"""Serving from a trained run, and the run outputs it reads.

  * gp.precompute_test_posterior_terms on an MnistSVGP (with and without
    the GPLVM table, with and without --object_kernel_normalize) against
    the JAX package's, float64, rtol 1e-10 of each output's max |entry|:
    JAX off a TPU builds K_nm and contracts it (gp_stats), the port runs
    B3's plain twin on the CPU;
  * cli.serve.main --run_dir on a tiny saved run of each driver against
    a direct serving.fit + predict on the run's final weights (the same
    fp32 math on the CPU, encoded in other chunks: rtol 1e-5), and the
    --out / --queries round trip;
  * the run outputs: MNIST's CSV columns are the JAX driver's lists
    (read from its source); SPRITES's, and serving from a SPRITES run, in
    tests/test_torch_serve_run_sprites.py.
"""

from __future__ import annotations

import ast
import csv
import glob
import inspect
import os
import pickle
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgpvae_tpu import gp as jgp, nn as jnets
from svgpvae_tpu.cli import mnist as jmnist
from svgpvae_tpu.gp.svgp import SVGPConfig as JConfig
from svgpvae_tpu_torch import data as tdata, gp as tgp, models as tmodels
from svgpvae_tpu_torch import parallel as tparallel
from svgpvae_tpu_torch import serving as tserving
from svgpvae_tpu_torch.cli import mnist as tmnist, serve as tserve
from svgpvae_tpu_torch.utils.convert import mnist_params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from export_jax_params import flatten_params  # noqa: E402
from torch_threads import _torch_threads  # noqa: E402,F401

RTOL64 = 1e-10
SERVE_RTOL = 1e-5
PARITY_RTOL = 1e-4
N_ACTIONS = 72
MNIST_ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs", "--PCA",
              "--ip_joint", "--GP_joint", "--ov_joint", "--dataset", "36",
              "--opt_regime", "joint-1", "--eval_every", "1", "--L", "4",
              "--batch_size", "64", "--seed", "0", "--device", "cpu"]
SPRITES_CHARS = 3
SPRITES_ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs",
                "--synthetic", "--synthetic_chars", str(SPRITES_CHARS),
                "--opt_regime", "joint-1", "--eval_every", "1",
                "--nr_epochs_repr_nn", "1", "--batch_size", "100",
                "--batch_size_repr_nn", "100", "--L", "8", "--seed", "0",
                "--gp_block_impl", "fused_rejitter"]


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _close(got, want, rtol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("table", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_mnist_precompute_matches_jax_f64(x64, table, normalize):
    rng = np.random.RandomState(3)
    N, L, M, m, n_obj = 300, 3, 4, 8, 12
    ip = np.hstack([np.arange(m)[:, None], rng.rand(m, 1) * 2 * np.pi,
                    rng.randn(m, M)])
    aux = np.hstack([rng.randint(0, n_obj, (N, 1)).astype(float),
                     rng.rand(N, 1) * 2 * np.pi, rng.randn(N, M)])
    aux_q = aux[:17] + np.hstack([np.zeros((17, 1)),
                                  rng.rand(17, 1), np.zeros((17, M))])
    means = rng.randn(N, L)
    variances = np.clip(np.exp(rng.randn(N, L)), 1e-3, 10.0)
    cfg = dict(jitter=1e-6, N_train=N, K_obj_normalize=normalize)
    j_gp = jgp.init_mnist_svgp(ip, rng.randn(n_obj, M) if table else None,
                               config=JConfig(**cfg), dtype=jnp.float64)
    j_gp = j_gp.replace(length_scale=jnp.asarray(0.8),
                        amplitude=jnp.asarray(1.3))
    vae = jnets.MnistVAE(L=L).init(jax.random.PRNGKey(0),
                                   jnp.zeros((2, 28, 28, 1)))
    port = mnist_params_from_jax(flatten_params({"vae": vae, "gp": j_gp}))
    t_gp = tgp.MnistSVGP(config=tgp.SVGPConfig(**cfg), **port["gp"])
    assert (t_gp.object_vectors is not None) == table
    assert t_gp.inducing_points.dtype == torch.float64

    want = jgp.precompute_test_posterior_terms(
        j_gp, *(jnp.asarray(a) for a in (means, variances, aux)))
    got = tgp.precompute_test_posterior_terms(
        t_gp, *(torch.from_numpy(a) for a in (means, variances, aux)))
    for g, w in zip(got, want):
        _close(g, w, RTOL64)
    for g, w in zip(
            tgp.posterior_from_precomputed(t_gp, torch.from_numpy(aux_q),
                                           *got),
            jgp.posterior_from_precomputed(j_gp, jnp.asarray(aux_q), *want)):
        _close(g, w, RTOL64)


@pytest.fixture(scope="module")
def mnist_splits():
    base = tdata.synthetic_digit_base_images("36", per_digit=10, seed=0)
    return tdata.generate_rotated_mnist(base, None, digits="36", seed=0)


def _csv(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.asarray(rows[1:], np.float64)


def _jax_columns(name: str) -> list:
    """A ResultSaver column list of the JAX MNIST driver's SVGPVAE path,
    read from its source."""
    src = inspect.getsource(jmnist.run_svgpvae)
    m = re.search(rf'"{re.escape(name)}"\),\s*(\[[^\]]*\])', src)
    return ast.literal_eval(m.group(1))


def _direct(params, train_images, train_aux, aux_q, clip_qs=True):
    """serving.fit + predict (posterior mean) on the run's weights, the
    whole train split encoded in one call."""
    with torch.no_grad():
        mu, var = tmodels.batching_encode_svgpvae(params["vae"], train_images,
                                                  clip_qs=clip_qs)
        pred = tserving.fit(params["gp"], mu, var, train_aux)
        return tserving.make_predict_fn(pred, params["vae"],
                                        sample=False)(aux_q)


def test_mnist_run_outputs_and_serve(tmp_path, mnist_splits):
    res = tmnist.main(MNIST_ARGV + ["--save", "--save_model_weights",
                                    "--save_latents", "--base_dir",
                                    str(tmp_path)], splits=mnist_splits)
    run = res["run_dir"]
    step = res["state"].step
    for sub in ("pics", "res", "preds", "ckpt", "sourcecode"):
        assert os.path.isdir(os.path.join(run, sub))
    snap = os.path.join(run, "sourcecode", "svgpvae_tpu_torch")
    assert os.path.isfile(os.path.join(snap, "cli", "mnist.py"))
    assert not glob.glob(os.path.join(snap, "**", "__pycache__"),
                         recursive=True)
    header, rows = _csv(os.path.join(run, "res", "ELBO_results.csv"))
    assert header == _jax_columns("ELBO_results.csv") == tmnist.ELBO_COLUMNS
    assert rows.shape == (1, len(header)) and rows[0, 0] == step
    assert np.isfinite(rows).all()
    header, rows = _csv(os.path.join(run, "res", "GP_params.csv"))
    assert header == _jax_columns("GP_params.csv")
    gp = res["state"].params["gp"]
    np.testing.assert_allclose(rows[0, 1:3], [float(gp.length_scale.detach()),
                                              float(gp.amplitude.detach())])
    with np.load(os.path.join(run, "res", f"gp_params_{step}.npz")) as z:
        assert set(z) == {"length_scale", "amplitude", "inducing_points",
                          "object_vectors"}
        np.testing.assert_array_equal(z["object_vectors"],
                                      gp.object_vectors.detach().numpy())
    test = mnist_splits["test"]
    with open(os.path.join(run, "cgen_images.p"), "rb") as f:
        assert pickle.load(f).shape == test["images"].shape
    with open(os.path.join(run, "latents_train.p"), "rb") as f:
        assert pickle.load(f).shape == (len(mnist_splits["train"]["images"]),
                                        4)
    with open(os.path.join(run, "pics", "test_metrics.txt")) as f:
        assert f.read().strip().split(",")[0] == "1"

    out = str(tmp_path / "preds.npz")
    served = tserve.main(["--run_dir", run, "--device", "cpu", "--out", out,
                          "--mean", "--limit", "10"], splits=mnist_splits)
    assert served["step"] == step and served["n_queries"] == 10
    aux_q = torch.as_tensor(test["aux_data"][:10], dtype=torch.float32)
    images, p_m, p_v = _direct(
        res["state"].params,
        torch.as_tensor(mnist_splits["train"]["images"],
                        dtype=torch.float32),
        torch.as_tensor(mnist_splits["train"]["aux_data"],
                        dtype=torch.float32), aux_q)
    got = served["state"]["served"][0]
    for k, want in (("p_m", p_m), ("p_v", p_v), ("images", images)):
        _close(got[k], want, SERVE_RTOL)
    with np.load(out) as z:
        for k in ("images", "p_m", "p_v", "aux_query"):
            np.testing.assert_array_equal(z[k], got[k].numpy())
    np.testing.assert_allclose(
        served["cgen_mse"], float(torch.sum(
            (torch.as_tensor(test["images"][:10], dtype=torch.float32)
             - images) ** 2)) /
        (28 * 28 * 10), rtol=1e-4)

    q = str(tmp_path / "q.npy")
    np.save(q, test["aux_data"][2:9])
    again = tserve.main(["--run_dir", run, "--device", "cpu", "--out",
                         str(tmp_path / "q.npz"), "--queries", q, "--mean"],
                        splits=mnist_splits)
    assert "cgen_mse" not in again
    np.testing.assert_array_equal(again["state"]["served"][0]["p_m"],
                                  got["p_m"][2:9])


def test_serve_refuses_data_parallel():
    """--data_parallel shards the fit (tests/test_torch_parallel_drivers.py);
    more ranks than visible devices are refused, with the JAX package's
    message."""
    n = tparallel.mesh.visible_devices("cpu") + 1
    with pytest.raises(SystemExit,
                       match=f"--data_parallel {n}: only .* visible"):
        tserve.main(["--run_dir", "x", "--data_parallel", str(n),
                     "--device", "cpu"])
