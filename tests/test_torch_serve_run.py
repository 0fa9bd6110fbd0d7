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
    (read from its source), SPRITES's files are the JAX SPRITES driver's,
    with the same columns and keys and, from the same initial weights and
    noise, the same values at the parity tests' rtol 1e-4.
"""

from __future__ import annotations

import ast
import contextlib
import csv
import glob
import inspect
import io
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
from svgpvae_tpu.cli import mnist as jmnist, sprites as jsprites
from svgpvae_tpu.gp.svgp import SVGPConfig as JConfig
from svgpvae_tpu_torch import data as tdata, gp as tgp, models as tmodels
from svgpvae_tpu_torch import serving as tserving
from svgpvae_tpu_torch.cli import mnist as tmnist, serve as tserve
from svgpvae_tpu_torch.cli import sprites as tsprites
from svgpvae_tpu_torch.utils.convert import mnist_params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from export_jax_params import flatten_params  # noqa: E402

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


@pytest.fixture(scope="module")
def corpus():
    return tdata.generate_synthetic_sprites(
        n_train_chars=SPRITES_CHARS, n_test_chars=2, n_frames_train=50,
        seed=0)


def _jax_eps(seed):
    """The JAX CLI's draws: main step t takes the t-th split of
    fold_in(PRNGKey(seed), 202); every eval batch PRNGKey(11)."""
    key = [jax.random.fold_in(jax.random.PRNGKey(seed), 202)]

    def eps_fn(kind, shape):
        if kind == "train":
            key[0], sub = jax.random.split(key[0])
        else:
            sub = jax.random.PRNGKey(11)
        return torch.from_numpy(np.array(jax.random.normal(sub, shape)))
    return eps_fn


def _jax_cli_init(seed, args) -> dict:
    """The JAX CLI's initial parameters, flat (its nets from
    PRNGKey(seed), the GP from RandomState(seed))."""
    key, dummy = jax.random.PRNGKey(seed), jnp.zeros((2, 64, 64, 3))
    rng = np.random.RandomState(seed)
    gplvm = rng.normal(0, 1.5, (N_ACTIONS, args.L_action))
    ip = rng.normal(0, 1.5, (N_ACTIONS, args.L_action + args.L_character))
    return flatten_params({
        "vae": jnets.SpritesVAE(L=args.L).init(key, dummy),
        "repr": jnets.SpritesReprNet(L=args.L_character).init(key, dummy),
        "head": jnets.ClassificationHead(num_classes=SPRITES_CHARS).init(
            key, jnp.zeros((2, args.L_character))),
        "gp": jgp.init_sprites_svgp(ip, gplvm, L_action=args.L_action)})


def test_sprites_run_outputs_match_jax_and_serve(tmp_path, corpus):
    args = tsprites.build_parser().parse_args(SPRITES_ARGV)
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **_jax_cli_init(0, args))
    port_base, jax_base = str(tmp_path / "port"), str(tmp_path / "jax")
    res = tsprites.main(SPRITES_ARGV + [
        "--device", "cpu", "--params", npz, "--save", "--save_model_weights",
        "--base_dir", port_base], splits=corpus, eps_fn=_jax_eps(0))
    jargs = jsprites.build_parser().parse_args(SPRITES_ARGV + [
        "--sprites_data_path", str(tmp_path / "corpus"), "--save",
        "--base_dir", jax_base])
    with contextlib.redirect_stdout(io.StringIO()):
        jsprites.run_experiment(jargs)
    port_run = res["run_dir"]
    (jax_run,) = glob.glob(os.path.join(jax_base, jargs.expid, "*"))
    step = res["state"].step

    for name in ("ELBO_results.csv", "GP_params.csv"):
        got_h, got = _csv(os.path.join(port_run, "res", name))
        want_h, want = _csv(os.path.join(jax_run, "res", name))
        assert got_h == want_h and got.shape == want.shape, name
        for j, col in enumerate(want_h):
            _close(got[:, j], want[:, j], PARITY_RTOL)
    gp_npz = f"gp_params_{step}.npz"
    with np.load(os.path.join(port_run, "res", gp_npz)) as g, \
            np.load(os.path.join(jax_run, "res", gp_npz)) as w:
        assert set(g) == set(w)
        for k in w:
            _close(g[k], w[k], PARITY_RTOL)
    for name in ("cgen_images.p", "cgen_images_target.p"):
        with open(os.path.join(port_run, name), "rb") as f:
            got = pickle.load(f)
        with open(os.path.join(jax_run, name), "rb") as f:
            want = np.asarray(pickle.load(f))
        assert got.shape == want.shape, name
        _close(got, want, 1e-3)  # decoded images: the parity tests' 1e-3
    for run in (port_run, jax_run):
        with open(os.path.join(run, "pics", "test_metrics.txt")) as f:
            assert len(f.read().strip().splitlines()) == 1

    out = str(tmp_path / "preds.npz")
    served = tserve.main(["--run_dir", port_run, "--device", "cpu", "--out",
                          out, "--mean"], splits=corpus)
    assert served["step"] == step and served["n_queries"] == N_ACTIONS - 36
    params = res["state"].params
    got = served["state"]["served"][0]
    tc = corpus["test_character"]
    with torch.no_grad():
        frames = torch.from_numpy(corpus["train"]["frames"])
        aux_train = tmodels.sprites_aux_data(
            params["repr"], frames,
            torch.from_numpy(corpus["train"]["aux_data"][:, 1]), 50)
        aux_q = tserve.sprites_query_aux(
            params["repr"], torch.from_numpy(tc["frames"][:36]),
            tc["aux_data"][36:N_ACTIONS, 1])
    images, p_m, p_v = _direct(params, frames, aux_train, aux_q)
    for k, want in (("aux_query", aux_q), ("p_m", p_m), ("p_v", p_v),
                    ("images", images)):
        _close(got[k], want, SERVE_RTOL)
    with np.load(out) as z:
        np.testing.assert_array_equal(z["p_m"], got["p_m"].numpy())


def test_serve_refuses_data_parallel():
    with pytest.raises(SystemExit, match="not ported"):
        tserve.main(["--run_dir", "x", "--data_parallel", "2",
                     "--device", "cpu"])
