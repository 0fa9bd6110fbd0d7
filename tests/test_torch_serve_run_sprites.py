"""Serving from a trained SPRITES run, and the run outputs it reads, in a
file of its own so that the suite's workers take it beside
tests/test_torch_serve_run.py (whose helpers it shares).

  * SPRITES's run outputs are the JAX SPRITES driver's files, with the
    same columns and keys and, from the same initial weights and noise,
    the same values at the parity tests' rtol 1e-4;
  * cli.serve.main --run_dir on that run against a direct serving.fit +
    predict on the run's final weights (rtol 1e-5), and --out.
"""

import contextlib
import glob
import io
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svgpvae_tpu import gp as jgp, nn as jnets
from svgpvae_tpu.cli import sprites as jsprites
from svgpvae_tpu_torch import data as tdata, models as tmodels
from svgpvae_tpu_torch.cli import serve as tserve
from svgpvae_tpu_torch.cli import sprites as tsprites

from test_torch_serve_run import (N_ACTIONS, PARITY_RTOL, SERVE_RTOL,
                                  SPRITES_ARGV, SPRITES_CHARS, _close, _csv,
                                  _direct, flatten_params)
from torch_threads import _torch_threads  # noqa: E402,F401


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
