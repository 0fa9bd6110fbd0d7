"""The port's SPRITES driver against the JAX CLI at the SPRITES record
config's flags (--ip_joint --GPLVM_joint --PCA --object_kernel_normalize
--clip_grad), on the same corpus, weights and noise: Hensman + GECO
through fused_rejitter_pallas (the Hensman CUDA cell, with --lr_decay
0.1) here, Titsias through fused (the Titsias CUDA cell) in
tests/test_torch_titsias_cli_record_titsias.py.  Gradients go through the
cosine-normalized kernel and the value clip.  The JAX CLI's PCA
initializers (sklearn) are given to the port with --params; sklearn's
default PCA solver is randomized, so the JAX side runs its exact solver,
as tests/test_torch_sprites_train.py::test_sprites_pca_init_matches_jax.

Tolerances and the parameter check as tests/test_torch_titsias_cli.py
(whose docstring says why the Hensman case leaves gp/inducing_points out
of the parameter check; its float64 test holds both record-config
blocks' gradients, the inducing points' included, to JAX).
"""

import contextlib
import functools
import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import data as jdata, gp as jgp, models as jmodels
from svgpvae_tpu import nn as jnets
from svgpvae_tpu.cli import sprites as jsprites
from svgpvae_tpu_torch import data as tdata, models as tmodels
from svgpvae_tpu_torch import train as ttrain
from svgpvae_tpu_torch.cli import sprites as tsprites
from svgpvae_tpu_torch.utils.convert import params_from_jax

from test_torch_titsias_cli import (BETA, MSE_RTOL, SPRITES_GRAD_RTOL,
                                    _assert_params, _np, _port_names,
                                    flatten_params)
from torch_threads import _torch_threads  # noqa: E402,F401


SPRITES_L, SPRITES_CHARS, N_ACTIONS = 8, 3, 72
RECORD_FLAGS = ["--ip_joint", "--GPLVM_joint", "--PCA",
                "--object_kernel_normalize", "--clip_grad"]
# 150 train frames: a full batch of 100 and a tail of 50.  The CLI's
# L_action 8 and L_character 16 are kept (8 * 16 >= 72 inducing points).
SPRITES_ARGV = ["--clip_qs", "--synthetic", "--synthetic_chars",
                str(SPRITES_CHARS), "--opt_regime", "joint-1",
                "--eval_every", "1", "--nr_epochs_repr_nn", "2",
                "--batch_size", "100", "--batch_size_repr_nn", "100",
                "--L", str(SPRITES_L), "--seed", "0", *RECORD_FLAGS]
RECORD_CASES = {
    # the Hensman CUDA cell, with the cosine lr
    "hensman-geco-fused_rejitter_pallas": [
        "--elbo", "SVGPVAE_Hensman", "--GECO", "--gp_block_impl",
        "fused_rejitter_pallas", "--lr_decay", "0.1"],
    # the Titsias CUDA cell, as the record runs (no GECO)
    "titsias-fused": ["--elbo", "SVGPVAE_Titsias", "--gp_block_impl",
                      "fused"],
}


@pytest.fixture(scope="module")
def sprites_corpus():
    return tdata.generate_synthetic_sprites(
        n_train_chars=SPRITES_CHARS, n_test_chars=2, n_frames_train=50,
        seed=0)


def _sprites_jax_eps(seed):
    """The JAX SPRITES CLI's draws: main step t the subkey of the t-th
    split of fold_in(PRNGKey(seed), 202), every eval batch PRNGKey(11)."""
    key = [jax.random.fold_in(jax.random.PRNGKey(seed), 202)]

    def eps_fn(kind, shape):
        import torch
        if kind == "train":
            key[0], sub = jax.random.split(key[0])
        else:
            sub = jax.random.PRNGKey(11)
        return torch.from_numpy(np.array(jax.random.normal(sub, shape)))
    return eps_fn


def _sprites_jax_init(seed, train_d, args):
    """The JAX CLI's initial parameters under --PCA (vae, repr, head from
    PRNGKey(seed), the GP from sprites_pca_init) as a flat dict."""
    key, dummy = jax.random.PRNGKey(seed), jnp.zeros((2, 64, 64, 3))
    gplvm, ip = jdata.sprites_pca_init(train_d, m=args.m,
                                       L_action=args.L_action,
                                       L_character=args.L_character)
    n_chars = len(train_d["frames"]) // 50
    return flatten_params({
        "vae": jnets.SpritesVAE(L=args.L).init(key, dummy),
        "repr": jnets.SpritesReprNet(L=args.L_character).init(key, dummy),
        "head": jnets.ClassificationHead(num_classes=n_chars).init(
            key, jnp.zeros((2, args.L_character))),
        "gp": jgp.init_sprites_svgp(ip, gplvm, L_action=args.L_action)})


def check_record_case(tmp_path, sprites_corpus, case, monkeypatch):
    """cli.sprites.main at the record config's flags against the JAX
    CLI's run_experiment on the same corpus, weights and noise."""
    from sklearn.decomposition import PCA
    monkeypatch.setattr(jdata.sprites, "PCA",
                        functools.partial(PCA, svd_solver="full"))
    argv = SPRITES_ARGV + RECORD_CASES[case]
    args = tsprites.build_parser().parse_args(argv)
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **_sprites_jax_init(0, sprites_corpus["train"], args))
    got = tsprites.main(argv + ["--device", "cpu", "--params", npz],
                        splits=sprites_corpus, eps_fn=_sprites_jax_eps(0),
                        capture_step=0)

    jargs = jsprites.build_parser().parse_args(
        argv + ["--sprites_data_path", str(tmp_path / "corpus")])
    with contextlib.redirect_stdout(io.StringIO()):
        want = jsprites.run_experiment(jargs)
    assert len(got["metrics"]) == 2 and got["pretrain"]["steps"] == 2
    assert got["state"].params["gp"].config.K_obj_normalize
    state = want["state"]
    np.testing.assert_allclose(got["cgen_mse"], want["best_cgen_mse"],
                               rtol=MSE_RTOL)
    g0 = {k: np.abs(_np(g)) for k, g in got["captured"]["grads"].items()}
    _assert_params(ttrain.named_tensors(got["state"].params),
                   _port_names(params_from_jax(flatten_params(
                       state.params))),
                   {k: g >= SPRITES_GRAD_RTOL * max(g.max(), 1e-30)
                    for k, g in g0.items()},
                   skip=("gp/inducing_points",) if args.GECO else ())

    # the test recon MSE of the JAX CLI's eval pass, on its final state
    vae = jnets.SpritesVAE(L=SPRITES_L)
    rep = jnets.SpritesReprNet(L=args.L_character)
    tc = sprites_corpus["test_character"]
    recon = jax.jit(lambda params, geco: jmodels.forward_pass_svgpvae(
        vae, params["vae"], params["gp"],
        (jnp.asarray(tc["frames"]), jnp.asarray(tc["aux_data"][:, 1])),
        jax.random.PRNGKey(11), beta=BETA, C_ma=geco.C_ma,
        lagrange_mult=geco.lagrange_mult, alpha=0.99,
        kappa=float(np.sqrt(args.kappa_squared)), clip_qs=True,
        geco=args.GECO, repr_apply=rep.apply, repr_params=params["repr"],
        frames_per_char=N_ACTIONS, gp_block_impl=args.gp_block_impl
    ).recon_loss)(state.params, state.geco)  # one compile, not per op
    np.testing.assert_allclose(got["evals"][0]["test_mse"],
                               float(recon) / len(tc["frames"]),
                               rtol=MSE_RTOL)
    # CPU tensors: the twins ran and no kernel launched
    assert all(n == 0 for s in got["step_launches"] for n in s.values())
    resolved = tmodels.resolve_gp_block_impl(
        "auto", workload="sprites", titsias=args.elbo == "SVGPVAE_Titsias",
        device="cuda")
    assert resolved == args.gp_block_impl  # the case runs the CUDA cell


@pytest.mark.parametrize("case", ["hensman-geco-fused_rejitter_pallas"])
def test_sprites_record_config_matches_jax_cli(tmp_path, sprites_corpus,
                                               case, monkeypatch):
    check_record_case(tmp_path, sprites_corpus, case, monkeypatch)
