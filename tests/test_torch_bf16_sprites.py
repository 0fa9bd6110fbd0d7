"""The port's SPRITES path under --bf16 and --bf16_hybrid against the JAX
package's with its nets at dtype=jnp.bfloat16 (the hybrid: the VAE's
head_dtype=jnp.float32), on the same fp32 weights (utils.convert), inputs
(made from a seed with numpy) and fp32 noise:

  * SpritesVAE (bf16 and hybrid: encode, decode), SpritesReprNet and the
    fp32 ClassificationHead on its bf16 embeddings (flax promotes them,
    as in JAX's pretraining) against flax's; their parameters stay fp32
    and their gradients come back fp32;
  * forward_pass_svgpvae (Hensman + GECO, the CUDA path's
    fused_rejitter_pallas block: B1's and B2's twins on the CPU), on 2
    characters x 5 frames: every output's dtype is JAX's, each value
    within HALF of JAX's own bf16-vs-fp32 distance (tests/bf16_hold.py),
    and every tensor that reaches B2 (`gp_stats`) and B1 (`chol_inverse`)
    is fp32.  The reconstruction is held to JAX's decoder on the port's
    own latent samples: thirteen bf16 layers apart, a rounding flip in
    the encoder's trunk (a qnet_mu entry one bf16 ulp off, 9.8e-4) moves
    the latents by up to 2e-4, and the decoder's bf16 input rounding turns
    that into flips over its whole output (RMS 2.9e-4 from JAX's
    reconstruction, against half of JAX's bf16-vs-fp32 distance, 2.8e-4),
    where the decoder on the same latents holds;
  * a tiny --bf16_hybrid run through `cli.sprites.main` on the CPU
    (pretraining, steps, the eval pass's encode, fit and cgen): fp32
    parameters, fp32 kernel inputs (B3 `fused_kernel_stats` in the fit
    too), finite metrics, and its run dir served with fp32 nets.

Every JAX program is compiled with XLA's excess precision off
(bf16_hold.flax_rounding), every op rounding its result to its dtype as
flax declares (tests/test_torch_bf16_mnist.py says why).  One place
where the two backends round differently is held apart: the repr net's
8x8 average pool.  XLA's CPU backend sums the 64 bf16 values one at a
time in bf16 (JAX's pooled output equals that sequential sum exactly),
an artefact of the backend; torch, like a TPU's reduction, accumulates
them in fp32 and rounds once.  That rounding alone moved the
embeddings by up to 1.5 bf16 ulps (1.46e-3 at a scale of 0.23), as far as
JAX's whole bf16-vs-fp32 distance (1.64e-3, maxima over the output), so
the JAX side's repr net is the JAX package's three convs (whose output the
port matched exactly) pooled with fp32 accumulation and one rounding
(bf16_hold.repr_pooled_once).
"""

import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import gp as jgp, models as jmodels, nn as jnets
from svgpvae_tpu.gp.svgp import SVGPConfig as JConfig
from svgpvae_tpu_torch import data as tdata, gp as tgp, models as tmodels
from svgpvae_tpu_torch import nn as tnets
from svgpvae_tpu_torch.cli import serve as tserve, sprites as tsprites
from svgpvae_tpu_torch.utils.convert import sprites_train_params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from bf16_hold import (flax_rounding, hold_to_jax_bf16,  # noqa: E402
                       repr_pooled_once)
from bf16_hold import kernel_inputs  # noqa: E402,F401
from export_jax_params import flatten_params  # noqa: E402
from torch_threads import _torch_threads  # noqa: E402,F401

BF16 = jnp.bfloat16
L, L_ACT, L_CHAR, FPC, N_CHARS, m = 8, 3, 4, 5, 2, 10
N_ACTIONS = 72
KAPPA = float(np.sqrt(0.0075))


def _problem():
    rng = np.random.RandomState(0)
    dummy = jnp.zeros((2, 64, 64, 3))
    params = {
        "vae": jnets.SpritesVAE(L=L).init(jax.random.PRNGKey(0), dummy),
        "repr": jnets.SpritesReprNet(L=L_CHAR).init(jax.random.PRNGKey(1),
                                                    dummy),
        "gp": jgp.init_sprites_svgp(
            rng.randn(m, L_ACT + L_CHAR), rng.randn(N_ACTIONS, L_ACT),
            L_action=L_ACT, config=JConfig(jitter=0.01, N_train=500))}
    frames = rng.rand(N_CHARS * FPC, 64, 64, 3).astype(np.float32)
    aids = rng.randint(0, N_ACTIONS, N_CHARS * FPC).astype(np.float32)
    return params, frames, aids


def _port(params, dtype=torch.bfloat16, head_dtype=None):
    """The port's vae, repr net and GP on `params`' weights, the nets at
    the compute dtypes given."""
    port = sprites_train_params_from_jax(
        flatten_params(params), tgp.SVGPConfig(jitter=0.01, N_train=500),
        L_action=L_ACT)
    port["vae"].set_compute_dtype(dtype, head_dtype)
    port["repr"].set_compute_dtype(dtype)
    return port


@pytest.mark.parametrize("hybrid", [False, True], ids=["bf16", "hybrid"])
def test_sprites_vae_matches_flax_bf16(hybrid):
    params, frames, _ = _problem()
    head = jnp.float32 if hybrid else None
    t_vae = _port(params, head_dtype=torch.float32 if hybrid else None)["vae"]
    z = np.random.RandomState(3).randn(len(frames), L).astype(np.float32)
    for method, arg in (("encode", frames), ("decode", z)):
        with torch.no_grad():
            got = getattr(t_vae, method)(torch.from_numpy(arg))
        w16, w32 = (flax_rounding(functools.partial(
            vae.apply, method=method))(params["vae"], arg) for vae in (
                jnets.SpritesVAE(L=L, dtype=BF16, head_dtype=head),
                jnets.SpritesVAE(L=L)))
        got, w16, w32 = ((t,) if not isinstance(t, tuple) else t
                         for t in (got, w16, w32))
        for i, (g, a, b) in enumerate(zip(got, w16, w32)):
            hold_to_jax_bf16(g, a, b, f"{method}[{i}]")


def test_sprites_repr_net_and_head_match_flax_bf16():
    """The repr net in bf16 (its pool held to JAX's trunk pooled once, see
    the module doc), and the fp32 classification head on its bf16
    embeddings."""
    params, frames, _ = _problem()
    t_repr = _port(params)["repr"]
    head = jnets.ClassificationHead(num_classes=7)
    hp = head.init(jax.random.PRNGKey(4), jnp.zeros((2, L_CHAR)))
    t_head = tnets.ClassificationHead(L_CHAR, 7)
    dense = hp["params"]["Dense_0"]
    t_head.load_state_dict({
        "dense.weight": torch.from_numpy(np.array(dense["kernel"]).T),
        "dense.bias": torch.from_numpy(np.array(dense["bias"]))})
    with torch.no_grad():
        emb = t_repr(torch.from_numpy(frames))
        logits = t_head(emb)
    e16, e32, cpu_pool = (flax_rounding(fn)(params["repr"], frames) for fn in (
        repr_pooled_once(L_CHAR), jnets.SpritesReprNet(L=L_CHAR).apply,
        jnets.SpritesReprNet(L=L_CHAR, dtype=BF16).apply))
    assert np.abs(np.asarray(cpu_pool, np.float32)
                  - np.asarray(e16, np.float32)).max() > 0
    hold_to_jax_bf16(emb, e16, e32, "embeddings")
    hold_to_jax_bf16(logits, *(flax_rounding(head.apply)(hp, e)
                               for e in (e16, e32)), "logits")
    assert logits.dtype == torch.float32


def test_bf16_nets_keep_fp32_parameters_and_gradients():
    """The casts are inside the layers: the parameters stay fp32 and
    autograd returns fp32 gradients."""
    vae = tnets.SpritesVAE(L=L, generator=torch.Generator().manual_seed(0),
                           dtype=torch.bfloat16, head_dtype=torch.float32)
    repr_net = tnets.SpritesReprNet(
        L=L_CHAR, generator=torch.Generator().manual_seed(1),
        dtype=torch.bfloat16)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(2))
    mu, var = vae.encode(x)
    emb = repr_net(x)
    (vae.decode(mu).sum() + var.sum() + emb.float().sum()).backward()
    for net in (vae, repr_net):
        for name, t in net.named_parameters():
            assert t.dtype == t.grad.dtype == torch.float32, name
    assert mu.dtype == torch.float32 and emb.dtype == torch.bfloat16


def _jax_forward(params, frames, aids, key, dtype, head_dtype=None):
    vae = jnets.SpritesVAE(L=L, dtype=dtype, head_dtype=head_dtype)
    repr_apply = (repr_pooled_once(L_CHAR) if dtype == BF16
                  else jnets.SpritesReprNet(L=L_CHAR).apply)
    return jmodels.forward_pass_svgpvae(
        vae, params["vae"], params["gp"], (frames, aids), key, beta=0.001,
        C_ma=jnp.float32(0.3), lagrange_mult=jnp.float32(1.5), alpha=0.99,
        kappa=KAPPA, clip_qs=True, geco=True, repr_apply=repr_apply,
        repr_params=params["repr"], frames_per_char=FPC,
        gp_block_impl="fused_rejitter_pallas")


@pytest.mark.parametrize("hybrid", [False, True], ids=["bf16", "hybrid"])
def test_forward_pass_sprites_bf16_matches_jax(hybrid, kernel_inputs):
    params, frames, aids = _problem()
    key = jax.random.PRNGKey(3)
    head = jnp.float32 if hybrid else None
    want16, want32 = (flax_rounding(functools.partial(
        _jax_forward, key=key, dtype=dt, head_dtype=hd))(params, frames, aids)
        for dt, hd in ((BF16, head), (jnp.float32, None)))
    port = _port(params, head_dtype=torch.float32 if hybrid else None)
    vae, repr_net = port["vae"], port["repr"]
    eps = torch.from_numpy(np.array(jax.random.normal(key, (N_CHARS * FPC,
                                                            L))))
    with torch.no_grad():
        got = tmodels.forward_pass_svgpvae(
            vae, port["gp"], (torch.from_numpy(frames),
                              torch.from_numpy(aids)), eps, beta=0.001,
            C_ma=torch.tensor(0.3), lagrange_mult=torch.tensor(1.5),
            alpha=0.99, kappa=KAPPA, clip_qs=True, geco=True,
            gp_block_impl="fused_rejitter_pallas", repr_net=repr_net,
            frames_per_char=FPC)
    for name in ("elbo", "recon_loss", "kl_term", "inside_elbo", "ce_term",
                 "inside_elbo_recon", "inside_elbo_kl", "p_m", "p_v",
                 "qnet_mu", "qnet_var", "latent_samples", "C_ma",
                 "lagrange_mult"):
        hold_to_jax_bf16(getattr(got, name), getattr(want16, name),
                         getattr(want32, name), name)
    lat = got.latent_samples.numpy()
    dec16, dec32 = (flax_rounding(functools.partial(
        vae.apply, method="decode"))(params["vae"], lat) for vae in (
            jnets.SpritesVAE(L=L, dtype=BF16, head_dtype=head),
            jnets.SpritesVAE(L=L)))
    hold_to_jax_bf16(got.recon_images, dec16, dec32, "recon_images")
    assert got.recon_images.dtype == (torch.float32 if hybrid
                                      else torch.bfloat16)
    assert {"gp_stats", "chol_inverse"} <= {n for n, _ in kernel_inputs}
    assert {d for _, d in kernel_inputs} == {torch.float32}


ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs", "--opt_regime",
        "joint-1", "--eval_every", "1", "--nr_epochs_repr_nn", "1",
        "--batch_size", "100", "--batch_size_repr_nn", "100", "--L", "8",
        "--L_action", "8", "--L_character", "9", "--device", "cpu",
        "--gp_block_impl", "fused_rejitter_pallas", "--seed", "0"]


def test_main_bf16_hybrid_runs_with_fp32_state(kernel_inputs, tmp_path):
    corpus = tdata.generate_synthetic_sprites(n_train_chars=3,
                                              n_test_chars=2,
                                              n_frames_train=50, seed=0)
    res = tsprites.main(ARGV + ["--bf16_hybrid", "--save",
                                "--save_model_weights", "--base_dir",
                                str(tmp_path)], splits=corpus)
    params = res["state"].params
    assert (params["vae"].dtype, params["vae"].head_dtype,
            params["repr"].dtype) == (torch.bfloat16, torch.float32,
                                      torch.bfloat16)
    for part in ("vae", "repr"):
        assert {t.dtype for t in params[part].parameters()} == \
            {torch.float32}
    assert all(np.isfinite(e["loss"]) for e in res["pretrain"]["epochs"])
    assert all(np.isfinite(mt["loss"]) for mt in res["metrics"])
    assert np.isfinite(res["evals"][-1]["cgen_mse"])
    names = {n for n, _ in kernel_inputs}
    assert {"gp_stats", "chol_inverse", "fused_kernel_stats"} <= names
    assert {d for _, d in kernel_inputs} == {torch.float32}
    loaded = tserve.load_predictor(res["run_dir"], torch.device("cpu"),
                                   corpus)
    assert loaded["args"].bf16_hybrid
    assert loaded["vae"].dtype is None and loaded["repr_net"].dtype is None
    assert loaded["aux"].dtype == torch.float32
