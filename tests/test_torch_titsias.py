"""The port's Titsias bound against the JAX package.

  * the dense two-pass bound (posterior_params + variational_loss with
    config.titsias, i.e. titsias_terms) on the MNIST kernel, with and
    without the GPLVM table: values, and gradients with respect to the GP
    parameters, y and the noise, at float64;
  * the fused determinant-lemma block gp_block_titsias for inverse_impl
    "chol" and "pallas" (B1's Cholesky twin on the CPU; JAX's XLA
    reference off the TPU): values and gradients at float64, on the MNIST
    kernel (m = 8) and on the SPRITES product-linear kernel at m = 72
    (rank <= L_action * L_character = 12: PD only through the jitter);
  * the Woodbury identity: with the relative ridge off, the port's fused
    bound equals its dense two-pass bound at float64;
  * the Nystrom floor: the floored residual of the dense bound, and the
    ill-conditioned MNIST case of tests/test_fused_gp.py (cond(K_mm) past
    1/eps32, encoder variances at the clip floor), finite in fp32 and
    tracking float64 in both packages;
  * (tests/test_torch_titsias_forward.py) forward_pass_svgpvae with the
    Titsias bound, both workloads, both CE forms, fp32 and float64;
  * two training steps of each workload against JAX's make_train_step.

Tolerances: float64 within RTOL64 = 1e-9 of each output's max |entry|
(the same formulas summed in other orders); the rank-deficient SPRITES
K_mm carries entries ~1/jitter in K_mm^-1 and the gradients go through it
twice, so there RANK_DEFICIENT_RTOL64 = 1e-6 (as
tests/test_torch_mnist_gp.py).  fp32: a scalar that is the difference of
larger terms is held to RTOL_LOSS = 1e-5 of the magnitudes it is computed
from (tests/test_torch_mnist_train.py), every other output to 1e-5 of its
max |entry| (at least 1); gradients to the fp32 tolerances of the
existing training tests (MNIST 2e-4, SPRITES 1e-3 of each tensor's max
|entry|); parameters after Adam steps atol 1e-4, a tenth of one step.
The float64 JAX references of the GP level compile at XLA's lowest
optimisation level (tests/test_torch_sprites_train.py's quick_jit), which
moves their results by round-off.
"""

import contextlib
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import gp as jgp, models as jmodels
from svgpvae_tpu import nn as jnets, train as jtrain
from svgpvae_tpu.gp.svgp import SVGPConfig as JConfig
from svgpvae_tpu_torch import gp as tgp, models as tmodels
from svgpvae_tpu_torch import train as ttrain
from svgpvae_tpu_torch.gp import svgp as tsvgp
from svgpvae_tpu_torch.nn import MnistVAE
from svgpvae_tpu_torch.utils.convert import (mnist_params_from_jax,
                                             params_from_jax,
                                             sprites_train_params_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from export_jax_params import flatten_params  # noqa: E402
from test_torch_sprites_train import quick_jit  # noqa: E402
from torch_threads import _torch_threads  # noqa: E402,F401

RTOL64 = 1e-9
RANK_DEFICIENT_RTOL64 = 1e-6
RTOL_LOSS = 1e-5
GRAD_RTOL32 = {"mnist": 2e-4, "sprites": 1e-3}
PARAM_ATOL = 1e-4
BETA = 0.001
SPRITES_JITTER = 0.01
N_ACTIONS = 72


@contextlib.contextmanager
def _x64(on: bool):
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, rtol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(_np(got).astype(np.float64), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _t(a):
    return torch.tensor(np.array(a, np.float64))


# --- the GP level, float64 ---------------------------------------------------


def _mnist_gp(rng, table=True, b=24, L=3, M=4, m=8, n_obj=10, jitter=1e-6):
    ip = np.hstack([np.arange(m)[:, None], rng.rand(m, 1) * 2 * np.pi,
                    rng.randn(m, M)])
    aux = np.hstack([rng.randint(0, n_obj, (b, 1)).astype(float),
                     rng.rand(b, 1) * 2 * np.pi, rng.randn(b, M)])
    table_init = rng.randn(n_obj, M) if table else None
    y, noise = rng.randn(b, L), np.clip(np.exp(rng.randn(b, L)), 1e-3, 10.)
    cfg = dict(titsias=True, jitter=jitter, N_train=10 * b)
    j_gp = jgp.init_mnist_svgp(ip, table_init, config=JConfig(**cfg),
                               dtype=jnp.float64)
    j_gp = j_gp.replace(length_scale=jnp.asarray(0.8),
                        amplitude=jnp.asarray(1.3))
    t_gp = tgp.init_mnist_svgp(ip, table_init, config=tgp.SVGPConfig(**cfg),
                               dtype=torch.float64)
    t_gp.length_scale, t_gp.amplitude = _t(0.8), _t(1.3)
    return j_gp, t_gp, aux, y, noise


def _sprites_gp(rng, b=40, L=3, La=3, Lc=4, m=72):
    """The SPRITES product-linear kernel at m = 72 over La * Lc = 12
    feature products: K_mm has rank <= 12."""
    ip = rng.normal(0, 1.5, (m, La + Lc))
    gplvm = rng.normal(0, 1.5, (N_ACTIONS, La))
    aux = np.hstack([rng.randint(0, N_ACTIONS, (b, 1)),
                     rng.rand(b, Lc) * 0.5])
    y, noise = rng.randn(b, L), np.clip(np.exp(rng.randn(b, L)), 1e-3, 10.)
    cfg = dict(titsias=True, jitter=SPRITES_JITTER, N_train=50 * b)
    j_gp = jgp.init_sprites_svgp(ip, gplvm, L_action=La,
                                 config=JConfig(**cfg), dtype=jnp.float64)
    t_gp = tgp.init_sprites_svgp(ip, gplvm, L_action=La,
                                 config=tgp.SVGPConfig(**cfg),
                                 dtype=torch.float64)
    return j_gp, t_gp, aux, y, noise


def _weights(rng, outs):
    return [rng.randn(*np.shape(o)) for o in outs]


def _grad_check(j_fn, t_fn, j_gp, t_gp, y, noise, w, rtol):
    """Values of every output, then the loss sum(outputs * w) and its
    gradients with respect to every GP tensor, y and the noise, against
    JAX.  A GP tensor the outputs do not use (the SPRITES linear kernel's
    length scales) has gradient 0 on both sides."""
    def j_loss(gp, y_, noise_):
        return sum(jnp.sum(o * wi) for o, wi in zip(j_fn(gp, y_, noise_), w))

    want, j_grads = quick_jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2)))(
        j_gp, jnp.asarray(y), jnp.asarray(noise))
    leaves = list(t_gp.named_tensors().values())
    for t in leaves:
        t.requires_grad_(True)
    y_t, noise_t = _t(y).requires_grad_(), _t(noise).requires_grad_()
    outs = t_fn(t_gp, y_t, noise_t)
    for o, jo in zip(outs, j_fn(j_gp, jnp.asarray(y), jnp.asarray(noise))):
        _close(o, jo, rtol)
    loss = sum(torch.sum(o * _t(wi)) for o, wi in zip(outs, w))
    _close(loss, want, rtol)
    grads = torch.autograd.grad(loss, leaves + [y_t, noise_t],
                                allow_unused=True)
    for name, g in zip(t_gp.named_tensors(), grads):
        w_g = np.asarray(getattr(j_grads[0], name))
        _close(torch.zeros(w_g.shape, dtype=torch.float64) if g is None
               else g, w_g, rtol)
    _close(grads[-2], j_grads[1], rtol)
    _close(grads[-1], j_grads[2], rtol)


@pytest.mark.parametrize("table", [False, True])
def test_two_pass_bound_matches_jax(table):
    """posterior_params + variational_loss under config.titsias: the dense
    (L, b, b) covariance bound titsias_terms and its zero KL."""
    rng = np.random.RandomState(1)
    with _x64(True):
        j_gp, t_gp, aux, y, noise = _mnist_gp(rng, table)
        aux_t = _t(aux)

        def j_fn(gp, y_, noise_):
            p_m, p_v, mu, A = jgp.posterior_params(gp, aux, aux, y_, noise_)
            return (p_m, p_v) + tuple(
                jgp.variational_loss(gp, aux, y_, noise_, mu, A))

        def t_fn(gp, y_, noise_):
            p_m, p_v, mu, A = tgp.posterior_params(gp, aux_t, aux_t, y_,
                                                   noise_)
            return (p_m, p_v) + tuple(
                tgp.variational_loss(gp, aux_t, y_, noise_, mu, A))

        w = _weights(rng, j_fn(j_gp, y, noise))
        _grad_check(j_fn, t_fn, j_gp, t_gp, y, noise, w, RTOL64)
        bundle = tgp.kernel_matrices(t_gp, aux_t)
        l2, kl = tgp.titsias_terms(t_gp, *bundle[1:], _t(y), _t(noise))
        _close(l2, jgp.titsias_terms(
            j_gp, *jgp.kernel_matrices(j_gp, jnp.asarray(aux))[1:], y,
            noise)[0], RTOL64)
        assert not kl.any()


@pytest.mark.parametrize("impl,workload", [
    pytest.param(impl, workload, id=f"{impl}-{workload}")
    for workload in ("mnist", "sprites") for impl in ("chol", "pallas")])
def test_fused_block_matches_jax(impl, workload):
    rng = np.random.RandomState(2)
    with _x64(True):
        j_gp, t_gp, aux, y, noise = (_mnist_gp(rng) if workload == "mnist"
                                     else _sprites_gp(rng))
        aux_t = _t(aux)

        def j_fn(gp, y_, noise_):
            return jgp.gp_block_titsias(gp, aux, y_, noise_,
                                        inverse_impl=impl)

        def t_fn(gp, y_, noise_):
            return tgp.gp_block_titsias(gp, aux_t, y_, noise_,
                                        inverse_impl=impl)

        w = _weights(rng, j_fn(j_gp, y, noise))
        _grad_check(j_fn, t_fn, j_gp, t_gp, y, noise, w,
                    RTOL64 if workload == "mnist" else RANK_DEFICIENT_RTOL64)


def test_fused_block_stacks_one_b1_call(monkeypatch):
    """inverse_impl="pallas" hands chol_inverse ONE (2L+1, m, m) stack,
    [K_mm + jitter; Sigma + ridge; Sigma1 + relative ridge] (the JAX
    package makes two calls for the TPU's VMEM), and B2 runs twice: at the
    encoder precision and at 1 / (noise + jitter)."""
    from svgpvae_tpu_torch.gp import fused
    with _x64(True):
        _, t_gp, aux, y, noise = _mnist_gp(np.random.RandomState(3))
    seen, stats, twin, b2 = [], [], fused.chol_inverse, tsvgp.gp_stats

    def recording(M):
        seen.append(M)
        return twin(M)

    def recording_stats(Knm, prec, py):
        stats.append(prec)
        return b2(Knm, prec, py)

    monkeypatch.setattr(fused, "chol_inverse", recording)
    monkeypatch.setattr(tsvgp, "gp_stats", recording_stats)
    fused.gp_block_titsias(t_gp, _t(aux), _t(y), _t(noise),
                           inverse_impl="pallas")
    L, m = y.shape[1], t_gp.inducing_points.shape[0]
    assert [tuple(M.shape) for M in seen] == [(2 * L + 1, m, m)]
    jitter = t_gp.config.jitter
    assert len(stats) == 2
    _close(stats[0], 1.0 / noise, RTOL64)
    _close(stats[1], 1.0 / (noise + jitter), RTOL64)
    with pytest.raises(ValueError):
        fused.gp_block_titsias(t_gp, _t(aux), _t(y), _t(noise),
                               inverse_impl="triton")


@pytest.mark.parametrize("workload", ["mnist", "sprites"])
def test_fused_bound_equals_dense_bound_f64(workload, monkeypatch):
    """With the relative ridge off, the determinant-lemma bound is the
    dense-covariance bound (mirrors tests/test_fused_gp.py
    ::test_fused_titsias_woodbury_identity_exact_f64), and the block's
    posterior the two-pass posterior: every output within RTOL64."""
    monkeypatch.setattr(tsvgp, "SIGMA_REL_JITTER", 0.0)
    rng = np.random.RandomState(4)
    with _x64(True):
        _, t_gp, aux, y, noise = (_mnist_gp(rng) if workload == "mnist"
                                  else _sprites_gp(rng))
    aux_t, y_t, noise_t = _t(aux), _t(y), _t(noise)
    p_m, p_v, mu, A = tgp.posterior_params(t_gp, aux_t, aux_t, y_t, noise_t)
    l2, kl = tgp.variational_loss(t_gp, aux_t, y_t, noise_t, mu, A)
    got = tgp.gp_block_titsias(t_gp, aux_t, y_t, noise_t)
    for g, w in zip(got, (p_m, p_v, l2, kl, mu)):
        _close(g, w, RTOL64)


def test_nystrom_floor_in_dense_bound():
    """titsias_terms floors the Nystrom residual K_nn - diag(Q) at 0: a
    K_nn_diag below diag(Q) gives the bound of K_nn_diag == diag(Q)."""
    with _x64(True):
        _, t_gp, aux, y, noise = _mnist_gp(np.random.RandomState(5))
    _, Kmm_chol, Knm, Knn_diag = tgp.kernel_matrices(t_gp, _t(aux))
    W = torch.cholesky_solve(Knm.T, Kmm_chol)
    diag_q = torch.sum(Knm * W.T, dim=-1)
    low, _ = tgp.titsias_terms(t_gp, Kmm_chol, Knm, diag_q - 0.5, _t(y),
                               _t(noise))
    at, _ = tgp.titsias_terms(t_gp, Kmm_chol, Knm, diag_q, _t(y), _t(noise))
    _close(low, at, RTOL64)


def _ill_conditioned(jdtype, tdtype):
    """tests/test_fused_gp.py::test_fused_titsias_stable_on_ill_conditioned
    _kernel's case: b = 256, L = 16, m = 32, a long periodic length scale
    (cond(K_mm) past 1/eps32) and the encoder variances at the clip
    floor."""
    R = np.random.RandomState(11)
    b, L, M, m, n_obj = 256, 16, 8, 32, 400
    ip = np.hstack([np.arange(m)[:, None], R.rand(m, 1) * 2 * np.pi,
                    R.randn(m, M)])
    table = R.randn(n_obj, M)
    aux = np.hstack([R.randint(0, n_obj, (b, 1)).astype(float),
                     R.rand(b, 1) * 2 * np.pi, R.randn(b, M)])
    y, noise = R.randn(b, L), np.full((b, L), 1e-3)
    cfg = dict(titsias=True, jitter=1e-6, N_train=4050)
    j_gp = jgp.init_mnist_svgp(ip, table, config=JConfig(**cfg),
                               dtype=jdtype)
    j_gp = j_gp.replace(length_scale=jnp.asarray(4.6, jdtype),
                        amplitude=jnp.asarray(1.6, jdtype))
    t_gp = tgp.init_mnist_svgp(ip, table, config=tgp.SVGPConfig(**cfg),
                               dtype=tdtype)
    t_gp.length_scale = torch.tensor(4.6, dtype=tdtype)
    t_gp.amplitude = torch.tensor(1.6, dtype=tdtype)
    arrs = [np.asarray(a, jdtype) for a in (aux, y, noise)]
    return j_gp, t_gp, arrs, [torch.from_numpy(a) for a in arrs]


def test_fused_block_stable_on_ill_conditioned_kernel():
    """No false reward of the collapsed bound where the dense fp32 bound
    breaks: the port's fp32 block is finite and within 5e-2 (the JAX
    test's band) of the float64 bound, as JAX's is; the two packages'
    float64 bounds agree within RANK_DEFICIENT_RTOL64 (K_mm^-1 carries
    entries ~1/jitter here)."""
    j32, t32, ja32, ta32 = _ill_conditioned(jnp.float32, torch.float32)
    l2_t32 = _np(tgp.gp_block_titsias(t32, *ta32)[2])
    l2_j32 = np.asarray(jgp.gp_block_titsias(j32, *ja32)[2])
    with _x64(True):
        j64, t64, ja64, ta64 = _ill_conditioned(jnp.float64, torch.float64)
        l2_j64 = np.asarray(jgp.gp_block_titsias(j64, *ja64)[2])
    l2_t64 = tgp.gp_block_titsias(t64, *ta64)[2]
    assert np.isfinite(l2_t32).all()
    _close(l2_t64, l2_j64, RANK_DEFICIENT_RTOL64)
    np.testing.assert_allclose(l2_t32, l2_j64, rtol=5e-2)
    np.testing.assert_allclose(l2_j32, l2_j64, rtol=5e-2)


# --- the forward pass --------------------------------------------------------


def _mnist_case(dtype, seed=0, b=32, L=4, M=4, m=8, n_obj=20):
    """JAX MnistVAE + Titsias MnistSVGP parameters in `dtype`, and a
    batch."""
    rng = np.random.RandomState(seed)
    ip = np.hstack([np.arange(m)[:, None], rng.rand(m, 1) * 2 * np.pi,
                    rng.randn(m, M)])
    vae = jnets.MnistVAE(L=L, dtype=dtype)
    vae_p = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype),
        jnets.MnistVAE(L=L).init(jax.random.PRNGKey(seed),
                                 jnp.zeros((2, 28, 28, 1))))
    gp = jgp.init_mnist_svgp(ip, rng.randn(n_obj, M), config=JConfig(
        titsias=True, jitter=1e-6, N_train=10 * b), dtype=dtype)
    batches = [(rng.rand(b, 28, 28, 1),
                np.hstack([rng.randint(0, n_obj, (b, 1)).astype(float),
                           rng.rand(b, 1) * 2 * np.pi, rng.randn(b, M)]))
               for _ in range(2)]
    return vae, {"vae": vae_p, "gp": gp}, batches


def _mnist_port(params, tdtype):
    port = mnist_params_from_jax(flatten_params(params))
    vae = MnistVAE(L=port["vae"]["enc_out.bias"].shape[0] // 2)
    vae.load_state_dict(port["vae"])
    cfg = params["gp"].config
    gp = tgp.MnistSVGP(config=tgp.SVGPConfig(
        titsias=True, jitter=cfg.jitter, N_train=cfg.N_train), **port["gp"])
    return {"vae": vae.to(tdtype), "gp": gp.to(dtype=tdtype)}


SPRITES_L, SPRITES_LA, SPRITES_LC, FPC, SPRITES_B = 8, 3, 4, 50, 100


def _sprites_case(dtype, seed=0, m=10, n_chars=2):
    """JAX SpritesVAE, SpritesReprNet and a Titsias SpritesSVGP (m = 10:
    a full-rank K_mm, as the fp32 SPRITES tests use) in `dtype`, and
    frames of n_chars characters x 50."""
    rng = np.random.RandomState(seed)
    dummy = jnp.zeros((2, 64, 64, 3))
    vae = jnets.SpritesVAE(L=SPRITES_L, dtype=dtype)
    rep = jnets.SpritesReprNet(L=SPRITES_LC, dtype=dtype)
    cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a, dtype), t)
    vae_p = cast(jnets.SpritesVAE(L=SPRITES_L).init(jax.random.PRNGKey(0),
                                                    dummy))
    rep_p = cast(jnets.SpritesReprNet(L=SPRITES_LC).init(
        jax.random.PRNGKey(1), dummy))
    gp = jgp.init_sprites_svgp(
        rng.randn(m, SPRITES_LA + SPRITES_LC),
        rng.randn(N_ACTIONS, SPRITES_LA), L_action=SPRITES_LA,
        config=JConfig(titsias=True, jitter=SPRITES_JITTER,
                       N_train=50 * SPRITES_B), dtype=dtype)
    frames = rng.rand(n_chars * FPC, 64, 64, 3)
    aids = rng.randint(0, N_ACTIONS, n_chars * FPC).astype(np.float64)
    return (vae, rep), {"vae": vae_p, "repr": rep_p, "gp": gp}, \
        (frames, aids)


def _sprites_port(params, tdtype):
    cfg = params["gp"].config
    port = sprites_train_params_from_jax(
        flatten_params(params), tgp.SVGPConfig(
            titsias=True, jitter=cfg.jitter, N_train=cfg.N_train),
        L_action=SPRITES_LA)
    return {k: port[k].to(tdtype) if k != "gp" else port[k].to(dtype=tdtype)
            for k in ("vae", "repr", "gp")}


IMPL = {"mnist": "fused_pallas", "sprites": "fused"}  # the CUDA cells
# --- training steps ----------------------------------------------------------


def _plain_loss(workload, nets):
    """The JAX drivers' loss for SVGPVAE_Titsias without --GECO: -elbo."""
    def loss_fn(params, batch, key, geco, step):
        kw = dict(beta=BETA, C_ma=geco.C_ma,
                  lagrange_mult=geco.lagrange_mult, alpha=0.99, kappa=0.1,
                  clip_qs=True, geco=False, gp_block_impl=IMPL[workload])
        if workload == "sprites":
            vae, rep = nets
            kw.update(repr_apply=rep.apply, repr_params=params["repr"],
                      frames_per_char=FPC)
        else:
            vae = nets
        out = jmodels.forward_pass_svgpvae(vae, params["vae"], params["gp"],
                                           batch, key, **kw)
        scale = (jnp.abs(out.recon_loss) + BETA / out.p_m.shape[1]
                 * (jnp.abs(out.inside_elbo) + jnp.abs(out.ce_term))
                 + jnp.abs(out.elbo))
        return -out.elbo, (geco, {"scale": scale})
    return loss_fn


@pytest.mark.parametrize("workload", ["mnist", "sprites"])
def test_train_steps_match_jax(workload):
    """Two steps of the plain Titsias objective through the CUDA cell's
    block (B1's twin for MNIST's fused_pallas on the CPU): the loss of
    each step, the first step's gradients and the parameters after
    both."""
    lr = 1e-3
    if workload == "mnist":
        nets, params, batches = _mnist_case(jnp.float32)
        port = _mnist_port(params, torch.float32)
    else:
        nets, params, (frames, aids) = _sprites_case(jnp.float32, n_chars=4)
        batches = [(frames[lo:lo + SPRITES_B], aids[lo:lo + SPRITES_B])
                   for lo in (0, SPRITES_B)]
        port = _sprites_port(params, torch.float32)
    batches = [tuple(np.asarray(a, np.float32) for a in b) for b in batches]
    tx = jtrain.make_optimizer(lr)
    state = jtrain.TrainState.create(params, tx, jax.random.PRNGKey(11))
    loss_j = _plain_loss(workload, nets)
    b, L = len(batches[0][0]), port["vae"].L
    eps, key = [], state.key  # the noise make_train_step draws
    for _ in batches:
        key, sub = jax.random.split(key)
        eps.append(torch.from_numpy(np.array(jax.random.normal(sub, (b, L)))))
    (_, _), want_grads = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(
        params, tuple(jnp.asarray(a) for a in batches[0]),
        jax.random.split(state.key)[1], state.geco, state.step)
    step = jtrain.make_train_step(loss_j, tx, donate=False)

    trainable = ttrain.trainable_tensors(port, lambda name: True)
    t_state = ttrain.TrainState(
        params=port, optimizer=ttrain.make_optimizer(trainable, lr),
        geco=ttrain.GECOState.init())
    kw = dict(beta=BETA, alpha=0.99, kappa=0.1, clip_qs=True, geco=False,
              gp_block_impl=IMPL[workload])

    def loss_fn(params, batch, geco, step_):
        extra = (dict(repr_net=params["repr"], frames_per_char=FPC)
                 if workload == "sprites" else {})
        out = tmodels.forward_pass_svgpvae(
            params["vae"], params["gp"], batch, eps[step_], C_ma=geco.C_ma,
            lagrange_mult=geco.lagrange_mult, **kw, **extra)
        return -out.elbo, (geco, {})

    to_port = (mnist_params_from_jax if workload == "mnist"
               else params_from_jax)
    for i, batch in enumerate(batches):
        state, m = step(state, tuple(jnp.asarray(a) for a in batch))
        tm = ttrain.train_step(t_state, tuple(map(torch.from_numpy, batch)),
                               loss_fn)
        assert abs(float(tm["loss"]) - float(m["loss"])) <= \
            RTOL_LOSS * float(m["scale"]), (float(tm["loss"]),
                                            float(m["loss"]))
        if i == 0:
            conv = to_port(flatten_params(want_grads))
            for part, d in conv.items():
                for k, w in d.items():
                    g, w = trainable[f"{part}/{k}"].grad, _np(w)
                    # a GP tensor the kernel does not use has no gradient
                    g = np.zeros_like(w) if g is None else _np(g)
                    err = np.abs(g - w).max()
                    assert err <= GRAD_RTOL32[workload] * max(
                        np.abs(w).max(), 1e-30), (part, k, err)
    assert t_state.step == int(state.step) == 2
    conv = to_port(flatten_params(state.params))
    for part, d in conv.items():
        for k, w in d.items():
            np.testing.assert_allclose(_np(trainable[f"{part}/{k}"]), _np(w),
                                       atol=PARAM_ATOL, err_msg=f"{part}/{k}")
