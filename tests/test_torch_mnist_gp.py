"""The port's rotated-MNIST GP against the JAX package, at float64.

  * linalg's ELBO closed forms;
  * MnistSVGP.kmat / kdiag, with and without the GPLVM table and the
    cosine-normalized object kernel;
  * the two-pass path (posterior_params, hensman_terms, variational_loss)
    and the fused block gp_block_hensman for every inverse_impl x kl_impl
    (and the "pallas" inverse at m = 256, --nr_inducing_points 16):
    values, and gradients with respect to the GP parameters and the
    encoder outputs;
  * the SPRITES fused block of the CUDA path (pallas x rejitter) at
    m = 24 and at m = 288 (--m 4), on a rank-deficient K_mm.

Tolerance rtol 1e-9 (relative to each output's max |entry|): the same
formulas at float64, summed in other orders.  The "pallas" inverse runs
the Cholesky twin on the CPU in the port and JAX's XLA reference off the
TPU, so both sides factorize.  The JAX references compile at XLA's
lowest optimisation level (tests/test_torch_sprites_train.py's quick_jit),
which moves their results by round-off.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import gp as jgp, linalg as jlinalg
from svgpvae_tpu.gp.svgp import SVGPConfig as JConfig
from svgpvae_tpu_torch import gp as tgp, linalg as tlinalg

from test_torch_sprites_train import quick_jit
from torch_threads import _torch_threads  # noqa: E402,F401

RTOL64 = 1e-9
# The blocks at m = 256 and 288 on a rank-deficient K_mm (PD only through
# the jitter): K_mm^-1 carries entries ~1/jitter, the gradients go through
# it twice, and the same float64 math summed in other orders agrees to
# ~cond^2 * eps, not 1e-9 (1e-6 is the bound the SPRITES forward tests and
# tests/test_fused_gp.py hold the "pallas" path to at float64).
RANK_DEFICIENT_RTOL64 = 1e-6


@pytest.fixture(autouse=True)
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _close(got, want, rtol=RTOL64):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _t(a):
    return torch.tensor(np.array(a, np.float64))


def test_linalg_closed_forms_match_jax():
    rng = np.random.RandomState(0)
    m = 6
    A = rng.randn(3, m, m)
    S = A @ A.transpose(0, 2, 1) + np.eye(m)
    Kf = rng.randn(m, m)
    K = Kf @ Kf.T + np.eye(m)
    Kc = np.linalg.cholesky(K)
    mu, v1, v2 = rng.randn(3, m), rng.rand(3, m) + .1, rng.rand(3, m) + .1
    b = rng.randn(m, 2)
    _close(tlinalg.logdet_from_chol(_t(np.linalg.cholesky(S))),
           jlinalg.logdet_from_chol(jnp.linalg.cholesky(S)))
    _close(tlinalg.gauss_cross_entropy(*map(_t, (mu, v1, mu[::-1], v2))),
           jlinalg.gauss_cross_entropy(mu, v1, mu[::-1], v2))
    _close(tlinalg.kl_diag_standard_normal(_t(mu), _t(v1)),
           jlinalg.kl_diag_standard_normal(mu, v1))
    _close(tlinalg.mvn_kl_against_prior(_t(mu), _t(S), _t(Kc), 1e-3),
           jax.vmap(lambda a, s: jlinalg.mvn_kl_against_prior(
               a, s, Kc, 1e-3))(mu, S))
    _close(tlinalg.solve_lower_triangular(_t(Kc), _t(b)),
           jlinalg.solve_lower_triangular(Kc, b))
    _close(tlinalg.psd_solve(_t(K), _t(b), 1e-6),
           jlinalg.psd_solve(K, b, 1e-6))
    _close(tlinalg.clip(_t(b), -0.5, 0.5), jlinalg.clip(b, -0.5, 0.5))
    g = [_t(b), None, _t(mu)]
    tlinalg.tree_value_clip(g, 0.3)
    for got, want in zip((g[0], g[2]),
                         jlinalg.tree_value_clip([b, mu], 0.3)):
        _close(got, want)


def _problem(rng, table, normalize, b=24, L=3, M=4, m=8, n_obj=10,
             jitter=1e-6):
    ip = np.hstack([np.arange(m)[:, None], rng.rand(m, 1) * 2 * np.pi,
                    rng.randn(m, M)])
    ids = rng.randint(0, n_obj, (b, 1)).astype(float)
    aux = np.hstack([ids, rng.rand(b, 1) * 2 * np.pi, rng.randn(b, M)])
    table_init = rng.randn(n_obj, M) if table else None
    y, noise = rng.randn(b, L), np.clip(np.exp(rng.randn(b, L)), 1e-3, 10.)
    cfg = dict(jitter=jitter, N_train=240, K_obj_normalize=normalize)
    j_gp = jgp.init_mnist_svgp(ip, table_init, config=JConfig(**cfg),
                               dtype=jnp.float64)
    j_gp = j_gp.replace(length_scale=jnp.asarray(0.8),
                        amplitude=jnp.asarray(1.3))
    t_gp = tgp.init_mnist_svgp(ip, table_init, config=tgp.SVGPConfig(**cfg),
                               dtype=torch.float64)
    t_gp.length_scale, t_gp.amplitude = _t(0.8), _t(1.3)
    return j_gp, t_gp, aux, y, noise


@pytest.mark.parametrize("table", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_kmat_kdiag_match_jax(table, normalize):
    j_gp, t_gp, aux, _, _ = _problem(np.random.RandomState(1), table,
                                     normalize)
    z = np.asarray(j_gp.inducing_points)
    for x_ind in (False, True):
        x = z if x_ind else aux
        _close(t_gp.kmat(_t(x), _t(z), x_inducing=x_ind),
               j_gp.kmat(x, z, x_inducing=x_ind))
        _close(t_gp.kdiag(_t(x), _t(x), x_inducing=x_ind,
                          y_inducing=x_ind),
               j_gp.kdiag(x, x, x_inducing=x_ind, y_inducing=x_ind))


def _gp_tensors(t_gp):
    for t in t_gp.named_tensors().values():
        t.requires_grad_(True)


def _jax_grads(fn, j_gp, y, noise):
    """Value and gradients of sum(outputs * weights) in JAX."""
    return quick_jit(jax.value_and_grad(fn, argnums=(0, 1, 2)))(
        j_gp, jnp.asarray(y), jnp.asarray(noise))


def _check_grads(t_loss, t_gp, y_t, noise_t, j_loss, j_grads,
                 rtol=RTOL64):
    """The loss and its gradients against JAX's; a GP tensor the loss does
    not use (the SPRITES linear kernel's length scales) has gradient 0."""
    _close(t_loss, j_loss, rtol)
    names = list(t_gp.named_tensors())
    grads = torch.autograd.grad(t_loss, _gp_leaves(t_gp) + [y_t, noise_t],
                                allow_unused=True)
    for name, g in zip(names, grads):
        want = np.asarray(getattr(j_grads[0], name))
        _close(torch.zeros(want.shape, dtype=torch.float64) if g is None
               else g, want, rtol)
    _close(grads[-2], j_grads[1], rtol)
    _close(grads[-1], j_grads[2], rtol)


def _gp_leaves(t_gp):
    return list(t_gp.named_tensors().values())


def _weights(rng, shapes):
    return [rng.randn(*s) for s in shapes]


@pytest.mark.parametrize("table", [False, True])
def test_two_pass_path_matches_jax(table):
    rng = np.random.RandomState(2)
    j_gp, t_gp, aux, y, noise = _problem(rng, table, normalize=False)
    b, L = y.shape
    m = j_gp.inducing_points.shape[0]
    w = _weights(rng, [(b, L), (b, L), (L, m), (L, m, m), (L,), (L,)])

    def j_fn(gp, y_, noise_):
        p_m, p_v, mu, A = jgp.posterior_params(gp, aux, aux, y_, noise_)
        s, kl = jgp.variational_loss(gp, aux, y_, noise_, mu, A)
        return sum(jnp.sum(o * wi) for o, wi in zip((p_m, p_v, mu, A, s, kl),
                                                     w))

    j_loss, j_grads = _jax_grads(j_fn, j_gp, y, noise)
    _gp_tensors(t_gp)
    y_t, noise_t = _t(y).requires_grad_(), _t(noise).requires_grad_()
    aux_t = _t(aux)
    p_m, p_v, mu, A = tgp.posterior_params(t_gp, aux_t, aux_t, y_t, noise_t)
    s, kl = tgp.variational_loss(t_gp, aux_t, y_t, noise_t, mu, A)
    outs = (p_m, p_v, mu, A, s, kl)
    j_outs = jgp.posterior_params(j_gp, aux, aux, y, noise)
    j_outs = j_outs + jgp.variational_loss(j_gp, aux, y, noise, *j_outs[2:])
    for o, jo in zip(outs, j_outs):
        _close(o, jo)
    t_loss = sum(torch.sum(o * _t(wi)) for o, wi in zip(outs, w))
    _check_grads(t_loss, t_gp, y_t, noise_t, j_loss, j_grads)


def test_hensman_terms_match_jax():
    rng = np.random.RandomState(3)
    j_gp, t_gp, aux, y, noise = _problem(rng, True, normalize=True)
    _, _, mu, A = jgp.posterior_params(j_gp, aux, aux, y, noise)
    j_bundle = jgp.kernel_matrices(j_gp, jnp.asarray(aux))
    t_bundle = tgp.kernel_matrices(t_gp, _t(aux))
    for g, w in zip(t_bundle, j_bundle):
        _close(g, w)
    want = jgp.hensman_terms(j_gp, *j_bundle[1:], y, noise, mu, A)
    got = tgp.hensman_terms(t_gp, *t_bundle[1:], _t(y), _t(noise), _t(mu),
                            _t(A))
    for g, w in zip(got, want):
        _close(g, w)


# m = 256 is --nr_inducing_points 16: the stack that takes B1's panel form
# on the card (here B1's Cholesky twin, and JAX's XLA reference), with
# jitter 1e-3 as chip_smoke.py's phase 10 runs it.  Its K_mm is rank
# deficient (linear in M = 4 object dimensions), so it is held to
# RANK_DEFICIENT_RTOL64; at jitter 1e-6 even the values are ~1.5e-6 apart.
@pytest.mark.parametrize("inverse_impl,kl_impl,m", [
    pytest.param(inv, kl, m, id=f"{kl}-{inv}" + ("" if m == 8 else f"-m{m}"))
    for m, invs in ((8, ("chol", "pallas")), (256, ("pallas",)))
    for kl in ("identity", "rejitter") for inv in invs])
def test_fused_block_matches_jax(inverse_impl, kl_impl, m):
    rng = np.random.RandomState(4)
    j_gp, t_gp, aux, y, noise = _problem(rng, True, normalize=False, m=m,
                                         jitter=1e-6 if m == 8 else 1e-3)
    b, L = y.shape
    w = _weights(rng, [(b, L), (b, L), (L,), (L,), (L, m)])
    kw = dict(inverse_impl=inverse_impl, kl_impl=kl_impl)

    def j_fn(gp, y_, noise_):
        outs = jgp.gp_block_hensman(gp, aux, y_, noise_, **kw)
        return sum(jnp.sum(o * wi) for o, wi in zip(outs, w))

    j_loss, j_grads = _jax_grads(j_fn, j_gp, y, noise)
    j_outs = jgp.gp_block_hensman(j_gp, aux, y, noise, **kw)
    _gp_tensors(t_gp)
    y_t, noise_t = _t(y).requires_grad_(), _t(noise).requires_grad_()
    outs = tgp.gp_block_hensman(t_gp, _t(aux), y_t, noise_t, **kw)
    rtol = RTOL64 if m == 8 else RANK_DEFICIENT_RTOL64
    for o, jo in zip(outs, j_outs):
        _close(o, jo, rtol)
    t_loss = sum(torch.sum(o * _t(wi)) for o, wi in zip(outs, w))
    _check_grads(t_loss, t_gp, y_t, noise_t, j_loss, j_grads, rtol)


@pytest.mark.parametrize("m", [24, 288])
def test_sprites_rejittered_block_matches_jax(m):
    """The SPRITES training block of the CUDA path (fused_rejitter_pallas:
    inverse_impl="pallas", kl_impl="rejitter"; B1's twin here, JAX's XLA
    reference) at float64, values and gradients.  m = 288 is --m 4 at
    L_action 8, L_character 16: K_mm has rank <= 128, PD only through the
    jitter, and A_hat + jitter reaches B1 at (L, 288, 288) -- the panel
    form on the card.  The port averages A_hat's triangles before B1 (a
    symmetric matrix either way at float64)."""
    rng = np.random.RandomState(m)
    n, L, La, Lc, n_actions = 30, 3, 8, 16, 72
    ip = rng.normal(0, 1.5, (m, La + Lc))
    gplvm = rng.normal(0, 1.5, (n_actions, La))
    aux = np.hstack([rng.randint(0, n_actions, (n, 1)),
                     rng.rand(n, Lc) * 0.5])
    y, noise = rng.randn(n, L), np.clip(np.exp(rng.randn(n, L)), 1e-3, 10.)
    cfg = dict(jitter=0.01, N_train=3000)
    j_gp = jgp.init_sprites_svgp(ip, gplvm, L_action=La,
                                 config=JConfig(**cfg), dtype=jnp.float64)
    t_gp = tgp.init_sprites_svgp(ip, gplvm, L_action=La,
                                 config=tgp.SVGPConfig(**cfg),
                                 dtype=torch.float64)
    w = _weights(rng, [(n, L), (n, L), (L,), (L,), (L, m)])
    kw = dict(inverse_impl="pallas", kl_impl="rejitter")

    def j_fn(gp, y_, noise_):
        outs = jgp.gp_block_hensman(gp, aux, y_, noise_, **kw)
        return sum(jnp.sum(o * wi) for o, wi in zip(outs, w))

    j_loss, j_grads = _jax_grads(j_fn, j_gp, y, noise)
    j_outs = jgp.gp_block_hensman(j_gp, aux, y, noise, **kw)
    _gp_tensors(t_gp)
    y_t, noise_t = _t(y).requires_grad_(), _t(noise).requires_grad_()
    outs = tgp.gp_block_hensman(t_gp, _t(aux), y_t, noise_t, **kw)
    for o, jo in zip(outs, j_outs):
        _close(o, jo, RANK_DEFICIENT_RTOL64)
    t_loss = sum(torch.sum(o * _t(wi)) for o, wi in zip(outs, w))
    _check_grads(t_loss, t_gp, y_t, noise_t, j_loss, j_grads,
                 RANK_DEFICIENT_RTOL64)


def test_fused_block_refuses_unknown_impls():
    _, t_gp, aux, y, noise = _problem(np.random.RandomState(5), False, False)
    with pytest.raises(ValueError):
        tgp.gp_block_hensman(t_gp, _t(aux), _t(y), _t(noise),
                             inverse_impl="triton")
