"""The port's B1 (chol_inverse) and the differentiable gp_stats against JAX.

CPU: the plain twin `chol_inverse_reference` (Cholesky) against the JAX
package's `chol_inverse_ref` and its Pallas kernel
`chol_inverse_pallas(..., interpret=True)` (Gauss-Jordan), in float32, on
PD stacks of condition 1e4 (1e3 at m = 72).  Tolerances are those
tests/test_fused_gp.py holds the Pallas kernel to: the inverse within 5e-4
of its own max |entry| and logdet within rtol 1e-5 (1e-4 at m = 72), both
methods being backward-stable at ~cond * eps.

The autograd backwards (`chol_inverse`, `gp_stats`) are held to `jax.vjp`
of the JAX custom-VJP functions at float64 (rtol 1e-9: the same formulas
summed in another order).  B1's is compared through M = B B^T + I, where
dL/dB is unique (a raw dL/dM depends on the symmetrization convention).

The CUDA kernels against these twins on the card: tests/test_torch_cuda.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu.ops.chol_inverse import (chol_inverse as jax_chol_inverse,
                                          chol_inverse_pallas,
                                          chol_inverse_ref)
from svgpvae_tpu.ops.gp_stats import gp_stats as jax_gp_stats
from svgpvae_tpu_torch.ops import chol_inverse as ci
from svgpvae_tpu_torch.ops import gp_stats as gps
from torch_threads import _torch_threads  # noqa: E402,F401

RTOL64 = 1e-9


def _pd_stack(rng, B, m, cond):
    out = np.empty((B, m, m))
    for i in range(B):
        Q, _ = np.linalg.qr(rng.randn(m, m))
        out[i] = (Q * np.logspace(0, np.log10(cond), m)) @ Q.T
    return out.astype(np.float32)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("B,m,cond", [(17, 32, 1e4), (5, 72, 1e3),
                                      (3, 37, 1e4), (5, 15, 1e4)])
def test_twin_matches_jax_ref_and_pallas(B, m, cond):
    M = _pd_stack(np.random.RandomState(B * m), B, m, cond)
    inv, ld = (x.numpy() for x in ci.chol_inverse_kernel(torch.from_numpy(M)))
    rtol_ld = 1e-4 if m >= 72 else 1e-5
    for impl in (chol_inverse_ref,
                 lambda x: chol_inverse_pallas(x, interpret=True)):
        inv_j, ld_j = (np.asarray(x) for x in impl(jnp.asarray(M)))
        scale = np.abs(inv_j).max()
        np.testing.assert_allclose(inv / scale, inv_j / scale, atol=5e-4)
        np.testing.assert_allclose(ld, ld_j, rtol=rtol_ld)


@pytest.mark.parametrize("B,m,cond", [(17, 32, 1e4), (5, 72, 1e3),
                                      (3, 37, 1e4)])
def test_gauss_jordan_witness_matches_jax_pallas(B, m, cond):
    """The plain Gauss-Jordan witness (the kernel's method one pivot at a
    time) against the JAX Pallas kernel's Gauss-Jordan, at the twin's
    tolerances; a pivot <= 0 gives a NaN logdet, as in JAX."""
    M = _pd_stack(np.random.RandomState(B + m), B, m, cond)
    inv, ld = (x.numpy() for x in
               ci.gauss_jordan_reference(torch.from_numpy(M)))
    inv_j, ld_j = (np.asarray(x) for x in
                   chol_inverse_pallas(jnp.asarray(M), interpret=True))
    scale = np.abs(inv_j).max()
    np.testing.assert_allclose(inv / scale, inv_j / scale, atol=5e-4)
    np.testing.assert_allclose(ld, ld_j, rtol=1e-4 if m >= 72 else 1e-5)
    M[1, 2, 2] = -1.0
    _, ld = ci.gauss_jordan_reference(torch.from_numpy(M))
    assert np.isfinite(float(ld[0])) and np.isnan(float(ld[1]))


def test_twin_gives_nan_off_pd_like_jax():
    M = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    M[1, 1, 1] = -1.0
    inv, ld = ci.chol_inverse_kernel(torch.from_numpy(M))
    inv_j, ld_j = chol_inverse_ref(jnp.asarray(M))
    assert float(ld[0]) == 0.0 and np.isnan(float(ld[1]))
    assert np.isnan(float(ld_j[1]))
    assert bool(torch.isnan(inv[1]).all()) and bool(jnp.isnan(inv_j[1]).all())


def test_cpu_tensors_launch_no_kernel():
    before = ci.chol_inverse_kernel.launches
    ci.chol_inverse(torch.eye(4)[None] * 2.0)
    assert ci.chol_inverse_kernel.launches == before


def test_chol_inverse_vjp_matches_jax(x64):
    rng = np.random.RandomState(3)
    Bm, gi, gl = rng.randn(4, 16, 16), rng.randn(4, 16, 16), rng.randn(4)

    def jax_loss(b):
        inv, ld = jax_chol_inverse(b @ b.transpose(0, 2, 1) + jnp.eye(16))
        return jnp.sum(inv * gi) + jnp.sum(ld * gl)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(Bm)))
    b = torch.tensor(Bm, requires_grad=True)
    inv, ld = ci.chol_inverse(b @ b.transpose(1, 2)
                              + torch.eye(16, dtype=torch.float64))
    (got,) = torch.autograd.grad(
        torch.sum(inv * torch.from_numpy(gi))
        + torch.sum(ld * torch.from_numpy(gl)), b)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL64,
                               atol=RTOL64 * np.abs(want).max())


def test_gp_stats_vjp_matches_jax_in_all_arguments(x64):
    rng = np.random.RandomState(5)
    n, m, L = 40, 9, 3
    knm, prec, py = rng.randn(n, m), rng.rand(n, L) + 0.5, rng.randn(n, L)
    d_sigma, d_r = rng.randn(L, m, m), rng.randn(L, m)
    out, vjp = jax.vjp(jax_gp_stats, *(jnp.asarray(a)
                                       for a in (knm, prec, py)))
    want = vjp((jnp.asarray(d_sigma), jnp.asarray(d_r)))
    args = [torch.tensor(a, requires_grad=True) for a in (knm, prec, py)]
    sigma, r = gps.gp_stats(*args)
    for g, w in zip((sigma, r), out):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL64)
    got = torch.autograd.grad((sigma, r), args, (torch.from_numpy(d_sigma),
                                                 torch.from_numpy(d_r)))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL64,
                                   atol=RTOL64 * np.abs(w).max())


def test_gp_stats_takes_a_strided_kernel_matrix():
    """A transposed view is made contiguous before the kernel sees it."""
    rng = np.random.RandomState(6)
    k = torch.tensor(rng.randn(7, 20))
    prec, py = torch.tensor(rng.rand(20, 2)), torch.tensor(rng.randn(20, 2))
    for g, w in zip(gps.gp_stats(k.T, prec, py),
                    gps.gp_sufficient_stats_reference(k.T.contiguous(),
                                                      prec, py)):
        assert torch.equal(g, w)
