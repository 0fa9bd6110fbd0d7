"""svgpvae_tpu_torch.kernels / .linalg against their JAX twins at float64.

Same numpy inputs through both; at float64 the two differ only by
summation order, so the tolerance is rtol 1e-10 / atol 1e-12.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import kernels as jk, linalg as jl
from svgpvae_tpu_torch import kernels as tk, linalg as tl
from torch_threads import _torch_threads  # noqa: E402,F401

RTOL, ATOL = 1e-10, 1e-12


@pytest.fixture(autouse=True, scope="module")
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _pair(rng, n, m, d):
    x, y = rng.randn(n, d), rng.randn(m, d)
    return x, y, torch.from_numpy(x), torch.from_numpy(y)


@pytest.mark.parametrize("n,m,d", [(7, 5, 3), (1, 4, 1), (9, 9, 16)])
def test_matrix_kernels(n, m, d):
    rng = np.random.RandomState(n * 100 + m)
    x, y, tx, ty = _pair(rng, n, m, d)
    _close(tk.sq_dists(tx, ty), jk.sq_dists(x, y))
    _close(tk.rbf_matrix(tx, ty, 0.7), jk.rbf_matrix(x, y, 0.7))
    _close(tk.rbf_matrix(tx, ty, 1.3, 0.4), jk.rbf_matrix(x, y, 1.3, 0.4))
    _close(tk.exp_sin_squared_matrix(tx, ty, 0.9, 1.2, 2 * np.pi),
           jk.exp_sin_squared_matrix(x, y, 0.9, 1.2, 2 * np.pi))
    k_t, k_j = tk.linear_matrix(tx, ty), jk.linear_matrix(x, y)
    _close(k_t, k_j)
    _close(tk.cosine_normalize_matrix(k_t, tx, ty),
           jk.cosine_normalize_matrix(k_j, x, y))


@pytest.mark.parametrize("n,d", [(6, 3), (1, 1), (11, 16)])
def test_diag_kernels(n, d):
    rng = np.random.RandomState(n + d)
    x, y, tx, ty = _pair(rng, n, n, d)
    _close(tk.rbf_diag(tx, ty, 0.7), jk.rbf_diag(x, y, 0.7))
    _close(tk.rbf_diag(tx, ty, 1.3, 0.4), jk.rbf_diag(x, y, 1.3, 0.4))
    _close(tk.exp_sin_squared_diag(tx, ty, 0.9, 1.2, 2 * np.pi),
           jk.exp_sin_squared_diag(x, y, 0.9, 1.2, 2 * np.pi))
    k_t, k_j = tk.linear_diag(tx, ty), jk.linear_diag(x, y)
    _close(k_t, k_j)
    _close(tk.cosine_normalize_diag(k_t, tx, ty),
           jk.cosine_normalize_diag(k_j, x, y))


def _spd(rng, batch, m):
    a = rng.randn(*batch, m, m)
    return a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(m)


@pytest.mark.parametrize("batch,m", [((), 5), ((3,), 7), ((2, 2), 4)])
def test_cholesky_family(batch, m):
    rng = np.random.RandomState(m)
    mat = _spd(rng, batch, m)
    b = rng.randn(*batch, m, 2)
    t_mat, t_b = torch.from_numpy(mat), torch.from_numpy(b)
    _close(tl.add_jitter(t_mat, 0.01), jl.add_jitter(mat, 0.01))
    chol_t, chol_j = tl.safe_cholesky(t_mat, 1e-3), jl.safe_cholesky(mat, 1e-3)
    _close(chol_t, chol_j)
    _close(tl.cho_solve(chol_t, t_b), jl.cho_solve(jnp.asarray(chol_j), b))
    _close(tl.psd_inverse(t_mat, 1e-3), jl.psd_inverse(mat, 1e-3))


def test_safe_cholesky_failure_gives_nan_like_jax():
    """An indefinite matrix: JAX returns NaNs, and so must the port."""
    mat = np.diag([1.0, -2.0, 3.0])
    want = np.asarray(jl.safe_cholesky(mat, 0.0))
    got = tl.safe_cholesky(torch.from_numpy(mat), 0.0).numpy()
    assert np.isnan(want).any()
    assert np.isnan(got).all()


def test_elementwise_helpers():
    x = np.array([0.0, -2.0, 0.5, 3.0, -0.0, 1e-30])
    tx = torch.from_numpy(x)
    _close(tl.reciprocal_no_nan(tx), jl.reciprocal_no_nan(x))
    _close(tl.stable_sqrt(tx), jl.stable_sqrt(x))


def test_precise_turns_tf32_off_and_restores():
    seen = []

    @tl.precise
    def probe():
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))

    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        probe()
        assert seen == [(False, False)]
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = before
