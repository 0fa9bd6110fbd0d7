"""Linear-algebra substrate for the GP math (port of svgpvae_tpu/linalg.py).

Jittered Cholesky factorizations + `cho_solve` for every PSD system.
`precise` is the port's form of the JAX package's HIGHEST-precision guard:
it runs a function with TF32 off, so CUDA matmuls stay IEEE fp32 in the
cancellation-heavy GP assembly.

Also the small closed forms shared by every ELBO: `gauss_cross_entropy`,
`kl_diag_standard_normal` and `mvn_kl_against_prior` (KL(N(mu, S) ||
N(0, K)) given chol(K)).
"""

from __future__ import annotations

import functools
import math

import torch
from torch import Tensor

LOG_2PI = math.log(2.0 * math.pi)


def precise(fn):
    """Run `fn` with TF32 disabled for matmuls and cuDNN, restoring the
    caller's settings afterwards."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        matmul = torch.backends.cuda.matmul.allow_tf32
        cudnn = torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn

    return wrapper


def add_jitter(mat: Tensor, jitter) -> Tensor:
    """M + jitter * I on the last two dims."""
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
    return mat + jitter * eye


def safe_cholesky(mat: Tensor, jitter) -> Tensor:
    """Lower Cholesky factor of the jittered matrix.  Like
    jnp.linalg.cholesky, a failed factorization gives NaNs rather than an
    error (and no host sync)."""
    chol, info = torch.linalg.cholesky_ex(add_jitter(mat, jitter))
    return torch.where((info != 0)[..., None, None],
                       torch.full_like(chol, float("nan")), chol)


def cho_solve(chol: Tensor, b: Tensor) -> Tensor:
    """Solve (L L^T) x = b given lower-triangular L; batched."""
    return torch.cholesky_solve(b, chol)


def psd_solve(mat: Tensor, b: Tensor, jitter) -> Tensor:
    """Solve M x = b for PSD M with diagonal jitter."""
    return cho_solve(safe_cholesky(mat, jitter), b)


def psd_inverse(mat: Tensor, jitter) -> Tensor:
    """Explicit inverse of a PSD matrix via its jittered Cholesky."""
    chol = safe_cholesky(mat, jitter)
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
    return cho_solve(chol, eye.expand(mat.shape))


def logdet_from_chol(chol: Tensor) -> Tensor:
    """log det(L L^T) = 2 * sum(log diag L); batched over leading dims."""
    diag = torch.diagonal(chol, dim1=-2, dim2=-1)
    return 2.0 * torch.sum(torch.log(diag), dim=-1)


def reciprocal_no_nan(x: Tensor) -> Tensor:
    """1/x with 0 -> 0 (tf.math.reciprocal_no_nan)."""
    zero = x == 0
    return torch.where(zero, torch.zeros_like(x),
                       1.0 / torch.where(zero, torch.ones_like(x), x))


def stable_sqrt(x: Tensor) -> Tensor:
    """sqrt with a non-negative clamp."""
    return torch.sqrt(torch.clamp(x, min=0.0))


def gauss_cross_entropy(mu1: Tensor, var1: Tensor, mu2: Tensor,
                        var2: Tensor) -> Tensor:
    """Elementwise E_{N(z; mu1, var1)}[log N(z; mu2, var2)] (not summed)."""
    term1 = torch.log(var2)
    term2 = (var1 + mu1 * mu1 - 2.0 * mu1 * mu2 + mu2 * mu2) / var2
    return -0.5 * (LOG_2PI + term1 + term2)


def kl_diag_standard_normal(mean: Tensor, var: Tensor) -> Tensor:
    """KL(N(mean, diag(var)) || N(0, I)) summed over ALL elements."""
    n = mean.numel()
    return 0.5 * (-n - torch.sum(torch.log(var)) + torch.sum(var)
                  + torch.sum(mean * mean))


def mvn_kl_against_prior(mu: Tensor, S: Tensor, K_chol: Tensor,
                         jitter) -> Tensor:
    """KL( N(mu, S) || N(0, K) ) with K given by its (jittered) Cholesky,

        0.5 * ( logdet K - logdet S - m + tr(K^{-1} S) + mu^T K^{-1} mu ),

    batched over the leading dims of mu (..., m) and S (..., m, m); S is
    jittered before its factorization."""
    m = mu.shape[-1]
    S_chol = safe_cholesky(S, jitter)
    trace = torch.diagonal(cho_solve(K_chol, S), dim1=-2,
                           dim2=-1).sum(dim=-1)
    quad = torch.sum(mu * cho_solve(K_chol, mu[..., None])[..., 0], dim=-1)
    return 0.5 * (logdet_from_chol(K_chol) - logdet_from_chol(S_chol) - m
                  + trace + quad)


def solve_lower_triangular(chol: Tensor, b: Tensor) -> Tensor:
    """L^{-1} b for lower-triangular L (whitening solve)."""
    return torch.linalg.solve_triangular(chol, b, upper=False)


def clip(x: Tensor, lo: float, hi: float) -> Tensor:
    return torch.clamp(x, lo, hi)


def tree_value_clip(tensors, limit: float) -> None:
    """Value-clip every tensor of an iterable to +/- limit, in place (the
    port's form of the JAX tree map over a gradient pytree; None entries,
    e.g. the .grad of a parameter that got none, are skipped)."""
    for t in tensors:
        if t is not None:
            t.clamp_(-limit, limit)
