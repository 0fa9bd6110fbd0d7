"""The port's sufficient-statistics ops against the JAX Pallas kernels.

CPU: the plain twins (`gp_sufficient_stats_reference`,
`fused_kernel_stats_reference`) against `gp_sufficient_stats(...,
interpret=True)` and `fused_kernel_stats(..., tile_n=64, interpret=True)`
of svgpvae_tpu, on the same numpy inputs, in float32.  Tolerance
rtol 2e-4 / atol 2e-3, the one tests/test_ops.py holds the Pallas kernels
to against their XLA reference (fp32 sums of up to 1000 terms of
magnitude ~10 in different orders).

The CUDA kernels against these twins on the card: tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu.ops.fused_kernel_stats import (
    fused_kernel_stats as jax_fused_kernel_stats)
from svgpvae_tpu.ops.gp_stats import gp_sufficient_stats as jax_gp_stats
from svgpvae_tpu_torch.ops import fused_kernel_stats as fks
from svgpvae_tpu_torch.ops import gp_stats as gps
from torch_threads import _torch_threads  # noqa: E402,F401

RTOL, ATOL = 2e-4, 2e-3


def _stats_inputs(rng, n, m, L):
    knm = rng.randn(n, m).astype(np.float32)
    prec = (rng.rand(n, L) + 0.5).astype(np.float32)
    py = rng.randn(n, L).astype(np.float32)
    return knm, prec, py


def _feature_inputs(rng, n, m, d1, d2, L, family):
    if family == "mnist":
        f1 = rng.rand(n, d1) * 2 * np.pi
        ip1 = rng.rand(m, d1) * 2 * np.pi
    else:
        f1, ip1 = rng.randn(n, d1), rng.randn(m, d1)
    f2, ip2 = rng.randn(n, d2), rng.randn(m, d2)
    prec = rng.rand(n, L) + 0.5
    py = rng.randn(n, L)
    return [a.astype(np.float32) for a in (f1, f2, ip1, ip2, prec, py)]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("n,m,L,tile", [(100, 32, 4, 64), (512, 72, 8, 128),
                                        (1000, 128, 16, 256),
                                        (130, 17, 3, 64), (77, 5, 1, 64)])
def test_gp_stats_twin_matches_pallas(n, m, L, tile):
    rng = np.random.RandomState(n + m + L)
    knm, prec, py = _stats_inputs(rng, n, m, L)
    want = jax_gp_stats(jnp.asarray(knm), jnp.asarray(prec), jnp.asarray(py),
                        tile_n=tile, interpret=True)
    got = gps.gp_sufficient_stats_reference(
        *(torch.from_numpy(a) for a in (knm, prec, py)))
    assert got[0].shape == (L, m, m) and got[1].shape == (L, m)
    _close(got, want)


FEATURE_CASES = [
    # family, n, m, d1, d2, L
    ("mnist", 200, 20, 1, 8, 4),
    ("mnist", 131, 9, 1, 5, 3),
    ("sprites", 150, 30, 3, 5, 6),
    ("sprites", 97, 13, 8, 16, 5),
]


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("family,n,m,d1,d2,L", FEATURE_CASES)
def test_fused_kernel_stats_twin_matches_pallas(family, n, m, d1, d2, L,
                                                normalize):
    rng = np.random.RandomState(n * 7 + m)
    arrs = _feature_inputs(rng, n, m, d1, d2, L, family)
    amp, ls = (0.9, 1.3) if family == "mnist" else (None, None)
    want = jax_fused_kernel_stats(
        *(jnp.asarray(a) for a in arrs), amp=amp, length_scale=ls,
        family=family, normalize=normalize, tile_n=64, interpret=True)
    got = fks.fused_kernel_stats_reference(
        *(torch.from_numpy(a) for a in arrs), amp=amp, length_scale=ls,
        family=family, normalize=normalize)
    _close(got, want)


def test_fused_normalize_clamps_zero_rows_like_pallas():
    """An all-zero data row contributes 0 (norm clamped at 1e-30), not NaN."""
    rng = np.random.RandomState(3)
    arrs = _feature_inputs(rng, 70, 11, 3, 4, 2, "sprites")
    arrs[0][5] = 0.0
    arrs[1][9] = 0.0
    want = jax_fused_kernel_stats(*(jnp.asarray(a) for a in arrs),
                                  family="sprites", normalize=True,
                                  tile_n=64, interpret=True)
    got = fks.fused_kernel_stats_reference(
        *(torch.from_numpy(a) for a in arrs), family="sprites",
        normalize=True)
    assert all(torch.isfinite(g).all() for g in got)
    _close(got, want)


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    rng = np.random.RandomState(4)
    knm, prec, py = (torch.from_numpy(a) for a in _stats_inputs(rng, 40, 6, 2))
    before = gps.gp_sufficient_stats.launches
    got = gps.gp_sufficient_stats(knm, prec, py)
    want = gps.gp_sufficient_stats_reference(knm, prec, py)
    assert gps.gp_sufficient_stats.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    arrs = [torch.from_numpy(a)
            for a in _feature_inputs(rng, 40, 6, 2, 3, 2, "sprites")]
    before = fks.fused_kernel_stats.launches
    got = fks.fused_kernel_stats(*arrs, family="sprites")
    want = fks.fused_kernel_stats_reference(*arrs, family="sprites")
    assert fks.fused_kernel_stats.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_non_cpu_non_cuda_tensors_raise():
    """Only CPU tensors take the twin; anything else must be CUDA."""
    knm = torch.empty(8, 4, device="meta")
    prec = torch.empty(8, 2, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gps.gp_sufficient_stats(knm, prec, prec)
    with pytest.raises(ValueError, match="CUDA"):
        fks.fused_kernel_stats(knm, knm, knm, knm, prec, prec,
                               family="sprites")
