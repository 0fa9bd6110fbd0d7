"""Batched inverse + logdet of jittered PD matrices, with a two-matmul VJP.

    Minv   = M^{-1}          (B, m, m)
    logdet = log det M       (B,)

Port of svgpvae_tpu/ops/chol_inverse.py.  `chol_inverse_kernel` launches
the hand-written CUDA kernel (csrc/chol_inverse.cu::svgp_chol_inverse,
Gauss-Jordan: one warp per matrix in registers for m <= 32, one block per
matrix in shared memory above, replacing the Pallas kernel
svgpvae_tpu/ops/chol_inverse.py::chol_inverse_pallas) for CUDA tensors,
and runs the plain twin `chol_inverse_reference` (Cholesky-based) for CPU
tensors.  On CUDA the kernel always runs.  The kernel's bound and design
are described in the CUDA source.

`chol_inverse` is the differentiable form (the JAX custom_vjp): it saves
M^{-1}, and its backward is what JAX computes outside Pallas
(svgpvae_tpu/ops/chol_inverse.py::_bwd):

    d(M^{-1}) = -M^{-1} dM M^{-1}   =>  Mbar  = -Minv gInv Minv
    d(logdet) = tr(M^{-1} dM)       =>  Mbar += gLogdet * Minv

(M symmetric PD, so Minv^T = Minv.)  M must already be jittered.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from svgpvae_tpu_torch import linalg
from svgpvae_tpu_torch.ops import _build
from svgpvae_tpu_torch.ops.gp_stats import check_cuda_f32


@linalg.precise
def chol_inverse_reference(M: torch.Tensor):
    """Plain PyTorch twin: Cholesky, explicit inverse, 2 sum log diag.
    A failed factorization (M not PD) gives NaNs, as in JAX, not an
    error."""
    chol = linalg.safe_cholesky(M, 0.0)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return (linalg.cho_solve(chol, eye.expand(M.shape)),
            linalg.logdet_from_chol(chol))


INFO_KEYS = ("warp_per_matrix", "threads", "smem_bytes", "registers",
             "blocks_per_sm", "grid_blocks")


def kernel_info(B: int, m: int, device: torch.device) -> dict:
    """The kernel a (B, m, m) stack launches on `device`: threads, shared
    memory, registers per thread and resident blocks per SM."""
    out = (ctypes.c_int * len(INFO_KEYS))()
    with torch.cuda.device(device):
        _build.check(_build.load().svgp_chol_inverse_info(B, m, out),
                     "svgp_chol_inverse_info")
    return dict(zip(INFO_KEYS, out))


def max_m(device: torch.device) -> int:
    """Largest m the kernel takes on `device` (above m = 32, one matrix
    per block, held in shared memory)."""
    return _max_m(device.index if device.index is not None
                  else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _max_m(index: int) -> int:  # a device property: asked once per device
    out = ctypes.c_int()
    _build.check(_build.load().svgp_chol_inverse_max_m(
        index, ctypes.byref(out)), "svgp_chol_inverse_max_m")
    return out.value


def chol_inverse_kernel(M: torch.Tensor):
    """(Minv (B, m, m), logdet (B,)) of M (B, m, m): CUDA kernel for CUDA
    tensors, plain twin for CPU tensors."""
    if M.device.type == "cpu":
        return chol_inverse_reference(M)
    device = check_cuda_f32(M=M)
    if M.dim() != 3 or M.shape[1] != M.shape[2] or M.shape[0] < 1 \
            or M.shape[1] < 1:
        raise ValueError(f"M must be (B, m, m), got {tuple(M.shape)}")
    B, m, _ = M.shape
    limit = max_m(device)
    if m > limit:
        raise ValueError(f"m = {m} does not fit one block's shared memory "
                         f"(at most {limit} on this device)")
    lib = _build.load()
    Minv = torch.empty_like(M)
    logdet = torch.empty(B, dtype=M.dtype, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.svgp_chol_inverse(M.data_ptr(), Minv.data_ptr(),
                                       logdet.data_ptr(), B, m, stream)
    _build.check(status, "svgp_chol_inverse")
    chol_inverse_kernel.launches += 1
    return Minv, logdet


chol_inverse_kernel.launches = 0


class _CholInverse(torch.autograd.Function):

    @staticmethod
    def forward(ctx, M):
        Minv, logdet = chol_inverse_kernel(M)
        ctx.save_for_backward(Minv)
        return Minv, logdet

    @staticmethod
    @linalg.precise
    def backward(ctx, g_inv, g_ld):
        (Minv,) = ctx.saved_tensors
        mbar = -torch.matmul(torch.matmul(Minv, g_inv), Minv)
        return mbar + g_ld[:, None, None] * Minv


def chol_inverse(M: torch.Tensor):
    """Differentiable (Minv, logdet) of a stack of jittered PD matrices."""
    return _CholInverse.apply(M.contiguous())
