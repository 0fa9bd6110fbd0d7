"""Batched inverse + logdet of jittered PD matrices, with a two-matmul VJP.

    Minv   = M^{-1}          (B, m, m)
    logdet = log det M       (B,)

Port of svgpvae_tpu/ops/chol_inverse.py.  `chol_inverse_kernel` launches
the hand-written CUDA kernel (csrc/chol_inverse.cu::svgp_chol_inverse,
replacing the Pallas kernel svgpvae_tpu/ops/chol_inverse.py::
chol_inverse_pallas) for CUDA tensors, and runs the plain twin
`chol_inverse_reference` (Cholesky-based) for CPU tensors.  On CUDA the
kernel always runs, at any m, in one of three Gauss-Jordan forms that the
library's launch plan picks by m: "warp" (m <= 32, one warp per
matrix), "blocked" (m <= 80, one block per matrix held in registers,
panels of 8 pivots) and "panel" (above it,
panels of 32 pivots on the matrix in device memory, two CUDA launches per
panel, with a workspace this wrapper allocates).  The forms' bounds and
designs are described in the CUDA source.

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


@torch.no_grad()
def gauss_jordan_reference(M: torch.Tensor):
    """The kernel's method in plain PyTorch, in M's dtype: in-place
    Gauss-Jordan without pivoting, one pivot at a time (no panels), and
    logdet as the log pivots summed in pivot order.  A second witness
    beside the Cholesky twin: on a stack of condition ~1e5 or more the
    two methods' fp32 forward errors differ by more than round-off."""
    A = M.clone()
    m = A.shape[-1]
    logdet = torch.zeros(A.shape[:-2], dtype=A.dtype, device=A.device)
    for k in range(m):
        p = A[:, k, k].clone()
        logdet += torch.where(p > 0, p.abs().log(), torch.nan)
        inv = 1.0 / p
        row = A[:, k, :] * inv[:, None]
        col = A[:, :, k].clone()
        A -= col[:, :, None] * row[:, None, :]
        A[:, k, :] = row
        A[:, :, k] = -col * inv[:, None]
        A[:, k, k] = inv
    return A, logdet


FORMS = ("warp", "blocked", "panel")
PLAN_KEYS = ("form", "tile", "extent", "workspace_per_matrix", "launches",
             "nb", "blocked_limit")
_INFO_FIELDS = ("threads", "smem_bytes", "registers", "local_bytes",
                "blocks_per_sm", "grid_blocks")


def launch_plan(m: int, device: torch.device):
    """The library's launch plan of an m x m stack on `device`, as the C
    array its entry point takes (keys PLAN_KEYS): the form (warp for
    m <= 32, blocked up to m = 80, panel above), the blocked form's tile
    and the rows it holds, the panel form's workspace floats per matrix,
    CUDA launches per call, pivots per panel, and the largest m of the
    blocked form.
    Asked once per m and device."""
    return _plan(device.index if device.index is not None
                 else torch.cuda.current_device(), m)


@functools.lru_cache(maxsize=256)
def _plan(index: int, m: int):
    out = (ctypes.c_int * len(PLAN_KEYS))()
    with torch.cuda.device(index):
        _build.check(_build.load().svgp_chol_inverse_plan(m, out),
                     "svgp_chol_inverse_plan")
    return out


def max_blocked_m(device: torch.device) -> int:
    """The largest m that the blocked form holds in registers (80; above
    it the panel form runs, with no limit)."""
    return launch_plan(1, device)[6]


def kernel_info(B: int, m: int, device: torch.device) -> dict:
    """The form a (B, m, m) stack takes on `device` and its kernels:
    threads, static shared memory, registers and local memory (spills)
    per thread, resident blocks per SM and grid; the panel form also gives
    its update kernel's (keys prefixed "update_"), its pivots per panel
    (nb) and its CUDA launches per call."""
    plan = launch_plan(m, device)
    out = (ctypes.c_int * (2 * len(_INFO_FIELDS)))()
    with torch.cuda.device(device):
        _build.check(_build.load().svgp_chol_inverse_info(B, m, plan, out),
                     "svgp_chol_inverse_info")
    info = {"form": FORMS[plan[0]], **dict(zip(_INFO_FIELDS, out))}
    if info["form"] == "panel":
        info.update({f"update_{k}": v for k, v in
                     zip(_INFO_FIELDS, out[len(_INFO_FIELDS):])})
    if info["form"] == "blocked":
        info["extent"] = plan[2]
    return {**info, "nb": plan[5], "launches": plan[4]}


def chol_inverse_kernel(M: torch.Tensor):
    """(Minv (B, m, m), logdet (B,)) of M (B, m, m): CUDA kernel for CUDA
    tensors, plain twin for CPU tensors.  One call counts one launch,
    however many CUDA launches its form makes."""
    if M.device.type == "cpu":
        return chol_inverse_reference(M)
    device = check_cuda_f32(M=M)
    if M.dim() != 3 or M.shape[1] != M.shape[2] or M.shape[0] < 1 \
            or M.shape[1] < 1:
        raise ValueError(f"M must be (B, m, m), got {tuple(M.shape)}")
    B, m, _ = M.shape
    lib = _build.load()
    plan = launch_plan(m, device)
    Minv = torch.empty_like(M)
    logdet = torch.empty(B, dtype=M.dtype, device=device)
    ws = (torch.empty(B * plan[3], dtype=M.dtype, device=device)
          if plan[3] else None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.svgp_chol_inverse(
            M.data_ptr(), Minv.data_ptr(), logdet.data_ptr(),
            None if ws is None else ws.data_ptr(), B, m, plan, stream)
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
