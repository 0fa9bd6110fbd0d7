"""GP sufficient statistics for all L latent channels at once (forward).

    Sigma_l = sum_n prec[n, l] * K_nm[n, :]^T K_nm[n, :]      (L, m, m)
    r_l     = sum_n py[n, l]   * K_nm[n, :]                   (L, m)

Port of svgpvae_tpu/ops/gp_stats.py.  `gp_sufficient_stats` launches the
hand-written CUDA kernel (csrc/gp_stats.cu::svgp_gp_stats, replacing the
Pallas kernel svgpvae_tpu/ops/gp_stats.py::gp_sufficient_stats) for CUDA
tensors, and runs its plain twin `gp_sufficient_stats_reference` for CPU
tensors.  Unlike the TPU dispatcher there is no n/m threshold: on CUDA the
kernel always runs.  The library's launch plan (asked once per shape and
device) picks the kernel and the split of n: at m <= 64 one launch with
no workspace for small n, chunks plus a fixed-order reduce above; at
larger m partial sums plus the reduce.  B3 builds K into a workspace
and runs the same plan on it.  The kernels' bound and design are
described in the CUDA source.

`gp_stats` is the differentiable form (the JAX custom_vjp of the same
name): its forward is `gp_sufficient_stats`, its backward the einsum VJP
of svgpvae_tpu/ops/gp_stats.py::_gp_stats_bwd.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from svgpvae_tpu_torch import linalg
from svgpvae_tpu_torch.ops import _build


@linalg.precise
def gp_sufficient_stats_reference(Knm: torch.Tensor, prec: torch.Tensor,
                                  py: torch.Tensor):
    """Plain PyTorch twin: materializes the (L, n, m) channel-scaled K."""
    scaled = prec.T[:, :, None] * Knm[None]  # (L, n, m)
    sigma = torch.einsum("nm,lnp->lmp", Knm, scaled)
    r = torch.einsum("nm,nl->lm", Knm, py)
    return sigma, r


def check_cuda_f32(**tensors) -> torch.device:
    """Validate what the CUDA kernels take: contiguous fp32 on one CUDA
    device.  Raises on anything else (no silent fallback)."""
    device = None
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
    return device


INFO_KEYS = ("single_launch", "threads", "smem_bytes", "registers",
             "blocks_per_sm", "grid_blocks", "reduce_registers",
             "reduce_blocks_per_sm", "local_bytes", "build_registers",
             "build_blocks_per_sm", "build_local_bytes")


def launch_plan(n: int, m: int, L: int, device: torch.device):
    """The library's launch plan of this shape on `device`, as the C array
    {n_chunks, rows_per_chunk, tile, build_blocks} its entry points take:
    n_chunks = 0 is the single-launch path (no workspace), otherwise the
    partial-sum workspace has n_chunks chunks; build_blocks is the grid of
    B3's K-build pass.  B2 and B3 share it.  Asked once per shape and
    device."""
    return _plan(device.index, n, m, L)


@functools.lru_cache(maxsize=256)
def _plan(index: int, n: int, m: int, L: int):
    out = (ctypes.c_int * 4)()
    with torch.cuda.device(index):
        _build.check(_build.load().svgp_stats_plan(n, m, L, out),
                     "svgp_stats_plan")
    return out


def kernel_info(n: int, m: int, L: int, device: torch.device, d1: int = 0,
                d2: int = 0) -> dict:
    """The kernels this shape's plan launches on `device`: threads,
    shared memory, registers and local memory (spills) per thread and
    resident blocks per SM (cudaFuncGetAttributes,
    cudaOccupancyMaxActiveBlocksPerMultiprocessor); with B3's feature
    widths d1, d2 also its K-build kernel's, the worst over the kernels
    those widths may launch."""
    out = (ctypes.c_int * len(INFO_KEYS))()
    with torch.cuda.device(device):
        _build.check(_build.load().svgp_stats_info(n, m, L, d1, d2, out),
                     "svgp_stats_info")
    return dict(zip(INFO_KEYS, out))


def alloc_outputs(plan, m: int, L: int, device: torch.device):
    """Outputs and the per-chunk partial-sum workspace (None, None on the
    single-launch path)."""
    f32 = dict(dtype=torch.float32, device=device)
    n_chunks = plan[0]
    ws = ((torch.empty((n_chunks, L, m, m), **f32),
           torch.empty((n_chunks, L, m), **f32)) if n_chunks else
          (None, None))
    return (torch.empty((L, m, m), **f32), torch.empty((L, m), **f32), *ws)


def gp_sufficient_stats(Knm: torch.Tensor, prec: torch.Tensor,
                        py: torch.Tensor):
    """(Sigma (L, m, m), r (L, m)) from K_nm (n, m), prec (n, L) and
    py = prec * y (n, L).  CUDA kernel for CUDA tensors, plain twin for
    CPU tensors."""
    if Knm.device.type == "cpu":
        return gp_sufficient_stats_reference(Knm, prec, py)
    device = check_cuda_f32(Knm=Knm, prec=prec, py=py)
    n, m = Knm.shape
    L = prec.shape[1]
    if prec.shape != (n, L) or py.shape != (n, L) or n < 1:
        raise ValueError(f"shapes Knm {tuple(Knm.shape)}, prec "
                         f"{tuple(prec.shape)}, py {tuple(py.shape)}")
    lib = _build.load()
    plan = launch_plan(n, m, L, device)
    sigma, r, *ws = alloc_outputs(plan, m, L, device)
    ws_ptrs = [None if w is None else w.data_ptr() for w in ws]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.svgp_gp_stats(
            Knm.data_ptr(), prec.data_ptr(), py.data_ptr(), sigma.data_ptr(),
            r.data_ptr(), *ws_ptrs, n, m, L, plan, stream)
    _build.check(status, "svgp_gp_stats")
    gp_sufficient_stats.launches += 1
    return sigma, r


gp_sufficient_stats.launches = 0


class _GPStats(torch.autograd.Function):
    """Forward: the kernel (CUDA) or its twin (CPU).  Backward: einsums."""

    @staticmethod
    def forward(ctx, Knm, prec, py):
        ctx.save_for_backward(Knm, prec, py)
        return gp_sufficient_stats(Knm, prec, py)

    @staticmethod
    @linalg.precise
    def backward(ctx, d_sigma, d_r):
        Knm, prec, py = ctx.saved_tensors
        # Sigma_l = K^T diag(prec_l) K  =>
        #   dK    += sum_l prec[:, l] * (K @ (dSigma_l + dSigma_l^T))
        #   dprec[n, l] = K[n] dSigma_l K[n]^T
        sym = d_sigma + d_sigma.transpose(-1, -2)              # (L, m, m)
        k_sym = torch.einsum("nm,lmp->lnp", Knm, sym)          # (L, n, m)
        dK = torch.einsum("nl,lnp->np", prec, k_sym)
        dprec = 0.5 * torch.einsum("nm,lnm->nl", Knm, k_sym)
        # r_l = K^T py_l  =>  dK += py @ d_r ; dpy = K @ d_r^T
        dK = dK + py @ d_r
        dpy = Knm @ d_r.T
        return dK, dprec, dpy


def gp_stats(Knm: torch.Tensor, prec: torch.Tensor, py: torch.Tensor):
    """Differentiable (Sigma (L, m, m), r (L, m)) in all three arguments.
    The inputs are made contiguous first (a kernel matrix may arrive as a
    strided view); the kernel takes nothing else."""
    return _GPStats.apply(Knm.contiguous(), prec.contiguous(),
                          py.contiguous())
