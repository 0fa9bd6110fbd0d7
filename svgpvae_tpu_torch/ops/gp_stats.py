"""GP sufficient statistics for all L latent channels at once (forward).

    Sigma_l = sum_n prec[n, l] * K_nm[n, :]^T K_nm[n, :]      (L, m, m)
    r_l     = sum_n py[n, l]   * K_nm[n, :]                   (L, m)

Port of svgpvae_tpu/ops/gp_stats.py.  `gp_sufficient_stats` launches the
hand-written CUDA kernel (csrc/gp_stats.cu::svgp_gp_stats, replacing the
Pallas kernel svgpvae_tpu/ops/gp_stats.py::gp_sufficient_stats) for CUDA
tensors, and runs its plain twin `gp_sufficient_stats_reference` for CPU
tensors.  Unlike the TPU dispatcher there is no n/m threshold: on CUDA the
kernel always runs.  The kernel's bound and design are described in the
CUDA source.

`gp_stats` is the differentiable form (the JAX custom_vjp of the same
name): its forward is `gp_sufficient_stats`, its backward the einsum VJP
of svgpvae_tpu/ops/gp_stats.py::_gp_stats_bwd.
"""

from __future__ import annotations

import ctypes

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


def launch_plan(lib, n: int, m: int, L: int, device: torch.device):
    """(n_chunks, rows_per_chunk) of the partial-sum workspace, as the
    library splits n for this device's SM count."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    n_chunks, rows = ctypes.c_int(), ctypes.c_int()
    _build.check(lib.svgp_stats_plan(n, m, L, sms, ctypes.byref(n_chunks),
                                     ctypes.byref(rows)), "svgp_stats_plan")
    return n_chunks.value, rows.value


def alloc_outputs(n_chunks: int, m: int, L: int, device: torch.device):
    """Outputs and the per-chunk partial-sum workspace."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((L, m, m), **f32), torch.empty((L, m), **f32),
            torch.empty((n_chunks, L, m, m), **f32),
            torch.empty((n_chunks, L, m), **f32))


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
    n_chunks, rows = launch_plan(lib, n, m, L, device)
    sigma, r, ws_sigma, ws_r = alloc_outputs(n_chunks, m, L, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.svgp_gp_stats(
            Knm.data_ptr(), prec.data_ptr(), py.data_ptr(), sigma.data_ptr(),
            r.data_ptr(), ws_sigma.data_ptr(), ws_r.data_ptr(), n, m, L,
            n_chunks, rows, stream)
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
