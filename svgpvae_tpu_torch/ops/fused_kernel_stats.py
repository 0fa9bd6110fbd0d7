"""Product-kernel construction fused with the GP sufficient statistics.

Port of svgpvae_tpu/ops/fused_kernel_stats.py.  The same (Sigma, r) as
ops.gp_stats, but from the raw auxiliary features instead of K_nm:

  mnist family:   K = amp^2 exp(-2 sin^2(|view_i - ip_view_j| / 2) / l^2)
                      * <obj_i, ip_obj_j>          (obj part optionally
                                                    cosine-normalized)
  sprites family: K = <act_i, ip_act_j> * <chr_i, ip_chr_j>
                                                   (both optionally
                                                    cosine-normalized)

Cosine normalization clamps data-row norms at 1e-30 (an all-zero row gives
0, not 0/0), as the TPU kernel does.  `fused_kernel_stats` launches the
hand-written CUDA kernels (csrc/gp_stats.cu::svgp_fused_kernel_stats,
replacing the Pallas kernel
svgpvae_tpu/ops/fused_kernel_stats.py::fused_kernel_stats) for CUDA
tensors, and runs the plain twin `fused_kernel_stats_reference` for CPU
tensors.  On the card, one kernel writes K_nm into an (n, m) workspace
(14.4 MB at the SPRITES fit, resident in the H100's L2) and B2's kernels
contract it; the source says why that beats keeping K on chip.  Forward
only.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from svgpvae_tpu_torch import kernels
from svgpvae_tpu_torch.ops import _build
from svgpvae_tpu_torch.ops.gp_stats import (alloc_outputs, check_cuda_f32,
                                            gp_sufficient_stats_reference,
                                            launch_plan)

FAMILIES = {"mnist": 0, "sprites": 1}
NORM_CLAMP = 1e-30


def _normalize(k, x, y):
    nx = torch.clamp(torch.linalg.norm(x, dim=-1), min=NORM_CLAMP)
    ny = torch.linalg.norm(y, dim=-1)
    return k / (nx[:, None] * ny[None, :])


def fused_kernel_matrix(f1, f2, ip1, ip2, amp=None, length_scale=None,
                        family: str = "mnist", normalize: bool = False):
    """K_nm (n, m) from the features, with kernels.py (the twin's K)."""
    if family == "mnist":
        k_a = kernels.exp_sin_squared_matrix(
            f1[:, :1], ip1[:, :1], 1.0 if amp is None else amp,
            1.0 if length_scale is None else length_scale, 2.0 * math.pi)
        k_b = kernels.linear_matrix(f2, ip2)
        if normalize:
            k_b = _normalize(k_b, f2, ip2)
    elif family == "sprites":
        k_a = kernels.linear_matrix(f1, ip1)
        k_b = kernels.linear_matrix(f2, ip2)
        if normalize:
            k_a = _normalize(k_a, f1, ip1)
            k_b = _normalize(k_b, f2, ip2)
    else:
        raise ValueError(f"unknown family {family!r}")
    return k_a * k_b


def fused_kernel_stats_reference(f1, f2, ip1, ip2, prec, py, amp=None,
                                 length_scale=None, family: str = "mnist",
                                 normalize: bool = False):
    """Plain PyTorch twin: build K with kernels.py, then the contraction."""
    knm = fused_kernel_matrix(f1, f2, ip1, ip2, amp, length_scale, family,
                              normalize)
    return gp_sufficient_stats_reference(knm, prec, py)


def fused_kernel_stats(f1: torch.Tensor, f2: torch.Tensor, ip1: torch.Tensor,
                       ip2: torch.Tensor, prec: torch.Tensor,
                       py: torch.Tensor, amp: Optional[float] = None,
                       length_scale: Optional[float] = None,
                       family: str = "mnist", normalize: bool = False):
    """Fused (Sigma (L, m, m), r (L, m)) from f1 (n, d1), f2 (n, d2),
    ip1 (m, d1), ip2 (m, d2), prec/py (n, L).  amp/length_scale are the
    mnist family's periodic-kernel scalars (default 1).  CUDA kernel for
    CUDA tensors, plain twin for CPU tensors."""
    if f1.device.type == "cpu":
        return fused_kernel_stats_reference(f1, f2, ip1, ip2, prec, py, amp,
                                            length_scale, family, normalize)
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    device = check_cuda_f32(f1=f1, f2=f2, ip1=ip1, ip2=ip2, prec=prec, py=py)
    n, d1 = f1.shape
    m, d2 = ip2.shape
    L = prec.shape[1]
    if (f2.shape != (n, d2) or ip1.shape != (m, d1) or prec.shape != (n, L)
            or py.shape != (n, L) or n < 1):
        raise ValueError(
            f"shapes f1 {tuple(f1.shape)}, f2 {tuple(f2.shape)}, ip1 "
            f"{tuple(ip1.shape)}, ip2 {tuple(ip2.shape)}, prec "
            f"{tuple(prec.shape)}, py {tuple(py.shape)}")
    amp = 1.0 if amp is None else float(amp)
    length_scale = 1.0 if length_scale is None else float(length_scale)
    lib = _build.load()
    plan = launch_plan(n, m, L, device)
    sigma, r, *ws = alloc_outputs(plan, m, L, device)
    ws_ptrs = [None if w is None else w.data_ptr() for w in ws]
    knm = torch.empty((n, m), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.svgp_fused_kernel_stats(
            f1.data_ptr(), f2.data_ptr(), ip1.data_ptr(), ip2.data_ptr(),
            d1, d2, amp, length_scale, FAMILIES[family], int(normalize),
            prec.data_ptr(), py.data_ptr(), sigma.data_ptr(), r.data_ptr(),
            *ws_ptrs, knm.data_ptr(), n, m, L, plan, stream)
    _build.check(status, "svgp_fused_kernel_stats")
    fused_kernel_stats.launches += 1
    return sigma, r


fused_kernel_stats.launches = 0
