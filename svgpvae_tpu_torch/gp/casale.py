"""Casale GPVAE prior (port of svgpvae_tpu/gp/casale.py): a full GP over
the train set with the Kronecker low-rank factor V (K ~= V V^T + alpha I)
and the first-order Taylor terms of the low-memory stochastic backprop.

Every K^-1 application is the factored Woodbury form
(rhs - V (alpha I + V^T V)^-1 V^T rhs) / alpha, O(N H^2), and the
training path's Taylor terms never form the (L, N, H) tensor
(`taylor_terms`, PARITY.md #14).  The noise alpha passes a
straight-through floor (ALPHA_FLOOR, PARITY.md #7) and optionally a
softplus map and a straight-through ceiling.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
from torch import Tensor

from svgpvae_tpu_torch import kernels, linalg
from svgpvae_tpu_torch.gp.svgp import _named_tensors, _to

ALPHA_FLOOR = 1e-5
ALPHA0 = 0.1  # the latent-GP noise at init


def kron(a: Tensor, b: Tensor) -> Tensor:
    """Kronecker product of two matrices by broadcasting."""
    ar, ac = a.shape
    br, bc = b.shape
    return (a[:, None, :, None] * b[None, :, None, :]).reshape(ar * br,
                                                               ac * bc)


@dataclasses.dataclass
class CasaleGP:
    """Parameters of the Casale full-GP prior, and its static options:
    `alpha_transform` "clamp" (alpha is the noise; consumers floor it,
    `effective_alpha`) or "softplus" (noise = softplus(alpha));
    `alpha_max` > 0 a straight-through ceiling on the noise."""

    length_scale: Tensor    # view-kernel length scale
    amplitude: Tensor       # view-kernel amplitude
    alpha: Tensor           # latent-GP observation noise (raw parameter)
    object_vectors: Tensor  # (n_objects, M) GPLVM table
    object_kernel_normalize: bool = False
    ov_joint: bool = True
    jitter: float = 1e-6
    alpha_transform: str = "clamp"
    alpha_max: float = 0.0

    named_tensors = _named_tensors
    to = _to


def init_casale_gp(object_vectors_init, object_kernel_normalize: bool,
                   ov_joint: bool, jitter: float = 1e-6,
                   dtype=torch.float32, alpha_transform: str = "clamp",
                   alpha_max: float = 0.0) -> CasaleGP:
    """Unit kernel scalars, noise ALPHA0 (softplus(raw) == ALPHA0 under
    "softplus")."""
    raw = (np.log(np.expm1(ALPHA0)) if alpha_transform == "softplus"
           else ALPHA0)
    return CasaleGP(
        length_scale=torch.tensor(1.0, dtype=dtype),
        amplitude=torch.tensor(1.0, dtype=dtype),
        alpha=torch.tensor(raw, dtype=dtype),
        object_vectors=torch.as_tensor(np.asarray(object_vectors_init),
                                       dtype=dtype),
        object_kernel_normalize=object_kernel_normalize, ov_joint=ov_joint,
        jitter=jitter, alpha_transform=alpha_transform, alpha_max=alpha_max)


def _straight_through(x: Tensor, value: Tensor) -> Tensor:
    """`value` forward, the identity's gradient backward."""
    return x + (value - x).detach()


def casale_noise(gp: CasaleGP) -> Tensor:
    """Raw alpha -> the noise before the floor: softplus(alpha) or alpha,
    ceilinged at alpha_max (> 0) straight-through, so a raw alpha driven
    above the cap can still train back down."""
    noise = (torch.logaddexp(gp.alpha, torch.zeros_like(gp.alpha))
             if gp.alpha_transform == "softplus" else gp.alpha)
    if gp.alpha_max > 0:
        noise = _straight_through(noise, torch.clamp(noise, max=gp.alpha_max))
    return noise


def effective_alpha(alpha: Tensor) -> Tensor:
    """The noise floored at ALPHA_FLOOR in value, with the identity's
    gradient, so a raw alpha trained below the floor is not frozen there
    (PARITY.md #7).  Every consumer (the Woodbury solves and the Taylor
    c * alpha term) goes through it."""
    return _straight_through(alpha, torch.clamp(alpha, min=ALPHA_FLOOR))


def casale_kernel_matrix(gp: CasaleGP, x: Tensor, y: Tensor,
                         x_has_id: bool = True,
                         y_has_id: bool = True) -> Tensor:
    """K(x, y) = ExpSinSquared(angle) x Linear(object vector).  Rows are
    [id, angle, pca...] when `*_has_id` (the vector is the table's row of
    that id under ov_joint, else the pca columns), else [angle, pca...]."""
    def unpack(aux, has_id):
        if not has_id:
            return aux[:, 0:1], aux[:, 1:]
        obj = (gp.object_vectors[aux[:, 0].long()] if gp.ov_joint
               else aux[:, 2:])
        return aux[:, 1:2], obj

    xv, xo = unpack(x, x_has_id)
    yv, yo = unpack(y, y_has_id)
    k_view = kernels.exp_sin_squared_matrix(xv, yv, gp.amplitude,
                                            gp.length_scale, 2.0 * math.pi)
    k_obj = kernels.linear_matrix(xo, yo)
    if gp.object_kernel_normalize:
        k_obj = kernels.cosine_normalize_matrix(k_obj, xo, yo)
    return k_view * k_obj


@linalg.precise
def v_matrix(gp: CasaleGP, unique_angles: Tensor, object_ids: Tensor,
             train_index: Tensor) -> Tensor:
    """Low-rank factor V (N, H), H = M * Q: kron(object vectors,
    chol(K_view)) over the sorted (object, angle) grid, the rows present
    in the train set (`train_index`: integer rows of the grid, see
    cli.mnist.train_angles_mask).  unique_angles (Q,) sorted, object_ids
    (P,) sorted.  The angle gram's factorization takes an absolute plus
    relative ridge (jitter + 1e-5 mean(diag)): it is near-singular in fp32
    once the length scale grows past ~1 (PARITY.md #7)."""
    ov = gp.object_vectors[object_ids.long()]
    if gp.object_kernel_normalize:
        ov = ov / torch.linalg.norm(ov, dim=-1, keepdim=True)
    K_w = kernels.exp_sin_squared_matrix(
        unique_angles[:, None], unique_angles[:, None], gp.amplitude,
        gp.length_scale, 2.0 * math.pi)
    diag_scale = torch.mean(torch.diagonal(K_w))
    L_w = linalg.safe_cholesky(K_w, gp.jitter + 1e-5 * diag_scale)
    return kron(ov, L_w)[train_index]


def _woodbury(V: Tensor, alpha: Tensor):
    """(floored alpha, chol(alpha I + V^T V) with its 1e-7 trace ridge)."""
    H = V.shape[1]
    alpha = effective_alpha(alpha)
    inner = alpha * torch.eye(H, dtype=V.dtype, device=V.device) + V.T @ V
    return alpha, linalg.safe_cholesky(
        inner, 1e-7 * torch.diagonal(inner).sum() / H)


@linalg.precise
def apply_k_inv(V: Tensor, alpha: Tensor, rhs: Tensor) -> Tensor:
    """K^-1 @ rhs, K = V V^T + alpha I, without forming the (N, N)
    inverse."""
    alpha, inner_chol = _woodbury(V, alpha)
    return (rhs - V @ linalg.cho_solve(inner_chol, V.T @ rhs)) / alpha


@linalg.precise
def taylor_terms(gp: CasaleGP, Z: Tensor, V: Tensor
                 ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The factored first-order Taylor pieces of the GP prior term for Z
    (N, L) latent samples over the full train set: a (L, N) = (K^-1 Z)^T,
    ztKV (L, H) = Z^T K^-1 V, K_inv_V (N, H) and c (L,) =
    (-||K^-1 z_l||^2 + tr K^-1) / 2, with tr K^-1 =
    (N - tr((alpha I + V^T V)^-1 V^T V)) / alpha.  The Taylor B_l =
    -K^-1 z_l (z_l^T K^-1 V) + K^-1 V is never formed: the training pass
    builds only its batch rows (models.casale)."""
    N = V.shape[0]
    alpha, inner_chol = _woodbury(V, casale_noise(gp))

    def kinv_apply(rhs):
        return (rhs - V @ linalg.cho_solve(inner_chol, V.T @ rhs)) / alpha

    KZ = kinv_apply(Z)        # (N, L)
    K_inv_V = kinv_apply(V)   # (N, H)
    tr_K_inv = (N - torch.diagonal(linalg.cho_solve(inner_chol, V.T @ V))
                .sum()) / alpha
    c = 0.5 * (-torch.sum(KZ * KZ, dim=0) + tr_K_inv)
    return KZ.T, Z.T @ K_inv_V, K_inv_V, c
