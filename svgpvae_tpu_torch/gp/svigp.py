"""Classic Hensman (2013) SVI-GP with explicit variational parameters
(port of svgpvae_tpu/gp/svigp.py), the deep-SVIGP baseline's GP.

Unlike the SVGPVAE's implied q(u), this GP carries trainable per-channel
variational locs m_l (m,) and scales A_l (m, m) (S_l = A_l A_l^T) and a
trainable scalar likelihood noise.  All L channels go through batched
Cholesky solves at once.  The kernel is the rotated-MNIST product kernel
(gp.svgp.MnistSVGP's): ExpSinSquared over the angle column x Linear over
the object vectors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from svgpvae_tpu_torch import kernels, linalg, parallel
from svgpvae_tpu_torch.gp.svgp import _named_tensors, _to


@dataclasses.dataclass
class SVIGP:
    """Parameters.  Aux rows are [id, angle, obj...]; the object vectors
    come from the aux data (columns 2:) or, with the trainable GPLVM
    table, are gathered by the id column; inducing rows always carry
    their own."""

    inducing_points: Tensor  # (m, 2 + M)
    length_scale: Tensor     # scalar
    amplitude: Tensor        # scalar
    q_mu: Tensor             # (L, m) variational locs
    q_scale: Tensor          # (L, m, m) variational scale factors
    noise: Tensor            # scalar likelihood noise
    object_vectors: Optional[Tensor] = None  # (n_objects, M)
    jitter: float = 1e-6
    N_train: int = 0
    K_obj_normalize: bool = False

    def _features(self, aux: Tensor, inducing: bool) -> Tuple[Tensor, Tensor]:
        view = aux[:, 1:2]
        if self.object_vectors is None or inducing:
            return view, aux[:, 2:]
        return view, self.object_vectors[aux[:, 0].long()]

    def kmat(self, x: Tensor, y: Tensor, x_inducing: bool = True,
             y_inducing: bool = True) -> Tensor:
        xv, xo = self._features(x, x_inducing)
        yv, yo = self._features(y, y_inducing)
        k_view = kernels.exp_sin_squared_matrix(
            xv, yv, self.amplitude, self.length_scale, 2.0 * math.pi)
        k_obj = kernels.linear_matrix(xo, yo)
        if self.K_obj_normalize:
            k_obj = kernels.cosine_normalize_matrix(k_obj, xo, yo)
        return k_view * k_obj

    def kdiag(self, x: Tensor, y: Tensor, x_inducing: bool = True,
              y_inducing: bool = True) -> Tensor:
        xv, xo = self._features(x, x_inducing)
        yv, yo = self._features(y, y_inducing)
        k_view = kernels.exp_sin_squared_diag(
            xv, yv, self.amplitude, self.length_scale, 2.0 * math.pi)
        k_obj = kernels.linear_diag(xo, yo)
        if self.K_obj_normalize:
            k_obj = kernels.cosine_normalize_diag(k_obj, xo, yo)
        return k_view * k_obj

    named_tensors = _named_tensors
    to = _to


def init_svigp(initial_inducing_points, object_vectors_init, L: int,
               N_train: int, jitter: float = 1e-6,
               K_obj_normalize: bool = False,
               dtype=torch.float32) -> SVIGP:
    """Zero locs, identity scales, noise 0.1, unit kernel scalars."""
    ip = torch.as_tensor(np.asarray(initial_inducing_points), dtype=dtype)
    m = ip.shape[0]
    return SVIGP(
        inducing_points=ip,
        length_scale=torch.tensor(1.0, dtype=dtype),
        amplitude=torch.tensor(1.0, dtype=dtype),
        q_mu=torch.zeros(L, m, dtype=dtype),
        q_scale=torch.eye(m, dtype=dtype).repeat(L, 1, 1),
        noise=torch.tensor(0.1, dtype=dtype),
        object_vectors=None if object_vectors_init is None
        else torch.as_tensor(np.asarray(object_vectors_init), dtype=dtype),
        jitter=jitter, N_train=N_train, K_obj_normalize=K_obj_normalize)


def _kmm_chol(gp: SVIGP) -> Tuple[Tensor, Tensor]:
    z = gp.inducing_points
    Kmm = gp.kmat(z, z)
    return Kmm, linalg.safe_cholesky(Kmm, gp.jitter)


@linalg.precise
def svigp_variational_loss(gp: SVIGP, aux: Tensor):
    """The Hensman bound's pieces for all channels: the sum term keeps
    only the K_tilde and trace parts (the data-fit quadratic is the
    driver's exact Gaussian likelihood, models.svigp).

    Returns (sum_terms (L,), kl_terms (L,), mean_vectors (b, L))."""
    _, Kmm_chol = _kmm_chol(gp)
    Knm = gp.kmat(aux, gp.inducing_points, x_inducing=False)  # (b, m)
    Knn_diag = gp.kdiag(aux, aux, x_inducing=False, y_inducing=False)
    S = gp.q_scale @ gp.q_scale.transpose(-1, -2)  # (L, m, m)

    W = linalg.cho_solve(Kmm_chol, Knm.T)  # (m, b)
    mean_vectors = W.T @ gp.q_mu.T  # (b, L)
    precision = 1.0 / gp.noise
    k_tilde = Knn_diag - torch.sum(Knm * W.T, dim=-1)  # (b,)
    wSw = torch.einsum("mb,lmp,pb->lb", W, S, W)  # (L, b)
    sum_terms = -0.5 * (precision * torch.sum(k_tilde)
                        + precision * torch.sum(wSw, dim=-1))
    kl_terms = linalg.mvn_kl_against_prior(gp.q_mu, S, Kmm_chol, gp.jitter)
    # over the global batch in a data-parallel step (parallel.sharded)
    return parallel.psum(sum_terms), kl_terms, mean_vectors


@linalg.precise
def svigp_posterior_params(gp: SVIGP, aux_test: Tensor):
    """Predictive posterior q_S at test points for all channels: (p_m
    (x, L), p_v (x, L))."""
    Kmm, Kmm_chol = _kmm_chol(gp)
    Kxm = gp.kmat(aux_test, gp.inducing_points, x_inducing=False)  # (x, m)
    Kxx_diag = gp.kdiag(aux_test, aux_test, x_inducing=False,
                        y_inducing=False)
    A = linalg.cho_solve(Kmm_chol, Kxm.T).T  # (x, m) = K_xm K_mm^-1
    p_m = A @ gp.q_mu.T
    S = gp.q_scale @ gp.q_scale.transpose(-1, -2)
    quad = torch.einsum("xm,lmp,xp->xl", A, Kmm[None] - S, A)
    return p_m, Kxx_diag[:, None] - quad
