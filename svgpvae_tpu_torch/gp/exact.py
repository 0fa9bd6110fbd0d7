"""Exact (dense) 1-D GP regression for the Pearce GPVAE / NP baselines (port
of svgpvae_tpu/gp/exact.py), batched over the leading axis and solved by
Cholesky.  The (batch, n, n) factorization is torch.linalg's: the JAX
package computes it outside any Pallas kernel too.

`PearceLengthScales` holds the per-channel length scales that
`--GP_joint` trains for the Pearce and NP ELBOs.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import Tensor

from svgpvae_tpu_torch import linalg
from svgpvae_tpu_torch.gp.svgp import _named_tensors, _to


class GP1DPosterior(NamedTuple):
    mean: Tensor          # (batch, ns)
    var: Tensor           # (batch, ns), or (batch, ns, ns) if full_variance
    log_marginal: Tensor  # (batch,)


@dataclasses.dataclass
class PearceLengthScales:
    """The exact GPs' length scales of the x and y latent channels."""

    length_scale_x: Tensor
    length_scale_y: Tensor

    named_tensors = _named_tensors
    to = _to


@linalg.precise
def gp_regression_1d(x: Tensor, y: Tensor, var_y: Tensor, x_test: Tensor,
                     length_scale, full_variance: bool = False,
                     jitter: float = 0.0) -> GP1DPosterior:
    """Exact GP regression, unit-amplitude RBF kernel over 1-D inputs.

    x (batch, n) inputs, y (batch, n) targets, var_y (batch, n)
    heteroscedastic noise, x_test (batch, ns).  Returns the posterior mean
    and variance at x_test and log p(y | x) per batch row.  With
    `full_variance` the (ns, ns) covariance, valid only for x_test == x.
    A failed factorization gives NaNs, as in JAX."""
    n = x.shape[-1]
    ilt = -0.5 / (length_scale * length_scale)
    eye = torch.eye(n, dtype=y.dtype, device=y.device)

    d = x[:, :, None] - x[:, None, :]
    K = torch.exp(d * d * ilt)
    chol = linalg.safe_cholesky(K + var_y[..., None] * eye, jitter)

    logdet = linalg.logdet_from_chol(chol)                      # (batch,)
    iKy = linalg.cho_solve(chol, y[..., None])[..., 0]          # (batch, n)
    quad = torch.sum(y * iKy, dim=-1)
    log_marginal = -0.5 * (n * linalg.LOG_2PI + quad + logdet)

    ds = x[:, :, None] - x_test[:, None, :]
    Ks = torch.exp(ds * ds * ilt)                               # (b, n, ns)
    mean = torch.einsum("bns,bn->bs", Ks, iKy)
    iK_Ks = linalg.cho_solve(chol, Ks)
    if full_variance:
        var = K - Ks.transpose(1, 2) @ iK_Ks                    # (b, ns, ns)
    else:
        var = 1.0 - torch.sum(Ks * iK_Ks, dim=1)                # (b, ns)
    return GP1DPosterior(mean=mean, var=var, log_marginal=log_marginal)
