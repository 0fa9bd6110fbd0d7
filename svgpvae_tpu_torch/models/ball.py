"""Moving-ball ELBOs (port of svgpvae_tpu/models/ball.py): the SVGPVAE
(Hensman or Titsias bound) and the Pearce GPVAE / Neural Process / VAE
family.

The randomness comes in as tensors: `eps` (the reparameterisation noise,
shaped as p_m) and, for the NP, `split` = (n_ctx, perm), the context size
and the per-video permutation (`draw_np_split` draws them from a
torch.Generator).  Tests feed the JAX package's draws through both.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from svgpvae_tpu_torch import linalg
from svgpvae_tpu_torch.gp.exact import gp_regression_1d
from svgpvae_tpu_torch.gp.fused import ball_gp_block, ball_gp_block_titsias
from svgpvae_tpu_torch.gp.svgp import (BallSVGP, ball_posterior_params,
                                       ball_variational_loss)

# q-variance clip for the ball experiment (reference: SVGPVAE_model.py:671)
BALL_QVAR_CLIP = (1e-6, 1e3)
# posterior-variance clip before sampling (reference: SVGPVAE_model.py:701)
BALL_PVAR_CLIP = (1e-4, 1e3)
# the NP masks its target points with this noise variance
NP_MASK_NOISE = 1e10
ELBO_TYPES = ("GPVAE_Pearce", "VAE", "NP")


class BallOutputs(NamedTuple):
    elbo: Tensor            # (batch,)
    recon: Tensor           # (batch,) reconstruction log-likelihood
    prior_kl: Tensor        # (batch,) "KL" term of the chosen bound
    inside_elbo: Tensor     # (batch,) SVGP inside-ELBO (zeros for Pearce)
    ce_term: Tensor         # (batch,)
    p_m: Tensor             # (batch, T, 2) approximate posterior mean
    p_v: Tensor             # (batch, T, 2) approximate posterior variance
    qnet_mu: Tensor
    qnet_var: Tensor
    pred_vid: Tensor        # (batch, T, px, py) sigmoid probabilities
    inside_elbo_recon: Tensor
    inside_elbo_kl: Tensor
    gp_cov_elemwise_mean: Optional[Tensor]  # (T, T, 2) or None


def full_cholesky_marginal_vars(qnet_var: Tensor) -> Tensor:
    """(b, T, 2T) stacked per-frame Cholesky rows -> (b, T, 2) marginal
    variances diag(tril(L) tril(L)^T) per channel (differentiable)."""
    tmax = qnet_var.shape[-1] // 2
    tri = torch.tril(torch.ones((tmax, tmax), dtype=qnet_var.dtype,
                                device=qnet_var.device))
    lx = qnet_var[:, :, :tmax] * tri
    ly = qnet_var[:, :, tmax:] * tri
    return torch.stack([torch.sum(lx * lx, dim=-1),
                        torch.sum(ly * ly, dim=-1)], dim=2)


def _marginalize_qvar(qnet_var: Tensor) -> Tensor:
    """(b, T, 2) variances pass through; a full-Cholesky head's (b, T, 2T)
    rows become marginal variances."""
    if qnet_var.shape[-1] != 2:
        return full_cholesky_marginal_vars(qnet_var)
    return qnet_var


def _bernoulli_ce(vids: Tensor, logits: Tensor) -> Tensor:
    """Elementwise sigmoid cross-entropy."""
    return (torch.clamp(logits, min=0) - logits * vids
            + torch.log1p(torch.exp(-torch.abs(logits))))


def _entropy(p_v: Tensor) -> Tensor:
    """Elementwise entropy of N(., p_v) (the exact-entropy CE slot)."""
    return 0.5 * (1.0 + linalg.LOG_2PI
                  + torch.log(torch.clamp(p_v, min=1e-12)))


def ball_svgpvae_elbo(encoder, decoder, gp: BallSVGP, vids: Tensor, beta,
                      eps: Tensor, clip_qs: bool = False,
                      gp_block_impl: str = "reference",
                      titsias_reference_ce: bool = False,
                      entropy_ce: bool = False) -> BallOutputs:
    """SVGPVAE ELBO on ball videos (times 1..T), with `eps` (b, T, 2) the
    reparameterisation noise.

    gp_block_impl: "reference" (the two-pass posterior + loss), "fused"
    (ball_gp_block or ball_gp_block_titsias by config.titsias, Cholesky)
    or "fused_pallas" (the same with chol_inverse: B1 on a CUDA tensor)."""
    if gp_block_impl not in ("reference", "fused", "fused_pallas"):
        raise ValueError(f"gp_block_impl {gp_block_impl!r} (resolve 'auto' "
                         "first)")
    tmax = vids.shape[1]
    times = torch.arange(1, tmax + 1, dtype=vids.dtype, device=vids.device)

    qnet_mu, qnet_var = encoder(vids)
    qnet_var = _marginalize_qvar(qnet_var)
    if clip_qs:
        qnet_var = torch.clamp(qnet_var, *BALL_QVAR_CLIP)

    if gp_block_impl != "reference":
        block = (ball_gp_block_titsias if gp.config.titsias
                 else ball_gp_block)
        p_m, p_v, sum_terms, kl_terms, gp_cov_mean = block(
            gp, times, qnet_mu, qnet_var,
            inverse_impl="pallas" if gp_block_impl == "fused_pallas"
            else "chol")
    else:
        p_m, p_cov, mu_hat, A_hat = ball_posterior_params(gp, times, qnet_mu,
                                                          qnet_var)
        sum_terms, kl_terms = ball_variational_loss(gp, times, qnet_mu,
                                                    qnet_var, mu_hat, A_hat)
        gp_cov_mean = p_cov.mean(dim=0)
        p_v = torch.diagonal(p_cov, dim1=1, dim2=2).transpose(1, 2)

    inside_elbo_recon = sum_terms.sum(dim=-1)
    inside_elbo_kl = kl_terms.sum(dim=-1)
    inside_elbo = inside_elbo_recon - inside_elbo_kl

    if entropy_ce or (gp.config.titsias and not titsias_reference_ce):
        ce_term = _entropy(p_v).sum(dim=(1, 2))
    else:
        ce = linalg.gauss_cross_entropy(p_m, p_v, qnet_mu, qnet_var)
        ce_term = -ce.sum(dim=(1, 2))

    latent = p_m + eps * linalg.stable_sqrt(torch.clamp(p_v,
                                                        *BALL_PVAR_CLIP))
    logits = decoder(latent)
    recon = -_bernoulli_ce(vids, logits).sum(dim=(1, 2, 3))
    prior_kl = ce_term + inside_elbo
    return BallOutputs(
        elbo=recon + beta * prior_kl, recon=recon, prior_kl=prior_kl,
        inside_elbo=inside_elbo, ce_term=ce_term, p_m=p_m, p_v=p_v,
        qnet_mu=qnet_mu, qnet_var=qnet_var, pred_vid=torch.sigmoid(logits),
        inside_elbo_recon=inside_elbo_recon, inside_elbo_kl=inside_elbo_kl,
        gp_cov_elemwise_mean=gp_cov_mean)


def draw_np_split(batch: int, tmax: int, generator: torch.Generator,
                  device=None, context_ratio: float = 0.5
                  ) -> Tuple[Tensor, Tensor]:
    """The NP's context size (a normal around context_ratio * T, rounded
    half to even and clipped to [2, T - 2]) and a random permutation of
    0..T-1 per video, (n_ctx () int64, perm (batch, T) int64)."""
    mean_c = context_ratio * tmax
    std_c = math.sqrt(context_ratio * (1 - context_ratio) * tmax)
    z = torch.randn((), generator=generator, device=device)
    n_ctx = torch.clamp(torch.round(mean_c + std_c * z), 2,
                        tmax - 2).long()
    perm = torch.argsort(torch.rand((batch, tmax), generator=generator,
                                    device=device), dim=1)
    return n_ctx, perm


def pearce_elbo(encoder, decoder, vids: Tensor, beta, eps: Tensor,
                length_scale, elbo_type: str = "GPVAE_Pearce",
                context_length_scale=None, entropy_ce: bool = False,
                split: Optional[Tuple[Tensor, Tensor]] = None
                ) -> BallOutputs:
    """Pearce-GPVAE / NP / VAE ELBO on ball videos (times 0..T-1), with
    `eps` (b, T, 2) the reparameterisation noise.

    `length_scale` is a scalar or a pair (lx, ly) of per-channel scales
    (trainable under --GP_joint).  For 'VAE' the caller passes a tiny
    length scale, so the prior is iid standard normal.  'NP' takes
    `split` = (n_ctx, perm) (see draw_np_split): the first n_ctx
    permuted frames of each video are its context, fitted by exact GPs
    with the STATIC `context_length_scale` (default: length_scale), the
    rest masked with noise NP_MASK_NOISE and their constant
    -0.5 log(2 pi NP_MASK_NOISE) each taken back out."""
    if elbo_type not in ELBO_TYPES:
        raise ValueError(f"elbo_type {elbo_type!r}")
    batch, tmax = vids.shape[0], vids.shape[1]
    dtype = vids.dtype
    times = torch.arange(0, tmax, dtype=dtype, device=vids.device)
    batch_t = times[None].expand(batch, tmax)
    if isinstance(length_scale, (tuple, list)):
        ls_x, ls_y = length_scale
    else:
        ls_x = ls_y = length_scale
    ctx_ls = (context_length_scale if context_length_scale is not None
              else length_scale)

    qnet_mu, qnet_var = encoder(vids)
    qnet_var = _marginalize_qvar(qnet_var)

    post_x = gp_regression_1d(batch_t, qnet_mu[:, :, 0], qnet_var[:, :, 0],
                              batch_t, ls_x)
    post_y = gp_regression_1d(batch_t, qnet_mu[:, :, 1], qnet_var[:, :, 1],
                              batch_t, ls_y)
    p_m = torch.stack([post_x.mean, post_y.mean], dim=2)
    p_v = torch.stack([post_x.var, post_y.var], dim=2)
    full_lhood = post_x.log_marginal + post_y.log_marginal

    if entropy_ce:
        ce = -_entropy(p_v)
    else:
        ce = linalg.gauss_cross_entropy(p_m, p_v, qnet_mu, qnet_var)
    ce_bt = ce.sum(dim=2)                                  # (batch, T)

    latent = p_m + eps * linalg.stable_sqrt(p_v)
    logits = decoder(latent)
    recon_bt = -_bernoulli_ce(vids, logits).sum(dim=(2, 3))  # (batch, T)

    if elbo_type == "NP":
        if split is None:
            raise ValueError("the NP ELBO needs split=(n_ctx, perm)")
        n_ctx, perm = split
        is_target = (torch.arange(tmax, device=vids.device)[None, :]
                     >= n_ctx)                             # in perm order
        ctx_mask = ~is_target

        def gather(a):
            return torch.gather(a, 1, perm)

        # filled on the device: no host copy, which a CUDA graph forbids
        big = torch.full((), NP_MASK_NOISE, dtype=dtype, device=vids.device)
        ctx = [gp_regression_1d(gather(batch_t), gather(qnet_mu[:, :, c]),
                                torch.where(ctx_mask,
                                            gather(qnet_var[:, :, c]), big),
                                batch_t, ctx_ls) for c in (0, 1)]
        n_masked = is_target.sum(dim=1).to(dtype)
        pad = -0.5 * n_masked * (torch.log(big) + linalg.LOG_2PI)
        con_lhood = ctx[0].log_marginal + ctx[1].log_marginal - 2 * pad
        np_ce = torch.where(is_target, gather(ce_bt), 0.0).sum(dim=1)
        elbo_recon = torch.where(is_target, gather(recon_bt), 0.0).sum(dim=1)
        prior_kl = full_lhood - np_ce - con_lhood
    else:
        prior_kl = full_lhood - ce_bt.sum(dim=1)
        elbo_recon = recon_bt.sum(dim=1)

    elbo = elbo_recon + beta * prior_kl
    zeros = torch.zeros_like(elbo)
    return BallOutputs(
        elbo=elbo, recon=elbo_recon, prior_kl=prior_kl, inside_elbo=zeros,
        ce_term=ce_bt.sum(dim=1), p_m=p_m, p_v=p_v, qnet_mu=qnet_mu,
        qnet_var=qnet_var, pred_vid=torch.sigmoid(logits),
        inside_elbo_recon=zeros, inside_elbo_kl=zeros,
        gp_cov_elemwise_mean=None)
