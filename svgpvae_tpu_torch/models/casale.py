"""Casale GPVAE forward and predict passes (port of
svgpvae_tpu/models/casale.py).  The training pass takes the Taylor terms
over the FULL train set (gp.casale.taylor_terms), gathered per batch by
the global row index; prediction is the full-GP posterior through the
Woodbury form.  Every draw is an input.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from svgpvae_tpu_torch import linalg
from svgpvae_tpu_torch.gp.casale import (CasaleGP, apply_k_inv,
                                         casale_kernel_matrix, casale_noise,
                                         effective_alpha)

QVAR_CLIP = (1e-3, 100.0)


class CasaleOutputs(NamedTuple):
    elbo: Tensor           # minimized directly
    recon_loss: Tensor     # per-pixel MSE sum
    gp_prior_term: Tensor
    log_var: Tensor
    qnet_mu: Tensor
    qnet_var: Tensor
    recon_images: Tensor


def encode_full_casale(vae, images: Tensor, eps: Tensor,
                       clip_qs: bool = False) -> Tensor:
    """Encode (a chunk of) the train set and sample its latents Z with
    `eps` (N, L)."""
    qnet_mu, qnet_var = vae.encode(images)
    if clip_qs:
        qnet_var = torch.clamp(qnet_var, *QVAR_CLIP)
    return qnet_mu + eps * linalg.stable_sqrt(qnet_var)


def forward_pass_casale(vae, gp: CasaleGP, batch, eps: Tensor, a: Tensor,
                        c: Tensor, V: Tensor, beta, ztKV: Tensor,
                        K_inv_V: Tensor, clip_qs: bool = False
                        ) -> CasaleOutputs:
    """The training objective from the factored Taylor terms (a, ztKV,
    K_inv_V, c of gp.casale.taylor_terms; V (N, H)): the batch's rows of
    B_l = -a_l ztKV_l + K_inv_V are built from the gathered pieces, never
    the (L, N, H) tensor.  Aux column 0 is the global train index (the
    sorted-train layout); `eps` (b, L).

    elbo = recon / K - (beta / L) (gp_prior_term + log_var / 2), the
    loss minimized (eq. 18 of Casale's appendix)."""
    images, aux_data = batch
    idx = aux_data[:, 0].long()
    K = images.shape[1] * images.shape[2]

    qnet_mu, qnet_var = vae.encode(images)
    L = qnet_mu.shape[1]
    if clip_qs:
        qnet_var = torch.clamp(qnet_var, *QVAR_CLIP)
    log_var = torch.sum(torch.log(qnet_var))
    latent = qnet_mu + eps * linalg.stable_sqrt(qnet_var)

    a_batch = a[:, idx]                                  # (L, b)
    B_batch = -a_batch[:, :, None] * ztKV[:, None, :] + K_inv_V[idx][None]
    gp_prior_term = (torch.sum(latent * a_batch.T)
                     + torch.sum(B_batch * V[idx][None])
                     + torch.sum(c) * effective_alpha(casale_noise(gp)))

    recon_images = vae.decode(latent)
    recon_sum = torch.sum((images - recon_images) ** 2)
    elbo = recon_sum / K - (beta / L) * (gp_prior_term + 0.5 * log_var)
    return CasaleOutputs(elbo=elbo, recon_loss=recon_sum / K,
                         gp_prior_term=gp_prior_term, log_var=log_var,
                         qnet_mu=qnet_mu, qnet_var=qnet_var,
                         recon_images=recon_images)


@torch.no_grad()
def predict_cgen_casale(vae, gp: CasaleGP, test_images: Tensor,
                        test_aux: Tensor, train_aux: Tensor, V: Tensor,
                        latent_train: Tensor, eps: Optional[Tensor],
                        take_mean: bool = False,
                        noise_override: Optional[float] = None):
    """The full-GP predictive posterior at the test rows ([id, angle,
    pca...]) conditioned on the train latents (train rows [global index,
    id, angle, pca...]), sampled with `eps` (x, L) (the mean alone with
    `take_mean`), decoded.  `noise_override` replaces the trained noise in
    this smoother only (a float, or a 0-d tensor on the device: a
    captured call's).  Returns (recon images, mean per-pixel squared
    error)."""
    L = latent_train.shape[1]
    noise = (casale_noise(gp) if noise_override is None else
             torch.as_tensor(noise_override, dtype=latent_train.dtype,
                             device=latent_train.device))

    @linalg.precise
    def posterior_mean_var():
        K_tt = casale_kernel_matrix(gp, test_aux, train_aux[:, 1:])  # (x, N)
        mean = K_tt @ apply_k_inv(V, noise, latent_train)          # (x, L)
        if take_mean:
            return mean, None
        K_xx = casale_kernel_matrix(gp, test_aux, test_aux)
        cov = K_xx - K_tt @ apply_k_inv(V, noise, K_tt.T)
        return mean, torch.diagonal(cov)  # the same for every channel

    mean, var = posterior_mean_var()
    latent_test = (mean if take_mean else
                   mean + eps * linalg.stable_sqrt(var[:, None].expand(-1, L)))
    recon = vae.decode(latent_test)
    return recon, torch.mean((test_images - recon) ** 2)
