"""Deep SVIGP (the decoder-only Hensman baseline) forward and predict
passes (port of svgpvae_tpu/models/svigp.py).  No encoder: the GP's
posterior means at the batch's aux data feed the decoder, under the exact
Gaussian likelihood with the GP's trainable noise.  No draws.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from svgpvae_tpu_torch import linalg, parallel
from svgpvae_tpu_torch.gp.svigp import (SVIGP, svigp_posterior_params,
                                        svigp_variational_loss)


class SVIGPOutputs(NamedTuple):
    elbo: Tensor
    recon_loss: Tensor       # per-pixel MSE sum
    kl_term: Tensor
    inside_elbo: Tensor
    recon_images: Tensor
    inside_elbo_recon: Tensor
    inside_elbo_kl: Tensor
    latent_samples: Tensor   # posterior mean vectors (b, L)


def forward_pass_deep_svigp(decoder, gp: SVIGP, batch) -> SVIGPOutputs:
    """elbo = -bK log(noise) - bK log(2 pi) / 2 - recon / (2 noise^2)
    + [sum_terms - (b / N) KL].  Aux rows are [global_index, id, angle,
    pca...]; the GP takes columns 1: (the global index is dropped).  In a
    data-parallel step (parallel.sharded) b and the sums are the global
    batch's."""
    images, aux_data = batch
    b = parallel.global_rows(images.shape[0])
    K = images.shape[1] * images.shape[2] * images.shape[3]

    sum_terms, kl_terms, mean_vectors = svigp_variational_loss(
        gp, aux_data[:, 1:])
    inside_elbo_recon = torch.sum(sum_terms)
    inside_elbo_kl = torch.sum(kl_terms)
    inside_elbo = inside_elbo_recon - (b / gp.N_train) * inside_elbo_kl

    recon_images = decoder(mean_vectors)
    recon_sum = parallel.psum(torch.sum((images - recon_images) ** 2))
    elbo = (-b * K * torch.log(gp.noise) - 0.5 * b * K * linalg.LOG_2PI
            - 0.5 * recon_sum / gp.noise ** 2 + inside_elbo)
    return SVIGPOutputs(elbo=elbo, recon_loss=recon_sum / K,
                        kl_term=inside_elbo, inside_elbo=inside_elbo,
                        recon_images=recon_images,
                        inside_elbo_recon=inside_elbo_recon,
                        inside_elbo_kl=inside_elbo_kl,
                        latent_samples=mean_vectors)


@torch.no_grad()
def predict_deep_svigp(decoder, gp: SVIGP, batch):
    """Posterior means at the test aux data -> decode -> (recon images,
    per-pixel MSE sum)."""
    images, aux_data = batch
    K = images.shape[1] * images.shape[2]
    p_m, _ = svigp_posterior_params(gp, aux_data[:, 1:])
    recon = decoder(p_m)
    return recon, torch.sum((images - recon) ** 2) / K
