"""Plain VAE / CVAE forward passes on image data (port of
svgpvae_tpu/models/vae.py): the standard-normal-prior ELBO with a
Gaussian decoder, for rotated MNIST (MnistVAE, or MnistCVAE conditioned
on the angle) and SPRITES (SpritesVAE), and the CVAE's conditional
generation.  Every draw is an input (`eps`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from svgpvae_tpu_torch import linalg, parallel

QVAR_CLIP = (1e-3, 10.0)


class VAEOutputs(NamedTuple):
    recon_loss: Tensor      # per-pixel MSE sum
    kl_term: Tensor
    elbo: Tensor
    recon_images: Tensor
    qnet_mu: Tensor
    qnet_var: Tensor
    latent_samples: Tensor


def cvae_inputs(images: Tensor, angles: Tensor) -> Tensor:
    """NHWC images (b, h, w, 1) and angles (b,) -> (b, h, w, 3): the image,
    then a sin map, then a cos map of the angle."""
    b, h, w, _ = images.shape
    maps = torch.stack([torch.sin(angles), torch.cos(angles)], dim=1)
    maps = maps.to(images.dtype)[:, None, None, :].expand(b, h, w, 2)
    return torch.cat([images, maps], dim=3)


def forward_pass_vae(vae, batch, eps: Tensor,
                     sigma_gaussian_decoder: float = 0.01,
                     clip_qs: bool = False, cvae: bool = False
                     ) -> VAEOutputs:
    """elbo = -recon / (2 sigma^2) - KL(q || N(0, I)); the reported recon
    loss is the per-pixel MSE sum.  batch = (images NHWC, aux); the CVAE
    reads the angle from aux column 1.  `eps` (b, L) is the
    reparameterisation noise, cast to the encoder's output dtype (JAX
    draws it there): under --bf16 the latent sample and the KL are bf16,
    and the pixel error is promoted to the images' fp32."""
    images, aux_data = batch
    K = images.shape[1] * images.shape[2] * images.shape[3]

    if cvae:
        angles = aux_data[:, 1]
        qnet_mu, qnet_var = vae.encode(cvae_inputs(images, angles), angles)
    else:
        qnet_mu, qnet_var = vae.encode(images)
    if clip_qs:
        qnet_var = torch.clamp(qnet_var, *QVAR_CLIP)

    latent_samples = qnet_mu + eps.to(qnet_mu.dtype) * linalg.stable_sqrt(
        qnet_var)
    recon_images = (vae.decode(latent_samples, aux_data[:, 1]) if cvae
                    else vae.decode(latent_samples))

    # over the global batch in a data-parallel step (parallel.sharded)
    recon_sum, kl_term = parallel.psum(
        torch.sum((images - recon_images) ** 2),
        linalg.kl_diag_standard_normal(qnet_mu, qnet_var))
    elbo = -(0.5 / sigma_gaussian_decoder ** 2) * recon_sum - kl_term
    return VAEOutputs(recon_loss=recon_sum / K, kl_term=kl_term, elbo=elbo,
                      recon_images=recon_images, qnet_mu=qnet_mu,
                      qnet_var=qnet_var, latent_samples=latent_samples)


@torch.no_grad()
def predict_cvae(vae, images_train: Tensor, aux_train: Tensor,
                 images_test: Tensor, aux_test: Tensor, eps: Tensor,
                 n_objects: int):
    """CVAE conditional generation: encode the train split, sample with
    `eps` (N_train, L), average the samples of each object id (aux column
    0, in [0, n_objects); an index_add_ segment mean, count floored at 1),
    decode each test row's object mean at its angle.  Returns (recon
    images, mean per-pixel squared error).  The latents and their means
    are in the encoder's output dtype (`eps` is cast to it), as in JAX."""
    angles = aux_train[:, 1]
    qnet_mu, qnet_var = vae.encode(cvae_inputs(images_train, angles), angles)
    latent = qnet_mu + eps.to(qnet_mu.dtype) * linalg.stable_sqrt(qnet_var)

    ids = aux_train[:, 0].long()
    sums = latent.new_zeros(n_objects, latent.shape[1]).index_add_(
        0, ids, latent)
    counts = latent.new_zeros(n_objects).index_add_(
        0, ids, torch.ones_like(ids, dtype=latent.dtype))
    means = sums / torch.clamp(counts, min=1.0)[:, None]

    recon = vae.decode(means[aux_test[:, 0].long()], aux_test[:, 1])
    return recon, torch.mean((images_test - recon) ** 2)
