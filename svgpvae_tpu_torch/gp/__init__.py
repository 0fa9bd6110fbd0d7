from svgpvae_tpu_torch.gp.fused import gp_block_hensman  # noqa: F401
from svgpvae_tpu_torch.gp.svgp import (  # noqa: F401
    MnistSVGP,
    SVGPConfig,
    SpritesSVGP,
    hensman_terms,
    init_mnist_svgp,
    init_sprites_svgp,
    kernel_matrices,
    posterior_params,
    precompute_test_posterior_terms,
    posterior_from_precomputed,
    variational_loss,
)
