from svgpvae_tpu_torch.gp.fused import (  # noqa: F401
    gp_block_hensman,
    gp_block_titsias,
)
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
    titsias_terms,
    variational_loss,
)
