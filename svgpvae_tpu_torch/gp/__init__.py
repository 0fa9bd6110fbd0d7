from svgpvae_tpu_torch.gp.casale import (  # noqa: F401
    ALPHA_FLOOR,
    CasaleGP,
    apply_k_inv,
    casale_kernel_matrix,
    casale_noise,
    effective_alpha,
    init_casale_gp,
    kron,
    taylor_terms,
    v_matrix,
)
from svgpvae_tpu_torch.gp.exact import (  # noqa: F401
    GP1DPosterior,
    PearceLengthScales,
    gp_regression_1d,
)
from svgpvae_tpu_torch.gp.fused import (  # noqa: F401
    ball_gp_block,
    ball_gp_block_titsias,
    gp_block_hensman,
    gp_block_titsias,
)
from svgpvae_tpu_torch.gp.svgp import (  # noqa: F401
    BallSVGP,
    MnistSVGP,
    SVGPConfig,
    SpritesSVGP,
    ball_posterior_params,
    ball_variational_loss,
    hensman_terms,
    init_ball_svgp,
    init_mnist_svgp,
    init_sprites_svgp,
    kernel_matrices,
    posterior_params,
    precompute_test_posterior_terms,
    posterior_from_precomputed,
    titsias_terms,
    variational_loss,
)
from svgpvae_tpu_torch.gp.svigp import (  # noqa: F401
    SVIGP,
    init_svigp,
    svigp_posterior_params,
    svigp_variational_loss,
)
