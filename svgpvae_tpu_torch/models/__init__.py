from svgpvae_tpu_torch.models.ball import (  # noqa: F401
    BALL_PVAR_CLIP,
    BALL_QVAR_CLIP,
    BallOutputs,
    ball_svgpvae_elbo,
    draw_np_split,
    full_cholesky_marginal_vars,
    pearce_elbo,
)
from svgpvae_tpu_torch.models.casale import (  # noqa: F401
    CasaleOutputs,
    encode_full_casale,
    forward_pass_casale,
    predict_cgen_casale,
)
from svgpvae_tpu_torch.models.svigp import (  # noqa: F401
    SVIGPOutputs,
    forward_pass_deep_svigp,
    predict_deep_svigp,
)
from svgpvae_tpu_torch.models.svgpvae import (  # noqa: F401
    GP_BLOCK_AUTO_TABLE,
    PVAR_CLIP,
    QVAR_CLIP,
    SVGPVAEOutputs,
    batching_encode_svgpvae,
    forward_pass_svgpvae,
    precompute_gp_params,
    predict_cgen_mnist,
    predict_cgen_sprites,
    resolve_gp_block_impl,
    sprites_aux_data,
)
from svgpvae_tpu_torch.models.vae import (  # noqa: F401
    VAEOutputs,
    cvae_inputs,
    forward_pass_vae,
    predict_cvae,
)
