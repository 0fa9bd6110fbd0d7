from svgpvae_tpu_torch.nn.nets import (  # noqa: F401
    BallDecoder,
    BallEncoder,
    ClassificationHead,
    MnistCVAE,
    MnistVAE,
    SVIGPDecoder,
    SpritesReprNet,
    SpritesVAE,
    safe_exp,
    upsample2x,
)
