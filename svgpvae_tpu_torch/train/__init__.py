from svgpvae_tpu_torch.train.geco import geco_effective_alpha  # noqa: F401
from svgpvae_tpu_torch.train.state import GECOState, TrainState  # noqa: F401
from svgpvae_tpu_torch.train.trainer import (  # noqa: F401
    EpochShuffle,
    epoch_batches,
    cosine_decay_lr,
    make_epoch_fn,
    make_generative_chunk_fn,
    make_multi_epoch_fn,
    make_optimizer,
    named_tensors,
    parse_opt_regime,
    train_step,
    trainable_tensors,
)
