from svgpvae_tpu_torch.utils.checkpoint import (  # noqa: F401
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from svgpvae_tpu_torch.utils.convert import params_from_jax  # noqa: F401
from svgpvae_tpu_torch.utils.metrics import (  # noqa: F401
    NonFiniteLossError,
    ResultSaver,
    check_finite,
    count_params,
    mse_rotation,
    post_process_full_cholesky,
)
from svgpvae_tpu_torch.utils.misc import (  # noqa: F401
    dict_to_flags,
    save_video_frames,
)
from svgpvae_tpu_torch.utils.profiling import annotate, trace_if  # noqa: F401
from svgpvae_tpu_torch.utils.rundir import (  # noqa: F401
    dump_args,
    make_checkpoint_folder,
)
