"""chip_smoke.py's phase 20 alone on one CUDA card: --epoch_chunk and
--eval_bundle as replayed CUDA graphs, beside the eager runs of phases 6
and 11 that it is held to (the build, the 36-digit set, those two runs,
then phase 20).  Prints the card's name and power limit first.

    PYTHONPATH=. python3 tools/epoch_chunk_phase.py
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("epoch_chunk_phase: no CUDA device")
    from svgpvae_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(cs.gpu_name_and_power())
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.load()
    cs.log(f"build: {time.perf_counter() - t0:.2f} s")
    splits = cs.mnist_splits()
    phase6 = cs.phase_train(splits)
    phase11 = cs.phase_train(splits, cs.TITSIAS_ARGV, 32, cs.TRAIN_STEPS,
                             cs.CAPTURE_STEP, "mnist titsias train", 2)
    with tempfile.TemporaryDirectory(prefix="chunk_phase_") as runs:
        t0 = time.perf_counter()
        launches = cs.phase_epoch_chunk(splits, phase6, phase11, runs)
        cs.log(f"[phase 20: {time.perf_counter() - t0:.1f} s] {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
