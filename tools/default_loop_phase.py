"""chip_smoke.py's phase 21 alone on one CUDA card: the default training
loops replayed from captured CUDA graphs (MNIST at --epoch_chunk 1, the
SPRITES epochs on the phase's small corpus, the ball's chunks), beside the
per-step runs of phases 6, 11 and 14 (and its own SPRITES per-step runs)
that it holds them to, then 20(b)'s deterministic
resume check (ROADMAP.md section C 12).  The card's name and power limit
come first.

    PYTHONPATH=. python3 tools/default_loop_phase.py
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
        raise SystemExit("default_loop_phase: no CUDA device")
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
    with tempfile.TemporaryDirectory(prefix="default_loop_") as runs:
        phase14 = {tag: cs.phase_ball_train(tag, runs)
                   for tag in cs.BALL_RUNS}
        t0 = time.perf_counter()
        launches = cs.phase_default_loops(splits, phase6, phase11, phase14,
                                          runs)
        cs.log(f"[phase 21: {time.perf_counter() - t0:.1f} s] {launches}")
        t0 = time.perf_counter()
        long_argv = [{f"joint-{cs.CHUNK_RESUME_EPOCHS}":
                      f"joint-{2 * cs.CHUNK_RESUME_EPOCHS}"}.get(a, a)
                     for a in cs.CHUNK_RESUME_ARGV]
        cs.deterministic_resume(splits, long_argv, runs,
                                ("eval_mse", "test_mse", "cgen_mse"))
        cs.log(f"[20(b) deterministic: {time.perf_counter() - t0:.1f} s]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
