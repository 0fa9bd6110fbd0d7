"""chip_smoke.py's phase 22 and 21(b)'s SPRITES additions alone on one
CUDA card: the MNIST driver's last loops replayed from captured CUDA
graphs (VAE, CVAE, the --opt_regime VAE phases, Casale at
--casale_taylor_every 1 and 2) beside phase 15's per-step runs, and
21(b)'s fp32 SPRITES run with its pretraining epochs and eval calls
captured (on 21(b)'s small corpus, held to its per-step run there, its
pretraining too; then the traced eval calls).  The card's name and
power limit come first.

    PYTHONPATH=. python3 tools/captured_rest_phase.py
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
        raise SystemExit("captured_rest_phase: no CUDA device")
    from svgpvae_tpu_torch import data
    from svgpvae_tpu_torch.cli import sprites
    from svgpvae_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(cs.gpu_name_and_power())
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.load()
    cs.log(f"build: {time.perf_counter() - t0:.2f} s")
    splits = cs.mnist_splits()
    corpus = data.generate_synthetic_sprites(
        n_train_chars=cs.DEFAULT_LOOP_CHARS,
        n_test_chars=cs.DEFAULT_LOOP_CHARS // 4, n_frames_train=50, seed=0)
    with tempfile.TemporaryDirectory(prefix="captured_rest_") as runs:
        t0 = time.perf_counter()
        sp_argv = cs.SPRITES_ARGV + cs.SAVE_ARGV + ["--base_dir", runs]
        eager = cs.launched(sprites.main, sp_argv, splits=corpus,
                            per_step=True)
        seen = cs.sprites_default_loop("21(b) sprites", sp_argv, eager,
                                       (2, 1, 0), corpus, runs)
        eval_seen = cs.sprites_eval_trace(corpus)
        cs.log(f"[21(b) sprites: {time.perf_counter() - t0:.1f} s] traced "
               f"epoch {seen}, eval calls {eval_seen}")
        phase15 = {tag: cs.phase_baseline_train(tag, splits)
                   for tag in cs.CAPTURED_REST_RUNS if tag in
                   cs.BASELINE_RUNS}
        phase15["mnist_vae_phase_train"] = cs.phase_vae_phase_train(splits)
        t0 = time.perf_counter()
        paths = cs.phase_captured_rest(splits, phase15, runs)
        cs.log(f"[phase 22: {time.perf_counter() - t0:.1f} s] {paths}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
