"""chip_smoke.py's phase 23 alone: --data_parallel over NCCL, one rank a
card, on a machine with 4 cards (the 4-card runs need them; on 2 or 3 the
phase runs what fits).  The north-star MNIST run, its Titsias and deep
SVIGP runs, the SPRITES run, the MNIST VAE run (the VAE runner's epochs,
captured over NCCL) and the serve, each per step over 2 and 4
cards held to its 1-process run, then on its default loop (CUDA graphs
with the all-reduces inside) held to its per-step run, the 1-process
yardstick runs in the same process (chip_smoke.py's comment above
NCCL_RUNS).  The cards' names and power limits come first; each run
prints one line of numbers (step p50/p90 of the untraced epochs, the
traced epoch's ms a step, idle share and NCCL all-reduce kernels and ms a
step, every rank's launches), and all of them go to --out as JSON.
Exits non-zero when any hold or check failed.

    PYTHONPATH=. python3 tools/nccl_phase.py
        [--out chiprun_out/nccl_phase.json]
        [--parts mnist,mnist_titsias,svigp,sprites,vae,serve]

--parts runs those parts alone (a short first run on the cards).
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="chiprun_out/nccl_phase.json")
    p.add_argument("--parts", default=None,
                   help="comma-separated parts (NCCL_RUNS' tags, serve)")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("nccl_phase: no CUDA device")
    if torch.cuda.device_count() < 2:
        raise SystemExit(f"nccl_phase: {torch.cuda.device_count()} card, "
                         "2 or more needed")
    from svgpvae_tpu_torch import data
    from svgpvae_tpu_torch.cli import serve
    from svgpvae_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    power = cs.gpu_name_and_power()
    cs.log(power)
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda} nccl "
           f"{'.'.join(map(str, torch.cuda.nccl.version()))}, "
           f"{torch.cuda.device_count()} cards")
    t0 = time.perf_counter()
    _build.load()
    cs.log(f"build: {time.perf_counter() - t0:.2f} s")
    parts = None if args.parts is None else args.parts.split(",")
    splits = cs.mnist_splits()
    corpus = None if parts is not None and not {"sprites", "serve"} & set(
        parts) else data.generate_synthetic_sprites(
            n_train_chars=cs.SERVE_CHARS, n_test_chars=cs.SERVE_CHARS // 4,
            n_frames_train=50, seed=serve.CORPUS_SEED)
    records, failure, paths = [], None, {}
    with tempfile.TemporaryDirectory(prefix="nccl_phase_") as runs:
        t0 = time.perf_counter()
        try:
            paths = cs.phase_nccl(splits, corpus, runs, records, parts)
        except AssertionError as e:  # the records are written first
            failure = e
        cs.log(f"[phase 23: {time.perf_counter() - t0:.1f} s] {paths}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"cards": power, "records": records, "paths": paths,
                   "failed": None if failure is None else str(failure)},
                  f, indent=1)
    if failure is not None:
        raise failure
    return 0


if __name__ == "__main__":
    sys.exit(main())
