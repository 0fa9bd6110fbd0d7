"""Does a torch.profiler trace of a replayed SPRITES epoch see every
replay's kernels?  On one CUDA card, --runs times: chip_smoke.py's phase
8 run (--config hensman: Hensman + GECO) or phase 12's (--config titsias:
the record flags, the `fused` cell, ~2,100 kernel records a replay) for 2
epochs through the default loop, epoch 1 traced by --profile_dir
(chip_smoke.traced_steps).  For each trace it prints the B1/B2 launches
the card ran against the counters', the kernel records of each of the
100 cudaGraphLaunch events (the replays off the most common count, by
position), the device records (kernels, copies, memsets) in the trace,
the end of the last device record against the end of the host's last
graph launch, the kernel records whose correlation id names no graph
launch or runtime call, the trace's size and its top-level keys besides
traceEvents (where the profiler leaves its warnings).  Kineto's own
warnings (a full activity buffer: "Exceeded max GPU buffer count") go to
the process's standard error.  The card's name and power limit come
first.

--chars N trains on an N-character corpus (N / 10 replays an epoch:
fewer records for the activity buffers), which tells a full buffer apart
from records dropped past the window's end.

    PYTHONPATH=. python3 tools/replay_trace_probe.py [--config titsias]
        [--runs 10] [--chars 1000]
"""

import argparse
import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

CONFIGS = {"hensman": cs.SPRITES_ARGV, "titsias": cs.SPRITES_TITSIAS_ARGV}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--config", choices=sorted(CONFIGS), default="hensman")
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--chars", type=int, default=cs.SERVE_CHARS,
                   help="train characters (50 frames each)")
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("replay_trace_probe: no CUDA device")
    from svgpvae_tpu_torch import data
    from svgpvae_tpu_torch.cli import serve, sprites
    from svgpvae_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(cs.gpu_name_and_power())
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
           f"{vars(args)}")
    _build.load()
    corpus = data.generate_synthetic_sprites(
        n_train_chars=args.chars, n_test_chars=max(2, args.chars // 4),
        n_frames_train=50, seed=serve.CORPUS_SEED)
    argv = [{str(cs.SERVE_CHARS): str(args.chars)}.get(a, a)
            for a in CONFIGS[args.config]] + [
        "--opt_regime", "joint-2", "--eval_every", "2"]
    steps = args.chars * 50 // 500
    misses = 0
    with tempfile.TemporaryDirectory(prefix="replay_probe_") as base:
        for run in range(args.runs):
            t0 = time.perf_counter()
            seen, counted, win = cs.traced_steps(
                sprites, argv, {"splits": corpus}, base,
                slice(steps, 2 * steps), (0, steps))
            (path,) = sorted(glob.glob(os.path.join(base, "trace_*",
                                                    "*.json")),
                             key=os.path.getmtime)[-1:]
            with open(path) as f:
                trace = json.load(f)
            events = trace["traceEvents"]
            runtime = {e.get("args", {}).get("correlation") for e in events
                       if e.get("cat") == "cuda_runtime"}
            device = [e for e in events if e.get("cat") in (
                "kernel", "gpu_memcpy", "gpu_memset")]
            orphans = sum(e.get("cat") == "kernel" and e.get("args", {}).get(
                "correlation") not in runtime for e in device)
            launches = [e for e in events if e.get("cat") == "cuda_runtime"
                        and e.get("name", "").startswith("cudaGraphLaunch")]
            last_launch = max((e["ts"] + e.get("dur", 0.0) for e in launches),
                              default=0.0)
            last_device = max((e["ts"] + e.get("dur", 0.0) for e in device),
                              default=0.0)
            gaps = cs.replay_gaps(win["replay_kernels"])
            misses += seen != counted
            cs.log(f"run {run}: the card ran {seen}, the counters {counted}; "
                   f"{len(win['replay_kernels'])} graph launches traced, "
                   f"kernel records per replay min "
                   f"{min(win['replay_kernels'])} max "
                   f"{max(win['replay_kernels'])}, off the most common "
                   f"(position, records) {gaps}; device records "
                   f"{len(device)}; the last device record ends "
                   f"{(last_device - last_launch) / 1e3:.3f} ms after the "
                   f"last graph launch returns; orphan kernel records "
                   f"{orphans}; {len(events)} events, "
                   f"{os.path.getsize(path) / 2**20:.1f} MiB; keys "
                   + json.dumps({k: v for k, v in trace.items()
                                 if k != "traceEvents"})[:2000]
                   + f"; {time.perf_counter() - t0:.1f} s")
    cs.log(f"{misses} of {args.runs} traces saw fewer kernels than the "
           f"counters; " + cs.gpu_name_and_power())
    return 0


if __name__ == "__main__":
    sys.exit(main())
