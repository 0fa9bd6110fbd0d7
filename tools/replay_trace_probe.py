"""Does a torch.profiler trace of a replayed SPRITES epoch see every
replay's kernels?  On one CUDA card, RUNS times: chip_smoke.py's phase 8
run (Hensman + GECO, 50,000 frames, 100 full-batch steps an epoch) for 2
epochs through the default loop, epoch 1 traced by --profile_dir
(chip_smoke.traced_steps).  For each trace it prints the B1/B2 launches
the card ran against the counters', the kernel records of each of the
100 cudaGraphLaunch events (the replays off the most common count, by
position), the kernel records whose correlation id names no graph launch
or runtime call, the trace's size and its top-level keys besides
traceEvents (where the profiler leaves its warnings).  The card's name
and power limit come first.

    PYTHONPATH=. python3 tools/replay_trace_probe.py
"""

import glob
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

RUNS = 10


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("replay_trace_probe: no CUDA device")
    from svgpvae_tpu_torch import data
    from svgpvae_tpu_torch.cli import serve, sprites
    from svgpvae_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(cs.gpu_name_and_power())
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    _build.load()
    corpus = data.generate_synthetic_sprites(
        n_train_chars=cs.SERVE_CHARS, n_test_chars=cs.SERVE_CHARS // 4,
        n_frames_train=50, seed=serve.CORPUS_SEED)
    argv = cs.SPRITES_ARGV + ["--opt_regime", "joint-2", "--eval_every", "2"]
    steps = cs.SPRITES_STEPS
    misses = 0
    with tempfile.TemporaryDirectory(prefix="replay_probe_") as base:
        for run in range(RUNS):
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
            orphans = sum(e.get("cat") == "kernel" and e.get("args", {}).get(
                "correlation") not in runtime for e in events)
            gaps = cs.replay_gaps(win["replay_kernels"])
            misses += seen != counted
            cs.log(f"run {run}: the card ran {seen}, the counters {counted}; "
                   f"{len(win['replay_kernels'])} graph launches traced, "
                   f"kernel records per replay min "
                   f"{min(win['replay_kernels'])} max "
                   f"{max(win['replay_kernels'])}, off the most common "
                   f"(position, records) {gaps}; orphan kernel records "
                   f"{orphans}; {len(events)} events, "
                   f"{os.path.getsize(path) / 2**20:.1f} MiB; keys "
                   + json.dumps({k: v for k, v in trace.items()
                                 if k != "traceEvents"})[:2000]
                   + f"; {time.perf_counter() - t0:.1f} s")
    cs.log(f"{misses} of {RUNS} traces saw fewer kernels than the counters; "
           + cs.gpu_name_and_power())
    return 0


if __name__ == "__main__":
    sys.exit(main())
