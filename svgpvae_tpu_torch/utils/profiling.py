"""Tracing hooks (port of svgpvae_tpu/utils/profiling.py).

    with trace_if(args.profile_dir, enabled=...):
        ... the traced steps ...

`trace_if` runs `torch.profiler` over its block (CPU activities, and CUDA
activities when a CUDA device is present) and exports one Chrome trace,
<dir>/trace_<pid>_<ms>.json, which chrome://tracing or Perfetto open;
`annotate(name)` is `torch.profiler.record_function`, a named range in
that trace (the drivers mark "train_step", "gp_block" and "eval_pass";
where the steps replay captured CUDA graphs, train.capture puts each
step's replay, or its eager warm-up or capture, in a "train_step"
range).  The drivers keep their own per-step timing (`step_seconds`: a
step's seconds after synchronize, or a replayed epoch's or chunk's
seconds over its steps, the JAX StepTimer's blocks), so the JAX
package's StepTimer has no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace_if(trace_dir: str, enabled: bool = True):
    """torch.profiler trace of the block into `trace_dir`; a no-op when
    disabled.  Yields the path of the trace it writes (None when
    disabled)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_"
                                   f"{int(time.time() * 1e3)}.json")
    with profile(activities=activities) as prof:
        _pad(cuda)
        yield path
        _pad(cuda)
    prof.export_chrome_trace(path)


# Host seconds of idle card at each end of a CUDA trace.  The profiler
# keeps only the card's records that lie inside its window on the host's
# clock; without a margin the window's first or last kernels, which run
# against its edges, were sometimes left out (up to 421 of a replayed
# SPRITES step's 744 kernel records; tools/replay_trace_probe.py).
TRACE_PAD_S = 0.1


def _pad(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)


def annotate(name: str):
    """A named range in the trace (record_function); costs next to nothing
    when no profiler runs."""
    return torch.profiler.record_function(name)
