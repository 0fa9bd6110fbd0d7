"""Tracing hooks (port of svgpvae_tpu/utils/profiling.py).

    with trace_if(args.profile_dir, enabled=...):
        ... the traced steps ...

`trace_if` runs `torch.profiler` over its block (CPU activities, and CUDA
activities when a CUDA device is present) and exports one Chrome trace,
<dir>/trace_<pid>_<ms>.json, which chrome://tracing or Perfetto open;
`annotate(name)` is `torch.profiler.record_function`, a named range in
that trace (the drivers mark "train_step", "gp_block" and "eval_pass").
The drivers keep their own per-step timing (`step_seconds`), so the JAX
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
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"trace_{os.getpid()}_"
                                   f"{int(time.time() * 1e3)}.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def annotate(name: str):
    """A named range in the trace (record_function); costs next to nothing
    when no profiler runs."""
    return torch.profiler.record_function(name)
