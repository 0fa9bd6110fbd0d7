"""Hand-written CUDA kernels with their plain PyTorch twins.

  ops.gp_stats            gp_sufficient_stats(_reference), gp_stats (autograd)
  ops.fused_kernel_stats  fused_kernel_stats(_reference)
  ops.chol_inverse        chol_inverse_kernel, chol_inverse_reference,
                          chol_inverse (autograd)

Import the submodules directly: the function `fused_kernel_stats` shares
its module's name, so it is not re-exported here.  `launch_counts` reads
every kernel wrapper's launch counter; `reset_launch_counts` zeroes them;
`add_launch_counts` moves a CUDA graph's counts from its capture to its
replays.
`KernelInputRecorder` records the dtype of every tensor the GP modules
hand to the kernels' wrappers.
"""


def _wrappers() -> dict:
    from svgpvae_tpu_torch.ops import chol_inverse as ci
    from svgpvae_tpu_torch.ops import fused_kernel_stats as fks
    from svgpvae_tpu_torch.ops import gp_stats as gps
    return {"chol_inverse": ci.chol_inverse_kernel,
            "fused_kernel_stats": fks.fused_kernel_stats,
            "gp_sufficient_stats": gps.gp_sufficient_stats}


def launch_counts() -> dict:
    """{kernel name: CUDA launches so far} over every kernel wrapper."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


def add_launch_counts(counts: dict, sign: int = 1) -> None:
    """Add `sign` x counts ({kernel name: launches}) to the wrappers'
    counters.  A CUDA-graph capture runs the wrappers, which count, but
    launches nothing; train.capture takes those counts back out at the
    capture and adds them at every replay, so that `launch_counts` reads
    what the device ran, as in an eager run."""
    for name, fn in _wrappers().items():
        fn.launches += sign * counts.get(name, 0)


class KernelInputRecorder:
    """While open, `seen` collects (name, dtype) of every tensor handed,
    by position or by keyword, to the kernels' wrappers where the GP
    modules call them: B2 `gp_stats` and the forward-only
    `gp_sufficient_stats`, B3 `fused_kernel_stats` (gp.svgp), B1
    `chol_inverse` (gp.fused).  It wraps those names and counts no
    launch."""

    def __enter__(self):
        from svgpvae_tpu_torch.gp import fused, svgp
        self.seen, self.saved = [], []
        for owner, name in ((svgp, "gp_stats"), (svgp, "gp_sufficient_stats"),
                            (svgp, "fused_kernel_stats"),
                            (fused, "chol_inverse")):
            self._wrap(owner, name)
        return self

    def _wrap(self, owner, name):
        import torch
        fn = getattr(owner, name)
        self.saved.append((owner, name, fn))

        def recording(*args, **kwargs):
            self.seen.extend((name, a.dtype) for a in (*args, *kwargs.values())
                             if isinstance(a, torch.Tensor))
            return fn(*args, **kwargs)
        setattr(owner, name, recording)

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)
        return False

    def names(self) -> set:
        return {n for n, _ in self.seen}

    def dtypes(self) -> set:
        return {d for _, d in self.seen}
