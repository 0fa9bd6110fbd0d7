"""Hand-written CUDA kernels with their plain PyTorch twins.

  ops.gp_stats            gp_sufficient_stats(_reference), gp_stats (autograd)
  ops.fused_kernel_stats  fused_kernel_stats(_reference)
  ops.chol_inverse        chol_inverse_kernel, chol_inverse_reference,
                          chol_inverse (autograd)

Import the submodules directly: the function `fused_kernel_stats` shares
its module's name, so it is not re-exported here.  `launch_counts` reads
every kernel wrapper's launch counter; `reset_launch_counts` zeroes them.
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
