"""chip_smoke.py phase 15's Casale run and its CPU recheck, several times
in one process on a CUDA card: whether the card's run repeats, and how
the recheck's limit moves with the CPU's own fp32-vs-float64 gap.

    python3 tools/casale_recheck_probe.py [--runs 3]

Prints, per run, the captured step's loss and whether the recheck held
(its own line gives the card-vs-CPU gap, the CPU's gap and the limit).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--runs", type=int, default=3)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("casale_recheck_probe: no CUDA device")
    from svgpvae_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(cs.gpu_name_and_power())
    _build.load()
    mnist_data = cs.mnist_splits()
    for i in range(args.runs):
        res, _ = cs.phase_baseline_train("casale_train", mnist_data)
        print(f"run {i}: captured loss {float(res['captured']['loss'])}",
              flush=True)
        try:
            cs.phase_baseline_cpu_check("casale_train", res, mnist_data)
            print(f"run {i}: the recheck held", flush=True)
        except AssertionError as e:
            print(f"run {i}: the recheck failed: {e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
