"""Time the PyTorch port's serving fit on a CUDA card, by part.

    PYTHONPATH=. python3 tools/time_torch_fit.py [--trace]

Times `gp.precompute_test_posterior_terms` (what `serving.fit` runs) at the
SPRITES serving shape (N = 50,000 train frames, m = 72 inducing points,
L = 64) for the linear x linear GP kernel (statistics through
fused_kernel_stats) and for --K_SE (through gp_sufficient_stats): the
first call in the process,
then REPS warm calls, each on the host clock around
`torch.cuda.synchronize`.  The warm calls are also split into their parts:
the sufficient statistics, the Cholesky of Sigma and the inverse of K_mm.
Encodings and aux data are random, in the ranges the serve produces; the
GP parameters are drawn from seed 0 as `cli.serve` draws them.  TF32 is
off, as in the serve.

--trace runs each first call under torch.profiler and adds what it spent
loading CUDA modules and functions on first use (host ms) and the device
ms of the GP-statistics kernels.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from svgpvae_tpu_torch import linalg
from svgpvae_tpu_torch.cli import serve
from svgpvae_tpu_torch.gp import svgp
from svgpvae_tpu_torch.models import QVAR_CLIP

N = 50_000   # train frames of the 1000-character SPRITES corpus
REPS = 5
SEED = 0


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def traced_ms(fn) -> tuple:
    """(host ms of fn(), host ms of CUDA module and function loading, device
    ms of the GP-statistics kernels), fn() under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms = host_ms(fn)
    rows = prof.key_averages()
    loading = sum(e.self_cpu_time_total for e in rows if "Loading" in e.key)
    stats = sum(e.self_device_time_total for e in rows
                if "stats" in e.key or "build_k" in e.key)
    return ms, loading / 1e3, stats / 1e3


def fit_inputs(n: int, L: int, L_character: int, seed: int, device):
    """(means, variances, aux) like the encoder's: variances clipped to
    QVAR_CLIP, aux = [action id as float, character vector]."""
    rng = np.random.RandomState(seed)
    means = rng.normal(0, 1, (n, L))
    variances = np.clip(np.exp(rng.normal(0, 2, (n, L))), *QVAR_CLIP)
    aux = np.concatenate([rng.randint(0, serve.N_ACTIONS, (n, 1)),
                          rng.normal(0, 1, (n, L_character))], axis=1)
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (means, variances, aux)]


def time_family(argv, device, trace: bool) -> None:
    args = serve.build_parser().parse_args(argv)
    _, _, gp = serve.build_model(args, device)
    means, variances, aux = fit_inputs(N, args.L, args.L_character, SEED,
                                       device)
    fit = lambda: svgp.precompute_test_posterior_terms(gp, means, variances,
                                                       aux)
    if trace:
        first, loading, stats = traced_ms(fit)
        note = (f" (traced: {loading:.1f} ms loading CUDA modules and "
                f"functions, {stats:.3f} ms of GP-statistics kernels)")
    else:
        first, note = host_ms(fit), ""
    warm = [host_ms(fit) for _ in range(REPS)]

    precision = linalg.reciprocal_no_nan(variances).contiguous()
    py = (precision * means).contiguous()
    z = gp.inducing_points
    Kmm = gp.kmat(z, z)
    sigma = Kmm[None] + svgp._fused_precompute_stats(gp, aux, precision,
                                                     py)[0]
    parts = {
        "statistics": lambda: svgp._fused_precompute_stats(gp, aux, precision,
                                                           py),
        "Sigma Cholesky": lambda: svgp._sigma_cholesky(sigma, gp.config),
        "K_mm inverse": lambda: linalg.psd_inverse(Kmm, gp.config.jitter),
    }
    split = {k: [host_ms(f) for _ in range(REPS)] for k, f in parts.items()}
    name = "K_SE" if args.K_SE else "linear"
    fmt = lambda ts: ", ".join(f"{t:.3f}" for t in ts)
    print(f"fit[{name}] N={N}: first call {first:.3f} ms{note}; warm "
          f"{fmt(warm)} ms")
    for k, ts in split.items():
        print(f"  {k}: {fmt(ts)} ms")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--trace", action="store_true")
    trace = p.parse_args().trace
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_fit: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    device = torch.device("cuda", 0)
    for extra in ([], ["--K_SE"]):
        time_family(["--device", "cuda", "--seed", str(SEED)] + extra,
                    device, trace)


if __name__ == "__main__":
    main()
