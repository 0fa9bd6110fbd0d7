"""The MNIST baselines side by side: the port's cli.mnist on the card and the
JAX CLI on the CPU, on the same data and flags.

    PYTHONPATH=. python3 tools/baselines_gate.py --package torch \
        [--seeds 0 1] [--runs vae cvae svigp casale] [--out FILE]
    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/baselines_gate.py \
        --package jax --data_dir DIR [--seeds 0 1] [--out FILE]

The data: the rotated 36-digit synthetic set at the drivers' widths
(N_train = 8,100, 800 objects), generated once with the port's numpy
generator at seed 0 whatever --seed a run takes, so both packages and
both seeds see the same rows (the JAX CLI reads it as pickles written to
--data_dir).  The runs, at the drivers' defaults otherwise (batch 256,
L = 16, M = 8, m = 32), with the flags of the JAX package's own runs
of each baseline (tools/tpu_round2.py, tools/tpu_round5.py):

  vae     --elbo VAE --clip_qs --nr_epochs 20 --eval_every 5
  cvae    --elbo CVAE --clip_qs --nr_epochs 20 --eval_every 5
  svigp   --elbo SVIGP_Hensman --PCA --ip_joint --GP_joint --ov_joint
          --clip_qs --nr_epochs 20 --eval_every 5
  casale  --elbo GPVAE_Casale --GP_joint --ov_joint --clip_qs --PCA
          --opt_regime VAE-5 GP-5 joint-10  (the cgen every 5 epochs)

Each run reports its best cgen MSE (the VAE has no cgen: its last and
best test recon MSE) and, for the port, the step p50 / p90 and the eval
seconds.  One JSON object per run is printed and, with --out, the list
is written there.
The card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

RUNS = {
    "vae": ["--elbo", "VAE", "--clip_qs", "--nr_epochs", "20",
            "--eval_every", "5"],
    "cvae": ["--elbo", "CVAE", "--clip_qs", "--nr_epochs", "20",
             "--eval_every", "5"],
    "svigp": ["--elbo", "SVIGP_Hensman", "--PCA", "--ip_joint", "--GP_joint",
              "--ov_joint", "--clip_qs", "--nr_epochs", "20", "--eval_every",
              "5"],
    "casale": ["--elbo", "GPVAE_Casale", "--GP_joint", "--ov_joint",
               "--clip_qs", "--PCA", "--opt_regime", "VAE-5", "GP-5",
               "joint-10"],
}
DATA_SEED = 0


def run_torch(name, seed, data_splits, device) -> dict:
    from svgpvae_tpu_torch.cli import mnist
    argv = RUNS[name] + ["--dataset", "36", "--seed", str(seed),
                         "--device", device]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = mnist.main(argv, splits=data_splits)
    sec = np.asarray(res["step_seconds"][1:])
    out = {"run": name, "package": "torch", "seed": seed,
           "seconds": time.perf_counter() - t0, "steps": len(sec) + 1,
           "step_p50_ms": 1e3 * float(np.percentile(sec, 50)),
           "step_p90_ms": 1e3 * float(np.percentile(sec, 90)),
           "eval_seconds": [e["seconds"] for e in res["evals"]]}
    if name == "vae":
        tests = [e["test_mse"] for e in res["evals"]]
        out.update(last_test_mse=tests[-1], best_test_mse=min(tests))
    else:
        out.update(best_cgen_mse=res["best_cgen_mse"],
                   cgen_mse=[e["cgen_mse"] for e in res["evals"]])
    return out


def run_jax(name, seed, data_dir) -> dict:
    from svgpvae_tpu.cli import mnist as jmnist
    argv = RUNS[name] + ["--dataset", "36", "--seed", str(seed),
                         "--mnist_data_path", data_dir]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = jmnist.main(argv)
    log = buf.getvalue()
    out = {"run": name, "package": "jax", "seed": seed,
           "seconds": time.perf_counter() - t0}
    if name == "vae":
        tests = [float(x) for x in re.findall(r"test MSE: ([0-9.]+)", log)]
        out.update(last_test_mse=tests[-1], best_test_mse=min(tests))
    else:
        out.update(best_cgen_mse=res["best_cgen_mse"], cgen_mse=[
            float(x) for x in re.findall(r"cgen test MSE: ([0-9.]+)", log)])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--package", choices=["torch", "jax"], required=True)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--runs", nargs="+", default=list(RUNS),
                   choices=list(RUNS))
    p.add_argument("--data_dir", type=str, default=None,
                   help="jax: where the dataset pickles are written")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)

    from svgpvae_tpu_torch import data
    base = data.synthetic_digit_base_images("36", per_digit=400,
                                            seed=DATA_SEED)
    if args.package == "torch":
        if args.device == "cuda":
            print(subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip())
        data_splits = data.generate_rotated_mnist(base, None, digits="36",
                                                  seed=DATA_SEED)
    else:
        if not args.data_dir:
            raise SystemExit("--package jax needs --data_dir")
        data.generate_rotated_mnist(base, args.data_dir, digits="36",
                                    seed=DATA_SEED)
    results = []
    for name in args.runs:
        for seed in args.seeds:
            r = (run_torch(name, seed, data_splits, args.device)
                 if args.package == "torch"
                 else run_jax(name, seed, args.data_dir))
            print(json.dumps(r), flush=True)
            results.append(r)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
