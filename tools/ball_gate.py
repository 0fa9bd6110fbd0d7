"""The moving-ball quality gate: the JAX package's record flags at the
reference's 25k-step budget, trained by the port's driver on a CUDA card.

    PYTHONPATH=. python3 tools/ball_gate.py [--runs hensman titsias pearce]
        [--seeds 0 1] [--steps 25000] [--out ball_gate.json]

Each run is `cli.ball.main` with

    hensman: --elbo SVGPVAE_Hensman --clip_qs --entropy_ce
    titsias: --elbo SVGPVAE_Titsias --clip_qs
    pearce:  --elbo GPVAE_Pearce                (the driver's default)

plus --steps <steps> --eval_every 5000 --seed <seed> --device cuda (the
JAX record runs: tools/tpu_round3.py::ball_job, with wave 19's
--entropy_ce for Hensman; RESULTS.md).  The eval is the driver's: the
trajectory MSE (mse_rotation) on the first fixed test batch, the same
numpy batches as the JAX driver's.  JAX reached a final MSE of 6.743
(Hensman) and 6.748 (Titsias) at 25k steps; the pass line is that + 5%.
Pearce is unconverged at 25k steps (JAX: 26.709 and 18.817 on two seeds),
so it is a reading, not a gate.

Prints the card's name and power limit, then per run and seed the MSE
at each eval, the final and best MSE, the step time p50/p90 (host clock
after torch.cuda.synchronize) and the seconds; the JSON file is
rewritten after each run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

FLAGS = {"hensman": ["--elbo", "SVGPVAE_Hensman", "--clip_qs",
                     "--entropy_ce"],
         "titsias": ["--elbo", "SVGPVAE_Titsias", "--clip_qs"],
         "pearce": ["--elbo", "GPVAE_Pearce"]}
JAX_FINAL = {"hensman": 6.743, "titsias": 6.748}  # RESULTS.md:22, 1045
PASS_FACTOR = 1.05
JAX_PEARCE = {0: 26.709, 1: 18.817}  # RESULTS.md:408-409, a reading


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--runs", nargs="+", default=["hensman", "titsias"],
                   choices=list(FLAGS))
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--steps", type=int, default=25000)
    p.add_argument("--eval_every", type=int, default=5000)
    p.add_argument("--out", default="ball_gate.json")
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ball_gate: no CUDA device")
    from svgpvae_tpu_torch.cli import ball

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"card": card, "torch": torch.__version__, "steps": args.steps,
           "runs": {}}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    base_dir = tempfile.mkdtemp(prefix="ball_gate_")
    for run in args.runs:
        for seed in args.seeds:
            t = time.perf_counter()
            res = ball.main(FLAGS[run] + [
                "--steps", str(args.steps), "--eval_every",
                str(args.eval_every), "--seed", str(seed), "--device",
                "cuda", "--base_dir", base_dir])
            evals = [(e["step"], e["mse"]) for e in res["evals"]]
            r = {"evals": evals, "final_mse": res["mse"],
                 "best_mse": min(m for _, m in evals),
                 "step_ms_p50": res["step_p50_ms"],
                 "step_ms_p90": res["step_p90_ms"],
                 "seconds": time.perf_counter() - t}
            if run in JAX_FINAL:
                r["jax_final"] = JAX_FINAL[run]
                r["pass_line"] = round(PASS_FACTOR * JAX_FINAL[run], 2)
                r["passes"] = res["mse"] <= r["pass_line"]
            elif seed in JAX_PEARCE:
                r["jax_reading"] = JAX_PEARCE[seed]
            out["runs"][f"{run}/seed{seed}"] = r
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
            print(f"{run} seed {seed}: final MSE {r['final_mse']:.4f}, best "
                  f"{r['best_mse']:.4f}; evals {evals}; step p50 "
                  f"{r['step_ms_p50']:.3f} ms, p90 {r['step_ms_p90']:.3f} "
                  f"ms; {r['seconds']:.0f} s"
                  + (f"; JAX {r['jax_final']}, pass line <= "
                     f"{r['pass_line']}: {'pass' if r['passes'] else 'MISS'}"
                     if "pass_line" in r else ""), flush=True)
    print(card)
    print(json.dumps({k: {kk: v for kk, v in r.items() if kk != "evals"}
                      for k, r in out["runs"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
