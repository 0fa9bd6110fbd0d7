"""The SPRITES Titsias quality gate: the JAX package's record configuration
(tools/tpu_round5.py::sprites_titsias_job, less the TPU-only --s2d64)
trained by the port's driver on a CUDA card, one run per seed.

    PYTHONPATH=. python3 tools/sprites_titsias_gate.py [--seeds 0 1]
        [--epochs 360] [--out chiprun_out/sprites_titsias_gate.json]

The 1000-character synthetic corpus (--corpus_seed 0) is generated once
in memory, as the driver's --synthetic would write it, and each seed runs
`cli.sprites.main` with

    --elbo SVGPVAE_Titsias --clip_qs --synthetic --synthetic_chars 1000
    --corpus_seed 0 --ip_joint --GPLVM_joint --PCA
    --object_kernel_normalize --clip_grad --opt_regime joint-<epochs>
    --eval_every 5 --nr_epochs_repr_nn 40 --seed <seed>

Prints the card's name and power limit, then for each seed the best cgen
MSE and the epoch it was read after, the cgen MSE after 30 and 90 epochs,
the step time p50/p90 and the seconds of the run, against the JAX
package's RECORDS band (RESULTS.md, "SPRITES cgen (CURRENT binary,
stable family)": 0.01416-0.01429); a best above FAIL_ABOVE (the band's
top + 5%) is a miss.  The JSON file is rewritten after each seed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

RECORD_BAND = (0.01416, 0.01429)
FAIL_ABOVE = 0.0150
CHARS, CORPUS_SEED = 1000, 0


def gate_argv(seed: int, epochs: int) -> list:
    return ["--elbo", "SVGPVAE_Titsias", "--clip_qs", "--synthetic",
            "--synthetic_chars", str(CHARS), "--corpus_seed",
            str(CORPUS_SEED), "--ip_joint", "--GPLVM_joint", "--PCA",
            "--object_kernel_normalize", "--clip_grad", "--opt_regime",
            f"joint-{epochs}", "--eval_every", "5", "--nr_epochs_repr_nn",
            "40", "--seed", str(seed), "--device", "cuda"]


def summarize(res: dict, seconds: float) -> dict:
    evals = [{"epochs_done": ev["epoch"] + 1, "cgen_mse": ev["cgen_mse"],
              "test_mse": ev["test_mse"]} for ev in res["evals"]]
    at = {e["epochs_done"]: e["cgen_mse"] for e in evals}
    best = min(evals, key=lambda e: e["cgen_mse"])
    sec = np.asarray(res["step_seconds"][1:])
    return {"best_cgen_mse": best["cgen_mse"],
            "best_after_epochs": best["epochs_done"],
            "cgen_after_30": at.get(30), "cgen_after_90": at.get(90),
            "final_cgen_mse": evals[-1]["cgen_mse"],
            "in_record_band": RECORD_BAND[0] <= best["cgen_mse"]
            <= RECORD_BAND[1],
            "passes": best["cgen_mse"] <= FAIL_ABOVE,
            "steps": len(res["step_seconds"]),
            "step_ms_p50": 1e3 * float(np.percentile(sec, 50)),
            "step_ms_p90": 1e3 * float(np.percentile(sec, 90)),
            "pretrain_seconds": res["pretrain"]["seconds"],
            "run_seconds": seconds, "evals": evals}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--epochs", type=int, default=360)
    p.add_argument("--out", default="chiprun_out/sprites_titsias_gate.json")
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sprites_titsias_gate: no CUDA device")
    from svgpvae_tpu_torch import data
    from svgpvae_tpu_torch.cli import sprites

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    splits = data.generate_synthetic_sprites(
        n_train_chars=CHARS, n_test_chars=max(2, CHARS // 4),
        n_frames_train=sprites.FRAMES_PER_CHAR, seed=CORPUS_SEED)
    print(f"corpus generated in {time.perf_counter() - t0:.1f} s",
          flush=True)
    out = {"card": card, "torch": torch.__version__,
           "record_band": RECORD_BAND, "fail_above": FAIL_ABOVE, "runs": {}}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for seed in args.seeds:
        t = time.perf_counter()
        res = sprites.main(gate_argv(seed, args.epochs), splits=splits)
        out["runs"][str(seed)] = summarize(res, time.perf_counter() - t)
        del res
        torch.cuda.empty_cache()
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(card)
    for seed, r in out["runs"].items():
        print(f"seed {seed}: best cgen MSE {r['best_cgen_mse']:.6f} after "
              f"{r['best_after_epochs']} epochs; after 30: "
              f"{r['cgen_after_30']}, after 90: {r['cgen_after_90']}; final "
              f"{r['final_cgen_mse']:.6f}; step p50 {r['step_ms_p50']:.3f} "
              f"ms, p90 {r['step_ms_p90']:.3f} ms; {r['run_seconds']:.0f} s; "
              f"in the band {RECORD_BAND}: {r['in_record_band']}; passes "
              f"(<= {FAIL_ABOVE}): {r['passes']}")
    print(json.dumps({k: {kk: v for kk, v in r.items() if kk != "evals"}
                      for k, r in out["runs"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
