"""The SPRITES Titsias quality gate: the JAX package's record configuration
(tools/tpu_round5.py::sprites_titsias_job, less the TPU-only --s2d64)
trained by the port's driver on a CUDA card, one run per seed, resumable
across calls.

    PYTHONPATH=. python3 tools/sprites_titsias_gate.py [--seeds 0 1]
        [--epochs 360] [--run_root chiprun_out/sprites_titsias_gate]
        [--resume_from DIR] [--out chiprun_out/sprites_titsias_gate.json]

The 1000-character synthetic corpus (--corpus_seed 0) is generated once
in memory, as the driver's --synthetic would write it, and each seed runs
`cli.sprites.main` with

    --elbo SVGPVAE_Titsias --clip_qs --synthetic --synthetic_chars 1000
    --corpus_seed 0 --ip_joint --GPLVM_joint --PCA
    --object_kernel_normalize --clip_grad --opt_regime joint-<epochs>
    --eval_every 5 --nr_epochs_repr_nn 40 --seed <seed>
    --save --save_model_weights --base_dir <run_root>/seed<seed>

so every eval pass leaves a checkpoint in the seed's run dir, and the
gate appends that eval to the run dir's gate_evals.json.  When the
seed's run dir already holds a checkpoint at step s (a run cut by a
time limit), the seed continues with `--resume_dir <run dir> --opt_regime
joint-<epochs - s / 100>` (100 steps per epoch) and no pretraining, and
the evals recorded up to step s carry over.  When the run root of the
earlier run is elsewhere (each run in a fresh copy of the repository),
pass it as --resume_from: each seed's run dir is copied from there into
--run_root before continuing.

Prints the card's name and power limit, then for each seed the best cgen
MSE and the epoch it was read after, the cgen MSE after 30 and 90 epochs,
the step time p50/p90 of each call and its seconds, against the JAX
package's RECORDS band (RESULTS.md, "SPRITES cgen (CURRENT binary,
stable family)": 0.01416-0.01429); a best above FAIL_ABOVE (the band's
top + 5%) is a miss.  The JSON file is rewritten after each eval.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

RECORD_BAND = (0.01416, 0.01429)
FAIL_ABOVE = 0.0150
CHARS, CORPUS_SEED = 1000, 0
STEPS_PER_EPOCH = 100  # 50,000 train frames / batch 500
EXPID = "gate"


def gate_argv(seed: int, epochs: int) -> list:
    return ["--elbo", "SVGPVAE_Titsias", "--clip_qs", "--synthetic",
            "--synthetic_chars", str(CHARS), "--corpus_seed",
            str(CORPUS_SEED), "--ip_joint", "--GPLVM_joint", "--PCA",
            "--object_kernel_normalize", "--clip_grad", "--opt_regime",
            f"joint-{epochs}", "--eval_every", "5", "--nr_epochs_repr_nn",
            "40", "--seed", str(seed), "--device", "cuda"]


def find_run(seed_root: str):
    """(run dir, latest checkpoint step) of a seed, or (None, None)."""
    from svgpvae_tpu_torch import utils
    runs = sorted(glob.glob(os.path.join(seed_root, EXPID, "*__on__*")))
    if not runs:
        return None, None
    return runs[-1], utils.latest_step(os.path.join(runs[-1], "ckpt"))


def summarize(evals: list, calls: list) -> dict:
    at = {e["epochs_done"]: e["cgen_mse"] for e in evals}
    best = min(evals, key=lambda e: e["cgen_mse"])
    return {"best_cgen_mse": best["cgen_mse"],
            "best_after_epochs": best["epochs_done"],
            "cgen_after_30": at.get(30), "cgen_after_90": at.get(90),
            "final_cgen_mse": evals[-1]["cgen_mse"],
            "epochs_done": evals[-1]["epochs_done"],
            "in_record_band": RECORD_BAND[0] <= best["cgen_mse"]
            <= RECORD_BAND[1],
            "passes": best["cgen_mse"] <= FAIL_ABOVE,
            "calls": calls, "evals": evals}


def run_seed(seed: int, epochs: int, seed_root: str, splits, write) -> None:
    """Train (or continue) one seed; `write(seed, evals, calls)` after
    each eval."""
    from svgpvae_tpu_torch.cli import sprites

    run_dir, step = find_run(seed_root)
    log_path = None if run_dir is None else os.path.join(run_dir,
                                                         "gate_evals.json")
    record = {"evals": [], "calls": []}
    if step is not None:
        with open(log_path) as f:
            record = json.load(f)
        done = step // STEPS_PER_EPOCH
        record["evals"] = [e for e in record["evals"]
                           if e["epochs_done"] <= done]
        if done >= epochs:
            print(f"seed {seed}: {done} epochs done already", flush=True)
            write(seed, record["evals"], record["calls"])
            return
        argv = gate_argv(seed, epochs - done) + [
            "--resume_dir", run_dir, "--save_model_weights"]
        print(f"seed {seed}: resuming {run_dir} after {done} epochs",
              flush=True)
    else:
        done = 0
        argv = gate_argv(seed, epochs) + [
            "--save", "--save_model_weights", "--base_dir", seed_root,
            "--expid", EXPID]
    call = {"first_epoch": done, "resumed": step is not None}
    record["calls"].append(call)

    def on_eval(ev):
        nonlocal log_path
        if log_path is None:  # the run dir exists once main has begun
            log_path = os.path.join(find_run(seed_root)[0],
                                    "gate_evals.json")
        record["evals"].append({"epochs_done": done + ev["epoch"] + 1,
                                "cgen_mse": ev["cgen_mse"],
                                "test_mse": ev["test_mse"]})
        with open(log_path, "w") as f:
            json.dump(record, f, indent=1)
        write(seed, record["evals"], record["calls"])

    t = time.perf_counter()
    res = sprites.main(argv, splits=splits, on_eval=on_eval)
    sec = np.asarray(res["step_seconds"][1:])
    call.update(steps=len(res["step_seconds"]),
                step_ms_p50=1e3 * float(np.percentile(sec, 50)),
                step_ms_p90=1e3 * float(np.percentile(sec, 90)),
                pretrain_seconds=(res["pretrain"] or {}).get("seconds"),
                run_seconds=time.perf_counter() - t)
    with open(log_path, "w") as f:
        json.dump(record, f, indent=1)
    write(seed, record["evals"], record["calls"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--epochs", type=int, default=360)
    p.add_argument("--run_root", default="chiprun_out/sprites_titsias_gate")
    p.add_argument("--resume_from", default=None,
                   help="a previous call's --run_root: each seed's run dir "
                        "is copied from there before continuing")
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
    out = {"card": card, "torch": torch.__version__,
           "record_band": RECORD_BAND, "fail_above": FAIL_ABOVE, "runs": {}}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    def write(seed, evals, calls):
        if evals:
            out["runs"][str(seed)] = summarize(evals, calls)
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)

    t0 = time.perf_counter()
    splits = data.generate_synthetic_sprites(
        n_train_chars=CHARS, n_test_chars=max(2, CHARS // 4),
        n_frames_train=sprites.FRAMES_PER_CHAR, seed=CORPUS_SEED)
    print(f"corpus generated in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for seed in args.seeds:
        seed_root = os.path.join(args.run_root, f"seed{seed}")
        prev = (None if args.resume_from is None
                else os.path.join(args.resume_from, f"seed{seed}"))
        if prev and os.path.isdir(prev) and not os.path.isdir(seed_root):
            shutil.copytree(prev, seed_root)
        run_seed(seed, args.epochs, seed_root, splits, write)
        torch.cuda.empty_cache()
    print(card)
    for seed, r in out["runs"].items():
        print(f"seed {seed}: best cgen MSE {r['best_cgen_mse']:.6f} after "
              f"{r['best_after_epochs']} epochs of {r['epochs_done']}; "
              f"after 30: {r['cgen_after_30']}, after 90: "
              f"{r['cgen_after_90']}; final {r['final_cgen_mse']:.6f}; "
              f"in the band {RECORD_BAND}: {r['in_record_band']}; passes "
              f"(<= {FAIL_ABOVE}): {r['passes']}; calls "
              + "; ".join(
                  f"from epoch {c['first_epoch']}: step p50 "
                  f"{c.get('step_ms_p50', float('nan')):.3f} ms, p90 "
                  f"{c.get('step_ms_p90', float('nan')):.3f} ms, "
                  f"{c.get('run_seconds', float('nan')):.0f} s"
                  for c in r["calls"]))
    print(json.dumps({k: {kk: v for kk, v in r.items() if kk != "evals"}
                      for k, r in out["runs"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
