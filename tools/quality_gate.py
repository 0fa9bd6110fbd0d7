"""The port's quality gates: a JAX record configuration trained by the
port's driver on a CUDA card, one run per seed and precision, resumable
across calls.

    PYTHONPATH=. python3 tools/quality_gate.py [--gate sprites_titsias]
        [--seeds 0 1] [--epochs N] [--precisions fp32 bf16 bf16_hybrid]
        [--run_root DIR] [--resume_from DIR] [--out FILE]

The gates (`GATES`), each the JAX package's configuration less its TPU-only
flags, with the RECORDS band of RESULTS.md that the JAX driver reached on
the same synthetic data:

  * sprites_titsias: tools/tpu_round5.py::sprites_titsias_job (less
    --s2d64), 360 epochs; band 0.01416-0.01429 (RESULTS.md:17);
  * sprites_hensman: tools/tpu_round5.py::sprites_job (less --s2d64), 360
    epochs; band 0.01436-0.01538 (RESULTS.md:18).  At --epochs 30 it is
    the wave-3 precision configuration of tools/tpu_round3.py:194-203;
  * mnist_multidigit: tools/record_gate.py::mnist36_record_job less
    --epoch_chunk (which only changes dispatch), 200 epochs; band
    0.01933-0.02181 (RESULTS.md:16).

A best cgen MSE above the band's top + 5% is a miss.  The SPRITES corpus
(1000 characters, --corpus_seed 0) and the multi-digit set (digits 13679,
generated from seed 0, as the JAX record runs generated it once) are made
once in memory and every seed trains on them.  Each run goes through the
driver's `main` with the gate's flags, `--opt_regime joint-<epochs>
--seed <seed>`, its precision's flag (`PRECISION_FLAGS`) and `--save
--save_model_weights --base_dir <run_root>/<precision>/seed<seed>`, so
every eval pass leaves a checkpoint, and the gate appends that eval to
the run dir's gate_evals.json.  When a run dir already holds a checkpoint
at step s (a run cut by a time limit), the run continues with
`--resume_dir <run dir> --opt_regime joint-<epochs - s / steps per
epoch>` and no SPRITES pretraining, and the evals recorded up to step s
carry over.  When the run root of the earlier run is elsewhere (each run
in a fresh copy of the repository), pass it as --resume_from: each run's
directory is copied from there before continuing.  A finished run's cgen
image pickles are deleted (a SPRITES pair is ~28 MB).

Prints the card's name and power limit, then for each run the best cgen
MSE and the epoch it was read after, the cgen MSE after 30 and 90 epochs,
the step time p50/p90 of each call and its seconds, against the band;
with more than one precision, each precision's best over fp32's on the
same seed, against the gate's `pair_limit`.  The JSON file (--out) is
rewritten after each eval.
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
from typing import NamedTuple

import numpy as np

CHARS, CORPUS_SEED = 1000, 0
MNIST_DIGITS, MNIST_DATA_SEED = "13679", 0
EXPID = "gate"
SPRITES_RECORD = ["--clip_qs", "--synthetic", "--synthetic_chars",
                  str(CHARS), "--corpus_seed", str(CORPUS_SEED),
                  "--ip_joint", "--GPLVM_joint", "--PCA",
                  "--object_kernel_normalize", "--clip_grad",
                  "--eval_every", "5", "--nr_epochs_repr_nn", "40"]


class Gate(NamedTuple):
    driver: str          # "sprites" or "mnist"
    flags: list          # the bound and the configuration's flags
    epochs: int
    band: tuple          # the JAX RECORDS band of the best cgen MSE
    pair_limit: float    # a precision's best over fp32's, same seed

    @property
    def fail_above(self) -> float:
        return round(self.band[1] * 1.05, 5)


GATES = {
    "sprites_titsias": Gate("sprites", ["--elbo", "SVGPVAE_Titsias",
                                        *SPRITES_RECORD], 360,
                            (0.01416, 0.01429), 1.12),
    "sprites_hensman": Gate("sprites", ["--elbo", "SVGPVAE_Hensman",
                                        "--GECO", *SPRITES_RECORD], 360,
                            (0.01436, 0.01538), 1.12),
    "mnist_multidigit": Gate("mnist", [
        "--elbo", "SVGPVAE_Hensman", "--GECO", "--PCA", "--ip_joint",
        "--GP_joint", "--ov_joint", "--clip_qs", "--dataset", MNIST_DIGITS,
        "--synthetic_digits", "--kappa_squared", "0.016", "--eval_every",
        "5"], 200, (0.01933, 0.02181), 1.05),
}
PRECISION_FLAGS = {"fp32": [], "bf16": ["--bf16"],
                   "bf16_hybrid": ["--bf16_hybrid"]}


def gate_argv(gate: str, seed: int, epochs: int,
              precision: str = "fp32") -> list:
    """The trainer's argv of one run of `gate`."""
    return GATES[gate].flags + [
        "--opt_regime", f"joint-{epochs}", "--seed", str(seed),
        "--device", "cuda"] + PRECISION_FLAGS[precision]


def make_splits(driver: str):
    """The gate's data, in memory: the 1000-character SPRITES corpus or
    the multi-digit rotated-MNIST set."""
    from svgpvae_tpu_torch import data
    from svgpvae_tpu_torch.cli import sprites
    if driver == "sprites":
        return data.generate_synthetic_sprites(
            n_train_chars=CHARS, n_test_chars=max(2, CHARS // 4),
            n_frames_train=sprites.FRAMES_PER_CHAR, seed=CORPUS_SEED)
    base = data.synthetic_digit_base_images(MNIST_DIGITS, per_digit=400,
                                            seed=MNIST_DATA_SEED)
    return data.generate_rotated_mnist(base, None, digits=MNIST_DIGITS,
                                       seed=MNIST_DATA_SEED)


def steps_per_epoch(driver: str, splits) -> int:
    """Training steps per epoch at the drivers' default batch sizes (500
    frames, 256 images), the tail batch included."""
    if driver == "sprites":
        return -(-len(splits["train"]["frames"]) // 500)
    return -(-len(splits["train"]["images"]) // 256)


def find_run(run_root: str):
    """(run dir, latest checkpoint step) of a run, or (None, None)."""
    from svgpvae_tpu_torch import utils
    runs = sorted(glob.glob(os.path.join(run_root, EXPID, "*__on__*")))
    if not runs:
        return None, None
    return runs[-1], utils.latest_step(os.path.join(runs[-1], "ckpt"))


def summarize(gate: Gate, evals: list, calls: list) -> dict:
    at = {e["epochs_done"]: e["cgen_mse"] for e in evals}
    best = min(evals, key=lambda e: e["cgen_mse"])
    return {"best_cgen_mse": best["cgen_mse"],
            "best_after_epochs": best["epochs_done"],
            "cgen_after_30": at.get(30), "cgen_after_90": at.get(90),
            "final_cgen_mse": evals[-1]["cgen_mse"],
            "epochs_done": evals[-1]["epochs_done"],
            "in_record_band": gate.band[0] <= best["cgen_mse"]
            <= gate.band[1],
            "passes": best["cgen_mse"] <= gate.fail_above,
            "calls": calls, "evals": evals}


def pairs(gate: Gate, runs: dict) -> dict:
    """Each non-fp32 run's best over the fp32 best of its seed, and
    whether it is within the gate's pair_limit."""
    out = {}
    for key, r in runs.items():
        precision, seed = key.split("/")
        ref = runs.get(f"fp32/{seed}")
        if precision == "fp32" or ref is None:
            continue
        ratio = r["best_cgen_mse"] / ref["best_cgen_mse"]
        out[key] = {"over_fp32": ratio, "passes": ratio <= gate.pair_limit}
    return out


def run_one(gate_name: str, precision: str, seed: int, epochs: int,
            run_root: str, splits, write) -> None:
    """Train (or continue) one run; `write(key, evals, calls)` after each
    eval."""
    from svgpvae_tpu_torch.cli import mnist, sprites

    gate = GATES[gate_name]
    per_epoch = steps_per_epoch(gate.driver, splits)
    key = f"{precision}/seed{seed}"
    run_dir, step = find_run(run_root)
    log_path = None if run_dir is None else os.path.join(run_dir,
                                                         "gate_evals.json")
    record = {"evals": [], "calls": []}
    if step is not None:
        with open(log_path) as f:
            record = json.load(f)
        done = step // per_epoch
        record["evals"] = [e for e in record["evals"]
                           if e["epochs_done"] <= done]
        if done >= epochs:
            print(f"{key}: {done} epochs done already", flush=True)
            write(key, record["evals"], record["calls"])
            return
        argv = gate_argv(gate_name, seed, epochs - done, precision) + [
            "--resume_dir", run_dir, "--save_model_weights"]
        print(f"{key}: resuming {run_dir} after {done} epochs", flush=True)
    else:
        done = 0
        argv = gate_argv(gate_name, seed, epochs, precision) + [
            "--save", "--save_model_weights", "--base_dir", run_root,
            "--expid", EXPID]
    call = {"first_epoch": done, "resumed": step is not None}
    record["calls"].append(call)

    def on_eval(ev):
        nonlocal log_path
        if log_path is None:  # the run dir exists once main has begun
            log_path = os.path.join(find_run(run_root)[0],
                                    "gate_evals.json")
        record["evals"].append({"epochs_done": done + ev["epoch"] + 1,
                                "cgen_mse": ev["cgen_mse"],
                                "test_mse": ev["test_mse"]})
        with open(log_path, "w") as f:
            json.dump(record, f, indent=1)
        write(key, record["evals"], record["calls"])

    driver = sprites if gate.driver == "sprites" else mnist
    t = time.perf_counter()
    res = driver.main(argv, splits=splits, on_eval=on_eval)
    sec = np.asarray(res["step_seconds"][1:] or res["step_seconds"])
    call.update(steps=len(res["step_seconds"]),
                step_ms_p50=1e3 * float(np.percentile(sec, 50)),
                step_ms_p90=1e3 * float(np.percentile(sec, 90)),
                pretrain_seconds=(res.get("pretrain") or {}).get("seconds"),
                run_seconds=time.perf_counter() - t)
    with open(log_path, "w") as f:
        json.dump(record, f, indent=1)
    for pickled in glob.glob(os.path.join(res["run_dir"], "cgen_images*.p")):
        os.remove(pickled)
    write(key, record["evals"], record["calls"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--gate", choices=sorted(GATES), default="sprites_titsias")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--epochs", type=int, default=None,
                   help="the gate's own by default")
    p.add_argument("--precisions", nargs="+", default=["fp32"],
                   choices=sorted(PRECISION_FLAGS))
    p.add_argument("--run_root", default=None,
                   help="default chiprun_out/<gate>")
    p.add_argument("--resume_from", default=None,
                   help="a previous call's --run_root: each run's dir is "
                        "copied from there before continuing")
    p.add_argument("--out", default=None,
                   help="default chiprun_out/<gate>.json")
    args = p.parse_args(argv)
    gate = GATES[args.gate]
    if gate.driver == "mnist" and "bf16_hybrid" in args.precisions:
        raise SystemExit("--bf16_hybrid is a SPRITES flag")
    epochs = args.epochs or gate.epochs
    run_root = args.run_root or os.path.join("chiprun_out", args.gate)
    out_path = args.out or os.path.join("chiprun_out", f"{args.gate}.json")

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("quality_gate: no CUDA device")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    out = {"card": card, "torch": torch.__version__, "gate": args.gate,
           "epochs": epochs, "argv": gate_argv(args.gate, 0, epochs),
           "record_band": gate.band, "fail_above": gate.fail_above,
           "pair_limit": gate.pair_limit, "runs": {}, "pairs": {}}
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)

    def write(key, evals, calls):
        if evals:
            out["runs"][key] = summarize(gate, evals, calls)
            out["pairs"] = pairs(gate, out["runs"])
            with open(out_path, "w") as f:
                json.dump(out, f, indent=1)

    t0 = time.perf_counter()
    splits = make_splits(gate.driver)
    print(f"data generated in {time.perf_counter() - t0:.1f} s", flush=True)
    for seed in args.seeds:
        for precision in args.precisions:
            sub = os.path.join(precision, f"seed{seed}")
            root = os.path.join(run_root, sub)
            prev = (None if args.resume_from is None
                    else os.path.join(args.resume_from, sub))
            if prev and os.path.isdir(prev) and not os.path.isdir(root):
                shutil.copytree(prev, root)
            run_one(args.gate, precision, seed, epochs, root, splits, write)
            torch.cuda.empty_cache()
    print(card)
    for key, r in out["runs"].items():
        print(f"{args.gate} {key}: best cgen MSE {r['best_cgen_mse']:.6f} "
              f"after {r['best_after_epochs']} epochs of "
              f"{r['epochs_done']}; after 30: {r['cgen_after_30']}, after "
              f"90: {r['cgen_after_90']}; final {r['final_cgen_mse']:.6f}; "
              f"in the band {gate.band}: {r['in_record_band']}; passes "
              f"(<= {gate.fail_above}): {r['passes']}; calls "
              + "; ".join(
                  f"from epoch {c['first_epoch']}: step p50 "
                  f"{c.get('step_ms_p50', float('nan')):.3f} ms, p90 "
                  f"{c.get('step_ms_p90', float('nan')):.3f} ms, "
                  f"{c.get('run_seconds', float('nan')):.0f} s"
                  for c in r["calls"]))
    for key, pr in out["pairs"].items():
        print(f"{args.gate} {key}: best over fp32's {pr['over_fp32']:.4f} "
              f"(limit {gate.pair_limit}): passes {pr['passes']}")
    print(json.dumps({"runs": {k: {kk: v for kk, v in r.items()
                                   if kk != "evals"}
                               for k, r in out["runs"].items()},
                      "pairs": out["pairs"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
