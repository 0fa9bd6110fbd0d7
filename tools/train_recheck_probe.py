"""chip_smoke.py's MNIST step recheck (phase 7's Hensman + GECO run, or
phase 11's Titsias run) several times on a CUDA card, run i from seed i:
how far the card's captured step sits from the CPU fp32 twin, against the
limit the recheck draws from the CPU's fp32-vs-f64 gap in two batch
orders (in order and reversed), in six (four seeded permutations more),
and in twelve (each of the six again with B1's Cholesky twin replaced by
the kernel's method, plain Gauss-Jordan: chip_smoke.train_cpu_steps).

    PYTHONPATH=. python3 tools/train_recheck_probe.py [--config titsias]
        [--runs 20]

Prints the card's name and power limit, then per run the loss's numbers
(card vs CPU fp32, the three gaps, the three limits) and the worst err/limit
over every value (the loss, the GECO state, each gradient) under each
rule; and the step redone eagerly on the card, on the CPU in fp32 and in
f64, with each part of the loss (PARTS) off its f64 value: which part
carries the card's round-off.  Last comes one JSON line with the runs'
loss rows.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402

# the forward pass's outputs the loss is assembled from
PARTS = ("recon_loss", "inside_elbo_recon", "inside_elbo_kl", "inside_elbo",
         "ce_term")
CONFIGS = {  # argv, phase_train's tag and B2 launches a step
    "hensman": (cs.TRAIN_ARGV, "train", None),
    "titsias": (cs.TITSIAS_ARGV, "mnist titsias train", 2)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", choices=sorted(CONFIGS), default="titsias")
    p.add_argument("--runs", type=int, default=20)
    args = p.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_recheck_probe: no CUDA device")
    from svgpvae_tpu_torch.ops import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(cs.gpu_name_and_power())
    _build.load()
    argv0, tag, b2 = CONFIGS[args.config]
    splits = cs.mnist_splits()
    rows = []
    for i in range(args.runs):
        argv = list(argv0)
        argv[argv.index("--seed") + 1] = str(i)
        res, _ = cs.phase_train(splits, argv, 32, cs.TRAIN_STEPS,
                                cs.CAPTURE_STEP, tag, b2)
        got, r32, r32_more, r64, terms = cs.train_cpu_steps(res, argv)
        parts = {}  # the loss's parts: card (eager), cpu fp32, cpu f64
        rargs = cs.mnist_recheck_args(argv)
        for name, dtype, device in (("card", torch.float32, "cuda"),
                                    ("cpu32", torch.float32, "cpu"),
                                    ("cpu64", torch.float64, "cpu")):
            vals, out, _ = cs.redo_mnist_step(res, rargs, dtype,
                                              device=device)
            images = res["captured"]["batch"][0].detach().cpu().double()
            parts[name] = {"loss": float(vals["loss"]), **{
                k: float(getattr(out, k).detach()) for k in PARTS},
                # the plain objective's recon term of these decoded
                # images, its sum taken in f64
                "recon_f64_sum": float(((images - out.recon_images.detach(
                ).cpu().double()) ** 2).sum() / images[0].numel())}
        for k in ("loss",) + PARTS + ("recon_f64_sum",):
            x64 = parts["cpu64"][k]
            print(f"run {i} part {k}: f64 {x64:.12g}; card (eager) off by "
                  f"{parts['card'][k] - x64:.3e}, cpu fp32 off by "
                  f"{parts['cpu32'][k] - x64:.3e}", flush=True)
        ratios = {}  # rule -> value -> (err / limit, gap, limit)
        names = list(r32_more)  # reversed, the seeded orders, Gauss-Jordan
        for rule, more in (
                ("two", names[:1]),
                ("six", names[:1 + cs.BASELINE_PERMUTATIONS]),
                ("twelve", names)):
            more = [r32_more[n] for n in more]
            ratios[rule] = {}
            for k, g in got.items():
                gap = max(float((r[k] - r64[k]).abs().max())
                          for r in [r32] + more)
                scale = terms if k == "loss" else float(r64[k].abs().max())
                limit = cs.hold_limit(k, gap, scale, cs.SUM_FLOOR)
                err = float((g.detach().cpu().double() - r32[k]).abs().max())
                ratios[rule][k] = (err / limit if limit else float(err > 0),
                                   gap, limit)
        worst = {rule: max(r.items(), key=lambda kv: kv[1][0])
                 for rule, r in ratios.items()}
        loss2, loss6, loss12 = (ratios[r]["loss"]
                                for r in ("two", "six", "twelve"))
        gj = float((r32_more["Gauss-Jordan in order"]["loss"]
                    - r64["loss"]).abs())
        err = float((got["loss"].detach().cpu().double()
                     - r32["loss"]).abs().max())
        err64 = float((got["loss"].detach().cpu().double()
                       - r64["loss"]).abs().max())
        row = dict(seed=i, loss=float(got["loss"]), err=err, card_vs_f64=err64,
                   gap_two=loss2[1], limit_two=loss2[2], gap_six=loss6[1],
                   limit_six=loss6[2], gauss_jordan_gap=gj,
                   gap_twelve=loss12[1], limit_twelve=loss12[2],
                   loss_terms=terms, **{
                       f"worst_{r}": [w[0], w[1][0]]
                       for r, w in worst.items()},
                   parts=parts)
        rows.append(row)
        print(f"run {i}: loss {row['loss']:.9g}: card vs cpu fp32 {err:.3e}, "
              f"card vs cpu f64 {err64:.3e}; gap over two orders "
              f"{loss2[1]:.3e} (limit {loss2[2]:.3e}, err/limit "
              f"{loss2[0]:.3f}), over six {loss6[1]:.3e} (limit "
              f"{loss6[2]:.3e}, err/limit {loss6[0]:.3f}), with the six "
              f"Gauss-Jordan runs {loss12[1]:.3e} (limit {loss12[2]:.3e}, "
              f"err/limit {loss12[0]:.3f}; Gauss-Jordan in order "
              f"{gj:.3e}); "
              f"worst over every value: " + ", ".join(
                  f"{r} {w[0]} {w[1][0]:.3f}" for r, w in worst.items()),
              flush=True)
    print(json.dumps({"config": args.config, "runs": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
