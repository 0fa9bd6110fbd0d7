"""Profile the PyTorch port's rotated-MNIST training step on a CUDA card.

    PYTHONPATH=. python3 tools/profile_torch_mnist_step.py [--steps 20] \
        [--elbo SVGPVAE_Hensman|VAE|CVAE|SVIGP_Hensman|GPVAE_Casale] \
        [--precision fp32|bf16] [--captured]

The north-star step of `svgpvae_tpu_torch.cli.mnist` (Hensman + GECO,
batch 256, L = 16, m = 32, the 36-digit synthetic set with its 800-object
GPLVM table, --gp_block_impl auto = fused_pallas on CUDA), or with --elbo
a baseline's step at the same widths (VAE and CVAE with --clip_qs; the
deep SVIGP with --PCA --ip_joint --GP_joint --ov_joint --clip_qs; a
Casale joint step with --GP_joint --ov_joint --clip_qs --PCA, the
full-train encode of 8,100 images included), built from the driver's
own pieces; --precision bf16 adds cli.mnist's --bf16 (SVGPVAE, VAE,
CVAE: the net in bfloat16, the GP in fp32).  After WARMUP steps it times
--steps steps on the host clock (each ended by torch.cuda.synchronize),
then runs --steps more under torch.profiler and prints:
  * the step time without and with the profiler;
  * the device's busy time per step (the union of the CUDA kernels'
    intervals, user annotations left out) and its idle share of the
    unprofiled step;
  * kernel launches per step, and the kernels that take the most device
    time (name, calls per step, device ms per step).
With --captured (SVGPVAE_Hensman) the steps are --epoch_chunk's: whole
epochs (31 full batches and the tail) replayed from captured CUDA graphs
by train.capture.GraphSteps, one epoch a chunk, each chunk ended by
torch.cuda.synchronize; after two chunks (the warm-ups and captures are
in the first) it times --steps chunks, then profiles --steps more, and a
step's time is its chunk's seconds over its steps.
TF32 is off, as in cli/mnist.py.  The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from quality_gate import PRECISION_FLAGS
from svgpvae_tpu_torch import data, models, train
from svgpvae_tpu_torch.cli import mnist
from svgpvae_tpu_torch.train import capture

ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs", "--PCA",
        "--ip_joint", "--GP_joint", "--ov_joint", "--dataset", "36",
        "--device", "cuda", "--seed", "0"]
BASELINE_ARGV = {  # the flags of tools/baselines_gate.py's runs
    "VAE": ["--elbo", "VAE", "--clip_qs"],
    "CVAE": ["--elbo", "CVAE", "--clip_qs"],
    "SVIGP_Hensman": ["--elbo", "SVIGP_Hensman", "--PCA", "--ip_joint",
                      "--GP_joint", "--ov_joint", "--clip_qs"],
    "GPVAE_Casale": ["--elbo", "GPVAE_Casale", "--GP_joint", "--ov_joint",
                     "--clip_qs", "--PCA"],
}


def build_step(elbo: str, splits: dict, device, extra=()):
    """(args, params, loss_fn, train split, noise generator) of one
    --elbo's training step, with cli.mnist's flags `extra` added."""
    if elbo == "SVGPVAE_Hensman":
        args = mnist.build_parser().parse_args(ARGV + list(extra))
        args.gp_block_impl = models.resolve_gp_block_impl(
            args.gp_block_impl, device=device)
    else:
        args = mnist.build_parser().parse_args(
            BASELINE_ARGV[elbo] + ["--dataset", "36", "--device", "cuda",
                                   "--seed", "0", *extra])
    eps = mnist.default_eps_fn(args.seed, device)
    n_train = len(splits["train"]["images"])
    if elbo == "SVIGP_Hensman":
        return (args, mnist.build_svigp(args, splits, n_train, device),
                mnist.make_svigp_loss_fn(),
                mnist.with_global_index(splits["train"]), None)
    if elbo == "GPVAE_Casale":
        train_d = mnist.sort_train_data(splits["train"])
        return (args, mnist.build_casale(args, splits, device),
                mnist.make_casale_loss_fn(
                    args, eps, mnist.casale_constants(train_d, device),
                    "joint"), train_d, eps.generator)
    vae, gp = mnist.build_model(args, splits, n_train, device)
    if gp is None:
        return (args, {"vae": vae}, mnist.make_vae_loss_fn(
            mnist.make_vae_forward(args, eps, cvae=elbo == "CVAE")),
            splits["train"], eps.generator)
    return (args, {"vae": vae, "gp": gp},
            mnist.make_loss_fn(args, mnist.make_forward(args, eps)),
            splits["train"], eps.generator)
WARMUP = 10


def busy_ms(events) -> float:
    """Union of the device kernels' [start, end) intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # us -> ms


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--elbo", default="SVGPVAE_Hensman",
                   choices=["SVGPVAE_Hensman", *BASELINE_ARGV])
    p.add_argument("--precision", choices=["fp32", "bf16"], default="fp32")
    p.add_argument("--captured", action="store_true",
                   help="--epoch_chunk's replayed CUDA graphs "
                        "(SVGPVAE_Hensman)")
    opts = p.parse_args()
    if opts.captured and opts.elbo != "SVGPVAE_Hensman":
        p.error("--captured takes --elbo SVGPVAE_Hensman")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    base = data.synthetic_digit_base_images("36", per_digit=400, seed=0)
    splits = data.generate_rotated_mnist(base, None, digits="36", seed=0)
    n_train = len(splits["train"]["images"])
    args, params, loss_fn, train_d, generator = build_step(
        opts.elbo, splits, device, PRECISION_FLAGS[opts.precision])
    trainable = train.trainable_tensors(params, lambda name: True)
    state = train.TrainState(params=params,
                             optimizer=train.make_optimizer(trainable,
                                                            args.lr),
                             geco=train.GECOState.init(device=device))
    im = torch.as_tensor(train_d["images"], dtype=torch.float32,
                         device=device)
    aux = torch.as_tensor(train_d["aux_data"], dtype=torch.float32,
                          device=device)
    bs = args.batch_size
    batches = [(im[i:i + bs], aux[i:i + bs])
               for i in range(0, n_train - bs + 1, bs)]

    graphs = (capture.GraphSteps(loss_fn, bs, [generator]) if opts.captured
              else None)
    per_call = -(-n_train // bs) if graphs else 1  # steps per timed call

    def call(i):
        if graphs:
            graphs.run(state, (im, aux), [None])
        else:
            train.train_step(state, batches[i % len(batches)], loss_fn)

    for i in range(2 if graphs else WARMUP):
        call(i)
    torch.cuda.synchronize()

    def steps(n):
        out = []
        for i in range(n):
            t0 = time.perf_counter()
            call(i)
            torch.cuda.synchronize()
            out += [1e3 * (time.perf_counter() - t0) / per_call] * per_call
        return out

    n = opts.steps
    plain = steps(n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = steps(n)
    n *= per_call
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy = busy_ms(kernels) / n
    p50 = float(np.median(plain))
    print(f"{opts.elbo} {opts.precision}"
          f"{' captured' if graphs else ''}: {n} steps (batch {bs}, L "
          f"{args.L}, m 32, "
          f"gp_block_impl {args.gp_block_impl}): host step p50 {p50:.3f} "
          f"ms (min "
          f"{min(plain):.3f}, max {max(plain):.3f}), under the profiler "
          f"p50 {float(np.median(profiled)):.3f} ms; device busy "
          f"{busy:.3f} ms per step, idle share {1 - busy / p50:.3f} of the "
          f"unprofiled p50; {len(kernels) / n:.1f} kernel launches per "
          f"step")
    by_name = {}
    for e in kernels:
        calls, dur = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, dur + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (calls, dur) in top:
        print(f"  {dur / 1e3 / n:8.4f} ms/step  {calls / n:5.1f} calls/step  "
              f"{name[:110]}")


if __name__ == "__main__":
    main()
