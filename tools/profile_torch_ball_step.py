"""Profile the PyTorch port's moving-ball training step on a CUDA card.

    PYTHONPATH=. python3 tools/profile_torch_ball_step.py \
        [--config hensman|titsias|pearce|np] [--steps 50]

The step of `svgpvae_tpu_torch.cli.ball` at the JAX driver's widths (35
videos of 30 32x32 frames, hidden 500, m = 15): `hensman` is
SVGPVAE_Hensman --clip_qs --entropy_ce and `titsias` SVGPVAE_Titsias
--clip_qs (both --gp_block_impl auto = fused_pallas on CUDA: one B1
launch per step), `pearce` the driver's default GPVAE_Pearce and `np`
the NP (exact GPs, no kernel of the port).  The step is the driver's:
a fresh video batch from the device generator, forward, backward, Adam.
After WARMUP steps it times --steps steps on the host clock (each ended by
torch.cuda.synchronize), then --steps more under torch.profiler, and
prints the step time without and with the profiler, the device's busy
time per step (the union of the CUDA kernels' intervals) and its idle
share of the unprofiled step, kernel launches per step, and the kernels
that take the most device time.  TF32 is off, as in cli/ball.py.  The
card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from profile_torch_mnist_step import busy_ms  # noqa: E402

from svgpvae_tpu_torch import data, models, train  # noqa: E402
from svgpvae_tpu_torch.cli import ball  # noqa: E402

CONFIGS = {
    "hensman": ["--elbo", "SVGPVAE_Hensman", "--clip_qs", "--entropy_ce"],
    "titsias": ["--elbo", "SVGPVAE_Titsias", "--clip_qs"],
    "pearce": ["--elbo", "GPVAE_Pearce"],
    "np": ["--elbo", "NP"],
}
WARMUP = 20


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", choices=list(CONFIGS), default="hensman")
    p.add_argument("--steps", type=int, default=50)
    opts = p.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    args = ball.build_parser().parse_args(
        CONFIGS[opts.config] + ["--device", "cuda", "--seed", "0",
                                "--base_dir", tempfile.mkdtemp()])
    args.gp_block_impl = models.resolve_gp_block_impl(
        args.gp_block_impl, workload="ball",
        titsias=args.elbo == "SVGPVAE_Titsias", device=device)
    params = ball.build_model(args, device)
    trainable = train.trainable_tensors(params,
                                        ball.trainable_predicate(args))
    state = train.TrainState(params=params,
                             optimizer=train.make_optimizer(trainable,
                                                            ball.LR),
                             geco=None)
    noise = ball.Noise(ball.default_eps_fn(0, device, ball.EVAL_SEED))
    loss_fn = ball.make_loss_fn(args, ball.make_forward(
        args, noise, ball.default_np_split_fn(noise, device),
        0.001 if args.elbo == "VAE" else args.modellt))
    video_fn = data.make_video_batch_fn(tmax=args.tmax, lt=args.vidlt,
                                        device=device, seed=1)

    def steps(n):
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            train.train_step(state, video_fn(), loss_fn)
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    steps(WARMUP)
    n = opts.steps
    plain = steps(n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = steps(n)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy = busy_ms(kernels) / n
    p50 = float(np.median(plain))
    print(f"{opts.config}: {n} steps (gp_block_impl {args.gp_block_impl}): "
          f"host step p50 {p50:.3f} ms (min {min(plain):.3f}, max "
          f"{max(plain):.3f}), under the profiler p50 "
          f"{float(np.median(profiled)):.3f} ms; device busy {busy:.3f} ms "
          f"per step, idle share {1 - busy / p50:.3f} of the unprofiled "
          f"p50; {len(kernels) / n:.1f} kernel launches per step")
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
