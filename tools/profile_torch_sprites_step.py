"""Profile the PyTorch port's SPRITES training step on a CUDA card.

    PYTHONPATH=. python3 tools/profile_torch_sprites_step.py [--steps 20]
        [--chars 1000] [--config hensman|hensman_record|titsias_record|vae]
        [--precision fp32|bf16|bf16_hybrid] [--gp_block_impl IMPL]

The step of `svgpvae_tpu_torch.cli.sprites` at the JAX CLI's defaults
(Hensman + GECO, batch 500 = 10 characters x 50 frames, L = 64,
L_action = 8, L_character = 16, 72 inducing points, the vae and repr
tensors trainable; --gp_block_impl auto = fused_rejitter_pallas on CUDA),
or with the record configuration's flags (--ip_joint --GPLVM_joint
--PCA --object_kernel_normalize --clip_grad) on Hensman + GECO or on
Titsias without GECO (auto = fused), or the plain VAE (--elbo VAE
--clip_qs: the SpritesVAE alone), on the synthetic corpus of --chars
characters, built from the CLI's
own pieces (no pretraining: it does not change the step's work).
--precision bf16 or bf16_hybrid adds the CLI's --bf16 or --bf16_hybrid
(the nets in bfloat16, the hybrid's VAE heads in fp32; the GP in fp32).
After WARMUP steps it times --steps steps on the host clock (each ended by
torch.cuda.synchronize), then runs --steps more under torch.profiler and
prints:
  * the step time without and with the profiler;
  * the device's busy time per step (the union of the CUDA kernels'
    intervals, user annotations left out) and its idle share of the
    unprofiled step;
  * kernel launches per step (all, and the port's kernels by the
    wrappers' counters), and the kernels that take the most device time
    (name, calls per step, device ms per step), with the port's kernels
    (gauss_jordan_*, stats_*, build_k_kernel) listed whatever their
    rank;
  * the device time of B1's and B2's autograd backwards (matmuls and
    einsums): B1's second call per step, on A_hat, feeds only its logdet,
    so its backward multiplies by a zero gradient of the inverse.
TF32 is off, as in cli/sprites.py.  The card's name and power limit come
first.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from profile_torch_mnist_step import busy_ms
from quality_gate import PRECISION_FLAGS
from svgpvae_tpu_torch import data, models, ops, train
from svgpvae_tpu_torch.cli import mnist, sprites

ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs", "--device",
        "cuda", "--seed", "0"]
RECORD_FLAGS = ["--ip_joint", "--GPLVM_joint", "--PCA",
                "--object_kernel_normalize", "--clip_grad"]
CONFIGS = {"hensman": ARGV, "hensman_record": ARGV + RECORD_FLAGS,
           "titsias_record": ["--elbo", "SVGPVAE_Titsias"] + [
               a for a in ARGV[2:] if a != "--GECO"] + RECORD_FLAGS,
           "vae": ["--elbo", "VAE"] + ARGV[3:]}
WARMUP = 10
OWN = ("gauss_jordan", "stats_", "build_k_kernel")  # the port's kernels


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--chars", type=int, default=1000)
    p.add_argument("--config", choices=list(CONFIGS), default="hensman")
    p.add_argument("--precision", choices=list(PRECISION_FLAGS),
                   default="fp32")
    p.add_argument("--gp_block_impl", default="auto")
    opts = p.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")

    args = sprites.build_parser().parse_args(
        CONFIGS[opts.config] + PRECISION_FLAGS[opts.precision]
        + ["--gp_block_impl", opts.gp_block_impl])
    vae_only = args.elbo == "VAE"
    if not vae_only:
        args.gp_block_impl = models.resolve_gp_block_impl(
            args.gp_block_impl, workload="sprites",
            titsias=args.elbo == "SVGPVAE_Titsias", device=device)
    splits = data.generate_synthetic_sprites(
        n_train_chars=opts.chars, n_test_chars=max(2, opts.chars // 4),
        n_frames_train=sprites.FRAMES_PER_CHAR, seed=args.corpus_seed)
    n_train = len(splits["train"]["frames"])
    params, _ = sprites.build_model(args, splits, n_train, device)
    trainable = train.trainable_tensors(params,
                                        sprites.trainable_predicate(args))
    state = train.TrainState(params=params,
                             optimizer=train.make_optimizer(trainable,
                                                            args.lr),
                             geco=train.GECOState.init(device=device),
                             clip_grad_value=args.clip_grad_thres
                             if args.clip_grad else None)
    eps = mnist.default_eps_fn(args.seed, device)
    loss_fn = (sprites.make_vae_loss_fn(sprites.make_vae_forward(args, eps))
               if vae_only else
               sprites.make_loss_fn(args, sprites.make_forward(args, eps)))
    frames = torch.as_tensor(splits["train"]["frames"], device=device)
    aids = torch.as_tensor(splits["train"]["aux_data"][:, 1], device=device)
    bs = args.batch_size
    batches = [(frames[i:i + bs], aids[i:i + bs])
               for i in range(0, n_train - bs + 1, bs)]

    for i in range(WARMUP):
        train.train_step(state, batches[i % len(batches)], loss_fn)
    torch.cuda.synchronize()

    def steps(n):
        out = []
        for i in range(n):
            t0 = time.perf_counter()
            train.train_step(state, batches[i % len(batches)], loss_fn)
            torch.cuda.synchronize()
            out.append(1e3 * (time.perf_counter() - t0))
        return out

    n = opts.steps
    ops.reset_launch_counts()
    plain = steps(n)
    own = {k: v / n for k, v in ops.launch_counts().items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled = steps(n)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    busy = busy_ms(kernels) / n
    p50 = float(np.median(plain))
    print(f"{opts.config} {opts.precision}: {n} steps (batch {bs}, L "
          f"{args.L}, m 72, "
          f"gp_block_impl "
          f"{args.gp_block_impl}, N_train {n_train}): host step p50 "
          f"{p50:.3f} ms (min {min(plain):.3f}, max {max(plain):.3f}), "
          f"under the profiler p50 {float(np.median(profiled)):.3f} ms; "
          f"device busy {busy:.3f} ms per step, idle share "
          f"{1 - busy / p50:.3f} of the unprofiled p50; "
          f"{len(kernels) / n:.1f} kernel launches per step, of the port's "
          f"kernels {own}")
    by_name = {}
    for e in kernels:
        calls, dur = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, dur + e.time_range.elapsed_us())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    shown = ranked[:15] + [kv for kv in ranked[15:]
                           if any(o in kv[0] for o in OWN)]
    for name, (calls, dur) in shown:
        print(f"  {dur / 1e3 / n:8.4f} ms/step  {calls / n:5.1f} calls/step  "
              f"{name[:110]}")
    # the kernels' autograd backwards (einsums and matmuls, no kernel of
    # the port's): device time of everything each launched
    for ev in prof.key_averages():
        if ev.key in ("_CholInverseBackward", "_GPStatsBackward",
                      "LinalgCholeskyExBackward0", "CholeskySolveBackward0"):
            print(f"  {ev.device_time_total / 1e3 / n:8.4f} ms/step  "
                  f"{ev.count / n:5.1f} calls/step  {ev.key} (device time "
                  "of its kernels)")


if __name__ == "__main__":
    main()
