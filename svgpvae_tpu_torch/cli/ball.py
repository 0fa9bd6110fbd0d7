"""Moving-ball experiment with the PyTorch port.

    python -m svgpvae_tpu_torch.cli.ball --elbo VAE --steps 60 \
        --eval_every 30 --device cpu                       (setup check)
    python -m svgpvae_tpu_torch.cli.ball --elbo SVGPVAE_Hensman --clip_qs

The flow of svgpvae_tpu/cli/ball.py::run_experiment for every --elbo
(GPVAE_Pearce, VAE, NP, SVGPVAE_Hensman, SVGPVAE_Titsias): batches of 35
videos of --tmax 32x32 frames (a ball of radius 3 on a GP path), fresh
videos every step from a torch.Generator on the device (`data.ball`), a
tanh-MLP encoder and decoder (hidden 500), Adam at 1e-3 (optionally
cosine-decayed, --lr_decay; value clip 1e5 with --clip_grad), and every
--eval_every steps the ELBO terms and the trajectory MSE (`mse_rotation`
of the posterior means against the true paths) on the first of the ten
fixed test batches (seeds 0..9, cached as a pickle in --base_dir).

SVGPVAE ELBOs run the per-video SVGP over times 1..T (m = --m inducing
points per channel, absolute --jitter): with --gp_block_impl
fused_pallas (the 'auto' choice on a CUDA device) one B1 `chol_inverse`
launch per step on the flat stack [K_mm; Sigma_1..35] of both channels,
(72, 15, 15) at the defaults, and under SVGPVAE_Titsias on [K_mm;
Sigma; Sigma1], (142, 15, 15).  'auto' is `reference` (Hensman) and
`fused` (Titsias) on the CPU, as in the JAX table.  Inducing points train
under --ip_joint and length scales under --GP_joint.  The Pearce, NP and
VAE ELBOs run exact GPs over times 0..T-1 (a batched Cholesky, no
kernel of the port), with per-channel length scales trained under
--GP_joint.

Weights come from flax's initialisation drawn from a torch.Generator
seeded by --seed (0 when unset), or from --params (an .npz of flat JAX
parameters, utils.convert.ball_params_from_jax).  The training noise
(and the NP's context draws) continue one generator seeded by --seed;
the eval pass draws from generators seeded with 99 (the JAX driver's
eval key) and 100 (the NP split); the videos from a generator seeded
with 1234 (or --seed + 1), the JAX driver's data key.  TF32 is off.

Run outputs: --save makes the run dir (args.json), every eval appends to
res/ELBO_results.csv and, for the SVGPVAE, res/GP_params.csv (the JAX
columns); every --ckpt_every steps and at the end a checkpoint (the
TrainState, the noise and video generators) under ckpt/ and the eval
batch's predictions in preds/preds_<step>.p; every --plot_every steps
the latent pictures, drawn with numpy alone (utils.plots, no
matplotlib): pics/<step:06d>.png (plot_latents: the eval batch's first
four videos, true and aligned paths with their covariance ellipses,
the reconstructions) from one more eval pass, and under
--squares_circles pics/<step:06d>_circles.png and _squares.png, the
latent-geometry probes: the probe video (data.make_circles /
make_squares) tiled to the batch, run through the eval forward (the
SVGPVAE: one B1 launch each) and its first video's encoder means
aligned with that eval pass's mse_rotation W.  The pictures are drawn
on the host after the eval passes, outside the step timings.
--resume_dir <run dir> continues from its latest checkpoint.  At every
eval the batch-mean ELBO goes through utils.check_finite: on NaN/inf
the current state goes
to <run dir>/ckpt_nan/<step>.pt (a diagnostic, not a resume point) and
utils.NonFiniteLossError is raised.

The loop runs the JAX driver's chunks: `chunk_steps`, the largest
divisor of gcd(--eval_every, --plot_every, --ckpt_every) up to 500,
steps at a time (the last chunk may be shorter), and the evals, pictures
and checkpoints at chunk ends.  On a CUDA device in a 1-process run a
chunk replays one captured CUDA graph of draw -> step per step
(train.make_generative_chunk_fn, train.capture.GenerativeSteps: the
videos, the noise and the NP's split drawn on the card from generators
registered with the graph; the first two steps of the run eager, Adam
capturable, so the run sits within round-off of a per-step one), with one
readback a chunk; a step's seconds are its chunk's over its steps, and
the first chunk is left out of the p50, as the JAX driver leaves out its
compile.  Elsewhere the steps run one by one, and the run prints why:
the CPU, --data_parallel (over gloo, which stages its all-reduces
through the host; over NCCL because the ball's batch of 35 videos tiles
5 or 7 ranks, so its graphs across ranks have no check on 2 or 4 cards),
a capture_step, an injected eps_fn, video_fn or NP np_split_fn without a
generator, or main(per_step=True).
--profile_dir DIR writes a torch.profiler Chrome trace into DIR of the
JAX driver's second chunk (steps start + chunk to start + 2 chunk, when
they are all to run): its replays, or its steps, in "train_step"
ranges.
--data_parallel N (0 off, -1 every visible device; N must divide the
batch of 35 videos): N ranks, one process each.  Every rank generates
the whole batch of videos and draws the global batch's noise (and the
NP's split) from the run's generators, then takes its contiguous share
of the videos (JAX pins the generated batch to the data axis); the
per-video ELBOs are averaged over the global batch (parallel.mean_rows)
and the gradients summed across ranks, so every rank takes the
1-process step.  The eval passes (the pictures' and the probes' too)
run replicated; only rank 0 writes the run dir, draws and prints.
--show_pics is accepted and ignored, as by the JAX driver.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import pickle
import time
from typing import Callable, Optional

import numpy as np
import torch

from svgpvae_tpu_torch import (data, gp as gpm, models, ops, parallel,
                               train, utils)
from svgpvae_tpu_torch.cli.mnist import (Noise, default_eps_fn, sync,
                                         uncaptured_reason)
from svgpvae_tpu_torch.nn import BallDecoder, BallEncoder
from svgpvae_tpu_torch.train import capture
from svgpvae_tpu_torch.utils import plots
from svgpvae_tpu_torch.utils.convert import ball_params_from_jax

BATCH, PX, PY, RADIUS = 35, 32, 32, 3.0
EVAL_SEED = 99        # the JAX driver's eval key, jax.random.PRNGKey(99)
EVAL_SPLIT_SEED = 100
LR = 1e-3
CLIP_GRAD_VALUE = 1e5
PROBES = {"circles": data.make_circles, "squares": data.make_squares}


def build_parser() -> argparse.ArgumentParser:
    """The JAX driver's arguments (same names and defaults), plus --device
    and --params."""
    p = argparse.ArgumentParser(description="Moving ball experiment "
                                            "(PyTorch port)")
    p.add_argument("--steps", type=int, default=25000)
    p.add_argument("--lr_decay", type=float, default=None,
                   help="cosine-decay the lr to lr*LR_DECAY over --steps")
    p.add_argument("--beta0", type=float, default=1.0)
    p.add_argument("--elbo", type=str, default="GPVAE_Pearce",
                   choices=["GPVAE_Pearce", "VAE", "NP", "SVGPVAE_Hensman",
                            "SVGPVAE_Titsias"])
    p.add_argument("--modellt", type=float, default=2.0)
    p.add_argument("--base_dir", type=str, default=os.getcwd())
    p.add_argument("--expid", type=str, default="debug")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--tmax", type=int, default=30)
    p.add_argument("--m", type=int, default=15)
    p.add_argument("--GP_joint", action="store_true")
    p.add_argument("--ip_joint", action="store_true")
    p.add_argument("--clip_qs", action="store_true")
    p.add_argument("--show_pics", action="store_true", help="unused")
    p.add_argument("--save", action="store_true")
    p.add_argument("--squares_circles", action="store_true")
    p.add_argument("--ip_min", type=float, default=1.0)
    p.add_argument("--ip_max", type=float, default=30.0)
    p.add_argument("--jitter", type=float, default=1e-9)
    p.add_argument("--gp_block_impl", type=str, default="auto",
                   choices=["reference", "fused", "fused_pallas", "auto"],
                   help="SVGPVAE GP block: two-pass reference, fused "
                        "(Cholesky), fused_pallas (chol_inverse: B1 on a "
                        "CUDA device, its twin on the CPU), or auto")
    p.add_argument("--titsias_reference_ce", action="store_true",
                   help="Titsias: the reference's encoder cross-entropy CE "
                        "term in place of the exact entropy (PARITY.md #13)")
    p.add_argument("--entropy_ce", action="store_true",
                   help="the exact sampling-distribution entropy CE term "
                        "for any ELBO")
    p.add_argument("--clip_grad", action="store_true")
    p.add_argument("--vidlt", type=float, default=2.0)
    p.add_argument("--GP_init", type=float, default=2.0)
    p.add_argument("--full_cholesky", action="store_true",
                   help="encoder emits per-frame full-Cholesky rows; the "
                        "ELBOs consume their marginal variances")
    p.add_argument("--eval_every", type=int, default=1000)
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--plot_every", type=int, default=10000)
    p.add_argument("--ckpt_every", type=int, default=50000)
    p.add_argument("--resume_dir", type=str, default=None)
    p.add_argument("--data_parallel", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--params", type=str, default=None,
                   help=".npz of flat JAX ball parameters to start from")
    return p


def load_test_batches(args) -> list:
    """The ten fixed test batches, from the pickle cache in --base_dir
    (written on first use, in the JAX driver's format and name)."""
    cache = os.path.join(args.base_dir,
                         f"Test_Batches_{args.vidlt}_{args.tmax}.pkl")
    if os.path.isfile(cache):
        with open(cache, "rb") as f:
            return pickle.load(f)
    batches = data.make_test_batches(10, tmax=args.tmax, px=PX, py=PY,
                                     lt=args.vidlt, batch=BATCH, r=RADIUS)
    if parallel.is_writer():  # the other ranks of a data-parallel run
        os.makedirs(args.base_dir, exist_ok=True)  # generate theirs alike
        tmp = f"{cache}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(batches, f)
        os.replace(tmp, cache)  # never a half-written cache
    return batches


def build_model(args, device: torch.device) -> dict:
    """{"enc", "dec"[, "gp"]} on `device`: flax's init from a generator
    seeded by --seed, or --params; the SVGPVAE's BallSVGP (a linspace
    inducing grid), or Pearce's length scales under --GP_joint."""
    gen = torch.Generator().manual_seed(0 if args.seed is None
                                        else args.seed)
    params = {"enc": BallEncoder(tmax=args.tmax, px=PX, py=PY,
                                 full_cholesky=args.full_cholesky,
                                 generator=gen),
              "dec": BallDecoder(px=PX, py=PY, generator=gen)}
    if "SVGPVAE" in args.elbo:
        cfg = gpm.SVGPConfig(titsias=args.elbo == "SVGPVAE_Titsias",
                             jitter=args.jitter)
        params["gp"] = gpm.init_ball_svgp(
            args.m, tmin=args.ip_min if args.ip_joint else 1.0,
            tmax=args.ip_max if args.ip_joint else float(args.tmax),
            length_scale_init=args.GP_init if args.GP_joint else args.vidlt,
            config=cfg)
    elif args.GP_joint and args.elbo != "VAE":
        params["gp"] = gpm.PearceLengthScales(
            length_scale_x=torch.tensor(args.GP_init),
            length_scale_y=torch.tensor(args.GP_init))
    if args.params:
        with np.load(args.params) as z:
            port = ball_params_from_jax(dict(z))
        params["enc"].load_state_dict(port["enc"])
        params["dec"].load_state_dict(port["dec"])
        if ("gp" in port) != ("gp" in params):
            raise ValueError("--params and --elbo/--GP_joint disagree on the "
                             "GP parameters")
        if "gp" in port:
            params["gp"] = dataclasses.replace(params["gp"], **port["gp"])
    return {k: v.to(device) for k, v in params.items()}


def trainable_predicate(args) -> Callable[[str], bool]:
    """As the JAX driver's mask, which only the SVGPVAE ELBOs apply:
    inducing points under --ip_joint, length scales under --GP_joint; the
    nets (and Pearce's length scales) always train."""
    svgpvae = "SVGPVAE" in args.elbo

    def predicate(name: str) -> bool:
        if svgpvae and "inducing_points" in name:
            return args.ip_joint
        if svgpvae and "length_scale" in name:
            return args.GP_joint
        return True

    return predicate


def open_run_dir(args) -> Optional[str]:
    if not parallel.is_writer():  # rank 0 of a data-parallel run writes
        return None
    if args.resume_dir:
        print(f"resuming into: {args.resume_dir}")
        return args.resume_dir
    if not args.save:
        return None
    run_dir = utils.make_checkpoint_folder(args.base_dir, args.expid,
                                           f"{args.elbo}_{args.beta0}")
    utils.dump_args(run_dir, args)
    print(f"checkpoint dir: {run_dir}")
    return run_dir


def default_np_split_fn(noise: Noise, device: torch.device) -> Callable:
    """np_split_fn(kind, batch, tmax): "train" draws continue the training
    noise generator, each "eval" draw a generator seeded with
    EVAL_SPLIT_SEED."""
    def split_fn(kind, batch, tmax):
        gen = noise.generator if kind == "train" else torch.Generator(
            device=device).manual_seed(EVAL_SPLIT_SEED)
        return models.draw_np_split(batch, tmax, gen, device)
    return split_fn


def make_forward(args, noise: Callable, np_split_fn: Callable,
                 model_lt: float) -> Callable:
    """forward(params, vids, kind, beta) -> BallOutputs with this run's
    options, eps from noise(kind, (b, T, 2)) and, for the NP,
    np_split_fn(kind, b, T)."""
    def forward(params, vids, kind, beta):
        b, t = vids.shape[:2]
        eps = noise(kind, (b, t, 2))
        if "SVGPVAE" in args.elbo:
            return models.ball_svgpvae_elbo(
                params["enc"], params["dec"], params["gp"], vids, beta, eps,
                clip_qs=args.clip_qs, gp_block_impl=args.gp_block_impl,
                titsias_reference_ce=args.titsias_reference_ce,
                entropy_ce=args.entropy_ce)
        gp = params.get("gp")
        ls = model_lt if gp is None else (gp.length_scale_x,
                                          gp.length_scale_y)
        split = None
        if args.elbo == "NP":  # the global batch's draw, this rank's rows
            n_ctx, perm = np_split_fn(kind, parallel.global_rows(b), t)
            split = (n_ctx, parallel.local_rows(perm))
        return models.pearce_elbo(
            params["enc"], params["dec"], vids, beta, eps, ls,
            elbo_type=args.elbo, context_length_scale=model_lt,
            entropy_ce=args.entropy_ce, split=split)
    return forward


def make_loss_fn(args, forward: Callable) -> Callable:
    """loss_fn(params, vids, geco, step) -> (-mean ELBO, (None, metrics))
    for train.train_step; the means are over the global batch
    (data-parallel: parallel.mean_rows)."""
    def loss_fn(params, vids, geco, step):
        out = forward(params, vids, "train", args.beta0)
        elbo = parallel.mean_rows(out.elbo)
        metrics = {"elbo": elbo.detach(),
                   "recon": parallel.mean_rows(out.recon).detach(),
                   "prior_kl": parallel.mean_rows(out.prior_kl).detach()}
        return -elbo, (None, metrics)
    return loss_fn


ELBO_COLUMNS = ["step", "loss", "elbo", "recon", "prior_kl", "min_qv",
                "max_qv", "min_pv", "max_pv", "inside_elbo", "ce_term",
                "MSE", "beta", "time"]
GP_COLUMNS = ["step", "length_scale", "ip_norm", "inducing_points"]


def main(argv=None, video_fn: Optional[Callable] = None,
         eps_fn: Optional[Callable] = None,
         np_split_fn: Optional[Callable] = None,
         capture_step: Optional[int] = None,
         per_step: bool = False) -> dict:
    """Train; returns {"mse" (the last eval's), "steps_per_sec",
    "step_p50_ms", "step_p90_ms" (host clock after synchronize, the first
    step, or with graphs the first chunk, left out), "state", "launches"
    (the run's kernel launches), "step_seconds", "metrics",
    "step_launches" (per step), "chunks" (each chunk's steps and
    seconds), "graph_replays", "graph_launches" (the captured graph's
    replays and the launches of one), "evals",
    "pictures" (draw_pictures' record of each --plot_every step under
    --save or --resume_dir), "captured", "run_dir", "noise", "video_fn"}.

    `video_fn()` -> (35, T, 32, 32) replaces the video generator,
    `eps_fn(kind, shape)` ("train"/"eval") the noise and
    `np_split_fn(kind, batch, T)` -> (n_ctx, perm) the NP's draws (tests
    inject the JAX driver's).  `capture_step` keeps a copy of that step's
    videos, parameters before it, draws and gradients.  `per_step` runs
    the chunks one step at a time where they would replay a captured
    CUDA graph (the card's eager yardstick)."""
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device")
    ranks = parallel.resolve_data_parallel(args.data_parallel, BATCH,
                                           args.device)
    if parallel.needs_launch(ranks):
        return parallel.launch(
            "svgpvae_tpu_torch.cli.ball", argv, {k: v for k, v in dict(
                video_fn=video_fn, eps_fn=eps_fn, np_split_fn=np_split_fn,
                capture_step=capture_step).items() if v is not None},
            ranks, args.device)
    with parallel.active(ranks):
        device = parallel.device(args.device)
        parallel.announce(device)
        return _main(args, device, video_fn, eps_fn, np_split_fn,
                     capture_step, per_step)


def _main(args, device, video_fn, eps_fn, np_split_fn, capture_step,
          per_step=False):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN (the GP math needs IEEE fp32)")
    args.gp_block_impl = models.resolve_gp_block_impl(
        args.gp_block_impl, workload="ball",
        titsias=args.elbo == "SVGPVAE_Titsias", device=device)
    model_lt = 0.001 if args.elbo == "VAE" else args.modellt
    if not (model_lt == args.vidlt or args.GP_joint or args.elbo == "VAE"):
        raise ValueError("model/data GP length scales must match unless "
                         "jointly optimized")
    print(f"elbo {args.elbo}, gp_block_impl {args.gp_block_impl}, device "
          f"{device}")

    seed = 0 if args.seed is None else args.seed
    run_dir = open_run_dir(args)
    test_batches = load_test_batches(args)
    params = build_model(args, device)
    trainable = train.trainable_tensors(params, trainable_predicate(args))
    print(f"parameters: {utils.count_params(params)}, trainable: "
          f"{sum(t.numel() for t in trainable.values())}")
    state = train.TrainState(
        params=params, optimizer=train.make_optimizer(trainable, LR),
        geco=None, lr_fn=train.cosine_decay_lr(LR, args.lr_decay,
                                               args.steps),
        clip_grad_value=CLIP_GRAD_VALUE if args.clip_grad else None)
    noise = Noise(eps_fn or default_eps_fn(seed, device, EVAL_SEED))
    injected_split = np_split_fn is not None
    np_split_fn = np_split_fn or default_np_split_fn(noise, device)
    video_fn = video_fn or data.make_video_batch_fn(
        tmax=args.tmax, px=PX, py=PY, lt=args.vidlt, batch=BATCH, r=RADIUS,
        device=device, seed=1234 if args.seed is None else args.seed + 1)
    if args.resume_dir:  # every rank restores
        resume(os.path.join(args.resume_dir, "ckpt"), state, noise,
               video_fn)
    parallel.check_replicated(list(train.named_tensors(params).values()))
    forward = make_forward(args, noise, np_split_fn, model_lt)
    loss_fn = make_loss_fn(args, forward)

    savers = {}
    if run_dir:
        savers["elbo"] = utils.ResultSaver(
            os.path.join(run_dir, "res", "ELBO_results.csv"), ELBO_COLUMNS,
            flush_every=1)
        if "SVGPVAE" in args.elbo:
            savers["gp"] = utils.ResultSaver(
                os.path.join(run_dir, "res", "GP_params.csv"), GP_COLUMNS,
                flush_every=1)
    tt0, td0 = test_batches[0]
    td0 = torch.as_tensor(td0, dtype=torch.float32, device=device)

    @torch.no_grad()
    def evaluate(check_step: Optional[int] = None):
        """The eval batch's outputs and their mse_rotation (aligned means,
        W, MSE, aligned variances); with `check_step` the sentinel sees
        the ELBO before the alignment."""
        out = forward(params, td0, "eval", 1.0)
        if check_step is not None:
            utils.check_finite([float(out.elbo.mean())], check_step,
                               lambda: checkpoint_state(state, noise,
                                                        video_fn), run_dir)
        return out, utils.mse_rotation(
            out.p_m.cpu().numpy().astype(np.float64), tt0,
            out.p_v.cpu().numpy().astype(np.float64))

    step_seconds, step_metrics, step_launches, evals = [], [], [], []
    captured, last_mse, pictures, chunks = None, float("nan"), [], []
    # every rank runs the pictures' eval passes; rank 0's run_dir draws
    draws = args.save or args.resume_dir is not None
    start = state.step
    chunk = chunk_steps(args)
    traced = profile_steps(args, start)
    why = per_step_reason(args, device, per_step, capture_step, noise,
                          video_fn, injected_split)
    print(f"training loop: chunks of {chunk} steps, each " + (
        f"step by step ({why})" if why else "replaying a captured CUDA "
        "graph of draw -> step, one readback a chunk"))
    graphs = chunk_fn = None
    if why is None:
        graphs = capture.GenerativeSteps(
            loss_fn, video_fn, chunk, [noise.generator,
                                       _generator(video_fn)])
        chunk_fn = train.make_generative_chunk_fn(graphs, chunk)

    def one_step():
        """A step of the per-step loop, timed after synchronize; the
        metrics as floats."""
        nonlocal captured
        snap = (_snapshot(state) if state.step == capture_step else None)
        before = ops.launch_counts()
        t0 = time.perf_counter()
        # every rank generates the batch and takes its share of videos
        with utils.annotate("train_step"), parallel.sharded():
            vids = video_fn()
            m = train.train_step(state, parallel.local_rows(vids), loss_fn)
            sync(device)
        step_seconds.append(time.perf_counter() - t0)
        after = ops.launch_counts()
        step_launches.append({k: after[k] - before[k] for k in after})
        if snap is not None:
            captured = dict(snap, vids=vids.clone(), eps=noise.last.clone(),
                            loss=m["loss"],
                            grads={k: t.grad.detach().clone()
                                   for k, t in trainable.items()})
        step_metrics.append({k: float(v) for k, v in m.items()})

    launches0 = ops.launch_counts()
    t_start = time.perf_counter()
    g_s = start
    while g_s < args.steps:  # the JAX driver's chunks: evals, pictures and
        n = min(chunk, args.steps - g_s)  # checkpoints at their ends
        t0 = time.perf_counter()
        with utils.trace_if(args.profile_dir, enabled=bool(traced)
                            and g_s == traced[0]):
            if chunk_fn is None:
                for _ in range(n):
                    one_step()
            else:
                ms, launches = chunk_fn(state, n)
                keys = list(ms)
                host = torch.stack([ms[k] for k in keys]).cpu().tolist()
                seconds = time.perf_counter() - t0
                step_seconds.extend([seconds / n] * n)
                step_launches.extend(launches)
                step_metrics.extend(dict(zip(keys, v)) for v in zip(*host))
        chunks.append({"steps": n, "seconds": time.perf_counter() - t0})
        g_s = state.step
        if traced and g_s == traced[1]:
            print(f"profiler trace written to {args.profile_dir} (steps "
                  f"{traced[0]}..{traced[1] - 1})")

        if g_s % args.eval_every == 0:
            before = ops.launch_counts()
            t0 = time.perf_counter()
            with utils.annotate("eval_pass"):
                out, (_, _, mse, _) = evaluate(check_step=g_s)
            elbo = float(out.elbo.mean())
            sync(device)
            after = ops.launch_counts()
            last_mse = mse
            ev = {"step": g_s, "mse": mse, "elbo": elbo,
                  "recon": float(out.recon.mean()),
                  "prior_kl": float(out.prior_kl.mean()),
                  "inside_elbo": float(out.inside_elbo.mean()),
                  "ce_term": float(out.ce_term.mean()),
                  "seconds": time.perf_counter() - t0,
                  "launches": {k: after[k] - before[k] for k in after}}
            evals.append(ev)
            print(f"{g_s}: elbo {elbo:.3f} recon {ev['recon']:.3f} "
                  f"priorKL {ev['prior_kl']:.3f} MSE {mse:.4f}")
            if "SVGPVAE" in args.elbo:
                print(f"   inside-ELBO {ev['inside_elbo']:.3f} CE "
                      f"{ev['ce_term']:.3f}")
            if savers:
                write_eval_rows(savers, state, out, ev, args.beta0)

        if draws and g_s % args.plot_every == 0:
            with utils.annotate("pictures"):
                pictures.append(draw_pictures(
                    args, run_dir, g_s, evaluate, forward, params, tt0,
                    td0))

        if run_dir and g_s % args.ckpt_every == 0:
            save(run_dir, state, noise, video_fn, evaluate, tt0, td0)

    if args.profile_dir and not traced:
        print("warning: --profile_dir set but no chunk was traced (needs "
              "two whole chunks of steps)")
    elapsed = time.perf_counter() - t_start
    steps_done = state.step - start
    # the first step, or with graphs the first chunk (its warm-ups and
    # capture: the JAX driver's compile), left out
    skip = 1 if chunk_fn is None else chunks[0]["steps"] if chunks else 0
    timed = np.asarray(step_seconds[skip:] or step_seconds)
    p50 = 1e3 * float(np.percentile(timed, 50)) if timed.size else None
    p90 = 1e3 * float(np.percentile(timed, 90)) if timed.size else None
    print(f"trained {steps_done} steps in {elapsed:.1f}s "
          f"({steps_done / max(elapsed, 1e-9):.2f} steps/s); final MSE "
          f"{last_mse:.4f}" + ("" if p50 is None else
                               f"; step p50 {p50:.3f} ms, p90 {p90:.3f} ms"))
    if run_dir:
        save(run_dir, state, noise, video_fn, evaluate, tt0, td0,
             preds=False)
    end = ops.launch_counts()
    return {"mse": last_mse,
            "steps_per_sec": steps_done / max(elapsed, 1e-9),
            "step_p50_ms": p50, "step_p90_ms": p90, "state": state,
            "launches": {k: end[k] - launches0[k] for k in end},
            "step_seconds": step_seconds, "metrics": step_metrics,
            "step_launches": step_launches, "evals": evals,
            "pictures": pictures, "chunks": chunks,
            "captured": captured, "run_dir": run_dir, "noise": noise,
            "video_fn": video_fn,
            "graph_replays": {} if graphs is None else {
                k: g.replays for k, g in graphs.graphs.items()},
            "graph_launches": {} if graphs is None else {
                k: g.launches for k, g in graphs.graphs.items()}}


def chunk_steps(args) -> int:
    """The JAX driver's chunk: the largest divisor of gcd(--eval_every,
    --plot_every, --ckpt_every) up to 500."""
    gcd = math.gcd(args.eval_every, math.gcd(args.plot_every,
                                             args.ckpt_every))
    return max(d for d in range(1, min(gcd, 500) + 1) if gcd % d == 0)


def profile_steps(args, start: int) -> Optional[tuple]:
    """--profile_dir's step range [first, end): the JAX driver's second
    chunk (chunk_steps) from `start`, or None without the flag or when
    that chunk would not run whole."""
    if not args.profile_dir:
        return None
    chunk = chunk_steps(args)
    first = start + chunk
    return (first, first + chunk) if first + chunk <= args.steps else None


def per_step_reason(args, device, per_step: bool, capture_step,
                    noise: Noise, video_fn, injected_split: bool
                    ) -> Optional[str]:
    """Why this run's chunks take their steps one by one, or None: each
    chunk replays a captured CUDA graph of draw -> step, as the JAX driver
    runs each chunk as one program (make_generative_chunk_fn)."""
    if per_step:
        return "main(per_step=True)"
    why = uncaptured_reason(device)
    if why is not None:
        return why
    if parallel.run_ranks() > 1:
        return ("--data_parallel: the ball's graphs have no check over "
                "NCCL (its batch of 35 videos tiles 5 or 7 ranks, not the "
                "2 or 4 cards they could be checked on)")
    if capture_step is not None:
        return "capture_step keeps one step's inputs"
    for what, gen in (("eps_fn", noise.generator),
                      ("video_fn", _generator(video_fn))):
        if gen is None:
            return (f"the {what} exposes no `generator`, so every replay "
                    "would reuse its captured draws")
    if injected_split and args.elbo == "NP":
        return ("an injected np_split_fn: its draws would be captured "
                "as constants")
    return None


def _generator(fn) -> Optional[torch.Generator]:
    return getattr(fn, "generator", None)


def checkpoint_state(state, noise: Noise, video_fn) -> dict:
    """The TrainState's state_dict and the noise and video generators'
    states (None for an injected function without one)."""
    gens = {k: _generator(f) for k, f in (("noise", noise),
                                          ("videos", video_fn))}
    return {"train_state": state.state_dict(),
            **{k: None if g is None else g.get_state()
               for k, g in gens.items()}}


def resume(ckpt_dir: str, state, noise: Noise, video_fn) -> None:
    """Restore the latest checkpoint under ckpt_dir into `state` and the
    generators."""
    if utils.latest_step(ckpt_dir) is None:
        print(f"no checkpoint under {ckpt_dir}; starting afresh")
        return
    ckpt = utils.restore_checkpoint(ckpt_dir)
    state.load_state_dict(ckpt["train_state"])
    for key, fn in (("noise", noise), ("videos", video_fn)):
        if ckpt[key] is None:
            continue
        gen = _generator(fn)
        if gen is None:
            raise ValueError(f"the checkpoint holds the {key} stream and "
                             "this run's function has no generator")
        gen.set_state(ckpt[key])
    print(f"resumed from {ckpt_dir} at step {state.step}")


def save(run_dir, state, noise, video_fn, evaluate, tt0, td0,
         preds: bool = True) -> None:
    """A checkpoint at the current step and (preds) the eval batch's
    predictions, preds/preds_<step>.p (videos, paths, predicted frames,
    aligned means and variances)."""
    utils.save_checkpoint(os.path.join(run_dir, "ckpt"),
                          checkpoint_state(state, noise, video_fn),
                          state.step)
    if preds:
        out, (rp, _, _, rv) = evaluate()
        with open(os.path.join(run_dir, "preds",
                               f"preds_{state.step}.p"), "wb") as f:
            pickle.dump((td0.cpu().numpy(), tt0,
                         out.pred_vid.cpu().numpy(), rp, rv), f)
    print(f"model saved: {run_dir}")


@torch.no_grad()
def probe_latents(forward, params, kind: str, W: np.ndarray, tmax: int,
                  device, dtype=torch.float32) -> tuple:
    """The --squares_circles probe `kind`: its path and video
    (PROBES[kind]), the video tiled to the batch of 35 and run through
    the eval forward, and the first video's encoder means aligned with W
    (an eval pass's mse_rotation): (traj (T, 2), vid (1, T, 32, 32),
    aligned (T, 2) float64)."""
    traj, vid = PROBES[kind](px=PX, py=PY, r=RADIUS, tmax=tmax)
    batch = torch.as_tensor(np.tile(vid, (BATCH, 1, 1, 1)), dtype=dtype,
                            device=device)
    qm = forward(params, batch, "eval", 1.0).qnet_mu[0]
    qm = qm.cpu().numpy().astype(np.float64)
    return traj, vid, np.hstack([qm, np.ones((tmax, 1))]) @ W


def draw_pictures(args, run_dir, g_s, evaluate, forward, params, tt0,
                  td0) -> dict:
    """The JAX driver's pictures at step g_s: one eval pass drawn by
    plot_latents into pics/<g_s:06d>.png, and under --squares_circles
    each probe's aligned latents by plot_geometry_probe into
    pics/<g_s:06d>_<kind>.png.  The passes run on every rank; a rank
    without a run dir draws nothing.  Returns {"step", "launches" (of the
    passes), "probes" ({kind: aligned latents}), "seconds" ({"eval",
    "probes", and per picture kind the host time to draw and write
    it})}."""
    before = ops.launch_counts()
    t0 = time.perf_counter()
    out, (rp, W, _, rv) = evaluate()
    pred_vid = out.pred_vid.cpu().numpy()
    seconds = {"eval": time.perf_counter() - t0}
    pics = os.path.join(run_dir, "pics") if run_dir else None
    if pics:
        t0 = time.perf_counter()
        plots.plot_latents(td0.cpu().numpy(), tt0, pred_vid, rp, rv,
                           save_path=os.path.join(pics, f"{g_s:06d}.png"))
        seconds["latents"] = time.perf_counter() - t0
    probes = {}
    if args.squares_circles:
        t0 = time.perf_counter()
        drawn = {kind: probe_latents(forward, params, kind, W, args.tmax,
                                     td0.device) for kind in PROBES}
        seconds["probes"] = time.perf_counter() - t0
        for kind, (traj, vid, aligned) in drawn.items():
            probes[kind] = aligned
            if pics:
                t0 = time.perf_counter()
                plots.plot_geometry_probe(
                    traj, aligned, vid, kind, save_path=os.path.join(
                        pics, f"{g_s:06d}_{kind}.png"))
                seconds[kind] = time.perf_counter() - t0
    after = ops.launch_counts()
    return {"step": g_s, "probes": probes, "seconds": seconds,
            "launches": {k: after[k] - before[k] for k in after}}


def write_eval_rows(savers, state, out, ev, beta0) -> None:
    """The JAX driver's per-eval rows."""
    savers["elbo"]([
        ev["step"], -ev["elbo"], ev["elbo"], ev["recon"], ev["prior_kl"],
        float(out.qnet_var.min()), float(out.qnet_var.max()),
        float(out.p_v.min()), float(out.p_v.max()), ev["inside_elbo"],
        ev["ce_term"], ev["mse"], beta0, time.time()])
    if "gp" in savers:
        gp = state.params["gp"]
        savers["gp"]([ev["step"], gp.length_scale.detach().cpu().numpy(),
                      float(torch.linalg.norm(gp.inducing_points.detach())),
                      gp.inducing_points.detach().cpu().numpy()])


def _snapshot(state) -> dict:
    """Copies of the parameters a step starts from, by name."""
    return {"step": state.step,
            "params": {k: t.detach().clone() for k, t in
                       train.named_tensors(state.params).items()}}


if __name__ == "__main__":
    main()
