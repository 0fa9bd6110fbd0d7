#!/usr/bin/env python3
"""Smoke run of the PyTorch port (svgpvae_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (nonzero exit) on failure:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA library from csrc/ (one nvcc per source, all at once),
     print the build time;
  3. each CUDA kernel against its plain PyTorch twin, on the card:
     B2/B3 at the SPRITES serving shape (n = 50,000, m = 72, L = 64) and at
     a ragged small shape, B2 also at the MNIST training shapes (256 and
     164 rows in a step, 28 in the last test batch, 8,100 in the cgen
     pass; m = 32, L = 16), B1 chol_inverse at (17, 32, 32) and the
     Titsias step's (33, 32, 32) and the ball's (72, 15, 15) and
     (142, 15, 15) (warp form), (65, 72, 72), (64, 72, 72),
     a ragged (5, 37, 37) and the SPRITES Titsias stack (129, 72, 72)
     (blocked form), and (17, 256, 256), (65, 288, 288) and
     (65, 512, 512) (panel form), B3 also at the MNIST serve fit
     (n = 8,100, m = 32, L = 16, the mnist family, with and without
     normalize); max errors and the times of kernel (per call, and device
     time in a CUDA-graph replay at the serve fits' shapes), twin and
     (B2) one library call, and each bound; B1 on a Titsias stack [K_mm;
     Sigma; Sigma1] in one call against the same matrices in two calls, bit
     for bit (the JAX package makes two calls for the TPU's VMEM; the port
     one); then one line with each kernel variant's registers and local
     memory per thread and resident blocks per SM at those shapes (B3: its
     K-build kernel too; it runs no thread-block clusters);
  4. the serve, through svgpvae_tpu_torch.cli.serve.main: the
     1000-character synthetic corpus in memory (N = 50,000 train frames),
     seed-0 weights, 8 requests -- once with the default linear x linear
     GP kernel (fit through B3 fused_kernel_stats) and once with --K_SE
     (fit through B2 gp_sufficient_stats).  Launch counters are zeroed
     just before and read just after; each serve's kernel must have
     launched inside its `serving.fit`;
  5. for each of the two serves, the card's encodings and aux data
     copied to the CPU, the fit and one request's p_m/p_v redone there
     with the plain twins, and compared;
  6. the rotated-MNIST training run, through
     svgpvae_tpu_torch.cli.mnist.main at the north-star width: the
     36-digit synthetic set in memory (N_train = 8,100, an 800-object
     GPLVM table, batch 256, L = 16, m = 32), Hensman + GECO,
     --opt_regime joint-2 --eval_every 2 (64 steps, one eval pass with
     the cgen MSE).  Launch counters are zeroed just before and read just
     after; B1 must launch exactly once in every step and B2 at least
     once;
  7. one mid-run training step (its parameters, GECO state, batch and
     noise, copied from the card) redone on the CPU with the twins, in
     fp32 (the batch in its order, reversed and in BASELINE_PERMUTATIONS
     seeded orders, each with B1's Cholesky twin and with plain
     Gauss-Jordan, the kernel's method) and in f64: the card's loss, GECO
     state and every gradient against the CPU fp32 twin, within a stated
     multiple of the CPU's own fp32-vs-f64 gap;
  8. the SPRITES training run, through svgpvae_tpu_torch.cli.sprites.main
     at the JAX CLI's widths: phase 4's 1000-character corpus in
     memory (N_train = 50,000, batch 500 = 10 characters x 50 frames,
     64x64x3 frames, L = 64, L_action = 8, L_character = 16, 72 inducing
     points, jitter 0.01), Hensman + GECO, --nr_epochs_repr_nn 2
     (20 pretraining steps), --opt_regime joint-1 --eval_every 1 (100
     steps, one eval pass over the 250 unseen characters).  Launch
     counters are zeroed just before and read just after; every step must
     launch B1 twice (fused_rejitter_pallas: [K_mm; Sigma], then A_hat)
     and B2 once, and the eval pass's fit B3 once;
  9. SPRITES step 60 checked on the CPU: (a) its two B1 input stacks,
     recomputed on the card from the captured inputs, through the kernel
     against a float64 inversion of the same fp32 stacks, within a stated
     multiple of the larger fp32 witness's own gap to float64 (the
     Cholesky twin, plain unblocked Gauss-Jordan); (b) the whole step
     redone on the CPU with the twins (fp32 in the batch's order, fp32
     with its characters reversed, f64), as phase 7;
 10. the large-m runs, B1 in its panel form (checked): SPRITES --m 4
     --L_character 36 (m = 288) on phase 4's corpus at phase 8's other
     widths, 1 pretraining epoch and 1 epoch (B1 twice and B2 once per
     step, B3 in the eval fit), with phase 9(a)'s check on its step 60;
     rotated MNIST --nr_inducing_points 16 --jitter 1e-3 (m = 256) at
     phase 6's widths, 1 epoch (B1 once per step).  Why those two flags:
     see SPRITES_M4_ARGV.  Launch counters are zeroed just before each
     run and read just after;
 11. the rotated-MNIST Titsias run: phase 6's configuration with
     --elbo SVGPVAE_Titsias and without --GECO (the plain objective, the
     exact-entropy CE), 64 steps and one eval pass; every step must launch
     B1 exactly once (the (33, 32, 32) stack [K_mm; Sigma; Sigma1]) and
     B2 exactly twice (at the encoder noise and at noise + jitter); then
     phase 7's CPU recheck of its step 40;
 12. the SPRITES Titsias run at the record configuration's flags
     (--ip_joint --GPLVM_joint --PCA --object_kernel_normalize
     --clip_grad, no --GECO) and phase 8's widths and depth: the `fused`
     cell, so every step launches B2 exactly twice and B1 never, and the
     eval pass's fit the normalize variant of B3 once; then phase 9(b)'s
     CPU recheck of its step 60.  Launch counters are zeroed just before
     each run and read just after;
 13. checkpoints and serving from a trained run (phase 8's run also
     writes its run dir, with --save --save_model_weights, into a
     temporary directory): (a) phase 6's run for one epoch with --save
     --save_model_weights; the same run restored from its checkpoint for
     0 epochs must equal the saved state bit for bit (parameters, Adam
     moments, GECO state, step, noise generator); then --resume_dir for
     one epoch more (B1 once and B2 at least once per step), its cgen MSE
     printed beside phase 6's; (b) cli.serve.main --run_dir on that run:
     B3's mnist family exactly once inside serving.fit, the fit and the
     64 demo queries' p_m/p_v redone on the CPU as phase 5 does (held to
     the larger of CPU_RTOL and RUN_FIT_NOISE_FACTOR x the CPU's own
     fp32-vs-f64 gap), --out and --queries round-tripped; (c) the same
     serve on phase 8's run dir (B3 sprites family once in the fit) and its
     phase-5 recheck. Launch counters are zeroed just before the training
     runs and before the serves, and read just after.
 14. the moving ball, through svgpvae_tpu_torch.cli.ball.main at the JAX
     driver's full width (35 videos of 30 32x32 frames, hidden 500,
     m = 15, jitter 1e-9): (a) SVGPVAE_Hensman --clip_qs --entropy_ce
     (the `fused_pallas` cell), 1,000 steps and one eval: B1 exactly once
     per step and in the eval, on the (72, 15, 15) stack [K_mm;
     Sigma_1..35] of both channels; (b) SVGPVAE_Titsias --clip_qs, 500
     steps and one eval, B1 once per step on (142, 15, 15) [K_mm; Sigma;
     Sigma1]; (c) the driver's default GPVAE_Pearce and the NP, 100 steps
     each, no kernel.  For (a) and (b): the captured mid-run step's B1
     stack recomputed on the card and held as phase 9(a) holds SPRITES's,
     and the whole step redone on the CPU (fp32 in order, fp32 with the
     videos reversed, f64), as phase 7.  Launch counters are zeroed just
     before each run and read just after.
 15. the baselines at the drivers' widths (BASELINE_RUNS): through
     cli.mnist.main on phase 6's 36-digit set, VAE and CVAE (2 epochs +
     eval), SVIGP_Hensman (2 epochs + eval) and GPVAE_Casale (--opt_regime
     VAE-1 GP-1 joint-3, the full-train encode every step, the eval after
     epoch 5), and through cli.sprites.main --elbo VAE on phase 4's corpus
     (1 epoch of 100 steps at batch 500 + eval): no kernel of the port
     may launch (counters zeroed before each run, read after); each
     run's captured step redone on the CPU as phase 7 (fp32 in order,
     reversed and in BASELINE_PERMUTATIONS seeded orders, f64; Casale's
     reordered steps also take the train split's rows, the Taylor sum's,
     in a reversed or seeded order).  Then phase 6's run with --opt_regime VAE-1 joint-1:
     the VAE epoch launches nothing, the joint epoch B1 once a step;
     phase 7's recheck of its step 40.
 16. the drivers' last single-GPU flags, each run with the launch
     counters zeroed just before and read just after: (a) phase 6's run
     with --reshuffle --test_set_metrics --profile_dir --save (phase 6's
     checks: B1 once and B2 at least once a step; the trace holds epoch
     1's 32 "train_step" ranges; one test-set metric row); (b)
     --bias_analysis for one epoch: no B1 in the steps (the two-pass
     block), B2 in every step and once in the bias pass at n = 8,100;
     (c) NaN training draws under --save: NonFiniteLossError and
     ckpt_nan/32.pt; (d) one --x64 epoch and its eval: 0 kernel launches
     (the plain versions in float64), beside phase 6's counts; (e) phase
     8's run with --reshuffle --test_set_metrics (phase 8's checks: B1
     twice and B2 once a step, B3 once in the eval fit); (f) a 4-character
     raw npy corpus written to a temporary directory, preprocessed into
     shards by cli.sprites (equal to data.preprocess_sprites), then one
     epoch on it at phase 8's widths; (g) the ball Hensman run for 200
     steps with --profile_dir: the JAX driver's chunk is gcd(100, 10000,
     50000) = 100, so the trace holds steps 100..199.
 17. mixed precision, each run with the launch counters zeroed just
     before and read just after: (a) phase 8's run with --bf16, then with
     --bf16_hybrid (phase 8's checks: B1 twice and B2 once a step, B3
     once in the eval fit); the encoder's outputs bf16 (fp32 under the
     hybrid) and every tensor handed to B1, B2 and B3 fp32; the step
     p50/p90 beside phase 8's; the --bf16 run's step 60 redone on the CPU
     with its nets in bf16 from the same state, batch and noise (loss and
     GECO state within 10x the CPU's spread over six character orders,
     floored; each gradient within BF16_LEAF_FACTOR x the CPU's
     bf16-vs-fp32 distance; the gradients together nearer the CPU's bf16
     step than its fp32 one); (b) phase 6's run with
     --bf16 (phase 6's checks, B2 also in the cgen pass), the same dtype
     checks, its p50 beside phase 6's.
 18. --data_parallel, the ranks sharing the one card through gloo (a
     correctness run, not a scaling one; every rank's launch counts,
     which each rank zeroes as it starts, are read by rank 0 at the end
     of the run and must agree across ranks): (a) phase 6's run over 2
     ranks, held to phase 6's 1-process run (per-step loss and GECO
     state, final parameters, eval rows) within RECHECK_FACTOR x the
     same run's fp32-vs-float64 gap (--x64 on the same draws; the float64
     run 21(a) holds its run to), and its captured step rechecked on the
     CPU as phase 7; (b) phase 8's widths and flags over 4 ranks at batch
     500 (125 frames a rank, shares starting inside characters) on a
     DP_SPRITES_CHARS-character corpus, beside YARD_RUNS runs in 1
     process, held to the first within RECHECK_FACTOR x the largest gap
     between two of them, and its captured step rechecked on the CPU as
     phase 9(b); (c) phase 13(c)'s serve on that corpus with the fit over
     2 ranks (B3 once a rank), held to the CPU twin as phase 13 holds it.
     Each part prints its seconds.
 19. the pictures, drawn with numpy alone (no matplotlib on the card's
     machine): (a) the ball, Hensman then Titsias, at phase 14's widths
     with --save --squares_circles --eval_every 50 --plot_every 50 for
     100 steps (launch counters zeroed just before each run and read
     just after, under the path "pictures"): every step, eval and
     picture pass launches B1 once on the run's stack, (72, 15, 15) or
     (142, 15, 15), 3 a plot (the eval pass drawn and the two probes);
     the last plot's probe latents, aligned on the card, held to the same
     weights' fp32 CPU twin within the larger of CPU_RTOL and
     RECHECK_FACTOR x the CPU's own fp32-vs-f64 gap (phase 13's rule);
     (b) the run dirs of phases 8, 13(a), 16(a), 16(e) and 19(a): pics/
     holds exactly the PNG names the JAX driver writes for their flags
     and steps, each decoded by utils.png.read_png at the JAX figure's
     size, not constant, its title (the kernel pictures: their three
     panel titles) in its text chunks; (c) the host ms of each picture
     kind on a line of its own, and matplotlib never imported.
 20. --epoch_chunk and --eval_bundle, the steps and the eval group
     replayed from captured CUDA graphs: (a) phase 6's run with
     --lr_decay 0.1 (each captured step's lr read from the graphs' table),
     eager and with --epoch_chunk 2 --eval_bundle: graphs of the
     full-batch step, the tail step and the eval group captured and
     replayed, B1 once and B2 at least once in every step and the run's
     launches those of phase 6; its per-step loss and GECO state, final
     parameters and eval MSEs held to the eager run within RECHECK_FACTOR
     x the same run's fp32-vs-float64 gap (on the same draws), as phase
     18(a) holds its run; (b) 10 epochs with --epoch_chunk 5 --eval_every
     5 --eval_bundle, run unbroken twice, the first traced by
     torch.profiler from its first eval to its end (its last chunk and
     eval group, all replays): the B1, B2 and B3 kernels the trace saw
     equal the launch counters' over the window and each graph's
     launches (counted at its capture) times its replays, and go into
     the kernels line under the path "epoch_chunk"; 5 epochs saved with
     phase 13(a)'s flags, restored (bit for bit, the noise generator
     included) and resumed for 5 more: the resumed run's per-step
     metrics, final parameters and eval MSEs held to the unbroken run as
     in (a), the yardstick the largest gap among YARD_RUNS unbroken
     runs (hold_to_yard), and its noise generator's state the unbroken
     run's; then the same four runs under
     torch.backends.cudnn.deterministic: the two unbroken runs, the
     saved run against the unbroken run's first half and the resumed run
     against its second half, all bit for bit; (c) phase 11's Titsias run as
     (a), and phase 15's deep SVIGP run with --epoch_chunk 2 held to its
     eager run within RECHECK_FACTOR x the gap of the eager run on train
     pixels nudged by one fp32 ulp (its loss floored at the round-off of
     the batch's sum of squared errors).  Each run prints its chunks'
     seconds, the later chunks' p50 per step and its eval groups' seconds
     beside the eager run's.  The eager runs of (a) and (c) are the
     drivers' per-step loops (main(per_step=True)).
 21. the default training loops replayed from captured CUDA graphs, each
     run of a driver's default path (no capture_step), held to the
     per-step run of the same argv and draws: (a) phases 6 and 11 (MNIST
     at --epoch_chunk 1, each epoch a full-batch and a tail graph),
     (b) phase 8 in fp32, 17(a)'s --bf16 run and phase 12's SPRITES
     Titsias run (the `fused` block), (c) phase 14's ball runs, every
     --elbo
     (chunks of 500 steps or fewer, one draw -> step graph).  Each: graph
     replays, every step's B1/B2 launches, the run's launches equal to
     the per-step run's by the counters, and a second captured run
     traced by its --profile_dir (an epoch, or the ball's second chunk),
     whose B1/B2/B3 kernels the card ran equal the counters' over those
     steps and the per-step run's over as many; the per-step loss (and
     GECO state), final parameters and eval scores within
     RECHECK_FACTOR x their gap in the per-step run with a capturable
     Adam (the reordering capture brings; MNIST: 20(a)'s float64 run;
     SPRITES: the largest pairwise gap of the per-step run and
     YARD_RUNS - 1 such runs), floored as hold_runs floors.  The SPRITES
     runs of (b) take DEFAULT_LOOP_CHARS characters (25 steps an
     epoch), each beside its own per-step run there
     (main(per_step=True)).  Each run prints its step ms (a replayed
     epoch's or chunk's seconds over its steps) beside the per-step p50,
     and from the trace the ms a step and the card's idle share over a
     window of replayed steps (DEFAULT_LOOP_TRACES), with the card's name
     and power limit.  The SPRITES runs of (b) also capture their
     pretraining epochs (a graph of the step) and their eval pass (four
     captured calls: recon, encode, fit, cgen): the graphs must have
     replayed, and the pretraining's per-epoch loss and accuracy are held
     to the per-step run's (and its peers') eager ones as the run is; then
     phase 8's run for 2 epochs, its second eval pass and epoch 1 traced
     by torch.profiler: the B1, B2 and B3 kernels of the eval calls equal
     the counters' and each call's launches (the path
     "sprites_eval_graph"); (d) a capture with a host read raises from
     train.capture.Graph, and the card runs on.  Each run prints its
     seconds.
 22. the MNIST driver's last loops replayed from captured CUDA graphs:
     phase 15's VAE, CVAE, Casale (--casale_taylor_every 1) and --opt_regime
     VAE-1 joint-1 runs without a capture_step, and Casale at
     --casale_taylor_every 2 (the held sample's refresh a graph of its
     own), each held to its per-step run as phase 21 holds one (every
     step's launches, the run's launches, a trace of its first timed
     epoch whose kernels equal the counters', the per-step loss, final
     parameters and eval scores within RECHECK_FACTOR x the gap of the
     per-step run with a capturable Adam, Casale's the largest pairwise
     gap of it and YARD_RUNS - 1 such runs, floored); each prints its
     replayed ms a step, idle share and memory peak beside the per-step
     p50.
 23. --data_parallel over NCCL, one rank a card, when the machine has 2
     cards or more (on one card a line says that it did not run and how
     many cards it saw): the MNIST, Titsias, deep SVIGP, SPRITES and
     MNIST VAE runs
     of NCCL_RUNS per step over 2 and 4 cards, each held to its 1-process
     run within RECHECK_FACTOR x the largest gap among YARD_RUNS
     1-process runs, then on their default loops (CUDA graphs with the
     all-reduces inside) held to their per-step runs, MNIST also with
     --epoch_chunk 3 --eval_bundle; every rank's launches alike; traces
     of MNIST's and SPRITES's epoch 1 whose B1/B2 kernels equal the
     counters' and whose NCCL all-reduce kernels equal the captured
     graphs' all-reduces over those steps; the serve's fit sharded over 2
     and 4 cards (the comment above NCCL_RUNS says it all; paths
     "nccl:<run>:<cards>:<loop>", "nccl:serve:<cards>").
 24. the JAX package's last one-program calls replayed from captured
     CUDA graphs, each held to its eager form on the same state (the
     comment above CAPTURED_EVAL_ARGV says it all): (a) phase 6's run with
     --eval_every 1, its unbundled eval passes (eval and test recon, the
     encode -> cgen) beside their eager twins, then traced: the B1/B2
     kernels the card ran in the second eval's graphs equal the counters'
     and the graphs' launches (the path "captured_eval"); (b) Casale's
     cgen graph, two cgens beside their eager twins; (c) phase 4's corpus
     serve and (d) phase 13(a)'s MNIST --run_dir serve, each eager,
     captured (a graph per encode chunk shape and per request shape) and
     eager again, held, traced (no host-to-device copy inside a replay),
     the request p50 captured beside eager (paths "serve_graph",
     "mnist_serve_graph": their fits' B3).

Phase 3 also times B2 at the m = 256 and 288 training shapes of phase 10
((256, 256, 16) and (8,100, 256, 16); (500, 288, 64) and (360, 288, 64))
and B3 at its m = 288 eval fit (50,000, 288, 64, d = 8 + 36), and phase
18's per-rank shares: B2 at (128, 32, 16), (4,050, 32, 16) and
(125, 72, 64), B3 and B2 at (25,000, 72, 64).

The line before the last is {"kernels": [...]} (per kernel: launches on
the main paths of phases 4, 6, 8, 10-20, phase 18's summed over its
runs and ranks under the path "data_parallel", phase 20's as its trace
of the card saw them under "epoch_chunk", phase 21's as its traces saw
them under "default_loop:<run>" and the SPRITES eval calls' under
"sprites_eval_graph", phase 22's as its traces saw them under
"captured:<run>" and the VAE-phase run's by the counters under
"vae_phase_graph", phase 23's (on 2 cards or more) summed over the ranks
under "nccl:...", phase 24's under "captured_eval" (the trace) and
"serve_graph" / "mnist_serve_graph" (the counters), and the max error and
times measured in phase 3 at the shape named in the entry, with the bound
computed from that shape; B1's entry lists every phase-3 shape under
"forms", B3's its other timed shapes under "variants"); the last line is
{"ok": true, "device": {...}}.  Needs a CUDA
device; exits nonzero without one.  TF32 is off for matmuls and cuDNN
throughout.  Each phase prints its seconds.
"""

from __future__ import annotations

import collections
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SLICE = dict(n=50_000, m=72, L=64, d1=8, d2=16)   # SPRITES fit shape
RAGGED = dict(n=1_003, m=37, L=5, d1=3, d2=7)
MNIST_FIT = dict(n=8_100, m=32, L=16, d1=1, d2=8)  # MNIST serve fit shape
# Kernel vs twin: both fp32, summing n terms in different orders.  Each
# output is held to its own scale: Sigma (positive terms) grows ~n, r
# (random-sign py) only ~sqrt(n), so a limit scaled by Sigma would hide a
# wrong r.  The random-walk estimate of the difference is ~sqrt(n)*eps of
# the output's scale, ~1e-5 at n = 5e4 for either; 1e-4 of max|twin_k|
# leaves ~8x margin over that.
KERNEL_RTOL = 1e-4
# Card (kernel) fit vs CPU (twin) fit, both fp32, on p_m and p_v of one
# request: Sigma differs by ~2e-6 relative between the two (phase 3), and
# the ridge 1e-5 * max diag bounds cond(Sigma) by ~1e5.  This fit's fp32
# noise (fp32 vs f64, printed) is ~3e-6 of max|p_m|, and the card-vs-CPU
# gap on an H100 ~1e-5; 1e-4 of max|.| leaves ~10x over that.
CPU_RTOL = 1e-4
SERVE_CHARS = 1000   # 50,000 train frames, 250 unseen characters
SERVE_REQUESTS = 8
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "chol_inverse": ("svgpvae_tpu_torch/csrc/chol_inverse.cu",
                     "svgpvae_tpu/ops/chol_inverse.py:174"),
    "gp_sufficient_stats": ("svgpvae_tpu_torch/csrc/gp_stats.cu",
                            "svgpvae_tpu/ops/gp_stats.py:63"),
    "fused_kernel_stats": ("svgpvae_tpu_torch/csrc/gp_stats.cu",
                           "svgpvae_tpu/ops/fused_kernel_stats.py:100"),
}
# B1 vs its Cholesky twin: Gauss-Jordan and Cholesky are both
# backward-stable at ~cond * eps; the inverse within 5e-4 of its own max
# |entry| and logdet within rtol 1e-5 (1e-4 at m = 72), the tolerances
# tests/test_fused_gp.py holds the TPU kernel to.  Inputs: PD stacks of
# condition 1e4 (1e3 at m >= 72).
B1_SHAPES = [("train", 17, 32, 1e4), ("sprites", 65, 72, 1e3),
             ("sprites_A_hat", 64, 72, 1e3), ("ragged", 5, 37, 1e4),
             ("mnist_titsias", 33, 32, 1e4),    # [K_mm; Sigma; Sigma1]
             ("ball_hensman", 72, 15, 1e4),     # [K_mm; Sigma_1..35] x 2
             ("ball_titsias", 142, 15, 1e4),    # [K_mm; Sigma; Sigma1] x 2
             ("sprites_titsias", 129, 72, 1e3),  # --gp_block_impl
                                                 # fused_pallas
             ("mnist_m256", 17, 256, 1e3),      # --nr_inducing_points 16
             ("sprites_m288", 65, 288, 1e3),    # --m 4
             ("sprites_A_hat_m288", 64, 288, 1e3),
             ("scaling_m512", 65, 512, 1e3)]    # the GP-dimension cell
B1_INV_TOL = 5e-4
# B2 at the training shapes: MNIST's minibatch, tail, last test batch and
# cgen pass (the mnist-family K), SPRITES's minibatch and test batch
TRAIN_STATS = [("train_step", "mnist", dict(n=256, m=32, L=16, d1=1, d2=8)),
               ("train_tail", "mnist", dict(n=164, m=32, L=16, d1=1, d2=8)),
               ("test_tail", "mnist", dict(n=28, m=32, L=16, d1=1, d2=8)),
               ("cgen", "mnist", dict(n=8_100, m=32, L=16, d1=1, d2=8)),
               ("sprites_step", "sprites",
                dict(n=500, m=72, L=64, d1=8, d2=16)),
               ("sprites_test_batch", "sprites",
                dict(n=360, m=72, L=64, d1=8, d2=16)),
               # phase 10's m = 256 (MNIST) and m = 288 (SPRITES) runs
               ("mnist_m256_step", "mnist",
                dict(n=256, m=256, L=16, d1=1, d2=8)),
               ("mnist_m256_cgen", "mnist",
                dict(n=8_100, m=256, L=16, d1=1, d2=8)),
               ("sprites_m288_step", "sprites",
                dict(n=500, m=288, L=64, d1=8, d2=36)),
               ("sprites_m288_test_batch", "sprites",
                dict(n=360, m=288, L=64, d1=8, d2=36)),
               # phase 18's per-rank shares: MNIST over 2 ranks (a
               # minibatch, the cgen pass), SPRITES over 4
               ("dp2_mnist_rank_step", "mnist",
                dict(n=128, m=32, L=16, d1=1, d2=8)),
               ("dp2_mnist_rank_cgen", "mnist",
                dict(n=4_050, m=32, L=16, d1=1, d2=8)),
               ("dp4_sprites_rank_step", "sprites",
                dict(n=125, m=72, L=64, d1=8, d2=16))]
# B3 at phase 10's SPRITES eval fit (m = 288, L_character 36)
SPRITES_M288_FIT = dict(n=50_000, m=288, L=64, d1=8, d2=36)
# B3 (and B2 under --K_SE) at one rank's share of the serve's fit over 2
# ranks (phase 18)
DP_RANK_FIT = dict(n=25_000, m=72, L=64, d1=8, d2=16)
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): fp32 outside the tensor
# cores, and HBM3
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Training run (phase 6): the north-star config on the 36-digit set
TRAIN_ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs", "--PCA",
              "--ip_joint", "--GP_joint", "--ov_joint", "--dataset", "36",
              "--synthetic_digits", "--opt_regime", "joint-2",
              "--eval_every", "2", "--device", "cuda", "--seed", "0"]
# Phase 11: the same run on the Titsias bound, without GECO (as
# tools/debug_titsias.py runs it)
TITSIAS_ARGV = ["--elbo", "SVGPVAE_Titsias"] + [
    a for a in TRAIN_ARGV[2:] if a != "--GECO"]
TRAIN_STEPS = 64       # 2 epochs x (31 full batches + the tail of 164)
CAPTURE_STEP = 40      # the mid-run step rechecked on the CPU (phase 7)
# Card (kernels, cuDNN, cuBLAS) vs CPU (twins) on one step, both fp32:
# each is off the exact answer by fp32 round-off, so the card is held to
# 10x the CPU's own fp32-vs-f64 gap (the largest of the CPU's fp32 runs:
# the batch in its order and reversed, and for the MNIST step
# (train_cpu_steps) in BASELINE_PERMUTATIONS seeded orders, each order
# also with B1 taken by the kernel's own method, plain Gauss-Jordan,
# beside the Cholesky twin, as phase 9(a) holds B1.  On the Titsias step
# the card's inside-ELBO and CE sat a median 4x, up to 40x, further from
# f64 than the twin's, and its loss, through the decoded images, up to
# 1.4e-4 of ~35 against a CPU gap as low as 1.2e-6 over two orders:
# tools/train_recheck_probe.py).  One sample of a gap can come out far
# below the round-off the card's summation order gives (measured: 1.7e-7
# on the last decoder bias, whose gradient sums 256 x 28 x 28 = 200,704
# terms, against a card-vs-CPU 6.6e-6), so each gap is floored: a
# gradient's at the random-walk round-off of the step's longest sum,
# sqrt(200,704) x 2^-24 = 2.7e-5 of its max |entry|; the GECO state's and
# the loss's at one fp32 ulp of their scale (for the loss, the
# magnitudes it is the difference of: |inside-ELBO| + |CE term| + |loss|,
# ~1.7e4 against a loss of ~40).
RECHECK_FACTOR = 10.0
# Phase 15's rechecks sample the CPU's fp32 round-off in four more batch
# orders (seeded permutations) beside those two: the Casale step's loss
# gap came out of the two at 6.1e-7 to 4.0e-5 over seven card runs, and
# in one of them below a tenth of the card's 2.3e-5 (PR 11's runs).  The
# Casale loss also sums its Taylor terms over the whole train split, so
# its reordered steps take the train rows in a reversed or seeded order
# too.
BASELINE_PERMUTATIONS = 4
SUM_FLOOR = math.sqrt(256 * 28 * 28) * 2.0 ** -24
FP32_ULP = 2.0 ** -23
# SPRITES training run (phase 8): the JAX CLI's defaults on phase 4's
# corpus; depth cut to 2 pretraining epochs, 1 epoch and one eval pass
SPRITES_ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs",
                "--synthetic", "--synthetic_chars", str(SERVE_CHARS),
                "--opt_regime", "joint-1", "--eval_every", "1",
                "--nr_epochs_repr_nn", "2", "--device", "cuda", "--seed", "0"]
# Phase 12: phase 8's run at the SPRITES record configuration's flags
# (tools/tpu_round5.py::sprites_titsias_job, less the TPU-only --s2d64)
SPRITES_TITSIAS_ARGV = ["--elbo", "SVGPVAE_Titsias"] + [
    a for a in SPRITES_ARGV[2:] if a != "--GECO"] + [
    "--ip_joint", "--GPLVM_joint", "--PCA", "--object_kernel_normalize",
    "--clip_grad"]
SPRITES_STEPS = 100        # 50,000 frames / batch 500
SPRITES_PRETRAIN_STEPS = 20  # 2 epochs x 50,000 / 5,000
SPRITES_CAPTURE = 60       # the mid-run step checked in phase 9
SPRITES_FPC = 50           # train frames per character
# Phase 9(a), B1 on the step's own stacks: Sigma's relative ridge bounds
# its condition near 1e5 (1e3 in phase 3's synthetic stacks), where a
# fixed tolerance means nothing.  Gauss-Jordan without pivoting and
# Cholesky are both backward-stable at ~cond * eps on a PD matrix, but
# their forward errors on one stack differ by more than round-off, so two
# fp32 witnesses run beside the kernel: the Cholesky twin and plain,
# unblocked Gauss-Jordan (the kernel's method one pivot at a time).  The
# kernel is held to 10x the larger witness's gap to float64 (as phase 7's
# multiple): the inverse normalized by each matrix's max |entry|, the
# logdet absolute.  Each gap is floored at m * 2^-24 of its scale (1,
# max |logdet|): one ulp per pivot, so a witness that happens to land
# within round-off of float64 cannot set a limit below that.
B1_REAL_FACTOR = 10.0
# Phase 10: the large-m runs, each through B1's panel form.  SPRITES
# --m 4 (m = 72 x 4 = 288) at phase 8's widths on phase 4's corpus, depth
# cut to 1 pretraining epoch (10 steps) and 1 epoch (100 steps) with one
# eval pass; rotated MNIST --nr_inducing_points 16 (m = 16 x 16 = 256)
# at phase 6's widths, 1 epoch (32 steps) and one eval pass.  Neither
# configuration trains in fp32 at the drivers' defaults, in either
# package (ROADMAP.md section C): at L_character 16, SPRITES's K_mm has
# rank <= 8 x 16 = 128 < 288, and on the same weights and noise the JAX
# CLI's ELBO diverges as the port's does (tools/compare_sprites_m4_cpu.py);
# MNIST's jitter 1e-6 leaves K_mm + jitter (rank <= 16 x 8 = 128 < 256)
# indefinite in fp32 from the first step.  So each run changes one flag,
# the least that makes K_mm usable at its m, and keeps every other width
# and the path --m 4 / --nr_inducing_points 16 take (B1's panel form on
# the stacks training builds, B2 and B3 at that m): --L_character 36,
# the smallest at which 8 x L_character reaches 288 (K_mm of full rank),
# and --jitter 1e-3.
SPRITES_M4_L_CHARACTER = 36
SPRITES_M4_ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs",
                   "--synthetic", "--synthetic_chars", str(SERVE_CHARS),
                   "--opt_regime", "joint-1", "--eval_every", "1",
                   "--nr_epochs_repr_nn", "1", "--m", "4", "--L_character",
                   str(SPRITES_M4_L_CHARACTER), "--device", "cuda",
                   "--seed", "0"]
MNIST_M256_ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs",
                   "--PCA", "--ip_joint", "--GP_joint", "--ov_joint",
                   "--dataset", "36", "--synthetic_digits", "--opt_regime",
                   "joint-1", "--eval_every", "1", "--nr_inducing_points",
                   "16", "--jitter", "1e-3", "--device", "cuda", "--seed",
                   "0"]
# Phase 13: the north-star MNIST run of phase 6, one epoch saved (an eval
# pass each epoch, so each writes a checkpoint), restored and resumed for
# one more; then the serves from its run dir and from phase 8's
SAVE_ARGV = ["--save", "--save_model_weights"]
# Phase 13's rechecks of the serves from a run hold the card to the larger
# of CPU_RTOL of max|.| and this multiple of the CPU's own fp32-vs-f64 gap
# (phase 7's RECHECK_FACTOR).  CPU_RTOL was set from the SPRITES fit's
# fp32 noise (~3e-6 of max|p_m|); the MNIST fit of a trained run is worse
# conditioned (Sigma's relative ridge allows cond ~1e5), and its fp32
# noise measured 1.1e-4 of max|p_m| on the CPU, above CPU_RTOL itself,
# with the card 9.6e-5 from the CPU fp32 twin (NVIDIA H100 80GB HBM3, 700
# W): a limit of CPU_RTOL there would pass or fail by chance.  For the
# SPRITES fit the multiple stays below CPU_RTOL.
RUN_FIT_NOISE_FACTOR = RECHECK_FACTOR
MNIST_SAVE_ARGV = [{"joint-2": "joint-1", "2": "1"}.get(a, a)
                   for a in TRAIN_ARGV]
MNIST_EPOCH_STEPS = TRAIN_STEPS // 2
# Phase 9(b): as phase 7, with the floor of a gradient at the round-off
# of the SPRITES step's longest sum (the decoder's output bias:
# 500 x 64 x 64 x 3 terms).
SPRITES_SUM_FLOOR = math.sqrt(500 * 64 * 64 * 3) * 2.0 ** -24
# Phase 14: the moving ball at the JAX driver's widths and defaults
# (batch 35, --tmax 30, 32x32 frames, hidden 500, --m 15, --jitter 1e-9);
# depth cut to 1,000 Hensman steps, 500 Titsias and 100 each of Pearce
# and NP, one eval each.  Phase 7's floor of a gradient is set by the
# step's longest sum: the loss over 35 x 30 x 32 x 32 pixels.
BALL_RUNS = {  # tag -> (argv, steps, B1 stack per step or None)
    "ball_hensman_train": (["--elbo", "SVGPVAE_Hensman", "--clip_qs",
                            "--entropy_ce"], 1000, (72, 15, 15)),
    "ball_titsias_train": (["--elbo", "SVGPVAE_Titsias", "--clip_qs"], 500,
                           (142, 15, 15)),
    "ball_pearce_train": (["--elbo", "GPVAE_Pearce"], 100, None),
    "ball_np_train": (["--elbo", "NP"], 100, None),
}
BALL_SUM_FLOOR = math.sqrt(35 * 30 * 32 * 32) * 2.0 ** -24
# Phase 15: the baselines at the drivers' widths (MNIST: batch 256, L = 16,
# M = 8, m = 32 on phase 6's 36-digit set; SPRITES: batch 500, L = 64 on
# phase 8's corpus), depth cut.  tag -> (driver, argv, steps, captured
# step, the longest sum of a captured step's gradient: its floor in
# phase 7's recheck).  No step of these runs reaches a port kernel, but
# the SVGPVAE run's joint epoch (32 steps), which launches B1 once per
# step.  Casale evaluates every 5 epochs (as the JAX driver), so its
# regime list ends in joint-3 for one eval; its captured step is a joint
# step, whose gradient sums over the full-train encode (8,100 images).
BASELINE_RUNS = {
    "mnist_vae_train": ("mnist", ["--elbo", "VAE", "--nr_epochs", "2",
                                  "--eval_every", "2", "--clip_qs"],
                        TRAIN_STEPS, CAPTURE_STEP, 256 * 28 * 28),
    "mnist_cvae_train": ("mnist", ["--elbo", "CVAE", "--nr_epochs", "2",
                                   "--eval_every", "2", "--clip_qs"],
                         TRAIN_STEPS, CAPTURE_STEP, 256 * 28 * 28),
    "svigp_train": ("mnist", ["--elbo", "SVIGP_Hensman", "--nr_epochs", "2",
                              "--eval_every", "2", "--PCA", "--ip_joint",
                              "--GP_joint", "--ov_joint"],
                    TRAIN_STEPS, CAPTURE_STEP, 256 * 28 * 28),
    "casale_train": ("mnist", ["--elbo", "GPVAE_Casale", "--opt_regime",
                               "VAE-1", "GP-1", "joint-3", "--PCA",
                               "--ov_joint", "--clip_qs"],
                     5 * TRAIN_STEPS // 2, 100, 8_100 * 28 * 28),
    "sprites_vae_train": ("sprites", ["--elbo", "VAE", "--clip_qs",
                                      "--synthetic", "--synthetic_chars",
                                      str(SERVE_CHARS), "--nr_epochs", "1",
                                      "--eval_every", "1"],
                          SPRITES_STEPS, SPRITES_CAPTURE,
                          500 * 64 * 64 * 3),
}
BASELINE_WIDTHS = {"mnist": (16, 8_100), "sprites": (64, 50_000)}  # L, N
# Phase 17: the --bf16 run's captured step is redone on the CPU with its
# nets in bf16 (the same state, batch and noise) in six character orders
# (as captured, reversed and BASELINE_PERMUTATIONS seeded ones) and once
# with its nets in fp32.  The card's loss and GECO state are held to the
# first bf16 run within RECHECK_FACTOR x the spread of the six, floored
# at phase 9(b)'s SPRITES_SUM_FLOOR of their magnitude.  The card's
# convolutions round their bf16 activations and gradients apart from the
# CPU's, as an independent implementation would: over every gradient the
# card sat 0.82 of the CPU's bf16-vs-fp32 distance from the CPU's bf16
# step, and up to 1.64 of it in one leaf (the decoder's first bias;
# median 0.80), where the CPU's six orders moved a leaf by 0.09 of it
# (median; at most 0.24; this phase on an NVIDIA H100 80GB HBM3, 700 W).
# So each gradient is held in the Frobenius norm (a gradient of a bf16
# layer is a bf16 number, one rounding moves an entry by a whole bf16
# ulp, and a maximum would let it set the result) within
# BF16_LEAF_FACTOR x that leaf's CPU bf16-vs-fp32 distance: two
# independent roundings sit sqrt(2) x one apart, and a factor of 2 covers
# the spread of a small leaf's norm.  And all gradients together must
# sit nearer the CPU's bf16 step than its fp32 step (the card: 486
# against 822), which a card that ran the nets in fp32 would not.
BF16_LEAF_FACTOR = 2.0 * math.sqrt(2.0)
# Hensman + GECO with a VAE phase: phase 6's run, --opt_regime VAE-1 joint-1
VAE_PHASE_ARGV = [x for a in TRAIN_ARGV
                  for x in (["VAE-1", "joint-1"] if a == "joint-2" else [a])]


# Phase 18: --data_parallel on the one card, every rank a process and the
# ranks sharing the card through gloo (SVGPVAE_RANKS_PER_DEVICE): a
# correctness run, not a scaling one.  (a) Phase 6's run over 2 ranks (128
# rows a rank; the tail batch of 164 rows replicated), against phase 6's
# 1-process run; the yardstick of its reordering is the same run in
# float64 (--x64, the plain path), whose draws are phase 6's fp32 draws.
# (b) Phase 8's widths and flags over 4 ranks at batch 500 (125 frames a
# rank: ranks 1-3 start inside a character) on a DP_SPRITES_CHARS-
# character corpus (4 steps, then the eval pass with its fit sharded),
# against the same run in 1 process; the yardstick is the largest gap
# between two of YARD_RUNS 1-process runs (hold_to_yard), which cost less
# than a run over 2 ranks (~25 s of spawned ranks).  The 4-rank run's
# captured step (the global batch and draws, the gradients summed across
# ranks) is also redone on the CPU as phases 7 and 9(b) do, as is 18(a)'s.
# (c) Phase 13(c)'s serve of phase 8's run dir on that corpus over 2 ranks
# (1,000 train rows a rank: phase 4's 2.4 GB of frames would take most of
# the part's time to reach the spawned rank), held to the CPU twin under
# phase 13's rule and printed beside the 1-process serve.
# The runs' per-step losses, GECO state, final parameters and eval rows
# are held as hold_to_cpu_gap holds a step, with the parameters' floor at
# two Adam steps (DP_PARAM_FLOOR_STEPS x lr): an entry whose gradient is
# round-off may step either way.
DP_SPRITES_CHARS = 40
DP_SPRITES_CAPTURE = 2
DP_PARAM_FLOOR_STEPS = 2
DP_LR = 1e-3  # both drivers' default --lr


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return " | ".join(out)  # one line a card


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() over reps launches (CUDA events), after
    one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 50) -> float:
    """Device time of fn() per call, from one CUDA-graph replay of `reps`
    captured calls (back-to-back kernels with no host dispatch between
    them), CUDA events around the replay."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float) -> tuple:
    """(least ms on an H100, "operations" or "bytes"): the larger of the
    work over the fp32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = 1e3 * flops / PEAK_FP32, 1e3 * nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def stats_bound(n, m, L, d1=0, d2=0, fused=False) -> tuple:
    """B2 executes the upper triangle of each Sigma_l (m(m+1)/2 FMA per
    row and channel) and r (m FMA); B3 also builds K from d1 + d2
    features.  Bytes: each input read once, each output written once."""
    flops = n * L * m * (m + 1) + 2 * n * m * L
    nbytes = 4 * (2 * n * L + L * m * m + L * m)
    if fused:
        flops += 2 * n * m * (d1 + d2)
        nbytes += 4 * (n + m) * (d1 + d2)
    else:
        nbytes += 4 * n * m
    return bound(flops, nbytes)


def chol_inverse_bound(B, m) -> tuple:
    """In-place Gauss-Jordan: m pivots x m x m FMA per matrix; reads M,
    writes M^-1 and logdet."""
    return bound(2 * B * m ** 3, 4 * (2 * B * m * m + B))


def stats_inputs(rng, n, m, L, d1, d2, family):
    """Features, inducing features, prec and py in the serving ranges:
    prec = 1/var with var clipped to [1e-3, 10], py = prec * mean."""
    if family == "mnist":
        f1 = rng.rand(n, 1) * 2 * np.pi
        ip1 = rng.rand(m, 1) * 2 * np.pi
    else:
        f1 = rng.normal(0, 1.5, (n, d1))
        ip1 = rng.normal(0, 1.5, (m, d1))
    f2 = rng.rand(n, d2) * 0.5
    ip2 = rng.normal(0, 1.5, (m, d2))
    var = np.clip(np.exp(rng.normal(0, 2, (n, L))), 1e-3, 10.0)
    prec = 1.0 / var
    py = prec * rng.normal(0, 1, (n, L))
    return [np.ascontiguousarray(a, np.float32)
            for a in (f1, f2, ip1, ip2, prec, py)]


OUTPUTS = ("Sigma", "r")


def output_errs(got, want) -> list:
    """(max abs error, max abs twin) of each output, Sigma then r."""
    return [(float((g - w).abs().max()), float(w.abs().max()))
            for g, w in zip(got, want)]


def phase_kernels(device) -> list:
    import torch
    from svgpvae_tpu_torch.ops import fused_kernel_stats as fks
    from svgpvae_tpu_torch.ops import gp_stats as gps

    rng = np.random.RandomState(0)
    records = []
    cases = [("fused_kernel_stats", "sprites", False),
             ("fused_kernel_stats", "sprites", True),
             ("fused_kernel_stats", "mnist", False),
             ("fused_kernel_stats", "mnist", True),
             ("gp_sufficient_stats", "sprites", False)]
    for shape_name, shape, shape_cases in (
            ("slice", SLICE, cases), ("ragged", RAGGED, cases),
            ("mnist_fit", MNIST_FIT, [c for c in cases if c[1] == "mnist"]),
            ("sprites_m288_fit", SPRITES_M288_FIT, cases[:1]),
            ("dp_rank_fit", DP_RANK_FIT, [cases[0], cases[4]])):
        for name, family, normalize in shape_cases:
            arrs = stats_inputs(rng, family=family, **shape)
            f1, f2, ip1, ip2, prec, py = (torch.from_numpy(a).to(device)
                                          for a in arrs)
            amp, ls = (0.9, 1.3) if family == "mnist" else (None, None)
            if name == "gp_sufficient_stats":
                knm = fks.fused_kernel_matrix(f1, f2, ip1, ip2, amp, ls,
                                              family, normalize).contiguous()
                run = lambda: gps.gp_sufficient_stats(knm, prec, py)
                twin = lambda: gps.gp_sufficient_stats_reference(knm, prec,
                                                                 py)
            else:
                run = lambda: fks.fused_kernel_stats(
                    f1, f2, ip1, ip2, prec, py, amp, ls, family, normalize)
                twin = lambda: fks.fused_kernel_stats_reference(
                    f1, f2, ip1, ip2, prec, py, amp, ls, family, normalize)
            got = run()
            torch.cuda.synchronize()
            want = twin()
            errs = output_errs(got, want)
            ok = all(bool(np.isfinite(e)) and e <= KERNEL_RTOL * scale
                     for e, scale in errs)
            err = max(e for e, _ in errs)
            ms = cuda_ms(run)
            plain_ms = cuda_ms(twin)
            # the kernels line's shapes: the serve fits' (the sprites
            # family with and without normalize, the mnist family at the
            # MNIST fit), phase 10's m = 288 eval fit and phase 18's fit
            # share of a rank
            in_line = ((shape_name == "slice" and family == "sprites")
                       or shape_name in ("mnist_fit", "sprites_m288_fit",
                                         "dp_rank_fit"))
            dev_ms = graph_ms(run, reps=20) if in_line else None
            library_ms = None
            if name == "gp_sufficient_stats":
                library_ms = cuda_ms(lambda: torch.einsum(
                    "nl,nm,np->lmp", prec, knm, knm))
            tag = f"{name}[{family},normalize={normalize}] {shape_name} {shape}"
            b_ms, b_by = stats_bound(fused=name == "fused_kernel_stats",
                                     **shape)
            log(f"{tag}: " + "; ".join(
                f"{o} max_abs_err {e:.3e} (max|twin| {scale:.3e}, limit "
                f"{KERNEL_RTOL * scale:.3e})"
                for o, (e, scale) in zip(OUTPUTS, errs))
                + f"; kernel {ms:.4f} ms"
                + ("" if dev_ms is None
                   else f" ({dev_ms:.4f} ms of device time in a graph replay)")
                + f", twin {plain_ms:.4f} ms"
                + ("" if library_ms is None
                   else f", library einsum {library_ms:.4f} ms")
                + f", bound {b_ms:.6f} ms ({b_by})")
            if not ok:
                raise AssertionError(f"{tag}: kernel disagrees with its twin")
            records.append(dict(
                name=name, family=family, normalize=normalize,
                shape=shape_name, dims=shape, max_abs_err=err, ms=ms,
                graph_ms=dev_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound=(b_ms, b_by)))
    return records


def phase_train_stats(device) -> None:
    """B2 against its twin at the training shapes (K built by the
    mnist- or sprites-family kernel from random features), with the
    regime its launch plan picks."""
    import torch
    from svgpvae_tpu_torch.ops import fused_kernel_stats as fks
    from svgpvae_tpu_torch.ops import gp_stats as gps

    rng = np.random.RandomState(1)
    for tag, family, shape in TRAIN_STATS:
        f1, f2, ip1, ip2, prec, py = (
            torch.from_numpy(a).to(device)
            for a in stats_inputs(rng, family=family, **shape))
        amp, ls = (1.0, 1.0) if family == "mnist" else (None, None)
        knm = fks.fused_kernel_matrix(f1, f2, ip1, ip2, amp, ls,
                                      family).contiguous()
        got = gps.gp_sufficient_stats(knm, prec, py)
        torch.cuda.synchronize()
        errs = output_errs(got, gps.gp_sufficient_stats_reference(
            knm, prec, py))
        ms = cuda_ms(lambda: gps.gp_sufficient_stats(knm, prec, py))
        plain_ms = cuda_ms(lambda: gps.gp_sufficient_stats_reference(
            knm, prec, py))
        library_ms = cuda_ms(lambda: torch.einsum("nl,nm,np->lmp", prec,
                                                  knm, knm))
        dev_ms = graph_ms(lambda: gps.gp_sufficient_stats(knm, prec, py))
        b_ms, b_by = stats_bound(**shape)
        plan = gps.launch_plan(shape["n"], shape["m"], shape["L"], device)
        log(f"gp_sufficient_stats {tag} {shape}, plan {list(plan)} "
            f"({'one launch' if plan[0] == 0 else f'{plan[0]} chunks + reduce'}"
            f"): " + "; ".join(
            f"{o} max_abs_err {e:.3e} (max|twin| {sc:.3e})"
            for o, (e, sc) in zip(OUTPUTS, errs))
            + f"; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms of device "
            f"time in a graph replay), twin {plain_ms:.4f} ms, library "
            f"einsum {library_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        if not all(np.isfinite(e) and e <= KERNEL_RTOL * sc
                   for e, sc in errs):
            raise AssertionError(f"gp_sufficient_stats {tag}: kernel "
                                 "disagrees with its twin")


def phase_occupancy(device) -> None:
    """Registers and local memory per thread and resident blocks per SM
    of every kernel variant the main paths launch, B3's K-build kernel
    included (cudaFuncGetAttributes and
    cudaOccupancyMaxActiveBlocksPerMultiprocessor, through the library)."""
    from svgpvae_tpu_torch.ops import chol_inverse as ci
    from svgpvae_tpu_torch.ops import gp_stats as gps
    rows = {}
    for tag, n, m, L in (("single launch", 256, 32, 16),
                         ("small-m chunks + reduce", 8_100, 32, 16),
                         ("partial sums + reduce", 50_000, 72, 64)):
        rows[f"gp_sufficient_stats {tag} {(n, m, L)}"] = gps.kernel_info(
            n, m, L, device)
    b3 = ("fused_kernel_stats K build + partial sums + reduce, cluster "
          "size 1 (no thread-block clusters) (50000, 72, 64)")
    rows[b3] = gps.kernel_info(50_000, 72, 64, device, SLICE["d1"],
                               SLICE["d2"])
    for B, m in ((17, 32), (33, 32), (72, 15), (142, 15), (5, 37), (65, 72),
                 (129, 72),
                 (17, 256), (65, 288)):
        info = ci.kernel_info(B, m, device)
        rows[f"chol_inverse {info['form']} form {(B, m, m)}"] = info
    log("kernel variants (registers and local bytes per thread, resident "
        "blocks per SM): " + json.dumps(rows))


def pd_stack(rng, B, m, cond):
    out = np.empty((B, m, m))
    for i in range(B):
        q, _ = np.linalg.qr(rng.randn(m, m))
        out[i] = (q * np.logspace(0, np.log10(cond), m)) @ q.T
    return out.astype(np.float32)


def phase_chol_inverse(device) -> list:
    """B1 against its Cholesky twin on the card, at every shape of
    B1_SHAPES; returns one record per shape, the training shape
    (17, 32, 32) first."""
    import torch
    from svgpvae_tpu_torch.ops import chol_inverse as ci

    rng = np.random.RandomState(2)
    records = []
    for tag, B, m, cond in B1_SHAPES:
        M = torch.from_numpy(pd_stack(rng, B, m, cond)).to(device)
        form = ci.kernel_info(B, m, device)["form"]
        inv, ld = ci.chol_inverse_kernel(M)
        torch.cuda.synchronize()
        inv_t, ld_t = ci.chol_inverse_reference(M)
        scale = float(inv_t.abs().max())
        inv_err = float((inv - inv_t).abs().max())
        ld_rel = float(((ld - ld_t).abs() / ld_t.abs().clamp(min=1e-30))
                       .max())
        ld_rtol = 1e-4 if m >= 72 else 1e-5
        ms = cuda_ms(lambda: ci.chol_inverse_kernel(M), reps=50)
        plain_ms = cuda_ms(lambda: ci.chol_inverse_reference(M), reps=50)
        dev_ms = graph_ms(lambda: ci.chol_inverse_kernel(M))
        b_ms, b_by = chol_inverse_bound(B, m)
        log(f"chol_inverse {tag} (B, m) = ({B}, {m}), {form} form, cond "
            f"{cond:.0e}: inverse max_abs_err {inv_err:.3e} (max|twin| "
            f"{scale:.3e}, limit {B1_INV_TOL * scale:.3e}); logdet max rel "
            f"err {ld_rel:.3e} (limit {ld_rtol:.0e}); kernel {ms:.4f} ms per "
            f"call ({dev_ms:.4f} ms of device time in a graph replay), "
            f"twin {plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
        if not (inv_err <= B1_INV_TOL * scale and ld_rel <= ld_rtol):
            raise AssertionError(f"chol_inverse {tag}: kernel disagrees "
                                 "with its twin")
        records.append(dict(shape=tag, form=form, dims=dict(B=B, m=m),
                            max_abs_err=inv_err, ms=ms, plain_ms=plain_ms,
                            graph_ms=dev_ms, bound=(b_ms, b_by)))
    return records


def phase_b1_one_call(device) -> None:
    """B1 on a Titsias stack [K_mm; Sigma_1..L; Sigma1_1..L] in one call
    (the port's gp_block_titsias) against [K_mm; Sigma_1..L] and
    [Sigma1_1..L] in two calls (the JAX package's split, which exists for
    the TPU's VMEM): every form treats each matrix of a stack alone, so
    the inverses and logdets must be the same bits."""
    import torch
    from svgpvae_tpu_torch.ops import chol_inverse as ci

    rng = np.random.RandomState(3)
    for L, m, cond in ((16, 32, 1e4), (64, 72, 1e3)):
        M = torch.from_numpy(pd_stack(rng, 2 * L + 1, m, cond)).to(device)
        one = ci.chol_inverse_kernel(M)
        two = [torch.cat(x) for x in zip(ci.chol_inverse_kernel(M[:L + 1]),
                                         ci.chol_inverse_kernel(M[L + 1:]))]
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(one, two)]
        ms_one = cuda_ms(lambda: ci.chol_inverse_kernel(M), reps=50)
        ms_two = cuda_ms(lambda: (ci.chol_inverse_kernel(M[:L + 1]),
                                  ci.chol_inverse_kernel(M[L + 1:])),
                         reps=50)
        log(f"chol_inverse {(2 * L + 1, m, m)} in one call vs "
            f"{(L + 1, m, m)} + {(L, m, m)} in two: inverse identical "
            f"{same[0]}, logdet identical {same[1]}; one call {ms_one:.4f} "
            f"ms, two calls {ms_two:.4f} ms")
        if not all(same):
            raise AssertionError(f"chol_inverse at m = {m}: one call and "
                                 "two calls disagree")


def check_finite(**tensors) -> None:
    for name, t in tensors.items():
        if not bool(t.isfinite().all()):
            raise AssertionError(f"{name} has non-finite values")


def phase_serve() -> tuple:
    """The serve twice (B3 path, then the --K_SE B2 path); returns both
    runs' results, the launch counts of the whole phase and the corpus."""
    from svgpvae_tpu_torch import data
    from svgpvae_tpu_torch import ops
    from svgpvae_tpu_torch.cli import serve

    t0 = time.perf_counter()
    splits = data.generate_synthetic_sprites(
        n_train_chars=SERVE_CHARS, n_test_chars=SERVE_CHARS // 4,
        n_frames_train=50, seed=serve.CORPUS_SEED)
    log(f"corpus: {len(splits['train']['frames'])} train frames, "
        f"{len(splits['test_character']['frames'])} unseen-character "
        f"frames, generated in {time.perf_counter() - t0:.1f} s")
    argv = ["--synthetic", "--synthetic_chars", str(SERVE_CHARS),
            "--n_requests", str(SERVE_REQUESTS), "--device", "cuda",
            "--seed", "0"]

    ops.reset_launch_counts()
    results = {}
    for name, extra, kernel in (("linear", [], "fused_kernel_stats"),
                                ("K_SE", ["--K_SE"], "gp_sufficient_stats")):
        res = serve.main(argv + extra, splits=splits)
        st = res["state"]
        pred = st["predictor"]
        m, L = pred.gp_params.inducing_points.shape[0], st["means"].shape[1]
        if (len(st["means"]), m, L) != (50 * SERVE_CHARS, 72, 64):
            raise AssertionError(f"served N={len(st['means'])}, m={m}, L={L}")
        if len(st["served"]) != SERVE_REQUESTS:
            raise AssertionError("not every request was answered")
        for i, req in enumerate(st["served"]):
            check_finite(**{f"{name} request {i} {k}": v
                            for k, v in req.items()})
        check_finite(mean_terms=pred.mean_terms, sigma_inv=pred.sigma_inv)
        sec = res["seconds"]
        log(f"serve[{name}]: encode {sec['encode']:.3f} s, fit "
            f"{sec['fit']:.4f} s, requests "
            f"{', '.join(f'{1e3 * t:.2f}' for t in sec['requests'])} ms, "
            f"cgen MSE {res['cgen_mse']:.6f}, launches in fit "
            f"{res['fit_launches']}")
        if res["fit_launches"][kernel] < 1:
            raise AssertionError(f"serve[{name}]: the fit did not launch "
                                 f"{kernel}")
        results[name] = res
    launches = ops.launch_counts()
    log(f"serve main-path launches: {launches}")
    return results, launches, splits


def phase_cpu_check(name, res, noise_factor=None) -> None:
    """Redo one serve's fit and its first request's p_m/p_v on the CPU
    with the plain twins (fp32), and in float64 as the yardstick of fp32
    noise.  The card is held to CPU_RTOL of max|.|, or with
    `noise_factor` to the larger of that and noise_factor x the CPU's own
    fp32-vs-f64 gap (phase 13: see RUN_FIT_NOISE_FACTOR)."""
    import torch
    from svgpvae_tpu_torch import gp as gpm
    from svgpvae_tpu_torch.models import PVAR_CLIP

    st = res["state"]
    gp_gpu = st["predictor"].gp_params
    req = st["served"][0]
    inputs = [st[k].cpu() for k in ("means", "variances", "aux")]
    aux_q = req["aux_query"].cpu()
    got = {"p_m": req["p_m"].cpu().double(), "p_v": req["p_v"].cpu().double()}
    ref = {}
    for dtype in (torch.float32, torch.float64):
        gp = gp_gpu.to("cpu", dtype)
        t0 = time.perf_counter()
        terms = gpm.precompute_test_posterior_terms(
            gp, *(x.to(dtype) for x in inputs))
        p_m, p_v = gpm.posterior_from_precomputed(gp, aux_q.to(dtype),
                                                  *terms)
        ref[dtype] = {"p_m": p_m.double(),
                      "p_v": torch.clamp(p_v, *PVAR_CLIP).double()}
        log(f"cpu fit [{name}] ({dtype}): "
            f"{time.perf_counter() - t0:.2f} s")
    for k in ("p_m", "p_v"):
        scale = float(ref[torch.float64][k].abs().max())
        err = float((got[k] - ref[torch.float32][k]).abs().max())
        noise = float((ref[torch.float32][k]
                       - ref[torch.float64][k]).abs().max())
        err64 = float((got[k] - ref[torch.float64][k]).abs().max())
        limit = max(CPU_RTOL * scale, (noise_factor or 0.0) * noise)
        log(f"[{name}] {k}: card vs cpu fp32 twin {err:.3e}, card vs cpu f64 "
            f"{err64:.3e}, cpu fp32 vs f64 {noise:.3e} (max|{k}| "
            f"{scale:.3e}, limit {limit:.3e})")
        if not err <= limit:
            raise AssertionError(f"[{name}] {k}: the card's fit disagrees "
                                 "with the CPU twins")


def mnist_splits() -> dict:
    """The rotated 36-digit set of phases 6 and 10, in memory."""
    from svgpvae_tpu_torch import data
    t0 = time.perf_counter()
    base = data.synthetic_digit_base_images("36", per_digit=400, seed=0)
    splits = data.generate_rotated_mnist(base, None, digits="36", seed=0)
    log(f"rotated 36-digit set: {len(splits['train']['images'])} train, "
        f"{len(splits['eval']['images'])} eval, "
        f"{len(splits['test']['images'])} test frames, generated in "
        f"{time.perf_counter() - t0:.1f} s")
    return splits


def phase_train(splits, argv=TRAIN_ARGV, m=32, steps=TRAIN_STEPS,
                capture=CAPTURE_STEP, tag="train", b2_per_step=None) -> tuple:
    """An MNIST training run on the card (the north-star run of phase 6,
    phase 10's at m = 256, or phase 11's Titsias run); returns its result
    and the launch counts of the whole run.  Every step must launch B1
    once, and B2 `b2_per_step` times (None: at least once)."""
    import torch
    from svgpvae_tpu_torch import ops
    from svgpvae_tpu_torch.cli import mnist

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = mnist.main(argv, splits=splits, capture_step=capture)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    st = res["state"]
    gp = st.params["gp"]
    dims = (len(splits["train"]["images"]), gp.inducing_points.shape[0],
            gp.object_vectors.shape[0], st.params["vae"].L)
    if dims != (8_100, m, 800, 16) or len(res["step_seconds"]) != steps:
        raise AssertionError(f"trained N, m, n_objects, L = {dims} over "
                             f"{len(res['step_seconds'])} steps")
    for i, mt in enumerate(res["metrics"]):
        if not all(np.isfinite(v) for v in mt.values()):
            raise AssertionError(f"step {i}: non-finite metrics {mt}")
    ev = res["evals"][-1]
    if not all(np.isfinite(ev[k]) for k in ("eval_mse", "test_mse",
                                            "cgen_mse")):
        raise AssertionError(f"non-finite eval pass {ev}")
    check_finite(**{f"gp/{k}": v for k, v in gp.named_tensors().items()})
    for i, sl in enumerate(res["step_launches"]):
        b2 = sl["gp_sufficient_stats"]
        if sl["chol_inverse"] != 1 or not (
                b2 >= 1 if b2_per_step is None else b2 == b2_per_step):
            raise AssertionError(
                f"step {i} launched {sl}: chol_inverse must launch once, "
                "gp_sufficient_stats " + ("at least once" if b2_per_step
                                          is None else f"{b2_per_step} "
                                          "times"))
    sec = np.asarray(res["step_seconds"])
    in_steps = {k: sum(sl[k] for sl in res["step_launches"])
                for k in launches}
    log(f"{tag}: {steps} steps; first step {1e3 * sec[0]:.2f} ms, "
        f"then p50 {1e3 * np.percentile(sec[1:], 50):.3f} ms, p90 "
        f"{1e3 * np.percentile(sec[1:], 90):.3f} ms; eval MSE "
        f"{ev['eval_mse']:.6f}, test MSE {ev['test_mse']:.6f}, cgen MSE "
        f"{ev['cgen_mse']:.6f} (eval+test {ev['seconds']['eval_test']:.3f} "
        f"s, cgen {ev['seconds']['cgen']:.3f} s); max_memory_allocated "
        f"{peak / 2**20:.1f} MiB; launches inside the steps {in_steps}, "
        f"in the whole run {launches}")
    return res, launches


def loss_magnitudes(out, loss, args) -> float:
    """The magnitudes a step's loss is the difference of, the scale of its
    fp32 round-off: under GECO the loss is -kl_term + lambda * recon / b
    with kl_term = inside-ELBO - CE term (|inside-ELBO| + |CE term| +
    |loss|); the plain objective's is recon - (beta / L) * kl_term
    (|recon| + beta / L * (|inside-ELBO| + |CE term|) + |loss|)."""
    inside, ce, recon, loss = (abs(float(t.detach())) for t in (
        out.inside_elbo, out.ce_term, out.recon_loss, loss))
    if args.GECO:
        return inside + ce + loss
    return recon + args.beta / args.L * (inside + ce) + loss


def mnist_recheck_args(argv):
    """The parsed `argv` of an MNIST run on the card, its `auto` block
    resolved as the card resolved it."""
    import torch
    from svgpvae_tpu_torch import models
    from svgpvae_tpu_torch.cli import mnist
    args = mnist.build_parser().parse_args(argv)
    args.gp_block_impl = models.resolve_gp_block_impl(
        args.gp_block_impl, titsias=args.elbo == "SVGPVAE_Titsias",
        device=torch.device("cuda"))
    return args


def redo_mnist_step(res, args, dtype, order=None, device="cpu",
                    b1=None) -> tuple:
    """The captured step of the MNIST run `res` redone eagerly on `device`
    (the CPU: the twins) in `dtype`, the batch in its order or in `order`,
    B1's (M^-1, log det M) taken from `b1` in place of its route (None:
    the kernel on the card, the Cholesky twin on the CPU).  Returns its
    loss, GECO state and gradients (float64, on the CPU), the forward
    pass's outputs, and the loss's magnitudes."""
    import torch
    from svgpvae_tpu_torch import gp as gpm, train
    from svgpvae_tpu_torch.cli import mnist
    from svgpvae_tpu_torch.nn import MnistVAE
    from svgpvae_tpu_torch.ops import chol_inverse as ci

    cap = res["captured"]

    def put(t):
        return t.detach().to(device, dtype)
    vae = MnistVAE(L=args.L)
    vae.load_state_dict({k: put(v) for k, v in cap["vae"].items()})
    gp = gpm.MnistSVGP(config=res["state"].params["gp"].config,
                       **{k: put(v) for k, v in cap["gp"].items()})
    params = {"vae": vae.to(device, dtype), "gp": gp}
    trainable = train.trainable_tensors(params, lambda name: True)
    def put_b(t):  # a batch-axis tensor, in its order or `order`
        return put(t) if order is None else put(t)[order.to(device)]
    batch = tuple(put_b(x) for x in cap["batch"])
    eps = put_b(cap["eps"])
    forward, outs = mnist.make_forward(args, lambda kind, shape: eps), []

    def recording(*a, **kw):
        outs.append(forward(*a, **kw))
        return outs[-1]

    route = ci.chol_inverse_kernel
    ci.chol_inverse_kernel = b1 or route
    try:
        loss, (geco, _) = mnist.make_loss_fn(args, recording)(
            params, batch, train.GECOState(
                C_ma=put(cap["geco"].C_ma),
                lagrange_mult=put(cap["geco"].lagrange_mult)), cap["step"])
        grads = torch.autograd.grad(loss, list(trainable.values()))
    finally:
        ci.chol_inverse_kernel = route
    out = {"loss": loss.detach(), "C_ma": geco.C_ma,
           "lagrange_mult": geco.lagrange_mult,
           **dict(zip(trainable, grads))}
    return ({k: v.detach().cpu().double() for k, v in out.items()},
            outs[-1], loss_magnitudes(outs[-1], loss, args))


def train_cpu_steps(res, argv=TRAIN_ARGV) -> tuple:
    """Redo the captured step of the MNIST run made with `argv` on the CPU
    with the twins: in fp32 with the batch in its order, reversed and in
    BASELINE_PERMUTATIONS seeded orders (the step's sums are
    order-invariant, so these differ by fp32 round-off alone), then in
    each of those orders again with B1's Cholesky twin replaced by the
    kernel's own method (plain Gauss-Jordan; see RECHECK_FACTOR), and in
    f64.  Returns (the card's values, the fp32 run in order, the other
    fp32 runs by name, the f64 run, the loss's magnitudes)."""
    import torch
    from svgpvae_tpu_torch.ops import chol_inverse as ci
    cap = res["captured"]
    args = mnist_recheck_args(argv)
    got = {"loss": cap["loss"], "C_ma": cap["geco_after"].C_ma,
           "lagrange_mult": cap["geco_after"].lagrange_mult, **cap["grads"]}
    b = cap["batch"][0].shape[0]
    gen = torch.Generator().manual_seed(0)
    orders = {"in order": None, "reversed": torch.arange(b - 1, -1, -1),
              **{f"order {i + 1}": torch.randperm(b, generator=gen)
                 for i in range(BASELINE_PERMUTATIONS)}}
    runs = {**{k: (o, None) for k, o in orders.items() if o is not None},
            **{f"Gauss-Jordan {k}": (o, ci.gauss_jordan_reference)
               for k, o in orders.items()}}
    t0 = time.perf_counter()
    r32 = redo_mnist_step(res, args, torch.float32)[0]
    r32_more = {name: redo_mnist_step(res, args, torch.float32, o,
                                      b1=b1)[0]
                for name, (o, b1) in runs.items()}
    r64, _, loss_terms = redo_mnist_step(res, args, torch.float64)
    log(f"cpu step {cap['step']} (fp32 {1 + len(runs)} times, f64): "
        f"{time.perf_counter() - t0:.2f} s")
    return got, r32, r32_more, r64, loss_terms


def phase_train_cpu_check(res, argv=TRAIN_ARGV) -> None:
    """Phase 7: the card's captured step held to train_cpu_steps' CPU
    runs (hold_to_cpu_gap)."""
    got, r32, r32_more, r64, loss_terms = train_cpu_steps(res, argv)
    hold_to_cpu_gap(f"step {res['captured']['step']}", got, r32,
                    list(r32_more.values()), r64, loss_terms, SUM_FLOOR)


def hold_to_cpu_gap(tag, got, r32, r32_more, r64, loss_terms,
                    sum_floor, names=("card", "cpu fp32", "cpu f64"),
                    floors=None) -> None:
    """The card's loss, GECO state and gradients (`got`) against the CPU
    fp32 twin `r32` (the batch in its order), each within RECHECK_FACTOR x
    the largest fp32-vs-f64 gap of the CPU's orderings (`r32` and the list
    `r32_more`), floored (see RECHECK_FACTOR).  Phase 18 holds whole runs
    the same way (`names` label the three, `floors` sets a key's floor
    outright)."""
    gaps = {k: max(float((r[k] - r64[k]).abs().max())
                   for r in [r32] + r32_more) for k in got}
    hold_within(tag, got, r32, r64, gaps, loss_terms, sum_floor, names,
                floors)


def hold_limit(k, gap, scale, sum_floor, floors=None) -> float:
    """hold_within's limit for the value `k`: RECHECK_FACTOR x its
    yardstick `gap`, floored at FP32_ULP (the loss and GECO state) or
    `sum_floor` of its `scale` (`floors` sets a key's floor outright)."""
    floor = (floors or {}).get(k, (FP32_ULP if k in ("loss", "C_ma",
                                                     "lagrange_mult")
                                   else sum_floor) * scale)
    return RECHECK_FACTOR * max(gap, floor)


def hold_within(tag, got, ref, other, gaps, loss_terms, sum_floor, names,
                floors=None) -> None:
    """`got` against `ref`, each value within RECHECK_FACTOR x its
    yardstick `gaps[k]`, floored (see RECHECK_FACTOR) at FP32_ULP (the
    loss and GECO state) or `sum_floor` of its scale: `loss_terms` for the
    loss, max|other[k]| else, where `other` is a yardstick run, printed
    beside (`floors` sets a key's floor outright)."""
    rows = []
    a, b, c = names
    for k, g in got.items():
        g = g.detach().cpu().double()
        scale = loss_terms if k == "loss" else float(other[k].abs().max())
        err = float((g - ref[k]).abs().max())
        limit = hold_limit(k, gaps[k], scale, sum_floor, floors)
        rows.append((k, err, limit))
        log(f"{tag} {k}: {a} vs {b} {err:.3e}, {b} "
            f"vs {c} {gaps[k]:.3e}, max|.| {scale:.3e}, limit {limit:.3e}"
            + (f"; {a} {float(g):.9g}, {b} {float(ref[k]):.9g}, "
               f"{c} {float(other[k]):.12g}" if g.numel() == 1 else ""))
    bad = [k for k, err, limit in rows if not err <= limit]
    if bad:
        raise AssertionError(f"{tag}: the {a} disagrees with the {b} "
                             f"on {bad}")
    # a limit of 0 is the GECO state of the plain objective: 0 and 1,
    # passed through untouched (and held to equality above)
    what = (f"{len(got) - 3} gradients and the loss/GECO within "
            f"{RECHECK_FACTOR:g}x the cpu fp32-vs-f64 gap" if c == "cpu f64"
            else f"{len(got)} values within {RECHECK_FACTOR:g}x the {b} vs "
            f"{c} gap")
    log(f"{tag}: {what} (floored); worst err/limit "
        f"{max(err / limit for _, err, limit in rows if limit):.3f}")


def phase_sprites_train(splits, argv=SPRITES_ARGV, m=72, l_character=16,
                        pretrain_steps=SPRITES_PRETRAIN_STEPS,
                        capture=SPRITES_CAPTURE,
                        tag="sprites train", per_step=(2, 1)) -> tuple:
    """A SPRITES training run on the card (phase 8, phase 10's at m = 288,
    or phase 12's Titsias run); returns its result and the launch counts
    of the whole run.  Every step must launch B1 and B2 `per_step` times
    and B3 never; the eval pass's fit B3 once (its normalize variant
    under --object_kernel_normalize)."""
    import torch
    from svgpvae_tpu_torch import ops, train
    from svgpvae_tpu_torch.cli import sprites

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = sprites.main(argv, splits=splits, capture_step=capture)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    st = res["state"]
    gp, vae = st.params["gp"], st.params["vae"]
    m_run, d = gp.inducing_points.shape
    dims = (len(splits["train"]["frames"]), m_run, vae.L, gp.L_action,
            d - gp.L_action)
    if dims != (50 * SERVE_CHARS, m, 64, 8, l_character):
        raise AssertionError(f"trained N, m, L, L_action, L_character = "
                             f"{dims}")
    if (len(res["step_seconds"]) != SPRITES_STEPS
            or res["pretrain"]["steps"] != pretrain_steps):
        raise AssertionError(f"{res['pretrain']['steps']} pretraining and "
                             f"{len(res['step_seconds'])} main steps")
    for i, mt in enumerate(res["metrics"]):
        if not all(np.isfinite(v) for v in mt.values()):
            raise AssertionError(f"step {i}: non-finite metrics {mt}")
    for ep in res["pretrain"]["epochs"]:
        if not all(np.isfinite(v) for v in ep.values()):
            raise AssertionError(f"non-finite pretraining epoch {ep}")
    ev = res["evals"][-1]
    if not all(np.isfinite(ev[k]) for k in ("test_mse", "cgen_mse")):
        raise AssertionError(f"non-finite eval pass {ev}")
    check_finite(**train.named_tensors(st.params))
    for i, sl in enumerate(res["step_launches"]):
        if (sl["chol_inverse"], sl["gp_sufficient_stats"],
                sl["fused_kernel_stats"]) != (*per_step, 0):
            raise AssertionError(f"step {i} launched {sl}: chol_inverse "
                                 f"must launch {per_step[0]} times and "
                                 f"gp_sufficient_stats {per_step[1]}")
    normalize = "--object_kernel_normalize" in argv
    if gp.config.K_obj_normalize != normalize:
        raise AssertionError(f"K_obj_normalize {gp.config.K_obj_normalize}")
    in_eval = {k: sum(stage[k] for stage in ev["launches"].values())
               for k in launches}
    if ev["launches"]["fit"]["fused_kernel_stats"] != 1 or \
            in_eval["fused_kernel_stats"] != 1:
        raise AssertionError(f"the eval pass launched {ev['launches']}: "
                             "fused_kernel_stats must launch once, in the "
                             "fit")
    sec = np.asarray(res["step_seconds"])
    in_steps = {k: sum(sl[k] for sl in res["step_launches"])
                for k in launches}
    log(f"{tag}: B3 normalize {normalize}; {pretrain_steps} pretraining "
        f"steps in "
        f"{res['pretrain']['seconds']:.3f} s (test_action acc "
        f"{res['pretrain']['epochs'][0]['test_action_acc']:.4f} after the "
        f"first epoch); {SPRITES_STEPS} steps: first {1e3 * sec[0]:.2f} "
        f"ms, then p50 {1e3 * np.percentile(sec[1:], 50):.3f} ms, p90 "
        f"{1e3 * np.percentile(sec[1:], 90):.3f} ms; eval "
        + ", ".join(f"{k} {v:.3f} s" for k, v in ev["seconds"].items())
        + f"; test MSE {ev['test_mse']:.6f}, cgen MSE {ev['cgen_mse']:.6f};"
        f" max_memory_allocated {peak / 2**20:.1f} MiB; launches per step "
        f"{res['step_launches'][0]}, inside the steps {in_steps}, in the "
        f"eval pass {in_eval}, in the whole run {launches}")
    return res, launches


def _sprites_step_params(cap, card_gp, device, dtype):
    """The captured step's parameters as the port's modules and GP."""
    from svgpvae_tpu_torch import gp as gpm
    from svgpvae_tpu_torch.nn import SpritesReprNet, SpritesVAE

    snap = {k: v.detach().to(device, dtype) for k, v in cap["params"].items()}

    def part(name):
        return {k.split("/", 1)[1]: v for k, v in snap.items()
                if k.startswith(name + "/")}

    vae = SpritesVAE(L=snap["vae/enc_out.bias"].shape[0] // 2)
    vae.load_state_dict(part("vae"))
    repr_net = SpritesReprNet(L=snap["repr/convs.0.bias"].shape[0])
    repr_net.load_state_dict(part("repr"))
    gp = gpm.SpritesSVGP(config=card_gp.config, L_action=card_gp.L_action,
                         use_se_kernel=card_gp.use_se_kernel, **part("gp"))
    return {"vae": vae.to(device, dtype), "repr": repr_net.to(device, dtype),
            "gp": gp}


def sprites_step_stacks(res, argv=SPRITES_ARGV, m=72) -> list:
    """The captured step's two B1 input stacks, recomputed on the card
    from its inputs (printing its loss beside the captured one)."""
    import torch
    from svgpvae_tpu_torch import models
    from svgpvae_tpu_torch.cli import sprites
    from svgpvae_tpu_torch.gp import fused

    cap = res["captured"]
    device = cap["batch"][0].device
    args = sprites.build_parser().parse_args(argv)
    args.gp_block_impl = models.resolve_gp_block_impl(
        args.gp_block_impl, workload="sprites", device=device)
    params = _sprites_step_params(cap, res["state"].params["gp"], device,
                                  torch.float32)
    stacks, kernel = [], fused.chol_inverse

    def recording(M):
        stacks.append(M.detach().clone())
        return kernel(M)

    fused.chol_inverse = recording
    try:
        with torch.no_grad():
            loss, _ = sprites.make_loss_fn(args, sprites.make_forward(
                args, lambda kind, shape: cap["eps"]))(
                params, cap["batch"], cap["geco"], cap["step"])
    finally:
        fused.chol_inverse = kernel
    log(f"sprites step {cap['step']} recomputed on the card: loss "
        f"{float(loss):.9g}, as captured {float(cap['loss']):.9g}")
    if [tuple(M.shape) for M in stacks] != [(65, m, m), (64, m, m)]:
        raise AssertionError(f"B1 inputs {[tuple(M.shape) for M in stacks]}")
    return stacks


def phase_sprites_b1(res, argv=SPRITES_ARGV, m=72) -> None:
    """Phase 9(a): the captured step's two B1 input stacks through the
    kernel against a float64 inversion of the same fp32 stacks, within
    B1_REAL_FACTOR of the larger of the two fp32 witnesses' gaps to
    float64: the Cholesky twin and plain, unblocked Gauss-Jordan."""
    stacks = sprites_step_stacks(res, argv, m)
    hold_b1_on_stacks(res["captured"]["step"],
                      zip(("[K_mm; Sigma]", "A_hat + jitter"), stacks))


def hold_b1_on_stacks(step, tagged_stacks) -> None:
    """B1 on a training step's own input stacks against a float64
    inversion of the same fp32 stacks, within B1_REAL_FACTOR of the
    larger of the two fp32 witnesses' gaps to float64: the Cholesky twin
    and plain, unblocked Gauss-Jordan (see B1_REAL_FACTOR)."""
    import torch
    from svgpvae_tpu_torch.ops import chol_inverse as ci

    for tag, M in tagged_stacks:
        form = ci.kernel_info(*M.shape[:2], M.device)["form"]
        inv, ld = ci.chol_inverse_kernel(M)
        torch.cuda.synchronize()
        witnesses = {"Cholesky twin": ci.chol_inverse_reference(M.cpu()),
                     "plain Gauss-Jordan": ci.gauss_jordan_reference(M)}
        inv64, ld64 = ci.chol_inverse_reference(M.cpu().double())

        def gaps(i, l):
            i = i.cpu().double()
            rel = ((i - inv64).abs().amax(dim=(1, 2))
                   / inv64.abs().amax(dim=(1, 2))).max()
            return float(rel), float((l.cpu().double() - ld64).abs().max())

        floor = M.shape[-1] * 2.0 ** -24
        wit = {name: gaps(*w) for name, w in witnesses.items()}
        bad = []
        for q, (what, got, scale) in enumerate(zip(
                ("inverse (normalized)", "logdet"), gaps(inv, ld),
                (1.0, float(ld64.abs().max())))):
            limit = B1_REAL_FACTOR * max(floor * scale,
                                         *(g[q] for g in wit.values()))
            log(f"chol_inverse ({form} form) on step {step}'s {tag} "
                f"{tuple(M.shape)}: {what} kernel vs f64 {got:.3e}, "
                + ", ".join(f"{name} vs f64 {g[q]:.3e}"
                            for name, g in wit.items())
                + f", limit {limit:.3e}")
            if not (np.isfinite(got) and got <= limit):
                bad.append(what)
        if bad:
            raise AssertionError(f"chol_inverse on step {step}'s "
                                 f"{tag}: {bad} past the limit")


def sprites_cpu_step(res, args, dtype, order=None, nets=(None, None)):
    """The captured step of a SPRITES run redone on the CPU with the
    twins, its parameters in `dtype`, the nets at the compute dtypes
    `nets` (dtype, head dtype), the batch's characters taken in `order`
    (None: as captured; whole characters, so every segment mean is the
    same).  Under --clip_grad the gradients take the card's value clip.
    Returns ({loss, C_ma, lagrange_mult, every gradient}, the loss's
    magnitudes)."""
    import torch
    from svgpvae_tpu_torch import linalg, train
    from svgpvae_tpu_torch.cli import sprites

    cap = res["captured"]

    def cpu(t):
        return t.detach().to("cpu", dtype)

    def cpu_b(t):  # a batch-axis tensor, its characters in `order`
        t = cpu(t)
        if order is None:
            return t
        chars = t.view(-1, SPRITES_FPC, *t.shape[1:])[order]
        return chars.reshape(t.shape)
    params = _sprites_step_params(cap, res["state"].params["gp"],
                                  torch.device("cpu"), dtype)
    params["vae"].set_compute_dtype(*nets)
    params["repr"].set_compute_dtype(nets[0])
    trainable = train.trainable_tensors(
        params, sprites.trainable_predicate(args))
    batch = tuple(cpu_b(x) for x in cap["batch"])
    eps = cpu_b(cap["eps"])
    forward, outs = sprites.make_forward(args, lambda kind, shape: eps), []

    def recording(*a):
        outs.append(forward(*a))
        return outs[-1]

    loss, (geco, _) = sprites.make_loss_fn(args, recording)(
        params, batch, train.GECOState(
            C_ma=cpu(cap["geco"].C_ma),
            lagrange_mult=cpu(cap["geco"].lagrange_mult)), cap["step"])
    grads = torch.autograd.grad(loss, list(trainable.values()))
    if args.clip_grad:
        linalg.tree_value_clip(grads, args.clip_grad_thres)
    out = {"loss": loss.detach(), "C_ma": geco.C_ma,
           "lagrange_mult": geco.lagrange_mult,
           **dict(zip(trainable, grads))}
    terms = loss_magnitudes(outs[-1], loss, args)
    return {k: v.detach().double() for k, v in out.items()}, terms


def _card_step(cap) -> dict:
    return {"loss": cap["loss"], "C_ma": cap["geco_after"].C_ma,
            "lagrange_mult": cap["geco_after"].lagrange_mult,
            **cap["grads"]}


def phase_sprites_cpu_check(res, argv=SPRITES_ARGV) -> None:
    """Phase 9(b): the captured step of the SPRITES run made with `argv`
    redone on the CPU with the twins, in fp32 with the batch in its order
    and with its characters reversed, and in f64."""
    import torch
    from svgpvae_tpu_torch import models
    from svgpvae_tpu_torch.cli import sprites

    cap = res["captured"]
    args = sprites.build_parser().parse_args(argv)
    args.gp_block_impl = models.resolve_gp_block_impl(
        args.gp_block_impl, workload="sprites",
        titsias=args.elbo == "SVGPVAE_Titsias", device=torch.device("cuda"))
    got = _card_step(cap)
    n_chars = cap["batch"][0].shape[0] // SPRITES_FPC

    t0 = time.perf_counter()
    r32, _ = sprites_cpu_step(res, args, torch.float32)
    r32_rev, _ = sprites_cpu_step(res, args, torch.float32,
                                  order=torch.arange(n_chars - 1, -1, -1))
    r64, loss_terms = sprites_cpu_step(res, args, torch.float64)
    log(f"cpu sprites step {cap['step']} (fp32 twice, f64): "
        f"{time.perf_counter() - t0:.2f} s")
    if set(r32) != set(got):
        raise AssertionError(f"gradients {sorted(set(got) ^ set(r32))}")
    hold_to_cpu_gap(f"sprites step {cap['step']}", got, r32, [r32_rev], r64,
                    loss_terms, SPRITES_SUM_FLOOR)


def state_mismatches(a, b) -> list:
    """The leaves in which two TrainStates differ, bit for bit: every
    parameter, the Adam moments and step counts, the GECO state, the
    step."""
    import torch
    sa, sb = a.state_dict(), b.state_dict()
    bad = [k for k in ("step", "trainable") if sa[k] != sb[k]]
    bad += [f"params/{k}" for k, v in sa["params"].items()
            if not torch.equal(v, sb["params"][k])]
    bad += [f"geco/{k}" for k, v in sa["geco"].items()
            if not torch.equal(v, sb["geco"][k])]
    oa, ob = sa["optimizer"]["state"], sb["optimizer"]["state"]
    if oa.keys() != ob.keys() or not oa:
        bad.append("optimizer/state")
    bad += [f"optimizer/{i}/{k}" for i in oa for k in ("step", "exp_avg",
                                                       "exp_avg_sq")
            if i in ob and not torch.equal(oa[i][k].cpu(), ob[i][k].cpu())]
    return bad


def check_mnist_epoch(res, tag) -> None:
    """One epoch of the north-star run: finite, 32 steps, B1 once and B2
    at least once in each, one finite eval pass."""
    if len(res["step_seconds"]) != MNIST_EPOCH_STEPS:
        raise AssertionError(f"{tag}: {len(res['step_seconds'])} steps")
    for i, (mt, sl) in enumerate(zip(res["metrics"], res["step_launches"])):
        if not all(np.isfinite(v) for v in mt.values()):
            raise AssertionError(f"{tag} step {i}: non-finite metrics {mt}")
        if sl["chol_inverse"] != 1 or sl["gp_sufficient_stats"] < 1:
            raise AssertionError(f"{tag} step {i} launched {sl}: "
                                 "chol_inverse must launch once, "
                                 "gp_sufficient_stats at least once")
    ev = res["evals"][-1]
    if not all(np.isfinite(ev[k]) for k in ("eval_mse", "test_mse",
                                            "cgen_mse")):
        raise AssertionError(f"{tag}: non-finite eval pass {ev}")


def phase_mnist_save_resume(splits, base_dir, phase6) -> tuple:
    """Phase 13(a): phase 6's run for one epoch with --save
    --save_model_weights; a fresh run restored from its checkpoint (0
    epochs) must equal the saved state bit for bit, the noise generator
    included; then --resume_dir for one epoch more.  Returns the run dir,
    the launch counts of the two training runs and their pictures'
    records."""
    import torch
    from svgpvae_tpu_torch import ops
    from svgpvae_tpu_torch.cli import mnist

    ops.reset_launch_counts()
    first = mnist.main(MNIST_SAVE_ARGV + SAVE_ARGV + ["--base_dir",
                                                      base_dir],
                       splits=splits)
    run_dir = first["run_dir"]
    check_mnist_epoch(first, "mnist --save")
    restored = mnist.main(
        [{"joint-1": "joint-0"}.get(a, a) for a in MNIST_SAVE_ARGV]
        + ["--resume_dir", run_dir], splits=splits)
    bad = state_mismatches(restored["state"], first["state"])
    same_noise = torch.equal(restored["noise"].generator.get_state(),
                             first["noise"].generator.get_state())
    log(f"mnist restored from {run_dir}ckpt at step "
        f"{restored['state'].step}: differs from the saved state in "
        f"{len(bad)} leaves {bad[:5]}; noise generator state identical "
        f"{same_noise}")
    if bad or not same_noise or restored["state"].step != MNIST_EPOCH_STEPS:
        raise AssertionError("the restored state differs from the saved one")
    rest = mnist.main(MNIST_SAVE_ARGV + ["--resume_dir", run_dir,
                                         "--save_model_weights"],
                      splits=splits)
    launches = ops.launch_counts()
    check_mnist_epoch(rest, "mnist --resume_dir")
    if rest["state"].step != 2 * MNIST_EPOCH_STEPS:
        raise AssertionError(f"resumed run ended at step "
                             f"{rest['state'].step}")
    sec = np.asarray(first["step_seconds"][1:] + rest["step_seconds"][1:])
    cgen = rest["evals"][-1]["cgen_mse"]
    cgen6 = phase6["evals"][-1]["cgen_mse"]
    log(f"mnist saved + resumed: 2 x {MNIST_EPOCH_STEPS} steps, p50 "
        f"{1e3 * np.percentile(sec, 50):.3f} ms, p90 "
        f"{1e3 * np.percentile(sec, 90):.3f} ms; cgen MSE after the saved "
        f"epoch {first['evals'][-1]['cgen_mse']:.6f}, after the resumed "
        f"one {cgen:.9f} (phase 6's uninterrupted 2 epochs: {cgen6:.9f}, "
        f"equal {cgen == cgen6}; a rerun on the card need not be bitwise, "
        f"cuDNN's backward is not deterministic); launches {launches}")
    return run_dir, launches, first["pictures"] + rest["pictures"]


def phase_serve_run(run_dir, splits, out_dir, family) -> tuple:
    """Phase 13(b)/(c): cli.serve.main --run_dir on a trained run: B3 (the
    run's GP family) launches exactly once inside serving.fit and nothing
    else does; --out holds what was served; --queries with the served
    rows serves them again.  Returns the first serve's result and the
    launch counts of both serves."""
    import os
    import torch
    from svgpvae_tpu_torch import gp as gpm
    from svgpvae_tpu_torch import ops
    from svgpvae_tpu_torch.cli import serve

    gp_type = {"mnist": gpm.MnistSVGP, "sprites": gpm.SpritesSVGP}[family]
    out, out_q = (os.path.join(out_dir, f"{family}_{n}.npz")
                  for n in ("demo", "queries"))
    queries = os.path.join(out_dir, f"{family}_queries.npy")
    ops.reset_launch_counts()
    res = serve.main(["--run_dir", run_dir, "--device", "cuda", "--out",
                      out], splits=splits)
    served = res["state"]["served"][0]
    np.save(queries, served["aux_query"].cpu().numpy())
    again = serve.main(["--run_dir", run_dir, "--device", "cuda", "--out",
                        out_q, "--queries", queries], splits=splits)
    launches = ops.launch_counts()
    want = {"chol_inverse": 0, "fused_kernel_stats": 1,
            "gp_sufficient_stats": 0}
    for r in (res, again):
        if r["fit_launches"] != want:
            raise AssertionError(f"serve {family} run: the fit launched "
                                 f"{r['fit_launches']}, not B3 once")
    pred = res["state"]["predictor"]
    if not isinstance(pred.gp_params, gp_type):
        raise AssertionError(f"served a {type(pred.gp_params).__name__}")
    check_finite(**{f"served {k}": v for k, v in served.items()},
                 mean_terms=pred.mean_terms, sigma_inv=pred.sigma_inv)
    with np.load(out) as z:
        if sorted(z) != sorted(served) or not all(
                np.array_equal(z[k], served[k].cpu().numpy()) for k in z):
            raise AssertionError("--out does not hold what was served")
    other = again["state"]["served"][0]
    gaps = {k: float((other[k] - served[k]).abs().max()) for k in
            ("aux_query", "p_m", "p_v")}
    scale = {k: float(served[k].abs().max()) for k in gaps}
    if not all(gaps[k] <= CPU_RTOL * scale[k] for k in gaps):
        raise AssertionError(f"--queries served {gaps} away (max|.| {scale})")
    sec = res["seconds"]
    log(f"serve {family} run (step {res['step']}): encode "
        f"{sec['encode']:.3f} s, fit {sec['fit']:.4f} s, predict "
        f"{res['n_queries']} queries {1e3 * sec['predict']:.2f} ms, cgen MSE "
        f"{res['cgen_mse']:.6f}; fit launches {res['fit_launches']}; "
        f"--queries re-serve max gaps {gaps} (bitwise "
        f"{all(torch.equal(other[k], served[k]) for k in gaps)}); "
        f"launches in both serves {launches}")
    return res, launches


def phase_large_m(corpus, mnist_data, device) -> dict:
    """Phase 10: the SPRITES --m 4 and MNIST --nr_inducing_points 16 runs,
    whose B1 stacks take the panel form (checked), with phase 9(a)'s check
    on the SPRITES run's step 60; returns each run's launch counts."""
    from svgpvae_tpu_torch.ops import chol_inverse as ci
    for B, m in ((65, 288), (64, 288), (17, 256)):
        form = ci.kernel_info(B, m, device)["form"]
        if form != "panel":
            raise AssertionError(f"B1 at {(B, m, m)} takes the {form} form")
    sprites_res, sprites_launches = phase_sprites_train(
        corpus, SPRITES_M4_ARGV, 288, SPRITES_M4_L_CHARACTER,
        SPRITES_PRETRAIN_STEPS // 2, SPRITES_CAPTURE,
        "sprites --m 4 --L_character 36 (m = 288, B1 panel form)")
    phase_sprites_b1(sprites_res, SPRITES_M4_ARGV, 288)
    _, mnist_launches = phase_train(
        mnist_data, MNIST_M256_ARGV, 256, TRAIN_STEPS // 2, None,
        "mnist --nr_inducing_points 16 (m = 256, B1 panel form)")
    return {"sprites_m288_train": sprites_launches,
            "mnist_m256_train": mnist_launches}


def phase_ball_train(tag, base_dir) -> tuple:
    """Phase 14: one ball run of BALL_RUNS through cli.ball.main on the
    card; returns its result and the run's launch counts.  An SVGPVAE
    step and the eval launch B1 exactly once each (nothing else); a
    Pearce or NP step launches nothing."""
    import torch
    from svgpvae_tpu_torch import ops, train
    from svgpvae_tpu_torch.cli import ball

    argv, steps, stack = BALL_RUNS[tag]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = ball.main(argv + ["--steps", str(steps), "--eval_every",
                            str(steps), "--base_dir", base_dir, "--device",
                            "cuda", "--seed", "0"], capture_step=steps // 2)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st = res["state"]
    enc = st.params["enc"]
    dims = (res["captured"]["vids"].shape, enc.hidden[0].out_features)
    if dims != ((35, 30, 32, 32), 500) or len(res["step_seconds"]) != steps:
        raise AssertionError(f"{tag}: videos and hidden width {dims}, "
                             f"{len(res['step_seconds'])} steps")
    if stack is not None and tuple(st.params["gp"].inducing_points.shape) \
            != (2, 15):
        raise AssertionError(f"{tag}: inducing points "
                             f"{tuple(st.params['gp'].inducing_points.shape)}")
    for i, mt in enumerate(res["metrics"]):
        if not all(np.isfinite(v) for v in mt.values()):
            raise AssertionError(f"{tag} step {i}: non-finite metrics {mt}")
    check_finite(**train.named_tensors(st.params))
    b1 = 1 if stack is not None else 0
    want = {"chol_inverse": b1, "fused_kernel_stats": 0,
            "gp_sufficient_stats": 0}
    for i, sl in enumerate(res["step_launches"]):
        if sl != want:
            raise AssertionError(f"{tag} step {i} launched {sl}, not {want}")
    ev = res["evals"][-1]
    if len(res["evals"]) != 1 or not np.isfinite(ev["mse"]) or \
            ev["launches"] != want:
        raise AssertionError(f"{tag}: eval {ev}")
    if launches["chol_inverse"] != b1 * (steps + 1):
        raise AssertionError(f"{tag}: the run launched {launches}")
    log(f"{tag}: {steps} steps; first {1e3 * res['step_seconds'][0]:.2f} "
        f"ms, then p50 {res['step_p50_ms']:.3f} ms, p90 "
        f"{res['step_p90_ms']:.3f} ms; eval ({ev['seconds']:.3f} s) "
        f"trajectory MSE {ev['mse']:.4f}, elbo {ev['elbo']:.3f}; "
        f"max_memory_allocated {peak / 2**20:.1f} MiB; launches per step "
        f"{res['step_launches'][0]}, in the whole run {launches}")
    return res, launches


def _ball_step_params(cap, card_gp, device, dtype):
    """The captured ball step's parameters as the port's modules and GP."""
    from svgpvae_tpu_torch import gp as gpm
    from svgpvae_tpu_torch.nn import BallDecoder, BallEncoder

    snap = {k: v.detach().to(device, dtype) for k, v in cap["params"].items()}

    def part(name):
        return {k.split("/", 1)[1]: v for k, v in snap.items()
                if k.startswith(name + "/")}

    enc, dec = BallEncoder(tmax=cap["vids"].shape[1]), BallDecoder()
    enc.load_state_dict(part("enc"))
    dec.load_state_dict(part("dec"))
    return {"enc": enc.to(device, dtype), "dec": dec.to(device, dtype),
            "gp": gpm.BallSVGP(config=card_gp.config, **part("gp"))}


def _ball_args(tag):
    import torch
    from svgpvae_tpu_torch import models
    from svgpvae_tpu_torch.cli import ball
    args = ball.build_parser().parse_args(BALL_RUNS[tag][0])
    args.gp_block_impl = models.resolve_gp_block_impl(
        args.gp_block_impl, workload="ball",
        titsias=args.elbo == "SVGPVAE_Titsias", device=torch.device("cuda"))
    return args


def phase_ball_b1(tag, res) -> None:
    """Phase 14: the captured step's B1 input stack, recomputed on the
    card from its inputs, held as phase 9(a) holds SPRITES's."""
    import torch
    from svgpvae_tpu_torch.cli import ball
    from svgpvae_tpu_torch.gp import fused

    cap = res["captured"]
    args = _ball_args(tag)
    params = _ball_step_params(cap, res["state"].params["gp"],
                               cap["vids"].device, torch.float32)
    stacks, kernel = [], fused.chol_inverse

    def recording(M):
        stacks.append(M.detach().clone())
        return kernel(M)

    fused.chol_inverse = recording
    try:
        with torch.no_grad():
            loss, _ = ball.make_loss_fn(args, ball.make_forward(
                args, lambda kind, shape: cap["eps"], None, args.modellt))(
                params, cap["vids"], None, cap["step"])
    finally:
        fused.chol_inverse = kernel
    log(f"{tag} step {cap['step']} recomputed on the card: loss "
        f"{float(loss):.9g}, as captured {float(cap['loss']):.9g}")
    want = [BALL_RUNS[tag][2]]
    if [tuple(M.shape) for M in stacks] != want:
        raise AssertionError(f"B1 inputs {[tuple(M.shape) for M in stacks]}"
                             f", not {want}")
    hold_b1_on_stacks(cap["step"], [(f"{tag} stack", stacks[0])])


def phase_ball_cpu_check(tag, res) -> None:
    """Phase 14: the captured step redone on the CPU with the twins, in
    fp32 with the videos in their order and reversed (the loss is a mean
    over videos, order-invariant), and in f64; the card's loss and
    gradients held as phase 7 holds MNIST's."""
    import torch
    from svgpvae_tpu_torch import train
    from svgpvae_tpu_torch.cli import ball

    cap = res["captured"]
    args = _ball_args(tag)
    got = {"loss": cap["loss"], **cap["grads"]}

    def cpu_step(dtype, reverse):
        def cpu_b(t):  # a batch-axis tensor, in its order or reversed
            t = t.detach().to("cpu", dtype)
            return t.flip(0) if reverse else t
        params = _ball_step_params(cap, res["state"].params["gp"],
                                   torch.device("cpu"), dtype)
        trainable = train.trainable_tensors(
            params, ball.trainable_predicate(args))
        eps, outs = cpu_b(cap["eps"]), []
        forward = ball.make_forward(args, lambda kind, shape: eps, None,
                                    args.modellt)

        def recording(*a):
            outs.append(forward(*a))
            return outs[-1]

        loss, _ = ball.make_loss_fn(args, recording)(
            params, cpu_b(cap["vids"]), None, cap["step"])
        grads = torch.autograd.grad(loss, list(trainable.values()))
        out = outs[-1]
        terms = sum(abs(float(t.detach().mean())) for t in (
            out.recon, out.ce_term, out.inside_elbo, loss))
        return ({k: v.detach().double() for k, v in
                 {"loss": loss, **dict(zip(trainable, grads))}.items()},
                terms)

    t0 = time.perf_counter()
    r32, _ = cpu_step(torch.float32, reverse=False)
    r32_rev, _ = cpu_step(torch.float32, reverse=True)
    r64, loss_terms = cpu_step(torch.float64, reverse=False)
    log(f"cpu {tag} step {cap['step']} (fp32 twice, f64): "
        f"{time.perf_counter() - t0:.2f} s")
    if set(r32) != set(got):
        raise AssertionError(f"gradients {sorted(set(got) ^ set(r32))}")
    hold_to_cpu_gap(f"{tag} step {cap['step']}", got, r32, [r32_rev], r64,
                    loss_terms, BALL_SUM_FLOOR)


def phase_ball(base_dir) -> tuple:
    """Phase 14: the four ball runs, the B1 check and the CPU recheck of
    the two SVGPVAE runs; returns each run's launch counts, and each
    run's (result, launches) by tag."""
    launches, runs = {}, {}
    for tag in BALL_RUNS:
        res, launches[tag] = phase_ball_train(tag, base_dir)
        runs[tag] = (res, launches[tag])
        if BALL_RUNS[tag][2] is not None:
            phase_ball_b1(tag, res)
            phase_ball_cpu_check(tag, res)
    return launches, runs


def _baseline_argv(tag) -> list:
    driver, argv, *_ = BASELINE_RUNS[tag]
    data = (["--dataset", "36", "--synthetic_digits"] if driver == "mnist"
            else [])
    return argv + data + ["--device", "cuda", "--seed", "0"]


def phase_baseline_train(tag, splits) -> tuple:
    """Phase 15: one run of BASELINE_RUNS on the card; returns its result
    and the run's launch counts, which must all be 0.  Finite metrics,
    parameters and eval pass; the step p50 and the run's seconds."""
    from svgpvae_tpu_torch import ops, train
    from svgpvae_tpu_torch.cli import mnist, sprites

    driver, _, steps, capture, _ = BASELINE_RUNS[tag]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = (mnist if driver == "mnist" else sprites).main(
        _baseline_argv(tag), splits=splits, capture_step=capture)
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    params = res["params"] if "params" in res else res["state"].params
    width = (params["dec"].L if "dec" in params else params["vae"].L,
             len(splits["train"]["images" if driver == "mnist"
                                 else "frames"]))
    if width != BASELINE_WIDTHS[driver] or len(res["step_seconds"]) != steps:
        raise AssertionError(f"{tag}: L, N_train = {width} over "
                             f"{len(res['step_seconds'])} steps")
    for i, mt in enumerate(res["metrics"]):
        if not all(np.isfinite(v) for v in mt.values()):
            raise AssertionError(f"{tag} step {i}: non-finite metrics {mt}")
    check_finite(**train.named_tensors(params))
    ev = res["evals"][-1]
    scores = {k: ev[k] for k in ("eval_mse", "test_mse", "cgen_mse")
              if ev.get(k) is not None}
    if not scores or not all(np.isfinite(v) for v in scores.values()):
        raise AssertionError(f"{tag}: eval pass {ev}")
    if any(launches.values()):
        raise AssertionError(f"{tag} launched {launches}: the baselines "
                             "reach no kernel of the port")
    sec = np.asarray(res["step_seconds"])
    log(f"{tag}: {steps} steps, {seconds:.2f} s in all (eval included); "
        f"first step {1e3 * sec[0]:.2f} ms, then p50 "
        f"{1e3 * np.percentile(sec[1:], 50):.3f} ms, p90 "
        f"{1e3 * np.percentile(sec[1:], 90):.3f} ms; eval after epoch "
        f"{ev['epoch']}: "
        + ", ".join(f"{k} {v:.6f}" for k, v in scores.items())
        + f" ({', '.join(f'{k} {v:.3f} s' for k, v in ev['seconds'].items())}"
        f"); launches {launches}")
    return res, launches


def _baseline_step_params(tag, cap, card_params, dtype):
    """The captured step's parameters as the port's modules (and GP) on
    the CPU."""
    import dataclasses
    from svgpvae_tpu_torch.nn import (MnistCVAE, MnistVAE, SVIGPDecoder,
                                      SpritesVAE)

    snap = {k: v.detach().to("cpu", dtype) for k, v in cap["params"].items()}

    def part(name):
        return {k.split("/", 1)[1]: v for k, v in snap.items()
                if k.startswith(name + "/")}

    if "dec" in card_params:
        net = SVIGPDecoder(L=card_params["dec"].L).to(dtype)
        net.load_state_dict(part("dec"))
        params = {"dec": net}
    else:
        net = {"mnist_cvae_train": MnistCVAE,
               "sprites_vae_train": SpritesVAE}.get(tag, MnistVAE)(
                   L=card_params["vae"].L).to(dtype)
        net.load_state_dict(part("vae"))
        params = {"vae": net}
    if "gp" in card_params:  # the card's static options, the step's tensors
        params["gp"] = dataclasses.replace(card_params["gp"], **part("gp"))
    return params


def phase_baseline_cpu_check(tag, res, splits) -> None:
    """Phase 15: the captured step redone on the CPU, in fp32 with the
    batch in its order, reversed and in BASELINE_PERMUTATIONS seeded
    orders (every baseline's loss sums over the batch's rows; a reordered
    batch takes its draw with it) and in f64; the card's loss and
    gradients held as phase 7 holds MNIST's, to the largest of those
    orders' gaps.  The Casale loss also sums its Taylor terms over the
    whole train split's latents Z and V, which no batch order permutes:
    each reordered Casale step also takes the train rows (Z's encode and
    draw, V's grid rows, the batch's global indices) in the reversed or
    the seeded order of the same count, so that the orders sample that
    sum's round-off too."""
    import torch
    from svgpvae_tpu_torch import models, train
    from svgpvae_tpu_torch.cli import mnist, sprites

    driver, _, _, _, longest_sum = BASELINE_RUNS[tag]
    cap = res["captured"]
    card_params = res["params"] if "params" in res else res["state"].params
    args = (mnist if driver == "mnist" else sprites).build_parser() \
        .parse_args(_baseline_argv(tag))
    got = {"loss": cap["loss"], "C_ma": cap["geco_after"].C_ma,
           "lagrange_mult": cap["geco_after"].lagrange_mult, **cap["grads"]}
    consts = (mnist.casale_constants(mnist.sort_train_data(splits["train"]),
                                     torch.device("cpu"))
              if tag == "casale_train" else None)

    def cpu_step(dtype, order=None, rows=None):
        """The step on the CPU in `dtype`, the batch in `order` and (Casale)
        the train split's rows in `rows`."""
        def cpu(t):
            return t.detach().to("cpu", dtype)

        def cpu_b(t):  # a batch-axis tensor, in its order or in `order`
            return cpu(t) if order is None else cpu(t)[order]

        def cpu_n(t):  # a train-row-axis tensor, in its order or in `rows`
            return cpu(t) if rows is None else cpu(t)[rows]
        params = _baseline_step_params(tag, cap, card_params, dtype)
        trainable = {k: t.requires_grad_(True) for k, t in
                     train.named_tensors(params).items() if k in got}
        # cli.mnist captures every draw of the step, cli.sprites its one
        raw = cap.get("draws", [cap["eps"]] if "eps" in cap else [])
        draws = [cpu_n(e) if consts is not None
                 and e.shape[0] == len(consts["images"]) else cpu(e)
                 for e in raw]
        if draws and draws[-1].shape[0] == cap["batch"][0].shape[0]:
            draws[-1] = cpu_b(raw[-1])
        replay = iter(draws)
        batch = [cpu_b(x) for x in cap["batch"]]

        def eps_fn(kind, shape):
            return next(replay)

        if tag == "casale_train":
            keep = (slice(None) if rows is None else rows)
            if rows is not None:  # the batch's global indices follow Z's rows
                where = torch.empty_like(rows)
                where[rows] = torch.arange(len(rows))
                batch[1] = batch[1].clone()
                batch[1][:, 0] = where[batch[1][:, 0].long()].to(dtype)
            loss_fn = mnist.make_casale_loss_fn(
                args, eps_fn, dict(consts,
                                   images=consts["images"][keep].to(dtype),
                                   angles=consts["angles"].to(dtype),
                                   grid_rows=consts["grid_rows"][keep]),
                cap["regime"],
                None if cap["held_Z"] is None else cpu_n(cap["held_Z"]))
        elif tag == "svigp_train":
            loss_fn = mnist.make_svigp_loss_fn()
        elif driver == "sprites":
            loss_fn = sprites.make_vae_loss_fn(
                sprites.make_vae_forward(args, eps_fn))
        else:
            loss_fn = mnist.make_vae_loss_fn(mnist.make_vae_forward(
                args, eps_fn, cvae=tag == "mnist_cvae_train"))
        outs, name = [], {"casale_train": "forward_pass_casale",
                          "svigp_train": "forward_pass_deep_svigp"}.get(
                              tag, "forward_pass_vae")
        forward = getattr(models, name)

        def recording(*a, **kw):
            outs.append(forward(*a, **kw))
            return outs[-1]

        setattr(models, name, recording)
        try:
            loss, (geco, _) = loss_fn(
                params, tuple(batch),
                train.GECOState(C_ma=cpu(cap["geco"].C_ma),
                                lagrange_mult=cpu(cap["geco"].lagrange_mult)),
                cap["step"])
        finally:
            setattr(models, name, forward)
        grads = torch.autograd.grad(loss, list(trainable.values()))
        out, images = outs[-1], cap["batch"][0]
        K = images[0].numel()
        if tag == "casale_train":
            terms = float(out.recon_loss) + args.beta / args.L * (
                abs(float(out.gp_prior_term)) + 0.5 * abs(float(out.log_var)))
        elif tag == "svigp_train":
            bK, noise = images.numel(), float(params["gp"].noise)
            terms = (bK * abs(math.log(noise)) + 0.5 * bK * math.log(
                2 * math.pi) + 0.5 * float(out.recon_loss) * K / noise ** 2
                + abs(float(out.inside_elbo)))
        else:
            terms = (0.5 / 0.01 ** 2 * float(out.recon_loss) * K
                     + abs(float(out.kl_term)))
        return ({k: v.detach().double() for k, v in {
            "loss": loss, "C_ma": geco.C_ma,
            "lagrange_mult": geco.lagrange_mult,
            **dict(zip(trainable, grads))}.items()}, terms)

    t0 = time.perf_counter()
    b = cap["batch"][0].shape[0]
    gen = torch.Generator().manual_seed(0)
    orders = [torch.arange(b - 1, -1, -1)] + [
        torch.randperm(b, generator=gen)
        for _ in range(BASELINE_PERMUTATIONS)]
    rows = [None] * len(orders)
    if consts is not None:
        n = len(consts["images"])
        gen = torch.Generator().manual_seed(0)
        rows = [torch.arange(n - 1, -1, -1)] + [
            torch.randperm(n, generator=gen)
            for _ in range(BASELINE_PERMUTATIONS)]
    r32, _ = cpu_step(torch.float32)
    r32_more = [cpu_step(torch.float32, o, r)[0]
                for o, r in zip(orders, rows)]
    r64, loss_terms = cpu_step(torch.float64)
    log(f"cpu {tag} step {cap['step']} (fp32 in {1 + len(orders)} orders, "
        f"f64): {time.perf_counter() - t0:.2f} s")
    if set(r32) != set(got):
        raise AssertionError(f"gradients {sorted(set(got) ^ set(r32))}")
    hold_to_cpu_gap(f"{tag} step {cap['step']}", got, r32, r32_more, r64,
                    loss_terms, math.sqrt(longest_sum) * 2.0 ** -24)


def phase_vae_phase_train(splits) -> tuple:
    """Phase 15: phase 6's run with --opt_regime VAE-1 joint-1: the VAE
    epoch's 32 steps launch no kernel, the joint epoch's B1 once and B2 at
    least once each; finite; phase 7's recheck of its step 40 (joint).
    Returns its result and launch counts."""
    from svgpvae_tpu_torch import ops, train
    from svgpvae_tpu_torch.cli import mnist

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = mnist.main(VAE_PHASE_ARGV, splits=splits,
                     capture_step=CAPTURE_STEP)
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    half = MNIST_EPOCH_STEPS
    if len(res["step_seconds"]) != 2 * half:
        raise AssertionError(f"{len(res['step_seconds'])} steps")
    for i, (mt, sl) in enumerate(zip(res["metrics"], res["step_launches"])):
        if not all(np.isfinite(v) for v in mt.values()):
            raise AssertionError(f"step {i}: non-finite metrics {mt}")
        want = (0, 0) if i < half else (1, None)
        if sl["chol_inverse"] != want[0] or (
                sl["gp_sufficient_stats"] == 0) != (i < half):
            raise AssertionError(f"step {i} ({res['regimes'][i // half]}) "
                                 f"launched {sl}")
    check_finite(**train.named_tensors(res["state"].params))
    ev = res["evals"][-1]
    if not all(np.isfinite(ev[k]) for k in ("eval_mse", "test_mse",
                                            "cgen_mse")):
        raise AssertionError(f"non-finite eval pass {ev}")
    sec = np.asarray(res["step_seconds"])
    log(f"mnist --opt_regime VAE-1 joint-1: {2 * half} steps, {seconds:.2f} "
        f"s in all; VAE epoch p50 {1e3 * np.percentile(sec[1:half], 50):.3f}"
        f" ms, joint epoch p50 {1e3 * np.percentile(sec[half:], 50):.3f} ms;"
        f" eval MSE {ev['eval_mse']:.6f}, cgen MSE {ev['cgen_mse']:.6f}; "
        f"launches {launches}")
    phase_train_cpu_check(res, VAE_PHASE_ARGV)
    return res, launches


def phase_baselines(mnist_data, corpus) -> tuple:
    """Phase 15: the baseline runs, each with its CPU recheck, and the
    SVGPVAE run with a VAE phase; returns each run's launch counts, and
    {tag: (result, launch counts)} of the runs phase 22 captures."""
    launches, runs = {}, {}
    for tag, (driver, *_) in BASELINE_RUNS.items():
        splits = mnist_data if driver == "mnist" else corpus
        res, launches[tag] = phase_baseline_train(tag, splits)
        phase_baseline_cpu_check(tag, res, splits)
        runs[tag] = (res, launches[tag])
    runs["mnist_vae_phase_train"] = phase_vae_phase_train(mnist_data)
    launches["mnist_vae_phase_train"] = runs["mnist_vae_phase_train"][1]
    return launches, {k: runs[k] for k in CAPTURED_REST_RUNS if k in runs}


# --- phase 16 ---------------------------------------------------------------
def _trace_kernels(trace_dir) -> tuple:
    """(path, "train_step" ranges on the host, CUDA kernel events) of the
    one Chrome trace under trace_dir (a range also shows on the device
    track, as "gpu_user_annotation")."""
    paths = glob.glob(os.path.join(trace_dir, "*.json"))
    if len(paths) != 1:
        raise AssertionError(f"{trace_dir}: traces {paths}")
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    return (paths[0], sum(e.get("name") == "train_step"
                          and e.get("cat") == "user_annotation"
                          for e in events),
            sum(e.get("cat") == "kernel" for e in events))


def _nan_eps(device):
    """eps_fn whose training draws are NaN (the eval draws are not)."""
    import torch
    from svgpvae_tpu_torch.cli import mnist
    base = mnist.default_eps_fn(0, device)

    def eps_fn(kind, shape):
        eps = base(kind, shape)
        return eps.fill_(float("nan")) if kind.startswith("train") else eps
    return eps_fn


def write_raw_sprites(path, n_train=4, n_test=2, seed=0) -> None:
    """A small corpus in the published raw npy layout (the nine
    {walk,spellcard,slash}_{front,left,right} frames/attributes x
    train/test files; one 8-frame sequence per character in each, the
    attributes' 4 x 6 one-hots naming the character)."""
    from svgpvae_tpu_torch.data import sprites as sd
    rng = np.random.RandomState(seed)
    for action in sd.RAW_SPRITES_ACTIONS:
        for direction in sd.RAW_SPRITES_DIRECTIONS:
            for split, n, off in (("train", n_train, 0),
                                  ("test", n_test, n_train)):
                a = np.zeros((n, 8, 4, 6), np.float32)
                for i in range(n):
                    for t in range(4):
                        a[i, :, t, (i + off + 2 * t) % 6] = 1.0
                stem = os.path.join(path, f"{action}_{direction}")
                np.save(f"{stem}_frames_{split}.npy",
                        rng.rand(n, 8, 64, 64, 3).astype(np.float32))
                np.save(f"{stem}_attributes_{split}.npy", a)


def phase_driver_flags(mnist_data, corpus, base_dir, phase6) -> tuple:
    """Phase 16: the drivers' last single-GPU flags on the card; returns
    each path's launch counts and the results of the saved runs (a) and
    (e), whose pictures phase 19 checks."""
    import torch
    from svgpvae_tpu_torch import data, ops, utils
    from svgpvae_tpu_torch.cli import ball, mnist, sprites

    device = torch.device("cuda", 0)
    paths, saved_runs = {}, {}
    # (a) --reshuffle --test_set_metrics --profile_dir --save: phase 6's
    # checks (B1 once, B2 at least once per step), the rows and the trace
    trace_dir = os.path.join(base_dir, "trace_mnist")
    res, paths["mnist_flags_train"] = phase_train(
        mnist_data, TRAIN_ARGV + [
            "--reshuffle", "--test_set_metrics", "--save", "--base_dir",
            base_dir, "--profile_dir", trace_dir], 32, TRAIN_STEPS, None,
        "mnist --reshuffle --test_set_metrics --profile_dir --save")
    saved_runs["16(a)"] = res
    path, ranges, kernels = _trace_kernels(trace_dir)
    with open(os.path.join(res["run_dir"], "res", "ELBO_results.csv")) as f:
        rows = f.read().strip().splitlines()[1:]
    if ranges != TRAIN_STEPS // 2 or len(rows) != 1:
        raise AssertionError(f"trace {path}: {ranges} train_step ranges; "
                             f"{len(rows)} metric rows")
    sec = np.asarray(res["step_seconds"])
    log(f"16(a): trace {os.path.basename(path)} "
        f"({os.path.getsize(path) / 2**20:.1f} MiB) holds epoch 1's "
        f"{ranges} steps and {kernels} CUDA kernel events; step p50 "
        f"{1e3 * np.percentile(sec[1:32], 50):.3f} ms in epoch 0, "
        f"{1e3 * np.percentile(sec[32:], 50):.3f} ms in the traced epoch "
        f"1; the test-set row {rows[0][:72]}...")
    # (b) --bias_analysis: the two-pass block (no B1), B2 in every step
    # and once in the bias pass at n = 8,100
    ops.reset_launch_counts()
    res = mnist.main(TRAIN_ARGV + ["--bias_analysis", "--opt_regime",
                                   "joint-1"], splits=mnist_data)
    paths["mnist_bias_train"] = ops.launch_counts()
    (bias,) = res["bias"]
    for i, sl in enumerate(res["step_launches"]):
        if sl["chol_inverse"] != 0 or sl["gp_sufficient_stats"] < 1:
            raise AssertionError(f"bias step {i} launched {sl}")
    if bias["launches"]["gp_sufficient_stats"] != 1 or \
            bias["launches"]["chol_inverse"] != 0 or \
            not np.isfinite(bias["bias"]):
        raise AssertionError(f"bias pass {bias}")
    log(f"16(b): --bias_analysis: {len(res['step_launches'])} steps, per "
        f"step {res['step_launches'][0]}; bias for epoch 0 "
        f"{bias['bias']:.6f}, the bias pass launched {bias['launches']}; "
        f"the run {paths['mnist_bias_train']}")
    # (c) the sentinel: NaN draws under --save
    ops.reset_launch_counts()
    try:
        mnist.main(TRAIN_ARGV + ["--opt_regime", "joint-1", "--save",
                                 "--base_dir", base_dir],
                   splits=mnist_data, eps_fn=_nan_eps(device))
        raise AssertionError("a NaN run did not raise")
    except utils.NonFiniteLossError as e:
        msg = str(e)
    paths["mnist_nan_train"] = ops.launch_counts()
    where = msg.rsplit(" ", 1)[-1]
    saved = utils.restore_checkpoint(where)
    if utils.latest_step(where) != 32 or saved["train_state"]["step"] != 32:
        raise AssertionError(f"ckpt_nan: {os.listdir(where)}")
    log(f"16(c): NonFiniteLossError: {msg}; {os.listdir(where)}")
    # (d) --x64: float64 on the card through the plain versions, 0 launches
    ops.reset_launch_counts()
    res = mnist.main(TRAIN_ARGV + ["--x64", "--opt_regime", "joint-1",
                                   "--eval_every", "1"], splits=mnist_data)
    paths["mnist_x64_train"] = launches = ops.launch_counts()
    ev = res["evals"][-1]
    dtypes = {t.dtype for t in res["state"].params["gp"].named_tensors()
              .values()}
    if any(launches.values()) or dtypes != {torch.float64} or not all(
            np.isfinite([m["loss"] for m in res["metrics"]])) or \
            not np.isfinite(ev["cgen_mse"]):
        raise AssertionError(f"--x64: launches {launches}, dtypes {dtypes}, "
                             f"eval {ev}")
    sec = np.asarray(res["step_seconds"][1:])
    log(f"16(d): --x64: {len(res['metrics'])} steps, p50 "
        f"{1e3 * np.percentile(sec, 50):.3f} ms (fp32: phase 6); cgen MSE "
        f"{ev['cgen_mse']:.6f}; launches {launches}, beside the fp32 run's "
        f"{phase6}")
    # (e) SPRITES --reshuffle --test_set_metrics at phase 8's widths
    res, paths["sprites_flags_train"] = phase_sprites_train(
        corpus, SPRITES_ARGV + ["--reshuffle", "--test_set_metrics",
                                "--save", "--base_dir", base_dir],
        tag="sprites --reshuffle --test_set_metrics")
    saved_runs["16(e)"] = res
    # (f) a raw npy corpus: preprocessed into shards by the driver, then
    # one epoch on it at phase 8's widths
    raw = os.path.join(base_dir, "raw_sprites")
    os.makedirs(raw)
    write_raw_sprites(raw)
    ops.reset_launch_counts()
    res = sprites.main(
        [a for a in SPRITES_ARGV if a not in ("--synthetic",
                                              "--synthetic_chars",
                                              str(SERVE_CHARS))]
        + ["--sprites_data_path", raw, "--batch_size", "100",
           "--batch_size_repr_nn", "100"])
    paths["sprites_raw_train"] = launches = ops.launch_counts()
    x_tr, x_te, a_tr, a_te, d_tr, d_te = data.load_raw_sprites_npys(raw)
    want = data.preprocess_sprites(x_tr, a_tr, d_tr, x_te, a_te, d_te,
                                   n_frames_train=SPRITES_FPC, seed=0)
    got = data.load_sprites(raw)
    for split in want:
        for k in ("frames", "aux_data"):
            if not np.array_equal(got[split][k], want[split][k]):
                raise AssertionError(f"raw corpus shards: {split}/{k}")
    ev = res["evals"][-1]
    if [sl["chol_inverse"] for sl in res["step_launches"]] != [2, 2] or \
            ev["launches"]["fit"]["fused_kernel_stats"] != 1 or \
            not np.isfinite(ev["cgen_mse"]):
        raise AssertionError(f"raw corpus run: {res['step_launches']}, "
                             f"eval {ev}")
    log(f"16(f): raw npy corpus -> shards ({len(got['train']['frames'])} "
        f"train, {len(got['test_character']['frames'])} test_character "
        f"frames, equal to preprocess_sprites); 2 steps, cgen MSE "
        f"{ev['cgen_mse']:.6f}; launches {launches}")
    # (g) the ball with --profile_dir: chunk = gcd(100, 10000, 50000) =
    # 100, so steps 100..199 of 200 are traced
    trace_dir = os.path.join(base_dir, "trace_ball")
    ops.reset_launch_counts()
    res = ball.main(BALL_RUNS["ball_hensman_train"][0] + [
        "--steps", "200", "--eval_every", "100", "--plot_every", "10000",
        "--ckpt_every", "50000", "--profile_dir", trace_dir, "--base_dir",
        base_dir, "--device", "cuda", "--seed", "0"])
    paths["ball_profile_train"] = launches = ops.launch_counts()
    path, ranges, kernels = _trace_kernels(trace_dir)
    if ranges != 100 or launches["chol_inverse"] != 202:
        raise AssertionError(f"ball trace {path}: {ranges} train_step "
                             f"ranges, {kernels} kernels; launches "
                             f"{launches}")
    log(f"16(g): ball trace {os.path.basename(path)} holds steps 100..199 "
        f"({ranges} train_step ranges, {kernels} CUDA kernel events); "
        f"launches {launches}; final MSE {res['mse']:.4f}")
    return paths, saved_runs


# --- phase 17 ---------------------------------------------------------------
class RecordedDtypes:
    """While open: the dtypes of the encoders' outputs (`encoder`) and
    the kernels' inputs (`kernels`, ops.KernelInputRecorder)."""

    def __enter__(self):
        from svgpvae_tpu_torch import ops
        from svgpvae_tpu_torch.nn import MnistVAE, SpritesVAE
        self.encoder = set()
        self.saved = [(net, net.encode) for net in (MnistVAE, SpritesVAE)]
        for net, fn in self.saved:
            net.encode = self._recording(fn)
        self.kernels = ops.KernelInputRecorder().__enter__()
        return self

    def _recording(self, fn):
        def encode(net, *args, **kwargs):
            out = fn(net, *args, **kwargs)
            self.encoder.update(t.dtype for t in out)
            return out
        return encode

    def __exit__(self, *exc):
        self.kernels.__exit__(*exc)
        for net, fn in self.saved:
            net.encode = fn
        return False

    def check(self, tag, encoder_dtype) -> None:
        import torch
        kernels = self.kernels.dtypes()
        if self.encoder != {encoder_dtype} or kernels != {torch.float32}:
            raise AssertionError(f"{tag}: encoder outputs {self.encoder}, "
                                 f"kernel inputs {kernels}")
        log(f"{tag}: encoder outputs {sorted(map(str, self.encoder))}, "
            f"every input of {sorted(self.kernels.names())} "
            f"{sorted(map(str, kernels))}")


def phase_bf16_cpu_check(res, argv) -> None:
    """Phase 17(a): the --bf16 run's captured step redone on the CPU, with
    its nets in bf16 in six character orders and in fp32 once, and the
    card's loss, GECO state and gradients held to it (see the comment on
    phase 17 among the constants)."""
    import torch
    from svgpvae_tpu_torch import models
    from svgpvae_tpu_torch.cli import sprites

    cap = res["captured"]
    args = sprites.build_parser().parse_args(argv)
    args.gp_block_impl = models.resolve_gp_block_impl(
        args.gp_block_impl, workload="sprites", device=torch.device("cuda"))
    nets = sprites.net_dtypes(args)
    n_chars = cap["batch"][0].shape[0] // SPRITES_FPC
    gen = torch.Generator().manual_seed(0)
    orders = [None, torch.arange(n_chars - 1, -1, -1)] + [
        torch.randperm(n_chars, generator=gen)
        for _ in range(BASELINE_PERMUTATIONS)]
    got = {k: v.detach().cpu().double() for k, v in _card_step(cap).items()}

    t0 = time.perf_counter()
    r16 = [sprites_cpu_step(res, args, torch.float32, order, nets)[0]
           for order in orders]
    r32, _ = sprites_cpu_step(res, args, torch.float32)
    log(f"cpu sprites step {cap['step']} (nets in bf16 in {len(orders)} "
        f"orders, in fp32 once): {time.perf_counter() - t0:.2f} s")
    if set(r16[0]) != set(got):
        raise AssertionError(f"gradients {sorted(set(got) ^ set(r16[0]))}")
    def fro(a, b, keys):
        return math.sqrt(sum(float(((a[k] - b[k]) ** 2).sum())
                             for k in keys))

    rows, tag = [], f"bf16 sprites step {cap['step']}"
    for k in ("loss", "C_ma", "lagrange_mult"):
        err = abs(float(got[k] - r16[0][k]))
        spread = max(abs(float(r[k] - r16[0][k])) for r in r16)
        scale = abs(float(r16[0][k]))
        limit = RECHECK_FACTOR * max(spread, SPRITES_SUM_FLOOR * scale)
        rows.append((k, err, limit))
        log(f"{tag} {k}: card {float(got[k]):.9g}, cpu bf16 "
            f"{float(r16[0][k]):.9g}, cpu fp32 {float(r32[k]):.9g}; card "
            f"vs cpu bf16 {err:.3e}, cpu spread over the orders "
            f"{spread:.3e}, limit {limit:.3e}")
    leaves = [k for k in got if k not in ("loss", "C_ma", "lagrange_mult")]
    for k in leaves:
        err, to_fp32 = fro(got, r16[0], [k]), fro(r32, r16[0], [k])
        spread = max(fro(r, r16[0], [k]) for r in r16)
        limit = BF16_LEAF_FACTOR * to_fp32
        rows.append((k, err, limit))
        log(f"{tag} {k}: card vs cpu bf16 {err:.3e}, cpu bf16 vs fp32 "
            f"{to_fp32:.3e}, cpu spread over the orders {spread:.3e}, limit "
            f"{limit:.3e}, norm {float(r16[0][k].norm()):.3e} (Frobenius)")
    whole, to_fp32 = fro(got, r16[0], leaves), fro(r32, r16[0], leaves)
    card_fp32 = fro(got, r32, leaves)
    worst = max((err / limit, k) for k, err, limit in rows)
    log(f"{tag}: worst err/limit {worst[0]:.3f} ({worst[1]}); the "
        f"{len(leaves)} gradients together: card vs cpu bf16 {whole:.3e}, "
        f"card vs cpu fp32 {card_fp32:.3e}, cpu bf16 vs fp32 "
        f"{to_fp32:.3e} (card vs cpu bf16 / cpu bf16 vs fp32: "
        f"{whole / to_fp32:.3f})")
    bad = [k for k, err, limit in rows if not err <= limit]
    if bad or not whole < card_fp32:
        raise AssertionError(f"{tag}: the card disagrees with the CPU on "
                             f"{bad}, or its gradients sit {whole:.3e} from "
                             f"the CPU's bf16 ones and {card_fp32:.3e} from "
                             "its fp32 ones")


def phase_mixed_precision(corpus, mnist_data, phase6, phase8) -> tuple:
    """Phase 17: the SPRITES run under --bf16 and --bf16_hybrid and the
    MNIST run under --bf16 (see the module doc); returns each run's
    launch counts and the SPRITES --bf16 run's (result, launches)."""
    import torch

    paths, bf16_run = {}, None
    p50 = {"sprites": np.percentile(phase8["step_seconds"][1:], 50),
           "mnist": np.percentile(phase6["step_seconds"][1:], 50)}
    for flag, enc in (("--bf16", torch.bfloat16),
                      ("--bf16_hybrid", torch.float32)):
        argv = SPRITES_ARGV + [flag]
        with RecordedDtypes() as rec:
            res, paths[f"sprites_{flag.strip('-')}_train"] = \
                phase_sprites_train(corpus, argv, tag=f"sprites {flag}")
        rec.check(f"sprites {flag}", enc)
        sec = np.asarray(res["step_seconds"][1:])
        log(f"17(a) sprites {flag}: step p50 "
            f"{1e3 * np.percentile(sec, 50):.3f} ms, p90 "
            f"{1e3 * np.percentile(sec, 90):.3f} ms; fp32 (phase 8) p50 "
            f"{1e3 * p50['sprites']:.3f} ms")
        if flag == "--bf16":
            phase_bf16_cpu_check(res, argv)
            bf16_run = (res, paths["sprites_bf16_train"])
    with RecordedDtypes() as rec:
        res, launches = phase_train(mnist_data, TRAIN_ARGV + ["--bf16"], 32,
                                    TRAIN_STEPS, None, "mnist --bf16")
    rec.check("mnist --bf16", torch.bfloat16)
    in_steps = sum(sl["gp_sufficient_stats"] for sl in res["step_launches"])
    if launches["gp_sufficient_stats"] <= in_steps:
        raise AssertionError(f"mnist --bf16: B2 launched {in_steps} times "
                             "in the steps and never in the eval pass")
    paths["mnist_bf16_train"] = launches
    log(f"17(b) mnist --bf16: step p50 "
        f"{1e3 * np.percentile(res['step_seconds'][1:], 50):.3f} ms; fp32 "
        f"(phase 6) p50 {1e3 * p50['mnist']:.3f} ms")
    return paths, bf16_run


# --- phase 18 ---------------------------------------------------------------


class ranks_share_card:
    """Context: up to `n` ranks of a data-parallel run on each card
    (gloo; 1: NCCL, a card a rank), restored after."""

    def __init__(self, n: int):
        from svgpvae_tpu_torch.parallel import mesh
        self.key, self.n = mesh.RANKS_PER_DEVICE_ENV, n

    def __enter__(self):
        self.old = os.environ.get(self.key)
        os.environ[self.key] = str(self.n)

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop(self.key, None)
        else:
            os.environ[self.key] = self.old
        return False


def run_values(res, scores, series=("loss", "C_ma", "lagrange")) -> dict:
    """A run's per-step `series` (by default its losses and GECO state),
    its final parameters (one vector) and its last eval's `scores`, as
    float64 CPU tensors."""
    import torch
    from svgpvae_tpu_torch import train
    series = {"lagrange_mult" if k == "lagrange" else k:
              torch.tensor([m[k] for m in res["metrics"]],
                           dtype=torch.float64) for k in series}
    params = res["params"] if "params" in res else res["state"].params
    params = torch.cat([t.detach().reshape(-1).cpu().double() for t in
                        train.named_tensors(params).values()])
    ev = res["evals"][-1]
    return dict(series, params=params, **{
        k: torch.tensor(float(ev[k]), dtype=torch.float64) for k in scores})


def hold_runs(tag, got, r32, r64, names, sum_floor) -> None:
    """A data-parallel run (`got`) against the 1-process run (`r32`),
    each value within RECHECK_FACTOR x its gap to `r64` (another order or
    precision of the same run), floored as hold_to_cpu_gap floors; the
    parameters at DP_PARAM_FLOOR_STEPS Adam steps."""
    hold_to_cpu_gap(tag, got, r32, [], r64,
                    float(r64["loss"].abs().max()), sum_floor, names=names,
                    floors={"params": DP_PARAM_FLOOR_STEPS * DP_LR})


# Runs on the card do not repeat bit for bit (cuDNN's backward sums in an
# order of its own), and one rerun's gap is no measure of that spread:
# 20(b) held a resumed --epoch_chunk 5 --eval_bundle run to one unbroken
# rerun and once failed it on the eval MSE, 6.169e-6 against a floored
# limit of 3.506e-6 (an NVIDIA H100 80GB HBM3 at 700 W), where the same
# runs agree bit for bit under cudnn.deterministic (ROADMAP.md section
# C 12).  So a run that is held to reruns of its reference is held to the
# largest gap between any two of YARD_RUNS of them (hold_to_yard): 20(b),
# the captured SPRITES runs of 21(b), Casale's captured runs (phase 22)
# and phase 23's NCCL runs.  Three were too few: in one full run of phase
# 23 three MNIST reruns' cgen MSEs fell within 9.7e-7 of each other, where
# the captured 1-process run sat 6.7e-6 from the first and the 2-card run
# 1.45e-5 (against a floored limit of 1.37e-5; on NVIDIA H100 80GB HBM3,
# 700 W).
YARD_RUNS = 5


def hold_to_yard(tag, got, ref, yard, names, sum_floor, floors=None) -> None:
    """`got` (run_values of a run) against `ref` (those of the run it is
    held to), each value within RECHECK_FACTOR x the largest gap between
    two of the yardstick runs `yard` (run_values of YARD_RUNS or more
    reruns of the reference), floored as hold_runs floors (`floors` adds
    or overrides a key's floor)."""
    if len(yard) < YARD_RUNS:
        raise ValueError(f"{tag}: a yardstick of {len(yard)} runs, "
                         f"{YARD_RUNS} at least")
    gaps = {k: max(float((a[k] - b[k]).abs().max())
                   for i, a in enumerate(yard) for b in yard[i + 1:])
            for k in got}
    hold_within(tag, got, ref, yard[1],
                gaps, float(yard[1]["loss"].abs().max()) if "loss" in yard[1]
                else 0.0, sum_floor, names,
                {"params": DP_PARAM_FLOOR_STEPS * DP_LR, **(floors or {})})


def check_step_launches(tag, res, steps, want) -> None:
    """`steps` steps, each of whose launches on rank 0 satisfy `want`."""
    if len(res["metrics"]) != steps or not all(
            want(s) for s in res["step_launches"]):
        raise AssertionError(f"{tag}: {len(res['metrics'])} steps, rank 0 "
                             f"launching {res['step_launches']}")


def check_rank_launches(tag, res, ranks, want) -> dict:
    """Every rank's launches over the run: the same on every rank (each
    runs its share of every step and the replicated passes alike), and
    `want(counts)` must hold; returns their sum by kernel."""
    per_rank = res["rank_launches"]
    if len(per_rank) != ranks:
        raise AssertionError(f"{tag}: {len(per_rank)} ranks reported")
    for r, counts in enumerate(per_rank):
        if counts != per_rank[0] or not want(counts):
            raise AssertionError(f"{tag}: rank {r} launched {counts}")
    log(f"{tag}: launches per rank {per_rank}")
    return {k: sum(c[k] for c in per_rank) for k in per_rank[0]}


_F64_RUNS = {}


def mnist_f64_run(argv, mnist_data) -> dict:
    """argv's MNIST run in float64 (--x64, the plain path) on the fp32
    default draws (the seed-0 eps_fn's, widened): the yardstick of phases
    18(a) and 21(a), run once a process for each argv."""
    import torch
    from svgpvae_tpu_torch.cli import mnist
    key = tuple(argv)
    if key not in _F64_RUNS:
        base = mnist.default_eps_fn(0, torch.device("cuda"))
        _F64_RUNS[key] = mnist.main(
            list(argv) + ["--x64"], splits=mnist_data,
            eps_fn=lambda kind, shape: base(kind, shape).double())
    return _F64_RUNS[key]


def phase_dp_mnist(mnist_data, phase6) -> dict:
    """Phase 18(a): phase 6's run over 2 ranks sharing the card."""
    import torch
    from svgpvae_tpu_torch import ops
    from svgpvae_tpu_torch.cli import mnist

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with ranks_share_card(2):
        dp = mnist.main(TRAIN_ARGV + ["--data_parallel", "2"],
                        splits=mnist_data, capture_step=CAPTURE_STEP)
    seconds = time.perf_counter() - t0
    check_step_launches("mnist over 2 ranks", dp, TRAIN_STEPS,
                        lambda s: s["chol_inverse"] == 1
                        and s["gp_sufficient_stats"] >= 1)
    launches = check_rank_launches(
        "mnist over 2 ranks", dp, 2,
        lambda c: c["chol_inverse"] >= TRAIN_STEPS
        and c["gp_sufficient_stats"] > TRAIN_STEPS)
    x64 = mnist_f64_run(TRAIN_ARGV, mnist_data)
    scores = ("eval_mse", "test_mse", "cgen_mse")
    sec = np.asarray(dp["step_seconds"][1:])
    log(f"mnist over 2 ranks (gloo, one card): {TRAIN_STEPS} steps and the "
        f"eval in {seconds:.1f} s (spawning rank 1 included); step p50 "
        f"{1e3 * np.percentile(sec, 50):.2f} ms, p90 "
        f"{1e3 * np.percentile(sec, 90):.2f} ms (phase 6, 1 process: "
        f"{1e3 * np.percentile(phase6['step_seconds'][1:], 50):.2f} ms); "
        f"cgen MSE {dp['cgen_mse']:.6f} (phase 6 {phase6['cgen_mse']:.6f})")
    hold_runs("mnist over 2 ranks", run_values(dp, scores),
              run_values(phase6, scores), run_values(x64, scores),
              ("2 ranks", "1 process", "1 process f64"), SUM_FLOOR)
    phase_train_cpu_check(dp)
    return {"data_parallel_mnist": launches}


def phase_dp_sprites(corpus) -> dict:
    """Phase 18(b): phase 8's widths over 4 ranks on the small corpus,
    beside YARD_RUNS runs in 1 process."""
    from svgpvae_tpu_torch import ops
    from svgpvae_tpu_torch.cli import sprites

    steps = DP_SPRITES_CHARS * SPRITES_FPC // 500
    runs, launches = [], {}
    for ranks in [1] * YARD_RUNS + [4]:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with ranks_share_card(4):
            res = sprites.main(
                SPRITES_ARGV + (["--data_parallel", str(ranks)]
                                if ranks > 1 else []),
                splits=corpus, capture_step=DP_SPRITES_CAPTURE)
        check_step_launches(
            f"sprites over {ranks} rank(s)", res, steps,
            lambda s: (s["chol_inverse"], s["gp_sufficient_stats"],
                       s["fused_kernel_stats"]) == (2, 1, 0))
        sec = np.asarray(res["step_seconds"][1:])
        log(f"sprites over {ranks} rank(s) (one card): {steps} steps, "
            f"pretraining and the eval in {time.perf_counter() - t0:.1f} s; "
            f"step p50 {1e3 * np.percentile(sec, 50):.2f} ms; cgen MSE "
            f"{res['cgen_mse']:.6f}")
        if ranks > 1:
            launches[ranks] = check_rank_launches(
                f"sprites over {ranks} ranks", res, ranks,
                lambda c: c["chol_inverse"] >= 2 * steps
                and c["gp_sufficient_stats"] >= steps
                and c["fused_kernel_stats"] == 1)
        runs.append(res)
    scores = ("test_mse", "cgen_mse")
    ones = [run_values(r, scores) for r in runs[:-1]]
    hold_to_yard("sprites over 4 ranks", run_values(runs[-1], scores),
                 ones[0], ones, ("4 ranks", "1 process",
                                 f"1-process reruns (x{YARD_RUNS})"),
                 SPRITES_SUM_FLOOR)
    phase_sprites_cpu_check(runs[-1])
    return {"data_parallel_sprites": launches[4]}


def phase_dp_serve(run_dir, corpus, out_dir) -> dict:
    """Phase 18(c): phase 13(c)'s serve on the small corpus with its fit
    over 2 ranks, beside the same serve in 1 process."""
    from svgpvae_tpu_torch import ops
    from svgpvae_tpu_torch.cli import serve

    argv = ["--run_dir", run_dir, "--device", "cuda", "--out",
            os.path.join(out_dir, "sprites_dp.npz")]
    unsharded = serve.main(argv, splits=corpus)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with ranks_share_card(2):
        res = serve.main(argv + ["--data_parallel", "2"], splits=corpus)
    want = {"chol_inverse": 0, "fused_kernel_stats": 1,
            "gp_sufficient_stats": 0}
    launches = check_rank_launches("serve over 2 ranks", res, 2,
                                   lambda c: c == want)
    if res["fit_launches"] != want:
        raise AssertionError(f"serve over 2 ranks: the fit launched "
                             f"{res['fit_launches']}")
    served, one = res["state"]["served"][0], \
        unsharded["state"]["served"][0]
    log(f"serve over 2 ranks: {time.perf_counter() - t0:.1f} s (spawning "
        f"rank 1 and pickling the corpus to it included), fit "
        f"{res['seconds']['fit']:.4f} s (1 process "
        f"{unsharded['seconds']['fit']:.4f} s); against the 1-process fit: "
        + ", ".join(f"{k} {float((served[k] - one[k]).abs().max()):.3e} "
                    f"(max|.| {float(one[k].abs().max()):.3e})"
                    for k in ("p_m", "p_v")))
    phase_cpu_check("sprites run, fit over 2 ranks", res,
                    RUN_FIT_NOISE_FACTOR)
    return {"data_parallel_serve": launches}


def phase_data_parallel(mnist_data, phase6, sprites_run_dir,
                        out_dir) -> dict:
    """Phase 18: --data_parallel, every rank's launches counted; (b) and
    (c) on a DP_SPRITES_CHARS-character corpus."""
    from svgpvae_tpu_torch import data
    out = {}
    t0 = time.perf_counter()
    out.update(phase_dp_mnist(mnist_data, phase6))
    log(f"[18(a): {time.perf_counter() - t0:.1f} s]")
    corpus = data.generate_synthetic_sprites(
        n_train_chars=DP_SPRITES_CHARS, n_test_chars=DP_SPRITES_CHARS // 4,
        n_frames_train=SPRITES_FPC, seed=0)
    t0 = time.perf_counter()
    out.update(phase_dp_sprites(corpus))
    log(f"[18(b): {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    out.update(phase_dp_serve(sprites_run_dir, corpus, out_dir))
    log(f"[18(c): {time.perf_counter() - t0:.1f} s]")
    return out


# --- phase 19 ---------------------------------------------------------------
# Phase 19(a): phase 14's Hensman and Titsias runs, 100 steps with an eval
# pass and a picture pass (the eval drawn, the two probes) every 50 steps.
PICTURE_ARGV = ["--steps", "100", "--eval_every", "50", "--plot_every", "50",
                "--save", "--squares_circles", "--device", "cuda", "--seed",
                "0"]
PICTURE_RUNS = ("ball_hensman_train", "ball_titsias_train")


def _ball_probes_cpu(tag, res, base_dir, dtype) -> dict:
    """Phase 19(a): the last picture pass redone on the CPU with the twins
    in `dtype`, from the run's final weights and the eval draw: the eval
    batch's mse_rotation W, then each probe's aligned latents."""
    import torch
    from svgpvae_tpu_torch import train, utils
    from svgpvae_tpu_torch.cli import ball

    args = _ball_args(tag)
    args.base_dir = base_dir
    cpu = torch.device("cpu")
    snap = {"params": {k: t.detach() for k, t in
                       train.named_tensors(res["state"].params).items()},
            "vids": torch.zeros(1, args.tmax)}
    params = _ball_step_params(snap, res["state"].params["gp"], cpu, dtype)
    # the eval draw of cli.mnist.default_eps_fn, made on the run's device
    run = res["state"].params["gp"].inducing_points.device
    eps = torch.randn((ball.BATCH, args.tmax, 2), device=run,
                      generator=torch.Generator(device=run).manual_seed(
                          ball.EVAL_SEED)).to(cpu, dtype)
    forward = ball.make_forward(args, lambda kind, shape: eps, None,
                                args.modellt)
    tt0, td0 = ball.load_test_batches(args)[0]
    with torch.no_grad():
        out = forward(params, torch.as_tensor(td0, dtype=dtype), "eval", 1.0)
    _, W, _, _ = utils.mse_rotation(out.p_m.numpy().astype(np.float64), tt0,
                                    out.p_v.numpy().astype(np.float64))
    return {kind: ball.probe_latents(forward, params, kind, W, args.tmax,
                                     cpu, dtype)[2] for kind in ball.PROBES}


def phase_picture_ball(tag, base_dir) -> tuple:
    """Phase 19(a): one ball run with the pictures and probes; returns its
    result and launch counts."""
    import torch
    from svgpvae_tpu_torch import ops
    from svgpvae_tpu_torch.cli import ball
    from svgpvae_tpu_torch.gp import fused

    argv, _, stack = BALL_RUNS[tag]
    shapes, kernel = set(), fused.chol_inverse

    def recording(M):
        shapes.add(tuple(M.shape))
        return kernel(M)

    fused.chol_inverse = recording
    try:
        ops.reset_launch_counts()
        res = ball.main(argv + PICTURE_ARGV + ["--base_dir", base_dir])
        launches = ops.launch_counts()
    finally:
        fused.chol_inverse = kernel
    want = {"chol_inverse": 1, "fused_kernel_stats": 0,
            "gp_sufficient_stats": 0}
    if shapes != {stack} or any(sl != want for sl in res["step_launches"]) \
            or any(ev["launches"] != want for ev in res["evals"]):
        raise AssertionError(f"{tag}: B1 on {shapes}; steps "
                             f"{res['step_launches'][:2]}...")
    per_plot = {"chol_inverse": 3, "fused_kernel_stats": 0,
                "gp_sufficient_stats": 0}
    plots = res["pictures"]
    if [p["step"] for p in plots] != [50, 100] or \
            any(p["launches"] != per_plot for p in plots):
        raise AssertionError(f"{tag}: picture passes "
                             f"{[(p['step'], p['launches']) for p in plots]}")
    if launches["chol_inverse"] != 100 + 2 + 3 * 2:
        raise AssertionError(f"{tag}: the run launched {launches}")
    r32 = _ball_probes_cpu(tag, res, base_dir, torch.float32)
    r64 = _ball_probes_cpu(tag, res, base_dir, torch.float64)
    for kind, got in plots[-1]["probes"].items():
        scale = np.abs(r64[kind]).max()
        gap = np.abs(r32[kind] - r64[kind]).max()
        err = np.abs(got - r32[kind]).max()
        limit = max(CPU_RTOL * scale, RECHECK_FACTOR * gap)
        log(f"{tag} {kind} probe at step 100: card vs CPU fp32 {err:.3e}, "
            f"CPU fp32 vs f64 {gap:.3e}, limit {limit:.3e} (max |latent| "
            f"{scale:.3f})")
        if not np.isfinite(got).all() or err > limit:
            raise AssertionError(f"{tag} {kind} probe off the CPU twin")
    log(f"{tag} with pictures: B1 on {stack} in every step, eval and "
        f"probe; per picture pass {plots[0]['launches']}; the run "
        f"{launches}; final MSE {res['mse']:.4f}")
    return res, launches


def jax_picture_names(driver, flags, eval_steps) -> dict:
    """{name: ((height, width), the text entries it must hold)} of the
    pics/*.png the JAX driver writes for a run with these flags at these
    eval steps: MNIST <s>.png, <s>_cgen.png (SVGPVAE, CVAE) and, under
    --save, <s>_kernels.png (SVGPVAE); SPRITES <s>_recon.png and
    <s>_cgen.png (SVGPVAE); the ball <s:06d>.png and, with
    --squares_circles, the two probes (figures without a title)."""
    grid = ((1000, 1000), ("Title",))
    names = {}
    for s in eval_steps:
        if driver == "mnist":
            names[f"{s}.png"] = names[f"{s}_cgen.png"] = grid
            if "--save" in flags:
                names[f"{s}_kernels.png"] = ((400, 1500), tuple(
                    f"Panel {k}" for k in range(3)))
        elif driver == "sprites":
            names[f"{s}_recon.png"] = names[f"{s}_cgen.png"] = grid
        else:
            names[f"{s:06d}.png"] = ((600, 800), ())
            if "--squares_circles" in flags:
                for kind in ("circles", "squares"):
                    names[f"{s:06d}_{kind}.png"] = ((400, 800), ())
    return names


def check_run_pictures(tag, run_dir, want) -> None:
    """Phase 19(b): run_dir/pics holds exactly `want`'s names, each
    decoded at its size, not constant, with its text entries."""
    from svgpvae_tpu_torch.utils.png import read_png

    pics = os.path.join(run_dir, "pics")
    got = sorted(p for p in os.listdir(pics) if p.endswith(".png"))
    if got != sorted(want):
        raise AssertionError(f"{tag}: pics {got}, the JAX driver's "
                             f"{sorted(want)}")
    for name in got:
        rgb, text = read_png(os.path.join(pics, name))
        size, keys = want[name]
        if rgb.shape[:2] != size or rgb.min() == rgb.max() or \
                not all(text.get(k) for k in keys):
            raise AssertionError(f"{tag} {name}: {rgb.shape}, texts "
                                 f"{text}")
    log(f"19(b) {tag}: {len(got)} pictures as the JAX driver names them, "
        f"decoded at their sizes: {got}")


def phase_pictures(base_dir, saved_runs) -> dict:
    """Phase 19: (a) the ball runs with pictures and probes, (b) every
    saved run's pics/ against the JAX names, (c) the host ms of each
    picture kind.  Returns the launch counts of (a)'s runs, summed."""
    seconds, launches = {}, {}
    for tag in PICTURE_RUNS:
        res, counts = phase_picture_ball(tag, base_dir)
        launches = {k: launches.get(k, 0) + v for k, v in counts.items()}
        check_run_pictures(f"19(a) {tag}", res["run_dir"], jax_picture_names(
            "ball", PICTURE_ARGV, [50, 100]))
        for p in res["pictures"]:
            for kind in ("latents", "circles", "squares"):
                seconds.setdefault(f"ball {kind}", []).append(
                    p["seconds"][kind])
    mnist_epoch = MNIST_EPOCH_STEPS
    mnist_run, mnist_pictures = saved_runs.pop("13(a)")
    # 13(a): one saved epoch, then one resumed without --save (no metric
    # rows, so no kernel picture)
    want = jax_picture_names("mnist", ["--save"], [mnist_epoch])
    want.update(jax_picture_names("mnist", [], [2 * mnist_epoch]))
    check_run_pictures("13(a)", mnist_run, want)
    records = {"13(a)": mnist_pictures}
    for tag, res in saved_runs.items():
        driver = "mnist" if "eval_mse" in res["evals"][-1] else "sprites"
        steps = len(res["step_seconds"])
        check_run_pictures(tag, res["run_dir"], jax_picture_names(
            driver, ["--save"], [steps]))
        records[tag] = res["pictures"]
    for tag, recs in records.items():
        driver = "sprites" if tag in ("8", "16(e)") else "mnist"
        for p in recs:
            seconds.setdefault(f"{driver} {p['kind']}", []).append(
                p["seconds"])
    log("19(c) host ms per picture (copy, draw, PNG write): " + "; ".join(
        f"{k} " + ", ".join(f"{1e3 * v:.1f}" for v in vs)
        for k, vs in sorted(seconds.items())))
    return launches


# --- phase 20 ---------------------------------------------------------------
# --epoch_chunk and --eval_bundle as replayed CUDA graphs.  (a) Phase 6's
# run under --lr_decay in chunks of 2 epochs with the bundled eval, held
# to its eager run as phase 18(a) holds its 2-rank run (per-step loss and
# GECO state, final parameters, eval MSEs within RECHECK_FACTOR x the
# same run's fp32-vs-float64 gap, on the same draws); B1 and B2 must
# launch as often as in phase 6.  (b) 10 epochs in chunks of 5 (an eval,
# and with --save a checkpoint, every 5), the second chunk and eval group
# of one run traced on the card (ReplayTrace), saved, restored (bit for
# bit) and resumed for its last 5 epochs, held to the unbroken run as (a)
# holds its run, the yardstick the largest gap among YARD_RUNS unbroken
# runs (cuDNN's backward does not repeat bit for bit on the card, so no
# two runs do, and one rerun's gap is no limit: see YARD_RUNS), the noise
# generator's state ending equal.  (c) Phase 11's Titsias run and
# phase 15's deep SVIGP run
# in chunks of 2, each held to its eager run as (a): Titsias to its
# float64 gap; deep SVIGP, whose run draws nothing and refuses --x64, to
# the gap of its eager run on train pixels nudged by one fp32 ulp (a
# perturbation at round-off's scale, which the run amplifies as it does
# round-off; reversing each batch's rows would not do: the driver's KDE
# inducing points are drawn from the rows in their order).  Its loss is
# itself the sum of a batch's 256 x 784 squared errors (over noise^2, to
# ~1e6), so its floor is that sum's random-walk round-off, SUM_FLOOR of
# its magnitude (phase 7's floor of a gradient), not one ulp: the
# chunked run's per-step losses came 2.875 from the eager run's (24
# ulps) and the nudged run's 0.44 (on an NVIDIA H100 80GB HBM3 at
# 700.00 W), both under that floor.
CHUNK_ARGV = ["--epoch_chunk", "2", "--eval_bundle"]
# (a) runs phase 6's run with a cosine lr decay: the lr of every captured
# step comes from the graphs' per-step table
LR_DECAY_ARGV = ["--lr_decay", "0.1"]
# The kernels' __global__ functions, as a trace of the card names them:
# one of them per counted launch (B1 at m <= 80: the warp or the blocked
# form; B2: its stats kernel, and not the reduce behind it; B3: its build
# kernel)
DEVICE_KERNELS = {
    "chol_inverse": ("gauss_jordan_inverse_warp", "gauss_jordan_blocked"),
    "gp_sufficient_stats": ("stats_small_kernel", "stats_partial_kernel"),
    "fused_kernel_stats": ("build_k_kernel",)}
CHUNK_RESUME_EPOCHS = 5
CHUNK_RESUME_ARGV = [{"joint-2": f"joint-{CHUNK_RESUME_EPOCHS}",
                      "2": str(CHUNK_RESUME_EPOCHS)}.get(a, a)
                     for a in TRAIN_ARGV] + [
    "--epoch_chunk", str(CHUNK_RESUME_EPOCHS), "--eval_bundle"]


def launched(fn, *args, **kwargs) -> tuple:
    """fn's result and the kernel launches it made."""
    from svgpvae_tpu_torch import ops
    before = ops.launch_counts()
    res = fn(*args, **kwargs)
    return res, {k: v - before[k] for k, v in ops.launch_counts().items()}


class ReplayTrace:
    """on_eval hook of a chunked, bundled run: from the end of its first
    eval (behind it the first chunk's warm-ups and captures and the eval
    group's warm-up and capture) to `stop()`, a torch.profiler trace of
    the card and the launch counters.  Every kernel in that window comes
    from a graph replay."""

    def __init__(self):
        self.prof = self.before = None

    def __call__(self, ev) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        from svgpvae_tpu_torch import ops
        if self.prof is None:
            torch.cuda.synchronize()
            self.before = ops.launch_counts()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()

    def stop(self) -> tuple:
        """(the kernels' launches the trace saw, by kernel; the counters'
        launches over the window)."""
        import torch
        from svgpvae_tpu_torch import ops
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        counted = {k: v - self.before[k]
                   for k, v in ops.launch_counts().items()}
        seen = dict.fromkeys(DEVICE_KERNELS, 0)
        for e in self.prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for k, names in DEVICE_KERNELS.items():
                seen[k] += any(n in e.name for n in names)
        # B3 runs B2's stats kernel on the K it builds: one more a B3 launch
        seen["gp_sufficient_stats"] -= seen["fused_kernel_stats"]
        return seen, counted


def check_traced_replays(tag, res, seen, counted, chunk_epochs) -> None:
    """The traced window of `res` (ReplayTrace: its last chunk of
    `chunk_epochs` epochs and its last eval group, all replays): the
    launches the card ran equal the counters' and each graph's launches
    (counted at its capture) times its replays in the window, and B1 and
    B2 ran."""
    per_epoch = len(res["metrics"]) // len(res["chunks"]) // chunk_epochs
    g = res["graph_launches"]
    want = {k: chunk_epochs * ((per_epoch - 1) * g["full"][k] + g["tail"][k])
            + g["eval"][k] for k in seen}
    if (seen != counted or seen != want or seen["chol_inverse"] < 1
            or seen["gp_sufficient_stats"] < 1):
        raise AssertionError(f"{tag}: the trace saw {seen}; the counters "
                             f"{counted}; the graphs' launches x replays "
                             f"{want} ({g})")


def check_graphs(tag, res, want=("full", "tail", "eval")) -> None:
    replays = res["graph_replays"]
    if any(replays.get(k, 0) < 1 for k in want):
        raise AssertionError(f"{tag}: graph replays {replays}, every one of "
                             f"{want} must have replayed")


def check_chunk_launches(tag, res, counts, eager_counts, steps) -> None:
    """`steps` steps, B1 once and B2 at least once in each, and the run's
    launches those of its eager run."""
    if (len(res["metrics"]) != steps or counts != eager_counts
            or any(sl["chol_inverse"] != 1 or sl["gp_sufficient_stats"] < 1
                   for sl in res["step_launches"])):
        raise AssertionError(f"{tag}: {len(res['metrics'])} steps launching "
                             f"{res['step_launches'][:3]}...; the run "
                             f"launched {counts}, its eager run "
                             f"{eager_counts}")


def chunk_timing(tag, res, eager) -> str:
    """The chunks' seconds, the later chunks' p50 per step, and the eval
    groups' seconds, beside the eager run's step p50 and eval seconds."""
    later = [c["seconds"] / c["steps"] for c in res["chunks"][1:]]
    first = res["chunks"][0]
    return (f"{tag}: chunks {[round(c['seconds'], 4) for c in res['chunks']]}"
            f" s (the first, with the warm-up and captures: "
            f"{1e3 * first['seconds'] / first['steps']:.3f} ms a step)"
            + (f", later chunks p50 {1e3 * np.percentile(later, 50):.3f} ms "
               "a step (chunk seconds / steps)" if later else "")
            + f"; eval seconds {[ev['seconds'] for ev in res['evals']]}; "
            f"eager run: step p50 "
            f"{1e3 * np.percentile(eager['step_seconds'][1:], 50):.3f} ms, "
            f"eval {eager['evals'][-1]['seconds']}")


def nudged_images(splits) -> dict:
    """The splits with every train pixel scaled by 1 + 2^-23: each
    nonzero one moves by about one fp32 ulp."""
    tr = splits["train"]
    images = (tr["images"] * np.float32(1 + 2.0 ** -23)).astype(np.float32)
    return dict(splits, train=dict(tr, images=images))


def deterministic_resume(splits, long_argv, base_dir, scores) -> None:
    """20(b) under cuDNN's deterministic algorithms (ROADMAP.md section C
    12): the unbroken run twice, the saved run and the resumed one.  The
    reruns must agree bit for bit (else the card is not deterministic
    here and the check says so), and then the saved run must equal the
    unbroken run's first half and the resumed run its second half, bit
    for bit: per-step loss and GECO state, final parameters, eval
    scores."""
    import torch
    from svgpvae_tpu_torch.cli import mnist

    def values(res, lo=0):
        return {**{k: [m[k] for m in res["metrics"][lo:]]
                   for k in ("loss", "C_ma", "lagrange")},
                "scores": [res["evals"][-1][k] for k in scores]}

    det, bench = torch.backends.cudnn.deterministic, \
        torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        runs = [mnist.main(long_argv, splits=splits) for _ in range(2)]
        saved = mnist.main(CHUNK_RESUME_ARGV + SAVE_ARGV + [
            "--base_dir", os.path.join(base_dir, "deterministic")],
            splits=splits)
        resumed = mnist.main(CHUNK_RESUME_ARGV + ["--resume_dir",
                                                  saved["run_dir"]],
                             splits=splits)
    finally:
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = bench
    half = len(saved["metrics"])
    checks = {
        "rerun": (values(runs[1]), values(runs[0]), runs[1], runs[0]),
        "saved": ({k: v for k, v in values(saved).items() if k != "scores"},
                  {k: v[:half] for k, v in values(runs[0]).items()
                   if k != "scores"}, None, None),
        "resumed": (values(resumed), values(runs[0], half), resumed,
                    runs[0])}
    bad = [tag for tag, (a, b, ra, rb) in checks.items() if a != b or (
        ra is not None and state_mismatches(ra["state"], rb["state"]))]
    if bad:
        raise AssertionError(f"20(b) deterministic: {bad} differ bit for "
                             "bit from the unbroken run")
    log(f"20(b) under cudnn.deterministic: the unbroken run, its rerun, the "
        f"saved run ({half} steps) and the resumed one agree bit for bit "
        f"(per-step loss and GECO state, the final state, the eval scores; "
        f"cgen MSE {runs[0]['evals'][-1]['cgen_mse']:.9f})")


def phase_epoch_chunk(splits, phase6, phase11, base_dir) -> dict:
    """Phase 20; `phase6` and `phase11` are (result, launches) of those
    phases' eager runs.  Returns {"epoch_chunk": the kernel launches the
    trace of 20(b) saw on the card}."""
    import torch
    from svgpvae_tpu_torch import ops
    from svgpvae_tpu_torch.cli import mnist

    scores = ("eval_mse", "test_mse", "cgen_mse")
    names = ("chunked", "eager", "eager f64")
    base = mnist.default_eps_fn(0, torch.device("cuda"))

    def f64(argv):  # the run in float64 on the same draws (plain path)
        return mnist.main(argv + ["--x64"], splits=splits,
                          eps_fn=lambda kind, shape: base(kind,
                                                          shape).double())

    # (a) phase 6's run under --lr_decay, eager, chunked and bundled; (c)
    # phase 11's
    decay_argv = TRAIN_ARGV + LR_DECAY_ARGV
    decay_eager, decay_counts = launched(mnist.main, decay_argv,
                                         splits=splits, per_step=True)
    if decay_counts != phase6[1]:
        raise AssertionError(f"20(a): the eager --lr_decay run launched "
                             f"{decay_counts}, phase 6 {phase6[1]}")
    for tag, argv, eager, eager_counts in (
            ("20(a) mnist --lr_decay", decay_argv, decay_eager, phase6[1]),
            ("20(c) mnist titsias", TITSIAS_ARGV, *phase11)):
        res, counts = launched(mnist.main, argv + CHUNK_ARGV, splits=splits)
        check_graphs(tag, res)
        check_chunk_launches(tag, res, counts, eager_counts, TRAIN_STEPS)
        log(chunk_timing(f"{tag} chunked + bundled", res, eager)
            + f"; launches {counts} (eager {eager_counts}); graph replays "
            f"{res['graph_replays']}; cgen MSE {res['cgen_mse']:.6f} "
            f"(eager {eager['cgen_mse']:.6f})")
        hold_runs(f"{tag} chunked", *(run_values(r, scores) for r in (
            res, eager, f64(argv))), names, SUM_FLOOR)

    # (b) 10 epochs in chunks of 5: unbroken twice, saved + resumed
    long_argv = [{f"joint-{CHUNK_RESUME_EPOCHS}":
                  f"joint-{2 * CHUNK_RESUME_EPOCHS}"}.get(a, a)
                 for a in CHUNK_RESUME_ARGV]
    trace = ReplayTrace()
    ops.reset_launch_counts()
    runs = [mnist.main(long_argv, splits=splits, on_eval=trace)]
    seen, counted = trace.stop()
    check_traced_replays("20(b) traced", runs[0], seen, counted,
                         CHUNK_RESUME_EPOCHS)
    log(f"20(b) the last chunk and eval group of the first unbroken run, "
        f"traced: the card ran {seen} (the counters {counted}; per "
        f"replay {runs[0]['graph_launches']})")
    runs += [mnist.main(long_argv, splits=splits)
             for _ in range(YARD_RUNS - 1)]
    saved = mnist.main(CHUNK_RESUME_ARGV + SAVE_ARGV + ["--base_dir",
                                                        base_dir],
                       splits=splits)
    restored = mnist.main(
        [{f"joint-{CHUNK_RESUME_EPOCHS}": "joint-0"}.get(a, a)
         for a in CHUNK_RESUME_ARGV] + ["--resume_dir", saved["run_dir"]],
        splits=splits)
    bad = state_mismatches(restored["state"], saved["state"])
    same_noise = torch.equal(restored["noise"].generator.get_state(),
                             saved["noise"].generator.get_state())
    if bad or not same_noise:
        raise AssertionError(f"20(b): the restored state differs from the "
                             f"saved one in {bad[:5]}, noise identical "
                             f"{same_noise}")
    resumed = mnist.main(CHUNK_RESUME_ARGV + ["--resume_dir",
                                              saved["run_dir"],
                                              "--save_model_weights"],
                         splits=splits)
    for tag, r in (("unbroken", runs[0]), ("saved", saved),
                   ("resumed", resumed)):
        check_graphs(f"20(b) {tag}", r)
    if not torch.equal(resumed["noise"].generator.get_state(),
                       runs[0]["noise"].generator.get_state()):
        raise AssertionError("20(b): the resumed run's noise generator "
                             "ends apart from the unbroken run's")
    half = len(saved["metrics"])
    got, *yard = (run_values(dict(r, metrics=r["metrics"][-half:]), scores)
                  for r in [resumed] + runs)
    hold_to_yard("20(b) resumed", got, yard[0], yard,
                 ("resumed", "unbroken", f"unbroken reruns (x{len(yard)})"),
                 SUM_FLOOR)
    deterministic_resume(splits, long_argv, base_dir, scores)
    log(chunk_timing("20(b) mnist 10 epochs in chunks of 5 (the untraced "
                     "run)", runs[1], phase6[0]))

    # (c) deep SVIGP: held to the gap of its eager run on nudged pixels
    svigp_argv = _baseline_argv("svigp_train")
    eager = mnist.main(svigp_argv, splits=splits, per_step=True)
    nudged = mnist.main(svigp_argv, splits=nudged_images(splits),
                        per_step=True)
    sres, counts = launched(mnist.main, svigp_argv + ["--epoch_chunk", "2"],
                            splits=splits)
    check_graphs("20(c) svigp", sres, ("full", "tail"))
    if any(counts.values()):
        raise AssertionError(f"20(c) svigp launched {counts}")
    log(chunk_timing("20(c) deep svigp chunked", sres, eager)
        + f"; graph replays {sres['graph_replays']}")
    got, r32, r64 = (run_values(r, ("cgen_mse",), ("loss",))
                     for r in (sres, eager, nudged))
    scale = float(r64["loss"].abs().max())
    hold_to_cpu_gap("20(c) deep svigp chunked", got, r32, [], r64, scale,
                    SUM_FLOOR, names=("chunked", "eager",
                                      "eager, pixels nudged"),
                    floors={"params": DP_PARAM_FLOOR_STEPS * DP_LR,
                            "loss": SUM_FLOOR * scale})
    return {"epoch_chunk": seen}


# --- phase 21 ---------------------------------------------------------------
# The default training loops (--epoch_chunk 1 on MNIST, the SPRITES
# epochs, the ball's chunks) replayed from captured CUDA graphs, each held
# to its driver's per-step run of the same argv and draws (phases 6, 11,
# 8, 17(a), 12 and 14's runs) as 20(a) holds a chunked run: within
# RECHECK_FACTOR x a yardstick gap, floored as hold_runs floors.
# MNIST's yardstick is 20(a)'s, the run in float64 on the same draws.
# The others' is the per-step run with a capturable Adam (its step
# counts on the card, its bias corrections there in fp32): the
# reordering of Adam's arithmetic that capture brings, in an eager run
# (the ball's steps run no cuDNN: two per-step runs agree bit for bit and
# would give no gap).  The trace of each: a captured run with
# --profile_dir, which traces MNIST's and SPRITES's epoch 1 and the
# ball's second chunk; tag -> (the extra argv: SPRITES runs 2 epochs,
# the ball's shorter runs chunks of half their steps; the traced steps;
# as many steps of the per-step run; the window of the trace's graph
# replays for the idle share: MNIST's before its tail step, which is
# captured there, and all of the others').
# 21(b)'s SPRITES runs: phase 8's flags on a DEFAULT_LOOP_CHARS-character
# corpus (25 steps an epoch), each held to its own per-step run there.  The
# depth is cut from phase 8's 1,000 characters for the time of the phase's
# 3 x YARD_RUNS per-step runs (ROADMAP.md section C 18), and the trace of
# an epoch holds a quarter of the replays (section C 16).
DEFAULT_LOOP_CHARS = 250
DEFAULT_LOOP_STEPS = DEFAULT_LOOP_CHARS * SPRITES_FPC // 500
DEFAULT_LOOP_TRACES = {
    "mnist": ([], slice(32, 64), slice(32, 64), (0, 31)),
    "sprites": (["--opt_regime", "joint-2", "--eval_every", "2"],
                slice(DEFAULT_LOOP_STEPS, 2 * DEFAULT_LOOP_STEPS),
                slice(0, DEFAULT_LOOP_STEPS), (0, DEFAULT_LOOP_STEPS)),
    "ball_hensman_train": ([], slice(500, 1000), slice(500, 1000),
                           (0, 500)),
    "ball_titsias_train": (["--eval_every", "250"], slice(250, 500),
                           slice(250, 500), (0, 250)),
    "ball_pearce_train": (["--eval_every", "50"], slice(50, 100),
                          slice(50, 100), (0, 50)),
    "ball_np_train": (["--eval_every", "50"], slice(50, 100),
                      slice(50, 100), (0, 50))}
ANNOTATIONS = ("train_step", "gp_block", "eval_pass", "pictures")
# NCCL's all-reduce kernels, as a trace of the card names them
# (ncclDevKernel_AllReduce_Sum_f32_RING_LL and the like): both words,
# lower-cased
NCCL_ALL_REDUCE = ("nccl", "allreduce")


class reordered_adam:
    """While open, train.make_optimizer hands out a capturable Adam (the
    per-step yardstick of phase 21)."""

    def __enter__(self):
        from svgpvae_tpu_torch import train
        self.make = make = train.make_optimizer

        def capturable(tensors, lr):
            opt = make(tensors, lr)
            opt.param_groups[0]["capturable"] = True
            return opt
        train.make_optimizer = capturable
        return self

    def __exit__(self, *exc):
        from svgpvae_tpu_torch import train
        train.make_optimizer = self.make
        return False


def traced_steps(driver, argv, kw, base_dir, steps, window) -> tuple:
    """driver.main(argv + --profile_dir, **kw), its default loop captured,
    and its one Chrome trace (MNIST and SPRITES: epoch 1; the ball: its
    second chunk) read back: (the kernels' launches the trace saw, by
    DEVICE_KERNELS; the counters' launches over the traced steps, the
    `steps` slice of the run's step_launches; read_trace's record over
    `window` with "ms_per_step" added: its ms over its steps, a third
    entry of `window` when there is one, else its replays)."""
    trace_dir = tempfile.mkdtemp(prefix="trace_", dir=base_dir)
    res = driver.main(argv + ["--profile_dir", trace_dir], **kw)
    (path,) = glob.glob(os.path.join(trace_dir, "*.json"))
    seen, win = read_trace(path, window)
    counted = {k: sum(sl[k] for sl in res["step_launches"][steps])
               for k in seen}
    lo, hi, *n_steps = window
    win["ms_per_step"] = win["ms"] / (n_steps[0] if n_steps else hi - lo)
    return seen, counted, win


def read_trace(path, window=None) -> tuple:
    """A Chrome trace of the card: (the kernels' launches it saw, by
    DEVICE_KERNELS; {"ms", "idle", "replay_kernels", "nccl",
    "nccl_in_replays", "nccl_ms", "replays"}).  "ms" and "idle" are over
    the graph replays window[0]..window[1] - 1 (each one cudaGraphLaunch),
    or with `window` None over every record of the card: the window runs
    on the card's clock from the first of its replays' kernels to the end
    of the last one's (a kernel joins its launch by the trace's
    correlation id), its idle share 1 - the union of the card's intervals
    (kernels, copies, memsets) in it over its length; "replay_kernels" the
    card's kernel records of each traced cudaGraphLaunch, in order (see
    replay_gaps); "nccl" the NCCL all-reduce kernels, "nccl_in_replays"
    those of graph replays, "nccl_ms" their device ms."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    seen = dict.fromkeys(DEVICE_KERNELS, 0)
    device, launches, kernels = [], [], collections.Counter()
    nccl = []
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        corr = e.get("args", {}).get("correlation")
        ts = e.get("ts", 0.0)
        if cat == "cuda_runtime" and name.startswith("cudaGraphLaunch"):
            launches.append((ts, corr))
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((ts, ts + e.get("dur", 0.0), corr))
            kernels[corr] += cat == "kernel"
            for k, names in DEVICE_KERNELS.items():
                seen[k] += cat == "kernel" and any(n in name for n in names)
            if cat == "kernel" and all(w in name.lower()
                                       for w in NCCL_ALL_REDUCE):
                nccl.append((corr, e.get("dur", 0.0)))
    # B3 runs B2's stats kernel on the K it builds: one more a B3 launch
    seen["gp_sufficient_stats"] -= seen["fused_kernel_stats"]
    launches.sort()
    if window is None:
        t0 = min(a for a, _, _ in device)
        t1 = max(b for _, b, _ in device)
    else:
        lo, hi, *_ = window
        if len(launches) < hi:
            raise AssertionError(f"{path}: {len(launches)} graph replays "
                                 f"traced, the window needs {hi}")
        chosen = {c for _, c in launches[lo:hi]}
        mine = [(a, b) for a, b, c in device if c in chosen]
        t0, t1 = min(a for a, _ in mine), max(b for _, b in mine)
    busy, end = 0.0, t0
    for a, b, _ in sorted(device):
        a, b = max(a, end), min(b, t1)
        if b > a:
            busy += b - a
            end = b
    replays = {c for _, c in launches}
    return seen, {"ms": (t1 - t0) / 1e3, "idle": 1.0 - busy / (t1 - t0),
                  "replay_kernels": [kernels[c] for _, c in launches],
                  "replays": len(launches), "nccl": len(nccl),
                  "nccl_in_replays": sum(c in replays for c, _ in nccl),
                  "nccl_ms": sum(d for _, d in nccl) / 1e3}


def replay_gaps(replay_kernels: list) -> list:
    """(position, kernel records) of the traced graph replays whose
    record count is not the most common one."""
    if not replay_kernels:
        return []
    mode = collections.Counter(replay_kernels).most_common(1)[0][0]
    return [(i, n) for i, n in enumerate(replay_kernels) if n != mode]


def default_loop(tag, driver, argv, eager, eager_counts, traced, kw,
                 base_dir, check_steps, scores, sum_floor,
                 series=("loss", "C_ma", "lagrange"), unit="epochs",
                 yardstick=None, extra_hold=None, pairwise=False) -> tuple:
    """Phase 21 for one run: `driver.main(argv, **kw)` with its default
    loop, captured, against `eager` (its per-step run, launching
    `eager_counts`): graph replays, `check_steps(res)` (each step's
    launches), the run's launches those of the per-step run; the run
    held as 20(a) holds a chunked one, the yardstick `yardstick()` (name,
    result), by default the per-step run with a capturable Adam.
    `traced` = (extra argv, the traced steps, the per-step run's steps of
    the same count, the window): a captured run of argv + extra traced by
    its --profile_dir,
    whose kernels the card ran equal the counters' over the traced steps
    and the per-step run's over as many steps.  With `pairwise` the
    run is held to the per-step run within the largest gap between any
    two of it and YARD_RUNS - 1 capturable-Adam reruns (hold_to_yard).
    `extra_hold(tag,
    res, eager, yard)`, when given, holds more of the run (SPRITES: its
    pretraining).  Returns the launches the trace saw and the captured
    run's by the counters."""
    import torch
    from svgpvae_tpu_torch import ops
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    res, counts = launched(driver.main, argv, **kw)
    peak = torch.cuda.max_memory_allocated()
    replays = res["graph_replays"]
    if not replays or any(v < 1 for v in replays.values()):
        raise AssertionError(f"{tag}: graph replays {replays}")
    check_steps(res)
    extra, steps, eager_steps, window = traced
    seen, counted, win = traced_steps(driver, argv + extra,
                                      kw, base_dir, steps,
                                      window)
    eager_window = {k: sum(sl[k] for sl in eager["step_launches"]
                           [eager_steps]) for k in seen}
    if not (counts == eager_counts and seen == counted == eager_window):
        raise AssertionError(
            f"{tag}: the captured run launched {counts}, the per-step run "
            f"{eager_counts}; over the traced steps the card ran {seen}, "
            f"the counters {counted}, the per-step run's as many steps "
            f"{eager_window}; the traced replays' kernel records "
            f"{len(win['replay_kernels'])} replays, off the most common "
            f"count (position, records) {replay_gaps(win['replay_kernels'])}")
    if yardstick is None:
        with reordered_adam():
            reruns = [driver.main(argv, per_step=True, **kw)
                      for _ in range(YARD_RUNS - 1 if pairwise else 1)]
        yard = ("per-step, Adam capturable", reruns[0])
    else:
        yard = yardstick()
    eager_ms = 1e3 * np.percentile(eager["step_seconds"][1:], 50)
    later = res["chunks"]
    # the epochs MNIST's recorder times: not the first, nor the first after
    # a regime switch (warm-ups and captures)
    per_step = [c["seconds"] / c["steps"] for c in later[1:]
                if c.get("timed", True)] or [
        c["seconds"] / c["steps"] for c in later[1:]] or [
        later[0]["seconds"] / later[0]["steps"]]
    log(f"{tag}: captured, {len(res['metrics'])} steps, graph replays "
        f"{replays}, launches {counts} (per-step run {eager_counts}); the "
        f"traced steps: the card ran {seen}; step "
        f"{1e3 * np.percentile(per_step, 50):.3f} ms (seconds of its "
        f"{'later ' if len(later) > 1 else ''}{unit} / steps) against the "
        f"per-step p50 {eager_ms:.3f} ms; traced replays "
        f"{win['ms_per_step']:.3f} ms a step, idle share "
        f"{win['idle']:.3f}; max_memory_allocated of the captured run "
        f"{peak / 2**20:.1f} MiB; {gpu_name_and_power()}")
    if pairwise:
        ref = run_values(eager, scores, series)
        hold_to_yard(f"{tag} captured", run_values(res, scores, series), ref,
                     [ref] + [run_values(r, scores, series) for r in reruns],
                     ("captured", "per-step", f"per-step and {yard[0]} "
                      f"(x{YARD_RUNS})"), sum_floor)
    else:
        hold_runs(f"{tag} captured", *(run_values(r, scores, series)
                                       for r in (res, eager, yard[1])),
                  ("captured", "per-step", yard[0]), sum_floor)
    if extra_hold is not None:
        extra_hold(tag, res, eager, yard)
    return seen, counts


SPRITES_EVAL_CALLS = ("recon", "encode", "fit", "cgen")


def hold_sprites_pretraining(tag, res, eager, yard) -> None:
    """21(b), beside default_loop's holds: the captured run's pretraining
    replayed its graph and each eval call replayed once; its per-epoch
    pretraining loss and accuracy held to the per-step run's (phase 8's,
    eager) within RECHECK_FACTOR x their gap in the yardstick run, floored:
    the loss at the random-walk round-off of its mean over a pretraining
    batch (5,000 frames), the accuracy at one frame of an epoch."""
    import torch
    pre, calls = res["pretrain"], res["eval_graph_replays"]
    if pre["graph_replays"].get("full", 0) < 1 or \
            calls != dict.fromkeys(SPRITES_EVAL_CALLS, 1):
        raise AssertionError(f"{tag}: pretraining graph replays "
                             f"{pre['graph_replays']}, eval calls' {calls}")

    def values(r):
        return {f"pretrain_{k}": torch.tensor(
            [ep[k] for ep in r["pretrain"]["epochs"]], dtype=torch.float64)
            for k in ("loss", "acc")}

    got, r32, r64 = (values(r) for r in (res, eager, yard[1]))
    scale = float(r64["pretrain_loss"].abs().max())
    hold_to_cpu_gap(
        f"{tag} pretraining", got, r32, [], r64, scale, SPRITES_SUM_FLOOR,
        names=("captured", "per-step", yard[0]), floors={
            "pretrain_loss": math.sqrt(5_000) * 2.0 ** -24 * scale,
            "pretrain_acc": 1.0 / (SPRITES_FPC * DEFAULT_LOOP_CHARS)})
    log(f"{tag} pretraining: {pre['steps']} steps, graph replays "
        f"{pre['graph_replays']} in {pre['seconds']:.3f} s (per-step run "
        f"{eager['pretrain']['seconds']:.3f} s); eval calls' seconds "
        f"{res['evals'][-1]['seconds']} (per-step run "
        f"{eager['evals'][-1]['seconds']}), launches per replay "
        f"{res['eval_graph_launches']}")


def sprites_default_loop(tag, argv, eager, per_step, corpus,
                         base_dir) -> dict:
    """21(b) for one SPRITES run: default_loop against `eager` ((result,
    launches) of its per-step run), each step launching (B1, B2, B3)
    `per_step` times, its pretraining held too, the yardstick pairwise
    (over five runs of this phase on an NVIDIA H100 80GB HBM3 at 700 W,
    one capturable-Adam rerun's test-MSE gap to the per-step run ranged
    1.9e-6 to 7.7e-5, the captured run's 3.2e-6 to 5.9e-5, and the
    smallest draw failed a captured run 2.9e-5 away);
    returns what its trace saw."""
    from svgpvae_tpu_torch.cli import sprites

    def check(res):
        if len(res["metrics"]) != DEFAULT_LOOP_STEPS or any(
                (sl["chol_inverse"], sl["gp_sufficient_stats"],
                 sl["fused_kernel_stats"]) != per_step
                for sl in res["step_launches"]):
            raise AssertionError(f"{tag}: steps launched "
                                 f"{res['step_launches'][:3]}...")

    return default_loop(
        tag, sprites, argv, *eager, DEFAULT_LOOP_TRACES["sprites"],
        {"splits": corpus}, base_dir, check, ("test_mse", "cgen_mse"),
        SPRITES_SUM_FLOOR, extra_hold=hold_sprites_pretraining,
        pairwise=True)[0]


def sprites_eval_trace(corpus) -> dict:
    """21(b): phase 8's run captured for 2 epochs (no pretraining), an eval
    pass after each.  From the end of the first eval (its calls' warm-ups
    and captures behind it) to the run's end, a torch.profiler trace of the
    card (ReplayTrace): epoch 1's step replays and the second eval's four
    call replays.  The B1, B2 and B3 kernels it saw must equal the
    counters' over the window, and epoch 1's steps' plus the eval calls'
    launches (each call's, counted at its capture); B1, B2 and B3 each ran
    in the eval.  Returns what the trace saw in the eval (the kernels
    line's path "sprites_eval_graph")."""
    from svgpvae_tpu_torch.cli import sprites
    argv = SPRITES_ARGV + ["--opt_regime", "joint-2", "--nr_epochs_repr_nn",
                           "0"]
    trace = ReplayTrace()
    res = sprites.main(argv, splits=corpus, on_eval=trace)
    seen, counted = trace.stop()
    steps = {k: sum(sl[k] for sl in res["step_launches"][
        DEFAULT_LOOP_STEPS:]) for k in seen}
    in_eval = {k: sum(st[k] for st in res["evals"][-1]["launches"].values())
               for k in seen}
    per_call = {k: sum(g.get(k, 0)
                       for g in res["eval_graph_launches"].values())
                for k in seen}
    eval_seen = {k: seen[k] - steps[k] for k in seen}
    if (seen != counted or eval_seen != in_eval or in_eval != per_call
            or any(v < 1 for v in in_eval.values())
            or res["eval_graph_replays"] != dict.fromkeys(
                SPRITES_EVAL_CALLS, 2)):
        raise AssertionError(
            f"21(b) sprites eval trace: the card ran {seen}, the counters "
            f"{counted}; epoch 1's steps {steps}, the eval's stages "
            f"{in_eval}, its calls' launches {per_call}, replays "
            f"{res['eval_graph_replays']}")
    ev = res["evals"][-1]
    log(f"21(b) sprites eval calls traced (the second eval and epoch 1): "
        f"the card ran {eval_seen} in the eval (the counters {in_eval}) and "
        f"{steps} in the epoch; seconds {ev['seconds']}; test MSE "
        f"{ev['test_mse']:.6f}, cgen MSE {ev['cgen_mse']:.6f}; "
        f"{gpu_name_and_power()}")
    return eval_seen


def phase_default_loops(mnist_data, phase6, phase11, phase14,
                        base_dir) -> dict:
    """Phase 21; phase6 and phase11 are (result, launches) of those
    phases' per-step runs, phase14 {tag: (result, launches)} of its runs.
    Returns each run's launches as the trace saw them."""
    import torch
    from svgpvae_tpu_torch import data
    from svgpvae_tpu_torch.cli import ball, mnist, sprites

    paths = {}
    t0 = time.perf_counter()

    def mnist_steps(tag, b2):
        def check(res):
            for i, sl in enumerate(res["step_launches"]):
                if sl["chol_inverse"] != 1 or sl["gp_sufficient_stats"] != b2:
                    raise AssertionError(f"{tag} step {i} launched {sl}")
            if len(res["metrics"]) != TRAIN_STEPS:
                raise AssertionError(f"{tag}: {len(res['metrics'])} steps")
        return check

    scores = ("eval_mse", "test_mse", "cgen_mse")
    for tag, argv, (eager, counts), b2 in (
            ("21(a) mnist", TRAIN_ARGV, phase6, 1),
            ("21(a) mnist titsias", TITSIAS_ARGV, phase11, 2)):
        def f64(argv=argv):  # 20(a)'s yardstick: float64 on the same draws
            return ("per-step f64", mnist_f64_run(argv, mnist_data))
        paths[tag] = default_loop(
            tag, mnist, argv, eager, counts, DEFAULT_LOOP_TRACES["mnist"],
            {"splits": mnist_data}, base_dir, mnist_steps(tag, b2), scores,
            SUM_FLOOR, yardstick=f64)[0]
        log(f"[{tag}: {time.perf_counter() - t0:.1f} s]")
        t0 = time.perf_counter()

    # (b) SPRITES fp32 (phase 8's flags, saved into a run dir of its own),
    # --bf16 (phase 17(a)'s) and the Titsias record flags (phase 12's: the
    # `fused` block, B2 twice a step, its Cholesky solves on cusolver under
    # capture), each on the small corpus beside its per-step run there
    t0 = time.perf_counter()
    small = data.generate_synthetic_sprites(
        n_train_chars=DEFAULT_LOOP_CHARS,
        n_test_chars=DEFAULT_LOOP_CHARS // 4, n_frames_train=SPRITES_FPC,
        seed=0)
    sp_argv = SPRITES_ARGV + SAVE_ARGV + ["--base_dir", base_dir]
    runs = [("21(b) sprites", sp_argv, (2, 1, 0)),
            ("21(b) sprites --bf16", SPRITES_ARGV + ["--bf16"], (2, 1, 0)),
            ("21(b) sprites titsias", SPRITES_TITSIAS_ARGV, (0, 2, 0))]
    for tag, argv, per_step in runs:
        eager = launched(sprites.main, argv, splits=small, per_step=True)
        paths[tag] = sprites_default_loop(tag, argv, eager, per_step, small,
                                          base_dir)
        log(f"[{tag}: {time.perf_counter() - t0:.1f} s]")
        t0 = time.perf_counter()
    eval_seen = sprites_eval_trace(small)
    log(f"[21(b) sprites eval trace: {time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()

    # (c) the ball, every --elbo (phase 14's runs)
    for name, (eager, counts) in phase14.items():
        argv, steps, _ = BALL_RUNS[name]
        full = argv + ["--steps", str(steps), "--eval_every", str(steps),
                       "--base_dir", base_dir, "--device", "cuda", "--seed",
                       "0"]
        tag = f"21(c) {name}"

        def check(res, tag=tag, steps=steps,
                  b1=int(BALL_RUNS[name][2] is not None)):
            want = {"chol_inverse": b1, "fused_kernel_stats": 0,
                    "gp_sufficient_stats": 0}
            if len(res["metrics"]) != steps or any(
                    sl != want for sl in res["step_launches"]):
                raise AssertionError(f"{tag}: steps launched "
                                     f"{res['step_launches'][:3]}...")
        paths[tag] = default_loop(
            tag, ball, full, eager, counts, DEFAULT_LOOP_TRACES[name], {},
            base_dir, check, ("mse", "elbo"), BALL_SUM_FLOOR, ("loss",),
            "chunks")[0]
        log(f"[{tag}: {time.perf_counter() - t0:.1f} s]")
        t0 = time.perf_counter()
    capture_failure_raises()
    torch.cuda.empty_cache()
    return {**{f"default_loop:{k.split(' ', 1)[1]}": v
               for k, v in paths.items()}, "sprites_eval_graph": eval_seen}


def capture_failure_raises() -> None:
    """21(d): a capture that a graph cannot hold (a host read of a device
    value inside it) raises from train.capture.Graph, and the card runs
    on after it."""
    import torch
    from svgpvae_tpu_torch.train import capture
    x = torch.ones(8, device="cuda")
    try:
        capture.Graph(lambda: float(x.sum()), torch.cuda.Stream())
    except RuntimeError as e:
        why = str(e).splitlines()[0]
    else:
        raise AssertionError("21(d): a capture with a host sync ran")
    if float((x * 2).sum()) != 16.0:
        raise AssertionError("21(d): the card is off after a failed capture")
    log(f"21(d) a failed capture raised: {why}")


# --- phase 22 ---------------------------------------------------------------
# The MNIST driver's last loops replayed from captured CUDA graphs: phase
# 15's VAE, CVAE and Casale runs and its --opt_regime VAE-1 joint-1 run,
# without a capture_step, and Casale at --casale_taylor_every 2 (its
# held sample's refresh a graph of its own), each held to its per-step run
# as phase 21 holds a run (default_loop: every step's launches, the run's
# launches the per-step run's, a traced run whose kernels equal the
# counters').  The yardstick is the per-step run with a capturable Adam
# (phase 21's for SPRITES and the ball), not 21(a)'s float64 run: the
# VAE's loss, ~4e8 at the start (its pixel sum over 2 sigma^2 = 2e-4),
# came 800-816 (16 ulps) from the per-step run's in the captured run and
# 816 in the capturable-Adam per-step run, where the float64 run on the
# same draws sat 33 from it (NVIDIA H100 80GB HBM3, 700.00 W).  The
# per-step loss, final parameters and eval scores are held.  Each trace
# is the run's first
# timed epoch (--profile_dir): epoch 1 of VAE and CVAE, the VAE-phase run
# at VAE-2 joint-2 its second VAE epoch (no kernel; the per-step run's VAE
# epoch beside it), Casale's epoch 3 (joint after joint); the windows
# leave out each epoch's last replay, its tail's first.  tag -> (extra
# argv, traced steps, the per-step run's steps of the same count, window
# of graph replays (and, for the cadenced run, the training steps among
# them), the scores).
CASALE_K2 = "casale_taylor2_train"
CAPTURED_REST_RUNS = {
    "mnist_vae_train": ([], slice(32, 64), slice(32, 64), (0, 31),
                        ("eval_mse", "test_mse")),
    "mnist_cvae_train": ([], slice(32, 64), slice(32, 64), (0, 31),
                         ("eval_mse", "test_mse", "cgen_mse")),
    "mnist_vae_phase_train": (["--opt_regime", "VAE-2", "joint-2"],
                              slice(32, 64), slice(0, 32), (0, 31),
                              ("eval_mse", "test_mse", "cgen_mse")),
    "casale_train": ([], slice(96, 128), slice(96, 128), (0, 31),
                     ("cgen_mse",)),
    # 16 refreshes ahead of the epoch's even steps, 31 full steps, the tail
    CASALE_K2: ([], slice(96, 128), slice(96, 128), (0, 47, 31),
                ("cgen_mse",))}
CASALE_SUM_FLOOR = math.sqrt(8_100 * 28 * 28) * 2.0 ** -24
# Casale's runs do not repeat on the card (phase 15): over 160 steps its
# parameters drift 2e-2 apart between two per-step runs, and its cgen MSE
# moved 1.6e-4 in one yardstick draw and 2.7e-3 in another (of ~0.067;
# the captured runs' 2.4e-3 and 1.6e-4 from the per-step run's, on an
# NVIDIA H100 80GB HBM3 at 700.00 W).  One draw is no measure of that
# spread, so its yardstick is pairwise (default_loop's `pairwise`).


def captured_rest_argv(tag) -> list:
    if tag == "mnist_vae_phase_train":
        return VAE_PHASE_ARGV
    if tag == CASALE_K2:
        return _baseline_argv("casale_train") + ["--casale_taylor_every",
                                                  "2"]
    return _baseline_argv(tag)


def phase_captured_rest(mnist_data, phase15, base_dir) -> dict:
    """Phase 22; phase15 {tag: (result, launches)} of phase 15's per-step
    runs.  Returns each run's launches as its trace saw them, and the
    VAE-phase run's by the counters (the path "vae_phase_graph")."""
    import torch
    from svgpvae_tpu_torch.cli import mnist

    paths = {}
    runs = dict(phase15)
    runs[CASALE_K2] = launched(mnist.main, captured_rest_argv(CASALE_K2),
                               splits=mnist_data, per_step=True)
    for tag, (eager, eager_counts) in runs.items():
        extra, steps, eager_steps, window, scores = CAPTURED_REST_RUNS[tag]
        argv = captured_rest_argv(tag)
        n_steps = len(eager["metrics"])

        def check(res, tag=tag, n_steps=n_steps):
            half = n_steps // 2
            for i, sl in enumerate(res["step_launches"]):
                joint = tag == "mnist_vae_phase_train" and i >= half
                if (sl["chol_inverse"], sl["gp_sufficient_stats"],
                        sl["fused_kernel_stats"]) != ((1, 1, 0) if joint
                                                      else (0, 0, 0)):
                    raise AssertionError(f"22 {tag} step {i} launched {sl}")
            if len(res["metrics"]) != n_steps:
                raise AssertionError(f"22 {tag}: {len(res['metrics'])} "
                                     "steps")

        casale = tag.startswith("casale")
        seen, counts = default_loop(
            f"22 {tag}", mnist, argv, eager, eager_counts,
            (extra, steps, eager_steps, window), {"splits": mnist_data},
            base_dir, check, scores,
            CASALE_SUM_FLOOR if casale else SUM_FLOOR, ("loss",),
            pairwise=casale)
        paths[f"captured:{tag}"] = seen
        if tag == "mnist_vae_phase_train":
            paths["vae_phase_graph"] = counts
    torch.cuda.empty_cache()
    return paths


# --- phase 23 ---------------------------------------------------------------
# --data_parallel over NCCL, one rank a card (2 cards or more; on one card
# the phase prints that it did not run).  (a) Each run per step (the
# drivers' per-step loops, main(per_step=True)) over 2 and 4 cards, held to
# the 1-process run on the same data and draws within RECHECK_FACTOR x the
# largest gap among YARD_RUNS 1-process runs (hold_to_yard), every rank's
# launches equal and each step's as in the 1-process run; (b) the same run
# on its default loop, which replays CUDA graphs with the all-reduces
# inside, held to its per-step data-parallel run against the same
# yardstick, its launches those of the per-step run; (c) the serve with
# its fit sharded.  The runs: the north-star MNIST run (phase 6's flags)
# over 6 epochs (2 and 4 cards), and over 2 cards with --epoch_chunk 3
# --eval_bundle; phase 11's Titsias run and phase 15's deep SVIGP run (2
# cards; deep SVIGP's yardstick adds its run on nudged pixels, 20(c)'s,
# since its runs draw nothing); phase 8's SPRITES run over 4 epochs (2 and
# 4 cards) on phase 4's corpus, which every rank reads from shards on
# disk; phase 15's MNIST VAE run over 6 epochs (2 and 4 cards); the serve
# of phase 4 with random weights (2 and 4 cards), whose yardstick adds the
# 1-process fit on its rows reversed.  The VAE's yardstick adds a per-step
# run with a capturable Adam, as phase 22's does: its 1-process per-step
# runs repeat within an ulp of its ~4e8 loss, where the capture's Adam
# arithmetic moves it by ~16 ulps (816 in a four-card call of this phase
# on NVIDIA H100 80GB HBM3 at 700 W).  MNIST's, the VAE's and SPRITES's
# 1-process, per-step and captured runs trace their epoch 1
# (--profile_dir, rank 0): the kernels the card ran in it equal the
# counters' over its steps, and its NCCL all-reduce kernels (inside the
# replays, for a captured run) equal the all-reduces of the captured
# run's graphs over those steps; their step p50/p90 come from the
# untraced epochs (a captured run's: epoch seconds / steps, its first
# epoch left out).
NCCL_MNIST_ARGV = [{"joint-2": "joint-6", "2": "6"}.get(a, a)
                   for a in TRAIN_ARGV]
NCCL_SPRITES_ARGV = [{"joint-1": "joint-4", "1": "4"}.get(a, a)
                     for a in SPRITES_ARGV]
# phase 15's MNIST VAE run over 6 epochs (its eval every 2)
NCCL_VAE_ARGV = [x for i, x in enumerate(_baseline_argv("mnist_vae_train"))
                 if x != "--nr_epochs" and _baseline_argv(
                     "mnist_vae_train")[i - 1] != "--nr_epochs"] + [
    "--nr_epochs", "6"]
# tag -> (driver, argv, cards, each step's (B1, B2, B3), the scores held,
# the per-step series held, the traced epoch's steps and the window of
# its graph replays in a captured run (MNIST's before its tail, whose
# graph is captured there), or None: untraced)
NCCL_RUNS = {
    "mnist": ("mnist", NCCL_MNIST_ARGV, (2, 4), (1, 1, 0),
              ("eval_mse", "test_mse", "cgen_mse"),
              ("loss", "C_ma", "lagrange"), (slice(32, 64), (0, 31))),
    "mnist_titsias": ("mnist", TITSIAS_ARGV, (2,), (1, 2, 0),
                      ("eval_mse", "test_mse", "cgen_mse"),
                      ("loss", "C_ma", "lagrange"), None),
    "svigp": ("mnist", _baseline_argv("svigp_train"), (2,), (0, 0, 0),
              ("cgen_mse",), ("loss",), None),
    "sprites": ("sprites", NCCL_SPRITES_ARGV, (2, 4), (2, 1, 0),
                ("test_mse", "cgen_mse"), ("loss", "C_ma", "lagrange"),
                (slice(SPRITES_STEPS, 2 * SPRITES_STEPS),
                 (0, SPRITES_STEPS))),
    "vae": ("mnist", NCCL_VAE_ARGV, (2, 4), (0, 0, 0),
            ("eval_mse", "test_mse"), ("loss",), (slice(32, 64), (0, 31)))}
NCCL_CHUNK_ARGV = ["--epoch_chunk", "3", "--eval_bundle"]
SERVE_SUM_FLOOR = math.sqrt(50 * SERVE_CHARS) * 2.0 ** -24


def nccl_timing(res, epoch_steps, traced) -> dict:
    """Step p50/p90 (ms) of a run's untraced epochs: a per-step run's step
    seconds but its first step's, a captured run's epoch seconds / steps
    but its first epoch's (warm-ups and captures)."""
    if res["chunks"]:
        per = [c["seconds"] / c["steps"] for i, c in enumerate(res["chunks"])
               if i > 0 and not (traced and i == 1)]
    else:
        per = [t for i, t in enumerate(res["step_seconds"])
               if i > 0 and not (traced and i // epoch_steps == 1)]
    return {"step_p50_ms": 1e3 * float(np.percentile(per, 50)),
            "step_p90_ms": 1e3 * float(np.percentile(per, 90))}


def nccl_run(tag, ranks, captured, extra=(), trace=None, **kw) -> tuple:
    """One run of NCCL_RUNS[tag] + `extra` argv on `ranks` cards (1: no
    group), per step or captured, with `trace` (its traced steps and the
    captured window) its epoch 1 traced: (result, {timing, trace,
    launches})."""
    import importlib
    from svgpvae_tpu_torch import ops
    name, argv, *_ = NCCL_RUNS[tag]
    driver = importlib.import_module(f"svgpvae_tpu_torch.cli.{name}")
    argv = argv + list(extra) + (["--data_parallel", str(ranks)]
                                 if ranks > 1 else [])
    epochs = (int(argv[argv.index("--opt_regime") + 1].rsplit("-")[1])
              if "--opt_regime" in argv
              else int(argv[argv.index("--nr_epochs") + 1]))
    trace_dir = tempfile.mkdtemp(prefix="trace_") if trace else None
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = driver.main(argv + (["--profile_dir", trace_dir] if trace else []),
                      per_step=not captured, **kw)
    seconds = time.perf_counter() - t0
    epoch_steps = len(res["metrics"]) // epochs
    rec = {"tag": tag, "cards": ranks, "loop": "captured" if captured
           else "per step",
           "flags": " ".join(NCCL_CHUNK_ARGV) if set(NCCL_CHUNK_ARGV) <= set(
               extra) else "",
           "steps": len(res["metrics"]),
           "seconds": seconds, **nccl_timing(res, epoch_steps, bool(trace)),
           "launches": ops.launch_counts(),
           "rank_launches": res.get("rank_launches")}
    if trace:
        steps, window = trace
        (path,) = glob.glob(os.path.join(trace_dir, "*.json"))
        seen, win = read_trace(path, window if captured else None)
        shutil.rmtree(trace_dir)
        n = steps.stop - steps.start
        n_window = window[1] - window[0] if captured else n
        rec.update(seen=seen, counted={
            k: sum(sl[k] for sl in res["step_launches"][steps])
            for k in seen}, traced_steps=n,
            trace_ms_per_step=win["ms"] / n_window, idle=win["idle"],
            nccl=win["nccl"], nccl_in_replays=win["nccl_in_replays"],
            nccl_per_step=win["nccl"] / n,
            nccl_ms_per_step=win["nccl_ms"] / n, replays=win["replays"])
    log(f"23 {tag} on {ranks} card(s), {rec['loop']}: " + json.dumps(
        {k: v for k, v in rec.items() if k not in ("tag", "cards", "loop")}))
    return res, rec


def nccl_check_launches(tag, res, rec, per_step, ranks) -> None:
    """Each step's launches on rank 0 are `per_step` (B1, B2, B3); every
    rank launched alike, at least `per_step` x steps, and B3 once an eval
    fit (SPRITES) or never (MNIST)."""
    keys = ("chol_inverse", "gp_sufficient_stats", "fused_kernel_stats")
    steps = len(res["metrics"])
    check_step_launches(f"23 {tag}", res, steps,
                        lambda sl: tuple(sl[k] for k in keys) == per_step)
    b3 = len(res["evals"]) if per_step[0] == 2 else 0

    def want(c):
        return (c["chol_inverse"] >= per_step[0] * steps
                and c["gp_sufficient_stats"] >= per_step[1] * steps
                and c["fused_kernel_stats"] == b3)
    if ranks > 1:
        check_rank_launches(f"23 {tag} on {ranks} cards", res, ranks, want)
    elif not want(rec["launches"]):
        raise AssertionError(f"23 {tag}: launched {rec['launches']}")


def nccl_check_trace(tag, rec, graphs) -> None:
    """A traced run's epoch 1: the card's B1/B2/B3 kernels equal the
    counters' (B1 at least once a step where a step launches it), and its
    NCCL all-reduce kernels (all inside the replays for a captured run)
    those of the captured run's graphs over its steps (`graphs`: its
    graph_all_reduces; every traced step a full step but an MNIST
    epoch's last, its tail)."""
    n = rec["traced_steps"]
    driver, _, _, per_step, *_ = NCCL_RUNS[tag]
    tail = graphs.get("tail", 0) if driver == "mnist" else graphs["full"]
    want = (n - 1) * graphs["full"] + tail
    replayed = rec["nccl_in_replays"] if rec["loop"] == "captured" \
        else rec["nccl"]
    if rec["seen"] != rec["counted"] or rec["nccl"] != want \
            or replayed != want or \
            rec["seen"]["chol_inverse"] < per_step[0] * n:
        raise AssertionError(
            f"23 {tag} on {rec['cards']} card(s), {rec['loop']}: the trace "
            f"saw {rec['seen']} and {rec['nccl']} NCCL all-reduces "
            f"({rec['nccl_in_replays']} in replays); the counters "
            f"{rec['counted']}, the graphs' all-reduces {want} ({graphs})")


def nccl_floors(tag, yard) -> dict:
    """Phase 23's floors beyond hold_runs' (`yard`: run_values of a
    1-process run): GECO's lagrange multiplier is the running product of
    one exp(C_ma) a step, so its round-off walks sqrt(steps) fp32 ulps of
    its size, where the default floor is one ulp (a four-card run of the
    phase held the lagrange of MNIST over 4 cards 0.195 from the 1-process
    run's, 25 ulps at its cap of 1e5 after 192 steps, against a 3-rerun gap
    of 1 ulp and a floored limit of 0.119); deep SVIGP's loss is a sum of
    a batch's squared errors, floored as 20(c) floors it."""
    floors = {}
    if "lagrange_mult" in yard:
        floors["lagrange_mult"] = (math.sqrt(len(yard["lagrange_mult"]))
                                   * FP32_ULP
                                   * float(yard["lagrange_mult"].abs().max()))
    if tag == "svigp":
        floors["loss"] = SUM_FLOOR * float(yard["loss"].abs().max())
    return floors


def nccl_cards(cards) -> tuple:
    """The card counts of `cards` that the machine has."""
    import torch
    return tuple(c for c in cards if c <= torch.cuda.device_count())


def nccl_config(tag, kw, extra=()) -> tuple:
    """Phase 23(a, b) for one entry of NCCL_RUNS (`extra` argv added to
    every run); returns ({path: launches summed over the ranks}, [run
    records])."""
    import torch
    _, _, cards, per_step, scores, series, trace = NCCL_RUNS[tag]

    def values(res):
        return run_values(res, scores, series)

    yard_res = [nccl_run(tag, 1, False, extra,
                         trace=trace if i == 0 else None, **kw)
                for i in range(YARD_RUNS)]
    records = [r for _, r in yard_res[:1]]
    for res, rec in yard_res[:1]:
        nccl_check_launches(tag, res, rec, per_step, 1)
    yard = [values(r) for r, _ in yard_res]
    if tag == "svigp":  # its runs draw nothing: 20(c)'s nudged pixels too
        yard.append(values(nccl_run(tag, 1, False, extra,
                                    splits=nudged_images(kw["splits"]))[0]))
    if tag == "vae":  # the Adam arithmetic of a capture: phase 22's rule
        with reordered_adam():
            yard.append(values(nccl_run(tag, 1, False, extra, **kw)[0]))
    ref = yard[0]
    floors = nccl_floors(tag, yard[1])
    del yard_res
    paths, graphs, pending = {}, None, []
    if trace:
        one, rec = nccl_run(tag, 1, True, extra, trace=trace, **kw)
        nccl_check_launches(tag, one, rec, per_step, 1)
        hold_to_yard(f"23 {tag} on 1 card captured", values(one), ref, yard,
                     ("captured", "1 process", f"reruns (x{len(yard)})"),
                     SUM_FLOOR, floors)
        records.append(rec)
        pending += [records[0], rec]
        del one
    per_step_runs = {}  # (a) before (b): a failed capture leaves them run
    for ranks in nccl_cards(cards):
        dp, rec = nccl_run(tag, ranks, False, extra, trace=trace, **kw)
        nccl_check_launches(tag, dp, rec, per_step, ranks)
        per_step_runs[ranks] = (values(dp), dp["rank_launches"])
        hold_to_yard(f"23 {tag} on {ranks} cards per step", values(dp), ref,
                     yard, (f"{ranks} cards", "1 process",
                            f"1-process reruns (x{len(yard)})"),
                     SUM_FLOOR, floors)
        records.append(rec)
        pending += [rec] if trace else []
        paths[f"nccl:{tag}:{ranks}:per_step"] = {
            k: sum(c[k] for c in dp["rank_launches"]) for k in KERNELS}
        del dp
    for ranks, (dp, dp_launches) in per_step_runs.items():
        cap, rec = nccl_run(tag, ranks, True, extra, trace=trace, **kw)
        nccl_check_launches(tag, cap, rec, per_step, ranks)
        if not cap["graph_replays"] or cap["rank_launches"] != dp_launches:
            raise AssertionError(
                f"23 {tag} on {ranks} cards captured: graph replays "
                f"{cap['graph_replays']}, rank launches "
                f"{cap['rank_launches']} (per step {dp_launches})")
        hold_to_yard(f"23 {tag} on {ranks} cards captured", values(cap), dp,
                     yard, ("captured", f"{ranks} cards per step",
                            f"1-process reruns (x{len(yard)})"),
                     SUM_FLOOR, floors)
        graphs = cap["graph_all_reduces"]
        log(f"23 {tag} on {ranks} cards: graph replays "
            f"{cap['graph_replays']}, all-reduces per replay {graphs}")
        records.append(rec)
        pending += [rec] if trace else []
        paths[f"nccl:{tag}:{ranks}:captured"] = {
            k: sum(c[k] for c in cap["rank_launches"]) for k in KERNELS}
        del cap
        if tag == "mnist" and ranks == 2:
            chunked, chrec = nccl_run(tag, ranks, True,
                                      list(extra) + NCCL_CHUNK_ARGV, **kw)
            nccl_check_launches(tag, chunked, chrec, per_step, ranks)
            if chunked["graph_replays"].get("eval", 0) < 1:
                raise AssertionError(f"23 mnist --epoch_chunk: graph "
                                     f"replays {chunked['graph_replays']}")
            hold_to_yard("23 mnist on 2 cards --epoch_chunk 3 --eval_bundle",
                         values(chunked), dp, yard,
                         ("chunked", "2 cards per step",
                          f"1-process reruns (x{len(yard)})"), SUM_FLOOR,
                         floors)
            records.append(chrec)
            paths["nccl:mnist_chunk:2:captured"] = {
                k: sum(c[k] for c in chunked["rank_launches"])
                for k in KERNELS}
            del chunked
        torch.cuda.empty_cache()
    for rec in pending:
        nccl_check_trace(tag, rec, graphs if rec["cards"] > 1
                         else dict.fromkeys(graphs, 0))
    return paths, records


def nccl_serve(corpus, base_dir) -> tuple:
    """Phase 23(c): the serve (phase 4's corpus, random weights) with its
    fit sharded over 2 and 4 cards, every rank generating the corpus
    itself; p_m and p_v of its request held to the 1-process serve's within
    RECHECK_FACTOR x the largest gap of a 1-process rerun and the
    1-process fit on the rows reversed, floored at the random-walk
    round-off of the fit's sums over N rows."""
    import torch
    from svgpvae_tpu_torch import gp as gpm, ops, serving
    from svgpvae_tpu_torch.cli import serve
    argv = ["--synthetic", "--synthetic_chars", str(SERVE_CHARS),
            "--n_requests", "1", "--device", "cuda", "--seed", "0", "--out",
            os.path.join(base_dir, "nccl_serve.npz")]

    def values(req):
        return {k: req[k].detach().double().cpu() for k in ("p_m", "p_v")}

    ones = [serve.main(argv, splits=corpus) for _ in range(YARD_RUNS - 1)]
    st = ones[0]["state"]
    req = st["served"][0]
    pred = st["predictor"]
    flip = serving.fit(pred.gp_params, *(st[k].flip(0) for k in (
        "means", "variances", "aux")))
    with torch.no_grad():
        p_m, p_v = gpm.posterior_from_precomputed(
            pred.gp_params, req["aux_query"], flip.mean_terms,
            flip.sigma_inv, flip.kmm_inv)
    yard = [values(o["state"]["served"][0]) for o in ones] + [
        {"p_m": p_m.double().cpu(),
         "p_v": torch.clamp(p_v, *serving.PVAR_CLIP).double().cpu()}]
    want = {"chol_inverse": 0, "fused_kernel_stats": 1,
            "gp_sufficient_stats": 0}
    paths, records = {}, []
    for ranks in nccl_cards((2, 4)):
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        res = serve.main(argv + ["--data_parallel", str(ranks)])
        hold_to_yard(f"23 serve on {ranks} cards", values(
            res["state"]["served"][0]), yard[0], yard,
            (f"fit on {ranks} cards", "1 process",
             "1-process reruns and reversed rows"), SERVE_SUM_FLOOR)
        launches = check_rank_launches(f"23 serve on {ranks} cards", res,
                                       ranks, lambda c: c == want)
        if res["fit_launches"] != want:
            raise AssertionError(f"23 serve on {ranks} cards: the fit "
                                 f"launched {res['fit_launches']}")
        rec = {"tag": "serve", "cards": ranks, "seconds":
               time.perf_counter() - t0, "fit_s": res["seconds"]["fit"],
               "fit_s_1_process": ones[0]["seconds"]["fit"],
               "rank_launches": res["rank_launches"]}
        log(f"23 serve on {ranks} cards: " + json.dumps(rec))
        records.append(rec)
        paths[f"nccl:serve:{ranks}"] = launches
    return paths, records


def phase_nccl(mnist_data, corpus, base_dir, records=None,
               parts=None) -> dict:
    """Phase 23 on the visible cards (2 or more; the 4-card runs need 4):
    NCCL_RUNS and the serve (or those of them named in `parts`); returns
    {path: launches summed over the ranks}, and appends every run's record
    to `records` when given.  Every part runs, and the phase then fails if
    any part did."""
    import traceback
    import torch
    from svgpvae_tpu_torch import data
    from svgpvae_tpu_torch.parallel import mesh
    sprites_dir = tempfile.mkdtemp(prefix="sprites_", dir=base_dir)
    if parts is None or "sprites" in parts:
        data.save_sprites_shards(corpus, sprites_dir)
    # the SPRITES ranks read phase 4's corpus from disk, each its own copy
    kws = {"sprites": ({}, ["--sprites_data_path", sprites_dir]),
           "mnist": ({"splits": mnist_data}, [])}
    paths, failed = {}, []
    records = [] if records is None else records
    todo = [(tag, nccl_config, (tag, *kws[NCCL_RUNS[tag][0]]))
            for tag in NCCL_RUNS] + [("serve", nccl_serve,
                                      (corpus, base_dir))]
    with ranks_share_card(1):
        for tag, fn, args in todo:
            if parts is not None and tag not in parts:
                continue
            t0 = time.perf_counter()
            try:
                p, r = fn(*args)
            except Exception:  # every part runs; the phase fails below
                log(f"23 {tag} FAILED:\n{traceback.format_exc()}")
                failed.append(tag)
                continue
            finally:
                log(f"[23 {tag}: {time.perf_counter() - t0:.1f} s]")
                torch.cuda.empty_cache()
            paths.update(p)
            records += r
    shutil.rmtree(sprites_dir, ignore_errors=True)
    if failed:
        raise AssertionError(f"phase 23 failed in {failed}")
    return paths


# --- phase 24 ---------------------------------------------------------------
# The JAX package's last one-program calls replayed from captured CUDA
# graphs, each held to its eager form on the same state: (a) phase 6's run
# with --eval_every 1 (two evals; the unbundled passes: eval and test
# recon, the encode -> cgen, one graph each), main(eager_evals=True): each
# captured pass beside its eager twin at the same state; then the same run
# traced by torch.profiler from its first eval to its end (ReplayTrace):
# the B1/B2 kernels the card ran in the second eval's replays equal the
# counters' and the eval graphs' launches; (b) Casale (phase 15's flags,
# --opt_regime VAE-1 GP-1 joint-8: cgens after epochs 5 and 10) with its
# eager twins; (c) phase 4's corpus serve (8 requests) and (d) phase 13's
# MNIST --run_dir serve (8 requests of its 64 demo queries), each eager
# (main(eager=True)), captured, and eager again: the encode chunks' and
# requests' graphs replayed, the encodings and each request's images,
# p_m and p_v held, the captured serve traced by torch.profiler (no
# host-to-device copy runs inside a graph replay), the request p50
# captured beside eager.  The limit of every hold is RECHECK_FACTOR x the
# larger of a measured gap and a floor: for the eval passes and the cgen
# the gap between the eager pass and the same eager pass on the cusolver
# backend (capture.cusolver_linalg: the one arithmetic a graph changes;
# MAGMA's and cusolver's Cholesky solves agree to round-off, not bit for
# bit), for the serve (no solve inside its graphs) the gap between the two
# eager serves; the floor the fp32 round-off of the value's longest sum,
# sqrt(terms) x 2^-24 of its scale (SUM_FLOOR for an MNIST batch,
# CASALE_SUM_FLOOR for Casale's full-train sums, SPRITES_SUM_FLOOR).
CAPTURED_EVAL_ARGV = [x for i, x in enumerate(TRAIN_ARGV)
                      if TRAIN_ARGV[i - 1] != "--eval_every"
                      and x != "--eval_every"] + ["--eval_every", "1"]
CASALE_EVAL_ARGV = [{"joint-3": "joint-8"}.get(a, a)
                    for a in _baseline_argv("casale_train")]
EVAL_PASSES = ("eval", "test", "cgen")


def hold_twin(tag, got, eager, yard, floor) -> float:
    """|got - eager| (max over entries) within RECHECK_FACTOR x the larger
    of |yard - eager| and `floor`; returns err / limit."""
    import torch
    got, eager, yard = (torch.as_tensor(x).double().cpu()
                        for x in (got, eager, yard))
    err = float((got - eager).abs().max())
    gap = float((yard - eager).abs().max())
    limit = RECHECK_FACTOR * max(gap, floor)
    log(f"{tag}: captured vs eager {err:.3e}, yardstick gap {gap:.3e}, "
        f"floor {floor:.3e}, limit {limit:.3e}")
    if not err <= limit:
        raise AssertionError(f"{tag}: the graph's result is {err:.3e} from "
                             f"the eager pass's (limit {limit:.3e})")
    return err / limit


def captured_mnist_evals(mnist_data) -> dict:
    """24(a); returns the B1/B2 launches the trace saw in the second
    eval's graphs (the kernels line's path "captured_eval")."""
    import torch
    from svgpvae_tpu_torch import ops
    from svgpvae_tpu_torch.cli import mnist
    ops.reset_launch_counts()
    res = mnist.main(CAPTURED_EVAL_ARGV, splits=mnist_data, eager_evals=True)
    want = dict.fromkeys(EVAL_PASSES, 2)
    if res["eval_graph_replays"] != want or len(res["evals"]) != 2:
        raise AssertionError(f"24(a): eval graph replays "
                             f"{res['eval_graph_replays']}")
    worst = 0.0
    for i, (ev, losses) in enumerate(zip(res["evals"], res["eval_losses"])):
        for name in EVAL_PASSES:
            twin = ev["eager"][name]
            scale = max(abs(x) for x in twin["losses"])
            worst = max(worst, hold_twin(
                f"24(a) eval {i} {name}: per-batch losses", losses[name],
                twin["losses"], twin["cusolver"]["losses"],
                SUM_FLOOR * scale))
            worst = max(worst, hold_twin(
                f"24(a) eval {i} {name}: sum", sum(losses[name]),
                twin["sum"], twin["cusolver"]["sum"],
                SUM_FLOOR * scale * math.sqrt(len(losses[name]))))
    twin = res["evals"][-1]["eager"]["cgen"]
    worst = max(worst, hold_twin(
        "24(a) cgen images", res["cgen_images"], twin["images"],
        twin["cusolver"]["images"],
        SUM_FLOOR * float(twin["images"].abs().max())))
    sec = [ev["seconds"] for ev in res["evals"]]
    eager_sec = [{"eval_test": ev["eager"]["eval"]["seconds"]
                  + ev["eager"]["test"]["seconds"],
                  "cgen": ev["eager"]["cgen"]["seconds"]}
                 for ev in res["evals"]]
    log(f"24(a) mnist eval passes: captured seconds {sec}, eager "
        f"{eager_sec} (the first captured eval holds the warm-ups and "
        f"captures); launches per replay {res['eval_graph_launches']}; "
        f"worst err/limit {worst:.3f}; {gpu_name_and_power()}")

    trace = ReplayTrace()
    res = mnist.main(CAPTURED_EVAL_ARGV, splits=mnist_data, on_eval=trace)
    seen, counted = trace.stop()
    steps = {k: sum(sl[k] for sl in res["step_launches"][
        MNIST_EPOCH_STEPS:]) for k in seen}
    per_replay = {k: sum(g.get(k, 0)
                         for g in res["eval_graph_launches"].values())
                  for k in seen}
    in_eval = {k: seen[k] - steps[k] for k in seen}
    if (seen != counted or in_eval != per_replay
            or in_eval["chol_inverse"] < 1
            or in_eval["gp_sufficient_stats"] < 1):
        raise AssertionError(
            f"24(a) traced: the card ran {seen}, the counters {counted}; "
            f"epoch 1's steps {steps}, the eval graphs' launches a replay "
            f"{per_replay}")
    log(f"24(a) traced second eval and epoch 1: the card ran {in_eval} in "
        f"the eval graphs (their launches {per_replay}) and {steps} in the "
        f"epoch; eval seconds {res['evals'][-1]['seconds']}")
    torch.cuda.empty_cache()
    return in_eval


def captured_casale_cgen(mnist_data) -> None:
    """24(b): Casale's cgen graph beside its eager twins."""
    from svgpvae_tpu_torch.cli import mnist
    res = mnist.main(CASALE_EVAL_ARGV, splits=mnist_data, eager_evals=True)
    if res["eval_graph_replays"] != {"cgen": 2} or len(res["evals"]) != 2:
        raise AssertionError(f"24(b): cgen graph replays "
                             f"{res['eval_graph_replays']}")
    worst = 0.0
    for ev in res["evals"]:
        twin = ev["eager"]["cgen"]
        worst = max(worst, hold_twin(
            f"24(b) casale cgen after epoch {ev['epoch']}", ev["cgen_mse"],
            twin["loss"], twin["cusolver"]["loss"],
            CASALE_SUM_FLOOR * abs(twin["loss"])))
    log(f"24(b) casale cgen: captured seconds "
        f"{[ev['seconds']['cgen'] for ev in res['evals']]}, eager "
        f"{[ev['eager']['cgen']['seconds'] for ev in res['evals']]} (the "
        f"first captured cgen holds its warm-up and capture); worst "
        f"err/limit {worst:.3f}; {gpu_name_and_power()}")


def graph_copies(path) -> tuple:
    """A Chrome trace of the card: (host-to-device copies inside graph
    replays, host-to-device copies elsewhere, graph replays)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    replays = {e.get("args", {}).get("correlation") for e in events
               if e.get("cat") == "cuda_runtime"
               and e.get("name", "").startswith("cudaGraphLaunch")}
    htod = [e.get("args", {}).get("correlation") for e in events
            if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    inside = sum(c in replays for c in htod)
    return inside, len(htod) - inside, len(replays)


def captured_serve(tag, argv, splits, floor, base_dir) -> dict:
    """24(c)/(d): the serve `argv` eager, captured, eager again and
    captured under torch.profiler; returns the captured serve's launches
    by the counters."""
    import torch
    from svgpvae_tpu_torch import ops
    from svgpvae_tpu_torch.cli import serve
    runs, counts = {}, None
    for name, eager in (("eager", True), ("captured", False),
                        ("eager again", True)):
        ops.reset_launch_counts()
        runs[name] = serve.main(argv, splits=splits, eager=eager)
        if name == "captured":
            counts = ops.launch_counts()
    cap, ref, yard = runs["captured"], runs["eager"], runs["eager again"]
    n = len(cap["state"]["served"])
    replays = cap["graph_replays"]
    requests = [v for k, v in replays.items() if k.startswith("request")]
    if (ref["graph_replays"] or not any(k.startswith("encode")
                                        for k in replays)
            or requests != [n]
            or cap["fit_launches"]["fused_kernel_stats"] != 1):
        raise AssertionError(f"{tag}: graph replays {replays}, eager "
                             f"{ref['graph_replays']}, fit launches "
                             f"{cap['fit_launches']}")
    worst = 0.0
    st = [r["state"] for r in (cap, ref, yard)]
    for k in ("means", "variances", "aux"):
        worst = max(worst, hold_twin(
            f"{tag} encode {k}", *(s[k] for s in st),
            floor * float(st[1][k].abs().max())))
    for i in range(n):
        for k in ("images", "p_m", "p_v"):
            worst = max(worst, hold_twin(
                f"{tag} request {i} {k}", *(s["served"][i][k] for s in st),
                floor * float(st[1]["served"][i][k].abs().max())))
    trace_dir = tempfile.mkdtemp(prefix="serve_trace_", dir=base_dir)
    path = os.path.join(trace_dir, "serve.json")
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        serve.main(argv, splits=splits)
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    inside, outside, graph_launches = graph_copies(path)
    shutil.rmtree(trace_dir)
    if inside or not outside or not graph_launches:
        raise AssertionError(f"{tag}: {inside} host-to-device copies inside "
                             f"the {graph_launches} traced graph replays, "
                             f"{outside} outside")
    sec = {k: [r["seconds"][x] for x in ("encode", "fit")]
           for k, r in runs.items()}
    p50 = {k: 1e3 * float(np.median(r["seconds"]["requests"][1:]))
           for k, r in runs.items()}
    p99 = {k: 1e3 * float(np.percentile(r["seconds"]["requests"][1:], 99))
           for k, r in runs.items()}
    log(f"{tag}: graph replays {replays}; request p50 captured "
        f"{p50['captured']:.3f} ms against eager {p50['eager']:.3f} and "
        f"{p50['eager again']:.3f} ms (p99 {p99}; requests after the "
        f"first, which captures); encode and fit seconds {sec}; "
        f"host-to-device copies: {inside} in the {graph_launches} traced "
        f"replays, {outside} outside; worst err/limit {worst:.3f}; "
        f"{gpu_name_and_power()}")
    torch.cuda.empty_cache()
    return counts


def phase_captured_eval(mnist_data, corpus, mnist_run, base_dir) -> dict:
    """Phase 24; mnist_run is phase 13(a)'s run dir.  Returns the launches
    of its paths: the eval graphs' as the trace saw them, the serves' by
    the counters (their fits' B3)."""
    paths = {"captured_eval": captured_mnist_evals(mnist_data)}
    captured_casale_cgen(mnist_data)
    paths["serve_graph"] = captured_serve(
        "24(c) corpus serve", ["--synthetic", "--synthetic_chars",
                               str(SERVE_CHARS), "--n_requests",
                               str(SERVE_REQUESTS), "--device", "cuda",
                               "--seed", "0"], corpus, SPRITES_SUM_FLOOR,
        base_dir)
    paths["mnist_serve_graph"] = captured_serve(
        "24(d) mnist --run_dir serve", [
            "--run_dir", mnist_run, "--device", "cuda", "--n_requests",
            str(SERVE_REQUESTS), "--out", os.path.join(base_dir,
                                                       "mnist_graph.npz")],
        mnist_data, SUM_FLOOR, base_dir)
    return paths


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    from svgpvae_tpu_torch.ops import _build  # fails outside a checkout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls and cuDNN")
    device = torch.device("cuda", 0)

    log(gpu_name_and_power())
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load()
    log(f"build (nvcc at first use, then load): "
        f"{time.perf_counter() - t0:.2f} s")

    def timed(phase, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"[phase {phase}: {time.perf_counter() - t:.1f} s]")
        return out

    records = timed(3, phase_kernels, device)
    timed(3, phase_train_stats, device)
    b1 = timed(3, phase_chol_inverse, device)
    timed(3, phase_b1_one_call, device)
    timed(3, phase_occupancy, device)
    results, serve_launches, corpus = timed(4, phase_serve)
    for name, res in results.items():
        timed(5, phase_cpu_check, name, res)
    mnist_data = mnist_splits()
    train_res, train_launches = timed(6, phase_train, mnist_data)
    timed(7, phase_train_cpu_check, train_res)
    runs = tempfile.TemporaryDirectory(prefix="chip_smoke_runs_")
    sprites_res, sprites_launches = timed(
        8, phase_sprites_train, corpus,
        SPRITES_ARGV + SAVE_ARGV + ["--base_dir", runs.name])
    timed("9a", phase_sprites_b1, sprites_res)
    timed("9b", phase_sprites_cpu_check, sprites_res)
    large_m = timed(10, phase_large_m, corpus, mnist_data, device)
    titsias_res, titsias_launches = timed(
        11, phase_train, mnist_data, TITSIAS_ARGV, 32, TRAIN_STEPS,
        CAPTURE_STEP, "mnist titsias train", 2)
    timed(11, phase_train_cpu_check, titsias_res, TITSIAS_ARGV)
    sp_titsias_res, sp_titsias_launches = timed(
        12, phase_sprites_train, corpus, SPRITES_TITSIAS_ARGV, 72, 16,
        SPRITES_PRETRAIN_STEPS, SPRITES_CAPTURE,
        "sprites titsias train (record flags)", (0, 2))
    timed(12, phase_sprites_cpu_check, sp_titsias_res, SPRITES_TITSIAS_ARGV)
    mnist_run, resume_launches, mnist_pictures = timed(
        "13a", phase_mnist_save_resume, mnist_data, runs.name, train_res)
    mnist_served, mnist_serve_launches = timed(
        "13b", phase_serve_run, mnist_run, mnist_data, runs.name, "mnist")
    timed("13b", phase_cpu_check, "mnist run", mnist_served,
          RUN_FIT_NOISE_FACTOR)
    sprites_served, sprites_serve_launches = timed(
        "13c", phase_serve_run, sprites_res["run_dir"], corpus, runs.name,
        "sprites")
    timed("13c", phase_cpu_check, "sprites run", sprites_served,
          RUN_FIT_NOISE_FACTOR)
    ball_launches, ball_runs = timed(14, phase_ball, runs.name)
    baseline_launches, phase15 = timed(15, phase_baselines, mnist_data,
                                       corpus)
    flag_launches, flag_runs = timed(16, phase_driver_flags, mnist_data,
                                     corpus, runs.name, train_launches)
    bf16_launches, bf16_run = timed(17, phase_mixed_precision, corpus,
                                    mnist_data, train_res, sprites_res)
    dp_launches = timed(18, phase_data_parallel, mnist_data, train_res,
                        sprites_res["run_dir"], runs.name)
    picture_launches = timed(19, phase_pictures, runs.name, {
        "8": sprites_res, "13(a)": (mnist_run, mnist_pictures),
        **flag_runs})
    chunk_launches = timed(20, phase_epoch_chunk, mnist_data,
                           (train_res, train_launches),
                           (titsias_res, titsias_launches), runs.name)
    default_launches = timed(21, phase_default_loops, mnist_data,
                             (train_res, train_launches),
                             (titsias_res, titsias_launches), ball_runs,
                             runs.name)
    rest_launches = timed(22, phase_captured_rest, mnist_data, phase15,
                          runs.name)
    cards = torch.cuda.device_count()
    nccl_launches = {}
    if cards >= 2:
        nccl_launches = timed(23, phase_nccl, mnist_data, corpus,
                              runs.name)
    else:
        log(f"[phase 23: not run: --data_parallel over NCCL needs 2 cards or "
            f"more, this machine has {cards}]")
    eval_launches = timed(24, phase_captured_eval, mnist_data, corpus,
                          mnist_run, runs.name)
    runs.cleanup()
    paths = {"serve": serve_launches, "mnist_train": train_launches,
             "sprites_train": sprites_launches, **large_m,
             "mnist_titsias_train": titsias_launches,
             "sprites_titsias_train": sp_titsias_launches,
             "mnist_resume_train": resume_launches,
             "mnist_serve_run": mnist_serve_launches,
             "sprites_serve_run": sprites_serve_launches, **ball_launches,
             **baseline_launches, **flag_launches, **bf16_launches,
             "pictures": picture_launches, **chunk_launches,
             **default_launches, **rest_launches, **eval_launches,
             **nccl_launches}
    # phase 18's paths (every rank's launches, summed) under one key
    paths["data_parallel"] = {k: sum(p[k] for p in dp_launches.values())
                              for k in KERNELS}

    at_slice = {r["name"]: r for r in records
                if r["shape"] == "slice" and r["family"] == "sprites"
                and not r["normalize"]}
    # B3's entry: the SPRITES fit, with its other timed shapes (the
    # normalize variant, the mnist family at the MNIST fit) under "variants"
    at_slice["fused_kernel_stats"] = dict(
        at_slice["fused_kernel_stats"], variants=[
            dict(family=r["family"], normalize=r["normalize"],
                 shape=r["dims"], ms=r["ms"], graph_ms=r["graph_ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                 bound_by=r["bound"][1], max_abs_err=r["max_abs_err"])
            for r in records if r["name"] == "fused_kernel_stats"
            and r["graph_ms"] is not None
            and r is not at_slice["fused_kernel_stats"]])
    # B1's entry: the training shape (warp form), with every shape of
    # phase 3 under "forms"
    at_slice["chol_inverse"] = dict(b1[0], library_ms=None, forms=[
        dict(form=r["form"], shape=r["dims"], ms=r["ms"],
             graph_ms=r["graph_ms"], plain_ms=r["plain_ms"],
             bound_ms=r["bound"][0], bound_by=r["bound"][1],
             max_abs_err=r["max_abs_err"]) for r in b1])
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = at_slice[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=sum(p[name] for p in paths.values()),
            launches_by_path={k: p[name] for k, p in paths.items()},
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=r["library_ms"],
            shape=r["dims"], graph_ms=r["graph_ms"],
            **{k: r[k] for k in ("forms", "variants") if k in r}))
    if "matplotlib" in sys.modules or "PIL" in sys.modules:
        raise AssertionError("matplotlib or PIL was imported")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
