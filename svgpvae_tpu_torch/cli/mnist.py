"""Rotated-MNIST training with the PyTorch port: the SVGPVAE (Hensman or
Titsias bound, with or without GECO) and the baselines (plain VAE, CVAE,
deep SVIGP, the Casale GPVAE).

    python -m svgpvae_tpu_torch.cli.mnist --elbo SVGPVAE_Hensman --GECO \
        --clip_qs --PCA --ip_joint --GP_joint --ov_joint --dataset 36 \
        --synthetic_digits --opt_regime joint-2 --eval_every 2 [--device cuda]

The three run functions of svgpvae_tpu/cli/mnist.py, dispatched on
--elbo as there:

  * `run_svgpvae` (SVGPVAE_Hensman, SVGPVAE_Titsias, VAE, CVAE): the
    dataset (pickles under --mnist_data_path; when absent, generated
    there as the JAX driver's ensure_dataset does: from a keras-layout
    <mnist_data_path>/mnist.npz, for --dataset 3 from the reference's
    eval pickle, or from the seven-segment stand-in glyphs with
    --synthetic_digits),
    the GP initialisation (KDE inducing points, PCA object vectors), then
    per epoch every full batch and the tail batch through one training
    step each, and every --eval_every epochs the eval MSE, the test MSE
    and the conditional-generation (cgen) MSE, whose GP posterior
    conditions on the encodings of the whole train split.  VAE and CVAE
    train --nr_epochs epochs of the standard-normal-prior ELBO
    (models.vae; the CVAE's cgen decodes each test object's mean train
    latent at the test angle, `predict_cvae`; the VAE has none).  An
    SVGPVAE run's --opt_regime may hold VAE phases ('VAE-10 joint-90'):
    their epochs train the VAE ELBO alone, and the trainable GP tensors,
    which that loss does not reach, still take their Adam update from a
    zero gradient, as under JAX's one masked optax Adam
    (train.train_step).
  * `run_svigp` (SVIGP_Hensman): the decoder-only deep SVIGP
    (gp.svigp, models.svigp): explicit variational parameters, the exact
    Gaussian likelihood with a trainable noise, aux rows with the global
    row index first; --nr_epochs epochs, cgen every --eval_every.
  * `run_casale` (GPVAE_Casale, alias GPVAE_Casale_batch): the train set
    sorted by (id, angle); every step encodes the WHOLE train split (or,
    with --casale_taylor_every K, every K-th step, the held sample between
    refreshes, without gradient), builds V and the factored Taylor terms
    (gp.casale) and takes the batch's loss (models.casale); --opt_regime's
    joint / GP / VAE epochs each step their own Adam (own moments and step
    count: --lr_joint over every tensor, --lr_gp over the GP's, 0.001 over
    the VAE's; the VAE regime's loss is the plain VAE ELBO); the cgen
    every 5 epochs, as the JAX driver (which ignores --eval_every there).

Each SVGPVAE step: conv encoder and the variance clip; the MnistSVGP
kernel matrices; the sufficient statistics (B2 `gp_sufficient_stats`
kernel forward, einsum backward); the (L+1, m, m) stack [K_mm;
Sigma_1..L]; with --gp_block_impl fused_pallas (the 'auto' choice on a
CUDA device) its inverse and logdets from the B1 `chol_inverse` kernel
(two-matmul backward); the Hensman terms, the cross-entropy, the
reparameterised sample, the conv decoder; GECO and Adam.  With
SVGPVAE_Titsias the block is gp.fused.gp_block_titsias: B2 twice (at the
encoder noise and at noise + jitter), and with fused_pallas (the 'auto'
choice on a CUDA device, as for Hensman) one B1 launch on the
(33, 32, 32) stack [K_mm; Sigma_1..16; Sigma1_1..16]; the CE term is the
exact entropy unless --titsias_reference_ce.  `--gp_block_impl` takes
the JAX driver's values, so one argv drives both; a `*_pallas` value
means the hand-written CUDA kernel B1 on a CUDA device and its plain twin
on the CPU.  'auto' resolves through models.GP_BLOCK_AUTO_TABLE.  The
baselines reach none of the port's kernels.

The device is --device (cuda by default; the run refuses to start
without one).  TF32 is off for matmuls and cuDNN.  Weights come from
flax's initialisation (nn.nets.init_like_flax_) drawn from a
torch.Generator seeded by --seed, or from --params (an .npz of flat
JAX parameters, tools/export_jax_params.py's format).  The noise of step
t is drawn from a torch.Generator seeded by --seed; the eval passes draw
theirs from a generator seeded with 7 for each batch (the JAX driver's
eval key is also one fixed key per batch).

Run outputs, as the JAX driver writes them: --save makes the run dir
<base_dir>/<expid>/<N>_<elbo>_<beta>__on__<stamp>/ (utils.rundir) with
args.json, and every eval pass of run_svgpvae appends to
res/ELBO_results.csv and res/GP_params.csv (the JAX columns, on the eval
split's first batch; the VAE columns for VAE and CVAE, and a VAE epoch
of an SVGPVAE run appends to res/ELBO_VAE_results.csv instead), writes
res/gp_params_<step>.npz and a line of pics/test_metrics.txt;
--save_model_weights adds a checkpoint (utils.checkpoint: the whole
TrainState and the training noise generator; Casale: each regime's) under
ckpt/ at every eval; at the end the last eval's cgen images go to
cgen_images.p (not for Casale, as in JAX) and, with --save_latents,
samples of the train split's latents to latents_train.p.  --resume_dir
<run dir> restores its latest checkpoint and runs the remaining epochs
from the restored step, writing into that run dir (run_svgpvae only:
the JAX driver's run_svigp and run_casale never read it, and the port
refuses it there).  The JAX
driver's pictures, drawn with numpy alone (utils.plots; the card's
machine has no matplotlib) and written with the titles in their PNG
text chunks, at every eval pass with a run dir: run_svgpvae's
pics/<step>.png (8 test images against their reconstructions, "epoch
E. recon MSE test X"), pics/<step>_cgen.png (SVGPVAE and CVAE: the cgen
images, "epoch E. CGEN MSE X") and, at an SVGPVAE epoch's metric rows,
pics/<step>_kernels.png (the view, object and product kernels on the
first train batch's aux rows, `kernel_matrices`); run_svigp's and
run_casale's pics/<step>_cgen.png.  They are drawn on the host after the
eval pass, outside the step timings; each result's "pictures" lists the
files and the host seconds of each.  --show_pics is accepted and
ignored, as by the JAX driver.

The sentinel: after every epoch the step metrics go through
utils.check_finite; on the first NaN/inf it writes the current state (the
checkpoint's dict) to <run dir>/ckpt_nan/<step>.pt when a run dir exists
and raises utils.NonFiniteLossError, with the JAX package's message.
That file is a diagnostic, not a resume point.

Driver flags, as in the JAX driver:

  * --reshuffle (SVGPVAE, VAE, CVAE, deep SVIGP): every epoch permutes
    the full batches' examples and leaves the tail batch in place
    (train.EpochShuffle), from a CPU torch.Generator seeded by --seed
    whose state the checkpoints keep; `main(perm_fn=)` injects another
    permutation (tests: JAX's).  A --bias_analysis epoch keeps the stored
    order, as JAX's per-step loop does.  Refused for Casale, whose JAX
    run never reads it;
  * --test_set_metrics: the per-eval metric rows come from the test
    split's first batch in place of the eval split's (run_svgpvae);
  * --profile_dir DIR: a torch.profiler trace (CPU and CUDA activities,
    one Chrome-trace JSON in DIR, opened by chrome://tracing or Perfetto)
    of the first timed epoch: the first after epoch 0 whose regime is the
    previous epoch's.  Its ranges "train_step", "gp_block" and
    "eval_pass" come from utils.annotate;
  * --x64 (SVGPVAE, VAE, CVAE): data, nets, GP and Adam in float64.  The
    CUDA kernels take fp32 only, so the GP blocks of a float64 CUDA run
    call their plain PyTorch versions (gp.svgp.on_plain_path, printed at
    the start): such a run launches no kernel.  'auto' resolves as on the
    CPU.  Refused for deep SVIGP and Casale, whose JAX runs ignore it;
  * --bias_analysis (SVGPVAE): the training steps run the two-pass block
    and keep its mu_hat (L, m); after each epoch the q(u) mean over the
    whole train split (gp.posterior_params on every train encoding: B2 at
    n = N_train on a CUDA device) and "bias for epoch E: B", the mean
    |epoch average of the batch estimates - full-split mean|;
  * --bf16 (SVGPVAE, VAE, CVAE): the conv nets compute in bfloat16 (the
    flax meaning of dtype=, nn.nets.cast_layer); their parameters, the
    Adam state and the checkpoints stay fp32, and so does the GP math:
    the encodings are cast to fp32 before the GP block, which with every
    kernel (B1, B2) takes fp32 only.  The VAE and CVAE keep their latent
    sample and KL in bf16, as JAX does.  --x64 overrides it (float64, with
    JAX's warning).  Refused for deep SVIGP and Casale, whose JAX runs
    ignore it.  The cgen images are pickled as fp32 (numpy has no bf16).

--data_parallel N (SVGPVAE, VAE, CVAE, deep SVIGP; 0 off, -1 every
visible device): N ranks, one process each (parallel.launch starts ranks
1..N-1 when the driver runs alone).  Every rank holds the parameters,
draws the global batch's noise from the run's generator and takes its
contiguous share of each full batch's rows; the GP statistics and every
sum over the batch are added across ranks (parallel.psum), so the loss,
the GECO state and each gradient are the 1-process run's, and every
rank's Adam takes the same step.  The tail batch runs replicated on every
rank, as the eval passes do, but for the cgen's full-train fit, which
each rank runs on its share of the train rows (B2) before the sums are
added.  Only rank 0 writes the run dir, its CSVs and checkpoints and
prints; --resume_dir restores on every rank.  With a card per rank the
ranks talk over NCCL and the training loops replay CUDA graphs with the
all-reduces inside (below); ranks sharing a card talk over gloo and step
one by one.  Refused, with the JAX driver's messages: N above the
visible devices, a --batch_size that N does not divide, and
--bias_analysis; and for Casale, which the JAX driver runs on one device
whatever the flag says.

The default loop (--epoch_chunk 1) is the JAX driver's one program an
epoch (train.make_epoch_fn): on a CUDA device, in a 1-process run or
under --data_parallel over NCCL, each epoch of every runner replays
captured CUDA graphs, a full-batch step and the tail step
(make_epoch_chunks with a chunk of one epoch), and its metrics are read
back once.  Over NCCL each rank replays the same graphs in the same
order: the full-batch step's graph takes the rank's rows and holds the
step's all-reduces (the GP statistics' psums, their backward, the
gradients'), the tail step's the replicated step's mean all-reduces.
The SVGPVAE's VAE phases of --opt_regime replay graphs of the VAE loss
that step the same optimizer, step counter and GECO state as the joint
graphs (one capture.GraphSteps over both losses); each Casale regime
replays its own graphs, and under --casale_taylor_every K > 1 the
refresh of the held full-train sample is a graph of its own ahead of
every K-th step.  Elsewhere the steps run one by one, and the run prints
why (per_step_reason): the CPU, --data_parallel over gloo (ranks sharing
a card: gloo stages each all-reduce through the host), --bias_analysis
(per step in the JAX driver too), --x64, a capture_step, an injected
eps_fn without a generator, or main(per_step=True).  A replayed epoch's
steps are timed as its seconds over its steps; the first epoch, and the
first after each regime switch (warm-ups and captures), are left out of
the p50.

The JAX driver's one-program flags, with the same numbers as an
unchunked run and fewer host round trips:

  * --epoch_chunk N (SVGPVAE, deep SVIGP): N whole epochs, tails
    included, through train.make_multi_epoch_fn, their per-step metrics
    kept on the device and read once a chunk; evals, CSV rows,
    checkpoints, pictures and the sentinel run at chunk ends and see the
    post-epoch state of an unchunked run.  It falls back to unchunked, with
    the JAX driver's warning, for the reasons of
    epoch_chunk_fallback_reasons (a VAE phase, --bias_analysis,
    --profile_dir, a chunk that does not divide --eval_every or the epoch
    count, VAE and CVAE).  On a CUDA device in a 1-process run the steps
    replay two captured CUDA graphs, a full-batch step and the tail step
    (train.capture.GraphSteps: the run's first steps are its warm-ups, Adam
    turns capturable, so the run sits within round-off of an eager one),
    also under --data_parallel over NCCL; on the CPU and under gloo the
    run takes the unchunked per-epoch loop, which gives the same
    numbers.  The timer keeps each chunk's seconds after synchronize;
    the first chunk (warm-up and captures) is left out of the p50, as
    JAX leaves out the compile;
  * --eval_bundle (SVGPVAE, outside a VAE-phase epoch): the eval recon,
    the test recon, the full-train encode and the cgen, tails included,
    as one function with the sums on the device and one readback per
    eval; on a CUDA device, in a 1-process run or over NCCL (the cgen's
    sharded fit and its all-reduce inside), it replays one captured CUDA
    graph (train.capture.CapturedCall), as each unbundled eval pass and
    Casale's cgen do, but under main(per_step=True)
    (eval_pass_reason).  Its images and per-batch
    losses equal the unbundled eval's; its MSEs are fp32 sums on the
    device where the unbundled eval adds Python floats.  Accepted without
    effect for VAE and CVAE, as by the JAX driver.
Each driver run prints one line saying whether they are captured.
Refused where the JAX driver's run never reads them (IGNORED_BY_JAX):
both for Casale, --eval_bundle for deep SVIGP.
"""

from __future__ import annotations

import argparse
import math
import os
import pickle
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from svgpvae_tpu_torch import data, models, ops, parallel, train, utils
from svgpvae_tpu_torch import gp as gpm
from svgpvae_tpu_torch import kernels
from svgpvae_tpu_torch.nn import MnistCVAE, MnistVAE, SVIGPDecoder
from svgpvae_tpu_torch.train import capture
from svgpvae_tpu_torch.utils import plots
from svgpvae_tpu_torch.utils.convert import (casale_params_from_jax,
                                             cvae_params_from_jax,
                                             mnist_params_from_jax,
                                             svigp_params_from_jax)

EVAL_SEED = 7  # the JAX driver's eval key, jax.random.PRNGKey(7)
CASALE_EVAL_EVERY = 5  # run_casale's fixed eval cadence (epochs)
CASALE_VAE_LR = 0.001  # the Casale VAE regime's Adam lr
CASALE_ELBOS = ("GPVAE_Casale", "GPVAE_Casale_batch")
# the reference repository's digit-3 eval pickle ("MNIST data/eval_data3.p"
# there), looked for under --mnist_data_path by this name: the JAX driver
# reads it from a fixed absolute path, outside any checkout
REF_EVAL_PICKLE = "reference_eval_data3.p"


def build_parser() -> argparse.ArgumentParser:
    """The JAX driver's arguments (same names and defaults), plus
    --device and --params."""
    p = argparse.ArgumentParser(
        description="Rotated MNIST training (PyTorch port)")
    p.add_argument("--expid", type=str, default="debug_MNIST")
    p.add_argument("--base_dir", type=str, default=os.getcwd())
    p.add_argument("--elbo", type=str, default="VAE",
                   choices=["VAE", "CVAE", "SVGPVAE_Hensman",
                            "SVGPVAE_Titsias", *CASALE_ELBOS,
                            "SVIGP_Hensman"])
    p.add_argument("--mnist_data_path", type=str, default="mnist_data/")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--nr_epochs", type=int, default=1000)
    p.add_argument("--beta", type=float, default=0.001)
    p.add_argument("--nr_inducing_points", type=float, default=2,
                   help="object vectors per angle")
    p.add_argument("--save", action="store_true")
    p.add_argument("--GP_joint", action="store_true")
    p.add_argument("--ip_joint", action="store_true")
    p.add_argument("--ov_joint", action="store_true")
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--lr_decay", type=float, default=None,
                   help="cosine-decay the lr to lr*LR_DECAY over the run "
                        "(SVGPVAE/VAE/SVIGP; Casale keeps its fixed lrs)")
    p.add_argument("--save_model_weights", action="store_true")
    p.add_argument("--dataset", type=str, default="3",
                   choices=["3", "36", "13679"])
    p.add_argument("--show_pics", action="store_true", help="unused")
    p.add_argument("--opt_regime", type=str, default=["joint-1000"],
                   nargs="+")
    p.add_argument("--L", type=int, default=16)
    p.add_argument("--clip_qs", action="store_true")
    p.add_argument("--ram", type=float, default=1.0, help="unused")
    p.add_argument("--test_set_metrics", action="store_true")
    p.add_argument("--GECO", action="store_true")
    p.add_argument("--alpha", type=float, default=0.99)
    p.add_argument("--kappa_squared", type=float, default=0.020)
    p.add_argument("--geco_lambda_max", type=float, default=1e5,
                   help="cap on the GECO lagrange multiplier (float32 safety)")
    p.add_argument("--object_kernel_normalize", action="store_true")
    p.add_argument("--save_latents", action="store_true")
    p.add_argument("--jitter", type=float, default=1e-6)
    p.add_argument("--PCA", action="store_true")
    p.add_argument("--bias_analysis", action="store_true")
    p.add_argument("--M", type=int, default=8)
    p.add_argument("--lr_gp", type=float, default=0.01,
                   help="Casale GP-regime Adam lr")
    p.add_argument("--lr_joint", type=float, default=0.001,
                   help="Casale joint-regime Adam lr")
    p.add_argument("--casale_alpha_softplus", action="store_true",
                   help="Casale: latent-GP noise = softplus(raw) in place "
                        "of the straight-through floor clamp")
    p.add_argument("--casale_alpha_max", type=float, default=0.0,
                   help="Casale: straight-through ceiling on the latent-GP "
                        "noise (0 = uncapped)")
    p.add_argument("--casale_predict_alpha", type=float, default=0.0,
                   help="Casale: the cgen smoother's latent-GP noise (0 = "
                        "the trained one)")
    p.add_argument("--casale_taylor_every", type=int, default=1,
                   help="Casale: refresh the full-train encode every K "
                        "steps (held without gradient in between)")
    p.add_argument("--N_t", type=int, default=None)
    p.add_argument("--eval_every", type=int, default=10,
                   help="epochs between eval/test/cgen passes")
    p.add_argument("--resume_dir", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--epoch_chunk", type=int, default=1)
    p.add_argument("--eval_bundle", action="store_true")
    p.add_argument("--gp_block_impl", type=str, default="auto",
                   choices=["auto", *models.svgpvae.GP_BLOCK_IMPLS],
                   help="GP block of the training forward: two-pass "
                        "reference, one-pass fused (Cholesky), "
                        "fused_pallas (inverse + logdet from chol_inverse: "
                        "the CUDA kernel B1 on a CUDA device, its twin on "
                        "the CPU), the rejittered-KL variants, or auto "
                        "(fused_pallas on CUDA; on the CPU reference for "
                        "Hensman, fused for Titsias)")
    p.add_argument("--titsias_reference_ce", action="store_true",
                   help="Titsias only: the reference's encoder "
                        "cross-entropy CE term in place of the exact "
                        "entropy (PARITY.md #13)")
    p.add_argument("--entropy_ce", action="store_true",
                   help="use the exact sampling-distribution entropy CE "
                        "term")
    p.add_argument("--synthetic_digits", action="store_true",
                   help="generate missing dataset pickles from the "
                        "seven-segment stand-in glyphs")
    p.add_argument("--reshuffle", action="store_true")
    p.add_argument("--data_parallel", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--x64", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--params", type=str, default=None,
                   help=".npz of flat JAX parameters of this --elbo's model "
                        "(tools/export_jax_params.py) to start from")
    return p


# flag -> (is it set?, the --elbo values whose JAX run never reads it)
IGNORED_BY_JAX = {
    "--epoch_chunk": (lambda a: a.epoch_chunk > 1, CASALE_ELBOS),
    "--eval_bundle": (lambda a: a.eval_bundle,
                      (*CASALE_ELBOS, "SVIGP_Hensman")),
    "--reshuffle": (lambda a: a.reshuffle, CASALE_ELBOS),
    "--x64": (lambda a: a.x64, (*CASALE_ELBOS, "SVIGP_Hensman")),
    "--bf16": (lambda a: a.bf16, (*CASALE_ELBOS, "SVIGP_Hensman")),
    "--resume_dir": (lambda a: a.resume_dir,
                     (*CASALE_ELBOS, "SVIGP_Hensman")),
}


def refuse_unported(args) -> None:
    if args.elbo in CASALE_ELBOS and args.data_parallel:
        raise SystemExit(f"--data_parallel: not ported for --elbo "
                         f"{args.elbo}, which the JAX driver runs on one "
                         "device whatever the flag says")
    for flag, (is_set, elbos) in IGNORED_BY_JAX.items():
        if is_set(args) and args.elbo in elbos:
            raise SystemExit(f"{flag}: not ported for --elbo {args.elbo} "
                             "(the JAX driver's run for it never reads the "
                             "flag)")
    if args.save_latents and args.elbo == "CVAE":
        raise SystemExit("--save_latents: not ported for --elbo CVAE (the "
                         "JAX driver's latents pass encodes without angles)")


def epoch_chunk_fallback_reasons(chunk: int, eval_every: int,
                                 nr_epochs: int, svgpvae: bool = True,
                                 regime=(), bias_analysis: bool = False,
                                 profile_dir=None) -> list:
    """Why --epoch_chunk must degrade to unchunked, as user-readable
    reasons (empty: chunking is valid); the JAX driver's rules and words.
    A chunk runs `chunk` whole epochs with one readback, so what needs the
    host between epochs (a VAE-phase regime switch, the per-epoch
    --bias_analysis pass, a one-epoch --profile_dir trace) or a cadence
    that does not fall on chunk boundaries would break the guarantee that
    every eval and saver row sees the post-epoch state of the unchunked
    loop."""
    reasons = []
    if chunk <= 1:
        return reasons
    if not svgpvae:
        reasons.append("SVGPVAE/Titsias (or SVIGP) runners only")
    if any(r == "VAE" for r in regime):
        reasons.append("--opt_regime has a VAE phase (regime switches "
                       "need per-epoch host control)")
    if bias_analysis:
        reasons.append("--bias_analysis hooks run per epoch on the host")
    if profile_dir:
        reasons.append("--profile_dir traces exactly one epoch program")
    if eval_every % chunk:
        reasons.append(f"chunk ({chunk}) must divide --eval_every "
                       f"({eval_every}) so evals land on chunk boundaries")
    if nr_epochs % chunk:
        reasons.append(f"chunk ({chunk}) must divide the epoch count "
                       f"({nr_epochs})")
    return reasons


def resolve_epoch_chunk(args, nr_epochs: int, **kw) -> int:
    """--epoch_chunk's chunk after epoch_chunk_fallback_reasons (1:
    unchunked), with the JAX driver's warning when it falls back."""
    chunk = max(1, args.epoch_chunk)
    reasons = epoch_chunk_fallback_reasons(
        chunk, args.eval_every, nr_epochs, profile_dir=args.profile_dir,
        **kw)
    if args.epoch_chunk > 1 and reasons:
        print(f"warning: --epoch_chunk {chunk} disabled (running "
              f"unchunked, per-epoch dispatch): {'; '.join(reasons)} "
              "— see docs/cli.md 'epoch_chunk interaction rules'")
        return 1
    return chunk


def uncaptured_reason(device: torch.device) -> Optional[str]:
    """Why --epoch_chunk's steps and the eval passes run without CUDA
    graphs here, or None: they are captured on a CUDA device, in a
    1-process run or over NCCL (the all-reduces captured with the
    steps)."""
    if device.type != "cuda":
        return f"a {device.type} device"
    if parallel.run_ranks() > 1 and \
            getattr(parallel.group(), "backend", None) != "nccl":
        return ("--data_parallel: gloo stages its all-reduces through the "
                "host")
    return None


def eval_pass_reason(device: torch.device, per_step: bool) -> Optional[str]:
    """Why a run's eval passes (the unbundled passes, --eval_bundle's
    group, Casale's cgen) run eagerly, or None: each replays a captured
    CUDA graph.  main(per_step=True) runs them eagerly too, so that the
    card's per-step yardstick holds no graph."""
    return "main(per_step=True)" if per_step else uncaptured_reason(device)


def per_step_reason(args, device: torch.device, per_step: bool,
                    capture_step: Optional[int], generator,
                    draws: bool = True) -> Optional[str]:
    """Why this run's default loop (--epoch_chunk 1) takes its steps one
    by one, or None: each epoch replays captured CUDA graphs, as the JAX
    driver runs each epoch as one program (train.make_epoch_fn).  `draws`:
    whether the loop draws noise (from `generator`)."""
    if per_step:
        return "main(per_step=True)"
    why = uncaptured_reason(device)
    if why is not None:
        return why
    if getattr(args, "bias_analysis", False) and "SVGPVAE" in args.elbo:
        return "--bias_analysis runs per step, as in the JAX driver"
    if getattr(args, "x64", False):
        return "--x64"
    if capture_step is not None:
        return "capture_step keeps one step's inputs"
    if draws and generator is None:
        return ("the eps_fn exposes no `generator`, so every replay would "
                "reuse its captured draws")
    return None


def make_epoch_chunks(chunk: int, device: torch.device, rec: "StepRecorder",
                      loss_fn, batch_size: int, tensors,
                      shuffle: Optional[train.EpochShuffle],
                      generator: Optional[torch.Generator],
                      draws: bool = True,
                      per_step_why: Optional[str] = None
                      ) -> Optional["EpochChunks"]:
    """The run's epochs as replayed CUDA graphs (capture.GraphSteps), in
    chunks of `chunk` epochs (--epoch_chunk, train.make_multi_epoch_fn),
    by default chunks of one epoch (the JAX driver's make_epoch_fn), or
    None
    where they are not captured: a chunked run where uncaptured_reason
    says so, a default run where `per_step_why` (per_step_reason) does;
    there the run takes the per-step loop, which gives the same numbers.
    `loss_fn`: one loss, or {kind: loss} (capture.StepGraphs; the VAE
    epochs of an --opt_regime with VAE phases step the kind "VAE").
    Prints which.  A captured chunk is refused with a capture_step (a
    graph keeps no step's inputs) and, for a run that `draws` noise, with
    an eps_fn that exposes no `generator` (its draws would be captured as
    constants)."""
    if chunk <= 1:
        why = per_step_why
        print("training loop: " + (
            f"per step ({why})" if why else "each epoch replays captured "
            "CUDA graphs (a full-batch step and the tail step), one "
            "readback an epoch"))
    else:
        why = uncaptured_reason(device)
        if why is None and rec.capture_step is not None:
            raise ValueError("capture_step: a captured chunk keeps no "
                             "step's inputs (run on the CPU)")
        if why is None and draws and generator is None:
            raise ValueError("--epoch_chunk on CUDA: the eps_fn exposes no "
                             "`generator`, so every replay would reuse its "
                             "captured draws")
        print(f"--epoch_chunk {chunk}: " + (
            f"{chunk} epochs a chunk, one readback each; the steps replay "
            "captured CUDA graphs (a full-batch step and the tail step)"
            if why is None else "the steps run uncaptured, one epoch at a "
            f"time as in an unchunked run ({why})"))
    if why is not None:
        return None
    graphs = capture.GraphSteps(loss_fn, batch_size,
                                [generator] if draws else [], shard=True)
    return EpochChunks(train.make_multi_epoch_fn(graphs, shuffle), graphs,
                       rec, tensors, chunk)


class EpochChunks:
    """A run's epochs in chunks: `epoch(state, e, kind, timed)` -> (epoch
    e's per-step metrics, the step count at its end, as the JAX driver
    counts it), running the chunk of the loss `kind` (StepRecorder.chunk,
    one readback; `timed`: whether its seconds join the p50) at the
    chunk's first epoch.  `graphs`: the capture.GraphSteps the chunks
    replay."""

    def __init__(self, multi_fn: Callable, graphs, rec: "StepRecorder",
                 tensors, chunk: int):
        self.multi_fn, self.graphs, self.rec = multi_fn, graphs, rec
        self.tensors, self.chunk, self.steps = tensors, chunk, None

    def epoch(self, state, epoch: int, kind: Optional[str] = None,
              timed: bool = True) -> tuple:
        i = epoch % self.chunk
        if i == 0:
            self.steps = self.rec.chunk(self.multi_fn, state, self.tensors,
                                        self.chunk, timed=timed, kind=kind)
        steps = self.steps[i]
        return steps, state.step - (self.chunk - 1 - i) * len(steps)


def graph_record(chunks: Optional[EpochChunks], *calls) -> dict:
    """{"graph_replays", "graph_launches", "graph_all_reduces"} of a run's
    captured CUDA graphs (the chunks' and the captured calls' that ran):
    each graph's replays, and the kernel launches and all-reduces of one
    replay."""
    graphs = dict(chunks.graphs.graphs) if chunks is not None else {}
    graphs.update((name, call.graph) for name, call in calls
                  if isinstance(call, capture.CapturedCall)
                  and call.graph is not None)
    return {"graph_replays": {k: g.replays for k, g in graphs.items()},
            "graph_launches": {k: g.launches for k, g in graphs.items()},
            "graph_all_reduces": {k: g.all_reduces
                                  for k, g in graphs.items()}}


def pass_record(calls: Dict[str, "capture.CapturedCall"]) -> dict:
    """{"eval_graph_replays", "eval_graph_launches"} of a run's captured
    eval passes (run_svgpvae's unbundled passes, Casale's cgen): each
    graph's replays and the kernel launches of one replay."""
    graphs = {k: c.graph for k, c in calls.items() if c.graph is not None}
    return {"eval_graph_replays": {k: g.replays for k, g in graphs.items()},
            "eval_graph_launches": {k: g.launches
                                    for k, g in graphs.items()}}


def load_splits(args) -> dict:
    """{"train", "eval", "test", "pca_ov_init"} from the pickles under
    --mnist_data_path, generated there first when absent (ensure_dataset)."""
    ensure_dataset(args)
    suffix = "" if args.M == 8 else f"_{args.M}"
    path = args.mnist_data_path
    train_d, eval_d, test_d = data.load_rotated_mnist(
        path, digits=args.dataset, M=args.M, N_t=args.N_t)
    with open(os.path.join(path, f"pca_ov_init{args.dataset}{suffix}.p"),
              "rb") as f:
        pca = pickle.load(f)
    return {"train": train_d, "eval": eval_d, "test": test_d,
            "pca_ov_init": pca}


def ensure_dataset(args) -> None:
    """The JAX driver's ensure_dataset: when --mnist_data_path holds no
    pickles for --dataset, generate them from the base images of, in this
    order, a keras-layout <mnist_data_path>/mnist.npz (any digits), the
    eval pickle <mnist_data_path>/REF_EVAL_PICKLE (--dataset 3), or the
    seven-segment glyphs (--synthetic_digits); otherwise refuse with the
    JAX driver's words.  Two deliberate divergences: the JAX driver reads
    the eval pickle from a fixed path outside the data directory, and
    requires it to exist before it will take --synthetic_digits."""
    suffix = "" if args.M == 8 else f"_{args.M}"
    path = args.mnist_data_path
    train_p = os.path.join(path, f"train_data{args.dataset}{suffix}.p")
    if os.path.exists(train_p):
        return
    keras_npz = os.path.join(path, "mnist.npz")
    eval_pickle = os.path.join(path, REF_EVAL_PICKLE)
    have_eval = os.path.exists(eval_pickle)
    if os.path.exists(keras_npz):
        print(f"dataset not found at {train_p}; bootstrapping from the "
              f"real MNIST archive {keras_npz}")
        base = data.load_keras_mnist_npz(keras_npz, digits=args.dataset,
                                         per_digit=400, seed=args.seed)
    elif args.dataset == "3" and have_eval:
        print(f"dataset not found at {train_p}; deriving base images from "
              "the shipped eval pickle and generating the rotated-MNIST "
              "pickles")
        base = data.derive_base_images_from_eval(eval_pickle,
                                                 n_target=400, seed=args.seed)
    elif args.synthetic_digits:
        print(f"dataset not found at {train_p}; generating synthetic "
              f"stand-in glyphs for digits '{args.dataset}' "
              "(--synthetic_digits)")
        base = data.synthetic_digit_base_images(args.dataset, per_digit=400,
                                                seed=args.seed)
    elif not have_eval:
        raise SystemExit("no dataset pickles and no shipped eval pickle to "
                         "derive from")
    else:
        raise SystemExit(
            f"cannot derive dataset '{args.dataset}' from the shipped "
            "digit-3 eval pickle; provide pre-generated pickles at "
            f"{path} (data.generate_rotated_mnist with "
            "real multi-digit base images), or pass --synthetic_digits "
            "for seven-segment stand-in glyphs")
    data.generate_rotated_mnist(base, path, digits=args.dataset,
                                latent_dim_object_vector=args.M,
                                seed=args.seed)


def object_vectors_init(args, splits: dict) -> Optional[np.ndarray]:
    """The GPLVM table's start under --ov_joint: the PCA embeddings
    (--PCA) or N(0, 1.5^2) draws from RandomState(--seed); None without
    --ov_joint."""
    if not args.ov_joint:
        return None
    if args.PCA:
        return splits["pca_ov_init"]
    n_obj = len(splits["pca_ov_init"])
    return np.random.RandomState(args.seed).normal(
        0, 1.5, n_obj * args.M).reshape(n_obj, args.M)


def _load_params(path: str, convert: Callable) -> dict:
    with np.load(path) as z:
        return convert(dict(z))


def run_dtype(args) -> torch.dtype:
    """float64 under --x64, else float32: the data, parameters and GP."""
    return torch.float64 if args.x64 else torch.float32


def net_dtype(args) -> Optional[torch.dtype]:
    """The nets' compute dtype: bfloat16 under --bf16 unless --x64
    overrides it, else None (the parameters' dtype)."""
    return torch.bfloat16 if args.bf16 and not args.x64 else None


def host_array(t: torch.Tensor) -> np.ndarray:
    """`t` on the host as a numpy array; bf16 (which numpy lacks) as
    fp32."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def draw(pictures: list, run_dir: Optional[str], name: str, kind: str,
         plot: Callable, *args, **kwargs) -> None:
    """With a run dir, plot(*args, **kwargs) into pics/<name>.png, and
    {"file", "kind", "seconds" (host time to copy, draw and write)} onto
    `pictures`; without one nothing.  Tensors among args are copied to
    the host once (bf16 as fp32)."""
    if not run_dir:
        return
    t0 = time.perf_counter()
    args = [host_array(a) if isinstance(a, torch.Tensor) else a
            for a in args]
    plot(*args, save_path=os.path.join(run_dir, "pics", f"{name}.png"),
         **kwargs)
    pictures.append({"file": f"{name}.png", "kind": kind,
                     "seconds": time.perf_counter() - t0})


@torch.no_grad()
def kernel_matrices(gp, aux: torch.Tensor, normalize: bool) -> tuple:
    """The JAX driver's kernel pictures' matrices on the aux rows [id,
    angle, object...]: the view kernel (ExpSinSquared over the angle,
    period 2 pi), the object kernel (linear over the GPLVM table's rows of
    the ids, or the aux rows' object columns; cosine-normalised under
    --object_kernel_normalize) and their product."""
    view = aux[:, 1:2]
    obj = (aux[:, 2:] if gp.object_vectors is None
           else gp.object_vectors[aux[:, 0].long()])
    k_view = kernels.exp_sin_squared_matrix(view, view, gp.amplitude,
                                            gp.length_scale, 2.0 * math.pi)
    k_obj = kernels.linear_matrix(obj, obj)
    if normalize:
        k_obj = kernels.cosine_normalize_matrix(k_obj, obj, obj)
    return k_view, k_obj, k_view * k_obj


def build_model(args, splits: dict, N_train: int, device: torch.device):
    """(MnistVAE or MnistCVAE, MnistSVGP or None) on `device` in the run's
    dtype, the net computing in `net_dtype(args)`: the GP (for the SVGPVAE
    ELBOs) initialised as the JAX driver does; the net from --params or
    flax's init from a generator seeded by --seed."""
    to = dict(device=device, dtype=run_dtype(args))
    net = MnistCVAE if args.elbo == "CVAE" else MnistVAE
    vae = net(L=args.L, generator=torch.Generator().manual_seed(args.seed),
              dtype=net_dtype(args))
    if "SVGPVAE" not in args.elbo:
        if args.params:
            vae.load_state_dict(_load_params(
                args.params, cvae_params_from_jax if args.elbo == "CVAE"
                else mnist_params_from_jax)["vae"])
        return vae.to(**to), None
    ip_init = data.generate_init_inducing_points(
        splits["train"], n=args.nr_inducing_points, use_pca=args.PCA,
        M=args.M, seed=args.seed)
    ov_init = object_vectors_init(args, splits)
    cfg = gpm.SVGPConfig(titsias=args.elbo == "SVGPVAE_Titsias",
                         jitter=args.jitter, N_train=N_train,
                         K_obj_normalize=args.object_kernel_normalize)
    gp = gpm.init_mnist_svgp(ip_init, ov_init, config=cfg)
    if args.params:
        port = _load_params(args.params, mnist_params_from_jax)
        vae.load_state_dict(port["vae"])
        if (port["gp"].get("object_vectors") is None) != (ov_init is None):
            raise ValueError("--params and --ov_joint disagree on the GPLVM "
                             "object-vector table")
        gp = gpm.MnistSVGP(config=cfg, **port["gp"])
    return vae.to(**to), gp.to(**to)


def trainable_predicate(args) -> Callable[[str], bool]:
    """name ("vae/...", "dec/...", "gp/<field>") -> trainable?  As the JAX
    driver's mask: the inducing points follow --ip_joint, the kernel
    scalars --GP_joint, the GPLVM table --ov_joint; the nets and the deep
    SVIGP's variational tensors and noise always train."""
    flags = {"inducing_points": args.ip_joint, "length_scale": args.GP_joint,
             "amplitude": args.GP_joint, "object_vectors": args.ov_joint}

    def predicate(name: str) -> bool:
        part, _, leaf = name.partition("/")
        return flags.get(leaf, True) if part == "gp" else True

    return predicate


def open_run_dir(args) -> Optional[str]:
    """The run's output directory: --resume_dir as it is, or with --save a
    new one (utils.make_checkpoint_folder) holding args.json; else None.
    None on the ranks > 0 of a data-parallel run: rank 0 writes."""
    if not parallel.is_writer():
        return None
    if args.resume_dir:
        print(f"resuming into: {args.resume_dir}")
        return args.resume_dir
    if not args.save:
        return None
    run_dir = utils.make_checkpoint_folder(args.base_dir, args.expid,
                                           f"{args.elbo}_{args.beta}")
    utils.dump_args(run_dir, args)
    print(f"checkpoint dir: {run_dir}")
    return run_dir


def checkpoint_state(state, noise: "Noise", **extra) -> dict:
    """What a checkpoint holds: the TrainState's state_dict, the training
    noise generator's state (None for an injected eps_fn without one) and
    the driver's `extra` entries."""
    gen = noise.generator
    return {"train_state": state.state_dict(),
            "noise": None if gen is None else gen.get_state(), **extra}


def shuffle_state(shuffle: Optional[train.EpochShuffle]) -> dict:
    """checkpoint_state's entry for --reshuffle's generator ({} without
    the flag)."""
    return {} if shuffle is None else {
        "shuffle": shuffle.generator.get_state()}


def restore_shuffle(ckpt: Optional[dict],
                    shuffle: Optional[train.EpochShuffle]) -> None:
    """--reshuffle's generator from a restored checkpoint that holds it."""
    if shuffle is not None and ckpt is not None and "shuffle" in ckpt:
        shuffle.generator.set_state(ckpt["shuffle"])


def resume(args, state, noise: "Noise") -> Optional[dict]:
    """Restore the latest checkpoint under --resume_dir/ckpt into `state`
    and the noise stream; returns it (None when there is none)."""
    ckpt_dir = os.path.join(args.resume_dir, "ckpt")
    if utils.latest_step(ckpt_dir) is None:
        print(f"no checkpoint under {ckpt_dir}; starting afresh")
        return None
    ckpt = utils.restore_checkpoint(ckpt_dir)
    state.load_state_dict(ckpt["train_state"])
    if ckpt["noise"] is not None:
        if noise.generator is None:
            raise ValueError("the checkpoint holds a noise stream and this "
                             "run's eps_fn has no generator to restore")
        noise.generator.set_state(ckpt["noise"])
    print(f"resumed from {ckpt_dir} at step {state.step}")
    return ckpt


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def default_eps_fn(seed: int, device: torch.device,
                   eval_seed: int = EVAL_SEED,
                   dtype: torch.dtype = torch.float32) -> Callable:
    """eps_fn(kind, shape): "train" draws (and "train/<regime>" ones)
    continue one generator seeded by `seed`; every "eval" draw comes from a
    generator seeded with `eval_seed` (the JAX CLIs use one fixed eval key
    per batch).  Draws in `dtype`."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def eps_fn(kind: str, shape) -> torch.Tensor:
        g = gen if kind.startswith("train") else \
            torch.Generator(device=device).manual_seed(eval_seed)
        return torch.randn(shape, generator=g, device=device, dtype=dtype)

    eps_fn.generator = gen  # the "train" stream, which checkpoints keep
    return eps_fn


class Noise:
    """eps_fn that also keeps its last training draw, and every training
    draw while `draws` is a list (a captured step's).  In a data-parallel
    step (parallel.sharded) it draws the global batch's noise, keeps that,
    and hands back this rank's rows."""

    def __init__(self, eps_fn: Callable):
        self.eps_fn, self.last, self.draws = eps_fn, None, None

    @property
    def generator(self) -> Optional[torch.Generator]:
        """The "train" stream's generator (default_eps_fn's), or None for
        an injected eps_fn without one."""
        return getattr(self.eps_fn, "generator", None)

    def __call__(self, kind: str, shape) -> torch.Tensor:
        eps = self.eps_fn(kind, (parallel.global_rows(shape[0]),
                                 *shape[1:]))
        if kind.startswith("train"):
            self.last = eps
            if self.draws is not None:
                self.draws.append(eps)
        return parallel.local_rows(eps)


class StaticDraws:
    """eps_fn of a captured eval group: the "eval" draws are the same at
    every call (a generator seeded anew, or the JAX driver's one fixed
    key), so each shape's is drawn from `noise` once and kept at a fixed
    address."""

    def __init__(self, noise: Callable):
        self.noise, self.drawn = noise, {}

    def __call__(self, kind: str, shape) -> torch.Tensor:
        key = (kind, tuple(shape))
        if key not in self.drawn:
            self.drawn[key] = self.noise(kind, shape)
        return self.drawn[key]


def make_forward(args, eps_fn: Callable) -> Callable:
    """forward(params, batch, geco, alpha, kind, bias_analysis=False): the
    SVGPVAE training forward pass with this run's options and
    `eps_fn(kind, (b, L))` noise."""
    kappa = float(np.sqrt(args.kappa_squared))

    def forward(params, batch, geco, alpha, kind, bias_analysis=False):
        return models.forward_pass_svgpvae(
            params["vae"], params["gp"], batch,
            eps_fn(kind, (batch[0].shape[0], args.L)), beta=args.beta,
            C_ma=geco.C_ma, lagrange_mult=geco.lagrange_mult, alpha=alpha,
            kappa=kappa, clip_qs=args.clip_qs, geco=args.GECO,
            lagrange_max=args.geco_lambda_max,
            gp_block_impl=args.gp_block_impl, entropy_ce=args.entropy_ce,
            titsias_reference_ce=args.titsias_reference_ce,
            bias_analysis=bias_analysis)

    return forward


def make_loss_fn(args, forward: Callable,
                 mean_vectors: Optional[list] = None) -> Callable:
    """loss_fn(params, batch, geco, step) -> (loss, (geco, metrics)) for
    train.train_step: GECO minimizes the objective, the plain objective
    maximizes the ELBO.  With a `mean_vectors` list (--bias_analysis) the
    step runs the two-pass block and appends its mu_hat (L, m)."""

    def loss_fn(params, batch, geco, step):
        out = forward(params, batch, geco,
                      train.geco_effective_alpha(step, args.alpha), "train",
                      bias_analysis=mean_vectors is not None)
        if mean_vectors is not None:
            mean_vectors.append(out.mean_vectors.detach())
        new_geco = train.GECOState(C_ma=out.C_ma,
                                   lagrange_mult=out.lagrange_mult)
        loss = out.elbo if args.GECO else -out.elbo
        metrics = {"elbo": out.elbo.detach(),
                   "recon": out.recon_loss.detach(), "C_ma": out.C_ma,
                   "lagrange": out.lagrange_mult}
        return loss, (new_geco, metrics)

    return loss_fn


def make_vae_forward(args, eps_fn: Callable, cvae: bool = False,
                     clip_qs: Optional[bool] = None) -> Callable:
    """forward(params, batch, kind): the plain VAE (or CVAE) forward pass
    with `eps_fn(kind, (b, L))` noise and --clip_qs (or `clip_qs`)."""
    clip = args.clip_qs if clip_qs is None else clip_qs

    def forward(params, batch, kind):
        return models.forward_pass_vae(
            params["vae"], batch, eps_fn(kind, (batch[0].shape[0], args.L)),
            clip_qs=clip, cvae=cvae)

    return forward


def make_vae_loss_fn(forward: Callable, kind: str = "train") -> Callable:
    """loss_fn for train.train_step: minus the VAE ELBO; the GECO state
    passes through."""

    def loss_fn(params, batch, geco, step):
        out = forward(params, batch, kind)
        return -out.elbo, (geco, {"elbo": out.elbo.detach(),
                                  "recon": out.recon_loss.detach()})

    return loss_fn


class StepRecorder:
    """Runs training steps and keeps, per step, the host seconds after
    synchronize, the metrics as floats and the kernel launches; at
    `capture_step` (a count of steps from the run's start) a copy of what
    the step starts from and of its noise, loss and gradients.  In a
    data-parallel run a full batch (`batch_size` rows) is sharded: the
    step takes this rank's rows (parallel.sharded); the tail batch runs
    replicated.  A capture keeps the global batch and draws, and the
    gradients summed across ranks: the 1-process step's."""

    def __init__(self, device: torch.device, noise: Optional[Noise],
                 capture_step: Optional[int],
                 batch_size: Optional[int] = None):
        self.device, self.noise, self.capture_step = device, noise, \
            capture_step
        self.batch_size = batch_size
        self.seconds, self.metrics, self.launches = [], [], []
        self.captured, self.chunks = None, []

    def step(self, state, batch, loss_fn, trainable: Dict[str, torch.Tensor],
             index: int, **extra) -> dict:
        snap = (_snapshot(state, batch, index, **extra)
                if index == self.capture_step else None)
        if snap is not None and self.noise is not None:
            self.noise.draws = []
        before = ops.launch_counts()
        t0 = time.perf_counter()
        with utils.annotate("train_step"), \
                parallel.sharded(len(batch[0]) == self.batch_size):
            m = train.train_step(
                state, tuple(parallel.local_rows(t) for t in batch), loss_fn)
            sync(self.device)
        self.seconds.append(time.perf_counter() - t0)
        after = ops.launch_counts()
        self.launches.append({k: after[k] - before[k] for k in after})
        if snap is not None:
            self.captured = _finish_capture(snap, state, trainable, m,
                                            self.noise)
        m = {k: float(v) for k, v in m.items()}
        self.metrics.append(m)
        return m

    def chunk(self, multi_fn: Callable, state, tensors, n_epochs: int,
              timed: bool = True, **kw) -> list:
        """n_epochs epochs through multi_fn (train.make_multi_epoch_fn,
        `kw` passed on), their metrics read back at once; per epoch, the
        list of its steps' metrics.  Each step's seconds are the chunk's
        over its steps; `chunks` keeps each chunk's seconds (after
        synchronize) and whether it is `timed`: the first chunk, and in the
        default loop the first epoch after a regime switch (the compiles
        in JAX, here warm-ups and captures), are left out of the p50."""
        t0 = time.perf_counter()
        metrics, launches = multi_fn(state, tensors, n_epochs, **kw)
        keys = list(metrics)
        host = torch.stack([metrics[k] for k in keys]).cpu().tolist()
        seconds = time.perf_counter() - t0
        self.chunks.append({"epochs": n_epochs, "steps": len(launches),
                            "seconds": seconds,
                            "timed": timed and bool(self.chunks)})
        self.seconds.extend([seconds / len(launches)] * len(launches))
        self.launches.extend(launches)
        epochs = [[dict(zip(keys, vals)) for vals in zip(
            *(host[i][e] for i in range(len(keys))))]
            for e in range(n_epochs)]
        for steps in epochs:
            self.metrics.extend(steps)
        return epochs

    def summary(self, elapsed: float) -> None:
        if self.chunks:
            first = self.chunks[0]
            per_step = [c["seconds"] / c["steps"] for c in self.chunks
                        if c["timed"]]
            print(f"total: {len(self.seconds)} steps in {len(self.chunks)} "
                  f"chunks, {elapsed:.1f}s; the first chunk "
                  f"{first['seconds']:.2f} s ({first['steps']} steps), "
                  + (f"then per step (chunk seconds / steps, the chunks "
                     f"after a regime switch left out) p50 "
                     f"{1e3 * float(np.percentile(per_step, 50)):.3f} ms"
                     if per_step else "no timed chunk"))
        elif self.seconds:
            timed = self.seconds[1:] or self.seconds
            print(f"total: {len(self.seconds)} steps, {elapsed:.1f}s; step "
                  f"time first {1e3 * self.seconds[0]:.2f} ms, p50 "
                  f"{1e3 * float(np.percentile(timed, 50)):.2f} ms, p90 "
                  f"{1e3 * float(np.percentile(timed, 90)):.2f} ms")

    def result(self) -> dict:
        return {"step_seconds": self.seconds, "metrics": self.metrics,
                "step_launches": self.launches, "captured": self.captured,
                "chunks": self.chunks}


class EpochTracer:
    """--profile_dir: `epoch(timed)` is a utils.trace_if context that
    traces the first epoch it is given with timed=True (the JAX drivers'
    first timed epoch) and no other, in a data-parallel run on rank 0
    alone, which writes the run's files; `report()` says where the trace
    went, or warns when no epoch was traced."""

    def __init__(self, profile_dir: Optional[str]):
        self.dir, self.traced = profile_dir, False

    def epoch(self, timed: bool):
        chosen = bool(self.dir) and timed and not self.traced
        self.traced = self.traced or chosen
        return utils.trace_if(self.dir,
                              enabled=chosen and parallel.is_writer())

    def report(self) -> None:
        if not self.dir:
            return
        if self.traced:
            print(f"profiler trace written to {self.dir}")
        else:
            print("warning: --profile_dir set but no epoch was traced "
                  "(needs >= 2 epochs of one regime)")


def _best(result: dict, evals: list, key: str = "cgen_mse") -> dict:
    """Adds "cgen_mse" (the last eval's) and "best_cgen_mse" (the best
    over the evals that have one) to `result`, and prints the best."""
    scored = [e for e in evals if e.get(key) is not None]
    result["cgen_mse"] = evals[-1].get(key) if evals else None
    if scored:
        best = min(scored, key=lambda e: e[key])
        print(f"best cgen MSE {best[key]:.5f} at epoch {best['epoch']}")
        result["best_cgen_mse"] = best[key]
    return result


def _save_cgen_images(run_dir: Optional[str], images) -> None:
    if run_dir and images is not None:
        with open(os.path.join(run_dir, "cgen_images.p"), "wb") as f:
            pickle.dump(host_array(images), f)


def main(argv=None, splits: Optional[dict] = None,
         eps_fn: Optional[Callable] = None,
         capture_step: Optional[int] = None,
         perm_fn: Optional[Callable] = None,
         on_eval: Optional[Callable[[dict], None]] = None,
         per_step: bool = False, eager_evals: bool = False) -> dict:
    """Train; returns a dict (see `run_svgpvae`, `run_svigp`,
    `run_casale`).

    `splits` ({"train", "eval", "test", "pca_ov_init"}, as
    data.generate_rotated_mnist returns) skips loading the dataset.
    `eps_fn(kind, shape)` ("train", "train/<regime>" for Casale, or
    "eval") replaces the default noise (tests inject the JAX draws).
    `capture_step` keeps a copy of that step's inputs, parameters before
    it, noise and gradients.  `perm_fn(n)` gives --reshuffle's
    permutations of n examples in place of the seeded generator's.
    `on_eval(ev)` is called after each eval pass of `run_svgpvae` (and its
    checkpoint) with its record (in a data-parallel run on rank 0).
    `per_step` runs the default loop (--epoch_chunk 1) one step at a time
    where it would replay captured CUDA graphs, and the eval passes
    eagerly (the card's eager yardstick).  `eager_evals` runs each
    captured eval pass (the unbundled passes, Casale's cgen) eagerly too,
    right after its replay, into the eval record's "eager" (the card's
    yardstick of the eval graphs)."""
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device")
    ranks = parallel.resolve_data_parallel(args.data_parallel,
                                           args.batch_size, args.device)
    if ranks and args.bias_analysis:
        raise SystemExit("--data_parallel does not support "
                         "--bias_analysis (per-step host loop)")
    if parallel.needs_launch(ranks):
        kw = {k: v for k, v in dict(
            splits=splits, eps_fn=eps_fn, capture_step=capture_step,
            perm_fn=perm_fn, per_step=per_step or None,
            eager_evals=eager_evals or None).items()
            if v is not None}
        # on_eval runs on rank 0 alone, which returns the run's result
        return parallel.launch(
            "svgpvae_tpu_torch.cli.mnist", argv, kw, ranks, args.device,
            rank0_kwargs=dict(kw, on_eval=on_eval))
    with parallel.active(ranks):
        return _main(args, parallel.device(args.device), splits, eps_fn,
                     capture_step, perm_fn, on_eval, per_step, eager_evals)


def _main(args, device, splits, eps_fn, capture_step, perm_fn, on_eval,
          per_step=False, eager_evals=False):
    parallel.announce(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN (the GP math needs IEEE fp32)")
    if splits is None:
        splits = load_splits(args)
    elif args.N_t is not None:
        raise SystemExit("--N_t subsamples pickled data; pass the "
                         "subsampled splits instead")
    eps_fn = eps_fn or default_eps_fn(args.seed, device,
                                      dtype=run_dtype(args))
    if args.x64:
        if args.bf16:
            print("warning: --x64 overrides --bf16 (float64 mode)")
        print("--x64: data, nets, GP and Adam in float64; the GP blocks run "
              "the kernels' plain PyTorch versions (the CUDA kernels take "
              "fp32 only), so no kernel launches")
    elif args.bf16:
        print("--bf16: the nets compute in bfloat16; their parameters, Adam "
              "and the GP math (and every kernel) stay fp32")
    shuffle = None
    if args.reshuffle:
        shuffle = train.EpochShuffle(
            len(splits["train"]["images"]), args.batch_size, seed=args.seed,
            perm_fn=perm_fn)
    if args.elbo in CASALE_ELBOS:
        return run_casale(args, splits, device, eps_fn, capture_step,
                          per_step, eager_evals)
    if args.elbo == "SVIGP_Hensman":
        return run_svigp(args, splits, device, capture_step, shuffle,
                         per_step)
    return run_svgpvae(args, splits, device, eps_fn, capture_step, shuffle,
                       on_eval, per_step, eager_evals)


def _to_dev(split: dict, device: torch.device,
            dtype: torch.dtype = torch.float32):
    return (torch.as_tensor(split["images"], dtype=dtype, device=device),
            torch.as_tensor(split["aux_data"], dtype=dtype, device=device))


def run_svgpvae(args, splits: dict, device: torch.device, eps_fn: Callable,
                capture_step: Optional[int],
                shuffle: Optional[train.EpochShuffle] = None,
                on_eval: Optional[Callable[[dict], None]] = None,
                per_step: bool = False, eager_evals: bool = False) -> dict:
    """SVGPVAE_Hensman, SVGPVAE_Titsias, VAE and CVAE.  Returns {"state",
    "step_seconds" (host clock after synchronize, per step; under
    --epoch_chunk its chunk's seconds over its steps), "chunks" (each
    chunk's epochs, steps and seconds), "metrics" (per step), "evals"
    (per eval pass), "eval_losses" (per eval pass, each pass's per-batch
    losses), "test_recon" and "cgen_images" (the last eval pass's, or
    None), "step_launches" (kernel launches inside each step),
    "graph_replays" and "graph_launches" (each captured CUDA graph's
    replays and the kernel launches of one, see graph_record),
    "eval_graph_replays" and "eval_graph_launches" (the unbundled eval
    passes' graphs: "eval", "test", "VAE/eval", "VAE/test", "cgen"; see
    pass_record), "captured",
    "cgen_mse", "best_cgen_mse", "regimes" (per epoch), "bias"
    (--bias_analysis: per epoch its bias, the epoch's mean of the batch
    estimates, the full-split mean vectors and the pass's kernel
    launches)}."""
    is_svgpvae = "SVGPVAE" in args.elbo
    is_cvae = args.elbo == "CVAE"
    dtype = run_dtype(args)
    if is_svgpvae:
        # --x64: 'auto' resolves as on the CPU (the kernels take fp32 only)
        args.gp_block_impl = models.resolve_gp_block_impl(
            args.gp_block_impl, workload="mnist",
            titsias=args.elbo == "SVGPVAE_Titsias",
            device=torch.device("cpu") if args.x64 else device)
        print(f"gp_block_impl: {args.gp_block_impl}, device {device}, "
              f"dtype {dtype}")
    train_d, eval_d, test_d = splits["train"], splits["eval"], splits["test"]
    # as the JAX driver: N_train stays n_digits * 4050 under --N_t
    N_train = (len(train_d["images"]) if args.N_t is None
               else len(args.dataset) * 4050)
    N_eval, N_test = len(eval_d["images"]), len(test_d["images"])

    run_dir = open_run_dir(args)
    vae, gp = build_model(args, splits, N_train, device)
    params = {"vae": vae} if gp is None else {"vae": vae, "gp": gp}
    trainable = train.trainable_tensors(params, trainable_predicate(args))
    print(f"parameters: {utils.count_params(params)}, trainable: "
          f"{sum(t.numel() for t in trainable.values())}")
    if is_svgpvae:
        nr_epochs, regime = train.parse_opt_regime(list(args.opt_regime))
    else:
        nr_epochs, regime = args.nr_epochs, ["VAE"] * args.nr_epochs
    # the lr-decay horizon counts N_train steps, as the JAX driver does
    steps_per_epoch = -(-N_train // args.batch_size)
    state = train.TrainState(
        params=params, optimizer=train.make_optimizer(trainable, args.lr),
        geco=train.GECOState.init(dtype=dtype, device=device),
        lr_fn=train.cosine_decay_lr(args.lr, args.lr_decay,
                                    nr_epochs * steps_per_epoch))
    noise = Noise(eps_fn)
    if args.resume_dir:
        restore_shuffle(resume(args, state, noise), shuffle)

    def ckpt_state():
        return checkpoint_state(state, noise, **shuffle_state(shuffle))

    forward = make_forward(args, noise) if is_svgpvae else None
    vae_forward = make_vae_forward(args, noise, cvae=is_cvae)
    loss_fns = {"VAE": make_vae_loss_fn(vae_forward)}
    batch_mean_vectors = [] if args.bias_analysis and is_svgpvae else None
    if is_svgpvae:
        loss_fns["joint"] = make_loss_fn(args, forward)
        loss_fns["bias"] = make_loss_fn(args, forward, batch_mean_vectors)
    savers = {}
    if args.save and run_dir:
        res = os.path.join(run_dir, "res")
        if is_svgpvae:
            savers["elbo"] = utils.ResultSaver(
                os.path.join(res, "ELBO_results.csv"), ELBO_COLUMNS,
                flush_every=1)
            savers["gp"] = utils.ResultSaver(
                os.path.join(res, "GP_params.csv"), GP_COLUMNS, flush_every=1)
            if "VAE" in regime:
                savers["elbo_vae"] = utils.ResultSaver(
                    os.path.join(res, "ELBO_VAE_results.csv"), VAE_COLUMNS,
                    flush_every=1)
        else:
            savers["elbo_vae"] = utils.ResultSaver(
                os.path.join(res, "ELBO_results.csv"), VAE_COLUMNS,
                flush_every=1)

    train_im, train_aux = _to_dev(train_d, device, dtype)
    eval_im, eval_aux = _to_dev(eval_d, device, dtype)
    test_im, test_aux = _to_dev(test_d, device, dtype)

    @torch.no_grad()
    def recon_pass(images, aux, vae_pass, eps, geco, keep: bool = False):
        """JAX's recon_stack_fn with its tail call: the eval-mode forward
        of the split's batches, tail included (the VAE's, or the
        SVGPVAE's at `geco`), with the "eval" draws of `eps`: (the
        per-batch recon losses, with `keep` the split's recon images,
        else None), on the device."""
        fwd = (make_vae_forward(args, eps, cvae=is_cvae) if vae_pass
               else make_forward(args, eps))
        outs = [fwd(params, batch, "eval") if vae_pass else
                fwd(params, batch, geco, args.alpha, "eval")
                for batch in train.epoch_batches((images, aux),
                                                 args.batch_size)]
        return (torch.stack([o.recon_loss for o in outs]),
                torch.cat([o.recon_images for o in outs]) if keep else None)

    @torch.no_grad()
    def encode_train():
        enc = [models.batching_encode_svgpvae(vae, im, clip_qs=args.clip_qs)
               for im, _ in train.epoch_batches((train_im, train_aux),
                                                args.batch_size)]
        return (torch.cat([e[0] for e in enc]),
                torch.cat([e[1] for e in enc]))

    @torch.no_grad()
    def cgen_pass(eps, geco=None):
        """JAX's encode_stack_fn then cgen_stack_fn, tails included: the
        full-train encode, then the SVGPVAE cgen of each test batch with
        `eps`'s "eval" draws: (the per-batch losses, the cgen images), on
        the device."""
        means, variances = encode_train()
        outs = [models.predict_cgen_mnist(
            vae, gp, batch, means, variances, train_aux,
            eps("eval", (batch[0].shape[0], args.L)))
            for batch in train.epoch_batches((test_im, test_aux),
                                             args.batch_size)]
        return (torch.stack([loss for _, loss in outs]),
                torch.cat([recon for recon, _ in outs]))

    @torch.no_grad()
    def eval_group(eps, geco):
        """--eval_bundle: the SVGPVAE eval group (eval recon, test recon,
        the full-train encode, the cgen; tails included) without a host
        sync, as the unbundled passes compute it with the "eval" draws of
        `eps`: (the per-batch losses of the three passes then their three
        sums, the test recon images, the cgen images), on the device."""
        (ev, _), (te, recon) = (recon_pass(*split, False, eps, geco, keep)
                                for split, keep in (
                                    ((eval_im, eval_aux), False),
                                    ((test_im, test_aux), True)))
        cg, images = cgen_pass(eps)
        losses = [ev, te, cg]
        return (torch.cat(losses + [torch.stack([x.sum() for x in losses])]),
                recon, images)

    # The unbundled eval passes, as JAX's recon_stack_fn (the eval and
    # test splits, the VAE's or the SVGPVAE's forward), encode_stack_fn ->
    # cgen_stack_fn (the SVGPVAE cgen) and their tail calls: on a CUDA
    # device each (split, pass kind) and the cgen replays a captured CUDA
    # graph (capture.CapturedCall), read back once; their "eval" draws are
    # static (StaticDraws: each shape drawn once, as the eval draws are the
    # same at every call) and their forward reads a static GECO pair,
    # copied in before each replay.  --eval_bundle's group is one more
    # such call ("bundle").  Elsewhere (pass_why) they run eagerly with the
    # run's noise and GECO state.  With `eager_evals` each captured pass
    # also runs eagerly right after its replay, at the same state, into
    # the eval record's "eager" (the card's yardstick).
    pass_why = eval_pass_reason(device, per_step)
    pass_geco = train.GECOState(state.geco.C_ma.clone(),
                                state.geco.lagrange_mult.clone())
    pass_eps = StaticDraws(noise)
    pass_calls: Dict[str, capture.CapturedCall] = {}
    pass_splits = {"eval": (eval_im, eval_aux), "test": (test_im, test_aux)}
    print("eval passes: " + (f"uncaptured ({pass_why})" if pass_why else
                             "each (the eval and test recon, the encode -> "
                             "cgen) replays a captured CUDA graph, read back "
                             "once"))

    def run_pass(name, fn, twin: Optional[dict] = None):
        """fn(eps, geco): the eval pass `name`, its graph replayed (or
        eagerly, pass_why); with `twin` also eagerly, into twin[name] =
        (its outputs, seconds, its outputs on the cusolver backend: the
        one arithmetic the graph changes, capture.cusolver_linalg; the
        seconds of both, which the pass's own seconds leave out)."""
        if pass_why:
            return fn(noise, state.geco)
        pass_geco.C_ma.copy_(state.geco.C_ma)
        pass_geco.lagrange_mult.copy_(state.geco.lagrange_mult)
        if name not in pass_calls:
            pass_calls[name] = capture.CapturedCall(
                lambda: fn(pass_eps, pass_geco))
        out = pass_calls[name]()
        if twin is not None:
            sync(device)  # the replay's end: its own seconds
            t0 = time.perf_counter()
            eager = fn(noise, state.geco)
            sync(device)
            seconds = time.perf_counter() - t0
            with capture.cusolver_linalg():
                cusolver = fn(noise, state.geco)
            sync(device)
            twin[name] = (eager, seconds, cusolver,
                          time.perf_counter() - t0)
        return out

    def eager_record(twin: dict) -> dict:
        """{pass: {"losses", "sum", "images", "seconds", "cusolver":
        {"losses", "sum", "images"}, "twin_seconds"}} of the eager twins
        of one eval's captured passes (see run_pass)."""
        def record(out):
            losses = out[0].tolist()
            return {"losses": losses, "sum": sum(losses), "images": out[1]}
        return {name: dict(record(eager), seconds=seconds,
                           cusolver=record(cusolver), twin_seconds=both)
                for name, (eager, seconds, cusolver, both)
                in twin.items()}

    def recon_sum(split, vae_pass, keep: bool = False, twin=None):
        """The JAX driver's "MSE" of the split "eval" or "test": the
        summed recon_loss over it (under GECO the constraint
        sum_b(mse_b - kappa^2)), the per-batch losses, and with `keep` a
        copy of its recon images (else None); one readback."""
        name = ("VAE/" if vae_pass else "") + split
        losses, recon = run_pass(name, lambda eps, geco: recon_pass(
            *pass_splits[split], vae_pass, eps, geco, keep), twin)
        losses = losses.tolist()
        return sum(losses), None if recon is None else recon.clone(), losses

    def cgen(twin=None):
        """(the cgen MSE, its images, its per-batch losses) or (None,
        None, None) for the VAE; the SVGPVAE's one readback."""
        if is_cvae:
            with torch.no_grad():
                images, loss = models.predict_cvae(
                    vae, train_im, train_aux, test_im, test_aux,
                    noise("eval", (N_train, args.L)),
                    n_objects=len(splits["pca_ov_init"]))
            return float(loss), images, [float(loss)]
        if not is_svgpvae:
            return None, None, None
        losses, images = run_pass("cgen", cgen_pass, twin)
        losses = losses.tolist()
        return sum(losses) / N_test, images.clone(), losses

    bundled = args.eval_bundle and is_svgpvae
    if args.eval_bundle and not is_svgpvae:
        print(f"--eval_bundle: no effect with --elbo {args.elbo} (the JAX "
              "driver bundles the SVGPVAE eval group only)")
    elif bundled:
        print("--eval_bundle: the eval group (eval and test recon, the "
              "full-train encode, the cgen) with one readback per eval; "
              + ("it replays one captured CUDA graph" if pass_why is None
                 else f"uncaptured ({pass_why})"))

    def bundled_eval(epoch):
        """The eval record, the per-batch losses, the test recon and cgen
        images of one eval group (see eval_group), read back once."""
        vals, recon, images = run_pass("bundle", eval_group)
        vals = vals.cpu().tolist()
        n_ev = -(-N_eval // args.batch_size)
        n_te = -(-N_test // args.batch_size)
        sums = vals[-3:]
        return ({"epoch": epoch, "eval_mse": sums[0] / N_eval,
                 "test_mse": sums[1] / N_test, "cgen_mse": sums[2] / N_test},
                {"eval": vals[:n_ev], "test": vals[n_ev:n_ev + n_te],
                 "cgen": vals[n_ev + n_te:-3]}, recon.clone(), images.clone())

    @torch.no_grad()
    def bias_pass(epoch):
        """The full-split q(u) mean and the epoch's bias (JAX:
        mean_vector_bias_analysis on every train encoding)."""
        before = ops.launch_counts()
        mu, var = encode_train()
        full = gpm.posterior_params(gp, train_aux, train_aux, mu, var)[2]
        avg = torch.stack(batch_mean_vectors).mean(0)
        bias = float(torch.mean(torch.abs(avg - full)))
        sync(device)
        after = ops.launch_counts()
        print(f"bias for epoch {epoch}: {bias:.6f}")
        return {"epoch": epoch, "bias": bias, "batch_mean_vectors": avg,
                "full_mean_vectors": full,
                "launches": {k: after[k] - before[k] for k in after}}

    parallel.check_replicated(list(train.named_tensors(params).values()))
    rec = StepRecorder(device, noise, capture_step, args.batch_size)
    tracer = EpochTracer(args.profile_dir)
    chunk = resolve_epoch_chunk(args, nr_epochs, svgpvae=is_svgpvae,
                                regime=regime,
                                bias_analysis=args.bias_analysis)
    # the graphs step the SVGPVAE loss, and the VAE loss of the VAE epochs
    # (an SVGPVAE run's VAE phases: the kind "VAE"), over one TrainState
    graph_losses = ({None: loss_fns["joint"], "VAE": loss_fns["VAE"]}
                    if is_svgpvae else loss_fns["VAE"])
    chunks = make_epoch_chunks(
        chunk, device, rec, graph_losses, args.batch_size,
        (train_im, train_aux), shuffle, noise.generator,
        per_step_why=per_step_reason(args, device, per_step, capture_step,
                                     noise.generator))
    evals, biases, pictures, eval_losses = [], [], [], []
    cgen_images = test_recon = None
    t_start = time.perf_counter()
    for epoch in range(nr_epochs):
        use_vae_pass = regime[epoch] == "VAE"
        # --bias_analysis: JAX's per-step loop, in stored order
        bias_epoch = batch_mean_vectors is not None and not use_vae_pass
        loss_fn = loss_fns["VAE" if use_vae_pass else
                           "bias" if bias_epoch else "joint"]
        t_epoch = time.perf_counter()
        timed = epoch > 0 and regime[epoch] == regime[epoch - 1]
        if chunks is not None:
            with tracer.epoch(timed and chunks.chunk == 1):
                steps, steps_done = chunks.epoch(
                    state, epoch, "VAE" if is_svgpvae and use_vae_pass
                    else None, timed)
            elbos = [m["elbo"] for m in steps]
            losses = [m["recon"] for m in steps]
        else:
            elbos, losses = [], []
            order = (shuffle.order() if shuffle is not None
                     and not bias_epoch else None)
            with tracer.epoch(timed):
                for batch in train.epoch_batches((train_im, train_aux),
                                                 args.batch_size, order):
                    m = rec.step(state, batch, loss_fn, trainable,
                                 state.step, regime=regime[epoch])
                    elbos.append(m["elbo"])
                    losses.append(m["recon"])
            steps_done = state.step
        utils.check_finite(elbos, steps_done, ckpt_state, run_dir)
        if bias_epoch:
            biases.append(bias_pass(epoch))
            batch_mean_vectors.clear()

        if (epoch + 1) % args.eval_every == 0:
            print(f"epoch {epoch}, regime {regime[epoch]}, mean ELBO/batch "
                  f"{np.mean(elbos):.3f}, train MSE "
                  f"{np.sum(losses) / N_train:.5f}, epoch time "
                  f"{time.perf_counter() - t_epoch:.2f}s")
            t0 = time.perf_counter()
            if bundled and not use_vae_pass:
                ev, batch_losses, test_recon, images = bundled_eval(epoch)
                ev["seconds"] = {"eval_group": time.perf_counter() - t0}
            else:
                twin = {} if eager_evals and not pass_why else None
                with utils.annotate("eval_pass"):
                    eval_sum, _, ev_l = recon_sum("eval", use_vae_pass,
                                                  twin=twin)
                    test_sum, test_recon, te_l = recon_sum(
                        "test", use_vae_pass, keep=bool(run_dir), twin=twin)
                    ev = {"epoch": epoch, "eval_mse": eval_sum / N_eval,
                          "test_mse": test_sum / N_test}
                    sync(device)
                    t1 = time.perf_counter()
                    ev["cgen_mse"], images, cg_l = cgen(twin)
                    sync(device)
                batch_losses = {"eval": ev_l, "test": te_l, "cgen": cg_l}
                ev["seconds"] = {"eval_test": t1 - t0,
                                 "cgen": time.perf_counter() - t1}
                if twin is not None:
                    ev["eager"] = eager_record(twin)
                    # the captured passes' seconds, without their twins'
                    for k, twin_pass in ev["eager"].items():
                        ev["seconds"]["cgen" if k == "cgen" else
                                      "eval_test"] -= twin_pass[
                                          "twin_seconds"]
            cgen_images = images if images is not None else cgen_images
            evals.append(ev)
            eval_losses.append(batch_losses)
            print(f"  eval MSE: {ev['eval_mse']:.5f}")
            print(f"  test MSE: {ev['test_mse']:.5f}")
            draw(pictures, run_dir, f"{state.step}", "recon",
                 plots.plot_image_grid, test_d["images"], test_recon,
                 f"epoch {epoch + 1}. recon MSE test {ev['test_mse']:.4f}")
            if ev["cgen_mse"] is not None:
                print(f"  cgen test MSE: {ev['cgen_mse']:.5f}")
                draw(pictures, run_dir, f"{state.step}_cgen", "cgen",
                     plots.plot_image_grid, test_d["images"], images,
                     f"epoch {epoch + 1}. CGEN MSE {ev['cgen_mse']:.4f}")
                if run_dir:
                    with open(os.path.join(run_dir, "pics",
                                           "test_metrics.txt"), "a") as f:
                        f.write(f"{epoch + 1},{round(ev['test_mse'], 4)},"
                                f"{round(ev['cgen_mse'], 4)}\n")
            # one batch of the eval split, or of the test split
            # (--test_set_metrics; reference MNIST_experiment.py:395-400)
            m_im, m_aux = ((test_im, test_aux) if args.test_set_metrics
                           else (eval_im, eval_aux))
            metrics_batch = (m_im[:args.batch_size], m_aux[:args.batch_size])
            if savers and use_vae_pass:
                write_vae_row(savers["elbo_vae"], state.step, vae_forward,
                              params, metrics_batch)
            elif savers:
                write_eval_rows(args, savers, run_dir, state, forward,
                                metrics_batch)
                draw(pictures, run_dir, f"{state.step}_kernels", "kernels",
                     plots.plot_kernel_matrices, *kernel_matrices(
                         gp, train_aux[:args.batch_size],
                         args.object_kernel_normalize))
            if run_dir and args.save_model_weights:
                utils.save_checkpoint(os.path.join(run_dir, "ckpt"),
                                      ckpt_state(), state.step)
            if on_eval is not None:
                on_eval(ev)

    rec.summary(time.perf_counter() - t_start)
    tracer.report()
    bundle_call = pass_calls.pop("bundle", None)
    result = dict(rec.result(), state=state, evals=evals, run_dir=run_dir,
                  noise=noise, regimes=regime, bias=biases, shuffle=shuffle,
                  pictures=pictures, test_recon=test_recon,
                  cgen_images=cgen_images, eval_losses=eval_losses,
                  **graph_record(chunks, ("eval", bundle_call)),
                  **pass_record(pass_calls))
    _best(result, evals)
    _save_cgen_images(run_dir, cgen_images)
    if run_dir and args.save_latents:
        with torch.no_grad():
            mu, var = encode_train()
            if gp is None:
                p_m, p_v = mu, var
            else:
                p_m, p_v, _, _ = gpm.posterior_params(gp, train_aux,
                                                      train_aux, mu, var)
        p_m, p_v = p_m.cpu().numpy(), p_v.cpu().numpy()
        z = p_m + np.sqrt(np.maximum(p_v, 0)) * \
            np.random.RandomState(0).randn(*p_m.shape)
        with open(os.path.join(run_dir, "latents_train.p"), "wb") as f:
            pickle.dump(z, f)
    return result


# --- deep SVIGP --------------------------------------------------------------


def with_global_index(split: dict) -> dict:
    """The split with a running row index prepended to its aux data."""
    aux = split["aux_data"]
    return dict(split, aux_data=np.c_[np.arange(len(aux), dtype=aux.dtype),
                                      aux])


def build_svigp(args, splits: dict, N_train: int, device: torch.device):
    """{"dec": SVIGPDecoder, "gp": SVIGP} on `device`, initialised as the
    JAX driver's run_svigp does (zero locs, identity scales, noise 0.1;
    the KDE inducing points drawn from the global-indexed train aux, whose
    columns 2: are the angle and the first M - 1 PCA columns), or from
    --params."""
    dec = SVIGPDecoder(L=args.L,
                       generator=torch.Generator().manual_seed(args.seed))
    ip_init = data.generate_init_inducing_points(
        with_global_index(splits["train"]), n=args.nr_inducing_points,
        use_pca=args.PCA, M=args.M, seed=args.seed)
    opts = dict(jitter=args.jitter, N_train=N_train,
                K_obj_normalize=args.object_kernel_normalize)
    gp = gpm.init_svigp(ip_init, object_vectors_init(args, splits), L=args.L,
                        **opts)
    if args.params:
        port = _load_params(args.params, svigp_params_from_jax)
        dec.load_state_dict(port["dec"])
        if ("object_vectors" in port["gp"]) != args.ov_joint:
            raise ValueError("--params and --ov_joint disagree on the GPLVM "
                             "object-vector table")
        gp = gpm.SVIGP(**port["gp"], **opts)
    return {"dec": dec.to(device), "gp": gp.to(device)}


def make_svigp_loss_fn() -> Callable:
    """loss_fn for train.train_step: minus the deep SVIGP's ELBO (no
    draws)."""

    def loss_fn(params, batch, geco, step):
        out = models.forward_pass_deep_svigp(params["dec"], params["gp"],
                                             batch)
        return -out.elbo, (geco, {"elbo": out.elbo.detach(),
                                  "recon": out.recon_loss.detach()})

    return loss_fn


def run_svigp(args, splits: dict, device: torch.device,
              capture_step: Optional[int],
              shuffle: Optional[train.EpochShuffle] = None,
              per_step: bool = False) -> dict:
    """SVIGP_Hensman: --nr_epochs epochs (every full batch and the tail,
    the full batches reshuffled under --reshuffle), the cgen MSE of the
    test split every --eval_every epochs.  Returns
    {"state", "step_seconds", "chunks", "metrics", "step_launches",
    "graph_replays", "graph_launches", "captured", "evals", "cgen_mse",
    "best_cgen_mse"}."""
    train_d = with_global_index(splits["train"])
    test_d = with_global_index(splits["test"])
    N_train, N_test = len(train_d["images"]), len(test_d["images"])
    run_dir = open_run_dir(args)
    params = build_svigp(args, splits, N_train, device)
    trainable = train.trainable_tensors(params, trainable_predicate(args))
    print(f"parameters: {utils.count_params(params)}, trainable: "
          f"{sum(t.numel() for t in trainable.values())}")
    state = train.TrainState(
        params=params, optimizer=train.make_optimizer(trainable, args.lr),
        geco=train.GECOState.init(device=device),
        lr_fn=train.cosine_decay_lr(
            args.lr, args.lr_decay,
            args.nr_epochs * -(-N_train // args.batch_size)))
    loss_fn = make_svigp_loss_fn()
    train_im, train_aux = _to_dev(train_d, device)
    test_im, test_aux = _to_dev(test_d, device)

    def ckpt_state():
        return {"train_state": state.state_dict(), **shuffle_state(shuffle)}

    parallel.check_replicated(list(train.named_tensors(params).values()))
    rec = StepRecorder(device, None, capture_step, args.batch_size)
    tracer = EpochTracer(args.profile_dir)
    chunk = resolve_epoch_chunk(args, args.nr_epochs)
    chunks = make_epoch_chunks(
        chunk, device, rec, loss_fn, args.batch_size, (train_im, train_aux),
        shuffle, None, draws=False,
        per_step_why=per_step_reason(args, device, per_step, capture_step,
                                     None, draws=False))
    evals, cgen_images, pictures = [], None, []
    t_start = time.perf_counter()
    for epoch in range(args.nr_epochs):
        if chunks is not None:
            with tracer.epoch(epoch > 0 and chunks.chunk == 1):
                steps, steps_done = chunks.epoch(state, epoch)
            elbos = [m["elbo"] for m in steps]
            losses = [m["recon"] for m in steps]
        else:
            elbos, losses = [], []
            order = shuffle.order() if shuffle is not None else None
            with tracer.epoch(epoch > 0):
                for batch in train.epoch_batches((train_im, train_aux),
                                                 args.batch_size, order):
                    m = rec.step(state, batch, loss_fn, trainable,
                                 state.step)
                    elbos.append(m["elbo"])
                    losses.append(m["recon"])
            steps_done = state.step
        utils.check_finite(elbos, steps_done, ckpt_state, run_dir)
        if (epoch + 1) % args.eval_every == 0:
            print(f"epoch {epoch}: mean ELBO/batch {np.mean(elbos):.3f}, "
                  f"train MSE {np.sum(losses) / N_train:.5f}, noise "
                  f"{params['gp'].noise.item():.4f}")
            t0 = time.perf_counter()
            total, images = 0.0, []
            for batch in train.epoch_batches((test_im, test_aux),
                                             args.batch_size):
                recon, loss = models.predict_deep_svigp(
                    params["dec"], params["gp"], batch)
                total += float(loss)
                images.append(recon)
            cgen_images = torch.cat(images)
            sync(device)
            evals.append({"epoch": epoch, "cgen_mse": total / N_test,
                          "seconds": {"cgen": time.perf_counter() - t0}})
            print(f"  cgen test MSE: {total / N_test:.5f}")
            draw(pictures, run_dir, f"{state.step}_cgen", "cgen",
                 plots.plot_image_grid, test_d["images"], cgen_images,
                 f"epoch {epoch + 1}. CGEN MSE {total / N_test:.4f}")
            if run_dir and args.save_model_weights:
                utils.save_checkpoint(os.path.join(run_dir, "ckpt"),
                                      ckpt_state(), state.step)
    rec.summary(time.perf_counter() - t_start)
    tracer.report()
    result = dict(rec.result(), state=state, evals=evals, run_dir=run_dir,
                  pictures=pictures, **graph_record(chunks))
    _save_cgen_images(run_dir, cgen_images)
    return _best(result, evals)


# --- Casale GPVAE ------------------------------------------------------------


def sort_train_data(train_d: dict) -> dict:
    """The Casale layout: rows sorted by (id, angle), the global row index
    prepended to the aux data ([global index, id, angle, pca...])."""
    aux = train_d["aux_data"]
    order = np.lexsort((aux[:, 1], aux[:, 0]))
    gidx = np.arange(len(aux), dtype=aux.dtype)[:, None]
    return {"images": train_d["images"][order],
            "aux_data": np.hstack([gidx, aux[order]])}


def train_angles_mask(aux_sorted: np.ndarray) -> np.ndarray:
    """Boolean mask over the (sorted unique id) x (sorted unique angle)
    grid: which pairs the train set holds (aux columns [global index, id,
    angle, ...])."""
    ids = np.unique(aux_sorted[:, 1])
    angles = np.unique(aux_sorted[:, 2])
    present = set(zip(aux_sorted[:, 1], aux_sorted[:, 2]))
    return np.array([(i, a) in present for i in ids for a in angles])


def casale_constants(train_sorted: dict, device: torch.device) -> dict:
    """What every Casale step reads besides the batch: the whole sorted
    train split's images (the full-train encode), its sorted unique
    angles and object ids, and the rows of the (object, angle) grid that
    it holds (v_matrix's gather)."""
    aux = train_sorted["aux_data"]
    return {
        "images": torch.as_tensor(train_sorted["images"],
                                  dtype=torch.float32, device=device),
        "angles": torch.as_tensor(np.unique(aux[:, 2]), dtype=torch.float32,
                                  device=device),
        "object_ids": torch.as_tensor(np.unique(aux[:, 1]).astype(np.int64),
                                      device=device),
        "grid_rows": torch.as_tensor(np.nonzero(train_angles_mask(aux))[0],
                                     device=device)}


def build_casale(args, splits: dict, device: torch.device) -> dict:
    """{"vae": MnistVAE, "gp": CasaleGP} on `device`: the GPLVM table from
    the PCA embeddings (--PCA) or, under --ov_joint, N(0, 1.5^2) draws;
    or from --params."""
    vae = MnistVAE(L=args.L,
                   generator=torch.Generator().manual_seed(args.seed))
    if not (args.PCA or args.ov_joint):
        raise SystemExit("--elbo GPVAE_Casale: without --ov_joint the GPLVM "
                         "table must start from --PCA")
    opts = dict(object_kernel_normalize=args.object_kernel_normalize,
                ov_joint=args.ov_joint, jitter=args.jitter,
                alpha_transform="softplus" if args.casale_alpha_softplus
                else "clamp", alpha_max=args.casale_alpha_max)
    gp = gpm.init_casale_gp(splits["pca_ov_init"] if args.PCA
                            else object_vectors_init(args, splits), **opts)
    if args.params:
        port = _load_params(args.params, casale_params_from_jax)
        vae.load_state_dict(port["vae"])
        gp = gpm.CasaleGP(**port["gp"], **opts)
    return {"vae": vae.to(device), "gp": gp.to(device)}


def make_casale_loss_fn(args, eps_fn: Callable, consts: dict, regime: str,
                        held_Z: Optional[torch.Tensor] = None) -> Callable:
    """loss_fn for train.train_step in a Casale `regime`.  "VAE": minus the
    plain VAE ELBO of the batch (aux column 0, the global index, dropped;
    no variance clip), one draw "train/VAE" (b, L).  "joint" / "GP": the
    full-train encode Z (a draw "train/<regime>" (N, L); or `held_Z`,
    without gradient), V and the Taylor terms, and the Casale objective
    of the batch (a draw (b, L))."""
    kind = f"train/{regime}"
    if regime == "VAE":
        forward = make_vae_forward(args, eps_fn, clip_qs=False)

        def vae_loss_fn(params, batch, geco, step):
            images, aux = batch
            out = forward(params, (images, aux[:, 1:]), kind)
            return -out.elbo, (geco, {"elbo": out.elbo.detach(),
                                      "recon": out.recon_loss.detach()})

        return vae_loss_fn

    def loss_fn(params, batch, geco, step):
        vae, gp = params["vae"], params["gp"]
        Z = held_Z
        if Z is None:
            images = consts["images"]
            Z = models.encode_full_casale(
                vae, images, eps_fn(kind, (images.shape[0], args.L)),
                clip_qs=args.clip_qs)
        V = gpm.v_matrix(gp, consts["angles"], consts["object_ids"],
                         consts["grid_rows"])
        a, ztKV, K_inv_V, c = gpm.taylor_terms(gp, Z, V)
        out = models.forward_pass_casale(
            vae, gp, batch, eps_fn(kind, (batch[0].shape[0], args.L)), a, c,
            V, args.beta, ztKV=ztKV, K_inv_V=K_inv_V, clip_qs=args.clip_qs)
        return out.elbo, (geco, {"elbo": out.elbo.detach(),
                                 "recon": out.recon_loss.detach()})

    return loss_fn


@torch.no_grad()
def casale_cgen(args, params: dict, consts: dict, test: tuple,
                train_aux: torch.Tensor, eps: Callable,
                noise_override=None) -> tuple:
    """JAX's Casale cgen_fn (gp_quantities' full-train encode and V, then
    the Woodbury cgen of the test split, svgpvae_tpu/cli/mnist.py:1305):
    the encode of consts["images"] with the "eval" draw eps("eval", (N,
    L)), V over consts' grid, the cgen of `test` (images, aux) with the
    draw eps("eval", (x, L)), conditioned on `train_aux`'s rows.
    `noise_override`: --casale_predict_alpha (None: the trained noise).
    Returns (recon images, loss) on the device."""
    vae, gp = params["vae"], params["gp"]
    Z = models.encode_full_casale(
        vae, consts["images"], eps("eval", (len(consts["images"]), args.L)),
        clip_qs=args.clip_qs)
    V = gpm.v_matrix(gp, consts["angles"], consts["object_ids"],
                     consts["grid_rows"])
    return models.predict_cgen_casale(
        vae, gp, *test, train_aux, V, Z, eps("eval", (len(test[0]), args.L)),
        noise_override=noise_override)


def run_casale(args, splits: dict, device: torch.device, eps_fn: Callable,
               capture_step: Optional[int], per_step: bool = False,
               eager_evals: bool = False) -> dict:
    """GPVAE_Casale: --opt_regime's epochs, each stepping its regime's own
    Adam; the cgen MSE every CASALE_EVAL_EVERY epochs.  On a CUDA device in
    a 1-process run each epoch replays its regime's captured CUDA graphs
    (a capture.GraphSteps per regime, whose Adam it turns capturable: a
    full-batch step and the tail step, and under --casale_taylor_every
    K > 1 the refresh of the held sample, a graph of its own that the host
    replays ahead of every K-th step), one readback an epoch; elsewhere
    the steps run one by one (per_step_reason).  The cgen replays a
    captured CUDA graph of its own on a CUDA device.  Returns {"params",
    "states" (per regime), "step_seconds", "metrics", "step_launches",
    "captured", "evals", "cgen_mse", "best_cgen_mse", "regimes" (per
    step), "chunks", "graph_replays" and "graph_launches" (named
    "<regime>/<graph>"), "eval_graph_replays" and "eval_graph_launches"
    (the cgen's graph, "cgen")}."""
    train_d = sort_train_data(splits["train"])
    N_train = len(train_d["images"])
    consts = casale_constants(train_d, device)
    test_im, test_aux = _to_dev(splits["test"], device)
    train_aux = torch.as_tensor(train_d["aux_data"], dtype=torch.float32,
                                device=device)
    run_dir = open_run_dir(args)
    params = build_casale(args, splits, device)
    named = train.trainable_tensors(params, lambda name: True)
    print(f"parameters: {utils.count_params(params)}")
    subsets = {"joint": (named, args.lr_joint),
               "GP": ({k: t for k, t in named.items()
                       if k.startswith("gp/")}, args.lr_gp),
               "VAE": ({k: t for k, t in named.items()
                        if k.startswith("vae/")}, CASALE_VAE_LR)}
    states = {r: train.TrainState(
        params=params, optimizer=train.make_optimizer(tensors, lr),
        geco=train.GECOState.init(device=device))
        for r, (tensors, lr) in subsets.items()}
    noise = Noise(eps_fn)
    nr_epochs, regime = train.parse_opt_regime(list(args.opt_regime))
    taylor_every = max(1, args.casale_taylor_every)
    # --casale_taylor_every K > 1: the held full-train sample, written in
    # place by every K-th step's refresh and read by the losses (a static
    # address for the graphs)
    held_Z = (torch.zeros((N_train, args.L), device=device)
              if taylor_every > 1 else None)
    age = 0
    loss_fns = {r: make_casale_loss_fn(args, noise, consts, r,
                                       None if r == "VAE" else held_Z)
                for r in subsets}

    @torch.no_grad()
    def refresh(r):
        held_Z.copy_(models.encode_full_casale(
            params["vae"], consts["images"],
            noise(f"train/{r}", (N_train, args.L)), clip_qs=args.clip_qs))

    def before_cadenced_step(r):
        """Every K-th cadenced step refreshes held_Z first (a graph of its
        own when the regime's steps replay graphs)."""
        nonlocal age
        if age % taylor_every == 0:
            if graphs:
                graphs[r].call("refresh", lambda: refresh(r))
            else:
                refresh(r)
        age += 1

    def ckpt_state():
        return {"regimes": {k: st.state_dict() for k, st in states.items()}}

    rec = StepRecorder(device, noise, capture_step)
    tracer = EpochTracer(args.profile_dir)
    why = per_step_reason(args, device, per_step, capture_step,
                          noise.generator)
    print("training loop: " + (
        f"per step ({why})" if why else "each epoch replays its regime's "
        "captured CUDA graphs (a full-batch step and the tail step"
        + (f"; the held sample's refresh every {taylor_every} steps"
           if held_Z is not None else "") + "), one readback an epoch"))
    graphs = {} if why else {r: capture.GraphSteps(
        loss_fns[r], args.batch_size, [noise.generator]) for r in subsets}
    epoch_fns = {r: train.make_multi_epoch_fn(g) for r, g in graphs.items()}
    tensors = (consts["images"], train_aux)

    # JAX's cgen_fn (gp_quantities -> the Woodbury cgen) as one captured
    # CUDA graph on a CUDA device (the eager call elsewhere, cgen_why): it
    # reads the parameters at their fixed addresses (each regime's Adam
    # steps them in place), its "eval" draws are static (StaticDraws) and
    # --casale_predict_alpha a device tensor made once.
    cgen_why = eval_pass_reason(device, per_step)
    cgen_eps = StaticDraws(noise)
    predict_alpha = (torch.tensor(args.casale_predict_alpha,
                                  dtype=torch.float32, device=device)
                     if args.casale_predict_alpha else None)

    test = (test_im, test_aux)

    def eager_cgen():
        return casale_cgen(args, params, consts, test, train_aux, noise,
                           args.casale_predict_alpha or None)

    cgen_call = eager_cgen if cgen_why else capture.CapturedCall(
        lambda: casale_cgen(args, params, consts, test, train_aux, cgen_eps,
                            predict_alpha))
    print("cgen: " + (f"uncaptured ({cgen_why})" if cgen_why else
                      "replays a captured CUDA graph, read back once"))
    evals, steps, regimes, pictures = [], 0, [], []
    t_start = time.perf_counter()
    for epoch in range(nr_epochs):
        r = regime[epoch]
        cadenced = held_Z is not None and r != "VAE"
        timed = epoch > 0 and r == regime[epoch - 1]
        with tracer.epoch(timed):
            if graphs:
                # the regimes' graphs never run at once: one memory pool
                graphs[r].pool = graphs[r].pool or next(
                    (g.pool for g in graphs.values() if g.pool), None)
                (ms,) = rec.chunk(
                    epoch_fns[r], states[r], tensors, 1, timed=timed,
                    before=(lambda j: before_cadenced_step(r)) if cadenced
                    else None)
            else:
                ms = []
                for j, batch in enumerate(train.epoch_batches(
                        tensors, args.batch_size)):
                    if cadenced:
                        before_cadenced_step(r)
                    ms.append(rec.step(
                        states[r], batch, loss_fns[r], subsets[r][0],
                        steps + j, regime=r,
                        held_Z=held_Z.clone() if cadenced else None))
        steps += len(ms)
        regimes.extend([r] * len(ms))
        elbos = [m["elbo"] for m in ms]
        losses = [m["recon"] for m in ms]
        utils.check_finite(elbos, steps, ckpt_state, run_dir)

        if (epoch + 1) % CASALE_EVAL_EVERY == 0:
            gp = params["gp"]
            print(f"epoch {epoch} ({r}): mean ELBO/batch {np.mean(elbos):.3f}"
                  f", train MSE {np.sum(losses) / N_train:.5f}")
            with torch.no_grad():
                ov = torch.linalg.norm(gp.object_vectors).item()
                print(f"  GP params: l={gp.length_scale.item():.4f} "
                      f"amp={gp.amplitude.item():.4f} "
                      f"alpha_raw={gp.alpha.item():.5f} "
                      f"noise={gpm.casale_noise(gp).item():.6f} "
                      f"|ov|={ov:.3f}")
            t0 = time.perf_counter()
            recon, loss = cgen_call()
            loss = float(loss)  # the pass's one readback
            recon = recon.clone()
            evals.append({"epoch": epoch, "cgen_mse": loss,
                          "seconds": {"cgen": time.perf_counter() - t0}})
            if eager_evals and not cgen_why:
                # the eager twin, and on the cusolver backend (the one
                # arithmetic the graph changes)
                t0 = time.perf_counter()
                twin_recon, twin_loss = eager_cgen()
                seconds = time.perf_counter() - t0
                with capture.cusolver_linalg():
                    cus_recon, cus_loss = eager_cgen()
                evals[-1]["eager"] = {"cgen": {
                    "loss": float(twin_loss), "images": twin_recon,
                    "seconds": seconds, "cusolver": {
                        "loss": float(cus_loss), "images": cus_recon}}}
            print(f"  cgen test MSE: {loss:.5f}")
            draw(pictures, run_dir, f"{steps}_cgen", "cgen",
                 plots.plot_image_grid, splits["test"]["images"], recon,
                 f"epoch {epoch + 1}. CGEN MSE {loss:.4f}")
            if run_dir and args.save_model_weights:
                utils.save_checkpoint(os.path.join(run_dir, "ckpt"),
                                      ckpt_state(), steps)
    rec.summary(time.perf_counter() - t_start)
    tracer.report()
    result = dict(rec.result(), params=params, states=states, evals=evals,
                  run_dir=run_dir, noise=noise, regimes=regimes,
                  pictures=pictures, graph_replays={
                      f"{r}/{k}": g.replays for r, st in graphs.items()
                      for k, g in st.graphs.items()}, graph_launches={
                      f"{r}/{k}": g.launches for r, st in graphs.items()
                      for k, g in st.graphs.items()},
                  **pass_record({} if cgen_why else {"cgen": cgen_call}))
    return _best(result, evals)


# --- run outputs -------------------------------------------------------------


ELBO_COLUMNS = ["step", "ELBO", "recon_loss", "KL_term", "min_qm", "max_qm",
                "min_qv", "max_qv", "inside_elbo", "ce_term", "min_pm",
                "max_pm", "min_pv", "max_pv", "C_ma", "lagrange_mult"]
VAE_COLUMNS = ELBO_COLUMNS[:8]
GP_COLUMNS = ["step", "length_scale", "amplitude", "ip_norm", "ov_norm"]


@torch.no_grad()
def write_vae_row(saver, step: int, vae_forward, params, batch) -> None:
    """The JAX driver's per-eval VAE metric row (the VAE forward pass on
    `batch` with the eval noise)."""
    out = vae_forward(params, batch, "eval")
    saver([step] + [float(x) for x in (
        out.elbo, out.recon_loss, out.kl_term, out.qnet_mu.min(),
        out.qnet_mu.max(), out.qnet_var.min(), out.qnet_var.max())])


@torch.no_grad()
def write_eval_rows(args, savers: dict, run_dir: str, state, forward,
                    batch) -> None:
    """The JAX driver's per-eval metric rows (the forward pass on `batch`
    with the eval noise) and res/gp_params_<step>.npz."""
    out = forward(state.params, batch, state.geco, args.alpha, "eval")
    savers["elbo"]([
        state.step, float(out.elbo), float(out.recon_loss),
        float(out.kl_term), float(out.qnet_mu.min()),
        float(out.qnet_mu.max()), float(out.qnet_var.min()),
        float(out.qnet_var.max()), float(out.inside_elbo),
        float(out.ce_term), float(out.p_m.min()), float(out.p_m.max()),
        float(out.p_v.min()), float(out.p_v.max()),
        float(state.geco.C_ma), float(state.geco.lagrange_mult)])
    gp = state.params["gp"]
    ov = gp.object_vectors
    savers["gp"]([state.step, float(gp.length_scale), float(gp.amplitude),
                  float(torch.linalg.norm(gp.inducing_points)),
                  0.0 if ov is None else float(torch.linalg.norm(ov))])
    np.savez(os.path.join(run_dir, "res", f"gp_params_{state.step}.npz"),
             length_scale=gp.length_scale.detach().cpu().numpy(),
             amplitude=gp.amplitude.detach().cpu().numpy(),
             inducing_points=gp.inducing_points.detach().cpu().numpy(),
             object_vectors=np.zeros(0) if ov is None
             else ov.detach().cpu().numpy())


def _snapshot(state, batch, index: int, **extra) -> dict:
    """Copies of what a step starts from: its parameters by name (and, as
    earlier consumers read them, the VAE's state dict and the GP's
    tensors), the batch, the GECO state and the driver's `extra`."""
    params = state.params
    snap = {"step": index, "batch": batch,
            "params": {k: v.detach().clone() for k, v in
                       train.named_tensors(params).items()},
            "geco": train.GECOState(C_ma=state.geco.C_ma.clone(),
                                    lagrange_mult=state.geco.lagrange_mult
                                    .clone()), **extra}
    if "vae" in params:
        snap["vae"] = {k: v.detach().clone()
                       for k, v in params["vae"].state_dict().items()}
    if "gp" in params:
        snap["gp"] = {k: v.detach().clone()
                      for k, v in params["gp"].named_tensors().items()}
    return snap


def _finish_capture(snap, state, trainable, metrics, noise) -> dict:
    """The step's noise ("draws", in order; "eps" the last), loss,
    gradients of its trainable tensors and the GECO state after it."""
    if noise is not None:
        snap["draws"] = [e.clone() for e in noise.draws]
        snap["eps"] = snap["draws"][-1] if snap["draws"] else None
        noise.draws = None
    snap["grads"] = {k: t.grad.detach().clone()
                     for k, t in trainable.items()}
    snap["loss"] = metrics["loss"]
    snap["geco_after"] = train.GECOState(
        C_ma=state.geco.C_ma.clone(),
        lagrange_mult=state.geco.lagrange_mult.clone())
    return snap


if __name__ == "__main__":
    main()
