"""SPRITES training with the PyTorch port: the SVGPVAE and the plain VAE.

    python -m svgpvae_tpu_torch.cli.sprites --elbo SVGPVAE_Hensman --GECO \
        --clip_qs --synthetic --synthetic_chars 1000 --opt_regime joint-1 \
        --eval_every 1 --nr_epochs_repr_nn 2 [--device cuda]

The flow of svgpvae_tpu/cli/sprites.py::run_experiment for
`SVGPVAE_Hensman` and `SVGPVAE_Titsias` (with or without --GECO):

  * the corpus: npz shards under --sprites_data_path; when there are none,
    the published raw npy corpus found there (the nine
    {walk,spellcard,slash}_{front,left,right} frames/attributes x
    train/test files) preprocessed into shards (data.load_raw_sprites_npys,
    data.preprocess_sprites: 50 train frames per character from
    RandomState(--corpus_seed), the JAX package's splits), or with
    --synthetic a generated corpus (the stale-corpus guard refuses one of
    another scale); or in memory (`main(splits=...)`); the train and test
    splits are uploaded to the device once;
  * the GP initialisation: N(0, 1.5^2) draws from RandomState(--seed), or
    the PCA + KDE initializers with --PCA;
  * the repr-net pretraining: SpritesReprNet + ClassificationHead over the
    train characters, cross-entropy, Adam at --lr_repr_nn, full batches of
    --batch_size_repr_nn; every 10 epochs the loss and accuracy on the
    test_action split;
  * per epoch, every full batch of --batch_size frames (whole characters,
    50 frames each; under --reshuffle the characters of the full batches
    permuted each epoch, the tail left in place, train.EpochShuffle with a
    CPU generator seeded by --seed whose state the checkpoints keep) and
    the tail through one training step each: conv
    encoder and the variance clip; the aux data from the repr net (the
    segment mean over each character's frames, under autograd); the
    SpritesSVGP kernel matrices; the GP block; the posterior-variance clip,
    the cross-entropy, the reparameterised sample, the conv decoder; GECO
    and Adam over the trainable vae, repr and gp tensors (--ip_joint,
    --GPLVM_joint, --GP_joint with --K_SE, --repr_nn_pretrain yes_fixed
    freezes the repr net), with the optional cosine lr (--lr_decay) and
    value clip (--clip_grad at --clip_grad_thres);
  * every --eval_every epochs: the test_character reconstruction MSE (72
    frames per character), the encodings and aux data of the whole train
    split, the full-train-set GP fit (B3 `fused_kernel_stats` on a CUDA
    device) and the conditional-generation (cgen) MSE of the unseen
    characters from their first --N_context frames;
  * --basin_retry: restart the main loop from a host copy of the
    post-pretraining parameters when cgen has not descended.

With --gp_block_impl fused_rejitter_pallas (the 'auto' choice on a CUDA
device) a step runs the B2 `gp_sufficient_stats` kernel (einsum backward)
once and the B1 `chol_inverse` kernel twice: on [K_mm; Sigma_1..L] and on
A_hat + jitter, whose logdet the rejittered KL takes.  `auto` is
`reference` on the CPU; a `*_pallas` impl there runs B1's plain twin.
With SVGPVAE_Titsias, `auto` is `fused` on every device: the
determinant-lemma block (gp.fused.gp_block_titsias) with Cholesky
solves, B2 twice per step (at the encoder noise and at noise + jitter)
and no B1 (an explicit --gp_block_impl fused_pallas runs one B1 launch
on [K_mm; Sigma_1..L; Sigma1_1..L]); the CE term is the exact entropy
unless --titsias_reference_ce.

The device is --device (cuda by default; the run refuses to start
without one).  TF32 is off for matmuls and cuDNN.  Weights come from
flax's initialisation (nn.nets.init_like_flax_) drawn from a
torch.Generator seeded by --seed, or from --params (an .npz of flat
JAX parameters, with the pretraining head if it is to be reused).  The
noise of step t is drawn from a torch.Generator seeded by --seed (or
--main_seed); every eval batch draws its noise from a generator seeded
with 11 (the JAX CLI's eval key is one fixed key too).

Run outputs, as the JAX CLI writes them (see cli/mnist.py): --save makes
the run dir with args.json; every epoch appends a row to
res/ELBO_results.csv and res/GP_params.csv (the JAX columns, on the first
train batch with the eval noise, or under --test_set_metrics on the first
test_character batch, 72 frames per character); every eval pass writes
res/gp_params_<step>.npz and a line of pics/test_metrics.txt, and at its
best cgen so far the last test batch's cgen images and their targets
(cgen_images.p, cgen_images_target.p); --save_model_weights writes a
checkpoint (the TrainState, the noise generator, the pretraining head)
at every eval and at the end.  --resume_dir <run dir> skips the
pretraining, restores the latest checkpoint and runs --opt_regime's
epochs from the restored step, writing into that run dir; it is refused
with --basin_retry, whose restarts need the post-pretraining parameters.
Every eval pass with a run dir also draws the JAX CLI's pictures, with
numpy alone (utils.plots; the card's machine has no matplotlib):
pics/<step>_recon.png, 8 frames of the last test_character batch
against their reconstructions ("epoch E. recon MSE X"), and for the
SVGPVAE pics/<step>_cgen.png, that batch's cgen targets against the
cgen images ("epoch E. CGEN MSE X"), the titles in the PNG text chunks;
on the host after the eval pass, outside the step timings (the result's
"pictures": the files and the host seconds of each).  --show_pics is
accepted and ignored, as by the JAX CLI.  After every epoch
utils.check_finite: on a NaN/inf ELBO the current state goes to
<run dir>/ckpt_nan/<step>.pt (a diagnostic, not a resume point) and
utils.NonFiniteLossError is raised.  --profile_dir DIR
writes a torch.profiler Chrome trace of epoch 1 (the JAX CLI's choice)
into DIR, with the ranges "train_step", "gp_block" and "eval_pass".

The main loop's epochs are the JAX CLI's epoch program
(train.make_epoch_fn): on a CUDA device, in a 1-process run or under
--data_parallel over NCCL, each epoch replays captured CUDA graphs of a
full-batch step (over NCCL on the rank's frames, its all-reduces inside)
and of the tail step (train.capture.GraphSteps: the batch rows gathered
on the card in the epoch's --reshuffle order, the lr of --lr_decay from
a per-step table, the GECO state in static tensors, the first two steps
of the run eager, Adam capturable, so a run sits within round-off of a
per-step one), its metrics read back once for the epoch's row,
check_finite and the --basin_retry plateau test; a --basin_retry restart
captures anew (a new optimizer, a new noise stream).  The epoch's seconds
over its steps are each step's.  Elsewhere the steps run one by one and
the run prints why: the CPU, --data_parallel over gloo (ranks sharing a
card), a capture_step, an injected eps_fn without a generator, or
main(per_step=True).  The pretraining epochs replay a captured graph of
their step likewise (make_epoch_fn; no tail, no GECO, a constant lr; the
metrics read back once an epoch), and the eval pass is JAX's three
programs and its fit as four captured calls (capture.CapturedCall): the
test_character recon (its loss summed on the device; B1 and B2 inside),
the full-train encode, the fit (B3, or B2 under --K_SE) and the cgen
(summed on the device), each read back once; their draws are static
(cli.mnist.StaticDraws) and the forward reads a static GECO pair copied
in before each pass.  Both say why they run uncaptured where the main
loop would (but for the eps_fn: they draw nothing from the training
stream).

--elbo VAE (the JAX CLI's default) trains the SpritesVAE alone on the
plain VAE ELBO (models.vae) for --nr_epochs epochs: no repr net, no
pretraining, no GP; its eval pass is the test_character reconstruction
MSE, and its metric rows the eight VAE columns.

Mixed precision, as the JAX CLI: --bf16 runs the SpritesVAE and the repr
net in bfloat16 (the flax meaning of dtype=, nn.nets.cast_layer), and
--bf16_hybrid the same with the VAE's heads (enc_out, dec_out and the
last elu) in fp32.  Their parameters, the Adam state and the checkpoints
stay fp32.  The pretraining runs the bf16 repr net under the fp32
classification head; every GP input is cast to fp32 (the encodings and
aux data of the training step, the eval pass's encode, fit and cgen), so
B1, B2 and B3 take fp32 only.  The cgen images are pickled as fp32
(numpy has no bf16).

--data_parallel N (0 off, -1 every visible device), as cli.mnist: N
ranks, one process each; every rank pretrains the repr net alike, then
each full main batch is sharded over the ranks by frames (a rank's share
need not align with the 50-frame characters: the character means add
per-character sums across ranks), the GP statistics and every sum over
the batch are added across ranks, and the tail batch and the eval passes
run replicated, but for the full-train fit (B3), which each rank runs on
its share of the train rows.  Over NCCL (a card per rank) the
pretraining, the main epochs and the four eval calls replay CUDA graphs
on every rank in the same order, their all-reduces inside (the eval's
in the fit); over gloo (ranks sharing a card) they run one by one.  A
--basin_retry restart re-replicates the post-pretraining parameters on
every rank.  Only rank 0 writes the run dir and prints.  Refused as in
JAX: N above the visible devices, or a batch that N does not divide.

--s2d64 and --fused_upsample are TPU rewrites that the port does not
carry, refused with an error (the JAX CLI turns --s2d64 off under bf16
too).
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
import shutil
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from svgpvae_tpu_torch import data, models, ops, parallel, train, utils
from svgpvae_tpu_torch import gp as gpm
from svgpvae_tpu_torch.cli.mnist import (EpochTracer, Noise, StaticDraws,
                                         checkpoint_state, default_eps_fn,
                                         draw, host_array, open_run_dir,
                                         per_step_reason, restore_shuffle,
                                         resume, shuffle_state, sync)
from svgpvae_tpu_torch.train import capture
from svgpvae_tpu_torch.nn import ClassificationHead, SpritesReprNet, SpritesVAE
from svgpvae_tpu_torch.utils import plots
from svgpvae_tpu_torch.utils.convert import (params_from_jax,
                                             sprites_train_params_from_jax)

N_ACTIONS = data.N_ACTIONS
FRAMES_PER_CHAR = 50      # train frames per character
EVAL_SEED = 11            # the JAX CLI's eval key, jax.random.PRNGKey(11)
PRETRAIN_EVAL_EVERY = 10  # epochs between the test_action passes
BASIN_STREAM = 7000       # the retry streams' offset (JAX: fold_in 7000 + n)


def build_parser() -> argparse.ArgumentParser:
    """The JAX CLI's arguments (same names and defaults), plus
    --device and --params."""
    p = argparse.ArgumentParser(
        description="SPRITES SVGPVAE training (PyTorch port)")
    p.add_argument("--expid", type=str, default="debug_SPRITES")
    p.add_argument("--base_dir", type=str, default=os.getcwd())
    p.add_argument("--elbo", type=str, default="VAE",
                   choices=["VAE", "SVGPVAE_Hensman", "SVGPVAE_Titsias"])
    p.add_argument("--sprites_data_path", type=str, default="SPRITES_data/")
    p.add_argument("--batch_size", type=int, default=500)
    p.add_argument("--nr_epochs", type=int, default=50)
    p.add_argument("--beta", type=float, default=0.001)
    p.add_argument("--m", type=int, default=1,
                   help="character vectors per action for inducing points")
    p.add_argument("--save", action="store_true")
    p.add_argument("--ip_joint", action="store_true")
    p.add_argument("--GPLVM_joint", action="store_true")
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--lr_decay", type=float, default=None,
                   help="cosine-decay the lr to lr*LR_DECAY over the run")
    p.add_argument("--save_model_weights", action="store_true")
    p.add_argument("--show_pics", action="store_true", help="unused")
    p.add_argument("--beta_schedule_switch", type=int, default=100,
                   help="unused")
    p.add_argument("--opt_regime", type=str, default=["joint-50"], nargs="+")
    p.add_argument("--L", type=int, default=64)
    p.add_argument("--L_action", type=int, default=8)
    p.add_argument("--L_character", type=int, default=16)
    p.add_argument("--clip_qs", action="store_true")
    p.add_argument("--ram", type=float, default=1.0, help="unused")
    p.add_argument("--GECO", action="store_true")
    p.add_argument("--alpha", type=float, default=0.99)
    p.add_argument("--kappa_squared", type=float, default=0.0075)
    p.add_argument("--geco_lambda_max", type=float, default=1e5,
                   help="cap on the GECO lagrange multiplier (float32 safety)")
    p.add_argument("--jitter", type=float, default=0.01)
    p.add_argument("--PCA", action="store_true")
    p.add_argument("--N_context", type=int, default=36)
    p.add_argument("--test_set_metrics", action="store_true")
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--clip_grad", action="store_true")
    p.add_argument("--repr_nn_pretrain", type=str, default="yes_joint",
                   choices=["no", "yes_fixed", "yes_joint"])
    p.add_argument("--lr_repr_nn", type=float, default=0.01)
    p.add_argument("--nr_epochs_repr_nn", type=int, default=400)
    p.add_argument("--batch_size_repr_nn", type=int, default=5000)
    p.add_argument("--object_kernel_normalize", action="store_true")
    p.add_argument("--K_SE", action="store_true")
    p.add_argument("--GP_joint", action="store_true")
    p.add_argument("--clip_grad_thres", type=float, default=1e6)
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic stand-in corpus if needed")
    p.add_argument("--synthetic_chars", type=int, default=12)
    p.add_argument("--allow_stale_corpus", action="store_true",
                   help="reuse an existing corpus whose N_train does not "
                        "match --synthetic_chars")
    p.add_argument("--corpus_seed", type=int, default=0,
                   help="seed of the synthetic corpus draw (kept apart from "
                        "--seed)")
    p.add_argument("--eval_every", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--main_seed", type=int, default=-1,
                   help="if >= 0, seed ONLY the main loop's noise stream "
                        "with it (inits and pretraining stay on --seed)")
    p.add_argument("--basin_retry", type=int, default=0,
                   help="restart the main loop from the post-pretraining "
                        "parameters, on a new noise stream, up to N times "
                        "when cgen has not descended by --basin_detect_rel "
                        "after --basin_detect_evals evals; 0 disables")
    p.add_argument("--basin_detect_evals", type=int, default=4)
    p.add_argument("--basin_detect_rel", type=float, default=0.03)
    p.add_argument("--resume_dir", type=str, default=None)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--bf16_hybrid", action="store_true")
    p.add_argument("--s2d64", action="store_true", default=None)
    p.add_argument("--no_s2d64", dest="s2d64", action="store_false")
    p.add_argument("--fused_upsample", action="store_true")
    p.add_argument("--gp_block_impl", type=str, default="auto",
                   choices=["auto", *models.svgpvae.GP_BLOCK_IMPLS],
                   help="GP block of the training forward (see cli/mnist.py)"
                        "; auto = fused_rejitter_pallas on CUDA, reference "
                        "on the CPU for Hensman (the identity-KL impls are "
                        "never auto here, PARITY.md #10), fused on every "
                        "device for Titsias")
    p.add_argument("--titsias_reference_ce", action="store_true",
                   help="Titsias only: the reference's encoder "
                        "cross-entropy CE term in place of the exact "
                        "entropy (PARITY.md #13)")
    p.add_argument("--entropy_ce", action="store_true",
                   help="use the exact sampling-distribution entropy CE "
                        "term")
    p.add_argument("--reshuffle", action="store_true")
    p.add_argument("--data_parallel", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--params", type=str, default=None,
                   help=".npz of flat JAX SPRITES SVGPVAE parameters (vae, "
                        "repr, gp and optionally the pretraining head) to "
                        "start from")
    return p


TPU_ONLY = {  # TPU rewrites of the convs, not carried by the port
    "--s2d64": lambda a: bool(a.s2d64),
    "--fused_upsample": lambda a: a.fused_upsample,
}


def refuse_unported(args) -> None:
    for flag, is_set in TPU_ONLY.items():
        if is_set(args):
            raise SystemExit(f"{flag}: a TPU rewrite, not ported")
    if "SVGPVAE" in args.elbo and any(not s.startswith("joint-")
                                      for s in args.opt_regime):
        raise SystemExit("--opt_regime: SPRITES trains jointly only (joint-N)"
                         ", as the reference experiment")
    if args.object_kernel_normalize and args.K_SE:
        raise SystemExit("--object_kernel_normalize and --K_SE: at most one "
                         "GP kernel flag at once")
    if args.batch_size % FRAMES_PER_CHAR:
        raise SystemExit(f"--batch_size must be a multiple of "
                         f"{FRAMES_PER_CHAR} (whole characters)")
    if args.basin_retry and args.resume_dir:
        raise SystemExit("--basin_retry restarts from the post-pretraining "
                         "parameters and cannot be combined with "
                         "--resume_dir")


def _count_corpus_rows(train_dir: str) -> Optional[int]:
    """Train rows over the shards, or None if a shard is unreadable (a
    partly written corpus)."""
    n = 0
    for shard in sorted(glob.glob(os.path.join(train_dir, "*.npz"))):
        try:
            with np.load(shard) as z:
                n += len(z["aux_data"])
        except (OSError, ValueError, KeyError) as e:
            print(f"corpus shard {shard} unreadable ({e}); treating the "
                  "corpus as invalid")
            return None
    return n


def ensure_dataset(args) -> None:
    """Make sure --sprites_data_path holds shards: as they are, or (with
    --synthetic) generated there.  An existing corpus of another scale
    than --synthetic_chars is refused unless --allow_stale_corpus; an
    unreadable one is deleted and regenerated."""
    path = args.sprites_data_path
    train_dir = os.path.join(path, "train")
    if os.path.isdir(train_dir):
        if not args.synthetic:
            return
        n_train = _count_corpus_rows(train_dir)
        expect = args.synthetic_chars * FRAMES_PER_CHAR
        if n_train == expect:
            return
        if n_train is None:
            print(f"existing corpus at {path} is unreadable; deleting and "
                  "regenerating")
            shutil.rmtree(path)
        elif args.allow_stale_corpus:
            print(f"WARNING: existing corpus at {path} has N_train="
                  f"{n_train}, but --synthetic_chars {args.synthetic_chars} "
                  f"implies {expect}; reusing it (--allow_stale_corpus)")
            return
        else:
            raise SystemExit(
                f"existing corpus at {path} has N_train={n_train}, but "
                f"--synthetic_chars {args.synthetic_chars} implies {expect};"
                " delete the directory to regenerate, or pass "
                "--allow_stale_corpus to reuse it anyway")
    if data.has_raw_sprites_npys(path):
        print(f"raw sprites npy corpus found at {path}; preprocessing "
              f"({FRAMES_PER_CHAR} train frames/char)")
        x_tr, x_te, a_tr, a_te, d_tr, d_te = data.load_raw_sprites_npys(path)
        splits = data.preprocess_sprites(x_tr, a_tr, d_tr, x_te, a_te, d_te,
                                         n_frames_train=FRAMES_PER_CHAR,
                                         seed=args.corpus_seed)
        data.save_sprites_shards(splits, path)
        return
    if not args.synthetic:
        raise SystemExit(f"no SPRITES shards at {path}: provide shards "
                         "(data.save_sprites_shards) or pass --synthetic")
    print(f"generating synthetic SPRITES corpus ({args.synthetic_chars} "
          "train characters)")
    splits = data.generate_synthetic_sprites(
        n_train_chars=args.synthetic_chars,
        n_test_chars=max(2, args.synthetic_chars // 4),
        n_frames_train=FRAMES_PER_CHAR, seed=args.corpus_seed)
    data.save_sprites_shards(splits, path)


def trainable_predicate(args) -> Callable[[str], bool]:
    """name ("vae/...", "repr/...", "gp/<field>") -> trainable?  As the
    JAX CLI's mask: the repr net is frozen under --repr_nn_pretrain
    yes_fixed, the inducing points follow --ip_joint, the GPLVM action
    table --GPLVM_joint, the four kernel scalars --GP_joint with --K_SE."""
    gp_flags = {"inducing_points": args.ip_joint,
                "gplvm_action": args.GPLVM_joint}
    gp_flags.update({k: args.GP_joint and args.K_SE for k in (
        "l_action", "sigma_action", "l_character", "sigma_character")})

    def predicate(name: str) -> bool:
        part, _, leaf = name.partition("/")
        if part == "repr":
            return args.repr_nn_pretrain != "yes_fixed"
        if part == "gp":
            return gp_flags[leaf]
        return True

    return predicate


def net_dtypes(args) -> tuple:
    """(compute dtype, head dtype) of the SpritesVAE, the first also the
    repr net's: bfloat16 under --bf16 or --bf16_hybrid, the hybrid's heads
    fp32; (None, None), the parameters' dtype, without either."""
    if not (args.bf16 or args.bf16_hybrid):
        return None, None
    return torch.bfloat16, torch.float32 if args.bf16_hybrid else None


def build_model(args, splits: dict, N_train: int, device: torch.device):
    """{"vae", "repr", "gp"} and the pretraining head on `device`: the GP
    initialised as the JAX CLI does, the nets from flax's init drawn
    from one generator seeded by --seed; or everything (the head if
    present) from --params.  The nets compute in `net_dtypes(args)`, the
    head in fp32.  --elbo VAE: {"vae"} alone and no head."""
    n_chars = N_train // FRAMES_PER_CHAR
    gen = torch.Generator().manual_seed(args.seed)
    dtype, head_dtype = net_dtypes(args)
    vae = SpritesVAE(L=args.L, generator=gen, dtype=dtype,
                     head_dtype=head_dtype)
    f32 = dict(device=device, dtype=torch.float32)
    if "SVGPVAE" not in args.elbo:
        if args.params:
            with np.load(args.params) as z:
                vae.load_state_dict(params_from_jax(dict(z))["vae"])
        return {"vae": vae.to(**f32)}, None
    repr_net = SpritesReprNet(L=args.L_character, generator=gen, dtype=dtype)
    head = ClassificationHead(args.L_character, n_chars, generator=gen)
    if args.PCA:
        gplvm_init, ip_init = data.sprites_pca_init(
            splits["train"], m=args.m, L_action=args.L_action,
            L_character=args.L_character, device=device)
    else:
        rng = np.random.RandomState(args.seed)
        gplvm_init = rng.normal(0, 1.5, (N_ACTIONS, args.L_action))
        ip_init = rng.normal(0, 1.5, (N_ACTIONS * args.m,
                                      args.L_action + args.L_character))
    cfg = gpm.SVGPConfig(titsias=args.elbo == "SVGPVAE_Titsias",
                         jitter=args.jitter, N_train=N_train,
                         K_obj_normalize=args.object_kernel_normalize)
    gp = gpm.init_sprites_svgp(ip_init, gplvm_init, L_action=args.L_action,
                               use_se_kernel=args.K_SE, config=cfg)
    params = {"vae": vae, "repr": repr_net, "gp": gp}
    if args.params:
        with np.load(args.params) as z:
            port = sprites_train_params_from_jax(
                dict(z), cfg, args.L_action, use_se_kernel=args.K_SE)
        head = port.pop("head", head)
        vae.load_state_dict(port["vae"].state_dict())
        repr_net.load_state_dict(port["repr"].state_dict())
        params["gp"] = port["gp"]
    return {k: v.to(**f32) for k, v in params.items()}, head.to(**f32)


def make_forward(args, eps_fn: Callable) -> Callable:
    """forward(params, batch, geco, alpha, kind, frames_per_char): the
    training forward pass with this run's options and `eps_fn(kind,
    (b, L))` noise."""
    kappa = float(np.sqrt(args.kappa_squared))

    def forward(params, batch, geco, alpha, kind, frames_per_char):
        return models.forward_pass_svgpvae(
            params["vae"], params["gp"], batch,
            eps_fn(kind, (batch[0].shape[0], args.L)), beta=args.beta,
            C_ma=geco.C_ma, lagrange_mult=geco.lagrange_mult, alpha=alpha,
            kappa=kappa, clip_qs=args.clip_qs, geco=args.GECO,
            lagrange_max=args.geco_lambda_max,
            gp_block_impl=args.gp_block_impl, entropy_ce=args.entropy_ce,
            titsias_reference_ce=args.titsias_reference_ce,
            repr_net=params["repr"], frames_per_char=frames_per_char)

    return forward


def make_vae_forward(args, eps_fn: Callable) -> Callable:
    """make_forward's form for --elbo VAE: the plain VAE forward pass
    (models.vae; the action ids and the GECO arguments go unused)."""

    def forward(params, batch, geco, alpha, kind, frames_per_char):
        return models.forward_pass_vae(
            params["vae"], batch, eps_fn(kind, (batch[0].shape[0], args.L)),
            clip_qs=args.clip_qs)

    return forward


def make_vae_loss_fn(forward: Callable) -> Callable:
    """loss_fn for train.train_step with make_vae_forward's forward: minus
    the VAE ELBO; the GECO state passes through."""

    def loss_fn(params, batch, geco, step):
        out = forward(params, batch, geco, 0.0, "train", FRAMES_PER_CHAR)
        return -out.elbo, (geco, {"elbo": out.elbo.detach(),
                                  "recon": out.recon_loss.detach()})

    return loss_fn


def make_loss_fn(args, forward: Callable) -> Callable:
    """loss_fn(params, batch, geco, step) -> (loss, (geco, metrics)) for
    train.train_step: GECO minimizes the objective, the plain objective
    maximizes the ELBO."""

    def loss_fn(params, batch, geco, step):
        out = forward(params, batch, geco,
                      train.geco_effective_alpha(step, args.alpha), "train",
                      FRAMES_PER_CHAR)
        new_geco = train.GECOState(C_ma=out.C_ma,
                                   lagrange_mult=out.lagrange_mult)
        loss = out.elbo if args.GECO else -out.elbo
        metrics = {"elbo": out.elbo.detach(),
                   "recon": out.recon_loss.detach(), "C_ma": out.C_ma,
                   "lagrange": out.lagrange_mult}
        return loss, (new_geco, metrics)

    return loss_fn


def pretrain_loss(params, batch, geco, step):
    """Repr net + head cross-entropy over the character ids, and the
    accuracy."""
    frames, char_ids = batch
    logits = params["head"](params["repr"](frames))
    labels = char_ids.long()
    loss = F.cross_entropy(logits, labels)
    acc = torch.mean((torch.argmax(logits, 1) == labels).float())
    return loss, (geco, {"acc": acc})


def main(argv=None, splits: Optional[dict] = None,
         eps_fn: Optional[Callable] = None,
         capture_step: Optional[int] = None,
         on_eval: Optional[Callable[[dict], None]] = None,
         perm_fn: Optional[Callable] = None,
         per_step: bool = False) -> dict:
    """Train; returns a dict (see `run_svgpvae`).

    `splits` ({"train", "test_action", "test_character"}, as
    data.generate_synthetic_sprites returns) skips the corpus on disk.
    `eps_fn(kind, shape)` ("train" or "eval") replaces the default noise
    (tests inject the JAX draws; a --basin_retry restart keeps drawing
    from it).  `capture_step` keeps a copy of that main step's inputs,
    parameters before it, noise and gradients.  `on_eval(ev)` is called
    after each eval pass (and its checkpoint) with its record (in a
    data-parallel run on rank 0).
    `perm_fn(n)` gives --reshuffle's permutations of the n characters of
    the full batches (tests inject JAX's).  `per_step` runs the main loop
    one step at a time where its epochs would replay captured CUDA graphs
    (the card's eager yardstick)."""
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device")
    loaded = splits is None
    if loaded:
        ensure_dataset(args)
        splits = data.load_sprites(args.sprites_data_path)
    ranks = parallel.resolve_data_parallel(
        args.data_parallel, min(args.batch_size,
                                len(splits["train"]["frames"])), args.device)
    if parallel.needs_launch(ranks):
        # the other ranks load the corpus that rank 0 made sure of
        kw = {k: v for k, v in dict(
            eps_fn=eps_fn, capture_step=capture_step, perm_fn=perm_fn,
            per_step=per_step or None).items() if v is not None}
        # on_eval runs on rank 0 alone, which returns the run's result
        return parallel.launch(
            "svgpvae_tpu_torch.cli.sprites", argv,
            kw if loaded else dict(kw, splits=splits), ranks, args.device,
            rank0_kwargs=dict(kw, splits=splits, on_eval=on_eval))
    with parallel.active(ranks):
        device = parallel.device(args.device)
        parallel.announce(device)
        return _main(args, device, splits, eps_fn, capture_step, on_eval,
                     perm_fn, per_step)


def _main(args, device, splits, eps_fn, capture_step, on_eval, perm_fn,
          per_step=False):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN (the GP math needs IEEE fp32)")
    if args.bf16 or args.bf16_hybrid:
        print("--bf16" + ("_hybrid: the nets compute in bfloat16, the VAE's "
                          "heads in fp32" if args.bf16_hybrid else
                          ": the nets compute in bfloat16")
              + "; their parameters, Adam and the GP math (and every "
              "kernel) stay fp32")
    return run_svgpvae(args, splits, device, eps_fn, capture_step, on_eval,
                       perm_fn, per_step)


def _stream_seed(args, attempt: int) -> int:
    """Seed of the main loop's noise stream: --main_seed (if >= 0) or
    --seed, and a derived one for each --basin_retry restart."""
    base = args.main_seed if args.main_seed >= 0 else args.seed
    if attempt == 0:
        return base
    return int(np.random.SeedSequence([base, BASIN_STREAM + attempt])
               .generate_state(1)[0])


def pretrain(args, params: dict, head, train_frames, train_chars,
             ta_frames, ta_chars, why: Optional[str] = None) -> dict:
    """The repr-net pretraining; updates params["repr"] in place.  Each
    epoch takes the full batches of the first (N // bs) * bs rows in
    stored order, no tail (the JAX CLI's device_batches).  Without a
    reason `why` to step one by one, each epoch replays a captured CUDA
    graph of the step (train.make_epoch_fn over a capture.GraphSteps;
    Adam turns capturable) and its metrics are read back once.  Returns
    its seconds, steps and per-epoch metrics (with the test_action loss
    and accuracy every PRETRAIN_EVAL_EVERY epochs, per batch as in JAX),
    "graph_replays" and "graph_launches" (see cli.mnist.graph_record)."""
    N = len(train_frames)
    bs = min(args.batch_size_repr_nn, N)
    n_full = (N // bs) * bs
    pre = {"repr": params["repr"], "head": head}
    state = train.TrainState(
        params=pre, geco=None, optimizer=train.make_optimizer(
            train.trainable_tensors(pre, lambda name: True),
            args.lr_repr_nn))

    @torch.no_grad()
    def eval_test_action():
        n = len(ta_frames)
        c = min(bs, n)
        bounds = [(lo, lo + c) for lo in range(0, (n // c) * c, c)]
        if n % c:
            bounds.append((n - n % c, n))
        loss = hits = 0.0
        for lo, hi in bounds:
            logits = head(params["repr"](ta_frames[lo:hi]))
            labels = ta_chars[lo:hi].long()
            loss += float(F.cross_entropy(logits, labels, reduction="sum"))
            hits += float(torch.sum(torch.argmax(logits, 1) == labels))
        return loss / n, hits / n

    t0 = time.perf_counter()
    print(f"pretraining representation net ({args.nr_epochs_repr_nn} "
          f"epochs, batch {bs}): " + (
              f"per step ({why})" if why else "each epoch replays a "
              "captured CUDA graph of the step, one readback an epoch"))
    # the same tensors every epoch (GraphSteps gathers its rows from them)
    tensors = (train_frames[:n_full], train_chars[:n_full])
    graphs = None if why else capture.GraphSteps(pretrain_loss, bs)
    epoch_fn = None if graphs is None else train.make_epoch_fn(graphs)
    epochs = []
    for epoch in range(args.nr_epochs_repr_nn):
        if epoch_fn:
            ms, _ = epoch_fn(state, tensors)
            host = torch.stack([ms["loss"], ms["acc"]]).cpu().tolist()
        else:
            ms = [train.train_step(state, tuple(t[lo:lo + bs]
                                                for t in tensors),
                                   pretrain_loss)
                  for lo in range(0, n_full, bs)]
            host = [[float(m[k]) for m in ms] for k in ("loss", "acc")]
        ep = {"epoch": epoch, "loss": float(np.mean(host[0])),
              "acc": float(np.mean(host[1]))}
        if epoch % PRETRAIN_EVAL_EVERY == 0:
            ep["test_action_loss"], ep["test_action_acc"] = \
                eval_test_action()
            print(f"  pretrain epoch {epoch}: loss {ep['loss']:.4f} acc "
                  f"{ep['acc']:.3f} | test_action loss "
                  f"{ep['test_action_loss']:.4f} acc "
                  f"{ep['test_action_acc']:.3f}")
        epochs.append(ep)
    seconds = time.perf_counter() - t0
    print(f"pretraining done in {seconds:.1f}s")
    return {"seconds": seconds, "steps": state.step, "epochs": epochs,
            **graph_record([graphs])}


def run_svgpvae(args, splits: dict, device: torch.device,
                eps_fn: Optional[Callable], capture_step: Optional[int],
                on_eval: Optional[Callable[[dict], None]] = None,
                perm_fn: Optional[Callable] = None,
                per_step: bool = False) -> dict:
    """Returns {"state", "pretrain", "step_seconds" (host clock after
    synchronize, per main step; for a replayed epoch its seconds over its
    steps), "metrics" (per step), "step_launches" (kernel launches inside
    each step), "evals" (per eval pass: MSEs, the seconds and launches of
    its stages), "captured", "cgen_mse", "best_cgen_mse",
    "basin_attempts", "chunks" (each replayed epoch's steps and seconds,
    as cli.mnist's), "graph_replays", "graph_launches" (graph_record),
    "eval_graph_replays", "eval_graph_launches" (the eval calls' graphs,
    by call), "test_recon" and "cgen_images" (the last eval's last test
    batch: its recon images; its cgen images and targets)}; "pretrain"
    holds its own graphs' record.  --elbo VAE: no pretraining, no GP;
    --nr_epochs epochs, and the eval pass is the test_character
    reconstruction alone."""
    is_svgpvae = "SVGPVAE" in args.elbo
    if is_svgpvae:
        args.gp_block_impl = models.resolve_gp_block_impl(
            args.gp_block_impl, workload="sprites",
            titsias=args.elbo == "SVGPVAE_Titsias", device=device)
        print(f"gp_block_impl: {args.gp_block_impl}, device {device}")
    train_d, tc_d = splits["train"], splits["test_character"]
    N_train, N_test = len(train_d["frames"]), len(tc_d["frames"])
    batch_size = min(args.batch_size, N_train)
    # test_character batches: a multiple of 72 frames that divides N_test
    # (the reference uses 576)
    batch_tc = min(576, N_test - (N_test % N_ACTIONS) or N_ACTIONS)
    while N_test % batch_tc:
        batch_tc -= N_ACTIONS

    run_dir = open_run_dir(args)
    params, head = build_model(args, splits, N_train, device)

    def to_dev(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    # each split is uploaded once; batches are views
    train_frames = to_dev(train_d["frames"])
    train_action = to_dev(train_d["aux_data"][:, 1])
    tc_frames = to_dev(tc_d["frames"])
    tc_action = to_dev(tc_d["aux_data"][:, 1])

    # why the pretraining and the eval calls, which draw nothing from the
    # training stream, run uncaptured (None: they replay CUDA graphs)
    side_why = per_step_reason(args, device, per_step, capture_step, None,
                               draws=False)
    pre = None
    if is_svgpvae and "yes" in args.repr_nn_pretrain and not args.resume_dir:
        ta_d = splits["test_action"]
        pre = pretrain(args, params, head, train_frames,
                       to_dev(train_d["aux_data"][:, 0]),
                       to_dev(ta_d["frames"]), to_dev(ta_d["aux_data"][:, 0]),
                       side_why)

    trainable = train.trainable_tensors(params, trainable_predicate(args))
    print(f"parameters: {utils.count_params(params)}, trainable: "
          f"{sum(t.numel() for t in trainable.values())}")
    nr_epochs = (train.parse_opt_regime(list(args.opt_regime))[0]
                 if is_svgpvae else args.nr_epochs)
    steps_per_epoch = -(-N_train // batch_size)

    def fresh_state():
        return train.TrainState(
            params=params,
            optimizer=train.make_optimizer(trainable, args.lr),
            geco=train.GECOState.init(device=device),
            lr_fn=train.cosine_decay_lr(args.lr, args.lr_decay,
                                        nr_epochs * steps_per_epoch),
            clip_grad_value=args.clip_grad_thres if args.clip_grad else None)

    def stream(attempt):
        return eps_fn or default_eps_fn(_stream_seed(args, attempt), device,
                                        eval_seed=EVAL_SEED)

    # --reshuffle permutes whole characters of the full batches
    shuffle = (train.EpochShuffle(N_train, batch_size, block=FRAMES_PER_CHAR,
                                  seed=args.seed, perm_fn=perm_fn)
               if args.reshuffle else None)
    state = fresh_state()
    noise = Noise(stream(0))
    if args.resume_dir:
        ckpt = resume(args, state, noise)
        if ckpt is not None and head is not None:
            head.load_state_dict(ckpt["head"])
        restore_shuffle(ckpt, shuffle)
    parallel.check_replicated(list(train.named_tensors(params).values()))
    if is_svgpvae:
        forward = make_forward(args, noise)
        loss_fn = make_loss_fn(args, forward)
    else:
        forward = make_vae_forward(args, noise)
        loss_fn = make_vae_loss_fn(forward)
    savers = {}
    if run_dir:
        savers["elbo"] = utils.ResultSaver(
            os.path.join(run_dir, "res", "ELBO_results.csv"),
            ELBO_COLUMNS if is_svgpvae else ELBO_COLUMNS[:8], flush_every=1)
    if run_dir and is_svgpvae:
        savers["gp"] = utils.ResultSaver(
            os.path.join(run_dir, "res", "GP_params.csv"), GP_COLUMNS,
            flush_every=1)

    def ckpt_state():
        return checkpoint_state(state, noise, head=None if head is None
                                else head.state_dict(),
                                **shuffle_state(shuffle))

    def save_checkpoint():
        utils.save_checkpoint(os.path.join(run_dir, "ckpt"), ckpt_state(),
                              state.step)
    # --basin_retry restarts from the post-pretraining parameters
    host_copy = ({k: v.detach().to("cpu", copy=True)
                  for k, v in train.named_tensors(params).items()}
                 if args.basin_retry else None)
    bounds = [(lo, min(lo + batch_size, N_train))
              for lo in range(0, N_train, batch_size)]
    # the per-epoch metric rows' batch: the first train batch, or the first
    # test_character batch (--test_set_metrics; its characters hold all 72
    # frames)
    metrics_batch, metrics_fpc = (
        ((tc_frames[:batch_tc], tc_action[:batch_tc]), N_ACTIONS)
        if args.test_set_metrics else
        ((train_frames[:batch_size], train_action[:batch_size]),
         FRAMES_PER_CHAR))

    # The eval pass: four calls (JAX's three lax.map programs and the fit),
    # each replaying a captured CUDA graph (capture.CapturedCall) unless
    # side_why says why not, each read back once.  Their draws are static
    # (every eval batch draws the same fixed noise), and the forward reads a
    # static GECO pair, copied in before each pass; what a call returns is
    # its graph's output, overwritten by the next replay.
    eps_eval = StaticDraws(noise)
    eval_forward = (make_forward if is_svgpvae else make_vae_forward)(
        args, eps_eval)
    geco_eval = train.GECOState(state.geco.C_ma.clone(),
                                state.geco.lagrange_mult.clone())
    tc_batches = [(tc_frames[lo:lo + batch_tc], tc_action[lo:lo + batch_tc])
                  for lo in range(0, N_test, batch_tc)]
    n_tgt = batch_tc // N_ACTIONS * (N_ACTIONS - args.N_context)
    fed = {}  # the encode call's outputs (the fit's inputs), the fit's

    @torch.no_grad()
    def recon_call():
        """The test_character forward of every batch: (the summed recon
        loss, the last batch's recon images)."""
        outs = [eval_forward(params, b, geco_eval, args.alpha, "eval",
                             N_ACTIONS) for b in tc_batches]
        return (torch.stack([o.recon_loss for o in outs]).sum(),
                outs[-1].recon_images)

    @torch.no_grad()
    def encode_call():
        """The encodings and aux data of the whole train split."""
        enc = []
        for lo, hi in bounds:
            im = train_frames[lo:hi]
            mu, var = models.batching_encode_svgpvae(params["vae"], im,
                                                     clip_qs=args.clip_qs)
            enc.append((mu, var, models.sprites_aux_data(
                params["repr"], im, train_action[lo:hi], FRAMES_PER_CHAR)
                .to(mu.dtype)))  # the fit (B3) takes fp32
        return tuple(torch.cat(x) for x in zip(*enc))

    @torch.no_grad()
    def fit_call():
        return models.precompute_gp_params(params["gp"], *fed["encode"])

    @torch.no_grad()
    def cgen_call():
        """The cgen of every test batch: (the summed loss, the last
        batch's cgen images and targets)."""
        outs = [models.predict_cgen_sprites(
            params["vae"], params["gp"], params["repr"], im, aid,
            *fed["fit"], n_context=args.N_context,
            n_actions_total=N_ACTIONS, eps=eps_eval("eval", (n_tgt, args.L)))
            for im, aid in tc_batches]
        return (torch.stack([loss for _, _, loss in outs]).sum(),
                *outs[-1][:2])

    eval_calls = {"recon": recon_call}
    if is_svgpvae:
        eval_calls.update(encode=encode_call, fit=fit_call, cgen=cgen_call)
    if not side_why:
        eval_calls = {k: capture.CapturedCall(f)
                      for k, f in eval_calls.items()}
    print("eval pass: " + (f"uncaptured ({side_why})" if side_why else
                           f"{len(eval_calls)} calls ("
                           + ", ".join(eval_calls) + "), each replaying a "
                           "captured CUDA graph, each read back once"))

    @utils.annotate("eval_pass")
    def eval_pass(epoch):
        ev, secs, launches = {"epoch": epoch}, {}, {}

        def stage(name, t0, before):
            sync(device)
            secs[name] = time.perf_counter() - t0
            after = ops.launch_counts()
            launches[name] = {k: after[k] - before[k] for k in after}
            return time.perf_counter(), after

        t, lc = time.perf_counter(), ops.launch_counts()
        geco_eval.C_ma.copy_(state.geco.C_ma)
        geco_eval.lagrange_mult.copy_(state.geco.lagrange_mult)
        recon, recon_images = eval_calls["recon"]()
        ev["test_mse"] = float(recon) / N_test
        recon_images = recon_images.clone()  # before the next replay
        t, lc = stage("recon", t, lc)
        if not is_svgpvae:
            ev["seconds"], ev["launches"] = secs, launches
            return ev, recon_images, None
        fed["encode"] = eval_calls["encode"]()
        t, lc = stage("encode", t, lc)
        fed["fit"] = eval_calls["fit"]()
        t, lc = stage("fit", t, lc)
        cgen, pics, tgts = eval_calls["cgen"]()
        ev["cgen_mse"] = float(cgen) / (N_test * (1 - args.N_context
                                                  / N_ACTIONS))
        pics, tgts = pics.clone(), tgts.clone()
        stage("cgen", t, lc)
        ev["seconds"], ev["launches"] = secs, launches
        # the last test batch's recon and cgen images
        return ev, recon_images, (pics, tgts)

    step_seconds, step_metrics, step_launches, evals = [], [], [], []
    captured, cgen_history, attempt, epoch = None, [], 0, 0
    pictures, chunks = [], []
    recon_images = cgen_images = None
    tc_last_frames = tc_d["frames"][(N_test - 1) // batch_tc * batch_tc:]
    tracer = EpochTracer(args.profile_dir)
    why = per_step_reason(args, device, per_step, capture_step,
                          noise.generator)
    print("training loop: " + (
        f"per step ({why})" if why else "each epoch replays captured CUDA "
        "graphs (a full-batch step and the tail step), one readback an "
        "epoch"))

    def epoch_graphs():
        """The default loop's graphs and epoch function (captured anew
        for a --basin_retry restart: a new optimizer, a new noise
        generator), or (None, None) for the per-step loop."""
        if why:
            return None, None
        graphs = capture.GraphSteps(loss_fn, batch_size, [noise.generator],
                                    shard=True)
        return graphs, train.make_epoch_fn(graphs, shuffle)

    graphs, epoch_fn = epoch_graphs()
    retired = graph_record([])  # the replays of the attempts before a restart
    tensors = (train_frames, train_action)
    t_start = time.perf_counter()
    while epoch < nr_epochs:
        t_epoch = time.perf_counter()
        elbos, losses = [], []
        if epoch_fn is not None:
            with tracer.epoch(epoch == 1):
                ms, launches = epoch_fn(state, tensors)
                keys = list(ms)
                host = torch.stack([ms[k] for k in keys]).cpu().tolist()
            seconds = time.perf_counter() - t_epoch
            chunks.append({"epochs": 1, "steps": len(launches),
                           "seconds": seconds})
            step_seconds.extend([seconds / len(launches)] * len(launches))
            step_launches.extend(launches)
            for vals in zip(*host):
                m = dict(zip(keys, vals))
                step_metrics.append(m)
                elbos.append(m["elbo"])
                losses.append(m["recon"])
        else:
            order = shuffle.order() if shuffle is not None else None
            with tracer.epoch(epoch == 1):
                for batch in train.epoch_batches(tensors, batch_size, order):
                    snap = (_snapshot(state, batch) if len(step_seconds) ==
                            capture_step else None)
                    before = ops.launch_counts()
                    t0 = time.perf_counter()
                    # a full batch takes this rank's frames (data-parallel)
                    with utils.annotate("train_step"), \
                            parallel.sharded(len(batch[0]) == batch_size):
                        m = train.train_step(
                            state, tuple(parallel.local_rows(t)
                                         for t in batch), loss_fn)
                        sync(device)
                    step_seconds.append(time.perf_counter() - t0)
                    after = ops.launch_counts()
                    step_launches.append({k: after[k] - before[k]
                                          for k in after})
                    if snap is not None:
                        captured = _finish_capture(snap, state, trainable,
                                                   m, noise.last)
                    m = {k: float(v) for k, v in m.items()}
                    step_metrics.append(m)
                    elbos.append(m["elbo"])
                    losses.append(m["recon"])
        utils.check_finite(elbos, state.step, ckpt_state, run_dir)
        print(f"epoch {epoch}: mean ELBO/batch {np.mean(elbos):.3f}, train "
              f"MSE {np.sum(losses) / N_train:.5f}, "
              f"{time.perf_counter() - t_epoch:.2f}s")
        if savers:
            write_epoch_rows(args, savers, state, forward, metrics_batch,
                             metrics_fpc)

        plateau = False
        if (epoch + 1) % args.eval_every == 0:
            if run_dir and is_svgpvae:
                gp = params["gp"]
                np.savez(os.path.join(run_dir, "res",
                                      f"gp_params_{state.step}.npz"),
                         gplvm_action=gp.gplvm_action.detach().cpu().numpy(),
                         inducing_points=gp.inducing_points.detach().cpu()
                         .numpy())
            ev, recon_images, cgen_images = eval_pass(epoch)
            evals.append(ev)
            print(f"  test recon MSE: {ev['test_mse']:.5f}")
            draw(pictures, run_dir, f"{state.step}_recon", "recon",
                 plots.plot_image_grid, tc_last_frames, recon_images,
                 f"epoch {epoch + 1}. recon MSE {ev['test_mse']:.4f}")
            if is_svgpvae:
                cgen_history.append(ev["cgen_mse"])
                print(f"  cgen test MSE: {ev['cgen_mse']:.5f}")
                plateau = (attempt < args.basin_retry
                           and len(cgen_history) == args.basin_detect_evals
                           and min(cgen_history) > (1 - args.basin_detect_rel)
                           * cgen_history[0])
                if run_dir:
                    write_eval_outputs(run_dir, epoch, ev, *cgen_images,
                                       ev["cgen_mse"] <= min(cgen_history))
                pics, tgts = cgen_images
                draw(pictures, run_dir, f"{state.step}_cgen", "cgen",
                     plots.plot_image_grid, tgts, pics,
                     f"epoch {epoch + 1}. CGEN MSE {ev['cgen_mse']:.4f}")
            print("  eval seconds: " + ", ".join(
                f"{k} {v:.3f}" for k, v in ev["seconds"].items()))
            if run_dir and args.save_model_weights:
                save_checkpoint()
            if on_eval is not None:
                on_eval(ev)
        epoch += 1
        if plateau:
            attempt += 1
            print(f"basin detector: cgen has not descended "
                  f"{args.basin_detect_rel:.0%} from its first eval "
                  f"({cgen_history[0]:.5f} -> best {min(cgen_history):.5f}) "
                  f"after {len(cgen_history)} evals; restarting the main "
                  f"loop (attempt {attempt}/{args.basin_retry}) on a new "
                  "noise stream")
            with torch.no_grad():
                for k, v in train.named_tensors(params).items():
                    v.copy_(host_copy[k])
            state = fresh_state()
            noise.eps_fn = stream(attempt)
            if shuffle is not None:
                shuffle.generator.manual_seed(_stream_seed(args, attempt))
            cgen_history, epoch = [], 0
            if graphs is not None:  # the graphs hold the old optimizer
                # keep their counts, free their memory pool
                retired = graph_record([graphs], retired)
                graphs = epoch_fn = None
                graphs, epoch_fn = epoch_graphs()

    elapsed = time.perf_counter() - t_start
    if chunks:
        later = [e["seconds"] / e["steps"] for e in chunks[1:]]
        first = chunks[0]
        print(f"total: {len(step_seconds)} steps in {len(chunks)} "
              f"replayed epochs, {elapsed:.1f}s; the first epoch "
              f"{first['seconds']:.2f} s ({first['steps']} steps), "
              + (f"then per step (epoch seconds / steps) p50 "
                 f"{1e3 * float(np.percentile(later, 50)):.3f} ms"
                 if later else "no later epoch"))
    elif step_seconds:
        timed = step_seconds[1:] or step_seconds
        print(f"total: {len(step_seconds)} steps, {elapsed:.1f}s; step time "
              f"first {1e3 * step_seconds[0]:.2f} ms, p50 "
              f"{1e3 * float(np.percentile(timed, 50)):.2f} ms, p90 "
              f"{1e3 * float(np.percentile(timed, 90)):.2f} ms")
    tracer.report()
    if run_dir and args.save_model_weights:
        save_checkpoint()
    result = {"state": state, "pretrain": pre, "step_seconds": step_seconds,
              "metrics": step_metrics, "step_launches": step_launches,
              "evals": evals, "pictures": pictures, "captured": captured,
              "basin_attempts": attempt,
              "cgen_mse": evals[-1].get("cgen_mse") if evals else None,
              "run_dir": run_dir, "noise": noise, "shuffle": shuffle,
              "chunks": chunks, "test_recon": recon_images,
              "cgen_images": cgen_images,
              **graph_record([graphs], retired)}
    # the eval calls' graphs: each one's replays, the launches of one
    eval_graphs = {k: c.graph for k, c in eval_calls.items()
                   if isinstance(c, capture.CapturedCall) and c.graph}
    result["eval_graph_replays"] = {k: g.replays
                                    for k, g in eval_graphs.items()}
    result["eval_graph_launches"] = {k: g.launches
                                     for k, g in eval_graphs.items()}
    if is_svgpvae and evals:
        best = min(evals, key=lambda e: e["cgen_mse"])
        print(f"best cgen MSE {best['cgen_mse']:.5f} at epoch "
              f"{best['epoch']}")
        result["best_cgen_mse"] = best["cgen_mse"]
    return result


ELBO_COLUMNS = ["step", "ELBO", "recon_loss", "KL_term", "min_qm", "max_qm",
                "min_qv", "max_qv", "inside_elbo", "inside_elbo_recon",
                "inside_elbo_kl", "ce_term", "min_pm", "max_pm", "min_pv",
                "max_pv", "C_ma", "lagrange_mult"]
GP_COLUMNS = ["step", "gplvm_norm", "ip_norm", "l_action", "sigma_action",
              "l_character", "sigma_character"]


def graph_record(steps: list, before: Optional[dict] = None) -> dict:
    """{"graph_replays", "graph_launches", "graph_all_reduces"} of the
    runs' GraphSteps (None for a per-step loop), added to the record
    `before` of the earlier --basin_retry attempts: each graph's replays
    (summed over the attempts), and the kernel launches and all-reduces
    of one replay."""
    keys = ("graph_replays", "graph_launches", "graph_all_reduces")
    replays, launches, reduces = (dict(before[k]) if before else {}
                                  for k in keys)
    for st in steps:
        for k, g in (st.graphs.items() if st is not None else ()):
            replays[k] = replays.get(k, 0) + g.replays
            launches[k] = g.launches
            reduces[k] = g.all_reduces
    return dict(zip(keys, (replays, launches, reduces)))


@torch.no_grad()
def write_epoch_rows(args, savers: dict, state, forward, batch,
                     frames_per_char: int = FRAMES_PER_CHAR) -> None:
    """The JAX CLI's per-epoch metric rows: the forward pass on `batch`
    (whole characters of `frames_per_char` frames) with the eval noise,
    and the GP's norms and kernel scalars (the VAE's: its eight columns,
    no GP row)."""
    out = forward(state.params, batch, state.geco, args.alpha, "eval",
                  frames_per_char)
    row = [out.elbo, out.recon_loss, out.kl_term, out.qnet_mu.min(),
           out.qnet_mu.max(), out.qnet_var.min(), out.qnet_var.max()]
    if "gp" not in savers:
        savers["elbo"]([state.step] + [float(x) for x in row])
        return
    savers["elbo"]([state.step] + [float(x) for x in row + [
        out.inside_elbo, out.inside_elbo_recon, out.inside_elbo_kl,
        out.ce_term, out.p_m.min(), out.p_m.max(), out.p_v.min(),
        out.p_v.max(), state.geco.C_ma, state.geco.lagrange_mult]])
    gp = state.params["gp"]
    savers["gp"]([state.step] + [float(x) for x in (
        torch.linalg.norm(gp.gplvm_action),
        torch.linalg.norm(gp.inducing_points), gp.l_action, gp.sigma_action,
        gp.l_character, gp.sigma_character)])


def write_eval_outputs(run_dir: str, epoch: int, ev: dict, pics, tgts,
                       best: bool) -> None:
    """pics/test_metrics.txt's line, and at the best cgen so far the last
    test batch's cgen images and targets."""
    if best:
        for name, x in (("cgen_images.p", pics),
                        ("cgen_images_target.p", tgts)):
            with open(os.path.join(run_dir, name), "wb") as f:
                pickle.dump(host_array(x), f)
    with open(os.path.join(run_dir, "pics", "test_metrics.txt"), "a") as f:
        f.write(f"{epoch + 1},{round(ev['test_mse'], 4)},"
                f"{round(ev['cgen_mse'], 4)}\n")


def _snapshot(state, batch) -> dict:
    """Copies of what a step starts from."""
    return {"step": state.step, "batch": batch,
            "params": {k: v.detach().clone() for k, v in
                       train.named_tensors(state.params).items()},
            "geco": train.GECOState(C_ma=state.geco.C_ma.clone(),
                                    lagrange_mult=state.geco.lagrange_mult
                                    .clone())}


def _finish_capture(snap, state, trainable, metrics, eps) -> dict:
    snap["eps"] = eps.clone()
    snap["grads"] = {k: t.grad.detach().clone()
                     for k, t in trainable.items()}
    snap["loss"] = metrics["loss"]
    snap["geco_after"] = train.GECOState(
        C_ma=state.geco.C_ma.clone(),
        lagrange_mult=state.geco.lagrange_mult.clone())
    return snap


if __name__ == "__main__":
    main()
