"""Rotated-MNIST SVGPVAE training with the PyTorch port.

    python -m svgpvae_tpu_torch.cli.mnist --elbo SVGPVAE_Hensman --GECO \
        --clip_qs --PCA --ip_joint --GP_joint --ov_joint --dataset 36 \
        --synthetic_digits --opt_regime joint-2 --eval_every 2 [--device cuda]

The flow of svgpvae_tpu/cli/mnist.py::run_svgpvae for `SVGPVAE_Hensman`
and `SVGPVAE_Titsias` (with or without --GECO): the dataset (pickles
under --mnist_data_path, generated there from the seven-segment stand-in
glyphs with
--synthetic_digits when absent), the GP initialisation (KDE inducing
points, PCA object vectors), then per epoch every full batch and the tail
batch through one training step each, and every --eval_every epochs the
eval MSE, the test MSE and the conditional-generation (cgen) MSE, whose GP
posterior conditions on the encodings of the whole train split.

Each step: conv encoder and the variance clip; the MnistSVGP kernel
matrices; the sufficient statistics (B2 `gp_sufficient_stats` kernel
forward, einsum backward); the (L+1, m, m) stack [K_mm; Sigma_1..L]; with
--gp_block_impl fused_pallas (the 'auto' choice on a CUDA device) its
inverse and logdets from the B1 `chol_inverse` kernel (two-matmul
backward); the Hensman terms, the cross-entropy, the reparameterised
sample, the conv decoder; GECO and Adam.  With SVGPVAE_Titsias the
block is gp.fused.gp_block_titsias: B2 twice (at the encoder noise and at
noise + jitter), and with fused_pallas (the 'auto' choice on a CUDA
device, as for Hensman) one B1 launch on the (33, 32, 32) stack
[K_mm; Sigma_1..16; Sigma1_1..16]; the CE term is the exact entropy
unless --titsias_reference_ce.  `--gp_block_impl` takes the JAX
driver's values, so one argv drives both; a `*_pallas` value means the
hand-written CUDA kernel B1 on a CUDA device and its plain twin on the
CPU.  'auto' resolves through models.GP_BLOCK_AUTO_TABLE.

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
args.json, and every eval pass appends to res/ELBO_results.csv and
res/GP_params.csv (the JAX columns, on the eval split's first batch),
writes res/gp_params_<step>.npz and a line of pics/test_metrics.txt;
--save_model_weights adds a checkpoint (utils.checkpoint: the whole
TrainState and the training noise generator) under ckpt/ at every eval;
at the end the last eval's cgen images go to cgen_images.p and, with
--save_latents, posterior samples of the train split's latents to
latents_train.p.  --resume_dir <run dir> restores its latest checkpoint
and runs --opt_regime's epochs from the restored step, writing into that
run dir.  The JAX driver's pictures (pics/*.png) are not written: the
port does without matplotlib, and --show_pics is refused.

Not ported yet, refused with an error: the other --elbo values, VAE
phases in --opt_regime, --bias_analysis, --epoch_chunk, --show_pics,
--test_set_metrics, --bf16, --x64, --data_parallel, --profile_dir,
--eval_bundle and --reshuffle.
"""

from __future__ import annotations

import argparse
import os
import pickle
import time
from typing import Callable, Optional

import numpy as np
import torch

from svgpvae_tpu_torch import data, models, ops, train, utils
from svgpvae_tpu_torch import gp as gpm
from svgpvae_tpu_torch.nn import MnistVAE
from svgpvae_tpu_torch.utils.convert import mnist_params_from_jax

EVAL_SEED = 7  # the JAX driver's eval key, jax.random.PRNGKey(7)


def build_parser() -> argparse.ArgumentParser:
    """The JAX driver's arguments (same names and defaults), plus
    --device and --params."""
    p = argparse.ArgumentParser(
        description="Rotated MNIST SVGPVAE training (PyTorch port)")
    p.add_argument("--expid", type=str, default="debug_MNIST")
    p.add_argument("--base_dir", type=str, default=os.getcwd())
    p.add_argument("--elbo", type=str, default="VAE",
                   choices=["VAE", "CVAE", "SVGPVAE_Hensman",
                            "SVGPVAE_Titsias", "GPVAE_Casale",
                            "GPVAE_Casale_batch", "SVIGP_Hensman"])
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
                   help="cosine-decay the lr to lr*LR_DECAY over the run")
    p.add_argument("--save_model_weights", action="store_true")
    p.add_argument("--dataset", type=str, default="3",
                   choices=["3", "36", "13679"])
    p.add_argument("--show_pics", action="store_true")
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
                   help="Casale only (not ported)")
    p.add_argument("--lr_joint", type=float, default=0.001,
                   help="Casale only (not ported)")
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
                   help=".npz of flat JAX MNIST SVGPVAE parameters "
                        "(tools/export_jax_params.py) to start from")
    return p


NOT_PORTED = {  # flag -> is it set?
    "--bias_analysis": lambda a: a.bias_analysis,
    "--epoch_chunk": lambda a: a.epoch_chunk > 1,
    "--show_pics": lambda a: a.show_pics,
    "--test_set_metrics": lambda a: a.test_set_metrics,
    "--bf16": lambda a: a.bf16,
    "--x64": lambda a: a.x64,
    "--data_parallel": lambda a: a.data_parallel != 0,
    "--profile_dir": lambda a: a.profile_dir is not None,
    "--eval_bundle": lambda a: a.eval_bundle,
    "--reshuffle": lambda a: a.reshuffle,
}
PORTED_ELBOS = ("SVGPVAE_Hensman", "SVGPVAE_Titsias")


def refuse_unported(args) -> None:
    if args.elbo not in PORTED_ELBOS:
        raise SystemExit(f"--elbo {args.elbo}: not ported yet (the port "
                         f"trains {' and '.join(PORTED_ELBOS)})")
    for flag, is_set in NOT_PORTED.items():
        if is_set(args):
            raise SystemExit(f"{flag}: not ported yet")
    if any(r == "VAE" for r in train.parse_opt_regime(args.opt_regime)[1]):
        raise SystemExit("--opt_regime: VAE phases are not ported yet")


def load_splits(args) -> dict:
    """{"train", "eval", "test", "pca_ov_init"} from the pickles under
    --mnist_data_path, generating them first with --synthetic_digits."""
    suffix = "" if args.M == 8 else f"_{args.M}"
    path = args.mnist_data_path
    if not os.path.exists(os.path.join(
            path, f"train_data{args.dataset}{suffix}.p")):
        if not args.synthetic_digits:
            raise SystemExit(
                f"no dataset pickles for '{args.dataset}' at {path}: "
                "generate them (svgpvae_tpu_torch.data.generate_rotated_mnist"
                " with real base images) or pass --synthetic_digits")
        print(f"dataset not found at {path}; generating synthetic stand-in "
              f"glyphs for digits '{args.dataset}' (--synthetic_digits)")
        base = data.synthetic_digit_base_images(args.dataset, per_digit=400,
                                                seed=args.seed)
        data.generate_rotated_mnist(base, path, digits=args.dataset,
                                    latent_dim_object_vector=args.M,
                                    seed=args.seed)
    train_d, eval_d, test_d = data.load_rotated_mnist(
        path, digits=args.dataset, M=args.M, N_t=args.N_t)
    with open(os.path.join(path, f"pca_ov_init{args.dataset}{suffix}.p"),
              "rb") as f:
        pca = pickle.load(f)
    return {"train": train_d, "eval": eval_d, "test": test_d,
            "pca_ov_init": pca}


def build_model(args, splits: dict, N_train: int, device: torch.device):
    """(MnistVAE, MnistSVGP) on `device`: the GP initialised as the JAX
    driver does; the VAE from --params or flax's init from a generator
    seeded by --seed."""
    vae = MnistVAE(L=args.L,
                   generator=torch.Generator().manual_seed(args.seed))
    ip_init = data.generate_init_inducing_points(
        splits["train"], n=args.nr_inducing_points, use_pca=args.PCA,
        M=args.M, seed=args.seed)
    ov_init = None
    if args.ov_joint:
        n_obj = len(splits["pca_ov_init"])
        ov_init = (splits["pca_ov_init"] if args.PCA else
                   np.random.RandomState(args.seed).normal(
                       0, 1.5, n_obj * args.M).reshape(n_obj, args.M))
    cfg = gpm.SVGPConfig(titsias=args.elbo == "SVGPVAE_Titsias",
                         jitter=args.jitter, N_train=N_train,
                         K_obj_normalize=args.object_kernel_normalize)
    gp = gpm.init_mnist_svgp(ip_init, ov_init, config=cfg)
    if args.params:
        with np.load(args.params) as z:
            port = mnist_params_from_jax(dict(z))
        vae.load_state_dict(port["vae"])
        if (port["gp"].get("object_vectors") is None) != (ov_init is None):
            raise ValueError("--params and --ov_joint disagree on the GPLVM "
                             "object-vector table")
        gp = gpm.MnistSVGP(config=cfg, **port["gp"])
    return vae.to(device), gp.to(device)


def trainable_predicate(args) -> Callable[[str], bool]:
    """name ("vae/...", "gp/<field>") -> trainable?  As the JAX driver's
    mask: the inducing points follow --ip_joint, the kernel scalars
    --GP_joint, the GPLVM table --ov_joint; the VAE always trains."""
    flags = {"inducing_points": args.ip_joint, "length_scale": args.GP_joint,
             "amplitude": args.GP_joint, "object_vectors": args.ov_joint}

    def predicate(name: str) -> bool:
        part, _, leaf = name.partition("/")
        return flags[leaf] if part == "gp" else True

    return predicate


def open_run_dir(args) -> Optional[str]:
    """The run's output directory: --resume_dir as it is, or with --save a
    new one (utils.make_checkpoint_folder) holding args.json; else None."""
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


def _chunks(images: torch.Tensor, aux: torch.Tensor, bs: int):
    """Full batches of `bs`, then the tail, as views."""
    for lo in range(0, len(images), bs):
        yield images[lo:lo + bs], aux[lo:lo + bs]


def default_eps_fn(seed: int, device: torch.device,
                   eval_seed: int = EVAL_SEED) -> Callable:
    """eps_fn(kind, shape): "train" draws continue one generator seeded by
    `seed`; every "eval" draw comes from a generator seeded with
    `eval_seed` (the JAX CLIs use one fixed eval key per batch)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def eps_fn(kind: str, shape) -> torch.Tensor:
        g = gen if kind == "train" else \
            torch.Generator(device=device).manual_seed(eval_seed)
        return torch.randn(shape, generator=g, device=device)

    eps_fn.generator = gen  # the "train" stream, which checkpoints keep
    return eps_fn


class Noise:
    """eps_fn that also keeps its last "train" draw."""

    def __init__(self, eps_fn: Callable):
        self.eps_fn, self.last = eps_fn, None

    @property
    def generator(self) -> Optional[torch.Generator]:
        """The "train" stream's generator (default_eps_fn's), or None for
        an injected eps_fn without one."""
        return getattr(self.eps_fn, "generator", None)

    def __call__(self, kind: str, shape) -> torch.Tensor:
        eps = self.eps_fn(kind, shape)
        if kind == "train":
            self.last = eps
        return eps


def make_forward(args, eps_fn: Callable) -> Callable:
    """forward(params, batch, geco, alpha, kind): the training forward
    pass with this run's options and `eps_fn(kind, (b, L))` noise."""
    kappa = float(np.sqrt(args.kappa_squared))

    def forward(params, batch, geco, alpha, kind):
        return models.forward_pass_svgpvae(
            params["vae"], params["gp"], batch,
            eps_fn(kind, (batch[0].shape[0], args.L)), beta=args.beta,
            C_ma=geco.C_ma, lagrange_mult=geco.lagrange_mult, alpha=alpha,
            kappa=kappa, clip_qs=args.clip_qs, geco=args.GECO,
            lagrange_max=args.geco_lambda_max,
            gp_block_impl=args.gp_block_impl, entropy_ce=args.entropy_ce,
            titsias_reference_ce=args.titsias_reference_ce)

    return forward


def make_loss_fn(args, forward: Callable) -> Callable:
    """loss_fn(params, batch, geco, step) -> (loss, (geco, metrics)) for
    train.train_step: GECO minimizes the objective, the plain objective
    maximizes the ELBO."""

    def loss_fn(params, batch, geco, step):
        out = forward(params, batch, geco,
                      train.geco_effective_alpha(step, args.alpha), "train")
        new_geco = train.GECOState(C_ma=out.C_ma,
                                   lagrange_mult=out.lagrange_mult)
        loss = out.elbo if args.GECO else -out.elbo
        metrics = {"elbo": out.elbo.detach(),
                   "recon": out.recon_loss.detach(), "C_ma": out.C_ma,
                   "lagrange": out.lagrange_mult}
        return loss, (new_geco, metrics)

    return loss_fn


def main(argv=None, splits: Optional[dict] = None,
         eps_fn: Optional[Callable] = None,
         capture_step: Optional[int] = None) -> dict:
    """Train; returns a dict (see `run_svgpvae`).

    `splits` ({"train", "eval", "test", "pca_ov_init"}, as
    data.generate_rotated_mnist returns) skips loading the dataset.
    `eps_fn(kind, shape)` ("train" or "eval") replaces the default noise
    (tests inject the JAX draws).  `capture_step` keeps a copy of that
    step's inputs, parameters before it, noise and gradients."""
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN (the GP math needs IEEE fp32)")
    if splits is None:
        splits = load_splits(args)
    elif args.N_t is not None:
        raise SystemExit("--N_t subsamples pickled data; pass the "
                         "subsampled splits instead")
    return run_svgpvae(args, splits, device,
                       eps_fn or default_eps_fn(args.seed, device),
                       capture_step)


def run_svgpvae(args, splits: dict, device: torch.device, eps_fn: Callable,
                capture_step: Optional[int]) -> dict:
    """Returns {"state", "step_seconds" (host clock after synchronize,
    per step), "metrics" (per step), "evals" (per eval pass),
    "step_launches" (kernel launches inside each step), "captured",
    "cgen_mse", "best_cgen_mse"}."""
    args.gp_block_impl = models.resolve_gp_block_impl(
        args.gp_block_impl, workload="mnist",
        titsias=args.elbo == "SVGPVAE_Titsias", device=device)
    print(f"gp_block_impl: {args.gp_block_impl}, device {device}")
    train_d, eval_d, test_d = splits["train"], splits["eval"], splits["test"]
    # as the JAX driver: N_train stays n_digits * 4050 under --N_t
    N_train = (len(train_d["images"]) if args.N_t is None
               else len(args.dataset) * 4050)
    N_eval, N_test = len(eval_d["images"]), len(test_d["images"])

    run_dir = open_run_dir(args)
    vae, gp = build_model(args, splits, N_train, device)
    params = {"vae": vae, "gp": gp}
    trainable = train.trainable_tensors(params, trainable_predicate(args))
    print(f"parameters: {utils.count_params(params)}, trainable: "
          f"{sum(t.numel() for t in trainable.values())}")
    nr_epochs, regime = train.parse_opt_regime(list(args.opt_regime))
    # the lr-decay horizon counts N_train steps, as the JAX driver does
    steps_per_epoch = -(-N_train // args.batch_size)
    state = train.TrainState(
        params=params, optimizer=train.make_optimizer(trainable, args.lr),
        geco=train.GECOState.init(device=device),
        lr_fn=train.cosine_decay_lr(args.lr, args.lr_decay,
                                    nr_epochs * steps_per_epoch))
    noise = Noise(eps_fn)
    if args.resume_dir:
        resume(args, state, noise)
    forward = make_forward(args, noise)
    loss_fn = make_loss_fn(args, forward)
    savers = {}
    if args.save and run_dir:
        savers["elbo"] = utils.ResultSaver(
            os.path.join(run_dir, "res", "ELBO_results.csv"), ELBO_COLUMNS,
            flush_every=1)
        savers["gp"] = utils.ResultSaver(
            os.path.join(run_dir, "res", "GP_params.csv"), GP_COLUMNS,
            flush_every=1)

    def to_dev(split):
        return (torch.as_tensor(split["images"], dtype=torch.float32,
                                device=device),
                torch.as_tensor(split["aux_data"], dtype=torch.float32,
                                device=device))

    train_im, train_aux = to_dev(train_d)
    eval_im, eval_aux = to_dev(eval_d)
    test_im, test_aux = to_dev(test_d)

    @torch.no_grad()
    def recon_sum(images, aux):
        # the JAX driver's "MSE": the summed recon_loss over the split
        # (under GECO the constraint sum_b(mse_b - kappa^2))
        return sum(float(forward(params, batch, state.geco, args.alpha,
                                 "eval").recon_loss)
                   for batch in _chunks(images, aux, args.batch_size))

    @torch.no_grad()
    def encode_train():
        enc = [models.batching_encode_svgpvae(vae, im, clip_qs=args.clip_qs)
               for im, _ in _chunks(train_im, train_aux, args.batch_size)]
        return (torch.cat([e[0] for e in enc]),
                torch.cat([e[1] for e in enc]))

    @torch.no_grad()
    def cgen_sum():
        """(summed cgen loss over the test split, its images)"""
        means, variances = encode_train()
        total, images = 0.0, []
        for batch in _chunks(test_im, test_aux, args.batch_size):
            recon, loss = models.predict_cgen_mnist(
                vae, gp, batch, means, variances, train_aux,
                noise("eval", (batch[0].shape[0], args.L)))
            total += float(loss)
            images.append(recon)
        return total, torch.cat(images)

    step_seconds, step_metrics, step_launches, evals = [], [], [], []
    captured = cgen_images = None
    t_start = time.perf_counter()
    for epoch in range(nr_epochs):
        t_epoch = time.perf_counter()
        elbos, losses = [], []
        for batch in _chunks(train_im, train_aux, args.batch_size):
            snap = (_snapshot(state, batch) if state.step == capture_step
                    else None)
            before = ops.launch_counts()
            t0 = time.perf_counter()
            m = train.train_step(state, batch, loss_fn)
            sync(device)
            step_seconds.append(time.perf_counter() - t0)
            after = ops.launch_counts()
            step_launches.append({k: after[k] - before[k] for k in after})
            if snap is not None:
                captured = _finish_capture(snap, state, trainable, m,
                                           noise.last)
            m = {k: float(v) for k, v in m.items()}
            step_metrics.append(m)
            elbos.append(m["elbo"])
            losses.append(m["recon"])
        if not np.all(np.isfinite(elbos)):
            raise FloatingPointError(
                f"non-finite ELBO in epoch {epoch} (step {state.step})")

        if (epoch + 1) % args.eval_every == 0:
            print(f"epoch {epoch}, regime {regime[epoch]}, mean ELBO/batch "
                  f"{np.mean(elbos):.3f}, train MSE "
                  f"{np.sum(losses) / N_train:.5f}, epoch time "
                  f"{time.perf_counter() - t_epoch:.2f}s")
            t0 = time.perf_counter()
            ev = {"epoch": epoch,
                  "eval_mse": recon_sum(eval_im, eval_aux) / N_eval,
                  "test_mse": recon_sum(test_im, test_aux) / N_test}
            sync(device)
            t1 = time.perf_counter()
            cgen_total, cgen_images = cgen_sum()
            ev["cgen_mse"] = cgen_total / N_test
            sync(device)
            ev["seconds"] = {"eval_test": t1 - t0,
                             "cgen": time.perf_counter() - t1}
            evals.append(ev)
            print(f"  eval MSE: {ev['eval_mse']:.5f}")
            print(f"  test MSE: {ev['test_mse']:.5f}")
            print(f"  cgen test MSE: {ev['cgen_mse']:.5f}")
            if run_dir:
                with open(os.path.join(run_dir, "pics", "test_metrics.txt"),
                          "a") as f:
                    f.write(f"{epoch + 1},{round(ev['test_mse'], 4)},"
                            f"{round(ev['cgen_mse'], 4)}\n")
            if savers:
                write_eval_rows(args, savers, run_dir, state, forward,
                                (eval_im[:args.batch_size],
                                 eval_aux[:args.batch_size]))
            if run_dir and args.save_model_weights:
                utils.save_checkpoint(os.path.join(run_dir, "ckpt"),
                                      checkpoint_state(state, noise),
                                      state.step)

    elapsed = time.perf_counter() - t_start
    if step_seconds:
        timed = step_seconds[1:] or step_seconds
        print(f"total: {len(step_seconds)} steps, {elapsed:.1f}s; step time "
              f"first {1e3 * step_seconds[0]:.2f} ms, p50 "
              f"{1e3 * float(np.percentile(timed, 50)):.2f} ms, p90 "
              f"{1e3 * float(np.percentile(timed, 90)):.2f} ms")
    result = {"state": state, "step_seconds": step_seconds,
              "metrics": step_metrics, "evals": evals,
              "step_launches": step_launches, "captured": captured,
              "cgen_mse": evals[-1]["cgen_mse"] if evals else None,
              "run_dir": run_dir, "noise": noise}
    if evals:
        best = min(evals, key=lambda e: e["cgen_mse"])
        print(f"best cgen MSE {best['cgen_mse']:.5f} at epoch "
              f"{best['epoch']}")
        result["best_cgen_mse"] = best["cgen_mse"]
    if run_dir and cgen_images is not None:
        with open(os.path.join(run_dir, "cgen_images.p"), "wb") as f:
            pickle.dump(cgen_images.cpu().numpy(), f)
    if run_dir and args.save_latents:
        with torch.no_grad():
            p_m, p_v, _, _ = gpm.posterior_params(gp, train_aux, train_aux,
                                                  *encode_train())
        p_m, p_v = p_m.cpu().numpy(), p_v.cpu().numpy()
        z = p_m + np.sqrt(np.maximum(p_v, 0)) * \
            np.random.RandomState(0).randn(*p_m.shape)
        with open(os.path.join(run_dir, "latents_train.p"), "wb") as f:
            pickle.dump(z, f)
    return result


ELBO_COLUMNS = ["step", "ELBO", "recon_loss", "KL_term", "min_qm", "max_qm",
                "min_qv", "max_qv", "inside_elbo", "ce_term", "min_pm",
                "max_pm", "min_pv", "max_pv", "C_ma", "lagrange_mult"]
GP_COLUMNS = ["step", "length_scale", "amplitude", "ip_norm", "ov_norm"]


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


def _snapshot(state, batch) -> dict:
    """Copies of what a step starts from."""
    vae, gp = state.params["vae"], state.params["gp"]
    return {"step": state.step, "batch": batch,
            "vae": {k: v.detach().clone()
                    for k, v in vae.state_dict().items()},
            "gp": {k: v.detach().clone()
                   for k, v in gp.named_tensors().items()},
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
