"""Serve SPRITES conditional generation with the PyTorch port.

    python -m svgpvae_tpu_torch.cli.serve --synthetic --synthetic_chars 1000 \
        --device cuda [--params params.npz] [--n_requests 8] [--mean]

Flow (as svgpvae_tpu/cli/serve.py for SPRITES): encode every train frame
and build the character auxiliary data -> `serving.fit` folds the
full-train-set GP conditioning into posterior terms (CUDA kernels on a
CUDA device) -> one request per unseen character: its first `--N_context`
frames in, the remaining actions out.  Prints the cgen MSE.

Weights come from `--params` (an .npz of the JAX parameters written by
tools/export_jax_params.py) or, without it, from a torch initialisation
seeded by `--seed`; the GP parameters are then drawn from
RandomState(seed) exactly as the JAX serve entry point draws them.
TF32 is switched off for matmuls and cuDNN: the GP math and the encodings
it conditions on need IEEE fp32.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from svgpvae_tpu_torch import data, models, ops, serving
from svgpvae_tpu_torch import gp as gpm
from svgpvae_tpu_torch.nn import SpritesReprNet, SpritesVAE
from svgpvae_tpu_torch.utils.convert import params_from_jax

N_ACTIONS = data.N_ACTIONS
FRAMES_PER_CHAR = 50   # train frames per character
ENCODE_CHUNK = 500     # frames per encoder call (a multiple of 50)
CORPUS_SEED = 0        # default --corpus_seed of svgpvae_tpu/cli/sprites.py


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Serve SPRITES conditional generation (PyTorch port)")
    p.add_argument("--sprites_data_path", type=str, default="SPRITES_data/")
    p.add_argument("--synthetic", action="store_true",
                   help="generate the synthetic corpus in memory")
    p.add_argument("--synthetic_chars", type=int, default=12)
    p.add_argument("--params", type=str, default=None,
                   help=".npz of flat JAX parameters "
                        "(tools/export_jax_params.py)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--L", type=int, default=64)
    p.add_argument("--L_action", type=int, default=8)
    p.add_argument("--L_character", type=int, default=16)
    p.add_argument("--m", type=int, default=1,
                   help="character vectors per action for inducing points")
    p.add_argument("--jitter", type=float, default=0.01)
    p.add_argument("--N_context", type=int, default=36)
    p.add_argument("--object_kernel_normalize", action="store_true")
    p.add_argument("--K_SE", action="store_true",
                   help="SE x SE GP kernel (fit through gp_sufficient_stats)")
    p.add_argument("--n_requests", type=int, default=1,
                   help="serve the first N unseen characters")
    p.add_argument("--mean", action="store_true",
                   help="decode the posterior mean instead of sampling")
    p.add_argument("--device", type=str, default="cuda")
    return p


def sprites_query_aux(repr_net, context_frames: torch.Tensor,
                      target_action_ids) -> torch.Tensor:
    """Aux-data queries for ONE unseen character: embed its context frames,
    mean-pool to the character vector, pair with the requested action ids."""
    with torch.no_grad():
        emb = repr_net(context_frames)  # (n_ctx, d)
    char_vec = emb.mean(dim=0, keepdim=True)
    tgt = torch.as_tensor(target_action_ids, dtype=emb.dtype,
                          device=emb.device)[:, None]
    return torch.cat([tgt, char_vec.expand(tgt.shape[0], -1)], dim=1)


def build_model(args, device: torch.device):
    """(vae, repr_net, gp) on `device`, from --params or from --seed."""
    torch.manual_seed(args.seed)
    vae = SpritesVAE(L=args.L)
    repr_net = SpritesReprNet(L=args.L_character)
    cfg = gpm.SVGPConfig(jitter=args.jitter,
                         K_obj_normalize=args.object_kernel_normalize)
    if args.params:
        with np.load(args.params) as z:
            port = params_from_jax(dict(z))
        vae.load_state_dict(port["vae"])
        repr_net.load_state_dict(port["repr"])
        gp = gpm.SpritesSVGP(config=cfg, L_action=args.L_action,
                             use_se_kernel=args.K_SE, **port["gp"])
        if gp.gplvm_action.shape[1] != args.L_action:
            raise ValueError(f"--L_action {args.L_action} does not match the "
                             f"GPLVM table {tuple(gp.gplvm_action.shape)}")
    else:
        rng = np.random.RandomState(args.seed)
        gplvm_init = rng.normal(0, 1.5, (N_ACTIONS, args.L_action))
        ip_init = rng.normal(0, 1.5, (N_ACTIONS * args.m,
                                      args.L_action + args.L_character))
        gp = gpm.init_sprites_svgp(ip_init, gplvm_init,
                                   L_action=args.L_action,
                                   use_se_kernel=args.K_SE, config=cfg)
    return vae.to(device).eval(), repr_net.to(device).eval(), gp.to(device)


@torch.no_grad()
def encode_train(vae, repr_net, frames: np.ndarray, action_ids: np.ndarray,
                 device: torch.device):
    """(means, variances, aux) over the whole train split, in chunks."""
    means, variances, aux = [], [], []
    for lo in range(0, len(frames), ENCODE_CHUNK):
        im = torch.from_numpy(frames[lo:lo + ENCODE_CHUNK]).to(device)
        ids = torch.from_numpy(action_ids[lo:lo + ENCODE_CHUNK]).to(device)
        mu, var = models.batching_encode_svgpvae(vae, im)
        means.append(mu)
        variances.append(var)
        aux.append(models.sprites_aux_data(repr_net, im, ids,
                                           FRAMES_PER_CHAR))
    return torch.cat(means), torch.cat(variances), torch.cat(aux)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_splits(args) -> dict:
    if args.synthetic:
        return data.generate_synthetic_sprites(
            n_train_chars=args.synthetic_chars,
            n_test_chars=max(2, args.synthetic_chars // 4),
            n_frames_train=FRAMES_PER_CHAR, seed=CORPUS_SEED)
    return data.load_sprites(args.sprites_data_path)


def main(argv=None, splits: dict = None) -> dict:
    """Run the serve; `splits` (as data.generate_synthetic_sprites returns)
    skips loading the corpus.  Returns the metrics and, under "state", the
    encodings, aux data, predictor and the served (aux_query, p_m, p_v),
    and under "fit_launches" the kernel launches made inside `serving.fit`."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN (the GP math needs IEEE fp32)")

    if splits is None:
        splits = load_splits(args)
    train_d, test_c = splits["train"], splits["test_character"]
    n_chars = len(test_c["frames"]) // N_ACTIONS
    if args.n_requests > n_chars:
        raise ValueError(f"--n_requests {args.n_requests} > {n_chars} unseen "
                         "characters in the corpus")
    vae, repr_net, gp = build_model(args, device)

    t0 = time.perf_counter()
    means, variances, aux = encode_train(
        vae, repr_net, train_d["frames"],
        np.ascontiguousarray(train_d["aux_data"][:, 1]), device)
    _sync(device)
    t_encode = time.perf_counter() - t0

    before = ops.launch_counts()
    t0 = time.perf_counter()
    predictor = serving.fit(gp, means, variances, aux)
    _sync(device)
    t_fit = time.perf_counter() - t0
    fit_launches = {k: v - before[k] for k, v in ops.launch_counts().items()}

    predict = serving.make_predict_fn(predictor, vae, sample=not args.mean)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    sq_err, n_queries, t_requests, served = 0.0, 0, [], []
    for c in range(args.n_requests):
        block = slice(c * N_ACTIONS, (c + 1) * N_ACTIONS)
        frames = torch.from_numpy(test_c["frames"][block]).to(device)
        aids = test_c["aux_data"][block, 1]
        t0 = time.perf_counter()
        aux_q = sprites_query_aux(repr_net, frames[:args.N_context],
                                  aids[args.N_context:])
        images, p_m, p_v = predict(aux_q, generator)
        _sync(device)
        t_requests.append(time.perf_counter() - t0)
        truth = frames[args.N_context:]
        sq_err += float(torch.sum((truth - images) ** 2))
        n_queries += len(truth)
        served.append({"aux_query": aux_q, "images": images, "p_m": p_m,
                       "p_v": p_v})

    K = train_d["frames"].shape[1] * train_d["frames"].shape[2]
    mse = sq_err / (K * n_queries)
    print(f"encode {len(means)} frames: {t_encode:.3f} s; fit: {t_fit:.3f} s; "
          f"request p50: {1e3 * float(np.median(t_requests)):.2f} ms")
    print(f"cgen MSE over {n_queries} queries: {mse:.5f}")
    print(f"served {args.n_requests} requests ({n_queries} queries)")
    return {"n_requests": args.n_requests, "n_queries": n_queries,
            "cgen_mse": mse,
            "seconds": {"encode": t_encode, "fit": t_fit,
                        "requests": t_requests},
            "fit_launches": fit_launches,
            "state": {"means": means, "variances": variances, "aux": aux,
                      "predictor": predictor, "served": served}}


if __name__ == "__main__":
    main()
