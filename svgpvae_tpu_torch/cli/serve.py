"""Serve conditional generation with the PyTorch port: from a trained run
(rotated MNIST or SPRITES), or SPRITES from given or seeded weights.

    # a run of cli.mnist or cli.sprites trained with --save
    # --save_model_weights
    python -m svgpvae_tpu_torch.cli.serve --run_dir <run dir> \
        [--out preds.npz] [--queries aux.npy] [--limit 64] [--mean] \
        [--device cuda]

    # the SPRITES corpus, weights from --params or --seed
    python -m svgpvae_tpu_torch.cli.serve --synthetic --synthetic_chars 1000 \
        --device cuda [--params params.npz] [--n_requests 8] [--mean]

From a run (as svgpvae_tpu/cli/serve.py): `load_predictor(run_dir)` reads
args.json, rebuilds the run's models and trainable set, restores the
latest checkpoint's parameters, loads the data the run used (its pickles
or shards, or the synthetic data regenerated from args.json's flags),
encodes the train split in chunks and runs `serving.fit`, which folds the
full-train-set GP conditioning into posterior terms (B3
`fused_kernel_stats` on a CUDA device, either family).  The queries are
the rows of --queries, or the demo: MNIST's test split (held-out angles,
the first --limit rows), SPRITES's first unseen character (its first
N_context frames in, the remaining actions out).  Writes the images,
p_m, p_v and aux queries to --out and prints the demo's cgen MSE.

--data_parallel N (0 off, -1 every visible device) shards the fit, as
the JAX serve does: N ranks, one process each, encode the train split
alike, then each fits its contiguous share of the N rows (B3, or B2
under --K_SE) and the (L, m, m) / (L, m) sums are added across ranks
before the replicated solves.  When the ranks do not divide the rows the
fit runs unsharded, with the JAX serve's warning.  Rank 0 alone prints
and writes --out.

Without --run_dir (SPRITES only): encode every train frame and build the
character auxiliary data -> `serving.fit` -> one request per unseen
character. Prints the cgen MSE. Weights come from `--params` (an .npz of
the JAX parameters written by tools/export_jax_params.py) or, without it,
flax's initialisation, drawn from a torch.Generator seeded by `--seed`;
the GP parameters are then drawn from RandomState(seed) exactly as the JAX
serve entry point draws them. TF32 is switched off for matmuls and cuDNN:
the GP math and the encodings it conditions on need IEEE fp32.

On a CUDA device the encode chunks and the requests replay captured CUDA
graphs, one per input shape (JAX jits the chunk encoder and `predict`):
a chunk's frames and action ids, or a request's context frames and
target action ids (SPRITES) or aux queries (MNIST, --run_dir), are
copied into the graph's static buffers before each replay; the request
graph registers the serve's seeded generator, so each replay draws the
noise an eager request would.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from svgpvae_tpu_torch import (data, models, ops, parallel, serving, train,
                               utils)
from svgpvae_tpu_torch import gp as gpm
from svgpvae_tpu_torch.nn import SpritesReprNet, SpritesVAE
from svgpvae_tpu_torch.train import capture
from svgpvae_tpu_torch.utils.convert import params_from_jax

N_ACTIONS = data.N_ACTIONS
FRAMES_PER_CHAR = 50   # train frames per character
ENCODE_CHUNK = 500     # frames per encoder call (a multiple of 50)
MNIST_ENCODE_CHUNK = 512
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
                   help="serve the first N unseen characters; with "
                        "--run_dir, serve the query set N times (--out "
                        "holds the first)")
    p.add_argument("--mean", action="store_true",
                   help="decode the posterior mean instead of sampling")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--run_dir", type=str, default=None,
                   help="run directory with ckpt/ and args.json (train with "
                        "--save --save_model_weights): serve that run")
    p.add_argument("--out", type=str, default="preds.npz",
                   help="--run_dir: output npz of images, p_m, p_v, "
                        "aux_query")
    p.add_argument("--limit", type=int, default=64,
                   help="--run_dir: serve at most this many test-split "
                        "queries (the MNIST demo)")
    p.add_argument("--queries", type=str, default=None,
                   help="--run_dir: .npy of (x, D) auxiliary-data query rows;"
                        " default: the demo queries")
    p.add_argument("--data_parallel", type=int, default=0,
                   help="shard the O(N) train-set conditioning (fit) over "
                        "N ranks (-1: every visible device)")
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
    gen = torch.Generator().manual_seed(args.seed)
    vae = SpritesVAE(L=args.L, generator=gen)
    repr_net = SpritesReprNet(L=args.L_character, generator=gen)
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


def uncaptured_reason(device: torch.device) -> Optional[str]:
    """Why the serve's encode chunks and requests run without CUDA graphs
    here, or None: on a CUDA device each replays a captured graph, one per
    input shape (no collective runs inside them, so a data-parallel run
    captures them as a 1-process run does)."""
    if device.type != "cuda":
        return f"a {device.type} device"
    return None


@torch.no_grad()
def encode_train(vae, repr_net, frames: np.ndarray, action_ids: np.ndarray,
                 device: torch.device, clip_qs: bool = True,
                 captured: bool = False):
    """(means, variances, aux, the chunks' capture.CallPerShape) over the
    whole train split, in chunks of ENCODE_CHUNK frames; with `captured`
    one captured CUDA graph per chunk shape (JAX's one jitted program
    reused per chunk shape)."""
    def chunk(im, ids):
        mu, var = models.batching_encode_svgpvae(vae, im, clip_qs=clip_qs)
        return mu, var, models.sprites_aux_data(repr_net, im, ids,
                                                FRAMES_PER_CHAR)

    call = capture.CallPerShape(chunk, device, captured=captured)
    outs = [call(frames[lo:lo + ENCODE_CHUNK],
                 action_ids[lo:lo + ENCODE_CHUNK])
            for lo in range(0, len(frames), ENCODE_CHUNK)]
    return (*(torch.cat(x) for x in zip(*outs)), call)


def graph_record(**calls) -> dict:
    """{"graph_replays", "graph_launches"} of the serve's calls (name:
    capture.CallPerShape), each captured graph named
    "<name>:<input shapes>"."""
    graphs = {f"{name}:{[list(s) for s, _ in key]}": g
              for name, per_shape in calls.items()
              for key, g in per_shape.graphs.items()}
    return {"graph_replays": {k: g.replays for k, g in graphs.items()},
            "graph_launches": {k: g.launches for k, g in graphs.items()}}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_fit(gp, means, variances, aux, device) -> tuple:
    """(predictor, seconds, kernel launches inside `serving.fit`)."""
    ranks = parallel.run_ranks()
    if len(means) % ranks:
        print(f"warning: N={len(means)} does not tile {ranks} devices; "
              "running the fit unsharded")
    parallel.barrier()  # the fit's seconds start when every rank is there
    before = ops.launch_counts()
    t0 = time.perf_counter()
    predictor = serving.fit(gp, means, variances, aux)
    _sync(device)
    seconds = time.perf_counter() - t0
    return predictor, seconds, {k: v - before[k]
                                for k, v in ops.launch_counts().items()}


def _load_args(run_dir: str) -> argparse.Namespace:
    """The run's flags (args.json); refuses a run of another --elbo."""
    with open(os.path.join(run_dir, "args.json")) as f:
        args = argparse.Namespace(**json.load(f))
    if "SVGPVAE" not in args.elbo:
        raise SystemExit(f"serving takes the SVGPVAE runs, not --elbo "
                         f"{args.elbo}")
    return args


def _restore(run_dir: str, params: dict, predicate, args, device) -> int:
    """Rebuild the run's TrainState (its trainable set, Adam) around
    `params` and restore the latest checkpoint into it; returns its step."""
    ckpt_dir = os.path.join(run_dir, "ckpt")
    if utils.latest_step(ckpt_dir) is None:
        raise SystemExit(f"no checkpoint under {ckpt_dir}; train with "
                         "--save --save_model_weights first")
    state = train.TrainState(
        params=params, geco=train.GECOState.init(device=device),
        optimizer=train.make_optimizer(
            train.trainable_tensors(params, predicate), args.lr))
    state.load_state_dict(utils.restore_checkpoint(ckpt_dir)["train_state"])
    for t in train.named_tensors(params).values():
        t.requires_grad_(False)
    print(f"restored {ckpt_dir} at step {state.step}")
    return state.step


def _rebuild_args(args) -> argparse.Namespace:
    """The run's flags for rebuilding its models: no --params (the
    checkpoint holds the weights), no --PCA, which only sets initial
    values the checkpoint overwrites (on SPRITES it would decompose the
    whole train split), and fp32 nets whatever precision the run trained
    in (--bf16, --bf16_hybrid: its parameters are fp32), as the JAX serve
    builds them."""
    return argparse.Namespace(**dict(vars(args), params=None, PCA=False,
                                     bf16=False, bf16_hybrid=False))


def load_mnist_predictor(run_dir: str, device: torch.device,
                         splits: dict = None, captured: bool = False
                         ) -> dict:
    """Rebuild and restore a cli.mnist SVGPVAE run and fit the predictor
    on its train split, encoded in chunks of MNIST_ENCODE_CHUNK images
    (with `captured` one captured CUDA graph per chunk shape).  `splits`
    (as data.generate_rotated_mnist returns) skips loading or
    regenerating the data.  Returns {"predictor", "vae", "test", "args",
    "step", "means", "variances", "aux", "seconds", "fit_launches",
    "encode_calls" (the chunks' capture.CallPerShape)}."""
    from svgpvae_tpu_torch.cli import mnist as mnist_cli

    args = _load_args(run_dir)
    if splits is None:
        splits = mnist_cli.load_splits(args)
    train_d = splits["train"]
    N_train = (len(train_d["images"]) if args.N_t is None
               else len(str(args.dataset)) * 4050)
    vae, gp = mnist_cli.build_model(_rebuild_args(args), splits, N_train,
                                    device)
    step = _restore(run_dir, {"vae": vae, "gp": gp},
                    mnist_cli.trainable_predicate(args), args, device)

    t0 = time.perf_counter()
    images = torch.as_tensor(train_d["images"], dtype=torch.float32,
                             device=device)
    aux = torch.as_tensor(train_d["aux_data"], dtype=torch.float32,
                          device=device)
    call = capture.CallPerShape(
        torch.no_grad()(lambda im: models.batching_encode_svgpvae(
            vae, im, clip_qs=args.clip_qs)), device, captured=captured)
    enc = [call(images[lo:lo + MNIST_ENCODE_CHUNK])
           for lo in range(0, len(images), MNIST_ENCODE_CHUNK)]
    means = torch.cat([e[0] for e in enc])
    variances = torch.cat([e[1] for e in enc])
    _sync(device)
    t_encode = time.perf_counter() - t0
    predictor, t_fit, launches = _timed_fit(gp, means, variances, aux,
                                            device)
    return {"predictor": predictor, "vae": vae.eval(), "test": splits["test"],
            "args": args, "step": step, "means": means,
            "variances": variances, "aux": aux,
            "seconds": {"encode": t_encode, "fit": t_fit},
            "fit_launches": launches, "encode_calls": call}


def load_sprites_predictor(run_dir: str, device: torch.device,
                           splits: dict = None, captured: bool = False
                           ) -> dict:
    """Rebuild and restore a cli.sprites SVGPVAE run and fit the predictor
    on its train split (encode_train, captured with `captured`).
    `splits` (as data.generate_synthetic_sprites returns) skips the
    corpus on disk.  Returns {"predictor", "vae", "repr_net",
    "test_character", "args", "step", "means", "variances", "aux",
    "seconds", "fit_launches", "encode_calls"}."""
    from svgpvae_tpu_torch.cli import sprites as sprites_cli

    args = _load_args(run_dir)
    if splits is None:
        sprites_cli.ensure_dataset(args)
        splits = data.load_sprites(args.sprites_data_path)
    train_d = splits["train"]
    params, _ = sprites_cli.build_model(_rebuild_args(args), splits,
                                        len(train_d["frames"]), device)
    step = _restore(run_dir, params, sprites_cli.trainable_predicate(args),
                    args, device)
    vae, repr_net = params["vae"].eval(), params["repr"].eval()

    t0 = time.perf_counter()
    means, variances, aux, per_shape = encode_train(
        vae, repr_net, train_d["frames"],
        np.ascontiguousarray(train_d["aux_data"][:, 1]), device,
        clip_qs=args.clip_qs, captured=captured)
    _sync(device)
    t_encode = time.perf_counter() - t0
    predictor, t_fit, launches = _timed_fit(params["gp"], means, variances,
                                            aux, device)
    return {"predictor": predictor, "vae": vae, "repr_net": repr_net,
            "test_character": splits["test_character"], "args": args,
            "step": step, "means": means, "variances": variances, "aux": aux,
            "seconds": {"encode": t_encode, "fit": t_fit},
            "fit_launches": launches, "encode_calls": per_shape}


def load_predictor(run_dir: str, device: torch.device,
                   splits: dict = None, captured: bool = False) -> dict:
    """Dispatch on the run's args.json (the SPRITES or the MNIST driver's
    flags)."""
    if hasattr(_load_args(run_dir), "sprites_data_path"):
        return load_sprites_predictor(run_dir, device, splits, captured)
    return load_mnist_predictor(run_dir, device, splits, captured)


def serve_run(args, device: torch.device, splits: dict = None,
              why: Optional[str] = None) -> dict:
    """--run_dir: load the run's predictor, serve the queries
    --n_requests times (each request draws afresh; --out holds the
    first), write --out.  Unless `why` says why not, the encode chunks and
    the request each replay a captured CUDA graph per input shape.
    Returns the metrics, and under "state" the encodings, aux data,
    predictor and the served (aux_query, images, p_m, p_v) of each
    request."""
    captured = why is None
    loaded = load_predictor(args.run_dir, device, splits, captured)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    request = serving.make_request_fn(
        loaded["predictor"], loaded["vae"], device, sample=not args.mean,
        generator=generator, captured=captured)
    truth = None
    if args.queries:
        aux_q = np.load(args.queries).astype(np.float32)
    elif "test" in loaded:  # MNIST demo: held-out-angle rows
        test = loaded["test"]
        aux_q = np.asarray(test["aux_data"][:args.limit], np.float32)
        truth = torch.as_tensor(test["images"][:args.limit],
                                dtype=torch.float32, device=device)
    else:  # SPRITES demo: the first unseen character
        tc = loaded["test_character"]
        frames = torch.from_numpy(tc["frames"][:N_ACTIONS]).to(device)
        n_ctx = loaded["args"].N_context
        aux_q = sprites_query_aux(loaded["repr_net"], frames[:n_ctx],
                                  tc["aux_data"][n_ctx:N_ACTIONS, 1])
        truth = frames[n_ctx:]
    served, t_requests = [], []
    for _ in range(args.n_requests):
        t0 = time.perf_counter()
        out = dict(zip(("aux_query", "images", "p_m", "p_v"),
                       request(aux_q)))
        _sync(device)
        t_requests.append(time.perf_counter() - t0)
        served.append(out)
    out = served[0]
    if parallel.is_writer():
        np.savez(args.out, **{k: out[k].cpu().numpy() for k in (
            "images", "p_m", "p_v", "aux_query")})
    sec = dict(loaded["seconds"], predict=t_requests[0],
               requests=t_requests)
    print(f"encode {len(loaded['means'])} rows: {sec['encode']:.3f} s; fit: "
          f"{sec['fit']:.3f} s; predict {len(aux_q)} queries: "
          f"{1e3 * t_requests[0]:.2f} ms"
          + (f", request p50 {1e3 * float(np.median(t_requests)):.2f} ms "
             f"over {len(t_requests)}" if len(t_requests) > 1 else "")
          + ("" if captured else f" (uncaptured: {why})"))
    result = {"n_queries": len(aux_q), "seconds": sec,
              "fit_launches": loaded["fit_launches"], "step": loaded["step"],
              "state": {k: loaded[k] for k in ("means", "variances", "aux",
                                               "predictor")},
              **graph_record(encode=loaded["encode_calls"],
                             request=request)}
    result["state"]["served"] = served
    if truth is not None:
        K = truth.shape[1] * truth.shape[2]
        result["cgen_mse"] = float(torch.sum((truth - out["images"]) ** 2)
                                   ) / (K * len(truth))
        print(f"cgen MSE over {len(truth)} queries: "
              f"{result['cgen_mse']:.5f}")
    print(f"served {len(aux_q)} queries -> {args.out}")
    return result


def load_splits(args) -> dict:
    if args.synthetic:
        return data.generate_synthetic_sprites(
            n_train_chars=args.synthetic_chars,
            n_test_chars=max(2, args.synthetic_chars // 4),
            n_frames_train=FRAMES_PER_CHAR, seed=CORPUS_SEED)
    return data.load_sprites(args.sprites_data_path)


def main(argv=None, splits: dict = None, eager: bool = False) -> dict:
    """Run the serve; `splits` (the run's data with --run_dir, else as
    data.generate_synthetic_sprites returns) skips loading the data.
    `eager` runs the encode chunks and the requests without CUDA graphs
    on a CUDA device (the card's yardstick of the graphs).  Returns the
    metrics and, under "state", the encodings, aux data, predictor and
    the served (aux_query, images, p_m, p_v), under "fit_launches" the
    kernel launches made inside `serving.fit`, and under "graph_replays"
    and "graph_launches" those of each captured graph ("encode:<chunk
    shapes>", "request:<input shapes>")."""
    args = build_parser().parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device")
    ranks = parallel.resolve_data_parallel(args.data_parallel, 0,
                                           args.device)
    if parallel.needs_launch(ranks):
        kw = {} if splits is None else {"splits": splits}
        return parallel.launch("svgpvae_tpu_torch.cli.serve", argv,
                               dict(kw, eager=True) if eager else kw,
                               ranks, args.device)
    with parallel.active(ranks):
        device = parallel.device(args.device)
        if ranks > 1:
            print(f"sharding fit over {ranks} ranks")
        return _main(args, device, splits, eager)


def _main(args, device, splits, eager=False):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN (the GP math needs IEEE fp32)")
    why = "main(eager=True)" if eager else uncaptured_reason(device)
    if args.run_dir:
        return serve_run(args, device, splits, why)

    if splits is None:
        splits = load_splits(args)
    train_d, test_c = splits["train"], splits["test_character"]
    n_chars = len(test_c["frames"]) // N_ACTIONS
    if args.n_requests > n_chars:
        raise ValueError(f"--n_requests {args.n_requests} > {n_chars} unseen "
                         "characters in the corpus")
    vae, repr_net, gp = build_model(args, device)

    captured = why is None
    print("encode chunks and requests: " + (
        "each input shape replays a captured CUDA graph" if captured
        else f"uncaptured ({why})"))
    t0 = time.perf_counter()
    means, variances, aux, encode_calls = encode_train(
        vae, repr_net, train_d["frames"],
        np.ascontiguousarray(train_d["aux_data"][:, 1]), device,
        captured=captured)
    _sync(device)
    t_encode = time.perf_counter() - t0

    predictor, t_fit, fit_launches = _timed_fit(gp, means, variances, aux,
                                                device)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    # a request: the context frames and target action ids copied to the
    # device, the repr net's character vector paired with the ids, predict
    request = serving.make_request_fn(
        predictor, vae, device, sample=not args.mean, generator=generator,
        query_fn=lambda frames, ids: sprites_query_aux(repr_net, frames,
                                                       ids),
        captured=captured)
    sq_err, n_queries, t_requests, served = 0.0, 0, [], []
    for c in range(args.n_requests):
        block = slice(c * N_ACTIONS, (c + 1) * N_ACTIONS)
        frames = test_c["frames"][block]
        aids = np.asarray(test_c["aux_data"][block, 1], np.float32)
        t0 = time.perf_counter()
        aux_q, images, p_m, p_v = request(frames[:args.N_context],
                                          aids[args.N_context:])
        _sync(device)
        t_requests.append(time.perf_counter() - t0)
        truth = torch.as_tensor(frames[args.N_context:], device=device)
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
                      "predictor": predictor, "served": served},
            **graph_record(encode=encode_calls, request=request)}


if __name__ == "__main__":
    main()
