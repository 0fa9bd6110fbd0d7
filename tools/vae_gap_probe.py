"""Split the MNIST VAE's port-vs-JAX quality gap (tools/baselines_gate.py's
vae run) into its initialisation and its noise.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tools/vae_gap_probe.py \
        --make tree_check/vae_probe [--seeds 0 1]
    PYTHONPATH=. python3 tools/vae_gap_probe.py --run tree_check/vae_probe \
        [--seeds 0 1] [--out FILE]

--make (on a CPU with jax): the JAX driver's initial MnistVAE parameters
of each seed (flax init from split(PRNGKey(seed))[1]) as flat .npz, and
its training draws (step t: normal(split of the state key, (b, 16)), for
baselines_gate.py's 20 epochs of 31 batches of 256 and the tail of 164)
as one float32 .npy per seed.

--run (on the card, or --device cpu): the gate's vae run (--elbo VAE
--clip_qs, 20 epochs, eval every 5, the seed-0 36-digit set) through
cli.mnist.main four ways per seed: the port's own init and noise (the
gate's run), JAX's init and draws (the JAX CLI's run, replayed), and the
two crossings (--draws port: the port's draws only, with either init).
The eval draws are the port's in every variant (JAX's eval key is one
fixed key per batch, as the port's).  Prints the test MSE at every eval
per variant; the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np

EPOCHS, BS, L, N_TRAIN = 20, 256, 16, 8_100
ARGV = ["--elbo", "VAE", "--clip_qs", "--nr_epochs", str(EPOCHS),
        "--eval_every", "5", "--dataset", "36"]


def make(path: str, seeds) -> None:
    import jax
    import jax.numpy as jnp
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from export_jax_params import flatten_params
    from svgpvae_tpu import nn as jnets

    os.makedirs(path, exist_ok=True)
    sizes = [BS] * (N_TRAIN // BS) + [N_TRAIN % BS]
    for seed in seeds:
        key, init_key = jax.random.split(jax.random.PRNGKey(seed))
        p = jnets.MnistVAE(L=L).init(init_key, jnp.zeros((2, 28, 28, 1)))
        np.savez(os.path.join(path, f"init{seed}.npz"),
                 **flatten_params({"vae": p}))
        draws = []
        for _ in range(EPOCHS):
            for b in sizes:
                key, sub = jax.random.split(key)
                draws.append(np.asarray(jax.random.normal(sub, (b, L))))
        np.save(os.path.join(path, f"noise{seed}.npy"),
                np.concatenate(draws).astype(np.float32))
        print(f"seed {seed}: init and {len(draws)} draws written")


def run(path: str, seeds, device: str, out, draw_kinds) -> None:
    import torch
    from svgpvae_tpu_torch import data
    from svgpvae_tpu_torch.cli import mnist

    if device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    base = data.synthetic_digit_base_images("36", per_digit=400, seed=0)
    splits = data.generate_rotated_mnist(base, None, digits="36", seed=0)
    dev = torch.device(device)
    results = []
    for seed in seeds:
        noise = torch.from_numpy(np.load(os.path.join(
            path, f"noise{seed}.npy"))).to(dev)
        for init in ("port", "jax"):
            for draws in draw_kinds:
                own = mnist.default_eps_fn(seed, dev)
                at = [0]

                def eps_fn(kind, shape, own=own, at=at, draws=draws):
                    if kind != "train" or draws == "port":
                        return own(kind, shape)
                    lo = at[0]
                    at[0] += shape[0]
                    return noise[lo:at[0]]
                argv = ARGV + ["--seed", str(seed), "--device", device]
                if init == "jax":
                    argv += ["--params", os.path.join(path,
                                                      f"init{seed}.npz")]
                with contextlib.redirect_stdout(io.StringIO()):
                    res = mnist.main(argv, splits=splits, eps_fn=eps_fn)
                r = {"seed": seed, "init": init, "draws": draws,
                     "test_mse": [e["test_mse"] for e in res["evals"]]}
                print(json.dumps(r), flush=True)
                results.append(r)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=1)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--make", type=str)
    g.add_argument("--run", type=str)
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--draws", nargs="+", default=["port", "jax"],
                   choices=["port", "jax"],
                   help="--run: whose training draws (both by default)")
    args = p.parse_args(argv)
    if args.make:
        make(args.make, args.seeds)
    else:
        run(args.run, args.seeds, args.device, args.out, args.draws)
    return 0


if __name__ == "__main__":
    sys.exit(main())
