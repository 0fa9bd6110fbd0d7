"""The port's SPRITES trainer against the JAX CLI on the same weights and
noise, per step, in fp32 on the CPU.

    python tools/compare_sprites_m4_cpu.py [--seed 0] [--chars 20]
        [--L_character 16] [--opt_regime joint-1] [--m 4] [--out DIR]

Both run Hensman + GECO with `--m` x 72 inducing points on the same
synthetic corpus (`--chars` characters, batch 100, L = 8, one pretraining
epoch, `fused_rejitter_pallas`): the JAX CLI from its own initialisation
(PRNGKey(seed) for the nets, RandomState(seed) for the GP), the port from
the same parameters (`--params`) and the JAX CLI's noise (`eps_fn`).  It
prints one JSON line: each package's ELBO at every main step, any error
it raised, and its best cgen MSE.  Neither package's non-finite check
stops it: the ELBOs are recorded as they come.

At `--m 4` and the default L_character 16, K_mm (m = 288) has rank <= 8 x
16 = 128 and is PD only through the jitter; this shows whether the fp32
run diverges in one package or in both.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

from export_jax_params import flatten_params  # noqa: E402
from svgpvae_tpu import gp as jgp, nn as jnets, utils as jutils  # noqa: E402
from svgpvae_tpu.cli import sprites as jsprites  # noqa: E402
from svgpvae_tpu_torch import train as ttrain  # noqa: E402
from svgpvae_tpu_torch.cli import sprites as tsprites  # noqa: E402

N_ACTIONS = 72


def jax_eps(seed):
    """The JAX CLI's draws: main step t uses the subkey of the t-th split
    of fold_in(PRNGKey(seed), 202); every eval batch uses PRNGKey(11)."""
    key = [jax.random.fold_in(jax.random.PRNGKey(seed), 202)]

    def eps_fn(kind, shape):
        if kind == "train":
            key[0], sub = jax.random.split(key[0])
        else:
            sub = jax.random.PRNGKey(11)
        return torch.from_numpy(np.array(jax.random.normal(sub, shape)))
    return eps_fn


def jax_cli_init(seed, chars, args):
    """The JAX CLI's initial parameters, flat, as `--params` takes them."""
    key, dummy = jax.random.PRNGKey(seed), jnp.zeros((2, 64, 64, 3))
    rng = np.random.RandomState(seed)
    gplvm = rng.normal(0, 1.5, (N_ACTIONS, args.L_action))
    ip = rng.normal(0, 1.5, (N_ACTIONS * args.m,
                             args.L_action + args.L_character))
    return flatten_params({
        "vae": jnets.SpritesVAE(L=args.L).init(key, dummy),
        "repr": jnets.SpritesReprNet(L=args.L_character).init(key, dummy),
        "head": jnets.ClassificationHead(num_classes=chars).init(
            key, jnp.zeros((2, args.L_character))),
        "gp": jgp.init_sprites_svgp(ip, gplvm, L_action=args.L_action)})


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chars", type=int, default=20)
    p.add_argument("--L_character", type=int, default=16)
    p.add_argument("--m", type=int, default=4)
    p.add_argument("--opt_regime", default="joint-1")
    p.add_argument("--out", default=None,
                   help="directory for the corpora and parameters "
                   "(default: a temporary one)")
    opts = p.parse_args()
    out = opts.out or tempfile.mkdtemp()
    argv = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs",
            "--synthetic", "--synthetic_chars", str(opts.chars),
            "--opt_regime", opts.opt_regime, "--eval_every", "1",
            "--nr_epochs_repr_nn", "1", "--batch_size", "100",
            "--batch_size_repr_nn", "100", "--L", "8",
            "--seed", str(opts.seed), "--m", str(opts.m),
            "--L_character", str(opts.L_character),
            "--gp_block_impl", "fused_rejitter_pallas"]
    args = tsprites.build_parser().parse_args(argv)
    npz = os.path.join(out, "params.npz")
    np.savez(npz, **jax_cli_init(opts.seed, opts.chars, args))

    port_elbo, step = [], ttrain.train_step

    def recording(state, batch, loss_fn):
        metrics = step(state, batch, loss_fn)
        if "elbo" in metrics:  # main steps, not pretraining
            port_elbo.append(float(metrics["elbo"]))
        return metrics
    tsprites.train.train_step = recording
    port_err = port_cgen = None
    try:
        res = tsprites.main(argv + [
            "--device", "cpu", "--params", npz, "--sprites_data_path",
            os.path.join(out, "port_corpus")], eps_fn=jax_eps(opts.seed))
        port_cgen = float(res["cgen_mse"])
    except Exception as e:  # noqa: BLE001 -- recorded, as JAX's below
        port_err = repr(e)[:300]
    finally:
        tsprites.train.train_step = step

    jax_elbo = []

    def record_epoch(values, *_, **__):
        jax_elbo.extend(float(v) for v in np.asarray(values).ravel())
    check, jutils.check_finite = jutils.check_finite, record_epoch
    jax_err = jax_cgen = None
    try:
        jargs = jsprites.build_parser().parse_args(
            argv + ["--sprites_data_path", os.path.join(out, "jax_corpus")])
        with contextlib.redirect_stdout(io.StringIO()):
            want = jsprites.run_experiment(jargs)
        jax_cgen = want.get("best_cgen_mse")
    except Exception as e:  # noqa: BLE001
        jax_err = repr(e)[:300]
    finally:
        jutils.check_finite = check
    print(json.dumps(dict(vars(opts), port_elbo=port_elbo,
                          port_error=port_err, port_cgen_mse=port_cgen,
                          jax_elbo=jax_elbo, jax_error=jax_err,
                          jax_cgen_mse=jax_cgen)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
