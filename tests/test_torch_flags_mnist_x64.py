"""The MNIST driver's --x64 --reshuffle --test_set_metrics against the JAX
package, in a file of its own so that the suite's workers take it beside
tests/test_torch_flags_mnist.py.

Two epochs of cli.mnist.main under --x64 --reshuffle --test_set_metrics
--save, with JAX's permutations and draws injected, against the same
epochs made with the JAX functions under jax_enable_x64 (make_epoch_fn,
make_train_step, the eval forward on the test split's first batch; the
nets' parameters cast to float64, as the port holds them): losses, the
first step's gradients, the parameters and the res/ELBO_results.csv rows,
at 1e-9 of each tensor's max |entry| (float64 on both sides; the JAX
programs compiled at XLA's lowest optimisation level, which moves float64
results by round-off).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import models as jmodels, train as jtrain
from svgpvae_tpu_torch import data as tdata, train as ttrain
from svgpvae_tpu_torch.cli import mnist as tmnist
from svgpvae_tpu_torch.utils.convert import mnist_params_from_jax

from test_torch_flags_mnist import (ARGV, BS, KAPPA, RTOL64, SEED, JaxKeys,
                                    _assert_params, _close64, _csv_rows,
                                    _jax_loss_fn, _jax_params,
                                    flatten_params)
from test_torch_sprites_train import quick_jit
from torch_threads import _torch_threads  # noqa: E402,F401


@pytest.fixture(scope="module")
def tiny_splits():
    """202 train rows (a full batch of 128 and a tail of 74); eval and
    test cut to one batch each."""
    base = tdata.synthetic_digit_base_images("36", per_digit=10, seed=0)
    out = tdata.generate_rotated_mnist(base, None, digits="36", seed=0)
    for split in ("eval", "test"):
        out[split] = {k: v[:BS] for k, v in out[split].items()}
    return out


def test_reshuffle_test_set_metrics_x64_match_jax(tmp_path, tiny_splits):
    """Two epochs under --x64 --reshuffle --test_set_metrics --save against
    the JAX driver's functions under jax_enable_x64 (its nets' parameters
    cast to float64, as the port holds them), at 1e-9: each epoch's steps
    through make_epoch_fn(shuffle=True) and the tail step (losses, the
    first step's gradients), the GECO state and the parameters after the
    four Adam steps, and each eval's metric row from the forward pass on
    the test split's first batch with the eval key.  Every tensor of the
    port's run is float64."""
    jax.config.update("jax_enable_x64", True)
    try:
        vae, params, key = _jax_params(tiny_splits, jnp.float64)
        npz = str(tmp_path / "params.npz")
        np.savez(npz, **flatten_params(params))
        keys = JaxKeys(SEED, jnp.float64)
        got = tmnist.main(ARGV + ["--x64", "--opt_regime", "joint-2",
                                  "--reshuffle", "--test_set_metrics",
                                  "--save", "--base_dir", str(tmp_path),
                                  "--params", npz],
                          splits=tiny_splits, eps_fn=keys.eps_fn,
                          perm_fn=keys.perm_fn, capture_step=0)
        want = _jax_epochs(vae, params, key, tiny_splits)
    finally:
        jax.config.update("jax_enable_x64", False)
    assert len(keys.perms) == 2 and len(got["metrics"]) == 4
    assert all(t.dtype == torch.float64 for t in
               ttrain.named_tensors(got["state"].params).values())
    assert got["state"].geco.C_ma.dtype == torch.float64
    for g, w in zip(got["metrics"], want["losses"]):
        _close64(g["loss"], w, "loss")
    conv = mnist_params_from_jax(flatten_params(want["grads"]))
    cap = got["captured"]["grads"]
    for part in ("vae", "gp"):
        for k, v in conv[part].items():
            _close64(cap[f"{part}/{k}"], v, f"grad {part}/{k}")
    state = want["state"]
    _close64(got["state"].geco.C_ma, state.geco.C_ma, "C_ma")
    _close64(got["state"].geco.lagrange_mult, state.geco.lagrange_mult,
             "lagrange")
    _assert_params(got["state"].params, state.params, RTOL64)
    csv = _csv_rows(got["run_dir"])
    assert [r[0] for r in csv] == [r[0] for r in want["rows"]] == [2, 4]
    for r_got, r_want in zip(csv, want["rows"]):
        for i, (g, w) in enumerate(zip(r_got[1:], r_want[1:])):
            _close64(g, w, f"row column {i + 1}")


def _jax_epochs(vae, params, key, splits):
    """Two epochs of the JAX driver under --reshuffle: make_epoch_fn with
    shuffle over the stacked full batch, then the tail step; after each,
    the --test_set_metrics row.  Also the first step's gradients."""
    tx = jtrain.make_optimizer(1e-3)
    state = jtrain.TrainState.create(params, tx, key, dtype=jnp.float64)
    loss = _jax_loss_fn(vae)
    epoch_fn = quick_jit(jtrain.make_epoch_fn(loss, tx, donate=False,
                                              shuffle=True))
    step = quick_jit(jtrain.make_train_step(loss, tx, donate=False))
    tr, te = splits["train"], splits["test"]
    im = jnp.asarray(tr["images"], jnp.float64)
    aux = jnp.asarray(tr["aux_data"], jnp.float64)
    stack = (im[:BS][None], aux[:BS][None])
    test_batch = (jnp.asarray(te["images"][:BS], jnp.float64),
                  jnp.asarray(te["aux_data"][:BS], jnp.float64))

    @quick_jit
    def metrics_row(params, geco):
        out = jmodels.forward_pass_svgpvae(
            vae, params["vae"], params["gp"], test_batch,
            jax.random.PRNGKey(7), beta=0.001, C_ma=geco.C_ma,
            lagrange_mult=geco.lagrange_mult, alpha=0.99, kappa=KAPPA,
            clip_qs=True, geco=True, gp_block_impl="reference")
        return jnp.stack([
            out.elbo, out.recon_loss, out.kl_term, out.qnet_mu.min(),
            out.qnet_mu.max(), out.qnet_var.min(), out.qnet_var.max(),
            out.inside_elbo, out.ce_term, out.p_m.min(), out.p_m.max(),
            out.p_v.min(), out.p_v.max(), geco.C_ma, geco.lagrange_mult])

    rows, losses, grads = [], [], None
    for _ in range(2):
        state, ms = epoch_fn(state, stack)
        if grads is None:  # the first step: its batch is the permuted one
            perm = jax.random.permutation(
                jax.random.split(key)[1], BS)
            sub = jax.random.split(jax.random.split(key)[0])[1]
            grads = quick_jit(jax.grad(lambda *a: loss(*a)[0]))(
                params, (im[:BS][perm], aux[:BS][perm]), sub,
                jtrain.GECOState.init(jnp.float64), 0)
        state, m = step(state, (im[BS:], aux[BS:]))
        losses += [float(ms["loss"][0]), float(m["loss"])]
        rows.append([int(state.step)] + list(np.asarray(
            metrics_row(state.params, state.geco))))
    return {"state": state, "losses": losses, "rows": rows, "grads": grads}
