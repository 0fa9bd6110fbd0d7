"""The MNIST driver's flags of the port against the JAX package.

  * --reshuffle: the example order of an epoch (train.EpochShuffle fed
    JAX's permutation) equals the order JAX's make_epoch_fn(shuffle=True,
    shuffle_block) scans, in single examples and in blocks, with the tail
    in place; a run resumed across a reshuffled epoch equals the unbroken
    one bit for bit;
  * (tests/test_torch_flags_mnist_x64.py) two epochs under --x64
    --reshuffle --test_set_metrics --save against the JAX functions;
  * the sentinel (utils.check_finite): a NaN forced through the draws
    (SVGPVAE, Casale) or the data (deep SVIGP, which draws nothing)
    under --save raises NonFiniteLossError with the JAX package's
    message for the same values, and leaves ckpt_nan/<step>.pt;
  * --bias_analysis at float64: the step's mu_hat, the
    full-split mean vectors and the bias against
    forward_pass_svgpvae(bias_analysis=True) and
    mean_vector_bias_analysis;
  * --profile_dir: a Chrome trace of the first timed epoch, with its
    steps' "train_step" ranges, the "gp_block" and the ops.

Tolerances: 1e-9 relative to each tensor's max |entry| (both sides
compute the same math in float64, whose round-off is ~1e-16, and the
GP solves amplify it by their conditioning, ~1e3 here); orders, ids and
step counts exactly.  The float64 JAX programs compile at XLA's lowest
optimisation level (tests/test_torch_sprites_train.py's quick_jit),
which moves their results by round-off.  At float32 the rows would sit up to 4e-4 apart
after two steps, the GP solves amplifying fp32 round-off, which is why
the driver comparison runs at --x64.
"""

import glob
import json
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import data as jdata, gp as jgp, models as jmodels
from svgpvae_tpu import nn as jnets, train as jtrain
from svgpvae_tpu.gp.svgp import SVGPConfig as JConfig
from svgpvae_tpu.utils import metrics as jmetrics
from svgpvae_tpu_torch import data as tdata, train as ttrain, utils as tutils
from svgpvae_tpu_torch.cli import mnist as tmnist
from svgpvae_tpu_torch.utils.convert import mnist_params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from export_jax_params import flatten_params  # noqa: E402
from test_torch_sprites_train import quick_jit  # noqa: E402
from torch_threads import _torch_threads  # noqa: E402,F401

RTOL64 = 1e-9
KAPPA = float(np.sqrt(0.02))
L, SEED, BS = 6, 0, 128
ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs", "--PCA",
        "--ip_joint", "--GP_joint", "--ov_joint", "--dataset", "36",
        "--eval_every", "1", "--L", str(L), "--batch_size", str(BS),
        "--seed", str(SEED), "--device", "cpu"]


@pytest.fixture(scope="module")
def tiny_splits():
    """202 train rows (a full batch of 128 and a tail of 74); eval and
    test cut to one batch each."""
    base = tdata.synthetic_digit_base_images("36", per_digit=10, seed=0)
    out = tdata.generate_rotated_mnist(base, None, digits="36", seed=0)
    for split in ("eval", "test"):
        out[split] = {k: v[:BS] for k, v in out[split].items()}
    return out


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close64(got, want, what=""):
    got, want = _np(got), _np(want)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max()
    assert err <= RTOL64 * scale, (what, err, scale)


class JaxKeys:
    """The JAX driver's key chain: the state key after the init split;
    every epoch under --reshuffle splits it once for the permutation
    (make_epoch_fn), every training step once for its draws; each eval
    batch uses PRNGKey(7).  `perm_fn` and `eps_fn` feed cli.mnist.main
    in that order."""

    def __init__(self, seed, dtype=jnp.float32):
        self.key = jax.random.split(jax.random.PRNGKey(seed))[0]
        self.dtype = dtype
        self.perms = []

    def perm_fn(self, n):
        self.key, pkey = jax.random.split(self.key)
        perm = np.asarray(jax.random.permutation(pkey, n))
        self.perms.append(perm)
        return perm

    def eps_fn(self, kind, shape):
        if kind == "train":
            self.key, sub = jax.random.split(self.key)
        else:
            sub = jax.random.PRNGKey(7)
        return torch.from_numpy(np.array(
            jax.random.normal(sub, shape, dtype=self.dtype)))


def _jax_loss_fn(vae, impl="reference", bias_analysis=False):
    """The JAX driver's loss_svgpvae for SVGPVAE_Hensman --GECO."""
    def loss_fn(params, batch, key, geco, step):
        out = jmodels.forward_pass_svgpvae(
            vae, params["vae"], params["gp"], batch, key, beta=0.001,
            C_ma=geco.C_ma, lagrange_mult=geco.lagrange_mult,
            alpha=jtrain.geco_effective_alpha(step, 0.99), kappa=KAPPA,
            clip_qs=True, geco=True, gp_block_impl=impl,
            bias_analysis=bias_analysis)
        scale = (jnp.abs(out.inside_elbo) + jnp.abs(out.ce_term)
                 + jnp.abs(out.elbo))
        return out.elbo, (jtrain.GECOState(C_ma=out.C_ma,
                                           lagrange_mult=out.lagrange_mult),
                          {"elbo": out.elbo, "recon": out.recon_loss,
                           "scale": scale, "mean_vectors": out.mean_vectors})
    return loss_fn


def _jax_params(splits, dtype=jnp.float32):
    """The JAX driver's initial parameters (PCA inducing points and GPLVM
    table), the nets cast to `dtype`, and the .npz the port reads."""
    tr = splits["train"]
    vae = jnets.MnistVAE(L=L, dtype=dtype)  # the driver's net_dtype
    key, init_key = jax.random.split(jax.random.PRNGKey(SEED))
    vae_p = jax.tree_util.tree_map(
        lambda a: a.astype(dtype),
        vae.init(init_key, jnp.zeros((2, 28, 28, 1))))
    ip = jdata.generate_init_inducing_points(tr, n=2, use_pca=True, M=8,
                                             seed=SEED)
    gp = jgp.init_mnist_svgp(ip, splits["pca_ov_init"], dtype=dtype,
                             config=JConfig(jitter=1e-6,
                                            N_train=len(tr["images"])))
    return vae, {"vae": vae_p, "gp": gp}, key


def _assert_params(port_params, j_params, atol):
    conv = mnist_params_from_jax(flatten_params(j_params))
    for k, v in conv["vae"].items():
        np.testing.assert_allclose(
            _np(port_params["vae"].state_dict()[k]), _np(v), atol=atol,
            err_msg=k)
    for k, v in conv["gp"].items():
        np.testing.assert_allclose(_np(getattr(port_params["gp"], k)),
                                   _np(v), atol=atol, err_msg=k)


def _csv_rows(run_dir, name="ELBO_results.csv"):
    with open(os.path.join(run_dir, "res", name)) as f:
        lines = f.read().strip().splitlines()
    return [[float(x) for x in line.split(",")] for line in lines[1:]]


@pytest.mark.parametrize("n,bs,block", [(202, 64, 1), (350, 100, 50)])
def test_reshuffle_order_matches_jax_epoch_fn(n, bs, block):
    """EpochShuffle fed JAX's permutation gives, batch by batch, the ids
    that make_epoch_fn(shuffle=True, shuffle_block=block) scans over the
    stacked full batches; the tail (n % bs) follows in stored order."""
    ids = np.arange(n, dtype=np.float32)
    n_full = n // bs

    def loss_fn(params, batch, key, geco, step):
        return jnp.sum(params["w"] * 0.0), (geco, {"ids": batch[0]})

    tx = jtrain.make_optimizer(1e-3)
    state = jtrain.TrainState.create({"w": jnp.zeros(())}, tx,
                                     jax.random.PRNGKey(3))
    epoch_fn = jtrain.make_epoch_fn(loss_fn, tx, donate=False, shuffle=True,
                                    shuffle_block=block)
    stack = (jnp.asarray(ids[:n_full * bs]).reshape(n_full, bs),)
    keys = JaxKeys(0)
    keys.key = state.key
    shuffle = ttrain.EpochShuffle(n, bs, block=block, perm_fn=keys.perm_fn)
    t_ids = (torch.as_tensor(ids),)
    for _ in range(2):  # the second epoch permutes the stored order anew
        state, ms = epoch_fn(state, stack)
        order = shuffle.order()
        got = [b[0].numpy() for b in ttrain.epoch_batches(t_ids, bs, order)]
        assert len(got) == n_full + 1
        np.testing.assert_array_equal(np.concatenate(got[:n_full]),
                                      np.asarray(ms["ids"]).reshape(-1))
        np.testing.assert_array_equal(got[-1], ids[n_full * bs:])
        keys.key = state.key  # the steps' splits follow the permutation's
    if block > 1:  # whole blocks move
        starts = np.concatenate(got[:n_full])[::block]
        assert np.all(starts % block == 0)
    assert not np.array_equal(keys.perms[0], keys.perms[1])


def test_resume_across_a_reshuffled_epoch_is_bitwise(tmp_path, tiny_splits):
    """--reshuffle's generator rides in the checkpoint: one epoch, then a
    resumed one, equals two unbroken epochs bit for bit (orders, losses,
    state and both generators)."""
    argv = ARGV + ["--reshuffle", "--opt_regime"]
    full = tmnist.main(argv + ["joint-2"], splits=tiny_splits)
    first = tmnist.main(argv + ["joint-1", "--save", "--save_model_weights",
                                "--base_dir", str(tmp_path)],
                        splits=tiny_splits)
    rest = tmnist.main(argv + ["joint-1", "--resume_dir", first["run_dir"],
                               "--save_model_weights"], splits=tiny_splits)
    assert rest["metrics"] == full["metrics"][2:]
    assert first["metrics"] == full["metrics"][:2]
    for k, v in ttrain.named_tensors(full["state"].params).items():
        assert torch.equal(ttrain.named_tensors(rest["state"].params)[k], v)
    assert torch.equal(rest["shuffle"].generator.get_state(),
                       full["shuffle"].generator.get_state())
    assert torch.equal(rest["noise"].generator.get_state(),
                       full["noise"].generator.get_state())
    # and the permutation did change the second epoch's order
    plain = tmnist.main(ARGV + ["--opt_regime", "joint-2"],
                        splits=tiny_splits)
    assert plain["metrics"][2] != full["metrics"][2]


def _nan_eps(kind, shape):
    return torch.full(shape, float("nan"))


@pytest.mark.parametrize("case", ["SVGPVAE_Hensman", "SVIGP_Hensman",
                                  "GPVAE_Casale"])
def test_sentinel_writes_ckpt_nan_and_raises(tmp_path, tiny_splits, case):
    """A NaN under --save: NonFiniteLossError (a RuntimeError) with the
    message of the JAX package's check_finite on the same values (the
    epoch's ELBOs, at the step count JAX passes), plus the checkpoint
    path; ckpt_nan/<step>.pt holds the state the run had."""
    splits, eps_fn = tiny_splits, _nan_eps
    if case == "SVGPVAE_Hensman":
        argv = ARGV + ["--opt_regime", "joint-1"]
    elif case == "SVIGP_Hensman":  # no draws: a NaN pixel
        images = tiny_splits["train"]["images"].copy()
        images[5, 3, 3, 0] = np.nan
        splits = dict(tiny_splits, train=dict(tiny_splits["train"],
                                              images=images))
        argv = ["--elbo", "SVIGP_Hensman", "--dataset", "36", "--L", "4",
                "--batch_size", str(BS), "--nr_epochs", "1", "--device",
                "cpu"]
        eps_fn = None
    else:
        argv = ["--elbo", "GPVAE_Casale", "--PCA", "--dataset", "36", "--L",
                "4", "--batch_size", str(BS), "--opt_regime", "joint-1",
                "--device", "cpu"]
    with pytest.raises(tutils.NonFiniteLossError) as info:
        tmnist.main(argv + ["--save", "--base_dir", str(tmp_path)],
                    splits=splits, eps_fn=eps_fn)
    assert isinstance(info.value, RuntimeError)
    steps = 2  # 202 rows: one full batch and the tail
    with pytest.raises(jmetrics.NonFiniteLossError) as want:
        jmetrics.check_finite([float("nan")] * steps, steps)
    (run_dir,) = glob.glob(str(tmp_path / "debug_MNIST" / "*"))
    path = os.path.join(run_dir, "ckpt_nan")
    assert str(info.value) == (f"{want.value}; emergency checkpoint written "
                               f"to {path}")
    assert tutils.latest_step(path) == steps
    saved = tutils.restore_checkpoint(path)
    sd = (saved["regimes"]["joint"] if case == "GPVAE_Casale"
          else saved["train_state"])
    assert sd["step"] == steps
    assert any(not torch.all(torch.isfinite(t)) for t in
               sd["params"].values())
    assert tutils.latest_step(os.path.join(run_dir, "ckpt")) is None


def test_bias_analysis_matches_jax_f64(tmp_path, tiny_splits):
    """--bias_analysis --x64 on 64 train rows and one batch of 64: the
    step's mu_hat (the two-pass block's, whatever --gp_block_impl says)
    against forward_pass_svgpvae(bias_analysis=True), the full-split mean
    vectors after the step against mean_vector_bias_analysis on every
    train encoding, and the bias, at 1e-9."""
    splits = dict(tiny_splits, train={k: v[:64] for k, v in
                                      tiny_splits["train"].items()})
    jax.config.update("jax_enable_x64", True)
    try:
        vae, params, key = _jax_params(splits, jnp.float64)
        npz = str(tmp_path / "params.npz")
        np.savez(npz, **flatten_params(params))
        keys = JaxKeys(SEED, jnp.float64)
        argv = [a if a != str(BS) else "64" for a in ARGV]
        got = tmnist.main(argv + ["--x64", "--bias_analysis", "--opt_regime",
                                  "joint-1", "--gp_block_impl",
                                  "fused_pallas", "--params", npz],
                          splits=splits, eps_fn=keys.eps_fn)
        tx = jtrain.make_optimizer(1e-3)
        state = jtrain.TrainState.create(params, tx, key, dtype=jnp.float64)
        step = quick_jit(jtrain.make_train_step(
            _jax_loss_fn(vae, "fused_pallas", bias_analysis=True), tx,
            donate=False))
        tr = splits["train"]
        im = jnp.asarray(tr["images"], jnp.float64)
        aux = jnp.asarray(tr["aux_data"], jnp.float64)
        state, m = step(state, (im, aux))
        batch_mv = np.asarray(m["mean_vectors"])
        full_mv = np.asarray(quick_jit(
            lambda p: jgp.mean_vector_bias_analysis(
                p["gp"], aux, *jmodels.batching_encode_svgpvae(
                    vae, p["vae"], im, clip_qs=True)))(state.params))
    finally:
        jax.config.update("jax_enable_x64", False)
    (b,) = got["bias"]
    assert b["epoch"] == 0 and b["full_mean_vectors"].dtype == torch.float64
    _close64(b["batch_mean_vectors"], batch_mv, "batch mean vectors")
    _close64(b["full_mean_vectors"], full_mv, "full mean vectors")
    np.testing.assert_allclose(b["bias"],
                               np.mean(np.abs(batch_mv - full_mv)),
                               rtol=RTOL64)
    assert all(n == 0 for n in b["launches"].values())  # CPU: the twins


def _trace_events(trace_dir):
    (path,) = glob.glob(os.path.join(trace_dir, "*.json"))
    with open(path) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"]]


def test_profile_dir_traces_the_first_timed_epoch(tmp_path, tiny_splits,
                                                  capsys):
    """--opt_regime VAE-1 joint-2: epoch 1 switches regime, so epoch 2 is
    the first timed one; its two steps are in the trace, with the GP
    block and the ops.  One epoch alone traces nothing and warns."""
    out = tmp_path / "trace"
    tmnist.main(ARGV + ["--opt_regime", "VAE-1", "joint-2", "--eval_every",
                        "5", "--profile_dir", str(out)], splits=tiny_splits)
    names = _trace_events(out)
    assert names.count("train_step") == 2
    assert names.count("gp_block") >= 2
    assert any(n.startswith("aten::") for n in names)
    assert f"profiler trace written to {out}" in capsys.readouterr().out
    tmnist.main(["--elbo", "VAE", "--dataset", "36", "--L", "4",
                 "--batch_size", str(BS), "--nr_epochs", "1",
                 "--eval_every", "5", "--device", "cpu", "--profile_dir",
                 str(tmp_path / "none")], splits=tiny_splits)
    assert "no epoch was traced" in capsys.readouterr().out
    assert not glob.glob(str(tmp_path / "none" / "*.json"))
