"""--epoch_chunk and --eval_bundle in the port's MNIST driver against the
JAX package and against the port's own unchunked, unbundled runs.

  * (a) epoch_chunk_fallback_reasons equals the JAX driver's on a grid of
    chunk, --eval_every, epoch count, runner, regime, --bias_analysis and
    --profile_dir, and the warning the port's deep-SVIGP and SVGPVAE
    runners print equals the line the JAX runner prints;
  * (b) a --epoch_chunk 2 --eval_every 2 run of 4 epochs through the
    chunk's graph runner equals the unchunked run bit for bit (per-step
    metrics, eval MSEs, CSV rows, final parameters), with and without
    --reshuffle; on the CPU unpatched a chunked run takes the unchunked
    per-epoch loop and says so;
  * (c) 2 epochs of the chunked run (through the graph runner), tail
    included, from JAX parameters
    and JAX noise, against train.make_multi_epoch_fn, at float64 (see
    jax_runs): per-step losses within test_torch_mnist_train.py's
    tolerance and 1e-9 of their scale, final parameters within 1e-9 of
    each tensor's max |entry|;
  * (d) the bundled eval's images and per-batch losses equal the
    unbundled eval's bit for bit, its MSEs within rtol 1e-6 (sums on the
    device where the unbundled eval adds Python floats); both against the
    JAX eval at rtol 1e-4 (as test_main_matches_jax_steps);
  * (e) deep SVIGP chunked equals unchunked;
  * (f) a chunked --save run resumed from its epoch-2 checkpoint equals
    the run unbroken (--reshuffle: both generators ride in the
    checkpoint);
  * capture.GraphSteps' bookkeeping (the rows gathered at a device
    counter, the lr table filling Adam's lr tensor, with and without
    --lr_decay, the static GECO pair, the metrics buffer, the warm-ups and
    step counts) against the unchunked run; a captured chunk refused for
    an eps_fn without a generator; a capturable Adam's state_dict written
    in the eager form.

The chunk's graph runner (capture.GraphSteps) runs on the CPU with each
CUDA graph replaced by an eager call of what it would capture
(`eager_graphs`): the graphs themselves run on the card (chip_smoke.py
phase 20).  The JAX eval
references compile at XLA's lowest optimisation level
(test_torch_sprites_train's quick_jit), which moves them by round-off;
the JAX training steps compile as the JAX driver compiles them.
"""

import itertools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import models as jmodels, train as jtrain
from svgpvae_tpu.cli import mnist as jmnist
from svgpvae_tpu_torch import data as tdata
from svgpvae_tpu_torch import train as ttrain
from svgpvae_tpu_torch.cli import mnist as tmnist
from svgpvae_tpu_torch.utils.convert import mnist_params_from_jax
from test_torch_flags_mnist import RTOL64, JaxKeys, _close64, _jax_params
from test_torch_mnist_train import (KAPPA, SLICE_ARGV, _assert_loss,
                                    _jax_loss_fn)
from test_torch_sprites_train import quick_jit
from export_jax_params import flatten_params  # noqa: E402
import graph_standins
from torch_threads import _torch_threads  # noqa: E402,F401

BS, L = 128, 6
ARGV = SLICE_ARGV + ["--device", "cpu"]


def _argv(epochs, eval_every, *extra):
    i = ARGV.index("--opt_regime")
    out = ARGV[:i] + ARGV[i + 4:] + ["--opt_regime", f"joint-{epochs}",
                                     "--eval_every", str(eval_every)]
    return out + list(extra)


@pytest.fixture(scope="module")
def tiny_splits():
    """202 train rows (a full batch of 128 and a tail of 74), 32 eval and
    13 test rows."""
    base = tdata.synthetic_digit_base_images("36", per_digit=10, seed=0)
    return tdata.generate_rotated_mnist(base, None, digits="36", seed=0)


def _params_equal(a, b):
    ta, tb = ttrain.named_tensors(a), ttrain.named_tensors(b)
    return ta.keys() == tb.keys() and all(torch.equal(ta[k], tb[k])
                                          for k in ta)


def _scores(res):
    return [{k: ev[k] for k in ("eval_mse", "test_mse", "cgen_mse")}
            for ev in res["evals"]]


def _csv(run_dir, name):
    with open(os.path.join(run_dir, "res", name)) as f:
        return f.read()


def _patch_eager_graphs(mp):
    """cli.mnist's chunks and bundle take the graph path on the CPU, with
    EagerGraph for the graphs and no stream or cusolver backend."""
    graph_standins.patch(mp.setattr)


@pytest.fixture
def eager_graphs(monkeypatch):
    _patch_eager_graphs(monkeypatch)


# --- (a) the fallback rules and their warning --------------------------------


@pytest.mark.parametrize("svgpvae,regime", [
    (True, ("joint",)), (True, ("VAE", "joint")), (False, ("VAE",))])
def test_fallback_reasons_match_jax(svgpvae, regime):
    for chunk, eval_every, epochs, bias, profile in itertools.product(
            (0, 1, 2, 3), (1, 2, 3, 4, 6), (0, 4, 6, 7), (False, True),
            (None, "traces")):
        kw = dict(svgpvae=svgpvae, regime=list(regime), bias_analysis=bias,
                  profile_dir=profile)
        assert tmnist.epoch_chunk_fallback_reasons(
            chunk, eval_every, epochs, **kw) == \
            jmnist.epoch_chunk_fallback_reasons(chunk, eval_every, epochs,
                                                **kw)


def _warning(text):
    return [line for line in text.splitlines()
            if line.startswith("warning: --epoch_chunk")]


@pytest.mark.parametrize("runner", ["svigp", "svgpvae"])
def test_fallback_warning_matches_jax(runner, tiny_splits, tmp_path,
                                      capsys):
    """The JAX runner (on pickles of the same splits, 0 epochs: the
    warning comes before the loop) and the port's print the same line."""
    data_path = str(tmp_path / "data")
    base = tdata.synthetic_digit_base_images("36", per_digit=10, seed=0)
    tdata.generate_rotated_mnist(base, data_path, digits="36", seed=0)
    flags = ["--epoch_chunk", "2", "--eval_every", "3", "--profile_dir",
             str(tmp_path / "trace"), "--dataset", "36", "--L", "4", "--PCA"]
    if runner == "svigp":
        flags += ["--elbo", "SVIGP_Hensman", "--nr_epochs", "0",
                  "--batch_size", "128"]
        jax_run = jmnist.run_svigp
    else:  # --N_t: the JAX runner's size check holds the full set only;
        # it keeps 195 train rows, which its eval stacks split into 3
        flags += ["--elbo", "SVGPVAE_Hensman", "--opt_regime", "joint-0",
                  "--bias_analysis", "--N_t", "16", "--batch_size", "65"]
        jax_run = jmnist.run_svgpvae
    jax_run(jmnist.build_parser().parse_args(
        flags + ["--mnist_data_path", data_path]))
    want = _warning(capsys.readouterr().out)
    tmnist.main(flags + ["--mnist_data_path", data_path, "--device", "cpu"])
    got = _warning(capsys.readouterr().out)
    assert len(want) == 1 and got == want, (got, want)


# --- (b), (f) chunked against unchunked --------------------------------------


@pytest.fixture(scope="module")
def unchunked(tiny_splits):
    """unchunked(*flags): the unchunked run of 4 epochs, an eval every 2,
    with `flags` added, run once."""
    runs = {}

    def run(*extra):
        if extra not in runs:
            runs[extra] = tmnist.main(_argv(4, 2, *extra), splits=tiny_splits)
        return runs[extra]

    return run


@pytest.mark.parametrize("reshuffle", [False, True])
def test_chunked_run_equals_unchunked(reshuffle, unchunked, tiny_splits,
                                      tmp_path, monkeypatch):
    extra = ["--reshuffle"] if reshuffle else []
    want = unchunked(*extra)
    saved = [tmnist.main(_argv(4, 2, *extra, "--save", "--base_dir",
                               str(tmp_path / "0")), splits=tiny_splits)]
    _patch_eager_graphs(monkeypatch)
    saved.append(tmnist.main(_argv(4, 2, *extra, "--epoch_chunk", "2",
                                   "--save", "--base_dir",
                                   str(tmp_path / "1")), splits=tiny_splits))
    got = saved[1]
    assert len(got["metrics"]) == 8 and got["metrics"] == want["metrics"]
    assert got["step_launches"] == want["step_launches"]
    assert _scores(got) == _scores(want)
    assert _params_equal(got["state"].params, want["state"].params)
    assert [c["steps"] for c in got["chunks"]] == [4, 4]
    for name in ("ELBO_results.csv", "GP_params.csv"):
        assert _csv(got["run_dir"], name) == _csv(saved[0]["run_dir"], name)
    if reshuffle:
        assert torch.equal(got["shuffle"].generator.get_state(),
                           want["shuffle"].generator.get_state())


def test_cpu_chunked_run_takes_the_unchunked_loop(unchunked, tiny_splits,
                                                  capsys):
    got = tmnist.main(_argv(4, 2, "--epoch_chunk", "2"), splits=tiny_splits)
    assert ("--epoch_chunk 2: the steps run uncaptured, one epoch at a time "
            "as in an unchunked run (a cpu device)") in capsys.readouterr().out
    want = unchunked()
    assert got["chunks"] == [] and got["graph_replays"] == {}
    assert got["metrics"] == want["metrics"]
    assert _params_equal(got["state"].params, want["state"].params)


def test_chunked_resume_equals_unbroken(unchunked, tiny_splits, tmp_path,
                                        eager_graphs):
    chunked = ["--reshuffle", "--epoch_chunk", "2"]
    first = tmnist.main(_argv(2, 2, *chunked, "--save", "--save_model_weights",
                              "--base_dir", str(tmp_path)),
                        splits=tiny_splits)
    rest = tmnist.main(_argv(2, 2, *chunked, "--resume_dir",
                             first["run_dir"], "--save_model_weights"),
                       splits=tiny_splits)
    full = unchunked("--reshuffle")
    assert first["metrics"] + rest["metrics"] == full["metrics"]
    assert _params_equal(rest["state"].params, full["state"].params)
    for gen in ("shuffle", "noise"):
        assert torch.equal(rest[gen].generator.get_state(),
                           full[gen].generator.get_state())


def test_svigp_chunked_equals_unchunked(tiny_splits, monkeypatch):
    argv = ["--elbo", "SVIGP_Hensman", "--PCA", "--ip_joint", "--GP_joint",
            "--ov_joint", "--dataset", "36", "--L", "4", "--batch_size",
            str(BS), "--nr_epochs", "2", "--eval_every", "2", "--device",
            "cpu"]
    want = tmnist.main(argv, splits=tiny_splits)
    _patch_eager_graphs(monkeypatch)
    got = tmnist.main(argv + ["--epoch_chunk", "2"], splits=tiny_splits)
    assert got["graph_replays"] == {"tail": 1}  # the 2 full steps warm up
    assert len(got["metrics"]) == 4 and got["metrics"] == want["metrics"]
    assert [ev["cgen_mse"] for ev in got["evals"]] == \
        [ev["cgen_mse"] for ev in want["evals"]]
    assert _params_equal(got["state"].params, want["state"].params)


def test_eval_bundle_has_no_effect_on_the_vae(tiny_splits):
    argv = ["--elbo", "VAE", "--dataset", "36", "--L", "4", "--batch_size",
            str(BS), "--nr_epochs", "1", "--eval_every", "1", "--device",
            "cpu"]
    want = tmnist.main(argv, splits=tiny_splits)
    got = tmnist.main(argv + ["--eval_bundle", "--epoch_chunk", "1"],
                      splits=tiny_splits)
    assert got["metrics"] == want["metrics"]
    assert _scores(got) == _scores(want)


# --- (c), (d) against JAX ----------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs(tiny_splits, tmp_path_factory):
    """2 epochs under --x64 from JAX's parameters on JAX's draws: the port
    chunked and bundled, the port unchunked and unbundled (with a run dir,
    which keeps its test recon images), and JAX's make_multi_epoch_fn with
    the eval sums after it.  Float64, as tests/test_torch_flags_mnist.py
    compares whole runs: in fp32 an Adam step on an entry whose gradient
    is round-off may go either way (test_torch_mnist_train.py), and over
    four steps one inducing-point entry came 1.2e-4 apart, above that
    file's tenth of a step."""
    jax.config.update("jax_enable_x64", True)
    try:
        vae, params, key = _jax_params(tiny_splits, jnp.float64)
        tmp = tmp_path_factory.mktemp("jax_runs")
        npz = str(tmp / "params.npz")
        np.savez(npz, **flatten_params(params))
        argv = _argv(2, 2, "--x64", "--params", npz)
        jax_eps = JaxKeys(0, jnp.float64).eps_fn
        with pytest.MonkeyPatch.context() as mp:
            _patch_eager_graphs(mp)
            # a captured chunk refuses an eps_fn without a generator (its
            # draws would be captured); the stand-in graphs call it anew
            # at every replay, so the JAX key chain advances as it should
            mp.setattr(tmnist.Noise, "generator", torch.Generator())
            bundled = tmnist.main(
                argv + ["--epoch_chunk", "2", "--eval_bundle"],
                splits=tiny_splits, eps_fn=jax_eps)
        port = {
            "bundled": bundled,
            "plain": tmnist.main(
                argv + ["--save", "--base_dir", str(tmp)],
                splits=tiny_splits, eps_fn=JaxKeys(0, jnp.float64).eps_fn)}

        tx = jtrain.make_optimizer(1e-3)
        state = jtrain.TrainState.create(params, tx, key, dtype=jnp.float64)
        multi = jtrain.make_multi_epoch_fn(_jax_loss_fn(vae, "fused_pallas"),
                                           tx, donate=False)
        f64 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
        tr = tiny_splits["train"]
        im, aux = f64(tr["images"]), f64(tr["aux_data"])
        state, ms = multi(state, (im[:BS][None], aux[:BS][None]),
                          (im[BS:], aux[BS:]), 2)
        ekey = jax.random.PRNGKey(7)

        @quick_jit
        def recon(params, geco, batch):
            return jmodels.forward_pass_svgpvae(
                vae, params["vae"], params["gp"], batch, ekey, beta=0.001,
                C_ma=geco.C_ma, lagrange_mult=geco.lagrange_mult, alpha=0.99,
                kappa=KAPPA, clip_qs=True, geco=True,
                gp_block_impl="fused_pallas").recon_loss

        @quick_jit
        def cgen_loss(params, batch, mu, var):
            return jmodels.predict_cgen_mnist(
                vae, params["vae"], params["gp"], batch, mu, var, aux,
                ekey)[1]

        def batches(split):
            x, a = f64(split["images"]), f64(split["aux_data"])
            return [(x[lo:lo + BS], a[lo:lo + BS])
                    for lo in range(0, len(x), BS)]

        mu, var = quick_jit(lambda p, x: jmodels.batching_encode_svgpvae(
            vae, p["vae"], x, clip_qs=True))(state.params, im)
        n = {k: len(tiny_splits[k]["images"]) for k in ("eval", "test")}
        jax_scores = {
            "eval_mse": sum(float(recon(state.params, state.geco, b)) for b
                            in batches(tiny_splits["eval"])) / n["eval"],
            "test_mse": sum(float(recon(state.params, state.geco, b)) for b
                            in batches(tiny_splits["test"])) / n["test"],
            "cgen_mse": sum(float(cgen_loss(state.params, b, mu, var)) for b
                            in batches(tiny_splits["test"])) / n["test"]}
        return (port, {k: np.asarray(v) for k, v in ms.items()},
                jax.tree_util.tree_map(np.asarray, state.params), jax_scores)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_chunked_run_matches_jax_multi_epoch_fn(jax_runs):
    """Per-step losses within test_main_matches_jax_steps's tolerance (and
    1e-9 of their scale), the final parameters within 1e-9 of each
    tensor's max |entry| (under its tenth of an Adam step)."""
    port, ms, params, _ = jax_runs
    got = port["bundled"]
    want, scale = ms["loss"].reshape(-1), ms["scale"].reshape(-1)
    assert len(got["metrics"]) == len(want) == 4
    for m, w, sc in zip(got["metrics"], want, scale):
        _assert_loss(m["loss"], w, sc)
        assert abs(m["loss"] - w) <= RTOL64 * sc
    conv = mnist_params_from_jax(flatten_params(params))
    t_params = got["state"].params
    for k, v in conv["vae"].items():
        _close64(t_params["vae"].state_dict()[k], v, k)
    for k, v in conv["gp"].items():
        _close64(getattr(t_params["gp"], k), v, k)
    assert got["metrics"] == port["plain"]["metrics"]


def test_eval_bundle_equals_unbundled_and_jax(jax_runs):
    port, _, _, jax_scores = jax_runs
    got, want = port["bundled"]["evals"][-1], port["plain"]["evals"][-1]
    assert port["bundled"]["eval_losses"] == port["plain"]["eval_losses"]
    for k in ("test_recon", "cgen_images"):
        assert torch.equal(port["bundled"][k], port["plain"][k]), k
    for k, v in jax_scores.items():
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k], v, rtol=1e-4, err_msg=k)
        np.testing.assert_allclose(want[k], v, rtol=1e-4, err_msg=k)


# --- the graph runner's bookkeeping on the CPU -------------------------------


def _check_graph_steps(extra, unchunked, tiny_splits):
    got = tmnist.main(_argv(4, 2, *extra, "--epoch_chunk", "2",
                            "--eval_bundle"), splits=tiny_splits)
    want = unchunked(*extra)
    # 2 steps an epoch: 2 warm-ups then replays of the full step, 1
    # warm-up then replays of the tail
    assert got["graph_replays"] == {"full": 2, "tail": 3, "eval": 2}
    assert got["metrics"] == want["metrics"]
    assert got["state"].step == want["state"].step == 8
    assert _params_equal(got["state"].params, want["state"].params)
    assert got["eval_losses"] == want["eval_losses"]
    # the last step's lr reached Adam through the table
    lr = got["state"].optimizer.param_groups[0]["lr"]
    lr_fn = want["state"].lr_fn
    assert isinstance(lr, torch.Tensor) and float(lr) == (
        1e-3 if lr_fn is None else lr_fn(7))


@pytest.mark.parametrize("reshuffle", [False, True])
def test_graph_steps_bookkeeping(reshuffle, unchunked, tiny_splits,
                                 eager_graphs):
    _check_graph_steps(["--reshuffle"] if reshuffle else [], unchunked,
                       tiny_splits)


def test_graph_steps_lr_table_feeds_adam(unchunked, tiny_splits,
                                         eager_graphs):
    """--lr_decay: every step's lr comes from the table."""
    _check_graph_steps(["--lr_decay", "0.1"], unchunked, tiny_splits)


def test_captured_chunk_refuses_draws_without_a_generator(tiny_splits,
                                                          eager_graphs):
    eps = tmnist.default_eps_fn(0, torch.device("cpu"))
    with pytest.raises(ValueError, match="exposes no `generator`"):
        tmnist.main(_argv(2, 2, "--epoch_chunk", "2"), splits=tiny_splits,
                    eps_fn=lambda kind, shape: eps(kind, shape))


def test_capturable_adam_checkpoints_in_eager_form():
    w = torch.nn.Parameter(torch.ones(3))
    opt = ttrain.make_optimizer({"w": w}, 1e-3)
    w.grad = torch.ones(3)
    opt.step()
    (group,) = opt.param_groups
    group["lr"], group["capturable"] = torch.tensor(1e-3), True
    state = ttrain.TrainState(params={}, optimizer=opt, geco=None)
    sd = state.state_dict()["optimizer"]
    (saved,) = sd["param_groups"]
    assert saved["lr"] == float(torch.tensor(1e-3)) and \
        not saved["capturable"]
    assert sd["state"][0]["step"].device.type == "cpu"
    assert group["capturable"]  # the live optimizer is left as it was
