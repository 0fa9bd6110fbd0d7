"""The MNIST driver's last one-program loops, captured: the VAE and CVAE
epochs, the VAE phases of an SVGPVAE --opt_regime, and Casale's regime
epochs (with and without --casale_taylor_every), through
train.make_epoch_fn / make_multi_epoch_fn and capture.GraphSteps, against
the per-step loops and the JAX package, at a tiny size on the CPU.

Each CUDA graph is replaced by an eager call of what it would capture
(test_torch_epoch_chunk's stand-ins: capture.Graph runs its function at
every replay, Adam's lr is a float64 tensor, which gives the float lr's
bits), so each graph path is held to its per-step run bit for bit:
  * VAE and CVAE (2 full batches and a tail an epoch, 2 epochs): per-step
    metrics, eval scores, final parameters, the graphs' replays;
  * SVGPVAE Hensman + GECO with --opt_regime VAE-1 joint-1 VAE-1 joint-1
    and --lr_decay: the VAE epochs step the graphs of the VAE loss
    ("VAE/full", "VAE/tail"), the joint epochs the SVGPVAE's, over one
    Adam, step counter and GECO pair: the GECO state and Adam's lr after
    every switch equal the per-step run's; the epochs after a switch are
    left out of the timed p50;
  * Casale --opt_regime VAE-1 GP-1 joint-1 at --casale_taylor_every 1 and
    2 (the held sample's refresh a graph of its own, "<regime>/refresh");
  * the --opt_regime run and both Casale cases of
    test_torch_baselines_cli (test_opt_regime_vae_phase_moves_gp_as_jax,
    test_casale_matches_jax), run again on the graph path: the same JAX
    references at the same tolerances;
  * on the CPU each of these runs per step, and says why.
The graphs themselves run on the card (chip_smoke.py phase 22).
"""

import pytest
import torch

import test_torch_baselines_cli as baselines_cli
from svgpvae_tpu_torch import data as tdata
from svgpvae_tpu_torch import train as ttrain
from svgpvae_tpu_torch.cli import mnist as tmnist
from test_torch_baselines_cli import splits  # noqa: F401 (fixture)
from test_torch_epoch_chunk import _patch_eager_graphs
from torch_threads import _torch_threads  # noqa: E402,F401

COMMON = ["--dataset", "36", "--L", "4", "--batch_size", "80", "--seed",
          "0", "--device", "cpu"]
VAE_ARGV = ["--nr_epochs", "2", "--eval_every", "2", "--clip_qs"]
SVGPVAE_ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs",
                "--PCA", "--ip_joint", "--GP_joint", "--ov_joint",
                "--opt_regime", "VAE-1", "joint-1", "VAE-1", "joint-1",
                "--eval_every", "2", "--lr_decay", "0.5"]
CASALE_ARGV = ["--elbo", "GPVAE_Casale", "--opt_regime", "VAE-1", "GP-1",
               "joint-1", "--PCA", "--ov_joint", "--clip_qs"]
CASALE_BATCH = ["--batch_size", "50"]  # 4 full batches and a tail of 2


@pytest.fixture(scope="module")
def tiny_splits():
    """202 train rows: 2 full batches of 80 and a tail of 42."""
    base = tdata.synthetic_digit_base_images("36", per_digit=10, seed=0)
    return tdata.generate_rotated_mnist(base, None, digits="36", seed=0)


def _params_equal(a, b):
    ta, tb = ttrain.named_tensors(a), ttrain.named_tensors(b)
    return ta.keys() == tb.keys() and all(torch.equal(ta[k], tb[k])
                                          for k in ta)


def _same_run(got, want, scores):
    assert got["metrics"] == want["metrics"]
    assert got["step_launches"] == want["step_launches"]
    assert [{k: ev[k] for k in scores} for ev in got["evals"]] == \
        [{k: ev[k] for k in scores} for ev in want["evals"]]
    params = "params" if "params" in got else "state"
    if params == "state":
        assert _params_equal(got["state"].params, want["state"].params)
    else:
        assert _params_equal(got["params"], want["params"])


def _both(argv, splits, monkeypatch, capsys):
    """(the graph path's run, the per-step run) of argv; the per-step
    run on the CPU says why it steps one by one."""
    want = tmnist.main(argv, splits=splits)
    assert "training loop: per step (a cpu device)" in \
        capsys.readouterr().out
    with monkeypatch.context() as mp:
        _patch_eager_graphs(mp)
        got = tmnist.main(argv, splits=splits)
    assert "each epoch replays" in capsys.readouterr().out
    return got, want


@pytest.mark.parametrize("elbo", ["VAE", "CVAE"])
def test_vae_and_cvae_epochs_equal_the_per_step_loop(elbo, tiny_splits,
                                                     monkeypatch, capsys):
    got, want = _both(["--elbo", elbo] + VAE_ARGV + COMMON, tiny_splits,
                      monkeypatch, capsys)
    assert len(got["metrics"]) == 6
    _same_run(got, want, ("eval_mse", "test_mse", "cgen_mse"))
    assert got["eval_losses"] == want["eval_losses"]
    # epoch 0: 2 full warm-ups and the tail's; epoch 1: each replayed
    assert got["graph_replays"] == {"full": 2, "tail": 1}
    assert [c["timed"] for c in got["chunks"]] == [False, True]


def test_opt_regime_vae_phases_equal_the_per_step_loop(tiny_splits,
                                                       monkeypatch, capsys):
    """VAE-1 joint-1 VAE-1 joint-1: the kinds' graphs over one optimizer;
    the GECO state and the lr after each switch are the per-step run's."""
    got, want = _both(SVGPVAE_ARGV + COMMON, tiny_splits, monkeypatch,
                      capsys)
    assert got["regimes"] == ["VAE", "joint", "VAE", "joint"]
    _same_run(got, want, ("eval_mse", "test_mse", "cgen_mse"))
    # the joint steps' GECO state after each switch (C_ma, lagrange),
    # and the per-step runs' GECO state at the end
    assert [(m["C_ma"], m["lagrange"]) for m in got["metrics"]
            if "C_ma" in m] == [(m["C_ma"], m["lagrange"])
                                for m in want["metrics"] if "C_ma" in m]
    for k in ("C_ma", "lagrange_mult"):
        assert torch.equal(getattr(got["state"].geco, k),
                           getattr(want["state"].geco, k))
    # Adam's lr: the per-step run's after its last step, from the table
    lr = got["state"].optimizer.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor)
    assert float(lr) == want["state"].optimizer.param_groups[0]["lr"] == \
        want["state"].lr_fn(11)
    opt_got, opt_want = got["state"].optimizer, want["state"].optimizer
    assert [int(opt_got.state[p]["step"]) for p in opt_got.state] == \
        [int(opt_want.state[p]["step"]) for p in opt_want.state]
    # VAE epoch 0: 2 full warm-ups, the tail's; joint epoch 1 the same;
    # VAE epoch 2 and joint epoch 3 replay everything
    assert got["graph_replays"] == {"VAE/full": 2, "VAE/tail": 1,
                                    "full": 2, "tail": 1}
    # every epoch follows a switch: none is timed
    assert [c["timed"] for c in got["chunks"]] == [False] * 4


@pytest.mark.parametrize("taylor_every", [1, 2])
def test_casale_regimes_equal_the_per_step_loop(taylor_every, tiny_splits,
                                                monkeypatch, capsys):
    argv = CASALE_ARGV + ["--casale_taylor_every", str(taylor_every)] + \
        COMMON + CASALE_BATCH
    got, want = _both(argv, tiny_splits, monkeypatch, capsys)
    assert got["regimes"] == want["regimes"] == ["VAE"] * 5 + ["GP"] * 5 \
        + ["joint"] * 5
    _same_run(got, want, ())
    for r in ("VAE", "GP", "joint"):
        sg, sw = got["states"][r], want["states"][r]
        assert sg.step == sw.step == 5
        assert [int(sg.optimizer.state[p]["step"])
                for p in sg.optimizer.state] == \
            [int(sw.optimizer.state[p]["step"]) for p in sw.optimizer.state]
    assert torch.equal(got["noise"].generator.get_state(),
                       want["noise"].generator.get_state())
    # each regime's epoch: 2 full steps warm up, the next 2 replay, the
    # tail warms up.  K = 2: the refreshes at ages 0, 2, 4 (GP) and 6, 8
    # (joint): each regime's first eager, the later ones replayed
    want_replays = {f"{r}/full": 2 for r in ("VAE", "GP", "joint")}
    if taylor_every == 2:
        want_replays.update({"GP/refresh": 2, "joint/refresh": 1})
    assert got["graph_replays"] == want_replays
    assert [c["timed"] for c in got["chunks"]] == [False] * 3


# --- the graph path against JAX ----------------------------------------------


def _graph_path(monkeypatch):
    """cli.mnist.main on the graph path for the JAX tests, whose eps_fn
    (the JAX key chain) has no generator: the stand-in graphs call it anew
    at every replay, so the chain advances as it should.  Returns the list
    the runs' results go to."""
    _patch_eager_graphs(monkeypatch)
    monkeypatch.setattr(tmnist.Noise, "generator", torch.Generator())
    runs, main = [], tmnist.main

    def recorded(*a, **k):
        runs.append(main(*a, **k))
        return runs[-1]

    monkeypatch.setattr(tmnist, "main", recorded)
    return runs


def test_opt_regime_graph_path_matches_jax(tmp_path, splits, monkeypatch):
    runs = _graph_path(monkeypatch)
    baselines_cli.test_opt_regime_vae_phase_moves_gp_as_jax(tmp_path, splits)
    (res,) = runs
    # 2 full batches an epoch, all warm-ups of their kinds: the graph
    # path's bookkeeping (rows, lr table, GECO pair, buffers) against JAX
    assert res["regimes"] == ["VAE", "joint"] and \
        [c["steps"] for c in res["chunks"]] == [2, 2]


@pytest.mark.parametrize("case", sorted(baselines_cli.CASALE_CASES))
def test_casale_graph_path_matches_jax(case, tmp_path, splits, monkeypatch):
    runs = _graph_path(monkeypatch)
    baselines_cli.test_casale_matches_jax(tmp_path, splits, case)
    (res,) = runs
    # "regimes": VAE-1 GP-1 joint-3, one tail step an epoch; the joint
    # tail warms up once and replays twice.  "taylor_every": joint-2, two
    # full steps an epoch, the refreshes at ages 0 (eager) and 2
    assert res["graph_replays"] == ({"joint/tail": 2} if case == "regimes"
                                    else {"joint/full": 2,
                                          "joint/refresh": 1})
