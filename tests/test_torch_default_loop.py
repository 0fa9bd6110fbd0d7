"""The drivers' default training loops through the one-program trainer
functions (train.make_epoch_fn, make_generative_chunk_fn and the
capture.GraphSteps / GenerativeSteps behind them) against the per-step
loops, at a tiny size on the CPU.

Each CUDA graph is replaced by an eager call of what it would capture
(test_torch_epoch_chunk's stand-ins: capture.Graph runs its function at
every replay, Adam's lr is a float64 tensor, which gives the float lr's
bits), so the graph path is held to the per-step loop bit for bit:
  * SPRITES Hensman + GECO (2 full batches and a tail an epoch, 2
    epochs), plain and under --reshuffle --lr_decay --clip_grad, and
    --elbo VAE: per-step metrics, eval MSEs, final parameters, the
    epochs' graph replays; and a --basin_retry restart, captured anew;
  * the ball, Hensman and NP: the same, its chunks and tail those of the
    JAX driver's rule (svgpvae_tpu/cli/ball.py:224-226, the last chunk
    min(chunk, steps - g_s) at :275-282), the tail replaying the one
    graph; the rule itself over a grid of cadences;
  * MNIST at the default --epoch_chunk 1 (SVGPVAE and deep SVIGP);
  * a ball run resumed mid-run from its checkpoint, the graphs' or the
    per-step loop's, in either loop, equal to the unbroken run;
  * the runs that stay per step say why (the CPU, --data_parallel,
    --bias_analysis, a capture_step).
The graphs themselves run on the card (chip_smoke.py phase 21).
"""

import gc
import math
import weakref

import pytest
import torch

from svgpvae_tpu_torch import data as tdata
from svgpvae_tpu_torch import parallel, train as ttrain
from svgpvae_tpu_torch.cli import ball as tball
from svgpvae_tpu_torch.cli import mnist as tmnist
from svgpvae_tpu_torch.cli import sprites as tsprites
from svgpvae_tpu_torch.train import capture
from test_torch_epoch_chunk import _argv, _patch_eager_graphs
from torch_threads import _torch_threads  # noqa: E402,F401

SPRITES_ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs",
                "--repr_nn_pretrain", "no", "--batch_size", "100", "--L",
                "8", "--L_action", "4", "--L_character", "18", "--seed", "0",
                "--device", "cpu", "--opt_regime", "joint-2", "--eval_every",
                "2"]
BALL_ARGV = ["--tmax", "6", "--m", "5", "--seed", "0", "--device", "cpu",
             "--eval_every", "3", "--plot_every", "3000", "--ckpt_every",
             "3", "--clip_qs"]
BALL_ELBOS = {"hensman": ["--elbo", "SVGPVAE_Hensman", "--entropy_ce"],
              "np": ["--elbo", "NP"]}


@pytest.fixture
def eager_graphs(monkeypatch):
    _patch_eager_graphs(monkeypatch)
    monkeypatch.setattr(tball, "uncaptured_reason", lambda device: None)


def _params_equal(a, b):
    ta, tb = ttrain.named_tensors(a), ttrain.named_tensors(b)
    return ta.keys() == tb.keys() and all(torch.equal(ta[k], tb[k])
                                          for k in ta)


def _same_run(got, want, scores):
    assert got["metrics"] == want["metrics"]
    assert got["step_launches"] == want["step_launches"]
    assert [{k: ev[k] for k in scores} for ev in got["evals"]] == \
        [{k: ev[k] for k in scores} for ev in want["evals"]]
    assert _params_equal(got["state"].params, want["state"].params)


# --- SPRITES -----------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    """5 train characters (250 frames: 2 batches of 100 and a tail of
    50), 2 test characters."""
    return tdata.generate_synthetic_sprites(n_train_chars=5, n_test_chars=2,
                                            n_frames_train=50, seed=0)


@pytest.mark.parametrize("extra", [[], ["--reshuffle", "--lr_decay", "0.5",
                                        "--clip_grad"],
                                   ["--elbo", "VAE", "--nr_epochs", "2"]])
def test_sprites_epochs_equal_the_per_step_loop(extra, corpus, monkeypatch,
                                                capsys):
    want = tsprites.main(SPRITES_ARGV + extra, splits=corpus)
    assert "training loop: per step (a cpu device)" in capsys.readouterr().out
    _patch_eager_graphs(monkeypatch)
    got = tsprites.main(SPRITES_ARGV + extra, splits=corpus)
    assert "each epoch replays captured CUDA graphs" in \
        capsys.readouterr().out
    assert len(got["metrics"]) == 6
    _same_run(got, want, ("test_mse", "cgen_mse") if "VAE" not in extra
              else ("test_mse",))
    # epoch 0: 2 full warm-ups and the tail's; epoch 1: each captured and
    # replayed
    assert got["graph_replays"] == {"full": 2, "tail": 1}
    assert [c["steps"] for c in got["chunks"]] == [3, 3]
    if "--reshuffle" in extra:
        assert torch.equal(got["shuffle"].generator.get_state(),
                           want["shuffle"].generator.get_state())
        lr = got["state"].optimizer.param_groups[0]["lr"]
        assert float(lr) == want["state"].lr_fn(5)


def test_sprites_basin_retry_restart_equals_the_per_step_loop(
        corpus, monkeypatch, capsys):
    """--basin_retry's restart (forced by a 100% descent demand at the
    first eval) captures anew: a new optimizer, noise stream and
    GraphSteps, equal to the per-step run's restart bit for bit; the
    first attempt's graphs are let go (their replays kept in the
    record)."""
    argv = SPRITES_ARGV + ["--basin_retry", "1", "--basin_detect_evals",
                           "1", "--basin_detect_rel", "1.0"]
    want = tsprites.main(argv, splits=corpus)
    _patch_eager_graphs(monkeypatch)
    steps = []

    class Recorded(capture.GraphSteps):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            steps.append(weakref.ref(self))

    monkeypatch.setattr(capture, "GraphSteps", Recorded)
    got = tsprites.main(argv, splits=corpus)
    assert "restarting the main loop (attempt 1/1)" in \
        capsys.readouterr().out
    assert got["basin_attempts"] == want["basin_attempts"] == 1
    assert len(got["metrics"]) == 12 and len(got["evals"]) == 2
    _same_run(got, want, ("test_mse", "cgen_mse"))
    assert got["graph_replays"] == {"full": 4, "tail": 2}
    gc.collect()
    assert len(steps) == 2 and steps[0]() is None


# --- the ball ----------------------------------------------------------------


def jax_chunks(start, steps, eval_every, plot_every, ckpt_every):
    """The JAX driver's chunk lengths (svgpvae_tpu/cli/ball.py:224-226
    and the loop at :260-282): chunk = the largest divisor of the
    cadences' gcd up to 500, each chunk min(chunk, steps - g_s)."""
    cadence_gcd = math.gcd(eval_every, math.gcd(plot_every, ckpt_every))
    chunk = max(d for d in range(1, min(cadence_gcd, 500) + 1)
                if cadence_gcd % d == 0)
    out, g_s = [], start
    while g_s < steps:
        n = min(chunk, steps - g_s)
        out.append(n)
        g_s += n
    return chunk, out


def test_ball_chunk_rule_matches_jax():
    for ev, plot, ckpt in ((1000, 10000, 50000), (4, 6, 2), (7, 7, 7),
                           (600, 1200, 1800), (1000, 1500, 2500),
                           (997, 997 * 2, 997 * 3)):
        args = tball.build_parser().parse_args(
            ["--eval_every", str(ev), "--plot_every", str(plot),
             "--ckpt_every", str(ckpt)])
        assert tball.chunk_steps(args) == jax_chunks(0, 0, ev, plot,
                                                     ckpt)[0]


@pytest.fixture(scope="module")
def ball_per_step(tmp_path_factory):
    """The per-step runs of 7 steps, once each."""
    base = ["--base_dir", str(tmp_path_factory.mktemp("ball"))]
    return {elbo: tball.main(BALL_ARGV + flags + ["--steps", "7"] + base)
            for elbo, flags in BALL_ELBOS.items()}


@pytest.mark.parametrize("elbo", list(BALL_ELBOS))
def test_ball_chunks_equal_the_per_step_loop(elbo, ball_per_step, tmp_path,
                                             eager_graphs, capsys):
    """Chunks of 3 (gcd of 3, 3000, 3): [3, 3, 1], the evals at steps 3
    and 6; steps 0 and 1 warm up, 2..6 replay the one graph, the 1-step
    tail included."""
    got = tball.main(BALL_ARGV + BALL_ELBOS[elbo] + [
        "--steps", "7", "--base_dir", str(tmp_path)])
    assert "replaying a captured CUDA graph of draw -> step" in \
        capsys.readouterr().out
    want = ball_per_step[elbo]
    _same_run(got, want, ("step", "mse", "elbo"))
    assert [c["steps"] for c in got["chunks"]] == [3, 3, 1] == \
        [c["steps"] for c in want["chunks"]] == jax_chunks(0, 7, 3, 3000,
                                                           3)[1]
    assert [ev["step"] for ev in got["evals"]] == [3, 6]
    assert got["graph_replays"] == {"full": 5}
    for key in ("noise", "video_fn"):
        assert torch.equal(got[key].generator.get_state(),
                           want[key].generator.get_state())


@pytest.mark.parametrize("first_loop,rest_loop", [("graphs", "graphs"),
                                                  ("per_step", "graphs"),
                                                  ("graphs", "per_step")])
def test_ball_resume_mid_run_equals_unbroken(first_loop, rest_loop,
                                             ball_per_step, tmp_path,
                                             monkeypatch):
    """3 steps saved (a checkpoint at 3), then --resume_dir to 7: equal to
    the unbroken run, whichever loop wrote the checkpoint (its optimizer
    state in the eager form) and whichever resumes it."""
    flags = BALL_ARGV + BALL_ELBOS["hensman"] + ["--base_dir", str(tmp_path)]

    def run(loop, argv):
        with pytest.MonkeyPatch.context() as mp:
            if loop == "graphs":
                _patch_eager_graphs(mp)
                mp.setattr(tball, "uncaptured_reason", lambda device: None)
            return tball.main(argv)

    first = run(first_loop, flags + ["--steps", "3", "--save"])
    rest = run(rest_loop, flags + ["--steps", "7", "--resume_dir",
                                   first["run_dir"]])
    assert rest["state"].step == 7 and len(rest["metrics"]) == 4
    want = ball_per_step["hensman"]
    assert first["metrics"] + rest["metrics"] == want["metrics"]
    assert _params_equal(rest["state"].params, want["state"].params)
    assert [ev["mse"] for ev in rest["evals"]] == \
        [ev["mse"] for ev in want["evals"][1:]]
    assert torch.equal(rest["noise"].generator.get_state(),
                       want["noise"].generator.get_state())


# --- MNIST -------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_splits():
    base = tdata.synthetic_digit_base_images("36", per_digit=10, seed=0)
    return tdata.generate_rotated_mnist(base, None, digits="36", seed=0)


@pytest.mark.parametrize("runner", ["svgpvae", "svigp"])
def test_mnist_default_epochs_equal_the_per_step_loop(runner, tiny_splits,
                                                      monkeypatch, capsys):
    if runner == "svgpvae":
        argv = _argv(3, 1, "--reshuffle")
    else:
        argv = ["--elbo", "SVIGP_Hensman", "--PCA", "--ip_joint",
                "--GP_joint", "--ov_joint", "--dataset", "36", "--L", "4",
                "--batch_size", "128", "--nr_epochs", "3", "--eval_every",
                "1", "--device", "cpu"]
    want = tmnist.main(argv, splits=tiny_splits)
    assert "training loop: per step (a cpu device)" in capsys.readouterr().out
    _patch_eager_graphs(monkeypatch)
    got = tmnist.main(argv, splits=tiny_splits)
    assert "each epoch replays captured CUDA graphs" in \
        capsys.readouterr().out
    _same_run(got, want, ("cgen_mse",))
    # 2 steps an epoch: the full step warms up in epochs 0 and 1 and is
    # captured in epoch 2; the tail warms up in epoch 0
    assert got["graph_replays"] == {"full": 1, "tail": 2}
    assert [c["epochs"] for c in got["chunks"]] == [1, 1, 1]


@pytest.mark.parametrize("how", ["bias_analysis", "capture_step",
                                 "data_parallel", "per_step"])
def test_runs_that_stay_per_step_say_why(how, tiny_splits, tmp_path,
                                         monkeypatch, capsys):
    """With graphs possible on the device, each of these still takes its
    steps one by one, and says so."""
    _patch_eager_graphs(monkeypatch)
    want = {"bias_analysis": "--bias_analysis runs per step, as in the JAX "
                             "driver",
            "capture_step": "capture_step keeps one step's inputs",
            "data_parallel": "--data_parallel: gloo stages its all-reduces "
                             "through the host",
            "per_step": "main(per_step=True)"}[how]
    if how == "data_parallel":  # the rule, without spawning ranks
        monkeypatch.undo()
        monkeypatch.setattr(parallel, "run_ranks", lambda: 2)
        args = tmnist.build_parser().parse_args([])
        assert tmnist.per_step_reason(args, torch.device("cuda"), False,
                                      None, torch.Generator()) == want
        assert tball.per_step_reason(
            tball.build_parser().parse_args([]), torch.device("cuda"), False,
            None, tmnist.Noise(tmnist.default_eps_fn(0, "cpu")),
            tdata.make_video_batch_fn(), False) == want
        return
    monkeypatch.setattr(tball, "uncaptured_reason", lambda device: None)
    argv = _argv(1, 1) + (["--bias_analysis"] if how == "bias_analysis"
                          else [])
    res = tmnist.main(argv, splits=tiny_splits,
                      capture_step=1 if how == "capture_step" else None,
                      per_step=how == "per_step")
    assert f"training loop: per step ({want})" in capsys.readouterr().out
    assert res["chunks"] == [] and res["graph_replays"] == {}
    if how == "capture_step":
        assert res["captured"] is not None
    if how != "bias_analysis":  # the ball's loop says the same
        res = tball.main(BALL_ARGV + BALL_ELBOS["np"] + [
            "--steps", "3", "--base_dir", str(tmp_path)],
                         per_step=how == "per_step",
                         capture_step=1 if how == "capture_step" else None)
        assert f"each step by step ({want})" in capsys.readouterr().out
        assert res["graph_replays"] == {} and len(res["metrics"]) == 3
