"""The SPRITES driver's last one-program loops, captured: the repr-net
pretraining epochs (train.make_epoch_fn over a capture.GraphSteps) and
the eval pass's four calls (capture.CapturedCall: the test_character
recon, the full-train encode, the fit, the cgen), against the per-step
run and the JAX CLI, at a tiny size on the CPU.

Each CUDA graph is replaced by an eager call of what it would capture
(test_torch_epoch_chunk's stand-ins), so the graph path is held to the
per-step run bit for bit:
  * the pretraining (250 train frames, batch 100: the first 200 in 2
    steps an epoch, no tail; 3 epochs): per-epoch loss and accuracy, the
    test_action check, the step count, the graph's replays;
  * the eval pass after each of 2 epochs, Hensman + GECO in fp32 and
    --elbo VAE: the MSEs, the last batch's recon and cgen images and
    targets, every stage's kernel launches, each call's replays; and the
    whole run (per-step metrics, final parameters);
  * test_torch_sprites_train_cli.py::test_main_matches_jax_cli, run again
    on the graph path: the JAX CLI's run at that test's tolerances.
On the CPU both run uncaptured and say why.  The graphs themselves run
on the card (chip_smoke.py phase 21(b)).
"""

import pytest
import torch

import test_torch_sprites_train_cli as sprites_cli
from svgpvae_tpu_torch import data as tdata
from svgpvae_tpu_torch import train as ttrain
from svgpvae_tpu_torch.cli import mnist as tmnist
from svgpvae_tpu_torch.cli import sprites as tsprites
from test_torch_epoch_chunk import _patch_eager_graphs
from torch_threads import _torch_threads  # noqa: E402,F401

ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs",
        "--nr_epochs_repr_nn", "3", "--batch_size_repr_nn", "100",
        "--batch_size", "100", "--L", "8", "--L_action", "4",
        "--L_character", "18", "--seed", "0", "--device", "cpu",
        "--opt_regime", "joint-2", "--eval_every", "1"]
VAE_ARGV = ["--elbo", "VAE", "--clip_qs", "--batch_size", "100", "--L",
            "8", "--seed", "0", "--device", "cpu", "--nr_epochs", "2",
            "--eval_every", "1"]
CALLS = ("recon", "encode", "fit", "cgen")


@pytest.fixture(scope="module")
def corpus():
    """5 train characters (250 frames), 2 test characters (144 frames:
    batch_tc 144, one recon and one cgen batch)."""
    return tdata.generate_synthetic_sprites(n_train_chars=5, n_test_chars=2,
                                            n_frames_train=50, seed=0)


def _params_equal(a, b):
    ta, tb = ttrain.named_tensors(a), ttrain.named_tensors(b)
    return ta.keys() == tb.keys() and all(torch.equal(ta[k], tb[k])
                                          for k in ta)


@pytest.fixture(scope="module")
def runs(corpus):
    """{argv name: (the graph path's run, the per-step run, their
    output)}, each run once."""
    out = {}
    for name, argv in (("svgpvae", ARGV), ("vae", VAE_ARGV)):
        with pytest.MonkeyPatch.context() as mp:
            lines = []
            mp.setattr("builtins.print", lambda *a, **k: lines.append(
                " ".join(map(str, a))))
            want = tsprites.main(argv, splits=corpus)
            _patch_eager_graphs(mp)
            got = tsprites.main(argv, splits=corpus)
        out[name] = (got, want, lines)
    return out


def test_pretraining_epochs_equal_the_per_step_loop(runs):
    got, want, lines = runs["svgpvae"]
    assert ("pretraining representation net (3 epochs, batch 100): per "
            "step (a cpu device)") in lines
    assert ("pretraining representation net (3 epochs, batch 100): each "
            "epoch replays a captured CUDA graph of the step, one readback "
            "an epoch") in lines
    pre, pre_want = got["pretrain"], want["pretrain"]
    assert pre["epochs"] == pre_want["epochs"] and len(pre["epochs"]) == 3
    assert "test_action_acc" in pre["epochs"][0]
    assert pre["steps"] == pre_want["steps"] == 6
    # 2 full steps an epoch: epoch 0 warms up, the next 4 replay
    assert pre["graph_replays"] == {"full": 4}
    assert pre_want["graph_replays"] == {}


@pytest.mark.parametrize("name", ["svgpvae", "vae"])
def test_eval_calls_equal_the_per_step_eval(name, runs):
    got, want, lines = runs[name]
    calls = CALLS if name == "svgpvae" else CALLS[:1]
    assert "eval pass: uncaptured (a cpu device)" in lines
    assert (f"eval pass: {len(calls)} calls ({', '.join(calls)}), each "
            "replaying a captured CUDA graph, each read back once") in lines
    scores = ("test_mse", "cgen_mse") if name == "svgpvae" else ("test_mse",)
    assert len(got["evals"]) == 2
    for ev, ev_want in zip(got["evals"], want["evals"]):
        assert {k: ev[k] for k in scores} == {k: ev_want[k] for k in scores}
        assert list(ev["seconds"]) == list(calls)
        assert ev["launches"] == ev_want["launches"]
    assert torch.equal(got["test_recon"], want["test_recon"])
    if name == "svgpvae":
        for g, w in zip(got["cgen_images"], want["cgen_images"]):
            assert torch.equal(g, w)
    else:
        assert got["cgen_images"] is want["cgen_images"] is None
    # each eval pass replays each call once (its first: warm-up, capture,
    # replay)
    assert got["eval_graph_replays"] == dict.fromkeys(calls, 2)
    assert want["eval_graph_replays"] == {}
    assert got["metrics"] == want["metrics"]
    assert _params_equal(got["state"].params, want["state"].params)


def test_graph_path_matches_jax_cli(tmp_path, corpus, monkeypatch):
    """The JAX CLI comparison of the per-step run, on the graph path: its
    eps_fn (the JAX key chain) has no generator, and the stand-in graphs
    call it anew at every replay."""
    _patch_eager_graphs(monkeypatch)
    monkeypatch.setattr(tmnist.Noise, "generator", torch.Generator())
    runs, main = [], tsprites.main

    def recorded(*a, **k):
        runs.append(main(*a, **k))
        return runs[-1]

    monkeypatch.setattr(tsprites, "main", recorded)
    sprites_cli.test_main_matches_jax_cli(
        tmp_path, tdata.generate_synthetic_sprites(
            n_train_chars=sprites_cli.MAIN_CHARS,
            n_test_chars=max(2, sprites_cli.MAIN_CHARS // 4),
            n_frames_train=50, seed=0))
    (res,) = runs
    # pretraining: 150 frames, batch 100, 2 epochs of one step, both
    # warm-ups; the main loop a full step and a tail, both warm-ups: the
    # graph path's bookkeeping against JAX.  The eval calls replay.
    assert res["pretrain"]["graph_replays"] == {}
    assert res["eval_graph_replays"] == dict.fromkeys(CALLS, 1)
    assert [c["steps"] for c in res["chunks"]] == [2]
