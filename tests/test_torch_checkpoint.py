"""Checkpoints with full resume (utils.checkpoint, TrainState.state_dict):
on the CPU a run cut after its first epoch and continued with
--resume_dir equals the uninterrupted run bit for bit, in every
parameter, Adam moment, GECO state and step metric; the write is atomic,
old checkpoints are pruned, and a checkpoint of another trainable set is
refused."""

from __future__ import annotations

import os

import pytest
import torch

from svgpvae_tpu_torch import data as tdata
from svgpvae_tpu_torch import train as ttrain
from svgpvae_tpu_torch import utils as tutils
from svgpvae_tpu_torch.cli import mnist as tmnist
from svgpvae_tpu_torch.cli import sprites as tsprites
from run_pictures import pictures
from torch_threads import _torch_threads  # noqa: E402,F401

MNIST_ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs", "--PCA",
              "--ip_joint", "--GP_joint", "--ov_joint", "--dataset", "36",
              "--eval_every", "1", "--L", "4", "--batch_size", "64",
              "--seed", "0", "--device", "cpu",
              "--gp_block_impl", "fused_pallas"]
# SPRITES checkpoints at the end of a run too: one eval pass, at the end
# of the uninterrupted run, is enough
SPRITES_ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs",
                "--synthetic", "--synthetic_chars", "3", "--eval_every", "2",
                "--nr_epochs_repr_nn", "1", "--batch_size", "100",
                "--batch_size_repr_nn", "100", "--L", "8",
                "--L_character", "9", "--seed", "0", "--device", "cpu",
                "--gp_block_impl", "fused_rejitter_pallas"]


@pytest.fixture(scope="module")
def mnist_splits():
    base = tdata.synthetic_digit_base_images("36", per_digit=10, seed=0)
    return tdata.generate_rotated_mnist(base, None, digits="36", seed=0)


@pytest.fixture(scope="module")
def corpus():
    return tdata.generate_synthetic_sprites(n_train_chars=3, n_test_chars=2,
                                            n_frames_train=50, seed=0)


def _assert_same_state(a: ttrain.TrainState, b: ttrain.TrainState):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"] and sa["trainable"] == sb["trainable"]
    for k, v in sa["params"].items():
        assert torch.equal(v, sb["params"][k]), k
    for k in ("C_ma", "lagrange_mult"):
        assert torch.equal(sa["geco"][k], sb["geco"][k]), k
    oa, ob = sa["optimizer"]["state"], sb["optimizer"]["state"]
    assert oa.keys() == ob.keys() and oa
    for i in oa:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)


@pytest.mark.parametrize("driver", ["mnist", "sprites"])
def test_resumed_run_equals_the_uninterrupted_one(driver, tmp_path,
                                                  mnist_splits, corpus):
    main, argv, splits = ((tmnist.main, MNIST_ARGV, mnist_splits)
                          if driver == "mnist" else
                          (tsprites.main, SPRITES_ARGV, corpus))
    full = main(argv + ["--opt_regime", "joint-2"], splits=splits)
    # --show_pics: accepted and ignored, as by the JAX drivers
    first = main(argv + ["--opt_regime", "joint-1", "--save",
                         "--save_model_weights", "--show_pics", "--base_dir",
                         str(tmp_path)], splits=splits)
    run_dir = first["run_dir"]
    assert run_dir.startswith(str(tmp_path))
    rest = main(argv + ["--opt_regime", "joint-1", "--resume_dir", run_dir,
                        "--save_model_weights"], splits=splits)
    if driver == "sprites":
        assert first["pretrain"]["steps"] == 1
        assert rest["pretrain"] is None  # skipped on resume
    n = len(rest["metrics"])
    assert n == len(first["metrics"]) and len(full["metrics"]) == 2 * n
    assert rest["metrics"] == full["metrics"][n:]
    _assert_same_state(rest["state"], full["state"])
    assert torch.equal(rest["noise"].generator.get_state(),
                       full["noise"].generator.get_state())
    if rest["evals"]:
        assert rest["evals"][-1]["cgen_mse"] == full["evals"][-1]["cgen_mse"]
    assert tutils.latest_step(os.path.join(run_dir, "ckpt")) == 2 * n
    # the JAX driver's pictures at each eval pass (MNIST every epoch:
    # svgpvae_tpu/cli/mnist.py:762, 805 and, with the metric rows that
    # --save turns on, 878; SPRITES with --eval_every 2 evaluates in
    # neither run)
    got = pictures(run_dir)
    want = ([f"{n}.png", f"{n}_cgen.png", f"{n}_kernels.png",
             f"{2 * n}.png", f"{2 * n}_cgen.png"] if driver == "mnist"
            else [])
    assert sorted(got) == sorted(want)
    for name, (h, w, text) in got.items():
        assert (h, w) == ((400, 1500) if "kernels" in name else (1000, 1000))
        assert ("Title" in text) != ("kernels" in name)
    if driver == "mnist":
        ev = rest["evals"][-1]
        assert got[f"{2 * n}.png"][2]["Title"] == \
            f"epoch 1. recon MSE test {ev['test_mse']:.4f}"
        assert got[f"{2 * n}_cgen.png"][2]["Title"] == \
            f"epoch 1. CGEN MSE {ev['cgen_mse']:.4f}"
        assert [p["file"] for p in first["pictures"]] == [
            f"{n}.png", f"{n}_cgen.png", f"{n}_kernels.png"]


def test_restore_is_bitwise(tmp_path, mnist_splits):
    """A fresh state restored from a checkpoint equals the saved one."""
    res = tmnist.main(MNIST_ARGV + ["--opt_regime", "joint-1", "--save",
                                    "--save_model_weights", "--base_dir",
                                    str(tmp_path)], splits=mnist_splits)
    fresh = tmnist.main(MNIST_ARGV + ["--opt_regime", "joint-0"],
                        splits=mnist_splits)
    ckpt = tutils.restore_checkpoint(os.path.join(res["run_dir"], "ckpt"))
    fresh["state"].load_state_dict(ckpt["train_state"])
    _assert_same_state(fresh["state"], res["state"])
    assert torch.equal(ckpt["noise"], res["noise"].generator.get_state())


def _state(trainable):
    params = {"net": torch.nn.Linear(3, 2)}
    tensors = ttrain.trainable_tensors(
        params, lambda name: name.split("/")[-1] in trainable)
    opt = ttrain.make_optimizer(tensors, 1e-2)
    state = ttrain.TrainState(params=params, optimizer=opt,
                              geco=ttrain.GECOState.init())
    loss = sum(t.sum() for t in tensors.values())
    loss.backward()
    opt.step()
    return state


def test_atomic_write_leaves_no_partial_file(tmp_path, monkeypatch):
    ckpt_dir = str(tmp_path / "ckpt")
    tutils.save_checkpoint(ckpt_dir, {"a": torch.ones(3)}, 5)

    def torn_save(obj, path):  # dies halfway through the write
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk gone")

    monkeypatch.setattr(torch, "save", torn_save)
    with pytest.raises(OSError, match="disk gone"):
        tutils.save_checkpoint(ckpt_dir, {"a": torch.zeros(3)}, 6)
    assert sorted(os.listdir(ckpt_dir)) == ["5.pt"]
    assert tutils.latest_step(ckpt_dir) == 5
    assert torch.equal(tutils.restore_checkpoint(ckpt_dir)["a"],
                       torch.ones(3))


def test_max_to_keep_keeps_the_newest(tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    for step in (3, 10, 7, 20, 15):
        tutils.save_checkpoint(ckpt_dir, {"step": step}, step)
    assert sorted(os.listdir(ckpt_dir)) == ["10.pt", "15.pt", "20.pt"]
    assert tutils.latest_step(ckpt_dir) == 20
    assert tutils.restore_checkpoint(ckpt_dir, 10)["step"] == 10
    assert tutils.latest_step(str(tmp_path / "none")) is None


def test_other_trainable_set_is_refused(tmp_path):
    saved = _state(trainable=("weight", "bias"))
    tutils.save_checkpoint(str(tmp_path), saved.state_dict(), 1)
    ckpt = tutils.restore_checkpoint(str(tmp_path))
    other = _state(trainable=("weight",))
    with pytest.raises(ValueError, match=r"net/bias"):
        other.load_state_dict(ckpt)
    same = _state(trainable=("weight", "bias"))
    same.load_state_dict(ckpt)
    assert torch.equal(same.params["net"].weight, saved.params["net"].weight)


def test_result_saver_appends_to_a_matching_file(tmp_path):
    """A resumed run appends its rows to the run's CSV; a file with other
    columns is left alone and a timestamped sibling started."""
    path = str(tmp_path / "res.csv")
    tutils.ResultSaver(path, ["step", "x"], flush_every=1)([1, 0.5])
    again = tutils.ResultSaver(path, ["step", "x"], flush_every=1)
    again([2, torch.tensor(0.25)])
    with open(path) as f:
        assert f.read().split() == ["step,x", "1,0.5", "2,0.25"]
    other = tutils.ResultSaver(path, ["step", "y"], flush_every=1)
    assert other.path != path and other.path.startswith(path + "_")
    with pytest.raises(ValueError, match="expected 2 values"):
        other([1])
