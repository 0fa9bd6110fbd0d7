"""The port's drivers under --data_parallel against their own 1-process
runs, on 5 CPU ranks under gloo (the port's 1-process drivers are pinned
to the JAX drivers by their own tests).

On the same data, weights and draws, the 5-rank run must take the
1-process run's steps:

  * cli.mnist SVGPVAE_Hensman + GECO at --x64, batch 100 (20 rows a rank)
    with a tail batch of 2, which runs replicated: one epoch with --save
    --save_model_weights, then a second epoch from --resume_dir on every
    rank, against one unbroken 2-epoch run; rank 0 alone makes the run
    dir (tests/parallel_cases.py::shared_run_dir).  Every step's metrics,
    the GECO state, the parameters, the eval rows and the captured step's
    gradients within 1e-9 (float64 summed in other orders);
  * cli.mnist SVIGP_Hensman (deep SVIGP), fp32;
  * cli.sprites Hensman + GECO, batch 150 (3 characters, 30 frames a
    rank, so that ranks 1 and 3 start inside a character) and a
    replicated tail of one character, fp32, with --save;
  * cli.ball SVGPVAE_Hensman at 5 ranks (the batch of 35 videos, 7 a
    rank), fp32; and the picture flags over 5 ranks: --save
    --squares_circles --plot_every 3 (every rank runs the pictures' and
    probes' eval passes, rank 0 alone draws into its one run dir) and
    --profile_dir with --show_pics (ignored; no run dir, no pictures);
  * cli.serve --data_parallel 5 from the SPRITES run dir (350 rows, 70 a
    rank) against the unsharded serve of the same run.

fp32 tolerances: per-step metrics 1e-5 of |value|, GECO state 1e-5, the
captured step's gradients 2e-4 of each tensor's max |entry| (as the
1-process driver tests hold the port to JAX), eval rows 1e-4, the
serve's p_m and p_v 1e-5 of their max |entry|.  Parameters after Adam
steps at fp32: within 2.5 lr, since Adam moves an entry by ~lr whatever
the size of its gradient and a gradient entry within round-off of 0 may
step either way; the gradients are what catches a sum counted once per
rank too many (Adam would hide a common factor).
"""

import glob
import os

import numpy as np
import pytest
import torch

from svgpvae_tpu_torch.cli import ball as tball, mnist as tmnist
from svgpvae_tpu_torch.cli import serve as tserve, sprites as tsprites

import parallel_cases as pc
from run_pictures import pictures
from torch_threads import _torch_threads  # noqa: E402,F401

WORLD = 5
MNIST = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs", "--PCA",
         "--ip_joint", "--GP_joint", "--ov_joint", "--dataset", "36",
         "--eval_every", "1", "--L", "6", "--batch_size", "100", "--seed",
         "0", "--device", "cpu", "--x64"]
SVIGP = ["--elbo", "SVIGP_Hensman", "--PCA", "--ip_joint", "--GP_joint",
         "--ov_joint", "--dataset", "36", "--nr_epochs", "1",
         "--eval_every", "1", "--L", "6", "--batch_size", "100", "--seed",
         "0", "--device", "cpu"]
SPRITES = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs", "--synthetic",
           "--opt_regime", "joint-1", "--eval_every", "1",
           "--nr_epochs_repr_nn", "1", "--batch_size", "150",
           "--batch_size_repr_nn", "100", "--L", "8", "--device", "cpu",
           "--seed", "0"]
BALL = ["--elbo", "SVGPVAE_Hensman", "--steps", "3", "--eval_every", "3",
        "--device", "cpu"]
DP = ["--data_parallel", str(WORLD)]
CAPTURE = 1


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return {k: str(tmp_path_factory.mktemp(k)) for k in
            ("mnist", "sprites", "ball", "ball_pics", "ranks")}


@pytest.fixture(scope="module")
def ranks(dirs):
    save = ["--save", "--save_model_weights"]
    cases = {
        "mnist": ("driver_case", dict(
            driver="mnist", data="mnist", capture_step=CAPTURE,
            argv=MNIST + DP + save + ["--opt_regime", "joint-1",
                                      "--base_dir", dirs["mnist"]],
            resume_argv=MNIST + DP + save + ["--opt_regime", "joint-1"])),
        "svigp": ("driver_case", dict(driver="mnist", data="mnist",
                                      capture_step=CAPTURE,
                                      argv=SVIGP + DP)),
        "sprites": ("driver_case", dict(
            driver="sprites", data="sprites", capture_step=CAPTURE,
            argv=SPRITES + DP + save + ["--base_dir", dirs["sprites"]])),
        "ball": ("driver_case", dict(
            driver="ball", capture_step=CAPTURE,
            argv=BALL + DP + ["--base_dir", dirs["ball"]])),
        **{name: ("driver_case", dict(driver="ball", argv=BALL + DP + flags
                                      + ["--base_dir", dirs["ball_pics"]]))
           for name, flags in ball_picture_cases(dirs).items()},
        "serve": ("serve_case", dict(base=dirs["sprites"], argv=[
            "--device", "cpu", "--out",
            os.path.join(dirs["ranks"], "served.npz")] + DP)),
    }
    return pc.Ranks(WORLD, cases, {}, dirs["ranks"])


def ball_picture_cases(dirs) -> dict:
    """The ball's picture flags over the ranks (refused before the
    pictures were ported)."""
    return {"squares_circles": ["--squares_circles", "--save",
                                "--plot_every", "3"],
            "show_pics": ["--profile_dir",
                          os.path.join(dirs["ranks"], "trace"),
                          "--show_pics"]}


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, (what, err, scale)


def _same_steps(got, want, rtol, grad_rtol, param_atol=None):
    """A rank run's summary against the 1-process run's."""
    assert len(got["metrics"]) == len(want["metrics"])
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        assert set(g) == set(w)
        for k in w:
            _close(g[k], w[k], rtol, (i, k))
    if want["geco"] is not None:
        _close(got["geco"], want["geco"], rtol, "geco")
    for g, w in zip(got["evals"], want["evals"]):
        for k, v in w.items():
            if v is not None and k != "epoch":  # a resumed run counts anew
                _close(g[k], v, max(rtol, 1e-4 if param_atol else rtol), k)
    assert set(got["params"]) == set(want["params"])
    for k, w in want["params"].items():
        if param_atol is None:
            _close(got["params"][k], w, rtol, k)
        else:
            assert np.abs(got["params"][k] - w).max() <= param_atol, k
    if want["grads"] is not None:
        assert set(got["grads"]) == set(want["grads"])
        for k, w in want["grads"].items():
            _close(got["grads"][k], w, grad_rtol, ("grad", k))


def _run_dirs(base):
    return glob.glob(os.path.join(base, "*", "*"))


def test_mnist_hensman_geco_resume_matches_one_process(ranks, dirs):
    want = pc.summary(tmnist.main(MNIST + ["--opt_regime", "joint-2"],
                                  splits=pc.mnist_splits(),
                                  capture_step=CAPTURE))
    got = ranks.results()["mnist"]
    n = len(got["first"]["metrics"])
    assert n == 3 and len(want["metrics"]) == 2 * n  # 2 full + the tail
    first = dict(got["first"], params=want["params"], geco=None,
                 evals=got["first"]["evals"])
    head = dict(want, metrics=want["metrics"][:n], evals=want["evals"][:1],
                geco=None)
    _same_steps(first, head, 1e-9, 1e-9)
    rest = dict(got, metrics=got["first"]["metrics"] + got["metrics"],
                evals=got["first"]["evals"] + got["evals"],
                grads=got["first"]["grads"])
    _same_steps(rest, want, 1e-9, 1e-9)
    # rank 0 alone made a run dir, and the resumed run wrote into it
    assert _run_dirs(dirs["mnist"]) == [got["run_dir"].rstrip("/")]
    assert len(os.listdir(os.path.join(got["run_dir"], "ckpt"))) == 2


def test_svigp_matches_one_process(ranks):
    want = pc.summary(tmnist.main(SVIGP, splits=pc.mnist_splits(),
                                  capture_step=CAPTURE))
    _same_steps(ranks.results()["svigp"], want, 1e-5, 2e-4, 2.5e-3)


def test_sprites_straddling_shares_match_one_process(ranks, dirs, tmp_path):
    want = pc.summary(tsprites.main(SPRITES + ["--base_dir", str(tmp_path)],
                                    splits=pc.sprites_splits(),
                                    capture_step=CAPTURE))
    got = ranks.results()["sprites"]
    assert len(want["metrics"]) == 3  # 2 full batches and the tail
    _same_steps(got, want, 1e-5, 2e-4, 2.5e-3)
    assert len(_run_dirs(dirs["sprites"])) == 1  # made by rank 0 alone


def test_ball_five_ranks_match_one_process(ranks, dirs):
    want = pc.summary(tball.main(BALL + ["--base_dir", dirs["ball"]],
                                 capture_step=CAPTURE))
    _same_steps(ranks.results()["ball"], want, 1e-5, 2e-4, 2.5e-3)


@pytest.mark.parametrize("case", ["squares_circles", "show_pics"])
def test_ball_picture_flags_over_five_ranks(ranks, dirs, case):
    got = ranks.results()[case]
    if case == "show_pics":
        assert got["run_dir"] is None and got["pictures"] == []
        return
    run_dir = got["run_dir"]
    assert _run_dirs(dirs["ball_pics"]) == [run_dir.rstrip("/")]
    assert {k: v[:2] for k, v in pictures(run_dir).items()} == {
        "000003.png": (600, 800), "000003_circles.png": (400, 800),
        "000003_squares.png": (400, 800)}
    (record,) = got["pictures"]
    assert record["step"] == 3 and set(record["probes"]) == {"circles",
                                                             "squares"}
    for aligned in record["probes"].values():
        assert aligned.shape == (30, 2) and np.isfinite(aligned).all()


def test_serve_sharded_fit_matches_unsharded(ranks, dirs):
    got = ranks.results()["serve"]  # the SPRITES run dir is written
    res = tserve.main(["--run_dir", _run_dirs(dirs["sprites"])[0],
                       "--device", "cpu", "--out",
                       os.path.join(dirs["ranks"], "one.npz")],
                      splits=pc.sprites_splits())
    served = res["state"]["served"][0]
    for k in ("p_m", "p_v"):
        _close(got[k], served[k].numpy(), 1e-5, k)
    assert got["fit_launches"] == res["fit_launches"]  # 0 on the CPU
