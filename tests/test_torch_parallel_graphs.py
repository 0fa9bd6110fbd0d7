"""The drivers' data-parallel runs on their graph paths (the loops that
replay CUDA graphs over NCCL, one card a rank) against their per-step
data-parallel runs, on 2 CPU ranks under gloo, and one of them against
the JAX package's data-parallel driver.

On the CPU each CUDA graph is replaced by an eager call of what it would
capture (tests/graph_standins.py, as in tests/test_torch_epoch_chunk.py:
capture.Graph runs its function at every replay, Adam's lr is a float64
tensor, which gives the float lr's bits), so the graph path's
bookkeeping under --data_parallel (each full step's rows cut to the
rank's share inside parallel.sharded, the tail step replicated with its
mean all-reduces, the GECO pair and the lr table) is held to the
per-step loop, which gloo runs, bit for bit:

  * cli.mnist SVGPVAE_Hensman + GECO, batch 100 over 2 ranks (50 rows a
    rank) and a replicated tail of 2, 2 epochs with --lr_decay; and the
    same run with --epoch_chunk 2 --eval_bundle (one chunk of both
    epochs, the bundled eval with its sharded cgen fit);
  * cli.mnist SVIGP_Hensman (deep SVIGP), VAE and CVAE, and
    SVGPVAE_Hensman + GECO with --opt_regime VAE-1 joint-1 VAE-1 joint-1
    (the VAE phases' graphs beside the joint ones, over one optimizer);
  * cli.sprites Hensman + GECO on 7 characters, batch 150 (75 frames a
    rank, so rank 1's share starts inside a character) and a replicated
    tail of one character, with the pretraining and the eval calls on
    their graph paths too.
Every step's metrics, the final parameters and GECO state, the eval
rows, and the all-reduces issued (parallel.all_reduce_count; the graph
path's eval calls issue one more in the warm-up of a call that holds
one) are equal.

The JAX package: cli.sprites on its graph path over 2 ranks, with the
JAX CLI's initial parameters and its draws (recorded from the port's
1-process run on JAX's key chain), against the JAX CLI run with
--data_parallel 2 on 2 of the 8 host devices, at
tests/test_torch_parallel_drivers.py's fp32 tolerances: the cgen MSE
within 1e-4 and the parameters within 2.5 lr.

Also: the capture gate names gloo and not NCCL (cli.mnist's
uncaptured_reason and per_step_reason; the ball keeps its per-step loop
under either, and says why), and parallel.backend_for picks NCCL only
with one rank per card.
"""

import contextlib
import io

import numpy as np
import jax
import pytest
import torch

from svgpvae_tpu.cli import sprites as jsprites
from svgpvae_tpu_torch import parallel
from svgpvae_tpu_torch.cli import ball as tball, mnist as tmnist
from svgpvae_tpu_torch.cli import sprites as tsprites
from svgpvae_tpu_torch.parallel import mesh

import parallel_cases as pc
from test_torch_sprites_train import _assert_params, _flat_port_names
from test_torch_sprites_train_cli import (  # noqa: F401 (corpus: fixture)
    MAIN_CHARS, SLICE_ARGV, _jax_cli_init, _jax_eps, corpus)
from export_jax_params import flatten_params  # noqa: E402
from torch_threads import _torch_threads  # noqa: E402,F401

WORLD = 2
DP = ["--data_parallel", str(WORLD)]
MNIST = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs", "--PCA",
         "--ip_joint", "--GP_joint", "--ov_joint", "--dataset", "36",
         "--opt_regime", "joint-2", "--eval_every", "1", "--L", "6",
         "--batch_size", "100", "--lr_decay", "0.5", "--seed", "0",
         "--device", "cpu"] + DP
MNIST_CHUNK = [{"1": "2"}.get(a, a) for a in MNIST] + [
    "--epoch_chunk", "2", "--eval_bundle"]
SVIGP = ["--elbo", "SVIGP_Hensman", "--PCA", "--ip_joint", "--GP_joint",
         "--ov_joint", "--dataset", "36", "--nr_epochs", "2",
         "--eval_every", "2", "--L", "6", "--batch_size", "100", "--seed",
         "0", "--device", "cpu"] + DP
SPRITES = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs", "--synthetic",
           "--opt_regime", "joint-2", "--eval_every", "1",
           "--nr_epochs_repr_nn", "1", "--batch_size", "150",
           "--batch_size_repr_nn", "100", "--L", "8", "--device", "cpu",
           "--seed", "0"] + DP
VAE = ["--nr_epochs", "2", "--eval_every", "2", "--clip_qs", "--dataset",
       "36", "--L", "6", "--batch_size", "100", "--seed", "0", "--device",
       "cpu"] + DP
VAE_PHASES = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs", "--PCA",
              "--ip_joint", "--GP_joint", "--ov_joint", "--dataset", "36",
              "--opt_regime", "VAE-1", "joint-1", "VAE-1", "joint-1",
              "--eval_every", "2", "--L", "6", "--batch_size", "100",
              "--lr_decay", "0.5", "--seed", "0", "--device", "cpu"] + DP
MNIST_DATA, SPRITES_DATA = ("mnist",), ("sprites",)
PAIRS = {"mnist": ("mnist", MNIST, MNIST_DATA),
         "mnist_chunk": ("mnist", MNIST_CHUNK, MNIST_DATA),
         "svigp": ("mnist", SVIGP, MNIST_DATA),
         "vae": ("mnist", ["--elbo", "VAE"] + VAE, MNIST_DATA),
         "cvae": ("mnist", ["--elbo", "CVAE"] + VAE, MNIST_DATA),
         "vae_phases": ("mnist", VAE_PHASES, MNIST_DATA),
         "sprites": ("sprites", SPRITES, SPRITES_DATA)}
# each run's graph replays: 2 epochs of 2 full batches and a tail, whose
# second epoch replays the graphs (the first's steps are their eager
# warm-ups); the bundled eval replays its one call; the VAE phases' run
# warms up and replays each kind's graphs over its 4 epochs
REPLAYS = {"mnist_chunk": {"full": 2, "tail": 1, "eval": 1},
           "vae_phases": {"VAE/full": 2, "VAE/tail": 1, "full": 2,
                          "tail": 1}}
# the JAX CLI's slice for 3 epochs (a full batch of 100 and a tail of 50
# each, so both graphs replay), one eval pass at the end
JAX_ARGV = [{"joint-1": "joint-3", "1": "3"}.get(a, a) for a in SLICE_ARGV]
SLICE_DATA = ("sprites", MAIN_CHARS, max(2, MAIN_CHARS // 4))
# tests/test_torch_parallel_drivers.py's fp32 tolerances: eval rows 1e-4;
# parameters after Adam steps within 2.5 lr (lr 1e-3), since Adam moves an
# entry by ~lr whatever its gradient's size and a gradient entry within
# round-off of 0 may step either way
EVAL_RTOL = 1e-4
PARAM_ATOL = 2.5e-3
# the eval calls whose graphs hold an all-reduce (the sharded fit, inside
# the MNIST cgen pass and the bundled group): their eager warm-up issues
# it once more than the per-step run does
WARMUP_ALL_REDUCES = {"mnist_chunk": 1, "sprites": 1, "mnist": 1,
                      "vae_phases": 1}


@pytest.fixture(scope="module")
def jax_setup(tmp_path_factory, corpus):  # noqa: F811
    """The JAX CLI's initial parameters (an .npz) and its draws, recorded
    from the port's 1-process run of the slice on JAX's key chain."""
    tmp = tmp_path_factory.mktemp("jax")
    args = tsprites.build_parser().parse_args(JAX_ARGV)
    npz = str(tmp / "params.npz")
    np.savez(npz, **_jax_cli_init(0, MAIN_CHARS, args))
    eps, draws = _jax_eps(0), {}

    def recording(kind, shape):
        out = eps(kind, shape)
        draws.setdefault(kind, []).append((tuple(shape), out.numpy()))
        return out

    one = tsprites.main(JAX_ARGV + ["--device", "cpu", "--params", npz],
                        splits=corpus, eps_fn=recording)
    return {"tmp": tmp, "npz": npz, "draws": draws, "one": one}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_setup):
    cases = {name: ("graph_pair_case", dict(driver=d, argv=argv, data=data))
             for name, (d, argv, data) in PAIRS.items()}
    cases["sprites_jax"] = ("graph_case", dict(
        driver="sprites", data=SLICE_DATA, draws="jax_draws",
        argv=JAX_ARGV + ["--device", "cpu", "--params", jax_setup["npz"]]
        + DP))
    return pc.Ranks(WORLD, cases, {"jax_draws": jax_setup["draws"]},
                    tmp_path_factory.mktemp("ranks"))


def _equal(got, want, warmups=0):
    """Two summaries (parallel_cases.summary) bit for bit; `got` issued
    `warmups` all-reduces more."""
    assert got["steps"] == want["steps"] and got["steps"] > 0
    assert got["metrics"] == want["metrics"]
    assert got["geco"] == want["geco"]
    assert got["evals"] == want["evals"] and want["evals"]
    assert got["params"].keys() == want["params"].keys()
    for k, w in want["params"].items():
        assert np.array_equal(got["params"][k], w), k
    assert got["all_reduces"] - warmups == want["all_reduces"] > 0


@pytest.mark.parametrize("case", sorted(PAIRS))
def test_graph_path_equals_per_step(ranks, case):
    """The data-parallel graph path (CPU stand-in graphs) against the
    same run per step under gloo."""
    pair = ranks.results()[case]
    _equal(pair["graphs"], pair["per_step"], WARMUP_ALL_REDUCES.get(case, 0))
    assert pair["per_step"]["graph_replays"] == {}
    assert pair["graphs"]["graph_replays"] == REPLAYS.get(
        case, {"full": 2, "tail": 1})


def test_sprites_graph_path_matches_jax_data_parallel(ranks, jax_setup):
    tmp = jax_setup["tmp"]
    jargs = jsprites.build_parser().parse_args(
        JAX_ARGV + DP + ["--sprites_data_path", str(tmp / "corpus")])
    assert len(jax.devices()) >= WORLD
    with contextlib.redirect_stdout(io.StringIO()):
        want = jsprites.run_experiment(jargs)
    got = ranks.results()["sprites_jax"]
    assert got["steps"] == 6 and got["graph_replays"] == {"full": 1,
                                                          "tail": 2}
    np.testing.assert_allclose(got["evals"][-1]["cgen_mse"],
                               want["best_cgen_mse"], rtol=EVAL_RTOL)
    _assert_params(got["params"],
                   _flat_port_names(flatten_params(want["state"].params)),
                   atol=PARAM_ATOL)
    # and the port's 1-process run of the same draws
    one = jax_setup["one"]
    np.testing.assert_allclose(got["evals"][-1]["cgen_mse"],
                               one["cgen_mse"], rtol=EVAL_RTOL)


class _Args:
    elbo, bias_analysis, x64 = "SVGPVAE_Hensman", False, False


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_capture_gate_names_gloo_not_nccl(backend, monkeypatch):
    group = mesh.Group(rank=0, world=2, backend=backend,
                       device=torch.device("cuda", 0))
    monkeypatch.setattr(mesh, "_GROUP", group)
    monkeypatch.setattr(mesh, "_ACTIVE", True)
    cuda = torch.device("cuda", 0)
    gen = torch.Generator()
    why = tmnist.uncaptured_reason(cuda)
    step_why = tmnist.per_step_reason(_Args(), cuda, False, None, gen)
    if backend == "nccl":
        assert why is None and step_why is None
    else:
        assert why == step_why == ("--data_parallel: gloo stages its "
                                   "all-reduces through the host")
    assert tmnist.uncaptured_reason(torch.device("cpu")) == "a cpu device"
    # the ball steps one by one under either backend, and says why
    ball_why = tball.per_step_reason(_Args(), cuda, False, None,
                                     tmnist.Noise(lambda k, s: None), None,
                                     False)
    if backend == "gloo":
        assert ball_why == why
    else:
        assert "NCCL" in ball_why
    # a 1-process run on a card captures
    monkeypatch.setattr(mesh, "_ACTIVE", False)
    assert tmnist.uncaptured_reason(cuda) is None


@pytest.mark.parametrize("per_device,cards,ranks,want", [
    (1, 4, 4, "nccl"), (1, 2, 2, "nccl"), (2, 1, 2, "gloo"),
    (4, 1, 4, "gloo")])
def test_backend_for_picks_nccl_only_with_a_card_per_rank(
        per_device, cards, ranks, want, monkeypatch):
    monkeypatch.setenv(mesh.RANKS_PER_DEVICE_ENV, str(per_device))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert parallel.resolve_data_parallel(ranks, 500, "cuda") == ranks
    assert mesh.backend_for("cuda") == want
    assert mesh.backend_for("cpu") == "gloo"
    assert [mesh.rank_device(r, "cuda").index for r in range(ranks)] == [
        r // per_device for r in range(ranks)]
    with pytest.raises(SystemExit, match="devices"):
        parallel.resolve_data_parallel(per_device * cards + 1, 500, "cuda")
