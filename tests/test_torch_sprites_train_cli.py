"""The port's SPRITES trainer (Hensman + GECO) through its driver, against
the JAX package (the modules: tests/test_torch_sprites_train.py).

  * the whole slice: cli.sprites.main(..., "--device", "cpu") on a tiny
    in-memory corpus (pretraining, the main steps with the tail, one eval
    pass), against JAX's CLI run on the same corpus with the same
    weights and noise: test MSE and cgen MSE within rtol 1e-4, and no
    kernel launch counted on the CPU.  Both save: the port's run dir
    holds exactly the PNG names of the JAX CLI's (<step>_recon.png and
    <step>_cgen.png), each a 1000 x 1000 grid with its title.  It uses
    the CLI's default L_action 8 and L_character 16: the CLI makes 72
    inducing points, so the small widths would be rank-deficient, where
    A_hat + jitter loses positive definiteness in fp32 in both packages;
  * --basin_retry, sprites_pca_init, the batcher, the dispatch cells,
    the refusals, the corpus guard, and that the entry point imports no
    jax.
"""

import contextlib
import functools
import io
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import data as jdata, gp as jgp, models as jmodels
from svgpvae_tpu import nn as jnets
from svgpvae_tpu.cli import sprites as jsprites
from svgpvae_tpu_torch import data as tdata, models as tmodels
from svgpvae_tpu_torch import train as ttrain
from svgpvae_tpu_torch.cli import sprites as tsprites

from test_torch_sprites_train import (FPC, KAPPA, L, L_ACT, L_CHAR,
                                      N_ACTIONS, ROOT, _assert_params,
                                      _flat_port_names, flatten_params)
from run_pictures import pictures
from torch_threads import _torch_threads  # noqa: E402,F401


# --- the whole slice ----------------------------------------------------------


MAIN_CHARS = 3  # 150 train frames: a full batch of 100 and a tail of 50
SLICE_ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs",
              "--synthetic", "--synthetic_chars", str(MAIN_CHARS),
              "--opt_regime", "joint-1", "--eval_every", "1",
              "--nr_epochs_repr_nn", "2", "--batch_size", "100",
              "--batch_size_repr_nn", "100", "--L", str(L), "--seed", "0",
              "--gp_block_impl", "fused_rejitter_pallas"]  # the CUDA block


@pytest.fixture(scope="module")
def corpus():
    return tdata.generate_synthetic_sprites(
        n_train_chars=MAIN_CHARS, n_test_chars=max(2, MAIN_CHARS // 4),
        n_frames_train=FPC, seed=0)


def _jax_eps(seed):
    """eps_fn giving the JAX CLI's draws: main step t uses the subkey of
    the t-th split of fold_in(PRNGKey(seed), 202); every eval batch uses
    PRNGKey(11)."""
    key = [jax.random.fold_in(jax.random.PRNGKey(seed), 202)]

    def eps_fn(kind, shape):
        if kind == "train":
            key[0], sub = jax.random.split(key[0])
        else:
            sub = jax.random.PRNGKey(11)
        return torch.from_numpy(np.array(jax.random.normal(sub, shape)))
    return eps_fn


def _jax_cli_init(seed, n_chars, args):
    """The JAX CLI's initial parameters (vae, repr, head from
    PRNGKey(seed), the GP from RandomState(seed)) as a flat dict."""
    key, dummy = jax.random.PRNGKey(seed), jnp.zeros((2, 64, 64, 3))
    rng = np.random.RandomState(seed)
    gplvm = rng.normal(0, 1.5, (N_ACTIONS, args.L_action))
    ip = rng.normal(0, 1.5, (N_ACTIONS, args.L_action + args.L_character))
    return flatten_params({
        "vae": jnets.SpritesVAE(L=args.L).init(key, dummy),
        "repr": jnets.SpritesReprNet(L=args.L_character).init(key, dummy),
        "head": jnets.ClassificationHead(num_classes=n_chars).init(
            key, jnp.zeros((2, args.L_character))),
        "gp": jgp.init_sprites_svgp(ip, gplvm, L_action=args.L_action)})


def test_main_matches_jax_cli(tmp_path, corpus):
    args = tsprites.build_parser().parse_args(SLICE_ARGV)
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **_jax_cli_init(0, MAIN_CHARS, args))
    got = tsprites.main(SLICE_ARGV + ["--device", "cpu", "--params", npz,
                                      "--save", "--base_dir",
                                      str(tmp_path / "port")],
                        splits=corpus, eps_fn=_jax_eps(0))

    jargs = jsprites.build_parser().parse_args(
        SLICE_ARGV + ["--sprites_data_path", str(tmp_path / "corpus"),
                      "--save", "--base_dir", str(tmp_path / "jax")])
    with contextlib.redirect_stdout(io.StringIO()):
        want = jsprites.run_experiment(jargs)
    (jax_run,) = [os.path.join(r, d) for r, ds, _ in os.walk(tmp_path / "jax")
                  for d in ds if d == "pics"]
    pics = pictures(got["run_dir"])
    assert sorted(pics) == sorted(p for p in os.listdir(jax_run)
                                  if p.endswith(".png"))
    ev = got["evals"][0]
    assert {k: (h, w, t["Title"]) for k, (h, w, t) in pics.items()} == {
        "2_recon.png": (1000, 1000,
                        f"epoch 1. recon MSE {ev['test_mse']:.4f}"),
        "2_cgen.png": (1000, 1000, f"epoch 1. CGEN MSE {ev['cgen_mse']:.4f}")}
    assert len(got["metrics"]) == 2 and got["pretrain"]["steps"] == 2
    np.testing.assert_allclose(got["cgen_mse"], want["best_cgen_mse"],
                               rtol=1e-4)
    state = want["state"]
    _assert_params(ttrain.named_tensors(got["state"].params),
                   _flat_port_names(flatten_params(state.params)))

    # the test recon MSE of the JAX CLI's eval pass, on its final state
    vae, rep = jnets.SpritesVAE(L=L), jnets.SpritesReprNet(L=16)
    tc = corpus["test_character"]
    recon = jax.jit(lambda params, geco: jmodels.forward_pass_svgpvae(
        vae, params["vae"], params["gp"],
        (jnp.asarray(tc["frames"]), jnp.asarray(tc["aux_data"][:, 1])),
        jax.random.PRNGKey(11), beta=0.001, C_ma=geco.C_ma,
        lagrange_mult=geco.lagrange_mult, alpha=0.99, kappa=KAPPA,
        clip_qs=True, geco=True, repr_apply=rep.apply,
        repr_params=params["repr"], frames_per_char=N_ACTIONS,
        gp_block_impl="fused_rejitter_pallas").recon_loss)(
            state.params, state.geco)  # one compile, not per op
    ev = got["evals"][0]
    np.testing.assert_allclose(ev["test_mse"],
                               float(recon) / len(tc["frames"]), rtol=1e-4)
    # CPU tensors: the twins ran and no kernel launched
    assert all(n == 0 for s in got["step_launches"] for n in s.values())
    assert all(n == 0 for s in ev["launches"].values() for n in s.values())


def test_basin_retry_restarts_from_the_pretrained_params(corpus):
    """--basin_retry: a restart (forced here by a 100% descent demand)
    begins from the post-pretraining parameters with a fresh GECO state.
    --PCA takes the numpy PCA initializers; with them this corpus drives
    fused_rejitter_pallas's A_hat + jitter off positive definiteness in
    fp32 at the tail step, in the JAX CLI as in the port, so this run
    takes the Cholesky form of the rejittered block."""
    argv = SLICE_ARGV + [
        "--device", "cpu", "--PCA", "--gp_block_impl", "fused_rejitter",
        "--basin_retry", "1",
        "--basin_detect_evals", "1", "--basin_detect_rel", "1.0"]
    first = tsprites.main(argv, splits=corpus, capture_step=0)
    again = tsprites.main(argv, splits=corpus, capture_step=2)
    assert again["basin_attempts"] == 1 and len(again["evals"]) == 2
    assert len(again["metrics"]) == 4
    a, b = first["captured"], again["captured"]
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k
    assert float(b["geco"].C_ma) == 0.0
    assert float(b["geco"].lagrange_mult) == 1.0
    assert not torch.equal(a["eps"], b["eps"])  # a new noise stream


# --- pieces -----------------------------------------------------------------


def test_sprites_pca_init_matches_jax(monkeypatch):
    """The JAX package's PCA is sklearn's with its default solver, which
    at these shapes is a randomized SVD drawn from numpy's global RNG:
    approximate (its 2nd and 3rd components differ from the exact ones by
    ~2% here) and different from run to run.  The JAX function is run
    with sklearn's exact solver instead; the port's numpy SVD is exact."""
    from sklearn.decomposition import PCA
    monkeypatch.setattr(jdata.sprites, "PCA",
                        functools.partial(PCA, svd_solver="full"))
    train_d = tdata.generate_synthetic_sprites(4, 2, FPC, seed=3)["train"]
    want = jdata.sprites_pca_init(train_d, m=2, L_action=L_ACT,
                                  L_character=L_CHAR)
    got = tdata.sprites_pca_init(train_d, m=2, L_action=L_ACT,
                                 L_character=L_CHAR)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max())


def test_batch_iterator_matches_jax(corpus):
    tc = corpus["test_character"]
    for (gf, ga), (wf, wa) in zip(tdata.sprites_batch_iterator(tc, 100),
                                  jdata.sprites_batch_iterator(tc, 100),
                                  strict=True):
        assert np.array_equal(gf, wf) and np.array_equal(ga, wa)


def test_dispatch_cells():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    resolve = tmodels.resolve_gp_block_impl
    assert resolve("auto", workload="sprites", device=cuda) == \
        "fused_rejitter_pallas"
    assert resolve("auto", workload="sprites", device=cpu) == "reference"
    assert jmodels.svgpvae.GP_BLOCK_AUTO_TABLE[
        ("sprites", "hensman", "other")][0] == "reference"
    # PARITY.md #10: no SPRITES Hensman cell resolves to an identity-KL
    # block
    for (workload, bound, _), (impl, _) in \
            tmodels.GP_BLOCK_AUTO_TABLE.items():
        if workload == "sprites" and bound == "hensman":
            assert impl not in ("fused", "fused_pallas")
    # Titsias: the Cholesky Woodbury block on every device, as JAX
    for device, backend in ((cuda, "tpu"), (cpu, "other")):
        assert resolve("auto", workload="sprites", titsias=True,
                       device=device) == "fused" == \
            jmodels.svgpvae.GP_BLOCK_AUTO_TABLE[
                ("sprites", "titsias", backend)][0]


@pytest.mark.parametrize("flag", [
    # the TPU rewrites stay refused under --data_parallel, which runs
    # (tests/test_torch_parallel_drivers.py)
    ["--elbo", "VAE", "--data_parallel", "2", "--s2d64"],
    ["--test_set_metrics", "--data_parallel", "2", "--fused_upsample"],
    ["--bf16", "--s2d64"], ["--bf16_hybrid", "--fused_upsample"],
    ["--data_parallel", "2", "--s2d64"],
    ["--profile_dir", "x", "--data_parallel", "4", "--fused_upsample"],
    ["--reshuffle", "--data_parallel", "2", "--s2d64"],
    ["--s2d64"], ["--fused_upsample"]])
def test_unported_flags_are_refused(flag, corpus):
    with pytest.raises(SystemExit, match="not ported"):
        tsprites.main(SLICE_ARGV + ["--device", "cpu"] + flag, splits=corpus)


@pytest.mark.parametrize("flag,match", [
    (["--opt_regime", "VAE-1", "joint-1"], "jointly"),
    (["--batch_size", "120"], "multiple of 50"),
    (["--K_SE", "--object_kernel_normalize"], "at most one"),
    (["--basin_retry", "1", "--resume_dir", "x"], "cannot be combined")])
def test_bad_configurations_are_refused(flag, match, corpus):
    with pytest.raises(SystemExit, match=match):
        tsprites.main(SLICE_ARGV + ["--device", "cpu"] + flag, splits=corpus)


def test_ensure_dataset_guards_the_corpus(tmp_path):
    path = str(tmp_path / "corpus")
    args = tsprites.build_parser().parse_args(
        ["--synthetic", "--synthetic_chars", "2", "--sprites_data_path",
         path])
    tsprites.ensure_dataset(args)
    assert len(tdata.load_sprites(path)["train"]["frames"]) == 2 * FPC
    args.synthetic_chars = 3
    with pytest.raises(SystemExit, match="N_train=100"):
        tsprites.ensure_dataset(args)
    args.allow_stale_corpus = True
    tsprites.ensure_dataset(args)  # reused
    # a raw npy corpus in the published layout is preprocessed into shards,
    # and wins over --synthetic, as in the JAX CLI
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.RandomState(0)
    for action in ("walk", "spellcard", "slash"):
        for direction in ("front", "left", "right"):
            for split, n in (("train", 2), ("test", 1)):
                attrs = np.zeros((n, 8, 4, 6), np.float32)
                for i in range(n):
                    attrs[i, :, :, (i + 2 * (split == "test")) % 6] = 1.0
                stem = raw / f"{action}_{direction}"
                np.save(f"{stem}_frames_{split}.npy",
                        rng.rand(n, 8, 64, 64, 3).astype(np.float32))
                np.save(f"{stem}_attributes_{split}.npy", attrs)
    tsprites.ensure_dataset(tsprites.build_parser().parse_args(
        ["--synthetic", "--sprites_data_path", str(raw)]))
    got = tdata.load_sprites(str(raw))
    assert len(got["train"]["frames"]) == 2 * FPC
    assert len(got["test_character"]["frames"]) == N_ACTIONS


def test_main_refuses_a_missing_cuda_device(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tsprites.main(SLICE_ARGV, splits=corpus)


def test_sprites_entry_point_imports_no_jax():
    """Importing the SPRITES trainer, the nets and the card's gate and
    profile tools adds no module of jax, flax, optax or sklearn (compared
    before/after, so a preloading hook cannot mask an import)."""
    code = (
        "import sys\n"
        "banned = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'sklearn',\n"
        "          'svgpvae_tpu')\n"
        "def mods(): return {m for m in sys.modules "
        "if m.split('.')[0] in banned}\n"
        "before = mods()\n"
        "import svgpvae_tpu_torch.cli.sprites\n"
        "import svgpvae_tpu_torch.data.sprites, svgpvae_tpu_torch.utils\n"
        "import svgpvae_tpu_torch.nn.nets\n"
        "sys.path.insert(0, 'tools')\n"
        "import quality_gate, profile_torch_sprites_step\n"
        "added = sorted(mods() - before)\n"
        "assert not added, added\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
