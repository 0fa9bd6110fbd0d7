"""The SPRITES driver's flags and the ball driver's, in the port, against
the JAX package.

  * the raw npy corpus: npys written here in the published layout (the
    nine {walk,spellcard,slash}_{front,left,right} frames/attributes x
    train/test files, a few sequences each) give, through the port's
    load_raw_sprites_npys + preprocess_sprites and through the driver's
    corpus step (shards written, then read back), the JAX package's
    splits exactly;
  * --reshuffle --test_set_metrics --profile_dir --save
    --save_model_weights, two epochs on three characters (a full batch
    of two, the tail of one) with JAX's permutations injected: each
    epoch's order is the one JAX's make_epoch_fn(shuffle=True,
    shuffle_block=50) scans (whole characters, the tail in place); the
    metric rows stand at the JAX CLI's step counts; the checkpoint keeps
    the permutation generator; the trace holds epoch 1's steps;
  * --test_set_metrics's rows against the JAX package: the port's driver
    from JAX parameters at --lr 0 (so its state after the epoch is those
    parameters), on nine test characters (648 frames, more than the 576
    of a full batch), against JAX's forward_pass_svgpvae at 72 frames
    per character on the batch the JAX CLI stages for its rows (taken
    from the CLI itself), with the same eval noise: every column within
    1e-4 of its scale (the fp32 tolerance of test_torch_sprites_train's
    forward) of JAX's float64 row, or 10x JAX's own fp32 distance from
    that row where it is larger; the GP row within 1e-6;
  * the sentinel on both drivers: a NaN forced through the draws under
    --save raises NonFiniteLossError with the JAX package's message for
    the same values, and leaves ckpt_nan/<step>.pt;
  * the ball's --profile_dir: the trace holds the steps of the JAX
    driver's second chunk (gcd of the three cadences).

Other comparisons are exact (splits, orders, ids, step counts, the
sentinel's message).
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
from svgpvae_tpu.cli import sprites as jcli
from svgpvae_tpu.gp.svgp import SVGPConfig as JConfig
from svgpvae_tpu.utils import metrics as jmetrics
from svgpvae_tpu_torch import data as tdata, gp as tgp, train as ttrain
from svgpvae_tpu_torch import utils as tutils
from svgpvae_tpu_torch.cli import ball as tball
from svgpvae_tpu_torch.cli import sprites as tsprites
from svgpvae_tpu_torch.utils.convert import sprites_train_params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from export_jax_params import flatten_params  # noqa: E402
from torch_threads import _torch_threads  # noqa: E402,F401

N_ACTIONS, FPC = 72, 50
ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs",
        "--repr_nn_pretrain", "no", "--batch_size", "100", "--L", "8",
        "--L_action", "4", "--L_character", "18", "--seed", "0",
        "--device", "cpu"]


def write_raw_corpus(path, n_train=3, n_test=2, seed=0):
    """The published raw layout, with n_train / n_test characters: each
    file holds one 8-frame sequence per character, in the same character
    order, and the attributes' 4 x 6 one-hots name the character."""
    rng = np.random.RandomState(seed)

    def attributes(n, offset):
        a = np.zeros((n, 8, 4, 6), np.float32)
        for i in range(n):
            for t in range(4):
                a[i, :, t, (i + offset + 2 * t) % 6] = 1.0
        return a

    for action in jdata.sprites.RAW_SPRITES_ACTIONS:
        for direction in jdata.sprites.RAW_SPRITES_DIRECTIONS:
            for split, n, offset in (("train", n_train, 0),
                                     ("test", n_test, n_train)):
                stem = os.path.join(path, f"{action}_{direction}")
                np.save(f"{stem}_frames_{split}.npy",
                        rng.rand(n, 8, 64, 64, 3).astype(np.float32))
                np.save(f"{stem}_attributes_{split}.npy",
                        attributes(n, offset))


def _assert_splits_equal(got, want):
    assert set(got) == set(want)
    for split in want:
        for k in ("frames", "aux_data"):
            np.testing.assert_array_equal(got[split][k], want[split][k],
                                          err_msg=f"{split}/{k}")


def test_raw_npys_preprocess_like_jax(tmp_path):
    write_raw_corpus(str(tmp_path))
    assert tdata.has_raw_sprites_npys(str(tmp_path))
    raw_t = tdata.load_raw_sprites_npys(str(tmp_path))
    raw_j = jdata.load_raw_sprites_npys(str(tmp_path))
    for a, b in zip(raw_t, raw_j):
        np.testing.assert_array_equal(a, b)
    x_tr, x_te, a_tr, a_te, d_tr, d_te = raw_j
    for seed in (0, 3):
        _assert_splits_equal(
            tdata.preprocess_sprites(x_tr, a_tr, d_tr, x_te, a_te, d_te,
                                     n_frames_train=FPC, seed=seed),
            jdata.preprocess_sprites(x_tr, a_tr, d_tr, x_te, a_te, d_te,
                                     n_frames_train=FPC, seed=seed))


def test_driver_preprocesses_a_raw_corpus(tmp_path):
    """The driver's corpus step on a directory of raw npys writes shards
    that read back as the JAX CLI's preprocessing (--corpus_seed)."""
    path = str(tmp_path)
    write_raw_corpus(path)
    args = tsprites.build_parser().parse_args(
        ["--sprites_data_path", path, "--corpus_seed", "2"])
    tsprites.ensure_dataset(args)
    x_tr, x_te, a_tr, a_te, d_tr, d_te = jdata.load_raw_sprites_npys(path)
    want = jdata.preprocess_sprites(x_tr, a_tr, d_tr, x_te, a_te, d_te,
                                    n_frames_train=FPC, seed=2)
    _assert_splits_equal(tdata.load_sprites(path), want)
    assert len(want["train"]["frames"]) == 3 * FPC


@pytest.fixture(scope="module")
def corpus():
    return tdata.generate_synthetic_sprites(n_train_chars=3, n_test_chars=2,
                                            n_frames_train=FPC, seed=0)


def _trace_events(trace_dir):
    (path,) = glob.glob(os.path.join(trace_dir, "*.json"))
    with open(path) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"]]


def test_reshuffle_test_set_metrics_and_profile(tmp_path, corpus,
                                                monkeypatch):
    # JAX's make_epoch_fn over the character ids of the stacked full
    # batch: two epochs, each permutation keyed off the state key
    ids = corpus["train"]["aux_data"][:, 0]

    def loss_fn(params, batch, key, geco, step):
        return jnp.sum(params["w"] * 0.0), (geco, {"ids": batch[0]})

    tx = jtrain.make_optimizer(1e-3)
    state = jtrain.TrainState.create({"w": jnp.zeros(())}, tx,
                                     jax.random.PRNGKey(5))
    epoch_fn = jtrain.make_epoch_fn(loss_fn, tx, donate=False, shuffle=True,
                                    shuffle_block=FPC)
    keys, want = [], []
    for _ in range(2):
        keys.append(state.key)
        state, ms = epoch_fn(state, (jnp.asarray(ids[:100])[None],))
        want.append(np.asarray(ms["ids"])[0])

    def perm_fn(n):  # the permutation make_epoch_fn drew
        pkey = jax.random.split(keys.pop(0))[1]
        return np.asarray(jax.random.permutation(pkey, n))

    orders = []
    batches = ttrain.epoch_batches

    def recording(tensors, batch_size, order=None):
        orders.append(order)
        return batches(tensors, batch_size, order)

    monkeypatch.setattr(ttrain, "epoch_batches", recording)
    got = tsprites.main(ARGV + ["--opt_regime", "joint-2", "--eval_every",
                                "2", "--reshuffle", "--test_set_metrics",
                                "--profile_dir", str(tmp_path / "trace"),
                                "--save", "--save_model_weights",
                                "--base_dir", str(tmp_path)],
                        splits=corpus, perm_fn=perm_fn)
    assert len(orders) == 2 and not keys
    for order, w in zip(orders, want):
        np.testing.assert_array_equal(ids[order.numpy()[:100]], w)
        np.testing.assert_array_equal(order.numpy()[100:],
                                      np.arange(100, 150))
    assert not np.array_equal(want[0], want[1])

    # the metric rows: one per epoch, at the JAX CLI's steps_done
    csv = _csv_rows(got["run_dir"], "ELBO_results.csv")
    assert [r[0] for r in csv] == [2, 4]

    # the checkpoint keeps the permutation stream; the trace, epoch 1
    ckpt = tutils.restore_checkpoint(os.path.join(got["run_dir"], "ckpt"))
    assert torch.equal(ckpt["shuffle"], got["shuffle"].generator.get_state())
    names = _trace_events(tmp_path / "trace")
    assert names.count("train_step") == 2 and "gp_block" in names


def _csv_rows(run_dir, name):
    with open(os.path.join(run_dir, "res", name)) as f:
        return [[float(x) for x in line.split(",")]
                for line in f.read().strip().splitlines()[1:]]


def _jax_cli_metrics_batch(tmp_path, corpus, argv):
    """The batch the JAX CLI stages for its --test_set_metrics rows, taken
    from the CLI itself: its run stops where it asks for that batch."""
    class Staged(Exception):
        pass

    def staged(split, batch_size):
        raise Staged(split, batch_size)

    args = jcli.build_parser().parse_args(
        argv + ["--test_set_metrics", "--save", "--base_dir",
                str(tmp_path / "jax")])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "ensure_dataset", lambda args: None)
        mp.setattr(jdata, "load_sprites", lambda path: corpus)
        mp.setattr(jdata, "sprites_batch_iterator", staged)
        with pytest.raises(Staged) as info:
            jcli.run_experiment(args)
    split, batch_size = info.value.args
    assert split is corpus["test_character"]
    return next(jdata.sprites_batch_iterator(split, batch_size))


def test_test_set_metrics_rows_match_jax(tmp_path):
    corpus = tdata.generate_synthetic_sprites(
        n_train_chars=2, n_test_chars=9, n_frames_train=FPC, seed=1)
    argv = ARGV + ["--opt_regime", "joint-1", "--eval_every", "2"]
    args = tsprites.build_parser().parse_args(argv)
    n_train = len(corpus["train"]["frames"])

    # JAX parameters as the JAX CLI makes them (the GP from --seed's rng)
    dummy = jnp.zeros((2, 64, 64, 3))
    vae = jnets.SpritesVAE(L=args.L)
    rep = jnets.SpritesReprNet(L=args.L_character)
    rng = np.random.RandomState(args.seed)
    gplvm = rng.normal(0, 1.5, (N_ACTIONS, args.L_action))
    ip = rng.normal(0, 1.5, (N_ACTIONS * args.m,
                             args.L_action + args.L_character))
    params = {"vae": jax.jit(vae.init)(jax.random.PRNGKey(0), dummy),
              "repr": jax.jit(rep.init)(jax.random.PRNGKey(1), dummy),
              "gp": jgp.init_sprites_svgp(
                  ip, gplvm, L_action=args.L_action,
                  config=JConfig(jitter=args.jitter, N_train=n_train))}
    flat = flatten_params(params)
    np.savez(tmp_path / "params.npz", **flat)

    eval_key = jax.random.PRNGKey(11)  # the JAX CLI's eval key

    def eps_fn(kind, shape):
        if kind == "eval":
            return torch.from_numpy(np.array(jax.random.normal(eval_key,
                                                               shape)))
        return torch.zeros(shape)

    got = tsprites.main(argv + ["--test_set_metrics", "--save", "--lr", "0",
                                "--params", str(tmp_path / "params.npz"),
                                "--base_dir", str(tmp_path)],
                        splits=corpus, eps_fn=eps_fn)
    st = got["state"]
    start = sprites_train_params_from_jax(
        flat, tgp.SVGPConfig(jitter=args.jitter, N_train=n_train),
        args.L_action)
    want_p = ttrain.named_tensors(start)
    for k, v in ttrain.named_tensors(st.params).items():
        assert torch.equal(v, want_p[k]), k  # --lr 0 keeps the parameters

    frames, aux = _jax_cli_metrics_batch(
        tmp_path, corpus, [a for a in argv if a not in ("--device", "cpu")])
    n_test = len(corpus["test_character"]["frames"])
    assert n_test > 576 and len(frames) < n_test
    impl = jmodels.resolve_gp_block_impl("auto", workload="sprites")
    geco = [float(st.geco.C_ma), float(st.geco.lagrange_mult)]

    def jax_row(dtype):
        """The JAX CLI's row (svgpvae_tpu/cli/sprites.py, --test_set_metrics)
        at `dtype`, each column beside the scale its round-off takes."""
        nets = (jnets.SpritesVAE(L=args.L, dtype=dtype),
                jnets.SpritesReprNet(L=args.L_character, dtype=dtype))

        def fwd(p, batch, C_ma, lm):
            return jmodels.forward_pass_svgpvae(
                nets[0], p["vae"], p["gp"], batch, eval_key, beta=args.beta,
                C_ma=C_ma, lagrange_mult=lm, alpha=args.alpha,
                kappa=float(np.sqrt(args.kappa_squared)),
                clip_qs=args.clip_qs, geco=args.GECO,
                lagrange_max=args.geco_lambda_max, repr_apply=nets[1].apply,
                repr_params=p["repr"], frames_per_char=N_ACTIONS,
                gp_block_impl=impl)

        out = jax.jit(fwd)(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params),
            (jnp.asarray(frames, dtype), jnp.asarray(aux[:, 1], dtype)),
            *(jnp.asarray(g, dtype) for g in geco))
        cols = [(out.elbo, abs(out.recon_loss) + abs(out.kl_term)),
                (out.recon_loss, out.recon_loss),
                (out.kl_term, abs(out.ce_term) + abs(out.inside_elbo))]
        cols += [(f(x), f(x)) for x in (out.qnet_mu, out.qnet_var)
                 for f in (jnp.min, jnp.max)]
        cols += [(out.inside_elbo, abs(out.inside_elbo_recon)
                  + abs(out.inside_elbo_kl)),
                 (out.inside_elbo_recon, out.inside_elbo_recon),
                 (out.inside_elbo_kl, out.inside_elbo_kl),
                 (out.ce_term, out.ce_term)]
        cols += [(f(x), f(x)) for x in (out.p_m, out.p_v)
                 for f in (jnp.min, jnp.max)]
        cols += [(g, g) for g in geco]
        return [(float(v), abs(float(scale))) for v, scale in cols]

    want32 = jax_row(jnp.float32)
    with jax.enable_x64(True):
        want64 = jax_row(jnp.float64)
    (row,) = _csv_rows(got["run_dir"], "ELBO_results.csv")
    assert row[0] == n_train // 100  # steps_done: one step of 2 characters
    assert len(row) == 1 + len(want64)
    # each column against JAX's float64 within 1e-4 of its scale, or 10x
    # JAX's own fp32 distance from it where that is larger (the posterior
    # variance, whose fp32 round-off grows with cond K_mm)
    for i, (g, (w, scale), (w32, _)) in enumerate(
            zip(row[1:], want64, want32)):
        limit = max(1e-4 * max(scale, 1.0), 10 * abs(w32 - w))
        assert abs(g - w) <= limit, (i + 1, g, w, w32)

    gp = params["gp"]
    (gp_row,) = _csv_rows(got["run_dir"], "GP_params.csv")
    np.testing.assert_allclose(gp_row, [n_train // 100] + [float(x) for x in (
        jnp.linalg.norm(gp.gplvm_action), jnp.linalg.norm(gp.inducing_points),
        gp.l_action, gp.sigma_action, gp.l_character, gp.sigma_character)],
        rtol=1e-6)


def _nan_eps(kind, shape):
    return torch.full(shape, float("nan"))


def test_sprites_sentinel_writes_ckpt_nan_and_raises(tmp_path, corpus):
    with pytest.raises(tutils.NonFiniteLossError) as info:
        tsprites.main(ARGV + ["--opt_regime", "joint-1", "--save",
                              "--base_dir", str(tmp_path)],
                      splits=corpus, eps_fn=_nan_eps)
    steps = 2  # a full batch of two characters and the tail
    with pytest.raises(jmetrics.NonFiniteLossError) as want:
        jmetrics.check_finite([float("nan")] * steps, steps)
    (run_dir,) = glob.glob(str(tmp_path / "debug_SPRITES" / "*"))
    path = os.path.join(run_dir, "ckpt_nan")
    assert str(info.value) == (f"{want.value}; emergency checkpoint written "
                               f"to {path}")
    saved = tutils.restore_checkpoint(path, steps)
    assert saved["train_state"]["step"] == steps and "head" in saved
    assert any(not torch.all(torch.isfinite(t))
               for t in saved["train_state"]["params"].values())


BALL = ["--tmax", "6", "--m", "5", "--seed", "0", "--device", "cpu"]


def test_ball_sentinel_writes_ckpt_nan_and_raises(tmp_path):
    """The ball checks its eval ELBO (JAX: at the eval step g_s)."""
    with pytest.raises(tutils.NonFiniteLossError) as info:
        tball.main(BALL + ["--elbo", "VAE", "--steps", "2", "--eval_every",
                           "2", "--save", "--base_dir", str(tmp_path)],
                   eps_fn=_nan_eps)
    with pytest.raises(jmetrics.NonFiniteLossError) as want:
        jmetrics.check_finite([float("nan")], 2)
    (run_dir,) = glob.glob(str(tmp_path / "debug" / "*"))
    path = os.path.join(run_dir, "ckpt_nan")
    assert str(info.value) == (f"{want.value}; emergency checkpoint written "
                               f"to {path}")
    saved = tutils.restore_checkpoint(path, 2)
    assert saved["train_state"]["step"] == 2 and "videos" in saved


def test_ball_profile_traces_the_second_chunk(tmp_path, capsys):
    """Cadences 4, 6 and 2: chunk 2, so steps 2 and 3 of 5 are traced."""
    tball.main(BALL + ["--elbo", "SVGPVAE_Hensman", "--clip_qs", "--steps",
                       "5", "--eval_every", "4", "--plot_every", "6",
                       "--ckpt_every", "2", "--profile_dir",
                       str(tmp_path / "trace"), "--base_dir",
                       str(tmp_path)])
    names = _trace_events(tmp_path / "trace")
    assert names.count("train_step") == 2
    assert "gp_block" in names or any(n.startswith("aten::") for n in names)
    assert "steps 2..3" in capsys.readouterr().out
    assert tball.profile_steps(tball.build_parser().parse_args(
        ["--profile_dir", "x", "--steps", "3", "--eval_every", "2",
         "--plot_every", "2", "--ckpt_every", "2"]), 0) is None
