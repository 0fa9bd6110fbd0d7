"""The port's baseline drivers against the JAX package.

Each MNIST --elbo of the baselines runs through cli.mnist.main(...,
"--device", "cpu") on a tiny in-memory split (202 train rows in two
batches of 101; eval and test splits of one batch), from the
JAX driver's initial weights (--params) and with its draws (eps_fn),
against the same steps and eval pass made with the JAX functions the JAX
driver composes (its run_* functions read pickles from disk and return
no per-step record):

  * VAE and CVAE: one epoch (two steps), the eval / test MSE and, for the
    CVAE, the cgen MSE of predict_cvae;
  * SVIGP_Hensman: one epoch and the cgen MSE; the port's own inducing
    points equal the JAX driver's (its KDE reads the global-indexed aux
    columns);
  * GPVAE_Casale: --opt_regime VAE-1 GP-1 joint-3 with one step an
    epoch (three Adams with their own moments and step counts), softplus
    noise under a ceiling and a pinned predict noise, and the cgen pass
    after epoch 5; GPVAE_Casale_batch (the alias) with
    --casale_taylor_every 2 (the full-train sample held, without
    gradient, between refreshes);
  * SVGPVAE_Hensman + GECO with --opt_regime VAE-1 joint-1: the VAE epoch
    leaves the GP tensors out of the loss, and JAX's masked Adam still
    counts those steps for them (a zero gradient), so the GP tensors
    after the joint epoch equal JAX's only if the port does the same;
  * SPRITES --elbo VAE on a 3-character corpus (two epochs of one step
    of 150 frames): the losses, the parameters and the test recon MSE;
  * the refusals that name their flag: Casale --data_parallel,
    SVIGP / Casale --resume_dir.

Each port run saves (--save): its run dir's pics/ holds exactly the
PNG names the JAX driver writes at those steps (svgpvae_tpu/cli/
mnist.py:762 <step>.png, :805 <step>_cgen.png for the CVAE, :1082 and
:1369 <step>_cgen.png; cli/sprites.py:741 <step>_recon.png), each
decoded at 1000 x 1000 with the JAX figure's title in its text.

Tolerances (float32 on both sides, the same math in other orders): each
step's loss within RTOL_LOSS of the sum of the magnitudes it is the
difference of; the deep SVIGP's within SVIGP_RTOL_LOSS of its -bK log
noise - recon / (2 noise^2) + ... (~5e5 at noise 0.1): JAX's fp32 pixel
sum is 3.7e-5 of the recon term from float64 at step 1 here (the
port's 5e-8), and the 1 / (2 noise^2) = 50 carries it whole into the
loss; parameters after the Adam steps
within PARAM_ATOL (a tenth of one step at lr 1e-3; at the Casale GP
regime's lr 1e-2, within a tenth of its step, 1e-3); eval metrics rtol
1e-4, but the Casale cgen MSE rtol CASALE_CGEN_RTOL: its Woodbury solve
at noise 0.05 has a condition of ~1e5, and on the same (JAX's final)
parameters its fp32 value sits 0.49% (the port) and 0.24% (JAX) from
float64 (0.24415, 0.24477 against 0.24535); tests/test_torch_baselines.py
holds the same math at float64 to 1e-9.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import data as jdata, gp as jgp, models as jmodels
from svgpvae_tpu import nn as jnets, train as jtrain
from svgpvae_tpu.cli import mnist as jmnist
from svgpvae_tpu.gp.svgp import SVGPConfig as JConfig
from svgpvae_tpu_torch import data as tdata
from svgpvae_tpu_torch import train as ttrain
from svgpvae_tpu_torch.cli import mnist as tmnist, sprites as tsprites
from svgpvae_tpu_torch.utils.convert import (casale_params_from_jax,
                                             cvae_params_from_jax,
                                             mnist_params_from_jax,
                                             params_from_jax,
                                             svigp_params_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from export_jax_params import flatten_params  # noqa: E402
from run_pictures import pictures  # noqa: E402
from torch_threads import _torch_threads  # noqa: E402,F401

RTOL_LOSS = 1e-5
SVIGP_RTOL_LOSS = 1e-4
PARAM_ATOL = 1e-4
RTOL_EVAL = 1e-4
CASALE_CGEN_RTOL = 1e-2
L, SEED, BS = 6, 0, 101  # two batches of the 202 train rows
COMMON = ["--dataset", "36", "--L", str(L), "--seed", str(SEED),
          "--device", "cpu"]


def _saved(tmp_path) -> list:
    return ["--save", "--base_dir", str(tmp_path / "runs")]


def _assert_pictures(got, want_titles):
    """The run dir's pictures are exactly {name: Title} of the JAX
    driver's, each a 1000 x 1000 grid."""
    pics = pictures(got["run_dir"])
    assert {k: (h, w) for k, (h, w, _) in pics.items()} == {
        k: (1000, 1000) for k in want_titles}
    assert {k: t["Title"] for k, (_, _, t) in pics.items()} == want_titles


@pytest.fixture(scope="module")
def splits():
    """202 train rows; eval and test cut to one batch each (every JAX
    function then compiles for one batch shape)."""
    base = tdata.synthetic_digit_base_images("36", per_digit=10, seed=0)
    out = tdata.generate_rotated_mnist(base, None, digits="36", seed=0)
    for split in ("eval", "test"):
        out[split] = {k: v[:BS] for k, v in out[split].items()}
    return out


def _f32(a):
    return jnp.asarray(a, jnp.float32)


def _batches(split, bs):
    im, aux = _f32(split["images"]), _f32(split["aux_data"])
    return [(im[lo:lo + bs], aux[lo:lo + bs])
            for lo in range(0, len(im), bs)]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _sum_rtol(terms: int) -> float:
    """RTOL_LOSS, or the random-walk round-off of an fp32 sum of `terms`
    terms (sqrt(terms) * 2^-24) where that is larger: the loss of a batch
    sums its pixels, in another order in each package."""
    return max(RTOL_LOSS, float(np.sqrt(terms)) * 2.0 ** -24)


def _assert_losses(got, want, rtol=RTOL_LOSS):
    """want: (loss, scale) per step, scale the sum of the magnitudes the
    loss is computed from (its fp32 round-off's scale)."""
    assert len(got) == len(want)
    for g, (w, scale) in zip(got, want):
        assert abs(g["loss"] - float(w)) <= rtol * float(scale), \
            (g["loss"], float(w), float(scale))


def _assert_params(got: dict, want: dict, atol=PARAM_ATOL, only=None):
    """got {port name: tensor}, want {port name: array}."""
    assert set(got) == set(want), (set(got) ^ set(want))
    for k, v in want.items():
        if only is None or k.startswith(only):
            np.testing.assert_allclose(_np(got[k]), _np(v), atol=atol,
                                       err_msg=k)


def _port_names(conv: dict) -> dict:
    return {f"{part}/{k}": v for part, sub in conv.items()
            for k, v in sub.items()}


def _jax_eps(seed):
    """The JAX driver's draws: train step t uses the subkey of the t-th
    split of the state key (split(PRNGKey(seed))[0]); every eval draw
    PRNGKey(7)."""
    key = [jax.random.split(jax.random.PRNGKey(seed))[0]]

    def eps_fn(kind, shape):
        if kind == "train":
            key[0], sub = jax.random.split(key[0])
        else:
            sub = jax.random.PRNGKey(7)
        return torch.from_numpy(np.array(jax.random.normal(sub, shape)))
    return eps_fn


def _vae_scale(out):
    """The VAE loss recon_sum / (2 sigma^2) + KL's magnitudes."""
    K = 28 * 28
    return 0.5 / 0.01 ** 2 * out.recon_loss * K + jnp.abs(out.kl_term)


# XLA's CPU backend at its lowest optimisation level: the same HLO, a
# compile about half as long (the tests' time is mostly JAX compiles).
# For the inits and the eval passes only: the training steps compile as
# the JAX driver's do, whose parameters are held to a tenth of a step.
QUICK = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


def _quick(jitted):
    """`jitted` compiled with QUICK, once per argument shapes."""
    compiled = {}

    def call(*args):
        key = str(jax.tree_util.tree_map(
            lambda a: (np.shape(a), np.result_type(a).name), args))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options=QUICK)
        return compiled[key](*args)
    return call


def _run_jax(state, loss_fns, schedule, batches):
    """JAX steps: one make_train_step per loss; schedule = the loss name
    per epoch; every epoch runs every batch.  Returns (state, [(loss,
    its metrics' "scale")])."""
    steps = {k: jtrain.make_train_step(f, tx, donate=False)
             for k, (f, tx) in loss_fns.items()}
    losses = []
    for name in schedule:
        for batch in batches:
            state, m = steps[name](state, batch)
            losses.append((m["loss"], m["scale"]))
    return state, losses


# --- VAE and CVAE ------------------------------------------------------------


@pytest.mark.parametrize("elbo", ["VAE", "CVAE"])
def test_vae_and_cvae_match_jax(tmp_path, splits, elbo):
    cvae = elbo == "CVAE"
    key, init_key = jax.random.split(jax.random.PRNGKey(SEED))
    if cvae:
        net = jnets.MnistCVAE(L=L)
        p = _quick(jax.jit(net.init))(init_key, jnp.zeros((2, 28, 28, 3)),
                              jnp.zeros(2))
    else:
        net = jnets.MnistVAE(L=L)
        p = _quick(jax.jit(net.init))(init_key, jnp.zeros((2, 28, 28, 1)))
    params = {"vae": p}
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **flatten_params(params))
    got = tmnist.main(["--elbo", elbo, "--nr_epochs", "1", "--eval_every",
                       "1", "--clip_qs", "--batch_size", str(BS), "--params",
                       npz] + COMMON + _saved(tmp_path), splits=splits,
                      eps_fn=_jax_eps(SEED))

    def loss_vae(params, batch, key, geco, step):
        out = jmodels.forward_pass_vae(net, params["vae"], batch, key,
                                       clip_qs=True, cvae=cvae)
        return -out.elbo, (geco, {"scale": _vae_scale(out)})

    tx = jtrain.make_optimizer(1e-3)
    state, losses = _run_jax(jtrain.TrainState.create(params, tx, key),
                             {"VAE": (loss_vae, tx)}, ["VAE"],
                             _batches(splits["train"], BS))
    _assert_losses(got["metrics"], losses, _sum_rtol(BS * 28 * 28))
    conv = (cvae_params_from_jax if cvae else mnist_params_from_jax)(
        flatten_params(state.params))
    _assert_params(ttrain.named_tensors(got["state"].params),
                   _port_names(conv))

    ekey = jax.random.PRNGKey(7)
    recon = _quick(jax.jit(lambda p, b: jmodels.forward_pass_vae(
        net, p, b, ekey, clip_qs=True, cvae=cvae).recon_loss))
    ev = got["evals"][0]
    for name, split in (("eval_mse", "eval"), ("test_mse", "test")):
        want = sum(float(recon(state.params["vae"], b))
                   for b in _batches(splits[split], BS))
        np.testing.assert_allclose(ev[name], want / len(
            splits[split]["images"]), rtol=RTOL_EVAL)
    if cvae:
        tr, te = splits["train"], splits["test"]
        _, want = jmodels.predict_cvae(
            net, state.params["vae"], _f32(tr["images"]),
            _f32(tr["aux_data"]), _f32(te["images"]), _f32(te["aux_data"]),
            ekey, n_objects=len(splits["pca_ov_init"]))
        np.testing.assert_allclose(ev["cgen_mse"], float(want),
                                   rtol=RTOL_EVAL)
        assert got["best_cgen_mse"] == ev["cgen_mse"]
    else:
        assert ev["cgen_mse"] is None and "best_cgen_mse" not in got
    # a plain VAE has no cgen picture (svgpvae_tpu/cli/mnist.py:800-816)
    _assert_pictures(got, {"2.png": f"epoch 1. recon MSE test "
                                    f"{ev['test_mse']:.4f}", **(
        {"2_cgen.png": f"epoch 1. CGEN MSE {ev['cgen_mse']:.4f}"}
        if cvae else {})})


# --- deep SVIGP --------------------------------------------------------------


def test_svigp_matches_jax(tmp_path, splits):
    argv = ["--elbo", "SVIGP_Hensman", "--nr_epochs", "1", "--eval_every",
            "1", "--PCA", "--ip_joint", "--GP_joint", "--ov_joint",
            "--batch_size", str(BS)] + COMMON
    train_g = dict(splits["train"], aux_data=jdata.mnist.add_global_index(
        splits["train"]["aux_data"]))
    test_g = dict(splits["test"], aux_data=jdata.mnist.add_global_index(
        splits["test"]["aux_data"]))
    N = len(train_g["images"])
    dec = jnets.SVIGPDecoder(L=L)
    dec_p = _quick(jax.jit(dec.init))(jax.random.PRNGKey(SEED),
                                      jnp.zeros((2, L)))
    ip = jdata.generate_init_inducing_points(train_g, n=2, use_pca=True,
                                             M=8, seed=SEED)
    gp = jgp.init_svigp(ip, splits["pca_ov_init"], L=L, N_train=N)
    params = {"dec": dec_p, "gp": gp}
    # the port's own initialisation: the same inducing points
    port_init = tmnist.build_svigp(tmnist.build_parser().parse_args(argv),
                                   splits, N, torch.device("cpu"))
    np.testing.assert_allclose(_np(port_init["gp"].inducing_points), ip,
                               rtol=1e-6)
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **flatten_params(params))
    got = tmnist.main(argv + ["--params", npz] + _saved(tmp_path),
                      splits=splits)
    _assert_pictures(got, {"2_cgen.png": "epoch 1. CGEN MSE "
                                         f"{got['cgen_mse']:.4f}"})

    def loss_fn(params, batch, key, geco, step):
        out = jmodels.forward_pass_deep_svigp(dec, params["dec"],
                                              params["gp"], batch)
        bK, noise = batch[0].size, params["gp"].noise
        scale = (bK * jnp.abs(jnp.log(noise)) + 0.5 * bK * np.log(2 * np.pi)
                 + 0.5 * out.recon_loss * 784 / noise ** 2
                 + jnp.abs(out.inside_elbo))
        return -out.elbo, (geco, {"scale": scale})

    tx = jtrain.make_optimizer(1e-3)
    state, losses = _run_jax(
        jtrain.TrainState.create(params, tx, jax.random.PRNGKey(SEED)),
        {"svigp": (loss_fn, tx)}, ["svigp"], _batches(train_g, BS))
    _assert_losses(got["metrics"], losses, SVIGP_RTOL_LOSS)
    _assert_params(ttrain.named_tensors(got["state"].params),
                   _port_names(svigp_params_from_jax(
                       flatten_params(state.params))))
    predict = _quick(jax.jit(lambda p, b: jmodels.predict_deep_svigp(
        dec, p["dec"], p["gp"], b)[1]))
    want = sum(float(predict(state.params, b))
               for b in _batches(test_g, BS)) / len(test_g["images"])
    np.testing.assert_allclose(got["best_cgen_mse"], want, rtol=RTOL_EVAL)


# --- Casale ------------------------------------------------------------------


def _casale_eps(seed, n_train, taylor_every, eval_epoch):
    """The JAX Casale driver's draws: the regime states' keys are
    fold_in(PRNGKey(seed), 0 / 1 / 2) for joint / GP / VAE.  A joint or GP
    step splits its key into (key, sub) and sub into (k1, k2): Z from k1
    (N, L), the batch from k2; with --casale_taylor_every > 1 it splits
    it into (key, k_enc, sub): Z (on a refresh) from k_enc, the batch from
    sub.  A VAE step draws the batch from its subkey.  The cgen pass after
    epoch `eval_epoch` splits fold_in(PRNGKey(seed), epoch) into (k1, k2):
    Z from k1, the test draw from k2."""
    base = jax.random.PRNGKey(seed)
    keys = {r: jax.random.fold_in(base, i)
            for i, r in enumerate(("joint", "GP", "VAE"))}
    pending = {}

    def normal(k, shape):
        return torch.from_numpy(np.array(jax.random.normal(k, shape)))

    def eps_fn(kind, shape):
        if kind == "eval":
            if "eval" not in pending:
                k1, pending["eval"] = jax.random.split(
                    jax.random.fold_in(base, eval_epoch))
                return normal(k1, shape)
            return normal(pending.pop("eval"), shape)
        r = kind.split("/")[1]
        if r in pending:
            return normal(pending.pop(r), shape)
        if r == "VAE":
            keys[r], sub = jax.random.split(keys[r])
            return normal(sub, shape)
        if taylor_every == 1:
            keys[r], sub = jax.random.split(keys[r])
            k1, pending[r] = jax.random.split(sub)
            return normal(k1, shape)
        keys[r], k_enc, sub = jax.random.split(keys[r], 3)
        if shape[0] == n_train:  # a refresh of the held sample
            pending[r] = sub
            return normal(k_enc, shape)
        return normal(sub, shape)
    return eps_fn


CASALE_CASES = {
    "regimes": (["--elbo", "GPVAE_Casale", "--opt_regime", "VAE-1", "GP-1",
                 "joint-3", "--batch_size", "256", "--clip_qs",
                 "--casale_alpha_softplus", "--casale_alpha_max", "0.5",
                 "--casale_predict_alpha", "0.05"], 1),
    "taylor_every": (["--elbo", "GPVAE_Casale_batch", "--opt_regime",
                      "joint-2", "--batch_size", str(BS),
                      "--casale_taylor_every", "2"], 2),
}


@pytest.mark.parametrize("case", sorted(CASALE_CASES))
def test_casale_matches_jax(tmp_path, splits, case):
    flags, K = CASALE_CASES[case]
    argv = flags + ["--PCA", "--ov_joint"] + COMMON
    args = tmnist.build_parser().parse_args(argv)
    train_s = jmnist.sort_train_data(splits["train"])
    assert np.array_equal(tmnist.sort_train_data(splits["train"])[
        "aux_data"], train_s["aux_data"])
    aux_s = train_s["aux_data"]
    angles = _f32(np.sort(np.unique(aux_s[:, 2])))
    oids = jnp.asarray(np.sort(np.unique(aux_s[:, 1])).astype(int))
    rows = jnp.asarray(np.nonzero(jmnist.train_angles_mask(aux_s))[0])
    N = len(aux_s)
    key = jax.random.PRNGKey(SEED)
    vae = jnets.MnistVAE(L=L)
    gp = jgp.init_casale_gp(
        splits["pca_ov_init"], object_kernel_normalize=False, ov_joint=True,
        alpha_transform="softplus" if args.casale_alpha_softplus
        else "clamp", alpha_max=args.casale_alpha_max)
    params = {"vae": _quick(jax.jit(vae.init))(key,
                                                jnp.zeros((2, 28, 28, 1))),
              "gp": gp}
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **flatten_params(params))
    nr_epochs, regime = ttrain.parse_opt_regime(args.opt_regime)
    eval_epoch = 4 if nr_epochs >= 5 else None
    got = tmnist.main(argv + ["--params", npz] + _saved(tmp_path),
                      splits=splits,
                      eps_fn=_casale_eps(SEED, N, K, eval_epoch))
    # the cgen picture at the eval pass (every 5 epochs), none without one
    _assert_pictures(got, {} if eval_epoch is None else {
        f"{len(got['metrics'])}_cgen.png":
            f"epoch {eval_epoch + 1}. CGEN MSE {got['cgen_mse']:.4f}"})

    full = _f32(train_s["images"])

    def casale_loss(params, batch, k_enc, k_batch, Z=None):
        if Z is None:
            Z = jmodels.encode_full_casale(vae, params["vae"], full, k_enc,
                                           clip_qs=args.clip_qs)
        V = jgp.v_matrix(params["gp"], angles, oids, rows)
        a, ztKV, K_inv_V, c = jgp.taylor_terms(params["gp"], Z, V)
        out = jmodels.forward_pass_casale(
            vae, params["vae"], params["gp"], batch, k_batch, a, None, c, V,
            args.beta, clip_qs=args.clip_qs, ztKV=ztKV, K_inv_V=K_inv_V)
        scale = out.recon_loss + args.beta / L * (
            jnp.abs(out.gp_prior_term) + 0.5 * jnp.abs(out.log_var))
        return out.elbo, (None, {"scale": scale})

    def loss_joint(params, batch, key, geco, step):  # the driver's loss
        k1, k2 = jax.random.split(key)
        loss, (_, m) = casale_loss(params, batch, k1, k2)
        return loss, (geco, m)

    def loss_vae(params, batch, key, geco, step):
        images, aux = batch
        out = jmodels.forward_pass_vae(vae, params["vae"],
                                       (images, aux[:, 1:]), key)
        return -out.elbo, (geco, {"scale": _vae_scale(out)})

    masks = {r: jtrain.trainable_mask(
        params, lambda p, l, r=r: jax.tree_util.keystr(p).startswith(r))
        for r in ("['gp']", "['vae']")}
    txs = {"joint": jtrain.make_optimizer(args.lr_joint),
           "GP": jtrain.make_optimizer(args.lr_gp, mask=masks["['gp']"]),
           "VAE": jtrain.make_optimizer(1e-3, mask=masks["['vae']"])}
    states = {r: jtrain.TrainState.create(params, txs[r],
                                          jax.random.fold_in(key, i))
              for i, r in enumerate(("joint", "GP", "VAE"))}
    steps = {r: jtrain.make_train_step(loss_vae if r == "VAE" else
                                       loss_joint, tx, donate=False)
             for r, tx in txs.items()}
    import optax

    @jax.jit
    def cadence_step(state, Z, batch, refresh):
        key, k_enc, sub = jax.random.split(state.key, 3)
        Z = jnp.where(refresh, jmodels.encode_full_casale(
            vae, state.params["vae"], full, k_enc, clip_qs=args.clip_qs), Z)
        (loss, (_, m)), grads = jax.value_and_grad(
            lambda p: casale_loss(p, batch, None, sub, Z), has_aux=True)(
                state.params)
        updates, opt = txs["joint"].update(grads, state.opt_state,
                                           state.params)
        return state.replace(step=state.step + 1, opt_state=opt, key=key,
                             params=optax.apply_updates(state.params,
                                                        updates)), Z, \
            (loss, m["scale"])

    current, losses, Z, age = params, [], jnp.zeros((N, L)), 0
    for r in regime:
        st = states[r].replace(params=current)
        for batch in _batches(train_s, args.batch_size):
            if K > 1:
                st, Z, loss = cadence_step(st, Z, batch,
                                           jnp.asarray(age % K == 0))
                age += 1
            else:
                st, m = steps[r](st, batch)
                loss = (m["loss"], m["scale"])
            losses.append(loss)
        states[r], current = st, st.params
    _assert_losses(got["metrics"], losses)
    conv = _port_names(casale_params_from_jax(flatten_params(current)))
    port = ttrain.named_tensors(got["params"])
    _assert_params(port, conv, only="vae/")
    _assert_params(port, conv, atol=10 * PARAM_ATOL, only="gp/")
    assert got["regimes"] == [r for r in regime
                              for _ in _batches(train_s, args.batch_size)]
    if eval_epoch is None:
        assert got["evals"] == []
        return
    def cgen(params, key):  # the JAX driver's cgen_fn
        k1, k2 = jax.random.split(key)
        V = jgp.v_matrix(params["gp"], angles, oids, rows)
        Zc = jmodels.encode_full_casale(vae, params["vae"], full, k1,
                                        clip_qs=args.clip_qs)
        return jmodels.predict_cgen_casale(
            vae, params["vae"], params["gp"],
            _f32(splits["test"]["images"]),
            _f32(splits["test"]["aux_data"]), _f32(aux_s), V, Zc, k2,
            noise_override=args.casale_predict_alpha or None)[1]

    want = _quick(jax.jit(cgen))(current, jax.random.fold_in(key,
                                                              eval_epoch))
    assert [e["epoch"] for e in got["evals"]] == [eval_epoch]
    np.testing.assert_allclose(got["best_cgen_mse"], float(want),
                               rtol=CASALE_CGEN_RTOL)


# --- SVGPVAE with a VAE phase ------------------------------------------------


def test_opt_regime_vae_phase_moves_gp_as_jax(tmp_path, splits):
    """--opt_regime VAE-1 joint-1: the GP tensors after the joint epoch
    equal JAX's, whose masked Adam counted the VAE epoch's steps for them
    with a zero gradient."""
    argv = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs", "--PCA",
            "--ip_joint", "--GP_joint", "--ov_joint", "--opt_regime", "VAE-1",
            "joint-1", "--eval_every", "5", "--batch_size", str(BS),
            "--gp_block_impl", "reference"] + COMMON
    tr = splits["train"]
    vae = jnets.MnistVAE(L=L)
    key, init_key = jax.random.split(jax.random.PRNGKey(SEED))
    ip = jdata.generate_init_inducing_points(tr, n=2, use_pca=True, M=8,
                                             seed=SEED)
    params = {"vae": _quick(jax.jit(vae.init))(init_key,
                                       jnp.zeros((2, 28, 28, 1))),
              "gp": jgp.init_mnist_svgp(ip, splits["pca_ov_init"],
                                        config=JConfig(
                                            jitter=1e-6,
                                            N_train=len(tr["images"])))}
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **flatten_params(params))
    got = tmnist.main(argv + ["--params", npz], splits=splits,
                      eps_fn=_jax_eps(SEED))

    kappa = float(np.sqrt(0.02))

    def loss_svgpvae(params, batch, key, geco, step):
        out = jmodels.forward_pass_svgpvae(
            vae, params["vae"], params["gp"], batch, key, beta=0.001,
            C_ma=geco.C_ma, lagrange_mult=geco.lagrange_mult,
            alpha=jtrain.geco_effective_alpha(step, 0.99), kappa=kappa,
            clip_qs=True, geco=True, gp_block_impl="reference")
        scale = (jnp.abs(out.inside_elbo) + jnp.abs(out.ce_term)
                 + jnp.abs(out.elbo))
        return out.elbo, (jtrain.GECOState(C_ma=out.C_ma,
                                           lagrange_mult=out.lagrange_mult),
                          {"scale": scale})

    def loss_vae(params, batch, key, geco, step):
        out = jmodels.forward_pass_vae(vae, params["vae"], batch, key,
                                       clip_qs=True)
        return -out.elbo, (geco, {"scale": _vae_scale(out)})

    tx = jtrain.make_optimizer(1e-3)
    state, losses = _run_jax(
        jtrain.TrainState.create(params, tx, key),
        {"VAE": (loss_vae, tx), "joint": (loss_svgpvae, tx)},
        ["VAE", "joint"], _batches(tr, BS))
    _assert_losses(got["metrics"], losses, _sum_rtol(BS * 28 * 28))
    assert got["state"].step == int(state.step) == 4
    _assert_params(ttrain.named_tensors(got["state"].params),
                   _port_names(mnist_params_from_jax(
                       flatten_params(state.params))))
    # every GP tensor moved in the joint epoch, by Adam's bias correction
    # at steps 3 and 4
    opt = got["state"].optimizer
    assert {int(opt.state[t]["step"]) for t in opt.state} == {4}


# --- SPRITES --elbo VAE ------------------------------------------------------


def test_sprites_vae_matches_jax(tmp_path):
    """The JAX SPRITES CLI's --elbo VAE path: the SpritesVAE from
    PRNGKey(seed), the main key fold_in(PRNGKey(seed), 202), minus the
    VAE ELBO of each batch of frames and action ids, Adam; the eval pass's
    test_character recon MSE on PRNGKey(11)."""
    argv = ["--elbo", "VAE", "--clip_qs", "--nr_epochs", "2", "--eval_every",
            "2", "--batch_size", "150", "--L", "8", "--seed", "0"]
    corpus = tdata.generate_synthetic_sprites(n_train_chars=3,
                                              n_test_chars=2,
                                              n_frames_train=50, seed=0)
    key = jax.random.PRNGKey(0)
    vae = jnets.SpritesVAE(L=8)
    params = {"vae": _quick(jax.jit(vae.init))(key,
                                                jnp.zeros((2, 64, 64, 3)))}
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **flatten_params(params))
    main_key = [jax.random.fold_in(key, 202)]

    def eps_fn(kind, shape):
        if kind == "train":
            main_key[0], sub = jax.random.split(main_key[0])
        else:
            sub = jax.random.PRNGKey(11)
        return torch.from_numpy(np.array(jax.random.normal(sub, shape)))

    got = tsprites.main(argv + ["--device", "cpu", "--params", npz]
                        + _saved(tmp_path), splits=corpus, eps_fn=eps_fn)
    test_mse = got["evals"][0]["test_mse"]
    _assert_pictures(got, {"2_recon.png": f"epoch 2. recon MSE "
                                          f"{test_mse:.4f}"})

    def loss_fn(params, batch, key, geco, step):
        out = jmodels.forward_pass_vae(vae, params["vae"], batch, key,
                                       clip_qs=True)
        return -out.elbo, (geco, {"scale": 0.5 / 0.01 ** 2 * out.recon_loss
                                  * 64 * 64 * 3 + jnp.abs(out.kl_term)})

    tr, tc = corpus["train"], corpus["test_character"]
    tx = jtrain.make_optimizer(1e-3)
    state, losses = _run_jax(
        jtrain.TrainState.create(params, tx, jax.random.fold_in(key, 202)),
        {"VAE": (loss_fn, tx)}, ["VAE", "VAE"],
        [(_f32(tr["frames"]), _f32(tr["aux_data"][:, 1]))])
    assert got["pretrain"] is None
    _assert_losses(got["metrics"], losses, _sum_rtol(150 * 64 * 64 * 3))
    conv = _port_names(params_from_jax(flatten_params(state.params)))
    _assert_params(ttrain.named_tensors(got["state"].params), conv)
    recon = _quick(jax.jit(lambda p, b: jmodels.forward_pass_vae(
        vae, p, b, jax.random.PRNGKey(11), clip_qs=True).recon_loss))(
            state.params["vae"], (_f32(tc["frames"]),
                                  _f32(tc["aux_data"][:, 1])))
    assert [e["epoch"] for e in got["evals"]] == [1]
    np.testing.assert_allclose(got["evals"][0]["test_mse"],
                               float(recon) / len(tc["frames"]),
                               rtol=RTOL_EVAL)
    assert "cgen_mse" not in got["evals"][0] and got["cgen_mse"] is None


# --- refusals ----------------------------------------------------------------


@pytest.mark.parametrize("flags,flag", [
    (["--elbo", "GPVAE_Casale", "--data_parallel", "2"], "--data_parallel"),
    (["--elbo", "GPVAE_Casale_batch", "--resume_dir", "x"], "--resume_dir"),
    (["--elbo", "SVIGP_Hensman", "--resume_dir", "x"], "--resume_dir"),
    (["--elbo", "CVAE", "--save_latents"], "--save_latents")])
def test_refusals_name_the_flag(flags, flag, splits):
    with pytest.raises(SystemExit, match=flag):
        tmnist.main(flags + COMMON, splits=splits)
