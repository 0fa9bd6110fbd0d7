"""The JAX package's last one-program calls, captured in the port: the
MNIST unbundled eval passes, Casale's cgen, and the serve's encode chunks
and requests, on the CPU.  Each CUDA graph is replaced by an eager call
of what it would capture (tests/graph_standins.py), so each captured path
is held to the port's eager form bit for bit, and to the JAX package on
the same inputs:

  * MNIST: --opt_regime VAE-1 joint-1 --eval_every 1 on a 202-row
    36-digit train split at batch 10 (eval 32 rows: 3 batches and a tail
    of 2; test 13: 1 and a tail of 3; train 20 and a tail of 2), under
    --x64 from JAX's initial parameters with --lr 0 (Adam moves nothing,
    so both evals see JAX's parameters; the joint epoch moves the GECO
    state, which the JAX passes are given) on JAX's eval draws.  The
    captured passes ("VAE/eval", "VAE/test", "eval", "test", "cgen") equal
    the eager run's and their own eager twins (main(eager_evals=True))
    bit for bit; both against the JAX driver's recon_stack_fn (the VAE's
    and the SVGPVAE's forward), encode_stack_fn -> cgen_stack_fn and their
    tail calls, rebuilt here as svgpvae_tpu/cli/mnist.py:502-530 builds
    them (they are closures of its run function), within RTOL64 of each
    value's scale;
  * Casale: cli.mnist.casale_cgen captured (capture.CapturedCall, its
    draws through StaticDraws) against the eager call and JAX's cgen_fn
    (svgpvae_tpu/cli/mnist.py:1305) at float64 on the same parameters,
    V, Z and test draw (JAX's draws from its keys, injected into the
    port), within RTOL64; and a Casale run (--opt_regime VAE-5: one cgen)
    captured against its eager run bit for bit;
  * the serve: the MNIST encode in chunks (capture.CallPerShape as
    cli.serve's MNIST encode runs it, 64-row chunks: 3 and a tail of 10,
    two graphs) and serving.make_request_fn
    (the posterior mean) at float64 against JAX's _encode_chunked
    (svgpvae_tpu/cli/serve.py:45) and make_predict_fn's predict within
    RTOL64; cli.serve.main on a 4-character corpus, captured against its
    eager run (main(eager=True)) bit for bit, sampled draws included (the
    request graph advances the serve's seeded generator as an eager
    request does); and test_torch_serving's whole-slice test against the
    JAX serve's steps run again on the graph path at that test's fp32
    tolerance.

RTOL64 = 1e-10: the same math at float64 in the two packages, summed in
other orders; Casale's cgen CASALE_RTOL64 = 1e-9, as
tests/test_torch_baselines.py holds it: its Woodbury solve has a
condition of ~1e5 at noise 0.05 (the images came 1.5e-10 of their scale
apart).  The graphs themselves run on the card (chip_smoke.py phase 24).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import gp as jgp, models as jmodels, nn as jnets
from svgpvae_tpu import serving as jserving
from svgpvae_tpu.cli import mnist as jmnist, serve as jserve
from svgpvae_tpu.gp.svgp import SVGPConfig as JConfig
from svgpvae_tpu_torch import data as tdata, gp as tgp, models as tmodels
from svgpvae_tpu_torch import serving as tserving
from svgpvae_tpu_torch.cli import mnist as tmnist, serve as tserve
from svgpvae_tpu_torch.nn import MnistVAE
from svgpvae_tpu_torch.train import capture
from svgpvae_tpu_torch.utils.convert import (casale_params_from_jax,
                                             mnist_params_from_jax)
from test_torch_flags_mnist import JaxKeys, _jax_params
from test_torch_mnist_train import KAPPA, SLICE_ARGV
from test_torch_sprites_train import quick_jit
import test_torch_serving
from export_jax_params import flatten_params  # noqa: E402
import graph_standins
from torch_threads import _torch_threads  # noqa: E402,F401

RTOL64 = 1e-10
CASALE_RTOL64 = 1e-9
BS = 10
EVAL_KEY = jax.random.PRNGKey(7)  # the JAX driver's eval key


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close64(got, want, what="", rtol=RTOL64):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, (what, err, scale)


@pytest.fixture(scope="module")
def tiny_splits():
    """202 train rows, 32 eval, 13 test."""
    base = tdata.synthetic_digit_base_images("36", per_digit=10, seed=0)
    return tdata.generate_rotated_mnist(base, None, digits="36", seed=0)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


# --- the MNIST unbundled eval passes -----------------------------------------


def _mnist_argv(tmp_path, npz):
    i = SLICE_ARGV.index("--opt_regime")
    argv = SLICE_ARGV[:i] + SLICE_ARGV[i + 2:]
    argv[argv.index("--batch_size") + 1] = str(BS)
    return argv + ["--opt_regime", "VAE-1", "joint-1", "--x64", "--lr", "0",
                   "--params", npz, "--device", "cpu", "--save",
                   "--base_dir", str(tmp_path)]


def _jax_passes(vae, params, splits, geco):
    """The JAX driver's eval programs at float64 (recon_stack_fn for the
    VAE and the SVGPVAE pass, encode_stack_fn -> cgen_stack_fn), each
    with its tail call: {pass: (per-batch losses, images)}."""
    f64 = functools.partial(jnp.asarray, dtype=jnp.float64)

    def recon_out(params, batch, vae_pass):
        if vae_pass:
            return jmodels.forward_pass_vae(vae, params["vae"], batch,
                                            EVAL_KEY, clip_qs=True)
        return jmodels.forward_pass_svgpvae(
            vae, params["vae"], params["gp"], batch, EVAL_KEY, beta=0.001,
            C_ma=geco[0], lagrange_mult=geco[1], alpha=0.99, kappa=KAPPA,
            clip_qs=True, geco=True, gp_block_impl="fused_pallas")

    def recon_stack(vae_pass):
        def stack_fn(params, stack):
            def body(b):
                out = recon_out(params, b, vae_pass)
                return out.recon_loss, out.recon_images
            losses, recons = jax.lax.map(body, stack)
            return losses, recons.reshape(-1, *recons.shape[2:])
        return quick_jit(stack_fn)

    def chunks(images, aux):
        full = len(images) // BS * BS
        stack = (images[:full].reshape(-1, BS, *images.shape[1:]),
                 aux[:full].reshape(-1, BS, aux.shape[-1]))
        return stack, (images[full:], aux[full:])

    def encode(params, images):
        return jmodels.batching_encode_svgpvae(vae, params["vae"], images,
                                               clip_qs=True)

    @quick_jit
    def encode_stack_fn(params, images_stack):
        mus, vs = jax.lax.map(lambda im: encode(params, im), images_stack)
        return (mus.reshape(-1, mus.shape[-1]), vs.reshape(-1, vs.shape[-1]))

    def cgen(params, b, means, variances, aux_train):
        return jmodels.predict_cgen_mnist(vae, params["vae"], params["gp"],
                                          b, means, variances, aux_train,
                                          EVAL_KEY)

    @quick_jit
    def cgen_stack_fn(params, stack, means, variances, aux_train):
        def body(b):
            recon, loss = cgen(params, b, means, variances, aux_train)
            return loss, recon
        losses, recons = jax.lax.map(body, stack)
        return losses, recons.reshape(-1, *recons.shape[2:])

    data = {k: (f64(splits[k]["images"]), f64(splits[k]["aux_data"]))
            for k in ("train", "eval", "test")}
    out = {}
    for vae_pass in (True, False):
        fn = recon_stack(vae_pass)
        tail_fn = quick_jit(lambda p, b, v=vae_pass: (
            lambda o: (o.recon_loss, o.recon_images))(recon_out(p, b, v)))
        for split in ("eval", "test"):
            stack, tail = chunks(*data[split])
            losses, images = fn(params, stack)
            t_loss, t_images = tail_fn(params, tail)
            out[("VAE/" if vae_pass else "") + split] = (
                np.append(np.asarray(losses), float(t_loss)),
                np.concatenate([images, t_images]))
    (im, aux), n = data["train"], len(data["train"][0]) // BS * BS
    mu, var = encode_stack_fn(params, im[:n].reshape(-1, BS, *im.shape[1:]))
    mt, vt = quick_jit(encode)(params, im[n:])
    mu, var = jnp.concatenate([mu, mt]), jnp.concatenate([var, vt])
    stack, tail = chunks(*data["test"])
    losses, images = cgen_stack_fn(params, stack, mu, var, aux)
    t_images, t_loss = quick_jit(cgen)(params, tail, mu, var, aux)
    out["cgen"] = (np.append(np.asarray(losses), float(t_loss)),
                   np.concatenate([images, t_images]))
    return out


@pytest.fixture(scope="module")
def mnist_runs(tiny_splits, tmp_path_factory):
    """The port's run eager and through the stand-ins (with its eager
    twins), and the JAX passes on the same parameters, GECO state and
    draws."""
    jax.config.update("jax_enable_x64", True)
    try:
        vae, params, _ = _jax_params(tiny_splits, jnp.float64)
        tmp = tmp_path_factory.mktemp("captured_eval")
        npz = str(tmp / "params.npz")
        np.savez(npz, **flatten_params(params))
        runs = {"eager": tmnist.main(
            _mnist_argv(tmp / "eager", npz), splits=tiny_splits,
            eps_fn=JaxKeys(0, jnp.float64).eps_fn)}
        with pytest.MonkeyPatch.context() as mp:
            graph_standins.patch(mp.setattr)
            # the stand-ins call the eps_fn at every replay, which the
            # training loop (per step under --x64) draws from in order
            mp.setattr(tmnist.Noise, "generator", torch.Generator())
            runs["captured"] = tmnist.main(
                _mnist_argv(tmp / "captured", npz), splits=tiny_splits,
                eps_fn=JaxKeys(0, jnp.float64).eps_fn, eager_evals=True)
        geco = runs["captured"]["state"].geco
        want = _jax_passes(vae, params, tiny_splits,
                           (jnp.asarray(_np(geco.C_ma)),
                            jnp.asarray(_np(geco.lagrange_mult))))
        return runs, want
    finally:
        jax.config.update("jax_enable_x64", False)


def test_mnist_eval_passes_equal_eager(mnist_runs):
    runs, _ = mnist_runs
    got, want = runs["captured"], runs["eager"]
    assert want["eval_graph_replays"] == {}
    assert got["eval_graph_replays"] == dict.fromkeys(
        ("VAE/eval", "VAE/test", "eval", "test", "cgen"), 1) | {"cgen": 2}
    assert got["eval_losses"] == want["eval_losses"]
    for k in ("eval_mse", "test_mse", "cgen_mse"):
        assert [e[k] for e in got["evals"]] == [e[k] for e in want["evals"]]
    for k in ("test_recon", "cgen_images"):
        assert torch.equal(got[k], want[k]), k
    # each captured pass against its eager twin, at the same state
    for ev, losses in zip(got["evals"], got["eval_losses"]):
        twin = ev["eager"]
        vae_pass = "VAE/eval" in twin
        assert set(twin) == {"VAE/eval", "VAE/test", "cgen"} if vae_pass \
            else {"eval", "test", "cgen"}
        for split in ("eval", "test", "cgen"):
            name = ("VAE/" if vae_pass and split != "cgen" else "") + split
            assert twin[name]["losses"] == losses[split], name
    assert torch.equal(got["evals"][-1]["eager"]["cgen"]["images"],
                       got["cgen_images"])
    assert "eager" not in want["evals"][-1]


def test_mnist_eval_passes_match_jax(mnist_runs):
    runs, want = mnist_runs
    got = runs["captured"]
    for ev_losses, vae_pass in zip(got["eval_losses"], (True, False)):
        for split in ("eval", "test", "cgen"):
            name = ("VAE/" if vae_pass and split != "cgen" else "") + split
            _close64(ev_losses[split], want[name][0], name)
    n = {"eval": 32, "test": 13}
    for ev, vae_pass in zip(got["evals"], (True, False)):
        for split in ("eval", "test"):
            name = ("VAE/" if vae_pass else "") + split
            _close64(ev[f"{split}_mse"] * n[split], want[name][0].sum(),
                     name)
        _close64(ev["cgen_mse"] * n["test"], want["cgen"][0].sum(), "cgen")
    _close64(got["test_recon"], want["test"][1], "test recon")
    _close64(got["cgen_images"], want["cgen"][1], "cgen images")


# --- Casale's cgen -----------------------------------------------------------


def test_casale_cgen_captured_matches_eager_and_jax(x64, tiny_splits):
    """cli.mnist.casale_cgen captured, eager and JAX's cgen_fn at float64:
    the port draws JAX's normals of k1 (the full-train encode) and k2 (the
    test draw)."""
    train_s = jmnist.sort_train_data(tiny_splits["train"])
    aux_s = train_s["aux_data"]
    args = tmnist.build_parser().parse_args(
        ["--elbo", "GPVAE_Casale", "--L", "6", "--clip_qs"])
    key = jax.random.PRNGKey(0)
    vae = jnets.MnistVAE(L=6, dtype=jnp.float64)
    vae_p = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64),
        quick_jit(vae.init)(key, jnp.zeros((2, 28, 28, 1))))
    gp = jgp.init_casale_gp(tiny_splits["pca_ov_init"], False, True,
                            dtype=jnp.float64)
    params = {"vae": vae_p, "gp": gp}
    conv = casale_params_from_jax(flatten_params(params))
    t_vae = MnistVAE(L=6).double()
    t_vae.load_state_dict(conv["vae"])
    t_params = {"vae": t_vae.eval(), "gp": tgp.CasaleGP(
        **conv["gp"], ov_joint=True)}
    assert t_params["gp"].object_vectors.dtype == torch.float64

    f64 = functools.partial(torch.as_tensor, dtype=torch.float64)
    consts = {"images": f64(train_s["images"]),
              "angles": f64(np.unique(aux_s[:, 2])),
              "object_ids": torch.as_tensor(
                  np.unique(aux_s[:, 1]).astype(np.int64)),
              "grid_rows": torch.as_tensor(
                  np.nonzero(jmnist.train_angles_mask(aux_s))[0])}
    test = (f64(tiny_splits["test"]["images"]),
            f64(tiny_splits["test"]["aux_data"]))
    k1, k2 = jax.random.split(jax.random.fold_in(key, 4))
    draws = {len(aux_s): k1, len(test[0]): k2}

    def eps(kind, shape):
        assert kind == "eval"
        return torch.from_numpy(np.array(jax.random.normal(
            draws[shape[0]], shape, dtype=jnp.float64)))

    with pytest.MonkeyPatch.context() as mp:
        graph_standins.patch(mp.setattr)
        call = capture.CapturedCall(lambda: tmnist.casale_cgen(
            args, t_params, consts, test, f64(aux_s), tmnist.StaticDraws(eps),
            f64(0.05)))
        got = [t.clone() for t in call()]
        again = call()
        assert call.graph.replays == 2
    eager = tmnist.casale_cgen(args, t_params, consts, test, f64(aux_s), eps,
                               0.05)
    for g, a, e in zip(got, again, eager):
        assert torch.equal(g, e) and torch.equal(a, e)

    angles = jnp.asarray(np.sort(np.unique(aux_s[:, 2])))
    oids = jnp.asarray(np.sort(np.unique(aux_s[:, 1])).astype(int))
    rows = jnp.asarray(np.nonzero(jmnist.train_angles_mask(aux_s))[0])

    def cgen_fn(params, key):  # the JAX driver's cgen_fn
        k1, k2 = jax.random.split(key)
        V = jgp.v_matrix(params["gp"], angles, oids, rows)
        Z = jmodels.encode_full_casale(vae, params["vae"],
                                       jnp.asarray(train_s["images"]), k1,
                                       clip_qs=True)
        return jmodels.predict_cgen_casale(
            vae, params["vae"], params["gp"],
            jnp.asarray(tiny_splits["test"]["images"]),
            jnp.asarray(tiny_splits["test"]["aux_data"]), jnp.asarray(aux_s),
            V, Z, k2, noise_override=0.05)

    want = quick_jit(cgen_fn)(params, jax.random.fold_in(key, 4))
    for g, w, what in zip(got, want, ("images", "loss")):
        _close64(g, w, what, CASALE_RTOL64)


def test_casale_run_captured_equals_eager(tiny_splits, monkeypatch):
    argv = ["--elbo", "GPVAE_Casale", "--opt_regime", "VAE-5", "--PCA",
            "--ov_joint", "--clip_qs", "--dataset", "36", "--L", "4",
            "--batch_size", "50", "--seed", "0", "--device", "cpu",
            "--casale_predict_alpha", "0.05"]
    want = tmnist.main(argv, splits=tiny_splits)
    graph_standins.patch(monkeypatch.setattr)
    got = tmnist.main(argv, splits=tiny_splits, eager_evals=True)
    assert want["eval_graph_replays"] == {}
    assert got["eval_graph_replays"] == {"cgen": 1}
    assert got["metrics"] == want["metrics"]
    (ev,), (ev_want,) = got["evals"], want["evals"]
    assert ev["cgen_mse"] == ev_want["cgen_mse"] == \
        ev["eager"]["cgen"]["loss"]


# --- the serve ---------------------------------------------------------------


def test_serve_encode_and_request_match_jax(x64, tiny_splits, monkeypatch):
    """The MNIST encode in 64-row chunks and the request (posterior mean),
    captured, against the eager forms and JAX's at float64."""
    L, m, chunk = 6, 8, 64
    rng = np.random.RandomState(3)
    vae = jnets.MnistVAE(L=L, dtype=jnp.float64)
    vae_p = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64),
        quick_jit(vae.init)(jax.random.PRNGKey(0), jnp.zeros((2, 28, 28, 1))))
    tr = tiny_splits["train"]
    ip = np.hstack([np.arange(m)[:, None] % 4, rng.rand(m, 1) * 2 * np.pi,
                    rng.randn(m, 8)])
    j_gp = jgp.init_mnist_svgp(ip, tiny_splits["pca_ov_init"],
                               config=JConfig(jitter=1e-6, N_train=len(
                                   tr["images"])), dtype=jnp.float64)
    conv = mnist_params_from_jax(flatten_params({"vae": vae_p, "gp": j_gp}))
    t_vae = MnistVAE(L=L).double()
    t_vae.load_state_dict(conv["vae"])
    t_vae.eval()
    t_gp = tgp.MnistSVGP(config=tgp.SVGPConfig(
        jitter=1e-6, N_train=len(tr["images"])), **conv["gp"])
    images = torch.as_tensor(tr["images"], dtype=torch.float64)
    aux = torch.as_tensor(tr["aux_data"], dtype=torch.float64)
    aux_q = np.asarray(tiny_splits["test"]["aux_data"], np.float64)

    def encode(captured):
        call = capture.CallPerShape(
            torch.no_grad()(lambda im: tmodels.batching_encode_svgpvae(
                t_vae, im, clip_qs=True)), torch.device("cpu"),
            captured=captured)
        enc = [call(images[lo:lo + chunk])
               for lo in range(0, len(images), chunk)]
        return [torch.cat(x) for x in zip(*enc)], call

    eager_enc, _ = encode(False)
    graph_standins.patch(monkeypatch.setattr)
    (mu, var), per_shape = encode(True)
    # 202 rows: three 64-row chunks replay one graph, the tail another
    assert {k: g.replays for k, g in per_shape.graphs.items()} == {
        (((64, 28, 28, 1), torch.float64),): 3,
        (((10, 28, 28, 1), torch.float64),): 1}
    assert torch.equal(mu, eager_enc[0]) and torch.equal(var, eager_enc[1])
    j_mu, j_var = jserve._encode_chunked(vae, vae_p, jnp.asarray(tr["images"]),
                                         True, chunk=chunk)
    _close64(mu, j_mu, "means")
    _close64(var, j_var, "variances")

    predictor = tserving.fit(t_gp, mu, var, aux)
    request = tserving.make_request_fn(predictor, t_vae, torch.device("cpu"),
                                       sample=False, captured=True)
    got = request(aux_q)
    again = request(aux_q)
    (graph,) = request.graphs.values()
    assert graph.replays == 2
    eager = tserving.make_request_fn(predictor, t_vae, torch.device("cpu"),
                                     sample=False)(aux_q)
    for g, a, e in zip(got, again, eager):
        assert torch.equal(g, e) and torch.equal(a, e)
    want = jserving.make_predict_fn(
        jserving.fit(j_gp, j_mu, j_var, jnp.asarray(tr["aux_data"])), vae,
        vae_p, sample=False)(jnp.asarray(aux_q), jax.random.PRNGKey(0))
    _close64(got[0], aux_q, "aux query")
    for g, w, what in zip(got[1:], want, ("images", "p_m", "p_v")):
        _close64(g, w, what)


def test_serve_main_captured_equals_eager(monkeypatch):
    """cli.serve.main on a 4-character corpus: the encode (one 200-frame
    chunk) and 3 requests (one shape, sampled draws) replay their graphs,
    and equal the eager serve's outputs bit for bit."""
    splits = tdata.generate_synthetic_sprites(
        n_train_chars=4, n_test_chars=3, n_frames_train=50, seed=0)
    argv = ["--synthetic", "--synthetic_chars", "4", "--n_requests", "3",
            "--L", "8", "--L_character", "9", "--device", "cpu"]
    want = tserve.main(argv, splits=splits, eager=True)
    graph_standins.patch(monkeypatch.setattr)
    uncaptured = tserve.main(argv, splits=splits, eager=True)
    got = tserve.main(argv, splits=splits)
    assert want["graph_replays"] == uncaptured["graph_replays"] == {}
    assert got["graph_replays"] == {
        "encode:[[200, 64, 64, 3], [200]]": 1,
        "request:[[36, 64, 64, 3], [36]]": 3}
    for k in ("means", "variances", "aux"):
        assert torch.equal(got["state"][k], want["state"][k]), k
    for g, w in zip(got["state"]["served"], want["state"]["served"]):
        for k in ("aux_query", "images", "p_m", "p_v"):
            assert torch.equal(g[k], w[k]), k
    # fresh draws per request, as the eager serve's
    served = got["state"]["served"]
    assert not torch.equal(served[0]["images"], served[1]["images"])
    assert got["cgen_mse"] == want["cgen_mse"]


def test_serve_graph_path_matches_jax(tmp_path, monkeypatch):
    """test_torch_serving's cli.serve.main against the JAX serve's steps
    (_encode_chunked, sprites_query_aux, predict), on the graph path."""
    graph_standins.patch(monkeypatch.setattr)
    runs, main = [], tserve.main

    def recorded(*a, **k):
        runs.append(main(*a, **k))
        return runs[-1]

    monkeypatch.setattr(tserve, "main", recorded)
    test_torch_serving.test_serve_main_matches_jax_steps(tmp_path)
    (res,) = runs
    assert res["graph_replays"] == {
        "encode:[[200, 64, 64, 3], [200]]": 1,
        "request:[[36, 64, 64, 3], [36]]": 2}
