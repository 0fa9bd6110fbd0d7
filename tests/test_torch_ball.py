"""The port's moving-ball modules against the JAX package.

  * the fixed test batches, bit for bit, and the torch video generator
    (binary frames, the rasterizer's formula, the path covariance within
    sampling error of the time kernel);
  * BallEncoder / BallDecoder (both encoder heads) with the weights
    carried over by utils.convert.ball_params_from_jax, fp32;
  * mse_rotation and post_process_full_cholesky;
  * gp_regression_1d (marginal and full variance, with jitter);
  * the two-pass ball posterior and inside-ELBO (Hensman, with and
    without ball_kl_quirk, and Titsias) and the fused blocks
    ball_gp_block / ball_gp_block_titsias for inverse_impl "chol" and
    "pallas" (B1's Cholesky twin on the CPU; JAX's Pallas kernel in
    interpret mode, as tests/test_fused_gp.py runs it): every output and
    the gradients of a weighted sum of them with respect to the GP
    tensors, y and the noise, at float64;
  * ball_svgpvae_elbo for each impl and bound, and pearce_elbo for
    GPVAE_Pearce, VAE and NP (the NP through the JAX draws of its context
    size and permutations), on injected noise at float64: every output
    and the gradient of the mean ELBO with respect to every parameter.

Tolerances: float64 within RTOL64 = 1e-9 of each output's max |entry|
(the same formulas summed in other orders, or Gauss-Jordan against
Cholesky on matrices of condition < 1e4); fp32 nets within 1e-5 of
max |entry| (three fp32 layers).
"""

import contextlib
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import data as jdata, models as jmodels, nn as jnets
from svgpvae_tpu.gp import exact as jexact, fused as jfused, svgp as jsvgp
from svgpvae_tpu.utils import metrics as jmetrics
from svgpvae_tpu_torch import data as tdata, gp as tgp, models as tmodels
from svgpvae_tpu_torch.data import ball as tball
from svgpvae_tpu_torch.nn import BallDecoder, BallEncoder
from svgpvae_tpu_torch.utils import metrics as tmetrics
from svgpvae_tpu_torch.utils.convert import (ball_params_from_jax,
                                             params_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from export_jax_params import flatten_params  # noqa: E402

RTOL64 = 1e-9
RTOL32 = 1e-5


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, rtol, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(_np(got).astype(np.float64), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


def _t(a):
    return torch.tensor(np.array(a, np.float64))


# --- data ---------------------------------------------------------------------


def test_test_batches_equal_jax():
    want = jdata.make_test_batches(3, tmax=7, px=16, py=16, lt=2.0, batch=4,
                                   r=2.0)
    got = tdata.make_test_batches(3, tmax=7, px=16, py=16, lt=2.0, batch=4,
                                  r=2.0)
    for (gt, gv), (wt, wv) in zip(got, want):
        assert gt.dtype == wt.dtype and gv.dtype == wv.dtype
        assert np.array_equal(gt, wt) and np.array_equal(gv, wv)
    # the driver's widths: 35 videos of 30 32x32 frames
    (gt, gv), = tdata.make_test_batches(1)
    (wt, wv), = jdata.make_test_batches(1)
    assert gv.shape == (35, 30, 32, 32)
    assert np.array_equal(gt, wt) and np.array_equal(gv, wv)


def test_video_generator_frames_and_path_covariance():
    tmax, lt, px = 10, 2.0, 32
    fn = tdata.make_video_batch_fn(tmax=tmax, lt=lt, batch=35, seed=5)
    state = fn.generator.get_state()
    paths = torch.cat([fn.paths() for _ in range(200)])    # (7000, T, 2)
    fn.generator.set_state(state)
    vids = fn()
    assert vids.shape == (35, tmax, 32, 32) and vids.dtype == torch.float32
    assert set(torch.unique(vids).tolist()) <= {0.0, 1.0}
    # the rasterizer is the numpy one's formula, frame for frame
    p0 = paths[:35].numpy().astype(np.float64)
    want = np.stack([tball._rasterize(p, px, px, 3.0) for p in p0])
    assert (vids.numpy() != want).mean() < 1e-4
    assert vids.sum(dim=(2, 3)).float().mean() > 20  # a ball is in view
    # unscaled paths ~ N(0, K_time + ridge) per channel and video
    z = ((paths - 0.5 * px) / (0.2 * px)).double()
    z = z.permute(0, 2, 1).reshape(-1, tmax)               # (14000, T)
    emp = (z.T @ z / z.shape[0]).numpy()
    t = np.arange(tmax)
    K = np.exp(-0.5 * (t[:, None] - t[None, :]) ** 2 / lt ** 2)
    # sampling error of a covariance entry: sqrt((1 + K_ij^2) / n)
    se = np.sqrt((1 + K ** 2) / z.shape[0])
    assert np.abs(emp - K).max() < 5 * se.max(), np.abs(emp - K).max()
    assert np.abs(z.mean(0).numpy()).max() < 5 / np.sqrt(z.shape[0])


# --- nets ---------------------------------------------------------------------


def _jax_nets(full_cholesky, tmax, hidden, px=8, seed=0):
    enc = jnets.BallEncoder(hidden=hidden, full_cholesky=full_cholesky)
    dec = jnets.BallDecoder(px=px, py=px, hidden=hidden)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = {"enc": enc.init(k1, jnp.zeros((2, tmax, px, px))),
              "dec": dec.init(k2, jnp.zeros((2, tmax, 2)))}
    return enc, dec, params


def _port_nets(params, full_cholesky, tmax, hidden, px=8,
               dtype=torch.float32):
    port = ball_params_from_jax(flatten_params(params))
    enc = BallEncoder(tmax=tmax, px=px, py=px, hidden=hidden,
                      full_cholesky=full_cholesky)
    dec = BallDecoder(px=px, py=px, hidden=hidden)
    enc.load_state_dict(port["enc"])
    dec.load_state_dict(port["dec"])
    return enc.to(dtype), dec.to(dtype)


@pytest.mark.parametrize("full_cholesky", [False, True])
@pytest.mark.parametrize("hidden", [(32,), (16, 12)])
def test_ball_nets_match_flax(full_cholesky, hidden):
    tmax, px = 6, 8
    rng = np.random.RandomState(3)
    j_enc, j_dec, params = _jax_nets(full_cholesky, tmax, hidden, px)
    t_enc, t_dec = _port_nets(params, full_cholesky, tmax, hidden, px)
    # random frames, no symmetry: a transposed flatten would show
    vids = (rng.rand(3, tmax, px, px) > 0.7).astype(np.float32)
    mu, var = t_enc(torch.from_numpy(vids))
    j_mu, j_var = j_enc.apply(params["enc"], jnp.asarray(vids))
    assert var.shape == ((3, tmax, 2 * tmax) if full_cholesky
                         else (3, tmax, 2))
    _close(mu, j_mu, RTOL32)
    _close(var, j_var, RTOL32)
    lat = rng.randn(3, tmax, 2).astype(np.float32)
    _close(t_dec(torch.from_numpy(lat)),
           j_dec.apply(params["dec"], jnp.asarray(lat)), RTOL32)


def test_params_from_jax_dispatches_ball():
    _, _, params = _jax_nets(False, 4, (8,))
    gp = jsvgp.init_ball_svgp(5, 1.0, 4.0, 2.0)
    flat = flatten_params(dict(params, gp=gp))
    port = params_from_jax(flat)
    assert set(port) == {"enc", "dec", "gp"}
    assert set(port["gp"]) == {"inducing_points", "length_scale"}
    assert port["enc"]["hidden.0.weight"].shape == (8, 64)
    flat = flatten_params(dict(params, gp={
        "length_scale_x": jnp.asarray(2.0),
        "length_scale_y": jnp.asarray(3.0)}))
    assert float(ball_params_from_jax(flat)["gp"]["length_scale_y"]) == 3.0
    with pytest.raises(KeyError):
        ball_params_from_jax(dict(flatten_params(params), **{"gp/x": 1.0}))


# --- metrics ------------------------------------------------------------------


@pytest.mark.parametrize("full_cholesky", [False, True])
def test_mse_rotation_matches_jax(full_cholesky):
    rng = np.random.RandomState(4)
    b, t = 5, 7
    X = rng.randn(b, t, 2).astype(np.float32)
    Y = rng.randn(b, t, 2)
    VX = (rng.rand(b, t, 2 * t) if full_cholesky
          else rng.rand(b, t, 2)).astype(np.float32)
    got = tmetrics.mse_rotation(X, Y, VX, full_cholesky=full_cholesky)
    want = jmetrics.mse_rotation(X, Y, VX, full_cholesky=full_cholesky)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if full_cholesky:
        np.testing.assert_array_equal(
            tmetrics.post_process_full_cholesky(VX, t),
            jmetrics.post_process_full_cholesky(VX, t))
        # the in-graph form of the ELBOs gives the same variances
        _close(tmodels.full_cholesky_marginal_vars(torch.from_numpy(VX)),
               tmetrics.post_process_full_cholesky(VX, t), RTOL32)


# --- exact GP -----------------------------------------------------------------


@pytest.mark.parametrize("full_variance", [False, True])
@pytest.mark.parametrize("jitter", [0.0, 1e-4])
def test_gp_regression_1d_matches_jax(full_variance, jitter):
    rng = np.random.RandomState(5)
    b, n = 4, 9
    x = np.sort(rng.rand(b, n) * 10, axis=1)
    y, var = rng.randn(b, n), np.exp(rng.randn(b, n))
    with _x64():
        want = jexact.gp_regression_1d(x, y, var, x, 1.7,
                                       full_variance=full_variance,
                                       jitter=jitter)
        x_t = _t(x)
        ls = _t(1.7).requires_grad_()
        got = tgp.gp_regression_1d(x_t, _t(y), _t(var), x_t, ls,
                                   full_variance=full_variance,
                                   jitter=jitter)
        for g, w, what in zip(got, want, got._fields):
            _close(g, w, RTOL64, what)
        # the length-scale gradient (trained under --GP_joint)
        j_g = jax.grad(lambda l: jnp.sum(jexact.gp_regression_1d(
            x, y, var, x, l, full_variance, jitter).log_marginal))(1.7)
        g, = torch.autograd.grad(got.log_marginal.sum(), ls)
        _close(g, j_g, RTOL64)


# --- the ball GP: two-pass and fused, float64 ----------------------------------


def _ball_gp(rng, V=4, T=8, m=5, quirk=False, titsias=False, jitter=1e-8):
    ip = np.linspace(1.0, T, m)[None] + 0.3 * rng.randn(2, m)
    ls = np.array([1.7, 2.4])
    y, noise = rng.randn(V, T, 2), rng.rand(V, T, 2) + 0.05
    cfg = dict(titsias=titsias, jitter=jitter, ball_kl_quirk=quirk)
    j_gp = jsvgp.init_ball_svgp(m, 1.0, float(T), 2.0,
                                dtype=jnp.float64).replace(
        config=jsvgp.SVGPConfig(**cfg), inducing_points=jnp.asarray(ip),
        length_scale=jnp.asarray(ls))
    t_gp = tgp.BallSVGP(config=tgp.SVGPConfig(**cfg),
                        inducing_points=_t(ip), length_scale=_t(ls))
    return j_gp, t_gp, np.arange(1.0, T + 1), y, noise


def _grad_check(j_fn, t_fn, j_gp, t_gp, y, noise, rng, rtol=RTOL64):
    """Every output, then sum(outputs * w) and its gradients with respect
    to the inducing points, the length scales, y and the noise."""
    j_outs = jax.jit(j_fn)(j_gp, jnp.asarray(y), jnp.asarray(noise))
    w = [rng.randn(*np.shape(o)) for o in j_outs]

    def j_loss(gp, y_, noise_):
        return sum(jnp.sum(o * wi) for o, wi in zip(j_fn(gp, y_, noise_), w))

    want, j_grads = jax.jit(jax.value_and_grad(j_loss, argnums=(0, 1, 2)))(
        j_gp, jnp.asarray(y), jnp.asarray(noise))
    leaves = [t_gp.inducing_points, t_gp.length_scale]
    for t in leaves:
        t.requires_grad_(True)
    y_t, noise_t = _t(y).requires_grad_(), _t(noise).requires_grad_()
    outs = t_fn(t_gp, y_t, noise_t)
    for i, (o, jo) in enumerate(zip(outs, j_outs)):
        assert tuple(o.shape) == np.shape(jo), i
        _close(o, jo, rtol, f"output {i}")
    loss = sum(torch.sum(o * _t(wi)) for o, wi in zip(outs, w))
    _close(loss, want, rtol)
    grads = torch.autograd.grad(loss, leaves + [y_t, noise_t])
    for g, wg, what in zip(grads, (j_grads[0].inducing_points,
                                   j_grads[0].length_scale, j_grads[1],
                                   j_grads[2]),
                           ("inducing_points", "length_scale", "y",
                            "noise")):
        _close(g, wg, rtol, what)


def _two_pass(gp_mod, gp, times, y, noise):
    p_m, p_cov, mu, A = gp_mod.ball_posterior_params(gp, times, y, noise)
    return (p_m, p_cov, mu, A) + tuple(
        gp_mod.ball_variational_loss(gp, times, y, noise, mu, A))


@pytest.mark.parametrize("case", ["hensman", "hensman-quirk", "titsias"])
def test_two_pass_ball_gp_matches_jax(case):
    rng = np.random.RandomState(6)
    with _x64():
        j_gp, t_gp, times, y, noise = _ball_gp(
            rng, quirk=case.endswith("quirk"), titsias=case == "titsias")
        t_times = _t(times)
        _grad_check(lambda gp, y_, n_: _two_pass(jsvgp, gp, times, y_, n_),
                    lambda gp, y_, n_: _two_pass(tgp, gp, t_times, y_, n_),
                    j_gp, t_gp, y, noise, rng)


@pytest.mark.parametrize("impl", ["chol", "pallas"])
@pytest.mark.parametrize("case", ["hensman", "hensman-quirk", "titsias"])
def test_fused_ball_blocks_match_jax(case, impl, monkeypatch):
    """The fused blocks against JAX's; under "pallas" JAX runs its Pallas
    kernel (interpret mode) and the port B1's Cholesky twin, on the flat
    stack of one chol_inverse call (counted)."""
    if impl == "pallas":
        monkeypatch.setenv("SVGPVAE_CHOL_INVERSE", "pallas")
    titsias = case == "titsias"
    rng = np.random.RandomState(7)
    V, m = 4, 5
    calls = []
    from svgpvae_tpu_torch.gp import fused as tfused
    kernel = tfused.chol_inverse

    def recording(M):
        calls.append(tuple(M.shape))
        return kernel(M)

    monkeypatch.setattr(tfused, "chol_inverse", recording)
    with _x64():
        j_gp, t_gp, times, y, noise = _ball_gp(
            rng, V=V, m=m, quirk=case.endswith("quirk"), titsias=titsias)
        t_times = _t(times)
        j_block = jfused.ball_gp_block_titsias if titsias \
            else jfused.ball_gp_block
        t_block = tgp.ball_gp_block_titsias if titsias \
            else tgp.ball_gp_block
        _grad_check(
            lambda gp, y_, n_: j_block(gp, times, y_, n_, inverse_impl=impl),
            lambda gp, y_, n_: t_block(gp, t_times, y_, n_,
                                       inverse_impl=impl),
            j_gp, t_gp, y, noise, rng)
    stack = 2 * ((2 * V + 1) if titsias else (V + 1))
    assert calls == ([(stack, m, m)] if impl == "pallas" else [])


def test_fused_block_matches_two_pass():
    """The port's fused Hensman block against its own two-pass path
    (same math, KL without the rejitter of A_hat): p_m, p_v, the
    inside-ELBO and the covariance diagnostic."""
    rng = np.random.RandomState(8)
    with _x64():
        _, gp, times, y, noise = _ball_gp(rng, jitter=0.0)
    t = _t(times)
    p_m, p_cov, mu, A, sum_t, kl = _two_pass(tgp, gp, t, _t(y), _t(noise))
    f = tgp.ball_gp_block(gp, t, _t(y), _t(noise))
    _close(f[0], p_m, 1e-9)
    _close(f[1], torch.diagonal(p_cov, dim1=1, dim2=2).transpose(1, 2), 1e-9)
    _close(f[2], sum_t, 1e-9)
    _close(f[3], kl, 1e-6)
    _close(f[4], p_cov.mean(0), 1e-9)


# --- the ELBOs, float64 --------------------------------------------------------


def _elbo_setup(rng, full_cholesky=False, V=3, T=6, px=8, hidden=(16,)):
    enc = jnets.BallEncoder(hidden=hidden, full_cholesky=full_cholesky,
                            dtype=jnp.float64)
    dec = jnets.BallDecoder(px=px, py=px, hidden=hidden, dtype=jnp.float64)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64),
        {"enc": enc.init(k1, jnp.zeros((2, T, px, px))),
         "dec": dec.init(k2, jnp.zeros((2, T, 2)))})
    t_enc, t_dec = _port_nets(params, full_cholesky, T, hidden, px,
                              torch.float64)
    vids = (rng.rand(V, T, px, px) > 0.8).astype(np.float64)
    return enc, dec, params, t_enc, t_dec, vids


def _check_outputs(got, want, fields):
    for f in fields:
        w = getattr(want, f)
        g = getattr(got, f)
        if w is None:
            assert g is None, f
            continue
        _close(g, w, RTOL64, f)


def _check_grads(t_loss, t_params, j_grads):
    """The port's gradient of every parameter against JAX's."""
    names = list(t_params)
    grads = torch.autograd.grad(t_loss, [t_params[k] for k in names])
    want = {f"{part}/{k}": v for part, d in
            ball_params_from_jax(flatten_params(j_grads)).items()
            for k, v in d.items()}
    assert set(want) == set(names)
    for k, g in zip(names, grads):
        _close(g, want[k], RTOL64, k)


def _named(**parts):
    out = {}
    for part, obj in parts.items():
        items = (obj.named_parameters() if isinstance(obj, torch.nn.Module)
                 else obj.named_tensors().items())
        for k, v in items:
            v.requires_grad_(True)
            out[f"{part}/{k}"] = v
    return out


FIELDS = ("elbo", "recon", "prior_kl", "inside_elbo", "ce_term", "p_m",
          "p_v", "qnet_mu", "qnet_var", "pred_vid", "inside_elbo_recon",
          "inside_elbo_kl", "gp_cov_elemwise_mean")


@pytest.mark.parametrize("impl", ["reference", "fused", "fused_pallas"])
@pytest.mark.parametrize("bound,ce", [
    ("hensman", "reference"), ("hensman", "entropy"),
    ("titsias", "entropy"), ("titsias", "reference")])
def test_ball_svgpvae_elbo_matches_jax(bound, ce, impl):
    rng = np.random.RandomState(9)
    titsias = bound == "titsias"
    entropy_ce = ce == "entropy" and not titsias
    ref_ce = ce == "reference" and titsias
    with _x64():
        enc, dec, params, t_enc, t_dec, vids = _elbo_setup(rng)
        j_gp, t_gp, _, _, _ = _ball_gp(rng, T=vids.shape[1],
                                       titsias=titsias)
        key = jax.random.PRNGKey(3)
        eps = jax.random.normal(key, (vids.shape[0], vids.shape[1], 2),
                                jnp.float64)

        def j_out(p, gp):
            return jmodels.ball_svgpvae_elbo(
                enc, p["enc"], dec, p["dec"], gp, jnp.asarray(vids), 0.7,
                key, clip_qs=True, gp_block_impl=impl,
                titsias_reference_ce=ref_ce, entropy_ce=entropy_ce)

        want = jax.jit(j_out)(params, j_gp)
        j_grads = jax.jit(jax.grad(lambda p, gp: jnp.mean(j_out(p, gp).elbo),
                                   argnums=(0, 1)))(params, j_gp)
        t_params = _named(enc=t_enc, dec=t_dec, gp=t_gp)
        got = tmodels.ball_svgpvae_elbo(
            t_enc, t_dec, t_gp, _t(vids), 0.7, _t(eps), clip_qs=True,
            gp_block_impl=impl, titsias_reference_ce=ref_ce,
            entropy_ce=entropy_ce)
        _check_outputs(got, want, FIELDS)
        _check_grads(got.elbo.mean(), t_params,
                     dict(j_grads[0], gp=j_grads[1]))


def _jax_np_split(key, batch, tmax, dtype=jnp.float64):
    """JAX pearce_elbo's NP draws from its key (svgpvae_tpu/models/
    ball.py:213-224)."""
    key_n, key_perm = jax.random.split(jax.random.fold_in(key, 1))
    mean_c, std_c = 0.5 * tmax, np.sqrt(0.25 * tmax)
    n_ctx = jnp.clip(jnp.round(
        mean_c + std_c * jax.random.normal(key_n, (), dtype=dtype)),
        2, tmax - 2).astype(jnp.int32)
    perm = jax.vmap(lambda k: jax.random.permutation(k, tmax))(
        jax.random.split(key_perm, batch))
    return (torch.tensor(int(n_ctx)),
            torch.from_numpy(np.array(perm, np.int64)))


@pytest.mark.parametrize("elbo_type,variant", [
    ("GPVAE_Pearce", "plain"), ("GPVAE_Pearce", "entropy_ce"),
    ("GPVAE_Pearce", "GP_joint"), ("GPVAE_Pearce", "full_cholesky"),
    ("VAE", "plain"), ("NP", "plain"), ("NP", "GP_joint")])
def test_pearce_elbo_matches_jax(elbo_type, variant):
    rng = np.random.RandomState(10)
    with _x64():
        enc, dec, params, t_enc, t_dec, vids = _elbo_setup(
            rng, full_cholesky=variant == "full_cholesky", T=8)
        V, T = vids.shape[:2]
        key = jax.random.PRNGKey(4)
        eps = jax.random.normal(key, (V, T, 2), jnp.float64)
        model_lt = 0.001 if elbo_type == "VAE" else 2.0
        joint = variant == "GP_joint"
        ls = {"length_scale_x": jnp.asarray(1.6),
              "length_scale_y": jnp.asarray(2.3)}

        def j_out(p):
            return jmodels.pearce_elbo(
                enc, p["enc"], dec, p["dec"], jnp.asarray(vids), 0.9, key,
                (p["gp"]["length_scale_x"], p["gp"]["length_scale_y"])
                if joint else model_lt, elbo_type=elbo_type,
                context_length_scale=model_lt,
                entropy_ce=variant == "entropy_ce")

        if joint:
            params = dict(params, gp=ls)
        want = jax.jit(j_out)(params)
        j_grads = jax.jit(jax.grad(lambda p: jnp.mean(j_out(p).elbo)))(
            params)
        t_gp = tgp.PearceLengthScales(**{k: _t(v) for k, v in ls.items()})
        t_params = _named(enc=t_enc, dec=t_dec,
                          **({"gp": t_gp} if joint else {}))
        split = _jax_np_split(key, V, T) if elbo_type == "NP" else None
        got = tmodels.pearce_elbo(
            t_enc, t_dec, _t(vids), 0.9, _t(eps),
            (t_gp.length_scale_x, t_gp.length_scale_y) if joint
            else model_lt, elbo_type=elbo_type,
            context_length_scale=model_lt,
            entropy_ce=variant == "entropy_ce", split=split)
        _check_outputs(got, want, FIELDS)
        _check_grads(got.elbo.mean(), t_params, j_grads)
    if elbo_type == "NP":
        assert 2 <= int(split[0]) <= T - 2
        with pytest.raises(ValueError):
            tmodels.pearce_elbo(t_enc, t_dec, _t(vids), 0.9, _t(eps), 2.0,
                                elbo_type="NP")


def test_np_split_draws():
    """draw_np_split: the context size in [2, T - 2] around T / 2, a
    permutation per video, reproducible from the generator."""
    gen = torch.Generator().manual_seed(0)
    sizes = []
    for _ in range(200):
        n_ctx, perm = tmodels.draw_np_split(5, 30, gen)
        assert perm.shape == (5, 30)
        assert (perm.sort(dim=1).values == torch.arange(30)).all()
        sizes.append(int(n_ctx))
    assert min(sizes) >= 2 and max(sizes) <= 28
    assert abs(np.mean(sizes) - 15) < 1.0
    a = tmodels.draw_np_split(3, 10, torch.Generator().manual_seed(1))
    b = tmodels.draw_np_split(3, 10, torch.Generator().manual_seed(1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_np_mask_constant_is_exact_subset():
    """The NP context likelihood with masked targets equals exact GPs on
    the context subsets alone (float64), the 1e10 padding's constant
    taken back out."""
    rng = np.random.RandomState(11)
    V, T, n_ctx = 3, 10, 4
    t = torch.arange(T, dtype=torch.float64)[None].expand(V, T)
    mu, var = _t(rng.randn(V, T)), _t(np.exp(rng.randn(V, T)))
    perm = torch.stack([torch.randperm(T, generator=torch.Generator()
                                       .manual_seed(i)) for i in range(V)])
    is_target = torch.arange(T)[None] >= n_ctx
    g = lambda a: torch.gather(a, 1, perm)  # noqa: E731
    masked = tgp.gp_regression_1d(g(t), g(mu),
                                  torch.where(~is_target, g(var), 1e10),
                                  t, 2.0).log_marginal
    pad = -0.5 * (T - n_ctx) * (np.log(1e10) + np.log(2 * np.pi))
    exact = tgp.gp_regression_1d(g(t)[:, :n_ctx], g(mu)[:, :n_ctx],
                                 g(var)[:, :n_ctx], t, 2.0).log_marginal
    _close(masked - pad, exact, 1e-6)
