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
  * (tests/test_torch_ball_elbo.py) ball_svgpvae_elbo and pearce_elbo
    at float64.

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

from svgpvae_tpu import data as jdata, nn as jnets
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
from torch_threads import _torch_threads  # noqa: E402,F401

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
