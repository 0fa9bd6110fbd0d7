"""The port's MNIST baseline modules against the JAX package.

  * MnistCVAE and SVIGPDecoder on weights carried over by utils.convert
    (cvae_params_from_jax, svigp_params_from_jax; casale_params_from_jax's
    leaves), fp32;
  * forward_pass_vae (VAE with the variance clip, CVAE without) and its
    gradients, and predict_cvae (an object id absent from the train rows:
    the count floor), on the JAX draws;
  * the deep SVIGP: svigp_variational_loss, svigp_posterior_params,
    forward_pass_deep_svigp and predict_deep_svigp, with the GPLVM table
    and the cosine normalization, and the gradient of the ELBO with
    respect to every GP tensor and the decoder;
  * Casale: kron, v_matrix (with and without the normalization),
    taylor_terms against JAX's taylor_coeffs (B rebuilt from the factored
    pieces), casale_k_inv and the dense B as test-side references (the
    (N, N) inverse that the port never forms), the driver's whole loss
    (full-train encode, V, the Taylor terms, forward_pass_casale) and its
    gradients (softplus noise under a ceiling, the variance clip),
    predict_cgen_casale (sampled with noise_override, and the mean), and
    the gradients of casale_noise under softplus and the alpha_max
    ceiling and of effective_alpha below its floor (the clamp path).

Tolerances: float64 within RTOL64 = 1e-9 of each output's max |entry|
(the same formulas in other orders), as tests/test_torch_ball.py; the
fp32 nets within 1e-5 of max |entry| (three fp32 layers).
"""

import contextlib
import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import models as jmodels, nn as jnets
from svgpvae_tpu.cli import mnist as jcli
from svgpvae_tpu.gp import casale as jcasale, svigp as jsvigp
from svgpvae_tpu_torch import gp as tgp, models as tmodels
from svgpvae_tpu_torch.cli import mnist as tcli
from svgpvae_tpu_torch.nn import MnistCVAE, MnistVAE, SVIGPDecoder
from svgpvae_tpu_torch.utils.convert import (casale_params_from_jax,
                                             cvae_params_from_jax,
                                             svigp_params_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from export_jax_params import flatten_params  # noqa: E402
from torch_threads import _torch_threads  # noqa: E402,F401

RTOL64 = 1e-9
RTOL32 = 1e-5
L = 4
# XLA's CPU backend at its lowest optimisation level: the same HLO, a
# compile about half as long (the file's time is mostly JAX compiles)
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


def _close(got, want, rtol=RTOL64, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(_np(got).astype(np.float64), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300),
                               err_msg=what)


def _t(a):
    return torch.tensor(np.array(a, np.float64))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                  tree)


def _mnist_rows(n, n_obj, M, rng, ids=None):
    """[id, angle, pca (M)] rows and images."""
    ids = rng.randint(0, n_obj, n) if ids is None else ids
    aux = np.hstack([ids[:, None].astype(float),
                     rng.randint(0, 16, (n, 1)) * 2 * np.pi / 16,
                     rng.randn(n, M)])
    return rng.rand(n, 28, 28, 1), aux


# --- nets --------------------------------------------------------------------


def test_nets_match_flax():
    rng = np.random.RandomState(0)
    x = rng.rand(5, 28, 28, 1).astype(np.float32)
    ang = (rng.rand(5) * 2 * np.pi).astype(np.float32)
    z = rng.randn(5, L).astype(np.float32)
    x3 = np.asarray(jmodels.vae.cvae_inputs(jnp.asarray(x), jnp.asarray(ang)))
    assert np.array_equal(
        x3, tmodels.cvae_inputs(torch.from_numpy(x), torch.from_numpy(ang)))

    cvae = jnets.MnistCVAE(L=L)
    p = _quick(jax.jit(cvae.init))(jax.random.PRNGKey(1),
                           jnp.zeros((2, 28, 28, 3)), jnp.zeros(2))
    t_cvae = MnistCVAE(L=L)
    t_cvae.load_state_dict(cvae_params_from_jax(
        flatten_params({"vae": p}))["vae"])
    assert t_cvae.dec_convs[0].in_channels == 10
    def apply(method):
        return _quick(jax.jit(functools.partial(cvae.apply, method=method)))

    mu, var = apply(cvae.encode)(p, x3, ang)
    t_mu, t_var = t_cvae.encode(torch.from_numpy(x3), torch.from_numpy(ang))
    _close(t_mu, mu, RTOL32)
    _close(t_var, var, RTOL32)
    _close(t_cvae.decode(torch.from_numpy(z), torch.from_numpy(ang)),
           apply(cvae.decode)(p, z, ang), RTOL32)

    dec = jnets.SVIGPDecoder(L=L)
    dp = _quick(jax.jit(dec.init))(jax.random.PRNGKey(2), jnp.zeros((2, L)))
    gp = jsvigp.init_svigp(rng.randn(6, 2 + 3), None, L=L, N_train=10)
    port = svigp_params_from_jax(flatten_params({"dec": dp, "gp": gp}))
    t_dec = SVIGPDecoder(L=L)
    t_dec.load_state_dict(port["dec"])
    _close(t_dec(torch.from_numpy(z)), _quick(jax.jit(dec.apply))(dp, z),
           RTOL32)
    assert set(port["gp"]) == {"inducing_points", "length_scale",
                               "amplitude", "q_mu", "q_scale", "noise"}

    # the Casale converter: the MnistVAE state (its nets are held by
    # tests/test_torch_mnist_data.py) and the CasaleGP leaves
    vp = _quick(jax.jit(jnets.MnistVAE(L=L).init))(jax.random.PRNGKey(3),
                                           jnp.zeros((2, 28, 28, 1)))
    cg = jcasale.init_casale_gp(rng.randn(4, 3), False, True)
    port = casale_params_from_jax(flatten_params({"vae": vp, "gp": cg}))
    MnistVAE(L=L).load_state_dict(port["vae"])
    assert set(port["gp"]) == {"length_scale", "amplitude", "alpha",
                               "object_vectors"}


# --- VAE / CVAE --------------------------------------------------------------


def _vae_pair(cvae: bool):
    """(flax module, f64 params, f64 torch module on the same weights)."""
    if cvae:
        net = jnets.MnistCVAE(L=L, dtype=jnp.float64)
        p = _quick(jax.jit(net.init))(jax.random.PRNGKey(4),
                              jnp.zeros((2, 28, 28, 3)), jnp.zeros(2))
    else:
        net = jnets.MnistVAE(L=L, dtype=jnp.float64)
        p = _quick(jax.jit(net.init))(jax.random.PRNGKey(4),
                              jnp.zeros((2, 28, 28, 1)))
    p = _f64(p)
    flat = flatten_params({"vae": p})
    state = cvae_params_from_jax(flat)["vae"] if cvae else _vae_state(flat)
    t_net = (MnistCVAE if cvae else MnistVAE)(L=L).double()
    t_net.load_state_dict(state)
    return net, p, t_net


@pytest.mark.parametrize("cvae,clip", [(False, True), (True, False)])
def test_forward_pass_vae_matches_jax(cvae, clip):
    rng = np.random.RandomState(5)
    with _x64():
        net, p, t_net = _vae_pair(cvae)
        im, aux = _mnist_rows(7, 3, 4, rng)
        key = jax.random.PRNGKey(6)

        def j_elbo(p):
            out = jmodels.forward_pass_vae(net, p, (im, aux), key,
                                           clip_qs=clip, cvae=cvae)
            return out.elbo, out
        (_, want), g = _quick(jax.jit(jax.value_and_grad(
            j_elbo, has_aux=True)))(p)
        eps = _t(jax.random.normal(key, (7, L), jnp.float64))
        got = tmodels.forward_pass_vae(t_net, (_t(im), _t(aux)), eps,
                                       clip_qs=clip, cvae=cvae)
        for name in want._fields:
            _close(getattr(got, name), getattr(want, name), what=name)
        g = flatten_params({"vae": g})
        got.elbo.backward()
        conv = cvae_params_from_jax(g)["vae"] if cvae else _vae_state(g)
        for k, t in t_net.named_parameters():
            _close(t.grad, conv[k], what=k)


def _vae_state(flat):
    from svgpvae_tpu_torch.utils.convert import _module, mnist_vae_state
    return mnist_vae_state(_module(flat, "vae/params"))


def test_predict_cvae_matches_jax():
    rng = np.random.RandomState(7)
    n_obj = 6
    with _x64():
        net, p, t_net = _vae_pair(True)
        # objects 0..3 in the train rows; the test asks for 5 (no train
        # rows: its mean latent is 0 through the count floor)
        tr_im, tr_aux = _mnist_rows(12, 4, 4, rng)
        te_im, te_aux = _mnist_rows(5, n_obj, 4, rng,
                                    ids=np.array([0, 1, 3, 5, 2]))
        key = jax.random.PRNGKey(8)
        recon, loss = _quick(jax.jit(functools.partial(
            jmodels.predict_cvae, net, n_objects=n_obj)))(
                p, tr_im, tr_aux, te_im, te_aux, key)
        eps = _t(jax.random.normal(key, (12, L), jnp.float64))
        t_recon, t_loss = tmodels.predict_cvae(
            t_net, _t(tr_im), _t(tr_aux), _t(te_im), _t(te_aux), eps,
            n_objects=n_obj)
    _close(t_recon, recon)
    _close(t_loss, loss)


# --- deep SVIGP --------------------------------------------------------------


def _svigp_pair(rng, ov: bool, normalize: bool, n_obj=5, M=3, m=6):
    ip = np.hstack([np.arange(m)[:, None], rng.rand(m, 1) * 2 * np.pi,
                    rng.randn(m, M)])
    table = rng.randn(n_obj, M) if ov else None
    gp = jsvigp.init_svigp(ip, table, L=L, N_train=40, jitter=1e-6,
                           K_obj_normalize=normalize, dtype=jnp.float64)
    gp = gp.replace(q_mu=jnp.asarray(rng.randn(L, m)),
                    q_scale=jnp.asarray(np.eye(m) + 0.2 * rng.randn(L, m, m)),
                    noise=jnp.asarray(0.3), length_scale=jnp.asarray(0.8),
                    amplitude=jnp.asarray(1.3))
    dec = jnets.SVIGPDecoder(L=L, dtype=jnp.float64)
    dp = _f64(_quick(jax.jit(dec.init))(jax.random.PRNGKey(9),
                                        jnp.zeros((2, L))))
    port = svigp_params_from_jax(flatten_params({"dec": dp, "gp": gp}))
    t_dec = SVIGPDecoder(L=L).double()
    t_dec.load_state_dict(port["dec"])
    t_gp = tgp.SVIGP(**port["gp"], jitter=1e-6, N_train=40,
                     K_obj_normalize=normalize)
    return dec, dp, gp, t_dec, t_gp


@pytest.mark.parametrize("ov,normalize", [(True, True)])
def test_svigp_matches_jax(ov, normalize):
    rng = np.random.RandomState(10)
    with _x64():
        dec, dp, gp, t_dec, t_gp = _svigp_pair(rng, ov, normalize)
        im, aux = _mnist_rows(9, 5, 3, rng)
        aux = np.hstack([np.arange(9)[:, None], aux])  # global index first
        for t_fn, j_fn in ((tgp.svigp_variational_loss,
                            jsvigp.svigp_variational_loss),
                           (tgp.svigp_posterior_params,
                            jsvigp.svigp_posterior_params)):
            got = t_fn(t_gp, _t(aux[:, 1:]))
            want = _quick(jax.jit(j_fn))(gp, aux[:, 1:])
            for g, w in zip(got, want):
                _close(g, w)

        def j_elbo(p):
            out = jmodels.forward_pass_deep_svigp(dec, p["dec"], p["gp"],
                                                  (im, aux))
            return out.elbo, out
        (_, want), g = _quick(jax.jit(jax.value_and_grad(
            j_elbo, has_aux=True)))(
            {"dec": dp, "gp": gp})
        for t in t_gp.named_tensors().values():
            t.requires_grad_(True)
        got = tmodels.forward_pass_deep_svigp(t_dec, t_gp, (_t(im), _t(aux)))
        for name in want._fields:
            _close(getattr(got, name), getattr(want, name), what=name)
        recon, loss = _quick(jax.jit(functools.partial(
            jmodels.predict_deep_svigp, dec)))(dp, gp, (im, aux))
        t_recon, t_loss = tmodels.predict_deep_svigp(t_dec, t_gp,
                                                     (_t(im), _t(aux)))
        _close(t_recon, recon)
        _close(t_loss, loss)

        got.elbo.backward()
        want_g = svigp_params_from_jax(flatten_params(g))
        for k, t in t_gp.named_tensors().items():
            _close(t.grad, want_g["gp"][k], what=k)
        for k, t in t_dec.named_parameters():
            _close(t.grad, want_g["dec"][k], what=k)


# --- Casale ------------------------------------------------------------------


def _casale_problem(rng, n_obj=4, Q=5, M=3, b=6):
    """A sorted train layout with some (object, angle) pairs missing, a
    CasaleGP and the matching torch one, a flax MnistVAE on the same
    weights."""
    angles = np.arange(Q) * 2 * np.pi / 16
    rows = [(i, a) for i in range(n_obj) for a in angles
            if rng.rand() > 0.25]
    aux = np.array([[i, a, *rng.randn(M)] for i, a in rows])
    images = rng.rand(len(aux), 28, 28, 1)
    train = jcli.sort_train_data({"images": images, "aux_data": aux})
    return train, rng.randn(n_obj, M)


def _casale_gp(table, normalize=False, ov_joint=True, transform="clamp",
               alpha_max=0.0, alpha=0.3):
    gp = jcasale.init_casale_gp(table, normalize, ov_joint,
                                dtype=jnp.float64,
                                alpha_transform=transform,
                                alpha_max=alpha_max)
    gp = gp.replace(length_scale=jnp.asarray(0.9), amplitude=jnp.asarray(1.2),
                    alpha=jnp.asarray(alpha))
    t_gp = tgp.CasaleGP(
        **{k: _t(getattr(gp, k)) for k in ("length_scale", "amplitude",
                                           "alpha", "object_vectors")},
        object_kernel_normalize=normalize, ov_joint=ov_joint,
        alpha_transform=transform, alpha_max=alpha_max)
    return gp, t_gp


def _grid(train):
    aux = train["aux_data"]
    mask = jcli.train_angles_mask(aux)
    return (np.sort(np.unique(aux[:, 2])),
            np.sort(np.unique(aux[:, 1])).astype(int), mask)


@pytest.mark.parametrize("normalize", [False, True])
def test_casale_v_and_taylor_match_jax(normalize):
    rng = np.random.RandomState(11)
    with _x64():
        a = rng.randn(3, 2)
        b = rng.randn(4, 5)
        _close(tgp.kron(_t(a), _t(b)), jcasale.kron(a, b))
        _close(tgp.kron(_t(a), _t(b)), np.kron(a, b))

        train, table = _casale_problem(rng)
        angles, oids, mask = _grid(train)
        assert np.array_equal(tcli.train_angles_mask(train["aux_data"]), mask)
        idx = torch.from_numpy(np.nonzero(mask)[0])
        gp, t_gp = _casale_gp(table, normalize)
        N = len(train["images"])
        Z = rng.randn(N, L)

        def j_all(gp, Z):  # V (the mask's rows), the Taylor pieces, K^-1
            V = jcasale.v_matrix(gp, jnp.asarray(angles), jnp.asarray(oids),
                                 jnp.asarray(jcasale.mask_to_indices(mask)))
            return (V, jcasale.taylor_coeffs(gp, Z, V),
                    jcasale.casale_k_inv(V, gp.alpha))
        V, (a_j, B_j, c_j), K_inv_j = _quick(jax.jit(j_all))(
            gp, jnp.asarray(Z))
        t_V = tgp.v_matrix(t_gp, _t(angles), torch.from_numpy(oids), idx)
        _close(t_V, V)
        a_t, ztKV, K_inv_V, c_t = tgp.taylor_terms(t_gp, _t(Z), t_V)
        _close(a_t, a_j)
        _close(c_t, c_j)
        _close(-a_t[:, :, None] * ztKV[:, None, :] + K_inv_V[None], B_j)

        # test-side references: the dense Woodbury inverse (JAX's
        # casale_k_inv, which the port never forms: (I - V (alpha I + V^T V
        # + ridge I)^-1 V^T) / alpha, with the factorization's 1e-7 trace
        # ridge) and B from it
        alpha = tgp.effective_alpha(t_gp.alpha)
        H = t_V.shape[1]
        eye = torch.eye(H, dtype=torch.float64)
        inner = alpha * eye + t_V.T @ t_V
        chol = torch.linalg.cholesky(inner + 1e-7 * torch.trace(inner) / H
                                     * eye)
        K_inv = (torch.eye(N, dtype=torch.float64)
                 - t_V @ torch.cholesky_solve(t_V.T, chol)) / alpha
        _close(K_inv, K_inv_j)
        KZ = K_inv @ _t(Z)
        B_dense = torch.stack([K_inv @ t_V - KZ[:, l:l + 1] @ (
            KZ[:, l:l + 1].T @ t_V) for l in range(L)])
        _close(B_dense, B_j)
        _close(tgp.apply_k_inv(t_V, t_gp.alpha, _t(Z)), KZ)


def _casale_nets(rng):
    vae = jnets.MnistVAE(L=L, dtype=jnp.float64)
    vp = _f64(_quick(jax.jit(vae.init))(jax.random.PRNGKey(12),
                                jnp.zeros((2, 28, 28, 1))))
    t_vae = MnistVAE(L=L).double()
    t_vae.load_state_dict(_vae_state(flatten_params({"vae": vp})))
    return vae, vp, t_vae


@pytest.mark.parametrize("transform,alpha_max,clip", [
    ("softplus", 0.2, True)])
def test_casale_loss_and_cgen_match_jax(transform, alpha_max, clip):
    rng = np.random.RandomState(13)
    with _x64():
        train, table = _casale_problem(rng)
        angles, oids, mask = _grid(train)
        idx = np.nonzero(mask)[0]
        gp, t_gp = _casale_gp(table, transform=transform,
                              alpha_max=alpha_max)
        vae, vp, t_vae = _casale_nets(rng)
        im, aux = train["images"], train["aux_data"]
        batch = (im[2:8], aux[2:8])
        N = len(im)
        k1, k2 = jax.random.split(jax.random.PRNGKey(14))
        beta = 0.5

        def j_loss(p):
            Z = jmodels.encode_full_casale(vae, p["vae"], im, k1,
                                           clip_qs=clip)
            V = jcasale.v_matrix(p["gp"], jnp.asarray(angles),
                                 jnp.asarray(oids), jnp.asarray(idx))
            a, ztKV, K_inv_V, c = jcasale.taylor_terms(p["gp"], Z, V)
            return jmodels.forward_pass_casale(
                vae, p["vae"], p["gp"], batch, k2, a, None, c, V, beta,
                clip_qs=clip, ztKV=ztKV, K_inv_V=K_inv_V)

        params = {"vae": vp, "gp": gp}
        (_, want), g = _quick(jax.jit(jax.value_and_grad(
            lambda p: (j_loss(p).elbo, j_loss(p)), has_aux=True)))(params)
        g = casale_params_from_jax(flatten_params(g))

        for t in t_gp.named_tensors().values():
            t.requires_grad_(True)
        Z = tmodels.encode_full_casale(
            t_vae, _t(im), _t(jax.random.normal(k1, (N, L), jnp.float64)),
            clip_qs=clip)
        V = tgp.v_matrix(t_gp, _t(angles), torch.from_numpy(oids),
                         torch.from_numpy(idx))
        a, ztKV, K_inv_V, c = tgp.taylor_terms(t_gp, Z, V)
        got = tmodels.forward_pass_casale(
            t_vae, t_gp, (_t(batch[0]), _t(batch[1])),
            _t(jax.random.normal(k2, (6, L), jnp.float64)), a, c, V, beta,
            ztKV=ztKV, K_inv_V=K_inv_V, clip_qs=clip)
        for name in want._fields:
            _close(getattr(got, name), getattr(want, name), what=name)
        got.elbo.backward()
        for k, t in t_gp.named_tensors().items():
            _close(t.grad, g["gp"][k], what=k)
        for k, t in t_vae.named_parameters():
            _close(t.grad, g["vae"][k], what=k)

        # cgen: test rows [id, angle, pca]; sampled, pinned noise, mean
        te_im, te_aux = _mnist_rows(5, 4, 3, rng)
        Zj, Vj = _quick(jax.jit(lambda vp, gp: (
            jmodels.encode_full_casale(vae, vp, im, k1),
            jcasale.v_matrix(gp, jnp.asarray(angles), jnp.asarray(oids),
                             jnp.asarray(idx)))))(vp, gp)
        for take_mean, override in ((False, 0.05), (True, None)):
            recon, loss = _quick(jax.jit(functools.partial(
                jmodels.predict_cgen_casale, vae, take_mean=take_mean,
                noise_override=override)))(vp, gp, te_im, te_aux, aux, Vj,
                                           Zj, k2)
            t_recon, t_loss = tmodels.predict_cgen_casale(
                t_vae, t_gp, _t(te_im), _t(te_aux), _t(aux), V.detach(),
                _t(Zj), _t(jax.random.normal(k2, (5, L), jnp.float64)),
                take_mean=take_mean, noise_override=override)
            _close(t_recon, recon)
            _close(t_loss, loss)


@pytest.mark.parametrize("transform,alpha_max,alpha", [
    ("softplus", 0.0, 0.4), ("softplus", 0.5, 1.2), ("clamp", 0.5, 0.9),
    ("clamp", 0.0, -0.3), ("clamp", 0.0, 3e-6)])
def test_casale_noise_gradients_match_jax(transform, alpha_max, alpha):
    """softplus, the straight-through ceiling (raw alpha above it) and the
    straight-through floor (alpha below ALPHA_FLOOR): values and
    gradients."""
    with _x64():
        gp, t_gp = _casale_gp(np.ones((2, 2)), transform=transform,
                              alpha_max=alpha_max, alpha=alpha)

        def j_fn(a):
            return jcasale.effective_alpha(jcasale.casale_noise(
                gp.replace(alpha=a)))
        t_gp.alpha.requires_grad_(True)
        got = tgp.effective_alpha(tgp.casale_noise(t_gp))
        _close(got, j_fn(gp.alpha))
        got.backward()
        _close(t_gp.alpha.grad, jax.grad(j_fn)(gp.alpha))
    if transform == "clamp" and alpha < tgp.ALPHA_FLOOR:
        assert float(got.detach()) == pytest.approx(tgp.ALPHA_FLOOR,
                                                    rel=RTOL64)
        assert float(t_gp.alpha.grad) == 1.0
