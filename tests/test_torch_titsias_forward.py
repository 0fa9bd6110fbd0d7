"""The port's forward pass under the Titsias bound against the JAX package
(the rest of the bound's tests: tests/test_torch_titsias.py, whose
helpers and tolerances these share).

  * forward_pass_svgpvae with the Titsias bound (the plain objective of
    the record configs), MNIST through the CUDA cell's fused_pallas and
    SPRITES through its fused, with the exact-entropy CE and with
    --titsias_reference_ce, on injected noise: every output and the
    objective's gradient with respect to every parameter, in fp32 and in
    float64;
  * the exact entropy is the Titsias default.

Tolerances as tests/test_torch_titsias.py: float64 within 1e-9 of each
output's max |entry| (1e-6 on the rank-deficient SPRITES K_mm); fp32 a
scalar that is the difference of larger terms within 1e-5 of the
magnitudes it is computed from, other outputs 1e-5 of their max |entry|,
gradients 2e-4 (MNIST) and 1e-3 (SPRITES) of each tensor's max |entry|.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import models as jmodels
from svgpvae_tpu_torch import gp as tgp, models as tmodels
from svgpvae_tpu_torch import train as ttrain
from svgpvae_tpu_torch.utils.convert import (mnist_params_from_jax,
                                             params_from_jax)

from test_torch_titsias import (BETA, FPC, GRAD_RTOL32, IMPL, RTOL64,
                                RTOL_LOSS, _mnist_case, _mnist_port, _np,
                                _sprites_case, _sprites_port, _x64,
                                flatten_params)
from torch_threads import _torch_threads  # noqa: E402,F401


CES = ("entropy", "reference")
# scalars that are the difference of larger terms: (term, weight)
SCALAR_TERMS = {"elbo": (("recon_loss", 1.0), ("kl_term", None)),
                "kl_term": (("ce_term", 1.0), ("inside_elbo", 1.0)),
                "inside_elbo": (("inside_elbo_recon", 1.0),
                                ("inside_elbo_kl", 1.0))}


def _jax_forward(workload, nets, dtype):
    """jit(value_and_grad) of the plain objective under both CE forms."""
    def fwd(params, batch, key, reference_ce):
        kw = dict(beta=BETA, C_ma=jnp.asarray(0.0, dtype),
                  lagrange_mult=jnp.asarray(1.0, dtype), alpha=0.99,
                  kappa=0.1, clip_qs=True, geco=False,
                  gp_block_impl=IMPL[workload],
                  titsias_reference_ce=reference_ce)
        if workload == "sprites":
            vae, rep = nets
            kw.update(repr_apply=rep.apply, repr_params=params["repr"],
                      frames_per_char=FPC)
        else:
            vae = nets
        out = jmodels.forward_pass_svgpvae(vae, params["vae"], params["gp"],
                                           batch, key, **kw)
        return out.elbo, out

    grad = jax.value_and_grad(fwd, has_aux=True)
    return jax.jit(lambda p, b, k: [grad(p, b, k, ce == "reference")
                                    for ce in CES])


@pytest.fixture(scope="module", params=[
    (w, p) for w in ("mnist", "sprites") for p in ("f32", "f64")],
    ids=lambda c: f"{c[0]}-{c[1]}")
def forward_case(request):
    """The JAX side of one (workload, precision): inputs, noise, and each
    CE form's outputs and gradients in the port's layout."""
    workload, precision = request.param
    f64 = precision == "f64"
    jdtype, tdtype = ((jnp.float64, torch.float64) if f64
                      else (jnp.float32, torch.float32))
    with _x64(f64):
        if workload == "mnist":
            nets, params, batches = _mnist_case(jdtype)
            batch = batches[0]
            port = _mnist_port(params, tdtype)
        else:
            nets, params, batch = _sprites_case(jdtype)
            port = _sprites_port(params, tdtype)
        key = jax.random.PRNGKey(3)
        jb = tuple(jnp.asarray(a, jdtype) for a in batch)
        outs = _jax_forward(workload, nets, jdtype)(params, jb, key)
        eps = np.array(jax.random.normal(key, (len(batch[0]),
                                               outs[0][0][1].p_m.shape[1]),
                                         jdtype))
        want = {}
        for ce, ((_, out), g) in zip(CES, outs):
            flat = flatten_params(g)
            if workload == "mnist":
                conv = mnist_params_from_jax(flat)
            else:
                conv = params_from_jax(flat)
            want[ce] = (jax.tree_util.tree_map(np.asarray, out),
                        {f"{part}/{k}": _np(v) for part, d in conv.items()
                         for k, v in d.items()})
    return dict(workload=workload, precision=precision, dtype=tdtype,
                params=port, batch=batch, eps=eps, want=want)


def _assert_forward(got, want, grads_got, grads_want, tol_v, tol_g, f64):
    for name in tmodels.SVGPVAEOutputs._fields:
        if name == "mean_vectors":  # no bias_analysis: JAX's unread 0
            assert got.mean_vectors is None
            assert np.asarray(want.mean_vectors).shape == ()
            continue
        w = np.asarray(getattr(want, name), np.float64)
        g = _np(getattr(got, name)).astype(np.float64)
        scale = max(np.abs(w).max(), 1.0)
        if name in SCALAR_TERMS and not f64:
            scale = max(scale, sum(
                abs(float(getattr(want, t))) * (wt if wt is not None else
                                                 BETA / got.p_m.shape[1])
                for t, wt in SCALAR_TERMS[name]))
        err = np.abs(g - w).max()
        assert err <= tol_v * scale, (name, err, scale)
    assert set(grads_got) == set(grads_want)
    for name, w in grads_want.items():
        g = grads_got[name]
        g = np.zeros_like(w) if g is None else _np(g)
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max()
        assert err <= tol_g * scale, (name, err, scale)


@pytest.mark.parametrize("ce", CES)
def test_forward_pass_matches_jax(forward_case, ce):
    c = forward_case
    params = copy.deepcopy(c["params"])  # gradients accumulate in place
    named = ttrain.trainable_tensors(params, lambda name: True)
    batch = tuple(torch.tensor(a, dtype=c["dtype"]) for a in c["batch"])
    kw = dict(beta=BETA, C_ma=torch.tensor(0.0, dtype=c["dtype"]),
              lagrange_mult=torch.tensor(1.0, dtype=c["dtype"]), alpha=0.99,
              kappa=0.1, clip_qs=True, geco=False,
              gp_block_impl=IMPL[c["workload"]],
              titsias_reference_ce=ce == "reference")
    if c["workload"] == "sprites":
        kw.update(repr_net=params["repr"], frames_per_char=FPC)
    got = tmodels.forward_pass_svgpvae(params["vae"], params["gp"], batch,
                                       torch.from_numpy(c["eps"]), **kw)
    got.elbo.backward()
    f64 = c["precision"] == "f64"
    if f64:
        tol_v = tol_g = RTOL64
    else:
        tol_v, tol_g = RTOL_LOSS, GRAD_RTOL32[c["workload"]]
    want, grads_want = c["want"][ce]
    _assert_forward(got, want, {k: t.grad for k, t in named.items()},
                    grads_want, tol_v, tol_g, f64)


def test_entropy_ce_is_the_titsias_default():
    """The CE term under the Titsias bound is the exact entropy of
    N(p_m, p_v) unless titsias_reference_ce; under Hensman the reference
    cross-entropy unless entropy_ce (PARITY.md #13)."""
    _, params, batches = _mnist_case(jnp.float32)
    port = _mnist_port(params, torch.float32)
    batch = tuple(torch.tensor(a, dtype=torch.float32) for a in batches[0])
    eps = torch.zeros(len(batch[0]), 4)

    def ce(titsias, **kw):
        gp = copy.copy(port["gp"])
        gp.config = tgp.SVGPConfig(titsias=titsias, jitter=1e-6,
                                   N_train=gp.config.N_train)
        with torch.no_grad():
            out = tmodels.forward_pass_svgpvae(
                port["vae"], gp, batch, eps, beta=BETA, C_ma=torch.tensor(0.),
                lagrange_mult=torch.tensor(1.), alpha=0.99, kappa=0.1,
                gp_block_impl="fused", **kw)
        entropy = torch.sum(-0.5 * (1.0 + np.log(2 * np.pi)
                                    + torch.log(out.p_v)))
        return float(out.ce_term), float(entropy)

    got, entropy = ce(True)
    assert got == entropy
    got, entropy = ce(True, titsias_reference_ce=True)
    assert got != entropy
    got, entropy = ce(False)
    assert got != entropy
    got, entropy = ce(False, entropy_ce=True)
    assert got == entropy
