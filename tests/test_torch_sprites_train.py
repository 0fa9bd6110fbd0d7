"""The port's SPRITES training (Hensman + GECO) against the JAX package.

Small size: b = 100 (2 characters x 50 frames), L = 8, L_action 3,
L_character 4, on weights converted from flax and JAX's noise.

  * forward_pass_svgpvae, SPRITES branch (aux data from the repr net under
    autograd, the PVAR_CLIP clip), under reference, fused_rejitter and
    fused_rejitter_pallas (the "pallas" inverse is B1's Cholesky twin on
    the CPU, JAX's XLA reference off the TPU): every output, and the
    gradient of the objective with respect to every vae, repr and gp
    tensor.  At float64 on the rank-deficient fixture of
    tests/test_fused_gp.py (m = 24 > L_action * L_character = 12; PD only
    through the jitter), within 1e-8 of each output's scale (1e-6 for the
    pallas path, as tests/test_fused_gp.py holds it): the same math summed
    in other orders.  At float32 on a full-rank K_mm (m = 10): values
    within 1e-4 of scale, gradients within 1e-3 of max |grad|.  A
    rank-deficient K_mm is not held at float32: K_mm^-1 then carries
    entries ~1/jitter and A_hat = K_mm Sigma^-1 K_mm is an O(|K_mm|)
    cancellation, so fp32 round-off in either package moves p_v and the
    KL far more than 1e-4 (ROADMAP.md section C);
  * two training steps against JAX's make_train_step, with the injected
    noise: the parameters and the GECO state;
  * two pretraining steps (repr net + classification head, cross-entropy)
    against JAX: loss, accuracy and parameters;
  * the trainability mask;
  * (tests/test_torch_sprites_train_cli.py) the whole slice through
    cli.sprites.main, sprites_pca_init, the dispatch cells, the
    refusals, and that the entry point imports no jax.

Scalars that are the difference of large terms (the objective, the
inside-ELBO, the KL term) are held to the sum of the magnitudes of what
they are computed from, as tests/test_torch_mnist_train.py does.
"""

import contextlib
import copy
import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import gp as jgp, models as jmodels
from svgpvae_tpu import nn as jnets, train as jtrain
from svgpvae_tpu.gp.svgp import SVGPConfig as JConfig
from svgpvae_tpu_torch import gp as tgp, models as tmodels
from svgpvae_tpu_torch import train as ttrain
from svgpvae_tpu_torch.cli import sprites as tsprites
from svgpvae_tpu_torch.utils.convert import (params_from_jax,
                                             sprites_train_params_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from export_jax_params import flatten_params  # noqa: E402
from torch_threads import _torch_threads  # noqa: E402,F401

L, L_ACT, L_CHAR, FPC, B = 8, 3, 4, 50, 100
N_ACTIONS = 72
KAPPA = float(np.sqrt(0.0075))
JITTER = 0.01
IMPLS = ["reference", "fused_rejitter", "fused_rejitter_pallas"]
TOL = {"f64": (1e-8, 1e-8), "f32": (1e-4, 1e-3)}  # (values, gradients)
PALLAS_TOL64 = 1e-6
GECO0 = (0.3, 1.5)  # C_ma, lagrange multiplier going into the step
SCALAR_TERMS = {"elbo": ("kl_term", "recon_loss"),
                "kl_term": ("ce_term", "inside_elbo"),
                "inside_elbo": ("inside_elbo_recon", "inside_elbo_kl")}


# XLA's CPU backend at its lowest optimisation level: the same HLO, a
# compile about half as long, results that move by round-off.  The port's
# tests compile with it the JAX programs that are only references and run
# briefly beside their compile (GP blocks, the ball's MLPs, small MNIST
# batches).  Not the conv nets at SPRITES size: unoptimised they run
# several times slower (the float64 SPRITES forward of this file's
# forward_case took 292 s against 66 s).  A JAX training step whose
# parameters are held to a tenth of an Adam step compiles as the JAX
# drivers compile it, except at float64 (a round-off change can flip an
# Adam step on an entry whose fp32 gradient is round-off).
QUICK = {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True}


def quick_jit(fun, **kw):
    """jax.jit(fun, **kw), compiled with QUICK once per argument shapes
    when called on arrays; inside another traced function (a tracer among
    the arguments) it traces inline as jax.jit does."""
    jitted = jax.jit(fun, **kw)
    if "static_argnums" in kw or "static_argnames" in kw:
        return jitted
    compiled = {}

    @functools.wraps(fun)
    def call(*args, **kwargs):
        leaves = jax.tree_util.tree_leaves((args, kwargs))
        if any(isinstance(x, jax.core.Tracer) for x in leaves):
            return jitted(*args, **kwargs)
        key = (str(jax.tree_util.tree_structure((args, kwargs))),
               tuple((np.shape(x), np.result_type(x).name) for x in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args, **kwargs).compile(
                compiler_options=QUICK)
        return compiled[key](*args, **kwargs)
    return call


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def flax_nets():
    """SpritesVAE / SpritesReprNet parameters (float32 init)."""
    dummy = jnp.zeros((2, 64, 64, 3))
    return (jax.jit(jnets.SpritesVAE(L=L).init)(jax.random.PRNGKey(0), dummy),
            jax.jit(jnets.SpritesReprNet(L=L_CHAR).init)(
                jax.random.PRNGKey(1), dummy))


@contextlib.contextmanager
def _x64(on: bool):
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _problem(flax_nets, m, dtype, seed=0, n_chars=B // FPC):
    """JAX params {"vae", "repr", "gp"} in `dtype`, and numpy frames and
    action ids of n_chars characters x 50 frames."""
    rng = np.random.RandomState(seed)
    vae_p, repr_p = (_cast(p, dtype) for p in flax_nets)
    gp = jgp.init_sprites_svgp(
        rng.randn(m, L_ACT + L_CHAR), rng.randn(N_ACTIONS, L_ACT),
        L_action=L_ACT, config=JConfig(jitter=JITTER, N_train=50 * B),
        dtype=dtype)
    frames = rng.rand(n_chars * FPC, 64, 64, 3)
    aids = rng.randint(0, N_ACTIONS, n_chars * FPC).astype(np.float64)
    return {"vae": vae_p, "repr": repr_p, "gp": gp}, frames, aids


def _port(params, torch_dtype):
    gp = params["gp"]
    port = sprites_train_params_from_jax(
        flatten_params(params),
        tgp.SVGPConfig(jitter=gp.config.jitter, N_train=gp.config.N_train),
        L_action=gp.L_action)
    return {"vae": port["vae"].to(torch_dtype),
            "repr": port["repr"].to(torch_dtype),
            "gp": port["gp"].to(torch_dtype)}


def _flat_port_names(flat: dict) -> dict:
    """Flat JAX parameters (or gradients) -> {"vae/<key>", "repr/<key>",
    "gp/<field>": array} in the port's layout."""
    conv = params_from_jax(flat)
    return {f"{part}/{k}": _np(v) for part, d in conv.items()
            for k, v in d.items()}


def _jax_forward(dtype):
    """One jitted function: value and gradients of the objective, with
    every output, under each impl of IMPLS (one compile for the three)."""
    vae = jnets.SpritesVAE(L=L, dtype=dtype)
    rep = jnets.SpritesReprNet(L=L_CHAR, dtype=dtype)

    def fwd(vae_p, repr_p, gp, frames, aids, key, impl):
        out = jmodels.forward_pass_svgpvae(
            vae, vae_p, gp, (frames, aids), key, beta=0.001,
            C_ma=jnp.asarray(GECO0[0], dtype),
            lagrange_mult=jnp.asarray(GECO0[1], dtype), alpha=0.99,
            kappa=KAPPA, clip_qs=True, geco=True, repr_apply=rep.apply,
            repr_params=repr_p, frames_per_char=FPC, gp_block_impl=impl)
        return out.elbo, out

    grad = jax.value_and_grad(fwd, argnums=(0, 1, 2), has_aux=True)
    return jax.jit(lambda *a: [grad(*a, impl) for impl in IMPLS])


def _assert_forward(got, want, grads_got, grads_want, tol_v, tol_g):
    for name in tmodels.SVGPVAEOutputs._fields:
        if name == "mean_vectors":  # no bias_analysis: JAX's unread 0
            assert got.mean_vectors is None
            assert np.asarray(want.mean_vectors).shape == ()
            continue
        w = np.asarray(getattr(want, name), np.float64)
        g = _np(getattr(got, name)).astype(np.float64)
        scale = max(np.abs(w).max(), 1.0)
        if name in SCALAR_TERMS:
            scale = max(scale, sum(abs(float(getattr(want, t)))
                                   for t in SCALAR_TERMS[name]))
        err = np.abs(g - w).max()
        assert err <= tol_v * scale, (name, err, scale)
    assert set(grads_got) == set(grads_want)
    for name, w in grads_want.items():
        g = grads_got[name]
        g = np.zeros_like(w) if g is None else _np(g)
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(g - w).max()
        assert err <= tol_g * scale, (name, err, scale)


@pytest.fixture(scope="module", params=["f64", "f32"])
def forward_case(request, flax_nets):
    """The JAX side of the forward-pass comparison at one precision: the
    inputs, the noise, and each impl's outputs and gradients."""
    f64 = request.param == "f64"
    m = 24 if f64 else 10  # f64: the rank-deficient fixture (m > 12)
    jdtype, tdtype = ((jnp.float64, torch.float64) if f64
                      else (jnp.float32, torch.float32))
    with _x64(f64):
        params, frames, aids = _problem(flax_nets, m, jdtype)
        key = jax.random.PRNGKey(3)
        outs = _jax_forward(jdtype)(
            params["vae"], params["repr"], params["gp"],
            jnp.asarray(frames, jdtype), jnp.asarray(aids, jdtype), key)
        eps = np.array(jax.random.normal(key, (B, L), jdtype))
        want = {impl: (out, _flat_port_names(flatten_params(
            {"vae": g[0], "repr": g[1], "gp": g[2]})))
            for impl, ((_, out), g) in zip(IMPLS, outs)}
        tparams = _port(params, tdtype)
    return dict(precision=request.param, dtype=tdtype, params=tparams,
                frames=frames, aids=aids, eps=eps, want=want)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_pass_matches_jax(forward_case, impl):
    c = forward_case
    tparams = copy.deepcopy(c["params"])  # gradients accumulate in place
    named = ttrain.trainable_tensors(tparams, lambda name: True)
    got = tmodels.forward_pass_svgpvae(
        tparams["vae"], tparams["gp"],
        (torch.tensor(c["frames"], dtype=c["dtype"]),
         torch.tensor(c["aids"], dtype=c["dtype"])),
        torch.from_numpy(c["eps"]), beta=0.001,
        C_ma=torch.tensor(GECO0[0], dtype=c["dtype"]),
        lagrange_mult=torch.tensor(GECO0[1], dtype=c["dtype"]), alpha=0.99,
        kappa=KAPPA, clip_qs=True, geco=True, gp_block_impl=impl,
        repr_net=tparams["repr"], frames_per_char=FPC)
    got.elbo.backward()
    tol_v, tol_g = TOL[c["precision"]]
    if c["precision"] == "f64" and impl.endswith("_pallas"):
        tol_v = tol_g = PALLAS_TOL64
    want, grads_want = c["want"][impl]
    _assert_forward(got, want, {k: t.grad for k, t in named.items()},
                    grads_want, tol_v, tol_g)


def test_a_hat_reaches_b1_symmetric(monkeypatch):
    """fused_rejitter_pallas hands B1 A_hat + jitter with its triangles
    averaged: the fp32 products K_mm Sigma^-1 K_mm leave them apart, and on
    a SPRITES step (cond ~1e5) the Gauss-Jordan kernel (the whole matrix)
    and the Cholesky twin (the lower triangle) then took logdets up to
    ~0.3 apart (ROADMAP.md section C)."""
    from svgpvae_tpu_torch.gp import fused
    rng = np.random.RandomState(2)
    gp = tgp.init_sprites_svgp(
        rng.normal(0, 1.5, (24, 7)), rng.normal(0, 1.5, (N_ACTIONS, L_ACT)),
        L_action=L_ACT, config=tgp.SVGPConfig(jitter=JITTER, N_train=5000))
    aux = torch.tensor(np.hstack([rng.randint(0, N_ACTIONS, (B, 1)),
                                  rng.rand(B, L_CHAR)]), dtype=torch.float32)
    y = torch.tensor(rng.randn(B, L), dtype=torch.float32)
    noise = torch.tensor(rng.rand(B, L) + 0.01, dtype=torch.float32)
    seen = []

    def recording(M):
        seen.append(M)
        return ci_twin(M)

    ci_twin = fused.chol_inverse
    monkeypatch.setattr(fused, "chol_inverse", recording)
    fused.gp_block_hensman(gp, aux, y, noise, inverse_impl="pallas",
                           kl_impl="rejitter")
    assert [tuple(M.shape) for M in seen] == [(L + 1, 24, 24), (L, 24, 24)]
    assert torch.equal(seen[1], seen[1].transpose(-1, -2))


# --- training and pretraining steps ------------------------------------------


PARAM_ATOL = 1e-4  # a tenth of one Adam step at lr 1e-3 (see the MNIST test)


def _jax_loss_fn(impl, alpha=0.99):
    """The JAX CLI's SVGPVAE_Hensman --GECO loss_fn."""
    vae, rep = jnets.SpritesVAE(L=L), jnets.SpritesReprNet(L=L_CHAR)

    def loss_fn(params, batch, key, geco, step):
        out = jmodels.forward_pass_svgpvae(
            vae, params["vae"], params["gp"], batch, key, beta=0.001,
            C_ma=geco.C_ma, lagrange_mult=geco.lagrange_mult,
            alpha=jtrain.geco_effective_alpha(step, alpha), kappa=KAPPA,
            clip_qs=True, geco=True, repr_apply=rep.apply,
            repr_params=params["repr"], frames_per_char=FPC,
            gp_block_impl=impl)
        scale = (jnp.abs(out.inside_elbo) + jnp.abs(out.ce_term)
                 + jnp.abs(out.elbo))
        return out.elbo, (jtrain.GECOState(C_ma=out.C_ma,
                                           lagrange_mult=out.lagrange_mult),
                          {"elbo": out.elbo, "scale": scale})
    return loss_fn


def _assert_params(got: dict, want: dict, atol=PARAM_ATOL):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(_np(got[k]), w, atol=atol, err_msg=k)


def test_train_steps_match_jax(flax_nets):
    """Two steps of the CUDA path's block (fused_rejitter_pallas; B1's
    twin on the CPU), every tensor trainable."""
    impl, lr = "fused_rejitter_pallas", 1e-3
    params, frames, aids = _problem(flax_nets, 10, jnp.float32, n_chars=4)
    batches = [(frames[lo:lo + B].astype(np.float32),
                aids[lo:lo + B].astype(np.float32)) for lo in (0, B)]
    tx = jtrain.make_optimizer(lr)
    state = jtrain.TrainState.create(params, tx, jax.random.PRNGKey(11))
    eps, key = [], state.key  # the noise make_train_step draws
    for _ in batches:
        key, sub = jax.random.split(key)
        eps.append(torch.from_numpy(np.array(jax.random.normal(sub, (B, L)))))
    step = jtrain.make_train_step(_jax_loss_fn(impl), tx, donate=False)

    tparams = _port(params, torch.float32)
    trainable = ttrain.trainable_tensors(tparams, lambda name: True)
    t_state = ttrain.TrainState(
        params=tparams, optimizer=ttrain.make_optimizer(trainable, lr),
        geco=ttrain.GECOState.init())
    args = tsprites.build_parser().parse_args(
        ["--GECO", "--clip_qs", "--L", str(L), "--gp_block_impl", impl])
    loss_fn = tsprites.make_loss_fn(args, tsprites.make_forward(
        args, lambda kind, shape: eps[t_state.step]))
    for batch in batches:
        state, m = step(state, tuple(jnp.asarray(a) for a in batch))
        tm = ttrain.train_step(t_state, tuple(map(torch.from_numpy, batch)),
                               loss_fn)
        # the objective is the small difference of the inside-ELBO and the
        # cross-entropy term: held to 1e-5 of their magnitudes
        assert abs(float(tm["loss"]) - float(m["loss"])) <= \
            1e-5 * float(m["scale"]), (float(tm["loss"]), float(m["loss"]))
    for got, want in ((t_state.geco.C_ma, state.geco.C_ma),
                      (t_state.geco.lagrange_mult, state.geco.lagrange_mult)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _assert_params(ttrain.named_tensors(tparams),
                   _flat_port_names(flatten_params(state.params)))


def _jax_pretrain_loss(rep, head):
    """The JAX CLI's pretrain_loss (svgpvae_tpu/cli/sprites.py:390)."""
    def pretrain_loss(p, batch, key, geco, step):
        frames, char_ids = batch
        emb = rep.apply(p["repr"], frames)
        logits = head.apply(p["head"], emb)
        labels = char_ids.astype(jnp.int32)
        loss = jnp.mean(
            -jax.nn.log_softmax(logits)[jnp.arange(len(labels)), labels])
        acc = jnp.mean(jnp.argmax(logits, 1) == labels)
        return loss, (geco, {"acc": acc})
    return pretrain_loss


def test_pretrain_steps_match_jax(flax_nets):
    n_chars, lr = 6, 0.01
    params, frames, _ = _problem(flax_nets, 10, jnp.float32, n_chars=4)
    rng = np.random.RandomState(4)
    batches = [(frames[lo:lo + B].astype(np.float32),
                rng.randint(0, n_chars, B).astype(np.float32))
               for lo in (0, B)]
    rep, head = (jnets.SpritesReprNet(L=L_CHAR),
                 jnets.ClassificationHead(num_classes=n_chars))
    pre = {"repr": params["repr"],
           "head": head.init(jax.random.PRNGKey(5), jnp.zeros((2, L_CHAR)))}
    tx = jtrain.make_optimizer(lr)
    state = jtrain.TrainState.create(pre, tx, jax.random.PRNGKey(6))
    step = jtrain.make_train_step(_jax_pretrain_loss(rep, head), tx,
                                  donate=False)

    port = sprites_train_params_from_jax(
        flatten_params(dict(params, head=pre["head"])),
        tgp.SVGPConfig(jitter=JITTER), L_action=L_ACT)
    t_pre = {"repr": port["repr"], "head": port["head"]}
    t_state = ttrain.TrainState(
        params=t_pre, geco=None, optimizer=ttrain.make_optimizer(
            ttrain.trainable_tensors(t_pre, lambda name: True), lr))
    for batch in batches:
        state, m = step(state, tuple(jnp.asarray(a) for a in batch))
        tm = ttrain.train_step(t_state, tuple(map(torch.from_numpy, batch)),
                               tsprites.pretrain_loss)
        np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["acc"]), float(m["acc"]),
                                   rtol=1e-6)
    want = flatten_params(state.params)
    conv = params_from_jax(dict(want, **{
        f"vae/{k}": v for k, v in flatten_params(params["vae"]).items()},
        **{f"gp/{k}": v for k, v in flatten_params(params["gp"]).items()}))
    want_port = {f"repr/{k}": _np(v) for k, v in conv["repr"].items()}
    kernel = want["head/params/Dense_0/kernel"]
    want_port["head/dense.weight"] = kernel.T
    want_port["head/dense.bias"] = want["head/params/Dense_0/bias"]
    # lr = 0.01: a tenth of one step is 1e-3
    _assert_params(ttrain.named_tensors(t_pre), want_port, atol=1e-3)


# --- the trainability mask ---------------------------------------------------


def _jax_trainable(args):
    """The JAX CLI's predicate (svgpvae_tpu/cli/sprites.py:458-469)."""
    def trainable(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.startswith("['repr']"):
            return args.repr_nn_pretrain != "yes_fixed"
        if "inducing_points" in name:
            return args.ip_joint
        if "gplvm_action" in name:
            return args.GPLVM_joint
        if ("l_action" in name or "sigma_action" in name
                or "l_character" in name or "sigma_character" in name):
            return args.GP_joint and args.K_SE
        return True
    return trainable


@pytest.mark.parametrize("pretrain", ["no", "yes_fixed", "yes_joint"])
def test_trainable_mask_matches_jax(flax_nets, pretrain):
    params, _, _ = _problem(flax_nets, 10, jnp.float32)
    tparams = _port(params, torch.float32)
    for flags in np.ndindex(2, 2, 2, 2):
        argv = ["--repr_nn_pretrain", pretrain] + [
            f for f, on in zip(("--ip_joint", "--GPLVM_joint", "--GP_joint",
                                "--K_SE"), flags) if on]
        args = tsprites.build_parser().parse_args(argv)
        mask = flatten_params(jtrain.trainable_mask(params,
                                                    _jax_trainable(args)))
        trainable = ttrain.trainable_tensors(
            tparams, tsprites.trainable_predicate(args))
        for name, t in ttrain.named_tensors(tparams).items():
            part, _, leaf = name.partition("/")
            want = {bool(v) for k, v in mask.items()
                    if k.startswith(part + "/")
                    and (part != "gp" or k == name)}
            assert want == {name in trainable} == {t.requires_grad}, \
                (argv, name)
