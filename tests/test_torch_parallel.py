"""The port's data parallelism (svgpvae_tpu_torch/parallel) against the
JAX package, on CPU ranks under gloo, in float64.

  * the refusals: parallel.resolve_data_parallel against the JAX
    package's on the same arguments (no ranks needed), and the drivers'
    refusals with the JAX drivers' messages;
  * the sharded fits: sharded_precompute_gp_params (MNIST with its GPLVM
    table, SPRITES linear x linear and SE) and sharded_posterior_params
    (MNIST) on 2 ranks against JAX's single-device
    gp.precompute_test_posterior_terms and gp.posterior_params;
  * one training step: forward_pass_svgpvae with GECO on stand-in linear
    nets (tests/parallel_cases.py), each rank on its half of the batch
    and of the draw, through train.train_step, against
    jax.value_and_grad of JAX's forward_pass_svgpvae on the whole batch:
    the loss, the GECO state and every gradient, for the Hensman and
    Titsias blocks (fused and two-pass) on the MNIST family and for the
    SPRITES family with 3 characters of 4 frames over 2 ranks, so that
    rank 0's share ends inside the second character.

The two ranks are spawned once for the file (a module fixture); the
tests read their results.  Tolerances: the fits 1e-10 of each output's
max |entry|, the step 1e-9 (the same math in float64 summed in other
orders, the GP solves amplifying round-off by their conditioning); the
loss, the small difference of the inside-ELBO and the cross-entropy
term, 1e-9 of |inside-ELBO| + |CE term| + |loss| (the port's 1-process
loss sits 5e-9 of |loss| from JAX's in the first case).  A term counted
once per rank too many would be off by a factor of 2.
"""

import contextlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from svgpvae_tpu import gp as jgp, models as jmodels
from svgpvae_tpu import parallel as jparallel
from svgpvae_tpu.gp.svgp import SVGPConfig as JConfig
from svgpvae_tpu_torch import parallel as tparallel
from svgpvae_tpu_torch.cli import mnist as tmnist

import parallel_cases as pc
from test_torch_sprites_train import quick_jit
from torch_threads import _torch_threads  # noqa: E402,F401

WORLD = 2
RTOL_FIT = 1e-10
RTOL_STEP = 1e-9
STEP_CASES = [("mnist_hensman", "reference"), ("mnist_hensman", "fused"),
              ("mnist_titsias", "reference"), ("mnist_titsias", "fused"),
              ("sprites_hensman", "fused_rejitter"),
              ("sprites_titsias", "fused")]
FIT_CASES = ["fit_mnist", "fit_sprites", "fit_sprites_se", "post_mnist"]


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _mnist_gp(rng, N_train, titsias=False, M=3, m=8, n_obj=6):
    return {"family": "mnist",
            "config": dict(jitter=1e-6, N_train=N_train, titsias=titsias),
            "gp": {"inducing_points": np.hstack([
                np.arange(m)[:, None] % n_obj, rng.rand(m, 1) * 2 * np.pi,
                rng.randn(m, M)]),
                "length_scale": np.asarray(0.9),
                "amplitude": np.asarray(1.2),
                "object_vectors": rng.randn(n_obj, M)}}


def _mnist_aux(rng, n, M=3, n_obj=6):
    return np.hstack([rng.randint(0, n_obj, (n, 1)).astype(float),
                      rng.rand(n, 1) * 2 * np.pi, rng.randn(n, M)])


def _sprites_gp(rng, N_train, titsias=False, se=False, L_a=2, L_c=3, m=6,
                n_act=4):
    return {"family": "sprites", "L_action": L_a, "se": se,
            "config": dict(jitter=1e-6, N_train=N_train, titsias=titsias),
            "gp": {"inducing_points": rng.randn(m, L_a + L_c),
                   "gplvm_action": rng.randn(n_act, L_a),
                   "l_action": np.asarray(1.1),
                   "sigma_action": np.asarray(0.7),
                   "l_character": np.asarray(0.9),
                   "sigma_character": np.asarray(0.8)}}


def _fit_problem(rng, family, se=False, test=False, N=40, L=3):
    if family == "mnist":
        d = _mnist_gp(rng, N)
        d["aux"] = _mnist_aux(rng, N)
    else:
        d = _sprites_gp(rng, N, se=se)
        d["aux"] = np.hstack([rng.randint(0, 4, (N, 1)).astype(float),
                              rng.randn(N, 3)])
    d["means"] = rng.randn(N, L)
    d["variances"] = np.clip(np.exp(rng.randn(N, L)), 1e-3, 10.0)
    if test:
        d["aux_test"] = _mnist_aux(rng, 7)
    return d


def _step_problem(rng, key, b=16, L=3, P=16):
    family, bound = key.split("_")
    if family == "mnist":
        d = _mnist_gp(rng, 100, titsias=bound == "titsias")
        d["aux"] = _mnist_aux(rng, b)
    else:
        d = _sprites_gp(rng, 60, titsias=bound == "titsias")
        b, d["fpc"] = 12, 4  # 3 characters; rank 0's 6 frames end in #2
        d["aux"] = rng.randint(0, 4, b).astype(float)
        d["W_repr"] = 0.3 * rng.randn(P, 3)
    d["images"] = rng.rand(b, 4, 4, 1)
    d["W_mu"], d["W_v"] = 0.5 * rng.randn(P, L), 0.3 * rng.randn(P, L)
    d["W_d"] = 0.3 * rng.randn(L, P)
    d["C_ma"], d["lagrange"] = 0.3, 1.2
    with x64():
        d["eps"] = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (b, L),
                                                dtype=jnp.float64))
    return d


@pytest.fixture(scope="module")
def problems():
    rng = np.random.RandomState(0)
    out = {k: _step_problem(rng, k) for k in dict(STEP_CASES)}
    out["fit_mnist"] = _fit_problem(rng, "mnist")
    out["fit_sprites"] = _fit_problem(rng, "sprites")
    out["fit_sprites_se"] = _fit_problem(rng, "sprites", se=True)
    out["post_mnist"] = _fit_problem(rng, "mnist", test=True)
    return out


@pytest.fixture(scope="module")
def ranks(problems, tmp_path_factory):
    cases = {f"{k}-{impl}": ("step_case", dict(key=k, impl=impl))
             for k, impl in STEP_CASES}
    cases.update({k: ("fit_case", dict(key=k)) for k in FIT_CASES})
    return pc.run_ranks(WORLD, cases, problems,
                        tmp_path_factory.mktemp("ranks"))


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-300)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, (what, err, scale)


def _jax_gp(d):
    cfg = JConfig(**d["config"])
    t = {k: jnp.asarray(v) for k, v in d["gp"].items()}
    if d["family"] == "mnist":
        return jgp.MnistSVGP(config=cfg, **t)
    return jgp.SpritesSVGP(config=cfg, **t, L_action=d["L_action"],
                           use_se_kernel=d["se"])


class _JaxLinVAE:
    """parallel_cases.LinVAE for JAX's forward (vae.apply(params, x,
    method=vae.encode))."""

    def __init__(self, shape):
        self.shape = shape

    def apply(self, params, x, method):
        return method(params, x)

    def encode(self, p, x):
        flat = x.reshape(len(x), -1)
        return flat @ p["W_mu"], jax.nn.softplus(flat @ p["W_v"]) + 0.05

    def decode(self, p, z):
        return (z @ p["W_d"]).reshape(len(z), *self.shape)


def test_resolve_data_parallel_matches_jax():
    avail = len(jax.devices())
    for n, b in [(0, 256), (-1, 8 * 32), (4, 256), (8, 500),
                 (99, 99 * 4), (3, 10)]:
        try:
            mesh = jparallel.resolve_data_parallel(n, b)
            want = 0 if mesh is None else mesh.devices.size
        except SystemExit as e:
            want = str(e)
        try:
            got = tparallel.resolve_data_parallel(n, b, "cpu", visible=avail)
        except SystemExit as e:
            got = str(e)
        assert got == want, (n, b)


@pytest.mark.parametrize("argv, message", [
    (["--elbo", "GPVAE_Casale", "--PCA"],
     "--data_parallel: not ported for --elbo GPVAE_Casale, which the JAX "
     "driver runs on one device whatever the flag says"),
    (["--elbo", "SVGPVAE_Hensman", "--bias_analysis"],
     "--data_parallel does not support --bias_analysis (per-step host "
     "loop)"),
    (["--elbo", "SVGPVAE_Hensman", "--batch_size", "101"],
     "--data_parallel 2: batch_size 101 does not tile the data axis; pick "
     "a batch size divisible by the device count"),
])
def test_driver_refusals(argv, message):
    with pytest.raises(SystemExit) as e:
        tmnist.main(argv + ["--data_parallel", "2", "--device", "cpu"],
                    splits={"train": {"images": np.zeros((4, 28, 28, 1))}})
    assert str(e.value) == message


def test_more_ranks_than_devices_refused():
    n = tparallel.mesh.visible_devices("cpu") + 1
    with pytest.raises(SystemExit, match=f"--data_parallel {n}: only "):
        tmnist.main(["--data_parallel", str(n), "--device", "cpu",
                     "--batch_size", str(n)], splits={})


@pytest.mark.parametrize("key", FIT_CASES)
def test_sharded_fit_matches_jax(ranks, problems, key):
    d = problems[key]
    with x64():
        gp = _jax_gp(d)
        arrays = [jnp.asarray(d[k]) for k in ("means", "variances", "aux")]
        if "aux_test" in d:
            want = quick_jit(jgp.posterior_params)(
                gp, jnp.asarray(d["aux_test"]), arrays[2], arrays[0],
                arrays[1])
        else:
            want = quick_jit(jgp.precompute_test_posterior_terms)(gp,
                                                                  *arrays)
        want = [np.asarray(w) for w in want]
    got = ranks[key]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, RTOL_FIT, (key, i))


@pytest.mark.parametrize("key, impl", STEP_CASES)
def test_training_step_matches_jax(ranks, problems, key, impl):
    d = problems[key]
    got = ranks[f"{key}-{impl}"]
    sprites = d["family"] == "sprites"
    with x64():
        vae = _JaxLinVAE(d["images"].shape[1:])
        images = jnp.asarray(d["images"])
        aux = jnp.asarray(d["aux"])

        def loss(vp, gp, rp):
            out = jmodels.forward_pass_svgpvae(
                vae, vp, gp, (images, aux), jax.random.PRNGKey(3), beta=1.0,
                C_ma=jnp.asarray(d["C_ma"]),
                lagrange_mult=jnp.asarray(d["lagrange"]), alpha=pc.ALPHA,
                kappa=pc.KAPPA, clip_qs=True, geco=True,
                repr_apply=((lambda p, x: x.reshape(len(x), -1) @ p)
                            if sprites else None),
                repr_params=rp, frames_per_char=d.get("fpc", 0),
                gp_block_impl=impl)
            return out.elbo, (out.C_ma, out.lagrange_mult)

        vp = {k: jnp.asarray(d[k]) for k in ("W_mu", "W_v", "W_d")}
        rp = jnp.asarray(d["W_repr"]) if sprites else None
        (value, (C_ma, lam)), grads = quick_jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(vp, _jax_gp(d), rp)
        want = {f"vae/{k}": np.asarray(v) for k, v in grads[0].items()}
        want.update({f"gp/{k}": np.asarray(getattr(grads[1], k))
                     for k in d["gp"]})
        if sprites:
            want["repr/W"] = np.asarray(grads[2])
    assert abs(got["loss"] - float(value)) <= RTOL_STEP * (
        got["terms"] + abs(float(value))), ("loss", got["loss"], value)
    _close(got["C_ma"], C_ma, RTOL_STEP, "C_ma")
    _close(got["lagrange"], lam, RTOL_STEP, "lagrange")
    assert set(got["grads"]) == set(want)
    for k, w in want.items():
        _close(got["grads"][k], w, RTOL_STEP, k)
