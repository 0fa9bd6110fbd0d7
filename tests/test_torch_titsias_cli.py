"""The port's drivers against the JAX package's on the Titsias bound and the
SPRITES record config (the record config's two driver runs are in
tests/test_torch_titsias_cli_record.py and
tests/test_torch_titsias_cli_record_titsias.py, a file each, so that the
suite's workers take them in parallel).

  * cli.mnist.main --elbo SVGPVAE_Titsias (the plain objective, the CUDA
    cell's fused_pallas block, B1's twin on the CPU), with the exact
    entropy CE and with --titsias_reference_ce, on a tiny in-memory
    36-digit set: two steps (a full batch and the tail) and one eval
    pass against the same steps and passes made with the JAX functions,
    from the same weights and noise;
  * cli.sprites.main at the SPRITES record config's flags (--ip_joint
    --GPLVM_joint --PCA --object_kernel_normalize --clip_grad) against
    the JAX CLI run on the same corpus, weights and noise: Hensman + GECO
    through fused_rejitter_pallas (the Hensman CUDA cell) and Titsias
    through fused (the Titsias CUDA cell), one of them with --lr_decay
    0.1.  Gradients go through the cosine-normalized kernel and the
    value clip.  The JAX CLI's PCA initializers (sklearn) are given to
    the port with --params; sklearn's default PCA solver is randomized,
    so the JAX side runs its exact solver, as
    tests/test_torch_sprites_train.py::test_sprites_pca_init_matches_jax.

Tolerances as tests/test_torch_mnist_train.py and
tests/test_torch_sprites_train.py: a loss within 1e-5 of the magnitudes
it is computed from; the MSEs of the eval pass rtol 1e-4; the MNIST first
step's gradients within 4x the port's own fp32-vs-float64 gap of that
step (the encoder's gradient through the collapsed bound carries ~1e-3
of fp32 round-off, measured), floored at 2e-4 of each tensor's max
|entry|; parameters after the steps atol 1e-4 (a tenth of one Adam
step) on every entry whose first-step gradient exceeds what the two
packages' fp32 gradients may differ by (MNIST: that limit; SPRITES: 1e-3
of its tensor's max, the SPRITES gradient tolerance), `_assert_params`.
The JAX programs that are only references (the first step's gradients,
the eval passes, the float64 blocks) compile at XLA's lowest
optimisation level (tests/test_torch_sprites_train.py's quick_jit), which
moves their results by round-off; the JAX training steps compile as the
JAX driver compiles them.

The record config's PCA initializers give every inducing point the same
character vector (the KDE resample is seeded alike for each action), so
the cosine-normalized K_mm has rank <= L_action = 8 at m = 72, and the
Hensman case's inducing-point gradient is fp32 round-off: on this corpus
the port's fp32 step-0 gradient of gp/inducing_points is 6.7x its max
|entry| away from the float64 one, with 306 of 1728 signs flipped (the
same step redone at both precisions; the Titsias case: 8.6e-4, 55 small
entries flipped).  No fp32 comparison can hold those entries, so the
Hensman case leaves gp/inducing_points out of the parameter check; the
float64 test below holds both record-config blocks' gradients, the
inducing points' included, to JAX.
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
from svgpvae_tpu.gp.svgp import SVGPConfig as JConfig
from svgpvae_tpu_torch import data as tdata
from svgpvae_tpu_torch import train as ttrain
from svgpvae_tpu_torch.cli import mnist as tmnist
from svgpvae_tpu_torch.utils.convert import mnist_params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from export_jax_params import flatten_params  # noqa: E402
from test_torch_sprites_train import quick_jit  # noqa: E402
from torch_threads import _torch_threads  # noqa: E402,F401

RTOL_LOSS = 1e-5
MNIST_GRAD_RTOL = 2e-4
# two fp32 implementations, each off float64 by about the port's own
# fp32-vs-float64 gap, differ by up to about twice it
F32_GAP_FACTOR = 4.0
SPRITES_GRAD_RTOL = 1e-3
PARAM_ATOL = 1e-4
MSE_RTOL = 1e-4
BETA = 0.001


def _np(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") \
        else np.asarray(x)


def _assert_params(got: dict, want: dict, held: dict, skip=()):
    """Parameters after the steps within PARAM_ATOL on the entries `held`
    marks (a boolean mask per tensor; a tensor without one is held
    whole): those whose first-step gradient is larger than the two
    packages' fp32 gradients can differ by.  Adam moves an entry by ~lr
    at its first step whatever the size of its gradient, so an entry
    whose gradient is within that difference has an undetermined
    direction, and may land up to 2 lr apart after two steps.  `skip`:
    tensors whose fp32 gradient is not determined at all (see its use)."""
    assert set(got) == set(want)
    bad = []
    for k, w in want.items():
        if k in skip:
            continue
        mask = held.get(k, np.ones(np.shape(w), bool))
        err = np.abs(_np(got[k]) - _np(w))[mask]
        if err.size and not err.max() <= PARAM_ATOL:
            bad.append((k, float(err.max()), int(mask.sum())))
    assert not bad, bad


def _port_names(conv: dict) -> dict:
    return {f"{part}/{k}": v for part, d in conv.items()
            for k, v in d.items()}


# --- MNIST -------------------------------------------------------------------


MNIST_L, MNIST_BS = 6, 128
MNIST_ARGV = ["--elbo", "SVGPVAE_Titsias", "--clip_qs", "--PCA",
              "--ip_joint", "--GP_joint", "--ov_joint", "--dataset", "36",
              "--opt_regime", "joint-1", "--eval_every", "1", "--L",
              str(MNIST_L), "--batch_size", str(MNIST_BS), "--seed", "0",
              "--gp_block_impl", "fused_pallas"]  # the CUDA cell's block


@pytest.fixture(scope="module")
def tiny_splits():
    base = tdata.synthetic_digit_base_images("36", per_digit=10, seed=0)
    return tdata.generate_rotated_mnist(base, None, digits="36", seed=0)


def _mnist_jax_eps(seed):
    """The JAX MNIST driver's draws: step t the subkey of the t-th split
    of the state key, every eval batch PRNGKey(7)."""
    key = [jax.random.split(jax.random.PRNGKey(seed))[0]]

    def eps_fn(kind, shape):
        import torch
        if kind == "train":
            key[0], sub = jax.random.split(key[0])
        else:
            sub = jax.random.PRNGKey(7)
        return torch.from_numpy(np.array(jax.random.normal(sub, shape)))
    return eps_fn


def _mnist_step_f64(cap, argv, config) -> dict:
    """The captured MNIST step's gradients redone by the port in
    float64 (same weights, batch and noise)."""
    import torch
    from svgpvae_tpu_torch import gp as tgp
    from svgpvae_tpu_torch.nn import MnistVAE
    f64 = torch.float64
    args = tmnist.build_parser().parse_args(argv)
    vae = MnistVAE(L=args.L).to(f64)
    vae.load_state_dict({k: v.to(f64) for k, v in cap["vae"].items()})
    gp = tgp.MnistSVGP(config=config,
                       **{k: v.to(f64) for k, v in cap["gp"].items()})
    params = {"vae": vae, "gp": gp}
    trainable = ttrain.trainable_tensors(params, lambda name: True)
    eps = cap["eps"].to(f64)
    loss, _ = tmnist.make_loss_fn(args, tmnist.make_forward(
        args, lambda kind, shape: eps))(
        params, tuple(x.to(f64) for x in cap["batch"]),
        ttrain.GECOState(C_ma=cap["geco"].C_ma.to(f64),
                         lagrange_mult=cap["geco"].lagrange_mult.to(f64)),
        cap["step"])
    grads = torch.autograd.grad(loss, list(trainable.values()))
    return {k: _np(g) for k, g in zip(trainable, grads)}


@pytest.mark.parametrize("ce", ["entropy", "reference"])
def test_mnist_main_matches_jax(tmp_path, tiny_splits, ce):
    seed = 0
    reference_ce = ce == "reference"
    tr = tiny_splits["train"]
    vae = jnets.MnistVAE(L=MNIST_L)
    key, init_key = jax.random.split(jax.random.PRNGKey(seed))
    ip = jdata.generate_init_inducing_points(tr, n=2, use_pca=True, M=8,
                                             seed=seed)
    N_train = len(tr["images"])
    params = {"vae": vae.init(init_key, jnp.zeros((2, 28, 28, 1))),
              "gp": jgp.init_mnist_svgp(
                  ip, tiny_splits["pca_ov_init"], config=JConfig(
                      titsias=True, jitter=1e-6, N_train=N_train))}
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **flatten_params(params))

    argv = MNIST_ARGV + ["--titsias_reference_ce"] * reference_ce
    got = tmnist.main(argv + ["--device", "cpu", "--params", npz],
                      splits=tiny_splits, eps_fn=_mnist_jax_eps(seed),
                      capture_step=0)

    def forward(params, batch, key):
        return jmodels.forward_pass_svgpvae(
            vae, params["vae"], params["gp"], batch, key, beta=BETA,
            C_ma=jnp.asarray(0.0), lagrange_mult=jnp.asarray(1.0),
            alpha=0.99, kappa=float(np.sqrt(0.02)), clip_qs=True,
            geco=False, gp_block_impl="fused_pallas",
            titsias_reference_ce=reference_ce)

    def loss_fn(params, batch, key, geco, step):
        out = forward(params, batch, key)
        scale = (jnp.abs(out.recon_loss) + BETA / MNIST_L
                 * (jnp.abs(out.inside_elbo) + jnp.abs(out.ce_term))
                 + jnp.abs(out.elbo))
        return -out.elbo, (geco, {"scale": scale})

    tx = jtrain.make_optimizer(1e-3)
    state = jtrain.TrainState.create(params, tx, key)
    step = jtrain.make_train_step(loss_fn, tx, donate=False)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    im, aux = f32(tr["images"]), f32(tr["aux_data"])
    batches = [(im[:MNIST_BS], aux[:MNIST_BS]),
               (im[MNIST_BS:], aux[MNIST_BS:])]
    assert len(got["metrics"]) == 2 and N_train - MNIST_BS == 74
    # the first step's gradients, at the same weights, batch and noise,
    # against the port's own float64 redo of the step
    grads0 = quick_jit(jax.grad(lambda p: loss_fn(
        p, batches[0], jax.random.split(key)[1], None, 0)[0]))(params)
    grads0 = _port_names(mnist_params_from_jax(flatten_params(grads0)))
    cap = got["captured"]
    g32 = {k: _np(g).astype(np.float64) for k, g in cap["grads"].items()}
    g64 = _mnist_step_f64(cap, argv, got["state"].params["gp"].config)
    assert set(g32) == set(grads0) == set(g64)
    held = {}
    for k, w in grads0.items():
        scale = np.abs(g64[k]).max()
        gap = np.abs(g32[k] - g64[k]).max()
        limit = max(F32_GAP_FACTOR * gap, MNIST_GRAD_RTOL * scale)
        err = np.abs(g32[k] - _np(w)).max()
        assert err <= limit, (k, err, gap, scale)
        # entries whose direction both fp32 gradients determine
        held[k] = np.abs(g64[k]) >= limit
    for i, batch in enumerate(batches):
        state, m = step(state, batch)
        assert abs(got["metrics"][i]["loss"] - float(m["loss"])) <= \
            RTOL_LOSS * float(m["scale"]), (got["metrics"][i]["loss"],
                                            float(m["loss"]))
    _assert_params(ttrain.named_tensors(got["state"].params),
                   _port_names(mnist_params_from_jax(
                       flatten_params(state.params))), held)

    # one eval pass: eval/test recon MSE and cgen MSE, eval key 7
    ekey = jax.random.PRNGKey(7)
    recon = quick_jit(lambda p, b: forward(p, b, ekey).recon_loss)
    cgen_loss = quick_jit(lambda p, b, mu, var: jmodels.predict_cgen_mnist(
        vae, p["vae"], p["gp"], b, mu, var, aux, ekey)[1])

    def recon_sum(split):
        x, a = f32(split["images"]), f32(split["aux_data"])
        return sum(float(recon(state.params, (x[lo:lo + MNIST_BS],
                                              a[lo:lo + MNIST_BS])))
                   for lo in range(0, len(x), MNIST_BS))

    te = tiny_splits["test"]
    mu, var = jmodels.batching_encode_svgpvae(vae, state.params["vae"], im)
    x, a = f32(te["images"]), f32(te["aux_data"])
    cgen = sum(float(cgen_loss(state.params, (x[lo:lo + MNIST_BS],
                                              a[lo:lo + MNIST_BS]), mu, var))
               for lo in range(0, len(x), MNIST_BS))
    ev = got["evals"][0]
    np.testing.assert_allclose(ev["eval_mse"],
                               recon_sum(tiny_splits["eval"])
                               / len(tiny_splits["eval"]["images"]),
                               rtol=MSE_RTOL)
    np.testing.assert_allclose(ev["test_mse"], recon_sum(te) / len(x),
                               rtol=MSE_RTOL)
    np.testing.assert_allclose(ev["cgen_mse"], cgen / len(x), rtol=MSE_RTOL)
    # CPU tensors: the twins ran and no kernel launched
    assert all(n == 0 for s in got["step_launches"] for n in s.values())


# --- SPRITES: the record config's GP blocks at float64 ---------------------
# (the record config's driver runs: tests/test_torch_titsias_cli_record*.py)


N_ACTIONS = 72


@pytest.mark.parametrize("bound", ["hensman-rejitter-pallas", "titsias-chol"])
def test_record_config_blocks_match_jax_f64(bound):
    """The GP blocks of the two record-config cases above at float64, on
    the structure the PCA initializers give (every inducing point's
    character vector the same, each action's vector its GPLVM row; the
    cosine-normalized product-linear kernel, K_mm of rank <= 8 at
    m = 72, PD through the jitter 0.01): every output, and the gradients
    of a weighted sum of them with respect to every GP tensor (the
    inducing points included), y and the noise, within 1e-6 of scale
    (RANK_DEFICIENT_RTOL64 of tests/test_torch_titsias.py)."""
    import torch
    from svgpvae_tpu_torch import gp as tgp
    rtol = 1e-6
    rng = np.random.RandomState(7)
    La, Lc, n, L = 8, 16, 60, 4
    gplvm = rng.normal(0, 1.5, (N_ACTIONS, La))
    ip = np.hstack([gplvm, np.tile(rng.normal(0, 1.5, Lc), (N_ACTIONS, 1))])
    aux = np.hstack([rng.randint(0, N_ACTIONS, (n, 1)),
                     rng.normal(0, 1.0, (n, Lc))])
    y, noise = rng.randn(n, L), np.clip(np.exp(rng.randn(n, L)), 1e-3, 10.)
    titsias = bound.startswith("titsias")
    cfg = dict(titsias=titsias, jitter=0.01, N_train=50 * n,
               K_obj_normalize=True)
    kw = (dict(inverse_impl="chol") if titsias
          else dict(inverse_impl="pallas", kl_impl="rejitter"))

    def block(pkg):
        return pkg.gp_block_titsias if titsias else pkg.gp_block_hensman

    jax.config.update("jax_enable_x64", True)
    try:
        j_gp = jgp.init_sprites_svgp(ip, gplvm, L_action=La,
                                     config=JConfig(**cfg),
                                     dtype=jnp.float64)
        j_outs = quick_jit(lambda gp, y_, noise_: block(jgp)(
            gp, aux, y_, noise_, **kw))(j_gp, y, noise)
        w = [rng.randn(*np.shape(o)) for o in j_outs]

        def j_loss(gp, y_, noise_):
            return sum(jnp.sum(o * wi) for o, wi in
                       zip(block(jgp)(gp, aux, y_, noise_, **kw), w))

        j_val, j_grads = quick_jit(jax.value_and_grad(
            j_loss, argnums=(0, 1, 2)))(j_gp, jnp.asarray(y),
                                        jnp.asarray(noise))
    finally:
        jax.config.update("jax_enable_x64", False)

    def t(a):
        return torch.tensor(np.asarray(a, np.float64))

    def close(got, want):
        want = np.asarray(want, np.float64)
        np.testing.assert_allclose(
            _np(got), want, rtol=rtol,
            atol=rtol * max(np.abs(want).max(), 1e-300))

    t_gp = tgp.init_sprites_svgp(ip, gplvm, L_action=La,
                                 config=tgp.SVGPConfig(**cfg),
                                 dtype=torch.float64)
    leaves = list(t_gp.named_tensors().values())
    for leaf in leaves:
        leaf.requires_grad_(True)
    y_t, noise_t = t(y).requires_grad_(), t(noise).requires_grad_()
    outs = block(tgp)(t_gp, t(aux), y_t, noise_t, **kw)
    for o, jo in zip(outs, j_outs):
        close(o, jo)
    loss = sum(torch.sum(o * t(wi)) for o, wi in zip(outs, w))
    close(loss, j_val)
    grads = torch.autograd.grad(loss, leaves + [y_t, noise_t],
                                allow_unused=True)
    for name, g in zip(t_gp.named_tensors(), grads):
        want = np.asarray(getattr(j_grads[0], name))
        close(torch.zeros(want.shape, dtype=torch.float64) if g is None
              else g, want)
    close(grads[-2], j_grads[1])
    close(grads[-1], j_grads[2])
