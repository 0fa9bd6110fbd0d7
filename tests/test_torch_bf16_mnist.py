"""The port's rotated-MNIST paths under --bf16 against the JAX package's
with its nets at dtype=jnp.bfloat16, on the same fp32 weights
(utils.convert), inputs (made from a seed with numpy) and noise:

  * MnistVAE and MnistCVAE at a bf16 compute dtype (encode and decode)
    against flax's;
  * forward_pass_svgpvae (Hensman + GECO, the CUDA path's fused_pallas
    block: B1's and B2's twins on the CPU) with JAX's fp32 draw, and
    forward_pass_vae (VAE and CVAE) with JAX's bf16 draw; every output's
    dtype is JAX's, and every tensor that reaches B2 (`gp_stats`) and B1
    (`chol_inverse`) is fp32;
  * one training step of the Hensman slice: the gradients, each leaf and
    all together, and the parameters after the Adam step; the parameters
    and Adam's moments stay fp32;
  * the trainer's entry point: `main` under --bf16 (SVGPVAE, VAE and
    CVAE) on the CPU, --x64 --bf16 (JAX's warning, then float64), and a
    --bf16 run dir served with fp32 nets.

Tolerance of the nets and forward passes (tests/bf16_hold.py): each
tensor within HALF of JAX's own bf16-vs-fp32 distance on the same input
(root mean square over the output), each scalar within half a bf16 ulp
of its magnitude; the fp32 reference of the VAE passes takes the bf16
run's draw, so the distance is that of the arithmetic alone.

The training step is held to JAX's bf16 gradients with each Dense and
Conv bias's gradient summed in fp32 (bf16_hold.grad_bias_summed_in_fp32:
XLA's CPU backend sums a bias's b x H x W cotangent in bf16, which put
JAX's bias gradients as far from torch's as from fp32), each leaf no
further from them than JAX's own bf16 gradients are from its fp32 ones
(measured: worst leaf dec_in.bias at 0.65 of that, every other leaf at
most 0.47, four of the eight biases equal), and all leaves together
within HALF of that distance (a port computing in fp32 sits at the whole
of it).  The parameters after the step are JAX's optimizer applied to the
port's gradients, to fp32 round-off (STEP_RTOL, STEP_ATOL).

Every JAX program here is compiled with XLA's excess precision off
(bf16_hold.flax_rounding), so that every op rounds its result to its
dtype, as flax's dtype= declares: under XLA's CPU default the jitted
forward's qnet_var, the exp of a bf16 log-variance cast to fp32, sat half
a bf16 ulp from flax's rounding (3.9e-3 at a scale of 1.8, against JAX's
bf16-vs-fp32 distance of 4.5e-3, maxima over the output).  Rounded as
flax declares, the port sat within fp32 round-off of JAX on every output
of the forward pass.
"""

import functools
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from svgpvae_tpu import gp as jgp, models as jmodels, nn as jnets
from svgpvae_tpu import train as jtrain
from svgpvae_tpu.gp.svgp import SVGPConfig as JConfig
from svgpvae_tpu_torch import data as tdata, gp as tgp, models as tmodels
from svgpvae_tpu_torch import train as ttrain
from svgpvae_tpu_torch.cli import mnist as tmnist, serve as tserve
from svgpvae_tpu_torch.nn import MnistCVAE, MnistVAE
from svgpvae_tpu_torch.utils.convert import (cvae_params_from_jax,
                                             mnist_params_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from bf16_hold import (HALF, flax_rounding,  # noqa: E402
                       grad_bias_summed_in_fp32, hold_to_jax_bf16)
from bf16_hold import kernel_inputs  # noqa: E402,F401
from export_jax_params import flatten_params  # noqa: E402
from torch_threads import _torch_threads  # noqa: E402,F401

BF16 = jnp.bfloat16
L, M, m, B = 4, 4, 8, 32
KAPPA = float(np.sqrt(0.02))
# The parameters after the Adam step against JAX's optimizer applied to
# the port's gradients: two fp32 ulps of the parameter, and 1e-5 of the
# step (lr = 1e-3), since optax takes Adam's bias correction 1 - 0.999 in
# fp32 (1.3e-5 off) where torch takes it in float64, which makes JAX's
# first step 6.4e-6 of lr shorter.
STEP_RTOL, STEP_ATOL = 2.0 ** -22, 1e-5 * 1e-3


def _mnist_net(cvae: bool):
    """(flax module class, fp32 params from flax's init, the port's net
    at a bf16 compute dtype on the same weights)."""
    net = jnets.MnistCVAE if cvae else jnets.MnistVAE
    zeros = (jnp.zeros((2, 28, 28, 3)), jnp.zeros(2)) if cvae else \
        (jnp.zeros((2, 28, 28, 1)),)
    p = net(L=L).init(jax.random.PRNGKey(4), *zeros)
    flat = flatten_params({"vae": p})
    t_net = (MnistCVAE if cvae else MnistVAE)(L=L, dtype=torch.bfloat16)
    t_net.load_state_dict((cvae_params_from_jax(flat) if cvae
                           else mnist_params_from_jax(flat))["vae"])
    return net, p, t_net


@pytest.mark.parametrize("cvae", [False, True], ids=["vae", "cvae"])
def test_mnist_nets_match_flax_bf16(cvae):
    rng = np.random.RandomState(0)
    x = rng.rand(B, 28, 28, 3 if cvae else 1).astype(np.float32)
    ang = rng.rand(B).astype(np.float32) * 2 * np.pi
    z = rng.randn(B, L).astype(np.float32)
    net, p, t_net = _mnist_net(cvae)
    for method, args in (("encode", (x, ang) if cvae else (x,)),
                         ("decode", (z, ang) if cvae else (z,))):
        with torch.no_grad():
            got = getattr(t_net, method)(*map(torch.from_numpy, args))
        want = [flax_rounding(functools.partial(
            net(L=L, dtype=dt).apply, method=method))(p, *args)
            for dt in (BF16, jnp.float32)]
        got, w16, w32 = ((t,) if not isinstance(t, tuple) else t
                         for t in (got, *want))
        for i, (g, a, b) in enumerate(zip(got, w16, w32)):
            hold_to_jax_bf16(g, a, b, f"{method}[{i}]")


def _problem(seed=0):
    """Weights (flax's init), the MNIST GP and one batch."""
    rng = np.random.RandomState(seed)
    ip = np.hstack([np.arange(m)[:, None], rng.rand(m, 1) * 2 * np.pi,
                    rng.randn(m, M)])
    table = rng.randn(20, M)
    aux = np.hstack([rng.randint(0, 20, (B, 1)).astype(float),
                     rng.rand(B, 1) * 2 * np.pi, rng.randn(B, M)])
    batch = (rng.rand(B, 28, 28, 1).astype(np.float32),
             aux.astype(np.float32))
    params = {"vae": jnets.MnistVAE(L=L).init(jax.random.PRNGKey(seed),
                                              jnp.zeros((2, 28, 28, 1))),
              "gp": jgp.init_mnist_svgp(ip, table, config=JConfig(
                  jitter=1e-6, N_train=10 * B))}
    return params, batch


def _port_params(params, dtype=torch.bfloat16):
    port = mnist_params_from_jax(flatten_params(params))
    vae = MnistVAE(L=L, dtype=dtype)
    vae.load_state_dict(port["vae"])
    gp = tgp.MnistSVGP(config=tgp.SVGPConfig(jitter=1e-6, N_train=10 * B),
                       **port["gp"])
    return {"vae": vae, "gp": gp}


def _j_forward(vae, params, batch, key=None):
    return jmodels.forward_pass_svgpvae(
        vae, params["vae"], params["gp"], batch, key, beta=0.001,
        C_ma=jnp.float32(0.0), lagrange_mult=jnp.float32(1.0), alpha=0.0,
        kappa=KAPPA, clip_qs=True, geco=True, gp_block_impl="fused_pallas")


def _t_forward(params, batch, eps):
    return tmodels.forward_pass_svgpvae(
        params["vae"], params["gp"], batch, eps, beta=0.001,
        C_ma=torch.tensor(0.0), lagrange_mult=torch.tensor(1.0), alpha=0.0,
        kappa=KAPPA, clip_qs=True, geco=True, gp_block_impl="fused_pallas")


def test_forward_pass_svgpvae_bf16_matches_jax(kernel_inputs):
    params, batch = _problem()
    key = jax.random.PRNGKey(5)
    want16, want32 = (flax_rounding(functools.partial(
        _j_forward, jnets.MnistVAE(L=L, dtype=dt), key=key))(params, batch)
        for dt in (BF16, jnp.float32))
    eps = torch.from_numpy(np.array(jax.random.normal(key, (B, L))))
    with torch.no_grad():
        got = _t_forward(_port_params(params),
                         tuple(map(torch.from_numpy, batch)), eps)
    for name in ("elbo", "recon_loss", "kl_term", "inside_elbo", "ce_term",
                 "p_m", "p_v", "qnet_mu", "qnet_var", "recon_images",
                 "latent_samples", "C_ma", "lagrange_mult"):
        hold_to_jax_bf16(getattr(got, name), getattr(want16, name),
                         getattr(want32, name), name)
    assert got.recon_images.dtype == torch.bfloat16
    names = {n for n, _ in kernel_inputs}
    assert {"gp_stats", "chol_inverse"} <= names
    assert {d for _, d in kernel_inputs} == {torch.float32}


def _vae_case(cvae):
    net, p, t_net = _mnist_net(cvae)
    rng = np.random.RandomState(2)
    aux = np.hstack([rng.randint(0, 5, (B, 1)).astype(float),
                     rng.rand(B, 1) * 2 * np.pi, rng.randn(B, M)])
    batch = (rng.rand(B, 28, 28, 1).astype(np.float32),
             aux.astype(np.float32))
    return net, p, t_net, batch


@pytest.mark.parametrize("cvae", [False, True], ids=["vae", "cvae"])
def test_forward_pass_vae_bf16_matches_jax(cvae, monkeypatch):
    """JAX draws the VAE's noise in the encoder's dtype, bf16; the fp32
    reference takes that same draw."""
    net, p, t_net, batch = _vae_case(cvae)
    key = jax.random.PRNGKey(6)
    eps16 = jax.random.normal(key, (B, L), BF16)

    def run(dtype):
        return flax_rounding(lambda p, b: jmodels.forward_pass_vae(
            net(L=L, dtype=dtype), p, b, key, clip_qs=True, cvae=cvae))(
                p, batch)
    want16 = run(BF16)
    monkeypatch.setattr(jax.random, "normal",
                        lambda k, shape, dtype: eps16.astype(dtype))
    want32 = run(jnp.float32)
    monkeypatch.undo()
    eps = torch.from_numpy(np.asarray(eps16, np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        got = tmodels.forward_pass_vae(
            t_net, tuple(map(torch.from_numpy, batch)), eps, clip_qs=True,
            cvae=cvae)
    for name in want16._fields:
        hold_to_jax_bf16(getattr(got, name), getattr(want16, name),
                         getattr(want32, name), name)
    assert got.kl_term.dtype == got.latent_samples.dtype == torch.bfloat16
    assert got.elbo.dtype == torch.float32


def _port_leaves(tree) -> dict:
    """A JAX parameter-shaped tree in the port's layout: {port name: fp64
    array}."""
    conv = mnist_params_from_jax(flatten_params(tree))
    return {f"{part}/{k}": np.asarray(v, np.float64)
            for part in ("vae", "gp") for k, v in conv[part].items()}


def _fro(x) -> float:
    return float(np.sqrt(np.sum(np.square(x))))


def test_train_step_bf16_matches_jax():
    """One Adam step of the Hensman slice under --bf16 against JAX's (its
    nets in bf16), held as the module doc says; everything the optimizer
    holds stays fp32."""
    params, batch = _problem(1)
    lr = 1e-3
    tx = jtrain.make_optimizer(lr)
    key = jax.random.PRNGKey(11)
    sub = jax.random.split(key)[1]

    def jax_loss(dtype):
        """jtrain.make_train_step's first step's loss (the noise of its
        key's split), its nets at `dtype`."""
        vae = jnets.MnistVAE(L=L, dtype=dtype)

        def loss(p):
            return jmodels.forward_pass_svgpvae(
                vae, p["vae"], p["gp"], batch, sub, beta=0.001,
                C_ma=jnp.float32(0.0), lagrange_mult=jnp.float32(1.0),
                alpha=jtrain.geco_effective_alpha(0, 0.99), kappa=KAPPA,
                clip_qs=True, geco=True, gp_block_impl="fused_pallas").elbo
        return loss

    g16 = _port_leaves(grad_bias_summed_in_fp32(jax_loss(BF16), params))
    g32 = _port_leaves(flax_rounding(jax.grad(jax_loss(jnp.float32)))(
        params))
    t_params = _port_params(params)
    trainable = ttrain.trainable_tensors(t_params, lambda name: True)
    before = {k: t.detach().clone() for k, t in trainable.items()}
    state = ttrain.TrainState(
        params=t_params, optimizer=ttrain.make_optimizer(trainable, lr),
        geco=ttrain.GECOState.init())
    eps = torch.from_numpy(np.array(jax.random.normal(sub, (B, L))))

    def loss_fn(p, b, geco, step):
        out = tmodels.forward_pass_svgpvae(
            p["vae"], p["gp"], b, eps, beta=0.001, C_ma=geco.C_ma,
            lagrange_mult=geco.lagrange_mult,
            alpha=ttrain.geco_effective_alpha(step, 0.99), kappa=KAPPA,
            clip_qs=True, geco=True, gp_block_impl="fused_pallas")
        return out.elbo, (ttrain.GECOState(
            C_ma=out.C_ma, lagrange_mult=out.lagrange_mult), {})

    ttrain.train_step(state, tuple(map(torch.from_numpy, batch)), loss_fn)
    assert set(trainable) == set(g16)
    grads = {k: t.grad.double().numpy() for k, t in trainable.items()}
    ratios = {k: _fro(grads[k] - g16[k]) / _fro(g16[k] - g32[k])
              for k in grads}
    worst = max(ratios, key=ratios.get)
    assert ratios[worst] <= 1.0, (worst, ratios[worst])
    whole = [np.concatenate([np.ravel(t[k]) for k in sorted(grads)])
             for t in (grads, g16, g32)]
    assert _fro(whole[0] - whole[1]) <= HALF * _fro(whole[1] - whole[2]), \
        (_fro(whole[0] - whole[1]), _fro(whole[1] - whole[2]))
    # JAX's optimizer on the port's gradients (Adam is elementwise, so the
    # port's layout serves), from the same parameters
    jp = {k: jnp.asarray(v.numpy()) for k, v in before.items()}
    updates, _ = tx.update({k: jnp.asarray(v, jnp.float32)
                            for k, v in grads.items()}, tx.init(jp), jp)
    want = optax.apply_updates(jp, updates)
    for k, t in trainable.items():
        assert t.dtype == torch.float32, k
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(want[k]),
                                   rtol=STEP_RTOL, atol=STEP_ATOL,
                                   err_msg=k)
    moments = [v for st in state.optimizer.state.values()
               for v in st.values() if isinstance(v, torch.Tensor)
               and v.dim() > 0]
    assert moments and {v.dtype for v in moments} == {torch.float32}


# --- the trainer's entry point ---------------------------------------------


ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs", "--PCA",
        "--ip_joint", "--GP_joint", "--ov_joint", "--dataset", "36",
        "--opt_regime", "joint-1", "--eval_every", "1", "--L", "6",
        "--batch_size", "128", "--seed", "0", "--device", "cpu",
        "--gp_block_impl", "fused_pallas"]


@pytest.fixture(scope="module")
def tiny_splits():
    base = tdata.synthetic_digit_base_images("36", per_digit=10, seed=0)
    return tdata.generate_rotated_mnist(base, None, digits="36", seed=0)


@pytest.mark.parametrize("elbo", ["SVGPVAE_Hensman", "VAE", "CVAE"])
def test_main_bf16_runs_with_fp32_state(elbo, tiny_splits, kernel_inputs,
                                        tmp_path):
    """--bf16 through `main`: the net computes in bf16, its parameters
    and the GP stay fp32, only fp32 reaches the kernels' wrappers, and the
    eval pass's cgen images are pickled as fp32."""
    argv = [a if a != "SVGPVAE_Hensman" else elbo for a in ARGV] + [
        "--bf16", "--nr_epochs", "1", "--save", "--base_dir", str(tmp_path)]
    res = tmnist.main(argv, splits=tiny_splits)
    vae = res["state"].params["vae"]
    assert vae.dtype == torch.bfloat16
    assert {t.dtype for t in vae.parameters()} == {torch.float32}
    ev = res["evals"][-1]
    assert np.isfinite(ev["test_mse"])
    assert all(np.isfinite(mt["loss"]) for mt in res["metrics"])
    assert {d for _, d in kernel_inputs} <= {torch.float32}
    if elbo != "VAE":
        assert np.isfinite(ev["cgen_mse"])
        with open(os.path.join(res["run_dir"], "cgen_images.p"), "rb") as f:
            assert np.load(f, allow_pickle=True).dtype == np.float32
    if elbo == "SVGPVAE_Hensman":
        assert {"gp_stats", "chol_inverse"} <= {n for n, _ in kernel_inputs}


def test_x64_overrides_bf16(tiny_splits, capsys):
    res = tmnist.main(ARGV + ["--bf16", "--x64", "--gp_block_impl",
                              "reference"], splits=tiny_splits)
    assert "warning: --x64 overrides --bf16 (float64 mode)" in \
        capsys.readouterr().out
    vae = res["state"].params["vae"]
    assert vae.dtype is None
    assert {t.dtype for t in vae.parameters()} == {torch.float64}
    assert np.isfinite(res["evals"][-1]["cgen_mse"])


def test_bf16_run_serves_with_fp32_nets(tiny_splits, tmp_path):
    res = tmnist.main(ARGV + ["--bf16", "--save", "--save_model_weights",
                              "--base_dir", str(tmp_path)],
                      splits=tiny_splits)
    loaded = tserve.load_predictor(res["run_dir"], torch.device("cpu"),
                                   tiny_splits)
    assert loaded["args"].bf16 and loaded["vae"].dtype is None
    assert loaded["means"].dtype == torch.float32
    for k, v in res["state"].params["vae"].state_dict().items():
        assert torch.equal(loaded["vae"].state_dict()[k], v), k
