"""The port's rotated-MNIST training step and driver against the JAX package.

  * one training step at float32 (b = 32, L = 4) on weights converted from
    flax and JAX's noise (jax.random.normal(split(state.key)[1], (b, L))):
    the loss, the GECO state after the step and every parameter's gradient
    against jax.value_and_grad of the JAX driver's loss; then the
    parameters after 2 Adam steps against train.make_train_step;
  * the whole slice: cli.mnist.main(..., "--device", "cpu") on a tiny
    in-memory dataset for two steps (one full batch and the tail) and one
    eval pass, against the same steps and passes made with the JAX
    functions;
  * the dispatch table, the trainer's pieces, the refusals, and that the
    entry point imports no jax/flax/optax/sklearn.

Tolerances (float32 on both sides, the same math in other orders): a
loss is the small difference of the inside-ELBO and the cross-entropy
term, each ~10x larger (e.g. -1854 and -1679 for a loss of 176), so it is
held to 1e-5 of |inside_elbo| + |ce_term| + |loss|; the GECO state rtol
1e-5; gradients within 2e-4 of each tensor's
max |entry| (the GP block's solves amplify fp32 round-off by its
conditioning, ~1e3 here: measured gaps are ~1e-5 of scale); parameters
after Adam steps atol 1e-4, a tenth of one step: Adam moves an entry by
up to lr = 1e-3 whatever the size of its gradient, so where a gradient
entry is within round-off of 0 (some inducing-point angles: the periodic
kernel's terms nearly cancel) the two sides may step differently
(measured: 4.7e-5 on 3 of 320 inducing-point entries, all others below
1e-6).
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import data as jdata, gp as jgp, models as jmodels
from svgpvae_tpu import nn as jnets, train as jtrain
from svgpvae_tpu.gp.svgp import SVGPConfig as JConfig
from svgpvae_tpu_torch import data as tdata, gp as tgp, models as tmodels
from svgpvae_tpu_torch import train as ttrain
from svgpvae_tpu_torch.cli import mnist as tmnist
from svgpvae_tpu_torch.nn import MnistVAE
from svgpvae_tpu_torch.utils.convert import mnist_params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from export_jax_params import flatten_params  # noqa: E402

RTOL_LOSS = 1e-5
GRAD_RTOL = 2e-4
PARAM_ATOL = 1e-4
KAPPA = float(np.sqrt(0.02))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jax_loss_fn(vae, impl, alpha=0.99):
    """The JAX driver's loss_svgpvae for SVGPVAE_Hensman --GECO."""
    def loss_fn(params, batch, key, geco, step):
        out = jmodels.forward_pass_svgpvae(
            vae, params["vae"], params["gp"], batch, key, beta=0.001,
            C_ma=geco.C_ma, lagrange_mult=geco.lagrange_mult,
            alpha=jtrain.geco_effective_alpha(step, alpha), kappa=KAPPA,
            clip_qs=True, geco=True, gp_block_impl=impl)
        scale = (jnp.abs(out.inside_elbo) + jnp.abs(out.ce_term)
                 + jnp.abs(out.elbo))
        return out.elbo, (jtrain.GECOState(C_ma=out.C_ma,
                                           lagrange_mult=out.lagrange_mult),
                          {"elbo": out.elbo, "recon": out.recon_loss,
                           "scale": scale})
    return loss_fn


def _assert_loss(got, want, scale):
    assert abs(float(got) - float(want)) <= RTOL_LOSS * float(scale), \
        (float(got), float(want), float(scale))


def _torch_loss_fn(eps_seq, impl, alpha=0.99):
    def loss_fn(params, batch, geco, step):
        out = tmodels.forward_pass_svgpvae(
            params["vae"], params["gp"], batch, eps_seq[step], beta=0.001,
            C_ma=geco.C_ma, lagrange_mult=geco.lagrange_mult,
            alpha=ttrain.geco_effective_alpha(step, alpha), kappa=KAPPA,
            clip_qs=True, geco=True, gp_block_impl=impl)
        return out.elbo, (ttrain.GECOState(C_ma=out.C_ma,
                                           lagrange_mult=out.lagrange_mult),
                          {"elbo": out.elbo.detach()})
    return loss_fn


def _problem(b=32, L=4, M=4, m=8, n_obj=20, seed=0):
    rng = np.random.RandomState(seed)
    ip = np.hstack([np.arange(m)[:, None], rng.rand(m, 1) * 2 * np.pi,
                    rng.randn(m, M)])
    table = rng.randn(n_obj, M)
    batches = []
    for _ in range(2):
        aux = np.hstack([rng.randint(0, n_obj, (b, 1)).astype(float),
                         rng.rand(b, 1) * 2 * np.pi, rng.randn(b, M)])
        batches.append((rng.rand(b, 28, 28, 1).astype(np.float32),
                        aux.astype(np.float32)))
    vae = jnets.MnistVAE(L=L)
    params = {"vae": vae.init(jax.random.PRNGKey(seed),
                              jnp.zeros((2, 28, 28, 1))),
              "gp": jgp.init_mnist_svgp(ip, table, config=JConfig(
                  jitter=1e-6, N_train=10 * b))}
    return vae, params, batches


def _port_params(params, L):
    port = mnist_params_from_jax(flatten_params(params))
    t_vae = MnistVAE(L=L)
    t_vae.load_state_dict(port["vae"])
    t_gp = tgp.MnistSVGP(config=tgp.SVGPConfig(jitter=1e-6,
                                               N_train=params["gp"].config
                                               .N_train), **port["gp"])
    return {"vae": t_vae, "gp": t_gp}


def _assert_grads(got: dict, j_grads, j_params):
    flat_j = flatten_params(j_grads)
    conv = mnist_params_from_jax(flat_j)  # same layout changes as weights
    want = {f"vae/{k}": v for k, v in conv["vae"].items()}
    want.update({f"gp/{k}": v for k, v in conv["gp"].items()})
    assert set(got) == set(want)
    for name, g in got.items():
        w = _np(want[name])
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(_np(g) - w).max()
        assert err <= GRAD_RTOL * scale, (name, err, scale)


def _assert_params(port_params, j_params):
    conv = mnist_params_from_jax(flatten_params(j_params))
    for k, v in conv["vae"].items():
        np.testing.assert_allclose(
            _np(port_params["vae"].state_dict()[k]), _np(v),
            atol=PARAM_ATOL, err_msg=k)
    for k, v in conv["gp"].items():
        np.testing.assert_allclose(_np(getattr(port_params["gp"], k)),
                                   _np(v), atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("impl", ["reference", "fused_pallas"])
def test_train_step_matches_jax(impl):
    L, lr = 4, 1e-3
    vae, params, batches = _problem(L=L)
    tx = jtrain.make_optimizer(lr)
    state = jtrain.TrainState.create(params, tx, jax.random.PRNGKey(11))
    loss_j = _jax_loss_fn(vae, impl)

    # the noise make_train_step draws at steps 0 and 1
    eps_seq, key = [], state.key
    for _ in range(2):
        key, sub = jax.random.split(key)
        eps_seq.append(torch.from_numpy(np.array(
            jax.random.normal(sub, (32, L)))))
    jb = [tuple(jnp.asarray(a) for a in b) for b in batches]
    (want_loss, (want_geco, want_m)), want_grads = jax.jit(jax.value_and_grad(
        loss_j, has_aux=True))(params, jb[0],
                              jax.random.split(state.key)[1], state.geco,
                              state.step)

    t_params = _port_params(params, L)
    trainable = ttrain.trainable_tensors(t_params, lambda name: True)
    t_state = ttrain.TrainState(
        params=t_params, optimizer=ttrain.make_optimizer(trainable, lr),
        geco=ttrain.GECOState.init())
    tb = [tuple(torch.from_numpy(a) for a in b) for b in batches]
    loss_fn = _torch_loss_fn(eps_seq, impl)
    m = ttrain.train_step(t_state, tb[0], loss_fn)
    _assert_loss(m["loss"], want_loss, want_m["scale"])
    for got, want in ((t_state.geco.C_ma, want_geco.C_ma),
                      (t_state.geco.lagrange_mult, want_geco.lagrange_mult)):
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL_LOSS)
    _assert_grads({k: t.grad for k, t in trainable.items()}, want_grads,
                  params)

    if impl == "reference":
        return  # the two-step check below runs the CUDA path's impl
    step = jtrain.make_train_step(loss_j, tx, donate=False)
    for batch in jb:
        state, _ = step(state, batch)
    ttrain.train_step(t_state, tb[1], loss_fn)
    assert t_state.step == int(state.step) == 2
    _assert_params(t_params, state.params)
    np.testing.assert_allclose(float(t_state.geco.C_ma),
                               float(state.geco.C_ma), rtol=RTOL_LOSS)


# --- the whole slice ---------------------------------------------------------


SLICE_ARGV = ["--elbo", "SVGPVAE_Hensman", "--GECO", "--clip_qs", "--PCA",
              "--ip_joint", "--GP_joint", "--ov_joint", "--dataset", "36",
              "--opt_regime", "joint-1", "--eval_every", "1", "--L", "6",
              "--batch_size", "128", "--seed", "0",
              "--gp_block_impl", "fused_pallas"]  # the CUDA path's block


@pytest.fixture(scope="module")
def tiny_splits():
    base = tdata.synthetic_digit_base_images("36", per_digit=10, seed=0)
    return tdata.generate_rotated_mnist(base, None, digits="36", seed=0)


def _jax_eps(seed, L):
    """eps_fn giving the JAX driver's draws: step t uses the subkey of the
    t-th split of the state key; every eval batch uses PRNGKey(7)."""
    key = [jax.random.split(jax.random.PRNGKey(seed))[0]]

    def eps_fn(kind, shape):
        if kind == "train":
            key[0], sub = jax.random.split(key[0])
        else:
            sub = jax.random.PRNGKey(7)
        return torch.from_numpy(np.array(jax.random.normal(sub, shape)))
    return eps_fn


def test_main_matches_jax_steps(tmp_path, tiny_splits):
    L, seed, bs = 6, 0, 128
    tr = tiny_splits["train"]
    vae = jnets.MnistVAE(L=L)
    key, init_key = jax.random.split(jax.random.PRNGKey(seed))
    vae_p = vae.init(init_key, jnp.zeros((2, 28, 28, 1)))
    ip = jdata.generate_init_inducing_points(tr, n=2, use_pca=True, M=8,
                                             seed=seed)
    N_train = len(tr["images"])
    j_gp = jgp.init_mnist_svgp(ip, tiny_splits["pca_ov_init"],
                               config=JConfig(jitter=1e-6, N_train=N_train))
    params = {"vae": vae_p, "gp": j_gp}
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **flatten_params(params))

    got = tmnist.main(SLICE_ARGV + ["--device", "cpu", "--params", npz],
                      splits=tiny_splits, eps_fn=_jax_eps(seed, L))

    tx = jtrain.make_optimizer(1e-3)
    state = jtrain.TrainState.create(params, tx, key)
    step = jtrain.make_train_step(_jax_loss_fn(vae, "fused_pallas"), tx,
                                  donate=False)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    im, aux = f32(tr["images"]), f32(tr["aux_data"])
    batches = [(im[:bs], aux[:bs]), (im[bs:], aux[bs:])]
    assert len(got["metrics"]) == 2 and N_train - bs == 74
    for i, batch in enumerate(batches):
        state, m = step(state, batch)
        _assert_loss(got["metrics"][i]["loss"], m["loss"], m["scale"])
    _assert_params(got["state"].params, state.params)

    # one eval pass: eval/test recon MSE and cgen MSE, eval key 7
    ekey = jax.random.PRNGKey(7)

    @jax.jit
    def recon(params, geco, batch):
        return jmodels.forward_pass_svgpvae(
            vae, params["vae"], params["gp"], batch, ekey, beta=0.001,
            C_ma=geco.C_ma, lagrange_mult=geco.lagrange_mult, alpha=0.99,
            kappa=KAPPA, clip_qs=True, geco=True,
            gp_block_impl="fused_pallas").recon_loss

    @jax.jit
    def cgen_loss(params, batch, mu, var):
        return jmodels.predict_cgen_mnist(vae, params["vae"], params["gp"],
                                          batch, mu, var, aux, ekey)[1]

    def recon_sum(split):
        x, a = f32(split["images"]), f32(split["aux_data"])
        return sum(float(recon(state.params, state.geco,
                               (x[lo:lo + bs], a[lo:lo + bs])))
                   for lo in range(0, len(x), bs))

    te = tiny_splits["test"]
    mu, var = jmodels.batching_encode_svgpvae(vae, state.params["vae"], im)
    x, a = f32(te["images"]), f32(te["aux_data"])
    cgen = sum(float(cgen_loss(state.params, (x[lo:lo + bs], a[lo:lo + bs]),
                               mu, var))
               for lo in range(0, len(x), bs))
    ev = got["evals"][0]
    np.testing.assert_allclose(ev["eval_mse"],
                               recon_sum(tiny_splits["eval"])
                               / len(tiny_splits["eval"]["images"]),
                               rtol=1e-4)
    np.testing.assert_allclose(ev["test_mse"], recon_sum(te) / len(x),
                               rtol=1e-4)
    np.testing.assert_allclose(ev["cgen_mse"], cgen / len(x), rtol=1e-4)
    # CPU tensors: the twins ran and no kernel launched
    assert all(n == 0 for s in got["step_launches"] for n in s.values())


def test_main_capture_and_frozen_leaves(tiny_splits):
    """--ip_joint off freezes the inducing points (no gradient, no update);
    capture_step keeps the step's inputs and gradients."""
    argv = [a for a in SLICE_ARGV if a != "--ip_joint"] + ["--device", "cpu"]
    res = tmnist.main(argv, splits=tiny_splits, capture_step=1)
    start = tmnist.main(argv[:argv.index("--opt_regime")] + [
        "--opt_regime", "joint-0"] + argv[argv.index("--opt_regime") + 2:],
        splits=tiny_splits)
    gp0, gp1 = start["state"].params["gp"], res["state"].params["gp"]
    assert torch.equal(gp0.inducing_points, gp1.inducing_points)
    assert not torch.equal(gp0.length_scale, gp1.length_scale)
    cap = res["captured"]
    assert cap["step"] == 1 and cap["eps"].shape == (74, 6)
    assert "gp/inducing_points" not in cap["grads"]
    assert cap["batch"][0].shape == (74, 28, 28, 1)
    assert float(cap["loss"]) == res["metrics"][1]["loss"]


# --- pieces -----------------------------------------------------------------


def test_dispatch_table():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tmodels.GP_BLOCK_AUTO_TABLE.keys() == {
        (w, bound, backend) for w in ("mnist", "sprites", "ball")
        for bound in ("hensman", "titsias") for backend in ("cuda", "other")}
    assert tmodels.resolve_gp_block_impl("auto", device=cuda) == \
        "fused_pallas"
    assert tmodels.resolve_gp_block_impl("auto", device=cpu) == "reference"
    # every "other" cell is the JAX package's, every "cuda" cell its "tpu"
    # cell
    j_table = jmodels.svgpvae.GP_BLOCK_AUTO_TABLE
    for (w, bound, backend), (impl, _) in tmodels.GP_BLOCK_AUTO_TABLE.items():
        assert j_table[(w, bound, "tpu" if backend == "cuda"
                        else "other")][0] == impl, (w, bound, backend)
    assert tmodels.resolve_gp_block_impl("auto", titsias=True,
                                         device=cuda) == "fused_pallas"
    assert tmodels.resolve_gp_block_impl("auto", titsias=True,
                                         device=cpu) == "fused"
    for impl in tmodels.svgpvae.GP_BLOCK_IMPLS:
        assert tmodels.resolve_gp_block_impl(impl, device=cuda) == impl
    with pytest.raises(NotImplementedError):
        tmodels.resolve_gp_block_impl("auto", workload="casale")
    with pytest.raises(ValueError):
        tmodels.resolve_gp_block_impl("triton")


def test_trainer_pieces_match_jax():
    specs = ["VAE-3", "GP-2", "joint-4"]
    assert ttrain.parse_opt_regime(specs) == jtrain.parse_opt_regime(specs)
    sched = jtrain.lr_schedule(1e-3, 0.1, 50)
    fn = ttrain.cosine_decay_lr(1e-3, 0.1, 50)
    for step in (0, 1, 25, 49, 50, 80):
        np.testing.assert_allclose(fn(step), float(sched(step)), rtol=1e-6)
    assert ttrain.cosine_decay_lr(1e-3, None, 50) is None
    assert ttrain.geco_effective_alpha(0, 0.99) == 0.0
    assert ttrain.geco_effective_alpha(3, 0.99) == 0.99


def test_value_clip_clips_gradients_before_adam():
    w = torch.zeros(3, requires_grad=True)
    state = ttrain.TrainState(params={}, optimizer=torch.optim.SGD([w], 1.0),
                              geco=None, clip_grad_value=0.5)

    def loss_fn(params, batch, geco, step):
        return torch.sum(w * torch.tensor([2.0, -0.1, -3.0])), (geco, {})

    ttrain.train_step(state, None, loss_fn)
    assert torch.allclose(w.detach(), torch.tensor([-0.5, 0.1, 0.5]))


@pytest.mark.parametrize("flag", [
    ["--elbo", "GPVAE_Casale", "--data_parallel", "2"],
    ["--elbo", "SVIGP_Hensman", "--x64"],
    ["--elbo", "GPVAE_Casale", "--epoch_chunk", "2"],
    ["--elbo", "GPVAE_Casale_batch", "--eval_bundle"],
    ["--elbo", "GPVAE_Casale", "--bf16"],
    ["--elbo", "GPVAE_Casale", "--x64"],
    ["--elbo", "GPVAE_Casale_batch", "--data_parallel", "2"],
    ["--elbo", "GPVAE_Casale", "--reshuffle"],
    ["--elbo", "SVIGP_Hensman", "--resume_dir", "x"],
    ["--elbo", "SVIGP_Hensman", "--eval_bundle"],
    ["--elbo", "SVIGP_Hensman", "--bf16"]])
def test_unported_flags_are_refused(flag, tiny_splits):
    argv = SLICE_ARGV + ["--device", "cpu"] + flag
    with pytest.raises(SystemExit, match="not ported"):
        tmnist.main(argv, splits=tiny_splits)


def test_main_refuses_a_missing_cuda_device(tiny_splits):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tmnist.main(SLICE_ARGV, splits=tiny_splits)


def test_mnist_entry_point_imports_no_jax():
    """Importing the MNIST trainer adds no jax/flax/optax/sklearn module
    (compared before/after, so a preloading hook cannot mask an import)."""
    code = (
        "import sys\n"
        "banned = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'sklearn',\n"
        "          'svgpvae_tpu')\n"
        "def mods(): return {m for m in sys.modules "
        "if m.split('.')[0] in banned}\n"
        "before = mods()\n"
        "import svgpvae_tpu_torch.cli.mnist, svgpvae_tpu_torch.ops\n"
        "import svgpvae_tpu_torch.ops.chol_inverse\n"
        "import svgpvae_tpu_torch.utils.profiling\n"
        "import svgpvae_tpu_torch.nn.nets, svgpvae_tpu_torch.cli.serve\n"
        "sys.path.insert(0, 'tools')\n"
        "import profile_torch_mnist_step\n"
        "added = sorted(mods() - before)\n"
        "assert not added, added\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
