"""The port's SPRITES serving slice against the JAX package.

  * the synthetic corpus is bit-identical for the same seed, and the shard
    files interoperate;
  * the GP precompute and fast posterior match JAX at float64 (rtol 1e-9:
    the same math, summed in other orders), with a full-rank and a
    rank-deficient K_mm;
  * models.predict_cgen_sprites and serving.fit/predict match JAX at
    float32 on transferred weights (rtol 1e-3 / atol 1e-4, the tolerance
    tests/test_serve_cli.py holds the served posterior to).  These use a
    full-rank K_mm (m <= L_action * L_character): with a rank-deficient
    one (PARITY.md #10) K_mm^-1 carries entries ~1/jitter, p_v is an
    O(|K_bb|) cancellation through it, and fp32 round-off in EITHER
    package moves p_v by ~1e-4 absolute (measured 3e-4 vs a 1e-1 scale at
    m = 18 > 15) -- that regime is held at float64 instead;
  * the whole slice, `svgpvae_tpu_torch.cli.serve.main` on a 4-character
    corpus on the CPU, matches the same steps in JAX;
  * importing the port's serve entry point loads no jax/flax/orbax/sklearn.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import data as jdata, models as jmodels, serving as jserving
from svgpvae_tpu import gp as jgp, nn as jnets
from svgpvae_tpu.cli import serve as jserve
from svgpvae_tpu.gp.svgp import SVGPConfig as JConfig
from svgpvae_tpu_torch import data as tdata, models as tmodels
from svgpvae_tpu_torch import gp as tgp, serving as tserving
from svgpvae_tpu_torch.cli import serve as tserve
from svgpvae_tpu_torch.nn import SpritesReprNet, SpritesVAE
from svgpvae_tpu_torch.utils.convert import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from export_jax_params import flatten_params  # noqa: E402
from torch_threads import _torch_threads  # noqa: E402,F401

RTOL32, ATOL32 = 1e-3, 1e-4
RTOL64 = 1e-9


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close32(got, want):
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL32, atol=ATOL32)


# --- corpus -----------------------------------------------------------------


def test_synthetic_corpus_is_bit_identical():
    kw = dict(n_train_chars=3, n_test_chars=2, n_frames_train=50, seed=7)
    want = jdata.generate_synthetic_sprites(**kw)
    got = tdata.generate_synthetic_sprites(**kw)
    assert got.keys() == want.keys()
    for split in want:
        for key in ("frames", "aux_data"):
            assert got[split][key].dtype == want[split][key].dtype
            np.testing.assert_array_equal(got[split][key], want[split][key])


def test_shards_interoperate(tmp_path):
    splits = tdata.generate_synthetic_sprites(2, 2, 50, seed=1)
    tdata.save_sprites_shards(splits, str(tmp_path / "port"), shard_size=64)
    jdata.save_sprites_shards(splits, str(tmp_path / "jax"), shard_size=64)
    for got in (jdata.load_sprites(str(tmp_path / "port")),
                tdata.load_sprites(str(tmp_path / "jax")),
                tdata.load_sprites(str(tmp_path / "port"))):
        for split in splits:
            for key in ("frames", "aux_data"):
                np.testing.assert_array_equal(got[split][key],
                                              splits[split][key])


# --- GP precompute + fast posterior at float64 ------------------------------


def _gp_case(rng, normalize, se, m, dtype_np):
    N, L, La, Lc, n_act = 120, 5, 3, 4, 12
    ip = rng.normal(0, 1.5, (m, La + Lc))
    gplvm = rng.normal(0, 1.5, (n_act, La))
    aux = np.hstack([rng.randint(0, n_act, (N, 1)).astype(float),
                     rng.rand(N, Lc)])
    aux_q = np.hstack([rng.randint(0, n_act, (7, 1)).astype(float),
                       rng.rand(7, Lc)])
    means = rng.randn(N, L)
    variances = np.clip(np.exp(rng.randn(N, L)), 1e-3, 10.0)
    cfg = dict(jitter=1e-2, K_obj_normalize=normalize)
    return ([a.astype(dtype_np) for a in (ip, gplvm, aux, aux_q, means,
                                          variances)], cfg, La, se)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("normalize,se,m", [
    (False, False, 9), (True, False, 9), (False, True, 9),
    (False, False, 14)])  # m = 14 > L_action * L_character: rank-deficient
def test_precompute_and_posterior_match_jax_f64(x64, normalize, se, m):
    rng = np.random.RandomState(11)
    (ip, gplvm, aux, aux_q, means, variances), cfg, La, se = _gp_case(
        rng, normalize, se, m, np.float64)
    j_gp = jgp.init_sprites_svgp(ip, gplvm, L_action=La, use_se_kernel=se,
                                 config=JConfig(**cfg), dtype=jnp.float64)
    t_gp = tgp.init_sprites_svgp(ip, gplvm, L_action=La, use_se_kernel=se,
                                 config=tgp.SVGPConfig(**cfg),
                                 dtype=torch.float64)
    want = jgp.precompute_test_posterior_terms(
        j_gp, jnp.asarray(means), jnp.asarray(variances), jnp.asarray(aux))
    got = tgp.precompute_test_posterior_terms(
        t_gp, *(torch.from_numpy(a) for a in (means, variances, aux)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL64,
                                   atol=RTOL64 * float(np.abs(w).max()))
    want_pv = jgp.posterior_from_precomputed(j_gp, jnp.asarray(aux_q), *want)
    got_pv = tgp.posterior_from_precomputed(t_gp, torch.from_numpy(aux_q),
                                            *got)
    for g, w in zip(got_pv, want_pv):
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL64,
                                   atol=RTOL64 * float(np.abs(w).max()))


def test_gplvm_gather_truncates_float_ids():
    """Float ids in aux column 0 index the GPLVM table like astype(int32)."""
    rng = np.random.RandomState(2)
    gp = tgp.init_sprites_svgp(rng.randn(4, 5), rng.randn(6, 2), L_action=2)
    aux = torch.tensor([[3.0, 0.1, 0.2, 0.3], [4.9999, 1.0, 1.0, 1.0]])
    act, chr_ = gp._features(aux, inducing=False)
    assert torch.equal(act, gp.gplvm_action[[3, 4]])
    assert torch.equal(chr_, aux[:, 1:])


# --- nets + GP at float32, transferred weights ------------------------------


L, L_ACT, L_CHR = 6, 3, 5


@pytest.fixture(scope="module")
def transferred():
    """flax nets + JAX GP, and the port's copies of them.  m = 12 inducing
    points <= L_ACT * L_CHR = 15 product-linear features: K_mm full rank."""
    rng = np.random.RandomState(5)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    vae, repr_net = jnets.SpritesVAE(L=L), jnets.SpritesReprNet(L=L_CHR)
    zeros = jnp.zeros((2, 64, 64, 3))
    gplvm = rng.normal(0, 1.5, (72, L_ACT))
    ip = rng.normal(0, 1.5, (12, L_ACT + L_CHR))
    cfg = dict(jitter=1e-2)
    j_gp = jgp.init_sprites_svgp(ip, gplvm, L_action=L_ACT,
                                 config=JConfig(**cfg))
    tree = {"vae": vae.init(k1, zeros), "repr": repr_net.init(k2, zeros),
            "gp": j_gp}
    port = params_from_jax(flatten_params(tree))
    t_vae, t_repr = SpritesVAE(L=L), SpritesReprNet(L=L_CHR)
    t_vae.load_state_dict(port["vae"])
    t_repr.load_state_dict(port["repr"])
    t_gp = tgp.SpritesSVGP(config=tgp.SVGPConfig(**cfg), L_action=L_ACT,
                           **port["gp"])
    return dict(vae=vae, repr=repr_net, tree=tree, j_gp=j_gp,
                t_vae=t_vae.eval(), t_repr=t_repr.eval(), t_gp=t_gp)


def _encoded_train(rng, n_char=2):
    frames = rng.rand(50 * n_char, 64, 64, 3).astype(np.float32)
    aids = np.tile(np.arange(50), n_char).astype(np.float32)
    return frames, aids


def test_encode_and_aux_match_jax(transferred):
    t = transferred
    frames, aids = _encoded_train(np.random.RandomState(0))
    mu_j, var_j = jmodels.batching_encode_svgpvae(
        t["vae"], t["tree"]["vae"], jnp.asarray(frames), clip_qs=True)
    aux_j = jmodels.sprites_aux_data(t["repr"].apply, t["tree"]["repr"],
                                     jnp.asarray(frames), jnp.asarray(aids),
                                     50)
    mu_t, var_t = tmodels.batching_encode_svgpvae(
        t["t_vae"], torch.from_numpy(frames), clip_qs=True)
    aux_t = tmodels.sprites_aux_data(t["t_repr"], torch.from_numpy(frames),
                                     torch.from_numpy(aids), 50)
    _close32(mu_t, mu_j)
    _close32(var_t, var_j)
    _close32(aux_t, aux_j)


@pytest.mark.parametrize("perm", [False, True])
def test_predict_cgen_sprites_matches_jax(transferred, perm):
    """Same ε: the JAX draw jax.random.normal(key, p_m.shape) is injected."""
    t = transferred
    rng = np.random.RandomState(1)
    frames, aids = _encoded_train(rng)
    mu_j, var_j = jmodels.batching_encode_svgpvae(
        t["vae"], t["tree"]["vae"], jnp.asarray(frames))
    aux_j = jmodels.sprites_aux_data(t["repr"].apply, t["tree"]["repr"],
                                     jnp.asarray(frames), jnp.asarray(aids),
                                     50)
    terms_j = jmodels.precompute_gp_params(t["j_gp"], mu_j, var_j, aux_j)
    terms_t = tmodels.precompute_gp_params(
        t["t_gp"], *(torch.tensor(np.asarray(a))
                     for a in (mu_j, var_j, aux_j)))

    test_im = rng.rand(144, 64, 64, 3).astype(np.float32)
    test_ids = np.tile(np.arange(72), 2).astype(np.float32)
    ctx_perm = np.stack([rng.permutation(72) for _ in range(2)]) if perm \
        else None
    key = jax.random.PRNGKey(9)
    recon_j, tgt_j, loss_j = jmodels.predict_cgen_sprites(
        t["vae"], t["tree"]["vae"], t["j_gp"], t["repr"].apply,
        t["tree"]["repr"], jnp.asarray(test_im), jnp.asarray(test_ids),
        *terms_j, n_context=36, n_actions_total=72, key=key,
        context_perm=None if ctx_perm is None else jnp.asarray(ctx_perm))
    eps = np.array(jax.random.normal(key, (72, L)))
    recon_t, tgt_t, loss_t = tmodels.predict_cgen_sprites(
        t["t_vae"], t["t_gp"], t["t_repr"], torch.from_numpy(test_im),
        torch.from_numpy(test_ids), *terms_t, n_context=36,
        n_actions_total=72, eps=torch.from_numpy(eps),
        context_perm=None if ctx_perm is None
        else torch.from_numpy(ctx_perm))
    np.testing.assert_array_equal(_np(tgt_t), _np(tgt_j))
    _close32(recon_t, recon_j)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=RTOL32)


def test_serving_fit_predict_match_jax(transferred):
    t = transferred
    rng = np.random.RandomState(2)
    N = 100
    means = rng.randn(N, L).astype(np.float32)
    variances = np.clip(np.exp(rng.randn(N, L)), 1e-3, 10).astype(np.float32)
    aux = np.hstack([rng.randint(0, 72, (N, 1)),
                     rng.rand(N, L_CHR)]).astype(np.float32)
    aux_q = aux[:9]
    pred_j = jserving.fit(t["j_gp"], jnp.asarray(means),
                          jnp.asarray(variances), jnp.asarray(aux))
    pred_t = tserving.fit(t["t_gp"], *(torch.from_numpy(a)
                                       for a in (means, variances, aux)))
    for name in ("mean_terms", "sigma_inv", "kmm_inv"):
        _close32(getattr(pred_t, name), getattr(pred_j, name))
    want = jserving.make_predict_fn(pred_j, t["vae"], t["tree"]["vae"],
                                    sample=False)(jnp.asarray(aux_q),
                                                  jax.random.PRNGKey(0))
    got = tserving.make_predict_fn(pred_t, t["t_vae"], sample=False)(
        torch.from_numpy(aux_q))
    for g, w in zip(got, want):
        _close32(g, w)


# --- the whole slice --------------------------------------------------------


def test_serve_main_matches_jax_steps(tmp_path):
    """cli.serve.main on a 4-character corpus (CPU) against the same steps
    in JAX on the same weights."""
    seed, n_chars = 0, 4
    vae, repr_net = jnets.SpritesVAE(L=64), jnets.SpritesReprNet(L=16)
    key = jax.random.PRNGKey(seed)
    zeros = jnp.zeros((2, 64, 64, 3))
    vae_p, repr_p = vae.init(key, zeros), repr_net.init(key, zeros)
    rng = np.random.RandomState(seed)  # as svgpvae_tpu/cli/serve.py draws
    gplvm = rng.normal(0, 1.5, (72, 8))
    ip = rng.normal(0, 1.5, (72, 24))
    splits = jdata.generate_synthetic_sprites(
        n_train_chars=n_chars, n_test_chars=max(2, n_chars // 4),
        n_frames_train=50, seed=0)
    train = splits["train"]
    cfg = JConfig(jitter=0.01, N_train=len(train["frames"]))
    j_gp = jgp.init_sprites_svgp(ip, gplvm, L_action=8, config=cfg)
    npz = str(tmp_path / "params.npz")
    np.savez(npz, **flatten_params({"vae": vae_p, "repr": repr_p,
                                    "gp": j_gp}))

    got = tserve.main(["--synthetic", "--synthetic_chars", str(n_chars),
                       "--params", npz, "--mean", "--n_requests", "2",
                       "--device", "cpu"])

    frames = jnp.asarray(train["frames"])
    means, variances = jserve._encode_chunked(vae, vae_p, frames, True)
    aux = jmodels.sprites_aux_data(repr_net.apply, repr_p, frames,
                                   jnp.asarray(train["aux_data"][:, 1]), 50)
    state = got["state"]
    _close32(state["means"], means)
    _close32(state["variances"], variances)
    _close32(state["aux"], aux)
    predict = jserving.make_predict_fn(
        jserving.fit(j_gp, means, variances, aux), vae, vae_p, sample=False)
    tc = splits["test_character"]
    sq_err = 0.0
    for c in range(2):
        block = slice(72 * c, 72 * (c + 1))
        aux_q = jserve.sprites_query_aux(repr_net, repr_p,
                                         jnp.asarray(tc["frames"][block][:36]),
                                         tc["aux_data"][block, 1][36:])
        images, p_m, p_v = predict(aux_q, key)
        served = state["served"][c]
        _close32(served["aux_query"], aux_q)
        _close32(served["p_m"], p_m)
        _close32(served["p_v"], p_v)
        _close32(served["images"], images)
        sq_err += float(np.sum((tc["frames"][block][36:] - images) ** 2))
    mse = sq_err / (64 * 64 * 72)
    assert got["n_queries"] == 72
    np.testing.assert_allclose(got["cgen_mse"], mse, rtol=RTOL32)
    # CPU tensors: the fit ran the plain twins and launched no kernel
    assert got["fit_launches"] == {"chol_inverse": 0,
                                   "fused_kernel_stats": 0,
                                   "gp_sufficient_stats": 0}


def test_serve_main_reads_shards_like_the_synthetic_corpus(tmp_path):
    """--sprites_data_path (shards on disk) serves exactly what --synthetic
    (the same corpus in memory) serves."""
    tdata.save_sprites_shards(tdata.generate_synthetic_sprites(
        n_train_chars=4, n_test_chars=2, n_frames_train=50,
        seed=tserve.CORPUS_SEED), str(tmp_path))
    common = ["--n_requests", "2", "--mean", "--device", "cpu"]
    from_disk = tserve.main(["--sprites_data_path", str(tmp_path)] + common)
    in_memory = tserve.main(["--synthetic", "--synthetic_chars", "4"]
                            + common)
    assert from_disk["cgen_mse"] == in_memory["cgen_mse"]
    for a, b in zip(from_disk["state"]["served"],
                    in_memory["state"]["served"]):
        assert torch.equal(a["images"], b["images"])


def test_serve_main_refuses_a_missing_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tserve.main(["--synthetic", "--synthetic_chars", "4"])


def test_port_imports_no_jax():
    """Importing the serve entry point, the profiling utilities (and
    tracing a block with them), the sentinel and the raw SPRITES npy
    loader adds no jax/flax/orbax/sklearn module (the set is compared
    before/after, so a preloading hook cannot mask an import)."""
    code = (
        "import sys\n"
        "banned = ('jax', 'jaxlib', 'flax', 'orbax', 'sklearn')\n"
        "def mods(): return {m for m in sys.modules "
        "if m.split('.')[0] in banned}\n"
        "before = mods()\n"
        "import svgpvae_tpu_torch.cli.serve, svgpvae_tpu_torch.ops.gp_stats\n"
        "import svgpvae_tpu_torch.ops.fused_kernel_stats\n"
        "import svgpvae_tpu_torch.ops._build\n"
        "import svgpvae_tpu_torch.utils.profiling as prof, tempfile\n"
        "from svgpvae_tpu_torch.utils.metrics import check_finite\n"
        "from svgpvae_tpu_torch.data.sprites import (\n"
        "    load_raw_sprites_npys, preprocess_sprites)\n"
        "with prof.trace_if(tempfile.mkdtemp()), prof.annotate('x'):\n"
        "    check_finite([1.0], 0)\n"
        "added = sorted(mods() - before)\n"
        "assert not added, added\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
