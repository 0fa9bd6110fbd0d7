"""The moving ball's ELBOs in the port against the JAX package (the
modules under them: tests/test_torch_ball.py, whose helpers these share).

  * ball_svgpvae_elbo for each impl and bound, and pearce_elbo for
    GPVAE_Pearce, VAE and NP (the NP through the JAX draws of its context
    size and permutations), on injected noise at float64: every output
    and the gradient of the mean ELBO with respect to every parameter;
  * the NP context draws and the masked-likelihood identity.

Tolerances: float64 within 1e-9 of each output's max |entry| (the same
formulas summed in other orders, or Gauss-Jordan against Cholesky on
matrices of condition < 1e4).  The JAX references compile at XLA's
lowest optimisation level (tests/test_torch_sprites_train.py's quick_jit),
which moves their results by round-off.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import models as jmodels, nn as jnets
from svgpvae_tpu_torch import gp as tgp, models as tmodels
from svgpvae_tpu_torch.utils.convert import ball_params_from_jax

from test_torch_ball import (RTOL64, _ball_gp, _close, _port_nets, _t, _x64,
                             flatten_params)
from test_torch_sprites_train import quick_jit
from torch_threads import _torch_threads  # noqa: E402,F401


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

        want = quick_jit(j_out)(params, j_gp)
        j_grads = quick_jit(jax.grad(
            lambda p, gp: jnp.mean(j_out(p, gp).elbo),
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
        want = quick_jit(j_out)(params)
        j_grads = quick_jit(jax.grad(lambda p: jnp.mean(j_out(p).elbo)))(
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
