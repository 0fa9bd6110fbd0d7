"""The port's SPRITES nets against the flax modules, with the flax weights
carried over by params_from_jax (via tools/export_jax_params.flatten_params).

float32 on the CPU: XLA and torch convolutions sum in different orders, so
outputs agree to float32 round-off through the 6-conv trunks: rtol 1e-4,
atol 1e-5 on O(0.1-1) activations.
"""

import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from svgpvae_tpu import nn as jnets
from svgpvae_tpu_torch import nn as tnets
from svgpvae_tpu_torch.utils.convert import params_from_jax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from export_jax_params import flatten_params  # noqa: E402
from torch_threads import _torch_threads  # noqa: E402,F401

RTOL, ATOL = 1e-4, 1e-5
L, L_CHAR = 6, 5


@pytest.fixture(scope="module")
def models():
    key = jax.random.PRNGKey(1)
    k1, k2 = jax.random.split(key)
    vae = jnets.SpritesVAE(L=L)
    repr_net = jnets.SpritesReprNet(L=L_CHAR)
    zeros = jnp.zeros((2, 64, 64, 3))
    tree = {"vae": vae.init(k1, zeros), "repr": repr_net.init(k2, zeros),
            "gp": {"inducing_points": np.zeros((3, 4)),
                   "gplvm_action": np.zeros((72, 2)),
                   "l_action": 1.0, "sigma_action": 0.1,
                   "l_character": 1.0, "sigma_character": 0.1}}
    port = params_from_jax(flatten_params(tree))
    t_vae = tnets.SpritesVAE(L=L)
    t_vae.load_state_dict(port["vae"])
    t_repr = tnets.SpritesReprNet(L=L_CHAR)
    t_repr.load_state_dict(port["repr"])
    return vae, tree["vae"], repr_net, tree["repr"], t_vae.eval(), \
        t_repr.eval()


def _images(b, seed):
    return np.random.RandomState(seed).rand(b, 64, 64, 3).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_sprites_vae_encode_matches_flax(models):
    vae, vae_p, _, _, t_vae, _ = models
    im = _images(3, 0)
    mu_j, var_j = vae.apply(vae_p, jnp.asarray(im), method=vae.encode)
    with torch.no_grad():
        mu_t, var_t = t_vae.encode(torch.from_numpy(im))
    assert mu_t.shape == (3, L)
    _close(mu_t, mu_j)
    _close(var_t, var_j)


def test_sprites_vae_decode_matches_flax(models):
    vae, vae_p, _, _, t_vae, _ = models
    z = np.random.RandomState(1).randn(4, L).astype(np.float32)
    want = vae.apply(vae_p, jnp.asarray(z), method=vae.decode)
    with torch.no_grad():
        got = t_vae.decode(torch.from_numpy(z))
    assert got.shape == (4, 64, 64, 3)
    _close(got, want)


def test_sprites_repr_net_matches_flax(models):
    _, _, repr_net, repr_p, _, t_repr = models
    im = _images(5, 2)
    want = repr_net.apply(repr_p, jnp.asarray(im))
    with torch.no_grad():
        got = t_repr(torch.from_numpy(im))
    assert got.shape == (5, L_CHAR)
    _close(got, want)


def test_safe_exp_caps_like_flax():
    x = np.array([-3.0, 0.0, 14.9, 15.0, 80.0, 1e4], np.float32)
    np.testing.assert_array_equal(
        tnets.safe_exp(torch.from_numpy(x)).numpy(),
        np.asarray(jnets.nets.safe_exp(jnp.asarray(x))))


def test_upsample2x_matches_flax():
    x = np.random.RandomState(3).randn(2, 3, 4, 5).astype(np.float32)  # NHWC
    want = np.asarray(jnets.upsample2x(jnp.asarray(x)))
    got = tnets.upsample2x(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
