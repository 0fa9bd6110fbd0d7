"""The port's nets initialise as the JAX package's flax nets do: every conv
and linear weight from lecun_normal (a unit normal truncated at +-2,
scaled so the variance is 1/fan_in), every bias zero, drawn from an
explicit torch.Generator.

The reference draw is jax.nn.initializers.lecun_normal() at the same
shape (flax's HWIO / (in, out) layout).  Tolerances are sampling error:
the std of n draws is held within 5 standard errors, sigma / sqrt(2 n),
of sqrt(1 / fan_in), and on the large layers the port's and JAX's draws
are held to one distribution by the two-sample Kolmogorov-Smirnov
statistic, below 3x its 5% critical value 1.36 sqrt(2 / n).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from svgpvae_tpu_torch.nn import (ClassificationHead, MnistVAE,
                                  SpritesReprNet, SpritesVAE)
from torch_threads import _torch_threads  # noqa: E402,F401

NETS = {
    "SpritesVAE": lambda g: SpritesVAE(L=64, generator=g),
    "SpritesReprNet": lambda g: SpritesReprNet(L=16, generator=g),
    "ClassificationHead": lambda g: ClassificationHead(16, 1000,
                                                       generator=g),
    "MnistVAE": lambda g: MnistVAE(L=16, generator=g),
}
LARGE = [("SpritesVAE", "enc_out"), ("SpritesVAE", "dec_in"),
         ("ClassificationHead", "dense")]


def _layers(net):
    return [(name, m) for name, m in net.named_modules()
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]


def _flax_shape(w: torch.Tensor) -> tuple:
    """torch (out, in, kh, kw) / (out, in) -> flax (kh, kw, in, out) /
    (in, out)."""
    if w.dim() == 4:
        return (w.shape[2], w.shape[3], w.shape[1], w.shape[0])
    return (w.shape[1], w.shape[0])


def _ks(a: np.ndarray, b: np.ndarray) -> float:
    grid = np.sort(np.concatenate([a, b]))
    cdf = [np.searchsorted(np.sort(x), grid, side="right") / len(x)
           for x in (a, b)]
    return float(np.abs(cdf[0] - cdf[1]).max())


@pytest.mark.parametrize("net_name", list(NETS))
def test_weights_are_lecun_normal_and_biases_zero(net_name):
    net = NETS[net_name](torch.Generator().manual_seed(0))
    key = jax.random.PRNGKey(0)
    layers = _layers(net)
    assert layers
    for name, layer in layers:
        w = layer.weight.detach().double().numpy().ravel()
        fan_in = layer.weight.shape[1:].numel()
        sigma = np.sqrt(1.0 / fan_in)
        key, sub = jax.random.split(key)
        ref = np.asarray(jax.nn.initializers.lecun_normal()(
            sub, _flax_shape(layer.weight)), np.float64).ravel()
        se = sigma / np.sqrt(2 * len(w))
        for draw in (w, ref):
            assert abs(draw.std() - sigma) <= 5 * se, (name, draw.std(),
                                                       sigma)
            assert abs(draw.mean()) <= 5 * sigma / np.sqrt(len(w)), name
        # truncated at 2 standard deviations of the underlying normal
        bound = 2 * sigma / 0.87962566103423978
        assert np.abs(w).max() <= bound * (1 + 1e-6), name
        assert np.abs(ref).max() <= bound * (1 + 1e-6), name
        assert torch.count_nonzero(layer.bias) == 0, name


@pytest.mark.parametrize("net_name,layer", LARGE)
def test_large_layers_match_jax_distribution(net_name, layer):
    net = NETS[net_name](torch.Generator().manual_seed(1))
    w = getattr(net, layer).weight.detach()
    ref = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(1), _flax_shape(w)), np.float64).ravel()
    assert w.numel() >= 16_000
    assert _ks(w.double().numpy().ravel(), ref) < \
        3 * 1.36 * np.sqrt(2 / w.numel())


@pytest.mark.parametrize("net_name", list(NETS))
def test_generator_seed_fixes_the_weights_and_spares_the_global_rng(
        net_name):
    before = torch.random.get_rng_state()
    a = NETS[net_name](torch.Generator().manual_seed(5)).state_dict()
    b = NETS[net_name](torch.Generator().manual_seed(5)).state_dict()
    c = NETS[net_name](torch.Generator().manual_seed(6)).state_dict()
    assert torch.equal(before, torch.random.get_rng_state())
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a if "weight" in k)


def test_drivers_seed_their_nets_from_seed():
    """cli.mnist and cli.sprites build their nets from --seed's generator,
    leaving the global RNG alone."""
    from svgpvae_tpu_torch import data
    from svgpvae_tpu_torch.cli import mnist, sprites

    base = data.synthetic_digit_base_images("36", per_digit=10, seed=0)
    splits = data.generate_rotated_mnist(base, None, digits="36", seed=0)
    argv = ["--elbo", "SVGPVAE_Hensman", "--dataset", "36", "--L", "4",
            "--ov_joint", "--PCA", "--device", "cpu"]
    before = torch.random.get_rng_state()
    margs = mnist.build_parser().parse_args(argv + ["--seed", "3"])
    vae, _ = mnist.build_model(margs, splits, 202, torch.device("cpu"))
    want = MnistVAE(L=4, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(v, want.state_dict()[k])
               for k, v in vae.state_dict().items())

    corpus = data.generate_synthetic_sprites(3, 2, 50, seed=0)
    sargs = sprites.build_parser().parse_args(
        ["--elbo", "SVGPVAE_Hensman", "--L", "8", "--seed", "3"])
    params, head = sprites.build_model(sargs, corpus, 150,
                                       torch.device("cpu"))
    gen = torch.Generator().manual_seed(3)
    want = {"vae": SpritesVAE(L=8, generator=gen),
            "repr": SpritesReprNet(L=16, generator=gen),
            "head": ClassificationHead(16, 3, generator=gen)}
    for part, net in dict(params, head=head).items():
        if part == "gp":
            continue
        assert all(torch.equal(v, want[part].state_dict()[k])
                   for k, v in net.state_dict().items()), part
    assert torch.equal(before, torch.random.get_rng_state())
