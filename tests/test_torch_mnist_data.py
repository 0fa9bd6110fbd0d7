"""The port's rotated-MNIST data and networks against the JAX package.

  * the stand-in glyphs are bit-identical for a seed, and so is the rotated
    dataset (images, ids, angles, splits) apart from the PCA columns, which
    come from a numpy SVD in the port and from sklearn in JAX: within 1e-5
    (sklearn's randomized solver converges to ~1e-7 of the ~5.0 scale);
  * the KDE inducing-point initializer is bit-identical on the same data;
  * the pickles interoperate;
  * MnistVAE encode/decode at float32 on weights converted from flax:
    rtol 1e-4 / atol 1e-5 (the same fp32 convolutions and matmuls, summed
    in other orders).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from sklearn.decomposition import PCA

from svgpvae_tpu import data as jdata, nn as jnets
from svgpvae_tpu_torch import data as tdata
from svgpvae_tpu_torch.nn import MnistVAE
from svgpvae_tpu_torch.utils.convert import mnist_vae_state, _module

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
from export_jax_params import flatten_params  # noqa: E402
from torch_threads import _torch_threads  # noqa: E402,F401

PCA_ATOL = 1e-5


@pytest.fixture(scope="module")
def datasets():
    base_j = jdata.synthetic_digit_base_images("36", per_digit=8, seed=3)
    base_t = tdata.synthetic_digit_base_images("36", per_digit=8, seed=3)
    kw = dict(digits="36", latent_dim_object_vector=4, seed=3)
    return (base_j, base_t, jdata.generate_rotated_mnist(base_j, None, **kw),
            tdata.generate_rotated_mnist(base_t, None, **kw))


def test_glyphs_are_bit_identical(datasets):
    base_j, base_t, _, _ = datasets
    assert base_t.dtype == base_j.dtype
    np.testing.assert_array_equal(base_t, base_j)


def test_rotated_dataset_matches_jax(datasets):
    _, _, want, got = datasets
    assert got["test_angle"] == want["test_angle"]
    np.testing.assert_allclose(got["pca_ov_init"], want["pca_ov_init"],
                               atol=PCA_ATOL)
    for split in ("train", "eval", "test"):
        np.testing.assert_array_equal(got[split]["images"],
                                      want[split]["images"])
        np.testing.assert_array_equal(got[split]["aux_data"][:, :2],
                                      want[split]["aux_data"][:, :2])
        np.testing.assert_allclose(got[split]["aux_data"][:, 2:],
                                   want[split]["aux_data"][:, 2:],
                                   atol=PCA_ATOL)


def test_numpy_pca_matches_sklearn_on_the_north_star_glyphs():
    X = tdata.synthetic_digit_base_images("36", per_digit=400, seed=0)
    X = X.reshape(len(X), -1)
    np.testing.assert_allclose(tdata.pca_embeddings(X, 8),
                               PCA(n_components=8).fit_transform(X),
                               atol=PCA_ATOL)


@pytest.mark.parametrize("shape", [(300, 40), (30, 400)])
def test_gram_pca_matches_the_svd_pca(shape):
    """The float64 Gram eigendecomposition that a CUDA device takes
    (covariance when rows >= columns, else the row Gram), run here on the
    CPU, against the numpy SVD: the same embeddings, signs included."""
    rng = np.random.RandomState(3)
    X = rng.rand(*shape) @ np.diag(np.linspace(3.0, 0.5, shape[1]))
    np.testing.assert_allclose(
        tdata.pca_embeddings_gram(X, 6, "cpu"),
        tdata.pca_embeddings(X, 6), rtol=0, atol=1e-9)


@pytest.mark.parametrize("use_pca,n", [(True, 2), (False, 2), (True, 0.5)])
def test_inducing_point_init_is_bit_identical(datasets, use_pca, n):
    _, _, want, _ = datasets
    kw = dict(n=n, use_pca=use_pca, M=4, seed=1)
    np.testing.assert_array_equal(
        tdata.generate_init_inducing_points(want["train"], **kw),
        jdata.generate_init_inducing_points(want["train"], **kw))


def test_pickles_interoperate(tmp_path, datasets):
    base_j, _, _, _ = datasets
    kw = dict(digits="36", latent_dim_object_vector=4, seed=3)
    tdata.generate_rotated_mnist(base_j, str(tmp_path), **kw)
    for N_t in (None, 7):
        got = tdata.load_rotated_mnist(str(tmp_path), digits="36", M=4,
                                       N_t=N_t)
        want = jdata.load_rotated_mnist(str(tmp_path), digits="36", M=4,
                                        N_t=N_t)
        for g, w in zip(got, want):
            for key in ("images", "aux_data"):
                np.testing.assert_array_equal(g[key], w[key])


@pytest.fixture(scope="module")
def vaes():
    L = 5
    vae = jnets.MnistVAE(L=L)
    params = vae.init(jax.random.PRNGKey(2), jnp.zeros((2, 28, 28, 1)))
    t_vae = MnistVAE(L=L)
    t_vae.load_state_dict(mnist_vae_state(
        _module(flatten_params({"vae": params}), "vae/params")))
    return vae, params, t_vae


def test_mnist_vae_encode_matches_flax(vaes):
    vae, params, t_vae = vaes
    x = np.random.RandomState(0).rand(6, 28, 28, 1).astype(np.float32)
    want = vae.apply(params, jnp.asarray(x), method=vae.encode)
    got = t_vae.encode(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)


def test_mnist_vae_decode_matches_flax(vaes):
    vae, params, t_vae = vaes
    z = np.random.RandomState(1).randn(6, 5).astype(np.float32)
    want = vae.apply(params, jnp.asarray(z), method=vae.decode)
    got = t_vae.decode(torch.from_numpy(z))
    assert got.shape == (6, 28, 28, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
