"""The port's real-data MNIST bootstrap against the JAX package's.

With no dataset pickles under --mnist_data_path, the JAX driver's
ensure_dataset builds them from a keras-layout <mnist_data_path>/mnist.npz
(any digit set) or, for --dataset 3, from the reference's eval pickle
(REF_EVAL_PICKLE, a fixed absolute path), and refuses otherwise.  The
port's load_splits takes the same order, and looks for the eval pickle
under --mnist_data_path (named by its REF_EVAL_PICKLE).  Here, in a tmp
dir (JAX's constant monkeypatched, the same pickle written for the
port into its data directory):

  * the port's load_keras_mnist_npz and derive_base_images_from_eval
    equal the JAX package's bit for bit;
  * the pickles the port's load_splits writes from an archive (--dataset
    36) and from an eval pickle (--dataset 3) equal those of JAX's
    ensure_dataset bit for bit, but for the PCA object-vector columns and
    table, held to tests/test_torch_mnist_data.py's PCA_ATOL (a numpy SVD
    in the port, sklearn in JAX);
  * without --synthetic_digits and without either file the port refuses
    with JAX's words; with --synthetic_digits and no eval pickle it
    generates the stand-in glyphs, where JAX first asserts that the
    pickle exists (a deliberate divergence, as is the pickle's place).

The fixture archive is written in keras's layout as
tests/test_e2e_realdata.py writes it; its images are built from a few
fixed patterns whose variances halve from one to the next, so that the
leading principal components are well separated: sklearn's randomized
solver (JAX) then lands within PCA_ATOL of the port's exact SVD, which
it does not on patterns of near-equal variance (6e-4 apart at a ratio
of 0.8 on the eval pickle's 400 derived images).
"""

import os
import pickle

import numpy as np
import pytest

from svgpvae_tpu import data as jdata
from svgpvae_tpu.cli import mnist as jmnist
from svgpvae_tpu_torch import data as tdata
from svgpvae_tpu_torch.cli import mnist as tmnist
from test_torch_mnist_data import PCA_ATOL
from torch_threads import _torch_threads  # noqa: E402,F401

N_PATTERNS = 12


def _patterned_images(rng, n, digit):
    """n uint8 28x28 images: a digit-dependent band plus N_PATTERNS fixed
    smooth patterns with weights of falling variance, and a little
    noise."""
    yy, xx = np.mgrid[:28, :28] / 27.0
    patterns = np.stack([np.sin(np.pi * (k % 4 + 1) * xx + k)
                         * np.cos(np.pi * (k // 4 + 1) * yy)
                         for k in range(N_PATTERNS)])
    scales = 40.0 * 0.5 ** np.arange(N_PATTERNS)
    img = 90.0 + np.einsum("nk,kij->nij", rng.randn(n, N_PATTERNS) * scales,
                           patterns)
    row = 4 + 3 * int(digit)
    img[:, row:row + 4, 6:22] += 80.0
    img += rng.rand(n, 28, 28) * 2.0
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_keras_mnist_npz(path, digits=("3", "6"), per_digit=420, seed=0):
    """An archive in keras's mnist.npz layout (uint8 x_train (N, 28, 28),
    y_train (N,), x_test, y_test), with decoy 7s the selection skips."""
    rng = np.random.RandomState(seed)
    xs = [_patterned_images(rng, per_digit, d) for d in digits]
    ys = [np.full(per_digit, int(d), dtype=np.uint8) for d in digits]
    xs.append(_patterned_images(rng, 50, "7"))
    ys.append(np.full(50, 7, dtype=np.uint8))
    x, y = np.concatenate(xs), np.concatenate(ys)
    perm = rng.permutation(len(x))
    np.savez(path, x_train=x[perm], y_train=y[perm], x_test=x[:10],
             y_test=y[:10])


def _write_eval_pickle(path, n_ids=24, n_angles=4, M=8, seed=1):
    """A digit-3 eval pickle in the dataset schema: every id at n_angles
    angles, the first of them 0 (the unrotated base images)."""
    rng = np.random.RandomState(seed)
    base = _patterned_images(rng, n_ids, "3").astype(np.float64) / 255.0
    angles = np.linspace(0.0, 2 * np.pi, n_angles, endpoint=False)
    images = np.repeat(base, n_angles, axis=0)[..., None]
    aux = np.c_[np.repeat(np.arange(n_ids), n_angles),
                np.tile(angles, n_ids), rng.randn(n_ids * n_angles, M)]
    with open(path, "wb") as f:
        pickle.dump({"images": images, "aux_data": aux}, f)


@pytest.fixture
def eval_pickle(tmp_path, monkeypatch):
    """JAX's REF_EVAL_PICKLE pointed at a path in tmp_path; yields (path,
    write(data_path)), write putting the pickle there and, for the port,
    at <data_path>/REF_EVAL_PICKLE."""
    path = str(tmp_path / "ref" / "eval_data3.p")
    monkeypatch.setattr(jmnist, "REF_EVAL_PICKLE", path)

    def write(data_path):
        for p in (path, os.path.join(data_path, tmnist.REF_EVAL_PICKLE)):
            os.makedirs(os.path.dirname(p), exist_ok=True)
            _write_eval_pickle(p)

    return path, write


def _args(package, data_path, dataset, *extra):
    return package.build_parser().parse_args(
        ["--dataset", dataset, "--mnist_data_path", data_path] + list(extra))


def _pickles(data_path, dataset):
    out = {}
    for name in ("train", "eval", "test", "pca_ov_init"):
        with open(os.path.join(data_path, f"{name}_data{dataset}.p"
                               if name != "pca_ov_init" else
                               f"pca_ov_init{dataset}.p"), "rb") as f:
            out[name] = pickle.load(f)
    return out


def _assert_pickles_match(got, want):
    np.testing.assert_allclose(got["pca_ov_init"], want["pca_ov_init"],
                               rtol=0, atol=PCA_ATOL)
    for split in ("train", "eval", "test"):
        g, w = got[split], want[split]
        assert g.keys() == w.keys()
        np.testing.assert_array_equal(g["images"], w["images"])
        np.testing.assert_array_equal(g["aux_data"][:, :2],
                                      w["aux_data"][:, :2])
        np.testing.assert_allclose(g["aux_data"][:, 2:], w["aux_data"][:, 2:],
                                   rtol=0, atol=PCA_ATOL)


def test_base_image_loaders_are_bit_identical(tmp_path, eval_pickle):
    npz = str(tmp_path / "mnist.npz")
    _write_keras_mnist_npz(npz)
    for digits, seed in (("36", 0), ("6", 5)):
        want = jdata.load_keras_mnist_npz(npz, digits=digits, per_digit=400,
                                          seed=seed)
        got = tdata.load_keras_mnist_npz(npz, digits=digits, per_digit=400,
                                         seed=seed)
        assert got.dtype == want.dtype and got.shape == (400 * len(digits),
                                                         28, 28)
        np.testing.assert_array_equal(got, want)
    path, write = eval_pickle
    write(str(tmp_path / "data"))
    want = jdata.derive_base_images_from_eval(path, n_target=400, seed=2)
    got = tdata.derive_base_images_from_eval(path, n_target=400, seed=2)
    assert got.shape == (400, 28, 28)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("source", ["keras_npz", "eval_pickle"])
def test_load_splits_matches_jax_ensure_dataset(source, tmp_path,
                                                eval_pickle):
    """--dataset 36 from the archive (the eval pickle is absent: JAX's
    branch for it comes first), --dataset 3 from the eval pickle."""
    dataset = "36" if source == "keras_npz" else "3"
    dirs = {k: str(tmp_path / k) for k in ("jax", "torch")}
    for d in dirs.values():
        os.makedirs(d)
        if source == "keras_npz":
            _write_keras_mnist_npz(os.path.join(d, "mnist.npz"))
    if source == "eval_pickle":
        eval_pickle[1](dirs["torch"])
    jmnist.ensure_dataset(_args(jmnist, dirs["jax"], dataset))
    splits = tmnist.load_splits(_args(tmnist, dirs["torch"], dataset))
    want, got = _pickles(dirs["jax"], dataset), _pickles(dirs["torch"],
                                                         dataset)
    _assert_pickles_match(got, want)
    n_digits = len(dataset)
    assert len(got["train"]["images"]) == 4050 * n_digits
    # load_splits hands back what it pickled
    for split in ("train", "eval", "test"):
        np.testing.assert_array_equal(splits[split]["images"],
                                      got[split]["images"])
    np.testing.assert_array_equal(splits["pca_ov_init"], got["pca_ov_init"])


@pytest.mark.parametrize("dataset,with_eval", [("36", False), ("3", False),
                                               ("36", True)])
def test_refusals_match_jax(dataset, with_eval, tmp_path, eval_pickle):
    """No pickles, no archive, no --synthetic_digits: JAX's reasons."""
    data_path = str(tmp_path / "none")
    if with_eval:
        eval_pickle[1](data_path)
    with pytest.raises((AssertionError, SystemExit)) as want:
        jmnist.ensure_dataset(_args(jmnist, data_path, dataset))
    with pytest.raises(SystemExit) as got:
        tmnist.load_splits(_args(tmnist, data_path, dataset))
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(
        "cannot derive dataset '36'" if with_eval else
        "no dataset pickles and no shipped eval pickle")


def test_synthetic_digits_without_the_eval_pickle(tmp_path, eval_pickle):
    """The deliberate divergence: JAX asserts the eval pickle exists
    before it takes --synthetic_digits; the port generates the glyphs,
    the dataset of data.generate_rotated_mnist on them."""
    data_path = str(tmp_path / "synthetic")
    with pytest.raises(AssertionError):
        jmnist.ensure_dataset(_args(jmnist, data_path, "3",
                                    "--synthetic_digits"))
    splits = tmnist.load_splits(_args(tmnist, data_path, "3",
                                      "--synthetic_digits"))
    base = tdata.synthetic_digit_base_images("3", per_digit=400, seed=0)
    want = tdata.generate_rotated_mnist(base, None, digits="3", seed=0)
    for split in ("train", "eval", "test"):
        np.testing.assert_array_equal(splits[split]["images"],
                                      want[split]["images"])
        np.testing.assert_array_equal(splits[split]["aux_data"],
                                      want[split]["aux_data"])


def test_eval_pickle_is_read_from_the_data_path_only(tmp_path, eval_pickle):
    """The port reads no file outside --mnist_data_path: with the eval
    pickle at JAX's path and under another directory, not under the data
    path, it refuses as without one (and derives from it under the data
    path: test_load_splits_matches_jax_ensure_dataset)."""
    eval_pickle[1](str(tmp_path / "elsewhere"))
    with pytest.raises(SystemExit) as got:
        tmnist.load_splits(_args(tmnist, str(tmp_path / "data"), "3"))
    assert str(got.value) == ("no dataset pickles and no shipped eval "
                              "pickle to derive from")
