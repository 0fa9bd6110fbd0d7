"""Rotated-MNIST dataset factory, loaders and initializers (numpy/scipy
copy of svgpvae_tpu/data/mnist.py, which the port may not import).

Dataset schema (identical to the JAX package's and the reference's
pickles): {'images': (N, 28, 28, 1) float, 'aux_data': (N, 2 + M) float}
with aux rows [image_id, angle_radians, pca_0..pca_{M-1}].

The one change: the PCA object-vector embeddings come from a numpy SVD
(`pca_embeddings`) instead of sklearn, which the port does not depend on.
Everything else (the seven-segment stand-in glyphs, the base images of
a keras-layout mnist.npz or an eval pickle, the rotations, the splits and
their `random`/numpy seeding, the KDE inducing-point initializer) is the
JAX package's code, so a seed gives the same images, ids and angles.
"""

from __future__ import annotations

import math
import pickle
import random
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
from scipy import ndimage, stats


def pca_embeddings(X: np.ndarray, n_components: int,
                   device=None) -> np.ndarray:
    """PCA(n_components).fit_transform(X) by a full SVD of the centred data
    (numpy), or on a CUDA `device` by `pca_embeddings_gram`.  Component
    signs follow sklearn's svd_flip on Vt: the largest-magnitude entry of
    each component is positive."""
    if device is not None and str(device).startswith("cuda"):
        return pca_embeddings_gram(X, n_components, device)
    Xc = X - X.mean(axis=0)
    _, _, vt = np.linalg.svd(Xc, full_matrices=False)
    vt = vt[:n_components]
    signs = np.sign(vt[np.arange(len(vt)), np.argmax(np.abs(vt), axis=1)])
    return Xc @ (vt * signs[:, None]).T


def pca_embeddings_gram(X: np.ndarray, n_components: int,
                        device) -> np.ndarray:
    """The same embeddings from the eigendecomposition of the smaller
    Gram matrix of the centred data (X_c^T X_c or X_c X_c^T), in float64
    on `device`.  A full SVD costs O(rows x columns^2): for the SPRITES
    train frames (50,000 x 12,288) minutes of CPU, where the Gram product
    and an eigendecomposition of order 12,288 run on a card."""
    import torch
    Xc = torch.as_tensor(np.asarray(X), device=device).to(torch.float64)
    Xc = Xc - Xc.mean(dim=0)
    k = n_components
    if Xc.shape[0] >= Xc.shape[1]:
        _, evecs = torch.linalg.eigh(Xc.T @ Xc)      # ascending
        vt = evecs[:, -k:].flip(-1).T                 # (k, n)
    else:
        evals, evecs = torch.linalg.eigh(Xc @ Xc.T)
        u = evecs[:, -k:].flip(-1)                    # (m, k)
        s = torch.sqrt(torch.clamp(evals[-k:].flip(-1), min=0.0))
        vt = (Xc.T @ u / s).T
    signs = torch.sign(vt[torch.arange(k), torch.argmax(vt.abs(), dim=1)])
    return (Xc @ (vt * signs[:, None]).T).cpu().numpy()


# seven-segment layout: (row_lo, row_hi, col_lo, col_hi) in a 28x28 frame
_SEGMENTS = {
    "A": (4, 7, 8, 20),     # top bar
    "B": (5, 14, 18, 21),   # top right
    "C": (14, 23, 18, 21),  # bottom right
    "D": (21, 24, 8, 20),   # bottom bar
    "E": (14, 23, 7, 10),   # bottom left
    "F": (5, 14, 7, 10),    # top left
    "G": (12, 15, 8, 20),   # middle bar
}
_DIGIT_SEGMENTS = {
    "0": "ABCDEF", "1": "BC", "2": "ABGED", "3": "ABGCD", "4": "FGBC",
    "5": "AFGCD", "6": "AFGECD", "7": "ABC", "8": "ABCDEFG", "9": "ABCDFG",
}


def derive_base_images_from_eval(eval_pickle_path: str,
                                 n_target: int = 400,
                                 seed: int = 0) -> np.ndarray:
    """Base (unrotated) digit images recovered from an eval pickle (its
    angle == 0 rows) and augmented to `n_target` images by small random
    rotations (scipy.ndimage.rotate) and shifts from RandomState(seed):
    (n_target, 28, 28)."""
    with open(eval_pickle_path, "rb") as f:
        data = pickle.load(f)
    aux = data["aux_data"]
    base = data["images"][aux[:, 1] == 0.0][..., 0]  # (n_base, 28, 28)

    rng = np.random.RandomState(seed)
    out = [base]
    while sum(len(x) for x in out) < n_target:
        ang = rng.uniform(-12, 12)
        shift = rng.randint(-2, 3, size=2)
        aug = ndimage.rotate(base, ang, axes=(1, 2), reshape=False)
        aug = np.roll(aug, shift, axis=(1, 2))
        out.append(np.clip(aug, 0.0, 1.0))
    return np.concatenate(out)[:n_target]


def load_keras_mnist_npz(npz_path: str, digits: str = "3",
                         per_digit: int = 400,
                         seed: int = 0) -> np.ndarray:
    """Base images from a real MNIST archive in keras's layout
    (`mnist.npz`: uint8 x_train (N, 28, 28), y_train, x_test, y_test):
    `per_digit` train images of each digit, drawn with random.seed(seed)
    + random.sample, in digit-block order, as floats in [0, 1]:
    (len(digits) * per_digit, 28, 28)."""
    with np.load(npz_path) as z:
        x_train = z["x_train"]
        y_train = z["y_train"]
    if x_train.dtype != np.uint8 or x_train.shape[1:] != (28, 28):
        raise ValueError(f"{npz_path}: x_train is {x_train.dtype} "
                         f"{x_train.shape}, keras's layout is uint8 "
                         "(N, 28, 28)")
    x_train = x_train.astype(np.float64) / 255.0

    random.seed(seed)
    blocks = []
    for d in digits:
        x_digit = x_train[y_train == int(d)]
        print(f"Number of images with digit {d}: {len(x_digit)}")
        idx = random.sample(list(range(x_digit.shape[0])), per_digit)
        blocks.append(x_digit[idx])
    return np.concatenate(blocks)


def synthetic_digit_base_images(digits: str, per_digit: int = 400,
                                seed: int = 0) -> np.ndarray:
    """Stand-in multi-digit base images: seven-segment digit glyphs with
    per-instance rotation/shift/blur/intensity augmentation.

    The repository ships no raw MNIST, and the reference's eval pickle
    holds only digit-3 images, so the reference's multi-digit experiments
    (`--dataset 36 / 13679`, utils.py:507-530, MNIST_experiment.py:40-43)
    cannot be derived from real data without a download.
    These glyphs give each digit CLASS a structurally distinct image
    distribution (distinct PCA object-vector embeddings), so the full
    multi-digit pipeline — id blocks, per-digit eval split, N = n*4050
    train frames, GPLVM table of n*400 object vectors — runs end-to-end.
    Swap in real MNIST base images via `generate_rotated_mnist` when
    available.

    Returns (len(digits) * per_digit, 28, 28) float in [0, 1], grouped by
    digit class in the order given (the id-block layout
    generate_rotated_mnist expects).
    """
    rng = np.random.RandomState(seed)
    out = np.empty((len(digits) * per_digit, 28, 28))
    for d_i, d in enumerate(digits):
        glyph = np.zeros((28, 28))
        for seg in _DIGIT_SEGMENTS[d]:
            r0, r1, c0, c1 = _SEGMENTS[seg]
            glyph[r0:r1, c0:c1] = 1.0
        for k in range(per_digit):
            img = glyph * rng.uniform(0.75, 1.0)
            img = ndimage.rotate(img, rng.uniform(-8, 8), reshape=False)
            img = np.roll(img, rng.randint(-1, 2, size=2), axis=(0, 1))
            img = ndimage.gaussian_filter(img, rng.uniform(0.5, 0.9))
            out[d_i * per_digit + k] = np.clip(img, 0.0, 1.0)
    return out


def generate_rotated_mnist(base_images: np.ndarray, save_path: str,
                           nr_angles: int = 16, valid_set_size: float = 0.1,
                           drop_rate: float = 0.25, digits: str = "3",
                           latent_dim_object_vector: int = 8,
                           shuffle_data: bool = True, seed: int = 0
                           ) -> Dict[str, dict]:
    """Rotated-MNIST dataset factory (reference: generate_rotated_MNIST,
    utils.py:507-657), as svgpvae_tpu/data/mnist.py, with a numpy PCA.

    base_images: (N_base, 28, 28) in [0, 1] — the images to rotate (all
    digits concatenated).  Produces train/eval/test dicts, the PCA
    object-vector init, and pickles them under `save_path` with the
    reference's file-naming scheme:
      train_data{digits}.p, eval_data{digits}.p, test_data{digits}.p,
      pca_ov_init{digits}.p  (suffix _{M} when M != 8).

    Pipeline: PCA(M) embeddings of the base images; rotate each image to
    nr_angles angles in [0, 360); aux row = [id, angle_rad, pca...]; split
    the last `valid_set_size` of each digit's ids into eval; hold out one
    random angle as the test set; drop `drop_rate` of the remaining frames.
    """
    random.seed(seed)
    py_random = random
    n_base = len(base_images)
    angles_deg = np.linspace(0, 360, nr_angles + 1)[:-1]

    M = latent_dim_object_vector
    pca_emb = pca_embeddings(base_images.reshape(n_base, -1), M)

    # rotate every base image to every angle
    images = np.empty((n_base, nr_angles, 28, 28), dtype=np.float64)
    for i in range(n_base):
        for j, ang in enumerate(angles_deg):
            images[i, j] = ndimage.rotate(base_images[i], ang, reshape=False)
    aux = np.empty((n_base, nr_angles, 2 + M))
    aux[:, :, 0] = np.arange(n_base)[:, None]
    aux[:, :, 1] = np.radians(angles_deg)[None, :]
    aux[:, :, 2:] = pca_emb[:, None, :]

    images = images.reshape(-1, 28, 28)[..., None]
    aux = aux.reshape(-1, 2 + M)

    # eval split: last `valid_set_size` of ids per digit block
    n_digits = len(digits)
    per_digit = n_base // n_digits
    n_keep = int(per_digit * (1 - valid_set_size))
    keep_rows, eval_rows = [], []
    for d in range(n_digits):
        lo = d * per_digit
        id_block = np.arange(lo, lo + per_digit)
        keep_ids, eval_ids = id_block[:n_keep], id_block[n_keep:]
        keep_rows.append(np.isin(aux[:, 0], keep_ids))
        eval_rows.append(np.isin(aux[:, 0], eval_ids))
    keep_mask = np.logical_or.reduce(keep_rows)
    eval_mask = np.logical_or.reduce(eval_rows)

    eval_images, eval_aux = images[eval_mask], aux[eval_mask]
    images, aux = images[keep_mask], aux[keep_mask]

    if shuffle_data:
        idx = py_random.sample(range(len(eval_images)), len(eval_images))
        eval_images, eval_aux = eval_images[idx], eval_aux[idx]

    # hold out one random angle as the test set
    test_angle = py_random.sample(list(angles_deg), 1)[0]
    test_mask = aux[:, 1] == math.radians(test_angle)
    train_images, train_aux = images[~test_mask], aux[~test_mask]
    test_images, test_aux = images[test_mask], aux[test_mask]

    # drop a fraction of frames
    def drop(imgs, a):
        n_keep_ = int(len(imgs) * (1 - drop_rate))
        if shuffle_data:
            idx = py_random.sample(range(len(imgs)), n_keep_)
        else:
            idx = list(range(n_keep_))
        return imgs[idx], a[idx]

    train_images, train_aux = drop(train_images, train_aux)
    test_images, test_aux = drop(test_images, test_aux)

    out = {
        "train": {"images": train_images, "aux_data": train_aux},
        "eval": {"images": eval_images, "aux_data": eval_aux},
        "test": {"images": test_images, "aux_data": test_aux},
        "pca_ov_init": pca_emb,
        "test_angle": test_angle,
    }

    if save_path is not None:
        path = Path(save_path)
        path.mkdir(parents=True, exist_ok=True)
        suffix = "" if M == 8 else f"_{M}"
        for split in ("train", "eval", "test"):
            with open(path / f"{split}_data{digits}{suffix}.p", "wb") as f:
                pickle.dump(out[split], f)
        with open(path / f"pca_ov_init{digits}{suffix}.p", "wb") as f:
            pickle.dump(pca_emb, f)
    return out


def load_rotated_mnist(mnist_path: str, digits: str = "3", M: int = 8,
                       N_t: Optional[int] = None,
                       seed: int = 0) -> Tuple[dict, dict, dict]:
    """Load train/eval/test dicts from pickles (reference:
    import_rotated_mnist, utils.py:799-875).

    N_t subsamples the per-image angle count (keep N_t of 15 train angles
    per image) for the data-sparsity studies.
    """
    path = Path(mnist_path)
    suffix = "" if M == 8 else f"_{M}"
    splits = {}
    for split in ("train", "eval", "test"):
        with open(path / f"{split}_data{digits}{suffix}.p", "rb") as f:
            splits[split] = pickle.load(f)

    if N_t is not None:
        rng = random.Random(seed)
        train = splits["train"]
        n_rows = len(train["aux_data"])
        mask_unit = [True] * N_t + [False] * (15 - N_t)
        mask = np.concatenate([
            rng.sample(mask_unit, 15) for _ in range(n_rows // 15)])
        mask = np.concatenate([mask, np.zeros(n_rows - len(mask), bool)])
        splits["train"] = {"images": train["images"][mask],
                           "aux_data": train["aux_data"][mask]}

    return splits["train"], splits["eval"], splits["test"]


def generate_init_inducing_points(train_data: dict, n: float = 5,
                                  nr_angles: int = 16, seed_init: int = 0,
                                  remove_test_angle: Optional[int] = None,
                                  use_pca: bool = False, M: int = 8,
                                  seed: int = 0) -> np.ndarray:
    """Inducing-point initializer (reference: generate_init_inducing_points,
    utils.py:691-744).

    For each of nr_angles angles sample `n` object vectors — from a gaussian
    KDE of the train PCA embeddings (use_pca) or N(0, 1.5^2) — and prepend
    [running_id, angle].  Fractional n < 1 subsamples int(n * nr_angles)
    angles with one vector each.  Accepts the loaded train dict (not a
    pickle path).
    """
    rng = random.Random(seed)
    aux = train_data["aux_data"]
    angles = np.linspace(0, 2 * np.pi, nr_angles + 1)[:-1]

    if n < 1:
        indices = rng.sample(range(nr_angles), int(n * nr_angles))
        n = 1
    else:
        indices = range(nr_angles)

    points = []
    for i in indices:
        if i == remove_test_angle:
            continue
        kde_seed = seed_init + i
        if use_pca:
            cols = []
            for pca_ax in range(2, 2 + M):
                kde = stats.gaussian_kde(aux[:, pca_ax])
                cols.append(kde.resample(int(n), seed=kde_seed))
            obj = np.concatenate(cols).T
        else:
            obj = np.random.RandomState(kde_seed).normal(
                0, 1.5, int(n) * M).reshape(int(n), M)
        points.append(np.hstack([np.full((int(n), 1), angles[i]), obj]))

    points = np.concatenate(points)
    ids = np.arange(len(points))[:, None].astype(points.dtype)
    return np.hstack([ids, points])
