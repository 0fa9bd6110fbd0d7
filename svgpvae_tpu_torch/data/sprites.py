"""SPRITES corpus: synthetic stand-in, sharded .npz IO, the batcher and
the PCA initializers (numpy and scipy only).

A copy of the numpy data code of svgpvae_tpu/data/sprites.py, kept here
because importing anything from `svgpvae_tpu` loads jax.
`generate_synthetic_sprites` draws the same numbers in the same order as
the JAX package's generator, so a seed gives a bit-identical corpus.
`sprites_pca_init` takes its PCA from `data.mnist.pca_embeddings` (numpy
SVD, or a float64 Gram eigendecomposition on a CUDA device) where the JAX
package calls sklearn's.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, Iterator, Tuple

import numpy as np
from scipy import stats

from svgpvae_tpu_torch.data.mnist import pca_embeddings

N_ACTIONS = 72          # 9 actions x 8 frames
FRAMES_PER_ACTION = 8


def generate_synthetic_sprites(n_train_chars: int = 20,
                               n_test_chars: int = 6,
                               n_frames_train: int = 50,
                               seed: int = 0) -> Dict[str, dict]:
    """Synthetic corpus with the SPRITES layout.

    Each character gets a random colour/texture signature and each of the
    72 action-frames a random spatial pattern; a frame blends the two.
    Splits: train (n_train_chars * n_frames_train frames, aux
    [char_id, action_frame_id]), test_action (the other frames of the
    train characters), test_character (all 72 frames of unseen
    characters).
    """
    rng = np.random.RandomState(seed)
    h = w = 64

    def char_signature():
        base = rng.rand(3)
        tex = rng.rand(8, 8, 3) * 0.5
        sig = np.kron(tex, np.ones((8, 8, 1))) + base[None, None]
        return np.clip(sig / 2.0, 0, 1)

    action_patterns = rng.rand(N_ACTIONS, h, w, 1) * 0.5

    def frames_for(sig):
        return np.clip(sig[None] * 0.7 + action_patterns * 0.6, 0, 1
                       ).astype(np.float32)

    train_f, train_a, ta_f, ta_a = [], [], [], []
    for c in range(n_train_chars):
        frames = frames_for(char_signature())  # (72, 64, 64, 3)
        ids = rng.choice(N_ACTIONS, n_frames_train, replace=False)
        ids.sort()
        test_ids = np.setdiff1d(np.arange(N_ACTIONS), ids)
        train_f.append(frames[ids])
        train_a.append(np.stack([np.full(len(ids), c), ids], axis=1))
        ta_f.append(frames[test_ids])
        ta_a.append(np.stack([np.full(len(test_ids), c), test_ids], axis=1))

    tc_f, tc_a = [], []
    for c in range(n_test_chars):
        tc_f.append(frames_for(char_signature()))
        tc_a.append(np.stack([np.full(N_ACTIONS, c), np.arange(N_ACTIONS)],
                             axis=1))

    return {
        "train": {"frames": np.concatenate(train_f),
                  "aux_data": np.concatenate(train_a).astype(np.float32)},
        "test_action": {"frames": np.concatenate(ta_f),
                        "aux_data": np.concatenate(ta_a).astype(np.float32)},
        "test_character": {"frames": np.concatenate(tc_f),
                           "aux_data": np.concatenate(tc_a).astype(
                               np.float32)},
    }


def save_sprites_shards(splits: Dict[str, dict], save_path: str,
                        shard_size: int = 2000) -> None:
    """Persist splits as sharded .npz files plus the train pickle, in the
    JAX package's layout (either package loads the other's shards)."""
    path = Path(save_path)
    for split, data in splits.items():
        d = path / split
        d.mkdir(parents=True, exist_ok=True)
        n = len(data["frames"])
        for s, lo in enumerate(range(0, n, shard_size)):
            np.savez(d / f"{split}{s + 1}.npz",
                     frames=data["frames"][lo:lo + shard_size],
                     aux_data=data["aux_data"][lo:lo + shard_size])
    with open(path / "sprites_train_dict.p", "wb") as f:
        pickle.dump(splits["train"], f)


def load_sprites(sprites_path: str) -> Dict[str, dict]:
    """Load the sharded .npz splits back into memory."""
    path = Path(sprites_path)
    out = {}
    for split in ("train", "test_action", "test_character"):
        shards = sorted((path / split).glob("*.npz"),
                        key=lambda p: int("".join(filter(str.isdigit,
                                                         p.stem)) or 0))
        if not shards:
            raise FileNotFoundError(f"no {split} shards under {path}")
        frames, aux = [], []
        for s in shards:
            with np.load(s) as z:
                frames.append(z["frames"])
                aux.append(z["aux_data"])
        out[split] = {"frames": np.concatenate(frames),
                      "aux_data": np.concatenate(aux)}
    return out


def has_raw_sprites_npys(path: str) -> bool:
    """True when the published raw corpus layout is present at `path`."""
    return (Path(path) / "walk_front_frames_train.npy").exists()


def sprites_batch_iterator(data: dict, batch_size: int
                           ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Dataset-order batches of (frames, aux_data); the last may be
    short."""
    n = len(data["frames"])
    for lo in range(0, n, batch_size):
        yield (data["frames"][lo:lo + batch_size],
               data["aux_data"][lo:lo + batch_size])


def sprites_pca_init(train_dict: dict, m: int = 15, L_action: int = 6,
                     L_character: int = 16, seed: int = 42,
                     n_action: int = N_ACTIONS, device=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """PCA initializers (reference: sprites_PCA_init).

    GPLVM action table: PCA(L_action) of the per-action-frame mean images
    -> (n_action, L_action).  Inducing points: each action vector tiled m
    times beside m draws from a gaussian KDE of each axis of the global
    PCA(L_character) embedding -> (n_action * m, L_action + L_character).
    A CUDA `device` takes the PCAs there (`pca_embeddings`).
    """
    frames = train_dict["frames"]
    aux = train_dict["aux_data"]
    global_mean = frames.mean(axis=0).reshape(-1)

    def action_mean(a):
        sel = frames[aux[:, 1] == a]
        # an action missing from a small train split takes the mean frame
        return sel.mean(axis=0).reshape(-1) if len(sel) else global_mean

    mean_frames = np.stack([action_mean(a) for a in range(n_action)])
    gplvm_action = pca_embeddings(mean_frames, L_action, device)
    global_emb = pca_embeddings(frames.reshape(len(frames), -1), L_character,
                                device)

    points = []
    for i in range(n_action):
        cols = [stats.gaussian_kde(global_emb[:, ax]).resample(
            m, seed=seed).reshape(-1) for ax in range(L_character)]
        char_vecs = np.array(cols).T  # (m, L_character)
        points.append(np.hstack([np.tile(gplvm_action[i], (m, 1)),
                                 char_vecs]))
    return gplvm_action, np.concatenate(points)
