"""SPRITES corpus: synthetic stand-in, the published raw npy corpus and
its preprocessing, sharded .npz IO, the batcher and the PCA initializers
(numpy and scipy only).

A copy of the numpy data code of svgpvae_tpu/data/sprites.py, kept here
because importing anything from `svgpvae_tpu` loads jax.
`generate_synthetic_sprites` draws the same numbers in the same order as
the JAX package's generator, so a seed gives a bit-identical corpus, and
`preprocess_sprites` (the raw corpus's character grouping and its seeded
50-frame train samples) gives the JAX package's splits exactly.
`sprites_pca_init` takes its PCA from `data.mnist.pca_embeddings` (numpy
SVD, or a float64 Gram eigendecomposition on a CUDA device) where the JAX
package calls sklearn's.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, Iterator, List, Tuple

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


RAW_SPRITES_ACTIONS = ("walk", "spellcard", "slash")
RAW_SPRITES_DIRECTIONS = ("front", "left", "right")


def load_raw_sprites_npys(path: str):
    """Load the external sprites repo's raw .npy corpus in its EXACT
    published file layout.

    The reference ingests the corpus through the external repo's
    `sprites_act` (SPRITES_utils.py:20,66 — `from load_sprites import
    sprites_act`), which reads, for each of the 9 action-direction
    combinations `{walk,spellcard,slash}_{front,left,right}`:

        <path>/<action>_<direction>_frames_train.npy      (N_tr, 8, 64, 64, 3)
        <path>/<action>_<direction>_frames_test.npy       (N_te, 8, 64, 64, 3)
        <path>/<action>_<direction>_attributes_train.npy  (N_tr, 8, 4, 6)
        <path>/<action>_<direction>_attributes_test.npy   (N_te, 8, 4, 6)

    and synthesizes the 9-way action one-hot `d[:, :, 3*act + dir] = 1`.
    Returns the same 6-tuple convention `(X_train, X_test, A_train,
    A_test, D_train, D_test)` so `preprocess_sprites` consumes it
    unchanged — pointing the driver at a directory of the published npys
    works with zero code change.
    """
    p = Path(path)
    out = {"train": [[], [], []], "test": [[], [], []]}
    for act_i, action in enumerate(RAW_SPRITES_ACTIONS):
        for dir_i, direction in enumerate(RAW_SPRITES_DIRECTIONS):
            label = 3 * act_i + dir_i
            for split in ("train", "test"):
                x = np.load(p / f"{action}_{direction}_frames_{split}.npy")
                a = np.load(
                    p / f"{action}_{direction}_attributes_{split}.npy")
                if (x.shape[1:] != (FRAMES_PER_ACTION, 64, 64, 3)
                        or a.shape[:2] != x.shape[:2] or a.ndim != 4
                        or a.shape[3] != 6):
                    raise ValueError(
                        f"{action}_{direction} {split}: frames {x.shape} "
                        f"and attributes {a.shape}, expected (N, 8, 64, "
                        "64, 3) and (N, 8, 4, 6)")
                d = np.zeros((x.shape[0], x.shape[1], 9), dtype=x.dtype)
                d[:, :, label] = 1.0
                xs, As, ds = out[split]
                xs.append(x)
                As.append(a)
                ds.append(d)
    x_tr, a_tr, d_tr = (np.concatenate(v) for v in out["train"])
    x_te, a_te, d_te = (np.concatenate(v) for v in out["test"])
    return x_tr, x_te, a_tr, a_te, d_tr, d_te


def has_raw_sprites_npys(path: str) -> bool:
    """True when the published raw corpus layout is present at `path`."""
    return (Path(path) / "walk_front_frames_train.npy").exists()


def preprocess_sprites(x_train, a_train, d_train, x_test, a_test, d_test,
                       n_frames_train: int = 50,
                       seed: int = 0) -> Dict[str, dict]:
    """Reshape a raw SPRITES corpus into (frames, aux_data) splits.

    Mirrors preprocess_sprite_SVGPVAE (SPRITES_utils.py:45-131): group
    sequences by character attribute signature, sample `n_frames_train` of
    each train character's 72 frames for training (rest -> test_action),
    keep all frames of unseen characters as test_character.  Inputs follow
    the external sprites repo's `sprites_act` return convention:
    x (sequences, T, 64, 64, 3), a (attribute one-hots), d (action one-hots).
    """
    rng = np.random.RandomState(seed)

    def group_by_character(attrs) -> Dict[str, List[int]]:
        groups: Dict[str, List[int]] = {}
        for i in range(len(attrs)):
            key = str(list(np.nonzero(attrs[i][0])[1]))
            groups.setdefault(key, []).append(i)
        return groups

    def build(x, a, d, sample_train: bool):
        groups = group_by_character(a)
        f_tr, a_tr, f_te, a_te = [], [], [], []
        for char_idx, seq_ids in enumerate(groups.values()):
            frames = x[seq_ids].reshape(-1, 64, 64, 3)
            actions = [np.nonzero(d[i][0])[0][0] for i in seq_ids]
            frame_ids = np.concatenate([
                np.arange(act * FRAMES_PER_ACTION,
                          (act + 1) * FRAMES_PER_ACTION) for act in actions])
            if sample_train:
                tr = np.sort(rng.choice(N_ACTIONS, n_frames_train,
                                        replace=False))
                te = np.setdiff1d(np.arange(N_ACTIONS), tr)
                f_tr.append(frames[tr])
                a_tr.append(np.stack([np.full(len(tr), char_idx),
                                      frame_ids[tr]], axis=1))
                f_te.append(frames[te])
                a_te.append(np.stack([np.full(len(te), char_idx),
                                      frame_ids[te]], axis=1))
            else:
                f_tr.append(frames)
                a_tr.append(np.stack([np.full(len(frames), char_idx),
                                      frame_ids], axis=1))
        out = (np.concatenate(f_tr), np.concatenate(a_tr).astype(np.float32))
        if sample_train:
            return out + (np.concatenate(f_te),
                          np.concatenate(a_te).astype(np.float32))
        return out

    tr_f, tr_a, ta_f, ta_a = build(x_train, a_train, d_train, True)
    tc_f, tc_a = build(x_test, a_test, d_test, False)
    return {
        "train": {"frames": tr_f, "aux_data": tr_a},
        "test_action": {"frames": ta_f, "aux_data": ta_a},
        "test_character": {"frames": tc_f, "aux_data": tc_a},
    }


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
