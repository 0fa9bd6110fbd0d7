"""Moving-ball data synthesis (port of svgpvae_tpu/data/ball.py).

  * `make_path_batch`, `make_video_batch`, `make_test_batches`: the
    numpy paths and frames of the fixed test batches, equal to the JAX
    package's (both seed the global numpy RNG with the batch's seed);
  * `VideoBatchFn` / `make_video_batch_fn`: the per-step training
    generator, paths = chol(K_time) @ z with z drawn from a
    torch.Generator on the run's device, rasterized by one broadcast
    comparison (the JAX package's jitted `make_video_batch_fn`).

  * `make_circles` / `make_squares`: the circles/squares latent-geometry
    probes (two rings, a 5x5 lattice) as numpy paths and frames, equal to
    the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

CHOL_RIDGE = 1e-5  # the time kernel's ridge before its Cholesky factor


def make_path_batch(batch: int = 40, tmax: int = 30, lt: float = 5.0,
                    seed=None) -> np.ndarray:
    """x(t), y(t) trajectories from a GP with an RBF time kernel:
    (batch, tmax, 2).  seed=None draws from the global numpy RNG."""
    t = np.arange(tmax)
    cov = np.exp(-0.5 * (t[:, None] - t[None, :]) ** 2 / (lt * lt))
    rng = np.random if seed is None else np.random.RandomState(seed)
    traj = rng.multivariate_normal(np.zeros(tmax), cov, (batch, 2))
    return np.transpose(traj, (0, 2, 1))


def _rasterize(traj_px: np.ndarray, px: int, py: int, r: float) -> np.ndarray:
    """(T, 2) pixel-space trajectory -> (T, px, py) binary ball frames; x
    runs along the second image axis and y along the first."""
    xs = np.arange(px)
    ys = np.arange(py)
    dx2 = (xs[None, None, :] - traj_px[:, 0][:, None, None]) ** 2  # (T,1,px)
    dy2 = (ys[None, :, None] - traj_px[:, 1][:, None, None]) ** 2  # (T,py,1)
    return ((dx2 + dy2) < r * r).astype(np.float32)


def make_video_batch(tmax: int = 50, px: int = 32, py: int = 32,
                     lt: float = 5.0, batch: int = 40, seed: int = 1,
                     r: float = 3.0) -> Tuple[np.ndarray, np.ndarray]:
    """(traj (batch, tmax, 2), vids (batch, tmax, px, py)): paths scaled
    by px/5 around the frame's centre and rasterized."""
    np.random.seed(seed)
    traj0 = make_path_batch(batch=batch, tmax=tmax, lt=lt)
    traj_px = traj0 * (px / 5.0) + 0.5 * px
    vids = np.stack([_rasterize(tp, px, py, r) for tp in traj_px])
    return traj0, vids


def make_test_batches(n_batches: int = 10, tmax: int = 30, px: int = 32,
                      py: int = 32, lt: float = 5.0, batch: int = 35,
                      r: float = 3.0) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The fixed test batches, seeds 0..n_batches-1."""
    return [make_video_batch(tmax=tmax, px=px, py=py, lt=lt, batch=batch,
                             seed=s, r=r) for s in range(n_batches)]


def _pixelate_series(traj: np.ndarray, px: int, py: int,
                     r: float) -> np.ndarray:
    traj_px = traj * (px / 5.0) + 0.5 * px
    return _rasterize(traj_px, px, py, r)


def make_circles(px: int = 32, py: int = 32, r: float = 3.0,
                 tmax: int = 30) -> Tuple[np.ndarray, np.ndarray]:
    """Two concentric rings of latent points (the centre, 8 at radius 1,
    10 at radius 2, then zeros up to tmax) and their frames:
    (traj (tmax, 2), vids (1, tmax, px, py))."""
    n_in, n_out = 8, 10
    ang_in = 2 * np.pi * np.arange(n_in) / n_in
    ang_out = 2 * np.pi * np.arange(n_out) / n_out
    x = np.concatenate([[0], np.sin(ang_in), 2 * np.sin(ang_out)])
    y = np.concatenate([[0], np.cos(ang_in), 2 * np.cos(ang_out)])
    traj = np.stack([x, y], axis=1)  # (19, 2)
    traj = np.vstack([traj, np.zeros((tmax - len(traj), 2))])
    vids = _pixelate_series(traj, px, py, r)[None]
    return traj, vids


def make_squares(px: int = 32, py: int = 32, r: float = 3.0,
                 tmax: int = 30) -> Tuple[np.ndarray, np.ndarray]:
    """A 5x5 lattice of latent points (-2..2, offset by 0.01, row by row,
    then zeros up to tmax) and their frames: (traj (tmax, 2), vids (1,
    tmax, px, py))."""
    base = np.arange(5) - 2
    sq_x = np.tile(base, 5)
    sq_y = np.repeat(base, 5)
    traj = np.stack([sq_x, sq_y], axis=1).astype(float) + 0.01
    traj = np.vstack([traj, np.zeros((tmax - len(traj), 2))])
    vids = _pixelate_series(traj, px, py, r)[None]
    return traj, vids


def time_kernel_cholesky(tmax: int, lt: float) -> np.ndarray:
    """Lower Cholesky factor of the RBF time kernel on 0..tmax-1 plus
    CHOL_RIDGE, in float64."""
    t = np.arange(tmax)
    cov = np.exp(-0.5 * (t[:, None] - t[None, :]) ** 2 / (lt * lt))
    return np.linalg.cholesky(cov + CHOL_RIDGE * np.eye(tmax))


def rasterize(paths: Tensor, px: int, py: int, r: float) -> Tensor:
    """(b, T, 2) pixel-space paths -> (b, T, py, px) binary frames, as
    `_rasterize`, batched."""
    xs = torch.arange(px, dtype=paths.dtype, device=paths.device)
    ys = torch.arange(py, dtype=paths.dtype, device=paths.device)
    dx2 = (xs[None, None, None, :] - paths[:, :, 0, None, None]) ** 2
    dy2 = (ys[None, None, :, None] - paths[:, :, 1, None, None]) ** 2
    return ((dx2 + dy2) < r * r).to(paths.dtype)


class VideoBatchFn:
    """Fresh random ball videos on every call: () -> (batch, tmax, px, py).

    `generator` (a torch.Generator on `device`, seeded by the caller) is
    the only source of randomness; a checkpoint keeps its state."""

    def __init__(self, tmax: int = 30, px: int = 32, py: int = 32,
                 lt: float = 5.0, batch: int = 35, r: float = 3.0,
                 device=None, generator: Optional[torch.Generator] = None,
                 dtype=torch.float32):
        self.tmax, self.px, self.py, self.batch, self.r = tmax, px, py, \
            batch, r
        self.dtype = dtype
        self.device = torch.device(device or "cpu")
        self.chol = torch.as_tensor(time_kernel_cholesky(tmax, lt),
                                    dtype=dtype, device=self.device)
        self.generator = generator

    def paths(self) -> Tensor:
        """(batch, tmax, 2) pixel-space paths chol @ z * 0.2 px + 0.5 px."""
        z = torch.randn((self.tmax, 2 * self.batch), generator=self.generator,
                        dtype=self.dtype, device=self.device)
        paths = (self.chol @ z).reshape(self.tmax, self.batch, 2)
        return paths.transpose(0, 1) * (0.2 * self.px) + 0.5 * self.px

    def __call__(self) -> Tensor:
        return rasterize(self.paths(), self.px, self.py, self.r)


def make_video_batch_fn(tmax: int = 30, px: int = 32, py: int = 32,
                        lt: float = 5.0, batch: int = 35, r: float = 3.0,
                        device=None, seed: int = 1234,
                        dtype=torch.float32) -> VideoBatchFn:
    """A VideoBatchFn drawing from a new generator on `device` seeded by
    `seed` (the JAX driver's data key is PRNGKey(1234), or seed + 1)."""
    device = torch.device(device or "cpu")
    gen = torch.Generator(device=device).manual_seed(seed)
    return VideoBatchFn(tmax, px, py, lt, batch, r, device, gen, dtype)
