"""Metrics, result persistence and the NaN sentinel (port of
svgpvae_tpu/utils/metrics.py).

  * `mse_rotation` -- the moving-ball trajectory metric: affine-align
    predicted latents to the true 2-D paths by least squares and report
    the residual MSE; `post_process_full_cholesky` reduces a
    full-Cholesky head's rows to marginal variances first;
  * `ResultSaver` -- named-column row appender persisted as CSV; recovers
    an existing file whose header matches (a resumed run appends to it),
    else starts a timestamped sibling;
  * `count_params` -- the parameter count of a {part: module or GP
    parameter dataclass} dict;
  * `check_finite` / `NonFiniteLossError` -- the drivers' fail-fast
    sentinel on each epoch's (ball: each eval's) metrics, with an
    emergency checkpoint <run_dir>/ckpt_nan/<step>.pt.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from svgpvae_tpu_torch.train.state import named_tensors
from svgpvae_tpu_torch.utils.checkpoint import save_checkpoint


def mse_rotation(X: np.ndarray, Y: np.ndarray,
                 VX: Optional[np.ndarray] = None,
                 full_cholesky: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray, float, np.ndarray]:
    """Least-squares affine alignment of latents X onto true paths Y.

    X, Y: (batch, tmax, 2); VX optional per-point diagonal variances, or
    with `full_cholesky` (batch, tmax, 2 tmax) stacked Cholesky rows.
    Returns (X_aligned, W (3, 2), MSE, VX_aligned (batch, tmax, 2, 2)).
    """
    batch, tmax, _ = X.shape
    if VX is not None and full_cholesky:
        VX = post_process_full_cholesky(VX, tmax)
    Xf = np.concatenate([X.reshape(-1, 2), np.ones((batch * tmax, 1))],
                        axis=1)
    Yf = Y.reshape(-1, 2)
    W, residuals, _, _ = np.linalg.lstsq(Xf, Yf, rcond=None)
    mse = float(residuals.sum()) if len(residuals) == 2 else float("nan")
    X_rot = (Xf @ W).reshape(batch, tmax, 2)

    VX_rot = np.zeros((batch, tmax, 2, 2))
    if VX is not None:
        A = W[:2, :]  # (2, 2) linear part
        VX_rot = np.einsum("ij,btj,jk->btik", A.T, VX, A)
    return X_rot, W, mse, VX_rot


def post_process_full_cholesky(arr: np.ndarray, tmax: int) -> np.ndarray:
    """(batch, tmax, 2 tmax) stacked lower-triangular Cholesky rows ->
    (batch, tmax, 2) marginal variances."""
    def tri_var(block):
        tri = np.tril(block)
        return np.diagonal(tri @ np.transpose(tri, (0, 2, 1)),
                           axis1=1, axis2=2)
    return np.stack([tri_var(arr[:, :, :tmax]), tri_var(arr[:, :, tmax:])],
                    axis=2)


class ResultSaver:
    """Append named-value rows; flush to CSV every `flush_every` rows."""

    def __init__(self, path: str, colnames: Sequence[str],
                 flush_every: int = 10):
        self.colnames = list(colnames)
        self.flush_every = flush_every
        self._rows: List[list] = []
        if os.path.exists(path):
            with open(path) as f:
                header = f.readline().strip().split(",")
            if header != self.colnames:
                path = f"{path}_{time.time()}"
        self.path = path
        if not os.path.exists(path):
            with open(path, "w", newline="") as f:
                csv.writer(f).writerow(self.colnames)

    def __call__(self, row: Sequence) -> None:
        if len(row) != len(self.colnames):
            raise ValueError(f"expected {len(self.colnames)} values, got "
                             f"{len(row)}")
        self._rows.append([_scalarize(v) for v in row])
        if len(self._rows) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if not self._rows:
            return
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerows(self._rows)
        self._rows = []


def _scalarize(v):
    arr = np.asarray(v)
    if arr.ndim == 0:
        return arr.item()
    return np.array2string(arr.ravel(), max_line_width=10**9, threshold=64)


def count_params(params: dict) -> int:
    """Total element count of every tensor of `params` (see
    train.named_tensors)."""
    return sum(t.numel() for t in named_tensors(params).values())


class NonFiniteLossError(RuntimeError):
    """Raised by `check_finite` when a training metric goes NaN/inf."""


def check_finite(values, step: int,
                 state: Union[dict, Callable[[], dict], None] = None,
                 run_dir: Optional[str] = None,
                 context: str = "train") -> None:
    """Fail-fast NaN/inf sentinel: on the first non-finite value of
    `values`, write the CURRENT state (typically already NaN-poisoned) as
    <run_dir>/ckpt_nan/<step>.pt when a run dir and a state are given,
    then raise NonFiniteLossError with the JAX package's message.  The
    file is a diagnostic (which leaves went non-finite), not a resume
    point: --resume_dir reads ckpt/.  `state` is the dict to save, or a
    function returning it (called only when a value is bad)."""
    arr = np.asarray(values, dtype=np.float64)
    ok = np.isfinite(arr)
    if np.all(ok):
        return
    msg = (f"non-finite {context} metric at step {step}: "
           f"{int(arr.size - ok.sum())}/{arr.size} bad values")
    if run_dir is not None and state is not None:
        path = os.path.join(run_dir, "ckpt_nan")
        save_checkpoint(path, state() if callable(state) else state, step)
        msg += f"; emergency checkpoint written to {path}"
    raise NonFiniteLossError(msg)
