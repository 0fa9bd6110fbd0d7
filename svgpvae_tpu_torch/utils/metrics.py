"""Result persistence (port of the ResultSaver and count_params parts of
svgpvae_tpu/utils/metrics.py).

  * `ResultSaver` -- named-column row appender persisted as CSV; recovers
    an existing file whose header matches (a resumed run appends to it),
    else starts a timestamped sibling;
  * `count_params` -- the parameter count of a {part: module or GP
    parameter dataclass} dict.
"""

from __future__ import annotations

import csv
import os
import time
from typing import List, Sequence

import numpy as np

from svgpvae_tpu_torch.train.state import named_tensors


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
