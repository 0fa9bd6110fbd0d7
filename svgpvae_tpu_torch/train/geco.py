"""GECO constrained-optimization helpers (port of svgpvae_tpu/train/geco.py).

The GECO update itself lives in the forward pass (models.svgpvae).  The
first step runs with alpha = 0, so the moving average is seeded by the
first batch (reference: MNIST_experiment.py:329-333).
"""

from __future__ import annotations


def geco_effective_alpha(step: int, alpha: float) -> float:
    """alpha at `step`: 0 on the first step, `alpha` afterwards."""
    return 0.0 if step == 0 else alpha
