"""Training state (port of svgpvae_tpu/train/state.py).

The JAX package threads one immutable pytree (parameters, optimizer
moments, GECO state, PRNG key, step) through its jitted step.  Here the
parameters are modules and tensors updated in place by a torch optimizer,
and the state object holds references to them plus the GECO state and the
step counter.  The noise of each step comes from the caller (see
cli.mnist), not from a key in the state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass
class GECOState:
    """GECO state: moving average of the constraint and the multiplier."""

    C_ma: torch.Tensor
    lagrange_mult: torch.Tensor

    @classmethod
    def init(cls, dtype=torch.float32, device=None) -> "GECOState":
        return cls(C_ma=torch.zeros((), dtype=dtype, device=device),
                   lagrange_mult=torch.ones((), dtype=dtype, device=device))


@dataclasses.dataclass
class TrainState:
    """Step counter + parameters + optimizer + GECO state.

    params: {"vae": nn.Module, "gp": parameter dataclass}; optimizer: a
    torch optimizer over the trainable tensors; lr_fn: step -> learning
    rate (None keeps the optimizer's); clip_grad_value: optional +/- clip
    of every gradient before the update."""

    params: dict
    optimizer: torch.optim.Optimizer
    geco: GECOState
    step: int = 0
    lr_fn: Optional[Any] = None
    clip_grad_value: Optional[float] = None
