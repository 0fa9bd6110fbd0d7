"""Optimizer wiring and the training step (port of
svgpvae_tpu/train/trainer.py, single device, eager).

  * `parse_opt_regime`: 'VAE-100 GP-100 joint-50' -> per-epoch regime list;
  * `named_tensors` (from train/state.py, where checkpoints use it): the
    parameters of every part ("vae", "repr", "head", "gp") by name;
  * `trainable_tensors` + `make_optimizer`: the JAX trainability mask
    becomes requires_grad and the optimizer's parameter group: a frozen
    leaf gets no gradient and no update (optax.set_to_zero);
  * Adam as optax.adam (b1 0.9, b2 0.999, eps 1e-8 added to sqrt(v_hat):
    torch.optim.Adam places eps the same way), with an optional value clip
    of the gradients and an optional cosine-decayed learning rate;
  * `train_step(state, batch, loss_fn)`: one forward/backward/update,
    with a zero gradient for a trainable tensor the loss does not reach.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from svgpvae_tpu_torch import linalg
from svgpvae_tpu_torch.train.state import TrainState, named_tensors


def parse_opt_regime(specs: List[str]) -> Tuple[int, List[str]]:
    """'VAE-100 GP-100 joint-50' -> (250, per-epoch regime list)."""
    schedule: List[str] = []
    for spec in specs:
        regime, _, count = spec.rpartition("-")
        schedule.extend([regime] * int(count))
    return len(schedule), schedule


def trainable_tensors(params: dict, predicate: Callable[[str], bool]
                      ) -> Dict[str, torch.Tensor]:
    """Set requires_grad on every tensor of `params` (see named_tensors)
    by predicate(name) and return the trainable ones by name."""
    out = {}
    for name, t in named_tensors(params).items():
        keep = bool(predicate(name))
        t.requires_grad_(keep)
        if keep:
            out[name] = t
    return out


def make_optimizer(tensors: Dict[str, torch.Tensor],
                   learning_rate: float) -> torch.optim.Adam:
    """Adam over the trainable tensors (one parameter group)."""
    return torch.optim.Adam(list(tensors.values()), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def cosine_decay_lr(lr: float, decay_alpha: Optional[float],
                    total_steps: int) -> Optional[Callable[[int], float]]:
    """step -> lr decaying from `lr` to `lr * decay_alpha` over
    `total_steps` (optax.cosine_decay_schedule), or None for a constant
    lr."""
    if decay_alpha is None:
        return None

    def fn(step: int) -> float:
        frac = min(step, total_steps) / total_steps
        cos = 0.5 * (1.0 + math.cos(math.pi * frac))
        return lr * ((1.0 - decay_alpha) * cos + decay_alpha)

    return fn


def train_step(state: TrainState, batch, loss_fn):
    """One step: loss_fn(params, batch, geco, step) -> (loss, (geco,
    metrics)); backward, optional value clip, Adam update, step + 1.
    Returns the metrics with "loss" added.  After the call every
    trainable tensor's .grad holds this step's gradient.

    A trainable tensor that the loss does not reach (the GP's in an
    --opt_regime VAE epoch) gets a zero gradient, as under JAX's masked
    optax Adam: Adam still decays its moments, moves it on the first
    moment and counts the step (torch would skip a .grad of None)."""
    opt = state.optimizer
    if state.lr_fn is not None:
        for group in opt.param_groups:
            group["lr"] = state.lr_fn(state.step)
    opt.zero_grad(set_to_none=True)
    loss, (geco, metrics) = loss_fn(state.params, batch, state.geco,
                                    state.step)
    loss.backward()
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:  # not reached by this loss: JAX's zero
                p.grad = torch.zeros_like(p)
    if state.clip_grad_value is not None:
        linalg.tree_value_clip(
            (p.grad for g in opt.param_groups for p in g["params"]),
            state.clip_grad_value)
    opt.step()
    state.geco = geco
    state.step += 1
    return dict(metrics, loss=loss.detach())
