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
    with a zero gradient for a trainable tensor the loss does not reach;
    in a data-parallel step (parallel.sharded) the gradients are summed
    across ranks first, so every rank takes the same update;
  * `EpochShuffle` (--reshuffle): each epoch's example order, as JAX's
    make_epoch_fn(shuffle=True, shuffle_block=...);
  * `make_epoch_fn` (the drivers' default loop), `make_multi_epoch_fn`
    (--epoch_chunk): an epoch, or a chunk of whole epochs, as replayed
    CUDA graphs (train.capture.GraphSteps), the metrics kept on the
    device; `make_generative_chunk_fn` (the ball): `chunk` steps that
    each draw their batch on the device (train.capture.GenerativeSteps).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from svgpvae_tpu_torch import linalg, parallel
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
    moment and counts the step (torch would skip a .grad of None).

    In a data-parallel step (parallel.sharded; `batch` holds this rank's
    rows) the loss is the global batch's, replicated on every rank: each
    rank backpropagates loss / world, whose psums sum the gradients of
    their inputs across ranks, and the parameters' gradients, zero fill
    included, are summed across ranks before the value clip
    (parallel/mesh.py says why this is the 1-process gradient).  A step
    that every rank of a data-parallel run takes whole (the tail batch,
    the SPRITES pretraining) averages its gradients and GECO state across
    ranks: the ranks' copies agree to round-off, and the average keeps
    their parameters bit for bit alike."""
    if state.lr_fn is not None:
        for group in state.optimizer.param_groups:
            group["lr"] = state.lr_fn(state.step)
    return apply_step(state, batch, loss_fn)


def apply_step(state: TrainState, batch, loss_fn):
    """`train_step` at the optimizer's current learning rate (a CUDA
    graph of train.capture sets it from the device first)."""
    opt = state.optimizer
    opt.zero_grad(set_to_none=True)
    loss, (geco, metrics) = loss_fn(state.params, batch, state.geco,
                                    state.step)
    world = parallel.world()
    (loss / world if world > 1 else loss).backward()
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:  # not reached by this loss: JAX's zero
                p.grad = torch.zeros_like(p)
    if parallel.run_ranks() > 1:
        parallel.all_reduce_grads([p for g in opt.param_groups
                                   for p in g["params"]], mean=world == 1)
        if geco is not None and world == 1:
            geco = type(geco)(*parallel.all_reduce_mean(geco.C_ma,
                                                        geco.lagrange_mult))
    if state.clip_grad_value is not None:
        linalg.tree_value_clip(
            (p.grad for g in opt.param_groups for p in g["params"]),
            state.clip_grad_value)
    opt.step()
    state.geco = geco
    state.step += 1
    return dict(metrics, loss=loss.detach())


class EpochShuffle:
    """--reshuffle: every epoch permutes the examples of the full batches
    in blocks of `block` consecutive examples (SPRITES keeps each
    character's frames together) and leaves the tail batch in place, the
    order of JAX's make_epoch_fn(shuffle=True, shuffle_block=block).

    The permutation of the blocks comes from `perm_fn(n_blocks)` when one
    is given (tests inject JAX's threefry permutation), else from a CPU
    torch.Generator seeded by `seed` (`generator`, whose state checkpoints
    keep, so that a resumed run draws the permutations of an unbroken
    one)."""

    def __init__(self, n: int, batch_size: int, block: int = 1,
                 seed: int = 0, perm_fn: Optional[Callable] = None):
        self.n, self.batch_size, self.block = n, batch_size, block
        self.n_full = (n // batch_size) * batch_size
        if self.n_full % block:
            raise ValueError(f"full batches of {self.n_full} examples do not "
                             f"split into blocks of {block}")
        self.generator = torch.Generator().manual_seed(seed)
        self.perm_fn = perm_fn

    def order(self) -> torch.Tensor:
        """The next epoch's example order (int64, a permutation of
        0..n-1)."""
        n_blocks = self.n_full // self.block
        if self.perm_fn is not None:
            perm = torch.tensor(np.asarray(self.perm_fn(n_blocks)),
                                dtype=torch.long)
        else:
            perm = torch.randperm(n_blocks, generator=self.generator)
        full = (perm[:, None] * self.block
                + torch.arange(self.block)).reshape(-1)
        return torch.cat([full, torch.arange(self.n_full, self.n)])


def epoch_batches(tensors: Tuple[torch.Tensor, ...], batch_size: int,
                  order: Optional[torch.Tensor] = None
                  ) -> Iterator[Tuple[torch.Tensor, ...]]:
    """An epoch's batches of `tensors` (split on their first axis): the
    full batches, then the tail.  Views in stored order, or gathered in
    `order` (EpochShuffle.order, moved to the tensors' device)."""
    n = len(tensors[0])
    if order is not None:
        order = order.to(tensors[0].device)
    for lo in range(0, n, batch_size):
        if order is None:
            yield tuple(t[lo:lo + batch_size] for t in tensors)
        else:
            idx = order[lo:lo + batch_size]
            yield tuple(t[idx] for t in tensors)


def make_multi_epoch_fn(graphs, shuffle: Optional[EpochShuffle] = None):
    """Port of make_multi_epoch_fn (--epoch_chunk): fn(state, tensors,
    n_epochs) runs `n_epochs` whole epochs of `tensors` (the train split,
    on the device), each its full batches, in EpochShuffle order under
    --reshuffle, and then its tail, through `graphs`
    (train.capture.GraphSteps: the steps replay captured CUDA graphs), and
    returns ({metric: (n_epochs, n_batches) tensor on the device}, [the
    kernel launches of each step]).  The n_epochs example orders are drawn
    first, from the one generator, in the sequence unchunked epochs draw
    them.  `kw` go to graphs.run: the loss `kind` of a GraphSteps over
    several losses (the --opt_regime's VAE phases), a `before(j)` hook ahead
    of step j (Casale's refresh of its held sample).  Nothing waits for the
    device: the caller reads the metrics once a chunk."""

    def multi_fn(state: TrainState, tensors, n_epochs: int, **kw):
        orders = [shuffle.order() if shuffle is not None else None
                  for _ in range(n_epochs)]
        return graphs.run(state, tensors, orders, **kw)

    return multi_fn


def make_epoch_fn(graphs, shuffle: Optional[EpochShuffle] = None):
    """Port of make_epoch_fn (the default loop of the MNIST and SPRITES
    drivers): fn(state, tensors) runs one epoch of `tensors` (the train
    split, on the device), its full batches in EpochShuffle order under
    --reshuffle (the order drawn first, as a per-step epoch draws it),
    then its tail as a step of its own, through `graphs` (GraphSteps),
    and returns ({metric: (n_batches,) tensor on the device}, [the kernel
    launches of each step]); `kw` as make_multi_epoch_fn's.  Nothing
    waits for the device."""
    multi_fn = make_multi_epoch_fn(graphs, shuffle)

    def epoch_fn(state: TrainState, tensors, **kw):
        metrics, launches = multi_fn(state, tensors, 1, **kw)
        return {k: v[0] for k, v in metrics.items()}, launches

    return epoch_fn


def make_generative_chunk_fn(graphs, chunk: int):
    """Port of make_generative_chunk_fn (the ball): fn(state, n=chunk)
    runs n <= `chunk` steps, each drawing its batch on the device and
    training on it, through `graphs` (GenerativeSteps, whose graph holds
    the draws), and returns ({metric: (n,) tensor on the device}, [the
    kernel launches of each step]).  A short last chunk is n steps of the
    same graph (the JAX driver compiles a one-off program of length n).
    Nothing waits for the device."""

    def chunk_fn(state: TrainState, n: int = chunk):
        return graphs.run(state, n)

    return chunk_fn
