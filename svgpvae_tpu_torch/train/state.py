"""Training state (port of svgpvae_tpu/train/state.py).

The JAX package threads one immutable pytree (parameters, optimizer
moments, GECO state, PRNG key, step) through its jitted step.  Here the
parameters are modules and tensors updated in place by a torch optimizer,
and the state object holds references to them plus the GECO state and the
step counter.  The noise of each step comes from the caller (see
cli.mnist), not from a key in the state.  `state_dict` /
`load_state_dict` carry everything but the noise through a checkpoint
(utils.checkpoint); the driver saves its noise generator beside it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


def named_tensors(params: dict) -> Dict[str, torch.Tensor]:
    """Every parameter tensor of params ({"vae": module, "gp": parameter
    dataclass}, plus "repr" and, for pretraining, "head" modules on
    SPRITES) by name "<part>/<parameter name>", e.g. "vae/enc_out.weight",
    "gp/inducing_points"."""
    named = {}
    for part, p in params.items():
        items = (p.named_parameters() if isinstance(p, torch.nn.Module)
                 else p.named_tensors().items())
        named.update({f"{part}/{k}": v for k, v in items})
    return named


def eager_optimizer_state(sd: dict) -> dict:
    """An optimizer state_dict as an eager (not capturable) Adam holds it:
    a capturable Adam (train.capture) keeps its lr in a device tensor and
    its step counts on the device; here they are a float and CPU tensors,
    so one checkpoint resumes a captured or an eager run alike."""
    groups = [dict(g, lr=float(g["lr"]), capturable=False)
              if isinstance(g["lr"], torch.Tensor) else g
              for g in sd["param_groups"]]
    state = {i: {k: v.cpu() if k == "step" else v for k, v in st.items()}
             for i, st in sd["state"].items()}
    return dict(sd, param_groups=groups, state=state)


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
    geco: Optional[GECOState]
    step: int = 0
    lr_fn: Optional[Any] = None
    clip_grad_value: Optional[float] = None

    def trainable_names(self) -> list:
        return [k for k, t in named_tensors(self.params).items()
                if t.requires_grad]

    def state_dict(self) -> dict:
        """Copies of every parameter (by named_tensors name), the names of
        the trainable ones, the optimizer's state_dict (always in the eager
        form: see eager_optimizer_state), the GECO state and the step."""
        return {
            "params": {k: t.detach().clone()
                       for k, t in named_tensors(self.params).items()},
            "trainable": self.trainable_names(),
            "optimizer": eager_optimizer_state(self.optimizer.state_dict()),
            "geco": None if self.geco is None else {
                "C_ma": self.geco.C_ma.detach().clone(),
                "lagrange_mult": self.geco.lagrange_mult.detach().clone()},
            "step": self.step}

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Restore a `state_dict` in place: parameters copied into this
        state's tensors (on their devices), the optimizer, GECO state and
        step.  Refuses, naming the leaves, a checkpoint whose parameters or
        trainable set differ from this state's (the optimizer's moments
        belong to the trainable tensors, in order)."""
        named = named_tensors(self.params)
        for what, have, want in (
                ("parameters", set(named), set(sd["params"])),
                ("trainable parameters", set(self.trainable_names()),
                 set(sd["trainable"]))):
            if have != want:
                raise ValueError(
                    f"checkpoint {what} differ: only in the checkpoint "
                    f"{sorted(want - have)}, only in this run "
                    f"{sorted(have - want)}")
        for k, t in named.items():
            if sd["params"][k].shape != t.shape:
                raise ValueError(f"checkpoint parameter {k}: shape "
                                 f"{tuple(sd['params'][k].shape)}, this run "
                                 f"{tuple(t.shape)}")
            t.copy_(sd["params"][k])
        self.optimizer.load_state_dict(sd["optimizer"])
        if sd["geco"] is not None:
            device = self.geco.C_ma.device
            self.geco = GECOState(
                **{k: v.to(device) for k, v in sd["geco"].items()})
        self.step = int(sd["step"])
