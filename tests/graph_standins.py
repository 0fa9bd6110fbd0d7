"""CPU stand-ins for train.capture's CUDA graphs, shared by the port's
graph-path tests (imports no jax, so spawned ranks may use it too).

`patch(setattr)` puts them in place through `setattr(obj, name, value)`
(pytest's monkeypatch.setattr, or `patched`'s recording setter):
capture.Graph becomes EagerGraph, whose replay runs eagerly what the
graph would have captured; Adam's lr becomes a float64 tensor
(tensor_lr_adam); the cusolver backend, the side streams and
torch.cuda.Stream become no-ops; and cli.mnist's and cli.serve's
uncaptured_reason say that the graphs run.
"""

import contextlib

import torch

from svgpvae_tpu_torch.cli import mnist as tmnist
from svgpvae_tpu_torch.cli import serve as tserve
from svgpvae_tpu_torch.train import capture


class EagerGraph:
    """A stand-in for capture.Graph on the CPU: replaying runs eagerly
    what the graph would have captured."""

    def __init__(self, fn, stream, generators=()):
        self.fn, self.replays, self.launches = fn, 0, {}
        self.all_reduces = 0

    def replay(self):
        self.replays += 1
        return self.fn()


def tensor_lr_adam(optimizer, device):
    """capture.capturable_adam on the CPU: Adam's lr a float64 tensor,
    which the steps fill from the lr table (torch takes a tensor lr on the
    CPU in its single-tensor form, which gives the float lr's bits)."""
    (group,) = optimizer.param_groups
    group["lr"] = torch.tensor(float(group["lr"]), dtype=torch.float64)
    group["foreach"] = False
    return group["lr"]


def patch(setattr):
    """cli.mnist's (and so every driver's) and cli.serve's graph paths on
    the CPU, with
    EagerGraph for the graphs and no stream or cusolver backend."""
    setattr(capture, "Graph", EagerGraph)
    setattr(capture, "capturable_adam", tensor_lr_adam)
    setattr(capture, "cusolver_linalg", contextlib.nullcontext)
    setattr(capture, "side_stream", lambda stream: contextlib.nullcontext())
    setattr(torch.cuda, "Stream", lambda *a, **k: None)
    setattr(tmnist, "uncaptured_reason", lambda device: None)
    setattr(tserve, "uncaptured_reason", lambda device: None)


@contextlib.contextmanager
def patched():
    """`patch` for the length of the block, every attribute restored
    after (for processes without pytest's monkeypatch: spawned ranks)."""
    saved = []

    def setattr_(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    patch(setattr_)
    try:
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)
