"""Data parallelism over processes (port of svgpvae_tpu/parallel/mesh.py).

The JAX package lays a batch over a jax.sharding.Mesh data axis and lets
XLA's SPMD partitioner insert the psums.  The port runs one process per
rank (torch.distributed), each with a contiguous share of the global
batch, and writes the sums out where the math reduces over the batch:

  * `resolve_data_parallel(n, batch_size, device)`: --data_parallel N as
    the JAX drivers read it (0 off, -1 every visible device), with their
    refusals and messages; returns the rank count (0: off);
  * `launch(module, argv, kwargs, world, device)`: a driver run alone
    starts ranks 1..N-1 itself (torch.multiprocessing, spawn), joins them
    through a file:// rendezvous in a temporary directory, runs rank 0 in
    this process and stops every rank it started.  Ranks > 0 print
    nothing;
  * `init(rank, world, init_method, device)`: the process group and the
    rank's device.  NCCL when every rank has a card of its own; gloo when
    ranks share a card (SVGPVAE_RANKS_PER_DEVICE > 1 lets that many ranks
    onto each visible card) and on the CPU.  Gloo on CUDA tensors offers
    broadcast, all-reduce and barrier only, so every collective here is
    one of those.  The device stays the card under either backend.  Under
    NCCL the rank's card is set before the group exists and bound to it
    (`device_id`), so the communicator is made at once, outside any CUDA
    graph capture (one made lazily inside a capture fails), and barriers
    name that card.  The drivers' training loops capture their steps,
    all-reduces included, into CUDA graphs under NCCL; gloo stages its
    all-reduces through the host, so under gloo they step one by one
    (train.capture, cli.mnist.uncaptured_reason);
  * `sharded(on)`: the context of one data-parallel step.  Inside it
    `world()` is the rank count, `local_rows` cuts this rank's share of a
    global batch and `psum` adds tensors across ranks.  Outside it (the
    tail batch, the eval passes, the SPRITES pretraining, a 1-process
    run) world() is 1, local_rows and psum hand their input back, and
    every rank computes the same replicated values, as JAX runs a tail
    batch replicated;
  * `psum`: a sum across ranks under autograd, whose backward pass sums
    the incoming gradients across ranks too.  Everything after a psum is
    replicated, so train.train_step backpropagates loss / world and then
    sums the parameters' gradients across ranks (`all_reduce_grads`):
    every term after a psum then counts once, every rank's shard terms
    add up, and every rank's Adam takes the 1-process gradient.  Plain
    DDP, which averages per-rank losses, would instead fit a GP
    posterior to each rank's shard alone;
  * `sharded_precompute_gp_params` / `sharded_posterior_params`: the
    full-train-set fits with each rank's share of the N rows through B3
    (or B2), the (L, m, m) / (L, m) partial sums added before the
    replicated m-sized solves; unsharded when no group is up or the ranks
    do not divide N;
  * `check_replicated`: the start-up check that every rank holds the
    same parameters;
  * `all_reduce_count`: the all-reduces issued so far (train.capture
    counts a graph's once at its capture and adds them at each replay,
    as it does kernel launches), which a trace of the card's NCCL kernels
    is held to.

JAX's model axis (`make_mesh(model=...)`) has no driver flag and is not
ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import shutil
import sys
import tempfile
from typing import Optional, Sequence

import torch
from torch import Tensor

RANKS_PER_DEVICE_ENV = "SVGPVAE_RANKS_PER_DEVICE"


@dataclasses.dataclass(frozen=True)
class Group:
    rank: int
    world: int
    backend: str
    device: torch.device


_GROUP: Optional[Group] = None
_ACTIVE = False   # the current run trains over the group (`active`)
_SHARDED = False  # inside one data-parallel step (`sharded`)
_ALL_REDUCES = 0  # all-reduces issued by this process (`all_reduce_count`)


def ranks_per_device() -> int:
    """How many ranks may share one card (SVGPVAE_RANKS_PER_DEVICE, 1)."""
    return max(1, int(os.environ.get(RANKS_PER_DEVICE_ENV, "1")))


def visible_devices(device="cuda") -> int:
    """Rank slots: the visible cards times ranks_per_device(), or on the
    CPU one per core (gloo ranks are processes)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count() * ranks_per_device()
    return os.cpu_count() or 1


def resolve_data_parallel(n: int, batch_size: int, device="cuda",
                          visible: Optional[int] = None) -> int:
    """`--data_parallel N` -> the rank count (0: off).

    N = 0 disables; N = -1 uses every visible device; N > 0 the first N.
    The batch size must divide over the ranks: a padded batch would change
    the GP minibatch's N/b scale.  Refused, with the JAX package's
    messages, when it does not or when N exceeds the visible devices."""
    if not n:
        return 0
    avail = visible_devices(device) if visible is None else visible
    ndev = avail if n < 0 else n
    if ndev > avail:
        raise SystemExit(f"--data_parallel {n}: only {avail} devices "
                         "visible")
    if batch_size % ndev:
        raise SystemExit(f"--data_parallel {ndev}: batch_size "
                         f"{batch_size} does not tile the data axis; "
                         "pick a batch size divisible by the device "
                         "count")
    return ndev


def rank_device(rank: int, device="cuda") -> torch.device:
    """Rank r's device: card r // ranks_per_device(), or the CPU."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank // ranks_per_device())


def backend_for(device="cuda") -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if torch.device(device).type == "cuda" and ranks_per_device() == 1:
        return "nccl"
    return "gloo"


def init(rank: int, world: int, init_method: str, device="cuda") -> Group:
    """Join the process group as `rank` of `world` and make this module
    use it.  Under NCCL the group is bound to the rank's card, which makes
    its communicator now."""
    global _GROUP
    import torch.distributed as dist
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(minutes=10),
                            device_id=dev if backend == "nccl" else None)
    _GROUP = Group(rank=rank, world=world, backend=backend, device=dev)
    return _GROUP


def shutdown() -> None:
    global _GROUP
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUP = None


def group() -> Optional[Group]:
    return _GROUP


def _active() -> bool:
    return _ACTIVE and _GROUP is not None and _GROUP.world > 1


@contextlib.contextmanager
def active(ranks: int):
    """A driver's run: over the process group when `ranks` > 1 (which
    must be the group's size), on this process alone otherwise."""
    global _ACTIVE
    if ranks > 1 and (_GROUP is None or _GROUP.world != ranks):
        raise RuntimeError(f"--data_parallel {ranks}: the process group has "
                           f"{None if _GROUP is None else _GROUP.world} "
                           "ranks")
    saved = _ACTIVE
    _ACTIVE = ranks > 1
    try:
        yield
    finally:
        _ACTIVE = saved


def needs_launch(ranks: int) -> bool:
    """A data-parallel run with no process group up yet: `launch` it."""
    return ranks > 1 and _GROUP is None


def announce(device) -> None:
    """A data-parallel run's first line (the JAX drivers print theirs)."""
    if _active():
        print(f"data-parallel training over {_GROUP.world} ranks: backend "
              f"{_GROUP.backend}, rank {_GROUP.rank} on {device}")


def is_writer() -> bool:
    """Rank 0 of a data-parallel run, or any other run: the process that
    writes run dirs."""
    return not _active() or _GROUP.rank == 0


def device(default) -> torch.device:
    """The rank's device in a data-parallel run, else `default`."""
    return _GROUP.device if _active() else torch.device(default)


def run_ranks() -> int:
    """The rank count of a data-parallel run, else 1."""
    return _GROUP.world if _active() else 1


def barrier() -> None:
    """Wait for every rank of a data-parallel run (no-op otherwise); under
    NCCL on the rank's own card."""
    if _active():
        import torch.distributed as dist
        dist.barrier(device_ids=[_GROUP.device.index]
                     if _GROUP.backend == "nccl" else None)


def all_reduce_count() -> int:
    """The all-reduces this process has issued (a CUDA graph's counted at
    each replay, see train.capture)."""
    return _ALL_REDUCES


def add_all_reduces(n: int) -> None:
    global _ALL_REDUCES
    _ALL_REDUCES += n


def _all_reduce(t: Tensor) -> None:
    """Sum `t` across the ranks in place (contiguous, on the rank's
    device), counted."""
    import torch.distributed as dist
    dist.all_reduce(t)
    add_all_reduces(1)


def world() -> int:
    """The rank count inside `sharded()`, else 1."""
    return _GROUP.world if _SHARDED else 1


def rank() -> int:
    return _GROUP.rank if _SHARDED else 0


@contextlib.contextmanager
def sharded(on: bool = True):
    """One data-parallel step (when `on` in a data-parallel run):
    world(), local_rows and psum act across ranks inside it."""
    global _SHARDED
    saved = _SHARDED
    _SHARDED = bool(on) and _active()
    try:
        yield
    finally:
        _SHARDED = saved


def global_rows(b_local: int) -> int:
    return b_local * world()


def row_offset(b_local: int) -> int:
    """This rank's first row in the global batch."""
    return rank() * b_local


def local_rows(x: Tensor) -> Tensor:
    """This rank's contiguous share of the first axis of `x`."""
    w = world()
    if w == 1:
        return x
    n = x.shape[0] // w
    return x[rank() * n:(rank() + 1) * n]


class _AllReduceSum(torch.autograd.Function):
    """Sum across ranks; the backward pass sums the gradients across
    ranks (see the module docstring for why that counts each term
    once)."""

    @staticmethod
    def forward(ctx, x):
        out = x.contiguous().clone()
        _all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        _all_reduce(grad)
        return grad


def psum(*tensors: Tensor):
    """The sum of each tensor across ranks inside `sharded()` (one
    all-reduce for them all), the tensors themselves outside it.  bf16 and
    fp16 sums travel as fp32."""
    if world() == 1:
        return tensors[0] if len(tensors) == 1 else tensors
    dtype = tensors[0].dtype
    wire = torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype
    flat = torch.cat([t.reshape(-1).to(wire) for t in tensors])
    parts = torch.split(_AllReduceSum.apply(flat),
                        [t.numel() for t in tensors])
    out = tuple(p.view(t.shape).to(t.dtype) for p, t in zip(parts, tensors))
    return out[0] if len(out) == 1 else out


def mean_rows(x: Tensor) -> Tensor:
    """The mean over the global batch of per-row values `x` (b_local,)."""
    if world() == 1:
        return x.mean()
    return psum(x.sum()) / global_rows(x.shape[0])


def gather_rows(*tensors: Tensor):
    """Every rank's rows of each tensor, in global order, under autograd
    (placed into zeros and psum'd)."""
    out = []
    for t in tensors:
        b = t.shape[0]
        pad = [t.new_zeros((row_offset(b),) + t.shape[1:]), t,
               t.new_zeros((global_rows(b) - row_offset(b) - b,)
                           + t.shape[1:])]
        out.append(torch.cat(pad))
    return psum(*out)


def all_reduce_grads(params: Sequence[Tensor], mean: bool = False) -> None:
    """Sum (or with `mean` average) the .grad of every tensor across the
    ranks of a data-parallel run, in place (one all-reduce)."""
    grads = [p.grad for p in params]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    _all_reduce(flat)
    if mean:
        flat /= _GROUP.world
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def all_reduce_mean(*tensors: Tensor) -> tuple:
    """Each tensor averaged across the ranks of a data-parallel run (no
    autograd)."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    _all_reduce(flat)
    flat /= _GROUP.world
    return tuple(p.view(t.shape).to(t.dtype) for p, t in zip(
        torch.split(flat, [t.numel() for t in tensors]), tensors))


def check_replicated(tensors: Sequence[Tensor], what: str = "parameters"
                     ) -> None:
    """Raise on every rank together unless every rank holds rank 0's
    values of `tensors` bit for bit."""
    import torch.distributed as dist
    if not _active():
        return
    mine = torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in tensors])
    ref = mine.clone()
    dist.broadcast(ref, src=0)
    bad = torch.tensor([float((mine != ref).sum())],
                       dtype=torch.float64, device=mine.device)
    _all_reduce(bad)
    if bad.item():
        raise RuntimeError(f"--data_parallel: the ranks start from different "
                           f"{what} ({int(bad.item())} values differ from "
                           "rank 0's)")


def gather_counts(counts: dict) -> list:
    """[rank 0's counts, rank 1's, ...] of a {name: int} dict that every
    rank holds with the same keys."""
    keys = sorted(counts)
    table = torch.zeros((_GROUP.world, len(keys)), dtype=torch.float64,
                        device=_GROUP.device)
    table[_GROUP.rank] = torch.tensor([float(counts[k]) for k in keys],
                                      dtype=torch.float64)
    _all_reduce(table)
    return [{k: int(v) for k, v in zip(keys, row.tolist())} for row in table]


def _shard_rows(n_rows: int) -> bool:
    """A full-train fit shards in a data-parallel run whose ranks divide
    the rows."""
    return _active() and n_rows % _GROUP.world == 0


def sharded_precompute_gp_params(gp_params, means: Tensor, variances: Tensor,
                                 aux_data: Tensor):
    """gp.precompute_test_posterior_terms over the full train set, each
    rank fitting its share of the N rows (B3, or B2 under the SE kernel)
    and the partial sums added across ranks before the replicated solves.
    Unsharded without a group or when the ranks do not divide N.
    Returns (mean_terms (L, m), Sigma_inv (L, m, m), Kmm_inv (m, m))."""
    from svgpvae_tpu_torch.gp.svgp import precompute_test_posterior_terms
    with sharded(_shard_rows(means.shape[0])):
        return precompute_test_posterior_terms(
            gp_params, local_rows(means), local_rows(variances),
            local_rows(aux_data))


def sharded_posterior_params(gp_params, aux_test: Tensor, aux_train: Tensor,
                             y: Tensor, noise: Tensor):
    """gp.posterior_params at `aux_test` conditioned on the full train set
    (the MNIST cgen), each rank contracting its share of the N rows (B2)
    and the (L, m, m) / (L, m) partial sums added across ranks; the m-
    and x-sized tail runs replicated.  Unsharded without a group or when
    the ranks do not divide N.  Returns (p_m, p_v, mu_hat, A_hat)."""
    from svgpvae_tpu_torch.gp.svgp import posterior_params
    with sharded(_shard_rows(y.shape[0])):
        return posterior_params(gp_params, aux_test, local_rows(aux_train),
                                local_rows(y), local_rows(noise))


def _rank_entry(index: int, world: int, init_method: str, module: str,
                argv: list, kwargs: dict, device: str, threads: int) -> None:
    """A spawned rank (index + 1): join the group, run the driver's main
    silently with rank 0's intra-op thread count (the CPU's reductions
    split by it), hand the launch counts to rank 0, leave the group."""
    import importlib
    sys.stdout = open(os.devnull, "w")
    torch.set_num_threads(threads)
    init(index + 1, world, init_method, device)
    try:
        importlib.import_module(module).main(argv, **kwargs)
        _rank_launch_counts()
    finally:
        _release_graphs()
        shutdown()


def _release_graphs() -> None:
    """Free the run's CUDA graphs, which hold its NCCL collectives, before
    the group's communicator goes (the graphs may sit in reference
    cycles)."""
    import gc
    gc.collect()
    if _GROUP is not None and _GROUP.device.type == "cuda":
        torch.cuda.synchronize(_GROUP.device)


def _rank_launch_counts() -> list:
    """Every rank's kernel launch counts (a collective: every rank calls
    it once, after its run)."""
    from svgpvae_tpu_torch import ops
    if _GROUP.device.type == "cuda":
        torch.cuda.synchronize(_GROUP.device)
    return gather_counts(ops.launch_counts())


def launch(module: str, argv: Optional[list], kwargs: dict, world: int,
           device="cuda", rank0_kwargs: Optional[dict] = None) -> dict:
    """Run `module`.main(argv, **kwargs) on `world` ranks: ranks 1.. in
    spawned processes (`kwargs` travel pickled), rank 0 here (with
    `rank0_kwargs` in place of `kwargs` when given).  Returns rank 0's
    result with "rank_launches" (each rank's kernel launch counts over the
    run; rank 0's counted from this process's last reset)."""
    import torch.multiprocessing as mp
    argv = list(sys.argv[1:] if argv is None else argv)
    rdzv = tempfile.mkdtemp(prefix="svgpvae_rdzv_")
    init_method = "file://" + os.path.join(rdzv, "init")
    ctx = mp.start_processes(_rank_entry, args=(world, init_method, module,
                                                argv, kwargs,
                                                str(device),
                                                torch.get_num_threads()),
                             nprocs=world - 1, join=False,
                             start_method="spawn")
    try:
        init(0, world, init_method, device)
        try:
            import importlib
            result = importlib.import_module(module).main(
                argv, **(kwargs if rank0_kwargs is None else rank0_kwargs))
            rank_launches = _rank_launch_counts()
        finally:
            _release_graphs()
            shutdown()
        while not ctx.join():
            pass
    except BaseException:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join()
        raise
    finally:
        shutil.rmtree(rdzv, ignore_errors=True)
    if isinstance(result, dict):
        result["rank_launches"] = rank_launches
    return result
