"""CUDA graphs for the training loops and the eval calls: the port's
form of the JAX package's one-program loops (train.make_epoch_fn,
make_multi_epoch_fn and make_generative_chunk_fn: the drivers' default
epochs, every MNIST runner's among them, the SPRITES pretraining epochs,
MNIST's --epoch_chunk, the ball's sample -> step chunks), of its eval
programs (MNIST's --eval_bundle and unbundled passes, Casale's cgen, the
SPRITES eval pass's recon, encode, fit and cgen) and of the serve's jitted
encode and predict.  On CUDA, "one program, one readback" is a graph
captured once and replayed; the drivers use these on a CUDA device, in a
1-process run or a data-parallel run over NCCL (the all-reduces inside
the graphs), and say why their steps run one by one elsewhere (the CPU,
--data_parallel over gloo, ...).

  * `Graph`: fn() captured on a side stream and replayed.  The kernel
    launches the wrappers counted during the capture (which ran nothing)
    are taken out of ops.launch_counts and added at every replay, so the
    counters read what the device ran, as in an eager run; so are the
    all-reduces (parallel.all_reduce_count).  In a data-parallel run the
    capture is thread-local (capture_error_mode): NCCL's watchdog thread
    polls its events while a rank captures.  CUDA
    generators that fn draws from are registered with the graph, so every
    replay advances them as an eager call would, and a checkpoint's
    get_state() after N replays resumes the same stream.
  * `StepGraphs`: the machinery of a loop's steps.  The run's first
    WARMUP steps of a kind and its first tail step run eagerly on the
    side stream: real steps of the run, which load every kernel and
    allocate Adam's moments before any capture, and which take step 0
    (GECO's alpha = 0, a host branch that a graph would bake in).  Then
    the step is captured once and every later one replays it; a loop's
    graphs share one memory pool.  One StepGraphs may step several losses
    over one TrainState (the MNIST --opt_regime's VAE and joint phases):
    their graphs read one set of static tensors (Adam's lr and step
    counts, the step counter, the GECO pair), so a graph of one loss
    replayed after steps of another reads the state those left; each loss
    keeps its own metric buffer.  `call(name, fn)` runs a function of the
    loop's own between steps (Casale's refresh of its held full-train
    sample) the same way: once eagerly, then captured and replayed.
  * `GraphSteps`: the steps of an epoch, or of a chunk of epochs
    (make_epoch_fn's and make_multi_epoch_fn's `graphs`): one graph of a
    full-batch step, one of the tail step.  With `shard` a full-batch step
    of a data-parallel run takes this rank's rows (parallel.sharded), as
    the drivers' per-step loops do; the tail step runs replicated.
  * `GenerativeSteps`: make_generative_chunk_fn's `graphs`, one graph of
    a step that draws its own batch on the device (the ball's videos),
    then its noise, and trains.
  * `CapturedCall`: an argument-less function (the eval bundle, an
    MNIST eval pass, a SPRITES eval call): the first call runs it once
    eagerly (its warm-up, whose results, launches and draws are
    discarded), captures it and replays it; later calls replay it.
  * `CallPerShape`: a function of input tensors (the serve's encode
    chunk and request), one CapturedCall per input shape, its inputs
    copied into static buffers before each replay.

What a graph needs that an eager step does not:
  - inputs at fixed addresses.  A step gathers its batch rows in the
    graph from the chunk's example orders (a static (n_epochs, n) tensor
    filled once a chunk) at a device step counter, which the graph
    advances, or draws them there from a registered generator; reads its
    learning rate from a per-step table (the cosine decay) into the lr
    tensor of a capturable Adam (`capturable_adam`:
    lr and step counts on the device; capturable=True changes Adam's
    arithmetic order, so a captured run sits within round-off of an eager
    one, not bit for bit); and copies the GECO state back into two static
    tensors, which the next step reads;
  - outputs at fixed addresses: each step writes its metrics into a
    static (steps, k) buffer, read once a call;
  - no host sync and no host memory that outlives the call: the GP
    blocks factorize with cholesky_ex, and torch's batched cholesky_solve,
    which by default goes to MAGMA and hands it pointer arrays in pinned
    host memory freed on return (a replay would read them later), runs
    with the cusolver backend during warm-ups and captures
    (`cusolver_linalg`).
A failed capture raises: the run never goes on eagerly in its place.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence

import torch

from svgpvae_tpu_torch import ops, parallel, utils
from svgpvae_tpu_torch.train.state import GECOState, TrainState, named_tensors
from svgpvae_tpu_torch.train.trainer import apply_step


@contextlib.contextmanager
def cusolver_linalg():
    """torch.linalg on the cusolver backend (not MAGMA), restored after."""
    backend = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(backend)


@contextlib.contextmanager
def side_stream(stream: torch.cuda.Stream):
    """Work on `stream`, ordered after the current stream's and before
    what the current stream does next."""
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        yield
    torch.cuda.current_stream().wait_stream(stream)


def launch_delta(before: dict) -> dict:
    after = ops.launch_counts()
    return {k: after[k] - before[k] for k in after}


class Graph:
    """fn() captured once on `stream` (with the cusolver backend; in the
    memory pool `pool` when given, see torch.cuda.graph) and replayed by
    `replay()`, which returns fn's outputs: the graph's static tensors,
    overwritten by the next replay.  `launches`: the kernel launches of
    one replay; `replays`: how many ran."""

    def __init__(self, fn: Callable, stream: torch.cuda.Stream,
                 generators: Sequence[torch.Generator] = (), pool=None):
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        before = ops.launch_counts()
        reduces = parallel.all_reduce_count()
        mode = "thread_local" if parallel.run_ranks() > 1 else "global"
        stream.wait_stream(torch.cuda.current_stream())
        with cusolver_linalg(), torch.cuda.graph(
                graph, pool=pool, stream=stream, capture_error_mode=mode):
            self.out = fn()
        torch.cuda.current_stream().wait_stream(stream)
        self.launches = launch_delta(before)
        self.all_reduces = parallel.all_reduce_count() - reduces
        ops.add_launch_counts(self.launches, -1)  # the capture ran nothing
        parallel.add_all_reduces(-self.all_reduces)
        self.graph, self.replays = graph, 0
        self.pool = graph.pool()  # for the captures that share it

    def replay(self):
        self.graph.replay()
        ops.add_launch_counts(self.launches)
        parallel.add_all_reduces(self.all_reduces)
        self.replays += 1
        return self.out


def metric_dtype(metrics: dict) -> torch.dtype:
    """The widest dtype among a step's metrics (0-d tensors), at least
    float32: every value widens to it exactly."""
    dtype = torch.float32
    for v in metrics.values():
        dtype = torch.promote_types(dtype, v.dtype)
    return dtype


def capturable_adam(optimizer: torch.optim.Optimizer,
                    device: torch.device) -> torch.Tensor:
    """Turn the driver's Adam (one parameter group) capturable in place:
    its step counts move to `device` and its learning rate becomes a 0-d
    float32 tensor there, which is returned (TrainState.state_dict writes
    both back in the eager form, so checkpoints stay portable)."""
    (group,) = optimizer.param_groups
    lr = group["lr"]
    if not isinstance(lr, torch.Tensor):
        lr = torch.tensor(lr, dtype=torch.float32, device=device)
    group["lr"], group["capturable"] = lr, True
    for st in optimizer.state.values():
        if "step" in st:
            st["step"] = st["step"].to(device=device, dtype=torch.float32)
    return lr


class StepGraphs:
    """Training steps through captured CUDA graphs, one per step kind
    (`which`): the first WARMUP steps of a kind (1 for any kind but
    "full") run eagerly on the side stream, the next is captured and
    replayed, every later one replayed.  The steps of a call read their
    learning rates from a per-step table at a device step counter, which
    each step advances, keep the GECO state in two static tensors and
    write their metrics into a static buffer, read back once a call.  All
    graphs share one memory pool: they never run concurrently, and what
    one graph leaves for the next (the parameters, Adam's moments, the
    counter, the GECO pair, the buffers) was allocated before any capture.
    `loss_fn` is one loss, or {kind: loss} of several over the one
    TrainState (a call steps one kind; the graphs of kind k are named
    "k/<which>", those of the kind None "<which>").  Subclasses give
    `batch(which)`, the step's inputs (read or drawn on the device).
    `graphs`: {name: Graph}, once captured."""

    WARMUP = 2  # eager full-batch steps before the full step's capture

    shard = False  # a full-batch step takes this rank's rows (GraphSteps)

    def __init__(self, loss_fn,
                 generators: Sequence[Optional[torch.Generator]] = ()):
        self.loss_fns = loss_fn if isinstance(loss_fn, dict) else {
            None: loss_fn}
        self.generators = [g for g in generators if g is not None]
        self.graphs: Dict[str, Graph] = {}
        self.warm: Dict[str, int] = {}
        self.bufs: Dict[Optional[str], torch.Tensor] = {}
        self.keys: Dict[Optional[str], List[str]] = {}
        self.pool = None

    @staticmethod
    def name(kind: Optional[str], which: str) -> str:
        return which if kind is None else f"{kind}/{which}"

    def _prepare(self, state: TrainState, device: torch.device,
                 n_steps: int) -> None:
        """Turn Adam capturable and allocate the static tensors of up to
        `n_steps` steps a call."""
        self.lr_const = float(state.optimizer.param_groups[0]["lr"])
        self.lr = capturable_adam(state.optimizer, device)
        self.stream = torch.cuda.Stream(device)
        self.lr_table = torch.empty(n_steps, dtype=self.lr.dtype,
                                    device=device)
        self.counter = torch.zeros((), dtype=torch.long, device=device)
        self.geco = None if state.geco is None else GECOState(
            state.geco.C_ma.clone(), state.geco.lagrange_mult.clone())
        self.n_steps = n_steps

    def _begin(self, state: TrainState, n: int) -> None:
        """A call of `n` steps from state.step: their learning rates into
        the table, the counter to 0."""
        lr_fn = state.lr_fn
        self.lr_table[:n].copy_(torch.tensor(
            [self.lr_const if lr_fn is None else lr_fn(state.step + i)
             for i in range(n)], dtype=self.lr.dtype))
        self.counter.zero_()

    def batch(self, which: str):
        raise NotImplementedError

    def _body(self, state: TrainState, which: str,
              kind: Optional[str]) -> None:
        """One step, eagerly or under capture: its inputs, its lr from the
        table, the update with the loss of `kind`, the GECO state back
        into the static pair, its metrics into the kind's buffer, the
        counter + 1."""
        s = self.counter
        self.lr.copy_(self.lr_table.index_select(0, s.view(1))[0])
        with parallel.sharded(self.shard and which == "full"):
            m = apply_step(state, self.batch(which), self.loss_fns[kind])
        if self.geco is not None and state.geco is not self.geco:
            self.geco.C_ma.copy_(state.geco.C_ma)
            self.geco.lagrange_mult.copy_(state.geco.lagrange_mult)
            state.geco = self.geco
        if kind not in self.bufs:  # the kind's first (eager) step: layout
            self.keys[kind] = list(m)
            self.bufs[kind] = torch.zeros((self.n_steps, len(m)),
                                          dtype=metric_dtype(m),
                                          device=s.device)
        buf = self.bufs[kind]
        vals = torch.stack([m[k].to(buf.dtype) for k in self.keys[kind]])
        buf.index_copy_(0, s.view(1), vals[None])
        self.counter.add_(1)

    def _launch(self, name: str, body: Callable, warmup: int) -> None:
        """body() eagerly on the side stream for its first `warmup` calls,
        then captured as the graph `name` and replayed."""
        graph = self.graphs.get(name)
        if graph is None and self.warm.get(name, 0) >= warmup:
            kw = {} if self.pool is None else {"pool": self.pool}
            graph = self.graphs[name] = Graph(body, self.stream,
                                              self.generators, **kw)
            self.pool = getattr(graph, "pool", None)
        if graph is None:
            with cusolver_linalg(), side_stream(self.stream):
                body()
            self.warm[name] = self.warm.get(name, 0) + 1
        else:
            graph.replay()

    def call(self, name: str, fn: Callable) -> None:
        """fn(), a function of the loop's own between two steps (it reads
        and writes tensors at fixed addresses, and may draw from the
        registered generators): its first call eager, then captured as
        the graph `name` and replayed, as a step is."""
        self._launch(name, fn, 1)

    def _step(self, state: TrainState, which: str,
              kind: Optional[str] = None) -> dict:
        before, step = ops.launch_counts(), state.step
        with utils.annotate("train_step"):
            self._launch(self.name(kind, which),
                         lambda: self._body(state, which, kind),
                         self.WARMUP if which == "full" else 1)
        # a capture runs the step's Python (step + 1) but no kernel, a
        # replay the kernels alone
        state.step = step + 1
        return launch_delta(before)

    def _readback(self, rows: int, kind: Optional[str] = None
                  ) -> Dict[str, torch.Tensor]:
        """The metrics of the call's `rows` steps of `kind`, {metric:
        (rows,)}, as copies on the device."""
        out = self.bufs[kind][:rows].clone()
        return {k: out[:, i] for i, k in enumerate(self.keys[kind])}


class GraphSteps(StepGraphs):
    """The steps of each chunk of epochs (make_epoch_fn's and
    make_multi_epoch_fn's `graphs`): a graph of a full-batch step
    ("full") and one of the tail step ("tail"), each gathering its batch
    rows from the chunk's example orders (a static (n_epochs, n) tensor
    filled once a chunk) at the step counter.  `run(state, tensors,
    orders, kind=None, before=None)` takes one chunk of the loss `kind`:
    `tensors` the train split on the device (the same tensors every
    chunk), `orders` one example order (or None, the stored order) per
    epoch of the chunk; before(j), when given, runs ahead of the chunk's
    step j (on the host, which may launch a `call`).  Returns ({metric:
    (n_epochs, n_batches) tensor on the device}, [launches of each
    step]).  `shard`: in a data-parallel run a full-batch step takes this
    rank's share of the batch's rows (the drivers' main loops); without
    it every step runs replicated (the SPRITES pretraining)."""

    def __init__(self, loss_fn, batch_size: int,
                 generators: Sequence[Optional[torch.Generator]] = (),
                 shard: bool = False):
        super().__init__(loss_fn, generators)
        self.bs, self.tensors, self.shard = batch_size, None, shard

    def _setup(self, state: TrainState, tensors, n_epochs: int) -> None:
        device = tensors[0].device
        self.tensors, self.n_epochs = tensors, n_epochs
        self.n = len(tensors[0])
        n_full, tail = divmod(self.n, self.bs)
        self.nb = n_full + (tail > 0)
        self._prepare(state, device, n_epochs * self.nb)
        long = dict(dtype=torch.long, device=device)
        self.orders = torch.empty((n_epochs, self.n), **long)
        self.rows = {"full": torch.arange(self.bs, **long),
                     "tail": torch.arange(tail, **long)}

    def batch(self, which: str):
        s = self.counter
        e = torch.div(s, self.nb, rounding_mode="floor")
        start = e * self.n + (s - e * self.nb) * self.bs
        order = self.orders.view(-1).index_select(0, start + self.rows[which])
        # this rank's share of the rows inside a sharded step, else all
        order = parallel.local_rows(order)
        return tuple(t.index_select(0, order) for t in self.tensors)

    def run(self, state: TrainState, tensors, orders: List[
            Optional[torch.Tensor]], kind: Optional[str] = None,
            before: Optional[Callable[[int], None]] = None):
        n_epochs = len(orders)
        if self.tensors is None:
            self._setup(state, tensors, n_epochs)
        elif n_epochs != self.n_epochs or any(
                a is not b for a, b in zip(tensors, self.tensors)):
            raise ValueError("every chunk must take the same train tensors "
                             "and epoch count")
        self.orders.copy_(torch.stack([
            torch.arange(self.n) if o is None else o for o in orders]))
        self._begin(state, n_epochs * self.nb)
        tail = self.n % self.bs
        launches = []
        for j in range(n_epochs * self.nb):
            if before is not None:
                before(j)
            launches.append(self._step(
                state, "tail" if tail and j % self.nb == self.nb - 1
                else "full", kind))
        return ({k: v.view(n_epochs, self.nb) for k, v in
                 self._readback(n_epochs * self.nb, kind).items()}, launches)


class GenerativeSteps(StepGraphs):
    """The steps of make_generative_chunk_fn: each draws its batch on the
    device (`sample_fn()`, the ball's videos) and takes the step, whose
    loss draws its noise (and the NP's split) in turn; one graph ("full")
    of that draw -> step.  Every generator these draws come from is
    registered with the graph, so a replay advances it as an eager step
    would.  `run(state, n)` takes n <= `chunk` steps (a short tail is n
    replays, not a new capture) and returns ({metric: (n,) tensor on the
    device}, [launches of each step])."""

    def __init__(self, loss_fn: Callable, sample_fn: Callable, chunk: int,
                 generators: Sequence[Optional[torch.Generator]] = ()):
        super().__init__(loss_fn, generators)
        self.sample_fn, self.chunk, self.ready = sample_fn, chunk, False

    def batch(self, which: str):
        return self.sample_fn()

    def run(self, state: TrainState, n: int):
        if not 0 < n <= self.chunk:
            raise ValueError(f"{n} steps: a call takes 1..{self.chunk}")
        if not self.ready:
            device = next(iter(named_tensors(state.params).values())).device
            self._prepare(state, device, self.chunk)
            self.ready = True
        self._begin(state, n)
        launches = [self._step(state, "full") for _ in range(n)]
        return self._readback(n), launches


class CapturedCall:
    """fn() -> outputs, with no arguments (it reads tensors at fixed
    addresses): the first call runs fn once eagerly on a side stream (the
    warm-up: its outputs are dropped, its launches taken out of the
    counters and its draws given back: each generator of `generators`
    returns to its state before it), captures it with those generators
    registered and replays it; later calls replay, each advancing the
    generators as an eager call would.  Returns the graph's outputs,
    which the next call overwrites."""

    def __init__(self, fn: Callable,
                 generators: Sequence[torch.Generator] = ()):
        self.fn, self.graph, self.generators = fn, None, list(generators)

    def __call__(self):
        if self.graph is None:
            stream = torch.cuda.Stream()
            before = ops.launch_counts()
            states = [g.get_state() for g in self.generators]
            with cusolver_linalg(), side_stream(stream):
                self.fn()
            for g, st in zip(self.generators, states):
                g.set_state(st)
            ops.add_launch_counts(launch_delta(before), -1)
            self.graph = Graph(self.fn, stream, self.generators)
        return self.graph.replay()


class CallPerShape:
    """fn(*inputs), for inputs given as tensors on any device or as arrays
    (JAX's jitted function, one program per input shape).  With
    `captured` each shape and dtype of the inputs is one CapturedCall: a
    call copies its inputs into that shape's static buffers on `device`,
    outside the graph, replays it and returns copies of its outputs
    (the next replay overwrites the graph's own); else fn runs eagerly on
    the inputs moved to `device`.  `graphs`: {(shapes and dtypes): Graph}
    of the calls captured so far."""

    def __init__(self, fn: Callable, device: torch.device,
                 generators: Sequence[torch.Generator] = (),
                 captured: bool = True):
        self.fn, self.device, self.generators = fn, device, generators
        self.captured = captured
        self.calls: Dict[tuple, tuple] = {}

    def __call__(self, *inputs):
        inputs = [torch.as_tensor(x) for x in inputs]
        if not self.captured:
            return self.fn(*(x.to(self.device) for x in inputs))
        key = tuple((tuple(x.shape), x.dtype) for x in inputs)
        if key not in self.calls:
            static = [torch.empty(x.shape, dtype=x.dtype, device=self.device)
                      for x in inputs]
            self.calls[key] = (static, CapturedCall(
                lambda: self.fn(*static), self.generators))
        static, call = self.calls[key]
        for buf, x in zip(static, inputs):
            buf.copy_(x)
        return tuple(t.clone() for t in call())

    @property
    def graphs(self) -> Dict[tuple, Graph]:
        return {k: c.graph for k, (_, c) in self.calls.items()
                if c.graph is not None}
