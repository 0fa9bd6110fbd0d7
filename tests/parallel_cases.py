"""The rank side of tests/test_torch_parallel*.py: spawn a gloo group of
CPU ranks once per test file, run every case of that file in it, and
hand rank 0's results back.  Imports no jax: the ranks run the port
alone, on inputs that the test process built (and on which it computes
the references).

    results = run_ranks(world, {"name": (case_fn_name, kwargs)}, inputs,
                        tmp_dir)

Each case is a function of this module, called on every rank inside the
group as case(inputs, **kwargs); rank 0's return values come back by
name.  Stdout of the ranks is dropped.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import torch

KAPPA = float(np.sqrt(0.02))
ALPHA = 0.9
F64 = torch.float64


def _rank(index, world, init_method, cases, inputs_path, out_path,
          threads):
    sys.stdout = open(os.devnull, "w")
    torch.set_num_threads(threads)
    from svgpvae_tpu_torch import parallel
    parallel.init(index, world, init_method, "cpu")
    try:
        inputs = torch.load(inputs_path, weights_only=False)
        results = {}
        for name, (fn, kwargs) in cases.items():
            results[name] = globals()[fn](inputs, **kwargs)
        if index == 0:
            torch.save(results, out_path)
    finally:
        parallel.shutdown()


class Ranks:
    """`world` spawned CPU ranks running `cases`; `results()` waits for
    them (the test process may compute its references meanwhile) and
    returns rank 0's results."""

    def __init__(self, world: int, cases: dict, inputs: dict, tmp_dir,
                 threads: int = 1):
        import torch.multiprocessing as mp
        tmp_dir = str(tmp_dir)
        inputs_path = os.path.join(tmp_dir, "inputs.pt")
        self.out_path = os.path.join(tmp_dir, "results.pt")
        torch.save(inputs, inputs_path)
        self.ctx = mp.start_processes(
            _rank, args=(world, "file://" + os.path.join(tmp_dir, "rdzv"),
                         cases, inputs_path, self.out_path, threads),
            nprocs=world, join=False, start_method="spawn")
        self._results = None

    def results(self) -> dict:
        if self._results is None:
            while not self.ctx.join():
                pass
            self._results = torch.load(self.out_path, weights_only=False)
        return self._results


def run_ranks(world: int, cases: dict, inputs: dict, tmp_dir,
              threads: int = 1) -> dict:
    """Run `cases` on `world` spawned CPU ranks; rank 0's results."""
    return Ranks(world, cases, inputs, tmp_dir, threads).results()


# --- the sharded fits and one training step ---------------------------------


class LinVAE(torch.nn.Module):
    """A stand-in VAE with the image nets' interface: linear maps from the
    flattened images to the encoder's means and (softplus) variances,
    and from the latents back to images."""

    def __init__(self, W_mu, W_v, W_d, shape):
        super().__init__()
        self.W_mu, self.W_v, self.W_d = (torch.nn.Parameter(torch.tensor(w))
                                         for w in (W_mu, W_v, W_d))
        self.shape = tuple(shape)

    def encode(self, x):
        flat = x.reshape(len(x), -1)
        return flat @ self.W_mu, torch.nn.functional.softplus(
            flat @ self.W_v) + 0.05

    def decode(self, z):
        return (z @ self.W_d).reshape(len(z), *self.shape)


class LinRepr(torch.nn.Module):
    """A stand-in SPRITES repr net: one linear map of the flattened
    frames."""

    def __init__(self, W):
        super().__init__()
        self.W = torch.nn.Parameter(torch.tensor(W))

    def forward(self, x):
        return x.reshape(len(x), -1) @ self.W


def port_gp(d: dict):
    """The port's GP (float64) from a problem's numpy fields."""
    from svgpvae_tpu_torch import gp as tgp
    cfg = tgp.SVGPConfig(**d["config"])
    t = {k: torch.tensor(v) for k, v in d["gp"].items()}
    if d["family"] == "mnist":
        return tgp.MnistSVGP(config=cfg, **t)
    return tgp.SpritesSVGP(config=cfg, **t, L_action=d["L_action"],
                           use_se_kernel=d.get("se", False))


def fit_case(inputs, key):
    """parallel.sharded_precompute_gp_params, or with aux_test
    sharded_posterior_params, over the group."""
    from svgpvae_tpu_torch import parallel
    d = inputs[key]
    gp = port_gp(d)
    t = {k: torch.tensor(d[k]) for k in ("means", "variances", "aux")}
    with torch.no_grad(), parallel.active(parallel.group().world):
        if "aux_test" in d:
            out = parallel.sharded_posterior_params(
                gp, torch.tensor(d["aux_test"]), t["aux"], t["means"],
                t["variances"])
        else:
            out = parallel.sharded_precompute_gp_params(
                gp, t["means"], t["variances"], t["aux"])
    return [o.numpy() for o in out]


def step_case(inputs, key, impl):
    """One train.train_step of forward_pass_svgpvae (GECO) on the stand-in
    nets, this rank's rows of the batch and of the draw: the loss, the
    GECO state after it and every gradient (summed across ranks)."""
    from svgpvae_tpu_torch import models, parallel, train
    d = inputs[key]
    params = {"vae": LinVAE(d["W_mu"], d["W_v"], d["W_d"],
                            d["images"].shape[1:]), "gp": port_gp(d)}
    sprites = d["family"] == "sprites"
    if sprites:
        params["repr"] = LinRepr(d["W_repr"])
    trainable = train.trainable_tensors(params, lambda name: True)
    state = train.TrainState(
        params=params, optimizer=train.make_optimizer(trainable, 1e-3),
        geco=train.GECOState(C_ma=torch.tensor(d["C_ma"], dtype=F64),
                             lagrange_mult=torch.tensor(d["lagrange"],
                                                        dtype=F64)))
    eps = torch.tensor(d["eps"])

    def loss_fn(params, batch, geco, step):
        out = models.forward_pass_svgpvae(
            params["vae"], params["gp"], batch, parallel.local_rows(eps),
            beta=1.0, C_ma=geco.C_ma, lagrange_mult=geco.lagrange_mult,
            alpha=ALPHA, kappa=KAPPA, clip_qs=True, geco=True,
            gp_block_impl=impl, repr_net=params.get("repr"),
            frames_per_char=d.get("fpc", 0))
        # the loss is the small difference of these (its tolerance's scale)
        terms = (out.inside_elbo.abs() + out.ce_term.abs()).detach()
        return out.elbo, (train.GECOState(C_ma=out.C_ma,
                                          lagrange_mult=out.lagrange_mult),
                          {"terms": terms})

    batch = (torch.tensor(d["images"]), torch.tensor(d["aux"]))
    with parallel.active(parallel.group().world), parallel.sharded():
        m = train.train_step(state, tuple(parallel.local_rows(t)
                                          for t in batch), loss_fn)
    return {"loss": float(m["loss"]), "terms": float(m["terms"]),
            "C_ma": float(state.geco.C_ma),
            "lagrange": float(state.geco.lagrange_mult),
            "grads": {k: t.grad.numpy().copy() for k, t in trainable.items()}}


# --- the drivers ------------------------------------------------------------


def mnist_splits(n_eval: int = 100) -> dict:
    """202 train rows (two full batches of 100 and a tail of 2 at
    --batch_size 100); eval and test cut to n_eval rows."""
    from svgpvae_tpu_torch import data as tdata
    base = tdata.synthetic_digit_base_images("36", per_digit=10, seed=0)
    out = tdata.generate_rotated_mnist(base, None, digits="36", seed=0)
    for split in ("eval", "test"):
        out[split] = {k: v[:n_eval] for k, v in out[split].items()}
    return out


def sprites_splits(n_train_chars: int = 7, n_test_chars: int = 2) -> dict:
    """By default 7 train characters (350 frames: two full batches of 150
    and a tail of 50 at --batch_size 150) and 2 unseen ones."""
    from svgpvae_tpu_torch import data as tdata
    return tdata.generate_synthetic_sprites(n_train_chars=n_train_chars,
                                            n_test_chars=n_test_chars,
                                            n_frames_train=50, seed=0)


def summary(res: dict) -> dict:
    """What a driver run is compared on: the per-step metrics, the
    parameters, the GECO state, the eval rows, the captured step's
    gradients, the pictures' records (without their times) and the run
    dir."""
    from svgpvae_tpu_torch import train
    state = res["state"]
    cap = res.get("captured")
    return {"metrics": res["metrics"],
            "params": {k: t.detach().numpy().copy() for k, t in
                       train.named_tensors(state.params).items()},
            "geco": None if state.geco is None else (
                float(state.geco.C_ma), float(state.geco.lagrange_mult)),
            "evals": [{k: v for k, v in e.items()
                       if k not in ("seconds", "launches")}
                      for e in res.get("evals", [])],
            "grads": None if cap is None else {
                k: g.numpy().copy() for k, g in cap["grads"].items()},
            "pictures": [{k: v for k, v in p.items() if k != "seconds"}
                         for p in res.get("pictures", [])],
            "run_dir": res.get("run_dir")}


def shared_run_dir(base: str) -> str:
    """The one run dir under `base` (<base>/<expid>/<run>), once rank 0
    has written it: every rank waits at a barrier first."""
    import glob
    import torch.distributed as dist
    dist.barrier()
    runs = glob.glob(os.path.join(base, "*", "*"))
    assert len(runs) == 1, runs  # rank 0 alone makes a run dir
    return runs[0]


def driver_case(inputs, driver, argv, data=None, capture_step=None,
                resume_argv=None):
    """cli.<driver>.main(argv) over the group (argv holds --data_parallel
    N); with resume_argv a second run continues the first's run dir
    (--base_dir is argv's last value)."""
    import importlib
    mod = importlib.import_module(f"svgpvae_tpu_torch.cli.{driver}")
    kw = {} if capture_step is None else {"capture_step": capture_step}
    if data == "mnist":
        kw["splits"] = mnist_splits()
    elif data == "sprites":
        kw["splits"] = sprites_splits()
    res = summary(mod.main(argv, **kw))
    if resume_argv is None:
        return res
    run_dir = shared_run_dir(argv[-1])
    kw.pop("capture_step", None)
    return dict(summary(mod.main(resume_argv + ["--resume_dir", run_dir],
                                 **kw)), first=res)


def serve_case(inputs, base, argv):
    """cli.serve.main on the SPRITES run dir that an earlier case wrote
    under `base`."""
    from svgpvae_tpu_torch.cli import serve
    res = serve.main(["--run_dir", shared_run_dir(base)] + argv,
                     splits=sprites_splits())
    served = res["state"]["served"][0]
    return {"p_m": served["p_m"].numpy().copy(),
            "p_v": served["p_v"].numpy().copy(),
            "fit_launches": res["fit_launches"]}


# --- the data-parallel graph paths (tests/test_torch_parallel_graphs.py) ----


def replayed_eps(draws: dict):
    """eps_fn handing out a recorded run's draws ({kind: [(shape, array),
    ...]} in the order that run drew them), with a `generator`, so the
    drivers' graph paths take it (the stand-in graphs call it anew at
    every replay, so it hands out the next draw each time)."""
    queues = {k: list(v) for k, v in draws.items()}

    def eps_fn(kind, shape):
        want, a = queues[kind].pop(0)
        assert tuple(shape) == tuple(want), (kind, shape, want)
        return torch.from_numpy(np.array(a))

    eps_fn.generator = torch.Generator()
    return eps_fn


def _run_driver(driver, argv, data, draws, inputs, graphs: bool) -> dict:
    """cli.<driver>.main(argv) on `data`'s splits ("mnist", or "sprites"
    with sprites_splits' arguments) and `draws`' recorded noise (a key of
    `inputs`), on the drivers' graph path with the CPU stand-in graphs
    (tests/graph_standins.py) or, under gloo, per step; its summary, the
    all-reduces it issued and its graphs' replays."""
    import importlib
    import graph_standins
    from svgpvae_tpu_torch import parallel
    mod = importlib.import_module(f"svgpvae_tpu_torch.cli.{driver}")
    kind, *args = data
    kw = {"splits": mnist_splits() if kind == "mnist"
          else sprites_splits(*args)}
    if draws is not None:
        kw["eps_fn"] = replayed_eps(inputs[draws])
    before = parallel.all_reduce_count()
    with graph_standins.patched() if graphs else contextlib.nullcontext():
        res = mod.main(argv, **kw)
    return dict(summary(res), all_reduces=parallel.all_reduce_count()
                - before, graph_replays=res.get("graph_replays"),
                steps=len(res["metrics"]))


def graph_pair_case(inputs, driver, argv, data, draws=None) -> dict:
    """The driver's data-parallel run (argv holds --data_parallel N) per
    step, as gloo runs it, then on its graph path: {"per_step",
    "graphs"}."""
    return {"per_step": _run_driver(driver, argv, data, draws, inputs,
                                    False),
            "graphs": _run_driver(driver, argv, data, draws, inputs, True)}


def graph_case(inputs, driver, argv, data, draws=None) -> dict:
    """The driver's data-parallel run on its graph path alone."""
    return _run_driver(driver, argv, data, draws, inputs, True)
