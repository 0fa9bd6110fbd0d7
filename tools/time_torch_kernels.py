"""Time the PyTorch port's CUDA kernels at the main path's shapes on one card.

    PYTHONPATH=. python3 tools/time_torch_kernels.py [--root DIR]
        [--repeats 3] [--kernels K1,K2] [--sweep] [--profile]

For each (kernel, shape) of the main paths -- B2 gp_sufficient_stats at the
MNIST training step (256 and 164 rows), cgen (8,100) and fit (50,000)
shapes and at the SPRITES training step (500, 72, 64) and test batch
(360, 72, 64), B3 fused_kernel_stats at the fit shape (sprites, and beside
it with normalize, in the mnist family with d = 1 + 8, and at L = 16), B1
chol_inverse at (17, 32, 32), (65, 72, 72) and (64, 72, 72), and at the
large-m shapes (17, 256, 256), (65, 288, 288), (64, 288, 288) and
(65, 512, 512), which an older tree may refuse (its row says so) -- it
prints one JSON line:
the time per call (CUDA events over back-to-back calls, the wrapper's
host dispatch included) and the device time per call (one CUDA-graph
replay of 50 captured calls), each measured --repeats times, and the
bound (chip_smoke.py's formulas).
Inputs are made from a seed.

--kernels times only the named kernels (default: all three).

--root DIR imports svgpvae_tpu_torch from DIR instead (an unpacked copy
of another commit, with its own build), so that two commits are compared
in one session on one card: run the script on each, in turns.

--sweep (this tree only) places B2's regime boundary: device time at
m = 32, L = 16 over n, in one launch and in 2, 4 and 8 n chunks plus the
reduce, each forced through the C entry point's plan argument.

--profile traces 10 calls of B2 at (256, 32, 16), of B3 at the fit
shape and of B1 at (65, 72, 72) and the panel form's shapes with
torch.profiler and prints the CUDA kernels and memory operations each
call launched, with their device time per call.

--chol_sweep adds B1's device time at several (B, m), among them both
sides of the blocked form's limit, and the device time of a one-element add_ in
the same kind of graph replay (the floor of one launch).

The card's name and power limit come first.  TF32 is off.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
STATS_SHAPES = [("train_step", 256, 32, 16), ("train_tail", 164, 32, 16),
                ("cgen", 8_100, 32, 16), ("fit", 50_000, 72, 64),
                ("sprites_step", 500, 72, 64),
                ("sprites_test_batch", 360, 72, 64)]
# B3: (tag, n, m, L, family, normalize, d1, d2); the serve's fit first
FUSED_SHAPES = [("fit", 50_000, 72, 64, "sprites", False, 8, 16),
                ("fit_normalize", 50_000, 72, 64, "sprites", True, 8, 16),
                ("fit_mnist", 50_000, 72, 64, "mnist", False, 1, 8),
                ("fit_L16", 50_000, 72, 16, "sprites", False, 8, 16)]
CHOL_SHAPES = [("train", 17, 32, 1e4), ("sprites", 65, 72, 1e3),
               ("sprites_A_hat", 64, 72, 1e3),
               ("mnist_m256", 17, 256, 1e3),       # --nr_inducing_points 16
               ("sprites_m288", 65, 288, 1e3),     # --m 4
               ("sprites_m288_A_hat", 64, 288, 1e3),
               ("scaling_m512", 65, 512, 1e3)]     # the scaling cell
SWEEP_N = [256, 384, 512, 1024, 2048, 4096, 8100]
# B1 over B and m: the warp form, both sides of the blocked form's limit
# (m = 80), and the panel form up to m = 239
CHOL_SWEEP = [(1, 32), (17, 32), (264, 32), (17, 16), (17, 2), (65, 64),
              (65, 80), (65, 81), (65, 128), (65, 160), (65, 200), (65, 239)]


def load_chip_smoke():
    """chip_smoke.py of this tree, for its timers, bounds and inputs."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stats_case(cs, rng, device, n, m, L, fused, family="sprites",
               normalize=False, d1=8, d2=16):
    import torch
    from svgpvae_tpu_torch.ops import fused_kernel_stats as fks
    from svgpvae_tpu_torch.ops import gp_stats as gps
    f1, f2, ip1, ip2, prec, py = (
        torch.from_numpy(a).to(device)
        for a in cs.stats_inputs(rng, n, m, L, d1, d2, family))
    if fused:
        amp, ls = (0.9, 1.3) if family == "mnist" else (None, None)
        return lambda: fks.fused_kernel_stats(f1, f2, ip1, ip2, prec, py,
                                              amp, ls, family, normalize)
    knm = fks.fused_kernel_matrix(f1, f2, ip1, ip2, family="sprites")
    knm = knm.contiguous()
    return lambda: gps.gp_sufficient_stats(knm, prec, py)


def measure(cs, fn, repeats):
    per_call = [cs.cuda_ms(fn, reps=50) for _ in range(repeats)]
    device = [cs.graph_ms(fn) for _ in range(repeats)]
    return per_call, device


def sweep(cs, device, repeats) -> None:
    """B2 at m = 32, L = 16: the single launch against 2, 4 and 8 n
    chunks, over n."""
    import torch
    from svgpvae_tpu_torch.ops import _build
    from svgpvae_tpu_torch.ops import gp_stats as gps
    lib = _build.load()
    m, L = 32, 16
    torch.manual_seed(3)
    gps.launch_plan(50_000, m, L, device)  # sets the kernels' attributes
    for n in SWEEP_N:
        knm = torch.randn(n, m, device=device)
        prec = torch.rand(n, L, device=device) + 0.5
        py = torch.randn(n, L, device=device)
        sigma = torch.empty(L, m, m, device=device)
        r = torch.empty(L, m, device=device)
        plans = {"single": (0, n, 256, 1)}
        for chunks in (2, 4, 8):
            per = -(-n // chunks)
            rows = -(-per // 4) * 4
            plans[f"chunks_{-(-n // rows)}"] = (-(-n // rows), rows, 256, 1)
        want = gps.gp_sufficient_stats_reference(knm, prec, py)
        row = {"n": n, "m": m, "L": L, "plan": list(gps.launch_plan(
            n, m, L, device))}
        for name, plan in plans.items():
            arr = (ctypes.c_int * 4)(*plan)
            ws = (torch.empty(plan[0], L, m, m, device=device),
                  torch.empty(plan[0], L, m, device=device))

            def run():
                stream = torch.cuda.current_stream().cuda_stream
                _build.check(lib.svgp_gp_stats(
                    knm.data_ptr(), prec.data_ptr(), py.data_ptr(),
                    sigma.data_ptr(), r.data_ptr(),
                    ws[0].data_ptr() if plan[0] else None,
                    ws[1].data_ptr() if plan[0] else None, n, m, L, arr,
                    stream), "svgp_gp_stats")
            run()
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max() / w.abs().max())
                      for g, w in zip((sigma, r), want))
            row[name] = dict(graph_ms=[cs.graph_ms(run)
                                       for _ in range(repeats)],
                             rel_err=err)
        print(json.dumps({"sweep": row}), flush=True)


def profile_kernels(cs, device) -> None:
    """torch.profiler over 10 calls of B2 at (256, 32, 16), of B3 at the
    fit shape and of B1 at (65, 72, 72) (blocked form), (17, 256, 256),
    (65, 288, 288) and (65, 512, 512) (panel form): the CUDA kernels and
    memory operations each call launched, with their device time per
    call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from svgpvae_tpu_torch.ops import chol_inverse as ci
    rng = np.random.RandomState(4)
    cases = [("gp_sufficient_stats", (256, 32, 16)),
             ("fused_kernel_stats", (50_000, 72, 64))] + [
        ("chol_inverse", (B, m)) for B, m in ((65, 72), (17, 256),
                                              (65, 288), (65, 512))]
    for name, dims in cases:
        if name == "chol_inverse":
            M = torch.from_numpy(cs.pd_stack(rng, *dims, 1e3)).to(device)
            fn = lambda: ci.chol_inverse_kernel(M)
        else:
            fn = stats_case(cs, rng, device, *dims,
                            fused=name == "fused_kernel_stats")
        fn()
        torch.cuda.synchronize()
        calls = 10
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ops = {}
        for e in prof.events():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.is_user_annotation):
                count, us = ops.get(e.name, (0, 0.0))
                ops[e.name] = (count + 1, us + e.device_time)
        print(json.dumps({"profile": f"{name} {dims}", "calls": calls,
                          "device_ops_per_call": {
                              k: dict(launches=c / calls, us=t / calls)
                              for k, (c, t) in ops.items()}}), flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=None)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--chol_sweep", action="store_true")
    p.add_argument("--kernels", default="gp_sufficient_stats,"
                   "fused_kernel_stats,chol_inverse",
                   help="comma-separated kernels to time")
    opts = p.parse_args()
    kernels = opts.kernels.split(",")
    root = Path(opts.root).resolve() if opts.root else HERE
    sys.path.insert(0, str(root))
    cs = load_chip_smoke()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_kernels: no CUDA device")
    import svgpvae_tpu_torch
    from svgpvae_tpu_torch.ops import _build
    from svgpvae_tpu_torch.ops import chol_inverse as ci
    if Path(svgpvae_tpu_torch.__file__).resolve().parent.parent != root:
        raise SystemExit(f"imported {svgpvae_tpu_torch.__file__}, not "
                         f"from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    device = torch.device("cuda", 0)
    _build.load()
    tree = str(root.relative_to(HERE)) if root != HERE else "."

    rng = np.random.RandomState(0)
    cases = ([("gp_sufficient_stats", tag, (n, m, L), {})
              for tag, n, m, L in STATS_SHAPES]
             + [("fused_kernel_stats", tag, (n, m, L),
                 dict(family=fam, normalize=nz, d1=d1, d2=d2))
                for tag, n, m, L, fam, nz, d1, d2 in FUSED_SHAPES])
    for kernel, tag, (n, m, L), opt in cases:
        if kernel not in kernels:
            continue
        fused = kernel == "fused_kernel_stats"
        fn = stats_case(cs, rng, device, n, m, L, fused, **opt)
        per_call, dev = measure(cs, fn, opts.repeats)
        b_ms, b_by = cs.stats_bound(n, m, L, opt.get("d1", 8),
                                    opt.get("d2", 16), fused=fused)
        print(json.dumps(dict(tree=tree, kernel=kernel, shape=tag,
                              dims=[n, m, L], ms=per_call, graph_ms=dev,
                              bound_ms=b_ms, bound_by=b_by)), flush=True)
    for tag, B, m, cond in CHOL_SHAPES if "chol_inverse" in kernels else []:
        M = torch.from_numpy(cs.pd_stack(rng, B, m, cond)).to(device)
        b_ms, b_by = cs.chol_inverse_bound(B, m)
        row = dict(tree=tree, kernel="chol_inverse", shape=tag,
                   dims=[B, m, m], bound_ms=b_ms, bound_by=b_by)
        try:
            ci.chol_inverse_kernel(M)
        except ValueError as e:  # an older tree's size limit
            print(json.dumps(dict(row, refused=str(e))), flush=True)
            continue
        per_call, dev = measure(cs, lambda: ci.chol_inverse_kernel(M),
                                opts.repeats)
        form = (ci.kernel_info(B, m, device).get("form")
                if hasattr(ci, "launch_plan") else None)
        print(json.dumps(dict(row, form=form, ms=per_call, graph_ms=dev)),
              flush=True)
    if opts.chol_sweep:
        one = torch.zeros(1, device=device)
        print(json.dumps(dict(tree=tree, floor_graph_ms=[
            cs.graph_ms(lambda: one.add_(1.0))
            for _ in range(opts.repeats)])), flush=True)
        for B, m in CHOL_SWEEP:
            M = torch.from_numpy(cs.pd_stack(rng, B, m, 1e3)).to(device)
            print(json.dumps(dict(
                tree=tree, kernel="chol_inverse", dims=[B, m, m],
                graph_ms=[cs.graph_ms(lambda: ci.chol_inverse_kernel(M))
                          for _ in range(opts.repeats)])), flush=True)
    if opts.sweep:
        sweep(cs, device, opts.repeats)
    if opts.profile:
        profile_kernels(cs, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
