"""B1 on the stacks a SPRITES --m 4 training run builds, on one card.

    PYTHONPATH=. python3 tools/b1_real_stacks.py [--every 10] [--save FILE]

Runs chip_smoke.py phase 10's SPRITES training (m = 288, 10 pretraining
steps, 100 steps, one eval pass) and keeps both B1 input stacks of every
`--every`-th step ([K_mm; Sigma] (65, 288, 288), A_hat + jitter (64, 288,
288)).  For each stack it prints one JSON line: the largest condition
number in the stack (float64 eigenvalues), and for the kernel and for
four fp32 witnesses -- the Cholesky twin (on the CPU), plain unblocked
Gauss-Jordan (`gauss_jordan_reference`, on the card) and two models of
the panel form's blocking in plain PyTorch (32-pivot panels, on the
card), which differ only in the order of the rank-32 update: "running"
takes the 32 products off each element one at a time, "summed" forms
their sum from zero and subtracts it once -- the gap to a float64
inversion of the same fp32 stack: the inverse's largest error over the
stack, each matrix normalized by its max |entry|, and logdet's largest
absolute error.  Then phase 9(a) as chip_smoke.py runs it on the captured step 60.
`--save` writes step 60's two stacks to an .npz.  TF32 is off.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def panel_model(M, nb=32, summed=True):
    """The panel form's arithmetic in plain PyTorch: per panel of nb
    pivots, the row panel reduced in place one pivot at a time (giving
    U), then every element takes A -= C U, in k order: the sum first and
    one subtraction (`summed`), or one product at a time."""
    import torch
    A = M.clone()
    m = A.shape[-1]
    logdet = torch.zeros(A.shape[0], dtype=A.dtype, device=A.device)
    eye = torch.eye(nb, dtype=A.dtype, device=A.device)
    for k0 in range(0, m, nb):
        kn = min(nb, m - k0)
        K = slice(k0, k0 + kn)
        R = A[:, K, :].clone()
        for k in range(kn):
            c = k0 + k
            p = R[:, k, c].clone()
            logdet += torch.log(p)
            inv = 1.0 / p
            row = R[:, k, :] * inv[:, None]
            col = R[:, :, c].clone()
            R -= col[:, :, None] * row[:, None, :]
            R[:, k, :] = row
            R[:, :, c] = -col * inv[:, None]
            R[:, k, c] = inv
        C = A[:, :, K].clone()
        C[:, K, :] = -eye[:kn, :kn]
        A[:, K, :] = 0
        A[:, :, K] = 0
        if summed:
            S = torch.zeros_like(A)
            for k in range(kn):
                S += C[:, :, k:k + 1] * R[:, k:k + 1, :]
            A -= S
        else:
            for k in range(kn):
                A -= C[:, :, k:k + 1] * R[:, k:k + 1, :]
    return A, logdet


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--every", type=int, default=10)
    p.add_argument("--save", default=None)
    opts = p.parse_args()
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("b1_real_stacks: no CUDA device")
    from svgpvae_tpu_torch import data
    from svgpvae_tpu_torch.cli import serve
    from svgpvae_tpu_torch.gp import fused
    from svgpvae_tpu_torch.ops import chol_inverse as ci
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.gpu_name_and_power(), flush=True)

    def row(M, tag):
        inv64, ld64 = ci.chol_inverse_reference(M.cpu().double())
        ev = torch.linalg.eigvalsh(M.double())
        out = dict(tag=tag, shape=list(M.shape),
                   cond_max=float((ev[:, -1] / ev[:, 0]).max()))
        for name, fn in (
                ("kernel", ci.chol_inverse_kernel),
                ("cholesky_fp32", lambda x: ci.chol_inverse_reference(
                    x.cpu())),
                ("plain_gauss_jordan_fp32", ci.gauss_jordan_reference),
                ("panel_model_running_fp32",
                 lambda x: panel_model(x, summed=False)),
                ("panel_model_summed_fp32", panel_model)):
            inv, ld = fn(M)
            inv = inv.cpu().double()
            rel = ((inv - inv64).abs().amax(dim=(1, 2))
                   / inv64.abs().amax(dim=(1, 2)))
            out[name] = [float(rel.max()),
                         float((ld.cpu().double() - ld64).abs().max())]
        print(json.dumps(out), flush=True)

    splits = data.generate_synthetic_sprites(
        n_train_chars=cs.SERVE_CHARS, n_test_chars=cs.SERVE_CHARS // 4,
        n_frames_train=50, seed=serve.CORPUS_SEED)
    kept, calls, kernel = [], [0], fused.chol_inverse

    def recording(M):  # two calls per step, then the eval pass's
        step, which = divmod(calls[0], 2)
        calls[0] += 1
        if step < cs.SPRITES_STEPS and step % opts.every == 0:
            kept.append((step, which, M.detach().clone()))
        return kernel(M)

    fused.chol_inverse = recording
    try:
        res, _ = cs.phase_sprites_train(
            splits, cs.SPRITES_M4_ARGV, 288, cs.SPRITES_M4_L_CHARACTER,
            cs.SPRITES_PRETRAIN_STEPS // 2, cs.SPRITES_CAPTURE,
            "sprites --m 4 --L_character 36")
    finally:
        fused.chol_inverse = kernel
    for step, which, M in kept:
        row(M, f"step {step} {('[K_mm; Sigma]', 'A_hat + jitter')[which]}")
    if opts.save:
        stacks = cs.sprites_step_stacks(res, cs.SPRITES_M4_ARGV, 288)
        np.savez(opts.save, sigma=stacks[0].cpu().numpy(),
                 a_hat=stacks[1].cpu().numpy())
    cs.phase_sprites_b1(res, cs.SPRITES_M4_ARGV, 288)
    return 0


if __name__ == "__main__":
    sys.exit(main())
