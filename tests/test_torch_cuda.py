"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here carries the `cuda` marker and skips without a CUDA device
(the decision is made in a fixture).  The file imports no JAX, so it runs
on a machine with a card and no jax (skipping tests/conftest.py, which
imports jax):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: fp32 kernel vs fp32 twin, the same sums in another order;
max abs error <= 1e-4 of max|twin| (as chip_smoke.py: the random-walk
estimate sqrt(n)*eps is ~1e-5 of the scale at these n).

B1 (chol_inverse), Gauss-Jordan against the Cholesky twin and float64, on
PD stacks of condition up to 1e4 (m <= 37) and 1e3 (m >= 64): the inverse
within 5e-4 of its own max |entry|, logdet within rtol 1e-5 (1e-4 at
m >= 72) -- the tolerances tests/test_fused_gp.py holds the TPU kernel to,
since both methods are backward-stable at ~cond * eps.

The kernels have forms that the library picks by shape: B2 one launch
(m <= 64, n <= 256), small-m chunks plus a reduce, or the partial-sum
kernel plus a reduce (m > 64); B3 a K-build kernel (compiled-in or
run-time feature widths) and then B2's form for the shape; B1 one warp
per matrix (m <= 32), one block per matrix in registers (m <= 80) or
two kernels per panel of 32 pivots on the matrix in device memory (above
it, no limit).  The cases cover both sides
of each boundary, and every form is checked to give the same bits from
run to run and to replay from a CUDA graph.
"""

import numpy as np
import pytest
import torch

from svgpvae_tpu_torch import gp as tgp, linalg as tlinalg
from svgpvae_tpu_torch.ops import chol_inverse as ci
from svgpvae_tpu_torch.ops import fused_kernel_stats as fks
from svgpvae_tpu_torch.ops import gp_stats as gps

KERNEL_RTOL = 1e-4
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(rng, device, n, m, L, d1=0, d2=0, family="sprites"):
    if family == "mnist":
        f1 = rng.rand(n, d1) * 2 * np.pi
        ip1 = rng.rand(m, d1) * 2 * np.pi
    else:
        f1, ip1 = rng.randn(n, d1), rng.randn(m, d1)
    arrs = (f1, rng.randn(n, d2), ip1, rng.randn(m, d2), rng.rand(n, L) + 0.5,
            rng.randn(n, L), rng.randn(n, m))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrs]


def _assert_close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= KERNEL_RTOL * scale


# The launch plan's regimes: B2 at m <= 64 runs one block per channel and
# n chunk, in one launch up to n = 256 (the training step's 256 and 164
# rows) and in chunks plus a reduce above; m > 64 (and B3) run the
# two-pass partial-sum kernel.
SMALL_MAX_M, SMALL_CHUNK_ROWS = 64, 256
GP_STATS_CASES = [(1, 1, 1), (130, 17, 3), (5000, 72, 64), (777, 129, 9),
                  (256, 32, 16), (164, 32, 16), (8100, 32, 16),
                  (SMALL_CHUNK_ROWS, 32, 16), (SMALL_CHUNK_ROWS + 1, 32, 16),
                  (300, 33, 5), (4000, 33, 5), (100, SMALL_MAX_M, 3),
                  (100, SMALL_MAX_M + 1, 3),
                  (500, 72, 64), (360, 72, 64)]  # SPRITES step, test batch


@pytest.mark.parametrize("n,m,L", GP_STATS_CASES)
def test_gp_stats_kernel_matches_twin(cuda, n, m, L):
    *_, prec, py, knm = _inputs(np.random.RandomState(n + m), cuda, n, m, L)
    before = gps.gp_sufficient_stats.launches
    got = gps.gp_sufficient_stats(knm, prec, py)
    torch.cuda.synchronize()
    assert gps.gp_sufficient_stats.launches == before + 1
    _assert_close(got, gps.gp_sufficient_stats_reference(knm, prec, py))


# B3 writes K with a kernel compiled for d = 8 + 16 (sprites) and 1 + 8
# (mnist), other widths taking the run-time form, then runs B2's plan on
# it: one launch (m <= 64, n <= 256), small-m chunks, or partial sums.
FEATURE_CASES = [
    # family, n, m, d1, d2, L
    ("mnist", 200, 20, 1, 8, 4),
    ("mnist", 131, 9, 1, 5, 3),
    ("sprites", 150, 30, 3, 5, 6),
    ("sprites", 97, 13, 8, 16, 5),
    ("sprites", 5000, 72, 8, 16, 64),
    # L not a multiple of 4 (a ragged last channel group) or of 16
    ("sprites", 700, 72, 8, 16, 9),
    ("sprites", 2000, 72, 8, 16, 63),
    ("sprites", 300, 30, 2, 7, 5),
    # n below one 64-row tile, and n not a multiple of 64
    ("sprites", 40, 72, 8, 16, 16),
    ("mnist", 1000, 33, 1, 8, 8),      # and >= 3 tiles (normalize too)
    ("mnist", 3000, 72, 1, 8, 64),
    ("mnist", 500, 40, 3, 5, 12),      # mnist, run-time form
]


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("family,n,m,d1,d2,L", FEATURE_CASES)
def test_fused_kernel_matches_twin(cuda, family, n, m, d1, d2, L, normalize):
    f1, f2, ip1, ip2, prec, py, _ = _inputs(np.random.RandomState(n + m),
                                            cuda, n, m, L, d1, d2, family)
    amp, ls = (0.9, 1.3) if family == "mnist" else (None, None)
    before = fks.fused_kernel_stats.launches
    got = fks.fused_kernel_stats(f1, f2, ip1, ip2, prec, py, amp, ls, family,
                                 normalize)
    torch.cuda.synchronize()
    assert fks.fused_kernel_stats.launches == before + 1
    _assert_close(got, fks.fused_kernel_stats_reference(
        f1, f2, ip1, ip2, prec, py, amp, ls, family, normalize))


@pytest.mark.parametrize("name,m", [("gp_sufficient_stats", 520),
                                    ("fused_kernel_stats", 400)])
def test_large_m_runs_with_a_shorter_tile(cuda, name, m):
    """A 128-row tile of this m overflows shared memory; the launch picks
    a shorter one."""
    f1, f2, ip1, ip2, prec, py, knm = _inputs(np.random.RandomState(m), cuda,
                                              300, m, 10, 8, 16)
    if name == "gp_sufficient_stats":
        got = gps.gp_sufficient_stats(knm, prec, py)
        want = gps.gp_sufficient_stats_reference(knm, prec, py)
    else:
        got = fks.fused_kernel_stats(f1, f2, ip1, ip2, prec, py,
                                     family="sprites")
        want = fks.fused_kernel_stats_reference(f1, f2, ip1, ip2, prec, py,
                                                family="sprites")
    _assert_close(got, want)


def test_fused_normalize_clamps_zero_rows(cuda):
    f1, f2, ip1, ip2, prec, py, _ = _inputs(np.random.RandomState(3), cuda,
                                            70, 11, 2, 3, 4)
    f1[5] = 0.0
    f2[9] = 0.0
    got = fks.fused_kernel_stats(f1, f2, ip1, ip2, prec, py,
                                 family="sprites", normalize=True)
    want = fks.fused_kernel_stats_reference(f1, f2, ip1, ip2, prec, py,
                                            family="sprites", normalize=True)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _assert_close(got, want)


@pytest.mark.parametrize("n,m,L,single_launch", [(256, 32, 16, True),
                                                  (164, 32, 16, True),
                                                  (8100, 32, 16, False),
                                                  (500, 72, 64, False),
                                                  (360, 72, 64, False),
                                                  (50_000, 72, 64, False)])
def test_gp_stats_plan_regimes(cuda, n, m, L, single_launch):
    """The MNIST training step's shapes take one launch and no workspace;
    the cgen and fit shapes and the SPRITES step and test batch (m = 72)
    two passes, with every block resident in one
    wave, and the fit's partial-sum kernel at >= 2 blocks per SM.  None
    of them spills.  B3 runs the same plan after its K-build kernel; at
    the fit its partial-sum kernel keeps 4 blocks (12 warps) per SM."""
    plan = gps.launch_plan(n, m, L, cuda)
    info = gps.kernel_info(n, m, L, cuda)
    assert (plan[0] == 0) == single_launch == bool(info["single_launch"])
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert info["grid_blocks"] <= info["blocks_per_sm"] * sms
    if m > SMALL_MAX_M:
        assert info["blocks_per_sm"] >= 2
    assert info["local_bytes"] == 0 and info["registers"] <= 168
    b3 = gps.kernel_info(n, m, L, cuda, 8, 16)
    assert b3["build_blocks_per_sm"] >= 1
    assert {k: b3[k] for k in gps.INFO_KEYS[:9]} == {
        k: info[k] for k in gps.INFO_KEYS[:9]}  # the same plan as B2
    if (n, m, L) == (50_000, 72, 64):
        assert info["blocks_per_sm"] >= 4


def _deterministic_case(case, cuda):
    rng = np.random.RandomState(5)
    if case[0] == "chol_inverse":
        _, B, m = case
        m = _b1_m(m, cuda)
        M = torch.from_numpy(_pd_stack(rng, B, m, 1e3).astype(np.float32))
        M = M.to(cuda)
        return lambda: ci.chol_inverse_kernel(M)
    name, n, m, L = case
    f1, f2, ip1, ip2, prec, py, knm = _inputs(rng, cuda, n, m, L, 8, 16)
    if name == "fused_kernel_stats":
        return lambda: fks.fused_kernel_stats(f1, f2, ip1, ip2, prec, py,
                                              family="sprites")
    return lambda: gps.gp_sufficient_stats(knm, prec, py)


@pytest.mark.parametrize("case", [
    ("fused_kernel_stats", 3000, 72, 16),
    ("fused_kernel_stats", 50_000, 72, 64),    # the serve's fit
    ("gp_sufficient_stats", 256, 32, 16),      # single launch
    ("gp_sufficient_stats", 8100, 32, 16),     # two passes
    ("gp_sufficient_stats", 50_000, 72, 64),   # two passes, many chunks
    ("chol_inverse", 17, 32),                  # one warp per matrix
    ("chol_inverse", 65, 72),                  # blocked, in registers
    ("chol_inverse", 5, "limit"),              # blocked, largest tile
    ("chol_inverse", 65, 288),                 # panel form
    ("chol_inverse", 3, "limit+1"),            # panel form, ragged panel
])
def test_kernels_are_deterministic(cuda, case):
    run = _deterministic_case(case, cuda)
    a = run()
    b = run()
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kernel_wrappers_reject_what_they_cannot_take(cuda):
    knm = torch.randn(16, 8, device=cuda)
    prec = torch.rand(16, 2, device=cuda)
    with pytest.raises(TypeError):
        gps.gp_sufficient_stats(knm.double(), prec.double(), prec.double())
    with pytest.raises(ValueError, match="contiguous"):
        gps.gp_sufficient_stats(knm.T.contiguous().T, prec, prec)
    with pytest.raises(ValueError, match="CUDA"):
        gps.gp_sufficient_stats(knm, prec.cpu(), prec)


def _pd_stack(rng, B, m, cond):
    out = np.empty((B, m, m))
    for i in range(B):
        Q, _ = np.linalg.qr(rng.randn(m, m))
        out[i] = (Q * np.logspace(0, np.log10(cond), m)) @ Q.T
    return out


# m <= 32 runs one warp per matrix (padded in registers); above, up to
# m = 80, one block per matrix held in registers; above that the panel
# form.  "limit" and "limit+1" stand for the blocked form's limit and one
# past it (asked of the library inside the test).  The condition
# of the small stacks is lower: logdet's fp32 error is ~cond * eps
# absolute, and |logdet| grows with m (~9 at m = 2 and cond 1e4, where
# rtol 1e-5 would not hold).  B * m^3 is capped to keep the file fast.
B1_COND = {1: 1.0, 2: 1e2, 17: 1e3, 31: 1e4, 32: 1e4, 33: 1e4}
B1_LARGE_M = [64, 100, 129, 160, 200, "limit", "limit+1", 256, 288, 512]
B1_MAX_WORK = 3e9  # B * m^3
B1_CASES = [(17, 32, 1e4), (65, 72, 1e3), (5, 37, 1e4), (5, 15, 1e4),
            (3, 1, 1.0), (2, 130, 1e2)] + [
    (B, m, cond) for m, cond in B1_COND.items()
    for B in (1, 17, 33) if (B, m) != (17, 32)] + [
    (B, m, 1e3) for m in B1_LARGE_M for B in (1, 17, 65)
    if isinstance(m, str) or B * m ** 3 <= B1_MAX_WORK]


def _b1_m(m, device) -> int:
    """An m of the cases: a number, or the blocked form's limit
    ("limit") or one past it ("limit+1")."""
    if isinstance(m, int):
        return m
    return ci.max_blocked_m(device) + (m == "limit+1")


def _b1_form(m, device) -> str:
    return ("warp" if m <= 32 else
            "blocked" if m <= ci.max_blocked_m(device) else "panel")


@pytest.mark.parametrize("B,m,cond", B1_CASES)
def test_chol_inverse_kernel_matches_twin_and_f64(cuda, B, m, cond):
    m = _b1_m(m, cuda)
    a = _pd_stack(np.random.RandomState(B + m), B, m, cond)
    M = torch.from_numpy(a.astype(np.float32)).to(cuda)
    assert ci.kernel_info(B, m, cuda)["form"] == _b1_form(m, cuda)
    before = ci.chol_inverse_kernel.launches
    inv, ld = ci.chol_inverse_kernel(M)
    torch.cuda.synchronize()
    assert ci.chol_inverse_kernel.launches == before + 1
    inv_t, ld_t = ci.chol_inverse_reference(M)
    inv64 = np.linalg.inv(a.astype(np.float32).astype(np.float64))
    ld64 = np.linalg.slogdet(a.astype(np.float32).astype(np.float64))[1]
    rtol_ld = 1e-4 if m >= 72 else 1e-5
    for want_inv, want_ld in ((inv_t.cpu().double().numpy(),
                               ld_t.cpu().double().numpy()), (inv64, ld64)):
        scale = np.abs(want_inv).max()
        np.testing.assert_allclose(inv.cpu().double().numpy() / scale,
                                   want_inv / scale, atol=5e-4)
        np.testing.assert_allclose(ld.cpu().double().numpy(), want_ld,
                                   rtol=rtol_ld, atol=1e-6)


@pytest.mark.parametrize("m", [4, 32, 40, 100, "limit", "limit+1", 300])
def test_chol_inverse_kernel_gives_nan_logdet_off_pd(cuda, m):
    """Every form: a pivot <= 0 makes that matrix's logdet NaN, and the
    other matrix's logdet stays exact."""
    m = _b1_m(m, cuda)
    M = torch.eye(m, device=cuda).repeat(2, 1, 1)
    M[1, 2, 2] = -1.0
    _, ld = ci.chol_inverse_kernel(M)
    assert float(ld[0]) == 0.0 and bool(torch.isnan(ld[1]))
    assert ci.kernel_info(2, m, cuda)["form"] == _b1_form(m, cuda)


def test_chol_inverse_kernel_refuses_what_it_cannot_take(cuda):
    with pytest.raises(TypeError):
        ci.chol_inverse_kernel(torch.eye(4, device=cuda, dtype=torch.float64)
                               [None])
    with pytest.raises(ValueError, match="contiguous"):
        ci.chol_inverse_kernel(torch.eye(4, device=cuda).expand(3, 4, 4))


def test_chol_inverse_kernel_takes_m_past_the_on_chip_limit(cuda):
    """m = the blocked form's limit + 1 runs the panel form (two CUDA launches
    per panel of 32 pivots, one counted launch) and matches the twin."""
    m = ci.max_blocked_m(cuda) + 1
    info = ci.kernel_info(4, m, cuda)
    assert info["form"] == "panel" and info["nb"] == 32
    assert info["launches"] == 2 * -(-m // 32)
    assert ci.kernel_info(4, m - 1, cuda)["form"] == "blocked"
    M = torch.from_numpy(_pd_stack(np.random.RandomState(m), 4, m, 1e3)
                         .astype(np.float32)).to(cuda)
    before = ci.chol_inverse_kernel.launches
    inv, ld = ci.chol_inverse_kernel(M)
    assert ci.chol_inverse_kernel.launches == before + 1
    inv_t, ld_t = ci.chol_inverse_reference(M)
    scale = float(inv_t.abs().max())
    assert float((inv - inv_t).abs().max()) <= 5e-4 * scale
    torch.testing.assert_close(ld, ld_t, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("B,m", [(17, 32), (65, 72), (65, 288)])
def test_chol_inverse_kernel_replays_from_a_cuda_graph(cuda, B, m):
    """One call of each form captured into a CUDA graph replays to the
    bits of an eager call (the panel form's workspace comes from the
    graph's pool, and no launch sets a function attribute)."""
    M = torch.from_numpy(_pd_stack(np.random.RandomState(m), B, m, 1e3)
                         .astype(np.float32)).to(cuda)
    want = ci.chol_inverse_kernel(M)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ci.chol_inverse_kernel(M)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = ci.chol_inverse_kernel(M)
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B,m", [(17, 32), (65, 288)])
def test_chol_inverse_autograd_matches_twin_autograd(cuda, B, m):
    """Through M = B B^T + I (dL/dB is unique there); (65, 288) runs the
    panel form."""
    rng = np.random.RandomState(4)
    Bm = torch.tensor(rng.randn(B, m, m) / np.sqrt(m / 32),
                      dtype=torch.float32, device=cuda, requires_grad=True)
    gi = torch.tensor(rng.randn(B, m, m), dtype=torch.float32, device=cuda)
    gl = torch.tensor(rng.randn(B), dtype=torch.float32, device=cuda)

    def grad(fn):
        M = Bm @ Bm.transpose(1, 2) + torch.eye(m, device=cuda)
        inv, ld = fn(M)
        (g,) = torch.autograd.grad(torch.sum(inv * gi) + torch.sum(ld * gl),
                                   Bm)
        return g

    before = ci.chol_inverse_kernel.launches
    got = grad(ci.chol_inverse)
    assert ci.chol_inverse_kernel.launches == before + 1
    want = grad(ci.chol_inverse_reference)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-4 * scale


@pytest.mark.parametrize("n,m,L", [(256, 32, 16),   # MNIST step
                                   (500, 72, 64),   # SPRITES step
                                   (360, 72, 64)])  # SPRITES test batch
def test_gp_stats_backward_matches_twin(cuda, n, m, L):
    rng = np.random.RandomState(8)
    args = [torch.tensor(a, dtype=torch.float32, device=cuda,
                         requires_grad=True)
            for a in (rng.randn(n, m), rng.rand(n, L) + 0.5,
                      rng.randn(n, L))]
    d_sigma = torch.tensor(rng.randn(L, m, m), dtype=torch.float32,
                           device=cuda)
    d_r = torch.tensor(rng.randn(L, m), dtype=torch.float32, device=cuda)

    def grads(fn):
        sigma, r = fn(*args)
        return torch.autograd.grad(torch.sum(sigma * d_sigma)
                                   + torch.sum(r * d_r), args)

    before = gps.gp_sufficient_stats.launches
    got = grads(gps.gp_stats)
    assert gps.gp_sufficient_stats.launches == before + 1
    for g, w in zip(got, grads(gps.gp_sufficient_stats_reference)):
        assert float((g - w).abs().max()) <= KERNEL_RTOL * float(w.abs().max())


@pytest.mark.parametrize("impl", ["chol", "pallas"])
def test_titsias_block_on_the_card_matches_the_cpu(cuda, impl):
    """gp_block_titsias at the MNIST step's shape (b = 256, L = 16,
    m = 32; "pallas": one B1 launch on the (33, 32, 32) stack; both: two
    B2 launches): every output, and the gradients of a weighted sum of
    them with respect to y and the noise, against the CPU twins in fp32,
    within 10x the CPU's own fp32-vs-float64 gap (floored at 1e-6 of each
    quantity's scale), as chip_smoke.py's rechecks."""
    rng = np.random.RandomState(9)
    b, L, M, m, n_obj = 256, 16, 8, 32, 400
    ip = np.hstack([np.arange(m)[:, None], rng.rand(m, 1) * 2 * np.pi,
                    rng.randn(m, M)])
    table = rng.randn(n_obj, M)
    aux = np.hstack([rng.randint(0, n_obj, (b, 1)).astype(float),
                     rng.rand(b, 1) * 2 * np.pi, rng.randn(b, M)])
    y, noise = rng.randn(b, L), np.clip(np.exp(rng.randn(b, L)), 1e-3, 10.)
    weights = [rng.randn(*s) for s in ((b, L), (b, L), (L,), (L,), (L, m))]
    cfg = tgp.SVGPConfig(titsias=True, jitter=1e-6, N_train=8_100)

    def run(device, dtype):
        gp = tgp.init_mnist_svgp(ip, table, config=cfg,
                                 dtype=dtype).to(device)

        def t(a):
            return torch.tensor(a, dtype=dtype, device=device)
        y_t, n_t = t(y).requires_grad_(), t(noise).requires_grad_()
        outs = tgp.gp_block_titsias(gp, t(aux), y_t, n_t,
                                    inverse_impl=impl)
        loss = sum(torch.sum(o * t(w)) for o, w in zip(outs, weights))
        grads = torch.autograd.grad(loss, (y_t, n_t))
        return [x.detach().cpu().double() for x in (*outs, *grads)]

    b1, b2 = ci.chol_inverse_kernel.launches, gps.gp_sufficient_stats.launches
    got = run(cuda, torch.float32)
    assert ci.chol_inverse_kernel.launches == b1 + (impl == "pallas")
    assert gps.gp_sufficient_stats.launches == b2 + 2
    cpu = torch.device("cpu")
    for g, w32, w64 in zip(got, run(cpu, torch.float32),
                           run(cpu, torch.float64)):
        scale = float(w64.abs().max())
        gap = float((w32 - w64).abs().max())
        assert float((g - w32).abs().max()) <= 10 * max(gap, 1e-6 * scale)


def _sprites_step_stacks(device, m=72):
    """The two B1 inputs of one SPRITES step, built as gp_block_hensman
    builds them (b = 500 frames of 10 characters, N_train = 50,000, L = 64,
    m inducing points of L_action 8 + L_character 16, jitter 0.01):
    [K_mm; Sigma_1..64] (65, m, m) with the relative Sigma ridge, and
    A_hat + jitter (64, m, m) with A_hat = K_mm Sigma^-1 K_mm from the
    fp32 twin's inverse, its triangles averaged.  m = 288 is --m 4: K_mm
    has rank <= 128 there, PD only through the jitter."""
    rng = np.random.RandomState(7)
    cfg = tgp.SVGPConfig(jitter=0.01, N_train=50_000)
    gp = tgp.init_sprites_svgp(rng.normal(0, 1.5, (m, 24)),
                               rng.normal(0, 1.5, (72, 8)), L_action=8,
                               config=cfg).to(device)
    aux = np.hstack([rng.randint(0, 72, (500, 1)),
                     np.repeat(rng.rand(10, 16) * 0.5, 50, axis=0)])
    var = np.clip(np.exp(rng.normal(0, 2, (500, 64))), 1e-3, 10.0)
    prec, y = (torch.tensor(a, dtype=torch.float32, device=device)
               for a in (1.0 / var, rng.normal(0, 1, (500, 64))))
    z = gp.inducing_points
    Kmm = gp.kmat(z, z)
    Knm = gp.kmat(torch.tensor(aux, dtype=torch.float32, device=device), z,
                  x_inducing=False)
    contrib, _ = gps.gp_sufficient_stats_reference(Knm, prec, prec * y)
    Sigma = Kmm[None] + (50_000 / 500) * contrib
    M = torch.cat([tlinalg.add_jitter(Kmm, cfg.jitter)[None],
                   tlinalg.add_jitter(Sigma, tgp.svgp.sigma_jitter(Sigma,
                                                                   cfg))])
    inv, _ = ci.chol_inverse_reference(M)
    A_hat = Kmm[None] @ (inv[1:] @ Kmm.expand(64, m, m))
    A_hat = 0.5 * (A_hat + A_hat.transpose(-1, -2))
    return {"sigma": M, "a_hat": tlinalg.add_jitter(A_hat, cfg.jitter)}


def _mnist_step_stack(device, m, jitter):
    """The B1 input of one MNIST step, as gp_block_hensman builds it
    (b = 256, N_train = 8,100, L = 16, M = 8 object dimensions, m
    inducing points on 16 angles): [K_mm; Sigma_1..16] (17, m, m).  At
    m = 256 (--nr_inducing_points 16) K_mm has rank <= 16 x 8 = 128 and
    a condition ~1e6 at jitter 1e-3."""
    rng = np.random.RandomState(11)
    angles = np.repeat(np.linspace(0, 2 * np.pi, 16, endpoint=False),
                       m // 16)[:m, None]
    ip = np.hstack([np.arange(m)[:, None], angles, rng.randn(m, 8)])
    aux = np.hstack([rng.randint(0, 800, (256, 1)),
                     rng.rand(256, 1) * 2 * np.pi, rng.randn(256, 8)])
    cfg = tgp.SVGPConfig(jitter=jitter, N_train=8_100)
    gp = tgp.init_mnist_svgp(ip, None, config=cfg).to(device)
    var = np.clip(np.exp(rng.normal(0, 2, (256, 16))), 1e-3, 10.0)
    prec = torch.tensor(1.0 / var, dtype=torch.float32, device=device)
    z = gp.inducing_points
    Kmm = gp.kmat(z, z)
    Knm = gp.kmat(torch.tensor(aux, dtype=torch.float32, device=device), z,
                  x_inducing=False)
    contrib, _ = gps.gp_sufficient_stats_reference(Knm, prec, prec)
    Sigma = Kmm[None] + (8_100 / 256) * contrib
    return torch.cat([tlinalg.add_jitter(Kmm, jitter)[None],
                      tlinalg.add_jitter(Sigma, tgp.svgp.sigma_jitter(
                          Sigma, cfg))])


# B1 on real stacks: Sigma's ridge bounds its condition near 1e5, past
# the 1e3 of the synthetic cases, so a fixed tolerance does not apply.
# Gauss-Jordan and Cholesky are both backward-stable at ~cond * eps: the
# kernel is held to 10x the fp32 twin's own gap to float64 (its inverse
# normalized by each matrix's max |entry|, its logdet absolute), floored
# at m * 2^-24 of the scale.
B1_REAL_FACTOR = 10.0


@pytest.mark.parametrize("m", [72, 288])  # blocked form, panel form
@pytest.mark.parametrize("stack", ["sigma", "a_hat"])
def test_chol_inverse_kernel_on_sprites_stacks(cuda, stack, m):
    M = _sprites_step_stacks(cuda, m)[stack]
    assert M.shape == ((65, m, m) if stack == "sigma" else (64, m, m))
    _hold_to_twin_gap(M)


@pytest.mark.parametrize("m", [32, 256])  # warp form, panel form
def test_chol_inverse_kernel_on_mnist_stacks(cuda, m):
    """MNIST's stack at --jitter 1e-3, where the panel form once formed U
    as the explicit A_KK^-1 times the row panel and lost positive pivots
    (NaN logdets) on this condition."""
    _hold_to_twin_gap(_mnist_step_stack(cuda, m, 1e-3))


def _hold_to_twin_gap(M):
    inv, ld = ci.chol_inverse_kernel(M)
    inv_t, ld_t = ci.chol_inverse_reference(M)
    a = M.cpu().double().numpy()
    inv64, ld64 = np.linalg.inv(a), np.linalg.slogdet(a)[1]

    def gaps(i, l):
        i = i.cpu().double().numpy()
        rel = np.abs(i - inv64).max(axis=(1, 2)) / np.abs(inv64).max(
            axis=(1, 2))
        return rel.max(), np.abs(l.cpu().double().numpy() - ld64).max()

    floor = M.shape[-1] * 2.0 ** -24
    for got, twin, scale in zip(gaps(inv, ld), gaps(inv_t, ld_t),
                                (1.0, np.abs(ld64).max())):
        assert np.isfinite(got)
        assert got <= B1_REAL_FACTOR * max(twin, floor * scale), \
            (tuple(M.shape), got, twin)


def _ball_step_stack(device, titsias):
    """The B1 input of one ball step, as gp.fused.ball_gp_block(_titsias)
    builds it at the driver's defaults (35 videos of T = 30 frames, two
    channels, m = 15 on the 1..30 grid, length scale 2, jitter 1e-9),
    with encoder variances exp(N(-2, 2^2)) clipped to --clip_qs's range
    [1e-6, 1e3] (Sigma's condition ~2e5): (72, 15, 15) [K_mm;
    Sigma_1..35] per channel, or (142, 15, 15) [K_mm; Sigma; Sigma1]
    under Titsias."""
    from svgpvae_tpu_torch.gp import fused
    rng = np.random.RandomState(13)
    gp = tgp.init_ball_svgp(15, 1.0, 30.0, 2.0, config=tgp.SVGPConfig(
        titsias=titsias, jitter=1e-9)).to(device)
    t = torch.arange(1, 31, dtype=torch.float32, device=device)
    y = torch.tensor(rng.randn(35, 30, 2), dtype=torch.float32,
                     device=device)
    var = torch.tensor(np.clip(np.exp(rng.normal(-2, 2, (35, 30, 2))), 1e-6,
                               1e3), dtype=torch.float32, device=device)
    stacks, kernel = [], fused.chol_inverse

    def recording(M):
        stacks.append(M.detach().clone())
        return kernel(M)

    fused.chol_inverse = recording
    try:
        block = tgp.ball_gp_block_titsias if titsias else tgp.ball_gp_block
        block(gp, t, y, var, inverse_impl="pallas")
    finally:
        fused.chol_inverse = kernel
    return stacks[0]


@pytest.mark.parametrize("titsias", [False, True])
def test_chol_inverse_kernel_on_ball_stacks(cuda, titsias):
    """The ball's stacks in the warp form: with no relative ridge, Sigma's
    condition follows the smallest encoder variance (~2e5 here; 2e7 with
    variances at --clip_qs's floor), so the kernel is held to 10x the
    larger gap to float64 of two fp32 witnesses (the Cholesky twin, plain
    Gauss-Jordan), as chip_smoke.py's phases 9(a) and 14."""
    M = _ball_step_stack(cuda, titsias)
    assert M.shape == ((142, 15, 15) if titsias else (72, 15, 15))
    assert ci.kernel_info(*M.shape[:2], cuda)["form"] == "warp"
    inv, ld = ci.chol_inverse_kernel(M)
    a = M.cpu().double().numpy()
    inv64, ld64 = np.linalg.inv(a), np.linalg.slogdet(a)[1]

    def gaps(i, l):
        i = i.cpu().double().numpy()
        rel = np.abs(i - inv64).max(axis=(1, 2)) / np.abs(inv64).max(
            axis=(1, 2))
        return rel.max(), np.abs(l.cpu().double().numpy() - ld64).max()

    witnesses = [gaps(*ci.chol_inverse_reference(M)),
                 gaps(*ci.gauss_jordan_reference(M))]
    floor = M.shape[-1] * 2.0 ** -24
    for q, (got, scale) in enumerate(zip(gaps(inv, ld),
                                         (1.0, np.abs(ld64).max()))):
        limit = B1_REAL_FACTOR * max(floor * scale, *(w[q] for w in witnesses))
        assert np.isfinite(got) and got <= limit, (q, got, witnesses)
