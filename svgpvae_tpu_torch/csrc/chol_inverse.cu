// Batched inverse and log-determinant of jittered positive-definite
// matrices on Hopper:
//
//     Minv[b]   = M[b]^{-1}           (B, m, m)
//     logdet[b] = log det M[b]        (B,)
//
// Replaces the Pallas TPU kernel svgpvae_tpu/ops/chol_inverse.py::
// chol_inverse_pallas (bodies _gj_blocked_kernel :57 and _gj_kernel :139,
// pallas_call :220).  The same method: Gauss-Jordan elimination without
// pivoting, which is stable for PD input (the pivots are the positive
// Schur-complement diagonals), and logdet as the sum of the log pivots,
// accumulated in pivot order as the TPU kernel does.  A pivot <= 0 (input
// not PD) makes logdet NaN.  The kernel takes any m: the TPU kernel is
// bounded by VMEM, this one is not bounded at all.
//
// Every form reduces in place (the classic in-place Gauss-Jordan: column
// k of the identity replaces column k of M), which halves the TPU
// kernel's (m, 2m) augmented work and storage.  IEEE fp32 FMA on the CUDA
// cores throughout, no tensor cores: the TPU kernel's lower-precision MXU
// update gave O(1) inverse errors and NaN logdets.  No atomics: every sum
// runs in a fixed order, so two calls give the same bits.  Ragged m is
// padded in registers as diag(M, I), which leaves the inverse's leading
// block and the logdet unchanged; nothing is padded in device memory.
//
// What bounds it on the card.  The elimination does m^3 FMA per matrix
// (2 B m^3 FLOP) on 2 B m^2 x 4 bytes of input and output: at (65, 72)
// 48.5 MFLOP and 2.7 MB, 0.7 us of fp32 arithmetic and 0.8 us of memory
// traffic at the H100's peaks.  None of the forms comes near that: the
// work of one matrix is a chain of m dependent pivot steps, and the card
// has more SMs than the stacks have matrices.  Three forms, by m:
//
// m <= 32 (every MNIST stack, the ball stack at m = 15):
// gauss_jordan_inverse_warp.  One warp owns one matrix and no barrier is
// ever needed:
//   * lane j holds column j in 32 registers; each pivot step moves the
//     rows up by one register (the pivot row to the end), so the pivot row
//     is always register 0, every register index is static, and the pivot
//     loop stays rolled (4 pivots per iteration: fully unrolled, the loop
//     is ~60 KB of code and ran slower);
//   * at pivot k, lane k's column is broadcast by 32 shuffles issued back
//     to back; the rank-1 update is one register FMA per element.  Lane k
//     leaves its own column as it is and scales it by -1/p after the last
//     pivot (the later pivots act on it linearly), so no element needs a
//     select;
//   * 1/p is the hardware's approximate reciprocal plus one Newton step
//     (within about an ulp), then a multiply: IEEE division branches to a
//     slow path for some operands, and a branch in the loop keeps one
//     pivot's update from overlapping the next pivot's shuffles;
//   * one warp (matrix) per block: with four, the same loop ran ~1.6x
//     slower on an H100.
// Bound by the 32 dependent pivot steps (32 shuffles and 31 FMAs per lane
// each) and the launch.
//
// 32 < m <= 80 (the SPRITES stacks at m = 72):
// gauss_jordan_blocked, a register-resident, panel-blocked Gauss-Jordan.
// One block owns one matrix.  T x T tile threads each hold a fixed A x A
// tile of it in registers for all pivots (rows ty + T a, columns tx + T b:
// the padding spreads evenly and the loads coalesce), and a panel warp
// holds no tile.  Device memory is read once and written once.  The
// pivots run in panels of NB = 8; for the panel K of columns
// k0 .. k0+NB-1:
//   (a) the owners write the NB x E row panel A[K, :] and the column panel
//       A[:, K] (transposed, rows of K as -identity) to shared memory and
//       zero their elements in either;
//   (b) the panel warp runs the NB-pivot Gauss-Jordan on the row panel in
//       registers with shuffles, giving U = [A_KK^-1 | A_KK^-1 A_K,rest]
//       in place, and the panel's pivots;
//   (c) every tile thread applies A_ij -= C_iK U_Kj to its own tile: the
//       rank-NB update of the rest, -A_iK A_KK^-1 in the panel's columns,
//       and U itself in the panel's rows (through the -identity rows of C).
// With a lookahead: the rows of panel K+1 take panel K's update first and
// go to the panel warp (named barrier 1, arrive and wait), which reduces
// them while the rest of the tile takes the update.  One block-wide
// barrier and one named barrier per panel (9 each at m = 72, where the
// one-block shared-memory form this replaces took 144 block-wide
// barriers, two per pivot); the panels are double-buffered, so one
// panel's writes never wait on the last panel's reads.  The panel warp
// lays its columns out rotated by k0, so the panel's diagonal block is
// always register 0 of lanes 0 .. NB-1 and no register index depends on
// the panel.  The tile is templated on the extent E = T A it covers, so
// every register index is static.  Two tiles, extents 64 and 80 (16 x 16
// threads holding 4 x 4 or 5 x 5 elements each), for the stacks the paths
// run in this range, m = 37 and 72.  Above 80 the panel form runs: no
// path runs m in 81-160, where larger tiles would still fit without local
// memory, and the library is built for sm_90a alone, so the limit is a
// constant of the build.  Shared memory is static and under 48 KB, so no
// launch changes a function attribute (CUDA-graph capture needs none).
// What bounds it: per panel, the panel warp's 8 dependent pivot steps (a
// shuffle, a reciprocal and an FMA each) against the tile's update, plus
// the two barriers and the hand-over; the work of one matrix is a chain of
// dependent steps, far below the card's peaks.
//
// m > 80 (MNIST m = 256, SPRITES m = 288, the m = 512 scaling cell): the
// same right-looking blocked Gauss-Jordan on the matrix in device memory,
// which the output holds as it is reduced in place; no limit on m.  Two
// kernels per panel of PNB = 32 columns, 2 ceil(m / 32) launches on the
// caller's stream with no host synchronisation between them:
//   * gauss_jordan_panel, ceil(m / 128) blocks per matrix, each owning
//     128 columns: warp 0 eliminates the 32 x 32 pivot block with the
//     warp form's loop (block 0 adds the log pivots to logdet in order),
//     recording each pivot's row operation in shared memory, while warps
//     1..4 copy the block's rows of the column panel C = A[:, K],
//     transposed through shared memory, to a workspace; then each thread
//     of warps 1..4 replays the 32 row operations on one column of the
//     row panel, giving U = A_KK^-1 A_K,: in a second workspace.  U is
//     formed by that sequential elimination, as in the blocked form, and
//     not as the explicit A_KK^-1 times the row panel: on real stacks of
//     condition ~1e6 (MNIST's K_mm at m = 256) the explicit product made
//     later pivots negative in fp32 and the training runs non-finite
//     (tests/test_torch_cuda.py holds both forms on such stacks);
//   * gauss_jordan_update, one block per 64 x 64 tile of each matrix:
//     A_ij = [i, j outside K] A_ij - sum_k C_ik U_kj, the sum formed on
//     its own and subtracted once, a contiguous 4 x 4 micro-tile per
//     thread from shared-memory tiles of C and U.
// The workspaces (2 B m 32 floats) come from the wrapper (PyTorch's
// allocator), so a CUDA-graph capture of a call works.  What bounds it:
// each panel's update reads and writes the whole stack (8 bytes per
// element per panel; at (65, 288) ~78 MB of traffic per panel with the
// C and U tiles, at (65, 512) a 68 MB stack that does not stay in the
// 50 MB L2), and each panel waits on the pivot block's 32 dependent
// steps.  A simple, correct form: keeping the matrix on chip across
// panels (persistent blocks, clusters) is later work.
//
// C interface (ctypes): pointers are device pointers to contiguous fp32
// data on the device of `stream`; the entry points return
// cudaGetLastError() after their launches (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>
#include <math.h>
#include <math_constants.h>

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 1;  // matrices per block, m <= WARP

enum Form { FORM_WARP = 0, FORM_BLOCKED = 1, FORM_PANEL = 2 };

// 1 / p to within about an ulp, without a branch: the hardware's
// approximate reciprocal and one Newton step.  (IEEE division takes a
// slow path, a branch, for some operands; a branch in the pivot loop keeps
// the scheduler from overlapping one pivot's update with the next pivot's
// shuffles.)
__device__ inline float reciprocal(float p) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(p));
  return fmaf(r, fmaf(-p, r, 1.f), r);
}

__device__ inline float log_pivot(float p) {
  return (p > 0.f) ? logf(p) : CUDART_NAN_F;
}

// The warp form's elimination of one 32 x 32 matrix: on entry a[i] is
// element (i, lane), on exit element (i, lane) of the inverse; returns
// this lane's pivot (pivot `lane`).  With `steps`, pivot k's row
// operation is recorded for columns outside the matrix: steps[k][0] =
// 1 / p, steps[k][i] = the pivot column's entry i places below the
// pivot row (rows counted as the registers rotate, see below).
__device__ __forceinline__ float warp_gauss_jordan(
    float (&a)[WARP], int lane, float (*steps)[WARP] = nullptr) {
  // Pivot k finds its row in a[0]; the update writes row i to a[i - 1]
  // and the pivot row to a[31], so the rows turn once around in the 32
  // pivots.  Lane k keeps its column unscaled (rk = 0 only moves the
  // rows) with -1 in the pivot row: column k of the result is that times
  // -1/p, applied at the end.
  float scale = 1.f;  // each lane's column is kept divided by scale
  float piv = 1.f;    // lane k keeps pivot k
#pragma unroll 4
  for (int k = 0; k < WARP; ++k) {
    // lane k's column, all 32 shuffles issued back to back
    float c[WARP];
#pragma unroll
    for (int i = 0; i < WARP; ++i) c[i] = __shfl_sync(FULL_MASK, a[i], k);
    const float p = c[0];
    const float inv = reciprocal(p);
    const bool pivot_lane = lane == k;
    if (steps != nullptr && pivot_lane) {  // lane k holds the column
      steps[k][0] = inv;
#pragma unroll
      for (int i = 1; i < WARP; ++i) steps[k][i] = a[i];
    }
    // this lane's pivot-row entry divided by the pivot
    const float rk = pivot_lane ? 0.f : a[0] * inv;
#pragma unroll
    for (int i = 1; i < WARP; ++i) a[i - 1] = fmaf(-c[i], rk, a[i]);
    a[WARP - 1] = pivot_lane ? -1.f : rk;
    if (pivot_lane) {
      scale = -inv;
      piv = p;
    }
  }
#pragma unroll
  for (int i = 0; i < WARP; ++i) a[i] *= scale;
  return piv;
}

__global__ void __launch_bounds__(WARP * WARPS_PER_BLOCK)
gauss_jordan_inverse_warp(const float* __restrict__ M,
                          float* __restrict__ Minv,
                          float* __restrict__ logdet, int B, int m) {
  const int lane = threadIdx.x % WARP;
  const int b = blockIdx.x * WARPS_PER_BLOCK + threadIdx.x / WARP;
  if (b >= B) return;  // the whole warp: every shuffle below is full-warp
  const size_t base = (size_t)b * m * m;

  float a[WARP];  // a[i] = element (i, lane); diag(M, I) past m
#pragma unroll
  for (int i = 0; i < WARP; ++i)
    a[i] = (i < m && lane < m) ? M[base + (size_t)i * m + lane]
                               : (i == lane ? 1.f : 0.f);
  const float piv = warp_gauss_jordan(a, lane);
  // logdet: every lane takes the log of its own pivot, then the logs are
  // summed in pivot order
  const float lg = log_pivot(piv);
  float ld_sum = 0.f;
#pragma unroll
  for (int k = 0; k < WARP; ++k) {
    const float v = __shfl_sync(FULL_MASK, lg, k);
    if (k < m) ld_sum += v;
  }

  if (lane < m) {
#pragma unroll
    for (int i = 0; i < WARP; ++i)
      if (i < m) Minv[base + (size_t)i * m + lane] = a[i];
  }
  if (lane == 0) logdet[b] = ld_sum;
}

// ---- blocked form ---------------------------------------------------------

// Pivots in the panel warp's sum of logs (the running sum stays in lane
// order, one shuffle per pivot).
__device__ inline float ordered_log_sum(const float* piv, int n, int lane) {
  float ld = 0.f;
  for (int t0 = 0; t0 < n; t0 += WARP) {
    const float lg = (t0 + lane < n) ? log_pivot(piv[t0 + lane]) : 0.f;
#pragma unroll
    for (int l = 0; l < WARP; ++l) {
      const float v = __shfl_sync(FULL_MASK, lg, l);
      if (t0 + l < n) ld += v;
    }
  }
  return ld;
}

template <int T, int A, int NB>
struct Blocked {
  static constexpr int E = T * A;             // extent held on chip
  static constexpr int LD = E + 1;            // odd shared row stride
  static constexpr int Q = (E + WARP - 1) / WARP;  // panel warp's slots
  static constexpr int W = Q * WARP;          // panel warp's columns
  static constexpr int TILE_THREADS = T * T;
  static constexpr int THREADS = TILE_THREADS + WARP;
  static_assert(E % NB == 0 && NB <= WARP && NB % 2 == 0, "panel width");
  static_assert(T % 2 == 0 && (T * T) % WARP == 0, "tile threads");
};

// Named barrier 1: the tile threads arrive when a panel's row panel is in
// shared memory, the panel warp waits for it (producer and consumer, so
// the tile threads go on with their update meanwhile).
template <int THREADS>
__device__ __forceinline__ void row_panel_arrive() {
  asm volatile("bar.arrive 1, %0;" ::"n"(THREADS) : "memory");
}
template <int THREADS>
__device__ __forceinline__ void row_panel_wait() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

template <int T, int A, int NB>
__global__ void __launch_bounds__(Blocked<T, A, NB>::THREADS, 1)
gauss_jordan_blocked(const float* __restrict__ M, float* __restrict__ Minv,
                     float* __restrict__ logdet, int m) {
  using Cfg = Blocked<T, A, NB>;
  constexpr int E = Cfg::E, LD = Cfg::LD, Q = Cfg::Q, W = Cfg::W;
  constexpr int THREADS = Cfg::THREADS;
  // col_panel[s][k][i] = A[i][k0 + k] (-identity in the panel's rows);
  // row_panel[s][k][j] = A[k0 + k][j], reduced in place to U
  __shared__ float col_panel[2][NB][LD];
  __shared__ float row_panel[2][NB][LD];
  __shared__ float pivots[E];
  const int tid = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * m * m;
  const int npanels = (m + NB - 1) / NB;

  if (tid < Cfg::TILE_THREADS) {
    const int ty = tid / T, tx = tid % T;
    float x[A][A];  // x[a][b] = element (ty + T a, tx + T b), diag(M, I)
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int i = ty + T * a;
#pragma unroll
      for (int b = 0; b < A; ++b) {
        const int j = tx + T * b;
        x[a][b] = (i < m && j < m) ? M[base + (size_t)i * m + j]
                                   : (i == j ? 1.f : 0.f);
      }
    }
    // Hand panel k0's rows (the whole tile row a if `row`) or columns
    // over to shared buffer s, zeroing them here: the row panel takes
    // the rows, the column panel the columns (-identity in the rows).
    auto hand_over = [&](int s, int k0, bool rows) {
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const int i = ty + T * a;
        const bool rin = (unsigned)(i - k0) < (unsigned)NB;
        if (rows != rin) continue;
#pragma unroll
        for (int b = 0; b < A; ++b) {
          const int j = tx + T * b;
          const bool cin = (unsigned)(j - k0) < (unsigned)NB;
          if (cin) col_panel[s][j - k0][i] = rin ? (i == j ? -1.f : 0.f)
                                                 : x[a][b];
          if (rin) row_panel[s][i - k0][j] = x[a][b];
          if (rin || cin) x[a][b] = 0.f;
        }
      }
    };
    hand_over(0, 0, true);
    row_panel_arrive<THREADS>();
    hand_over(0, 0, false);
    for (int panel = 0; panel < npanels; ++panel) {
      const int s = panel & 1, k0 = panel * NB, k1 = k0 + NB;
      const bool ahead = panel + 1 < npanels;
      __syncthreads();  // U of this panel and its column panel are ready
      // Look ahead: the rows of the next panel take this panel's update
      // first and go to the panel warp, which reduces them while the rest
      // of the tile is updated.
      bool next_row[A];
#pragma unroll
      for (int a = 0; a < A; ++a)
        next_row[a] = ahead && (unsigned)(ty + T * a - k1) < (unsigned)NB;
#pragma unroll
      for (int a = 0; a < A; ++a) {
        if (!next_row[a]) continue;
        const int i = ty + T * a;
#pragma unroll
        for (int k = 0; k < NB; ++k) {
          const float c = col_panel[s][k][i];
#pragma unroll
          for (int b = 0; b < A; ++b)
            x[a][b] = fmaf(-c, row_panel[s][k][tx + T * b], x[a][b]);
        }
      }
      if (ahead) {
        hand_over(s ^ 1, k1, true);
        row_panel_arrive<THREADS>();
      }
      // the rest of the tile: x -= C U in k order (the next panel's rows,
      // already updated and handed over, take c = 0 and stay 0)
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        float c[A], u[A];
#pragma unroll
        for (int a = 0; a < A; ++a)
          c[a] = next_row[a] ? 0.f : col_panel[s][k][ty + T * a];
#pragma unroll
        for (int b = 0; b < A; ++b) u[b] = row_panel[s][k][tx + T * b];
#pragma unroll
        for (int a = 0; a < A; ++a)
#pragma unroll
          for (int b = 0; b < A; ++b) x[a][b] = fmaf(-c[a], u[b], x[a][b]);
      }
      if (ahead) hand_over(s ^ 1, k1, false);
    }
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int i = ty + T * a;
#pragma unroll
      for (int b = 0; b < A; ++b) {
        const int j = tx + T * b;
        if (i < m && j < m) Minv[base + (size_t)i * m + j] = x[a][b];
      }
    }
  } else {
    // the panel warp: lane l, slot q holds column (k0 + l + 32 q) mod W
    // of the row panel (0 past the extent), so the diagonal block is
    // slot 0 of lanes 0 .. NB-1
    const int lane = tid - Cfg::TILE_THREADS;
    for (int panel = 0; panel < npanels; ++panel) {
      const int s = panel & 1, k0 = panel * NB;
      row_panel_wait<THREADS>();  // this panel's rows are handed over
      float y[NB][Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int c = (k0 + lane + WARP * q) % W;
#pragma unroll
        for (int r = 0; r < NB; ++r)
          y[r][q] = (c < E) ? row_panel[s][r][c] : 0.f;
      }
      float piv = 1.f;  // lane k keeps pivot k0 + k
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        float col[NB];  // the pivot column, from lane k
#pragma unroll
        for (int r = 0; r < NB; ++r)
          col[r] = __shfl_sync(FULL_MASK, y[r][0], k);
        const float inv = reciprocal(col[k]);
        if (lane == k) {  // the pivot column becomes e_k, then is updated
          piv = col[k];
#pragma unroll
          for (int r = 0; r < NB; ++r) y[r][0] = (r == k) ? 1.f : 0.f;
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float t = y[k][q] * inv;
          y[k][q] = t;
#pragma unroll
          for (int r = 0; r < NB; ++r)
            if (r != k) y[r][q] = fmaf(-col[r], t, y[r][q]);
        }
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int c = (k0 + lane + WARP * q) % W;
        if (c < E) {
#pragma unroll
          for (int r = 0; r < NB; ++r) row_panel[s][r][c] = y[r][q];
        }
      }
      if (lane < NB) pivots[k0 + lane] = piv;
      __syncthreads();  // U of this panel is ready
    }
    __syncwarp();
    const float ld = ordered_log_sum(pivots, m, lane);
    if (lane == 0) logdet[blockIdx.x] = ld;
  }
}

// The blocked form's tiles, smallest extent first: (T, A, NB), extent
// T A.  The kernel of each is instantiated below.
struct BlockedConfig {
  int T, A, NB;
  const void* fn;
};

#define BLOCKED_CONFIG(T, A, NB) \
  { T, A, NB, (const void*)gauss_jordan_blocked<T, A, NB> }
const BlockedConfig BLOCKED[] = {BLOCKED_CONFIG(16, 4, 8),
                                  BLOCKED_CONFIG(16, 5, 8)};
#undef BLOCKED_CONFIG
constexpr int N_BLOCKED = sizeof(BLOCKED) / sizeof(BLOCKED[0]);
constexpr int BLOCKED_LIMIT = 16 * 5;  // the largest tile's extent

cudaError_t launch_blocked(int config, const float* M, float* Minv,
                           float* logdet, int B, int m, cudaStream_t s) {
  const BlockedConfig& c = BLOCKED[config];
  const int threads = c.T * c.T + WARP;
  void* args[] = {(void*)&M, (void*)&Minv, (void*)&logdet, (void*)&m};
  return cudaLaunchKernel(c.fn, dim3(B), dim3(threads), args, 0, s);
}

// ---- panel form -----------------------------------------------------------

constexpr int PNB = 32;             // panel width: the warp form's block
constexpr int PANEL_COLS = 128;     // columns of U per panel block
constexpr int COPIERS = PANEL_COLS / WARP;        // warps 1..4
constexpr int PANEL_THREADS = WARP + PANEL_COLS;  // warp 0 eliminates
constexpr int UT = 64;              // update tile (UT x UT outputs)
constexpr int UPDATE_THREADS = 256; // 16 x 16, 4 x 4 outputs each
constexpr int UR = UT / 16;
static_assert(UR == 4, "the update reads its micro-tile as float4");

// ceil(m / PANEL_COLS) blocks per matrix, block c owning columns (and
// column-panel rows) [c PANEL_COLS, (c + 1) PANEL_COLS).  Warp 0 of each
// eliminates the 32 x 32 pivot block with the warp form's loop, recording
// every pivot's row operation in shared memory (block 0 adds the log
// pivots to logdet in order; the block owning the panel's columns writes
// A_KK^-1 to U); warps 1..4 meanwhile copy the block's rows of the
// column panel, the panel's rows as -identity, transposed through shared
// memory into Ct (B, PNB, m).  Then each thread of warps 1..4 replays the
// 32 recorded row operations on one column of the row panel, in pivot
// order, giving that column of U = A_KK^-1 A_K,: (B, PNB, m): the same
// sequential elimination the blocked form runs.  (Forming U as the
// explicit A_KK^-1 times the row panel instead loses positive pivots on
// stacks of condition ~1e6.)  `src` is M for the first panel and Minv
// after.
__global__ void __launch_bounds__(PANEL_THREADS)
gauss_jordan_panel(const float* __restrict__ src, float* __restrict__ Ct,
                   float* __restrict__ U, float* __restrict__ logdet, int m,
                   int k0, int per_matrix) {
  __shared__ __align__(16) float steps[PNB][WARP];
  __shared__ float stage[COPIERS][WARP][WARP + 1];
  const int tid = threadIdx.x, lane = tid % WARP, warp = tid / WARP;
  const int b = blockIdx.x / per_matrix, chunk = blockIdx.x % per_matrix;
  const int lo = chunk * PANEL_COLS, hi = min(m, lo + PANEL_COLS);
  const float* a = src + (size_t)b * m * m;
  float* u = U + (size_t)b * PNB * m;
  const int kn = min(PNB, m - k0);  // real pivots in this panel
  if (warp == 0) {
    float blk[WARP];  // element (k0 + i, k0 + lane), identity past m
#pragma unroll
    for (int i = 0; i < WARP; ++i)
      blk[i] = (i < kn && lane < kn)
                   ? a[(size_t)(k0 + i) * m + k0 + lane]
                   : (i == lane ? 1.f : 0.f);
    const float piv = warp_gauss_jordan(blk, lane, steps);
    if (k0 >= lo && k0 < hi && lane < kn) {
#pragma unroll
      for (int i = 0; i < WARP; ++i) u[(size_t)i * m + k0 + lane] = blk[i];
    }
    if (chunk == 0) {
      const float lg = log_pivot(piv);
      float ld = (k0 == 0) ? 0.f : logdet[b];
#pragma unroll
      for (int k = 0; k < WARP; ++k) {
        const float v = __shfl_sync(FULL_MASK, lg, k);
        if (k < kn) ld += v;
      }
      if (lane == 0) logdet[b] = ld;
    }
  } else {
    // 32 rows at a time: lane k loads column k0 + k of each row (32
    // loads in flight), then writes row r0 + lane of each Ct[k]
    float (*t)[WARP + 1] = stage[warp - 1];
    float* ct = Ct + (size_t)b * PNB * m;
    for (int r0 = lo + (warp - 1) * WARP; r0 < hi; r0 += COPIERS * WARP) {
      float v[WARP];
#pragma unroll
      for (int r = 0; r < WARP; ++r) {
        const int i = r0 + r;
        v[r] = 0.f;
        if (i < hi && lane < kn)
          v[r] = ((unsigned)(i - k0) < (unsigned)kn)
                     ? (i - k0 == lane ? -1.f : 0.f)
                     : a[(size_t)i * m + k0 + lane];
      }
#pragma unroll
      for (int r = 0; r < WARP; ++r) t[r][lane] = v[r];
      __syncwarp();
      if (r0 + lane < hi) {
#pragma unroll
        for (int k = 0; k < PNB; ++k)
          ct[(size_t)k * m + r0 + lane] = t[lane][k];
      }
      __syncwarp();
    }
  }
  __syncthreads();  // the row operations are recorded
  if (warp == 0) return;
  const int j = lo + tid - WARP;
  if (j >= hi || (unsigned)(j - k0) < (unsigned)kn) return;
  // column j of the row panel, in the warp form's rotating registers:
  // pivot k finds the pivot row in x[0]
  float x[WARP];
#pragma unroll
  for (int i = 0; i < WARP; ++i)
    x[i] = (i < kn) ? a[(size_t)(k0 + i) * m + j] : 0.f;
#pragma unroll 2
  for (int k = 0; k < PNB; ++k) {
    float c[WARP];
#pragma unroll
    for (int i = 0; i < WARP; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(&steps[k][i]);
      c[i] = q.x, c[i + 1] = q.y, c[i + 2] = q.z, c[i + 3] = q.w;
    }
    const float rk = x[0] * c[0];  // c[0] = 1 / p
#pragma unroll
    for (int i = 1; i < WARP; ++i) x[i - 1] = fmaf(-c[i], rk, x[i]);
    x[WARP - 1] = rk;
  }
#pragma unroll
  for (int i = 0; i < WARP; ++i) u[(size_t)i * m + j] = x[i];
}

// One block per UT x UT tile of each matrix: dst_ij = [i, j outside the
// panel] src_ij - sum_k C_ik U_kj, each thread a contiguous 4 x 4
// micro-tile (float4 reads of the shared tiles; float4 loads and stores
// of the matrix when `vec`: m a multiple of 4 and both pointers 16-byte
// aligned).  The sum is formed on its own, in k order from zero, and
// subtracted from src_ij once: taking the 32 products off src_ij one at a
// time rounds at src_ij's scale at every step, and on SPRITES's A_hat +
// jitter at m = 288 (condition ~6e5) an fp32 model of that order read
// several times the inverse error of this one (tools/b1_real_stacks.py
// prints both).  Each element is read and written by one thread, so src
// may be dst.
__global__ void __launch_bounds__(UPDATE_THREADS)
gauss_jordan_update(const float* src, float* dst,
                    const float* __restrict__ Ct,
                    const float* __restrict__ U, int m, int k0, int tiles,
                    int vec) {
  __shared__ __align__(16) float cs[PNB][UT];  // cs[k][i - i0]
  __shared__ __align__(16) float us[PNB][UT];  // us[k][j - j0]
  const int per = tiles * tiles;
  const int b = blockIdx.x / per, t = blockIdx.x % per;
  const int i0 = (t / tiles) * UT, j0 = (t % tiles) * UT;
  const int tid = threadIdx.x;
  const float* c_in = Ct + (size_t)b * PNB * m;
  const float* u_in = U + (size_t)b * PNB * m;
#pragma unroll
  for (int r = 0; r < UT * PNB / UPDATE_THREADS; ++r) {
    const int idx = tid + r * UPDATE_THREADS;
    const int k = idx / UT, x = idx % UT;
    cs[k][x] = (i0 + x < m) ? c_in[(size_t)k * m + i0 + x] : 0.f;
    us[k][x] = (j0 + x < m) ? u_in[(size_t)k * m + j0 + x] : 0.f;
  }
  const int ty = tid / 16, tx = tid % 16;
  const int ib = i0 + UR * ty, jb = j0 + UR * tx;
  const size_t base = (size_t)b * m * m;
  const int kn = min(PNB, m - k0);
  __syncthreads();
  float sum[UR][UR] = {};
#pragma unroll 8
  for (int k = 0; k < PNB; ++k) {
    const float4 cv = *reinterpret_cast<const float4*>(&cs[k][UR * ty]);
    const float4 uv = *reinterpret_cast<const float4*>(&us[k][UR * tx]);
    const float c4[UR] = {cv.x, cv.y, cv.z, cv.w};
    const float u4[UR] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
    for (int a = 0; a < UR; ++a)
#pragma unroll
      for (int c = 0; c < UR; ++c) sum[a][c] = fmaf(c4[a], u4[c], sum[a][c]);
  }
#pragma unroll
  for (int a = 0; a < UR; ++a) {
    const int i = ib + a;
    if (i >= m) continue;
    const bool row_keep = (unsigned)(i - k0) >= (unsigned)kn;
    float v[UR];  // src_ij, 0 in the panel's rows and columns
    if (vec && jb < m) {
      const float4 q = *reinterpret_cast<const float4*>(
          &src[base + (size_t)i * m + jb]);
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
      for (int c = 0; c < UR; ++c)
        v[c] = (jb + c < m) ? src[base + (size_t)i * m + jb + c] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < UR; ++c) {
      const bool keep = row_keep && (unsigned)(jb + c - k0) >= (unsigned)kn;
      v[c] = (keep ? v[c] : 0.f) - sum[a][c];
    }
    if (vec && jb < m) {
      *reinterpret_cast<float4*>(&dst[base + (size_t)i * m + jb]) =
          make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int c = 0; c < UR; ++c)
        if (jb + c < m) dst[base + (size_t)i * m + jb + c] = v[c];
    }
  }
}

int panel_count(int m) { return (m + PNB - 1) / PNB; }
int panel_blocks(int m) { return (m + PANEL_COLS - 1) / PANEL_COLS; }
int update_tiles(int m) { return (m + UT - 1) / UT; }

// ---- plan -----------------------------------------------------------------

struct KernelInfo {
  int threads, smem, registers, local_bytes, blocks_per_sm;
};

cudaError_t kernel_info(const void* fn, int threads, KernelInfo* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      0);
  if (err != cudaSuccess) return err;
  *out = {threads, (int)attr.sharedSizeBytes, attr.numRegs,
          (int)attr.localSizeBytes, blocks};
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The launch plan of an m x m stack on the current device:
// plan = {form (0 warp, 1 blocked, 2 panel), blocked tile index (-1 if
//         none), rows the blocked tile holds (0 if none), workspace
//         floats per matrix, CUDA launches per call, pivots per panel,
//         the largest m of the blocked form}.
int svgp_chol_inverse_plan(int m, int* plan) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  int form = FORM_PANEL, config = -1;
  if (m <= WARP) {
    form = FORM_WARP;
  } else if (m <= BLOCKED_LIMIT) {
    form = FORM_BLOCKED;
    for (config = 0; config < N_BLOCKED - 1; ++config) {
      const BlockedConfig& c = BLOCKED[config];
      if ((m + c.NB - 1) / c.NB * c.NB <= c.T * c.A) break;
    }
  }
  plan[0] = form;
  plan[1] = config;
  plan[2] = config >= 0 ? BLOCKED[config].T * BLOCKED[config].A : 0;
  plan[3] = form == FORM_PANEL ? 2 * m * PNB : 0;
  plan[4] = form == FORM_PANEL ? 2 * panel_count(m) : 1;
  plan[5] = form == FORM_PANEL ? PNB
            : form == FORM_BLOCKED ? BLOCKED[config].NB : 1;
  plan[6] = BLOCKED_LIMIT;
  return 0;
}

// The kernels that (B, m) launches under `plan`, on the current device:
// info = {threads per block, static shared memory bytes, registers per
//         thread, local (spilled) bytes per thread, resident blocks per
//         SM, blocks in the grid} of the first kernel, then the same six
//         of the panel form's update kernel (zeros for the other forms).
int svgp_chol_inverse_info(int B, int m, const int* plan, int* info) {
  if (B < 1 || m < 1) return (int)cudaErrorInvalidValue;
  KernelInfo k1{}, k2{};
  int grid1 = B, grid2 = 0;
  cudaError_t err;
  if (plan[0] == FORM_WARP) {
    err = kernel_info((const void*)gauss_jordan_inverse_warp,
                      WARP * WARPS_PER_BLOCK, &k1);
    grid1 = (B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  } else if (plan[0] == FORM_BLOCKED) {
    const BlockedConfig& c = BLOCKED[plan[1]];
    err = kernel_info(c.fn, c.T * c.T + WARP, &k1);
  } else {
    err = kernel_info((const void*)gauss_jordan_panel, PANEL_THREADS, &k1);
    if (err == cudaSuccess)
      err = kernel_info((const void*)gauss_jordan_update, UPDATE_THREADS,
                        &k2);
    grid1 = B * panel_blocks(m);
    grid2 = B * update_tiles(m) * update_tiles(m);
  }
  if (err != cudaSuccess) return (int)err;
  const int vals[12] = {k1.threads, k1.smem, k1.registers, k1.local_bytes,
                        k1.blocks_per_sm, grid1, k2.threads, k2.smem,
                        k2.registers, k2.local_bytes, k2.blocks_per_sm,
                        grid2};
  for (int i = 0; i < 12; ++i) info[i] = vals[i];
  return 0;
}

// (Minv, logdet) of M under `plan` (svgp_chol_inverse_plan of this m on
// this device).  The panel form needs `workspace`: plan[3] floats per
// matrix; the other forms take none (NULL).
int svgp_chol_inverse(const float* M, float* Minv, float* logdet,
                      float* workspace, int B, int m, const int* plan,
                      void* stream) {
  if (B < 1 || m < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (plan[0] == FORM_WARP) {
    if (m > WARP) return (int)cudaErrorInvalidValue;
    gauss_jordan_inverse_warp<<<(B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK,
                                WARP * WARPS_PER_BLOCK, 0, s>>>(
        M, Minv, logdet, B, m);
    return (int)cudaGetLastError();
  }
  if (plan[0] == FORM_BLOCKED) {
    if (plan[1] < 0 || plan[1] >= N_BLOCKED) return (int)cudaErrorInvalidValue;
    const BlockedConfig& c = BLOCKED[plan[1]];
    if ((m + c.NB - 1) / c.NB * c.NB > c.T * c.A)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = launch_blocked(plan[1], M, Minv, logdet, B, m, s);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  if (workspace == nullptr) return (int)cudaErrorInvalidValue;
  float* Ct = workspace;
  float* U = workspace + (size_t)B * m * PNB;
  const int tiles = update_tiles(m), per_matrix = panel_blocks(m);
  const int vec = m % 4 == 0 && (uintptr_t)M % 16 == 0
                  && (uintptr_t)Minv % 16 == 0;
  const float* src = M;
  for (int k0 = 0; k0 < m; k0 += PNB) {
    gauss_jordan_panel<<<B * per_matrix, PANEL_THREADS, 0, s>>>(
        src, Ct, U, logdet, m, k0, per_matrix);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gauss_jordan_update<<<B * tiles * tiles, UPDATE_THREADS, 0, s>>>(
        src, Minv, Ct, U, m, k0, tiles, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = Minv;
  }
  return 0;
}

}  // extern "C"
