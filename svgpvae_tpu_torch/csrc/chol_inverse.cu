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
// not PD) makes logdet NaN.
//
// What bounds it on the card.  The elimination does m^3 FMA per matrix
// (2 m^3 B FLOP) on 2 B m^2 x 4 bytes of input and output.  At the MNIST
// training shape (B, m) = (17, 32) that is 1.1 MFLOP and 139 KB: about
// 0.04 us of memory traffic and 0.02 us of fp32 arithmetic at the H100's
// peaks.  The real floor is the launch (a few us) and the m dependent
// pivot steps.  At (65, 72) (the SPRITES stack of a later slice) it is
// 48.5 MFLOP on 2.7 MB, still far below a microsecond of either peak.
//
// Both kernels form the inverse in place (the classic in-place
// Gauss-Jordan: column k of the identity replaces column k of M), which
// halves the TPU kernel's (m, 2m) augmented work and storage.  fp32 FMA
// throughout, no tensor cores: the TPU kernel's lower precision MXU update
// gave O(1) inverse errors and NaN logdets.
//
// m <= 32 (every MNIST stack, the ball stack at m = 15):
// gauss_jordan_inverse_warp.  A block barrier per pivot step was the
// whole cost of the shared-memory form at m = 32 (~0.5 us a step), so
// here one warp owns one matrix and no barrier is ever needed:
//   * lane j holds column j of the matrix in 32 registers; each pivot
//     step moves the rows up by one register (the pivot row to the end),
//     so the pivot row is always register 0, every register index is
//     static, and the pivot loop stays rolled (4 pivots per iteration:
//     fully unrolled, the loop is ~60 KB of code and ran slower);
//   * m < 32 is padded in registers to diag(M, I), which leaves the
//     inverse's leading block and the logdet unchanged (the TPU wrapper
//     pads the same way); the padded pivots change no value;
//   * at pivot k, lane k's column is broadcast by 32 shuffles issued
//     back to back (the pivot is one of them); the pivot row's entry is
//     in each lane's own register, so the rank-1 update is one register
//     FMA per element.  Lane k leaves its own column as it is and scales
//     it by -1/p after the last pivot (the later pivots act on it
//     linearly), so no element needs a select;
//   * 1/p is the hardware's approximate reciprocal plus one Newton step
//     (within about an ulp), then a multiply: IEEE division branches to
//     a slow path for some operands (a zero numerator among them), and a
//     branch in the loop keeps one pivot's update from overlapping the
//     next pivot's shuffles;
//   * one warp (matrix) per block: with four, the same loop ran ~1.6x
//     slower on an H100; loads and stores are coalesced (at row i the
//     lanes touch consecutive columns).
// What bounds it: the 32 dependent pivot steps, each 32 shuffles and 31
// FMAs per lane, and the launch.
//
// m > 32 (the SPRITES stacks of a later slice): gauss_jordan_inverse, one
// block per matrix with the matrix in shared memory for all m pivot
// steps (device memory read once and written once).  Row k is divided by
// the (IEEE) pivot, then every other row i takes fma(-a[i][k], row[j],
// a[i][j]).  Logdet is the sum of the log pivots in pivot order, as in
// the warp form.  Each pivot step is two barrier-separated rounds:
// (1) copy pivot row k (divided by the pivot) and column k to two small
// shared vectors; (2) every thread applies the rank-1 update to its
// elements.  The shared row stride is
// odd, so reading a column touches 32 banks.  Threads form a
// 32 x min(m, 32) grid that strides over the matrix, so any m is masked,
// never padded in device memory.  4 m (m + 1) bytes of shared memory:
// 21 KB at m = 72; above 48 KB (m > 108) the launch opts in to more
// dynamic shared memory; m > the card's opt-in limit allows (240 on an
// H100) is refused.
//
// C interface (ctypes): pointers are device pointers to contiguous fp32
// data on the device of `stream`; the entry points return
// cudaGetLastError() after their launch (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int WARPS_PER_BLOCK = 1;  // matrices per block, m <= WARP
constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

__host__ __device__ inline int row_stride(int m) { return m | 1; }

__host__ inline size_t smem_bytes(int m) {
  // the matrix at an odd row stride, then the pivot row and column
  return sizeof(float) * ((size_t)m * row_stride(m) + 2 * (size_t)m);
}

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
  // logdet: every lane takes the log of its own pivot, then the logs are
  // summed in pivot order
  const float lg = (piv > 0.f) ? logf(piv) : CUDART_NAN_F;
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

__global__ void gauss_jordan_inverse(const float* __restrict__ M,
                                     float* __restrict__ Minv,
                                     float* __restrict__ logdet, int m) {
  extern __shared__ float smem[];
  const int ld = row_stride(m);
  float* a = smem;                  // (m, ld)
  float* row = smem + m * ld;       // pivot row / pivot
  float* col = row + m;             // pivot column (0 at the pivot)
  const size_t base = (size_t)blockIdx.x * m * m;
  const int tx = threadIdx.x, ty = threadIdx.y, ny = blockDim.y;

  for (int i = ty; i < m; i += ny)
    for (int j = tx; j < m; j += WARP) a[i * ld + j] = M[base + i * m + j];
  __syncthreads();

  float ld_sum = 0.f;  // used by thread (0, 0) only
  for (int k = 0; k < m; ++k) {
    const float p = a[k * ld + k];
    // round 1: scaled pivot row (its pivot entry becomes 1 / p; warp 0)
    // and the pivot column with the pivot itself zeroed
    // pivot column (warp 1, or warp 0 when m == 1 leaves only one warp)
    if (ty == 0) {
      for (int j = tx; j < m; j += WARP)
        row[j] = (j == k ? 1.f : a[k * ld + j]) / p;
    }
    if (ty == (ny > 1 ? 1 : 0)) {
      for (int i = tx; i < m; i += WARP)
        col[i] = (i == k) ? 0.f : a[i * ld + k];
    }
    if (tx == 0 && ty == 0) ld_sum += (p > 0.f) ? logf(p) : CUDART_NAN_F;
    __syncthreads();
    // round 2: rank-1 update; row k takes the scaled row, column k of the
    // other rows becomes -a[i][k] / p
    for (int i = ty; i < m; i += ny) {
      const float c = col[i];
      for (int j = tx; j < m; j += WARP) {
        float v;
        if (i == k) {
          v = row[j];
        } else {
          v = (j == k) ? 0.f : a[i * ld + j];
          v = fmaf(-c, row[j], v);
        }
        a[i * ld + j] = v;
      }
    }
    __syncthreads();
  }

  for (int i = ty; i < m; i += ny)
    for (int j = tx; j < m; j += WARP) Minv[base + i * m + j] = a[i * ld + j];
  if (tx == 0 && ty == 0) logdet[blockIdx.x] = ld_sum;
}

struct Launch {
  bool warp;
  dim3 grid, block;
  size_t smem;
};

Launch launch_config(int B, int m) {
  if (m <= WARP)
    return {true, dim3((B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK),
            dim3(WARP * WARPS_PER_BLOCK), 0};
  return {false, dim3(B), dim3(WARP, m < WARP ? m : WARP), smem_bytes(m)};
}

}  // namespace

extern "C" {

// Largest m whose shared-memory working set fits one block of `device`.
int svgp_chol_inverse_max_m(int device, int* max_m) {
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  int m = 1;
  while (smem_bytes(m + 1) <= (size_t)optin) ++m;
  *max_m = m;
  return 0;
}

// The kernel that (B, m) launches, on the current device:
// info = {warp form (1) or shared-memory form (0), threads per block,
//         dynamic shared memory bytes, registers per thread, resident
//         blocks per SM, blocks in the grid}.
int svgp_chol_inverse_info(int B, int m, int* info) {
  if (B < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const Launch c = launch_config(B, m);
  const void* fn = c.warp ? (const void*)gauss_jordan_inverse_warp
                          : (const void*)gauss_jordan_inverse;
  if (c.smem > STATIC_SMEM_LIMIT) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  const int threads = (int)(c.block.x * c.block.y);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads,
                                                      c.smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = c.warp;
  info[1] = threads;
  info[2] = (int)c.smem;
  info[3] = attr.numRegs;
  info[4] = blocks;
  info[5] = (int)c.grid.x;
  return 0;
}

int svgp_chol_inverse(const float* M, float* Minv, float* logdet, int B,
                      int m, void* stream) {
  if (B < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const Launch c = launch_config(B, m);
  if (c.warp) {
    gauss_jordan_inverse_warp<<<c.grid, c.block, 0, (cudaStream_t)stream>>>(
        M, Minv, logdet, B, m);
    return (int)cudaGetLastError();
  }
  if (c.smem > STATIC_SMEM_LIMIT) {
    cudaError_t err = cudaFuncSetAttribute(
        gauss_jordan_inverse, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)c.smem);
    if (err != cudaSuccess) return (int)err;
  }
  gauss_jordan_inverse<<<c.grid, c.block, c.smem, (cudaStream_t)stream>>>(
      M, Minv, logdet, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
