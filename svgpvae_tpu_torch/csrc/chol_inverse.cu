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
// peaks.  The real floor is the launch (a few us) and the m sequential
// pivot steps, each a barrier-separated round of shared-memory work.  At
// (65, 72) (the SPRITES stack of a later slice) it is 48.5 MFLOP on 2.7 MB,
// still far below a microsecond of either peak.
//
// What the design does about it:
//   * One block per matrix; the whole matrix lives in shared memory for
//     all m pivot steps, so device memory is read once and written once.
//     The inverse is formed in place (the classic in-place Gauss-Jordan:
//     column k of the identity replaces column k of M), which halves the
//     TPU kernel's (m, 2m) augmented work and storage: 4 m (m + 1) bytes,
//     4.2 KB at m = 32 and 21 KB at m = 72.  Above 48 KB (m > 108) the
//     launch opts in to more dynamic shared memory; m > the card's opt-in
//     limit allows (240 on an H100) is refused.
//   * Each pivot step is two barrier-separated rounds: (1) copy pivot row k
//     (divided by the pivot) and column k to two small shared vectors;
//     (2) every thread applies the rank-1 update to its elements.  The
//     shared row stride is odd, so reading a column touches 32 banks.
//   * Threads form a 32 x min(m, 32) grid that strides over the matrix,
//     so any m is masked, never padded in device memory, and a warp reads
//     consecutive columns of one row (conflict-free, coalesced loads).
//   * IEEE fp32 FMA throughout, no tensor cores: the TPU kernel's lower
//     precision MXU update gave O(1) inverse errors and NaN logdets.
// Many matrices per block (the ball stack, m = 15) and a warp-synchronous
// form without block barriers are later work.
//
// C interface (ctypes): pointers are device pointers to contiguous fp32
// data on the device of `stream`; the entry point returns
// cudaGetLastError() after its launch (0 = success).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARP = 32;
constexpr size_t STATIC_SMEM_LIMIT = 48 * 1024;

__host__ __device__ inline int row_stride(int m) { return m | 1; }

__host__ inline size_t smem_bytes(int m) {
  // the matrix at an odd row stride, then the pivot row and column
  return sizeof(float) * ((size_t)m * row_stride(m) + 2 * (size_t)m);
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
    if (tx == 0 && ty == 0) ld_sum += (p > 0.f) ? logf(p) : nanf("");
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

int svgp_chol_inverse(const float* M, float* Minv, float* logdet, int B,
                      int m, void* stream) {
  if (B < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(m);
  if (smem > STATIC_SMEM_LIMIT) {
    cudaError_t err = cudaFuncSetAttribute(
        gauss_jordan_inverse, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 block(WARP, m < WARP ? m : WARP);
  gauss_jordan_inverse<<<B, block, smem, (cudaStream_t)stream>>>(M, Minv,
                                                                 logdet, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
