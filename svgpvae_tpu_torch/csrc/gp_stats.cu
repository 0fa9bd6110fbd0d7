// GP sufficient statistics on Hopper, for all L latent channels at once:
//
//     Sigma_l = sum_n prec[n, l] * K[n, :]^T K[n, :]      (L, m, m)
//     r_l     = sum_n py[n, l]   * K[n, :]               (L, m)
//
// Replaces two Pallas TPU kernels with one source:
//   * svgpvae_tpu/ops/gp_stats.py::gp_sufficient_stats (body _stats_kernel):
//     K_nm is read from device memory            -> svgp_gp_stats
//   * svgpvae_tpu/ops/fused_kernel_stats.py::fused_kernel_stats (body
//     _kernel_body): each K tile is built in-kernel from the raw features,
//     so the (n, m) kernel matrix never reaches device memory
//                                                 -> svgp_fused_kernel_stats
//
// What bounds it on the card.  At the SPRITES precompute shape
// (n = 50,000, m = 72, L = 64) arithmetic: the upper triangles take
// n L m (m + 1) = 16.6 GFLOP against ~40 MB of inputs, far above the H100's
// fp32 ridge.  At the MNIST training shapes (n = 256 or 8,100, m = 32,
// L = 16) the work is a few microseconds of either peak, and the launch
// and the dependent latency of one pass over n are the floor.
// Everything stays IEEE fp32 FMA on the CUDA cores (no TF32, no tensor
// cores): the Sigma_l feed a Cholesky whose conditioning the GP relies
// on.  Tensor cores would need 3xTF32 split products, which changes the
// precision contract and the bound; that is not done here.
//
// The launch plan (svgp_stats_plan) picks the kernel and the split of n
// from the shape and the device; there is no other switch.  No atomics
// anywhere: every sum is taken in a fixed order, so the results are the
// same bits from run to run.
//
// B2 at m <= SMALL_MAX_M (the MNIST training step, its eval batches and
// the cgen pass): stats_small_kernel.  Two launches and a partial-sum
// workspace were the whole cost of the step's 256-row call, so one block
// per channel loops over its rows and, when it has all n (n <=
// SMALL_CHUNK_ROWS), writes Sigma (both triangles, mirrored in the kernel)
// and r straight to the outputs: one launch, no workspace.  A block's
// threads are (n groups) x (4 x 4 micro-tiles of the upper triangle),
// 14 x 36 = 504 at m = 32, two blocks per SM; group g takes rows
// t = g (mod groups) and the groups' sums are added in group order at the
// end.  The r sums ride on the loads of triangle row 0.  Larger n is
// split into chunks of at least SMALL_CHUNK_ROWS rows, as many as fill
// one wave (2 x 132 / L blocks at L = 16), whose upper triangles go to
// the workspace for stats_reduce_kernel.
//
// m > SMALL_MAX_M and every B3 call (the SPRITES fit): stats_partial_kernel
// + stats_reduce_kernel.  The TPU grid walks its n tiles in order and
// carries the (L, m, m) sum in VMEM.  Hopper blocks run in parallel, so
// each block owns one (n chunk x CHANNELS_PER_BLOCK channels x triangle
// slice), accumulates in registers, and writes its partial sums to the
// workspace; the reduce sums them over the chunks in chunk order and
// mirrors the upper triangle.  What the body does about what bounds it:
//   * a thread owns one 4 x 8 micro-tile (rows 4 ti.., columns 8 tj..)
//     of the upper triangle for the block's 4 channels: 128 accumulators
//     in 168 registers, 90 threads of 96 active at m = 72, four blocks
//     (12 warps) per SM; the plan sizes the n chunks so that all blocks
//     are resident in one wave
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
//   * the inner loop per row is four 16-byte shared loads (the thread's
//     K rows and columns and the 4 channels' prec), 16 multiplies and 128
//     FMAs.  Measured on an H100, each variant with more shared loads per
//     FMA was slower, whatever its occupancy: staging the channel-scaled
//     operand prec_l * K in shared memory (a pure-FMA loop with five loads
//     per 64 FMAs and a second barrier per tile), 4 x 4 tiles (three per
//     64), 4 x 8 tiles for channel pairs (four per 64), 3 channels at 18
//     warps per SM; see PERF.md;
//   * overlap: the next 64-row tile's K (or features), prec and py are
//     copied with cp.async into the second of two buffers while the
//     current tile is consumed;
//   * B3 builds each K tile from the staged features in 1 x 4 strips; the
//     inducing features are staged (transposed) once per block.
// Ragged m and n are masked (zero-filled rows and columns of the shared
// tiles), not padded in device memory; Sigma's lower triangle is never
// computed.
//
// C interface (ctypes): every pointer is a device pointer to contiguous
// fp32 data on the device of `stream`; each entry point returns
// cudaGetLastError() after its launches (0 = success).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

namespace {

// two-pass body
constexpr int TILE_N = 64;              // rows per pipeline stage
constexpr int MIN_TILE_N = 4;           // keeps the float4 arrays aligned
constexpr int CHANNELS_PER_BLOCK = 4;   // latent channels sharing a K tile
constexpr int MAX_THREADS = 192;        // threads per block (micro-tiles)
constexpr int MIN_BLOCKS_PER_SM = 2;    // -> at most 168 registers
constexpr int MIN_TILES_PER_CHUNK = 2;  // keeps the workspace small
constexpr int REDUCE_THREADS = 256;
// B2 at small m (single launch up to SMALL_CHUNK_ROWS rows)
constexpr int SMALL_MAX_M = 64;
constexpr int SMALL_CHUNK_ROWS = 256;   // rows per block, at least
constexpr int SMALL_TILE_N = 256;       // rows per pipeline stage (at most)
constexpr int SMALL_THREADS = 512;      // (n groups) x (micro-tiles), at most
constexpr int SMALL_MAX_GROUPS = 32;

constexpr int FAMILY_MNIST = 0;    // amp^2 exp(-2 sin^2(|dv|/2)/l^2) * <obj, ip_obj>
constexpr int FAMILY_SPRITES = 1;  // <act, ip_act> * <chr, ip_chr>

struct Features {
  const float* f1;   // (n, d1) data-side features (view | action)
  const float* f2;   // (n, d2) data-side features (object | character)
  const float* ip1;  // (m, d1) inducing-side features
  const float* ip2;  // (m, d2)
  int d1, d2;
  float amp, length_scale;
  int family;
  int normalize;
};

__host__ __device__ inline int pad4(int m) { return (m + 3) & ~3; }
__host__ __device__ inline int pad8(int m) { return (m + 7) & ~7; }

// ---------------------------------------------------------------------------
// asynchronous tile copies (cp.async; src_size 0 zero-fills the target)

__device__ inline void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ inline void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying a (tile x ld) tile into dst from src, element (0, 0) of
// the tile in a row-major array of row stride `stride`; rows >= rows and
// columns >= cols are zero-filled.  16-byte copies where the rows allow.
__device__ inline void stage_async(float* dst, int ld, const float* src,
                                   size_t stride, int cols, int rows,
                                   int tile, int tid, int nthr) {
  const bool vec = cols == ld && ld % 4 == 0 && stride % 4 == 0 &&
                   ((uintptr_t)src & 15) == 0;
  if (vec) {
    const int q = ld / 4;
    for (int i = tid; i < tile * q; i += nthr) {
      const int t = i / q, c = 4 * (i - t * q);
      const bool ok = t < rows;
      cp_async16(dst + t * ld + c, ok ? src + t * stride + c : src, ok);
    }
  } else {
    for (int i = tid; i < tile * ld; i += nthr) {
      const int t = i / ld, c = i - t * ld;
      const bool ok = t < rows && c < cols;
      cp_async4(dst + i, ok ? src + t * stride + c : src, ok);
    }
  }
}

// ---------------------------------------------------------------------------
// B3: K tiles from the features

__device__ inline float sq_norm(const float* __restrict__ a, int d,
                               int stride) {
  float s = 0.f;
  for (int k = 0; k < d; ++k) s = fmaf(a[k * stride], a[k * stride], s);
  return s;
}

// K[t, j..j+3] of one tile from the staged features: F1/F2 rows of the
// tile (tile x d), inducing features transposed (d x mp, zero columns
// past m), clamped data-row norms rn and inducing-row norms in (ones past
// m) -- the formulas of fused_kernel_stats_reference.  Zero feature rows
// (past n) and zero inducing columns give K = 0.
__device__ inline float4 kernel_strip(const Features& ft, const float* F1,
                                      const float* F2, const float* IP1,
                                      const float* IP2, const float* rn1,
                                      const float* rn2, const float* in1,
                                      const float* in2, int t, int j, int mp) {
  float ka[4] = {0.f, 0.f, 0.f, 0.f}, kb[4] = {0.f, 0.f, 0.f, 0.f};
  const float* f2 = F2 + t * ft.d2;
  for (int k = 0; k < ft.d2; ++k) {
    const float x = f2[k];
    const float4 z = *reinterpret_cast<const float4*>(IP2 + k * mp + j);
    kb[0] = fmaf(x, z.x, kb[0]);
    kb[1] = fmaf(x, z.y, kb[1]);
    kb[2] = fmaf(x, z.z, kb[2]);
    kb[3] = fmaf(x, z.w, kb[3]);
  }
  if (ft.family == FAMILY_MNIST) {
    const float v = F1[t * ft.d1];  // periodic part over column 0 only
    const float inv_l2 = 1.f / (ft.length_scale * ft.length_scale);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float s = sinf(0.5f * fabsf(v - IP1[j + q]));
      ka[q] = (ft.amp * ft.amp) * expf(-2.f * s * s * inv_l2);
    }
  } else {
    const float* f1 = F1 + t * ft.d1;
    for (int k = 0; k < ft.d1; ++k) {
      const float x = f1[k];
      const float4 z = *reinterpret_cast<const float4*>(IP1 + k * mp + j);
      ka[0] = fmaf(x, z.x, ka[0]);
      ka[1] = fmaf(x, z.y, ka[1]);
      ka[2] = fmaf(x, z.z, ka[2]);
      ka[3] = fmaf(x, z.w, ka[3]);
    }
  }
  if (ft.normalize) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      kb[q] = kb[q] / (rn2[t] * in2[j + q]);
      if (ft.family == FAMILY_SPRITES) ka[q] = ka[q] / (rn1[t] * in1[j + q]);
    }
  }
  return make_float4(ka[0] * kb[0], ka[1] * kb[1], ka[2] * kb[2],
                     ka[3] * kb[3]);
}

// (ti, tj), ti <= tj, of micro-tile p of the upper triangle of an
// mt x mt grid, row by row
__device__ inline void triangle_tile(int p, int mt, int* ti, int* tj) {
  int i = 0;
  while (p >= mt - i) {
    p -= mt - i;
    ++i;
  }
  *ti = i;
  *tj = i + p;
}

// ---------------------------------------------------------------------------
// two passes: partial sums per n chunk, then a fixed-order reduce

// 4 x 8 micro-tiles (rows 4 ti.., columns 8 tj..) of a pad8(m) square that
// meet its upper triangle: row block ti needs column blocks tj >= ti / 2.
__host__ __device__ inline int wide_tiles(int m) {
  const int mt8 = pad8(m) / 8;
  return mt8 * (mt8 + 1);
}

// (ti, tj) of micro-tile q of wide_tiles, row block by row block
__device__ inline void wide_tile(int q, int mt8, int* ti, int* tj) {
  int i = 0;
  while (q >= mt8 - i / 2) {
    q -= mt8 - i / 2;
    ++i;
  }
  *ti = i;
  *tj = i / 2 + q;
}

// Shared-memory layout of stats_partial_kernel, in floats; every offset is
// a multiple of 4.  Two raw stage buffers (what cp.async fills), then the
// built K tile (B3), r accumulators and the block-constant inducing
// features (B3).
struct PartialLayout {
  int raw;                         // floats per raw stage buffer
  int k, f1, f2, p, y;             // offsets inside a raw buffer
  int kb, rs, rn1, rn2, in1, in2, ip1, ip2;
  int total;
};

__host__ __device__ inline PartialLayout partial_layout(int tile, int m,
                                                        int d1, int d2,
                                                        bool features) {
  constexpr int G = CHANNELS_PER_BLOCK;
  const int mp = pad8(m);
  PartialLayout s;
  int o = 0;
  s.k = o;   o += features ? 0 : tile * mp;
  s.f1 = o;  o += tile * d1;
  s.f2 = o;  o += tile * d2;
  s.p = o;   o += tile * G;
  s.y = o;   o += tile * G;
  s.raw = o;
  o = 2 * s.raw;
  s.kb = o;  o += features ? tile * mp : 0;
  s.rs = o;  o += G * mp;
  s.rn1 = o; o += features ? tile : 0;
  s.rn2 = o; o += features ? tile : 0;
  s.in1 = o; o += features ? mp : 0;
  s.in2 = o; o += features ? mp : 0;
  s.ip1 = o; o += d1 * mp;
  s.ip2 = o; o += d2 * mp;
  s.total = o;
  return s;
}

// grid: (n_chunks, ceil(L / CHANNELS_PER_BLOCK), triangle slices)
template <bool FROM_FEATURES>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS_PER_SM)
stats_partial_kernel(const float* __restrict__ knm, Features ft,
                     const float* __restrict__ prec,
                     const float* __restrict__ py,
                     float* __restrict__ ws_sigma, float* __restrict__ ws_r,
                     int n, int m, int L, int rows_per_chunk, int tile) {
  constexpr int G = CHANNELS_PER_BLOCK;
  extern __shared__ __align__(16) float smem[];
  const int mp = pad8(m);
  const int d1 = FROM_FEATURES ? ft.d1 : 0, d2 = FROM_FEATURES ? ft.d2 : 0;
  const PartialLayout lay = partial_layout(tile, m, d1, d2, FROM_FEATURES);
  float* Kb = smem + lay.kb;    // tile x mp     built K tile (B3)
  float* Rs = smem + lay.rs;    // G x mp        r accumulators
  float* rn1 = smem + lay.rn1;  // tile          clamped data-row norms
  float* rn2 = smem + lay.rn2;
  float* in1 = smem + lay.in1;  // mp            inducing-row norms
  float* in2 = smem + lay.in2;
  float* IP1 = smem + lay.ip1;  // d1 x mp       inducing features^T
  float* IP2 = smem + lay.ip2;  // d2 x mp

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int chunk = blockIdx.x;
  const int l0 = blockIdx.y * G;
  const int n_ch = min(G, L - l0);
  const bool does_r = blockIdx.z == 0;

  // this thread's 4 x 8 micro-tile of the upper triangle, for all G
  // channels of the block
  const int p_tile = blockIdx.z * nthr + tid;
  const bool active = p_tile < wide_tiles(m);
  int ti = 0, tj = 0;
  if (active) wide_tile(p_tile, mp / 8, &ti, &tj);

  for (int i = tid; i < G * mp; i += nthr) Rs[i] = 0.f;
  if constexpr (FROM_FEATURES) {
    for (int i = tid; i < d1 * mp; i += nthr) {
      const int k = i / mp, j = i % mp;
      IP1[i] = j < m ? ft.ip1[(size_t)j * d1 + k] : 0.f;
    }
    for (int i = tid; i < d2 * mp; i += nthr) {
      const int k = i / mp, j = i % mp;
      IP2[i] = j < m ? ft.ip2[(size_t)j * d2 + k] : 0.f;
    }
    if (ft.normalize) {
      __syncthreads();
      for (int j = tid; j < mp; j += nthr) {
        // ones past m, so the zero padding columns stay 0, not 0/0
        in1[j] = (j < m && ft.family == FAMILY_SPRITES)
                     ? sqrtf(sq_norm(IP1 + j, d1, mp)) : 1.f;
        in2[j] = j < m ? sqrtf(sq_norm(IP2 + j, d2, mp)) : 1.f;
      }
    }
  }

  const int row_begin = chunk * rows_per_chunk;
  const int row_end = min(n, row_begin + rows_per_chunk);
  const int n_tiles = (row_end - row_begin + tile - 1) / tile;
  auto stage = [&](int it, int buf) {
    float* raw = smem + buf * lay.raw;
    const int row0 = row_begin + it * tile;
    const int rows = row_end - row0;
    if constexpr (FROM_FEATURES) {
      stage_async(raw + lay.f1, d1, ft.f1 + (size_t)row0 * d1, d1, d1, rows,
                  tile, tid, nthr);
      stage_async(raw + lay.f2, d2, ft.f2 + (size_t)row0 * d2, d2, d2, rows,
                  tile, tid, nthr);
    } else {
      stage_async(raw + lay.k, mp, knm + (size_t)row0 * m, m, m, rows, tile,
                  tid, nthr);
    }
    stage_async(raw + lay.p, G, prec + (size_t)row0 * L + l0, L, n_ch, rows,
                tile, tid, nthr);
    stage_async(raw + lay.y, G, py + (size_t)row0 * L + l0, L, n_ch, rows,
                tile, tid, nthr);
    cp_async_commit();
  };

  float acc[G][4][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][i][j] = 0.f;

  if (n_tiles > 0) stage(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const float* raw = smem + buf * lay.raw;
    const float* P = raw + lay.p;  // tile x G
    const float* Y = raw + lay.y;  // tile x G
    cp_async_wait_all();
    __syncthreads();  // tile `it` is in; tile it - 1 is fully consumed
    if (it + 1 < n_tiles) stage(it + 1, buf ^ 1);

    const float* Kt;  // the K tile of this step (tile x mp)
    if constexpr (FROM_FEATURES) {
      const float* F1 = raw + lay.f1;
      const float* F2 = raw + lay.f2;
      if (ft.normalize) {
        for (int t = tid; t < tile; t += nthr) {
          // clamp: an all-zero data row would otherwise give 0/0
          rn1[t] = ft.family == FAMILY_SPRITES
                       ? fmaxf(sqrtf(sq_norm(F1 + t * d1, d1, 1)), 1e-30f)
                       : 1.f;
          rn2[t] = fmaxf(sqrtf(sq_norm(F2 + t * d2, d2, 1)), 1e-30f);
        }
        __syncthreads();
      }
      const int strips = mp / 4;
      for (int i = tid; i < tile * strips; i += nthr) {
        const int t = i / strips, j = 4 * (i - t * strips);
        *reinterpret_cast<float4*>(Kb + t * mp + j) = kernel_strip(
            ft, F1, F2, IP1, IP2, rn1, rn2, in1, in2, t, j, mp);
      }
      Kt = Kb;
      __syncthreads();  // the K tile is built
    } else {
      Kt = raw + lay.k;
    }

    if (does_r) {
      // each (g, j) accumulator is owned by one thread across all tiles
      for (int i = tid; i < G * m; i += nthr) {
        const int g = i / m, j = i % m;
        float s = Rs[g * mp + j];
        for (int t = 0; t < tile; ++t) s = fmaf(Y[t * G + g], Kt[t * mp + j], s);
        Rs[g * mp + j] = s;
      }
    }
    if (active) {
#pragma unroll 2
      for (int t = 0; t < tile; ++t) {
        const float* row = Kt + t * mp;
        const float4 a = *reinterpret_cast<const float4*>(row + 4 * ti);
        const float4 b0 = *reinterpret_cast<const float4*>(row + 8 * tj);
        const float4 b1 = *reinterpret_cast<const float4*>(row + 8 * tj + 4);
        const float4 p4 = *reinterpret_cast<const float4*>(P + t * G);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pa = pv[g] * av[i];
#pragma unroll
            for (int j = 0; j < 8; ++j)
              acc[g][i][j] = fmaf(pa, bv[j], acc[g][i][j]);
          }
        }
      }
    }
  }

  if (active) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int l = l0 + g;
      if (l >= L) continue;
      float* out = ws_sigma + ((size_t)chunk * L + l) * m * m;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ti + i;
        if (r >= m) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * tj + j;
          if (c < m) out[(size_t)r * m + c] = acc[g][i][j];
        }
      }
    }
  }
  if (does_r) {
    for (int i = tid; i < G * m; i += nthr) {
      const int g = i / m, j = i % m, l = l0 + g;
      if (l < L) ws_r[((size_t)chunk * L + l) * m + j] = Rs[g * mp + j];
    }
  }
}

// sum_c p[c * stride] in chunk order, with REDUCE_BATCH loads in flight
constexpr int REDUCE_BATCH = 8;
__device__ inline float sum_chunks(const float* __restrict__ p, size_t stride,
                                   int n_chunks) {
  float s = 0.f;
  int c = 0;
  for (; c + REDUCE_BATCH <= n_chunks; c += REDUCE_BATCH) {
    float v[REDUCE_BATCH];
#pragma unroll
    for (int q = 0; q < REDUCE_BATCH; ++q) v[q] = p[(size_t)(c + q) * stride];
#pragma unroll
    for (int q = 0; q < REDUCE_BATCH; ++q) s += v[q];
  }
  for (; c < n_chunks; ++c) s += p[(size_t)c * stride];
  return s;
}

// Sum the per-chunk partials in chunk order; mirror the upper triangle.
__global__ void __launch_bounds__(REDUCE_THREADS)
stats_reduce_kernel(const float* __restrict__ ws_sigma,
                    const float* __restrict__ ws_r, float* __restrict__ sigma,
                    float* __restrict__ r, int n_chunks, int m, int L) {
  const size_t mm = (size_t)m * m;
  const size_t n_sigma = (size_t)L * mm;
  const size_t n_total = n_sigma + (size_t)L * m;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < n_total; idx += (size_t)gridDim.x * blockDim.x) {
    if (idx < n_sigma) {
      const size_t l = idx / mm;
      const int e = (int)(idx % mm);
      const int i = e / m, j = e % m;
      const size_t src = l * mm + (size_t)min(i, j) * m + max(i, j);
      sigma[idx] = sum_chunks(ws_sigma + src, n_sigma, n_chunks);
    } else {
      const size_t k = idx - n_sigma;
      r[k] = sum_chunks(ws_r + k, (size_t)L * m, n_chunks);
    }
  }
}

// ---------------------------------------------------------------------------
// B2 at m <= SMALL_MAX_M: one block per (channel, n chunk); with one chunk
// the block writes the outputs itself (single launch, no workspace)

__host__ __device__ inline int small_tiles(int m) {
  const int mt = pad4(m) / 4;  // 4 x 4 micro-tiles per side
  return mt * (mt + 1) / 2;
}

__host__ __device__ inline int small_groups(int m) {
  const int g = SMALL_THREADS / small_tiles(m);
  return g < 1 ? 1 : (g > SMALL_MAX_GROUPS ? SMALL_MAX_GROUPS : g);
}

// Shared-memory layout of stats_small_kernel, in floats: two raw stage
// buffers (K tile, prec and py columns of the channel); after the loop
// the same space holds every thread's sums (SMALL_PAYLOAD floats each).
constexpr int SMALL_PAYLOAD = 20;  // 4 x 4 of Sigma, 4 of r
struct SmallLayout {
  int raw, k, p, y, total;
};

__host__ __device__ inline SmallLayout small_layout(int tile, int m) {
  const int mp = pad4(m);
  const int red = small_groups(m) * small_tiles(m) * SMALL_PAYLOAD;
  SmallLayout s;
  int o = 0;
  s.k = o;  o += tile * mp;
  s.p = o;  o += tile;
  s.y = o;  o += tile;
  s.raw = o;
  s.total = 2 * s.raw > red ? 2 * s.raw : red;
  return s;
}

// grid: (L, chunks); block: small_groups(m) x small_tiles(m) threads.
// Thread (group g, micro-tile (ti, tj)) sums rows t = g (mod groups) of
// Sigma's 4 x 4 block (4 ti.., 4 tj..); the threads of triangle row
// ti = 0 also sum r at columns 4 tj.. from the same loads.  The groups'
// sums are then added in group order, one output element per thread.
// mirror = 1 (one chunk): Sigma (both triangles) and r go to sigma_out /
// r_out; mirror = 0: the chunk's upper triangle and r go to the
// workspace, for stats_reduce_kernel.
__global__ void __launch_bounds__(SMALL_THREADS, 2)
stats_small_kernel(const float* __restrict__ knm,
                   const float* __restrict__ prec,
                   const float* __restrict__ py,
                   float* __restrict__ sigma_out, float* __restrict__ r_out,
                   int n, int m, int L, int rows_per_chunk, int tile,
                   int mirror) {
  extern __shared__ __align__(16) float smem[];
  const int mp = pad4(m), mt = mp / 4, n_tri = small_tiles(m);
  const int groups = small_groups(m);
  const SmallLayout lay = small_layout(tile, m);
  const int l = blockIdx.x, chunk = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int grp = tid / n_tri, p_tile = tid - grp * n_tri;
  int ti = 0, tj = 0;
  triangle_tile(p_tile, mt, &ti, &tj);

  const int row_begin = chunk * rows_per_chunk;
  const int row_end = min(n, row_begin + rows_per_chunk);
  const int n_tiles = (row_end - row_begin + tile - 1) / tile;
  auto stage = [&](int it, int buf) {
    float* raw = smem + buf * lay.raw;
    const int row0 = row_begin + it * tile, rows = row_end - row0;
    stage_async(raw + lay.k, mp, knm + (size_t)row0 * m, m, m, rows, tile,
                tid, nthr);
    stage_async(raw + lay.p, 1, prec + (size_t)row0 * L + l, L, 1, rows,
                tile, tid, nthr);
    stage_async(raw + lay.y, 1, py + (size_t)row0 * L + l, L, 1, rows, tile,
                tid, nthr);
    cp_async_commit();
  };

  float acc[SMALL_PAYLOAD];
#pragma unroll
  for (int e = 0; e < SMALL_PAYLOAD; ++e) acc[e] = 0.f;
  if (n_tiles > 0) stage(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    const float* raw = smem + buf * lay.raw;
    const float* K = raw + lay.k;
    const float* P = raw + lay.p;
    const float* Y = raw + lay.y;
    cp_async_wait_all();
    __syncthreads();  // tile `it` is in; tile it - 1 is fully consumed
    if (it + 1 < n_tiles) stage(it + 1, buf ^ 1);
#pragma unroll 2
    for (int t = grp; t < tile; t += groups) {
      const float4 a = *reinterpret_cast<const float4*>(K + t * mp + 4 * ti);
      const float4 b = *reinterpret_cast<const float4*>(K + t * mp + 4 * tj);
      const float pt = P[t], yt = Y[t];
      const float av[4] = {pt * a.x, pt * a.y, pt * a.z, pt * a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[4 * i + j] = fmaf(av[i], bv[j], acc[4 * i + j]);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[16 + j] = fmaf(yt, bv[j], acc[16 + j]);
    }
  }
  __syncthreads();  // every thread is done with the stage buffers

  float* red = smem;  // groups x n_tri x SMALL_PAYLOAD
#pragma unroll
  for (int e = 0; e < SMALL_PAYLOAD; ++e)
    red[(grp * n_tri + p_tile) * SMALL_PAYLOAD + e] = acc[e];
  __syncthreads();
  float* out_s = sigma_out + ((size_t)chunk * L + l) * m * m;
  float* out_r = r_out + ((size_t)chunk * L + l) * m;
  for (int idx = tid; idx < n_tri * SMALL_PAYLOAD; idx += nthr) {
    const int p = idx / SMALL_PAYLOAD, e = idx - p * SMALL_PAYLOAD;
    float v = 0.f;
    for (int g = 0; g < groups; ++g)
      v += red[(g * n_tri + p) * SMALL_PAYLOAD + e];
    int i0, j0;
    triangle_tile(p, mt, &i0, &j0);
    if (e < 16) {
      const int row = 4 * i0 + e / 4, col = 4 * j0 + e % 4;
      if (row < m && col < m && row <= col) {
        out_s[(size_t)row * m + col] = v;
        if (mirror) out_s[(size_t)col * m + row] = v;
      }
    } else if (i0 == 0 && 4 * j0 + e - 16 < m) {
      out_r[4 * j0 + e - 16] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// host side

// Threads per block and triangle slices of the partial-sum grid: one
// thread per 4 x 8 micro-tile of the upper triangle, at most MAX_THREADS.
struct TriangleGrid {
  int threads, slices;
};

TriangleGrid triangle_grid(int m) {
  const int n_tri = wide_tiles(m);
  int threads = ((n_tri + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  return {threads, (n_tri + threads - 1) / threads};
}

size_t partial_smem_bytes(int tile, int m, int d1, int d2, bool features) {
  return sizeof(float) * (size_t)partial_layout(tile, m, d1, d2, features).total;
}

size_t small_smem_bytes(int tile, int m) {
  return sizeof(float) * (size_t)small_layout(tile, m).total;
}

const void* partial_fn(bool features) {
  return features ? (const void*)stats_partial_kernel<true>
                  : (const void*)stats_partial_kernel<false>;
}

// B2 at small m goes through stats_small_kernel, everything else through
// stats_partial_kernel
bool uses_small(int m, bool features) { return !features && m <= SMALL_MAX_M; }

struct Plan {
  int n_chunks;  // 0: single launch, no workspace
  int rows_per_chunk;
  int tile;
};

// The kernel, grid, threads and shared memory that a plan launches (the
// reduce, when there are chunks, comes after it).
struct Kernel {
  const void* fn;
  dim3 grid;
  int threads;
  size_t smem;
};

Kernel plan_kernel(const Plan& plan, int m, int L, int d1, int d2) {
  const bool features = d1 > 0 || d2 > 0;
  const unsigned chunks = plan.n_chunks > 0 ? plan.n_chunks : 1;
  if (uses_small(m, features))
    return {(const void*)stats_small_kernel, dim3(L, chunks),
            small_groups(m) * small_tiles(m), small_smem_bytes(plan.tile, m)};
  const TriangleGrid tg = triangle_grid(m);
  return {partial_fn(features),
          dim3(chunks, (L + CHANNELS_PER_BLOCK - 1) / CHANNELS_PER_BLOCK,
               tg.slices),
          tg.threads, partial_smem_bytes(plan.tile, m, d1, d2, features)};
}

// What a launch of this shape looks like on the current device; sets each
// kernel's dynamic shared-memory limit to the device's opt-in maximum.
int make_plan(int n, int m, int L, int d1, int d2, Plan* plan) {
  const bool features = d1 > 0 || d2 > 0;
  if (n < 1 || m < 1 || L < 1 || d1 < 0 || d2 < 0 ||
      (features && (d1 < 1 || d2 < 1)))
    return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  for (const void* fn : {partial_fn(false), partial_fn(true),
                         (const void*)stats_small_kernel}) {
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  if (e != cudaSuccess) return (int)e;

  if (uses_small(m, features)) {
    // one block per (channel, chunk) of at least SMALL_CHUNK_ROWS rows, at
    // most one wave; one chunk is the single launch
    int tile = SMALL_TILE_N;
    while (tile > MIN_TILE_N && small_smem_bytes(tile, m) > (size_t)optin)
      tile /= 2;
    const Kernel k = plan_kernel({0, n, tile}, m, L, d1, d2);
    if (k.smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    int resident = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, k.fn,
                                                      k.threads, k.smem);
    if (e != cudaSuccess) return (int)e;
    long long chunks = ((long long)n + SMALL_CHUNK_ROWS - 1) / SMALL_CHUNK_ROWS;
    const long long wave = (long long)resident * sms / L;
    if (chunks > wave) chunks = wave;
    if (chunks <= 1) {
      *plan = {0, n, tile};
      return 0;
    }
    const long long rows = ((n + chunks - 1) / chunks + 3) / 4 * 4;
    *plan = {(int)((n + rows - 1) / rows), (int)rows, tile};
    return 0;
  }

  int tile = TILE_N;
  while (tile > MIN_TILE_N &&
         partial_smem_bytes(tile, m, d1, d2, features) > (size_t)optin)
    tile /= 2;
  const Kernel k = plan_kernel({1, n, tile}, m, L, d1, d2);
  if (k.smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  int resident = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, k.fn,
                                                    k.threads, k.smem);
  if (e != cudaSuccess) return (int)e;
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  // all blocks resident in one wave; chunks of whole TILE_N tiles
  const long long blocks_per_chunk = (long long)k.grid.y * k.grid.z;
  const long long n_tiles = ((long long)n + TILE_N - 1) / TILE_N;
  long long chunks = (long long)resident * sms / blocks_per_chunk;
  const long long most = n_tiles / MIN_TILES_PER_CHUNK;
  if (chunks > most) chunks = most;
  if (chunks < 1) chunks = 1;
  const long long rows = (n_tiles + chunks - 1) / chunks * TILE_N;
  *plan = {(int)((n + rows - 1) / rows), (int)rows, tile};
  return 0;
}

bool valid_plan(const Plan& p, int n, int m, int L) {
  return n >= 1 && m >= 1 && L >= 1 && p.n_chunks >= 0 &&
         p.tile >= MIN_TILE_N && p.tile % 4 == 0 && p.rows_per_chunk >= 1 &&
         (p.n_chunks == 0 ? p.rows_per_chunk >= n
                          : (long long)p.n_chunks * p.rows_per_chunk >= n);
}

int launch_reduce(const float* ws_sigma, const float* ws_r, float* sigma,
                  float* r, int n_chunks, int m, int L, cudaStream_t stream) {
  const size_t total = (size_t)L * m * m + (size_t)L * m;
  size_t blocks = (total + REDUCE_THREADS - 1) / REDUCE_THREADS;
  if (blocks > 65535) blocks = 65535;
  stats_reduce_kernel<<<(unsigned)blocks, REDUCE_THREADS, 0, stream>>>(
      ws_sigma, ws_r, sigma, r, n_chunks, m, L);
  return (int)cudaGetLastError();
}

template <bool FROM_FEATURES>
int launch_partial(const float* knm, const Features& ft, const float* prec,
                   const float* py, float* sigma, float* r, float* ws_sigma,
                   float* ws_r, int n, int m, int L, const Plan& plan,
                   cudaStream_t stream) {
  if (!valid_plan(plan, n, m, L) || plan.n_chunks < 1 ||
      plan.rows_per_chunk % plan.tile != 0)
    return (int)cudaErrorInvalidValue;
  const Kernel k = plan_kernel(plan, m, L, FROM_FEATURES ? ft.d1 : 0,
                               FROM_FEATURES ? ft.d2 : 0);
  stats_partial_kernel<FROM_FEATURES><<<k.grid, k.threads, k.smem, stream>>>(
      knm, ft, prec, py, ws_sigma, ws_r, n, m, L, plan.rows_per_chunk,
      plan.tile);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_reduce(ws_sigma, ws_r, sigma, r, plan.n_chunks, m, L, stream);
}

int launch_small(const float* knm, const float* prec, const float* py,
                 float* sigma, float* r, float* ws_sigma, float* ws_r, int n,
                 int m, int L, const Plan& plan, cudaStream_t stream) {
  if (!valid_plan(plan, n, m, L) || m > SMALL_MAX_M)
    return (int)cudaErrorInvalidValue;
  const bool single = plan.n_chunks == 0;
  const Kernel k = plan_kernel(plan, m, L, 0, 0);
  stats_small_kernel<<<k.grid, k.threads, k.smem, stream>>>(
      knm, prec, py, single ? sigma : ws_sigma, single ? r : ws_r, n, m, L,
      plan.rows_per_chunk, plan.tile, single);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || single) return (int)e;
  return launch_reduce(ws_sigma, ws_r, sigma, r, plan.n_chunks, m, L, stream);
}

}  // namespace

extern "C" {

const char* svgp_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

// The launch plan of a shape on the current device, as {n_chunks,
// rows_per_chunk, tile}: n_chunks = 0 is the single launch (no
// workspace); otherwise the caller sizes the partial-sum workspace as
// n_chunks x L x (m x m + m) floats.  d1 = d2 = 0 is B2 (K from memory),
// d1, d2 >= 1 is B3.
int svgp_stats_plan(int n, int m, int L, int d1, int d2, int* out) {
  Plan plan;
  const int status = make_plan(n, m, L, d1, d2, &plan);
  if (status != 0) return status;
  out[0] = plan.n_chunks;
  out[1] = plan.rows_per_chunk;
  out[2] = plan.tile;
  return 0;
}

// The kernels a shape's plan launches, on the current device: info =
// {single launch (1) or two passes (0), threads per block, dynamic shared
// memory bytes, registers per thread, resident blocks per SM, blocks in
// the grid, and for two passes the reduce kernel's registers per thread
// and resident blocks per SM (0 otherwise)}.
int svgp_stats_info(int n, int m, int L, int d1, int d2, int* info) {
  Plan plan;
  int status = make_plan(n, m, L, d1, d2, &plan);
  if (status != 0) return status;
  const Kernel k = plan_kernel(plan, m, L, d1, d2);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, k.fn);
  int resident = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, k.fn,
                                                      k.threads, k.smem);
  if (e != cudaSuccess) return (int)e;
  info[0] = plan.n_chunks == 0;
  info[1] = k.threads;
  info[2] = (int)k.smem;
  info[3] = attr.numRegs;
  info[4] = resident;
  info[5] = (int)(k.grid.x * k.grid.y * k.grid.z);
  info[6] = info[7] = 0;
  if (plan.n_chunks > 0) {
    e = cudaFuncGetAttributes(&attr, (const void*)stats_reduce_kernel);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &resident, (const void*)stats_reduce_kernel, REDUCE_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    info[6] = attr.numRegs;
    info[7] = resident;
  }
  return 0;
}

// B2: K_nm (n, m) read from device memory.  plan = {n_chunks,
// rows_per_chunk, tile} from svgp_stats_plan; n_chunks = 0 takes no
// workspace (ws_sigma, ws_r may be null).
int svgp_gp_stats(const float* knm, const float* prec, const float* py,
                  float* sigma, float* r, float* ws_sigma, float* ws_r, int n,
                  int m, int L, const int* plan, void* stream) {
  const Plan p = {plan[0], plan[1], plan[2]};
  if (uses_small(m, false))
    return launch_small(knm, prec, py, sigma, r, ws_sigma, ws_r, n, m, L, p,
                        (cudaStream_t)stream);
  Features none = {};
  return launch_partial<false>(knm, none, prec, py, sigma, r, ws_sigma, ws_r,
                               n, m, L, p, (cudaStream_t)stream);
}

// B3: K built in-kernel from f1 (n, d1), f2 (n, d2), ip1 (m, d1), ip2 (m, d2).
// family: 0 = mnist (periodic over f1[:, 0] x linear over f2),
//         1 = sprites (linear x linear).  Always two passes.
int svgp_fused_kernel_stats(const float* f1, const float* f2, const float* ip1,
                            const float* ip2, int d1, int d2, float amp,
                            float length_scale, int family, int normalize,
                            const float* prec, const float* py, float* sigma,
                            float* r, float* ws_sigma, float* ws_r, int n,
                            int m, int L, const int* plan, void* stream) {
  if (d1 < 1 || d2 < 1 || (family != FAMILY_MNIST && family != FAMILY_SPRITES))
    return (int)cudaErrorInvalidValue;
  Features ft = {f1, f2, ip1, ip2, d1, d2, amp, length_scale, family,
                 normalize};
  return launch_partial<true>(nullptr, ft, prec, py, sigma, r, ws_sigma,
                              ws_r, n, m, L, {plan[0], plan[1], plan[2]},
                              (cudaStream_t)stream);
}

}  // extern "C"
