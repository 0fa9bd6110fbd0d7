// GP sufficient statistics on Hopper, for all L latent channels at once:
//
//     Sigma_l = sum_n prec[n, l] * K[n, :]^T K[n, :]      (L, m, m)
//     r_l     = sum_n py[n, l]   * K[n, :]               (L, m)
//
// Replaces two Pallas TPU kernels with one source:
//   * svgpvae_tpu/ops/gp_stats.py::gp_sufficient_stats (body _stats_kernel):
//     K_nm is read from device memory            -> svgp_gp_stats
//   * svgpvae_tpu/ops/fused_kernel_stats.py::fused_kernel_stats (body
//     _kernel_body): K built from the raw features
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
// m > SMALL_MAX_M (the SPRITES fit): stats_partial_kernel +
// stats_reduce_kernel.  The TPU grid walks its n tiles in order and
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
//   * overlap: the next 64-row tile's K, prec and py are copied with
//     cp.async into the second of two buffers while the current tile is
//     consumed;
//   * r is its own short pass over the staged tile: a thread owns one
//     channel's 4 columns for the whole kernel, one 16-byte K load and
//     one py load per 4 FMAs.
//
// B3 (build_k_kernel, then B2's path above on the result).  The TPU
// kernel builds each K tile in VMEM, once for all L channels, so K never
// reaches HBM.  On Hopper a block holds 4 channels (registers), so 16
// blocks need each tile at the fit shape; built in each block, that is
// 16 builds of every tile (19% more instructions than the Sigma loop)
// between block-wide barriers.  K itself is small: 14.4 MB at
// n = 50,000, m = 72, which the 50 MB L2 holds.  So B3 writes K once,
// one 1 x 4 strip per thread (d1 and d2 unrolled for the widths the paths
// use: 8 + 16 and 1 + 8), and B2's kernels read it back from L2: the
// build is 0.02 ms of a 0.61 ms call at the fit shape, so what bounds B3
// is the partial-sum body above.  Measured on an
// H100 against the alternative that keeps K on chip -- clusters of 2, 4
// or 8 blocks that build each tile once per cluster and share it through
// distributed shared memory, the build spread between the Sigma rows or
// given to a producer warp -- every clustered form was slower
// (0.72-0.81 ms): the build and cluster bookkeeping beside 128
// accumulators spill at the 168-register cap that four blocks per SM
// need, and a producer warp leaves room for three; see PERF.md.
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
// B3's K-build pass
constexpr int BUILD_THREADS = 256;
constexpr int BUILD_BLOCKS_PER_SM = 4;  // grid-stride loop over (row, strip)
constexpr float NORM_CLAMP = 1e-30f;
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
  float amp2, inv_l2;  // mnist: amp^2 and 1 / length_scale^2
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
// B3: K from the features

__device__ inline float sq_norm(const float* __restrict__ a, int d,
                               int stride) {
  float s = 0.f;
  for (int k = 0; k < d; ++k) s = fmaf(a[k * stride], a[k * stride], s);
  return s;
}

// k[q] += sum_c x[c] IPT[c, j + q] (q < 4) and sq += sum_c x[c]^2, over
// a data row x (d features) and the transposed inducing features IPT
// (d x mp).  D > 0 is d at compile time (unrolled, 16-byte row loads when
// D % 4 == 0); D = 0 reads d at run time.
template <int D>
__device__ inline void dot_strip(const float* __restrict__ x,
                                 const float* __restrict__ IPT, int d, int j,
                                 int mp, float (&k)[4], float& sq) {
  auto step = [&](float xv, int c) {
    const float4 z = *reinterpret_cast<const float4*>(IPT + c * mp + j);
    k[0] = fmaf(xv, z.x, k[0]);
    k[1] = fmaf(xv, z.y, k[1]);
    k[2] = fmaf(xv, z.z, k[2]);
    k[3] = fmaf(xv, z.w, k[3]);
    sq = fmaf(xv, xv, sq);
  };
  if constexpr (D > 0 && D % 4 == 0) {
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const float4 v = *reinterpret_cast<const float4*>(x + c);
      step(v.x, c);
      step(v.y, c + 1);
      step(v.z, c + 2);
      step(v.w, c + 3);
    }
  } else if constexpr (D > 0) {
#pragma unroll
    for (int c = 0; c < D; ++c) step(x[c], c);
  } else {
    for (int c = 0; c < d; ++c) step(x[c], c);
  }
}

// The B3 variant a launch runs: family, d1, d2 and normalize fixed at
// compile time where >= 0 (> 0 for d), read from Features where not.
template <int FAM, int D1, int D2, int NORM>
struct Variant {
  __device__ static int family(const Features& ft) {
    return FAM >= 0 ? FAM : ft.family;
  }
  __device__ static bool normalize(const Features& ft) {
    return NORM >= 0 ? NORM == 1 : ft.normalize != 0;
  }
  __device__ static int d1(const Features& ft) { return D1 > 0 ? D1 : ft.d1; }
  __device__ static int d2(const Features& ft) { return D2 > 0 ? D2 : ft.d2; }
};

// K[t, j..j+3] of one data row from its features f1 (d1), f2 (d2), the
// transposed inducing features IP1 (d1 x mp), IP2 (d2 x mp; zero columns
// past m) and the inducing-row norms in1, in2 (ones past m) -- the
// formulas of fused_kernel_stats_reference, with the data-row norms
// clamped at NORM_CLAMP.  Zero feature rows (past n) and zero inducing
// columns give K = 0.
template <class V, int D1, int D2>
__device__ inline float4 build_strip(const Features& ft, const float* f1,
                                     const float* f2, const float* IP1,
                                     const float* IP2, const float* in1,
                                     const float* in2, int j, int mp) {
  const int family = V::family(ft);
  float ka[4] = {0.f, 0.f, 0.f, 0.f}, kb[4] = {0.f, 0.f, 0.f, 0.f};
  float s1 = 0.f, s2 = 0.f;
  dot_strip<D2>(f2, IP2, V::d2(ft), j, mp, kb, s2);
  if (family == FAMILY_MNIST) {
    const float v = f1[0];  // periodic part over column 0 only
    const float4 z = *reinterpret_cast<const float4*>(IP1 + j);
    const float zv[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float s = sinf(0.5f * fabsf(v - zv[q]));
      ka[q] = ft.amp2 * expf(-2.f * s * s * ft.inv_l2);
    }
  } else {
    dot_strip<D1>(f1, IP1, V::d1(ft), j, mp, ka, s1);
  }
  if (V::normalize(ft)) {
    const float4 i1 = *reinterpret_cast<const float4*>(in1 + j);
    const float4 i2 = *reinterpret_cast<const float4*>(in2 + j);
    const float n1[4] = {i1.x, i1.y, i1.z, i1.w};
    const float n2[4] = {i2.x, i2.y, i2.z, i2.w};
    const float r1 = fmaxf(sqrtf(s1), NORM_CLAMP);
    const float r2 = fmaxf(sqrtf(s2), NORM_CLAMP);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      kb[q] = kb[q] / (r2 * n2[q]);
      if (family == FAMILY_SPRITES) ka[q] = ka[q] / (r1 * n1[q]);
    }
  }
  return make_float4(ka[0] * kb[0], ka[1] * kb[1], ka[2] * kb[2],
                     ka[3] * kb[3]);
}

// B3's first pass: K (n, m) from the features, one 1 x 4 strip per
// thread and step of a grid-stride loop, each written once to device
// memory (14.4 MB at the fit shape: it stays in the 50 MB L2 for the
// partial-sum pass that reads it).  The inducing features are staged
// (transposed) with their norms in shared memory once per block.
template <int FAM, int D1, int D2, int NORM>
__global__ void __launch_bounds__(BUILD_THREADS)
build_k_kernel(Features ft, float* __restrict__ knm, int n, int m) {
  using V = Variant<FAM, D1, D2, NORM>;
  extern __shared__ __align__(16) float smem[];
  const int d1 = V::d1(ft), d2 = V::d2(ft), mp = pad8(m);
  float* in1 = smem;            // mp       inducing-row norms
  float* in2 = smem + mp;
  float* IP1 = smem + 2 * mp;   // d1 x mp  inducing features^T
  float* IP2 = IP1 + d1 * mp;   // d2 x mp
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int i = tid; i < d1 * mp; i += nthr) {
    const int k = i / mp, j = i % mp;
    IP1[i] = j < m ? ft.ip1[(size_t)j * d1 + k] : 0.f;
  }
  for (int i = tid; i < d2 * mp; i += nthr) {
    const int k = i / mp, j = i % mp;
    IP2[i] = j < m ? ft.ip2[(size_t)j * d2 + k] : 0.f;
  }
  __syncthreads();
  if (V::normalize(ft)) {
    for (int j = tid; j < mp; j += nthr) {
      // ones past m, so the zero padding columns stay 0, not 0/0
      in1[j] = (j < m && V::family(ft) == FAMILY_SPRITES)
                   ? sqrtf(sq_norm(IP1 + j, d1, mp)) : 1.f;
      in2[j] = j < m ? sqrtf(sq_norm(IP2 + j, d2, mp)) : 1.f;
    }
    __syncthreads();
  }
  const int strips = (m + 3) / 4;
  const long long total = (long long)n * strips;
  for (long long u = (long long)blockIdx.x * nthr + tid; u < total;
       u += (long long)gridDim.x * nthr) {
    const int t = (int)(u / strips), j = 4 * (int)(u - (long long)t * strips);
    const float4 k = build_strip<V, D1, D2>(
        ft, ft.f1 + (size_t)t * d1, ft.f2 + (size_t)t * d2, IP1, IP2, in1,
        in2, j, mp);
    float* out = knm + (size_t)t * m + j;
    if (m % 4 == 0) {
      *reinterpret_cast<float4*>(out) = k;
    } else {  // ragged m: the row stride is not a multiple of 16 bytes
      out[0] = k.x;
      if (j + 1 < m) out[1] = k.y;
      if (j + 2 < m) out[2] = k.z;
      if (j + 3 < m) out[3] = k.w;
    }
  }
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
// r accumulators.
struct PartialLayout {
  int raw;       // floats per raw stage buffer
  int k, p, y;   // offsets inside a raw buffer
  int rs, total;
};

__host__ __device__ inline PartialLayout partial_layout(int tile, int m) {
  constexpr int G = CHANNELS_PER_BLOCK;
  const int mp = pad8(m);
  PartialLayout s;
  int o = 0;
  s.k = o;   o += tile * mp;
  s.p = o;   o += tile * G;
  s.y = o;   o += tile * G;
  s.raw = o;
  o = 2 * s.raw;
  s.rs = o;  o += G * mp;
  s.total = o;
  return s;
}

// grid: (n_chunks, ceil(L / CHANNELS_PER_BLOCK), triangle slices).  The
// layout comes in as a parameter (partial_layout(tile, m), computed on
// the host), so its offsets are operands, not registers: beside the 128
// accumulators the 168 registers then hold everything else, no spills.
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS_PER_SM)
stats_partial_kernel(const float* __restrict__ knm,
                     const float* __restrict__ prec,
                     const float* __restrict__ py,
                     float* __restrict__ ws_sigma, float* __restrict__ ws_r,
                     int n, int m, int L, int rows_per_chunk, int tile,
                     PartialLayout lay) {
  constexpr int G = CHANNELS_PER_BLOCK;
  extern __shared__ __align__(16) float smem[];
  const int mp = pad8(m);
  float* Rs = smem + lay.rs;    // G x mp        r accumulators

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

  const int row_begin = chunk * rows_per_chunk;
  const int row_end = min(n, row_begin + rows_per_chunk);
  const int n_tiles = (row_end - row_begin + tile - 1) / tile;
  auto stage = [&](int it, int buf) {
    float* raw = smem + buf * lay.raw;
    const int row0 = row_begin + it * tile;
    const int rows = row_end - row0;
    stage_async(raw + lay.k, mp, knm + (size_t)row0 * m, m, m, rows, tile,
                tid, nthr);
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
    const float* Kt = raw + lay.k;  // tile x mp
    const float* P = raw + lay.p;   // tile x G
    const float* Y = raw + lay.y;   // tile x G
    cp_async_wait_all();
    __syncthreads();  // tile `it` is in; tile it - 1 is fully consumed
    if (it + 1 < n_tiles) stage(it + 1, buf ^ 1);

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
    if (does_r) {
      // unit u = (channel g, columns 4 s..4 s+3) is owned by one thread
      // across all tiles: one 16-byte K load and one Y load per 4 FMAs
      const int strips = mp / 4;
      for (int u = tid; u < G * strips; u += nthr) {
        const int g = u / strips, j = 4 * (u - g * strips);
        float4 s = *reinterpret_cast<const float4*>(Rs + g * mp + j);
#pragma unroll 4
        for (int t = 0; t < tile; ++t) {
          const float y = Y[t * G + g];
          const float4 k = *reinterpret_cast<const float4*>(Kt + t * mp + j);
          s.x = fmaf(y, k.x, s.x);
          s.y = fmaf(y, k.y, s.y);
          s.z = fmaf(y, k.z, s.z);
          s.w = fmaf(y, k.w, s.w);
        }
        *reinterpret_cast<float4*>(Rs + g * mp + j) = s;
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
  if (does_r) {  // each thread writes the r columns it owns
    const int strips = mp / 4;
    for (int u = tid; u < G * strips; u += nthr) {
      const int g = u / strips, j = 4 * (u - g * strips), l = l0 + g;
      for (int q = 0; q < 4 && l < L && j + q < m; ++q)
        ws_r[((size_t)chunk * L + l) * m + j + q] = Rs[g * mp + j + q];
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

size_t partial_smem_bytes(int tile, int m) {
  return sizeof(float) * (size_t)partial_layout(tile, m).total;
}

size_t small_smem_bytes(int tile, int m) {
  return sizeof(float) * (size_t)small_layout(tile, m).total;
}

size_t build_smem_bytes(int m, int d1, int d2) {
  return sizeof(float) * (size_t)(2 + d1 + d2) * pad8(m);
}

// small m goes through stats_small_kernel, the rest through
// stats_partial_kernel
bool uses_small(int m) { return m <= SMALL_MAX_M; }

// B3's K-build kernel for a call: compiled for the feature widths the
// paths use (SPRITES 8 + 16, the MNIST GPLVM's 1 + 8) and normalize, else
// the run-time form.
const void* build_fn(int family, int d1, int d2, int normalize) {
  if (family == FAMILY_SPRITES && d1 == 8 && d2 == 16)
    return normalize ? (const void*)build_k_kernel<FAMILY_SPRITES, 8, 16, 1>
                     : (const void*)build_k_kernel<FAMILY_SPRITES, 8, 16, 0>;
  if (family == FAMILY_MNIST && d1 == 1 && d2 == 8)
    return normalize ? (const void*)build_k_kernel<FAMILY_MNIST, 1, 8, 1>
                     : (const void*)build_k_kernel<FAMILY_MNIST, 1, 8, 0>;
  return (const void*)build_k_kernel<-1, 0, 0, -1>;
}

struct Plan {
  int n_chunks;  // 0: single launch, no workspace
  int rows_per_chunk;
  int tile;
  int build_blocks;  // B3's K-build grid (a grid-stride loop)
};

// The kernel, grid, threads and shared memory that a plan launches (the
// reduce, when there are chunks, comes after it).
struct Kernel {
  const void* fn;
  dim3 grid;
  int threads;
  size_t smem;
};

Kernel plan_kernel(const Plan& plan, int m, int L) {
  const unsigned chunks = plan.n_chunks > 0 ? plan.n_chunks : 1;
  if (uses_small(m))
    return {(const void*)stats_small_kernel, dim3(L, chunks),
            small_groups(m) * small_tiles(m), small_smem_bytes(plan.tile, m)};
  const TriangleGrid tg = triangle_grid(m);
  return {(const void*)stats_partial_kernel,
          dim3(chunks, (L + CHANNELS_PER_BLOCK - 1) / CHANNELS_PER_BLOCK,
               tg.slices),
          tg.threads, partial_smem_bytes(plan.tile, m)};
}

// What a launch of this shape looks like on the current device; sets each
// kernel's dynamic shared-memory limit to the device's opt-in maximum.
int make_plan(int n, int m, int L, Plan* plan) {
  if (n < 1 || m < 1 || L < 1) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  for (const void* fn :
       {(const void*)stats_partial_kernel, (const void*)stats_small_kernel,
        build_fn(FAMILY_SPRITES, 8, 16, 0), build_fn(FAMILY_SPRITES, 8, 16, 1),
        build_fn(FAMILY_MNIST, 1, 8, 0), build_fn(FAMILY_MNIST, 1, 8, 1),
        (const void*)build_k_kernel<-1, 0, 0, -1>}) {
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  }
  if (e != cudaSuccess) return (int)e;
  const int build_blocks = BUILD_BLOCKS_PER_SM * sms;

  if (uses_small(m)) {
    // one block per (channel, chunk) of at least SMALL_CHUNK_ROWS rows, at
    // most one wave; one chunk is the single launch
    int tile = SMALL_TILE_N;
    while (tile > MIN_TILE_N && small_smem_bytes(tile, m) > (size_t)optin)
      tile /= 2;
    const Kernel k = plan_kernel({0, n, tile, build_blocks}, m, L);
    if (k.smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    int resident = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, k.fn,
                                                      k.threads, k.smem);
    if (e != cudaSuccess) return (int)e;
    long long chunks = ((long long)n + SMALL_CHUNK_ROWS - 1) / SMALL_CHUNK_ROWS;
    const long long wave = (long long)resident * sms / L;
    if (chunks > wave) chunks = wave;
    if (chunks <= 1) {
      *plan = {0, n, tile, build_blocks};
      return 0;
    }
    const long long rows = ((n + chunks - 1) / chunks + 3) / 4 * 4;
    *plan = {(int)((n + rows - 1) / rows), (int)rows, tile, build_blocks};
    return 0;
  }

  int tile = TILE_N;
  while (tile > MIN_TILE_N && partial_smem_bytes(tile, m) > (size_t)optin)
    tile /= 2;
  const Kernel k = plan_kernel({1, n, tile, build_blocks}, m, L);
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
  *plan = {(int)((n + rows - 1) / rows), (int)rows, tile, build_blocks};
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

// (Sigma, r) from K_nm in device memory: the plan's kernel, then the
// reduce when it has chunks.
int launch_stats(const float* knm, const float* prec, const float* py,
                 float* sigma, float* r, float* ws_sigma, float* ws_r, int n,
                 int m, int L, const Plan& plan, cudaStream_t stream) {
  if (!valid_plan(plan, n, m, L) ||
      (!uses_small(m) &&
       (plan.n_chunks < 1 || plan.rows_per_chunk % plan.tile != 0)))
    return (int)cudaErrorInvalidValue;
  const bool single = plan.n_chunks == 0;
  const Kernel k = plan_kernel(plan, m, L);
  if (uses_small(m))
    stats_small_kernel<<<k.grid, k.threads, k.smem, stream>>>(
        knm, prec, py, single ? sigma : ws_sigma, single ? r : ws_r, n, m, L,
        plan.rows_per_chunk, plan.tile, single);
  else
    stats_partial_kernel<<<k.grid, k.threads, k.smem, stream>>>(
        knm, prec, py, ws_sigma, ws_r, n, m, L, plan.rows_per_chunk,
        plan.tile, partial_layout(plan.tile, m));
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
// rows_per_chunk, tile, build_blocks}: n_chunks = 0 is the single launch
// (no workspace); otherwise the caller sizes the partial-sum workspace as
// n_chunks x L x (m x m + m) floats.  build_blocks is the grid of B3's
// K-build pass.  B2 and B3 share the plan.
int svgp_stats_plan(int n, int m, int L, int* out) {
  Plan plan;
  const int status = make_plan(n, m, L, &plan);
  if (status != 0) return status;
  out[0] = plan.n_chunks;
  out[1] = plan.rows_per_chunk;
  out[2] = plan.tile;
  out[3] = plan.build_blocks;
  return 0;
}

// The kernels a shape's plan launches, on the current device: info =
// {single launch (1) or two passes (0), threads per block, dynamic shared
// memory bytes, registers per thread, resident blocks per SM, blocks in
// the grid, for two passes the reduce kernel's registers per thread and
// resident blocks per SM (0 otherwise), local-memory bytes per thread
// (spills), and for B3 (d1, d2 >= 1) the K-build kernel's registers,
// resident blocks per SM and local bytes, the worst over the kernels
// these widths may launch (0 for B2)}.
int svgp_stats_info(int n, int m, int L, int d1, int d2, int* info) {
  Plan plan;
  int status = make_plan(n, m, L, &plan);
  if (status != 0) return status;
  const Kernel k = plan_kernel(plan, m, L);
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
  info[8] = (int)attr.localSizeBytes;
  info[9] = info[10] = info[11] = 0;
  if (plan.n_chunks > 0) {
    e = cudaFuncGetAttributes(&attr, (const void*)stats_reduce_kernel);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &resident, (const void*)stats_reduce_kernel, REDUCE_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    info[6] = attr.numRegs;
    info[7] = resident;
  }
  if (d1 > 0 && d2 > 0) {
    info[10] = 1 << 30;
    for (int family : {FAMILY_MNIST, FAMILY_SPRITES})
      for (int normalize : {0, 1}) {
        const void* fn = build_fn(family, d1, d2, normalize);
        e = cudaFuncGetAttributes(&attr, fn);
        if (e == cudaSuccess)
          e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &resident, fn, BUILD_THREADS, build_smem_bytes(m, d1, d2));
        if (e != cudaSuccess) return (int)e;
        info[9] = attr.numRegs > info[9] ? attr.numRegs : info[9];
        info[10] = resident < info[10] ? resident : info[10];
        info[11] = (int)attr.localSizeBytes > info[11]
                       ? (int)attr.localSizeBytes : info[11];
      }
  }
  return 0;
}

// B2: K_nm (n, m) read from device memory.  plan from svgp_stats_plan;
// n_chunks = 0 takes no workspace (ws_sigma, ws_r may be null).
int svgp_gp_stats(const float* knm, const float* prec, const float* py,
                  float* sigma, float* r, float* ws_sigma, float* ws_r, int n,
                  int m, int L, const int* plan, void* stream) {
  return launch_stats(knm, prec, py, sigma, r, ws_sigma, ws_r, n, m, L,
                      {plan[0], plan[1], plan[2], plan[3]},
                      (cudaStream_t)stream);
}

// B3: K built from f1 (n, d1), f2 (n, d2), ip1 (m, d1), ip2 (m, d2) into
// the workspace knm (n, m), then B2 on it.  family: 0 = mnist (periodic
// over f1[:, 0] x linear over f2), 1 = sprites (linear x linear).
int svgp_fused_kernel_stats(const float* f1, const float* f2, const float* ip1,
                            const float* ip2, int d1, int d2, float amp,
                            float length_scale, int family, int normalize,
                            const float* prec, const float* py, float* sigma,
                            float* r, float* ws_sigma, float* ws_r, float* knm,
                            int n, int m, int L, const int* plan,
                            void* stream) {
  const Plan p = {plan[0], plan[1], plan[2], plan[3]};
  if (d1 < 1 || d2 < 1 || p.build_blocks < 1 ||
      (family != FAMILY_MNIST && family != FAMILY_SPRITES))
    return (int)cudaErrorInvalidValue;
  Features ft = {f1, f2, ip1, ip2, d1, d2, amp * amp,
                 1.f / (length_scale * length_scale), family, normalize != 0};
  void* args[] = {&ft, &knm, &n, &m};
  cudaError_t e = cudaLaunchKernel(build_fn(family, d1, d2, normalize),
                                   dim3(p.build_blocks), dim3(BUILD_THREADS),
                                   args, build_smem_bytes(m, d1, d2),
                                   (cudaStream_t)stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch_stats(knm, prec, py, sigma, r, ws_sigma, ws_r, n, m, L, p,
                      (cudaStream_t)stream);
}

}  // extern "C"
