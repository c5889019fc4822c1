// Grouped GMM sweep for Hopper (sm_90a): the constrained (matroid) engine's
// round — own-group distance block + running min + per-group tile top-p in
// one pass over the points.
//
// Replaces the TPU kernel
//   src/repro/kernels/gmm_update.py  gmm_grouped_topb_pallas
//                                    (_grouped_topb_kernel)
//
// What it computes, per row i of points X (n, d) with label g = labels_i
// against centers C (m, bc, d) — bc centers per group:
//   own_i   = min over j < bc of the metric transform of x_i . c[g, j]
//             (+inf when g is outside [0, m), e.g. the -1 of an invalid row)
//   out_i   = min(min_in_i, own_i)                        -> min_out
// and, per tile of BN rows and per group g, the tile's top-p of
// {out_i : labels_i = g} as (value, global index) pairs, ordered by value
// descending with ties to the lower index (the order lax.top_k gives).  A
// group with fewer than p rows in the tile fills its tail with -inf entries
// whose index is the tile's first row, so every index lies in [0, n).  The
// wrapper merges each group's tile winners.
//
// What differs from the TPU kernel: that one does one (bn, d) x (m*bc, d)
// product per tile for all m groups and masks away all but each row's own
// group.  Here each row meets only its own group's bc centers, so a sweep
// does 2*n*bc*d operations, not m times that.
//
// Arithmetic shared with the plain version (kernels/ref.py
// grouped_dist_ref, the B3 contract), so the two agree bit for bit and the
// engine decides the same on both paths (a run makes thousands of argmax
// decisions among near-equal distances; summed in two different fp32
// orders, one of them flips and the runs part): every dot product is
// accumulated in float64 from exact fp32 products and rounded once to
// float32, and the epilogue is one correctly rounded fp32 operation at a
// time.  float64 sums in any order round to the same float32 unless the
// exact sum lies within ~1e-16 of a rounding boundary.
//
// Bound: bytes.  A sweep must read the points once, n*d*4 bytes (4.75 GB
// at the musiXmatch shape, 1.42 ms at 3.35 TB/s), plus 12n bytes of row
// state and the squared norms in the euclidean modes; the own-group
// products, 2*n*bc*d operations in float64, take 0.28 ms on the FP64
// tensor cores.  The design:
//   - the wrapper converts the centers to float64 once per sweep, into a
//     (m, bc, dp) scratch zero-padded to dp = d rounded up to 16 (5.1 MB at
//     m = 16, bc = 8, d = 5,000, L2-resident); lanes whose center lies
//     past bc read nothing and take zeros;
//   - each tile buckets its rows by group (a counting sort in shared
//     memory), and a warp takes up to 32 rows of one group at a time: its
//     task is a (32 x d) . (d x 8) product on the FP64 tensor cores
//     (mma16x8x4, dmma.cuh), so every center value the warp reads serves
//     all 32 rows, and the per-row, per-center float64 sums stay in the
//     accumulator fragments over the whole of d, with no reduction across
//     lanes and no barrier until the task ends;
//   - each point value is loaded once (16-byte loads, three 16-value blocks
//     of 32 rows in flight a warp, 16 warps an SM) and converted to float64
//     once, for all 8 centers of a block (bc > 8 takes one pass per block
//     of 8);
//   - the per-group top-p is one bitonic sort of the tile's (group, value,
//     index) keys, group first; each group's run then starts at a position
//     found by binary search;
//   - the ragged last tile is masked here, so the caller never pads.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "dmma.cuh"
#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTaskRows = 32;            // rows of one group a warp takes
constexpr int kLaneRows = kTaskRows / 8;  // rows a lane loads
constexpr int kFrags = kTaskRows / 16;    // accumulator fragments a warp
constexpr int kBlocks = 3;                // 16-value blocks in flight
constexpr int kNoGroup = 0x7fffffff;   // group key of a row in no group

// The metric transform of a float32 dot product, one correctly rounded
// operation at a time: torch's order for (xs + cs) - 2 * dot, clamp at 0,
// sqrt; arccos of the clamped cosine.
template <int MODE>
__device__ __forceinline__ float transform_rn(float dot, float xs, float cs) {
  if (MODE == kSqEuclidean || MODE == kEuclidean) {
    const float d2 = fmaxf(__fsub_rn(__fadd_rn(xs, cs), __fmul_rn(2.0f, dot)),
                           0.0f);
    return MODE == kEuclidean ? __fsqrt_rn(d2) : d2;
  } else if (MODE == kDot) {
    return -dot;
  } else {
    return acosf(fminf(fmaxf(dot, -1.0f), 1.0f));
  }
}

// the tile order: group ascending, then the top-p order within a group
__device__ __forceinline__ bool precedes(int ga, float va, int ia, int gb,
                                         float vb, int ib) {
  return ga < gb || (ga == gb && before(va, ia, vb, ib));
}

// Four values of a row from column k on (zeros past d or for a missing
// row).  VEC: one 16-byte load (d % 4 == 0, 16-byte aligned rows).
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int k,
                                        int d) {
  if (row == nullptr || k >= d) return make_float4(0.f, 0.f, 0.f, 0.f);
  if (VEC) return __ldg(reinterpret_cast<const float4*>(row + k));
  float4 v;
  v.x = __ldg(row + k);
  v.y = k + 1 < d ? __ldg(row + k + 1) : 0.f;
  v.z = k + 2 < d ? __ldg(row + k + 2) : 0.f;
  v.w = k + 3 < d ? __ldg(row + k + 3) : 0.f;
  return v;
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// One 16-value block of d: the four tensor-core steps of a task.  Lane
// (g, t) holds columns k + 4t .. k + 4t + 3 of rows g, g + 8, g + 16, ...
// (x) and of center g (c); step j takes column k + 4t + j of both, so every
// product pairs a row value with the center value of its column.
__device__ __forceinline__ void task_block(double (&acc)[kFrags][4],
                                           const float4 (&x)[kLaneRows],
                                           const double (&c)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int f = 0; f < kFrags; ++f) {
      const double a[2] = {(double)lane_of(x[2 * f], j),
                           (double)lane_of(x[2 * f + 1], j)};
      mma16x8x4(acc[f], a, c[j]);
    }
  }
}

// Four float64 values of a center from column k on (zeros for a center
// past bc: it is never read).
__device__ __forceinline__ void load_c4(double (&c)[4],
                                        const double* __restrict__ cp, int k) {
  if (cp == nullptr) {
    c[0] = c[1] = c[2] = c[3] = 0.0;
    return;
  }
  const double2 lo = __ldg(reinterpret_cast<const double2*>(cp + k));
  const double2 hi = __ldg(reinterpret_cast<const double2*>(cp + k + 2));
  c[0] = lo.x;
  c[1] = lo.y;
  c[2] = hi.x;
  c[3] = hi.y;
}

template <int BN>
size_t smem_bytes(int m) {
  return (size_t)BN * 4 * sizeof(int) + (size_t)(3 * m + 2) * sizeof(int);
}

template <int MODE, int BN, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
grouped_sweep_kernel(const float* __restrict__ X,
                     const float* __restrict__ xsq,
                     const double* __restrict__ C64,
                     const float* __restrict__ csq,
                     const float* __restrict__ min_in,
                     const int* __restrict__ labels,
                     float* __restrict__ min_out, float* __restrict__ tile_val,
                     int* __restrict__ tile_idx, int n, int d, int m, int bc,
                     int dp, int p) {
  constexpr bool kNorms = (MODE == kSqEuclidean || MODE == kEuclidean);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* key = reinterpret_cast<float*>(smem_raw);  // BN
  int* kid = reinterpret_cast<int*>(key + BN);      // BN
  int* klab = kid + BN;                             // BN
  int* order = klab + BN;                           // BN: rows by group
  int* cnt = order + BN;                            // m: rows of each group
  int* off = cnt + m;                               // m + 1: bucket starts
  int* first = off + m + 1;                         // m + 1: first task
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t = lane & 3;
  const long long tile0 = (long long)blockIdx.x * BN;

  // klab[r]: the row's group, kNoGroup for a label outside [0, m) and for
  // the rows past n of the ragged last tile; key[r]: the own-group min
  for (int g = tid; g < m; g += kThreads) cnt[g] = 0;
  __syncthreads();
  for (int r = tid; r < BN; r += kThreads) {
    const long long i = tile0 + r;
    const int g = i < n ? labels[i] : -1;
    const bool mine = g >= 0 && g < m;
    klab[r] = mine ? g : kNoGroup;
    key[r] = CUDART_INF_F;
    if (mine) atomicAdd(&cnt[g], 1);
  }
  __syncthreads();
  if (tid == 0) {  // bucket starts and each group's first task
    int o = 0, f = 0;
    for (int g = 0; g < m; ++g) {
      off[g] = o;
      first[g] = f;
      o += cnt[g];
      f += (cnt[g] + kTaskRows - 1) / kTaskRows;
      cnt[g] = 0;  // becomes the fill cursor
    }
    off[m] = o;
    first[m] = f;
  }
  __syncthreads();
  // the bucket order within a group is the atomics' order: a row's sums do
  // not depend on the rows it shares a task with
  for (int r = tid; r < BN; r += kThreads) {
    const int g = klab[r];
    if (g != kNoGroup) order[off[g] + atomicAdd(&cnt[g], 1)] = r;
  }
  __syncthreads();

  const int tasks = first[m];
  for (int task = warp; task < tasks; task += kWarps) {
    int lo = 0, hi = m - 1;  // the group whose tasks hold this one
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (first[mid] <= task) lo = mid;
      else hi = mid - 1;
    }
    const int g = lo;
    const int base = off[g] + (task - first[g]) * kTaskRows;
    const int len = min(kTaskRows, off[g + 1] - base);
    const float* rp[kLaneRows];  // rows g8, g8 + 8, ... of the task
#pragma unroll
    for (int f = 0; f < kLaneRows; ++f) {
      const int slot = g8 + 8 * f;
      rp[f] = slot < len ? X + (tile0 + order[base + slot]) * (long long)d
                         : nullptr;
    }
    for (int cb = 0; cb < bc; cb += 8) {
      const double* cp = cb + g8 < bc
                              ? C64 + ((size_t)g * bc + cb + g8) * dp + 4 * t
                              : nullptr;
      double acc[kFrags][4];
#pragma unroll
      for (int f = 0; f < kFrags; ++f)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[f][v] = 0.0;
      int k = 0;
      for (; k + 16 * (kBlocks - 1) < d; k += 16 * kBlocks) {
        float4 x[kBlocks][kLaneRows];  // every load of the step in flight
        double c[kBlocks][4];
#pragma unroll
        for (int u = 0; u < kBlocks; ++u) {
#pragma unroll
          for (int f = 0; f < kLaneRows; ++f)
            x[u][f] = load4<VEC>(rp[f], k + 16 * u + 4 * t, d);
          load_c4(c[u], cp, k + 16 * u);
        }
#pragma unroll
        for (int u = 0; u < kBlocks; ++u) task_block(acc, x[u], c[u]);
      }
      for (; k < d; k += 16) {
        float4 x[kLaneRows];
        double c[4];
#pragma unroll
        for (int f = 0; f < kLaneRows; ++f)
          x[f] = load4<VEC>(rp[f], k + 4 * t, d);
        load_c4(c, cp, k);
        task_block(acc, x, c);
      }
      // acc[f][2h + e]: row slot g8 + 8h + 16f, center cb + 2t + e
#pragma unroll
      for (int f = 0; f < kFrags; ++f) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int slot = g8 + 8 * h + 16 * f;
          const int r = slot < len ? order[base + slot] : -1;
          float best = CUDART_INF_F;
          if (r >= 0) {
            const float xs = kNorms ? xsq[tile0 + r] : 0.f;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = cb + 2 * t + e;
              if (c < bc) {
                const float c2 = kNorms ? csq[g * bc + c] : 0.f;
                best = fminf(best, transform_rn<MODE>(
                                       __double2float_rn(acc[f][2 * h + e]),
                                       xs, c2));
              }
            }
          }
          best = fminf(best, __shfl_xor_sync(0xffffffffu, best, 1));
          best = fminf(best, __shfl_xor_sync(0xffffffffu, best, 2));
          if (t == 0 && r >= 0) key[r] = fminf(key[r], best);
        }
      }
    }
  }
  __syncthreads();

  // running-min write-back (a row in no group keeps min_in) and the field
  for (int r = tid; r < BN; r += kThreads) {
    const long long i = tile0 + r;
    float v = -CUDART_INF_F;
    if (i < n) {
      const float mo = fminf(min_in[i], key[r]);
      min_out[i] = mo;
      v = mo;
    }
    key[r] = v;
    kid[r] = (int)i;
  }
  __syncthreads();

  // bitonic sort of the tile's (group, value, index) keys
  for (int k = 2; k <= BN; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < BN; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const float vi = key[i], vj = key[ixj];
          const int ii = kid[i], ij = kid[ixj];
          const int gi = klab[i], gj = klab[ixj];
          const bool fwd = (i & k) == 0;
          if (fwd ? precedes(gj, vj, ij, gi, vi, ii)
                  : precedes(gi, vi, ii, gj, vj, ij)) {
            key[i] = vj;
            key[ixj] = vi;
            kid[i] = ij;
            kid[ixj] = ii;
            klab[i] = gj;
            klab[ixj] = gi;
          }
        }
      }
      __syncthreads();
    }
  }

  // group g's winners are the first min(p, rows of g) entries of its run;
  // the rest of its p slots are -inf at the tile's first row
  for (int e = tid; e < m * p; e += kThreads) {
    const int g = e / p, j = e - g * p;
    int lo = 0, hi = BN;  // first position whose group is >= g
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (klab[mid] < g) lo = mid + 1;
      else hi = mid;
    }
    const int pos = lo + j;
    float v = -CUDART_INF_F;
    int ix = (int)tile0;
    if (pos < BN && klab[pos] == g) {
      v = key[pos];
      ix = kid[pos];
    }
    const size_t o = ((size_t)g * gridDim.x + blockIdx.x) * p + j;
    tile_val[o] = v;
    tile_idx[o] = ix;
  }
}

template <int MODE, int BN>
cudaError_t launch(const float* X, const float* xsq, const double* C64,
                   const float* csq, const float* min_in, const int* labels,
                   float* min_out, float* tile_val, int* tile_idx, int n,
                   int d, int m, int bc, int p, bool vec,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<BN>(m);
  auto kern = vec ? grouped_sweep_kernel<MODE, BN, true>
                  : grouped_sweep_kernel<MODE, BN, false>;
  static size_t sized[2] = {0, 0};  // the largest shared memory allowed yet
  if (smem > sized[vec]) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    sized[vec] = smem;
  }
  const int tiles = (int)(((long long)n + BN - 1) / BN);
  const int dp = (d + 15) / 16 * 16;
  kern<<<tiles, kThreads, smem, stream>>>(X, xsq, C64, csq, min_in, labels,
                                          min_out, tile_val, tile_idx, n, d,
                                          m, bc, dp, p);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(const float* X, const float* xsq, const double* C64,
                        const float* csq, const float* min_in,
                        const int* labels, float* min_out, float* tile_val,
                        int* tile_idx, int n, int d, int m, int bc, int p,
                        int bn, bool vec, cudaStream_t st) {
#define REPRO_ARGS                                                            \
  X, xsq, C64, csq, min_in, labels, min_out, tile_val, tile_idx, n, d, m, bc, \
      p, vec, st
  switch (bn) {
    case 1024: return launch<MODE, 1024>(REPRO_ARGS);
    case 2048: return launch<MODE, 2048>(REPRO_ARGS);
    case 4096: return launch<MODE, 4096>(REPRO_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_ARGS
}

}  // namespace

extern "C" {

// One grouped sweep.  Pointers are device pointers; xsq and csq may be null
// for the dot and cosine modes.  C64 holds the centers in float64, zero
// padded to (m, bc, dp) with dp = d rounded up to 16; csq the m*bc squared
// norms of the fp32 centers.  tile_val /
// tile_idx hold m * ceil(n / bn) * p entries (group-major, then tile, then
// rank).  vec = 1 when d % 4 == 0 and X is 16-byte aligned.  Returns the
// launch's cudaError_t (0 = launched).
int repro_grouped_sweep(const float* X, const float* xsq, const double* C64,
                        const float* csq, const float* min_in,
                        const int* labels, float* min_out, float* tile_val,
                        int* tile_idx, int n, int d, int m, int bc, int p,
                        int mode, int bn, int vec, void* stream) {
  if (n <= 0 || d <= 0 || m <= 0 || bc <= 0 || p <= 0 || p > bn)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_ARGS                                                            \
  X, xsq, C64, csq, min_in, labels, min_out, tile_val, tile_idx, n, d, m, bc, \
      p, bn, vec != 0, st
  switch (mode) {
    case kSqEuclidean: return (int)launch_mode<kSqEuclidean>(REPRO_ARGS);
    case kEuclidean: return (int)launch_mode<kEuclidean>(REPRO_ARGS);
    case kDot: return (int)launch_mode<kDot>(REPRO_ARGS);
    case kCosine: return (int)launch_mode<kCosine>(REPRO_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_ARGS
}

}  // extern "C"
