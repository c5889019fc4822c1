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
// group, because products are cheap on the MXU.  On CUDA cores they are
// not: at m = 16 the full product is 16x the own-group work.  Here each
// row meets only its own group's bc centers, so a sweep does 2*n*bc*d flops,
// as the ungrouped sweep (gmm_sweep.cu) does.
//
// Arithmetic shared with the plain version, so the two agree bit for bit
// and the engine decides the same on both paths (a run makes thousands of
// argmax decisions among near-equal distances; summed in two different
// fp32 orders, one of them flips and the runs part): every dot product is
// accumulated in float64 and rounded once to float32, and the epilogue is
// one correctly rounded fp32 operation at a time (no contraction into
// FMA), as torch evaluates ref.gmm_grouped_topb_ref.  float64 sums in any
// order round to the same float32 unless the exact sum lies within ~1e-16
// of a rounding boundary.
//
// Bound: bytes.  A sweep must read the points once, n*d*4 bytes, plus 12n
// bytes of row state (min_in and label read, min_out written) and the
// squared norms in the euclidean modes; the own-group arithmetic, 2*n*bc*d
// operations in float64, is below the fp64 rate for the engine's blocks
// (bc <= 8).  The design:
//   - one warp takes two rows at a time, lanes striding over d with 16-byte
//     loads (four in flight per lane) when d % 4 == 0 — the loop of
//     gmm_sweep.cu, except that each row of the pair meets its own group's
//     centers;
//   - where all m groups' centers of a d-chunk fit in 128 KB of shared
//     memory (m * min(bc, 8) <= 128 at a 256-float chunk) they are staged
//     there and the rows meet them in shared memory (STAGED); otherwise each
//     row reads its own block from device memory with __ldg, where the
//     m*bc*d*4 bytes of centers stay L2-resident;
//   - the per-group top-p is one bitonic sort of the tile's (group, value,
//     index) keys, group first; each group's run then starts at a position
//     found by binary search;
//   - the ragged last tile is masked here, so the caller never pads.
// No tensor cores (TF32 cannot meet the 3e-5 parity with the reference).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNB = 8;                // centers of a group folded per pass
constexpr int kSub = 512;             // rows whose partial dot products are held
constexpr int kStageFloats = 32768;   // 128 KB for the staged centers
constexpr int kNoGroup = 0x7fffffff;  // group key of a row in no group

template <bool STAGED>
__device__ __forceinline__ float4 load_c4(const float* c, int t) {
  const float4* c4 = reinterpret_cast<const float4*>(c);
  if (STAGED) return c4[t];
  return __ldg(c4 + t);
}

template <bool STAGED>
__device__ __forceinline__ float load_c(const float* c, int t) {
  if (STAGED) return c[t];
  return __ldg(c + t);
}

__device__ __forceinline__ double dot4d(float4 a, float4 b, double s) {
  s = fma((double)a.x, (double)b.x, s);
  s = fma((double)a.y, (double)b.y, s);
  s = fma((double)a.z, (double)b.z, s);
  return fma((double)a.w, (double)b.w, s);
}

__device__ __forceinline__ double warp_sum_d(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// Dot products of two rows (dc values each) with their own groups' first
// nb centers (ca, cb: each row's first center; centers cstride floats
// apart), accumulated in float64 and summed over the warp (every lane ends
// with the sums).
template <bool STAGED>
__device__ __forceinline__ void dot_rows_own(const float* __restrict__ xa,
                                             const float* __restrict__ xb,
                                             const float* ca, const float* cb,
                                             int cstride, int nb, int dc,
                                             int vec, int lane,
                                             double (&sa)[kNB],
                                             double (&sb)[kNB]) {
#pragma unroll
  for (int j = 0; j < kNB; ++j) sa[j] = sb[j] = 0.0;
  if (vec) {
    const float4* a4 = reinterpret_cast<const float4*>(xa);
    const float4* b4 = reinterpret_cast<const float4*>(xb);
    const int dc4 = dc >> 2;
    int t = lane;
    for (; t + 32 < dc4; t += 64) {
      const float4 a0 = __ldg(a4 + t), b0 = __ldg(b4 + t);
      const float4 a1 = __ldg(a4 + t + 32), b1 = __ldg(b4 + t + 32);
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        if (j < nb) {
          const float* cj = ca + j * cstride;
          const float* dj = cb + j * cstride;
          sa[j] = dot4d(a1, load_c4<STAGED>(cj, t + 32),
                        dot4d(a0, load_c4<STAGED>(cj, t), sa[j]));
          sb[j] = dot4d(b1, load_c4<STAGED>(dj, t + 32),
                        dot4d(b0, load_c4<STAGED>(dj, t), sb[j]));
        }
      }
    }
    if (t < dc4) {
      const float4 a0 = __ldg(a4 + t), b0 = __ldg(b4 + t);
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        if (j < nb) {
          sa[j] = dot4d(a0, load_c4<STAGED>(ca + j * cstride, t), sa[j]);
          sb[j] = dot4d(b0, load_c4<STAGED>(cb + j * cstride, t), sb[j]);
        }
      }
    }
  } else {
    for (int t = lane; t < dc; t += 32) {
      const float a = __ldg(xa + t), b = __ldg(xb + t);
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        if (j < nb) {
          sa[j] = fma((double)a, (double)load_c<STAGED>(ca + j * cstride, t),
                      sa[j]);
          sb[j] = fma((double)b, (double)load_c<STAGED>(cb + j * cstride, t),
                      sb[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    sa[j] = warp_sum_d(sa[j]);
    sb[j] = warp_sum_d(sb[j]);
  }
}

// the tile order: group ascending, then the top-p order within a group
__device__ __forceinline__ bool precedes(int ga, float va, int ia, int gb,
                                         float vb, int ib) {
  return ga < gb || (ga == gb && before(va, ia, vb, ib));
}

template <int BN>
__host__ __device__ constexpr int sub_rows() {
  return BN < kSub ? BN : kSub;
}

template <int BN>
size_t smem_bytes(bool staged, int m, int nbs, int dcs) {
  return (size_t)BN * (sizeof(float) + 2 * sizeof(int)) +
         (size_t)sub_rows<BN>() * kNB * sizeof(double) +
         (staged ? (size_t)m * nbs * dcs * sizeof(float) : 0);
}

template <int MODE, int BN, bool STAGED>
__global__ void __launch_bounds__(kThreads)
grouped_sweep_kernel(const float* __restrict__ X,
                     const float* __restrict__ xsq,
                     const float* __restrict__ C,
                     const float* __restrict__ csq,
                     const float* __restrict__ min_in,
                     const int* __restrict__ labels,
                     float* __restrict__ min_out, float* __restrict__ tile_val,
                     int* __restrict__ tile_idx, int n, int d, int m, int bc,
                     int p, int dcs, int vec) {
  constexpr int SUB = sub_rows<BN>();
  constexpr bool kNorms = (MODE == kSqEuclidean || MODE == kEuclidean);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* acc = reinterpret_cast<double*>(smem_raw);  // SUB * kNB
  float* key = reinterpret_cast<float*>(acc + SUB * kNB);  // BN
  int* kid = reinterpret_cast<int*>(key + BN);         // BN
  int* klab = kid + BN;                                // BN
  float* cs = reinterpret_cast<float*>(klab + BN);     // m * nbs * dcs
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long tile0 = (long long)blockIdx.x * BN;
  const int nbs = min(kNB, bc);

  // klab[r]: the row's group, kNoGroup for a label outside [0, m) and for
  // the rows past n of the ragged last tile; key[r]: the running min over
  // the center passes folded so far
  for (int r = tid; r < BN; r += kThreads) {
    const long long i = tile0 + r;
    const int g = i < n ? labels[i] : -1;
    klab[r] = (g >= 0 && g < m) ? g : kNoGroup;
    key[r] = CUDART_INF_F;
  }
  __syncthreads();

  for (int s0 = 0; s0 < BN; s0 += SUB) {
    const long long row0 = tile0 + s0;
    if (row0 >= n) break;  // block-uniform
    const int srows = (int)min((long long)SUB, (long long)n - row0);
    for (int g0 = 0; g0 < bc; g0 += kNB) {
      const int nb = min(kNB, bc - g0);
      __syncthreads();  // the previous fold has read acc
      for (int t = tid; t < SUB * kNB; t += kThreads) acc[t] = 0.0;
      __syncthreads();
      for (int k0 = 0; k0 < d; k0 += dcs) {
        const int dc = min(dcs, d - k0);
        if (STAGED) {
          // centers g0..g0+nb-1 of every group, d-chunk k0: one warp per
          // center row
          __syncthreads();  // every warp is done with the previous chunk
          for (int row = warp; row < m * nbs; row += kWarps) {
            const int g = row / nbs, j = row - g * nbs;
            if (j >= nb) continue;
            const float* src = C + (size_t)(g * bc + g0 + j) * d + k0;
            float* dst = cs + (size_t)row * dcs;
            if (vec) {
              for (int c = 4 * lane; c < dc; c += 128)
                *reinterpret_cast<float4*>(dst + c) =
                    __ldg(reinterpret_cast<const float4*>(src + c));
            } else {
              for (int c = lane; c < dc; c += 32) dst[c] = __ldg(src + c);
            }
          }
          __syncthreads();
        }
        // two rows per warp, each with its own group's centers; a lone last
        // row pairs with itself, and a row in no group borrows its
        // partner's block (its sums are never read)
        for (int r = 2 * warp; r < srows; r += 2 * kWarps) {
          const int rb = min(r + 1, srows - 1);
          const int la = klab[s0 + r], lb = klab[s0 + rb];
          if (la == kNoGroup && lb == kNoGroup) continue;  // warp-uniform
          const int ga = la == kNoGroup ? lb : la;
          const int gb = lb == kNoGroup ? la : lb;
          const float* ca;
          const float* cb;
          if (STAGED) {
            ca = cs + (size_t)ga * nbs * dcs;
            cb = cs + (size_t)gb * nbs * dcs;
          } else {
            ca = C + (size_t)(ga * bc + g0) * d + k0;
            cb = C + (size_t)(gb * bc + g0) * d + k0;
          }
          double sa[kNB], sb[kNB];
          dot_rows_own<STAGED>(X + (size_t)(row0 + r) * d + k0,
                               X + (size_t)(row0 + rb) * d + k0, ca, cb,
                               STAGED ? dcs : d, nb, dc, vec, lane, sa, sb);
          if (lane == 0) {
#pragma unroll
            for (int j = 0; j < kNB; ++j) acc[r * kNB + j] += sa[j];
            if (rb != r) {
#pragma unroll
              for (int j = 0; j < kNB; ++j) acc[rb * kNB + j] += sb[j];
            }
          }
        }
      }
      __syncthreads();
      for (int r = tid; r < srows; r += kThreads) {
        const int g = klab[s0 + r];
        if (g == kNoGroup) continue;
        const float xs = kNorms ? xsq[row0 + r] : 0.f;
        float best = key[s0 + r];
        for (int j = 0; j < nb; ++j) {
          const float c2 = kNorms ? csq[g * bc + g0 + j] : 0.f;
          best = fminf(best, transform_rn<MODE>((float)acc[r * kNB + j], xs,
                                                c2));
        }
        key[s0 + r] = best;
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
  for (int t = tid; t < m * p; t += kThreads) {
    const int g = t / p, j = t - g * p;
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

template <int MODE, int BN, bool STAGED>
cudaError_t launch(const float* X, const float* xsq, const float* C,
                   const float* csq, const float* min_in, const int* labels,
                   float* min_out, float* tile_val, int* tile_idx, int n,
                   int d, int m, int bc, int p, int dcs, int vec,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<BN>(STAGED, m, min(kNB, bc), dcs);
  auto kern = grouped_sweep_kernel<MODE, BN, STAGED>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int tiles = (int)(((long long)n + BN - 1) / BN);
  kern<<<tiles, kThreads, smem, stream>>>(X, xsq, C, csq, min_in, labels,
                                          min_out, tile_val, tile_idx, n, d,
                                          m, bc, p, dcs, vec);
  return cudaGetLastError();
}

template <int MODE, bool STAGED>
cudaError_t launch_tile(const float* X, const float* xsq, const float* C,
                        const float* csq, const float* min_in,
                        const int* labels, float* min_out, float* tile_val,
                        int* tile_idx, int n, int d, int m, int bc, int p,
                        int bn, int dcs, int vec, cudaStream_t st) {
#define REPRO_ARGS                                                          \
  X, xsq, C, csq, min_in, labels, min_out, tile_val, tile_idx, n, d, m, bc, \
      p, dcs, vec, st
  switch (bn) {
    case 1024: return launch<MODE, 1024, STAGED>(REPRO_ARGS);
    case 2048: return launch<MODE, 2048, STAGED>(REPRO_ARGS);
    case 4096: return launch<MODE, 4096, STAGED>(REPRO_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_ARGS
}

template <int MODE>
cudaError_t launch_mode(const float* X, const float* xsq, const float* C,
                        const float* csq, const float* min_in,
                        const int* labels, float* min_out, float* tile_val,
                        int* tile_idx, int n, int d, int m, int bc, int p,
                        int bn, int staged, int vec, cudaStream_t st) {
  if (!staged)
    return launch_tile<MODE, false>(X, xsq, C, csq, min_in, labels, min_out,
                                    tile_val, tile_idx, n, d, m, bc, p, bn, d,
                                    vec, st);
  // the widest staged d-chunk whose m * min(bc, 8) center rows fit
  const long long rows = (long long)m * min(kNB, bc);
  int dcs = 1024;
  while (dcs >= 256 && rows * dcs > kStageFloats) dcs >>= 1;
  if (dcs < 256) return cudaErrorInvalidValue;
  return launch_tile<MODE, true>(X, xsq, C, csq, min_in, labels, min_out,
                                 tile_val, tile_idx, n, d, m, bc, p, bn, dcs,
                                 vec, st);
}

}  // namespace

extern "C" {

// One grouped sweep.  Pointers are device pointers; xsq and csq may be null
// for the dot and cosine modes.  C holds m*bc center rows (group-major),
// tile_val/tile_idx hold m * ceil(n / bn) * p entries (group-major, then
// tile, then rank).  staged = 1 stages the centers in shared memory (needs
// m * min(bc, 8) <= 128), 0 reads them from device memory.  Returns the
// launch's cudaError_t (0 = launched).
int repro_grouped_sweep(const float* X, const float* xsq, const float* C,
                        const float* csq, const float* min_in,
                        const int* labels, float* min_out, float* tile_val,
                        int* tile_idx, int n, int d, int m, int bc, int p,
                        int mode, int bn, int staged, int vec, void* stream) {
  if (n <= 0 || d <= 0 || m <= 0 || bc <= 0 || p <= 0 || p > bn)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_ARGS                                                          \
  X, xsq, C, csq, min_in, labels, min_out, tile_val, tile_idx, n, d, m, bc, \
      p, bn, staged, vec, st
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
