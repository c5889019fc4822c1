// Fused GMM sweep for Hopper (sm_90a): distance block + running min +
// tile-local top-p in one pass over the points.
//
// Replaces the TPU kernels
//   src/repro/kernels/gmm_topb.py    gmm_topb_pallas          (_topb_kernel)
//   src/repro/kernels/gmm_update.py  gmm_update_select_pallas (_gmm_kernel)
// The second is the p = 1 instance of this source: a block (max, first
// argmax) reduction in place of the sort.
//
// What it computes, per row i of points X (n, d) against centers C (b, d):
//   dist_j  = metric transform of x_i . c_j (mode below)
//   out_i   = min(min_in_i, min_j dist_j)          -> min_out
//   field_i = mask_i ? out_i : -inf
// and, per tile of BN rows, the tile's top-p of the field as (value, global
// index) pairs, ordered by value descending with ties to the lower index
// (the order lax.top_k gives).  The wrapper merges the tiles' winners.
//
// Bound: bytes.  A sweep must read the points once, n*d*4 bytes, plus 9n
// bytes of per-row state (min_in and squared norm read, min_out written,
// mask read); the arithmetic, 2*n*d*b flops, is far below the fp32 CUDA-core
// rate for the b <= 32 blocks the engine folds.  The design follows from
// that:
//   - each point row is read from device memory once per group of kNB = 8
//     centers (once per sweep for the engine's blocks of b <= 8), by one
//     warp that takes two rows at a time, lanes striding over d with
//     16-byte loads (four in flight per lane) when d % 4 == 0;
//   - the b centers are staged in shared memory in d-chunks (kDC floats per
//     center), so the row stream meets them there and not in device memory;
//   - the squared norms (and, for cosine, the normalized points) are loop
//     invariants that the engine computes once per run and passes in;
//   - the ragged last tile is masked here, so the caller never pads (and
//     never copies) the point array;
//   - nothing of size (n, b) is written: the per-row partial dot products
//     live in shared memory for a 256-row sub-tile at a time.
// Accumulation is fp32 on CUDA cores (no TF32): the kernel must match the
// plain version to 3e-5.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNB = 8;      // centers folded per pass over a row
constexpr int kDC = 1024;   // d-chunk of the centers staged in shared memory
constexpr int kSub = 256;   // rows whose partial dot products are held

// Dot products of two rows (one d-chunk of dc values each) with the kNB
// centers staged in shared memory, summed over the warp (every lane ends
// with the sums).  The 16-byte path keeps four row loads in flight per
// lane; the scalar path serves d % 4 != 0.
__device__ __forceinline__ void dot_rows(const float* __restrict__ xa,
                                         const float* __restrict__ xb,
                                         const float* cs, int dc, int vec,
                                         int lane, float (&sa)[kNB],
                                         float (&sb)[kNB]) {
#pragma unroll
  for (int j = 0; j < kNB; ++j) sa[j] = sb[j] = 0.f;
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
        const float4* c4 = reinterpret_cast<const float4*>(cs + j * kDC);
        const float4 c0 = c4[t], c1 = c4[t + 32];
        sa[j] += dot4(a0, c0) + dot4(a1, c1);
        sb[j] += dot4(b0, c0) + dot4(b1, c1);
      }
    }
    if (t < dc4) {
      const float4 a0 = __ldg(a4 + t), b0 = __ldg(b4 + t);
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        const float4 c0 = reinterpret_cast<const float4*>(cs + j * kDC)[t];
        sa[j] += dot4(a0, c0);
        sb[j] += dot4(b0, c0);
      }
    }
  } else {
    for (int t = lane; t < dc; t += 32) {
      const float a = __ldg(xa + t), b = __ldg(xb + t);
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        sa[j] += a * cs[j * kDC + t];
        sb[j] += b * cs[j * kDC + t];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    sa[j] = warp_sum(sa[j]);
    sb[j] = warp_sum(sb[j]);
  }
}

template <int BN>
constexpr size_t smem_bytes() {
  return (size_t)(kNB * kDC + kSub * kNB + BN) * sizeof(float) +
         (size_t)BN * sizeof(int);
}

template <int MODE, int BN, bool TOPP>
__global__ void __launch_bounds__(kThreads)
gmm_sweep_kernel(const float* __restrict__ X, const float* __restrict__ xsq,
                 const float* __restrict__ C, const float* __restrict__ csq,
                 const float* __restrict__ min_in,
                 const uint8_t* __restrict__ mask, float* __restrict__ min_out,
                 float* __restrict__ tile_val, int* __restrict__ tile_idx,
                 int n, int d, int b, int p, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* cs = reinterpret_cast<float*>(smem_raw);  // kNB * kDC
  float* acc = cs + kNB * kDC;                      // kSub * kNB
  float* key = acc + kSub * kNB;                    // BN
  int* kid = reinterpret_cast<int*>(key + BN);      // BN
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long tile0 = (long long)blockIdx.x * BN;
  constexpr bool kNorms = (MODE == kSqEuclidean || MODE == kEuclidean);

  // key[r] holds the running min over the center groups folded so far
  for (int r = tid; r < BN; r += kThreads) key[r] = CUDART_INF_F;

  for (int s0 = 0; s0 < BN; s0 += kSub) {
    const long long row0 = tile0 + s0;
    if (row0 >= n) break;  // block-uniform
    const int srows = (int)min((long long)kSub, (long long)n - row0);
    for (int g0 = 0; g0 < b; g0 += kNB) {
      const int nb = min(kNB, b - g0);
      __syncthreads();  // the previous fold has read acc
      for (int t = tid; t < kSub * kNB; t += kThreads) acc[t] = 0.f;
      for (int k0 = 0; k0 < d; k0 += kDC) {
        const int dc = min(kDC, d - k0);
        __syncthreads();  // cs is free again; acc zeroing is visible
        for (int t = tid; t < kNB * kDC; t += kThreads) {
          const int j = t / kDC, c = t - j * kDC;
          cs[t] = (j < nb && c < dc) ? C[(size_t)(g0 + j) * d + k0 + c] : 0.f;
        }
        __syncthreads();
        // two rows per warp: every center value read from shared memory
        // serves both rows; a lone last row pairs with itself
        for (int r = 2 * warp; r < srows; r += 2 * kWarps) {
          const int rb = min(r + 1, srows - 1);
          float sa[kNB], sb[kNB];
          dot_rows(X + (size_t)(row0 + r) * d + k0,
                   X + (size_t)(row0 + rb) * d + k0, cs, dc, vec, lane, sa,
                   sb);
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
        const float xs = kNorms ? xsq[row0 + r] : 0.f;
        float best = key[s0 + r];
        for (int j = 0; j < nb; ++j) {
          const float c2 = kNorms ? csq[g0 + j] : 0.f;
          best = fminf(best, transform<MODE>(acc[r * kNB + j], xs, c2));
        }
        key[s0 + r] = best;
      }
    }
  }
  __syncthreads();

  // running-min write-back and the masked field; rows past n (the ragged
  // last tile) enter as -inf with indices >= n, which the wrapper clamps
  for (int r = tid; r < BN; r += kThreads) {
    const long long i = tile0 + r;
    float v = -CUDART_INF_F;
    if (i < n) {
      const float m = fminf(min_in[i], key[r]);
      min_out[i] = m;
      if (mask[i]) v = m;
    }
    key[r] = v;
    kid[r] = (int)i;
  }
  __syncthreads();

  if (TOPP) {
    // bitonic sort of the tile's (value, index) pairs into `before` order
    for (int k = 2; k <= BN; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < BN; i += kThreads) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const float vi = key[i], vj = key[ixj];
            const int ii = kid[i], ij = kid[ixj];
            const bool fwd = (i & k) == 0;
            if (fwd ? before(vj, ij, vi, ii) : before(vi, ii, vj, ij)) {
              key[i] = vj;
              key[ixj] = vi;
              kid[i] = ij;
              kid[ixj] = ii;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int t = tid; t < p; t += kThreads) {
      tile_val[(size_t)blockIdx.x * p + t] = key[t];
      tile_idx[(size_t)blockIdx.x * p + t] = kid[t];
    }
  } else {
    // p == 1: (max, first argmax) reduction
    float bv = -CUDART_INF_F;
    int bi = 0x7fffffff;
    for (int r = tid; r < BN; r += kThreads) {
      if (before(key[r], kid[r], bv, bi)) {
        bv = key[r];
        bi = kid[r];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (before(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    float* wv = acc;  // acc is free after the fold
    int* wi = reinterpret_cast<int*>(acc + kWarps);
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      bv = wv[0];
      bi = wi[0];
      for (int w = 1; w < kWarps; ++w) {
        if (before(wv[w], wi[w], bv, bi)) {
          bv = wv[w];
          bi = wi[w];
        }
      }
      tile_val[blockIdx.x] = bv;
      tile_idx[blockIdx.x] = bi;
    }
  }
}

template <int MODE, int BN, bool TOPP>
cudaError_t launch(const float* X, const float* xsq, const float* C,
                   const float* csq, const float* min_in, const uint8_t* mask,
                   float* min_out, float* tile_val, int* tile_idx, int n,
                   int d, int b, int p, int vec, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<BN>();
  auto kern = gmm_sweep_kernel<MODE, BN, TOPP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int tiles = (int)(((long long)n + BN - 1) / BN);
  kern<<<tiles, kThreads, smem, stream>>>(X, xsq, C, csq, min_in, mask,
                                          min_out, tile_val, tile_idx, n, d,
                                          b, p, vec);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(const float* X, const float* xsq, const float* C,
                        const float* csq, const float* min_in,
                        const uint8_t* mask, float* min_out, float* tile_val,
                        int* tile_idx, int n, int d, int b, int p, int bn,
                        int vec, cudaStream_t st) {
#define REPRO_ARGS \
  X, xsq, C, csq, min_in, mask, min_out, tile_val, tile_idx, n, d, b, p, vec, st
  if (p == 1 && bn == 256) return launch<MODE, 256, false>(REPRO_ARGS);
  switch (bn) {
    case 256: return launch<MODE, 256, true>(REPRO_ARGS);
    case 512: return launch<MODE, 512, true>(REPRO_ARGS);
    case 1024: return launch<MODE, 1024, true>(REPRO_ARGS);
    case 2048: return launch<MODE, 2048, true>(REPRO_ARGS);
    case 4096: return launch<MODE, 4096, true>(REPRO_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_ARGS
}

}  // namespace

extern "C" {

// One sweep.  Pointers are device pointers; xsq and csq may be null for the
// dot and cosine modes.  tile_val/tile_idx hold ceil(n / bn) * p entries.
// Returns the launch's cudaError_t (0 = launched).
int repro_gmm_sweep(const float* X, const float* xsq, const float* C,
                    const float* csq, const float* min_in, const uint8_t* mask,
                    float* min_out, float* tile_val, int* tile_idx, int n,
                    int d, int b, int p, int mode, int bn, int vec,
                    void* stream) {
  if (n <= 0 || d <= 0 || b <= 0 || p <= 0 || p > bn)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kSqEuclidean:
      return (int)launch_mode<kSqEuclidean>(X, xsq, C, csq, min_in, mask,
                                            min_out, tile_val, tile_idx, n, d,
                                            b, p, bn, vec, st);
    case kEuclidean:
      return (int)launch_mode<kEuclidean>(X, xsq, C, csq, min_in, mask,
                                          min_out, tile_val, tile_idx, n, d,
                                          b, p, bn, vec, st);
    case kDot:
      return (int)launch_mode<kDot>(X, xsq, C, csq, min_in, mask, min_out,
                                    tile_val, tile_idx, n, d, b, p, bn, vec,
                                    st);
    case kCosine:
      return (int)launch_mode<kCosine>(X, xsq, C, csq, min_in, mask, min_out,
                                       tile_val, tile_idx, n, d, b, p, bn,
                                       vec, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
