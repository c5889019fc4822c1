// Fused GMM sweep for Hopper (sm_90a): distance block + running min +
// tile-local top-p in one pass over the points.
//
// Replaces the TPU kernels
//   src/repro/kernels/gmm_topb.py    gmm_topb_pallas          (_topb_kernel)
//   src/repro/kernels/gmm_update.py  gmm_update_select_pallas (_gmm_kernel)
// The second is the p = 1 instance of this source.
//
// What it computes, per row i of points X (n, d) against centers C (b, d):
//   dist_j  = metric transform of x_i . c_j (mode below)
//   out_i   = min(min_in_i, min_j dist_j)          -> min_out
//   field_i = mask_i ? out_i : -inf
// and, per tile of bn rows, the tile's top-p of the field as (value, global
// index) pairs, ordered by value descending with ties to the lower index
// (the order lax.top_k gives; p = 1 is the (max, first argmax)).  Rows past
// n enter the last tile as -inf with indices >= n, which the wrapper
// clamps.  The wrapper merges the tiles' winners.
//
// Bound on this card: bytes for b <= 8.  A sweep must read the points once
// (n*d*4 bytes) plus 9n bytes of per-row state (13n with the squared
// norms); its 2*n*d*b fp32 flops are 4 a byte at b = 8 against the card's
// 20 (67 TFLOP/s over 3.35 TB/s), and reach the ridge only near b = 32.
// No tensor cores: TF32 cannot meet the 3e-5 parity, and the FP64 ones
// would buy a rate the sweep does not need at the price of a conversion
// for every loaded element.  What the design does about the bound:
//   - the grid fills the card: a block sweeps a slab of 16 rows (a tile
//     holds bn / 16), so the MapReduce probe's 8,192-row sweeps launch 512
//     blocks (one block a tile gave 17-33 for 132 SMs); for b <= 8 a block
//     is 4 consumer warps of 4 rows x 8 centers and four blocks fit a
//     multiprocessor, so those 512 run in one wave (the same shape runs
//     the 237,662-row main shape at 79 % of its bytes bound on an H100);
//     above, 8 consumer warps of 2 rows x 32 centers, two blocks a
//     multiprocessor;
//   - each point row is read from device memory once a sweep for b <= 32:
//     one producer warp streams the slab's rows and the b centers, chunk
//     by chunk along d (kDC floats), into a ring of shared-memory stages
//     with TMA bulk copies (cp.async.bulk, one instruction a row chunk,
//     completed on an mbarrier by bytes), or with 4-byte cp.async copies
//     when d % 4 != 0 or the base is not 16-byte aligned; the consumer
//     warps each own rows of the slab and every center of the pass, so
//     one staged chunk serves all b centers, and keep their sums in
//     registers across the whole of d (per-lane partials, one warp
//     reduction at the end); the ring's full/empty mbarriers are the only
//     synchronization of the d loop, so the copies run ahead of the
//     arithmetic;
//   - one launch a sweep, no serial epilogue: a block ranks its 16 rows
//     (min(p, 16) winners, counted, no sort) into a slab scratch; the last
//     block of a tile to finish (a ticket a tile, reset by that block)
//     merges the tile's sorted slab lists in log2(slabs) rounds, each
//     entry placed by its rank in its pair (its position plus a binary
//     search in the partner list), cut at p; a tile whose slabs hold fewer
//     than p rows is filled with its pad rows, as one block of the whole
//     tile would have filled it;
//   - the squared norms (and, for cosine, the normalized points) are loop
//     invariants the engine computes once per run and passes in; the
//     ragged last slab and tile are masked here, so the caller never pads.
// Accumulation is fp32 on CUDA cores (no TF32): the kernel must match the
// plain version to 3e-5.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "sweep_common.cuh"

namespace {

constexpr int kRows = 16;       // rows a block sweeps (a slab)
constexpr int kDC = 128;        // floats of a row a stage holds
constexpr int kMaxStages = 8;
// ring bytes a block: two blocks (8 consumer warps) or four (4) fit the
// multiprocessor's 228 KB of shared memory beside their other arrays
constexpr size_t kRingBytes8 = 110592;
constexpr size_t kRingBytes4 = 49152;

struct Args {
  const float* X;
  const float* xsq;
  const float* C;
  const float* csq;
  const float* min_in;
  const uint8_t* mask;
  float* min_out;
  float* tile_val;
  int* tile_idx;
  float* slab_val;
  int* slab_idx;
  int* tickets;
  int n, d, b, p, bn, vec;
  int stages;      // ring stages
  int cslots;      // center rows a stage holds
  int ring_bytes;  // ring size (also holds the tile merge's candidates)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::
          "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned),
// completed on `bar` by its byte count
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 4-byte asynchronous copy; with `valid` false it writes a zero
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.async copies land
__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// the W consumer warps only (the producer may still be streaming)
template <int W>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(W * 32) : "memory");
}

__device__ __forceinline__ float fma4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Entries of the sorted (before-order) list (v, ix)[0, len) that come
// before (value, index): a binary search in steps of top, top/2, ..., 1,
// with `top` a power of two >= len.
__device__ __forceinline__ int count_before(const float* v, const int* ix,
                                            int len, int top, float value,
                                            int index) {
  int lo = 0;
  for (int step = top; step > 0; step >>= 1) {
    const int m = lo + step;
    if (m <= len && before(v[m - 1], ix[m - 1], value, index)) lo = m;
  }
  return lo;
}

// The block: W consumer warps and one producer warp over a slab of kRows
// rows.  Consumer warp w owns rows [w*RW, (w+1)*RW) (RW = kRows/W) and
// every center of the pass; a pass folds CPM centers, so that RW x CPM
// sums a lane fill the registers once: for b <= 8, 4 warps of 4 rows x 8
// centers (1 for b = 1), four blocks a multiprocessor, so a probe-sized
// sweep's 512 blocks run in one wave; above, 8 warps of 2 rows x 32
// centers, two blocks a multiprocessor, so one pass serves b <= 32.
template <int NC, int W>
struct Shape {
  static constexpr int kThreads = (W + 1) * 32;
  static constexpr int kRW = kRows / W;
  static constexpr int kCPM = NC == 1 ? 1 : (W == 4 ? 8 : 32);
  static constexpr int kMinBlocks = W == 4 ? 4 : 2;
};

template <int MODE, int NC, int W>
__global__ void __launch_bounds__(Shape<NC, W>::kThreads,
                                  Shape<NC, W>::kMinBlocks)
    gmm_sweep_kernel(const Args a) {
  constexpr int R = kRows;
  constexpr int T = Shape<NC, W>::kThreads;
  constexpr int RW = Shape<NC, W>::kRW;
  constexpr int CPM = Shape<NC, W>::kCPM;
  constexpr bool kNorms = (MODE == kSqEuclidean || MODE == kEuclidean);
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = a.stages;
  const int stage_floats = (R + a.cslots) * kDC;
  float* ring = reinterpret_cast<float*>(smem);
  float* dsm = reinterpret_cast<float*>(smem + a.ring_bytes);  // R x CPM
  float* rmin = dsm + R * CPM;                                  // R
  float* fval = rmin + R;                                       // R
  int* fid = reinterpret_cast<int*>(fval + R);                  // R
  uint64_t* full = reinterpret_cast<uint64_t*>(fid + R);        // S
  uint64_t* empty = full + S;                                   // S
  int* flag = reinterpret_cast<int*>(empty + S);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * R;
  const int rv = (int)min((long long)R, (long long)a.n - row0);  // >= 1
  const int nk = (a.d + kDC - 1) / kDC;
  const int nchunks = (a.b + CPM - 1) / CPM * nk;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], a.vec ? 1 : 32);
      mbar_init(&empty[s], W);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  if (tid < R) rmin[tid] = CUDART_INF_F;
  __syncthreads();

  if (warp == W) {
    // producer: chunk c of pass c / nk fills stage c % S
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % S;
      if (c >= S) mbar_wait(&empty[s], ((c / S) - 1) & 1);
      const int pass = c / nk, k0 = (c - pass * nk) * kDC;
      const int dc = min(kDC, a.d - k0);
      const int g0 = pass * CPM, bc = min(CPM, a.b - g0);
      float* xs = ring + (size_t)s * stage_floats;
      float* cs = xs + R * kDC;
      const int rows = rv + bc;
      if (a.vec) {
        if (lane == 0) mbar_arrive_tx(&full[s], (uint32_t)(rows * dc * 4));
        __syncwarp();
        for (int q = lane; q < rows; q += 32) {
          const float* src = q < rv ? a.X + (size_t)(row0 + q) * a.d + k0
                                    : a.C + (size_t)(g0 + q - rv) * a.d + k0;
          float* dst = q < rv ? xs + q * kDC : cs + (q - rv) * kDC;
          bulk_copy(dst, src, (uint32_t)(dc * 4), &full[s]);
        }
      } else {
        // element copies, the chunk's tail to a float4 filled with zeros
        const int w = (dc + 3) & ~3;
        for (int e = lane; e < rows * w; e += 32) {
          const int q = e / w, k = e - q * w;
          const float* src = q < rv ? a.X + (size_t)(row0 + q) * a.d
                                    : a.C + (size_t)(g0 + q - rv) * a.d;
          float* dst = (q < rv ? xs + q * kDC : cs + (q - rv) * kDC) + k;
          copy4(dst, src + k0 + min(k, dc - 1), k < dc);
        }
        copies_arrive(&full[s]);
      }
    }
  } else {
    // consumers: lane l takes float4 column l of each chunk
    float acc[RW][CPM];
    const int r0 = warp * RW;
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % S;
      const int pass = c / nk, kc = c - pass * nk;
      const int dc = min(kDC, a.d - kc * kDC);
      const int bc = min(CPM, a.b - pass * CPM);
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int j = 0; j < CPM; ++j) acc[i][j] = 0.f;
      }
      mbar_wait(&full[s], (c / S) & 1);
      const float* xs = ring + (size_t)s * stage_floats;
      const float* cs = xs + R * kDC;
      if (lane < ((dc + 3) >> 2)) {
#pragma unroll
        float4 xv[RW];
#pragma unroll
        for (int i = 0; i < RW; ++i)
          xv[i] = reinterpret_cast<const float4*>(xs + (r0 + i) * kDC)[lane];
        if (NC == 1) {
          const float4 cv = reinterpret_cast<const float4*>(cs)[lane];
#pragma unroll
          for (int i = 0; i < RW; ++i) acc[i][0] = fma4(xv[i], cv, acc[i][0]);
        } else {
#pragma unroll
          for (int g = 0; g < CPM / 8; ++g) {
            if (g * 8 < bc) {
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const float4 cv = reinterpret_cast<const float4*>(
                    cs + (g * 8 + j) * kDC)[lane];
#pragma unroll
                for (int i = 0; i < RW; ++i)
                  acc[i][g * 8 + j] = fma4(xv[i], cv, acc[i][g * 8 + j]);
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (kc == nk - 1) {
        // the pass's dot products, then each row folds the pass's centers
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int j = 0; j < CPM; ++j)
            if (j < bc) {
              const float v = warp_sum(acc[i][j]);
              if (lane == 0) dsm[(r0 + i) * CPM + j] = v;
            }
        consumers_sync<W>();
        if (tid < rv) {
          const float xs2 = kNorms ? a.xsq[row0 + tid] : 0.f;
          float best = rmin[tid];
          for (int j = 0; j < bc; ++j) {
            const float c2 = kNorms ? a.csq[pass * CPM + j] : 0.f;
            best = fminf(best, transform<MODE>(dsm[tid * CPM + j], xs2, c2));
          }
          rmin[tid] = best;
        }
        consumers_sync<W>();  // dsm is free for the next pass
      }
    }
  }
  __syncthreads();

  // the running min written back and the masked field of the slab
  const int L = min(a.p, R);
  if (tid < R) {
    const long long i = row0 + tid;
    float v = -CUDART_INF_F;
    if (tid < rv) {
      const float m = fminf(a.min_in[i], rmin[tid]);
      a.min_out[i] = m;
      if (a.mask[i]) v = m;
    }
    fval[tid] = v;
    fid[tid] = (int)i;
  }
  __syncthreads();
  // the slab's top-L in before order, each row placed by its rank
  if (tid < R) {
    const float v = fval[tid];
    const int id = fid[tid];
    int rank = 0;
    for (int r = 0; r < R; ++r) rank += before(fval[r], fid[r], v, id);
    if (rank < L) {
      a.slab_val[(size_t)blockIdx.x * L + rank] = v;
      a.slab_idx[(size_t)blockIdx.x * L + rank] = id;
    }
    __threadfence();  // the winners are visible before the ticket
  }
  __syncthreads();

  // the last block of the tile to finish merges the tile's slabs
  const int per = a.bn / R;
  const int tile = (int)(row0 / a.bn);
  const int first = tile * per;
  const int nslab = min(per, (int)gridDim.x - first);
  if (tid == 0) *flag = atomicAdd(&a.tickets[tile], 1) == nslab - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // two buffers of per * L entries: the slab lists, then rounds that merge
  // neighbouring lists pairwise (each entry placed by its rank: its
  // position plus the partner list's entries before it), cut at p
  const int M = nslab * L, cap = per * L;
  float* sv = ring;
  int* si = reinterpret_cast<int*>(sv + cap);
  float* dv = reinterpret_cast<float*>(si + cap);
  int* di = reinterpret_cast<int*>(dv + cap);
  for (int e = tid; e < M; e += T) {
    sv[e] = __ldcg(a.slab_val + (size_t)first * L + e);
    si[e] = __ldcg(a.slab_idx + (size_t)first * L + e);
  }
  if (tid == 0) a.tickets[tile] = 0;
  __syncthreads();
  int lists = nslab, span = 1, width = L;
  while (lists > 1) {
    const int merged = min(2 * width, a.p);
    int top = 1;
    while (top < width) top <<= 1;
    for (int e = tid; e < lists * width; e += T) {
      const int li = e / width, pos = e - li * width;
      if (pos >= min(width, L * (nslab - li * span))) continue;
      const int pi = li ^ 1;
      int rank = pos;
      if (pi < lists)
        rank += count_before(sv + pi * width, si + pi * width,
                             min(width, L * (nslab - pi * span)), top, sv[e],
                             si[e]);
      if (rank < merged) {
        dv[(li >> 1) * merged + rank] = sv[e];
        di[(li >> 1) * merged + rank] = si[e];
      }
    }
    __syncthreads();
    float* tv_ = sv;
    sv = dv;
    dv = tv_;
    int* ti_ = si;
    si = di;
    di = ti_;
    lists = (lists + 1) >> 1;
    span <<= 1;
    width = merged;
  }
  float* tv = a.tile_val + (size_t)tile * a.p;
  int* ti = a.tile_idx + (size_t)tile * a.p;
  const long long tile0 = (long long)tile * a.bn;
  for (int r = tid; r < a.p; r += T) {
    if (r < M) {
      tv[r] = sv[r];
      ti[r] = si[r];
    } else {
      // a tile whose slabs hold fewer than p rows: its pad rows, in order
      tv[r] = -CUDART_INF_F;
      ti[r] = (int)(tile0 + r);
    }
  }
}

template <int MODE, int NC, int W>
cudaError_t launch(const Args& a, int blocks, size_t smem,
                   cudaStream_t stream) {
  auto kern = gmm_sweep_kernel<MODE, NC, W>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<blocks, Shape<NC, W>::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(const Args& a, int blocks, size_t smem,
                        cudaStream_t st) {
  if (a.b == 1) return launch<MODE, 1, 4>(a, blocks, smem, st);
  if (a.b <= 8) return launch<MODE, 8, 4>(a, blocks, smem, st);
  return launch<MODE, 8, 8>(a, blocks, smem, st);
}

}  // namespace

extern "C" {

// One sweep.  Pointers are device pointers; xsq and csq may be null for the
// dot and cosine modes.  tile_val/tile_idx hold ceil(n / bn) * p entries,
// slab_val/slab_idx ceil(n / rows) * min(p, rows), tickets ceil(n / bn)
// int32 entries that are zero (and are left zero).  rows is the slab the
// wrapper planned its scratch for and must be 16.  Returns the launch's
// cudaError_t (0 = launched).
int repro_gmm_sweep(const float* X, const float* xsq, const float* C,
                    const float* csq, const float* min_in, const uint8_t* mask,
                    float* min_out, float* tile_val, int* tile_idx,
                    float* slab_val, int* slab_idx, int* tickets, int n,
                    int d, int b, int p, int mode, int bn, int rows, int vec,
                    void* stream) {
  if (n <= 0 || d <= 0 || b <= 0 || p <= 0 || p > bn || rows != kRows ||
      bn % kRows != 0)
    return (int)cudaErrorInvalidValue;
  const bool narrow = b <= 8;  // 4 consumer warps, else 8
  const int cpm = b == 1 ? 1 : (narrow ? 8 : 32);
  const int cslots = b == 1 ? 1 : std::min(cpm, (b + 7) / 8 * 8);
  const size_t stage = (size_t)(kRows + cslots) * kDC * sizeof(float);
  const size_t budget = narrow ? kRingBytes4 : kRingBytes8;
  const int stages =
      (int)std::max<size_t>(3, std::min<size_t>(kMaxStages, budget / stage));
  // the tile merge's two buffers of (bn / rows) * min(p, rows) pairs
  size_t ring = std::max<size_t>(
      stages * stage,
      (size_t)(bn / kRows) * std::min(p, kRows) * 4 * sizeof(float));
  ring = (ring + 15) / 16 * 16;
  const size_t smem = ring +
                      (size_t)(kRows * cpm + 3 * kRows) * sizeof(float) +
                      2 * stages * sizeof(uint64_t) + 16;
  Args a{X,        xsq,      C,       csq, min_in, mask, min_out, tile_val,
         tile_idx, slab_val, slab_idx, tickets, n,  d,      b,
         p,        bn,       vec,     stages, cslots, (int)ring};
  const int blocks = (int)(((long long)n + kRows - 1) / kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kSqEuclidean:
      return (int)launch_mode<kSqEuclidean>(a, blocks, smem, st);
    case kEuclidean:
      return (int)launch_mode<kEuclidean>(a, blocks, smem, st);
    case kDot:
      return (int)launch_mode<kDot>(a, blocks, smem, st);
    case kCosine:
      return (int)launch_mode<kCosine>(a, blocks, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
