// Tiled pairwise distance for Hopper (sm_90a): out[i][j] = metric transform
// of x_i . y_j for X (m, d) and Y (n, d), written to device memory once.
//
// Replaces the TPU kernel
//   src/repro/kernels/pairwise.py  pairwise_pallas  (_pairwise_kernel)
//
// Per entry, in the reference's factorized form (repro/kernels/pairwise.py
// _transform):
//   sqeuclidean  max(xsq_i + ysq_j - 2 dot, 0)
//   euclidean    sqrt of that
//   dot          -dot
//   cosine       acos(clamp(dot, -1, 1))   (the wrapper normalizes the rows)
// The diagonal of a self-distance matrix is not zeroed: the factorized form
// leaves self-distances of rounding size there, as the reference does.
//
// Arithmetic: every dot product is accumulated in float64 from exact
// fp32 x fp32 products (24 + 24 bits fit float64's 53) on the FP64 tensor
// cores (mma.sync .f64, dmma.cuh) and rounded once to float32; the epilogue
// is one correctly rounded fp32 operation at a time (__fadd_rn, __fsub_rn:
// never contracted).  The plain version (kernels/ref.py pairwise_ref) is
// the float64 product rounded once, then the same epilogue in torch, and the
// grouped sweep (gmm_grouped.cu, B4) keeps the same contract.  Two float64
// sums in different orders round to the same float32 unless the exact sum
// lies within float64 rounding (~1e-16 relative) of an fp32 rounding
// boundary, so kernel and plain agree bit for bit but for such entries,
// which are one ulp apart.
// Per-entry operation sequence: the entry's float64 sum runs over d in
// tensor-core steps of kK columns from 0 (kK = 16, or 8 where d <= 16),
// each step adding its kK exact products to the entry's sum; steps past d
// are skipped and the padding within the last step is 0 * 0.  The step
// depth and the steps depend on d alone — not on the tile configuration, m,
// n or the entry's place in its tile — so a one-column call equals its
// tile's column, and a tail of the rows equals the tile's rows, by
// construction.  The streaming core-set's far-point path (core/smm.py)
// recomputes one column after each insert and relies on it.
//
// Bound: at the streaming shapes it is bound by operations (a 4,096 x 1,025
// tile at d = 5,000 is 42 GFLOP against 0.1 GB of bytes).  The products run
// on the FP64 tensor cores at 67 TFLOP/s on an H100 SXM (the same figure as
// fp32 outside the tensor cores), so the bound is 0.627 ms there.  At d = 3
// it is bound by the bytes of the output it writes (a 65,536 x 513 tile is
// 134 MB, 0.040 ms).  The design:
//   - each block owns a 64 x 64 output tile (64 x 8 where n <= 8), each of
//     its four warps a 32 x 32 part (16 x 8) as 16 x 8 float64 accumulator
//     fragments in registers; three blocks an SM, so the tensor cores have
//     twelve warps to take steps from;
//   - x and y rows are staged with cp.async in d-chunks of kBK = 16 fp32
//     values into a ring of kStages stages, issued kStages chunks ahead
//     (each thread finds the source rows of its pieces once a block, so
//     a chunk costs no 64-bit address arithmetic);
//     each thread converts the pieces its own copies brought (each staged
//     value once) into one of two float64 chunks (row stride kLDK:
//     conflict-free 8-byte fragment reads), and converts chunk c + 1 before
//     it takes chunk c's steps, so one barrier a chunk separates them and
//     the steps still in the tensor pipe overlap the barrier;
//   - the ragged m, n and d edges are zero-filled by the copies (no read
//     past an edge), so the caller never pads or copies its inputs;
//   - the epilogue (round, norm correction, transform) runs on the
//     registers into a shared-memory tile, which threads store row by row
//     on consecutive columns;
//   - d <= 16 (one chunk a tile; the output is the cost): a persistent loop
//     over the tiles reads the next tile's rows and norms into registers
//     while the current tile's steps, epilogue and stores run.
// No cuBLAS, CUTLASS GEMM or torch product runs here.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "dmma.cuh"

namespace {

constexpr int kBK = 16;        // d-chunk: fp32 values a row and stage
constexpr int kStages = 3;     // cp.async ring of fp32 chunks
constexpr int kLDK = kBK + 4;  // float64 row stride of a converted chunk

enum Mode { kSqEuclidean = 0, kEuclidean = 1, kDot = 2, kCosine = 3 };

template <int MODE>
__device__ __forceinline__ float transform(float dot, float xs, float ys) {
  if (MODE == kSqEuclidean || MODE == kEuclidean) {
    // (xs + ys) - 2 dot, in that order (2 dot is exact, so no contraction
    // can change it)
    const float d2 = fmaxf(__fsub_rn(__fadd_rn(xs, ys), 2.0f * dot), 0.0f);
    return MODE == kEuclidean ? sqrtf(d2) : d2;
  } else if (MODE == kDot) {
    return -dot;
  } else {
    return acosf(fminf(fmaxf(dot, -1.0f), 1.0f));
  }
}

// Column col of row r in a float64 chunk.
__device__ __forceinline__ int at(int r, int col) { return r * kLDK + col; }

template <int BM, int BN, int WM, int WN>
struct Tile {
  static constexpr int kThreads = 32 * (BM / WM) * (BN / WN);
  static constexpr int FM = WM / 16, FN = WN / 8;  // fragments a warp
  static constexpr int kRows = BM + BN;  // staged rows: x first, then y
  static constexpr size_t kBuf = (size_t)kRows * kLDK;  // doubles a chunk
  static constexpr size_t kF64 = 2 * kBuf * 8;          // two chunks
  static constexpr size_t kStage = (size_t)kRows * kBK;  // floats
  static constexpr size_t kSmem = kF64 + kStages * kStage * 4;
  // the output tile reuses the float64 chunks once the sums are done
  static constexpr size_t kEpi = (size_t)BM * (BN + 1) * 4;
  static_assert(kEpi <= kF64, "output tile fits");
  // one chunk a tile: one float64 chunk or the output tile
  static constexpr size_t kSmemOne = kBuf * 8 > kEpi ? kBuf * 8 : kEpi;
};

// The warp's KK-deep tensor-core steps over the float64 chunk cur, for the
// steps whose first column k0 + KK s lies below d.
template <int KK, int BM, int FM, int FN>
__device__ __forceinline__ void steps(double (&acc)[FM][FN][4],
                                      const double* cur, int k0, int d,
                                      int wr, int wc, int g, int t) {
#pragma unroll
  for (int s = 0; s < kBK / KK; ++s) {
    if (k0 + KK * s >= d) break;  // past d: depends on d alone
    double b[FN][KK / 4];
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int u = 0; u < KK / 4; ++u)
        b[j][u] = cur[at(BM + wc + 8 * j + g, KK * s + t + 4 * u)];
#pragma unroll
    for (int i = 0; i < FM; ++i) {
      double a[KK / 2];
#pragma unroll
      for (int v = 0; v < KK / 2; ++v)
        a[v] = cur[at(wr + 16 * i + g + 8 * (v & 1),
                      KK * s + t + 4 * (v >> 1))];
#pragma unroll
      for (int j = 0; j < FN; ++j) mma16x8<KK>(acc[i][j], a, b[j]);
    }
  }
}

// The warp's part of the output tile, rounded and transformed, into epi
// (row stride BN + 1); xs, ys are its rows' and columns' squared norms.
template <int MODE, int BN, int FM, int FN>
__device__ __forceinline__ void epilogue(float* epi,
                                         const double (&acc)[FM][FN][4],
                                         const float (&xs)[FM][2],
                                         const float (&ys)[FN][2], int wr,
                                         int wc, int g, int t) {
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          epi[(wr + 16 * i + g + 8 * h) * (BN + 1) + wc + 8 * j + 2 * t + e] =
              transform<MODE>(__double2float_rn(acc[i][j][2 * h + e]),
                              xs[i][h], ys[j][e]);
}

// The squared norms of the warp's rows and columns (0 where not needed),
// every load in flight at once.
template <int MODE, int FM, int FN>
__device__ __forceinline__ void load_norms(float (&xs)[FM][2],
                                           float (&ys)[FN][2],
                                           const float* __restrict__ xsq,
                                           const float* __restrict__ ysq,
                                           long long r0, long long c0, int m,
                                           int n, int g, int t) {
  constexpr bool kNorms = (MODE == kSqEuclidean || MODE == kEuclidean);
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long gr = r0 + 16 * i + g + 8 * h;
      xs[i][h] = (kNorms && gr < m) ? __ldg(xsq + gr) : 0.0f;
    }
#pragma unroll
  for (int j = 0; j < FN; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const long long gc = c0 + 8 * j + 2 * t + e;
      ys[j][e] = (kNorms && gc < n) ? __ldg(ysq + gc) : 0.0f;
    }
}

// The output tile from epi to device memory, threads on consecutive columns.
template <int BM, int BN, int NT>
__device__ __forceinline__ void store_tile(float* __restrict__ out,
                                           const float* epi, long long row0,
                                           long long col0, int m, int n,
                                           int tid) {
#pragma unroll 4
  for (int e = tid; e < BM * BN; e += NT) {
    const int r = e / BN, c = e % BN;
    const long long gr = row0 + r, gc = col0 + c;
    if (gr < m && gc < n) out[gr * n + gc] = epi[r * (BN + 1) + c];
  }
}

// A thread's share of a chunk: pieces e = tid + NT u, each the 16 bytes of
// staged row e / 4 at columns 4 (e % 4) .. 4 (e % 4) + 3 of the chunk.  The
// source of a piece is the same row in every chunk, so it is found once:
// src[u] points at its first column in chunk 0 (null: no such row).
template <int BM, int BN, int NT>
struct Pieces {
  static constexpr int R = BM + BN, N = R * (kBK / 4);
  static constexpr int P = (N + NT - 1) / NT;
  const float* src[P];

  __device__ __forceinline__ Pieces(const float* __restrict__ X,
                                    const float* __restrict__ Y,
                                    long long row0, long long col0, int m,
                                    int n, int d, int tid) {
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int e = tid + NT * u, r = e / (kBK / 4), k = 4 * (e % (kBK / 4));
      src[u] = nullptr;
      if (e < N) {
        if (r < BM) {
          if (row0 + r < m) src[u] = X + (row0 + r) * d + k;
        } else if (col0 + (r - BM) < n) {
          src[u] = Y + (col0 + (r - BM)) * d + k;
        }
      }
    }
  }

  // Copies of chunk c into the stage st[row][k] (VEC: one 16-byte cp.async
  // a piece; else four 4-byte ones, for d % 4 != 0 or unaligned rows);
  // zeros past the edges.
  template <bool VEC>
  __device__ __forceinline__ void copy(float* st, int c, int d, int tid,
                                       const float* any) const {
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int e = tid + NT * u;
      if (e >= N) break;
      const int gk = c * kBK + 4 * (e % (kBK / 4));
      const float* p = src[u];
      if (VEC) {
        const bool ok = p != nullptr && gk < d;
        cp_async16(st + 4 * e, ok ? p + c * kBK : any, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = p != nullptr && gk + q < d;
          cp_async4(st + 4 * e + q, ok ? p + c * kBK + q : any, ok ? 4 : 0);
        }
      }
    }
  }

  // Chunk c as float64 in dst: convert the pieces this thread's own copies
  // brought into stage c % kStages (so waiting for its own copies is
  // enough; each staged value is converted once), then refill that stage
  // with chunk c + kStages.
  template <bool VEC>
  __device__ __forceinline__ void fill(double* dst, float* ring, int c,
                                       int nk, int d, int tid,
                                       const float* any) const {
    cp_async_wait<kStages - 1>();  // chunk c
    float* st = ring + (c % kStages) * R * kBK;
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int e = tid + NT * u;
      if (e >= N) break;
      const float4 v = *reinterpret_cast<const float4*>(st + 4 * e);
      double2* o = reinterpret_cast<double2*>(
          dst + at(e / (kBK / 4), 4 * (e % (kBK / 4))));
      o[0] = make_double2(v.x, v.y);
      o[1] = make_double2(v.z, v.w);
    }
    if (c + kStages < nk) copy<VEC>(st, c + kStages, d, tid, any);
    cp_async_commit();
  }
};

// d > kBK: one block a BM x BN tile, d in chunks through the ring.
template <int MODE, int BM, int BN, int WM, int WN, bool VEC>
__global__ void __launch_bounds__(Tile<BM, BN, WM, WN>::kThreads, 3)
pairwise_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                const float* __restrict__ xsq, const float* __restrict__ ysq,
                float* __restrict__ out, int m, int n, int d) {
  using T = Tile<BM, BN, WM, WN>;
  constexpr int NT = T::kThreads, FM = T::FM, FN = T::FN, WX = BN / WN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* buf = reinterpret_cast<double*>(smem_raw);          // 2 chunks
  float* ring = reinterpret_cast<float*>(smem_raw + T::kF64);  // stages
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / WX) * WM, wc = (warp % WX) * WN;
  const long long row0 = (long long)blockIdx.x * BM;
  const long long col0 = (long long)blockIdx.y * BN;
  // a warp whose rows or columns all lie past the edge stages and waits
  // with the others but computes nothing
  const bool live = row0 + wr < m && col0 + wc < n;

  double acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0;

  const int nk = (d + kBK - 1) / kBK;
  const Pieces<BM, BN, NT> pieces(X, Y, row0, col0, m, n, d, tid);
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s < nk) pieces.template copy<VEC>(ring + s * T::kStage, s, d, tid, X);
    cp_async_commit();
  }
  pieces.template fill<VEC>(buf, ring, 0, nk, d, tid, X);
  __syncthreads();
  for (int c = 0; c < nk; ++c) {
    // convert the next chunk into the other buffer first: this chunk's
    // steps then end the iteration and run on through the barrier
    if (c + 1 < nk)
      pieces.template fill<VEC>(buf + ((c + 1) & 1) * T::kBuf, ring, c + 1,
                                nk, d, tid, X);
    if (live)
      steps<16, BM>(acc, buf + (c & 1) * T::kBuf, c * kBK, d, wr, wc, g, t);
    __syncthreads();
  }
  cp_async_wait<0>();

  float* epi = reinterpret_cast<float*>(buf);
  if (live) {
    float xs[FM][2], ys[FN][2];
    load_norms<MODE>(xs, ys, xsq, ysq, row0 + wr, col0 + wc, m, n, g, t);
    epilogue<MODE, BN>(epi, acc, xs, ys, wr, wc, g, t);
  }
  __syncthreads();
  store_tile<BM, BN, NT>(out, epi, row0, col0, m, n, tid);
}

// d <= kBK: every tile is one chunk, so a tile's time is the latency of
// its loads, steps and stores.  Blocks loop over the tiles (row tiles
// first) and read the next tile's rows and norms into registers while the
// current tile's steps, epilogue and stores run.
template <int MODE, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(Tile<BM, BN, WM, WN>::kThreads, 3)
pairwise_one_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                    const float* __restrict__ xsq,
                    const float* __restrict__ ysq, float* __restrict__ out,
                    int m, int n, int d) {
  using T = Tile<BM, BN, WM, WN>;
  constexpr int NT = T::kThreads, FM = T::FM, FN = T::FN, WX = BN / WN;
  constexpr int R = BM + BN, N = R * kBK / NT;
  static_assert(R * kBK % NT == 0, "whole chunk a thread count");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* buf = reinterpret_cast<double*>(smem_raw);  // the chunk
  float* epi = reinterpret_cast<float*>(smem_raw);    // then the output
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / WX) * WM, wc = (warp % WX) * WN;
  const long long ntr = ((long long)m + BM - 1) / BM;
  const long long tiles = ntr * (((long long)n + BN - 1) / BN);
  float v[N], xs[FM][2], ys[FN][2];
  auto load = [&](long long tile) {  // every load in flight at once
    const long long row0 = (tile % ntr) * BM, col0 = (tile / ntr) * BN;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int e = tid + NT * u, r = e / kBK, k = e % kBK;
      v[u] = 0.0f;
      if (k < d) {
        if (r < BM) {
          if (row0 + r < m) v[u] = __ldg(X + (row0 + r) * d + k);
        } else if (col0 + (r - BM) < n) {
          v[u] = __ldg(Y + (col0 + (r - BM)) * d + k);
        }
      }
    }
    load_norms<MODE>(xs, ys, xsq, ysq, row0 + wr, col0 + wc, m, n, g, t);
  };
  long long tile = blockIdx.x;
  if (tile < tiles) load(tile);
  for (; tile < tiles; tile += gridDim.x) {
    const long long row0 = (tile % ntr) * BM, col0 = (tile / ntr) * BN;
    const bool live = row0 + wr < m && col0 + wc < n;
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int e = tid + NT * u;
      buf[at(e / kBK, e % kBK)] = v[u];
    }
    float cx[FM][2], cy[FN][2];
#pragma unroll
    for (int i = 0; i < FM; ++i) cx[i][0] = xs[i][0], cx[i][1] = xs[i][1];
#pragma unroll
    for (int j = 0; j < FN; ++j) cy[j][0] = ys[j][0], cy[j][1] = ys[j][1];
    if (tile + gridDim.x < tiles) load(tile + gridDim.x);
    __syncthreads();  // the chunk is staged
    double acc[FM][FN][4];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0;
    if (live) steps<8, BM>(acc, buf, 0, d, wr, wc, g, t);
    __syncthreads();  // every warp is done with the chunk
    if (live) epilogue<MODE, BN>(epi, acc, cx, cy, wr, wc, g, t);
    __syncthreads();
    store_tile<BM, BN, NT>(out, epi, row0, col0, m, n, tid);
    __syncthreads();  // the tile is stored before the next chunk lands
  }
}

template <int MODE, int BM, int BN, int WM, int WN>
cudaError_t launch(const float* X, const float* Y, const float* xsq,
                   const float* ysq, float* out, int m, int n, int d,
                   bool vec, cudaStream_t stream) {
  using T = Tile<BM, BN, WM, WN>;
  const long long gx = ((long long)m + BM - 1) / BM;
  const long long gy = ((long long)n + BN - 1) / BN;
  if (gx > 0x7fffffffLL || gy > 65535) return cudaErrorInvalidValue;
  auto kern = vec ? pairwise_kernel<MODE, BM, BN, WM, WN, true>
                  : pairwise_kernel<MODE, BM, BN, WM, WN, false>;
  static bool sized[2] = {false, false};  // shared memory above 48 KB, once
  if (!sized[vec]) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
    if (e != cudaSuccess) return e;
    sized[vec] = true;
  }
  kern<<<dim3((unsigned)gx, (unsigned)gy), T::kThreads, T::kSmem, stream>>>(
      X, Y, xsq, ysq, out, m, n, d);
  return cudaGetLastError();
}

template <int MODE, int BM, int BN, int WM, int WN>
cudaError_t launch_one(const float* X, const float* Y, const float* xsq,
                       const float* ysq, float* out, int m, int n, int d,
                       cudaStream_t stream) {
  using T = Tile<BM, BN, WM, WN>;
  auto kern = pairwise_one_kernel<MODE, BM, BN, WM, WN>;
  static int slots = 0;  // blocks the card holds at once
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kern, T::kThreads, T::kSmemOne);
    if (e != cudaSuccess) return e;
    slots = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long tiles =
      (((long long)m + BM - 1) / BM) * (((long long)n + BN - 1) / BN);
  const int blocks = (int)(tiles < slots ? tiles : slots);
  kern<<<blocks, T::kThreads, T::kSmemOne, stream>>>(X, Y, xsq, ysq, out, m,
                                                      n, d);
  return cudaGetLastError();
}

// Route by shape.  The per-entry operation sequence depends on d alone, so
// the choice changes speed only: d <= kBK the persistent one-chunk loop
// (8-deep steps); otherwise 16-deep steps in 64 x 8 tiles for n <= 8 (the
// far-point path's one-column calls, the delegates' center tiles) and
// 64 x 64 tiles for the rest.
template <int MODE>
cudaError_t launch_mode(const float* X, const float* Y, const float* xsq,
                        const float* ysq, float* out, int m, int n, int d,
                        bool vec, cudaStream_t st) {
  if (d <= kBK)
    return launch_one<MODE, 64, 64, 32, 32>(X, Y, xsq, ysq, out, m, n, d, st);
  if (n <= 8)
    return launch<MODE, 64, 8, 16, 8>(X, Y, xsq, ysq, out, m, n, d, vec, st);
  return launch<MODE, 64, 64, 32, 32>(X, Y, xsq, ysq, out, m, n, d, vec, st);
}

}  // namespace

extern "C" {

// One distance tile.  Pointers are device pointers; xsq and ysq may be null
// for the dot and cosine modes.  out holds m * n floats, row-major.
// Returns the launch's cudaError_t (0 = launched).
int repro_pairwise(const float* X, const float* Y, const float* xsq,
                   const float* ysq, float* out, int m, int n, int d,
                   int mode, void* stream) {
  if (m <= 0 || n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(Y) % 16 == 0;
  switch (mode) {
    case kSqEuclidean:
      return (int)launch_mode<kSqEuclidean>(X, Y, xsq, ysq, out, m, n, d, vec,
                                            st);
    case kEuclidean:
      return (int)launch_mode<kEuclidean>(X, Y, xsq, ysq, out, m, n, d, vec,
                                          st);
    case kDot:
      return (int)launch_mode<kDot>(X, Y, xsq, ysq, out, m, n, d, vec, st);
    case kCosine:
      return (int)launch_mode<kCosine>(X, Y, xsq, ysq, out, m, n, d, vec, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
