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
// Bound: at the streaming shapes it is bound by fp32 operations (a 4,096 x
// 1,025 tile at d = 5,000 is 42 GFLOP against 0.1 GB of bytes) and at d = 3
// by the bytes of the output it writes (a 65,536 x 513 tile is 134 MB).
// The design follows from that, kept simple:
//   - each block owns a BM x BN output tile and each thread a TM x TN patch
//     of it in registers, so every value read from shared memory serves TM
//     or TN products;
//   - x and y tiles are staged in shared memory in d-chunks of kBK values,
//     transposed (k-major) so the inner loop reads them without bank
//     conflicts; accumulation is fp32 on CUDA cores (no TF32), because the
//     kernel must match the plain version to 3e-5;
//   - the ragged m, n and d edges are masked here (zeros in shared memory,
//     no store past the edge), so the caller never pads or copies its
//     inputs (the reference's jnp.pad is a full copy);
//   - the epilogue (norm correction and transform) runs on the registers and
//     the tile is stored once, threads of a warp on consecutive columns.
// Summation order: every entry is one chain over k = 0, 1, ..., d-1 started
// from 0, one rounded product and one rounded add per step (__fmul_rn,
// __fadd_rn: never contracted into a fused multiply-add), whatever the tile
// configuration, the entry's place in its tile, m or n.  So an entry comes
// out bit for bit the same in a full tile and in a one-column call — the
// streaming core-set's far-point path (core/smm.py) recomputes one column
// after each insert and relies on it — and the plain version
// (kernels/ref.py pairwise_ref) computes the very same chain in torch, so
// kernel and plain agree bit for bit and a stream makes the same decisions
// on either path.  The price: two instructions per term where a fused
// multiply-add would take one, so the kernel can reach at most half of the
// card's fp32 rate.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;  // d-chunk staged in shared memory

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

// Stage rows [r0, r0 + R) x columns [k0, k0 + kBK) of A (rows x d) into
// S[k][r] (row stride R + 1), zeros past the edges.  Sixteen threads read
// one row's chunk: 64 contiguous bytes.
template <int R>
__device__ __forceinline__ void stage(float (*S)[R + 1],
                                      const float* __restrict__ A,
                                      long long r0, long long rows, int k0,
                                      int d, int tid) {
#pragma unroll
  for (int e = tid; e < R * kBK; e += kThreads) {
    const int r = e / kBK, k = e - r * kBK;
    const long long gr = r0 + r;
    const int gk = k0 + k;
    S[k][r] = (gr < rows && gk < d) ? __ldg(A + gr * d + gk) : 0.0f;
  }
}

template <int MODE, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
pairwise_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                const float* __restrict__ xsq, const float* __restrict__ ysq,
                float* __restrict__ out, int m, int n, int d) {
  constexpr int TX = BN / TN;  // threads along the columns
  constexpr int TY = BM / TM;  // threads along the rows
  static_assert(TX * TY == kThreads, "one output patch per thread");
  __shared__ float As[kBK][BM + 1];
  __shared__ float Bs[kBK][BN + 1];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const long long row0 = (long long)blockIdx.x * BM;
  const long long col0 = (long long)blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kBK) {
    stage<BM>(As, X, row0, m, k0, d, tid);
    stage<BN>(Bs, Y, col0, n, k0, d, tid);
    __syncthreads();
    // past d the staged values are 0 and acc + 0 * 0 == acc, so the padded
    // steps leave every entry's chain unchanged
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty + TY * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + TX * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(a[i], b[j]));
    }
    __syncthreads();
  }

  constexpr bool kNorms = (MODE == kSqEuclidean || MODE == kEuclidean);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = row0 + ty + TY * i;
    if (r >= m) continue;
    const float xs = kNorms ? xsq[r] : 0.0f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long c = col0 + tx + TX * j;
      if (c < n) {
        const float ys = kNorms ? ysq[c] : 0.0f;
        out[r * n + c] = transform<MODE>(acc[i][j], xs, ys);
      }
    }
  }
}

template <int MODE, int BM, int BN, int TM, int TN>
cudaError_t launch(const float* X, const float* Y, const float* xsq,
                   const float* ysq, float* out, int m, int n, int d,
                   cudaStream_t stream) {
  const long long gx = ((long long)m + BM - 1) / BM;
  const long long gy = ((long long)n + BN - 1) / BN;
  if (gx > 0x7fffffffLL || gy > 65535) return cudaErrorInvalidValue;
  pairwise_kernel<MODE, BM, BN, TM, TN>
      <<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0, stream>>>(
          X, Y, xsq, ysq, out, m, n, d);
  return cudaGetLastError();
}

// Tile configuration by shape.  The per-entry arithmetic is the same in
// all three, so the choice changes speed only:
//   narrow  64 x 4   (1 x 1 per thread)  n <= 4: the one-column calls of the
//           far-point path, which would waste 127/128 of a wide tile;
//   wide    128 x 128 (8 x 8)            enough tiles to fill the card twice;
//   medium  64 x 64  (4 x 4)             otherwise (more, smaller blocks).
template <int MODE>
cudaError_t launch_mode(const float* X, const float* Y, const float* xsq,
                        const float* ysq, float* out, int m, int n, int d,
                        cudaStream_t st) {
  if (n <= 4)
    return launch<MODE, 64, 4, 1, 1>(X, Y, xsq, ysq, out, m, n, d, st);
  const long long wide =
      (((long long)m + 127) / 128) * (((long long)n + 127) / 128);
  if (wide >= 2 * 132)
    return launch<MODE, 128, 128, 8, 8>(X, Y, xsq, ysq, out, m, n, d, st);
  return launch<MODE, 64, 64, 4, 4>(X, Y, xsq, ysq, out, m, n, d, st);
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
  switch (mode) {
    case kSqEuclidean:
      return (int)launch_mode<kSqEuclidean>(X, Y, xsq, ysq, out, m, n, d, st);
    case kEuclidean:
      return (int)launch_mode<kEuclidean>(X, Y, xsq, ysq, out, m, n, d, st);
    case kDot:
      return (int)launch_mode<kDot>(X, Y, xsq, ysq, out, m, n, d, st);
    case kCosine:
      return (int)launch_mode<kCosine>(X, Y, xsq, ysq, out, m, n, d, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
