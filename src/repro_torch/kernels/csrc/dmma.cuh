// Float64 tensor-core pieces shared by the distance tile (pairwise.cu, B3)
// and the grouped sweep (gmm_grouped.cu, B4): 16 x 8 x k product steps on
// the FP64 tensor cores (k = 4, 8, 16), and the cp.async copies that stage
// fp32 rows.
//
// mma16x8x4(c, a, b) adds A (16 x 4) . B (4 x 8) to the 16 x 8 block C held
// by the warp, every operand float64.  Fragment layout (PTX ISA, mma
// .m16n8k4 .f64; lane = 4 * g + t):
//   a[0] = A[g][t], a[1] = A[g + 8][t]
//   b    = B[t][g]
//   c[0] = C[g][2t], c[1] = C[g][2t + 1], c[2] = C[g + 8][2t],
//   c[3] = C[g + 8][2t + 1]
// A product of two fp32 values is exact in float64 (24 + 24 < 53 bits), so
// the only roundings are the float64 accumulations.  Each entry of C
// depends on its row of A, its column of B and its own old value only, so
// an entry comes out the same wherever it sits in a tile.  (Not volatile:
// the step is a pure function of its operands, so the compiler may move
// loads across it.)
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void mma16x8x4(double (&c)[4], const double (&a)[2],
                                          double b) {
  asm(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// k = 8 and k = 16 forms (PTX ISA, sm_90):
//   a[v0 + 2 v1] = A[g + 8 v0][t + 4 v1], b[u] = B[t + 4u][g], C as above
__device__ __forceinline__ void mma16x8x8(double (&c)[4], const double (&a)[4],
                                          const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ void mma16x8x16(double (&c)[4],
                                           const double (&a)[8],
                                           const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

template <int K>
__device__ __forceinline__ void mma16x8(double (&c)[4],
                                        const double (&a)[K / 2],
                                        const double (&b)[K / 4]) {
  if constexpr (K == 4) mma16x8x4(c, a, b[0]);
  else if constexpr (K == 8) mma16x8x8(c, a, b);
  else mma16x8x16(c, a, b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy to shared memory; src_bytes = 0 writes zeros and reads
// nothing (the ragged edges of a tile)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4-byte copy to shared memory, zero-filled as above (rows whose d is not
// a multiple of 4, or that are not 16-byte aligned)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace
