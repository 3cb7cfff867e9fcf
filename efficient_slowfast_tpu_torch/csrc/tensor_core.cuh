// Warp-level building blocks for bf16 tensor-core kernels on sm_80 and
// later (Hopper included): ldmatrix, mma.sync m16n8k16 with f32
// accumulation, cp.async with zero fill, ex2.approx and packed bf16
// conversion, each a thin wrapper over one PTX instruction; and a
// block-wide loader of a window of matrix rows and columns into padded
// shared memory.
//
// Fragment layouts of mma.sync.m16n8k16 with bf16 inputs (PTX ISA, "Matrix
// Fragments for mma.m16n8k16"), for lane = 4 g + t:
//   A (16 x 16, row-major), four 32-bit registers of two bf16 each:
//     a[0] = A[g][2t..2t+1]     a[1] = A[g+8][2t..2t+1]
//     a[2] = A[g][2t+8..2t+9]   a[3] = A[g+8][2t+8..2t+9]
//   B (16 x 8, K x N), two registers:
//     b[0] = B[2t..2t+1][g]     b[1] = B[2t+8..2t+9][g]
//   C and D (16 x 8, f32):
//     d[0..1] = D[g][2t..2t+1]  d[2..3] = D[g+8][2t..2t+1]
// The element of lower index sits in the lower 16 bits of a register.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 matrices of 16-bit elements from shared memory: lanes 8i to
// 8i + 7 give the addresses of rows 0-7 of matrix i (16 bytes each), and
// r[i] receives the lane's (row g, columns 2t and 2t + 1) of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// The same, transposed: r[i] receives (rows 2t and 2t + 1, column g) of
// matrix i.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// d += A B on the tensor cores: A 16 x 16 and B 16 x 8 in bf16, d in f32.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from global to shared memory, asynchronously, bypassing L1: the
// first src_bytes (0 or 16) are read and the rest of the 16 are zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit (one MUFU.EX2; -inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to nearest-even bf16 in one register, lo in the lower
// half (one F2FP instruction).
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// bf16 padding of each shared-memory row of a tile (16 bytes): the 8 rows
// of an ldmatrix phase then fall on 8 different bank groups.
constexpr int kSmemPad = 8;

// Rows r0 .. r0 + kRowsT - 1 and columns col0 .. col0 + kCols - 1 of a
// (count x w) bf16 matrix into shared rows `ld` elements apart, zero past w
// and past count, by the kThreads threads of the block. vec: w is a
// multiple of 8 and src is 16-byte aligned, so each row goes as kCols / 8
// 16-byte cp.async chunks (zero-filled where they fall outside the matrix),
// a fixed number per thread; else element by element.
template <int kCols, int kRowsT, int kThreads>
__device__ __forceinline__ void load_cols(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src, int r0,
                                          int count, int w, int col0,
                                          bool vec) {
  const __nv_bfloat16* base = src + (size_t)r0 * w + col0;
  const int left = count - r0;  // rows of the matrix from r0 on
  const int wl = w - col0;      // columns of the matrix from col0 on
  if (vec) {
    constexpr int kChunks = kCols / 8, kTotal = kRowsT * kChunks;
#pragma unroll
    for (int u = 0; u < (kTotal + kThreads - 1) / kThreads; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (kTotal % kThreads == 0 || i < kTotal) {
        const int r = i / kChunks, j = i % kChunks * 8;
        const bool in = r < left && j < wl;
        cp_async_16(dst + r * ld + j, in ? base + r * w + j : src,
                    in ? 16 : 0);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kRowsT * kCols; i += kThreads) {
      const int r = i / kCols, j = i % kCols;
      dst[r * ld + j] = r < left && j < wl ? base[r * w + j]
                                           : __float2bfloat16_rn(0.f);
    }
  }
}

// Rows r0 .. r0 + kRowsT - 1 of a (count x w) bf16 matrix into shared rows
// of WP + kSmemPad elements, zero-padded to WP columns and past count
// (load_cols from column 0).
template <int WP, int kRowsT, int kThreads>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int count, int w, bool vec) {
  load_cols<WP, kRowsT, kThreads>(dst, WP + kSmemPad, src, r0, count, w, 0,
                                  vec);
}

}  // namespace tc
