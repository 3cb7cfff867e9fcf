// Flash attention backward for Hopper (sm_90a): the gradients of
// out = softmax(q k^T) v (no scale on the logits) with respect to q, k and
// v, recomputing the probabilities tile by tile from the forward's per-row
// log-sum-exp, so that the N x M probabilities never exist in memory.
//
// Replaces the backward of the Pallas TPU kernel K2, which in the JAX
// package is not a Pallas kernel: efficient_slowfast_tpu/ops/pallas/
// flash_attention.py::_bwd (:219-222), XLA's vjp of chunked_attention
// (:31-80). That vjp recomputes the forward and keeps every key chunk's
// logits and probabilities as lax.scan residuals, N*M float32 per clip:
// 2.5 GB per clip for CMDA-R50's two big fusions at the 224^2 training crop
// (N = M = 25088).
//
// For q (B, N, D), k (B, M, D), v (B, M, C), the forward's out (B, N, C)
// and lse (B, N) (lse = row max + log(row sum) of the logits, float32) and
// the output's gradient dO (B, N, C), with P = exp(q k^T - lse):
//   Dl = rowsum(dO o out)       dV = P^T dO
//   dS = P o (dO v^T - Dl)      dQ = dS k        dK = dS^T q
// Three launches per call, without atomics, so the result is deterministic:
//   (a) attention_bwd_delta_kernel: Dl, one thread per row, float32.
//   (b) the key-rows kernel: a block owns 64 keys and loops over every
//       query tile, holding dK and dV in registers.
//   (c) the query-rows kernel: a block owns 64 query rows and loops over
//       every key tile, holding dQ in registers.
// (b) and (c) are one template. A block's rows (keys in (b), queries in
// (c)) bring two row operands, A1 (rows x D: k or q) and A2 (rows x C: v or
// dO); the columns (queries in (b), keys in (c)) stream in tiles of two
// operands, B1 (cols x D: q or k) and B2 (cols x C: dO or v). Per tile:
//   X = A1 B1^T, Y = A2 B2^T        (S^T and dP^T in (b), S and dP in (c))
//   P = exp(X - lse), dS = P o (Y - Dl)   (lse, Dl of the query: the
//                                          column in (b), the row in (c))
//   (b): dV += P B2, dK += dS B1;   (c): dQ += dS B1.
// Columns past the matrix are masked (P = 0); rows past it are computed
// and not written.
//
// What bounds it on the H100 at the CMDA-R50 training shapes (bf16, 8 clips
// of 32 frames at 224^2; N = M = 25088, 25088, 6272, 1568 with D = C = 8,
// 32, 64, 128): the five products are 2 N M (3D + 2C) operations per clip
// on a few tens of MB, so operations, not bytes, bound it: the N*M
// exponentials at 16 per clock per SM where D = C <= 32 (s1/s2_fuse), the
// tensor cores above. chip_smoke.py computes the bound per shape. This
// first version does more than that work: (b) and (c) each recompute X, Y
// and P, so the products are 2 N M (4D + 3C) and the exponentials 2 N M.
//
// bfloat16: all products on the tensor cores (mma.sync m16n8k16, bf16 in,
// f32 accumulated; helpers in tensor_core.cuh). A warp owns 16 rows; a
// block has 4 warps. D and C are zero-padded to one width WP in {16, 32,
// 64, 128} in shared memory, rows padded by 16 bytes. A1 and A2 are copied
// to shared memory once; B1 and B2 stream in tiles of 64 columns (32 where
// WP is 128, for registers) through two buffers filled by 16-byte cp.async
// copies, one tile ahead, with two barriers per tile. X and Y come from
// ldmatrix fragments of both operands (A1 and A2 re-read each tile: no
// registers to hold them at WP 128); P and dS are rounded to bf16 in the
// accumulator registers, which become the A fragments of P B2 and dS B1
// directly, B2 and B1 taken by ldmatrix.trans of their row-major layout.
// The exponentials are MUFU.EX2, P = ex2(X log2 e - lse log2 e), one FFMA
// each. The row pass (a) reads the bf16 out and dO and sums in float32.
//
// float32 (the tolerance checks): the same template with scalar f32 FMAs
// on the CUDA cores, 256 threads a block over 64 rows and tiles of 32
// columns: four threads own a row, each computes X, Y, P and dS for 8 of
// the tile's columns into shared memory, then accumulates its quarter of
// the row's output columns over all 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// (a) Dl[r] = sum_j out[r, j] dO[r, j] over the rows of (B N, C).
template <typename T>
__global__ void attention_bwd_delta_kernel(const T* __restrict__ out,
                                           const T* __restrict__ dout,
                                           float* __restrict__ delta,
                                           long long rows, int c) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T* o = out + r * c;
  const T* g = dout + r * c;
  float s = 0.f;
  for (int j = 0; j < c; ++j) s = fmaf(to_f(o[j]), to_f(g[j]), s);
  delta[r] = s;
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel.

constexpr int kWarps = 4;
constexpr int kTcThreads = 32 * kWarps;
constexpr int kTcRows = 16 * kWarps;  // rows of a block
constexpr int kStages = 2;            // column-tile buffers
constexpr int kPad = tc::kSmemPad;

// Columns of a tile: 64, or 32 where WP is 128 (X and Y take kCols / 2
// registers each beside the 8 WP / 32 of the accumulators).
__host__ __device__ constexpr int tc_cols(int wp) {
  return wp == 128 ? 32 : 64;
}

// Shared memory: A1 and A2 (kTcRows x (WP + kPad) each), kStages tiles of
// B1 and of B2 (tc_cols x (WP + kPad) each), bf16; then kStages x tc_cols
// floats each of lse and Dl (read in (b) only).
__host__ __device__ inline size_t tc_smem_bytes(int wp) {
  return sizeof(bf16) * (size_t)(wp + kPad) *
             (2 * kTcRows + 2 * kStages * tc_cols(wp)) +
         sizeof(float) * 2 * kStages * tc_cols(wp);
}

// x (16 x 8 kNT, fragment layout) = A B^T: A the warp's 16 rows of a
// row-major (rows x WP) shared tile, B a row-major (8 kNT x WP) shared
// tile. a, b: the lane's ldmatrix rows in each.
template <int WP, int kNT>
__device__ __forceinline__ void products(float (&x)[kNT][4], const bf16* a,
                                         const bf16* b) {
  constexpr int kLd = WP + kPad;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
    x[nt][0] = x[nt][1] = x[nt][2] = x[nt][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < WP / 16; ++kc) {
    uint32_t af[4];
    tc::ldmatrix_x4(af, a + 16 * kc);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t bf[4];
      tc::ldmatrix_x4(bf, b + 16 * np * kLd + 16 * kc);
      tc::mma_bf16_16816(x[2 * np], af, bf[0], bf[1]);
      tc::mma_bf16_16816(x[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x WP) += F B: F (16 x 8 kNT) in the fragment layout of an
// accumulator, rounded to bf16 A fragments in registers; B a row-major
// (8 kNT x WP) shared tile read by ldmatrix.trans from the lane's row bt.
template <int WP, int kNT>
__device__ __forceinline__ void accumulate(float (&acc)[WP / 8][4],
                                           const float (&f)[kNT][4],
                                           const bf16* bt) {
  constexpr int kLd = WP + kPad;
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    const uint32_t a[4] = {tc::pack_bf16x2(f[2 * kk][0], f[2 * kk][1]),
                           tc::pack_bf16x2(f[2 * kk][2], f[2 * kk][3]),
                           tc::pack_bf16x2(f[2 * kk + 1][0], f[2 * kk + 1][1]),
                           tc::pack_bf16x2(f[2 * kk + 1][2], f[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < WP / 16; ++np) {
      uint32_t b[4];
      tc::ldmatrix_x4_trans(b, bt + 16 * kk * kLd + 16 * np);
      tc::mma_bf16_16816(acc[2 * np], a, b[0], b[1]);
      tc::mma_bf16_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Rows r (16 x WP accumulator of the warp, rows g and g + 8) into the
// (rows x w) matrix dst, columns < w.
template <int WP>
__device__ __forceinline__ void store_rows(bf16* dst,
                                           const float (&acc)[WP / 8][4],
                                           int row0, int rows, int w, int g,
                                           int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= rows) continue;
    bf16* o = dst + (size_t)row * w;
#pragma unroll
    for (int j = 0; j < WP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < w) o[col] = __float2bfloat16_rn(acc[j][2 * h]);
      if (col + 1 < w) o[col + 1] = __float2bfloat16_rn(acc[j][2 * h + 1]);
    }
  }
}

// KEY_ROWS: kernel (b), rows are keys (a1 = k, a2 = v, b1 = q, b2 = dO;
// out_d = dK, out_c = dV); else (c), rows are queries (a1 = q, a2 = dO,
// b1 = k, b2 = v; out_d = dQ). lse and delta are indexed by the query.
template <int WP, bool KEY_ROWS>
__global__ void __launch_bounds__(kTcThreads)
attention_bwd_tc_kernel(const bf16* __restrict__ a1,
                        const bf16* __restrict__ a2,
                        const bf16* __restrict__ b1,
                        const bf16* __restrict__ b2,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ out_d, bf16* __restrict__ out_c,
                        int rows, int cols, int d, int c, bool d_vec,
                        bool c_vec) {
  constexpr int kCols = tc_cols(WP), kNT = kCols / 8;
  constexpr int kLd = WP + kPad, kATile = kTcRows * kLd, kBTile = kCols * kLd;
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned
  bf16* a1s = reinterpret_cast<bf16*>(smem4);  // [kTcRows][kLd]
  bf16* a2s = a1s + kATile;                    // [kTcRows][kLd]
  bf16* b1s = a2s + kATile;                    // [kStages][kCols][kLd]
  bf16* b2s = b1s + kStages * kBTile;          // [kStages][kCols][kLd]
  // [kStages][kCols]: lse in log2 units, and Dl, of the tile's queries
  float* lse_s = reinterpret_cast<float*>(b2s + kStages * kBTile);
  float* dl_s = lse_s + kStages * kCols;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  // ldmatrix: lane supplies row lr of matrix 2 * l16 + l8
  const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
  const int a_lane = (16 * warp + lr + 8 * l8) * kLd + 8 * l16;  // A frags
  const int b_lane = (lr + 8 * l16) * kLd + 8 * l8;   // B of A B^T
  const int bt_lane = (lr + 8 * l8) * kLd + 8 * l16;  // B of F B, .trans
  const int r0 = blockIdx.x * kTcRows;
  const size_t bi = blockIdx.y;
  const size_t queries = KEY_ROWS ? cols : rows;
  a1 += bi * rows * d;
  a2 += bi * rows * c;
  b1 += bi * cols * d;
  b2 += bi * cols * c;
  lse += bi * queries;
  delta += bi * queries;
  out_d += bi * rows * d;
  if constexpr (KEY_ROWS) out_c += bi * rows * c;
  const int tiles = (cols + kCols - 1) / kCols;

  auto load_tile = [&](int it) {  // B1, B2 (and lse, Dl) of tile it
    const int buf = it % kStages, c0 = it * kCols;
    tc::load_rows<WP, kCols, kTcThreads>(b1s + buf * kBTile, b1, c0, cols, d,
                                         d_vec);
    tc::load_rows<WP, kCols, kTcThreads>(b2s + buf * kBTile, b2, c0, cols, c,
                                         c_vec);
    if constexpr (KEY_ROWS) {
      for (int i = threadIdx.x; i < kCols; i += kTcThreads) {
        const int col = c0 + i;
        lse_s[buf * kCols + i] = col < cols ? lse[col] * kLog2e : INFINITY;
        dl_s[buf * kCols + i] = col < cols ? delta[col] : 0.f;
      }
    }
    tc::cp_async_commit();
  };

  tc::load_rows<WP, kTcRows, kTcThreads>(a1s, a1, r0, rows, d, d_vec);
  tc::load_rows<WP, kTcRows, kTcThreads>(a2s, a2, r0, rows, c, c_vec);
  load_tile(0);  // one group with A1 and A2

  float lse_r[2] = {0.f, 0.f}, dl_r[2] = {0.f, 0.f};  // (c): rows g, g + 8
  if constexpr (!KEY_ROWS) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 16 * warp + g + 8 * h;
      if (row < rows) {
        lse_r[h] = lse[row] * kLog2e;
        dl_r[h] = delta[row];
      }
    }
  }
  float acc_d[WP / 8][4], acc_c[KEY_ROWS ? WP / 8 : 1][4];
#pragma unroll
  for (int j = 0; j < WP / 8; ++j) {
    acc_d[j][0] = acc_d[j][1] = acc_d[j][2] = acc_d[j][3] = 0.f;
    if constexpr (KEY_ROWS)
      acc_c[j][0] = acc_c[j][1] = acc_c[j][2] = acc_c[j][3] = 0.f;
  }

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      load_tile(it + 1);  // into the buffer that tile it - 1 left
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();  // tile it (and A1, A2) landed for every thread
    const int buf = it % kStages, c0 = it * kCols;
    const bf16* b1t = b1s + buf * kBTile;
    const bf16* b2t = b2s + buf * kBTile;
    float x[kNT][4], y[kNT][4];
    products<WP, kNT>(x, a1s + a_lane, b1t + b_lane);
    products<WP, kNT>(y, a2s + a_lane, b2t + b_lane);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, j = 8 * nt + 2 * t + (e & 1);
        const float l2 = KEY_ROWS ? lse_s[buf * kCols + j] : lse_r[h];
        const float dl = KEY_ROWS ? dl_s[buf * kCols + j] : dl_r[h];
        const float p =
            c0 + j < cols ? tc::ex2(fmaf(x[nt][e], kLog2e, -l2)) : 0.f;
        x[nt][e] = p;
        y[nt][e] = p * (y[nt][e] - dl);
      }
    accumulate<WP, kNT>(acc_d, y, b1t + bt_lane);    // dS B1
    if constexpr (KEY_ROWS)
      accumulate<WP, kNT>(acc_c, x, b2t + bt_lane);  // P B2
    __syncthreads();  // buffer buf is free for tile it + 2
  }

  store_rows<WP>(out_d, acc_d, r0 + 16 * warp, rows, d, g, t);
  if constexpr (KEY_ROWS)
    store_rows<WP>(out_c, acc_c, r0 + 16 * warp, rows, c, g, t);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int WP, bool KEY_ROWS>
int launch_tc(const void* a1, const void* a2, const void* b1, const void* b2,
              const float* lse, const float* delta, void* out_d, void* out_c,
              int b, int rows, int cols, int d, int c, bool d_vec, bool c_vec,
              cudaStream_t s) {
  auto kernel = attention_bwd_tc_kernel<WP, KEY_ROWS>;
  const size_t smem = tc_smem_bytes(WP);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((rows + kTcRows - 1) / kTcRows, b);
  kernel<<<grid, kTcThreads, smem, s>>>(
      static_cast<const bf16*>(a1), static_cast<const bf16*>(a2),
      static_cast<const bf16*>(b1), static_cast<const bf16*>(b2), lse, delta,
      static_cast<bf16*>(out_d), static_cast<bf16*>(out_c), rows, cols, d, c,
      d_vec, c_vec);
  return (int)cudaGetLastError();
}

template <bool KEY_ROWS>
int dispatch_tc(const void* a1, const void* a2, const void* b1,
                const void* b2, const float* lse, const float* delta,
                void* out_d, void* out_c, int b, int rows, int cols, int d,
                int c, cudaStream_t s) {
  const bool d_vec = d % 8 == 0 && aligned16(a1) && aligned16(b1);
  const bool c_vec = c % 8 == 0 && aligned16(a2) && aligned16(b2);
  const int w = d > c ? d : c;
#define ESF_LAUNCH(WP)                                                       \
  return launch_tc<WP, KEY_ROWS>(a1, a2, b1, b2, lse, delta, out_d, out_c, b, \
                                 rows, cols, d, c, d_vec, c_vec, s)
  if (w <= 16) ESF_LAUNCH(16);
  if (w <= 32) ESF_LAUNCH(32);
  if (w <= 64) ESF_LAUNCH(64);
  ESF_LAUNCH(128);
#undef ESF_LAUNCH
}

// ---------------------------------------------------------------------------
// float32: the scalar kernel.

constexpr int kF32Threads = 256;
constexpr int kF32Rows = 64;  // rows of a block, four threads each
constexpr int kF32Cols = 32;  // columns of a tile
constexpr int kF32LdP = kF32Cols + 1;

// Floats of shared memory: A1, A2 (kF32Rows x (WP + 1)), B1, B2 (kF32Cols x
// (WP + 1)), P and dS (kF32Rows x kF32LdP), lse and Dl (kF32Cols).
__host__ __device__ inline size_t f32_smem_floats(int wp) {
  return (size_t)(wp + 1) * 2 * (kF32Rows + kF32Cols) +
         (size_t)2 * kF32Rows * kF32LdP + 2 * kF32Cols;
}

// Rows r0 .. r0 + count_t - 1 of a (count x w) matrix into shared rows of
// ld floats, zero past w (up to wp) and past count.
__device__ __forceinline__ void load_f32(float* dst, const float* src, int r0,
                                         int count_t, int count, int w,
                                         int wp, int ld) {
  for (int i = threadIdx.x; i < count_t * wp; i += kF32Threads) {
    const int r = i / wp, j = i - r * wp;
    dst[r * ld + j] =
        r0 + r < count && j < w ? src[(size_t)(r0 + r) * w + j] : 0.f;
  }
}

template <int WP, bool KEY_ROWS>
__global__ void __launch_bounds__(kF32Threads)
attention_bwd_scalar_kernel(const float* __restrict__ a1,
                         const float* __restrict__ a2,
                         const float* __restrict__ b1,
                         const float* __restrict__ b2,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ out_d, float* __restrict__ out_c,
                         int rows, int cols, int d, int c) {
  constexpr int kLd = WP + 1;
  extern __shared__ float4 smem4[];
  float* a1s = reinterpret_cast<float*>(smem4);  // [kF32Rows][kLd]
  float* a2s = a1s + kF32Rows * kLd;             // [kF32Rows][kLd]
  float* b1s = a2s + kF32Rows * kLd;             // [kF32Cols][kLd]
  float* b2s = b1s + kF32Cols * kLd;             // [kF32Cols][kLd]
  float* ps = b2s + kF32Cols * kLd;              // [kF32Rows][kF32LdP]
  float* dss = ps + kF32Rows * kF32LdP;          // [kF32Rows][kF32LdP]
  float* lse_s = dss + kF32Rows * kF32LdP;       // [kF32Cols], log2 units
  float* dl_s = lse_s + kF32Cols;                // [kF32Cols]

  const int tid = threadIdx.x, r = tid >> 2, part = tid & 3;
  const int r0 = blockIdx.x * kF32Rows, row = r0 + r;
  const size_t bi = blockIdx.y;
  const size_t queries = KEY_ROWS ? cols : rows;
  a1 += bi * rows * d;
  a2 += bi * rows * c;
  b1 += bi * cols * d;
  b2 += bi * cols * c;
  lse += bi * queries;
  delta += bi * queries;

  load_f32(a1s, a1, r0, kF32Rows, rows, d, WP, kLd);
  load_f32(a2s, a2, r0, kF32Rows, rows, c, WP, kLd);
  const float lse_r = !KEY_ROWS && row < rows ? lse[row] * kLog2e : 0.f;
  const float dl_r = !KEY_ROWS && row < rows ? delta[row] : 0.f;
  float acc_d[WP / 4], acc_c[KEY_ROWS ? WP / 4 : 1];
#pragma unroll
  for (int v = 0; v < WP / 4; ++v) {
    acc_d[v] = 0.f;
    if constexpr (KEY_ROWS) acc_c[v] = 0.f;
  }
  const float* a1r = a1s + r * kLd;
  const float* a2r = a2s + r * kLd;

  for (int c0 = 0; c0 < cols; c0 += kF32Cols) {
    __syncthreads();  // the last tile is no longer read
    load_f32(b1s, b1, c0, kF32Cols, cols, d, WP, kLd);
    load_f32(b2s, b2, c0, kF32Cols, cols, c, WP, kLd);
    if (KEY_ROWS && tid < kF32Cols) {
      lse_s[tid] = c0 + tid < cols ? lse[c0 + tid] * kLog2e : INFINITY;
      dl_s[tid] = c0 + tid < cols ? delta[c0 + tid] : 0.f;
    }
    __syncthreads();
    // X, Y, P and dS of row r at columns part + 4u
#pragma unroll
    for (int u = 0; u < kF32Cols / 4; ++u) {
      const int j = part + 4 * u;
      const float* b1r = b1s + j * kLd;
      const float* b2r = b2s + j * kLd;
      float x = 0.f, y = 0.f;
      for (int e = 0; e < d; ++e) x = fmaf(a1r[e], b1r[e], x);
      for (int e = 0; e < c; ++e) y = fmaf(a2r[e], b2r[e], y);
      const float l2 = KEY_ROWS ? lse_s[j] : lse_r;
      const float dl = KEY_ROWS ? dl_s[j] : dl_r;
      const float p = c0 + j < cols ? exp2f(fmaf(x, kLog2e, -l2)) : 0.f;
      ps[r * kF32LdP + j] = p;
      dss[r * kF32LdP + j] = p * (y - dl);
    }
    __syncwarp();  // the four threads of row r share a warp
    // this thread's output columns part + 4v over the tile's columns
    for (int j = 0; j < kF32Cols; ++j) {
      const float ds = dss[r * kF32LdP + j];
      const float* b1r = b1s + j * kLd + part;
#pragma unroll
      for (int v = 0; v < WP / 4; ++v)
        acc_d[v] = fmaf(ds, b1r[4 * v], acc_d[v]);
      if constexpr (KEY_ROWS) {
        const float p = ps[r * kF32LdP + j];
        const float* b2r = b2s + j * kLd + part;
#pragma unroll
        for (int v = 0; v < WP / 4; ++v)
          acc_c[v] = fmaf(p, b2r[4 * v], acc_c[v]);
      }
    }
  }

  if (row >= rows) return;
#pragma unroll
  for (int v = 0; v < WP / 4; ++v) {
    const int e = part + 4 * v;
    if (e < d) out_d[(bi * rows + row) * d + e] = acc_d[v];
    if constexpr (KEY_ROWS)
      if (e < c) out_c[(bi * rows + row) * c + e] = acc_c[v];
  }
}

template <int WP, bool KEY_ROWS>
int launch_f32(const float* a1, const float* a2, const float* b1,
               const float* b2, const float* lse, const float* delta,
               float* out_d, float* out_c, int b, int rows, int cols, int d,
               int c, cudaStream_t s) {
  auto kernel = attention_bwd_scalar_kernel<WP, KEY_ROWS>;
  const size_t smem = f32_smem_floats(WP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((rows + kF32Rows - 1) / kF32Rows, b);
  kernel<<<grid, kF32Threads, smem, s>>>(a1, a2, b1, b2, lse, delta, out_d,
                                         out_c, rows, cols, d, c);
  return (int)cudaGetLastError();
}

template <bool KEY_ROWS>
int dispatch_f32(const void* a1, const void* a2, const void* b1,
                 const void* b2, const float* lse, const float* delta,
                 void* out_d, void* out_c, int b, int rows, int cols, int d,
                 int c, cudaStream_t s) {
  const int w = d > c ? d : c;
#define ESF_LAUNCH(WP)                                                      \
  return launch_f32<WP, KEY_ROWS>(                                          \
      static_cast<const float*>(a1), static_cast<const float*>(a2),         \
      static_cast<const float*>(b1), static_cast<const float*>(b2), lse,    \
      delta, static_cast<float*>(out_d), static_cast<float*>(out_c), b,     \
      rows, cols, d, c, s)
  if (w <= 8) ESF_LAUNCH(8);
  if (w <= 16) ESF_LAUNCH(16);
  if (w <= 32) ESF_LAUNCH(32);
  if (w <= 64) ESF_LAUNCH(64);
  ESF_LAUNCH(128);
#undef ESF_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (scalar kernels), 1 = bfloat16 (tensor-core kernels).
// q (b, n, d), k (b, m, d), v (b, m, c), out and dout (b, n, c), and dq,
// dk, dv (the shapes of q, k, v) are contiguous in dtype; lse (b, n) holds
// the forward's float32 log-sum-exp, and delta is float32 (b, n) scratch.
// Three launches on the stream: (a), (b), (c). Returns the first CUDA
// error code, 0 if all three launched.
int flash_attention_backward_launch(int dtype, const void* q, const void* k,
                                    const void* v, const void* out,
                                    const void* dout, const float* lse,
                                    void* dq, void* dk, void* dv,
                                    float* delta, int b, int n, int m, int d,
                                    int c, void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || m <= 0 || d <= 0 || d > 128 ||
      c <= 0 || c > 128 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)b * n;
  const int blocks = (int)((rows + 255) / 256);
  if (dtype == 0)
    attention_bwd_delta_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(out), static_cast<const float*>(dout),
        delta, rows, c);
  else
    attention_bwd_delta_kernel<bf16><<<blocks, 256, 0, s>>>(
        static_cast<const bf16*>(out), static_cast<const bf16*>(dout), delta,
        rows, c);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  // (b): rows are keys; (c): rows are queries
  err = dtype == 0
            ? dispatch_f32<true>(k, v, q, dout, lse, delta, dk, dv, b, m, n,
                                 d, c, s)
            : dispatch_tc<true>(k, v, q, dout, lse, delta, dk, dv, b, m, n,
                                d, c, s);
  if (err != 0) return err;
  return dtype == 0 ? dispatch_f32<false>(q, dout, k, v, lse, delta, dq,
                                          nullptr, b, n, m, d, c, s)
                    : dispatch_tc<false>(q, dout, k, v, lse, delta, dq,
                                         nullptr, b, n, m, d, c, s);
}

}  // extern "C"
