// Flash attention for Hopper (sm_90a): softmax(q k^T) v in one launch per
// call, without writing the N x M logits anywhere.
//
// Replaces the Pallas TPU kernel
//   efficient_slowfast_tpu/ops/pallas/flash_attention.py::_flash_forward
//   (body _flash_kernel :83-109, pallas_call :139).
// It computes, for q (B, N, D), k (B, M, D), v (B, M, C) in float32 or
// bfloat16, with no scale on the logits:
//   out[b, i] = sum_j softmax_j(q[b, i] . k[b, j]) v[b, j]
// with f32 logits, the softmax running online over key tiles (running max,
// running sum, f32 accumulator), dividing by max(row_sum, 1e-30) and
// writing v's dtype, as the TPU kernel does. Unlike the TPU kernel it masks
// a key count that is not a multiple of the tile (keys >= M get logit -inf)
// and skips query rows >= N, and it takes any M, D and C (above 128 the
// float32 wide kernel and the bf16 cluster kernel, at the end of this
// file), B up to 65535. Given a non-null lse buffer, a launch also writes
// each row's float32 log-sum-exp, row max + log(row sum), from which the
// backward (flash_attention_bwd.cu) recomputes the probabilities; the
// serving path passes null, and the output is the same either way.
//
// What bounds it on the H100 at the CMDA-R50 serving shapes (bf16, 4 clips
// of 32 frames at 256^2; N = M = 32768, 32768, 8192, 2048 with
// D = C = 8, 32, 64, 128): the work is 4*B*N*M*C operations on 67 MB, about
// 11000 operations per byte, so it is bound by operations, not bytes:
// 764.5 GFLOP is 0.77 ms at the bf16 tensor-core peak, and the N*M
// exponentials (8.9e9) are 2.1 ms at 16 per clock per SM, which is the
// tighter floor where D = C <= 32. chip_smoke.py computes both per shape.
//
// bfloat16 (serving): both products on the tensor cores, FA2-style
// (flash_attention_tc_kernel; mma.sync m16n8k16, bf16 in, f32 accumulated,
// helpers in tensor_core.cuh). A warp owns 16 query rows of one batch
// entry; a block has 8 warps (128 rows), or 4 where D or C is 128, so that
// s4_fuse's 8192 rows still give every SM a block. D and C are zero-padded
// to DP, CP in {16, 32, 64, 128} in shared memory.
//   - q is copied to shared memory once and each warp keeps its 16 rows as
//     A fragments in registers (ldmatrix).
//   - k and v stream in tiles of 64 keys through a ring of three buffers
//     filled by 16-byte cp.async copies (zero-filled past M and past D or
//     C), a fixed, unrolled count per thread; one __syncthreads per tile.
//     Shared rows are padded by 16 bytes, so that the 8 rows of each
//     ldmatrix phase fall on 8 different bank groups (no conflicts, no
//     swizzle needed). Rows that are not 16-byte chunks (D or C not a
//     multiple of 8, or an unaligned pointer) take element-wise loads.
//   - S = q k^T: k is the B operand in its row-major (M, D) layout
//     (ldmatrix, no transpose), 16 x 64 logits per warp in f32. A warp
//     computes the next tile's S beside this tile's softmax: the two are
//     independent, so the tensor cores work while the exponentials wait.
//   - Softmax on S's accumulator registers: the four lanes of a quad own a
//     row; the tile's row max takes two shuffles, the accumulator and the
//     lane's part of the row sum are rescaled once per tile by
//     ex2((old max - new max) log2 e), and each probability is one FFMA
//     (log2 e and the max folded in) and one MUFU.EX2. The row sum adds the
//     unrounded f32 probabilities; the quad's parts meet once, at the end.
//     Only the last tile, where M is ragged, masks keys >= M (a separate
//     instance of the step).
//   - P is rounded once to bf16 (cvt.rn.bf16x2, two per instruction) and
//     the S accumulator registers become the A fragments of O += P v
//     directly, with no trip through shared memory; v is the B operand via
//     ldmatrix.trans of its row-major (M, C) layout.
//   FP32-pipe instructions per logit in the loop, by design: FMNMX 1 (max),
//   FFMA 1, FADD 1 (sum), F2FP 1/2, and the rescale's FMULs, CP/64 per
//   logit (amortised over the tile's 64 keys): 3.75 at D = C = 8 and 4 at
//   32, within the 8 that the ex2 rate leaves room for (128 FP32 lanes
//   against 16 MUFU.EX2 per clock per SM). chip_smoke.py counts them in
//   the main loop of the SASS.
// Rounding P to bf16 is what the TPU kernel does not do (it keeps P in f32
// for P v) and what FA2/FA3, SDPA and the JAX package's own dense path
// (ops/attention.py:57-58) do; chip_smoke.py's ATTN_BF16_TOL argues the
// error (at most 2^-9 max|v| before the output's own rounding).
//
// float32 (the tolerance checks): a first, simple version with scalar f32
// FMAs on the CUDA cores (flash_attention_kernel): a block of 256 threads owns 64
// query rows of one batch entry and keeps its q tile in shared memory. It
// streams the keys in tiles of 64:
//   1. S = q k^T for the 64 x 64 tile, each thread a 4 x 4 register tile over
//      D (q and k transposed in shared memory for 16-byte loads), scaled by
//      log2(e) so that the softmax can use exp2; masked keys get -inf.
//   2. Four threads own one query row and 16 of the tile's keys each (keys
//      sp, sp+4, ...): they take the row's tile max with two shuffles,
//      rescale their accumulator by exp2(old max - new max) and turn their
//      logits into probabilities in registers.
//   3. O += P V. For C <= 32 each of the four threads accumulates all C
//      columns over its own 16 keys, from the probabilities it holds, and
//      the four partial rows are summed with shuffles at the end. For C > 32
//      the accumulator would not fit one thread: the four threads split the
//      columns instead and read the row's probabilities back from shared
//      memory, each over all 64 keys.
// The only synchronisations are the two around each tile's loads and the
// one before its logits are read; steps 2 and 3 stay inside one warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows of one block
constexpr int kBK = 64;   // keys of one tile
constexpr int kPad = 4;   // row padding of the shared tiles, in floats
constexpr int kLdT = kBQ + kPad;  // leading dim of transposed q/k tiles, logits
constexpr int kKeysPerThread = kBK / 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

// Floats of shared memory: q^T and k^T (d x kLdT each), v (kBK x (cp + kPad)),
// logits (kBQ x kLdT).
__host__ __device__ inline size_t smem_floats(int d, int cp) {
  return (size_t)2 * d * kLdT + (size_t)kBK * (cp + kPad) + (size_t)kBQ * kLdT;
}

// CP: C padded to 8, 16, 32, 64 or 128 (zero columns beyond C).
template <typename T, int CP>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int n, int m, int d, int c) {
  constexpr bool kKeySplit = CP <= 32;   // else the 4 threads split C
  constexpr int kAcc = kKeySplit ? CP : CP / 4;
  constexpr int kLdV = CP + kPad;
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned
  float* qs = reinterpret_cast<float*>(smem4);  // [d][kLdT]  q^T
  float* ks = qs + d * kLdT;         // [d][kLdT]  k^T
  float* vs = ks + d * kLdT;         // [kBK][kLdV]
  float* ss = vs + kBK * kLdV;       // [kBQ][kLdT] logits, then P (C > 32)

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const size_t bi = blockIdx.y;
  const T* qb = q + bi * n * d;
  const T* kb = k + bi * m * d;
  const T* vb = v + bi * m * c;

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, j = i - r * d;
    qs[j * kLdT + r] = q0 + r < n ? to_f(qb[(size_t)(q0 + r) * d + j]) : 0.f;
  }

  // step 1's 4x4 tile: rows r1.., keys c1..
  const int r1 = (tid >> 4) * 4, c1 = (tid & 15) * 4;
  // steps 2-3: row sr, part sp of 4
  const int sr = tid >> 2, sp = tid & 3;
  float* srow = ss + sr * kLdT;
  float row_max = -INFINITY, row_sum = 0.f;  // log2 units
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < m; k0 += kBK) {
    __syncthreads();  // the last tile's k, v and logits are no longer read
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, j = i - r * d;
      ks[j * kLdT + r] = k0 + r < m ? to_f(kb[(size_t)(k0 + r) * d + j]) : 0.f;
    }
    for (int i = tid; i < kBK * CP; i += kThreads) {
      const int r = i / CP, j = i % CP;
      vs[r * kLdV + j] =
          k0 + r < m && j < c ? to_f(vb[(size_t)(k0 + r) * c + j]) : 0.f;
    }
    __syncthreads();

    // 1. logits of the tile, in log2 units
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int e = 0; e < d; ++e) {
        const float4 a = *reinterpret_cast<const float4*>(qs + e * kLdT + r1);
        const float4 b = *reinterpret_cast<const float4*>(ks + e * kLdT + c1);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4 o;
        o.x = k0 + c1 + 0 < m ? s[i][0] * kLog2e : -INFINITY;
        o.y = k0 + c1 + 1 < m ? s[i][1] * kLog2e : -INFINITY;
        o.z = k0 + c1 + 2 < m ? s[i][2] * kLog2e : -INFINITY;
        o.w = k0 + c1 + 3 < m ? s[i][3] * kLog2e : -INFINITY;
        *reinterpret_cast<float4*>(ss + (r1 + i) * kLdT + c1) = o;
      }
    }
    __syncthreads();

    // 2. online softmax of row sr over keys sp, sp + 4, ...
    float p[kKeysPerThread];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < kKeysPerThread; ++t) {
      p[t] = srow[sp + 4 * t];
      mx = fmaxf(mx, p[t]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float new_max = fmaxf(row_max, mx);  // finite: a tile has a key < m
    const float corr = exp2f(row_max - new_max);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kKeysPerThread; ++t) {
      p[t] = exp2f(p[t] - new_max);
      sum += p[t];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    row_sum = row_sum * corr + sum;
    row_max = new_max;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] *= corr;

    // 3. acc += P V
    if constexpr (kKeySplit) {
#pragma unroll
      for (int t = 0; t < kKeysPerThread; ++t) {
        const float* vr = vs + (sp + 4 * t) * kLdV;
#pragma unroll
        for (int j = 0; j < CP; j += 4) {
          const float4 w = *reinterpret_cast<const float4*>(vr + j);
          acc[j] = fmaf(p[t], w.x, acc[j]);
          acc[j + 1] = fmaf(p[t], w.y, acc[j + 1]);
          acc[j + 2] = fmaf(p[t], w.z, acc[j + 2]);
          acc[j + 3] = fmaf(p[t], w.w, acc[j + 3]);
        }
      }
    } else {
      // columns of this thread: sp*4 + 16u + e, so that the four threads
      // of a row read neighbouring 16-byte words of a v row
#pragma unroll
      for (int t = 0; t < kKeysPerThread; ++t) srow[sp + 4 * t] = p[t];
      __syncwarp();
      for (int kk = 0; kk < kBK; ++kk) {
        const float pk = srow[kk];
        const float* vr = vs + kk * kLdV + sp * 4;
#pragma unroll
        for (int u = 0; u < CP / 16; ++u) {
          const float4 w = *reinterpret_cast<const float4*>(vr + 16 * u);
          acc[4 * u] = fmaf(pk, w.x, acc[4 * u]);
          acc[4 * u + 1] = fmaf(pk, w.y, acc[4 * u + 1]);
          acc[4 * u + 2] = fmaf(pk, w.z, acc[4 * u + 2]);
          acc[4 * u + 3] = fmaf(pk, w.w, acc[4 * u + 3]);
        }
      }
    }
  }

  const int row = q0 + sr;
  const float denom = fmaxf(row_sum, 1e-30f);
  if (lse != nullptr && sp == 0 && row < n)  // row_max is in log2 units
    lse[bi * n + row] = row_max * kLn2 + logf(row_sum);
  T* orow = out + (bi * n + row) * c;
  if constexpr (kKeySplit) {
#pragma unroll
    for (int j = 0; j < CP; ++j) {
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 1);
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 2);
    }
    if (row < n) {
#pragma unroll
      for (int j = 0; j < CP; ++j)
        if ((j & 3) == sp && j < c) orow[j] = from_f<T>(acc[j] / denom);
    }
  } else if (row < n) {
#pragma unroll
    for (int u = 0; u < CP / 16; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = sp * 4 + 16 * u + e;
        if (j < c) orow[j] = from_f<T>(acc[4 * u + e] / denom);
      }
  }
}

template <typename T, int CP>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int b, int n, int m, int d, int c, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, CP>;
  const size_t smem = smem_floats(d, CP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBQ - 1) / kBQ, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, n, m, d, c);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             float* lse, int b, int n, int m, int d, int c, cudaStream_t s) {
  if (c <= 8) return launch<T, 8>(q, k, v, out, lse, b, n, m, d, c, s);
  if (c <= 16) return launch<T, 16>(q, k, v, out, lse, b, n, m, d, c, s);
  if (c <= 32) return launch<T, 32>(q, k, v, out, lse, b, n, m, d, c, s);
  if (c <= 64) return launch<T, 64>(q, k, v, out, lse, b, n, m, d, c, s);
  return launch<T, 128>(q, k, v, out, lse, b, n, m, d, c, s);
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel.

using bf16 = __nv_bfloat16;

constexpr int kTcBK = 64;     // keys of one tile
constexpr int kTcNT = kTcBK / 8;  // 8-key column tiles of a logit tile
constexpr int kTcStages = 3;  // k/v tile buffers: two read, one filling
constexpr int kTcPad = tc::kSmemPad;  // bf16 padding of each shared row

// Shared memory of the bf16 kernel: q (rows x DP), then kTcStages k tiles
// (kTcBK x DP) and kTcStages v tiles (kTcBK x CP), rows padded by kTcPad.
__host__ __device__ inline size_t tc_smem_bytes(int rows, int dp, int cp) {
  return sizeof(bf16) * ((size_t)(rows + kTcStages * kTcBK) * (dp + kTcPad) +
                         (size_t)kTcStages * kTcBK * (cp + kTcPad));
}

// S = q k^T for one tile of keys, 16 rows x 64 keys per warp. kt: the
// lane's ldmatrix row in the k tile; per 16 keys and 16 of D one ldmatrix
// gives the B fragments of two 8-key tiles.
template <int DP>
__device__ __forceinline__ void tile_logits(float (&s)[kTcNT][4],
                                            const uint32_t (&qf)[DP / 16][4],
                                            const bf16* kt) {
  constexpr int kLdK = DP + kTcPad;
#pragma unroll
  for (int nt = 0; nt < kTcNT; ++nt)
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int np = 0; np < kTcNT / 2; ++np)
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      uint32_t b[4];
      tc::ldmatrix_x4(b, kt + 16 * np * kLdK + 16 * kc);
      tc::mma_bf16_16816(s[2 * np], qf[kc], b[0], b[1]);
      tc::mma_bf16_16816(s[2 * np + 1], qf[kc], b[2], b[3]);
    }
}

// The online softmax of one tile's logits s (rows g and g + 8 of the
// warp's 16, as h = 0, 1), then O += P v. vt: the lane's ldmatrix row in
// the v tile.
template <int CP>
__device__ __forceinline__ void tile_softmax_pv(float (&s)[kTcNT][4],
                                                float (&o)[CP / 8][4],
                                                float (&row_max)[2],
                                                float (&row_sum)[2],
                                                const bf16* vt) {
  constexpr int kNT = kTcNT;
  constexpr int kLdV = CP + kTcPad;
  float mx[2] = {row_max[0], row_max[1]};
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
  }
  float ml[2];  // the new max in log2 units
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    // finite: a tile holds a key < m; the first tile's corr is ex2(-inf)
    const float corr = tc::ex2((row_max[h] - mx[h]) * kLog2e);
    row_max[h] = mx[h];
    ml[h] = mx[h] * kLog2e;
    row_sum[h] *= corr;
#pragma unroll
    for (int j = 0; j < CP / 8; ++j) {
      o[j][2 * h] *= corr;
      o[j][2 * h + 1] *= corr;
    }
  }
  uint32_t pf[kNT][2];  // P in bf16: rows g, g + 8 of each 8-key tile
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const float p0 = tc::ex2(fmaf(s[nt][0], kLog2e, -ml[0]));
    const float p1 = tc::ex2(fmaf(s[nt][1], kLog2e, -ml[0]));
    const float p2 = tc::ex2(fmaf(s[nt][2], kLog2e, -ml[1]));
    const float p3 = tc::ex2(fmaf(s[nt][3], kLog2e, -ml[1]));
    row_sum[0] += p0 + p1;
    row_sum[1] += p2 + p3;
    pf[nt][0] = tc::pack_bf16x2(p0, p1);
    pf[nt][1] = tc::pack_bf16x2(p2, p3);
  }
  // two 8-key tiles of P are one 16-key A fragment; per 16 keys and 16 of
  // C, one ldmatrix.trans gives two B fragments
#pragma unroll
  for (int kk = 0; kk < kTcBK / 16; ++kk) {
    const uint32_t a[4] = {pf[2 * kk][0], pf[2 * kk][1], pf[2 * kk + 1][0],
                           pf[2 * kk + 1][1]};
#pragma unroll
    for (int np = 0; np < CP / 16; ++np) {
      uint32_t b[4];
      tc::ldmatrix_x4_trans(b, vt + 16 * kk * kLdV + 16 * np);
      tc::mma_bf16_16816(o[2 * np], a, b[0], b[1]);
      tc::mma_bf16_16816(o[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// Warps of a block (16 query rows each) for D, C padded to DP, CP: 8 (128
// rows), or 4 where D or C is 128, so that the small s4_fuse grid (B N =
// 8192 rows) still gives every SM a block.
__host__ __device__ constexpr int tc_warps(int dp, int cp) {
  return dp == 128 || cp == 128 ? 4 : 8;
}

// DP, CP: D and C padded to 16, 32, 64 or 128. Where DP + CP <= 64 two
// blocks share an SM (at most 128 registers a thread).
template <int DP, int CP>
__global__ void
__launch_bounds__(32 * tc_warps(DP, CP), DP + CP <= 64 ? 2 : 1)
flash_attention_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          float* __restrict__ lse, int n, int m, int d, int c,
                          bool qk_vec, bool v_vec) {
  constexpr int kThreads = 32 * tc_warps(DP, CP), kRows = kThreads / 2;
  constexpr int kLdK = DP + kTcPad, kLdV = CP + kTcPad;
  constexpr int kKTile = kTcBK * kLdK, kVTile = kTcBK * kLdV;
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // [kRows][kLdK]
  bf16* ks = qs + kRows * kLdK;               // [kTcStages][kTcBK][kLdK]
  bf16* vs = ks + kTcStages * kKTile;         // [kTcStages][kTcBK][kLdV]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  // ldmatrix: lane supplies row lr of matrix 2 * l16 + l8
  const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
  const int k_lane = (lr + 8 * l16) * kLdK + 8 * l8;  // k: keys x D
  const int v_lane = (lr + 8 * l8) * kLdV + 8 * l16;  // v: keys x C, .trans
  const int q0 = blockIdx.x * kRows;
  const size_t bi = blockIdx.y;
  const bf16* qb = q + bi * n * d;
  const bf16* kb = k + bi * m * d;
  const bf16* vb = v + bi * m * c;
  const int tiles = (m + kTcBK - 1) / kTcBK, full = m / kTcBK;
  auto load_tile = [&](int it) {  // k and v of tile it, into its buffer
    const int buf = it % kTcStages;
    tc::load_rows<DP, kTcBK, kThreads>(ks + buf * kKTile, kb, it * kTcBK, m,
                                       d, qk_vec);
    tc::load_rows<CP, kTcBK, kThreads>(vs + buf * kVTile, vb, it * kTcBK, m,
                                       c, v_vec);
    tc::cp_async_commit();
  };

  tc::load_rows<DP, kRows, kThreads>(qs, qb, q0, n, d, qk_vec);
  load_tile(0);
  tc::cp_async_wait<0>();
  __syncthreads();
  if (tiles > 1) load_tile(1);

  uint32_t qf[DP / 16][4];  // this warp's 16 q rows as A fragments
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc)
    tc::ldmatrix_x4(qf[kc], qs + (16 * warp + lr + 8 * l8) * kLdK + 16 * kc +
                                8 * l16);
  float o[CP / 8][4];  // O of rows g, g + 8 (fragment layout)
#pragma unroll
  for (int j = 0; j < CP / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};  // logits of rows g, g + 8
  float row_sum[2] = {0.f, 0.f};  // this lane's part of their sums

  // Tile it: its logits s are ready, and the logits of tile it + 1
  // (s_next) are computed beside its softmax, independent of it, so that
  // the warp keeps the tensor cores busy while it waits on the
  // exponentials. ragged: the last tile, M not a multiple of kTcBK (a
  // separate instance, so that whole tiles carry no masking).
  auto step = [&](float (&s)[kTcNT][4], float (&s_next)[kTcNT][4], int it,
                  auto ragged) {
    if (it + 1 < tiles) {
      tc::cp_async_wait<0>();  // tile it + 1 has landed
      // ... for every thread, and all are past tile it - 1, whose buffers
      // tile it + 2 now fills
      __syncthreads();
      if (it + 2 < tiles) load_tile(it + 2);
    }
    if constexpr (decltype(ragged)::value) {  // keys >= m get -inf
      const int k0 = it * kTcBK;
#pragma unroll
      for (int nt = 0; nt < kTcNT; ++nt) {
        const int key = k0 + 8 * nt + 2 * t;
        if (key >= m) s[nt][0] = s[nt][2] = -INFINITY;
        if (key + 1 >= m) s[nt][1] = s[nt][3] = -INFINITY;
      }
    }
    // after the last tile this reads a stale buffer, and s_next is unused
    tile_logits<DP>(s_next, qf, ks + (it + 1) % kTcStages * kKTile + k_lane);
    tile_softmax_pv<CP>(s, o, row_max, row_sum,
                        vs + it % kTcStages * kVTile + v_lane);
  };
  const std::false_type whole{};
  const std::true_type ragged{};
  float sa[kTcNT][4], sb[kTcNT][4];
  tile_logits<DP>(sa, qf, ks + k_lane);
  int it = 0;
  for (; it + 1 < full; it += 2) {  // by two: s and s_next swap roles
    step(sa, sb, it, whole);
    step(sb, sa, it + 1, whole);
  }
  if (it < full) {  // an odd count of whole tiles
    step(sa, sb, it++, whole);
    if (it < tiles) step(sb, sa, it, ragged);
  } else if (it < tiles) {
    step(sa, sb, it, ragged);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 1);
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 2);
    const float denom = fmaxf(row_sum[h], 1e-30f);
    const int row = q0 + 16 * warp + g + 8 * h;
    if (row < n) {
      if (lse != nullptr && t == 0)
        lse[bi * n + row] = row_max[h] + logf(row_sum[h]);
      bf16* orow = out + (bi * n + row) * c;
#pragma unroll
      for (int j = 0; j < CP / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < c) orow[col] = __float2bfloat16_rn(o[j][2 * h] / denom);
        if (col + 1 < c)
          orow[col + 1] = __float2bfloat16_rn(o[j][2 * h + 1] / denom);
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int DP, int CP>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              float* lse, int b, int n, int m, int d, int c,
              cudaStream_t stream) {
  auto kernel = flash_attention_tc_kernel<DP, CP>;
  constexpr int kThreads = 32 * tc_warps(DP, CP), kRows = kThreads / 2;
  const size_t smem = tc_smem_bytes(kRows, DP, CP);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool qk_vec = d % 8 == 0 && aligned16(q) && aligned16(k);
  const bool v_vec = c % 8 == 0 && aligned16(v);
  const dim3 grid((n + kRows - 1) / kRows, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, n, m, d,
      c, qk_vec, v_vec);
  return (int)cudaGetLastError();
}

template <int DP>
int dispatch_tc_c(const void* q, const void* k, const void* v, void* out,
                  float* lse, int b, int n, int m, int d, int c,
                  cudaStream_t s) {
  if (c <= 16)
    return launch_tc<DP, 16>(q, k, v, out, lse, b, n, m, d, c, s);
  if (c <= 32)
    return launch_tc<DP, 32>(q, k, v, out, lse, b, n, m, d, c, s);
  if (c <= 64)
    return launch_tc<DP, 64>(q, k, v, out, lse, b, n, m, d, c, s);
  return launch_tc<DP, 128>(q, k, v, out, lse, b, n, m, d, c, s);
}

int dispatch_tc(const void* q, const void* k, const void* v, void* out,
                float* lse, int b, int n, int m, int d, int c,
                cudaStream_t s) {
  if (d <= 16)
    return dispatch_tc_c<16>(q, k, v, out, lse, b, n, m, d, c, s);
  if (d <= 32)
    return dispatch_tc_c<32>(q, k, v, out, lse, b, n, m, d, c, s);
  if (d <= 64)
    return dispatch_tc_c<64>(q, k, v, out, lse, b, n, m, d, c, s);
  return dispatch_tc_c<128>(q, k, v, out, lse, b, n, m, d, c, s);
}

// ---------------------------------------------------------------------------
// D or C above 128 (non-local blocks: D = C = 256 in s3, 512 in s4, 1024
// in res5). float32: the wide kernel below, whose grid dimension runs over
// 128-column slices of C: the blocks of slice z compute
// out[:, 128 z .. 128 z + 127] and each recomputes the logits over the
// whole of D, and their exponentials, so a call does ceil(C / 128) times
// the q k^T work of one pass and the bound counts it once. Still one
// launch per call. The slices' row maxima and sums are the same
// arithmetic in the same order, so they normalise alike; slice 0 writes
// the log-sum-exp. bfloat16: the cluster kernel at the end of this file.

constexpr int kWideCols = 128;  // columns of C a block owns

// float32 (the tolerance checks): 256 threads, 64 query rows, four threads
// a row, tiles of 32 keys. A thread reads its q row from global memory
// (through L1) and computes the logits of 8 of the tile's keys over D
// against k rows in shared memory, then the online softmax of the narrow
// kernel and its share of the 128 columns of P v. The k rows come in
// chunks of at most kWideF32DC columns of D (one chunk up to D = 512; rows
// of chunk + 1 floats: the four threads' keys fall in four banks), so any
// D fits shared memory; the logits' sums run over D in order either way.
constexpr int kWideF32BK = 32;
constexpr int kWideF32LdV = kWideCols + 4;
constexpr int kWideF32DC = 512;

__host__ __device__ inline int wide_f32_chunk(int d) {
  return d < kWideF32DC ? d : kWideF32DC;
}

__host__ __device__ inline size_t wide_f32_smem_floats(int d) {
  return (size_t)kWideF32BK * (wide_f32_chunk(d) + 1) +
         (size_t)kWideF32BK * kWideF32LdV + (size_t)kBQ * (kWideF32BK + 1);
}

__global__ void __launch_bounds__(kThreads)
flash_attention_wide_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ out, float* __restrict__ lse,
                            int n, int m, int d, int c) {
  constexpr int kBK = kWideF32BK, kKeys = kBK / 4;
  constexpr int kLdP = kBK + 1;
  const int dc = wide_f32_chunk(d), ldk = dc + 1;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [kBK][ldk]
  float* vs = ks + kBK * ldk;                   // [kBK][kWideF32LdV]
  float* ps = vs + kBK * kWideF32LdV;           // [kBQ][kLdP]
  const int tid = threadIdx.x, sr = tid >> 2, sp = tid & 3;
  const int row = blockIdx.x * kBQ + sr;
  const size_t bi = blockIdx.y;
  const int col0 = blockIdx.z * kWideCols;
  const float* qr = q + (bi * n + (row < n ? row : n - 1)) * d;
  const float* kb = k + bi * m * d;
  const float* vb = v + bi * m * c + col0;
  float* prow = ps + sr * kLdP;
  float row_max = -INFINITY, row_sum = 0.f;  // log2 units
  float acc[kWideCols / 4];
#pragma unroll
  for (int j = 0; j < kWideCols / 4; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < m; k0 += kBK) {
    __syncthreads();  // the last tile's k, v and P are no longer read
    for (int i = tid; i < kBK * kWideCols; i += kThreads) {
      const int r = i / kWideCols, j = i % kWideCols;
      vs[r * kWideF32LdV + j] = k0 + r < m && col0 + j < c
                                    ? vb[(size_t)(k0 + r) * c + j]
                                    : 0.f;
    }
    // logits of row sr at keys sp + 4 t, in log2 units, chunk by chunk
    float p[kKeys];
#pragma unroll
    for (int t = 0; t < kKeys; ++t) p[t] = 0.f;
    for (int e0 = 0; e0 < d; e0 += dc) {
      const int w = d - e0 < dc ? d - e0 : dc;
      if (e0 > 0) __syncthreads();  // the last chunk is no longer read
      for (int i = tid; i < kBK * w; i += kThreads) {
        const int r = i / w, j = i - r * w;
        ks[r * ldk + j] =
            k0 + r < m ? kb[(size_t)(k0 + r) * d + e0 + j] : 0.f;
      }
      __syncthreads();
      for (int e = 0; e < w; ++e) {
        const float qe = qr[e0 + e];
#pragma unroll
        for (int t = 0; t < kKeys; ++t)
          p[t] = fmaf(qe, ks[(sp + 4 * t) * ldk + e], p[t]);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < kKeys; ++t) {
      p[t] = k0 + sp + 4 * t < m ? p[t] * kLog2e : -INFINITY;
      mx = fmaxf(mx, p[t]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float new_max = fmaxf(row_max, mx);  // finite: a tile has a key < m
    const float corr = exp2f(row_max - new_max);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kKeys; ++t) {
      p[t] = exp2f(p[t] - new_max);
      sum += p[t];
      prow[sp + 4 * t] = p[t];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    row_sum = row_sum * corr + sum;
    row_max = new_max;
#pragma unroll
    for (int j = 0; j < kWideCols / 4; ++j) acc[j] *= corr;
    __syncwarp();  // the four threads of row sr share a warp
    // acc += P v over the slice: columns sp * 4 + 16 u + e of this thread
    for (int kk = 0; kk < kBK; ++kk) {
      const float pk = prow[kk];
      const float* vr = vs + kk * kWideF32LdV + sp * 4;
#pragma unroll
      for (int u = 0; u < kWideCols / 16; ++u) {
        const float4 w = *reinterpret_cast<const float4*>(vr + 16 * u);
        acc[4 * u] = fmaf(pk, w.x, acc[4 * u]);
        acc[4 * u + 1] = fmaf(pk, w.y, acc[4 * u + 1]);
        acc[4 * u + 2] = fmaf(pk, w.z, acc[4 * u + 2]);
        acc[4 * u + 3] = fmaf(pk, w.w, acc[4 * u + 3]);
      }
    }
  }

  if (row >= n) return;
  const float denom = fmaxf(row_sum, 1e-30f);
  if (lse != nullptr && blockIdx.z == 0 && sp == 0)  // log2 units
    lse[bi * n + row] = row_max * kLn2 + logf(row_sum);
  float* orow = out + (bi * n + row) * c + col0;
#pragma unroll
  for (int u = 0; u < kWideCols / 16; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = sp * 4 + 16 * u + e;
      if (col0 + j < c) orow[j] = acc[4 * u + e] / denom;
    }
}

int launch_wide_f32(const void* q, const void* k, const void* v, void* out,
                    float* lse, int b, int n, int m, int d, int c,
                    cudaStream_t stream) {
  const size_t smem = wide_f32_smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wide_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBQ - 1) / kBQ, b, (c + kWideCols - 1) / kWideCols);
  flash_attention_wide_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, n, m, d,
      c);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16, D or C above 128: the cluster kernel
// (flash_attention_tc_cluster_kernel<CW, MODE>), one launch a call, any D
// and C.
//
// What bounds it: at the non-local widths (D = C = 256 to 1024) the work
// is 2 B N M (D + C) operations on a few tens of MB, 800 or more per byte,
// so operations bound it; chip_smoke.py computes the bound per shape.
//
// Split (forward_split's plan). A tile of kClRows = 128 query rows belongs
// to G column groups (a grid dimension) of R blocks each (R = the plan's
// "cluster", a power of two up to 8): block r of group g owns the output
// columns [(g R + r) cs, (g R + r + 1) cs) (cs <= CW <= 256: the float32
// accumulator of 64 rows x CW columns a warpgroup is CW / 2 registers a
// thread), so G = ceil(C / 2048) groups hold any C. Where D is up to 256
// and C up to 2048 (MODE 0) every block computes the logits over all of D
// itself (R times a call: at (64, 2048) that took a third of the time of
// one block broadcasting them, PERF.md) and the blocks are no cluster.
// Else the R blocks of a group are one thread block cluster whose
// first P blocks (the "pushers") compute partial logits: pusher p owns the
// ds = kClDSlice = 256-column slices [p nds, (p + 1) nds) of D. For each
// tile of keys a pusher sends its partial to the other blocks of the
// cluster (push_partial: bulk copies into their shared memory), and each
// block adds the P partials in rank order, 0 first (sum_partials), so that
// every block of the group holds the same float32 logits, bit for bit, and
// runs the same softmax. So a group computes q k^T once and a call G times
// (forward_split's "recompute"), whatever D: where D fits one slice (C
// above 2048), one pusher computes the logits and the other blocks
// receive them. Each block then adds P v[:, its columns] into its own
// output columns.
//
// q. Up to D = 2048 (MODE 1, one slice a pusher; and MODE 0) a block's q
// slice (128 x 256) stays in shared memory for the whole call. Beyond
// (MODE 2) a pusher owns nds > 1 slices, whose q would not fit: a k stage
// then holds a slice of q beside the slice of k, the loads run over (tile,
// slice) in turn, and a tile's logits add up slice by slice, each slice's
// 16 k16 steps one wgmma group that is waited before the next slice's
// stage is read (no wgmma is in flight across the slice loop's back edge).
// q then streams from L2 once a tile.
//
// Inside a block, 256 threads: warpgroups 0 and 1, 64 query rows each.
// Thread 0 of a pusher also issues the TMA loads of q and k, thread 128
// those of v, into mbarrier full / empty rings (ks and vs stages of tiles
// of 64 keys, or 32 where the blocks exchange: the slots and the rings
// then fit shared memory). A warpgroup computes S = q k^T by wgmma with
// both operands in shared memory (f32 in registers), runs the online
// softmax in registers (the narrow kernel's arithmetic: f32 logits, ex2
// with the max folded in, row sums of the unrounded probabilities, the
// accumulator rescaled only where a row's max moved), rounds P once to
// bf16 and uses its registers as the A operand of the wgmma O += P v (v
// read MN-major in place, N = CW). S of the next tile is issued with P v
// of this one. Every operand is a tile of 64-column atoms in the 128-byte
// swizzle (hopper.cuh: make_sw128_tile_map, one TMA copy a tile;
// desc_sw128, desc_sw128_mn); TMA fills rows past N or M and columns past
// D or C with zeros, so ragged edges need no masking beyond keys >= m,
// which get -inf after the sum.
//
// The exchange: each warpgroup has a slot for every pusher's partial; the
// blocks signal each other by mbarriers (x_full: the pushes of a round have
// landed, by the copies' transaction bytes; x_free: every other block has
// read my last push, by its leader's remote arrival), never by a barrier
// of the whole cluster. Where P whole slots fit (beside resident q and
// three k stages: P up to 4) it is deferred: tile j + 1's partial is
// pushed right after tile j's sum and summed a tile later, so the copies
// fly while tile j's softmax and products run (S then runs two tiles
// ahead). Elsewhere a slot holds half a partial (the plan's "rounds" 2)
// and each tile's exchange is two rounds, at once.
//
// Registers set the block's shape: ptxas sizes a wgmma kernel's registers
// by whole warpgroups, and a consumer's 64 x CW float32 accumulator takes
// CW / 2 of them. With a producer warp (288 threads, sized as 384) every
// thread had 168, setmaxnreg or not, and the CW = 256 accumulator spilled
// even beside 32-key tiles; two warpgroups have 255 each (PERF.md).
//
// Shared memory (cluster_smem_bytes, forward_split's arithmetic): q (128 x
// 256, MODE 0 and 1), ks k stages (keys x 256, beside a 128 x 256 slice of
// q in MODE 2), vs v stages (keys x CW), the exchange's slots (128 x 32
// float32 for each pusher, halved over two rounds), 256 bytes of
// mbarriers, 1024 bytes of alignment. At D = C = 1024 (R = P = 4, cs =
// 256, three stages each) that is 64 + 48 + 48 + 64 KB of the 227 KB a
// block may have; at D = C = 3072 (G = 2, R = 8, P = 4 pushers of 3
// slices, two stages each, the slots halved) 160 + 32 + 32 KB.
// D and C must be multiples of 64 and the data 16-byte aligned (the TMA
// maps): the wrapper gives other inputs zero-padded copies, which is exact.
// The output has no atomics and is bit-identical from call to call.

constexpr int kClRows = 128;     // query rows of a block
// columns of D in a block's logits: four 64-column atoms, whose 16 k16
// steps a wgmma chain takes unrolled (a loop over the atoms carries the
// accumulator across its back edge, and ptxas then serializes the chain,
// its C7519)
constexpr int kClDSlice = 256;
constexpr int kClExchangeKeys = 32;  // keys of a tile where blocks exchange
constexpr int kClThreads = 256;  // two consumer warpgroups
constexpr int kClMinStages = 2;  // of each ring
constexpr int kClMaxStages = 3;
constexpr int kClBarrierBytes = 256;
constexpr int kClSmemLimit = 232448;  // dynamic shared memory of a block

// The exchange's slots: a partial (64 rows x 32 keys float32), or its half
// where a tile's exchange takes two rounds, for each warpgroup and pusher.
__host__ __device__ inline size_t cluster_slot_bytes(int pushers,
                                                     int rounds) {
  return (size_t)2 * pushers * 64 * kClExchangeKeys * 4 / rounds;
}

// (+ 1024: the tiles start at a 1024-byte boundary, as the swizzle needs)
__host__ __device__ inline size_t cluster_smem_bytes(int mode, int width,
                                                     int keys, int ks, int vs,
                                                     int pushers,
                                                     int rounds) {
  const size_t q = mode == 2 ? 0 : (size_t)kClRows * kClDSlice;
  const size_t stage = (size_t)(mode == 2 ? kClRows + keys : keys) *
                       kClDSlice;
  return 2 * (q + ks * stage + (size_t)vs * keys * width) +
         (mode > 0 ? cluster_slot_bytes(pushers, rounds) : 0) +
         kClBarrierBytes + 1024;
}

struct ClusterArgs {
  bf16* out;
  float* lse;
  int n, m, c;
  int split;    // R: blocks of a column group (a cluster where R > 1)
  int pushers;  // P: its blocks that compute partial logits
  int nds;      // kClDSlice-column slices of D a pusher owns
  int cs;       // C columns of a block's slice
  int ks, vs;   // ring stages of k and of v
  int rounds;   // of a tile's exchange
};

// The exchange of partial logits between the blocks of a cluster, a round
// at a time. Slot [wg][p] holds pusher p's partial for warpgroup wg in
// rounds of kF4 float4 a thread, float4 i of thread t128 at [i][t128].
// push_partial (pushers only): once every other block has read my last
// push (x_free: each one's leader arrives there), the warpgroup writes
// floats [e0, e0 + 4 kF4) of its partial into its own slot, and its leader
// pushes that slot into the same slot of every other block by bulk
// copies, which complete on that block's x_full. sum_partials: once every
// pusher's push of the round has landed, the warpgroup adds the P slots in
// rank order into the same floats and frees them (an arrival on every
// other pusher's x_free).
struct Exchange {
  float4* wslots;  // this warpgroup's slots
  uint64_t* full;
  uint64_t* free;
  int split, pushers, rank, t128, wg;
};

template <int kF4, int NS>
__device__ __forceinline__ void push_partial(const Exchange& x,
                                             const float (&s)[NS], int e0,
                                             uint32_t round) {
  constexpr uint32_t kBytes = kF4 * 128 * 16;
  if (x.rank >= x.pushers) return;  // the whole block alike
  float4* mine = x.wslots + x.rank * kF4 * 128;
  const bool leader = x.t128 == 0;
  if (leader && round >= 1) hp::mbar_wait_cluster(x.free, (round - 1) & 1);
  hp::named_barrier(1 + x.wg, 128);
#pragma unroll
  for (int i = 0; i < kF4; ++i) {
    const int e = e0 + 4 * i;
    mine[i * 128 + x.t128] = make_float4(s[e], s[e + 1], s[e + 2], s[e + 3]);
  }
  hp::fence_proxy_async();  // the copies read what the threads wrote
  hp::named_barrier(1 + x.wg, 128);
  if (leader) {
    hp::mbar_arrive_expect_tx(x.full, (x.pushers - 1) * kBytes);
    for (int r = 0; r < x.split; ++r)
      if (r != x.rank)
        hp::bulk_copy_cluster(hp::cluster_addr(mine, r), mine, kBytes,
                              hp::cluster_addr(x.full, r));
  }
}

template <int kF4, int NS>
__device__ __forceinline__ void sum_partials(const Exchange& x,
                                             float (&s)[NS], int e0,
                                             uint32_t round) {
  constexpr uint32_t kBytes = kF4 * 128 * 16;
  // a block that pushes nothing expects the P pushes on its own arrival
  if (x.rank >= x.pushers && x.t128 == 0)
    hp::mbar_arrive_expect_tx(x.full, x.pushers * kBytes);
  hp::mbar_wait_cluster(x.full, round & 1);
  for (int r = 0; r < x.pushers; ++r) {
    const float4* slot = x.wslots + r * kF4 * 128 + x.t128;
#pragma unroll
    for (int i = 0; i < kF4; ++i) {
      const float4 v = slot[i * 128];
      const int e = e0 + 4 * i;
      if (r == 0) {
        s[e] = v.x, s[e + 1] = v.y, s[e + 2] = v.z, s[e + 3] = v.w;
      } else {
        s[e] += v.x, s[e + 1] += v.y, s[e + 2] += v.z, s[e + 3] += v.w;
      }
    }
  }
  hp::named_barrier(1 + x.wg, 128);  // the slots are read
  if (x.t128 == 0)
    for (int r = 0; r < x.pushers; ++r)
      if (r != x.rank) hp::mbar_arrive_cluster(x.free, r);
}

// A tile's exchange at once, in kRounds rounds (numbered from kRounds j);
// returns the last round's number.
template <int kRounds, int NS>
__device__ __forceinline__ uint32_t exchange_rounds(const Exchange& x,
                                                    float (&s)[NS], int j) {
  constexpr int kF4 = NS / 4 / kRounds;
#pragma unroll
  for (int h = 0; h < kRounds; ++h) {
    push_partial<kF4>(x, s, 4 * kF4 * h, kRounds * j + h);
    sum_partials<kF4>(x, s, 4 * kF4 * h, kRounds * j + h);
  }
  return kRounds * j + kRounds - 1;
}

// CW: the output columns a block accumulates (64, 128 or 256), at least
// its slice cs; MODE: 0 one block a query tile (tiles of 64 keys), 1 a
// cluster that exchanges partial logits, q resident, 2 the same with q
// streamed beside k (tiles of 32 keys where they exchange: the slots and
// the rings then fit shared memory).
template <int CW, int MODE>
__global__ void __launch_bounds__(kClThreads, 1)
flash_attention_tc_cluster_kernel(const __grid_constant__ CUtensorMap q_map,
                                  const __grid_constant__ CUtensorMap k_map,
                                  const __grid_constant__ CUtensorMap v_map,
                                  const ClusterArgs a) {
  constexpr bool kExchange = MODE > 0, kStream = MODE == 2;
  constexpr int BK = kExchange ? kClExchangeKeys : 64;
  constexpr int ds = kClDSlice;
  constexpr int kQElems = kClRows * ds;
  // a k stage: a slice of k (BK x ds), after a slice of q where q streams
  constexpr int kStage = (kStream ? kClRows + BK : BK) * ds;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // tiles of 64-column atoms, each [rows][64] bf16 in the 128-byte swizzle
  bf16* q_s = reinterpret_cast<bf16*>(smem);   // [ds / 64][kClRows][64]
  bf16* k_s = q_s + (kStream ? 0 : kQElems);   // [ks][(q), ds / 64][BK][64]
  bf16* v_s = k_s + a.ks * kStage;             // [vs][CW / 64][BK][64]
  unsigned char* x_bytes =
      reinterpret_cast<unsigned char*>(v_s + a.vs * BK * CW);
  float4* slots = reinterpret_cast<float4*>(x_bytes);  // [wg][p][f4][128]
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      x_bytes + (kExchange ? cluster_slot_bytes(a.pushers, a.rounds) : 0));
  uint64_t* q_full = bar;
  uint64_t* k_full = bar + 1;                  // [ks]
  uint64_t* k_empty = k_full + kClMaxStages;   // [ks]
  uint64_t* v_full = k_empty + kClMaxStages;   // [vs]
  uint64_t* v_empty = v_full + kClMaxStages;   // [vs]
  uint64_t* x_full = v_empty + kClMaxStages;   // [warpgroup]
  uint64_t* x_free = x_full + 2;               // [warpgroup]

  const int split = a.split, rank = blockIdx.x % split, group = blockIdx.z;
  const int q0 = blockIdx.x / split * kClRows, bi = blockIdx.y;
  const bool pusher = rank < a.pushers;  // MODE 0: every block
  const int dcol0 = kExchange ? rank * a.nds * ds : 0;
  const int ccol0 = (group * split + rank) * a.cs;
  const int tiles = (a.m + BK - 1) / BK;
  const int nds = kStream ? a.nds : 1;
  const int loads = tiles * nds;  // of the k ring: (tile, slice) in turn
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    hp::mbar_init(q_full, 1);
    for (int s = 0; s < kClMaxStages; ++s) {
      hp::mbar_init(&k_full[s], 1);
      hp::mbar_init(&k_empty[s], 256);
      hp::mbar_init(&v_full[s], 1);
      hp::mbar_init(&v_empty[s], 256);
    }
    if (kExchange)
      for (int i = 0; i < 2; ++i) {
        hp::mbar_init(&x_full[i], 1);
        hp::mbar_init(&x_free[i], split - 1);
      }
    hp::mbar_init_fence();
  }
  // every block of the cluster has its barriers before any arrives there
  if (kExchange)
    hp::cluster_sync();
  else
    __syncthreads();

  // TMA loads, one copy a tile (make_sw128_tile_map): thread 0 of a pusher
  // issues q's slice and k's, thread 128 v's; the rings' first stages
  // here, the rest as stages free up, each at least a tile ahead of its
  // use. Load l of the k ring: tile l / nds, slice l % nds of the pusher's
  // (and, where q streams, that slice of q).
  const int v_atoms = a.cs / 64;
  auto load_k = [&](int l) {
    const int s = l % a.ks, j = l / nds;
    const int atom = (dcol0 + (l - j * nds) * ds) / 64;
    uint64_t* full = &k_full[s];
    bf16* st = k_s + s * kStage;
    hp::mbar_arrive_expect_tx(full, kStage * 2);
    if constexpr (kStream) {
      hp::tma_load_4d(st, &q_map, full, 0, q0, atom, bi);
      st += kQElems;
    }
    hp::tma_load_4d(st, &k_map, full, 0, j * BK, atom, bi);
  };
  auto load_v = [&](int j) {
    uint64_t* full = &v_full[j % a.vs];
    hp::mbar_arrive_expect_tx(full, BK * 64 * v_atoms * 2);
    hp::tma_load_4d(v_s + j % a.vs * BK * CW, &v_map, full, 0, j * BK,
                    ccol0 / 64, bi);
  };
  const bool k_issuer = threadIdx.x == 0 && pusher;
  const bool v_issuer = threadIdx.x == 128;
  if (k_issuer) {
    hp::prefetch_tensormap(&q_map);
    hp::prefetch_tensormap(&k_map);
    if constexpr (!kStream) {
      hp::mbar_arrive_expect_tx(q_full, kQElems * 2);
      hp::tma_load_4d(q_s, &q_map, q_full, 0, q0, dcol0 / 64, bi);
    }
    for (int l = 0; l < a.ks && l < loads; ++l) load_k(l);
  }
  if (v_issuer) {
    hp::prefetch_tensormap(&v_map);
    for (int j = 0; j < a.vs && j < tiles; ++j) load_v(j);
  }

  // a consumer warpgroup: query rows q0 + 64 wg ..
  const int t128 = threadIdx.x % 128, warp = t128 / 32, lane = t128 % 32;
  const int g = lane / 4, t = lane % 4;
  float o[CW / 2];  // O, wgmma's accumulator layout (hopper.cuh)
#pragma unroll
  for (int i = 0; i < CW / 2; ++i) o[i] = 0.f;
  float row_max[2] = {-INFINITY, -INFINITY};  // rows g, g + 8 of the warp
  float row_sum[2] = {0.f, 0.f};              // this lane's part
  float s[BK / 2];   // S (64 rows x BK keys, f32) of the tile in softmax
  float sn[BK / 2];  // S of a later tile, as its wgmma leaves it
  // The 16 k16 steps of a slice of S into acc, the four of each 64-column
  // atom 32 bytes apart (q, k: this warpgroup's rows of the slice's
  // tiles). A descriptor's start address is its low bits in 16-byte units,
  // so each step's is the tile's plus an immediate; the base is taken anew
  // each tile, so that the compiler does not keep sixteen descriptors live
  // across the loop.
  auto slice_logits = [&](float (&acc)[BK / 2], const bf16* q,
                          const bf16* k, bool accumulate) {
    const uint64_t qd = hp::desc_sw128(hp::opaque(q + 64 * wg * 64));
    const uint64_t kd = hp::desc_sw128(k);
#pragma unroll
    for (int kk = 0; kk < ds / 16; ++kk)  // atom kk / 4, 32 bytes a step
      hp::Wgmma<BK, 0, 0>::run(
          acc, qd + (kk / 4 * kClRows * 128 + kk % 4 * 32) / 16,
          kd + (kk / 4 * BK * 128 + kk % 4 * 32) / 16, accumulate || kk > 0);
  };
  // S of tile j into acc: q resident, one wgmma group, committed and not
  // waited, its k stage released by the caller; q streamed, a group a
  // slice, each waited and its stage released (and refilled) here
  auto issue_logits = [&](float (&acc)[BK / 2], int j) {
    if constexpr (kStream) {
      for (int i = 0; i < nds; ++i) {
        const int l = j * nds + i, st = l % a.ks;
        const bf16* stage = k_s + st * kStage;
        hp::mbar_wait_bounded(&k_full[st], (l / a.ks) & 1);
        hp::wgmma_fence();
        slice_logits(acc, stage, stage + kQElems, i > 0);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(acc);
        hp::mbar_arrive(&k_empty[st]);
        if (k_issuer && l + a.ks < loads) {
          hp::mbar_wait_bounded(&k_empty[st], (l / a.ks) & 1);
          load_k(l + a.ks);
        }
        __syncwarp();
      }
    } else {
      slice_logits(acc, q_s, k_s + j % a.ks * kStage, false);
      hp::wgmma_commit();
    }
  };
  // The exchange. Deferred (one round a tile), tile j + 1's partial is
  // pushed right after tile j's sum, and its own sum waits a tile, so the
  // copies fly while tile j's softmax and products run (S runs two tiles
  // ahead; with q resident a k ring of three stages). Else each tile's
  // exchange is two rounds, at once.
  const int slot_f4 = BK / 8 / a.rounds;  // float4 a round
  const Exchange xc{slots + wg * a.pushers * slot_f4 * 128, &x_full[wg],
                    &x_free[wg], split, a.pushers, rank, t128, wg};
  const bool deferred = kExchange && a.rounds == 1;
  const int ahead = deferred ? 2 : 1;  // S runs this many tiles ahead
  uint32_t last_round = 0;
  auto exchange_now = [&](float (&acc)[BK / 2], int j) {
    if constexpr (kExchange) {
      last_round = a.rounds == 1 ? exchange_rounds<1>(xc, acc, j)
                                 : exchange_rounds<2>(xc, acc, j);
    }
  };
  if (pusher) {
    if constexpr (!kStream) {
      hp::mbar_wait_bounded(q_full, 0);
      hp::mbar_wait_bounded(&k_full[0], 0);
    }
    hp::wgmma_fence();
    issue_logits(s, 0);
    hp::wgmma_wait<0>();
    hp::fence_regs(s);
    if constexpr (!kStream) hp::mbar_arrive(&k_empty[0]);
  }
  if (deferred) {
    push_partial<BK / 8>(xc, s, 0, 0);
    if (tiles > 1 && pusher) {
      if constexpr (!kStream) hp::mbar_wait_bounded(&k_full[1], 0);
      hp::wgmma_fence();
      issue_logits(sn, 1);
      hp::wgmma_wait<0>();
      hp::fence_regs(sn);
      if constexpr (!kStream) hp::mbar_arrive(&k_empty[1]);
    }
  } else {
    exchange_now(s, 0);
  }

  // Tile j: its softmax, then S of tile j + ahead and P v of tile j issued
  // together; without a deferred exchange, tile j + 1's runs while P v is
  // on the tensor cores.
  for (int j = 0; j < tiles; ++j) {
    if (deferred) {
      sum_partials<BK / 8>(xc, s, 0, j);
      if (j + 1 < tiles) push_partial<BK / 8>(xc, sn, 0, j + 1);
      last_round = j;
    }
    const int key0 = j * BK;
    if (key0 + BK > a.m) {  // keys >= m get -inf
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        const int key = key0 + 8 * jj + 2 * t;
        if (key >= a.m) s[4 * jj] = s[4 * jj + 2] = -INFINITY;
        if (key + 1 >= a.m) s[4 * jj + 1] = s[4 * jj + 3] = -INFINITY;
      }
    }
    // the online softmax: element 4 jj + e is row g + 8 (e / 2), key
    // 8 jj + 2 t + (e % 2)
    float mx[2] = {row_max[0], row_max[1]};
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * jj], s[4 * jj + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
    }
    float ml[2];  // the new max in log2 units
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      // finite: a tile holds a key < m; the first tile's corr is ex2(-inf)
      const float corr = tc::ex2((row_max[h] - mx[h]) * kLog2e);
      row_max[h] = mx[h];
      ml[h] = mx[h] * kLog2e;
      row_sum[h] *= corr;
      if (corr != 1.f) {  // the row's max moved (exact to skip at 1)
#pragma unroll
        for (int jj = 0; jj < CW / 8; ++jj) {
          o[4 * jj + 2 * h] *= corr;
          o[4 * jj + 2 * h + 1] *= corr;
        }
      }
    }
    // P in bf16 as the A fragments of the BK / 16 k16 steps over the
    // tile's keys (hopper.cuh: register r of step kk holds elements
    // 8 kk + 2 r, + 1, of row g + 8 (r % 2))
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 8 * kk + 2 * r, h = r & 1;
        const float p0 = tc::ex2(fmaf(s[e], kLog2e, -ml[h]));
        const float p1 = tc::ex2(fmaf(s[e + 1], kLog2e, -ml[h]));
        row_sum[h] += p0 + p1;
        pa[kk][r] = tc::pack_bf16x2(p0, p1);
      }

    const int jn = j + ahead;
    const bool next = jn < tiles, logits = next && pusher;
    if (logits && !kStream)
      hp::mbar_wait_bounded(&k_full[jn % a.ks], (jn / a.ks) & 1);
    hp::mbar_wait_bounded(&v_full[j % a.vs], (j / a.vs) & 1);
    const bf16* vt = v_s + j % a.vs * BK * CW;
    hp::wgmma_fence();
    if (logits) issue_logits(sn, jn);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hp::WgmmaRs<CW, 1>::run(
          o, pa[kk], hp::desc_sw128_mn(vt + 16 * kk * 64, BK * 128), 1);
    hp::wgmma_commit();
    if (next) {
      hp::wgmma_wait<1>();  // S of tile jn; P v may run on
      hp::fence_regs(sn);
      if (logits && !kStream) hp::mbar_arrive(&k_empty[jn % a.ks]);
      if (!deferred) {  // the next tile's S, summed over the cluster now
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = sn[i];
        exchange_now(s, jn);
      }
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hp::fence_regs(pa[kk]);
    hp::mbar_arrive(&v_empty[j % a.vs]);
    // refills: k for tile j + ks (q resident) and v for tile j + vs, into
    // the stages that tile j's products freed, once the other warpgroup's
    // are done too
    if (!kStream && k_issuer && j + a.ks < tiles) {
      hp::mbar_wait_bounded(&k_empty[j % a.ks], (j / a.ks) & 1);
      load_k(j + a.ks);
    }
    if (v_issuer && j + a.vs < tiles) {
      hp::mbar_wait_bounded(&v_empty[j % a.vs], (j / a.vs) & 1);
      load_v(j + a.vs);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 1);
    row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 2);
    const float denom = fmaxf(row_sum[h], 1e-30f);
    const int row = q0 + 64 * wg + 16 * warp + g + 8 * h;
    if (row < a.n) {
      if (a.lse != nullptr && rank == 0 && group == 0 && t == 0)
        a.lse[(size_t)bi * a.n + row] = row_max[h] + logf(row_sum[h]);
      bf16* orow = a.out + ((size_t)bi * a.n + row) * a.c + ccol0;
#pragma unroll
      for (int jj = 0; jj < CW / 8; ++jj) {
        const int col = 8 * jj + 2 * t;
        if (col < a.cs && ccol0 + col < a.c)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[4 * jj + 2 * h] / denom,
                                    o[4 * jj + 2 * h + 1] / denom);
      }
    }
  }
  // a pusher keeps its shared memory until every other block has read its
  // last push (after that no block writes or arrives here)
  if (kExchange && pusher && t128 == 0)
    hp::mbar_wait_cluster(xc.free, last_round & 1);
}

template <int CW, int MODE>
int launch_cluster(const CUtensorMap& q_map, const CUtensorMap& k_map,
                   const CUtensorMap& v_map, const ClusterArgs& a, int b,
                   int groups, size_t smem, cudaStream_t stream) {
  auto kernel = flash_attention_tc_cluster_kernel<CW, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.split * ((a.n + kClRows - 1) / kClRows), b, groups);
  cfg.blockDim = dim3(kClThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = MODE > 0 ? a.split : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, q_map, k_map, v_map, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_cluster_mode(int width, const CUtensorMap& q_map,
                        const CUtensorMap& k_map, const CUtensorMap& v_map,
                        const ClusterArgs& a, int b, int groups, size_t smem,
                        cudaStream_t s) {
  if (width == 64)
    return launch_cluster<64, MODE>(q_map, k_map, v_map, a, b, groups, smem,
                                    s);
  if (width == 128)
    return launch_cluster<128, MODE>(q_map, k_map, v_map, a, b, groups, smem,
                                     s);
  return launch_cluster<256, MODE>(q_map, k_map, v_map, a, b, groups, smem,
                                   s);
}

template <int CW, int MODE>
int cluster_smem_attr() {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(
      &attr, flash_attention_tc_cluster_kernel<CW, MODE>);
  return err == cudaSuccess ? attr.maxDynamicSharedSizeBytes : -(int)err;
}

template <int MODE>
int cluster_smem_attr_mode(int width) {
  if (width == 64) return cluster_smem_attr<64, MODE>();
  if (width == 128) return cluster_smem_attr<128, MODE>();
  if (width == 256) return cluster_smem_attr<256, MODE>();
  return -(int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (scalar kernel; D or C above 128 the wide one), 1 =
// bfloat16 (tensor-core kernel, D and C up to 128; wider bf16 calls go to
// flash_attention_cluster_launch with their plan, and are refused here).
// q (b, n, d), k (b, m, d), v (b, m, c) and out (b, n, c) are contiguous.
// lse: null, or a float32 (b, n) buffer that receives each row's
// log-sum-exp of its logits, max + log(sum of exp(logit - max)), for the
// backward. Returns the CUDA error code of the launch.
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* out, float* lse, int b, int n,
                           int m, int d, int c, void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || m <= 0 || d <= 0 || c <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d > 128 || c > 128) {
    if (dtype == 0) return launch_wide_f32(q, k, v, out, lse, b, n, m, d, c, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, lse, b, n, m, d, c, s);
  if (dtype == 1) return dispatch_tc(q, k, v, out, lse, b, n, m, d, c, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory bytes of one block of the cluster kernel in MODE mode.
size_t flash_attention_cluster_smem(int mode, int width, int keys, int ks,
                                    int vs, int pushers, int rounds) {
  return cluster_smem_bytes(mode, width, keys, ks, vs, pushers, rounds);
}

// The dynamic shared memory attribute of the cluster kernel of (width,
// mode) (what its last launch set), or a negative CUDA error code.
int flash_attention_cluster_smem_attr(int width, int mode) {
  if (mode == 0) return cluster_smem_attr_mode<0>(width);
  if (mode == 1) return cluster_smem_attr_mode<1>(width);
  if (mode == 2) return cluster_smem_attr_mode<2>(width);
  return -(int)cudaErrorInvalidValue;
}

// bfloat16 with D or C above 128: the cluster kernel on the plan {split,
// exchange, pushers, groups, nds, cs, width, keys, ks, vs, rounds, smem}
// of the wrapper's forward_split (its fields "cluster", "exchange",
// "pushers", "groups", "slices", "c_slice", "width", "keys", "k_stages",
// "v_stages", "rounds", "smem"); its mode is 0 without the exchange (each
// block computes the logits), else 2 where nds > 1, else 1.
// D and C multiples of 64, the tensors 16-byte aligned; lse as above. A
// plan the kernel cannot run returns cudaErrorInvalidValue; otherwise the
// CUDA error code of the launch.
int flash_attention_cluster_launch(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int b, int n, int m, int d, int c,
                                   const int* plan, void* stream) {
  const int split = plan[0], exchange = plan[1], pushers = plan[2];
  const int groups = plan[3], nds = plan[4], cs = plan[5], width = plan[6];
  const int keys = plan[7], ks = plan[8], vs = plan[9], rounds = plan[10];
  const int smem = plan[11];
  const int mode = exchange == 0 ? 0 : nds > 1 ? 2 : 1;
  const long long d_cols =
      (long long)(mode == 0 ? 1 : pushers) * nds * kClDSlice;
  const bool ok =
      b > 0 && b <= 65535 && n > 0 && m > 0 && d > 0 && c > 0 &&
      d % 64 == 0 && c % 64 == 0 && aligned16(q) && aligned16(k) &&
      aligned16(v) && aligned16(out) &&
      (split == 1 || split == 2 || split == 4 || split == 8) &&
      (exchange == 0 || exchange == 1) && pushers >= 1 &&
      pushers <= split && nds >= 1 && groups >= 1 && groups <= 65535 &&
      // the pushers' slices cover D, and each holds a column of it
      d_cols >= d && d_cols - (long long)nds * kClDSlice < d &&
      (mode == 0 ? keys == 64 && rounds == 1 && groups == 1 && nds == 1 &&
                       pushers == split
                 : split > 1 && keys == kClExchangeKeys &&
                       (rounds == 1 || rounds == 2)) &&
      // deferred with q resident (one round): S two tiles ahead, three k
      // stages
      (mode != 1 || rounds != 1 || ks == 3) &&
      (width == 64 || width == 128 || width == 256) && cs > 0 &&
      cs % 64 == 0 && cs <= width &&
      (long long)cs * split * groups >= c && ks >= kClMinStages &&
      ks <= kClMaxStages && vs >= kClMinStages && vs <= kClMaxStages &&
      smem > 0 &&
      (size_t)smem ==
          cluster_smem_bytes(mode, width, keys, ks, vs, pushers, rounds) &&
      smem <= kClSmemLimit &&
      (long long)split * ((n + kClRows - 1) / kClRows) <= 0x7fffffff;
  if (!ok) return (int)cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  if (!hp::make_sw128_tile_map(&q_map, q, b, n, d, kClRows, kClDSlice / 64) ||
      !hp::make_sw128_tile_map(&k_map, k, b, m, d, keys, kClDSlice / 64) ||
      !hp::make_sw128_tile_map(&v_map, v, b, m, c, keys, cs / 64))
    return (int)cudaErrorInvalidValue;
  const ClusterArgs a{static_cast<bf16*>(out), lse, n, m, c, split, pushers,
                      nds, cs, ks, vs, rounds};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    return launch_cluster_mode<0>(width, q_map, k_map, v_map, a, b, groups,
                                  smem, s);
  if (mode == 1)
    return launch_cluster_mode<1>(width, q_map, k_map, v_map, a, b, groups,
                                  smem, s);
  return launch_cluster_mode<2>(width, q_map, k_map, v_map, a, b, groups,
                                smem, s);
}

}  // extern "C"
