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
//
// What bounds it on the H100 at the CMDA-R50 training shapes (bf16, 8 clips
// of 32 frames at 224^2; N = M = 25088, 25088, 6272, 1568 with D = C = 8,
// 32, 64, 128): the five products are 2 N M (3D + 2C) operations per clip
// on a few tens of MB, so operations, not bytes, bound it: the N*M
// exponentials at 16 per clock per SM where D = C <= 32 (s1/s2_fuse), the
// tensor cores above (s3/s4_fuse). chip_smoke.py computes the bound per
// shape.
//
// bfloat16 with D and C up to 128: three launches, (a) the prologue, (b)
// one pass, (c) dQ. Above 128, at any width, the cluster kernel (its
// section below) takes (b), with the columns split over a thread block
// cluster (and over column groups of clusters beyond 2048).
//   (a) attention_bwd_prologue_kernel: per query (lse log2 e, Dl) in
//       float32, rows padded to the query tile, and the float32 dQ
//       accumulator zeroed.
//   (b) attention_bwd_wgmma_kernel: a block owns Bc = 64 NWG keys of one
//       clip and makes one pass over all its query tiles of 64, so each
//       exponential and each of the five products is computed once: the
//       work the bound counts. Warpgroups 0 .. NWG-1 consume, 64 keys
//       each; warpgroup NWG produces (setmaxnreg moves its registers to
//       the consumers): one thread loads k and v once and
//       streams q, dO and the per-query statistics of each tile through a
//       ring of stages by TMA (an mbarrier "full" and "empty" per stage),
//       so loads overlap the products. Per tile a consumer computes
//         S^T = k q^T, dP^T = v dO^T          (wgmma, A and B in shared
//                                              memory, keys as M)
//         P^T = ex2(S^T log2 e - lse log2 e), dS^T = P^T o (dP^T - Dl)
//                                             (registers, one MUFU.EX2 per
//                                              element)
//         dV += P^T dO, dK += dS^T q          (wgmma with P^T and dS^T as
//                                              bf16 A fragments in
//                                              registers, dO and q read
//                                              MN-major in place)
//       and writes dS to shared memory in bf16; after a named barrier
//       over the consumers, dQ's part dS k (64 queries x WP) is one more
//       wgmma (its columns split over the warpgroups), staged in shared
//       memory as float32 and added to the clip's accumulator rows by one
//       bulk reduce-add (cp.reduce.async.bulk .add.f32). dS goes to shared
//       memory MN-major (the two queries of a register adjacent), one
//       4-byte store each.
//   (c) attention_bwd_dq_kernel: the accumulator to bf16 dQ.
// dQ is therefore NOT deterministic: the float32 adds of the key blocks'
// parts arrive in any order, so dQ may differ in its last bits from call to
// call. dK and dV are sums inside one block, in a fixed order, and are
// bit-identical across calls. Each block starts its pass at query tile
// blockIdx.x mod tiles, so that the blocks of a clip do not all add into
// the same rows at once.
// What the design does about its bounds: at D = C <= 32 the exponentials
// bind; the pass computes each once (half of a two-pass design's). Above,
// the tensor cores bind; wgmma with operands in shared memory is the
// instruction that reaches their rate. Measured on the H100 (PERF.md, PR
// 6), neither binds yet: each stage of a tile waits on the one before
// (wgmma results, the exponentials, the barrier before dQ), so the split
// (Choice) runs one consumer warpgroup a block and three blocks an SM at
// D, C <= 32, whose tiles then overlap, two warpgroups (Bc = 128) at 64
// and one at 128. The dQ reduction's traffic (N D M / Bc floats a clip) costs
// no measurable time.
// Operands use wgmma's no-swizzle layout (hopper.cuh), the padded width WP
// in {16, 32, 64, 128} covers D and C (TMA fills the columns past them,
// and rows past N or M, with zeros), and keys past M or queries past N get
// P = 0. TMA needs D and C multiples of 8 and 16-byte aligned bases: the
// wrapper pads other inputs with zero columns, which is exact.
//
// float32 (the tolerance checks): Dl by (a) below, then two launches of a
// scalar template with f32 FMAs on the CUDA cores, without atomics: the
// key-rows kernel (a block owns 64 keys and loops over every query tile,
// holding dK and dV in registers) and the query-rows kernel (a block owns
// 64 query rows and loops over every key tile, holding dQ). A block's rows
// (keys, or queries) bring A1 (rows x D: k or q) and A2 (rows x C: v or
// dO); the columns stream as B1 (cols x D: q or k) and B2 (cols x C: dO or
// v): X = A1 B1^T, Y = A2 B2^T, P = exp(X - lse), dS = P o (Y - Dl), then
// dV += P B2 and dK += dS B1 (key rows) or dQ += dS B1 (query rows). 256
// threads a block over 64 rows and tiles of 32 columns: four threads own a
// row, each computes X, Y, P and dS for 8 of the tile's columns into
// shared memory, then accumulates its quarter of the row's output columns
// over all 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// float32 (a): Dl[r] = sum_j out[r, j] dO[r, j] over the rows of (B N, C).
__global__ void attention_bwd_delta_kernel(const float* __restrict__ out,
                                           const float* __restrict__ dout,
                                           float* __restrict__ delta,
                                           long long rows, int c) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* o = out + r * c;
  const float* g = dout + r * c;
  float s = 0.f;
  for (int j = 0; j < c; ++j) s = fmaf(o[j], g[j], s);
  delta[r] = s;
}

// ---------------------------------------------------------------------------
// bfloat16: the one-pass wgmma kernel and its two row passes.

constexpr int kBr = 64;              // queries of a tile
constexpr int kSmemLimit = 232448;   // dynamic shared memory of a block
constexpr int kSmemSm = 233472;      // of an SM, 1 KB of it reserved a block

__host__ __device__ constexpr int padded_width(int w) {
  return w <= 16 ? 16 : w <= 32 ? 32 : w <= 64 ? 64 : 128;
}

// The split of one block for padded width WP, NWG consumer warpgroups and
// CTAS blocks resident on an SM (shared memory and registers divided).
// Shared memory: k and v ([WP / 8][Bc][8] bf16 each), kStages stages of q
// and dO ([WP / 8][kBr][8] each) and (lse log2 e, Dl) per query (kBr
// float2), dS ([kBr / 8][Bc][8] bf16: MN-major, query pairs adjacent), the
// dQ part ([kBr][WP] f32), then the mbarriers.
template <int WP, int NWG, int CTAS>
struct Plan {
  static constexpr int kBc = 64 * NWG;
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kPanels = WP / 8;
  static constexpr int kTileBytes = kBr * WP * 2;
  static constexpr int kStageBytes = 2 * kTileBytes + kBr * 8;
  static constexpr int kKvBytes = kBc * WP * 2;
  static constexpr int kDsBytes = kBc * kBr * 2;
  static constexpr int kDqBytes = kBr * WP * 4;
  static constexpr int kFixedBytes = 2 * kKvBytes + kDsBytes + kDqBytes;
  static constexpr int kBudget =
      kSmemSm / CTAS - 1024 < kSmemLimit ? kSmemSm / CTAS - 1024 : kSmemLimit;
  static constexpr int kFit = (kBudget - kFixedBytes - 256) / kStageBytes;
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kSmemBytes =
      kFixedBytes + kStages * kStageBytes + 8 * (2 * kStages + 1);
  // dQ's columns split over kDqWgs warpgroups (wgmma's N is at least 8)
  static constexpr int kDqWgs = NWG < WP / 8 ? NWG : WP / 8;
  static constexpr int kDqCols = WP / kDqWgs;
  // registers a thread at launch (what __launch_bounds__ leaves), and a
  // consumer thread's once the block's producer warpgroup drops to 24:
  // setmaxnreg.inc takes only registers that its own block gave back, so a
  // count above this waits forever
  static constexpr int kEntryRegs = 65536 / (kThreads * CTAS) / 8 * 8;
  static constexpr int kRegs = (kEntryRegs + (kEntryRegs - 24) / NWG) / 8 * 8;
  static constexpr int kConsumerRegs = kRegs < 240 ? kRegs : 240;
  static constexpr bool kRealloc = NWG > 1 || CTAS > 1;
  static_assert(kStages >= 2, "shared memory holds fewer than two stages");
};

// acc (64 x N) += A B, A in registers, B MN-major in shared memory (K rows
// x N columns in panels `panel` bytes apart), as one wgmma or two of N / 2.
template <int N>
__device__ __forceinline__ void mma_rs(float (&acc)[N / 2],
                                      const uint32_t (&a)[4], const bf16* b,
                                      uint32_t panel) {
  if constexpr (N <= 64) {
    hp::WgmmaRs<N, 1>::run(acc, a, hp::desc(b, 128, panel), 1);
  } else {
    mma_rs<64>(*reinterpret_cast<float(*)[32]>(acc), a, b, panel);
    mma_rs<64>(*reinterpret_cast<float(*)[32]>(acc + 32), a, b + 8 * panel / 2,
               panel);
  }
}

// acc (64 x N) = A B (+ acc where accumulate), A and B MN-major in shared
// memory (K rows x M or N columns in panels `panel` bytes apart), N <= 64.
template <int N>
__device__ __forceinline__ void mma_ss(float (&acc)[N / 2], const bf16* a,
                                      const bf16* b, uint32_t panel,
                                      int accumulate) {
  hp::Wgmma<N, 1, 1>::run(acc, hp::desc(a, 128, panel),
                          hp::desc(b, 128, panel), accumulate);
}

// (a) Per query row of (B, npad): stats = (lse log2 e, Dl), (0, 0) on the
// padding rows; and the row's WP accumulator floats set to 0 (none at WP =
// 0: the cluster kernel's accumulator is zeroed by a memset). out and dO
// are (B, N, C) with C a multiple of 8, 16-byte aligned.
__global__ void attention_bwd_prologue_kernel(
    const bf16* __restrict__ out, const bf16* __restrict__ dout,
    const float* __restrict__ lse, float2* __restrict__ stats,
    float* __restrict__ dq_acc, int b, int n, int npad, int c, int wp) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= (long long)b * npad) return;
  const int i = (int)(r % npad);
  float2 st = make_float2(0.f, 0.f);
  if (i < n) {
    const long long row = r / npad * n + i;
    const uint4* o = reinterpret_cast<const uint4*>(out + row * c);
    const uint4* g = reinterpret_cast<const uint4*>(dout + row * c);
    float s = 0.f;
    for (int j = 0; j < c / 8; ++j) {
      const uint4 ov = o[j], gv = g[j];
      const bf16* op = reinterpret_cast<const bf16*>(&ov);
      const bf16* gp = reinterpret_cast<const bf16*>(&gv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        s = fmaf(__bfloat162float(op[e]), __bfloat162float(gp[e]), s);
    }
    st = make_float2(lse[row] * kLog2e, s);
  }
  stats[r] = st;
  float4* acc = reinterpret_cast<float4*>(dq_acc + r * wp);
  for (int j = 0; j < wp / 4; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// (b) The one pass. k_map, v_map, q_map and do_map are panel maps
// (hopper.cuh) of k, v (boxes of Bc rows) and q, dO (boxes of kBr rows);
// stats (B, npad) from (a); dq_acc (B, npad, WP) float32, added to; dk
// (B, M, D) and dv (B, M, C) written.
template <int WP, int NWG, int CTAS>
__global__ void __launch_bounds__(Plan<WP, NWG, CTAS>::kThreads, CTAS)
attention_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float2* __restrict__ stats,
                           float* __restrict__ dq_acc, bf16* __restrict__ dk,
                           bf16* __restrict__ dv, int n, int m, int d,
                           int c) {
  using P = Plan<WP, NWG, CTAS>;
  constexpr int kBc = P::kBc;
  constexpr uint32_t kPanelK = kBc * 16;  // bytes between panels of k, v
  constexpr uint32_t kPanelQ = kBr * 16;  // of q and dO
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + kBc * WP;
  unsigned char* stage0 = smem + 2 * P::kKvBytes;
  bf16* ds_s =
      reinterpret_cast<bf16*>(stage0 + P::kStages * P::kStageBytes);
  float* dq_s = reinterpret_cast<float*>(ds_s + kBc * kBr);
  uint64_t* full = reinterpret_cast<uint64_t*>(dq_s + kBr * WP);
  uint64_t* empty = full + P::kStages;
  uint64_t* kv_full = empty + P::kStages;
  auto q_tile = [&](int s) {
    return reinterpret_cast<bf16*>(stage0 + s * P::kStageBytes);
  };

  const int b = blockIdx.y, key0 = blockIdx.x * kBc;
  const int tiles = (n + kBr - 1) / kBr, npad = tiles * kBr;
  const int first = blockIdx.x % tiles;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 128 * NWG);
    }
    hp::mbar_init(kv_full, 1);
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (wg == NWG) {  // the producer warpgroup; one thread issues the loads
    if constexpr (P::kRealloc) hp::reg_dealloc<24>();
    if (threadIdx.x == 128 * NWG) {
      hp::mbar_arrive_expect_tx(kv_full, 2 * P::kKvBytes);
      for (int p = 0; p < P::kPanels; ++p) {
        hp::tma_load_3d(k_s + p * kBc * 8, &k_map, kv_full, 8 * p, key0, b);
        hp::tma_load_3d(v_s + p * kBc * 8, &v_map, kv_full, 8 * p, key0, b);
      }
      for (int i = 0; i < tiles; ++i) {
        const int s = i % P::kStages, q0 = (first + i) % tiles * kBr;
        if (i >= P::kStages)  // stage s's last tile released
          hp::mbar_wait(&empty[s], (i / P::kStages - 1) & 1);
        bf16* qt = q_tile(s);
        hp::mbar_arrive_expect_tx(&full[s], P::kStageBytes);
        for (int p = 0; p < P::kPanels; ++p) {
          hp::tma_load_3d(qt + p * kBr * 8, &q_map, &full[s], 8 * p, q0, b);
          hp::tma_load_3d(qt + (P::kPanels + p) * kBr * 8, &do_map, &full[s],
                          8 * p, q0, b);
        }
        hp::bulk_load(qt + 2 * kBr * WP, stats + (size_t)b * npad + q0,
                      kBr * 8, &full[s]);
      }
    }
    return;
  }

  // a consumer warpgroup: keys key0 + 64 wg ..
  if constexpr (P::kRealloc) hp::reg_alloc<P::kConsumerRegs>();
  const int tid = threadIdx.x, warp = tid / 32 % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int krow = 64 * wg + 16 * warp + g;  // rows krow, krow + 8
  const bool keys_ragged = key0 + 64 * wg + 64 > m;
  float dv_acc[WP / 2], dk_acc[WP / 2];
#pragma unroll
  for (int i = 0; i < WP / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;
  hp::mbar_wait(kv_full, 0);

  for (int i = 0; i < tiles; ++i) {
    const int s = i % P::kStages, q0 = (first + i) % tiles * kBr;
    hp::mbar_wait(&full[s], (i / P::kStages) & 1);
    const bf16* qt = q_tile(s);
    const bf16* dot = qt + kBr * WP;
    const float2* stt = reinterpret_cast<const float2*>(dot + kBr * WP);

    // S^T = k q^T and dP^T = v dO^T (64 keys x kBr queries)
    float st[kBr / 2], dp[kBr / 2];
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WP / 16; ++kk) {
      const int a = (2 * kk * kBc + 64 * wg) * 8, bq = 2 * kk * kBr * 8;
      hp::Wgmma<kBr, 0, 0>::run(st, hp::desc(k_s + a, kPanelK, 128),
                                hp::desc(qt + bq, kPanelQ, 128), kk);
      hp::Wgmma<kBr, 0, 0>::run(dp, hp::desc(v_s + a, kPanelK, 128),
                                hp::desc(dot + bq, kPanelQ, 128), kk);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(st);
    hp::fence_regs(dp);

    // P^T and dS^T in place; keys past M and queries past N get P = 0
    const bool edge = keys_ragged || q0 + kBr > n;
#pragma unroll
    for (int j = 0; j < kBr / 8; ++j) {
      const float4 sj = *reinterpret_cast<const float4*>(stt + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l2 = e & 1 ? sj.z : sj.x, dl = e & 1 ? sj.w : sj.y;
        float p = tc::ex2(fmaf(st[4 * j + e], kLog2e, -l2));
        if (edge && (q0 + 8 * j + 2 * t + (e & 1) >= n ||
                     key0 + krow + 8 * (e >> 1) >= m))
          p = 0.f;
        st[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - dl);
      }
    }
    // bf16 A fragments of k16 step kk (queries 16 kk ..), and dS into
    // ds_s: element (query, key) at [query / 8][key][query % 8], so that
    // each register's two queries of one key are one 4-byte store
    uint32_t pa[kBr / 16][4], da[kBr / 16][4];
    uint32_t* dss = reinterpret_cast<uint32_t*>(ds_s);
#pragma unroll
    for (int kk = 0; kk < kBr / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = tc::pack_bf16x2(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        da[kk][r] = tc::pack_bf16x2(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        dss[((2 * kk + (r >> 1)) * kBc + krow + 8 * (r & 1)) * 4 + t] =
            da[kk][r];
      }

    // dV += P^T dO, dK += dS^T q
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBr / 16; ++kk) {
      mma_rs<WP>(dv_acc, pa[kk], dot + 16 * kk * 8, kPanelQ);
      mma_rs<WP>(dk_acc, da[kk], qt + 16 * kk * 8, kPanelQ);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(dv_acc);
    hp::fence_regs(dk_acc);
    hp::mbar_arrive(&empty[s]);  // q, dO and the statistics are read

    // every warpgroup's dS^T stored, and the last dQ part read from dq_s
    hp::fence_proxy_async();
    if (tid == 0) hp::bulk_wait_read();
    hp::named_barrier(1, 128 * NWG);
    if (wg < P::kDqWgs) {  // dQ part = dS k, columns wg * kDqCols .., by 64
      constexpr int kPart = P::kDqCols < 64 ? P::kDqCols : 64;
#pragma unroll
      for (int part = 0; part < P::kDqCols / kPart; ++part) {
        const int col0 = wg * P::kDqCols + part * kPart;
        float dq[kPart / 2];
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBc / 16; ++kk)
          mma_ss<kPart>(dq, ds_s + 16 * kk * 8,
                        k_s + (col0 / 8 * kBc + 16 * kk) * 8, kPanelK, kk);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(dq);
#pragma unroll
        for (int j = 0; j < kPart / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(
                dq_s + (16 * warp + g + 8 * h) * WP + col0 + 8 * j + 2 * t) =
                make_float2(dq[4 * j + 2 * h], dq[4 * j + 2 * h + 1]);
      }
    }
    hp::fence_proxy_async();
    hp::named_barrier(1, 128 * NWG);
    if (tid == 0) {
      hp::bulk_reduce_add_f32(dq_acc + ((size_t)b * npad + q0) * WP, dq_s,
                              P::kDqBytes);
      hp::bulk_commit();
    }
  }
  if (tid == 0) hp::bulk_wait_read();

  // dK and dV rows of this thread's keys, columns < d (or c)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + krow + 8 * h;
    if (key >= m) continue;
    __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(
        dk + ((size_t)b * m + key) * d);
    __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(
        dv + ((size_t)b * m + key) * c);
#pragma unroll
    for (int j = 0; j < WP / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (col < d)
        ok[col / 2] = __floats2bfloat162_rn(dk_acc[4 * j + 2 * h],
                                            dk_acc[4 * j + 2 * h + 1]);
      if (col < c)
        ov[col / 2] = __floats2bfloat162_rn(dv_acc[4 * j + 2 * h],
                                            dv_acc[4 * j + 2 * h + 1]);
    }
  }
}

// (c) dq (B, N, D) = the accumulator's rows < N and columns < D in bf16,
// 8 columns a thread (D a multiple of 8). The accumulator is (B, slices,
// npad, sw): column j of D in slice j / sw at j % sw (one slice of WP
// columns for the one-pass kernel, 2 R of 128 for the cluster kernel).
__global__ void attention_bwd_dq_kernel(const float* __restrict__ dq_acc,
                                        bf16* __restrict__ dq, int b, int n,
                                        int npad, int d, int slices, int sw) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)b * n * (d / 8)) return;
  const long long row = i / (d / 8);
  const int col = (int)(i % (d / 8)) * 8;
  const float4* src = reinterpret_cast<const float4*>(
      dq_acc + ((row / n * slices + col / sw) * npad + row % n) * sw +
      col % sw);
  const float4 lo = src[0], hi = src[1];
  __nv_bfloat162 o[4] = {__floats2bfloat162_rn(lo.x, lo.y),
                         __floats2bfloat162_rn(lo.z, lo.w),
                         __floats2bfloat162_rn(hi.x, hi.y),
                         __floats2bfloat162_rn(hi.z, hi.w)};
  *reinterpret_cast<uint4*>(dq + row * d + col) =
      *reinterpret_cast<const uint4*>(o);
}

// The split of each padded width: consumer warpgroups a block (Bc = 64
// of them) and blocks resident on an SM. Several blocks of one consumer
// warpgroup hide the latency of a tile's stages better than two
// warpgroups that wait for each other at every tile (PERF.md, PR 6).
template <int WP>
struct Choice {
  static constexpr int kGroups = WP == 64 ? 2 : 1;
  static constexpr int kPerSm = WP <= 32 ? 3 : 1;
};

template <int WP, int NWG, int CTAS>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float2* stats, float* dq_acc,
                 void* dk, void* dv, int b, int n, int m, int d, int c,
                 cudaStream_t s) {
  using P = Plan<WP, NWG, CTAS>;
  CUtensorMap k_map, v_map, q_map, do_map;
  if (!hp::make_panel_map(&k_map, k, b, m, d, P::kBc) ||
      !hp::make_panel_map(&v_map, v, b, m, c, P::kBc) ||
      !hp::make_panel_map(&q_map, q, b, n, d, kBr) ||
      !hp::make_panel_map(&do_map, dout, b, n, c, kBr))
    return (int)cudaErrorInvalidValue;
  auto kernel = attention_bwd_wgmma_kernel<WP, NWG, CTAS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmemBytes);
  if (err == cudaSuccess)  // all of the SM's shared memory, for CTAS blocks
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + P::kBc - 1) / P::kBc, b);
  kernel<<<grid, P::kThreads, P::kSmemBytes, s>>>(
      k_map, v_map, q_map, do_map, stats, dq_acc, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n, m, d, c);
  return (int)cudaGetLastError();
}

// The block split of width WP for (b, m): {Bc, kBr, stages, blocks,
// shared memory bytes, WP, blocks an SM}.
template <int WP>
void plan_of(int b, int m, int* split) {
  using C = Choice<WP>;
  using P = Plan<WP, C::kGroups, C::kPerSm>;
  const int v[7] = {P::kBc, kBr, P::kStages, (m + P::kBc - 1) / P::kBc * b,
                    P::kSmemBytes, WP, C::kPerSm};
  for (int i = 0; i < 7; ++i) split[i] = v[i];
}

template <int WP>
int launch_width(const void* q, const void* k, const void* v,
                 const void* dout, const float2* stats, float* dq_acc,
                 void* dk, void* dv, int b, int n, int m, int d, int c,
                 cudaStream_t s) {
  using C = Choice<WP>;
  return launch_wgmma<WP, C::kGroups, C::kPerSm>(
      q, k, v, dout, stats, dq_acc, dk, dv, b, n, m, d, c, s);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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

// ---------------------------------------------------------------------------
// bfloat16, D or C above 128 (non-local blocks: 256 in s3, 512 in s4, 1024
// in a res5): the cluster kernel (attention_bwd_cluster_kernel<BR, MODE>),
// three launches a call as at the narrow widths: (a) the prologue, (b) the
// cluster kernel, (c) dQ; any D and C. The one-pass kernel above stops at
// 128: a consumer warpgroup holds dK and dV (64 keys x WP float32 each),
// 256 registers a thread at WP = 256. So here the columns are split too,
// as the forward's cluster kernel splits them (csrc/flash_attention.cu,
// push_partial / sum_partials):
//
// Split. A block owns kClKeys = 64 keys of one clip and two consumer
// warpgroups, both on those keys. The 256-column slices of D and of C are
// dealt to G column groups (a grid dimension) of R blocks each (the plan's
// "groups" and "cluster": G = 1 and the least of 1, 2, 4, 8 with 256 R >=
// D and >= C up to 2048; beyond, G = ceil(max(D, C) / 2048) and R =
// ceil(max(D, C) / 256 G)): block r of group g owns slice o = g R + r, and
// its warpgroup w the kClSlice = 128 columns [128 (2 o + w), + 128) of D
// and of C (its dK and dV accumulators: 64 + 64 registers a thread). The R
// blocks of a group form one thread block cluster over a clip's key block;
// columns past D or C arrive as zeros and give zeros. Per query tile of BR
// queries (32, or 16 where the slots would not fit beside the rings) a
// warpgroup computes the partial S^T = k q^T and dP^T = v dO^T over its
// columns of the block's slices of D and of C (wgmma, both operands in
// shared memory, keys as M): its own slice o, and where G > 1 the
// "extra" slices r + R j (j != g) below D's (C's) count, whose k (v) and q
// (dO) stream through a ring of their own once a query tile, so that the
// group's R blocks together cover all of D and C. The block adds its two
// warpgroups' partials, and the cluster its blocks' partials in rank
// order, 0 first, over distributed shared memory: every block leader
// pushes its partial (S^T and dP^T, float32; over two rounds, S^T then
// dP^T, where the slots of one would not fit) into the same slot of every
// other block by bulk copies (x_full: transaction bytes; x_free: each
// peer's arrival once it has read my last push), then every thread sums
// the R slots. So all 2 R warpgroups of a group hold the same S^T and
// dP^T, bit for bit, and compute the same P^T = ex2(S^T log2 e - lse
// log2 e) and dS^T = P^T o (dP^T - Dl) (rounded to bf16 once, as the
// one-pass kernel rounds them), then
//   dV[:, its C columns] += P^T dO,  dK[:, its D columns] += dS^T q
// (register A fragments, dO and q read MN-major in place), and
//   dQ[tile, its D columns]^T = k^T dS^T
// (k and dS from shared memory, both MN-major: M = 128 columns of D, so a
// query tile of 32 needs no 64-row wgmma). dV, dK and dQ are computed once
// a call where D and C are multiples of 256 R G (the zoo's 256, 512, 1024,
// 2048), and the two logits products G times (elsewhere the warpgroups
// whose own columns lie past D or C multiply zeros: "recompute" in
// backward_split). The exponentials run 2 R G times (cheap beside the
// products: 0.02 ms at the AVA res5 step).
//
// dQ: option (a), a bulk reduce-add (cp.reduce.async.bulk .add.f32) of
// each warpgroup's BR x 128 float32 part into a (B, 2 R G, npad, 128)
// accumulator, as the one-pass kernel adds its dQ. N D ceil(M / 64) x 4
// bytes a clip of traffic (0.1 ms of the card's memory at I3D-NLN's s3, 8
// clips; 0.2 ms at the AVA res5 step), where a deterministic second pass
// over the query tiles (b) would recompute S and dP, 2 N M (2 D + C) more
// operations (1.4x the bound's work at D = C). So bf16 dQ is NOT
// deterministic here either: its float32 adds arrive in any order. dK and
// dV are sums inside one block in a fixed order and are bit-identical
// across calls.
//
// Grid: R blocks a key block and group, ceil(M / 64) key blocks, B clips,
// G groups; one block an SM (256 threads, 255 registers a thread, up to
// 227 KB of shared memory). At I3D-NLN's s3 (8 clips, M = 784, D = C =
// 256: R = 1) that is 104 blocks, one wave on 79% of the card's 132 SMs;
// at 256^2 (M = 1024) 128 blocks (97%); at the AVA res5 step (16 clips,
// M = 392, D = C = 1024: R = 4) 448 blocks in clusters of 4, 3.4 waves.
//
// Loads: thread 0 issues TMA copies (hopper.cuh make_panels_map: one copy
// a tile of 32 column panels) of the block's own 256 columns of k and v
// once, per query tile of q, dO (the block's 256 columns) and the
// (lse log2 e, Dl) statistics into a ring of stages (full: one arrival and
// the copies' bytes; empty: one arrival per warpgroup once its products and
// its dQ reduce-add have read the stage), and per (query tile, extra
// slice) in turn the slice's k and q, or v and dO, into the extra ring
// (xfull, xempty). A stage holds [statistics][q][dO]; its q and dO become
// the warpgroups' dQ staging once both have read them.
//
// Shared memory (cl_smem_bytes, backward_split's arithmetic): k and v (64
// x 256 bf16 each), the stages (256 + 1024 BR bytes each, three where they
// fit, else two), where G > 1 two extra stages (64 x 256 and BR x 256
// bf16 each), dS (BR x 64 bf16), R slots (BR x 64 x 2 float32 each, over
// the rounds), the mbarriers. D and C reach it as multiples of 8 with
// 16-byte aligned data (the wrapper pads other inputs, exactly, as for the
// narrow path).

constexpr int kClKeys = 64;            // keys a block (wgmma's M)
constexpr int kClSlice = 128;          // columns of D and of C a warpgroup owns
constexpr int kClCols = 2 * kClSlice;  // of a block
constexpr int kClThreads = 256;        // two consumer warpgroups
constexpr int kClMaxCluster = 8;
constexpr int kClMinStages = 2;
constexpr int kClMaxStages = 3;
constexpr int kClMaxExtraStages = 2;
constexpr int kClStatsBytes = 256;     // a stage's statistics (BR x 8 bytes)
constexpr int kClBarrierBytes = 256;
constexpr int kClKvBytes = kClKeys * kClCols * 2;  // k or v

__host__ __device__ constexpr int cl_stage_bytes(int br) {
  return kClStatsBytes + 4 * br * kClCols;  // statistics, q, dO
}

// an extra stage: a slice of k (or v), and of q (or dO) for one tile
__host__ __device__ constexpr int cl_extra_bytes(int br) {
  return kClKvBytes + 2 * br * kClCols;
}

// a block's partial: S^T and dP^T (64 keys x BR queries float32 each)
__host__ __device__ constexpr int cl_slot_bytes(int br) { return 512 * br; }

__host__ __device__ inline int cl_smem_bytes(int split, int br, int stages,
                                             int xstages, int rounds) {
  return 2 * kClKvBytes + stages * cl_stage_bytes(br) +
         xstages * cl_extra_bytes(br) + kClKeys * br * 2 +
         split * cl_slot_bytes(br) / rounds + kClBarrierBytes;
}

struct ClusterBwdArgs {
  const float2* stats;  // (B, npad): (lse log2 e, Dl)
  float* dq_acc;        // (B, 2 R G, npad, 128) float32, added to
  bf16* dk;
  bf16* dv;
  int n, m, d, c, npad;
  int split;    // R
  int groups;   // G
  int stages;   // of the ring
  int xstages;  // of the extra ring (G > 1)
};

// MODE: 0 one column group (no extra slices, one round of exchange), 1
// column groups with one round, 2 with two
template <int BR, int MODE>
__global__ void __launch_bounds__(kClThreads, 1)
attention_bwd_cluster_kernel(const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const ClusterBwdArgs a) {
  constexpr int kF4 = BR / 4;  // float4 a thread in a slot: S^T, then dP^T
  constexpr bool kExtra = MODE > 0;
  constexpr int kRounds = MODE == 2 ? 2 : 1;
  constexpr int per = kF4 / kRounds;  // float4 a thread a round
  constexpr uint32_t kPanelK = kClKeys * 16;  // bytes between panels of k, v
  constexpr uint32_t kPanelQ = BR * 16;       // of q and dO
  extern __shared__ __align__(128) unsigned char smem[];
  // tiles of column panels [cols / 8][rows][8] (hopper.cuh)
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [32][64][8]
  bf16* v_s = k_s + kClKeys * kClCols;        // [32][64][8]
  unsigned char* stage0 = smem + 2 * kClKvBytes;
  unsigned char* xstage0 = stage0 + a.stages * cl_stage_bytes(BR);
  bf16* ds_s = reinterpret_cast<bf16*>(xstage0 +
                                       a.xstages * cl_extra_bytes(BR));
  float4* slots = reinterpret_cast<float4*>(ds_s + kClKeys * BR);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(slots) +
      a.split * cl_slot_bytes(BR) / kRounds);
  uint64_t* empty = full + kClMaxStages;
  uint64_t* kv_full = empty + kClMaxStages;
  uint64_t* x_full = kv_full + 1;
  uint64_t* x_free = x_full + 1;
  uint64_t* xfull = x_free + 1;                 // [xstages]
  uint64_t* xempty = xfull + kClMaxExtraStages;  // [xstages]

  const int split = a.split, rank = blockIdx.x % split, b = blockIdx.y;
  const int group = blockIdx.z, own = group * split + rank;
  const int kb = blockIdx.x / split, key0 = kb * kClKeys;
  const int tiles = a.npad / BR, first = kb % tiles;
  const int tid = threadIdx.x, wg = tid / 128, t128 = tid % 128;
  const int warp = t128 / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int col0 = (2 * own + wg) * kClSlice;  // of D and of C
  // the extra slices rank + R j (j != group) below D's and C's counts of
  // 256 columns: ed of D, then of C, ex in all, a tile
  auto extras = [&](int cols) {
    const int slices = (cols + kClCols - 1) / kClCols;
    int j = slices > rank ? (slices - rank + split - 1) / split : 0;
    j = j < a.groups ? j : a.groups;
    return j - (group < j ? 1 : 0);
  };
  const int ed = kExtra ? extras(a.d) : 0;
  const int ex = kExtra ? ed + extras(a.c) : 0;
  auto stage = [&](int s) { return stage0 + s * cl_stage_bytes(BR); };
  auto xstage = [&](int s) { return xstage0 + s * cl_extra_bytes(BR); };
  if (tid == 0) {
    for (int s = 0; s < kClMaxStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 2);
    }
    for (int s = 0; s < kClMaxExtraStages; ++s) {
      hp::mbar_init(&xfull[s], 1);
      hp::mbar_init(&xempty[s], kClThreads);
    }
    hp::mbar_init(kv_full, 1);
    hp::mbar_init(x_full, 1);
    hp::mbar_init(x_free, split > 1 ? split - 1 : 1);
    hp::mbar_init_fence();
  }
  // every block of the cluster has its barriers before any arrives there
  if (split > 1)
    hp::cluster_sync();
  else
    __syncthreads();

  // tile i's statistics, q and dO (the block's 256 columns) into stage
  // i % stages
  auto load_tile = [&](int i) {
    const int s = i % a.stages, q0 = (first + i) % tiles * BR;
    unsigned char* st = stage(s);
    hp::mbar_arrive_expect_tx(&full[s], 8 * BR + 4 * BR * kClCols);
    hp::bulk_load(st, a.stats + (size_t)b * a.npad + q0, 8 * BR, &full[s]);
    hp::tma_load_4d(st + kClStatsBytes, &q_map, &full[s], 0, q0,
                    own * kClCols / 8, b);
    hp::tma_load_4d(st + kClStatsBytes + 2 * BR * kClCols, &do_map,
                    &full[s], 0, q0, own * kClCols / 8, b);
  };
  // extra load l: extra l % ex of tile l / ex, its slice of k and q (of D)
  // or of v and dO (of C), into extra stage l % xstages
  auto load_extra = [&](int l) {
    const int i = l / ex, e = l - i * ex, s = l % a.xstages;
    const int q0 = (first + i) % tiles * BR;
    const bool on_d = e < ed;
    int j = on_d ? e : e - ed;
    j += j >= group;
    const int panel = (rank + split * j) * kClCols / 8;
    unsigned char* st = xstage(s);
    hp::mbar_arrive_expect_tx(&xfull[s], cl_extra_bytes(BR));
    hp::tma_load_4d(st, on_d ? &k_map : &v_map, &xfull[s], 0, key0, panel, b);
    hp::tma_load_4d(st + kClKvBytes, on_d ? &q_map : &do_map, &xfull[s], 0,
                    q0, panel, b);
  };
  const int xloads = tiles * ex;
  if (tid == 0) {
    hp::prefetch_tensormap(&q_map);
    hp::prefetch_tensormap(&do_map);
    hp::mbar_arrive_expect_tx(kv_full, 2 * kClKvBytes);
    hp::tma_load_4d(k_s, &k_map, kv_full, 0, key0, own * kClCols / 8, b);
    hp::tma_load_4d(v_s, &v_map, kv_full, 0, key0, own * kClCols / 8, b);
    for (int i = 0; i < a.stages && i < tiles; ++i) load_tile(i);
    if constexpr (kExtra)
      for (int l = 0; l < a.xstages && l < xloads; ++l) load_extra(l);
  }
  // (the wgmma and barrier instructions below are warp-aligned: each branch
  // of one thread is followed by __syncwarp)
  __syncwarp();

  const int krow = 16 * warp + g;  // this thread's keys krow, krow + 8
  const bool keys_ragged = key0 + kClKeys > a.m;
  float4* mine = slots + rank * per * 128;
  float dv_acc[kClSlice / 2], dk_acc[kClSlice / 2];
#pragma unroll
  for (int i = 0; i < kClSlice / 2; ++i) dv_acc[i] = dk_acc[i] = 0.f;
  hp::mbar_wait_bounded(kv_full, 0);

  // acc += this warpgroup's 128 columns of extra load l's slice (k q^T or
  // v dO^T), a wgmma group of its own (folding the first two into the own
  // products' group had ptxas inject warpgroup arrives, C7519, and was
  // slower: PERF.md); then the stage released and refilled (at
  // once: refilled at the tile's end instead, the 3072 step ran 4% slower)
  auto extra_product = [&](float (&acc)[BR / 2], int l) {
    const int s = l % a.xstages;
    const bf16* xa = reinterpret_cast<const bf16*>(xstage(s));
    const bf16* xb = xa + kClKeys * kClCols;
    hp::mbar_wait_bounded(&xfull[s], (l / a.xstages) & 1);
    __syncwarp();
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kClSlice / 16; ++kk) {
      const int p = 16 * wg + 2 * kk;
      hp::Wgmma<BR, 0, 0>::run(acc,
                               hp::desc(xa + p * kClKeys * 8, kPanelK, 128),
                               hp::desc(xb + p * BR * 8, kPanelQ, 128), 1);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    hp::mbar_arrive(&xempty[s]);
    if (tid == 0 && l + a.xstages < xloads) {
      hp::mbar_wait_bounded(&xempty[s], (l / a.xstages) & 1);
      load_extra(l + a.xstages);
    }
    __syncwarp();
  };

  for (int i = 0; i < tiles; ++i) {
    const int s = i % a.stages, q0 = (first + i) % tiles * BR;
    unsigned char* st = stage(s);
    const float2* stt = reinterpret_cast<const float2*>(st);
    const bf16* qt = reinterpret_cast<const bf16*>(st + kClStatsBytes);
    const bf16* dot = qt + BR * kClCols;
    hp::mbar_wait_bounded(&full[s], (i / a.stages) & 1);
    __syncwarp();

    // this warpgroup's partial S^T = k q^T and dP^T = v dO^T (64 keys x BR
    // queries) over its 128 columns of the own slice: panels 16 wg .. 16 wg
    // + 15; then of the extra slices
    float sp[BR / 2], dp[BR / 2];
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kClSlice / 16; ++kk) {
      const int p = 16 * wg + 2 * kk;
      hp::Wgmma<BR, 0, 0>::run(sp, hp::desc(k_s + p * kClKeys * 8, kPanelK, 128),
                               hp::desc(qt + p * BR * 8, kPanelQ, 128), kk);
      hp::Wgmma<BR, 0, 0>::run(dp, hp::desc(v_s + p * kClKeys * 8, kPanelK, 128),
                               hp::desc(dot + p * BR * 8, kPanelQ, 128), kk);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(sp);
    hp::fence_regs(dp);
    if constexpr (kExtra) {
      for (int e = 0; e < ed; ++e) extra_product(sp, i * ex + e);
      for (int e = ed; e < ex; ++e) extra_product(dp, i * ex + e);
    }

    // per round h (S^T and dP^T at once, or S^T then dP^T): the block's
    // partial (warpgroup 0's plus warpgroup 1's) in my slot, once every
    // peer has read my last push; pushed to every peer; the R slots summed
#pragma unroll
    for (int h = 0; h < kRounds; ++h) {
      const int x = i * kRounds + h;
      if (split > 1 && tid == 0 && x > 0)
        hp::mbar_wait_cluster(x_free, (x - 1) & 1);
      __syncwarp();
      hp::named_barrier(1, kClThreads);
      if (wg == 1) {
#pragma unroll
        for (int f = 0; f < kF4; ++f) {
          if (f / per != h) continue;
          const float* y = f < kF4 / 2 ? sp + 4 * f : dp + 4 * (f - kF4 / 2);
          mine[(f - h * per) * 128 + t128] = make_float4(y[0], y[1], y[2],
                                                         y[3]);
        }
      }
      hp::named_barrier(1, kClThreads);
      if (wg == 0) {
#pragma unroll
        for (int f = 0; f < kF4; ++f) {
          if (f / per != h) continue;
          const float* y = f < kF4 / 2 ? sp + 4 * f : dp + 4 * (f - kF4 / 2);
          const float4 z = mine[(f - h * per) * 128 + t128];
          mine[(f - h * per) * 128 + t128] =
              make_float4(y[0] + z.x, y[1] + z.y, y[2] + z.z, y[3] + z.w);
        }
        hp::fence_proxy_async();  // the bulk copies read what was written
      }
      hp::named_barrier(1, kClThreads);
      if (split > 1) {
        if (tid == 0) {
          const uint32_t bytes = per * 128 * 16;
          hp::mbar_arrive_expect_tx(x_full, (split - 1) * bytes);
          for (int r = 0; r < split; ++r)
            if (r != rank)
              hp::bulk_copy_cluster(hp::cluster_addr(mine, r), mine, bytes,
                                    hp::cluster_addr(x_full, r));
        }
        hp::mbar_wait_cluster(x_full, x & 1);
        __syncwarp();
      }
      // the cluster's S^T and dP^T: the R slots in rank order
      for (int r = 0; r < split; ++r) {
        const float4* slot = slots + r * per * 128 + t128;
#pragma unroll
        for (int f = 0; f < kF4; ++f) {
          if (f / per != h) continue;
          const float4 z = slot[(f - h * per) * 128];
          float* y = f < kF4 / 2 ? sp + 4 * f : dp + 4 * (f - kF4 / 2);
          if (r == 0) {
            y[0] = z.x, y[1] = z.y, y[2] = z.z, y[3] = z.w;
          } else {
            y[0] += z.x, y[1] += z.y, y[2] += z.z, y[3] += z.w;
          }
        }
      }
      hp::named_barrier(1, kClThreads);  // the slots are read
      if (split > 1 && tid == 0)
        for (int r = 0; r < split; ++r)
          if (r != rank) hp::mbar_arrive_cluster(x_free, r);
      __syncwarp();
    }

    // P^T and dS^T in place; keys past M and queries past N get P = 0
    const bool edge = keys_ragged || q0 + BR > a.n;
#pragma unroll
    for (int j = 0; j < BR / 8; ++j) {
      const float4 sj = *reinterpret_cast<const float4*>(stt + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float l2 = e & 1 ? sj.z : sj.x, dl = e & 1 ? sj.w : sj.y;
        float p = tc::ex2(fmaf(sp[4 * j + e], kLog2e, -l2));
        if (edge && (q0 + 8 * j + 2 * t + (e & 1) >= a.n ||
                     key0 + krow + 8 * (e >> 1) >= a.m))
          p = 0.f;
        sp[4 * j + e] = p;
        dp[4 * j + e] = p * (dp[4 * j + e] - dl);
      }
    }
    // bf16 A fragments of k16 step kk (queries 16 kk ..); warpgroup 0 also
    // stores dS^T: element (query, key) at [query / 8][key][query % 8], so
    // that each register's two queries of one key are one 4-byte store
    uint32_t pa[BR / 16][4], da[BR / 16][4];
    uint32_t* dss = reinterpret_cast<uint32_t*>(ds_s);
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = tc::pack_bf16x2(sp[8 * kk + 2 * r], sp[8 * kk + 2 * r + 1]);
        da[kk][r] = tc::pack_bf16x2(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
        if (wg == 0)
          dss[((2 * kk + (r >> 1)) * kClKeys + krow + 8 * (r & 1)) * 4 + t] =
              da[kk][r];
      }
    if (wg == 0) hp::fence_proxy_async();  // dS^T is read by wgmma

    // dV += P^T dO, dK += dS^T q over this warpgroup's columns
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      const int off = (16 * wg * BR + 16 * kk) * 8;
      mma_rs<kClSlice>(dv_acc, pa[kk], dot + off, kPanelQ);
      mma_rs<kClSlice>(dk_acc, da[kk], qt + off, kPanelQ);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(dv_acc);
    hp::fence_regs(dk_acc);
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      hp::fence_regs(pa[kk]);
      hp::fence_regs(da[kk]);
    }
    // both warpgroups are done with q and dO, and dS^T is in ds_s
    hp::named_barrier(1, kClThreads);

    // dQ^T = k^T dS^T over this warpgroup's 128 columns of D, two 64-row
    // wgmmas (k MN-major: rows = keys, panels = D; dS^T MN-major: rows =
    // keys, panels = queries)
    float dq[2][BR / 2];
    hp::wgmma_fence();
#pragma unroll
    for (int mp = 0; mp < 2; ++mp)
#pragma unroll
      for (int kk = 0; kk < kClKeys / 16; ++kk)
        hp::Wgmma<BR, 1, 1>::run(
            dq[mp],
            hp::desc(k_s + ((16 * wg + 8 * mp) * kClKeys + 16 * kk) * 8, 128,
                     kPanelK),
            hp::desc(ds_s + 16 * kk * 8, 128, kClKeys * 16), kk);
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_regs(dq[0]);
    hp::fence_regs(dq[1]);
    // staged [query][128] float32 where this stage's q and dO were, then
    // added to the accumulator's rows q0 .. of slice 2 own + wg
    float* dq_s = reinterpret_cast<float*>(st + kClStatsBytes) +
                  wg * BR * kClSlice;
#pragma unroll
    for (int mp = 0; mp < 2; ++mp)
#pragma unroll
      for (int j = 0; j < BR / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dq_s[(8 * j + 2 * t + (e & 1)) * kClSlice + 64 * mp + krow +
               8 * (e >> 1)] = dq[mp][4 * j + e];
    hp::fence_proxy_async();
    hp::named_barrier(2 + wg, 128);
    if (t128 == 0) {
      hp::bulk_reduce_add_f32(
          a.dq_acc +
              (((size_t)b * 2 * split * a.groups + 2 * own + wg) * a.npad +
               q0) * kClSlice,
          dq_s, BR * kClSlice * 4);
      hp::bulk_commit();
      hp::bulk_wait_read();
      hp::mbar_arrive(&empty[s]);  // this warpgroup is done with stage s
    }
    __syncwarp();
    // refill: tile i + stages into stage s once both warpgroups left it
    if (tid == 0 && i + a.stages < tiles) {
      hp::mbar_wait_bounded(&empty[s], (i / a.stages) & 1);
      load_tile(i + a.stages);
    }
    __syncwarp();
  }

  // dK and dV rows of this thread's keys, its warpgroup's columns < d (c)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = key0 + krow + 8 * h;
    if (key >= a.m) continue;
    __nv_bfloat162* ok = reinterpret_cast<__nv_bfloat162*>(
        a.dk + ((size_t)b * a.m + key) * a.d);
    __nv_bfloat162* ov = reinterpret_cast<__nv_bfloat162*>(
        a.dv + ((size_t)b * a.m + key) * a.c);
#pragma unroll
    for (int j = 0; j < kClSlice / 8; ++j) {
      const int col = col0 + 8 * j + 2 * t;
      if (col < a.d)
        ok[col / 2] = __floats2bfloat162_rn(dk_acc[4 * j + 2 * h],
                                            dk_acc[4 * j + 2 * h + 1]);
      if (col < a.c)
        ov[col / 2] = __floats2bfloat162_rn(dv_acc[4 * j + 2 * h],
                                            dv_acc[4 * j + 2 * h + 1]);
    }
  }
  // keep this block's shared memory until every peer has read my last push
  // (after that no peer writes or arrives here)
  if (split > 1 && tid == 0)
    hp::mbar_wait_cluster(x_free, (tiles * kRounds - 1) & 1);
}

template <int BR, int MODE>
int launch_cluster_bwd(const CUtensorMap& k_map, const CUtensorMap& v_map,
                       const CUtensorMap& q_map, const CUtensorMap& do_map,
                       const ClusterBwdArgs& a, int b, int smem,
                       cudaStream_t stream) {
  auto kernel = attention_bwd_cluster_kernel<BR, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.split * ((a.m + kClKeys - 1) / kClKeys), b, a.groups);
  cfg.blockDim = dim3(kClThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, k_map, v_map, q_map, do_map, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int BR, int MODE>
int cluster_bwd_smem_attr() {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, attention_bwd_cluster_kernel<BR, MODE>);
  return err == cudaSuccess ? attr.maxDynamicSharedSizeBytes : -(int)err;
}

// ---------------------------------------------------------------------------
// float32, D or C above 128: a grid dimension over 128-column slices of the
// outputs, each block recomputing X and Y over all of D and C for its
// slice; deterministic.

constexpr int kWideCols = 128;  // output columns a block owns

inline int wide_slices(int d, int c) {
  return ((d > c ? d : c) + kWideCols - 1) / kWideCols;
}

// float32 (b), (c): the scalar kernel's rows and tiles of 32 columns with
// an output slice of 128 columns per block (32 accumulators a thread for
// each output), the b1 and b2 tiles in shared memory in chunks of cw =
// min(wp, kF32Chunk) columns (wp: the sliced width, a multiple of 128; zero
// past D and C; rows of cw + 1 floats), and a thread's own row of a1 and
// a2 read from global memory (through L1). Up to wp = 512 a chunk is the
// whole width. Above, X and Y add up chunk by chunk, and the chunk that
// holds the block's slice comes last, so that it is in shared memory for
// the output products.
constexpr int kF32Chunk = 512;

__host__ __device__ inline int f32_chunk(int wp) {
  return wp < kF32Chunk ? wp : kF32Chunk;
}

__host__ __device__ inline size_t f32_wide_smem_floats(int wp) {
  return (size_t)2 * kF32Cols * (f32_chunk(wp) + 1) +
         (size_t)2 * kF32Rows * kF32LdP + 2 * kF32Cols;
}

// Columns col0 .. col0 + cw - 1 of rows r0 .. r0 + kF32Cols - 1 of a
// (count x w) matrix into shared rows of ld floats, zero past w and count.
__device__ __forceinline__ void load_f32_cols(float* dst, const float* src,
                                              int r0, int count, int w,
                                              int col0, int cw, int ld) {
  for (int i = threadIdx.x; i < kF32Cols * cw; i += kF32Threads) {
    const int r = i / cw, j = i - r * cw;
    dst[r * ld + j] = r0 + r < count && col0 + j < w
                          ? src[(size_t)(r0 + r) * w + col0 + j]
                          : 0.f;
  }
}

template <bool KEY_ROWS>
__global__ void __launch_bounds__(kF32Threads)
attention_bwd_scalar_wide_kernel(const float* __restrict__ a1,
                                 const float* __restrict__ a2,
                                 const float* __restrict__ b1,
                                 const float* __restrict__ b2,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 float* __restrict__ out_d,
                                 float* __restrict__ out_c, int rows,
                                 int cols, int d, int c, int wp) {
  constexpr int kU = kF32Cols / 4, kV = kWideCols / 4;
  const int cw = f32_chunk(wp), ld = cw + 1;
  extern __shared__ float4 smem4[];
  float* b1s = reinterpret_cast<float*>(smem4);  // [kF32Cols][ld]
  float* b2s = b1s + kF32Cols * ld;              // [kF32Cols][ld]
  float* ps = b2s + kF32Cols * ld;               // [kF32Rows][kF32LdP]
  float* dss = ps + kF32Rows * kF32LdP;          // [kF32Rows][kF32LdP]
  float* lse_s = dss + kF32Rows * kF32LdP;       // [kF32Cols], log2 units
  float* dl_s = lse_s + kF32Cols;                // [kF32Cols]

  const int tid = threadIdx.x, r = tid >> 2, part = tid & 3;
  const int row = blockIdx.x * kF32Rows + r, col0 = blockIdx.z * kWideCols;
  const size_t bi = blockIdx.y;
  const size_t queries = KEY_ROWS ? cols : rows;
  const bool live = row < rows;
  const float* a1r = a1 + (bi * rows + (live ? row : 0)) * d;
  const float* a2r = a2 + (bi * rows + (live ? row : 0)) * c;
  b1 += bi * cols * d;
  b2 += bi * cols * c;
  lse += bi * queries;
  delta += bi * queries;
  const float lse_r = !KEY_ROWS && live ? lse[row] * kLog2e : 0.f;
  const float dl_r = !KEY_ROWS && live ? delta[row] : 0.f;
  float acc_d[kV], acc_c[KEY_ROWS ? kV : 1];
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    acc_d[v] = 0.f;
    if constexpr (KEY_ROWS) acc_c[v] = 0.f;
  }

  // chunks of D and of C; the ones that hold col0 come last
  const int nd = (d + cw - 1) / cw, nc = (c + cw - 1) / cw;
  const int last_d = col0 / cw < nd ? col0 / cw : nd - 1;
  const int last_c = col0 / cw < nc ? col0 / cw : nc - 1;
  for (int c0 = 0; c0 < cols; c0 += kF32Cols) {
    // X and Y of row r at columns part + 4 u, over all of D and C
    float x[kU], y[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) x[u] = y[u] = 0.f;
    for (int i = 0; i < nd + nc; ++i) {
      const bool on_d = i < nd;
      const int ch = on_d ? (last_d + 1 + i) % nd : (last_c + 1 + i - nd) % nc;
      const int w = on_d ? d : c, e0 = ch * cw;
      const int we = w - e0 < cw ? w - e0 : cw;
      float* bs = on_d ? b1s : b2s;
      __syncthreads();  // the last tile or chunk is no longer read
      load_f32_cols(bs, on_d ? b1 : b2, c0, cols, w, e0, cw, ld);
      if (i == 0 && KEY_ROWS && tid < kF32Cols) {
        lse_s[tid] = c0 + tid < cols ? lse[c0 + tid] * kLog2e : INFINITY;
        dl_s[tid] = c0 + tid < cols ? delta[c0 + tid] : 0.f;
      }
      __syncthreads();
      if (!live) continue;
      if (on_d) {
        for (int e = 0; e < we; ++e) {
          const float av = a1r[e0 + e];
#pragma unroll
          for (int u = 0; u < kU; ++u)
            x[u] = fmaf(av, bs[(part + 4 * u) * ld + e], x[u]);
        }
      } else {
        for (int e = 0; e < we; ++e) {
          const float av = a2r[e0 + e];
#pragma unroll
          for (int u = 0; u < kU; ++u)
            y[u] = fmaf(av, bs[(part + 4 * u) * ld + e], y[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = part + 4 * u;
      const float l2 = KEY_ROWS ? lse_s[j] : lse_r;
      const float dl = KEY_ROWS ? dl_s[j] : dl_r;
      const float p = c0 + j < cols ? exp2f(fmaf(x[u], kLog2e, -l2)) : 0.f;
      ps[r * kF32LdP + j] = p;
      dss[r * kF32LdP + j] = p * (y[u] - dl);
    }
    __syncwarp();  // the four threads of row r share a warp
    // the slice's columns, in the chunks loaded last
    for (int j = 0; j < kF32Cols; ++j) {
      if (col0 < d) {
        const float ds = dss[r * kF32LdP + j];
        const float* b1r = b1s + j * ld + col0 - last_d * cw + part;
#pragma unroll
        for (int v = 0; v < kV; ++v)
          acc_d[v] = fmaf(ds, b1r[4 * v], acc_d[v]);
      }
      if constexpr (KEY_ROWS) {
        if (col0 < c) {
          const float p = ps[r * kF32LdP + j];
          const float* b2r = b2s + j * ld + col0 - last_c * cw + part;
#pragma unroll
          for (int v = 0; v < kV; ++v)
            acc_c[v] = fmaf(p, b2r[4 * v], acc_c[v]);
        }
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int v = 0; v < kV; ++v) {
    const int e = col0 + part + 4 * v;
    if (e < d) out_d[(bi * rows + row) * d + e] = acc_d[v];
    if constexpr (KEY_ROWS)
      if (e < c) out_c[(bi * rows + row) * c + e] = acc_c[v];
  }
}

template <bool KEY_ROWS>
int launch_f32_wide(const void* a1, const void* a2, const void* b1,
                    const void* b2, const float* lse, const float* delta,
                    void* out_d, void* out_c, int b, int rows, int cols,
                    int d, int c, cudaStream_t s) {
  auto kernel = attention_bwd_scalar_wide_kernel<KEY_ROWS>;
  // wp: the sliced width of b1 and b2 (both D and C); the query rows'
  // output, dQ, has slices of D only
  const int wp = wide_slices(d, c) * kWideCols;
  const int slices = KEY_ROWS ? wide_slices(d, c) : wide_slices(d, d);
  const size_t smem = f32_wide_smem_floats(wp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((rows + kF32Rows - 1) / kF32Rows, b, slices);
  kernel<<<grid, kF32Threads, smem, s>>>(
      static_cast<const float*>(a1), static_cast<const float*>(a2),
      static_cast<const float*>(b1), static_cast<const float*>(b2), lse,
      delta, static_cast<float*>(out_d), static_cast<float*>(out_c), rows,
      cols, d, c, wp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the workspace that flash_attention_backward_launch needs:
// float32, Dl (b, n); bfloat16 (D and C up to 128), the statistics (b,
// npad) float2 and the dQ accumulator (b, npad, WP) float32, npad = n
// rounded up to the tile.
long long flash_attention_backward_workspace(int dtype, int b, int n, int d,
                                             int c) {
  if (dtype == 0) return 4LL * b * n;
  const long long npad = (long long)(n + kBr - 1) / kBr * kBr;
  return 8LL * b * npad + 4LL * b * npad * padded_width(d > c ? d : c);
}

// The one-pass bf16 kernel's split for this problem (D and C up to 128;
// wider calls run the cluster kernel on the wrapper's
// backward_cluster_split): split[0..7] = {keys a block (Bc), queries a
// tile, stages, blocks, shared memory bytes, padded width WP, blocks
// resident on an SM, output column slices}.
void flash_attention_backward_plan(int b, int m, int d, int c, int* split) {
  split[7] = 1;
  switch (padded_width(d > c ? d : c)) {
    case 16: plan_of<16>(b, m, split); break;
    case 32: plan_of<32>(b, m, split); break;
    case 64: plan_of<64>(b, m, split); break;
    default: plan_of<128>(b, m, split);
  }
}

// dtype: 0 = float32 (scalar kernels), 1 = bfloat16 (the one-pass wgmma
// kernel, D and C up to 128; wider bf16 calls go to
// flash_attention_backward_cluster_launch, and are refused here). q (b,
// n, d), k (b, m, d), v (b, m, c), out and dout (b, n, c), and dq, dk, dv
// (the shapes of q, k, v) are contiguous in dtype; lse (b, n) holds the
// forward's float32 log-sum-exp; workspace holds
// flash_attention_backward_workspace bytes. In bfloat16, d and c must be
// multiples of 8 and q, k, v, out, dout and dq 16-byte aligned. Three
// launches on the stream. Returns the first CUDA error code, 0 if all
// three launched.
int flash_attention_backward_launch(int dtype, const void* q, const void* k,
                                    const void* v, const void* out,
                                    const void* dout, const float* lse,
                                    void* dq, void* dk, void* dv,
                                    void* workspace, int b, int n, int m,
                                    int d, int c, void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || m <= 0 || d <= 0 || c <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = d > 128 || c > 128;
  if (dtype == 0) {
    float* delta = static_cast<float*>(workspace);
    const long long rows = (long long)b * n;
    attention_bwd_delta_kernel<<<(int)((rows + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(out), static_cast<const float*>(dout),
        delta, rows, c);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    if (wide) {
      err = launch_f32_wide<true>(k, v, q, dout, lse, delta, dk, dv, b, m,
                                  n, d, c, s);
      if (err != 0) return err;
      return launch_f32_wide<false>(q, dout, k, v, lse, delta, dq, nullptr,
                                    b, n, m, d, c, s);
    }
    // key rows (dK, dV), then query rows (dQ)
    err = dispatch_f32<true>(k, v, q, dout, lse, delta, dk, dv, b, m, n, d,
                             c, s);
    if (err != 0) return err;
    return dispatch_f32<false>(q, dout, k, v, lse, delta, dq, nullptr, b, n,
                               m, d, c, s);
  }
  if (wide || d % 8 || c % 8 || !aligned16(q) || !aligned16(k) ||
      !aligned16(v) || !aligned16(out) || !aligned16(dout) || !aligned16(dq))
    return (int)cudaErrorInvalidValue;
  const int wp = padded_width(d > c ? d : c);
  const int npad = (n + kBr - 1) / kBr * kBr;
  float2* stats = static_cast<float2*>(workspace);
  float* dq_acc = reinterpret_cast<float*>(stats + (size_t)b * npad);
  const long long rows = (long long)b * npad;
  attention_bwd_prologue_kernel<<<(int)((rows + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse,
      stats, dq_acc, b, n, npad, c, wp);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  switch (wp) {
    case 16: err = launch_width<16>(q, k, v, dout, stats, dq_acc, dk, dv, b,
                                    n, m, d, c, s); break;
    case 32: err = launch_width<32>(q, k, v, dout, stats, dq_acc, dk, dv, b,
                                    n, m, d, c, s); break;
    case 64: err = launch_width<64>(q, k, v, dout, stats, dq_acc, dk, dv, b,
                                    n, m, d, c, s); break;
    default: err = launch_width<128>(q, k, v, dout, stats, dq_acc, dk, dv, b,
                                     n, m, d, c, s);
  }
  if (err != 0) return err;
  const long long chunks = (long long)b * n * (d / 8);
  attention_bwd_dq_kernel<<<(int)((chunks + 255) / 256), 256, 0, s>>>(
      dq_acc, static_cast<bf16*>(dq), b, n, npad, d, 1, wp);
  return (int)cudaGetLastError();
}

// The cluster kernel's shared memory bytes for a plan (cluster R, queries
// BR a tile, stages, extra stages, rounds of a tile's exchange), and its
// workspace bytes for (b, n): the statistics (b, npad) float2 and the dQ
// accumulator (b, 2 R G, npad, 128) float32, npad = n rounded up to BR.
int flash_attention_backward_cluster_smem(int split, int rows, int stages,
                                          int xstages, int rounds) {
  return cl_smem_bytes(split, rows, stages, xstages, rounds);
}

long long flash_attention_backward_cluster_workspace(int b, int n, int split,
                                                     int groups, int rows) {
  const long long npad = (long long)(n + rows - 1) / rows * rows;
  return 8LL * b * npad + 4LL * b * 2 * split * groups * npad * kClSlice;
}

// The dynamic shared memory attribute of the cluster kernel of BR queries
// a tile and mode (0 one column group; 1, 2 column groups and the rounds
// of a tile's exchange) (what its last launch set), or a negative CUDA
// error code.
int flash_attention_backward_cluster_smem_attr(int rows, int mode) {
  if (rows == 32 && mode == 0) return cluster_bwd_smem_attr<32, 0>();
  if (rows == 16 && mode == 0) return cluster_bwd_smem_attr<16, 0>();
  if (rows == 16 && mode == 1) return cluster_bwd_smem_attr<16, 1>();
  if (rows == 16 && mode == 2) return cluster_bwd_smem_attr<16, 2>();
  return -(int)cudaErrorInvalidValue;
}

// bfloat16 with D or C above 128: the cluster kernel on the plan {cluster,
// groups, queries, stages, extra stages, rounds, smem} of the wrapper's
// backward_split (its fields "cluster", "groups", "queries", "stages",
// "extra_stages", "rounds", "smem"), three launches: the prologue
// (statistics, the accumulator zeroed), the cluster kernel, dQ. Tensors
// and workspace (flash_attention_backward_cluster_workspace bytes) as for
// flash_attention_backward_launch in bfloat16. A plan the kernel cannot
// run returns cudaErrorInvalidValue; otherwise the first CUDA error code.
int flash_attention_backward_cluster_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, void* dq, void* dk, void* dv,
    void* workspace, int b, int n, int m, int d, int c, const int* plan,
    void* stream) {
  const int split = plan[0], groups = plan[1], rows = plan[2];
  const int stages = plan[3], xstages = plan[4], rounds = plan[5];
  const int smem = plan[6];
  const bool ok =
      b > 0 && b <= 65535 && n > 0 && m > 0 && d > 0 && c > 0 && d % 8 == 0 &&
      c % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
      aligned16(out) && aligned16(dout) && aligned16(dq) && split >= 1 &&
      split <= kClMaxCluster && groups >= 1 && groups <= 65535 &&
      (long long)kClCols * split * groups >= (d > c ? d : c) &&
      (rows == 16 || (rows == 32 && groups == 1)) && stages >= kClMinStages &&
      stages <= kClMaxStages && (groups == 1) == (xstages == 0) &&
      xstages <= kClMaxExtraStages && (rounds == 1 || rounds == 2) &&
      (groups > 1 || rounds == 1) &&
      smem == cl_smem_bytes(split, rows, stages, xstages, rounds) &&
      smem <= kSmemLimit &&
      (long long)split * ((m + kClKeys - 1) / kClKeys) <= 0x7fffffff;
  if (!ok) return (int)cudaErrorInvalidValue;
  CUtensorMap k_map, v_map, q_map, do_map;
  if (!hp::make_panels_map(&k_map, k, b, m, d, kClKeys, kClCols / 8) ||
      !hp::make_panels_map(&v_map, v, b, m, c, kClKeys, kClCols / 8) ||
      !hp::make_panels_map(&q_map, q, b, n, d, rows, kClCols / 8) ||
      !hp::make_panels_map(&do_map, dout, b, n, c, rows, kClCols / 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npad = (n + rows - 1) / rows * rows, slices = 2 * split * groups;
  float2* stats = static_cast<float2*>(workspace);
  float* dq_acc = reinterpret_cast<float*>(stats + (size_t)b * npad);
  const long long qrows = (long long)b * npad;
  // the accumulator zeroed by the runtime's memset (coalesced), the
  // prologue computing only the statistics
  int err = (int)cudaMemsetAsync(dq_acc, 0, 4 * qrows * slices * kClSlice, s);
  if (err != 0) return err;
  attention_bwd_prologue_kernel<<<(int)((qrows + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse,
      stats, dq_acc, b, n, npad, c, 0);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const ClusterBwdArgs a{stats, dq_acc, static_cast<bf16*>(dk),
                         static_cast<bf16*>(dv), n, m, d, c, npad, split,
                         groups, stages, xstages};
  if (rows == 32)
    err = launch_cluster_bwd<32, 0>(k_map, v_map, q_map, do_map, a, b, smem, s);
  else if (groups == 1)
    err = launch_cluster_bwd<16, 0>(k_map, v_map, q_map, do_map, a, b, smem, s);
  else if (rounds == 1)
    err = launch_cluster_bwd<16, 1>(k_map, v_map, q_map, do_map, a, b, smem, s);
  else
    err = launch_cluster_bwd<16, 2>(k_map, v_map, q_map, do_map, a, b, smem, s);
  if (err != 0) return err;
  const long long chunks = (long long)b * n * (d / 8);
  attention_bwd_dq_kernel<<<(int)((chunks + 255) / 256), 256, 0, s>>>(
      dq_acc, static_cast<bf16*>(dq), b, n, npad, d, slices, kClSlice);
  return (int)cudaGetLastError();
}

}  // extern "C"
