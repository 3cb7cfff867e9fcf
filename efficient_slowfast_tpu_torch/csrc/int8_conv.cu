// K3: int8 x int8 -> int32 3-D convolution for Hopper (sm_90a), the
// int8 serving convs of TPU.INT8_EVAL / TPU.INT8_SPATIAL.
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA
// (efficient_slowfast_tpu/ops/conv.py:236-247, lax.dot_general of the
// pointwise convs on the strided slice, and :302-313,
// lax.conv_general_dilated of the others, both with
// preferred_element_type=int32, dequantized as f32(acc) * (s_act * s_w),
// rounded to the compute dtype, then + bias in that dtype). No stock
// PyTorch CUDA op computes an int8 3-D convolution. What this file computes
// is bit for bit what those XLA products compute.
//
// Two launches a conv, planned per shape by ops/kernels/int8_conv.py::plan
// (the tile, split and ring below arrive in its int array):
//
// 1. conv_quantize_kernel reads x (bf16 or f32, channels-last) once and
//    writes its int8 codes once, channels-last, as XLA rounds them:
//    s_act = act_max * f32(1/127) (XLA's rewrite of the division by 127,
//    __fmul_rn), x widened to f32, __fdiv_rn by s_act, rintf (half to
//    even), clamp to +-127. A pointwise conv keeps only its strided
//    positions (JAX slices before it quantizes); any other conv gets its
//    zero padding written into the buffer, so that no later gather tests a
//    bound. Channels are padded to a multiple of 4 with zero codes, and the
//    buffer's rows to the gather's alignment. The 3-channel stride-2 stems
//    are written as 2 x 2 blocks of positions (16 bytes each, "s2d"), so
//    that their conv is the kernel halved at stride 1 with 16-byte
//    gathers. Where that changes the weights' K layout (the stems), the
//    same launch writes the matching copy of the weight codes; and it
//    zeroes the split-K counters. 16-byte stores, byte-bound.
// 2. conv_gemm_kernel<NWG, BN, OUT>, an implicit GEMM on the codes only:
//    M = output positions, N = Co, K = kt kh kw Cp tap-major. For a fixed
//    (dt, dy) the kw taps of an output row are kw * Cp contiguous bytes of
//    the buffer (a "segment"), whatever the stride, so A's row is kt * kh
//    segments, each padded to the gather's 4-, 8- or 16-byte unit. A ring
//    of 128-byte K slabs (four k32 steps) in shared memory, one full and
//    one empty mbarrier a stage, is fed by a producer warpgroup and drained
//    by NWG consumer warpgroups (64 output rows each) that run wgmma
//    m64nBNk32 s8 x s8 -> s32 from shared memory, both operands K-major in
//    the 128-byte swizzle (hopper.cuh, desc_sw128). B: one TMA box of 128 K
//    bytes x BN rows a slab, from the codes (Co, Kp). A: a TMA box of the (M,
//    Cp) code matrix for a pointwise conv with Cp % 16 == 0; else cp.async
//    gathers of 4, 8 or 16 bytes by the producer warpgroup (a thread copies
//    one chunk position of every (128 / cpr)-th row, so that an instruction
//    reads whole 128-byte runs of rows and writes them to the swizzled tile
//    without bank conflicts; each chunk's source is the row's offset plus the
//    chunk's, from two small tables in shared memory); the slab's mbarrier
//    counts each thread's copies as they land (cp.async.mbarrier.arrive), so
//    no thread waits for its own. The A route is gathers because an M tile of
//    the path (128 output positions of a frame of 8-128 columns, ragged at
//    clip and tile edges) is no box of a tiled tensor map, and a gather of
//    pre-quantized rows reads each code from L1/L2 at one instruction per
//    4-16 bytes. Blocks are persistent (at most one or two an SM, by BN):
//    each walks tiles gridDim.x apart, its producer running on into the next
//    tile's slabs while the consumers store this one's. Where the grid would
//    give fewer than ~132 tiles the K slabs are split too: each split writes
//    its int32 partial, and the last of a tile (a counter) adds the others'
//    in a fixed order, exactly, and alone runs the epilogue. Epilogue: y =
//    f32(acc) * (s_act * s_w[n]) rounded to the output dtype, then + bias in
//    that dtype, each step rounded as XLA rounds it (__int2float_rn,
//    __fmul_rn, __fadd_rn: no fused multiply-add), or the int32 sum itself
//    (OUT 2); staged through shared memory for 16-byte stores.
//
// What bounds each class of shape on the H100 (chip_smoke.py phase 15
// computes the bound per shape): the fast pathway's convs (Co 8-256, K
// 8-576), the stems and most pointwise convs do few operations a byte and
// are bound by bytes: here the quantize pass's read of x and the codes'
// write and read are the traffic, and the GEMM reads each code from L2
// once per tap; the slow s4/s5 temporal and 3x3 convs (K 2304-6144) are
// bound by operations: wgmma from a ring 2-8 slabs deep keeps the tensor
// cores fed, and split-K gives the 16-64 output tiles of s4/s5 the card's
// 132 SMs. Measured (PERF.md, PR 14), the slow convs run at the L2's read
// rate instead, re-reading A per N tile and B per M tile, and the fast
// stem's 164k slabs each pay the ring's per-slab cost.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr int kSlab = 128;  // K bytes a ring stage
constexpr int kMaxStages = 8;
constexpr float kInv127 = 0.007874015718698502f;

// The plan, as ops/kernels/int8_conv.py::Plan.args lays it out (all int).
struct Plan {
  // x (B, T, H, W, Ci), channels-last
  int b, t, h, w, ci;
  // the code buffer (B, Tq, Hq, Wq, Cp): position q reads x at q * qs + qo
  int tq, hq, wq, cp, qst, qsh, qsw, qot, qoh, qow;
  // the conv over the buffer (no padding) and its output
  int kt, kh, kw, st, sh, sw, to, ho, wo, co, m;
  // K: segments of seg bytes (kw Cp of them real), A's K extent, B's row
  // length (a multiple of 32), the codes' row length; gather unit (4, 8,
  // 16 bytes; 0: A by TMA); relayout: B is rewritten for the padded K.
  // s2d: a 3-channel stride-2 stem's buffer holds 2 x 2 blocks of padded
  // positions (16 bytes: (a, b) sub-position, cp0 channels), position q
  // reading x at 2 q + (a, b) + qo, and the conv is its kernel halved
  // (kh0 x kw0 taps originally) at stride 1
  int gather, seg, k_a, k_b, kp, relayout, s2d, kh0, kw0, cp0;
  // tiles: 64 NWG rows, BN columns, K split, ring stages, shared memory
  int nwg, bn, split, stages, smem;
  // byte offsets into the scratch of the codes' copy, the partials, the
  // counters; the buffer's bytes (a multiple of 16)
  int off_b, off_ws, off_cnt, q_bytes;
};
constexpr int kPlanInts = sizeof(Plan) / sizeof(int);

template <int NWG, int BN, int OUT>
struct Tile {
  static constexpr int kBM = 64 * NWG;
  static constexpr int kThreads = 128 * (NWG + 1);
  // blocks an SM: narrow tiles take two, so that one block's epilogue and
  // ring fill overlap the other's products
  static constexpr int kCtas = BN <= 64 ? 2 : 1;
  // two consumer warpgroups of one block an SM take the producer's
  // registers (168 at entry; 40 producer, 232 consumer)
  static constexpr bool kRealloc = NWG == 2 && kCtas == 1;
  static constexpr int kStageBytes = (kBM + BN) * kSlab;
  static constexpr int kOutSize = OUT == 1 ? 2 : 4;
  static constexpr int kEpiLd = BN * kOutSize + 16;  // bytes a staged row
};

struct GemmArgs {
  Plan p;
  const int8_t* a;  // the code buffer
  const float* w_scale;
  const float* act_max;
  const void* bias;  // (Co,) in the output dtype, or null
  void* out;         // (M, Co)
  int* ws;           // split-K partials (split, M, n_tiles BN)
  int* counters;     // one a tile
  int out_vec;       // 16-byte output stores allowed
};

// ---- 1. the quantize pass ---------------------------------------------

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t code(float v, float s_act) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s_act)), -127.f), 127.f);
  return (uint32_t)((int)q & 0xff);
}

// 8 consecutive elements from a 16-byte aligned address
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

struct QuantArgs {
  Plan p;
  const void* x;
  const float* act_max;
  const int8_t* codes;  // (Co, Kp)
  int8_t* q;            // the code buffer
  int8_t* bq;           // (Co, k_b) when p.relayout
  int* counters;
  int n_counters;
  int vec;  // Ci % 8 == 0 and x 16-byte aligned
};

// x's element offset of buffer pixel `pix` (B, Tq, Hq, Wq order), moved by
// (da, db) in h and w (an s2d sub-position), or -1 where it is padding
__device__ __forceinline__ long long source_pixel(const Plan& p, unsigned pix,
                                                  int da, int db) {
  const unsigned wq = pix % p.wq;
  unsigned r = pix / p.wq;
  const unsigned hq = r % p.hq;
  r /= p.hq;
  const unsigned tq = r % p.tq;
  const unsigned b = r / p.tq;
  const int ti = (int)tq * p.qst + p.qot,
            hi = (int)hq * p.qsh + da + p.qoh,
            wi = (int)wq * p.qsw + db + p.qow;
  if (ti < 0 || ti >= p.t || hi < 0 || hi >= p.h || wi < 0 || wi >= p.w)
    return -1;
  return ((((long long)b * p.t + ti) * p.h + hi) * p.w + wi) * p.ci;
}

// Buffer bytes, weight-copy bytes and counters are below 2^31 (the plan
// checks), so the offsets are 32-bit.
template <typename Tin>
__global__ void __launch_bounds__(256)
    conv_quantize_kernel(const QuantArgs a) {
  const Plan& p = a.p;
  const Tin* x = static_cast<const Tin*>(a.x);
  const float s_act = __fmul_rn(*a.act_max, kInv127);
  const unsigned q_real =
      (unsigned)p.b * p.tq * p.hq * p.wq * p.cp;  // bytes before slack
  const unsigned chunks = (unsigned)p.q_bytes / 16;
  const unsigned nb = p.relayout ? (unsigned)p.co * p.k_b : 0;
  const unsigned total = chunks + nb + a.n_counters;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    if (i < chunks) {
      uint32_t word[4] = {0, 0, 0, 0};
      const unsigned o = 16 * i;
      if (a.vec && p.cp % 16 == 0) {
        // 16 channels of one position (Cp = Ci, a multiple of 16)
        const long long src = o < q_real ? source_pixel(p, o / p.cp, 0, 0)
                                         : -1;
        if (src >= 0) {
          float v[2][8];
          load8(x + src + o % p.cp, v[0]);
          load8(x + src + o % p.cp + 8, v[1]);
#pragma unroll
          for (int e = 0; e < 16; ++e)
            word[e / 4] |= code(v[e / 8][e % 8], s_act) << (8 * (e % 4));
        }
      } else if (a.vec) {
        // two groups of 8 channels (Cp = Ci, a multiple of 8)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const unsigned o8 = o + 8 * half;
          if (o8 >= q_real) break;
          const long long src = source_pixel(p, o8 / p.cp, 0, 0);
          if (src < 0) continue;
          float v[8];
          load8(x + src + o8 % p.cp, v);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            word[2 * half + e / 4] |= code(v[e], s_act) << (8 * (e % 4));
        }
      } else if (p.s2d) {
        // one position a chunk: sub-position j's cp0 = 4 channels are
        // word j (channels past Ci and padding are zero codes)
        if (o < q_real) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const long long src = source_pixel(p, o / 16, j >> 1, j & 1);
            if (src < 0) continue;
            for (int ch = 0; ch < p.ci; ++ch)
              word[j] |= code(widen(x[src + ch]), s_act) << (8 * ch);
          }
        }
      } else {
        // byte by byte: channels past Ci and padding are zero codes
        unsigned pix = o / p.cp;
        int c = o % p.cp;
        long long src = source_pixel(p, pix, 0, 0);
        for (int e = 0; e < 16 && o + e < q_real; ++e) {
          if (src >= 0 && c < p.ci)
            word[e / 4] |= code(widen(x[src + c]), s_act) << (8 * (e % 4));
          if (++c == p.cp) {
            c = 0;
            src = source_pixel(p, ++pix, 0, 0);
          }
        }
      }
      *reinterpret_cast<uint4*>(a.q + o) =
          make_uint4(word[0], word[1], word[2], word[3]);
    } else if (i < chunks + nb) {
      // the weight codes in the padded K layout: segment s = (dt, dy) of
      // the buffer's conv, byte o of it tap dx = o / Cp, channel o % Cp
      // (for s2d, sub-position and channel), of the codes' (dt, dy, dx)
      const unsigned j = i - chunks;
      const int n = (int)(j / p.k_b), k = (int)(j % p.k_b);
      int8_t v = 0;
      if (k < p.k_a) {
        const int s = k / p.seg, o = k % p.seg, dt = s / p.kh;
        int dy = s % p.kh, dx = o / p.cp, c = o % p.cp;
        if (p.s2d) {
          const int sub = c / p.cp0;
          dy = 2 * dy + (sub >> 1);
          dx = 2 * dx + (sub & 1);
          c %= p.cp0;
        }
        if (dy < p.kh0 && dx < p.kw0 && c < p.ci)
          v = a.codes[(long long)n * p.kp +
                      ((dt * p.kh0 + dy) * p.kw0 + dx) * p.ci + c];
      }
      a.bq[j] = v;
    } else {
      a.counters[i - chunks - nb] = 0;
    }
  }
}

// ---- 2. the GEMM --------------------------------------------------------

// Shared memory of a block, from a 1024-byte aligned base: the ring (A's
// BM x 128 and B's BN x 128 bytes a stage, each in the 128-byte swizzle),
// the staged output tile, two mbarriers a stage and the split-K flag, two
// tiles' column scales and biases, the tile's row offsets, the gathers'
// chunk offsets.
struct Smem {
  int ring, epi, bars, cols, rows, chunks, total;
  __host__ __device__ Smem(int nwg, int bn, int stages, int out_size,
                           int n_chunks) {
    const int bm = 64 * nwg;
    ring = (bm + bn) * kSlab * stages;
    epi = ring;
    bars = epi + (bm * (bn * out_size + 16) + 15) / 16 * 16;
    cols = bars + 16 * stages + 16;
    rows = cols + 16 * bn;
    chunks = rows + 4 * bm;
    total = chunks + (4 * n_chunks + 15) / 16 * 16 + 1024;  // + alignment
  }
};

int smem_bytes(int nwg, int bn, int stages, int out_dtype, int chunks) {
  return Smem(nwg, bn, stages, out_dtype == 1 ? 2 : 4, chunks).total;
}

// A's slab [k0, k0 + 128) by cp.async, UNIT bytes a copy: thread pt of the
// producer warpgroup copies chunk pt % cpr of every (128 / cpr)-th row, so
// that an instruction reads whole 128-byte runs of rows and writes them to
// the swizzled tile without bank conflicts. A chunk's source is its row's
// offset (rowoff, -1 past M) plus its own (koff); the row offsets are read
// before the copies are issued.
template <int UNIT, int BM>
__device__ __forceinline__ void gather(unsigned char* st, const int8_t* a,
                                       const int* koff, const int* rowoff,
                                       int k0, int k_a, int pt) {
  constexpr int kCpr = kSlab / UNIT, kStep = 128 / kCpr, kRows = BM / kStep;
  const int c = pt % kCpr, r0 = pt / kCpr, kb = c * UNIT;
  if (k0 + kb >= k_a) return;
  const int8_t* src = a + koff[(k0 + kb) / UNIT];
  int off[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) off[q] = rowoff[r0 + q * kStep];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int r = r0 + q * kStep;
    if (off[q] >= 0)
      hp::cp_async<UNIT>(st + r * kSlab + (((kb >> 4) ^ (r & 7)) << 4) +
                             (kb & 15),
                         src + off[q]);
  }
}

template <int NWG, int BN, int OUT>
__global__ void __launch_bounds__(Tile<NWG, BN, OUT>::kThreads,
                                  Tile<NWG, BN, OUT>::kCtas)
    conv_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                     const __grid_constant__ CUtensorMap b_map,
                     const __grid_constant__ GemmArgs g) {
  using T = Tile<NWG, BN, OUT>;
  constexpr int BM = T::kBM;
  const Plan& p = g.p;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Smem L(NWG, BN, p.stages, T::kOutSize,
               p.gather ? p.k_a / p.gather : 0);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + p.stages;
  int* last = reinterpret_cast<int*>(empty + p.stages);
  int* rowoff = reinterpret_cast<int*>(smem + L.rows);
  int* koff = reinterpret_cast<int*>(smem + L.chunks);
  unsigned char* stile = smem + L.epi;

  const int n_tiles = (p.co + BN - 1) / BN;
  const int units = (p.m + BM - 1) / BM * n_tiles * p.split;
  const int nk = p.k_b / kSlab + (p.k_b % kSlab != 0);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      // gathers: 128 cp.async arrivals and the B load's; TMA: one
      hp::mbar_init(&full[s], p.gather ? 129 : 1);
      hp::mbar_init(&empty[s], 4 * NWG);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  // the block walks units (tile, K split) from blockIdx.x, gridDim.x apart;
  // the producer runs ahead into the next unit's slabs while the consumers
  // finish this one's epilogue
  if (wg == NWG) {  // the producer warpgroup
    if constexpr (T::kRealloc) hp::reg_dealloc<40>();
    const int pt = threadIdx.x - 128 * NWG;
    if (!p.gather && pt != 0) return;
    if (pt == 0) {
      hp::prefetch_tensormap(&b_map);
      if (!p.gather) hp::prefetch_tensormap(&a_map);
    }
    if (p.gather) {
      // the chunks' offsets: segment s = (dt, dy) starts (dt Hq + dy) Wq
      // Cp bytes past the row's first tap
      for (int j = pt; j < p.k_a / p.gather; j += 128) {
        const int k = j * p.gather, s = k / p.seg, dt = s / p.kh;
        koff[j] = ((dt * p.hq + s - dt * p.kh) * p.wq) * p.cp + k - s * p.seg;
      }
    }
    int i = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int tile = u / p.split, split = u % p.split;
      const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
      const int ks0 = split * nk / p.split;
      const int nks = (split + 1) * nk / p.split - ks0;
      if (p.gather) {
        hp::named_barrier(2, 128);  // the last unit's gathers are issued
        for (int r = pt; r < BM; r += 128) {
          int m = m0 + r, off = -1;
          if (m < p.m) {
            const int wo = m % p.wo;
            m /= p.wo;
            const int ho = m % p.ho;
            m /= p.ho;
            const int to = m % p.to, b = m / p.to;
            off = (((b * p.tq + to * p.st) * p.hq + ho * p.sh) * p.wq +
                   wo * p.sw) * p.cp;
          }
          rowoff[r] = off;
        }
        hp::named_barrier(2, 128);
      }
      for (int j = 0; j < nks; ++j, ++i) {
        const int s = i % p.stages, k0 = (ks0 + j) * kSlab;
        if (i >= p.stages)
          hp::mbar_wait_bounded(&empty[s], (i / p.stages - 1) & 1);
        unsigned char* st = smem + s * T::kStageBytes;
        if (pt == 0) {
          hp::mbar_arrive_expect_tx(&full[s],
                                    (BN + (p.gather ? 0 : BM)) * kSlab);
          hp::tma_load_2d(st + BM * kSlab, &b_map, &full[s], k0, n0);
          if (!p.gather) hp::tma_load_2d(st, &a_map, &full[s], k0, m0);
        }
        if (p.gather) {
          if (p.gather == 16)
            gather<16, BM>(st, g.a, koff, rowoff, k0, p.k_a, pt);
          else if (p.gather == 8)
            gather<8, BM>(st, g.a, koff, rowoff, k0, p.k_a, pt);
          else
            gather<4, BM>(st, g.a, koff, rowoff, k0, p.k_a, pt);
          hp::cp_async_mbar_arrive(&full[s]);  // once the copies land
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of each tile
  if constexpr (T::kRealloc) hp::reg_alloc<232>();
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  // d[4 j + e] is row 16 warp + g + 8 (e / 2), column 8 j + 2 t + e % 2
  const int g4 = lane / 4, t4 = lane % 4;
  const int r0 = 64 * wg + 16 * warp + g4;
  const float s_act = __fmul_rn(*g.act_max, kInv127);
  int acc[BN / 2];
  int i = 0;
  for (int u = blockIdx.x, parity = 0; u < units;
       u += gridDim.x, parity ^= 1) {
    const int tile = u / p.split, split = u % p.split;
    const int m0 = tile / n_tiles * BM, n0 = tile % n_tiles * BN;
    const int ks0 = split * nk / p.split;
    const int nks = (split + 1) * nk / p.split - ks0;
    // the tile's column scales s_act s_w[n] and biases, one load a thread,
    // into this unit's half of the table (the epilogue's first barrier
    // publishes them; the unit before last read the other half)
    float* cols = reinterpret_cast<float*>(smem + L.cols) + 2 * BN * parity;
    if constexpr (OUT != 2) {
      for (int c = threadIdx.x; c < BN; c += 128 * NWG) {
        const int n = n0 + c;
        float sc = 0.f, bi = 0.f;
        if (n < p.co) {
          sc = __fmul_rn(s_act, g.w_scale[n]);
          if (g.bias != nullptr)
            bi = OUT == 0 ? static_cast<const float*>(g.bias)[n]
                          : __bfloat162float(
                                static_cast<const __nv_bfloat16*>(g.bias)[n]);
        }
        cols[c] = sc;
        cols[BN + c] = bi;
      }
    }
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0;
    int prev = -1;
    for (int j = 0; j < nks; ++j, ++i) {
      const int s = i % p.stages, k0 = (ks0 + j) * kSlab;
      const int steps = min(kSlab / 32, (p.k_b - k0) / 32);
      hp::mbar_wait_bounded(&full[s], (i / p.stages) & 1);
      hp::fence_proxy_async();  // the gathers' cp.async writes, for wgmma
      const unsigned char* st = smem + s * T::kStageBytes;
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlab / 32; ++kk) {
        if (kk < steps)
          hp::WgmmaS8<BN>::run(
              acc, hp::desc_sw128(st + wg * 64 * kSlab + 32 * kk),
              hp::desc_sw128(st + BM * kSlab + 32 * kk), 1);
      }
      hp::wgmma_commit();
      if (p.stages > 1) {  // release the slab before this one
        hp::wgmma_wait<1>();
        if (prev >= 0 && lane == 0) hp::mbar_arrive(&empty[prev]);
        prev = s;
      } else {  // a ring of one: release this slab before the next load
        hp::wgmma_wait<0>();
        if (lane == 0) hp::mbar_arrive(&empty[s]);
      }
    }
    hp::wgmma_wait<0>();
    hp::fence_regs(acc);
    if (prev >= 0 && lane == 0) hp::mbar_arrive(&empty[prev]);

    if (p.split > 1) {
      const int nw = n_tiles * BN;
      int* ws = g.ws + (size_t)split * p.m * nw;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + r0 + 8 * h;
          if (m < p.m)
            *reinterpret_cast<int2*>(ws + (size_t)m * nw + n0 + 8 * j +
                                     2 * t4) =
                make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      __threadfence();
      hp::named_barrier(1, 128 * NWG);
      if (threadIdx.x == 0)
        *last = atomicAdd(&g.counters[tile], 1) == p.split - 1;
      hp::named_barrier(1, 128 * NWG);
      if (!*last) continue;
      __threadfence();
      for (int o = 0; o < p.split; ++o) {  // the other blocks' partials
        if (o == split) continue;
        const int* wo = g.ws + (size_t)o * p.m * nw;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = m0 + r0 + 8 * h;
            if (m < p.m) {
              const int2 v = __ldcg(reinterpret_cast<const int2*>(
                  wo + (size_t)m * nw + n0 + 8 * j + 2 * t4));
              acc[4 * j + 2 * h] += v.x;
              acc[4 * j + 2 * h + 1] += v.y;
            }
          }
      }
    }

    // dequantize into the staging tile (the last unit's stores have read
    // it), then 16-byte stores
    hp::named_barrier(1, 128 * NWG);
    // a thread's two adjacent columns (2 t, 2 t + 1 of each 8) go out as
    // one store: bf16 pairs rounded by one packed conversion (each half
    // rounded to nearest even, as two single ones would)
    const float* __restrict__ scales = cols;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const float2 sc = make_float2(scales[col], scales[col + 1]);
      const float2 bi = make_float2(scales[BN + col], scales[BN + col + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        unsigned char* dst =
            stile + (r0 + 8 * h) * T::kEpiLd + col * T::kOutSize;
        if constexpr (OUT == 2) {
          *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
        } else {
          float2 y = make_float2(__fmul_rn(__int2float_rn(v0), sc.x),
                                 __fmul_rn(__int2float_rn(v1), sc.y));
          if constexpr (OUT == 0) {
            if (g.bias != nullptr)
              y = make_float2(__fadd_rn(y.x, bi.x), __fadd_rn(y.y, bi.y));
            *reinterpret_cast<float2*>(dst) = y;
          } else {
            __nv_bfloat162 yb = __floats2bfloat162_rn(y.x, y.y);
            if (g.bias != nullptr) {
              const float2 yf = __bfloat1622float2(yb);
              yb = __floats2bfloat162_rn(__fadd_rn(yf.x, bi.x),
                                         __fadd_rn(yf.y, bi.y));
            }
            *reinterpret_cast<__nv_bfloat162*>(dst) = yb;
          }
        }
      }
    }
    hp::named_barrier(1, 128 * NWG);
    constexpr int kChunks = BN * T::kOutSize / 16;  // 16-byte chunks a row
    constexpr int kPer = 16 / T::kOutSize;          // elements a chunk
    unsigned char* out = static_cast<unsigned char*>(g.out);
    for (int idx = threadIdx.x; idx < BM * kChunks; idx += 128 * NWG) {
      const int row = idx / kChunks, ch = idx % kChunks;
      const int m = m0 + row, n = n0 + ch * kPer;
      if (m >= p.m || n >= p.co) continue;
      const unsigned char* src = stile + row * T::kEpiLd + ch * 16;
      unsigned char* dst = out + ((size_t)m * p.co + n) * T::kOutSize;
      if (g.out_vec && n + kPer <= p.co) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < kPer && n + e < p.co; ++e)
          memcpy(dst + e * T::kOutSize, src + e * T::kOutSize, T::kOutSize);
      }
    }
  }
}

template <int NWG, int BN, int OUT>
int launch_gemm(const CUtensorMap& a_map, const CUtensorMap& b_map,
                const GemmArgs& g, cudaStream_t stream) {
  using T = Tile<NWG, BN, OUT>;
  auto kernel = conv_gemm_kernel<NWG, BN, OUT>;
  static int sms[64] = {};  // per device: set up once, the SM count
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sms[dev]) {
    const int budget = T::kCtas == 1 ? 232448 : 233472 / T::kCtas - 1024;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, budget);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return (int)err;
  }
  const Plan& p = g.p;
  if (p.smem != smem_bytes(NWG, BN, p.stages, OUT,
                           p.gather ? p.k_a / p.gather : 0))
    return (int)cudaErrorInvalidValue;
  const int units =
      (p.m + T::kBM - 1) / T::kBM * ((p.co + BN - 1) / BN) * p.split;
  const int grid = units < sms[dev] * T::kCtas ? units : sms[dev] * T::kCtas;
  kernel<<<grid, T::kThreads, p.smem, stream>>>(a_map, b_map, g);
  return (int)cudaGetLastError();
}

template <int NWG, int BN>
int launch_out(int out_dtype, const CUtensorMap& a, const CUtensorMap& b,
               const GemmArgs& g, cudaStream_t s) {
  switch (out_dtype) {
    case 0: return launch_gemm<NWG, BN, 0>(a, b, g, s);
    case 1: return launch_gemm<NWG, BN, 1>(a, b, g, s);
    case 2: return launch_gemm<NWG, BN, 2>(a, b, g, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int NWG>
int launch_bn(int out_dtype, const CUtensorMap& a, const CUtensorMap& b,
              const GemmArgs& g, cudaStream_t s) {
  switch (g.p.bn) {
    case 8: return launch_out<NWG, 8>(out_dtype, a, b, g, s);
    case 16: return launch_out<NWG, 16>(out_dtype, a, b, g, s);
    case 32: return launch_out<NWG, 32>(out_dtype, a, b, g, s);
    case 64: return launch_out<NWG, 64>(out_dtype, a, b, g, s);
    case 128: return launch_out<NWG, 128>(out_dtype, a, b, g, s);
    case 256: return launch_out<NWG, 256>(out_dtype, a, b, g, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The plan's length in ints, the GEMM instantiations the library holds
// (NWG 1-2 x BN 8-256 x output dtype), and the shared memory of a tile.
int int8_conv_plan_ints() { return kPlanInts; }
int int8_conv_instantiations() { return 2 * 6 * 3; }
int int8_conv_smem_bytes(int nwg, int bn, int stages, int out_dtype,
                         int chunks) {
  return smem_bytes(nwg, bn, stages, out_dtype, chunks);
}

// in_dtype: 0 float32, 1 bfloat16; out_dtype: 0 float32, 1 bfloat16, 2 the
// int32 accumulator. x (B, T, H, W, Ci) channels-last; codes (Co, Kp) int8;
// bias null or (Co,) in the output dtype; out (B, To, Ho, Wo, Co); scratch
// (16-byte aligned) holds the code buffer and, at the plan's offsets, the
// codes' padded copy, the partials and the counters. quantize_only: the
// first launch alone (its buffer and copy are read back for checks).
// Returns the CUDA error of the launches (0 on success).
int int8_conv_launch(const int* plan, int plan_ints, int in_dtype,
                     int out_dtype, const void* x, const int8_t* codes,
                     const float* w_scale, const float* act_max,
                     const void* bias, void* out, void* scratch,
                     int quantize_only, cudaStream_t stream) {
  if (plan_ints != kPlanInts) return (int)cudaErrorInvalidValue;
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  if (p.nwg < 1 || p.nwg > 2 || p.stages < 1 || p.stages > kMaxStages ||
      p.split < 1 || p.k_b % 32 != 0 || p.q_bytes % 16 != 0 || p.m <= 0 ||
      (p.gather != 0 && p.gather != 4 && p.gather != 8 && p.gather != 16))
    return (int)cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  int8_t* q = reinterpret_cast<int8_t*>(base);
  int8_t* bq = p.relayout ? reinterpret_cast<int8_t*>(base + p.off_b) : nullptr;
  int* ws = p.split > 1 ? reinterpret_cast<int*>(base + p.off_ws) : nullptr;
  int* counters =
      p.split > 1 ? reinterpret_cast<int*>(base + p.off_cnt) : nullptr;
  const int tiles = (p.m + 64 * p.nwg - 1) / (64 * p.nwg) *
                    ((p.co + p.bn - 1) / p.bn);

  QuantArgs qa{p, x, act_max, codes, q, bq, counters,
               p.split > 1 ? tiles : 0,
               p.ci % 8 == 0 && p.cp == p.ci &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0};
  const long long work = (long long)p.q_bytes / 16 +
                         (p.relayout ? (long long)p.co * p.k_b : 0) +
                         qa.n_counters;  // below 2^31: the plan checks
  const int blocks = (int)((work + 255) / 256 < 132 * 16 ? (work + 255) / 256
                                                         : 132 * 16);
  if (in_dtype == 0)
    conv_quantize_kernel<float><<<blocks, 256, 0, stream>>>(qa);
  else
    conv_quantize_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(qa);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || quantize_only) return (int)err;

  CUtensorMap a_map, b_map;
  memset(&a_map, 0, sizeof(a_map));
  if (!p.gather && !hp::make_sw128_map(&a_map, q, p.m, p.cp, 64 * p.nwg))
    return (int)cudaErrorInvalidValue;
  if (!hp::make_sw128_map(&b_map, p.relayout ? bq : codes, p.co,
                          p.relayout ? p.k_b : p.kp, p.bn))
    return (int)cudaErrorInvalidValue;
  GemmArgs g{p, q, w_scale, act_max, bias, out, ws, counters,
             reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                 ((long long)p.co * (out_dtype == 1 ? 2 : 4)) % 16 == 0};
  return p.nwg == 1 ? launch_bn<1>(out_dtype, a_map, b_map, g, stream)
                    : launch_bn<2>(out_dtype, a_map, b_map, g, stream);
}

}  // extern "C"
