// int8 x int8 -> int32 3-D convolution for Hopper (sm_90a): the int8
// serving convs of TPU.INT8_EVAL / TPU.INT8_SPATIAL, one launch a conv.
//
// Replaces no Pallas kernel: the JAX package leaves these products to XLA
// (efficient_slowfast_tpu/ops/conv.py:243-247, lax.dot_general of the
// pointwise convs, and :309-313, lax.conv_general_dilated of the others,
// both with preferred_element_type=int32). No stock PyTorch CUDA op
// computes an int8 3-D convolution, so the port has this kernel.
//
// It is an implicit GEMM over channels-last activations: M = the output
// positions (B, T', H', W'), N = Co, K = kt kh kw Cin in tap-major order
// (the weight codes' layout, padded by the wrapper to a multiple of 32).
// Each block owns a 128 x BN tile of the output (BN = 16, 32 or 64 by Co)
// and walks K in chunks of 32:
//   - A chunk: each thread gathers 4 rows x 8 consecutive K elements of x
//     in its dtype (16-byte loads where Cin is a multiple of 8 and x is
//     aligned; element by element otherwise, as for the 3-channel stems),
//     taps outside the clip reading zero, and quantizes them in registers
//     as XLA does: xq = clip(rint(x / s_act), -127, 127), IEEE division
//     (__fdiv_rn) and round half to even (rintf), s_act = act_max *
//     f32(1/127) (XLA's rewrite of the division by 127, __fmul_rn). The
//     int8 codes go to shared memory, rows padded to 48 bytes so that
//     ldmatrix phases are conflict-free.
//   - B chunk: the weight codes, 16-byte cp.async rows (zero past Co).
//   - Products: mma.sync.m16n8k32 s8 x s8 -> s32, A and B fragments by
//     ldmatrix (an int8 m16n8k32 fragment has the word layout of a bf16
//     m16n8k16 one), 4 warps, two shared-memory stages: the next chunk's
//     global loads are in flight while this one multiplies.
//   - Epilogue: y = f32(acc) * (s_act * s_w[n]) rounded to the output
//     dtype, then + bias in that dtype, each step rounded as XLA rounds
//     it (__int2float_rn, __fmul_rn, __fadd_rn: no fused multiply-add);
//     or the int32 accumulator itself (out dtype 2), for exact checks.
//
// What bounds it on the H100 (chip_smoke.py computes it per shape): the
// slow pathway's convs do 2 K operations per output element, above the
// card's int8 balance point (~590 op/byte) where K is in the thousands, so
// they are bound by operations; the fast pathway's (K = 8-576, Co = 8-256)
// and the stems are bound by bytes. This first version is simple: a
// 128 x 64 tile re-reads and re-quantizes its A rows once per N tile, and
// mma.sync runs at a fraction of wgmma's rate; wgmma s8 fed by TMA, with
// the quantize fused into the producer, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kBM = 128;      // output positions a block
constexpr int kBK = 32;       // K a chunk: one m16n8k32 step
constexpr int kLd = kBK + 16; // bytes a shared row
constexpr int kThreads = 128;
constexpr int kRowsT = kBM * 4 / kThreads;  // A rows a thread gathers (4)

struct Params {
  const void* x;          // (B, T, H, W, Ci), channels-last
  const int8_t* wq;       // (Co, Kp), K tap-major
  const float* w_scale;   // (Co,)
  const float* act_max;   // one float
  const void* bias;       // (Co,) in the output dtype, or null
  void* out;              // (B, T', H', W', Co)
  int b, t, h, w, ci, to, ho, wo, co, kt, kh, kw, st, sh, sw, pt, ph, pw;
  int k, kp, vec;
  long long m;            // output positions
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// 8 consecutive elements of x from a 16-byte aligned address
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

__device__ __forceinline__ uint32_t quantize4(const float* v, float s_act) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(v[i], s_act)), -127.f), 127.f);
    r |= (uint32_t)((int)q & 0xff) << (8 * i);
  }
  return r;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename Tout>
__device__ __forceinline__ void store(Tout* out, long long i, int acc,
                                      float scale, const Tout* bias, int n);

template <>
__device__ __forceinline__ void store<float>(float* out, long long i, int acc,
                                             float scale, const float* bias,
                                             int n) {
  float y = __fmul_rn(__int2float_rn(acc), scale);
  if (bias != nullptr) y = __fadd_rn(y, bias[n]);
  out[i] = y;
}

template <>
__device__ __forceinline__ void store<__nv_bfloat16>(
    __nv_bfloat16* out, long long i, int acc, float scale,
    const __nv_bfloat16* bias, int n) {
  __nv_bfloat16 y = __float2bfloat16_rn(__fmul_rn(__int2float_rn(acc), scale));
  if (bias != nullptr)
    y = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(y), __bfloat162float(bias[n])));
  out[i] = y;
}

template <>
__device__ __forceinline__ void store<int>(int* out, long long i, int acc,
                                           float, const int*, int) {
  out[i] = acc;
}

template <typename Tin, typename Tout, int BN>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const Params p) {
  constexpr int kWarpsN = BN == 64 ? 2 : 1;
  constexpr int kWarpsM = 4 / kWarpsN;
  constexpr int kWM = kBM / kWarpsM, kWN = BN / kWarpsN;
  constexpr int kMT = kWM / 16, kNT = kWN / 8;
  static_assert(kNT % 2 == 0, "B fragments come two n-tiles an ldmatrix");

  __shared__ __align__(16) int8_t sa[2][kBM * kLd];
  __shared__ __align__(16) int8_t sb[2][BN * kLd];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp / kWarpsN, warp_n = warp % kWarpsN;
  const int n_tiles = (p.co + BN - 1) / BN;
  const long long m0 = (long long)(blockIdx.x / n_tiles) * kBM;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const Tin* x = static_cast<const Tin*>(p.x);
  const float s_act = __fmul_rn(*p.act_max, 0.007874015718698502f);

  // the thread's A rows: output position -> first input tap (b, t, h, w)
  const int grp = tid % 4;  // K elements 8 grp .. 8 grp + 7 of a chunk
  int rb[kRowsT], rt[kRowsT], rh[kRowsT], rw[kRowsT];
#pragma unroll
  for (int j = 0; j < kRowsT; ++j) {
    const long long m = m0 + tid / 4 + 32 * j;
    if (m < p.m) {
      long long r = m;
      const int wo = r % p.wo; r /= p.wo;
      const int ho = r % p.ho; r /= p.ho;
      const int to = r % p.to; r /= p.to;
      rb[j] = (int)r;
      rt[j] = to * p.st - p.pt;
      rh[j] = ho * p.sh - p.ph;
      rw[j] = wo * p.sw - p.pw;
    } else {
      rb[j] = -1;
      rt[j] = rh[j] = rw[j] = 0;
    }
  }

  float v[kRowsT][8];
  // the raw x values of chunk kc for this thread's rows
  auto gather = [&](int kc) {
    const int k0 = kc * kBK + 8 * grp;
    if (p.vec) {
      // Cin % 8 == 0: the 8 elements share one tap
      int dt = 0, dy = 0, dx = 0, c = 0;
      const bool in_k = k0 < p.k;
      if (in_k) {
        const int tap = k0 / p.ci;
        c = k0 - tap * p.ci;
        dx = tap % p.kw;
        dy = (tap / p.kw) % p.kh;
        dt = tap / (p.kw * p.kh);
      }
#pragma unroll
      for (int j = 0; j < kRowsT; ++j) {
        const int ti = rt[j] + dt, hi = rh[j] + dy, wi = rw[j] + dx;
        if (in_k && rb[j] >= 0 && ti >= 0 && ti < p.t && hi >= 0 &&
            hi < p.h && wi >= 0 && wi < p.w) {
          const size_t off =
              ((((size_t)rb[j] * p.t + ti) * p.h + hi) * p.w + wi) * p.ci + c;
          load8(x + off, v[j]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[j][e] = 0.f;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = k0 + e;
        int dt = 0, dy = 0, dx = 0, c = 0;
        const bool in_k = k < p.k;
        if (in_k) {
          const int tap = k / p.ci;
          c = k - tap * p.ci;
          dx = tap % p.kw;
          dy = (tap / p.kw) % p.kh;
          dt = tap / (p.kw * p.kh);
        }
#pragma unroll
        for (int j = 0; j < kRowsT; ++j) {
          const int ti = rt[j] + dt, hi = rh[j] + dy, wi = rw[j] + dx;
          float val = 0.f;
          if (in_k && rb[j] >= 0 && ti >= 0 && ti < p.t && hi >= 0 &&
              hi < p.h && wi >= 0 && wi < p.w)
            val = load_f(x + ((((size_t)rb[j] * p.t + ti) * p.h + hi) * p.w +
                              wi) * p.ci + c);
          v[j][e] = val;
        }
      }
    }
  };
  auto put_a = [&](int stage) {
#pragma unroll
    for (int j = 0; j < kRowsT; ++j) {
      uint2 q;
      q.x = quantize4(v[j], s_act);
      q.y = quantize4(v[j] + 4, s_act);
      *reinterpret_cast<uint2*>(&sa[stage][(tid / 4 + 32 * j) * kLd + 8 * grp]) = q;
    }
  };
  auto load_b = [&](int kc, int stage) {
    for (int i = tid; i < BN * 2; i += kThreads) {
      const int r = i >> 1, half = i & 1, n = n0 + r;
      const bool in = n < p.co;
      tc::cp_async_16(&sb[stage][r * kLd + 16 * half],
                      in ? p.wq + (size_t)n * p.kp + kc * kBK + 16 * half : p.wq,
                      in ? 16 : 0);
    }
    tc::cp_async_commit();
  };

  int acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int chunks = p.kp / kBK;
  load_b(0, 0);
  gather(0);
  put_a(0);
  tc::cp_async_wait<0>();
  __syncthreads();

  for (int kc = 0; kc < chunks; ++kc) {
    const int cur = kc & 1;
    const bool more = kc + 1 < chunks;
    if (more) {
      load_b(kc + 1, cur ^ 1);
      gather(kc + 1);
    }
    uint32_t af[kMT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
      const int row = warp_m * kWM + i * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
      tc::ldmatrix_x4(af[i], &sa[cur][row * kLd + 16 * (lane >> 4)]);
    }
#pragma unroll
    for (int j = 0; j < kNT; j += 2) {
      uint32_t bf[4];
      const int q = lane >> 3;
      const int row = warp_n * kWN + j * 8 + 8 * (q >> 1) + (lane & 7);
      tc::ldmatrix_x4(bf, &sb[cur][row * kLd + 16 * (q & 1)]);
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        mma_s8(acc[i][j], af[i], bf[0], bf[1]);
        mma_s8(acc[i][j + 1], af[i], bf[2], bf[3]);
      }
    }
    if (more) {
      put_a(cur ^ 1);
      tc::cp_async_wait<0>();
    }
    __syncthreads();
  }

  // epilogue: lane (g, t) holds rows g, g + 8 and columns 2t, 2t + 1 of
  // each 16 x 8 tile
  Tout* out = static_cast<Tout*>(p.out);
  const Tout* bias = static_cast<const Tout*>(p.bias);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + warp_n * kWN + j * 8 + 2 * t4 + c;
      if (n >= p.co) continue;
      const float scale = __fmul_rn(s_act, p.w_scale[n]);
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long m = m0 + warp_m * kWM + i * 16 + g + 8 * r;
          if (m < p.m)
            store<Tout>(out, m * p.co + n, acc[i][j][2 * r + c], scale, bias,
                        n);
        }
      }
    }
  }
}

template <typename Tin, typename Tout>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const long long m_tiles = (p.m + kBM - 1) / kBM;
  if (p.co <= 16) {
    const long long blocks = m_tiles * ((p.co + 15) / 16);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    int8_conv_kernel<Tin, Tout, 16><<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  } else if (p.co <= 32) {
    const long long blocks = m_tiles * ((p.co + 31) / 32);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    int8_conv_kernel<Tin, Tout, 32><<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  } else {
    const long long blocks = m_tiles * ((p.co + 63) / 64);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
    int8_conv_kernel<Tin, Tout, 64><<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_out(int out_dtype, const Params& p, cudaStream_t stream) {
  switch (out_dtype) {
    case 0: return launch<Tin, float>(p, stream);
    case 1: return launch<Tin, __nv_bfloat16>(p, stream);
    case 2: return launch<Tin, int>(p, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// in_dtype: 0 float32, 1 bfloat16; out_dtype: 0 float32, 1 bfloat16, 2 the
// int32 accumulator. x (B, T, H, W, Ci) channels-last; w (Co, Kp) int8 with
// Kp a multiple of 32; bias null or (Co,) in the output dtype; out (B, To,
// Ho, Wo, Co). vec: Ci % 8 == 0 and x 16-byte aligned. Returns the CUDA
// error of the launch (0 on success).
int int8_conv_launch(int in_dtype, int out_dtype, const void* x,
                     const int8_t* w, const float* w_scale,
                     const float* act_max, const void* bias, void* out, int b,
                     int t, int h, int wd, int ci, int to, int ho, int wo,
                     int co, int kt, int kh, int kw, int st, int sh, int sw,
                     int pt, int ph, int pw, int kp, int vec,
                     cudaStream_t stream) {
  Params p{x,  w,  w_scale, act_max, bias, out, b,  t,  h,  wd, ci,
           to, ho, wo,      co,      kt,   kh,  kw, st, sh, sw, pt,
           ph, pw, kt * kh * kw * ci, kp, vec, (long long)b * to * ho * wo};
  if (kp % kBK != 0 || kp < p.k || co <= 0 || p.m <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = in_dtype == 0
                        ? launch_out<float>(out_dtype, p, stream)
                        : launch_out<__nv_bfloat16>(out_dtype, p, stream);
  return (int)err;
}

}  // extern "C"
