// Flash attention for Hopper (sm_90a): softmax(q k^T) v in one launch per
// call, without writing the N x M logits anywhere.
//
// Replaces the Pallas TPU kernel
//   efficient_slowfast_tpu/ops/pallas/flash_attention.py::_flash_forward
//   (body _flash_kernel :83-109, pallas_call :139).
// It computes, for q (B, N, D), k (B, M, D), v (B, M, C) in float32 or
// bfloat16, with no scale on the logits:
//   out[b, i] = sum_j softmax_j(q[b, i] . k[b, j]) v[b, j]
// upcasting every input to f32, with the softmax running online over key
// tiles (running max, running sum, f32 accumulator), dividing by
// max(row_sum, 1e-30) and writing v's dtype, as the TPU kernel does. Unlike
// the TPU kernel it masks a key count that is not a multiple of the tile
// (keys >= M get logit -inf) and skips query rows >= N, and it takes any M.
// D and C range over 1..128.
//
// What bounds it on the H100 at the CMDA-R50 serving shapes (bf16, 4 clips
// of 32 frames at 256^2; N = M = 32768, 32768, 8192, 2048 with
// D = C = 8, 32, 64, 128): the work is 4*B*N*M*C operations on 67 MB, about
// 11000 operations per byte, so it is bound by operations, not bytes:
// 764.5 GFLOP is 0.77 ms at the bf16 tensor-core peak, and the N*M
// exponentials (8.9e9) are 2.1 ms at 16 per clock per SM, which is the
// tighter floor where C = 8. chip_smoke.py computes both per shape.
//
// Design (a first, simple version; products are scalar f32 FMAs on the CUDA
// cores, so it runs far above that floor): a block of 256 threads owns 64
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

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;   // query rows of one block
constexpr int kBK = 64;   // keys of one tile
constexpr int kPad = 4;   // row padding of the shared tiles, in floats
constexpr int kLdT = kBQ + kPad;  // leading dim of transposed q/k tiles, logits
constexpr int kKeysPerThread = kBK / 4;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Floats of shared memory: q^T and k^T (d x kLdT each), v (kBK x (cp + kPad)),
// logits (kBQ x kLdT).
__host__ __device__ inline size_t smem_floats(int d, int cp) {
  return (size_t)2 * d * kLdT + (size_t)kBK * (cp + kPad) + (size_t)kBQ * kLdT;
}

// CP: C padded to 8, 16, 32, 64 or 128 (zero columns beyond C).
template <typename T, int CP>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int n,
                       int m, int d, int c) {
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
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int n, int m, int d, int c, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, CP>;
  const size_t smem = smem_floats(d, CP) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBQ - 1) / kBQ, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), n, m, d, c);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int b,
             int n, int m, int d, int c, cudaStream_t s) {
  if (c <= 8) return launch<T, 8>(q, k, v, out, b, n, m, d, c, s);
  if (c <= 16) return launch<T, 16>(q, k, v, out, b, n, m, d, c, s);
  if (c <= 32) return launch<T, 32>(q, k, v, out, b, n, m, d, c, s);
  if (c <= 64) return launch<T, 64>(q, k, v, out, b, n, m, d, c, s);
  return launch<T, 128>(q, k, v, out, b, n, m, d, c, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (b, n, d), k (b, m, d), v (b, m, c)
// and out (b, n, c) are contiguous. Returns the CUDA error code of the
// launch.
int flash_attention_launch(int dtype, const void* q, const void* k,
                           const void* v, void* out, int b, int n, int m,
                           int d, int c, void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || m <= 0 || d <= 0 || d > 128 ||
      c <= 0 || c > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, out, b, n, m, d, c, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, out, b, n, m, d, c, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
