// Fused eval-mode ResNet bottleneck block for Hopper (sm_90a), one launch
// per residual block.
//
// Replaces the Pallas TPU kernel
//   efficient_slowfast_tpu/ops/pallas/fused_bottleneck.py::fused_bottleneck
//   (body _kernel :105-156, helper _apply_a :85-102).
// It computes, with BN already folded into the weights:
//   a   = relu(Tx1x1 conv(x) + ba)        kt in {1, 3}, taps zero at clip edges
//   b   = relu(1x3x3 conv(a, pad 1) + bb)
//   out = relu((b @ wc + bc) + residual)  residual = x or (x @ wp + bp)
// on x (N = B*T, H, W, Cin) channels-last, in float32 or bfloat16, with f32
// accumulation. Like the TPU kernel it rounds to the working type at the
// same points: a and b after their ReLU, c and the projected residual before
// the add, and the output.
//
// What bounds it on the H100 at the SlowFast-R50 serving shapes (bf16, 4
// clips; chip_smoke.py computes it per shape): the slow pathway's s4 and s5
// blocks do 730-900 operations per byte of x read and out written, above the
// card's ~295 op/byte balance point, so they are bound by operations; slow
// s2 (136 op/byte), s3 (270) and every fast-pathway block (8-64 channels,
// 25-200 op/byte) are bound by bytes. Unfused, each block streams a and b
// through device memory (about six tensor passes); fused, a and b live only
// in shared memory and registers, so the bytes are one read of x and one
// write of out, which is all the bytes-bound shapes need.
//
// Design (a first, simple version): a thread block owns an H-strip of
// `rows` output rows of one frame. It
//   1. computes a for the strip plus a one-row halo above and below into
//      shared memory (halo rows outside the image are zero AFTER the ReLU,
//      since relu(0*W + b) != 0; frames outside the clip contribute zero to
//      the temporal taps, and frame n belongs to clip n / t_len),
//   2. computes b for the strip from a, reading zero for the W padding,
//      into shared memory,
//   3. computes out in tiles of Cout from b (and the projection from x).
// Each stage is a GEMM whose A operand is gathered on the fly (im2col) and
// whose K dimension is streamed through shared memory in chunks of 16, so
// Cin up to 2048 and Ci up to 512 fit in any case. Products are scalar f32
// FMAs on register tiles of 4x4 per thread; the tile shape adapts to M and N
// (down to 8 channels on the fast pathway). The operations-bound slow blocks
// therefore run at the f32 FMA rate, not the tensor-core rate: wgmma/TMA and
// a persistent schedule are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;
// staging floats: the largest A chunk (BM 512) plus its B chunk (BN 8)
constexpr int kStageFloats = kBK * (512 + 8);

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

struct Params {
  const void* x;
  const void* wa;
  const float* ba;
  const void* wb;
  const float* bb;
  const void* wc;
  const float* bc;
  const void* wp;
  const float* bp;
  void* out;
  int n, t_len, h, w, cin, ci, cout, rows;
};

// Output tile of one GEMM stage: tx threads along N, 256 / tx along M, each
// thread a 4x4 register tile. Picks the shape that pads M x N the least.
struct Tile {
  int tx, bm, bn;
};

__device__ __forceinline__ Tile pick_tile(int m, int n) {
  Tile best{2, 512, 8};
  long long best_cost = -1;
  for (int tx = 2; tx <= 64; tx *= 2) {
    const int bm = (kThreads / tx) * 4, bn = tx * 4;
    const long long cost = (long long)((m + bm - 1) / bm) * bm *
                           (long long)((n + bn - 1) / bn) * bn;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = Tile{tx, bm, bn};
    }
  }
  return best;
}

// acc += A[m0:m0+bm, 0:K] @ B[0:K, n0:n0+bn] for this thread's 4x4 part.
// la(m, k) and lb(k, n) return 0 outside the operands.
template <class LA, class LB>
__device__ __forceinline__ void mma_tile(float (&acc)[4][4], const Tile& tl,
                                         int m0, int n0, int K, const LA& la,
                                         const LB& lb, float* stage) {
  const int tid = threadIdx.x;
  const int ty = tid / tl.tx, tx = tid % tl.tx;
  float* As = stage;
  float* Bs = stage + kBK * tl.bm;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int idx = tid; idx < tl.bm * kBK; idx += kThreads) {
      const int kk = idx % kBK, mm = idx / kBK;
      As[kk * tl.bm + mm] = la(m0 + mm, k0 + kk);
    }
    for (int idx = tid; idx < kBK * tl.bn; idx += kThreads) {
      const int nn = idx % tl.bn, kk = idx / tl.bn;
      Bs[kk * tl.bn + nn] = lb(k0 + kk, n0 + nn);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk * tl.bm + ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk * tl.bn + tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

template <typename T, int KT, bool PROJ>
__global__ void __launch_bounds__(kThreads)
fused_bottleneck_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* stage = reinterpret_cast<float*>(smem);
  T* a_s = reinterpret_cast<T*>(smem + kStageFloats * sizeof(float));
  T* b_s = a_s + (size_t)(p.rows + 2) * p.w * p.ci;

  const T* __restrict__ x = static_cast<const T*>(p.x);
  const T* __restrict__ wa = static_cast<const T*>(p.wa);
  const T* __restrict__ wb = static_cast<const T*>(p.wb);
  const T* __restrict__ wc = static_cast<const T*>(p.wc);
  const T* __restrict__ wp = static_cast<const T*>(p.wp);
  T* __restrict__ out = static_cast<T*>(p.out);

  const int H = p.h, W = p.w, cin = p.cin, ci = p.ci, cout = p.cout;
  const int frame = blockIdx.y;
  const int clip0 = (frame / p.t_len) * p.t_len;  // first frame of the clip
  const int t = frame - clip0;
  const int r0 = blockIdx.x * p.rows;
  const int rows_out = min(p.rows, H - r0);
  const int tid = threadIdx.x;

  // ---- a on rows r0-1 .. r0+rows_out (halo included) ---------------------
  {
    const int M = (rows_out + 2) * W, K = KT * cin;
    const Tile tl = pick_tile(M, ci);
    auto la = [&](int m, int k) -> float {
      if (m >= M || k >= K) return 0.f;
      const int y = r0 - 1 + m / W, col = m % W;
      if (y < 0 || y >= H) return 0.f;
      const int dt = k / cin, ch = k - dt * cin;
      const int tt = t + dt - KT / 2;
      if (tt < 0 || tt >= p.t_len) return 0.f;
      return to_f(x[(((size_t)(clip0 + tt) * H + y) * W + col) * cin + ch]);
    };
    auto lb = [&](int k, int j) -> float {
      return (k < K && j < ci) ? to_f(wa[(size_t)k * ci + j]) : 0.f;
    };
    for (int m0 = 0; m0 < M; m0 += tl.bm)
      for (int n0 = 0; n0 < ci; n0 += tl.bn) {
        float acc[4][4];
        zero(acc);
        mma_tile(acc, tl, m0, n0, K, la, lb, stage);
        const int ty = tid / tl.tx, tx = tid % tl.tx;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + ty * 4 + i;
          if (m >= M) continue;
          const int y = r0 - 1 + m / W;
          const bool inside = y >= 0 && y < H;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = n0 + tx * 4 + j;
            if (c >= ci) continue;
            // the unfused conv zero-pads the post-ReLU activation
            const float v = inside ? fmaxf(acc[i][j] + p.ba[c], 0.f) : 0.f;
            a_s[(size_t)m * ci + c] = from_f<T>(v);
          }
        }
      }
  }
  __syncthreads();

  // ---- b: 1x3x3 conv over a, pad 1 ---------------------------------------
  const int M = rows_out * W;
  {
    const int K = 9 * ci;
    const Tile tl = pick_tile(M, ci);
    auto la = [&](int m, int k) -> float {
      if (m >= M || k >= K) return 0.f;
      const int rr = m / W, col = m % W;
      const int tap = k / ci, ch = k - tap * ci;
      const int dy = tap / 3, cc = col + tap % 3 - 1;
      if (cc < 0 || cc >= W) return 0.f;
      return to_f(a_s[((size_t)(rr + dy) * W + cc) * ci + ch]);
    };
    auto lb = [&](int k, int j) -> float {
      return (k < K && j < ci) ? to_f(wb[(size_t)k * ci + j]) : 0.f;
    };
    for (int m0 = 0; m0 < M; m0 += tl.bm)
      for (int n0 = 0; n0 < ci; n0 += tl.bn) {
        float acc[4][4];
        zero(acc);
        mma_tile(acc, tl, m0, n0, K, la, lb, stage);
        const int ty = tid / tl.tx, tx = tid % tl.tx;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + ty * 4 + i;
          if (m >= M) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = n0 + tx * 4 + j;
            if (c >= ci) continue;
            b_s[(size_t)m * ci + c] = from_f<T>(fmaxf(acc[i][j] + p.bb[c], 0.f));
          }
        }
      }
  }
  __syncthreads();

  // ---- c: 1x1x1 conv + residual + ReLU -----------------------------------
  {
    const size_t pix0 = ((size_t)frame * H + r0) * W;  // first output pixel
    const Tile tl = pick_tile(M, cout);
    auto la_c = [&](int m, int k) -> float {
      return (m < M && k < ci) ? to_f(b_s[(size_t)m * ci + k]) : 0.f;
    };
    auto lb_c = [&](int k, int j) -> float {
      return (k < ci && j < cout) ? to_f(wc[(size_t)k * cout + j]) : 0.f;
    };
    auto la_p = [&](int m, int k) -> float {
      return (m < M && k < cin) ? to_f(x[(pix0 + m) * cin + k]) : 0.f;
    };
    auto lb_p = [&](int k, int j) -> float {
      return (k < cin && j < cout) ? to_f(wp[(size_t)k * cout + j]) : 0.f;
    };
    for (int m0 = 0; m0 < M; m0 += tl.bm)
      for (int n0 = 0; n0 < cout; n0 += tl.bn) {
        float acc[4][4], accp[4][4];
        zero(acc);
        zero(accp);
        mma_tile(acc, tl, m0, n0, ci, la_c, lb_c, stage);
        if constexpr (PROJ) mma_tile(accp, tl, m0, n0, cin, la_p, lb_p, stage);
        const int ty = tid / tl.tx, tx = tid % tl.tx;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = m0 + ty * 4 + i;
          if (m >= M) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = n0 + tx * 4 + j;
            if (c >= cout) continue;
            const float cv = to_f(from_f<T>(acc[i][j] + p.bc[c]));
            float res;
            if constexpr (PROJ)
              res = to_f(from_f<T>(accp[i][j] + p.bp[c]));
            else
              res = to_f(x[(pix0 + m) * cin + c]);
            out[(pix0 + m) * cout + c] = from_f<T>(fmaxf(cv + res, 0.f));
          }
        }
      }
  }
}

template <typename T, int KT, bool PROJ>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = fused_bottleneck_kernel<T, KT, PROJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.h + p.rows - 1) / p.rows, p.n);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int kt, bool proj, size_t smem, cudaStream_t s) {
  if (kt == 1) return proj ? launch<T, 1, true>(p, smem, s) : launch<T, 1, false>(p, smem, s);
  if (kt == 3) return proj ? launch<T, 3, true>(p, smem, s) : launch<T, 3, false>(p, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block: staging + a (rows + 2 halo rows) + b.
size_t fused_bottleneck_smem_bytes(int elem_bytes, int w, int ci, int rows) {
  return kStageFloats * sizeof(float) +
         (size_t)(2 * rows + 2) * w * ci * elem_bytes;
}

// dtype: 0 = float32, 1 = bfloat16. wp/bp are null for the identity
// shortcut (then cin == cout). Returns the CUDA error code of the launch.
int fused_bottleneck_launch(int dtype, const void* x, const void* wa,
                            const float* ba, const void* wb, const float* bb,
                            const void* wc, const float* bc, const void* wp,
                            const float* bp, void* out, int n, int t_len,
                            int h, int w, int cin, int ci, int cout, int kt,
                            int rows, void* stream) {
  if (n <= 0 || t_len <= 0 || n % t_len || rows <= 0 || h <= 0 || w <= 0 ||
      (wp == nullptr && cin != cout))
    return (int)cudaErrorInvalidValue;
  const Params p{x, wa, ba, wb, bb, wc, bc, wp, bp, out,
                 n, t_len, h, w, cin, ci, cout, rows};
  const size_t smem = fused_bottleneck_smem_bytes(dtype == 0 ? 4 : 2, w, ci, rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool proj = wp != nullptr;
  if (dtype == 0) return dispatch<float>(p, kt, proj, smem, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(p, kt, proj, smem, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
