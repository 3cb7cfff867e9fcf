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
// bfloat16 (serving): fused_bottleneck_tc_kernel. The first version (the
// float32 kernel below, then run on bf16 too) gathered every operand
// element through a `/` and a `%` into an f32 staging buffer and ran scalar
// FMAs, and a block owned a strip of 1-4 rows: at slow s5 it computed 8
// output pixels, recomputed a on 3 rows to keep 1 and pulled all 13.1 MB of
// weights through L2 for them. This one:
//   - Work split: a cluster of CL blocks (CL in {1, 2, 4, 8}, thread block
//     clusters) owns a strip of R rows of one frame. Block r of the cluster
//     computes channels [r Ci/CL, (r+1) Ci/CL) of a for the strip and its
//     halo rows and writes them into the shared memory of every block of
//     the cluster (distributed shared memory, then barrier.cluster); b the
//     same way; then each block computes its Cout/CL slice of out. So no
//     block recomputes another's halo and a weight byte comes into a
//     cluster once per strip. Where Ci is small (the bytes-bound shapes) CL
//     is 1. The wrapper's plan() picks CL and R (64 or more output pixels a
//     strip, half the frame where a frame has fewer than 128) by a cost
//     model fitted to measured times, with the same shared-memory arithmetic
//     as tc_smem below.
//   - Products: all four (a: K = kt Cin; b: nine shifted 1x3x3 taps,
//     K = 9 Ci; c: K = Ci; the projection: K = Cin) are bf16 x bf16 -> f32
//     mma.sync m16n8k16 (tensor_core.cuh), 8 warps a block. Where Ci >= 64
//     a warp owns 32 rows x up to 64 columns (one block per SM, up to 255
//     registers), else 16 x up to 32 (two blocks per SM, 128 registers). A
//     fragments come by ldmatrix from a staged x chunk or from a and b in
//     shared memory; B fragments by ldmatrix.trans from the row-major K x N
//     weights.
//   - Operands: x rows and weight chunks of 16, 32 or 64 K rows come by
//     16-byte cp.async into a ring of 2-6 stages (chunks in flight while one
//     multiplies), sized by what shared memory is free in each stage of the
//     block: a's ring spans b's buffer, c's the dead a. Channel counts that
//     are not multiples of 8 take element loads. Rows are padded by 16 bytes,
//     so ldmatrix phases are conflict-free. a and b stay in shared memory as
//     bf16; a holds the image rows of the strip and its halo and one pixel of
//     zeros, which every tap outside the image (H and W padding) reads, so
//     b's taps are shifted ldmatrix addresses. Frames outside the clip are
//     temporal taps the block skips; padded channels get zero weights and
//     bias, so a and b are zero there.
//   - Output: c + bc is rounded to bf16 into a shared tile and leaves with
//     the residual by 16-byte loads and stores, four in flight a thread. A
//     projection is computed first, rounded and written to out, and read
//     back as the residual by the thread that wrote it.
// What holds it from its bound (chip_smoke.py, PERF.md): mma.sync issue
// from 8 warps reaches about a quarter of the tensor cores' rate, and each
// chunk's copies and barrier add to that rather than hide behind it;
// wgmma with TMA and a producer warp is the next step.
// It rounds where the TPU kernel does: a and b after bias and ReLU, c + bc
// and the projected residual before the add, relu(c + res) once.
//
// float32 (the tolerance checks): the first, simple version, a thread block
// per H-strip of `rows` rows of one frame. It
//   1. computes a for the strip plus a one-row halo above and below into
//      shared memory (halo rows outside the image are zero AFTER the ReLU,
//      since relu(0*W + b) != 0; frames outside the clip contribute zero to
//      the temporal taps, and frame n belongs to clip n / t_len),
//   2. computes b for the strip from a, reading zero for the W padding,
//      into shared memory,
//   3. computes out in tiles of Cout from b (and the projection from x).
// Each stage is a GEMM whose A operand is gathered on the fly (im2col) and
// whose K dimension is streamed through shared memory in chunks of 16.
// Products are scalar f32 FMAs on register tiles of 4x4 per thread.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "tensor_core.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;
// staging floats: the largest A chunk (BM 512) plus its B chunk (BN 8)
constexpr int kStageFloats = kBK * (512 + 8);

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

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

constexpr int kMaxSmem = 232448;  // dynamic shared memory of one H100 block

// Raises `kernel`'s dynamic shared memory limit to the most a block may have,
// once per kernel and device rather than on every launch.
template <auto kernel>
cudaError_t allow_smem() {
  static std::atomic<unsigned> done{0};  // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <typename T, int KT, bool PROJ>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = allow_smem<fused_bottleneck_kernel<T, KT, PROJ>>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.h + p.rows - 1) / p.rows, p.n);
  fused_bottleneck_kernel<T, KT, PROJ><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int kt, bool proj, size_t smem, cudaStream_t s) {
  if (kt == 1) return proj ? launch<T, 1, true>(p, smem, s) : launch<T, 1, false>(p, smem, s);
  if (kt == 3) return proj ? launch<T, 3, true>(p, smem, s) : launch<T, 3, false>(p, smem, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel.

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 256;  // 8 warps
constexpr int kMaxStages = 6;    // the deepest ring of one pass
constexpr int kMaxBM = 128;      // the most pixels of one pass
// the most n8 tiles of a warp with MI m16 tiles: 8 (wide), 4 (narrow, so
// that two blocks fit an SM's registers)
template <int MI>
constexpr int kMaxNT = MI == 1 ? 4 : 8;
// The least ring that b's weight chunks stream through: three stages of a
// 128 x 32 x chunk and a 32 x 128 weight chunk (rows padded by 16 bytes);
// the launch gives it what shared memory is left. a's ring also spans b's
// buffer (b is written only after a), and c's ring is the larger of this
// one and a's buffer (a is dead once b is done).
constexpr int kRingElems = 3 * (kMaxBM * (32 + 8) + 32 * (128 + 8));

struct TcParams {
  const bf16* x;
  const bf16* wa;
  const float* ba;
  const bf16* wb;
  const float* bb;
  const bf16* wc;
  const float* bc;
  const bf16* wp;
  const float* bp;
  bf16* out;
  int n, t_len, h, w, cin, ci, cout, rows, cl;
  int ring;  // elements of the ring, at least kRingElems
  // 16-byte copies: rows are whole 16-byte chunks and the pointer is aligned
  bool x_vec, wa_vec, wb_vec, wc_vec, wp_vec, out_vec;
};

__host__ __device__ inline int pad16(int c) { return (c + 15) & ~15; }

// Pixels of a's buffer: the image rows of a strip and its halo, and one
// pixel of zeros that taps outside the image read.
__host__ __device__ inline int a_pixels(int h, int w, int rows) {
  return (rows + 2 < h ? rows + 2 : h) * w + 1;
}

// Shared memory of one block: a, b (rows x w pixels), each pixel Ci padded
// to 16 plus 8 (16 bytes), and a ring of ring elements.
__host__ __device__ inline size_t tc_smem(int h, int w, int ci, int rows,
                                          int ring) {
  const size_t lda = pad16(ci) + 8;
  return sizeof(bf16) * ((size_t)a_pixels(h, w, rows) * lda +
                         (size_t)rows * w * lda + ring);
}

// One pass over an M x N output, K streamed in chunks: wm warps along M
// (MI m16 tiles each) and wn along N (nt n8 tiles each) cover bm x bn
// (bm <= 128, bn <= 256); a chunk
// is kc rows of K (64, 32 or 16, whichever divides the channel count cp and
// leaves the ring at least three stages), staged as an optional bm x kc x
// chunk (rows of ldk) and a kc x bn weight chunk (rows of ldn) at a_elems
// into each of `stages` stages of `stage` elements.
struct Pass {
  int wm, wn, bm, bn, nt, kc, ldk, ldn, stages, stage, a_elems;
};

template <int MI>
__device__ __forceinline__ Pass pass_shape(int m, int n, int cp, bool has_x,
                                           int ring_elems) {
  Pass s;
  s.wm = 1;
  while (s.wm < kMaxBM / (16 * MI) && 16 * MI * s.wm < m) s.wm <<= 1;
  int bn = 16;  // a power of two, so that loads index by shifts
  while (bn < n && bn < 256) bn <<= 1;
  s.bn = min(bn, 8 * kMaxNT<MI> * (8 / s.wm));
  s.wn = min(8 / s.wm, s.bn / 8);
  s.bm = 16 * MI * s.wm;
  s.nt = s.bn / (8 * s.wn);
  s.ldn = s.bn + 8;
  for (int kc = 64;; kc >>= 1) {
    if (cp % kc) continue;
    s.kc = kc;
    s.ldk = kc + 8;
    s.a_elems = has_x ? s.bm * s.ldk : 0;
    s.stage = s.a_elems + kc * s.ldn;
    s.stages = min(kMaxStages, ring_elems / s.stage);
    if (s.stages >= 3 || kc == 16) break;
  }
  return s;
}

__device__ __forceinline__ int log2i(int v) { return 31 - __clz(v); }

// Rows k0 .. k0 + kc - 1 of a row-major matrix with ld columns (zero from
// row k0 + kv on), columns c0 .. c0 + bn - 1 (zero from column cv on), into
// a staged weight chunk with rows of ldn.
__device__ __forceinline__ void load_w(bf16* dst, const bf16* src, int ld,
                                       int k0, int kc, int kv, int c0, int bn,
                                       int cv, int ldn, bool vec) {
  if (vec) {
    const int sh = log2i(bn >> 3);
    for (int i = threadIdx.x; i < kc << sh; i += kTcThreads) {
      const int r = i >> sh, j = (i & ((1 << sh) - 1)) << 3;
      const bool in = r < kv && c0 + j < cv;
      tc::cp_async_16(dst + r * ldn + j,
                      in ? src + (size_t)(k0 + r) * ld + c0 + j : src,
                      in ? 16 : 0);
    }
  } else {
    const int sh = log2i(bn);
    for (int i = threadIdx.x; i < kc << sh; i += kTcThreads) {
      const int r = i >> sh, j = i & (bn - 1);
      dst[r * ldn + j] = r < kv && c0 + j < cv
                             ? src[(size_t)(k0 + r) * ld + c0 + j]
                             : __float2bfloat16_rn(0.f);
    }
  }
}

// Pixel rows 0 .. bm - 1 of src (cin channels each; zero from row mv on),
// channels k0 .. k0 + kc - 1 (zero from cin on), into a staged x chunk with
// rows of ldk.
__device__ __forceinline__ void load_x(bf16* dst, const bf16* src, int cin,
                                       int mv, int bm, int k0, int kc,
                                       int ldk, bool vec) {
  const int sh = log2i(kc >> 3);  // the 16-byte chunks of a row, log2
  if (vec) {
    for (int i = threadIdx.x; i < bm << sh; i += kTcThreads) {
      const int r = i >> sh, j = (i & ((1 << sh) - 1)) << 3;
      const bool in = r < mv && k0 + j < cin;
      tc::cp_async_16(dst + r * ldk + j,
                      in ? src + (size_t)r * cin + k0 + j : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < bm << (sh + 3); i += kTcThreads) {
      const int r = i >> (sh + 3), j = i & (kc - 1);
      dst[r * ldk + j] = r < mv && k0 + j < cin ? src[(size_t)r * cin + k0 + j]
                                                : __float2bfloat16_rn(0.f);
    }
  }
}

// Waits until at most n (0 .. kMaxStages - 2) of this thread's committed
// copy groups are in flight.
__device__ __forceinline__ void wait_pending(int n) {
  switch (n) {
    case 0: tc::cp_async_wait<0>(); break;
    case 1: tc::cp_async_wait<1>(); break;
    case 2: tc::cp_async_wait<2>(); break;
    case 3: tc::cp_async_wait<3>(); break;
    default: tc::cp_async_wait<4>(); break;
  }
}

// acc = the sum over nch K chunks of A x B, on the tensor cores, through a
// ring of s.stages stages: load(c, st) issues chunk c's copies into the
// stage at st (its weight chunk at st + s.a_elems); a_ptr(c, st, i) is the
// lane's ldmatrix row of chunk c's A operand in the warp's m16 tile i (k
// from 0); b_lane is the lane's ldmatrix.trans offset in a weight chunk.
// Where MI is 2, the fragments of the next 16 of K load while this 16's
// products run. Inactive warps load and synchronise but do not multiply;
// a warp with 16 or fewer rows of the output left (wrows) skips its
// second m16 tile.
template <int MI, class Load, class APtr>
__device__ __forceinline__ void run_pass(float (&acc)[MI][kMaxNT<MI>][4],
                                         const Pass& s, bool active, int wrows,
                                         int nch, bf16* ring, int b_lane,
                                         const Load& load, const APtr& a_ptr) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < kMaxNT<MI>; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  const int S = s.stages;
  for (int c = 0; c < S - 1; ++c) {
    if (c < nch) load(c, ring + c * s.stage);
    tc::cp_async_commit();
  }
  int rd = 0, wr = S - 1;  // the stages of chunks c and c + S - 1
  for (int c = 0; c < nch; ++c) {
    wait_pending(S - 2);  // chunk c has landed ...
    // ... for every thread, and all are past chunk c - 1, whose stage
    // chunk c + S - 1 now fills
    __syncthreads();
    if (c + S - 1 < nch) load(c + S - 1, ring + wr * s.stage);
    tc::cp_async_commit();
    const bf16* st = ring + rd * s.stage;
    wr = wr + 1 == S ? 0 : wr + 1;
    rd = rd + 1 == S ? 0 : rd + 1;
    if (!active) continue;
    const bf16* ap[MI];
#pragma unroll
    for (int i = 0; i < MI; ++i) ap[i] = a_ptr(c, st, i);
    const bool two_m = MI == 2 && wrows > 16;
    const bf16* bp = st + s.a_elems + b_lane;
    auto frags = [&](int ks, uint32_t (&a)[MI][4],
                     uint32_t (&b)[kMaxNT<MI> / 2][4]) {
#pragma unroll
      for (int i = 0; i < MI; ++i)
        if (i == 0 || two_m) tc::ldmatrix_x4(a[i], ap[i] + ks);
#pragma unroll
      for (int jj = 0; jj < kMaxNT<MI> / 2; ++jj)
        if (2 * jj < s.nt)
          tc::ldmatrix_x4_trans(b[jj], bp + ks * s.ldn + 16 * jj);
    };
    auto mmas = [&](const uint32_t (&a)[MI][4],
                    const uint32_t (&b)[kMaxNT<MI> / 2][4]) {
#pragma unroll
      for (int jj = 0; jj < kMaxNT<MI> / 2; ++jj) {
        if (2 * jj >= s.nt) continue;
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          if (i > 0 && !two_m) continue;
          tc::mma_bf16_16816(acc[i][2 * jj], a[i], b[jj][0], b[jj][1]);
          if (2 * jj + 1 < s.nt)
            tc::mma_bf16_16816(acc[i][2 * jj + 1], a[i], b[jj][2], b[jj][3]);
        }
      }
    };
    uint32_t fa0[MI][4], fb0[kMaxNT<MI> / 2][4];
    if constexpr (MI == 1) {  // 128 registers: no room for a second set
      for (int ks = 0; ks < s.kc; ks += 16) {
        frags(ks, fa0, fb0);
        mmas(fa0, fb0);
      }
    } else {
      uint32_t fa1[MI][4], fb1[kMaxNT<MI> / 2][4];
      frags(0, fa0, fb0);
      for (int ks = 0; ks < s.kc; ks += 32) {
        const bool two = ks + 16 < s.kc;
        if (two) frags(ks + 16, fa1, fb1);
        mmas(fa0, fb0);
        if (!two) break;
        if (ks + 32 < s.kc) frags(ks + 32, fa0, fb0);
        mmas(fa1, fb1);
      }
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring is free
}

// Writes relu(acc + bias) of a pass as bf16 pairs into the a or b buffer
// `buf` of every block of the cluster. Row m of the pass's output goes to
// pixel pos(m) of buf; columns are channels from ch0.
template <int MI, class Pos>
__device__ __forceinline__ void push_relu(const float (&acc)[MI][kMaxNT<MI>][4],
                                          const Pass& s, int wm_i, int wn_i,
                                          int mb, int m_end, int nb, int n_end,
                                          int ch0, const float* bias, int ci,
                                          int lda, bf16* buf,
                                          cg::cluster_group& cluster,
                                          int cl, const Pos& pos) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2 * MI; ++i) {  // rows g, g + 8 of each m16 tile
    const int m = mb + 16 * MI * wm_i + 8 * i + g;
    if (m >= m_end) continue;
    bf16* row = buf + pos(m) * lda;
#pragma unroll
    for (int j = 0; j < kMaxNT<MI>; ++j) {
      const int n = nb + (wn_i * s.nt + j) * 8 + 2 * tq;
      if (j >= s.nt || n >= n_end) continue;
      const int ch = ch0 + n;
      const float b0 = ch < ci ? bias[ch] : 0.f;
      const float b1 = ch + 1 < ci ? bias[ch + 1] : 0.f;
      const float* d = acc[i >> 1][j] + 2 * (i & 1);
      const uint32_t v = tc::pack_bf16x2(fmaxf(d[0] + b0, 0.f),
                                         fmaxf(d[1] + b1, 0.f));
      for (int r = 0; r < cl; ++r)
        *reinterpret_cast<uint32_t*>(cluster.map_shared_rank(row + ch, r)) = v;
    }
  }
}

// acc + bias of one pass of c or of the projection, rounded to bf16, into
// the out tile (the ring's memory, rows of s.ldn); columns from c0 of cout.
template <int MI>
__device__ __forceinline__ void tile_out(const float (&acc)[MI][kMaxNT<MI>][4],
                                         const Pass& s, int wm_i, int wn_i,
                                         bool active, int c0, int cout,
                                         const float* bias, bf16* tile) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  if (active) {
#pragma unroll
    for (int j = 0; j < kMaxNT<MI>; ++j) {
      if (j >= s.nt) continue;
      const int n = (wn_i * s.nt + j) * 8 + 2 * tq, gc = c0 + n;
      const float b0 = gc < cout ? bias[gc] : 0.f;
      const float b1 = gc + 1 < cout ? bias[gc + 1] : 0.f;
#pragma unroll
      for (int i = 0; i < 2 * MI; ++i) {
        const float* d = acc[i >> 1][j] + 2 * (i & 1);
        *reinterpret_cast<uint32_t*>(tile + (16 * MI * wm_i + 8 * i + g) * s.ldn + n) =
            tc::pack_bf16x2(d[0] + b0, d[1] + b1);
      }
    }
  }
  __syncthreads();
}

// Rows 0 .. mv - 1 and columns 0 .. min(bn, c_end - c0) - 1 of the out tile
// (rows of ldt) to out (pixels from out_row, columns from c0 of cout): the
// tile itself where res is null, else bf16(relu(tile + res)) with res's rows
// of ld_res. 16-byte loads and stores where vec.
__device__ __forceinline__ void write_out(const bf16* tile, int ldt, int mv,
                                          int bn, int c0, int c_end,
                                          bf16* out_row, int cout,
                                          const bf16* res_row, int ld_res,
                                          bool vec) {
  if (vec) {
    // four 16-byte chunks a thread at a time, their loads issued together
    const int sh = log2i(bn >> 3), total = mv << sh;
    for (int i0 = threadIdx.x; i0 < total; i0 += 4 * kTcThreads) {
      uint4 v[4], rv[4];
      bool in[4];
      size_t at[4];  // the chunk's offset in out's rows
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kTcThreads;
        const int r = i >> sh, j = (i & ((1 << sh) - 1)) << 3;
        in[u] = i < total && c0 + j < c_end;
        at[u] = (size_t)r * cout + c0 + j;
        if (!in[u]) continue;
        v[u] = *reinterpret_cast<const uint4*>(tile + r * ldt + j);
        if (res_row)
          rv[u] = *reinterpret_cast<const uint4*>(res_row + (size_t)r * ld_res +
                                                  c0 + j);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!in[u]) continue;
        if (res_row) {
          uint32_t* vw = reinterpret_cast<uint32_t*>(&v[u]);
          const uint32_t* rw = reinterpret_cast<const uint32_t*>(&rv[u]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(vw + e));
            const float2 b = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(rw + e));
            vw[e] = tc::pack_bf16x2(fmaxf(a.x + b.x, 0.f), fmaxf(a.y + b.y, 0.f));
          }
        }
        *reinterpret_cast<uint4*>(out_row + at[u]) = v[u];
      }
    }
  } else {
    const int sh = log2i(bn);
    for (int i = threadIdx.x; i < mv << sh; i += kTcThreads) {
      const int r = i >> sh, j = i & (bn - 1), gc = c0 + j;
      if (gc >= c_end) continue;
      float v = __bfloat162float(tile[r * ldt + j]);
      if (res_row)
        v = fmaxf(v + __bfloat162float(res_row[(size_t)r * ld_res + gc]), 0.f);
      out_row[(size_t)r * cout + gc] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();  // the tile is the ring's memory again
}

// One launch: blockIdx.y is the frame, blockIdx.x / cl the strip of `rows`
// rows, the block's rank in its cluster of cl its slice of Ci and of Cout.
// MI: m16 tiles of a warp, 2 where Ci >= 64 (one block per SM, up to 255
// registers a thread), else 1 (two blocks per SM, 128 registers).
template <int KT, bool PROJ, int MI>
__global__ void __launch_bounds__(kTcThreads, MI == 1 ? 2 : 1)
fused_bottleneck_tc_kernel(const TcParams p) {
  extern __shared__ float4 smem4[];  // float4: 16-byte aligned
  const int H = p.h, W = p.w, cin = p.cin, ci = p.ci, cout = p.cout;
  const int R = p.rows, CL = p.cl;
  const int cip = pad16(ci), cinp = pad16(cin), lda = cip + 8;
  const int a_zero = a_pixels(H, W, R) - 1;  // a's pixel of zeros
  const int a_elems = (a_zero + 1) * lda, b_elems = R * W * lda;
  bf16* a_s = reinterpret_cast<bf16*>(smem4);  // [image rows ya0..][W][lda]
  bf16* b_s = a_s + a_elems;                   // [R W][lda]
  bf16* ring = b_s + b_elems;                  // p.ring

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int frame = blockIdx.y, r0 = blockIdx.x / CL * R;
  const int rows_out = min(R, H - r0);
  const int t = frame % p.t_len;
  const size_t HW = (size_t)H * W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // ldmatrix: lane supplies row lr of matrix 2 * l16 + l8
  const int lr = lane & 7, l8 = (lane >> 3) & 1, l16 = lane >> 4;
  const int ci_n = cip / CL, ci0 = rank * ci_n;   // this block's a, b channels
  const int co_n = cout / CL, co0 = rank * co_n;  // and out channels
  const int ci_end = min(ci0 + ci_n, ci), co_end = co0 + co_n;
  constexpr int RW = 16 * MI;  // rows of a warp
  float acc[MI][kMaxNT<MI>][4];

  // image rows of a: the strip and its halo rows inside the image
  const int ya0 = max(r0 - 1, 0), ya1 = min(r0 + rows_out + 1, H);
  // ---- a's pixel of zeros, which taps outside the image read (zero AFTER
  // the ReLU: relu(0 W + b) != 0) ------------------------------------------
  for (int i = tid; i < lda / 8; i += kTcThreads)
    reinterpret_cast<uint4*>(a_s + (size_t)a_zero * lda)[i] =
        make_uint4(0, 0, 0, 0);
  // every block of the cluster runs before any writes into its memory
  cluster.sync();

  // ---- a on image rows ya0 .. ya1 - 1 (the strip and its halo) -----------
  // (its ring spans b's buffer and the ring: b is written only after a)
  {
    const int M = (ya1 - ya0) * W;
    const Pass s = pass_shape<MI>(M, ci_n, cinp, true, b_elems + p.ring);
    const int cpt = cinp / s.kc;  // chunks per temporal tap
    // temporal taps: frames outside the clip are skipped (zero)
    const int dt0 = KT == 3 && t == 0 ? 1 : 0;
    const int dt1 = KT == 3 && t == p.t_len - 1 ? 2 : KT;
    const int wm_i = warp % s.wm, wn_i = warp / s.wm;
    const int a_lane = (RW * wm_i + lr + 8 * l8) * s.ldk + 8 * l16;
    const int b_lane = (lr + 8 * l8) * s.ldn + 8 * l16 + wn_i * s.nt * 8;
    auto pos = [](int m) { return (size_t)m; };
    for (int mb = 0; mb < M; mb += s.bm) {
      const bool active = wn_i < s.wn && mb + RW * wm_i < M;
      const bf16* xrow = p.x + ((size_t)frame * HW + (size_t)ya0 * W + mb) * cin;
      for (int nb = 0; nb < ci_n; nb += s.bn) {
        auto load = [&](int c, bf16* st) {
          const int tap = c / cpt, k0 = (c - tap * cpt) * s.kc;
          const int dt = dt0 + tap;
          load_x(st, xrow + (ptrdiff_t)(dt - KT / 2) * (ptrdiff_t)HW * cin,
                  cin, M - mb, s.bm, k0, s.kc, s.ldk, p.x_vec);
          load_w(st + s.a_elems, p.wa, ci, dt * cin + k0, s.kc, cin - k0,
                  ci0 + nb, s.bn, ci_end, s.ldn, p.wa_vec);
        };
        auto a_ptr = [&](int, const bf16* st, int i) {
          return st + a_lane + 16 * i * s.ldk;
        };
        run_pass(acc, s, active, M - mb - RW * wm_i, (dt1 - dt0) * cpt, b_s,
                 b_lane, load, a_ptr);
        if (active)
          push_relu(acc, s, wm_i, wn_i, mb, M, nb, ci_n, ci0, p.ba, ci, lda,
                    a_s, cluster, CL, pos);
      }
    }
  }
  cluster.sync();  // all of a, from every block of the cluster

  // ---- b: the 1x3x3 conv over a, nine shifted taps ------------------------
  const int M = rows_out * W;
  {
    const Pass s = pass_shape<MI>(M, ci_n, cip, false, p.ring);
    const int cpt = cip / s.kc;  // chunks per tap
    const int wm_i = warp % s.wm, wn_i = warp / s.wm;
    const int b_lane = (lr + 8 * l8) * s.ldn + 8 * l16 + wn_i * s.nt * 8;
    auto pos = [](int m) { return (size_t)m; };
    for (int mb = 0; mb < M; mb += s.bm) {
      const bool active = wn_i < s.wn && mb + RW * wm_i < M;
      // the lane's ldmatrix rows: output pixel (y, x) of each m16 tile
      int ly[MI], lx[MI];
      for (int i = 0; i < MI; ++i) {
        const int m = min(mb + RW * wm_i + 16 * i + lr + 8 * l8, M - 1);
        ly[i] = r0 + m / W;
        lx[i] = m - (m / W) * W;
      }
      for (int nb = 0; nb < ci_n; nb += s.bn) {
        auto load = [&](int c, bf16* st) {
          const int tap = c / cpt, k0 = (c - tap * cpt) * s.kc;
          load_w(st, p.wb, ci, tap * ci + k0, s.kc, ci - k0, ci0 + nb, s.bn,
                  ci_end, s.ldn, p.wb_vec);
        };
        auto a_ptr = [&](int c, const bf16*, int i) {
          const int tap = c / cpt, k0 = (c - tap * cpt) * s.kc;
          const int dy = tap / 3, y = ly[i] + dy - 1, x = lx[i] + tap - 3 * dy - 1;
          const int px = y >= 0 && y < H && x >= 0 && x < W
                             ? (y - ya0) * W + x : a_zero;
          return a_s + (size_t)px * lda + k0 + 8 * l16;
        };
        run_pass(acc, s, active, M - mb - RW * wm_i, 9 * cpt, ring, b_lane,
                 load, a_ptr);
        if (active)
          push_relu(acc, s, wm_i, wn_i, mb, M, nb, ci_n, ci0, p.bb, ci, lda,
                    b_s, cluster, CL, pos);
      }
    }
  }
  cluster.sync();  // all of b; no block reads another's memory after this

  // ---- out = relu(bf16(b wc + bc) + residual), this block's Cout slice ----
  // (its ring is the larger of the ring and a's buffer, dead now)
  {
    bf16* ring_c = a_elems > p.ring ? a_s : ring;
    const int ring_n = max(a_elems, p.ring);
    const size_t pix0 = ((size_t)frame * H + r0) * W;  // first output pixel
    const Pass s = pass_shape<MI>(M, co_n, cip, false, ring_n);
    const Pass sp = pass_shape<MI>(M, co_n, cinp, true, ring_n);  // projection
    const int wm_i = warp % s.wm, wn_i = warp / s.wm;
    const int a_lane = (RW * wm_i + lr + 8 * l8) * sp.ldk + 8 * l16;
    const int b_lane = (lr + 8 * l8) * s.ldn + 8 * l16 + wn_i * s.nt * 8;
    for (int mb = 0; mb < M; mb += s.bm) {
      const bool active = wn_i < s.wn && mb + RW * wm_i < M;
      const int mv = min(s.bm, M - mb);
      const bf16* b_lane_a[MI];  // the lane's ldmatrix rows of b
      for (int i = 0; i < MI; ++i)
        b_lane_a[i] = b_s + (size_t)min(mb + RW * wm_i + 16 * i + lr + 8 * l8, M - 1) * lda + 8 * l16;
      const bf16* xrow = p.x + (pix0 + mb) * cin;
      bf16* orow = p.out + (pix0 + mb) * cout;
      for (int nb = 0; nb < co_n; nb += s.bn) {
        const int c0 = co0 + nb;
        if constexpr (PROJ) {  // bf16(x wp + bp) to out, read back below
          auto load = [&](int c, bf16* st) {
            const int k0 = c * sp.kc;
            load_x(st, xrow, cin, mv, sp.bm, k0, sp.kc, sp.ldk, p.x_vec);
            load_w(st + sp.a_elems, p.wp, cout, k0, sp.kc, cin - k0, c0,
                    sp.bn, co_end, sp.ldn, p.wp_vec);
          };
          auto a_ptr = [&](int, const bf16* st, int i) {
            return st + a_lane + 16 * i * sp.ldk;
          };
          run_pass(acc, sp, active, M - mb - RW * wm_i, cinp / sp.kc, ring_c,
                   b_lane, load, a_ptr);
          tile_out(acc, s, wm_i, wn_i, active, c0, cout, p.bp, ring_c);
          write_out(ring_c, s.ldn, mv, s.bn, c0, co_end, orow, cout, nullptr,
                    0, p.out_vec);
        }
        auto load = [&](int c, bf16* st) {
          const int k0 = c * s.kc;
          load_w(st, p.wc, cout, k0, s.kc, ci - k0, c0, s.bn, co_end, s.ldn,
                  p.wc_vec);
        };
        auto a_ptr = [&](int c, const bf16*, int i) {
          return b_lane_a[i] + c * s.kc;
        };
        run_pass(acc, s, active, M - mb - RW * wm_i, cip / s.kc, ring_c, b_lane,
                 load, a_ptr);
        tile_out(acc, s, wm_i, wn_i, active, c0, cout, p.bc, ring_c);
        // the residual: x, or the projection this thread wrote above
        write_out(ring_c, s.ldn, mv, s.bn, c0, co_end, orow, cout,
                  PROJ ? orow : xrow, PROJ ? cout : cin, p.out_vec);
      }
    }
  }
}

inline bool aligned16(const void* q) {
  return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
}

template <int KT, bool PROJ, int MI>
int launch_tc(const TcParams& p, cudaStream_t stream) {
  cudaError_t err = allow_smem<fused_bottleneck_tc_kernel<KT, PROJ, MI>>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cl * ((p.h + p.rows - 1) / p.rows), p.n, 1);
  cfg.blockDim = dim3(kTcThreads, 1, 1);
  cfg.dynamicSmemBytes = tc_smem(p.h, p.w, p.ci, p.rows, p.ring);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_bottleneck_tc_kernel<KT, PROJ, MI>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int MI>
int dispatch_tc_mi(const TcParams& p, int kt, bool proj, cudaStream_t s) {
  if (kt == 1)
    return proj ? launch_tc<1, true, MI>(p, s) : launch_tc<1, false, MI>(p, s);
  if (kt == 3)
    return proj ? launch_tc<3, true, MI>(p, s) : launch_tc<3, false, MI>(p, s);
  return (int)cudaErrorInvalidValue;
}

template <int KT, bool PROJ, int MI>
int max_clusters(int cluster, size_t smem) {
  cudaError_t err = allow_smem<fused_bottleneck_tc_kernel<KT, PROJ, MI>>();
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kTcThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, fused_bottleneck_tc_kernel<KT, PROJ, MI>, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

int dispatch_tc(const TcParams& p, int kt, bool proj, cudaStream_t s) {
  return p.ci >= 64 ? dispatch_tc_mi<2>(p, kt, proj, s)
                    : dispatch_tc_mi<1>(p, kt, proj, s);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of the float32 kernel: staging + a
// (rows + 2 halo rows) + b.
size_t fused_bottleneck_smem_bytes(int elem_bytes, int w, int ci, int rows) {
  return kStageFloats * sizeof(float) +
         (size_t)(2 * rows + 2) * w * ci * elem_bytes;
}

// Dynamic shared memory of one block of the bfloat16 kernel.
// ring: its elements (at least fused_bottleneck_tc_min_ring()).
size_t fused_bottleneck_tc_smem_bytes(int h, int w, int ci, int rows,
                                      int ring) {
  return tc_smem(h, w, ci, rows, ring);
}

int fused_bottleneck_tc_min_ring() { return kRingElems; }

// Clusters of `cluster` blocks of the bf16 kernel for kt 3 without a
// projection, with the warp tiles of Ci and smem bytes of shared memory,
// that the card runs at once; a negative CUDA error code on failure.
int fused_bottleneck_tc_max_clusters(int ci, int cluster, size_t smem) {
  return ci >= 64 ? max_clusters<3, false, 2>(cluster, smem)
                  : max_clusters<3, false, 1>(cluster, smem);
}

// dtype: 0 = float32 (scalar kernel; cluster 1, ring 0), 1 = bfloat16
// (tensor-core kernel). rows: output rows of a block's (cluster's) strip;
// cluster: blocks of a cluster, 1, 2, 4 or 8, where Ci and Cout are
// multiples of 16 times it; ring: elements of the bf16 kernel's ring. wp/bp
// are null for the identity shortcut (then cin == cout). Returns the CUDA
// error code of the launch.
int fused_bottleneck_launch(int dtype, const void* x, const void* wa,
                            const float* ba, const void* wb, const float* bb,
                            const void* wc, const float* bc, const void* wp,
                            const float* bp, void* out, int n, int t_len,
                            int h, int w, int cin, int ci, int cout, int kt,
                            int rows, int cluster, int ring, void* stream) {
  if (n <= 0 || n > 65535 || t_len <= 0 || n % t_len || rows <= 0 ||
      h <= 0 || w <= 0 || cin <= 0 || ci <= 0 || cout <= 0 ||
      (wp == nullptr && cin != cout))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool proj = wp != nullptr;
  if (dtype == 0) {
    if (cluster != 1 || ring != 0) return (int)cudaErrorInvalidValue;
    const Params p{x, wa, ba, wb, bb, wc, bc, wp, bp, out,
                   n, t_len, h, w, cin, ci, cout, rows};
    return dispatch<float>(p, kt, proj,
                           fused_bottleneck_smem_bytes(4, w, ci, rows), s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if ((cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      (cluster > 1 && (ci % (16 * cluster) || cout % (16 * cluster))) ||
      ring < kRingElems || tc_smem(h, w, ci, rows, ring) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const TcParams p{static_cast<const bf16*>(x),  static_cast<const bf16*>(wa),
                   ba, static_cast<const bf16*>(wb), bb,
                   static_cast<const bf16*>(wc), bc,
                   static_cast<const bf16*>(wp), bp, static_cast<bf16*>(out),
                   n, t_len, h, w, cin, ci, cout, rows, cluster, ring,
                   cin % 8 == 0 && aligned16(x),
                   ci % 8 == 0 && aligned16(wa),
                   ci % 8 == 0 && aligned16(wb),
                   cout % 8 == 0 && aligned16(wc),
                   proj && cout % 8 == 0 && aligned16(wp),
                   cout % 8 == 0 && aligned16(out) && (proj || aligned16(x))};
  return dispatch_tc(p, kt, proj, s);
}

}  // extern "C"
