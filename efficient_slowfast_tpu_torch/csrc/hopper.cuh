// Hopper (sm_90a) building blocks: mbarriers, distributed shared memory
// (bulk copies into and arrivals on the other blocks of a cluster), TMA tile
// loads and bulk copies into shared memory, cp.async copies whose
// completion an mbarrier counts, the bulk float32 reduce-add from shared
// into global memory, warpgroup matrix multiplies (wgmma) with f32
// accumulation on bf16 operands and s32 accumulation on s8 operands, named
// barriers and register reallocation. Each is a thin wrapper over one PTX
// instruction (PTX ISA 8.0, sm_90a), so that a kernel's source reads as
// CUDA C++ and its PTX sits in one place.
//
// Shared-memory operands of wgmma are described in the 128-byte swizzle
// (desc_sw128, K3) or in the no-swizzle ("interleave") layout, whose unit
// is a core matrix: 8 rows of 16 bytes
// (8 bf16 or 16 s8), 128 contiguous bytes. A tile stored as column panels,
// [cols / 8][rows][8] bf16, is made of such core matrices, and one TMA
// load of a box 8 columns wide and `rows` high writes one panel
// (make_panel_map). The same
// panel tile serves both operand orders (PTX ISA, "Shared Memory Matrix
// Layout", canonical layouts without swizzling):
//   K-major  (rows = M or N, panels = K):  core matrices along M/N are SBO
//            = 128 bytes apart, the two along K of a k16 step LBO = rows *
//            16 bytes apart.
//   MN-major (rows = K, panels = M or N):  core matrices along M/N are SBO
//            = rows * 16 bytes apart, along K LBO = 128 bytes apart.
// An s8 k32 step spans the same 32 bytes of K as a bf16 k16 step, so its
// operands take the same descriptors; 8-bit wgmma reads K-major only.
// wgmma's accumulator (m64nN, f32 or s32) in the registers of thread 4 g + t of
// warp w of the warpgroup: d[4 j + e] is row 16 w + g + 8 (e / 2), column
// 8 j + 2 t + (e % 2). An A operand in registers (m64k16, bf16x2) has the
// layout of mma.sync's A: a[0] rows g, columns 2t..2t+1; a[1] row g + 8;
// a[2] row g, columns 2t+8..2t+9; a[3] row g + 8, columns 2t+8..2t+9, all
// within warp w's 16 rows. So accumulator registers of columns 16 kk ..
// 16 kk + 15 pack into the A fragment of k16 step kk.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hp {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers --------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival that also expects `bytes` of transactions (TMA copies).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// True once the phase of parity `parity` has completed.
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// mbar_wait for kernels that finish in milliseconds: a phase that has not
// completed within 4 s means a lost arrival, and the kernel traps (a
// launch failure that the host sees) instead of hanging the card.
__device__ __forceinline__ void mbar_wait_bounded(uint64_t* bar,
                                                  uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try_wait(bar, parity))
    if (globaltimer() - t0 > 4000000000ull) __trap();
}

// ---- thread block clusters --------------------------------------------

// The address of `p`'s counterpart in the shared memory of block `rank`
// of the cluster, for the ::cluster state space.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

// One arrival on `bar` in the shared memory of block `rank` of the
// cluster, releasing this thread's earlier writes (and those ordered
// before it) at cluster scope.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, int rank) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          cluster_addr(bar, rank))
      : "memory");
}

// mbar_wait_bounded whose completion acquires at cluster scope: what the
// other blocks of the cluster wrote before their arrivals is visible.
__device__ __forceinline__ bool mbar_try_wait_cluster(uint64_t* bar,
                                                      uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
      "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  if (mbar_try_wait_cluster(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try_wait_cluster(bar, parity))
    if (globaltimer() - t0 > 4000000000ull) __trap();
}

// Every thread of every block of the cluster: the cluster's barrier
// (arrive with release, wait with acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---- TMA and bulk copies ----------------------------------------------

// The box of a 3-D tensor map at coordinates (c0, c1, c2), innermost
// first, into shared memory; completes `bar`'s transactions. Elements
// outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The box of a 4-D tensor map at coordinates (c0, c1, c2, c3), innermost
// first.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The box of a 2-D tensor map at coordinates (c0, c1), innermost first.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
// from global into shared memory; completes `bar`'s transactions.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16) from this block's shared memory to the cluster
// address `dst` (cluster_addr) in another block's, completing the
// transactions of the mbarrier at the cluster address `bar` there.
__device__ __forceinline__ void bulk_copy_cluster(uint32_t dst,
                                                  const void* src,
                                                  uint32_t bytes,
                                                  uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// dst[i] += src[i] for `bytes` / 4 floats, shared to global, as one
// asynchronous bulk operation of the issuing thread's bulk group.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst,
                                                    const float* src,
                                                    uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], "
      "[%1], %2;\n" ::"l"(dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until the thread's committed bulk operations have read their
// shared-memory sources.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma operands, bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// BYTES (4, 8 or 16; both addresses aligned to it) from global into
// shared memory by cp.async: L1-cached below 16 bytes, L2 only at 16.
// No "memory" clobber: the compiler may move other loads across the
// copy (the copied shared memory is read only after a barrier or a
// cp.async wait, which do clobber memory).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES));
}

// One arrival on `bar` once every cp.async this thread has issued so far
// has landed; the arrival is one of the barrier's expected count (noinc).
// The copies are generic-proxy writes: a reader that hands the data to
// wgmma runs fence_proxy_async after its wait.
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Loads a tensor map (a kernel parameter) into the TMA unit's cache ahead
// of its first use.
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---- barriers and registers -------------------------------------------

// bar.sync on named barrier `id` (1-15) for `count` threads.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- wgmma ------------------------------------------------------------

// Shared-memory matrix descriptor, no swizzle: start address, leading and
// stride byte offsets (each >> 4 in 14 bits).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// p, hidden from the compiler's view (it cannot hoist what depends on it).
template <typename T>
__device__ __forceinline__ const T* opaque(const T* p) {
  uint64_t v = reinterpret_cast<uint64_t>(p);
  asm volatile("mov.b64 %0, %0;\n" : "+l"(v));
  return reinterpret_cast<const T*>(v);
}

// K-major operand rows of 128 bytes in the 128-byte swizzle (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B: 16-byte chunk c of row r at chunk c ^ (r %
// 8) of its row), 8-row groups SBO = 1024 bytes apart; the tile 1024-byte
// aligned. A k32 (s8) or k16 (bf16) step j starts at the tile + 32 j.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// MN-major operand in the 128-byte swizzle: atoms of 64 M/N elements (128
// bytes, one row) by K rows, 8-row groups SBO = 1024 bytes apart, atoms
// along M/N `lbo` bytes apart; each atom 1024-byte aligned. A k16 step kk
// starts at the tile + 2048 kk (16 rows of 128 bytes).
__device__ __forceinline__ uint64_t desc_sw128_mn(const void* p,
                                                  uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma issue or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// The same for an A operand in registers: wgmma reads it until its wait,
// so it is kept from reuse until then.
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ESF_ACC8(i)                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (m64 x N, f32) = A B + (accumulate ? d : 0), K = 16, bf16. A and B
// from shared memory by descriptor; TA / TB: A / B is MN-major.
template <int N, int TA, int TB>
struct Wgmma;

// The same with A in registers (four bf16x2 per thread).
template <int N, int TB>
struct WgmmaRs;

template <int TA, int TB>
struct Wgmma<16, TA, TB> {
  __device__ static __forceinline__ void run(float (&d)[8], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : ESF_ACC8(0)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<32, TA, TB> {
  __device__ static __forceinline__ void run(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : ESF_ACC8(0), ESF_ACC8(8)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Wgmma<64, TA, TB> {
  __device__ static __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : ESF_ACC8(0), ESF_ACC8(8), ESF_ACC8(16), ESF_ACC8(24)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
  }
};

template <int TB>
struct WgmmaRs<16, TB> {
  __device__ static __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, "
        "1, %14;\n}\n"
        : ESF_ACC8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate), "n"(TB));
  }
};

template <int TB>
struct WgmmaRs<32, TB> {
  __device__ static __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : ESF_ACC8(0), ESF_ACC8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate), "n"(TB));
  }
};

template <int TB>
struct WgmmaRs<64, TB> {
  __device__ static __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : ESF_ACC8(0), ESF_ACC8(8), ESF_ACC8(16), ESF_ACC8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate), "n"(TB));
  }
};

template <int TB>
struct WgmmaRs<128, TB> {
  __device__ static __forceinline__ void run(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, "
        "%67}, %68, p, 1, 1, %70;\n}\n"
        : ESF_ACC8(0), ESF_ACC8(8), ESF_ACC8(16), ESF_ACC8(24), ESF_ACC8(32),
          ESF_ACC8(40), ESF_ACC8(48), ESF_ACC8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate), "n"(TB));
  }
};

template <int TB>
struct WgmmaRs<256, TB> {
  __device__ static __forceinline__ void run(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
        "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
        "%127}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : ESF_ACC8(0), ESF_ACC8(8), ESF_ACC8(16), ESF_ACC8(24), ESF_ACC8(32),
          ESF_ACC8(40), ESF_ACC8(48), ESF_ACC8(56), ESF_ACC8(64), ESF_ACC8(72),
          ESF_ACC8(80), ESF_ACC8(88), ESF_ACC8(96), ESF_ACC8(104),
          ESF_ACC8(112), ESF_ACC8(120)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate), "n"(TB));
  }
};

#undef ESF_ACC8

#define ESF_IACC8(i)                                                    \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),           \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (m64 x N, s32) = A B + (accumulate ? d : 0), K = 32, s8 x s8, A and B
// K-major in shared memory by descriptor (integer wgmma takes neither
// transposes nor operand scales). N: the widths K3 instantiates.
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<8> {
  __device__ static __forceinline__ void run(int (&d)[4], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaS8<16> {
  __device__ static __forceinline__ void run(int (&d)[8], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
        : ESF_IACC8(0)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaS8<32> {
  __device__ static __forceinline__ void run(int (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15}, %16, %17, p;\n}\n"
        : ESF_IACC8(0), ESF_IACC8(8)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaS8<64> {
  __device__ static __forceinline__ void run(int (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p;\n}\n"
        : ESF_IACC8(0), ESF_IACC8(8), ESF_IACC8(16), ESF_IACC8(24)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaS8<128> {
  __device__ static __forceinline__ void run(int (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
        : ESF_IACC8(0), ESF_IACC8(8), ESF_IACC8(16), ESF_IACC8(24),
          ESF_IACC8(32), ESF_IACC8(40), ESF_IACC8(48), ESF_IACC8(56)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct WgmmaS8<256> {
  __device__ static __forceinline__ void run(int (&d)[128], uint64_t a,
                                             uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
        "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
        "%127}, %128, %129, p;\n}\n"
        : ESF_IACC8(0), ESF_IACC8(8), ESF_IACC8(16), ESF_IACC8(24),
          ESF_IACC8(32), ESF_IACC8(40), ESF_IACC8(48), ESF_IACC8(56),
          ESF_IACC8(64), ESF_IACC8(72), ESF_IACC8(80), ESF_IACC8(88),
          ESF_IACC8(96), ESF_IACC8(104), ESF_IACC8(112), ESF_IACC8(120)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};


#undef ESF_IACC8

// ---- host: tensor maps ------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, from the libcuda that the CUDA
// runtime has loaded into the process (no link against libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A bf16 tensor (planes, rows, cols), contiguous, read in boxes of 8
// columns by `box_rows` rows of one plane, zero outside the tensor: one
// box fills one column panel of a tile. Returns false where the driver
// refuses (cols % 8 or a base that is not 16-byte aligned).
inline bool make_panel_map(CUtensorMap* map, const void* base, int planes,
                           int rows, int cols, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {8, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 tensor (planes, rows, cols), contiguous, cols a multiple of 8 and
// base 16-byte aligned, seen as (planes, cols / 8, rows, 8) and read in
// boxes of `box_panels` 8-column panels by `box_rows` rows (coordinates: 0,
// first row, first panel, plane): one box fills a tile of column panels
// [box_panels][box_rows][8] (the no-swizzle layout above) in one copy;
// panels and rows outside the tensor arrive as zeros. Returns false where
// the driver refuses.
inline bool make_panels_map(CUtensorMap* map, const void* base, int planes,
                            int rows, int cols, int box_rows,
                            int box_panels) {
  EncodeTiled encode = encode_tiled();
  if (!encode || cols % 8) return false;
  const cuuint64_t dims[4] = {8, (cuuint64_t)rows, (cuuint64_t)cols / 8,
                              (cuuint64_t)planes};
  const cuuint64_t strides[3] = {(cuuint64_t)cols * 2, 16,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[4] = {8, (cuuint32_t)box_rows, (cuuint32_t)box_panels,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 tensor (planes, rows, cols), contiguous, cols a multiple of 64
// and base 16-byte aligned, seen as (planes, cols / 64, rows, 64) and read
// in the 128-byte swizzle in boxes of `box_atoms` 64-column atoms by
// `box_rows` rows (coordinates: 0, first row, first atom, plane): one box
// fills a tile [box_atoms][box_rows][128 bytes], K-major (desc_sw128) or
// MN-major (desc_sw128_mn), in one copy; atoms and rows outside the tensor
// arrive as zeros. Returns false where cuTensorMapEncodeTiled refuses.
inline bool make_sw128_tile_map(CUtensorMap* map, const void* base,
                                int planes, int rows, int cols, int box_rows,
                                int box_atoms) {
  EncodeTiled encode = encode_tiled();
  if (!encode || cols % 64) return false;
  const cuuint64_t dims[4] = {64, (cuuint64_t)rows, (cuuint64_t)cols / 64,
                              (cuuint64_t)planes};
  const cuuint64_t strides[3] = {(cuuint64_t)cols * 2, 128,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, (cuuint32_t)box_atoms,
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// An int8 matrix (rows, cols), contiguous, cols a multiple of 16 and base
// 16-byte aligned, read in boxes of 128 columns by `box_rows` rows in the
// 128-byte swizzle (desc_sw128's layout), zero outside the matrix: one box
// fills one K-major operand tile [box_rows][128 bytes] of a ring stage.
// Returns false where the driver refuses.
inline bool make_sw128_map(CUtensorMap* map, const void* base, long long rows,
                           int cols, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hp
