// Hopper building blocks for the port's kernels: the Tensor Memory
// Accelerator (TMA) with its tensor maps, mbarriers, named barriers and
// the warpgroup matrix multiply (wgmma), as inline PTX for sm_90a.
//
// Written by hand, without CUTLASS or CuTe, so that a library including
// it builds in seconds.  attn_fwd_hopper.cuh, the forward body of K1
// (flash_fwd.cu) and K6 (block_sparse.cu), is built on it, and so is
// attn_bwd_hopper.cuh, the backward body of K2/K3 (flash_bwd.cu) and K7/K8
// (block_sparse.cu), and so are K5's implicit GEMM (conv3x3.cu) and K9's
// block-masked GEMM (block_sparse.cu).
// Its last sections hold what the two attention bodies share: the block
// shape and the steps of a sweep, the split of f32 operands into bf16
// pieces on which the f32 forward, dK/dV and dQ (and K5 and K9 in f32)
// form their products, and the products themselves; and the consumers
// that K5 and K9 share in f32.
//
// Conventions.
//   * Tiles land in shared memory by TMA with a swizzle whose span equals
//     one tile row of a "panel": a panel is at most 64 bf16 columns (128
//     bytes) wide, so a (rows, D) tile is D / 64 panels of (rows, 64) at
//     D >= 64, or one panel of (rows, D) at D 16 or 32 (32- or 64-byte
//     rows, 32- or 64-byte swizzle).  Each panel starts on a 1024-byte
//     boundary.  An f32 tile lands the same way in panels of at most 32
//     columns, and is split in place into bf16 panels for wgmma
//     (split_tile, below).
//   * wgmma reads such a panel through a shared-memory descriptor of the
//     same swizzle: rows at the panel's row pitch, groups of 8 rows at 8
//     pitches (the stride byte offset), each k16 step 32 bytes further
//     along a row (K-major) or 16 rows further down (MN-major, the
//     transposed B of a (keys, D) V tile).  Every product here spans at
//     most one panel in N, so the leading byte offset is never read.
//   * wgmma's m64 accumulator: thread t of warp w of the warpgroup holds
//     rows 16w + t/4 and 16w + t/4 + 8; element 4j + 2h + c is row
//     16w + t/4 + 8h, column 8j + 2(t%4) + c.  Taken 16 columns at a time
//     and packed to bf16 pairs it is the register A operand of the next
//     wgmma (the trick of FlashAttention-3).
//
// Its first section holds what every kernel of the port takes: the element
// conversions, the LSE sentinel and the shared-memory opt-in.
//
// The header is included by one .cu file per shared library (directly or
// through the attention bodies); everything lives in an anonymous
// namespace, so each library keeps its own copy.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

// ---- what every kernel takes ------------------------------------------------

constexpr float BIG_LSE = 1e30f;              // LSE of a fully masked row
constexpr int kMaxDevices = 64;
constexpr size_t kMaxSmemBytes = 232448;      // a block's opt-in limit on sm_90

// a variable, not a function: host and device code both read it
template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as astype does
}

// The dynamic shared-memory opt-in of `kernel`, made once per device, not
// per launch: it is a host call on the launch path and no stream
// operation, so a launch captured into a CUDA graph must not make it.
// `mu` and `done` belong to the one kernel instantiation.  With
// `max_carveout` the SM also gives shared memory all it can of its L1, so
// that several such blocks fit on it at once.
template <typename Kernel>
cudaError_t smem_opt_in_once(Kernel kernel, int bytes, std::mutex& mu, bool* done,
                             bool max_carveout = false) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && max_carveout)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}


__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// makes this thread's ordinary stores to shared memory visible to the async
// proxy (TMA, wgmma) of the threads that synchronise with it afterwards
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` more of TMA traffic in this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the barrier's phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// a barrier over `nthreads` threads (whole warps) under id 1..15; id 0 is
// __syncthreads's
__device__ __forceinline__ void named_barrier_sync(int id, int nthreads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// arrives on named barrier `id` (counted as `nthreads`, whole warps) without
// waiting: the threads that bar.sync on it wait for these arrivals, and see
// this thread's earlier writes to shared memory
__device__ __forceinline__ void named_barrier_arrive(int id, int nthreads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(nthreads) : "memory");
}

// moves registers between warpgroups of a warp-specialised block: a
// producer gives some up, consumers take them; all 128 threads of the
// warpgroup execute it, once, at the top of a branch the others never enter
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---- TMA -------------------------------------------------------------------

// box of a 2-D `tmap` at coordinates (c0 innermost, c1) into shared memory,
// completing `bytes` of `bar`'s expected traffic; out-of-bounds elements
// arrive as zeros.  K9 (block_sparse.cu) reads x and W so.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* tmap, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// a box of shared memory at `src`, in the layout a load of the same box
// would give, to a 2-D `tmap` at coordinates (c0 innermost, c1): elements
// outside the tensor are not written.  One bulk group of this thread; the
// writers of `src` fence_proxy_async() and synchronise with it first.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* tmap, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(tmap)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

// closes this thread's bulk group, then waits until its bulk stores have
// read their shared memory (it may then be reused or the block may exit)
__device__ __forceinline__ void tma_store_flush() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the same for a 3-D map: coordinates (c0 innermost, c1, c2)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* tmap, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the same for a 4-D map (c0 innermost .. c3); K5 (conv3x3.cu) reads its
// pixel boxes so, and its coordinates may be negative: elements before the
// start of a dimension arrive as zeros too
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* tmap, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

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

// keeps the compiler from moving reads or writes of an accumulator across
// a wgmma_wait: the registers are written asynchronously
__device__ __forceinline__ void fence_regs(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// swizzle span in bytes (32, 64, 128) of a panel row -> descriptor layout
template <int kRowBytes>
constexpr uint64_t kDescLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;

// shared-memory matrix descriptor of a swizzled panel with rows of
// kRowBytes bytes, starting at `p` (which may sit 32-byte steps into a
// row: the swizzle is a function of the address).  Both offsets hold the
// 8-row group stride: the stride byte offset reads it, and the leading
// byte offset is not read by a product within one swizzle atom in N.
template <int kRowBytes>
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  constexpr uint64_t sbo = (8 * kRowBytes) >> 4;   // 8-row groups
  const uint64_t addr = (smem_u32(p) & 0x3FFFF) >> 4;
  return addr | (sbo << 16) | (sbo << 32) | (kDescLayout<kRowBytes> << 62);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (m64n16, f32) (+)= A . B, A and B bf16 in shared memory (descriptors).
template <int kTransB>
__device__ __forceinline__ void wgmma_ss_m64n16k16(float* d, uint64_t desc_a, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

// D (m64n32, f32) (+)= A . B, A and B bf16 in shared memory (descriptors).
template <int kTransB>
__device__ __forceinline__ void wgmma_ss_m64n32k16(float* d, uint64_t desc_a, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

// D (m64n64, f32) (+)= A . B, A and B bf16 in shared memory (descriptors).
template <int kTransB>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float* d, uint64_t desc_a, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

// D (m64n128, f32) (+)= A . B, A and B bf16 in shared memory (descriptors).
template <int kTransB>
__device__ __forceinline__ void wgmma_ss_m64n128k16(float* d, uint64_t desc_a, uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

// D (m64n16, f32) += A . B, A bf16 in registers (four packed pairs per
// thread, the layout of an m64 accumulator's 16 columns), B in shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_m64n16k16(float* d, const uint32_t* a,
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

// D (m64n32, f32) += A . B, A bf16 in registers (four packed pairs per
// thread, the layout of an m64 accumulator's 16 columns), B in shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_m64n32k16(float* d, const uint32_t* a,
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

// D (m64n64, f32) += A . B, A bf16 in registers (four packed pairs per
// thread, the layout of an m64 accumulator's 16 columns), B in shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float* d, const uint32_t* a,
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate),
        "n"(kTransB));
}

// m64nNk16 with both operands in shared memory; accumulate = 0 overwrites d
template <int N, int kTransB>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma_ss: N");
  if constexpr (N == 16) wgmma_ss_m64n16k16<kTransB>(d, desc_a, desc_b, accumulate);
  if constexpr (N == 32) wgmma_ss_m64n32k16<kTransB>(d, desc_a, desc_b, accumulate);
  if constexpr (N == 64) wgmma_ss_m64n64k16<kTransB>(d, desc_a, desc_b, accumulate);
  if constexpr (N == 128) wgmma_ss_m64n128k16<kTransB>(d, desc_a, desc_b, accumulate);
}

// m64nNk16 with A in registers
template <int N, int kTransB>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc_b,
                                         int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64, "wgmma_rs: N");
  if constexpr (N == 16) wgmma_rs_m64n16k16<kTransB>(d, a, desc_b, accumulate);
  if constexpr (N == 32) wgmma_rs_m64n32k16<kTransB>(d, a, desc_b, accumulate);
  if constexpr (N == 64) wgmma_rs_m64n64k16<kTransB>(d, a, desc_b, accumulate);
}

// ---- panels and the consumer epilogue ----------------------------------------

// the panel split of a (rows, D) tile of kElem-byte elements (see the
// conventions above): bf16 panels of at most 64 columns; f32 ones, as TMA
// lands an f32 tile, of at most 32
template <int D, int kElem = 2>
struct Panels {
  static constexpr int PW = D * kElem < 128 ? D : 128 / kElem;   // panel width, columns
  static constexpr int NP = D / PW;                              // panels per row
  static constexpr int RB = PW * kElem;   // bytes per panel row = swizzle span
};

// TMA's swizzle and the wgmma descriptors assume 1024-byte-aligned panels
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// The epilogue of a consumer warpgroup, first half: its accumulator (this
// thread's rows r and r + 8 of 64, D / 2 f32) times `scale`, in bf16, into
// the warpgroup's own 64 rows of a tile of panels at `rows` (panel pitch
// kPanel), which no other warpgroup reads.  The 16-byte chunks of a row
// are xor'd by row, against bank conflicts.
template <int D, int kPanel>
__device__ __forceinline__ void stage_rows(unsigned char* rows, const float* acc, float scale) {
  using P = Panels<D>;
  constexpr int SWZ = P::RB / 16 - 1;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int j = 0; j < P::PW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + lane / 4 + 8 * h;
        const float* a = acc + p * (P::PW / 2) + 4 * j + 2 * h;
        *reinterpret_cast<uint32_t*>(rows + p * kPanel + r * P::RB + 16 * (j ^ (r & SWZ)) +
                                     4 * (lane % 4)) = pack_bf16x2(a[0] * scale, a[1] * scale);
      }
}

// Second half, after the warpgroup's named barrier: the 64 staged rows to
// rows row0 .. row0 + 63 of `out` (rows of D), 16 bytes a thread; rows at
// or past n_rows are not written.
template <int D, int kPanel>
__device__ __forceinline__ void store_rows(const unsigned char* rows, __nv_bfloat16* out,
                                           int row0, int n_rows) {
  using P = Panels<D>;
  constexpr int SWZ = P::RB / 16 - 1;
  for (int i = threadIdx.x % 128; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8);
    const int cc = i % (D / 8);
    const int p = cc / (P::PW / 8), j = cc % (P::PW / 8);
    if (row0 + r < n_rows)
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * D + 8 * cc) =
          *reinterpret_cast<const uint4*>(rows + p * kPanel + r * P::RB + 16 * (j ^ (r & SWZ)));
  }
}

// ---- attention sweeps --------------------------------------------------------
//
// What the bf16 attention kernels share (the forward of attn_fwd_hopper.cuh,
// the backward of attn_bwd_hopper.cuh): a block of two consumer warpgroups
// owns 128 rows and streams 64-row tiles of the other side (or 128 in K1's
// dense sweep below D 128); each streamed tile is a step of a sweep.

constexpr int kConsumers = 256;                // two warpgroups of 64 rows
constexpr int kBlockRows = 128;                // output rows per block
constexpr int kTileRows = 64;                  // rows of a streamed list tile
constexpr float kLog2e = 1.4426950408889634f;

// flag bits of a sweep step (shifted by the consumer warpgroup, 0 or 1):
// bit w when warpgroup w computes the tile, bit 2 + w when that pair is
// covered by the block mask in part
constexpr uint32_t kVisit = 1;
constexpr uint32_t kPartial = 4;
constexpr uint32_t kPartialAny = 12;

// one streamed tile of a sweep: its index (rows tile * tile rows ..) and flags
struct Step {
  int tile;
  uint32_t flags;
};

// Where the rows of one attention operand lie: a (B, H, rows, D) bf16 tensor
// whose last dim is unit-stride, with element strides b, h and r of its
// batch, head and row dims (contiguous: H rows D, rows D, D).  The attention
// kernels read q, k, v and dO through such strides, so the view
// (B, T, H, D).transpose(1, 2) that every attention layer makes is read in
// place; their outputs are contiguous.
struct HeadStrides {
  long long b, h, r;

  __host__ __device__ long long head(int bh, int H) const {
    return (long long)(bh / H) * b + (long long)(bh % H) * h;
  }
};

// the three HeadStrides of q, k, v (and dO) from the C entries' flat array
// (batch, head and row strides of each operand in turn)
inline HeadStrides head_strides(const long long* s, int i) {
  return HeadStrides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

// One warp stages rows row0 .. row0 + kRows - 1 of one head's (n_rows, D)
// bf16 or f32 matrix, row i at src + i * pitch, into a kRows-row tile of
// swizzled panels (Panels<D, sizeof(T)>) at `dst` (panel pitch kPanel),
// where TMA would put them: the swizzle xors a row's 16-byte chunk index
// with address bits 7.. of its panel offset (Swizzle<3,4,3> at 128-byte
// rows, <2,4,3> at 64, <1,4,3> at 32), so a row keeps its own bytes.  Rows
// whose bit in `live` is clear, and rows at or past n_rows, are written as
// zeros, not loaded.
template <int D, int kPanel, typename T, int kRows = kTileRows>
__device__ __forceinline__ void stage_live_rows(unsigned char* dst, const T* __restrict__ src,
                                                long long pitch, int row0, int n_rows,
                                                unsigned long long live, int lane) {
  using P = Panels<D, sizeof(T)>;
  constexpr int CPR = D * sizeof(T) / 16;   // 16-byte chunks per row
  constexpr int CPP = P::RB / 16;           // 16-byte chunks per panel row
  constexpr int EPC = 16 / sizeof(T);       // elements per chunk
  constexpr uint32_t SWZ = (P::RB / 16 - 1) << 4;
  // one load in flight: the producer runs on the few registers it kept
#pragma unroll 1
  for (int i = lane; i < kRows * CPR; i += 32) {
    const int r = i / CPR, cc = i % CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows && ((live >> r) & 1ull))
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * pitch + EPC * cc);
    const uint32_t a = r * P::RB + 16 * (cc % CPP);
    *reinterpret_cast<uint4*>(dst + (cc / CPP) * kPanel + (a ^ ((a >> 3) & SWZ))) = val;
  }
}

// ---- f32 products as bf16 products -------------------------------------------
//
// wgmma has no full-f32 product.  An f32 operand a is split into bf16
// pieces a1 = bf16(a), a2 = bf16(a - a1) and a3 = bf16(a - a1 - a2) (each
// difference exact in f32), so that a1 + a2 + a3 = a exactly (for |a| above
// 2^-102, where a3 is a normal number), and a product a . b is formed from
// bf16 wgmma products with f32 accumulation, small terms first: with three
// pieces on both sides a1 b3 + a2 b2 + a3 b1, then a1 b2 + a2 b1, then a1
// b1 (six products; the terms left out are 2^-24 of the product); with two
// pieces of b, a2 b2 + a3 b1, a1 b2 + a2 b1, a1 b1 (five; b's own
// rounding, 2^-17 of |b| at most, stays).  Two pieces a side, three
// products, miss the f32 limits of the attention backward on the card,
// and the forward's O needs three pieces of V too: the backward's delta =
// rowsum(dO O) must match its own recomputed P . V to f32 rounding, or
// the gradient of a key bias (zero in exact arithmetic) grows 20x
// (PERF.md).  Operands in registers are split where they are packed
// (split_bf16x3); a tile in shared memory is split in place (split_tile):
// the bytes of an f32 tile are those of its a1 and a2 panels, and a3 goes
// beside them.

// the three pieces of two f32 values, each pair packed as in pack_bf16x2
__device__ __forceinline__ void split_bf16x3(float x0, float x1, uint32_t& p1, uint32_t& p2,
                                             uint32_t& p3) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);   // round to nearest even
  const float2 b1 = __bfloat1622float2(h);
  const float r0 = x0 - b1.x, r1 = x1 - b1.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 b2 = __bfloat1622float2(m);
  p1 = *reinterpret_cast<const uint32_t*>(&h);
  p2 = *reinterpret_cast<const uint32_t*>(&m);
  p3 = pack_bf16x2(r0 - b2.x, r1 - b2.y);
}

// kThreads threads (a warpgroup, or both consumer warpgroups) split the
// kRows-row f32 tile at `t` (64 rows, or the f32 forward's 32-key tiles at
// D 192 and 256), which TMA landed as
// Panels<D, 4> (panels of 32 f32 columns, 128-byte rows, kRows * 128 bytes
// apart; D 16 one panel of 64-byte rows), in place into its three bf16
// pieces, each in panels of Panels<D> (the swizzle of their rows; SPAN =
// kRows rows of one): the first and second pieces of 64-column group g at
// t + 2 g SPAN and t + (2 g + 1) SPAN, where the f32 panels 2 g and 2 g + 1
// lay (so at D 128 each group is split on its own), and the third piece's
// panel g at t + kRows D 4 + g SPAN, after the f32 bytes.  A thread takes 8
// columns of a row a step; the threads read a whole group before they
// write it (named barrier `bar`, the kThreads threads, ranked by
// threadIdx.x % kThreads).  The caller fences the writes to the async
// proxy and synchronises before a wgmma reads them.
template <int D, int kThreads = 128, int kRows = kTileRows>
__device__ __forceinline__ void split_tile(unsigned char* t, int bar) {
  using F = Panels<D, 4>;
  using P = Panels<D>;
  constexpr int SPAN = kRows * P::RB;              // one bf16 panel
  constexpr int FPANEL = kRows * F::RB;            // one f32 panel
  constexpr int THIRD = kRows * D * 4;             // the third pieces, after the f32 bytes
  constexpr int CB = P::PW / 8;                    // 8-column blocks of a group's row
  constexpr int BLOCKS = kRows * CB;               // of a group
  constexpr int N = (BLOCKS + kThreads - 1) / kThreads;   // blocks a thread
  constexpr uint32_t SWZ_F = (F::RB / 16 - 1) << 4;
  constexpr uint32_t SWZ_B = (P::RB / 16 - 1) << 4;
  const int tid = threadIdx.x % kThreads;
#pragma unroll
  for (int g = 0; g < P::NP; ++g) {
    unsigned char* grp = t + 2 * g * SPAN;
    float4 v[2 * N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = tid + kThreads * i, r = u / CB, c = 8 * (u % CB);
      if (BLOCKS % kThreads != 0 && u >= BLOCKS) break;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = c + 4 * e;   // a 16-byte chunk of f32 columns
        const uint32_t a = r * F::RB + 4 * (cc % F::PW);
        v[2 * i + e] = *reinterpret_cast<const float4*>(grp + (cc / F::PW) * FPANEL +
                                                        (a ^ ((a >> 3) & SWZ_F)));
      }
    }
    named_barrier_sync(bar, kThreads);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int u = tid + kThreads * i, r = u / CB, c = 8 * (u % CB);
      if (BLOCKS % kThreads != 0 && u >= BLOCKS) break;
      const float4 x = v[2 * i], y = v[2 * i + 1];
      uint4 p1, p2, p3;
      split_bf16x3(x.x, x.y, p1.x, p2.x, p3.x);
      split_bf16x3(x.z, x.w, p1.y, p2.y, p3.y);
      split_bf16x3(y.x, y.y, p1.z, p2.z, p3.z);
      split_bf16x3(y.z, y.w, p1.w, p2.w, p3.w);
      const uint32_t a = r * P::RB + 2 * c;
      const uint32_t off = a ^ ((a >> 3) & SWZ_B);
      *reinterpret_cast<uint4*>(grp + off) = p1;
      *reinterpret_cast<uint4*>(grp + SPAN + off) = p2;
      *reinterpret_cast<uint4*>(t + THIRD + g * SPAN + off) = p3;
    }
  }
}

// A consumer warpgroup's 64 rows of k16 steps j0 .. j0 + kSteps - 1 of an
// f32 tile at `src` (rows of kRowBytes bytes as TMA lands them: 16-byte
// chunks xor'd by address bits 7..) as wgmma's register A operand: the
// three bf16 pieces (split_bf16x3), per piece and step the four packed
// pairs of an m64k16 A fragment, those of an m64 accumulator's 16 columns
// (thread t of warp w holds rows 16w + t/4 and + 8, columns 2(t%4) + {0,
// 1} and + 8).
template <int kRowBytes, int kSteps>
__device__ __forceinline__ void load_split_rows(uint32_t (&a)[3][kSteps][4],
                                                const unsigned char* src, int j0 = 0) {
  constexpr uint32_t SWZ = (kRowBytes / 16 - 1) << 4;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kSteps; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // i = 2 * (column half) + row half
      const uint32_t r = 16 * warp + lane / 4 + 8 * (i & 1);
      const uint32_t o =
          r * kRowBytes + 4 * (16 * (j0 + j) + 8 * (i >> 1) + 2 * (lane % 4));
      const float2 v = *reinterpret_cast<const float2*>(src + (o ^ ((o >> 3) & SWZ)));
      split_bf16x3(v.x, v.y, a[0][j][i], a[1][j][i], a[2][j][i]);
    }
}

// ---- GEMMs on f32 operands split into bf16 pieces (K5, K9) -------------------
//
// K5's f32 implicit GEMM (conv3x3.cu) and K9's f32 block-masked GEMM
// (block_sparse.cu) share their consumers: each consumer warpgroup reads
// its 64-row f32 box of A (as TMA landed it) straight into wgmma's register
// A operand, split there into three pieces (load_split_rows), the next
// step's while a step's products run, and B comes as three bf16 pieces
// that the wrapper split once per call.  A step (one ring stage, KC
// columns of A) makes six products a k16 step, small terms first, into a
// fresh partial, which is added to the f32 total (round to nearest) once
// done: wgmma rounds the sums it accumulates toward zero, which over all
// the steps' products in one accumulator shrank K5's output by 3.3e-5 at
// K = 4608 (PERF.md).  A ring's configuration C gives kSteps (k16 steps a
// stage), FRB (bytes of an A box row), kAcc (accumulator floats a thread),
// STAGES, A_SLOT, B_SLOT and products(part, a, b): the six products into
// part, issued, not waited.

// acc = the f32 product of A split into registers (a: piece, k16 step,
// fragment) and B's three pieces in shared memory, as six bf16 products a
// k16 step, small terms first: a1 b3 + a2 b2 + a3 b1, then a1 b2 + a2 b1,
// then a1 b1.  Piece p of B lies kPiece bytes after piece p - 1, k16 step
// j kStep bytes after step 0, rows of kRowBytes bytes (the descriptor's
// swizzle), read K-major (kTransB 0) or MN-major (1); a step makes kProducts
// m64nN products, product n's B kNext bytes after product 0's, its
// accumulator N / 2 floats after product 0's.  The first product of each
// overwrites its accumulator.  Issued, not waited.
template <int N, int kTransB, int kRowBytes, int kSteps, int kPiece, int kStep,
          int kProducts = 1, int kNext = 0>
__device__ __forceinline__ void wgmma_split_products(float* acc,
                                                     const uint32_t (&a)[3][kSteps][4],
                                                     const unsigned char* b) {
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    // the pieces (0-based) of term t: (0, 2) (1, 1) (2, 0) (0, 1) (1, 0) (0, 0)
    const int pa = t < 3 ? t : t < 5 ? t - 3 : 0;
    const int pb = t < 3 ? 2 - t : t == 3 ? 1 : 0;
#pragma unroll
    for (int j = 0; j < kSteps; ++j)
#pragma unroll
      for (int n = 0; n < kProducts; ++n)
        wgmma_rs<N, kTransB>(acc + n * (N / 2), a[pa][j],
                             smem_desc<kRowBytes>(b + pb * kPiece + n * kNext + kStep * j),
                             t + j > 0);
  }
}

// Step `it` of a live consumer warpgroup of ring C, its A box split into
// a[kA] already: issue the step's products into `part`, split the next
// step's box (at a_wg, A_SLOT bytes a stage) into a[1 - kA] while they
// run, then add them to the total (round to nearest) and free the stage.
template <class C, int kA>
__device__ __forceinline__ void split_gemm_step(uint32_t (&a)[2][3][C::kSteps][4],
                                                float (&part)[C::kAcc], float (&total)[C::kAcc],
                                                const unsigned char* a_wg,
                                                const unsigned char* b_s, uint64_t* full,
                                                uint64_t* empty, int it, int n_steps) {
  const int s = it % C::STAGES;
  wgmma_fence();
  C::products(part, a[kA], b_s + s * C::B_SLOT);
  wgmma_commit();
  if (it + 1 < n_steps) {
    const int s1 = (it + 1) % C::STAGES;
    mbar_wait(&full[s1], ((it + 1) / C::STAGES) & 1);
    load_split_rows<C::FRB, C::kSteps>(a[1 - kA], a_wg + s1 * C::A_SLOT);
  }
  wgmma_wait<0>();
  mbar_arrive(&empty[s]);
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) {
    fence_regs(part[i]);
    total[i] += part[i];
  }
}

// All n_steps (at least 1) steps of a live consumer warpgroup of ring C
// into `total`: its A boxes at a_wg, the B pieces at b_s, the box splits
// into registers alternating so that the next step's split runs beside a
// step's products.
template <class C>
__device__ __forceinline__ void split_gemm(float (&part)[C::kAcc], float (&total)[C::kAcc],
                                           const unsigned char* a_wg, const unsigned char* b_s,
                                           uint64_t* full, uint64_t* empty, int n_steps) {
  uint32_t a[2][3][C::kSteps][4];
  mbar_wait(&full[0], 0);
  load_split_rows<C::FRB, C::kSteps>(a[0], a_wg);
  for (int it = 0; it < n_steps; it += 2) {
    split_gemm_step<C, 0>(a, part, total, a_wg, b_s, full, empty, it, n_steps);
    if (it + 1 < n_steps)
      split_gemm_step<C, 1>(a, part, total, a_wg, b_s, full, empty, it + 1, n_steps);
  }
}

// The n_steps steps of a consumer warpgroup with no rows of its own (past
// the output's end): it waits for each stage and frees it, in step with
// the live warpgroup, since each stage's empty barrier counts both.
template <class C>
__device__ __forceinline__ void split_gemm_drain(uint64_t* full, uint64_t* empty, int n_steps) {
  for (int it = 0; it < n_steps; ++it) {
    const int s = it % C::STAGES;
    mbar_wait(&full[s], (it / C::STAGES) & 1);
    mbar_arrive(&empty[s]);
  }
}

// ---- the attention bodies' products ------------------------------------------

// acc (m64 x N f32, one consumer warpgroup) = A . B^T over D (kAcc: acc
// +=), both operands K-major panels in shared memory: A from 64 rows at
// `a`, B from N rows (64, or a tile's 32-row half) at `b`, panel pitches
// kPanelA and kPanelB.  Issued, not waited.
template <int D, int kPanelA, int kPanelB, bool kAcc = false, int N = kTileRows>
__device__ __forceinline__ void wgmma_scores(float* acc, const unsigned char* a,
                                             const unsigned char* b) {
  using P = Panels<D>;
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int j = 0; j < P::PW / 16; ++j)
      wgmma_ss<N, 0>(acc, smem_desc<P::RB>(a + p * kPanelA + 32 * j),
                     smem_desc<P::RB>(b + p * kPanelB + 32 * j), kAcc || p + j > 0);
}

// wgmma_scores of f32 tiles split in place into three pieces (split_tile:
// pieces 1 and 2 in panels at pitch 2 kSpan, piece 2 kSpan after piece 1,
// piece 3 at kThird in panels at pitch kSpan) as a1 b3 + a2 b2 + a3 b1,
// then a1 b2 + a2 b1, then a1 b1.  Issued, not waited.
template <int D, int kSpanA, int kSpanB, int kThird, int N = kTileRows>
__device__ __forceinline__ void wgmma_scores_split(float* acc, const unsigned char* a,
                                                   const unsigned char* b) {
  constexpr int PA = 2 * kSpanA, PB = 2 * kSpanB;
  wgmma_scores<D, PA, kSpanB, false, N>(acc, a, b + kThird);
  wgmma_scores<D, PA, PB, true, N>(acc, a + kSpanA, b + kSpanB);
  wgmma_scores<D, kSpanA, PB, true, N>(acc, a + kThird, b);
  wgmma_scores<D, PA, PB, true, N>(acc, a, b + kSpanB);
  wgmma_scores<D, PA, PB, true, N>(acc, a + kSpanA, b);
  wgmma_scores<D, PA, PB, true, N>(acc, a, b);
}

// acc (m64 x D f32) += A . B with A (64 x 16 kSteps) packed bf16 in
// registers and B the 16 kSteps x D rows at `b` (panel pitch kPanelB)
// read MN-major.  Issued, not waited.
template <int D, int kPanelB, int kSteps = kTileRows / 16>
__device__ __forceinline__ void wgmma_accumulate(float* acc, const uint32_t* a,
                                                 const unsigned char* b) {
  using P = Panels<D>;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int p = 0; p < P::NP; ++p)
      wgmma_rs<P::PW, 1>(acc + p * (P::PW / 2), a + 4 * kk,
                         smem_desc<P::RB>(b + p * kPanelB + 16 * P::RB * kk), 1);
}

// wgmma_accumulate of an f32 A split in registers into three pieces
// (split_bf16x3: a1, a2, a3) and an f32 tile split in place at `b` (as in
// wgmma_scores_split), as a1 b3 + a2 b2 + a3 b1 (a1 b3 only where kThird
// places b's third piece; with two, b's own rounding stays), then a1 b2 +
// a2 b1, then a1 b1.  Issued, not waited.
template <int D, int kSpanB, int kThird = 0, int kSteps = kTileRows / 16>
__device__ __forceinline__ void wgmma_accumulate_split(float* acc, const uint32_t* a1,
                                                       const uint32_t* a2, const uint32_t* a3,
                                                       const unsigned char* b) {
  constexpr int PB = 2 * kSpanB;
  if constexpr (kThird != 0) wgmma_accumulate<D, kSpanB, kSteps>(acc, a1, b + kThird);
  wgmma_accumulate<D, PB, kSteps>(acc, a2, b + kSpanB);
  wgmma_accumulate<D, PB, kSteps>(acc, a3, b);
  wgmma_accumulate<D, PB, kSteps>(acc, a1, b + kSpanB);
  wgmma_accumulate<D, PB, kSteps>(acc, a2, b);
  wgmma_accumulate<D, PB, kSteps>(acc, a1, b);
}

// ---- the wide f32 products (head dims 192 and 256) ---------------------------
//
// At D 192 and 256 the f32 attention kernels cannot hold both sides of a
// score product in three bf16 pieces: the block's own 64 rows stay in f32
// (q in the forward, K and V in dK/dV, Q and dO in dQ) and are split into
// wgmma's register A operand 32 columns (one TMA panel, two k16 steps) at a
// time, against a streamed tile of kWideRows rows split in place
// (split_tile<D, ., kWideRows>).  wgmma rounds the sums it accumulates
// toward zero (PERF.md): a score over all of D 256 in one accumulator (96
// roundings) shrinks enough that the forward's LSE and the backward's
// recomputed P disagree, and a key bias's gradient (zero in exact
// arithmetic) reads several times the plain f32 pipeline's; so each panel's
// twelve products go to a fresh partial, added to the score in f32 once
// done (tests/test_torch_f32_split.py).

// rows of a streamed tile at D 192 and 256 (key rows in the forward and in
// dQ, query rows in dK/dV), and whether the score products run as a loop
// over the A operand's panels (wide_scores)
constexpr int kWideRows = 32;
template <int D>
constexpr bool kWideRolled = D > 192;

// The products of panel g's k16 steps j0 .. j0 + kSteps - 1 (their pieces
// in a: piece, step, fragment) and the matching columns of N rows of a
// kWideRows-row tile split in place at k (N = 16 from the tile's row 16 on:
// the caller offsets k), six a step, small terms first (a1 b3 + a2 b2 + a3
// b1, a1 b2 + a2 b1, a1 b1), into part; the panel's first product
// overwrites it, or with kStep each step's first.  Issued, not waited.
template <int D, int kSteps, int N = kWideRows, bool kStep = false>
__device__ __forceinline__ void wide_products(float (&part)[N / 2],
                                              const uint32_t (&a)[3][kSteps][4],
                                              const unsigned char* k, int g, int j0) {
  using P = Panels<D>;   // the tile's pieces
  constexpr int SPAN = kWideRows * P::RB;
  constexpr int THIRD = kWideRows * D * 4;
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int c = 32 * g + 16 * (j0 + j);   // the k16 step's first column
    const int p = c / P::PW;                // the tile's 64-column group
#pragma unroll
    for (int t = 0; t < 6; ++t) {
      // the pieces (0-based) of term t: (0, 2) (1, 1) (2, 0) (0, 1) (1, 0) (0, 0)
      const int pa = t < 3 ? t : t < 5 ? t - 3 : 0;
      const int pb = t < 3 ? 2 - t : t == 3 ? 1 : 0;
      const unsigned char* b = k + (pb == 2 ? THIRD + p * SPAN : (2 * p + pb) * SPAN);
      wgmma_rs<N, 0>(part, a[pa][j], smem_desc<P::RB>(b + 2 * (c % P::PW)),
                     kStep ? t > 0 : j0 + j + t > 0);
    }
  }
}

// The partial of a panel, once its products are done, added to the score
// (round to nearest).
template <int N>
__device__ __forceinline__ void add_partial(float (&sc)[N / 2], float (&part)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    fence_regs(part[i]);
    sc[i] += part[i];
  }
}

// S (m64 x N, this thread's N / 2) = A . B^T of a consumer warpgroup's 64
// f32 rows at q (TMA's 32-column panels of 64 rows) and N rows of a
// kWideRows-row tile split in place at k: per panel of q, its k16 steps
// split into registers (load_split_rows) and its twelve products
// (wide_products) into a fresh partial (add_partial).  The order of the
// products is the same at every D; only how much of q is held split
// differs: at D 192 the panels are unrolled and the next one is split while
// the last one's products run; at D 256 that spills (the 96 products'
// operands outgrow the consumers' 240 registers, as do a second buffer in
// a loop and, in K6, a whole panel), so the panels run as a loop, a k16
// step split before its products.  With kStep (the backward's scores) each
// k16 step's six products go to a fresh partial, a loop at every D: wgmma
// aligns the products of an instruction to its largest term, accumulator
// included, and truncates the rest, so the small terms added to a partial
// that already holds a step's sum lose their low bits, and the backward's
// dS = P (dP - delta) cancels those errors up to the row's cancellation
// (PERF.md).  With kAcc the products are added to sc as it stands: the
// f32 backward above D 256 sums its scores over the D panels of a ring, a
// call a panel.  Waited.
template <int D, int N = kWideRows, bool kStep = false, bool kAcc = false>
__device__ __forceinline__ void wide_scores(float (&sc)[N / 2], const unsigned char* q,
                                            const unsigned char* k) {
  using F = Panels<D, 4>;
  constexpr int FPANEL = kTileRows * F::RB;
  float part[N / 2];
  if constexpr (!kAcc) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) sc[i] = 0.0f;
  }
  if constexpr (!kStep && !kWideRolled<D>) {
    uint32_t a[2][3][2][4];   // two panels' pieces
    load_split_rows<F::RB, 2>(a[0], q);
#pragma unroll
    for (int g = 0; g < F::NP; ++g) {
      wgmma_fence();
      wide_products<D, 2, N>(part, a[g & 1], k, g, 0);
      wgmma_commit();
      if (g + 1 < F::NP) load_split_rows<F::RB, 2>(a[(g + 1) & 1], q + (g + 1) * FPANEL);
      wgmma_wait<0>();
      add_partial<N>(sc, part);
    }
  } else {
    uint32_t a[3][1][4];   // one k16 step's pieces
#pragma unroll 1
    for (int g = 0; g < F::NP; ++g) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        load_split_rows<F::RB, 1>(a, q + g * FPANEL, j);
        wgmma_fence();
        wide_products<D, 1, N, kStep>(part, a, k, g, j);
        wgmma_commit();
        wgmma_wait<0>();
        if constexpr (kStep) add_partial<N>(sc, part);
      }
      if constexpr (!kStep) add_partial<N>(sc, part);
    }
  }
}

// ---- head dims above 256: panels and chunks --------------------------------
//
// Above head dim 256 the attention kernels (attn_fwd_chunk_kernel in
// attn_fwd_hopper.cuh, bwd_dkv_chunk_kernel and bwd_dq_chunk_kernel in
// attn_bwd_hopper.cuh) stream the operands whose products sum over D in
// panels of kChunkPanel columns, and a block keeps kChunkCols columns of
// its output: the chunks of a head are blocks of their own.

constexpr int kChunkPanel = 64;    // columns of the summed operands a ring stage holds
constexpr int kChunkCols = 256;   // output columns a block keeps

// The columns of chunk c of a head dim D (a multiple of kChunkPanel above
// kChunkCols): it writes the output's columns lo .. hi - 1 (each column by
// one chunk) and forms them within the kChunkCols columns from col0, which
// stay inside D (the last chunk reaches back into its neighbour's).
struct Chunk {
  int col0, lo, hi;
};

__host__ __device__ inline Chunk chunk_of(int c, int D) {
  const int lo = c * kChunkCols;
  const bool whole = lo + kChunkCols <= D;
  return Chunk{whole ? lo : D - kChunkCols, lo, whole ? lo + kChunkCols : D};
}

__host__ __device__ inline int chunk_count(int D) { return (D + kChunkCols - 1) / kChunkCols; }

// The bf16 chunked kernels' scores over one ring stage: wgmma's products
// of a consumer warpgroup's 64 own rows at a and N rows of the streamed
// tile at b (64 keys in the forward and dK/dV, a warpgroup's 32 in dQ),
// both one kChunkPanel-column panel of 128-byte rows, into acc (m64 x N);
// the first of them overwrites acc where `first`.  Issued, not waited.
template <int N = kTileRows>
__device__ __forceinline__ void chunk_scores_bf16(float* acc, const unsigned char* a,
                                                  const unsigned char* b, bool first) {
#pragma unroll
  for (int j = 0; j < kChunkPanel / 16; ++j)
    wgmma_ss<N, 0>(acc, smem_desc<128>(a + 32 * j), smem_desc<128>(b + 32 * j),
                   !first || j > 0);
}


// ---- tensor maps (host) ----------------------------------------------------

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime so
// that no library has to link libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A tensor map over an array of `rank` dimensions of bf16 (kElem 2) or f32
// (kElem 4) elements, dims[0] innermost, read in boxes of `box` elements
// with the swizzle of box[0] * kElem-byte rows (32, 64 or 128 bytes).
// Out-of-bounds elements read as zeros.  The array is contiguous, or
// dimension i > 0 steps pitches[i - 1] bytes.  The strides must be
// multiples of 16 bytes (contiguous: dims[0] * kElem a multiple of 16),
// the base 16-byte aligned.
template <int kElem = 2>
inline cudaError_t encode_tiled(CUtensorMap* map, const void* base, int rank,
                                const uint64_t* dims, const uint32_t* box,
                                const uint64_t* pitches = nullptr) {
  static_assert(kElem == 2 || kElem == 4, "encode_tiled: bf16 or f32");
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const uint32_t row_bytes = box[0] * kElem;
  CUtensorMapSwizzle swizzle = row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                               : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : row_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                 : CU_TENSOR_MAP_SWIZZLE_NONE;
  if (swizzle == CU_TENSOR_MAP_SWIZZLE_NONE || rank < 1 || rank > 5) return cudaErrorInvalidValue;
  cuuint64_t g_dims[5], strides[4];
  cuuint32_t g_box[5], elem_strides[5];
  uint64_t pitch = kElem;   // bytes
  for (int i = 0; i < rank; ++i) {
    g_dims[i] = dims[i];
    g_box[i] = box[i];
    elem_strides[i] = 1;
    if (i > 0) strides[i - 1] = pitches ? pitches[i - 1] : pitch;
    pitch *= dims[i];
  }
  const CUtensorMapDataType type =
      kElem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUresult r = fn(map, type, rank, const_cast<void*>(base), g_dims, strides, g_box,
                  elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A tensor map over a matrix of kElem-byte elements (bf16 2, f32 4) of n1
// rows of n0 elements, row r at `base` + r * `pitch` elements, read in
// boxes of (box1 rows, box0 columns).
template <int kElem = 2>
inline cudaError_t encode_2d(CUtensorMap* map, const void* base, uint64_t n0, uint64_t n1,
                             uint64_t pitch, uint32_t box0, uint32_t box1) {
  const uint64_t dims[2] = {n0, n1};
  const uint32_t box[2] = {box0, box1};
  const uint64_t pitches[1] = {kElem * pitch};
  return encode_tiled<kElem>(map, base, 2, dims, box, pitches);
}

// A tensor map over n2 bf16 matrices of n1 rows of n0 elements, row r of
// matrix i at `base` + (i n1 + r) * `pitch` elements, read in boxes of
// (1, box1 rows, box0 columns): a box never reaches past its matrix.
// K9's f32 route reads W's three bf16 pieces so.
inline cudaError_t encode_bf16_stack(CUtensorMap* map, const void* base, uint64_t n0, uint64_t n1,
                                     uint64_t n2, uint64_t pitch, uint32_t box0, uint32_t box1) {
  const uint64_t dims[3] = {n0, n1, n2};
  const uint32_t box[3] = {box0, box1, 1};
  const uint64_t pitches[2] = {2 * pitch, 2 * pitch * n1};
  return encode_tiled<2>(map, base, 3, dims, box, pitches);
}

// A tensor map over a contiguous bf16 array of shape (n2, n1, n0), n0
// innermost, read in boxes of (1, box1, box0): a box never reaches past n1
// into the next index of n2.  K5 (conv3x3.cu) reads its weights so.
inline cudaError_t encode_bf16_3d(CUtensorMap* map, const void* base, uint64_t n0, uint64_t n1,
                                  uint64_t n2, uint32_t box0, uint32_t box1) {
  const uint64_t dims[3] = {n0, n1, n2};
  const uint32_t box[3] = {box0, box1, 1};
  return encode_tiled(map, base, 3, dims, box);
}

// A tensor map over the first n_heads heads of an attention operand of
// element type T (bf16 or f32; D columns, `rows` rows a head, H heads a
// batch, strides `s`) as the 4-D array (D, rows, H, B), read in boxes of
// (1, 1, box1, box0) loaded at (column, row, h, b): a box never reaches
// past its own head, and rows past `rows` arrive as zeros.  TMA takes
// strides that are multiples of 16 bytes and a 16-byte-aligned base; the
// wrappers copy an operand that breaks this.
template <typename T>
inline cudaError_t encode_heads(CUtensorMap* map, const void* base, int D, int rows, int H,
                                int n_heads, HeadStrides s, uint32_t box0, uint32_t box1) {
  constexpr uint64_t E = sizeof(T);
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)rows, (uint64_t)H,
                            (uint64_t)((n_heads + H - 1) / H)};
  const uint32_t box[4] = {box0, box1, 1, 1};
  const uint64_t pitches[3] = {E * (uint64_t)s.r, E * (uint64_t)s.h, E * (uint64_t)s.b};
  return encode_tiled<(int)E>(map, base, 4, dims, box, pitches);
}

// A tensor map over a contiguous bf16 array of shape (n3, n2, n1, n0), read
// in boxes of (box3, box2, box1, box0): a box lands in shared memory as
// box3 * box2 * box1 rows of box0 elements, row-major.
inline cudaError_t encode_bf16_4d(CUtensorMap* map, const void* base, uint64_t n0, uint64_t n1,
                                  uint64_t n2, uint64_t n3, uint32_t box0, uint32_t box1,
                                  uint32_t box2, uint32_t box3) {
  const uint64_t dims[4] = {n0, n1, n2, n3};
  const uint32_t box[4] = {box0, box1, box2, box3};
  return encode_tiled(map, base, 4, dims, box);
}

}  // namespace
