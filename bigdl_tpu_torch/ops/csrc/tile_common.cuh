// Helpers shared by the port's kernels: the block shape of the FMA tile
// loop left, K9's tile route (block_sparse.cu), one block of four warps;
// its element conversions, the LSE sentinel and the shared-memory opt-in
// that every kernel takes.  The attention
// kernels K1-K3 and K6-K8, K5 and K9's Hopper route are built on
// hopper_common.cuh (TMA, mbarriers, wgmma), the attention kernels also on
// attn_fwd_hopper.cuh and attn_bwd_hopper.cuh; in f32 the attention
// kernels and K5 form each product from bf16 products on bf16 pieces of
// its operands, a design K9's tile loop has not taken yet.
//
// The header is included by one .cu file per shared library; everything
// lives in an anonymous namespace, so each library keeps its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace {

constexpr int NTHREADS = 128;                 // a tile loop's block: four warps
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

}  // namespace
