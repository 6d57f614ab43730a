// Tile machinery shared by the port's attention kernels: the f32 paths of
// K3 (flash_bwd.cu) and K8 (block_sparse.cu); conv3x3.cu (K5), K9,
// attn_wide.cu and the Hopper kernels take its helpers too.  It is the
// counterpart of the shared tile helpers at the top of
// bigdl_tpu/ops/flash_attention.py.  The bf16 K1-K3, K5 and K6-K8 and the
// f32 K1, K2, K6 and K7 are built on hopper_common.cuh (TMA, mbarriers,
// wgmma), the attention kernels also on attn_fwd_hopper.cuh and
// attn_bwd_hopper.cuh.
//
// Every tile is TILE = 64 rows of a row-major (rows, D) matrix, worked on
// by one block of four warps.  Each warp owns 16 rows of the tile it
// produces: it computes those rows of a score tile and then consumes the
// same rows as the A operand of its own accumulation, so only loads of
// shared tiles need a block-wide barrier.  The products are f32 FMA;
// wgmma has no f32 product, and the f32 K1, K2, K6 and K7 form each of
// theirs from bf16 products on bf16 pieces of its operands instead
// (hopper_common.cuh), a design the kernels here have not taken yet.
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

constexpr int TILE = 64;                      // rows of every q/k/v tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS_PER_WARP = TILE / NWARPS;  // 16
constexpr float BIG_LSE = 1e30f;              // LSE of a fully masked row
constexpr int kMaxDevices = 64;
constexpr size_t kMaxSmemBytes = 232448;      // a block's opt-in limit on sm_90

static_assert(TILE == 64, "the softmax passes give each lane two columns");

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

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Rows [row0, row0 + nrows) of a row-major (rows_total, D) matrix into
// shared memory, 16 bytes per thread per step; rows past rows_total are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int rows_total,
                                          int nrows) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < nrows * VPR; i += NTHREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows_total)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * D + c) = val;
  }
}

// s_s[rows of this warp][0:TILE] = a_s[rows of this warp] . b_s^T, in f32
// and unscaled.  a_s and b_s are (TILE, D) row-major tiles; s_s is
// (TILE, TILE) row-major.
template <int D>
__device__ __forceinline__ void score_tile(const float* a_s, const float* b_s, float* s_s,
                                           int warp, int lane) {
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    for (int c = lane; c < TILE; c += 32) {
      float acc = 0.0f;
      for (int dd = 0; dd < D; ++dd) {
        const int d = (dd + lane) & (D - 1);   // rotate: no bank conflicts on b_s
        acc += a_s[r * D + d] * b_s[c * D + d];
      }
      s_s[r * TILE + c] = acc;
    }
  }
}

// acc_s[rows of this warp] += a_s[rows of this warp] . b_s, f32 accumulate.
// a_s is (TILE, TILE) row-major (a probability or dS tile), b_s a (TILE, D)
// row-major tile, acc_s (TILE, D) f32.
template <int D>
__device__ __forceinline__ void mma_acc_tile(const float* a_s, const float* b_s, float* acc_s,
                                             int warp, int lane) {
  const int r0 = warp * ROWS_PER_WARP;
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = r0 + rr;
    for (int d = lane; d < D; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < TILE; ++j) acc += a_s[r * TILE + j] * b_s[j * D + d];
      acc_s[r * D + d] += acc;
    }
  }
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
