// Tile machinery shared by the port's attention kernels: the f32 paths of
// K1-K3 (flash_fwd.cu, flash_bwd.cu) and of K7/K8, K6 and K9
// (block_sparse.cu); conv3x3.cu (K5), attn_wide.cu and the Hopper kernels
// take its helpers too.  It is the counterpart of the shared tile helpers
// at the top of bigdl_tpu/ops/flash_attention.py.  The bf16 K1-K3 and
// K7/K8 are built on hopper_common.cuh (TMA, mbarriers, wgmma) and
// attn_bwd_hopper.cuh.
//
// Every tile is TILE = 64 rows of a row-major (rows, D) matrix, worked on
// by one block of four warps.  Each warp owns 16 rows of the tile it
// produces: it computes those rows of a score tile and then consumes the
// same rows as the A operand of its own accumulation, so only loads of
// shared tiles need a block-wide barrier.  bf16 products run on the
// tensor cores through WMMA (16x16x16, f32 accumulate); f32 inputs use
// plain FMA, since WMMA has no full-f32 product.
//
// The header is included by one .cu file per shared library; everything
// lives in an anonymous namespace, so each library keeps its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
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
static_assert(ROWS_PER_WARP == 16, "one WMMA row tile per warp");

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
template <typename T, int D>
__device__ __forceinline__ void score_tile(const T* a_s, const T* b_s, float* s_s, int warp,
                                           int lane) {
  if constexpr (kIsBf16<T>) {
    using namespace nvcuda;
    for (int ct = 0; ct < TILE / 16; ++ct) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, a_s + warp * 16 * D + kk, D);
        wmma::load_matrix_sync(b, b_s + ct * 16 * D + kk, D);   // b^T as col-major
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(s_s + warp * 16 * TILE + ct * 16, c, TILE, wmma::mem_row_major);
    }
  } else {
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      for (int c = lane; c < TILE; c += 32) {
        float acc = 0.0f;
        for (int dd = 0; dd < D; ++dd) {
          const int d = (dd + lane) & (D - 1);   // rotate: no bank conflicts on b_s
          acc += to_f32(a_s[r * D + d]) * to_f32(b_s[c * D + d]);
        }
        s_s[r * TILE + c] = acc;
      }
    }
  }
}

// acc_s[rows of this warp] += a_s[rows of this warp] . b_s, f32 accumulate.
// a_s is (TILE, TILE) row-major (a probability or dS tile already cast to
// T), b_s a (TILE, D) row-major tile, acc_s (TILE, D) f32.
template <typename T, int D>
__device__ __forceinline__ void mma_acc_tile(const T* a_s, const T* b_s, float* acc_s, int warp,
                                             int lane) {
  const int r0 = warp * ROWS_PER_WARP;
  if constexpr (kIsBf16<T>) {
    using namespace nvcuda;
    for (int dt = 0; dt < D / 16; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, acc_s + r0 * D + dt * 16, D, wmma::mem_row_major);
      for (int jj = 0; jj < TILE; jj += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, a_s + r0 * TILE + jj, TILE);
        wmma::load_matrix_sync(b, b_s + jj * D + dt * 16, D);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(acc_s + r0 * D + dt * 16, c, D, wmma::mem_row_major);
    }
  } else {
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = r0 + rr;
      for (int d = lane; d < D; d += 32) {
        float acc = 0.0f;
        for (int j = 0; j < TILE; ++j) acc += to_f32(a_s[r * TILE + j]) * to_f32(b_s[j * D + d]);
        acc_s[r * D + d] += acc;
      }
    }
  }
}

// The dynamic shared-memory opt-in of `kernel`, made once per device, not
// per launch: it is a host call on the launch path and no stream
// operation, so a launch captured into a CUDA graph must not make it.
// `mu` and `done` belong to the one kernel instantiation.
template <typename Kernel>
cudaError_t smem_opt_in_once(Kernel kernel, int bytes, std::mutex& mu, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace
