// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `_fwd_kernel` of bigdl_tpu/ops/flash_attention.py
// (launched by `_flash_fwd`).  It computes exactly what that kernel computes:
//   * scores q.k in f32 (bf16 products, f32 accumulation) times sm_scale;
//   * the causal mask top-left aligned: q_pos >= k_pos, both counted from 0;
//   * an online softmax over k tiles with f32 running (m, l, acc);
//   * P cast to v's dtype before the P.V product;
//   * O = acc / max(l, 1e-30) in q's dtype, and the row log-sum-exp in f32;
//     a fully masked row gives O = 0 and LSE = 1e30.
//
// Design.  One thread block (4 warps) per (batch*head, tile of 64 query
// rows); a loop over 64-row k/v tiles takes the place of the TPU's
// sequential grid axis, and stops at the causal diagonal.  The q tile, the
// current k/v tiles, the score and probability tiles and the f32
// accumulator live in shared memory; each warp owns 16 query rows end to
// end, so only the k/v tile loads need a block-wide barrier.  bf16 products
// run on the tensor cores through WMMA (16x16x16, f32 accumulate); f32
// inputs use plain FMA, since WMMA has no full-f32 product.  Any T and S
// are taken: the ragged edge is zero-filled on load and masked to -inf.
// The tile loads, products and warp reductions live in tile_common.cuh,
// shared with the backward kernels of flash_bwd.cu.
//
// What bounds it on an H100.  At the served prefill shape (B 4, H 8,
// T 512, D 128, bf16, causal) the kernel must move q, k, v and o, 16.8 MB,
// which is 5.0 us at 3.35 TB/s, against 2.15 GFLOP of products, 2.2 us at
// 989 TFLOP/s: it is memory-bound.  This simple design re-reads k/v per
// query tile and does not overlap loads with compute (no TMA, no wgmma,
// no pipelining); closing the gap to the bound is later work.

#include "tile_common.cuh"

namespace {

constexpr int BQ = TILE;   // query rows per block
constexpr int BK = TILE;   // key rows per tile

template <typename T, int D>
constexpr size_t smem_bytes() {
  return sizeof(T) * (BQ * D + 2 * BK * D + BQ * BK)        // q, k, v, p
         + sizeof(float) * (BQ * BK + BQ * D + 3 * BQ);    // s, acc, m, l, alpha
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int T_len, int S_len,
                 float sm_scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + BQ * D;
  T* v_s = k_s + BK * D;
  T* p_s = v_s + BK * D;
  float* s_s = reinterpret_cast<float*>(p_s + BQ * BK);
  float* acc_s = s_s + BQ * BK;
  float* m_s = acc_s + BQ * D;
  float* l_s = m_s + BQ;
  float* alpha_s = l_s + BQ;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  q += (size_t)bh * T_len * D;
  k += (size_t)bh * S_len * D;
  v += (size_t)bh * S_len * D;
  o += (size_t)bh * T_len * D;
  lse += (size_t)bh * T_len;

  load_tile<T, D>(q_s, q, q0, T_len, BQ);
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) acc_s[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.0f;
  }
  __syncthreads();

  // key tiles strictly above the causal diagonal contribute nothing
  const int k_end = causal ? min(S_len, q0 + BQ) : S_len;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    load_tile<T, D>(k_s, k, k0, S_len, BK);
    load_tile<T, D>(v_s, v, k0, S_len, BK);
    __syncthreads();

    score_tile<T, D>(q_s, k_s, s_s, warp, lane);
    __syncwarp();

    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      const int q_pos = q0 + r;
      float s0 = s_s[r * BK + lane] * sm_scale;
      float s1 = s_s[r * BK + lane + 32] * sm_scale;
      const int k_pos0 = k0 + lane, k_pos1 = k0 + lane + 32;
      if (k_pos0 >= S_len || (causal && k_pos0 > q_pos)) s0 = -INFINITY;
      if (k_pos1 >= S_len || (causal && k_pos1 > q_pos)) s1 = -INFINITY;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      // guard fully masked rows: exp(-inf - -inf) would be nan
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      const float p0 = expf(s0 - m_safe);
      const float p1 = expf(s1 - m_safe);
      const float scale = m_old == -INFINITY ? 0.0f : expf(m_old - m_safe);
      const float psum = warp_sum(p0 + p1);
      p_s[r * BK + lane] = from_f32<T>(p0);
      p_s[r * BK + lane + 32] = from_f32<T>(p1);
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * scale + psum;
        alpha_s[r] = scale;
      }
    }
    __syncwarp();

    // acc = acc * alpha + P.V over this warp's rows
    for (int i = lane; i < ROWS_PER_WARP * D; i += 32)
      acc_s[warp * ROWS_PER_WARP * D + i] *= alpha_s[warp * ROWS_PER_WARP + i / D];
    __syncwarp();
    mma_acc_tile<T, D>(p_s, v_s, acc_s, warp, lane);
    __syncthreads();   // k_s / v_s are overwritten by the next tile
  }

  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    if (q0 + r >= T_len) break;
    const float l = l_s[r];
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    for (int d = lane; d < D; d += 32)
      o[(size_t)(q0 + r) * D + d] = from_f32<T>(acc_s[r * D + d] * inv);
    if (lane == 0) lse[q0 + r] = l > 0.0f ? m_s[r] + logf(fmaxf(l, 1e-30f)) : BIG_LSE;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                   int T_len, int S_len, float sm_scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  static_assert(smem <= kMaxSmemBytes, "flash_fwd tile does not fit in shared memory");
  auto kernel = flash_fwd_kernel<T, D>;
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  cudaError_t err = smem_opt_in_once(kernel, (int)smem, mu, attr_set);
  if (err != cudaSuccess) return err;
  dim3 grid((T_len + BQ - 1) / BQ, BH);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), T_len, S_len, sm_scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o, void* lse,
                       int BH, int T_len, int S_len, float sm_scale, int causal,
                       cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, BH, T_len, S_len, sm_scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, BH, T_len, S_len, sm_scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, BH, T_len, S_len, sm_scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, BH, T_len, S_len, sm_scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (BH, T, D), k/v (BH, S, D), o (BH, T, D) in q's dtype, lse (BH, T) f32;
// all contiguous and 16-byte aligned.  dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int bigdl_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int BH, int T_len, int S_len, int D, int dtype, float sm_scale,
                               int causal, void* stream) {
  if (BH <= 0 || T_len <= 0 || S_len <= 0 || BH > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(D, q, k, v, o, lse, BH, T_len, S_len, sm_scale,
                                          causal, s);
  if (dtype == 0)
    return (int)dispatch_d<float>(D, q, k, v, o, lse, BH, T_len, S_len, sm_scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
