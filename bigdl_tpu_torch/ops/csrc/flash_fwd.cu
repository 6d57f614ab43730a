// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `_fwd_kernel` of bigdl_tpu/ops/flash_attention.py
// (launched by `_flash_fwd`).  It computes exactly what that kernel computes:
//   * scores q.k in f32 (bf16 products, f32 accumulation) times sm_scale;
//   * the causal mask top-left aligned: q_pos >= k_pos, both counted from 0;
//   * an online softmax over k tiles with f32 running (m, l, acc), l summed
//     from the f32 probabilities;
//   * P cast to v's dtype before the P.V product;
//   * O = acc / max(l, 1e-30) in q's dtype, and the row log-sum-exp in f32;
//     a fully masked row gives O = 0 and LSE = 1e30.
//
// What bounds it on an H100.  At the training shape (B 16, H 8, T 1024,
// D 128, bf16, causal) the kernel must move q, k, v and o, 134 MB, which is
// 40 us at 3.35 TB/s, against 34 GFLOP of products, 35 us at 989 TFLOP/s:
// the two bounds sit together, so loads must overlap the products.
//
// bf16 design (flash_fwd_wgmma_kernel, on hopper_common.cuh).  One block of
// 384 threads per (batch*head, 128 query rows): two consumer warpgroups of
// 64 rows each and one producer warpgroup, which hands most of its
// registers to the consumers (setmaxnreg: 40 against 232 each, so the f32 S
// and O accumulators and P of a thread stay in registers).  One producer
// thread issues every load by TMA through 3-D tensor maps (D, T or S, B*H),
// so a tile never reads past its own head and the ragged edge arrives as
// zeros: the q tile once, then K and V tiles of 64 key rows into a ring of
// 4 stages (D 128; 128 rows and 3 stages below), each guarded by a full and
// an empty mbarrier.  A consumer warpgroup computes S = Q.K^T with wgmma
// (both operands K-major in shared memory, 128-byte swizzle), runs the
// online softmax on the accumulator in registers (a row lives in one quad
// of threads: two shuffles reduce it), masks only a diagonal or ragged
// tile, rescales its O accumulator in registers, packs P to bf16 in
// registers and adds P.V with wgmma taking P as its register A operand and
// the V tile as a transposed (MN-major) B.  O never leaves registers until
// the epilogue, which scales by 1/l, rounds to bf16, stages the rows in the
// warpgroup's own part of the q tile and writes them with 16-byte
// stores.  Blocks start with the heaviest causal q tiles, so the last wave
// is short.
//
// f32 (flash_fwd_kernel) keeps the FMA design of tile_common.cuh: one
// 4-warp block per 64 query rows, tiles and accumulator in shared memory.
// wgmma has no full-f32 product, and no bf16 main path runs it: it serves
// the f32 comparisons of training and serving.  K6 (block_sparse.cu) runs
// the same f32 tile loop over its tile lists.

#include "tile_common.cuh"
#include "hopper_common.cuh"

namespace {

// ---- bf16: TMA, mbarriers and wgmma -----------------------------------------

constexpr int kBQ = 128;                   // query rows per block
constexpr int kConsumers = 256;            // two warpgroups of 64 rows
constexpr int kFwdThreads = kConsumers + 128;  // and one producer warpgroup
// registers per thread after the hand-over (the launch gives 168 to each
// of the 384): 3 warps per SM quarter, 40 + 2 * 232 <= 512
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct FwdCfg {
  static constexpr int PW = D < 64 ? D : 64;   // panel width, columns
  static constexpr int NP = D / PW;            // panels per row
  static constexpr int RB = PW * 2;            // bytes per panel row = swizzle span
  // key rows per tile, stages of the K/V ring: at D 128 a 64-key tile lets
  // the warpgroup above the diagonal skip the diagonal tile's second half
  // (measured on the causal main path: PERF.md)
  static constexpr int BK = D == 128 ? 64 : 128;
  static constexpr int STAGES = D == 128 ? 4 : 3;
  static constexpr int Q_BYTES = kBQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int PANEL_Q = kBQ * RB;
  static constexpr int PANEL_KV = BK * RB;
  static constexpr size_t SMEM =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + sizeof(uint64_t) * (1 + 2 * STAGES);
};

// A consumer warpgroup of flash_fwd_wgmma_kernel: rows q0w .. q0w + 63 of
// the block's q tile; this thread holds rows row0 and row0 + 8 of each
// accumulator (hopper_common.cuh).
template <int D>
__device__ __forceinline__ void consume(unsigned char* q_s, const unsigned char* k_s,
                                        const unsigned char* v_s, uint64_t* q_full,
                                        uint64_t* full, uint64_t* empty,
                                        __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                                        int bh, int q0, int n_kt, int T_len, int S_len,
                                        float scale_log2, int causal) {
  using C = FwdCfg<D>;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int q0w = q0 + 64 * wg;
  const int r_wg = 16 * warp + lane / 4;    // row within the warpgroup's 64
  const int row0 = q0w + r_wg;
  unsigned char* q_wg = q_s + 64 * wg * C::RB;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};   // this thread's share of l; the quad sums at the end

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int s = it % C::STAGES;
    const int k0 = it * C::BK;
    mbar_wait(&full[s], (it / C::STAGES) & 1);
    // a tile wholly above this warpgroup's causal diagonal is only released
    if (!(causal && k0 > q0w + 63)) {
      float sc[C::BK / 2];
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < C::NP; ++p)
#pragma unroll
        for (int j = 0; j < C::PW / 16; ++j)
          wgmma_ss<C::BK, 0>(sc, smem_desc<C::RB>(q_wg + p * C::PANEL_Q + 32 * j),
                             smem_desc<C::RB>(k_s + (s * C::NP + p) * C::PANEL_KV + 32 * j),
                             p + j > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i) fence_regs(sc[i]);

#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i) sc[i] *= scale_log2;
      if (k0 + C::BK > S_len || (causal && k0 + C::BK - 1 > q0w)) {
#pragma unroll
        for (int i = 0; i < C::BK / 2; ++i) {
          const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int row = row0 + 8 * ((i >> 1) & 1);
          if (col >= S_len || (causal && col > row)) sc[i] = -INFINITY;
        }
      }
      float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i) m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], sc[i]);
      float m_safe[2], alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
        m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
        // guard fully masked rows: exp(-inf - -inf) would be nan
        m_safe[h] = m_new[h] == -INFINITY ? 0.0f : m_new[h];
        alpha[h] = m_run[h] == -INFINITY ? 0.0f : exp2f(m_run[h] - m_safe[h]);
        m_run[h] = m_new[h];
        l_run[h] *= alpha[h];
      }
#pragma unroll
      for (int i = 0; i < C::BK / 2; ++i) {
        sc[i] = exp2f(sc[i] - m_safe[(i >> 1) & 1]);
        l_run[(i >> 1) & 1] += sc[i];
      }
      uint32_t pa[C::BK / 4];   // P in bf16: 16 columns per k16 step, wgmma's A layout
#pragma unroll
      for (int i = 0; i < C::BK / 4; ++i) pa[i] = pack_bf16x2(sc[2 * i], sc[2 * i + 1]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
        for (int p = 0; p < C::NP; ++p)
          wgmma_rs<C::PW, 1>(acc + p * (C::PW / 2), pa + 4 * kk,
                             smem_desc<C::RB>(v_s + (s * C::NP + p) * C::PANEL_KV +
                                              16 * C::RB * kk),
                             1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) fence_regs(acc[i]);
    }
    mbar_arrive(&empty[s]);
  }

  // epilogue: O = acc / l in bf16, staged in this warpgroup's rows of the
  // q tile (its own products are done), then written 16 bytes a thread
  constexpr int SWZ = C::RB / 16 - 1;   // 16-byte chunks of a panel row, xor'd by row
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    inv[h] = 1.0f / fmaxf(l_run[h], 1e-30f);
    const int row = row0 + 8 * h;
    if (t == 0 && row < T_len)
      lse[(size_t)bh * T_len + row] =
          l_run[h] > 0.0f ? (m_run[h] + log2f(fmaxf(l_run[h], 1e-30f))) * kLn2 : BIG_LSE;
  }
#pragma unroll
  for (int p = 0; p < C::NP; ++p)
#pragma unroll
    for (int j = 0; j < C::PW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_wg + 8 * h;
        const float* a = acc + p * (C::PW / 2) + 4 * j + 2 * h;
        *reinterpret_cast<uint32_t*>(q_wg + p * C::PANEL_Q + r * C::RB + 16 * (j ^ (r & SWZ)) +
                                     4 * t) = pack_bf16x2(a[0] * inv[h], a[1] * inv[h]);
      }
  named_barrier_sync(1 + wg, 128);
  for (int i = threadIdx.x % 128; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8);
    const int cc = i % (D / 8);
    const int p = cc / (C::PW / 8), j = cc % (C::PW / 8);
    const unsigned char* src = q_wg + p * C::PANEL_Q + r * C::RB + 16 * (j ^ (r & SWZ));
    if (q0w + r < T_len)
      *reinterpret_cast<uint4*>(o + ((size_t)bh * T_len + q0w + r) * D + 8 * cc) =
          *reinterpret_cast<const uint4*>(src);
  }
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int T_len, int S_len, float scale_log2,
                       int causal) {
  using C = FwdCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  // TMA's swizzle and the wgmma descriptors assume 1024-byte-aligned panels
  unsigned char* q_s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* k_s = q_s + C::Q_BYTES;                // [stage][panel][BK rows]
  unsigned char* v_s = k_s + C::STAGES * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + C::STAGES * C::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + C::STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // heaviest causal tiles first
  // key tiles strictly above the causal diagonal contribute nothing
  const int k_end = causal ? min(S_len, q0 + kBQ) : S_len;
  const int n_kt = (k_end + C::BK - 1) / C::BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // the producer warpgroup: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      for (int p = 0; p < C::NP; ++p)
        tma_load_3d(q_s + p * C::PANEL_Q, &tm_q, q_full, p * C::PW, q0, bh);
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % C::STAGES;
        mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);   // the first round passes
        mbar_arrive_expect_tx(&full[s], 2 * C::KV_BYTES);
        for (int p = 0; p < C::NP; ++p) {
          const int off = (s * C::NP + p) * C::PANEL_KV;
          tma_load_3d(k_s + off, &tm_k, &full[s], p * C::PW, it * C::BK, bh);
          tma_load_3d(v_s + off, &tm_v, &full[s], p * C::PW, it * C::BK, bh);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<D>(q_s, k_s, v_s, q_full, full, empty, o, lse, bh, q0, n_kt, T_len, S_len, scale_log2,
               causal);
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                        int T_len, int S_len, float sm_scale, int causal, cudaStream_t stream) {
  using C = FwdCfg<D>;
  static_assert(C::SMEM <= kMaxSmemBytes, "flash_fwd_wgmma tiles do not fit in shared memory");
  const int n_qt = (T_len + kBQ - 1) / kBQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  // encoded per launch and passed by value: a CUDA graph captures them
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = encode_bf16_3d(&tm_q, q, D, T_len, BH, C::PW, kBQ);
  if (err == cudaSuccess) err = encode_bf16_3d(&tm_k, k, D, S_len, BH, C::PW, C::BK);
  if (err == cudaSuccess) err = encode_bf16_3d(&tm_v, v, D, S_len, BH, C::PW, C::BK);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_wgmma_kernel<D>;
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  err = smem_opt_in_once(kernel, (int)C::SMEM, mu, attr_set);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(BH, n_qt), kFwdThreads, C::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), T_len, S_len,
      sm_scale * kLog2e, causal);
  return cudaGetLastError();
}

// ---- f32: the FMA tile loop of tile_common.cuh -------------------------------

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

cudaError_t dispatch_bf16(int D, const void* q, const void* k, const void* v, void* o,
                          void* lse, int BH, int T_len, int S_len, float sm_scale, int causal,
                          cudaStream_t stream) {
  switch (D) {
    case 16: return launch_bf16<16>(q, k, v, o, lse, BH, T_len, S_len, sm_scale, causal, stream);
    case 32: return launch_bf16<32>(q, k, v, o, lse, BH, T_len, S_len, sm_scale, causal, stream);
    case 64: return launch_bf16<64>(q, k, v, o, lse, BH, T_len, S_len, sm_scale, causal, stream);
    case 128: return launch_bf16<128>(q, k, v, o, lse, BH, T_len, S_len, sm_scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_f32(int D, const void* q, const void* k, const void* v, void* o,
                         void* lse, int BH, int T_len, int S_len, float sm_scale, int causal,
                         cudaStream_t stream) {
  switch (D) {
    case 16: return launch<float, 16>(q, k, v, o, lse, BH, T_len, S_len, sm_scale, causal, stream);
    case 32: return launch<float, 32>(q, k, v, o, lse, BH, T_len, S_len, sm_scale, causal, stream);
    case 64: return launch<float, 64>(q, k, v, o, lse, BH, T_len, S_len, sm_scale, causal, stream);
    case 128:
      return launch<float, 128>(q, k, v, o, lse, BH, T_len, S_len, sm_scale, causal, stream);
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
    return (int)dispatch_bf16(D, q, k, v, o, lse, BH, T_len, S_len, sm_scale, causal, s);
  if (dtype == 0)
    return (int)dispatch_f32(D, q, k, v, o, lse, BH, T_len, S_len, sm_scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory per block of the kernel that bigdl_flash_fwd
// launches for head dim D and dtype (as above); 0 for what it does not take.
extern "C" int bigdl_flash_fwd_smem_bytes(int D, int dtype) {
  if (dtype == 1) {
    switch (D) {
      case 16: return (int)FwdCfg<16>::SMEM;
      case 32: return (int)FwdCfg<32>::SMEM;
      case 64: return (int)FwdCfg<64>::SMEM;
      case 128: return (int)FwdCfg<128>::SMEM;
    }
  } else if (dtype == 0) {
    switch (D) {
      case 16: return (int)smem_bytes<float, 16>();
      case 32: return (int)smem_bytes<float, 32>();
      case 64: return (int)smem_bytes<float, 64>();
      case 128: return (int)smem_bytes<float, 128>();
    }
  }
  return 0;
}
