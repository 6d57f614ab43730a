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
// bf16 design: the Hopper body of attn_fwd_hopper.cuh (on
// hopper_common.cuh), which block_sparse.cu's K6 shares, over the dense
// sweep below.  One block of 384 threads per (batch*head, 128 query rows):
// two consumer warpgroups of 64 rows each, whose S, P and O stay in
// registers, and one producer warpgroup that loads the q tile once and K
// and V tiles into an mbarrier ring by TMA; S = Q.K^T and O += P.V on
// wgmma, P as the register A operand.  Key tiles are 64 rows at D 128 and
// above (a warpgroup above the diagonal then skips the diagonal tile's
// second half: measured on the causal main path, PERF.md; 4 stages at
// D 128, 3 at D 192, 2 at D 256) and 128 rows in 3 stages below.  Blocks
// start with the heaviest causal q tiles, so the last wave is short.  q, k
// and v are read at their own strides (the head-strided view of an
// attention layer in place); o is contiguous.
//
// Head dims 192 and 256 are the bf16 route of head dims 129-256 (the
// wrapper zero-pads D to the next of them).  There the bound moves: at
// B 2, H 8, T 1024, D 256, causal, the two products are 8.6 GFLOP, 8.7 us
// at 989 TFLOP/s, against 33.6 MB, 10.0 us at 3.35 TB/s.
//
// f32 (flash_fwd_kernel) keeps the FMA design of tile_common.cuh: one
// 4-warp block per 64 query rows, tiles and accumulator in shared memory.
// wgmma has no full-f32 product, and no bf16 main path runs it: it serves
// the f32 comparisons of training and serving.  K6 (block_sparse.cu) runs
// the same f32 tile loop over its 64-row tile lists, so on an all-ones mask
// K6 and K1 give the same bits in f32, as they do in bf16 through the
// shared Hopper body.

#include "attn_fwd_hopper.cuh"

namespace {

// ---- bf16: the Hopper body of attn_fwd_hopper.cuh over the dense sweep ------

// The key tiles of BK rows of each 128 query rows from 0 up to the causal
// diagonal; a consumer warpgroup skips a tile wholly above its own
// diagonal.  Blocks start with the heaviest causal tiles, the high q blocks.
template <int BK>
struct DenseSweep {
  static constexpr bool kList = false;
  int causal;

  __device__ int fwd_block() const { return gridDim.y - 1 - blockIdx.y; }
  __device__ int fwd_count(int b, int S_len) const {
    // key tiles strictly above the causal diagonal contribute nothing
    const int k_end = causal ? min(S_len, (b + 1) * kBlockRows) : S_len;
    return (k_end + BK - 1) / BK;
  }
  __device__ Step fwd_step(int b, int it) const {
    uint32_t flags = 0;
    for (int w = 0; w < 2; ++w)
      if (!(causal && it * BK > b * kBlockRows + 64 * w + 63)) flags |= kVisit << w;
    return Step{it, flags};
  }
};

// key rows per tile at head dim D (see the note at the top)
template <int D>
constexpr int kDenseKeyRows = D >= 128 ? 64 : 128;

template <int D>
cudaError_t launch_bf16(const FwdArgs& a) {
  return launch_fwd_wgmma<D, kDenseKeyRows<D>>(a, DenseSweep<kDenseKeyRows<D>>{a.causal});
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

    score_tile<D>(q_s, k_s, s_s, warp, lane);
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
    mma_acc_tile<D>(p_s, v_s, acc_s, warp, lane);
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

cudaError_t dispatch_bf16(int D, const FwdArgs& a) {
  switch (D) {
    case 16: return launch_bf16<16>(a);
    case 32: return launch_bf16<32>(a);
    case 64: return launch_bf16<64>(a);
    case 128: return launch_bf16<128>(a);
    case 192: return launch_bf16<192>(a);
    case 256: return launch_bf16<256>(a);
    default: return cudaErrorInvalidValue;
  }
}

// the f32 tile loop reads contiguous heads: from head h0 on
cudaError_t dispatch_f32(int D, const FwdArgs& a) {
  if (!a.sq.dense(a.H, a.T_len, D) || !a.sk.dense(a.H, a.S_len, D) ||
      !a.sv.dense(a.H, a.S_len, D))
    return cudaErrorInvalidValue;
  const size_t qo = (size_t)a.h0 * a.T_len, kv = (size_t)a.h0 * a.S_len * D;
  const void* q = static_cast<const float*>(a.q) + qo * D;
  const void* k = static_cast<const float*>(a.k) + kv;
  const void* v = static_cast<const float*>(a.v) + kv;
  void* o = static_cast<float*>(a.o) + qo * D;
  void* lse = static_cast<float*>(a.lse) + qo;
  const int BH = a.BH, T_len = a.T_len, S_len = a.S_len, causal = a.causal;
  const float sm_scale = a.sm_scale;
  const cudaStream_t stream = a.stream;
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

// Heads h0 .. h0 + BH - 1 of q (., H, T, D) and k/v (., H, S, D) in one
// dtype (0 = float32, 1 = bfloat16), each at its element strides (strides:
// batch, head and row of q, then k, then v; the last dim unit-stride); in
// bf16 every stride a multiple of 8 and each base 16-byte aligned (TMA), in
// f32 contiguous.  o (., T, D) in q's dtype and lse (., T) f32 contiguous.
// Every pointer is the tensor's start, not its head h0's.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int bigdl_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               const long long* strides, int H, int h0, int BH, int T_len,
                               int S_len, int D, int dtype, float sm_scale, int causal,
                               void* stream) {
  if (BH <= 0 || T_len <= 0 || S_len <= 0 || BH > 65535 || H <= 0 || h0 < 0)
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{q, k, v, o, lse, head_strides(strides, 0), head_strides(strides, 1),
                  head_strides(strides, 2), H, h0, BH, T_len, S_len, sm_scale, causal,
                  static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return (int)dispatch_bf16(D, a);
  if (dtype == 0) return (int)dispatch_f32(D, a);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory per block of the kernel that bigdl_flash_fwd
// launches for head dim D and dtype (as above); 0 for what it does not take.
extern "C" int bigdl_flash_fwd_smem_bytes(int D, int dtype) {
  if (dtype == 1) {
    switch (D) {
      case 16: return (int)FwdCfg<16, kDenseKeyRows<16>>::SMEM;
      case 32: return (int)FwdCfg<32, kDenseKeyRows<32>>::SMEM;
      case 64: return (int)FwdCfg<64, kDenseKeyRows<64>>::SMEM;
      case 128: return (int)FwdCfg<128, kDenseKeyRows<128>>::SMEM;
      case 192: return (int)FwdCfg<192, kDenseKeyRows<192>>::SMEM;
      case 256: return (int)FwdCfg<256, kDenseKeyRows<256>>::SMEM;
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
