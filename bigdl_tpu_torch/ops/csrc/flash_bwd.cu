// Flash-attention backward for Hopper (sm_90a), bound to Python with ctypes:
// K2 (dK, dV) and K3 (dQ), the FlashAttention-2 schedule.
//
// Replaces the TPU kernels `_dkv_kernel` and `_dq_kernel` of
// bigdl_tpu/ops/flash_attention.py (launched by `_flash_bwd`).  Both
// recompute the probability tile from (q, k, LSE) and compute exactly what
// those kernels compute:
//   * scores in f32 (bf16 products, f32 accumulation) times sm_scale, the
//     causal mask top-left aligned (q_pos >= k_pos), P = exp(S - LSE);
//   * dP = dO . V^T in f32 and dS = P * (dP - delta), with delta =
//     rowsum(dO * O) in f32 computed by the caller, as the JAX package
//     computes it in XLA outside Pallas;
//   * K2: P cast to v's dtype before dV += P^T . dO, and dS cast to q's
//     dtype before dK += dS^T . Q;
//   * K3: dS cast to k's dtype before dQ += dS . K;
//   * f32 accumulators; dK and dQ times sm_scale; outputs in the inputs'
//     dtype.  Rows past T or S and masked pairs get P = 0; a fully masked
//     row carries LSE = 1e30, so its P and every gradient from it are 0.
// No atomics: each output row has one owner block, so two launches on the
// same inputs give the same bits.
//
// What bounds it on an H100.  At the training shape (B 16, H 8, T = S =
// 1024, D 128, bf16, causal) each T x S x D product under the causal mask
// is 17.2 GFLOP.  K2 makes four (S^T, dP^T, dV, dK): 68.8 GFLOP, 0.070 ms
// at 989 TFLOP/s, against 201 MB of q, k, v, dO, dK, dV, 0.060 ms at
// 3.35 TB/s.  K3 makes three: 51.6 GFLOP, 0.052 ms, against 168 MB,
// 0.050 ms.  Both sit at the ridge, so loads must overlap the products
// and the products must run on wgmma.
//
// bf16 design (on hopper_common.cuh, the building blocks of K1).  Each
// kernel runs one block of 384 threads: two consumer warpgroups of 64
// output rows each and one producer warpgroup, which hands most of its
// registers to the consumers (setmaxnreg), so each consumer keeps its
// accumulators in registers for the block's life.  One producer thread
// issues every tile load by TMA through 3-D tensor maps (D, rows, B*H),
// so a tile never reads past its own head and the ragged edge arrives as
// zeros; streamed tiles go through a ring of stages, each guarded by a
// full and an empty mbarrier.  Panels, swizzles and descriptors follow
// hopper_common.cuh.
//   * K2: one block per (batch*head, 128 key rows).  The K and V rows are
//     loaded once.  Tiles of 64 query rows of Q and dO stream through 3
//     stages from the causal diagonal on; the producer's first warp also
//     stages each tile's LSE (times log2 e) and delta, writing LSE = 1e30
//     and delta = 0 for rows past T, as the tile loop did.  A consumer
//     computes S^T = K . Q^T and dP^T = V . dO^T with wgmma (both operands
//     K-major in shared memory; LSE and delta are per query, so per
//     accumulator column here), forms P^T and dS^T in registers, packs
//     them to bf16 in wgmma's A layout and adds dV += P^T . dO and dK +=
//     dS^T . Q with wgmma taking them as its register operand and the dO
//     and Q tiles as a transposed (MN-major) B.  dK and dV stay in
//     registers: 2 * D / 2 f32 a thread.
//   * K3: one block per (batch*head, 128 query rows).  Q and dO are
//     loaded once, each thread reads the LSE and delta of its two rows,
//     and tiles of 64 key rows of K and V stream through 4 stages up to
//     the diagonal.  S = Q . K^T and dP = dO . V^T on wgmma, dS in
//     registers, packed, and dQ += dS . K with K as the MN-major B.
//   * A zero-filled key row scores 0, whose P = exp(-LSE) is not 0: key
//     columns at or past S (K3) and query columns at or past T (K2) are
//     masked explicitly, with the causal mask, on the diagonal and ragged
//     tiles only.  A warpgroup skips a tile that lies wholly above its
//     causal diagonal.
//   * The epilogue scales, rounds to bf16, stages the rows in the
//     warpgroup's own rows of a tile it alone reads (K and V in K2, Q in
//     K3) and writes them with 16-byte stores; rows past S (K2) or T (K3)
//     are not written.  Blocks start with the heaviest causal tiles: low
//     key tiles in K2, high query tiles in K3.
//
// f32 (flash_bwd_dkv_kernel, flash_bwd_dq_kernel) keeps the tile loop of
// tile_common.cuh, unchanged: one 4-warp block per 64 key (K2) or query
// (K3) rows, FMA products through shared memory.  wgmma has no full-f32
// product, and no bf16 main path runs it: it serves the f32 comparisons
// of training, and K7/K8 (block_sparse.cu) run the same f32 loop over
// their tile lists, so on an all-ones mask the two pairs agree bit for bit
// in f32.

#include "tile_common.cuh"
#include "hopper_common.cuh"

namespace {

// ---- bf16: TMA, mbarriers and wgmma -----------------------------------------

constexpr int kConsumers = 256;                // two warpgroups of 64 rows
constexpr int kBwdThreads = kConsumers + 128;  // and one producer warpgroup
constexpr int kBlockRows = 128;                // output rows per block
constexpr int kTileRows = 64;                  // rows of a streamed tile
constexpr float kLog2e = 1.4426950408889634f;
// registers per thread after the hand-over.  The launch gives 168 to each
// of the 384, and the consumers can take only what the producer gives
// back: (168 - P) * 4 warps >= (C - 168) * 8 warps, P + 2 C <= 504 (at
// 512 setmaxnreg.inc waits for ever).  K2's consumers hold dK and dV (D
// f32) beside S^T and dP^T, so its producer keeps the least, 24 + 2 * 240;
// K3's as K1's, 40 + 2 * 232.
constexpr int kDkvProducerRegs = 24;
constexpr int kDkvConsumerRegs = 240;
constexpr int kDqProducerRegs = 40;
constexpr int kDqConsumerRegs = 232;

// K2: the block's K and V rows, then the ring of (Q, dO, LSE, delta) tiles
template <int D>
struct DkvCfg : Panels<D> {
  static constexpr int STAGES = 3;
  static constexpr int KV_BYTES = kBlockRows * D * 2;    // the K or the V rows
  static constexpr int PANEL_KV = kBlockRows * Panels<D>::RB;
  static constexpr int TILE_BYTES = kTileRows * D * 2;   // one Q or dO tile
  static constexpr int PANEL_T = kTileRows * Panels<D>::RB;
  static constexpr size_t SMEM = 1024 + 2 * KV_BYTES + STAGES * (2 * TILE_BYTES)
                                 + STAGES * 2 * kTileRows * sizeof(float)
                                 + sizeof(uint64_t) * (1 + 2 * STAGES);
};

// K3: the block's Q and dO rows, then the ring of (K, V) tiles
template <int D>
struct DqCfg : Panels<D> {
  static constexpr int STAGES = 4;
  static constexpr int Q_BYTES = kBlockRows * D * 2;     // the Q or the dO rows
  static constexpr int PANEL_Q = kBlockRows * Panels<D>::RB;
  static constexpr int TILE_BYTES = kTileRows * D * 2;   // one K or V tile
  static constexpr int PANEL_T = kTileRows * Panels<D>::RB;
  static constexpr size_t SMEM =
      1024 + 2 * Q_BYTES + STAGES * 2 * TILE_BYTES + sizeof(uint64_t) * (1 + 2 * STAGES);
};

// acc (m64 x 64 f32, one consumer warpgroup) = A . B^T over D, both
// operands K-major panels in shared memory: A from 64 rows at `a`, B from
// 64 rows at `b`, panel pitches kPanelA and kPanelB.  Issued, not waited.
template <int D, int kPanelA, int kPanelB>
__device__ __forceinline__ void wgmma_scores(float* acc, const unsigned char* a,
                                             const unsigned char* b) {
  using P = Panels<D>;
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int j = 0; j < P::PW / 16; ++j)
      wgmma_ss<kTileRows, 0>(acc, smem_desc<P::RB>(a + p * kPanelA + 32 * j),
                             smem_desc<P::RB>(b + p * kPanelB + 32 * j), p + j > 0);
}

// acc (m64 x D f32) += A . B with A (64 x 64) packed bf16 in registers and
// B the 64 x D tile at `b` (panel pitch kPanelB) read MN-major.  Issued,
// not waited.
template <int D, int kPanelB>
__device__ __forceinline__ void wgmma_accumulate(float* acc, const uint32_t* a,
                                                 const unsigned char* b) {
  using P = Panels<D>;
#pragma unroll
  for (int kk = 0; kk < kTileRows / 16; ++kk)
#pragma unroll
    for (int p = 0; p < P::NP; ++p)
      wgmma_rs<P::PW, 1>(acc + p * (P::PW / 2), a + 4 * kk,
                         smem_desc<P::RB>(b + p * kPanelB + 16 * P::RB * kk), 1);
}

// A consumer warpgroup of K2: key rows k0w .. k0w + 63; this thread holds
// rows key0 and key0 + 8 of each accumulator (hopper_common.cuh), whose
// columns are the tile's query rows.
template <int D>
__device__ __forceinline__ void dkv_consume(unsigned char* k_s, unsigned char* v_s,
                                            const unsigned char* q_s, const unsigned char* do_s,
                                            const float* lse_s, const float* delta_s,
                                            uint64_t* kv_full, uint64_t* full, uint64_t* empty,
                                            __nv_bfloat16* __restrict__ dk,
                                            __nv_bfloat16* __restrict__ dv, int k0, int q_begin,
                                            int n_qt, int T_len, int S_len, float scale_log2,
                                            float sm_scale, int causal) {
  using C = DkvCfg<D>;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int k0w = k0 + 64 * wg;
  const int key0 = k0w + 16 * warp + lane / 4;
  unsigned char* k_wg = k_s + 64 * wg * C::RB;
  unsigned char* v_wg = v_s + 64 * wg * C::RB;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk_acc[i] = 0.0f;
    dv_acc[i] = 0.0f;
  }

  if (n_qt > 0) mbar_wait(kv_full, 0);
  for (int it = 0; it < n_qt; ++it) {
    const int s = it % C::STAGES;
    const int q0 = q_begin + it * kTileRows;
    mbar_wait(&full[s], (it / C::STAGES) & 1);
    // a tile wholly above this warpgroup's causal diagonal is only released
    if (!(causal && q0 + kTileRows - 1 < k0w)) {
      const unsigned char* q_t = q_s + s * C::TILE_BYTES;
      const unsigned char* do_t = do_s + s * C::TILE_BYTES;
      const float* lse_t = lse_s + s * kTileRows;
      const float* delta_t = delta_s + s * kTileRows;
      float st[kTileRows / 2], dpt[kTileRows / 2];
      wgmma_fence();
      wgmma_scores<D, C::PANEL_KV, C::PANEL_T>(st, k_wg, q_t);   // S^T = K . Q^T
      wgmma_commit();
      wgmma_scores<D, C::PANEL_KV, C::PANEL_T>(dpt, v_wg, do_t);  // dP^T = V . dO^T
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < kTileRows / 2; ++i) fence_regs(st[i]);

      // P^T = exp(S^T * scale - LSE), in base 2; the staged LSE is times
      // log2 e.  Only a diagonal or ragged tile pays for the mask.
      const bool edge = q0 + kTileRows > T_len || (causal && q0 < k0w + 63);
#pragma unroll
      for (int i = 0; i < kTileRows / 2; ++i) {
        const int c = 8 * (i / 4) + 2 * t + (i & 1);   // query row within the tile
        float p = exp2f(fmaf(st[i], scale_log2, -lse_t[c]));
        if (edge) {
          const int q = q0 + c;
          const int key = key0 + 8 * ((i >> 1) & 1);
          if (q >= T_len || (causal && key > q)) p = 0.0f;
        }
        st[i] = p;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kTileRows / 2; ++i) fence_regs(dpt[i]);
      // dS^T = P^T * (dP^T - delta); P^T and dS^T in bf16, wgmma's A layout
      uint32_t pa[kTileRows / 4], da[kTileRows / 4];
#pragma unroll
      for (int i = 0; i < kTileRows / 4; ++i) {
        const int c = 8 * (i / 2) + 2 * t;
        pa[i] = pack_bf16x2(st[2 * i], st[2 * i + 1]);
        da[i] = pack_bf16x2(st[2 * i] * (dpt[2 * i] - delta_t[c]),
                            st[2 * i + 1] * (dpt[2 * i + 1] - delta_t[c + 1]));
      }
      wgmma_fence();
      wgmma_accumulate<D, C::PANEL_T>(dv_acc, pa, do_t);   // dV += P^T . dO
      wgmma_accumulate<D, C::PANEL_T>(dk_acc, da, q_t);    // dK += dS^T . Q
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        fence_regs(dk_acc[i]);
        fence_regs(dv_acc[i]);
      }
    }
    mbar_arrive(&empty[s]);
  }

  // epilogue: dK * sm_scale and dV in bf16, staged in this warpgroup's own
  // K and V rows (its products are done; the other warpgroup never reads
  // them)
  stage_rows<D, C::PANEL_KV>(k_wg, dk_acc, sm_scale);
  stage_rows<D, C::PANEL_KV>(v_wg, dv_acc, 1.0f);
  named_barrier_sync(1 + wg, 128);
  store_rows<D, C::PANEL_KV>(k_wg, dk, k0w, S_len);
  store_rows<D, C::PANEL_KV>(v_wg, dv, k0w, S_len);
}

// K2: grid (B*H, ceil(S / 128)).
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int T_len, int S_len, float scale_log2, float sm_scale, int causal) {
  using C = DkvCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s = align1024(smem_raw);             // [panel][128 rows]
  unsigned char* v_s = k_s + C::KV_BYTES;
  unsigned char* q_s = v_s + C::KV_BYTES;               // [stage][panel][64 rows]
  unsigned char* do_s = q_s + C::STAGES * C::TILE_BYTES;
  float* lse_s = reinterpret_cast<float*>(do_s + C::STAGES * C::TILE_BYTES);  // [stage][64]
  float* delta_s = lse_s + C::STAGES * kTileRows;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(delta_s + C::STAGES * kTileRows);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + C::STAGES;

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockRows;   // heaviest causal tiles first
  // Top-left causal alignment: query rows before k0 attend to no key of
  // this block, so the sweep starts at row k0 (and runs no tile at all
  // when k0 >= T: dK = dV = 0)
  const int q_begin = causal ? k0 : 0;
  const int n_qt = T_len > q_begin ? (T_len - q_begin + kTileRows - 1) / kTileRows : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 32);   // the producer's first warp
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kDkvProducerRegs>();
    // the producer's first warp: lane 0 issues every load, each lane
    // stages two rows' LSE and delta of a tile and arrives on its barrier
    if (threadIdx.x < kConsumers + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0 && n_qt > 0) {
        mbar_arrive_expect_tx(kv_full, 2 * C::KV_BYTES);
        for (int p = 0; p < C::NP; ++p) {
          tma_load_3d(k_s + p * C::PANEL_KV, &tm_k, kv_full, p * C::PW, k0, bh);
          tma_load_3d(v_s + p * C::PANEL_KV, &tm_v, kv_full, p * C::PW, k0, bh);
        }
      }
      const float* lse_h = lse + (size_t)bh * T_len;
      const float* delta_h = delta + (size_t)bh * T_len;
      for (int it = 0; it < n_qt; ++it) {
        const int s = it % C::STAGES;
        const int q0 = q_begin + it * kTileRows;
        mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);   // the first round passes
        for (int c = lane; c < kTileRows; c += 32) {
          const bool in = q0 + c < T_len;
          lse_s[s * kTileRows + c] = (in ? lse_h[q0 + c] : BIG_LSE) * kLog2e;
          delta_s[s * kTileRows + c] = in ? delta_h[q0 + c] : 0.0f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * C::TILE_BYTES);
          for (int p = 0; p < C::NP; ++p) {
            const int off = s * C::TILE_BYTES + p * C::PANEL_T;
            tma_load_3d(q_s + off, &tm_q, &full[s], p * C::PW, q0, bh);
            tma_load_3d(do_s + off, &tm_do, &full[s], p * C::PW, q0, bh);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<kDkvConsumerRegs>();
    dkv_consume<D>(k_s, v_s, q_s, do_s, lse_s, delta_s, kv_full, full, empty,
                   dk + (size_t)bh * S_len * D, dv + (size_t)bh * S_len * D, k0, q_begin, n_qt,
                   T_len, S_len, scale_log2, sm_scale, causal);
  }
}

// A consumer warpgroup of K3: query rows q0w .. q0w + 63; this thread
// holds rows row0 and row0 + 8 of each accumulator.
template <int D>
__device__ __forceinline__ void dq_consume(unsigned char* q_s, const unsigned char* do_s,
                                           const unsigned char* k_s, const unsigned char* v_s,
                                           uint64_t* q_full, uint64_t* full, uint64_t* empty,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           __nv_bfloat16* __restrict__ dq, int q0, int n_kt,
                                           int T_len, int S_len, float scale_log2,
                                           float sm_scale, int causal) {
  using C = DqCfg<D>;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int q0w = q0 + 64 * wg;
  const int row0 = q0w + 16 * warp + lane / 4;
  unsigned char* q_wg = q_s + 64 * wg * C::RB;
  const unsigned char* do_wg = do_s + 64 * wg * C::RB;

  // this thread's two rows: LSE (times log2 e) and delta; rows past T
  // read LSE = 1e30, so their P is 0
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool in = row < T_len;
    lse_r[h] = (in ? lse[row] : BIG_LSE) * kLog2e;
    delta_r[h] = in ? delta[row] : 0.0f;
  }
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.0f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int s = it % C::STAGES;
    const int k0 = it * kTileRows;
    mbar_wait(&full[s], (it / C::STAGES) & 1);
    // a tile wholly above this warpgroup's causal diagonal is only released
    if (!(causal && k0 > q0w + 63)) {
      const unsigned char* k_t = k_s + s * C::TILE_BYTES;
      const unsigned char* v_t = v_s + s * C::TILE_BYTES;
      float sc[kTileRows / 2], dp[kTileRows / 2];
      wgmma_fence();
      wgmma_scores<D, C::PANEL_Q, C::PANEL_T>(sc, q_wg, k_t);    // S = Q . K^T
      wgmma_commit();
      wgmma_scores<D, C::PANEL_Q, C::PANEL_T>(dp, do_wg, v_t);   // dP = dO . V^T
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < kTileRows / 2; ++i) fence_regs(sc[i]);

      // P = exp(S * scale - LSE); a zero-filled key row past S scores 0,
      // so key columns at or past S are masked with the causal mask
      const bool edge = k0 + kTileRows > S_len || (causal && k0 + kTileRows - 1 > q0w);
#pragma unroll
      for (int i = 0; i < kTileRows / 2; ++i) {
        const int h = (i >> 1) & 1;
        float p = exp2f(fmaf(sc[i], scale_log2, -lse_r[h]));
        if (edge) {
          const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          if (col >= S_len || (causal && col > row0 + 8 * h)) p = 0.0f;
        }
        sc[i] = p;
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kTileRows / 2; ++i) fence_regs(dp[i]);
      // dS = P * (dP - delta) in bf16, wgmma's A layout
      uint32_t da[kTileRows / 4];
#pragma unroll
      for (int i = 0; i < kTileRows / 4; ++i) {
        const int h = i & 1;
        da[i] = pack_bf16x2(sc[2 * i] * (dp[2 * i] - delta_r[h]),
                            sc[2 * i + 1] * (dp[2 * i + 1] - delta_r[h]));
      }
      wgmma_fence();
      wgmma_accumulate<D, C::PANEL_T>(dq_acc, da, k_t);   // dQ += dS . K
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) fence_regs(dq_acc[i]);
    }
    mbar_arrive(&empty[s]);
  }

  // epilogue: dQ * sm_scale in bf16, staged in this warpgroup's own Q rows
  stage_rows<D, C::PANEL_Q>(q_wg, dq_acc, sm_scale);
  named_barrier_sync(1 + wg, 128);
  store_rows<D, C::PANEL_Q>(q_wg, dq, q0w, T_len);
}

// K3: grid (B*H, ceil(T / 128)).
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int T_len, int S_len, float scale_log2,
                          float sm_scale, int causal) {
  using C = DqCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align1024(smem_raw);             // [panel][128 rows]
  unsigned char* do_s = q_s + C::Q_BYTES;
  unsigned char* k_s = do_s + C::Q_BYTES;               // [stage][panel][64 rows]
  unsigned char* v_s = k_s + C::STAGES * C::TILE_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + C::STAGES * C::TILE_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + C::STAGES;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockRows;   // heaviest causal tiles first
  // key tiles strictly above the causal diagonal contribute nothing
  const int k_end = causal ? min(S_len, q0 + kBlockRows) : S_len;
  const int n_kt = (k_end + kTileRows - 1) / kTileRows;

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
    setmaxnreg_dec<kDqProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_arrive_expect_tx(q_full, 2 * C::Q_BYTES);
      for (int p = 0; p < C::NP; ++p) {
        tma_load_3d(q_s + p * C::PANEL_Q, &tm_q, q_full, p * C::PW, q0, bh);
        tma_load_3d(do_s + p * C::PANEL_Q, &tm_do, q_full, p * C::PW, q0, bh);
      }
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % C::STAGES;
        mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);   // the first round passes
        mbar_arrive_expect_tx(&full[s], 2 * C::TILE_BYTES);
        for (int p = 0; p < C::NP; ++p) {
          const int off = s * C::TILE_BYTES + p * C::PANEL_T;
          tma_load_3d(k_s + off, &tm_k, &full[s], p * C::PW, it * kTileRows, bh);
          tma_load_3d(v_s + off, &tm_v, &full[s], p * C::PW, it * kTileRows, bh);
        }
      }
    }
  } else {
    setmaxnreg_inc<kDqConsumerRegs>();
    dq_consume<D>(q_s, do_s, k_s, v_s, q_full, full, empty, lse + (size_t)bh * T_len,
                  delta + (size_t)bh * T_len, dq + (size_t)bh * T_len * D, q0, n_kt, T_len,
                  S_len, scale_log2, sm_scale, causal);
  }
}

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dO;
  const float* lse;
  const float* delta;
  void* out0;   // dK (K2) or dQ (K3)
  void* out1;   // dV (K2)
  int BH, T_len, S_len;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

// the four tensor maps of a launch, encoded per launch and passed by
// value (a CUDA graph captures them): q and dO in boxes of q_rows rows,
// k and v in boxes of k_rows rows
template <int D>
cudaError_t encode_maps(const BwdArgs& a, int q_rows, int k_rows, CUtensorMap* tm) {
  constexpr int PW = Panels<D>::PW;
  cudaError_t err = encode_bf16_3d(&tm[0], a.q, D, a.T_len, a.BH, PW, q_rows);
  if (err == cudaSuccess) err = encode_bf16_3d(&tm[1], a.dO, D, a.T_len, a.BH, PW, q_rows);
  if (err == cudaSuccess) err = encode_bf16_3d(&tm[2], a.k, D, a.S_len, a.BH, PW, k_rows);
  if (err == cudaSuccess) err = encode_bf16_3d(&tm[3], a.v, D, a.S_len, a.BH, PW, k_rows);
  return err;
}

template <int D>
cudaError_t launch_dkv_bf16(const BwdArgs& a) {
  using C = DkvCfg<D>;
  static_assert(C::SMEM <= kMaxSmemBytes, "flash_bwd_dkv_wgmma tiles do not fit in shared memory");
  const int n_kb = (a.S_len + kBlockRows - 1) / kBlockRows;
  if (n_kb > 65535) return cudaErrorInvalidValue;
  CUtensorMap tm[4];
  cudaError_t err = encode_maps<D>(a, kTileRows, kBlockRows, tm);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dkv_wgmma_kernel<D>;
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  err = smem_opt_in_once(kernel, (int)C::SMEM, mu, attr_set);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.BH, n_kb), kBwdThreads, C::SMEM, a.stream>>>(
      tm[0], tm[1], tm[2], tm[3], a.lse, a.delta, static_cast<__nv_bfloat16*>(a.out0),
      static_cast<__nv_bfloat16*>(a.out1), a.T_len, a.S_len, a.sm_scale * kLog2e, a.sm_scale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_bf16(const BwdArgs& a) {
  using C = DqCfg<D>;
  static_assert(C::SMEM <= kMaxSmemBytes, "flash_bwd_dq_wgmma tiles do not fit in shared memory");
  const int n_qb = (a.T_len + kBlockRows - 1) / kBlockRows;
  if (n_qb > 65535) return cudaErrorInvalidValue;
  CUtensorMap tm[4];
  cudaError_t err = encode_maps<D>(a, kBlockRows, kTileRows, tm);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_dq_wgmma_kernel<D>;
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  err = smem_opt_in_once(kernel, (int)C::SMEM, mu, attr_set);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.BH, n_qb), kBwdThreads, C::SMEM, a.stream>>>(
      tm[0], tm[1], tm[2], tm[3], a.lse, a.delta, static_cast<__nv_bfloat16*>(a.out0), a.T_len,
      a.S_len, a.sm_scale * kLog2e, a.sm_scale, a.causal);
  return cudaGetLastError();
}

// ---- f32: the FMA tile loop of tile_common.cuh -------------------------------

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * 4 * TILE * D        // k, v, q, dO
         + sizeof(float) * 2 * TILE * TILE   // S^T, dP^T (then P^T, dS^T in place)
         + sizeof(float) * 2 * TILE * D      // dK, dV accumulators
         + sizeof(float) * 2 * TILE;         // lse, delta
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * 4 * TILE * D        // q, dO, k, v
         + sizeof(float) * 2 * TILE * TILE   // S, dP (then dS in place)
         + sizeof(float) * TILE * D          // dQ accumulator
         + sizeof(float) * 2 * TILE;         // lse, delta
}

// One (query, key) pair of a score tile: the masked-or-recomputed P and
// dS = P * (dP - delta), both in f32.
__device__ __forceinline__ void p_and_ds(float s, float dp, float lse, float delta, bool keep,
                                         float sm_scale, float* p, float* ds) {
  *p = keep ? expf(s * sm_scale - lse) : 0.0f;
  *ds = *p * (dp - delta);
}

// K2 in f32: grid (ceil(S / 64), B*H).  Each warp owns 16 key rows of the
// tile; P^T and dS^T overwrite S^T and dP^T in place (each lane rewrites
// only what it read), so D 128 fits in 224.5 KB.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dO,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int T_len, int S_len,
                     float sm_scale, int causal) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + TILE * D;
  T* q_s = v_s + TILE * D;
  T* do_s = q_s + TILE * D;
  float* st_s = do_s + TILE * D;   // S^T: key rows, query columns
  float* dpt_s = st_s + TILE * TILE;                          // dP^T
  float* dk_acc = dpt_s + TILE * TILE;
  float* dv_acc = dk_acc + TILE * D;
  T* pt_s = st_s;      // written over S^T in place
  T* dst_s = dpt_s;    // written over dP^T in place
  float* lse_s = dv_acc + TILE * D;
  float* delta_s = lse_s + TILE;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * TILE;
  q += (size_t)bh * T_len * D;
  dO += (size_t)bh * T_len * D;
  lse += (size_t)bh * T_len;
  delta += (size_t)bh * T_len;
  k += (size_t)bh * S_len * D;
  v += (size_t)bh * S_len * D;
  dk += (size_t)bh * S_len * D;
  dv += (size_t)bh * S_len * D;

  load_tile<T, D>(k_s, k, k0, S_len, TILE);
  load_tile<T, D>(v_s, v, k0, S_len, TILE);
  for (int i = threadIdx.x; i < TILE * D; i += NTHREADS) {
    dk_acc[i] = 0.0f;
    dv_acc[i] = 0.0f;
  }

  // Top-left causal alignment: query rows before k0 attend to no key of
  // this tile, so the sweep starts at the q tile holding row k0 (and runs
  // no tile at all when k0 >= T).
  const int q_begin = causal ? (k0 / TILE) * TILE : 0;
  for (int q0 = q_begin; q0 < T_len; q0 += TILE) {
    __syncthreads();   // k/v/accumulators ready; every warp done with the last q/dO tile
    load_tile<T, D>(q_s, q, q0, T_len, TILE);
    load_tile<T, D>(do_s, dO, q0, T_len, TILE);
    for (int i = threadIdx.x; i < TILE; i += NTHREADS) {
      const bool in = q0 + i < T_len;
      lse_s[i] = in ? lse[q0 + i] : BIG_LSE;
      delta_s[i] = in ? delta[q0 + i] : 0.0f;
    }
    __syncthreads();

    score_tile<T, D>(k_s, q_s, st_s, warp, lane);    // S^T = K . Q^T
    score_tile<T, D>(v_s, do_s, dpt_s, warp, lane);  // dP^T = V . dO^T
    __syncwarp();

    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      const int k_pos = k0 + r;
      for (int c = lane; c < TILE; c += 32) {
        const int q_pos = q0 + c;
        const bool keep = k_pos < S_len && q_pos < T_len && !(causal && k_pos > q_pos);
        float p, ds;
        p_and_ds(st_s[r * TILE + c], dpt_s[r * TILE + c], lse_s[c], delta_s[c], keep,
                 sm_scale, &p, &ds);
        pt_s[r * TILE + c] = p;
        dst_s[r * TILE + c] = ds;
      }
    }
    __syncwarp();

    mma_acc_tile<T, D>(pt_s, do_s, dv_acc, warp, lane);   // dV += P^T . dO
    mma_acc_tile<T, D>(dst_s, q_s, dk_acc, warp, lane);   // dK += dS^T . Q
  }
  __syncthreads();   // the zero-fill is visible when the sweep ran no tile

  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    if (k0 + r >= S_len) break;
    for (int d = lane; d < D; d += 32) {
      dk[(size_t)(k0 + r) * D + d] = dk_acc[r * D + d] * sm_scale;
      dv[(size_t)(k0 + r) * D + d] = dv_acc[r * D + d];
    }
  }
}

// K3 in f32: grid (ceil(T / 64), B*H).
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int T_len, int S_len, float sm_scale, int causal) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + TILE * D;
  T* k_s = do_s + TILE * D;
  T* v_s = k_s + TILE * D;
  float* s_s = v_s + TILE * D;   // S: query rows, key columns
  float* dp_s = s_s + TILE * TILE;                          // dP
  float* dq_acc = dp_s + TILE * TILE;
  T* ds_s = dp_s;   // written over dP in place
  float* lse_s = dq_acc + TILE * D;
  float* delta_s = lse_s + TILE;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * TILE;
  q += (size_t)bh * T_len * D;
  dO += (size_t)bh * T_len * D;
  lse += (size_t)bh * T_len;
  delta += (size_t)bh * T_len;
  k += (size_t)bh * S_len * D;
  v += (size_t)bh * S_len * D;
  dq += (size_t)bh * T_len * D;

  load_tile<T, D>(q_s, q, q0, T_len, TILE);
  load_tile<T, D>(do_s, dO, q0, T_len, TILE);
  for (int i = threadIdx.x; i < TILE; i += NTHREADS) {
    const bool in = q0 + i < T_len;
    lse_s[i] = in ? lse[q0 + i] : BIG_LSE;
    delta_s[i] = in ? delta[q0 + i] : 0.0f;
  }
  for (int i = threadIdx.x; i < TILE * D; i += NTHREADS) dq_acc[i] = 0.0f;

  // key tiles strictly above the causal diagonal contribute nothing
  const int k_end = causal ? min(S_len, q0 + TILE) : S_len;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();   // q/dO/stats ready; every warp done with the last k/v tile
    load_tile<T, D>(k_s, k, k0, S_len, TILE);
    load_tile<T, D>(v_s, v, k0, S_len, TILE);
    __syncthreads();

    score_tile<T, D>(q_s, k_s, s_s, warp, lane);    // S = Q . K^T
    score_tile<T, D>(do_s, v_s, dp_s, warp, lane);  // dP = dO . V^T
    __syncwarp();

    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      const int q_pos = q0 + r;
      const float lse_r = lse_s[r];
      const float delta_r = delta_s[r];
      for (int c = lane; c < TILE; c += 32) {
        const int k_pos = k0 + c;
        const bool keep = k_pos < S_len && q_pos < T_len && !(causal && k_pos > q_pos);
        float p, ds;
        p_and_ds(s_s[r * TILE + c], dp_s[r * TILE + c], lse_r, delta_r, keep, sm_scale, &p,
                 &ds);
        ds_s[r * TILE + c] = ds;
      }
    }
    __syncwarp();

    mma_acc_tile<T, D>(ds_s, k_s, dq_acc, warp, lane);   // dQ += dS . K
  }
  __syncthreads();   // the zero-fill is visible when the sweep ran no tile

  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    if (q0 + r >= T_len) break;
    for (int d = lane; d < D; d += 32) dq[(size_t)(q0 + r) * D + d] = dq_acc[r * D + d] * sm_scale;
  }
}

template <int D>
cudaError_t launch_dkv_f32(const BwdArgs& a) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static_assert(smem <= kMaxSmemBytes, "flash_bwd_dkv tiles do not fit in shared memory");
  auto kernel = flash_bwd_dkv_kernel<D>;
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  cudaError_t err = smem_opt_in_once(kernel, (int)smem, mu, attr_set);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S_len + TILE - 1) / TILE, a.BH);
  kernel<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dO), a.lse, a.delta,
      static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.T_len, a.S_len, a.sm_scale,
      a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_f32(const BwdArgs& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static_assert(smem <= kMaxSmemBytes, "flash_bwd_dq tiles do not fit in shared memory");
  auto kernel = flash_bwd_dq_kernel<D>;
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  cudaError_t err = smem_opt_in_once(kernel, (int)smem, mu, attr_set);
  if (err != cudaSuccess) return err;
  dim3 grid((a.T_len + TILE - 1) / TILE, a.BH);
  kernel<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dO), a.lse, a.delta,
      static_cast<float*>(a.out0), a.T_len, a.S_len, a.sm_scale, a.causal);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16
template <int D>
cudaError_t launch(bool dkv, int dtype, const BwdArgs& a) {
  if (dtype == 1) return dkv ? launch_dkv_bf16<D>(a) : launch_dq_bf16<D>(a);
  if (dtype == 0) return dkv ? launch_dkv_f32<D>(a) : launch_dq_f32<D>(a);
  return cudaErrorInvalidValue;
}

int dispatch(bool dkv, int D, int dtype, const BwdArgs& a) {
  if (a.BH <= 0 || a.T_len <= 0 || a.S_len <= 0 || a.BH > 65535)
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return (int)launch<16>(dkv, dtype, a);
    case 32: return (int)launch<32>(dkv, dtype, a);
    case 64: return (int)launch<64>(dkv, dtype, a);
    case 128: return (int)launch<128>(dkv, dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int D>
int smem_of(bool dkv, int dtype) {
  if (dtype == 1) return (int)(dkv ? DkvCfg<D>::SMEM : DqCfg<D>::SMEM);
  if (dtype == 0) return (int)(dkv ? dkv_smem_bytes<D>() : dq_smem_bytes<D>());
  return 0;
}

}  // namespace

// q, dO (BH, T, D) and k, v (BH, S, D) in one dtype (0 = float32,
// 1 = bfloat16); lse and delta (BH, T) f32; outputs as their inputs.  All
// contiguous and 16-byte aligned.  Each returns the cudaError_t of its
// launch (0 on success).

// K2: dk, dv (BH, S, D).
extern "C" int bigdl_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dO,
                                   const void* lse, const void* delta, void* dk, void* dv,
                                   int BH, int T_len, int S_len, int D, int dtype,
                                   float sm_scale, int causal, void* stream) {
  const BwdArgs a{q, k, v, dO, static_cast<const float*>(lse), static_cast<const float*>(delta),
                  dk, dv, BH, T_len, S_len, sm_scale, causal,
                  static_cast<cudaStream_t>(stream)};
  return dispatch(true, D, dtype, a);
}

// K3: dq (BH, T, D).
extern "C" int bigdl_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                                  const void* lse, const void* delta, void* dq, int BH,
                                  int T_len, int S_len, int D, int dtype, float sm_scale,
                                  int causal, void* stream) {
  const BwdArgs a{q, k, v, dO, static_cast<const float*>(lse), static_cast<const float*>(delta),
                  dq, nullptr, BH, T_len, S_len, sm_scale, causal,
                  static_cast<cudaStream_t>(stream)};
  return dispatch(false, D, dtype, a);
}

// Dynamic shared memory per block of the kernel that bigdl_flash_bwd_dkv
// (dkv = 1) or bigdl_flash_bwd_dq (dkv = 0) launches for head dim D and
// dtype (as above); 0 for what they do not take.
extern "C" int bigdl_flash_bwd_smem_bytes(int dkv, int D, int dtype) {
  switch (D) {
    case 16: return smem_of<16>(dkv != 0, dtype);
    case 32: return smem_of<32>(dkv != 0, dtype);
    case 64: return smem_of<64>(dkv != 0, dtype);
    case 128: return smem_of<128>(dkv != 0, dtype);
    default: return 0;
  }
}
