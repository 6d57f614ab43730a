// The attention forward for Hopper (sm_90a): the kernel that flash_fwd.cu
// runs as K1 and block_sparse.cu as K6, in bf16 and in f32.  Both compute
// the same math; only the sweep differs, so the body is written once here
// and templated on a sweep policy, as attn_bwd_hopper.cuh is for the
// backward.
//
// Replaces the TPU kernels `_fwd_kernel` (bigdl_tpu/ops/flash_attention.py:150)
// and `_bs_fwd_kernel` (bigdl_tpu/ops/block_sparse.py:292).  It computes
// exactly what they compute:
//   * scores q.k in f32 (f32 accumulation) times sm_scale;
//   * the causal mask top-left aligned: q_pos >= k_pos, both counted from 0;
//     in K6 also the block mask;
//   * an online softmax over k tiles with f32 running (m, l, acc), l summed
//     from the f32 probabilities;
//   * P cast to v's dtype before the P.V product (in f32 P is not rounded);
//   * O = acc / max(l, 1e-30) in q's dtype, and the row log-sum-exp in f32;
//     a row that attends nothing gives O = 0 and LSE = 1e30.
//
// What bounds it on an H100.  Two products of 2 * D FLOP per live score
// element against q, k, v and o moved once.  At K1's training shape (B 16,
// H 8, T 1024, D 128, causal, bf16) that is 34 GFLOP, 35 us at 989
// TFLOP/s, against 134 MB, 40 us at 3.35 TB/s: the two bounds sit
// together.  At K6's block-sparse training shape (B 4, H 8, T 4096, D 128,
// sliding window 2 + 1 global at block 512) it is 73.0 GFLOP, 74 us,
// against 135 MB, 40 us: bound by operations.  So loads must overlap the
// products, and the products must run on wgmma with the intermediates in
// registers.  In f32 each f32 product is formed from bf16 products (below):
// twelve bf16 products for the two f32 ones, so the tensor cores give 989
// * 2 / 12 = 164.8 TFLOP/s of f32 work; at B 2, H 8, T 512, D 128,
// causal, 1.08 GFLOP take 6.5 us at that rate against 16.8 MB, 5.0 us:
// bound by operations.
//
// Design.  One block of 384 threads per (batch*head, 128 query rows): two
// consumer warpgroups of 64 rows each and one producer warpgroup, which
// hands most of its registers to the consumers (setmaxnreg: 40 against 232
// each), so the f32 S and O accumulators and P of a thread stay in
// registers.  The producer loads the q rows once by TMA through 4-D tensor
// maps (D, T or S, H, B) over the operands' own strides (hopper_common.cuh,
// HeadStrides: the head-strided view an attention layer makes is read in
// place), so a tile never reads past its own head and the ragged edge
// arrives as zeros, then streams K and V tiles into a ring of stages, each
// guarded by a full and an empty mbarrier.  A consumer
// warpgroup computes S = Q.K^T with wgmma (both operands K-major in shared
// memory, 128-byte swizzle), runs the online softmax on the accumulator in
// registers (a row lives in one quad of threads: two shuffles reduce it),
// masks only a diagonal, ragged or partial tile, rescales its O accumulator
// in registers and adds P.V with wgmma taking P from registers as its A
// operand and the V tile as a transposed (MN-major) B.  O never leaves
// registers until the epilogue.
//   * bf16 (attn_fwd_wgmma_kernel, fwd_consume): P is packed to bf16; the
//     epilogue scales by 1/l, rounds to bf16, stages the rows in the
//     warpgroup's own part of the q tile and writes them with 16-byte
//     stores.
//   * f32 (attn_fwd_split_kernel, fwd_f32_consume; D 16-128): wgmma has no
//     f32 product, so each f32 operand is split into bf16 pieces
//     (hopper_common.cuh: a1 = bf16(a), a2 = bf16(a - a1), a3 = bf16(a - a1
//     - a2)) and each product is a sum of bf16 products with f32
//     accumulation, small terms first: S from six (three pieces of Q and
//     of K), P.V from six (three pieces of P, split in registers, and of
//     V).  O is held to f32 rounding, not only to the 1e-4 limit: the
//     backward's delta = rowsum(dO O) must match its own recomputed P.V,
//     or the gradient of a key bias (zero in exact arithmetic) grows 20x
//     (PERF.md), which two pieces of V, or of P, allow.  The f32 tiles
//     land by TMA in panels of 32 columns and are split in place: each
//     warpgroup splits its own 64 q rows once (the q rows arrive as two
//     64-row boxes); both warpgroups split each K tile, then each V tile,
//     together (named barrier kKvSplit), even one whose products only one
//     of them computes.  K and V have barriers of their own: K is released
//     once S is formed, so the next K lands during the softmax and P.V,
//     and V during the next split of K and S, with one stage at D 128.
//     64-key tiles at every head dim; Q, K and V take 6 bytes an element,
//     so 4 stages up to D 32, 3 at D 64 and one at D 128 (193 KB).  O
//     leaves in f32 straight from the accumulators.
//   * f32 at D 192 and 256 (attn_fwd_split_kernel, fwd_f32_consume WIDE):
//     the same products on a layout of its own, since Q, K and V in three
//     pieces no longer fit (D 256: 384 KB).  The q rows stay in f32 (4
//     bytes an element, 128 KB at D 256) and each consumer warpgroup
//     splits them into wgmma's register A operand 32 columns (one TMA
//     panel, two k16 steps) at a time, for every key tile (wide_scores,
//     hopper_common.cuh, which the f32 dK/dV and dQ share at these D).
//     K and V come as 32-key tiles split in place as above (48 KB each at
//     D 256: one stage, 225 KB in all), so S is 16 registers a thread
//     beside O's 128 and P's three pieces 24; the producer keeps 24
//     registers so that the consumers get 240.  wgmma rounds the sums it
//     accumulates toward zero (PERF.md): S over all of D 256 in one
//     accumulator (96 roundings) shrinks the scores enough that LSE and
//     the backward's recomputed P disagree, and a key bias's
//     gradient (zero in exact arithmetic) reads over 3x the plain f32
//     pipeline's; so each q panel's twelve products go to a fresh partial,
//     added to S in f32 once done (within 2x; tests/test_torch_f32_split.py).
//     At D 192 the panels are unrolled and the next one is split while
//     the last one's products run; at D 256 that spills, so the panels run
//     as a loop, a k16 step at a time (k1_variants.py --wide).  K6's list
//     steps are 64-key tiles: the producer streams each as two 32-key
//     halves (a partial pair's live rows split with it).
//   * above D 256, both dtypes (attn_fwd_chunk_kernel, chunk_consume): the
//     layout above stops fitting: 128 q rows by D no longer stay resident
//     (80 KB in bf16 at D 320, 160 KB in f32), an O accumulator over all
//     of D outgrows the registers (D / 2 a thread), and one wgmma or TMA
//     box spans at most 256 columns.  So D is chunked.  The scores are
//     summed over panels of 64 columns: the producer streams panel p of
//     the block's q rows beside panel p of the key tile through a ring of
//     stages (bf16: 24 KB, 6 stages; f32: 44 KB, 4 stages), so every head
//     dim takes the same shared memory and the panel count is a run-time
//     argument: one instantiation per dtype and sweep serves every D
//     above 256 (a multiple of 64; the wrappers zero-pad to one, exactly:
//     zero q and k columns add 0 to a score, zero v columns only fill
//     columns that are cut off).  O is kept kChunkCols = 256 columns a
//     block (128 registers a thread, as at D 256), the chunks of a head in
//     blocks of their own (grid x = head * chunks + chunk, so they run
//     side by side and read the same q and K panels from L2), and each
//     block forms S anew over all of D: a chunk's own code before its
//     epilogue differs only in V's columns, so every chunk forms the same
//     S, m and l, bit for bit, and chunk 0 writes LSE.  A chunk's columns
//     lie inside D: the last one starts at D - 256 and writes only what
//     its neighbour does not.  The V chunk streams through a ring of its
//     own (bf16: two 32 KB tiles; f32: one 48 KB tile).  bf16 keeps one S
//     accumulator over the panels (64-key tiles), each stage's products
//     chained behind the last's and the stage released once they are
//     done (wgmma_wait<1>).  f32 keeps the products of D 192 and 256:
//     32-key tiles, each K panel and V tile split in place by both
//     warpgroups, q split into wgmma's register operand a k16 step at a
//     time, and each 32-column q panel's twelve products into a fresh
//     partial added to S in f32 (one accumulator over 10 or more panels
//     would shrink the scores until LSE and the backward's recomputed P
//     disagree; tests/test_torch_f32_split.py).
//     In a list sweep's partial pair the producer's first warp stages the
//     live rows of every K panel and of the V chunk, so a dead row (NaN
//     included) never reaches a product.  What bounds it: each chunk's
//     block forms S over all of D, so at D 320 the products are (2 * 320
//     + 2 * 256) / (2 * 320) = 1.8x the minimal work (the second chunk
//     forms 256 columns to write 64), at D 512 1.5x; and every key tile
//     brings the block's q rows again from L2 (twice the K bytes in bf16,
//     four times in f32).  Neither is what holds it back on an H100
//     (k1_variants.py --chunked, PERF.md): keeping q resident where it
//     fits would save 1-6 % of the time and forming S once a row block
//     (the most that handing P to the other chunks' warpgroups could
//     gain) 9-16 %; the kernel runs at 3.5-4.7x its bound in bf16 and
//     5.3-7.9x in f32.
//
// The sweep policy says which 128 query rows a block owns, which key tiles
// it streams, in which order, and which consumer warpgroup computes each:
//   * fwd_block(): the owner block's index b (query rows 128 b ..);
//   * fwd_count(b, S): how many key tiles it streams (0: O = 0, LSE = 1e30);
//   * fwd_step(b, it): the it-th key tile and its flags (hopper_common.cuh:
//     bit w when warpgroup w computes it, bit 2 + w when that pair is
//     covered by the block mask in part).  A warpgroup that does not visit
//     a tile only releases it.
//   * kList: false for flash_fwd.cu's DenseSweep (K1: key tiles up to the
//     causal diagonal, counted by arithmetic, heaviest blocks first; in
//     bf16 64-key tiles at D 128 and above, 128-key tiles in 3 stages below;
//     in f32 64-key tiles); true for block_sparse.cu's ListSweep (K6: the
//     steps of K8's 128-row lists, 64-key tiles at every D).  bf16 64-key
//     tiles run in 4 stages at D up to 128, 3 at D 192 and 2 at D 256 (the
//     q tile grows with D: 192 KB in all at the two wide head dims).  A
//     list step is read from device memory by the producer's first warp,
//     which stages it in shared memory with the tile.  A tile with a
//     partial pair is staged by that warp, not by TMA: it copies the key
//     rows some query of the block attends (live(b, it)) into the swizzled
//     layout TMA would give and writes zeros for the rest
//     (stage_live_rows), so a dead K or V row (NaN included) never reaches
//     a product; keep(q, k) is the block mask tested inside a partial pair.
// On an all-ones causal mask at a 128-multiple block the list is the dense
// sweep of 64-key tiles (bf16 at D 128, f32 at every D), tile for tile, so
// K6 and K1 give the same bits.
//
// Everything lives in an anonymous namespace, as in hopper_common.cuh.
#pragma once

#include "hopper_common.cuh"

namespace {

constexpr int kFwdThreads = kConsumers + 128;  // and one producer warpgroup
// registers per thread after the hand-over (the launch gives 168 to each
// of the 384): P + 2 C <= 504, as attn_bwd_hopper.cuh derives
constexpr int kFwdProducerRegs = 40;
constexpr int kFwdConsumerRegs = 232;
constexpr float kLn2 = 0.6931471805599453f;
// named barrier of the f32 forward: each K and V tile split by both
// consumer warpgroups together, read by both (1 and 2 are each
// warpgroup's own, for its q rows)
constexpr int kKvSplit = 3;

// The block's q rows, then the ring of (K, V) tiles of BK key rows and, for
// a list sweep, each stage's step.  T is the operands' type: in bf16 the q
// rows land as one 128-row tile, and a stage's K and V share one full and
// one empty barrier; in f32 as two 64-row tiles (one a consumer
// warpgroup) in TMA's panels L (Panels<D, 4>, *_LOAD bytes), each split in
// place into three bf16 pieces (split_tile: pieces 1 and 2 where the f32
// bytes lay, piece 3 after them, in panels of the bf16 geometry, PANEL_Q
// and PANEL_KV bytes), so Q, K and V take 6 bytes an element, or at D 192
// and 256 (WIDE) q stays in f32 and only K and V are split; and K and V
// have barriers of their own (KV_BARS), so the next K lands while the
// consumers still read V.
template <int D, int kKeyRows, typename T = __nv_bfloat16>
struct FwdCfg : Panels<D> {
  using L = Panels<D, sizeof(T)>;
  static constexpr bool F32 = !kIsBf16<T>;
  static constexpr bool WIDE = F32 && D > 128;   // q split into registers, not in place
  static constexpr int BK = kKeyRows;
  static constexpr int STAGES = F32 ? (D <= 32 ? 4 : D <= 64 ? 3 : 1)
                                     : BK == 64 ? (D <= 128 ? 4 : D <= 192 ? 3 : 2) : 3;
  static constexpr int Q_ROWS = F32 ? kTileRows : kBlockRows;   // rows of a q tile
  static constexpr int Q_ELEM = F32 ? (WIDE ? 4 : 6) : 2;       // bytes a q element takes
  static constexpr int Q_TILE = Q_ROWS * D * Q_ELEM;
  static constexpr int Q_BYTES = kBlockRows * D * Q_ELEM;
  static constexpr int Q_LOAD = Q_ROWS * D * (int)sizeof(T);   // one q tile's TMA bytes
  static constexpr int KV_BYTES = BK * D * (F32 ? 6 : 2);      // one K or V tile
  static constexpr int KV_LOAD = BK * D * (int)sizeof(T);      // a K or V tile's TMA bytes
  static constexpr int PANEL_Q = Q_ROWS * Panels<D>::RB;
  static constexpr int PANEL_KV = BK * Panels<D>::RB;
  static constexpr int LPANEL_Q = Q_ROWS * L::RB;
  static constexpr int LPANEL_KV = BK * L::RB;
  static constexpr int KV_BARS = F32 ? 2 : 1;   // (full, empty) pairs a stage
  // registers a thread after the hand-over (P + 2 C <= 504): a wide f32
  // consumer holds O (D / 2), S and its partial (16 each) and q's pieces
  // (48 at D 192, 12 at D 256), so its producer keeps only 24, as K2's does
  static constexpr int PRODUCER_REGS = WIDE ? 24 : kFwdProducerRegs;
  static constexpr int CONSUMER_REGS = WIDE ? 240 : kFwdConsumerRegs;
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES +
                                 sizeof(uint64_t) * (1 + 2 * KV_BARS * STAGES) +
                                 STAGES * sizeof(Step);
  static_assert(!F32 || (WIDE ? BK == kWideRows && D <= 256 : BK == kTileRows),
                "f32: 64-key tiles to D 128, 32-key tiles at D 192 and 256");
};

// the key rows of the forward's tiles in T over a list sweep (whose steps
// are 64-row tiles), and in f32 over the dense sweep too: 64, or 32 in f32
// at D 192 and 256
template <int D, typename T>
constexpr int kFwdTileRows = !kIsBf16<T> && D > 128 ? kWideRows : kTileRows;

// One key tile's scores (this thread's BK / 2 of rows row0 and row0 + 8
// of the warpgroup's 64, query rows from q0w) made unnormalised
// probabilities in place: times scale_log2 (base-2 exponentials), masked
// (causal, ragged, partial pair), exp2 against the running max m_run,
// whose old value rescales l_run and, by the factors left in alpha, the
// caller's accumulator.  Only a diagonal, ragged or partial tile pays for
// the masks, each in a loop of its own behind one branch: a test inside
// the exponentials' loop is branched element by element on every tile.
// Element i is query row row0 + 8 ((i >> 1) & 1), key column k0 + 8 (i /
// 4) + 2 t + (i & 1).
template <int BK, class Sweep>
__device__ __forceinline__ void online_softmax(const Sweep& sw, float* sc, float* m_run,
                                               float* l_run, float* alpha, bool part, int k0,
                                               int q0w, int row0, int t, int T_len, int S_len,
                                               float scale_log2, int causal) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] *= scale_log2;
  if (part || k0 + BK > S_len || (causal && k0 + BK - 1 > q0w)) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      const int row = row0 + 8 * ((i >> 1) & 1);
      if (col >= S_len || (causal && col > row)) sc[i] = -INFINITY;
    }
    if constexpr (Sweep::kList) {
      if (part) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int row = row0 + 8 * ((i >> 1) & 1);
          if (col < S_len && (row >= T_len || !sw.keep(row, col))) sc[i] = -INFINITY;
        }
      }
    }
  }
  float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) m_new[(i >> 1) & 1] = fmaxf(m_new[(i >> 1) & 1], sc[i]);
  float m_safe[2];
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
  for (int i = 0; i < BK / 2; ++i) {
    sc[i] = exp2f(sc[i] - m_safe[(i >> 1) & 1]);
    l_run[(i >> 1) & 1] += sc[i];
  }
}

// The rows' totals after the last tile: l summed over the quad, 1 / l into
// inv, and the LSE of rows row0 and row0 + 8 (1e30 where l is 0), written
// by the quad's first thread for the rows below T_len.
__device__ __forceinline__ void finish_rows(float* l_run, const float* m_run, float* inv,
                                            float* __restrict__ lse, int row0, int t,
                                            int T_len) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    inv[h] = 1.0f / fmaxf(l_run[h], 1e-30f);
    const int row = row0 + 8 * h;
    if (t == 0 && row < T_len)
      lse[row] = l_run[h] > 0.0f ? (m_run[h] + log2f(fmaxf(l_run[h], 1e-30f))) * kLn2 : BIG_LSE;
  }
}

// A bf16 consumer warpgroup: rows q0w .. q0w + 63 of block b's q tile;
// this thread holds rows row0 and row0 + 8 of each accumulator
// (hopper_common.cuh).  o and lse start at the block's head.
template <int D, int kKeyRows, class Sweep>
__device__ __forceinline__ void fwd_consume(const Sweep& sw, unsigned char* q_s,
                                            const unsigned char* k_s, const unsigned char* v_s,
                                            const Step* step_s, uint64_t* q_full, uint64_t* full,
                                            uint64_t* empty, __nv_bfloat16* __restrict__ o,
                                            float* __restrict__ lse, int b, int n, int T_len,
                                            int S_len, float scale_log2, int causal) {
  using C = FwdCfg<D, kKeyRows>;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int q0w = b * kBlockRows + 64 * wg;
  const int r_wg = 16 * warp + lane / 4;    // row within the warpgroup's 64
  const int row0 = q0w + r_wg;
  unsigned char* q_wg = q_s + 64 * wg * C::RB;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};   // this thread's share of l; the quad sums at the end

  if (n > 0) mbar_wait(q_full, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % C::STAGES;
    Step step;
    if constexpr (!Sweep::kList) step = sw.fwd_step(b, it);
    mbar_wait(&full[s], (it / C::STAGES) & 1);
    if constexpr (Sweep::kList) step = step_s[s];   // staged by the producer
    if (step.flags & (kVisit << wg)) {
      const int k0 = step.tile * C::BK;
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

      float alpha[2];
      online_softmax<C::BK>(sw, sc, m_run, l_run, alpha,
                            Sweep::kList && (step.flags & (kPartial << wg)), k0, q0w, row0, t,
                            T_len, S_len, scale_log2, causal);
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
  finish_rows(l_run, m_run, inv, lse, row0, t, T_len);
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
      *reinterpret_cast<uint4*>(o + ((size_t)q0w + r) * D + 8 * cc) =
          *reinterpret_cast<const uint4*>(src);
  }
}

// An f32 consumer warpgroup: rows q0w .. q0w + 63, its own 64 q rows at
// q_s + wg Q_TILE; every product of f32 operands formed from bf16 products
// on their pieces (see the note at the top).  Up to D 128 (64-key tiles) it
// splits its q rows in place once; at D 192 and 256 (WIDE, 32-key tiles)
// they stay in f32 and are split into registers for every key tile
// (wide_scores).  A stage's K tile arrives on full[s] and is released on
// empty[s] once S is formed; its V tile on full_v[s], released on
// empty_v[s] after P . V.  o and lse start at the block's head; O leaves in
// f32 straight from the accumulators.
template <int D, class Sweep>
__device__ __forceinline__ void fwd_f32_consume(const Sweep& sw, unsigned char* q_s,
                                                unsigned char* k_s, unsigned char* v_s,
                                                const Step* step_s, uint64_t* q_full,
                                                uint64_t* full, uint64_t* empty,
                                                uint64_t* full_v, uint64_t* empty_v,
                                                float* __restrict__ o, float* __restrict__ lse,
                                                int b, int n, int T_len, int S_len,
                                                float scale_log2, int causal) {
  using C = FwdCfg<D, kFwdTileRows<D, float>, float>;
  using P = Panels<D>;
  constexpr int BK = C::BK;
  constexpr int THIRD = BK * D * 4;   // a tile's third pieces, after its f32 bytes
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int q0w = b * kBlockRows + 64 * wg;
  const int row0 = q0w + 16 * warp + lane / 4;
  unsigned char* q_wg = q_s + wg * C::Q_TILE;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};   // this thread's share of l; the quad sums at the end

  if (n > 0) {
    mbar_wait(q_full, 0);
    if constexpr (!C::WIDE) {
      split_tile<D>(q_wg, 1 + wg);   // the warpgroup's own rows, once
      fence_proxy_async();
      named_barrier_sync(1 + wg, 128);
    }
  }
  for (int it = 0; it < n; ++it) {
    const int s = it % C::STAGES;
    const uint32_t parity = (it / C::STAGES) & 1;
    Step step;
    if constexpr (!Sweep::kList) step = sw.fwd_step(b, it);
    mbar_wait(&full[s], parity);
    if constexpr (Sweep::kList) step = step_s[s];   // staged by the producer
    const bool visit = step.flags & (kVisit << wg);
    unsigned char* k_t = k_s + s * C::KV_BYTES;
    unsigned char* v_t = v_s + s * C::KV_BYTES;
    // K, then V, in three pieces, by both warpgroups, whichever of them
    // computes the tile
    split_tile<D, kConsumers, BK>(k_t, kKvSplit);
    fence_proxy_async();
    named_barrier_sync(kKvSplit, kConsumers);
    float sc[BK / 2];
    if (visit) {   // S = Q . K^T
      if constexpr (C::WIDE) {
        wide_scores<D>(sc, q_wg, k_t);
      } else {
        wgmma_fence();
        wgmma_scores_split<D, C::PANEL_Q, C::PANEL_KV, THIRD>(sc, q_wg, k_t);
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) fence_regs(sc[i]);
      }
    }
    mbar_arrive(&empty[s]);   // K is read: the next K may land
    uint32_t a1[BK / 4], a2[BK / 4], a3[BK / 4];   // P's pieces
    if (visit) {
      float alpha[2];
      online_softmax<BK>(sw, sc, m_run, l_run, alpha,
                         Sweep::kList && (step.flags & (kPartial << wg)), step.tile * BK, q0w,
                         row0, t, T_len, S_len, scale_log2, causal);
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) split_bf16x3(sc[2 * i], sc[2 * i + 1], a1[i], a2[i], a3[i]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
    mbar_wait(&full_v[s], parity);
    split_tile<D, kConsumers, BK>(v_t, kKvSplit);
    fence_proxy_async();
    named_barrier_sync(kKvSplit, kConsumers);
    if (visit) {
      wgmma_fence();
      wgmma_accumulate_split<D, C::PANEL_KV, THIRD, BK / 16>(acc, a1, a2, a3, v_t);   // O += P . V
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < D / 2; ++i) fence_regs(acc[i]);
    }
    mbar_arrive(&empty_v[s]);
  }

  // epilogue: O = acc / l in f32, two columns a store (element 4 j + 2 h
  // of panel p: row row0 + 8 h, column p PW + 8 j + 2 t)
  float inv[2];
  finish_rows(l_run, m_run, inv, lse, row0, t, T_len);
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int j = 0; j < P::PW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        const float* a = acc + p * (P::PW / 2) + 4 * j + 2 * h;
        if (row < T_len)
          *reinterpret_cast<float2*>(o + (size_t)row * D + p * P::PW + 8 * j + 2 * t) =
              make_float2(a[0] * inv[h], a[1] * inv[h]);
      }
}

// The forward block over operands of type T (bf16, or f32 on the split
// products of fwd_f32_consume): grid (B*H, ceil(T / 128)); the sweep maps
// blockIdx.y to a block.  A list sweep's
// steps are 64-key tiles, streamed as kSub tiles of BK rows each.  The
// kernels below pass their tensor maps' addresses.
template <int D, int kKeyRows, class Sweep, typename T>
__device__ __forceinline__ void attn_fwd_body(const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                              const CUtensorMap* tm_v, T* __restrict__ o,
                                              float* __restrict__ lse, int T_len, int S_len,
                                              float scale_log2, int causal, int H, int h0,
                                              const Sweep& sw) {
  using C = FwdCfg<D, kKeyRows, T>;
  using L = typename C::L;   // TMA's panels
  constexpr int kSub = Sweep::kList ? kTileRows / C::BK : 1;   // tiles a list step
  static_assert(!Sweep::kList || C::BK * kSub == kTileRows, "list sweeps stream 64-row tiles");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align1024(smem_raw);             // [q tile][panel][rows]
  unsigned char* k_s = q_s + C::Q_BYTES;                // [stage][panel][BK rows]
  unsigned char* v_s = k_s + C::STAGES * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + C::STAGES * C::KV_BYTES);
  uint64_t* full = q_full + 1;          // K's (and, in bf16, V's)
  uint64_t* empty = full + C::STAGES;
  uint64_t* full_v = empty + C::STAGES;   // f32: V's own (in bf16 past the barriers, unused)
  uint64_t* empty_v = full_v + C::STAGES;
  Step* step_s = reinterpret_cast<Step*>(full + 2 * C::KV_BARS * C::STAGES);   // list sweeps

  const int bh = h0 + blockIdx.x;   // of the B*H heads; TMA reads head h of batch bb
  const int h = bh % H, bb = bh / H;
  const int b = sw.fwd_block();
  const int q0 = b * kBlockRows;
  const int n = sw.fwd_count(b, S_len) * kSub;   // 0: O = 0, LSE = 1e30

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    // one TMA thread, or the first warp where it may stage rows itself
    const uint32_t loaders = Sweep::kList ? 32 : 1;
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], loaders);
      mbar_init(&empty[s], kConsumers);
      if constexpr (C::F32) {
        mbar_init(&full_v[s], loaders);
        mbar_init(&empty_v[s], kConsumers);
      }
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<C::PRODUCER_REGS>();
    const int lane = threadIdx.x % 32;
    if (Sweep::kList ? threadIdx.x < kConsumers + 32 : threadIdx.x == kConsumers) {
      if (lane == 0 && n > 0) {
        // the q tiles (f32: a second 64-row tile only where a row of it
        // is below T; rows past T arrive as zeros)
        const int tiles =
            C::Q_ROWS == kBlockRows || q0 + C::Q_ROWS < T_len ? kBlockRows / C::Q_ROWS : 1;
        mbar_arrive_expect_tx(q_full, tiles * C::Q_LOAD);
        for (int w = 0; w < tiles; ++w)
          for (int p = 0; p < L::NP; ++p)
            tma_load_4d(q_s + w * C::Q_TILE + p * C::LPANEL_Q, tm_q, q_full, p * L::PW,
                        q0 + w * C::Q_ROWS, h, bb);
      }
      for (int it = 0; it < n; ++it) {
        const int s = it % C::STAGES;
        Step step = sw.fwd_step(b, it / kSub);
        if constexpr (kSub > 1) step.tile = step.tile * kSub + it % kSub;
        const int k0 = step.tile * C::BK;
        const uint32_t parity = ((it / C::STAGES) & 1) ^ 1;   // the first round passes
        mbar_wait(&empty[s], parity);
        if constexpr (Sweep::kList) {
          if (lane == 0) step_s[s] = step;
        }
        // f32: K on full[s], then V on full_v[s] once the consumers have
        // read the stage's V; bf16: both on full[s]
        for (int kv = 0; kv < C::KV_BARS; ++kv) {
          const bool with_k = kv == 0, with_v = !C::F32 || kv == 1;
          uint64_t* bar = kv == 0 ? &full[s] : &full_v[s];
          if (kv == 1) mbar_wait(&empty_v[s], parity);
          if constexpr (Sweep::kList) {
            if (step.flags & kPartialAny) {   // a partial pair: live rows only
              unsigned long long live = sw.live(b, it / kSub);
              if constexpr (kSub > 1) live >>= C::BK * (it % kSub);
              if (with_k)
                stage_live_rows<D, C::LPANEL_KV, T, C::BK>(k_s + s * C::KV_BYTES,
                                                           sw.src_a + sw.stride_a.head(bh, H),
                                                           sw.stride_a.r, k0, S_len, live, lane);
              if (with_v)
                stage_live_rows<D, C::LPANEL_KV, T, C::BK>(v_s + s * C::KV_BYTES,
                                                           sw.src_b + sw.stride_b.head(bh, H),
                                                           sw.stride_b.r, k0, S_len, live, lane);
              fence_proxy_async();
              mbar_arrive(bar);
              continue;
            }
            if (lane != 0) {
              mbar_arrive(bar);
              continue;
            }
          }
          mbar_arrive_expect_tx(bar, (with_k + with_v) * C::KV_LOAD);
          for (int p = 0; p < L::NP; ++p) {
            if (with_k)
              tma_load_4d(k_s + s * C::KV_BYTES + p * C::LPANEL_KV, tm_k, bar, p * L::PW, k0,
                          h, bb);
            if (with_v)
              tma_load_4d(v_s + s * C::KV_BYTES + p * C::LPANEL_KV, tm_v, bar, p * L::PW, k0,
                          h, bb);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<C::CONSUMER_REGS>();
    T* o_h = o + (size_t)bh * T_len * D;
    float* lse_h = lse + (size_t)bh * T_len;
    if constexpr (C::F32)
      fwd_f32_consume<D>(sw, q_s, k_s, v_s, step_s, q_full, full, empty, full_v, empty_v, o_h,
                         lse_h, b, n, T_len, S_len, scale_log2, causal);
    else
      fwd_consume<D, kKeyRows>(sw, q_s, k_s, v_s, step_s, q_full, full, empty, o_h, lse_h, b,
                               n, T_len, S_len, scale_log2, causal);
  }
}

// the forward in bf16 (K1, K6)
template <int D, int kKeyRows, class Sweep>
__global__ void __launch_bounds__(kFwdThreads, 1)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int T_len, int S_len, float scale_log2,
                      int causal, int H, int h0, const Sweep sw) {
  attn_fwd_body<D, kKeyRows>(&tm_q, &tm_k, &tm_v, o, lse, T_len, S_len, scale_log2, causal, H,
                             h0, sw);
}

// the forward in f32 (K1, K6 at D 16-128, 192 and 256), each product from
// bf16 products on bf16 pieces of its operands
template <int D, int kKeyRows, class Sweep>
__global__ void __launch_bounds__(kFwdThreads, 1)
attn_fwd_split_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                      float* __restrict__ lse, int T_len, int S_len, float scale_log2,
                      int causal, int H, int h0, const Sweep sw) {
  attn_fwd_body<D, kKeyRows>(&tm_q, &tm_k, &tm_v, o, lse, T_len, S_len, scale_log2, causal, H,
                             h0, sw);
}

// The arguments of one forward launch over heads h0 .. h0 + BH - 1 of H
// heads a batch: q (., H, T, D), k and v (., H, S, D) at their strides, o
// (., T, D) and lse (., T) f32 contiguous, all from their first head.
struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  void* lse;
  HeadStrides sq, sk, sv;
  int H, h0, BH, T_len, S_len;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

// the forward over `sw`, key tiles of kKeyRows rows: bf16
// (attn_fwd_wgmma_kernel) or f32 (attn_fwd_split_kernel)
template <int D, int kKeyRows, typename T = __nv_bfloat16, class Sweep>
cudaError_t launch_fwd_wgmma(const FwdArgs& a, const Sweep& sw) {
  using C = FwdCfg<D, kKeyRows, T>;
  static_assert(C::SMEM <= kMaxSmemBytes, "attn_fwd_wgmma tiles do not fit in shared memory");
  const int n_qb = (a.T_len + kBlockRows - 1) / kBlockRows;
  if (n_qb > 65535) return cudaErrorInvalidValue;
  // encoded per launch and passed by value: a CUDA graph captures them
  CUtensorMap tm_q, tm_k, tm_v;
  const int heads = a.h0 + a.BH;
  constexpr int PW = C::L::PW;
  cudaError_t err = encode_heads<T>(&tm_q, a.q, D, a.T_len, a.H, heads, a.sq, PW, C::Q_ROWS);
  if (err == cudaSuccess)
    err = encode_heads<T>(&tm_k, a.k, D, a.S_len, a.H, heads, a.sk, PW, C::BK);
  if (err == cudaSuccess)
    err = encode_heads<T>(&tm_v, a.v, D, a.S_len, a.H, heads, a.sv, PW, C::BK);
  if (err != cudaSuccess) return err;
  auto kernel = [] {
    if constexpr (kIsBf16<T>) return attn_fwd_wgmma_kernel<D, kKeyRows, Sweep>;
    else return attn_fwd_split_kernel<D, kKeyRows, Sweep>;
  }();
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  err = smem_opt_in_once(kernel, (int)C::SMEM, mu, attr_set);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.BH, n_qb), kFwdThreads, C::SMEM, a.stream>>>(
      tm_q, tm_k, tm_v, static_cast<T*>(a.o), static_cast<float*>(a.lse), a.T_len, a.S_len,
      a.sm_scale * kLog2e, a.causal, a.H, a.h0, sw);
  return cudaGetLastError();
}

// ---- the forward above head dim 256 (attn_fwd_chunk_kernel) ----------------
//
// See the note at the top.  Panels of kChunkPanel columns of q and K stream
// through a ring (the producer loads panel p of the q rows and of the key
// tile into one stage); a block keeps kChunkCols columns of O, the chunk
// chunk_of gives it (hopper_common.cuh).

// The ring of (q panel, K panel) stages, the ring of V chunk tiles and,
// for a list sweep, each stage's step, in operands of type T.  A q panel is
// the block's 128 rows by kChunkPanel columns (bf16: one TMA box; f32: two
// boxes of 32 columns, LPANEL_Q apart, each warpgroup's 64 rows 8 KB into
// a box); a K panel BK keys by kChunkPanel columns and a V tile BK keys by
// kChunkCols columns, in TMA's boxes of L::PW columns, LPANEL_KV apart.  In
// f32 the K panel and the V tile are split in place into three bf16 pieces
// (split_tile: the third piece after the f32 bytes), and q is split into
// wgmma's register operand as it is read (as at D 192 and 256).
template <typename T>
struct ChunkCfg {
  using L = Panels<kChunkPanel, sizeof(T)>;   // TMA's boxes: 64 bf16 or 32 f32 columns
  static constexpr bool F32 = !kIsBf16<T>;
  static constexpr int BK = F32 ? kWideRows : kTileRows;   // key rows a tile
  static constexpr int Q_LOAD = kBlockRows * kChunkPanel * (int)sizeof(T);
  static constexpr int K_LOAD = BK * kChunkPanel * (int)sizeof(T);
  static constexpr int K_BYTES = K_LOAD + (F32 ? BK * kChunkPanel * 2 : 0);
  static constexpr int STAGE = Q_LOAD + K_BYTES;
  static constexpr int V_LOAD = BK * kChunkCols * (int)sizeof(T);
  static constexpr int V_BYTES = V_LOAD + (F32 ? BK * kChunkCols * 2 : 0);
  static constexpr int LPANEL_Q = kBlockRows * L::RB;
  static constexpr int LPANEL_KV = BK * L::RB;
  // bf16: 6 stages of 24 KB and two V tiles of 32 KB; f32: 4 of 44 KB and
  // one of 48 KB
  static constexpr int STAGES = F32 ? 4 : 6;
  static constexpr int V_STAGES = F32 ? 1 : 2;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + (size_t)V_STAGES * V_BYTES +
                                 sizeof(uint64_t) * 2 * (STAGES + V_STAGES) +
                                 STAGES * sizeof(Step);
  static_assert(STAGE % 1024 == 0 && V_BYTES % 1024 == 0, "panels start on 1024-byte bounds");
};

// The producer warp (lane 0 alone over a dense sweep) of the chunked
// forward: for each of the n key tiles of block b, its np panels of q and
// K into the stage ring, then its chunk of V (columns col0 ..) into the V
// ring.  A list step's partial pair is staged by the warp, live rows only,
// a K panel and the V chunk alike.
template <class Sweep, typename T>
__device__ __forceinline__ void chunk_produce(const Sweep& sw, const CUtensorMap* tm_q,
                                              const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                              unsigned char* stages, unsigned char* vbuf,
                                              Step* step_s, uint64_t* full, uint64_t* empty,
                                              uint64_t* full_v, uint64_t* empty_v, int b, int n,
                                              int np, int col0, int S_len, int h, int bb, int bh,
                                              int H) {
  using C = ChunkCfg<T>;
  using L = typename C::L;
  constexpr int kSub = Sweep::kList ? kTileRows / C::BK : 1;   // tiles a list step
  const int lane = threadIdx.x % 32;
  int si = 0;   // stages filled
  for (int it = 0; it < n; ++it) {
    Step step = sw.fwd_step(b, it / kSub);
    if constexpr (kSub > 1) step.tile = step.tile * kSub + it % kSub;
    const int k0 = step.tile * C::BK;
    bool part = false;
    unsigned long long live = 0;
    if constexpr (Sweep::kList) {
      part = step.flags & kPartialAny;
      if (part) {
        live = sw.live(b, it / kSub);
        if constexpr (kSub > 1) live >>= C::BK * (it % kSub);
      }
    }
    for (int p = 0; p < np; ++p, ++si) {
      const int s = si % C::STAGES;
      mbar_wait(&empty[s], ((si / C::STAGES) & 1) ^ 1);   // the first round passes
      unsigned char* q_st = stages + s * C::STAGE;
      unsigned char* k_st = q_st + C::Q_LOAD;
      if constexpr (Sweep::kList) {
        if (p == 0 && lane == 0) step_s[s] = step;
        if (part) {   // a partial pair: the K panel's live rows only
          stage_live_rows<kChunkPanel, C::LPANEL_KV, T, C::BK>(
              k_st, sw.src_a + sw.stride_a.head(bh, H) + p * kChunkPanel, sw.stride_a.r, k0,
              S_len, live, lane);
          fence_proxy_async();
        }
        if (lane != 0) {
          mbar_arrive(&full[s]);
          continue;
        }
      }
      mbar_arrive_expect_tx(&full[s], C::Q_LOAD + (part ? 0 : C::K_LOAD));
      for (int g = 0; g < L::NP; ++g) {
        const int col = p * kChunkPanel + g * L::PW;
        tma_load_4d(q_st + g * C::LPANEL_Q, tm_q, &full[s], col, b * kBlockRows, h, bb);
        if (!part) tma_load_4d(k_st + g * C::LPANEL_KV, tm_k, &full[s], col, k0, h, bb);
      }
    }
    const int vs = it % C::V_STAGES;
    mbar_wait(&empty_v[vs], ((it / C::V_STAGES) & 1) ^ 1);
    unsigned char* v_st = vbuf + vs * C::V_BYTES;
    if constexpr (Sweep::kList) {
      if (part) {
        stage_live_rows<kChunkCols, C::LPANEL_KV, T, C::BK>(
            v_st, sw.src_b + sw.stride_b.head(bh, H) + col0, sw.stride_b.r, k0, S_len, live,
            lane);
        fence_proxy_async();
        mbar_arrive(&full_v[vs]);
        continue;
      }
      if (lane != 0) {
        mbar_arrive(&full_v[vs]);
        continue;
      }
    }
    mbar_arrive_expect_tx(&full_v[vs], C::V_LOAD);
    for (int g = 0; g < kChunkCols / L::PW; ++g)
      tma_load_4d(v_st + g * C::LPANEL_KV, tm_v, &full_v[vs], col0 + g * L::PW, k0, h, bb);
  }
}

// S += Q . K^T over one f32 ring stage: the stage's two 32-column panels of
// this warpgroup's 64 q rows (f32, TMA's layout, LPANEL_Q apart) each split
// into wgmma's register operand a k16 step at a time, against the 32 keys
// of the K panel split in place at k; each q panel's twelve products into
// a fresh partial added to S in f32 (the order of wide_scores at D 256).
// Waited.
__device__ __forceinline__ void chunk_scores_f32(float (&sc)[kWideRows / 2],
                                                 const unsigned char* q, const unsigned char* k) {
  using C = ChunkCfg<float>;
  float part[kWideRows / 2];
#pragma unroll 1
  for (int g = 0; g < C::L::NP; ++g) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t a[3][1][4];   // one k16 step's pieces
      load_split_rows<C::L::RB, 1>(a, q + g * C::LPANEL_Q, j);
      wgmma_fence();
      wide_products<kChunkPanel, 1, kWideRows>(part, a, k, g, j);
      wgmma_commit();
      wgmma_wait<0>();
    }
    add_partial<kWideRows>(sc, part);
  }
}

// A consumer warpgroup of the chunked forward: rows q0w .. q0w + 63 of
// block b, the columns col0 .. col0 + kChunkCols - 1 of O of chunk
// `chunk` (chunk_of) in registers, of which it writes lo .. hi - 1; LSE
// in chunk 0 (every chunk forms the same S and l, bit for bit, since
// nothing before the epilogue depends on the chunk but V's columns).
// bf16: S over the np stages of a key tile in one accumulator (wgmma
// groups chained, each stage released once the next stage's products are
// issued and its own are done); f32: both warpgroups split each stage's K
// panel, then the tile's V chunk, in place (named barrier kKvSplit), S
// from chunk_scores_f32.  o (rows of D = np panels) and lse are the
// tensors' starts; head bh's rows and the chunk's columns are worked out
// in the epilogue, which keeps them out of the loop's registers.
template <typename T, class Sweep>
__device__ __forceinline__ void chunk_consume(const Sweep& sw, unsigned char* stages,
                                              unsigned char* vbuf, const Step* step_s,
                                              uint64_t* full, uint64_t* empty, uint64_t* full_v,
                                              uint64_t* empty_v, T* __restrict__ o,
                                              float* __restrict__ lse, int bh, int b, int n,
                                              int np, int chunk, int T_len, int S_len,
                                              float scale_log2, int causal) {
  using C = ChunkCfg<T>;
  using P = Panels<kChunkCols>;   // O's panels (and V's bf16 pieces)
  constexpr int BK = C::BK;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int q0w = b * kBlockRows + 64 * wg;
  const int row0 = q0w + 16 * warp + lane / 4;
  const int q_off = 64 * wg * C::L::RB;   // this warpgroup's rows in a q box

  float acc[kChunkCols / 2];
#pragma unroll
  for (int i = 0; i < kChunkCols / 2; ++i) acc[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};   // this thread's share of l; the quad sums at the end

  for (int it = 0; it < n; ++it) {
    const int si = it * np;   // the tile's first stage, counted from the first
    Step step;
    if constexpr (!Sweep::kList) step = sw.fwd_step(b, it);
    mbar_wait(&full[si % C::STAGES], (si / C::STAGES) & 1);
    if constexpr (Sweep::kList) step = step_s[si % C::STAGES];   // staged by the producer
    const bool visit = step.flags & (kVisit << wg);
    float sc[BK / 2];
    if constexpr (C::F32) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
#pragma unroll 1
      for (int p = 0; p < np; ++p) {
        const int s = (si + p) % C::STAGES;
        if (p > 0) mbar_wait(&full[s], ((si + p) / C::STAGES) & 1);
        unsigned char* k_st = stages + s * C::STAGE + C::Q_LOAD;
        split_tile<kChunkPanel, kConsumers, BK>(k_st, kKvSplit);
        fence_proxy_async();
        named_barrier_sync(kKvSplit, kConsumers);
        if (visit) chunk_scores_f32(sc, stages + s * C::STAGE + q_off, k_st);
        mbar_arrive(&empty[s]);
      }
    } else if (visit) {
      const unsigned char* st = stages + (si % C::STAGES) * C::STAGE;
      wgmma_fence();
      chunk_scores_bf16(sc, st + q_off, st + C::Q_LOAD, true);
      wgmma_commit();
#pragma unroll 1
      for (int p = 1; p < np; ++p) {
        const int s = (si + p) % C::STAGES;
        mbar_wait(&full[s], ((si + p) / C::STAGES) & 1);
        st = stages + s * C::STAGE;
        wgmma_fence();
        chunk_scores_bf16(sc, st + q_off, st + C::Q_LOAD, false);
        wgmma_commit();
        wgmma_wait<1>();   // the stage before is read
        mbar_arrive(&empty[(si + p - 1) % C::STAGES]);
      }
      wgmma_wait<0>();
      mbar_arrive(&empty[(si + np - 1) % C::STAGES]);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) fence_regs(sc[i]);
    } else {
      mbar_arrive(&empty[si % C::STAGES]);
#pragma unroll 1
      for (int p = 1; p < np; ++p) {
        const int s = (si + p) % C::STAGES;
        mbar_wait(&full[s], ((si + p) / C::STAGES) & 1);
        mbar_arrive(&empty[s]);
      }
    }

    uint32_t a1[BK / 4], a2[BK / 4], a3[BK / 4];   // P in bf16; f32: its three pieces
    if (visit) {
      float alpha[2];
      online_softmax<BK>(sw, sc, m_run, l_run, alpha,
                         Sweep::kList && (step.flags & (kPartial << wg)), step.tile * BK, q0w,
                         row0, t, T_len, S_len, scale_log2, causal);
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) {
        if constexpr (C::F32) split_bf16x3(sc[2 * i], sc[2 * i + 1], a1[i], a2[i], a3[i]);
        else a1[i] = pack_bf16x2(sc[2 * i], sc[2 * i + 1]);
      }
#pragma unroll
      for (int i = 0; i < kChunkCols / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    }
    const int vs = it % C::V_STAGES;
    unsigned char* v_st = vbuf + vs * C::V_BYTES;
    mbar_wait(&full_v[vs], (it / C::V_STAGES) & 1);
    if constexpr (C::F32) {
      split_tile<kChunkCols, kConsumers, BK>(v_st, kKvSplit);
      fence_proxy_async();
      named_barrier_sync(kKvSplit, kConsumers);
    }
    if (visit) {   // O += P . V
      wgmma_fence();
      if constexpr (C::F32)
        wgmma_accumulate_split<kChunkCols, BK * P::RB, BK * kChunkCols * 4, BK / 16>(
            acc, a1, a2, a3, v_st);
      else
        wgmma_accumulate<kChunkCols, C::LPANEL_KV, BK / 16>(acc, a1, v_st);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kChunkCols / 2; ++i) fence_regs(acc[i]);
    }
    mbar_arrive(&empty_v[vs]);
  }

  // epilogue: O = acc / l in T, two columns a store (element 4 j + 2 h of
  // panel p: row row0 + 8 h, column col0 + p PW + 8 j + 2 t), the chunk's
  // own columns only
  const int D = np * kChunkPanel;
  const Chunk ch = chunk_of(chunk, D);
  o += (size_t)bh * T_len * D;
  float inv[2];
  finish_rows(l_run, m_run, inv, lse + (size_t)bh * T_len, row0, t, chunk == 0 ? T_len : 0);
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int j = 0; j < P::PW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        const int col = ch.col0 + p * P::PW + 8 * j + 2 * t;
        const float* a = acc + p * (P::PW / 2) + 4 * j + 2 * h;
        if (row < T_len && col >= ch.lo && col < ch.hi) {
          if constexpr (C::F32)
            *reinterpret_cast<float2*>(o + (size_t)row * D + col) =
                make_float2(a[0] * inv[h], a[1] * inv[h]);
          else
            *reinterpret_cast<uint32_t*>(o + (size_t)row * D + col) =
                pack_bf16x2(a[0] * inv[h], a[1] * inv[h]);
        }
      }
}

// The forward above head dim 256 in T (bf16, or f32 on split products):
// grid (chunk_count(D) chunks of each of B*H heads, ceil(T / 128)); the
// sweep maps blockIdx.y to a block, blockIdx.x is head * chunks + chunk,
// so a head's chunks run side by side and share q and K in L2.  D is a
// multiple of kChunkPanel above kChunkCols, the same instantiation at every
// such D.
template <typename T, class Sweep>
__global__ void __launch_bounds__(kFwdThreads, 1)
attn_fwd_chunk_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,
                      float* __restrict__ lse, int T_len, int S_len, int D, float scale_log2,
                      int causal, int H, int h0, int chunks, const Sweep sw) {
  using C = ChunkCfg<T>;
  constexpr int kSub = Sweep::kList ? kTileRows / C::BK : 1;
  static_assert(!Sweep::kList || C::BK * kSub == kTileRows, "list sweeps stream 64-row tiles");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = align1024(smem_raw);
  unsigned char* vbuf = stages + C::STAGES * C::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(vbuf + C::V_STAGES * C::V_BYTES);
  uint64_t* empty = full + C::STAGES;
  uint64_t* full_v = empty + C::STAGES;
  uint64_t* empty_v = full_v + C::V_STAGES;
  Step* step_s = reinterpret_cast<Step*>(empty_v + C::V_STAGES);   // list sweeps

  // the block's chunk, head (of the B*H; TMA reads head h of batch bb),
  // query rows and key tiles (n = 0: O = 0, LSE = 1e30), worked out by the
  // producer and the consumers each after their setmaxnreg: values live
  // across it are spilled
  const auto where = [&](int& chunk, int& bh, int& b, int& n) {
    chunk = blockIdx.x % chunks;
    bh = h0 + blockIdx.x / chunks;
    b = sw.fwd_block();
    n = sw.fwd_count(b, S_len) * kSub;
  };
  const int np = D / kChunkPanel;

  if (threadIdx.x == 0) {
    // one TMA thread, or the first warp where it may stage rows itself
    const uint32_t loaders = Sweep::kList ? 32 : 1;
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], loaders);
      mbar_init(&empty[s], kConsumers);
    }
    for (int s = 0; s < C::V_STAGES; ++s) {
      mbar_init(&full_v[s], loaders);
      mbar_init(&empty_v[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  int chunk, bh, b, n;
  // 40 and 232 registers in both dtypes: the f32 consumer's O chunk (128
  // registers a thread) and one k16 step of q's pieces fit in 232, and
  // the list producer, which stages rows, spills in 24
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kFwdProducerRegs>();
    if (Sweep::kList ? threadIdx.x < kConsumers + 32 : threadIdx.x == kConsumers) {
      where(chunk, bh, b, n);
      chunk_produce<Sweep, T>(sw, &tm_q, &tm_k, &tm_v, stages, vbuf, step_s, full, empty, full_v,
                              empty_v, b, n, np, chunk_of(chunk, D).col0, S_len, bh % H, bh / H,
                              bh, H);
    }
  } else {
    setmaxnreg_inc<kFwdConsumerRegs>();
    where(chunk, bh, b, n);
    chunk_consume<T>(sw, stages, vbuf, step_s, full, empty, full_v, empty_v, o, lse, bh, b,
                     n, np, chunk, T_len, S_len, scale_log2, causal);
  }
}

// the forward over `sw` at a head dim D above 256 (a multiple of
// kChunkPanel; the wrappers zero-pad to one), in bf16 or f32
template <typename T, class Sweep>
cudaError_t launch_fwd_chunked(const FwdArgs& a, int D, const Sweep& sw) {
  using C = ChunkCfg<T>;
  static_assert(C::SMEM <= kMaxSmemBytes, "attn_fwd_chunk tiles do not fit in shared memory");
  if (D <= kChunkCols || D % kChunkPanel) return cudaErrorInvalidValue;
  const int n_qb = (a.T_len + kBlockRows - 1) / kBlockRows;
  const int chunks = chunk_count(D);
  if (n_qb > 65535 || (long long)a.BH * chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // encoded per launch and passed by value: a CUDA graph captures them
  CUtensorMap tm_q, tm_k, tm_v;
  const int heads = a.h0 + a.BH;
  constexpr int PW = C::L::PW;
  cudaError_t err = encode_heads<T>(&tm_q, a.q, D, a.T_len, a.H, heads, a.sq, PW, kBlockRows);
  if (err == cudaSuccess)
    err = encode_heads<T>(&tm_k, a.k, D, a.S_len, a.H, heads, a.sk, PW, C::BK);
  if (err == cudaSuccess)
    err = encode_heads<T>(&tm_v, a.v, D, a.S_len, a.H, heads, a.sv, PW, C::BK);
  if (err != cudaSuccess) return err;
  auto kernel = attn_fwd_chunk_kernel<T, Sweep>;
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  err = smem_opt_in_once(kernel, (int)C::SMEM, mu, attr_set);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.BH * chunks, n_qb), kFwdThreads, C::SMEM, a.stream>>>(
      tm_q, tm_k, tm_v, static_cast<T*>(a.o), static_cast<float*>(a.lse), a.T_len, a.S_len, D,
      a.sm_scale * kLog2e, a.causal, a.H, a.h0, chunks, sw);
  return cudaGetLastError();
}

}  // namespace
