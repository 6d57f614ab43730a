// The attention backward for Hopper (sm_90a): the dK/dV and dQ kernels
// that flash_bwd.cu runs as K2 and K3 and block_sparse.cu as K7 and K8, in
// bf16 and in f32, at every head dim (above 256 chunked).  Both pairs
// compute the same math; only the sweep differs, so the body is written
// once here and templated on a sweep policy.
//
// What they compute (the TPU kernels `_dkv_kernel` / `_dq_kernel` of
// bigdl_tpu/ops/flash_attention.py and `_bs_dkv_kernel` / `_bs_dq_kernel` of
// bigdl_tpu/ops/block_sparse.py): scores in f32 times sm_scale, P =
// exp(S - LSE), dP = dO . V^T, dS = P * (dP - delta) with delta from the
// caller; P cast to v's dtype before dV += P^T . dO, dS cast before dK +=
// dS^T . Q and dQ += dS . K (in f32 neither is cast); f32 accumulators, dK
// and dQ times sm_scale.
// Every element that the causal mask, the ragged edge or the block mask
// kills gets P = 0 and dS = 0 by select, not by a product: a killed element
// may face a NaN in dP (a dead key row of the block's own V), and 0 * NaN is
// NaN, so on an edge or partial tile its dP is replaced by delta first.  No
// atomics: each output row has one owner block, so two launches on the same
// inputs give the same bits.
//
// Design (see flash_bwd.cu for what bounds it).  One block of 384 threads:
// two consumer warpgroups of 64 output rows each and one producer warpgroup
// that hands most of its registers to the consumers (setmaxnreg), so each
// consumer keeps its accumulators in registers.  One producer thread issues
// the tile loads by TMA through 4-D tensor maps (D, rows, H, B) over the
// operands' own strides (HeadStrides); streamed 64-row tiles go through a
// ring of stages, each guarded by a full and an empty mbarrier.  Panels,
// swizzles and descriptors follow hopper_common.cuh, which also holds the
// sweep's Step, its flag bits and stage_live_rows, shared with the forward
// body (attn_fwd_hopper.cuh).
//   * dK/dV (bwd_dkv_wgmma_kernel) up to D 128: the block owns 128 key rows;
//     K and V are loaded once; 64-row Q and dO tiles stream through 3
//     stages, and the producer's first warp stages each tile's LSE (times
//     log2 e) and delta beside them (1e30 and 0 past T).  S^T = K . Q^T and
//     dP^T = V . dO^T on wgmma; P^T and dS^T packed to bf16 as the register
//     A operand of dV += P^T . dO and dK += dS^T . Q, dO and Q read MN-major.
//   * dK/dV at D 192 and 256 (the same kernel, dkv_split_consume): dK and
//     dV of 128 rows would take 2 D f32 a consumer thread, more than its
//     240 registers, so the block owns 64 key rows and splits the work by
//     output: warpgroup 0 computes S^T and P^T and keeps dV, warpgroup 1
//     computes dP^T and dS^T and keeps dK (D / 2 f32 a thread each); P^T
//     passes from 0 to 1 through shared memory in f32, so dS^T rounds as
//     above.  3 stages at D 192, 2 at D 256.
//   * dK/dV in f32 (bwd_dkv_split_kernel, D 16-128; dkv_f32_consume): wgmma
//     has no f32 product, so each product of f32 operands is formed from
//     bf16 products on the operands' three bf16 pieces (hopper_common.cuh:
//     a1 = bf16(a), a2 = bf16(a - a1), a3 = bf16(a - a1 - a2)), small terms
//     first: six for S^T and dP^T, five for dV and dK (dO and Q in two
//     pieces there).  Three products on two pieces a side missed the f32
//     limit on the card (PERF.md).  The block is the 64-row block above:
//     the f32 tiles land by TMA in panels of 32 columns and are split in
//     place, each by the warpgroup whose scores read it first (K and each
//     Q tile by warpgroup 0, V and each dO tile by 1); P^T and dS^T are
//     split in registers; dK and dV leave in f32.  A tile takes 6 bytes an
//     element, so 3 stages below D 128 and 1 at D 128 (209 KB).
//   * dK/dV in f32 at D 192 and 256 (the same kernel, DkvCfg::WIDE): K, V
//     and 64-row Q and dO tiles in three pieces would take 384 KB at D 256,
//     so K and V stay f32 (128 KB) and each warpgroup splits its own
//     operand into wgmma's register A operand 32 columns at a time, for
//     every Q or dO tile, S^T and dP^T summed from a fresh partial per k16
//     step (hopper_common.cuh, wide_scores with kStep: wgmma truncates
//     what it accumulates).  Q and dO stream as 32-row tiles split in
//     place (48 KB each at D 256, one stage), each 64-row step of a sweep
//     as two, and P^T passes from warpgroup 0 to 1 in the Q tile's third
//     pieces, which only S^T reads, so no buffer of its own: 230,688 B at
//     D 256.
//   * dQ (bwd_dq_wgmma_kernel) up to D 128: the block owns 128 query rows;
//     Q and dO are loaded once; 64-row K and V tiles stream through 4
//     stages.  S = Q . K^T and dP = dO . V^T, dS packed as the A operand of
//     dQ += dS . K.
//   * dQ at D 192 and 256 (the same kernel, dq_split_consume): dQ of 128
//     rows would take D f32 a consumer thread, and Q and dO of 128 rows
//     with two K/V stages 256 KB of shared memory, so the block owns 64
//     query rows: warpgroup 0 computes S and P, warpgroup 1 dP and dS (P
//     passes from 0 to 1 in f32, so dS rounds as above), dS goes to shared
//     memory in bf16, and each warpgroup adds dS . K over half of the
//     tile's keys to its own D / 2 f32; the two halves are summed once, at
//     the end.  3 stages at D 192, 2 at D 256.
//   * dQ in f32 (bwd_dq_split_kernel, D 16-128; dq_f32_consume): the block
//     owns 64 query rows, as at D 192, but splits each tile by keys
//     instead: warpgroup w forms S, P, dP and dS over keys 32 w .. 32 w +
//     31 in its own registers (m64n32 products) and adds dS . K over them,
//     so nothing crosses between the warpgroups per tile; the halves meet
//     once, at the end.  Six bf16 products for each of S, dP and dQ, on
//     three pieces a side (two pieces of K leave K's rounding in dQ, which
//     a common shift of the key rows then shows; PERF.md).  Q and dO land
//     once, K and V tiles on barriers of their own (V released once dP is
//     formed, K after dS . K), split in place by both warpgroups together.
//     4 stages to D 32, 3 at D 64, 1 at D 128 (197,680 B).
//   * dQ in f32 at D 192 and 256 (the same kernel, DqCfg::WIDE): Q and dO
//     stay f32, split into registers 32 columns at a time for every K or V
//     tile (wide_scores, a partial per k16 step), and the K and V tiles
//     are of 32 keys, 16 a warpgroup (m64n16 products), split in place:
//     one stage, 230,448 B at D 256.  Each warpgroup keeps all of dQ (D /
//     2 f32) beside one k16 step's pieces of its A operand.
//   * dK/dV and dQ above D 256, both dtypes (bwd_dkv_chunk_kernel,
//     bwd_dq_chunk_kernel): design (a) of the chunked forward
//     (attn_fwd_hopper.cuh) carried to the 64-row blocks above.  Own rows
//     at D 512 would take 256 KB in f32 (128 KB in bf16), so they stream
//     with each tile in 64-column panels through a ring; S^T and dP^T (or
//     S and dP) are summed over the panels, and a block keeps 256 columns
//     of its output (dV in warpgroup 0 and dK in 1, or dQ in both: D / 2
//     = 128 f32 a thread, the D 256 budget), the chunks of a head in
//     blocks of their own, each forming the scores anew.  The tile's chunk
//     operands land in a slot of their own.  One instantiation per pass,
//     dtype and sweep for every D.  f32 streams the WIDE blocks' 32-row
//     tiles (each tile and chunk operand split in place, a fresh score
//     partial per k16 step; 2 or 3 stages of 56 KB).  bf16 has no pieces:
//     one wgmma product a k16 step, each panel read by wgmma as it lands,
//     and one f32 score accumulator over the panels, chained stage behind
//     stage as the bf16 forward chains S (bf16's 7e-3 limit asks for no
//     fresh partial), with the work split of the bf16 64-row blocks: dV in
//     warpgroup 0 and dK in 1 with P^T handed over in shared memory, dQ
//     split by keys as in f32 (m64n32 scores, nothing crossing per tile).
//     What the layout is chosen for: the own rows are re-read from L2 for
//     every tile, so bf16 streams 64-row tiles (m64n64 scores for dK/dV),
//     which halves that traffic against 32-row ones and, at 32 KB a stage,
//     still leaves room for 4 stages beside 64 KB of chunk operands and
//     P^T (214,616 B for dK/dV); 128-row tiles would put 64 score f32 a
//     thread beside the 128 of the chunk, past the consumers' 224
//     registers (producer 56 + 2 * 224 = 504).
//   * A zero-filled row scores 0 and exp(0 - LSE) is not 0, so the masks
//     (causal, ragged, block) are applied on edge and partial tiles.
//
// The sweep policy says which block owns which rows, which streamed tiles it
// visits, in which order, and which consumer warpgroup computes each:
//   * dkv_block(), dq_block(): the owner block's index b (rows 128 b .., or
//     64 b .. for the 64-row blocks);
//   * dkv_count(b, T, own), dq_count(b, S, own): how many tiles it streams
//     (own: the rows a block owns, 128 or 64);
//   * dkv_step(b, it, own), dq_step(b, it, own): the it-th tile and its flags, bit w
//     (kVisit << w) when consumer warpgroup w computes it and bit 2 + w
//     (kPartial << w) when that pair is covered by the block mask in part.
//     A warpgroup that does not visit a streamed tile only releases it.  A
//     list sweep's step is read from device memory by the producer, which
//     stages it in shared memory with the tile; the dense sweep's is
//     arithmetic, computed where it is needed.
//   * kList: false for the dense sweep (flash_bwd.cu's DenseSweep); true for
//     a sweep over tile lists (block_sparse.cu's ListSweep), which also has
//     keep(q, k) (the block mask of a partial pair), live(b, it) (the
//     streamed rows that some row of the block attends, one bit a row) and
//     src_a / src_b (the streamed tensors).  A streamed tile with a partial
//     pair is staged by the producer's first warp instead of TMA: it copies
//     the live rows with 16-byte loads into the swizzled panel layout TMA
//     would give and writes zeros for the rest, so a dead row (NaN in K/V)
//     never reaches a product.
//
// Everything lives in an anonymous namespace, as in hopper_common.cuh.
#pragma once

#include "hopper_common.cuh"

namespace {

constexpr int kBwdThreads = kConsumers + 128;  // and one producer warpgroup
// registers per thread after the hand-over.  The launch gives 168 to each
// of the 384, and the consumers can take only what the producer gives
// back: (168 - P) * 4 warps >= (C - 168) * 8 warps, P + 2 C <= 504 (at
// 512 setmaxnreg.inc waits for ever).  The dK/dV consumers hold dK and dV
// (D f32) beside S^T and dP^T, so its producer keeps the least, 24 + 2 *
// 240, as does the 64-row dQ block's (D / 2 f32 of dQ beside S or dP);
// the 128-row dQ kernel's as K1's, 40 + 2 * 232.
constexpr int kDkvProducerRegs = 24;
constexpr int kDkvConsumerRegs = 240;
constexpr int kDqProducerRegs = 40;
constexpr int kDqConsumerRegs = 232;

// key rows a dK/dV block owns at head dim D: 128 up to D 128 (a consumer
// warpgroup keeps dK and dV of 64 rows, D f32 a thread), 64 at D 192 and
// 256 (warpgroup 0 keeps dV of all 64 rows, warpgroup 1 dK: D / 2 f32 a
// thread each, where dK and dV together, D a thread, would pass the 240
// registers a consumer has); in f32 64 at every D (dkv_f32_consume): its
// operands' three bf16 pieces take the bytes of bf16 at three times the
// head dim
template <int D, typename T = __nv_bfloat16>
constexpr int kDkvOwnRows = kIsBf16<T> && D <= 128 ? kBlockRows : kTileRows;

// dK/dV: the block's K and V rows, then the ring of (Q, dO, LSE, delta)
// tiles; at 64 own rows also the P^T tile that warpgroup 0 hands to 1 (f32).
// T is the operands' type.  TMA lands them in panels L (Panels<D, 4> in
// f32: *_LOAD bytes a tile), which the f32 kernel splits in place into
// three bf16 pieces (split_tile: pieces 1 and 2 where the f32 bytes lay,
// piece 3 after them; panels of the bf16 geometry, PANEL_KV and PANEL_T
// bytes each), so an f32 tile takes 6 bytes an element.  In f32 one stage
// at D 128 (209 KB), three below.  In f32 at D 192 and 256 (WIDE) the K
// and V rows stay f32 (4 bytes an element; split into registers per panel,
// wide_scores), the Q and dO tiles are of kWideRows rows, one stage, and
// P^T passes in the Q tile's third pieces, which only S^T reads (230,688 B
// at D 256).
template <int D, typename T = __nv_bfloat16>
struct DkvCfg : Panels<D> {
  using L = Panels<D, sizeof(T)>;
  static constexpr bool WIDE = !kIsBf16<T> && D > 128;
  static constexpr int OWN = kDkvOwnRows<D, T>;
  static constexpr int ELEM = kIsBf16<T> ? 2 : 6;   // bytes an element takes in shared memory
  static constexpr int TILE_ROWS = WIDE ? kWideRows : kTileRows;   // rows of a Q or dO tile
  static constexpr int STAGES = !kIsBf16<T> ? (D <= 64 ? 3 : 1)
                                : OWN == kBlockRows || D <= 192 ? 3 : 2;
  static constexpr int KV_LOAD = OWN * D * (int)sizeof(T);   // the K or the V rows
  static constexpr int KV_BYTES = OWN * D * (WIDE ? 4 : ELEM);
  static constexpr int PANEL_KV = OWN * Panels<D>::RB;
  static constexpr int LPANEL_KV = OWN * L::RB;
  static constexpr int TILE_LOAD = TILE_ROWS * D * (int)sizeof(T);   // one Q or dO tile
  static constexpr int TILE_BYTES = TILE_ROWS * D * ELEM;
  static constexpr int PANEL_T = TILE_ROWS * Panels<D>::RB;
  static constexpr int LPANEL_T = TILE_ROWS * L::RB;
  static constexpr int PT_BYTES = OWN == kTileRows && !WIDE ? kTileRows * kTileRows * 4 : 0;
  static constexpr size_t SMEM = 1024 + 2 * KV_BYTES + STAGES * (2 * TILE_BYTES) + PT_BYTES
                                 + STAGES * 2 * TILE_ROWS * sizeof(float)
                                 + sizeof(uint64_t) * (1 + 2 * STAGES)
                                 + STAGES * sizeof(Step);
  static_assert(!WIDE || (D <= 256 && kTileRows * TILE_ROWS * 4 <= TILE_ROWS * D * 2),
                "the wide f32 dK/dV hands P^T over in a Q tile's third pieces");
};

// named barriers of the 64-row dK/dV block (1 and 2 are the consumers'
// epilogue barriers, and in f32 each warpgroup's barrier of its splits):
// P^T written by warpgroup 0, read by warpgroup 1; in f32 also dO split by
// warpgroup 1, read by warpgroup 0
constexpr int kPtFull = 3;
constexpr int kPtEmpty = 4;
constexpr int kDoSplit = 7;

// query rows a dQ block owns at head dim D: 128 up to D 128, 64 at D 192
// and 256 (dQ of 128 rows would take D f32 a consumer thread, and Q and dO
// of 128 rows beside two K/V stages more shared memory than a block has);
// in f32 64 at every D (dq_f32_consume), as for dK/dV
template <int D, typename T = __nv_bfloat16>
constexpr int kDqOwnRows = kIsBf16<T> && D <= 128 ? kBlockRows : kTileRows;

// dQ: the block's Q and dO rows, then the ring of (K, V) tiles; at 64 own
// rows in bf16 also the dS panel that warpgroup 1 hands to both (bf16,
// swizzled as TMA would load it) and the P tile that warpgroup 0 hands to 1
// (f32).  T is the operands' type: in f32 TMA lands them in panels L
// (Panels<D, 4>, *_LOAD bytes), split in place into three bf16 pieces as
// in DkvCfg (6 bytes an element), and K and V have barriers of their own
// (KV_BARS), so the next V lands while dS . K still reads K.  In f32 one
// stage at D 128 (197,680 B), three at D 64, four below.  In f32 at D 192
// and 256 (WIDE) the Q and dO rows stay f32 (split into registers per
// panel, wide_scores) and the K and V tiles are of kWideRows rows, one
// stage (230,448 B at D 256).
template <int D, typename T = __nv_bfloat16>
struct DqCfg : Panels<D> {
  using L = Panels<D, sizeof(T)>;
  static constexpr bool F32 = !kIsBf16<T>;
  static constexpr bool WIDE = F32 && D > 128;
  static constexpr int OWN = kDqOwnRows<D, T>;
  static constexpr int ELEM = F32 ? 6 : 2;   // bytes an element takes in shared memory
  static constexpr int TILE_ROWS = WIDE ? kWideRows : kTileRows;   // rows of a K or V tile
  static constexpr int STAGES = F32 ? (D <= 32 ? 4 : D <= 64 ? 3 : 1)
                                : OWN == kBlockRows ? 4 : D <= 192 ? 3 : 2;
  static constexpr int Q_BYTES = OWN * D * (WIDE ? 4 : ELEM);   // the Q or the dO rows
  static constexpr int Q_LOAD = OWN * D * (int)sizeof(T);
  static constexpr int PANEL_Q = OWN * Panels<D>::RB;
  static constexpr int LPANEL_Q = OWN * L::RB;
  static constexpr int TILE_BYTES = TILE_ROWS * D * ELEM;  // one K or V tile
  static constexpr int TILE_LOAD = TILE_ROWS * D * (int)sizeof(T);
  static constexpr int PANEL_T = TILE_ROWS * Panels<D>::RB;
  static constexpr int LPANEL_T = TILE_ROWS * L::RB;
  static constexpr bool HANDOVER = !F32 && OWN == kTileRows;   // dq_split_consume's P and dS
  static constexpr int DS_BYTES = HANDOVER ? kTileRows * kTileRows * 2 : 0;
  static constexpr int PT_BYTES = HANDOVER ? kTileRows * kTileRows * 4 : 0;
  static constexpr int KV_BARS = F32 ? 2 : 1;   // (full, empty) pairs a stage
  static constexpr int PRODUCER_REGS = OWN == kBlockRows ? kDqProducerRegs : kDkvProducerRegs;
  static constexpr int CONSUMER_REGS = OWN == kBlockRows ? kDqConsumerRegs : kDkvConsumerRegs;
  static constexpr size_t SMEM = 1024 + 2 * Q_BYTES + STAGES * 2 * TILE_BYTES + DS_BYTES
                                 + PT_BYTES + sizeof(uint64_t) * (1 + 2 * KV_BARS * STAGES)
                                 + STAGES * sizeof(Step);
};

// named barriers of the 64-row dQ block (1 is warpgroup 0's epilogue
// barrier; kPtFull as above): dS written by warpgroup 1, read by both;
// both warpgroups' sums of dQ meet; in f32 each K and V tile split by both
// warpgroups together (1 and 2 are then each warpgroup's barrier of its
// Q or dO split)
constexpr int kDsFull = 5;
constexpr int kDqSum = 6;
constexpr int kDqSplit = 8;

// acc (m64 x D f32) += A . B over kSteps k16 steps, A from a 64 x 64 bf16
// K-major panel at `a` (128-byte rows, as TMA swizzles them) and B the
// tile at `b` (panel pitch kPanelB) read MN-major, both in shared memory:
// `a` and `b` sit at the first step's keys.  Issued, not waited.
template <int D, int kPanelB, int kSteps>
__device__ __forceinline__ void wgmma_accumulate_ss(float* acc, const unsigned char* a,
                                                    const unsigned char* b) {
  using P = Panels<D>;
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int p = 0; p < P::NP; ++p)
      wgmma_ss<P::PW, 1>(acc + p * (P::PW / 2), smem_desc<128>(a + 32 * kk),
                         smem_desc<P::RB>(b + p * kPanelB + 16 * P::RB * kk), 1);
}

// A consumer warpgroup of the dK/dV kernel: key rows k0w .. k0w + 63; this
// thread holds rows key0 and key0 + 8 of each accumulator
// (hopper_common.cuh), whose columns are the tile's query rows.
template <int D, class Sweep>
__device__ __forceinline__ void dkv_consume(const Sweep& sw, unsigned char* k_s,
                                            unsigned char* v_s, const unsigned char* q_s,
                                            const unsigned char* do_s, const float* lse_s,
                                            const float* delta_s, const Step* step_s,
                                            uint64_t* kv_full, uint64_t* full, uint64_t* empty,
                                            __nv_bfloat16* __restrict__ dk,
                                            __nv_bfloat16* __restrict__ dv, int b, int n,
                                            int T_len, int S_len, float scale_log2,
                                            float sm_scale, int causal) {
  using C = DkvCfg<D>;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int k0w = b * kBlockRows + 64 * wg;
  const int key0 = k0w + 16 * warp + lane / 4;
  unsigned char* k_wg = k_s + 64 * wg * C::RB;
  unsigned char* v_wg = v_s + 64 * wg * C::RB;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk_acc[i] = 0.0f;
    dv_acc[i] = 0.0f;
  }

  if (n > 0) mbar_wait(kv_full, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % C::STAGES;
    Step step;
    if constexpr (!Sweep::kList) step = sw.dkv_step(b, it, kBlockRows);
    mbar_wait(&full[s], (it / C::STAGES) & 1);
    if constexpr (Sweep::kList) step = step_s[s];   // staged by the producer
    if (step.flags & (kVisit << wg)) {
      const int q0 = step.tile * kTileRows;
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
      // log2 e.  Only a diagonal, ragged or partial tile pays for the mask.
      const bool part = Sweep::kList && (step.flags & (kPartial << wg));
      const bool edge = part || q0 + kTileRows > T_len || (causal && q0 < k0w + 63);
      // The masks run in loops of their own behind branches per tile: a
      // test inside the exponentials' loop is not predicated but branched
      // element by element, on every tile.  Element i is query row q0 + c,
      // c = 8 (i / 4) + 2 t + (i & 1), and key row key0 + 8 ((i >> 1) & 1).
#pragma unroll
      for (int i = 0; i < kTileRows / 2; ++i)
        st[i] = exp2f(fmaf(st[i], scale_log2, -lse_t[8 * (i / 4) + 2 * t + (i & 1)]));
      if (edge) {
#pragma unroll
        for (int i = 0; i < kTileRows / 2; ++i) {
          const int q = q0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int key = key0 + 8 * ((i >> 1) & 1);
          if (q >= T_len || (causal && key > q)) st[i] = 0.0f;
        }
        if constexpr (Sweep::kList) {
          if (part) {
#pragma unroll
            for (int i = 0; i < kTileRows / 2; ++i) {
              const int q = q0 + 8 * (i / 4) + 2 * t + (i & 1);
              const int key = key0 + 8 * ((i >> 1) & 1);
              if (q < T_len && (key >= S_len || !sw.keep(q, key))) st[i] = 0.0f;
            }
          }
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kTileRows / 2; ++i) fence_regs(dpt[i]);
      // a killed element's dP^T may be NaN (a dead key row of V): where P^T
      // is 0, dP^T is replaced by delta, so that dS^T is 0 by select
      if (edge) {
#pragma unroll
        for (int i = 0; i < kTileRows / 2; ++i)
          dpt[i] = st[i] == 0.0f ? delta_t[8 * (i / 4) + 2 * t + (i & 1)] : dpt[i];
      }
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

// The two consumer warpgroups of the dK/dV kernel at D 192 and 256, over the
// block's 64 key rows k0 .. k0 + 63 (this thread holds rows key0 and key0 +
// 8 of each accumulator, whose columns are the tile's query rows).  Each
// streamed tile takes two products a warpgroup, all on registers as A:
//   warpgroup 0: S^T = K . Q^T, P^T = exp(S^T - LSE) masked, P^T in f32 to
//     shared memory for warpgroup 1, then dV += P^T . dO;
//   warpgroup 1: dP^T = V . dO^T, then, with P^T from warpgroup 0, dS^T =
//     P^T * (dP^T - delta) as K2's 128-row consumer forms it, and dK +=
//     dS^T . Q.
// P^T passes through one f32 tile guarded by two named barriers: kPtFull
// (warpgroup 0 arrives after writing, 1 syncs before reading) and kPtEmpty
// (1 arrives after reading, 0 syncs before writing the next; both skip the
// unmatched end).  Every list entry and dense step is visited by the whole
// block: a 64-row key tile is one owner, so the step flags' visit bits are
// not read.  Warpgroup 0 alone reads K and 1 alone V, so each stages its
// result in that tile for the epilogue.
template <int D, class Sweep>
__device__ __forceinline__ void dkv_split_consume(const Sweep& sw, unsigned char* k_s,
                                                  unsigned char* v_s, const unsigned char* q_s,
                                                  const unsigned char* do_s, float* pt_s,
                                                  const float* lse_s, const float* delta_s,
                                                  const Step* step_s, uint64_t* kv_full,
                                                  uint64_t* full, uint64_t* empty,
                                                  __nv_bfloat16* __restrict__ dk,
                                                  __nv_bfloat16* __restrict__ dv, int b, int n,
                                                  int T_len, int S_len, float scale_log2,
                                                  float sm_scale, int causal) {
  using C = DkvCfg<D>;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int k0 = b * kTileRows;
  const int key0 = k0 + 16 * warp + lane / 4;

  float acc[D / 2];   // dV (warpgroup 0) or dK (1): 64 x D
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  if (n > 0) mbar_wait(kv_full, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % C::STAGES;
    Step step;
    if constexpr (!Sweep::kList) step = sw.dkv_step(b, it, kTileRows);
    mbar_wait(&full[s], (it / C::STAGES) & 1);
    if constexpr (Sweep::kList) step = step_s[s];   // staged by the producer
    const int q0 = step.tile * kTileRows;
    const unsigned char* q_t = q_s + s * C::TILE_BYTES;
    const unsigned char* do_t = do_s + s * C::TILE_BYTES;
    const float* lse_t = lse_s + s * kTileRows;
    const float* delta_t = delta_s + s * kTileRows;
    const bool part = Sweep::kList && (step.flags & kPartial);
    const bool edge = part || q0 + kTileRows > T_len || (causal && q0 < k0 + 63);
    float sc[kTileRows / 2];
    uint32_t a[kTileRows / 4];
    // S^T = K . Q^T (warpgroup 0), dP^T = V . dO^T (1).  The products
    // take their operands by warpgroup, not in branches: a wgmma on a
    // divergent path is serialised (ptxas C7520).
    wgmma_fence();
    wgmma_scores<D, C::PANEL_KV, C::PANEL_T>(sc, wg == 0 ? k_s : v_s, wg == 0 ? q_t : do_t);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kTileRows / 2; ++i) fence_regs(sc[i]);

    if (wg == 0) {
      // P^T, masked as K2's consumer masks it (element i: query row q0 + c,
      // c = 8 (i / 4) + 2 t + (i & 1), key row key0 + 8 ((i >> 1) & 1))
#pragma unroll
      for (int i = 0; i < kTileRows / 2; ++i)
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -lse_t[8 * (i / 4) + 2 * t + (i & 1)]));
      if (edge) {
#pragma unroll
        for (int i = 0; i < kTileRows / 2; ++i) {
          const int q = q0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int key = key0 + 8 * ((i >> 1) & 1);
          if (q >= T_len || (causal && key > q)) sc[i] = 0.0f;
        }
        if constexpr (Sweep::kList) {
          if (part) {
#pragma unroll
            for (int i = 0; i < kTileRows / 2; ++i) {
              const int q = q0 + 8 * (i / 4) + 2 * t + (i & 1);
              const int key = key0 + 8 * ((i >> 1) & 1);
              if (q < T_len && (key >= S_len || !sw.keep(q, key))) sc[i] = 0.0f;
            }
          }
        }
      }
      if (it > 0) named_barrier_sync(kPtEmpty, kConsumers);
#pragma unroll
      for (int i = 0; i < kTileRows / 2; ++i) pt_s[i * 128 + tid] = sc[i];
      named_barrier_arrive(kPtFull, kConsumers);
#pragma unroll
      for (int i = 0; i < kTileRows / 4; ++i) a[i] = pack_bf16x2(sc[2 * i], sc[2 * i + 1]);
    } else {
      named_barrier_sync(kPtFull, kConsumers);
      // dS^T = P^T * (dP^T - delta) in bf16; where P^T is 0 on an edge or
      // partial tile, dP^T (NaN from a dead key row of V) is replaced by
      // delta first, so that dS^T is 0 by select
#pragma unroll
      for (int i = 0; i < kTileRows / 4; ++i) {
        const int c = 8 * (i / 2) + 2 * t;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = pt_s[(2 * i + e) * 128 + tid];
          const float dp = edge && p == 0.0f ? delta_t[c + e] : sc[2 * i + e];
          ds[e] = p * (dp - delta_t[c + e]);
        }
        a[i] = pack_bf16x2(ds[0], ds[1]);
      }
      if (it + 1 < n) named_barrier_arrive(kPtEmpty, kConsumers);
    }
    // dV += P^T . dO (warpgroup 0), dK += dS^T . Q (1)
    wgmma_fence();
    wgmma_accumulate<D, C::PANEL_T>(acc, a, wg == 0 ? do_t : q_t);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_regs(acc[i]);
    mbar_arrive(&empty[s]);
  }

  // epilogue: dV (warpgroup 0) in the K rows, dK * sm_scale (1) in the V rows
  unsigned char* rows = wg == 0 ? k_s : v_s;
  stage_rows<D, C::PANEL_KV>(rows, acc, wg == 0 ? 1.0f : sm_scale);
  named_barrier_sync(1 + wg, 128);
  store_rows<D, C::PANEL_KV>(rows, wg == 0 ? dv : dk, k0, S_len);
}

// The it-th streamed tile of a sweep whose steps are 64-row tiles, each
// streamed as kSub tiles of 64 / kSub rows (the wide f32 blocks' 32-row
// tiles: kSub 2), from the step of its 64-row tile: its index among the
// streamed tiles, its flags those of the step.
template <int kSub>
__device__ __forceinline__ Step sub_step(Step step, int it) {
  if constexpr (kSub > 1) step.tile = step.tile * kSub + it % kSub;
  return step;
}

// The two consumer warpgroups of the f32 dK/dV kernel, over the block's 64
// key rows: dkv_split_consume's split of the work (warpgroup 0 S^T, P^T
// and dV; warpgroup 1 dP^T, dS^T and dK; P^T handed over in f32), every
// product of f32 operands formed from bf16 products on the operands' bf16
// pieces (hopper_common.cuh): six for S^T and dP^T (three pieces a side),
// five for dV and dK (P^T and dS^T in three pieces, dO and Q in their
// first two).  The f32 tiles are split in place, each by the warpgroup
// whose scores read it first: warpgroup 0 splits K once and each Q tile,
// warpgroup 1 V and each dO tile.  P^T and dS^T are split in registers.
// Besides kPtFull and kPtEmpty one named barrier orders the splits between
// warpgroups: kDoSplit (warpgroup 1 arrives after it has read P^T, 0 syncs
// before dV += P^T . dO); Q, split by warpgroup 0 before it hands P^T
// over, is ready when warpgroup 1 passes kPtFull.  Arriving only after
// kPtFull, warpgroup 1 cannot arrive twice on kDoSplit before warpgroup 0
// has synced once.  dK and dV leave in f32 straight from the accumulators.
// At D 192 and 256 (C::WIDE) K and V stay f32: each warpgroup splits its
// own operand into registers 32 columns at a time for every 32-row Q or dO
// tile, a fresh partial of S^T or dP^T per k16 step (wide_scores); P^T passes
// in the Q tile's third pieces, which S^T alone reads and warpgroup 0's
// split of the next Q tile overwrites only after the stage's release (one
// stage), so kPtEmpty is not used.
template <int D, class Sweep>
__device__ __forceinline__ void dkv_f32_consume(const Sweep& sw, unsigned char* k_s,
                                                unsigned char* v_s, unsigned char* q_s,
                                                unsigned char* do_s, float* pt_s,
                                                const float* lse_s, const float* delta_s,
                                                const Step* step_s, uint64_t* kv_full,
                                                uint64_t* full, uint64_t* empty,
                                                float* __restrict__ dk, float* __restrict__ dv,
                                                int b, int n, int T_len, int S_len,
                                                float scale_log2, float sm_scale, int causal) {
  using C = DkvCfg<D, float>;
  constexpr int TR = C::TILE_ROWS;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int k0 = b * kTileRows;
  const int key0 = k0 + 16 * warp + lane / 4;

  float acc[D / 2];   // dV (warpgroup 0) or dK (1): 64 x D
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  if (n > 0) {
    mbar_wait(kv_full, 0);
    if constexpr (!C::WIDE) {
      split_tile<D>(wg == 0 ? k_s : v_s, 1 + wg);   // each warpgroup's own operand
      fence_proxy_async();
      named_barrier_sync(1 + wg, 128);
    }
  }
  for (int it = 0; it < n; ++it) {
    const int s = it % C::STAGES;
    Step step;
    if constexpr (!Sweep::kList)
      step = sub_step<kTileRows / TR>(sw.dkv_step(b, it / (kTileRows / TR), kTileRows), it);
    mbar_wait(&full[s], (it / C::STAGES) & 1);
    if constexpr (Sweep::kList) step = step_s[s];   // staged by the producer
    const int q0 = step.tile * TR;
    unsigned char* q_t = q_s + s * C::TILE_BYTES;
    unsigned char* do_t = do_s + s * C::TILE_BYTES;
    const float* lse_t = lse_s + s * TR;
    const float* delta_t = delta_s + s * TR;
    const bool part = Sweep::kList && (step.flags & kPartial);
    const bool edge = part || q0 + TR > T_len || (causal && q0 < k0 + 63);
    split_tile<D, 128, TR>(wg == 0 ? q_t : do_t, 1 + wg);
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);
    float sc[TR / 2];
    uint32_t a1[TR / 4], a2[TR / 4], a3[TR / 4];
    // S^T = K . Q^T (warpgroup 0), dP^T = V . dO^T (1), operands chosen by
    // warpgroup, as in dkv_split_consume
    if constexpr (C::WIDE) {
      wide_scores<D, kWideRows, true>(sc, wg == 0 ? k_s : v_s, wg == 0 ? q_t : do_t);
    } else {
      wgmma_fence();
      wgmma_scores_split<D, C::PANEL_KV, C::PANEL_T, kTileRows * D * 4>(
          sc, wg == 0 ? k_s : v_s, wg == 0 ? q_t : do_t);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kTileRows / 2; ++i) fence_regs(sc[i]);
    }
    // P^T in f32 for warpgroup 1: its own buffer, or at D 192 and 256 the
    // Q tile's third pieces (S^T has read them)
    float* pt = C::WIDE ? reinterpret_cast<float*>(q_t + TR * D * 4) : pt_s;

    if (wg == 0) {
      // P^T, masked as dkv_split_consume masks it
#pragma unroll
      for (int i = 0; i < TR / 2; ++i)
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -lse_t[8 * (i / 4) + 2 * t + (i & 1)]));
      if (edge) {
#pragma unroll
        for (int i = 0; i < TR / 2; ++i) {
          const int q = q0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int key = key0 + 8 * ((i >> 1) & 1);
          if (q >= T_len || (causal && key > q)) sc[i] = 0.0f;
        }
        if constexpr (Sweep::kList) {
          if (part) {
#pragma unroll
            for (int i = 0; i < TR / 2; ++i) {
              const int q = q0 + 8 * (i / 4) + 2 * t + (i & 1);
              const int key = key0 + 8 * ((i >> 1) & 1);
              if (q < T_len && (key >= S_len || !sw.keep(q, key))) sc[i] = 0.0f;
            }
          }
        }
      }
      if constexpr (!C::WIDE) {
        if (it > 0) named_barrier_sync(kPtEmpty, kConsumers);
      }
#pragma unroll
      for (int i = 0; i < TR / 2; ++i) pt[i * 128 + tid] = sc[i];
      named_barrier_arrive(kPtFull, kConsumers);
#pragma unroll
      for (int i = 0; i < TR / 4; ++i)
        split_bf16x3(sc[2 * i], sc[2 * i + 1], a1[i], a2[i], a3[i]);
      named_barrier_sync(kDoSplit, kConsumers);
    } else {
      named_barrier_sync(kPtFull, kConsumers);
      named_barrier_arrive(kDoSplit, kConsumers);
      // dS^T = P^T * (dP^T - delta); where P^T is 0 on an edge or partial
      // tile, dP^T (NaN from a dead key row of V) is replaced by delta
      // first, so that dS^T is 0 by select
#pragma unroll
      for (int i = 0; i < TR / 4; ++i) {
        const int c = 8 * (i / 2) + 2 * t;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = pt[(2 * i + e) * 128 + tid];
          const float dp = edge && p == 0.0f ? delta_t[c + e] : sc[2 * i + e];
          ds[e] = p * (dp - delta_t[c + e]);
        }
        split_bf16x3(ds[0], ds[1], a1[i], a2[i], a3[i]);
      }
      if constexpr (!C::WIDE) {
        if (it + 1 < n) named_barrier_arrive(kPtEmpty, kConsumers);
      }
    }
    // dV += P^T . dO (warpgroup 0), dK += dS^T . Q (1)
    wgmma_fence();
    wgmma_accumulate_split<D, C::PANEL_T, 0, TR / 16>(acc, a1, a2, a3, wg == 0 ? do_t : q_t);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_regs(acc[i]);
    mbar_arrive(&empty[s]);
  }

  // epilogue: dV (warpgroup 0) or dK * sm_scale (1) in f32, two columns a
  // store (element 4 j + 2 h of panel p: row key0 + 8 h, column p PW + 8 j
  // + 2 t)
  using P = Panels<D>;
  float* out = wg == 0 ? dv : dk;
  const float scale = wg == 0 ? 1.0f : sm_scale;
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int j = 0; j < P::PW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = key0 + 8 * h;
        const float* a = acc + p * (P::PW / 2) + 4 * j + 2 * h;
        if (row < S_len)
          *reinterpret_cast<float2*>(out + (size_t)row * D + p * P::PW + 8 * j + 2 * t) =
              make_float2(a[0] * scale, a[1] * scale);
      }
}

// The dK/dV block over operands of type T (bf16, or f32 on the split
// products of dkv_f32_consume): grid (B*H, ceil(S / own rows)); the sweep
// maps blockIdx.y to a block.  The sweep's steps are 64-row tiles, streamed
// as kSub tiles of C::TILE_ROWS rows each (2 in f32 at D 192 and 256).  The
// kernels below pass their tensor maps' addresses.
template <int D, class Sweep, typename T>
__device__ __forceinline__ void bwd_dkv_body(const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                             const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta, T* __restrict__ dk,
                                             T* __restrict__ dv, int T_len, int S_len,
                                             float scale_log2, float sm_scale, int causal, int H,
                                             int h0, const Sweep& sw) {
  using C = DkvCfg<D, T>;
  using L = typename C::L;   // TMA's panels
  constexpr int TR = C::TILE_ROWS;
  constexpr int kSub = kTileRows / TR;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s = align1024(smem_raw);             // [panel][own rows]
  unsigned char* v_s = k_s + C::KV_BYTES;
  unsigned char* q_s = v_s + C::KV_BYTES;               // [stage][panel][TR rows]
  unsigned char* do_s = q_s + C::STAGES * C::TILE_BYTES;
  float* pt_s = reinterpret_cast<float*>(do_s + C::STAGES * C::TILE_BYTES);  // 64 own rows
  float* lse_s = pt_s + C::PT_BYTES / 4;                // [stage][TR]
  float* delta_s = lse_s + C::STAGES * TR;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(delta_s + C::STAGES * TR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + C::STAGES;
  Step* step_s = reinterpret_cast<Step*>(empty + C::STAGES);   // [stage], list sweeps

  const int bh = h0 + blockIdx.x;   // of the B*H heads; TMA reads head h of batch bb
  const int h = bh % H, bb = bh / H;
  const int b = sw.dkv_block();
  const int k0 = b * C::OWN;
  const int n = sw.dkv_count(b, T_len, C::OWN) * kSub;   // 0: dK = dV = 0

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
    // the producer's first warp: lane 0 issues the loads, each lane stages
    // two rows' LSE and delta of a tile and arrives on its barrier
    if (threadIdx.x < kConsumers + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0 && n > 0) {
        mbar_arrive_expect_tx(kv_full, 2 * C::KV_LOAD);
        for (int p = 0; p < L::NP; ++p) {
          tma_load_4d(k_s + p * C::LPANEL_KV, tm_k, kv_full, p * L::PW, k0, h, bb);
          tma_load_4d(v_s + p * C::LPANEL_KV, tm_v, kv_full, p * L::PW, k0, h, bb);
        }
      }
      const float* lse_h = lse + (size_t)bh * T_len;
      const float* delta_h = delta + (size_t)bh * T_len;
      for (int it = 0; it < n; ++it) {
        const int s = it % C::STAGES;
        const Step step = sub_step<kSub>(sw.dkv_step(b, it / kSub, C::OWN), it);
        const int q0 = step.tile * TR;
        mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);   // the first round passes
        for (int c = lane; c < TR; c += 32) {
          const bool in = q0 + c < T_len;
          lse_s[s * TR + c] = (in ? lse_h[q0 + c] : BIG_LSE) * kLog2e;
          delta_s[s * TR + c] = in ? delta_h[q0 + c] : 0.0f;
        }
        if constexpr (Sweep::kList) {
          if (lane == 0) step_s[s] = step;
          if (step.flags & kPartialAny) {   // a partial pair: live rows only
            const unsigned long long live = sw.live(b, it / kSub) >> (TR * (it % kSub));
            stage_live_rows<D, C::LPANEL_T, T, TR>(q_s + s * C::TILE_BYTES,
                                                   sw.src_a + sw.stride_a.head(bh, H),
                                                   sw.stride_a.r, q0, T_len, live, lane);
            stage_live_rows<D, C::LPANEL_T, T, TR>(do_s + s * C::TILE_BYTES,
                                                   sw.src_b + sw.stride_b.head(bh, H),
                                                   sw.stride_b.r, q0, T_len, live, lane);
            fence_proxy_async();
            mbar_arrive(&full[s]);
            continue;
          }
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * C::TILE_LOAD);
          for (int p = 0; p < L::NP; ++p) {
            const int off = s * C::TILE_BYTES + p * C::LPANEL_T;
            tma_load_4d(q_s + off, tm_q, &full[s], p * L::PW, q0, h, bb);
            tma_load_4d(do_s + off, tm_do, &full[s], p * L::PW, q0, h, bb);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<kDkvConsumerRegs>();
    T* dk_h = dk + (size_t)bh * S_len * D;
    T* dv_h = dv + (size_t)bh * S_len * D;
    if constexpr (!kIsBf16<T>)
      dkv_f32_consume<D>(sw, k_s, v_s, q_s, do_s, pt_s, lse_s, delta_s, step_s, kv_full, full,
                         empty, dk_h, dv_h, b, n, T_len, S_len, scale_log2, sm_scale, causal);
    else if constexpr (C::OWN == kBlockRows)
      dkv_consume<D>(sw, k_s, v_s, q_s, do_s, lse_s, delta_s, step_s, kv_full, full, empty,
                     dk_h, dv_h, b, n, T_len, S_len, scale_log2, sm_scale, causal);
    else
      dkv_split_consume<D>(sw, k_s, v_s, q_s, do_s, pt_s, lse_s, delta_s, step_s, kv_full, full,
                           empty, dk_h, dv_h, b, n, T_len, S_len, scale_log2, sm_scale, causal);
  }
}

// dK/dV in bf16 (K2, K7)
template <int D, class Sweep>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                     const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int T_len, int S_len, float scale_log2,
                     float sm_scale, int causal, int H, int h0, const Sweep sw) {
  bwd_dkv_body<D>(&tm_q, &tm_do, &tm_k, &tm_v, lse, delta, dk, dv, T_len, S_len, scale_log2,
                  sm_scale, causal, H, h0, sw);
}

// dK/dV in f32 (K2, K7), each product from bf16 products on three bf16
// pieces of its operands
template <int D, class Sweep>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_dkv_split_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int T_len, int S_len, float scale_log2,
                     float sm_scale, int causal, int H, int h0, const Sweep sw) {
  bwd_dkv_body<D>(&tm_q, &tm_do, &tm_k, &tm_v, lse, delta, dk, dv, T_len, S_len, scale_log2,
                  sm_scale, causal, H, h0, sw);
}

// A consumer warpgroup of the dQ kernel: query rows q0w .. q0w + 63; this
// thread holds rows row0 and row0 + 8 of each accumulator.
template <int D, class Sweep>
__device__ __forceinline__ void dq_consume(const Sweep& sw, unsigned char* q_s,
                                           const unsigned char* do_s, const unsigned char* k_s,
                                           const unsigned char* v_s, const Step* step_s,
                                           uint64_t* q_full,
                                           uint64_t* full, uint64_t* empty,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           __nv_bfloat16* __restrict__ dq, int b, int n,
                                           int T_len, int S_len, float scale_log2,
                                           float sm_scale, int causal) {
  using C = DqCfg<D>;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int q0w = b * kBlockRows + 64 * wg;
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

  if (n > 0) mbar_wait(q_full, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % C::STAGES;
    Step step;
    if constexpr (!Sweep::kList) step = sw.dq_step(b, it, kBlockRows);
    mbar_wait(&full[s], (it / C::STAGES) & 1);
    if constexpr (Sweep::kList) step = step_s[s];   // staged by the producer
    if (step.flags & (kVisit << wg)) {
      const int k0 = step.tile * kTileRows;
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
      const bool part = Sweep::kList && (step.flags & (kPartial << wg));
      const bool edge =
          part || k0 + kTileRows > S_len || (causal && k0 + kTileRows - 1 > q0w);
      // the masks in loops of their own, as in the dK/dV kernel; element i
      // is query row row0 + 8 ((i >> 1) & 1), key column k0 + 8 (i / 4) +
      // 2 t + (i & 1)
#pragma unroll
      for (int i = 0; i < kTileRows / 2; ++i)
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -lse_r[(i >> 1) & 1]));
      if (edge) {
#pragma unroll
        for (int i = 0; i < kTileRows / 2; ++i) {
          const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          if (col >= S_len || (causal && col > row0 + 8 * ((i >> 1) & 1))) sc[i] = 0.0f;
        }
        if constexpr (Sweep::kList) {
          if (part) {
#pragma unroll
            for (int i = 0; i < kTileRows / 2; ++i) {
              const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
              const int row = row0 + 8 * ((i >> 1) & 1);
              if (col < S_len && (row >= T_len || !sw.keep(row, col))) sc[i] = 0.0f;
            }
          }
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kTileRows / 2; ++i) fence_regs(dp[i]);
      // where P is 0, dP is replaced by delta, so that dS is 0 by select
      if (edge) {
#pragma unroll
        for (int i = 0; i < kTileRows / 2; ++i)
          dp[i] = sc[i] == 0.0f ? delta_r[(i >> 1) & 1] : dp[i];
      }
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

// The two consumer warpgroups of the dQ kernel at D 192 and 256, over the
// block's 64 query rows q0 .. q0 + 63 (this thread holds rows row0 and
// row0 + 8 of each accumulator).  Each streamed K/V tile takes two
// products a warpgroup, both issued with operands chosen by warpgroup (a
// wgmma on a divergent path is serialised, ptxas C7520):
//   warpgroup 0: S = Q . K^T, P = exp(S - LSE) masked as K3's 128-row
//     consumer masks it, P in f32 to shared memory for warpgroup 1;
//   warpgroup 1: dP = dO . V^T, then, with P from warpgroup 0, dS = P *
//     (dP - delta) as K3's 128-row consumer forms it, in bf16 into a
//     swizzled 64 x 64 panel;
//   both: dQ += dS . K over half of the tile's keys, warpgroup w keys
//     32 w .. 32 w + 31, dS read from the panel.
// Split by keys, both warpgroups keep D / 2 f32 of dQ (all of its columns)
// and issue the same products; split by columns, D 192 would not halve
// into 64-column panels.  The two sums meet once, at the end, in the
// drained ring.  Two named barriers order the hand-overs: kPtFull (0
// arrives after writing P, 1 syncs before reading it) and kDsFull (1
// arrives after writing dS, 0 syncs before its product).  Each also frees
// the other buffer: 0 writes the next P only after kDsFull, which 1
// passes after reading P, and 1 writes the next dS only after the next
// kPtFull, which 0 passes after its product has read dS.  Every list
// entry and dense step is visited by the whole block (one 64-row query
// tile), so the step flags' visit bits are not read.
template <int D, class Sweep>
__device__ __forceinline__ void dq_split_consume(const Sweep& sw, unsigned char* q_s,
                                                 const unsigned char* do_s, unsigned char* k_s,
                                                 const unsigned char* v_s, unsigned char* ds_s,
                                                 float* pt_s, const Step* step_s,
                                                 uint64_t* q_full, uint64_t* full,
                                                 uint64_t* empty, const float* __restrict__ lse,
                                                 const float* __restrict__ delta,
                                                 __nv_bfloat16* __restrict__ dq, int b, int n,
                                                 int T_len, int S_len, float scale_log2,
                                                 float sm_scale, int causal) {
  using C = DqCfg<D>;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int q0 = b * kTileRows;
  const int row0 = q0 + 16 * warp + lane / 4;

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
  float acc[D / 2];   // this warpgroup's keys' share of dQ: 64 x D
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  if (n > 0) mbar_wait(q_full, 0);
  for (int it = 0; it < n; ++it) {
    const int s = it % C::STAGES;
    Step step;
    if constexpr (!Sweep::kList) step = sw.dq_step(b, it, kTileRows);
    mbar_wait(&full[s], (it / C::STAGES) & 1);
    if constexpr (Sweep::kList) step = step_s[s];   // staged by the producer
    const int k0 = step.tile * kTileRows;
    const unsigned char* k_t = k_s + s * C::TILE_BYTES;
    const unsigned char* v_t = v_s + s * C::TILE_BYTES;
    const bool part = Sweep::kList && (step.flags & kPartial);
    const bool edge =
        part || k0 + kTileRows > S_len || (causal && k0 + kTileRows - 1 > q0);
    float sc[kTileRows / 2];
    // S = Q . K^T (warpgroup 0), dP = dO . V^T (1)
    wgmma_fence();
    wgmma_scores<D, C::PANEL_Q, C::PANEL_T>(sc, wg == 0 ? q_s : do_s, wg == 0 ? k_t : v_t);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kTileRows / 2; ++i) fence_regs(sc[i]);

    if (wg == 0) {
      // P = exp(S * scale - LSE), the masks in loops of their own; element
      // i is query row row0 + 8 ((i >> 1) & 1), key column k0 + 8 (i / 4) +
      // 2 t + (i & 1)
#pragma unroll
      for (int i = 0; i < kTileRows / 2; ++i)
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -lse_r[(i >> 1) & 1]));
      if (edge) {
#pragma unroll
        for (int i = 0; i < kTileRows / 2; ++i) {
          const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          if (col >= S_len || (causal && col > row0 + 8 * ((i >> 1) & 1))) sc[i] = 0.0f;
        }
        if constexpr (Sweep::kList) {
          if (part) {
#pragma unroll
            for (int i = 0; i < kTileRows / 2; ++i) {
              const int col = k0 + 8 * (i / 4) + 2 * t + (i & 1);
              const int row = row0 + 8 * ((i >> 1) & 1);
              if (col < S_len && (row >= T_len || !sw.keep(row, col))) sc[i] = 0.0f;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kTileRows / 2; ++i) pt_s[i * 128 + tid] = sc[i];
      named_barrier_arrive(kPtFull, kConsumers);
      named_barrier_sync(kDsFull, kConsumers);
    } else {
      named_barrier_sync(kPtFull, kConsumers);
      // dS = P * (dP - delta); where P is 0 on an edge or partial tile, dP
      // (NaN from a dead key row of V) is replaced by delta first, so that
      // dS is 0 by select
#pragma unroll
      for (int i = 0; i < kTileRows / 2; ++i) {
        const float p = pt_s[i * 128 + tid];
        const float d = delta_r[(i >> 1) & 1];
        sc[i] = p * ((edge && p == 0.0f ? d : sc[i]) - d);
      }
      stage_rows<kTileRows, 0>(ds_s, sc, 1.0f);   // bf16, TMA's swizzle
      fence_proxy_async();   // for the wgmma of both warpgroups
      named_barrier_arrive(kDsFull, kConsumers);
    }
    // dQ += dS . K over keys 32 wg .. 32 wg + 31
    wgmma_fence();
    wgmma_accumulate_ss<D, C::PANEL_T, 2>(acc, ds_s + 64 * wg, k_t + 32 * wg * C::RB);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_regs(acc[i]);
    mbar_arrive(&empty[s]);
  }

  // epilogue: warpgroup 1's share into the ring (both warpgroups' products
  // are done, and no load is left to land there), added to warpgroup 0's
  // in the same order for every element; dQ * sm_scale in bf16, staged in
  // the block's Q rows
  float* share = reinterpret_cast<float*>(k_s);
  named_barrier_sync(kDqSum, kConsumers);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) share[i * 128 + tid] = acc[i];
  }
  named_barrier_sync(kDqSum, kConsumers);
  if (wg == 0) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] += share[i * 128 + tid];
    stage_rows<D, C::PANEL_Q>(q_s, acc, sm_scale);
    named_barrier_sync(1, 128);
    store_rows<D, C::PANEL_Q>(q_s, dq, q0, T_len);
  }
}

// The two consumer warpgroups of the f32 dQ kernel, over the block's 64
// query rows q0 .. q0 + 63 (this thread holds rows row0 and row0 + 8 of
// each accumulator).  They split each 64-key tile by keys: warpgroup w
// takes keys 32 w .. 32 w + 31 of it, and forms S = Q . K^T and dP = dO .
// V^T over them (m64n32 products), P and dS = P * (dP - delta) in its own
// registers (masked as dq_split_consume masks them), and dQ += dS . K over
// the same keys, into its own D / 2 f32 of all 64 rows; nothing crosses
// between the warpgroups per tile.  Every product of f32 operands is formed
// from bf16 products on three bf16 pieces a side (hopper_common.cuh), six a
// product: Q and dO are split once, warpgroup 0 splitting Q and 1 dO;
// each K and V tile by both warpgroups together (256 threads, named barrier
// kDqSplit), K before S is issued and V while S runs; dS in registers.  K
// arrives on full[s] and is released on empty[s] after dS . K; V on
// full_v[s], released on empty_v[s] once dP is formed.  The two sums meet
// once, at the end, in the drained ring (barrier kDqSum), added in one
// order for every element, and dQ * sm_scale leaves in f32 from warpgroup
// 0's accumulators.  At D 192 and 256 (C::WIDE) Q and dO stay f32 and the
// K and V tiles are of 32 keys, 16 a warpgroup (m64n16 products): each
// warpgroup splits Q, then dO, into registers 32 columns at a time for
// every tile, a fresh partial of S or dP per k16 step (wide_scores), V
// split once S is formed.
template <int D, class Sweep>
__device__ __forceinline__ void dq_f32_consume(const Sweep& sw, unsigned char* q_s,
                                               unsigned char* do_s, unsigned char* k_s,
                                               unsigned char* v_s, const Step* step_s,
                                               uint64_t* q_full, uint64_t* full, uint64_t* empty,
                                               uint64_t* full_v, uint64_t* empty_v,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               float* __restrict__ dq, int b, int n, int T_len,
                                               int S_len, float scale_log2, float sm_scale,
                                               int causal) {
  using C = DqCfg<D, float>;
  using P = Panels<D>;
  constexpr int TR = C::TILE_ROWS;
  constexpr int THIRD = TR * D * 4;   // a tile's third pieces, after its f32 bytes
  constexpr int KH = TR / 2;          // the keys of a warpgroup's half of a tile
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int q0 = b * kTileRows;
  const int row0 = q0 + 16 * warp + lane / 4;

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
  float acc[D / 2];   // this warpgroup's keys' share of dQ: 64 x D
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  if (n > 0) {
    mbar_wait(q_full, 0);
    if constexpr (!C::WIDE) {
      split_tile<D>(wg == 0 ? q_s : do_s, 1 + wg);
      fence_proxy_async();
      named_barrier_sync(kDqSplit, kConsumers);   // both warpgroups read both
    }
  }
  for (int it = 0; it < n; ++it) {
    const int s = it % C::STAGES;
    const uint32_t parity = (it / C::STAGES) & 1;
    Step step;
    if constexpr (!Sweep::kList)
      step = sub_step<kTileRows / TR>(sw.dq_step(b, it / (kTileRows / TR), kTileRows), it);
    mbar_wait(&full[s], parity);
    if constexpr (Sweep::kList) step = step_s[s];   // staged by the producer
    unsigned char* k_t = k_s + s * C::TILE_BYTES;
    unsigned char* v_t = v_s + s * C::TILE_BYTES;
    const int kw = step.tile * TR + KH * wg;   // this warpgroup's first key
    const bool part = Sweep::kList && (step.flags & kPartial);
    const bool edge = part || kw + KH > S_len || (causal && kw + KH - 1 > q0);
    split_tile<D, kConsumers, TR>(k_t, kDqSplit);
    fence_proxy_async();
    named_barrier_sync(kDqSplit, kConsumers);
    // S = Q . K^T over this warpgroup's keys; the products take their keys
    // by warpgroup, not in branches (a wgmma on a divergent path is
    // serialised, ptxas C7520)
    float sc[KH / 2], dp[KH / 2];
    if constexpr (C::WIDE) {
      wide_scores<D, KH, true>(sc, q_s, k_t + KH * wg * P::RB);
      mbar_wait(&full_v[s], parity);
      split_tile<D, kConsumers, TR>(v_t, kDqSplit);
      fence_proxy_async();
      named_barrier_sync(kDqSplit, kConsumers);
      wide_scores<D, KH, true>(dp, do_s, v_t + KH * wg * P::RB);
    } else {
      wgmma_fence();
      wgmma_scores_split<D, C::PANEL_Q, C::PANEL_T, THIRD, KH>(sc, q_s, k_t + KH * wg * P::RB);
      wgmma_commit();
      mbar_wait(&full_v[s], parity);
      split_tile<D, kConsumers>(v_t, kDqSplit);   // while S runs
      fence_proxy_async();
      named_barrier_sync(kDqSplit, kConsumers);
      wgmma_fence();
      wgmma_scores_split<D, C::PANEL_Q, C::PANEL_T, THIRD, KH>(dp, do_s, v_t + KH * wg * P::RB);
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < KH / 2; ++i) fence_regs(sc[i]);
    }

    // P = exp(S * scale - LSE), the masks first, in loops of their own (a
    // killed score to -inf, so its P is 0); element i is query row row0 + 8
    // ((i >> 1) & 1), key column kw + 8 (i / 4) + 2 t + (i & 1)
    if (edge) {
#pragma unroll
      for (int i = 0; i < KH / 2; ++i) {
        const int col = kw + 8 * (i / 4) + 2 * t + (i & 1);
        if (col >= S_len || (causal && col > row0 + 8 * ((i >> 1) & 1))) sc[i] = -INFINITY;
      }
      if constexpr (Sweep::kList) {
        if (part) {
#pragma unroll
          for (int i = 0; i < KH / 2; ++i) {
            const int col = kw + 8 * (i / 4) + 2 * t + (i & 1);
            const int row = row0 + 8 * ((i >> 1) & 1);
            if (col < S_len && (row >= T_len || !sw.keep(row, col))) sc[i] = -INFINITY;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < KH / 2; ++i)
      sc[i] = exp2f(fmaf(sc[i], scale_log2, -lse_r[(i >> 1) & 1]));
    if constexpr (!C::WIDE) {
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < KH / 2; ++i) fence_regs(dp[i]);
    }
    mbar_arrive(&empty_v[s]);   // V is read: the next V may land
    // dS = P * (dP - delta); where P is 0 on an edge or partial tile, dP
    // (NaN from a dead key row of V) is replaced by delta first, so that dS
    // is 0 by select; its three pieces are dQ's A operand
    uint32_t a1[KH / 4], a2[KH / 4], a3[KH / 4];
#pragma unroll
    for (int i = 0; i < KH / 4; ++i) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = sc[2 * i + e];
        const float d = delta_r[i & 1];
        ds[e] = p * ((edge && p == 0.0f ? d : dp[2 * i + e]) - d);
      }
      split_bf16x3(ds[0], ds[1], a1[i], a2[i], a3[i]);
    }
    // dQ += dS . K over this warpgroup's keys
    wgmma_fence();
    wgmma_accumulate_split<D, C::PANEL_T, THIRD, KH / 16>(acc, a1, a2, a3,
                                                          k_t + KH * wg * P::RB);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < D / 2; ++i) fence_regs(acc[i]);
    mbar_arrive(&empty[s]);   // K is read
  }

  // epilogue: warpgroup 1's share into the ring (both warpgroups'
  // products are done, and no load is left to land there), added to
  // warpgroup 0's
  float* share = reinterpret_cast<float*>(k_s);
  named_barrier_sync(kDqSum, kConsumers);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) share[i * 128 + tid] = acc[i];
  }
  named_barrier_sync(kDqSum, kConsumers);
  if (wg != 0) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] += share[i * 128 + tid];
  // dQ * sm_scale in f32, two columns a store (element 4 j + 2 h of panel
  // p: row row0 + 8 h, column p PW + 8 j + 2 t)
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int j = 0; j < P::PW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        const float* a = acc + p * (P::PW / 2) + 4 * j + 2 * h;
        if (row < T_len)
          *reinterpret_cast<float2*>(dq + (size_t)row * D + p * P::PW + 8 * j + 2 * t) =
              make_float2(a[0] * sm_scale, a[1] * sm_scale);
      }
}

// The dQ block over operands of type T (bf16, or f32 on the split products
// of dq_f32_consume): grid (B*H, ceil(T / own rows)); the sweep maps
// blockIdx.y to a block.  The sweep's steps are 64-row tiles, streamed as
// kSub tiles of C::TILE_ROWS rows each (2 in f32 at D 192 and 256).  The
// kernels below pass their tensor maps' addresses.
template <int D, class Sweep, typename T>
__device__ __forceinline__ void bwd_dq_body(const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                            const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta, T* __restrict__ dq,
                                            int T_len, int S_len, float scale_log2,
                                            float sm_scale, int causal, int H, int h0,
                                            const Sweep& sw) {
  using C = DqCfg<D, T>;
  using L = typename C::L;   // TMA's panels
  constexpr int kSub = kTileRows / C::TILE_ROWS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align1024(smem_raw);             // [panel][own rows]
  unsigned char* do_s = q_s + C::Q_BYTES;
  unsigned char* k_s = do_s + C::Q_BYTES;               // [stage][panel][TILE_ROWS rows]
  unsigned char* v_s = k_s + C::STAGES * C::TILE_BYTES;
  unsigned char* ds_s = v_s + C::STAGES * C::TILE_BYTES;   // bf16, 64 own rows: dS
  float* pt_s = reinterpret_cast<float*>(ds_s + C::DS_BYTES);   // and P
  uint64_t* q_full = reinterpret_cast<uint64_t*>(pt_s + C::PT_BYTES / 4);
  uint64_t* full = q_full + 1;          // K's (and, in bf16, V's)
  uint64_t* empty = full + C::STAGES;
  uint64_t* full_v = empty + C::STAGES;   // f32: V's own (in bf16 past the barriers, unused)
  uint64_t* empty_v = full_v + C::STAGES;
  Step* step_s = reinterpret_cast<Step*>(full + 2 * C::KV_BARS * C::STAGES);   // list sweeps

  const int bh = h0 + blockIdx.x;
  const int h = bh % H, bb = bh / H;
  const int b = sw.dq_block();
  const int q0 = b * C::OWN;
  const int n = sw.dq_count(b, S_len, C::OWN) * kSub;   // 0: dQ = 0

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
        mbar_arrive_expect_tx(q_full, 2 * C::Q_LOAD);
        for (int p = 0; p < L::NP; ++p) {
          tma_load_4d(q_s + p * C::LPANEL_Q, tm_q, q_full, p * L::PW, q0, h, bb);
          tma_load_4d(do_s + p * C::LPANEL_Q, tm_do, q_full, p * L::PW, q0, h, bb);
        }
      }
      for (int it = 0; it < n; ++it) {
        const int s = it % C::STAGES;
        const Step step = sub_step<kSub>(sw.dq_step(b, it / kSub, C::OWN), it);
        const int k0 = step.tile * C::TILE_ROWS;
        if constexpr (C::F32) {
          // V on full_v[s] (the consumers release it first, once dP is
          // formed), then K on full[s] once they have released the stage's
          // K
          const uint32_t parity = ((it / C::STAGES) & 1) ^ 1;   // the first round passes
          for (int kv = 0; kv < 2; ++kv) {
            const bool with_v = kv == 0;
            uint64_t* bar = with_v ? &full_v[s] : &full[s];
            mbar_wait(with_v ? &empty_v[s] : &empty[s], parity);
            if constexpr (Sweep::kList) {
              if (with_v && lane == 0) step_s[s] = step;
              if (step.flags & kPartialAny) {   // a partial pair: live rows only
                constexpr int TR = C::TILE_ROWS;
                const unsigned long long live = sw.live(b, it / kSub) >> (TR * (it % kSub));
                if (with_v)
                  stage_live_rows<D, C::LPANEL_T, T, TR>(v_s + s * C::TILE_BYTES,
                                                         sw.src_b + sw.stride_b.head(bh, H),
                                                         sw.stride_b.r, k0, S_len, live, lane);
                else
                  stage_live_rows<D, C::LPANEL_T, T, TR>(k_s + s * C::TILE_BYTES,
                                                         sw.src_a + sw.stride_a.head(bh, H),
                                                         sw.stride_a.r, k0, S_len, live, lane);
                fence_proxy_async();
                mbar_arrive(bar);
                continue;
              }
              if (lane != 0) {
                mbar_arrive(bar);
                continue;
              }
            }
            mbar_arrive_expect_tx(bar, C::TILE_LOAD);
            for (int p = 0; p < L::NP; ++p) {
              const int off = s * C::TILE_BYTES + p * C::LPANEL_T;
              if (with_v) tma_load_4d(v_s + off, tm_v, bar, p * L::PW, k0, h, bb);
              else tma_load_4d(k_s + off, tm_k, bar, p * L::PW, k0, h, bb);
            }
          }
          continue;
        }
        mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);   // the first round passes
        if constexpr (Sweep::kList) {
          if (lane == 0) step_s[s] = step;
          if (step.flags & kPartialAny) {   // a partial pair: live rows only
            const unsigned long long live = sw.live(b, it / kSub);
            stage_live_rows<D, C::PANEL_T>(k_s + s * C::TILE_BYTES,
                                           sw.src_a + sw.stride_a.head(bh, H), sw.stride_a.r,
                                           k0, S_len, live, lane);
            stage_live_rows<D, C::PANEL_T>(v_s + s * C::TILE_BYTES,
                                           sw.src_b + sw.stride_b.head(bh, H), sw.stride_b.r,
                                           k0, S_len, live, lane);
            fence_proxy_async();
            mbar_arrive(&full[s]);
            continue;
          }
          if (lane != 0) {
            mbar_arrive(&full[s]);
            continue;
          }
        }
        mbar_arrive_expect_tx(&full[s], 2 * C::TILE_BYTES);
        for (int p = 0; p < C::NP; ++p) {
          const int off = s * C::TILE_BYTES + p * C::PANEL_T;
          tma_load_4d(k_s + off, tm_k, &full[s], p * C::PW, k0, h, bb);
          tma_load_4d(v_s + off, tm_v, &full[s], p * C::PW, k0, h, bb);
        }
      }
    }
  } else {
    setmaxnreg_inc<C::CONSUMER_REGS>();
    const float* lse_h = lse + (size_t)bh * T_len;
    const float* delta_h = delta + (size_t)bh * T_len;
    T* dq_h = dq + (size_t)bh * T_len * D;
    if constexpr (C::F32)
      dq_f32_consume<D>(sw, q_s, do_s, k_s, v_s, step_s, q_full, full, empty, full_v, empty_v,
                        lse_h, delta_h, dq_h, b, n, T_len, S_len, scale_log2, sm_scale, causal);
    else if constexpr (C::OWN == kBlockRows)
      dq_consume<D>(sw, q_s, do_s, k_s, v_s, step_s, q_full, full, empty, lse_h, delta_h, dq_h,
                    b, n, T_len, S_len, scale_log2, sm_scale, causal);
    else
      dq_split_consume<D>(sw, q_s, do_s, k_s, v_s, ds_s, pt_s, step_s, q_full, full, empty,
                          lse_h, delta_h, dq_h, b, n, T_len, S_len, scale_log2, sm_scale,
                          causal);
  }
}

// dQ in bf16 (K3, K8)
template <int D, class Sweep>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int T_len,
                    int S_len, float scale_log2, float sm_scale, int causal, int H, int h0,
                    const Sweep sw) {
  bwd_dq_body<D>(&tm_q, &tm_do, &tm_k, &tm_v, lse, delta, dq, T_len, S_len, scale_log2,
                 sm_scale, causal, H, h0, sw);
}

// dQ in f32 (K3, K8), each product from bf16 products on three bf16
// pieces of its operands
template <int D, class Sweep>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_dq_split_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq, int T_len,
                    int S_len, float scale_log2, float sm_scale, int causal, int H, int h0,
                    const Sweep sw) {
  bwd_dq_body<D>(&tm_q, &tm_do, &tm_k, &tm_v, lse, delta, dq, T_len, S_len, scale_log2,
                 sm_scale, causal, H, h0, sw);
}

// ---- the backward above head dim 256 ------------------------------------------
//
// See the note at the top.  A block owns 64 rows (key rows for dK/dV,
// query rows for dQ) and keeps kChunkCols columns of its output, the chunk
// chunk_of gives it (hopper_common.cuh); the chunks of a head are blocks of
// their own.  For each streamed tile (query rows for dK/dV, key rows for
// dQ: 32 rows in f32, 64 in bf16) it forms the scores anew over all of D
// from kChunkPanel-column panels that stream through a ring: a stage holds
// panel p of the two own operands (K and V, or Q and dO; in f32 split into
// wgmma's register operand as they are read, as wide_scores does) and of
// the tile's two (Q and dO, or K and V; in f32 split in place,
// split_tile).  Then the tile's chunk operands (dO and Q for dV and dK, K
// for dQ: the tile's rows by the chunk's 256 columns, in f32 split in
// place) land in a slot of their own.  So one instantiation per pass,
// dtype and sweep serves every D above 256 (the panel count is an
// argument), and every chunk forms the same scores bit for bit: up to the
// epilogue a chunk's code differs only in which columns of its chunk
// operands it reads.

// The ring and the chunk slot of the chunked dK/dV (kDkv) or dQ over
// operands of type T.  TMA lands a panel in boxes of TMA's panel width (L:
// 64 bf16 or 32 f32 columns, 128-byte rows): an own panel as boxes of 64
// rows (LPANEL_OWN apart), a tile panel as boxes of TR rows (LPANEL_T
// apart), a chunk operand as boxes of TR rows; in f32 with room after the
// tile panel and the chunk operand for their third pieces.  f32 dK/dV: 2
// stages of 56 KB, the dO and Q chunk operands (48 KB each) and P^T
// (222,520 B); f32 dQ: 3 stages and the K chunk operand (222,536 B).  bf16
// streams 64-row tiles (m64n64 scores: the own rows, re-read for every
// tile, take half the stages they would at 32 rows): 4 stages of 32 KB,
// dK/dV with the dO and Q chunk operands (32 KB each) and P^T (214,616 B),
// dQ with the K chunk operand (165,464 B).
template <bool kDkv, typename T = float>
struct BwdChunkCfg {
  using L = Panels<kChunkPanel, sizeof(T)>;
  static constexpr int E = sizeof(T);
  static constexpr int THIRD = kIsBf16<T> ? 0 : 2;   // bytes of a third piece an element
  static constexpr int TR = kIsBf16<T> ? kTileRows : kWideRows;   // rows of a streamed tile
  static constexpr int OWN_PANEL = kTileRows * kChunkPanel * E;    // an own panel
  static constexpr int TILE_LOAD = TR * kChunkPanel * E;           // a tile panel's bytes
  static constexpr int TILE_PANEL = TR * kChunkPanel * (E + THIRD);   // and its third pieces
  static constexpr int STAGE = 2 * OWN_PANEL + 2 * TILE_PANEL;
  static constexpr int STAGES = kIsBf16<T> ? 4 : kDkv ? 2 : 3;
  static constexpr int CHUNK_LOAD = TR * kChunkCols * E;
  static constexpr int CHUNK_BYTES = TR * kChunkCols * (E + THIRD);
  static constexpr int CHUNKS = kDkv ? 2 : 1;                      // chunk operands
  static constexpr int PT_BYTES = kDkv ? kTileRows * TR * 4 : 0;   // P^T, 0 to 1
  static constexpr int LPANEL_OWN = kTileRows * L::RB;
  static constexpr int LPANEL_T = TR * L::RB;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + (size_t)CHUNKS * CHUNK_BYTES +
                                 PT_BYTES + 2 * TR * sizeof(float) +
                                 sizeof(uint64_t) * 2 * (STAGES + 1) + sizeof(Step);
  static_assert(STAGE % 1024 == 0 && CHUNK_BYTES % 1024 == 0, "panels on 1024-byte bounds");
  // the producer issues a tile's chunk operands after its first STAGES
  // panels: every D above 256 has more panels than that
  static_assert(STAGES < (kChunkCols + kChunkPanel) / kChunkPanel, "a tile has more panels");
};

// registers after the hand-over: the consumers keep 128 f32 of their
// chunk beside a tile's scores (and in f32 one k16 step's pieces); the
// producer warp stages rows (list sweeps) and LSE and delta (dK/dV), and
// the f32 list dK/dV's spills in 40
constexpr int kChunkBwdProducerRegs = 56;
constexpr int kChunkBwdConsumerRegs = 224;

// The producer warp of the chunked dK/dV (kDkv) or dQ: for each of the n
// streamed tiles of block b, its np panels into the stage ring (own rows
// own0 .. of own_a and own_b, the tile's rows of tile_a and tile_b), and
// after the first STAGES of them its chunk operands (columns col0 ..) into
// the chunk slot: dO and Q (tile_b, tile_a) for dK/dV, with the tile's LSE
// (times log2 e) and delta (head bh's rows at lse, delta), or K (tile_a)
// for dQ.  Lane 0 issues the TMA loads; a list step's partial pair is
// staged by the warp, the tile's live rows only, in every panel and chunk
// operand.
template <bool kDkv, typename T, class Sweep>
__device__ __forceinline__ void bwd_chunk_produce(
    const Sweep& sw, const CUtensorMap* tm_own_a, const CUtensorMap* tm_own_b,
    const CUtensorMap* tm_tile_a, const CUtensorMap* tm_tile_b, unsigned char* stages,
    unsigned char* chunk_s, float* lse_s, float* delta_s, Step* step_s, uint64_t* full,
    uint64_t* empty, uint64_t* full_c, uint64_t* empty_c, const float* __restrict__ lse,
    const float* __restrict__ delta, int b, int n, int np, int col0, int tile_len, int h,
    int bb, int bh, int H) {
  using C = BwdChunkCfg<kDkv, T>;
  using L = typename C::L;
  constexpr int TR = C::TR;
  constexpr int kSub = kTileRows / TR;   // a sweep step's 64-row tile as two tiles
  const int lane = threadIdx.x % 32;
  const int own0 = b * kTileRows;
  int si = 0;   // stages filled
  for (int it = 0; it < n; ++it) {
    Step step;
    if constexpr (kDkv) step = sub_step<kSub>(sw.dkv_step(b, it / kSub, kTileRows), it);
    else step = sub_step<kSub>(sw.dq_step(b, it / kSub, kTileRows), it);
    const int r0 = step.tile * TR;
    bool part = false;
    unsigned long long live = 0;
    if constexpr (Sweep::kList) {
      part = step.flags & kPartialAny;
      if (part) live = sw.live(b, it / kSub) >> (TR * (it % kSub));
    }
    for (int p = 0; p < np; ++p, ++si) {
      if (p == C::STAGES) {   // the tile's chunk operands
        mbar_wait(empty_c, (it & 1) ^ 1);   // the first round passes
        if constexpr (kDkv) {
#pragma unroll
          for (int i = 0; i < TR / 32; ++i) {
            const int c = lane + 32 * i;
            const bool in = r0 + c < tile_len;
            lse_s[c] = (in ? lse[r0 + c] : BIG_LSE) * kLog2e;
            delta_s[c] = in ? delta[r0 + c] : 0.0f;
          }
        }
        bool staged = false;
        if constexpr (Sweep::kList) {
          if (lane == 0) *step_s = step;
          if (part) {
#pragma unroll 1
            for (int i = 0; i < C::CHUNKS; ++i) {
              const bool from_b = kDkv && i == 0;   // dO; else Q or K
              const T* src = from_b ? sw.src_b + sw.stride_b.head(bh, H)
                                    : sw.src_a + sw.stride_a.head(bh, H);
              stage_live_rows<kChunkCols, C::LPANEL_T, T, TR>(
                  chunk_s + i * C::CHUNK_BYTES, src + col0,
                  from_b ? sw.stride_b.r : sw.stride_a.r, r0, tile_len, live, lane);
            }
            fence_proxy_async();
            staged = true;
          }
        }
        if (staged || lane != 0) {
          mbar_arrive(full_c);
        } else {
          mbar_arrive_expect_tx(full_c, C::CHUNKS * C::CHUNK_LOAD);
          for (int i = 0; i < C::CHUNKS; ++i)
            for (int g = 0; g < kChunkCols / L::PW; ++g)
              tma_load_4d(chunk_s + i * C::CHUNK_BYTES + g * C::LPANEL_T,
                          kDkv && i == 0 ? tm_tile_b : tm_tile_a, full_c, col0 + g * L::PW, r0,
                          h, bb);
        }
      }
      const int s = si % C::STAGES;
      mbar_wait(&empty[s], ((si / C::STAGES) & 1) ^ 1);   // the first round passes
      unsigned char* st = stages + s * C::STAGE;
      unsigned char* ta = st + 2 * C::OWN_PANEL;
      unsigned char* tb = ta + C::TILE_PANEL;
      if constexpr (Sweep::kList) {
        if (part) {   // a partial pair: the tile panels' live rows only
          stage_live_rows<kChunkPanel, C::LPANEL_T, T, TR>(
              ta, sw.src_a + sw.stride_a.head(bh, H) + p * kChunkPanel, sw.stride_a.r, r0,
              tile_len, live, lane);
          stage_live_rows<kChunkPanel, C::LPANEL_T, T, TR>(
              tb, sw.src_b + sw.stride_b.head(bh, H) + p * kChunkPanel, sw.stride_b.r, r0,
              tile_len, live, lane);
          fence_proxy_async();
        }
      }
      if (lane != 0) {
        mbar_arrive(&full[s]);
        continue;
      }
      mbar_arrive_expect_tx(&full[s], 2 * C::OWN_PANEL + (part ? 0 : 2 * C::TILE_LOAD));
      for (int g = 0; g < L::NP; ++g) {
        const int col = p * kChunkPanel + g * L::PW;
        tma_load_4d(st + g * C::LPANEL_OWN, tm_own_a, &full[s], col, own0, h, bb);
        tma_load_4d(st + C::OWN_PANEL + g * C::LPANEL_OWN, tm_own_b, &full[s], col, own0, h, bb);
        if (!part) {
          tma_load_4d(ta + g * C::LPANEL_T, tm_tile_a, &full[s], col, r0, h, bb);
          tma_load_4d(tb + g * C::LPANEL_T, tm_tile_b, &full[s], col, r0, h, bb);
        }
      }
    }
  }
}

// The two consumer warpgroups of the chunked f32 dK/dV, over the block's 64
// key rows k0 .. k0 + 63 (this thread holds rows key0 and key0 + 8 of each
// accumulator): dkv_f32_consume's split of the work at D 192 and 256, with
// D in panels.  Per panel warpgroup 0 splits the stage's Q panel in place
// and adds its products to S^T = K . Q^T (K split into registers, a fresh
// partial per k16 step, wide_scores), warpgroup 1 the dO panel's to dP^T
// = V . dO^T; then, from the chunk slot, warpgroup 0 forms P^T, hands it to 1
// in f32 (pt_s, kPtFull and kPtEmpty as in dkv_f32_consume), splits the dO
// chunk operand and adds P^T . dO to dV's chunk; warpgroup 1 forms dS^T =
// P^T * (dP^T - delta) (a dead key row's NaN in dP^T replaced by delta
// first), splits the Q chunk operand and adds dS^T . Q to dK's: five
// products each (dO and Q in two pieces).  Each warpgroup splits only what
// it reads, so besides P^T nothing crosses between them.  The epilogue
// writes the chunk's own columns of dV (0) or dK * sm_scale (1), in f32.
template <class Sweep>
__device__ __forceinline__ void dkv_chunk_consume(const Sweep& sw, unsigned char* stages,
                                                  unsigned char* chunk_s, float* pt_s,
                                                  const float* lse_s, const float* delta_s,
                                                  const Step* step_s, uint64_t* full,
                                                  uint64_t* empty, uint64_t* full_c,
                                                  uint64_t* empty_c, float* __restrict__ dk,
                                                  float* __restrict__ dv, int bh, int b, int n,
                                                  int np, int chunk, int T_len, int S_len,
                                                  float scale_log2, float sm_scale, int causal) {
  using C = BwdChunkCfg<true>;
  using P = Panels<kChunkCols>;   // the chunk's panels
  constexpr int TR = C::TR;
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int k0 = b * kTileRows;
  const int key0 = k0 + 16 * warp + lane / 4;
  // this warpgroup's operands: K and the Q panel (0), V and the dO panel
  // (1) in a stage; the dO (0) or Q (1) chunk operand
  const int own_off = wg * C::OWN_PANEL;
  const int tile_off = 2 * C::OWN_PANEL + wg * C::TILE_PANEL;
  unsigned char* ct = chunk_s + wg * C::CHUNK_BYTES;

  float acc[kChunkCols / 2];   // dV (warpgroup 0) or dK (1): 64 x the chunk
#pragma unroll
  for (int i = 0; i < kChunkCols / 2; ++i) acc[i] = 0.0f;

  int si = 0;   // stages read
  for (int it = 0; it < n; ++it) {
    float sc[TR / 2];   // S^T (warpgroup 0) or dP^T (1)
#pragma unroll
    for (int i = 0; i < TR / 2; ++i) sc[i] = 0.0f;
#pragma unroll 1
    for (int p = 0; p < np; ++p, ++si) {
      const int s = si % C::STAGES;
      mbar_wait(&full[s], (si / C::STAGES) & 1);
      unsigned char* st = stages + s * C::STAGE;
      split_tile<kChunkPanel, 128, TR>(st + tile_off, 1 + wg);
      fence_proxy_async();
      named_barrier_sync(1 + wg, 128);
      wide_scores<kChunkPanel, TR, true, true>(sc, st + own_off, st + tile_off);
      mbar_arrive(&empty[s]);
    }

    mbar_wait(full_c, it & 1);
    Step step;
    if constexpr (Sweep::kList) step = *step_s;   // staged by the producer
    else step = sub_step<kTileRows / TR>(sw.dkv_step(b, it / (kTileRows / TR), kTileRows), it);
    const int q0 = step.tile * TR;
    const bool part = Sweep::kList && (step.flags & kPartial);
    const bool edge = part || q0 + TR > T_len || (causal && q0 < k0 + 63);
    split_tile<kChunkCols, 128, TR>(ct, 1 + wg);
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);
    uint32_t a1[TR / 4], a2[TR / 4], a3[TR / 4];
    if (wg == 0) {
      // P^T, masked as dkv_split_consume masks it (element i: query row q0
      // + c, c = 8 (i / 4) + 2 t + (i & 1), key row key0 + 8 ((i >> 1) & 1))
#pragma unroll
      for (int i = 0; i < TR / 2; ++i)
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -lse_s[8 * (i / 4) + 2 * t + (i & 1)]));
      if (edge) {
#pragma unroll
        for (int i = 0; i < TR / 2; ++i) {
          const int q = q0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int key = key0 + 8 * ((i >> 1) & 1);
          if (q >= T_len || (causal && key > q)) sc[i] = 0.0f;
        }
        if constexpr (Sweep::kList) {
          if (part) {
#pragma unroll
            for (int i = 0; i < TR / 2; ++i) {
              const int q = q0 + 8 * (i / 4) + 2 * t + (i & 1);
              const int key = key0 + 8 * ((i >> 1) & 1);
              if (q < T_len && (key >= S_len || !sw.keep(q, key))) sc[i] = 0.0f;
            }
          }
        }
      }
      if (it > 0) named_barrier_sync(kPtEmpty, kConsumers);
#pragma unroll
      for (int i = 0; i < TR / 2; ++i) pt_s[i * 128 + tid] = sc[i];
      named_barrier_arrive(kPtFull, kConsumers);
#pragma unroll
      for (int i = 0; i < TR / 4; ++i)
        split_bf16x3(sc[2 * i], sc[2 * i + 1], a1[i], a2[i], a3[i]);
    } else {
      named_barrier_sync(kPtFull, kConsumers);
      // dS^T = P^T * (dP^T - delta); where P^T is 0 on an edge or partial
      // tile, dP^T (NaN from a dead key row of V) is replaced by delta
      // first, so that dS^T is 0 by select
#pragma unroll
      for (int i = 0; i < TR / 4; ++i) {
        const int c = 8 * (i / 2) + 2 * t;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = pt_s[(2 * i + e) * 128 + tid];
          const float dp = edge && pv == 0.0f ? delta_s[c + e] : sc[2 * i + e];
          ds[e] = pv * (dp - delta_s[c + e]);
        }
        split_bf16x3(ds[0], ds[1], a1[i], a2[i], a3[i]);
      }
      if (it + 1 < n) named_barrier_arrive(kPtEmpty, kConsumers);
    }
    // dV += P^T . dO (warpgroup 0), dK += dS^T . Q (1), over the chunk
    wgmma_fence();
    wgmma_accumulate_split<kChunkCols, TR * P::RB, 0, TR / 16>(acc, a1, a2, a3, ct);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kChunkCols / 2; ++i) fence_regs(acc[i]);
    mbar_arrive(empty_c);
  }

  // epilogue: dV (warpgroup 0) or dK * sm_scale (1) in f32, the chunk's own
  // columns, two a store (element 4 j + 2 h of panel p: row key0 + 8 h,
  // column col0 + p PW + 8 j + 2 t)
  const int D = np * kChunkPanel;
  const Chunk ch = chunk_of(chunk, D);
  float* out = (wg == 0 ? dv : dk) + (size_t)bh * S_len * D;
  const float scale = wg == 0 ? 1.0f : sm_scale;
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int j = 0; j < P::PW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = key0 + 8 * h;
        const int col = ch.col0 + p * P::PW + 8 * j + 2 * t;
        const float* a = acc + p * (P::PW / 2) + 4 * j + 2 * h;
        if (row < S_len && col >= ch.lo && col < ch.hi)
          *reinterpret_cast<float2*>(out + (size_t)row * D + col) =
              make_float2(a[0] * scale, a[1] * scale);
      }
}

// The two consumer warpgroups of the chunked f32 dQ, over the block's 64
// query rows q0 .. q0 + 63 (this thread holds rows row0 and row0 + 8 of
// each accumulator): dq_f32_consume's split of the work at D 192 and 256,
// with D in panels.  Per panel both warpgroups split the stage's K and V
// panels in place together (kDqSplit), and warpgroup w adds the products
// over keys 16 w .. 16 w + 15 of the tile to S = Q . K^T and dP = dO . V^T
// (Q and dO split into registers, a fresh partial per k16 step,
// wide_scores); then, from the chunk slot, both split the K chunk operand,
// and each forms P and dS over its keys and adds dS . K to its own sum of
// dQ's chunk (six products).  The two sums meet once, at the end, in the
// drained ring (kDqSum), and warpgroup 0 writes the chunk's own columns of
// dQ * sm_scale in f32.
template <class Sweep>
__device__ __forceinline__ void dq_chunk_consume(const Sweep& sw, unsigned char* stages,
                                                 unsigned char* chunk_s, const Step* step_s,
                                                 uint64_t* full, uint64_t* empty,
                                                 uint64_t* full_c, uint64_t* empty_c,
                                                 const float* __restrict__ lse,
                                                 const float* __restrict__ delta,
                                                 float* __restrict__ dq, int bh, int b, int n,
                                                 int np, int chunk, int T_len, int S_len,
                                                 float scale_log2, float sm_scale, int causal) {
  using C = BwdChunkCfg<false>;
  using P = Panels<kChunkCols>;   // the chunk's panels
  constexpr int TR = C::TR;
  constexpr int KH = TR / 2;      // the keys of a warpgroup's half of a tile
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int q0 = b * kTileRows;
  const int row0 = q0 + 16 * warp + lane / 4;
  // this warpgroup's keys in a tile panel and in the chunk operand
  const int key_off = KH * wg * Panels<kChunkPanel>::RB;

  // this thread's two rows: LSE (times log2 e) and delta; rows past T
  // read LSE = 1e30, so their P is 0
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool in = row < T_len;
    lse_r[h] = (in ? lse[(size_t)bh * T_len + row] : BIG_LSE) * kLog2e;
    delta_r[h] = in ? delta[(size_t)bh * T_len + row] : 0.0f;
  }
  float acc[kChunkCols / 2];   // this warpgroup's keys' share of dQ's chunk
#pragma unroll
  for (int i = 0; i < kChunkCols / 2; ++i) acc[i] = 0.0f;

  int si = 0;   // stages read
  for (int it = 0; it < n; ++it) {
    float sc[KH / 2], dp[KH / 2];
#pragma unroll
    for (int i = 0; i < KH / 2; ++i) {
      sc[i] = 0.0f;
      dp[i] = 0.0f;
    }
#pragma unroll 1
    for (int p = 0; p < np; ++p, ++si) {
      const int s = si % C::STAGES;
      mbar_wait(&full[s], (si / C::STAGES) & 1);
      unsigned char* st = stages + s * C::STAGE;
      unsigned char* kp = st + 2 * C::OWN_PANEL;
      unsigned char* vp = kp + C::TILE_PANEL;
      split_tile<kChunkPanel, kConsumers, TR>(kp, kDqSplit);
      split_tile<kChunkPanel, kConsumers, TR>(vp, kDqSplit);
      fence_proxy_async();
      named_barrier_sync(kDqSplit, kConsumers);
      wide_scores<kChunkPanel, KH, true, true>(sc, st, kp + key_off);
      wide_scores<kChunkPanel, KH, true, true>(dp, st + C::OWN_PANEL, vp + key_off);
      mbar_arrive(&empty[s]);
    }

    mbar_wait(full_c, it & 1);
    Step step;
    if constexpr (Sweep::kList) step = *step_s;   // staged by the producer
    else step = sub_step<kTileRows / TR>(sw.dq_step(b, it / (kTileRows / TR), kTileRows), it);
    const int kw = step.tile * TR + KH * wg;   // this warpgroup's first key
    const bool part = Sweep::kList && (step.flags & kPartial);
    const bool edge = part || kw + KH > S_len || (causal && kw + KH - 1 > q0);
    split_tile<kChunkCols, kConsumers, TR>(chunk_s, kDqSplit);
    fence_proxy_async();
    named_barrier_sync(kDqSplit, kConsumers);

    // P = exp(S * scale - LSE), the masks first (a killed score to -inf);
    // element i is query row row0 + 8 ((i >> 1) & 1), key column kw + 8
    // (i / 4) + 2 t + (i & 1)
    if (edge) {
#pragma unroll
      for (int i = 0; i < KH / 2; ++i) {
        const int col = kw + 8 * (i / 4) + 2 * t + (i & 1);
        if (col >= S_len || (causal && col > row0 + 8 * ((i >> 1) & 1))) sc[i] = -INFINITY;
      }
      if constexpr (Sweep::kList) {
        if (part) {
#pragma unroll
          for (int i = 0; i < KH / 2; ++i) {
            const int col = kw + 8 * (i / 4) + 2 * t + (i & 1);
            const int row = row0 + 8 * ((i >> 1) & 1);
            if (col < S_len && (row >= T_len || !sw.keep(row, col))) sc[i] = -INFINITY;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < KH / 2; ++i) sc[i] = exp2f(fmaf(sc[i], scale_log2, -lse_r[(i >> 1) & 1]));
    // dS = P * (dP - delta); where P is 0 on an edge or partial tile, dP
    // (NaN from a dead key row of V) is replaced by delta first
    uint32_t a1[KH / 4], a2[KH / 4], a3[KH / 4];
#pragma unroll
    for (int i = 0; i < KH / 4; ++i) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pv = sc[2 * i + e];
        const float d = delta_r[i & 1];
        ds[e] = pv * ((edge && pv == 0.0f ? d : dp[2 * i + e]) - d);
      }
      split_bf16x3(ds[0], ds[1], a1[i], a2[i], a3[i]);
    }
    // dQ += dS . K over this warpgroup's keys, the chunk's columns
    wgmma_fence();
    wgmma_accumulate_split<kChunkCols, TR * P::RB, TR * kChunkCols * 4, KH / 16>(
        acc, a1, a2, a3, chunk_s + key_off);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kChunkCols / 2; ++i) fence_regs(acc[i]);
    mbar_arrive(empty_c);
  }

  // epilogue: warpgroup 1's share into the drained ring, added to
  // warpgroup 0's; dQ * sm_scale in f32, the chunk's own columns
  float* share = reinterpret_cast<float*>(stages);
  named_barrier_sync(kDqSum, kConsumers);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < kChunkCols / 2; ++i) share[i * 128 + tid] = acc[i];
  }
  named_barrier_sync(kDqSum, kConsumers);
  if (wg != 0) return;
#pragma unroll
  for (int i = 0; i < kChunkCols / 2; ++i) acc[i] += share[i * 128 + tid];
  const int D = np * kChunkPanel;
  const Chunk ch = chunk_of(chunk, D);
  float* out = dq + (size_t)bh * T_len * D;
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int j = 0; j < P::PW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        const int col = ch.col0 + p * P::PW + 8 * j + 2 * t;
        const float* a = acc + p * (P::PW / 2) + 4 * j + 2 * h;
        if (row < T_len && col >= ch.lo && col < ch.hi)
          *reinterpret_cast<float2*>(out + (size_t)row * D + col) =
              make_float2(a[0] * sm_scale, a[1] * sm_scale);
      }
}

// The scores of one streamed tile of a bf16 chunked consumer, over the np
// ring stages from stage si (the stages read so far) on: `products(stage,
// first)` issues a stage's wgmma (the first overwriting its accumulators),
// chained behind the stage before's into the same f32 accumulators, and a
// stage is released once its products are done, after the next stage's
// are issued (wgmma_wait<1>), as the bf16 chunked forward sums S.  Done
// when it returns; the caller fences the accumulators.
template <class C, class Products>
__device__ __forceinline__ void chunk_stage_scores(unsigned char* stages, uint64_t* full,
                                                   uint64_t* empty, int si, int np,
                                                   Products&& products) {
  mbar_wait(&full[si % C::STAGES], (si / C::STAGES) & 1);
  wgmma_fence();
  products(stages + (si % C::STAGES) * C::STAGE, true);
  wgmma_commit();
#pragma unroll 1
  for (int p = 1; p < np; ++p) {
    const int s = (si + p) % C::STAGES;
    mbar_wait(&full[s], ((si + p) / C::STAGES) & 1);
    wgmma_fence();
    products(stages + s * C::STAGE, false);
    wgmma_commit();
    wgmma_wait<1>();   // the stage before is read
    mbar_arrive(&empty[(si + p - 1) % C::STAGES]);
  }
  wgmma_wait<0>();
  mbar_arrive(&empty[(si + np - 1) % C::STAGES]);
}

// The two consumer warpgroups of the chunked bf16 dK/dV, over the block's
// 64 key rows k0 .. k0 + 63 (this thread holds rows key0 and key0 + 8 of
// each accumulator, whose columns are the tile's query rows):
// dkv_split_consume's split of the work at D 192 and 256, with D in
// panels.  Per stage warpgroup 0 adds the products of its K and Q panels
// to S^T = K . Q^T and warpgroup 1 those of its V and dO panels to dP^T =
// V . dO^T, both operands read from the stage, one f32 accumulator over
// the panels (chunk_stage_scores); then, from the chunk slot, warpgroup 0
// forms P^T, hands it to 1 in f32 (pt_s, kPtFull and kPtEmpty as in
// dkv_split_consume) and adds P^T . dO to dV's chunk; warpgroup 1 forms
// dS^T = P^T * (dP^T - delta) (a dead key row's NaN in dP^T replaced by
// delta first) and adds dS^T . Q to dK's; P^T and dS^T packed to bf16 as
// the register A operand, dO and Q read MN-major.  The epilogue writes the
// chunk's own columns of dV (0) or dK * sm_scale (1), in bf16.
template <class Sweep>
__device__ __forceinline__ void dkv_chunk_bf16_consume(
    const Sweep& sw, unsigned char* stages, const unsigned char* chunk_s, float* pt_s,
    const float* lse_s, const float* delta_s, const Step* step_s, uint64_t* full,
    uint64_t* empty, uint64_t* full_c, uint64_t* empty_c, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int bh, int b, int n, int np, int chunk, int T_len,
    int S_len, float scale_log2, float sm_scale, int causal) {
  using C = BwdChunkCfg<true, __nv_bfloat16>;
  using P = Panels<kChunkCols>;   // the chunk's panels
  constexpr int TR = C::TR;
  static_assert(TR == kTileRows, "a sweep step is one bf16 tile");
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int k0 = b * kTileRows;
  const int key0 = k0 + 16 * warp + lane / 4;
  // this warpgroup's operands: K and the Q panel (0), V and the dO panel
  // (1) in a stage; the dO (0) or Q (1) chunk operand.  The products take
  // them by warpgroup, not in branches: a wgmma on a divergent path is
  // serialised (ptxas C7520).
  const int own_off = wg * C::OWN_PANEL;
  const int tile_off = 2 * C::OWN_PANEL + wg * C::TILE_PANEL;
  const unsigned char* ct = chunk_s + wg * C::CHUNK_BYTES;

  float acc[kChunkCols / 2];   // dV (warpgroup 0) or dK (1): 64 x the chunk
#pragma unroll
  for (int i = 0; i < kChunkCols / 2; ++i) acc[i] = 0.0f;

  for (int it = 0; it < n; ++it) {
    float sc[TR / 2];   // S^T (warpgroup 0) or dP^T (1)
    chunk_stage_scores<C>(stages, full, empty, it * np, np,
                          [&](const unsigned char* st, bool first) {
                            chunk_scores_bf16<TR>(sc, st + own_off, st + tile_off, first);
                          });
#pragma unroll
    for (int i = 0; i < TR / 2; ++i) fence_regs(sc[i]);

    mbar_wait(full_c, it & 1);
    Step step;
    if constexpr (Sweep::kList) step = *step_s;   // staged by the producer
    else step = sw.dkv_step(b, it, kTileRows);
    const int q0 = step.tile * TR;
    const bool part = Sweep::kList && (step.flags & kPartial);
    const bool edge = part || q0 + TR > T_len || (causal && q0 < k0 + 63);
    uint32_t a[TR / 4];
    if (wg == 0) {
      // P^T, masked as dkv_split_consume masks it (element i: query row q0
      // + c, c = 8 (i / 4) + 2 t + (i & 1), key row key0 + 8 ((i >> 1) & 1))
#pragma unroll
      for (int i = 0; i < TR / 2; ++i)
        sc[i] = exp2f(fmaf(sc[i], scale_log2, -lse_s[8 * (i / 4) + 2 * t + (i & 1)]));
      if (edge) {
#pragma unroll
        for (int i = 0; i < TR / 2; ++i) {
          const int q = q0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int key = key0 + 8 * ((i >> 1) & 1);
          if (q >= T_len || (causal && key > q)) sc[i] = 0.0f;
        }
        if constexpr (Sweep::kList) {
          if (part) {
#pragma unroll
            for (int i = 0; i < TR / 2; ++i) {
              const int q = q0 + 8 * (i / 4) + 2 * t + (i & 1);
              const int key = key0 + 8 * ((i >> 1) & 1);
              if (q < T_len && (key >= S_len || !sw.keep(q, key))) sc[i] = 0.0f;
            }
          }
        }
      }
      if (it > 0) named_barrier_sync(kPtEmpty, kConsumers);
#pragma unroll
      for (int i = 0; i < TR / 2; ++i) pt_s[i * 128 + tid] = sc[i];
      named_barrier_arrive(kPtFull, kConsumers);
#pragma unroll
      for (int i = 0; i < TR / 4; ++i) a[i] = pack_bf16x2(sc[2 * i], sc[2 * i + 1]);
    } else {
      named_barrier_sync(kPtFull, kConsumers);
      // dS^T = P^T * (dP^T - delta) in bf16; where P^T is 0 on an edge or
      // partial tile, dP^T (NaN from a dead key row of V) is replaced by
      // delta first, so that dS^T is 0 by select
#pragma unroll
      for (int i = 0; i < TR / 4; ++i) {
        const int c = 8 * (i / 2) + 2 * t;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pv = pt_s[(2 * i + e) * 128 + tid];
          const float dp = edge && pv == 0.0f ? delta_s[c + e] : sc[2 * i + e];
          ds[e] = pv * (dp - delta_s[c + e]);
        }
        a[i] = pack_bf16x2(ds[0], ds[1]);
      }
      if (it + 1 < n) named_barrier_arrive(kPtEmpty, kConsumers);
    }
    // dV += P^T . dO (warpgroup 0), dK += dS^T . Q (1), over the chunk
    wgmma_fence();
    wgmma_accumulate<kChunkCols, C::LPANEL_T, TR / 16>(acc, a, ct);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kChunkCols / 2; ++i) fence_regs(acc[i]);
    mbar_arrive(empty_c);
  }

  // epilogue: dV (warpgroup 0) or dK * sm_scale (1) in bf16, the chunk's
  // own columns, two a store (element 4 j + 2 h of panel p: row key0 + 8
  // h, column col0 + p PW + 8 j + 2 t)
  const int D = np * kChunkPanel;
  const Chunk ch = chunk_of(chunk, D);
  __nv_bfloat16* out = (wg == 0 ? dv : dk) + (size_t)bh * S_len * D;
  const float scale = wg == 0 ? 1.0f : sm_scale;
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int j = 0; j < P::PW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = key0 + 8 * h;
        const int col = ch.col0 + p * P::PW + 8 * j + 2 * t;
        const float* v = acc + p * (P::PW / 2) + 4 * j + 2 * h;
        if (row < S_len && col >= ch.lo && col < ch.hi)
          *reinterpret_cast<uint32_t*>(out + (size_t)row * D + col) =
              pack_bf16x2(v[0] * scale, v[1] * scale);
      }
}

// The two consumer warpgroups of the chunked bf16 dQ, over the block's 64
// query rows q0 .. q0 + 63 (this thread holds rows row0 and row0 + 8 of
// each accumulator): each 64-key tile split by keys, as the f32 chunked dQ
// splits it.  Per stage warpgroup w adds the products of the Q and dO
// panels and keys 32 w .. 32 w + 31 of the K and V panels to S = Q . K^T
// and dP = dO . V^T (m64n32, both operands read from the stage, one f32
// accumulator each over the panels, chunk_stage_scores); then, from the
// chunk slot, it forms P and dS = P * (dP - delta) over its keys in its own
// registers (masked as the f32 chunked dQ masks them) and adds dS . K over
// the same keys to its own sum of dQ's chunk, dS packed to bf16 as the
// register A operand and K's chunk read MN-major: nothing crosses between
// the warpgroups per tile.  The two sums meet once, at the end, in the
// drained ring (kDqSum), added in one order for every element, and
// warpgroup 0 writes the chunk's own columns of dQ * sm_scale in bf16.
template <class Sweep>
__device__ __forceinline__ void dq_chunk_bf16_consume(
    const Sweep& sw, unsigned char* stages, const unsigned char* chunk_s, const Step* step_s,
    uint64_t* full, uint64_t* empty, uint64_t* full_c, uint64_t* empty_c,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, int bh, int b, int n, int np, int chunk, int T_len,
    int S_len, float scale_log2, float sm_scale, int causal) {
  using C = BwdChunkCfg<false, __nv_bfloat16>;
  using P = Panels<kChunkCols>;   // the chunk's panels
  constexpr int TR = C::TR;
  constexpr int KH = TR / 2;      // the keys of a warpgroup's half of a tile
  static_assert(TR == kTileRows, "a sweep step is one bf16 tile");
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int q0 = b * kTileRows;
  const int row0 = q0 + 16 * warp + lane / 4;
  // this warpgroup's keys in a tile panel and in the chunk operand
  const int key_off = KH * wg * C::L::RB;

  // this thread's two rows: LSE (times log2 e) and delta; rows past T
  // read LSE = 1e30, so their P is 0
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool in = row < T_len;
    lse_r[h] = (in ? lse[(size_t)bh * T_len + row] : BIG_LSE) * kLog2e;
    delta_r[h] = in ? delta[(size_t)bh * T_len + row] : 0.0f;
  }
  float acc[kChunkCols / 2];   // this warpgroup's keys' share of dQ's chunk
#pragma unroll
  for (int i = 0; i < kChunkCols / 2; ++i) acc[i] = 0.0f;

  for (int it = 0; it < n; ++it) {
    float sc[KH / 2], dp[KH / 2];
    chunk_stage_scores<C>(stages, full, empty, it * np, np,
                          [&](const unsigned char* st, bool first) {
                            const unsigned char* kp = st + 2 * C::OWN_PANEL + key_off;
                            chunk_scores_bf16<KH>(sc, st, kp, first);   // S = Q . K^T
                            chunk_scores_bf16<KH>(dp, st + C::OWN_PANEL, kp + C::TILE_PANEL,
                                                  first);               // dP = dO . V^T
                          });
#pragma unroll
    for (int i = 0; i < KH / 2; ++i) {
      fence_regs(sc[i]);
      fence_regs(dp[i]);
    }

    mbar_wait(full_c, it & 1);
    Step step;
    if constexpr (Sweep::kList) step = *step_s;   // staged by the producer
    else step = sw.dq_step(b, it, kTileRows);
    const int kw = step.tile * TR + KH * wg;   // this warpgroup's first key
    const bool part = Sweep::kList && (step.flags & kPartial);
    const bool edge = part || kw + KH > S_len || (causal && kw + KH - 1 > q0);

    // P = exp(S * scale - LSE), the masks first (a killed score to -inf);
    // element i is query row row0 + 8 ((i >> 1) & 1), key column kw + 8
    // (i / 4) + 2 t + (i & 1)
    if (edge) {
#pragma unroll
      for (int i = 0; i < KH / 2; ++i) {
        const int col = kw + 8 * (i / 4) + 2 * t + (i & 1);
        if (col >= S_len || (causal && col > row0 + 8 * ((i >> 1) & 1))) sc[i] = -INFINITY;
      }
      if constexpr (Sweep::kList) {
        if (part) {
#pragma unroll
          for (int i = 0; i < KH / 2; ++i) {
            const int col = kw + 8 * (i / 4) + 2 * t + (i & 1);
            const int row = row0 + 8 * ((i >> 1) & 1);
            if (col < S_len && (row >= T_len || !sw.keep(row, col))) sc[i] = -INFINITY;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < KH / 2; ++i) sc[i] = exp2f(fmaf(sc[i], scale_log2, -lse_r[(i >> 1) & 1]));
    // dS = P * (dP - delta) in bf16; where P is 0 on an edge or partial
    // tile, dP (NaN from a dead key row of V) is replaced by delta first
    uint32_t a[KH / 4];
#pragma unroll
    for (int i = 0; i < KH / 4; ++i) {
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float pv = sc[2 * i + e];
        const float d = delta_r[i & 1];
        ds[e] = pv * ((edge && pv == 0.0f ? d : dp[2 * i + e]) - d);
      }
      a[i] = pack_bf16x2(ds[0], ds[1]);
    }
    // dQ += dS . K over this warpgroup's keys, the chunk's columns
    wgmma_fence();
    wgmma_accumulate<kChunkCols, C::LPANEL_T, KH / 16>(acc, a, chunk_s + key_off);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kChunkCols / 2; ++i) fence_regs(acc[i]);
    mbar_arrive(empty_c);
  }

  // epilogue: warpgroup 1's share into the drained ring, added to
  // warpgroup 0's; dQ * sm_scale in bf16, the chunk's own columns
  float* share = reinterpret_cast<float*>(stages);
  named_barrier_sync(kDqSum, kConsumers);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < kChunkCols / 2; ++i) share[i * 128 + tid] = acc[i];
  }
  named_barrier_sync(kDqSum, kConsumers);
  if (wg != 0) return;
#pragma unroll
  for (int i = 0; i < kChunkCols / 2; ++i) acc[i] += share[i * 128 + tid];
  const int D = np * kChunkPanel;
  const Chunk ch = chunk_of(chunk, D);
  __nv_bfloat16* out = dq + (size_t)bh * T_len * D;
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int j = 0; j < P::PW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        const int col = ch.col0 + p * P::PW + 8 * j + 2 * t;
        const float* v = acc + p * (P::PW / 2) + 4 * j + 2 * h;
        if (row < T_len && col >= ch.lo && col < ch.hi)
          *reinterpret_cast<uint32_t*>(out + (size_t)row * D + col) =
              pack_bf16x2(v[0] * sm_scale, v[1] * sm_scale);
      }
}

// The shared memory of the chunked dK/dV (kDkv) or dQ: the stage ring, the
// chunk slot, P^T (dK/dV), the tile's LSE and delta (dK/dV), the ring's
// and the slot's barriers and, for a list sweep, the slot's step.  The
// producer and the consumers each lay it out after their setmaxnreg
// (pointers live across it are spilled); init() comes first, in every
// thread.
template <bool kDkv, typename T>
struct BwdChunkSmem {
  unsigned char* stages;
  unsigned char* chunk_s;
  float* pt_s;
  float* lse_s;
  float* delta_s;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* full_c;
  uint64_t* empty_c;
  Step* step_s;

  __device__ explicit BwdChunkSmem(unsigned char* raw) {
    using C = BwdChunkCfg<kDkv, T>;
    stages = align1024(raw);
    chunk_s = stages + C::STAGES * C::STAGE;
    pt_s = reinterpret_cast<float*>(chunk_s + C::CHUNKS * C::CHUNK_BYTES);
    lse_s = pt_s + C::PT_BYTES / 4;
    delta_s = lse_s + C::TR;
    full = reinterpret_cast<uint64_t*>(delta_s + C::TR);
    empty = full + C::STAGES;
    full_c = empty + C::STAGES;
    empty_c = full_c + 1;
    step_s = reinterpret_cast<Step*>(empty_c + 1);
  }

  // thread 0 initialises the barriers (the producer's warp arrives on
  // every full barrier), and the block synchronises
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < BwdChunkCfg<kDkv, T>::STAGES; ++s) {
        mbar_init(&full[s], 32);
        mbar_init(&empty[s], kConsumers);
      }
      mbar_init(full_c, 32);
      mbar_init(empty_c, kConsumers);
      mbar_fence_init();
    }
    __syncthreads();
  }
};

// dK/dV above head dim 256 (K2, K7) in T (bf16, or f32 on split
// products): grid (chunk_count(D) chunks of each of B*H heads, ceil(S /
// 64)); the sweep maps blockIdx.y to a block, blockIdx.x is head * chunks
// + chunk, so a head's chunks run side by side and share its operands in
// L2.  D is a multiple of kChunkPanel above kChunkCols, the same
// instantiation at every such D.  The block's chunk, head and tiles are
// worked out by the producer and the consumers each after their
// setmaxnreg: values live across it are spilled.
template <typename T, class Sweep>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_dkv_chunk_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int T_len, int S_len, int D, float scale_log2, float sm_scale, int causal,
                     int H, int h0, int chunks, const Sweep sw) {
  constexpr int kSub = kTileRows / BwdChunkCfg<true, T>::TR;   // tiles a sweep step
  extern __shared__ unsigned char smem_raw[];
  BwdChunkSmem<true, T>(smem_raw).init();
  const auto where = [&](int& chunk, int& bh, int& b, int& n) {
    chunk = blockIdx.x % chunks;
    bh = h0 + blockIdx.x / chunks;
    b = sw.dkv_block();
    n = sw.dkv_count(b, T_len, kTileRows) * kSub;   // 0: dK = dV = 0
  };
  int chunk, bh, b, n;
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kChunkBwdProducerRegs>();
    if (threadIdx.x < kConsumers + 32) {
      const BwdChunkSmem<true, T> m(smem_raw);
      where(chunk, bh, b, n);
      bwd_chunk_produce<true, T>(sw, &tm_k, &tm_v, &tm_q, &tm_do, m.stages, m.chunk_s,
                                 m.lse_s, m.delta_s, m.step_s, m.full, m.empty, m.full_c,
                                 m.empty_c, lse + (size_t)bh * T_len,
                                 delta + (size_t)bh * T_len, b, n, D / kChunkPanel,
                                 chunk_of(chunk, D).col0, T_len, bh % H, bh / H, bh, H);
    }
  } else {
    setmaxnreg_inc<kChunkBwdConsumerRegs>();
    const BwdChunkSmem<true, T> m(smem_raw);
    where(chunk, bh, b, n);
    if constexpr (kIsBf16<T>)
      dkv_chunk_bf16_consume(sw, m.stages, m.chunk_s, m.pt_s, m.lse_s, m.delta_s, m.step_s,
                             m.full, m.empty, m.full_c, m.empty_c, dk, dv, bh, b, n,
                             D / kChunkPanel, chunk, T_len, S_len, scale_log2, sm_scale, causal);
    else
      dkv_chunk_consume(sw, m.stages, m.chunk_s, m.pt_s, m.lse_s, m.delta_s, m.step_s, m.full,
                        m.empty, m.full_c, m.empty_c, dk, dv, bh, b, n, D / kChunkPanel, chunk,
                        T_len, S_len, scale_log2, sm_scale, causal);
  }
}

// dQ above head dim 256 (K3, K8) in T: grid (chunks of each of B*H heads,
// ceil(T / 64)), as bwd_dkv_chunk_kernel.
template <typename T, class Sweep>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_dq_chunk_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int T_len,
                    int S_len, int D, float scale_log2, float sm_scale, int causal, int H,
                    int h0, int chunks, const Sweep sw) {
  constexpr int kSub = kTileRows / BwdChunkCfg<false, T>::TR;   // tiles a sweep step
  extern __shared__ unsigned char smem_raw[];
  BwdChunkSmem<false, T>(smem_raw).init();
  const auto where = [&](int& chunk, int& bh, int& b, int& n) {
    chunk = blockIdx.x % chunks;
    bh = h0 + blockIdx.x / chunks;
    b = sw.dq_block();
    n = sw.dq_count(b, S_len, kTileRows) * kSub;   // 0: dQ = 0
  };
  int chunk, bh, b, n;
  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kChunkBwdProducerRegs>();
    if (threadIdx.x < kConsumers + 32) {
      const BwdChunkSmem<false, T> m(smem_raw);
      where(chunk, bh, b, n);
      bwd_chunk_produce<false, T>(sw, &tm_q, &tm_do, &tm_k, &tm_v, m.stages, m.chunk_s,
                                  m.lse_s, m.delta_s, m.step_s, m.full, m.empty, m.full_c,
                                  m.empty_c, lse, delta, b, n, D / kChunkPanel,
                                  chunk_of(chunk, D).col0, S_len, bh % H, bh / H, bh, H);
    }
  } else {
    setmaxnreg_inc<kChunkBwdConsumerRegs>();
    const BwdChunkSmem<false, T> m(smem_raw);
    where(chunk, bh, b, n);
    if constexpr (kIsBf16<T>)
      dq_chunk_bf16_consume(sw, m.stages, m.chunk_s, m.step_s, m.full, m.empty, m.full_c,
                            m.empty_c, lse, delta, dq, bh, b, n, D / kChunkPanel, chunk, T_len,
                            S_len, scale_log2, sm_scale, causal);
    else
      dq_chunk_consume(sw, m.stages, m.chunk_s, m.step_s, m.full, m.empty, m.full_c,
                       m.empty_c, lse, delta, dq, bh, b, n, D / kChunkPanel, chunk, T_len,
                       S_len, scale_log2, sm_scale, causal);
  }
}

// The arguments of one backward launch over heads h0 .. h0 + BH - 1 of H
// heads a batch: q, dO (., H, T, D) and k, v (., H, S, D) at their strides;
// lse, delta (., T) f32 and the outputs contiguous; all from their first
// head.
struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dO;
  const float* lse;
  const float* delta;
  void* out0;   // dK or dQ
  void* out1;   // dV
  HeadStrides sq, sk, sv, sdo;
  int H, h0, BH, T_len, S_len;
  float sm_scale;
  int causal;
  cudaStream_t stream;
};

// the four tensor maps of a launch at head dim D, encoded per launch and
// passed by value (a CUDA graph captures them): q and dO in boxes of
// q_rows rows, k and v in boxes of k_rows rows, PW columns wide
template <typename T>
cudaError_t encode_bwd_maps(const BwdArgs& a, int D, int PW, int q_rows, int k_rows,
                            CUtensorMap* tm) {
  const int heads = a.h0 + a.BH;
  cudaError_t err = encode_heads<T>(&tm[0], a.q, D, a.T_len, a.H, heads, a.sq, PW, q_rows);
  if (err == cudaSuccess)
    err = encode_heads<T>(&tm[1], a.dO, D, a.T_len, a.H, heads, a.sdo, PW, q_rows);
  if (err == cudaSuccess)
    err = encode_heads<T>(&tm[2], a.k, D, a.S_len, a.H, heads, a.sk, PW, k_rows);
  if (err == cudaSuccess)
    err = encode_heads<T>(&tm[3], a.v, D, a.S_len, a.H, heads, a.sv, PW, k_rows);
  return err;
}

// the dK/dV kernel over `sw` (out0 dK, out1 dV): bf16 (bwd_dkv_wgmma_kernel)
// or f32 (bwd_dkv_split_kernel)
template <int D, typename T = __nv_bfloat16, class Sweep>
cudaError_t launch_dkv_wgmma(const BwdArgs& a, const Sweep& sw) {
  using C = DkvCfg<D, T>;
  static_assert(C::SMEM <= kMaxSmemBytes, "bwd_dkv_wgmma tiles do not fit in shared memory");
  const int n_kb = (a.S_len + C::OWN - 1) / C::OWN;
  if (n_kb > 65535) return cudaErrorInvalidValue;
  CUtensorMap tm[4];
  cudaError_t err = encode_bwd_maps<T>(a, D, Panels<D, sizeof(T)>::PW, C::TILE_ROWS, C::OWN, tm);
  if (err != cudaSuccess) return err;
  auto kernel = [] {
    if constexpr (kIsBf16<T>) return bwd_dkv_wgmma_kernel<D, Sweep>;
    else return bwd_dkv_split_kernel<D, Sweep>;
  }();
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  err = smem_opt_in_once(kernel, (int)C::SMEM, mu, attr_set);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.BH, n_kb), kBwdThreads, C::SMEM, a.stream>>>(
      tm[0], tm[1], tm[2], tm[3], a.lse, a.delta, static_cast<T*>(a.out0),
      static_cast<T*>(a.out1), a.T_len, a.S_len, a.sm_scale * kLog2e, a.sm_scale, a.causal, a.H,
      a.h0, sw);
  return cudaGetLastError();
}

// the dQ kernel over `sw` (out0 dQ): bf16 (bwd_dq_wgmma_kernel) or f32
// (bwd_dq_split_kernel)
template <int D, typename T = __nv_bfloat16, class Sweep>
cudaError_t launch_dq_wgmma(const BwdArgs& a, const Sweep& sw) {
  using C = DqCfg<D, T>;
  static_assert(C::SMEM <= kMaxSmemBytes, "bwd_dq_wgmma tiles do not fit in shared memory");
  const int n_qb = (a.T_len + C::OWN - 1) / C::OWN;
  if (n_qb > 65535) return cudaErrorInvalidValue;
  CUtensorMap tm[4];
  cudaError_t err = encode_bwd_maps<T>(a, D, Panels<D, sizeof(T)>::PW, C::OWN, C::TILE_ROWS, tm);
  if (err != cudaSuccess) return err;
  auto kernel = [] {
    if constexpr (kIsBf16<T>) return bwd_dq_wgmma_kernel<D, Sweep>;
    else return bwd_dq_split_kernel<D, Sweep>;
  }();
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  err = smem_opt_in_once(kernel, (int)C::SMEM, mu, attr_set);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.BH, n_qb), kBwdThreads, C::SMEM, a.stream>>>(
      tm[0], tm[1], tm[2], tm[3], a.lse, a.delta, static_cast<T*>(a.out0), a.T_len, a.S_len,
      a.sm_scale * kLog2e, a.sm_scale, a.causal, a.H, a.h0, sw);
  return cudaGetLastError();
}

// the chunked dK/dV (kDkv: out0 dK, out1 dV) or dQ (out0 dQ) over `sw` at a
// head dim D above 256 (a multiple of kChunkPanel; the wrappers zero-pad
// to one), operands of type T (bf16 or f32)
template <bool kDkv, typename T, class Sweep>
cudaError_t launch_bwd_chunked(const BwdArgs& a, int D, const Sweep& sw) {
  using C = BwdChunkCfg<kDkv, T>;
  static_assert(C::SMEM <= kMaxSmemBytes, "bwd_chunk tiles do not fit in shared memory");
  if (D <= kChunkCols || D % kChunkPanel) return cudaErrorInvalidValue;
  const int n_b = ((kDkv ? a.S_len : a.T_len) + kTileRows - 1) / kTileRows;
  const int chunks = chunk_count(D);
  if (n_b > 65535 || (long long)a.BH * chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap tm[4];
  cudaError_t err = encode_bwd_maps<T>(a, D, C::L::PW, kDkv ? C::TR : kTileRows,
                                       kDkv ? kTileRows : C::TR, tm);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.BH * chunks, n_b);
  const float scale_log2 = a.sm_scale * kLog2e;
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  if constexpr (kDkv) {
    auto kernel = bwd_dkv_chunk_kernel<T, Sweep>;
    err = smem_opt_in_once(kernel, (int)C::SMEM, mu, attr_set);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kBwdThreads, C::SMEM, a.stream>>>(
        tm[0], tm[1], tm[2], tm[3], a.lse, a.delta, static_cast<T*>(a.out0),
        static_cast<T*>(a.out1), a.T_len, a.S_len, D, scale_log2, a.sm_scale, a.causal, a.H,
        a.h0, chunks, sw);
  } else {
    auto kernel = bwd_dq_chunk_kernel<T, Sweep>;
    err = smem_opt_in_once(kernel, (int)C::SMEM, mu, attr_set);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kBwdThreads, C::SMEM, a.stream>>>(
        tm[0], tm[1], tm[2], tm[3], a.lse, a.delta, static_cast<T*>(a.out0), a.T_len,
        a.S_len, D, scale_log2, a.sm_scale, a.causal, a.H, a.h0, chunks, sw);
  }
  return cudaGetLastError();
}

}  // namespace
