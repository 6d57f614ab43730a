// Block-sparse attention (K6 forward, K7 dK/dV, K8 dQ) and the block-sparse
// matmul (K9) for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernels of bigdl_tpu/ops/block_sparse.py:
//   * K6 `_bs_fwd_kernel`, K7 `_bs_dkv_kernel`, K8 `_bs_dq_kernel` (launched
//     by `_bs_fwd` / `_bs_bwd`): the flash-attention tiles of flash_fwd.cu and
//     flash_bwd.cu, swept over a list of live tiles instead of the dense
//     (causal) range.  Each computes exactly what its flash twin computes
//     (f32 scores times sm_scale, top-left causal mask, online softmax with
//     f32 (m, l, acc), P cast to v's dtype, LSE with the 1e30 sentinel;
//     P = exp(S - LSE), dS = P * (dP - delta), dK and dQ times sm_scale),
//     under the block mask as well;
//   * K9 `_bs_mm_kernel` (launched by `_bs_mm_fwd`): x[M, K] @ W[K, N] over
//     the live (K block, N block) tiles of W only, f32 accumulation, out in
//     x's dtype.  Its backward dX is K9 again on (g, W^T, mask^T), W^T read
//     from W's own bytes.
//
// Tables.  The TPU grid sweeps mask blocks; these kernels work on 64-row
// tiles, so the host (ops/block_sparse.py `_tile_tables`) builds the
// lists at tile granularity (and regroups them per 128 or 64 own rows for
// the Hopper bodies, below): for each q tile (K6, K8) the k tiles holding a
// live element, for each k tile (K7) the q tiles, in ascending order, each
// with a `partial` flag when the block mask does not cover the whole tile
// pair.  An all-ones causal mask therefore gives K1's sweep exactly.
// In a partial pair the kernel tests every element against the block mask
// (a uint8 (T / bq, S / bk) grid, causal blocks pruned) beside the causal
// test, and zero-fills, instead of loading, the rows of the other side's
// tile that no row of its own tile may attend: a dead element never
// reaches a product (0 * NaN is NaN), so NaN in dead K/V cannot leak.  A
// masked score is selected to -inf (forward) or its P and dS to 0
// (backward).  Rows of the block's own tile are loaded whole: a dead row
// there yields only masked scores, which the select discards.  A q tile
// with no live k tile writes O = 0 and LSE = 1e30 and dQ = 0; a k tile
// with no live q tile writes dK = dV = 0.  Each output row has one owner
// block: no atomics, deterministic.
//
// What bounds them on an H100.  At the block-sparse training shape (B 4,
// H 8, T = S = 4096, D 128, bf16, causal, sliding window 2 + 1 global at
// block 512) 4,458,496 of the 16.8 M score elements per head are live;
// each T x S x D product over them is 36.5 GFLOP.  K6 makes two (73.0
// GFLOP, 0.074 ms at 989 TFLOP/s, against 135 MB, 0.040 ms), K7 four and
// K8 three: all three are bound by operations, so the products must run
// on wgmma, fed by TMA, with the intermediates in registers.
//
// K6, K7 and K8 design.  In bf16 they are K1's and K2/K3's Hopper kernels
// (attn_fwd_hopper.cuh, attn_bwd_hopper.cuh: TMA ring, wgmma,
// accumulators in registers; q, k, v and dO read at their own strides) with
// a tile list in place of the dense sweep (ListSweep below), at D 16-128 and
// at 192 and 256, the bf16 route of head dims 129-256: the host regroups the
// 64-row tile lists per block of 128 own rows, the block's two consumer
// warpgroups each computing the streamed tiles its own 64 rows visit (K7
// and K8 at D 192 and 256 own 64 rows a block and read the 64-row tile
// lists); K6 reads K8's 128-row lists (the same own query rows, the same
// streamed K and V tiles).  A streamed tile with a
// partial pair is staged by the producer's first warp, live rows only, so
// the TMA load of a dead row never happens; inside a partial pair each
// element is tested against the block mask and its score selected to -inf
// (K6) or its P and dS to 0 (K7, K8).  In f32 each f32 product is formed
// from bf16 wgmma products on bf16 pieces of its operands: K6 is K1's f32
// forward (attn_fwd_hopper.cuh's attn_fwd_split_kernel) over the same
// 128-row query lists as in bf16; K7 is K2's f32 dK/dV block
// (attn_bwd_hopper.cuh's bwd_dkv_split_kernel: 64 key rows a block) over
// the 64-row key lists K7 reads at bf16 D 192 and 256, and K8 is K3's f32
// dQ block (bwd_dq_split_kernel: 64 query rows a block) over the 64-row
// query lists K8 reads there.  At f32 D 192 and 256 all three stream each
// 64-row list step as two 32-row tiles (a partial pair's live rows split
// with it).  Above D 256 K6 is K1's chunked forward (attn_fwd_hopper.cuh's
// attn_fwd_chunk_kernel, one instantiation per dtype for every head dim)
// over the same 128-row query lists, a partial pair's live rows staged for
// every 64-column panel of K and for V's 256-column chunk; K7 and K8 are
// K2's and K3's chunked backward (attn_bwd_hopper.cuh's
// bwd_dkv_chunk_kernel, bwd_dq_chunk_kernel, one instantiation per dtype)
// over the 64-row key and query lists, a partial pair's live rows staged
// for every panel and chunk operand.  On an all-ones mask both dtypes give
// K1-K3's bits.
//
// K9 design.  At the flagship MLP shape (x 16384 x 1024 bf16, W 1024 x 4096
// at density 0.5, block 128) it must do 68.7 GFLOP (0.069 ms) and move about
// 172 MB (0.051 ms): bound by operations, so in bf16 it is a GEMM on wgmma
// fed by TMA (bs_mm_kernel_wgmma), the nearest model K5's implicit GEMM
// (conv3x3.cu).  A block of two consumer warpgroups and one producer warp
// (288 threads, two blocks an SM) owns 128 rows of x by BN output columns of
// one column block (BN the largest of 128, 64, 32, 16 that divides bn).  The
// producer walks the column block's live K blocks in chunks of KC (the
// largest of 64, 32, 16 that divides bk, so a chunk never reaches into a dead
// block: NaN there is never loaded) and loads, per chunk, two 64-row x boxes
// and W's box into a ring of stages (full and empty mbarriers).  W is read in
// place in either orientation: MN-major (the forward's W) as BN / 64 panels
// of KC rows, each the transposed B of one n64 product (as K1 reads V), or
// K-major (dX's W^T, which is W's storage) as one box of BN rows of KC,
// the plain B of one n-BN product.  TMA zero-fills x's rows past M; the
// epilogue rounds to bf16, stages the tile in the consumer's own x slots in
// TMA's swizzled layout and writes it with TMA stores, which clip at M; a
// column block with no live block writes zeros.  N tiles vary fastest over
// the grid.  What bounds it on the card is the L2 -> SM traffic of the
// boxes (64 FLOP a byte at 128 x 128 tiles), not the products (PERF.md).
// In f32 (bs_mm_kernel_split) the same walk and grid form every f32
// product from six bf16 products on three bf16 pieces of each operand, as
// K5 does in f32 (conv3x3.cu), with the consumers K5 shares
// (hopper_common.cuh, split_gemm): the wrapper splits W once per call into
// three bf16 pieces in W's own orientation (so dX still reads W's storage
// K-major, nothing transposed), read with the bf16 route's boxes; x lands
// in f32 boxes (KC 32 or 16: 128- or 64-byte rows) that each consumer
// warpgroup reads straight into wgmma's register operand and splits there,
// the next step's box while a step's six products a k16 step run; each
// step's products go to a fresh partial, added to the f32 total (round to
// nearest), since wgmma rounds its sums toward zero.  The f32 total, the
// partial and two split boxes take about 200 registers at BN 128, so the
// block is two consumer warpgroups and a producer warpgroup that gives its
// registers up (setmaxnreg 40 / 232), one block an SM with a ring of up to
// 8 stages; the epilogue stores f32 straight from the total, a warp writing
// whole 32-byte sectors.  Six products make it bound by operations (68.7
// GFLOP at the MLP shape, 0.417 ms at 989 / 6 TFLOP/s); its boxes move 4
// bytes an x element and 6 a W element from L2.
// Blocks that are not multiples of 64 (any bk and bn, in either dtype)
// take the coarse route: at blocks that are not multiples of 16 a K chunk
// cannot stay inside a block (a wgmma step is 16 deep, a TMA box row 16
// bytes), and at 16 and 32 the block walk's narrow N tiles re-read x from
// L2 for every one (measured slower, PERF.md).  The wrapper writes
// a masked copy of W once per call (bs_mm_mask_kernel: W's live elements,
// zeros at its dead ones and in the padding up to whole coarse tiles, in
// W's own orientation, so dX still reads W's storage K-major; in f32
// straight as its three bf16 pieces), and the kernels above walk coarse
// (KC x BN) tiles of the copy as if they were the mask's blocks: the host
// lists, for each BN-column tile, the KC-row chunks that hold a live
// element.  The copy is a select, not a product, so NaN in a dead block
// never reaches a product.  x's tensor map zero-fills past K, the bf16 TMA
// store clips at N, and the f32 epilogue writes whole tiles into an output
// row padded to them.  At small blocks nearly every coarse tile holds a
// live element, so the route does the dense product's work, as a matmul
// on the masked W does.  Every route takes any M and any number of column
// tiles (a 1-D grid).

#include "attn_bwd_hopper.cuh"
#include "attn_fwd_hopper.cuh"

namespace {

// One row per block of the own side: the tiles of the other side to visit.
// Row r's first counts[r] entries of tiles / partial are live.
struct Tables {
  const int* tiles;        // (rows, L)
  const int* counts;       // (rows,)
  const uint8_t* partial;  // (rows, L): the flag bytes of ListSweep below
  int L;
};

// The runtime block mask, read inside partial tile pairs only.
struct Mask {
  const uint8_t* m;  // (T / bq, S / bk) row-major
  int nkb, bq, bk;
  int T_len, S_len, causal;

  __device__ __forceinline__ bool block(int qp, int kp) const {
    return m[(qp / bq) * nkb + kp / bk] != 0;
  }
};

// ---------------------------------------------------------------------------
// K6, K7 and K8 in both dtypes: the Hopper bodies of attn_fwd_hopper.cuh and
// attn_bwd_hopper.cuh over the tile lists of 128-row (or 64-row) blocks.
// ---------------------------------------------------------------------------

// The lists ops/block_sparse.py builds per block of 128 own rows (key rows
// in K7, query rows in K6 and K8, which read the same lists): the ascending
// union of the lists of its two 64-row tiles, a flag byte per entry (bit w:
// tile w of the block visits the streamed tile; bit 2 + w: that pair is
// partial), the streamed rows some row of the block attends (bit r for row
// r, read at partial entries only), and the blocks in order of their list
// length, longest first.  On an all-ones causal mask at a 128-multiple block
// the lists are the dense sweeps of K1 (at D 128) and K2/K3, tile for tile,
// so K6-K8 give K1-K3's bits.  K7 and K8 at D 192 and 256 own 64 rows a
// block and read the same lists built per 64-row key (K7) or query (K8)
// tile (bit 0 and bit 2 only), as do the f32 K7 and K8 at every D; the f32
// K6 reads the 128-row lists, as in bf16.  T is the streamed tensors' type
// (bf16 or f32).
template <typename T = __nv_bfloat16>
struct ListSweep {
  static constexpr bool kList = true;
  const int* tiles;                 // (blocks, L)
  const uint8_t* flags;             // (blocks, L)
  const unsigned long long* rows;   // (blocks, L)
  const int* counts;                // (blocks,)
  const int* order;                 // (blocks,)
  int L;
  Mask mk;
  const T* src_a;                   // the streamed tensors: q, dO (K7); k, v (K8)
  const T* src_b;
  HeadStrides stride_a, stride_b;   // at their strides

  __device__ int dkv_block() const { return order[blockIdx.y]; }
  __device__ int dq_block() const { return order[blockIdx.y]; }
  __device__ int dkv_count(int b, int, int) const { return counts[b]; }
  __device__ int dq_count(int b, int, int) const { return counts[b]; }
  __device__ Step dkv_step(int b, int it, int) const { return fwd_step(b, it); }
  __device__ Step dq_step(int b, int it, int) const { return fwd_step(b, it); }
  __device__ int fwd_block() const { return order[blockIdx.y]; }
  __device__ int fwd_count(int b, int) const { return counts[b]; }
  __device__ Step fwd_step(int b, int it) const {
    const size_t e = (size_t)b * L + it;
    return Step{tiles[e], flags[e]};
  }
  __device__ bool keep(int qp, int kp) const { return mk.block(qp, kp); }
  __device__ unsigned long long live(int b, int it) const { return rows[(size_t)b * L + it]; }
};

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dO;
  const float* lse;
  const float* delta;
  void* out0;   // O (K6), dK (K7) or dQ (K8)
  void* out1;   // LSE (K6) or dV (K7)
  // the block lists: per 128 own rows (K7 and K8 at bf16 D > 128 and in
  // f32: per 64)
  Tables tab;
  const int* order;  // the blocks, longest list first
  const unsigned long long* rows;   // live streamed rows
  Mask mk;
  HeadStrides sq, sk, sv, sdo;   // q, k, v, dO at their strides
  int H, h0, BH;                 // heads h0 .. h0 + BH - 1, H a batch
  float sm_scale;
  cudaStream_t stream;
};

enum class Which { kFwd, kDkv, kDq };

// the sweep over the block lists of `a`, streaming q and dO (K7, dkv) or
// k and v (K6, K8) at their strides
template <typename T>
ListSweep<T> list_sweep(const AttnArgs& a, bool dkv) {
  return ListSweep<T>{a.tab.tiles, a.tab.partial, a.rows, a.tab.counts, a.order, a.tab.L, a.mk,
                      static_cast<const T*>(dkv ? a.q : a.k),
                      static_cast<const T*>(dkv ? a.dO : a.v),
                      dkv ? a.sq : a.sk, dkv ? a.sdo : a.sv};
}

// K6's arguments: out0 O, out1 LSE
inline FwdArgs fwd_args(const AttnArgs& a) {
  return FwdArgs{a.q, a.k, a.v, a.out0, a.out1, a.sq, a.sk, a.sv, a.H, a.h0, a.BH, a.mk.T_len,
                 a.mk.S_len, a.sm_scale, a.mk.causal, a.stream};
}

// K7's and K8's arguments: out0 dK or dQ, out1 dV
inline BwdArgs bwd_args(const AttnArgs& a) {
  return BwdArgs{a.q, a.k, a.v, a.dO, a.lse, a.delta, a.out0, a.out1, a.sq, a.sk, a.sv, a.sdo,
                 a.H, a.h0, a.BH, a.mk.T_len, a.mk.S_len, a.sm_scale, a.mk.causal, a.stream};
}

// K6 (out0 O, out1 LSE), K7 (out0 dK, out1 dV) or K8 (out0 dQ) over the
// block lists, in bf16 or f32 (T)
template <Which W, int D, typename T = __nv_bfloat16>
cudaError_t launch_wgmma(const AttnArgs& a) {
  const ListSweep<T> sw = list_sweep<T>(a, W == Which::kDkv);
  if constexpr (W == Which::kFwd)
    return launch_fwd_wgmma<D, kFwdTileRows<D, T>, T>(fwd_args(a), sw);
  else if constexpr (W == Which::kDkv) return launch_dkv_wgmma<D, T>(bwd_args(a), sw);
  else return launch_dq_wgmma<D, T>(bwd_args(a), sw);
}

// both dtypes at D 16-256, over the block lists (order and rows given)
template <Which W, typename T, int D>
cudaError_t launch_attn(const AttnArgs& a) {
  if (a.order == nullptr || a.rows == nullptr) return cudaErrorInvalidValue;
  return launch_wgmma<W, D, T>(a);
}

// Above head dim 256 (a multiple of 64), in either dtype: K6 the chunked
// forward over the 128-row query lists, K7 and K8 the chunked backward
// over the 64-row key and query lists; one instantiation for every D.
template <Which W, typename T>
cudaError_t launch_chunked_list(int D, const AttnArgs& a) {
  if (a.order == nullptr || a.rows == nullptr) return cudaErrorInvalidValue;
  const ListSweep<T> sw = list_sweep<T>(a, W == Which::kDkv);
  if constexpr (W == Which::kFwd)
    return launch_fwd_chunked<T>(fwd_args(a), D, sw);
  else
    return launch_bwd_chunked<W == Which::kDkv, T>(bwd_args(a), D, sw);
}

template <Which W, typename T>
cudaError_t dispatch_attn_d(int D, const AttnArgs& a) {
  switch (D) {
    case 16: return launch_attn<W, T, 16>(a);
    case 32: return launch_attn<W, T, 32>(a);
    case 64: return launch_attn<W, T, 64>(a);
    case 128: return launch_attn<W, T, 128>(a);
    case 192: return launch_attn<W, T, 192>(a);
    case 256: return launch_attn<W, T, 256>(a);
    default: return launch_chunked_list<W, T>(D, a);
  }
}

template <Which W>
int dispatch_attn(int D, int dtype, const AttnArgs& a) {
  const Mask& mk = a.mk;
  if (a.BH <= 0 || a.BH > 65535 || a.H <= 0 || a.h0 < 0 || mk.T_len <= 0 || mk.S_len <= 0 ||
      mk.bq <= 0 || mk.bk <= 0 || mk.T_len % mk.bq || mk.S_len % mk.bk ||
      mk.nkb != mk.S_len / mk.bk || a.tab.L <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) return (int)dispatch_attn_d<W, __nv_bfloat16>(D, a);
  if (dtype == 0) return (int)dispatch_attn_d<W, float>(D, a);
  return (int)cudaErrorInvalidValue;
}

AttnArgs make_args(const void* q, const void* k, const void* v, const void* dO, const void* lse,
                   const void* delta, void* out0, void* out1, const void* tiles,
                   const void* counts, const void* partial, const void* bmask, const void* order,
                   const void* rows, int L, int nkb, int bq, int bk, const long long* strides,
                   int H, int h0, int BH, int T_len, int S_len, float sm_scale, int causal,
                   void* stream) {
  const HeadStrides none{0, 0, 0};
  return AttnArgs{q, k, v, dO, static_cast<const float*>(lse), static_cast<const float*>(delta),
                  out0, out1,
                  Tables{static_cast<const int*>(tiles), static_cast<const int*>(counts),
                         static_cast<const uint8_t*>(partial), L},
                  static_cast<const int*>(order), static_cast<const unsigned long long*>(rows),
                  Mask{static_cast<const uint8_t*>(bmask), nkb, bq, bk, T_len, S_len, causal},
                  head_strides(strides, 0), head_strides(strides, 1), head_strides(strides, 2),
                  dO ? head_strides(strides, 3) : none, H, h0, BH, sm_scale,
                  static_cast<cudaStream_t>(stream)};
}

template <Which W, int D>
int smem_of(int dtype) {
  if (dtype == 1)
    return (int)(W == Which::kFwd   ? FwdCfg<D, kTileRows>::SMEM
                 : W == Which::kDkv ? DkvCfg<D>::SMEM
                                    : DqCfg<D>::SMEM);
  if (dtype == 0)
    return (int)(W == Which::kFwd   ? FwdCfg<D, kFwdTileRows<D, float>, float>::SMEM
                 : W == Which::kDkv ? DkvCfg<D, float>::SMEM
                                    : DqCfg<D, float>::SMEM);
  return 0;
}

template <Which W>
int smem_of_d(int D, int dtype) {
  switch (D) {
    case 16: return smem_of<W, 16>(dtype);
    case 32: return smem_of<W, 32>(dtype);
    case 64: return smem_of<W, 64>(dtype);
    case 128: return smem_of<W, 128>(dtype);
    case 192: return smem_of<W, 192>(dtype);
    case 256: return smem_of<W, 256>(dtype);
  }
  if (D <= kChunkCols || D % kChunkPanel) return 0;
  if (W == Which::kFwd)
    return dtype == 1 ? (int)ChunkCfg<__nv_bfloat16>::SMEM
                      : dtype == 0 ? (int)ChunkCfg<float>::SMEM : 0;
  if (dtype == 1)
    return (int)(W == Which::kDkv ? BwdChunkCfg<true, __nv_bfloat16>::SMEM
                                  : BwdChunkCfg<false, __nv_bfloat16>::SMEM);
  if (dtype == 0)
    return (int)(W == Which::kDkv ? BwdChunkCfg<true, float>::SMEM
                                  : BwdChunkCfg<false, float>::SMEM);
  return 0;
}

// ---------------------------------------------------------------------------
// K9.  Both routes compute out (M, N) = x (M, K) . W (K, N) over W's live
// (bk, bn) blocks: output column block c sums x's K blocks against W's live
// blocks of c only.  x's rows lie ldx elements apart.  W (the B operand)
// is read in place: MN-major (element (k, n) at w[k * ldw + n], W as the
// forward gets it) or K-major (at w[n * ldw + k]: the backward's dX reads
// W^T so, which is W's own storage).  out is contiguous.
// ---------------------------------------------------------------------------

// ---- bf16: a block-masked GEMM on TMA and wgmma --------------------------------

constexpr int kMmThreads = kConsumers + 32;   // two consumer warpgroups, a producer warp
constexpr int kMmBlocksPerSm = 2;
constexpr int kMmRows = 128;                  // output rows of a block, 64 a warpgroup
constexpr int kMmRingBytes = 98304;           // the ring of a block: two fit on an SM

// The ring's stages: each holds both consumers' x boxes (64 rows of KC
// columns, K-major, the swizzle of a KC * 2-byte row) and W's boxes for the
// block's BN output columns: one box of BN rows of KC (K-major W), or BN /
// PW panels of KC rows of PW <= 64 columns (MN-major W), so that every
// wgmma stays within one swizzle panel in N.
template <int KC, int BN, bool KMAJ>
struct MmCfg {
  static constexpr int kChunk = KC;
  static constexpr int kCols = BN;
  static constexpr bool kKMajor = KMAJ;
  static constexpr int kThreads = kMmThreads;
  static constexpr int kBlocksPerSm = kMmBlocksPerSm;
  static constexpr int RA = KC * 2;                        // bytes of an x box row
  static constexpr int PW = KMAJ ? KC : (BN < 64 ? BN : 64);   // elements of a W box row
  static constexpr int RB = PW * 2;                        // its bytes = its swizzle span
  static constexpr int NP = KMAJ ? 1 : BN / PW;            // W boxes a step
  static constexpr int PANEL = (KMAJ ? BN : KC) * RB;      // bytes of one W box
  static constexpr int A_SLOT = 64 * RA;                   // one consumer's x box
  static constexpr int B_BYTES = KC * BN * 2;              // the step's W boxes
  static constexpr int B_SLOT = B_BYTES < 1024 ? 1024 : B_BYTES;   // 1024-byte aligned
  static constexpr int STAGE = 2 * A_SLOT + B_SLOT;
  static constexpr int STAGES = kMmRingBytes / STAGE < 8 ? kMmRingBytes / STAGE : 8;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
  // the epilogue stages a consumer's 64 x BN outputs in its own x slots
  static_assert(STAGES * A_SLOT >= 64 * BN * 2, "bs_mm: epilogue rows do not fit");
  static_assert(STAGES >= 2, "bs_mm: the ring needs two stages");
};

// A consumer's 64 x BN accumulator in bf16 into 64-row panels of PW <= 64
// columns at `rows` (panel pitch 64 PW 2 bytes), laid out as a TMA box of
// the panel's swizzle lands: 16-byte chunk j of row r at j xor address bits
// 7.. (Swizzle<3,4,3> at 128-byte rows, <2,4,3> at 64, <1,4,3> at 32).
template <int BN>
__device__ __forceinline__ void stage_out(unsigned char* rows, const float* acc) {
  using P = Panels<BN>;
  constexpr uint32_t SWZ = (P::RB / 16 - 1) << 4;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int p = 0; p < P::NP; ++p)
#pragma unroll
    for (int j = 0; j < P::PW / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t a = (16 * warp + lane / 4 + 8 * h) * P::RB + 16 * j + 4 * (lane % 4);
        const float* v = acc + p * (P::PW / 2) + 4 * j + 2 * h;
        *reinterpret_cast<uint32_t*>(rows + p * 64 * P::RB + (a ^ ((a >> 3) & SWZ))) =
            pack_bf16x2(v[0], v[1]);
      }
}

// grid (m_tiles * n_tiles): block i computes rows 128 (i / n_tiles) ..
// +127 of output columns BN (i % n_tiles) .. +BN-1, which lie in one column
// block.  N tiles vary fastest: the blocks in flight share their x rows,
// write whole output rows, and all of W stays in L2 (measured faster than M
// fastest, PERF.md).
template <int KC, int BN, bool KMAJ>
__global__ void __launch_bounds__(kMmThreads, kMmBlocksPerSm)
bs_mm_kernel_wgmma(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_out, const int* __restrict__ tiles,
                   const int* __restrict__ counts, int L, int M, int bk, int bn, int n_tiles) {
  using C = MmCfg<KC, BN, KMAJ>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* a_s = align1024(smem_raw);              // [consumer][stage] x boxes
  unsigned char* b_s = a_s + 2 * C::STAGES * C::A_SLOT;  // [stage] W boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + C::STAGES * C::B_SLOT);
  uint64_t* empty = full + C::STAGES;

  const int m0 = (blockIdx.x / n_tiles) * kMmRows;
  const int n0 = (blockIdx.x % n_tiles) * BN;
  const int cb = n0 / bn;              // the output column block
  const int chunks = bk / KC;          // steps a live K block
  const int n_steps = counts[cb] * chunks;   // 0: the block writes zeros

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      // a second x box only where the block has rows past its first 64
      const bool two = m0 + 64 < M;
      const uint32_t bytes = (two ? 2 : 1) * C::A_SLOT + C::B_BYTES;
      const int* kblocks = tiles + (size_t)cb * L;
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % C::STAGES;
        const int k0 = kblocks[it / chunks] * bk + (it % chunks) * KC;
        mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);   // the first round passes
        mbar_arrive_expect_tx(&full[s], bytes);
        tma_load_2d(a_s + s * C::A_SLOT, &tm_x, &full[s], k0, m0);
        if (two) tma_load_2d(a_s + (C::STAGES + s) * C::A_SLOT, &tm_x, &full[s], k0, m0 + 64);
        unsigned char* b = b_s + s * C::B_SLOT;
        if constexpr (KMAJ) {
          tma_load_2d(b, &tm_w, &full[s], k0, n0);
        } else {
#pragma unroll
          for (int p = 0; p < C::NP; ++p)
            tma_load_2d(b + p * C::PANEL, &tm_w, &full[s], n0 + p * C::PW, k0);
        }
      }
    }
  } else {
    const int wg = threadIdx.x / 128;
    const int row0 = m0 + 64 * wg;
    const bool live = row0 < M;   // else only the barriers, in step
    unsigned char* a_wg = a_s + wg * C::STAGES * C::A_SLOT;

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int it = 0; it < n_steps; ++it) {
      const int s = it % C::STAGES;
      mbar_wait(&full[s], (it / C::STAGES) & 1);
      if (live) {
        const unsigned char* a = a_wg + s * C::A_SLOT;
        const unsigned char* b = b_s + s * C::B_SLOT;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < KC / 16; ++j) {
          const uint64_t da = smem_desc<C::RA>(a + 32 * j);
          if constexpr (KMAJ) {
            // B = W^T's rows, K-major: each k16 step 32 bytes along them
            wgmma_ss<BN, 0>(acc, da, smem_desc<C::RB>(b + 32 * j), 1);
          } else {
            // B = W's rows, MN-major (transposed B): each k16 step 16 rows
            // further down, one product per 64-column panel
#pragma unroll
            for (int p = 0; p < C::NP; ++p)
              wgmma_ss<C::PW, 1>(acc + p * (C::PW / 2), da,
                                 smem_desc<C::RB>(b + p * C::PANEL + 16 * C::RB * j), 1);
          }
        }
        wgmma_commit();
        // the stage is free once its products are done: the other three
        // warpgroups on the SM keep the tensor cores busy meanwhile
        wgmma_wait<0>();
      }
      mbar_arrive(&empty[s]);
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_regs(acc[i]);

    // epilogue: bf16 into this warpgroup's own x slots (every load into
    // them has landed and been read), then TMA stores of the rows below M
    if (live) {
      using P = Panels<BN>;
      stage_out<BN>(a_wg, acc);
      fence_proxy_async();
      named_barrier_sync(1 + wg, 128);
      if (threadIdx.x % 128 == 0) {
#pragma unroll
        for (int p = 0; p < P::NP; ++p)
          tma_store_2d(&tm_out, a_wg + p * 64 * P::RB, n0 + p * P::PW, row0);
        tma_store_flush();
      }
    }
  }
}

// What one K9 launch reads (bigdl_bs_mm's arguments): W (K, N) in (bk,
// bn) blocks; x's first kx <= K columns (TMA zero-fills the rest), out's
// first nout <= N columns, its rows ldo elements apart.
struct MmArgs {
  const void* x;
  const void* w;
  void* out;
  const int* tiles;
  const int* counts;
  int L, M, K, N, bk, bn, ldx, ldw, kmajor, kx, nout, ldo;
  cudaStream_t stream;
};

template <template <int, int, bool> class Cfg, int KC, int BN, class R, class F>
R mm_with_kmajor(int kmajor, F f) {
  return kmajor ? f(Cfg<KC, BN, true>{}) : f(Cfg<KC, BN, false>{});
}

template <template <int, int, bool> class Cfg, int KC, class R, class F>
R mm_with_bn(int bn, int kmajor, R none, F f) {
  switch (bn) {
    case 16: return mm_with_kmajor<Cfg, KC, 16, R>(kmajor, f);
    case 32: return mm_with_kmajor<Cfg, KC, 32, R>(kmajor, f);
    case 64: return mm_with_kmajor<Cfg, KC, 64, R>(kmajor, f);
    case 128: return mm_with_kmajor<Cfg, KC, 128, R>(kmajor, f);
  }
  return none;
}

// f(MmCfg<KC, BN, kmajor>{}) for the bf16 Hopper route's instantiation at
// (kc, bn, kmajor), or `none`
template <class R, class F>
R with_mm_cfg(int kc, int bn, int kmajor, R none, F f) {
  switch (kc) {
    case 16: return mm_with_bn<MmCfg, 16>(bn, kmajor, none, f);
    case 32: return mm_with_bn<MmCfg, 32>(bn, kmajor, none, f);
    case 64: return mm_with_bn<MmCfg, 64>(bn, kmajor, none, f);
  }
  return none;
}

template <int KC, int BN, bool KMAJ>
auto mm_kernel(MmCfg<KC, BN, KMAJ>) {
  return bs_mm_kernel_wgmma<KC, BN, KMAJ>;
}

// the once-per-device shared-memory opt-in of Cfg's kernel (mm_kernel)
template <class Cfg>
cudaError_t mm_opt_in() {
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  return smem_opt_in_once(mm_kernel(Cfg{}), (int)Cfg::SMEM, mu, attr_set,
                          Cfg::kBlocksPerSm > 1);
}

template <class Cfg>
cudaError_t launch_mm_wgmma(const MmArgs& a) {
  constexpr int KC = Cfg::kChunk, BN = Cfg::kCols;
  static_assert(kMmBlocksPerSm * (Cfg::SMEM + 1024) <= 233472, "bs_mm: two blocks must share an SM");
  const bool aligned = (reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.w) |
                        reinterpret_cast<uintptr_t>(a.out)) % 16 == 0;
  // a K chunk never leaves its K block, an N tile never its column block;
  // TMA's row pitches are multiples of 16 bytes
  if (a.bk % KC || a.bn % BN || a.ldo % 8 || a.ldx % 8 || a.ldw % 8 || !aligned)
    return cudaErrorInvalidValue;
  const long long n_tiles = a.N / BN;
  const long long blocks = (a.M + kMmRows - 1) / kMmRows * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // encoded per launch and passed by value: a CUDA graph captures them
  CUtensorMap tm_x, tm_w, tm_out;
  cudaError_t err = encode_2d(&tm_x, a.x, a.kx, a.M, a.ldx, KC, 64);
  if (err == cudaSuccess)
    err = Cfg::kKMajor ? encode_2d(&tm_w, a.w, a.K, a.N, a.ldw, KC, BN)
                       : encode_2d(&tm_w, a.w, a.N, a.K, a.ldw, Cfg::PW, KC);
  if (err == cudaSuccess)
    err = encode_2d(&tm_out, a.out, a.nout, a.M, a.ldo, Panels<BN>::PW, 64);
  if (err == cudaSuccess) err = mm_opt_in<Cfg>();
  if (err != cudaSuccess) return err;
  bs_mm_kernel_wgmma<KC, BN, Cfg::kKMajor><<<(unsigned)blocks, kMmThreads, Cfg::SMEM, a.stream>>>(
      tm_x, tm_w, tm_out, a.tiles, a.counts, a.L, a.M, a.bk, a.bn, (int)n_tiles);
  return cudaGetLastError();
}

// ---- f32: the block-masked GEMM on bf16 pieces ------------------------------

constexpr int kMmSplitThreads = kConsumers + 128;   // and a producer warpgroup
// the producer gives up registers for the consumers' total, partial and
// split x boxes (64 + 64 + 48 at BN 128, KC 32): 40 + 2 * 232 = 504, the
// most a 384-thread block launched at 168 registers a thread can move
constexpr int kMmSplitProducerRegs = 40;
constexpr int kMmSplitConsumerRegs = 232;

// The ring of the f32 route (one block an SM): each stage holds both
// consumers' x boxes as TMA lands them in f32 (64 rows of KC columns,
// K-major, the swizzle of a KC * 4-byte row) and the three bf16 pieces of
// W's boxes for the block's BN output columns, each piece PIECE bytes:
// MN-major (the forward's W) as NP panels of KC rows of PW <= 64 columns,
// each the transposed B of one product, its k16 step 16 rows down;
// K-major (dX's W^T, W's own storage) as one box of BN rows of KC, read as
// NP products of PW rows each, its k16 step 32 bytes along.
template <int KC, int BN, bool KMAJ>
struct MmSplitCfg {
  static constexpr int kChunk = KC;
  static constexpr int kCols = BN;
  static constexpr bool kKMajor = KMAJ;
  static constexpr int kThreads = kMmSplitThreads;
  static constexpr int kBlocksPerSm = 1;
  static constexpr int kSteps = KC / 16;                    // k16 steps a stage
  static constexpr int kAcc = BN / 2;                       // accumulator floats a thread
  static constexpr int FRB = KC * 4;                        // bytes of an x box row
  static constexpr int PW = BN < 64 ? BN : 64;              // columns of one product
  static constexpr int NP = BN / PW;                        // products a k16 step and piece
  static constexpr int RB = (KMAJ ? KC : PW) * 2;           // bytes of a W box row
  static constexpr int NEXT = KMAJ ? PW * RB : KC * RB;     // from one product's B to the next
  static constexpr int KSTEP = KMAJ ? 32 : 16 * RB;         // from one k16 step's B to the next
  static constexpr int W_BYTES = KC * BN * 2;               // one piece's boxes
  static constexpr int PIECE = (W_BYTES + 1023) / 1024 * 1024;
  static constexpr int A_SLOT = 64 * FRB;                   // one consumer's x box
  static constexpr int B_SLOT = 3 * PIECE;
  static constexpr int STAGE = 2 * A_SLOT + B_SLOT;
  static constexpr int STAGES = (int)((kMaxSmemBytes - 2048) / STAGE) < 8
                                    ? (int)((kMaxSmemBytes - 2048) / STAGE) : 8;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
  static_assert(KC == 16 || KC == 32, "bs_mm: f32 chunks of 16 or 32 columns");
  static_assert(STAGES >= 2, "bs_mm: the ring needs two stages");

  // a step's six products a k16 step: the x box's pieces in registers by
  // W's pieces at b
  __device__ static void products(float* acc, const uint32_t (&a)[3][kSteps][4],
                                  const unsigned char* b) {
    wgmma_split_products<PW, KMAJ ? 0 : 1, RB, kSteps, PIECE, KSTEP, NP, NEXT>(acc, a, b);
  }
};

// A consumer warpgroup's total (its 64 rows from row0 by BN output
// columns from n0, f32) to out (rows of N): each thread stores its two
// rows' pairs of columns, 8 bytes at a time, so a warp writes whole
// 32-byte sectors; rows at or past M are not written.
template <class C>
__device__ __forceinline__ void store_mm_f32(const float* acc, float* __restrict__ out, int row0,
                                             int M, int N, int n0) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 16 * warp + lane / 4 + 8 * h;
    if (r >= M) continue;
    float* dst = out + (size_t)r * N + n0 + 2 * (lane % 4);
#pragma unroll
    for (int p = 0; p < C::NP; ++p)
#pragma unroll
      for (int j = 0; j < C::PW / 8; ++j) {
        const float* e = acc + p * (C::PW / 2) + 4 * j + 2 * h;
        *reinterpret_cast<float2*>(dst + p * C::PW + 8 * j) = make_float2(e[0], e[1]);
      }
  }
}

// The f32 route: the bf16 route's grid and walk over each column block's
// live K blocks, on f32 x boxes and W's three bf16 pieces (tm_w maps them
// as (inner, rows, 3): piece p at index p), with a producer warpgroup
// that hands its registers to the consumers (setmaxnreg).  grid (m_tiles *
// n_tiles), N tiles fastest: block i computes rows 128 (i / n_tiles) ..
// +127 of output columns BN (i % n_tiles) .. +BN-1, which lie in one
// column block.
template <int KC, int BN, bool KMAJ>
__global__ void __launch_bounds__(kMmSplitThreads, 1)
bs_mm_kernel_split(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_w, float* __restrict__ out,
                   const int* __restrict__ tiles, const int* __restrict__ counts, int L, int M,
                   int N, int bk, int bn, int n_tiles) {
  using C = MmSplitCfg<KC, BN, KMAJ>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* a_s = align1024(smem_raw);              // [consumer][stage] x boxes
  unsigned char* b_s = a_s + 2 * C::STAGES * C::A_SLOT;  // [stage] W's pieces
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + C::STAGES * C::B_SLOT);
  uint64_t* empty = full + C::STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the block's tile and its steps (0: the block writes zeros), worked out
  // by the producer and the consumers each after their setmaxnreg: values
  // live across it are spilled
  const auto where = [&](int& m0, int& n0, int& n_steps) {
    m0 = (blockIdx.x / n_tiles) * kMmRows;
    n0 = (blockIdx.x % n_tiles) * BN;
    n_steps = counts[n0 / bn] * (bk / KC);
  };

  if (threadIdx.x >= kConsumers) {
    setmaxnreg_dec<kMmSplitProducerRegs>();
    if (threadIdx.x == kConsumers) {
      int m0, n0, n_steps;
      where(m0, n0, n_steps);
      const int chunks = bk / KC;   // steps a live K block
      // a second x box only where the block has rows past its first 64
      const bool two = m0 + 64 < M;
      const uint32_t bytes = (two ? 2 : 1) * C::A_SLOT + 3 * C::W_BYTES;
      const int* kblocks = tiles + (size_t)(n0 / bn) * L;
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % C::STAGES;
        const int k0 = kblocks[it / chunks] * bk + (it % chunks) * KC;
        mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);   // the first round passes
        mbar_arrive_expect_tx(&full[s], bytes);
        tma_load_2d(a_s + s * C::A_SLOT, &tm_x, &full[s], k0, m0);
        if (two) tma_load_2d(a_s + (C::STAGES + s) * C::A_SLOT, &tm_x, &full[s], k0, m0 + 64);
        unsigned char* b = b_s + s * C::B_SLOT;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          if constexpr (KMAJ) {
            tma_load_3d(b + p * C::PIECE, &tm_w, &full[s], k0, n0, p);
          } else {
#pragma unroll
            for (int q = 0; q < C::NP; ++q)
              tma_load_3d(b + p * C::PIECE + q * C::NEXT, &tm_w, &full[s], n0 + q * C::PW, k0, p);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<kMmSplitConsumerRegs>();
    int m0, n0, n_steps;
    where(m0, n0, n_steps);
    const int wg = threadIdx.x / 128;
    const int row0 = m0 + 64 * wg;
    const bool live = row0 < M;   // else only the barriers, in step
    const unsigned char* a_wg = a_s + wg * C::STAGES * C::A_SLOT;

    float part[C::kAcc], total[C::kAcc];
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) part[i] = total[i] = 0.0f;
    if (live) {
      if (n_steps > 0) split_gemm<C>(part, total, a_wg, b_s, full, empty, n_steps);
      store_mm_f32<C>(total, out, row0, M, N, n0);
    } else {
      split_gemm_drain<C>(full, empty, n_steps);
    }
  }
}

template <int KC, int BN, bool KMAJ>
auto mm_kernel(MmSplitCfg<KC, BN, KMAJ>) {
  return bs_mm_kernel_split<KC, BN, KMAJ>;
}

// f(MmSplitCfg<KC, BN, kmajor>{}) for the f32 route's instantiation at
// (kc, bn, kmajor), or `none`
template <class R, class F>
R with_mm_split_cfg(int kc, int bn, int kmajor, R none, F f) {
  switch (kc) {
    case 16: return mm_with_bn<MmSplitCfg, 16>(bn, kmajor, none, f);
    case 32: return mm_with_bn<MmSplitCfg, 32>(bn, kmajor, none, f);
  }
  return none;
}

// a.w holds W's three bf16 pieces, (3, K, ldw) MN-major or (3, N, ldw)
// K-major, contiguous: piece p of row r at a.w + (p rows + r) ldw
template <class Cfg>
cudaError_t launch_mm_split(const MmArgs& a) {
  constexpr int KC = Cfg::kChunk, BN = Cfg::kCols;
  static_assert(Cfg::SMEM <= kMaxSmemBytes, "bs_mm: the f32 ring does not fit");
  const bool aligned = (reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.w) |
                        reinterpret_cast<uintptr_t>(a.out)) % 16 == 0;
  // a K chunk never leaves its K block, an N tile never its column block;
  // TMA's row pitches are multiples of 16 bytes; the epilogue writes whole
  // tiles, 8 bytes a store, into rows ldo apart
  if (a.bk % KC || a.bn % BN || a.ldo % 2 || a.ldo < a.N || a.ldx % 4 || a.ldw % 8 || !aligned)
    return cudaErrorInvalidValue;
  const long long n_tiles = a.N / BN;
  const long long blocks = (a.M + kMmRows - 1) / kMmRows * n_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // encoded per launch and passed by value: a CUDA graph captures them
  CUtensorMap tm_x, tm_w;
  cudaError_t err = encode_2d<4>(&tm_x, a.x, a.kx, a.M, a.ldx, KC, 64);
  if (err == cudaSuccess)
    err = Cfg::kKMajor ? encode_bf16_stack(&tm_w, a.w, a.K, a.N, 3, a.ldw, KC, BN)
                       : encode_bf16_stack(&tm_w, a.w, a.N, a.K, 3, a.ldw, Cfg::PW, KC);
  if (err == cudaSuccess) err = mm_opt_in<Cfg>();
  if (err != cudaSuccess) return err;
  bs_mm_kernel_split<KC, BN, Cfg::kKMajor><<<(unsigned)blocks, kMmSplitThreads, Cfg::SMEM,
                                             a.stream>>>(
      tm_x, tm_w, static_cast<float*>(a.out), a.tiles, a.counts, a.L, a.M, a.ldo, a.bk, a.bn,
      (int)n_tiles);
  return cudaGetLastError();
}

// ---- the coarse route's masked copy of W ------------------------------------

constexpr int kMaskThreads = 256;

// dst (P, Rp, Cp) bf16, contiguous, from src (R, C) of T at element strides
// (sr, sc): element (r, c) is src's where r < R, c < C and its block in the
// uint8 grid ((R / br) x ngc, row-major) is live, else 0; P = 1 in bf16
// (the element), 3 in f32 (its three bf16 pieces, split_bf16x3: p1 =
// bf16(v), p2 = bf16(v - p1), p3 = bf16(v - p1 - p2), each rounded to
// nearest even, as the wrapper's plain version splits).  A dead element is
// never loaded.  A thread writes 8 columns of one row, 16 bytes a piece (Cp
// a multiple of 8).  Bound by bytes: W's live elements read once, 2 or 6
// bytes written an element of the padded copy.  It is K9's coarse route's
// first step, no TPU kernel's counterpart: the TPU kernel never forms W's
// dead blocks, and the select and split in plain PyTorch (several passes)
// took a large share of a call at small blocks (PERF.md).
template <typename T>
__global__ void __launch_bounds__(kMaskThreads)
bs_mm_mask_kernel(const T* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                  const uint8_t* __restrict__ grid, int R, int C, long long sr, long long sc,
                  int Rp, int Cp, int br, int bc, int ngc) {
  const size_t per_row = Cp / 8;
  const size_t groups = (size_t)Rp * per_row;
  const size_t plane = (size_t)Rp * Cp;
  for (size_t g = (size_t)blockIdx.x * kMaskThreads + threadIdx.x; g < groups;
       g += (size_t)gridDim.x * kMaskThreads) {
    const int r = (int)(g / per_row);
    const int c0 = (int)(g % per_row) * 8;
    const uint8_t* live = r < R ? grid + (size_t)(r / br) * ngc : nullptr;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + j;
      v[j] = live != nullptr && c < C && live[c / bc]
                 ? to_f32(src[(long long)r * sr + (long long)c * sc])
                 : 0.0f;
    }
    __nv_bfloat16* out = dst + (size_t)r * Cp + c0;
    if constexpr (kIsBf16<T>) {
      // bf16 to f32 and back is exact
      *reinterpret_cast<uint4*>(out) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                                  pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
    } else {
      uint32_t p[3][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_bf16x3(v[2 * i], v[2 * i + 1], p[0][i], p[1][i], p[2][i]);
#pragma unroll
      for (int q = 0; q < 3; ++q)
        *reinterpret_cast<uint4*>(out + q * plane) = make_uint4(p[q][0], p[q][1], p[q][2], p[q][3]);
    }
  }
}

template <typename T>
cudaError_t launch_mm_mask(const void* src, void* dst, const uint8_t* grid, int R, int C,
                           long long sr, long long sc, int Rp, int Cp, int br, int bc, int ngc,
                           cudaStream_t stream) {
  const long long groups = (long long)Rp * (Cp / 8);
  const long long blocks = (groups + kMaskThreads - 1) / kMaskThreads;
  bs_mm_mask_kernel<T><<<(unsigned)(blocks < 65536 ? blocks : 65536), kMaskThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<__nv_bfloat16*>(dst), grid, R, C, sr, sc, Rp, Cp,
      br, bc, ngc);
  return cudaGetLastError();
}

}  // namespace

// Heads h0 .. h0 + BH - 1 of q, dO (., H, T, D) and k, v (., H, S, D) in
// one dtype (0 = float32, 1 = bfloat16), each at its element strides
// (strides: batch, head and row of q, k, v, then dO; the last dim
// unit-stride), read through TMA: every stride a multiple of 16 bytes and
// each base 16-byte aligned.  lse and delta (., T) f32 and the outputs
// contiguous, in the inputs' dtype; every pointer is the tensor's start, not
// its head h0's.  bmask (T / bq, S / bk) uint8, the runtime block mask.  The
// tables as ops/block_sparse.py builds them, block lists (128-row; 64-row
// for K7 and K8 at bf16 D 192 and 256 and in f32): tiles (blocks, L) int32,
// counts (blocks,) int32, partial the flag bytes (blocks, L) uint8, order
// (blocks,) int32 and rows (blocks, L) uint64.  Each returns the
// cudaError_t of its launch (0 on success).

// K6: o (BH, T, D), lse (BH, T); lists per 128 query rows (the lists the
// bf16 K8 reads up to D 128), in both dtypes.
extern "C" int bigdl_bs_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            const void* tiles, const void* counts, const void* partial,
                            const void* bmask, const void* order, const void* rows, int L,
                            int nkb, int bq, int bk, const long long* strides, int H, int h0,
                            int BH, int T_len, int S_len, int D, int dtype, float sm_scale,
                            int causal, void* stream) {
  const AttnArgs a = make_args(q, k, v, nullptr, nullptr, nullptr, o, lse, tiles, counts, partial,
                               bmask, order, rows, L, nkb, bq, bk, strides, H, h0, BH, T_len,
                               S_len, sm_scale, causal, stream);
  return dispatch_attn<Which::kFwd>(D, dtype, a);
}

// K7: dk, dv (., S, D); lists per 128 key rows (bf16 to D 128) or per 64
// (bf16 at D 192 and 256, f32).
extern "C" int bigdl_bs_bwd_dkv(const void* q, const void* k, const void* v, const void* dO,
                                const void* lse, const void* delta, void* dk, void* dv,
                                const void* tiles, const void* counts, const void* partial,
                                const void* bmask, const void* order, const void* rows, int L,
                                int nkb, int bq, int bk, const long long* strides, int H, int h0,
                                int BH, int T_len, int S_len, int D, int dtype, float sm_scale,
                                int causal, void* stream) {
  const AttnArgs a = make_args(q, k, v, dO, lse, delta, dk, dv, tiles, counts, partial, bmask,
                               order, rows, L, nkb, bq, bk, strides, H, h0, BH, T_len, S_len,
                               sm_scale, causal, stream);
  return dispatch_attn<Which::kDkv>(D, dtype, a);
}

// K8: dq (., T, D); lists per 128 query rows (bf16 to D 128) or per 64
// (bf16 at D 192 and 256, f32).
extern "C" int bigdl_bs_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                               const void* lse, const void* delta, void* dq, const void* tiles,
                               const void* counts, const void* partial, const void* bmask,
                               const void* order, const void* rows, int L, int nkb, int bq,
                               int bk, const long long* strides, int H, int h0, int BH,
                               int T_len, int S_len, int D, int dtype, float sm_scale,
                               int causal, void* stream) {
  const AttnArgs a = make_args(q, k, v, dO, lse, delta, dq, nullptr, tiles, counts, partial,
                               bmask, order, rows, L, nkb, bq, bk, strides, H, h0, BH, T_len,
                               S_len, sm_scale, causal, stream);
  return dispatch_attn<Which::kDq>(D, dtype, a);
}

// Dynamic shared memory per block of the kernel that bigdl_bs_fwd
// launches for head dim D and dtype (as above); 0 for what it does not take.
extern "C" int bigdl_bs_fwd_smem_bytes(int D, int dtype) {
  return smem_of_d<Which::kFwd>(D, dtype);
}

// The same for bigdl_bs_bwd_dkv (dkv = 1) or bigdl_bs_bwd_dq (dkv = 0).
extern "C" int bigdl_bs_bwd_smem_bytes(int dkv, int D, int dtype) {
  return dkv ? smem_of_d<Which::kDkv>(D, dtype) : smem_of_d<Which::kDq>(D, dtype);
}

// K9: out (M, nout) = x (M, kx) @ W (kx, nout) over W's live (bk, bn)
// blocks, where W is handed over as a (K, N) operand, K >= kx and N >= nout
// multiples of bk and bn, zero past (kx, nout) (the coarse route pads its
// masked copy so; elsewhere K = kx, N = nout); tiles (N / bn, L) int32 lists
// each column block's live K blocks, counts (N / bn,) int32 their number.
// x's rows lie ldx elements apart (TMA reads its first kx columns, zeros
// past them); W is MN-major (kmajor 0: element (k, n) at w[k * ldw + n]) or
// K-major (kmajor 1: at w[n * ldw + k]); out's rows lie ldo elements apart;
// one dtype.  K chunks of kc, N tiles of bn_tile, the wrapper's choice (kc
// divides bk, bn_tile divides bn; x, w, out 16-byte aligned and the row
// pitches multiples of 16 bytes, for TMA): in bf16 on W as it stands (kc
// 16, 32 or 64; ldx, ldw and ldo multiples of 8; the TMA store clips at
// nout), in f32 on W's three bf16 pieces, which w then points to (kc 16 or
// 32; (3, K, ldw) MN-major or (3, N, ldw) K-major, contiguous: piece p of
// row r at w + (p rows + r) ldw; ldx a multiple of 4, ldw of 8; the
// epilogue writes whole N tiles, so ldo >= N, even).
extern "C" int bigdl_bs_mm(const void* x, const void* w, void* out, const void* tiles,
                           const void* counts, int L, int M, int K, int N, int bk, int bn,
                           int ldx, int ldw, int kmajor, int kc, int bn_tile, int kx, int nout,
                           int ldo, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || bk <= 0 || bn <= 0 || K % bk || N % bn || L <= 0 ||
      kx <= 0 || kx > K || nout <= 0 || nout > N || ldx < kx || ldo < nout ||
      ldw < (kmajor ? K : N))
    return (int)cudaErrorInvalidValue;
  const MmArgs a{x,  w,   out, static_cast<const int*>(tiles), static_cast<const int*>(counts),
                 L,  M,   K,   N,
                 bk, bn,  ldx, ldw, kmajor, kx, nout, ldo, static_cast<cudaStream_t>(stream)};
  const cudaError_t none = cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)with_mm_cfg(kc, bn_tile, kmajor, none,
                            [&](auto cfg) { return launch_mm_wgmma<decltype(cfg)>(a); });
  if (dtype == 0)
    return (int)with_mm_split_cfg(kc, bn_tile, kmajor, none,
                                  [&](auto cfg) { return launch_mm_split<decltype(cfg)>(a); });
  return (int)none;
}

// The coarse route's masked copy of W (bs_mm_mask_kernel): dst (P, Rp, Cp)
// bf16 contiguous, 16-byte aligned, Cp a multiple of 8, from src (R, C) at
// element strides (sr, sc) in dtype (1 bf16: P = 1, the element; 0 f32: P
// = 3, its three bf16 pieces), element (r, c) kept where r < R, c < C and
// the uint8 grid ((R / br) x ngc, row-major) holds its (br, bc) block, else
// 0.  R and C are multiples of br and bc.
extern "C" int bigdl_bs_mm_mask(const void* src, void* dst, const void* grid, int R, int C,
                                long long sr, long long sc, int Rp, int Cp, int br, int bc,
                                int ngc, int dtype, void* stream) {
  if (R <= 0 || C <= 0 || Rp < R || Cp < C || Cp % 8 || br <= 0 || bc <= 0 || R % br ||
      C % bc || ngc != C / bc || reinterpret_cast<uintptr_t>(dst) % 16)
    return (int)cudaErrorInvalidValue;
  const uint8_t* g = static_cast<const uint8_t*>(grid);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_mm_mask<__nv_bfloat16>(src, dst, g, R, C, sr, sc, Rp, Cp, br, bc, ngc, st);
  if (dtype == 0)
    return (int)launch_mm_mask<float>(src, dst, g, R, C, sr, sc, Rp, Cp, br, bc, ngc, st);
  return (int)cudaErrorInvalidValue;
}

// f(Cfg{}) for K9's kernel at (kc, bn_tile, kmajor) in dtype (1 bf16,
// 0 f32), or `none`
template <class R, class F>
R with_mm_route(int kc, int bn_tile, int kmajor, int dtype, R none, F f) {
  if (dtype == 1) return with_mm_cfg(kc, bn_tile, kmajor, none, f);
  if (dtype == 0) return with_mm_split_cfg(kc, bn_tile, kmajor, none, f);
  return none;
}

// Dynamic shared memory per block of K9's kernel at (kc, bn_tile,
// kmajor) in dtype (1 bf16, 0 f32), or 0 for what it does not take.
extern "C" int bigdl_bs_mm_smem_bytes(int kc, int bn_tile, int kmajor, int dtype) {
  return with_mm_route(kc, bn_tile, kmajor, dtype, 0,
                       [](auto cfg) { return (int)decltype(cfg)::SMEM; });
}

// How many blocks of K9's kernel at (kc, bn_tile, kmajor) in dtype
// the current device runs on one SM at once (bf16: 2 by design, f32: 1),
// or -1.
extern "C" int bigdl_bs_mm_blocks_per_sm(int kc, int bn_tile, int kmajor, int dtype) {
  return with_mm_route(kc, bn_tile, kmajor, dtype, -1, [](auto cfg) {
    using Cfg = decltype(cfg);
    int n = -1;
    if (mm_opt_in<Cfg>() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, mm_kernel(Cfg{}), Cfg::kThreads,
                                                      Cfg::SMEM) != cudaSuccess)
      return -1;
    return n;
  });
}
