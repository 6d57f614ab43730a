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
// bf16 design: the Hopper body of attn_bwd_hopper.cuh (on
// hopper_common.cuh), which block_sparse.cu's K7 and K8 share, over the dense
// sweep below.  Each kernel runs one block of 384 threads: two consumer
// warpgroups of 64 output rows each and one producer warpgroup, which hands
// most of its registers to the consumers (setmaxnreg), so each consumer
// keeps its accumulators in registers for the block's life; one producer
// thread issues every tile load by TMA into a ring of stages.
//   * K2: one block per (batch*head, 128 key rows).  K and V are loaded
//     once; 64-row Q and dO tiles stream through 3 stages from the causal
//     diagonal on, with each tile's LSE and delta staged beside them.  dK and
//     dV stay in registers: 2 * D / 2 f32 a thread.
//   * K3: one block per (batch*head, 128 query rows).  Q and dO are loaded
//     once, and 64-row K and V tiles stream through 4 stages up to the
//     diagonal.
//   * A warpgroup skips a tile that lies wholly above its causal diagonal.
//     Blocks start with the heaviest causal tiles: low key tiles in K2, high
//     query tiles in K3.
//   * K2 and K3 at D 192 and 256 (the bf16 route of head dims 129-256,
//     zero-padded by the wrapper): blocks of 64 own rows.  K2 keeps dV in
//     one consumer warpgroup and dK in the other; K3 forms P in one and dS
//     in the other, and each adds dS . K over half of every key tile
//     (attn_bwd_hopper.cuh says why).  At B 2, H 8, T 1024, D 256, causal
//     K2's four products are 17.3 GFLOP, 17.5 us at 989 TFLOP/s, against
//     50.5 MB, 15.1 us; K3's three 12.9 GFLOP, 13.0 us, against 42.1 MB,
//     12.6 us.
//   * Above D 256 (zero-padded by the wrapper to a multiple of 64) K2 and
//     K3 run the chunked backward in bf16 as in f32 (below): 64 own rows a
//     block and one 256-column chunk of dK/dV or dQ, the own rows and each
//     64-row tile streamed in 64-column panels through 4 ring stages, the
//     scores summed over them in one f32 accumulator.  At B 2, H 8, T
//     1024, D 320, causal K2's four products are 21.5 GFLOP, 21.7 us at
//     989 TFLOP/s, against 63.0 MB, 18.8 us; K3's three 16.1 GFLOP, 16.3
//     us, against 52.6 MB, 15.7 us.  Each block re-reads its own rows from
//     L2 for every tile (K2's TMA loads request 1.0 GB, K3's 0.86 GB),
//     which holds them at 6.6x and 7.2x those bounds on an H100 (PERF.md;
//     attn_bwd_hopper.cuh says how the tiles are sized for it).
// q, k, v and dO are read at their own strides (the head-strided view of an
// attention layer in place); the outputs are contiguous.
//
// f32: the same body's 64-row f32 blocks, whose f32 products are formed
// from bf16 wgmma products on three bf16 pieces of each operand, and which
// read q, k, v and dO at their strides as the bf16 kernels do.  K2
// (bwd_dkv_split_kernel, 64 key rows a block) makes six bf16 products for
// each score product and five for dV and dK; K3 (bwd_dq_split_kernel, 64
// query rows a block, each key tile split by keys between the two consumer
// warpgroups) six for S, dP and dQ alike.  At D 192 and 256 (head dims
// 129-256, zero-padded as in bf16) the block's own rows stay f32 and are
// split into registers for every 32-row streamed tile (attn_bwd_hopper.cuh
// says why).  At the phase-3 shape (B 2, H 8, T 512, D 128, causal) K2's
// four products are 2.15 GFLOP as f32 and 11.8 as bf16: 11.96 us at 989
// TFLOP/s, against 25.2 MB, 7.5 us; K3's three are 1.61 GFLOP as f32, 9.7
// as bf16: 9.8 us, against 21.0 MB, 6.3 us.  At B 2, H 8, T 1024, D 256,
// causal K2's are 17.3 GFLOP as f32, 95 us at 989 * 4 / 22 TFLOP/s, and
// K3's 12.9 GFLOP, 78 us at 989 * 3 / 18: bound by operations.  Above D
// 256 (zero-padded to a multiple of 64) f32 K2 and K3 run the chunked
// backward (bwd_dkv_chunk_kernel, bwd_dq_chunk_kernel): the own rows and
// the 32-row tiles stream in 64-column panels, the scores summed over
// them, and a block keeps 256 columns of dK/dV or dQ, the chunks of a head
// in blocks of their own; at D 320 (same shape) K2's four products are
// 21.5 GFLOP as f32, 0.120 ms at 989 * 4 / 22, K3's 16.1, 0.098 ms.  K7
// and K8 (block_sparse.cu) run the same kernels over their tile lists, so
// on an all-ones mask the two pairs agree bit for bit in both dtypes.

#include "attn_bwd_hopper.cuh"

namespace {

// ---- bf16: the Hopper body of attn_bwd_hopper.cuh over the dense sweep ------

// K2 sweeps the 64-row query tiles of its 128 (or 64) key rows from the
// causal diagonal (row k0) to T; K3 the key tiles of its 128 (or 64) query
// rows from 0 up to the diagonal.  A consumer warpgroup of a 128-row block
// skips a tile wholly above its own diagonal.  Blocks start with the
// heaviest causal tiles: low key blocks in K2, high query blocks in K3.
struct DenseSweep {
  static constexpr bool kList = false;
  int causal;

  __device__ int dkv_block() const { return blockIdx.y; }
  __device__ int dq_block() const { return gridDim.y - 1 - blockIdx.y; }

  // own: the key rows of a dK/dV block, 128 or 64 (one 64-row tile)
  __device__ int dkv_count(int b, int T_len, int own) const {
    const int q_begin = causal ? b * own : 0;
    return T_len > q_begin ? (T_len - q_begin + kTileRows - 1) / kTileRows : 0;
  }
  __device__ Step dkv_step(int b, int it, int own) const {
    const int tile = (causal ? b * own / kTileRows : 0) + it;
    const int q_last = tile * kTileRows + kTileRows - 1;
    uint32_t flags = 0;
    for (int w = 0; w < own / kTileRows; ++w)
      if (!(causal && q_last < b * own + 64 * w)) flags |= kVisit << w;
    return Step{tile, flags};
  }

  // own: the query rows of a dQ block, 128 or 64
  __device__ int dq_count(int b, int S_len, int own) const {
    const int k_end = causal ? min(S_len, (b + 1) * own) : S_len;
    return (k_end + kTileRows - 1) / kTileRows;
  }
  __device__ Step dq_step(int b, int it, int own) const {
    uint32_t flags = 0;
    for (int w = 0; w < own / kTileRows; ++w)
      if (!(causal && it * kTileRows > b * own + 64 * w + 63)) flags |= kVisit << w;
    return Step{it, flags};
  }
};

// dtype: 0 = float32, 1 = bfloat16
template <int D>
cudaError_t launch(bool dkv, int dtype, const BwdArgs& a) {
  const DenseSweep sw{a.causal};
  if (dtype == 1) return dkv ? launch_dkv_wgmma<D>(a, sw) : launch_dq_wgmma<D>(a, sw);
  if (dtype == 0)
    return dkv ? launch_dkv_wgmma<D, float>(a, sw) : launch_dq_wgmma<D, float>(a, sw);
  return cudaErrorInvalidValue;
}

int dispatch(bool dkv, int D, int dtype, const BwdArgs& a) {
  if (a.BH <= 0 || a.T_len <= 0 || a.S_len <= 0 || a.BH > 65535 || a.H <= 0 || a.h0 < 0)
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return (int)launch<16>(dkv, dtype, a);
    case 32: return (int)launch<32>(dkv, dtype, a);
    case 64: return (int)launch<64>(dkv, dtype, a);
    case 128: return (int)launch<128>(dkv, dtype, a);
    case 192: return (int)launch<192>(dkv, dtype, a);
    case 256: return (int)launch<256>(dkv, dtype, a);
  }
  // above head dim 256: the chunked backward, one instantiation per pass
  // and dtype for every D (a multiple of 64)
  const DenseSweep sw{a.causal};
  if (dtype == 1)
    return (int)(dkv ? launch_bwd_chunked<true, __nv_bfloat16>(a, D, sw)
                     : launch_bwd_chunked<false, __nv_bfloat16>(a, D, sw));
  if (dtype == 0)
    return (int)(dkv ? launch_bwd_chunked<true, float>(a, D, sw)
                     : launch_bwd_chunked<false, float>(a, D, sw));
  return (int)cudaErrorInvalidValue;
}

template <int D>
int smem_of(bool dkv, int dtype) {
  if (dtype == 1) return (int)(dkv ? DkvCfg<D>::SMEM : DqCfg<D>::SMEM);
  if (dtype == 0) return (int)(dkv ? DkvCfg<D, float>::SMEM : DqCfg<D, float>::SMEM);
  return 0;
}

}  // namespace

// Heads h0 .. h0 + BH - 1 of q, dO (., H, T, D) and k, v (., H, S, D) in
// one dtype (0 = float32, 1 = bfloat16), each at its element strides
// (strides: batch, head and row of q, k, v, then dO; the last dim
// unit-stride), read through TMA: every stride a multiple of 16 bytes and
// each base 16-byte aligned.  lse and delta (., T) f32 and the outputs
// contiguous, in the inputs' dtype.  Every pointer is the tensor's start, not its head h0's.
// Each returns the cudaError_t of its launch (0 on success).

BwdArgs make_args(const void* q, const void* k, const void* v, const void* dO, const void* lse,
                  const void* delta, void* out0, void* out1, const long long* strides, int H,
                  int h0, int BH, int T_len, int S_len, float sm_scale, int causal, void* stream) {
  return BwdArgs{q, k, v, dO, static_cast<const float*>(lse), static_cast<const float*>(delta),
                 out0, out1, head_strides(strides, 0), head_strides(strides, 1),
                 head_strides(strides, 2), head_strides(strides, 3), H, h0, BH, T_len, S_len,
                 sm_scale, causal, static_cast<cudaStream_t>(stream)};
}

// K2: dk, dv (., S, D).
extern "C" int bigdl_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dO,
                                   const void* lse, const void* delta, void* dk, void* dv,
                                   const long long* strides, int H, int h0, int BH, int T_len,
                                   int S_len, int D, int dtype, float sm_scale, int causal,
                                   void* stream) {
  return dispatch(true, D, dtype, make_args(q, k, v, dO, lse, delta, dk, dv, strides, H, h0, BH,
                                            T_len, S_len, sm_scale, causal, stream));
}

// K3: dq (., T, D).
extern "C" int bigdl_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                                  const void* lse, const void* delta, void* dq,
                                  const long long* strides, int H, int h0, int BH, int T_len,
                                  int S_len, int D, int dtype, float sm_scale, int causal,
                                  void* stream) {
  return dispatch(false, D, dtype, make_args(q, k, v, dO, lse, delta, dq, nullptr, strides, H,
                                             h0, BH, T_len, S_len, sm_scale, causal, stream));
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
    case 192: return smem_of<192>(dkv != 0, dtype);
    case 256: return smem_of<256>(dkv != 0, dtype);
  }
  if (D <= kChunkCols || D % kChunkPanel) return 0;
  if (dtype == 1)
    return (int)(dkv ? BwdChunkCfg<true, __nv_bfloat16>::SMEM
                     : BwdChunkCfg<false, __nv_bfloat16>::SMEM);
  if (dtype == 0) return (int)(dkv ? BwdChunkCfg<true, float>::SMEM : BwdChunkCfg<false, float>::SMEM);
  return 0;
}
