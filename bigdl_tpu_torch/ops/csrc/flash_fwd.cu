// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `_fwd_kernel` of bigdl_tpu/ops/flash_attention.py
// (launched by `_flash_fwd`).  It computes exactly what that kernel computes:
//   * scores q.k in f32 (f32 accumulation) times sm_scale;
//   * the causal mask top-left aligned: q_pos >= k_pos, both counted from 0;
//   * an online softmax over k tiles with f32 running (m, l, acc), l summed
//     from the f32 probabilities;
//   * P cast to v's dtype before the P.V product (in f32 not rounded);
//   * O = acc / max(l, 1e-30) in q's dtype, and the row log-sum-exp in f32;
//     a fully masked row gives O = 0 and LSE = 1e30.
//
// What bounds it on an H100.  At the training shape (B 16, H 8, T 1024,
// D 128, bf16, causal) the kernel must move q, k, v and o, 134 MB, which is
// 40 us at 3.35 TB/s, against 34 GFLOP of products, 35 us at 989 TFLOP/s:
// the two bounds sit together, so loads must overlap the products.  In f32
// (B 2, H 8, T 512, D 128, causal) 1.08 GFLOP of products, each f32 one
// formed from bf16 products (twelve for two, so 164.8 TFLOP/s of f32
// work), take 6.5 us against 16.8 MB, 5.0 us.
//
// Design: the Hopper body of attn_fwd_hopper.cuh (on hopper_common.cuh),
// which block_sparse.cu's K6 shares, over the dense sweep below, in both
// dtypes.  One block of 384 threads per (batch*head, 128 query rows): two
// consumer warpgroups of 64 rows each, whose S, P and O stay in registers,
// and one producer warpgroup that loads the q rows once and K and V tiles
// into an mbarrier ring by TMA; S = Q.K^T and O += P.V on wgmma, P from
// registers.  In bf16 key tiles are 64 rows at D 128 and above (a
// warpgroup above the diagonal then skips the diagonal tile's second half:
// measured on the causal main path, PERF.md; 4 stages at D 128, 3 at
// D 192, 2 at D 256) and 128 rows in 3 stages below.  In f32 each f32
// product is a sum of bf16 products on bf16 pieces of its operands
// (attn_fwd_split_kernel), over 64-key tiles at D 16-128 and 32-key tiles
// at 192 and 256, where q stays in f32 and is split into registers.
// Blocks start with the heaviest causal q tiles, so the last wave is
// short.  q, k and v are read at their own strides (the head-strided view
// of an attention layer in place); o is contiguous.
//
// Head dims 192 and 256 are the route of head dims 129-256 in both dtypes
// (the wrapper zero-pads D to the next of them).  There the bound moves: at
// B 2, H 8, T 1024, D 256, causal, the two products are 8.6 GFLOP, 8.7 us
// at 989 TFLOP/s in bf16 (52 us at the f32 split rate), against 33.6 MB,
// 10.0 us at 3.35 TB/s (20 us in f32).  Above 256 both dtypes run the
// chunked forward of attn_fwd_hopper.cuh (attn_fwd_chunk_kernel: the
// scores summed over 64-column panels of q and K streamed through the
// ring, O kept 256 columns a block, the chunks of a head in blocks of
// their own), one instantiation for every head dim, the wrapper
// zero-padding D to a multiple of 64: at D 320 the two products are 10.7
// GFLOP, 10.9 us in bf16 (65 us in f32), against 42 MB, 12.5 us (25 us in
// f32).  On an all-ones causal mask at a 128-multiple block K6 sweeps the
// same key tiles as K1 at bf16 D 128 and above 256 and at every f32 D, so
// the two give the same bits.

#include "attn_fwd_hopper.cuh"

namespace {

// ---- the Hopper body of attn_fwd_hopper.cuh over the dense sweep -----------

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

// key rows per bf16 tile at head dim D (see the note at the top); f32 runs
// 64-key tiles, 32 at D 192 and 256 (kFwdTileRows)
template <int D>
constexpr int kDenseKeyRows = D >= 128 ? 64 : 128;

template <int D>
cudaError_t launch_bf16(const FwdArgs& a) {
  return launch_fwd_wgmma<D, kDenseKeyRows<D>>(a, DenseSweep<kDenseKeyRows<D>>{a.causal});
}

template <int D>
cudaError_t launch_f32(const FwdArgs& a) {
  constexpr int BK = kFwdTileRows<D, float>;
  return launch_fwd_wgmma<D, BK, float>(a, DenseSweep<BK>{a.causal});
}

// above head dim 256, either dtype: the chunked forward, one instantiation
// for every D (a multiple of 64)
template <typename T>
cudaError_t launch_chunked(int D, const FwdArgs& a) {
  return launch_fwd_chunked<T>(a, D, DenseSweep<ChunkCfg<T>::BK>{a.causal});
}

cudaError_t dispatch_bf16(int D, const FwdArgs& a) {
  switch (D) {
    case 16: return launch_bf16<16>(a);
    case 32: return launch_bf16<32>(a);
    case 64: return launch_bf16<64>(a);
    case 128: return launch_bf16<128>(a);
    case 192: return launch_bf16<192>(a);
    case 256: return launch_bf16<256>(a);
    default: return launch_chunked<__nv_bfloat16>(D, a);
  }
}

cudaError_t dispatch_f32(int D, const FwdArgs& a) {
  switch (D) {
    case 16: return launch_f32<16>(a);
    case 32: return launch_f32<32>(a);
    case 64: return launch_f32<64>(a);
    case 128: return launch_f32<128>(a);
    case 192: return launch_f32<192>(a);
    case 256: return launch_f32<256>(a);
    default: return launch_chunked<float>(D, a);
  }
}

}  // namespace

// Heads h0 .. h0 + BH - 1 of q (., H, T, D) and k/v (., H, S, D) in one
// dtype (0 = float32, 1 = bfloat16), each at its element strides (strides:
// batch, head and row of q, then k, then v; the last dim unit-stride); every
// stride a multiple of 16 bytes and each base 16-byte aligned (TMA).  o
// (., T, D) in q's dtype and lse (., T) f32 contiguous.
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
    if (D > kChunkCols && D % kChunkPanel == 0) return (int)ChunkCfg<__nv_bfloat16>::SMEM;
  } else if (dtype == 0) {
    switch (D) {
      case 16: return (int)FwdCfg<16, kTileRows, float>::SMEM;
      case 32: return (int)FwdCfg<32, kTileRows, float>::SMEM;
      case 64: return (int)FwdCfg<64, kTileRows, float>::SMEM;
      case 128: return (int)FwdCfg<128, kTileRows, float>::SMEM;
      case 192: return (int)FwdCfg<192, kFwdTileRows<192, float>, float>::SMEM;
      case 256: return (int)FwdCfg<256, kFwdTileRows<256, float>, float>::SMEM;
    }
    if (D > kChunkCols && D % kChunkPanel == 0) return (int)ChunkCfg<float>::SMEM;
  }
  return 0;
}
