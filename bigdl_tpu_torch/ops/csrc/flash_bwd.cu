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
//
// Design.  No atomics: each output row has one owner block.
//   * K2: one block (4 warps) per (batch*head, tile of 64 key rows); it
//     keeps its k/v tiles and its f32 dK/dV accumulators in shared memory
//     and loops over 64-row q/dO tiles from the causal diagonal on.
//   * K3: one block per (batch*head, tile of 64 query rows); it keeps its
//     q/dO tiles and its f32 dQ accumulator and loops over k/v tiles up to
//     the diagonal.
// Layout: each kernel lays its score tile out with the rows of the output
// it accumulates, S^T (key rows) in K2 and S (query rows) in K3, where the
// TPU kernels use S^T in both.  Then the warp that computes a 16-row band
// of the score tile holds exactly the A operand of its own WMMA
// accumulation (P^T/dS^T . X in K2, dS . K in K3), row-major in shared
// memory: no transposed fragment loads, no exchange between warps, and
// only the streamed tile loads need a block-wide barrier.  LSE and delta
// are per query, so K2 reads them per column and K3 per row.
//
// Shared memory per block at D 128 bf16: K2 holds q, dO, k, v (64 KB),
// S^T and dP^T in f32 (32 KB), P^T and dS^T in bf16 (16 KB) and the f32
// dK/dV accumulators (64 KB), 176.5 KB: one block per SM, after the
// once-per-device opt-in.  In f32 the P^T/dS^T tiles overwrite S^T/dP^T
// in place (each lane rewrites only what it read), so D 128 f32 fits in
// 224.5 KB.  K3 needs 136.5 KB (bf16) and 192.5 KB (f32).
//
// What bounds it on an H100.  At the training shape (B 16, H 8, T = S =
// 1024, D 128, bf16, causal) each T x S x D product under the causal mask
// is 17.2 GFLOP.  K2 makes four (S^T, dP^T, dV, dK): 68.8 GFLOP, 0.070 ms
// at 989 TFLOP/s, against 201 MB of q, k, v, dO, dK, dV, 0.060 ms at
// 3.35 TB/s.  K3 makes three: 51.6 GFLOP, 0.052 ms, against 168 MB,
// 0.050 ms.  Both sit at the ridge.  This simple design stages every
// product through shared memory with 16x16x16 WMMA, re-reads q/dO (K2)
// or k/v (K3) per tile and overlaps no load with compute (no TMA, no
// wgmma, no pipelining); closing the gap is later work.

#include "tile_common.cuh"

namespace {

template <typename T, int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(T) * 4 * TILE * D                        // k, v, q, dO
         + sizeof(float) * 2 * TILE * TILE               // S^T, dP^T
         + sizeof(float) * 2 * TILE * D                  // dK, dV accumulators
         + (kIsBf16<T> ? sizeof(T) * 2 * TILE * TILE : 0)   // P^T, dS^T
         + sizeof(float) * 2 * TILE;                     // lse, delta
}

template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(T) * 4 * TILE * D                        // q, dO, k, v
         + sizeof(float) * 2 * TILE * TILE               // S, dP
         + sizeof(float) * TILE * D                      // dQ accumulator
         + (kIsBf16<T> ? sizeof(T) * TILE * TILE : 0)  // dS
         + sizeof(float) * 2 * TILE;                     // lse, delta
}

// One (query, key) pair of a score tile: the masked-or-recomputed P and
// dS = P * (dP - delta), both in f32.
__device__ __forceinline__ void p_and_ds(float s, float dp, float lse, float delta, bool keep,
                                         float sm_scale, float* p, float* ds) {
  *p = keep ? expf(s * sm_scale - lse) : 0.0f;
  *ds = *p * (dp - delta);
}

// K2: grid (ceil(S / 64), B*H).
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dO, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int T_len, int S_len, float sm_scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + TILE * D;
  T* q_s = v_s + TILE * D;
  T* do_s = q_s + TILE * D;
  float* st_s = reinterpret_cast<float*>(do_s + TILE * D);   // S^T: key rows, query columns
  float* dpt_s = st_s + TILE * TILE;                          // dP^T
  float* dk_acc = dpt_s + TILE * TILE;
  float* dv_acc = dk_acc + TILE * D;
  T* pt_s;
  T* dst_s;
  float* lse_s;
  if constexpr (kIsBf16<T>) {
    pt_s = reinterpret_cast<T*>(dv_acc + TILE * D);
    dst_s = pt_s + TILE * TILE;
    lse_s = reinterpret_cast<float*>(dst_s + TILE * TILE);
  } else {
    pt_s = reinterpret_cast<T*>(st_s);    // written over S^T in place
    dst_s = reinterpret_cast<T*>(dpt_s);  // written over dP^T in place
    lse_s = dv_acc + TILE * D;
  }
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
        pt_s[r * TILE + c] = from_f32<T>(p);
        dst_s[r * TILE + c] = from_f32<T>(ds);
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
      dk[(size_t)(k0 + r) * D + d] = from_f32<T>(dk_acc[r * D + d] * sm_scale);
      dv[(size_t)(k0 + r) * D + d] = from_f32<T>(dv_acc[r * D + d]);
    }
  }
}

// K3: grid (ceil(T / 64), B*H).
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dO, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int T_len, int S_len,
                    float sm_scale, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + TILE * D;
  T* k_s = do_s + TILE * D;
  T* v_s = k_s + TILE * D;
  float* s_s = reinterpret_cast<float*>(v_s + TILE * D);   // S: query rows, key columns
  float* dp_s = s_s + TILE * TILE;                          // dP
  float* dq_acc = dp_s + TILE * TILE;
  T* ds_s;
  float* lse_s;
  if constexpr (kIsBf16<T>) {
    ds_s = reinterpret_cast<T*>(dq_acc + TILE * D);
    lse_s = reinterpret_cast<float*>(ds_s + TILE * TILE);
  } else {
    ds_s = reinterpret_cast<T*>(dp_s);   // written over dP in place
    lse_s = dq_acc + TILE * D;
  }
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
        ds_s[r * TILE + c] = from_f32<T>(ds);
      }
    }
    __syncwarp();

    mma_acc_tile<T, D>(ds_s, k_s, dq_acc, warp, lane);   // dQ += dS . K
  }
  __syncthreads();   // the zero-fill is visible when the sweep ran no tile

  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    if (q0 + r >= T_len) break;
    for (int d = lane; d < D; d += 32)
      dq[(size_t)(q0 + r) * D + d] = from_f32<T>(dq_acc[r * D + d] * sm_scale);
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

template <typename T, int D>
cudaError_t launch_dkv(const BwdArgs& a) {
  constexpr size_t smem = dkv_smem_bytes<T, D>();
  static_assert(smem <= kMaxSmemBytes, "flash_bwd_dkv tiles do not fit in shared memory");
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  cudaError_t err = smem_opt_in_once(kernel, (int)smem, mu, attr_set);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S_len + TILE - 1) / TILE, a.BH);
  kernel<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dO), a.lse, a.delta, static_cast<T*>(a.out0),
      static_cast<T*>(a.out1), a.T_len, a.S_len, a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const BwdArgs& a) {
  constexpr size_t smem = dq_smem_bytes<T, D>();
  static_assert(smem <= kMaxSmemBytes, "flash_bwd_dq tiles do not fit in shared memory");
  auto kernel = flash_bwd_dq_kernel<T, D>;
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  cudaError_t err = smem_opt_in_once(kernel, (int)smem, mu, attr_set);
  if (err != cudaSuccess) return err;
  dim3 grid((a.T_len + TILE - 1) / TILE, a.BH);
  kernel<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dO), a.lse, a.delta, static_cast<T*>(a.out0), a.T_len, a.S_len,
      a.sm_scale, a.causal);
  return cudaGetLastError();
}

template <bool DKV, typename T>
cudaError_t dispatch_d(int D, const BwdArgs& a) {
  switch (D) {
    case 16: return DKV ? launch_dkv<T, 16>(a) : launch_dq<T, 16>(a);
    case 32: return DKV ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
    case 64: return DKV ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
    case 128: return DKV ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DKV>
int dispatch(int D, int dtype, const BwdArgs& a) {
  if (a.BH <= 0 || a.T_len <= 0 || a.S_len <= 0 || a.BH > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) return (int)dispatch_d<DKV, __nv_bfloat16>(D, a);
  if (dtype == 0) return (int)dispatch_d<DKV, float>(D, a);
  return (int)cudaErrorInvalidValue;
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
  return dispatch<true>(D, dtype, a);
}

// K3: dq (BH, T, D).
extern "C" int bigdl_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                                  const void* lse, const void* delta, void* dq, int BH,
                                  int T_len, int S_len, int D, int dtype, float sm_scale,
                                  int causal, void* stream) {
  const BwdArgs a{q, k, v, dO, static_cast<const float*>(lse), static_cast<const float*>(delta),
                  dq, nullptr, BH, T_len, S_len, sm_scale, causal,
                  static_cast<cudaStream_t>(stream)};
  return dispatch<false>(D, dtype, a);
}
