// The attention backward for head dims above the built ones (sm_90a),
// bound to Python with ctypes: the "wide" route of K2/K3 and K7/K8.
//
// The Hopper backward kernels are built for head dims 16, 32, 64, 128, 192
// and 256 in both dtypes; a head dim between them is zero-padded to the
// next.  So this route takes dK/dV and dQ above 256 in bf16; in f32 they
// run attn_bwd_hopper.cuh's chunked backward (bwd_dkv_chunk_kernel,
// bwd_dq_chunk_kernel), and K1 and K6 above 256 its chunked forward
// (attn_fwd_chunk_kernel), in both dtypes.  The TPU
// kernels take any D: `_dkv_kernel`, `_dq_kernel` of
// bigdl_tpu/ops/flash_attention.py and `_bs_dkv_kernel`, `_bs_dq_kernel` of
// bigdl_tpu/ops/block_sparse.py hand D straight to their (1, block, D)
// blocks.  These two kernels take any D as it is, under a dense mask
// (top-left causal or none) or a block mask (the runtime (T / bq, S / bk)
// grid the block-sparse wrappers upload, causal blocks pruned, and the
// causal test), and compute exactly what the plain version
// `_attn_bwd_plain` of ops/flash_attention.py computes:
//   * dK/dV: P = exp(s - LSE), dP = dO . v, dS = P * (dP - delta) (delta from
//     the caller); dV += P (in v's dtype) * dO and dK += dS (in q's dtype) *
//     q over the queries that attend the key; dK times sm_scale;
//   * dQ: dQ += dS (in k's dtype) * k over the row's keys, times sm_scale;
//   * f32 accumulation; outputs in bf16.
//
// Design: simple and right.  One warp owns one output row (a query row for
// dQ, a key row for dK/dV) and walks only the keys (or queries) the mask
// keeps, 32 at a time, so a row that no output row attends (NaN in dead
// K/V included) is never read.  Each lane scores one of the 32: its dot
// products run over d in order with one FMA per term, and the steps after
// them are rounded one at a time (no contraction), which is how the plain
// version's matrix products and elementwise steps round on the card; so a
// row where dP and delta cancel exactly (the first causal row of dQ)
// cancels here as it does there.  Then lane l adds the 32 rows, in order,
// into columns l, l + 32, ... of the warp's f32 workspace: the own row (and
// dO's, for dQ; v's, for dK/dV) and the accumulators, 3 or 4 rows of D f32
// a warp, all in shared memory; a block runs up to 4 warps, fewer when
// their workspace would pass 227 KB (one warp takes D up to 14,528).  No
// atomics: every output row has one owner warp, and two launches give the
// same bits.
//
// What bounds it: nothing it does is fast.  It reads each key row once per
// query row that attends it, from L2, a row a lane (16 bytes a load where
// D allows), and its products run on FMA; it is the route of head dims no
// model here uses, and its times stand beside the bound in PERF.md.

#include <algorithm>

#include "tile_common.cuh"

namespace {

constexpr int kMaxWarps = 4;

// The keys (queries) an output row walks: under a dense mask (m null) every
// key, under a block mask the keys of its live blocks; under causal only
// q >= k, top-left aligned.
struct Walk {
  const uint8_t* m;   // (T / bq, S / bk) row-major, or null
  int nkb, bq, bk;
  int T_len, S_len, causal;

  // f(lo, hi) for each run [lo, hi) of keys that query q attends, ascending
  template <class F>
  __device__ void keys(int q, F f) const {
    const int k_end = causal ? min(S_len, q + 1) : S_len;
    if (m == nullptr) {
      if (k_end > 0) f(0, k_end);
      return;
    }
    const uint8_t* row = m + (size_t)(q / bq) * nkb;
    for (int kb = 0; kb * bk < k_end; ++kb)
      if (row[kb]) f(kb * bk, min((kb + 1) * bk, k_end));
  }

  // f(lo, hi) for each run [lo, hi) of queries that attend key k, ascending
  template <class F>
  __device__ void queries(int k, F f) const {
    const int q_begin = causal ? k : 0;
    if (m == nullptr) {
      if (q_begin < T_len) f(q_begin, T_len);
      return;
    }
    const int kb = k / bk;
    for (int qb = q_begin / bq; qb * bq < T_len; ++qb)
      if (m[(size_t)qb * nkb + kb]) f(max(qb * bq, q_begin), min((qb + 1) * bq, T_len));
  }
};

// a . b over d = 0 .. D - 1 in order, one FMA a term: a an f32 workspace
// row (the same address in every lane), b a row in device memory, read 16
// bytes at a time where rows of D stay 16-byte aligned
template <typename T>
__device__ __forceinline__ float lane_dot(const float* a, const T* __restrict__ b, int D) {
  constexpr int V = 16 / sizeof(T);
  float acc = 0.0f;
  int d = 0;
  if (D % V == 0) {
    for (; d < D; d += V) {
      const uint4 raw = *reinterpret_cast<const uint4*>(b + d);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) acc = fmaf(a[d + i], to_f32(e[i]), acc);
    }
  }
  for (; d < D; ++d) acc = fmaf(a[d], to_f32(b[d]), acc);
  return acc;
}

// x rounded to T and back: the cast of P or dS before a product
template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return to_f32(from_f32<T>(x));
}

// acc[d] += sum over the chunk's rows j < n, in order, of w_j * rows[j][d]:
// w_j is lane j's weight; lane l takes columns l, l + 32, ...
template <typename T>
__device__ __forceinline__ void add_rows(float* acc, float w, const T* __restrict__ rows, int n,
                                         int D, int lane) {
  for (int j = 0; j < n; ++j) {
    const float wj = __shfl_sync(0xffffffffu, w, j);
    const T* r = rows + (size_t)j * D;
    for (int d = lane; d < D; d += 32) acc[d] = fmaf(wj, to_f32(r[d]), acc[d]);
  }
}

// dK/dV: one warp per key row, grid (S / warps, B*H); workspace 4 D f32 a
// warp (the k and v rows, the dK and dV accumulators).
template <typename T>
__global__ void wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ dO,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                T* __restrict__ dk, T* __restrict__ dv, Walk w, int D,
                                float sm_scale) {
  extern __shared__ float ws[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kp = blockIdx.x * (blockDim.x / 32) + warp;
  if (kp >= w.S_len) return;
  const int bh = blockIdx.y;
  const size_t row = (size_t)bh * w.S_len + kp;
  float* k_s = ws + (size_t)warp * 4 * D;
  float* v_s = k_s + D;
  float* dk_acc = v_s + D;
  float* dv_acc = dk_acc + D;
  const T* qh = q + (size_t)bh * w.T_len * D;
  const T* doh = dO + (size_t)bh * w.T_len * D;
  const float* lse_h = lse + (size_t)bh * w.T_len;
  const float* delta_h = delta + (size_t)bh * w.T_len;
  for (int d = lane; d < D; d += 32) {
    k_s[d] = to_f32(k[row * D + d]);
    v_s[d] = to_f32(v[row * D + d]);
    dk_acc[d] = 0.0f;
    dv_acc[d] = 0.0f;
  }
  __syncwarp();

  w.queries(kp, [&](int lo, int hi) {
    for (int q0 = lo; q0 < hi; q0 += 32) {
      const int qp = q0 + lane;
      float pr = 0.0f, dsr = 0.0f;
      if (qp < hi) {
        const float s = __fmul_rn(lane_dot(k_s, qh + (size_t)qp * D, D), sm_scale);
        const float p = expf(__fsub_rn(s, lse_h[qp]));
        const float dp = lane_dot(v_s, doh + (size_t)qp * D, D);
        pr = rounded<T>(p);
        dsr = rounded<T>(__fmul_rn(p, __fsub_rn(dp, delta_h[qp])));
      }
      const int n = min(32, hi - q0);
      add_rows(dv_acc, pr, doh + (size_t)q0 * D, n, D, lane);    // dV += P^T . dO
      add_rows(dk_acc, dsr, qh + (size_t)q0 * D, n, D, lane);    // dK += dS^T . Q
    }
  });

  for (int d = lane; d < D; d += 32) {
    dk[row * D + d] = from_f32<T>(__fmul_rn(dk_acc[d], sm_scale));
    dv[row * D + d] = from_f32<T>(dv_acc[d]);
  }
}

// dQ: one warp per query row, grid (T / warps, B*H); workspace 3 D f32 a
// warp (the q and dO rows, the dQ accumulator).
template <typename T>
__global__ void wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v, const T* __restrict__ dO,
                               const float* __restrict__ lse, const float* __restrict__ delta,
                               T* __restrict__ dq, Walk w, int D, float sm_scale) {
  extern __shared__ float ws[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qp = blockIdx.x * (blockDim.x / 32) + warp;
  if (qp >= w.T_len) return;
  const int bh = blockIdx.y;
  const size_t row = (size_t)bh * w.T_len + qp;
  float* q_s = ws + (size_t)warp * 3 * D;
  float* do_s = q_s + D;
  float* dq_acc = do_s + D;
  const T* kh = k + (size_t)bh * w.S_len * D;
  const T* vh = v + (size_t)bh * w.S_len * D;
  const float lse_r = lse[row], delta_r = delta[row];
  for (int d = lane; d < D; d += 32) {
    q_s[d] = to_f32(q[row * D + d]);
    do_s[d] = to_f32(dO[row * D + d]);
    dq_acc[d] = 0.0f;
  }
  __syncwarp();

  w.keys(qp, [&](int lo, int hi) {
    for (int k0 = lo; k0 < hi; k0 += 32) {
      const int kp = k0 + lane;
      float dsr = 0.0f;
      if (kp < hi) {
        const float s = __fmul_rn(lane_dot(q_s, kh + (size_t)kp * D, D), sm_scale);
        const float p = expf(__fsub_rn(s, lse_r));
        const float dp = lane_dot(do_s, vh + (size_t)kp * D, D);
        dsr = rounded<T>(__fmul_rn(p, __fsub_rn(dp, delta_r)));
      }
      add_rows(dq_acc, dsr, kh + (size_t)k0 * D, min(32, hi - k0), D, lane);   // dQ += dS . K
    }
  });

  for (int d = lane; d < D; d += 32) dq[row * D + d] = from_f32<T>(__fmul_rn(dq_acc[d], sm_scale));
}

struct WideArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dO;
  const float* lse;
  const float* delta;
  void* out0;   // dK or dQ
  void* out1;   // dV
  Walk w;
  int BH, D;
  float sm_scale;
  cudaStream_t stream;
};

enum class Which { kDkv, kDq };

// f32 workspace columns a warp holds
template <Which W>
constexpr int kWorkspaceRows = W == Which::kDkv ? 4 : 3;

template <Which W, typename T>
cudaError_t launch_wide(const WideArgs& a) {
  const size_t per_warp = sizeof(float) * kWorkspaceRows<W> * (size_t)a.D;
  const int warps = (int)std::min<size_t>(kMaxWarps, kMaxSmemBytes / per_warp);
  if (warps < 1) return cudaErrorInvalidValue;
  // grid (output rows of a head / warps, B*H)
  const int rows = W == Which::kDkv ? a.w.S_len : a.w.T_len;
  dim3 grid((rows + warps - 1) / warps, a.BH);
  const size_t smem = per_warp * warps;
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  cudaError_t err;
  if constexpr (W == Which::kDkv) {
    auto kernel = wide_dkv_kernel<T>;
    err = smem_opt_in_once(kernel, (int)kMaxSmemBytes, mu, attr_set);
    if (err != cudaSuccess) return err;
    kernel<<<grid, 32 * warps, smem, a.stream>>>(
        q, k, v, static_cast<const T*>(a.dO), a.lse, a.delta, static_cast<T*>(a.out0),
        static_cast<T*>(a.out1), a.w, a.D, a.sm_scale);
  } else {
    auto kernel = wide_dq_kernel<T>;
    err = smem_opt_in_once(kernel, (int)kMaxSmemBytes, mu, attr_set);
    if (err != cudaSuccess) return err;
    kernel<<<grid, 32 * warps, smem, a.stream>>>(q, k, v, static_cast<const T*>(a.dO), a.lse,
                                                 a.delta, static_cast<T*>(a.out0), a.w, a.D,
                                                 a.sm_scale);
  }
  return cudaGetLastError();
}

template <Which W>
int dispatch_wide(const WideArgs& a) {
  const Walk& w = a.w;
  if (a.BH <= 0 || a.BH > 65535 || w.T_len <= 0 || w.S_len <= 0 || a.D <= 0)
    return (int)cudaErrorInvalidValue;
  if (w.m != nullptr && (w.bq <= 0 || w.bk <= 0 || w.T_len % w.bq || w.S_len % w.bk ||
                         w.nkb != w.S_len / w.bk))
    return (int)cudaErrorInvalidValue;
  return (int)launch_wide<W, __nv_bfloat16>(a);
}

// the arguments from head h0 on: every pointer moved to that head's rows
template <typename T>
WideArgs make_wide_args(const void* q, const void* k, const void* v, const void* dO,
                        const void* lse, const void* delta, void* out0, void* out1,
                        const void* bmask, int nkb, int bq, int bk, int h0, int BH, int T_len,
                        int S_len, int D, float sm_scale, int causal, void* stream, bool dkv) {
  const size_t qo = (size_t)h0 * T_len, ko = (size_t)h0 * S_len;
  auto at = [](const void* p, size_t n) -> const T* {
    return p ? static_cast<const T*>(p) + n : nullptr;
  };
  auto out_at = [](void* p, size_t n) -> void* { return p ? static_cast<T*>(p) + n : nullptr; };
  // out0: dK or dQ; out1: dV
  return WideArgs{at(q, qo * D), at(k, ko * D), at(v, ko * D), at(dO, qo * D),
                  static_cast<const float*>(lse) + qo, static_cast<const float*>(delta) + qo,
                  out_at(out0, (dkv ? ko : qo) * D), out_at(out1, ko * D),
                  Walk{static_cast<const uint8_t*>(bmask), nkb, bq, bk, T_len, S_len, causal},
                  BH, D, sm_scale, static_cast<cudaStream_t>(stream)};
}

template <Which W>
int wide_entry(int dtype, const void* q, const void* k, const void* v, const void* dO,
                  const void* lse, const void* delta, void* out0, void* out1, const void* bmask,
                  int nkb, int bq, int bk, int h0, int BH, int T_len, int S_len, int D,
                  float sm_scale, int causal, void* stream) {
  if (h0 < 0 || dtype != 1) return (int)cudaErrorInvalidValue;
  return dispatch_wide<W>(make_wide_args<__nv_bfloat16>(q, k, v, dO, lse, delta, out0, out1,
                                                        bmask, nkb, bq, bk, h0, BH, T_len, S_len,
                                                        D, sm_scale, causal, stream,
                                                        W == Which::kDkv));
}

}  // namespace

// Heads h0 .. h0 + BH - 1 of q, dO (., T, D) and k, v (., S, D), contiguous,
// in bf16 (dtype 1; any other code is refused), any D; lse and delta (., T)
// f32; dK, dV and dQ as their inputs.  Every pointer is the tensor's start, not
// its head h0's.  bmask: the runtime block mask (T / bq, S / bk) uint8 of
// the block-sparse wrappers (nkb = S / bk), or null for the dense mask.
// Each returns the cudaError_t of its launch (0 on success).

// dK, dV (., S, D)
extern "C" int bigdl_wide_bwd_dkv(const void* q, const void* k, const void* v, const void* dO,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  const void* bmask, int nkb, int bq, int bk, int h0, int BH,
                                  int T_len, int S_len, int D, int dtype, float sm_scale,
                                  int causal, void* stream) {
  return wide_entry<Which::kDkv>(dtype, q, k, v, dO, lse, delta, dk, dv, bmask, nkb, bq, bk,
                                    h0, BH, T_len, S_len, D, sm_scale, causal, stream);
}

// dQ (., T, D)
extern "C" int bigdl_wide_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                                 const void* lse, const void* delta, void* dq,
                                 const void* bmask, int nkb, int bq, int bk, int h0, int BH,
                                 int T_len, int S_len, int D, int dtype, float sm_scale,
                                 int causal, void* stream) {
  return wide_entry<Which::kDq>(dtype, q, k, v, dO, lse, delta, dq, nullptr, bmask, nkb, bq,
                                   bk, h0, BH, T_len, S_len, D, sm_scale, causal, stream);
}
