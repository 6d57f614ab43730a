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
//     x's dtype.  Its backward dX is K9 again on (g, W^T, mask^T).
//
// Tables.  The TPU grid sweeps mask blocks; these kernels work on 64-row
// tiles (TILE), so the host (ops/block_sparse.py `_tile_tables`) builds the
// lists at tile granularity (and regroups them per 128 rows for the bf16
// K6-K8, below): for each q tile (K6, K8) the k tiles holding
// a live element, for each k tile (K7) the q tiles, in ascending order,
// each with a `partial` flag when the block mask does not cover the whole
// tile pair.  An all-ones causal mask therefore gives K1's sweep exactly.
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
// accumulators in registers) with a tile list in place of the dense sweep
// (ListSweep below): the host regroups the 64-row tile lists per block of
// 128 own rows, the block's two consumer warpgroups each computing the
// streamed tiles its own 64 rows visit; K6 reads K8's lists (the same own
// query rows, the same streamed K and V tiles).  A streamed tile with a
// partial pair is staged by the producer's first warp, live rows only, so
// the TMA load of a dead row never happens; inside a partial pair each
// element is tested against the block mask and its score selected to -inf
// (K6) or its P and dS to 0 (K7, K8).  In f32 they keep the tile loops of
// flash_fwd.cu's and flash_bwd.cu's f32 kernels over the 64-row tables
// (wgmma has no full-f32 product); on an all-ones mask both dtypes give
// K1-K3's bits.
//
// K9 design.  One block (4 warps) per (64 rows of x, up to 64 columns of
// one output column block); it walks that column block's live K blocks in
// chunks of 32, staging x and W chunks in shared memory (W rows past the
// live block and x columns past it are zero-filled, never loaded), bf16
// through WMMA with the accumulators in registers, f32 through FMA (a
// 4 x 8 micro-tile per thread).  Any M (the ragged edge masked), any bk and
// bn that tile K and N; 16-byte loads when bk and bn allow, else scalar
// ones.  At the flagship MLP shape (x 16384 x 1024 bf16, W 1024 x 4096 at
// density 0.5, block 128) it must do 68.7 GFLOP (0.069 ms) and move about
// 172 MB (0.051 ms): bound by operations.

#include <mma.h>   // K9's bf16 products (WMMA)

#include "attn_bwd_hopper.cuh"
#include "attn_fwd_hopper.cuh"

namespace {

// One row per tile of the block's own side: the tiles of the other side
// to visit.  Row r's first counts[r] entries of tiles / partial are live.
struct Tables {
  const int* tiles;        // (rows, L)
  const int* counts;       // (rows,)
  const uint8_t* partial;  // (rows, L): 1 where the block mask covers the pair in part
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

  // Some query of [q0, q0 + TILE) may attend key kp.
  __device__ bool key_live(int kp, int q0) const {
    if (kp >= S_len) return false;
    const int q_end = min(q0 + TILE, T_len);
    const int kb = kp / bk;
    for (int qb = q0 / bq; qb * bq < q_end; ++qb) {
      if (!m[qb * nkb + kb]) continue;
      if (!causal || min((qb + 1) * bq, q_end) - 1 >= kp) return true;
    }
    return false;
  }

  // Query qp may attend some key of [k0, k0 + TILE).
  __device__ bool query_live(int qp, int k0) const {
    if (qp >= T_len) return false;
    const int k_end = min(k0 + TILE, S_len);
    const int qb = qp / bq;
    for (int kb = k0 / bk; kb * bk < k_end; ++kb) {
      if (!m[qb * nkb + kb]) continue;
      if (!causal || max(kb * bk, k0) <= qp) return true;
    }
    return false;
  }
};

// A (TILE, D) tile whose rows come from row0 on where live[r], else zero.
template <typename T, int D>
__device__ __forceinline__ void load_live_rows(T* dst, const T* src, int row0,
                                               const uint8_t* live) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < TILE * VPR; i += NTHREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (live[r]) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * D + c) = val;
  }
}

// ---------------------------------------------------------------------------
// K6 in f32: the flash_fwd.cu tile loop over the 64-row tile tables; grid
// (ceil(T / 64), B*H), one block per q tile.
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (TILE * D + 2 * TILE * D + TILE * TILE)   // q, k, v, p
         + sizeof(float) * (TILE * TILE + TILE * D + 3 * TILE)    // s, acc, m, l, alpha
         + TILE;                                                  // live key rows
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
bs_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              Tables tab, Mask mk, float sm_scale) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + TILE * D;
  T* v_s = k_s + TILE * D;
  T* p_s = v_s + TILE * D;
  float* s_s = reinterpret_cast<float*>(p_s + TILE * TILE);
  float* acc_s = s_s + TILE * TILE;
  float* m_s = acc_s + TILE * D;
  float* l_s = m_s + TILE;
  float* alpha_s = l_s + TILE;
  uint8_t* live_s = reinterpret_cast<uint8_t*>(alpha_s + TILE);

  const int T_len = mk.T_len, S_len = mk.S_len, causal = mk.causal;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int qt = blockIdx.x;
  const int q0 = qt * TILE;
  q += (size_t)bh * T_len * D;
  k += (size_t)bh * S_len * D;
  v += (size_t)bh * S_len * D;
  o += (size_t)bh * T_len * D;
  lse += (size_t)bh * T_len;
  const int n_tiles = tab.counts[qt];
  const int* tiles = tab.tiles + (size_t)qt * tab.L;
  const uint8_t* partial = tab.partial + (size_t)qt * tab.L;

  load_tile<T, D>(q_s, q, q0, T_len, TILE);
  for (int i = threadIdx.x; i < TILE * D; i += NTHREADS) acc_s[i] = 0.0f;
  for (int i = threadIdx.x; i < TILE; i += NTHREADS) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.0f;
  }
  __syncthreads();

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = tiles[it] * TILE;
    const bool part = partial[it] != 0;
    if (part) {
      for (int r = threadIdx.x; r < TILE; r += NTHREADS) live_s[r] = mk.key_live(k0 + r, q0);
      __syncthreads();
      load_live_rows<T, D>(k_s, k, k0, live_s);
      load_live_rows<T, D>(v_s, v, k0, live_s);
    } else {
      load_tile<T, D>(k_s, k, k0, S_len, TILE);
      load_tile<T, D>(v_s, v, k0, S_len, TILE);
    }
    __syncthreads();

    score_tile<D>(q_s, k_s, s_s, warp, lane);
    __syncwarp();

    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      const int q_pos = q0 + r;
      float s0 = s_s[r * TILE + lane] * sm_scale;
      float s1 = s_s[r * TILE + lane + 32] * sm_scale;
      const int k_pos0 = k0 + lane, k_pos1 = k0 + lane + 32;
      if (k_pos0 >= S_len || (causal && k_pos0 > q_pos) ||
          (part && !(q_pos < T_len && mk.block(q_pos, k_pos0))))
        s0 = -INFINITY;
      if (k_pos1 >= S_len || (causal && k_pos1 > q_pos) ||
          (part && !(q_pos < T_len && mk.block(q_pos, k_pos1))))
        s1 = -INFINITY;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      // guard fully masked rows: exp(-inf - -inf) would be nan
      const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
      const float p0 = expf(s0 - m_safe);
      const float p1 = expf(s1 - m_safe);
      const float scale = m_old == -INFINITY ? 0.0f : expf(m_old - m_safe);
      const float psum = warp_sum(p0 + p1);
      p_s[r * TILE + lane] = from_f32<T>(p0);
      p_s[r * TILE + lane + 32] = from_f32<T>(p1);
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
    __syncthreads();   // k_s / v_s / live_s are overwritten by the next tile
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

// ---------------------------------------------------------------------------
// K7 and K8 in f32: the flash_bwd.cu tile loop over the 64-row tile tables.
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * 4 * TILE * D        // k, v, q, dO
         + sizeof(float) * 2 * TILE * TILE   // S^T, dP^T (then P^T, dS^T in place)
         + sizeof(float) * 2 * TILE * D      // dK, dV accumulators
         + sizeof(float) * 2 * TILE          // lse, delta
         + TILE;                             // live query rows
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * 4 * TILE * D        // q, dO, k, v
         + sizeof(float) * 2 * TILE * TILE   // S, dP (then dS in place)
         + sizeof(float) * TILE * D          // dQ accumulator
         + sizeof(float) * 2 * TILE          // lse, delta
         + TILE;                             // live key rows
}

// One (query, key) pair of a score tile: P and dS, both selected to 0 where
// the pair is masked (a masked dP may hold anything).
__device__ __forceinline__ void p_and_ds(float s, float dp, float lse, float delta, bool keep,
                                         float sm_scale, float* p, float* ds) {
  *p = keep ? expf(s * sm_scale - lse) : 0.0f;
  *ds = keep ? *p * (dp - delta) : 0.0f;
}

// K7 in f32: grid (ceil(S / 64), B*H), one block per k tile.  P^T and dS^T
// overwrite S^T and dP^T in place (each lane rewrites only what it read).
template <int D>
__global__ void __launch_bounds__(NTHREADS)
bs_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dO,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dk, float* __restrict__ dv, Tables tab, Mask mk,
              float sm_scale) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + TILE * D;
  T* q_s = v_s + TILE * D;
  T* do_s = q_s + TILE * D;
  float* st_s = do_s + TILE * D;      // S^T: key rows, query columns
  float* dpt_s = st_s + TILE * TILE;  // dP^T
  float* dk_acc = dpt_s + TILE * TILE;
  float* dv_acc = dk_acc + TILE * D;
  T* pt_s = st_s;     // written over S^T in place
  T* dst_s = dpt_s;   // written over dP^T in place
  float* lse_s = dv_acc + TILE * D;
  float* delta_s = lse_s + TILE;
  uint8_t* live_s = reinterpret_cast<uint8_t*>(delta_s + TILE);

  const int T_len = mk.T_len, S_len = mk.S_len, causal = mk.causal;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int kt = blockIdx.x;
  const int k0 = kt * TILE;
  q += (size_t)bh * T_len * D;
  dO += (size_t)bh * T_len * D;
  lse += (size_t)bh * T_len;
  delta += (size_t)bh * T_len;
  k += (size_t)bh * S_len * D;
  v += (size_t)bh * S_len * D;
  dk += (size_t)bh * S_len * D;
  dv += (size_t)bh * S_len * D;
  const int n_tiles = tab.counts[kt];
  const int* tiles = tab.tiles + (size_t)kt * tab.L;
  const uint8_t* partial = tab.partial + (size_t)kt * tab.L;

  load_tile<T, D>(k_s, k, k0, S_len, TILE);
  load_tile<T, D>(v_s, v, k0, S_len, TILE);
  for (int i = threadIdx.x; i < TILE * D; i += NTHREADS) {
    dk_acc[i] = 0.0f;
    dv_acc[i] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = tiles[it] * TILE;
    const bool part = partial[it] != 0;
    __syncthreads();   // k/v/accumulators ready; every warp done with the last q/dO tile
    if (part) {
      for (int r = threadIdx.x; r < TILE; r += NTHREADS) live_s[r] = mk.query_live(q0 + r, k0);
      __syncthreads();
      load_live_rows<T, D>(q_s, q, q0, live_s);
      load_live_rows<T, D>(do_s, dO, q0, live_s);
    } else {
      load_tile<T, D>(q_s, q, q0, T_len, TILE);
      load_tile<T, D>(do_s, dO, q0, T_len, TILE);
    }
    for (int i = threadIdx.x; i < TILE; i += NTHREADS) {
      const bool in = q0 + i < T_len;
      lse_s[i] = in ? lse[q0 + i] : BIG_LSE;
      delta_s[i] = in ? delta[q0 + i] : 0.0f;
    }
    __syncthreads();

    score_tile<D>(k_s, q_s, st_s, warp, lane);    // S^T = K . Q^T
    score_tile<D>(v_s, do_s, dpt_s, warp, lane);  // dP^T = V . dO^T
    __syncwarp();

    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      const int k_pos = k0 + r;
      for (int c = lane; c < TILE; c += 32) {
        const int q_pos = q0 + c;
        const bool keep = k_pos < S_len && q_pos < T_len && !(causal && k_pos > q_pos) &&
                          (!part || mk.block(q_pos, k_pos));
        float p, ds;
        p_and_ds(st_s[r * TILE + c], dpt_s[r * TILE + c], lse_s[c], delta_s[c], keep,
                 sm_scale, &p, &ds);
        pt_s[r * TILE + c] = p;
        dst_s[r * TILE + c] = ds;
      }
    }
    __syncwarp();

    mma_acc_tile<D>(pt_s, do_s, dv_acc, warp, lane);   // dV += P^T . dO
    mma_acc_tile<D>(dst_s, q_s, dk_acc, warp, lane);   // dK += dS^T . Q
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

// K8 in f32: grid (ceil(T / 64), B*H), one block per q tile, over K6's table.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
bs_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dq, Tables tab, Mask mk, float sm_scale) {
  using T = float;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + TILE * D;
  T* k_s = do_s + TILE * D;
  T* v_s = k_s + TILE * D;
  float* s_s = v_s + TILE * D;      // S: query rows, key columns
  float* dp_s = s_s + TILE * TILE;  // dP
  float* dq_acc = dp_s + TILE * TILE;
  T* ds_s = dp_s;   // written over dP in place
  float* lse_s = dq_acc + TILE * D;
  float* delta_s = lse_s + TILE;
  uint8_t* live_s = reinterpret_cast<uint8_t*>(delta_s + TILE);

  const int T_len = mk.T_len, S_len = mk.S_len, causal = mk.causal;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int qt = blockIdx.x;
  const int q0 = qt * TILE;
  q += (size_t)bh * T_len * D;
  dO += (size_t)bh * T_len * D;
  lse += (size_t)bh * T_len;
  delta += (size_t)bh * T_len;
  k += (size_t)bh * S_len * D;
  v += (size_t)bh * S_len * D;
  dq += (size_t)bh * T_len * D;
  const int n_tiles = tab.counts[qt];
  const int* tiles = tab.tiles + (size_t)qt * tab.L;
  const uint8_t* partial = tab.partial + (size_t)qt * tab.L;

  load_tile<T, D>(q_s, q, q0, T_len, TILE);
  load_tile<T, D>(do_s, dO, q0, T_len, TILE);
  for (int i = threadIdx.x; i < TILE; i += NTHREADS) {
    const bool in = q0 + i < T_len;
    lse_s[i] = in ? lse[q0 + i] : BIG_LSE;
    delta_s[i] = in ? delta[q0 + i] : 0.0f;
  }
  for (int i = threadIdx.x; i < TILE * D; i += NTHREADS) dq_acc[i] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = tiles[it] * TILE;
    const bool part = partial[it] != 0;
    __syncthreads();   // q/dO/stats ready; every warp done with the last k/v tile
    if (part) {
      for (int r = threadIdx.x; r < TILE; r += NTHREADS) live_s[r] = mk.key_live(k0 + r, q0);
      __syncthreads();
      load_live_rows<T, D>(k_s, k, k0, live_s);
      load_live_rows<T, D>(v_s, v, k0, live_s);
    } else {
      load_tile<T, D>(k_s, k, k0, S_len, TILE);
      load_tile<T, D>(v_s, v, k0, S_len, TILE);
    }
    __syncthreads();

    score_tile<D>(q_s, k_s, s_s, warp, lane);    // S = Q . K^T
    score_tile<D>(do_s, v_s, dp_s, warp, lane);  // dP = dO . V^T
    __syncwarp();

    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      const int q_pos = q0 + r;
      const float lse_r = lse_s[r];
      const float delta_r = delta_s[r];
      for (int c = lane; c < TILE; c += 32) {
        const int k_pos = k0 + c;
        const bool keep = k_pos < S_len && q_pos < T_len && !(causal && k_pos > q_pos) &&
                          (!part || mk.block(q_pos, k_pos));
        float p, ds;
        p_and_ds(s_s[r * TILE + c], dp_s[r * TILE + c], lse_r, delta_r, keep, sm_scale, &p,
                 &ds);
        ds_s[r * TILE + c] = ds;
      }
    }
    __syncwarp();

    mma_acc_tile<D>(ds_s, k_s, dq_acc, warp, lane);   // dQ += dS . K
  }
  __syncthreads();   // the zero-fill is visible when the sweep ran no tile

  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp * ROWS_PER_WARP + rr;
    if (q0 + r >= T_len) break;
    for (int d = lane; d < D; d += 32)
      dq[(size_t)(q0 + r) * D + d] = dq_acc[r * D + d] * sm_scale;
  }
}

// ---------------------------------------------------------------------------
// K6, K7 and K8 in bf16: the Hopper bodies of attn_fwd_hopper.cuh and
// attn_bwd_hopper.cuh over the tile lists of 128-row blocks.
// ---------------------------------------------------------------------------

// The lists ops/block_sparse.py builds per block of 128 own rows (key rows
// in K7, query rows in K6 and K8, which read the same lists): the ascending
// union of the lists of its two 64-row tiles, a flag byte per entry (bit w:
// tile w of the block visits the streamed tile; bit 2 + w: that pair is
// partial), the streamed rows some row of the block attends (bit r for row
// r, read at partial entries only), and the blocks in order of their list
// length, longest first.  On an all-ones causal mask at a 128-multiple block
// the lists are the dense sweeps of K1 (at D 128) and K2/K3, tile for tile,
// so K6-K8 give K1-K3's bits.
struct ListSweep {
  static constexpr bool kList = true;
  const int* tiles;                 // (blocks, L)
  const uint8_t* flags;             // (blocks, L)
  const unsigned long long* rows;   // (blocks, L)
  const int* counts;                // (blocks,)
  const int* order;                 // (blocks,)
  int L;
  Mask mk;
  const __nv_bfloat16* src_a;       // the streamed tensors: q, dO (K7); k, v (K8)
  const __nv_bfloat16* src_b;

  __device__ int dkv_block() const { return order[blockIdx.y]; }
  __device__ int dq_block() const { return order[blockIdx.y]; }
  __device__ int dkv_count(int b, int) const { return counts[b]; }
  __device__ int dq_count(int b, int) const { return counts[b]; }
  __device__ Step dkv_step(int b, int it) const {
    const size_t e = (size_t)b * L + it;
    return Step{tiles[e], flags[e]};
  }
  __device__ Step dq_step(int b, int it) const { return dkv_step(b, it); }
  __device__ int fwd_block() const { return order[blockIdx.y]; }
  __device__ int fwd_count(int b, int) const { return counts[b]; }
  __device__ Step fwd_step(int b, int it) const { return dkv_step(b, it); }
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
  Tables tab;        // f32: 64-row tile tables; bf16: 128-row block lists
  const int* order;  // bf16: the blocks, longest list first
  const unsigned long long* rows;   // bf16: live streamed rows
  Mask mk;
  int BH;
  float sm_scale;
  cudaStream_t stream;
};

enum class Which { kFwd, kDkv, kDq };

// K6 (out0 O, out1 LSE), K7 (out0 dK, out1 dV) or K8 (out0 dQ) in bf16
// over the block lists
template <Which W, int D>
cudaError_t launch_wgmma(const AttnArgs& a) {
  const bool dkv = W == Which::kDkv;
  const ListSweep sw{a.tab.tiles, a.tab.partial, a.rows, a.tab.counts, a.order, a.tab.L, a.mk,
                     static_cast<const __nv_bfloat16*>(dkv ? a.q : a.k),
                     static_cast<const __nv_bfloat16*>(dkv ? a.dO : a.v)};
  if constexpr (W == Which::kFwd) {
    return launch_fwd_wgmma<D, kTileRows>(FwdArgs{a.q, a.k, a.v, a.out0, a.out1, a.BH,
                                                  a.mk.T_len, a.mk.S_len, a.sm_scale,
                                                  a.mk.causal, a.stream},
                                          sw);
  } else {
    const BwdArgs b{a.q, a.k, a.v, a.dO, a.lse, a.delta, a.out0, a.out1, a.BH, a.mk.T_len,
                    a.mk.S_len, a.sm_scale, a.mk.causal, a.stream};
    if constexpr (W == Which::kDkv) return launch_dkv_wgmma<D>(b, sw);
    else return launch_dq_wgmma<D>(b, sw);
  }
}

template <Which W, typename T, int D>
cudaError_t launch_attn(const AttnArgs& a) {
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  const int rows = W == Which::kDkv ? a.mk.S_len : a.mk.T_len;
  dim3 grid((rows + TILE - 1) / TILE, a.BH);
  cudaError_t err;
  if constexpr (kIsBf16<T>) {
    if (a.order == nullptr || a.rows == nullptr) return cudaErrorInvalidValue;
    return launch_wgmma<W, D>(a);
  } else if constexpr (W == Which::kFwd) {
    constexpr size_t smem = fwd_smem_bytes<D>();
    static_assert(smem <= kMaxSmemBytes, "block-sparse tiles do not fit in shared memory");
    auto kernel = bs_fwd_kernel<D>;
    err = smem_opt_in_once(kernel, (int)smem, mu, attr_set);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NTHREADS, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<float*>(a.out0),
        static_cast<float*>(a.out1), a.tab, a.mk, a.sm_scale);
  } else if constexpr (W == Which::kDkv) {
    constexpr size_t smem = dkv_smem_bytes<D>();
    static_assert(smem <= kMaxSmemBytes, "block-sparse tiles do not fit in shared memory");
    auto kernel = bs_dkv_kernel<D>;
    err = smem_opt_in_once(kernel, (int)smem, mu, attr_set);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NTHREADS, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dO), a.lse, a.delta,
        static_cast<float*>(a.out0), static_cast<float*>(a.out1), a.tab, a.mk, a.sm_scale);
  } else {
    constexpr size_t smem = dq_smem_bytes<D>();
    static_assert(smem <= kMaxSmemBytes, "block-sparse tiles do not fit in shared memory");
    auto kernel = bs_dq_kernel<D>;
    err = smem_opt_in_once(kernel, (int)smem, mu, attr_set);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NTHREADS, smem, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dO), a.lse, a.delta,
        static_cast<float*>(a.out0), a.tab, a.mk, a.sm_scale);
  }
  return cudaGetLastError();
}

template <Which W, typename T>
cudaError_t dispatch_attn_d(int D, const AttnArgs& a) {
  switch (D) {
    case 16: return launch_attn<W, T, 16>(a);
    case 32: return launch_attn<W, T, 32>(a);
    case 64: return launch_attn<W, T, 64>(a);
    case 128: return launch_attn<W, T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <Which W>
int dispatch_attn(int D, int dtype, const AttnArgs& a) {
  const Mask& mk = a.mk;
  if (a.BH <= 0 || a.BH > 65535 || mk.T_len <= 0 || mk.S_len <= 0 || mk.bq <= 0 ||
      mk.bk <= 0 || mk.T_len % mk.bq || mk.S_len % mk.bk || mk.nkb != mk.S_len / mk.bk ||
      a.tab.L <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) return (int)dispatch_attn_d<W, __nv_bfloat16>(D, a);
  if (dtype == 0) return (int)dispatch_attn_d<W, float>(D, a);
  return (int)cudaErrorInvalidValue;
}

AttnArgs make_args(const void* q, const void* k, const void* v, const void* dO, const void* lse,
                   const void* delta, void* out0, void* out1, const void* tiles,
                   const void* counts, const void* partial, const void* bmask, const void* order,
                   const void* rows, int L, int nkb, int bq, int bk, int BH, int T_len,
                   int S_len, float sm_scale, int causal, void* stream) {
  return AttnArgs{q, k, v, dO, static_cast<const float*>(lse), static_cast<const float*>(delta),
                  out0, out1,
                  Tables{static_cast<const int*>(tiles), static_cast<const int*>(counts),
                         static_cast<const uint8_t*>(partial), L},
                  static_cast<const int*>(order), static_cast<const unsigned long long*>(rows),
                  Mask{static_cast<const uint8_t*>(bmask), nkb, bq, bk, T_len, S_len, causal},
                  BH, sm_scale, static_cast<cudaStream_t>(stream)};
}

template <Which W, int D>
int smem_of(int dtype) {
  if (dtype == 1)
    return (int)(W == Which::kFwd   ? FwdCfg<D, kTileRows>::SMEM
                 : W == Which::kDkv ? DkvCfg<D>::SMEM
                                    : DqCfg<D>::SMEM);
  if (dtype == 0)
    return (int)(W == Which::kFwd   ? fwd_smem_bytes<D>()
                 : W == Which::kDkv ? dkv_smem_bytes<D>()
                                    : dq_smem_bytes<D>());
  return 0;
}

template <Which W>
int smem_of_d(int D, int dtype) {
  switch (D) {
    case 16: return smem_of<W, 16>(dtype);
    case 32: return smem_of<W, 32>(dtype);
    case 64: return smem_of<W, 64>(dtype);
    case 128: return smem_of<W, 128>(dtype);
    default: return 0;
  }
}

// ---------------------------------------------------------------------------
// K9: grid (ceil(M / 64), number of 64-column chunks of all column blocks).
// ---------------------------------------------------------------------------

constexpr int MM_TILE = 64;   // rows of x and columns of W per block
constexpr int MM_KC = 32;     // depth of one staged chunk

// Rows [0, 64) x columns [0, MM_KC) of x from (m0, kk); zero past M and kw.
template <typename T, bool VEC>
__device__ __forceinline__ void load_x_chunk(T* x_s, const T* x, int m0, int M, int K, int kk,
                                             int kw) {
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    constexpr int VPR = MM_KC / V;
    for (int i = threadIdx.x; i < MM_TILE * VPR; i += NTHREADS) {
      const int r = i / VPR, c = (i % VPR) * V;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && c < kw)
        val = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + kk + c);
      *reinterpret_cast<uint4*>(x_s + r * MM_KC + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < MM_TILE * MM_KC; i += NTHREADS) {
      const int r = i / MM_KC, c = i % MM_KC;
      x_s[i] = (m0 + r < M && c < kw) ? x[(size_t)(m0 + r) * K + kk + c] : from_f32<T>(0.0f);
    }
  }
}

// Rows [0, MM_KC) x columns [0, 64) of W from (kk, c0); zero past kw and cw.
template <typename T, bool VEC>
__device__ __forceinline__ void load_w_chunk(T* w_s, const T* w, int N, int kk, int kw, int c0,
                                             int cw) {
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    constexpr int VPR = MM_TILE / V;
    for (int i = threadIdx.x; i < MM_KC * VPR; i += NTHREADS) {
      const int r = i / VPR, c = (i % VPR) * V;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < kw && c < cw)
        val = *reinterpret_cast<const uint4*>(w + (size_t)(kk + r) * N + c0 + c);
      *reinterpret_cast<uint4*>(w_s + r * MM_TILE + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < MM_KC * MM_TILE; i += NTHREADS) {
      const int r = i / MM_TILE, c = i % MM_TILE;
      w_s[i] = (r < kw && c < cw) ? w[(size_t)(kk + r) * N + c0 + c] : from_f32<T>(0.0f);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
bs_mm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, Tables tab,
             int M, int K, int N, int bk, int bn, int chunks) {
  __shared__ __align__(128) T x_s[MM_TILE * MM_KC];
  __shared__ __align__(128) T w_s[MM_KC * MM_TILE];

  const int m0 = blockIdx.x * MM_TILE;
  const int cb = blockIdx.y / chunks;   // output column block
  const int c0 = cb * bn + (blockIdx.y % chunks) * MM_TILE;
  const int cw = min(MM_TILE, (cb + 1) * bn - c0);
  const int n_blocks = tab.counts[cb];
  const int* kblocks = tab.tiles + (size_t)cb * tab.L;
  const int warp = threadIdx.x / 32;

  if constexpr (kIsBf16<T>) {
    using namespace nvcuda;
    __shared__ __align__(128) float o_s[MM_TILE * MM_TILE];
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MM_TILE / 16];
    for (int ct = 0; ct < MM_TILE / 16; ++ct) wmma::fill_fragment(acc[ct], 0.0f);
    for (int it = 0; it < n_blocks; ++it) {
      const int k_beg = kblocks[it] * bk, k_end = k_beg + bk;
      for (int kk = k_beg; kk < k_end; kk += MM_KC) {
        const int kw = min(MM_KC, k_end - kk);
        __syncthreads();   // every warp done with the last chunk
        load_x_chunk<T, VEC>(x_s, x, m0, M, K, kk, kw);
        load_w_chunk<T, VEC>(w_s, w, N, kk, kw, c0, cw);
        __syncthreads();
        for (int ks = 0; ks < MM_KC; ks += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::load_matrix_sync(a, x_s + warp * 16 * MM_KC + ks, MM_KC);
          for (int ct = 0; ct < MM_TILE / 16; ++ct) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
            wmma::load_matrix_sync(b, w_s + ks * MM_TILE + ct * 16, MM_TILE);
            wmma::mma_sync(acc[ct], a, b, acc[ct]);
          }
        }
      }
    }
    for (int ct = 0; ct < MM_TILE / 16; ++ct)
      wmma::store_matrix_sync(o_s + warp * 16 * MM_TILE + ct * 16, acc[ct], MM_TILE,
                              wmma::mem_row_major);
    __syncwarp();
    const int lane = threadIdx.x % 32;
    for (int i = lane; i < 16 * MM_TILE; i += 32) {
      const int r = warp * 16 + i / MM_TILE, c = i % MM_TILE;
      if (m0 + r < M && c < cw)
        out[(size_t)(m0 + r) * N + c0 + c] = from_f32<T>(o_s[r * MM_TILE + c]);
    }
  } else {
    const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;   // 4 rows x 8 columns each
    float acc[4][8] = {};
    for (int it = 0; it < n_blocks; ++it) {
      const int k_beg = kblocks[it] * bk, k_end = k_beg + bk;
      for (int kk = k_beg; kk < k_end; kk += MM_KC) {
        const int kw = min(MM_KC, k_end - kk);
        __syncthreads();
        load_x_chunk<T, VEC>(x_s, x, m0, M, K, kk, kw);
        load_w_chunk<T, VEC>(w_s, w, N, kk, kw, c0, cw);
        __syncthreads();
        for (int kc = 0; kc < MM_KC; ++kc) {
          float a[4], b[8];
          for (int i = 0; i < 4; ++i) a[i] = to_f32(x_s[(rg * 4 + i) * MM_KC + kc]);
          for (int j = 0; j < 8; ++j) b[j] = to_f32(w_s[kc * MM_TILE + cg * 8 + j]);
          for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * b[j];
        }
      }
    }
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      if (m0 + r >= M) break;
      for (int j = 0; j < 8; ++j) {
        const int c = cg * 8 + j;
        if (c < cw) out[(size_t)(m0 + r) * N + c0 + c] = from_f32<T>(acc[i][j]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_mm(const void* x, const void* w, void* out, Tables tab, int M, int K, int N,
                      int bk, int bn, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int chunks = (bn + MM_TILE - 1) / MM_TILE;
  const long long ny = (long long)(N / bn) * chunks;
  if (ny > 65535) return cudaErrorInvalidValue;
  dim3 grid((M + MM_TILE - 1) / MM_TILE, (unsigned)ny);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (bk % V == 0 && bn % V == 0)
    bs_mm_kernel<T, true><<<grid, NTHREADS, 0, stream>>>(xp, wp, op, tab, M, K, N, bk, bn,
                                                         chunks);
  else
    bs_mm_kernel<T, false><<<grid, NTHREADS, 0, stream>>>(xp, wp, op, tab, M, K, N, bk, bn,
                                                          chunks);
  return cudaGetLastError();
}

}  // namespace

// q, dO (BH, T, D) and k, v (BH, S, D) in one dtype (0 = float32,
// 1 = bfloat16); lse and delta (BH, T) f32; outputs as their inputs; bmask
// (T / bq, S / bk) uint8, the runtime block mask.  The tables as
// ops/block_sparse.py builds them.  In f32 the kernels read 64-row tile
// tables: tiles (tiles, L) int32, counts (tiles,) int32, partial (tiles, L)
// uint8; order and rows are not read.  In bf16 they read 128-row block
// lists: tiles (blocks, L) int32, counts (blocks,) int32, partial the flag
// bytes (blocks, L) uint8, order (blocks,) int32 and rows (blocks, L)
// uint64.  All contiguous and 16-byte aligned.  Each returns the
// cudaError_t of its launch (0 on success).

// K6: o (BH, T, D), lse (BH, T); tables per q tile (f32) or per 128 query
// rows (bf16: the lists K8 reads).
extern "C" int bigdl_bs_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            const void* tiles, const void* counts, const void* partial,
                            const void* bmask, const void* order, const void* rows, int L,
                            int nkb, int bq, int bk, int BH, int T_len, int S_len, int D,
                            int dtype, float sm_scale, int causal, void* stream) {
  const AttnArgs a = make_args(q, k, v, nullptr, nullptr, nullptr, o, lse, tiles, counts, partial,
                               bmask, order, rows, L, nkb, bq, bk, BH, T_len, S_len, sm_scale,
                               causal, stream);
  return dispatch_attn<Which::kFwd>(D, dtype, a);
}

// K7: dk, dv (BH, S, D); tables per k tile (f32) or per 128 key rows (bf16).
extern "C" int bigdl_bs_bwd_dkv(const void* q, const void* k, const void* v, const void* dO,
                                const void* lse, const void* delta, void* dk, void* dv,
                                const void* tiles, const void* counts, const void* partial,
                                const void* bmask, const void* order, const void* rows, int L,
                                int nkb, int bq, int bk, int BH, int T_len, int S_len, int D,
                                int dtype, float sm_scale, int causal, void* stream) {
  const AttnArgs a = make_args(q, k, v, dO, lse, delta, dk, dv, tiles, counts, partial, bmask,
                               order, rows, L, nkb, bq, bk, BH, T_len, S_len, sm_scale, causal,
                               stream);
  return dispatch_attn<Which::kDkv>(D, dtype, a);
}

// K8: dq (BH, T, D); tables per q tile (f32) or per 128 query rows (bf16).
extern "C" int bigdl_bs_bwd_dq(const void* q, const void* k, const void* v, const void* dO,
                               const void* lse, const void* delta, void* dq, const void* tiles,
                               const void* counts, const void* partial, const void* bmask,
                               const void* order, const void* rows, int L, int nkb, int bq,
                               int bk, int BH, int T_len, int S_len, int D, int dtype,
                               float sm_scale, int causal, void* stream) {
  const AttnArgs a = make_args(q, k, v, dO, lse, delta, dq, nullptr, tiles, counts, partial,
                               bmask, order, rows, L, nkb, bq, bk, BH, T_len, S_len, sm_scale,
                               causal, stream);
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

// K9: out (M, N) = x (M, K) @ W (K, N) over W's live (bk, bn) tiles; tiles
// (N / bn, L) int32 lists each output column block's live K blocks, counts
// (N / bn,) int32 their number.  x, w, out in one dtype.
extern "C" int bigdl_bs_mm(const void* x, const void* w, void* out, const void* tiles,
                           const void* counts, int L, int M, int K, int N, int bk, int bn,
                           int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || bk <= 0 || bn <= 0 || K % bk || N % bn || L <= 0)
    return (int)cudaErrorInvalidValue;
  const Tables tab{static_cast<const int*>(tiles), static_cast<const int*>(counts), nullptr, L};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch_mm<__nv_bfloat16>(x, w, out, tab, M, K, N, bk, bn, s);
  if (dtype == 0) return (int)launch_mm<float>(x, w, out, tab, M, K, N, bk, bn, s);
  return (int)cudaErrorInvalidValue;
}
