// 3x3 stride-1 SAME convolution for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel `_kernel` of bigdl_tpu/ops/conv3x3_pallas.py
// (launched by `_conv3x3_fwd`).  It computes what that kernel computes:
//   y[b, h, w, o] = sum over dy, dx in 0..2 and c of
//                   x[b, h + dy - 1, w + dx - 1, c] * wk[dy, dx, o, c],
// with zero padding outside the image, products accumulated in f32 and
// the output in x's dtype.  x and y are NHWC; the weights come in as
// (tap, out, in), which the wrapper makes from the HWIO weight once per
// call (ops/conv3x3.py).  The backward's dX is this kernel again, on the
// output gradient with the spatially flipped weights.
//
// What bounds it on an H100.  At ResNet-50's stage-1 shape (B 64, 56 x 56,
// C = O = 64, bf16) one call moves x, w and y, 51.5 MB, 15.4 us at
// 3.35 TB/s, against 14.8 GFLOP, 15.0 us at 989 TFLOP/s: it sits at the
// ridge; the deeper stages (C = O up to 512) are bound by operations.  So
// the loads must overlap the products, and the products must run on wgmma.
//
// bf16 design (conv3x3_kernel_wgmma): an implicit GEMM.  M is output
// pixels, N output channels and K the nine taps times C, walked as
// 9 * ceil(C / KC) steps (tap, c0), KC = 16, 32 or 64 channels (the
// smallest that holds C, at most 64: a 32-, 64- or 128-byte swizzle).  A
// block owns two pixel boxes of at most 64 pixels each (TN images x TH
// rows x TW columns, picked on the host to waste the fewest rows) and BN
// output channels (64 at O <= 64, else 128): a producer warp and two
// consumer warpgroups, one per box.  For step
// (tap (dy, dx), c0) the producer's TMA loads each box of x at coordinates
// (c0, w0 + dx - 1, h0 + dy - 1, n0) through a 4-D tensor map (C, W, H, B),
// and the weight box (c0, o0, tap) through a 3-D map (C, O, 9), into a ring
// of stages guarded by full and empty mbarriers.  TMA fills every element
// outside the tensor with zeros, before its start too, so the SAME halo,
// the ragged edges of H, W and B, channels past C and rows past O need no
// masking code (the TPU kernel's flat slab with two wrap columns per row
// is not carried over).  A box lands as a row-major (pixels x KC) panel,
// K-major, which a wgmma descriptor reads as it stands; the consumer
// accumulates its 64 x BN tile in registers with wgmma (both operands in
// shared memory), keeps one step's products in flight, and frees a stage
// once the products that read it are done.  The epilogue rounds to bf16,
// stages 64 channels at a time in the consumer's own pixel slots and
// stores the pixels inside the image, 16 bytes a thread (element by
// element where O is not a multiple of 8).  A block takes at most 97 KB of
// shared memory and 288 threads (the producer is one warp) of at most 96
// registers, so two share an SM and one block's epilogue and first loads
// overlap the other's products.  ptxas compiles the whole kernel to the
// register cap of its launch bounds, whatever setmaxnreg hands over later:
// two 384-thread blocks would cap at 80, too few for an m64n128 wgmma (64
// accumulator registers and its operands).  TMA's limits fall
// on the wrapper: C a multiple of 8 and at least 16 (it zero-pads x's and
// the weights' channels), x, the weights and y 16-byte aligned.
//
// f32 (conv3x3_kernel_f32) keeps the FMA design: wgmma has no full-f32
// product.  One 4-warp block owns TH x TW <= 64 output pixels of one image
// and 64 output channels; for each chunk of 32 input channels it loads the
// haloed patch, (TH + 2) x (TW + 2) pixels, and the nine taps' weights into
// shared memory once, zero outside the image and past C and O, and all nine
// taps read their shifted windows from that one patch.

#include "hopper_common.cuh"
#include "tile_common.cuh"

namespace {

// ---- bf16: an implicit GEMM on TMA and wgmma ---------------------------------

constexpr int kConvThreads = kConsumers + 32;  // two consumer warpgroups, a producer warp
constexpr int kConvBlocksPerSm = 2;
constexpr int kBoxRows = 64;                   // output pixels of a consumer warpgroup
constexpr int kRingBytes = 98304;              // the ring of a block: two fit on an SM

// The ring's stages: each holds both consumers' pixel boxes (64 rows of KC
// channels) and the weight box (BN rows of KC channels).
template <int KC, int BN>
struct ConvCfg {
  static constexpr int kChunk = KC;             // input channels a step
  static constexpr int kOut = BN;               // output channels a block
  static constexpr int RB = KC * 2;             // bytes of a box row = the swizzle span
  static constexpr int A_SLOT = kBoxRows * RB;  // one consumer's pixel box
  static constexpr int B_SLOT = BN * RB;        // the weight box
  static constexpr int STAGE = 2 * A_SLOT + B_SLOT;
  static constexpr int STAGES = kRingBytes / STAGE < 8 ? kRingBytes / STAGE : 8;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
  // the epilogue stages 64 channels of 64 pixels in a consumer's own slots
  static_assert(STAGES * A_SLOT >= kBoxRows * 128, "conv3x3: epilogue rows do not fit");
  static_assert(STAGES >= 2, "conv3x3: the ring needs two stages");
};

// What a launch's blocks share: the output's shape and the pixel box.
struct ConvShape {
  int B, H, W, O;
  int TN, TH, TW;                 // the box: TN images x TH rows x TW columns
  int tiles_w, tiles_h, n_tiles;  // boxes over W, over H, and in all
  int n_chunks;                   // ceil(C / KC)
};

// (w0, h0, n0) of pixel box t; boxes run along W, then H, then B
__device__ __forceinline__ int3 box_origin(const ConvShape& sh, int t) {
  const int wt = t % sh.tiles_w;
  const int rest = t / sh.tiles_w;
  return make_int3(wt * sh.TW, (rest % sh.tiles_h) * sh.TH, (rest / sh.tiles_h) * sh.TN);
}

// The 64 staged rows of a consumer's box (channels o0 .. o0 + 63, 128-byte
// rows with their 16-byte chunks xor'd by row, as stage_rows leaves them) to
// y, 16 bytes a thread; rows past the box, pixels outside the image and
// channels at or past O are not written.
__device__ __forceinline__ void store_box(const unsigned char* rows, __nv_bfloat16* __restrict__ y,
                                          const ConvShape& sh, int3 p, int o0) {
  const int box_rows = sh.TN * sh.TH * sh.TW;
  const bool vec = sh.O % 8 == 0;
  for (int i = threadIdx.x % 128; i < kBoxRows * 8; i += 128) {
    const int r = i / 8, cc = i % 8;
    const int n = p.z + r / (sh.TH * sh.TW);
    const int h = p.y + (r / sh.TW) % sh.TH;
    const int w = p.x + r % sh.TW;
    const int o = o0 + 8 * cc;
    if (r >= box_rows || n >= sh.B || h >= sh.H || w >= sh.W || o >= sh.O) continue;
    const unsigned char* src = rows + r * 128 + 16 * (cc ^ (r & 7));
    __nv_bfloat16* dst = y + (((size_t)n * sh.H + h) * sh.W + w) * sh.O + o;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(src);
      for (int k = 0; k < 8 && o + k < sh.O; ++k) dst[k] = e[k];
    }
  }
}

// grid (ceil(n_tiles / 2), ceil(O / BN)): block (i, j) computes pixel boxes
// 2 i and 2 i + 1 (consumer warpgroups 0 and 1) by output channels
// j BN .. j BN + BN - 1.
template <int KC, int BN>
__global__ void __launch_bounds__(kConvThreads, kConvBlocksPerSm)
conv3x3_kernel_wgmma(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w, __nv_bfloat16* __restrict__ y,
                     const ConvShape sh) {
  using C = ConvCfg<KC, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* a_s = align1024(smem_raw);              // [consumer][stage] pixel boxes
  unsigned char* b_s = a_s + 2 * C::STAGES * C::A_SLOT;  // [stage] weight boxes
  uint64_t* full = reinterpret_cast<uint64_t*>(b_s + C::STAGES * C::B_SLOT);
  uint64_t* empty = full + C::STAGES;

  const int n_steps = 9 * sh.n_chunks;
  const int o0 = blockIdx.y * BN;

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
      // the block's boxes; a missing second box (an odd count) loads nothing
      const int t0 = 2 * blockIdx.x;
      const bool two = t0 + 1 < sh.n_tiles;
      const int3 p0 = box_origin(sh, t0);
      const int3 p1 = box_origin(sh, two ? t0 + 1 : t0);
      const uint32_t bytes =
          (two ? 2 : 1) * sh.TN * sh.TH * sh.TW * C::RB + (uint32_t)C::B_SLOT;
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % C::STAGES;
        const int tap = it / sh.n_chunks;
        const int c0 = (it - tap * sh.n_chunks) * KC;
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
        mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);   // the first round passes
        mbar_arrive_expect_tx(&full[s], bytes);
        tma_load_4d(a_s + s * C::A_SLOT, &tm_x, &full[s], c0, p0.x + dx, p0.y + dy, p0.z);
        if (two)
          tma_load_4d(a_s + (C::STAGES + s) * C::A_SLOT, &tm_x, &full[s], c0, p1.x + dx,
                      p1.y + dy, p1.z);
        tma_load_3d(b_s + s * C::B_SLOT, &tm_w, &full[s], c0, o0, tap);
      }
    }
  } else {
    const int wg = threadIdx.x / 128;
    const int tile = 2 * blockIdx.x + wg;
    const bool live = tile < sh.n_tiles;   // else only the barriers, in step
    unsigned char* a_wg = a_s + wg * C::STAGES * C::A_SLOT;

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    for (int it = 0; it < n_steps; ++it) {
      const int s = it % C::STAGES;
      mbar_wait(&full[s], (it / C::STAGES) & 1);
      if (live) {
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < KC / 16; ++j)
          wgmma_ss<BN, 0>(acc, smem_desc<C::RB>(a_wg + s * C::A_SLOT + 32 * j),
                          smem_desc<C::RB>(b_s + s * C::B_SLOT + 32 * j), 1);
        wgmma_commit();
        wgmma_wait<1>();   // the previous step's products are done
      }
      if (it > 0) mbar_arrive(&empty[(it - 1) % C::STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_regs(acc[i]);

    // epilogue: 64 channels at a time, in bf16, through this warpgroup's own
    // pixel slots (every load into them has landed and been read)
    if (live) {
      const int3 p = box_origin(sh, tile);
#pragma unroll
      for (int q = 0; q < BN / 64; ++q) {
        if (q > 0) named_barrier_sync(1 + wg, 128);   // the last rows are stored
        stage_rows<64, 0>(a_wg, acc + 32 * q, 1.0f);
        named_barrier_sync(1 + wg, 128);
        store_box(a_wg, y, sh, p, o0 + 64 * q);
      }
    }
  }
}

// The pixel box of a consumer warpgroup, TN x TH x TW <= 64 pixels: the
// fewest boxes over the batch, then the widest rows.  Returns the count.
int pick_box(int B, int H, int W, int* TN, int* TH, int* TW) {
  long best = -1;
  for (int tw = 1; tw <= (W < kBoxRows ? W : kBoxRows); ++tw)
    for (int th = 1; th <= H && th * tw <= kBoxRows; ++th) {
      const int tn = kBoxRows / (th * tw) < B ? kBoxRows / (th * tw) : B;
      const long count =
          (long)((B + tn - 1) / tn) * ((H + th - 1) / th) * ((W + tw - 1) / tw);
      if (best < 0 || count <= best) {   // ties go to the wider rows
        best = count;
        *TN = tn;
        *TH = th;
        *TW = tw;
      }
    }
  return best > 0x7fffffffL ? -1 : (int)best;
}

// KC (the smallest of 16, 32, 64 that holds C, at most 64) and BN (64 at
// O <= 64, else 128) of the bf16 kernel
int chunk_channels(int C) { return C <= 16 ? 16 : C <= 32 ? 32 : 64; }
int block_channels(int O) { return O <= 64 ? 64 : 128; }

// f(ConvCfg<KC, BN>{}) for the bf16 instantiation at (kc, bn), or `none`
template <class R, class F>
R with_cfg(int kc, int bn, R none, F f) {
  switch (kc * 1000 + bn) {
    case 16064: return f(ConvCfg<16, 64>{});
    case 16128: return f(ConvCfg<16, 128>{});
    case 32064: return f(ConvCfg<32, 64>{});
    case 32128: return f(ConvCfg<32, 128>{});
    case 64064: return f(ConvCfg<64, 64>{});
    case 64128: return f(ConvCfg<64, 128>{});
  }
  return none;
}

// the once-per-device shared-memory opt-in of conv3x3_kernel_wgmma<KC, BN>
template <class Cfg>
cudaError_t wgmma_opt_in() {
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  return smem_opt_in_once(conv3x3_kernel_wgmma<Cfg::kChunk, Cfg::kOut>, (int)Cfg::SMEM, mu,
                          attr_set, true);
}

template <class Cfg>
cudaError_t launch_wgmma(const void* x, const void* wk, void* y, int B, int H, int W, int C,
                         int O, cudaStream_t stream) {
  constexpr int KC = Cfg::kChunk, BN = Cfg::kOut;
  static_assert(kConvBlocksPerSm * (Cfg::SMEM + 1024) <= 233472,
                "conv3x3: two blocks must share an SM");
  ConvShape sh;
  sh.B = B;
  sh.H = H;
  sh.W = W;
  sh.O = O;
  sh.n_tiles = pick_box(B, H, W, &sh.TN, &sh.TH, &sh.TW);
  if (sh.n_tiles <= 0) return cudaErrorInvalidValue;
  sh.tiles_w = (W + sh.TW - 1) / sh.TW;
  sh.tiles_h = (H + sh.TH - 1) / sh.TH;
  sh.n_chunks = (C + KC - 1) / KC;
  // encoded per launch and passed by value: a CUDA graph captures them
  CUtensorMap tm_x, tm_w;
  cudaError_t err = encode_bf16_4d(&tm_x, x, C, W, H, B, KC, sh.TW, sh.TH, sh.TN);
  if (err == cudaSuccess) err = encode_bf16_3d(&tm_w, wk, C, O, 9, KC, BN);
  if (err == cudaSuccess) err = wgmma_opt_in<Cfg>();
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.n_tiles + 1) / 2, (O + BN - 1) / BN);
  conv3x3_kernel_wgmma<KC, BN><<<grid, kConvThreads, Cfg::SMEM, stream>>>(
      tm_x, tm_w, static_cast<__nv_bfloat16*>(y), sh);
  return cudaGetLastError();
}

cudaError_t dispatch_bf16(const void* x, const void* wk, void* y, int B, int H, int W, int C,
                          int O, cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wk) |
                        reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  if (C % 8 != 0 || C < 16 || !aligned) return cudaErrorInvalidValue;
  return with_cfg(chunk_channels(C), block_channels(O), (cudaError_t)cudaErrorInvalidValue,
                  [&](auto cfg) {
                    return launch_wgmma<decltype(cfg)>(x, wk, y, B, H, W, C, O, stream);
                  });
}

// ---- f32: the FMA tile loop --------------------------------------------------

constexpr int BM = 64;          // output pixel slots per block
constexpr int BN32 = 64;        // output channels per block
constexpr int KC32 = 32;        // input channels per chunk
constexpr int PATCH_MAX = 200;  // (TH + 2) * (TW + 2) <= 198 when TH * TW <= 64
constexpr int OUT_STRIDE = BN32 + 4;
constexpr int kRow = KC32 + 1;  // 33 words a row: one k spreads over all banks
constexpr int kVec = 4;         // floats in one 16-byte load
constexpr size_t kF32Smem =
    sizeof(float) * (size_t)(PATCH_MAX + 9 * BN32) * kRow > sizeof(float) * BM * OUT_STRIDE
        ? sizeof(float) * (size_t)(PATCH_MAX + 9 * BN32) * kRow
        : sizeof(float) * BM * OUT_STRIDE;

// Elements [c, c + kVec) of a channel chunk that has `count` channels left
// in its row (`src` points at the chunk's first channel) into dst; zero
// past `count` and when !valid.  `vec` allows one 16-byte load (the row
// length is a multiple of kVec and the base is aligned).
__device__ __forceinline__ void load_vec(float* dst, const float* src, int c, int count, bool vec,
                                         bool valid) {
  if (valid && vec && c < count) {
    const float4 val = *reinterpret_cast<const float4*>(src + c);
    dst[0] = val.x;
    dst[1] = val.y;
    dst[2] = val.z;
    dst[3] = val.w;
  } else {
    for (int j = 0; j < kVec; ++j) dst[j] = (valid && c + j < count) ? src[c + j] : 0.0f;
  }
}

// The patch position of output slot m at tap (0, 0); slots past TH * TW
// read position 0 and are never stored.
__device__ __forceinline__ int slot_pos(int m, int slots, int TW, int PW) {
  return m < slots ? (m / TW) * PW + m % TW : 0;
}

// thread (tm, tn) owns slots tm + 8 i (i < 8) and channels tn + 16 j (j < 4)
__global__ void __launch_bounds__(NTHREADS)
conv3x3_kernel_f32(const float* __restrict__ x, const float* __restrict__ wk,
                   float* __restrict__ y, int H, int W, int C, int O, int TH, int TW,
                   int tiles_w, int x_aligned) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int VPR = KC32 / kVec;   // 16-byte vectors per patch or weight row
  float* patch_s = reinterpret_cast<float*>(smem);
  float* w_s = patch_s + PATCH_MAX * kRow;
  float* out_s = reinterpret_cast<float*>(smem);   // reused after the last chunk

  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int o0 = blockIdx.z * BN32;
  const int PW = TW + 2;
  const int npos = (TH + 2) * PW;
  const int slots = TH * TW;
  const bool vec_x = x_aligned && C % kVec == 0;
  const bool vec_w = C % kVec == 0;
  x += (size_t)blockIdx.y * H * W * C;
  y += (size_t)blockIdx.y * H * W * O;

  const int tn = threadIdx.x & 15;
  const int tm = threadIdx.x >> 4;
  int pos[8];
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    pos[i] = slot_pos(tm + 8 * i, slots, TW, PW);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  for (int c0 = 0; c0 < C; c0 += KC32) {
    // the haloed patch: image rows h0 - 1 .. h0 + TH, columns w0 - 1 .. w0 + TW
    for (int i = threadIdx.x; i < npos * VPR; i += NTHREADS) {
      const int p = i / VPR, v = i % VPR;
      const int h = h0 + p / PW - 1, w = w0 + p % PW - 1;
      const bool inside = h >= 0 && h < H && w >= 0 && w < W;
      const float* src = x + ((size_t)(inside ? h : 0) * W + (inside ? w : 0)) * C + c0;
      load_vec(patch_s + p * kRow + v * kVec, src, v * kVec, C - c0, vec_x, inside);
    }
    // the nine taps' weights for output channels o0 .. o0 + BN32
    for (int i = threadIdx.x; i < 9 * BN32 * VPR; i += NTHREADS) {
      const int row = i / VPR, v = i % VPR;   // row = tap * BN32 + n
      const int o = o0 + row % BN32;
      const bool valid = o < O;
      const float* src = wk + ((size_t)(row / BN32) * O + (valid ? o : 0)) * C + c0;
      load_vec(w_s + row * kRow + v * kVec, src, v * kVec, C - c0, vec_w, valid);
    }
    __syncthreads();
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * PW + tap % 3;
      const float* wt = w_s + (tap * BN32 + tn) * kRow;
#pragma unroll
      for (int k = 0; k < KC32; ++k) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = patch_s[(pos[i] + off) * kRow + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = wt[16 * j * kRow + k];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();   // the next chunk overwrites the patch and weights
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out_s[(tm + 8 * i) * OUT_STRIDE + tn + 16 * j] = acc[i][j];
  __syncthreads();
  for (int i = threadIdx.x; i < slots * BN32; i += NTHREADS) {
    const int m = i / BN32, n = i % BN32;
    const int h = h0 + m / TW, w = w0 + m % TW, o = o0 + n;
    if (h < H && w < W && o < O) y[((size_t)h * W + w) * O + o] = out_s[m * OUT_STRIDE + n];
  }
}

// The pixel tile: TH x TW <= BM slots, the fewest blocks over the image,
// then the smallest patch.
void pick_tile(int H, int W, int* TH, int* TW) {
  long best = -1;
  int best_patch = 0;
  for (int tw = 1; tw <= (W < BM ? W : BM); ++tw) {
    const int th = BM / tw < H ? BM / tw : H;
    const long count = (long)((H + th - 1) / th) * ((W + tw - 1) / tw);
    const int patch = (th + 2) * (tw + 2);
    if (best < 0 || count < best || (count == best && patch < best_patch)) {
      best = count;
      best_patch = patch;
      *TH = th;
      *TW = tw;
    }
  }
}

cudaError_t launch_f32(const void* x, const void* wk, void* y, int B, int H, int W, int C, int O,
                       int x_aligned, cudaStream_t stream) {
  static_assert(kF32Smem <= kMaxSmemBytes, "conv3x3 tile does not fit in shared memory");
  if (B > 65535 || (O + BN32 - 1) / BN32 > 65535) return cudaErrorInvalidValue;
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  cudaError_t err = smem_opt_in_once(conv3x3_kernel_f32, (int)kF32Smem, mu, attr_set);
  if (err != cudaSuccess) return err;
  int TH = 1, TW = 1;
  pick_tile(H, W, &TH, &TW);
  const int tiles_w = (W + TW - 1) / TW;
  dim3 grid(((H + TH - 1) / TH) * tiles_w, B, (O + BN32 - 1) / BN32);
  conv3x3_kernel_f32<<<grid, NTHREADS, kF32Smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wk), static_cast<float*>(y), H, W,
      C, O, TH, TW, tiles_w, x_aligned);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, C) and y (B, H, W, O) NHWC, wk (3, 3, O, C) = (tap, out, in),
// one dtype, all contiguous.  dtype 0 = float32: wk and y 16-byte aligned,
// x_aligned says whether x is.  dtype 1 = bfloat16: x, wk and y 16-byte
// aligned and C a multiple of 8, at least 16 (TMA's limits; the wrapper
// pads).  Returns the cudaError_t of the launch (0 on success).
extern "C" int bigdl_conv3x3(const void* x, const void* wk, void* y, int B, int H, int W, int C,
                             int O, int dtype, int x_aligned, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)dispatch_bf16(x, wk, y, B, H, W, C, O, s);
  if (dtype == 0) return (int)launch_f32(x, wk, y, B, H, W, C, O, x_aligned, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory per block of the bf16 kernel at KC input channels
// a step and BN output channels a block (dtype 1), or of the f32 kernel
// (dtype 0, kc and bn ignored); 0 for what it does not take.
extern "C" int bigdl_conv3x3_smem_bytes(int kc, int bn, int dtype) {
  if (dtype == 0) return (int)kF32Smem;
  if (dtype != 1) return 0;
  return with_cfg(kc, bn, 0, [](auto cfg) { return (int)decltype(cfg)::SMEM; });
}

// How many blocks of the bf16 kernel at (kc, bn) the current device runs on
// one SM at once (2 by design), or -1.
extern "C" int bigdl_conv3x3_blocks_per_sm(int kc, int bn) {
  return with_cfg(kc, bn, -1, [](auto cfg) {
    using Cfg = decltype(cfg);
    int n = -1;
    if (wgmma_opt_in<Cfg>() != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, conv3x3_kernel_wgmma<Cfg::kChunk, Cfg::kOut>, kConvThreads, Cfg::SMEM) !=
            cudaSuccess)
      return -1;
    return n;
  });
}

// What the bf16 kernel does at x (B, H, W, C) and O output channels, C as
// the kernel takes it (a multiple of 8, at least 16): plan = (TN, TH, TW)
// of its pixel box, KC, BN.  Returns the number of boxes (two a block), or
// -1.
extern "C" int bigdl_conv3x3_plan(int B, int H, int W, int C, int O, int* plan) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0) return -1;
  plan[3] = chunk_channels(C);
  plan[4] = block_channels(O);
  return pick_box(B, H, W, plan, plan + 1, plan + 2);
}
