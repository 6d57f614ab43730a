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
// What bounds it on an H100 in bf16.  At ResNet-50's stage-1 shape (B 64,
// 56 x 56, C = O = 64) one call moves x, w and y, 51.5 MB, 15.4 us at
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
// f32 design (conv3x3_kernel_split): the same implicit GEMM, grid, boxes
// and producer, with every f32 product formed from bf16 products on the
// tensor cores (wgmma has no f32 product).  Each f32 operand a is split
// into three bf16 pieces, a1 = bf16(a), a2 = bf16(a - a1), a3 = bf16(a -
// a1 - a2), and each step adds six bf16 products, small terms first: a1 w3
// + a2 w2 + a3 w1, then a1 w2 + a2 w1, then a1 w1 (hopper_common.cuh, "f32
// products as bf16 products").  The weights are split once per call by the
// wrapper, (3, 9, O, C8) bf16 read through a 3-D map (C8, O, 27), three
// boxes a step.  The pixel boxes land in f32 through a 4-D f32 map (KC =
// 16 or 32 channels: 64- or 128-byte rows), TMA's zero fill again making
// the halo, and each consumer warpgroup reads its own box straight into
// wgmma's register operand, split there into its three pieces
// (hopper_common.cuh's split_gemm, which K9's f32 route shares), the next
// step's while a step's products run.  Shared
// memory's 128 bytes a cycle is what the design spares: a product with
// both operands in shared memory reads 128 bytes a cycle at n64 (96 at
// n128), which with the TMA writes and a split of the boxes in shared
// memory came to 1.7x the tensor cores' time at BN 64; with A in
// registers a step moves about 120 bytes a cycle of the tensor cores'
// time (the weight pieces' reads 64, the TMA writes 37, the box reads
// 21).  wgmma rounds the sums it accumulates toward zero: on an H100, six
// products a k16 step into one accumulator shrank the output by 3.3e-5 at
// K = 9 x 512 (every output, the same way).  So each step's products go to
// a fresh partial sum, added to the f32 total (round to nearest) once they
// are done.  The partial, the total and two split boxes (48 registers at
// KC 32) fit the 168-register cap of a 288-thread block alone on its SM at
// BN 64, not at BN 128, so BN is 64 at every O; the ring is 168 KB at KC
// 32 (6 stages), 112 KB at KC 16 (8).  Six products make the bound 6 x the
// bf16 one: 14.8 GFLOP at 989 / 6 TFLOP/s is 0.090 ms at every ResNet-50
// stage, so every stage is bound by operations.  The epilogue stores f32
// straight from the total, a warp writing whole 32-byte sectors.  TMA's
// limits fall on the wrapper: C a multiple of 4 and at least 16 (it
// zero-pads x), x and y 16-byte aligned.

#include "hopper_common.cuh"

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

// What a launch's blocks share at x (B, H, W, C), O output channels and KC
// channels a step: the pixel box (pick_box) and the counts over it
cudaError_t conv_shape(int B, int H, int W, int C, int O, int KC, ConvShape* sh) {
  sh->B = B;
  sh->H = H;
  sh->W = W;
  sh->O = O;
  sh->n_tiles = pick_box(B, H, W, &sh->TN, &sh->TH, &sh->TW);
  if (sh->n_tiles <= 0) return cudaErrorInvalidValue;
  sh->tiles_w = (W + sh->TW - 1) / sh->TW;
  sh->tiles_h = (H + sh->TH - 1) / sh->TH;
  sh->n_chunks = (C + KC - 1) / KC;
  return cudaSuccess;
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
  cudaError_t err = conv_shape(B, H, W, C, O, KC, &sh);
  if (err != cudaSuccess) return err;
  // encoded per launch and passed by value: a CUDA graph captures them
  CUtensorMap tm_x, tm_w;
  err = encode_bf16_4d(&tm_x, x, C, W, H, B, KC, sh.TW, sh.TH, sh.TN);
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

// ---- f32: the implicit GEMM on bf16 pieces -----------------------------------

constexpr int kSplitBlocksPerSm = 1;
constexpr int kSplitRingBytes = 196608;   // the ring of a block alone on its SM

// The ring's stages of the f32 kernel: each holds both consumers' pixel
// boxes as TMA lands them in f32 (64 rows of KC channels), and the three
// bf16 pieces of the weight box (BN rows of KC channels each), which the
// wrapper split once per call.  Its consumers are hopper_common.cuh's
// split_gemm: each reads its box into wgmma's register operand, split
// there (load_split_rows), and products() forms a step's six products a
// k16 step on the weight pieces, K-major.
template <int KC, int BN>
struct ConvSplitCfg {
  static constexpr int kChunk = KC;             // input channels a step
  static constexpr int kOut = BN;               // output channels a block
  static constexpr int kAcc = BN / 2;           // accumulator floats a thread
  static constexpr int kSteps = KC / 16;        // k16 steps of a product
  static constexpr int FRB = KC * 4;            // bytes of an f32 box row = its swizzle span
  static constexpr int RB = KC * 2;             // bytes of a bf16 piece's row = its swizzle span
  static constexpr int A_SLOT = kBoxRows * FRB; // one consumer's f32 pixel box
  static constexpr int W_PIECE = BN * RB;       // one bf16 piece of the weight box
  static constexpr int B_SLOT = 3 * W_PIECE;
  static constexpr int STAGE = 2 * A_SLOT + B_SLOT;
  static constexpr int STAGES =
      kSplitRingBytes / STAGE < 8 ? kSplitRingBytes / STAGE : 8;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + 2 * STAGES * sizeof(uint64_t);
  static_assert(KC == 16 || KC == 32, "conv3x3: f32 chunks of 16 or 32 channels");
  static_assert(STAGES >= 2, "conv3x3: the ring needs two stages");

  // a step's six products a k16 step: the box's pieces in registers by the
  // weight pieces at b (W_PIECE apart), K-major, each k16 step 32 bytes on
  __device__ static void products(float* acc, const uint32_t (&a)[3][kSteps][4],
                                  const unsigned char* b) {
    wgmma_split_products<BN, 0, RB, kSteps, W_PIECE, 32>(acc, a, b);
  }
};

// The accumulator of a consumer warpgroup (its box's 64 pixels by output
// channels o0 .. o0 + BN - 1, f32) to y: each thread stores its two rows'
// pairs of channels, 8 bytes at a time (element by element where O is
// odd), so a warp writes whole 32-byte sectors; rows past the box, pixels
// outside the image and channels at or past O are not written.
template <int BN>
__device__ __forceinline__ void store_acc_f32(const float* acc, float* __restrict__ y,
                                              const ConvShape& sh, int3 p, int o0) {
  const int box_rows = sh.TN * sh.TH * sh.TW;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const bool pairs = sh.O % 2 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + lane / 4 + 8 * h;
    const int n = p.z + r / (sh.TH * sh.TW);
    const int hh = p.y + (r / sh.TW) % sh.TH;
    const int ww = p.x + r % sh.TW;
    if (r >= box_rows || n >= sh.B || hh >= sh.H || ww >= sh.W) continue;
    float* dst = y + (((size_t)n * sh.H + hh) * sh.W + ww) * sh.O;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int o = o0 + 8 * j + 2 * (lane % 4);
      const float* e = acc + 4 * j + 2 * h;
      if (pairs) {
        if (o < sh.O) *reinterpret_cast<float2*>(dst + o) = make_float2(e[0], e[1]);
      } else {
        if (o < sh.O) dst[o] = e[0];
        if (o + 1 < sh.O) dst[o + 1] = e[1];
      }
    }
  }
}

// The f32 kernel: the bf16 kernel's grid, boxes and producer, on f32 pixel
// boxes and the weights' three bf16 pieces.  grid (ceil(n_tiles / 2),
// ceil(O / BN)): block (i, j) computes pixel boxes 2 i and 2 i + 1
// (consumer warpgroups 0 and 1) by output channels j BN .. j BN + BN - 1.
// tm_w maps the pieces as (C8, O, 27): piece p of tap t at index 9 p + t.
template <int KC, int BN>
__global__ void __launch_bounds__(kConvThreads, kSplitBlocksPerSm)
conv3x3_kernel_split(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w, float* __restrict__ y,
                     const ConvShape sh) {
  using C = ConvSplitCfg<KC, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* a_s = align1024(smem_raw);              // [consumer][stage] pixel boxes
  unsigned char* b_s = a_s + 2 * C::STAGES * C::A_SLOT;  // [stage] weight pieces
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
          (two ? 2 : 1) * sh.TN * sh.TH * sh.TW * C::FRB + (uint32_t)C::B_SLOT;
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
#pragma unroll
        for (int p = 0; p < 3; ++p)
          tma_load_3d(b_s + s * C::B_SLOT + p * C::W_PIECE, &tm_w, &full[s], c0, o0,
                      9 * p + tap);
      }
    }
  } else {
    const int wg = threadIdx.x / 128;
    const int tile = 2 * blockIdx.x + wg;
    const bool live = tile < sh.n_tiles;   // else only the barriers, in step
    unsigned char* a_wg = a_s + wg * C::STAGES * C::A_SLOT;

    // each step's products go to a fresh partial sum, added to the total
    // in f32 (round to nearest) once done: wgmma rounds its sums toward
    // zero, which over all the steps' products in one accumulator shrank
    // the output by ~3e-5 at K = 4608.  The box splits into registers
    // alternate, so that the next step's split runs beside a step's
    // products.
    float part[BN / 2], total[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) part[i] = total[i] = 0.0f;
    if (live) {
      split_gemm<C>(part, total, a_wg, b_s, full, empty, n_steps);
      store_acc_f32<BN>(total, y, sh, box_origin(sh, tile), o0);
    } else {
      split_gemm_drain<C>(full, empty, n_steps);
    }
  }
}

// KC of the f32 kernel: 16 channels at C <= 16, else 32 (64- and 128-byte
// f32 rows); its BN is 64 at every O (three accumulators of BN / 2
// registers a thread)
int split_chunk_channels(int C) { return C <= 16 ? 16 : 32; }
constexpr int kSplitOut = 64;

// f(ConvSplitCfg<KC, BN>{}) for the f32 instantiation at (kc, bn), or `none`
template <class R, class F>
R with_split_cfg(int kc, int bn, R none, F f) {
  switch (kc * 1000 + bn) {
    case 16064: return f(ConvSplitCfg<16, 64>{});
    case 32064: return f(ConvSplitCfg<32, 64>{});
  }
  return none;
}

// the once-per-device shared-memory opt-in of conv3x3_kernel_split<KC, BN>
template <class Cfg>
cudaError_t split_opt_in() {
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  return smem_opt_in_once(conv3x3_kernel_split<Cfg::kChunk, Cfg::kOut>, (int)Cfg::SMEM, mu,
                          attr_set);
}

template <class Cfg>
cudaError_t launch_split(const void* x, const void* wk, void* y, int B, int H, int W, int C,
                         int O, cudaStream_t stream) {
  constexpr int KC = Cfg::kChunk, BN = Cfg::kOut;
  static_assert(Cfg::SMEM <= kMaxSmemBytes, "conv3x3: the f32 ring does not fit");
  ConvShape sh;
  cudaError_t err = conv_shape(B, H, W, C, O, KC, &sh);
  if (err != cudaSuccess) return err;
  // x as (C, W, H, B) in f32 boxes (KC, TW, TH, TN); the pieces as (C8, O,
  // 27) in bf16 boxes (KC, BN, 1); encoded per launch, passed by value
  CUtensorMap tm_x, tm_w;
  const uint64_t x_dims[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint32_t x_box[4] = {(uint32_t)KC, (uint32_t)sh.TW, (uint32_t)sh.TH, (uint32_t)sh.TN};
  err = encode_tiled<4>(&tm_x, x, 4, x_dims, x_box);
  if (err == cudaSuccess) err = encode_bf16_3d(&tm_w, wk, (C + 7) / 8 * 8, O, 27, KC, BN);
  if (err == cudaSuccess) err = split_opt_in<Cfg>();
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.n_tiles + 1) / 2, (O + BN - 1) / BN);
  conv3x3_kernel_split<KC, BN><<<grid, kConvThreads, Cfg::SMEM, stream>>>(
      tm_x, tm_w, static_cast<float*>(y), sh);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* x, const void* wk, void* y, int B, int H, int W, int C,
                         int O, cudaStream_t stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wk) |
                        reinterpret_cast<uintptr_t>(y)) % 16 == 0;
  if (C % 4 != 0 || C < 16 || !aligned) return cudaErrorInvalidValue;
  return with_split_cfg(split_chunk_channels(C), kSplitOut,
                        (cudaError_t)cudaErrorInvalidValue, [&](auto cfg) {
                          return launch_split<decltype(cfg)>(x, wk, y, B, H, W, C, O, stream);
                        });
}

}  // namespace

// x (B, H, W, C) and y (B, H, W, O) NHWC, contiguous, 16-byte aligned.
// dtype 1 = bfloat16: wk (3, 3, O, C) = (tap, out, in), 16-byte aligned, and
// C a multiple of 8, at least 16.  dtype 0 = float32: wk the three bf16
// pieces of the f32 (tap, out, in) weights, (3, 9, O, C8) with C8 = C
// rounded up to a multiple of 8 and zeros past C, and C a multiple of 4, at
// least 16 (TMA's limits; the wrapper pads and splits).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int bigdl_conv3x3(const void* x, const void* wk, void* y, int B, int H, int W, int C,
                             int O, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)dispatch_bf16(x, wk, y, B, H, W, C, O, s);
  if (dtype == 0) return (int)dispatch_f32(x, wk, y, B, H, W, C, O, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory per block of the kernel at KC input channels a step
// and BN output channels a block, in bf16 (dtype 1) or f32 (dtype 0); 0 for
// what it does not take.
extern "C" int bigdl_conv3x3_smem_bytes(int kc, int bn, int dtype) {
  if (dtype == 0)
    return with_split_cfg(kc, bn, 0, [](auto cfg) { return (int)decltype(cfg)::SMEM; });
  if (dtype != 1) return 0;
  return with_cfg(kc, bn, 0, [](auto cfg) { return (int)decltype(cfg)::SMEM; });
}

// How many blocks of the kernel at (kc, bn) in bf16 (dtype 1: 2 by design)
// or f32 (dtype 0: 1) the current device runs on one SM at once, or -1.
extern "C" int bigdl_conv3x3_blocks_per_sm(int kc, int bn, int dtype) {
  auto occupancy = [](auto kernel, cudaError_t opt_in, int smem) {
    int n = -1;
    if (opt_in != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kConvThreads, smem) !=
            cudaSuccess)
      return -1;
    return n;
  };
  if (dtype == 0)
    return with_split_cfg(kc, bn, -1, [&](auto cfg) {
      using Cfg = decltype(cfg);
      return occupancy(conv3x3_kernel_split<Cfg::kChunk, Cfg::kOut>, split_opt_in<Cfg>(),
                       (int)Cfg::SMEM);
    });
  if (dtype != 1) return -1;
  return with_cfg(kc, bn, -1, [&](auto cfg) {
    using Cfg = decltype(cfg);
    return occupancy(conv3x3_kernel_wgmma<Cfg::kChunk, Cfg::kOut>, wgmma_opt_in<Cfg>(),
                     (int)Cfg::SMEM);
  });
}

// What the kernel does at x (B, H, W, C) and O output channels in bf16
// (dtype 1) or f32 (dtype 0), C as the kernel takes it (bf16: a multiple of
// 8, f32: of 4; at least 16): plan = (TN, TH, TW) of its pixel box, KC, BN.
// Returns the number of boxes (two a block), or -1.
extern "C" int bigdl_conv3x3_plan(int B, int H, int W, int C, int O, int dtype, int* plan) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || (dtype != 0 && dtype != 1)) return -1;
  plan[3] = dtype == 1 ? chunk_channels(C) : split_chunk_channels(C);
  plan[4] = dtype == 1 ? block_channels(O) : kSplitOut;
  return pick_box(B, H, W, plan, plan + 1, plan + 2);
}
