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
// Design: the TPU kernel's "one input slab, nine shifted windows".  One
// thread block (4 warps) owns a tile of TH x TW output pixels of one
// image (TH * TW <= 64 slots, chosen per shape on the host to waste the
// fewest slots) and 64 output channels.  For each chunk of 32 input
// channels it loads the haloed input patch, (TH + 2) x (TW + 2) pixels,
// into shared memory once, zero outside the image and past C, and the
// nine taps' weights for its 64 channels; all nine taps then read their
// shifted windows from that one patch.  Every thread computes its own
// patch row for each output slot it feeds, so a window that crosses an
// image row needs no padded "wrap" columns (the TPU kernel's flat slab
// emits 2 per row and slices them off): the halo and every ragged edge
// (H, W, C, O of any size) are masked instead.  bf16 products run on the
// tensor cores through mma.sync m16n8k16 (f32 accumulate), with each
// thread's A-fragment rows gathered from the patch by address; f32
// inputs use plain FMA, since no tensor-core product keeps full f32.
// The f32 output tile is staged in shared memory and stored row by row
// (consecutive threads, consecutive channels).
//
// What bounds it on an H100.  At ResNet-50's stage-1 shape (B 64, 56 x 56,
// C = O = 64, bf16) one call moves x, w and y, 51.5 MB, 15.4 us at
// 3.35 TB/s, against 14.8 GFLOP, 15.0 us at 989 TFLOP/s: it sits at the
// ridge; the deeper stages (C = O up to 512) are bound by operations.
// This simple design does not overlap the chunk loads with the products
// (no cp.async/TMA pipeline, no wgmma) and re-reads each weight chunk
// once per pixel tile; closing the gap to the bound is later work.

#include "tile_common.cuh"

namespace {

constexpr int BM = 64;          // output pixel slots per block
constexpr int BN = 64;          // output channels per block
constexpr int KC = 32;          // input channels per chunk
constexpr int PATCH_MAX = 200;  // (TH + 2) * (TW + 2) <= 198 when TH * TW <= 64
constexpr int OUT_STRIDE = BN + 4;

// shared-memory row stride in elements: bf16 rows of 80 bytes keep the
// 16-byte stores aligned and the fragment loads free of bank conflicts;
// f32 rows of 33 words spread one k over all banks
template <typename T>
constexpr int kRow = kIsBf16<T> ? KC + 8 : KC + 1;
template <typename T>
constexpr int kVec = 16 / sizeof(T);   // elements in one 16-byte load

template <typename T>
constexpr size_t conv_smem_bytes() {
  return sizeof(T) * (size_t)(PATCH_MAX + 9 * BN) * kRow<T> > sizeof(float) * BM * OUT_STRIDE
             ? sizeof(T) * (size_t)(PATCH_MAX + 9 * BN) * kRow<T>
             : sizeof(float) * BM * OUT_STRIDE;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Elements [c, c + kVec) of a channel chunk that has `count` channels left
// in its row (`src` points at the chunk's first channel) into dst; zero
// past `count` and when !valid.  `vec` allows one 16-byte load (the row
// length is a multiple of kVec and the base is aligned).
template <typename T>
__device__ __forceinline__ void load_vec(T* dst, const T* src, int c, int count, bool vec,
                                         bool valid) {
  constexpr int V = kVec<T>;
  if (valid && vec && c < count) {
    const uint4 val = *reinterpret_cast<const uint4*>(src + c);
    if constexpr (kIsBf16<T>) {
      *reinterpret_cast<uint4*>(dst) = val;
    } else {
      const float* f = reinterpret_cast<const float*>(&val);
      for (int j = 0; j < V; ++j) dst[j] = f[j];
    }
  } else {
    for (int j = 0; j < V; ++j) dst[j] = (valid && c + j < count) ? src[c + j] : from_f32<T>(0.0f);
  }
}

// The patch position of output slot m at tap (0, 0); slots past TH * TW
// read position 0 and are never stored.
__device__ __forceinline__ int slot_pos(int m, int slots, int TW, int PW) {
  return m < slots ? (m / TW) * PW + m % TW : 0;
}

template <typename T>
struct Tile;

// bf16: warp (wm, wn) owns slots [32 wm, 32 wm + 32) and channels
// [32 wn, 32 wn + 32): two m16 by four n8 mma.sync tiles.
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int R = kRow<__nv_bfloat16>;
  int pos[2][2];
  float acc[2][4][4];
  int wm, wn, g, t4;

  __device__ void init(int slots, int TW, int PW) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    wm = warp >> 1;
    wn = warp & 1;
    g = lane >> 2;
    t4 = lane & 3;
    #pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      #pragma unroll
      for (int h = 0; h < 2; ++h) pos[mi][h] = slot_pos(wm * 32 + mi * 16 + h * 8 + g, slots, TW, PW);
    #pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      #pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        #pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
  }

  __device__ void compute(const __nv_bfloat16* patch_s, const __nv_bfloat16* w_s, int PW) {
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * PW + tap % 3;
      #pragma unroll
      for (int k0 = 0; k0 < KC; k0 += 16) {
        uint32_t a[2][4], b[4][2];
        #pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          // rows g and g + 8 of the m16 tile, k pairs 2 t4 and 2 t4 + 8
          const __nv_bfloat16* r0 = patch_s + (pos[mi][0] + off) * R + k0 + 2 * t4;
          const __nv_bfloat16* r1 = patch_s + (pos[mi][1] + off) * R + k0 + 2 * t4;
          a[mi][0] = ld32(r0);
          a[mi][1] = ld32(r1);
          a[mi][2] = ld32(r0 + 8);
          a[mi][3] = ld32(r1 + 8);
        }
        #pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          // column g of the n8 tile: weights are (tap, n, k), k contiguous
          const __nv_bfloat16* col = w_s + (tap * BN + wn * 32 + ni * 8 + g) * R + k0 + 2 * t4;
          b[ni][0] = ld32(col);
          b[ni][1] = ld32(col + 8);
        }
        #pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          #pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            float* d = acc[mi][ni];
            asm volatile(
                "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                : "r"(a[mi][0]), "r"(a[mi][1]), "r"(a[mi][2]), "r"(a[mi][3]), "r"(b[ni][0]),
                  "r"(b[ni][1]));
          }
      }
    }
  }

  __device__ void store(float* out_s) const {
    #pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      #pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int row = wm * 32 + mi * 16 + g;
        const int col = wn * 32 + ni * 8 + 2 * t4;
        out_s[row * OUT_STRIDE + col] = acc[mi][ni][0];
        out_s[row * OUT_STRIDE + col + 1] = acc[mi][ni][1];
        out_s[(row + 8) * OUT_STRIDE + col] = acc[mi][ni][2];
        out_s[(row + 8) * OUT_STRIDE + col + 1] = acc[mi][ni][3];
      }
  }
};

// f32: thread (tm, tn) owns slots tm + 8 i (i < 8) and channels tn + 16 j
// (j < 4), FMA.
template <>
struct Tile<float> {
  static constexpr int R = kRow<float>;
  int pos[8];
  float acc[8][4];
  int tm, tn;

  __device__ void init(int slots, int TW, int PW) {
    tn = threadIdx.x & 15;
    tm = threadIdx.x >> 4;
    #pragma unroll
    for (int i = 0; i < 8; ++i) {
      pos[i] = slot_pos(tm + 8 * i, slots, TW, PW);
      #pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    }
  }

  __device__ void compute(const float* patch_s, const float* w_s, int PW) {
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * PW + tap % 3;
      const float* wt = w_s + (tap * BN + tn) * R;
      #pragma unroll
      for (int k = 0; k < KC; ++k) {
        float a[8], b[4];
        #pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = patch_s[(pos[i] + off) * R + k];
        #pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = wt[16 * j * R + k];
        #pragma unroll
        for (int i = 0; i < 8; ++i)
          #pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  __device__ void store(float* out_s) const {
    #pragma unroll
    for (int i = 0; i < 8; ++i)
      #pragma unroll
      for (int j = 0; j < 4; ++j) out_s[(tm + 8 * i) * OUT_STRIDE + tn + 16 * j] = acc[i][j];
  }
};

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ wk, T* __restrict__ y, int H,
               int W, int C, int O, int TH, int TW, int tiles_w, int x_aligned) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int R = kRow<T>;
  constexpr int V = kVec<T>;
  constexpr int VPR = KC / V;   // 16-byte vectors per patch or weight row
  T* patch_s = reinterpret_cast<T*>(smem);
  T* w_s = patch_s + PATCH_MAX * R;
  float* out_s = reinterpret_cast<float*>(smem);   // reused after the last chunk

  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int o0 = blockIdx.z * BN;
  const int PW = TW + 2;
  const int npos = (TH + 2) * PW;
  const int slots = TH * TW;
  const bool vec_x = x_aligned && C % V == 0;
  const bool vec_w = C % V == 0;
  x += (size_t)blockIdx.y * H * W * C;
  y += (size_t)blockIdx.y * H * W * O;

  Tile<T> tile;
  tile.init(slots, TW, PW);
  for (int c0 = 0; c0 < C; c0 += KC) {
    // the haloed patch: image rows h0 - 1 .. h0 + TH, columns w0 - 1 .. w0 + TW
    for (int i = threadIdx.x; i < npos * VPR; i += NTHREADS) {
      const int p = i / VPR, v = i % VPR;
      const int h = h0 + p / PW - 1, w = w0 + p % PW - 1;
      const bool inside = h >= 0 && h < H && w >= 0 && w < W;
      const T* src = x + ((size_t)(inside ? h : 0) * W + (inside ? w : 0)) * C + c0;
      load_vec<T>(patch_s + p * R + v * V, src, v * V, C - c0, vec_x, inside);
    }
    // the nine taps' weights for output channels o0 .. o0 + BN
    for (int i = threadIdx.x; i < 9 * BN * VPR; i += NTHREADS) {
      const int row = i / VPR, v = i % VPR;   // row = tap * BN + n
      const int o = o0 + row % BN;
      const bool valid = o < O;
      const T* src = wk + ((size_t)(row / BN) * O + (valid ? o : 0)) * C + c0;
      load_vec<T>(w_s + row * R + v * V, src, v * V, C - c0, vec_w, valid);
    }
    __syncthreads();
    tile.compute(patch_s, w_s, PW);
    __syncthreads();   // the next chunk overwrites the patch and weights
  }
  tile.store(out_s);
  __syncthreads();
  for (int i = threadIdx.x; i < slots * BN; i += NTHREADS) {
    const int m = i / BN, n = i % BN;
    const int h = h0 + m / TW, w = w0 + m % TW, o = o0 + n;
    if (h < H && w < W && o < O)
      y[((size_t)h * W + w) * O + o] = from_f32<T>(out_s[m * OUT_STRIDE + n]);
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

template <typename T>
cudaError_t launch(const void* x, const void* wk, void* y, int B, int H, int W, int C, int O,
                   int x_aligned, cudaStream_t stream) {
  constexpr size_t smem = conv_smem_bytes<T>();
  static_assert(smem <= kMaxSmemBytes, "conv3x3 tile does not fit in shared memory");
  auto kernel = conv3x3_kernel<T>;
  static std::mutex mu;
  static bool attr_set[kMaxDevices] = {};
  cudaError_t err = smem_opt_in_once(kernel, (int)smem, mu, attr_set);
  if (err != cudaSuccess) return err;
  int TH = 1, TW = 1;
  pick_tile(H, W, &TH, &TW);
  const int tiles_w = (W + TW - 1) / TW;
  dim3 grid(((H + TH - 1) / TH) * tiles_w, B, (O + BN - 1) / BN);
  kernel<<<grid, NTHREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(wk),
                                           static_cast<T*>(y), H, W, C, O, TH, TW, tiles_w,
                                           x_aligned);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, C) and y (B, H, W, O) NHWC, wk (3, 3, O, C) = (tap, out, in),
// one dtype, all contiguous; wk and y 16-byte aligned, x_aligned says
// whether x is.  dtype: 0 = float32, 1 = bfloat16.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int bigdl_conv3x3(const void* x, const void* wk, void* y, int B, int H, int W, int C,
                             int O, int dtype, int x_aligned, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0 || B > 65535 || (O + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, wk, y, B, H, W, C, O, x_aligned, s);
  if (dtype == 0) return (int)launch<float>(x, wk, y, B, H, W, C, O, x_aligned, s);
  return (int)cudaErrorInvalidValue;
}
