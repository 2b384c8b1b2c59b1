// The FIR resampler upfirdn2d on NCHW planes, forward and gradient, in
// float32, float64, bfloat16 and float16.
//
// Replaces no TPU kernel: the JAX package wrote this FIR in XLA
// (gangealing_tpu/ops/resample.py::upfirdn2d), and the port first ran it as
// F.pad, then a depthwise F.conv2d (ATen's conv_depthwise2d), which wrote a
// padded copy of every input, kept it for the backward and reached about
// 13% of the card's memory bandwidth. It was added because a profile of
// every benchmark cell named that conv among the top device ops: the
// STN encoders' Blur before each stride-2 conv, G's blur after each
// transposed conv and ToRGB's 2x upsample all run through it.
//
// out[n, c, oy, ox] = sum_{i, j} w[i][j] xup[oy * down + i - py0,
//                                            ox * down + j - px0]
// where w are the correlation taps (the FIR's 2-D taps flipped, gain
// included: the plain version's conv weight) and xup is x with up - 1
// zeros after each sample on each axis; a position outside xup reads zero,
// so a positive pad pads with zeros and a negative one crops. The gradient
// of this function is the same function with the taps flipped, up and
// down swapped and the complementary pads (ops/resample.py::grad_pads), so
// one kernel serves both.
//
// Each output is summed as ATen's depthwise conv sums it: one fused
// multiply-add a tap, row by row of the conv's weight, in its order (the
// forward's taps ascending; a gradient's descending, as ATen's backward
// walks the forward's weight). A tap on a zero (padding, an inserted
// zero) adds nothing to such a sum, so skipping it changes no bit: in
// float32 the kernel gives the plain version's bits, forward and backward,
// and a training step's numbers stay those of the plain version (its
// gradient through TF32 convs amplifies any other rounding of the FIR).
//
// Each element type is loaded and stored as it is and summed in the type
// ATen's depthwise conv accumulates it in: float for float32, bfloat16 and
// float16, double for float64. A 16-bit output is rounded once, from the
// float sum; ATen may run a 16-bit depthwise conv through cuDNN, whose sum
// differs in order, so there the two agree to a unit in the last place.
//
// What bounds it: memory. Each input element is read from device memory
// once (the halo rows a neighbouring work item reads again come from L2)
// and each output element is written once, with a few operations a byte.
// Its time is the latency of those reads (chip_fir_variants.py). What the
// design does about that:
// - implicit padding: no padded or zero-inserted copy is made; a thread's
//   taps that fall outside the plane, or on an inserted zero, are dropped
//   before the loop (polyphase: at up = 2 each output uses the 2 x 2 taps
//   of the 4 x 4 that hit samples);
// - a work item is a tile of output rows and columns of one plane, one
//   thread an output column. The item's threads first copy its input tile
//   (the rows and columns its taps reach) to shared memory, each load at a
//   clamped address with the padding selected in after it, so that no
//   branch stands between the loads of kRowsInFlight steps and they are in
//   flight together; a warp's loads fall on consecutive addresses. Then
//   each thread walks down its column with the taps' window of the tile in
//   registers, reading one new tile row of it an output row;
// - tiling from the plane's size: an item is at most kMaxTileW columns
//   (wider rows are cut into equal tiles) and kMaxTileH rows (a quarter at
//   down = 2); a block holds as many items as kThreads threads take, so
//   the 8 x 8 planes of the encoders' last levels fill a block with 28
//   planes where one plane a block would leave most threads idle;
// - the taps are launch arguments: no tap tensor is read.
//
// Filters of up to kTaps taps a side (smaller ones padded with zero taps
// after theirs); up and down in {(1, 1), (2, 1), (1, 2)}: the forwards and
// their gradients.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 4;
constexpr int kThreads = 256;
constexpr int kMaxTileW = 64;
constexpr int kMaxTileH = 32;
constexpr int kRowsInFlight = 8;  // tile rows whose loads are in flight

// An element type's accumulation type, its loads, stores and fused
// multiply-add.
template <typename T>
struct Acc {
  using type = float;
};
template <>
struct Acc<double> {
  using type = double;
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ double load(const double* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(__half* p, float v) {
  *p = __float2half_rn(v);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

struct Taps {
  float w[kTaps][kTaps];  // correlation taps, zero beyond the filter
};

struct Geometry {
  int H, W, OH, OW;          // input and output planes
  int px0, py0;              // leading pads; negative crops
  int tile_w, tile_h;        // output columns and rows of a work item
  int tiles_x, tiles_y;      // work items across and down a plane
  int tile_rows, tile_cols;  // an item's input tile, the most
  long long items;           // planes * tiles_y * tiles_x
};

// floor(v / 2) for either sign
__device__ __forceinline__ int floor_half(int v) {
  return v >= 0 ? v / 2 : -((1 - v) / 2);
}

// For an output whose first tap lies at upsampled position ``a`` on an
// axis: the first sample its taps hit, and whether those are the odd taps
// (up = 2: taps 1 and 3 of 4 hit samples, else 0 and 2; up = 1: all).
template <int UP>
__device__ __forceinline__ int first_hit(int a, bool& odd) {
  odd = UP == 2 && (a & 1);
  return UP == 2 ? floor_half(a + (odd ? 1 : 0)) : a;
}

// Moves the window one row down: its rows up one, ``next`` (the row below
// it, at the window's first column) in as its last.
template <int K, typename A>
__device__ __forceinline__ void shift_window(A (&win)[K][K], const A* next) {
#pragma unroll
  for (int m = 0; m < K - 1; ++m)
#pragma unroll
    for (int n = 0; n < K; ++n) win[m][n] = win[m + 1][n];
#pragma unroll
  for (int n = 0; n < K; ++n) win[K - 1][n] = next[n];
}

template <typename T, int UP, int DOWN, bool REVERSE>
__global__ void __launch_bounds__(kThreads)
    upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y, Taps taps,
                     Geometry g) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char shared[];
  A* tiles = reinterpret_cast<A*>(shared);  // [item][tile_rows][tile_cols]
  constexpr int kHit = kTaps / UP;
  const int lane = threadIdx.x % g.tile_w;
  const int slot = threadIdx.x / g.tile_w;
  const long long item =
      (long long)blockIdx.x * (blockDim.x / g.tile_w) + slot;
  const bool live = item < g.items;
  const int tx = live ? (int)(item % g.tiles_x) : 0;
  const int ty = live ? (int)(item / g.tiles_x % g.tiles_y) : 0;
  const long long plane = live ? item / g.tiles_x / g.tiles_y : 0;
  const int ox0 = tx * g.tile_w;
  const int oy0 = ty * g.tile_h;
  const int rows = min(g.tile_h, g.OH - oy0);
  const int cols = min(g.tile_w, g.OW - ox0);
  bool odd;
  // the item's input tile: the rows and columns its outputs' taps reach
  const int u0 = first_hit<UP>(oy0 * DOWN - g.py0, odd);
  const int u1 =
      first_hit<UP>((oy0 + rows - 1) * DOWN - g.py0, odd) + kHit - 1;
  const int c0 = first_hit<UP>(ox0 * DOWN - g.px0, odd);
  const int c1 =
      first_hit<UP>((ox0 + cols - 1) * DOWN - g.px0, odd) + kHit - 1;
  A* t = tiles + (size_t)slot * g.tile_rows * g.tile_cols;

  if (live && rows > 0 && cols > 0) {
    const int nrows = u1 - u0 + 1, ncols = c1 - c0 + 1;
    const T* xp = x + (size_t)plane * g.H * g.W;
    // a row in kSteps loads a thread: all its columns once the tile is at
    // least 4 wide
    constexpr int kSteps = UP == 1 ? DOWN + 1 : 1;
#pragma unroll kRowsInFlight
    for (int r = 0; r < nrows; ++r) {
      const int u = u0 + r, uc = min(max(u, 0), g.H - 1);
      const T* row = xp + (size_t)uc * g.W;
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        const int c = lane + k * g.tile_w, v = c0 + c;
        const int vc = min(max(v, 0), g.W - 1);
        const A val = load(row + vc);
        if (c < ncols)
          t[r * g.tile_cols + c] = u == uc && v == vc ? val : A(0);
      }
    }
    // the columns a tile under 4 wide leaves
    const int rest = ncols - kSteps * g.tile_w;
    for (int i = lane; i < nrows * rest; i += g.tile_w) {
      const int r = i / rest, c = kSteps * g.tile_w + i - r * rest;
      const int u = u0 + r, v = c0 + c;
      const int uc = min(max(u, 0), g.H - 1), vc = min(max(v, 0), g.W - 1);
      const A val = load(xp + (size_t)uc * g.W + vc);
      t[r * g.tile_cols + c] = u == uc && v == vc ? val : A(0);
    }
  }
  __syncthreads();
  if (!live || lane >= cols || rows <= 0) return;

  bool odd_x;
  const int sx = first_hit<UP>((ox0 + lane) * DOWN - g.px0, odd_x) - c0;

  // the window: tile rows lo .. lo + kHit - 1 at this column's taps
  A win[kHit][kHit];
  bool odd_y;
  int lo = first_hit<UP>(oy0 * DOWN - g.py0, odd_y) - u0;
  const int last = u1 - u0;  // the tile's last row
#pragma unroll
  for (int m = 0; m < kHit; ++m)
#pragma unroll
    for (int n = 0; n < kHit; ++n)
      win[m][n] = t[(lo + m) * g.tile_cols + sx + n];
  T* yp = y + (size_t)plane * g.OH * g.OW + ox0 + lane;
  // at up = 1 the window moves down DOWN rows an output row, and the loop
  // unrolled kTaps times renames the window's registers in place of moving
  // them; at up = 2 it moves 0 or 1 rows, by the output row's phase
#pragma unroll kTaps
  for (int r = 0; r < rows; ++r) {
    if (UP == 2) {
      const int first = first_hit<UP>((oy0 + r) * DOWN - g.py0, odd_y) - u0;
      if (lo < first) {
        shift_window<kHit>(win, t + min(lo + kHit, last) * g.tile_cols + sx);
        ++lo;
      }
    }
    A v = 0;
#pragma unroll
    for (int mm = 0; mm < kHit; ++mm) {
      const int m = REVERSE ? kHit - 1 - mm : mm;
#pragma unroll
      for (int nn = 0; nn < kHit; ++nn) {
        const int n = REVERSE ? kHit - 1 - nn : nn;
        // the tap that weighs win[m][n], read from the launch arguments
        const A tap =
            UP == 1 ? taps.w[m][n]
                    : (odd_y ? (odd_x ? taps.w[UP * m + 1][UP * n + 1]
                                      : taps.w[UP * m + 1][UP * n])
                             : (odd_x ? taps.w[UP * m][UP * n + 1]
                                      : taps.w[UP * m][UP * n]));
        v = fma_rn(tap, win[m][n], v);
      }
    }
    store(yp + (size_t)(oy0 + r) * g.OW, v);
    if (UP == 1) {
#pragma unroll
      for (int s = 0; s < DOWN; ++s) {
        // past the tile's end the row read is a valid one, never used
        shift_window<kHit>(win, t + min(lo + kHit, last) * g.tile_cols + sx);
        ++lo;
      }
    }
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, int UP, int DOWN, bool REVERSE>
cudaError_t launch(const T* x, T* y, int planes, int H, int W, int OH, int OW,
                   int px0, int py0, const Taps& taps, cudaStream_t stream) {
  Geometry g;
  g.H = H, g.W = W, g.OH = OH, g.OW = OW, g.px0 = px0, g.py0 = py0;
  g.tiles_x = ceil_div(OW, kMaxTileW);
  g.tile_w = ceil_div(OW, g.tiles_x);
  g.tiles_y = ceil_div(OH, kMaxTileH / (DOWN * DOWN));
  g.tile_h = ceil_div(OH, g.tiles_y);
  g.tile_rows = ((g.tile_h - 1) * DOWN + kTaps - 1) / UP + 1;
  g.tile_cols = ((g.tile_w - 1) * DOWN + kTaps - 1) / UP + 1;
  g.items = (long long)planes * g.tiles_y * g.tiles_x;
  const int per_block = kThreads / g.tile_w;
  const long long blocks = (g.items + per_block - 1) / per_block;
  const size_t shared = sizeof(typename Acc<T>::type) * per_block *
                        g.tile_rows * g.tile_cols;
  const auto kernel = upfirdn2d_kernel<T, UP, DOWN, REVERSE>;
  // float64 tiles pass the 48 KiB a block gets unless it asks for more
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)blocks, per_block * g.tile_w, shared, stream>>>(x, y,
                                                                    taps, g);
  return cudaGetLastError();
}

template <typename T, bool REVERSE>
cudaError_t dispatch(const void* xv, void* yv, int planes, int H, int W,
                     int OH, int OW, int up, int down, int px0, int py0,
                     const Taps& taps, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  T* y = static_cast<T*>(yv);
  if (up == 1 && down == 1)
    return launch<T, 1, 1, REVERSE>(x, y, planes, H, W, OH, OW, px0, py0,
                                    taps, s);
  if (up == 2 && down == 1)
    return launch<T, 2, 1, REVERSE>(x, y, planes, H, W, OH, OW, px0, py0,
                                    taps, s);
  if (up == 1 && down == 2)
    return launch<T, 1, 2, REVERSE>(x, y, planes, H, W, OH, OW, px0, py0,
                                    taps, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_order(const void* x, void* y, int planes, int H, int W,
                           int OH, int OW, int up, int down, int px0, int py0,
                           const Taps& taps, bool reverse, cudaStream_t s) {
  return reverse ? dispatch<T, true>(x, y, planes, H, W, OH, OW, up, down,
                                     px0, py0, taps, s)
                 : dispatch<T, false>(x, y, planes, H, W, OH, OW, up, down,
                                      px0, py0, taps, s);
}

}  // namespace

// x (planes, H, W) and y (planes, OH, OW), contiguous, of the element type
// ``dtype`` (0 float32, 1 float64, 2 bfloat16, 3 float16); taps the
// kTaps x kTaps correlation taps, row-major, on the host, zero beyond the
// filter; px0, py0 the leading pads; reverse: sum the taps in descending
// order (a gradient's). The caller sizes the output. Returns a
// cudaError_t, 0 on success.
extern "C" int gg_upfirdn2d(const void* x, void* y, int dtype, int planes,
                            int H, int W, int OH, int OW, int up, int down,
                            int px0, int py0, const float* taps, int reverse,
                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (planes == 0 || OH <= 0 || OW <= 0) return (int)cudaSuccess;
  Taps t;
  for (int i = 0; i < kTaps; ++i)
    for (int j = 0; j < kTaps; ++j) t.w[i][j] = taps[i * kTaps + j];
  const cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return (int)dispatch_order<float>(x, y, planes, H, W, OH, OW, up, down,
                                        px0, py0, t, reverse, s);
    case 1:
      return (int)dispatch_order<double>(x, y, planes, H, W, OH, OW, up, down,
                                         px0, py0, t, reverse, s);
    case 2:
      return (int)dispatch_order<__nv_bfloat16>(x, y, planes, H, W, OH, OW,
                                                up, down, px0, py0, t,
                                                reverse, s);
    case 3:
      return (int)dispatch_order<__half>(x, y, planes, H, W, OH, OW, up, down,
                                         px0, py0, t, reverse, s);
  }
  return (int)cudaErrorInvalidValue;
}
