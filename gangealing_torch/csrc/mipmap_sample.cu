// K1: mipmap (anti-aliased) sample, forward, from a native-resolution
// Gaussian pyramid.
//
// Replaces the TPU kernel gangealing_tpu/ops/pallas_mipmap.py::_fwd_kernel
// (launched by _mt_sample_core through mipmap_sample). That kernel samples a
// coarse-height band stack with four composed row tents per point as MXU
// matmuls. The function is that of ops/mipmap.py::_mipmap_warp_fold: a
// bilinear sample of each full-resolution Gaussian level, lerped between
// the floor and ceil of the point's level. The full-resolution levels are
// never stored. The pyramid (ops/mipmap.py::_build_pyramid) keeps level d
// at its native (S/2^d, S/2^d), S the size reflect-padded to a power of 2:
// level 0 is the padded input, (N, C, S, S); levels 1.. are packed per
// image as [level][row][column][channel], the channels zero-padded to whole
// float4 groups, so that one 16-byte load brings a texel's three colours.
// A full-resolution corner that a point's bilinear tap reads on a level
// d >= 1 is what interpolate_bilinear gives it from 2x2 coarse texels:
// rows first, then columns, source index (i + 0.5) * 2^-d - 0.5 clipped to
// [0, S/2^d - 1], the upper index clamped. The four corners of a tap are
// two adjacent rows and columns, so on a coarse level they reach at most
// 3x3 texels: each point loads that window once per float4 group and
// level. K1 folds the rebuild and the tap into one 3x3 filter on the
// window, which it sums with fused multiply-adds, within a few units in
// the last place of the plain version. Level 0 is a bilinear tap as in
// bilinear.cuh.
//
// A block is a 32 x 4 tile of output points: neighbouring points' windows
// overlap heavily on a coarse level, so a tile's loads fall in a compact
// window of each level and are served from L1 after the first.
//
// What bounds it on an H100: bytes, by the count of what a run must read
// (the distinct texels its taps reach, on the main path mostly level 0's:
// 256^2 against 128^2 and smaller coarse levels). What holds it back from
// that bound is the per-point arithmetic (the tap, the rebuild's weights
// on two levels, two 3x3 filters), which takes about half its time with
// every pyramid load replaced by a constant, and the latency of the
// gathers on top of it (chip_mipmap_variants.py; PERF.md). More blocks an
// SM, skipping the window's third row and column where no corner reads
// them, and unpadded 12-byte texels were each slower. Tensor cores and TMA
// do not apply: the work is a gather at data-dependent addresses with a
// few multiply-adds a texel, and a TMA tile would have to cover the
// bounding box of the tile's taps, which a rotated or zoomed-out grid
// makes far larger than the taps. Against the full-resolution stack this
// design reads no upsampled level and the warp builds none.
//
// K3: d/dgrid and d/dlevels, backward, from the same pyramid. Replaces
// pallas_mipmap.py::_dcoords_kernel, which returns d/dx and d/d(tent
// amplitudes) of the band form and leaves JAX to chain them to the grid and
// the levels through _band_tent_coords. Same tiles and window; one pass per
// level whose tent or tent slope is not 0 at the point's level. It rebuilds
// each corner as the plain version does, in its order; the library is
// built with -fmad=false, so each rebuilt corner equals the plain
// version's bit for bit and the tap arithmetic of bilinear.cuh carries
// over unchanged. Each corner, loaded once, feeds the value (d/dlevels)
// and both slopes (d/dgrid). The gradient is jax.grad's of the fold path, ties
// included: the right derivative at an integer coordinate, half the
// gradient on a clamp bound, and the level tent max(0, 1 - |level - d|)
// differentiated with |t|' = 1 at 0 and half at the kink where the tent
// meets 0. So at an integer level f the derivative reads levels f - 1 and
// f + 1 as well, which the forward does not read, and just below an
// integer level f + 1 the level f + 2, where lv - (f + 2) rounds to -1.
//
// K5a: d/dpyramid, backward. Replaces pallas_mipmap.py::_dimg_kernel, a
// deterministic wy^T matmul accumulated over point blocks. Here it is the
// exact adjoint of K1 on the pyramid, written in the pyramid's own layout
// (d/dlevel0 (N, C, S, S), d/dcoarse packed as the coarse levels, padding
// channels 0) as a binned gather with no atomics and no memset, the same
// to the bit from run to run, in three kernels (binned.cuh):
//  1. bin: a point has an entry on each of its two levels whose tent
//     max(0, 1 - |level - d|) is not 0 (none if its four tap weights are
//     0), keyed by the tile of its footprint's top-left texel on that
//     level: the 2x2 tap on level 0, on a coarse level the 3x3 window of
//     its rebuilt corners. Every level of the pyramid is cut into 16 x 4
//     tiles, numbered level by level.
//  2. gather: a warp an item of up to kSlots candidates of one tile, as
//     K5b's: it sorts them stably by their footprint's top-left texel and
//     stores each at its sorted place with the weight it puts on each of
//     the 3 x 3 texels from there (level 0: the tap's corner weights; a
//     coarse level: K1's filter, tap_filter, each entry of the window that
//     the rebuild clamps onto the edge texel summed there in window order;
//     both times the level tent). Each lane sums its texels over the runs
//     that can reach them in a fixed order, a float4 group of channels a
//     pass, and writes every texel of the tile, zero where nothing lands.
//  3. merge: adds a split tile's later items to its first, in item order.
// What bounds it: the bytes (grid, levels and dout read once, the
// pyramid's gradient written once) would take 8 us at the train check's
// shapes; like K5b, it is held back by three launches and each kernel's
// chain of dependent loads, groupings and scans. The autograd Function
// launches it only when the image needs a gradient; in the GANgealing step
// both warps sample G's output, which carries none.

#include <cuda_runtime.h>

#include <cstdint>

#include "bilinear.cuh"
#include "binned.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kTileX = 32;
constexpr int kTileY = 4;

// Where the levels of a pyramid lie. level0: (N, C, S, S), the input
// reflect-padded to S. coarse: per image, levels 1.. at off[d] (floats),
// each [row][column][G float4 groups of channels], the channels padded
// with zeros to 4 G. H, W: the sampled (cropped) image; lp: the crop's
// offset into the padded levels.
struct Pyramid {
  const float* level0;
  const float* coarse;
  int64_t level0_stride, coarse_stride;
  int64_t off[kMaxLevels];
  int size[kMaxLevels];
  float scale[kMaxLevels];
  int D, C, G, S, H, W, lp;
};

// One axis of the rebuild of full-resolution index i on a level of side
// hc at `scale` (hc / full): interpolate_bilinear's source index
// (_resize_axis_weights) and its lerp weights.
struct Axis {
  int r0;
  float w0, w1;
};

__device__ __forceinline__ Axis resize_axis(int i, int hc, float scale) {
  float src = ((float)i + 0.5f) * scale - 0.5f;
  src = fminf(fmaxf(src, 0.f), (float)(hc - 1));
  Axis a;
  const float f = floorf(src);
  a.r0 = (int)f;
  a.w1 = src - f;
  a.w0 = 1.f - a.w1;
  return a;
}

// The rebuild of a point's four corners on one coarse level: the 3x3
// window of texels the corners reach (texel indices row[a] + col[b]), the
// lerp weights of the corner rows Y0, Y1 and columns X0, X1, and where the
// second row's and column's r0 sits in the window (ky, kx: 0 or 1). The
// first row's r0 is window row 0; each r1 is the window entry after its
// r0, clamped as the window is.
struct Rebuild {
  int row[3], col[3];
  Axis y0, y1, x0, x1;
  int ky, kx;
};

__device__ __forceinline__ Rebuild make_rebuild(int Y0, int Y1, int X0, int X1,
                                                int hc, float scale) {
  Rebuild r;
  r.y0 = resize_axis(Y0, hc, scale);
  r.y1 = resize_axis(Y1, hc, scale);
  r.x0 = resize_axis(X0, hc, scale);
  r.x1 = resize_axis(X1, hc, scale);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.row[k] = min(r.y0.r0 + k, hc - 1) * hc;
    r.col[k] = min(r.x0.r0 + k, hc - 1);
  }
  // Y1 is Y0 or Y0 + 1, so its r0 is r0(Y0) or the next
  r.ky = r.y1.r0 - r.y0.r0;
  r.kx = r.x1.r0 - r.x0.r0;
  return r;
}

// The 3x3 window of float4 group g of a coarse level (texels of G groups).
__device__ __forceinline__ void load_window(const float* __restrict__ level,
                                            const Rebuild& r, int G, int g,
                                            float4 win[3][3]) {
  const float4* l4 = reinterpret_cast<const float4*>(level);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) win[a][b] = __ldg(l4 + (r.row[a] + r.col[b]) * G + g);
  }
}

__device__ __forceinline__ float4 lerp4(float4 a, float wa, float4 b,
                                        float wb) {
  return make_float4(a.x * wa + b.x * wb, a.y * wa + b.y * wb,
                     a.z * wa + b.z * wb, a.w * wa + b.w * wb);
}

__device__ __forceinline__ float4 pick4(int k, float4 a, float4 b) {
  return k ? b : a;
}

// The four rebuilt corners of a window, in the tap order (x0,y0) (x1,y0)
// (x0,y1) (x1,y1), each as interpolate_bilinear forms it, rows first:
// (L[r0][c0] w_y0 + L[r1][c0] w_y1) w_x0 + (L[r0][c1] w_y0 + L[r1][c1] w_y1) w_x1.
// Built with -fmad=false, each equals the plain version's bit for bit.
__device__ __forceinline__ void rebuild_corners(const float4 win[3][3],
                                                const Rebuild& r,
                                                float4 v[4]) {
  float4 ra[3], rb[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    ra[j] = lerp4(win[0][j], r.y0.w0, win[1][j], r.y0.w1);
    rb[j] = lerp4(pick4(r.ky, win[0][j], win[1][j]), r.y1.w0,
                  pick4(r.ky, win[1][j], win[2][j]), r.y1.w1);
  }
  v[0] = lerp4(ra[0], r.x0.w0, ra[1], r.x0.w1);
  v[1] = lerp4(pick4(r.kx, ra[0], ra[1]), r.x1.w0, pick4(r.kx, ra[1], ra[2]),
               r.x1.w1);
  v[2] = lerp4(rb[0], r.x0.w0, rb[1], r.x0.w1);
  v[3] = lerp4(pick4(r.kx, rb[0], rb[1]), r.x1.w0, pick4(r.kx, rb[1], rb[2]),
               r.x1.w1);
}

// The tap of weights w over the four rebuilt corners as one 3x3 filter on
// the window: row weights ry0 of the corner row Y0 and ry1 of Y1, column
// weights rx0, rx1 likewise, A = ry0 (w0 rx0 + w1 rx1) + ry1 (w2 rx0 + w3 rx1).
// Summed with fused multiply-adds in another order than the plain version,
// so it agrees with it to a few units in the last place, not bit for bit.
__device__ __forceinline__ void tap_filter(const Rebuild& r, const float w[4],
                                           float A[3][3]) {
  const float ry0[3] = {r.y0.w0, r.y0.w1, 0.f};
  const float ry1[3] = {r.ky ? 0.f : r.y1.w0, r.ky ? r.y1.w0 : r.y1.w1,
                        r.ky ? r.y1.w1 : 0.f};
  const float rx0[3] = {r.x0.w0, r.x0.w1, 0.f};
  const float rx1[3] = {r.kx ? 0.f : r.x1.w0, r.kx ? r.x1.w0 : r.x1.w1,
                        r.kx ? r.x1.w1 : 0.f};
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const float b0 = __fmaf_rn(w[1], rx1[b], w[0] * rx0[b]);
    const float b1 = __fmaf_rn(w[3], rx1[b], w[2] * rx0[b]);
#pragma unroll
    for (int a = 0; a < 3; ++a) A[a][b] = __fmaf_rn(ry1[a], b1, ry0[a] * b0);
  }
}

__device__ __forceinline__ float4 filter_window(const float4 win[3][3],
                                                const float A[3][3]) {
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      t.x = __fmaf_rn(A[a][b], win[a][b].x, t.x);
      t.y = __fmaf_rn(A[a][b], win[a][b].y, t.y);
      t.z = __fmaf_rn(A[a][b], win[a][b].z, t.z);
      t.w = __fmaf_rn(A[a][b], win[a][b].w, t.w);
    }
  }
  return t;
}

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// A point's taps on every level: the bilinear taps of the cropped image,
// their offsets into a level-0 plane, and its corner rows and columns in
// padded coordinates.
struct PointTaps {
  gg::Taps t;
  int off0[4];
  int Y0, Y1, X0, X1;
};

template <int PAD>
__device__ __forceinline__ PointTaps point_taps(const Pyramid& p, float gx,
                                                float gy) {
  PointTaps q;
  q.t = gg::make_taps<PAD>(gx, gy, p.H, p.W);
  // the corners' clamped rows and columns, from their offsets
  const int y0 = q.t.off[0] / p.W, y1 = q.t.off[2] / p.W;
  q.Y0 = y0 + p.lp;
  q.Y1 = y1 + p.lp;
  q.X0 = q.t.off[0] - y0 * p.W + p.lp;
  q.X1 = q.t.off[1] - y0 * p.W + p.lp;
  q.off0[0] = q.Y0 * p.S + q.X0;
  q.off0[1] = q.Y0 * p.S + q.X1;
  q.off0[2] = q.Y1 * p.S + q.X0;
  q.off0[3] = q.Y1 * p.S + q.X1;
  return q;
}

__device__ __forceinline__ Rebuild level_rebuild(const Pyramid& p,
                                                 const PointTaps& q, int d) {
  return make_rebuild(q.Y0, q.Y1, q.X0, q.X1, p.size[d], p.scale[d]);
}

__device__ __forceinline__ float tap(const float v[4], const gg::Taps& t) {
  return v[0] * t.w[0] + v[1] * t.w[1] + v[2] * t.w[2] + v[3] * t.w[3];
}

// The level tent of a point's level lv: its floor level f, clipped to
// [0, D - 2], and the weights max(0, 1 - |lv - d|) of f and f + 1.
struct Tent {
  int f;
  float lo, hi;
};

__device__ __forceinline__ Tent tent_of(float lv, int D) {
  const float f = fminf(fmaxf(floorf(lv), 0.f), (float)(D - 2));
  return Tent{(int)f, fmaxf(0.f, 1.f - fabsf(lv - f)),
              fmaxf(0.f, 1.f - fabsf(lv - (f + 1.f)))};
}

// The level-0 tap of one channel plane, as the plain version sums it.
__device__ __forceinline__ void level0_corners(const float* __restrict__ plane,
                                               const PointTaps& q,
                                               float v[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = __ldg(plane + q.off0[k]);
}

// The output point of this thread: image n, flat point index p of the
// Ho x Wo points, from a 32 x 4 tile of them.
__device__ __forceinline__ bool tile_point(int n, int Ho, int Wo, int64_t* i,
                                           int64_t* p) {
  const int ox = blockIdx.x * kTileX + threadIdx.x;
  const int oy = blockIdx.y * kTileY + threadIdx.y;
  if (ox >= Wo || oy >= Ho) return false;
  *p = (int64_t)oy * Wo + ox;
  *i = n * (int64_t)Ho * Wo + *p;
  return true;
}

// One thread per output point, all its channels: NC of them (0: p.C, in a
// loop), 4 to a float4 group of the coarse levels.
template <int PAD, int NC>
__global__ void __launch_bounds__(kTileX* kTileY)
    mipmap_pyramid_fwd_kernel(Pyramid p, const float* __restrict__ grid,
                              const float* __restrict__ levels,
                              float* __restrict__ out, int Ho, int Wo) {
  const int n = blockIdx.z;
  int64_t i, pt;
  if (!tile_point(n, Ho, Wo, &i, &pt)) return;
  const PointTaps q = point_taps<PAD>(p, grid[2 * i], grid[2 * i + 1]);
  const Tent tn = tent_of(levels[i], p.D);
  const float w_lo = tn.lo, w_hi = tn.hi;
  const int d_lo = tn.f, d_hi = d_lo + 1;
  const int C = NC > 0 ? NC : p.C;
  const int G = NC > 0 ? (NC + 3) / 4 : p.G;
  const int64_t P = (int64_t)Ho * Wo;
  const float* img0 = p.level0 + n * p.level0_stride;
  const float* coarse = p.coarse + n * p.coarse_stride;
  float* dst = out + n * C * P + pt;
  // Both levels are read whatever their weights, as the plain version sums
  // every level: a weight of 0 adds exactly 0.
  const Rebuild r_hi = level_rebuild(p, q, d_hi);
  float a_hi[3][3], a_lo[3][3];
  tap_filter(r_hi, q.t.w, a_hi);
  Rebuild r_lo;
  if (d_lo > 0) {
    r_lo = level_rebuild(p, q, d_lo);
    tap_filter(r_lo, q.t.w, a_lo);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float4 win[3][3];
    load_window(coarse + p.off[d_hi], r_hi, G, g, win);
    const float4 hi = filter_window(win, a_hi);
    float4 lo;
    if (d_lo > 0) {
      load_window(coarse + p.off[d_lo], r_lo, G, g, win);
      lo = filter_window(win, a_lo);
    } else {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * g + j < C) {
          float v[4];
          level0_corners(img0 + (int64_t)(4 * g + j) * p.S * p.S, q, v);
          t[j] = tap(v, q.t);
        }
      }
      lo = make_float4(t[0], t[1], t[2], t[3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * g + j;
      if (c < C) dst[c * P] = lane(lo, j) * w_lo + lane(hi, j) * w_hi;
    }
  }
}

// The level tent of level d at lv, max(0, 1 - |lv - d|), and its
// derivative under JAX's rules (see K3 above).
__device__ __forceinline__ float level_tent(float lv, float d, float* slope) {
  const float t = lv - d;
  const float a = 1.f - (t >= 0.f ? t : -t);
  *slope = (a > 0.f ? 1.f : (a == 0.f ? 0.5f : 0.f)) * (t >= 0.f ? -1.f : 1.f);
  return fmaxf(0.f, a);
}

// One channel's part of K3 on one level, from its four corner values: the
// tap times the tent's slope into d/dlevels, the tap's slopes times the
// tent into d/dx and d/dy.
__device__ __forceinline__ void dcoords_channel(const float v[4],
                                                const gg::Taps& t, float dd,
                                                float w, float slope,
                                                float* gx, float* gy,
                                                float* gl) {
  if (slope != 0.f) *gl += dd * slope * tap(v, t);
  if (w != 0.f) {
    float sx = 0.f, sy = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sx += v[k] * t.wdx[k];
      sy += v[k] * t.wdy[k];
    }
    *gx += dd * w * sx;
    *gy += dd * w * sy;
  }
}

template <int PAD, int NC>
__global__ void __launch_bounds__(kTileX* kTileY)
    mipmap_pyramid_dcoords_kernel(Pyramid p, const float* __restrict__ grid,
                                  const float* __restrict__ levels,
                                  const float* __restrict__ dout,
                                  float* __restrict__ dgrid,
                                  float* __restrict__ dlevels, int Ho,
                                  int Wo) {
  const int n = blockIdx.z;
  int64_t i, pt;
  if (!tile_point(n, Ho, Wo, &i, &pt)) return;
  const PointTaps q = point_taps<PAD>(p, grid[2 * i], grid[2 * i + 1]);
  const float lv = levels[i];
  const int C = NC > 0 ? NC : p.C;
  const int G = NC > 0 ? (NC + 3) / 4 : p.G;
  const int64_t P = (int64_t)Ho * Wo;
  const float* img0 = p.level0 + n * p.level0_stride;
  const float* coarse = p.coarse + n * p.coarse_stride;
  const float* g = dout + n * C * P + pt;
  // every level whose tent or tent slope is not 0 at lv, in order, and
  // each level's channels in order: f - 1 .. f + 1, and f + 2, whose
  // |lv - d| rounds to exactly 1 (the tent's kink) when lv lies within
  // rounding below f + 1
  const int f = (int)floorf(lv);
  const int d_lo = max(0, f - 1), d_hi = min(p.D - 1, f + 2);
  float gx = 0.f, gy = 0.f, gl = 0.f;
  for (int d = d_lo; d <= d_hi; ++d) {
    float slope;
    const float w = level_tent(lv, (float)d, &slope);
    if (w == 0.f && slope == 0.f) continue;
    if (d == 0) {
      for (int c = 0; c < C; ++c) {
        float v[4];
        level0_corners(img0 + (int64_t)c * p.S * p.S, q, v);
        dcoords_channel(v, q.t, g[c * P], w, slope, &gx, &gy, &gl);
      }
      continue;
    }
    const Rebuild r = level_rebuild(p, q, d);
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float4 win[3][3], v4[4];
      load_window(coarse + p.off[d], r, G, gi, win);
      rebuild_corners(win, r, v4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * gi + j;
        if (c < C) {
          const float v[4] = {lane(v4[0], j), lane(v4[1], j), lane(v4[2], j),
                              lane(v4[3], j)};
          dcoords_channel(v, q.t, g[c * P], w, slope, &gx, &gy, &gl);
        }
      }
    }
  }
  dgrid[2 * i] = gx * q.t.sx;
  dgrid[2 * i + 1] = gy * q.t.sy;
  dlevels[i] = gl;
}

// ---- K5a ----

constexpr int kSpan = 3;  // the widest footprint: a coarse level's window
constexpr int kRowKeys = kTileW + kSpan - 1;  // an item's local keys a row
constexpr int kLocalKeys = kRowKeys * (kTileH + kSpan - 1);

__device__ __forceinline__ bool reaches_nothing(const gg::Taps& t) {
  return t.w[0] == 0.f && t.w[1] == 0.f && t.w[2] == 0.f && t.w[3] == 0.f;
}

// The top-left texel (ky, kx) of a point's footprint on level d: its
// tap's on level 0, its 3x3 window's on a coarse level.
__device__ __forceinline__ void footprint_origin(const Pyramid& p,
                                                 const PointTaps& q, int d,
                                                 int* ky, int* kx) {
  if (d == 0) {
    *ky = q.Y0;
    *kx = q.X0;
    return;
  }
  *ky = resize_axis(q.Y0, p.size[d], p.scale[d]).r0;
  *kx = resize_axis(q.X0, p.size[d], p.scale[d]).r0;
}

// The weights a point puts on the kSpan x kSpan texels from its
// footprint's top-left on level d, times its tent w there, into wq: on
// level 0 its tap's corner weights, two corners that a clamp folds onto
// one texel summed in corner order; on a coarse level K1's filter of the
// window, the entries that the rebuild clamps onto the edge texel summed
// there in window order.
__device__ __forceinline__ void footprint_weights(const Pyramid& p,
                                                  const PointTaps& q, int d,
                                                  float w, float* wq) {
#pragma unroll
  for (int j = 0; j < kSpan * kSpan; ++j) wq[j] = 0.f;
  if (d == 0) {
    const bool cx = q.X1 != q.X0, cy = q.Y1 != q.Y0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wq[((k >> 1) && cy ? kSpan : 0) + ((k & 1) && cx ? 1 : 0)] += q.t.w[k];
    }
  } else {
    const Rebuild r = level_rebuild(p, q, d);
    float A[3][3];
    tap_filter(r, q.t.w, A);
    const int ry = p.size[d] - 1 - r.y0.r0, rx = p.size[d] - 1 - r.x0.r0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) wq[min(a, ry) * kSpan + min(b, rx)] += A[a][b];
    }
  }
#pragma unroll
  for (int j = 0; j < kSpan * kSpan; ++j) wq[j] *= w;
}

// K5a's bin keys: an entry on each level whose tent is not 0 at the
// point's level, none for a point whose tap weights are all 0.
template <int PAD>
struct DpyramidKeys {
  static constexpr int kEntries = 2;
  struct Point {
    float2 g;
    float lv;
  };
  Pyramid p;
  Tiling tl;
  const float2* grid;
  const float* levels;
  int P;

  __device__ __forceinline__ Point load(int n, int i) const {
    const int64_t at = (int64_t)n * P + i;
    return Point{grid[at], levels[at]};
  }
  __device__ __forceinline__ void keys(const Point& pt, int (&key)[2]) const {
    const PointTaps q = point_taps<PAD>(p, pt.g.x, pt.g.y);
    if (reaches_nothing(q.t)) return;
    const Tent tn = tent_of(pt.lv, p.D);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if ((e ? tn.hi : tn.lo) == 0.f) continue;
      const int d = tn.f + e;
      int ky, kx;
      footprint_origin(p, q, d, &ky, &kx);
      key[e] = tile_key(tl, d, ky, kx, d == 0 ? 2 : kSpan);
    }
  }
};

// A gather warp's shared memory: per candidate, in the order of its
// sorted position, the weights it puts on the kSpan x kSpan texels from
// its footprint's top-left, a float4 group of channels of dout and its
// point; per local key its count, its run's start and a running position.
struct PyrItemShared {
  float wq[kSlots][kSpan * kSpan];
  float4 g[kSlots];
  int pt[kSlots];
  unsigned short cnt[kLocalKeys];
  unsigned short run[kLocalKeys + 1];
  unsigned short pos[kLocalKeys];
};
constexpr size_t kPyrItemShared = (sizeof(PyrItemShared) + 15) & ~(size_t)15;

// Tile t of the pyramid: its level, its first texel and the level's side.
struct TileAt {
  int d, y0, x0, side;
};

__device__ __forceinline__ TileAt tile_at(const Pyramid& p, const Tiling& tl,
                                          int t) {
  TileAt a;
  a.d = level_of(tl, t);
  const int lt = t - tl.base[a.d], tiles_x = tl.tiles_x[a.d];
  a.x0 = (lt % tiles_x) * kTileW;
  a.y0 = (lt / tiles_x) * kTileH;
  a.side = p.size[a.d];
  return a;
}

// The gradient's float4 group g0 of channels of texel (y, x) of level d of
// image n: planes on level 0 (lanes past C: nothing), packed texels on a
// coarse level.
__device__ __forceinline__ float* group_at(const Pyramid& p, float* dlevel0,
                                           float* dcoarse, int n, int d,
                                           int y, int x, int g0) {
  if (d == 0) {
    return dlevel0 + (((int64_t)n * p.C + 4 * g0) * p.S + y) * p.S + x;
  }
  return dcoarse + n * p.coarse_stride + p.off[d] +
         ((int64_t)(y * p.size[d] + x) * p.G + g0) * 4;
}

__device__ __forceinline__ void store_group(const Pyramid& p, float* at,
                                            int d, int g0, float4 v) {
  if (d > 0) {
    *reinterpret_cast<float4*>(at) = v;
    return;
  }
  const int64_t plane = (int64_t)p.S * p.S;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (4 * g0 + c < p.C) at[c * plane] = lane(v, c);
  }
}

__device__ __forceinline__ float4 load_group(const Pyramid& p,
                                             const float* at, int d, int g0) {
  if (d > 0) return *reinterpret_cast<const float4*>(at);
  const int64_t plane = (int64_t)p.S * p.S;
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) v[c] = 4 * g0 + c < p.C ? at[c * plane] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Each warp walks the image's work items on its own: item i is tile t's
// candidates [s * kSlots, (s + 1) * kSlots) of its list, s = i - first[t].
template <int PAD>
__global__ void __launch_bounds__(kGatherWarps * 32)
    dpyramid_gather_kernel(Pyramid p, Tiling tl,
                           const float* __restrict__ grid,
                           const float* __restrict__ levels,
                           const float* __restrict__ dout,
                           const int* __restrict__ order,
                           char* __restrict__ work,
                           float* __restrict__ partial,
                           float* __restrict__ dlevel0,
                           float* __restrict__ dcoarse, int P, int extra) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  PyrItemShared& sh = *reinterpret_cast<PyrItemShared*>(
      reinterpret_cast<char*>(smem) + warp * kPyrItemShared);
  const int n = blockIdx.y, nt = tl.base[tl.levels], C = p.C;
  const Work wk = work_of(work, nt, extra, n);
  const int n_items = wk.first[nt];
  const float2* pts = reinterpret_cast<const float2*>(grid) + (int64_t)n * P;
  const float* lvs = levels + (int64_t)n * P;
  const int* ord = order + (int64_t)n * 2 * P;
  const float* dn = dout + (int64_t)n * C * P;
  for (int i = blockIdx.x * kGatherWarps + warp; i < n_items;
       i += gridDim.x * kGatherWarps) {
    const int t = wk.item_tile[i], s = i - wk.first[t];
    const int4 start = wk.seg[2 * t], len = wk.seg[2 * t + 1];
    const int v0 = s * kSlots;
    const int m = min(len.x + len.y + len.z + len.w - v0, kSlots);
    const TileAt at = tile_at(p, tl, t);
    const int width = at.d == 0 ? 2 : kSpan;
    if (m <= 0) {  // a tile that no footprint reaches: its one item
#pragma unroll
      for (int te = 0; te < kTileTexels / 32; ++te) {
        const int e = te * 32 + lane;
        const int y = at.y0 + e / kTileW, x = at.x0 + e % kTileW;
        if (y >= at.side || x >= at.side) continue;
        for (int g0 = 0; g0 < p.G; ++g0) {
          store_group(p, group_at(p, dlevel0, dcoarse, n, at.d, y, x, g0),
                      at.d, g0, make_float4(0.f, 0.f, 0.f, 0.f));
        }
      }
      continue;
    }

    // The candidates' indices, then their coordinates and levels (all
    // loads of a step issued together).
    int pi[kSlotRounds];
#pragma unroll
    for (int r = 0; r < kSlotRounds; ++r) {
      const int j = r * 32 + lane;
      pi[r] = j < m ? candidate(ord, start, len, v0 + j) : -1;
    }
    float2 g[kSlotRounds];
    float lv[kSlotRounds];
#pragma unroll
    for (int r = 0; r < kSlotRounds; ++r) {
      g[r] = pi[r] >= 0 ? pts[pi[r]] : make_float2(0.f, 0.f);
      lv[r] = pi[r] >= 0 ? lvs[pi[r]] : 0.f;
    }
    for (int k = lane; k < kLocalKeys; k += 32) sh.cnt[k] = 0;
    __syncwarp();
    // The local key of each candidate's footprint origin; each key's count.
    int key[kSlotRounds];
#pragma unroll
    for (int r = 0; r < kSlotRounds; ++r) {
      key[r] = -1;
      if (pi[r] >= 0) {
        const PointTaps q = point_taps<PAD>(p, g[r].x, g[r].y);
        int ky, kx;
        footprint_origin(p, q, at.d, &ky, &kx);
        key[r] = (ky - at.y0 + kSpan - 1) * kRowKeys + kx - at.x0 + kSpan - 1;
      }
      const Group gr = group_of(key[r]);
      if (key[r] >= 0 && gr.lead) {
        sh.cnt[key[r]] += (unsigned short)__popc(gr.mask);
      }
      __syncwarp();
    }
    float dv[kSlotRounds][4];  // dout's first channels, loaded now
#pragma unroll
    for (int r = 0; r < kSlotRounds; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dv[r][c] = pi[r] >= 0 && c < C ? dn[(int64_t)c * P + pi[r]] : 0.f;
      }
    }
    warp_scan<kLocalKeys>(sh.cnt, sh.run, lane);
    for (int k = lane; k < kLocalKeys; k += 32) sh.pos[k] = sh.run[k];
    __syncwarp();
    // Each candidate at its sorted place: its weights on this level, dout
    // and the point.
#pragma unroll
    for (int r = 0; r < kSlotRounds; ++r) {
      const Group gr = group_of(key[r]);
      if (key[r] >= 0) {
        const int a = sh.pos[key[r]] + rank_in(gr);
        const PointTaps q = point_taps<PAD>(p, g[r].x, g[r].y);
        const Tent tn = tent_of(lv[r], p.D);
        footprint_weights(p, q, at.d, at.d == tn.f ? tn.lo : tn.hi,
                          sh.wq[a]);
        sh.g[a] = make_float4(dv[r][0], dv[r][1], dv[r][2], dv[r][3]);
        sh.pt[a] = pi[r];
      }
      __syncwarp();
      if (key[r] >= 0 && gr.lead) {
        sh.pos[key[r]] += (unsigned short)__popc(gr.mask);
      }
      __syncwarp();
    }

    // Texel (ly, lx) is reached from the origins (ly - dy, lx - dx),
    // 0 <= dx, dy < width: for each dy, `width` adjacent local keys.
    const int placed = sh.run[kLocalKeys];
    for (int g0 = 0; g0 < p.G; ++g0) {
      if (g0 > 0) {
        for (int j = lane; j < placed; j += 32) {
          float v[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            v[c] = 4 * g0 + c < C ? dn[(int64_t)(4 * g0 + c) * P + sh.pt[j]]
                                  : 0.f;
          }
          sh.g[j] = make_float4(v[0], v[1], v[2], v[3]);
        }
        __syncwarp();
      }
#pragma unroll
      for (int te = 0; te < kTileTexels / 32; ++te) {
        const int e = te * 32 + lane;
        const int ly = e / kTileW, lx = e % kTileW;
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int dy = width - 1; dy >= 0; --dy) {
          const int k = (ly - dy + kSpan - 1) * kRowKeys + lx - width + kSpan;
          const int b1 = sh.run[k + 1], b2 = sh.run[k + 2];
          const int end = sh.run[k + width];
          for (int j = sh.run[k]; j < end; ++j) {
            const int dx = width - 1 - (j >= b1) - (width == kSpan && j >= b2);
            const float w = sh.wq[j][dy * kSpan + dx];
            const float4 gv = sh.g[j];
            acc.x += gv.x * w;
            acc.y += gv.y * w;
            acc.z += gv.z * w;
            acc.w += gv.w * w;
          }
        }
        const int y = at.y0 + ly, x = at.x0 + lx;
        if (y < at.side && x < at.side) {
          if (s == 0) {
            store_group(p, group_at(p, dlevel0, dcoarse, n, at.d, y, x, g0),
                        at.d, g0, acc);
          } else {
            const int64_t slot = (int64_t)n * extra + (i - t - 1);
            float* ps = partial + (slot * p.G + g0) * 4 * kTileTexels + e;
            ps[0] = acc.x;
            ps[kTileTexels] = acc.y;
            ps[2 * kTileTexels] = acc.z;
            ps[3 * kTileTexels] = acc.w;
          }
        }
      }
      __syncwarp();
    }
  }
}

// A warp a tile: add a split tile's later items, in item order, to what
// its first wrote; a float4 group of channels of two texels a lane at a
// time.
__global__ void __launch_bounds__(kGatherWarps * 32)
    dpyramid_merge_kernel(Pyramid p, Tiling tl, char* __restrict__ work,
                          const float* __restrict__ partial,
                          float* __restrict__ dlevel0,
                          float* __restrict__ dcoarse, int extra) {
  constexpr int kPer = kTileTexels / 32;  // a lane's texels
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.y, nt = tl.base[tl.levels];
  const int t = blockIdx.x * kGatherWarps + (threadIdx.x >> 5);
  if (t >= nt) return;
  const Work wk = work_of(work, nt, extra, n);
  const int first = wk.first[t], splits = wk.first[t + 1] - first;
  if (splits <= 1) return;
  const int64_t slot0 = (int64_t)n * extra + first - t;  // item 1's slot
  const TileAt at = tile_at(p, tl, t);
  for (int g0 = 0; g0 < p.G; ++g0) {
    float* to[kPer];
    float4 a[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = k * 32 + lane;
      const int y = at.y0 + e / kTileW, x = at.x0 + e % kTileW;
      to[k] = y < at.side && x < at.side
                  ? group_at(p, dlevel0, dcoarse, n, at.d, y, x, g0) : nullptr;
      a[k] = to[k] ? load_group(p, to[k], at.d, g0)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int s = 1; s < splits; ++s) {
      const float* ps =
          partial + ((slot0 + s - 1) * p.G + g0) * 4 * kTileTexels + lane;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        a[k].x += ps[k * 32];
        a[k].y += ps[kTileTexels + k * 32];
        a[k].z += ps[2 * kTileTexels + k * 32];
        a[k].w += ps[3 * kTileTexels + k * 32];
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (to[k]) store_group(p, to[k], at.d, g0, a[k]);
    }
  }
}

// The pyramid's geometry from the entry points' arguments: D levels of C
// channels, level 0 (N, C, S, S), level d >= 1 of side S >> d in the
// coarse block, its texels of G float4 groups; the cropped (H, W) at
// offset lp. Returns false for what the kernels do not take.
bool make_pyramid(Pyramid* p, const float* level0, const float* coarse,
                  int D, int C, int S, int H, int W, int lp) {
  if (D < 2 || D > kMaxLevels || (S >> (D - 1)) < 1 || C < 1) return false;
  if (lp < 0 || H + lp > S || W + lp > S) return false;
  if (reinterpret_cast<uintptr_t>(coarse) % 16 != 0) return false;
  p->level0 = level0;
  p->coarse = coarse;
  p->D = D;
  p->C = C;
  p->G = (C + 3) / 4;
  p->S = S;
  p->H = H;
  p->W = W;
  p->lp = lp;
  p->level0_stride = (int64_t)C * S * S;
  int64_t off = 0;
  for (int d = 0; d < D; ++d) {
    p->size[d] = S >> d;
    p->scale[d] = (float)((double)p->size[d] / (double)S);
    p->off[d] = off;
    if (d > 0) off += (int64_t)4 * p->G * p->size[d] * p->size[d];
  }
  p->coarse_stride = off;
  return true;
}

dim3 tile_grid(int planes, int Ho, int Wo) {
  return dim3((unsigned)((Wo + kTileX - 1) / kTileX),
              (unsigned)((Ho + kTileY - 1) / kTileY), (unsigned)planes);
}

// K1 for NC channels (0: any) and the padding code: launch, and return
// the CUDA error code of the launch.
template <int NC>
int launch_fwd(int padding, dim3 blocks, dim3 threads, cudaStream_t s,
               const Pyramid& p, const float* grid, const float* levels,
               float* out, int Ho, int Wo) {
  switch (padding) {
    case gg::kBorder:
      mipmap_pyramid_fwd_kernel<gg::kBorder, NC>
          <<<blocks, threads, 0, s>>>(p, grid, levels, out, Ho, Wo);
      break;
    case gg::kReflection:
      mipmap_pyramid_fwd_kernel<gg::kReflection, NC>
          <<<blocks, threads, 0, s>>>(p, grid, levels, out, Ho, Wo);
      break;
    case gg::kZeros:
      mipmap_pyramid_fwd_kernel<gg::kZeros, NC>
          <<<blocks, threads, 0, s>>>(p, grid, levels, out, Ho, Wo);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K3 likewise.
template <int NC>
int launch_dcoords(int padding, dim3 blocks, dim3 threads, cudaStream_t s,
                   const Pyramid& p, const float* grid, const float* levels,
                   const float* dout, float* dgrid, float* dlevels, int Ho,
                   int Wo) {
  switch (padding) {
    case gg::kBorder:
      mipmap_pyramid_dcoords_kernel<gg::kBorder, NC><<<blocks, threads, 0, s>>>(
          p, grid, levels, dout, dgrid, dlevels, Ho, Wo);
      break;
    case gg::kReflection:
      mipmap_pyramid_dcoords_kernel<gg::kReflection, NC>
          <<<blocks, threads, 0, s>>>(p, grid, levels, dout, dgrid, dlevels,
                                      Ho, Wo);
      break;
    case gg::kZeros:
      mipmap_pyramid_dcoords_kernel<gg::kZeros, NC><<<blocks, threads, 0, s>>>(
          p, grid, levels, dout, dgrid, dlevels, Ho, Wo);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K5a's geometry and the byte offsets of its scratch: the bucketed
// entries (two a point), the work lists and the split tiles' partials.
struct DpyramidPlan {
  Tiling tl;
  BinPlan bin;
  size_t order, work, partial, bytes;
};

bool plan_dpyramid(DpyramidPlan* q, int N, int D, int C, int S, int P) {
  if (N <= 0 || D < 2 || D > kMaxLevels || C < 1 || S < 1 ||
      (S >> (D - 1)) < 1 || P <= 0) {
    return false;
  }
  int sides[kMaxLevels];
  for (int d = 0; d < D; ++d) sides[d] = S >> d;
  q->tl = make_tiling(D, sides, sides);
  if (!plan_bin(&q->bin, q->tl, 2, P)) return false;
  const int G = (C + 3) / 4;
  size_t at = 0;
  q->order = at;
  at = align16(at + sizeof(int) * (size_t)N * 2 * P);
  q->work = at;
  at = align16(at + q->bin.work * N);
  q->partial = at;
  at = align16(at + sizeof(float) * (size_t)N * q->bin.extra * G * 4 *
                        kTileTexels);
  q->bytes = at;
  return true;
}

template <int PAD>
int launch_dpyramid(const Pyramid& p, const DpyramidPlan& q,
                    const float* grid, const float* levels, const float* dout,
                    float* dlevel0, float* dcoarse, char* scratch, int N,
                    int P, cudaStream_t s) {
  int* order = reinterpret_cast<int*>(scratch + q.order);
  char* work = scratch + q.work;
  float* partial = reinterpret_cast<float*>(scratch + q.partial);
  const DpyramidKeys<PAD> keys{p, q.tl, reinterpret_cast<const float2*>(grid),
                               levels, P};
  const int rc = launch_bin(keys, q.tl, q.bin, N, order, work, P, s);
  if (rc != 0) return rc;
  const size_t shared = kGatherWarps * kPyrItemShared;
  const cudaError_t err = cudaFuncSetAttribute(
      dpyramid_gather_kernel<PAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return (int)err;
  // a warp for each tile's first item; later items go to the warps of
  // lower tiles in turn
  const dim3 blocks((q.bin.nt + kGatherWarps - 1) / kGatherWarps, N);
  dpyramid_gather_kernel<PAD><<<blocks, kGatherWarps * 32, shared, s>>>(
      p, q.tl, grid, levels, dout, order, work, partial, dlevel0, dcoarse, P,
      q.bin.extra);
  dpyramid_merge_kernel<<<blocks, kGatherWarps * 32, 0, s>>>(
      p, q.tl, work, partial, dlevel0, dcoarse, q.bin.extra);
  return (int)cudaGetLastError();
}

}  // namespace

// K1. level0 (N, C, S, S): the input reflect-padded to S; coarse: per
// image, levels 1 .. D - 1 of side S >> d, each [row][column][channel]
// with the channels zero-padded to a multiple of 4, 16-byte aligned; grid
// (N, Ho, Wo, 2) with x then y in [-1, 1] over the cropped (H, W) at
// offset lp; levels (N, Ho, Wo); out (N, C, Ho, Wo); all f32 and
// contiguous, 2 <= D <= 8. Returns the CUDA error code of the launch.
extern "C" int gg_mipmap_pyramid_fwd(const float* level0, const float* coarse,
                                     const float* grid, const float* levels,
                                     float* out, int N, int D, int C, int S,
                                     int H, int W, int lp, int Ho, int Wo,
                                     int padding, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Pyramid p;
  if (!make_pyramid(&p, level0, coarse, D, C, S, H, W, lp) || N > 65535)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)N * Ho * Wo == 0) return (int)cudaSuccess;
  const dim3 threads(kTileX, kTileY);
  const dim3 blocks = tile_grid(N, Ho, Wo);
  cudaStream_t s = (cudaStream_t)stream;
  return C == 3 ? launch_fwd<3>(padding, blocks, threads, s, p, grid, levels,
                                out, Ho, Wo)
                : launch_fwd<0>(padding, blocks, threads, s, p, grid, levels,
                                out, Ho, Wo);
}

// K3. level0, coarse, grid, levels as for K1; dout (N, C, Ho, Wo), dgrid
// (N, Ho, Wo, 2), dlevels (N, Ho, Wo); all f32 and contiguous. Returns the
// CUDA error code of the launch.
extern "C" int gg_mipmap_pyramid_dcoords(const float* level0,
                                         const float* coarse,
                                         const float* grid,
                                         const float* levels,
                                         const float* dout, float* dgrid,
                                         float* dlevels, int N, int D, int C,
                                         int S, int H, int W, int lp, int Ho,
                                         int Wo, int padding, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Pyramid p;
  if (!make_pyramid(&p, level0, coarse, D, C, S, H, W, lp) || N > 65535)
    return (int)cudaErrorInvalidValue;
  if ((int64_t)N * Ho * Wo == 0) return (int)cudaSuccess;
  const dim3 threads(kTileX, kTileY);
  const dim3 blocks = tile_grid(N, Ho, Wo);
  cudaStream_t s = (cudaStream_t)stream;
  return C == 3 ? launch_dcoords<3>(padding, blocks, threads, s, p, grid,
                                    levels, dout, dgrid, dlevels, Ho, Wo)
                : launch_dcoords<0>(padding, blocks, threads, s, p, grid,
                                    levels, dout, dgrid, dlevels, Ho, Wo);
}

// K5a's scratch in bytes for these shapes, or -1 for shapes it does not
// take.
extern "C" long long gg_mipmap_dpyramid_scratch(int N, int D, int C, int S,
                                                int P) {
  DpyramidPlan q;
  return plan_dpyramid(&q, N, D, C, S, P) ? (long long)q.bytes : -1;
}

// K5a. grid (N, P, 2), levels (N, P), dout (N, C, P) over the cropped
// (H, W) at offset lp of a pyramid of D levels of side S >> d; dlevel0
// (N, C, S, S) and dcoarse (per image the coarse levels, packed as K1
// reads them, 16-byte aligned), both written whole; scratch of
// gg_mipmap_dpyramid_scratch bytes, 16-byte aligned; all f32 and
// contiguous. Three launches; returns the CUDA error code.
extern "C" int gg_mipmap_dpyramid(const float* grid, const float* levels,
                                  const float* dout, float* dlevel0,
                                  float* dcoarse, void* scratch, int N, int D,
                                  int C, int S, int H, int W, int lp, int P,
                                  int padding, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0) return (int)cudaSuccess;
  Pyramid p;
  DpyramidPlan q;
  if (!make_pyramid(&p, dlevel0, dcoarse, D, C, S, H, W, lp) || N > 65535 ||
      !plan_dpyramid(&q, N, D, C, S, P)) {
    return (int)cudaErrorInvalidValue;
  }
  char* sc = static_cast<char*>(scratch);
  cudaStream_t s = (cudaStream_t)stream;
  switch (padding) {
    case gg::kBorder:
      return launch_dpyramid<gg::kBorder>(p, q, grid, levels, dout, dlevel0,
                                          dcoarse, sc, N, P, s);
    case gg::kReflection:
      return launch_dpyramid<gg::kReflection>(p, q, grid, levels, dout,
                                              dlevel0, dcoarse, sc, N, P, s);
    case gg::kZeros:
      return launch_dpyramid<gg::kZeros>(p, q, grid, levels, dout, dlevel0,
                                         dcoarse, sc, N, P, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
