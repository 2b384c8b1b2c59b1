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
// K5a: d/dstack, backward. Replaces pallas_mipmap.py::_dimg_kernel, a
// deterministic wy^T matmul accumulated over point blocks. Here each point
// scatters dout x level weight x corner weight into the full-resolution
// (N, D, C, H, W) d/dstack, with atomicAdd: the order of the sums, and so
// the last bits, change from run to run. The autograd Function maps it to
// d/dpyramid with the adjoint of the rebuild as torch ops, and launches it
// only when the image needs a gradient; in the GANgealing step both warps
// sample G's output, which carries none.

#include <cuda_runtime.h>

#include <cstdint>

#include "bilinear.cuh"

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
  const float lv = levels[i];
  const float f = fminf(fmaxf(floorf(lv), 0.f), (float)(p.D - 2));
  const float w_lo = fmaxf(0.f, 1.f - fabsf(lv - f));
  const float w_hi = fmaxf(0.f, 1.f - fabsf(lv - (f + 1.f)));
  const int d_lo = (int)f, d_hi = d_lo + 1;
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

template <int PAD>
__global__ void mipmap_dstack_kernel(const float* __restrict__ grid,
                                     const float* __restrict__ levels,
                                     const float* __restrict__ dout,
                                     float* __restrict__ dstack, int N, int D,
                                     int C, int H, int W, int P) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)N * P) return;
  const int64_t n = i / P;
  const int64_t p = i - n * P;
  const gg::Taps t = gg::make_taps<PAD>(grid[2 * i], grid[2 * i + 1], H, W);
  const float lv = levels[i];
  const float f = fminf(fmaxf(floorf(lv), 0.f), (float)(D - 2));
  const float w_lo = fmaxf(0.f, 1.f - fabsf(lv - f));
  const float w_hi = fmaxf(0.f, 1.f - fabsf(lv - (f + 1.f)));
  const int64_t hw = (int64_t)H * W;
  float* lo = dstack + (n * D + (int64_t)f) * C * hw;
  float* hi = lo + C * hw;
  const float* g = dout + n * C * P + p;
  for (int c = 0; c < C; ++c) {
    const float dd = g[(int64_t)c * P];
    if (w_lo != 0.f) gg::scatter(lo + c * hw, t, dd * w_lo);
    if (w_hi != 0.f) gg::scatter(hi + c * hw, t, dd * w_hi);
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

// K5a. grid (N, P, 2), levels (N, P), dout (N, C, P), dstack
// (N, D, C, H, W) zero-filled by the caller; all f32 and contiguous,
// D >= 2. Returns the CUDA error code of the launch.
extern "C" int gg_mipmap_sample_dstack(const float* grid, const float* levels,
                                       const float* dout, float* dstack,
                                       int N, int D, int C, int H, int W,
                                       int P, int padding, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D < 2) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)N * P;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  GG_LAUNCH_BY_PADDING(mipmap_dstack_kernel, blocks, threads, s, grid, levels,
                       dout, dstack, N, D, C, H, W, P);
  return (int)cudaGetLastError();
}
