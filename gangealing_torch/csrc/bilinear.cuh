// Per-point bilinear tap with torch.nn.functional.grid_sample semantics
// (mode="bilinear", align_corners=False), shared by the grid-sample and the
// mipmap-sample kernels.
//
// The arithmetic follows gangealing_torch/ops/grid_sample.py::_compute_coords
// and grid_sample op for op. The library is built with -fmad=false, so no
// multiply-add is contracted and each step rounds as the plain torch version
// rounds it.
#pragma once

#include <cstdint>

namespace gg {

enum Padding : int { kBorder = 0, kReflection = 1, kZeros = 2 };

// Reflect into [-0.5, size - 0.5], as _reflect(c, -1, 2 * size - 1). The
// remainder is taken with floorf on a value that is already >= 0, so it does
// not depend on fmodf's sign convention. *slope receives d(result)/dc under
// JAX's rules: |t| has derivative 1 at t = 0, and a flipped span -1.
__device__ __forceinline__ float reflect(float c, int size, float* slope) {
  const float mn = -0.5f;
  const float span = (float)size;
  const float t = c - mn;
  c = fabsf(t);
  const float flips = floorf(c / span);
  const float extra = c - flips * span;
  const bool flipped = fmodf(flips, 2.f) != 0.f;
  *slope = (t >= 0.f ? 1.f : -1.f) * (flipped ? -1.f : 1.f);
  return flipped ? span - extra + mn : extra + mn;
}

// d clip(u, lo, hi) / du as jax.grad takes it: clip is min(max(u, lo), hi)
// and each of max and min passes half the gradient at a tie.
__device__ __forceinline__ float clip_slope(float u, float lo, float hi) {
  const float m = fmaxf(u, lo);
  const float dmax = u > lo ? 1.f : (u == lo ? 0.5f : 0.f);
  const float dmin = m < hi ? 1.f : (m == hi ? 0.5f : 0.f);
  return dmax * dmin;
}

// Unnormalize a [-1, 1] coordinate over `size` pixels and apply the padding
// rule. Zeros padding leaves the coordinate as it is: the corners outside
// the image are masked in make_taps. *slope receives d(result)/dg.
template <int PAD>
__device__ __forceinline__ float source_coord(float g, int size,
                                              float* slope) {
  const float c = ((g + 1.f) * (float)size - 1.f) * 0.5f;
  const float hi = (float)(size - 1);
  *slope = (float)size * 0.5f;
  if (PAD == kBorder) {
    *slope *= clip_slope(c, 0.f, hi);
    return fminf(fmaxf(c, 0.f), hi);
  }
  if (PAD == kReflection) {
    float rs;
    const float r = reflect(c, size, &rs);
    *slope *= rs * clip_slope(r, 0.f, hi);
    return fminf(fmaxf(r, 0.f), hi);
  }
  return c;
}

// The four corners of one point: offsets into an (H, W) plane, read at
// clamped indices, and weights from the unclamped tent, zeroed for corners
// outside the image under zeros padding. Order: (x0,y0) (x1,y0) (x0,y1)
// (x1,y1), the order in which the plain version sums them. For the
// backward, wdx and wdy are each weight's derivatives with respect to the
// padded coordinates x and y (the right derivative at an integer, since
// x0 = floor(x)), and sx, sy the derivatives of x and y with respect to the
// grid's.
struct Taps {
  int off[4];
  float w[4];
  float wdx[4];
  float wdy[4];
  float sx, sy;
};

template <int PAD>
__device__ __forceinline__ void set_corner(Taps& t, int k, float xc, float yc,
                                           float wx, float wy, float dwx,
                                           float dwy, int H, int W) {
  float valid = 1.f;
  if (PAD == kZeros) {
    valid = xc >= 0.f && xc < (float)W && yc >= 0.f && yc < (float)H ? 1.f
                                                                      : 0.f;
  }
  const int xi = (int)fminf(fmaxf(xc, 0.f), (float)(W - 1));
  const int yi = (int)fminf(fmaxf(yc, 0.f), (float)(H - 1));
  t.off[k] = yi * W + xi;
  t.w[k] = PAD == kZeros ? (valid != 0.f ? wx * wy : 0.f) : wx * wy;
  t.wdx[k] = dwx * wy * valid;
  t.wdy[k] = wx * dwy * valid;
}

template <int PAD>
__device__ __forceinline__ Taps make_taps(float gx, float gy, int H, int W) {
  Taps t;
  const float x = source_coord<PAD>(gx, W, &t.sx);
  const float y = source_coord<PAD>(gy, H, &t.sy);
  // floorf, never a truncating cast: zeros padding passes negative coords.
  const float x0 = floorf(x), y0 = floorf(y);
  const float x1 = x0 + 1.f, y1 = y0 + 1.f;
  const float wx1 = x - x0, wx0 = 1.f - wx1;
  const float wy1 = y - y0, wy0 = 1.f - wy1;
  set_corner<PAD>(t, 0, x0, y0, wx0, wy0, -1.f, -1.f, H, W);
  set_corner<PAD>(t, 1, x1, y0, wx1, wy0, 1.f, -1.f, H, W);
  set_corner<PAD>(t, 2, x0, y1, wx0, wy1, -1.f, 1.f, H, W);
  set_corner<PAD>(t, 3, x1, y1, wx1, wy1, 1.f, 1.f, H, W);
  return t;
}

__device__ __forceinline__ float sample(const float* __restrict__ plane,
                                        const Taps& t) {
  return plane[t.off[0]] * t.w[0] + plane[t.off[1]] * t.w[1] +
         plane[t.off[2]] * t.w[2] + plane[t.off[3]] * t.w[3];
}

// d(sample)/dx and d(sample)/dy of one plane at the point.
__device__ __forceinline__ void sample_slopes(const float* __restrict__ plane,
                                              const Taps& t, float* dx,
                                              float* dy) {
  float ax = 0.f, ay = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = plane[t.off[k]];
    ax += v * t.wdx[k];
    ay += v * t.wdy[k];
  }
  *dx = ax;
  *dy = ay;
}

}  // namespace gg

// Launch kernel<PAD> for the padding code in the enclosing function's
// `padding`, or return cudaErrorInvalidValue from it for an unknown code.
#define GG_LAUNCH_BY_PADDING(kernel, blocks, threads, stream, ...)         \
  switch (padding) {                                                       \
    case gg::kBorder:                                                      \
      kernel<gg::kBorder><<<blocks, threads, 0, stream>>>(__VA_ARGS__);    \
      break;                                                               \
    case gg::kReflection:                                                  \
      kernel<gg::kReflection><<<blocks, threads, 0, stream>>>(__VA_ARGS__); \
      break;                                                               \
    case gg::kZeros:                                                       \
      kernel<gg::kZeros><<<blocks, threads, 0, stream>>>(__VA_ARGS__);     \
      break;                                                               \
    default:                                                               \
      return (int)cudaErrorInvalidValue;                                   \
  }
