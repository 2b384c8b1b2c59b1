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
// not depend on fmodf's sign convention.
__device__ __forceinline__ float reflect(float c, int size) {
  const float mn = -0.5f;
  const float span = (float)size;
  c = fabsf(c - mn);
  const float flips = floorf(c / span);
  const float extra = c - flips * span;
  return fmodf(flips, 2.f) != 0.f ? span - extra + mn : extra + mn;
}

// Unnormalize a [-1, 1] coordinate over `size` pixels and apply the padding
// rule. Zeros padding leaves the coordinate as it is: the corners outside
// the image are masked in make_taps.
template <int PAD>
__device__ __forceinline__ float source_coord(float g, int size) {
  float c = ((g + 1.f) * (float)size - 1.f) * 0.5f;
  if (PAD == kBorder) {
    c = fminf(fmaxf(c, 0.f), (float)(size - 1));
  } else if (PAD == kReflection) {
    c = fminf(fmaxf(reflect(c, size), 0.f), (float)(size - 1));
  }
  return c;
}

// The four corners of one point: offsets into an (H, W) plane, read at
// clamped indices, and weights from the unclamped tent, zeroed for corners
// outside the image under zeros padding. Order: (x0,y0) (x1,y0) (x0,y1)
// (x1,y1), the order in which the plain version sums them.
struct Taps {
  int off[4];
  float w[4];
};

template <int PAD>
__device__ __forceinline__ void set_corner(Taps& t, int k, float xc, float yc,
                                           float w, int H, int W) {
  if (PAD == kZeros) {
    const bool valid = xc >= 0.f && xc < (float)W && yc >= 0.f && yc < (float)H;
    w = valid ? w : 0.f;
  }
  const int xi = (int)fminf(fmaxf(xc, 0.f), (float)(W - 1));
  const int yi = (int)fminf(fmaxf(yc, 0.f), (float)(H - 1));
  t.off[k] = yi * W + xi;
  t.w[k] = w;
}

template <int PAD>
__device__ __forceinline__ Taps make_taps(float gx, float gy, int H, int W) {
  const float x = source_coord<PAD>(gx, W);
  const float y = source_coord<PAD>(gy, H);
  // floorf, never a truncating cast: zeros padding passes negative coords.
  const float x0 = floorf(x), y0 = floorf(y);
  const float x1 = x0 + 1.f, y1 = y0 + 1.f;
  const float wx1 = x - x0, wx0 = 1.f - wx1;
  const float wy1 = y - y0, wy0 = 1.f - wy1;
  Taps t;
  set_corner<PAD>(t, 0, x0, y0, wx0 * wy0, H, W);
  set_corner<PAD>(t, 1, x1, y0, wx1 * wy0, H, W);
  set_corner<PAD>(t, 2, x0, y1, wx0 * wy1, H, W);
  set_corner<PAD>(t, 3, x1, y1, wx1 * wy1, H, W);
  return t;
}

__device__ __forceinline__ float sample(const float* __restrict__ plane,
                                        const Taps& t) {
  return plane[t.off[0]] * t.w[0] + plane[t.off[1]] * t.w[1] +
         plane[t.off[2]] * t.w[2] + plane[t.off[3]] * t.w[3];
}

}  // namespace gg
