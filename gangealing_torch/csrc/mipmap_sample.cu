// K1: mipmap (anti-aliased) sample, forward.
//
// Replaces the TPU kernel gangealing_tpu/ops/pallas_mipmap.py::_fwd_kernel
// (launched by _mt_sample_core through mipmap_sample). That kernel samples a
// coarse-height band stack with four composed row tents per point as MXU
// matmuls. Here each point gathers directly from the D full-resolution
// Gaussian levels of ops/mipmap.py::_build_stack: it bilinearly samples the
// floor and ceil levels of its own level and lerps them. With the level
// weights taken as tents, max(0, 1 - |level - d|), this equals the
// tent-weighted sum over the level axis of _mipmap_warp_fold for any level,
// and (1 - lw, lw) for the levels the warp produces (<= D - 1).
//
// What bounds it here: gather latency and bytes. Each point reads 8 taps x C
// channels (2 levels x 4 corners) at data-dependent addresses and writes C
// floats. The stack is D x C x H x W f32 per image (about 3 MB at 4 x 3 x
// 256 x 256) and stays mostly in the 50 MB L2, so the taps are L2 hits. The
// design: one thread per output point, neighbouring threads on neighbouring
// points so the grid, level and output accesses coalesce; the coordinates,
// corners and level weights are computed once per point and reused for every
// channel of both levels. Reading coarse bands instead of full-resolution
// levels, and shared-memory tiling, are later work.
//
// K3: d/dgrid and d/dlevels, backward. Replaces
// pallas_mipmap.py::_dcoords_kernel, which returns d/dx and d/d(tent
// amplitudes) of the band form and leaves JAX to chain them to the grid and
// the levels through _band_tent_coords. Here one thread per point recomputes
// the taps, accumulates d/dx and d/dy over the channels of the levels with
// weight, chains them through the padding rule and the unnormalise step to
// d/dgrid, and writes d/dlevels; autograd chains d/dlevels on through
// mipmap_levels. The gradient is jax.grad's of the fold path, ties
// included: the right derivative at an integer coordinate, half the
// gradient on a clamp bound, and the level tent max(0, 1 - |level - d|)
// differentiated with |t|' = 1 at 0 and half at the kink where the tent
// meets 0. So at an integer level f the derivative reads level f - 1 as
// well, which the forward never reads. Bounded like K1, by the tap gathers
// (2 or 3 levels x 4 corners x C) from L2.
//
// K5a: d/dstack, backward. Replaces pallas_mipmap.py::_dimg_kernel, a
// deterministic wy^T matmul accumulated over point blocks. Here each point
// scatters dout x level weight x corner weight into the two levels it read,
// with atomicAdd: the order of the sums, and so the last bits, change from
// run to run. The autograd Function launches it only when the stack needs a
// gradient; in the GANgealing step both warps sample G's output, which
// carries none.

#include <cuda_runtime.h>

#include "bilinear.cuh"

namespace {

template <int PAD>
__global__ void mipmap_sample_kernel(const float* __restrict__ stack,
                                     const float* __restrict__ grid,
                                     const float* __restrict__ levels,
                                     float* __restrict__ out, int N, int D,
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
  const float* lo = stack + (n * D + (int64_t)f) * C * hw;
  const float* hi = lo + C * hw;
  float* dst = out + n * C * P + p;
  for (int c = 0; c < C; ++c) {
    dst[(int64_t)c * P] = gg::sample(lo + c * hw, t) * w_lo +
                          gg::sample(hi + c * hw, t) * w_hi;
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

template <int PAD>
__global__ void mipmap_dcoords_kernel(const float* __restrict__ stack,
                                      const float* __restrict__ grid,
                                      const float* __restrict__ levels,
                                      const float* __restrict__ dout,
                                      float* __restrict__ dgrid,
                                      float* __restrict__ dlevels, int N,
                                      int D, int C, int H, int W, int P) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)N * P) return;
  const int64_t n = i / P;
  const int64_t p = i - n * P;
  const gg::Taps t = gg::make_taps<PAD>(grid[2 * i], grid[2 * i + 1], H, W);
  const float lv = levels[i];
  // every level whose tent or tent slope is not 0 at lv
  const int f = (int)floorf(lv);
  const int d_lo = max(0, f - 1), d_hi = min(D - 1, f + 1);
  const int64_t hw = (int64_t)H * W;
  const float* g = dout + n * C * P + p;
  float gx = 0.f, gy = 0.f, gl = 0.f;
  for (int d = d_lo; d <= d_hi; ++d) {
    float slope;
    const float w = level_tent(lv, (float)d, &slope);
    if (w == 0.f && slope == 0.f) continue;
    const float* level = stack + (n * D + d) * C * hw;
    for (int c = 0; c < C; ++c) {
      const float* plane = level + c * hw;
      const float dd = g[(int64_t)c * P];
      if (slope != 0.f) gl += dd * slope * gg::sample(plane, t);
      if (w != 0.f) {
        float sx, sy;
        gg::sample_slopes(plane, t, &sx, &sy);
        gx += dd * w * sx;
        gy += dd * w * sy;
      }
    }
  }
  dgrid[2 * i] = gx * t.sx;
  dgrid[2 * i + 1] = gy * t.sy;
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

}  // namespace

// stack (N, D, C, H, W), grid (N, P, 2) with x then y in [-1, 1], levels
// (N, P), out (N, C, P); all f32 and contiguous, D >= 2. Returns the CUDA
// error code of the launch.
extern "C" int gg_mipmap_sample_fwd(const float* stack, const float* grid,
                                    const float* levels, float* out, int N,
                                    int D, int C, int H, int W, int P,
                                    int padding, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D < 2) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)N * P;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  GG_LAUNCH_BY_PADDING(mipmap_sample_kernel, blocks, threads, s, stack,
                       grid, levels, out, N, D, C, H, W, P);
  return (int)cudaGetLastError();
}

// K3. stack (N, D, C, H, W), grid (N, P, 2), levels (N, P), dout (N, C, P),
// dgrid (N, P, 2), dlevels (N, P); all f32 and contiguous, D >= 2. Returns
// the CUDA error code of the launch.
extern "C" int gg_mipmap_sample_dcoords(const float* stack, const float* grid,
                                        const float* levels, const float* dout,
                                        float* dgrid, float* dlevels, int N,
                                        int D, int C, int H, int W, int P,
                                        int padding, int device,
                                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D < 2) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)N * P;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  GG_LAUNCH_BY_PADDING(mipmap_dcoords_kernel, blocks, threads, s, stack, grid,
                       levels, dout, dgrid, dlevels, N, D, C, H, W, P);
  return (int)cudaGetLastError();
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
