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
  switch (padding) {
    case gg::kBorder:
      mipmap_sample_kernel<gg::kBorder><<<blocks, threads, 0, s>>>(stack, grid, levels, out, N, D, C, H, W, P);
      break;
    case gg::kReflection:
      mipmap_sample_kernel<gg::kReflection><<<blocks, threads, 0, s>>>(stack, grid, levels, out, N, D, C, H, W, P);
      break;
    case gg::kZeros:
      mipmap_sample_kernel<gg::kZeros><<<blocks, threads, 0, s>>>(stack, grid, levels, out, N, D, C, H, W, P);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
