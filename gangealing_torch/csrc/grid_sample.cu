// K2: bilinear grid sample, forward.
//
// Replaces the TPU kernel gangealing_tpu/ops/pallas_grid_sample.py::_fwd_kernel
// (launched by _pallas_sample). That kernel builds dense tent-weight matrices
// and contracts them on the MXU because gathers are slow on a TPU. On Hopper
// a direct gather is the natural form: 4 taps per point and channel.
//
// What bounds it here: gather latency and bytes. Each point reads 4 taps x C
// channels at data-dependent addresses and writes C floats. The source image
// (N x C x H x W f32, 0.8 MB per image at 3 x 256 x 256) stays mostly in the
// 50 MB L2, so the taps are L2 hits; the grid read and the output write are
// the device-memory traffic. The design: one thread per output point, with
// neighbouring threads on neighbouring points, so the grid reads and the
// output writes coalesce; the coordinates and the 4 corner offsets and
// weights are computed once per point and reused for every channel.
// Shared-memory tiling of the source is later work.

#include <cuda_runtime.h>

#include "bilinear.cuh"

namespace {

template <int PAD>
__global__ void grid_sample_kernel(const float* __restrict__ img,
                                   const float* __restrict__ grid,
                                   float* __restrict__ out, int N, int C,
                                   int H, int W, int P) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)N * P) return;
  const int64_t n = i / P;
  const int64_t p = i - n * P;
  const gg::Taps t = gg::make_taps<PAD>(grid[2 * i], grid[2 * i + 1], H, W);
  const int64_t hw = (int64_t)H * W;
  const float* src = img + n * C * hw;
  float* dst = out + n * C * P + p;
  for (int c = 0; c < C; ++c) {
    dst[(int64_t)c * P] = gg::sample(src + c * hw, t);
  }
}

}  // namespace

// img (N, C, H, W), grid (N, P, 2) with x then y in [-1, 1], out (N, C, P);
// all f32 and contiguous. Returns the CUDA error code of the launch.
extern "C" int gg_grid_sample_fwd(const float* img, const float* grid,
                                  float* out, int N, int C, int H, int W,
                                  int P, int padding, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)N * P;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (padding) {
    case gg::kBorder:
      grid_sample_kernel<gg::kBorder><<<blocks, threads, 0, s>>>(img, grid, out, N, C, H, W, P);
      break;
    case gg::kReflection:
      grid_sample_kernel<gg::kReflection><<<blocks, threads, 0, s>>>(img, grid, out, N, C, H, W, P);
      break;
    case gg::kZeros:
      grid_sample_kernel<gg::kZeros><<<blocks, threads, 0, s>>>(img, grid, out, N, C, H, W, P);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
