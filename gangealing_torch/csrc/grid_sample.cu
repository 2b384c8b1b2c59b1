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
//
// K4: d/dgrid, backward. Replaces pallas_grid_sample.py::_dcoords_kernel,
// which contracts tent-derivative matrices on the MXU. Here, one thread per
// point again: it recomputes the taps and their derivative weights, reads
// the same 4 x C taps and C values of dout, and chains d/dx and d/dy
// through the padding rule and the unnormalise step (bilinear.cuh
// source_coord), under JAX's rules: the right derivative at an integer
// coordinate, half the gradient on a clamp bound, reflection's sign flips.
// Bounded like K2, by the tap gathers (L2) plus the dout read.
//
// K5b: d/dimage, backward. Replaces pallas_grid_sample.py::_dimg_kernel,
// which accumulates a wy^T matmul over point blocks in VMEM and is
// deterministic. Here each point scatters dout x its 4 corner weights into
// d/dimage with atomicAdd (one thread per point, C channels): simple, but
// the order of the sums changes from run to run, so the last bits do.
// Bounded by the atomics' L2 traffic. The autograd Function launches it
// only when the image needs a gradient; in the GANgealing step it does not.

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

template <int PAD>
__global__ void grid_sample_dgrid_kernel(const float* __restrict__ img,
                                         const float* __restrict__ grid,
                                         const float* __restrict__ dout,
                                         float* __restrict__ dgrid, int N,
                                         int C, int H, int W, int P) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)N * P) return;
  const int64_t n = i / P;
  const int64_t p = i - n * P;
  const gg::Taps t = gg::make_taps<PAD>(grid[2 * i], grid[2 * i + 1], H, W);
  const int64_t hw = (int64_t)H * W;
  const float* src = img + n * C * hw;
  const float* g = dout + n * C * P + p;
  float gx = 0.f, gy = 0.f;
  for (int c = 0; c < C; ++c) {
    float sx, sy;
    gg::sample_slopes(src + c * hw, t, &sx, &sy);
    const float d = g[(int64_t)c * P];
    gx += d * sx;
    gy += d * sy;
  }
  dgrid[2 * i] = gx * t.sx;
  dgrid[2 * i + 1] = gy * t.sy;
}

template <int PAD>
__global__ void grid_sample_dimg_kernel(const float* __restrict__ grid,
                                        const float* __restrict__ dout,
                                        float* __restrict__ dimg, int N, int C,
                                        int H, int W, int P) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)N * P) return;
  const int64_t n = i / P;
  const int64_t p = i - n * P;
  const gg::Taps t = gg::make_taps<PAD>(grid[2 * i], grid[2 * i + 1], H, W);
  const int64_t hw = (int64_t)H * W;
  float* dst = dimg + n * C * hw;
  const float* g = dout + n * C * P + p;
  for (int c = 0; c < C; ++c) {
    gg::scatter(dst + c * hw, t, g[(int64_t)c * P]);
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
  GG_LAUNCH_BY_PADDING(grid_sample_kernel, blocks, threads, s, img, grid,
                       out, N, C, H, W, P);
  return (int)cudaGetLastError();
}

// K4. img (N, C, H, W), grid (N, P, 2), dout (N, C, P), dgrid (N, P, 2);
// all f32 and contiguous. Returns the CUDA error code of the launch.
extern "C" int gg_grid_sample_dgrid(const float* img, const float* grid,
                                    const float* dout, float* dgrid, int N,
                                    int C, int H, int W, int P, int padding,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)N * P;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  GG_LAUNCH_BY_PADDING(grid_sample_dgrid_kernel, blocks, threads, s, img,
                       grid, dout, dgrid, N, C, H, W, P);
  return (int)cudaGetLastError();
}

// K5b. grid (N, P, 2), dout (N, C, P), dimg (N, C, H, W) zero-filled by
// the caller; all f32 and contiguous. Returns the CUDA error code.
extern "C" int gg_grid_sample_dimg(const float* grid, const float* dout,
                                   float* dimg, int N, int C, int H, int W,
                                   int P, int padding, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)N * P;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  GG_LAUNCH_BY_PADDING(grid_sample_dimg_kernel, blocks, threads, s, grid,
                       dout, dimg, N, C, H, W, P);
  return (int)cudaGetLastError();
}
