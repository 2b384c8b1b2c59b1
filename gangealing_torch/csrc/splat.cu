// K6: Gaussian point splat, forward only.
//
// Replaces the TPU kernel gangealing_tpu/ops/splat.py::_splat_kernel
// (launched by splat2d_mxu). That kernel avoids scatters, which are slow on
// a TPU: it builds dense separable Gaussian weight matrices for a block of
// points and contracts them on the MXU in bf16 into an (H, (C+1)*W) canvas.
// On Hopper a scatter is cheap, so this kernel computes the f32 function of
// gangealing_torch/ops/splat.py::splat2d directly, as the reference CUDA
// kernel does (utils/splat2d_cuda, splat_gpu_impl.cu:36-96): one thread per
// (image, point) walks the point's footprint window and adds its weighted
// values and its weight into the accumulator with atomicAdd.
//
// What bounds it here: the atomics. Each point of a dense label adds C+1
// floats to each of the (4 sigma + 3)^2 pixels of its window at most
// (about 30 to 36 pixels at sigma 1.2), into an accumulator of
// N x (C+1) x H x W floats that stays in the 50 MB L2 for the AR path's
// shapes; neighbouring points of a label hit neighbouring pixels, so
// atomics on one address queue behind each other. The output (the
// accumulator) is written once in device memory. A tiled design that
// accumulates a block of points in shared memory, and is deterministic, is
// later work.
//
// The window is the exact one of each point, [max(0, floor(p - 2s)),
// min(size - 1, ceil(p + 2s))] on each axis; the plain version evaluates a
// static window of R = 2 * ceil(2 * max_sigma) + 3 and masks what lies
// outside. The two agree whenever sigma <= max_sigma, which the callers
// guarantee. A point is skipped unless 0 <= x < W and 0 <= y < H, compared
// as floats, so the invisible points that composed_propagate_object moves to
// -1e6 never reach an integer conversion. Each weight is computed in the
// plain version's order, exp(norm * (py - y)^2) * exp(norm * (px - x)^2)
// with norm = -1 / (2 s s); the library is built with -fmad=false and uses
// expf, so the only differences from the plain version are the order of the
// sums, which the atomics change from run to run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void splat_kernel(const float* __restrict__ coords,
                             const float* __restrict__ values,
                             const float* __restrict__ sigma,
                             float* __restrict__ acc, int N, int P, int C,
                             int H, int W) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)N * P) return;
  const int64_t n = i / P;
  const float x = coords[2 * i];
  const float y = coords[2 * i + 1];
  if (!(x >= 0.f && x < (float)W && y >= 0.f && y < (float)H)) return;
  const float s = sigma[n];
  const float length = 2.f * s;
  const float norm = -1.f / (2.f * s * s);
  const int t = (int)fmaxf(0.f, floorf(y - length));
  const int b = (int)fminf((float)H - 1.f, ceilf(y + length));
  const int l = (int)fmaxf(0.f, floorf(x - length));
  const int r = (int)fminf((float)W - 1.f, ceilf(x + length));
  const float* v = values + i * C;
  const int64_t hw = (int64_t)H * W;
  float* dst = acc + n * (C + 1) * hw;
  for (int py = t; py <= b; ++py) {
    const float dy = (float)py - y;
    const float gy = expf(norm * (dy * dy));
    for (int px = l; px <= r; ++px) {
      const float dx = (float)px - x;
      const float gx = expf(norm * (dx * dx));
      const float w = gy * gx;
      float* pix = dst + (int64_t)py * W + px;
      for (int c = 0; c < C; ++c) {
        atomicAdd(pix + c * hw, w * v[c]);
      }
      atomicAdd(pix + C * hw, w);
    }
  }
}

}  // namespace

// coords (N, P, 2) with x then y in pixels, values (N, P, C), sigma (N,),
// acc (N, C + 1, H, W) zero-filled by the caller, alpha as its last
// channel; all f32 and contiguous. Returns the CUDA error code of the
// launch.
extern "C" int gg_splat_fwd(const float* coords, const float* values,
                            const float* sigma, float* acc, int N, int P,
                            int C, int H, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int64_t total = (int64_t)N * P;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  splat_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      coords, values, sigma, acc, N, P, C, H, W);
  return (int)cudaGetLastError();
}
