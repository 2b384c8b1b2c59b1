// K6: Gaussian point splat, forward only, as a deterministic tiled gather.
//
// Replaces the TPU kernel gangealing_tpu/ops/splat.py::_splat_kernel
// (launched by splat2d_mxu). That kernel avoids scatters, which are slow on
// a TPU: it builds dense separable Gaussian weight matrices for a block of
// points and contracts them on the MXU in bf16 into an (H, (C+1)*W) canvas.
// This kernel computes the f32 function of
// gangealing_torch/ops/splat.py::splat2d and writes each output value once:
// no accumulator in device memory, no zero-fill, no global atomic, and the
// same bits from run to run.
//
// One block of kThreads threads owns one image, a region of kRegionX x
// kRegionY output tiles of kTile x kTile pixels, and a group of kGroup
// value channels. It culls its image's points in rounds of kPerThread
// points a thread, all loaded before the first test, and lists a point if
// it is visible and its window overlaps the region: the region's list. Then,
// tile by tile, it culls the region's list into the tile's list. Both lists
// hold their points in ascending index, placed by a block-wide prefix sum
// of the keep flags (warp ballots, then a warp's shuffle scan of the
// round's counts), so the order depends only on the input. When the tile's
// list is full the block gathers what it holds and resumes; when the
// region's list is full it is refilled from the first point left out, for
// each tile, so any point count and any density work. A gather first
// writes each listed point's separable weights over the tile's rows and
// columns into shared memory (2 * kTile expf a point instead of kTile^2,
// the same bits whichever thread forms them), then each warp walks its
// 8 x 4 pixel sub-regions, one pixel a lane: a ballot over the list picks
// the points whose window overlaps the sub-region, and each lane adds
// w = gy * gx, w * v for each channel and w to its pixel's sums, over
// those points in ascending order. A point whose window misses the pixel
// adds w = 0. So each pixel's sums are taken in the order the plain
// version's CPU scatter takes them. The epilogue adds the canvas where
// there is one and divides by alpha + 1e-8, or by max(alpha, 1) + 1e-8 for
// the soft channels.
//
// What bounds it: the output, written once (52 MB for the AR path's object
// and mask at batch 50 and 256 x 256), against 5 MB of points and values.
// What it spends its time on (chip_splat_variants.py, PERF.md): the
// region's cull and the output first, then the tile culls, the weights and
// the sums, all held back by the latency of each round's loads and block
// barriers at four blocks an SM. So a warp first tests its points against
// the region widened by 2s + 2, which is cheaper than the exact windows. A
// dense label at sigma 1.2 puts about 0.25 points on a pixel and each
// point on about 40 pixels, so a 16 x 16 tile keeps about a hundred points
// and an 8 x 4 sub-region a few dozen: the sub-region ballot keeps the sums
// near what the points need. The region's cull costs O(regions x points)
// tests, read from L2; the region's list takes the tile culls to shared
// memory.
//
// The window is the exact one of each point on each axis,
// [max(0, floor(p - 2s)), min(size - 1, ceil(p + 2s))], formed in f32 as
// the plain version forms it; the plain version evaluates a static window
// of R = 2 * ceil(2 * max_sigma) + 3 and masks what lies outside, so the
// two agree whenever sigma <= max_sigma, which the callers guarantee. A
// point is skipped unless 0 <= x < W and 0 <= y < H, compared as floats, so
// the invisible points that composed_propagate_object moves to -1e6 never
// reach an integer conversion. Each weight is the plain version's
// exp(norm * (dy * dy)) * exp(norm * (dx * dx)) with norm = -1 / (2 s s),
// multiplied into the values in its order; the library is built with
// -fmad=false and uses expf, so the kernel differs from the plain version
// on the CPU only by expf's last bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 16;          // output tile side
constexpr int kRegionX = 4;        // a block's tiles across
constexpr int kRegionY = 2;        // and down
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;      // points a thread culls in a round
constexpr int kRound = kPerThread * kThreads;
constexpr int kList = 192;         // points a tile's list holds
constexpr int kRegionList = 1536;  // points the region's list holds
constexpr int kGroup = 4;          // value channels a block computes
// A warp sums sub-regions of 8 x 4 pixels, one pixel a lane; warp w takes
// sub-regions w, w + kWarps, ...
constexpr int kSubW = 8;
constexpr int kSubH = 4;
constexpr int kSubsX = kTile / kSubW;
constexpr int kSubsPerWarp = kSubsX * (kTile / kSubH) / kWarps;
static_assert(kSubW * kSubH == 32, "one pixel a lane");
static_assert(kSubsPerWarp * kWarps * 32 == kTile * kTile, "whole tile");
static_assert(kTile <= 256, "window bounds packed in bytes");
static_assert(kPerThread * kWarps <= 32, "a round's counts fit a warp");

constexpr size_t kSharedBytes =
    kList * (sizeof(float4) + 2 * kTile * sizeof(float) + 2 * sizeof(float) +
             sizeof(int)) +
    kRegionList * (sizeof(float2) + sizeof(int));

// The value channels of the hard set (normalised by alpha + 1e-8) and the
// soft set (by max(alpha, 1) + 1e-8): values (N, P, C), canvas (N, C, H, W)
// or null, out (N, C, H, W).
struct Set {
  const float* values;
  const float* canvas;
  float* out;
  int C;
};

// One round's ranks: the place of each kept one of this thread's kPerThread
// candidates, candidate j of thread tid being the round's j * kThreads +
// tid, among the round's kept ones in that order; returns the round's
// count. Each warp scans the (j, warp) counts by shuffles, lane
// j * kWarps + w holding that of (j, w). The caller synchronises the
// block before s_kept is written again.
__device__ __forceinline__ int round_ranks(const bool (&keep)[kPerThread],
                                           int (&rank)[kPerThread],
                                           int* s_kept, int lane, int warp) {
  unsigned ballot[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    ballot[j] = __ballot_sync(0xffffffffu, keep[j]);
    if (lane == 0) s_kept[j * kWarps + warp] = __popc(ballot[j]);
  }
  __syncthreads();
  const int mine = lane < kPerThread * kWarps ? s_kept[lane] : 0;
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    rank[j] = __shfl_sync(0xffffffffu, incl - mine, j * kWarps + warp) +
              __popc(ballot[j] & ((1u << lane) - 1));
  }
  return __shfl_sync(0xffffffffu, incl, 31);
}

__global__ void __launch_bounds__(kThreads, 4)
    splat_tiles_kernel(const float* __restrict__ coords,
                       const float* __restrict__ sigma, Set hard, Set soft,
                       int P, int H, int W, int regions_x) {
  extern __shared__ float4 smem[];
  float4* s_val = smem;                                      // [kList]
  float* s_gy = reinterpret_cast<float*>(s_val + kList);     // [kList][kTile]
  float* s_gx = s_gy + kList * kTile;                        // [kList][kTile]
  float* s_x = s_gx + kList * kTile;                         // [kList]
  float* s_y = s_x + kList;                                  // [kList]
  int* s_win = reinterpret_cast<int*>(s_y + kList);          // [kList]
  float2* s_rxy = reinterpret_cast<float2*>(s_win + kList);  // [kRegionList]
  int* s_ri = reinterpret_cast<int*>(s_rxy + kRegionList);   // [kRegionList]
  __shared__ int s_kept[32];
  __shared__ int s_next;

  const int n = blockIdx.y;
  const int c_first = blockIdx.z * kGroup;
  const int rx0 = (blockIdx.x % regions_x) * (kRegionX * kTile);
  const int ry0 = (blockIdx.x / regions_x) * (kRegionY * kTile);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float s = sigma[n];
  const float length = 2.f * s;
  const float norm = -1.f / (2.f * s * s);
  const float fW = (float)W;
  const float fH = (float)H;
  const float2* xy = reinterpret_cast<const float2*>(coords) + (int64_t)n * P;

  int tx0 = 0, ty0 = 0;  // the tile being summed
  float acc[kSubsPerWarp][kGroup];
  float alpha[kSubsPerWarp];

  // Point i of the image into slot `slot` of the tile's list: its
  // position, its window relative to the tile, its values.
  auto list = [&](int slot, int i, float x, float y) {
    s_x[slot] = x;
    s_y[slot] = y;
    const int t = max((int)floorf(y - length) - ty0, 0);
    const int b = min((int)fminf(fH - 1.f, ceilf(y + length)) - ty0, kTile - 1);
    const int l = max((int)floorf(x - length) - tx0, 0);
    const int r = min((int)fminf(fW - 1.f, ceilf(x + length)) - tx0, kTile - 1);
    s_win[slot] = t | b << 8 | l << 16 | r << 24;
    float v[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int ch = c_first + g;
      v[g] = ch < hard.C ? hard.values[((int64_t)n * P + i) * hard.C + ch]
             : ch - hard.C < soft.C
                 ? soft.values[((int64_t)n * P + i) * soft.C + ch - hard.C]
                 : 0.f;
    }
    s_val[slot] = make_float4(v[0], v[1], v[2], v[3]);
  };

  // The tile list's weights, then each warp's sums over it.
  auto gather = [&](int count) {
    for (int e = tid; e < count * 2 * kTile; e += kThreads) {
      const int k = e / (2 * kTile);
      const int j = e % (2 * kTile);
      const int win = s_win[k];
      const bool row = j < kTile;
      const int at = row ? j : j - kTile;
      const int lo = (win >> (row ? 0 : 16)) & 255;
      const int hi = (win >> (row ? 8 : 24)) & 255;
      float g = 0.f;
      if (at >= lo && at <= hi) {
        const float d = (float)((row ? ty0 : tx0) + at) - (row ? s_y : s_x)[k];
        g = expf(norm * (d * d));
      }
      (row ? s_gy : s_gx)[k * kTile + at] = g;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kSubsPerWarp; ++q) {
      const int sub = warp + q * kWarps;
      const int sx0 = (sub % kSubsX) * kSubW;
      const int sy0 = (sub / kSubsX) * kSubH;
      if (tx0 + sx0 >= W || ty0 + sy0 >= H) continue;  // warp-uniform
      const int col = sx0 + (lane & (kSubW - 1));
      const int row = sy0 + lane / kSubW;
      for (int k0 = 0; k0 < count; k0 += 32) {
        const int k = k0 + lane;
        bool hit = false;
        if (k < count) {
          const int win = s_win[k];
          hit = (win & 255) <= sy0 + kSubH - 1 && ((win >> 8) & 255) >= sy0 &&
                ((win >> 16) & 255) <= sx0 + kSubW - 1 &&
                ((win >> 24) & 255) >= sx0;
        }
        unsigned m = __ballot_sync(0xffffffffu, hit);
        while (m) {
          const int p = k0 + __ffs(m) - 1;
          m &= m - 1;
          const float w = s_gy[p * kTile + row] * s_gx[p * kTile + col];
          const float4 v = s_val[p];
          acc[q][0] += w * v.x;
          acc[q][1] += w * v.y;
          acc[q][2] += w * v.z;
          acc[q][3] += w * v.w;
          alpha[q] += w;
        }
      }
    }
    __syncthreads();
  };

  // The region list: the visible points of [from, P) whose window overlaps
  // the region, in index order, until it is full. Returns their count and
  // sets `next` to the first point left out (P if none is). A window
  // [max(0, floor(p - 2s)), min(size - 1, ceil(p + 2s))] overlaps
  // [lo, hi] iff floor(p - 2s) <= hi and ceil(p + 2s) >= lo, since
  // 0 <= lo <= hi and lo <= size - 1; such a p lies within 2s + 2 of
  // [lo, hi], a cheaper test that a warp makes first.
  auto fill_region = [&](int from, int& next) {
    const float x1 = (float)(rx0 + kRegionX * kTile - 1);
    const float y1 = (float)(ry0 + kRegionY * kTile - 1);
    const float near_x0 = (float)rx0 - length - 2.f, near_x1 = x1 + length + 2.f;
    const float near_y0 = (float)ry0 - length - 2.f, near_y1 = y1 + length + 2.f;
    int rcount = 0;
    next = P;
    for (int base = from; base < P; base += kRound) {
      float2 p[kPerThread];
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int i = base + j * kThreads + tid;
        p[j] = i < P ? xy[i] : make_float2(-1.f, -1.f);  // not visible
      }
      bool keep[kPerThread];
      bool any = false;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const float x = p[j].x, y = p[j].y;
        keep[j] = x >= 0.f && x < fW && y >= 0.f && y < fH && x > near_x0 &&
                  x < near_x1 && y > near_y0 && y < near_y1;
        any = any || keep[j];
      }
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const float x = p[j].x, y = p[j].y;
          keep[j] = keep[j] && floorf(y - length) <= y1 &&
                    ceilf(y + length) >= (float)ry0 &&
                    floorf(x - length) <= x1 && ceilf(x + length) >= (float)rx0;
        }
      }
      int rank[kPerThread];
      const int total = round_ranks(keep, rank, s_kept, lane, warp);
      const int take = min(total, kRegionList - rcount);
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (!keep[j]) continue;
        const int i = base + j * kThreads + tid;
        if (rank[j] < take) {
          s_rxy[rcount + rank[j]] = p[j];
          s_ri[rcount + rank[j]] = i;
        } else if (rank[j] == take) {
          s_next = i;
        }
      }
      rcount += take;
      __syncthreads();
      if (take < total) {  // the same for every thread
        next = s_next;
        break;
      }
    }
    return rcount;
  };

  int rcount = 0, rnext = 0;
  bool whole = false;  // the region list holds all the region's points
  for (int tile = 0; tile < kRegionX * kRegionY; ++tile) {
    tx0 = rx0 + (tile % kRegionX) * kTile;
    ty0 = ry0 + (tile / kRegionX) * kTile;
    if (tx0 >= W || ty0 >= H) continue;  // the same for every thread
#pragma unroll
    for (int q = 0; q < kSubsPerWarp; ++q) {
      alpha[q] = 0.f;
#pragma unroll
      for (int c = 0; c < kGroup; ++c) acc[q][c] = 0.f;
    }
    const float tile_x1 = (float)(tx0 + kTile - 1);
    const float tile_y1 = (float)(ty0 + kTile - 1);
    int count = 0;
    for (int from = 0;;) {
      if (!whole) {
        rcount = fill_region(from, rnext);
        whole = from == 0 && rnext >= P;
      }
      // The tile's points among the region list's, in its order, into the
      // tile's list, gathering whenever it is full.
      for (int base = 0; base < rcount; base += kRound) {
        float2 p[kPerThread];
        bool keep[kPerThread];
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) {
          const int e = base + j * kThreads + tid;
          p[j] = e < rcount ? s_rxy[e] : make_float2(-1e30f, -1e30f);
          keep[j] = e < rcount && floorf(p[j].y - length) <= tile_y1 &&
                    ceilf(p[j].y + length) >= (float)ty0 &&
                    floorf(p[j].x - length) <= tile_x1 &&
                    ceilf(p[j].x + length) >= (float)tx0;
        }
        int rank[kPerThread];
        const int total = round_ranks(keep, rank, s_kept, lane, warp);
        for (int placed = 0;;) {
          const int take = min(total - placed, kList - count);
#pragma unroll
          for (int j = 0; j < kPerThread; ++j) {
            const int r = rank[j] - placed;
            if (keep[j] && r >= 0 && r < take) {
              list(count + r, s_ri[base + j * kThreads + tid], p[j].x,
                   p[j].y);
            }
          }
          count += take;
          placed += take;
          if (placed == total) break;  // the same for every thread
          __syncthreads();
          gather(count);
          count = 0;
        }
        __syncthreads();
      }
      if (rnext >= P) break;
      from = rnext;
    }
    if (count > 0) gather(count);

#pragma unroll
    for (int q = 0; q < kSubsPerWarp; ++q) {
      const int sub = warp + q * kWarps;
      const int px = tx0 + (sub % kSubsX) * kSubW + (lane & (kSubW - 1));
      const int py = ty0 + (sub / kSubsX) * kSubH + lane / kSubW;
      if (px >= W || py >= H) continue;
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        const int ch = c_first + c;
        const bool is_hard = ch < hard.C;
        const int sc = is_hard ? ch : ch - hard.C;
        if (!is_hard && sc >= soft.C) break;
        const int C = is_hard ? hard.C : soft.C;
        const float* canvas = is_hard ? hard.canvas : soft.canvas;
        const int64_t idx = (((int64_t)n * C + sc) * H + py) * W + px;
        float sum = acc[q][c];
        if (canvas != nullptr) sum = sum + canvas[idx];
        const float a = is_hard ? alpha[q] : fmaxf(alpha[q], 1.f);
        (is_hard ? hard.out : soft.out)[idx] = sum / (a + 1e-8f);
      }
    }
  }
}

}  // namespace

// coords (N, P, 2) with x then y in pixels, sigma (N,); the hard set's
// values (N, P, Ch), canvas (N, Ch, H, W) or null and out (N, Ch, H, W),
// divided by alpha + 1e-8; the soft set's (Cs channels) likewise, divided
// by max(alpha, 1) + 1e-8. Either set may have no channels, and its
// pointers are then not read. All f32 and contiguous. One launch for both
// sets; returns the CUDA error code of the launch.
extern "C" int gg_splat_fwd(const float* coords, const float* sigma,
                            const float* hard_values, const float* hard_canvas,
                            float* hard_out, const float* soft_values,
                            const float* soft_canvas, float* soft_out, int N,
                            int P, int Ch, int Cs, int H, int W, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || H == 0 || W == 0 || Ch + Cs == 0) return (int)cudaSuccess;
  err = cudaFuncSetAttribute(splat_tiles_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSharedBytes);
  if (err != cudaSuccess) return (int)err;
  const int regions_x = (W + kRegionX * kTile - 1) / (kRegionX * kTile);
  const int regions_y = (H + kRegionY * kTile - 1) / (kRegionY * kTile);
  const dim3 grid(regions_x * regions_y, N, (Ch + Cs + kGroup - 1) / kGroup);
  splat_tiles_kernel<<<grid, kThreads, kSharedBytes, (cudaStream_t)stream>>>(
      coords, sigma, Set{hard_values, hard_canvas, hard_out, Ch},
      Set{soft_values, soft_canvas, soft_out, Cs}, P, H, W, regions_x);
  return (int)cudaGetLastError();
}
