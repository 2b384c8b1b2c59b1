// K2: bilinear grid sample, forward.
//
// Replaces the TPU kernel gangealing_tpu/ops/pallas_grid_sample.py::_fwd_kernel
// (launched by _pallas_sample). That kernel builds dense tent-weight matrices
// and contracts them on the MXU because gathers are slow on a TPU. On Hopper
// a direct gather is the natural form: 4 taps per point and channel.
//
// What bounds it on the main path's two shapes: the AR app samples its flow
// grid, (50, 2, 128, 128) held as a permuted (N, H, W, 2) tensor, at 4,060
// label points an image (models/stn.py::sample_grid_at_points): about 5 MB
// of texels, grid and output, a bound near 1.5 us, so the launch and the
// latency of one round of gathers bound it. The antialias=False warp samples
// a (40, 3, 256, 256) source at 128 x 128 points a head: about 44 MB, a
// bound near 13 us, with every tap an L2 hit (the source fits the 50 MB L2)
// and the grid read and output write the device-memory traffic.
//
// The design: the kernel reads the layout its caller holds, so the AR grid
// reaches it without the 6.6 MB copy a contiguous() made: NCHW planes, or
// packed texels (channels_last strides), read as one float2 a corner for 2
// channels and one float4 for 4. A block is a tile of 4 output rows of 64
// points, each thread two neighbouring points of a row: one float4 grid
// load, two float2 stores a channel, and a warp's taps fall on neighbouring
// source texels that share cache lines. A grid narrower than 64 points is
// walked in rows of 64 in its memory order. The taps come from
// gg::make_taps and each channel sums its four corners in the plain
// version's order, so with -fmad=false the result equals plain grid_sample
// to the bit.
//
// K4: d/dgrid, backward. Replaces pallas_grid_sample.py::_dcoords_kernel,
// which contracts tent-derivative matrices on the MXU. Here, one thread per
// point again: it recomputes the taps and their derivative weights, reads
// the same 4 x C taps and C values of dout, and chains d/dx and d/dy
// through the padding rule and the unnormalise step (bilinear.cuh
// source_coord), under JAX's rules: the right derivative at an integer
// coordinate, half the gradient on a clamp bound, reflection's sign flips.
// Bounded like K2, by the tap gathers (L2) plus the dout read. It takes
// NCHW planes; the autograd Function hands it a contiguous image.
//
// K5b: d/dimage, backward. Replaces pallas_grid_sample.py::_dimg_kernel,
// which accumulates WY^T @ (dout * WX) in VMEM over a sequential grid of
// point blocks and so is deterministic. Here it is a binned gather with no
// atomics and no zero-fill, the same to the bit from run to run:
//  1. bin (binned.cuh, shared with K5a): each point's key is the tile
//     (kTileW x kTileH texels) of its top-left clamped tap, times 4
//     classes that say whether that tap lies on the tile's last row, last
//     column or both (then the footprint also reaches the tile below, right
//     or diagonal, since a clamped corner lies at most one texel right and
//     one down). A point whose four weights are 0 (zeros padding) reaches
//     nothing and has no key. One cluster of blocks an image sorts the
//     points into per-key buckets in point order with no atomics, counting
//     the keys in passes, so no image size is refused, and writes the
//     image's work list: each tile's candidates (its own bucket and its
//     left, upper and upper-left neighbours' edge classes) cut into work
//     items of kSlots candidates.
//  2. gather: one warp an item, with no block-wide barrier. It loads its
//     candidates' indices, then their coordinates and first kGroup
//     channels of dout (all loads of a step issued together), sorts the
//     candidates stably by the local position of their top-left tap
//     ((kTileW + 1) x (kTileH + 1) keys) and stores each at its sorted
//     place in shared memory with the weight it puts on each of the four
//     texels it reaches (its corners' weights summed in corner order where
//     a clamp folds two onto one texel). Then each lane sums its texels'
//     contributions from the four runs that can reach each, in a fixed
//     order (the runs, the points in index order), kGroup channels a pass,
//     and writes every texel of the tile, zero where nothing lands.
//  3. merge: a split tile's first item wrote its sums into d/dimage and
//     the others into scratch, which this adds in item order.
// What bounds it: not the bytes (the dout and grid reads and the d/dimage
// write, about 6.3 us at the train step's shapes on an H100) but three
// launches and, in each kernel, the latency of a chain of dependent loads,
// groupings and scans (chip_grid_sample_variants.py splits the time by
// kernel). The design answers with many independent chains: the gather
// holds each item's candidates in registers and shared memory with no
// block-wide barrier, a warp an item, and small 16 x 4 tiles keep its
// registers few and many warps in flight. Skew makes long runs: a texel
// onto which border padding clamps thousands of points sums them one
// after another, so an item holds few candidates and a heavy tile spreads
// over several warps. The scratch (bucketed indices, work lists, partial
// tiles) is allocated by the caller.

#include <cuda_runtime.h>

#include <cstdint>

#include "bilinear.cuh"
#include "binned.cuh"

namespace {

// K2's layouts of the image: NCHW planes; packed texels of C channels
// (channels_last), read channel by channel, as one float2 (C = 2) or as one
// float4 (C = 4).
enum Layout : int { kPlanes = 0, kTexels = 1, kTexels2 = 2, kTexels4 = 4 };

constexpr int kRowPoints = 64;  // a K2 tile's points along a row
constexpr int kTileRows = 4;    // and its rows

__device__ __forceinline__ float2 sample2(const float2* __restrict__ texels,
                                          const gg::Taps& t) {
  const float2 a = texels[t.off[0]], b = texels[t.off[1]];
  const float2 c = texels[t.off[2]], d = texels[t.off[3]];
  return make_float2(a.x * t.w[0] + b.x * t.w[1] + c.x * t.w[2] + d.x * t.w[3],
                     a.y * t.w[0] + b.y * t.w[1] + c.y * t.w[2] + d.y * t.w[3]);
}

__device__ __forceinline__ float4 sample4(const float4* __restrict__ texels,
                                          const gg::Taps& t) {
  const float4 a = texels[t.off[0]], b = texels[t.off[1]];
  const float4 c = texels[t.off[2]], d = texels[t.off[3]];
  return make_float4(a.x * t.w[0] + b.x * t.w[1] + c.x * t.w[2] + d.x * t.w[3],
                     a.y * t.w[0] + b.y * t.w[1] + c.y * t.w[2] + d.y * t.w[3],
                     a.z * t.w[0] + b.z * t.w[1] + c.z * t.w[2] + d.z * t.w[3],
                     a.w * t.w[0] + b.w * t.w[1] + c.w * t.w[2] + d.w * t.w[3]);
}

// One channel of packed texels of C channels.
__device__ __forceinline__ float sample_texels(const float* __restrict__ base,
                                               const gg::Taps& t, int C) {
  return base[(int64_t)t.off[0] * C] * t.w[0] +
         base[(int64_t)t.off[1] * C] * t.w[1] +
         base[(int64_t)t.off[2] * C] * t.w[2] +
         base[(int64_t)t.off[3] * C] * t.w[3];
}

// The P = rows x cols points of an image are walked as rows of `cols`
// (the last may be short); thread (x, y) of block (bx, by, n) takes points
// 2x and 2x + 1 of row by * kTileRows + y from column bx * kRowPoints.
// `vec`: cols and P are even and the grid 16-byte aligned, so a thread's
// two points are one float4 of the grid and one float2 of each output row.
template <int PAD, int LAYOUT>
__global__ void __launch_bounds__(32 * kTileRows)
    grid_sample_kernel(const float* __restrict__ img,
                       const float* __restrict__ grid, float* __restrict__ out,
                       int C, int H, int W, int P, int cols, int vec) {
  const int n = blockIdx.z;
  const int col = blockIdx.x * kRowPoints + 2 * threadIdx.x;
  const int64_t p =
      (int64_t)(blockIdx.y * kTileRows + threadIdx.y) * cols + col;
  if (col >= cols || p >= P) return;
  const bool two = col + 1 < cols && p + 1 < P;
  const float* g = grid + ((int64_t)n * P + p) * 2;
  float gx0, gy0, gx1 = 0.f, gy1 = 0.f;
  if (vec) {
    const float4 v = *reinterpret_cast<const float4*>(g);
    gx0 = v.x, gy0 = v.y, gx1 = v.z, gy1 = v.w;
  } else {
    gx0 = g[0], gy0 = g[1];
    if (two) gx1 = g[2], gy1 = g[3];
  }
  const gg::Taps t0 = gg::make_taps<PAD>(gx0, gy0, H, W);
  const gg::Taps t1 = gg::make_taps<PAD>(gx1, gy1, H, W);
  const int64_t hw = (int64_t)H * W;
  float* dst = out + (int64_t)n * C * P + p;
  auto store = [&](int c, float a, float b) {
    float* d = dst + (int64_t)c * P;
    if (vec) {
      *reinterpret_cast<float2*>(d) = make_float2(a, b);
    } else {
      d[0] = a;
      if (two) d[1] = b;
    }
  };
  if (LAYOUT == kPlanes) {
    const float* src = img + n * C * hw;
    for (int c = 0; c < C; ++c) {
      store(c, gg::sample(src + c * hw, t0), gg::sample(src + c * hw, t1));
    }
  } else if (LAYOUT == kTexels2) {
    const float2* src = reinterpret_cast<const float2*>(img) + n * hw;
    const float2 a = sample2(src, t0), b = sample2(src, t1);
    store(0, a.x, b.x);
    store(1, a.y, b.y);
  } else if (LAYOUT == kTexels4) {
    const float4* src = reinterpret_cast<const float4*>(img) + n * hw;
    const float4 a = sample4(src, t0), b = sample4(src, t1);
    store(0, a.x, b.x);
    store(1, a.y, b.y);
    store(2, a.z, b.z);
    store(3, a.w, b.w);
  } else {
    const float* src = img + n * C * hw;
    for (int c = 0; c < C; ++c) {
      store(c, sample_texels(src + c, t0, C), sample_texels(src + c, t1, C));
    }
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

template <int LAYOUT>
int launch_k2(dim3 blocks, dim3 threads, cudaStream_t s, int padding,
              const float* img, const float* grid, float* out, int C, int H,
              int W, int P, int cols, int vec) {
  switch (padding) {
    case gg::kBorder:
      grid_sample_kernel<gg::kBorder, LAYOUT><<<blocks, threads, 0, s>>>(
          img, grid, out, C, H, W, P, cols, vec);
      break;
    case gg::kReflection:
      grid_sample_kernel<gg::kReflection, LAYOUT><<<blocks, threads, 0, s>>>(
          img, grid, out, C, H, W, P, cols, vec);
      break;
    case gg::kZeros:
      grid_sample_kernel<gg::kZeros, LAYOUT><<<blocks, threads, 0, s>>>(
          img, grid, out, C, H, W, P, cols, vec);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---- K5b ----

constexpr int kFine = (kTileW + 1) * (kTileH + 1);  // local keys of an item
constexpr int kGroup = 4;      // channels a gather pass sums (a float4)

// A gather warp's shared memory: per candidate, in the order of its
// sorted position, the weight it puts on each texel it reaches (wq.x, .y,
// .z, .w for the offsets (dx, dy) = (0, 0), (1, 0), (0, 1), (1, 1) from
// its top-left tap), kGroup channels of dout and its point; per local key
// its count, its run's start and a running position.
struct ItemShared {
  float4 wq[kSlots];
  float4 g[kSlots];
  int pt[kSlots];
  unsigned short cnt[kFine];
  unsigned short run[kFine + 1];
  unsigned short pos[kFine];
};
constexpr size_t kItemShared = (sizeof(ItemShared) + 15) & ~(size_t)15;

// K5b's bin keys: one entry a point, the tile of its top-left clamped
// tap; a point whose four weights are 0 (zeros padding) reaches nothing
// and has none.
template <int PAD>
struct DimgKeys {
  static constexpr int kEntries = 1;
  using Point = float2;
  const float2* grid;
  Tiling tl;
  int P, H, W;

  __device__ __forceinline__ float2 load(int n, int i) const {
    return grid[(int64_t)n * P + i];
  }
  __device__ __forceinline__ void keys(float2 g, int (&key)[1]) const {
    const gg::Taps t = gg::make_taps<PAD>(g.x, g.y, H, W);
    if (t.w[0] == 0.f && t.w[1] == 0.f && t.w[2] == 0.f && t.w[3] == 0.f) {
      return;
    }
    const int ky = t.off[0] / W, kx = t.off[0] - ky * W;
    key[0] = tile_key(tl, 0, ky, kx, 2);
  }
};

// Each warp walks the image's work items on its own: item i is tile t's
// candidates [s * kSlots, (s + 1) * kSlots) of its list, s = i - first[t].
template <int PAD>
__global__ void __launch_bounds__(kGatherWarps * 32)
    dimg_gather_kernel(const float* __restrict__ grid,
                       const float* __restrict__ dout,
                       const int* __restrict__ order, char* __restrict__ work,
                       float* __restrict__ partial, float* __restrict__ dimg,
                       int C, int P, int H, int W, int tiles_x, int tiles_y,
                       int extra) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ItemShared& sh = *reinterpret_cast<ItemShared*>(
      reinterpret_cast<char*>(smem) + warp * kItemShared);
  const int n = blockIdx.y;
  const int nt = tiles_x * tiles_y;
  const Work wk = work_of(work, nt, extra, n);
  const int n_items = wk.first[nt];
  const float2* pts = reinterpret_cast<const float2*>(grid) + (int64_t)n * P;
  const int* ord = order + (int64_t)n * P;
  const float* dn = dout + (int64_t)n * C * P;
  const int64_t hw = (int64_t)H * W;
  for (int i = blockIdx.x * kGatherWarps + warp; i < n_items;
       i += gridDim.x * kGatherWarps) {
    const int t = wk.item_tile[i], s = i - wk.first[t];
    const int4 start = wk.seg[2 * t], len = wk.seg[2 * t + 1];
    const int v0 = s * kSlots;
    const int m = min(len.x + len.y + len.z + len.w - v0, kSlots);
    const int x0 = (t % tiles_x) * kTileW, y0 = (t / tiles_x) * kTileH;

    // The candidates' indices, then their coordinates (all loads of a step
    // issued together).
    int p[kSlotRounds];
#pragma unroll
    for (int r = 0; r < kSlotRounds; ++r) {
      const int j = r * 32 + lane;
      p[r] = j < m ? candidate(ord, start, len, v0 + j) : -1;
    }
    float2 g[kSlotRounds];
#pragma unroll
    for (int r = 0; r < kSlotRounds; ++r) {
      g[r] = p[r] >= 0 ? pts[p[r]] : make_float2(0.f, 0.f);
    }
    for (int k = lane; k < kFine; k += 32) sh.cnt[k] = 0;
    __syncwarp();
    // The local key of each candidate's top-left tap; each key's count.
    int key[kSlotRounds];
#pragma unroll
    for (int r = 0; r < kSlotRounds; ++r) {
      key[r] = -1;
      if (p[r] >= 0) {
        const gg::Taps tp = gg::make_taps<PAD>(g[r].x, g[r].y, H, W);
        const int ky = tp.off[0] / W, kx = tp.off[0] - ky * W;
        key[r] = (ky - y0 + 1) * (kTileW + 1) + (kx - x0 + 1);
      }
      const Group gr = group_of(key[r]);
      if (key[r] >= 0 && gr.lead) {
        sh.cnt[key[r]] += (unsigned short)__popc(gr.mask);
      }
      __syncwarp();
    }
    float d[kSlotRounds][kGroup];  // dout's first channels, loaded now
#pragma unroll
    for (int r = 0; r < kSlotRounds; ++r) {
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        d[r][c] = p[r] >= 0 && c < C ? dn[(int64_t)c * P + p[r]] : 0.f;
      }
    }
    warp_scan<kFine>(sh.cnt, sh.run, lane);
    for (int k = lane; k < kFine; k += 32) sh.pos[k] = sh.run[k];
    __syncwarp();
    // Each candidate at its sorted place: the weight of the corners that
    // land on each of the four texels it reaches, summed in corner order
    // (corners 1 and 3 lie one texel right of the top-left tap and 2 and 3
    // one down, unless a clamp folds them onto it), dout and the point.
#pragma unroll
    for (int r = 0; r < kSlotRounds; ++r) {
      const Group gr = group_of(key[r]);
      if (key[r] >= 0) {
        const int at = sh.pos[key[r]] + rank_in(gr);
        const gg::Taps tp = gg::make_taps<PAD>(g[r].x, g[r].y, H, W);
        const bool cx = tp.off[1] != tp.off[0], cy = tp.off[2] != tp.off[0];
        float w0 = tp.w[0], w1 = cx ? tp.w[1] : 0.f, w2 = cy ? tp.w[2] : 0.f;
        if (!cx) w0 += tp.w[1];
        if (!cy) w0 += tp.w[2];
        if (!cx && !cy) w0 += tp.w[3];
        if (cx && !cy) w1 += tp.w[3];
        if (cy && !cx) w2 += tp.w[3];
        sh.wq[at] = make_float4(w0, w1, w2, cx && cy ? tp.w[3] : 0.f);
        sh.g[at] = make_float4(d[r][0], d[r][1], d[r][2], d[r][3]);
        sh.pt[at] = p[r];
      }
      __syncwarp();
      if (key[r] >= 0 && gr.lead) {
        sh.pos[key[r]] += (unsigned short)__popc(gr.mask);
      }
      __syncwarp();
    }

    // Texel (ly, lx) is reached from the top-left taps at (ly, lx), (ly,
    // lx - 1), (ly - 1, lx) and (ly - 1, lx - 1): local keys offset by one.
    const int placed = sh.run[kFine];
    for (int c0 = 0; c0 < C; c0 += kGroup) {
      if (c0 > 0) {
        for (int j = lane; j < placed; j += 32) {
          float v[kGroup];
#pragma unroll
          for (int c = 0; c < kGroup; ++c) {
            v[c] = c0 + c < C ? dn[(int64_t)(c0 + c) * P + sh.pt[j]] : 0.f;
          }
          sh.g[j] = make_float4(v[0], v[1], v[2], v[3]);
        }
        __syncwarp();
      }
#pragma unroll
      for (int te = 0; te < kTileTexels / 32; ++te) {
        const int e = te * 32 + lane;
        const int ly = e / kTileW, lx = e % kTileW;
        float acc[kGroup];
#pragma unroll
        for (int c = 0; c < kGroup; ++c) acc[c] = 0.f;
        // the taps one row up (dy = 1), then on its row; each row's two
        // keys, one column left (dx = 1) and on its column, are adjacent
#pragma unroll
        for (int dy = 1; dy >= 0; --dy) {
          const int k = (ly - dy + 1) * (kTileW + 1) + lx;
          const int mid = sh.run[k + 1], end = sh.run[k + 2];
#pragma unroll 2
          for (int j = sh.run[k]; j < end; ++j) {
            const float4 w4 = sh.wq[j];
            const float w = j < mid ? (dy ? w4.w : w4.y) : (dy ? w4.z : w4.x);
            const float4 g4 = sh.g[j];
            acc[0] += g4.x * w;
            acc[1] += g4.y * w;
            acc[2] += g4.z * w;
            acc[3] += g4.w * w;
          }
        }
        const int y = y0 + ly, x = x0 + lx;
        if (y < H && x < W) {
#pragma unroll
          for (int c = 0; c < kGroup; ++c) {
            if (c0 + c >= C) break;
            if (s == 0) {
              dimg[((int64_t)n * C + c0 + c) * hw + (int64_t)y * W + x] =
                  acc[c];
            } else {
              const int64_t slot = (int64_t)n * extra + (i - t - 1);
              partial[(slot * C + c0 + c) * kTileTexels + e] = acc[c];
            }
          }
        }
      }
      __syncwarp();
    }
  }
}

// A warp a tile: add a split tile's later items, in item order, to what
// its first wrote; kGroup channels of two texels a lane at a time, their
// loads issued together.
__global__ void __launch_bounds__(kGatherWarps * 32)
    dimg_merge_kernel(char* __restrict__ work,
                      const float* __restrict__ partial,
                      float* __restrict__ dimg, int C, int H, int W,
                      int tiles_x, int tiles_y, int extra) {
  constexpr int kPer = kTileTexels / 32;  // a lane's texels
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.y, nt = tiles_x * tiles_y;
  const int t = blockIdx.x * kGatherWarps + (threadIdx.x >> 5);
  if (t >= nt) return;
  const Work wk = work_of(work, nt, extra, n);
  const int first = wk.first[t], splits = wk.first[t + 1] - first;
  if (splits <= 1) return;
  const int64_t slot0 = (int64_t)n * extra + first - t;  // item 1's slot
  const int64_t hw = (int64_t)H * W;
  int64_t at[kPer];
  bool inside[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = k * 32 + lane;
    const int y = (t / tiles_x) * kTileH + e / kTileW;
    const int x = (t % tiles_x) * kTileW + e % kTileW;
    inside[k] = y < H && x < W;
    at[k] = (int64_t)y * W + x;
  }
  for (int c0 = 0; c0 < C; c0 += kGroup) {
    float a[kGroup][kPer];
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        a[c][k] = c0 + c < C && inside[k]
                      ? dimg[((int64_t)n * C + c0 + c) * hw + at[k]] : 0.f;
      }
    }
    for (int s = 1; s < splits; ++s) {
      const float* ps = partial + (slot0 + s - 1) * C * kTileTexels;
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (c0 + c < C) a[c][k] += ps[(c0 + c) * kTileTexels + k * 32 + lane];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        if (c0 + c < C && inside[k]) {
          dimg[((int64_t)n * C + c0 + c) * hw + at[k]] = a[c][k];
        }
      }
    }
  }
}

// K5b's geometry and the byte offsets of its scratch.
struct DimgPlan {
  Tiling tl;
  BinPlan bin;
  size_t order, work, partial, bytes;
};

bool plan_dimg(DimgPlan* q, int N, int C, int H, int W, int P) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || P <= 0) return false;
  q->tl = make_tiling(1, &H, &W);
  if (!plan_bin(&q->bin, q->tl, 1, P)) return false;
  size_t at = 0;
  q->order = at;
  at = align16(at + sizeof(int) * (size_t)N * P);
  q->work = at;
  at = align16(at + q->bin.work * N);
  q->partial = at;
  at = align16(at + sizeof(float) * (size_t)N * q->bin.extra * C *
                        kTileTexels);
  q->bytes = at;
  return true;
}

template <int PAD>
int launch_dimg(const float* grid, const float* dout, float* dimg,
                char* scratch, const DimgPlan& q, int N, int C, int H, int W,
                int P, cudaStream_t s) {
  int* order = reinterpret_cast<int*>(scratch + q.order);
  char* work = scratch + q.work;
  float* partial = reinterpret_cast<float*>(scratch + q.partial);
  const int nt = q.bin.nt, tiles_x = q.tl.tiles_x[0];
  const int tiles_y = q.tl.tiles_y[0], extra = q.bin.extra;
  const DimgKeys<PAD> keys{reinterpret_cast<const float2*>(grid), q.tl, P, H,
                           W};
  int rc = launch_bin(keys, q.tl, q.bin, N, order, work, P, s);
  if (rc != 0) return rc;
  const cudaError_t err = cudaFuncSetAttribute(
      dimg_gather_kernel<PAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(kGatherWarps * kItemShared));
  if (err != cudaSuccess) return (int)err;
  // a warp for each tile's first item; later items go to the warps of
  // lower tiles in turn
  const int gather_blocks = (nt + kGatherWarps - 1) / kGatherWarps;
  dimg_gather_kernel<PAD><<<dim3(gather_blocks, N), kGatherWarps * 32,
                            kGatherWarps * kItemShared, s>>>(
      grid, dout, order, work, partial, dimg, C, P, H, W, tiles_x, tiles_y,
      extra);
  dimg_merge_kernel<<<dim3(gather_blocks, N), kGatherWarps * 32, 0, s>>>(
      work, partial, dimg, C, H, W, tiles_x, tiles_y, extra);
  return (int)cudaGetLastError();
}

}  // namespace

// K2. img (N, C, H, W) f32, contiguous NCHW (packed = 0) or channels_last
// (packed = 1); grid (N, P, 2) with x then y in [-1, 1] and out (N, C, P),
// both contiguous; Wo the output's width. Returns the CUDA error code of
// the launch.
extern "C" int gg_grid_sample_fwd(const float* img, const float* grid,
                                  float* out, int N, int C, int H, int W,
                                  int P, int Wo, int packed, int padding,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((int64_t)N * P == 0) return (int)cudaSuccess;
  if (Wo <= 0 || N > 65535) return (int)cudaErrorInvalidValue;
  // an output narrower than a tile's row is walked in rows of kRowPoints
  const int cols = Wo >= kRowPoints ? Wo : kRowPoints;
  const int rows = (P + cols - 1) / cols;
  const dim3 blocks((cols + kRowPoints - 1) / kRowPoints,
                    (rows + kTileRows - 1) / kTileRows, N);
  if (blocks.y > 65535) return (int)cudaErrorInvalidValue;
  const int vec = cols % 2 == 0 && P % 2 == 0 &&
                  reinterpret_cast<uintptr_t>(grid) % 16 == 0;
  const uintptr_t at = reinterpret_cast<uintptr_t>(img);
  const int layout = !packed                          ? kPlanes
                     : C == 2 && at % 8 == 0          ? kTexels2
                     : C == 4 && at % 16 == 0         ? kTexels4
                                                      : kTexels;
  const dim3 threads(32, kTileRows);
  cudaStream_t s = (cudaStream_t)stream;
  switch (layout) {
    case kPlanes:
      return launch_k2<kPlanes>(blocks, threads, s, padding, img, grid, out,
                                C, H, W, P, cols, vec);
    case kTexels2:
      return launch_k2<kTexels2>(blocks, threads, s, padding, img, grid, out,
                                 C, H, W, P, cols, vec);
    case kTexels4:
      return launch_k2<kTexels4>(blocks, threads, s, padding, img, grid, out,
                                 C, H, W, P, cols, vec);
    default:
      return launch_k2<kTexels>(blocks, threads, s, padding, img, grid, out,
                                C, H, W, P, cols, vec);
  }
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

// K5b's scratch in bytes for these shapes, or -1 for shapes it does not
// take.
extern "C" long long gg_grid_sample_dimg_scratch(int N, int C, int H, int W,
                                                 int P) {
  DimgPlan q;
  return plan_dimg(&q, N, C, H, W, P) ? (long long)q.bytes : -1;
}

// K5b. grid (N, P, 2), dout (N, C, P), dimg (N, C, H, W), written whole;
// scratch of gg_grid_sample_dimg_scratch bytes, 16-byte aligned; all f32
// and contiguous. Three launches; returns the CUDA error code.
extern "C" int gg_grid_sample_dimg(const float* grid, const float* dout,
                                   float* dimg, void* scratch, int N, int C,
                                   int H, int W, int P, int padding,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N == 0 || C == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  DimgPlan q;
  if (P == 0 || !plan_dimg(&q, N, C, H, W, P) || N > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  char* sc = static_cast<char*>(scratch);
  cudaStream_t s = (cudaStream_t)stream;
  switch (padding) {
    case gg::kBorder:
      return launch_dimg<gg::kBorder>(grid, dout, dimg, sc, q, N, C, H, W, P,
                                      s);
    case gg::kReflection:
      return launch_dimg<gg::kReflection>(grid, dout, dimg, sc, q, N, C, H, W,
                                          P, s);
    case gg::kZeros:
      return launch_dimg<gg::kZeros>(grid, dout, dimg, sc, q, N, C, H, W, P,
                                     s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
