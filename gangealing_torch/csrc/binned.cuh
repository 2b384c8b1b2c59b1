// The bin stage of the deterministic binned gathers K5a (d/dpyramid,
// mipmap_sample.cu) and K5b (d/dimage, grid_sample.cu), and what their
// gathers share.
//
// A point reaches a small footprint of texels on one level (K5b: the 2x2
// of its bilinear tap; K5a: that on level 0, a 3x3 window on a coarse
// level, one footprint on each of the two levels its level tent weighs).
// Each footprint is an entry, keyed by the kTileW x kTileH tile of its
// top-left texel, times kClasses classes that say whether it also reaches
// the tile to the right, below or diagonally (a footprint of width w does
// when its top-left lies in the tile's last w - 1 columns or rows; tiles
// are at least as wide and high as a footprint, so no footprint reaches
// further). The bin kernel sorts the entries of one image into per-key
// buckets in point order, a stable counting sort with no atomics: one
// thread-block cluster of kCluster blocks an image, each warp counting
// its own run of points with __match_any_sync, the blocks reading each
// other's counts from distributed shared memory and placing their points
// by the scanned counts. The per-warp counts of every key live in shared
// memory, so the keys are counted in passes of at most kPassKeys (the
// points are read again each pass): no image size is refused. Then block
// 0 writes the image's work list: each tile's candidates as four segments
// of the bucketed order (its own bucket, the left tile's classes 2-3, the
// upper tile's 1-2 and the upper-left tile's 2), cut into work items of
// kSlots candidates, and each item's tile. A gather takes an item a warp;
// a split tile's later items write partial tiles that a merge adds.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;  // the bin kernel's blocks
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 16;     // a tile's texels across
constexpr int kTileH = 4;      // and down
constexpr int kTileTexels = kTileW * kTileH;
// keys a tile: interior, last rows, corner, last columns
constexpr int kClasses = 4;
constexpr int kCluster = 8;    // blocks that bin one image
// rounds of 32 points whose loads a bin warp issues together
constexpr int kBinRounds = 8;
constexpr int kPassKeys = 4096;  // most keys a bin pass counts
constexpr int kGatherWarps = 4;  // warps of a gather block, an item each
constexpr int kSlots = 128;    // candidates a work item holds
constexpr int kSlotRounds = kSlots / 32;
constexpr int kMaxTileLevels = 8;
static_assert(kSlotRounds * 32 == kSlots, "whole rounds");
static_assert(kTileTexels % 32 == 0, "whole texels a lane");
static_assert(kSlots <= 65535, "16-bit slots and counts");
static_assert(kTileW >= 3 && kTileH >= 3, "a footprint spills one tile");

// Exclusive prefix sum of s[0, len) in place by the whole block (s in
// shared or global memory); returns the total. s_warp holds kWarps + 1
// ints.
__device__ int block_exclusive_scan(int* s, int len, int* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (len + kThreads - 1) / kThreads;
  const int lo = min(tid * per, len), hi = min(lo + per, len);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += s[i];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < kWarps ? s_warp[lane] : 0;
    int w = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += u;
    }
    if (lane < kWarps) s_warp[lane] = w - v;
    if (lane == kWarps - 1) s_warp[kWarps] = w;
  }
  __syncthreads();
  int run = s_warp[warp] + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int v = s[i];
    s[i] = run;
    run += v;
  }
  const int total = s_warp[kWarps];
  __syncthreads();
  return total;
}

// The lanes of the warp with the same key as this lane, and whether this
// lane leads them (the lowest such lane).
struct Group {
  unsigned mask;
  bool lead;
};

__device__ __forceinline__ Group group_of(int key) {
  const unsigned m = __match_any_sync(0xffffffffu, key);
  return Group{m, (int)(threadIdx.x & 31) == __ffs(m) - 1};
}

__device__ __forceinline__ int rank_in(const Group& g) {
  return __popc(g.mask & ((1u << (threadIdx.x & 31)) - 1));
}

// Exclusive prefix sum of cnt[0, N) by one warp into run[0, N], run[N]
// the total.
template <int N>
__device__ __forceinline__ void warp_scan(const unsigned short* cnt,
                                          unsigned short* run, int lane) {
  constexpr int per = (N + 31) / 32;
  const int lo = min(lane * per, N), hi = min(lo + per, N);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += cnt[i];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  int r = incl - sum;
  for (int i = lo; i < hi; ++i) {
    run[i] = (unsigned short)r;
    r += cnt[i];
  }
  if (lane == 31) run[N] = (unsigned short)incl;
  __syncwarp();
}

// The tiles of an image's levels: level d has tiles_x[d] x tiles_y[d]
// tiles, numbered row by row from base[d]; base[levels] tiles in all.
struct Tiling {
  int levels;
  int tiles_x[kMaxTileLevels], tiles_y[kMaxTileLevels];
  int base[kMaxTileLevels + 1];
};

// The tiling of levels of height h[d] and width w[d].
inline Tiling make_tiling(int levels, const int* h, const int* w) {
  Tiling tl;
  tl.levels = levels;
  tl.base[0] = 0;
  for (int d = 0; d < levels; ++d) {
    tl.tiles_x[d] = (w[d] + kTileW - 1) / kTileW;
    tl.tiles_y[d] = (h[d] + kTileH - 1) / kTileH;
    tl.base[d + 1] = tl.base[d] + tl.tiles_x[d] * tl.tiles_y[d];
  }
  return tl;
}

__device__ __forceinline__ int level_of(const Tiling& tl, int t) {
  int d = 0;
  while (d + 1 < tl.levels && t >= tl.base[d + 1]) ++d;
  return d;
}

// The bin key of a footprint of width `width` whose top-left texel is
// (ky, kx) on level d.
__device__ __forceinline__ int tile_key(const Tiling& tl, int d, int ky,
                                        int kx, int width) {
  const bool row = ky % kTileH > kTileH - width;
  const bool col = kx % kTileW > kTileW - width;
  // last rows 1, corner 2, last columns 3: the tile below reads classes
  // 1-2, the tile to the right 2-3, the diagonal one 2
  const int cls = col ? (row ? 2 : 3) : (row ? 1 : 0);
  return (tl.base[d] + (ky / kTileH) * tl.tiles_x[d] + kx / kTileW) *
             kClasses + cls;
}

// An image's work list: each tile's candidates as four segments of the
// bucketed order, the first of its work items (first[nt] items in all),
// the tile of each item, and each bucket's start (start[K] entries).
struct Work {
  int4* seg;      // [nt][2]: starts, then lengths
  int* first;     // [nt + 1]
  int* item_tile; // [nt + extra]
  int* start;     // [K + 1]
};

__host__ __device__ __forceinline__ size_t align16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

__host__ __device__ __forceinline__ size_t work_bytes(int nt, int extra) {
  return align16(sizeof(int4) * 2 * nt +
                 sizeof(int) * ((nt + 1) + (nt + extra) +
                                (nt * kClasses + 1)));
}

__device__ __forceinline__ Work work_of(char* base, int nt, int extra,
                                        int n) {
  Work w;
  w.seg = reinterpret_cast<int4*>(base + n * work_bytes(nt, extra));
  w.first = reinterpret_cast<int*>(w.seg + 2 * nt);
  w.item_tile = w.first + nt + 1;
  w.start = w.item_tile + nt + extra;
  return w;
}

// The bin stage's geometry: tiles and keys, the keys a pass counts, the
// bound on the items past each tile's first (an entry is a candidate of
// at most 4 tiles), the work list's bytes an image and the bin kernel's
// dynamic shared memory.
struct BinPlan {
  int nt, K, pass_keys, extra;
  size_t work, shared;
};

inline bool plan_bin(BinPlan* b, const Tiling& tl, int entries, int P) {
  b->nt = tl.base[tl.levels];
  const int64_t K = (int64_t)b->nt * kClasses;
  const int64_t cand = (int64_t)kClasses * entries * P;
  if (K <= 0 || K > (1 << 28) || cand > (1 << 30)) return false;
  b->K = (int)K;
  const int passes = (b->K + kPassKeys - 1) / kPassKeys;
  b->pass_keys = (b->K + passes - 1) / passes;
  b->extra = (int)((cand + kSlots - 1) / kSlots);
  b->work = work_bytes(b->nt, b->extra);
  b->shared = sizeof(int) * (size_t)(kWarps + 2) * b->pass_keys;
  return true;
}

// One cluster of kCluster blocks an image bins its points' entries into
// `order` (the point's index, bucket by bucket, point order within a
// bucket; kEntries * P ints an image) and block 0 writes the work list.
// Keys: the entries of a point, with
//   static constexpr int kEntries;  // entries a point
//   struct Point;                   // what a point's keys are made from
//   Point load(int n, int i) const;
//   void keys(const Point&, int (&key)[kEntries]) const;  // -1: none
// A point's entries lie on different tiles.
template <class Keys>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    bin_kernel(Keys keys, Tiling tl, int* __restrict__ order,
               char* __restrict__ work, int P, int pass_keys, int extra) {
  constexpr int E = Keys::kEntries;
  extern __shared__ int s_rows[];    // [kWarps][pass_keys], [pass_keys] x 2
  int* s_tot = s_rows + kWarps * pass_keys;  // counts, for the cluster
  int* s_start = s_tot + pass_keys;          // the buckets' starts
  __shared__ int s_warp[kWarps + 1];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.y, nt = tl.base[tl.levels], K = nt * kClasses;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Work w = work_of(work, nt, extra, n);
  // each warp's run: whole rounds, kCluster * kWarps runs covering P
  const int per_warp = (P + kCluster * kWarps * 32 - 1) /
                       (kCluster * kWarps * 32) * 32;
  const int first = (rank * kWarps + warp) * per_warp;
  const int last = min(first + per_warp, P);

  // The keys of kBinRounds rounds of the warp's run from `from`, less k0,
  // or -1 outside [k0, k0 + kn).
  auto keys_of = [&](int from, int k0, int kn,
                     int (&key)[kBinRounds][E]) {
    typename Keys::Point pt[kBinRounds];
#pragma unroll
    for (int r = 0; r < kBinRounds; ++r) {
      const int i = from + r * 32 + lane;
      if (i < last) pt[r] = keys.load(n, i);
    }
#pragma unroll
    for (int r = 0; r < kBinRounds; ++r) {
#pragma unroll
      for (int e = 0; e < E; ++e) key[r][e] = -1;
      if (from + r * 32 + lane < last) keys.keys(pt[r], key[r]);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int k = key[r][e] - k0;
        key[r][e] = key[r][e] >= 0 && k >= 0 && k < kn ? k : -1;
      }
    }
  };
  int* dst = order + (int64_t)n * E * P;
  int placed_before = 0;
  for (int k0 = 0; k0 < K; k0 += pass_keys) {
    const int kn = min(pass_keys, K - k0);
    for (int e = tid; e < kWarps * kn; e += kThreads) s_rows[e] = 0;
    __syncthreads();
    for (int from = first; from < last; from += kBinRounds * 32) {
      int key[kBinRounds][E];
      keys_of(from, k0, kn, key);
#pragma unroll
      for (int r = 0; r < kBinRounds; ++r) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int k = key[r][e];
          const Group g = group_of(k);
          if (k >= 0 && g.lead) s_rows[warp * kn + k] += __popc(g.mask);
          __syncwarp();
        }
      }
    }
    __syncthreads();
    for (int k = tid; k < kn; k += kThreads) {
      int sum = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) sum += s_rows[v * kn + k];
      s_tot[k] = sum;
    }
    cluster.sync();
    // Each key's total over the cluster, and this block's warps' offsets
    // from the bucket's start: the earlier blocks' counts, then the
    // earlier warps'.
    for (int k = tid; k < kn; k += kThreads) {
      int total = 0, before = 0;
      for (int q = 0; q < kCluster; ++q) {
        const int v = cluster.map_shared_rank(s_tot, q)[k];
        total += v;
        if (q < rank) before += v;
      }
      s_start[k] = total;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) {
        const int c = s_rows[v * kn + k];
        s_rows[v * kn + k] = before;
        before += c;
      }
    }
    cluster.sync();  // no block goes on while another reads its counts
    const int placed = block_exclusive_scan(s_start, kn, s_warp);
    if (rank == 0) {
      for (int k = tid; k < kn; k += kThreads) {
        w.start[k0 + k] = placed_before + s_start[k];
      }
    }
    for (int from = first; from < last; from += kBinRounds * 32) {
      int key[kBinRounds][E];
      keys_of(from, k0, kn, key);
#pragma unroll
      for (int r = 0; r < kBinRounds; ++r) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int k = key[r][e];
          const Group g = group_of(k);
          if (k >= 0) {
            dst[placed_before + s_start[k] + s_rows[warp * kn + k] +
                rank_in(g)] = from + r * 32 + lane;
          }
          __syncwarp();
          if (k >= 0 && g.lead) s_rows[warp * kn + k] += __popc(g.mask);
          __syncwarp();
        }
      }
    }
    placed_before += placed;
    __syncthreads();
  }
  if (rank != 0) return;

  // The work list, from the buckets' starts.
  if (tid == 0) w.start[K] = placed_before;
  __syncthreads();
  const int* S = w.start;
  for (int t = tid; t < nt; t += kThreads) {
    const int d = level_of(tl, t), tiles_x = tl.tiles_x[d];
    const int lt = t - tl.base[d], tx = lt % tiles_x, ty = lt / tiles_x;
    const int o = t * kClasses, u = o - tiles_x * kClasses;
    const int4 start = make_int4(S[o], tx > 0 ? S[o - 2] : 0,
                                 ty > 0 ? S[u + 1] : 0,
                                 tx > 0 && ty > 0 ? S[u - 2] : 0);
    const int4 len = make_int4(
        S[o + 4] - S[o], tx > 0 ? S[o] - S[o - 2] : 0,
        ty > 0 ? S[u + 3] - S[u + 1] : 0,
        tx > 0 && ty > 0 ? S[u - 1] - S[u - 2] : 0);
    w.seg[2 * t] = start;
    w.seg[2 * t + 1] = len;
    const int cand = len.x + len.y + len.z + len.w;
    w.first[t] = max(1, (cand + kSlots - 1) / kSlots);
  }
  __syncthreads();
  const int n_items = block_exclusive_scan(w.first, nt, s_warp);
  for (int t = tid; t < nt; t += kThreads) {
    const int from = w.first[t], to = t + 1 < nt ? w.first[t + 1] : n_items;
    for (int i = from; i < to; ++i) w.item_tile[i] = t;
  }
  if (tid == 0) w.first[nt] = n_items;
}

// Launch the bin kernel for N images; returns the CUDA error code.
template <class Keys>
int launch_bin(const Keys& keys, const Tiling& tl, const BinPlan& b, int N,
               int* order, char* work, int P, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      bin_kernel<Keys>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)b.shared);
  if (err != cudaSuccess) return (int)err;
  bin_kernel<Keys><<<dim3(kCluster, N), kThreads, b.shared, s>>>(
      keys, tl, order, work, P, b.pass_keys, b.extra);
  return (int)cudaGetLastError();
}

// Candidate v of a tile's list: its four segments one after another.
__device__ __forceinline__ int candidate(const int* ord, int4 start, int4 len,
                                         int v) {
  int at = start.x + v;
  if (v >= len.x) {
    v -= len.x;
    at = start.y + v;
    if (v >= len.y) {
      v -= len.y;
      at = start.z + v;
      if (v >= len.z) at = start.w + v - len.z;
    }
  }
  return ord[at];
}

}  // namespace
