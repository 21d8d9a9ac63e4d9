// Root-to-leaf R-tree walk through ancestor windows, writing the dense
// visited-leaf mask.
//
// Replaces traverse_fused_sliced_t (src/repro/kernels/traverse_fused.py):
// the visited set of traverse_fused.cu, but each leaf tile of tl leaves
// sees internal level l only through its window of width[l] nodes from
// starts[l, tile] * width[l] (the AncestorTable of core/device_tree.py).
// A window node past the level's end is dead; a parent index is rebased
// to the window of the level above (rel = parent - start) and a parent
// outside that window is dead (src/repro/kernels/ref.py,
// traverse_fused_sliced). With a correctly built table this is exactly
// the full walk.
//
// What held the first design back: a CTA held 8 queries, so each leaf
// tile was walked and read once per 8 rows; the frontier was a byte per
// (query, window node), each node tested for the 8 queries one after
// another; the leaves were loaded only after the walk, so their latency
// sat behind it; and every (query, leaf) went out as a guarded one-byte
// store, while the [B, L] mask is the kernel's bound.
//
// Design for Hopper: the full walk's (traverse_fused.cu) through windows,
// and a walk shared by the tiles it serves. One CTA per (tile of kQT = 32
// queries, segment of consecutive leaf tiles); the launch picks enough
// segments to fill the card and no more. The CTA keeps, for each window
// node of every level, a kQT-bit mask of its rows that reach the node
// (in shared memory, the levels one after another). A tile's windows
// are those of the tile before it down to some level (on the 1.5M-leaf
// routing tree every window but the lowest is its whole level, and the
// lowest moves once in ~89 tiles), so the CTA walks only from the first
// level whose window moved, or not at all: a tile then costs its leaves'
// tests and its writes. A level is walked with each thread's first node
// loaded a level ahead; a node is tested only when its rebased parent is
// live for some row: every row, unrolled and branch-free, when more than
// kDense rows are live, else the live rows one after another (at the
// lower levels a parent is live for one or two rows of 32, and the
// unrolled tests were most of a launch there). A level with no live bit
// ends the walk: the tile's rows are zeros, and so are the next tiles'
// until a window at or above that level moves. Each thread's two leaves
// of the next tile are loaded while this tile is served. Each thread
// packs its two leaves' bytes of a row into a half-word of a [kQT][chunk]
// tile in shared memory, and a warp copies a row segment out at a time:
// each aligned 16-byte block of the row is read from the tile at its byte
// offset (five words, funnel-shifted) and written in one streaming store
// (__stcs: the mask is read once, by the compaction); only the row's
// unaligned head and tail go out a byte at a time (row b starts at byte
// b*L). Output offsets are 64-bit: B*L passes 2^31 on a large batch of
// the 1.5M-leaf tree. Shared memory is the tile plus 4 * sum(width)
// bytes whatever the tree's size; the wrapper routes a table whose widest
// window passes the sliced rung's reach to the per-level rung.
//
// Bound: bytes. The [B, L] mask write (B*L bytes) dominates the reads of
// the leaf level (20 bytes a leaf per query tile, served by L2) and of
// the windows; 4 compares per (query, node tested).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kQT = 32;                    // queries per CTA
constexpr int kBlock = 256;                // threads per CTA
constexpr int kWarps = kBlock / 32;
constexpr int kChunk = 2 * kBlock;         // leaves a round, 2 a thread
constexpr int kRowWords = kChunk / 4 + 4;  // a tile row, padded
constexpr int kDense = 8;       // more live rows than this: test them all
constexpr int kCtasPerSm = 8;   // CTAs an SM the grid aims for
using Mask = uint32_t;                     // one bit per query of the tile
constexpr Mask kAll = ~0u;
static_assert(kQT == 8 * static_cast<int>(sizeof(Mask)), "a bit a row");
static_assert(kMaxLevels <= 32, "warp 0 reads a level's start a lane");

struct Levels {
  int n_int;                  // internal levels (root first)
  int off[kMaxLevels + 1];    // level l's nodes: [off[l], off[l+1])
  int width[kMaxLevels];      // level l's window width
  int moff[kMaxLevels];       // level l's row masks in shared memory
};

__device__ __forceinline__ bool hit(const float4& q, const float4& m) {
  return (q.x <= m.z) && (m.x <= q.z) && (q.y <= m.w) && (m.y <= q.w);
}

// a query from shared memory, read where it is used: the queries do not
// change over a CTA's tiles, and held in registers across them (as the
// compiler otherwise would) they take 128 of a thread's registers
__device__ __forceinline__ float4 query(const float4* q) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(q))));
  return v;
}

// the rows of `live` whose query meets m
__device__ __forceinline__ Mask hits(const float4* q, Mask live,
                                     const float4& m) {
  Mask mk = 0;
  if (__popc(live) > kDense) {
#pragma unroll
    for (int j = 0; j < kQT; ++j)
      mk |= Mask(((live >> j) & 1u) & unsigned(hit(query(q + j), m))) << j;
  } else {
    while (live) {
      const int j = __ffs(live) - 1;
      live &= live - 1;
      mk |= Mask(hit(query(q + j), m)) << j;
    }
  }
  return mk;
}

__global__ void __launch_bounds__(kBlock)
traverse_fused_sliced_kernel(const float4* __restrict__ queries, int B,
                             const float4* __restrict__ int_mbrs,
                             const int* __restrict__ int_parents, Levels lv,
                             const int* __restrict__ starts, int n_tiles,
                             int tl, const float4* __restrict__ leaf_mbrs,
                             const int* __restrict__ leaf_parents, int L,
                             uint8_t* __restrict__ out, int n_qtiles,
                             int per) {
  extern __shared__ uint32_t smem[];
  uint32_t* tile = smem;                               // [kQT][kRowWords]
  Mask* masks = tile + kQT * kRowWords;                // [sum(width)]
  __shared__ float4 q[kQT];
  __shared__ int win[kMaxLevels];      // this tile's window starts
  __shared__ int first;                // its first level whose window moved
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int b0 = (blockIdx.x % n_qtiles) * kQT;
  const int nq = min(kQT, B - b0);
  const int tile0 = (blockIdx.x / n_qtiles) * per;
  const int tile1 = min(n_tiles, tile0 + per);
  const int n_int = lv.n_int;

  // two leaves a thread of the round at r0 (raw parents; -1 past c1)
  auto leaves = [&](int c1, int r0, float4* m, int* p) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int i = r0 + 2 * t + s;
      m[s] = i < c1 ? leaf_mbrs[i] : make_float4(1.f, 1.f, 0.f, 0.f);
      p[s] = i < c1 ? leaf_parents[i] : -1;
    }
  };
  float4 m[2], m_next[2];
  int p[2], p_next[2];
  leaves(min(tile0 * tl + tl, L), tile0 * tl, m_next, p_next);
  if (t < kQT) {  // rows past B compare false with everything (NaN)
    const float nan = __int_as_float(0x7fffffff);
    q[t] = t < nq ? queries[b0 + t] : make_float4(nan, nan, nan, nan);
  }
  if (t < kMaxLevels) win[t] = -1;

  // window node i of level l: its MBR, and its parent rebased to the
  // window above (0 at the root), -1 when the node is dead
  auto node = [&](int l, int i, float4& mm, int& pp) {
    const int lo = lv.off[l];
    const int g = win[l] + i;
    const bool in = i < lv.width[l] && g >= 0 && g < lv.off[l + 1] - lo;
    mm = in ? int_mbrs[lo + g] : make_float4(1.f, 1.f, 0.f, 0.f);
    pp = in ? 0 : -1;
    if (in && l > 0) {
      const int rel = int_parents[lo + g] - win[l - 1];
      pp = rel >= 0 && rel < lv.width[l - 1] ? rel : -1;
    }
  };
  // levels [0, valid) hold the row masks of the current windows; with
  // `dead`, level valid - 1 has no live bit
  int valid = 0;
  bool dead = false;
  const Mask* leaf_live = masks + lv.moff[n_int - 1];
  const int pw = lv.width[n_int - 1];
  const uintptr_t base = reinterpret_cast<uintptr_t>(out);
  uint16_t* half = reinterpret_cast<uint16_t*>(tile);
  for (int tid = tile0; tid < tile1; ++tid) {
    const int c0 = tid * tl;
    const int c1 = min(c0 + tl, L);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      m[s] = m_next[s];
      p[s] = p_next[s];
    }
    __syncthreads();     // the last tile is done with win and the tile
    if (warp == 0) {     // this tile's windows, and the first that moved
      const int w = lane < n_int ? starts[lane * n_tiles + tid] *
                                   lv.width[lane] : -1;
      const unsigned moved = __ballot_sync(0xffffffffu, w != win[lane]);
      win[lane] = w;
      if (lane == 0) first = moved ? __ffs(moved) - 1 : n_int;
    }
    if (tid + 1 < tile1)
      leaves(min(c0 + 2 * tl, L), c0 + tl, m_next, p_next);
    __syncthreads();
    if (first < valid) {   // a window at or above the valid levels moved
      valid = first;
      dead = false;
    }

    if (!dead && valid < n_int) {
      float4 mn;
      int pn;
      node(valid, t, mn, pn);
      for (int l = valid; l < n_int; ++l) {
        const float4 m0 = mn;
        const int p0 = pn;
        if (l + 1 < n_int) node(l + 1, t, mn, pn);     // a level ahead
        const Mask* up = masks + (l ? lv.moff[l - 1] : 0);
        Mask* mine = masks + lv.moff[l];
        Mask any = 0;
        for (int i = t; i < lv.width[l]; i += kBlock) {
          float4 mm = m0;
          int pp = p0;
          if (i != t) node(l, i, mm, pp);
          const Mask live = pp < 0 ? 0u : (l == 0 ? kAll : up[pp]);
          const Mask mk = hits(q, live, mm);
          mine[i] = mk;
          any |= mk;
        }
        valid = l + 1;
        if (!__syncthreads_or(any != 0)) {
          dead = true;
          break;
        }
      }
    }

    for (int r0 = c0; r0 < c1; r0 += kChunk) {
      if (r0 != c0) {    // the last round's copy-out is done with the tile
        __syncthreads();
        leaves(c1, r0, m, p);
      }
      Mask h[2] = {0u, 0u};
      if (!dead) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int rel = p[s] - win[n_int - 1];
          h[s] = hits(q, rel >= 0 && rel < pw ? leaf_live[rel] : 0u, m[s]);
        }
      }
#pragma unroll
      for (int j = 0; j < kQT; ++j)
        half[j * 2 * kRowWords + t] = static_cast<uint16_t>(
            ((h[0] >> j) & 1u) | (((h[1] >> j) & 1u) << 8));
      __syncthreads();

      // out: a warp a row segment, aligned 16-byte blocks, the head and
      // tail a byte at a time
      const int n = min(kChunk, c1 - r0);
      for (int j = warp; j < nq; j += kWarps) {
        const int64_t s = static_cast<int64_t>(b0 + j) * L + r0;
        const int head =
            min(static_cast<int>((16 - ((base + s) & 15)) & 15), n);
        const int nb = (n - head) >> 4;       // aligned 16-byte blocks
        const int tail = head + 16 * nb;      // first byte past them
        const uint32_t* row = tile + j * kRowWords;
        uint8_t* o = out + s;
        for (int k = lane; k < nb; k += 32) {
          const int x = head + 16 * k;
          const uint32_t* w = row + (x >> 2);
          const unsigned sh = 8u * (x & 3);
          uint4 v;
          v.x = __funnelshift_r(w[0], w[1], sh);
          v.y = __funnelshift_r(w[1], w[2], sh);
          v.z = __funnelshift_r(w[2], w[3], sh);
          v.w = __funnelshift_r(w[3], w[4], sh);
          __stcs(reinterpret_cast<uint4*>(o + x), v);
        }
        const uint8_t* rb = reinterpret_cast<const uint8_t*>(row);
        const int x = lane < 16 ? lane : tail + lane - 16;
        if (lane < 16 ? x < head : x < n) __stcs(o + x, rb[x]);
      }
    }
  }
}

}  // namespace

// queries [B,4] f32; int_mbrs/int_parents: the internal levels packed root
// first, level l at [h_offsets[l], h_offsets[l+1]) (host array, n_int+1
// entries; parents index the previous level); starts [n_int, n_tiles] i32
// window block indices (device), h_widths [n_int] window widths (host);
// leaf_mbrs [L,4] f32, leaf_parents [L] i32; out [B,L] bytes. Returns the
// launch's cudaError_t.
extern "C" int traverse_fused_sliced_launch(
    const float* queries, int B, const float* int_mbrs,
    const int* int_parents, const int* h_offsets, int n_int,
    const int* starts, const int* h_widths, int n_tiles, int tl,
    const float* leaf_mbrs, const int* leaf_parents, int L, uint8_t* out,
    void* stream) {
  const int n_qtiles = (B + kQT - 1) / kQT;
  if (n_int < 1 || n_int > kMaxLevels || B <= 0 || L <= 0 || tl <= 0 ||
      n_tiles != (L + tl - 1) / tl)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  lv.n_int = n_int;
  int64_t total = 0;
  for (int l = 0; l <= kMaxLevels; ++l) lv.off[l] = 0;
  for (int l = 0; l < kMaxLevels; ++l) lv.width[l] = lv.moff[l] = 0;
  for (int l = 0; l <= n_int; ++l) lv.off[l] = h_offsets[l];
  for (int l = 0; l < n_int; ++l) {
    if (h_widths[l] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    lv.width[l] = h_widths[l];
    lv.moff[l] = static_cast<int>(total);
    total += h_widths[l];
  }
  const int64_t smem = static_cast<int64_t>(kQT) * kRowWords * 4 +
                       total * static_cast<int64_t>(sizeof(Mask));
  if (smem > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        traverse_fused_sliced_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  // leaf-tile segments: enough CTAs to fill the card kCtasPerSm deep,
  // and no more
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int64_t want = (static_cast<int64_t>(sms) * kCtasPerSm +
                        n_qtiles - 1) / n_qtiles;
  const int64_t segs = want < n_tiles ? want : n_tiles;
  const int per = static_cast<int>((n_tiles + segs - 1) / segs);
  const int64_t n_blocks =
      static_cast<int64_t>(n_qtiles) * ((n_tiles + per - 1) / per);
  if (n_blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  traverse_fused_sliced_kernel<<<static_cast<unsigned>(n_blocks), kBlock,
                                 static_cast<size_t>(smem),
                                 static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(queries), B,
      reinterpret_cast<const float4*>(int_mbrs), int_parents, lv, starts,
      n_tiles, tl, reinterpret_cast<const float4*>(leaf_mbrs), leaf_parents,
      L, out, n_qtiles, per);
  return static_cast<int>(cudaGetLastError());
}
