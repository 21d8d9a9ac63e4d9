// Fused root-to-leaf R-tree walk writing the dense visited-leaf mask.
//
// Replaces traverse_fused_t (src/repro/kernels/traverse_fused.py). Same
// semantics as the level-synchronous walk (src/repro/core/traversal.py,
// visited_leaf_mask_per_level): a node is visited iff its parent was
// visited and its MBR intersects the query (closed rectangles), the root
// iff its MBR intersects; the output is the leaf level's [B, L] mask.
//
// What held the first design back: each CTA walked the internal
// levels first (a barrier a level) and only then loaded its leaves, in 8
// serial rounds of parent, MBR and 8 one-byte stores, with a row loop of
// runtime trip count that did not unroll. So the leaf loads' latency sat
// behind the walk's, and the mask, the kernel's bound, went out a byte at
// a time.
//
// Design for Hopper: one CTA per (tile of kQT queries, chunk of kChunk
// leaves). Each thread owns 4 consecutive leaves of the chunk and issues
// their MBRs and parents before the walk: they do not depend on it, so
// their latency hides behind it. The walk keeps, for each node of a level,
// a kQT-bit mask of the tile's rows that visit it (two buffers as long as
// the widest internal level, in shared memory), and tests a node only if
// its parent is live for one of the rows. A thread then looks up its
// leaves' parents' masks: leaves under a parent dead for every row are
// zeros with no hit test. The tests run over the compile-time kQT rows
// unrolled and branch-free (the live bit and the hit ANDed): a chain of
// short-circuit branches left each query load's latency exposed, a fifth
// to a third of a launch on an H100 (PERF.md). Each thread packs a row's
// four bytes into a word of a [kQT][chunk] tile in shared memory, and
// the tile goes out in 16-byte stores: row b starts at byte b*L, not a
// multiple of 16, so each aligned 16-byte block of a row is read from
// the tile at its byte offset (five words, funnel-shifted), and only the
// row chunk's unaligned head and tail go out a byte at a time. A
// single-level tree (root == leaves) has no internal levels and every
// leaf's parent test is skipped.
//
// Bound: bytes. The [B, L] mask write (B*L bytes) dominates the reads of
// the leaf level (20 bytes a leaf per query tile, served by L2) and the
// internal levels; the compares are 4 per (query, node tested). What a
// launch takes is the CTA's chain (its loads, a barrier a level, the
// tests, the write-out), not the bytes: on an H100 the write-out is about
// a quarter of a launch at the 872K-point deployment (PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kQT = 16;                  // queries per CTA
constexpr int kBlock = 256;              // threads per CTA
constexpr int kChunk = kBlock * 4;       // leaves per CTA, 4 a thread
constexpr int kRowWords = kChunk / 4 + 4;  // a tile row, padded
using Mask = uint16_t;                   // one bit per query of the tile
constexpr Mask kAll =
    static_cast<Mask>(kQT >= 32 ? ~0u : (1u << kQT) - 1u);
static_assert(kQT <= 8 * static_cast<int>(sizeof(Mask)), "Mask too narrow");

struct Levels {
  int n_int;                  // internal levels (root first)
  int off[kMaxLevels + 1];    // level l's nodes: [off[l], off[l+1])
};

__device__ __forceinline__ bool hit(const float4& q, const float4& m) {
  return (q.x <= m.z) && (m.x <= q.z) && (q.y <= m.w) && (m.y <= q.w);
}

__global__ void __launch_bounds__(kBlock)
traverse_fused_kernel(const float4* __restrict__ queries, int B,
                      const float4* __restrict__ int_mbrs,
                      const int* __restrict__ int_parents, Levels lv,
                      int width, const float4* __restrict__ leaf_mbrs,
                      const int* __restrict__ leaf_parents, int L,
                      uint8_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  uint32_t* tile = smem;                               // [kQT][kRowWords]
  Mask* cur = reinterpret_cast<Mask*>(tile + kQT * kRowWords);  // [width]
  Mask* nxt = cur + width;
  __shared__ float4 q[kQT];
  const int t = threadIdx.x;
  const int b0 = blockIdx.x * kQT;
  const int nq = min(kQT, B - b0);
  const int c0 = blockIdx.y * kChunk;
  const int i0 = c0 + 4 * t;

  // this thread's four leaves, loaded before the walk
  float4 m[4];
  int p[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    m[s] = i0 + s < L ? leaf_mbrs[i0 + s] : make_float4(1.f, 1.f, 0.f, 0.f);
    p[s] = -1;                                         // past L: dead
  }
  if (lv.n_int > 0) {
    if (i0 + 3 < L && (reinterpret_cast<uintptr_t>(leaf_parents + i0) & 15)
        == 0) {
      const int4 pp = *reinterpret_cast<const int4*>(leaf_parents + i0);
      p[0] = pp.x;
      p[1] = pp.y;
      p[2] = pp.z;
      p[3] = pp.w;
    } else {
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (i0 + s < L) p[s] = leaf_parents[i0 + s];
    }
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (i0 + s < L) p[s] = 0;
  }
  if (t < kQT) {  // rows past B compare false with everything (NaN)
    const float nan = __int_as_float(0x7fffffff);
    q[t] = t < nq ? queries[b0 + t] : make_float4(nan, nan, nan, nan);
  }
  __syncthreads();

  for (int l = 0; l < lv.n_int; ++l) {
    const int lo = lv.off[l];
    const int n = lv.off[l + 1] - lo;
    for (int i = t; i < n; i += kBlock) {
      const float4 mm = int_mbrs[lo + i];
      const Mask live = l == 0 ? kAll : cur[int_parents[lo + i]];
      Mask mk = 0;
      if (live) {
#pragma unroll
        for (int j = 0; j < kQT; ++j)
          mk |= Mask(unsigned(((live >> j) & 1) & hit(q[j], mm)) << j);
      }
      nxt[i] = mk;
    }
    __syncthreads();
    Mask* swap = cur;
    cur = nxt;
    nxt = swap;
  }

  Mask live[4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
    live[s] = p[s] < 0 ? Mask(0) : (lv.n_int > 0 ? cur[p[s]] : kAll);
  if ((live[0] | live[1] | live[2] | live[3]) == 0) {
#pragma unroll
    for (int j = 0; j < kQT; ++j) tile[j * kRowWords + t] = 0u;
  } else {
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      uint32_t w = 0u;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        w |= unsigned(((live[s] >> j) & 1) & hit(q[j], m[s])) << (8 * s);
      tile[j * kRowWords + t] = w;
    }
  }
  __syncthreads();

  // out: each row's chunk as aligned 16-byte blocks, the partial head
  // and tail block a byte at a time
  const int n = min(kChunk, L - c0);
  const uint8_t* tb = reinterpret_cast<const uint8_t*>(tile);
  constexpr int kBlocks = kChunk / 16 + 1;             // blocks a row meets
  for (int i = t; i < nq * kBlocks; i += kBlock) {
    const int j = i / kBlocks;
    const int kb = i - j * kBlocks;
    uint8_t* g = out + static_cast<int64_t>(b0 + j) * L + c0;
    const int lo = kb * 16 - static_cast<int>(
        reinterpret_cast<uintptr_t>(g) & 15);          // block start - g
    if (lo >= n) continue;
    const uint32_t* src = tile + j * kRowWords;
    if (lo >= 0 && lo + 16 <= n) {
      const uint32_t* w = src + (lo >> 2);
      const unsigned sh = 8u * (lo & 3);
      uint4 v;
      v.x = __funnelshift_r(w[0], w[1], sh);
      v.y = __funnelshift_r(w[1], w[2], sh);
      v.z = __funnelshift_r(w[2], w[3], sh);
      v.w = __funnelshift_r(w[3], w[4], sh);
      *reinterpret_cast<uint4*>(g + lo) = v;
    } else {
      const int e = min(lo + 16, n);
      for (int x = max(lo, 0); x < e; ++x) g[x] = tb[j * kRowWords * 4 + x];
    }
  }
}

}  // namespace

// queries [B,4] f32; int_mbrs/int_parents: the internal levels packed root
// first, level l at [h_offsets[l], h_offsets[l+1]) (host array, n_int+1
// entries; parents index the previous level); leaf_mbrs [L,4] f32,
// leaf_parents [L] i32; out [B,L] bytes. Returns the launch's cudaError_t.
extern "C" int traverse_fused_launch(const float* queries, int B,
                                     const float* int_mbrs,
                                     const int* int_parents,
                                     const int* h_offsets, int n_int,
                                     const float* leaf_mbrs,
                                     const int* leaf_parents, int L,
                                     uint8_t* out, void* stream) {
  if (n_int < 0 || n_int > kMaxLevels || B <= 0 || L <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  lv.n_int = n_int;
  int width = 1;
  for (int l = 0; l <= kMaxLevels; ++l) lv.off[l] = 0;
  for (int l = 0; l <= n_int; ++l) lv.off[l] = h_offsets[l];
  for (int l = 0; l < n_int; ++l)
    width = max(width, h_offsets[l + 1] - h_offsets[l]);
  const size_t smem = static_cast<size_t>(kQT) * kRowWords * 4 +
                      static_cast<size_t>(2) * width * sizeof(Mask);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        traverse_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((B + kQT - 1) / kQT, (L + kChunk - 1) / kChunk);
  traverse_fused_kernel<<<grid, kBlock, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(queries), B,
      reinterpret_cast<const float4*>(int_mbrs), int_parents, lv, width,
      reinterpret_cast<const float4*>(leaf_mbrs), leaf_parents, L, out);
  return static_cast<int>(cudaGetLastError());
}
