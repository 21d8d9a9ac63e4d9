// Root-to-leaf R-tree walk through ancestor windows, compacted into a
// slot table.
//
// Replaces traverse_compact_sliced_t (src/repro/kernels/traverse_fused.py):
// the windowed visited set of traverse_fused_sliced.cu (each leaf tile of
// tl leaves sees internal level l only through its window of width[l]
// nodes from starts[l, tile] * width[l]; out-of-window parents and nodes
// past a level's end are dead), compacted as traverse_compact.cu does:
// each query gets the first k visited leaf ids in id order (zeros past its
// count) and its total visited count, exact past k. The [B, L] mask never
// reaches device memory.
//
// Design for Hopper: compaction needs a row's leaves in id order and CTAs
// run in no order, so one CTA owns kQT queries and loops over the leaf
// tiles in order, as the TPU kernel's grid revisits its (i, 0) output
// block. For each tile it walks the windows root first, the frontier of
// every internal level in shared memory as bytes [kQT][width[l]]. Windows
// of the upper levels repeat over runs of tiles, so a level whose window
// start equals the one its buffer holds is not walked again, and a tile
// below a reused level on which no query keeps a live node is skipped
// without a read. Otherwise each warp takes 32 consecutive leaves of the
// tile, one per lane (a leaf's MBR is read only if its parent is live for
// one of the CTA's queries), and one __ballot_sync per query gives that
// query's 32-leaf bitmap word; compact.cuh's block_compact_bitmap_at ranks the
// tile's bits from the row's running count (a tile with no visited leaf
// in a row is not compacted for it). Shared memory is
// kQT * (ceil(tl/32) * 4 + sum(width)) bytes whatever the tree's size;
// the wrapper routes a table that passes the limit to the per-level rung.
//
// Bound: bytes. The compulsory traffic is the queries, one read of the
// tree (leaf level and windows) and the B*(k+1) ints of slot table and
// counts; 4 compares per (query, node).
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "compact.cuh"

namespace {

constexpr int kMaxLevels = 32;
constexpr int kQT = 4;        // queries per CTA
constexpr int kBlock = 256;   // threads per CTA
constexpr int kWarps = kBlock / 32;

struct Levels {
  int n_int;                  // internal levels (root first)
  int off[kMaxLevels + 1];    // level l's nodes: [off[l], off[l+1])
  int width[kMaxLevels];      // level l's window width
  int foff[kMaxLevels + 1];   // level l's frontier: kQT * foff[l] bytes in
};

__device__ __forceinline__ bool hit(const float4& q, const float4& m) {
  return (q.x <= m.z) && (m.x <= q.z) && (q.y <= m.w) && (m.y <= q.w);
}

__global__ void __launch_bounds__(kBlock)
traverse_compact_sliced_kernel(const float4* __restrict__ queries, int B,
                               const float4* __restrict__ int_mbrs,
                               const int* __restrict__ int_parents,
                               Levels lv, const int* __restrict__ starts,
                               int n_tiles, int tl,
                               const float4* __restrict__ leaf_mbrs,
                               const int* __restrict__ leaf_parents, int L,
                               int k, int* __restrict__ idx,
                               int* __restrict__ cnt) {
  extern __shared__ uint32_t smem[];
  const int n_words = (tl + 31) >> 5;
  uint32_t* bits = smem;                                   // [kQT][n_words]
  uint8_t* front = reinterpret_cast<uint8_t*>(smem + kQT * n_words);
  __shared__ float4 q[kQT];
  __shared__ unsigned warp_rows[kWarps];
  const int b0 = blockIdx.x * kQT;
  const int nq = min(kQT, B - b0);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t < kQT) {   // rows past B compare false against everything (NaN)
    const float nan = __int_as_float(0x7fffffff);
    q[t] = t < nq ? queries[b0 + t] : make_float4(nan, nan, nan, nan);
  }
  __syncthreads();

  // Every thread keeps the same copy of these (all values are uniform
  // across the block): the window start each level's buffer holds
  // (INT_MIN: none) and whether any node in it is live, and each row's
  // count.
  int held[kMaxLevels];
  bool held_live[kMaxLevels];
  for (int l = 0; l < lv.n_int; ++l) held[l] = INT_MIN;
  int run[kQT];
#pragma unroll
  for (int j = 0; j < kQT; ++j) run[j] = 0;

  for (int tile = 0; tile < n_tiles; ++tile) {
    // levels whose window is unchanged keep their buffers
    int l0 = 0;
    bool dead = false;
    while (l0 < lv.n_int && starts[l0 * n_tiles + tile] == held[l0]) {
      dead |= !held_live[l0];
      ++l0;
    }
    for (int l = l0; l < lv.n_int && !dead; ++l) {
      const int lo = lv.off[l];
      const int n = lv.off[l + 1] - lo;
      const int w = lv.width[l];
      const int sb = starts[l * n_tiles + tile];
      const int s = sb * w;
      uint8_t* mine = front + kQT * lv.foff[l];
      const uint8_t* up = l > 0 ? front + kQT * lv.foff[l - 1] : nullptr;
      const int uw = l > 0 ? lv.width[l - 1] : 0;
      const int us = l > 0 ? held[l - 1] * uw : 0;
      bool any = false;
      for (int i = t; i < w; i += kBlock) {
        const int g = s + i;
        const bool in = g >= 0 && g < n;
        const float4 m = in ? int_mbrs[lo + g] : q[0];
        const int rel = l > 0 && in ? int_parents[lo + g] - us : 0;
        const bool ok = in && rel >= 0 && (l == 0 || rel < uw);
#pragma unroll
        for (int j = 0; j < kQT; ++j) {
          const bool v = ok && (l == 0 || up[j * uw + rel] != 0) &&
                         hit(q[j], m);
          mine[j * w + i] = v;
          any |= v;
        }
      }
      const bool live = __syncthreads_or(any) != 0;
      held[l] = sb;
      held_live[l] = live;
      if (!live) {
        dead = true;
        for (int d = l + 1; d < lv.n_int; ++d) held[d] = INT_MIN;
      }
    }
    if (dead) continue;

    // the leaf tile: one ballot per (32 leaves, query)
    const int last = lv.n_int - 1;
    const int pw = lv.width[last];
    const int ps = held[last] * pw;
    const uint8_t* up = front + kQT * lv.foff[last];
    const int c0 = tile * tl;
    const int c1 = min(c0 + tl, L);
    unsigned rows = 0;
    for (int base = warp * 32; base < tl; base += kWarps * 32) {
      const int i = c0 + base + lane;
      const bool in = i < c1;
      const int rel = in ? leaf_parents[i] - ps : -1;
      const bool ok = in && rel >= 0 && rel < pw;
      bool par[kQT];
      bool any_par = false;
#pragma unroll
      for (int j = 0; j < kQT; ++j) {
        par[j] = ok && up[j * pw + rel] != 0;
        any_par |= par[j];
      }
      const float4 m = any_par ? leaf_mbrs[i] : q[0];   // dead: no read
#pragma unroll
      for (int j = 0; j < kQT; ++j) {
        const unsigned word =
            __ballot_sync(0xffffffffu, par[j] && hit(q[j], m));
        if (lane == 0) bits[j * n_words + (base >> 5)] = word;
        rows |= (word != 0u ? 1u : 0u) << j;
      }
    }
    if (lane == 0) warp_rows[warp] = rows;
    __syncthreads();
    rows = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) rows |= warp_rows[w];
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      if (j < nq && ((rows >> j) & 1u)) {
        run[j] += repro_torch::block_compact_bitmap_at<kBlock>(
            bits + j * n_words, n_words, k, c0, run[j],
            idx + static_cast<int64_t>(b0 + j) * k);
      }
    }
    __syncthreads();   // bits and warp_rows are rewritten by the next tile
  }

#pragma unroll
  for (int j = 0; j < kQT; ++j) {
    if (j < nq) {
      int* row = idx + static_cast<int64_t>(b0 + j) * k;
      for (int s = run[j] + t; s < k; s += kBlock) row[s] = 0;
      if (t == 0) cnt[b0 + j] = run[j];
    }
  }
}

}  // namespace

// Shared memory of one CTA for a table of these widths and tile.
extern "C" int traverse_compact_sliced_smem_bytes(const int* h_widths,
                                                  int n_int, int tl) {
  int sum = 0;
  for (int l = 0; l < n_int; ++l) sum += h_widths[l];
  return kQT * (((tl + 31) / 32) * 4 + sum);
}

// queries [B,4] f32; int_mbrs/int_parents: the internal levels packed root
// first, level l at [h_offsets[l], h_offsets[l+1]) (host array, n_int+1
// entries; parents index the previous level); starts [n_int, n_tiles] i32
// window block indices (device), h_widths [n_int] window widths (host);
// leaf_mbrs [L,4] f32, leaf_parents [L] i32 -> idx [B,k] i32, cnt [B] i32.
// Returns the launch's cudaError_t.
extern "C" int traverse_compact_sliced_launch(
    const float* queries, int B, const float* int_mbrs,
    const int* int_parents, const int* h_offsets, int n_int,
    const int* starts, const int* h_widths, int n_tiles, int tl,
    const float* leaf_mbrs, const int* leaf_parents, int L, int k, int* idx,
    int* cnt, void* stream) {
  if (n_int < 1 || n_int > kMaxLevels || B <= 0 || L <= 0 || tl <= 0 ||
      k <= 0 || n_tiles != (L + tl - 1) / tl)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  lv.n_int = n_int;
  for (int l = 0; l <= kMaxLevels; ++l) lv.off[l] = lv.foff[l] = 0;
  for (int l = 0; l < kMaxLevels; ++l) lv.width[l] = 0;
  for (int l = 0; l <= n_int; ++l) lv.off[l] = h_offsets[l];
  for (int l = 0; l < n_int; ++l) {
    if (h_widths[l] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    lv.width[l] = h_widths[l];
    lv.foff[l + 1] = lv.foff[l] + h_widths[l];
  }
  const size_t smem = static_cast<size_t>(
      traverse_compact_sliced_smem_bytes(h_widths, n_int, tl));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        traverse_compact_sliced_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  traverse_compact_sliced_kernel<<<(B + kQT - 1) / kQT, kBlock, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(queries), B,
      reinterpret_cast<const float4*>(int_mbrs), int_parents, lv, starts,
      n_tiles, tl, reinterpret_cast<const float4*>(leaf_mbrs), leaf_parents,
      L, k, idx, cnt);
  return static_cast<int>(cudaGetLastError());
}
