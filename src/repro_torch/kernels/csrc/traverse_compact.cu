// Fused root-to-leaf R-tree walk, compacted into a slot table.
//
// Replaces traverse_compact_t (src/repro/kernels/traverse_fused.py): the
// visited set of traverse_fused.cu (a node is visited iff its parent was
// visited and its MBR intersects the query, closed rectangles), but
// instead of the dense [B, L] mask each query gets the first k visited
// leaf ids in id order (zeros past its count) and its total visited
// count, exact past k. The mask never reaches device memory.
//
// What held the first design back: one CTA owned 4 queries and
// the whole leaf level, so a 512-query batch was 128 CTAs, about one an
// SM; each warp looped over all L leaves (~50 rounds of dependent loads
// at L = 12,730) and read every leaf's MBR even under a parent dead for
// all 4 rows, then compacted the 4 rows' L-bit bitmaps one after another
// with a block scan and two barriers each. At selectivity 5e-5 a row
// visits a handful of the level above's nodes, so nearly all of that
// work was wasted, and the time was the latency of one CTA's chain.
//
// Design for Hopper: the work of a row is its visited subtree. flatten
// lays every parent's children out contiguously, in parent order, so
// each internal node owns a child range [first, end) of the level below
// (the tree's WalkPack, built once per tree). One warp walks one query
// from the root with no barrier: per level it holds the live nodes' child
// ranges as a list in shared memory (two lists, as long as the widest
// internal level), and tests only those children, 32 a round, lanes
// spread over the concatenated ranges of up to 32 live nodes at a time
// (a warp scan of the range lengths, then each lane finds its node with
// five shuffles). A hit on an internal level appends that child's own
// range to the next list; on the leaf level it takes the running rank,
// so live nodes in increasing id and their children in order give the
// visited leaves in id order with no bitmap and no block scan. The MBRs
// (and child ranges) of kR rounds are loaded before any of them is
// tested, so their latency overlaps. After the leaves the warp zero-fills
// slots [count, k) with 16-byte stores. A CTA holds up to kWarps
// queries, fewer when their lists would outgrow shared memory; a
// single-level tree is the zero-internal-level case of the same walk
// (one virtual parent whose range is every leaf).
//
// Bound: bytes. The compulsory traffic is the queries, one read of the
// visited subtree's nodes (20 bytes an internal node, 16 a leaf) and the
// B*(k+1) ints of slot table and counts; 4 compares per (query, node
// tested). A row visiting few leaves costs a few rounds of dependent L2
// loads, which set the time.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kWarps = 4;     // queries (warps) per CTA, at most
constexpr int kR = 8;         // rounds whose loads are issued together
constexpr int kMaxSmem = 227 * 1024 - 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Levels {
  int n_int;                  // internal levels (root first)
  int off[kMaxLevels + 1];    // level l's nodes: [off[l], off[l+1])
};

__device__ __forceinline__ bool hit(const float4& q, const float4& m) {
  return (q.x <= m.z) && (m.x <= q.z) && (q.y <= m.w) && (m.y <= q.w);
}

__global__ void __launch_bounds__(kWarps * 32)
traverse_compact_kernel(const float4* __restrict__ queries, int B,
                        const float4* __restrict__ int_mbrs,
                        const int2* __restrict__ ranges, Levels lv,
                        int width, const float4* __restrict__ leaf_mbrs,
                        int L, int k, int* __restrict__ idx,
                        int* __restrict__ cnt) {
  extern __shared__ int2 lists[];              // [warps][2][width]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;                          // no barrier below
  int2* cur = lists + static_cast<int64_t>(warp) * 2 * width;
  int2* nxt = cur + width;
  const float4 q = queries[b];
  int* row = idx + static_cast<int64_t>(b) * k;
  const unsigned below = (1u << lane) - 1u;

  // the level above level 0: one virtual node whose children are level 0
  if (lane == 0) cur[0] = make_int2(0, lv.n_int > 0 ? lv.off[1] : L);
  __syncwarp();
  int n_cur = 1;
  int count = 0;
  for (int l = 0; l <= lv.n_int && n_cur > 0; ++l) {
    const bool leaf = l == lv.n_int;
    const float4* mbrs = leaf ? leaf_mbrs : int_mbrs + lv.off[l];
    const int2* rng = ranges + (leaf ? 0 : lv.off[l]);
    int n_next = 0;
    for (int c0 = 0; c0 < n_cur; c0 += 32) {
      // up to 32 live nodes' child ranges, one a lane, laid end to end
      const int2 r = c0 + lane < n_cur ? cur[c0 + lane] : make_int2(0, 0);
      const int len = r.y - r.x;
      int incl = len;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      const int total = __shfl_sync(kFull, incl, 31);
      const int excl = incl - len;
      for (int p0 = 0; p0 < total; p0 += 32 * kR) {
        int child[kR];
        float4 m[kR];
        int2 cr[kR];
#pragma unroll
        for (int s = 0; s < kR; ++s) {
          // position p's node: the last lane whose range starts at or
          // before p (empty ranges never win: the next starts there too)
          const int p = p0 + s * 32 + lane;
          int j = 0;
#pragma unroll
          for (int step = 16; step > 0; step >>= 1) {
            if (__shfl_sync(kFull, excl, j + step) <= p) j += step;
          }
          const int first = __shfl_sync(kFull, r.x, j);
          const int start = __shfl_sync(kFull, excl, j);
          child[s] = p < total ? first + (p - start) : -1;
        }
#pragma unroll
        for (int s = 0; s < kR; ++s) {
          m[s] = make_float4(1.f, 1.f, 0.f, 0.f);
          cr[s] = make_int2(0, 0);
          if (child[s] >= 0) {
            m[s] = mbrs[child[s]];
            if (!leaf) cr[s] = rng[child[s]];
          }
        }
#pragma unroll
        for (int s = 0; s < kR; ++s) {
          if (p0 + s * 32 >= total) break;     // warp-uniform
          const bool h = child[s] >= 0 && hit(q, m[s]);
          const unsigned bal = __ballot_sync(kFull, h);
          const int before = __popc(bal & below);
          if (leaf) {
            if (h && count + before < k) row[count + before] = child[s];
            count += __popc(bal);
          } else {
            if (h) nxt[n_next + before] = cr[s];
            n_next += __popc(bal);
          }
        }
      }
    }
    if (!leaf) {
      __syncwarp();                            // the next list is written
      int2* swap = cur;
      cur = nxt;
      nxt = swap;
      n_cur = n_next;
    }
  }

  // slots [count, k) are zeros: head ints to a 16-byte boundary, then
  // int4 stores, then the tail
  const int z0 = min(count, k);
  int* zp = row + z0;
  const int nz = k - z0;
  const int head = min(nz, static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(zp) & 15)) & 15) >> 2));
  if (lane < head) zp[lane] = 0;
  const int body = (nz - head) >> 2;
  int4* z4 = reinterpret_cast<int4*>(zp + head);
  for (int i = lane; i < body; i += 32) z4[i] = make_int4(0, 0, 0, 0);
  const int tail = head + body * 4;
  if (lane < nz - tail) zp[tail + lane] = 0;
  if (lane == 0) cnt[b] = count;
}

// Warps a CTA: kWarps, fewer when their lists outgrow shared memory
// (kernels/ops.py compact_warps mirrors this); 0 when one warp's do not
// fit.
int warps_for(int width) {
  const int per = 2 * width * static_cast<int>(sizeof(int2));
  return per > kMaxSmem ? 0 : min(kWarps, kMaxSmem / per);
}

}  // namespace

// queries [B,4] f32; int_mbrs [N_int,4] f32 and ranges [N_int,2] i32 (each
// internal node's children [first, end) in the level below): the
// internal levels packed root first, level l at [h_offsets[l],
// h_offsets[l+1]) (host array, n_int+1 entries); leaf_mbrs [L,4] f32 ->
// idx [B,k] i32, cnt [B] i32. Returns the launch's cudaError_t.
extern "C" int traverse_compact_launch(const float* queries, int B,
                                       const float* int_mbrs,
                                       const int* ranges,
                                       const int* h_offsets, int n_int,
                                       const float* leaf_mbrs, int L, int k,
                                       int* idx, int* cnt, void* stream) {
  if (n_int < 0 || n_int > kMaxLevels || B <= 0 || L <= 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  lv.n_int = n_int;
  int width = 1;
  for (int l = 0; l <= kMaxLevels; ++l) lv.off[l] = 0;
  for (int l = 0; l <= n_int; ++l) lv.off[l] = h_offsets[l];
  for (int l = 0; l < n_int; ++l)
    width = max(width, h_offsets[l + 1] - h_offsets[l]);
  const int warps = warps_for(width);
  if (warps == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(warps) * 2 * width * sizeof(int2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        traverse_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  traverse_compact_kernel<<<(B + warps - 1) / warps, warps * 32, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(queries), B,
      reinterpret_cast<const float4*>(int_mbrs),
      reinterpret_cast<const int2*>(ranges), lv, width,
      reinterpret_cast<const float4*>(leaf_mbrs), L, k, idx, cnt);
  return static_cast<int>(cudaGetLastError());
}
