// Fused root-to-leaf R-tree walk writing the dense visited-leaf mask.
//
// Replaces traverse_fused_t (src/repro/kernels/traverse_fused.py). Same
// semantics as the level-synchronous walk (src/repro/core/traversal.py,
// visited_leaf_mask_per_level): a node is visited iff its parent was
// visited and its MBR intersects the query (closed rectangles), the root
// iff its MBR intersects; the output is the leaf level's mask.
//
// Design for Hopper: one CTA per (tile of QT queries, chunk of leaves).
// The internal levels are small (a few hundred nodes at the paper's
// scale), so each CTA walks them from the root with the frontier of its
// QT queries held in shared memory as bytes [QT][max internal width],
// ping-ponging between two buffers; frontier expansion is a direct read
// of frontier[parent] from shared memory (the TPU kernel's one-hot MXU
// matmul exists only because Mosaic cannot gather along lanes). Threads
// then stride over the CTA's leaf chunk: each loads a leaf MBR and parent
// once and writes the QT mask bytes, so each query row is written by
// consecutive threads (coalesced). A single-level tree (root == leaves)
// has no internal levels and every leaf's parent test is skipped.
//
// Bound: bytes. The [B, L] mask write (B*L bytes) dominates the reads of
// the leaf level (20 bytes a leaf per CTA row of tiles, served by L2) and
// the internal levels; the compares are 4 per (query, node).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kQT = 8;        // queries per CTA
constexpr int kBlock = 256;   // threads per CTA

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
                      int leaf_chunk, uint8_t* __restrict__ out) {
  extern __shared__ uint8_t frontier[];     // 2 * kQT * width bytes
  __shared__ float4 q[kQT];
  const int b0 = blockIdx.x * kQT;
  const int nq = min(kQT, B - b0);
  const int t = threadIdx.x;
  if (t < kQT)   // rows past B get a rectangle that meets nothing
    q[t] = t < nq ? queries[b0 + t] : make_float4(1.f, 1.f, 0.f, 0.f);
  __syncthreads();

  uint8_t* cur = frontier;
  uint8_t* nxt = frontier + kQT * width;
  for (int l = 0; l < lv.n_int; ++l) {
    const int lo = lv.off[l];
    const int n = lv.off[l + 1] - lo;
    for (int i = t; i < n; i += kBlock) {
      const float4 m = int_mbrs[lo + i];
      const int p = l > 0 ? int_parents[lo + i] : 0;
#pragma unroll
      for (int j = 0; j < kQT; ++j) {
        const bool alive = l == 0 || cur[j * width + p] != 0;
        nxt[j * width + i] = alive && hit(q[j], m);
      }
    }
    __syncthreads();
    uint8_t* swap = cur;
    cur = nxt;
    nxt = swap;
  }

  const int c0 = blockIdx.y * leaf_chunk;
  const int c1 = min(c0 + leaf_chunk, L);
  for (int i = c0 + t; i < c1; i += kBlock) {
    const float4 m = leaf_mbrs[i];
    const int p = lv.n_int > 0 ? leaf_parents[i] : 0;
    for (int j = 0; j < nq; ++j) {
      const bool alive = lv.n_int == 0 || cur[j * width + p] != 0;
      out[static_cast<int64_t>(b0 + j) * L + i] = alive && hit(q[j], m);
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
                                     int leaf_chunk, uint8_t* out,
                                     void* stream) {
  if (n_int < 0 || n_int > kMaxLevels || B <= 0 || L <= 0 || leaf_chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  lv.n_int = n_int;
  int width = 1;
  for (int l = 0; l <= kMaxLevels; ++l) lv.off[l] = 0;
  for (int l = 0; l <= n_int; ++l) lv.off[l] = h_offsets[l];
  for (int l = 0; l < n_int; ++l)
    width = max(width, h_offsets[l + 1] - h_offsets[l]);
  const size_t smem = static_cast<size_t>(2) * kQT * width;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        traverse_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((B + kQT - 1) / kQT, (L + leaf_chunk - 1) / leaf_chunk);
  traverse_fused_kernel<<<grid, kBlock, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(queries), B,
      reinterpret_cast<const float4*>(int_mbrs), int_parents, lv, width,
      reinterpret_cast<const float4*>(leaf_mbrs), leaf_parents, L, leaf_chunk,
      out);
  return static_cast<int>(cudaGetLastError());
}
