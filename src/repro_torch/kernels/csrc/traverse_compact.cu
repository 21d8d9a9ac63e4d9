// Fused root-to-leaf R-tree walk, compacted into a slot table.
//
// Replaces traverse_compact_t (src/repro/kernels/traverse_fused.py):
// the visited set of traverse_fused.cu (a node is visited iff its parent
// was visited and its MBR intersects the query, closed rectangles), but
// instead of the dense [B, L] mask each query gets the first k visited
// leaf ids in id order (zeros past its count) and its total visited
// count. The mask never reaches device memory.
//
// Design for Hopper: the compaction needs a row's whole leaf level in id
// order, so one CTA owns kQT queries and all L leaves (traverse_fused.cu
// instead splits the leaf level across CTAs). The CTA walks the internal
// levels from the root with its queries' frontier in shared memory as
// bytes [kQT][width], ping-ponging between two buffers, exactly as
// traverse_fused.cu does. At the leaf level each warp takes 32
// consecutive leaves, one per lane (coalesced 16-byte MBR loads), and
// one __ballot_sync per query gives that query's 32-leaf bitmap word
// directly: an L-bit bitmap per query in shared memory (1.6 KB at
// L = 12,730), written without atomics. compact.cuh, the port of the
// TPU compaction epilogue that mlp_predict_compact.cu also uses, turns
// each bitmap into the slot table with per-thread popcounts and one
// block scan. A single-level tree (root == leaves) is the zero-internal-
// level case of the same loop. The wrapper raises when the bitmaps plus
// the frontier outgrow shared memory (the ancestor-sliced walk is not
// ported).
//
// Bound: bytes. Each CTA reads the leaf level (20 bytes a leaf, served by
// L2 after the first CTAs) and the internal levels; the compulsory
// traffic is the queries, one read of the tree and the B*(k+1) ints of
// slot table and counts; 4 compares per (query, node).
#include <cuda_runtime.h>

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
};

__device__ __forceinline__ bool hit(const float4& q, const float4& m) {
  return (q.x <= m.z) && (m.x <= q.z) && (q.y <= m.w) && (m.y <= q.w);
}

__global__ void __launch_bounds__(kBlock)
traverse_compact_kernel(const float4* __restrict__ queries, int B,
                        const float4* __restrict__ int_mbrs,
                        const int* __restrict__ int_parents, Levels lv,
                        int width, const float4* __restrict__ leaf_mbrs,
                        const int* __restrict__ leaf_parents, int L, int k,
                        int* __restrict__ idx, int* __restrict__ cnt) {
  extern __shared__ uint32_t smem[];
  const int n_words = (L + 31) >> 5;
  uint32_t* bits = smem;                                   // [kQT][n_words]
  uint8_t* frontier = reinterpret_cast<uint8_t*>(smem + kQT * n_words);
  __shared__ float4 q[kQT];
  const int b0 = blockIdx.x * kQT;
  const int nq = min(kQT, B - b0);
  const int t = threadIdx.x;
  if (t < kQT)   // rows past B are never compacted
    q[t] = t < nq ? queries[b0 + t] : make_float4(1.f, 1.f, 0.f, 0.f);
  __syncthreads();

  uint8_t* cur = frontier;                         // 2 * kQT * width bytes
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

  const int lane = t & 31;
  for (int base = (t >> 5) * 32; base < L; base += kWarps * 32) {
    const int i = base + lane;
    const bool in = i < L;
    const float4 m = in ? leaf_mbrs[i] : make_float4(1.f, 1.f, 0.f, 0.f);
    const int p = in && lv.n_int > 0 ? leaf_parents[i] : 0;
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      const bool alive = lv.n_int == 0 || cur[j * width + p] != 0;
      const unsigned w = __ballot_sync(0xffffffffu, in && alive &&
                                                        hit(q[j], m));
      if (lane == 0) bits[j * n_words + (base >> 5)] = w;
    }
  }
  __syncthreads();

  for (int j = 0; j < nq; ++j) {
    repro_torch::block_compact_bitmap<kBlock>(
        bits + j * n_words, n_words, k,
        idx + static_cast<int64_t>(b0 + j) * k, cnt + b0 + j);
    __syncthreads();
  }
}

}  // namespace

extern "C" int traverse_compact_smem_bytes(int L, int width) {
  return kQT * ((L + 31) / 32) * 4 + 2 * kQT * width;
}

// queries [B,4] f32; int_mbrs/int_parents: the internal levels packed root
// first, level l at [h_offsets[l], h_offsets[l+1]) (host array, n_int+1
// entries; parents index the previous level); leaf_mbrs [L,4] f32,
// leaf_parents [L] i32 -> idx [B,k] i32, cnt [B] i32. Returns the
// launch's cudaError_t.
extern "C" int traverse_compact_launch(const float* queries, int B,
                                       const float* int_mbrs,
                                       const int* int_parents,
                                       const int* h_offsets, int n_int,
                                       const float* leaf_mbrs,
                                       const int* leaf_parents, int L, int k,
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
  const size_t smem =
      static_cast<size_t>(traverse_compact_smem_bytes(L, width));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        traverse_compact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  traverse_compact_kernel<<<(B + kQT - 1) / kQT, kBlock, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(queries), B,
      reinterpret_cast<const float4*>(int_mbrs), int_parents, lv, width,
      reinterpret_cast<const float4*>(leaf_mbrs), leaf_parents, L, k, idx,
      cnt);
  return static_cast<int>(cudaGetLastError());
}
