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
// Design for Hopper: one CTA per (leaf tile, tile of kQT queries). The
// CTA walks its tile's windows root first with its queries' frontier in
// shared memory as bytes [kQT][max width], ping-ponging between two
// buffers, the loop of traverse_fused.cu over windows instead of whole
// levels, then writes the tile's mask bytes (each query row by
// consecutive threads, coalesced). A level on which no query keeps a live
// node ends the walk: the tile's rows are written as zeros. The TPU
// kernel stages the windows through scalar-prefetched BlockSpecs; here
// the CTA reads its own starts. Shared memory is 2 * kQT * max(width)
// bytes whatever the tree's size; the wrapper routes a table whose widest
// window passes that to the per-level rung.
//
// Bound: bytes. The [B, L] mask write (B*L bytes) dominates the reads of
// the leaf level and of the windows; 4 compares per (query, node).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kQT = 8;        // queries per CTA
constexpr int kBlock = 256;   // threads per CTA

struct Levels {
  int n_int;                  // internal levels (root first)
  int off[kMaxLevels + 1];    // level l's nodes: [off[l], off[l+1])
  int width[kMaxLevels];      // level l's window width
};

__device__ __forceinline__ bool hit(const float4& q, const float4& m) {
  return (q.x <= m.z) && (m.x <= q.z) && (q.y <= m.w) && (m.y <= q.w);
}

__global__ void __launch_bounds__(kBlock)
traverse_fused_sliced_kernel(const float4* __restrict__ queries, int B,
                             const float4* __restrict__ int_mbrs,
                             const int* __restrict__ int_parents, Levels lv,
                             int wmax, const int* __restrict__ starts,
                             int n_tiles, int tl,
                             const float4* __restrict__ leaf_mbrs,
                             const int* __restrict__ leaf_parents, int L,
                             uint8_t* __restrict__ out) {
  extern __shared__ uint8_t frontier[];     // 2 * kQT * wmax bytes
  __shared__ float4 q[kQT];
  const int tile = blockIdx.x;
  const int b0 = blockIdx.y * kQT;
  const int nq = min(kQT, B - b0);
  const int t = threadIdx.x;
  if (t < kQT) {   // rows past B compare false against everything (NaN)
    const float nan = __int_as_float(0x7fffffff);
    q[t] = t < nq ? queries[b0 + t] : make_float4(nan, nan, nan, nan);
  }
  __syncthreads();

  uint8_t* cur = frontier;
  uint8_t* nxt = frontier + kQT * wmax;
  int prev_s = 0;
  bool live = true;
  for (int l = 0; l < lv.n_int && live; ++l) {
    const int lo = lv.off[l];
    const int n = lv.off[l + 1] - lo;
    const int w = lv.width[l];
    const int s = starts[l * n_tiles + tile] * w;
    bool any = false;
    for (int i = t; i < w; i += kBlock) {
      const int g = s + i;
      const bool in = g >= 0 && g < n;
      const float4 m = in ? int_mbrs[lo + g] : q[0];
      const int rel = l > 0 && in ? int_parents[lo + g] - prev_s : 0;
      const bool ok = in && rel >= 0 && (l == 0 || rel < lv.width[l - 1]);
#pragma unroll
      for (int j = 0; j < kQT; ++j) {
        const bool v = ok && (l == 0 || cur[j * wmax + rel] != 0) &&
                       hit(q[j], m);
        nxt[j * wmax + i] = v;
        any |= v;
      }
    }
    live = __syncthreads_or(any) != 0;
    uint8_t* swap = cur;
    cur = nxt;
    nxt = swap;
    prev_s = s;
  }

  const int pw = lv.width[lv.n_int - 1];
  const int c0 = tile * tl;
  const int c1 = min(c0 + tl, L);
  for (int i = c0 + t; i < c1; i += kBlock) {
    float4 m = q[0];
    int rel = -1;
    if (live) {
      m = leaf_mbrs[i];
      rel = leaf_parents[i] - prev_s;
    }
    const bool ok = rel >= 0 && rel < pw;
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      if (j < nq)
        out[static_cast<int64_t>(b0 + j) * L + i] =
            ok && cur[j * wmax + rel] != 0 && hit(q[j], m);
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
  if (n_int < 1 || n_int > kMaxLevels || B <= 0 || L <= 0 || tl <= 0 ||
      n_tiles != (L + tl - 1) / tl || (B + kQT - 1) / kQT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  lv.n_int = n_int;
  int wmax = 1;
  for (int l = 0; l <= kMaxLevels; ++l) lv.off[l] = 0;
  for (int l = 0; l < kMaxLevels; ++l) lv.width[l] = 0;
  for (int l = 0; l <= n_int; ++l) lv.off[l] = h_offsets[l];
  for (int l = 0; l < n_int; ++l) {
    if (h_widths[l] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    lv.width[l] = h_widths[l];
    wmax = max(wmax, h_widths[l]);
  }
  const size_t smem = static_cast<size_t>(2) * kQT * wmax;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        traverse_fused_sliced_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(n_tiles, (B + kQT - 1) / kQT);
  traverse_fused_sliced_kernel<<<grid, kBlock, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(queries), B,
      reinterpret_cast<const float4*>(int_mbrs), int_parents, lv, wmax,
      starts, n_tiles, tl, reinterpret_cast<const float4*>(leaf_mbrs),
      leaf_parents, L, out);
  return static_cast<int>(cudaGetLastError());
}
