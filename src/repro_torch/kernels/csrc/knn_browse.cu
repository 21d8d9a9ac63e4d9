// Distance browsing over the entries of named leaves (kNN serving).
//
// Replaces knn_browse (src/repro/kernels/knn_browse.py): for every
// (query b, slot k) the kernel writes the squared distance from query b's
// centre to each of the M entries of leaf leaf_idx[b,k], or +inf when the
// entry lies outside the probed radius (d2 > r2), when the slot is
// invalid, and on +inf padding (whose distance is +inf by arithmetic).
// The caller's top-k over the flat [B, K*M] view gives the k nearest.
//
// Design for Hopper: one CTA per (query, slot) row, threads over M, as in
// leaf_refine.cu. The slot's validity and leaf id are uniform across the
// CTA, so an invalid slot writes +inf without reading leaf data and a
// valid one reads exactly its leaf's [M, 2] entries as coalesced 8-byte
// loads (the TPU form gets the same I/O saving from scalar-prefetched
// BlockSpecs). d2 is __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)):
// nvcc would otherwise contract it into an fma, and the plain version
// (and the kNN brute-force oracle) round the two products separately, so
// the kernel matches them bit for bit. The caller clamps slot ids into
// [0, L); the kernel trusts them.
//
// Bound: bytes. Reads are valid slots * M * 8 bytes of entries, writes
// are B*K*M*4 bytes of distances (16.8 MB for a 512 x 64 slot table of
// 128-entry leaves); 6 flops and a compare per entry.
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
knn_browse_kernel(const float* __restrict__ centers,
                  const float2* __restrict__ entries, int M,
                  const int* __restrict__ leaf_idx,
                  const bool* __restrict__ valid, int K,
                  float* __restrict__ out) {
  const int64_t row = blockIdx.x;          // b * K + k
  const int b = static_cast<int>(row / K);
  float* o = out + row * M;
  if (!valid[row]) {
    for (int m = threadIdx.x; m < M; m += kBlock) o[m] = INFINITY;
    return;
  }
  const float cx = centers[3 * b];
  const float cy = centers[3 * b + 1];
  const float r2 = centers[3 * b + 2];
  const float2* e = entries + static_cast<int64_t>(leaf_idx[row]) * M;
  for (int m = threadIdx.x; m < M; m += kBlock) {
    const float2 p = e[m];
    const float dx = __fsub_rn(p.x, cx);
    const float dy = __fsub_rn(p.y, cy);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    o[m] = d2 <= r2 ? d2 : INFINITY;
  }
}

}  // namespace

// centers [B,3] f32 (cx, cy, r2); entries [L,M,2] f32; leaf_idx [B,K] i32
// in [0, L); valid [B,K] bool; out [B,K,M] f32. Returns the launch's
// cudaError_t.
extern "C" int knn_browse_launch(const float* centers, const float* entries,
                                 int M, const int* leaf_idx,
                                 const bool* valid, int B, int K, float* out,
                                 void* stream) {
  if (B <= 0 || K <= 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned rows = static_cast<unsigned>(B) * static_cast<unsigned>(K);
  knn_browse_kernel<<<rows, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      centers, reinterpret_cast<const float2*>(entries), M, leaf_idx, valid,
      K, out);
  return static_cast<int>(cudaGetLastError());
}
