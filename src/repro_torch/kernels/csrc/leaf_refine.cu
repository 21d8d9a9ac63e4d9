// Exact point-in-rectangle refinement over the entries of named leaves.
//
// Replaces leaf_refine (src/repro/kernels/leaf_refine.py): for every
// (query b, slot k) the kernel tests the M entries of leaf leaf_idx[b,k]
// against query b's closed rectangle and writes inside[b,k,:]; an invalid
// slot writes zeros. Entries padded with +inf never match.
//
// Design for Hopper: one CTA per (query, slot) row, threads over M. The
// slot's validity and leaf id are uniform across the CTA, so an invalid
// slot issues no read of leaf data at all and a valid one reads exactly
// its leaf's [M, 2] entries as coalesced 8-byte loads: only the leaves the
// slot table names are touched, which is the paper's I/O saving (the TPU
// form gets it from scalar-prefetched BlockSpecs). The caller clamps slot
// ids into [0, L); the kernel trusts them.
//
// Bound: bytes. Reads are valid slots * M * 8 bytes of entries, writes are
// B*K*M bytes of mask; there are 4 compares per entry.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
leaf_refine_kernel(const float4* __restrict__ queries,
                   const float2* __restrict__ entries, int M,
                   const int* __restrict__ leaf_idx,
                   const bool* __restrict__ valid, int K,
                   uint8_t* __restrict__ out) {
  const int64_t row = blockIdx.x;          // b * K + k
  const int b = static_cast<int>(row / K);
  uint8_t* o = out + row * M;
  if (!valid[row]) {
    for (int m = threadIdx.x; m < M; m += kBlock) o[m] = 0;
    return;
  }
  const float4 q = queries[b];
  const float2* e = entries + static_cast<int64_t>(leaf_idx[row]) * M;
  for (int m = threadIdx.x; m < M; m += kBlock) {
    const float2 p = e[m];
    o[m] = (p.x >= q.x) && (p.x <= q.z) && (p.y >= q.y) && (p.y <= q.w);
  }
}

}  // namespace

// queries [B,4] f32; entries [L,M,2] f32; leaf_idx [B,K] i32 in [0, L);
// valid [B,K] bool; out [B,K,M] bytes. Returns the launch's cudaError_t.
extern "C" int leaf_refine_launch(const float* queries, const float* entries,
                                  int M, const int* leaf_idx,
                                  const bool* valid, int B, int K,
                                  uint8_t* out, void* stream) {
  if (B <= 0 || K <= 0 || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned rows = static_cast<unsigned>(B) * static_cast<unsigned>(K);
  leaf_refine_kernel<<<rows, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(queries),
      reinterpret_cast<const float2*>(entries), M, leaf_idx, valid, K, out);
  return static_cast<int>(cudaGetLastError());
}
