// Batched rectangle-intersection mask: queries [B,4] x MBRs [N,4] -> [B,N].
//
// Replaces mbr_intersect_t (src/repro/kernels/mbr_intersect.py): closed
// rectangles, q0 <= m2 && m0 <= q2 && q1 <= m3 && m1 <= q3. It is the
// rectangle test of each level on the walk ladder's last rung (the
// per-level loop, ops._per_level_walk) and the whole walk of a
// single-level tree.
//
// Design for Hopper: a grid over (chunk of MBRs, tile of kQT queries),
// the query tile in shared memory. Threads stride over the chunk, each
// loading one MBR as a float4 and writing its byte for every query of the
// tile, so each query row is written by consecutive threads (coalesced
// along N). The TPU kernel's planar [4, N] layout exists for its lanes;
// here the [N, 4] rows load as one 16-byte vector. Output offsets are
// 64-bit: B * N passes 2^31 at the sizes the per-level rung serves.
//
// Bound: bytes. B*N bytes written against 16*(B+N) read; 4 compares per
// (query, MBR).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQT = 32;        // queries per CTA
constexpr int kBlock = 256;    // threads per CTA
constexpr int kChunk = 4096;   // MBRs per CTA

__global__ void __launch_bounds__(kBlock)
mbr_intersect_kernel(const float4* __restrict__ queries, int B,
                     const float4* __restrict__ mbrs, int N,
                     uint8_t* __restrict__ out) {
  __shared__ float4 q[kQT];
  const int b0 = blockIdx.y * kQT;
  const int nq = min(kQT, B - b0);
  const int t = threadIdx.x;
  if (t < nq) q[t] = queries[b0 + t];
  __syncthreads();

  const int c0 = blockIdx.x * kChunk;
  const int c1 = min(c0 + kChunk, N);
  for (int i = c0 + t; i < c1; i += kBlock) {
    const float4 m = mbrs[i];
    for (int j = 0; j < nq; ++j) {
      const float4 r = q[j];
      out[static_cast<int64_t>(b0 + j) * N + i] =
          (r.x <= m.z) && (m.x <= r.z) && (r.y <= m.w) && (m.y <= r.w);
    }
  }
}

}  // namespace

// queries [B,4] f32, mbrs [N,4] f32 -> out [B,N] bytes. Returns the
// launch's cudaError_t.
extern "C" int mbr_intersect_launch(const float* queries, int B,
                                    const float* mbrs, int N, uint8_t* out,
                                    void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((N + kChunk - 1) / kChunk, (B + kQT - 1) / kQT);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  mbr_intersect_kernel<<<grid, kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(queries), B,
      reinterpret_cast<const float4*>(mbrs), N, out);
  return static_cast<int>(cudaGetLastError());
}
