// Space-filling-curve keys of normalized query centres.
//
// Replaces spatial_key_t (src/repro/kernels/spatial_key.py). Each centre
// (cx, cy), already normalized by the workload's bounding box, is
// quantized to `order`-bit integer coordinates (c * 2^order truncated
// toward zero, clipped to [0, 2^order)), then either bit-interleaved
// (Morton, x in the high bit of each pair) or run through the classic
// xy->d Hilbert walk, whose quadrant rotations are selects. All int32:
// at order 15 the key has 30 bits and the largest Hilbert term is 3*2^28.
//
// Design for Hopper: one thread per query, the order-bit loop unrolled in
// registers. The TPU kernel lays the centres out planar ([2, B], queries
// on lanes) for the VPU; here a thread reads its own float2, coalesced
// across the warp. __float2int_rz saturates out-of-range values (and maps
// NaN to 0) before the integer clip, which gives the plain version's
// clamp-then-cast result for every finite input.
//
// Bound: bytes and launch latency. 8 bytes in and 4 out per query and
// about 10 integer operations per bit: a 4096-query stream is 49 KB and
// ~0.6 M integer operations, far below a microsecond of the card.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;

template <bool kHilbert>
__global__ void __launch_bounds__(kBlock)
spatial_key_kernel(const float2* __restrict__ cxy, int B, int order,
                   int* __restrict__ keys) {
  const int b = blockIdx.x * kBlock + threadIdx.x;
  if (b >= B) return;
  const int n = 1 << order;
  const float fn = static_cast<float>(n);
  const float2 c = cxy[b];
  int x = min(max(__float2int_rz(__fmul_rn(c.x, fn)), 0), n - 1);
  int y = min(max(__float2int_rz(__fmul_rn(c.y, fn)), 0), n - 1);
  int key = 0;
  if (!kHilbert) {
    for (int i = 0; i < order; ++i)
      key |= (((x >> i) & 1) << (2 * i + 1)) | (((y >> i) & 1) << (2 * i));
  } else {
    for (int i = order - 1; i >= 0; --i) {
      const int s = 1 << i;
      const int rx = (x >> i) & 1;
      const int ry = (y >> i) & 1;
      key += s * s * ((3 * rx) ^ ry);
      const bool swap = ry == 0;
      const bool flip = swap && rx == 1;
      const int fx = flip ? s - 1 - x : x;
      const int fy = flip ? s - 1 - y : y;
      x = swap ? fy : fx;
      y = swap ? fx : fy;
    }
  }
  keys[b] = key;
}

}  // namespace

// cxy [B,2] f32 normalized centres; hilbert 1 (Hilbert) or 0 (Morton);
// 1 <= order <= 15; keys [B] i32. Returns the launch's cudaError_t.
extern "C" int spatial_key_launch(const float* cxy, int B, int hilbert,
                                  int order, int* keys, void* stream) {
  if (B <= 0 || order < 1 || order > 15)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kBlock - 1) / kBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* c = reinterpret_cast<const float2*>(cxy);
  if (hilbert)
    spatial_key_kernel<true><<<grid, kBlock, 0, s>>>(c, B, order, keys);
  else
    spatial_key_kernel<false><<<grid, kBlock, 0, s>>>(c, B, order, keys);
  return static_cast<int>(cudaGetLastError());
}
