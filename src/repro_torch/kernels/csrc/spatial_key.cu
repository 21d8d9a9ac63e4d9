// Space-filling-curve keys of query rects, normalized by a frame.
//
// Replaces spatial_key_t (src/repro/kernels/spatial_key.py) together with
// the normalization its wrapper runs before it: each rect's centre
// ((q0 + q2) * 0.5, (q1 + q3) * 0.5) is normalized by the frame
// (xmin, ymin, xmax, ymax) as (c - lo) / max(hi - lo, 1e-12), quantized to
// `order`-bit integer coordinates (c * 2^order truncated toward zero,
// clipped to [0, 2^order)), then either bit-interleaved (Morton, x in the
// high bit of each pair) or run through the classic xy->d Hilbert walk,
// whose quadrant rotations are selects. All int32: at order 15 the key
// has 30 bits and the largest Hilbert term is 3*2^28.
//
// What held the first design back: the kernel took normalized centres,
// so each call first ran about nine PyTorch launches (the centre sums and
// halvings, the span, the clamp, a stack, a subtraction, a division), and
// the kernel itself sits at the floor of any launch.
//
// Design for Hopper: one thread per query, one launch. The TPU kernel
// took planar normalized centres because its VPU wanted them on lanes;
// here a thread reads its own rect in one 16-byte load, the CTA reads the
// frame's 16 bytes once into shared memory, and the normalization runs in
// registers, in the plain version's order with explicit round-to-nearest
// operations (no contraction, no fast division: the keys are bit-equal).
// The span keeps the plain clamp's NaN (a select, not fmaxf). The
// order-bit loop is unrolled in registers. __float2int_rz saturates
// out-of-range values (and maps NaN to 0) before the integer clip, which
// gives the plain version's clamp-then-cast result for every non-NaN
// input.
//
// Bound: bytes and launch latency. 16 bytes in and 4 out per query, about
// 8 float operations and 10 integer operations per bit: a 4096-query
// stream is 82 KB and ~1 M operations, far below a microsecond of the
// card.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;

// max(d, 1e-12) as the plain clamp computes it: NaN stays NaN
__device__ __forceinline__ float span(float d) {
  return d < 1e-12f ? 1e-12f : d;
}

template <bool kHilbert>
__global__ void __launch_bounds__(kBlock)
spatial_key_kernel(const float4* __restrict__ rects,
                   const float4* __restrict__ frame, int B, int order,
                   int* __restrict__ keys) {
  __shared__ float4 f;
  const int b = blockIdx.x * kBlock + threadIdx.x;
  if (threadIdx.x == 0) f = *frame;
  const float4 r = b < B ? rects[b] : make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  if (b >= B) return;
  const float cx = __fmul_rn(__fadd_rn(r.x, r.z), 0.5f);
  const float cy = __fmul_rn(__fadd_rn(r.y, r.w), 0.5f);
  const float nx = __fdiv_rn(__fsub_rn(cx, f.x), span(__fsub_rn(f.z, f.x)));
  const float ny = __fdiv_rn(__fsub_rn(cy, f.y), span(__fsub_rn(f.w, f.y)));
  const int n = 1 << order;
  const float fn = static_cast<float>(n);
  int x = min(max(__float2int_rz(__fmul_rn(nx, fn)), 0), n - 1);
  int y = min(max(__float2int_rz(__fmul_rn(ny, fn)), 0), n - 1);
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

// rects [B,4] f32 and frame [4] f32 (xmin, ymin, xmax, ymax), both on the
// device and 16-byte aligned; hilbert 1 (Hilbert) or 0 (Morton);
// 1 <= order <= 15; keys [B] i32. Returns the launch's cudaError_t.
extern "C" int spatial_key_launch(const float* rects, const float* frame,
                                  int B, int hilbert, int order, int* keys,
                                  void* stream) {
  if (B <= 0 || order < 1 || order > 15 ||
      (reinterpret_cast<uintptr_t>(rects) & 15) ||
      (reinterpret_cast<uintptr_t>(frame) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kBlock - 1) / kBlock);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* r = reinterpret_cast<const float4*>(rects);
  const float4* f = reinterpret_cast<const float4*>(frame);
  if (hilbert)
    spatial_key_kernel<true><<<grid, kBlock, 0, s>>>(r, f, B, order, keys);
  else
    spatial_key_kernel<false><<<grid, kBlock, 0, s>>>(r, f, B, order, keys);
  return static_cast<int>(cudaGetLastError());
}
