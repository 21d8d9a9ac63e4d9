// Probe of the insert delta buffer, compacted into a slot table.
//
// Replaces delta_probe_t (src/repro/kernels/delta_probe.py): closed-
// rectangle containment of each query against every buffer point, turned
// into the first k hit positions in buffer (= insertion) order, zeros
// past the row's count, and the row's full hit total (exact past k). The
// [B, cap] containment mask never reaches device memory. Unstaged buffer
// slots hold +inf, so `p.x <= q.xmax` fails on them and the kernel never
// reads the staged count.
//
// Design for Hopper: the TPU kernel sweeps buffer tiles in order and
// carries a running rank across grid steps; here one CTA owns kQT queries
// and the whole buffer, so the order lives inside the CTA. Each warp takes
// 32 consecutive buffer points, one per lane (8-byte loads, coalesced),
// and one __ballot_sync per query gives that query's 32-point bitmap word
// with no atomics: a cap-bit bitmap per query in shared memory (1 KB at
// cap 8192). compact.cuh, the port of the TPU compaction epilogue shared
// with traverse_compact.cu and mlp_predict_compact.cu, turns each bitmap
// into the slot table with per-thread popcounts and one block scan. The
// wrapper raises when the bitmaps outgrow shared memory.
//
// Bound: bytes at the serving shapes. The compulsory traffic is the
// queries (16 B each), one read of the buffer (8 B a slot) and the
// B*(k+1) ints of slot table and counts; the compares are 4 per
// (query, staged point). Each CTA reads the whole buffer, from L2 after
// the first CTAs.
#include <cuda_runtime.h>

#include <cstdint>

#include "compact.cuh"

namespace {

constexpr int kQT = 4;        // queries per CTA
constexpr int kBlock = 256;   // threads per CTA
constexpr int kWarps = kBlock / 32;

__device__ __forceinline__ bool contains(const float4& q, const float2& p) {
  return (p.x >= q.x) && (p.x <= q.z) && (p.y >= q.y) && (p.y <= q.w);
}

__global__ void __launch_bounds__(kBlock)
delta_probe_kernel(const float4* __restrict__ queries, int B,
                   const float2* __restrict__ pts, int cap, int k,
                   int* __restrict__ idx, int* __restrict__ cnt) {
  extern __shared__ uint32_t bits[];                       // [kQT][n_words]
  const int n_words = (cap + 31) >> 5;
  __shared__ float4 q[kQT];
  const int b0 = blockIdx.x * kQT;
  const int nq = min(kQT, B - b0);
  const int t = threadIdx.x;
  if (t < kQT)   // rows past B are never compacted
    q[t] = t < nq ? queries[b0 + t] : make_float4(1.f, 1.f, 0.f, 0.f);
  __syncthreads();

  const int lane = t & 31;
  for (int base = (t >> 5) * 32; base < cap; base += kWarps * 32) {
    const int i = base + lane;
    const bool in = i < cap;
    const float2 p = in ? pts[i] : make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      const unsigned w = __ballot_sync(0xffffffffu, in && contains(q[j], p));
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

extern "C" int delta_probe_smem_bytes(int cap) {
  return kQT * ((cap + 31) / 32) * 4;
}

// queries [B,4] f32; pts [cap,2] f32 (+inf on unstaged slots) -> idx
// [B,k] i32, cnt [B] i32. Returns the launch's cudaError_t.
extern "C" int delta_probe_launch(const float* queries, int B,
                                  const float* pts, int cap, int k, int* idx,
                                  int* cnt, void* stream) {
  if (B <= 0 || cap < 0 || k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(delta_probe_smem_bytes(cap));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        delta_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  delta_probe_kernel<<<(B + kQT - 1) / kQT, kBlock, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(queries), B,
      reinterpret_cast<const float2*>(pts), cap, k, idx, cnt);
  return static_cast<int>(cudaGetLastError());
}
