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
// carries a running rank across grid steps; here a warp sweeps the whole
// buffer in order for one query and carries the rank itself, so no
// bitmap, block scan or barrier stands between the tests and the writes.
// A CTA of kWarps queries first stages the buffer into shared memory
// (cp.async, 16 bytes a thread, padded with +inf to a step; one
// barrier), so the buffer crosses L2 once a CTA and not once a query.
// A step covers kGroups groups of 64 points: in each a lane takes two
// consecutive points (one 16-byte shared load) and two ballots give the
// group's hits, the groups' loads and ballots independent of one
// another; a step without a hit in the warp (most of them: a query hits
// ~0.3 of 6,144 points) ends there. Otherwise, group by group, a lane's
// rank is the running count plus the popcounts of the hits below it, and
// a hit whose rank is below k writes its position directly. A buffer
// larger than shared memory is swept from global memory the same way
// (read-only loads; no staging). At the serving cap (8,192) that global
// sweep takes about 4x the staged one on an H100, which is why both
// paths stay.
//
// Bound: operations at the serving shapes. The compulsory traffic is the
// queries (16 B each), one read of the buffer (8 B a slot) and the
// B*(k+1) ints of slot table and counts; the compares are 4 per
// (query, staged point).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 4;    // queries a CTA, a warp each
constexpr int kBlock = kWarps * 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kGroups = 4;    // 64-point groups a step: 256 points
// Shared memory one CTA may ask for on sm_90, less the static reserve.
constexpr int kMaxStageBytes = 227 * 1024 - 1024;

__device__ __forceinline__ bool contains(const float4& q, float x, float y) {
  return (x >= q.x) && (x <= q.z) && (y >= q.y) && (y <= q.w);
}

// Points 2j and 2j + 1 of the buffer as one float4, +inf past cap.
__device__ __forceinline__ float4 pair(const float2* __restrict__ pts,
                                       int cap, int j) {
  const int i = 2 * j;
  if (i + 1 < cap) return __ldg(reinterpret_cast<const float4*>(pts) + j);
  const float2 p = i < cap ? pts[i] : make_float2(INFINITY, INFINITY);
  return make_float4(p.x, p.y, INFINITY, INFINITY);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem));
}

// Pairs of points (float4s) swept: cap rounded up to a step's points.
__host__ __device__ __forceinline__ int swept_pairs(int cap) {
  return (cap + 64 * kGroups - 1) / (64 * kGroups) * (32 * kGroups);
}

template <bool kStaged>
__global__ void __launch_bounds__(kBlock)
delta_probe_kernel(const float4* __restrict__ queries, int B,
                   const float2* __restrict__ pts, int cap, int k,
                   int* __restrict__ idx, int* __restrict__ cnt) {
  extern __shared__ float4 stage[];                 // [swept_pairs(cap)]
  const int n4 = swept_pairs(cap);
  if (kStaged) {
    const float4* src = reinterpret_cast<const float4*>(pts);
    for (int j = threadIdx.x; j < n4; j += kBlock) {
      if (2 * j + 1 < cap) cp_async16(stage + j, src + j);
      else stage[j] = pair(pts, cap, j);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;                                // warp-uniform
  const float4 q = queries[b];
  int* row = idx + static_cast<int64_t>(b) * k;
  const unsigned below = (1u << lane) - 1u;
  int n = 0;                                         // hits so far
  for (int j0 = 0; j0 < n4; j0 += 32 * kGroups) {
    bool h0[kGroups], h1[kGroups];
    unsigned m0[kGroups], m1[kGroups], any = 0u;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int j = j0 + 32 * g + lane;
      const float4 v = kStaged ? stage[j] : pair(pts, cap, j);
      h0[g] = contains(q, v.x, v.y);
      h1[g] = contains(q, v.z, v.w);
      m0[g] = __ballot_sync(kAll, h0[g]);
      m1[g] = __ballot_sync(kAll, h1[g]);
      any |= m0[g] | m1[g];
    }
    if (any == 0u) continue;                         // the common step
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int p = 2 * (j0 + 32 * g + lane);
      if (n < k) {
        const int r = n + __popc(m0[g] & below) + __popc(m1[g] & below);
        if (h0[g] && r < k) row[r] = p;
        if (h1[g] && r + h0[g] < k) row[r + h0[g]] = p + 1;
      }
      n += __popc(m0[g]) + __popc(m1[g]);
    }
  }
  for (int s = n + lane; s < k; s += 32) row[s] = 0;
  if (lane == 0) cnt[b] = n;
}

// Shared memory a CTA stages the buffer into, 0 when it is swept from
// global memory instead.
int smem_bytes(int cap) {
  const int64_t bytes = static_cast<int64_t>(swept_pairs(cap)) * 16;
  return bytes <= kMaxStageBytes ? static_cast<int>(bytes) : 0;
}

}  // namespace

// queries [B,4] f32; pts [cap,2] f32 (+inf on unstaged slots, 16-byte
// aligned) -> idx [B,k] i32, cnt [B] i32. Returns the launch's
// cudaError_t.
extern "C" int delta_probe_launch(const float* queries, int B,
                                  const float* pts, int cap, int k, int* idx,
                                  int* cnt, void* stream) {
  if (B <= 0 || cap < 0 || k <= 0 || cap > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(cap);
  const unsigned grid = (B + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* q = reinterpret_cast<const float4*>(queries);
  const float2* p = reinterpret_cast<const float2*>(pts);
  if (smem == 0 && cap > 0) {
    delta_probe_kernel<false><<<grid, kBlock, 0, s>>>(q, B, p, cap, k, idx,
                                                      cnt);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          delta_probe_kernel<true>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    delta_probe_kernel<true><<<grid, kBlock, smem, s>>>(q, B, p, cap, k,
                                                        idx, cnt);
  }
  return static_cast<int>(cudaGetLastError());
}
