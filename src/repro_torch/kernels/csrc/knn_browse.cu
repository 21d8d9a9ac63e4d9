// Distance browsing over the entries of named leaves (kNN serving), in
// two forms.
//
// Replaces knn_browse (src/repro/kernels/knn_browse.py) and, in the
// selecting form, the top-k after it (src/repro/core/knn.py:90-96).
//
// knn_browse_kernel (the TPU kernel's own contract): for every (query b,
// slot k) the squared distance from query b's centre to each of the M
// entries of leaf leaf_idx[b,k], or +inf when the entry lies outside the
// probed radius (d2 > r2), when the slot is invalid, and on +inf padding
// (whose distance is +inf by arithmetic): out [B, K, M]. One CTA per
// (query, slot) row, threads over M; an invalid slot writes +inf without
// reading leaf data. The caller clamps slot ids into [0, L).
//
// knn_browse_kernel_topk (what knn_query serves through): the same
// distances, but only the k smallest in-radius ones of each row leave the
// chip, ascending, ties to the lower flat position slot*M + m (the order
// lax.top_k of -d2 gives), with the winners' entry ids and the row's
// count of in-radius candidates. Fewer than k in radius: +inf and id -1
// past them. The [B, K, M] tensor, a sort of it and a gather of every
// candidate's id never exist. Design for Hopper: one CTA per query row,
// kTopWarps warps over (valid slot, 64-entry chunk) units, a lane per
// two entries (one 16-byte load). The row's slot table is staged in
// shared memory first, the ids clamped into [0, L), with a list of the
// valid slots (a ballot and one shared atomic a warp), so no warp spends
// a step on an invalid slot (95% of the 872K deployment's wide table)
// and none reads its leaf; a warp loads kUnroll units before it tests
// any. A candidate is a packed 64-bit key: the d2 bits high (d2 >=
// +0 and never NaN after the radius test, so the bit order is the value
// order), the flat position low, so keys are distinct and their order is
// the tie rule. Each thread keeps its KT smallest keys (KT the power of
// two >= k) sorted in registers; one compare against its KT-th rejects
// most candidates. A warp whose lanes hold at most 32 keys in all
// gathers them one a lane (a scan of the list lengths) and sorts them by
// a warp bitonic sort; a fuller warp merges its lanes' lists by xor
// shuffles (the smaller half of two sorted lists by one min step, then a
// bitonic merge). Warp 0 merges the warps' lists the same way, in
// log2(kTopWarps) steps, and its first k lanes write the winners,
// gathering their ids. Largest k: kMaxK (64).
//
// Both forms compute d2 as __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy,
// dy)): nvcc would otherwise contract it into an fma, and the plain
// version (and the kNN brute-force oracle) round the two products
// separately, so the kernels match them bit for bit.
//
// Bound: bytes. The selecting form reads the valid slots' distinct
// leaves (M*8 bytes each), B*K*5 bytes of slot table and writes
// B*(2k+1)*4 bytes; the d2 form also writes B*K*M*4 bytes of distances.
// 6 flops and a compare per entry of a valid slot.
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

// ---------------------------------------------------------------------------
// the selecting form

using u64 = unsigned long long;

constexpr int kTopWarps = 8;
constexpr int kTopBlock = kTopWarps * 32;
constexpr int kUnroll = 4;        // units a warp loads before it tests
constexpr int kMaxK = 64;
constexpr u64 kEmpty = ~0ull;     // sorts after every key
constexpr unsigned kAll = 0xffffffffu;

// Insert key into the ascending list L (the largest falls off).
template <int KT>
__device__ __forceinline__ void insert(u64 (&L)[KT], u64 key) {
#pragma unroll
  for (int i = 0; i < KT; ++i) {
    const u64 lo = key < L[i] ? key : L[i];
    key = key < L[i] ? L[i] : key;
    L[i] = lo;
  }
}

// L := the KT smallest of L and the list of lane (lane ^ o), both
// ascending: the element-wise min of L and the partner's list reversed is
// a bitonic sequence holding them, and a bitonic merge sorts it.
template <int KT>
__device__ __forceinline__ void merge_lane(u64 (&L)[KT], int o) {
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    const u64 a = __shfl_xor_sync(kAll, L[KT - 1 - i], o);
    const u64 b = __shfl_xor_sync(kAll, L[i], o);
    L[i] = a < L[i] ? a : L[i];
    L[KT - 1 - i] = b < L[KT - 1 - i] ? b : L[KT - 1 - i];
  }
#pragma unroll
  for (int j = KT / 2; j > 0; j >>= 1) {
#pragma unroll
    for (int i = 0; i < KT; ++i) {
      if ((i & j) == 0) {
        const u64 a = L[i], c = L[i | j];
        L[i] = a < c ? a : c;
        L[i | j] = a < c ? c : a;
      }
    }
  }
}

// After it every lane of each group of 2*first lanes holds the group's KT
// smallest keys, ascending (first 16: the whole warp's).
template <int KT>
__device__ __forceinline__ void merge_warp(u64 (&L)[KT], int first = 16) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    if (o <= first) merge_lane<KT>(L, o);
}

// One key a lane, sorted ascending across the warp (a bitonic sort).
__device__ __forceinline__ u64 sort_warp(u64 x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 y = __shfl_xor_sync(kAll, x, stride);
      const bool keep_min = ((lane & stride) == 0) == ((lane & size) == 0);
      x = keep_min == (y < x) ? y : x;
    }
  }
  return x;
}

template <int KT>
__global__ void __launch_bounds__(kTopBlock)
knn_browse_kernel_topk(const float* __restrict__ centers,
                       const float4* __restrict__ entries, int L, int M,
                       const int* __restrict__ entry_ids,
                       const int* __restrict__ leaf_idx,
                       const bool* __restrict__ valid, int K, int k,
                       float* __restrict__ d2k, int* __restrict__ ids,
                       int* __restrict__ n_within) {
  // tab[s]: slot s's clamped leaf, -1 when invalid; tab[K + i]: the i-th
  // valid slot, in no particular order (a key carries its own slot)
  extern __shared__ int tab[];
  __shared__ u64 lists[kTopWarps][KT];
  __shared__ u64 spill[kTopWarps][32];      // a sparse warp's keys
  __shared__ int within[kTopWarps];
  __shared__ int n_valid;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r0 = static_cast<int64_t>(b) * K;
  if (threadIdx.x == 0) n_valid = 0;
  const float cx = centers[3 * b];
  const float cy = centers[3 * b + 1];
  const float r2 = centers[3 * b + 2];
  __syncthreads();
  for (int s0 = warp * 32; s0 < K; s0 += kTopBlock) {
    const int s = s0 + lane;
    const bool ok = s < K && valid[r0 + s];
    if (s < K) tab[s] = ok ? min(max(leaf_idx[r0 + s], 0), L - 1) : -1;
    const unsigned m = __ballot_sync(kAll, ok);
    int base = 0;
    if (lane == 0 && m) base = atomicAdd(&n_valid, __popc(m));
    base = __shfl_sync(kAll, base, 0);
    if (ok) tab[K + base + __popc(m & ((1u << lane) - 1u))] = s;
  }
  __syncthreads();

  u64 list[KT];
#pragma unroll
  for (int i = 0; i < KT; ++i) list[i] = kEmpty;
  int n_in = 0;
  const int M2 = M >> 1;                     // 16-byte pairs a leaf
  const int per_slot = (M2 + 31) >> 5;       // units a slot
  const int n_units = n_valid * per_slot;
  for (int u0 = warp; u0 < n_units; u0 += kTopWarps * kUnroll) {
    float4 v[kUnroll];
    int pos[kUnroll];                        // flat position of v's first
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      const int u = u0 + t * kTopWarps;
      pos[t] = -1;
      if (u < n_units) {
        const int i = u / per_slot;
        const int s = tab[K + i];
        const int leaf = tab[s];
        const int j = (u - i * per_slot) * 32 + lane;
        if (j < M2) {
          v[t] = entries[static_cast<int64_t>(leaf) * M2 + j];
          pos[t] = s * M + 2 * j;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kUnroll; ++t) {
      if (pos[t] < 0) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float dx = __fsub_rn(h ? v[t].z : v[t].x, cx);
        const float dy = __fsub_rn(h ? v[t].w : v[t].y, cy);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        if (d2 <= r2 && d2 < INFINITY) {
          ++n_in;
          const u64 key = static_cast<u64>(__float_as_uint(d2)) << 32 |
                          static_cast<unsigned>(pos[t] + h);
          if (key < list[KT - 1]) insert<KT>(list, key);
        }
      }
    }
  }

  // The warp's KT smallest into lists[warp]. A warp holding at most 32
  // keys (the common case: ~100 in radius over a row's 256 threads)
  // gathers them one a lane and sorts them; a fuller one merges the
  // lanes' lists.
  const int len = min(n_in, KT);
  const int total = __reduce_add_sync(kAll, len);
  if (total <= 32) {
    int off = len;                           // exclusive scan of len
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAll, off, o);
      if (lane >= o) off += y;
    }
    off -= len;
#pragma unroll
    for (int i = 0; i < KT; ++i)
      if (i < len) spill[warp][off + i] = list[i];
    __syncwarp();
    u64 x = lane < total ? spill[warp][lane] : kEmpty;
    if (total > 1) x = sort_warp(x, lane);
    for (int i = lane; i < KT; i += 32) lists[warp][i] = i < 32 ? x : kEmpty;
  } else {
    merge_warp<KT>(list);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < KT; ++i) lists[warp][i] = list[i];
    }
  }
  n_in = __reduce_add_sync(kAll, n_in);
  if (lane == 0) within[warp] = n_in;
  __syncthreads();
  if (warp != 0) return;
  // lanes 0 .. kTopWarps-1 hold the warps' lists: log2(kTopWarps) steps
#pragma unroll
  for (int i = 0; i < KT; ++i)
    list[i] = lane < kTopWarps ? lists[lane][i] : kEmpty;
  if (__any_sync(kAll, list[0] != kEmpty))
    merge_warp<KT>(list, kTopWarps / 2);
  if (lane == 0) {
    int n = 0;
#pragma unroll
    for (int w = 0; w < kTopWarps; ++w) n += within[w];
    n_within[b] = n;
  }
  // lane 0 holds the row's list (lanes past kTopWarps do not): share it
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < KT; ++i) lists[0][i] = list[i];
  }
  __syncwarp();
  for (int i = lane; i < k; i += 32) {
    const u64 key = lists[0][i];
    float d = INFINITY;
    int id = -1;
    if (key != kEmpty) {
      const int pos = static_cast<int>(key & 0xffffffffu);
      const int s = pos / M;
      d = __uint_as_float(static_cast<unsigned>(key >> 32));
      id = entry_ids[static_cast<int64_t>(tab[s]) * M + (pos - s * M)];
    }
    d2k[static_cast<int64_t>(b) * k + i] = d;
    ids[static_cast<int64_t>(b) * k + i] = id;
  }
}

template <int KT>
int launch_topk(const float* centers, const float* entries, int L, int M,
                const int* entry_ids, const int* leaf_idx, const bool* valid,
                int B, int K, int k, float* d2k, int* ids, int* n_within,
                cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(K) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        knn_browse_kernel_topk<KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  knn_browse_kernel_topk<KT><<<B, kTopBlock, smem, stream>>>(
      centers, reinterpret_cast<const float4*>(entries), L, M, entry_ids,
      leaf_idx, valid, K, k, d2k, ids, n_within);
  return static_cast<int>(cudaGetLastError());
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

// centers [B,3] f32 (cx, cy, r2); entries [L,M,2] f32 (16-byte aligned, M
// even); entry_ids [L,M] i32; leaf_idx [B,K] i32 (any value: clamped into
// [0, L)); valid [B,K] bool; 1 <= k <= min(kMaxK, K*M) -> d2k [B,k] f32,
// ids [B,k] i32, n_within [B] i32. Returns the launch's cudaError_t.
extern "C" int knn_browse_topk_launch(const float* centers,
                                      const float* entries, int L, int M,
                                      const int* entry_ids,
                                      const int* leaf_idx, const bool* valid,
                                      int B, int K, int k, float* d2k,
                                      int* ids, int* n_within, void* stream) {
  if (B <= 0 || K <= 0 || L <= 0 || M <= 0 || M % 2 || k <= 0 ||
      k > kMaxK || static_cast<int64_t>(K) * M > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 8)
    return launch_topk<8>(centers, entries, L, M, entry_ids, leaf_idx, valid,
                          B, K, k, d2k, ids, n_within, s);
  if (k <= 16)
    return launch_topk<16>(centers, entries, L, M, entry_ids, leaf_idx,
                           valid, B, K, k, d2k, ids, n_within, s);
  if (k <= 32)
    return launch_topk<32>(centers, entries, L, M, entry_ids, leaf_idx,
                           valid, B, K, k, d2k, ids, n_within, s);
  return launch_topk<64>(centers, entries, L, M, entry_ids, leaf_idx, valid,
                         B, K, k, d2k, ids, n_within, s);
}
