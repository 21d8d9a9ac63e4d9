// Exact point-in-rectangle refinement over the entries of named leaves,
// with each slot's hit count.
//
// Replaces leaf_refine (src/repro/kernels/leaf_refine.py): for every
// (query b, slot k) the kernel tests the M entries of leaf leaf_idx[b,k]
// (clamped into [0, L)) against query b's closed rectangle and writes
// inside[b,k,:] and counts[b,k] = sum_m inside[b,k,m]; an invalid slot
// writes zeros. Entries padded with +inf never match.
//
// Design for Hopper: one warp per (query, slot) row, kRowsPerWarp rows a
// warp in turn and kWarps warps a CTA (32 rows: a narrow batch of B 512,
// K 64 is 1,024 CTAs). The warp reads its rows' ids and validity once,
// one row a lane, and clamps the ids itself (the wrapper issues no
// clamp). Invalid rows read no leaf data: the warp strides over the
// group's bytes and zeroes theirs, 16 bytes a lane when M is a multiple
// of 16 (at M 128 one store instruction covers four rows). On a valid
// row each lane takes 4 consecutive entries a step: two 16-byte
// read-only loads of the leaf's [M, 2] tile and one 4-byte store of four
// 0/1 bytes, so at M 128 one step covers the row (1 KB read, 128 B
// written). The hits are summed across the warp in the same pass and
// the row's lane writes the count: the [B, K, M] mask is never read back
// to count it. Only the leaves the slot table names are touched, which
// is the paper's I/O saving (the TPU form gets it from scalar-prefetched
// BlockSpecs). Four rows a warp, not one: at the join's wide K 512,
// where 95% of the rows are invalid, a CTA of a few rows spends its time
// being scheduled (PERF.md).
//
// Bound: bytes. Reads are B*16 of queries, B*K*5 of slot table and each
// named leaf's M*8 bytes once; writes are B*K*M bytes of mask and B*K*4
// of counts. There are 4 compares per entry.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;                 // warps per CTA
constexpr int kRowsPerWarp = 4;           // (query, slot) rows a warp
constexpr int kBlock = kWarps * 32;
constexpr unsigned kAll = 0xffffffffu;

// Zero the invalid rows (bits of ``invalid``) among a warp's n_rows rows
// from o on: lanes stride over the rows' bytes, W bytes (a V) at a time.
template <int W, typename V>
__device__ void zero_rows(uint8_t* o, int M, int n_rows, unsigned invalid,
                          int lane) {
  const int n = n_rows * M / W;
  for (int c = lane; c < n; c += 32)
    if (invalid >> (c * W / M) & 1u) reinterpret_cast<V*>(o)[c] = V{};
}

__global__ void __launch_bounds__(kBlock)
leaf_refine_kernel(const float4* __restrict__ queries,
                   const float4* __restrict__ entries, int L, int M,
                   const int* __restrict__ leaf_idx,
                   const bool* __restrict__ valid, int64_t rows, int K,
                   uint8_t* __restrict__ out, int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x) * kWarps +
                        (threadIdx.x >> 5)) * kRowsPerWarp;  // b * K + k
  if (row0 >= rows) return;                  // uniform across the warp
  const int n_rows = rows - row0 < kRowsPerWarp
                         ? static_cast<int>(rows - row0) : kRowsPerWarp;
  // lane r < n_rows: row r's validity and clamped leaf id
  bool ok = false;
  int leaf = 0;
  if (lane < n_rows) {
    ok = valid[row0 + lane];
    leaf = leaf_idx[row0 + lane];
    leaf = leaf < 0 ? 0 : (leaf >= L ? L - 1 : leaf);
  }
  const unsigned ok_bits = __ballot_sync(kAll, ok);
  const unsigned invalid = ((1u << n_rows) - 1u) & ~ok_bits;
  uint8_t* o = out + row0 * M;
  if (M % 16 == 0)
    zero_rows<16, uint4>(o, M, n_rows, invalid, lane);
  else
    zero_rows<4, uint32_t>(o, M, n_rows, invalid, lane);
  int count = 0;                             // lane r: row r's count
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (r >= n_rows) break;
    if (!(ok_bits >> r & 1u)) continue;      // uniform across the warp
    const int64_t row = row0 + r;
    const float4 q = queries[row / K];
    // entry m of the leaf is half of the float4 at (leaf * M + m) / 2
    const int lf = __shfl_sync(kAll, leaf, r);
    const float4* e = entries + (static_cast<int64_t>(lf) * M >> 1);
    uint8_t* orow = out + row * M;
    int n = 0;
    for (int m = lane * 4; m < M; m += 32 * 4) {
      const float4 a = e[m >> 1];            // entries m, m + 1
      const float4 c = e[(m >> 1) + 1];      // entries m + 2, m + 3
      const uint32_t h0 = (a.x >= q.x) & (a.x <= q.z) & (a.y >= q.y) &
                          (a.y <= q.w);
      const uint32_t h1 = (a.z >= q.x) & (a.z <= q.z) & (a.w >= q.y) &
                          (a.w <= q.w);
      const uint32_t h2 = (c.x >= q.x) & (c.x <= q.z) & (c.y >= q.y) &
                          (c.y <= q.w);
      const uint32_t h3 = (c.z >= q.x) & (c.z <= q.z) & (c.w >= q.y) &
                          (c.w <= q.w);
      *reinterpret_cast<uint32_t*>(orow + m) =
          h0 | h1 << 8 | h2 << 16 | h3 << 24;
      n += h0 + h1 + h2 + h3;
    }
    n = __reduce_add_sync(kAll, n);
    if (lane == r) count = n;
  }
  if (lane < n_rows) counts[row0 + lane] = count;
}

}  // namespace

// queries [B,4] f32; entries [L,M,2] f32, M a multiple of 4, 16-byte
// aligned; leaf_idx [B,K] i32 (any value: clamped into [0, L)); valid
// [B,K] bool; out [B,K,M] bytes; counts [B,K] i32. Returns the launch's
// cudaError_t.
extern "C" int leaf_refine_launch(const float* queries, const float* entries,
                                  int L, int M, const int* leaf_idx,
                                  const bool* valid, int B, int K,
                                  uint8_t* out, int* counts, void* stream) {
  if (B <= 0 || K <= 0 || L <= 0 || M <= 0 || M % 4 != 0 ||
      reinterpret_cast<uintptr_t>(queries) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(entries) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = static_cast<int64_t>(B) * K;
  const int64_t per_cta = kWarps * kRowsPerWarp;
  const int64_t blocks = (rows + per_cta - 1) / per_cta;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  leaf_refine_kernel<<<static_cast<unsigned>(blocks), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(queries),
      reinterpret_cast<const float4*>(entries), L, M, leaf_idx, valid, rows,
      K, out, counts);
  return static_cast<int>(cudaGetLastError());
}
