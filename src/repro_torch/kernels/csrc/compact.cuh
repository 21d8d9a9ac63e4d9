// Block-wide compaction of a per-row bitmap in shared memory.
//
// Replaces the TPU compaction epilogue (src/repro/kernels/epilogue.py,
// compact_epilogue_tpu / compact_epilogue_interp): a row's selected
// columns become a slot table of the first k column ids in column order,
// plus the row's total count of selected columns. The TPU form ranks set
// lanes with a cumsum and scatters through rank-equality compares because
// Mosaic has no lane scatter; here the row is a bitmap of 32-bit words in
// shared memory and the ranks come from per-thread popcounts and one block
// exclusive scan, after which each thread writes its own words' ids
// directly.
//
// Work split: thread t owns the contiguous word run
// [t*per, min((t+1)*per, n_words)), so thread order is column order and a
// thread's exclusive prefix is the rank of its first set bit. Bound: the
// bitmap is read once from shared memory (n_words*4 bytes) and k ids are
// written; for the sizes served (tens of thousands of columns) the block
// scan's two barriers dominate, not bandwidth.
//
// Used by mlp_predict_compact.cu (delta_probe.cu ranks its own hits since
// its redesign).
#pragma once

#include <cstdint>

namespace repro_torch {

// Exclusive block scan of one int per thread; returns the thread's
// exclusive prefix and writes the block total to *total (shared).
template <int BLOCK>
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_buf,
                                                    int* total) {
  static_assert(BLOCK % 32 == 0 && BLOCK <= 1024, "BLOCK must be warps");
  constexpr int NW = BLOCK / 32;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(full, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_buf[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int w = lane < NW ? warp_buf[lane] : 0;
    int wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(full, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < NW) warp_buf[lane] = wi - w;   // exclusive warp offsets
    if (lane == NW - 1) *total = wi;
  }
  __syncthreads();
  return warp_buf[wid] + incl - v;
}

// Compact the set bits of `bits[0 .. n_words)` (column c is bit c&31 of
// word c>>5) into idx_row[0 .. k): the first k set columns in increasing
// order, zeros past the count; *cnt_out receives the total set count.
// All threads of the block must call it; bits must be visible (barrier
// before the call).
template <int BLOCK>
__device__ void block_compact_bitmap(const uint32_t* bits, int n_words,
                                     int k, int* idx_row, int* cnt_out) {
  __shared__ int warp_buf[32];
  __shared__ int total;
  const int per = (n_words + BLOCK - 1) / BLOCK;
  const int w0 = min(static_cast<int>(threadIdx.x) * per, n_words);
  const int w1 = min(w0 + per, n_words);
  int mine = 0;
  for (int w = w0; w < w1; ++w) mine += __popc(bits[w]);
  int rank = block_exclusive_scan<BLOCK>(mine, warp_buf, &total);
  for (int w = w0; w < w1 && rank < k; ++w) {
    uint32_t m = bits[w];
    while (m != 0u && rank < k) {
      int b = __ffs(m) - 1;
      idx_row[rank++] = (w << 5) + b;
      m &= m - 1u;
    }
  }
  const int n = total;
  for (int s = n + static_cast<int>(threadIdx.x); s < k; s += BLOCK)
    idx_row[s] = 0;
  if (threadIdx.x == 0) *cnt_out = n;
}

}  // namespace repro_torch
