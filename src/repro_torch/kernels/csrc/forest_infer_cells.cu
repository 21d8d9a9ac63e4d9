// Celled oblivious-forest inference: per-cell summed tree votes.
//
// Replaces forest_infer_cells (src/repro/kernels/forest_infer.py). Cell c
// owns the T trees c*T .. c*T+T-1 of the flattened (cell, tree) axis. For
// query b and tree r = c*T + t, the leaf code is
//   code = sum_d (features[b, feat_idx[r, d]] > thresh[r, d]) * 2^(D-1-d)
// and out[b, c, :] = sum over t, in ascending t, of tables[r, code, :].
//
// Design for Hopper: the TPU kernel gathers the features outside the
// kernel into a [B, C*T, D] array, turns each code into a one-hot row and
// multiplies it into the table on the MXU, accumulating the trees in a
// revisited output block. Here the output, [B, C, Cl] f32 (549 MB for the
// deployment's 512 queries x 400 cells x 670 labels), is the work: the
// kernel is a row pass bound by its writes. One CTA owns one cell and kQT
// queries, and the grid is cell-major (the query tiles of a cell run
// together and share its table rows in L2).
//  1. codes: each (query, tree) reads its D features in place (feat_idx
//     names the column: the [B, C*T, D] intermediate never exists),
//     wrapped once then clamped as the reference's gather takes them, and
//     builds code = (code << 1) | bit (exact for D <= 24, which the
//     launcher enforces) into shared memory.
//  2. votes: a warp writes one query's output row of Cl floats at a time,
//     whole: 16-byte streaming stores (__stcs: the caller reads the
//     output, not this kernel) at the row's 16-byte aligned addresses,
//     lane k on the k-th, and the up to 3 floats before the first (lanes
//     0-3) and after the last (lanes 4-7) one at a time. A row starts at
//     (b*C + c)*Cl floats, so its alignment varies with Cl; each lane
//     loads the T trees' table floats under its four output floats (one
//     16-byte load where the table row's address allows, else two 8-byte
//     or four 4-byte loads) and sums them in ascending t in registers, the
//     order of the TPU grid (T innermost) and of the plain version's loop,
//     so the two agree bit for bit. Writing a row at a time, not a label
//     vector across several rows, is what lets the writes reach the
//     card's write rate. Offsets step a row at a time; nothing is divided
//     per element.
//
// Bound: bytes. The output [B, C, Cl] f32 is written once; the table rows
// the batch's codes name are read (each distinct row once at best); the
// features, feat_idx and thresh are small. The work is D compares per
// (query, tree) and T - 1 adds per output element.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQT = 32;       // queries per CTA
constexpr int kWarps = 4;
constexpr int kBlock = kWarps * 32;

// four floats from p, as wide as p's alignment allows (p's alignment is
// the same for every lane of a warp, so the branch does not diverge)
__device__ __forceinline__ float4 load4(const float* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15) == 0) return __ldg(reinterpret_cast<const float4*>(p));
  if ((a & 7) == 0) {
    const float2 lo = __ldg(reinterpret_cast<const float2*>(p));
    const float2 hi = __ldg(reinterpret_cast<const float2*>(p + 2));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__global__ void __launch_bounds__(kBlock)
forest_infer_cells_kernel(const float* __restrict__ features, int B, int F,
                          const int* __restrict__ feat_idx,
                          const float* __restrict__ thresh,
                          const float* __restrict__ tables, int C, int T,
                          int D, int Cl, float* __restrict__ out,
                          int n_tiles) {
  extern __shared__ int codes[];                 // [kQT][T]
  const int c = blockIdx.x / n_tiles;
  const int b0 = (blockIdx.x % n_tiles) * kQT;
  const int nq = min(kQT, B - b0);

  // leaf codes of this tile's queries under each of the cell's trees
  for (int i = threadIdx.x; i < nq * T; i += kBlock) {
    const int qi = i / T;
    const int t = i - qi * T;
    const int64_t r = static_cast<int64_t>(c) * T + t;
    const float* x = features + static_cast<int64_t>(b0 + qi) * F;
    const int* fi = feat_idx + r * D;
    const float* th = thresh + r * D;
    int code = 0;
    for (int d = 0; d < D; ++d) {
      int f = fi[d];
      f = f < 0 ? f + F : f;                     // wrap once, then clamp,
      f = f < 0 ? 0 : (f >= F ? F - 1 : f);      // as the gather does
      code = (code << 1) | (x[f] > th[d] ? 1 : 0);
    }
    codes[qi * T + t] = code;
  }
  __syncthreads();

  // votes: a warp a whole output row at a time, the T trees in order
  const int lane = threadIdx.x & 31;
  const int64_t tree = (static_cast<int64_t>(1) << D) * Cl;  // floats
  const float* cell = tables + static_cast<int64_t>(c) * T * tree;
  for (int qi = threadIdx.x >> 5; qi < nq; qi += kWarps) {
    float* o = out + (static_cast<int64_t>(b0 + qi) * C + c) * Cl;
    const int* cq = codes + qi * T;
    const int head = min(static_cast<int>(
        ((16 - (reinterpret_cast<uintptr_t>(o) & 15)) & 15) >> 2), Cl);
    const int nb = (Cl - head) >> 2;             // aligned float4s
    for (int k = lane; k < nb; k += 32) {
      const int x = head + 4 * k;
      const float* src = cell + static_cast<int64_t>(cq[0]) * Cl + x;
      float4 acc = load4(src);
      for (int t = 1; t < T; ++t) {
        const float4 v = load4(cell + t * tree +
                               static_cast<int64_t>(cq[t]) * Cl + x);
        acc = make_float4(acc.x + v.x, acc.y + v.y, acc.z + v.z,
                          acc.w + v.w);
      }
      __stcs(reinterpret_cast<float4*>(o + x), acc);
    }
    const int tail = head + 4 * nb;
    const int x = lane < 4 ? lane : tail + lane - 4;
    if (lane < 4 ? x < head : lane < 8 && x < Cl) {
      float acc = __ldg(cell + static_cast<int64_t>(cq[0]) * Cl + x);
      for (int t = 1; t < T; ++t)
        acc += __ldg(cell + t * tree + static_cast<int64_t>(cq[t]) * Cl + x);
      __stcs(o + x, acc);
    }
  }
}

}  // namespace

// features [B,F] f32, feat_idx [C*T,D] i32, thresh [C*T,D] f32,
// tables [C*T,2^D,Cl] f32 -> out [B,C,Cl] f32. Returns the launch's
// cudaError_t; launches nothing (and returns 0) when B is 0.
extern "C" int forest_infer_cells_launch(const float* features, int B, int F,
                                         const int* feat_idx,
                                         const float* thresh,
                                         const float* tables, int C, int T,
                                         int D, int Cl, float* out,
                                         void* stream) {
  if (B < 0 || F <= 0 || C <= 0 || T <= 0 || D <= 0 || D > 24 || Cl <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int n_tiles = (B + kQT - 1) / kQT;
  const int64_t n_blocks = static_cast<int64_t>(n_tiles) * C;
  if (n_blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kQT) * T * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        forest_infer_cells_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  forest_infer_cells_kernel<<<static_cast<unsigned>(n_blocks), kBlock, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      features, B, F, feat_idx, thresh, tables, C, T, D, Cl, out, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
