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
// revisited output block. Here one CTA owns kQT queries and one cell. It
// reads each query's features in place (feat_idx names the column, so the
// [B, C*T, D] intermediate never exists), builds the leaf code as
// code = (code << 1) | bit (exact for D <= 24, which the launcher
// enforces), and keeps the kQT x T codes in shared memory. Then threads
// stride over the tile's (query, label) pairs, neighbouring threads on
// neighbouring labels of one table row, and each sums its T votes in tree
// order in a register before one store: the order of the TPU grid (T
// innermost) and of the plain version's loop, so the two agree bit for
// bit. (One flat stride over all kQT x Cl pairs keeps every lane busy; a
// loop over the queries with a stride over each one's labels idles the
// lanes past Cl's last multiple of the block and was slower.)
//
// Bound: bytes. The output [B, C, Cl] f32 is written once; the table rows
// the batch's codes name are read (each distinct row once at best); the
// features, feat_idx and thresh are small. The work is D compares per
// (query, tree) and T - 1 adds per output element.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQT = 32;       // queries per CTA
constexpr int kBlock = 128;   // threads per CTA

__global__ void __launch_bounds__(kBlock)
forest_infer_cells_kernel(const float* __restrict__ features, int B, int F,
                          const int* __restrict__ feat_idx,
                          const float* __restrict__ thresh,
                          const float* __restrict__ tables, int C, int T,
                          int D, int Cl, float* __restrict__ out) {
  extern __shared__ int codes[];                 // [kQT][T]
  const int64_t tile = blockIdx.x / C;
  const int c = static_cast<int>(blockIdx.x % C);
  const int64_t b0 = tile * kQT;
  const int64_t rest = B - b0;
  const int nq = rest < kQT ? static_cast<int>(rest) : kQT;
  const int64_t n_leaves = int64_t{1} << D;

  // leaf codes of this tile's queries under each of the cell's trees
  for (int i = threadIdx.x; i < nq * T; i += kBlock) {
    const int q = i / T;
    const int t = i % T;
    const int64_t r = static_cast<int64_t>(c) * T + t;
    const float* x = features + (b0 + q) * F;
    int code = 0;
    for (int d = 0; d < D; ++d) {
      int f = feat_idx[r * D + d];
      f = f < 0 ? 0 : (f >= F ? F - 1 : f);      // clamp, as a gather does
      code = (code << 1) | (x[f] > thresh[r * D + d] ? 1 : 0);
    }
    codes[q * T + t] = code;
  }
  __syncthreads();

  // votes: one (query, label) pair per thread, the T trees in order
  const int64_t n_out = static_cast<int64_t>(nq) * Cl;
  for (int64_t i = threadIdx.x; i < n_out; i += kBlock) {
    const int q = static_cast<int>(i / Cl);
    const int l = static_cast<int>(i % Cl);
    const int64_t r0 = static_cast<int64_t>(c) * T;
    float acc = tables[(r0 * n_leaves + codes[q * T]) * Cl + l];
    for (int t = 1; t < T; ++t)
      acc += tables[((r0 + t) * n_leaves + codes[q * T + t]) * Cl + l];
    out[((b0 + q) * C + c) * Cl + l] = acc;
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
  const int64_t n_blocks = (static_cast<int64_t>(B) + kQT - 1) / kQT * C;
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
      features, B, F, feat_idx, thresh, tables, C, T, D, Cl, out);
  return static_cast<int>(cudaGetLastError());
}
