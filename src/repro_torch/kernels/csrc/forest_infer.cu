// Oblivious-forest inference: summed tree votes per (query, class).
//
// Replaces forest_infer (src/repro/kernels/forest_infer.py). For tree t,
// code = sum_d (sel[b,t,d] > thresh[t,d]) * 2^(D-1-d) names a row of
// tables[t], and the votes tables[t, code, c] are summed over t.
//
// Design for Hopper: one thread per (query, class). The TPU kernel turns
// the leaf code into a one-hot row and multiplies it into the table on the
// MXU; on the card the code is an index and the vote a direct load (the
// router's tables are 16 x 64 floats and stay in L1/L2). Trees are summed
// in ascending t, the order the TPU kernel's grid accumulates and the
// plain version loops, so results agree bit for bit.
//
// Bound: bytes. Each query reads its T*D pre-gathered features once
// (B*T*D*4 bytes); per tree the work is D compares and one add.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
forest_infer_kernel(const float* __restrict__ sel,
                    const float* __restrict__ thresh,
                    const float* __restrict__ tables, int B, int T, int D,
                    int C, float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= static_cast<int64_t>(B) * C) return;
  const int b = static_cast<int>(i / C);
  const int c = static_cast<int>(i % C);
  const float* s = sel + static_cast<int64_t>(b) * T * D;
  float acc = 0.f;
  for (int t = 0; t < T; ++t) {
    int code = 0;
    for (int d = 0; d < D; ++d)
      code = (code << 1) | (s[t * D + d] > thresh[t * D + d] ? 1 : 0);
    acc += tables[(static_cast<int64_t>(t) * (1 << D) + code) * C + c];
  }
  out[i] = acc;
}

}  // namespace

// sel [B,T,D] f32, thresh [T,D] f32, tables [T,2^D,C] f32 -> out [B,C] f32.
// Returns the launch's cudaError_t.
extern "C" int forest_infer_launch(const float* sel, const float* thresh,
                                   const float* tables, int B, int T, int D,
                                   int C, float* out, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || D > 24 || C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(B) * C;
  const unsigned blocks = static_cast<unsigned>((n + kBlock - 1) / kBlock);
  forest_infer_kernel<<<blocks, kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      sel, thresh, tables, B, T, D, C, out);
  return static_cast<int>(cudaGetLastError());
}
