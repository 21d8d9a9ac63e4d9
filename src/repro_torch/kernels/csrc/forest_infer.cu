// Oblivious-forest inference: summed tree votes per (query, class).
//
// Replaces forest_infer (src/repro/kernels/forest_infer.py). For tree t,
// code = sum_d (features[b, feat_idx[t,d]] > thresh[t,d]) * 2^(D-1-d)
// names a row of tables[t], and the votes tables[t, code, c] are summed
// over t in ascending order.
//
// Design for Hopper: the TPU kernel takes features pre-gathered into a
// [B, T, D] array, turns each leaf code into a one-hot row and multiplies
// it into the table on the MXU, accumulating trees over its grid. Here one
// CTA owns kQT queries, so a 512-query batch spreads over 64 SMs. It
// gathers its own features: the tile's feature rows, thresh and feat_idx
// (a negative id wrapped once, then clamped into [0, F), as the
// reference's gather does) are staged in shared memory, and so are the
// tables when they are small (kTableSmem; the router's are 4 KB), else
// they are read from global memory in the same kernel. One
// thread per (query, tree) builds the leaf code with the strict > and the
// most-significant-first order (code = (code << 1) | bit, exact for
// D <= 24, which the launcher enforces) and writes that tree's C votes to
// a shared [kQT, T, C] buffer; after a barrier one thread per (query,
// class) sums its T votes in ascending t, the order of the TPU grid and
// of the plain version's loop, so the two agree bit for bit.
//
// Bound: bytes. The batch needs B*F*4 bytes of features, T*D*8 of
// thresholds and indices, the tables (T*2^D*C*4) and B*C*4 of output;
// the work is D compares per (query, tree) and T adds per output.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQT = 8;                     // queries per CTA
constexpr int kBlock = 128;                // threads per CTA
constexpr size_t kTableSmem = 32 * 1024;   // tables staged up to this size
constexpr size_t kMaxSmem = 232448;        // a CTA's shared memory, sm_90

__global__ void __launch_bounds__(kBlock)
forest_infer_kernel(const float* __restrict__ features, int B, int F,
                    const int* __restrict__ feat_idx,
                    const float* __restrict__ thresh,
                    const float* __restrict__ tables, int T, int D, int C,
                    bool staged, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int TD = T * D;
  const int64_t n_tab = static_cast<int64_t>(T) << D;     // table rows
  float* s_th = smem;                                     // [T*D]
  int* s_fi = reinterpret_cast<int*>(s_th + TD);          // [T*D]
  float* s_x = reinterpret_cast<float*>(s_fi + TD);       // [kQT*F]
  float* s_v = s_x + kQT * F;                             // [kQT*T*C]
  float* s_tab = s_v + kQT * T * C;                       // [T*2^D*C]
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kQT;
  const int nq = B - b0 < kQT ? static_cast<int>(B - b0) : kQT;

  for (int i = threadIdx.x; i < TD; i += kBlock) {
    int f = feat_idx[i];
    f = f < 0 ? f + F : f;                   // wrap once, then clamp,
    s_fi[i] = f < 0 ? 0 : (f >= F ? F - 1 : f);   // as the gather does
    s_th[i] = thresh[i];
  }
  for (int i = threadIdx.x; i < nq * F; i += kBlock)
    s_x[i] = features[b0 * F + i];
  if (staged)
    for (int64_t i = threadIdx.x; i < n_tab * C; i += kBlock)
      s_tab[i] = tables[i];
  __syncthreads();

  // one (query, tree) pair a thread: the leaf code, then the tree's votes
  for (int i = threadIdx.x; i < nq * T; i += kBlock) {
    const int q = i / T;
    const int t = i % T;
    const float* x = s_x + q * F;
    int code = 0;
    for (int d = 0; d < D; ++d)
      code = (code << 1) | (x[s_fi[t * D + d]] > s_th[t * D + d] ? 1 : 0);
    const int64_t r = ((static_cast<int64_t>(t) << D) + code) * C;
    float* v = s_v + static_cast<int64_t>(i) * C;         // [q, t, :]
    for (int c = 0; c < C; ++c) v[c] = staged ? s_tab[r + c] : tables[r + c];
  }
  __syncthreads();

  // one (query, class) pair a thread: the T votes in tree order
  for (int i = threadIdx.x; i < nq * C; i += kBlock) {
    const int q = i / C;
    const int c = i % C;
    const float* v = s_v + static_cast<int64_t>(q) * T * C + c;
    float acc = 0.f;
    for (int t = 0; t < T; ++t) acc += v[static_cast<int64_t>(t) * C];
    out[b0 * C + i] = acc;
  }
}

}  // namespace

// features [B,F] f32, feat_idx [T,D] i32, thresh [T,D] f32, tables
// [T,2^D,C] f32 -> out [B,C] f32. Returns the launch's cudaError_t;
// launches nothing (and returns 0) when B is 0.
extern "C" int forest_infer_launch(const float* features, int B, int F,
                                   const int* feat_idx, const float* thresh,
                                   const float* tables, int T, int D, int C,
                                   float* out, void* stream) {
  if (B < 0 || F <= 0 || T <= 0 || D <= 0 || D > 24 || C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const size_t base = (static_cast<size_t>(T) * D * 2 +
                       static_cast<size_t>(kQT) * F +
                       static_cast<size_t>(kQT) * T * C) * sizeof(float);
  const size_t tab = (static_cast<size_t>(T) << D) * C * sizeof(float);
  if (base > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const bool staged = tab <= kTableSmem && base + tab <= kMaxSmem;
  const size_t smem = base + (staged ? tab : 0);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        forest_infer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned blocks = static_cast<unsigned>((B + kQT - 1) / kQT);
  forest_infer_kernel<<<blocks, kBlock, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      features, B, F, feat_idx, thresh, tables, T, D, C, staged, out);
  return static_cast<int>(cudaGetLastError());
}
