// Chunked RWKV-6 (Finch) linear-attention scan.
//
// Replaces wkv6 (src/repro/kernels/wkv6.py; _kernel at :36, pallas_call at
// :90). Per row b of BH, with an f32 state S [dk, dv] starting at 0, the
// sequence is cut into chunks of C steps processed in order. With
// lw = log w (per channel), cum_inc the inclusive and cum the exclusive
// cumsum of lw inside the chunk, and total = cum_inc[C-1], each chunk does
//   y_i  = (r_i * exp(cum_i)) @ S                              inter
//        + sum_{j<i} [sum_c r_ic k_jc exp(cum_ic - cum_inc_jc)] v_j  intra
//        + (sum_c r_ic u_c k_ic) v_i                          bonus
//   S    = exp(total) * S + (k * exp(total - cum_inc))^T @ v   state
// Every exponent is <= 0, per channel, as in the TPU kernel: no FLA-style
// factoring, so any decay is stable. log w is clamped at log(FLT_MIN):
// a decay of exactly 0 then resets the state as the sequential definition
// (ref.wkv6) does, where log(0) - log(0) gives the TPU kernel NaN. For
// w >= FLT_MIN the clamp changes nothing.
//
// Design for Hopper: the TPU grid is (BH, T/C) with the state in VMEM
// scratch carried along the sequential chunk axis. Here the chunk axis is
// a loop inside the CTA, and each CTA owns one row b and a slice of kDvs
// (32) columns of v, y and S: column j of y and S depends only on column
// j of S and v, so the slices need no communication. Each CTA recomputes
// the chunk's [C, C] scores (C^2 dk / 2 exps), the price of the split:
// batch 1 of rwkv6-3b (BH 40) runs 80 CTAs of 512 threads.
// Everything of a chunk lives in shared memory: (r, cum) and (k, cum_inc)
// interleaved as float2 rows padded to dk + 1 (conflict-free column
// reads), the v slice, the scores, the state slice. A thread computes the
// scores of one column j for 4 consecutive rows i, so the (k_j, cum_inc_j)
// it loads serve 4 pairs and the row loads are broadcasts; the outputs
// and the state update keep 4 independent sums a thread. f32 FFMA with
// accurate expf/logf throughout; no tensor cores (a later PR).
//
// Bound: operations at the rwkv6-3b shapes. The intra-chunk scores are
// C(C-1)/2 * dk (subtract, exp, multiply, multiply-add) per chunk and row,
// beside the three [C, dk] x [dk, dv]-sized products; the bytes are r, k,
// w, v read once and y written once.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 512;            // threads per CTA
constexpr int kRows = 4;               // score rows per thread
constexpr int kDvs = 32;               // v / y / state columns a CTA
constexpr int kRpp = kBlock / kDvs;    // rows a pass in steps 5, 6
constexpr float kLogwMin = -87.336544750553f;   // logf(FLT_MIN)

__global__ void __launch_bounds__(kBlock)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, int T, int dk, int dv, int C,
            int n_split, float* __restrict__ y) {
  extern __shared__ float2 smem2[];
  const int dkp = dk + 1;
  const int cp = C + 1;
  float2* rc = smem2;                         // [C][dkp] (r, cum)
  float2* kc = rc + C * dkp;                  // [C][dkp] (k, cum_inc)
  float* vs = reinterpret_cast<float*>(kc + C * dkp);   // [C][kDvs]
  float* sc = vs + C * kDvs;                  // [C][cp] scores
  float* st = sc + C * cp;                    // [dk][kDvs] state slice
  float* bonus = st + dk * kDvs;              // [C]
  float* us = bonus + C;                      // [dk]
  float* etot = us + dk;                      // [dk] exp(total)

  const int64_t b = blockIdx.x / n_split;
  const int j0 = static_cast<int>(blockIdx.x % n_split) * kDvs;
  const int nj = min(kDvs, dv - j0);
  const int tid = threadIdx.x;

  for (int i = tid; i < dk * kDvs; i += kBlock) st[i] = 0.f;
  for (int c = tid; c < dk; c += kBlock) us[c] = u[b * dk + c];

  const int n_chunks = T / C;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int64_t row0 = b * T + static_cast<int64_t>(ch) * C;
    // 1. the chunk's tiles; log w clamped at log(FLT_MIN) (NaN stays NaN)
#pragma unroll 4
    for (int idx = tid; idx < C * dk; idx += kBlock) {
      const int i = idx / dk, c = idx % dk;
      const int64_t g = (row0 + i) * dk + c;
      const float lw = logf(w[g]);
      rc[i * dkp + c].x = r[g];
      kc[i * dkp + c] = make_float2(k[g], lw < kLogwMin ? kLogwMin : lw);
    }
    for (int idx = tid; idx < C * kDvs; idx += kBlock) {
      const int i = idx / kDvs, jj = idx % kDvs;
      vs[idx] = jj < nj ? v[(row0 + i) * dv + j0 + jj] : 0.f;
    }
    __syncthreads();

    // 2. per-channel cumsums over the chunk, in order
    for (int c = tid; c < dk; c += kBlock) {
      float run = 0.f;
#pragma unroll 8
      for (int i = 0; i < C; ++i) {
        const float lw = kc[i * dkp + c].y;
        run += lw;
        kc[i * dkp + c].y = run;           // cum_inc
        rc[i * dkp + c].y = run - lw;      // cum
      }
    }
    __syncthreads();

    // 3. strictly causal scores, 4 rows x 1 column a thread; the bonus
    for (int t = tid; t < (C / kRows) * C; t += kBlock) {
      const int j = t % C;
      const int i0 = (t / C) * kRows;
      float acc[kRows] = {0.f, 0.f, 0.f, 0.f};
      if (j < i0 + kRows - 1) {
#pragma unroll 4
        for (int c = 0; c < dk; ++c) {
          const float2 kj = kc[j * dkp + c];
#pragma unroll
          for (int q = 0; q < kRows; ++q) {
            const float2 ri = rc[(i0 + q) * dkp + c];
            acc[q] += ri.x * kj.x * expf(ri.y - kj.y);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        sc[(i0 + q) * cp + j] = j < i0 + q ? acc[q] : 0.f;
    }
    for (int i = tid; i < C; i += kBlock) {
      float s = 0.f;
      for (int c = 0; c < dk; ++c)
        s += rc[i * dkp + c].x * us[c] * kc[i * dkp + c].x;
      bonus[i] = s;
    }
    __syncthreads();

    // 4. r * exp(cum) and k * exp(total - cum_inc), in place; exp(total)
    for (int idx = tid; idx < C * dk; idx += kBlock) {
      const int i = idx / dk, c = idx % dk;
      const float total = kc[(C - 1) * dkp + c].y;
      float2& ri = rc[i * dkp + c];
      float2& ki = kc[i * dkp + c];
      ri.x *= expf(ri.y);
      ki.x *= expf(total - ki.y);
    }
    for (int c = tid; c < dk; c += kBlock)
      etot[c] = expf(kc[(C - 1) * dkp + c].y);
    __syncthreads();

    // 5. outputs of the slice: inter + intra + bonus, in that order. A
    //    thread owns column jj of kRows rows kRpp apart, so each st / vs
    //    value it loads serves kRows independent sums. The scores are 0
    //    for j >= i, so the intra sum may run over the whole chunk.
    for (int ib = tid / kDvs; ib < C; ib += kRows * kRpp) {
      const int jj = tid % kDvs;
      int row[kRows];
      float acc[kRows], intra[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        row[q] = min(ib + q * kRpp, C - 1);     // past C: computed, dropped
        acc[q] = 0.f;
        intra[q] = 0.f;
      }
#pragma unroll 4
      for (int c = 0; c < dk; ++c) {
        const float s = st[c * kDvs + jj];
#pragma unroll
        for (int q = 0; q < kRows; ++q) acc[q] += rc[row[q] * dkp + c].x * s;
      }
#pragma unroll 4
      for (int j = 0; j < C; ++j) {
        const float vj = vs[j * kDvs + jj];
#pragma unroll
        for (int q = 0; q < kRows; ++q) intra[q] += sc[row[q] * cp + j] * vj;
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int i = ib + q * kRpp;
        if (i < C && jj < nj)
          y[(row0 + i) * dv + j0 + jj] =
              acc[q] + intra[q] + bonus[i] * vs[i * kDvs + jj];
      }
    }
    __syncthreads();

    // 6. the state slice, in place (each thread owns its entries: column
    //    jj of kRows state rows kRpp apart)
    for (int cb = tid / kDvs; cb < dk; cb += kRows * kRpp) {
      const int jj = tid % kDvs;
      int c[kRows];
      float acc[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        c[q] = min(cb + q * kRpp, dk - 1);
        acc[q] = 0.f;
      }
#pragma unroll 4
      for (int i = 0; i < C; ++i) {
        const float vi = vs[i * kDvs + jj];
#pragma unroll
        for (int q = 0; q < kRows; ++q) acc[q] += kc[i * dkp + c[q]].x * vi;
      }
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        if (cb + q * kRpp < dk)
          st[c[q] * kDvs + jj] = etot[c[q]] * st[c[q] * kDvs + jj] + acc[q];
    }
    __syncthreads();
  }
}

}  // namespace

// r, k, w [BH, T, dk], v [BH, T, dv], u [BH, dk], all f32 and contiguous
// -> y [BH, T, dv] f32. T must be a multiple of the chunk C (the wrapper
// pads with identity steps), C a multiple of 4. smem is the bytes of the
// kernel's shared-memory layout at (dk, C), as ops.wkv6_smem computes
// them. Returns the launch's cudaError_t; launches nothing (and returns
// 0) when BH or T is 0.
extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* w, const float* u, int BH, int T,
                           int dk, int dv, int C, int smem, float* y,
                           void* stream) {
  if (BH < 0 || T < 0 || dk <= 0 || dv <= 0 || C <= 0 || C % kRows != 0 ||
      T % C != 0 || smem <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || T == 0) return 0;
  const int n_split = (dv + kDvs - 1) / kDvs;
  const int64_t n_blocks = static_cast<int64_t>(BH) * n_split;
  if (n_blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  wkv6_kernel<<<static_cast<unsigned>(n_blocks), kBlock,
                static_cast<size_t>(smem),
                static_cast<cudaStream_t>(stream)>>>(
      r, k, v, w, u, T, dk, dv, C, n_split, y);
  return static_cast<int>(cudaGetLastError());
}
