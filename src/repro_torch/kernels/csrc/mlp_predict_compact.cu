// Fused AI-path prediction: cell-routed MLP bank -> compact leaf slot table.
//
// Replaces mlp_predict_compact_t (src/repro/kernels/mlp_infer.py). For
// query b and each valid cell slot s (cell c = cell_ids[b,s]) it runs
// c's expert F -> H (ReLU) -> Cl, applies the sigmoid and `> thr`, maps
// every surviving local label l through label_map[c,l] (where lmask[c,l])
// to a global leaf id, unions the leaves over the slots, and returns the
// first k predicted leaf ids in id order plus the number of distinct
// predicted leaves. The dense [B, L] score table never exists.
//
// Design for Hopper: one CTA per query. The TPU kernel stages each query's
// expert through one-hot MXU matmuls because Mosaic cannot gather along
// lanes; here the CTA reads w1[c] / w2[c] directly (the bank stays in L2
// across the batch). Threads over H form the hidden layer in shared memory
// (sum over F), then threads over Cl form the logits (sum over H, the
// reference's order) with coalesced reads of w2's rows. Each surviving
// label sets one bit of a per-query leaf bitmap in shared memory (L bits:
// about 2 KB at 16k leaves); the OR is the max-union across cells and the
// dedup of labels shared by sibling cells. compact.cuh turns the bitmap
// into the slot table with a block popcount scan. Needs thr >= 0 (a
// negative threshold would predict every leaf in the dense reference).
//
// Bound: bytes at the serving shapes. Per valid slot the CTA reads
// (F*H + H + H*Cl + 2*Cl) floats of its cell (L2-resident after the first
// query that uses the cell); it does 2*(F*H + H*Cl) flops per slot.
#include <cuda_runtime.h>

#include <cstdint>

#include "compact.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
mlp_predict_compact_kernel(const float* __restrict__ x,
                           const int* __restrict__ cell_ids,
                           const bool* __restrict__ slot_ok,
                           const float* __restrict__ w1,
                           const float* __restrict__ b1,
                           const float* __restrict__ w2,
                           const float* __restrict__ b2,
                           const int* __restrict__ label_map,
                           const bool* __restrict__ lmask, int S, int F,
                           int H, int Cl, int n_leaves, int k, float thr,
                           int* __restrict__ idx, int* __restrict__ cnt) {
  extern __shared__ float smem[];
  float* xs = smem;                                    // [F]
  float* hs = smem + F;                                // [H]
  uint32_t* bits = reinterpret_cast<uint32_t*>(hs + H);  // [n_words]
  const int b = blockIdx.x;
  const int n_words = (n_leaves + 31) >> 5;
  for (int w = threadIdx.x; w < n_words; w += kBlock) bits[w] = 0u;
  for (int f = threadIdx.x; f < F; f += kBlock) xs[f] = x[b * F + f];
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    if (!slot_ok[b * S + s]) continue;                 // uniform per CTA
    const int c = cell_ids[b * S + s];
    const float* W1 = w1 + static_cast<int64_t>(c) * F * H;
    const float* W2 = w2 + static_cast<int64_t>(c) * H * Cl;
    for (int h = threadIdx.x; h < H; h += kBlock) {
      float acc = xs[0] * W1[h];
      for (int f = 1; f < F; ++f) acc += xs[f] * W1[f * H + h];
      hs[h] = fmaxf(acc + b1[c * H + h], 0.f);
    }
    __syncthreads();
    for (int l = threadIdx.x; l < Cl; l += kBlock) {
      if (!lmask[c * Cl + l]) continue;
      float z = hs[0] * W2[l];
      for (int h = 1; h < H; ++h) z += hs[h] * W2[h * Cl + l];
      z += b2[c * Cl + l];
      const float p = 1.f / (1.f + expf(-z));
      const int leaf = label_map[c * Cl + l];
      if (p > thr && leaf >= 0 && leaf < n_leaves)
        atomicOr(&bits[leaf >> 5], 1u << (leaf & 31));
    }
    __syncthreads();
  }
  repro_torch::block_compact_bitmap<kBlock>(
      bits, n_words, k, idx + static_cast<int64_t>(b) * k, cnt + b);
}

}  // namespace

extern "C" int mlp_predict_compact_smem_bytes(int F, int H, int n_leaves) {
  return (F + H) * 4 + ((n_leaves + 31) / 32) * 4;
}

// x [B,F] normalized features; cell_ids [B,S] i32 in [0, C); slot_ok [B,S]
// bool; w1 [C,F,H], b1 [C,H], w2 [C,H,Cl], b2 [C,Cl] f32; label_map [C,Cl]
// i32; lmask [C,Cl] bool -> idx [B,k] i32, cnt [B] i32. Returns the
// launch's cudaError_t.
extern "C" int mlp_predict_compact_launch(
    const float* x, const int* cell_ids, const bool* slot_ok,
    const float* w1, const float* b1, const float* w2, const float* b2,
    const int* label_map, const bool* lmask, int B, int S, int F, int H,
    int Cl, int n_leaves, int k, float thr, int* idx, int* cnt,
    void* stream) {
  if (B <= 0 || S <= 0 || F <= 0 || H <= 0 || Cl <= 0 || n_leaves <= 0 ||
      k <= 0 || !(thr >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(
      mlp_predict_compact_smem_bytes(F, H, n_leaves));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mlp_predict_compact_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  mlp_predict_compact_kernel<<<B, kBlock, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      x, cell_ids, slot_ok, w1, b1, w2, b2, label_map, lmask, S, F, H, Cl,
      n_leaves, k, thr, idx, cnt);
  return static_cast<int>(cudaGetLastError());
}
