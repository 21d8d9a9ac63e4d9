// Chunk-parallel RWKV-6 (Finch) linear-attention scan for Hopper.
//
// Replaces wkv6 (src/repro/kernels/wkv6.py; _kernel at :36, pallas_call at
// :90). Per row b of BH, with an f32 state S [dk, dv] starting at 0,
//   y_t = r_t . (S_{t-1} + (u * k_t) v_t^T),
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T.
// The sequence is cut into chunks of C steps (C a multiple of 16, <= 64).
// With lw = max(log2 w, -126) per step and channel (-126 = log2(FLT_MIN):
// a decay of exactly 0 then resets the state as the sequential definition
// ref.wkv6 does, where log 0 - log 0 gives the TPU kernel NaN; for
// w >= FLT_MIN the clamp changes nothing) and P_i the exclusive cumsum of
// lw over the chunk (P_0 = 0, P_C = tot):
//   y_i     = (r_i * 2^{P_i}) S_c                                  inter
//           + sum_{j<i} [sum_ch r_i k_j 2^{P_i - P_{j+1}}] v_j     intra
//           + (sum_ch r_i u k_i) v_i                               bonus
//   S_{c+1} = 2^{tot} * S_c + dS_c,  dS_c = (k * 2^{tot - P_{j+1}})^T v.
// Every exponent is <= 0 (the cumsum of log w never rises): no FLA-style
// factoring through a positive exponent, as in the TPU kernel.
//
// Design. The TPU grid walks the chunks of a row in order with the state
// in VMEM; one CTA a row would leave most of the 132 SMs idle at batch 1
// (BH 40). So the work is split over (row, chunk), in three kernels that
// one wkv6_launch issues on one stream:
//   1. wkv6_state_kernel, one CTA a (row, chunk): dS_c and 2^{tot_c} into
//      scratch (BH * T/C * dk * dv floats, the wrapper's).
//   2. wkv6_scan_kernel, one thread a (row, 2 state entries): the pass
//      over the chunk states, in order along the chunks only, rewriting
//      dS_c in place as S_c, the state that enters chunk c. The loads of
//      the next kScanU chunks are in flight while the chain runs.
//   3. wkv6_output_kernel, one CTA a (row, chunk): y = inter + intra +
//      bonus. The chunk is cut into sub-chunks of 16 steps, each owned by
//      two warps (32 columns of y each). For sub-chunk I starting at s and
//      j < s, 2^{P_i - P_{j+1}} = 2^{P_i - P_s} * 2^{P_s - P_{j+1}}, both
//      factors <= 1, so the scores left of the diagonal block are an exact
//      product (r * 2^{P - P_s})_I (k * 2^{P_s - P_{j+1}})_{<s}^T of
//      factors <= 1 (an underflowing factor bounds a true value smaller
//      still). Only the 16 x 16 diagonal blocks keep the per-channel form:
//      120 * dk exponentials a sub-chunk in f32 FFMA, a lane taking the
//      row pair (p, 15 - p) on 8 channels.
//   The intra term and the bonus live in kernel 3, beside the inter term,
//   and not in kernel 1: y is then written once. Kernel 1 writing them
//   would make kernel 3 read y back and write it again, 2 * BH * T * dv
//   floats more (0.67 GB, ~0.2 ms at [1, 32768]), and kernel 3 needs r,
//   k, v and P for the inter term anyway.
// Exponentials are ex2.approx.ftz (2 ulp; a result below FLT_MIN, 2^-126,
// flushes to 0), the diagonal blocks' too, the logarithm log2f. Every
// exponent is already base 2 (P is a cumsum of log2 w), and CUDA's expf
// and exp2f are themselves ex2.approx (2 ulp) behind a scaling and
// denormal handling; a flushed factor stands for a term below 2^-126 of
// |r k v|, far inside rtol = atol = 5e-4.
// The four [16|dk|C] x [dk|C] products (dS, inter, the off-diagonal
// scores, scores @ v) run on the tensor cores, hand-written mma.sync
// m16n8k8 TF32 with split operands: x = hi + lo, each rounded to tf32
// (cvt.rna), and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, accurate to
// ~2^-21 of each product. Plain TF32 (2^-11) breaks rtol = atol = 5e-4
// where sums cancel. mma.sync and not wgmma: the operands are scaled by
// exponentials and split on their way from shared memory into registers,
// and the tiles are 16-row sub-chunks.
// Loads are cp.async in groups in the order of first use (kernel 1: w, k,
// v; kernel 3: w; r and S_c; k; then v into S_c's room once the inter
// product is done), so the cumsum and the products run while later tiles
// arrive. Kernel 3 keeps the scores in registers until both warps of a
// sub-chunk are done with its rows of r, then writes them there: 72.2 KB
// and at most 85 registers a thread, so 3 CTAs share an SM and one's loads
// overlap the others' compute. A double-buffered ring would instead halve
// the CTAs resident on an SM.
// dk = dv = 64 (RWKV-6's head size): the wrapper pads smaller heads.
//
// Bound: bytes. r, k, w, v read once and y written once (1.68 GB at
// rwkv6-3b's [1, 32768] prefill, 0.50 ms at 3.35 TB/s); the operations of
// the sub-chunked form (3.4 GFLOP in f32, 31 on the tensor cores) take
// 0.11 ms at the H100's peaks. The kernels move more: k, w, v twice, and
// the chunk states (dk * dv floats a chunk) written by 1, read and written
// by 2, read by 3: 4.0 GB in all.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kD = 64;                // dk = dv
constexpr int kSub = 16;              // steps of a sub-chunk (one m16 tile)
constexpr int kMaxC = 64;             // chunk steps at most: 4 sub-chunks
constexpr int kThreads = 256;         // 8 warps: 2 a sub-chunk in kernel 3
constexpr int kPA = kD + 4;           // pitch of tiles read as [m][k]
constexpr int kPB = kD + 8;           // pitch of tiles read as [k][n]
constexpr int kScanU = 8;             // chunk states loaded ahead in pass 2
constexpr float kLog2wMin = -126.f;   // log2(FLT_MIN)

__device__ __forceinline__ void cp16(float* s, const float* g) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// n rows of kD floats from global g into shared s at pitch p
__device__ __forceinline__ void load_rows(float* s, int p, const float* g,
                                          int n) {
  for (int i = threadIdx.x; i < n * (kD / 4); i += kThreads) {
    const int row = i >> 4, c4 = (i & 15) * 4;
    cp16(s + row * p + c4, g + row * kD + c4);
  }
}

// pb rows 1..C hold the chunk's w; leaves pb[i][c] = P_i (row 0 = 0).
// Thread (q, c) scans 16 steps of channel c, then adds the parts before.
__device__ __forceinline__ void chunk_cumsum(float* pb, float* part, int C) {
  const int c = threadIdx.x & (kD - 1), q = threadIdx.x / kD;
  const int ns = C / kSub;
  if (q < ns) {
    float run = 0.f;
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
      float* p = pb + (q * kSub + s + 1) * kPA + c;
      float lw = log2f(*p);
      lw = lw < kLog2wMin ? kLog2wMin : lw;    // NaN stays NaN
      run += lw;
      *p = run;
    }
    part[q * kD + c] = run;
  }
  if (q == 0) pb[c] = 0.f;
  __syncthreads();
  if (q > 0 && q < ns) {
    float off = 0.f;
    for (int qq = 0; qq < q; ++qq) off += part[qq * kD + c];
#pragma unroll
    for (int s = 0; s < kSub; ++s) pb[(q * kSub + s + 1) * kPA + c] += off;
  }
  __syncthreads();
}

// 2^x to 2 ulp; a result below FLT_MIN flushes to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// x = hi + lo, both tf32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A operand of one m16n8k8 product, split: elements e of the fragment are
// (row g + 8 (e & 1), column t + 4 (e >> 1)) of the 16 x 8 tile.
struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

// d += a b in three tf32 products, the small ones first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// B fragment of the [k][n] tile at (k0, n0) of shared x (pitch p)
__device__ __forceinline__ FragB frag_b(const float* x, int p, int k0, int n0,
                                        int g, int t) {
  FragB b;
  split(x[(k0 + t) * p + n0 + g], b.hi[0], b.lo[0]);
  split(x[(k0 + t + 4) * p + n0 + g], b.hi[1], b.lo[1]);
  return b;
}

__device__ __forceinline__ void store_c(float* out, int ld, int m0, int n0,
                                        int g, int t, const float (&d)[4]) {
  *reinterpret_cast<float2*>(out + (m0 + g) * ld + n0 + 2 * t) =
      make_float2(d[0], d[1]);
  *reinterpret_cast<float2*>(out + (m0 + g + 8) * ld + n0 + 2 * t) =
      make_float2(d[2], d[3]);
}

// 1. dS_c = (k * 2^{tot - P_{j+1}})^T v and 2^{tot}, one CTA a (row, chunk)
__global__ void __launch_bounds__(kThreads)
wkv6_state_kernel(const float* __restrict__ k, const float* __restrict__ v,
                  const float* __restrict__ w, int C,
                  float* __restrict__ states, float* __restrict__ decay) {
  extern __shared__ float4 smem4[];
  float* kb = reinterpret_cast<float*>(smem4);   // [C][kPB] k, then k_dec
  float* vb = kb + C * kPB;                      // [C][kPB]
  float* pb = vb + C * kPB;                      // [C + 1][kPA] w, then P
  float* part = pb + (C + 1) * kPA;              // [4][kD]

  const int64_t chunk = blockIdx.x;              // b * T / C + ch
  const int64_t row0 = chunk * C;                // = b * T + ch * C
  load_rows(pb + kPA, kPA, w + row0 * kD, C);
  cp_commit();
  load_rows(kb, kPB, k + row0 * kD, C);
  cp_commit();
  load_rows(vb, kPB, v + row0 * kD, C);
  cp_commit();
  cp_wait<2>();
  __syncthreads();
  chunk_cumsum(pb, part, C);
  cp_wait<1>();
  __syncthreads();

  const float* tot = pb + C * kPA;
  for (int i = threadIdx.x; i < C * kD; i += kThreads) {
    const int j = i / kD, c = i % kD;
    kb[j * kPB + c] *= ex2(tot[c] - pb[(j + 1) * kPA + c]);
  }
  if (threadIdx.x < kD)
    decay[chunk * kD + threadIdx.x] = ex2(tot[threadIdx.x]);
  cp_wait<0>();
  __syncthreads();

  // warp: dS rows m0 .. m0 + 15 (channels of k), columns n0 .. n0 + 31
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < C; k0 += 8) {
    FragA a;       // A(m = channel, k = step) = k_dec[step][channel]
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split(kb[(k0 + t + 4 * (e >> 1)) * kPB + m0 + g + 8 * (e & 1)],
            a.hi[e], a.lo[e]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      mma3(acc[nt], a, frag_b(vb, kPB, k0, n0 + nt * 8, g, t));
  }
  float* ds = states + chunk * kD * kD;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    store_c(ds, kD, m0, n0 + nt * 8, g, t, acc[nt]);
}

// 2. the pass over the chunk states: dS_c -> S_c in place, in chunk order,
//    one thread a pair of state entries (16 threads share one decay). Two
//    register groups of kScanU chunks: the next group's loads are in
//    flight while this group's chain runs.
constexpr int kE2 = kD * kD / 2;      // float2 of one state

struct ScanGroup {
  float2 d[kScanU];
  float a[kScanU];
};

__device__ __forceinline__ void scan_load(ScanGroup& g, const float2* st,
                                          const float* dc, int c0, int nc) {
#pragma unroll
  for (int q = 0; q < kScanU; ++q)
    if (c0 + q < nc) {
      g.d[q] = st[static_cast<int64_t>(c0 + q) * kE2];
      g.a[q] = dc[static_cast<int64_t>(c0 + q) * kD];
    }
}

__device__ __forceinline__ void scan_run(const ScanGroup& g, float2* st,
                                         float2& s, int c0, int nc) {
#pragma unroll
  for (int q = 0; q < kScanU; ++q)
    if (c0 + q < nc) {
      st[static_cast<int64_t>(c0 + q) * kE2] = s;
      s = make_float2(fmaf(g.a[q], s.x, g.d[q].x),
                      fmaf(g.a[q], s.y, g.d[q].y));
    }
}

__global__ void __launch_bounds__(kThreads)
wkv6_scan_kernel(float* __restrict__ states, const float* __restrict__ decay,
                 int BH, int nc) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(BH) * kE2) return;
  const int64_t b = idx / kE2;
  const int e = static_cast<int>(idx % kE2);
  float2* st = reinterpret_cast<float2*>(states) + b * nc * kE2 + e;
  const float* dc = decay + b * nc * kD + e / (kD / 2);
  float2 s = make_float2(0.f, 0.f);
  ScanGroup g0, g1;
  scan_load(g0, st, dc, 0, nc);
  for (int c0 = 0; c0 < nc; c0 += 2 * kScanU) {
    scan_load(g1, st, dc, c0 + kScanU, nc);
    scan_run(g0, st, s, c0, nc);
    scan_load(g0, st, dc, c0 + 2 * kScanU, nc);
    scan_run(g1, st, s, c0 + kScanU, nc);
  }
}

// the two warps of sub-chunk I meet (named barrier 1 + I, 64 threads)
__device__ __forceinline__ void pair_sync(int I) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + I) : "memory");
}

// Diagonal-block sums m0 .. m0 + M - 1 of a lane: m < p is the pair
// (ia, s + m), m < 15 the pair (ib, s + m - p), 15 and 16 the bonus of
// ia and ib; summed over the lane's 8 channels, then over its 8 lanes.
template <int M>
__device__ __forceinline__ void diag_sums(float (&d)[M], int m0,
                                          const float* rb, const float* kb,
                                          const float* pb, const float* ub,
                                          int s, int p, int q) {
  const int ia = s + p, ib = s + 15 - p;
#pragma unroll
  for (int m = 0; m < M; ++m) d[m] = 0.f;
#pragma unroll 2
  for (int cc = 0; cc < 8; ++cc) {
    const int c = q + 8 * cc;
    const float ra = rb[ia * kPA + c], pa = pb[ia * kPA + c];
    const float rbb = rb[ib * kPA + c], pbb = pb[ib * kPA + c];
#pragma unroll
    for (int mm = 0; mm < M; ++mm) {
      const int m = m0 + mm;
      if (m < 15) {
        const bool lo = m < p;
        const int j = s + (lo ? m : m - p);
        const float ri = lo ? ra : rbb, pi = lo ? pa : pbb;
        d[mm] = fmaf(ri * kb[j * kPA + c], ex2(pi - pb[(j + 1) * kPA + c]),
                     d[mm]);
      } else {
        const int i = m == 15 ? ia : ib;
        d[mm] = fmaf((m == 15 ? ra : rbb) * ub[c], kb[i * kPA + c], d[mm]);
      }
    }
  }
#pragma unroll
  for (int mm = 0; mm < M; ++mm) {
    d[mm] += __shfl_xor_sync(0xffffffffu, d[mm], 1);
    d[mm] += __shfl_xor_sync(0xffffffffu, d[mm], 2);
    d[mm] += __shfl_xor_sync(0xffffffffu, d[mm], 4);
  }
}

// 3. y of one (row, chunk): inter + intra + bonus
__global__ void __launch_bounds__(kThreads, 3)
wkv6_output_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ w,
                   const float* __restrict__ u,
                   const float* __restrict__ states, int T, int C,
                   float* __restrict__ y) {
  extern __shared__ float4 smem4[];
  float* rb = reinterpret_cast<float*>(smem4);   // [C][kPA] r; then the
                                                 // scores sc[i][j], j <= i
  float* kb = rb + C * kPA;                      // [C][kPA]
  float* pb = kb + C * kPA;                      // [C + 1][kPA] w, then P
  float* vb = pb + (C + 1) * kPA;                // [kD][kPB] S_c; then v
                                                 // [C][kPB]
  float* ub = vb + kD * kPB;                     // [kD]
  float* part = ub + kD;                         // [4][kD]

  const int64_t chunk = blockIdx.x;              // b * T / C + ch
  const int64_t b = chunk / (T / C);
  const int64_t row0 = chunk * C;
  // load groups in the order of first use: w; r and S_c; k; and v once
  // S_c is spent
  load_rows(pb + kPA, kPA, w + row0 * kD, C);
  cp_commit();
  load_rows(rb, kPA, r + row0 * kD, C);
  load_rows(vb, kPB, states + chunk * kD * kD, kD);
  cp_commit();
  load_rows(kb, kPA, k + row0 * kD, C);
  cp_commit();
  if (threadIdx.x < kD) ub[threadIdx.x] = u[b * kD + threadIdx.x];
  cp_wait<2>();
  __syncthreads();
  chunk_cumsum(pb, part, C);
  cp_wait<1>();
  __syncthreads();

  // warp (I, h): rows s .. s + 15 of the chunk, y columns n0 .. n0 + 31
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int I = warp >> 1, h = warp & 1;
  const bool active = I < C / kSub;
  const int s = I * kSub, n0 = h * 32;
  float acc[4][4] = {};
  if (active) {
    // inter: (r * 2^{P})_I S_c
    for (int k0 = 0; k0 < kD; k0 += 8) {
      FragA a;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = (s + g + 8 * (e & 1)) * kPA + k0 + t + 4 * (e >> 1);
        split(rb[o] * ex2(pb[o]), a.hi[e], a.lo[e]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma3(acc[nt], a, frag_b(vb, kPB, k0, n0 + nt * 8, g, t));
    }
  }
  cp_wait<0>();
  __syncthreads();                 // k has landed; S_c is spent
  load_rows(vb, kPB, v + row0 * kD, C);
  cp_commit();
  // the scores of rows s .. s + 15, held in registers until both warps of
  // the sub-chunk are done reading its rows of r
  float sacc[3][4] = {};
  float dq[3] = {0.f, 0.f, 0.f};   // diagonal sums m = q, q + 8, 16
  const int q = lane & 7, p = 4 * h + (lane >> 3);
  if (active) {
    // left of the diagonal block: n-tiles h, h + 2, h + 4 of [0, s)
    if (s > 0) {
      const float* ps = pb + s * kPA;            // P_s
      for (int k0 = 0; k0 < kD; k0 += 8) {
        FragA a;                                 // r * 2^{P - P_s}
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = k0 + t + 4 * (e >> 1);
          const int o = (s + g + 8 * (e & 1)) * kPA + c;
          split(rb[o] * ex2(pb[o] - ps[c]), a.hi[e], a.lo[e]);
        }
#pragma unroll
        for (int qq = 0; qq < 3; ++qq) {
          const int j0 = (h + 2 * qq) * 8;
          if (j0 >= s) break;                    // the same on every lane
          const int j = j0 + g;
          FragB bf;                              // k_j * 2^{P_s - P_{j+1}}
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = k0 + t + 4 * e;
            split(kb[j * kPA + c] * ex2(ps[c] - pb[(j + 1) * kPA + c]),
                  bf.hi[e], bf.lo[e]);
          }
          mma3(sacc[qq], a, bf);
        }
      }
    }
    // the diagonal block, per channel: lane (p - 4h, q) takes the row pair
    // (p, 15 - p) on channels q, q + 8, ..., q + 56, in two passes of sums
    {
      float d[8];
      diag_sums<8>(d, 0, rb, kb, pb, ub, s, p, q);
#pragma unroll
      for (int m = 0; m < 8; ++m)
        if (m == q) dq[0] = d[m];
    }
    {
      float d[9];
      diag_sums<9>(d, 8, rb, kb, pb, ub, s, p, q);
#pragma unroll
      for (int m = 0; m < 8; ++m)
        if (m == q) dq[1] = d[m];
      dq[2] = d[8];
    }
    pair_sync(I);                  // rows s .. s + 15 of r are spent
    float* sc = rb;
#pragma unroll
    for (int qq = 0; qq < 3; ++qq)
      if ((h + 2 * qq) * 8 < s)
        store_c(sc, kPA, s, (h + 2 * qq) * 8, g, t, sacc[qq]);
    const int ia = s + p, ib = s + 15 - p;
    sc[ia * kPA + s + q] = 0.f;
    sc[ia * kPA + s + q + 8] = 0.f;
    sc[ib * kPA + s + q] = 0.f;
    sc[ib * kPA + s + q + 8] = 0.f;
    __syncwarp();                  // the zeros land first
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      const int m = e == 2 ? 16 : q + 8 * e;
      if (e == 2 && q != 0) continue;
      const int o = m < p    ? ia * kPA + s + m
                    : m < 15 ? ib * kPA + s + m - p
                    : m == 15 ? ia * kPA + ia
                              : ib * kPA + ib;
      sc[o] = dq[e];
    }
  }
  cp_wait<0>();
  __syncthreads();
  if (active) {
    // intra + bonus: scores[s .., 0 : s + 16] v[0 : s + 16, n0 ..]
    const float* sc = rb;
    for (int k0 = 0; k0 < s + kSub; k0 += 8) {
      FragA a;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(sc[(s + g + 8 * (e & 1)) * kPA + k0 + t + 4 * (e >> 1)],
              a.hi[e], a.lo[e]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma3(acc[nt], a, frag_b(vb, kPB, k0, n0 + nt * 8, g, t));
    }
    float* yo = y + row0 * kD;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      store_c(yo, kD, s, n0 + nt * 8, g, t, acc[nt]);
  }
}

size_t state_smem(int C) {
  return 4 * (2 * C * kPB + (C + 1) * kPA + 4 * kD);
}

size_t output_smem(int C) {
  return 4 * (2 * C * kPA + (C + 1) * kPA + kD * kPB + kD + 4 * kD);
}

}  // namespace

// r, k, w [BH, T, 64], v [BH, T, 64], u [BH, 64], all f32 and contiguous
// -> y [BH, T, 64] f32. T must be a multiple of the chunk C (the wrapper
// pads with identity steps), C a multiple of 16 no larger than 64.
// states [BH, T/C, 64, 64] and decay [BH, T/C, 64] are f32 scratch.
// Launches the three kernels on stream in order and returns the first
// cudaError_t; launches nothing (and returns 0) when BH or T is 0.
extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* w, const float* u, int BH, int T,
                           int C, float* states, float* decay, float* y,
                           void* stream) {
  if (BH < 0 || T < 0 || C < kSub || C > kMaxC || C % kSub != 0 ||
      T % C != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (BH == 0 || T == 0) return 0;
  const int nc = T / C;
  const int64_t n_chunks = static_cast<int64_t>(BH) * nc;
  const int64_t n_scan =
      (static_cast<int64_t>(BH) * kE2 + kThreads - 1) / kThreads;
  if (n_chunks > INT_MAX || n_scan > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t sm1 = state_smem(C), sm3 = output_smem(C);
  cudaError_t e = cudaFuncSetAttribute(
      wkv6_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sm1));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(wkv6_output_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(sm3));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  wkv6_state_kernel<<<static_cast<unsigned>(n_chunks), kThreads, sm1, st>>>(
      k, v, w, C, states, decay);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv6_scan_kernel<<<static_cast<unsigned>(n_scan), kThreads, 0, st>>>(
      states, decay, BH, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv6_output_kernel<<<static_cast<unsigned>(n_chunks), kThreads, sm3, st>>>(
      r, k, v, w, u, states, T, C, y);
  return static_cast<int>(cudaGetLastError());
}
