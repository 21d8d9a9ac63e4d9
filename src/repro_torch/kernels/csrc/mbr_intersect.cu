// Batched rectangle-intersection mask: queries [B,4] x MBRs [N,4] -> [B,N],
// optionally folded with the level above's mask.
//
// Replaces mbr_intersect_t (src/repro/kernels/mbr_intersect.py): closed
// rectangles, q0 <= m2 && m0 <= q2 && q1 <= m3 && m1 <= q3. Given a parent
// mask [B, Np] and parents [N], byte (b, i) is parent_mask[b, parents[i]]
// & hit(b, i): one step of the reference's per-level walk
// (src/repro/core/traversal.py:60-74, mask[:, parent] & hit) in one pass,
// so the walk ladder's last rung (ops._per_level_walk) is one launch a
// level. It is also the whole walk of a single-level tree.
//
// Design for Hopper: a CTA owns kQT queries x kTN MBRs; the query tile
// runs fastest in the grid, so the kQT-query tiles of one MBR tile run
// together and read its MBRs from L2. Two phases:
//  1. hit bits: a warp's lanes take 32 consecutive MBRs (one float4 load
//     each, parents once) and reduce them to the word's bounding box;
//     lane j tests query j against the box, and a ballot names the
//     queries that can meet any of the 32 (every hit lies in the box, so
//     the filter drops only misses: comparisons are the bound's cost, and
//     a small query meets few words of a wide level). For each such query
//     the lanes test their MBRs and vote (__ballot_sync); lane j keeps
//     query j's 32-bit word and writes it to a shared [kQT][kTN/32] bit
//     tile, zero for a query the box filtered out (a tile of fewer than
//     kWarps words splits each word's queries over several warps). The
//     votes of a few candidates run one after another; past kDense (a
//     wide node's word, which most queries meet) the warp votes on all 32
//     queries in an unrolled loop, whose votes do not wait on one
//     another. Only when a vote has a hit do the hitting lanes load their
//     parent's byte (any parents, any order; clamped into [0, Np) so the
//     load stays in the row) and vote again; the plain form is compiled
//     without that step.
//  2. copy-out: a warp a row segment. Each lane takes 16 bits at the
//     segment's first 16-byte aligned address (a funnel shift of two
//     words), spreads each nibble to four 0/1 bytes by one multiply, and
//     writes them in one 16-byte streaming store (__stcs: the mask is
//     read once, by the next level or the compaction). A row b*N is
//     aligned only to N's power-of-two factor, so the up to 15 bytes
//     before the first aligned address (lanes 0-15) and after the last
//     (lanes 16-31) are written a byte at a time.
// Output offsets are 64-bit: B * N passes 2^31 at the sizes the per-level
// rung serves.
//
// Bound: bytes. B*N bytes written against 16*(B+N) (+ 4N parents and the
// parent bytes the hits name) read; 4 compares per (query, MBR).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQT = 32;           // queries per CTA
constexpr int kTN = 512;          // MBRs per CTA
constexpr int kWarps = 8;
constexpr int kBlock = kWarps * 32;
constexpr int kWords = kTN / 32;  // bit words a row of the tile
constexpr int kRow = kWords + 1;  // + one the funnel shift may read past
constexpr int kDense = 8;         // more candidates than this: vote on all

// four bits -> four bytes of 0/1, bit j to byte j (little-endian)
__device__ __forceinline__ uint32_t spread4(uint32_t n) {
  return (n * 0x00204081u) & 0x01010101u;
}

__device__ __forceinline__ bool meets(float4 a, float4 b) {
  return (a.x <= b.z) && (b.x <= a.z) && (a.y <= b.w) && (b.y <= a.w);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 8 CTAs an SM (32 registers a thread): the whole card's worth of
// stores in flight while other CTAs vote
template <bool kFold>
__global__ void __launch_bounds__(kBlock, 8)
mbr_intersect_kernel(const float4* __restrict__ queries, int B,
                     const float4* __restrict__ mbrs, int N,
                     const uint8_t* __restrict__ parent_mask,
                     const int* __restrict__ parents, int Np,
                     uint8_t* __restrict__ out, int n_qtiles) {
  __shared__ float4 q[kQT];
  __shared__ uint32_t bits[kQT][kRow];
  const int b0 = (blockIdx.x % n_qtiles) * kQT;
  const int c0 = (blockIdx.x / n_qtiles) * kTN;
  const int nq = min(kQT, B - b0);
  const int n = min(kTN, N - c0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inf = __int_as_float(0x7f800000);
  const float4 never = make_float4(inf, inf, -inf, -inf);
  // a narrow tile has fewer words than warps: `parts` warps share a word,
  // each taking the queries j with j % parts == its part
  const int nw = (n + 31) / 32;
  const int parts = max(1, kWarps / nw);
  const int part = warp % parts;
  const int step = kWarps / parts;
  const bool owner = lane % parts == part;
  // lane's MBR (and parent) of word w, `never` past the tile's end
  auto fetch = [&](int w, float4& m, int& p) {
    const bool live = w < nw && w * 32 + lane < n;
    const int i = c0 + w * 32 + lane;
    m = live ? mbrs[i] : never;
    p = kFold && live ? min(max(parents[i], 0), Np - 1) : 0;
  };
  float4 m_next;
  int p_next;
  fetch(warp / parts, m_next, p_next);     // in flight across the barrier
  if (threadIdx.x < kQT) {
    q[threadIdx.x] = threadIdx.x < nq ? queries[b0 + threadIdx.x] : never;
    bits[threadIdx.x][kWords] = 0;
  }
  __syncthreads();
  const float4 mine = q[lane];         // lane j's own query, for the filter
  const uint32_t own = __ballot_sync(0xffffffffu, owner);

  for (int w = warp / parts; w < nw; w += step) {
    const float4 m = m_next;
    const int p = p_next;
    fetch(w + step, m_next, p_next);
    // the word's bounding box; a query that misses it misses every MBR
    const float4 box = make_float4(warp_min(m.x), warp_min(m.y),
                                   warp_max(m.z), warp_max(m.w));
    uint32_t cand = __ballot_sync(0xffffffffu, meets(mine, box)) & own;
    // query j's vote; past the box every lane misses
    auto vote = [&](int j) {
      const bool hit = meets(q[j], m);
      uint32_t v = __ballot_sync(0xffffffffu, hit);
      if (kFold && v)
        v = __ballot_sync(0xffffffffu,
                          hit && parent_mask[static_cast<int64_t>(b0 + j) *
                                             Np + p] != 0);
      return v;
    };
    uint32_t word = 0;                 // lane j's: query j's hit bits
    if (__popc(cand) > kDense) {
      // most queries meet the box (a wide node's word): all 32 votes,
      // two at a time (more spill the folded form's registers at 32)
#pragma unroll 2
      for (int j = 0; j < kQT; ++j) {
        const uint32_t v = vote(j);
        if (lane == j) word = v;
      }
    } else {
      while (cand) {                   // a few: one after another
        const int j = __ffs(cand) - 1;
        cand &= cand - 1;
        const uint32_t v = vote(j);
        if (lane == j) word = v;
      }
    }
    if (owner) bits[lane][w] = word;
  }
  __syncthreads();

  const uintptr_t base = reinterpret_cast<uintptr_t>(out);
  for (int j = warp; j < nq; j += kWarps) {
    const int64_t s = static_cast<int64_t>(b0 + j) * N + c0;
    const int head = min(static_cast<int>((16 - ((base + s) & 15)) & 15), n);
    const int nb = (n - head) >> 4;       // aligned 16-byte blocks
    const int tail = head + 16 * nb;      // first byte past them
    const uint32_t* row = bits[j];
    uint8_t* o = out + s;
    for (int k = lane; k < nb; k += 32) {
      const int x = head + 16 * k;
      const uint32_t v =
          __funnelshift_r(row[x >> 5], row[(x >> 5) + 1], x & 31) & 0xffffu;
      uint4 word;
      word.x = spread4(v & 15u);
      word.y = spread4((v >> 4) & 15u);
      word.z = spread4((v >> 8) & 15u);
      word.w = spread4(v >> 12);
      __stcs(reinterpret_cast<uint4*>(o + x), word);
    }
    const int t = lane < 16 ? lane : tail + lane - 16;
    if (lane < 16 ? t < head : t < n)
      __stcs(o + t, static_cast<uint8_t>((row[t >> 5] >> (t & 31)) & 1u));
  }
}

}  // namespace

// queries [B,4] f32, mbrs [N,4] f32 (both 16-byte aligned) -> out [B,N]
// bytes; parent_mask [B,Np] bytes and parents [N] i32 both given (Np >= 1)
// or both null (Np ignored). Returns the launch's cudaError_t.
extern "C" int mbr_intersect_launch(const float* queries, int B,
                                    const float* mbrs, int N,
                                    const uint8_t* parent_mask,
                                    const int* parents, int Np, uint8_t* out,
                                    void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((parent_mask == nullptr) != (parents == nullptr) ||
      (parents != nullptr && Np <= 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qtiles = (B + kQT - 1) / kQT;
  const int64_t n_blocks =
      static_cast<int64_t>(n_qtiles) * ((N + kTN - 1) / kTN);
  if (n_blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = parents != nullptr ? mbr_intersect_kernel<true>
                                          : mbr_intersect_kernel<false>;
  kernel<<<static_cast<unsigned>(n_blocks), kBlock, 0,
           static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(queries), B,
      reinterpret_cast<const float4*>(mbrs), N, parent_mask, parents, Np,
      out, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}
