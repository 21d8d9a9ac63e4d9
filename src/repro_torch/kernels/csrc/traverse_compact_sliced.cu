// Root-to-leaf R-tree walk through ancestor windows, compacted into a
// slot table.
//
// Replaces traverse_compact_sliced_t (src/repro/kernels/traverse_fused.py):
// the windowed visited set of traverse_fused_sliced.cu (each leaf tile of
// tl leaves sees internal level l only through its window of width[l]
// nodes from starts[l, tile] * width[l]; out-of-window parents and nodes
// past a level's end are dead), compacted as traverse_compact.cu does:
// each query gets the first k visited leaf ids in id order (zeros past its
// count) and its total visited count, exact past k. The [B, L] mask never
// reaches device memory.
//
// Bound: bytes. The compulsory traffic is the queries, one read of the
// tree's visited part (leaf level and windows) and the B*(k+1) ints of
// slot table and counts; 4 compares per (query, node). A launch needs a
// fraction of a microsecond of that; what it takes is latency.
//
// What held the first design back: compaction needs a row's leaves in id
// order, so one CTA owned 4 queries and walked every leaf tile in order
// (879 tiles on a 40M-point index), each tile a chain of dependent reads
// (the window starts of every level, a leaf's parent, then its MBR) and
// four barriers. A launch took the tile count times one tile's latency
// whatever the batch, on 128 CTAs of 8 warps for 512 queries.
//
// This design splits the leaf axis into S contiguous segments of at most
// ceil(n_tiles / S) tiles and runs three kernels over it, issued by one
// launch:
//   1. count: CTA (segment s, group g of kQT queries) walks its segment
//      and writes each row's visit count there, and the round of its first
//      visit, to scratch [2, B, S];
//   2. scan: one warp a row turns its S counts into each segment's first
//      rank (in place), writes the row's total (the count, exact past k)
//      and zero-fills the slots past it;
//   3. write: the same grid walks again, from the earliest first visit of
//      its open rows, and ranks each visit from its segment's first rank,
//      writing those below k. A CTA none of whose rows has a visit in its
//      segment below rank k returns after reading the ranks, and one stops
//      as soon as every row is done.
// Slots follow from the counts alone, so the result is deterministic and
// independent of the order CTAs run in. kernels.ops.compact_sliced_segments
// picks S so that the grid puts a few CTAs on every SM.
//
// Inside a segment, runs of tiles whose window starts agree at every level
// are found in parallel (each tile's starts read once) and walked as one:
// the windows root first, each level's frontier in shared memory as one
// kQT-bit mask per window node, a level whose window is unchanged kept, and
// a run under a level with no live node skipped without a read; then the
// run's leaves as one flat range, kUnroll leaves a thread a round, round
// r's hit tests running while round r + 1's MBRs and round r + 2's parents
// load. A node's or leaf's MBR is read only if its parent is live for one
// of the CTA's rows, and tested against the rows only if it meets the
// union of their boxes. The count pass needs no barrier between rounds:
// each thread tallies its visits per row in bytes, four rows a register,
// folded into per-lane counts by warp reductions before a byte can wrap.
// The write pass ballots each round's visits into a bitmap of kRound / 32
// words a row and, for the rows with a visit in the round, ranks a row
// per warp with shuffles (compact.cuh's block scan would take two
// barriers a row).
//
// Where the time goes on the 40M-point index's kNN batches (PERF.md): the
// dense clusters, where a leaf is live for most of a group's rows. Their
// segments hold most of the hit tests and MBR reads, so a small kQT and
// more segments than CTA slots spread them, until the cost every CTA pays
// (its windows' walk, its barriers) takes over.
//
// Shared memory: sum(width) masks of the frontiers, plus kQT * kRound / 32
// words of bitmap in the write pass, whatever the tree's size
// (kernels.ops.walk_smem); the wrapper routes a table that passes the
// limit to the per-level rung.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kQT = 8;        // queries per CTA (ops.COMPACT_SLICED_QUERY_TILE)
constexpr int kBlock = 256;   // threads per CTA
constexpr int kWarps = kBlock / 32;
// CTAs an SM the walk passes are built for (registers); the grid is four
// such waves (ops.COMPACT_SLICED_CTAS_PER_SM)
constexpr int kMinBlocks = 4;
constexpr int kUnroll = 2;    // leaves (or nodes) a thread has in flight
constexpr int kRound = kBlock * kUnroll;
constexpr int kWords = kRound / 32;   // bitmap words of a row per round
constexpr unsigned kFull = 0xffffffffu;
static_assert(kQT >= 1 && kQT <= 32, "a row is one bit of a mask");
static_assert(kWords <= 32, "the write pass ranks a round's words, one a lane");

// A frontier node's live rows, one bit per query of the CTA.
using Mask = std::conditional_t<
    (kQT <= 8), uint8_t, std::conditional_t<(kQT <= 16), uint16_t, uint32_t>>;

struct Levels {
  int n_int;                  // internal levels (root first)
  int off[kMaxLevels + 1];    // level l's nodes: [off[l], off[l+1])
  int width[kMaxLevels];      // level l's window width
  int foff[kMaxLevels + 1];   // level l's frontier: masks [foff[l], foff[l+1])
};

struct Walk {
  const float4* queries;
  int B;
  const float4* int_mbrs;     // internal levels packed root first
  const int* int_parents;
  const int* starts;          // [n_int, n_tiles] window block indices
  int n_tiles, tl;
  const float4* leaf_mbrs;
  const int* leaf_parents;
  int L;
  int S, per;                 // segments, tiles a segment
  int k;
};

__host__ __device__ constexpr int front_bytes(int n_masks) {
  return (n_masks * static_cast<int>(sizeof(Mask)) + 15) / 16 * 16;
}

__device__ __forceinline__ bool hit(const float4& q, const float4& m) {
  return (q.x <= m.z) && (m.x <= q.z) && (q.y <= m.w) && (m.y <= q.w);
}

// The rows of `live` whose query meets m. q[kQT] is the union of the
// rows' boxes: what misses it misses every row, for one test. Past it,
// every row is tested (the same q[j] in every lane: no divergence, one
// broadcast read): where a leaf is live for many rows, as in a dense
// cluster, that is cheaper than a loop over the live rows.
__device__ __forceinline__ unsigned hits(const float4* q, const float4& m,
                                         unsigned live) {
  if (!hit(q[kQT], m)) return 0u;
  unsigned r = 0;
#pragma unroll
  for (int j = 0; j < kQT; ++j)
    r |= static_cast<unsigned>(hit(q[j], m)) << j;
  return r & live;
}

// Walk level l's window (block sb) for `rows`, the level above's frontier
// `up` (window start us, width uw), into `mine`. Returns whether any node
// is live (all threads; a barrier).
__device__ bool walk_level(const Walk& w, const Levels& lv, int l, int sb,
                           const Mask* up, int us, int uw, Mask* mine,
                           unsigned rows, const float4* q) {
  const int lo = lv.off[l];
  const int n = lv.off[l + 1] - lo;
  const int wd = lv.width[l];
  const int s = sb * wd;
  bool any = false;
  for (int i0 = 0; i0 < wd; i0 += kRound) {
    int par[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kBlock + threadIdx.x;
      const int g = s + i;
      par[u] = l > 0 && i < wd && g >= 0 && g < n ? w.int_parents[lo + g] : 0;
    }
    unsigned pm[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kBlock + threadIdx.x;
      const int g = s + i;
      unsigned v = 0;
      if (i < wd && g >= 0 && g < n) {
        const int rel = par[u] - us;
        v = l == 0 ? rows : (rel >= 0 && rel < uw ? up[rel] & rows : 0u);
      }
      pm[u] = v;
    }
    float4 m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      m[u] = pm[u] ? w.int_mbrs[lo + s + i0 + u * kBlock + threadIdx.x]
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kBlock + threadIdx.x;
      if (i < wd) {
        const unsigned r = pm[u] ? hits(q, m[u], pm[u]) : 0u;
        mine[i] = static_cast<Mask>(r);
        any |= r != 0u;
      }
    }
  }
  return __syncthreads_or(any) != 0;
}

// Per-row state of the write pass, in shared memory.
struct Rows {
  int first[kQT];   // the segment's first rank
  int count[kQT];   // visits in the segment
  int run[kQT];     // visits ranked so far
  int from[kQT];    // the round of the first visit (its first leaf)
};

// The rows of `rows` that still have a visit to write below rank k.
__device__ __forceinline__ unsigned open_rows(const Rows& r, unsigned rows,
                                              int k) {
  unsigned out = 0;
  while (rows) {
    const int j = __ffs(rows) - 1;
    rows &= rows - 1;
    if (r.run[j] < r.count[j] && r.first[j] + r.run[j] < k) out |= 1u << j;
  }
  return out;
}

// One segment of one query group: the count pass (kWrite false) or the
// write pass.
template <bool kWrite>
__device__ void walk_segment(const Walk& w, const Levels& lv_arg,
                             int* __restrict__ scratch,
                             const int* __restrict__ cnt,
                             int* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Levels lv;   // indexed by level at run time: no local copy
  __shared__ float4 q[kQT + 1];   // the rows' boxes, then their union
  __shared__ Rows rs;
  __shared__ int seg_count[kQT];
  __shared__ int seg_from[kQT];   // count pass: Rows::from
  __shared__ int from_tile;       // write pass: the first tile to walk
  __shared__ int red[kWarps];
  __shared__ int cur[kMaxLevels];   // the run's window starts
  __shared__ unsigned warp_rows[2][kWarps];   // write pass
  const int s = blockIdx.x;
  const int b0 = blockIdx.y * kQT;
  const int nq = min(kQT, w.B - b0);
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int t0 = min(s * w.per, w.n_tiles);
  const int t1 = min(t0 + w.per, w.n_tiles);
  if (t == 0) lv = lv_arg;
  if (t < kQT) {
    q[t] = t < nq ? w.queries[b0 + t] : make_float4(0.f, 0.f, 0.f, 0.f);
    seg_count[t] = 0;
    seg_from[t] = INT_MAX;
    if constexpr (kWrite) {
      int f = 0, c = 0, from = INT_MAX;
      if (t < nq) {
        const int64_t row = static_cast<int64_t>(b0 + t) * w.S;
        f = scratch[row + s];
        c = (s + 1 < w.S ? scratch[row + s + 1] : cnt[b0 + t]) - f;
        from = scratch[static_cast<int64_t>(w.B) * w.S + row + s];
      }
      rs.first[t] = f;
      rs.count[t] = c;
      rs.run[t] = 0;
      rs.from[t] = from;
    }
  }
  __syncthreads();
  Mask* front = reinterpret_cast<Mask*>(smem);
  uint32_t* bits =
      reinterpret_cast<uint32_t*>(smem + front_bytes(lv.foff[lv.n_int]));
  unsigned rows = nq == 32 ? kFull : (1u << nq) - 1u;
  if constexpr (kWrite) {
    rows = open_rows(rs, rows, w.k);
    if (!rows) return;
  }
  if (t == 0) {
    const float inf = __int_as_float(0x7f800000);
    float4 u = make_float4(inf, inf, -inf, -inf);
    for (unsigned rr = rows; rr; rr &= rr - 1) {
      const float4& b = q[__ffs(rr) - 1];
      u = make_float4(fminf(u.x, b.x), fminf(u.y, b.y), fmaxf(u.z, b.z),
                      fmaxf(u.w, b.w));
    }
    q[kQT] = u;
    if constexpr (kWrite) {   // no open row has a visit before this tile
      int from = INT_MAX;
      for (unsigned rr = rows; rr; rr &= rr - 1)
        from = min(from, rs.from[__ffs(rr) - 1]);
      from_tile = max(t0, from / w.tl);
    }
  }
  __syncthreads();

  // Every thread keeps the same copy of these (all values are uniform
  // across the block): the window start each level's frontier holds
  // (INT_MIN: none) and whether any node in it is live.
  int held[kMaxLevels];
  bool held_live[kMaxLevels];
  for (int l = 0; l < lv.n_int; ++l) held[l] = INT_MIN;
  // count pass: each thread counts its visits of row j in byte j % 4 of
  // tally[j / 4]; every kFlush rounds (before a byte can wrap) the warp
  // adds them into lane j's lane_count
  constexpr int kTally = (kQT + 3) / 4;
  constexpr int kFlush = 255 / kUnroll;
  uint32_t tally[kTally];
#pragma unroll
  for (int r = 0; r < kTally; ++r) tally[r] = 0u;
  int since_flush = 0;
  int lane_count = 0;
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      const int c = static_cast<int>(__reduce_add_sync(
          kFull, (tally[j >> 2] >> (8 * (j & 3))) & 0xffu));
      if (lane == j) lane_count += c;
    }
#pragma unroll
    for (int r = 0; r < kTally; ++r) tally[r] = 0u;
    since_flush = 0;
  };
  const int last = lv.n_int - 1;
  int parity = 0;   // write pass: warp_rows buffer of this round

  unsigned seen = 0;   // count pass: rows this warp has seen a visit of
  for (int tile = kWrite ? from_tile : t0; tile < t1;) {
    // tile's window starts, one load a level (the barrier before: the last
    // run may still read cur and the frontiers)
    __syncthreads();
    if (t < lv.n_int) cur[t] = w.starts[t * w.n_tiles + tile];
    __syncthreads();
    // the run: tiles [tile, end) whose window starts equal tile's
    int end = t1;
    for (int c = tile + 1; c < t1; c += kBlock) {
      const int i = c + t;
      bool differs = false;
      if (i < t1)
        for (int l = 0; l < lv.n_int; ++l)
          differs |= w.starts[l * w.n_tiles + i] != cur[l];
      if (__syncthreads_or(differs)) {
        const int first = __reduce_min_sync(kFull, differs ? i : INT_MAX);
        if (lane == 0) red[warp] = first;
        __syncthreads();
        end = red[0];
#pragma unroll
        for (int v = 1; v < kWarps; ++v) end = min(end, red[v]);
        break;
      }
    }

    // levels whose window is unchanged keep their frontiers
    int l0 = 0;
    bool dead = false;
    while (l0 < lv.n_int && cur[l0] == held[l0]) {
      dead |= !held_live[l0];
      ++l0;
    }
    if (!dead && l0 < lv.n_int) {
      for (int l = l0; l < lv.n_int; ++l) {
        const int sb = cur[l];
        const int uw = l > 0 ? lv.width[l - 1] : 0;
        const int us = l > 0 ? held[l - 1] * uw : 0;
        const Mask* up = l > 0 ? front + lv.foff[l - 1] : nullptr;
        const bool live =
            walk_level(w, lv, l, sb, up, us, uw, front + lv.foff[l], rows, q);
        held[l] = sb;
        held_live[l] = live;
        if (!live) {
          dead = true;
          for (int d = l + 1; d < lv.n_int; ++d) held[d] = INT_MIN;
          break;
        }
      }
    }
    const int c0 = tile * w.tl;
    const int c1 = min(end * w.tl, w.L);
    tile = end;
    if (dead) continue;

    // the run's leaves, one flat range, in rounds of kRound leaves: round
    // r's hit tests run while round r + 1's MBRs and round r + 2's
    // parents load
    const int pw = lv.width[last];
    const int ps = held[last] * pw;
    const Mask* up = front + lv.foff[last];
    int par[kUnroll];
    unsigned live[kUnroll], live_next[kUnroll];
    float4 m[kUnroll], m_next[kUnroll];
    auto load_parents = [&](int b) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = b + u * kBlock + t;
        par[u] = i < c1 ? w.leaf_parents[i] : 0;
      }
    };
    auto load_mbrs = [&](int b, unsigned* lv_, float4* m_) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = b + u * kBlock + t;
        const int rel = par[u] - ps;
        lv_[u] = i < c1 && rel >= 0 && rel < pw ? up[rel] & rows : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        m_[u] = lv_[u] ? w.leaf_mbrs[b + u * kBlock + t]
                       : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    load_parents(c0);
    load_mbrs(c0, live, m);
    load_parents(c0 + kRound);
    for (int base = c0; base < c1; base += kRound) {
      load_mbrs(base + kRound, live_next, m_next);
      load_parents(base + 2 * kRound);
      unsigned h[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        h[u] = live[u] ? hits(q, m[u], live[u]) : 0u;
        live[u] = live_next[u];
        m[u] = m_next[u];
      }

      if constexpr (!kWrite) {
        // the round of each row's first visit in this warp
        unsigned fresh = 0;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) fresh |= h[u];
        fresh = __reduce_or_sync(kFull, fresh) & ~seen;
        if (fresh) {
          seen |= fresh;
          if (lane == 0)
            for (; fresh; fresh &= fresh - 1)
              atomicMin(&seg_from[__ffs(fresh) - 1], base);
        }
        // spread each 4-row nibble of h into 4 bytes: bit i -> byte i
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (h[u]) {
#pragma unroll
            for (int r = 0; r < kTally; ++r)
              tally[r] += ((h[u] >> (4 * r)) & 0xfu) * 0x00204081u &
                          0x01010101u;
          }
        }
        if (++since_flush == kFlush) flush();
        continue;
      }

      // write pass: rank this round's visits of every open row that has
      // one (per-warp row masks, double-buffered across rounds)
      unsigned mine = 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mine |= h[u];
      mine = __reduce_or_sync(kFull, mine);
      if (lane == 0) warp_rows[parity][warp] = mine;
      __syncthreads();
      unsigned found = 0;
#pragma unroll
      for (int v = 0; v < kWarps; ++v) found |= warp_rows[parity][v];
      parity ^= 1;
      rows = open_rows(rs, rows, w.k);   // ranks of earlier rounds are in
      if (!rows) return;
      found &= rows;
      if (!found) continue;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        unsigned rr = found;
        while (rr) {
          const int j = __ffs(rr) - 1;
          rr &= rr - 1;
          const unsigned word = __ballot_sync(kFull, (h[u] >> j) & 1u);
          if (lane == 0) bits[j * kWords + u * kWarps + warp] = word;
        }
      }
      __syncthreads();
      for (int j = warp; j < kQT; j += kWarps) {
        if (!((found >> j) & 1u)) continue;
        // lane v holds word v: leaves base + (v / kWarps) * kBlock +
        // (v % kWarps) * 32 + bit, so lane order is leaf order
        unsigned word = lane < kWords ? bits[j * kWords + lane] : 0u;
        const int c = __popc(word);
        int incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += y;
        }
        const int tot = __shfl_sync(kFull, incl, 31);
        const int run = rs.run[j];
        int rank = rs.first[j] + run + incl - c;
        const int col =
            base + (lane / kWarps) * kBlock + (lane % kWarps) * 32;
        int* out = idx + static_cast<int64_t>(b0 + j) * w.k;
        while (word && rank < w.k) {
          out[rank++] = col + __ffs(word) - 1;
          word &= word - 1;
        }
        __syncwarp();
        if (lane == 0) rs.run[j] = run + tot;
      }
    }
  }

  if constexpr (!kWrite) {
    flush();
    if (lane < kQT && lane_count) atomicAdd(&seg_count[lane], lane_count);
    __syncthreads();
    if (t < nq) {
      const int64_t row = static_cast<int64_t>(b0 + t) * w.S;
      scratch[row + s] = seg_count[t];
      scratch[static_cast<int64_t>(w.B) * w.S + row + s] = seg_from[t];
    }
  }
}

__global__ void __launch_bounds__(kBlock, kMinBlocks)
traverse_compact_sliced_kernel_count(Walk w, Levels lv,
                                     int* __restrict__ scratch) {
  walk_segment<false>(w, lv, scratch, nullptr, nullptr);
}

// One warp a row: exclusive scan of the row's S segment counts in place,
// the row's total, and the zero fill of its slots past the total.
__global__ void __launch_bounds__(kBlock)
traverse_compact_sliced_kernel_scan(int B, int S, int k,
                                    int* __restrict__ scratch,
                                    int* __restrict__ cnt,
                                    int* __restrict__ idx) {
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  int* row = scratch + static_cast<int64_t>(b) * S;
  int carry = 0;
  for (int s0 = 0; s0 < S; s0 += 32) {
    const int s = s0 + lane;
    const int v = s < S ? row[s] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (s < S) row[s] = carry + incl - v;
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) cnt[b] = carry;
  int* out = idx + static_cast<int64_t>(b) * k;
  for (int i = min(carry, k) + lane; i < k; i += 32) out[i] = 0;
}

__global__ void __launch_bounds__(kBlock, kMinBlocks)
traverse_compact_sliced_kernel_write(Walk w, Levels lv,
                                     const int* __restrict__ scratch,
                                     const int* __restrict__ cnt,
                                     int* __restrict__ idx) {
  walk_segment<true>(w, lv, const_cast<int*>(scratch), cnt, idx);
}

cudaError_t allow_smem(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// queries [B,4] f32; int_mbrs/int_parents: the internal levels packed root
// first, level l at [h_offsets[l], h_offsets[l+1]) (host array, n_int+1
// entries; parents index the previous level); starts [n_int, n_tiles] i32
// window block indices (device), h_widths [n_int] window widths (host);
// leaf_mbrs [L,4] f32, leaf_parents [L] i32 -> idx [B,k] i32, cnt [B] i32;
// scratch [2,B,S] i32 (each segment's visit count, then its first rank;
// the round of each row's first visit in it), S >= 1 segments of
// ceil(n_tiles / S) tiles. Issues the count, scan and write kernels on the
// stream; returns the first failing launch's cudaError_t.
extern "C" int traverse_compact_sliced_launch(
    const float* queries, int B, const float* int_mbrs,
    const int* int_parents, const int* h_offsets, int n_int,
    const int* starts, const int* h_widths, int n_tiles, int tl,
    const float* leaf_mbrs, const int* leaf_parents, int L, int k, int* idx,
    int* cnt, int* scratch, int S, void* stream) {
  if (n_int < 1 || n_int > kMaxLevels || B <= 0 || L <= 0 || tl <= 0 ||
      k <= 0 || S <= 0 || n_tiles != (L + tl - 1) / tl ||
      (B + kQT - 1) / kQT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Walk w = {};
  w.queries = reinterpret_cast<const float4*>(queries);
  w.B = B;
  w.int_mbrs = reinterpret_cast<const float4*>(int_mbrs);
  w.int_parents = int_parents;
  Levels lv = {};
  lv.n_int = n_int;
  for (int l = 0; l <= n_int; ++l) lv.off[l] = h_offsets[l];
  for (int l = 0; l < n_int; ++l) {
    if (h_widths[l] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    lv.width[l] = h_widths[l];
    lv.foff[l + 1] = lv.foff[l] + h_widths[l];
  }
  w.starts = starts;
  w.n_tiles = n_tiles;
  w.tl = tl;
  w.leaf_mbrs = reinterpret_cast<const float4*>(leaf_mbrs);
  w.leaf_parents = leaf_parents;
  w.L = L;
  w.S = S;
  w.per = (n_tiles + S - 1) / S;
  w.k = k;
  const int count_smem = front_bytes(lv.foff[n_int]);
  const int write_smem = count_smem + kQT * kWords * 4;
  cudaError_t e = allow_smem(
      reinterpret_cast<const void*>(traverse_compact_sliced_kernel_count),
      count_smem);
  if (e == cudaSuccess)
    e = allow_smem(
        reinterpret_cast<const void*>(traverse_compact_sliced_kernel_write),
        write_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(S, (B + kQT - 1) / kQT);
  traverse_compact_sliced_kernel_count<<<grid, kBlock, count_smem, st>>>(
      w, lv, scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  traverse_compact_sliced_kernel_scan<<<(B + kWarps - 1) / kWarps, kBlock, 0,
                                        st>>>(B, S, k, scratch, cnt, idx);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  traverse_compact_sliced_kernel_write<<<grid, kBlock, write_smem, st>>>(
      w, lv, scratch, cnt, idx);
  return static_cast<int>(cudaGetLastError());
}
