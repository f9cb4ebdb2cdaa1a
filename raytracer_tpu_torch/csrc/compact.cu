// compact: the cluster engine's shortlist compaction.  A tile's row of the
// (tiles, C) cluster mask (hit bytes, slab entries) becomes what the
// visibility kernels read: the bitmask words, the first max_list hit
// columns front to back by entry, their entries and the unclamped count.
//
// Replaces no Pallas kernel: the JAX package's _compact
// (raytracer_tpu/ops/cluster_trace.py) is XLA's lax.top_k over -entry and
// a bit packing of the mask by multiplies and sums; the port's plain
// version (kernels.compact_plain) is a full stable torch.sort of every
// column and an int64 sum.  The output is the same function:
//
//   words[i*W + w]    bit b is hit[i, 32w + b]          (W = ceil(C / 32))
//   counts[i]         the number of hit columns of tile i, unclamped
//   ids, elist        at positions < min(counts[i], max_list): tile i's hit
//                     columns by ascending entry, equal entries by
//                     ascending column (a stable sort; -0 and +0 equal),
//                     and those entries, bit for bit; past that, id 0 and
//                     +inf (no visitor reads them)
//   tally (optional)  += [tiles with a hit column, tiles whose count
//                     passes max_list]: two int64 running sums (the
//                     lists a visitor walks, and those it walks as the
//                     bitmask), one atomic add each from such a tile's
//                     warp; a null tally counts nothing
//
// What bounds it: memory.  It reads C bytes of hit per tile, 4 bytes of
// entry per hit column, and writes 4 W + 8 max_list + 4 bytes per tile;
// it does no float arithmetic.  A 131,072-ray band of the 524,288-triangle
// terrain is 1,024 tiles x 4,096 columns (4.2 MB of hit).
//
// Design: one warp a tile, 4 tiles a block.  The warp streams the row's
// hit bytes as aligned 16-byte loads, one a lane (512 columns a warp
// load; the next load is in flight while the current one is worked on), a
// row that starts off a 16-byte boundary (the strided triangle and sphere
// slices of one concatenated mask) read from the boundary below with the
// bits outside the row masked.  Each lane turns its 16 bytes into 16 bits;
// two lanes' bits make 32 bits of the row, and a funnel shift by the row's
// misalignment gives word w, so words and counts need no pass of their
// own.  Entries are gathered at hit columns only (most columns miss: the
// big terrain's hierarchical masks leave ~2 live chunks of 32 a tile).
// The hit (entry, column) pairs are appended to a per-warp buffer in
// shared memory in ascending column order, by a prefix sum of the lanes'
// bit counts, so a pair's buffer position orders equal entries.  The
// selection costs what the tile's count asks: a tile with at most
// max_list hits ranks them directly (each lane counts the pairs before
// its own); above that, a radix select (4 passes of 8 bits over the
// order-preserving key of the entry) finds the max_list-th key and keeps
// the pairs below it and the first of those equal to it, in order, and
// the survivors are ranked.  The buffer holds one warp load's candidates
// beyond max_list: when a load would overflow it, that selection prunes
// it first, and from then on only entries below the last selected key are
// kept (a later column with an equal entry ranks behind it).  The kernel
// allocates nothing and launches on the caller's stream, so it is
// captured inside the programs' CUDA graphs.

#include <cstdint>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;             // tiles a block, one a warp
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSpan = 32 * 16;        // columns of one warp load
constexpr int kMaxList = 64;          // the ranking takes 2 survivors a lane
constexpr int kBins = 256;            // radix select: 8 bits a pass
constexpr int kGather = 4;            // entry loads a lane keeps in flight

// Unsigned key in the order of the floats under <, with -0 as +0.
__device__ __forceinline__ unsigned order_key(unsigned raw) {
  raw = raw == 0x80000000u ? 0u : raw;
  return (raw & 0x80000000u) ? ~raw : (raw | 0x80000000u);
}

// Four bool bytes (0 or 1) -> four bits, byte j at bit j.
__device__ __forceinline__ unsigned byte_bits(unsigned x) {
  return (x | x >> 7 | x >> 14 | x >> 21) & 0xfu;
}

__device__ __forceinline__ unsigned chunk_bits(uint4 v) {
  return byte_bits(v.x) | byte_bits(v.y) << 4 | byte_bits(v.z) << 8 |
         byte_bits(v.w) << 12;
}

// Bits of 16-byte chunk j that are columns of the row: column 16 j + b - r
// in [0, c).
__device__ __forceinline__ unsigned valid_bits(int j, int r, int c) {
  const int lo = r - 16 * j, hi = c + r - 16 * j;
  unsigned m = 0xffffu;
  if (lo > 0) m &= 0xffffu << lo;
  if (hi < 16) m &= hi > 0 ? (1u << hi) - 1u : 0u;
  return m;
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// Keep the k smallest of the nb > k buffered pairs (key, then position),
// in buffer order, at positions [0, k); returns the k-th smallest key.
__device__ unsigned select_smallest(unsigned* skey, int* sid, int* hist,
                                    int nb, int k, int lane) {
  unsigned prefix = 0u, pmask = 0u;
  int rank = k;  // 1-based rank among the keys that match prefix so far
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = lane; b < kBins; b += 32) hist[b] = 0;
    __syncwarp();
    for (int p = lane; p < nb; p += 32) {
      const unsigned u = order_key(skey[p]);
      if ((u & pmask) == prefix) atomicAdd(&hist[(u >> shift) & 0xffu], 1);
    }
    __syncwarp();
    int h[kBins / 32], sum = 0;
#pragma unroll
    for (int t = 0; t < kBins / 32; ++t) {
      h[t] = hist[lane * (kBins / 32) + t];
      sum += h[t];
    }
    const int incl = warp_inclusive_sum(sum, lane), excl = incl - sum;
    const bool mine = excl < rank && rank <= incl;
    const int src = __ffs(__ballot_sync(kFull, mine)) - 1;
    int digit = 0, below = excl;
    if (mine) {
#pragma unroll
      for (int t = 0; t < kBins / 32; ++t) {
        if (below + h[t] >= rank) {
          digit = lane * (kBins / 32) + t;
          break;
        }
        below += h[t];
      }
    }
    digit = __shfl_sync(kFull, digit, src);
    below = __shfl_sync(kFull, below, src);
    prefix |= static_cast<unsigned>(digit) << shift;
    pmask |= 0xffu << shift;
    rank -= below;
    __syncwarp();  // every lane has read hist before the next pass clears it
  }
  // the keys below prefix, and the first `rank` keys equal to it
  int dst = 0, eq_seen = 0;
  for (int q = 0; q < nb; q += 32) {
    const int p = q + lane;
    const unsigned raw = p < nb ? skey[p] : 0u;
    const int id = p < nb ? sid[p] : 0;
    const unsigned u = order_key(raw);
    const bool eq = p < nb && u == prefix;
    const unsigned eqb = __ballot_sync(kFull, eq);
    const bool keep = (p < nb && u < prefix) ||
                      (eq && eq_seen + __popc(eqb & lanes_below(lane)) < rank);
    const unsigned kb = __ballot_sync(kFull, keep);
    __syncwarp();  // every lane has read its pair before any is overwritten
    if (keep) {
      const int d = dst + __popc(kb & lanes_below(lane));
      skey[d] = raw;
      sid[d] = id;
    }
    dst += __popc(kb);
    eq_seen += __popc(eqb);
    __syncwarp();
  }
  return prefix;
}

__global__ void __launch_bounds__(kWarps * 32) compact_kernel(
    const unsigned char* __restrict__ hit, long long hstride,
    const float* __restrict__ entry, long long estride,
    int* __restrict__ words, int* __restrict__ ids, float* __restrict__ elist,
    int* __restrict__ counts, unsigned long long* __restrict__ tally,
    int nt, int c, int max_list, int cap) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= nt) return;
  unsigned* skey = reinterpret_cast<unsigned*>(smem) + warp * (2 * cap + kBins);
  int* sid = reinterpret_cast<int*>(skey + cap);
  int* hist = sid + cap;

  const unsigned char* row = hit + i * hstride;
  const float* erow = entry + i * estride;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(row);
  const int r = static_cast<int>(addr & 15u);
  const uint4* base = reinterpret_cast<const uint4*>(addr - r);
  const int nchunk = c > 0 ? (r + c + 15) >> 4 : 0;
  const int nit = (nchunk + 31) >> 5, nw = (c + 31) >> 5;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  uint4 nxt = lane < nchunk ? __ldg(base + lane) : zero;
  int count = 0, nb = 0;
  bool pruned = false;
  unsigned thr = 0u;
  for (int it = 0; it < nit; ++it) {
    const int j = it * 32 + lane;
    const uint4 cur = nxt;
    nxt = j + 32 < nchunk ? __ldg(base + j + 32) : zero;
    const unsigned m = chunk_bits(cur) & valid_bits(j, r, c);

    // words: lane k < 16 joins chunks 2k and 2k + 1 into 32 bits of the
    // row's stream (bit s is column s - r), and shifts in the next 32
    const int k = lane & 15;
    const unsigned s = __shfl_sync(kFull, m, 2 * k) |
                       __shfl_sync(kFull, m, 2 * k + 1) << 16;
    unsigned s1 = __shfl_down_sync(kFull, s, 1);
    const unsigned mn = chunk_bits(nxt) & valid_bits(j + 32, r, c);
    const unsigned n0 = __shfl_sync(kFull, mn, 0) | __shfl_sync(kFull, mn, 1) << 16;
    if (lane == 15) s1 = n0;
    const int w = it * 16 + lane;
    if (lane < 16 && w < nw) {
      words[static_cast<long long>(i) * nw + w] =
          static_cast<int>(__funnelshift_r(s, s1, r));
    }

    // the hit columns, appended in ascending order
    const int pc = __popc(m);
    const int incl = warp_inclusive_sum(pc, lane);
    const int total = __shfl_sync(kFull, incl, 31);
    count += total;
    if (total == 0) continue;
    if (nb + total > cap) {
      thr = select_smallest(skey, sid, hist, nb, max_list, lane);
      nb = max_list;
      pruned = true;
    }
    int pos = nb + incl - pc;
    for (unsigned mm = m; mm != 0u; mm &= mm - 1u) {
      sid[pos++] = 16 * j - r + __ffs(mm) - 1;
    }
    __syncwarp();
    // their entries; after a prune only those below its key stay
    int dst = nb;
    for (int q = 0; q < total; q += 32 * kGather) {
      int col[kGather];
      float e[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int p = q + 32 * u + lane;
        col[u] = p < total ? sid[nb + p] : 0;
        e[u] = p < total ? __ldg(erow + col[u]) : 0.0f;
      }
      __syncwarp();  // read before the compaction overwrites
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int p = q + 32 * u + lane;
        const unsigned raw = __float_as_uint(e[u]);
        const bool keep = p < total && (!pruned || order_key(raw) < thr);
        const unsigned kb = __ballot_sync(kFull, keep);
        if (keep) {
          const int d = dst + __popc(kb & lanes_below(lane));
          skey[d] = raw;
          sid[d] = col[u];
        }
        dst += __popc(kb);
      }
      __syncwarp();
    }
    nb = dst;
  }

  if (lane == 0) {
    counts[i] = count;
    if (tally != nullptr && count > 0) {
      atomicAdd(tally, 1ull);
      if (count > max_list) atomicAdd(tally + 1, 1ull);
    }
  }
  if (nb > max_list) {
    select_smallest(skey, sid, hist, nb, max_list, lane);
    nb = max_list;
  }
  int* out_ids = ids + static_cast<long long>(i) * max_list;
  float* out_e = elist + static_cast<long long>(i) * max_list;
  for (int p = lane; p < max_list; p += 32) {
    if (p < nb) {
      const unsigned raw = skey[p], u = order_key(raw);
      int rank = 0;
      for (int q = 0; q < nb; ++q) {
        const unsigned v = order_key(skey[q]);
        rank += (v < u || (v == u && q < p)) ? 1 : 0;
      }
      out_ids[rank] = sid[p];
      out_e[rank] = __uint_as_float(raw);
    } else {
      out_ids[p] = 0;
      out_e[p] = CUDART_INF_F;
    }
  }
}

}  // namespace

// hit: bool rows of c bytes, row i at hit + i * hstride (any alignment);
// entry: f32 rows, row i at entry + i * estride; words (nt * ceil(c / 32)),
// ids, elist (nt * max_list), counts (nt): outputs; tally: two int64 sums
// added to, or null.  max_list in [1, 64].
extern "C" int rt_compact(const unsigned char* hit, long long hstride,
                          const float* entry, long long estride, int* words,
                          int* ids, float* elist, int* counts,
                          unsigned long long* tally, int nt, int c,
                          int max_list, void* stream) {
  if (nt < 0 || c < 0 || max_list < 1 || max_list > kMaxList) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nt > 0) {
    // a buffer of every column, or of max_list pairs and one warp load
    const int cap = c + 31 - (c + 31) % 32 < max_list + kSpan
                        ? c + 31 - (c + 31) % 32
                        : max_list + kSpan;
    const size_t smem = sizeof(int) * kWarps * (2 * cap + kBins);
    compact_kernel<<<(nt + kWarps - 1) / kWarps, kWarps * 32, smem,
                     static_cast<cudaStream_t>(stream)>>>(
        hit, hstride, entry, estride, words, ids, elist, counts, tally, nt,
        c, max_list, cap);
  }
  return static_cast<int>(cudaGetLastError());
}
