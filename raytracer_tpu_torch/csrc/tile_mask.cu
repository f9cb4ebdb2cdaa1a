// tile_mask: the interval-arithmetic tile test of shared-origin eye waves.
// Could any ray of a tile hit a cluster box?  Per tile, the boxes that
// bound its rays' origins and directions; per (tile, cluster) the slab
// test in interval arithmetic, conservative and near-tight for the
// coherent frusta of eye tiles.
//
// Replaces no Pallas kernel: the JAX package's tile_cluster_mask
// (raytracer_tpu/ops/cluster_trace.py) is XLA glue, and the port's plain
// version (kernels.tile_mask_plain) builds about twenty dense
// (tiles, C, 3) float tensors, about 50 MB each on a band of the
// 524,288-triangle terrain (1,024 tiles x 4,096 columns).  The output is
// the same function, bit for bit (IEEE float32, no fast math, no FMA
// contraction: backend.py builds every kernel with -fmad=false):
//
//   per tile (or sub-interval of `tile / sub` consecutive rays): o_lo,
//   o_hi, d_lo, d_hi the least and greatest origin and direction
//   components over its active rays (all rays without `active`); a tile
//   without an active ray takes the point interval o = 0, d = 1 and cap 0;
//   cap the greatest t_hi over the same rays; per axis crosses = d_lo <= 0
//   && d_hi >= 0, i_lo = crosses ? -1e18 : 1 / d_hi, i_hi = crosses ? 1e18
//   : 1 / d_lo;
//   per (tile, column, axis): n1 = [cmin - o_hi, cmin - o_lo], n2 = [cmax -
//   o_hi, cmax - o_lo], t1 = n1 * [i_lo, i_hi] and t2 = n2 * [i_lo, i_hi]
//   (each the min and max of the four products), near = min(t1_lo,
//   t2_lo), far = max(t1_hi, t2_hi);
//   entry = the max of the three nears, exit = the min of the fars; hit =
//   entry <= exit && exit >= 0 [&& entry <= cap] [&& the tile has an
//   active ray].  With sub > 1 a tile's sub-intervals merge: hit is any,
//   entry the least over the sub-intervals that hit (+inf when none).
//
// Every min and max propagates NaN like torch.minimum / amax (nan_min,
// nan_max of common.cuh): cluster tables hold NaN boxes (empty and
// padding clusters), and a NaN fails every comparison, so it never hits.
// A min or max is exact in any order, so the reductions over a tile's
// rays may run in any order; the one freedom is the sign of a zero
// result, which no comparison sees and which the shortlist compaction
// orders as equal (csrc/compact.cu).  A zero direction bound takes the
// crossing branch whatever its sign (d_lo <= 0 <= d_hi).
//
// Four products in place of eight.  Where the box's six bounds are finite
// with cmin <= cmax, and the tile's o_lo, o_hi, i_lo, i_hi are finite with
// nonzero i's (the record's flag), none of the eight products of an axis
// is NaN (a finite nonzero i times a finite or overflowed n), and
// rounding is monotone: n1_lo = cmin - o_hi is the least of the four
// numerators and n2_hi = cmax - o_lo the greatest, so for each i the least
// and greatest of n * i are among n1_lo * i and n2_hi * i.  near is then
// the min, and far the max, of the four products n1_lo * i_lo, n1_lo *
// i_hi, n2_hi * i_lo, n2_hi * i_hi: the same values as the eight give.
// Any other pair (a NaN or infinite bound, a zero or infinite reciprocal)
// takes the eight products and the plain version's order of minima and
// maxima.
//
// What bounds it: the output stores and instruction issue.  5 bytes
// written a (tile, column) pair; 42 float operations a pair on the four-
// product path (per axis 2 subtracts, 4 multiplies, 6 min/max; 4 for the
// axis reductions, 2 compares), 84 on the eight-product one.  A terrain
// band's call is 4.19M pairs and 21 MB out; the rays are read once per
// block that covers their tile (3.3 MB on a band, from L2 after the first
// block; the horse frame's 32,400 tiles read 4.1M rays, 104 MB).
//
// Design: a 2-D grid over (tile group, column group).  A block takes tb
// consecutive tiles and w consecutive columns, both chosen per launch from
// nt and C (rt_tile_mask): at most kMaxColumns columns, about kPairs
// (tile, column) pairs, at most kMaxGroup tiles, and fewer tiles while the
// grid would give the SMs fewer than kBlocksPerSm blocks each.  First each
// warp reduces whole sub-intervals (lanes stride over the rays, then a
// butterfly of shuffles) into a record in shared memory: the tile's bounds
// never reach device memory.  Then thread j of the block holds columns j,
// j + 128, ... (at most kMaxCols, their boxes in registers) and walks the
// tiles, reading each tile's record once (a broadcast from shared memory)
// for all its columns; with fewer than 128 columns the threads split into
// groups that take every ng-th tile.  Consecutive threads store
// consecutive bytes of a row.  Every pair is written by one thread: no
// atomics, deterministic.  The kernel allocates nothing and launches on
// the caller's stream, so it is captured inside the programs' CUDA graphs.
// On an H100 (PERF.md): the column walk with the record read once a tile
// and the four-product path took a terrain band's call from 36.7 to 24.4
// us; 256 columns a block, 1,024 or 4,096 to 8,192 pairs a block, and a
// register cap for 12 or 16 blocks a SM (spills) were slower.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPairs = 2048;          // (tile, column) pairs a block aims at
constexpr int kMaxGroup = 32;         // tiles a block
constexpr int kMaxRecords = 256;      // sub-interval records a block
constexpr int kMaxColumns = 512;      // columns a block
constexpr int kMaxCols = (kMaxColumns + kThreads - 1) / kThreads;  // a thread
constexpr int kBlocksPerSm = 4;
constexpr float kBig = 1e18f;         // the finite reciprocal sentinel _BIG

// A sub-interval's bounds: (o_lo, cap), (o_hi, none), (i_lo, finite),
// (i_hi, 0).  `finite`: o_lo, o_hi, i_lo, i_hi finite and the i's nonzero.
struct Record {
  float4 lo, hi, ilo, ihi;
};

__device__ __forceinline__ float crossing_recip(bool crosses, float big,
                                                float d) {
  return crosses ? big : 1.0f / d;
}

// A box whose six bounds are finite with lo <= hi on every axis.
__device__ __forceinline__ bool finite_box(const float* bl, const float* bh) {
  bool ok = true;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    ok = ok && isfinite(bl[a]) && isfinite(bh[a]) && bl[a] <= bh[a];
  }
  return ok;
}

// (hit, entry) of one sub-interval and one box.  Where both are finite
// (finite_box, the record's flag) the four products n1_lo * i and n2_hi * i
// bound the eight (see the note above); otherwise all eight are taken, as
// the plain version does.
__device__ __forceinline__ bool pair_test(const Record& r, const float* bl,
                                          const float* bh, bool box_ok,
                                          bool use_cap, float* entry) {
  const float olo[3] = {r.lo.x, r.lo.y, r.lo.z};
  const float ohi[3] = {r.hi.x, r.hi.y, r.hi.z};
  const float il[3] = {r.ilo.x, r.ilo.y, r.ilo.z};
  const float ih[3] = {r.ihi.x, r.ihi.y, r.ihi.z};
  float nr[3], fr[3];
  if (box_ok && r.ilo.w != 0.0f) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float n1l = bl[a] - ohi[a], n2h = bh[a] - olo[a];
      const float p1 = n1l * il[a], p2 = n1l * ih[a];
      const float q3 = n2h * il[a], q4 = n2h * ih[a];
      nr[a] = nan_min(nan_min(p1, p2), nan_min(q3, q4));
      fr[a] = nan_max(nan_max(p1, p2), nan_max(q3, q4));
    }
  } else {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float n1l = bl[a] - ohi[a], n1h = bl[a] - olo[a];
      const float n2l = bh[a] - ohi[a], n2h = bh[a] - olo[a];
      const float p1 = n1l * il[a], p2 = n1l * ih[a];
      const float p3 = n1h * il[a], p4 = n1h * ih[a];
      const float q1 = n2l * il[a], q2 = n2l * ih[a];
      const float q3 = n2h * il[a], q4 = n2h * ih[a];
      const float t1l = nan_min(nan_min(p1, p2), nan_min(p3, p4));
      const float t1h = nan_max(nan_max(p1, p2), nan_max(p3, p4));
      const float t2l = nan_min(nan_min(q1, q2), nan_min(q3, q4));
      const float t2h = nan_max(nan_max(q1, q2), nan_max(q3, q4));
      nr[a] = nan_min(t1l, t2l);
      fr[a] = nan_max(t1h, t2h);
    }
  }
  const float en = nan_max(nan_max(nr[0], nr[1]), nr[2]);
  const float ex = nan_min(nan_min(fr[0], fr[1]), fr[2]);
  *entry = en;
  return en <= ex && ex >= 0.0f && (!use_cap || en <= r.lo.w) &&
         r.hi.w == 0.0f;
}

// NC: columns a thread holds; SUB1: one sub-interval a tile.
template <int NC, bool SUB1>
__global__ void __launch_bounds__(kThreads) tile_mask_kernel(
    const float* __restrict__ origin, const float* __restrict__ dirs,
    const unsigned char* __restrict__ active, const float* __restrict__ cmin,
    const float* __restrict__ cmax, const float* __restrict__ t_hi,
    unsigned char* __restrict__ hit, float* __restrict__ entry, int nt, int c,
    int tile, int sub, int tb, int w) {
  extern __shared__ Record rec[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t0 = blockIdx.x * tb;
  const int ntb = min(tb, nt - t0);
  const int rays = tile / sub;
  const float inf = CUDART_INF_F;

  // 1. each warp reduces whole sub-intervals to their records
  for (int s = warp; s < ntb * sub; s += kWarps) {
    const long long r0 = static_cast<long long>(t0) * tile +
                         static_cast<long long>(s) * rays;
    float olo[3] = {inf, inf, inf}, ohi[3] = {-inf, -inf, -inf};
    float dlo[3] = {inf, inf, inf}, dhi[3] = {-inf, -inf, -inf};
    float cap = -inf;
    bool any = false;
#pragma unroll 4
    for (int k = lane; k < rays; k += 32) {
      const long long i = r0 + k;
      if (active != nullptr && active[i] == 0) continue;
      any = true;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float o = __ldg(origin + 3 * i + a), d = __ldg(dirs + 3 * i + a);
        olo[a] = nan_min(olo[a], o);
        ohi[a] = nan_max(ohi[a], o);
        dlo[a] = nan_min(dlo[a], d);
        dhi[a] = nan_max(dhi[a], d);
      }
      if (t_hi != nullptr) cap = nan_max(cap, __ldg(t_hi + i));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        olo[a] = nan_min(olo[a], __shfl_xor_sync(RT_FULL_MASK, olo[a], off));
        ohi[a] = nan_max(ohi[a], __shfl_xor_sync(RT_FULL_MASK, ohi[a], off));
        dlo[a] = nan_min(dlo[a], __shfl_xor_sync(RT_FULL_MASK, dlo[a], off));
        dhi[a] = nan_max(dhi[a], __shfl_xor_sync(RT_FULL_MASK, dhi[a], off));
      }
      cap = nan_max(cap, __shfl_xor_sync(RT_FULL_MASK, cap, off));
    }
    any = __any_sync(RT_FULL_MASK, any);
    if (lane == 0) {
      const bool none = active != nullptr && !any;
      if (none) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          olo[a] = ohi[a] = 0.0f;
          dlo[a] = dhi[a] = 1.0f;
        }
        cap = 0.0f;
      }
      float ilo[3], ihi[3];
      bool ok = true;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const bool crosses = dlo[a] <= 0.0f && dhi[a] >= 0.0f;
        ilo[a] = crossing_recip(crosses, -kBig, dhi[a]);
        ihi[a] = crossing_recip(crosses, kBig, dlo[a]);
        ok = ok && isfinite(olo[a]) && isfinite(ohi[a]) && isfinite(ilo[a]) &&
             isfinite(ihi[a]) && ilo[a] != 0.0f && ihi[a] != 0.0f;
      }
      rec[s] = Record{make_float4(olo[0], olo[1], olo[2], cap),
                      make_float4(ohi[0], ohi[1], ohi[2], none ? 1.0f : 0.0f),
                      make_float4(ilo[0], ilo[1], ilo[2], ok ? 1.0f : 0.0f),
                      make_float4(ihi[0], ihi[1], ihi[2], 0.0f)};
    }
  }
  __syncthreads();

  // 2. thread (g, j) holds columns j, j + cw, ... of the block's (at most
  // NC of them) and takes tiles g, g + ng, ...
  const int c0 = blockIdx.y * w;
  const int wc = min(w, c - c0);
  const int cw = min(wc, kThreads);
  const int ng = kThreads / cw;
  const int g = threadIdx.x / cw, j = threadIdx.x - g * cw;
  if (g >= ng) return;
  const bool use_cap = t_hi != nullptr;
  float bl[NC][3], bh[NC][3];
  bool box_ok[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int k = c0 + min(j + q * cw, wc - 1);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      bl[q][a] = __ldg(cmin + 3 * k + a);
      bh[q][a] = __ldg(cmax + 3 * k + a);
    }
    box_ok[q] = finite_box(bl[q], bh[q]);
  }
  for (int t = g; t < ntb; t += ng) {
    bool h[NC];
    float e[NC];
    if (SUB1) {
      const Record r = rec[t];
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        h[q] = pair_test(r, bl[q], bh[q], box_ok[q], use_cap, &e[q]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        h[q] = false;
        e[q] = inf;
      }
      for (int s = 0; s < sub; ++s) {
        const Record r = rec[t * sub + s];
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          float en;
          if (pair_test(r, bl[q], bh[q], box_ok[q], use_cap, &en)) {
            h[q] = true;
            e[q] = fminf(e[q], en);  // a hit's entry is never NaN
          }
        }
      }
    }
    const long long o = static_cast<long long>(t0 + t) * c + c0 + j;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      if (j + q * cw < wc) {
        hit[o + q * cw] = h[q] ? 1 : 0;
        entry[o + q * cw] = e[q];
      }
    }
  }
}

template <int NC>
void launch(bool sub1, dim3 grid, size_t smem, cudaStream_t stream,
            const float* origin, const float* dirs,
            const unsigned char* active, const float* cmin, const float* cmax,
            const float* t_hi, unsigned char* hit, float* entry, int nt, int c,
            int tile, int sub, int tb, int w) {
  if (sub1) {
    tile_mask_kernel<NC, true><<<grid, kThreads, smem, stream>>>(
        origin, dirs, active, cmin, cmax, t_hi, hit, entry, nt, c, tile, sub,
        tb, w);
  } else {
    tile_mask_kernel<NC, false><<<grid, kThreads, smem, stream>>>(
        origin, dirs, active, cmin, cmax, t_hi, hit, entry, nt, c, tile, sub,
        tb, w);
  }
}

}  // namespace

// origin, dirs: (nt * tile, 3) f32; active: (nt * tile) bool bytes or
// null; cmin, cmax: (c, 3) f32; t_hi: (nt * tile) f32 or null; hit (nt, c)
// bool bytes and entry (nt, c) f32: outputs.  tile % sub == 0, sub at
// most kMaxRecords.
extern "C" int rt_tile_mask(const float* origin, const float* dirs,
                            const unsigned char* active, const float* cmin,
                            const float* cmax, const float* t_hi,
                            unsigned char* hit, float* entry, int nt, int c,
                            int tile, int sub, void* stream) {
  if (nt < 0 || c < 0 || tile < 1 || sub < 1 || tile % sub != 0 ||
      sub > kMaxRecords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nt > 0 && c > 0) {
    const int w = c < kMaxColumns ? c : kMaxColumns;
    const int groups = (c + w - 1) / w;
    int tb = (kPairs + w - 1) / w;
    tb = tb < kMaxGroup ? tb : kMaxGroup;
    tb = tb < kMaxRecords / sub ? tb : kMaxRecords / sub;
    tb = tb > 1 ? tb : 1;
    const long long want = static_cast<long long>(kBlocksPerSm) * sm_count();
    while (tb > 1 && static_cast<long long>((nt + tb - 1) / tb) * groups < want) {
      tb = (tb + 1) / 2;
    }
    if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((nt + tb - 1) / tb, groups);
    const size_t smem = sizeof(Record) * tb * sub;
    const int nc = (w + kThreads - 1) / kThreads;
    auto st = static_cast<cudaStream_t>(stream);
    static_assert(kMaxCols <= 4, "a launch holds at most 4 columns a thread");
    switch (nc) {
      case 1:
        launch<1>(sub == 1, grid, smem, st, origin, dirs, active, cmin, cmax,
                  t_hi, hit, entry, nt, c, tile, sub, tb, w);
        break;
      case 2:
        launch<2>(sub == 1, grid, smem, st, origin, dirs, active, cmin, cmax,
                  t_hi, hit, entry, nt, c, tile, sub, tb, w);
        break;
      case 3:
        launch<3>(sub == 1, grid, smem, st, origin, dirs, active, cmin, cmax,
                  t_hi, hit, entry, nt, c, tile, sub, tb, w);
        break;
      default:
        launch<4>(sub == 1, grid, smem, st, origin, dirs, active, cmin, cmax,
                  t_hi, hit, entry, nt, c, tile, sub, tb, w);
        break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
