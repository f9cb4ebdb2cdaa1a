// ray_mask: exact per-ray slab test of every ray against every cluster
// box, OR-reduced over each 128-ray tile, with the least slab entry.
//
// Replaces the TPU kernels _ray_mask_kernel (raytracer_tpu/ops/
// cluster_trace.py:305-352) and _ray_mask_kernel_hier (:242-302), both
// called by _ray_cluster_mask_tpu (:355).
//
// Design: one block of 128 threads per tile.  The tile's precomputed ray
// bundle [o*inv (3), t_hi, inv (3)] goes to shared memory ray-major, two
// float4 a ray ([o*inv, t_hi] and [inv, 0]), for C > 64 ordered by the
// octant of the ray's direction (the signs of inv; a ballot per octant
// and warp gives each ray its place): a thread reads a ray with two
// broadcast 128-bit loads and tests it against every box column it holds
// in registers.  The order of a tile's rays cannot change a result (an OR
// and a min).  Only the C real columns are evaluated (the TPU's _BIG
// padding boxes are not); the per-launch instance:
//   C > 128:      each thread holds 2 columns (C = 249: 128 x 2), in
//                 passes of 256 columns;
//   64 < C <= 128: 1 column a thread;
//   C <= 64:      the 128 rays are split over 2 (C <= 64) or 4 (C <= 32,
//                 the supercluster pass) groups of threads, each holding
//                 one column and testing its share of the rays; the
//                 partial (hit, entry) merge by OR and min in shared
//                 memory, exact in any order (a hit's entry is never NaN,
//                 and a float min is exact).  These stage the rays in
//                 order and take the min/max form below: on 32 or 64 rays
//                 a thread, sorting made them no faster.
// Every ray is tested, inactive ones (t_hi -inf) too: an overflowing
// product can make an entry -inf, so skipping them is not provably exact.
// Each (tile, column) is written by one thread: no atomics,
// deterministic.  A tile without an active ray writes 0 / +inf without
// reading its bundle.
//
// Near and far planes per octant: per axis the TPU takes t1 = inv*lo -
// o*inv, t2 = inv*hi - o*inv, near = min(t1, t2), far = max(t1, t2), both
// NaN-propagating.  For a box with lo <= hi, rounding is monotone, so t1
// <= t2 when inv > 0 and t1 >= t2 when inv < 0 (a zero inv of either sign,
// taken as >= 0, gives t1 == t2 up to the sign of a zero): the octant
// names near and far without a min or max, the same values.  When t1 or t2 is NaN the TPU's near and
// far are both NaN, so the entry or the exit is, and the pair misses; the
// chosen near or far is that NaN too, so it misses as well.  A column
// with lo > hi on some axis (no cluster box has one) takes the min/max
// form.  So each pair costs 4 NaN-propagating min/max instead of 10.
//
// What bounds it: instruction issue and the latency of each pair's chain
// of dependent operations.  About 22 instructions per (ray, box) pair: 6
// multiplies and 6 subtracts rounded one by one (-fmad=false), 4
// NaN-propagating min/max of one instruction each, 3 compares and the
// predicated OR and min of the result; the shared loads are 2 per ray,
// shared by a thread's columns.  The sorted loop runs 4 rays deep, so a
// thread has 8 independent pairs in flight (on an H100, 4 rays deep was
// 1.3x faster than 2 at the full-width terrain's busiest call; 8 deep
// gained nothing).
//
// Hierarchical form (scenes above 512 cluster columns): the columns are
// cut into S 128-cluster chunks, chunk j of tile i gated by the coarse bit
// sup[i*S + j] (the same slab test against the dilated union of the
// chunk's boxes, run before by the flat kernel): a chunk whose bit is 0,
// or any chunk of a tile without an active ray, is written 0 / +inf; the
// others take the flat kernel's routine.  Coarse miss implies fine miss
// (the slab chain is monotone in the box coordinates and the union is
// dilated), so the result equals the flat kernel's bit for bit.
//
// What bounds it: the spread of the live chunks, then instruction issue.
// A few tiles (shadow segments across the terrain) cross many
// superclusters, the rest a few: at the big terrain's busiest call 4.7
// live chunks per active tile on average and 16 at most.  One block per
// tile walking its chunks in turn left the launch as long as its busiest
// tile while the other SMs idled.  So a block takes one group of at most
// g chunks of one tile (a 2-D grid: tile, group), g chosen per launch
// (hier_group): the most, up to RT_HIER_GROUP_MAX, that still gives every
// SM RT_HIER_BLOCKS_PER_SM blocks, so a tile's live chunks run on many
// SMs at once and the hardware hands the blocks out as SMs free up.  The
// block writes its dead chunks first, a warp a chunk, as int4 / float4
// stores when the rows are 16-byte aligned (c % 4 == 0); a block without a
// live chunk stages nothing and is done.  Otherwise it stages the tile's
// rays once (octant-sorted) and takes its live chunks in turn, thread t
// testing column 128 * j + t with the flat kernel's routine.  The hit bit
// rides on the entry (NaN until a ray hits): 23 instructions a pair, the
// ray loads included.  Only the C real columns of the last chunk are
// written (the TPU pads them with _BIG boxes), each (tile, column) by one
// thread.  On an H100 (PERF.md): 2 or 4 box columns a thread, with the
// rays split over the warps and merged, or more chunks a block, were no
// faster; 4 chunks a block wrote the dead chunks near the memory rate.

#include <algorithm>
#include <cstdint>

#include "common.cuh"

// hier_group aims at this many blocks a SM, with at most RT_HIER_GROUP_MAX
// chunks a block
#define RT_HIER_BLOCKS_PER_SM 32
#define RT_HIER_GROUP_MAX 4
static_assert(RT_HIER_GROUP_MAX <= 32, "a block's chunks are bits of one ballot");

namespace {

constexpr int kWarps = RT_TILE / 32;

// The tile's staged rays: st[2p] = (o*inv, t_hi) and st[2p + 1] = (inv, 0)
// of the ray at place p; the rays of octant o (bit a: inv's axis a < 0)
// at places [start[o], start[o + 1]).
struct Staged {
  float4 st[2 * RT_TILE];
  int start[9];
  int count[kWarps][8];  // rays of each octant in each warp
};

// Stage tile i's ray bundle (blocks of RT_TILE threads), ordered by octant
// when SORT, else in ray order.
template <bool SORT>
__device__ __forceinline__ void stage_bundle(Staged& s, const float* bundle,
                                             int i, int r) {
  const int j = threadIdx.x, w = j >> 5, lane = j & 31;
  const float* b = bundle + i * RT_TILE + j;
  const float4 o = make_float4(b[0], b[r], b[2 * r], b[3 * r]);
  const float4 v = make_float4(b[4 * r], b[5 * r], b[6 * r], 0.0f);
  if (!SORT) {
    s.st[2 * j] = o;
    s.st[2 * j + 1] = v;
    __syncthreads();
    return;
  }
  const int oct = (v.x < 0.0f ? 1 : 0) | (v.y < 0.0f ? 2 : 0) | (v.z < 0.0f ? 4 : 0);
  unsigned same = 0u;  // the lanes of this warp in this ray's octant
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const unsigned m = __ballot_sync(RT_FULL_MASK, oct == k);
    if (lane == 0) s.count[w][k] = __popc(m);
    if (oct == k) same = m;
  }
  __syncthreads();
  // place: the rays of lower octants, of lower warps in this octant, then
  // of lower lanes
  int p = __popc(same & ((1u << lane) - 1u));
  for (int k = 0; k <= oct; ++k) {
    for (int w2 = 0; w2 < kWarps; ++w2) p += (k < oct || w2 < w) ? s.count[w2][k] : 0;
  }
  s.st[2 * p] = o;
  s.st[2 * p + 1] = v;
  if (j <= 8) {
    int n = 0;
    for (int k = 0; k < j; ++k) {
      for (int w2 = 0; w2 < kWarps; ++w2) n += s.count[w2][k];
    }
    s.start[j] = n;
  }
  __syncthreads();
}

// ANY: a hit sets *any.  Without ANY, *emin starts NaN and stays NaN
// until a ray hits (fminf drops a NaN operand; a hit's entry is never
// NaN), so the hit bit is !isnan(*emin): an instruction a pair fewer.
template <bool ANY>
__device__ __forceinline__ void slab_hit(float entry, float exit_, float thi,
                                         bool* any, float* emin) {
  if ((entry <= exit_) && (exit_ >= 0.0f) && (entry <= thi)) {
    if (ANY) *any = true;
    *emin = fminf(*emin, entry);  // entry is not NaN here
  }
}

// Slab test of the staged rays at places [j0, j1) against the boxes of
// columns cc[0..NB) (a column >= c takes a NaN box: no hit): ORs the hits
// into any[n] (see slab_hit for !ANY) and takes the least entry over the
// hitting rays into emin[n].  j0, j1 are uniform over the warp.  SORTED:
// the rays are staged by octant, and regular columns take the near and
// far planes.
template <int NB, bool SORTED, bool ANY = true>
__device__ __forceinline__ void slab_columns(const Staged& s, int j0, int j1,
                                             const float* __restrict__ box,
                                             int c, const int* cc, bool* any,
                                             float* emin) {
  float lo[3][NB], hi[3][NB];
  bool regular = true;  // lo <= hi (or NaN) on every axis of every column
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const bool real = cc[n] < c;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a][n] = real ? box[a * c + cc[n]] : CUDART_NAN_F;
      hi[a][n] = real ? box[(4 + a) * c + cc[n]] : CUDART_NAN_F;
      regular = regular && !(lo[a][n] > hi[a][n]);
    }
  }
  if (!SORTED || !regular) {
#pragma unroll 2
    for (int j = j0; j < j1; ++j) {
      const float4 o = s.st[2 * j], v = s.st[2 * j + 1];  // o*inv, t_hi; inv
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        float t1 = v.x * lo[0][n] - o.x, t2 = v.x * hi[0][n] - o.x;
        const float nx = nan_min(t1, t2), fx = nan_max(t1, t2);
        t1 = v.y * lo[1][n] - o.y;
        t2 = v.y * hi[1][n] - o.y;
        const float ny = nan_min(t1, t2), fy = nan_max(t1, t2);
        t1 = v.z * lo[2][n] - o.z;
        t2 = v.z * hi[2][n] - o.z;
        const float nz = nan_min(t1, t2), fz = nan_max(t1, t2);
        slab_hit<ANY>(nan_max(nx, nan_max(ny, nz)), nan_min(fx, nan_min(fy, fz)),
                      o.w, &any[n], &emin[n]);
      }
    }
    return;
  }
#pragma unroll 1
  for (int k = 0; k < 8; ++k) {
    const int a = max(j0, s.start[k]), e = min(j1, s.start[k + 1]);
    float nc[3][NB], fc[3][NB];  // the near and far plane of each axis
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        const bool neg = (k >> ax) & 1;
        nc[ax][n] = neg ? hi[ax][n] : lo[ax][n];
        fc[ax][n] = neg ? lo[ax][n] : hi[ax][n];
      }
    }
#pragma unroll 4
    for (int j = a; j < e; ++j) {
      const float4 o = s.st[2 * j], v = s.st[2 * j + 1];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const float nx = v.x * nc[0][n] - o.x, fx = v.x * fc[0][n] - o.x;
        const float ny = v.y * nc[1][n] - o.y, fy = v.y * fc[1][n] - o.y;
        const float nz = v.z * nc[2][n] - o.z, fz = v.z * fc[2][n] - o.z;
        slab_hit<ANY>(nan_max(nx, nan_max(ny, nz)), nan_min(fx, nan_min(fy, fz)),
                      o.w, &any[n], &emin[n]);
      }
    }
  }
}

__device__ __forceinline__ void write_column(int c, int cc, int i, bool any,
                                             float emin, int* __restrict__ hit,
                                             float* __restrict__ ent) {
  hit[static_cast<size_t>(i) * c + cc] = any ? 1 : 0;
  ent[static_cast<size_t>(i) * c + cc] = emin;
}

__device__ __forceinline__ void miss_columns(int c, int c0, int c1, int i,
                                             int* __restrict__ hit,
                                             float* __restrict__ ent) {
  for (int cc = c0 + threadIdx.x; cc < c1; cc += blockDim.x) {
    write_column(c, cc, i, false, CUDART_INF_F, hit, ent);
  }
}

// S groups of 128 / S threads split the rays (S > 1 needs C <= 128 / S);
// each thread holds NB columns.
template <int S, int NB>
__global__ void __launch_bounds__(RT_TILE) ray_mask_kernel(
    const int* __restrict__ act, const float* __restrict__ box,
    const float* __restrict__ bundle, int* __restrict__ hit,
    float* __restrict__ ent, int c, int r) {
  constexpr int W = RT_TILE / S;  // columns a pass, per column held
  __shared__ Staged st;
  const int i = blockIdx.x;
  if (act[i] == 0) {
    miss_columns(c, 0, c, i, hit, ent);
    return;
  }
  stage_bundle<S == 1>(st, bundle, i, r);
  const int t = threadIdx.x % W, part = threadIdx.x / W;
  for (int c0 = 0; c0 < c; c0 += W * NB) {
    int cc[NB];
    bool any[NB];
    float emin[NB];
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      cc[n] = c0 + t + n * W;
      any[n] = false;
      emin[n] = CUDART_INF_F;
    }
    slab_columns<NB, S == 1>(st, part * W, (part + 1) * W, box, c, cc, any, emin);
    if constexpr (S == 1) {
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        if (cc[n] < c) write_column(c, cc[n], i, any[n], emin[n], hit, ent);
      }
    } else {
      static_assert(NB == 1, "split rays: one column a thread, one pass");
      __shared__ int p_hit[RT_TILE];
      __shared__ float p_ent[RT_TILE];
      p_hit[threadIdx.x] = any[0];
      p_ent[threadIdx.x] = emin[0];
      __syncthreads();
      if (part == 0 && cc[0] < c) {
        bool h = false;
        float e = CUDART_INF_F;
#pragma unroll
        for (int p = 0; p < S; ++p) {
          h = h || p_hit[t + p * W] != 0;
          e = fminf(e, p_ent[t + p * W]);  // +inf where no ray of p hits
        }
        write_column(c, cc[0], i, h, e, hit, ent);
      }
    }
  }
}

// Columns [c0, c1) of tile i written 0 / +inf by one warp: one int4 and
// one float4 a lane when VEC (c % 4 == 0 and 16-byte aligned outputs, so
// c0 and c1 are multiples of 4), else one column a lane.
__device__ __forceinline__ void miss_chunk(int c, int c0, int c1, int i,
                                           bool vec, int* __restrict__ hit,
                                           float* __restrict__ ent) {
  const int lane = threadIdx.x & 31;
  const size_t row = static_cast<size_t>(i) * c;
  if (vec) {
    int4* h = reinterpret_cast<int4*>(hit + row);
    float4* e = reinterpret_cast<float4*>(ent + row);
    const float inf = CUDART_INF_F;
    for (int q = c0 / 4 + lane; q < c1 / 4; q += 32) {
      h[q] = make_int4(0, 0, 0, 0);
      e[q] = make_float4(inf, inf, inf, inf);
    }
  } else {
    for (int cc = c0 + lane; cc < c1; cc += 32) {
      write_column(c, cc, i, false, CUDART_INF_F, hit, ent);
    }
  }
}

// Block (i, y): chunks [y*g, y*g + g) of tile i (see the note above).
// Each live chunk is one round of the block: thread t tests column
// 128 * j + t against the tile's 128 rays.  The bound of at least 1 block
// a SM changes only how ptxas schedules the slab loop: on an H100 it ran
// 0.0756 ms at the big terrain's busiest call against 0.0818 ms with the
// bare bound (PERF.md).
__global__ void __launch_bounds__(RT_TILE, 1) ray_mask_hier_kernel(
    const int* __restrict__ act, const int* __restrict__ sup,
    const float* __restrict__ box, const float* __restrict__ bundle,
    int* __restrict__ hit, float* __restrict__ ent, int c, int r, int g,
    bool vec) {
  __shared__ Staged st;
  const int s = (c + RT_CLUSTER - 1) / RT_CLUSTER;
  const int i = blockIdx.x, j0 = blockIdx.y * g, n = min(g, s - j0);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // bit k: chunk j0 + k is live (the same in every warp)
  const bool on = act[i] != 0;
  const unsigned live = __ballot_sync(
      RT_FULL_MASK,
      on && lane < n && sup[static_cast<size_t>(i) * s + j0 + lane] != 0);
  for (int k = w; k < n; k += kWarps) {
    if (!((live >> k) & 1u)) {
      const int c0 = (j0 + k) * RT_CLUSTER;
      miss_chunk(c, c0, min(c, c0 + RT_CLUSTER), i, vec, hit, ent);
    }
  }
  if (live == 0u) return;  // uniform over the block
  stage_bundle<true>(st, bundle, i, r);
  for (unsigned m = live; m != 0u; m &= m - 1u) {
    const int c0 = (j0 + __ffs(m) - 1) * RT_CLUSTER + 32 * w;  // this warp's
    if (c0 >= c) continue;  // past the last chunk's real columns
    const int cc = c0 + lane;  // < the chunk's end iff < c
    bool unused;
    float emin = CUDART_NAN_F;  // NaN until a ray hits (slab_hit<false>)
    slab_columns<1, true, false>(st, 0, RT_TILE, box, c, &cc, &unused, &emin);
    if (cc < c) {
      const bool h = !isnan(emin);
      write_column(c, cc, i, h, h ? emin : CUDART_INF_F, hit, ent);
    }
  }
}

// Chunks a block of a hierarchical launch over nt tiles of s chunks: the
// most (up to RT_HIER_GROUP_MAX) that still gives RT_HIER_BLOCKS_PER_SM
// blocks a SM, or a whole tile's when nt alone gives that many.
int hier_group(int nt, int s) {
  const long want = static_cast<long>(RT_HIER_BLOCKS_PER_SM) * sm_count();
  const long per_tile = std::min<long>(s, std::max<long>(1, (want + nt - 1) / nt));
  const int g = static_cast<int>((s + per_tile - 1) / per_tile);
  return std::max(1, std::min(g, RT_HIER_GROUP_MAX));
}

}  // namespace

extern "C" int rt_ray_mask(const int* act, const float* box,
                           const float* bundle, int* hit, float* ent, int nt,
                           int c, int r, void* stream) {
  if (nt > 0 && c > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (c <= RT_TILE / 4) {
      ray_mask_kernel<4, 1><<<nt, RT_TILE, 0, s>>>(act, box, bundle, hit, ent, c, r);
    } else if (c <= RT_TILE / 2) {
      ray_mask_kernel<2, 1><<<nt, RT_TILE, 0, s>>>(act, box, bundle, hit, ent, c, r);
    } else if (c <= RT_TILE) {
      ray_mask_kernel<1, 1><<<nt, RT_TILE, 0, s>>>(act, box, bundle, hit, ent, c, r);
    } else {
      ray_mask_kernel<1, 2><<<nt, RT_TILE, 0, s>>>(act, box, bundle, hit, ent, c, r);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_ray_mask_hier(const int* act, const int* sup,
                                const float* box, const float* bundle,
                                int* hit, float* ent, int nt, int c, int r,
                                void* stream) {
  if (nt > 0 && c > 0) {
    const int s = (c + RT_CLUSTER - 1) / RT_CLUSTER, g = hier_group(nt, s);
    const bool vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(hit) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(ent) % 16 == 0;
    const dim3 grid(nt, (s + g - 1) / g);
    ray_mask_hier_kernel<<<grid, RT_TILE, 0, static_cast<cudaStream_t>(stream)>>>(
        act, sup, box, bundle, hit, ent, c, r, g, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// Chunks a block of a hierarchical launch over nt tiles of c columns (the
// group hier_group picks); a number, not an error code.
extern "C" int rt_ray_mask_hier_group(int nt, int c) {
  return hier_group(nt, (c + RT_CLUSTER - 1) / RT_CLUSTER);
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
