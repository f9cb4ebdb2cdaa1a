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
// cut into 128-cluster chunks, chunk j of tile i gated by the coarse bit
// sup[i*S + j] (the same slab test against the dilated union of the
// chunk's boxes, run before by the flat kernel).  The bit is uniform over
// the block, so the branch does not diverge; a chunk whose bit is 0 is
// written 0 / +inf.  Thread t tests column 128*j + t of chunk j with the
// flat kernel's routine, and only the C real columns of the last chunk
// are written (the TPU pads them with _BIG boxes).  Coarse miss implies
// fine miss (the slab chain is monotone in the box coordinates and the
// union is dilated), so the result equals the flat kernel's bit for bit.

#include "common.cuh"

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

__device__ __forceinline__ void slab_hit(float entry, float exit_, float thi,
                                         bool* any, float* emin) {
  if ((entry <= exit_) && (exit_ >= 0.0f) && (entry <= thi)) {
    *any = true;
    *emin = fminf(*emin, entry);  // entry is not NaN here
  }
}

// Slab test of the staged rays at places [j0, j1) against the boxes of
// columns cc[0..NB) (a column >= c takes a NaN box: no hit): ORs the hits
// into any[n] and takes the least entry over the hitting rays into
// emin[n].  j0, j1 are uniform over the warp.  SORTED: the rays are
// staged by octant, and regular columns take the near and far planes.
template <int NB, bool SORTED>
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
        slab_hit(nan_max(nx, nan_max(ny, nz)), nan_min(fx, nan_min(fy, fz)), o.w,
                 &any[n], &emin[n]);
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
        slab_hit(nan_max(nx, nan_max(ny, nz)), nan_min(fx, nan_min(fy, fz)), o.w,
                 &any[n], &emin[n]);
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

__global__ void __launch_bounds__(RT_TILE) ray_mask_hier_kernel(
    const int* __restrict__ act, const int* __restrict__ sup,
    const float* __restrict__ box, const float* __restrict__ bundle,
    int* __restrict__ hit, float* __restrict__ ent, int c, int r) {
  __shared__ Staged st;
  const int i = blockIdx.x;
  if (act[i] == 0) {
    miss_columns(c, 0, c, i, hit, ent);
    return;
  }
  stage_bundle<true>(st, bundle, i, r);
  const int n_chunks = (c + RT_CLUSTER - 1) / RT_CLUSTER;
  for (int j = 0; j < n_chunks; ++j) {
    const int c0 = j * RT_CLUSTER;
    const int c1 = min(c, c0 + RT_CLUSTER);
    if (sup[static_cast<size_t>(i) * n_chunks + j] == 0) {
      miss_columns(c, c0, c1, i, hit, ent);
    } else {
      const int cc = c0 + threadIdx.x;  // < c1 iff < c
      bool any = false;
      float emin = CUDART_INF_F;
      slab_columns<1, true>(st, 0, RT_TILE, box, c, &cc, &any, &emin);
      if (cc < c) write_column(c, cc, i, any, emin, hit, ent);
    }
  }
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
    ray_mask_hier_kernel<<<nt, RT_TILE, 0, static_cast<cudaStream_t>(stream)>>>(
        act, sup, box, bundle, hit, ent, c, r);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
