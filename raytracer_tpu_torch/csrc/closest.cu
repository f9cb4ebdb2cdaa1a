// closest: nearest triangle/sphere hit of every ray over its tile's
// cluster shortlists.
//
// Replaces the TPU kernel _closest_kernel (raytracer_tpu/ops/
// cluster_trace.py:720-834) in both call shapes: shared origin (eye rays,
// _cluster_closest_call_shared, :1546) and per-ray origin (secondary
// rays, _cluster_closest_call, :1487).
//
// Design: one block of 128 threads per 128-ray tile, one thread per ray.
// For each visited cluster the block stages the cluster's 12x128
// triangle rows (or 4x128 sphere rows) in shared memory, then every
// thread tests its ray against all 128 lanes; the reads are broadcasts.
// Visit order is the engine's: triangle clusters then sphere clusters,
// each from the front-to-back list (or the ascending bitmask scan when
// the list overflowed), all sphere clusters ascending when the scene has
// at most 8.  The winner is the lexicographic minimum of (t, lane, visit):
// what the TPU's lanewise accumulator and first-lane argmin produce.  With
// a shared origin the origin's per-triangle dot products are computed
// once per lane while staging (the values the per-pair form would give).
//
// What bounds it: floating-point operations, about 40 per (ray, triangle)
// pair of a visited cluster, one IEEE rounding each (-fmad=false, no FMA
// contraction, IEEE divide).  This first version aims at correctness, not
// speed: no FMA, one block per tile, synchronous staging.

#include "common.cuh"

namespace {

template <bool SHARED, bool BFC>
__global__ void __launch_bounds__(RT_TILE) closest_kernel(
    const int* __restrict__ tw, const int* __restrict__ tl,
    const int* __restrict__ tc, const int* __restrict__ sw,
    const int* __restrict__ sl, const int* __restrict__ sc,
    const float* __restrict__ origin, const float* __restrict__ dirs,
    const float* __restrict__ tri_dat, const float* __restrict__ sph_dat,
    float* __restrict__ t_out, int* __restrict__ slot_out,
    int ct, int cs, int pt, int ps, int wt, int ws) {
  __shared__ float rows[12][RT_CLUSTER];
  __shared__ float orow[3][RT_CLUSTER];  // shared origin: n.o, w1.o, w2.o
  const int i = blockIdx.x;
  const int j = threadIdx.x;
  const int ray = i * RT_TILE + j;
  if (tc[i] == 0 && sc[i] == 0) {
    t_out[ray] = CUDART_INF_F;
    slot_out[ray] = -1;
    return;
  }
  const float ox = SHARED ? origin[0] : origin[3 * ray + 0];
  const float oy = SHARED ? origin[1] : origin[3 * ray + 1];
  const float oz = SHARED ? origin[2] : origin[3 * ray + 2];
  const float dx = dirs[3 * ray + 0];
  const float dy = dirs[3 * ray + 1];
  const float dz = dirs[3 * ray + 2];
  float bt = CUDART_INF_F;
  int bj = RT_CLUSTER;
  int bk = 0;

  auto consider = [&](float t, bool ok, int lane, int kb) {
    const float tt = ok ? t : CUDART_INF_F;
    if (tt < bt || (tt == bt && lane < bj)) {
      bt = tt;
      bj = lane;
      bk = kb;
    }
  };

  auto tri_body = [&](int k) {
    __syncthreads();  // the previous visit's readers are done
    for (int r = 0; r < 12; ++r) rows[r][j] = tri_dat[r * pt + k * RT_CLUSTER + j];
    if (SHARED) {
      for (int r = 0; r < 3; ++r) orow[r][j] = dot_rows(ox, oy, oz, rows, 3 * r, j);
    }
    __syncthreads();
    for (int l = 0; l < RT_CLUSTER; ++l) {
      float t;
      const bool ok = tri_hit<BFC>(
          rows, l, SHARED ? orow[0][l] : dot_rows(ox, oy, oz, rows, 0, l),
          SHARED ? orow[1][l] : dot_rows(ox, oy, oz, rows, 3, l),
          SHARED ? orow[2][l] : dot_rows(ox, oy, oz, rows, 6, l), dx, dy, dz,
          &t);
      consider(t, ok, l, k);
    }
    return true;
  };

  const float a_q = dx * dx + dy * dy + dz * dz;
  auto sph_body = [&](int k) {
    __syncthreads();
    for (int r = 0; r < 4; ++r) rows[r][j] = sph_dat[r * ps + k * RT_CLUSTER + j];
    __syncthreads();
    for (int l = 0; l < RT_CLUSTER; ++l) {
      const float rad = rows[3][l];
      const SphTerms s = sph_terms(ox, oy, oz, dx, dy, dz, a_q, rows[0][l],
                                   rows[1][l], rows[2][l], rad);
      float t1;
      const bool ok = sph_root(s, a_q, rad, &t1);
      consider(t1, ok, l, ct + k);
    }
    return true;
  };

  visit_clusters(i, tw, tl, tc, ct, RT_MAX_TRI_LIST, wt, tri_body);
  if (cs <= RT_DENSE_SPH_ROWS) {
    if (sc[i] != 0) {
      for (int k = 0; k < cs; ++k) sph_body(k);
    }
  } else {
    visit_clusters(i, sw, sl, sc, cs, RT_MAX_SPH_LIST, ws, sph_body);
  }
  const int slot = bk >= ct ? pt + (bk - ct) * RT_CLUSTER + bj
                            : bk * RT_CLUSTER + bj;
  t_out[ray] = bt;
  slot_out[ray] = bt < CUDART_INF_F ? slot : -1;
}

template <bool SHARED, bool BFC>
void launch(const int* tw, const int* tl, const int* tc, const int* sw,
            const int* sl, const int* sc, const float* origin,
            const float* dirs, const float* tri_dat, const float* sph_dat,
            float* t, int* slot, int nt, int ct, int cs, int pt, int ps,
            int wt, int ws, cudaStream_t stream) {
  closest_kernel<SHARED, BFC><<<nt, RT_TILE, 0, stream>>>(
      tw, tl, tc, sw, sl, sc, origin, dirs, tri_dat, sph_dat, t, slot, ct,
      cs, pt, ps, wt, ws);
}

}  // namespace

extern "C" int rt_closest(const int* tw, const int* tl, const int* tc,
                          const int* sw, const int* sl, const int* sc,
                          const float* origin, const float* dirs,
                          const float* tri_dat, const float* sph_dat,
                          float* t, int* slot, int nt, int ct, int cs, int pt,
                          int ps, int wt, int ws, int shared_origin, int bfc,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nt > 0) {
    if (shared_origin) {
      if (bfc) launch<true, true>(tw, tl, tc, sw, sl, sc, origin, dirs, tri_dat, sph_dat, t, slot, nt, ct, cs, pt, ps, wt, ws, s);
      else launch<true, false>(tw, tl, tc, sw, sl, sc, origin, dirs, tri_dat, sph_dat, t, slot, nt, ct, cs, pt, ps, wt, ws, s);
    } else {
      if (bfc) launch<false, true>(tw, tl, tc, sw, sl, sc, origin, dirs, tri_dat, sph_dat, t, slot, nt, ct, cs, pt, ps, wt, ws, s);
      else launch<false, false>(tw, tl, tc, sw, sl, sc, origin, dirs, tri_dat, sph_dat, t, slot, nt, ct, cs, pt, ps, wt, ws, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
