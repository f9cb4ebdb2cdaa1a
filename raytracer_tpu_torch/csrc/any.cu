// any: generic segment any-hit of every ray over its tile's cluster
// shortlists: some triangle or sphere hit with t < t_max on the ray
// origin + t * dir.
//
// Replaces the TPU kernel _any_kernel (raytracer_tpu/ops/
// cluster_trace.py:837-913, called by _cluster_any_call, :1604).  It
// serves the shadow waves of scenes whose per-light shadow plane tables
// pass the 8 MB budget (cluster_any), where each segment carries its own
// t_max (1 for a shadow segment origin -> light).
//
// Design: one block of 128 threads per tile, one thread per ray, as in
// closest.cu.  For each visited cluster the block stages the 12x128
// triangle rows (or 4x128 sphere rows) in shared memory; every thread
// runs the closest kernel's Wald test (or sphere quadratic) against all
// 128 lanes and ORs ok && t < t_max into its flag.  Visit order does not
// matter to an OR, so a walk stops once every ray of the tile is found: a
// block-wide vote before each visit (__syncthreads_count, also the
// barrier that frees the staged rows), as the TPU's while-loop condition
// does.  Sphere clusters: every one, ascending, when the scene has at most
// 8 (gated on the tile having a sphere candidate), else the shortlist
// walk.  Every lane of a listed tile is tested, inactive ones too, as on
// the TPU.  Padding slots give t = 0/0 = NaN (triangles) or radius 0
// (spheres): every comparison fails, so no lane mask is needed.
//
// What bounds it: floating-point operations, about 41 per (ray, triangle)
// pair of a visited cluster (as closest.cu's per-ray-origin test, with
// t < t_max and the OR in place of the winner update), one IEEE rounding
// each (-fmad=false).  This first version aims at correctness, not speed.

#include "common.cuh"

namespace {

template <bool BFC, bool RELAXED>
__global__ void __launch_bounds__(RT_TILE) any_kernel(
    const int* __restrict__ tw, const int* __restrict__ tl,
    const int* __restrict__ tc, const int* __restrict__ sw,
    const int* __restrict__ sl, const int* __restrict__ sc,
    const float* __restrict__ origin, const float* __restrict__ dirs,
    const float* __restrict__ t_max, const float* __restrict__ tri_dat,
    const float* __restrict__ sph_dat, int* __restrict__ found, int ct,
    int cs, int pt, int ps, int wt, int ws) {
  __shared__ float rows[12][RT_CLUSTER];
  const int i = blockIdx.x;
  const int j = threadIdx.x;
  const int ray = i * RT_TILE + j;
  if (tc[i] == 0 && sc[i] == 0) {
    found[ray] = 0;
    return;
  }
  const float ox = origin[3 * ray + 0];
  const float oy = origin[3 * ray + 1];
  const float oz = origin[3 * ray + 2];
  const float dx = dirs[3 * ray + 0];
  const float dy = dirs[3 * ray + 1];
  const float dz = dirs[3 * ray + 2];
  const float tmax = t_max[ray];
  bool fnd = false;

  auto tri_body = [&](int k) {
    // early exit once every ray of the tile is found
    if (__syncthreads_count(fnd) == RT_TILE) return false;
    for (int r = 0; r < 12; ++r) rows[r][j] = tri_dat[r * pt + k * RT_CLUSTER + j];
    __syncthreads();
    for (int l = 0; l < RT_CLUSTER && !fnd; ++l) {
      float t;
      fnd = tri_hit<BFC>(rows, l, dot_rows(ox, oy, oz, rows, 0, l),
                         dot_rows(ox, oy, oz, rows, 3, l),
                         dot_rows(ox, oy, oz, rows, 6, l), dx, dy, dz, &t) &&
            (t < tmax);
    }
    return true;
  };

  const float a_q = dx * dx + dy * dy + dz * dz;
  auto sph_body = [&](int k) {
    if (__syncthreads_count(fnd) == RT_TILE) return false;
    for (int r = 0; r < 4; ++r) rows[r][j] = sph_dat[r * ps + k * RT_CLUSTER + j];
    __syncthreads();
    for (int l = 0; l < RT_CLUSTER && !fnd; ++l) {
      // the ray's own t_max, also in the relaxed form (u = 2a t_max + b)
      fnd = sph_occluded<RELAXED>(ox, oy, oz, dx, dy, dz, a_q, rows[0][l],
                                  rows[1][l], rows[2][l], rows[3][l], tmax);
    }
    return true;
  };

  if (tc[i] != 0) {
    visit_clusters(i, tw, tl, tc, ct, RT_MAX_TRI_LIST, wt, tri_body);
  }
  if (sc[i] != 0) {
    if (cs <= RT_DENSE_SPH_ROWS) {
      for (int k = 0; k < cs && sph_body(k); ++k) {
      }
    } else {
      visit_clusters(i, sw, sl, sc, cs, RT_MAX_SPH_LIST, ws, sph_body);
    }
  }
  found[ray] = fnd ? 1 : 0;
}

template <bool BFC, bool RELAXED>
void launch(const int* tw, const int* tl, const int* tc, const int* sw,
            const int* sl, const int* sc, const float* origin,
            const float* dirs, const float* t_max, const float* tri_dat,
            const float* sph_dat, int* found, int nt, int ct, int cs, int pt,
            int ps, int wt, int ws, cudaStream_t stream) {
  any_kernel<BFC, RELAXED><<<nt, RT_TILE, 0, stream>>>(
      tw, tl, tc, sw, sl, sc, origin, dirs, t_max, tri_dat, sph_dat, found,
      ct, cs, pt, ps, wt, ws);
}

}  // namespace

extern "C" int rt_any(const int* tw, const int* tl, const int* tc,
                      const int* sw, const int* sl, const int* sc,
                      const float* origin, const float* dirs,
                      const float* t_max, const float* tri_dat,
                      const float* sph_dat, int* found, int nt, int ct,
                      int cs, int pt, int ps, int wt, int ws, int bfc,
                      int relaxed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nt > 0) {
    if (bfc) {
      if (relaxed) launch<true, true>(tw, tl, tc, sw, sl, sc, origin, dirs, t_max, tri_dat, sph_dat, found, nt, ct, cs, pt, ps, wt, ws, s);
      else launch<true, false>(tw, tl, tc, sw, sl, sc, origin, dirs, t_max, tri_dat, sph_dat, found, nt, ct, cs, pt, ps, wt, ws, s);
    } else {
      if (relaxed) launch<false, true>(tw, tl, tc, sw, sl, sc, origin, dirs, t_max, tri_dat, sph_dat, found, nt, ct, cs, pt, ps, wt, ws, s);
      else launch<false, false>(tw, tl, tc, sw, sl, sc, origin, dirs, t_max, tri_dat, sph_dat, found, nt, ct, cs, pt, ps, wt, ws, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
