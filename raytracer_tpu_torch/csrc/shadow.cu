// shadow: any-hit of the segments origin -> point light, for every light
// in one launch, as a bitfield (bit l: occluded toward light l).
//
// Replaces the TPU kernels _shadow_kernel (raytracer_tpu/ops/
// cluster_trace.py:982-1080, one light) and _shadow_kernel_ml (:1135-1275,
// all lights).  The multi-light kernel's results are bitwise those of the
// single-light kernel per light (its docstring, :1138-1144), so this one
// kernel serves both with n_lights = 1 or more.
//
// Design: one block of 128 threads per tile, one thread per ray.  Per
// light, the triangle candidates are staged 16x128 plane rows at a time
// in shared memory and each thread evaluates the four planes at its
// origin, in the TPU's order ox*r0 + (oy*r1 + (oz*r2 + r3)).  The TPU
// keeps a running max per (ray, lane) that propagates NaN, and a lane is
// occluding iff that max is >= 0; here each thread keeps two 128-bit lane
// masks (some visit >= 0, some visit NaN), which is the same test.
// Spheres: with at most 8 sphere clusters, one dense pass over all of
// them for every light, run when any light has sphere candidates; else a
// per-light walk that stops once all 128 rays of the tile are occluded
// (a block-wide vote; the skipped visits cannot change a bit).
//
// What bounds it: floating-point operations, about 28 per (ray, triangle)
// pair (4 planes x 6 ops + 3 NaN-propagating mins + 2 compares), rounded
// op for op (-fmad=false).  This first version aims at correctness, not
// speed.

#include "common.cuh"

namespace {

template <bool RELAXED>
__global__ void __launch_bounds__(RT_TILE) shadow_kernel(
    const int* __restrict__ tw, const int* __restrict__ tl,
    const int* __restrict__ tc, const int* __restrict__ sw,
    const int* __restrict__ sl, const int* __restrict__ sc,
    const float* __restrict__ lps, const float* __restrict__ origin,
    const float* __restrict__ planes, const float* __restrict__ sph_dat,
    int* __restrict__ found, int nt, int nl, int ct, int cs, int pt, int ps,
    int wt, int ws) {
  __shared__ float rows[16][RT_CLUSTER];
  const int i = blockIdx.x;
  const int j = threadIdx.x;
  const int ray = i * RT_TILE + j;
  bool empty = true;
  for (int l = 0; l < nl; ++l) {
    empty = empty && tc[l * nt + i] == 0 && sc[l * nt + i] == 0;
  }
  if (empty) {
    found[ray] = 0;
    return;
  }
  const float ox = origin[3 * ray + 0];
  const float oy = origin[3 * ray + 1];
  const float oz = origin[3 * ray + 2];
  unsigned fnd = 0;

  for (int l = 0; l < nl; ++l) {
    const float* pln = planes + static_cast<size_t>(l) * 16 * pt;
    unsigned nonneg[4] = {0u, 0u, 0u, 0u};
    unsigned poison[4] = {0u, 0u, 0u, 0u};
    auto tri_body = [&](int k) {
      __syncthreads();
      for (int r = 0; r < 16; ++r) rows[r][j] = pln[r * pt + k * RT_CLUSTER + j];
      __syncthreads();
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        unsigned nn = 0u, pp = 0u;
        for (int b = 0; b < 32; ++b) {
          const int q = w * 32 + b;
          const float u0 = ox * rows[0][q] + (oy * rows[1][q] + (oz * rows[2][q] + rows[3][q]));
          const float v1 = ox * rows[4][q] + (oy * rows[5][q] + (oz * rows[6][q] + rows[7][q]));
          const float v2 = ox * rows[8][q] + (oy * rows[9][q] + (oz * rows[10][q] + rows[11][q]));
          const float v3 = ox * rows[12][q] + (oy * rows[13][q] + (oz * rows[14][q] + rows[15][q]));
          const float m = nan_min(nan_min(u0, v1), nan_min(v2, v3));
          nn |= static_cast<unsigned>(m >= 0.0f) << b;
          pp |= static_cast<unsigned>(m != m) << b;
        }
        nonneg[w] |= nn;
        poison[w] |= pp;
      }
      return true;
    };
    visit_clusters(i, tw + l * nt * wt, tl + l * nt * RT_MAX_TRI_LIST,
                   tc + l * nt, ct, RT_MAX_TRI_LIST, wt, tri_body);
    const unsigned occ = (nonneg[0] & ~poison[0]) | (nonneg[1] & ~poison[1]) |
                         (nonneg[2] & ~poison[2]) | (nonneg[3] & ~poison[3]);
    if (occ != 0u) fnd |= 1u << l;

    if (cs > RT_DENSE_SPH_ROWS && sc[l * nt + i] != 0) {
      const float dx = lps[3 * l + 0] - ox;
      const float dy = lps[3 * l + 1] - oy;
      const float dz = lps[3 * l + 2] - oz;
      const float a_q = dx * dx + dy * dy + dz * dz;
      const unsigned bit = 1u << l;
      auto sph_body = [&](int k) {
        // early exit once every ray of the tile is occluded toward l
        if (__syncthreads_count((fnd & bit) != 0u) == RT_TILE) return false;
        for (int r = 0; r < 4; ++r) rows[r][j] = sph_dat[r * ps + k * RT_CLUSTER + j];
        __syncthreads();
        bool any = false;
        for (int q = 0; q < RT_CLUSTER; ++q) {
          any = any || sph_occluded<RELAXED>(ox, oy, oz, dx, dy, dz, a_q,
                                             rows[0][q], rows[1][q],
                                             rows[2][q], rows[3][q], 1.0f);
        }
        if (any) fnd |= bit;
        return true;
      };
      visit_clusters(i, sw + l * nt * ws, sl + l * nt * RT_MAX_SPH_LIST,
                     sc + l * nt, cs, RT_MAX_SPH_LIST, ws, sph_body);
      __syncthreads();  // rows are reused by the next light's triangles
    }
  }

  if (cs <= RT_DENSE_SPH_ROWS) {
    bool any_sc = false;
    for (int l = 0; l < nl; ++l) any_sc = any_sc || sc[l * nt + i] != 0;
    if (any_sc) {
      for (int k = 0; k < cs; ++k) {
        __syncthreads();
        for (int r = 0; r < 4; ++r) rows[r][j] = sph_dat[r * ps + k * RT_CLUSTER + j];
        __syncthreads();
        for (int l = 0; l < nl; ++l) {
          const float dx = lps[3 * l + 0] - ox;
          const float dy = lps[3 * l + 1] - oy;
          const float dz = lps[3 * l + 2] - oz;
          const float a_q = dx * dx + dy * dy + dz * dz;
          bool any = false;
          for (int q = 0; q < RT_CLUSTER; ++q) {
            any = any || sph_occluded<RELAXED>(ox, oy, oz, dx, dy, dz, a_q,
                                               rows[0][q], rows[1][q],
                                               rows[2][q], rows[3][q], 1.0f);
          }
          if (any) fnd |= 1u << l;
        }
      }
    }
  }
  found[ray] = static_cast<int>(fnd);
}

}  // namespace

extern "C" int rt_shadow(const int* tw, const int* tl, const int* tc,
                         const int* sw, const int* sl, const int* sc,
                         const float* lps, const float* origin,
                         const float* planes, const float* sph_dat,
                         int* found, int nt, int nl, int ct, int cs, int pt,
                         int ps, int wt, int ws, int relaxed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nt > 0) {
    if (relaxed) {
      shadow_kernel<true><<<nt, RT_TILE, 0, s>>>(tw, tl, tc, sw, sl, sc, lps, origin, planes, sph_dat, found, nt, nl, ct, cs, pt, ps, wt, ws);
    } else {
      shadow_kernel<false><<<nt, RT_TILE, 0, s>>>(tw, tl, tc, sw, sl, sc, lps, origin, planes, sph_dat, found, nt, nl, ct, cs, pt, ps, wt, ws);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
