// Shared constants and helpers of the cluster-engine kernels.
//
// Every kernel is built with -fmad=false and without fast math (see
// backend.py): each float operation rounds as in PyTorch's eager
// elementwise ops, so a kernel equals its plain PyTorch version in
// ops/kernels.py bit for bit.  Float literals carry the f suffix: a
// double literal would promote the expression to double.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#define RT_TILE 128         // rays per tile = threads per block
#define RT_CLUSTER 128      // primitive slots per cluster
#define RT_MAX_TRI_LIST 48  // list capacity before the bitmask fallback
#define RT_MAX_SPH_LIST 8
#define RT_DENSE_SPH_ROWS 8 // <= this many sphere clusters: visit all

// min/max that propagate NaN like torch.minimum / jnp.minimum (CUDA's
// fminf/fmaxf return the other operand): empty clusters have NaN boxes
// and padding triangles give NaN t, and every test relies on NaN failing
// every comparison.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

// Visit the candidate clusters of tile i in the engine's order: the
// front-to-back id list when its count fits max_list, else every cluster
// whose bit is set, ascending.  The lists are per tile, so the walk is
// uniform across the block and `body` may synchronise.  `body` returns
// false to stop the walk (the any-hit kernels' early exit; the decision
// must be uniform over the block), true to go on.
template <class Body>
__device__ __forceinline__ void visit_clusters(
    int i, const int* words, const int* ids, const int* counts,
    int n_clusters, int max_list, int wpt, Body body) {
  const int n = counts[i];
  if (n <= max_list) {
    for (int k = 0; k < n; ++k) {
      if (!body(ids[i * max_list + k])) return;
    }
  } else {
    for (int k = 0; k < n_clusters; ++k) {
      if (((words[i * wpt + (k >> 5)] >> (k & 31)) & 1) && !body(k)) return;
    }
  }
}

// Sphere quadratic terms of one (ray, sphere) pair, in the operation
// order of the Pallas kernels (raytracer_tpu/ops/cluster_trace.py:546-568).
struct SphTerms {
  float b_q, c_q, disc;
};

__device__ __forceinline__ SphTerms sph_terms(
    float ox, float oy, float oz, float dx, float dy, float dz, float a_q,
    float cx, float cy, float cz, float rad) {
  const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
  SphTerms s;
  s.b_q = 2.0f * (dx * ocx + dy * ocy + dz * ocz);
  s.c_q = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  s.disc = s.b_q * s.b_q - 4.0f * a_q * s.c_q;
  return s;
}

// Smaller root even when negative (the reference's quirk); t2 < 0 is the
// sign test (sq - b) < 0, the divide by 2a > 0 kept out.
__device__ __forceinline__ bool sph_root(const SphTerms& s, float a_q,
                                         float rad, float* t1) {
  const float sq = sqrtf(nan_max(s.disc, 0.0f));
  *t1 = (-s.b_q - sq) / (2.0f * a_q);
  return (s.disc >= 0.0f) && !((*t1 < 0.0f) && ((sq - s.b_q) < 0.0f)) &&
         (rad > 0.0f);
}

// Sphere hit with t < tmax on the ray o + t d (tmax 1: the segment
// o -> o + d).  RELAXED: the sqrt/div-free sign tests of --relaxed-parity,
// t2 >= 0 <=> b <= 0 or c <= 0 and t1 < tmax <=> u > 0 or disc > u^2 with
// u = 2a tmax + b (cluster_trace.py:621-644).
template <bool RELAXED>
__device__ __forceinline__ bool sph_occluded(float ox, float oy, float oz,
                                             float dx, float dy, float dz,
                                             float a_q, float cx, float cy,
                                             float cz, float rad, float tmax) {
  const SphTerms s = sph_terms(ox, oy, oz, dx, dy, dz, a_q, cx, cy, cz, rad);
  if (RELAXED) {
    const float u = 2.0f * a_q * tmax + s.b_q;
    return (rad > 0.0f) && (s.disc >= 0.0f) &&
           ((s.b_q <= 0.0f) || (s.c_q <= 0.0f)) &&
           ((u > 0.0f) || (s.disc > u * u));
  }
  float t1;
  return sph_root(s, a_q, rad, &t1) && (t1 < tmax);
}

// o . (rows[r], rows[r+1], rows[r+2]) of triangle lane l.
__device__ __forceinline__ float dot_rows(float ox, float oy, float oz,
                                          float (*rows)[RT_CLUSTER], int r,
                                          int l) {
  return ox * rows[r][l] + oy * rows[r + 1][l] + oz * rows[r + 2][l];
}

// Wald test of the ray against staged triangle lane l, in the operation
// order of _tri_cluster_test (cluster_trace.py:520-543); the origin dots
// n.o, w1.o, w2.o come from the caller (per ray, or per lane for a shared
// origin).  All-zero padding rows give t = 0/0 = NaN: every comparison
// fails.  BFC culls triangles facing away from the ray.
template <bool BFC>
__device__ __forceinline__ bool tri_hit(float (*rows)[RT_CLUSTER], int l,
                                        float no, float w1o, float w2o,
                                        float dx, float dy, float dz,
                                        float* t_out) {
  const float nd = dx * rows[0][l] + dy * rows[1][l] + dz * rows[2][l];
  const float t = (rows[9][l] - no) / nd;
  const float beta = w1o + t * (dx * rows[3][l] + dy * rows[4][l] + dz * rows[5][l]) - rows[10][l];
  const float gamma = w2o + t * (dx * rows[6][l] + dy * rows[7][l] + dz * rows[8][l]) - rows[11][l];
  const float alpha = 1.0f - beta - gamma;
  bool ok = (alpha >= 0.0f) && (beta >= 0.0f) && (gamma >= 0.0f) &&
            (t >= 0.0f);
  if (BFC) ok = ok && (nd < 0.0f);
  *t_out = t;
  return ok;
}
