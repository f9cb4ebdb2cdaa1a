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
// Design: the closest kernel's walk (common.cuh, warp_walk): one block of
// G warps per 128-ray tile (4, or 16 for launches of few tiles per SM, as
// in closest.cu), each warp testing all 128 rays,
// 4 per thread, against its items (a chunk of RT_CHUNK lanes of a visit),
// which it stages lane-major and double-buffered with cp.async.  The test
// is the closest kernel's Wald test (or sphere quadratic, in the RELAXED
// form when asked); each ray ORs ok && t < t_max into its flag.  An OR
// needs no merge and no visit order, so the tile's found rays are a
// 128-bit mask in shared memory that every warp ORs its flags into
// (atomicOr) after each item and reads before the next: a warp stops once
// all 128 rays are found and skips an item once its own 128 flags are
// set.  Within an item the four rays of a thread are tested in straight
// lines, found ones too (their flag cannot change): a branch per ray cost
// more than the tests it skipped (PERF.md, PR 3).  Sphere clusters: every
// one, ascending, when the scene has at most 8 (gated on the tile having
// a sphere candidate), else the shortlist walk.  Every lane of a listed
// tile is tested, inactive ones too, as on the TPU.  Padding slots give
// t = 0/0 = NaN (triangles) or radius 0 (spheres): every comparison
// fails, so no lane mask is needed.
//
// What bounds it: instruction issue, as closest.cu's per-ray-origin test
// (about 54 instructions per (ray, triangle) pair, with t < t_max and the
// OR in place of the winner update), over the pairs up to each ray's
// first hit.

#include "common.cuh"

namespace {

constexpr int kRays = RT_RAYS_PER_THREAD;
constexpr int kStage = RT_CHUNK * RT_TRI_STRIDE;  // floats per buffer

template <int G>
constexpr int smem_bytes() {
  return G * 2 * kStage * 4;
}

template <bool BFC, bool RELAXED, int G>
__global__ void __launch_bounds__(G * 32) any_kernel(
    const int* __restrict__ tw, const int* __restrict__ tl,
    const int* __restrict__ tc, const int* __restrict__ sw,
    const int* __restrict__ sl, const int* __restrict__ sc,
    const float* __restrict__ origin, const float* __restrict__ dirs,
    const float* __restrict__ t_max, const float* __restrict__ tri_dat,
    const float* __restrict__ sph_dat, int* __restrict__ found, int ct,
    int cs, int pt, int ps, int wt, int ws) {
  extern __shared__ float4 smem4[];
  __shared__ unsigned tile_found[kRays];  // bit lane of word q: ray lane + 32 q
  float* smem = reinterpret_cast<float*>(smem4);
  const int i = blockIdx.x;
  if (tc[i] == 0 && sc[i] == 0) {
    for (int j = threadIdx.x; j < RT_TILE; j += blockDim.x) found[i * RT_TILE + j] = 0;
    return;
  }
  if (threadIdx.x < kRays) tile_found[threadIdx.x] = 0u;
  __syncthreads();
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int l0 = (w % RT_LANE_SPLIT) * RT_CHUNK;  // this warp's lanes
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float a_q[kRays], tmax[kRays];
  bool fnd[kRays];
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const int ray = i * RT_TILE + lane + 32 * q;
    ox[q] = origin[3 * ray + 0];
    oy[q] = origin[3 * ray + 1];
    oz[q] = origin[3 * ray + 2];
    dx[q] = dirs[3 * ray + 0];
    dy[q] = dirs[3 * ray + 1];
    dz[q] = dirs[3 * ray + 2];
    a_q[q] = dx[q] * dx[q] + dy[q] * dy[q] + dz[q] * dz[q];
    tmax[q] = t_max[i * RT_TILE + lane + 32 * q];
    fnd[q] = false;
  }

  // take the rays other warps have found; true when the whole tile is
  // (lane 0's reading, so the decision is uniform over the warp)
  auto all_found = [&]() {
    unsigned all = RT_FULL_MASK;
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      const unsigned m = *static_cast<volatile unsigned*>(&tile_found[q]);
      fnd[q] = fnd[q] || ((m >> lane) & 1u);
      all &= m;
    }
    return __shfl_sync(RT_FULL_MASK, all == RT_FULL_MASK, 0) != 0;
  };

  auto stage = [&](float* dst, int k) {
    if (k < ct) stage_tri(dst, tri_dat, pt, k, l0, lane);
    else stage_sph(dst, sph_dat, ps, k - ct, l0, lane);
  };

  auto body = [&](float* buf, int k, int) {
    // skip the item when each of the warp's 128 rays is found; else test
    // all four rays of a thread (found ones too: the OR cannot change,
    // and straight-line code keeps the four tests interleaved)
    bool live = false;
#pragma unroll
    for (int q = 0; q < kRays; ++q) live = live || !fnd[q];
    if (!__any_sync(RT_FULL_MASK, live)) return;
    const float4* rows = reinterpret_cast<const float4*>(buf);
    if (k < ct) {
#pragma unroll 2
      for (int l = 0; l < RT_CHUNK; ++l) {
        const float4 a = rows[3 * l], b = rows[3 * l + 1], c = rows[3 * l + 2];
#pragma unroll
        for (int q = 0; q < kRays; ++q) {
          float t;
          const bool ok = tri_hit_ray<BFC>(a, b, c, ox[q], oy[q], oz[q], dx[q],
                                           dy[q], dz[q], &t);
          fnd[q] = fnd[q] || (ok && t < tmax[q]);
        }
      }
    } else {
#pragma unroll 2
      for (int l = 0; l < RT_CHUNK; ++l) {
        const float4 s = rows[l];
#pragma unroll
        for (int q = 0; q < kRays; ++q) {
          // the ray's own t_max, also in the relaxed form (u = 2a t_max + b)
          fnd[q] = fnd[q] || sph_occluded<RELAXED>(
              ox[q], oy[q], oz[q], dx[q], dy[q], dz[q], a_q[q], s.x, s.y, s.z,
              s.w, tmax[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      const unsigned m = __ballot_sync(RT_FULL_MASK, fnd[q]);
      if (lane == 0 && m != 0u) atomicOr(&tile_found[q], m);
    }
  };

  WarpVisits seq = tile_visits<G>(i, w, tw, tl, tc, sw, sl, sc, ct, cs, wt, ws);
  warp_walk(seq, smem + w * 2 * kStage, kStage, stage, body, all_found);
  __syncthreads();
  for (int j = threadIdx.x; j < RT_TILE; j += blockDim.x) {
    found[i * RT_TILE + j] = (tile_found[j >> 5] >> (j & 31)) & 1u;
  }
}

}  // namespace

extern "C" int rt_any(const int* tw, const int* tl, const int* tc,
                      const int* sw, const int* sl, const int* sc,
                      const float* origin, const float* dirs,
                      const float* t_max, const float* tri_dat,
                      const float* sph_dat, int* found, int nt, int ct,
                      int cs, int pt, int ps, int wt, int ws, int bfc,
                      int relaxed, void* stream) {
  if (nt <= 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t e = dispatch(wide_launch(nt), bfc, relaxed,
                                 [&](auto g, auto bf, auto rx) {
    constexpr int G = decltype(g)::value;
    auto kernel = any_kernel<decltype(bf)::value, decltype(rx)::value, G>;
    static const cudaError_t a = allow_smem(kernel, smem_bytes<G>());
    if (a != cudaSuccess) return a;
    kernel<<<nt, G * 32, smem_bytes<G>(), static_cast<cudaStream_t>(stream)>>>(
        tw, tl, tc, sw, sl, sc, origin, dirs, t_max, tri_dat, sph_dat, found,
        ct, cs, pt, ps, wt, ws);
    return cudaGetLastError();
  });
  return static_cast<int>(e);
}
