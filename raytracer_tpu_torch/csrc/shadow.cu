// shadow: any-hit of the segments origin -> point light, for every light
// in one launch, as a bitfield (bit l: occluded toward light l).
//
// Replaces the TPU kernels _shadow_kernel (raytracer_tpu/ops/
// cluster_trace.py:982-1080, one light) and _shadow_kernel_ml (:1135-1275,
// all lights).  The multi-light kernel's results are bitwise those of the
// single-light kernel per light (its docstring, :1138-1144), so this one
// kernel serves both with n_lights = 1 or more.
//
// Design (common.cuh, warp_walk): one block of G warps per 128-ray tile
// (4, or 16 for launches of a few tiles per SM, as in closest.cu), every
// warp covering all 128 rays, 4 per thread.  Per light, the tile's
// triangle visits are cut into items (visit, 32-lane chunk) shared out
// over the warps: warp w tests chunk w % 4 of every (G / 4)-th visit.  A
// warp stages its items itself with cp.async, double-buffered, so no
// visit needs a block barrier; a lane's 16 plane values are staged
// lane-major (stage_planes) and read with 4 broadcast 128-bit loads that
// serve the thread's 4 rays (16 scalar loads a pair before).  Each thread evaluates the four planes at its
// origins in the TPU's order ox*r0 + (oy*r1 + (oz*r2 + r3)).
//
// The TPU keeps a running max per (ray, lane) that propagates NaN, and a
// lane occludes iff that max is >= 0: a lane that is >= 0 in one visit and
// NaN in another does not.  Two walks keep that rule:
//   fast: each thread keeps, per ray, the NaN-propagating max over all its
//     pairs (one instruction a pair).  A ray that meets no NaN is
//     occluded iff some pair is >= 0, whichever warp saw it: the warps OR
//     max >= 0 into the ray's bit.  A NaN anywhere in the tile sets a
//     flag, read after the light's one block barrier;
//   exact (the flag set: a plane value overflowed, or the table holds
//     NaN): the walk again, each thread keeping two 32-bit masks per ray
//     over its chunk's lanes (some visit >= 0, some visit NaN).  Every
//     warp ORs both into shared memory per (ray, lane) (in 16-warp blocks
//     four warps share a chunk), and only after a second barrier is
//     nonneg & ~poison folded into the ray's bit.
// The triangle walk has no early exit: a later visit can clear a lane.
//
// Spheres: a live-ray walk.  The result is defined as act & occluded
// (act: the rays hit & relevant toward each light, every ray without one),
// so a ray needs the sphere test only while it is active and not yet
// occluded.  Per light whose tile has sphere candidates (with at most 8
// sphere clusters: every cluster, when any light has candidates; else
// the light's list or bitmask), after a block barrier the tile's rays are
// staged once in shared memory ((o, a_q), (light - o)), and the live rays
// act & ~occ are snapshotted (the count of shadow.live).  The sphere
// clusters are cut into items (cluster, 32-lane chunk) as above, staged
// by cp.async; in an item each thread owns ONE sphere lane and loops over
// the warp's live rays (act & ~occ as the item starts, uniform over the
// warp), two rays an iteration (two independent chains in flight),
// reading each ray's staged segment as a broadcast; a ray's result over
// the 32 lanes is one vote, ORed into occ by lane 0.  An
// item costs the live count, not 128; a warp stops once no ray is live,
// and a light with no live ray walks nothing.  An OR cannot change once
// set, so no order of warps or items changes a bit.
//
// The replaced design tested all 128 rays of every item, 4 a thread,
// skipping a ray only when every lane of the warp had it occluded: rays
// whose bit no caller reads (misses, surfaces facing away) and rays
// already occluded cost as much as live ones.
//
// What bounds it: instruction issue.  29 instructions per (ray, triangle)
// pair in the fast walk's SASS: 24 float operations of the planes rounded
// one by one (-fmad=false), 3 NaN-propagating mins, the running max and
// one 128-bit shared load; the exact walk's masks make it 33.5.  Per live
// (ray, sphere) pair: the sphere test's float operations, two broadcast
// 128-bit shared loads of the ray, the vote and the bit loop.

#include "common.cuh"

namespace {

constexpr int kRays = RT_RAYS_PER_THREAD;
constexpr int kStage = RT_CHUNK * RT_PLANE_STRIDE;  // floats per buffer
constexpr int kMaxLights = 32;                      // bits of the result

template <int G>
constexpr int smem_bytes() {
  return G * 2 * kStage * 4;
}

// G last: the profiler's kernel names start shadow_kernel<RELAXED, ...
template <bool RELAXED, int G>
__global__ void __launch_bounds__(G * 32) shadow_kernel(
    const int* __restrict__ tw, const int* __restrict__ tl,
    const int* __restrict__ tc, const int* __restrict__ sw,
    const int* __restrict__ sl, const int* __restrict__ sc,
    const float* __restrict__ lps, const float* __restrict__ origin,
    const float* __restrict__ planes, const float* __restrict__ sph_dat,
    const unsigned char* __restrict__ act, int* __restrict__ found,
    unsigned long long* __restrict__ tally, int nt, int nl, int ct, int cs,
    int pt, int ps, int wt, int ws, int act_sl, int act_sr) {
  extern __shared__ float4 smem4[];
  // the exact walk's lanes of one light over its visits, [some visit >=
  // 0, some visit NaN][chunk][ray]: bit b of a word is lane 32 * chunk + b
  __shared__ unsigned lane_masks[2][RT_LANE_SPLIT][RT_TILE];
  // bit lane of occ[l][q]: ray lane + 32 q is occluded toward light l
  __shared__ unsigned occ[kMaxLights][kRays];
  // bit lane of act_w[l][q]: ray lane + 32 q is active toward light l
  __shared__ unsigned act_w[kMaxLights][kRays];
  // the sphere walk's rays toward its light: (o, a_q) and (light - o, 0)
  __shared__ float4 seg[2 * RT_TILE];
  // the rays live (active, not occluded) as the light's sphere walk starts
  __shared__ unsigned live0[kRays];
  // nonzero: some ray of the tile meets a NaN plane value toward light l
  __shared__ int poisoned[kMaxLights];
  float* smem = reinterpret_cast<float*>(smem4);
  const int i = blockIdx.x;
  bool empty = true;
  for (int l = 0; l < nl; ++l) {
    empty = empty && tc[l * nt + i] == 0 && sc[l * nt + i] == 0;
  }
  if (empty) {
    for (int j = threadIdx.x; j < RT_TILE; j += blockDim.x) found[i * RT_TILE + j] = 0;
    return;
  }
  for (int e = threadIdx.x; e < 2 * RT_LANE_SPLIT * RT_TILE; e += blockDim.x) {
    (&lane_masks[0][0][0])[e] = 0u;
  }
  for (int e = threadIdx.x; e < kMaxLights * kRays; e += blockDim.x) (&occ[0][0])[e] = 0u;
  for (int e = threadIdx.x; e < kMaxLights; e += blockDim.x) poisoned[e] = 0;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int p = w; p < nl * kRays; p += G) {  // uniform over the warp
    const int l = p / kRays, q = p % kRays;
    const size_t at = static_cast<size_t>(l) * act_sl +
                      static_cast<size_t>(i * RT_TILE + 32 * q + lane) * act_sr;
    const unsigned m = __ballot_sync(RT_FULL_MASK, act == nullptr || act[at] != 0);
    if (lane == 0) act_w[l][q] = m;
  }
  __syncthreads();
  const int h = w % RT_LANE_SPLIT;  // this warp's chunk
  const int l0 = h * RT_CHUNK;
  float* buf = smem + w * 2 * kStage;
  float ox[kRays], oy[kRays], oz[kRays];
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const int ray = i * RT_TILE + lane + 32 * q;
    ox[q] = origin[3 * ray + 0];
    oy[q] = origin[3 * ray + 1];
    oz[q] = origin[3 * ray + 2];
  }
  const VisitSide none{nullptr, nullptr, 0, 0, 0};
  auto visits = [&](VisitSide tri, VisitSide sph) {
    return WarpVisits(tri, sph, w / RT_LANE_SPLIT, G / RT_LANE_SPLIT);
  };
  // with at most 8 sphere clusters, every light walks them all when any
  // light has a sphere candidate in the tile
  bool any_sc = false;
  for (int l = 0; l < nl; ++l) any_sc = any_sc || sc[l * nt + i] != 0;

  for (int l = 0; l < nl; ++l) {
    const int s = l * nt + i;
    const int n_t = tc[s];
    if (n_t != 0) {  // uniform over the block, as the barriers below need
      const float* pln = planes + static_cast<size_t>(l) * 16 * pt;
      // this warp's items of light l's triangle visits; pair(q, bit, m)
      // takes the min-plane value m of ray q and the lane of bit `bit`
      auto tri_walk = [&](auto pair) {
        WarpVisits seq = visits(
            VisitSide{tl + s * RT_MAX_TRI_LIST, tw + static_cast<size_t>(s) * wt,
                      n_t <= RT_MAX_TRI_LIST ? n_t : -1, ct, 0},
            none);
        auto body = [&](float* sb, int, int) {
          const float4* rows = reinterpret_cast<const float4*>(sb);
#pragma unroll 1
          for (int g = 0; g < RT_CHUNK; g += 8) {
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int ln = g + u;
              const float4* r = rows + ln * (RT_PLANE_STRIDE / 4);
              const int x = plane_swizzle(u);  // == plane_swizzle(ln): 8 | g
              const float4 p0 = r[0 ^ x], p1 = r[1 ^ x], p2 = r[2 ^ x], p3 = r[3 ^ x];
              const unsigned bit = 1u << ln;
#pragma unroll
              for (int q = 0; q < kRays; ++q) {
                const float u0 = ox[q] * p0.x + (oy[q] * p0.y + (oz[q] * p0.z + p0.w));
                const float v1 = ox[q] * p1.x + (oy[q] * p1.y + (oz[q] * p1.z + p1.w));
                const float v2 = ox[q] * p2.x + (oy[q] * p2.y + (oz[q] * p2.z + p2.w));
                const float v3 = ox[q] * p3.x + (oy[q] * p3.y + (oz[q] * p3.z + p3.w));
                pair(q, bit, nan_min(nan_min(u0, v1), nan_min(v2, v3)));
              }
            }
          }
        };
        warp_walk(seq, buf, kStage,
                  [&](float* dst, int k) { stage_planes(dst, pln, pt, k, l0, lane); },
                  body, [] { return false; });
      };

      // fast walk: per ray, the NaN-propagating max over all its pairs.
      // Without a NaN the ray is occluded iff that max is >= 0, which is
      // the TPU's rule, whatever warp saw which lane
      float mx[kRays];
#pragma unroll
      for (int q = 0; q < kRays; ++q) mx[q] = -CUDART_INF_F;
      tri_walk([&](int q, unsigned, float m) { mx[q] = nan_max(mx[q], m); });
      bool nan = false;
#pragma unroll
      for (int q = 0; q < kRays; ++q) {
        nan = nan || mx[q] != mx[q];
        const unsigned m = __ballot_sync(RT_FULL_MASK, mx[q] >= 0.0f);
        if (lane == 0 && m != 0u) atomicOr(&occ[l][q], m);
      }
      if (__any_sync(RT_FULL_MASK, nan) && lane == 0) atomicOr(&poisoned[l], 1);
      __syncthreads();

      if (poisoned[l] != 0) {
        // some ray meets a NaN: the exact walk, lane by lane.  Each warp
        // ORs its (ray, lane) masks into shared memory (in 16-warp blocks
        // four warps share a chunk) and, after a barrier, nonneg & ~poison
        // is folded over every warp's visits
        if (threadIdx.x < kRays) occ[l][threadIdx.x] = 0u;
        unsigned nonneg[kRays], poison[kRays];
#pragma unroll
        for (int q = 0; q < kRays; ++q) nonneg[q] = poison[q] = 0u;
        tri_walk([&](int q, unsigned bit, float m) {
          if (m >= 0.0f) nonneg[q] |= bit;
          if (m != m) poison[q] |= bit;
        });
#pragma unroll
        for (int q = 0; q < kRays; ++q) {
          if (nonneg[q] != 0u) atomicOr(&lane_masks[0][h][lane + 32 * q], nonneg[q]);
          if (poison[q] != 0u) atomicOr(&lane_masks[1][h][lane + 32 * q], poison[q]);
        }
        __syncthreads();
        // the masks are cleared for the next light, which writes them
        // only after its own fast walk's barrier
        for (int j = threadIdx.x; j < RT_TILE; j += blockDim.x) {
          unsigned o = 0u;
#pragma unroll
          for (int c = 0; c < RT_LANE_SPLIT; ++c) {
            o |= lane_masks[0][c][j] & ~lane_masks[1][c][j];
            lane_masks[0][c][j] = 0u;
            lane_masks[1][c][j] = 0u;
          }
          if (o != 0u) atomicOr(&occ[l][j >> 5], 1u << (j & 31));
        }
      }
    }

    if (cs > RT_DENSE_SPH_ROWS ? sc[s] != 0 : any_sc) {  // uniform
      // every warp is past light l - 1's sphere walk (seg, live0 free) and
      // light l's triangle bits are final
      __syncthreads();
      for (int j = threadIdx.x; j < RT_TILE; j += blockDim.x) {
        const int ray = i * RT_TILE + j;
        const float x = origin[3 * ray + 0], y = origin[3 * ray + 1],
                    z = origin[3 * ray + 2];
        const float dx = lps[3 * l + 0] - x, dy = lps[3 * l + 1] - y,
                    dz = lps[3 * l + 2] - z;
        seg[2 * j] = make_float4(x, y, z, dx * dx + dy * dy + dz * dz);
        seg[2 * j + 1] = make_float4(dx, dy, dz, 0.0f);
      }
      if (threadIdx.x < kRays) {
        live0[threadIdx.x] = act_w[l][threadIdx.x] & ~occ[l][threadIdx.x];
      }
      __syncthreads();
      unsigned start[kRays];
      int n_live = 0;
#pragma unroll
      for (int q = 0; q < kRays; ++q) {
        start[q] = live0[q];
        n_live += __popc(start[q]);
      }
      if (tally != nullptr && threadIdx.x == 0) {
        atomicAdd(tally, static_cast<unsigned long long>(RT_TILE));
        atomicAdd(tally + 1, static_cast<unsigned long long>(n_live));
      }
      if (n_live != 0) {
        const int n_s = sc[s];
        WarpVisits seq = visits(
            none, cs <= RT_DENSE_SPH_ROWS
                      ? VisitSide{nullptr, nullptr, cs, cs, 0}
                      : VisitSide{sl + s * RT_MAX_SPH_LIST,
                                  sw + static_cast<size_t>(s) * ws,
                                  n_s <= RT_MAX_SPH_LIST ? n_s : -1, cs, 0});
        // this warp's live rays toward l as an item starts (lane 0's
        // reading of occ, so uniform over the warp); stop when none is
        unsigned live[kRays];
        auto stop = [&] {
          unsigned any = 0u;
#pragma unroll
          for (int q = 0; q < kRays; ++q) {
            const unsigned o = *static_cast<volatile unsigned*>(&occ[l][q]);
            live[q] = start[q] & ~__shfl_sync(RT_FULL_MASK, o, 0);
            any |= live[q];
          }
          return any == 0u;
        };
        // one sphere lane a thread over the live rays, a vote a ray
        auto body = [&](float* sb, int, int) {
          const float4 sp = reinterpret_cast<const float4*>(sb)[lane];
#pragma unroll
          for (int q = 0; q < kRays; ++q) {
            unsigned m = live[q], hit = 0u;
            while (m != 0u) {
              // two rays an iteration (the second is the first again when
              // one is left): two independent chains in flight
              const int b0 = __ffs(m) - 1;
              m &= m - 1u;
              const int b1 = m != 0u ? __ffs(m) - 1 : b0;
              m &= m - 1u;
              const float4 o0 = seg[2 * (32 * q + b0)];
              const float4 d0 = seg[2 * (32 * q + b0) + 1];
              const float4 o1 = seg[2 * (32 * q + b1)];
              const float4 d1 = seg[2 * (32 * q + b1) + 1];
              const bool h0 = sph_occluded<RELAXED>(o0.x, o0.y, o0.z, d0.x, d0.y,
                                                    d0.z, o0.w, sp.x, sp.y, sp.z,
                                                    sp.w, 1.0f);
              const bool h1 = sph_occluded<RELAXED>(o1.x, o1.y, o1.z, d1.x, d1.y,
                                                    d1.z, o1.w, sp.x, sp.y, sp.z,
                                                    sp.w, 1.0f);
              if (__any_sync(RT_FULL_MASK, h0)) hit |= 1u << b0;
              if (__any_sync(RT_FULL_MASK, h1)) hit |= 1u << b1;
            }
            if (lane == 0 && hit != 0u) atomicOr(&occ[l][q], hit);
          }
        };
        warp_walk(seq, buf, kStage,
                  [&](float* dst, int k) { stage_sph(dst, sph_dat, ps, k, l0, lane); },
                  body, stop);
      }
    }
  }

  __syncthreads();
  for (int j = threadIdx.x; j < RT_TILE; j += blockDim.x) {
    int f = 0;
    for (int l = 0; l < nl; ++l) {
      const unsigned m = occ[l][j >> 5] & act_w[l][j >> 5];
      f |= static_cast<int>((m >> (j & 31)) & 1u) << l;
    }
    found[i * RT_TILE + j] = f;
  }
}

}  // namespace

extern "C" int rt_shadow(const int* tw, const int* tl, const int* tc,
                         const int* sw, const int* sl, const int* sc,
                         const float* lps, const float* origin,
                         const float* planes, const float* sph_dat,
                         const unsigned char* act, int* found,
                         unsigned long long* tally, int nt, int nl, int ct,
                         int cs, int pt, int ps, int wt, int ws, int act_sl,
                         int act_sr, int relaxed, void* stream) {
  if (nt <= 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t e = dispatch(wide_launch(nt), relaxed, false,
                                 [&](auto g, auto rx, auto) {
    constexpr int G = decltype(g)::value;
    auto kernel = shadow_kernel<decltype(rx)::value, G>;
    static const cudaError_t a = allow_smem(kernel, smem_bytes<G>());
    if (a != cudaSuccess) return a;
    kernel<<<nt, G * 32, smem_bytes<G>(), static_cast<cudaStream_t>(stream)>>>(
        tw, tl, tc, sw, sl, sc, lps, origin, planes, sph_dat, act, found,
        tally, nt, nl, ct, cs, pt, ps, wt, ws, act_sl, act_sr);
    return cudaGetLastError();
  });
  return static_cast<int>(e);
}
