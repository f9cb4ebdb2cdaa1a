// closest: nearest triangle/sphere hit of every ray over its tile's
// cluster shortlists.
//
// Replaces the TPU kernel _closest_kernel (raytracer_tpu/ops/
// cluster_trace.py:720-834) in both call shapes: shared origin (eye rays,
// _cluster_closest_call_shared, :1546) and per-ray origin (secondary
// rays, _cluster_closest_call, :1487).
//
// Visit order is the engine's: triangle clusters then sphere clusters,
// each from the front-to-back list (or the ascending bitmask scan when
// the list overflowed), all sphere clusters ascending when the scene has
// at most 8.  The winner is the lexicographic minimum of (t, lane, visit
// position): what the TPU's lanewise accumulator and first-lane argmin
// produce.
//
// Design (common.cuh, warp_walk): one block of G warps per 128-ray tile,
// each warp covering all 128 rays, 4 per thread in registers.  The tile's
// work is cut into items (visit position, chunk of RT_CHUNK = 32 lanes):
// warp w tests chunk w % 4 of every (G / 4)-th visit.  G is 4 for
// launches of many tiles (whole frames: short walks, and each warp gets a
// quarter of every visit) and 16 for launches of a few tiles per SM (the
// big scenes' ray chunks: long walks, split across four warp groups too).
// A warp
// stages its items itself with cp.async, lane-major (a triangle lane is
// three float4, a sphere lane one) and double-buffered, so a lane's rows
// are read with three broadcast 128-bit loads that serve 4 pairs, and no
// item needs a block barrier.  Per item a thread keeps each ray's first
// lane of least t, then folds it into the ray's running (t, lane << 24 |
// position) key; at the end the warps' partial winners merge through
// shared memory on the same key: the lexicographic minimum does not
// depend on the order, so the merge equals the sequential walk.  With a
// shared origin the staging warp computes each lane's n.a - n.o, w1.o and
// w2.o once (the values the per-pair form gives).
//
// What bounds it: instruction issue.  About 54 instructions per (ray,
// triangle) pair with a per-ray origin (45 float operations rounded one
// by one under -fmad=false, the IEEE divide's sequence, the compares and
// the winner update), about 40 with a shared origin; an SM issues four
// warp instructions per clock, so a kernel that rounds op for op tops out
// at half the 67 TFLOP/s FMA peak (33.5 T operations/s).

#include "common.cuh"

namespace {

constexpr int kRays = RT_RAYS_PER_THREAD;

// floats of one staging buffer: an item's lane-major triangle rows, and
// with a shared origin each lane's (w1.o, w2.o)
template <bool SHARED>
__host__ __device__ constexpr int stage_floats() {
  return RT_CHUNK * RT_TRI_STRIDE + (SHARED ? 2 * RT_CHUNK : 0);
}

// the G warps' staging buffers, reused for their partial winners
// (t, key, cluster) at the end
template <int G, bool SHARED>
__host__ __device__ constexpr int smem_bytes() {
  return 4 * (2 * stage_floats<SHARED>() > RT_TILE * 3
                  ? G * 2 * stage_floats<SHARED>() : G * RT_TILE * 3);
}

// G last: the profiler's kernel names start closest_kernel<SHARED, ...
template <bool SHARED, bool BFC, int G>
__global__ void __launch_bounds__(G * 32) closest_kernel(
    const int* __restrict__ tw, const int* __restrict__ tl,
    const int* __restrict__ tc, const int* __restrict__ sw,
    const int* __restrict__ sl, const int* __restrict__ sc,
    const float* __restrict__ origin, const float* __restrict__ dirs,
    const float* __restrict__ tri_dat, const float* __restrict__ sph_dat,
    float* __restrict__ t_out, int* __restrict__ slot_out,
    int ct, int cs, int pt, int ps, int wt, int ws) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int i = blockIdx.x;
  if (tc[i] == 0 && sc[i] == 0) {
    for (int j = threadIdx.x; j < RT_TILE; j += blockDim.x) {
      t_out[i * RT_TILE + j] = CUDART_INF_F;
      slot_out[i * RT_TILE + j] = -1;
    }
    return;
  }
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int l0 = (w % RT_LANE_SPLIT) * RT_CHUNK;  // this warp's lanes
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float a_q[kRays], bt[kRays];
  int bkey[kRays], bk[kRays];
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const int ray = i * RT_TILE + lane + 32 * q;
    ox[q] = SHARED ? origin[0] : origin[3 * ray + 0];
    oy[q] = SHARED ? origin[1] : origin[3 * ray + 1];
    oz[q] = SHARED ? origin[2] : origin[3 * ray + 2];
    dx[q] = dirs[3 * ray + 0];
    dy[q] = dirs[3 * ray + 1];
    dz[q] = dirs[3 * ray + 2];
    a_q[q] = dx[q] * dx[q] + dy[q] * dy[q] + dz[q] * dz[q];
    bt[q] = CUDART_INF_F;
    bkey[q] = 0x7fffffff;
    bk[q] = 0;
  }

  auto stage = [&](float* dst, int k) {
    if (k < ct) stage_tri(dst, tri_dat, pt, k, l0, lane);
    else stage_sph(dst, sph_dat, ps, k - ct, l0, lane);
  };

  auto body = [&](float* buf, int k, int pos) {
    float vt[kRays];
    int vj[kRays];
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      vt[q] = CUDART_INF_F;
      vj[q] = 0;
    }
    const float4* rows = reinterpret_cast<const float4*>(buf);
    if (k < ct) {
      float2* oterm = reinterpret_cast<float2*>(buf + RT_CHUNK * RT_TRI_STRIDE);
      if (SHARED) {
        // the origin's per-lane terms, once per lane: n.a - n.o in place
        // of n.a, and (w1.o, w2.o)
        for (int l = lane; l < RT_CHUNK; l += 32) {
          float* r = buf + l * RT_TRI_STRIDE;
          const float4 a = rows[3 * l], b = rows[3 * l + 1], c = rows[3 * l + 2];
          r[3] = a.w - dot3(ox[0], oy[0], oz[0], a);
          oterm[l] = make_float2(dot3(ox[0], oy[0], oz[0], b),
                                 dot3(ox[0], oy[0], oz[0], c));
        }
        __syncwarp();
      }
#pragma unroll 2
      for (int l = 0; l < RT_CHUNK; ++l) {
        const float4 a = rows[3 * l], b = rows[3 * l + 1], c = rows[3 * l + 2];
        float2 e = make_float2(0.0f, 0.0f);
        if (SHARED) e = oterm[l];
#pragma unroll
        for (int q = 0; q < kRays; ++q) {
          float t;
          const bool ok =
              SHARED ? tri_hit<BFC>(a, b, c, a.w, e.x, e.y, dx[q], dy[q], dz[q], &t)
                     : tri_hit_ray<BFC>(a, b, c, ox[q], oy[q], oz[q], dx[q],
                                        dy[q], dz[q], &t);
          if (ok && t < vt[q]) {
            vt[q] = t;
            vj[q] = l0 + l;
          }
        }
      }
    } else {
#pragma unroll 2
      for (int l = 0; l < RT_CHUNK; ++l) {
        const float4 s = rows[l];
#pragma unroll
        for (int q = 0; q < kRays; ++q) {
          const SphTerms st = sph_terms(ox[q], oy[q], oz[q], dx[q], dy[q],
                                        dz[q], a_q[q], s.x, s.y, s.z, s.w);
          float t1;
          if (sph_root(st, a_q[q], s.w, &t1) && t1 < vt[q]) {
            vt[q] = t1;
            vj[q] = l0 + l;
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRays; ++q) {
      const int key = (vj[q] << 24) | pos;
      if (vt[q] < bt[q] || (vt[q] == bt[q] && key < bkey[q])) {
        bt[q] = vt[q];
        bkey[q] = key;
        bk[q] = k;
      }
    }
  };

  WarpVisits seq = tile_visits<G>(i, w, tw, tl, tc, sw, sl, sc, ct, cs, wt, ws);
  warp_walk(seq, smem + w * 2 * stage_floats<SHARED>(), stage_floats<SHARED>(),
            stage, body, [] { return false; });

  // merge the warps' partial winners on (t, lane, position)
  __syncthreads();  // every warp is done with its staging buffers
  float* m_t = smem;
  int* m_key = reinterpret_cast<int*>(smem + G * RT_TILE);
  int* m_k = m_key + G * RT_TILE;
#pragma unroll
  for (int q = 0; q < kRays; ++q) {
    const int j = w * RT_TILE + lane + 32 * q;
    m_t[j] = bt[q];
    m_key[j] = bkey[q];
    m_k[j] = bk[q];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < RT_TILE; j += blockDim.x) {
    float t = CUDART_INF_F;
    int key = 0x7fffffff, k = 0;
    for (int g = 0; g < G; ++g) {
      const float gt = m_t[g * RT_TILE + j];
      const int gkey = m_key[g * RT_TILE + j];
      if (gt < t || (gt == t && gkey < key)) {
        t = gt;
        key = gkey;
        k = m_k[g * RT_TILE + j];
      }
    }
    const int l = key >> 24;
    const int slot = k >= ct ? pt + (k - ct) * RT_CLUSTER + l : k * RT_CLUSTER + l;
    t_out[i * RT_TILE + j] = t;
    slot_out[i * RT_TILE + j] = t < CUDART_INF_F ? slot : -1;
  }
}

}  // namespace

extern "C" int rt_closest(const int* tw, const int* tl, const int* tc,
                          const int* sw, const int* sl, const int* sc,
                          const float* origin, const float* dirs,
                          const float* tri_dat, const float* sph_dat,
                          float* t, int* slot, int nt, int ct, int cs, int pt,
                          int ps, int wt, int ws, int shared_origin, int bfc,
                          void* stream) {
  if (nt <= 0) return static_cast<int>(cudaGetLastError());
  const cudaError_t e = dispatch(wide_launch(nt), shared_origin, bfc,
                                 [&](auto g, auto sh, auto bf) {
    constexpr int G = decltype(g)::value;
    constexpr bool SHARED = decltype(sh)::value;
    auto kernel = closest_kernel<SHARED, decltype(bf)::value, G>;
    constexpr int bytes = smem_bytes<G, SHARED>();
    static const cudaError_t a = allow_smem(kernel, bytes);
    if (a != cudaSuccess) return a;
    kernel<<<nt, G * 32, bytes, static_cast<cudaStream_t>(stream)>>>(
        tw, tl, tc, sw, sl, sc, origin, dirs, tri_dat, sph_dat, t, slot, ct,
        cs, pt, ps, wt, ws);
    return cudaGetLastError();
  });
  return static_cast<int>(e);
}

// Threads per block of a closest-hit, any-hit or shadow launch over nt
// tiles (the block width wide_launch picks); a number, not an error code.
extern "C" int rt_launch_threads(int nt) {
  return 32 * (wide_launch(nt) ? RT_WIDE_WARPS : RT_NARROW_WARPS);
}
