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

#include <type_traits>

#define RT_TILE 128         // rays per tile (one block)
#define RT_CLUSTER 128      // primitive slots per cluster
#define RT_MAX_TRI_LIST 48  // list capacity before the bitmask fallback
#define RT_MAX_SPH_LIST 8
#define RT_DENSE_SPH_ROWS 8 // <= this many sphere clusters: visit all

// min/max that propagate NaN like torch.minimum / jnp.minimum (CUDA's
// fminf/fmaxf return the other operand): empty clusters have NaN boxes
// and padding triangles give NaN t, and every test relies on NaN failing
// every comparison.  One instruction each (PTX min.NaN / max.NaN, sm_80
// and later: FMNMX with .NAN).  On zeros of opposite sign the result may
// carry the other sign than torch.minimum's; -0 == +0, so every
// comparison, and the kernels' equality with their plain versions (held
// with ==), and the shortlist sort (_compact orders -0 and +0 as equal)
// are unaffected.
__device__ __forceinline__ float nan_min(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
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

// ---------------------------------------------------------------------------
// Warp-level cluster walks of the closest, any-hit and shadow kernels.  The
// visit sequence of a tile: the front-to-back id list of each side when
// its count fits the list, else every cluster whose bit is set,
// ascending.  A block of
// G warps owns one 128-ray tile; every warp covers all 128 rays
// (RT_RAYS_PER_THREAD per thread).  The tile's work is cut into items
// (visit position p, lane chunk h): RT_LANE_SPLIT chunks of RT_CHUNK lanes
// per visit.  Warp w takes chunk h = w % RT_LANE_SPLIT of the visits
// p = w / RT_LANE_SPLIT + m * (G / RT_LANE_SPLIT): the warps split the
// lanes of each visit and, beyond RT_LANE_SPLIT warps, the visits.  Each
// warp stages its own items, lane-major and double-buffered with cp.async;
// no item needs a block barrier.
//
// G is chosen per launch (wide_launch): RT_NARROW_WARPS for launches of
// many tiles (whole frames: many short walks, where more warps per tile
// would idle), RT_WIDE_WARPS for launches of at most RT_WIDE_TILES_PER_SM
// tiles per SM (the big scenes' ray chunks: few tiles, long walks, where
// a narrow block leaves the SMs nearly empty).
// ---------------------------------------------------------------------------

#define RT_LANE_SPLIT 4
#define RT_NARROW_WARPS 4
#define RT_WIDE_WARPS 16
#define RT_WIDE_TILES_PER_SM 16
#define RT_CHUNK (RT_CLUSTER / RT_LANE_SPLIT)  // lanes per item
#define RT_RAYS_PER_THREAD (RT_TILE / 32)
#define RT_TRI_STRIDE 12    // floats per staged triangle lane: 3 float4
#define RT_FULL_MASK 0xffffffffu

// The card's SM count, read once per process (the port drives one card a
// process; every per-launch choice made from it gives the same result).
// A failed read leaves it 0, and the error is the one cudaGetLastError
// returns after the launch.
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) == cudaSuccess) {
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    return n;
  }();
  return sms;
}

// True when a launch over nt tiles takes RT_WIDE_WARPS-warp blocks (with
// no SM count, narrow).
inline bool wide_launch(int nt) { return nt <= RT_WIDE_TILES_PER_SM * sm_count(); }

// f(G, A, B) for the kernel instance of a launch, each argument a
// std::integral_constant: G warps per block, template flags a and b.
template <class F>
cudaError_t dispatch(bool wide, bool a, bool b, F f) {
  using T = std::true_type;
  using N = std::false_type;
  auto flags = [&](auto g) -> cudaError_t {
    if (a) return b ? f(g, T(), T()) : f(g, T(), N());
    return b ? f(g, N(), T()) : f(g, N(), N());
  };
  return wide ? flags(std::integral_constant<int, RT_WIDE_WARPS>())
              : flags(std::integral_constant<int, RT_NARROW_WARPS>());
}

// Allow `bytes` of dynamic shared memory for `kernel` (needed above 48 KB).
// The callers keep the result in a static of each instance: once per
// process.
template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Staged triangle lane: a = (n, n.a), b = (w1, w1.a), c = (w2, w2.a).
// Wald test of the ray against it in the operation order of
// _tri_cluster_test (cluster_trace.py:520-543): nmo = n.a - n.o and the
// origin dots w1.o, w2.o come from the caller (per pair, or once per lane
// for a shared origin; the same values either way).  All-zero padding
// lanes give t = 0/0 = NaN: every comparison fails.  BFC culls triangles
// facing away from the ray.
template <bool BFC>
__device__ __forceinline__ bool tri_hit(float4 a, float4 b, float4 c,
                                        float nmo, float w1o, float w2o,
                                        float dx, float dy, float dz,
                                        float* t_out) {
  const float nd = dx * a.x + dy * a.y + dz * a.z;
  const float t = nmo / nd;
  const float beta = w1o + t * (dx * b.x + dy * b.y + dz * b.z) - b.w;
  const float gamma = w2o + t * (dx * c.x + dy * c.y + dz * c.z) - c.w;
  const float alpha = 1.0f - beta - gamma;
  bool ok = (alpha >= 0.0f) && (beta >= 0.0f) && (gamma >= 0.0f) &&
            (t >= 0.0f);
  if (BFC) ok = ok && (nd < 0.0f);
  *t_out = t;
  return ok;
}

// o . (v.x, v.y, v.z), as ox * row + oy * row + oz * row on the TPU.
__device__ __forceinline__ float dot3(float ox, float oy, float oz, float4 v) {
  return ox * v.x + oy * v.y + oz * v.z;
}

// Wald test with a per-ray origin: the origin dots per pair.
template <bool BFC>
__device__ __forceinline__ bool tri_hit_ray(float4 a, float4 b, float4 c,
                                            float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float* t_out) {
  return tri_hit<BFC>(a, b, c, a.w - dot3(ox, oy, oz, a), dot3(ox, oy, oz, b),
                      dot3(ox, oy, oz, c), dx, dy, dz, t_out);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy lanes [l0, l0 + RT_CHUNK) of triangle cluster k (rows of the
// (12, pt) table) into lane-major order, dst[l * 12 + s]: slots (n, n.a,
// w1, w1.a, w2, w2.a), i.e. rows 0-2, 9, 3-5, 10, 6-8, 11.  Each cp.async
// moves one float; a warp's copies of one row are consecutive floats.
__device__ __forceinline__ void stage_tri(float* dst, const float* tri,
                                          int pt, int k, int l0, int lane) {
  const float* src = tri + k * RT_CLUSTER + l0;
#pragma unroll
  for (int e = lane; e < 12 * RT_CHUNK; e += 32) {
    const int r = e / RT_CHUNK, l = e % RT_CHUNK;
    const int s = r < 9 ? r + r / 3 : 4 * (r - 9) + 3;
    cp_async4(dst + l * RT_TRI_STRIDE + s, src + r * pt + l);
  }
}

// Lanes [l0, l0 + RT_CHUNK) of cluster k of one light's (16, pt) shadow
// plane table, lane-major, RT_PLANE_STRIDE floats a lane: the lane's rows
// 4v .. 4v + 3 as the float4 at slot v ^ plane_swizzle(l).  The XOR puts
// the eight lanes a copy instruction writes on distinct banks; each copy
// instruction of a warp reads 8 consecutive floats of 4 rows (4 whole
// sectors).  Each cp.async moves one float.
#define RT_PLANE_STRIDE 16
__host__ __device__ constexpr int plane_swizzle(int l) { return (l >> 1) & 3; }

__device__ __forceinline__ void stage_planes(float* dst, const float* pln,
                                             int pt, int k, int l0, int lane) {
  const float* src = pln + k * RT_CLUSTER + l0;
  const int s = lane & 3, g = lane >> 2;
#pragma unroll
  for (int it = 0; it < 16; ++it) {
    const int l = g + 8 * (it & 3), v = it >> 2;
    cp_async4(dst + l * RT_PLANE_STRIDE + 4 * (v ^ plane_swizzle(l)) + s,
              src + (4 * v + s) * pt + l);
  }
}

// The same lanes of sphere cluster k of the (4, ps) table as one float4
// (center, radius) per lane.
__device__ __forceinline__ void stage_sph(float* dst, const float* sph,
                                          int ps, int k, int l0, int lane) {
  const float* src = sph + k * RT_CLUSTER + l0;
#pragma unroll
  for (int e = lane; e < 4 * RT_CHUNK; e += 32) {
    const int r = e / RT_CHUNK, l = e % RT_CHUNK;
    cp_async4(dst + l * 4 + r, src + r * ps + l);
  }
}

// One side (triangles or spheres) of a tile's visit sequence: the id list
// when its count fits the list, else every cluster whose bit is set,
// ascending; or (dense) every cluster.
struct VisitSide {
  const int* ids;    // the tile's list; nullptr: dense (cluster r at rank r)
  const int* words;  // the tile's bitmask words
  int len;           // visits, or -1: scan the bitmask
  int n_clusters;
  int k0;            // added to the cluster id (ct on the sphere side)
};

// The positions first, first + stride, ... of the sequence (triangle
// side, then sphere side), in order.  The positions are those of the
// whole sequence, so the warps' partial winners merge exactly.  Uniform
// over the warp.
class WarpVisits {
 public:
  __device__ WarpVisits(VisitSide tri, VisitSide sph, int first, int stride)
      : tri_(tri), sph_(sph), s_(0), base_(0), target_(first),
        stride_(stride), word_(-1), rank_(0), bits_(0u) {}

  // The next visit of this warp: cluster id k (sphere clusters offset by
  // ct) at position pos; false when the sequence is done.
  __device__ bool next(int* k, int* pos) {
    while (s_ < 2) {
      const VisitSide S = s_ == 0 ? tri_ : sph_;  // by value: registers
      if (S.len >= 0) {
        const int r = target_ - base_;
        if (r < S.len) {
          *k = S.k0 + (S.ids ? S.ids[r] : r);
          *pos = target_;
          target_ += stride_;
          return true;
        }
        base_ += S.len;
      } else {
        const int n_words = (S.n_clusters + 31) >> 5;
        for (;;) {
          if (bits_ == 0u) {
            if (++word_ >= n_words) break;
            bits_ = static_cast<unsigned>(S.words[word_]);
            if ((word_ + 1) * 32 > S.n_clusters) {
              bits_ &= (1u << (S.n_clusters & 31)) - 1u;
            }
            continue;
          }
          const int b = __ffs(bits_) - 1;
          bits_ &= bits_ - 1u;
          if (base_ + rank_++ == target_) {
            *k = S.k0 + word_ * 32 + b;
            *pos = target_;
            target_ += stride_;
            return true;
          }
        }
        base_ += rank_;
      }
      ++s_;
      word_ = -1;
      rank_ = 0;
      bits_ = 0u;
    }
    return false;
  }

 private:
  VisitSide tri_, sph_;
  int s_, base_, target_, stride_, word_, rank_;
  unsigned bits_;
};

// Warp w's visits of tile i (blocks of G warps), in the sequence shared
// by the closest and any-hit kernels: triangle clusters, then sphere
// clusters (all of them, ascending, when the scene has at most
// RT_DENSE_SPH_ROWS and the tile has a sphere candidate).
template <int G>
__device__ __forceinline__ WarpVisits tile_visits(
    int i, int warp, const int* tw, const int* tl, const int* tc,
    const int* sw, const int* sl, const int* sc, int ct, int cs, int wt,
    int ws) {
  const int n_t = tc[i], n_s = sc[i];
  const VisitSide tri{tl + i * RT_MAX_TRI_LIST, tw + i * wt,
                      n_t <= RT_MAX_TRI_LIST ? n_t : -1, ct, 0};
  const VisitSide sph =
      cs <= RT_DENSE_SPH_ROWS
          ? VisitSide{nullptr, nullptr, n_s != 0 ? cs : 0, cs, ct}
          : VisitSide{sl + i * RT_MAX_SPH_LIST, sw + i * ws,
                      n_s <= RT_MAX_SPH_LIST ? n_s : -1, cs, ct};
  static_assert(G % RT_LANE_SPLIT == 0, "a visit's chunks go to as many warps");
  return WarpVisits(tri, sph, warp / RT_LANE_SPLIT, G / RT_LANE_SPLIT);
}

// Walk this warp's items with two staging buffers (buf and buf + stride
// floats): the copies of the next item are in flight while the warp tests
// the current one.  stage(dst, k) issues an item's copies of cluster k;
// body(staged, k, pos) tests it; stop() (uniform over the warp) ends the
// walk before an item.  No block-wide barrier; the buffers may be reused by
// the next walk.
template <class Stage, class Body, class Stop>
__device__ __forceinline__ void warp_walk(WarpVisits& seq, float* buf,
                                          int stride, Stage stage, Body body,
                                          Stop stop) {
  int k, pos;
  bool have = seq.next(&k, &pos);
  if (have) stage(buf, k);
  cp_async_commit();
  int cur = 0;
  while (have && !stop()) {
    int k2, pos2;
    const bool have2 = seq.next(&k2, &pos2);
    if (have2) stage(buf + (cur ^ 1) * stride, k2);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of the current item
    __syncwarp();        // ... and every other lane's
    body(buf + cur * stride, k, pos);
    __syncwarp();        // the buffer is free for the item after next
    cur ^= 1;
    k = k2;
    pos = pos2;
    have = have2;
  }
  cp_async_wait<0>();
  __syncwarp();  // every lane's copies have landed: the buffers are free
}
