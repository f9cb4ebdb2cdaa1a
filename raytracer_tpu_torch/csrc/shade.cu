// shade: the cluster engine's forward bounce epilogue, one thread a ray, in
// two launches around the occlusion pass.
//
// Replaces no Pallas kernel: the JAX package leaves this arithmetic to XLA,
// which fuses it (raytracer_tpu/ops/cluster_trace.py cluster_closest_hit
// after its kernel, raytracer_tpu/ops/shade.py shade_local and
// reflection_rays, raytracer_tpu/models/whitted.py _shade).  Run as
// PyTorch ops it was about 270 kernels a bounce over (R,), (R, 3) and
// (R, L, 3) tensors, the largest block of a frame's device time.
//
//   hit_record_kernel, after the closest kernel: the dense small-sphere
//     test merged into the kernel's (t, slot) (strict <, so triangles keep
//     exact-t ties; the lowest sphere slot wins), the ray's slot_pack row
//     read directly (the table sits in L2), and the hit record (hit,
//     normal, mat, point, offset; not t, which nothing after it reads)
//     with the shadow pass's per-light mask hit & (cos_theta >=
//     RELEVANT_COS).  Every lane is computed.
//   shade_bounce_kernel, after the occlusion pass: the small-sphere
//     segment test ORed into the occlusion bits, the depth-0 background,
//     ambient, Blinn-Phong over the lights, color += throughput * local,
//     the mirror reflection and the next carry (throughput, active,
//     origin, direction), written in place.  A lane that enters inactive
//     returns after reading its flag when the carry is updated in place:
//     the plain version leaves such a lane's carry as it was, its
//     throughput being 0 since the bounce that ended it.
//
// Each kernel equals its plain version in ops/cluster_trace.py (PyTorch's ops on
// the card) bit for bit: -fmad=false, the plain version's operation
// order, sqrtf, acosf and powf as PyTorch's float ops call them, and
// PyTorch's CUDA order for its sums over a last axis of 3 (sum3) and over
// the lights (a running sum in each of 4 accumulators, light l in l % 4,
// then added in order).
//
// What bounds them: memory.  hit_record reads 21 bytes a ray (33 with a
// ray's own origin) and its slot table row from L2, and writes 45 + L;
// shade_bounce reads 38 a ray and up to 44 + L more a hit, and writes 49
// (floats of (R, 3) rows, one 4-byte access a component: a warp's three
// accesses cover 384 contiguous bytes).  The material rows, lights and
// small spheres are a few hundred bytes, read through the read-only
// cache.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = RT_TILE;

// PyTorch's CUDA sum over a last axis of 3 (normalize, norm, dot): two
// threads an output, the first adding elements 0 and 2, then the second's
// element 1
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return (a + c) + b;
}

// torch.clamp_min / torch.clamp on the card: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, long long i) {
  return V3{p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}
__device__ __forceinline__ V3 ldg3(const float* p, long long i) {
  return V3{__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}
__device__ __forceinline__ void store3(float* p, long long i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return V3{a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 vdiv(V3 a, float s) {
  return V3{a.x / s, a.y / s, a.z / s};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return sum3(a.x * b.x, a.y * b.y, a.z * b.z);
}
// v / sqrt(v . v), ops/intersect.py normalize
__device__ __forceinline__ V3 normalize(V3 v) { return vdiv(v, sqrtf(dot(v, v))); }

__global__ void __launch_bounds__(kThreads) hit_record_kernel(
    const float* __restrict__ t_k, const int* __restrict__ slot_k,
    const float* __restrict__ origin, int org_stride,
    const float* __restrict__ dirs, const bool* __restrict__ active,
    const float* __restrict__ pack, const float* __restrict__ sph, int ps,
    int n_small, int pt, const float* __restrict__ lps, int nl, float eps,
    float relevant_cos, bool* __restrict__ hit_out, float* __restrict__ normal_out, long long* __restrict__ mat_out,
    float* __restrict__ point_out, float* __restrict__ offset_out,
    bool* __restrict__ mask_out, int r) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= r) return;
  const V3 o = load3(origin, org_stride ? i : 0);
  const V3 d = load3(dirs, i);
  float t = t_k[i];
  int slot = slot_k[i];
  if (n_small > 0) {
    // cluster_trace._merge_small_spheres: the first least t of the dense
    // test (torch.min: NaN wins), taken only below the kernel's t
    const float a_q = d.x * d.x + d.y * d.y + d.z * d.z;
    float tj = CUDART_INF_F;
    int j = 0;
    for (int s = 0; s < n_small; ++s) {
      const float rad = __ldg(sph + 3 * ps + s);
      const SphTerms q = sph_terms(o.x, o.y, o.z, d.x, d.y, d.z, a_q,
                                   __ldg(sph + s), __ldg(sph + ps + s),
                                   __ldg(sph + 2 * ps + s), rad);
      float t1;
      const float ts = sph_root(q, a_q, rad, &t1) ? t1 : CUDART_INF_F;
      if (ts < tj || (isnan(ts) && !isnan(tj))) {
        tj = ts;
        j = s;
      }
    }
    if (tj < (slot >= 0 ? t : CUDART_INF_F)) {
      t = tj;
      slot = pt + j;
    }
  }
  // cluster_trace.slot_hits
  const bool fhit = slot >= 0;
  const int sslot = fhit ? slot : 0;
  const float4 p0 = __ldg(reinterpret_cast<const float4*>(pack) + 2 * sslot);
  const float4 p1 = __ldg(reinterpret_cast<const float4*>(pack) + 2 * sslot + 1);
  const V3 aux{p0.x, p0.y, p0.z};
  t = fhit ? t : 1.0f;
  const V3 p{o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
  const bool sph_lane = fhit && sslot >= pt;
  const V3 up{0.0f, 0.0f, 1.0f};
  const float safe_rad = sph_lane ? clamp_min(p0.w, 1e-30f) : 1.0f;
  const V3 n_raw = sph_lane ? vdiv(sub(p, aux), safe_rad) : up;
  V3 n = sph_lane ? normalize(n_raw) : aux;
  n = fhit ? n : up;
  const V3 off{p.x + n.x * eps, p.y + n.y * eps, p.z + n.z * eps};
  const bool h = fhit && active[i];
  hit_out[i] = h;
  store3(normal_out, i, n);
  mat_out[i] = fhit ? static_cast<long long>(p1.x) : 0;
  store3(point_out, i, p);
  store3(offset_out, i, off);
  // shade._light_terms' relevance, masked by the hit
  for (int l = 0; l < nl; ++l) {
    const float cos_theta = dot(normalize(sub(ldg3(lps, l), p)), n);
    mask_out[i * nl + l] = h && cos_theta >= relevant_cos;
  }
}

template <bool RELAXED>
__global__ void __launch_bounds__(kThreads) shade_bounce_kernel(
    const float* color_in, const float* tp_in, const bool* active_in,
    const float* org_in, int org_stride, const float* dir_in,
    const bool* __restrict__ hit, const float* __restrict__ normal,
    const long long* __restrict__ mat, const float* __restrict__ point,
    const float* __restrict__ offset, const bool* __restrict__ occ,
    const float* __restrict__ mat_ambient, const float* __restrict__ mat_diffuse,
    const float* __restrict__ mat_specular, const float* __restrict__ mat_mirror,
    const float* __restrict__ mat_phong, const bool* __restrict__ mat_is_mirror,
    const float* __restrict__ lps, const float* __restrict__ lint,
    const float* __restrict__ ambient_light, const float* __restrict__ background,
    const float* __restrict__ sph, int ps, int n_small, float* color_out,
    float* tp_out, bool* active_out, float* org_out, float* dir_out, int r,
    int nl, int first, int inplace, float relevant_cos, float rad_to_deg,
    float gate_deg) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= r) return;
  const bool act = active_in[i];
  if (!act && inplace) return;
  const bool h = hit[i];
  V3 color = load3(color_in, i);
  const V3 tp = load3(tp_in, i);
  if (first) {
    const bool bg = !h && act;
    color = V3{color.x + (bg ? __ldg(background) : 0.0f),
               color.y + (bg ? __ldg(background + 1) : 0.0f),
               color.z + (bg ? __ldg(background + 2) : 0.0f)};
  }
  V3 local{0.0f, 0.0f, 0.0f};
  bool next = false;
  V3 refl_org{0.0f, 0.0f, 0.0f}, refl_dir{0.0f, 0.0f, 0.0f}, tint{0.0f, 0.0f, 0.0f};
  if (h) {
    // shade.shade_local
    const long long m = mat[i];
    local = mul(ldg3(mat_ambient, m), ldg3(ambient_light, 0));
    const V3 n = load3(normal, i);
    const V3 off = load3(offset, i);
    const V3 d_unit = normalize(load3(dir_in, i));
    const V3 n_unit = normalize(n);
    if (nl > 0) {
      const V3 p = load3(point, i);
      const V3 diffuse = ldg3(mat_diffuse, m);
      const V3 specular = ldg3(mat_specular, m);
      const float phong = __ldg(mat_phong + m);
      V3 acc[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = V3{0.0f, 0.0f, 0.0f};
      for (int l0 = 0; l0 < nl; l0 += 4) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int l = l0 + k;
          if (l >= nl) break;
          const V3 lp = ldg3(lps, l);
          const V3 to_off = sub(lp, off);
          const float light_dist = sqrtf(dot(to_off, to_off));
          const float cos_theta = dot(normalize(sub(lp, p)), n);
          if (!(cos_theta >= relevant_cos) || occ[i * nl + l]) continue;
          bool occluded = false;
          if (n_small > 0) {
            // cluster_trace._small_sphere_test_multi toward this light
            const float a_q = to_off.x * to_off.x + to_off.y * to_off.y +
                              to_off.z * to_off.z;
            for (int s = 0; s < n_small && !occluded; ++s) {
              occluded = sph_occluded<RELAXED>(
                  off.x, off.y, off.z, to_off.x, to_off.y, to_off.z, a_q,
                  __ldg(sph + s), __ldg(sph + ps + s), __ldg(sph + 2 * ps + s),
                  __ldg(sph + 3 * ps + s), 1.0f);
            }
          }
          if (occluded) continue;
          const V3 sdir = vdiv(to_off, light_dist);
          const float dd = light_dist * light_dist;
          const V3 li = ldg3(lint, l);
          const V3 irr{li.x / dd, li.y / dd, li.z / dd};
          const bool gate = acosf(cos_theta) * rad_to_deg <= gate_deg;
          const float cos_h = clamp_min(dot(n_unit, normalize(sub(sdir, d_unit))), 0.0f);
          const float pw = powf(cos_h, phong);
          const float cl = clamp01(cos_theta);
          const V3 diff{diffuse.x * cl * irr.x, diffuse.y * cl * irr.y,
                        diffuse.z * cl * irr.z};
          const V3 spec{specular.x * pw * irr.x, specular.y * pw * irr.y,
                        specular.z * pw * irr.z};
          acc[k] = V3{acc[k].x + (diff.x + (gate ? spec.x : 0.0f)),
                      acc[k].y + (diff.y + (gate ? spec.y : 0.0f)),
                      acc[k].z + (diff.z + (gate ? spec.z : 0.0f))};
        }
      }
      local = V3{local.x + (((acc[0].x + acc[1].x) + acc[2].x) + acc[3].x),
                 local.y + (((acc[0].y + acc[1].y) + acc[2].y) + acc[3].y),
                 local.z + (((acc[0].z + acc[1].z) + acc[2].z) + acc[3].z)};
    }
    // shade.reflection_rays
    const float two_cos = 2.0f * -dot(d_unit, n_unit);
    refl_dir = V3{d_unit.x + n_unit.x * two_cos, d_unit.y + n_unit.y * two_cos,
                  d_unit.z + n_unit.z * two_cos};
    refl_org = off;
    tint = ldg3(mat_mirror, m);
    next = act && __ldg(reinterpret_cast<const unsigned char*>(mat_is_mirror) + m);
  }
  store3(color_out, i, V3{color.x + tp.x * local.x, color.y + tp.y * local.y,
                          color.z + tp.z * local.z});
  store3(tp_out, i, next ? mul(tp, tint) : V3{0.0f, 0.0f, 0.0f});
  active_out[i] = next;
  store3(org_out, i, next ? refl_org : load3(org_in, org_stride ? i : 0));
  store3(dir_out, i, next ? refl_dir : load3(dir_in, i));
}

}  // namespace

// t, slot: the closest kernel's (R_pad,) results; origin: (3,) with
// shared_origin, else (R, 3); dirs (R, 3); active (R,) bool; pack: the
// (Pt + Ps, 8) slot table; sph: the (4, ps) sphere table, its first
// n_small columns the small spheres (0: none); lps (nl, 3); outputs of R
// rays, the mask (R, nl).
extern "C" int rt_hit_record(const float* t, const int* slot,
                             const float* origin, const float* dirs,
                             const bool* active, const float* pack,
                             const float* sph, const float* lps, bool* hit,
                             float* normal, long long* mat,
                             float* point, float* offset, bool* mask, int r,
                             int pt, int ps, int n_small, int nl,
                             int shared_origin, float eps, float relevant_cos,
                             void* stream) {
  if (r <= 0) return static_cast<int>(cudaGetLastError());
  hit_record_kernel<<<(r + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      t, slot, origin, shared_origin ? 0 : 1, dirs, active, pack, sph, ps,
      n_small, pt, lps, nl, eps, relevant_cos, hit, normal, mat, point,
      offset, mask, r);
  return static_cast<int>(cudaGetLastError());
}

// The carry (color, tp, active, org, dir) in and out (out may be in: then
// inplace), org_in (3,) with shared_origin; the hit record of rt_hit_record;
// occ (R, nl) bool (nullptr without lights); the scene's material rows
// (M, 3) / (M,), lights (nl, 3), ambient light and background (3,).
extern "C" int rt_shade_bounce(
    const float* color_in, const float* tp_in, const bool* active_in,
    const float* org_in, const float* dir_in, const bool* hit,
    const float* normal, const long long* mat, const float* point,
    const float* offset, const bool* occ, const float* mat_ambient,
    const float* mat_diffuse, const float* mat_specular,
    const float* mat_mirror, const float* mat_phong,
    const bool* mat_is_mirror, const float* lps, const float* lint,
    const float* ambient_light, const float* background, const float* sph,
    float* color_out, float* tp_out, bool* active_out, float* org_out,
    float* dir_out, int r, int nl, int ps, int n_small, int shared_origin,
    int first, int inplace, int relaxed, float relevant_cos, float rad_to_deg,
    float gate_deg, void* stream) {
  if (r <= 0) return static_cast<int>(cudaGetLastError());
  auto kernel = relaxed ? shade_bounce_kernel<true> : shade_bounce_kernel<false>;
  kernel<<<(r + kThreads - 1) / kThreads, kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      color_in, tp_in, active_in, org_in, shared_origin ? 0 : 1, dir_in, hit,
      normal, mat, point, offset, occ, mat_ambient, mat_diffuse, mat_specular,
      mat_mirror, mat_phong, mat_is_mirror, lps, lint, ambient_light,
      background, sph, ps, n_small, color_out, tp_out, active_out, org_out,
      dir_out, r, nl, first, inplace, relevant_cos, rad_to_deg, gate_deg);
  return static_cast<int>(cudaGetLastError());
}
