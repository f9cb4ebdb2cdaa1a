// threefry: uniform f32 draws of JAX's default PRNG, threefry2x32 in its
// partitionable form (jax_threefry_partitionable, the default since JAX
// 0.5), so a seed gives the JAX package's jitter and adaptive sample sets
// bit for bit.
//
// Replaces no Pallas kernel: the JAX package draws with jax.random.uniform
// (raytracer_tpu/models/whitted.py:362-370, raytracer_tpu/ops/
// adaptive.py:118-119,168), which XLA lowers to one fused elementwise
// kernel.  Element i of a draw of n is
//
//   (x0, x1) = threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))
//   bits     = x0 ^ x1
//   f        = bitcast<f32>((bits >> 9) | 0x3F800000) - 1     in [0, 1)
//   out[i]   = max(lo, f * (hi - lo) + lo)
//
// in native uint32 arithmetic: 20 rounds of add, rotate and xor with the
// rotation constants (13, 15, 26, 6) / (17, 29, 16, 24), the key injected
// every 4 rounds with ks2 = k0 ^ k1 ^ 0x1BD11BDA (Salmon et al., SC'11,
// as jax._src.prng writes it).  The float steps round op by op (built
// with -fmad=false), as the plain version in ops/kernels.py does.
//
// Design: one thread per element, 256-thread blocks; the counter is the
// thread's flat index, so neighbouring threads store neighbouring floats
// (coalesced 4-byte stores).  The key is read from device memory, two
// int64 words whose low 32 bits are k0 and k1 (each thread loads them
// once; every thread of the grid reads the same 16 bytes, an L1/L2 hit):
// the host writes them into a static tensor before a captured program
// replays, so one CUDA graph draws every band's and every wave's offsets.
//
// What bounds it: the 4 n bytes it writes, or its instructions, whichever
// is slower.  It is integer work, so the ceiling is the issue rate (4 warp
// instructions a clock on each SM), not the FP32 FMA rate; chip_smoke.py
// counts the SASS instructions of threefry_uniform_kernel (cuobjdump) and
// divides by 132 SMs x 4 x 32 lanes x the maximum SM clock.  A full-width
// SSAA 2 band is 8,388,608 elements, 33.5 MB.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define RT_TF_ROUND(r) \
  x0 += x1;            \
  x1 = rotl(x1, r);    \
  x1 ^= x0;

#define RT_TF_GROUP_A RT_TF_ROUND(13) RT_TF_ROUND(15) RT_TF_ROUND(26) RT_TF_ROUND(6)
#define RT_TF_GROUP_B RT_TF_ROUND(17) RT_TF_ROUND(29) RT_TF_ROUND(16) RT_TF_ROUND(24)

__global__ void __launch_bounds__(kThreads) threefry_uniform_kernel(
    const long long* __restrict__ key, float lo, float hi,
    float* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = static_cast<uint32_t>(static_cast<unsigned long long>(i) >> 32) + k0;
  uint32_t x1 = static_cast<uint32_t>(i) + k1;
  RT_TF_GROUP_A
  x0 += k1;
  x1 += k2 + 1u;
  RT_TF_GROUP_B
  x0 += k2;
  x1 += k0 + 2u;
  RT_TF_GROUP_A
  x0 += k0;
  x1 += k1 + 3u;
  RT_TF_GROUP_B
  x0 += k1;
  x1 += k2 + 4u;
  RT_TF_GROUP_A
  x0 += k2;
  x1 += k0 + 5u;
  const uint32_t bits = x0 ^ x1;
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  out[i] = fmaxf(lo, f * (hi - lo) + lo);
}

#undef RT_TF_GROUP_A
#undef RT_TF_GROUP_B
#undef RT_TF_ROUND

}  // namespace

// key: (2,) int64 on the device, the key words in their low 32 bits; out:
// (n,) f32 on the device; lo, hi: the bounds as f32 (hi - lo is rounded on
// the device, as jax.random.uniform rounds it).
extern "C" int rt_threefry_uniform(const long long* key, float lo, float hi,
                                   float* out, long long n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long blocks = (n + kThreads - 1) / kThreads;
  threefry_uniform_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(key, lo, hi, out,
                                                                 n);
  return static_cast<int>(cudaGetLastError());
}
