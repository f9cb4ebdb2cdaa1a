// ray_mask: exact per-ray slab test of every ray against every cluster
// box, OR-reduced over each 128-ray tile, with the least slab entry.
//
// Replaces the TPU kernel _ray_mask_kernel (raytracer_tpu/ops/
// cluster_trace.py:305-352, called by _ray_cluster_mask_tpu, :355).
//
// Design: one block per tile.  The tile's precomputed ray bundle
// [o*inv (3), t_hi, inv (3)] goes to shared memory; each thread owns the
// cluster columns c, c + blockDim, ... (only the C real columns: the TPU's
// _BIG padding boxes are not evaluated), loops over the 128 rays and
// writes hit and entry for (tile, c) itself: no atomics, deterministic.
// A tile without an active ray writes 0 / +inf without testing.
//
// What bounds it: floating-point operations, about 25 per (ray, cluster)
// pair (6 multiplies and subtracts, 12 NaN-propagating min/max, 3
// compares), rounded op for op (-fmad=false).  This first version aims
// at correctness, not speed.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(RT_TILE) ray_mask_kernel(
    const int* __restrict__ act, const float* __restrict__ box,
    const float* __restrict__ bundle, int* __restrict__ hit,
    float* __restrict__ ent, int c, int r) {
  __shared__ float b[7][RT_TILE];
  const int i = blockIdx.x;
  if (act[i] == 0) {
    for (int cc = threadIdx.x; cc < c; cc += blockDim.x) {
      hit[i * c + cc] = 0;
      ent[i * c + cc] = CUDART_INF_F;
    }
    return;
  }
  for (int k = 0; k < 7; ++k) b[k][threadIdx.x] = bundle[k * r + i * RT_TILE + threadIdx.x];
  __syncthreads();
  for (int cc = threadIdx.x; cc < c; cc += blockDim.x) {
    const float x0 = box[0 * c + cc], y0 = box[1 * c + cc], z0 = box[2 * c + cc];
    const float x1 = box[4 * c + cc], y1 = box[5 * c + cc], z1 = box[6 * c + cc];
    int any = 0;
    float emin = CUDART_INF_F;
    for (int j = 0; j < RT_TILE; ++j) {
      const float oix = b[0][j], oiy = b[1][j], oiz = b[2][j], thi = b[3][j];
      const float ix = b[4][j], iy = b[5][j], iz = b[6][j];
      float t1 = ix * x0 - oix, t2 = ix * x1 - oix;
      const float nx = nan_min(t1, t2), fx = nan_max(t1, t2);
      t1 = iy * y0 - oiy;
      t2 = iy * y1 - oiy;
      const float ny = nan_min(t1, t2), fy = nan_max(t1, t2);
      t1 = iz * z0 - oiz;
      t2 = iz * z1 - oiz;
      const float nz = nan_min(t1, t2), fz = nan_max(t1, t2);
      const float entry = nan_max(nx, nan_max(ny, nz));
      const float exit_ = nan_min(fx, nan_min(fy, fz));
      if ((entry <= exit_) && (exit_ >= 0.0f) && (entry <= thi)) {
        any = 1;
        emin = fminf(emin, entry);  // entry is not NaN here
      }
    }
    hit[i * c + cc] = any;
    ent[i * c + cc] = emin;
  }
}

}  // namespace

extern "C" int rt_ray_mask(const int* act, const float* box,
                           const float* bundle, int* hit, float* ent, int nt,
                           int c, int r, void* stream) {
  if (nt > 0 && c > 0) {
    ray_mask_kernel<<<nt, RT_TILE, 0, static_cast<cudaStream_t>(stream)>>>(
        act, box, bundle, hit, ent, c, r);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
