// ray_mask: exact per-ray slab test of every ray against every cluster
// box, OR-reduced over each 128-ray tile, with the least slab entry.
//
// Replaces the TPU kernels _ray_mask_kernel (raytracer_tpu/ops/
// cluster_trace.py:305-352) and _ray_mask_kernel_hier (:242-302), both
// called by _ray_cluster_mask_tpu (:355).
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
//
// Hierarchical form (scenes above 512 cluster columns): the columns are
// cut into 128-cluster chunks, chunk j of tile i gated by the coarse bit
// sup[i*S + j] (the same slab test against the dilated union of the
// chunk's boxes, run before by the flat kernel).  The bit is uniform over
// the block, so the branch does not diverge; a chunk whose bit is 0 is
// written 0 / +inf.  Thread t owns column 128*j + t of chunk j, and only
// the C real columns of the last chunk are written (the TPU pads them
// with _BIG boxes).  Coarse miss implies fine miss (the slab chain is
// monotone in the box coordinates and the union is dilated), so the
// result equals the flat kernel's bit for bit.

#include "common.cuh"

namespace {

// Stage tile i's ray bundle [o*inv (3), t_hi, inv (3)] in shared memory.
__device__ __forceinline__ void load_bundle(float (*b)[RT_TILE],
                                            const float* bundle, int i, int r) {
  for (int k = 0; k < 7; ++k) b[k][threadIdx.x] = bundle[k * r + i * RT_TILE + threadIdx.x];
  __syncthreads();
}

// Slab test of the tile's 128 rays against cluster box cc: writes the
// OR of the hits and the least entry over the hitting rays (+inf: none).
__device__ __forceinline__ void slab_column(float (*b)[RT_TILE],
                                            const float* __restrict__ box,
                                            int c, int cc, int i,
                                            int* __restrict__ hit,
                                            float* __restrict__ ent) {
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
  hit[static_cast<size_t>(i) * c + cc] = any;
  ent[static_cast<size_t>(i) * c + cc] = emin;
}

__device__ __forceinline__ void miss_columns(int c, int c0, int c1, int i,
                                             int* __restrict__ hit,
                                             float* __restrict__ ent) {
  for (int cc = c0 + threadIdx.x; cc < c1; cc += blockDim.x) {
    hit[static_cast<size_t>(i) * c + cc] = 0;
    ent[static_cast<size_t>(i) * c + cc] = CUDART_INF_F;
  }
}

__global__ void __launch_bounds__(RT_TILE) ray_mask_kernel(
    const int* __restrict__ act, const float* __restrict__ box,
    const float* __restrict__ bundle, int* __restrict__ hit,
    float* __restrict__ ent, int c, int r) {
  __shared__ float b[7][RT_TILE];
  const int i = blockIdx.x;
  if (act[i] == 0) {
    miss_columns(c, 0, c, i, hit, ent);
    return;
  }
  load_bundle(b, bundle, i, r);
  for (int cc = threadIdx.x; cc < c; cc += blockDim.x) {
    slab_column(b, box, c, cc, i, hit, ent);
  }
}

__global__ void __launch_bounds__(RT_TILE) ray_mask_hier_kernel(
    const int* __restrict__ act, const int* __restrict__ sup,
    const float* __restrict__ box, const float* __restrict__ bundle,
    int* __restrict__ hit, float* __restrict__ ent, int c, int r) {
  __shared__ float b[7][RT_TILE];
  const int i = blockIdx.x;
  if (act[i] == 0) {
    miss_columns(c, 0, c, i, hit, ent);
    return;
  }
  load_bundle(b, bundle, i, r);
  const int n_chunks = (c + RT_CLUSTER - 1) / RT_CLUSTER;
  for (int j = 0; j < n_chunks; ++j) {
    const int c0 = j * RT_CLUSTER;
    const int c1 = min(c, c0 + RT_CLUSTER);
    if (sup[static_cast<size_t>(i) * n_chunks + j] == 0) {
      miss_columns(c, c0, c1, i, hit, ent);
    } else {
      for (int cc = c0 + threadIdx.x; cc < c1; cc += blockDim.x) {
        slab_column(b, box, c, cc, i, hit, ent);
      }
    }
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

extern "C" int rt_ray_mask_hier(const int* act, const int* sup,
                                const float* box, const float* bundle,
                                int* hit, float* ent, int nt, int c, int r,
                                void* stream) {
  if (nt > 0 && c > 0) {
    ray_mask_hier_kernel<<<nt, RT_TILE, 0, static_cast<cudaStream_t>(stream)>>>(
        act, sup, box, bundle, hit, ent, c, r);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
