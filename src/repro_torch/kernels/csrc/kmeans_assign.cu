// K-Means assignment on Hopper (sm_90a): for every point, the index and the
// value of the smallest squared distance to K centroids.
//
// Replaces the Pallas TPU kernel repro/kernels/kmeans/kernel.py
// (assign_pallas -> _assign_kernel), which tiles points into VMEM and forms
// the distance tile with an MXU matmul.
//
// What bounds it on the H100: at the streaming path's shapes (D = 3,
// K = 10) the work is 2*K*D = 60 FLOP per 20 bytes moved, far below the
// card's ~20 FLOP/byte f32 balance point, so it is bound by reading the
// points and writing label + distance. Wide cases (D = 128, K = 1024) turn
// it compute-bound on f32 FMAs.
//
// Design: one thread per point, the point's coordinates in registers (for
// D <= 128; re-read through L1 above that), the centroids and their squared
// norms staged in shared memory, in tiles of as many centroids as 48 KB
// hold, so any K and D run. Every thread of a block reads the same centroid
// word at the same time (a shared-memory broadcast). The distance keeps the
// reference's form, |p|^2 - 2 p.c + |c|^2 in f32, and the scan compares with
// a strict '<' in ascending centroid order, so the first index wins ties as
// jnp.argmin does. No padding: the TPU's 128-lane padding is not carried
// over, so no padded centroid exists that could win.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// MAXD > 0: the point lives in registers (D <= MAXD). MAXD == 0: any D, the
// point is re-read from global memory for every centroid.
template <typename T, int MAXD>
__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const T* __restrict__ points, const T* __restrict__ centroids,
                     int32_t* __restrict__ labels, float* __restrict__ dist,
                     int n, int k, int d, int tile_k) {
  extern __shared__ float smem[];
  float* c_tile = smem;                                   // tile_k x d
  float* c2_tile = smem + static_cast<size_t>(tile_k) * d;  // tile_k

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const T* p = points + (live ? i : 0) * d;

  float preg[MAXD > 0 ? MAXD : 1];
  float p2 = 0.f;
  if (live) {
    if constexpr (MAXD > 0) {
#pragma unroll
      for (int j = 0; j < MAXD; ++j) {
        preg[j] = j < d ? to_f32(p[j]) : 0.f;
        p2 += preg[j] * preg[j];
      }
    } else {
      for (int j = 0; j < d; ++j) {
        const float v = to_f32(p[j]);
        p2 += v * v;
      }
    }
  }

  float best = INFINITY;
  int best_k = 0;
  for (int k0 = 0; k0 < k; k0 += tile_k) {
    const int kt = min(tile_k, k - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < kt * d; idx += blockDim.x) {
      c_tile[idx] = to_f32(centroids[static_cast<long long>(k0) * d + idx]);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < kt; c += blockDim.x) {
      float c2 = 0.f;
      for (int j = 0; j < d; ++j) c2 += c_tile[c * d + j] * c_tile[c * d + j];
      c2_tile[c] = c2;
    }
    __syncthreads();
    if (!live) continue;
    for (int c = 0; c < kt; ++c) {
      const float* cc = c_tile + c * d;
      float cross = 0.f;
      if constexpr (MAXD > 0) {
#pragma unroll
        for (int j = 0; j < MAXD; ++j) {
          if (j < d) cross += preg[j] * cc[j];
        }
      } else {
        for (int j = 0; j < d; ++j) cross += to_f32(p[j]) * cc[j];
      }
      const float d2 = p2 - 2.f * cross + c2_tile[c];
      if (d2 < best) {
        best = d2;
        best_k = k0 + c;
      }
    }
  }
  if (live) {
    labels[i] = best_k;
    dist[i] = best;
  }
}

template <typename T, int MAXD>
void launch(const void* points, const void* centroids, void* labels, void* dist,
            int n, int k, int d, int tile_k, cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  const size_t smem = static_cast<size_t>(tile_k) * (d + 1) * sizeof(float);
  kmeans_assign_kernel<T, MAXD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(points), static_cast<const T*>(centroids),
      static_cast<int32_t*>(labels), static_cast<float*>(dist), n, k, d, tile_k);
}

template <typename T>
void launch_for_width(const void* points, const void* centroids, void* labels, void* dist,
                      int n, int k, int d, int tile_k, cudaStream_t stream) {
  if (d <= 4) {
    launch<T, 4>(points, centroids, labels, dist, n, k, d, tile_k, stream);
  } else if (d <= 16) {
    launch<T, 16>(points, centroids, labels, dist, n, k, d, tile_k, stream);
  } else if (d <= 32) {
    launch<T, 32>(points, centroids, labels, dist, n, k, d, tile_k, stream);
  } else if (d <= 64) {
    launch<T, 64>(points, centroids, labels, dist, n, k, d, tile_k, stream);
  } else if (d <= 128) {
    launch<T, 128>(points, centroids, labels, dist, n, k, d, tile_k, stream);
  } else {
    launch<T, 0>(points, centroids, labels, dist, n, k, d, tile_k, stream);
  }
}

}  // namespace

extern "C" {

// points (n, d) and centroids (k, d), row-major, f32 (dtype 0) or bf16
// (dtype 1); labels int32 (n,), dist f32 (n,). Returns cudaGetLastError().
int kmeans_assign(const void* points, const void* centroids, void* labels, void* dist,
                  int n, int k, int d, int dtype, void* stream) {
  if (n <= 0) return 0;
  const int tile_k = min(k, kSmemBytes / static_cast<int>((d + 1) * sizeof(float)));
  if (k < 1 || d < 1 || tile_k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_for_width<float>(points, centroids, labels, dist, n, k, d, tile_k, s);
  } else if (dtype == 1) {
    launch_for_width<__nv_bfloat16>(points, centroids, labels, dist, n, k, d, tile_k, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
