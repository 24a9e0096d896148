// K-Means assignment on Hopper (sm_90a): for every point, the index and the
// value of the smallest squared distance to K centroids.
//
// Replaces the Pallas TPU kernel repro/kernels/kmeans/kernel.py
// (assign_pallas -> _assign_kernel), which tiles points into VMEM and forms
// the distance tile with an MXU matmul.
//
// Every regime keeps the reference's form, d^2 = |p|^2 - 2 p.c + |c|^2 with
// |p|^2 and |c|^2 in f32, and the first index wins ties (as jnp.argmin): a
// scan in ascending centroid order with a strict '<', and merges that compare
// (d^2, index) lexicographically. No padded centroid exists that could win
// (the TPU's 1e30 padding is not carried over): centroids past K are masked.
//
// The caller (kernels/kmeans/ops.py, assign_plan) chooses one of four
// regimes and passes it with its tile sizes; the entry point checks them.
//
// narrow (D <= 16, K*D <= 1024; the stream's 3 x 10): 2KD = 60 FLOP per 20
//   bytes moved, far below the card's balance point, and at the stream's
//   80 000 points a launch of ~1.5 MB: bound by memory latency and by
//   issuing the scan, not by bytes. So nothing stands in a chain in front of
//   the FMAs that need not: a pair of lanes first puts its 4 consecutive
//   points in flight, straight into registers (16- or 8-byte loads where the
//   row width and the base allow, D a template constant; value by value
//   otherwise), then the block stages the K*D centroid words in shared
//   memory, each thread one centroid's row with its |c|^2 in the same pass,
//   and waits once. Each lane of the pair scans every other centroid (one
//   shared-memory broadcast feeds 4 FMAs); the pair merges (d^2, index) by
//   a shuffle, and one lane stores the 4 labels, the other the 4 distances,
//   16 bytes each. The grid is a few blocks per SM with a grid-stride loop,
//   so the centroids are staged once per block. Every d^2 is the first
//   port's to the bit: f32, dimensions in ascending order.
//
// wide (D >= 8, K >= 16, K*D >= 2048; 128 x 1024): 2NKD operations against N(D + 2)
//   words, so operations bound it, and the CUDA cores' f32 FMAs (67 TFLOP/s)
//   lose to the tensor cores. A fused distance GEMM + argmin on mma.sync: a
//   block owns 128 points and walks every tile of 128 centroids in chunks of
//   128 bytes of each row (32 f32 or 64 bf16 dimensions), staged by cp.async
//   in a ring of KM_WIDE_STAGES buffers, rows padded by 16 bytes so the
//   fragment loads (16 bytes a thread, dimensions permuted identically for
//   points and centroids) meet no bank conflicts. 8 warps of 64 x 32 outputs.
//   * bf16: one mma.sync.m16n8k16 per product, f32 accumulation; bf16 x bf16
//     products are exact in f32, as in the reference's upcast.
//   * f32: 3xTF32 on mma.sync.m16n8k8. Each value splits into hi =
//     tf32(x) (cvt.rna) and lo = tf32(x - hi); the cross term accumulates
//     a_lo b_hi + a_hi b_lo + a_hi b_hi in f32, small terms first. Dropping
//     lo*lo leaves ~2^-22 relative per product, far inside the check's
//     8 (D+2) 2^-24 (|p| + max|c|)^2; one-pass TF32 (2^-11 per product,
//     coherent on unlucky data) does not stay inside it
//     (tests/test_torch_kmeans.py emulates both).
//   * The epilogue works on the accumulator fragments: |p|^2 and |c|^2 are
//     summed in f32 from the staged rows (|c|^2 per centroid tile, by half
//     the threads while the other half sums |p|^2 on the first tile), each
//     row keeps a running (min, index), lanes of a fragment row merge by
//     shuffles and the 4 warps of a row through shared memory.
//   * Tails: dimensions past D and rows past N or K are zero-filled in
//     shared memory (adding exact zeros); centroids past K are masked out of
//     the min; rows past N are not stored. Rows whose bytes are not 16-byte
//     aligned are staged with plain loads instead of cp.async.
//   * mma.sync, not wgmma/TMA: simpler, and enough to beat cdist + min; the
//     warpgroup form is a later step (ROADMAP).
//
// generic (everything else, e.g. 300 x 5): the first port's kernel, unchanged:
//   one thread per point, the point in registers for D <= 128, centroids and
//   |c|^2 staged in shared memory in tiles of as many centroids as 48 KB hold.
//
// chunked (one centroid row does not fit 48 KB: D >= 12 288, e.g. D = 20 000
//   with K = 2 or 15, which wide does not take below K = 16): 4 points per
//   warp, the lanes striding over D (coalesced 128-byte runs of a row), tiles
//   of up to 16 centroids staged in chunks of D as f32; each lane keeps
//   running |p|^2, |c|^2 and p.c for its dimensions in registers, summed over
//   the warp by a fixed butterfly. Bound by the bytes of the points.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

// the narrow kernel's points per group of lanes, lanes per group and threads
// per block, and the wide kernel's ring of stages, bytes of a row per chunk and
// least blocks per SM: -D overrides for tools/tile_sweep.py
#ifndef KM_NARROW_PPT
#define KM_NARROW_PPT 4
#endif
#ifndef KM_NARROW_THREADS
#define KM_NARROW_THREADS 128
#endif
#ifndef KM_NARROW_KSPLIT
#define KM_NARROW_KSPLIT 2
#endif
#ifndef KM_WIDE_STAGES
#define KM_WIDE_STAGES 3
#endif
#ifndef KM_WIDE_CHUNK
#define KM_WIDE_CHUNK 128
#endif
#ifndef KM_WIDE_MIN_BLOCKS
#define KM_WIDE_MIN_BLOCKS 1
#endif

namespace {

enum Regime { kGeneric = 0, kNarrow = 1, kWide = 2, kChunked = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; zero-filled when bytes == 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

int sm_count() {  // of the current device; 0 if it cannot be read
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

__device__ __forceinline__ uint4 lds128(const unsigned char* p) {
  return *reinterpret_cast<const uint4*>(p);
}
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// (d, i) <- the lexicographically smaller of (d, i) and (od, oi)
__device__ __forceinline__ void take_min(float& d, int& i, float od, int oi) {
  if (od < d || (od == d && oi < i)) {
    d = od;
    i = oi;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// generic: the first port's kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;

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

// ---------------------------------------------------------------------------
// chunked: rows too long for one centroid to fit 48 KB
// ---------------------------------------------------------------------------

constexpr int kChunkedWarps = 8;
constexpr int kChunkedThreads = kChunkedWarps * 32;
constexpr int kChunkedPPW = 4;                                // points a warp takes
constexpr int kChunkedPoints = kChunkedWarps * kChunkedPPW;  // points a block takes
constexpr int kChunkedMaxK = 16;                              // centroids of a tile

// the sum of v over the warp by a fixed butterfly: every lane ends with the
// same bits (each step adds the same two values, in either order)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// A warp owns kChunkedPPW points; its lanes stride over D, so every point
// load is a coalesced 32-value run. A tile of up to kChunkedMaxK centroids
// is staged chunk_d dimensions at a time (tile_k x chunk_d f32 in shared
// memory); each lane keeps running |p|^2, |c|^2 and p.c over its dimensions
// in registers, and the warp sums them by a fixed butterfly at the end of
// the tile. d^2 = |p|^2 - 2 p.c + |c|^2, centroids scanned in ascending
// order with a strict '<' (first index wins ties; |c|^2 is the same bits
// for every point).
template <typename T>
__global__ void __launch_bounds__(kChunkedThreads)
assign_chunked(const T* __restrict__ points, const T* __restrict__ centroids,
               int32_t* __restrict__ labels, float* __restrict__ dist, int n, int k, int d,
               int tile_k, int chunk_d) {
  constexpr int P = kChunkedPPW, KT = kChunkedMaxK;
  extern __shared__ float c_chunk[];  // tile_k x chunk_d
  const int lane = threadIdx.x % 32;
  const long long p0 = static_cast<long long>(blockIdx.x) * kChunkedPoints +
                       (threadIdx.x / 32) * P;
  float best[P];
  int best_k[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    best[p] = INFINITY;
    best_k[p] = 0;
  }
  for (int k0 = 0; k0 < k; k0 += tile_k) {
    const int kt = min(tile_k, k - k0);
    float p2[P], cross[P][KT], c2[KT];
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      c2[c] = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) cross[p][c] = 0.f;
    }
#pragma unroll
    for (int p = 0; p < P; ++p) p2[p] = 0.f;
    for (int j0 = 0; j0 < d; j0 += chunk_d) {
      const int jt = min(chunk_d, d - j0);
      __syncthreads();  // the previous chunk is no longer read
      for (int c = 0; c < kt; ++c) {
        const T* src = centroids + static_cast<long long>(k0 + c) * d + j0;
        for (int j = threadIdx.x; j < jt; j += kChunkedThreads)
          c_chunk[c * chunk_d + j] = to_f32(src[j]);
      }
      __syncthreads();
#pragma unroll 2
      for (int j = lane; j < jt; j += 32) {
        float pv[P];
#pragma unroll
        for (int p = 0; p < P; ++p)
          pv[p] = p0 + p < n ? to_f32(points[(p0 + p) * d + j0 + j]) : 0.f;
#pragma unroll
        for (int p = 0; p < P; ++p) p2[p] += pv[p] * pv[p];
#pragma unroll
        for (int c = 0; c < KT; ++c) {
          if (c < kt) {
            const float cv = c_chunk[c * chunk_d + j];
            c2[c] += cv * cv;
#pragma unroll
            for (int p = 0; p < P; ++p) cross[p][c] += pv[p] * cv;
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < KT; ++c) c2[c] = warp_sum(c2[c]);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      p2[p] = warp_sum(p2[p]);
#pragma unroll
      for (int c = 0; c < KT; ++c) {
        if (c < kt) {
          const float d2 = p2[p] - 2.f * warp_sum(cross[p][c]) + c2[c];
          if (d2 < best[p]) {
            best[p] = d2;
            best_k[p] = k0 + c;
          }
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p0 + p < n) {
        labels[p0 + p] = best_k[p];
        dist[p0 + p] = best[p];
      }
    }
  }
}

template <typename T>
int launch_chunked(const void* points, const void* centroids, void* labels, void* dist, int n,
                   int k, int d, int tile_k, int chunk_d, cudaStream_t stream) {
  const dim3 grid((n + kChunkedPoints - 1) / kChunkedPoints);
  const size_t smem = static_cast<size_t>(tile_k) * chunk_d * sizeof(float);
  assign_chunked<T><<<grid, kChunkedThreads, smem, stream>>>(
      static_cast<const T*>(points), static_cast<const T*>(centroids),
      static_cast<int32_t*>(labels), static_cast<float*>(dist), n, k, d, tile_k, chunk_d);
  return 0;
}

// ---------------------------------------------------------------------------
// narrow: memory and latency
// ---------------------------------------------------------------------------

constexpr int kNarrowPPT = KM_NARROW_PPT;  // consecutive points a group of lanes takes
constexpr int kNarrowSplit = KM_NARROW_KSPLIT;  // lanes of a group, each every S-th centroid
constexpr int kNarrowThreads = KM_NARROW_THREADS;
constexpr int kNarrowGroups = kNarrowThreads / kNarrowSplit;  // groups of points per block
constexpr int kNarrowPoints = kNarrowPPT * kNarrowGroups;     // points a block takes per step
constexpr int kNarrowMaxD = 16;
constexpr int kNarrowMaxCD = 1024;  // centroid words staged in shared memory
constexpr int kNarrowBlocksPerSM = 4;  // the grid's most blocks per SM
static_assert(kNarrowThreads % 32 == 0 && 32 % kNarrowSplit == 0, "narrow blocks are whole warps");

// the widest load (16 or 8 bytes; 0: none) of which a thread's P points of
// exactly D values are whole words
template <typename T, int D>
constexpr int kNarrowVec = (kNarrowPPT * D * sizeof(T)) % 16 == 0  ? 16
                           : (kNarrowPPT * D * sizeof(T)) % 8 == 0 ? 8
                                                                   : 0;

// element e of T values packed in 32-bit words, as f32 (bf16 -> f32 is a
// 16-bit shift); e is a constant once the loops are unrolled
template <typename T>
__device__ __forceinline__ float packed(const uint32_t* rw, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(rw[e]);
  } else {
    const uint32_t w = rw[e / 2];
    return __uint_as_float(e % 2 ? (w & 0xffff0000u) : (w << 16));
  }
}
__device__ __forceinline__ uint32_t bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// VEC (16 or 8): D is exact and a thread's P points are whole VEC-byte words
// of an aligned base, loaded as such into registers (the last thread's, past
// N, 4 bytes at a time). VEC 0: D is an upper bound of the runtime d and
// every value is its own load.
template <typename T, int D, int VEC>
__global__ void __launch_bounds__(kNarrowThreads)
assign_narrow(const T* __restrict__ points, const T* __restrict__ centroids,
              int32_t* __restrict__ labels, float* __restrict__ dist, int n, int k, int d) {
  constexpr int P = kNarrowPPT, S = kNarrowSplit;
  constexpr int NW = VEC ? P * D * static_cast<int>(sizeof(T)) / 4 : 1;  // 32-bit words
  extern __shared__ float smem[];
  float* cs = smem;          // k x d
  float* c2s = smem + k * d;  // k
  const int tid = threadIdx.x;
  const int s = tid % S;  // this lane scans centroids s, s + S, ...
  const long long groups = (static_cast<long long>(n) + P - 1) / P;
  const long long stride = static_cast<long long>(gridDim.x) * kNarrowGroups;
  // the block's first group; the lanes of a group load the same points
  long long g0 = static_cast<long long>(blockIdx.x) * kNarrowGroups;

  uint32_t rw[NW];                                 // VEC: the points as loaded
  T xr[VEC ? 1 : P][VEC ? 1 : D];                   // otherwise: value by value
  auto load = [&](long long grp) {
    const long long i0 = grp * P;
    if constexpr (VEC) {
      const T* src = points + i0 * D;
      if (i0 + P <= n) {
        if constexpr (VEC == 16) {
#pragma unroll
          for (int q = 0; q < NW / 4; ++q) {
            const uint4 v = reinterpret_cast<const uint4*>(src)[q];
            rw[4 * q] = v.x, rw[4 * q + 1] = v.y, rw[4 * q + 2] = v.z, rw[4 * q + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int q = 0; q < NW / 2; ++q) {
            const uint2 v = reinterpret_cast<const uint2*>(src)[q];
            rw[2 * q] = v.x, rw[2 * q + 1] = v.y;
          }
        }
      } else {
#pragma unroll
        for (int m = 0; m < NW; ++m) {  // 32-bit words, the values past N zero
          uint32_t w;
          if constexpr (sizeof(T) == 4) {
            w = i0 + m / D < n ? bits(src[m]) : 0u;
          } else {
            const uint32_t lo = i0 + (2 * m) / D < n ? bits(src[2 * m]) : 0u;
            const uint32_t hi = i0 + (2 * m + 1) / D < n ? bits(src[2 * m + 1]) : 0u;
            w = lo | (hi << 16);
          }
          rw[m] = w;
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int j = 0; j < D; ++j)
          xr[p][j] = j < d && i0 + p < n ? points[(i0 + p) * d + j] : T(0.f);
    }
  };

  if (g0 + tid / S < groups) load(g0 + tid / S);  // the thread's first points in flight
  // centroids in the same pass as |c|^2; the arithmetic of the generic kernel
  for (int c = tid; c < k; c += kNarrowThreads) {
    float c2 = 0.f;
    for (int j = 0; j < d; ++j) {
      const float v = to_f32(centroids[c * d + j]);
      cs[c * d + j] = v;
      c2 += v * v;
    }
    c2s[c] = c2;
  }
  __syncthreads();

  for (; g0 < groups; g0 += stride) {  // the same steps for every lane: shuffles below
    const long long g = g0 + tid / S;
    float x[P][D], p2[P], best[P];
    int bk[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      p2[p] = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        if constexpr (VEC) {
          x[p][j] = packed<T>(rw, p * D + j);
        } else {
          x[p][j] = to_f32(xr[p][j]);
        }
        p2[p] += x[p][j] * x[p][j];
      }
      best[p] = INFINITY;
      bk[p] = 0;
    }
    const long long i0 = g * P;
    if (g + stride < groups) load(g + stride);  // the next points in flight during the scan
#pragma unroll 2
    for (int c = s; c < k; c += S) {  // d^2 of the P points, in the generic kernel's order
      const float* cc = cs + c * d;
      float cross[P];
#pragma unroll
      for (int p = 0; p < P; ++p) cross[p] = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        if (VEC || j < d) {
          const float v = cc[j];
#pragma unroll
          for (int p = 0; p < P; ++p) cross[p] += x[p][j] * v;
        }
      }
      const float c2 = c2s[c];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float d2 = p2[p] - 2.f * cross[p] + c2;
        if (d2 < best[p]) {
          best[p] = d2;
          bk[p] = c;
        }
      }
    }
    // the group's lanes merge (d^2, index) lexicographically: the first
    // index of the smallest d^2 wins, as in one ascending scan
#pragma unroll
    for (int off = 1; off < S; off <<= 1)
#pragma unroll
      for (int p = 0; p < P; ++p)
        take_min(best[p], bk[p], __shfl_xor_sync(0xffffffffu, best[p], off),
                 __shfl_xor_sync(0xffffffffu, bk[p], off));
    if (g >= groups) continue;
    if constexpr (P % 4 == 0) {
      if (i0 + P <= n) {  // lane 0 stores the labels, lane 1 (or 0) the distances
#pragma unroll
        for (int q = 0; q < P / 4; ++q) {
          if (s == 0)
            reinterpret_cast<int4*>(labels + i0)[q] =
                make_int4(bk[4 * q], bk[4 * q + 1], bk[4 * q + 2], bk[4 * q + 3]);
          if (s == (S > 1 ? 1 : 0))
            reinterpret_cast<float4*>(dist + i0)[q] =
                make_float4(best[4 * q], best[4 * q + 1], best[4 * q + 2], best[4 * q + 3]);
        }
        continue;
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (s == 0 && i0 + p < n) {
        labels[i0 + p] = bk[p];
        dist[i0 + p] = best[p];
      }
    }
  }
}

template <typename T, int D, int VEC>
int launch_narrow_as(const void* points, const void* centroids, void* labels, void* dist, int n,
                     int k, int d, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(k) * (d + 1) * sizeof(float);
  const long long groups = (static_cast<long long>(n) + kNarrowPPT - 1) / kNarrowPPT;
  const long long blocks = (groups + kNarrowGroups - 1) / kNarrowGroups;
  const int grid = static_cast<int>(
      std::min(blocks, static_cast<long long>(std::max(sm_count(), 1)) * kNarrowBlocksPerSM));
  assign_narrow<T, D, VEC><<<grid, kNarrowThreads, smem, stream>>>(
      static_cast<const T*>(points), static_cast<const T*>(centroids),
      static_cast<int32_t*>(labels), static_cast<float*>(dist), n, k, d);
  return 0;
}

// d == D: 16- or 8-byte loads where the shape and the base allow, else value
// by value with D rounded up to 4, 8 or 16
template <typename T, int D>
int launch_narrow(const void* points, const void* centroids, void* labels, void* dist, int n,
                  int k, int d, cudaStream_t stream) {
  if constexpr (D > kNarrowMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (d != D) return launch_narrow<T, D + 1>(points, centroids, labels, dist, n, k, d, stream);
    constexpr int VEC = kNarrowVec<T, D>;
    if constexpr (VEC > 0) {
      if ((reinterpret_cast<uintptr_t>(points) & (VEC - 1)) == 0)
        return launch_narrow_as<T, D, VEC>(points, centroids, labels, dist, n, k, d, stream);
    }
    constexpr int MAXD = D <= 4 ? 4 : D <= 8 ? 8 : 16;
    return launch_narrow_as<T, MAXD, 0>(points, centroids, labels, dist, n, k, d, stream);
  }
}

// ---------------------------------------------------------------------------
// wide: a fused distance GEMM + argmin on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWideRows = 128;     // points per block
constexpr int kWideCols = 128;     // centroids per tile
constexpr int kWideThreads = 256;  // 8 warps: 2 along the points x 4 along the centroids
constexpr int kChunk = KM_WIDE_CHUNK;  // bytes of a row per staged chunk
constexpr int kRowStride = kChunk + 16;  // bytes per staged row, padded
constexpr int kStages = KM_WIDE_STAGES;
constexpr int kStageBytes = (kWideRows + kWideCols) * kRowStride;
// the ring, |p|^2 and |c|^2, and the 4 column warps' (d^2, index) per row
constexpr int kWideSmem = kStages * kStageBytes + (kWideRows + kWideCols) * 4 + 4 * kWideRows * 8;
static_assert(kStages >= 2 && kChunk % 128 == 0, "the ring needs two stages of whole k-steps");

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x -> hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  const float f = __uint_as_float(x);
  hi = tf32_rna(f);
  lo = tf32_rna(f - __uint_as_float(hi));
}

// c += a (16x8, row) * b (8x8, col); tf32 operands, f32 accumulator
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a (16x16, row) * b (16x8, col); bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


// the f32 sum of squares of a staged row's chunk, in ascending dimension
// order (zeros past D add nothing); 16-byte loads
template <typename T>
__device__ __forceinline__ float row_sq(const unsigned char* row) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < kChunk / 16; ++q) {
    const uint4 v = lds128(row + 16 * q);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t x = word(v, w);
      if constexpr (sizeof(T) == 4) {
        const float f = __uint_as_float(x);
        s += f * f;
      } else {  // two bf16, low half first: bf16 -> f32 is a 16-bit shift
        const float lo = __uint_as_float(x << 16), hi = __uint_as_float(x & 0xffff0000u);
        s += lo * lo;
        s += hi * hi;
      }
    }
  }
  return s;
}


// Fragments: every 128 bytes of a staged row are 4 k-steps (8 f32 or 16
// bf16 dimensions each), which take the bytes in an order that is the same
// for points and centroids, so the sum over dimensions is unchanged: thread
// t (lane % 4) of a quad owns bytes [32 t, 32 t + 32) of them and loads them
// as two 16-byte words h = 0, 1; k-step 2 h + u takes 32-bit words 2 u and
// 2 u + 1 of word h as its two operand registers (f32: the dimensions the
// mma shape calls t and t + 4; bf16: the pairs it calls 2t, 2t+1 and 2t+8,
// 2t+9).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kWideThreads, KM_WIDE_MIN_BLOCKS)
assign_wide(const T* __restrict__ points, const T* __restrict__ centroids,
            int32_t* __restrict__ labels, float* __restrict__ dist, int n, int k, int d) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int EPC = kChunk / sizeof(T);  // dimensions per chunk
  constexpr int EPV = 16 / sizeof(T);      // dimensions per 16 bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* p2s = reinterpret_cast<float*>(smem_raw + kStages * kStageBytes);
  float* c2s = p2s + kWideRows;
  float* md = c2s + kWideCols;                              // [4][kWideRows] d^2
  int* mi = reinterpret_cast<int*>(md + 4 * kWideRows);    // [4][kWideRows] index

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2;  // the warp's 64 points
  const int wn = warp & 3;   // the warp's 32 centroids of a tile
  const long long row0 = static_cast<long long>(blockIdx.x) * kWideRows;
  const int n_chunks = (d + EPC - 1) / EPC;
  const int n_tiles = (k + kWideCols - 1) / kWideCols;
  const int n_iters = n_tiles * n_chunks;

  // chunk `it` (centroid tile it / n_chunks, dimension chunk it % n_chunks)
  // of the points and of the centroids into stage `it % kStages`
  auto load = [&](int it) {
    unsigned char* st = smem_raw + (it % kStages) * kStageBytes;
    const int c0 = (it / n_chunks) * kWideCols;
    const int e0 = (it % n_chunks) * EPC;
    if constexpr (VEC) {
#pragma unroll
      for (int j = 0; j < (kWideRows + kWideCols) * (kChunk / 16) / kWideThreads; ++j) {
        const int piece = tid + j * kWideThreads;
        const int r = piece / (kChunk / 16), q = piece % (kChunk / 16);
        const int e = e0 + q * EPV;
        const T* src = points;
        int bytes = 0;
        if (r < kWideRows) {
          if (row0 + r < n && e < d) {
            src = points + (row0 + r) * d + e;
            bytes = 16;
          }
        } else if (c0 + r - kWideRows < k && e < d) {
          src = centroids + static_cast<long long>(c0 + r - kWideRows) * d + e;
          bytes = 16;
        }
        cp_async16(st + r * kRowStride + q * 16, src, bytes);
      }
    } else {
      for (int x = tid; x < (kWideRows + kWideCols) * EPC; x += kWideThreads) {
        const int r = x / EPC, e = e0 + x % EPC;
        T v = T(0.f);
        if (r < kWideRows) {
          if (row0 + r < n && e < d) v = points[(row0 + r) * d + e];
        } else if (c0 + r - kWideRows < k && e < d) {
          v = centroids[static_cast<long long>(c0 + r - kWideRows) * d + e];
        }
        reinterpret_cast<T*>(st + r * kRowStride)[x % EPC] = v;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_iters) load(s);
    cp_async_commit();
  }

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  float best[4][2];
  int bidx[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i][0] = best[i][1] = INFINITY;
    bidx[i][0] = bidx[i][1] = 0;
  }
  float sq = 0.f;  // threads < 128: |c|^2 of centroid tid; others: |p|^2 of point tid - 128

  for (int it = 0; it < n_iters; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk `it` has landed, and chunk it - 1 is no longer read
    if (it + kStages - 1 < n_iters) load(it + kStages - 1);
    cp_async_commit();

    const unsigned char* sa = smem_raw + (it % kStages) * kStageBytes;
    const unsigned char* sb = sa + kWideRows * kRowStride;
    const int tile = it / n_chunks;
    const bool last_chunk = it % n_chunks == n_chunks - 1;
    if (tid < kWideCols) {
      sq += row_sq<T>(sb + tid * kRowStride);
    } else if (tile == 0) {
      sq += row_sq<T>(sa + (tid - kWideCols) * kRowStride);
    }

#pragma unroll
    for (int h = 0; h < 2 * kChunk / 128; ++h) {  // 128 bytes of each row per pair of h
      const int off = 128 * (h / 2) + 32 * t + 16 * (h % 2);
      uint4 av[4][2], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          av[i][r] = lds128(sa + (wm * 64 + i * 16 + g + 8 * r) * kRowStride + off);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = lds128(sb + (wn * 32 + j * 8 + g) * kRowStride + off);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if constexpr (kF32) {
          uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            split_tf32(word(av[i][0], 2 * u), ah[i][0], al[i][0]);
            split_tf32(word(av[i][1], 2 * u), ah[i][1], al[i][1]);
            split_tf32(word(av[i][0], 2 * u + 1), ah[i][2], al[i][2]);
            split_tf32(word(av[i][1], 2 * u + 1), ah[i][3], al[i][3]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            split_tf32(word(bv[j], 2 * u), bh[j][0], bl[j][0]);
            split_tf32(word(bv[j], 2 * u + 1), bh[j][1], bl[j][1]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {  // small terms first
              mma_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
              mma_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
              mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
            }
        } else {
          uint32_t a[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i][0] = word(av[i][0], 2 * u);
            a[i][1] = word(av[i][1], 2 * u);
            a[i][2] = word(av[i][0], 2 * u + 1);
            a[i][3] = word(av[i][1], 2 * u + 1);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_bf16(acc[i][j], a[i], word(bv[j], 2 * u), word(bv[j], 2 * u + 1));
        }
      }
    }

    if (!last_chunk) continue;
    // the tile's epilogue: d^2 from the fragments, running (min, index) per row
    if (tid < kWideCols) {
      c2s[tid] = sq;
      sq = 0.f;
    } else if (tile == 0) {
      p2s[tid - kWideCols] = sq;
    }
    __syncthreads();
    const int c0 = tile * kWideCols + wn * 32;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float pa = p2s[wm * 64 + i * 16 + g];
      const float pb = p2s[wm * 64 + i * 16 + g + 8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = wn * 32 + j * 8 + 2 * t + e;
          const int col = c0 + j * 8 + 2 * t + e;
          const float c2 = c2s[cl];
          const float da = pa - 2.f * acc[i][j][e] + c2;
          const float db = pb - 2.f * acc[i][j][2 + e] + c2;
          if (col < k && da < best[i][0]) {
            best[i][0] = da;
            bidx[i][0] = col;
          }
          if (col < k && db < best[i][1]) {
            best[i][1] = db;
            bidx[i][1] = col;
          }
        }
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
      }
    }
  }

  // the quad's lanes share rows; then the 4 column warps of a row
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, best[i][r], off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx[i][r], off);
        take_min(best[i][r], bidx[i][r], od, oi);
      }
      if (t == 0) {
        const int row = wm * 64 + i * 16 + g + 8 * r;
        md[wn * kWideRows + row] = best[i][r];
        mi[wn * kWideRows + row] = bidx[i][r];
      }
    }
  __syncthreads();
  if (tid < kWideRows && row0 + tid < n) {
    float bd = md[tid];
    int bi = mi[tid];
#pragma unroll
    for (int w = 1; w < 4; ++w) take_min(bd, bi, md[w * kWideRows + tid], mi[w * kWideRows + tid]);
    labels[row0 + tid] = bi;
    dist[row0 + tid] = bd;
  }
}

template <typename T, bool VEC>
int launch_wide_as(const void* points, const void* centroids, void* labels, void* dist, int n,
                   int k, int d, cudaStream_t stream) {
  const cudaError_t err = allow_smem(assign_wide<T, VEC>, kWideSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (static_cast<long long>(n) + kWideRows - 1) / kWideRows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  assign_wide<T, VEC><<<static_cast<unsigned>(blocks), kWideThreads, kWideSmem, stream>>>(
      static_cast<const T*>(points), static_cast<const T*>(centroids),
      static_cast<int32_t*>(labels), static_cast<float*>(dist), n, k, d);
  return 0;
}

template <typename T>
int launch_wide(const void* points, const void* centroids, void* labels, void* dist, int n,
                int k, int d, cudaStream_t stream) {
  if (aligned16(points) && aligned16(centroids) && (static_cast<size_t>(d) * sizeof(T)) % 16 == 0)
    return launch_wide_as<T, true>(points, centroids, labels, dist, n, k, d, stream);
  return launch_wide_as<T, false>(points, centroids, labels, dist, n, k, d, stream);
}

template <typename T>
int launch_regime(const void* points, const void* centroids, void* labels, void* dist, int n,
                  int k, int d, int regime, int tile_n, int tile_k, int chunk_d,
                  cudaStream_t s) {
  switch (regime) {
    case kGeneric:
      if (tile_n != kThreads || tile_k < 1 || tile_k > k ||
          static_cast<long long>(tile_k) * (d + 1) * sizeof(float) > kSmemBytes)
        return static_cast<int>(cudaErrorInvalidValue);
      launch_for_width<T>(points, centroids, labels, dist, n, k, d, tile_k, s);
      return 0;
    case kNarrow:
      if (tile_n != kNarrowPoints || tile_k != k || d > kNarrowMaxD ||
          static_cast<long long>(k) * d > kNarrowMaxCD || !aligned16(labels) || !aligned16(dist))
        return static_cast<int>(cudaErrorInvalidValue);
      return launch_narrow<T, 1>(points, centroids, labels, dist, n, k, d, s);
    case kWide:
      if (tile_n != kWideRows || tile_k != kWideCols) return static_cast<int>(cudaErrorInvalidValue);
      return launch_wide<T>(points, centroids, labels, dist, n, k, d, s);
    case kChunked:
      if (tile_n != kChunkedPoints || tile_k < 1 || tile_k > k || tile_k > kChunkedMaxK ||
          chunk_d < 1 || chunk_d > d ||
          static_cast<long long>(tile_k) * chunk_d * sizeof(float) > kSmemBytes)
        return static_cast<int>(cudaErrorInvalidValue);
      return launch_chunked<T>(points, centroids, labels, dist, n, k, d, tile_k, chunk_d, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// points (n, d) and centroids (k, d), row-major, f32 (dtype 0) or bf16
// (dtype 1); labels int32 (n,), dist f32 (n,). `regime` (0 generic, 1
// narrow, 2 wide, 3 chunked) with the points a block takes at a time
// (`tile_n`), the centroids it stages at once (`tile_k`) and, chunked, the
// dimensions it stages at once (`chunk_d`; the other regimes' builds fix
// theirs), as kernels/kmeans/ops.py assign_plan chooses them; a regime or
// tile this build does not take is refused. Returns cudaGetLastError() (or
// the refusal's code).
int kmeans_assign(const void* points, const void* centroids, void* labels, void* dist,
                  int n, int k, int d, int dtype, int regime, int tile_n, int tile_k,
                  int chunk_d, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = launch_regime<float>(points, centroids, labels, dist, n, k, d, regime, tile_n, tile_k,
                               chunk_d, s);
  } else if (dtype == 1) {
    err = launch_regime<__nv_bfloat16>(points, centroids, labels, dist, n, k, d, regime, tile_n,
                                       tile_k, chunk_d, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
