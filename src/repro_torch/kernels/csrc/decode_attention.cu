// One-token (decode) GQA attention over a KV cache on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/attention/decode_kernel.py
// (decode_attention_pallas -> _decode_kernel): per (sequence, KV head) an
// online softmax over block_kv-sized cache chunks that stops at the first
// chunk past the sequence's position, f32 accumulation, output in v's dtype.
//
// What bounds it on the H100: every live K and V entry is read once and used
// for G = H / KV query rows (2 G flop per element), far below the card's
// ~295 flop/byte balance point, so it is bound by the bytes of the live cache
// entries. At the serving path's shapes (a few rows, a few hundred entries of
// 3 x 64 bf16 each) a launch moves well under a megabyte and is bound by
// launch and memory latency rather than bandwidth.
//
// Design: one block of 4 warps per (row b, KV head, group of up to GMAX of
// that head's query rows). The block holds its query rows, scaled by
// 1/sqrt(hd) in f32, in registers, sliced across the lanes that share one
// key: each lane owns a 16-byte slice of the head dim (8 bf16 or 4 f32), so
// a key row is read by hd/8 (bf16) neighbouring lanes with 16-byte loads,
// and a warp walks 32/(hd/8) keys at a time. The loop stops at min(pos + 1,
// S) entries: the early exit of the TPU kernel at key granularity, with the
// ragged edge masked and no S % block_kv requirement; pos >= S makes every
// entry valid. Each lane group keeps (m, l, acc) per query row; the groups
// of a warp merge with shuffles and the warps through shared memory, by the
// log-sum-exp rule. The output is acc / max(l, 1e-30).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int32_t* __restrict__ pos,
                        T* __restrict__ out, int S, int H, int KV, float scale) {
  constexpr int EPL = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte load
  constexpr int LPK = HD / EPL;                           // lanes per key row
  constexpr int KPW = 32 / LPK;                           // keys per warp step
  static_assert(HD % EPL == 0 && LPK >= 1 && LPK <= 32 && 32 % LPK == 0, "head dim");

  __shared__ float sm_m[kWarps][GMAX];
  __shared__ float sm_l[kWarps][GMAX];
  __shared__ float sm_acc[kWarps][GMAX][HD];

  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int G = H / KV;
  const int g0 = blockIdx.z * GMAX;
  const int ng = min(GMAX, G - g0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPK;   // which of the warp's KPW keys
  const int part = lane % LPK;  // which 16-byte slice of the row
  const int d0 = part * EPL;

  float qr[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    float tmp[EPL];
    if (g < ng) {
      load16(q + (static_cast<size_t>(b) * H + kvh * G + g0 + g) * HD + d0, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = tmp[e] * scale;
  }

  // entries <= pos are valid: n = pos + 1, all S once pos >= S
  const int n = min(pos[b] + 1, S);

  float m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  const size_t row_stride = static_cast<size_t>(KV) * HD;
  const T* kb = k + static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(kvh) * HD + d0;
  const T* vb = v + static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(kvh) * HD + d0;

  // the loop bound is uniform across the warp, so the shuffles below see
  // every lane; lanes past the ragged edge take no part in the softmax
  for (int jb = warp * KPW; jb < n; jb += kWarps * KPW) {
    const int j = jb + sub;
    const bool valid = j < n;
    float kf[EPL], vf[EPL];
    if (valid) {
      load16(kb + static_cast<size_t>(j) * row_stride, kf);
      load16(vb + static_cast<size_t>(j) * row_stride, vf);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[e] = vf[e] = 0.f;
    }
    float s[GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) dot = fmaf(qr[g][e], kf[e], dot);
      s[g] = dot;
    }
#pragma unroll
    for (int off = LPK / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
    }
    if (valid) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float mn = fmaxf(m[g], s[g]);
        const float alpha = expf(m[g] - mn);
        const float p = expf(s[g] - mn);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = acc[g][e] * alpha + p * vf[e];
        m[g] = mn;
      }
    }
  }

  // merge the KPW key groups of the warp (lanes that share a slice)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn);
      const float bo = expf(mo - mn);
      l[g] = l[g] * a + lo * bo;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + ao * bo;
      }
      m[g] = mn;
    }
  }

  // merge the warps through shared memory
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
      if (part == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < ng * HD; idx += blockDim.x) {
    const int g = idx / HD;
    const int d = idx % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * f;
      asum += sm_acc[w][g][d] * f;
    }
    store(out + (static_cast<size_t>(b) * H + kvh * G + g0 + g) * HD + d, asum / fmaxf(lsum, 1e-30f));
  }
}

template <typename T, int HD, int GMAX>
void launch(const void* q, const void* k, const void* v, const void* pos, void* out,
            int B, int S, int H, int KV, cudaStream_t stream) {
  const int G = H / KV;
  const dim3 grid(B, KV, (G + GMAX - 1) / GMAX);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  decode_attention_kernel<T, HD, GMAX><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(pos), static_cast<T*>(out), S, H, KV, scale);
}

// the query rows of a KV head go GMAX to a block: 1, 2, 4 or 8 (more than 8
// split over blockIdx.z)
template <typename T, int HD>
void launch_group(const void* q, const void* k, const void* v, const void* pos, void* out,
                  int B, int S, int H, int KV, cudaStream_t stream) {
  const int G = H / KV;
  if (G <= 1) {
    launch<T, HD, 1>(q, k, v, pos, out, B, S, H, KV, stream);
  } else if (G <= 2) {
    launch<T, HD, 2>(q, k, v, pos, out, B, S, H, KV, stream);
  } else if (G <= 4) {
    launch<T, HD, 4>(q, k, v, pos, out, B, S, H, KV, stream);
  } else {
    launch<T, HD, 8>(q, k, v, pos, out, B, S, H, KV, stream);
  }
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, const void* pos, void* out,
              int B, int S, int H, int KV, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: launch_group<T, 32>(q, k, v, pos, out, B, S, H, KV, stream); break;
    case 64: launch_group<T, 64>(q, k, v, pos, out, B, S, H, KV, stream); break;
    case 128: launch_group<T, 128>(q, k, v, pos, out, B, S, H, KV, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

extern "C" {

// q (B, 1, H, hd); k, v (B, S, KV, hd); pos (B,) int32 >= 0; out (B, 1, H, hd).
// All contiguous, 16-byte aligned, f32 (dtype 0) or bf16 (dtype 1).
// Returns cudaGetLastError().
int decode_attention(const void* q, const void* k, const void* v, const void* pos, void* out,
                     int B, int S, int H, int KV, int hd, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || KV < 1 || H < KV || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = launch_hd<float>(q, k, v, pos, out, B, S, H, KV, hd, s);
  } else if (dtype == 1) {
    err = launch_hd<__nv_bfloat16>(q, k, v, pos, out, B, S, H, KV, hd, s);
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
