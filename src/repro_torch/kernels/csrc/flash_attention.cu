// Causal / non-causal GQA flash attention (prefill) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/attention/kernel.py
// (flash_attention_pallas -> _flash_kernel): per (batch, query head, query
// block) an online softmax over KV chunks, causal programs stopping after
// the chunk that holds their last query row, f32 accumulation, output in
// q's dtype. It computes what the model's prefill computes
// (repro/models/attention.py blockwise_attention).
//
// What bounds it on the H100: 4 hd flop per (query, key) pair against
// 2 hd bytes of K and V per key, so at prefill lengths of a few hundred
// tokens and more the work is operations, not bytes. This first version
// does its products on the CUDA cores in f32 (67 TFLOP/s peak, not the
// 989 TFLOP/s of the bf16 tensor cores); wgmma, TMA and warp specialisation
// are later work. In exchange P stays in f32, as in the TPU kernel, and the
// result differs from the plain version only by the order of f32 sums.
//
// Design: one block of 128 threads per (64 query rows, query head, batch
// row); two threads per query row, each owning half of the head dim, its
// half of the scaled query row and its half of the f32 accumulator in
// registers. The KV head's K and V (h / G) are staged through shared memory
// in tiles of 4096 / hd keys, converted to f32 (16 KB per tile each; the two
// halves of a row are padded 4 floats apart so the two threads of a row read
// different banks). Each thread computes its half of a score with float4
// reads that the warp's 16 rows share (a broadcast), adds the other half with
// one shuffle, and updates the online softmax once per 16 keys. Causal blocks
// stop at the tile holding their last row; inside a tile, keys past the row
// (q_pos >= k_pos, both counted from 0) and past Skv are masked, and rows
// past Sq compute but write nothing, so any Sq and Skv run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = kThreads / 2;  // query rows per block
constexpr int kChunk = 16;           // keys per online-softmax update
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

__device__ __forceinline__ void store16(float* p, const float (&in)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float (&in)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int Sq, int Skv, int H, int KV, int causal, float scale) {
  constexpr int EPL = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte load
  constexpr int HALF = HD / 2;                           // head-dim share of one thread
  constexpr int TILE = 4096 / HD;                        // keys per shared-memory tile
  constexpr int ROW = HD + 8;                            // smem floats per key row
  constexpr int CPR = HD / EPL;                          // 16-byte chunks per key row
  static_assert(HALF % EPL == 0 && HALF % 4 == 0 && TILE % kChunk == 0, "head dim");

  __shared__ __align__(16) float ks[TILE * ROW];
  __shared__ __align__(16) float vs[TILE * ROW];

  const int b = blockIdx.z;
  const int hh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int kvh = hh / (H / KV);
  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int row = q0 + (tid >> 1);
  const bool live = row < Sq;

  float qr[HALF], acc[HALF];
  const T* qp = q + ((static_cast<size_t>(b) * Sq + row) * H + hh) * HD + half * HALF;
#pragma unroll
  for (int c = 0; c < HALF; c += EPL) {
    float tmp[EPL];
    if (live) {
      load16(qp + c, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qr[c + e] = tmp[e] * scale;
      acc[c + e] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  // keys the block needs: a causal block stops after its last row
  const int last = min(q0 + kRows, Sq) - 1;
  const int n_keys = causal ? min(last + 1, Skv) : Skv;
  const int row_last = causal ? row : Skv - 1;  // last key this row sees
  const size_t krow = static_cast<size_t>(KV) * HD;
  const T* kbase = k + static_cast<size_t>(b) * Skv * krow + static_cast<size_t>(kvh) * HD;
  const T* vbase = v + static_cast<size_t>(b) * Skv * krow + static_cast<size_t>(kvh) * HD;
  const int my = half * (HALF + 4);  // this thread's half of a smem row

  for (int t0 = 0; t0 < n_keys; t0 += TILE) {
    const int nt = min(TILE, n_keys - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int c = tid; c < TILE * CPR; c += kThreads) {
      const int j = c / CPR;
      const int d = (c % CPR) * EPL;
      float kf[EPL], vf[EPL];
      if (j < nt) {
        load16(kbase + static_cast<size_t>(t0 + j) * krow + d, kf);
        load16(vbase + static_cast<size_t>(t0 + j) * krow + d, vf);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[e] = vf[e] = 0.f;
      }
      const int so = j * ROW + (d < HALF ? d : d + 4);
#pragma unroll
      for (int e = 0; e < EPL; e += 4) {
        *reinterpret_cast<float4*>(ks + so + e) = make_float4(kf[e], kf[e + 1], kf[e + 2], kf[e + 3]);
        *reinterpret_cast<float4*>(vs + so + e) = make_float4(vf[e], vf[e + 1], vf[e + 2], vf[e + 3]);
      }
    }
    __syncthreads();

    for (int c0 = 0; c0 < nt; c0 += kChunk) {
      float s[kChunk];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* kr = ks + (c0 + jj) * ROW + my;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HALF; d += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + d);
          dot = fmaf(qr[d], k4.x, dot);
          dot = fmaf(qr[d + 1], k4.y, dot);
          dot = fmaf(qr[d + 2], k4.z, dot);
          dot = fmaf(qr[d + 3], k4.w, dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        const int key = t0 + c0 + jj;
        s[jj] = (c0 + jj < nt && key <= row_last) ? dot : -INFINITY;
        mx = fmaxf(mx, s[jj]);
      }
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < HALF; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(s[jj] - mx);  // 0 for a masked key
        l += p;
        const float* vr = vs + (c0 + jj) * ROW + my;
#pragma unroll
        for (int d = 0; d < HALF; d += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vr + d);
          acc[d] = fmaf(p, v4.x, acc[d]);
          acc[d + 1] = fmaf(p, v4.y, acc[d + 1]);
          acc[d + 2] = fmaf(p, v4.z, acc[d + 2]);
          acc[d + 3] = fmaf(p, v4.w, acc[d + 3]);
        }
      }
      m = mx;
    }
  }

  if (!live) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* op = out + ((static_cast<size_t>(b) * Sq + row) * H + hh) * HD + half * HALF;
#pragma unroll
  for (int c = 0; c < HALF; c += EPL) {
    float tmp[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) tmp[e] = acc[c + e] * inv;
    store16(op + c, tmp);
  }
}

template <typename T, int HD>
void launch(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
            int H, int KV, int causal, cudaStream_t stream) {
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  flash_attention_kernel<T, HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Skv, H, KV, causal, scale);
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Skv,
              int H, int KV, int hd, int causal, cudaStream_t stream) {
  switch (hd) {
    case 32: launch<T, 32>(q, k, v, out, B, Sq, Skv, H, KV, causal, stream); break;
    case 64: launch<T, 64>(q, k, v, out, B, Sq, Skv, H, KV, causal, stream); break;
    case 128: launch<T, 128>(q, k, v, out, B, Sq, Skv, H, KV, causal, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd); k, v (B, Skv, KV, hd); out (B, Sq, H, hd). All
// contiguous, 16-byte aligned, f32 (dtype 0) or bf16 (dtype 1).
// Returns cudaGetLastError().
int flash_attention(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                    int Skv, int H, int KV, int hd, int causal, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Skv < 1 || KV < 1 || H < KV || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 0) {
    err = launch_hd<float>(q, k, v, out, B, Sq, Skv, H, KV, hd, causal, s);
  } else if (dtype == 1) {
    err = launch_hd<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KV, hd, causal, s);
  } else {
    err = static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
