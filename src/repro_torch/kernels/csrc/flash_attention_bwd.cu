// Backward of causal / non-causal GQA flash attention on Hopper (sm_90a).
//
// No TPU kernel to replace: the JAX package's Pallas flash kernel
// (repro/kernels/attention/kernel.py) has no backward, and its training
// differentiates the pure-JAX blockwise attention. These kernels compute the
// JAX package's explicit flash backward, the custom_vjp of
// repro/runtime/sharded_attention.py (_flash_bwd): with s the scaled scores
// q.k / sqrt(hd) and lse the forward's row log-sum-exp,
//   delta = rowsum(dO * O),  P = exp(s - lse),  dV = P^T dO,
//   dS = P (dP - delta) with dP = dO V^T,  dQ = dS K / sqrt(hd),
//   dK = dS^T Q / sqrt(hd),
// dK and dV summed over the G query heads of each KV head. Causal masks
// q_pos >= k_pos with both counted from 0; keys past Skv and rows past Sq
// take no part.
//
// What bounds it on the H100: 10 hd flop per (query, key) pair (S again, dP,
// and three products into dQ, dK, dV) against 2 hd bytes of K/V per key and
// 4 hd bytes of Q/dO per query row, so at training lengths it is operations.
// This first version runs them on the CUDA cores in f32, for both dtypes:
// S and P are recomputed in f32 from the operands as loaded (bf16 or f32),
// which keeps the per-element agreement with the plain version, and leaves
// the tensor cores (mma.sync or wgmma) to later work.
//
// Two kernels, deterministic (no atomics, every output written once, every
// sum in a fixed order), launched in this order on one stream:
//   (a) flash_attention_bwd_dq: one block per (64 query rows, query head,
//       batch row), 4 threads per row, each owning every fourth 16-byte chunk
//       of the head dim (so the 4 threads of a row read 64 contiguous bytes of
//       a staged key row: no bank conflicts, and all rows of a warp read the
//       same key, a broadcast). Each row computes delta first and writes it
//       to a workspace (B, H, Sq) for (b), then walks the K/V tiles (4096 / hd
//       keys, staged in shared memory as f32) up to its block's last row on
//       the diagonal, accumulating dQ in registers.
//   (b) flash_attention_bwd_dkdv: one block per (64 keys, KV head, batch
//       row), 4 threads per key the same way. It walks the G query heads of
//       its KV head and, per head, the query tiles (4096 / hd rows of Q and
//       dO, with their lse and delta, staged as f32) from the block's first
//       key on the diagonal to Sq, accumulating dK and dV in registers, and
//       writes each once.
// The two reductions a pair needs (s = q.k and dP = dO.v) are partial sums
// over a thread's chunks, finished over its 4 threads by two shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;                   // threads per query row (a) or key (b)
constexpr int kRowsPerBlock = kThreads / kLanes;  // 64

// 4 consecutive elements -> f32
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  o[0] = a.x;
  o[1] = a.y;
  o[2] = b.x;
  o[3] = b.y;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4], float scale) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0] * scale, v[1] * scale, v[2] * scale,
                                              v[3] * scale);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4], float scale) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0] * scale, v[1] * scale);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2] * scale, v[3] * scale);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// the sum over the 4 threads of a row (lanes 4i .. 4i + 3)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// a 4096 / HD x HD f32 tile (16 KB) from rows [r0, r0 + n) of a (.., S, heads,
// HD) tensor at head `head`; zero rows past n
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, size_t row_stride, int n) {
  constexpr int CH = HD / 4;
  constexpr int TILE = 4096 / HD;
  for (int c = threadIdx.x; c < TILE * CH; c += kThreads) {
    const int j = c / CH, ch = c % CH;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < n) load4(src + static_cast<size_t>(j) * row_stride + ch * 4, x);
    *reinterpret_cast<float4*>(dst + j * HD + ch * 4) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ out, const T* __restrict__ dout,
                       const float* __restrict__ lse, float* __restrict__ delta_ws,
                       T* __restrict__ dq, int Sq, int Skv, int H, int KV, int causal,
                       float scale) {
  constexpr int CH = HD / 4;       // 16-byte (4-float) chunks per row
  constexpr int CPT = CH / kLanes;  // chunks per thread: sub, sub + 4, ...
  constexpr int TILE = 4096 / HD;   // keys per staged tile
  static_assert(CH % kLanes == 0, "head dim");
  __shared__ __align__(16) float ks[TILE * HD];
  __shared__ __align__(16) float vs[TILE * HD];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRowsPerBlock;
  const int sub = threadIdx.x % kLanes;
  const int row = q0 + threadIdx.x / kLanes;
  const bool live = row < Sq;
  const int kvh = h / (H / KV);

  float qr[CPT][4], dor[CPT][4], acc[CPT][4];
  float delta = 0.f;
  const size_t qoff = ((static_cast<size_t>(b) * Sq + row) * H + h) * HD;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = (sub + kLanes * c) * 4;
    float o4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e) qr[c][e] = dor[c][e] = acc[c][e] = 0.f;
    if (live) {
      load4(q + qoff + d, qr[c]);
      load4(dout + qoff + d, dor[c]);
      load4(out + qoff + d, o4);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) delta = fmaf(dor[c][e], o4[e], delta);
  }
  delta = quad_sum(delta);
  const size_t roff = (static_cast<size_t>(b) * H + h) * Sq + row;
  const float row_lse = live ? lse[roff] : 0.f;
  if (live && sub == 0) delta_ws[roff] = delta;

  // keys the block needs: a causal block stops at its last row
  const int last = min(q0 + kRowsPerBlock, Sq) - 1;
  const int n_keys = causal ? min(last + 1, Skv) : Skv;
  const int row_last = !live ? -1 : (causal ? row : Skv - 1);  // last key this row sees
  const size_t krow = static_cast<size_t>(KV) * HD;
  const T* kbase = k + static_cast<size_t>(b) * Skv * krow + static_cast<size_t>(kvh) * HD;
  const T* vbase = v + static_cast<size_t>(b) * Skv * krow + static_cast<size_t>(kvh) * HD;

  for (int t0 = 0; t0 < n_keys; t0 += TILE) {
    const int nt = min(TILE, n_keys - t0);
    __syncthreads();  // the previous tile is no longer read
    stage_rows<T, HD>(ks, kbase + static_cast<size_t>(t0) * krow, krow, nt);
    stage_rows<T, HD>(vs, vbase + static_cast<size_t>(t0) * krow, krow, nt);
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      const float* kr = ks + j * HD;
      const float* vr = vs + j * HD;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int d = (sub + kLanes * c) * 4;
        float k4[4], v4[4];
        load4(kr + d, k4);
        load4(vr + d, v4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s = fmaf(qr[c][e], k4[e], s);
          dp = fmaf(dor[c][e], v4[e], dp);
        }
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      const float p = t0 + j <= row_last ? expf(s * scale - row_lse) : 0.f;
      const float ds = p * (dp - delta);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        float k4[4];
        load4(kr + (sub + kLanes * c) * 4, k4);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] = fmaf(ds, k4[e], acc[c][e]);
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int c = 0; c < CPT; ++c) store4(dq + qoff + (sub + kLanes * c) * 4, acc[c], scale);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta_ws,
                         T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, int H, int KV,
                         int causal, float scale) {
  constexpr int CH = HD / 4;
  constexpr int CPT = CH / kLanes;
  constexpr int TILE = 4096 / HD;  // query rows per staged tile
  static_assert(CH % kLanes == 0, "head dim");
  __shared__ __align__(16) float qs[TILE * HD];
  __shared__ __align__(16) float dos[TILE * HD];
  __shared__ float ls[TILE];
  __shared__ float dl[TILE];

  const int b = blockIdx.z, kvh = blockIdx.y, k0 = blockIdx.x * kRowsPerBlock;
  const int sub = threadIdx.x % kLanes;
  const int key = k0 + threadIdx.x / kLanes;
  const bool live = key < Skv;
  const int G = H / KV;

  float kr[CPT][4], vr[CPT][4], dka[CPT][4], dva[CPT][4];
  const size_t koff = ((static_cast<size_t>(b) * Skv + key) * KV + kvh) * HD;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = (sub + kLanes * c) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) kr[c][e] = vr[c][e] = dka[c][e] = dva[c][e] = 0.f;
    if (live) {
      load4(k + koff + d, kr[c]);
      load4(v + koff + d, vr[c]);
    }
  }

  // rows before the block's first key see none of its keys when causal
  const int r_begin = causal ? k0 : 0;
  const size_t qrow = static_cast<size_t>(H) * HD;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qbase = q + static_cast<size_t>(b) * Sq * qrow + static_cast<size_t>(h) * HD;
    const T* dobase = dout + static_cast<size_t>(b) * Sq * qrow + static_cast<size_t>(h) * HD;
    const size_t lbase = (static_cast<size_t>(b) * H + h) * Sq;
    for (int r0 = r_begin; r0 < Sq; r0 += TILE) {
      const int nr = min(TILE, Sq - r0);
      __syncthreads();  // the previous tile is no longer read
      stage_rows<T, HD>(qs, qbase + static_cast<size_t>(r0) * qrow, qrow, nr);
      stage_rows<T, HD>(dos, dobase + static_cast<size_t>(r0) * qrow, qrow, nr);
      for (int i = threadIdx.x; i < nr; i += kThreads) {
        ls[i] = lse[lbase + r0 + i];
        dl[i] = delta_ws[lbase + r0 + i];
      }
      __syncthreads();
      for (int i = 0; i < nr; ++i) {
        const float* qi = qs + i * HD;
        const float* doi = dos + i * HD;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int d = (sub + kLanes * c) * 4;
          float q4[4], do4[4];
          load4(qi + d, q4);
          load4(doi + d, do4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s = fmaf(q4[e], kr[c][e], s);
            dp = fmaf(do4[e], vr[c][e], dp);
          }
        }
        s = quad_sum(s);
        dp = quad_sum(dp);
        const bool seen = live && (!causal || r0 + i >= key);
        const float p = seen ? expf(s * scale - ls[i]) : 0.f;
        const float ds = p * (dp - dl[i]);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int d = (sub + kLanes * c) * 4;
          float q4[4], do4[4];
          load4(qi + d, q4);
          load4(doi + d, do4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dva[c][e] = fmaf(p, do4[e], dva[c][e]);
            dka[c][e] = fmaf(ds, q4[e], dka[c][e]);
          }
        }
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int d = (sub + kLanes * c) * 4;
    store4(dk + koff + d, dka[c], scale);
    store4(dv + koff + d, dva[c], 1.f);
  }
}

int check_sizes(int B, int Sq, int Skv, int H, int KV, int hd, int dtype) {
  if (Skv < 1 || KV < 1 || H < KV || H % KV != 0 || B > 65535 || H > 65535 || KV > 65535 ||
      (hd != 32 && hd != 64 && hd != 128) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename T, int HD>
void launch_dq(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const void* lse, void* delta, void* dq, int B, int Sq, int Skv, int H, int KV,
               int causal, cudaStream_t s) {
  const dim3 grid((Sq + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  flash_attention_bwd_dq<T, HD><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), Sq, Skv, H, KV, causal,
      1.0f / sqrtf(static_cast<float>(HD)));
}

template <typename T, int HD>
void launch_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
                 int causal, cudaStream_t s) {
  const dim3 grid((Skv + kRowsPerBlock - 1) / kRowsPerBlock, KV, B);
  flash_attention_bwd_dkdv<T, HD><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), Sq, Skv, H, KV,
      causal, 1.0f / sqrtf(static_cast<float>(HD)));
}

}  // namespace

extern "C" {

// (a): q, out, dout, dq (B, Sq, H, hd); k, v (B, Skv, KV, hd); lse and the
// delta workspace it writes (B, H, Sq) f32. All contiguous, 16-byte aligned,
// f32 (dtype 0) or bf16 (dtype 1) but lse and delta. Returns cudaGetLastError().
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* out,
                           const void* dout, const void* lse, void* delta, void* dq, int B,
                           int Sq, int Skv, int H, int KV, int hd, int causal, int dtype,
                           void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  const int bad = check_sizes(B, Sq, Skv, H, KV, hd, dtype);
  if (bad) return bad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(T, HD) launch_dq<T, HD>(q, k, v, out, dout, lse, delta, dq, B, Sq, Skv, H, KV, causal, s)
  if (dtype == 0) {
    if (hd == 32) DQ(float, 32);
    if (hd == 64) DQ(float, 64);
    if (hd == 128) DQ(float, 128);
  } else {
    if (hd == 32) DQ(__nv_bfloat16, 32);
    if (hd == 64) DQ(__nv_bfloat16, 64);
    if (hd == 128) DQ(__nv_bfloat16, 128);
  }
#undef DQ
  return static_cast<int>(cudaGetLastError());
}

// (b), after (a) on the same stream: q, dout (B, Sq, H, hd); k, v, dk, dv
// (B, Skv, KV, hd); lse and (a)'s delta (B, H, Sq) f32.
int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int B,
                             int Sq, int Skv, int H, int KV, int hd, int causal, int dtype,
                             void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  const int bad = check_sizes(B, Sq, Skv, H, KV, hd, dtype);
  if (bad) return bad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKDV(T, HD) \
  launch_dkdv<T, HD>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, H, KV, causal, s)
  if (dtype == 0) {
    if (hd == 32) DKDV(float, 32);
    if (hd == 64) DKDV(float, 64);
    if (hd == 128) DKDV(float, 128);
  } else {
    if (hd == 32) DKDV(__nv_bfloat16, 32);
    if (hd == 64) DKDV(__nv_bfloat16, 64);
    if (hd == 128) DKDV(__nv_bfloat16, 128);
  }
#undef DKDV
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
