// One-token (decode) GQA attention over a KV cache on Hopper (sm_90a),
// split over the cache (flash-decoding).
//
// Replaces the Pallas TPU kernel repro/kernels/attention/decode_kernel.py
// (decode_attention_pallas -> _decode_kernel): per (sequence, KV head) an
// online softmax over block_kv-sized cache chunks that stops at the first
// chunk past the sequence's position, f32 accumulation, output in v's dtype.
//
// What bounds it on the H100: every live K and V entry is read once and used
// for G = H / KV query rows (2 G flop per element), far below the card's
// ~295 flop/byte balance point, so its bound is the bytes of the live cache
// entries. At the serving path's shapes (B = 1-4 rows of a few hundred
// entries of 3 x 64 bf16) a call moves well under a megabyte: the bytes
// bound (~0.0001 ms) lies far below the device time of the least kernel
// (~0.0012 ms, chip_smoke.py's launch_floor_ms), so what sets the time is
// latency: the chain of dependent memory round trips and the launches. The
// first port (one block per (row, KV head): 12 blocks on 132 SMs, each
// walking 256 keys 16 at a time, a round trip per step) took 0.0089 ms.
//
// Design:
// * Split over the cache (flash-decoding). Each (row b, KV head, group of
//   GB query heads) splits the cache into chunks of `chunk` keys, a block
//   each. The launcher picks the chunk from the grid and S: with fewer
//   (row, head group) pairs than SMs, S is cut into about SMs / pairs
//   chunks of at least kMinChunk = 64 keys (B=4, S=256: 4 chunks, 48
//   blocks); with as many pairs as SMs (B=64: 192) there is no split and
//   no merge. Blocks whose chunk starts past their row's position exit.
//   decode_attention_chunk makes this choice once, for the SM count the
//   caller gives; the caller sizes the workspace from it and passes it to
//   decode_attention, which checks it. DECODE_CHUNK fixes the chunk at
//   compile time (tools/tile_sweep.py).
// * Loads in flight. A block takes its keys in rounds of R = kWarps x KPW x
//   kSteps keys (64 for bf16 at hd 64; kSteps = 4 steps of KPW keys per
//   warp): every lane issues the 16-byte K and V slices of its 4 keys
//   before using the first —
//   the first round's together with the row's position, before it is
//   known which keys are live — and each next round's before the current
//   round's arithmetic. A 64-key chunk waits on memory once.
// * Lane layout: each lane owns a 16-byte slice of the head dim (8 bf16 or
//   4 f32), hd / 8 (bf16) neighbouring lanes read one key row — rounded up
//   to a power of two, so that a warp holds whole key rows: at hd 112
//   (kimi-k2) 16 lanes a key with 2 idle in bf16 (14 slices), 32 with 4
//   idle in f32 (28); an idle lane loads nothing and adds 0 —, the block's
//   GB query rows (scaled by log2(e) / sqrt(hd), f32) sit in registers. GB
//   is the largest divisor of G up to 8, instantiated exactly, so G = 3
//   computes 3 rows, not 4; G = 12 takes two blocks of 6. Lane groups merge
//   by shuffles, warps through shared memory, by the log-sum-exp rule.
// * A deterministic merge. Split blocks write their partial (m, l, acc)
//   into a workspace the wrapper allocates (torch.empty); a second kernel,
//   one block per (row, query head), merges the live chunks in chunk order
//   by the log-sum-exp rule. It goes out as the split kernel's
//   programmatic dependent (griddepcontrol): its blocks are scheduled while
//   the split kernel runs, read the row's position and wait for the split
//   kernel's end, which hides most of the second launch (0.0005-0.0007 ms
//   against a plain launch, measured before that was removed; PERF.md).
//   Nothing depends on block timing:
//   repeated calls and graph replays give bitwise the same output, and no
//   atomics touch output values. A merge by the last split block to
//   finish (a counter, __threadfence, atomicAdd) lost to it by about
//   0.001 ms at B=4 (PERF.md).
// * A cache shard. The cache may be the shard of a longer one (a
//   cache_seq-sharded cache on a mesh) whose first entry sits at global
//   position `start`: entry j is valid where start + j <= pos. A row with no
//   valid entry (pos < start) runs chunk 0 over no key and writes 0. Given
//   an `lse` pointer, the kernel that writes the output (the split kernel
//   without a split, else the merge) also writes each row's log-sum-exp of
//   its scaled scores, ln(sum exp) = (m + log2 l) ln 2 from its (m, l), and
//   -inf where l = 0: the partial that a merge across shards weighs. With
//   start = 0 and no lse pointer the arithmetic is the unsharded kernel's.
// Softmax in base 2 (exp2f), with the scale folded into q; the output is
// acc / max(l, 1e-30).
//
// What bounds it now (NVIDIA H100 80GB HBM3, 700 W; PERF.md): B=4 S=256
// takes ~0.004 ms, about three launch floors: the split kernel's own
// launch and one round trip for position, K and V together, the merge's
// wait and its round trip. B=64 (no split) ~0.0063 ms: four rounds of 64
// keys a block, each round's loads in flight behind the previous round.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kSteps = 4;  // keys per lane whose loads go out at once
constexpr int kMinChunk = 64;  // fewest keys per block when the cache is split
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
struct Slice;  // one lane's 16-byte slice of a key or value row, in f32

template <>
struct Slice<float> {
  static constexpr int kElems = 4;
  static __device__ __forceinline__ void unpack(const uint4& raw, float (&out)[4]) {
    out[0] = __uint_as_float(raw.x);
    out[1] = __uint_as_float(raw.y);
    out[2] = __uint_as_float(raw.z);
    out[3] = __uint_as_float(raw.w);
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Slice<__nv_bfloat16> {
  static constexpr int kElems = 8;
  static __device__ __forceinline__ void unpack(const uint4& raw, float (&out)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

constexpr int ceil_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The lane layout of one (T, HD) instantiation
template <typename T, int HD>
struct Layout {
  static constexpr int EPL = Slice<T>::kElems;  // elements per 16-byte load
  static constexpr int LIVE = HD / EPL;         // slices of a key row
  static constexpr int LPK = ceil_pow2(LIVE);   // lanes per key row, LPK - LIVE idle
  static constexpr int KPW = 32 / LPK;          // keys per warp step
  static constexpr int NS = kSteps;             // steps per round
  static constexpr int R = kWarps * KPW * NS;   // keys per round of loads
  static_assert(HD % EPL == 0 && LPK <= 32, "head dim");
};

// live entries of row b in a shard from global position `start`: entry j is
// valid where start + j <= pos, all S once pos >= start + S, none below start
__device__ __forceinline__ int live_keys(const int32_t* pos, int b, int S, int start) {
  const int p = pos[b] - start;
  return p >= S ? S : max(p + 1, 0);
}

// natural log-sum-exp of a row from its base-2 running max m and sum l
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * kLn2 : -INFINITY;
}

// Wait until the grid this one depends on (programmatic dependent launch)
// has finished and its writes are visible; a no-op without one.
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Let the grid that depends on this one be scheduled now: it waits in
// wait_for_primary() for this grid's end, so its launch overlaps this grid.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename T, int HD, int GB>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int32_t* __restrict__ pos,
                        T* __restrict__ out, float* __restrict__ lse,
                        float* __restrict__ ws_acc, float2* __restrict__ ws_ml, int S, int H,
                        int KV, int chunk, int splits, int start, float scale_log2) {
  using L = Layout<T, HD>;
  constexpr int EPL = L::EPL, LPK = L::LPK, KPW = L::KPW, NS = L::NS, R = L::R;

  __shared__ float sm_m[kWarps][GB];
  __shared__ float sm_l[kWarps][GB];
  __shared__ float sm_acc[kWarps][GB][HD];

  launch_dependents();
  const int c = blockIdx.x;  // which chunk of the cache
  const int G = H / KV;
  const int ngb = G / GB;
  const int kvh = blockIdx.y / ngb;
  const int h0 = kvh * G + (blockIdx.y % ngb) * GB;  // the block's first query head
  const int b = blockIdx.z;
  const int c0 = c * chunk;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int sub = lane / LPK;   // which of the warp's KPW keys
  const int part = lane % LPK;  // which 16-byte slice of the row
  const int d0 = part * EPL;
  // a lane past the row's slices (hd 112) holds zeros: it loads nothing
  const bool has_slice = L::LIVE == LPK || part < L::LIVE;

  const size_t row_stride = static_cast<size_t>(KV) * HD;
  const T* kb = k + static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(kvh) * HD + d0;
  const T* vb = v + static_cast<size_t>(b) * S * row_stride + static_cast<size_t>(kvh) * HD + d0;

  // a round's keys: step s of this lane is key r0 + (s kWarps + warp) KPW + sub
  uint4 kraw[NS], vraw[NS];
  auto issue = [&](int r0, int end) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int j = r0 + (s * kWarps + warp) * KPW + sub;
      const bool valid = j < end && has_slice;
      kraw[s] = valid ? *reinterpret_cast<const uint4*>(kb + static_cast<size_t>(j) * row_stride)
                      : make_uint4(0, 0, 0, 0);
      vraw[s] = valid ? *reinterpret_cast<const uint4*>(vb + static_cast<size_t>(j) * row_stride)
                      : make_uint4(0, 0, 0, 0);
    }
  };
  // the first round's loads go out with the position's, before it is known
  // which of the keys are live
  issue(c0, min(c0 + chunk, S));
  const int n = live_keys(pos, b, S, start);
  const int live_chunks = max(1, (n + chunk - 1) / chunk);  // chunk 0 runs even for n = 0
  if (c >= live_chunks) return;
  const int c1 = min(c0 + chunk, n);

  float qr[GB][EPL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    float tmp[EPL];
    Slice<T>::unpack(has_slice ? *reinterpret_cast<const uint4*>(
                                     q + (static_cast<size_t>(b) * H + h0 + g) * HD + d0)
                               : make_uint4(0, 0, 0, 0),
                     tmp);
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = tmp[e] * scale_log2;
  }

  float m[GB], l[GB], acc[GB][EPL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  // the loop bound is uniform across the block, so the shuffles see every
  // lane; keys past c1 take no part in the softmax
  for (int r0 = c0; r0 < c1; r0 += R) {
    uint4 kcur[NS], vcur[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      kcur[s] = kraw[s];
      vcur[s] = vraw[s];
    }
    if (r0 + R < c1) issue(r0 + R, c1);  // the next round's loads fly during this one
    float sc[NS][GB];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float kf[EPL];
      Slice<T>::unpack(kcur[s], kf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dot = fmaf(qr[g][e], kf[e], dot);
        sc[s][g] = dot;
      }
    }
#pragma unroll
    for (int off = LPK / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
#pragma unroll
        for (int g = 0; g < GB; ++g) sc[s][g] += __shfl_xor_sync(0xffffffffu, sc[s][g], off);
      }
    }
    bool valid[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) valid[s] = r0 + (s * kWarps + warp) * KPW + sub < c1;
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mn = m[g];
#pragma unroll
      for (int s = 0; s < NS; ++s)
        if (valid[s]) mn = fmaxf(mn, sc[s][g]);
      const float alpha = exp2f(m[g] - mn);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
      m[g] = mn;
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!valid[s]) continue;
      float vf[EPL];
      Slice<T>::unpack(vcur[s], vf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        const float p = exp2f(sc[s][g] - m[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  }

  // merge the KPW key groups of the warp (lanes that share a slice)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = exp2f(m[g] - mn);
      const float bo = exp2f(mo - mn);
      l[g] = l[g] * a + lo * bo;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + ao * bo;
      }
      m[g] = mn;
    }
  }

  // merge the warps through shared memory: the block's (m, l, acc) per row
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (has_slice) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) sm_acc[warp][g][d0 + e] = acc[g][e];
      }
      if (part == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < GB * HD; idx += blockDim.x) {
    const int g = idx / HD;
    const int d = idx % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, asum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * f;
      asum += sm_acc[w][g][d] * f;
    }
    const size_t row = static_cast<size_t>(b) * H + h0 + g;
    if (splits == 1) {
      Slice<T>::store(out + row * HD + d, asum / fmaxf(lsum, 1e-30f));
      if (lse != nullptr && d == 0) lse[row] = row_lse(mx, lsum);
    } else {
      ws_acc[(row * splits + c) * HD + d] = asum;
      if (d == 0) ws_ml[row * splits + c] = make_float2(mx, lsum);
    }
  }
}

// The split's merge: one block of hd threads per (row, query head) merges
// the live chunks' partials in chunk order by the log-sum-exp rule. It is
// launched as the split kernel's programmatic dependent, so it is on the
// SMs before that kernel ends: it reads the position, then waits.
template <typename T>
__global__ void merge_kernel(const int32_t* __restrict__ pos, T* __restrict__ out,
                             float* __restrict__ lse, const float* __restrict__ ws_acc,
                             const float2* __restrict__ ws_ml, int S, int H, int chunk,
                             int splits, int start) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x, hd = blockDim.x;
  // not written by the split kernel
  const int n = live_keys(pos, static_cast<int>(row / H), S, start);
  const int live_chunks = max(1, (n + chunk - 1) / chunk);
  wait_for_primary();
  float m = kNegInf, l = 0.f, acc = 0.f;
#pragma unroll 4
  for (int c = 0; c < live_chunks; ++c) {
    // read past L1: the split kernel's blocks wrote these
    const float2 ml = __ldcg(&ws_ml[row * splits + c]);
    const float a = __ldcg(&ws_acc[(row * splits + c) * hd + d]);
    const float mn = fmaxf(m, ml.x);
    const float f_old = exp2f(m - mn), f_new = exp2f(ml.x - mn);
    l = l * f_old + ml.y * f_new;
    acc = acc * f_old + a * f_new;
    m = mn;
  }
  Slice<T>::store(out + row * hd + d, acc / fmaxf(l, 1e-30f));
  if (lse != nullptr && d == 0) lse[row] = row_lse(m, l);
}

// the query heads of a KV head go GB to a block: the largest divisor of G
// that is at most 8
int group_block(int G) {
  for (int gb = 8; gb > 1; --gb)
    if (G % gb == 0) return gb;
  return 1;
}

template <typename T, int HD>
constexpr int keys_per_round() {
  return Layout<T, HD>::R;
}

// keys per block: the whole cache unless the grid would leave SMs idle,
// then about sms / pairs chunks of at least kMinChunk keys (DECODE_CHUNK
// fixes it), a multiple of the round R
int choose_chunk(int pairs, int S, int R, int sms) {
#ifdef DECODE_CHUNK
  int chunk = DECODE_CHUNK;
  (void)pairs;
  (void)sms;
#else
  int chunk = S;
  if (pairs < sms) {
    const int want = (sms + pairs - 1) / pairs;
    chunk = max(kMinChunk, (S + want - 1) / want);
  }
#endif
  chunk = (max(chunk, 1) + R - 1) / R * R;
  return min(chunk, (S + R - 1) / R * R);
}

template <typename T, int HD, int GB>
cudaError_t launch(const void* q, const void* k, const void* v, const void* pos, void* out,
                   float* lse, void* ws, int B, int S, int H, int KV, int chunk, int splits,
                   int start, cudaStream_t stream) {
  const int ngb = H / KV / GB;
  const dim3 grid(splits, KV * ngb, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  float* ws_acc = static_cast<float*>(ws);
  float2* ws_ml = reinterpret_cast<float2*>(ws_acc + static_cast<size_t>(B) * H * splits * HD);
  decode_attention_kernel<T, HD, GB><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(pos), static_cast<T*>(out), lse, ws_acc, ws_ml, S, H, KV, chunk,
      splits, start, scale_log2);
  if (splits == 1) return cudaSuccess;
  // the merge, as a programmatic dependent of the split kernel
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H);
  cfg.blockDim = dim3(HD);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, merge_kernel<T>, static_cast<const int32_t*>(pos),
                            static_cast<T*>(out), lse, static_cast<const float*>(ws_acc),
                            static_cast<const float2*>(ws_ml), S, H, chunk, splits, start);
}

template <typename T, int HD>
cudaError_t launch_group(const void* q, const void* k, const void* v, const void* pos,
                         void* out, float* lse, void* ws, int B, int S, int H, int KV, int chunk,
                         int splits, int start, cudaStream_t s) {
  switch (group_block(H / KV)) {
    case 1: return launch<T, HD, 1>(q, k, v, pos, out, lse, ws, B, S, H, KV, chunk, splits, start, s);
    case 2: return launch<T, HD, 2>(q, k, v, pos, out, lse, ws, B, S, H, KV, chunk, splits, start, s);
    case 3: return launch<T, HD, 3>(q, k, v, pos, out, lse, ws, B, S, H, KV, chunk, splits, start, s);
    case 4: return launch<T, HD, 4>(q, k, v, pos, out, lse, ws, B, S, H, KV, chunk, splits, start, s);
    case 5: return launch<T, HD, 5>(q, k, v, pos, out, lse, ws, B, S, H, KV, chunk, splits, start, s);
    case 6: return launch<T, HD, 6>(q, k, v, pos, out, lse, ws, B, S, H, KV, chunk, splits, start, s);
    case 7: return launch<T, HD, 7>(q, k, v, pos, out, lse, ws, B, S, H, KV, chunk, splits, start, s);
    default: return launch<T, HD, 8>(q, k, v, pos, out, lse, ws, B, S, H, KV, chunk, splits, start, s);
  }
}

// keys per round of the (dtype, hd) instantiation; 0 for one that does not exist
int round_keys(int hd, int dtype) {
  if (dtype == 0) {
    switch (hd) {
      case 32: return keys_per_round<float, 32>();
      case 64: return keys_per_round<float, 64>();
      case 112: return keys_per_round<float, 112>();
      case 128: return keys_per_round<float, 128>();
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 32: return keys_per_round<__nv_bfloat16, 32>();
      case 64: return keys_per_round<__nv_bfloat16, 64>();
      case 112: return keys_per_round<__nv_bfloat16, 112>();
      case 128: return keys_per_round<__nv_bfloat16, 128>();
    }
  }
  return 0;
}

bool valid_shape(int B, int S, int H, int KV) {
  return B > 0 && B <= 65535 && S >= 1 && KV >= 1 && H >= KV && H % KV == 0;
}

}  // namespace

extern "C" {

// Keys per block that decode_attention takes at these sizes on a card of
// `sms` SMs, a multiple of its round; splits = ceil(S / chunk) chunks per
// (row, head group), 1 when chunk >= S. The caller allocates B H splits
// (hd + 2) f32 of workspace when splits > 1 and passes the chunk on.
// Negative on sizes it does not take.
int decode_attention_chunk(int B, int S, int H, int KV, int hd, int dtype, int sms) {
  const int R = round_keys(hd, dtype);
  if (R == 0 || sms < 1 || !valid_shape(B, S, H, KV))
    return -static_cast<int>(cudaErrorInvalidValue);
  const int chunk = choose_chunk(B * KV * (H / KV / group_block(H / KV)), S, R, sms);
  return (S + chunk - 1) / chunk > 65535 ? -static_cast<int>(cudaErrorInvalidValue) : chunk;
}

// q (B, 1, H, hd); k, v (B, S, KV, hd): the shard of a cache from global
// position start >= 0; pos (B,) int32; out (B, 1, H, hd); lse: (B, H) f32
// or null; chunk: keys per block, from decode_attention_chunk (a positive
// multiple of the round, at most 65535 chunks over S); ws: B H splits
// (hd + 2) f32, splits = ceil(S / chunk) (unused without a split). All
// contiguous, 16-byte aligned, f32 (dtype 0) or bf16 (dtype 1). Returns
// cudaGetLastError().
int decode_attention(const void* q, const void* k, const void* v, const void* pos, void* out,
                     void* lse, void* ws, int B, int S, int H, int KV, int hd, int dtype,
                     int chunk, int start, void* stream) {
  if (B <= 0) return 0;
  const int R = round_keys(hd, dtype);
  if (R == 0 || !valid_shape(B, S, H, KV) || chunk < R || chunk % R != 0 || start < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int splits = (S + chunk - 1) / chunk;
  if (splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == 0) {
    switch (hd) {
      case 32: err = launch_group<float, 32>(q, k, v, pos, out, l, ws, B, S, H, KV, chunk, splits, start, s); break;
      case 64: err = launch_group<float, 64>(q, k, v, pos, out, l, ws, B, S, H, KV, chunk, splits, start, s); break;
      case 112: err = launch_group<float, 112>(q, k, v, pos, out, l, ws, B, S, H, KV, chunk, splits, start, s); break;
      default: err = launch_group<float, 128>(q, k, v, pos, out, l, ws, B, S, H, KV, chunk, splits, start, s); break;
    }
  } else {
    using bf = __nv_bfloat16;
    switch (hd) {
      case 32: err = launch_group<bf, 32>(q, k, v, pos, out, l, ws, B, S, H, KV, chunk, splits, start, s); break;
      case 64: err = launch_group<bf, 64>(q, k, v, pos, out, l, ws, B, S, H, KV, chunk, splits, start, s); break;
      case 112: err = launch_group<bf, 112>(q, k, v, pos, out, l, ws, B, S, H, KV, chunk, splits, start, s); break;
      default: err = launch_group<bf, 128>(q, k, v, pos, out, l, ws, B, S, H, KV, chunk, splits, start, s); break;
    }
  }
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
