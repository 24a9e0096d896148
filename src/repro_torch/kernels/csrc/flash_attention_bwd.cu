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
// q_pos >= k_pos, k_pos counted from 0 and q_pos from q_offset (query row p
// sits at position q_offset + p: a sequence shard's rows against keys
// gathered from position 0, runtime/sharded_attention.py); keys past Skv and
// rows past Sq take no part. (a)'s key count, tile break and masks count
// from that position; (b)'s first query row is the one at its first key,
// k0 - q_offset clamped at 0, and its skip, edge test and masks likewise.
//
// What bounds it on the H100: 10 hd flop per (query, key) pair (S again, dP,
// and three products into dQ, dK, dV) against 2 hd bytes of K/V per key and
// 4 hd bytes of Q/dO per query row, so at training lengths it is operations,
// and those belong on the tensor cores.
//
// Two kernels, deterministic (no atomics, every output written once, every
// sum in a fixed order), launched in this order on one stream.
//
// bf16 (the training path): products on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), operands staged in shared
// memory as loaded (bf16, rows padded to HD + 8 so that ldmatrix reads 8 rows
// from 8 distinct bank groups), brought in by cp.async and double-buffered.
// Every product walks 16 keys (a) or 16 query rows (b) at a time, so S and dP
// are two n-tiles of 8 and one ldmatrix.x4 gives the B fragments of both for
// one k-step of 16 head dims: hd 32, 64, 112 (kimi-k2: 7 k-steps) and 128 run
// the same code, and the hd-wide products take HD / 8 n-tiles (14 at 112)
// from HD / 16 ldmatrix.x4.trans. Nothing is padded to another head dim.
//   (a) flash_attention_bwd_dq: the G query heads of a KV head are packed as
//       the rows of one block, query-position-major as in the forward (packed
//       row r is position r / G, head member r % G), so they share every K/V
//       tile; 64 rows a block, a warp per 16. Each warp keeps its rows' Q and
//       dO as A fragments in registers, computes their delta as the diagonal
//       of dO O^T on the tensor cores (summed as dP is, so dP - delta is
//       exactly 0 where O equals V: one key) and writes it to the (B, H, Sq)
//       workspace for (b), then walks the 64-key
//       K/V tiles up to its block's last position: S = Q K^T and dP = dO V^T,
//       P = 2^(s log2(e) / sqrt(hd) - lse log2(e)) and dS in f32 registers,
//       then dQ += dS K with dS's accumulator fragments reused as A fragments
//       and K read through ldmatrix.trans. Blocks are issued heaviest (last
//       rows) first.
//   (b) flash_attention_bwd_dkdv: one block per (32 keys, KV head, batch
//       row), a warp per 16 keys, issued heaviest (first keys) first. The
//       block keeps its keys' K and V in shared memory and walks the G heads
//       and, for each, the query tiles of 32 rows from its first key on (the
//       diagonal) to Sq: S^T = K Q^T and dP^T = V dO^T (K and V A fragments
//       read from shared memory each step: at hd 128 the dK and dV
//       accumulators alone are 128 f32 registers a lane), P^T and dS^T in
//       f32, then dV += P^T dO and dK += dS^T Q with dO and Q read through
//       ldmatrix.trans. Four warp groups share the block's keys and take the
//       (head, query tile) items round-robin, each with its own Q/dO stages
//       and a named barrier; at the end groups 1-3 hand their dK/dV to group
//       0 through shared memory in group order (a fixed order), which scales
//       dK and writes each row once. Blocks of 32 keys with four groups were
//       measured against 16 and 64 keys with 1, 2 or 4 groups
//       (tools/tile_sweep.py bwd): best or within 10 % of the best at every
//       shape of the checks, and best on a grid of many blocks (B=8 S=1024):
//       more groups shorten the heaviest (first) key block's chain of items,
//       and a grid of few blocks leaves SMs idle.
//   * P and dS enter the products as bf16 hi + lo (hi = bf16(x), lo =
//     bf16(x - hi)), both multiplied into one f32 accumulator: about 16
//     bits, as the forward keeps P. Each of the three products needs it: a
//     bf16 P or dS alone misses the per-element rule against the f32 plain
//     version by 15-30x (tests/test_torch_attention.py emulates both).
//   * mma.sync rather than wgmma: at the training shapes the grids hold tens
//     to hundreds of blocks; wgmma, TMA and warp specialisation are later
//     work.
//
// f32 (no training path runs it): the first version's CUDA-core kernels,
// which keep the 1e-5 agreement with the plain version that bf16 operands
// cannot: (a) one block per (64 query rows, query head, batch row), 4
// threads per row each owning every fourth 16-byte chunk of the head dim,
// K/V tiles of 4096 / hd keys staged as f32; (b) one block per (64 keys, KV
// head, batch row) walking the G heads' query tiles the same way. The two
// reductions a pair needs (s = q.k and dP = dO.v) are partial sums over a
// thread's chunks, finished over its 4 threads by two shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// (b)'s key warps a block and warp groups; defining BWD_KEY_WARPS and
// BWD_GROUPS builds another choice, for measuring one against another
// (tools/tile_sweep.py bwd)
#ifndef BWD_KEY_WARPS
#define BWD_KEY_WARPS 2
#endif
#ifndef BWD_GROUPS
#define BWD_GROUPS 4
#endif

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kRows = 64;   // (a): packed query rows a block, a warp per 16
constexpr int kKeys = 64;   // (a): keys a staged K/V tile
constexpr int kQRows = 32;  // (b): query rows a staged Q/dO tile
constexpr int kKeyWarps = BWD_KEY_WARPS;  // (b): a warp per 16 keys
constexpr int kGroups = BWD_GROUPS;       // (b): warp groups over the items

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, zero-filled when bytes == 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// barrier `id` (1..15) over the `threads` threads of one warp group
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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

// 2^x (ex2.approx: 2 ulp)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x, y) -> hi = bf16(x, y) and lo = bf16(x - hi, y - hi), packed
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// the A fragments (hi and lo) of a 16 x 16 tile held as two n-tiles of
// accumulators: rows g and g + 8, columns 2t, 2t + 1 of n-tile 0 then 1
__device__ __forceinline__ void a_frags(const float (&x)[2][4], uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  split_bf16(x[0][0], x[0][1], hi[0], lo[0]);
  split_bf16(x[0][2], x[0][3], hi[1], lo[1]);
  split_bf16(x[1][0], x[1][1], hi[2], lo[2]);
  split_bf16(x[1][2], x[1][3], hi[3], lo[3]);
}

// acc (16 rows x HD) += (hi + lo) (16 x 16) * rows [0, 16) of the staged tile
// t (16 rows of HD, the k dimension), read through ldmatrix.trans
template <int HD>
__device__ __forceinline__ void mma_rows(float (&acc)[HD / 8][4], const uint32_t (&hi)[4],
                                         const uint32_t (&lo)[4], const __nv_bfloat16* t,
                                         int lane) {
  constexpr int ROW = HD + 8;
#pragma unroll
  for (int jp = 0; jp < HD / 16; ++jp) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, t + ((lane & 7) + ((lane >> 3) & 1) * 8) * ROW + jp * 16 +
                             (lane >> 4) * 8);
    mma_bf16(acc[2 * jp], hi, b[0], b[1]);
    mma_bf16(acc[2 * jp + 1], hi, b[2], b[3]);
    mma_bf16(acc[2 * jp], lo, b[0], b[1]);
    mma_bf16(acc[2 * jp + 1], lo, b[2], b[3]);
  }
}

// the B fragments of one k-step (16 head dims from kk * 16) for rows [0, 16)
// of the staged tile t: b[0..1] n-tile of rows 0-7, b[2..3] rows 8-15
template <int HD>
__device__ __forceinline__ void b_frags(uint32_t (&b)[4], const __nv_bfloat16* t, int kk,
                                        int lane) {
  constexpr int ROW = HD + 8;
  ldmatrix_x4(b, t + ((lane & 7) + (lane >> 4) * 8) * ROW + kk * 16 + ((lane >> 3) & 1) * 8);
}

template <int HD>
constexpr int dq_smem_bytes() {
  // the Q and dO tiles, then 2 stages of a K and a V tile
  return (2 * kRows + 4 * kKeys) * (HD + 8) * 2;
}

template <int HD>
__global__ void __launch_bounds__(kRows * 2)
flash_attention_bwd_dq_mma(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ out,
                           const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                           float* __restrict__ delta_ws, __nv_bfloat16* __restrict__ dq, int B,
                           int Sq, int Skv, int H, int KV, int causal, int q_off,
                           int n_row_tiles, float scale) {
  constexpr int ROW = HD + 8;  // bf16 per smem row: 16 bytes of pad
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  constexpr int KSTEPS = HD / 16;
  constexpr int NT = HD / 8;   // 8-wide n-tiles of dQ
  constexpr int THREADS = kRows * 2;
  constexpr int TILE = kKeys * ROW;
  static_assert(HD % 16 == 0 && kRows <= kKeys, "shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdo = sq + kRows * ROW;
  __nv_bfloat16* sk = sdo + kRows * ROW;  // [2 stages][kKeys][ROW]
  __nv_bfloat16* sv = sk + 2 * TILE;      // [2 stages][kKeys][ROW]

  // block -> (row tile, KV head, batch row), the last row tiles first
  const int kvb = KV * B;
  const int r0 = (n_row_tiles - 1 - static_cast<int>(blockIdx.x) / kvb) * kRows;
  const int kvh = static_cast<int>(blockIdx.x) % kvb % KV;
  const int b = static_cast<int>(blockIdx.x) % kvb / KV;
  const int G = H / KV;
  const int rows = Sq * G;  // packed rows of this (batch row, KV head)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int r_last = min(r0 + kRows, rows) - 1;
  const int n_keys = causal ? min(q_off + r_last / G + 1, Skv) : Skv;
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;

  // offset of packed row r's head-dim vector in q, out, dout, dq
  const auto row_off = [&](int r) {
    return ((static_cast<size_t>(b) * Sq + r / G) * H + kvh * G + r % G) * HD;
  };
  // Q, dO and O tiles (zero rows past the end; O where the K tile of stage
  // 1 goes), then the K/V tile of step 0
  __nv_bfloat16* so = sk + TILE;
  for (int c = tid; c < kRows * CH; c += THREADS) {
    const int rr = c / CH, ch = c % CH, r = r0 + rr;
    const size_t off = r < rows ? row_off(r) + ch * 8 : 0;
    cp_async16(sq + rr * ROW + ch * 8, q + off, r < rows ? 16 : 0);
    cp_async16(sdo + rr * ROW + ch * 8, dout + off, r < rows ? 16 : 0);
    cp_async16(so + rr * ROW + ch * 8, out + off, r < rows ? 16 : 0);
  }
  cp_async_commit();
  const size_t krow = static_cast<size_t>(KV) * HD;
  const __nv_bfloat16* kbase = k + static_cast<size_t>(b) * Skv * krow + static_cast<size_t>(kvh) * HD;
  const __nv_bfloat16* vbase = v + static_cast<size_t>(b) * Skv * krow + static_cast<size_t>(kvh) * HD;
  auto load_tile = [&](int t, int stage) {
    for (int c = tid; c < kKeys * CH; c += THREADS) {
      const int j = c / CH, ch = c % CH, key = t * kKeys + j;
      const bool live = key < Skv;
      const size_t off = live ? static_cast<size_t>(key) * krow + ch * 8 : 0;
      cp_async16(sk + stage * TILE + j * ROW + ch * 8, kbase + off, live ? 16 : 0);
      cp_async16(sv + stage * TILE + j * ROW + ch * 8, vbase + off, live ? 16 : 0);
    }
  };
  load_tile(0, 0);
  cp_async_commit();

  const int wr0 = r0 + warp * 16;
  const bool warp_live = wr0 < rows;
  // positions count from q_off (causal: row p sees keys <= q_off + p)
  const int w_lo = q_off + wr0 / G;                      // first position of the warp
  const int w_hi = q_off + min(wr0 + 15, rows - 1) / G;  // last live position of the warp
  const float scale_log2 = scale * kLog2e;

  cp_async_wait<1>();  // Q, dO and O have landed
  __syncthreads();
  uint32_t qf[KSTEPS][4], dof[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    ldmatrix_x4(qf[kk], sq + (warp * 16 + (lane & 15)) * ROW + kk * 16 + (lane >> 4) * 8);
    ldmatrix_x4(dof[kk], sdo + (warp * 16 + (lane & 15)) * ROW + kk * 16 + (lane >> 4) * 8);
  }
  // delta of the warp's 16 rows: the diagonal of dO O^T, on the tensor cores
  // as dP = dO V^T is, so that dP - delta is exactly 0 where O equals V;
  // lane 4g + g / 2 holds rows g and g + 8, and writes them for (b)
  float dl[2], l2[2];
  int pos[2];
  {
    float d[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t bo[4];
      b_frags<HD>(bo, so + warp * 16 * ROW, kk, lane);
      mma_bf16(d[0], dof[kk], bo[0], bo[1]);
      mma_bf16(d[1], dof[kk], bo[2], bo[3]);
    }
    const int g = lane >> 2, diag = 4 * g + (g >> 1);
    dl[0] = __shfl_sync(0xffffffffu, (g & 1) ? d[0][1] : d[0][0], diag);
    dl[1] = __shfl_sync(0xffffffffu, (g & 1) ? d[1][3] : d[1][2], diag);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr0 + g + 8 * h;
      const size_t roff = (static_cast<size_t>(b) * H + kvh * G + r % G) * Sq + r / G;
      if (r < rows && lane == diag) delta_ws[roff] = dl[h];
      pos[h] = q_off + r / G;
      l2[h] = r < rows ? lse[roff] * kLog2e : 0.f;
    }
  }
  __syncthreads();  // the O tile is read: stage 1 is free for tile 1

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = sk + (t & 1) * TILE;
    const __nv_bfloat16* vt = sv + (t & 1) * TILE;
    for (int c = 0; warp_live && c < kKeys / 16; ++c) {
      const int kc0 = t * kKeys + c * 16;  // the chunk's first key
      if (kc0 >= n_keys || (causal && kc0 > w_hi)) break;
      const __nv_bfloat16* kc = kt + c * 16 * ROW;
      const __nv_bfloat16* vc = vt + c * 16 * ROW;
      // S = Q K^T and dP = dO V^T over the chunk's 16 keys (two n-tiles)
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t bk[4], bv[4];
        b_frags<HD>(bk, kc, kk, lane);
        b_frags<HD>(bv, vc, kk, lane);
        mma_bf16(s[0], qf[kk], bk[0], bk[1]);
        mma_bf16(s[1], qf[kk], bk[2], bk[3]);
        mma_bf16(dp[0], dof[kk], bv[0], bv[1]);
        mma_bf16(dp[1], dof[kk], bv[2], bv[3]);
      }
      // P and dS in f32 (s becomes dS); masked only where the chunk crosses
      // Skv or the warp's diagonal
      const bool edge = kc0 + 16 > Skv || (causal && kc0 + 15 > w_lo);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(s[j][e] * scale_log2 - l2[e >> 1]);
          if (edge) {
            const int key = kc0 + j * 8 + 2 * (lane & 3) + (e & 1);
            if (key >= Skv || (causal && key > pos[e >> 1])) p = 0.f;
          }
          s[j][e] = p * (dp[j][e] - dl[e >> 1]);
        }
      }
      // dQ += (dS_hi + dS_lo) K
      uint32_t hi[4], lo[4];
      a_frags(s, hi, lo);
      mma_rows<HD>(acc, hi, lo, kc, lane);
    }
    __syncthreads();  // this stage is free for tile t + 2
  }

  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + (lane >> 2) + 8 * h;
    if (r >= rows) continue;
    __nv_bfloat16* op = dq + row_off(r) + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * h] * scale, acc[j][2 * h + 1] * scale);
  }
}

// bytes of one (b) warp group's stage: a Q and a dO tile, their lse and delta
template <int HD>
__host__ __device__ constexpr int dkdv_stage_bytes() {
  return 2 * kQRows * (HD + 8) * 2 + 2 * kQRows * 4;
}
template <int HD, int KW, int GS>
constexpr int dkdv_smem_bytes() {
  // the block's K and V rows, then each group's 2 stages
  return 2 * KW * 16 * (HD + 8) * 2 + GS * 2 * dkdv_stage_bytes<HD>();
}

// KW warps a block along its 16 KW keys, GS warp groups along the (head,
// query tile) items
template <int HD, int KW, int GS>
__global__ void __launch_bounds__(KW * 32 * GS)
flash_attention_bwd_dkdv_mma(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                             int B, int Sq, int Skv, int H, int KV, int causal, int q_off,
                             float scale) {
  constexpr int ROW = HD + 8;
  constexpr int CH = HD / 8;
  constexpr int KSTEPS = HD / 16;
  constexpr int NT = HD / 8;
  constexpr int KEYS = KW * 16;
  constexpr int GT = KW * 32;  // threads of a warp group
  constexpr int THREADS = GT * GS;
  constexpr int STAGE = dkdv_stage_bytes<HD>();
  static_assert(HD % 16 == 0 && kQRows % 16 == 0 && GS <= 15, "shape");
  // groups 1.. hand their dK and dV (NT * 8 floats a thread) to group 0
  // through the (then free) stages
  static_assert(GS == 1 || NT * 8 * GT * 4 <= GS * 2 * STAGE, "merge buffer");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sv = sk + KEYS * ROW;
  unsigned char* stages = reinterpret_cast<unsigned char*>(sv + KEYS * ROW);  // [GS][2][STAGE]

  // block -> (key block, KV head, batch row), the first keys (most rows) first
  const int kvb = KV * B;
  const int k0 = static_cast<int>(blockIdx.x) / kvb * KEYS;
  const int kvh = static_cast<int>(blockIdx.x) % kvb % KV;
  const int b = static_cast<int>(blockIdx.x) % kvb / KV;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kw = warp % KW;   // the warp's 16 keys
  const int grp = warp / KW;  // the warp's group
  const int gtid = tid % GT;

  // the block's K and V rows (zero rows past Skv)
  for (int c = tid; c < KEYS * CH; c += THREADS) {
    const int j = c / CH, ch = c % CH, key = k0 + j;
    const size_t off = key < Skv ? ((static_cast<size_t>(b) * Skv + key) * KV + kvh) * HD + ch * 8 : 0;
    cp_async16(sk + j * ROW + ch * 8, k + off, key < Skv ? 16 : 0);
    cp_async16(sv + j * ROW + ch * 8, v + off, key < Skv ? 16 : 0);
  }
  cp_async_commit();

  // items: (head member g, query tile) over rows from the one at the block's
  // first key (causal: row p sits at position q_off + p) to Sq; group grp
  // takes items grp, grp + GS, ...
  const int r_begin = causal ? max(k0 - q_off, 0) : 0;
  const int n_qt = r_begin < Sq ? (Sq - r_begin + kQRows - 1) / kQRows : 0;
  const int n_items = G * n_qt;
  const int my_items = grp < n_items ? (n_items - grp + GS - 1) / GS : 0;
  const auto stage_q = [&](int s) {
    return reinterpret_cast<__nv_bfloat16*>(stages + (grp * 2 + s) * STAGE);
  };
  auto load_item = [&](int jj, int s) {
    const int i = grp + jj * GS, h = kvh * G + i / n_qt, r0 = r_begin + i % n_qt * kQRows;
    __nv_bfloat16* sq = stage_q(s);
    __nv_bfloat16* sdo = sq + kQRows * ROW;
    float* sl = reinterpret_cast<float*>(sdo + kQRows * ROW);
    for (int c = gtid; c < kQRows * CH; c += GT) {
      const int rr = c / CH, ch = c % CH, r = r0 + rr;
      const size_t off = r < Sq ? ((static_cast<size_t>(b) * Sq + r) * H + h) * HD + ch * 8 : 0;
      cp_async16(sq + rr * ROW + ch * 8, q + off, r < Sq ? 16 : 0);
      cp_async16(sdo + rr * ROW + ch * 8, dout + off, r < Sq ? 16 : 0);
    }
    const size_t lbase = (static_cast<size_t>(b) * H + h) * Sq;
    for (int c = gtid; c < kQRows; c += GT) {
      const size_t off = r0 + c < Sq ? lbase + r0 + c : 0;
      cp_async4(sl + c, lse + off, r0 + c < Sq ? 4 : 0);
      cp_async4(sl + kQRows + c, delta + off, r0 + c < Sq ? 4 : 0);
    }
  };
  if (my_items > 0) load_item(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // K, V and each group's first item have landed

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const int kw0 = k0 + kw * 16;  // the warp's first key
  const __nv_bfloat16* ka = sk + kw * 16 * ROW;
  const __nv_bfloat16* va = sv + kw * 16 * ROW;
  const float scale_log2 = scale * kLog2e;

  for (int jj = 0; jj < my_items; ++jj) {
    if (jj + 1 < my_items) {
      load_item(jj + 1, (jj + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    group_sync(1 + grp, GT);
    const int r0 = r_begin + (grp + jj * GS) % n_qt * kQRows;
    const __nv_bfloat16* sq = stage_q(jj & 1);
    const __nv_bfloat16* sdo = sq + kQRows * ROW;
    const float* sl = reinterpret_cast<const float*>(sdo + kQRows * ROW);
    const float* sd = sl + kQRows;
#pragma unroll
    for (int c = 0; c < kQRows / 16; ++c) {
      const int qc0 = r0 + c * 16;  // the chunk's first query row
      if (kw0 >= Skv || qc0 >= Sq || (causal && q_off + qc0 + 15 < kw0)) continue;
      const __nv_bfloat16* qc = sq + c * 16 * ROW;
      const __nv_bfloat16* dc = sdo + c * 16 * ROW;
      // S^T = K Q^T and dP^T = V dO^T over the chunk's 16 rows (two n-tiles)
      float s[2][4] = {}, dp[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t a[4], bq[4];
        ldmatrix_x4(a, ka + (lane & 15) * ROW + kk * 16 + (lane >> 4) * 8);
        b_frags<HD>(bq, qc, kk, lane);
        mma_bf16(s[0], a, bq[0], bq[1]);
        mma_bf16(s[1], a, bq[2], bq[3]);
        ldmatrix_x4(a, va + (lane & 15) * ROW + kk * 16 + (lane >> 4) * 8);
        b_frags<HD>(bq, dc, kk, lane);
        mma_bf16(dp[0], a, bq[0], bq[1]);
        mma_bf16(dp[1], a, bq[2], bq[3]);
      }
      // P^T and dS^T in f32 (s becomes P^T, dp dS^T); masked only where
      // the chunk crosses Sq or the warp's diagonal
      const bool edge = qc0 + 16 > Sq || (causal && q_off + qc0 < kw0 + 15);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c * 16 + j * 8 + 2 * (lane & 3) + (e & 1);  // row of the tile
          float p = ex2(s[j][e] * scale_log2 - sl[col] * kLog2e);
          if (edge) {
            const int key = kw0 + (lane >> 2) + 8 * (e >> 1);
            if (r0 + col >= Sq || (causal && q_off + r0 + col < key)) p = 0.f;
          }
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - sd[col]);
        }
      }
      // dV += (P_hi + P_lo)^T dO and dK += (dS_hi + dS_lo)^T Q
      uint32_t hi[4], lo[4];
      a_frags(s, hi, lo);
      mma_rows<HD>(dva, hi, lo, dc, lane);
      a_frags(dp, hi, lo);
      mma_rows<HD>(dka, hi, lo, qc, lane);
    }
    group_sync(1 + grp, GT);  // this stage is free for item jj + 2
  }

  if (GS > 1) {
    // group 0 adds the other groups' dK and dV in group order, thread by
    // thread: the threads gtid of two groups hold the same keys and columns
    float* xfer = reinterpret_cast<float*>(stages);  // [NT * 8][GT]
    for (int src = 1; src < GS; ++src) {
      __syncthreads();
      if (grp == src) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            xfer[(j * 8 + e) * GT + gtid] = dka[j][e];
            xfer[(j * 8 + 4 + e) * GT + gtid] = dva[j][e];
          }
      }
      __syncthreads();
      if (grp == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            dka[j][e] += xfer[(j * 8 + e) * GT + gtid];
            dva[j][e] += xfer[(j * 8 + 4 + e) * GT + gtid];
          }
      }
    }
    if (grp != 0) return;
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kw0 + (lane >> 2) + 8 * h;
    if (key >= Skv) continue;
    const size_t off = ((static_cast<size_t>(b) * Skv + key) * KV + kvh) * HD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + j * 8) =
          __floats2bfloat162_rn(dka[j][2 * h] * scale, dka[j][2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + j * 8) =
          __floats2bfloat162_rn(dva[j][2 * h], dva[j][2 * h + 1]);
    }
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int HD>
int launch_dq_bf16(const void* q, const void* k, const void* v, const void* out, const void* dout,
                   const void* lse, void* delta, void* dq, int B, int Sq, int Skv, int H, int KV,
                   int causal, int q_off, cudaStream_t s) {
  constexpr int smem = dq_smem_bytes<HD>();
  const int err = allow_smem(flash_attention_bwd_dq_mma<HD>, smem);
  if (err) return err;
  const int n_row_tiles = (Sq * (H / KV) + kRows - 1) / kRows;
  flash_attention_bwd_dq_mma<HD><<<n_row_tiles * KV * B, kRows * 2, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<__nv_bfloat16*>(dq), B, Sq, Skv, H, KV, causal,
      q_off, n_row_tiles, 1.0f / sqrtf(static_cast<float>(HD)));
  return 0;
}

template <int HD>
int launch_dkdv_bf16(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
                     int Skv, int H, int KV, int causal, int q_off, cudaStream_t s) {
  constexpr int KW = kKeyWarps, GS = kGroups;
  constexpr int smem = dkdv_smem_bytes<HD, KW, GS>();
  const int err = allow_smem(flash_attention_bwd_dkdv_mma<HD, KW, GS>, smem);
  if (err) return err;
  const int n_key_blocks = (Skv + KW * 16 - 1) / (KW * 16);
  flash_attention_bwd_dkdv_mma<HD, KW, GS><<<n_key_blocks * KV * B, KW * 32 * GS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), B, Sq, Skv, H, KV, causal,
      q_off, 1.0f / sqrtf(static_cast<float>(HD)));
  return 0;
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kLanes = 4;                         // threads per query row (a) or key (b)
constexpr int kRowsPerBlock = kThreads / kLanes;  // 64

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4], float scale) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0] * scale, x[1] * scale, x[2] * scale,
                                              x[3] * scale);
}

// the sum over the 4 threads of a row (lanes 4i .. 4i + 3)
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// a 4096 / HD x HD f32 tile from rows [r0, r0 + n) of a (.., S, heads, HD)
// tensor at head `head`; zero rows past n
template <int HD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, size_t row_stride, int n) {
  constexpr int CH = HD / 4;
  constexpr int TILE = 4096 / HD;
  for (int c = threadIdx.x; c < TILE * CH; c += kThreads) {
    const int j = c / CH, ch = c % CH;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < n) load4(src + static_cast<size_t>(j) * row_stride + ch * 4, x);
    *reinterpret_cast<float4*>(dst + j * HD + ch * 4) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ out,
                           const float* __restrict__ dout, const float* __restrict__ lse,
                           float* __restrict__ delta_ws, float* __restrict__ dq, int Sq, int Skv,
                           int H, int KV, int causal, int q_off, float scale) {
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
  float dsum = 0.f;
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
    for (int e = 0; e < 4; ++e) dsum = fmaf(dor[c][e], o4[e], dsum);
  }
  dsum = quad_sum(dsum);
  const size_t roff = (static_cast<size_t>(b) * H + h) * Sq + row;
  const float row_lse = live ? lse[roff] : 0.f;
  if (live && sub == 0) delta_ws[roff] = dsum;

  // keys the block needs: a causal block stops at its last row
  const int last = min(q0 + kRowsPerBlock, Sq) - 1;
  const int n_keys = causal ? min(q_off + last + 1, Skv) : Skv;
  const int row_last = !live ? -1 : (causal ? q_off + row : Skv - 1);  // last key it sees
  const size_t krow = static_cast<size_t>(KV) * HD;
  const float* kbase = k + static_cast<size_t>(b) * Skv * krow + static_cast<size_t>(kvh) * HD;
  const float* vbase = v + static_cast<size_t>(b) * Skv * krow + static_cast<size_t>(kvh) * HD;

  for (int t0 = 0; t0 < n_keys; t0 += TILE) {
    const int nt = min(TILE, n_keys - t0);
    __syncthreads();  // the previous tile is no longer read
    stage_rows<HD>(ks, kbase + static_cast<size_t>(t0) * krow, krow, nt);
    stage_rows<HD>(vs, vbase + static_cast<size_t>(t0) * krow, krow, nt);
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
      const float ds = p * (dp - dsum);
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

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta_ws,
                             float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv,
                             int H, int KV, int causal, int q_off, float scale) {
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
  // (row p sits at position q_off + p)
  const int r_begin = causal ? max(k0 - q_off, 0) : 0;
  const size_t qrow = static_cast<size_t>(H) * HD;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* qbase = q + static_cast<size_t>(b) * Sq * qrow + static_cast<size_t>(h) * HD;
    const float* dobase = dout + static_cast<size_t>(b) * Sq * qrow + static_cast<size_t>(h) * HD;
    const size_t lbase = (static_cast<size_t>(b) * H + h) * Sq;
    for (int r0 = r_begin; r0 < Sq; r0 += TILE) {
      const int nr = min(TILE, Sq - r0);
      __syncthreads();  // the previous tile is no longer read
      stage_rows<HD>(qs, qbase + static_cast<size_t>(r0) * qrow, qrow, nr);
      stage_rows<HD>(dos, dobase + static_cast<size_t>(r0) * qrow, qrow, nr);
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
        const bool seen = live && (!causal || q_off + r0 + i >= key);
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

template <int HD>
int launch_dq_f32(const void* q, const void* k, const void* v, const void* out, const void* dout,
                  const void* lse, void* delta, void* dq, int B, int Sq, int Skv, int H, int KV,
                  int causal, int q_off, cudaStream_t s) {
  const dim3 grid((Sq + kRowsPerBlock - 1) / kRowsPerBlock, H, B);
  flash_attention_bwd_dq_f32<HD><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(out), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta), static_cast<float*>(dq), Sq,
      Skv, H, KV, causal, q_off, 1.0f / sqrtf(static_cast<float>(HD)));
  return 0;
}

template <int HD>
int launch_dkdv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, void* dk, void* dv, int B, int Sq, int Skv, int H, int KV,
                    int causal, int q_off, cudaStream_t s) {
  const dim3 grid((Skv + kRowsPerBlock - 1) / kRowsPerBlock, KV, B);
  flash_attention_bwd_dkdv_f32<HD><<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), Sq, Skv,
      H, KV, causal, q_off, 1.0f / sqrtf(static_cast<float>(HD)));
  return 0;
}

int check_sizes(int B, int Skv, int H, int KV, int q_offset) {
  // B <= 65535: the f32 grids' z; the bf16 grids are one-dimensional
  if (Skv < 1 || KV < 1 || H < KV || H % KV != 0 || B > 65535 || H > 65535 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// (a): q, out, dout, dq (B, Sq, H, hd); k, v (B, Skv, KV, hd); lse and the
// delta workspace it writes (B, H, Sq) f32. All contiguous, 16-byte aligned,
// f32 (dtype 0) or bf16 (dtype 1) but lse and delta; hd 32, 64, 112 or 128.
// Returns cudaGetLastError().
int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* out,
                           const void* dout, const void* lse, void* delta, void* dq, int B,
                           int Sq, int Skv, int H, int KV, int hd, int causal, int q_offset,
                           int dtype, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  int err = check_sizes(B, Skv, H, KV, q_offset);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DQ(LAUNCH, HD) \
  LAUNCH<HD>(q, k, v, out, dout, lse, delta, dq, B, Sq, Skv, H, KV, causal, q_offset, s)
  err = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    switch (hd) {
      case 32: err = DQ(launch_dq_f32, 32); break;
      case 64: err = DQ(launch_dq_f32, 64); break;
      case 112: err = DQ(launch_dq_f32, 112); break;
      case 128: err = DQ(launch_dq_f32, 128); break;
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 32: err = DQ(launch_dq_bf16, 32); break;
      case 64: err = DQ(launch_dq_bf16, 64); break;
      case 112: err = DQ(launch_dq_bf16, 112); break;
      case 128: err = DQ(launch_dq_bf16, 128); break;
    }
  }
#undef DQ
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// (b), after (a) on the same stream: q, dout (B, Sq, H, hd); k, v, dk, dv
// (B, Skv, KV, hd); lse and (a)'s delta (B, H, Sq) f32.
int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dk, void* dv, int B,
                             int Sq, int Skv, int H, int KV, int hd, int causal, int q_offset,
                             int dtype, void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  int err = check_sizes(B, Skv, H, KV, q_offset);
  if (err) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DKDV(LAUNCH, HD) \
  LAUNCH<HD>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, H, KV, causal, q_offset, s)
  err = static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    switch (hd) {
      case 32: err = DKDV(launch_dkdv_f32, 32); break;
      case 64: err = DKDV(launch_dkdv_f32, 64); break;
      case 112: err = DKDV(launch_dkdv_f32, 112); break;
      case 128: err = DKDV(launch_dkdv_f32, 128); break;
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 32: err = DKDV(launch_dkdv_bf16, 32); break;
      case 64: err = DKDV(launch_dkdv_bf16, 64); break;
      case 112: err = DKDV(launch_dkdv_bf16, 112); break;
      case 128: err = DKDV(launch_dkdv_bf16, 128); break;
    }
  }
#undef DKDV
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
