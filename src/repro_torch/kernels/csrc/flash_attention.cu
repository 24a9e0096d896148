// Causal / non-causal GQA flash attention (prefill) on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/attention/kernel.py
// (flash_attention_pallas -> _flash_kernel): an online softmax over KV
// chunks, causal programs stopping after the chunk that holds their last
// query row, f32 accumulation, output in q's dtype. It computes what the
// model's prefill computes (repro/models/attention.py blockwise_attention).
//
// What bounds it on the H100: 4 hd flop per (query, key) pair against 2 hd
// bytes of K and V per key, so at prefill lengths of a few hundred tokens and
// more the work is operations, and those belong on the tensor cores. At the
// serving path's length (one prompt of 128 tokens, 9 query heads over 3 KV
// heads) the whole call is a few microseconds of latency: a handful of blocks,
// each one load of Q and two K/V tiles, so what counts there is that no block
// waits on a tile it could have had in flight.
//
// bf16 (the serving path): flash_attention_mma, products on the tensor cores
// with mma.sync.m16n8k16 (bf16 in, f32 accumulate).
//   * Rows are packed per KV head: the G query heads of a KV head become the
//     rows of one M dimension, query-position-major (packed row r is position
//     r / G, head member r % G). One block per (tile of 32 or 64 packed rows,
//     KV head, batch row), one warp per 16 rows; all G heads share every
//     staged K/V tile, and a causal block still stops after the tile that
//     holds its last position. Blocks are issued heaviest (last rows) first.
//   * A grid of fewer blocks than the card has SMs (the serving path's one
//     prompt of 128 has 18 blocks of 64 rows for 132 SMs) leaves SMs idle and
//     each block's key tiles in one serial chain, at about 2 us per tile. Such
//     a launch runs two warp groups per block, group g taking tiles g, g + 2,
//     ... for the same rows, merged by the log-sum-exp rule at the end; and it
//     takes blocks of 32 rows where even those are fewer than the SMs.
//   * K/V tiles of 64 keys stay bf16 in shared memory as loaded, brought in by
//     cp.async and double-buffered: the next tiles load while the current
//     ones are computed. Rows are padded by 16 bytes so ldmatrix reads 8 rows
//     from 8 distinct bank groups. Q comes the same way once and stays in
//     registers as A fragments for the whole loop.
//   * S = Q K^T: ldmatrix on K rows gives the col-major B fragments directly;
//     a k-step's fragments are all loaded before its independent mmas. The
//     k-steps go two at a time (32 head dims); hd = 112 (kimi-k2) has 7
//     k-steps of 16, and its last one loads the B fragments of two n-tiles
//     per ldmatrix.x4 instead (14 n-tiles of 8 for P V as for any hd that is
//     a multiple of 16). The
//     scale is applied to S in f32 (1/sqrt(hd) is not a power of two for hd
//     32 and 128), folded with log2(e) into one factor so that the online
//     softmax takes 2^x (ex2.approx) on the accumulator fragments: each
//     thread holds two rows, whose max and sum reduce as trees over its 16
//     values and over the lane quad by shuffles. Masking runs only in tiles
//     that cross the diagonal or Skv.
//   * O += P V keeps P at about 16 bits: P = hi + lo with hi = bf16(P) and
//     lo = bf16(P - hi), both multiplied by V (ldmatrix.trans) into one f32
//     accumulator. A bf16 P alone moves outputs by up to ~10x the per-element
//     tolerance against the f32-P reference (tests/test_torch_attention.py
//     emulates both); the split stays inside it at twice the P V products.
//   * mma.sync rather than wgmma: at the serving path's shapes the work is
//     latency-bound with 18-72 blocks, and a 64-row warpgroup tile per block
//     would leave even more of the card idle.
//
// f32: flash_attention_f32, the first version's CUDA-core kernel (its key
// tile is 4096 / hd keys rounded down to whole chunks of 16: 32 at hd 112).
// Its 2e-5 agreement with the reference (tests/test_kernels.py) cannot be met
// with bf16 operands, and no path of the port runs attention in f32 on the
// card. One block of 128 threads per (64 query rows, query head, batch row),
// two threads per row each owning half of the head dim; K and V staged in
// shared memory as f32, products and online softmax in f32 registers.
//
// Head dims 32, 64, 112 and 128 are instantiated; 112 (kimi-k2) is not a
// multiple of 32, and neither kernel pads it: rows stay 112 wide in memory.
//
// Both take any Sq and Skv: keys past Skv (or past a row, when causal) are
// masked, rows past Sq compute but write nothing.
//
// Query offset: a causal call takes q_offset >= 0, and query row p sits at
// position q_offset + p (a sequence shard's rows, against keys gathered from
// position 0: runtime/sharded_attention.py). Every causal bound above (a
// block's key count, a warp's tile skip, its edge test and the mask) counts
// from that position; with q_offset 0 the kernel is the one it was.
//
// Training: given an lse pointer, both also write each row's log-sum-exp of
// its scaled scores, lse = m + log(max(l, 1e-30)) in natural-log units, f32,
// in (B, H, Sq) layout (the residual the backward kernels of
// flash_attention_bwd.cu read, as the JAX package's _flash_fwd_core returns
// it). The mma kernel writes it after its two warp groups are merged by the
// log-sum-exp rule; its packed row r is position r / G, head member r % G.
// It is instantiated with and without the write (LSE), so the serving path
// (a null pointer) runs the code it ran before the write existed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// packed rows per bf16 block are chosen per launch (launch_bf16); defining
// FLASH_ROWS (32 or 64) fixes them, for measuring one choice against another

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kKeys = 64;  // keys per staged K/V tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when bytes == 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// 2^x (ex2.approx: 2 ulp; 0 for -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x, y) -> hi = bf16(x, y) and lo = bf16(x - hi, y - hi), packed
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = pack_bf16(h);
  lo = pack_bf16(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

template <int HD, int ROWS, int SPLIT>
constexpr int smem_bytes_bf16() {
  // the Q tile, then 2 stages of SPLIT K tiles and SPLIT V tiles
  return (ROWS + 4 * SPLIT * kKeys) * (HD + 8) * 2;
}

// max and sum over the 16 values of each of a thread's two rows, as trees
__device__ __forceinline__ float max16(const float (&s)[8][4], int h) {
  float t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = fmaxf(s[j][2 * h], s[j][2 * h + 1]);
#pragma unroll
  for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
  return t[0];
}
__device__ __forceinline__ float sum16(const float (&s)[8][4], int h) {
  float t[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) t[j] = s[j][2 * h] + s[j][2 * h + 1];
#pragma unroll
  for (int w = 4; w >= 1; w >>= 1)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] += t[j + w];
  return t[0];
}

// ROWS packed rows per block, a warp per 16; SPLIT warp groups of ROWS / 16
// warps: group g takes key tiles g, g + SPLIT, ... for the same rows, and
// the groups merge (m, l, O) at the end; LSE: also write each row's
// log-sum-exp to lse
template <int HD, int ROWS, int SPLIT, bool LSE>
__global__ void __launch_bounds__(ROWS * 2 * SPLIT)
flash_attention_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int Sq, int Skv, int H, int KV, int causal,
                    int q_off, float scale_log2) {
  constexpr int ROW = HD + 8;  // bf16 per smem row: 16 bytes of pad
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  constexpr int KSTEPS = HD / 16;
  constexpr int NT = HD / 8;   // 8-wide n-tiles of the output
  constexpr int GROUP = ROWS * 2;  // threads of a warp group
  constexpr int THREADS = GROUP * SPLIT;
  constexpr int TILE = kKeys * ROW;  // bf16 of one staged K or V tile
  static_assert(HD % 16 == 0 && ROWS % 16 == 0 && (SPLIT == 1 || SPLIT == 2), "shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sk = sq + ROWS * ROW;         // [2 stages][SPLIT][kKeys][ROW]
  __nv_bfloat16* sv = sk + 2 * SPLIT * TILE;   // [2 stages][SPLIT][kKeys][ROW]

  const int G = H / KV;
  const int rows = Sq * G;  // packed rows of this (batch row, KV head)
  const int r0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // heaviest tiles first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rw = (tid >> 5) % (ROWS / 16);  // the warp's 16 rows
  const int grp = tid / GROUP;             // the warp's share of the key tiles

  const int r_last = min(r0 + ROWS, rows) - 1;
  const int n_keys = causal ? min(q_off + r_last / G + 1, Skv) : Skv;
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;
  const int n_steps = (n_tiles + SPLIT - 1) / SPLIT;

  // Q tile (zero rows past the end), then K/V tiles of step 0
  for (int c = tid; c < ROWS * CH; c += THREADS) {
    const int rr = c / CH, ch = c % CH, r = r0 + rr;
    const __nv_bfloat16* src = q;
    int bytes = 0;
    if (r < rows) {
      src = q + ((static_cast<size_t>(b) * Sq + r / G) * H + kvh * G + r % G) * HD + ch * 8;
      bytes = 16;
    }
    cp_async16(sq + rr * ROW + ch * 8, src, bytes);
  }
  cp_async_commit();

  const size_t krow = static_cast<size_t>(KV) * HD;
  const __nv_bfloat16* kbase = k + static_cast<size_t>(b) * Skv * krow + static_cast<size_t>(kvh) * HD;
  const __nv_bfloat16* vbase = v + static_cast<size_t>(b) * Skv * krow + static_cast<size_t>(kvh) * HD;
  auto load_step = [&](int step, int stage) {  // key tiles step * SPLIT + g, g < SPLIT
    for (int c = tid; c < SPLIT * kKeys * CH; c += THREADS) {
      const int j = c / CH, ch = c % CH, key = step * SPLIT * kKeys + j;
      const bool live = key < Skv;
      const size_t off = live ? static_cast<size_t>(key) * krow + ch * 8 : 0;
      const int dst = stage * SPLIT * TILE + j * ROW + ch * 8;
      cp_async16(sk + dst, kbase + off, live ? 16 : 0);
      cp_async16(sv + dst, vbase + off, live ? 16 : 0);
    }
  };
  load_step(0, 0);
  cp_async_commit();

  // this thread's rows: g and g + 8 of its warp's 16
  const int wr0 = r0 + rw * 16;
  const bool warp_live = wr0 < rows;
  // positions count from q_off (causal: row p sees keys <= q_off + p)
  const int w_lo = q_off + wr0 / G;                      // first position of the warp
  const int w_hi = q_off + min(wr0 + 15, rows - 1) / G;  // last live position of the warp
  const int pos_a = q_off + (wr0 + (lane >> 2)) / G;
  const int pos_b = q_off + (wr0 + (lane >> 2) + 8) / G;

  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk)
    ldmatrix_x4(qf[kk], sq + (rw * 16 + (lane & 15)) * ROW + kk * 16 + (lane >> 4) * 8);

  float o[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      load_step(step + 1, (step + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int t = step * SPLIT + grp;
    const int k0 = t * kKeys;
    if (warp_live && t < n_tiles && !(causal && k0 > w_hi)) {
      const __nv_bfloat16* kt = sk + ((step & 1) * SPLIT + grp) * TILE;
      const __nv_bfloat16* vt = sv + ((step & 1) * SPLIT + grp) * TILE;

      // S = Q K^T over 64 keys: 8 n-tiles of 8 keys, two k-steps at a time;
      // all fragments of a step are loaded before its 16 independent mmas
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk + 1 < KSTEPS; kk += 2) {
        uint32_t bk[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          ldmatrix_x4(bk[j], kt + (j * 8 + (lane & 7)) * ROW + kk * 16 + (lane >> 3) * 8);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_bf16(s[j], qf[kk], bk[j][0], bk[j][1]);
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_bf16(s[j], qf[kk + 1], bk[j][2], bk[j][3]);
      }
      if (KSTEPS % 2) {  // the last k-step alone: matrices 0-1 are n-tile 2 jp, 2-3 n-tile 2 jp + 1
        constexpr int kk = KSTEPS - 1;
        uint32_t bk[4][4];
#pragma unroll
        for (int jp = 0; jp < 4; ++jp)
          ldmatrix_x4(bk[jp], kt + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * ROW + kk * 16 +
                                  ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          mma_bf16(s[2 * jp], qf[kk], bk[jp][0], bk[jp][1]);
          mma_bf16(s[2 * jp + 1], qf[kk], bk[jp][2], bk[jp][3]);
        }
      }

      // scale to log2 units; mask where the tile crosses Skv or (causal) the
      // warp's diagonal. m, alpha and P are taken with 2^x: the scale and
      // log2(e) are one f32 factor, so p = 2^(s c - m) is e^(s / sqrt(hd)
      // - m') to a few f32 ulps of the exponent.
      const bool edge = k0 + kKeys > Skv || (causal && k0 + kKeys - 1 > w_lo);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * scale_log2;
          if (edge) {
            const int key = k0 + j * 8 + 2 * (lane & 3) + (e & 1);
            if (key >= Skv || (causal && key > (e < 2 ? pos_a : pos_b))) x = -INFINITY;
          }
          s[j][e] = x;
        }
      }
      float mx[2] = {fmaxf(m[0], max16(s, 0)), fmaxf(m[1], max16(s, 1))};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      }
      const float alpha[2] = {ex2(m[0] - mx[0]), ex2(m[1] - mx[1])};
      m[0] = mx[0];
      m[1] = mx[1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = ex2(s[j][e] - mx[e >> 1]);  // 0 for a masked key
      }
      l[0] = l[0] * alpha[0] + sum16(s, 0);
      l[1] = l[1] * alpha[1] + sum16(s, 1);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }

      // O += (P_hi + P_lo) V, 16 keys per step; P's accumulator fragments
      // are already the A fragments' layout. Each step loads its V fragments
      // first, then runs the hi products over every n-tile, then the lo ones.
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
        uint32_t bv[NT / 2][4];
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp)
          ldmatrix_x4_trans(bv[jp], vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ROW +
                                        jp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          mma_bf16(o[2 * jp], ph, bv[jp][0], bv[jp][1]);
          mma_bf16(o[2 * jp + 1], ph, bv[jp][2], bv[jp][3]);
        }
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          mma_bf16(o[2 * jp], pl, bv[jp][0], bv[jp][1]);
          mma_bf16(o[2 * jp + 1], pl, bv[jp][2], bv[jp][3]);
        }
      }
    }
    __syncthreads();  // this stage is free for step + 2
  }

  if (SPLIT > 1) {
    // group 1 hands its (m, l, O) to group 0 through the (now free) K/V
    // tiles, thread by thread: the two threads hold the same rows and columns
    constexpr int VALS = NT * 4 + 4;
    float* xfer = reinterpret_cast<float*>(sk);  // [VALS][GROUP]
    const int gt = tid % GROUP;
    if (grp == 1 && warp_live) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) xfer[(j * 4 + e) * GROUP + gt] = o[j][e];
      xfer[(NT * 4) * GROUP + gt] = m[0];
      xfer[(NT * 4 + 1) * GROUP + gt] = m[1];
      xfer[(NT * 4 + 2) * GROUP + gt] = l[0];
      xfer[(NT * 4 + 3) * GROUP + gt] = l[1];
    }
    __syncthreads();
    if (grp == 1) return;
    if (warp_live) {
      float a0[2], a1[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m1 = xfer[(NT * 4 + h) * GROUP + gt];
        const float mm = fmaxf(m[h], m1);
        a0[h] = ex2(m[h] - mm);
        a1[h] = ex2(m1 - mm);
        l[h] = l[h] * a0[h] + xfer[(NT * 4 + 2 + h) * GROUP + gt] * a1[h];
        if (LSE) m[h] = mm;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[j][e] = o[j][e] * a0[e >> 1] + xfer[(j * 4 + e) * GROUP + gt] * a1[e >> 1];
    }
  }

  if (!warp_live) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr0 + (lane >> 2) + 8 * h;
    if (r >= rows) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    if (LSE && (lane & 3) == 0)  // m and l are in log2 units
      lse[(static_cast<size_t>(b) * H + kvh * G + r % G) * Sq + r / G] =
          (m[h] + log2f(fmaxf(l[h], 1e-30f))) * 0.6931471805599453f;
    __nv_bfloat16* op =
        out + ((static_cast<size_t>(b) * Sq + r / G) * H + kvh * G + r % G) * HD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + j * 8) =
          __floats2bfloat162_rn(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
  }
}

template <int HD, int ROWS, int SPLIT, bool LSE>
int launch_tiles(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
                 int Skv, int H, int KV, int causal, int q_off, cudaStream_t stream) {
  constexpr int smem = smem_bytes_bf16<HD, ROWS, SPLIT>();
  // group 1's (m, l, O) must fit where its K tiles were
  static_assert(SPLIT == 1 || (HD / 2 + 4) * 4 * ROWS * 2 <= 2 * SPLIT * kKeys * (HD + 8) * 2,
                "split transfer");
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_mma<HD, ROWS, SPLIT, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Sq * (H / KV) + ROWS - 1) / ROWS, KV, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(HD));  // log2(e) / sqrt(hd)
  flash_attention_mma<HD, ROWS, SPLIT, LSE><<<grid, ROWS * 2 * SPLIT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, Sq, Skv, H, KV,
      causal, q_off, scale_log2);
  return 0;
}

// Blocks of 64 packed rows, unless the grid then has fewer blocks than the
// card has SMs: that leaves SMs idle and each block's key tiles in one
// chain, so such a launch splits every block's key tiles over two warp
// groups, and takes blocks of 32 rows where even those are fewer than the
// SMs (the serving path's prompt of 128: 36 blocks of 32 rows).
template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
                int Skv, int H, int KV, int causal, int q_off, cudaStream_t stream) {
  static int sm_count[64];  // per device, read once (0: not yet)
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sm_count[device] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    sm_count[device] = n;
  }
  const long long rows = static_cast<long long>(Sq) * (H / KV);
  const auto blocks = [&](int r) { return (rows + r - 1) / r * KV * B; };
#define FLASH_LAUNCH(R, S)                                                                  \
  (lse != nullptr ? launch_tiles<HD, R, S, true>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal,  \
                                                 q_off, stream)                                 \
                  : launch_tiles<HD, R, S, false>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal, \
                                                  q_off, stream))
#ifdef FLASH_ROWS
  return blocks(FLASH_ROWS) < sm_count[device] ? FLASH_LAUNCH(FLASH_ROWS, 2)
                                               : FLASH_LAUNCH(FLASH_ROWS, 1);
#else
  if (blocks(32) < sm_count[device]) return FLASH_LAUNCH(32, 2);
  if (blocks(64) < sm_count[device]) return FLASH_LAUNCH(64, 2);
  return FLASH_LAUNCH(64, 1);
#endif
#undef FLASH_LAUNCH
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kRows = kThreads / 2;  // query rows per block
constexpr int kChunk = 16;           // keys per online-softmax update

__device__ __forceinline__ void load16(const float* p, float (&out)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

__device__ __forceinline__ void store16(float* p, const float (&in)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ lse, int Sq, int Skv, int H, int KV, int causal,
                    int q_off, float scale) {
  constexpr int EPL = 4;                                 // floats per 16-byte load
  constexpr int HALF = HD / 2;                           // head-dim share of one thread
  constexpr int TILE = 4096 / HD / kChunk * kChunk;      // keys per shared-memory tile
  constexpr int ROW = HD + 8;                            // smem floats per key row
  constexpr int CPR = HD / EPL;                          // 16-byte chunks per key row
  static_assert(HALF % EPL == 0 && TILE % kChunk == 0, "head dim");

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
  const float* qp = q + ((static_cast<size_t>(b) * Sq + row) * H + hh) * HD + half * HALF;
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
  const int n_keys = causal ? min(q_off + last + 1, Skv) : Skv;
  const int row_last = causal ? q_off + row : Skv - 1;  // last key this row sees
  const size_t krow = static_cast<size_t>(KV) * HD;
  const float* kbase = k + static_cast<size_t>(b) * Skv * krow + static_cast<size_t>(kvh) * HD;
  const float* vbase = v + static_cast<size_t>(b) * Skv * krow + static_cast<size_t>(kvh) * HD;
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
      *reinterpret_cast<float4*>(ks + so) = make_float4(kf[0], kf[1], kf[2], kf[3]);
      *reinterpret_cast<float4*>(vs + so) = make_float4(vf[0], vf[1], vf[2], vf[3]);
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
  if (lse != nullptr && half == 0)  // both threads of the row hold the same m and l
    lse[(static_cast<size_t>(b) * H + hh) * Sq + row] = m + logf(fmaxf(l, 1e-30f));
  float* op = out + ((static_cast<size_t>(b) * Sq + row) * H + hh) * HD + half * HALF;
#pragma unroll
  for (int c = 0; c < HALF; c += EPL) {
    float tmp[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) tmp[e] = acc[c + e] * inv;
    store16(op + c, tmp);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
               int Skv, int H, int KV, int causal, int q_off, cudaStream_t stream) {
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  const float scale = 1.0f / sqrtf(static_cast<float>(HD));
  flash_attention_f32<HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, Sq, Skv, H, KV, causal, q_off, scale);
  return 0;
}

int launch_hd(const void* q, const void* k, const void* v, void* out, float* lse, int B, int Sq,
              int Skv, int H, int KV, int hd, int causal, int q_off, int dtype, cudaStream_t s) {
  if (dtype == 0) {
    switch (hd) {
      case 32: return launch_f32<32>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal, q_off, s);
      case 64: return launch_f32<64>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal, q_off, s);
      case 112: return launch_f32<112>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal, q_off, s);
      case 128: return launch_f32<128>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal, q_off, s);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 32: return launch_bf16<32>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal, q_off, s);
      case 64: return launch_bf16<64>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal, q_off, s);
      case 112: return launch_bf16<112>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal, q_off, s);
      case 128: return launch_bf16<128>(q, k, v, out, lse, B, Sq, Skv, H, KV, causal, q_off, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q (B, Sq, H, hd); k, v (B, Skv, KV, hd); out (B, Sq, H, hd). All
// contiguous, 16-byte aligned, f32 (dtype 0) or bf16 (dtype 1). causal: query
// row p (counted from 0) sees keys <= q_offset + p (q_offset >= 0: the row's
// global position on a sequence shard); q_offset is ignored when not causal.
// lse: null,
// or (B, H, Sq) f32 for each row's log-sum-exp (the training forward).
// Returns cudaGetLastError().
int flash_attention(const void* q, const void* k, const void* v, void* out, void* lse, int B,
                    int Sq, int Skv, int H, int KV, int hd, int causal, int q_offset, int dtype,
                    void* stream) {
  if (B <= 0 || Sq <= 0) return 0;
  if (Skv < 1 || KV < 1 || H < KV || H % KV != 0 || B > 65535 || KV > 65535 || q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = launch_hd(q, k, v, out, static_cast<float*>(lse), B, Sq, Skv, H, KV, hd, causal,
                            q_offset, dtype, static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
