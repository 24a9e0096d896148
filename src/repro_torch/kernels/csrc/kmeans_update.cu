// The streaming K-Means update's sums on Hopper (sm_90a), in a fixed order:
// for labels (N,) and points (N, D),
//   sums[l, j] = sum over rows i with label l of x[i, j]
//   counts[l]  = the number of those rows
// where a row adds to no label when its label lies outside [0, K) or the
// mask gives it weight 0.
//
// Replaces no TPU kernel: the JAX package computes this with an
// order-preserving scatter (repro/kernels/kmeans/ref.py, update_scatter),
// whose sums are bit-identical from run to run. PyTorch's index_add_ adds
// with atomics on CUDA, in an order that changes between runs; these kernels
// keep every sum's order fixed by (N, D, K, dtype) and the labels alone, so
// an update repeats bit for bit. No floating-point atomics anywhere; the
// counts are integers. The caller (kernels/kmeans/ops.py, update_plan)
// chooses one of two regimes from (D, K, dtype) and passes its sizes; the
// entry point checks them.
//
// What bounds it: not bytes. 80 000 x 3 f32 is 960 KB of points and 320 KB
// of labels, 0.38 us at 3.35 TB/s, and 65 536 x 128 f32 is 32 MB, 10 us;
// a launch costs about 1 us, and a chain of launches each waits for the one
// before. The first port stable-sorted the labels with torch.sort (a library
// radix sort of 32-bit keys, several launches: 45 us of its 56 us at the
// stream's shape) though the labels lie in [0, K). So neither regime sorts
// with a library, the stream's shape sorts not at all, every launch after
// the first is a programmatic dependent (it starts while the one before it
// drains, and waits with griddepcontrol.wait before it reads that one's
// writes), and what a launch reads it reads with wide loads, all in flight.
//
// partials (K*D <= 256: the K-Means streams' 3 x 10). No sort, two launches:
// 1. partial_sums: block b takes block_rows consecutive rows in row order
//    (a count fixed by N and D), staged into shared memory by cp.async, 16
//    bytes a thread (80 000 x 3 f32 is one contiguous run). Thread (g, c)
//    owns the pair c = (label l, column j) and row group g of `groups` =
//    256 / (K D): it walks rows g, g + groups, ... of each tile and keeps a
//    Kahan step of x[i, j] where row i's label is l (computed for every row
//    and selected, so no lane waits on a branch), counting those rows as an
//    integer. The groups' (sum, compensation) pairs are added by a fixed
//    halving tree, each step a TwoSum that keeps the rounding error in the
//    compensation, into one K D partial a block.
// 2. merge_partials: block y takes 32 of the K D sums and K counts; warp w
//    loads the partials of blocks w, w + 8, ... (32 of them at once) and
//    adds them in block order, the warps by the same tree; each sum is
//    written as sum - compensation.
//
// sorted (K*D > 256: the wide stream's 128 x 1024). A deterministic counting
// sort of the labels replaces torch.sort, then the first port's segment and
// merge scheme sums in its order. Five launches:
// 1. sort_count: block u takes sort_rows = 2048 rows, 8 warps of 8 chunks
//    of 32 rows, each lane's 8 labels loaded at once; lanes with one label
//    in a chunk find each other with __match_any_sync and the highest adds
//    their number to its warp's count of that label (shared memory: 8 K
//    ints; in device memory where they do not fit 48 KB). The block's counts
//    per label go to hist[u, l].
// 2. sort_columns: a thread a label, its column of counts in flight at once:
//    before[u, l], the counts of blocks before u, and total[l].
// 3. sort_scatter: each block counts again by warp (before it waits for
//    sort_columns), scans the totals in label order (starts[l]; starts[K] =
//    the rows that add to a label; block 0 writes them), turns starts[l] +
//    before[u, l] and its warps' counts into first slots, and places each
//    row at its label's next slot after the earlier lanes of its chunk with
//    that label (popc of the match mask below the lane). Rows land in row
//    order within a label: order and starts equal torch.sort(stable=True)'s
//    and a searchsorted of the sorted labels, for labels in [0, K) (other
//    rows are left out).
// 4. segment_sums: the sorted rows are cut into segments of seg_rows rows,
//    whatever the labels, so the work is spread evenly however the rows fall
//    on the labels (the stream's 1024 labels, or every row on one). Block
//    (s, y) takes segment s and walks the pieces of label runs in it in
//    order: thread (r, q) sums rows r, r + R, ... of a piece (R = 256 / cols
//    rows in flight) for V consecutive columns from (y Q + q) V, with Kahan
//    addition, each row's V values one load (16 bytes where D and the base
//    allow: a 512-byte f32 row is one warp-wide load), so one block reads a
//    row of up to 32 V columns whole and reads the segment's order and
//    labels once. The block adds the R partials of a column by a fixed
//    halving tree. A run that lies wholly in the segment is written to sums;
//    the piece of a run that began in an earlier segment is the segment's
//    head partial, the piece of one that goes on past it is its tail.
// 5. merge_runs: block (l, y) adds the partials of a run that crosses
//    segments: the tail of its first segment, then the heads of the later
//    ones summed by the same scheme, V columns a thread; zeros for an empty
//    run; the counts are the runs' lengths.
// Which thread loads which columns (V, Q) does not enter any sum's order;
// R, seg_rows and cols come from D alone, as in the first port, whose sums
// these are to the bit for labels in [0, K) and no mask.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>
#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the counting sort: chunks of 32 rows a warp, rows a block
constexpr int kSortChunks = 8;
constexpr int kSortRows = kWarps * kSortChunks * 32;
constexpr int kColumnThreads = 128;
constexpr int kMergeBatch = 32;  // partials a merge thread loads at once
constexpr int kScanCache = 32;   // blocks whose counts sort_columns keeps in registers
constexpr int kSmemBytes = 48 * 1024;  // shared memory a block takes without opting in
constexpr int kStaticSmemBytes = 3 * kThreads * 4;  // partial_sums' own (its tree)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Kahan addition: sum + x, with the rounding error carried in comp (the
// pair stands for sum - comp)
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = x - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// (s, c) + (s2, c2), each pair standing for s - c: a TwoSum gives the
// rounding error of s + s2 exactly, and it joins the compensations
__device__ __forceinline__ void pair_add(float& s, float& c, float s2, float c2) {
  const float t = s + s2;
  const float bp = t - s;
  const float err = (s - (t - bp)) + (s2 - bp);
  c = (c + c2) - err;
  s = t;
}

// programmatic dependent launch (sm_90): a kernel launched by launch_after
// may start while the one before it drains; it waits for that one (and so
// for every launch before it) to finish and its writes to be visible before
// it reads what they wrote. A kernel lets the next one start once each of its
// blocks is past its own wait.
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// the label row i adds to, or -1: masked out (mask[i] == 0) or outside [0, K)
__device__ __forceinline__ int row_label(const int32_t* __restrict__ labels,
                                         const uint8_t* __restrict__ mask, long long i, int k) {
  const int l = labels[i];
  return (mask != nullptr && mask[i] == 0) || l < 0 || l >= k ? -1 : l;
}

// `bytes` from src to shared dst (16-byte aligned) by the whole block: 16
// bytes a thread by cp.async where src is aligned (the caller waits with
// cp.async.wait_all), else elements of `elem` bytes
__device__ __forceinline__ void stage(void* dst, const void* src, int bytes, int elem) {
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(s) & 15) == 0) {
    done = bytes & ~15;
    for (int i = threadIdx.x * 16; i < done; i += kThreads * 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       static_cast<uint32_t>(__cvta_generic_to_shared(d + i))),
                   "l"(s + i));
  }
  if (elem == 4) {
    for (int i = done + threadIdx.x * 4; i < bytes; i += kThreads * 4)
      *reinterpret_cast<uint32_t*>(d + i) = *reinterpret_cast<const uint32_t*>(s + i);
  } else {
    for (int i = done + threadIdx.x * 2; i < bytes; i += kThreads * 2)
      *reinterpret_cast<uint16_t*>(d + i) = *reinterpret_cast<const uint16_t*>(s + i);
  }
}

// ---------------------------------------------------------------- partials

template <typename T>
__global__ void __launch_bounds__(kThreads)
partial_sums(const T* __restrict__ points, const int32_t* __restrict__ labels,
             const uint8_t* __restrict__ mask, float* __restrict__ part,
             int32_t* __restrict__ part_n, int n, int k, int d, int block_rows, int tile_rows,
             int groups) {
  extern __shared__ __align__(16) unsigned char smem[];
  let_next_start();
  int* lab = reinterpret_cast<int*>(smem);                   // tile_rows labels
  T* x = reinterpret_cast<T*>(smem + tile_rows * 4);          // tile_rows x d values
  __shared__ float ps[kThreads], pc[kThreads];
  __shared__ int pn[kThreads];
  const int kd = k * d;
  const int c = threadIdx.x % kd, g = threadIdx.x / kd;     // (label, column) pair, row group
  const int l = c / d, j = c % d;
  float s = 0.f, comp = 0.f;
  int cnt = 0;
  const long long lo = static_cast<long long>(blockIdx.x) * block_rows;
  const long long hi = min(lo + block_rows, static_cast<long long>(n));
  for (long long r0 = lo; r0 < hi; r0 += tile_rows) {
    const int rows = static_cast<int>(min(static_cast<long long>(tile_rows), hi - r0));
    __syncthreads();  // the last tile is read
    stage(lab, labels + r0, rows * 4, 4);
    stage(x, points + r0 * d, rows * d * static_cast<int>(sizeof(T)), sizeof(T));
    asm volatile("cp.async.wait_all;\n" ::);
    if (mask != nullptr) {
      __syncthreads();
      for (int i = threadIdx.x; i < rows; i += kThreads)
        if (mask[r0 + i] == 0) lab[i] = -1;
    }
    __syncthreads();
    if (g < groups) {
#pragma unroll 4
      for (int i = g; i < rows; i += groups) {  // every row's step computed, kept where it hits
        const bool hit = lab[i] == l;
        float t = s, tc = comp;
        kahan_add(t, tc, to_f32(x[i * d + j]));
        s = hit ? t : s;
        comp = hit ? tc : comp;
        cnt += hit;
      }
    }
  }
  ps[threadIdx.x] = s;
  pc[threadIdx.x] = comp;
  pn[threadIdx.x] = cnt;
  for (int m = groups; m > 1;) {  // groups m -> ceil(m / 2): group g takes g + h
    const int h = (m + 1) / 2;
    __syncthreads();
    if (g < m - h) {
      const int o = threadIdx.x + h * kd;
      float a = ps[threadIdx.x], b = pc[threadIdx.x];
      pair_add(a, b, ps[o], pc[o]);
      ps[threadIdx.x] = a;
      pc[threadIdx.x] = b;
      pn[threadIdx.x] += pn[o];
    }
    m = h;
  }
  __syncthreads();
  if (g == 0) {
    part[2LL * blockIdx.x * kd + c] = ps[c];
    part[(2LL * blockIdx.x + 1) * kd + c] = pc[c];
    if (j == 0) part_n[static_cast<long long>(blockIdx.x) * k + l] = pn[c];
  }
}

// block y: entries y * 32 + lane of the K D sums and then the K counts
__global__ void __launch_bounds__(kThreads)
merge_partials(const float* __restrict__ part, const int32_t* __restrict__ part_n,
               float* __restrict__ sums, float* __restrict__ counts, int blocks, int k, int d) {
  __shared__ float ms[kWarps][32], mc[kWarps][32];
  __shared__ int mn[kWarps][32];
  const int kd = k * d;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f, c = 0.f;
  int cnt = 0;
  wait_for_previous();
  // blocks w, w + 8, ... in order, kMergeBatch of them loaded before they are added
  for (int b0 = w; b0 < blocks; b0 += kMergeBatch * kWarps) {
    float vs[kMergeBatch], vc[kMergeBatch];
    int vn[kMergeBatch];
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      const long long b = b0 + u * kWarps;
      const bool in = b < blocks;
      vs[u] = in && col < kd ? part[2 * b * kd + col] : 0.f;
      vc[u] = in && col < kd ? part[(2 * b + 1) * kd + col] : 0.f;
      vn[u] = in && col >= kd && col < kd + k ? part_n[b * k + col - kd] : 0;
    }
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      if (b0 + u * kWarps < blocks) {
        pair_add(s, c, vs[u], vc[u]);
        cnt += vn[u];
      }
    }
  }
  ms[w][lane] = s;
  mc[w][lane] = c;
  mn[w][lane] = cnt;
  for (int h = kWarps / 2; h > 0; h /= 2) {
    __syncthreads();
    if (w < h) {
      float a = ms[w][lane], b = mc[w][lane];
      pair_add(a, b, ms[w + h][lane], mc[w + h][lane]);
      ms[w][lane] = a;
      mc[w][lane] = b;
      mn[w][lane] += mn[w + h][lane];
    }
  }
  __syncthreads();
  if (w == 0) {
    if (col < kd) {
      sums[col] = ms[0][lane] - mc[0][lane];
    } else if (col < kd + k) {
      counts[col - kd] = static_cast<float>(mn[0][lane]);
    }
  }
}

// ------------------------------------------------------------ counting sort

// this block's counts per warp and label (kWarps x K) in `wh`: warp w takes
// chunks of 32 rows from blockIdx.x * kSortRows + w * kSortChunks * 32 on,
// its labels loaded up front
__device__ __forceinline__ void count_by_warp(int* wh, const int32_t* __restrict__ labels,
                                              const uint8_t* __restrict__ mask, int n, int k,
                                              int (&lab)[kSortChunks]) {
  for (int i = threadIdx.x; i < kWarps * k; i += kThreads) wh[i] = 0;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const long long lo = static_cast<long long>(blockIdx.x) * kSortRows + w * kSortChunks * 32 + lane;
#pragma unroll
  for (int r = 0; r < kSortChunks; ++r) {
    const long long i = lo + r * 32;
    lab[r] = i < n ? row_label(labels, mask, i, k) : -1;
  }
  __syncthreads();
  int* h = wh + w * k;
#pragma unroll
  for (int r = 0; r < kSortChunks; ++r) {
    const unsigned same = __match_any_sync(0xffffffffu, lab[r]);
    if (lab[r] >= 0 && lane == 31 - __clz(same)) h[lab[r]] += __popc(same);
    __syncwarp();
  }
  __syncthreads();
}

// the per-warp counts: in shared memory where kWarps K ints fit, else in
// this block's piece of `spill`
__device__ __forceinline__ int* warp_counts(int* smem, int32_t* spill, int k) {
  return spill == nullptr ? smem : spill + static_cast<long long>(blockIdx.x) * kWarps * k;
}

__global__ void __launch_bounds__(kThreads)
sort_count(const int32_t* __restrict__ labels, const uint8_t* __restrict__ mask,
           int32_t* __restrict__ hist, int32_t* __restrict__ spill, int n, int k) {
  extern __shared__ int sh[];
  let_next_start();
  int* wh = warp_counts(sh, spill, k);
  int lab[kSortChunks];
  count_by_warp(wh, labels, mask, n, k, lab);
  for (int l = threadIdx.x; l < k; l += kThreads) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += wh[w * k + l];
    hist[static_cast<long long>(blockIdx.x) * k + l] = t;
  }
}

// thread l: label l's column of the block counts, in flight at once where
// there are at most kScanCache blocks: before[u, l] = the counts of blocks
// before u, and total[l]
__global__ void __launch_bounds__(kColumnThreads)
sort_columns(const int32_t* __restrict__ hist, int32_t* __restrict__ before,
             int32_t* __restrict__ total, int units, int k) {
  wait_for_previous();
  let_next_start();
  const int l = blockIdx.x * kColumnThreads + threadIdx.x;
  if (l >= k) return;
  int run = 0;
  if (units <= kScanCache) {
    int cached[kScanCache];
#pragma unroll
    for (int u = 0; u < kScanCache; ++u)
      cached[u] = u < units ? hist[static_cast<long long>(u) * k + l] : 0;
#pragma unroll
    for (int u = 0; u < kScanCache; ++u) {
      if (u < units) before[static_cast<long long>(u) * k + l] = run;
      run += cached[u];
    }
  } else {
#pragma unroll 8
    for (int u = 0; u < units; ++u) {
      before[static_cast<long long>(u) * k + l] = run;
      run += hist[static_cast<long long>(u) * k + l];
    }
  }
  total[l] = run;
}

// the exclusive scan of total over the block's threads, chunk by chunk of
// kThreads labels: fn(l, first row of label l) for each label, in chunk
// order; returns the rows of all labels
template <typename Fn>
__device__ __forceinline__ int scan_labels(const int32_t* __restrict__ total, int k, Fn fn) {
  __shared__ int warp_tot[kWarps];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  int carry = 0;
  for (int base = 0; base < k; base += kThreads) {
    const int l = base + threadIdx.x;
    const int tot = l < k ? total[l] : 0;
    int v = tot;  // inclusive in the warp, then the warps' totals
    for (int o = 1; o < 32; o *= 2) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    __syncthreads();  // warp_tot of the last chunk is read
    if (lane == 31) warp_tot[w] = v;
    __syncthreads();
    int below = 0, all = 0;
    for (int x = 0; x < kWarps; ++x) {
      below += x < w ? warp_tot[x] : 0;
      all += warp_tot[x];
    }
    if (l < k) fn(l, carry + below + v - tot);
    carry += all;
  }
  return carry;
}

__global__ void __launch_bounds__(kThreads)
sort_scatter(const int32_t* __restrict__ labels, const uint8_t* __restrict__ mask,
             const int32_t* __restrict__ before, const int32_t* __restrict__ total,
             int32_t* __restrict__ spill, int32_t* __restrict__ starts,
             int32_t* __restrict__ order, int n, int k) {
  extern __shared__ int sh[];
  int* wh = warp_counts(sh, spill, k);
  int lab[kSortChunks];
  // sort_count is done (sort_columns let this kernel start only past its
  // own wait), so its per-warp counts may be overwritten before this wait
  count_by_warp(wh, labels, mask, n, k, lab);
  wait_for_previous();
  let_next_start();
  // label l's rows start at starts[l] (block 0 writes them); block u's at
  // starts[l] + before[u, l]; warp w's after the block's earlier warps'
  const int rows = scan_labels(total, k, [&](int l, int first) {
    if (blockIdx.x == 0) starts[l] = first;
    int run = first + before[static_cast<long long>(blockIdx.x) * k + l];
    for (int w = 0; w < kWarps; ++w) {
      const int c = wh[w * k + l];
      wh[w * k + l] = run;
      run += c;
    }
  });
  if (blockIdx.x == 0 && threadIdx.x == 0) starts[k] = rows;
  __syncthreads();
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  int* h = wh + w * k;
  const long long lo = static_cast<long long>(blockIdx.x) * kSortRows + w * kSortChunks * 32 + lane;
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int r = 0; r < kSortChunks; ++r) {
    const unsigned same = __match_any_sync(0xffffffffu, lab[r]);
    if (lab[r] >= 0) order[h[lab[r]] + __popc(same & below)] = static_cast<int>(lo + r * 32);
    __syncwarp();
    if (lab[r] >= 0 && lane == 31 - __clz(same)) h[lab[r]] += __popc(same);
    __syncwarp();
  }
}

// ------------------------------------------------------------ segments

// V consecutive values of one row, one load
template <typename T, int V>
struct alignas(sizeof(T) * V) Row {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
segment_sums(const T* __restrict__ points, const int32_t* __restrict__ labels,
             const int32_t* __restrict__ order, const int32_t* __restrict__ starts,
             float* __restrict__ sums, float* __restrict__ part, int n, int k, int d, int cols,
             int seg_rows, int q_lanes) {
  __shared__ float psum[V][kThreads];
  const int s = blockIdx.x;
  const int rows = kThreads / cols;
  const int r = threadIdx.x / q_lanes, q = threadIdx.x % q_lanes;
  const int j0 = (blockIdx.y * q_lanes + q) * V;
  const long long seg_lo = static_cast<long long>(s) * seg_rows;
  const int seg_hi = static_cast<int>(min(seg_lo + seg_rows, static_cast<long long>(n)));
  int start = static_cast<int>(seg_lo);
  wait_for_previous();
  let_next_start();
  const int stop = min(seg_hi, starts[k]);

  while (start < stop) {  // one piece of a run, [start, end): the same for every thread
    const int l = labels[order[start]];
    const int run_lo = starts[l], run_hi = starts[l + 1];
    const int end = min(run_hi, stop);
    if (end <= start) break;  // no run holds `start`: order and starts disagree
    float sum[V], comp[V];
#pragma unroll
    for (int v = 0; v < V; ++v) sum[v] = comp[v] = 0.f;
    if (j0 < d) {
      for (int i = start + r; i < end; i += rows) {
        const Row<T, V> row =
            *reinterpret_cast<const Row<T, V>*>(points + static_cast<long long>(order[i]) * d + j0);
#pragma unroll
        for (int v = 0; v < V; ++v) kahan_add(sum[v], comp[v], to_f32(row.v[v]));
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) psum[v][r * q_lanes + q] = sum[v];
    for (int h = rows / 2; h > 0; h /= 2) {  // each column's R partials by a halving tree
      __syncthreads();
      if (r < h) {
#pragma unroll
        for (int v = 0; v < V; ++v) psum[v][r * q_lanes + q] += psum[v][(r + h) * q_lanes + q];
      }
    }
    __syncthreads();
    if (r == 0 && j0 < d) {
      float* out;
      if (run_lo >= seg_lo && run_hi <= seg_hi) {  // the whole run
        out = sums + static_cast<long long>(l) * d;
      } else {  // this piece's partials: head or tail of the segment
        out = part + (2LL * s + (run_lo < seg_lo ? 0 : 1)) * d;
      }
#pragma unroll
      for (int v = 0; v < V; ++v) out[j0 + v] = psum[v][q];
    }
    start = end;  // psum[.][q] is read and written next by thread (0, q) alone
  }
}

// block (l, y): label l's run, V consecutive columns a thread from
// (y Q + q) V; thread row r sums the heads of segments s0 + 1 + r, + R, ...
template <int V>
__global__ void __launch_bounds__(kThreads)
merge_runs(const int32_t* __restrict__ starts, const float* __restrict__ part,
           float* __restrict__ sums, float* __restrict__ counts, int d, int cols, int seg_rows,
           int q_lanes) {
  __shared__ float psum[V][kThreads];
  const int l = blockIdx.x;
  const int rows = kThreads / cols;
  const int r = threadIdx.x / q_lanes, q = threadIdx.x % q_lanes;
  const int j0 = (blockIdx.y * q_lanes + q) * V;
  wait_for_previous();
  const int lo = starts[l], hi = starts[l + 1];
  if (blockIdx.y == 0 && threadIdx.x == 0) counts[l] = static_cast<float>(hi - lo);
  float* out = sums + static_cast<long long>(l) * d + j0;
  if (hi == lo) {  // an empty run: zeros
    if (r == 0 && j0 < d) {
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = 0.f;
    }
    return;
  }
  const int s0 = lo / seg_rows, s1 = (hi - 1) / seg_rows;
  if (s0 == s1) return;  // the run lies in one segment, written whole by segment_sums
  float sum[V], comp[V];
#pragma unroll
  for (int v = 0; v < V; ++v) sum[v] = comp[v] = 0.f;
  if (j0 < d) {
    for (int s = s0 + 1 + r; s <= s1; s += rows) {  // heads of the later segments
      const Row<float, V> head = *reinterpret_cast<const Row<float, V>*>(part + 2LL * s * d + j0);
#pragma unroll
      for (int v = 0; v < V; ++v) kahan_add(sum[v], comp[v], head.v[v]);
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) psum[v][r * q_lanes + q] = sum[v];
  for (int h = rows / 2; h > 0; h /= 2) {  // each column's R partials by a halving tree
    __syncthreads();
    if (r < h) {
#pragma unroll
      for (int v = 0; v < V; ++v) psum[v][r * q_lanes + q] += psum[v][(r + h) * q_lanes + q];
    }
  }
  __syncthreads();
  if (r == 0 && j0 < d) {  // the first one's tail first
    const float* tail = part + (2LL * s0 + 1) * d + j0;
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = tail[v] + psum[v][q];
  }
}

// ------------------------------------------------------------ launchers

// launches the kernel at position `at` of the regime only while at <
// stop_after (0: all of them): tools/tile_sweep.py times the regime's phases
#define LAUNCH(at, ...)                         \
  do {                                          \
    if (stop_after == 0 || (at) < stop_after) { \
      __VA_ARGS__;                              \
    }                                           \
  } while (0)

// kernel<<<grid, block, smem, stream>>>(args...) as a programmatic
// dependent of the launch before it on the stream (see wait_for_previous)
template <typename... Params, typename... Args>
void launch_after(void (*kernel)(Params...), dim3 grid, dim3 block, int smem,
                  cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

template <typename T>
void launch_partials(const T* points, const int32_t* labels, const uint8_t* mask, int32_t* iwork,
                     float* fwork, float* sums, float* counts, int n, int k, int d,
                     int block_rows, int tile_rows, int groups, int stop_after,
                     cudaStream_t stream) {
  const int blocks = (n + block_rows - 1) / block_rows;
  const int staged = std::min(tile_rows, block_rows);  // the rows a tile takes at most
  const int smem = staged * (4 + d * static_cast<int>(sizeof(T)));
  if (blocks > 0)
    LAUNCH(0, partial_sums<T><<<blocks, kThreads, smem, stream>>>(
                  points, labels, mask, fwork, iwork, n, k, d, block_rows, staged, groups));
  LAUNCH(1, launch_after(merge_partials, (k * d + k + 31) / 32, kThreads, 0, stream, fwork, iwork,
                         sums, counts, blocks, k, d));
}

// values of `elem` bytes a load for rows of D from `base`: the most, up to
// 16 bytes, that divides D and the base's alignment (no sum depends on it)
int row_vector(const void* base, int elem, int d) {
  int v = 16 / elem;
  while (v > 1 && (d % v != 0 || reinterpret_cast<uintptr_t>(base) % (v * elem) != 0)) v /= 2;
  return v;
}

// fn(std::integral_constant<int, V>) for V = v, the values a load of one row
// takes (16 bytes of 2-byte values at most, 4-byte ones 4)
template <int Max, typename Fn>
void with_row_vector(int v, Fn fn) {
  if constexpr (Max == 8) {
    if (v == 8) return fn(std::integral_constant<int, 8>{});
  }
  if (v >= 4) return fn(std::integral_constant<int, 4>{});
  if (v == 2) return fn(std::integral_constant<int, 2>{});
  fn(std::integral_constant<int, 1>{});
}

template <typename T>
void launch_sorted(const T* points, const int32_t* labels, const uint8_t* mask, int32_t* iwork,
                   float* fwork, float* sums, float* counts, int n, int k, int d, int seg_rows,
                   int cols, int stop_after, cudaStream_t stream) {
  const int units = std::max((n + kSortRows - 1) / kSortRows, 1);
  const bool in_smem = kWarps * k * 4 <= kSmemBytes;
  int32_t* starts = iwork;
  int32_t* order = starts + k + 1;
  int32_t* hist = order + n;
  int32_t* before = hist + static_cast<long long>(units) * k;
  int32_t* total = before + static_cast<long long>(units) * k;
  int32_t* spill = in_smem ? nullptr : total + k;
  const int smem = in_smem ? kWarps * k * 4 : 0;
  LAUNCH(0, sort_count<<<units, kThreads, smem, stream>>>(labels, mask, hist, spill, n, k));
  LAUNCH(1, launch_after(sort_columns, (k + kColumnThreads - 1) / kColumnThreads, kColumnThreads,
                         0, stream, hist, before, total, units, k));
  LAUNCH(2, launch_after(sort_scatter, units, kThreads, smem, stream, labels, mask, before, total,
                         spill, starts, order, n, k));
  // segment_sums and merge_runs: R = 256 / cols rows of Q = min(cols,
  // ceil(D / V)) lanes a block, ceil(D / (Q V)) blocks of columns
  const auto column_grid = [&](int v) {
    const int q_lanes = std::min(cols, (d + v - 1) / v);
    return std::make_pair(q_lanes, (d + q_lanes * v - 1) / (q_lanes * v));
  };
  constexpr int kPointsVector = 16 / static_cast<int>(sizeof(T));
  if (n > 0)
    LAUNCH(3, with_row_vector<kPointsVector>(row_vector(points, sizeof(T), d), [&](auto v) {
             const auto [q_lanes, blocks_y] = column_grid(v);
             launch_after(segment_sums<T, decltype(v)::value>,
                          dim3((n + seg_rows - 1) / seg_rows, blocks_y), kThreads / cols * q_lanes,
                          0, stream, points, labels, order, starts, sums, fwork, n, k, d, cols,
                          seg_rows, q_lanes);
           }));
  LAUNCH(4, with_row_vector<4>(row_vector(fwork, 4, d), [&](auto v) {
           const auto [q_lanes, blocks_y] = column_grid(v);
           launch_after(merge_runs<decltype(v)::value>, dim3(k, blocks_y),
                        kThreads / cols * q_lanes, 0, stream, starts, fwork, sums, counts, d, cols,
                        seg_rows, q_lanes);
         }));
}

constexpr bool is_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

extern "C" {

// points (n, d) row-major, f32 (dtype 0) or bf16 (dtype 1); labels int32
// (n,); mask uint8 (n,) or null (a row with mask 0 adds nothing); sums f32
// (k, d) and counts f32 (k,) are written whole. regime 0, partials: a, b, c
// = rows a block takes, rows staged at a time (both multiples of 8), row
// groups (groups k d <= 256); iwork int32 (blocks k), fwork f32 (2 blocks k
// d), blocks = ceil(n / a). regime 1, sorted: a = sorted rows a segment, b =
// column lanes (a power of two <= 32; a a multiple of 256 / b), c = rows a
// counting-sort block (2048); iwork int32 (k + 1 starts, n order, 2 units k +
// k, and units 8 k more where 8 k ints pass 48 KB; units = max(ceil(n /
// 2048), 1)),
// fwork f32 (2 ceil(n / a) d). stop_after: launch only the regime's first
// that many kernels (0: all). Returns cudaGetLastError() (or
// cudaErrorInvalidValue for sizes it does not take).
int kmeans_update(const void* points, const void* labels, const void* mask, void* iwork,
                  void* fwork, void* sums, void* counts, int n, int k, int d, int dtype,
                  int regime, int a, int b, int c, int stop_after, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (k < 1 || d < 1 || n < 0 || (dtype != 0 && dtype != 1) || stop_after < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (regime == 0) {
    if (a < 8 || a % 8 != 0 || b < 8 || b % 8 != 0 || c < 1 ||
        static_cast<long long>(c) * k * d > kThreads ||
        static_cast<long long>(b) * (4 + d * elem) > kSmemBytes - kStaticSmemBytes)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (regime == 1) {
    if (!is_pow2(b) || b > 32 || a < kThreads / b || a % (kThreads / b) != 0 || c != kSortRows ||
        (d + b - 1) / b > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* lab = static_cast<const int32_t*>(labels);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* iw = static_cast<int32_t*>(iwork);
  auto* fw = static_cast<float*>(fwork);
  auto* su = static_cast<float*>(sums);
  auto* co = static_cast<float*>(counts);
  if (dtype == 0) {
    const auto* p = static_cast<const float*>(points);
    if (regime == 0) {
      launch_partials(p, lab, m, iw, fw, su, co, n, k, d, a, b, c, stop_after, s);
    } else {
      launch_sorted(p, lab, m, iw, fw, su, co, n, k, d, a, b, stop_after, s);
    }
  } else {
    const auto* p = static_cast<const __nv_bfloat16*>(points);
    if (regime == 0) {
      launch_partials(p, lab, m, iw, fw, su, co, n, k, d, a, b, c, stop_after, s);
    } else {
      launch_sorted(p, lab, m, iw, fw, su, co, n, k, d, a, b, stop_after, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
