// The streaming K-Means update's sums on Hopper (sm_90a), in a fixed order:
// for labels (N,) in [0, K) and points (N, D),
//   sums[l, j] = sum over rows i with label l of w_i x[i, j]
//   counts[l]  = sum over those rows of w_i (without weights: their number).
//
// Replaces no TPU kernel: the JAX package computes this with an
// order-preserving scatter (repro/kernels/kmeans/ref.py, update_scatter),
// whose sums are bit-identical from run to run. PyTorch's index_add_ adds
// with atomics on CUDA, in an order that changes between runs; these kernels
// keep the sums' order fixed, so an update repeats bit for bit.
//
// The caller (kernels/kmeans/ops.py, update_cuda) stable-sorts the labels
// (torch.sort(stable=True), deterministic) and passes the sorted labels and
// the permutation. Three launches on one stream:
//
// 1. run_starts: starts[l] = the first sorted row of label l (starts[K] =
//    N), so label l's run of sorted rows is [starts[l], starts[l + 1]).
// 2. segment_sums: the sorted rows are cut into segments of seg_rows rows,
//    whatever the labels, so the work is spread evenly however the rows
//    fall on the labels (the stream's 10 labels, or every row on one).
//    Block (s, y) takes segment s and `cols` consecutive dimensions from
//    y * cols, and walks the pieces of label runs in it in order: thread
//    (r, c) sums rows r, r + R, ... of a piece (R = 256 / cols rows in
//    flight) with compensated (Kahan) addition, then the block adds the R
//    partials of a column by a fixed halving tree. A run that lies wholly in
//    the segment is written to sums; the piece of a run that began in an
//    earlier segment is the segment's head partial, the piece of one that
//    goes on past it is its tail partial.
// 3. merge_runs: block (l, y) adds the partials of a run that crosses
//    segments: the tail of its first segment, then the heads of the later
//    ones summed by the same scheme. It writes zeros for an empty run and the
//    counts (the run's length, or the weights summed like a column).
//
// Every output element is written by exactly one thread and no atomics are
// used, so nothing needs clearing first and the order depends only on the
// labels and on seg_rows (chosen from D alone).
//
// Bound by bytes: every point is read once (the permuted rows of a run are
// scattered, but each row's cols values are one contiguous run for a warp),
// 4 bytes of labels and 8 of the permutation per row, and K (D + 1) f32 out.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Kahan addition: sum + x, with the rounding error carried in comp
__device__ __forceinline__ void kahan_add(float& sum, float& comp, float x) {
  const float y = x - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// the R partials part[r * cols + c] of column c added by a fixed halving
// tree; the sum lands in part[c]
__device__ __forceinline__ void tree_sum(float* part, int rows, int cols, int r, int c) {
  for (int s = rows / 2; s > 0; s /= 2) {
    __syncthreads();
    if (r < s) part[r * cols + c] += part[(r + s) * cols + c];
  }
  __syncthreads();
}

// labels clipped to [-1, K]: rows with a label outside [0, K) fall before
// starts[0] or from starts[K] on, and no run takes them
__device__ __forceinline__ int clip_label(int v, int k) { return v < -1 ? -1 : (v > k ? k : v); }

// one thread per sorted row i in [0, N]: labels between the previous row's
// and this row's start here
__global__ void run_starts(const int32_t* __restrict__ sorted_labels, int32_t* __restrict__ starts,
                           int n, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i > n) return;
  const int prev = i == 0 ? -1 : clip_label(sorted_labels[i - 1], k);
  const int cur = i == n ? k : clip_label(sorted_labels[i], k);
  for (int l = prev + 1; l <= cur; ++l) starts[l] = i;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sums(const T* __restrict__ points, const int32_t* __restrict__ sorted_labels,
             const int64_t* __restrict__ order, const float* __restrict__ weights,
             const int32_t* __restrict__ starts, float* __restrict__ sums,
             float* __restrict__ counts, float* __restrict__ part, int n, int k, int d,
             int cols, int seg_rows) {
  __shared__ float psum[kThreads];
  __shared__ float pw[kThreads];
  const int s = blockIdx.x;
  const int rows = kThreads / cols;
  const int r = threadIdx.x / cols, c = threadIdx.x % cols;
  const int j = blockIdx.y * cols + c;
  const bool count_w = weights != nullptr && blockIdx.y == 0;  // this block sums weights too
  const long long seg_lo = static_cast<long long>(s) * seg_rows;
  const int seg_hi = static_cast<int>(min(seg_lo + seg_rows, static_cast<long long>(n)));
  int start = max(static_cast<int>(seg_lo), starts[0]);
  const int stop = min(seg_hi, starts[k]);

  while (start < stop) {  // one piece of a run, [start, end): the same for every thread
    const int l = sorted_labels[start];
    const int run_lo = starts[l], run_hi = starts[l + 1];
    const int end = min(run_hi, stop);
    float sum = 0.f, comp = 0.f, w = 0.f, wcomp = 0.f;
    for (int i = start + r; i < end; i += rows) {
      const long long row = order[i];
      const float wi = weights != nullptr ? weights[row] : 1.f;
      if (j < d) kahan_add(sum, comp, to_f32(points[row * d + j]) * wi);
      if (count_w && c == 0) kahan_add(w, wcomp, wi);
    }
    psum[threadIdx.x] = sum;
    if (count_w) pw[threadIdx.x] = w;  // nonzero in column 0 only
    tree_sum(psum, rows, cols, r, c);
    if (count_w) tree_sum(pw, rows, cols, r, c);
    if (r == 0) {
      if (run_lo >= seg_lo && run_hi <= seg_hi) {  // the whole run
        if (j < d) sums[static_cast<long long>(l) * d + j] = psum[c];
        if (count_w && c == 0) counts[l] = pw[0];
      } else {  // this piece's partials: (D + 1) floats, the count last
        const long long slot = 2LL * s + (run_lo < seg_lo ? 0 : 1);  // head : tail
        float* out = part + slot * (d + 1);
        if (j < d) out[j] = psum[c];
        if (count_w && c == 0) out[d] = pw[0];
      }
    }
    start = end;
  }
}

// block (l, y): label l's run, columns y * cols + c of the D + 1 (the count
// last, summed from the weights' partials)
__global__ void __launch_bounds__(kThreads)
merge_runs(const int32_t* __restrict__ starts, const float* __restrict__ part,
           const float* __restrict__ weights, float* __restrict__ sums,
           float* __restrict__ counts, int d, int cols, int seg_rows) {
  __shared__ float psum[kThreads];
  const int l = blockIdx.x;
  const int rows = kThreads / cols;
  const int r = threadIdx.x / cols, c = threadIdx.x % cols;
  const int j = blockIdx.y * cols + c;
  const int width = weights != nullptr ? d + 1 : d;
  const int lo = starts[l], hi = starts[l + 1];
  if (weights == nullptr && blockIdx.y == 0 && threadIdx.x == 0)
    counts[l] = static_cast<float>(hi - lo);
  if (hi == lo) {  // an empty run: zeros
    if (r == 0 && j < width) (j < d ? sums[static_cast<long long>(l) * d + j] : counts[l]) = 0.f;
    return;
  }
  const int s0 = lo / seg_rows, s1 = (hi - 1) / seg_rows;
  if (s0 == s1) return;  // the run lies in one segment, written whole by segment_sums
  float sum = 0.f, comp = 0.f;
  if (j < width)
    for (int s = s0 + 1 + r; s <= s1; s += rows)
      kahan_add(sum, comp, part[2LL * s * (d + 1) + j]);  // heads of the later segments
  psum[threadIdx.x] = sum;
  tree_sum(psum, rows, cols, r, c);
  if (r == 0 && j < width) {
    const float v = part[(2LL * s0 + 1) * (d + 1) + j] + psum[c];  // the first one's tail first
    if (j < d) {
      sums[static_cast<long long>(l) * d + j] = v;
    } else {
      counts[l] = v;
    }
  }
}

// columns a block takes: the least power of two >= d, at most 32 (one warp's
// row of a run is then one contiguous load of up to 128 bytes)
int cols_for(int d) {
  int cols = 1;
  while (cols < d && cols < 32) cols *= 2;
  return cols;
}

template <typename T>
void launch(const void* points, const void* sorted_labels, const void* order,
            const void* weights, void* starts, void* part, void* sums, void* counts, int n,
            int k, int d, int seg_rows, cudaStream_t stream) {
  const int cols = cols_for(d);
  const auto* labels = static_cast<const int32_t*>(sorted_labels);
  auto* st = static_cast<int32_t*>(starts);
  const auto* w = static_cast<const float*>(weights);
  auto* p = static_cast<float*>(part);
  run_starts<<<n / kThreads + 1, kThreads, 0, stream>>>(labels, st, n, k);
  const int segments = (n + seg_rows - 1) / seg_rows;
  if (segments > 0)
    segment_sums<T><<<dim3(segments, (d + cols - 1) / cols), kThreads, 0, stream>>>(
        static_cast<const T*>(points), labels, static_cast<const int64_t*>(order), w, st,
        static_cast<float*>(sums), static_cast<float*>(counts), p, n, k, d, cols, seg_rows);
  const int width = weights != nullptr ? d + 1 : d;
  merge_runs<<<dim3(k, (width + cols - 1) / cols), kThreads, 0, stream>>>(
      st, p, w, static_cast<float*>(sums), static_cast<float*>(counts), d, cols, seg_rows);
}

}  // namespace

extern "C" {

// points (n, d) row-major, f32 (dtype 0) or bf16 (dtype 1); sorted_labels
// int32 (n,) in ascending order, each in [0, k); order int64 (n,), the row
// of points behind each sorted label; weights f32 (n,) or null (every row
// weighs 1); starts int32 (k + 1,) and part f32 (2 ceil(n / seg_rows), d + 1)
// are workspace; sums f32 (k, d) and counts f32 (k,) are written whole.
// Returns cudaGetLastError() (or cudaErrorInvalidValue for sizes it does not
// take).
int kmeans_update(const void* points, const void* sorted_labels, const void* order,
                  const void* weights, void* starts, void* part, void* sums, void* counts,
                  int n, int k, int d, int dtype, int seg_rows, void* stream) {
  if (k < 1 || d < 1 || n < 0 || seg_rows < 1 || (d + 1 + 31) / 32 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(points, sorted_labels, order, weights, starts, part, sums, counts, n, k, d,
                  seg_rows, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(points, sorted_labels, order, weights, starts, part, sums, counts, n,
                          k, d, seg_rows, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
