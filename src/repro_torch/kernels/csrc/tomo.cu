// Parallel-beam backprojection and forward projection on Hopper (sm_90a),
// batched over frames.
//
// Replace the Pallas TPU kernels of repro/kernels/tomo/kernel.py:
//   tomo_backproject <- backproject_pallas -> _bp_kernel
//   tomo_project     <- project_pallas     -> _fp_kernel
// The TPU kernels rebuild each angle's interpolation weights as a one-hot
// (pixels x bins) matrix and contract it on the MXU, because a TPU has no
// cheap scatter or gather. A GPU gathers well, so both kernels here read
// just the two bins (or pixels) that carry weight.
//
// Geometry (repro/kernels/tomo/ref.py): the pixel in (row, col) of an n x n
// image projects at angle theta to the detector coordinate
//   s = (col - c) cos(theta) + (row - c) sin(theta) + (n_det - 1) / 2,
// c = (n - 1) / 2, and is shared linearly between bin floor(s) (weight
// 1 - f) and bin floor(s) + 1 (weight f), f = s - floor(s). Bins outside
// [0, n_det) are dropped, as the one-hot form drops them.
//
// Both kernels take s from detector_s(), with every
// product and sum rounded once (no FMA contraction) — the same roundings as
// the plain PyTorch version — so the two kernels give every (pixel, bin)
// pair the very same weight and stay exact adjoints of each other up to the
// order of their sums, which ML-EM relies on.
//
// What bounds them on the H100: per (frame, pixel, angle) one interpolation
// of ~6 f32 operations against ~4 bytes of sinogram that stay in L1/L2 (a
// 360 x 1448 f32 sinogram is 2 MB), so both are bound by operations and by
// the gather's cache traffic, not by device memory.
//
// tomo_backproject: one thread per (frame, pixel); the angles' cos/sin in
// shared memory; an f32 register accumulates over all angles and the pixel
// is written once. No atomics.
//
// tomo_project: one thread per (angle, bin) gathers, for up to kFrames
// frames at once, the pixels whose footprint reaches its bin — a gather,
// not a scatter, so no atomics and the sum order is fixed from run to run.
// The thread walks the image along the axis more perpendicular to the ray
// (rows when |cos| >= |sin|, else columns; one choice per warp, since a
// warp is 32 bins of one angle); on each line it solves for the pixel interval that
// can reach its bin (a reciprocal of the slope taken once per thread, no
// divisions), widens it by one pixel on each side against rounding, tests
// each candidate with the same rounded s as tomo_backproject and keeps
// exactly the pixels whose floor(s) is bin or bin - 1. floor(s) is monotone
// along a line, so the kept pixels are one run of at most 3 (2 / |slope|
// < 3): the scan keeps their weights, and the gather applies each weight
// to every frame the thread carries, one f32 accumulator per frame in
// registers. So the geometry is computed once per (line, candidate) for
// all frames; more frames take more blocks along the grid's z dimension.
// Column-walking angles read a transposed copy of the images (made by
// transpose_kernel into the caller's scratch at the start of the call), so
// in both halves neighbouring bins read neighbouring addresses and a warp's
// loads coalesce. A block holds kAngles adjacent angles (a warp each) over
// the same bins: on a line their pixel strips overlap but for a few pixels,
// so one warp's misses are the others' L1 hits. Per frame the sum order is
// that of the first version: lines in order, pixels along the line in
// order.
//
// What bounds tomo_project: issuing the gathers. At 8 x 1448^2 -> 8 x 360
// x 1448, 4 against 8 frames per thread puts the geometry (computed once
// per chunk of frames) at about 0.9 ms of some 11.6 ms; the rest grows
// with the frames: per (angle, 32 bins, line) a warp issues 3 pixel steps
// x 8 frames of loads and fused multiply-adds, each load coalesced over
// 2-3 cache lines. Device memory sees each image and its transposed copy
// about once per wave of blocks, since all blocks in flight walk the lines
// in the same order; sharing L1 between adjacent angles gains only 2-3 %
// (PERF.md), so L2 traffic is not the limit either.
#include <cuda_runtime.h>
#include <math.h>

namespace {

#ifndef TOMO_FRAMES
#define TOMO_FRAMES 8  // frames one tomo_project thread carries
#endif
#ifndef TOMO_ANGLES
#define TOMO_ANGLES 4  // adjacent angles in one tomo_project block, a warp each
#endif

constexpr int kThreads = 256;
constexpr int kAngleChunk = 1024;
constexpr int kFrames = TOMO_FRAMES;
constexpr int kAngles = TOMO_ANGLES;
constexpr int kBinWarps = kThreads / 32 / kAngles;  // 32-bin strips per tomo_project block
static_assert(kAngles >= 1 && (kThreads / 32) % kAngles == 0, "TOMO_ANGLES");
constexpr int kTile = 32;  // transpose tile

// s from the two rounded products x cos(theta) and y sin(theta), x = col - c
// and y = row - c, each sum rounded once
__device__ __forceinline__ float detector_s(float x_cos, float y_sin, float det_center) {
  return __fadd_rn(__fadd_rn(x_cos, y_sin), det_center);
}

// s, floor(s) and f
__device__ __forceinline__ void coord_from_terms(float x_cos, float y_sin, float det_center,
                                                 int& s0, float& f) {
  const float s = detector_s(x_cos, y_sin, det_center);
  const float fl = floorf(s);
  s0 = static_cast<int>(fl);
  f = __fsub_rn(s, fl);
}

__device__ __forceinline__ void detector_coord(int row, int col, float center, float cos_t,
                                               float sin_t, float det_center, int& s0,
                                               float& f) {
  const float x = static_cast<float>(col) - center;  // exact: half-integers
  const float y = static_cast<float>(row) - center;
  coord_from_terms(__fmul_rn(x, cos_t), __fmul_rn(y, sin_t), det_center, s0, f);
}

__global__ void __launch_bounds__(kThreads)
backproject_kernel(const float* __restrict__ sinos, const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, float* __restrict__ out,
                   int n_angles, int n_det, int n) {
  __shared__ float cs[kAngleChunk];
  __shared__ float sn[kAngleChunk];
  const long long n_pix = static_cast<long long>(n) * n;
  const long long pix = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = pix < n_pix;
  const int row = live ? static_cast<int>(pix / n) : 0;
  const int col = live ? static_cast<int>(pix % n) : 0;
  const float center = 0.5f * static_cast<float>(n - 1);
  const float det_center = 0.5f * static_cast<float>(n_det - 1);
  const float* sino = sinos + static_cast<long long>(blockIdx.y) * n_angles * n_det;

  float acc = 0.f;
  for (int a0 = 0; a0 < n_angles; a0 += kAngleChunk) {
    const int na = min(kAngleChunk, n_angles - a0);
    __syncthreads();
    for (int t = threadIdx.x; t < na; t += blockDim.x) {
      cs[t] = cos_t[a0 + t];
      sn[t] = sin_t[a0 + t];
    }
    __syncthreads();
    if (!live) continue;
    for (int a = 0; a < na; ++a) {
      int s0;
      float f;
      detector_coord(row, col, center, cs[a], sn[a], det_center, s0, f);
      const float* r = sino + static_cast<long long>(a0 + a) * n_det;
      float v = 0.f;
      if (s0 >= 0 && s0 < n_det) v = (1.f - f) * r[s0];
      if (s0 + 1 >= 0 && s0 + 1 < n_det) v += f * r[s0 + 1];
      acc += v;
    }
  }
  if (live) out[static_cast<long long>(blockIdx.y) * n_pix + pix] = acc;
}

// out[f][c][r] = in[f][r][c] for every frame f (blockIdx.z), through a
// padded shared-memory tile so both the reads and the writes coalesce
__global__ void __launch_bounds__(kTile * 8)
transpose_kernel(const float* __restrict__ in, float* __restrict__ out, int n) {
  __shared__ float tile[kTile][kTile + 1];
  const long long frame = static_cast<long long>(blockIdx.z) * n * n;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  for (int j = threadIdx.y; j < kTile; j += blockDim.y) {
    const int r = r0 + j, c = c0 + threadIdx.x;
    if (r < n && c < n) tile[j][threadIdx.x] = in[frame + static_cast<long long>(r) * n + c];
  }
  __syncthreads();
  for (int j = threadIdx.y; j < kTile; j += blockDim.y) {
    const int c = c0 + j, r = r0 + threadIdx.x;
    if (r < n && c < n) out[frame + static_cast<long long>(c) * n + r] = tile[threadIdx.x][j];
  }
}

// One tomo_project thread's walk over the image's lines, for the nf <=
// kFrames frames at img + fr * frame. BY_ROWS: a line is a row and u its
// column, else a line is a column of the transposed copy and u its row.
template <bool BY_ROWS>
__device__ __forceinline__ void project_walk(const float* __restrict__ img, long long frame,
                                             int nf, int n, int bin, float slope, float cross,
                                             float center, float det_center,
                                             float (&acc)[kFrames]) {
  // pixels that weigh on this bin have x cos + y sin in [lo, hi)
  const float lo = static_cast<float>(bin) - 1.f - det_center;
  const float hi = static_cast<float>(bin) + 1.f - det_center;
  const float bin_f = static_cast<float>(bin), below_f = static_cast<float>(bin - 1);
  const float inv_slope = 1.f / slope;
  for (int line = 0; line < n; ++line) {
    // on this line u must satisfy u * slope in [lo - w * cross, hi - w * cross)
    const float w = static_cast<float>(line) - center;
    float u0 = (lo - w * cross) * inv_slope;
    float u1 = (hi - w * cross) * inv_slope;
    if (u0 > u1) {
      const float t = u0;
      u0 = u1;
      u1 = t;
    }
    const int first = max(0, static_cast<int>(floorf(u0 + center)) - 1);
    const int last = min(n - 1, static_cast<int>(ceilf(u1 + center)) + 1);
    // test every candidate with detector_s (the line's product once);
    // floor(s) is monotone along the line, so the kept
    // pixels are one run ending at `end`, and the last three weights are kept
    const float w_term = __fmul_rn(w, cross);
    float wt0 = 0.f, wt1 = 0.f, wt2 = 0.f;
    int end = -1, kept = 0;
    float x = static_cast<float>(first) - center;  // exact: integers or half-integers
    for (int u = first; u <= last; ++u, x += 1.f) {
      const float u_term = __fmul_rn(x, slope);
      const float sv = BY_ROWS ? detector_s(u_term, w_term, det_center)
                               : detector_s(w_term, u_term, det_center);
      const float fl = floorf(sv);
      if (fl == bin_f || fl == below_f) {
        const float f = __fsub_rn(sv, fl);
        wt0 = wt1;
        wt1 = wt2;
        wt2 = fl == bin_f ? 1.f - f : f;
        end = u;
        ++kept;
      }
    }
    const float* px = img + static_cast<long long>(line) * n;
    if (kept <= 3) {  // always, for a unit (cos, sin): the run spans 2 / |slope| < 3
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j < 3 - kept) continue;
        const float wt = j == 0 ? wt0 : (j == 1 ? wt1 : wt2);
        const int u = end - 2 + j;
#pragma unroll
        for (int fr = 0; fr < kFrames; ++fr)
          if (fr < nf) acc[fr] = fmaf(wt, px[fr * frame + u], acc[fr]);
      }
    } else {
      for (int u = end - kept + 1; u <= end; ++u) {
        const float u_term = __fmul_rn(static_cast<float>(u) - center, slope);
        int s0;
        float f;
        coord_from_terms(BY_ROWS ? u_term : w_term, BY_ROWS ? w_term : u_term, det_center, s0, f);
        const float wt = s0 == bin ? 1.f - f : f;
        for (int fr = 0; fr < nf; ++fr) acc[fr] = fmaf(wt, px[fr * frame + u], acc[fr]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ imgs, const float* __restrict__ imgs_t,
               const float* __restrict__ cos_t, const float* __restrict__ sin_t,
               float* __restrict__ out, int batch, int n_angles, int n_det, int n) {
  const int warp = threadIdx.x >> 5;
  const int a = blockIdx.y * kAngles + warp % kAngles;
  const int bin = (blockIdx.x * kBinWarps + warp / kAngles) * 32 + (threadIdx.x & 31);
  const int f0 = blockIdx.z * kFrames;
  if (a >= n_angles || bin >= n_det) return;
  const int nf = min(kFrames, batch - f0);
  const float ct = cos_t[a];
  const float st = sin_t[a];
  const float center = 0.5f * static_cast<float>(n - 1);
  const float det_center = 0.5f * static_cast<float>(n_det - 1);
  const long long frame = static_cast<long long>(n) * n;

  float acc[kFrames];
#pragma unroll
  for (int fr = 0; fr < kFrames; ++fr) acc[fr] = 0.f;
  // walk the axis more perpendicular to the ray (the same for the whole warp)
  if (fabsf(ct) >= fabsf(st)) {
    project_walk<true>(imgs + f0 * frame, frame, nf, n, bin, ct, st, center, det_center, acc);
  } else {
    project_walk<false>(imgs_t + f0 * frame, frame, nf, n, bin, st, ct, center, det_center, acc);
  }
#pragma unroll
  for (int fr = 0; fr < kFrames; ++fr)
    if (fr < nf) out[((f0 + fr) * static_cast<long long>(n_angles) + a) * n_det + bin] = acc[fr];
}

}  // namespace

extern "C" {

// sinos (batch, n_angles, n_det), cos_t/sin_t (n_angles,), out (batch, n, n);
// all f32, row-major. Returns cudaGetLastError().
int tomo_backproject(const void* sinos, const void* cos_t, const void* sin_t, void* out,
                     int batch, int n_angles, int n_det, int n, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (batch > 65535 || n_angles < 0 || n_det < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_pix = static_cast<long long>(n) * n;
  const dim3 grid(static_cast<unsigned>((n_pix + kThreads - 1) / kThreads), batch);
  backproject_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sinos), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<float*>(out), n_angles, n_det, n);
  return static_cast<int>(cudaGetLastError());
}

// imgs (batch, n, n), cos_t/sin_t (n_angles,), out (batch, n_angles, n_det),
// scratch (batch, n, n) for the transposed images; all f32, row-major.
// Returns cudaGetLastError().
int tomo_project(const void* imgs, void* scratch, const void* cos_t, const void* sin_t,
                 void* out, int batch, int n_angles, int n_det, int n, void* stream) {
  if (batch <= 0 || n_angles <= 0 || n_det <= 0) return 0;
  if (batch > 65535 || n_angles > 65535 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kTile - 1) / kTile;
  transpose_kernel<<<dim3(tiles, tiles, batch), dim3(kTile, 8), 0, s>>>(
      static_cast<const float*>(imgs), static_cast<float*>(scratch), n);
  const dim3 grid((n_det + 32 * kBinWarps - 1) / (32 * kBinWarps), (n_angles + kAngles - 1) / kAngles,
                  (batch + kFrames - 1) / kFrames);
  project_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(imgs), static_cast<const float*>(scratch),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<float*>(out), batch, n_angles, n_det, n);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
