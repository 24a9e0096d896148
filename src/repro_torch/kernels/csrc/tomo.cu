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
// Both kernels call detector_coord() for s, floor(s) and f, with every
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
// tomo_project: one thread per (frame, angle, bin) — a gather, not a
// scatter, so the sum order is fixed from run to run. The thread walks the
// image along the axis more perpendicular to the ray (rows when
// |cos| >= |sin|, else columns); on each line it solves for the pixel
// interval whose footprint can reach its bin, widens it by one pixel on
// each side against rounding, and tests each candidate with
// detector_coord(), keeping exactly the pixels whose floor(s) is bin or
// bin - 1.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAngleChunk = 1024;

__device__ __forceinline__ void detector_coord(int row, int col, float center, float cos_t,
                                               float sin_t, float det_center, int& s0,
                                               float& f) {
  const float x = static_cast<float>(col) - center;  // exact: half-integers
  const float y = static_cast<float>(row) - center;
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(x, cos_t), __fmul_rn(y, sin_t)), det_center);
  const float fl = floorf(s);
  s0 = static_cast<int>(fl);
  f = __fsub_rn(s, fl);
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

__global__ void __launch_bounds__(kThreads)
project_kernel(const float* __restrict__ imgs, const float* __restrict__ cos_t,
               const float* __restrict__ sin_t, float* __restrict__ out,
               int n_angles, int n_det, int n) {
  const int bin = blockIdx.x * blockDim.x + threadIdx.x;
  const int a = blockIdx.y;
  if (bin >= n_det) return;
  const float ct = cos_t[a];
  const float st = sin_t[a];
  const float center = 0.5f * static_cast<float>(n - 1);
  const float det_center = 0.5f * static_cast<float>(n_det - 1);
  const float* img = imgs + static_cast<long long>(blockIdx.z) * n * n;
  // pixels that weigh on this bin have x cos + y sin in [lo, hi)
  const float lo = static_cast<float>(bin) - 1.f - det_center;
  const float hi = static_cast<float>(bin) + 1.f - det_center;

  float acc = 0.f;
  const bool by_rows = fabsf(ct) >= fabsf(st);
  for (int line = 0; line < n; ++line) {
    // on this row (column), the other coordinate u must satisfy
    // u * slope in [lo - w * cross, hi - w * cross)
    const float w = static_cast<float>(line) - center;
    const float slope = by_rows ? ct : st;
    const float cross = by_rows ? st : ct;
    float u0 = (lo - w * cross) / slope;
    float u1 = (hi - w * cross) / slope;
    if (u0 > u1) {
      const float t = u0;
      u0 = u1;
      u1 = t;
    }
    const int first = max(0, static_cast<int>(floorf(u0 + center)) - 1);
    const int last = min(n - 1, static_cast<int>(ceilf(u1 + center)) + 1);
    for (int other = first; other <= last; ++other) {
      const int row = by_rows ? line : other;
      const int col = by_rows ? other : line;
      int s0;
      float f;
      detector_coord(row, col, center, ct, st, det_center, s0, f);
      const float v = img[static_cast<long long>(row) * n + col];
      if (s0 == bin) {
        acc += (1.f - f) * v;
      } else if (s0 + 1 == bin) {
        acc += f * v;
      }
    }
  }
  out[(static_cast<long long>(blockIdx.z) * n_angles + a) * n_det + bin] = acc;
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

// imgs (batch, n, n), cos_t/sin_t (n_angles,), out (batch, n_angles, n_det);
// all f32, row-major. Returns cudaGetLastError().
int tomo_project(const void* imgs, const void* cos_t, const void* sin_t, void* out,
                 int batch, int n_angles, int n_det, int n, void* stream) {
  if (batch <= 0 || n_angles <= 0 || n_det <= 0) return 0;
  if (batch > 65535 || n_angles > 65535 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_det + kThreads - 1) / kThreads, n_angles, batch);
  project_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(imgs), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<float*>(out), n_angles, n_det, n);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
