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
// tomo_backproject: one thread per pixel carries kBpFrames (8) frames, one
// f32 accumulator each, and computes the geometry (s, floor(s), the two
// weights) once per (pixel, angle) for all of them; batches that are not a
// multiple of 8 take more blocks along the grid's z dimension. A block
// covers a 32 x 16 tile of pixels. For each chunk of kBpAngles (16) angles
// it stages into shared memory only the window of bins the tile can reach
// at each angle — kBpWindow (39) bins from one below the least floor(s) of
// the tile's corners, the same rounded s as every pixel — for all its
// frames, laid out [angle][bin][frame] with the bin's stride padded to 12
// floats, so one 16-byte load brings 4 frames of one bin and 8 neighbouring
// bins fall in distinct banks. The copies are cp.async, double-buffered
// over the angle chunks; bins outside [0, n_det) are staged as 0, which
// removes the range tests (the plain version reads them as 0). Per pixel,
// angle and 4 frames: two 16-byte shared loads (bins s0 and s0 + 1) and 8
// fused multiply-adds; the sum runs over the angles in order, the pixel is
// written once, no atomics. Threads past the image's edge sum an edge pixel
// and write nothing. A direction longer than unit (never on the path) can
// reach beyond the window: such an angle is not staged and its pixels read
// the sinograms directly, with the range tests.
//
// What bounds tomo_backproject: the shared-memory loads were expected to,
// at 2 x 4 bytes per (frame, pixel, angle) and 128 bytes per clock and SM,
// ~1.4 ms at 8 x 360 x 1448 -> 8 x 1448^2. The card agrees in part
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md): the kernel takes ~2.4 ms, and 4
// frames per thread instead of 8 add ~0.45 ms, so one pass of geometry and
// staging costs about that and the frames' loads and multiply-adds with the
// window copies the other ~2 ms.
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

#ifndef TOMO_BP_FRAMES
#define TOMO_BP_FRAMES 8  // frames one tomo_backproject thread carries
#endif
#ifndef TOMO_BP_TILE_X
#define TOMO_BP_TILE_X 32  // pixel columns of a tomo_backproject block's tile
#endif
#ifndef TOMO_BP_TILE_Y
#define TOMO_BP_TILE_Y 16  // pixel rows of the tile
#endif
#ifndef TOMO_BP_ANGLES
#define TOMO_BP_ANGLES 16  // angles per staged chunk of tomo_backproject
#endif

constexpr int kThreads = 256;
constexpr int kFrames = TOMO_FRAMES;
constexpr int kAngles = TOMO_ANGLES;
constexpr int kBinWarps = kThreads / 32 / kAngles;  // 32-bin strips per tomo_project block
static_assert(kAngles >= 1 && (kThreads / 32) % kAngles == 0, "TOMO_ANGLES");
constexpr int kTile = 32;  // transpose tile

constexpr int kBpFrames = TOMO_BP_FRAMES;
constexpr int kBpTx = TOMO_BP_TILE_X;
constexpr int kBpTy = TOMO_BP_TILE_Y;
constexpr int kBpThreads = kBpTx * kBpTy;
constexpr int kBpAngles = TOMO_BP_ANGLES;
static_assert(kBpFrames % 4 == 0 && kBpFrames >= 4, "TOMO_BP_FRAMES: a multiple of 4");
static_assert(kBpThreads % 32 == 0 && kBpThreads <= 1024 && kBpTx > 1 && kBpTy > 1,
              "TOMO_BP_TILE_X x TOMO_BP_TILE_Y: whole warps, at most 1024 threads");
constexpr int ceil_sqrt(int v) {
  int r = 0;
  while (r * r < v) ++r;
  return r;
}
// Bins one tile can reach at one angle, for a unit (cos, sin): floor(s)
// takes at most ceil(extent) + 1 values over the tile, extent =
// (TX - 1)|cos| + (TY - 1)|sin| <= hypot(TX - 1, TY - 1); one more for bin
// s0 + 1 and one on each side against rounding: 39 for a 32 x 16 tile.
constexpr int kBpWindow = ceil_sqrt((kBpTx - 1) * (kBpTx - 1) + (kBpTy - 1) * (kBpTy - 1)) + 4;
// floats per staged bin: the frames, padded so that stride / 4 is odd, which
// puts 8 neighbouring bins in 8 distinct 16-byte groups of banks
constexpr int kBpStride = (kBpFrames / 4) % 2 ? kBpFrames : kBpFrames + 4;
constexpr int kBpChunkFloats = kBpAngles * (4 + kBpWindow * kBpStride);
constexpr int kBpSmem = 2 * kBpChunkFloats * 4;
constexpr int kBpWide = -0x7fffffff - 1;  // window start of an angle that is not staged

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

// ---------------------------------------------------------------------------
// tomo_backproject
// ---------------------------------------------------------------------------

// one 4-byte copy global -> shared, zero-filled when !valid (src must still
// be a mapped address)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One staged chunk of angles in dynamic shared memory: per angle (cos, sin,
// the window's first bin as int bits, 0) in one 16-byte word, read with one
// broadcast load, then the windows.
struct BpChunk {
  float4* geo;  // [kBpAngles]; first bin kBpWide: the angle is not staged
  float* win;   // [kBpAngles][kBpWindow][kBpStride]: bin-major, frames innermost
  __device__ BpChunk(float* base, int buf) {
    geo = reinterpret_cast<float4*>(base + buf * kBpChunkFloats);
    win = reinterpret_cast<float*>(geo + kBpAngles);
  }
};

// Stage angles [a0, a0 + kBpAngles) for the block's tile: a warp per angle
// computes the window from the tile's four corners (a lane each, the same
// rounded s as every pixel) and copies its bins for all the block's frames;
// bins outside [0, n_det), frames past nf and angles past n_angles are
// zero-filled. A window wider than kBpWindow (cos/sin longer than unit) is
// marked kBpWide and not staged.
__device__ __forceinline__ void bp_stage(const float* __restrict__ sinos,
                                         const float* __restrict__ cos_t,
                                         const float* __restrict__ sin_t, BpChunk ch, int a0,
                                         int n_angles, int n_det, int n, int f0, int nf,
                                         int row0, int col0, float center, float det_center) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int a = warp; a < kBpAngles; a += kBpThreads / 32) {
    const int ang = min(a0 + a, n_angles - 1);
    const bool live = a0 + a < n_angles;
    const float ct = cos_t[ang], st = sin_t[ang];
    int s0;
    float f;
    // the corners of the tile's part inside the image
    detector_coord((lane & 2) ? min(row0 + kBpTy - 1, n - 1) : row0,
                   (lane & 1) ? min(col0 + kBpTx - 1, n - 1) : col0, center, ct, st, det_center,
                   s0, f);
    int lo = s0, hi = s0;
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    // floor(s) of any pixel of the tile lies in [lo - 1, hi + 1]: one bin
    // of slack on each side for the rounding of s between the corners
    const bool wide = hi - lo > kBpWindow - 4 || lo < -(1 << 29) || hi > (1 << 29);
    const int first = wide ? kBpWide : lo - 1;
    if (lane == 0) ch.geo[a] = make_float4(ct, st, __int_as_float(first), 0.f);
    const bool staged = live && !wide;
    for (int i = lane; i < kBpFrames * kBpWindow; i += 32) {
      const int fr = i / kBpWindow, w = i % kBpWindow;
      const int bin = first + w;
      const bool valid = staged && fr < nf && bin >= 0 && bin < n_det;
      const float* src = sinos + (static_cast<long long>(f0 + fr) * n_angles + ang) * n_det + bin;
      cp_async4(ch.win + (a * kBpWindow + w) * kBpStride + fr, valid ? src : sinos, valid);
    }
  }
}

// One (pixel, angle) straight from the sinograms, with the range tests: for
// pixels whose bins fall outside their tile's window (directions longer
// than unit only)
__device__ __forceinline__ void bp_direct(const float* __restrict__ rows, long long frame, int nf,
                                       int n_det, int s0, float w0, float f,
                                       float (&acc)[kBpFrames]) {
#pragma unroll
  for (int fr = 0; fr < kBpFrames; ++fr) {
    if (fr >= nf) break;
    const float* r = rows + fr * frame;
    const float v0 = s0 >= 0 && s0 < n_det ? r[s0] : 0.f;
    const float v1 = s0 + 1 >= 0 && s0 + 1 < n_det ? r[s0 + 1] : 0.f;
    acc[fr] = fmaf(f, v1, fmaf(w0, v0, acc[fr]));
  }
}

__global__ void __launch_bounds__(kBpThreads)
backproject_kernel(const float* __restrict__ sinos, const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, float* __restrict__ out, int batch,
                   int n_angles, int n_det, int n) {
  extern __shared__ __align__(16) float bp_smem[];
  const int row0 = blockIdx.y * kBpTy, col0 = blockIdx.x * kBpTx;
  // threads past the image's edge sum a pixel of the edge and write nothing,
  // so every pixel summed lies in the tile's window
  const bool live = row0 + static_cast<int>(threadIdx.x) / kBpTx < n &&
                    col0 + static_cast<int>(threadIdx.x) % kBpTx < n;
  const int row = min(row0 + static_cast<int>(threadIdx.x) / kBpTx, n - 1);
  const int col = min(col0 + static_cast<int>(threadIdx.x) % kBpTx, n - 1);
  const int f0 = blockIdx.z * kBpFrames;
  const int nf = min(kBpFrames, batch - f0);
  const float center = 0.5f * static_cast<float>(n - 1);
  const float det_center = 0.5f * static_cast<float>(n_det - 1);
  const float x = static_cast<float>(col) - center;  // exact: integers or half-integers
  const float y = static_cast<float>(row) - center;
  const long long frame = static_cast<long long>(n_angles) * n_det;

  float acc[kBpFrames];
#pragma unroll
  for (int fr = 0; fr < kBpFrames; ++fr) acc[fr] = 0.f;

  const int chunks = (n_angles + kBpAngles - 1) / kBpAngles;
  if (chunks > 0)
    bp_stage(sinos, cos_t, sin_t, BpChunk(bp_smem, 0), 0, n_angles, n_det, n, f0, nf, row0,
             col0, center, det_center);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {  // the next chunk lands while this one is summed
      bp_stage(sinos, cos_t, sin_t, BpChunk(bp_smem, (c + 1) & 1), (c + 1) * kBpAngles,
               n_angles, n_det, n, f0, nf, row0, col0, center, det_center);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const BpChunk ch(bp_smem, c & 1);
    const int a0 = c * kBpAngles;
    const int na = min(kBpAngles, n_angles - a0);
#pragma unroll 4
    for (int a = 0; a < na; ++a) {
      const float4 g = ch.geo[a];
      int s0;
      float f;
      coord_from_terms(__fmul_rn(x, g.x), __fmul_rn(y, g.y), det_center, s0, f);
      const float w0 = 1.f - f;
      const unsigned idx = static_cast<unsigned>(s0) - static_cast<unsigned>(__float_as_int(g.z));
      if (idx <= static_cast<unsigned>(kBpWindow - 2)) {
        // bins s0 and s0 + 1, four frames per 16-byte load
        const float* p = ch.win + (a * kBpWindow + static_cast<int>(idx)) * kBpStride;
#pragma unroll
        for (int q = 0; q < kBpFrames / 4; ++q) {
          const float4 r0 = *reinterpret_cast<const float4*>(p + 4 * q);
          const float4 r1 = *reinterpret_cast<const float4*>(p + kBpStride + 4 * q);
          acc[4 * q + 0] = fmaf(f, r1.x, fmaf(w0, r0.x, acc[4 * q + 0]));
          acc[4 * q + 1] = fmaf(f, r1.y, fmaf(w0, r0.y, acc[4 * q + 1]));
          acc[4 * q + 2] = fmaf(f, r1.z, fmaf(w0, r0.z, acc[4 * q + 2]));
          acc[4 * q + 3] = fmaf(f, r1.w, fmaf(w0, r0.w, acc[4 * q + 3]));
        }
      } else {
        bp_direct(sinos + (static_cast<long long>(f0) * n_angles + a0 + a) * n_det, frame, nf,
                  n_det, s0, w0, f, acc);
      }
    }
    __syncthreads();  // before the next iteration stages over this buffer
  }
  if (live) {
    const long long n_pix = static_cast<long long>(n) * n;
    float* o = out + static_cast<long long>(f0) * n_pix + static_cast<long long>(row) * n + col;
#pragma unroll
    for (int fr = 0; fr < kBpFrames; ++fr)
      if (fr < nf) o[fr * n_pix] = acc[fr];
  }
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
  const int frame_blocks = (batch + kBpFrames - 1) / kBpFrames;
  const int tiles_y = (n + kBpTy - 1) / kBpTy;
  if (frame_blocks > 65535 || tiles_y > 65535 || n_angles < 0 || n_det < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kBpSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        backproject_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBpSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + kBpTx - 1) / kBpTx, tiles_y, frame_blocks);
  backproject_kernel<<<grid, kBpThreads, kBpSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sinos), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<float*>(out), batch, n_angles, n_det, n);
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
