// Device code shared by the f32 weight-gradient passes of the two training
// backwards (flex_train.cu, the 4x128 FlexibleNeRF's; paper_train.cu, the
// 8x256 PaperNeRF's): dW = X^T dY and db = sum dY of one output tile of a
// weight matrix, summed over one chunk of point tiles on the FMA pipes.
//
// X is the matrix's input, rows of the forward's f32 residuals
// res[tile][row][point]; dY its output gradient, rows of the f32 deltas
// delta[tile][row][point] that the layer-gradient pass wrote. Both kernels
// tile their points by kTile = 64; the residual and delta row counts, the
// tiles a chunk and the job table are each kernel's own, and arguments here.
//
// A block of kThreads = 256 threads owns an output tile of at most kWTile x
// kWTile (inputs i0 .., outputs o0 ..): thread (ty, tx) keeps the A x B
// outputs i0 + ty + 16 a, o0 + tx + 16 b (a < A, b < B) in registers, A and
// B (1, 4 or 8) a template's, so a narrow matrix runs no products past its
// extent rounded up to 16. A warp is 4 ty x 8 tx, so its float4 reads of 4 X
// rows and of 8 dY rows (kStride floats apart: 4 banks) each take one
// wavefront, and per 4 points a thread issues 16 A B FMAs for 4 (A + B)
// shared loads (16 a load at 8 x 8). X and dY are staged feature-major,
// straight copies of the residual and delta rows, by cp.async into two
// stages of half a point tile each (kSmem bytes, 72 KB: two blocks an SM):
// stage s + 1 lands while stage s is summed, one barrier a stage.
//
// Each output's sum runs over the chunk's point tiles, then their points, in
// ascending order from 0.f, and so does each bias sum (threads 0 .. 16 B - 1
// of a block with i0 = 0 read their dY row as it is staged): an order that
// does not depend on the output tiling, so no tiling changes a result's
// bits.

#pragma once

#include <cuda_runtime.h>

namespace wgrad {

constexpr int kTile = 64;                 // points a tile
constexpr int kWTile = 128;               // the largest output tile: 128 inputs x 128 outputs
constexpr int kThreads = 256;             // 16 x 16 threads
constexpr int kPoints = kTile / 2;        // points a stage
constexpr int kStride = kPoints + 4;      // shared row: 16-byte aligned, rows 4 banks apart
constexpr int kBuf = kWTile * kStride;    // floats of one stage's X or dY
constexpr size_t kSmem = 4 * kBuf * sizeof(float);   // X and dY, two stages: 72 KB

// One weight matrix (or block of one) of a kernel's job table.
struct Job {
  int x_row, in_dim;    // residual rows X
  int d_row, out_dim;   // delta rows dY
  int w_off, b_off;     // where dW (in, out) and db go in the packed layout (b_off -1: none)
  int first_tile;       // index of the job's first output tile
};

// Stage s of a block's chunk (point tile t_begin + s / 2, its half s % 2)
// into xs and ys (rows of kStride floats): the 16 A residual rows X from
// x_row + i0 and the 16 B delta rows dY from d_row + o0, kPoints points a
// row, as one cp.async group of 16-byte copies of every thread; rows past
// in_dim or out_dim are filled with zeros (a copy of 0 source bytes).
template <int A, int B>
__device__ __forceinline__ void stage(float* xs, float* ys, const float* __restrict__ res,
                                      int res_rows, const float* __restrict__ delta, int d_rows,
                                      const Job& job, long long t_begin, int s, int i0, int o0) {
  constexpr int kRows = 16 * (A > B ? A : B);
  const long long t = t_begin + s / 2;
  const int half = (s % 2) * kPoints;
  const float* xt = res + (t * res_rows + job.x_row + i0) * kTile + half;
  const float* yt = delta + (t * d_rows + job.d_row + o0) * kTile + half;
  const unsigned xd = static_cast<unsigned>(__cvta_generic_to_shared(xs));
  const unsigned yd = static_cast<unsigned>(__cvta_generic_to_shared(ys));
  for (int e = threadIdx.x; e < kRows * (kPoints / 4); e += kThreads) {
    const int r = e / (kPoints / 4);
    const int c = 4 * (e % (kPoints / 4));
    if (16 * A == kRows || r < 16 * A) {
      const bool xv = i0 + r < job.in_dim;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(xd + 4 * (r * kStride + c)),
                   "l"(xt + (xv ? r : 0) * kTile + c), "r"(xv ? 16 : 0) : "memory");
    }
    if (16 * B == kRows || r < 16 * B) {
      const bool yv = o0 + r < job.out_dim;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(yd + 4 * (r * kStride + c)),
                   "l"(yt + (yv ? r : 0) * kTile + c), "r"(yv ? 16 : 0) : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The block's sums of job's output tile (i0, o0) over the point tiles
// chunk * tiles_per_chunk .. (at most n_tiles), written to the chunk's
// row of partial (n_params floats a chunk, the packed parameter layout):
// dW where i < in_dim and o < out_dim, db where i0 = 0 and job.b_off >= 0,
// for the outputs below out_dim or, with kPadBias, below out_dim rounded up
// to 4 (a layout that pads a short bias: the pad gets a zero, so the reduced
// gradient is defined everywhere). smem is kSmem bytes.
template <int A, int B, bool kPadBias>
__device__ __forceinline__ void tile_sums(const float* __restrict__ res, int res_rows,
                                          const float* __restrict__ delta, int d_rows,
                                          float* __restrict__ partial, int n_params,
                                          long long n_tiles, int tiles_per_chunk, long long chunk,
                                          const Job& job, int i0, int o0, float* smem) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);
  const bool bias_rows = job.b_off >= 0 && i0 == 0 && threadIdx.x < 16 * B;

  float acc[A][B];
#pragma unroll
  for (int a = 0; a < A; ++a) {
#pragma unroll
    for (int b = 0; b < B; ++b) acc[a][b] = 0.f;
  }
  float bsum = 0.f;

  const long long t_begin = chunk * tiles_per_chunk;
  const int n_stages = 2 * static_cast<int>(min(t_begin + tiles_per_chunk, n_tiles) - t_begin);
  stage<A, B>(smem, smem + kBuf, res, res_rows, delta, d_rows, job, t_begin, 0, i0, o0);
  for (int s = 0; s < n_stages; ++s) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    const float* xs = smem + (s % 2) * 2 * kBuf;
    const float* ys = xs + kBuf;
    if (s + 1 < n_stages) {
      float* nx = smem + ((s + 1) % 2) * 2 * kBuf;
      stage<A, B>(nx, nx + kBuf, res, res_rows, delta, d_rows, job, t_begin, s + 1, i0, o0);
    }
    if (bias_rows) {
      const float* yr = ys + threadIdx.x * kStride;
#pragma unroll
      for (int p = 0; p < kPoints; p += 4) {
        const float4 v = *reinterpret_cast<const float4*>(yr + p);
        bsum += v.x;
        bsum += v.y;
        bsum += v.z;
        bsum += v.w;
      }
    }
    // Not unrolled: at 8 x 8, unrolled by 2 it spills at the 128 registers
    // that two blocks an SM allow, and runs slower.
#pragma unroll 1
    for (int p = 0; p < kPoints; p += 4) {
      float4 x[A];
#pragma unroll
      for (int a = 0; a < A; ++a) {
        x[a] = *reinterpret_cast<const float4*>(xs + (ty + 16 * a) * kStride + p);
      }
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const float4 y = *reinterpret_cast<const float4*>(ys + (tx + 16 * b) * kStride + p);
#pragma unroll
        for (int a = 0; a < A; ++a) acc[a][b] = fmaf(x[a].x, y.x, acc[a][b]);
#pragma unroll
        for (int a = 0; a < A; ++a) acc[a][b] = fmaf(x[a].y, y.y, acc[a][b]);
#pragma unroll
        for (int a = 0; a < A; ++a) acc[a][b] = fmaf(x[a].z, y.z, acc[a][b]);
#pragma unroll
        for (int a = 0; a < A; ++a) acc[a][b] = fmaf(x[a].w, y.w, acc[a][b]);
      }
    }
  }

  float* out = partial + chunk * n_params;
#pragma unroll
  for (int a = 0; a < A; ++a) {
    const int i = i0 + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int o = o0 + tx + 16 * b;
      if (i < job.in_dim && o < job.out_dim) out[job.w_off + i * job.out_dim + o] = acc[a][b];
    }
  }
  const int ob = o0 + static_cast<int>(threadIdx.x);
  const int b_end = kPadBias ? (job.out_dim + 3) & ~3 : job.out_dim;
  if (bias_rows && ob < b_end) out[job.b_off + ob] = ob < job.out_dim ? bsum : 0.f;
}

}  // namespace wgrad
