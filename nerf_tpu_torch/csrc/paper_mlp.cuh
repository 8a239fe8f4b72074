// Device code shared by the 8x256 PaperNeRF kernels (paper_t.cu, the
// render-path forward, and paper_train.cu, the training forward + backward;
// their f32 instances run this file's FMA design, their bf16 instances the
// tensor-core one of paper_tc.cuh, which shares its parameter layout):
// the packed parameter layout, the residual rows, the positional encoding of
// a point tile at any depth, the register-tiled dense layer over a tile in
// shared memory, and the whole forward over a tile, which saves the training
// residuals when it is given a buffer for them.
//
// A tile is kTile = 64 consecutive points of the public (N*S) point order,
// held feature-major in shared memory: act[feature][point]. A block of
// kThreads = 256 threads computes a dense layer of OUT outputs as OUT/4
// feature groups x (256 / (OUT/4)) point runs: each thread keeps 4 output
// features x kRun points (16 at OUT = 256, 8 at OUT = 128) in registers,
// reads one float4 of weights per input feature (neighbouring threads,
// neighbouring addresses; the 2.5 MB parameter buffer stays L2 resident) and
// its points' activations as float4 broadcasts from shared memory. Because
// the whole output tile sits in registers, a layer writes it back over its
// own input after a barrier: one 256 x 64 f32 buffer (64 KB) serves the
// trunk, and the encoding (dim x 64) stays resident beside it for the skip
// at layer 4, ~80 KB a block at 10 frequencies, two blocks an SM.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace paper {

constexpr int kWidth = 256;
constexpr int kDirWidth = 128;
constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kTF = 4;          // output features per thread in a dense layer
constexpr int kMaxFreq = 16;    // encoding depths the kernels take: 0..16

__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }
__host__ __device__ constexpr int enc_dim(int num_freq) { return 3 + 6 * num_freq; }

// Offsets (floats) of the packed forward parameters: each layer's (in, out)
// row-major weight, then its bias, every segment padded to a multiple of 4
// floats so that each weight row starts 16-byte aligned. Only the feat rows
// of layers_dir[0] are here; its viewdir rows are folded into dc by the
// wrapper, and layers_dir[3] is never run.
struct Layout {
  int dim;            // encoding width 3 + 6F
  int w[8], b[8];     // layers_xyz.i; w[4] is (dim + 256, 256), rows [enc; h]
  int wf, bf;         // fc_feat (256, 256)
  int wa, ba;         // fc_alpha (256, 1)
  int wd[3], bd[3];   // layers_dir.0 feat rows (256, 128), layers_dir.1, .2 (128, 128)
  int wr, br;         // fc_rgb (128, 3)
  int total;
};

__host__ __device__ inline int take(int* off, int n) {
  const int at = *off;
  *off += pad4(n);
  return at;
}

__host__ __device__ inline Layout make_layout(int num_freq) {
  Layout l{};
  l.dim = enc_dim(num_freq);
  int off = 0;
  for (int i = 0; i < 8; ++i) {
    const int in = i == 0 ? l.dim : i == 4 ? l.dim + kWidth : kWidth;
    l.w[i] = take(&off, in * kWidth);
    l.b[i] = take(&off, kWidth);
  }
  l.wf = take(&off, kWidth * kWidth);
  l.bf = take(&off, kWidth);
  l.wa = take(&off, kWidth);
  l.ba = take(&off, 1);
  l.wd[0] = take(&off, kWidth * kDirWidth);
  l.bd[0] = take(&off, kDirWidth);
  for (int i = 1; i < 3; ++i) {
    l.wd[i] = take(&off, kDirWidth * kDirWidth);
    l.bd[i] = take(&off, kDirWidth);
  }
  l.wr = take(&off, kDirWidth * 3);
  l.br = take(&off, 3);
  l.total = off;
  return l;
}

// Dynamic shared memory of a forward block: the encoding and one 256-row
// activation buffer, 64 points each.
inline size_t fwd_smem_bytes(const Layout& L) {
  return static_cast<size_t>(L.dim + kWidth) * kTile * sizeof(float);
}

// Training residual rows of a point, stored per tile: res[tile][row][point]:
// enc (dim), h0..h7 (post-ReLU trunk, 256 each), feat (256, not ReLU'd),
// d0..d2 (post-ReLU direction branch, 128 each).
__host__ __device__ constexpr int res_h(int dim, int i) { return dim + kWidth * i; }
__host__ __device__ constexpr int res_feat(int dim) { return dim + 8 * kWidth; }
__host__ __device__ constexpr int res_d(int dim, int i) { return dim + 9 * kWidth + kDirWidth * i; }
__host__ __device__ constexpr int res_rows(int dim) { return res_d(dim, 3); }

// Encoding of the tile's points into enc rows 0..dim-1, in the checkpoint's
// interleaved order [x | sin f0 | cos f0 | sin f1 | ...]; points past
// n_points encode x = 0. The sinusoids are sincosf of x * 2^f (exact in
// f32), without fast math.
__device__ __forceinline__ void encode_tile(const float* __restrict__ pts, long long tile0,
                                            long long n_points, int num_freq, float* enc) {
  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    const int p = i / 3;
    const int c = i % 3;
    const float x = tile0 + p < n_points ? pts[tile0 * 3 + i] : 0.f;
    enc[c * kTile + p] = x;
    float scale = 1.f;
    for (int f = 0; f < num_freq; ++f) {
      float s, co;
      sincosf(x * scale, &s, &co);
      enc[(3 + 6 * f + c) * kTile + p] = s;
      enc[(6 + 6 * f + c) * kTile + p] = co;
      scale *= 2.f;
    }
  }
}

// One thread's share of a dense layer's output tile: features j0..j0+3 of
// points p0..p0+kRun-1, accumulated in registers.
template <int OUT>
struct Acc {
  static constexpr int kGroups = OUT / kTF;
  static constexpr int kRun = kTile / (kThreads / kGroups);
  static_assert(kThreads % kGroups == 0 && kRun % 4 == 0, "tile shape");
  int j0, p0;
  float v[kTF][kRun];

  __device__ __forceinline__ Acc()
      : j0((threadIdx.x % kGroups) * kTF), p0((threadIdx.x / kGroups) * kRun) {
#pragma unroll
    for (int f = 0; f < kTF; ++f) {
#pragma unroll
      for (int p = 0; p < kRun; ++p) v[f][p] = 0.f;
    }
  }

  // v[f][p] += sum_{k < K} W[k][j0 + f] * in[k][p0 + p]; W (K, OUT) row-major
  // in device memory, 16-byte aligned; in feature-major in shared memory.
  __device__ __forceinline__ void mac(const float* __restrict__ W, int K, const float* in) {
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      const float4 w4 = __ldg(reinterpret_cast<const float4*>(W + k * OUT + j0));
      const float w[kTF] = {w4.x, w4.y, w4.z, w4.w};
      const float4* a = reinterpret_cast<const float4*>(in + k * kTile + p0);
#pragma unroll
      for (int q = 0; q < kRun / 4; ++q) {
        const float4 x = a[q];
#pragma unroll
        for (int f = 0; f < kTF; ++f) {
          v[f][4 * q + 0] = fmaf(w[f], x.x, v[f][4 * q + 0]);
          v[f][4 * q + 1] = fmaf(w[f], x.y, v[f][4 * q + 1]);
          v[f][4 * q + 2] = fmaf(w[f], x.z, v[f][4 * q + 2]);
          v[f][4 * q + 3] = fmaf(w[f], x.w, v[f][4 * q + 3]);
        }
      }
    }
  }

  // Write v over the tile buffer `out` once every thread has finished
  // reading the layer's inputs (which may be `out` itself); returns when the
  // new rows are visible to the block.
  __device__ __forceinline__ void write(float* out) {
    __syncthreads();
#pragma unroll
    for (int f = 0; f < kTF; ++f) {
#pragma unroll
      for (int q = 0; q < kRun / 4; ++q) {
        *reinterpret_cast<float4*>(out + (j0 + f) * kTile + p0 + 4 * q) =
            make_float4(v[f][4 * q], v[f][4 * q + 1], v[f][4 * q + 2], v[f][4 * q + 3]);
      }
    }
    __syncthreads();
  }

  // The forward epilogue: v = act(v + b[j] (+ dc[ray(p)][j])). dc is (rays,
  // OUT) f32; the ray of tile point p is (tile0 + p) / samples.
  template <bool kRelu>
  __device__ __forceinline__ void bias_act(const float* __restrict__ bias,
                                           const float* __restrict__ dc, long long tile0,
                                           int samples, long long n_points) {
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(bias + j0));
    const float b[kTF] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int p = 0; p < kRun; ++p) {
      float d[kTF] = {0.f, 0.f, 0.f, 0.f};
      const long long gp = tile0 + p0 + p;
      if (dc != nullptr && gp < n_points) {
        const float4 d4 = __ldg(reinterpret_cast<const float4*>(dc + (gp / samples) * OUT + j0));
        d[0] = d4.x;
        d[1] = d4.y;
        d[2] = d4.z;
        d[3] = d4.w;
      }
#pragma unroll
      for (int f = 0; f < kTF; ++f) {
        const float y = v[f][p] + b[f] + d[f];
        v[f][p] = kRelu ? fmaxf(y, 0.f) : y;
      }
    }
  }
};

// Copy `rows` feature rows of a tile from shared memory to its residual rows
// (a no-op without a residual buffer).
__device__ __forceinline__ void save_rows(const float* act, int rows, float* dst) {
  if (dst == nullptr) return;
  for (int i = threadIdx.x; i < rows * kTile; i += kThreads) dst[i] = act[i];
}

// The forward over the tile blockIdx.x: encoding into `enc` (dim rows), the
// 8-layer ReLU trunk with [enc; h3] into layer 4, fc_feat (no ReLU), sigma
// from feat, the direction branch (layers_dir.0 feat rows + the ray's dc,
// then layers_dir.1 and .2, all ReLU'd), fc_rgb -> out (n_points, 4)
// [r, g, b, sigma]. Every layer writes its output over `act` (256 rows).
// With res non-null each layer's stored output is also written to the
// tile's residual rows. This is the f32 design: the bf16 one is
// paper_tc.cuh's.
__device__ __forceinline__ void forward_tile(const float* __restrict__ pts,
                                             const float* __restrict__ dc,
                                             const float* __restrict__ params, const Layout& L,
                                             float* __restrict__ out, float* res,
                                             long long n_points, int samples, int num_freq,
                                             float* enc, float* act) {
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const int dim = L.dim;
  float* rt = res == nullptr ? nullptr
                             : res + static_cast<long long>(blockIdx.x) * res_rows(dim) * kTile;
  auto row = [rt](int r) { return rt == nullptr ? nullptr : rt + r * kTile; };

  encode_tile(pts, tile0, n_points, num_freq, enc);
  __syncthreads();
  save_rows(enc, dim, row(0));

  for (int i = 0; i < 8; ++i) {
    Acc<kWidth> a;
    if (i == 0) {
      a.mac(params + L.w[0], dim, enc);
    } else if (i == 4) {
      // Skip: W4 rows [enc; h], two products summed in f32.
      a.mac(params + L.w[4], dim, enc);
      a.mac(params + L.w[4] + dim * kWidth, kWidth, act);
    } else {
      a.mac(params + L.w[i], kWidth, act);
    }
    a.bias_act<true>(params + L.b[i], nullptr, tile0, samples, n_points);
    a.write(act);
    save_rows(act, kWidth, row(res_h(dim, i)));
  }

  {  // feat = fc_feat(h7), not ReLU'd.
    Acc<kWidth> a;
    a.mac(params + L.wf, kWidth, act);
    a.bias_act<false>(params + L.bf, nullptr, tile0, samples, n_points);
    a.write(act);
    save_rows(act, kWidth, row(res_feat(dim)));
  }
  // sigma from feat, one point per thread; done before layers_dir.0 writes
  // over feat (its write waits for every thread).
  if (threadIdx.x < kTile) {
    const int p = threadIdx.x;
    float acc = 0.f;
    for (int k = 0; k < kWidth; ++k) {
      acc = fmaf(__ldg(params + L.wa + k), act[k * kTile + p], acc);
    }
    if (tile0 + p < n_points) out[(tile0 + p) * 4 + 3] = acc + __ldg(params + L.ba);
  }
  for (int i = 0; i < 3; ++i) {
    Acc<kDirWidth> a;
    a.mac(params + L.wd[i], i == 0 ? kWidth : kDirWidth, act);
    a.bias_act<true>(params + L.bd[i], i == 0 ? dc : nullptr, tile0, samples, n_points);
    a.write(act);
    save_rows(act, kDirWidth, row(res_d(dim, i)));
  }

  // fc_rgb: one (channel, point) pair per thread.
  for (int i = threadIdx.x; i < 3 * kTile; i += kThreads) {
    const int c = i / kTile;
    const int p = i % kTile;
    float acc = 0.f;
    for (int k = 0; k < kDirWidth; ++k) {
      acc = fmaf(__ldg(params + L.wr + k * 3 + c), act[k * kTile + p], acc);
    }
    if (tile0 + p < n_points) out[(tile0 + p) * 4 + c] = acc + __ldg(params + L.br + c);
  }
}

}  // namespace paper
