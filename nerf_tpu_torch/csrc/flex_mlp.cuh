// Device code shared by the 4x128 FlexibleNeRF kernels (mlp_t.cu, the
// render-path forward, flex_train.cu, the training forward + backward,
// stage.cu, the forward fused with compositing, and mlp.cu, the point-major
// and ray-major forwards):
// the packed parameter layout, the bf16 rounding, the positional encoding of
// a point tile, the feature-major dense layer over a tile in shared memory,
// and the whole forward over a tile, which saves the f32 training residuals
// when it is given a buffer for them (the bf16 instances of every kernel
// run flex_tc.cuh's tensor-core tile instead; the kBf16 rounding here has
// no instance left).
//
// A tile is kTile = 64 consecutive points of the public (N*S) point order,
// held feature-major in shared memory: act[feature][point].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flex {

constexpr int kHidden = 128;
constexpr int kDirHidden = 64;
constexpr int kFreqXyz = 10;
constexpr int kFreqDir = 4;
constexpr int kEnc = 3 + 6 * kFreqXyz;     // 63
constexpr int kEncDir = 3 + 6 * kFreqDir;  // 27
constexpr int kThreads = 128;
constexpr int kTile = 64;

// Packed parameter buffer: each layer's (in, out) row-major f32 weight
// followed by its bias. Only the feat rows of layers_dir[0] are here; its
// viewdir rows are folded into dc by the wrapper.
constexpr int kOffW1 = 0;                                  // layer1 (63, 128)
constexpr int kOffB1 = kOffW1 + kEnc * kHidden;
constexpr int kOffWx = kOffB1 + kHidden;                   // layers_xyz.{0,1,2}
constexpr int kLayerX = kHidden * kHidden + kHidden;       // (128, 128) + bias
constexpr int kOffWf = kOffWx + 3 * kLayerX;               // fc_feat (128, 128)
constexpr int kOffBf = kOffWf + kHidden * kHidden;
constexpr int kOffWa = kOffBf + kHidden;                   // fc_alpha (128, 1)
constexpr int kOffBa = kOffWa + kHidden;
constexpr int kOffWd = kOffBa + 1;                         // layers_dir.0 feat rows (128, 64)
constexpr int kOffBd = kOffWd + kHidden * kDirHidden;
constexpr int kOffWr = kOffBd + kDirHidden;                // fc_rgb (64, 3)
constexpr int kOffBr = kOffWr + kDirHidden * 3;
constexpr int kParams = kOffBr + 3;                        // 82820
// The point-major forward (mlp.cu) encodes each point's direction itself: its
// buffer appends layers_dir.0's direction rows (27, 64) to the one above.
constexpr int kOffWdDir = kParams;
constexpr int kParamsDir = kOffWdDir + kEncDir * kDirHidden;   // 84548

// Training residual rows of a point, stored per tile: res[tile][row][point].
constexpr int kResEnc = 0;                       // enc (63)
constexpr int kResA0 = kResEnc + kEnc;           // a0 (128), layer1's output, not ReLU'd
constexpr int kResH1 = kResA0 + kHidden;         // h1, h2, h3 (128 each)
constexpr int kResH2 = kResH1 + kHidden;
constexpr int kResH3 = kResH2 + kHidden;
constexpr int kResFeat = kResH3 + kHidden;       // feat (128)
constexpr int kResHd = kResFeat + kHidden;       // hd (64)
constexpr int kResRows = kResHd + kDirHidden;    // 767

template <bool kBf16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// Encoding of the tile's 3-vectors (points, or with kFreq = kFreqDir view
// directions) into act rows 0..3 + 6 kFreq - 1, in the checkpoint's
// interleaved order [x | sin f0 | cos f0 | sin f1 | ...]; points past
// n_points encode x = 0. The sinusoids are sincosf of x * 2^f (exact in f32),
// without fast math.
template <bool kBf16, int kFreq = kFreqXyz>
__device__ __forceinline__ void encode_tile(const float* __restrict__ pts,
                                            long long tile0, long long n_points,
                                            float* act) {
  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    const int p = i / 3;
    const int c = i % 3;
    const float x = tile0 + p < n_points ? pts[tile0 * 3 + i] : 0.f;
    act[c * kTile + p] = rnd<kBf16>(x);
    float scale = 1.f;
#pragma unroll
    for (int f = 0; f < kFreq; ++f) {
      float s, co;
      sincosf(x * scale, &s, &co);
      act[(3 + 6 * f + c) * kTile + p] = rnd<kBf16>(s);
      act[(6 + 6 * f + c) * kTile + p] = rnd<kBf16>(co);
      scale *= 2.f;
    }
  }
}

// out[j][p] = act(sum_k in[k][p] * W[k][j] + b[j] (+ dc[ray(p)][j])) for the
// tile's kTile points. Thread t computes feature t % OUT for a run of
// kTile / (kThreads / OUT) points. W is (in_dim, OUT) row-major, so
// neighbouring threads read neighbouring weights.
template <int OUT, bool kRelu, bool kBf16>
__device__ __forceinline__ void dense(const float* __restrict__ W,
                                      const float* __restrict__ bias,
                                      int in_dim, const float* in, float* out,
                                      const float* __restrict__ dc,
                                      long long tile0, int samples,
                                      long long n_points) {
  constexpr int kRun = kTile / (kThreads / OUT);
  const int j = threadIdx.x % OUT;
  const int p0 = (threadIdx.x / OUT) * kRun;
  float acc[kRun];
#pragma unroll
  for (int p = 0; p < kRun; ++p) acc[p] = 0.f;
  for (int k = 0; k < in_dim; ++k) {
    const float w = rnd<kBf16>(__ldg(W + k * OUT + j));
    const float4* a = reinterpret_cast<const float4*>(in + k * kTile + p0);
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) {
      const float4 v = a[q];
      acc[4 * q + 0] = fmaf(w, v.x, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(w, v.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(w, v.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(w, v.w, acc[4 * q + 3]);
    }
  }
  const float bj = __ldg(bias + j);
#pragma unroll
  for (int p = 0; p < kRun; ++p) {
    float y = acc[p] + bj;
    if (dc != nullptr) {
      const long long gp = tile0 + p0 + p;
      if (gp < n_points) y += __ldg(dc + (gp / samples) * OUT + j);
    }
    if (kRelu) y = fmaxf(y, 0.f);
    out[j * kTile + p0 + p] = rnd<kBf16>(y);
  }
}

// The layers of mlp.cu's direction layers: the same dense split into its
// sum (accumulate) and its epilogue (finish), so that a layer can sum two
// input blocks (dense2) or add a term of its own (dense_with). dense above
// keeps its own loop: the trunk of every kernel here runs it, and nvcc
// compiles the stage kernel (stage.cu) to 128 registers with it, to 110 with
// the split version, which ran 13% slower (NVIDIA H100 80GB HBM3, 700 W).
template <int OUT>
constexpr int kRunOf = kTile / (kThreads / OUT);

template <int OUT>
__device__ __forceinline__ int run0() {
  return (threadIdx.x / OUT) * kRunOf<OUT>;
}

// acc[p] += sum_k in[k][p0 + p] * W[k][j] over in_dim input rows, for the
// thread's feature j = t % OUT and run of points from p0 = run0<OUT>().
template <int OUT, bool kBf16>
__device__ __forceinline__ void accumulate(float (&acc)[kRunOf<OUT>],
                                           const float* __restrict__ W, int in_dim,
                                           const float* in) {
  const int j = threadIdx.x % OUT;
  const int p0 = run0<OUT>();
  for (int k = 0; k < in_dim; ++k) {
    const float w = rnd<kBf16>(__ldg(W + k * OUT + j));
    const float4* a = reinterpret_cast<const float4*>(in + k * kTile + p0);
#pragma unroll
    for (int q = 0; q < kRunOf<OUT> / 4; ++q) {
      const float4 v = a[q];
      acc[4 * q + 0] = fmaf(w, v.x, acc[4 * q + 0]);
      acc[4 * q + 1] = fmaf(w, v.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(w, v.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(w, v.w, acc[4 * q + 3]);
    }
  }
}

// out[j][p] = act(add(p, j, acc[p] + b[j])) for the thread's run; add(p, j,
// y) returns y plus whatever the caller adds for point p of the tile. The
// callbacks are structs with force-inlined operators, not lambdas: a
// lambda's call is not certain to be inlined.
template <int OUT, bool kRelu, bool kBf16, typename Add>
__device__ __forceinline__ void finish(const float (&acc)[kRunOf<OUT>],
                                       const float* __restrict__ bias, float* out,
                                       Add add) {
  const int j = threadIdx.x % OUT;
  const int p0 = run0<OUT>();
  const float bj = __ldg(bias + j);
#pragma unroll
  for (int p = 0; p < kRunOf<OUT>; ++p) {
    float y = add(p0 + p, j, acc[p] + bj);
    if (kRelu) y = fmaxf(y, 0.f);
    out[j * kTile + p0 + p] = rnd<kBf16>(y);
  }
}

struct AddNothing {
  __device__ __forceinline__ float operator()(int, int, float y) const { return y; }
};

// dense with add(p, j, y) in place of dc (mlp.cu's ray-major direction layer).
template <int OUT, bool kRelu, bool kBf16, typename Add>
__device__ __forceinline__ void dense_with(const float* __restrict__ W,
                                           const float* __restrict__ bias, int in_dim,
                                           const float* in, float* out, Add add) {
  float acc[kRunOf<OUT>];
#pragma unroll
  for (int p = 0; p < kRunOf<OUT>; ++p) acc[p] = 0.f;
  accumulate<OUT, kBf16>(acc, W, in_dim, in);
  finish<OUT, kRelu, kBf16>(acc, bias, out, add);
}

// dense over two input blocks into one sum: in_dim rows of `in` through W,
// then in_dim2 rows of in2 through W2.
template <int OUT, bool kRelu, bool kBf16>
__device__ __forceinline__ void dense2(const float* __restrict__ W, int in_dim, const float* in,
                                       const float* __restrict__ W2, int in_dim2,
                                       const float* in2, const float* __restrict__ bias,
                                       float* out) {
  float acc[kRunOf<OUT>];
#pragma unroll
  for (int p = 0; p < kRunOf<OUT>; ++p) acc[p] = 0.f;
  accumulate<OUT, kBf16>(acc, W, in_dim, in);
  accumulate<OUT, kBf16>(acc, W2, in_dim2, in2);
  finish<OUT, kRelu, kBf16>(acc, bias, out, AddNothing{});
}

// Copy `rows` feature rows of a tile from shared memory to its residual rows
// (a no-op without a residual buffer).
__device__ __forceinline__ void save_rows(const float* act, int rows, float* dst) {
  if (dst == nullptr) return;
  for (int i = threadIdx.x; i < rows * kTile; i += kThreads) dst[i] = act[i];
}

// The forward over the tile of points tile0 .. tile0 + kTile - 1: encoding,
// layer1 (no activation), the ReLU trunk, fc_feat (ReLU) and fc_alpha (from
// h3), the direction layer, fc_rgb -> row (point - out0) of out (.., 4)
// [r, g, b, sigma], for the points below n_points. The tile's activations
// ping-pong between buf_a and buf_b (128 x kTile each). With res non-null,
// each layer's stored input is also written to the tile's residual rows (f32,
// the f32 training forward's). It ends without a barrier: a caller that runs a
// second tile in the same block syncs first.
//
// dir_layer(feat, hd), a struct as finish's callbacks are, writes hd =
// relu(feat @ W_dir[:128] + the direction's term + b) into rows 0..63 of hd
// (buf_a) from feat (buf_b). Every thread calls it, after a barrier that
// ends the trunk's reads of buf_a, so it may use buf_a's rows 64..127 as
// scratch, with a barrier of its own before its dense layer reads them.
template <bool kBf16, typename DirLayer>
__device__ __forceinline__ void forward_tile_with(const float* __restrict__ pts,
                                                  const float* __restrict__ params,
                                                  float* __restrict__ out, long long out0,
                                                  float* res, long long tile0,
                                                  long long n_points, float* buf_a,
                                                  float* buf_b, DirLayer dir_layer) {
  float* rt = res == nullptr ? nullptr : res + (tile0 / kTile) * kResRows * kTile;
  auto row = [rt](int r) { return rt == nullptr ? nullptr : rt + r * kTile; };

  // Encoding into buf_a rows 0..62, checkpoint order.
  encode_tile<kBf16>(pts, tile0, n_points, buf_a);
  __syncthreads();
  save_rows(buf_a, kEnc, row(kResEnc));
  dense<kHidden, false, kBf16>(params + kOffW1, params + kOffB1, kEnc, buf_a,
                               buf_b, nullptr, tile0, 1, n_points);
  __syncthreads();
  save_rows(buf_b, kHidden, row(kResA0));
  dense<kHidden, true, kBf16>(params + kOffWx, params + kOffWx + kHidden * kHidden,
                              kHidden, buf_b, buf_a, nullptr, tile0, 1, n_points);
  __syncthreads();
  save_rows(buf_a, kHidden, row(kResH1));
  dense<kHidden, true, kBf16>(params + kOffWx + kLayerX,
                              params + kOffWx + kLayerX + kHidden * kHidden,
                              kHidden, buf_a, buf_b, nullptr, tile0, 1, n_points);
  __syncthreads();
  save_rows(buf_b, kHidden, row(kResH2));
  dense<kHidden, true, kBf16>(params + kOffWx + 2 * kLayerX,
                              params + kOffWx + 2 * kLayerX + kHidden * kHidden,
                              kHidden, buf_b, buf_a, nullptr, tile0, 1, n_points);
  __syncthreads();

  // h3 in buf_a: feat = relu(fc_feat) into buf_b; sigma (raw) per point.
  save_rows(buf_a, kHidden, row(kResH3));
  dense<kHidden, true, kBf16>(params + kOffWf, params + kOffBf, kHidden, buf_a,
                              buf_b, nullptr, tile0, 1, n_points);
  if (threadIdx.x < kTile) {
    const int p = threadIdx.x;
    float acc = 0.f;
    for (int k = 0; k < kHidden; ++k) {
      acc = fmaf(rnd<kBf16>(__ldg(params + kOffWa + k)), buf_a[k * kTile + p], acc);
    }
    if (tile0 + p < n_points) out[(tile0 + p - out0) * 4 + 3] = acc + __ldg(params + kOffBa);
  }
  __syncthreads();

  // Direction layer into buf_a rows 0..63.
  save_rows(buf_b, kHidden, row(kResFeat));
  dir_layer(buf_b, buf_a);
  __syncthreads();
  save_rows(buf_a, kDirHidden, row(kResHd));

  // fc_rgb: one (channel, point) pair per thread step.
  for (int i = threadIdx.x; i < 3 * kTile; i += kThreads) {
    const int c = i / kTile;
    const int p = i % kTile;
    float acc = 0.f;
    for (int k = 0; k < kDirHidden; ++k) {
      acc = fmaf(rnd<kBf16>(__ldg(params + kOffWr + k * 3 + c)), buf_a[k * kTile + p], acc);
    }
    if (tile0 + p < n_points) out[(tile0 + p - out0) * 4 + c] = acc + __ldg(params + kOffBr + c);
  }
}

// The direction layer whose term is the ray's row of dc (n_points / samples,
// 64), read from device memory.
template <bool kBf16>
struct DirLayerRayRow {
  const float* params;
  const float* dc;
  long long tile0;
  long long n_points;
  int samples;
  __device__ __forceinline__ void operator()(const float* feat, float* hd) const {
    dense<kDirHidden, true, kBf16>(params + kOffWd, params + kOffBd, kHidden, feat, hd, dc,
                                   tile0, samples, n_points);
  }
};

// forward_tile_with with DirLayerRayRow (mlp_t.cu, flex_train.cu, stage.cu).
template <bool kBf16>
__device__ __forceinline__ void forward_tile_at(const float* __restrict__ pts,
                                                const float* __restrict__ dc,
                                                const float* __restrict__ params,
                                                float* __restrict__ out, long long out0,
                                                float* res, long long tile0,
                                                long long n_points, int samples,
                                                float* buf_a, float* buf_b) {
  forward_tile_with<kBf16>(pts, params, out, out0, res, tile0, n_points, buf_a, buf_b,
                           DirLayerRayRow<kBf16>{params, dc, tile0, n_points, samples});
}

// The forward over the tile blockIdx.x, into out (n_points, 4).
template <bool kBf16>
__device__ __forceinline__ void forward_tile(const float* __restrict__ pts,
                                             const float* __restrict__ dc,
                                             const float* __restrict__ params,
                                             float* __restrict__ out, float* res,
                                             long long n_points, int samples,
                                             float* buf_a, float* buf_b) {
  forward_tile_at<kBf16>(pts, dc, params, out, 0, res,
                         static_cast<long long>(blockIdx.x) * kTile, n_points, samples, buf_a,
                         buf_b);
}

}  // namespace flex
