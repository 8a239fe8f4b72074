// Fused FlexibleNeRF (4x128, 10/4 encoding) training kernels for Hopper
// (sm_90a): a forward that saves the residuals, and a backward that gives
// every parameter gradient and the per-ray direction-contribution gradient.
//
// Replaces nerf_tpu/ops/pallas/flex_train.py:fused_flex_mlp_train, the
// custom-VJP pair that nerf_tpu/ops/pallas/train_vjp.py:build_train_vjp
// builds (pallas_call at train_vjp.py:197, forward, and :241, backward).
// Same function at the public layout:
//   forward:  pts (N, S, 3) f32 + dc = enc(viewdirs) @ W_dir[128:] (N, 64) f32
//             -> raw (N, S, 4) f32 [r, g, b, sigma], plus residuals in the
//             compute dtype: enc, a0 (layer1's output, not ReLU'd), h1, h2,
//             h3, feat and hd (post-ReLU);
//   backward: cotangent (N, S, 4) f32 + residuals -> the gradient of the
//             packed parameter buffer (flex_mlp.cuh's layout) and ddc (N, 64).
// pts and viewdirs get no gradient (training data), as on the TPU.
//
// What bounds it on the card: arithmetic. A point costs ~82k multiply-adds
// forward and ~156k backward (~74k to carry the gradient back through the
// layers, ~82k for the weight gradients), against ~1.5 KB (bf16) or ~3 KB
// (f32) of residuals and ~2.8 KB of f32 deltas moved through device memory,
// far above the memory roofline. The first design runs f32 FMAs from
// registers and shared memory; tensor cores (wgmma) are later work.
//
// Design (right and simple first):
//   * forward: mlp_t.cu's evaluation (flex_mlp.cuh's forward_tile), one
//     block of 128 threads per tile of 64 points, given a residual buffer, so
//     it also copies each layer's tile from shared memory into
//     res[tile][row][point], coalesced;
//   * backward, four launches on one stream:
//     1. train_bwd_act: per 64-point tile, carries the cotangent back through
//        fc_rgb, the direction layer, the fused [fc_feat; fc_alpha] head
//        (one 129-deep contraction that joins at h3, since fc_alpha reads h3),
//        the trunk and down to layer1's output a0 (unmasked: layer1 has no
//        ReLU). ReLU masks compare the stored (compute-dtype) activation with
//        0. Every layer's output gradient is written, f32 and unrounded, to a
//        delta buffer delta[tile][row][point];
//     2. train_bwd_wgrad: dW = X^T dY and db = sum dY for the eight weight
//        matrices, as one launch over (64 x 64 output tile, chunk of 16
//        point tiles). Each block keeps its partial sums in registers and
//        writes them to its chunk's row of a scratch buffer laid out like the
//        packed parameters;
//     3. train_bwd_reduce: sums the chunks' rows in a fixed order. No atomics:
//        two identical calls give bitwise-equal gradients;
//     4. train_bwd_ddc: ddc[ray] = sum over the ray's samples of the
//        direction layer's gradient, one thread per (ray, feature), so rays
//        that straddle tiles (S not a divisor of 64) are summed whole.
//   * the backward reads the weights as nn.Linear's (out, in) matrices from a
//     second packed buffer (kT* offsets below), so that neighbouring threads
//     read neighbouring weights when they compute neighbouring input
//     features.
//
// compute dtype bf16: both operands of every product (forward, dX = dY W^T
// and dW = X^T dY) are rounded to bf16 and the sums stay f32, as
// preferred_element_type=f32 does on the TPU; residuals are stored in bf16.
// Bias gradients and ddc sum the unrounded f32 deltas, as the TPU kernel's
// rowsum and ddc do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flex_mlp.cuh"

namespace {

using namespace flex;

// Delta rows (f32) of a point, same layout: the cotangent, then the gradient
// of each layer's output.
constexpr int kDRgb = 0;                         // drgb (3)
constexpr int kDSig = 3;                         // dsigma (1)
constexpr int kDHd = 4;                          // dhd (64), masked
constexpr int kDFeat = kDHd + kDirHidden;        // dfeat (128), masked
constexpr int kDH3 = kDFeat + kHidden;           // dh3, dh2, dh1 (128 each), masked
constexpr int kDH2 = kDH3 + kHidden;
constexpr int kDH1 = kDH2 + kHidden;
constexpr int kDA0 = kDH1 + kHidden;             // da0 (128), unmasked
constexpr int kDRows = kDA0 + kHidden;           // 708

// Backward weights, each nn.Linear's (out, in) row-major matrix.
constexpr int kTWr = 0;                                    // fc_rgb (3, 64)
constexpr int kTWd = kTWr + 3 * kDirHidden;                // layers_dir.0 feat cols (64, 128)
constexpr int kTWfa = kTWd + kDirHidden * kHidden;         // [fc_feat (128, 128); fc_alpha (1, 128)]
constexpr int kTWx2 = kTWfa + (kHidden + 1) * kHidden;     // layers_xyz.2 (128, 128)
constexpr int kTWx1 = kTWx2 + kHidden * kHidden;           // layers_xyz.1
constexpr int kTWx0 = kTWx1 + kHidden * kHidden;           // layers_xyz.0
constexpr int kTParams = kTWx0 + kHidden * kHidden;        // 74048

constexpr size_t kFwdSmem = 2 * kHidden * kTile * sizeof(float);
constexpr size_t kActSmem = (2 * kHidden + 1) * kTile * sizeof(float);

// Weight-gradient tiling.
constexpr int kWTile = 64;            // output tile: 64 inputs x 64 outputs
constexpr int kWThreads = 256;        // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTilesPerChunk = 16;    // point tiles summed by one block
constexpr int kWPad = kWTile + 4;     // shared row length (float4-aligned)

template <bool kBf16>
using Res = std::conditional_t<kBf16, __nv_bfloat16, float>;

// ---------------------------------------------------------------------------
// Forward: mlp_t's evaluation, saving every residual.

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
train_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ dc,
                 const float* __restrict__ params, float* __restrict__ out,
                 Res<kBf16>* __restrict__ res, long long n_points, int samples) {
  extern __shared__ float4 smem[];
  float* buf_a = reinterpret_cast<float*>(smem);
  forward_tile<kBf16, Res<kBf16>>(pts, dc, params, out, res, n_points, samples, buf_a,
                                  buf_a + kHidden * kTile);
}

// ---------------------------------------------------------------------------
// Backward 1: the gradient of every layer's output, per tile.

// dX[j][p] = mask(act[j][p] > 0) * sum_k WT[k][j] * dY[k][p], WT (in_dim, OUT)
// being the (out, in) nn.Linear weight of the forward layer. The unrounded
// result goes to delta rows (f32), the rounded one to out_s (the next
// product's operand) unless out_s is null. mask_rows null = no mask.
template <int OUT, bool kBf16>
__device__ __forceinline__ void dense_bwd(const float* __restrict__ WT, int in_dim,
                                          const float* in,
                                          const Res<kBf16>* __restrict__ mask_rows,
                                          float* out_s, float* __restrict__ delta_rows) {
  constexpr int kRun = kTile / (kThreads / OUT);
  const int j = threadIdx.x % OUT;
  const int p0 = (threadIdx.x / OUT) * kRun;
  float acc[kRun];
#pragma unroll
  for (int p = 0; p < kRun; ++p) acc[p] = 0.f;
  for (int k = 0; k < in_dim; ++k) {
    const float w = rnd<kBf16>(__ldg(WT + k * OUT + j));
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
  if (mask_rows != nullptr) {
    const Res<kBf16>* m = mask_rows + j * kTile + p0;
#pragma unroll
    for (int p = 0; p < kRun; ++p) acc[p] = load(m + p) > 0.f ? acc[p] : 0.f;
  }
  float4* d = reinterpret_cast<float4*>(delta_rows + j * kTile + p0);
#pragma unroll
  for (int q = 0; q < kRun / 4; ++q) {
    d[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
  }
  if (out_s != nullptr) {
#pragma unroll
    for (int p = 0; p < kRun; ++p) out_s[j * kTile + p0 + p] = rnd<kBf16>(acc[p]);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
train_bwd_act_kernel(const float* __restrict__ g, const Res<kBf16>* __restrict__ res,
                     const float* __restrict__ wt, float* __restrict__ delta,
                     long long n_points) {
  extern __shared__ float4 smem[];
  float* buf_a = reinterpret_cast<float*>(smem);   // 129 rows
  float* buf_b = buf_a + (kHidden + 1) * kTile;    // 128 rows
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const Res<kBf16>* rt = res + static_cast<long long>(blockIdx.x) * kResRows * kTile;
  float* dt = delta + static_cast<long long>(blockIdx.x) * kDRows * kTile;

  // Cotangent: drgb into buf_a rows 0..2, dsigma into row 128 (the fused
  // head's extra row); padded points get 0, so they add nothing anywhere.
  if (threadIdx.x < kTile) {
    const int p = threadIdx.x;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tile0 + p < n_points) v = reinterpret_cast<const float4*>(g)[tile0 + p];
    buf_a[0 * kTile + p] = rnd<kBf16>(v.x);
    buf_a[1 * kTile + p] = rnd<kBf16>(v.y);
    buf_a[2 * kTile + p] = rnd<kBf16>(v.z);
    buf_a[kHidden * kTile + p] = rnd<kBf16>(v.w);
    dt[(kDRgb + 0) * kTile + p] = v.x;
    dt[(kDRgb + 1) * kTile + p] = v.y;
    dt[(kDRgb + 2) * kTile + p] = v.z;
    dt[kDSig * kTile + p] = v.w;
  }
  __syncthreads();
  // dhd = mask(hd) * drgb W_rgb^T
  dense_bwd<kDirHidden, kBf16>(wt + kTWr, 3, buf_a, rt + kResHd * kTile, buf_b,
                               dt + kDHd * kTile);
  __syncthreads();
  // dfeat = mask(feat) * dhd W_dir[:128]^T  (buf_a row 128 keeps dsigma)
  dense_bwd<kHidden, kBf16>(wt + kTWd, kDirHidden, buf_b, rt + kResFeat * kTile, buf_a,
                            dt + kDFeat * kTile);
  __syncthreads();
  // dh3 = mask(h3) * [dfeat; dsigma] [W_feat; W_alpha]^T
  dense_bwd<kHidden, kBf16>(wt + kTWfa, kHidden + 1, buf_a, rt + kResH3 * kTile, buf_b,
                            dt + kDH3 * kTile);
  __syncthreads();
  dense_bwd<kHidden, kBf16>(wt + kTWx2, kHidden, buf_b, rt + kResH2 * kTile, buf_a,
                            dt + kDH2 * kTile);
  __syncthreads();
  dense_bwd<kHidden, kBf16>(wt + kTWx1, kHidden, buf_a, rt + kResH1 * kTile, buf_b,
                            dt + kDH1 * kTile);
  __syncthreads();
  // da0: layer1 has no ReLU, so no mask.
  dense_bwd<kHidden, kBf16>(wt + kTWx0, kHidden, buf_b, nullptr, nullptr,
                            dt + kDA0 * kTile);
}

// ---------------------------------------------------------------------------
// Backward 2: weight and bias gradients, partial sums per chunk of tiles.

struct WJob {
  int x_row, in_dim;    // residual rows X
  int d_row, out_dim;   // delta rows dY
  int w_off, b_off;     // where dW (in, out) and db go in the packed layout
  int first_tile;       // index of the job's first 64 x 64 output tile
};

constexpr int kNumJobs = 8;
__constant__ WJob kJobs[kNumJobs] = {
    {kResHd, kDirHidden, kDRgb, 3, kOffWr, kOffBr, 0},                         // fc_rgb: 1 tile
    {kResFeat, kHidden, kDHd, kDirHidden, kOffWd, kOffBd, 1},                  // layers_dir.0: 2
    {kResH3, kHidden, kDFeat, kHidden, kOffWf, kOffBf, 3},                     // fc_feat: 4
    {kResH3, kHidden, kDSig, 1, kOffWa, kOffBa, 7},                            // fc_alpha: 2
    {kResH2, kHidden, kDH3, kHidden, kOffWx + 2 * kLayerX,
     kOffWx + 2 * kLayerX + kHidden * kHidden, 9},                             // layers_xyz.2: 4
    {kResH1, kHidden, kDH2, kHidden, kOffWx + kLayerX,
     kOffWx + kLayerX + kHidden * kHidden, 13},                                // layers_xyz.1: 4
    {kResA0, kHidden, kDH1, kHidden, kOffWx, kOffWx + kHidden * kHidden, 17},  // layers_xyz.0: 4
    {kResEnc, kEnc, kDA0, kHidden, kOffW1, kOffB1, 21},                        // layer1: 2
};
constexpr int kNumWTiles = 23;

template <bool kBf16>
__global__ void __launch_bounds__(kWThreads)
train_bwd_wgrad_kernel(const Res<kBf16>* __restrict__ res, const float* __restrict__ delta,
                       float* __restrict__ partial, long long n_tiles) {
  __shared__ __align__(16) float xs[kTile * kWPad];   // xs[p][i]
  __shared__ __align__(16) float ys[kTile * kWPad];   // ys[p][o], rounded

  int jb = 0;
  while (jb + 1 < kNumJobs && kJobs[jb + 1].first_tile <= static_cast<int>(blockIdx.x)) ++jb;
  const WJob job = kJobs[jb];
  const int o_tiles = (job.out_dim + kWTile - 1) / kWTile;
  const int local = blockIdx.x - job.first_tile;
  const int i0 = (local / o_tiles) * kWTile;
  const int o0 = (local % o_tiles) * kWTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const bool bias_block = i0 == 0 && threadIdx.x < kWTile && o0 + threadIdx.x < job.out_dim;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  }
  float bsum = 0.f;

  const long long t_begin = static_cast<long long>(blockIdx.y) * kTilesPerChunk;
  const long long t_end = min(t_begin + kTilesPerChunk, n_tiles);
  for (long long t = t_begin; t < t_end; ++t) {
    const Res<kBf16>* xt = res + (t * kResRows + job.x_row) * kTile;
    const float* dtile = delta + (t * kDRows + job.d_row) * kTile;
    for (int e = threadIdx.x; e < kWTile * kTile; e += kWThreads) {
      const int r = e / kTile;
      const int p = e % kTile;
      xs[p * kWPad + r] = i0 + r < job.in_dim ? load(xt + (i0 + r) * kTile + p) : 0.f;
      ys[p * kWPad + r] = o0 + r < job.out_dim ? rnd<kBf16>(dtile[(o0 + r) * kTile + p]) : 0.f;
    }
    if (bias_block) {
      const float* row = dtile + (o0 + threadIdx.x) * kTile;
      for (int p = 0; p < kTile; ++p) bsum += row[p];
    }
    __syncthreads();
#pragma unroll 4
    for (int p = 0; p < kTile; ++p) {
      const float4 xa = *reinterpret_cast<const float4*>(xs + p * kWPad + ty * 4);
      const float4 yb = *reinterpret_cast<const float4*>(ys + p * kWPad + tx * 4);
      const float xv[4] = {xa.x, xa.y, xa.z, xa.w};
      const float yv[4] = {yb.x, yb.y, yb.z, yb.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xv[a], yv[b], acc[a][b]);
      }
    }
    __syncthreads();
  }

  float* out = partial + static_cast<long long>(blockIdx.y) * kParams;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int o = o0 + tx * 4 + b;
      if (i < job.in_dim && o < job.out_dim) out[job.w_off + i * job.out_dim + o] = acc[a][b];
    }
  }
  if (bias_block) out[job.b_off + o0 + threadIdx.x] = bsum;
}

// Backward 3: grad[e] = sum over chunks c, in order, of partial[c][e].
__global__ void train_bwd_reduce_kernel(const float* __restrict__ partial, int n_chunks,
                                        float* __restrict__ grad) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kParams) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += partial[static_cast<long long>(c) * kParams + e];
  grad[e] = s;
}

// Backward 4: ddc[r][c] = sum over s of dhd at point r * samples + s.
__global__ void train_bwd_ddc_kernel(const float* __restrict__ delta, long long n_rays,
                                     int samples, float* __restrict__ ddc) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_rays * kDirHidden) return;
  const long long r = idx / kDirHidden;
  const int c = static_cast<int>(idx % kDirHidden);
  float s = 0.f;
  for (int k = 0; k < samples; ++k) {
    const long long q = r * samples + k;
    s += delta[((q / kTile) * kDRows + kDHd + c) * kTile + q % kTile];
  }
  ddc[idx] = s;
}

template <bool kBf16>
cudaError_t launch_fwd(const float* pts, const float* dc, const float* params, float* out,
                       void* res, long long n_points, int samples, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(train_fwd_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kFwdSmem));
  if (err != cudaSuccess) return err;
  const long long tiles = (n_points + kTile - 1) / kTile;
  train_fwd_kernel<kBf16><<<static_cast<unsigned int>(tiles), kThreads, kFwdSmem, stream>>>(
      pts, dc, params, out, static_cast<Res<kBf16>*>(res), n_points, samples);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_bwd(const float* g, const void* res, const float* wt, float* delta,
                       float* partial, float* grad, float* ddc, long long n_points,
                       int samples, cudaStream_t stream) {
  const long long tiles = (n_points + kTile - 1) / kTile;
  const long long chunks = (tiles + kTilesPerChunk - 1) / kTilesPerChunk;
  const Res<kBf16>* r = static_cast<const Res<kBf16>*>(res);
  cudaError_t err = cudaFuncSetAttribute(train_bwd_act_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kActSmem));
  if (err != cudaSuccess) return err;
  train_bwd_act_kernel<kBf16><<<static_cast<unsigned int>(tiles), kThreads, kActSmem,
                                stream>>>(g, r, wt, delta, n_points);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  train_bwd_wgrad_kernel<kBf16><<<dim3(kNumWTiles, static_cast<unsigned int>(chunks)),
                                  kWThreads, 0, stream>>>(r, delta, partial, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  train_bwd_reduce_kernel<<<(kParams + 255) / 256, 256, 0, stream>>>(
      partial, static_cast<int>(chunks), grad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_rays = n_points / samples;
  const long long threads = n_rays * kDirHidden;
  train_bwd_ddc_kernel<<<static_cast<unsigned int>((threads + 255) / 256), 256, 0, stream>>>(
      delta, n_rays, samples, ddc);
  return cudaGetLastError();
}

bool bad_shape(long long n_points, int samples) {
  const long long tiles = (n_points + kTile - 1) / kTile;
  return samples <= 0 || n_points <= 0 || n_points % samples != 0 || tiles > 0x7fffffffLL ||
         (tiles + kTilesPerChunk - 1) / kTilesPerChunk > 65535 ||
         (n_points / samples * kDirHidden + 255) / 256 > 0x7fffffffLL;
}

}  // namespace

// The layout the Python wrapper allocates for: {rows of residuals per point,
// rows of f32 deltas per point, floats of the packed forward parameters, of
// the packed backward weights, points per tile, point tiles per chunk}.
extern "C" void nerf_flex_train_layout(int* out) {
  out[0] = kResRows;
  out[1] = kDRows;
  out[2] = kParams;
  out[3] = kTParams;
  out[4] = kTile;
  out[5] = kTilesPerChunk;
}

// pts (n_points, 3), dc (n_points / samples, 64), params (kParams,), out
// (n_points, 4): contiguous f32 device buffers; res: tiles * kResRows * kTile
// elements of the compute dtype (bf16 when bf16 != 0, else f32). Returns a
// cudaError_t.
extern "C" int nerf_flex_train_forward(const float* pts, const float* dc, const float* params,
                                       long long n_params, float* out, void* res,
                                       long long n_points, int samples, int bf16,
                                       void* stream) {
  if (n_params != kParams || bad_shape(n_points, samples)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16 ? launch_fwd<true>(pts, dc, params, out, res, n_points, samples, s)
                               : launch_fwd<false>(pts, dc, params, out, res, n_points, samples, s);
  return static_cast<int>(err);
}

// g (n_points, 4) f32 cotangent; res from the forward; wt (kTParams,) the
// backward weights; scratch: delta (tiles * kDRows * kTile f32) and partial
// (chunks * kParams f32); outputs: grad (kParams,) in the packed parameter
// layout and ddc (n_points / samples, 64). Returns a cudaError_t.
extern "C" int nerf_flex_train_backward(const float* g, const void* res, const float* wt,
                                        long long n_wt, float* delta, float* partial,
                                        float* grad, float* ddc, long long n_points,
                                        int samples, int bf16, void* stream) {
  if (n_wt != kTParams || bad_shape(n_points, samples)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_bwd<true>(g, res, wt, delta, partial, grad, ddc, n_points, samples, s)
           : launch_bwd<false>(g, res, wt, delta, partial, grad, ddc, n_points, samples, s);
  return static_cast<int>(err);
}
