// Fused PaperNeRF (8x256) training kernels for Hopper (sm_90a): a forward
// that saves the residuals, and a backward that gives every parameter
// gradient and the per-ray direction-contribution gradient.
//
// Replaces nerf_tpu/ops/pallas/paper_train.py:fused_paper_mlp_train, the
// custom-VJP pair that nerf_tpu/ops/pallas/train_vjp.py:build_train_vjp
// builds (pallas_call at train_vjp.py:197, forward, and :241, backward).
// Same function at the public layout:
//   forward:  pts (N, S, 3) f32 + dc = enc(viewdirs) @ W_dir[256:] (N, 128) f32
//             -> raw (N, S, 4) f32 [r, g, b, sigma], plus residuals in the
//             compute dtype: enc, h0..h7 (post-ReLU trunk), feat (not
//             ReLU'd) and d0..d2 (post-ReLU direction branch), 2,751 values
//             a point at F = 10;
//   backward: cotangent (N, S, 4) f32 + residuals -> the gradient of the
//             packed parameter buffer (paper_mlp.cuh's layout) and ddc
//             (N, 128). layers_dir[3] is not in the buffer (the wrapper's
//             autograd leaves its gradient at zero); pts and viewdirs get no
//             gradient (training data), as on the TPU.
//
// What bounds it on the card: arithmetic. A point costs 622,720
// multiply-adds forward and ~1.2M backward (~0.6M to carry the gradient back
// through the layers, ~0.6M for the weight gradients) at F = 10, against
// ~5.5 KB (bf16) or ~11 KB (f32) of residuals and ~10.8 KB of f32 deltas
// moved through device memory: far above the memory roofline. At 1024 x 128
// points the f32 FMA peak (67 TFLOP/s) bounds the forward at 2.4 ms and the
// backward at ~4.9 ms. The first design runs f32 FMAs from registers and
// shared memory; tensor cores (wgmma) are later work.
//
// Design (right and simple first), PR 2's FlexibleNeRF design widened:
//   * forward: paper_t.cu's evaluation (paper_mlp.cuh's forward_tile), one
//     block of 256 threads per tile of 64 points, given a residual buffer, so
//     it also copies each layer's tile from shared memory into
//     res[tile][row][point], coalesced;
//   * backward, four launches on one stream:
//     1. train_bwd_act: per 64-point tile, carries the cotangent back through
//        fc_rgb, layers_dir.2, .1, the fused [layers_dir.0 feat rows;
//        fc_alpha] head (one 129-deep contraction that joins at feat, since
//        sigma reads feat), fc_feat and the trunk down to layer 0's output
//        (the skip layer sends gradient to h3 only, through W4[dim:]; enc is
//        data). ReLU masks compare the stored (compute-dtype) activation with
//        0; feat has no mask. Every layer's output gradient is written, f32
//        and unrounded, to delta[tile][row][point], and rounded over the
//        tile's shared buffer as the next product's operand;
//     2. train_bwd_wgrad: dW = X^T dY and db = sum dY for the 15 weight
//        blocks (layer 4's enc rows and h rows are two), as one launch over
//        (64 x 64 output tile, chunk of 32 point tiles). Each block keeps its
//        partial sums in registers and writes them to its chunk's row of a
//        scratch buffer laid out like the packed parameters;
//     3. train_bwd_reduce: sums the chunks' rows in a fixed order. No atomics:
//        two identical calls give bitwise-equal gradients;
//     4. train_bwd_ddc: ddc[ray] = sum over the ray's samples of layers_dir.0's
//        output gradient, one thread per (ray, feature), so rays that
//        straddle tiles are summed whole.
//   * the backward reads the weights as nn.Linear's (out, in) matrices from a
//     second packed buffer (kT* offsets below), so that neighbouring threads
//     read neighbouring weights when they compute neighbouring input
//     features.
//
// compute dtype bf16: both operands of every product (forward, dX = dY W^T
// and dW = X^T dY) are rounded to bf16 and the sums stay f32, as
// preferred_element_type=f32 does on the TPU; residuals are stored in bf16.
// Bias gradients and ddc sum the unrounded f32 deltas. (The TPU kernel sums
// its bias gradients with a ones-row dot at DEFAULT precision, which on the
// TPU rounds dY to bf16 and on the CPU does not; the port keeps f32 sums.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "paper_mlp.cuh"

namespace {

using namespace paper;

// Delta rows (f32) of a point: the cotangent, then the gradient of each
// layer's output (masked by its ReLU where it has one).
constexpr int kDRgb = 0;                          // drgb (3)
constexpr int kDSig = 3;                          // dsigma (1)
constexpr int kDD2 = 4;                           // dd2, dd1, dd0 (128 each)
constexpr int kDD1 = kDD2 + kDirWidth;
constexpr int kDD0 = kDD1 + kDirWidth;
constexpr int kDFeat = kDD0 + kDirWidth;          // dfeat (256), unmasked
constexpr int kDZ7 = kDFeat + kWidth;             // dz7 .. dz0 (256 each)
__host__ __device__ constexpr int d_z(int i) { return kDZ7 + kWidth * (7 - i); }
constexpr int kDRows = d_z(0) + kWidth;           // 2692

// Backward weights, each nn.Linear's (out, in) row-major matrix.
constexpr int kTWr = 0;                                        // fc_rgb (3, 128)
constexpr int kTWd2 = kTWr + 3 * kDirWidth;                    // layers_dir.2 (128, 128)
constexpr int kTWd1 = kTWd2 + kDirWidth * kDirWidth;           // layers_dir.1
constexpr int kTWda = kTWd1 + kDirWidth * kDirWidth;           // [layers_dir.0 feat cols (128, 256); fc_alpha (1, 256)]
constexpr int kTWf = kTWda + (kDirWidth + 1) * kWidth;         // fc_feat (256, 256)
__host__ __device__ constexpr int tw_x(int i) {                // layers_xyz.7 .. .1 (layer 4: its h cols)
  return kTWf + kWidth * kWidth * (8 - i);
}
constexpr int kTParams = tw_x(1) + kWidth * kWidth;            // 590464

constexpr size_t kActSmem = kWidth * kTile * sizeof(float);

// Weight-gradient tiling.
constexpr int kWTile = 64;            // output tile: 64 inputs x 64 outputs
constexpr int kWThreads = 256;        // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTilesPerChunk = 32;    // point tiles summed by one block
constexpr int kWPad = kWTile + 4;     // shared row length (float4-aligned)

template <bool kBf16>
using Res = std::conditional_t<kBf16, __nv_bfloat16, float>;

// ---------------------------------------------------------------------------
// Forward: paper_t's evaluation, saving every residual.

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
train_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ dc,
                 const float* __restrict__ params, const Layout L, float* __restrict__ out,
                 Res<kBf16>* __restrict__ res, long long n_points, int samples, int num_freq) {
  extern __shared__ float4 smem[];
  float* enc = reinterpret_cast<float*>(smem);
  forward_tile<kBf16, Res<kBf16>>(pts, dc, params, L, out, res, n_points, samples, num_freq, enc,
                                  enc + L.dim * kTile);
}

// ---------------------------------------------------------------------------
// Backward 1: the gradient of every layer's output, per tile.

// dX = mask(stored activation > 0) * acc, written unrounded to the tile's
// delta rows (f32) and, unless act is null, rounded over the shared tile
// buffer as the next product's operand. mask_rows null = no mask.
template <int OUT, bool kBf16>
__device__ __forceinline__ void store_grad(Acc<OUT>& a, const Res<kBf16>* __restrict__ mask_rows,
                                           float* __restrict__ delta_rows, float* act) {
  constexpr int kRun = Acc<OUT>::kRun;
  if (mask_rows != nullptr) {
#pragma unroll
    for (int f = 0; f < kTF; ++f) {
      const Res<kBf16>* m = mask_rows + (a.j0 + f) * kTile + a.p0;
#pragma unroll
      for (int p = 0; p < kRun; ++p) a.v[f][p] = load(m + p) > 0.f ? a.v[f][p] : 0.f;
    }
  }
#pragma unroll
  for (int f = 0; f < kTF; ++f) {
    float4* d = reinterpret_cast<float4*>(delta_rows + (a.j0 + f) * kTile + a.p0);
#pragma unroll
    for (int q = 0; q < kRun / 4; ++q) {
      d[q] = make_float4(a.v[f][4 * q], a.v[f][4 * q + 1], a.v[f][4 * q + 2], a.v[f][4 * q + 3]);
    }
  }
  if (act != nullptr) a.template write<kBf16>(act);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
train_bwd_act_kernel(const float* __restrict__ g, const Res<kBf16>* __restrict__ res,
                     const float* __restrict__ wt, float* __restrict__ delta, long long n_points,
                     int dim) {
  extern __shared__ float4 smem[];
  float* act = reinterpret_cast<float*>(smem);   // 256 rows
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const Res<kBf16>* rt = res + static_cast<long long>(blockIdx.x) * res_rows(dim) * kTile;
  float* dt = delta + static_cast<long long>(blockIdx.x) * kDRows * kTile;
  auto rrow = [rt](int r) { return rt + r * kTile; };
  auto drow = [dt](int r) { return dt + r * kTile; };

  // Cotangent: drgb into act rows 0..2, dsigma into row 128 (the fused
  // head's extra row, which the 128-wide direction layers leave alone);
  // padded points get 0, so they add nothing anywhere.
  if (threadIdx.x < kTile) {
    const int p = threadIdx.x;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tile0 + p < n_points) v = reinterpret_cast<const float4*>(g)[tile0 + p];
    act[0 * kTile + p] = rnd<kBf16>(v.x);
    act[1 * kTile + p] = rnd<kBf16>(v.y);
    act[2 * kTile + p] = rnd<kBf16>(v.z);
    act[kDirWidth * kTile + p] = rnd<kBf16>(v.w);
    dt[(kDRgb + 0) * kTile + p] = v.x;
    dt[(kDRgb + 1) * kTile + p] = v.y;
    dt[(kDRgb + 2) * kTile + p] = v.z;
    dt[kDSig * kTile + p] = v.w;
  }
  __syncthreads();
  {  // dd2 = mask(d2) * drgb W_rgb
    Acc<kDirWidth> a;
    a.mac<kBf16>(wt + kTWr, 3, act);
    store_grad<kDirWidth, kBf16>(a, rrow(res_d(dim, 2)), drow(kDD2), act);
  }
  {  // dd1 = mask(d1) * dd2 W_d2
    Acc<kDirWidth> a;
    a.mac<kBf16>(wt + kTWd2, kDirWidth, act);
    store_grad<kDirWidth, kBf16>(a, rrow(res_d(dim, 1)), drow(kDD1), act);
  }
  {  // dd0 = mask(d0) * dd1 W_d1
    Acc<kDirWidth> a;
    a.mac<kBf16>(wt + kTWd1, kDirWidth, act);
    store_grad<kDirWidth, kBf16>(a, rrow(res_d(dim, 0)), drow(kDD0), act);
  }
  {  // dfeat = [dd0; dsigma] [W_d0 feat cols; W_alpha]; feat has no ReLU
    Acc<kWidth> a;
    a.mac<kBf16>(wt + kTWda, kDirWidth + 1, act);
    store_grad<kWidth, kBf16>(a, nullptr, drow(kDFeat), act);
  }
  {  // dz7 = mask(h7) * dfeat W_feat
    Acc<kWidth> a;
    a.mac<kBf16>(wt + kTWf, kWidth, act);
    store_grad<kWidth, kBf16>(a, rrow(res_h(dim, 7)), drow(d_z(7)), act);
  }
  // dz_{i-1} = mask(h_{i-1}) * dz_i W_i (layer 4: its h columns only).
  for (int i = 7; i >= 1; --i) {
    Acc<kWidth> a;
    a.mac<kBf16>(wt + tw_x(i), kWidth, act);
    store_grad<kWidth, kBf16>(a, rrow(res_h(dim, i - 1)), drow(d_z(i - 1)),
                              i > 1 ? act : nullptr);
  }
}

// ---------------------------------------------------------------------------
// Backward 2: weight and bias gradients, partial sums per chunk of tiles.

struct WJob {
  int x_row, in_dim;    // residual rows X
  int d_row, out_dim;   // delta rows dY
  int w_off, b_off;     // where dW (in, out) and db go in the packed layout (b_off -1: none)
  int first_tile;       // index of the job's first 64 x 64 output tile
};

constexpr int kMaxJobs = 16;
struct WJobs {
  WJob job[kMaxJobs];
  int n_jobs, n_wtiles;
};

WJobs make_jobs(const Layout& L) {
  const int dim = L.dim;
  WJobs t{};
  int n = 0, tiles = 0;
  auto add = [&](int x_row, int in_dim, int d_row, int out_dim, int w_off, int b_off) {
    t.job[n++] = {x_row, in_dim, d_row, out_dim, w_off, b_off, tiles};
    tiles += ((in_dim + kWTile - 1) / kWTile) * ((out_dim + kWTile - 1) / kWTile);
  };
  add(res_d(dim, 2), kDirWidth, kDRgb, 3, L.wr, L.br);                  // fc_rgb
  add(res_d(dim, 1), kDirWidth, kDD2, kDirWidth, L.wd[2], L.bd[2]);     // layers_dir.2
  add(res_d(dim, 0), kDirWidth, kDD1, kDirWidth, L.wd[1], L.bd[1]);     // layers_dir.1
  add(res_feat(dim), kWidth, kDD0, kDirWidth, L.wd[0], L.bd[0]);        // layers_dir.0 feat rows
  add(res_feat(dim), kWidth, kDSig, 1, L.wa, L.ba);                     // fc_alpha
  add(res_h(dim, 7), kWidth, kDFeat, kWidth, L.wf, L.bf);               // fc_feat
  for (int i = 7; i >= 5; --i) {
    add(res_h(dim, i - 1), kWidth, d_z(i), kWidth, L.w[i], L.b[i]);     // layers_xyz.7 .. .5
  }
  add(0, dim, d_z(4), kWidth, L.w[4], L.b[4]);                          // layers_xyz.4 enc rows
  add(res_h(dim, 3), kWidth, d_z(4), kWidth, L.w[4] + dim * kWidth, -1);  // .4 h rows
  for (int i = 3; i >= 1; --i) {
    add(res_h(dim, i - 1), kWidth, d_z(i), kWidth, L.w[i], L.b[i]);     // layers_xyz.3 .. .1
  }
  add(0, dim, d_z(0), kWidth, L.w[0], L.b[0]);                          // layers_xyz.0
  t.n_jobs = n;
  t.n_wtiles = tiles;
  return t;
}

template <bool kBf16>
__global__ void __launch_bounds__(kWThreads)
train_bwd_wgrad_kernel(const Res<kBf16>* __restrict__ res, const float* __restrict__ delta,
                       float* __restrict__ partial, long long n_tiles, int dim, int n_params,
                       const __grid_constant__ WJobs jobs) {
  __shared__ __align__(16) float xs[kTile * kWPad];   // xs[p][i]
  __shared__ __align__(16) float ys[kTile * kWPad];   // ys[p][o], rounded

  int jb = 0;
  while (jb + 1 < jobs.n_jobs && jobs.job[jb + 1].first_tile <= static_cast<int>(blockIdx.x)) ++jb;
  const WJob job = jobs.job[jb];
  const int o_tiles = (job.out_dim + kWTile - 1) / kWTile;
  const int local = blockIdx.x - job.first_tile;
  const int i0 = (local / o_tiles) * kWTile;
  const int o0 = (local % o_tiles) * kWTile;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const bool bias_block = job.b_off >= 0 && i0 == 0 && threadIdx.x < kWTile &&
                          o0 + threadIdx.x < job.out_dim;
  const int rows = res_rows(dim);

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
    const Res<kBf16>* xt = res + (t * rows + job.x_row) * kTile;
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

  float* out = partial + static_cast<long long>(blockIdx.y) * n_params;
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
  // The layout pads a short bias (fc_alpha's 1, fc_rgb's 3) to 4 floats:
  // give the pad a zero so the reduced gradient is defined everywhere.
  const int o_pad = o0 + static_cast<int>(threadIdx.x);
  if (job.b_off >= 0 && i0 == 0 && threadIdx.x < kWTile && o_pad >= job.out_dim &&
      o_pad < pad4(job.out_dim)) {
    out[job.b_off + o_pad] = 0.f;
  }
}

// Backward 3: grad[e] = sum over chunks c, in order, of partial[c][e].
__global__ void train_bwd_reduce_kernel(const float* __restrict__ partial, int n_chunks,
                                        int n_params, float* __restrict__ grad) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_params) return;
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += partial[static_cast<long long>(c) * n_params + e];
  grad[e] = s;
}

// Backward 4: ddc[r][c] = sum over s of dd0 at point r * samples + s.
__global__ void train_bwd_ddc_kernel(const float* __restrict__ delta, long long n_rays,
                                     int samples, float* __restrict__ ddc) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_rays * kDirWidth) return;
  const long long r = idx / kDirWidth;
  const int c = static_cast<int>(idx % kDirWidth);
  float s = 0.f;
  for (int k = 0; k < samples; ++k) {
    const long long q = r * samples + k;
    s += delta[((q / kTile) * kDRows + kDD0 + c) * kTile + q % kTile];
  }
  ddc[idx] = s;
}

template <bool kBf16>
cudaError_t launch_fwd(const float* pts, const float* dc, const float* params, const Layout& L,
                       float* out, void* res, long long n_points, int samples, int num_freq,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(train_fwd_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = (n_points + kTile - 1) / kTile;
  train_fwd_kernel<kBf16><<<static_cast<unsigned int>(tiles), kThreads, smem, stream>>>(
      pts, dc, params, L, out, static_cast<Res<kBf16>*>(res), n_points, samples, num_freq);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_bwd(const float* g, const void* res, const float* wt, const Layout& L,
                       float* delta, float* partial, float* grad, float* ddc, long long n_points,
                       int samples, cudaStream_t stream) {
  const long long tiles = (n_points + kTile - 1) / kTile;
  const long long chunks = (tiles + kTilesPerChunk - 1) / kTilesPerChunk;
  const Res<kBf16>* r = static_cast<const Res<kBf16>*>(res);
  cudaError_t err = cudaFuncSetAttribute(train_bwd_act_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kActSmem));
  if (err != cudaSuccess) return err;
  train_bwd_act_kernel<kBf16><<<static_cast<unsigned int>(tiles), kThreads, kActSmem, stream>>>(
      g, r, wt, delta, n_points, L.dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const WJobs jobs = make_jobs(L);
  train_bwd_wgrad_kernel<kBf16><<<dim3(jobs.n_wtiles, static_cast<unsigned int>(chunks)),
                                  kWThreads, 0, stream>>>(r, delta, partial, tiles, L.dim,
                                                          L.total, jobs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  train_bwd_reduce_kernel<<<(L.total + 255) / 256, 256, 0, stream>>>(
      partial, static_cast<int>(chunks), L.total, grad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_rays = n_points / samples;
  const long long threads = n_rays * kDirWidth;
  train_bwd_ddc_kernel<<<static_cast<unsigned int>((threads + 255) / 256), 256, 0, stream>>>(
      delta, n_rays, samples, ddc);
  return cudaGetLastError();
}

bool bad_shape(long long n_points, int samples, int num_freq) {
  const long long tiles = (n_points + kTile - 1) / kTile;
  return num_freq < 0 || num_freq > kMaxFreq || samples <= 0 || n_points <= 0 ||
         n_points % samples != 0 || tiles > 0x7fffffffLL ||
         (tiles + kTilesPerChunk - 1) / kTilesPerChunk > 65535 ||
         (n_points / samples * kDirWidth + 255) / 256 > 0x7fffffffLL;
}

}  // namespace

// The layout the Python wrapper allocates for, at encoding depth num_freq:
// {rows of residuals per point, rows of f32 deltas per point, floats of the
// packed forward parameters, of the packed backward weights, points per
// tile, point tiles per chunk}.
extern "C" void nerf_paper_train_layout(int num_freq, int* out) {
  const Layout L = make_layout(num_freq);
  out[0] = res_rows(L.dim);
  out[1] = kDRows;
  out[2] = L.total;
  out[3] = kTParams;
  out[4] = kTile;
  out[5] = kTilesPerChunk;
}

// pts (n_points, 3), dc (n_points / samples, 128), params (packed, see
// nerf_paper_train_layout), out (n_points, 4): contiguous f32 device
// buffers, dc and params 16-byte aligned; res: tiles * res_rows * kTile
// elements of the compute dtype (bf16 when bf16 != 0, else f32). Returns a
// cudaError_t.
extern "C" int nerf_paper_train_forward(const float* pts, const float* dc, const float* params,
                                        long long n_params, float* out, void* res,
                                        long long n_points, int samples, int num_freq, int bf16,
                                        void* stream) {
  if (bad_shape(n_points, samples, num_freq)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = make_layout(num_freq);
  if (n_params != L.total) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_fwd<true>(pts, dc, params, L, out, res, n_points, samples, num_freq, s)
           : launch_fwd<false>(pts, dc, params, L, out, res, n_points, samples, num_freq, s);
  return static_cast<int>(err);
}

// g (n_points, 4) f32 cotangent; res from the forward; wt (kTParams,) the
// backward weights; scratch: delta (tiles * kDRows * kTile f32) and partial
// (chunks * n_params f32); outputs: grad (n_params,) in the packed parameter
// layout and ddc (n_points / samples, 128). Returns a cudaError_t.
extern "C" int nerf_paper_train_backward(const float* g, const void* res, const float* wt,
                                         long long n_wt, float* delta, float* partial,
                                         float* grad, float* ddc, long long n_points,
                                         int samples, int num_freq, int bf16, void* stream) {
  if (n_wt != kTParams || bad_shape(n_points, samples, num_freq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout L = make_layout(num_freq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_bwd<true>(g, res, wt, L, delta, partial, grad, ddc, n_points, samples, s)
           : launch_bwd<false>(g, res, wt, L, delta, partial, grad, ddc, n_points, samples, s);
  return static_cast<int>(err);
}
