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
// What bounds it on the card: in f32, arithmetic. A point costs 622,720
// multiply-adds forward and ~1.2M backward (~0.6M to carry the gradient back
// through the layers, ~0.6M for the weight gradients) at F = 10, against
// ~5.5 KB (bf16) or ~11 KB (f32) of residuals and ~10.8 KB of f32 deltas
// moved through device memory. At 1024 x 128 points the f32 FMA peak (67
// TFLOP/s) bounds the forward at 2.4 ms and the backward at ~4.7 ms; on an
// H100 80GB HBM3 at 700 W the f32 instances take ~3.8 and ~8.9 ms. On the
// bf16 tensor cores (989 TFLOP/s) the arithmetic takes 0.17 + 0.33 ms, and
// the bytes set the pace: the forward's 0.72 GB of residual writes (0.22 ms
// at 3.35 TB/s), and the backward's 1.41 GB of f32 deltas, written by the
// layer-gradient pass and read, with the 0.7 GB of residuals, by the
// weight-gradient pass. That pass is bound by those reads (17.1 GB, 5.1 ms,
// at paper_train's 4096 x (64 + 192) points a step) and runs on wgmma in
// wgrad_wg.cuh at ~80% of that bound.
//
// The f32 instances run on the FMA pipes (paper_mlp.cuh's register-blocked
// dense layer, and fma_wgrad.cuh's weight-gradient pass, which the 4x128
// field's shares); the bf16 instances run the same passes on the tensor
// cores, bf16 operands and f32 sums, with the tile, the residuals and the
// deltas point-major: the forward and the layer gradients on paper_tc.cuh's
// mma.sync m16n8k16 tile, with bf16 weights the wrapper prepares in fragment
// order (kernels/paper_t.py images(f)), the weight gradients on
// wgrad_wg.cuh's wgmma body:
//   * forward: paper_t.cu's evaluation (paper_mlp.cuh's or paper_tc.cuh's
//     forward_tile), one block of 256 threads per tile of 64 points, given a
//     residual buffer, so it also writes each layer's tile to
//     res[tile][row][point] (f32, from the registers that hold it) or
//     res[point][row] (bf16, copied from shared memory), coalesced;
//   * backward, four launches on one stream:
//     1. train_bwd_act: per 64-point tile, carries the cotangent back through
//        fc_rgb, layers_dir.2, .1, the fused [layers_dir.0 feat rows;
//        fc_alpha] head (one 129-deep contraction that joins at feat, since
//        sigma reads feat), fc_feat and the trunk down to layer 0's output
//        (the skip layer sends gradient to h3 only, through W4[dim:]; enc is
//        data). ReLU masks compare the stored (compute-dtype) activation with
//        0; feat has no mask. Every layer's output gradient is written, f32
//        and unrounded, to the delta rows (delta[tile][row][point] in f32,
//        delta[point][row] in bf16), and over the tile's shared buffer
//        (rounded, in bf16) as the next product's operand. The f32 instance
//        runs paper_mlp.cuh's dense layer over the backward weights, staged
//        through its ring; the bf16 instance runs the fused head and
//        drgb . W_rgb as padded products (K 129 -> 144 and 3 -> 16);
//     2. train_bwd_wgrad: dW = X^T dY and db = sum dY for the 15 weight
//        blocks (layer 4's enc rows and h rows are two), each summed per
//        chunk of 32 point tiles into that chunk's row of a work buffer
//        laid out like the packed parameters. f32: one launch over (128 x
//        128 output tile, chunk), on the FMA pipes (fma_wgrad.cuh: 8 x 8
//        outputs a thread, X and dY staged by cp.async two stages deep).
//        bf16: one persistent block an SM on wgmma (wgrad_wg.cuh): tensor
//        copies stream the residual and delta rows point-major through a
//        ring, a converter warpgroup rounds dY to bf16 and sums the biases,
//        two consumer warpgroups keep each 256 x 128 output tile in
//        registers over the chunk; bitwise the mma.sync tile it replaced;
//     3. train_bwd_reduce: sums the chunks' rows in a fixed order. No atomics:
//        two identical calls give bitwise-equal gradients;
//     4. train_bwd_ddc: ddc[ray] = sum over the ray's samples of layers_dir.0's
//        output gradient, one thread per (ray, feature), so rays that
//        straddle tiles are summed whole.
//   * the f32 backward reads the weights as nn.Linear's (out, in) matrices
//     from a second packed buffer (kT* offsets below): as (K, OUT) matrices,
//     K the forward layer's outputs, the forward's dense layer takes them
//     as they are; the bf16 one reads their fragments (paper_tc.cuh kB*).
//
// compute dtype bf16: both operands of every product (forward, dX = dY W^T
// and dW = X^T dY) are rounded to bf16 and the sums stay f32, as
// preferred_element_type=f32 does on the TPU; residuals are stored in bf16.
// Bias gradients and ddc sum the unrounded f32 deltas. (The TPU kernel sums
// its bias gradients with a ones-row dot at DEFAULT precision, which on the
// TPU rounds dY to bf16 and on the CPU does not; the port keeps f32 sums.)
//
// Scenes (scenes.cuh): every launch takes a count of scenes of one shape,
// each with its own inputs, parameters, residuals and outputs, as the
// scene-vmapped multi-scene step gives them; the scene is each grid's
// slowest axis and a scene's blocks do what a single-scene launch's do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "fma_wgrad.cuh"
#include "paper_mlp.cuh"
#include "paper_tc.cuh"
#include "scenes.cuh"
#include "wgrad_wg.cuh"

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

// Dynamic shared memory of the f32 layer-gradient pass: the 256-row tile
// buffer and the weight ring (96 KB, two blocks an SM).
constexpr size_t kBwdSmem = (kActFloats + 2 * kSlotFloats) * sizeof(float);

// Weight-gradient tiling: a block sums a 128 x 128 output tile (f32:
// fma_wgrad.cuh's, 8 x 8 outputs a thread) over a chunk of point tiles.
constexpr int kWTile = wgrad::kWTile;
constexpr int kWThreads = wgrad::kThreads;
constexpr int kTilesPerChunk = 32;    // point tiles summed by one block
static_assert(wgrad::kTile == kTile && wgrad_wg::kTile == kTile,
              "fma_wgrad.cuh and wgrad_wg.cuh tile points as the kernels do");

using bf16 = __nv_bfloat16;

template <bool kBf16>
using Res = std::conditional_t<kBf16, bf16, float>;

// ---------------------------------------------------------------------------
// Forward: paper_t's evaluation, saving every residual.

// Tile blockIdx.x of scene sc.
template <bool kBf16>
__device__ __forceinline__ void train_fwd_scene(const float* pts, const float* dc,
                                                const float* params, const bf16* wbf,
                                                const Layout& L, const tc::FwdLayout& T,
                                                float* out, Res<kBf16>* res, long long n_points,
                                                int samples, int num_freq,
                                                const scenes::Strides& st, unsigned int sc) {
  using scenes::at;
  extern __shared__ float4 smem[];
  pts = at(pts, st.pts, sc);
  dc = at(dc, st.dc, sc);
  params = at(params, st.params, sc);
  wbf = at(wbf, st.wbf, sc);
  out = at(out, st.out, sc);
  res = at(res, st.res, sc);
  if constexpr (kBf16) {
    auto* enc = reinterpret_cast<bf16*>(smem);
    tc::forward_tile(pts, dc, params, wbf, L, T, out, res, n_points, samples, num_freq, enc,
                     enc + tc::enc_stride(L.dim) * kTile);
  } else {
    forward_tile(pts, dc, params, L, out, res, n_points, samples, num_freq,
                 reinterpret_cast<float*>(smem));
  }
}

// Tile blockIdx.x of scene blockIdx.y.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
train_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ dc,
                 const float* __restrict__ params, const bf16* __restrict__ wbf, const Layout L,
                 const tc::FwdLayout T, float* __restrict__ out, Res<kBf16>* __restrict__ res,
                 long long n_points, int samples, int num_freq, const scenes::Strides st) {
  train_fwd_scene<kBf16>(pts, dc, params, wbf, L, T, out, res, n_points, samples, num_freq, st,
                         blockIdx.y);
}

// One scene, without the scene's offsets (st unused): the f32 forward runs
// it at S = 1, where train_fwd_kernel<0> takes 4% longer. Only the f32
// instance is launched.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
train_fwd_one_kernel(const float* __restrict__ pts, const float* __restrict__ dc,
                     const float* __restrict__ params, const bf16* __restrict__ wbf,
                     const Layout L, const tc::FwdLayout T, float* __restrict__ out,
                     Res<kBf16>* __restrict__ res, long long n_points, int samples, int num_freq,
                     const scenes::Strides st) {
  train_fwd_scene<kBf16>(pts, dc, params, wbf, L, T, out, res, n_points, samples, num_freq,
                         scenes::Strides{}, 0u);
}

// ---------------------------------------------------------------------------
// Backward 1: the gradient of every layer's output, per tile.

// The f32 instance: dX = mask(stored activation > 0) * the thread's block,
// written to the tile's delta rows and, unless act is null, over the shared
// tile buffer as the next product's operand (the sum ended with a barrier
// after its last read of it). mask_rows null = no mask.
template <int OUT>
__device__ __forceinline__ void store_grad(Block<OUT>& blk, const float* __restrict__ mask_rows,
                                           float* __restrict__ delta_rows, float* act) {
  constexpr int kTF = OUT / 32;
  if (mask_rows != nullptr) {
#pragma unroll
    for (int f = 0; f < kTF; ++f) {
      const float* m = mask_rows + (Block<OUT>::j0() + f) * kTile + Block<OUT>::p0();
      const float4 m0 = *reinterpret_cast<const float4*>(m);
      const float4 m1 = *reinterpret_cast<const float4*>(m + 32);
      const float mk[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
      for (int q = 0; q < 8; ++q) blk.v[f][q] = mk[q] > 0.f ? blk.v[f][q] : 0.f;
    }
  }
#pragma unroll
  for (int f = 0; f < kTF; ++f) {
    blk.store(delta_rows, f);
    if (act != nullptr) blk.store(act, f);
  }
}

// The bf16 instance: dX = mask(stored activation > 0) * acc, written
// unrounded to the point's delta rows (f32, point-major) and, unless act is
// null, rounded over the shared tile as the next product's operand.
// mask null = no mask.
template <int NT>
__device__ __forceinline__ void store_grad_tc(tc::Acc<NT>& a, const bf16* __restrict__ mask,
                                              int rows, float* __restrict__ drow, bf16* act) {
  const int lane = threadIdx.x & 31;
  const int n0 = (threadIdx.x >> 5) * 8 * NT + 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = 16 * m + (lane >> 2) + 8 * h;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float y0 = a.v[m][n][2 * h];
        float y1 = a.v[m][n][2 * h + 1];
        if (mask != nullptr) {
          const float2 mk = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              mask + static_cast<long long>(p) * rows + n0 + 8 * n));
          y0 = mk.x > 0.f ? y0 : 0.f;
          y1 = mk.y > 0.f ? y1 : 0.f;
          a.v[m][n][2 * h] = y0;
          a.v[m][n][2 * h + 1] = y1;
        }
        *reinterpret_cast<float2*>(drow + static_cast<long long>(p) * kDRows + n0 + 8 * n) =
            make_float2(y0, y1);
      }
    }
  }
  if (act != nullptr) a.write(act);
}

__device__ __forceinline__ void bwd_act_tile_tc(const float* __restrict__ g,
                                                const bf16* __restrict__ res,
                                                const bf16* __restrict__ w,
                                                float* __restrict__ delta, long long n_points,
                                                int dim, bf16* act) {
  using tc::kStride;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const int rows = tc::res_rows(dim);
  const bf16* rt = res + tile0 * rows;
  float* dt = delta + tile0 * kDRows;

  // Cotangent: drgb into act columns 0..2 and dsigma into column 128 (the
  // fused head's extra row), the two padded products' K pads (3..15,
  // 129..143) zero; padded points get 0, so they add nothing anywhere.
  if (threadIdx.x < kTile) {
    const int p = threadIdx.x;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tile0 + p < n_points) v = reinterpret_cast<const float4*>(g)[tile0 + p];
    bf16* r = act + p * kStride;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    reinterpret_cast<uint4*>(r)[0] = zero;
    reinterpret_cast<uint4*>(r)[1] = zero;
    reinterpret_cast<uint4*>(r + kDirWidth)[0] = zero;
    reinterpret_cast<uint4*>(r + kDirWidth)[1] = zero;
    r[0] = __float2bfloat16_rn(v.x);
    r[1] = __float2bfloat16_rn(v.y);
    r[2] = __float2bfloat16_rn(v.z);
    r[kDirWidth] = __float2bfloat16_rn(v.w);
    *reinterpret_cast<float4*>(dt + static_cast<long long>(p) * kDRows + kDRgb) = v;
  }
  __syncthreads();
  {  // dd2 = mask(d2) * drgb W_rgb
    tc::Acc<2> a;
    a.mac(w + tc::kBRgb, act, kStride, 1);
    store_grad_tc(a, rt + tc::res_d(dim, 2), rows, dt + kDD2, act);
  }
  {  // dd1 = mask(d1) * dd2 W_d2
    tc::Acc<2> a;
    a.mac(w + tc::kBD2, act, kStride, kDirWidth / 16);
    store_grad_tc(a, rt + tc::res_d(dim, 1), rows, dt + kDD1, act);
  }
  {  // dd0 = mask(d0) * dd1 W_d1
    tc::Acc<2> a;
    a.mac(w + tc::kBD1, act, kStride, kDirWidth / 16);
    store_grad_tc(a, rt + tc::res_d(dim, 0), rows, dt + kDD0, act);
  }
  {  // dfeat = [dd0; dsigma] [W_d0 feat cols; W_alpha]; feat has no ReLU
    tc::Acc<4> a;
    a.mac(w + tc::kBHead, act, kStride, 144 / 16);
    store_grad_tc(a, nullptr, rows, dt + kDFeat, act);
  }
  {  // dz7 = mask(h7) * dfeat W_feat
    tc::Acc<4> a;
    a.mac(w + tc::kBFeat, act, kStride, kWidth / 16);
    store_grad_tc(a, rt + tc::res_h(dim, 7), rows, dt + d_z(7), act);
  }
  // dz_{i-1} = mask(h_{i-1}) * dz_i W_i (layer 4: its h columns only).
  for (int i = 7; i >= 1; --i) {
    tc::Acc<4> a;
    a.mac(w + tc::kbx(i), act, kStride, kWidth / 16);
    store_grad_tc(a, rt + tc::res_h(dim, i - 1), rows, dt + d_z(i - 1), i > 1 ? act : nullptr);
  }
}

// The f32 instance, on paper_mlp.cuh's dense layer: the backward weights
// read as (K, OUT) matrices (K = the forward layer's outputs), staged
// through the ring; smem is kBwdSmem bytes: the 256-row tile buffer, then
// the ring.
__device__ __forceinline__ void bwd_act_tile_fma(const float* __restrict__ g,
                                                 const float* __restrict__ res,
                                                 const float* __restrict__ wt,
                                                 float* __restrict__ delta, long long n_points,
                                                 int dim, float* smem) {
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const float* rt = res + static_cast<long long>(blockIdx.x) * res_rows(dim) * kTile;
  float* dt = delta + static_cast<long long>(blockIdx.x) * kDRows * kTile;
  auto rrow = [rt](int r) { return rt + r * kTile; };
  auto drow = [dt](int r) { return dt + r * kTile; };
  float* act = smem;
  Ring ring{smem + kActFloats, 0};

  // Cotangent: drgb into act rows 0..2, dsigma into row 128 (the fused
  // head's extra row, which the 128-wide direction layers leave alone);
  // padded points get 0, so they add nothing anywhere. fc_rgb's weights
  // land meanwhile; the first sum's barrier publishes both.
  stage_async(ring.slot(0), first_slice<kDirWidth>(wt + kTWr, 3));
  if (threadIdx.x < kTile) {
    const int p = threadIdx.x;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tile0 + p < n_points) v = reinterpret_cast<const float4*>(g)[tile0 + p];
    act[0 * kTile + p] = v.x;
    act[1 * kTile + p] = v.y;
    act[2 * kTile + p] = v.z;
    act[kDirWidth * kTile + p] = v.w;
    dt[(kDRgb + 0) * kTile + p] = v.x;
    dt[(kDRgb + 1) * kTile + p] = v.y;
    dt[(kDRgb + 2) * kTile + p] = v.z;
    dt[kDSig * kTile + p] = v.w;
  }
  {  // dd2 = mask(d2) * drgb W_rgb
    Block<kDirWidth> b;
    dense_sum<kDirWidth>(ring, Rows{wt + kTWr, 3, act}, b,
                         first_slice<kDirWidth>(wt + kTWd2, kDirWidth));
    store_grad<kDirWidth>(b, rrow(res_d(dim, 2)), drow(kDD2), act);
  }
  {  // dd1 = mask(d1) * dd2 W_d2
    Block<kDirWidth> b;
    dense_sum<kDirWidth>(ring, Rows{wt + kTWd2, kDirWidth, act}, b,
                         first_slice<kDirWidth>(wt + kTWd1, kDirWidth));
    store_grad<kDirWidth>(b, rrow(res_d(dim, 1)), drow(kDD1), act);
  }
  {  // dd0 = mask(d0) * dd1 W_d1
    Block<kDirWidth> b;
    dense_sum<kDirWidth>(ring, Rows{wt + kTWd1, kDirWidth, act}, b,
                         first_slice<kWidth>(wt + kTWda, kDirWidth + 1));
    store_grad<kDirWidth>(b, rrow(res_d(dim, 0)), drow(kDD0), act);
  }
  {  // dfeat = [dd0; dsigma] [W_d0 feat cols; W_alpha]; feat has no ReLU
    Block<kWidth> b;
    dense_sum<kWidth>(ring, Rows{wt + kTWda, kDirWidth + 1, act}, b,
                      first_slice<kWidth>(wt + kTWf, kWidth));
    store_grad<kWidth>(b, nullptr, drow(kDFeat), act);
  }
  {  // dz7 = mask(h7) * dfeat W_feat
    Block<kWidth> b;
    dense_sum<kWidth>(ring, Rows{wt + kTWf, kWidth, act}, b,
                      first_slice<kWidth>(wt + tw_x(7), kWidth));
    store_grad<kWidth>(b, rrow(res_h(dim, 7)), drow(d_z(7)), act);
  }
  // dz_{i-1} = mask(h_{i-1}) * dz_i W_i (layer 4: its h columns only).
  for (int i = 7; i >= 1; --i) {
    Block<kWidth> b;
    dense_sum<kWidth>(ring, Rows{wt + tw_x(i), kWidth, act}, b,
                      i > 1 ? first_slice<kWidth>(wt + tw_x(i - 1), kWidth) : Slice{nullptr, 0});
    store_grad<kWidth>(b, rrow(res_h(dim, i - 1)), drow(d_z(i - 1)), i > 1 ? act : nullptr);
  }
}

// Tile blockIdx.x of scene sc.
template <bool kBf16>
__device__ __forceinline__ void bwd_act_scene(const float* g, const Res<kBf16>* res,
                                              const void* weights, float* delta,
                                              long long n_points, int dim,
                                              const scenes::Strides& st, unsigned int sc) {
  using scenes::at;
  extern __shared__ float4 smem[];
  g = at(g, st.g, sc);
  res = at(res, st.res, sc);
  delta = at(delta, st.delta, sc);
  if constexpr (kBf16) {
    bwd_act_tile_tc(g, res, at(static_cast<const bf16*>(weights), st.wt, sc), delta, n_points,
                    dim, reinterpret_cast<bf16*>(smem));
  } else {
    bwd_act_tile_fma(g, res, at(static_cast<const float*>(weights), st.wt, sc), delta,
                     n_points, dim, reinterpret_cast<float*>(smem));
  }
}

// Tile blockIdx.x of scene blockIdx.y.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
train_bwd_act_kernel(const float* __restrict__ g, const Res<kBf16>* __restrict__ res,
                     const void* __restrict__ weights, float* __restrict__ delta,
                     long long n_points, int dim, const scenes::Strides st) {
  bwd_act_scene<kBf16>(g, res, weights, delta, n_points, dim, st, blockIdx.y);
}

// One scene, without the scene's offsets (st unused): the bf16 pass runs it
// at S = 1, where train_bwd_act_kernel<1> spills 8 bytes and takes 1.4%
// longer. Only the bf16 instance is launched.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
train_bwd_act_one_kernel(const float* __restrict__ g, const Res<kBf16>* __restrict__ res,
                         const void* __restrict__ weights, float* __restrict__ delta,
                         long long n_points, int dim, const scenes::Strides st) {
  bwd_act_scene<kBf16>(g, res, weights, delta, n_points, dim, scenes::Strides{}, 0u);
}

// ---------------------------------------------------------------------------
// Backward 2: weight and bias gradients, partial sums per chunk of tiles.

using WJob = wgrad::Job;

constexpr int kMaxJobs = 16;
struct WJobs {
  WJob job[kMaxJobs];
  int n_jobs, n_wtiles;
};

// The weight blocks, their residual rows (the f32 layout, or the bf16 one of
// the tensor-core instance) and, for the f32 instance, their kWTile-square
// output tiles (the bf16 one takes wgrad_wg.cuh's items instead).
WJobs make_jobs(const Layout& L, bool tensor_cores) {
  const int dim = L.dim;
  const int tile = kWTile;
  auto res_h = [&](int i) { return tensor_cores ? tc::res_h(dim, i) : paper::res_h(dim, i); };
  auto res_d = [&](int i) { return tensor_cores ? tc::res_d(dim, i) : paper::res_d(dim, i); };
  const int res_feat = tensor_cores ? tc::res_feat(dim) : paper::res_feat(dim);
  WJobs t{};
  int n = 0, tiles = 0;
  auto add = [&](int x_row, int in_dim, int d_row, int out_dim, int w_off, int b_off) {
    t.job[n++] = {x_row, in_dim, d_row, out_dim, w_off, b_off, tiles};
    tiles += ((in_dim + tile - 1) / tile) * ((out_dim + tile - 1) / tile);
  };
  add(res_d(2), kDirWidth, kDRgb, 3, L.wr, L.br);                       // fc_rgb
  add(res_d(1), kDirWidth, kDD2, kDirWidth, L.wd[2], L.bd[2]);          // layers_dir.2
  add(res_d(0), kDirWidth, kDD1, kDirWidth, L.wd[1], L.bd[1]);          // layers_dir.1
  add(res_feat, kWidth, kDD0, kDirWidth, L.wd[0], L.bd[0]);             // layers_dir.0 feat rows
  add(res_feat, kWidth, kDSig, 1, L.wa, L.ba);                          // fc_alpha
  add(res_h(7), kWidth, kDFeat, kWidth, L.wf, L.bf);                    // fc_feat
  for (int i = 7; i >= 5; --i) {
    add(res_h(i - 1), kWidth, d_z(i), kWidth, L.w[i], L.b[i]);          // layers_xyz.7 .. .5
  }
  add(0, dim, d_z(4), kWidth, L.w[4], L.b[4]);                          // layers_xyz.4 enc rows
  add(res_h(3), kWidth, d_z(4), kWidth, L.w[4] + dim * kWidth, -1);     // .4 h rows
  for (int i = 3; i >= 1; --i) {
    add(res_h(i - 1), kWidth, d_z(i), kWidth, L.w[i], L.b[i]);          // layers_xyz.3 .. .1
  }
  add(0, dim, d_z(0), kWidth, L.w[0], L.b[0]);                          // layers_xyz.0
  t.n_jobs = n;
  t.n_wtiles = tiles;
  return t;
}

// The job of output tile blockIdx.x.
__device__ __forceinline__ WJob find_job(const WJobs& jobs) {
  int jb = 0;
  while (jb + 1 < jobs.n_jobs && jobs.job[jb + 1].first_tile <= static_cast<int>(blockIdx.x)) ++jb;
  return jobs.job[jb];
}

// The f32 instance, on the FMA pipes: fma_wgrad.cuh's 8 x 8 outputs a
// thread over the job's 128 x 128 output tile.
__device__ __forceinline__ void wgrad_fma(const float* __restrict__ res,
                                          const float* __restrict__ delta,
                                          float* __restrict__ partial, long long n_tiles, int dim,
                                          int n_params, const WJobs& jobs, float* smem) {
  const WJob job = find_job(jobs);
  const int o_tiles = (job.out_dim + kWTile - 1) / kWTile;
  const int local = blockIdx.x - job.first_tile;
  wgrad::tile_sums<8, 8, true>(res, res_rows(dim), delta, kDRows, partial, n_params, n_tiles,
                               kTilesPerChunk, blockIdx.y, job, (local / o_tiles) * kWTile,
                               (local % o_tiles) * kWTile, smem);
}

// The f32 instance: output tile blockIdx.x and chunk blockIdx.y of scene
// blockIdx.z.
template <bool kBf16>
__global__ void __launch_bounds__(kWThreads, 2)
train_bwd_wgrad_kernel(const Res<kBf16>* __restrict__ res, const float* __restrict__ delta,
                       float* __restrict__ partial, long long n_tiles, int dim, int n_params,
                       const __grid_constant__ WJobs jobs, const scenes::Strides st) {
  static_assert(!kBf16, "the bf16 weight gradients run wgrad_wg.cuh's body");
  using scenes::at;
  extern __shared__ float4 smem[];
  const unsigned int sc = blockIdx.z;
  wgrad_fma(at(res, st.res, sc), at(delta, st.delta, sc), at(partial, st.partial, sc), n_tiles,
            dim, n_params, jobs, reinterpret_cast<float*>(smem));
}

// The bf16 instance, persistent on wgmma (wgrad_wg.cuh): every scene's
// residual and delta rows through the tensor maps xmap and ymap.
template <bool kBf16>
__global__ void __launch_bounds__(wgrad_wg::kThreads, 1)
train_bwd_wgrad_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap ymap, float* __restrict__ partial,
                       long long partial_stride, int n_params, int n_tiles, int chunks,
                       int n_scenes, const __grid_constant__ wgrad_wg::Items items) {
  static_assert(kBf16, "the f32 weight gradients run fma_wgrad.cuh's body");
  extern __shared__ float4 smem[];
  wgrad_wg::run(&xmap, &ymap, partial, partial_stride, n_params, n_tiles, kTilesPerChunk,
                chunks, n_scenes, items, reinterpret_cast<unsigned char*>(smem));
}

// Backward 3: grad[e] = sum over chunks c, in order, of partial[c][e], per
// scene blockIdx.y.
__global__ void train_bwd_reduce_kernel(const float* __restrict__ partial, int n_chunks,
                                        int n_params, float* __restrict__ grad,
                                        const scenes::Strides st) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_params) return;
  partial = scenes::at(partial, st.partial, blockIdx.y);
  grad = scenes::at(grad, st.grad, blockIdx.y);
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += partial[static_cast<long long>(c) * n_params + e];
  grad[e] = s;
}

// Backward 4: ddc[r][c] = sum over s of dd0 at point r * samples + s, per
// scene blockIdx.y; the deltas are point-major in the bf16 instance.
template <bool kBf16>
__global__ void train_bwd_ddc_kernel(const float* __restrict__ delta, long long n_rays,
                                     int samples, float* __restrict__ ddc,
                                     const scenes::Strides st) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_rays * kDirWidth) return;
  delta = scenes::at(delta, st.delta, blockIdx.y);
  ddc = scenes::at(ddc, st.ddc, blockIdx.y);
  const long long r = idx / kDirWidth;
  const int c = static_cast<int>(idx % kDirWidth);
  float s = 0.f;
  for (int k = 0; k < samples; ++k) {
    const long long q = r * samples + k;
    s += kBf16 ? delta[q * kDRows + kDD0 + c]
               : delta[((q / kTile) * kDRows + kDD0 + c) * kTile + q % kTile];
  }
  ddc[idx] = s;
}

// The per-scene strides of a launch at this shape (scenes.cuh): each
// scene's buffers are the single-scene launch's.
scenes::Strides scene_strides(const Layout& L, long long n_points, int samples, bool bf16) {
  const long long tiles = (n_points + kTile - 1) / kTile;
  const long long chunks = (tiles + kTilesPerChunk - 1) / kTilesPerChunk;
  const long long dc = n_points / samples * kDirWidth;
  return {3 * n_points, dc, L.total, bf16 ? tc::make_fwd_layout(L.dim).total : 0,
          4 * n_points, tiles * kTile * (bf16 ? tc::res_rows(L.dim) : res_rows(L.dim)),
          4 * n_points, bf16 ? tc::kBTotal : kTParams, tiles * kDRows * kTile,
          chunks * L.total, L.total, dc};
}

// `smem` bytes of dynamic shared memory for `kernel` and, with `carveout`,
// the largest shared-memory carveout.
template <typename Kernel>
cudaError_t set_smem(Kernel* kernel, size_t smem, bool carveout) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  return err == cudaSuccess && carveout ? max_shared_carveout(kernel) : err;
}

template <bool kBf16>
cudaError_t launch_fwd(const float* pts, const float* dc, const float* params, const bf16* wbf,
                       const Layout& L, float* out, void* res, int n_scenes, long long n_points,
                       int samples, int num_freq, cudaStream_t stream) {
  const size_t smem = kBf16 ? tc::fwd_smem_bytes(L.dim) : fwd_smem_bytes(L);
  auto* kernel = train_fwd_kernel<kBf16>;
  if constexpr (!kBf16) {
    if (n_scenes == 1) kernel = train_fwd_one_kernel<kBf16>;
  }
  cudaError_t err = set_smem(kernel, smem, !kBf16);
  if (err != cudaSuccess) return err;
  const unsigned int tiles = static_cast<unsigned int>((n_points + kTile - 1) / kTile);
  kernel<<<dim3(tiles, n_scenes), kThreads, smem, stream>>>(
      pts, dc, params, wbf, L, tc::make_fwd_layout(L.dim), out, static_cast<Res<kBf16>*>(res),
      n_points, samples, num_freq, scene_strides(L, n_points, samples, kBf16));
  return cudaGetLastError();
}

// The bf16 weight gradients: one persistent block an SM (no more than the
// work items) over every scene's rows, which the tensor maps take as one
// table: (n_scenes tiles kTile) rows of residuals, and of deltas. That holds
// only while each scene's residuals and deltas lie end to end, unpadded:
// any other stride is refused.
cudaError_t launch_wgrad_wg(const bf16* res, const float* delta, float* partial,
                            long long tiles, long long chunks, int n_scenes, const Layout& L,
                            const WJobs& jobs, const scenes::Strides& st, cudaStream_t stream) {
  const long long rows = n_scenes * tiles * kTile;
  const wgrad_wg::Items items = wgrad_wg::make_items(jobs.job, jobs.n_jobs);
  if (rows > 0x7fffffffLL || items.n == 0 || st.res != tiles * kTile * tc::res_rows(L.dim) ||
      st.delta != tiles * kTile * kDRows) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap xmap, ymap;
  cudaError_t err = wgrad_wg::make_map(&xmap, res, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                       tc::res_rows(L.dim), rows, wgrad_wg::kBoxIn, true);
  if (err == cudaSuccess) {
    err = wgrad_wg::make_map(&ymap, delta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, kDRows, rows,
                             wgrad_wg::kOut, false);
  }
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  using Wg = void (*)(CUtensorMap, CUtensorMap, float*, long long, int, int, int, int,
                      wgrad_wg::Items);
  const Wg kernel = train_bwd_wgrad_kernel<true>;
  if (err == cudaSuccess) err = set_smem(kernel, wgrad_wg::kSmemBytes, false);
  if (err != cudaSuccess) return err;
  const long long work = n_scenes * chunks * items.n;
  const unsigned int grid = static_cast<unsigned int>(work < sms ? work : sms);
  kernel<<<grid, wgrad_wg::kThreads, wgrad_wg::kSmemBytes, stream>>>(
      xmap, ymap, partial, st.partial, L.total, static_cast<int>(tiles),
      static_cast<int>(chunks), n_scenes, items);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_bwd(const float* g, const void* res, const void* wt, const Layout& L,
                       float* delta, float* partial, float* grad, float* ddc, int n_scenes,
                       long long n_points, int samples, cudaStream_t stream) {
  const long long tiles = (n_points + kTile - 1) / kTile;
  const long long chunks = (tiles + kTilesPerChunk - 1) / kTilesPerChunk;
  const scenes::Strides st = scene_strides(L, n_points, samples, kBf16);
  const Res<kBf16>* r = static_cast<const Res<kBf16>*>(res);
  const size_t smem = kBf16 ? tc::kActSmem : kBwdSmem;
  auto* act = train_bwd_act_kernel<kBf16>;
  if constexpr (kBf16) {
    if (n_scenes == 1) act = train_bwd_act_one_kernel<kBf16>;
  }
  cudaError_t err = set_smem(act, smem, !kBf16);
  if (err != cudaSuccess) return err;
  act<<<dim3(static_cast<unsigned int>(tiles), n_scenes), kThreads, smem, stream>>>(
      g, r, wt, delta, n_points, L.dim, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const WJobs jobs = make_jobs(L, kBf16);
  if constexpr (kBf16) {
    err = launch_wgrad_wg(r, delta, partial, tiles, chunks, n_scenes, L, jobs, st, stream);
  } else {
    using Fma = void (*)(const float*, const float*, float*, long long, int, int, WJobs,
                         scenes::Strides);
    err = set_smem(static_cast<Fma>(train_bwd_wgrad_kernel<false>), wgrad::kSmem, true);
    if (err != cudaSuccess) return err;
    const dim3 grid(jobs.n_wtiles, static_cast<unsigned int>(chunks), n_scenes);
    train_bwd_wgrad_kernel<false><<<grid, kWThreads, wgrad::kSmem, stream>>>(
        r, delta, partial, tiles, L.dim, L.total, jobs, st);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  train_bwd_reduce_kernel<<<dim3((L.total + 255) / 256, n_scenes), 256, 0, stream>>>(
      partial, static_cast<int>(chunks), L.total, grad, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_rays = n_points / samples;
  const long long threads = n_rays * kDirWidth;
  train_bwd_ddc_kernel<kBf16><<<dim3(static_cast<unsigned int>((threads + 255) / 256), n_scenes),
                                256, 0, stream>>>(delta, n_rays, samples, ddc, st);
  return cudaGetLastError();
}

bool bad_shape(int n_scenes, long long n_points, int samples, int num_freq) {
  const long long tiles = (n_points + kTile - 1) / kTile;
  return n_scenes <= 0 || n_scenes > scenes::kMaxScenes || num_freq < 0 || num_freq > kMaxFreq ||
         samples <= 0 || n_points <= 0 || n_points % samples != 0 || tiles > 0x7fffffffLL ||
         (tiles + kTilesPerChunk - 1) / kTilesPerChunk > 65535 ||
         (n_points / samples * kDirWidth + 255) / 256 > 0x7fffffffLL;
}

}  // namespace

// The layout the Python wrapper allocates for, at encoding depth num_freq:
// {rows of f32 residuals per point, rows of f32 deltas per point, floats of
// the packed forward parameters, of the packed f32 backward weights, points
// per tile, point tiles per chunk, rows of bf16 residuals per point, bf16
// values of the tensor-core forward weights, of the backward ones}.
extern "C" void nerf_paper_train_layout(int num_freq, int* out) {
  const Layout L = make_layout(num_freq);
  out[0] = res_rows(L.dim);
  out[1] = kDRows;
  out[2] = L.total;
  out[3] = kTParams;
  out[4] = kTile;
  out[5] = kTilesPerChunk;
  out[6] = tc::res_rows(L.dim);
  out[7] = tc::make_fwd_layout(L.dim).total;
  out[8] = tc::kBTotal;
}

// n_scenes scenes of n_points points each (scenes.cuh: every buffer below is
// one scene's, laid end to end n_scenes times). pts (n_points, 3), dc
// (n_points / samples, 128), params (packed, see nerf_paper_train_layout),
// out (n_points, 4): contiguous f32 device buffers, dc and params 16-byte
// aligned; with bf16 != 0 also wbf, the bf16 forward weights in fragment
// order (16-byte aligned; ignored for f32); res: tiles * kTile * (f32 or bf16
// residual rows) elements of the compute dtype. Returns a cudaError_t.
extern "C" int nerf_paper_train_forward(const float* pts, const float* dc, const float* params,
                                        long long n_params, const void* wbf, long long n_wbf,
                                        float* out, void* res, int n_scenes, long long n_points,
                                        int samples, int num_freq, int bf16, void* stream) {
  if (bad_shape(n_scenes, n_points, samples, num_freq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout L = make_layout(num_freq);
  if (n_params != L.total ||
      (bf16 && (wbf == nullptr || n_wbf != tc::make_fwd_layout(L.dim).total))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const __nv_bfloat16*>(wbf);
  const cudaError_t err =
      bf16 ? launch_fwd<true>(pts, dc, params, w, L, out, res, n_scenes, n_points, samples,
                              num_freq, s)
           : launch_fwd<false>(pts, dc, params, w, L, out, res, n_scenes, n_points, samples,
                               num_freq, s);
  return static_cast<int>(err);
}

// n_scenes scenes, as the forward's. g (n_points, 4) f32 cotangent; res from
// the forward; wt the backward weights: (kTParams,) f32 (out, in) matrices,
// or with bf16 != 0 (kBTotal,) bf16 fragments, 16-byte aligned; work buffers:
// delta (tiles * kDRows * kTile f32) and partial (chunks * n_params f32);
// outputs: grad (n_params,) in the packed parameter layout and ddc
// (n_points / samples, 128). Returns a cudaError_t.
extern "C" int nerf_paper_train_backward(const float* g, const void* res, const void* wt,
                                         long long n_wt, float* delta, float* partial,
                                         float* grad, float* ddc, int n_scenes,
                                         long long n_points, int samples, int num_freq,
                                         int bf16, void* stream) {
  if (n_wt != (bf16 ? tc::kBTotal : kTParams) ||
      bad_shape(n_scenes, n_points, samples, num_freq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout L = make_layout(num_freq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_bwd<true>(g, res, wt, L, delta, partial, grad, ddc, n_scenes, n_points,
                              samples, s)
           : launch_bwd<false>(g, res, wt, L, delta, partial, grad, ddc, n_scenes, n_points,
                               samples, s);
  return static_cast<int>(err);
}

