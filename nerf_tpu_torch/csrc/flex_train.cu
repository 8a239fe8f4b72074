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
// What bounds it on the card: in f32, arithmetic. A point costs ~82k
// multiply-adds forward and ~156k backward (~74k to carry the gradient back
// through the layers, ~82k for the weight gradients), against ~1.5 KB (bf16)
// or ~3 KB (f32) of residuals and ~2.8 KB of f32 deltas moved through device
// memory. At 1024 x 128 points the f32 FMA peak (67 TFLOP/s) bounds the
// forward at 0.32 ms and the backward at 0.61 ms. On the bf16 tensor cores
// (989 TFLOP/s) the arithmetic takes 0.02 + 0.04 ms and the bytes set the
// pace: the forward's 0.2 GB of residual writes (0.06 ms at 3.35 TB/s), and
// the backward's 0.37 GB of f32 deltas, written by the layer-gradient pass
// and read by the weight-gradient pass.
//
// The f32 instances run the FMA design: the forward flex_mlp.cuh's
// (mlp_t.cu's note), the backward the passes below; the bf16 instances run
// the same passes on the tensor cores (flex_tc.cuh: mma.sync m16n8k16, bf16
// operands, f32 sums), with the tile, the residuals and the deltas
// point-major, and bf16 weights the wrapper prepares in fragment order
// (kernels/mlp.py pack_tc_forward, kernels/flex_train.py pack_tc_backward):
//   * forward: mlp_t.cu's evaluation (flex_mlp.cuh's or flex_tc.cuh's
//     forward_tile), one block of 128 threads per tile of 64 points, given a
//     residual buffer, so it also copies each layer's tile from shared memory
//     into res[tile][row][point] (f32) or res[point][row] (bf16), coalesced;
//   * backward, four launches on one stream:
//     1. train_bwd_act: per 64-point tile, carries the cotangent back through
//        fc_rgb, the direction layer, the fused [fc_feat; fc_alpha] head
//        (one 129-deep contraction that joins at h3, since fc_alpha reads h3),
//        the trunk and down to layer1's output a0 (unmasked: layer1 has no
//        ReLU). ReLU masks compare the stored (compute-dtype) activation with
//        0. Every layer's output gradient is written, f32 and unrounded, to a
//        delta buffer (delta[tile][row][point] in f32, delta[point][row] in
//        bf16), and over the tile's shared buffer (rounded, in bf16) as the
//        next product's operand. The bf16 instance runs drgb . W_rgb and the
//        fused head as padded products (K 3 -> 16 and 129 -> 144);
//     2. train_bwd_wgrad: dW = X^T dY and db = sum dY for the eight weight
//        matrices, as one launch over (matrix, chunk of 16 point tiles), one
//        output tile of at most 128 x 128 a matrix: on the FMA pipes (f32:
//        fma_wgrad.cuh's register blocks, cut to the matrix's extent rounded
//        up to 16 rows and columns, X and dY staged by cp.async two stages
//        deep) or on the tensor cores (bf16, staged by cp.async; the warps of
//        a narrow matrix's empty rows and columns skip their products). Each
//        block keeps its partial sums in registers and writes them to its
//        chunk's row of a scratch buffer laid out like the packed parameters;
//     3. train_bwd_reduce: sums the chunks' rows in a fixed order. No atomics:
//        two identical calls give bitwise-equal gradients;
//     4. train_bwd_ddc: ddc[ray] = sum over the ray's samples of the
//        direction layer's gradient, one thread per (ray, feature), so rays
//        that straddle tiles (S not a divisor of 64) are summed whole.
//   * the f32 backward reads the weights as nn.Linear's (out, in) matrices
//     from a second packed buffer (kT* offsets below): as (K, OUT) matrices,
//     K the forward layer's outputs, flex_mlp.cuh's dense_sum stages and
//     sums them as it does the forward's, so the f32 layer-gradient pass is
//     the forward's register-blocked body with an epilogue of its own; the
//     bf16 one reads their fragments (flex_tc.cuh kB*).
//
// compute dtype bf16: both operands of every product (forward, dX = dY W^T
// and dW = X^T dY) are rounded to bf16 and the sums stay f32, as
// preferred_element_type=f32 does on the TPU; residuals are stored in bf16.
// Bias gradients and ddc sum the unrounded f32 deltas, as the TPU kernel's
// rowsum and ddc do.
//
// Scenes (scenes.cuh): every launch takes a count of scenes of one shape,
// each with its own inputs, parameters, residuals and outputs, as the
// scene-vmapped multi-scene step gives them; the scene is each grid's
// slowest axis and a scene's blocks do what a single-scene launch's do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "flex_mlp.cuh"
#include "flex_tc.cuh"
#include "fma_wgrad.cuh"
#include "scenes.cuh"

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

// Dynamic shared memory of the f32 layer-gradient pass: buf_a (129 rows:
// the fused head's K), buf_b (128), then the weight ring (96.25 KB, two
// blocks an SM).
constexpr size_t kActSmem = ((2 * kHidden + 1) * kTile + 2 * kSlotFloats) * sizeof(float);

// Weight-gradient blocks: one a matrix and chunk of point tiles.
constexpr int kWThreads = wgrad::kThreads;
constexpr int kTilesPerChunk = 16;    // point tiles summed by one block
static_assert(wgrad::kTile == kTile, "fma_wgrad.cuh tiles points as the kernels do");

// bf16 weight-gradient tiling: 128 inputs x 128 outputs, 8 warps of 32 x 64.
constexpr int kGTile = 128;
constexpr int kGStride = kGTile + 8;   // shared row (bf16): ldmatrix rows on distinct banks

// bf16 layer-gradient tile: rows of the fused head's K (144) + 8.
constexpr int kBStride = 144 + 8;
constexpr size_t kActSmemTc = static_cast<size_t>(kBStride) * kTile * sizeof(__nv_bfloat16);

using bf16 = __nv_bfloat16;

template <bool kBf16>
using Res = std::conditional_t<kBf16, bf16, float>;

// ---------------------------------------------------------------------------
// Forward: mlp_t's evaluation, saving every residual.

// Each kernel below is a template over the compute dtype whose f32 instance
// keeps the FMA design's launch bounds; the bf16 instance is an explicit
// specialization with its own: a register budget that fits its blocks on an
// SM without spills.

// Tile blockIdx.x of scene sc. The f32 body takes the scene's points,
// their rays' dc rows and their outputs by their index among all the
// scenes' (scene sc's points start at sc * n_points, a whole number of rays),
// and its parameters at a constant stride, so that it holds no pointer of
// its own scene through the layers: with every pointer offset, 6 scenes of
// 1024 x 128 points took 4.75 ms against 4.16 for 6 single-scene launches,
// so 4.21-4.24 (NVIDIA H100 80GB HBM3, 700 W, tools/torch_kernel_check.py).
template <bool kBf16>
__device__ __forceinline__ void train_fwd_scene(const float* pts, const float* dc,
                                                const float* params, const bf16* wbf, float* out,
                                                Res<kBf16>* res, long long n_points, int samples,
                                                const scenes::Strides& st, unsigned int sc) {
  using scenes::at;
  extern __shared__ float4 smem[];
  if constexpr (kBf16) {
    auto* enc = reinterpret_cast<bf16*>(smem);
    tc::forward_tile(at(pts, st.pts, sc), at(dc, st.dc, sc), at(params, st.params, sc),
                     at(wbf, st.wbf, sc), at(out, st.out, sc), at(res, st.res, sc), n_points,
                     samples, enc, enc + tc::kEncStride * kTile);
  } else {
    const long long first = static_cast<long long>(sc) * n_points;
    // forward_tile_at finds the residual rows of the point p at tile p / kTile
    // from res: rt is scene sc's buffer less the first / kTile tiles before
    // it, so the global tiles of scene sc land in its own buffer. first / kTile
    // <= sc * tiles, so rt never lies before scene 0's buffer.
    float* rt = at(res, st.res, sc) - (first / kTile) * kResRows * kTile;
    forward_tile_at(pts, dc, params + static_cast<long long>(sc) * kParams, out, 0, rt,
                    first + static_cast<long long>(blockIdx.x) * kTile, first + n_points, samples,
                    reinterpret_cast<float*>(smem));
  }
}

// Tile blockIdx.x of scene blockIdx.y.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
train_fwd_kernel(const float* __restrict__ pts, const float* __restrict__ dc,
                 const float* __restrict__ params, const bf16* __restrict__ wbf,
                 float* __restrict__ out, Res<kBf16>* __restrict__ res, long long n_points,
                 int samples, const scenes::Strides st) {
  train_fwd_scene<kBf16>(pts, dc, params, wbf, out, res, n_points, samples, st, blockIdx.y);
}

template <>
__global__ void __launch_bounds__(kThreads, 4)
train_fwd_kernel<true>(const float* __restrict__ pts, const float* __restrict__ dc,
                       const float* __restrict__ params, const bf16* __restrict__ wbf,
                       float* __restrict__ out, bf16* __restrict__ res, long long n_points,
                       int samples, const scenes::Strides st) {
  train_fwd_scene<true>(pts, dc, params, wbf, out, res, n_points, samples, st, blockIdx.y);
}

// One scene, without the scene's offsets (wbf and st unused): the f32
// forward runs it at S = 1, where train_fwd_kernel<0> (126 registers against
// 114) takes 3% longer. Only the f32 instance exists.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
train_fwd_one_kernel(const float* __restrict__ pts, const float* __restrict__ dc,
                     const float* __restrict__ params, const bf16* __restrict__ wbf,
                     float* __restrict__ out, Res<kBf16>* __restrict__ res, long long n_points,
                     int samples, const scenes::Strides st) {
  static_assert(!kBf16, "the bf16 forward has no one-scene kernel");
  extern __shared__ float4 smem[];
  forward_tile(pts, dc, params, out, res, n_points, samples, reinterpret_cast<float*>(smem));
}

// ---------------------------------------------------------------------------
// Backward 1: the gradient of every layer's output, per tile.

// The f32 instance's epilogue: dX = mask(stored activation > 0) * the
// thread's block (dense_sum's), written to the tile's delta rows and, unless
// act is null, to the shared tile buffer act as the next product's operand.
// mask_rows null = no mask.
template <int OUT>
__device__ __forceinline__ void store_grad(float (&acc)[OUT / 16][8],
                                           const float* __restrict__ mask_rows,
                                           float* __restrict__ delta_rows, float* act) {
  constexpr int kTF = OUT / 16;
  const int j0 = (threadIdx.x / 8) * kTF;
  const int p0 = 4 * (threadIdx.x % 8);
  if (mask_rows != nullptr) {
#pragma unroll
    for (int f = 0; f < kTF; ++f) {
      const float* m = mask_rows + (j0 + f) * kTile + p0;
      const float4 m0 = *reinterpret_cast<const float4*>(m);
      const float4 m1 = *reinterpret_cast<const float4*>(m + 32);
      const float mk[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[f][q] = mk[q] > 0.f ? acc[f][q] : 0.f;
    }
  }
#pragma unroll
  for (int f = 0; f < kTF; ++f) {
    const float4 lo = make_float4(acc[f][0], acc[f][1], acc[f][2], acc[f][3]);
    const float4 hi = make_float4(acc[f][4], acc[f][5], acc[f][6], acc[f][7]);
    float* d = delta_rows + (j0 + f) * kTile + p0;
    *reinterpret_cast<float4*>(d) = lo;
    *reinterpret_cast<float4*>(d + 32) = hi;
    if (act != nullptr) {
      float* a = act + (j0 + f) * kTile + p0;
      *reinterpret_cast<float4*>(a) = lo;
      *reinterpret_cast<float4*>(a + 32) = hi;
    }
  }
}

// The f32 instance, on flex_mlp.cuh's dense_sum over the backward weights,
// staged through its ring. Each layer's gradient is dX[j][p] = mask(act[j][p]
// > 0) * sum_k WT[k][j] dY[k][p], WT (K, OUT) the (out, in) nn.Linear weight
// of the forward layer, summed as acc = fmaf(WT[k][j], dY[k][p], acc) for k
// ascending from 0.f, with no bias: the order of the one-feature-a-thread
// design before it, so the deltas are bitwise that design's. The tile's
// gradients ping-pong between buf_a and buf_b (dense_sum's first barrier
// ends the reads of the buffer a layer writes); each layer's last slice
// stages the next layer's first. smem is kActSmem bytes.
__device__ __forceinline__ void bwd_act_tile_fma(const float* __restrict__ g,
                                                 const float* __restrict__ res,
                                                 const float* __restrict__ wt,
                                                 float* __restrict__ delta, long long n_points,
                                                 float* smem) {
  float* buf_a = smem;                             // 129 rows
  float* buf_b = buf_a + (kHidden + 1) * kTile;    // 128 rows
  Ring ring{buf_b + kBufFloats, 0};
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const float* rt = res + static_cast<long long>(blockIdx.x) * kResRows * kTile;
  float* dt = delta + static_cast<long long>(blockIdx.x) * kDRows * kTile;

  // Cotangent: drgb into buf_a rows 0..2, dsigma into row 128 (the fused
  // head's extra row); padded points get 0, so they add nothing anywhere.
  // fc_rgb's weights land meanwhile; the first sum's barrier publishes both.
  stage_async(ring.slot(0), first_slice<kDirHidden>(wt + kTWr, 3));
  if (threadIdx.x < kTile) {
    const int p = threadIdx.x;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tile0 + p < n_points) v = reinterpret_cast<const float4*>(g)[tile0 + p];
    buf_a[0 * kTile + p] = v.x;
    buf_a[1 * kTile + p] = v.y;
    buf_a[2 * kTile + p] = v.z;
    buf_a[kHidden * kTile + p] = v.w;
    dt[(kDRgb + 0) * kTile + p] = v.x;
    dt[(kDRgb + 1) * kTile + p] = v.y;
    dt[(kDRgb + 2) * kTile + p] = v.z;
    dt[kDSig * kTile + p] = v.w;
  }
  {  // dhd = mask(hd) * drgb W_rgb^T
    float acc[kDirHidden / 16][8];
    dense_sum<kDirHidden>(ring, Rows{wt + kTWr, 3, buf_a}, acc,
                          first_slice<kHidden>(wt + kTWd, kDirHidden));
    store_grad<kDirHidden>(acc, rt + kResHd * kTile, dt + kDHd * kTile, buf_b);
  }
  {  // dfeat = mask(feat) * dhd W_dir[:128]^T  (buf_a row 128 keeps dsigma)
    float acc[kHidden / 16][8];
    dense_sum<kHidden>(ring, Rows{wt + kTWd, kDirHidden, buf_b}, acc,
                       first_slice<kHidden>(wt + kTWfa, kHidden + 1));
    store_grad<kHidden>(acc, rt + kResFeat * kTile, dt + kDFeat * kTile, buf_a);
  }
  {  // dh3 = mask(h3) * [dfeat; dsigma] [W_feat; W_alpha]^T
    float acc[kHidden / 16][8];
    dense_sum<kHidden>(ring, Rows{wt + kTWfa, kHidden + 1, buf_a}, acc,
                       first_slice<kHidden>(wt + kTWx2, kHidden));
    store_grad<kHidden>(acc, rt + kResH3 * kTile, dt + kDH3 * kTile, buf_b);
  }
  {
    float acc[kHidden / 16][8];
    dense_sum<kHidden>(ring, Rows{wt + kTWx2, kHidden, buf_b}, acc,
                       first_slice<kHidden>(wt + kTWx1, kHidden));
    store_grad<kHidden>(acc, rt + kResH2 * kTile, dt + kDH2 * kTile, buf_a);
  }
  {
    float acc[kHidden / 16][8];
    dense_sum<kHidden>(ring, Rows{wt + kTWx1, kHidden, buf_a}, acc,
                       first_slice<kHidden>(wt + kTWx0, kHidden));
    store_grad<kHidden>(acc, rt + kResH1 * kTile, dt + kDH1 * kTile, buf_b);
  }
  {  // da0: layer1 has no ReLU, so no mask.
    float acc[kHidden / 16][8];
    dense_sum<kHidden>(ring, Rows{wt + kTWx0, kHidden, buf_b}, acc, Slice{nullptr, 0});
    store_grad<kHidden>(acc, nullptr, dt + kDA0 * kTile, nullptr);
  }
}

template <int NT>
using TcAcc = tcmma::Acc<NT, tc::kWarps, kBStride>;

// The bf16 instance: dX = mask(stored activation > 0) * acc, written
// unrounded to the point's delta rows (f32, point-major) and, unless act is
// null, rounded over the shared tile as the next product's operand.
// mask null = no mask.
template <int NT>
__device__ __forceinline__ void store_grad_tc(TcAcc<NT>& a, const bf16* __restrict__ mask,
                                              float* __restrict__ drow, bf16* act) {
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
              mask + p * tc::kRows + n0 + 8 * n));
          y0 = mk.x > 0.f ? y0 : 0.f;
          y1 = mk.y > 0.f ? y1 : 0.f;
          a.v[m][n][2 * h] = y0;
          a.v[m][n][2 * h + 1] = y1;
        }
        *reinterpret_cast<float2*>(drow + p * kDRows + n0 + 8 * n) = make_float2(y0, y1);
      }
    }
  }
  if (act != nullptr) a.write(act);
}

// The bf16 instance, on the tensor cores; act is 64 x kBStride bf16.
__device__ __forceinline__ void bwd_act_tile_tc(const float* __restrict__ g,
                                                const bf16* __restrict__ res,
                                                const bf16* __restrict__ w,
                                                float* __restrict__ delta, long long n_points,
                                                bf16* act) {
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;
  const bf16* rt = res + tile0 * tc::kRows;
  float* dt = delta + tile0 * kDRows;

  // Cotangent: drgb into act columns 0..2 and dsigma into column 128 (the
  // fused head's extra row), the two padded products' K pads (3..15,
  // 129..143) zero; padded points get 0, so they add nothing anywhere.
  if (threadIdx.x < kTile) {
    const int p = threadIdx.x;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tile0 + p < n_points) v = reinterpret_cast<const float4*>(g)[tile0 + p];
    bf16* r = act + p * kBStride;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    reinterpret_cast<uint4*>(r)[0] = zero;
    reinterpret_cast<uint4*>(r)[1] = zero;
    reinterpret_cast<uint4*>(r + kHidden)[0] = zero;
    reinterpret_cast<uint4*>(r + kHidden)[1] = zero;
    r[0] = __float2bfloat16_rn(v.x);
    r[1] = __float2bfloat16_rn(v.y);
    r[2] = __float2bfloat16_rn(v.z);
    r[kHidden] = __float2bfloat16_rn(v.w);
    *reinterpret_cast<float4*>(dt + p * kDRows + kDRgb) = v;
  }
  __syncthreads();
  {  // dhd = mask(hd) * drgb W_rgb^T
    TcAcc<2> a;
    a.mac(w + tc::kBRgb, act, kBStride, 1);
    store_grad_tc(a, rt + tc::kRowHd, dt + kDHd, act);
  }
  {  // dfeat = mask(feat) * dhd W_dir[:128]^T  (column 128 keeps dsigma)
    TcAcc<4> a;
    a.mac(w + tc::kBDir, act, kBStride, kDirHidden / 16);
    store_grad_tc(a, rt + tc::kRowFeat, dt + kDFeat, act);
  }
  {  // dh3 = mask(h3) * [dfeat; dsigma] [W_feat; W_alpha]^T
    TcAcc<4> a;
    a.mac(w + tc::kBHead, act, kBStride, 144 / 16);
    store_grad_tc(a, rt + tc::kRowH3, dt + kDH3, act);
  }
  {
    TcAcc<4> a;
    a.mac(w + tc::kbx(2), act, kBStride, kHidden / 16);
    store_grad_tc(a, rt + tc::kRowH2, dt + kDH2, act);
  }
  {
    TcAcc<4> a;
    a.mac(w + tc::kbx(1), act, kBStride, kHidden / 16);
    store_grad_tc(a, rt + tc::kRowH1, dt + kDH1, act);
  }
  {  // da0: layer1 has no ReLU, so no mask.
    TcAcc<4> a;
    a.mac(w + tc::kbx(0), act, kBStride, kHidden / 16);
    store_grad_tc(a, nullptr, dt + kDA0, nullptr);
  }
}

// Tile blockIdx.x of scene sc.
template <bool kBf16>
__device__ __forceinline__ void bwd_act_scene(const float* g, const Res<kBf16>* res,
                                              const void* weights, float* delta,
                                              long long n_points, const scenes::Strides& st,
                                              unsigned int sc) {
  using scenes::at;
  extern __shared__ float4 smem[];
  if constexpr (kBf16) {
    bwd_act_tile_tc(at(g, st.g, sc), at(res, st.res, sc),
                    at(static_cast<const bf16*>(weights), st.wt, sc), at(delta, st.delta, sc),
                    n_points, reinterpret_cast<bf16*>(smem));
  } else {
    bwd_act_tile_fma(at(g, st.g, sc), at(res, st.res, sc),
                     at(static_cast<const float*>(weights), st.wt, sc), at(delta, st.delta, sc),
                     n_points, reinterpret_cast<float*>(smem));
  }
}

// Tile blockIdx.x of scene blockIdx.y.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
train_bwd_act_kernel(const float* __restrict__ g, const Res<kBf16>* __restrict__ res,
                     const void* __restrict__ weights, float* __restrict__ delta,
                     long long n_points, const scenes::Strides st) {
  bwd_act_scene<kBf16>(g, res, weights, delta, n_points, st, blockIdx.y);
}

// 3 blocks an SM: at 4 (128 registers) the k-step loop spilled.
template <>
__global__ void __launch_bounds__(kThreads, 3)
train_bwd_act_kernel<true>(const float* __restrict__ g, const bf16* __restrict__ res,
                           const void* __restrict__ weights, float* __restrict__ delta,
                           long long n_points, const scenes::Strides st) {
  bwd_act_scene<true>(g, res, weights, delta, n_points, st, blockIdx.y);
}

// One scene, without the scene's offsets (st unused): the bf16 pass runs it
// at S = 1, where train_bwd_act_kernel<1> spills 4 bytes and takes 5%
// longer. Only the bf16 instance is launched.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 3)
train_bwd_act_one_kernel(const float* __restrict__ g, const Res<kBf16>* __restrict__ res,
                         const void* __restrict__ weights, float* __restrict__ delta,
                         long long n_points, const scenes::Strides st) {
  bwd_act_scene<kBf16>(g, res, weights, delta, n_points, scenes::Strides{}, 0u);
}

// ---------------------------------------------------------------------------
// Backward 2: weight and bias gradients, partial sums per chunk of tiles.

using WJob = wgrad::Job;

// The eight matrices, one output tile each, in the f32 residual layout and
// in the bf16 one (first_tile: the job's index). The f32 table runs the
// largest first: its grid is (chunk, job), and blocks start in that order,
// so the small ones fill the last wave.
constexpr int kNumJobs = 8;
__constant__ WJob kJobs[kNumJobs] = {
    {kResH3, kHidden, kDFeat, kHidden, kOffWf, kOffBf, 0},                     // fc_feat
    {kResH2, kHidden, kDH3, kHidden, kOffWx + 2 * kLayerX,
     kOffWx + 2 * kLayerX + kHidden * kHidden, 1},                             // layers_xyz.2
    {kResH1, kHidden, kDH2, kHidden, kOffWx + kLayerX,
     kOffWx + kLayerX + kHidden * kHidden, 2},                                 // layers_xyz.1
    {kResA0, kHidden, kDH1, kHidden, kOffWx, kOffWx + kHidden * kHidden, 3},   // layers_xyz.0
    {kResFeat, kHidden, kDHd, kDirHidden, kOffWd, kOffBd, 4},                  // layers_dir.0
    {kResEnc, kEnc, kDA0, kHidden, kOffW1, kOffB1, 5},                         // layer1
    {kResH3, kHidden, kDSig, 1, kOffWa, kOffBa, 6},                            // fc_alpha
    {kResHd, kDirHidden, kDRgb, 3, kOffWr, kOffBr, 7},                         // fc_rgb
};
__constant__ WJob kTcJobs[kNumJobs] = {
    {tc::kRowHd, kDirHidden, kDRgb, 3, kOffWr, kOffBr, 0},
    {tc::kRowFeat, kHidden, kDHd, kDirHidden, kOffWd, kOffBd, 1},
    {tc::kRowH3, kHidden, kDFeat, kHidden, kOffWf, kOffBf, 2},
    {tc::kRowH3, kHidden, kDSig, 1, kOffWa, kOffBa, 3},
    {tc::kRowH2, kHidden, kDH3, kHidden, kOffWx + 2 * kLayerX,
     kOffWx + 2 * kLayerX + kHidden * kHidden, 4},
    {tc::kRowH1, kHidden, kDH2, kHidden, kOffWx + kLayerX,
     kOffWx + kLayerX + kHidden * kHidden, 5},
    {tc::kRowA0, kHidden, kDH1, kHidden, kOffWx, kOffWx + kHidden * kHidden, 6},
    {tc::kRowEnc, kEnc, kDA0, kHidden, kOffW1, kOffB1, 7},
};

// The f32 instance, on the FMA pipes: chunk blockIdx.x of matrix
// blockIdx.y, fma_wgrad.cuh's register blocks over the matrix's extent
// rounded up to 16 rows (inputs) and columns (outputs): 8 x 8 a thread for
// the 128 x 128 matrices, 8 x 4 for layers_dir.0 (128 x 64), 4 x 8 for
// layer1 (63 x 128), 8 x 1 for fc_alpha (128 x 1) and 4 x 1 for fc_rgb
// (64 x 3): 84,992 products a point for the 82,112 the matrices hold, 3.4%
// of them padding (64 x 64 tiles: 13%).
template <int A, int B>
__device__ __forceinline__ void wgrad_tile(const float* __restrict__ res,
                                           const float* __restrict__ delta,
                                           float* __restrict__ partial, long long n_tiles,
                                           const WJob& job, float* smem) {
  wgrad::tile_sums<A, B, false>(res, kResRows, delta, kDRows, partial, kParams, n_tiles,
                                kTilesPerChunk, blockIdx.x, job, 0, 0, smem);
}

__device__ __forceinline__ void wgrad_fma(const float* __restrict__ res,
                                          const float* __restrict__ delta,
                                          float* __restrict__ partial, long long n_tiles,
                                          float* smem) {
  const WJob job = kJobs[blockIdx.y];
  if (job.in_dim > 64) {
    if (job.out_dim > 64) {
      wgrad_tile<8, 8>(res, delta, partial, n_tiles, job, smem);
    } else if (job.out_dim > 16) {
      wgrad_tile<8, 4>(res, delta, partial, n_tiles, job, smem);
    } else {
      wgrad_tile<8, 1>(res, delta, partial, n_tiles, job, smem);
    }
  } else if (job.out_dim > 16) {
    wgrad_tile<4, 8>(res, delta, partial, n_tiles, job, smem);
  } else {
    wgrad_tile<4, 1>(res, delta, partial, n_tiles, job, smem);
  }
}

// 16 bytes from device memory to shared memory, asynchronously (cp.async,
// L2 only); with pred false the destination is zero-filled and src not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}

constexpr int kDStage = kGTile + 4;   // f32 dY staging row (floats)
// Dynamic shared memory of a bf16 weight-gradient block: X twice, dY (bf16),
// the f32 dY staging tile and the bias sums' reduction.
constexpr size_t kWgradSmem = (2 * kTile * kGStride + kTile * kGStride) * sizeof(bf16) +
                              (kTile * kDStage + (kWThreads / 32) * kGTile) * sizeof(float);

// The bf16 instance, on the tensor cores: block (job, chunk) owns the job's
// whole matrix (at most kGTile x kGTile), 8 warps of 32 inputs x 64 outputs
// (2 x 8 m16n8 tiles); per 64-point tile, X (bf16 residuals) and dY (f32
// deltas, rounded as they are staged) are staged point-major and read with
// ldmatrix.trans (K = points). A warp whose outputs lie past the matrix's
// skips their products (fc_rgb, fc_alpha and layers_dir.0 are narrower than
// the tile). The staging is asynchronous: cp.async brings the next tile's X
// (double-buffered) and f32 dY rows while this tile's products run; the dY
// rows are then rounded into the bf16 tile in shared memory, and the bias
// sums add the unrounded values as they pass (each thread 4 outputs over 8
// points of a tile; the 8 warps' sums added in a fixed order at the end).
// Synchronous staging ran this pass in 0.425 ms at 1024 x 128 points, this in
// 0.268-0.271 (tools/torch_kernel_check.py, NVIDIA H100 80GB HBM3, 700 W),
// with bitwise the same sums.
__device__ __forceinline__ void wgrad_tc(const bf16* __restrict__ res,
                                         const float* __restrict__ delta,
                                         float* __restrict__ partial, long long n_tiles) {
  extern __shared__ float4 smem_w[];
  bf16* xs = reinterpret_cast<bf16*>(smem_w);          // [2][64][kGStride]
  bf16* ys = xs + 2 * kTile * kGStride;                 // [64][kGStride]
  float* dys = reinterpret_cast<float*>(ys + kTile * kGStride);   // [64][kDStage]
  float* red = dys + kTile * kDStage;                   // [8][kGTile]

  const WJob job = kTcJobs[blockIdx.x];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int groups = wm * 32 < job.in_dim ? min(4, (job.out_dim - wn * 64 + 15) / 16) : 0;
  const int d0 = job.d_row & ~3;            // aligned start of the dY rows
  const int doff = job.d_row - d0;
  const int dchunks = (doff + job.out_dim + 3) / 4;

  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    }
  }
  float bs[4] = {0.f, 0.f, 0.f, 0.f};

  const long long t_begin = static_cast<long long>(blockIdx.y) * kTilesPerChunk;
  const long long t_end = min(t_begin + kTilesPerChunk, n_tiles);
  auto issue = [&](long long t, bf16* xb) {
    const bf16* xt = res + t * kTile * tc::kRows + job.x_row;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = threadIdx.x & 15;
      const int p = (threadIdx.x >> 4) + 16 * j;
      cp_async16(xb + p * kGStride + 8 * c, xt + p * tc::kRows + 8 * c, 8 * c < job.in_dim);
    }
    const float* dt = delta + t * kTile * kDRows + d0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = warp + 8 * j;
      cp_async16(dys + p * kDStage + 4 * lane, dt + p * kDRows + 4 * lane, lane < dchunks);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  issue(t_begin, xs);
  for (long long t = t_begin; t < t_end; ++t) {
    const bf16* xb = xs + ((t - t_begin) & 1) * kTile * kGStride;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    // dY: round outputs 4 lane .. + 3 of points warp + 8 j into ys, sum the
    // unrounded values into the bias.
    const int o = 4 * lane;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = warp + 8 * j;
      const float* src = dys + p * kDStage + doff + o;
      float4 v;
      v.x = o < job.out_dim ? src[0] : 0.f;
      v.y = o + 1 < job.out_dim ? src[1] : 0.f;
      v.z = o + 2 < job.out_dim ? src[2] : 0.f;
      v.w = o + 3 < job.out_dim ? src[3] : 0.f;
      bs[0] += v.x;
      bs[1] += v.y;
      bs[2] += v.z;
      bs[3] += v.w;
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      *reinterpret_cast<uint2*>(ys + p * kGStride + 4 * lane) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    }
    __syncthreads();
    if (t + 1 < t_end) issue(t + 1, xs + ((t + 1 - t_begin) & 1) * kTile * kGStride);
    if (groups > 0) {
#pragma unroll
      for (int ks = 0; ks < kTile / 16; ++ks) {
        uint32_t af[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          tcmma::ldsm4t(af[m], xb + (ks * 16 + (lane & 7) + (lane >> 4) * 8) * kGStride +
                                   wm * 32 + m * 16 + ((lane >> 3) & 1) * 8);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q < groups) {
            uint32_t bf[4];
            tcmma::ldsm4t(bf, ys + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kGStride +
                                  wn * 64 + q * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              tcmma::mma(acc[m][2 * q], af[m], bf[0], bf[1]);
              tcmma::mma(acc[m][2 * q + 1], af[m], bf[2], bf[3]);
            }
          }
        }
      }
    }
  }
  __syncthreads();

  float* out = partial + static_cast<long long>(blockIdx.y) * kParams;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = wm * 32 + m * 16 + (lane >> 2) + 8 * h;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int oo = wn * 64 + n * 8 + 2 * (lane & 3) + e;
          if (i < job.in_dim && oo < job.out_dim) {
            out[job.w_off + i * job.out_dim + oo] = acc[m][n][2 * h + e];
          }
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) red[warp * kGTile + 4 * lane + e] = bs[e];
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < job.out_dim) {
    float sum = 0.f;
    for (int w = 0; w < kWThreads / 32; ++w) sum += red[w * kGTile + threadIdx.x];
    out[job.b_off + threadIdx.x] = sum;
  }
}

// Scene sc's chunk and matrix (blockIdx.x and .y, or .y and .x in bf16).
template <bool kBf16>
__device__ __forceinline__ void wgrad_scene(const Res<kBf16>* res, const float* delta,
                                            float* partial, long long n_tiles,
                                            const scenes::Strides& st, unsigned int sc) {
  using scenes::at;
  if constexpr (kBf16) {
    wgrad_tc(at(res, st.res, sc), at(delta, st.delta, sc), at(partial, st.partial, sc),
             n_tiles);
  } else {
    extern __shared__ float4 smem[];
    wgrad_fma(at(res, st.res, sc), at(delta, st.delta, sc), at(partial, st.partial, sc),
              n_tiles, reinterpret_cast<float*>(smem));
  }
}

// 2 blocks an SM: 128 registers, 72 KB of shared memory each. The scene is
// blockIdx.z.
template <bool kBf16>
__global__ void __launch_bounds__(kWThreads, 2)
train_bwd_wgrad_kernel(const Res<kBf16>* __restrict__ res, const float* __restrict__ delta,
                       float* __restrict__ partial, long long n_tiles, const scenes::Strides st) {
  wgrad_scene<kBf16>(res, delta, partial, n_tiles, st, blockIdx.z);
}

// Backward 3: grad[e] = sum over chunks c, in order, of partial[c][e], per
// scene blockIdx.y.
__global__ void train_bwd_reduce_kernel(const float* __restrict__ partial, int n_chunks,
                                        float* __restrict__ grad, const scenes::Strides st) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= kParams) return;
  partial = scenes::at(partial, st.partial, blockIdx.y);
  grad = scenes::at(grad, st.grad, blockIdx.y);
  float s = 0.f;
  for (int c = 0; c < n_chunks; ++c) s += partial[static_cast<long long>(c) * kParams + e];
  grad[e] = s;
}

// Backward 4: ddc[r][c] = sum over s of dhd at point r * samples + s, per
// scene blockIdx.y; the deltas are point-major in the bf16 instance.
template <bool kBf16>
__global__ void train_bwd_ddc_kernel(const float* __restrict__ delta, long long n_rays,
                                     int samples, float* __restrict__ ddc,
                                     const scenes::Strides st) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_rays * kDirHidden) return;
  delta = scenes::at(delta, st.delta, blockIdx.y);
  ddc = scenes::at(ddc, st.ddc, blockIdx.y);
  const long long r = idx / kDirHidden;
  const int c = static_cast<int>(idx % kDirHidden);
  float s = 0.f;
  for (int k = 0; k < samples; ++k) {
    const long long q = r * samples + k;
    s += kBf16 ? delta[q * kDRows + kDHd + c]
               : delta[((q / kTile) * kDRows + kDHd + c) * kTile + q % kTile];
  }
  ddc[idx] = s;
}

// The per-scene strides of a launch at this shape (scenes.cuh): each
// scene's buffers are the single-scene launch's.
scenes::Strides scene_strides(long long n_points, int samples, bool bf16) {
  const long long tiles = (n_points + kTile - 1) / kTile;
  const long long chunks = (tiles + kTilesPerChunk - 1) / kTilesPerChunk;
  const long long dc = n_points / samples * kDirHidden;
  return {3 * n_points, dc, kParams, bf16 ? tc::kFwdWeights : 0,
          4 * n_points, tiles * kTile * (bf16 ? tc::kRows : kResRows), 4 * n_points,
          bf16 ? tc::kBwdWeights : kTParams, tiles * kDRows * kTile, chunks * kParams, kParams,
          dc};
}

// `smem` bytes of dynamic shared memory for `kernel`.
template <typename Kernel>
cudaError_t set_smem(Kernel* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kBf16>
cudaError_t launch_fwd(const float* pts, const float* dc, const float* params, const bf16* wbf,
                       float* out, void* res, int n_scenes, long long n_points, int samples,
                       cudaStream_t stream) {
  const size_t smem = kBf16 ? tc::kFwdSmem : kForwardSmem;
  auto* kernel = train_fwd_kernel<kBf16>;
  if constexpr (!kBf16) {
    if (n_scenes == 1) kernel = train_fwd_one_kernel<kBf16>;
  }
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned int tiles = static_cast<unsigned int>((n_points + kTile - 1) / kTile);
  kernel<<<dim3(tiles, n_scenes), kThreads, smem, stream>>>(
      pts, dc, params, wbf, out, static_cast<Res<kBf16>*>(res), n_points, samples,
      scene_strides(n_points, samples, kBf16));
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_bwd(const float* g, const void* res, const void* wt, float* delta,
                       float* partial, float* grad, float* ddc, int n_scenes,
                       long long n_points, int samples, cudaStream_t stream) {
  const long long tiles = (n_points + kTile - 1) / kTile;
  const long long chunks = (tiles + kTilesPerChunk - 1) / kTilesPerChunk;
  const scenes::Strides st = scene_strides(n_points, samples, kBf16);
  const Res<kBf16>* r = static_cast<const Res<kBf16>*>(res);
  const size_t smem = kBf16 ? kActSmemTc : kActSmem;
  auto* act = train_bwd_act_kernel<kBf16>;
  if constexpr (kBf16) {
    if (n_scenes == 1) act = train_bwd_act_one_kernel<kBf16>;
  }
  cudaError_t err = set_smem(act, smem);
  if (err != cudaSuccess) return err;
  act<<<dim3(static_cast<unsigned int>(tiles), n_scenes), kThreads, smem, stream>>>(
      g, r, wt, delta, n_points, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t wsmem = kBf16 ? kWgradSmem : wgrad::kSmem;
  err = set_smem(train_bwd_wgrad_kernel<kBf16>, wsmem);
  if (err != cudaSuccess) return err;
  const dim3 grid = kBf16 ? dim3(kNumJobs, static_cast<unsigned int>(chunks), n_scenes)
                         : dim3(static_cast<unsigned int>(chunks), kNumJobs, n_scenes);
  train_bwd_wgrad_kernel<kBf16><<<grid, kWThreads, wsmem, stream>>>(r, delta, partial, tiles,
                                                                    st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  train_bwd_reduce_kernel<<<dim3((kParams + 255) / 256, n_scenes), 256, 0, stream>>>(
      partial, static_cast<int>(chunks), grad, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_rays = n_points / samples;
  const long long threads = n_rays * kDirHidden;
  train_bwd_ddc_kernel<kBf16><<<dim3(static_cast<unsigned int>((threads + 255) / 256), n_scenes),
                                256, 0, stream>>>(delta, n_rays, samples, ddc, st);
  return cudaGetLastError();
}

bool bad_shape(int n_scenes, long long n_points, int samples) {
  const long long tiles = (n_points + kTile - 1) / kTile;
  return n_scenes <= 0 || n_scenes > scenes::kMaxScenes || samples <= 0 || n_points <= 0 ||
         n_points % samples != 0 || tiles > 0x7fffffffLL ||
         (tiles + kTilesPerChunk - 1) / kTilesPerChunk > 65535 ||
         (n_points / samples * kDirHidden + 255) / 256 > 0x7fffffffLL;
}

}  // namespace

// The layout the Python wrapper allocates for: {rows of f32 residuals per
// point, rows of f32 deltas per point, floats of the packed forward
// parameters, of the packed f32 backward weights, points per tile, point
// tiles per chunk, rows of bf16 residuals per point, bf16 values of the
// tensor-core forward weights, of the backward ones}.
extern "C" void nerf_flex_train_layout(int* out) {
  out[0] = kResRows;
  out[1] = kDRows;
  out[2] = kParams;
  out[3] = kTParams;
  out[4] = kTile;
  out[5] = kTilesPerChunk;
  out[6] = tc::kRows;
  out[7] = tc::kFwdWeights;
  out[8] = tc::kBwdWeights;
}

// n_scenes scenes of n_points points each (scenes.cuh: every buffer below is
// one scene's, laid end to end n_scenes times). pts (n_points, 3), dc
// (n_points / samples, 64), params (kParams,), out (n_points, 4): contiguous
// f32 device buffers, dc 16-byte aligned; with bf16 != 0 also wbf
// (tc::kFwdWeights,), the bf16 forward weights in fragment order (16-byte
// aligned; ignored for f32); res: tiles * kTile * (kResRows f32 or tc::kRows
// bf16) elements of the compute dtype. Returns a cudaError_t.
extern "C" int nerf_flex_train_forward(const float* pts, const float* dc, const float* params,
                                       long long n_params, const void* wbf, long long n_wbf,
                                       float* out, void* res, int n_scenes, long long n_points,
                                       int samples, int bf16, void* stream) {
  if (n_params != kParams || bad_shape(n_scenes, n_points, samples) ||
      (bf16 && (wbf == nullptr || n_wbf != tc::kFwdWeights))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const __nv_bfloat16*>(wbf);
  const cudaError_t err =
      bf16 ? launch_fwd<true>(pts, dc, params, w, out, res, n_scenes, n_points, samples, s)
           : launch_fwd<false>(pts, dc, params, w, out, res, n_scenes, n_points, samples, s);
  return static_cast<int>(err);
}

// n_scenes scenes, as the forward's. g (n_points, 4) f32 cotangent; res from
// the forward; wt the backward weights: (kTParams,) f32 (out, in) matrices,
// or with bf16 != 0 (tc::kBwdWeights,) bf16 fragments, 16-byte aligned;
// scratch: delta (tiles * kDRows * kTile f32) and partial (chunks * kParams
// f32); outputs: grad (kParams,) in the packed parameter layout and ddc
// (n_points / samples, 64). Returns a cudaError_t.
extern "C" int nerf_flex_train_backward(const float* g, const void* res, const void* wt,
                                        long long n_wt, float* delta, float* partial,
                                        float* grad, float* ddc, int n_scenes,
                                        long long n_points, int samples, int bf16,
                                        void* stream) {
  if (n_wt != (bf16 ? tc::kBwdWeights : kTParams) || bad_shape(n_scenes, n_points, samples)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_bwd<true>(g, res, wt, delta, partial, grad, ddc, n_scenes, n_points,
                              samples, s)
           : launch_bwd<false>(g, res, wt, delta, partial, grad, ddc, n_scenes, n_points,
                               samples, s);
  return static_cast<int>(err);
}
