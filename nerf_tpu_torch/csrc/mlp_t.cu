// Fused positional encoding + 4x128 FlexibleNeRF forward, for Hopper (sm_90a).
//
// Replaces nerf_tpu/ops/pallas/mlp_t.py:fused_mlp_t. Same function at the
// public layout: pts (N, S, 3) f32, the per-ray direction contribution
// dc = enc(viewdirs) @ W_dir[128:] (N, 64) f32 (computed by the wrapper, as
// the TPU version computes it outside its kernel) -> raw (N, S, 4) f32
// [r, g, b, sigma].
//
// What bounds it on the card: arithmetic. One point costs ~82k multiply-adds
// (63x128 + 3x128x128 + 128x129 + 128x64 + 64x3) against 12 B read and 16 B
// written, so the kernel is far above the memory roofline; what matters is
// keeping the activations out of device memory and the multipliers fed.
//
// compute dtype f32: flex_mlp.cuh's forward_tile on the FMA pipes, which the
// training forward (flex_train.cu) runs too:
//   * one block of 128 threads per tile of kTile = 64 points;
//   * the tile's activations ping-pong between two feature-major shared
//     buffers act[feature][point] of 128 x 64 f32 (64 KB in all, so dynamic
//     shared memory with cudaFuncSetAttribute);
//   * thread j computes output feature j of a dense layer for a run of
//     points, accumulating in registers: per input feature k it reads one
//     weight W[k][j] (neighbouring threads, neighbouring addresses; the
//     330 KB parameter buffer stays L2/L1 resident) and the run's
//     activations act[k][p..] as float4 broadcasts from shared memory;
//   * the encoding is written in the checkpoint's interleaved order
//     [x | sin f0 | cos f0 | sin f1 | ...], so layer 1 takes the checkpoint's
//     rows as they are; the sinusoids are sincosf of x * 2^f (exact in f32),
//     without fast math and without the TPU's double-angle recurrence;
//   * fc_alpha is a 1-wide dot product per point, fc_rgb 3 per point, done
//     by one thread each; the ragged tail of the last tile is masked.
// It runs at ~24 TFLOP/s on an H100 SXM (700 W), about 35% of the f32 FMA
// peak: 3 blocks of 64 KB fit an SM, and their 12 warps hide little latency.
//
// compute dtype bf16: flex_tc.cuh's forward_tile on the tensor cores
// (mma.sync m16n8k16, bf16 operands, f32 sums, bf16 point-major tiles of
// 17 KB), its weights a bf16 copy in fragment order that the wrapper packs
// once per call (kernels/mlp.py pack_tc_forward). Activations are rounded
// once, where they are stored as the next layer's input, as the TPU kernel's
// preferred_element_type=f32 products with bf16 operands do.

#include "flex_mlp.cuh"
#include "flex_tc.cuh"

namespace {

using namespace flex;

constexpr size_t kSmemBytes = 2 * kHidden * kTile * sizeof(float);

template <bool kBf16>
__device__ __forceinline__ void mlp_t_tile(const float* __restrict__ pts,
                                           const float* __restrict__ dc,
                                           const float* __restrict__ params,
                                           const __nv_bfloat16* __restrict__ wbf,
                                           float* __restrict__ out, long long n_points,
                                           int samples) {
  extern __shared__ float4 smem[];
  if constexpr (kBf16) {
    auto* enc = reinterpret_cast<__nv_bfloat16*>(smem);
    tc::forward_tile(pts, dc, params, wbf, out, nullptr, n_points, samples, enc,
                     enc + tc::kEncStride * kTile);
  } else {
    float* buf_a = reinterpret_cast<float*>(smem);
    forward_tile<false>(pts, dc, params, out, nullptr, n_points, samples, buf_a,
                        buf_a + kHidden * kTile);
  }
}

// The f32 instance keeps the FMA design's bounds; the bf16 one is held to
// 128 registers, so that 4 blocks share an SM.
template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
mlp_t_kernel(const float* __restrict__ pts, const float* __restrict__ dc,
             const float* __restrict__ params, const __nv_bfloat16* __restrict__ wbf,
             float* __restrict__ out, long long n_points, int samples) {
  mlp_t_tile<kBf16>(pts, dc, params, wbf, out, n_points, samples);
}

template <>
__global__ void __launch_bounds__(kThreads, 4)
mlp_t_kernel<true>(const float* __restrict__ pts, const float* __restrict__ dc,
                   const float* __restrict__ params, const __nv_bfloat16* __restrict__ wbf,
                   float* __restrict__ out, long long n_points, int samples) {
  mlp_t_tile<true>(pts, dc, params, wbf, out, n_points, samples);
}

template <bool kBf16>
cudaError_t launch(const float* pts, const float* dc, const float* params,
                   const __nv_bfloat16* wbf, float* out, long long n_points, int samples,
                   cudaStream_t stream) {
  const size_t smem = kBf16 ? tc::kFwdSmem : kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_t_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = (n_points + kTile - 1) / kTile;
  mlp_t_kernel<kBf16><<<static_cast<unsigned int>(tiles), kThreads, smem,
                        stream>>>(pts, dc, params, wbf, out, n_points, samples);
  return cudaGetLastError();
}

}  // namespace

// Number of floats the packed parameter buffer must hold, and of bf16 values
// in the tensor-core forward's weights.
extern "C" int nerf_mlp_t_num_params() { return kParams; }
extern "C" int nerf_mlp_t_tc_weights() { return tc::kFwdWeights; }

// pts (n_points, 3), dc (n_points / samples, 64), params (kParams,),
// out (n_points, 4): contiguous f32 device buffers, dc 8-byte aligned; with
// bf16 != 0 also wbf (tc::kFwdWeights,), the bf16 weights in fragment order,
// 16-byte aligned (ignored for f32). Returns a cudaError_t.
extern "C" int nerf_mlp_t_forward(const float* pts, const float* dc,
                                  const float* params, long long n_params,
                                  const void* wbf, long long n_wbf,
                                  float* out, long long n_points, int samples,
                                  int bf16, void* stream) {
  if (n_params != kParams || samples <= 0 || n_points <= 0 ||
      (bf16 && (wbf == nullptr || n_wbf != tc::kFwdWeights)) ||
      n_points % samples != 0 ||
      (n_points + kTile - 1) / kTile > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const __nv_bfloat16*>(wbf);
  const cudaError_t err =
      bf16 ? launch<true>(pts, dc, params, w, out, n_points, samples, s)
           : launch<false>(pts, dc, params, w, out, n_points, samples, s);
  return static_cast<int>(err);
}
