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
// keeping the activations out of device memory and the FMA units fed. This
// design runs at ~24 TFLOP/s on an H100 SXM (700 W), about 35% of its f32
// FMA peak: 3 blocks of 64 KB fit an SM, and their 12 warps hide little
// latency. Tensor cores are the next step.
//
// First design (right and simple; tensor cores, wgmma and TMA come later),
// in flex_mlp.cuh's forward_tile, which the training forward (flex_train.cu)
// runs too:
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
//
// compute dtype bf16: both matmul operands are rounded to bf16 and the sums
// stay f32 (the TPU kernel's preferred_element_type=f32); activations are
// rounded once, where they are stored as the next layer's input.

#include "flex_mlp.cuh"

namespace {

using namespace flex;

constexpr size_t kSmemBytes = 2 * kHidden * kTile * sizeof(float);

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
mlp_t_kernel(const float* __restrict__ pts, const float* __restrict__ dc,
             const float* __restrict__ params, float* __restrict__ out,
             long long n_points, int samples) {
  extern __shared__ float4 smem[];
  float* buf_a = reinterpret_cast<float*>(smem);
  forward_tile<kBf16, float>(pts, dc, params, out, nullptr, n_points, samples, buf_a,
                             buf_a + kHidden * kTile);
}

template <bool kBf16>
cudaError_t launch(const float* pts, const float* dc, const float* params,
                   float* out, long long n_points, int samples,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_t_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return err;
  const long long tiles = (n_points + kTile - 1) / kTile;
  mlp_t_kernel<kBf16><<<static_cast<unsigned int>(tiles), kThreads, kSmemBytes,
                        stream>>>(pts, dc, params, out, n_points, samples);
  return cudaGetLastError();
}

}  // namespace

// Number of floats the packed parameter buffer must hold.
extern "C" int nerf_mlp_t_num_params() { return kParams; }

// pts (n_points, 3), dc (n_points / samples, 64), params (kParams,),
// out (n_points, 4): contiguous f32 device buffers. Returns a cudaError_t.
extern "C" int nerf_mlp_t_forward(const float* pts, const float* dc,
                                  const float* params, long long n_params,
                                  float* out, long long n_points, int samples,
                                  int bf16, void* stream) {
  if (n_params != kParams || samples <= 0 || n_points <= 0 ||
      n_points % samples != 0 ||
      (n_points + kTile - 1) / kTile > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<true>(pts, dc, params, out, n_points, samples, s)
           : launch<false>(pts, dc, params, out, n_points, samples, s);
  return static_cast<int>(err);
}
