// Fused positional encoding + 8x256 PaperNeRF forward, for Hopper (sm_90a).
//
// Replaces nerf_tpu/ops/pallas/paper_t.py:fused_paper_mlp_t. Same function at
// the public layout: pts (N, S, 3) f32, the per-ray direction contribution
// dc = enc(viewdirs) @ W_dir[256:] (N, 128) f32 (computed by the wrapper, as
// the TPU version computes it outside its kernel) -> raw (N, S, 4) f32
// [r, g, b, sigma]. The encoding depth F is a runtime argument (0..16), not
// a pin: configs/lego_paper.yml uses 10, the JAX kernel's default is 6.
//
// What bounds it on the card: arithmetic. One point costs 622,720
// multiply-adds at F = 10 (63x256 + 3x256x256 + 319x256 + 3x256x256 +
// 256x256 + 256 + 256x128 + 2x128x128 + 128x3) against 12 B read and 16 B
// written, so the kernel is far above the memory roofline: 67 TFLOP/s of f32
// FMA on an H100 SXM bounds a 131072 x 128 chunk at 312 ms; bf16 operands
// could run on the tensor cores at 989 TFLOP/s (21 ms), which this first
// design does not use.
//
// Design (right and simple first; tensor cores, wgmma and TMA come later),
// in paper_mlp.cuh's forward_tile, which the training forward
// (paper_train.cu) runs too:
//   * one block of 256 threads per tile of 64 points; the encoding (dim x 64
//     f32) and one 256 x 64 f32 activation buffer in dynamic shared memory,
//     ~80 KB at F = 10, so two blocks an SM;
//   * a dense layer keeps each thread's 4 features x 16 points (8 at the
//     128-wide direction branch) in registers, so the layer writes its
//     output back over its input after a barrier: no ping-pong buffer;
//   * the skip at layer 4 is two products into one f32 accumulator,
//     W4[:dim] . enc + W4[dim:] . h3, the encoding staying resident from the
//     start;
//   * fc_feat has no ReLU, sigma is read from feat (one 256-long dot per
//     point), dc is added to layers_dir.0's feat-row product, then
//     layers_dir.1, .2 and fc_rgb; layers_dir.3 is never read;
//   * the encoding is written in the checkpoint's interleaved order, so
//     layer 0 and the skip take the checkpoint's rows as they are; the
//     sinusoids are sincosf of x * 2^f (exact in f32), without fast math and
//     without the TPU's double-angle recurrence.
//
// compute dtype bf16: both matmul operands are rounded to bf16 and the sums
// stay f32 (the TPU kernel's preferred_element_type=f32); activations are
// rounded once, where they are stored as the next layer's input.

#include "paper_mlp.cuh"

namespace {

using namespace paper;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
paper_t_kernel(const float* __restrict__ pts, const float* __restrict__ dc,
               const float* __restrict__ params, const Layout L, float* __restrict__ out,
               long long n_points, int samples, int num_freq) {
  extern __shared__ float4 smem[];
  float* enc = reinterpret_cast<float*>(smem);
  forward_tile<kBf16, float>(pts, dc, params, L, out, nullptr, n_points, samples, num_freq, enc,
                             enc + L.dim * kTile);
}

template <bool kBf16>
cudaError_t launch(const float* pts, const float* dc, const float* params, const Layout& L,
                   float* out, long long n_points, int samples, int num_freq,
                   cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      paper_t_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = (n_points + kTile - 1) / kTile;
  paper_t_kernel<kBf16><<<static_cast<unsigned int>(tiles), kThreads, smem, stream>>>(
      pts, dc, params, L, out, n_points, samples, num_freq);
  return cudaGetLastError();
}

}  // namespace

// Number of floats the packed parameter buffer must hold at encoding depth
// num_freq (-1 for a depth the kernel does not take).
extern "C" int nerf_paper_num_params(int num_freq) {
  if (num_freq < 0 || num_freq > kMaxFreq) return -1;
  return make_layout(num_freq).total;
}

// pts (n_points, 3), dc (n_points / samples, 128), params
// (nerf_paper_num_params(num_freq),), out (n_points, 4): contiguous f32
// device buffers, dc and params 16-byte aligned. Returns a cudaError_t.
extern "C" int nerf_paper_t_forward(const float* pts, const float* dc, const float* params,
                                    long long n_params, float* out, long long n_points,
                                    int samples, int num_freq, int bf16, void* stream) {
  if (num_freq < 0 || num_freq > kMaxFreq || samples <= 0 || n_points <= 0 ||
      n_points % samples != 0 || (n_points + kTile - 1) / kTile > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout L = make_layout(num_freq);
  if (n_params != L.total) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<true>(pts, dc, params, L, out, n_points, samples, num_freq, s)
           : launch<false>(pts, dc, params, L, out, n_points, samples, num_freq, s);
  return static_cast<int>(err);
}
