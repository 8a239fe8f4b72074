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
// written, so the kernel is far above the memory roofline: a 131072 x 128
// chunk is bounded at 312 ms by the f32 FMA peak (67 TFLOP/s) and at 21 ms
// by the bf16 tensor-core peak (989 TFLOP/s). On an H100 80GB HBM3 at 700 W
// the f32 design takes ~460 ms a chunk (~68% of its bound), the bf16 one
// ~63 ms.
//
// Two designs, one per compute dtype, both one block of 256 threads per tile
// of 64 points with the whole forward in one launch:
//   * float32 (paper_mlp.cuh's forward_tile, on the FMA pipes): the encoding
//     (dim x 64 f32), one 256 x 64 f32 activation buffer and a two-slot ring
//     of weight slices (cp.async) in dynamic shared memory, ~112 KB at
//     F = 10, two blocks an SM; each thread keeps 8 features x 8 points (4 x 8
//     at the 128-wide direction branch) in registers, so a layer writes its
//     output back over its input after a barrier;
//   * bfloat16 (paper_tc.cuh's forward_tile, on the tensor cores): the same
//     in-place structure with the tile point-major in bf16 (~43 KB at
//     F = 10), every wide product an mma.sync m16n8k16 with f32 sums, its
//     weights prepared by the wrapper in bf16 fragment order
//     (kernels/paper_t.py pack_tc_forward); sigma and rgb on FMA.
// Both: the skip at layer 4 sums W4[:dim] . enc + W4[dim:] . h3 in one f32
// accumulator, the encoding staying resident from the start; fc_feat has no
// ReLU, sigma is read from feat, dc is added to layers_dir.0's feat-row
// product, then layers_dir.1, .2 and fc_rgb; layers_dir.3 is never read. The
// encoding is the checkpoint's interleaved order, so layer 0 and the skip
// take the checkpoint's rows as they are; the sinusoids are sincosf of
// x * 2^f (exact in f32), without fast math and without the TPU's
// double-angle recurrence.
//
// compute dtype bf16: both matmul operands are bf16 and the sums stay f32
// (the TPU kernel's preferred_element_type=f32); activations are rounded
// once, where they are stored as the next layer's input.

#include "paper_mlp.cuh"
#include "paper_tc.cuh"

namespace {

using namespace paper;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 2)
paper_t_kernel(const float* __restrict__ pts, const float* __restrict__ dc,
               const float* __restrict__ params, const __nv_bfloat16* __restrict__ wbf,
               const Layout L, const tc::FwdLayout T, float* __restrict__ out,
               long long n_points, int samples, int num_freq) {
  extern __shared__ float4 smem[];
  if constexpr (kBf16) {
    auto* enc = reinterpret_cast<__nv_bfloat16*>(smem);
    tc::forward_tile(pts, dc, params, wbf, L, T, out, nullptr, n_points, samples, num_freq, enc,
                     enc + tc::enc_stride(L.dim) * kTile);
  } else {
    forward_tile(pts, dc, params, L, out, nullptr, n_points, samples, num_freq,
                 reinterpret_cast<float*>(smem));
  }
}

template <bool kBf16>
cudaError_t launch(const float* pts, const float* dc, const float* params,
                   const __nv_bfloat16* wbf, const Layout& L, float* out, long long n_points,
                   int samples, int num_freq, cudaStream_t stream) {
  const size_t smem = kBf16 ? tc::fwd_smem_bytes(L.dim) : fwd_smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      paper_t_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && !kBf16) err = max_shared_carveout(paper_t_kernel<kBf16>);
  if (err != cudaSuccess) return err;
  const long long tiles = (n_points + kTile - 1) / kTile;
  paper_t_kernel<kBf16><<<static_cast<unsigned int>(tiles), kThreads, smem, stream>>>(
      pts, dc, params, wbf, L, tc::make_fwd_layout(L.dim), out, n_points, samples, num_freq);
  return cudaGetLastError();
}

}  // namespace

// Number of floats the packed parameter buffer must hold at encoding depth
// num_freq (-1 for a depth the kernel does not take).
extern "C" int nerf_paper_num_params(int num_freq) {
  if (num_freq < 0 || num_freq > kMaxFreq) return -1;
  return make_layout(num_freq).total;
}

// Number of bf16 values of the tensor-core weights (paper_tc.cuh FwdLayout)
// at encoding depth num_freq (-1 for a depth the kernel does not take).
extern "C" int nerf_paper_tc_weights(int num_freq) {
  if (num_freq < 0 || num_freq > kMaxFreq) return -1;
  return tc::make_fwd_layout(enc_dim(num_freq)).total;
}

// pts (n_points, 3), dc (n_points / samples, 128), params
// (nerf_paper_num_params(num_freq),), out (n_points, 4): contiguous f32
// device buffers, dc and params 16-byte aligned; with bf16 != 0 also wbf,
// the bf16 weights in fragment order (nerf_paper_tc_weights(num_freq)
// values, 16-byte aligned; ignored for f32). Returns a cudaError_t.
extern "C" int nerf_paper_t_forward(const float* pts, const float* dc, const float* params,
                                    long long n_params, const void* wbf, long long n_wbf,
                                    float* out, long long n_points, int samples, int num_freq,
                                    int bf16, void* stream) {
  if (num_freq < 0 || num_freq > kMaxFreq || samples <= 0 || n_points <= 0 ||
      n_points % samples != 0 || (n_points + kTile - 1) / kTile > 0x7fffffffLL) {
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
      bf16 ? launch<true>(pts, dc, params, w, L, out, n_points, samples, num_freq, s)
           : launch<false>(pts, dc, params, w, L, out, n_points, samples, num_freq, s);
  return static_cast<int>(err);
}
