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
// ~31 ms (~68%).
//
// Two designs, one per compute dtype, both the whole forward in one launch:
//   * float32 (paper_mlp.cuh's forward_tile, on the FMA pipes): one block of
//     256 threads a tile of 64 points; the encoding (dim x 64 f32), one
//     256 x 64 f32 activation buffer and a two-slot ring of weight slices
//     (cp.async) in dynamic shared memory, ~112 KB at F = 10, two blocks an
//     SM; each thread keeps 8 features x 8 points (4 x 8 at the 128-wide
//     direction branch) in registers, so a layer writes its output back over
//     its input after a barrier;
//   * bfloat16 (paper_wg.cuh's forward, on the tensor cores by wgmma): one
//     persistent, warp-specialised block of 384 threads an SM, in clusters of
//     two; two consumer warpgroups of 64 points each keep every activation in
//     registers, a producer streams the weights through a ring of
//     shared-memory stages by bulk copies multicast to both blocks of the
//     cluster, packed by the wrapper as the stages' swizzled images
//     (kernels/paper_t.py pack_wg_forward); sigma and rgb on FMA.
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
// once, where they become the next layer's input.

#include "paper_mlp.cuh"
#include "paper_wg.cuh"

namespace {

using namespace paper;

template <bool kBf16>
__global__ void __launch_bounds__(kBf16 ? wg::kThreads : kThreads, kBf16 ? 1 : 2)
paper_t_kernel(const float* __restrict__ pts, const float* __restrict__ dc,
               const float* __restrict__ params, const __nv_bfloat16* __restrict__ wbf,
               const Layout L, float* __restrict__ out, long long n_points, int samples,
               int num_freq) {
  extern __shared__ float4 smem[];
  if constexpr (kBf16) {
    wg::forward(pts, dc, params, wbf, L, out, n_points, samples, num_freq,
                reinterpret_cast<unsigned char*>(smem));
  } else {
    forward_tile(pts, dc, params, L, out, nullptr, n_points, samples, num_freq,
                 reinterpret_cast<float*>(smem));
  }
}

cudaError_t launch_f32(const float* pts, const float* dc, const float* params, const Layout& L,
                       float* out, long long n_points, int samples, int num_freq,
                       cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      paper_t_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) err = max_shared_carveout(paper_t_kernel<false>);
  if (err != cudaSuccess) return err;
  const long long tiles = (n_points + kTile - 1) / kTile;
  paper_t_kernel<false><<<static_cast<unsigned int>(tiles), kThreads, smem, stream>>>(
      pts, dc, params, nullptr, L, out, n_points, samples, num_freq);
  return cudaGetLastError();
}

// The persistent bf16 kernel: clusters of wg::kCluster blocks, as many as
// fit on the card at once, at most one a unit of kCluster block tiles.
cudaError_t launch_bf16(const float* pts, const float* dc, const float* params,
                        const __nv_bfloat16* wbf, const Layout& L, float* out, long long n_points,
                        int samples, int num_freq, cudaStream_t stream) {
  const int smem = wg::smem_layout(L.dim).bytes;
  cudaError_t err = cudaFuncSetAttribute(paper_t_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr{};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = wg::kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(wg::kCluster);
  cfg.blockDim = dim3(wg::kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, paper_t_kernel<true>, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  const long long unit = static_cast<long long>(wg::kCluster) * wg::kBlockPoints;
  const long long units = (n_points + unit - 1) / unit;
  cfg.gridDim = dim3(static_cast<unsigned int>(units < clusters ? units : clusters) * wg::kCluster);
  err = cudaLaunchKernelEx(&cfg, paper_t_kernel<true>, pts, dc, params, wbf, L, out, n_points,
                           samples, num_freq);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Number of floats the packed parameter buffer must hold at encoding depth
// num_freq (-1 for a depth the kernel does not take).
extern "C" int nerf_paper_num_params(int num_freq) {
  if (num_freq < 0 || num_freq > kMaxFreq) return -1;
  return make_layout(num_freq).total;
}

// Number of bf16 values of the bf16 kernel's weight image (paper_wg.cuh)
// at encoding depth num_freq (-1 for a depth the kernel does not take).
extern "C" int nerf_paper_wg_weights(int num_freq) {
  if (num_freq < 0 || num_freq > kMaxFreq) return -1;
  return wg::num_weights(enc_dim(num_freq));
}

// pts (n_points, 3), dc (n_points / samples, 128), params
// (nerf_paper_num_params(num_freq),), out (n_points, 4): contiguous f32
// device buffers, dc and params 16-byte aligned; with bf16 != 0 also wbf,
// the bf16 weight image (nerf_paper_wg_weights(num_freq) values, 16-byte
// aligned; ignored for f32). Returns a cudaError_t.
extern "C" int nerf_paper_t_forward(const float* pts, const float* dc, const float* params,
                                    long long n_params, const void* wbf, long long n_wbf,
                                    float* out, long long n_points, int samples, int num_freq,
                                    int bf16, void* stream) {
  if (num_freq < 0 || num_freq > kMaxFreq || samples <= 0 || n_points <= 0 ||
      n_points % samples != 0 || (n_points + kTile - 1) / kTile > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Layout L = make_layout(num_freq);
  if (n_params != L.total || (bf16 && (wbf == nullptr || n_wbf != wg::num_weights(L.dim)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch_bf16(pts, dc, params, static_cast<const __nv_bfloat16*>(wbf), L, out,
                         n_points, samples, num_freq, s)
           : launch_f32(pts, dc, params, L, out, n_points, samples, num_freq, s);
  return static_cast<int>(err);
}
