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
// First design (right and simple; tensor cores, wgmma and TMA come later):
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHidden = 128;
constexpr int kDirHidden = 64;
constexpr int kFreqXyz = 10;
constexpr int kEnc = 3 + 6 * kFreqXyz;  // 63
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

constexpr size_t kSmemBytes = 2 * kHidden * kTile * sizeof(float);

template <bool kBf16>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// out[j][p] = act(sum_k in[k][p] * W[k][j] + b[j] (+ dc[ray(p)][j])) for the
// tile's kTile points. Thread t computes feature t % OUT for a run of
// kTile / (kThreads / OUT) points.
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

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
mlp_t_kernel(const float* __restrict__ pts, const float* __restrict__ dc,
             const float* __restrict__ params, float* __restrict__ out,
             long long n_points, int samples) {
  extern __shared__ float4 smem[];
  float* buf_a = reinterpret_cast<float*>(smem);
  float* buf_b = buf_a + kHidden * kTile;
  const long long tile0 = static_cast<long long>(blockIdx.x) * kTile;

  // Encoding into buf_a rows 0..62, checkpoint order.
  for (int i = threadIdx.x; i < kTile * 3; i += kThreads) {
    const int p = i / 3;
    const int c = i % 3;
    const float x = tile0 + p < n_points ? pts[tile0 * 3 + i] : 0.f;
    buf_a[c * kTile + p] = rnd<kBf16>(x);
    float scale = 1.f;
#pragma unroll
    for (int f = 0; f < kFreqXyz; ++f) {
      float s, co;
      sincosf(x * scale, &s, &co);
      buf_a[(3 + 6 * f + c) * kTile + p] = rnd<kBf16>(s);
      buf_a[(6 + 6 * f + c) * kTile + p] = rnd<kBf16>(co);
      scale *= 2.f;
    }
  }
  __syncthreads();

  // layer1 has no activation (FlexibleNeRFModel.apply); the trunk is ReLU.
  dense<kHidden, false, kBf16>(params + kOffW1, params + kOffB1, kEnc, buf_a,
                               buf_b, nullptr, tile0, samples, n_points);
  __syncthreads();
  dense<kHidden, true, kBf16>(params + kOffWx, params + kOffWx + kHidden * kHidden,
                              kHidden, buf_b, buf_a, nullptr, tile0, samples, n_points);
  __syncthreads();
  dense<kHidden, true, kBf16>(params + kOffWx + kLayerX,
                              params + kOffWx + kLayerX + kHidden * kHidden,
                              kHidden, buf_a, buf_b, nullptr, tile0, samples, n_points);
  __syncthreads();
  dense<kHidden, true, kBf16>(params + kOffWx + 2 * kLayerX,
                              params + kOffWx + 2 * kLayerX + kHidden * kHidden,
                              kHidden, buf_b, buf_a, nullptr, tile0, samples, n_points);
  __syncthreads();

  // Trunk output in buf_a: feat = relu(fc_feat) into buf_b; sigma (raw) per point.
  dense<kHidden, true, kBf16>(params + kOffWf, params + kOffBf, kHidden, buf_a,
                              buf_b, nullptr, tile0, samples, n_points);
  if (threadIdx.x < kTile) {
    const int p = threadIdx.x;
    float acc = 0.f;
    for (int k = 0; k < kHidden; ++k) {
      acc = fmaf(rnd<kBf16>(__ldg(params + kOffWa + k)), buf_a[k * kTile + p], acc);
    }
    if (tile0 + p < n_points) out[(tile0 + p) * 4 + 3] = acc + __ldg(params + kOffBa);
  }
  __syncthreads();

  // Direction layer: relu(feat @ W_dir[:128] + dc[ray] + b) into buf_a rows 0..63.
  dense<kDirHidden, true, kBf16>(params + kOffWd, params + kOffBd, kHidden, buf_b,
                                 buf_a, dc, tile0, samples, n_points);
  __syncthreads();

  // fc_rgb: one (channel, point) pair per thread step.
  for (int i = threadIdx.x; i < 3 * kTile; i += kThreads) {
    const int c = i / kTile;
    const int p = i % kTile;
    float acc = 0.f;
    for (int k = 0; k < kDirHidden; ++k) {
      acc = fmaf(rnd<kBf16>(__ldg(params + kOffWr + k * 3 + c)), buf_a[k * kTile + p], acc);
    }
    if (tile0 + p < n_points) out[(tile0 + p) * 4 + c] = acc + __ldg(params + kOffBr + c);
  }
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
