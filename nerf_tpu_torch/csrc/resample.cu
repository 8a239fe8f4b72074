// Inverse-CDF resampling (hierarchical sampling) in one pass, for Hopper (sm_90a).
//
// Replaces nerf_tpu/ops/pallas/resample.py:fused_sample_pdf. Same function
// at the public layout: bin edges (N, M), bin weights (N, M-1) and uniforms
// u (N, S) in [0, 1] -> (N, S) new depths, f32. The chain of the reference's
// sample_pdf: +1e-5 weight floor, pdf = w / sum(w), a zero-prepended
// inclusive CDF, the right-side rank of u in it (searchsorted(right=True)),
// below = max(rank - 1, 0), above = min(rank, M - 1), denom < 1e-5 -> 1, and
// the linear interpolation between the two bin edges. The pdf and the CDF
// never reach device memory.
//
// What bounds it on the card: bytes (each bin, weight, u and output once,
// ~0.75 KB a ray at M = 63, S = 64 with det's shared u row; ~0.03 ms for
// 131072 rays), against a few hundred operations a ray. The design:
//   * one warp per ray, 8 rays a block of 256 threads; a ray's CDF and bin
//     edges sit in shared memory (2 M floats a warp, so M <= 768);
//   * the lanes load the weights and edges coalesced, sum the floored
//     weights (in f64 with shuffles, rounded once to f32) and write the f32
//     pdf = w / sum; lane 0 then turns it into the CDF by a sequential prefix
//     sum accumulated in f64, each entry rounded once to f32. The TPU kernel
//     takes the prefix sum as a triangular matmul on its MXU. A correctly
//     rounded prefix sum of positive terms is non-decreasing, which the
//     binary search relies on, and is the CDF that torch.cumsum gives on the
//     CPU (it accumulates f32 in f64); any f32 scan differs from it only by
//     its own rounding, which moves samples of bins of small pdf by
//     ~rounding * width / pdf;
//   * lane l then takes samples l, l + 32, ...: a binary search for the rank
//     (the TPU kernel's masked max/min planes over samples x bins), two
//     reads of each of CDF and edges, and the guarded interpolation. u need
//     not be sorted; det's linspace row is shared by every ray (row stride 0).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRaysPerBlock = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxBins = 768;  // 8 warps x 2 x 768 floats = 48 KB of shared memory

__global__ void __launch_bounds__(kThreads)
resample_kernel(const float* __restrict__ bins, const float* __restrict__ weights,
                const float* __restrict__ u, long long u_ray_stride,
                float* __restrict__ out, long long n_rays, int m, int samples) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const long long ray = static_cast<long long>(blockIdx.x) * kRaysPerBlock + warp;
  if (ray >= n_rays) return;  // the whole warp leaves together; no block barrier below
  float* cdf = smem + warp * 2 * m;
  float* edge = cdf + m;
  const float* w = weights + ray * (m - 1);

  double sum = 0.0;
  for (int i = lane; i < m - 1; i += 32) sum += static_cast<double>(w[i] + 1e-5f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFullMask, sum, o);
  const float total = __double2float_rn(sum);
  for (int i = lane; i < m - 1; i += 32) cdf[i + 1] = (w[i] + 1e-5f) / total;
  for (int i = lane; i < m; i += 32) edge[i] = bins[ray * m + i];
  __syncwarp();
  if (lane == 0) {
    cdf[0] = 0.f;
    double run = 0.0;
    for (int i = 1; i < m; ++i) {
      run += static_cast<double>(cdf[i]);
      cdf[i] = __double2float_rn(run);
    }
  }
  __syncwarp();

  const float* ur = u + ray * u_ray_stride;
  for (int j = lane; j < samples; j += 32) {
    const float uj = ur[j];
    int lo = 0;  // the rank: the first index whose cdf > uj, in [0, m]
    int hi = m;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cdf[mid] <= uj) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int below = max(lo - 1, 0);
    const int above = min(lo, m - 1);
    const float cdf_below = cdf[below];
    float denom = cdf[above] - cdf_below;
    if (denom < 1e-5f) denom = 1.f;
    const float t = (uj - cdf_below) / denom;
    const float e0 = edge[below];
    out[ray * samples + j] = e0 + t * (edge[above] - e0);
  }
}

}  // namespace

// The largest number of bin edges M the kernel takes.
extern "C" int nerf_resample_max_bins() { return kMaxBins; }

// bins (n_rays, m), weights (n_rays, m - 1), u (n_rays rows of samples
// floats, u_ray_stride apart: samples, or 0 for one row shared by every ray)
// in; out (n_rays, samples): contiguous f32 device buffers. Returns a
// cudaError_t.
extern "C" int nerf_resample(const float* bins, const float* weights, const float* u,
                             long long u_ray_stride, float* out, long long n_rays, int m,
                             int samples, void* stream) {
  if (n_rays <= 0 || samples <= 0 || m < 2 || m > kMaxBins || u_ray_stride < 0 ||
      (n_rays + kRaysPerBlock - 1) / kRaysPerBlock > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (n_rays + kRaysPerBlock - 1) / kRaysPerBlock;
  const size_t smem = static_cast<size_t>(kRaysPerBlock) * 2 * m * sizeof(float);
  resample_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(bins, weights, u, u_ray_stride, out,
                                                         n_rays, m, samples);
  return static_cast<int>(cudaGetLastError());
}
