// The tensor-core building blocks both MLP families' bf16 kernels share
// (paper_tc.cuh for the 8x256 PaperNeRF, flex_tc.cuh for the 4x128
// FlexibleNeRF): the mma.sync and ldmatrix wrappers, and a warp's share of a
// layer over a 64-point tile held in f32 registers.
//
// A tile's activations live in shared memory as bf16, point-major,
// act[point][feature], with a row stride of the widest K plus 8 (the 16-byte
// pad puts the 8 rows an ldmatrix reads on distinct banks). M = the 64
// points, N = a layer's outputs split over the block's warps, K = its inputs
// in steps of 16. B fragments come straight from device memory in fragment
// order (kernels/paper_t.py fragment_order): for k-step ks, warp w and lane
// l, the NT x 4 bf16 that lane l's b0..b3 registers hold, so a warp reads
// 256 x NT contiguous bytes a k-step, one k-step ahead of the products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tcmma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm4(uint32_t* r, const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm4t(uint32_t* r, const bf16* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// A warp's share of a layer over the tile, for a block of kWarps warps and
// activation rows of kStride bf16: acc[mt][nt] is the m16n8 tile of points
// 16 mt .. 16 mt + 15 and outputs warp * 8 NT + 8 nt .. + 7 (the layer has
// 8 NT kWarps outputs).
template <int NT, int kWarps, int kStride>
struct Acc {
  float v[4][NT][4];

  __device__ __forceinline__ Acc() {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[m][n][e] = 0.f;
      }
    }
  }

  // v += A (64 points x 16 ksteps, bf16 rows of `a` with `a_stride`) . B
  // (the fragment-ordered weights at w). kUnroll > 0 unrolls the k-steps
  // that many times (2 in the forwards, whose layers are unrolled too, to
  // fit 128 registers); 0 leaves it to the compiler (the backwards).
  template <int kUnroll = 0>
  __device__ __forceinline__ void mac(const bf16* __restrict__ w, const bf16* a, int a_stride,
                                      int ksteps) {
    constexpr int kU = NT / 2;                   // uint4 of B per lane a k-step
    constexpr int kStep = kWarps * 32 * kU;      // uint4 a k-step
    const int lane = threadIdx.x & 31;
    const uint4* wp = reinterpret_cast<const uint4*>(w) + ((threadIdx.x >> 5) * 32 + lane) * kU;
    // ldmatrix x4 rows: lanes 0-15 points 0-15 at k, lanes 16-31 at k + 8.
    const bf16* ap = a + (lane & 15) * a_stride + (lane >> 4) * 8;
    uint4 cur[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) cur[u] = __ldg(wp + u);
    // One k-step: load the next step's B, multiply with this one's.
    auto step = [&](int ks) {
      uint4 nxt[kU];
      const int kn = ks + 1 < ksteps ? ks + 1 : ks;
#pragma unroll
      for (int u = 0; u < kU; ++u) nxt[u] = __ldg(wp + kn * kStep + u);
      const uint32_t* b = reinterpret_cast<const uint32_t*>(cur);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t af[4];
        ldsm4(af, ap + m * 16 * a_stride + ks * 16);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma(v[m][n], af, b[2 * n], b[2 * n + 1]);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
    };
    if constexpr (kUnroll > 0) {
#pragma unroll (kUnroll > 0 ? kUnroll : 1)
      for (int ks = 0; ks < ksteps; ++ks) step(ks);
    } else {
      for (int ks = 0; ks < ksteps; ++ks) step(ks);
    }
  }

  // The forward epilogue: v = act(v + b[n] (+ dc[ray(p)][n])); dc is (rays,
  // N) f32 (8-byte aligned rows), the ray of tile point p is (tile0 + p) /
  // samples. The bias is read a float at a time: the 4x128 family's packed
  // layout leaves some biases at odd offsets.
  template <bool kRelu>
  __device__ __forceinline__ void bias_act(const float* __restrict__ bias,
                                           const float* __restrict__ dc, long long tile0,
                                           int samples, long long n_points) {
    constexpr int kN = 8 * NT * kWarps;
    const int lane = threadIdx.x & 31;
    const int n0 = (threadIdx.x >> 5) * 8 * NT + 2 * (lane & 3);
    float2 b[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      b[n] = make_float2(__ldg(bias + n0 + 8 * n), __ldg(bias + n0 + 8 * n + 1));
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long gp = tile0 + 16 * m + (lane >> 2) + 8 * h;
        const float* drow = dc != nullptr && gp < n_points ? dc + (gp / samples) * kN : nullptr;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          float2 d = make_float2(0.f, 0.f);
          if (drow != nullptr) d = __ldg(reinterpret_cast<const float2*>(drow + n0 + 8 * n));
          const float y0 = v[m][n][2 * h] + b[n].x + d.x;
          const float y1 = v[m][n][2 * h + 1] + b[n].y + d.y;
          v[m][n][2 * h] = kRelu ? fmaxf(y0, 0.f) : y0;
          v[m][n][2 * h + 1] = kRelu ? fmaxf(y1, 0.f) : y1;
        }
      }
    }
  }

  // Write v rounded to bf16 over the tile `act` once every thread has
  // finished reading the layer's inputs (which may be `act` itself); returns
  // when the new rows are visible to the block.
  __device__ __forceinline__ void write(bf16* act) {
    const int lane = threadIdx.x & 31;
    const int n0 = (threadIdx.x >> 5) * 8 * NT + 2 * (lane & 3);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bf16* row = act + (16 * m + (lane >> 2) + 8 * h) * kStride + n0;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
              __floats2bfloat162_rn(v[m][n][2 * h], v[m][n][2 * h + 1]);
        }
      }
    }
    __syncthreads();
  }
};

}  // namespace tcmma
