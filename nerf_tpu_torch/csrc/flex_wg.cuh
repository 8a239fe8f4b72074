// Hopper device code of the bf16 4x128 FlexibleNeRF render forward: the bf16
// instance of mlp_t.cu's mlp_t_kernel (#1), on wgmma. flex_tc.cuh's mma.sync
// tile stays the body of the other bf16 4x128 kernels (#2, #3, #7 and #8's
// training forward), which write residual rows or have layouts of their own;
// this body shares no logic with it, only wg_ptx.cuh's PTX wrappers with
// paper_wg.cuh.
//
// What bounds it: arithmetic. A point costs 83,840 multiply-adds against 28
// bytes of input and output, so only the tensor cores' rate limits it: a
// 131072 x 128 chunk is bounded at 2.79 ms by 989 TFLOP/s. The mma.sync tile
// takes ~11.4 ms (24%): its B fragments stream from L2 (~18%), its sincosf
// sits serially at each tile's start (~8%), and mma.sync's issue rate and
// per-layer barriers take the rest. This body takes ~5.5 ms (~50%) on an
// NVIDIA H100 80GB HBM3 at 700 W (PERF.md's kernel table has the runs).
//
// Design (one persistent block of 512 threads an SM, 64-point tiles walked
// with the grid's stride):
//   * Resident weights. The 82,240 bf16 weights are packed by the wrapper as
//     wgmma's shared-memory images (kernels/mlp.py pack_wg_forward): each wide
//     layer (out, in) in 64-column K slices of N rows of 128 bytes, K-major,
//     16-byte chunks swizzled as the 128-byte-swizzle descriptor reads them.
//     Bulk copies (cp.async.bulk on an mbarrier) put the wide layers' 160 KB
//     in shared memory once a block; they stay for the launch. No weight
//     byte crosses L2 after that, and there is no weight ring.
//   * Warp specialised on the encoding: kProducers producer warpgroups
//     (setmaxnreg kProducerRegs) encode the next tiles' points into a ring of
//     swizzled 64 x 64 bf16 slabs, kSlabsPer a consumer, each on a full /
//     empty mbarrier pair, so sincosf overlaps the products. Each sincosf
//     sits behind its own slow-path branch, so a thread's run serially; one
//     producer warpgroup took ~5,400 cycles a tile and held three consumers
//     to 42% of the bound (clock64 probes), two keep two consumers fed.
//     kConsumers consumer warpgroups (setmaxnreg kConsumerRegs) each run
//     tile c of every unit of kConsumers tiles. More than 512 threads do not
//     start: setmaxnreg only moves registers within the block's launch-time
//     allocation, which 640 threads cap at 96 each.
//   * Every wide layer is wgmma m64nNk16 with f32 sums: layer1 (N = 128, A
//     from the slab, K = 64), layers_xyz.0 .. .2 and fc_feat (N = 128), the
//     direction layer (N = 64, + the ray's dc row in the epilogue). After
//     layer1, A comes from registers: a layer's accumulator, biased, ReLU'd
//     and rounded to bf16 (one cvt.rn.relu a pair), is the next layer's A
//     fragment (the m64nN accumulator's n8 blocks 2k, 2k + 1 hold A's k-th
//     16-deep slice), so activations never touch shared memory and a layer
//     needs no barrier. A layer's biases (and the direction layer's dc terms)
//     are loaded while its products run.
//   * Turns: the consumers issue their layers' products in a fixed rotation
//     (named barriers 1 .. kConsumers), so each one's epilogue and heads
//     overlap the other's products; the next tile's layer1 is issued before
//     this tile's rgb is summed.
//   * fc_alpha (128 -> 1) and fc_rgb (64 -> 3) stay on FMA in f32 from the
//     rounded activations; sigma is read from h3 before fc_feat replaces it.
//   * No call anywhere in the kernel: a 64-bit division is a call to a
//     library routine, and ptxas then serialises every wgmma (ray_of).
//
// Numbers, bitwise those of flex_tc.cuh's tile: bf16 operands, f32 sums in
// its k order (each 16-deep product added to the f32 sums in turn); a
// layer's sums + bias (+ dc), ReLU but at layer1, rounded once; the heads
// sum in head_dot's order: the columns 4j + 2e, 4j + 2e + 1 in one fmaf
// chain for each e, the two chains added, + bias; the encoding is sincosf of
// x * 2^f without fast math, rounded once, column 63 zero.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "flex_mlp.cuh"
#include "wg_ptx.cuh"

namespace flex {
namespace wg {

using namespace wgptx;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                            // consumer warpgroups a block
constexpr int kProducers = 2;                            // producer warpgroups a block
constexpr int kRows = 64;                                // points a tile: wgmma's M
constexpr int kThreads = (kConsumers + kProducers) * 128;
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs =
    ((65536 - 128 * kProducers * kProducerRegs) / (128 * kConsumers)) & ~7;
constexpr int kSlabsPer = 2;                             // encoding slabs a consumer
constexpr int kSlabs = kConsumers * kSlabsPer;
constexpr int kEncK = 64;                                // kEnc padded to 16
constexpr int kSlabBytes = kRows * kEncK * 2;            // 8 KB

// The weight image (bf16 values): the wide layers' swizzled slices, (out,
// in), in the order the kernel reads them, then fc_alpha (128) and fc_rgb
// (3, 64) plain.
constexpr int kW1 = 0;                                   // layer1, 128 x 64
constexpr int kWx0 = kW1 + kHidden * kEncK;              // layers_xyz.0 .. .2, 128 x 128
constexpr int kWf = kWx0 + 3 * kHidden * kHidden;        // fc_feat
constexpr int kWd = kWf + kHidden * kHidden;             // layers_dir.0's feat rows, 64 x 128
constexpr int kWa = kWd + kDirHidden * kHidden;          // fc_alpha
constexpr int kWr = kWa + kHidden;                       // fc_rgb
constexpr int kNumWeights = kWr + 3 * kDirHidden;        // 82240
constexpr int kWideBytes = kWa * 2;                      // 163840

// The f32 copies a block keeps (floats): the biases, and the heads' bf16
// weights as f32, each permuted so that a thread reads the four it needs at
// once as a float4 (bias_col, head_col).
constexpr int kFB1 = 0;
constexpr int kFBx = kFB1 + kHidden;                     // layers_xyz.i bias at kFBx + 128 i
constexpr int kFBf = kFBx + 3 * kHidden;
constexpr int kFBd = kFBf + kHidden;
constexpr int kFWa = kFBd + kDirHidden;
constexpr int kFWr = kFWa + kHidden;                     // fc_rgb row c at kFWr + 64 c
constexpr int kFBa = kFWr + 3 * kDirHidden;
constexpr int kFBr = kFBa + 1;
constexpr int kF32Floats = kFBr + 3;                     // 1028

// Dynamic shared memory (bytes from a 1024-aligned base): the weights, the
// slabs, the f32 copies, then the barriers: the weights', full[kSlabs],
// empty[kSlabs].
constexpr int kSmemEnc = kWideBytes;
constexpr int kSmemF32 = kSmemEnc + kSlabs * kSlabBytes;
constexpr int kSmemBars = (kSmemF32 + kF32Floats * 4 + 7) & ~7;
constexpr int kSmemBytes = kSmemBars + (1 + 2 * kSlabs) * 8 + 1024;   // + the base's alignment
static_assert(kSmemBytes <= 232448, "shared memory a block can have");
static_assert((kConsumers * kConsumerRegs + kProducers * kProducerRegs) * 128 <= 65536,
              "registers");

__device__ __forceinline__ void arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// `bytes` from device memory into the block's shared memory at dst,
// completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The consumers' turns at issuing a layer's products: consumer w waits on
// named barrier 1 + w, then lets the next one go.
struct Turns {
  int wg;
  __device__ __forceinline__ void wait() const { named_sync(1 + wg, 256); }
  __device__ __forceinline__ void pass() const {
    named_arrive(1 + (wg + 1) % kConsumers, 256);
  }
};

// Half H of a point's encoding row, columns 32 H .. 32 H + 31, from its
// coordinates x: [x | sin f0 | cos f0 | ...] as the checkpoint orders it,
// sincosf of x * 2^f, column 63 zero; rounded to bf16 and stored as the
// row's four 16-byte chunks 4 H .. 4 H + 3, chunk j at (j ^ swz) of `row`.
// Half 1 takes f4's cosine of the third coordinate (column 32) itself.
template <int H>
__device__ __forceinline__ void encode_half(const float (&x)[3], unsigned char* row, int swz) {
  float v[32];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (H == 0) v[c] = x[c];
  }
#pragma unroll
  for (int f = 0; f < kFreqXyz; ++f) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int ks = 3 + 6 * f + c - 32 * H;
      const int kc = 6 + 6 * f + c - 32 * H;
      if ((ks >= 0 && ks < 32) || (kc >= 0 && kc < 32)) {
        float s, co;
        sincosf(x[c] * static_cast<float>(1 << f), &s, &co);
        if (ks >= 0 && ks < 32) v[ks] = s;
        if (kc >= 0 && kc < 32) v[kc] = co;
      }
    }
  }
  if (H == 1) v[31] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint4 u =
        make_uint4(pack_bf16(v[8 * j], v[8 * j + 1]), pack_bf16(v[8 * j + 2], v[8 * j + 3]),
                   pack_bf16(v[8 * j + 4], v[8 * j + 5]), pack_bf16(v[8 * j + 6], v[8 * j + 7]));
    *reinterpret_cast<uint4*>(row + (((4 * H + j) ^ swz) << 4)) = u;
  }
}

// The encoding of the tile's 64 points from p0 into `slab` (rows of 128
// bytes), by the producer's 128 threads (t): thread t writes half t / 64 of
// point t % 64's row. Points past n_points encode x = 0.
__device__ __forceinline__ void encode(const float* __restrict__ pts, long long p0,
                                       long long n_points, unsigned char* slab, int t) {
  const int p = t & (kRows - 1);
  float x[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) x[c] = p0 + p < n_points ? __ldg(pts + (p0 + p) * 3 + c) : 0.f;
  if (t < kRows) {
    encode_half<0>(x, slab + p * 128, p & 7);
  } else {
    encode_half<1>(x, slab + p * 128, p & 7);
  }
}

// Where a layer's bias and a head's weights lie in their f32 copies: the
// float4 at 16 k + 4 q holds bias columns c, c + 1, c + 8, c + 9 with c =
// 16 k + 2 q (the thread's columns of A's k-th slice); the float4 at 16 k +
// 8 g + 4 e holds head columns c, c + 1, c + 4, c + 5 with c = 16 k + 8 g +
// 2 e (a step of the heads' chains). Position j holds column ..._col(j).
__device__ __forceinline__ int bias_col(int j) {
  return (j & ~15) + 2 * ((j >> 2) & 3) + (j & 1) + 8 * ((j >> 1) & 1);
}
__device__ __forceinline__ int head_col(int j) {
  return (j & ~7) + 2 * ((j >> 2) & 1) + (j & 1) + 4 * ((j >> 1) & 1);
}

// The thread's biases of an N-wide layer, from their permuted copy.
template <int N>
__device__ __forceinline__ void load_bias(const float* bias, float4 (&b)[N / 16]) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k) {
    b[k] = *reinterpret_cast<const float4*>(bias + 16 * k + 4 * (threadIdx.x & 3));
  }
}

// The thread's terms of its rows' dc rows in the direction layer (dc0 / dc1
// null: a row past the points, which adds 0, as the mma.sync tile does):
// e[k] = (row r at c, c + 1, row r + 8 at c, c + 1), e[4 + k] the same at
// c + 8, c = 16 k + 2 (lane % 4).
__device__ __forceinline__ void load_dc(const float* __restrict__ dc0,
                                        const float* __restrict__ dc1, float4 (&e)[8]) {
  const int q = threadIdx.x & 3;
  const float2 zero = make_float2(0.f, 0.f);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int c = 16 * (k & 3) + 2 * q + 8 * (k >> 2);
    const float2 e0 = dc0 != nullptr ? __ldg(reinterpret_cast<const float2*>(dc0 + c)) : zero;
    const float2 e1 = dc1 != nullptr ? __ldg(reinterpret_cast<const float2*>(dc1 + c)) : zero;
    e[k] = make_float4(e0.x, e0.y, e1.x, e1.y);
  }
}

// The epilogue of an N-wide layer: a = bf16(act(d + bias (+ dc))), the next
// layer's A fragments, from the biases b (load_bias) and with kDc the dc
// terms e (load_dc). The thread's rows are r = 16 warp + lane / 4 and
// r + 8; accumulator n8 block j holds columns 8 j + 2 (lane % 4) + {0, 1},
// d[4 j] (r), d[4 j + 2] (r + 8); A's k-th slice is blocks 2 k and 2 k + 1.
template <int N, bool kRelu, bool kDc>
__device__ __forceinline__ void epilogue(const float (&d)[N / 2], const float4 (&b)[N / 16],
                                         uint32_t (&a)[8][4], const float4* e = nullptr) {
#pragma unroll
  for (int k = 0; k < N / 16; ++k) {
    float v[8] = {d[8 * k] + b[k].x,     d[8 * k + 1] + b[k].y, d[8 * k + 2] + b[k].x,
                  d[8 * k + 3] + b[k].y, d[8 * k + 4] + b[k].z, d[8 * k + 5] + b[k].w,
                  d[8 * k + 6] + b[k].z, d[8 * k + 7] + b[k].w};
    if constexpr (kDc) {
      const float4 lo = e[k], hi = e[4 + k];
      v[0] += lo.x, v[1] += lo.y, v[2] += lo.z, v[3] += lo.w;
      v[4] += hi.x, v[5] += hi.y, v[6] += hi.z, v[7] += hi.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[k][i] = kRelu ? pack_bf16_relu(v[2 * i], v[2 * i + 1])
                      : pack_bf16(v[2 * i], v[2 * i + 1]);
    }
  }
}

// h . w for the thread's row over the 16 KS columns of the rounded
// activation a, for each of the NH heads w[h] (f32 in shared memory), in
// flex_tc.cuh's head_dot order: lane q holds columns 16 k + 2 q + {0, 1} and
// 16 k + 8 + 2 q + {0, 1} of rows r and r + 8; lane q sums row r (q < 2) or
// r + 8 over the columns 4 j + 2 (q % 2) + {0, 1} in one fmaf chain, the
// columns of its partner q ^ 2 by shuffle, and the chains of q and q ^ 1 are
// added. The sums come out complete in both lanes of a row.
template <int KS, int NH>
__device__ __forceinline__ void heads(const uint32_t (&a)[8][4], const float* const (&w)[NH],
                                      float (&out)[NH]) {
  const int q = threadIdx.x & 3;
  const bool hi = q >= 2;
  const int e = 2 * (q & 1);
  float s[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) s[h] = 0.f;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
#pragma unroll
    for (int g = 0; g < 2; ++g) {
      const uint32_t lo_row = a[k][2 * g], hi_row = a[k][2 * g + 1];
      const uint32_t other = __shfl_xor_sync(0xffffffffu, hi ? lo_row : hi_row, 2);
      const float2 x0 = unpack_bf16(hi ? other : lo_row);    // columns c, c + 1
      const float2 x1 = unpack_bf16(hi ? hi_row : other);    // columns c + 4, c + 5
#pragma unroll
      for (int h = 0; h < NH; ++h) {   // columns c, c + 1, c + 4, c + 5 (head_col)
        const float4 wv = *reinterpret_cast<const float4*>(w[h] + 16 * k + 8 * g + 2 * e);
        s[h] = fmaf(x0.x, wv.x, s[h]);
        s[h] = fmaf(x0.y, wv.y, s[h]);
        s[h] = fmaf(x1.x, wv.z, s[h]);
        s[h] = fmaf(x1.y, wv.w, s[h]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < NH; ++h) out[h] = s[h] + __shfl_xor_sync(0xffffffffu, s[h], 1);
}

// Issue a layer's products on the previous one's activation held in a:
// d = h . W^T, W's slices from the resident image at `wsm` (N rows of 128
// bytes a slice); finish_layer waits for them.
template <int N>
__device__ __forceinline__ void issue_layer(const Turns& turns, float (&d)[N / 2],
                                            uint32_t (&a)[8][4], uint32_t wsm) {
  turns.wait();
  pin(d);
  pin(a);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint64_t db = sw128_desc(wsm + (k >> 2) * N * 128);
    mma_rs<N>(d, a[k], db + 2 * (k & 3), k > 0);
  }
  wgmma_commit();
  turns.pass();
}

template <int N>
__device__ __forceinline__ void finish_layer(float (&d)[N / 2], uint32_t (&a)[8][4]) {
  wgmma_wait<0>();
  pin(d);
  pin(a);
}

// The ray of point g, g / samples, without a call: in 32 bits where g fits,
// else by restoring division over g's bits. (A 64-bit division is a call to
// a library routine, and a call anywhere in a kernel makes ptxas serialise
// every wgmma in it.)
__device__ __forceinline__ long long ray_of(long long g, int samples) {
  const unsigned long long s = static_cast<unsigned int>(samples);
  if (g < 0x100000000LL) return static_cast<uint32_t>(g) / static_cast<uint32_t>(samples);
  unsigned long long q = 0, rem = 0;
  for (int b = 63 - __clzll(g); b >= 0; --b) {
    rem = (rem << 1) | ((static_cast<unsigned long long>(g) >> b) & 1);
    q <<= 1;
    if (rem >= s) {
      rem -= s;
      q |= 1;
    }
  }
  return static_cast<long long>(q);
}

// The whole forward: mlp_t.cu's bf16 mlp_t_kernel. Biases from the f32
// parameters (flex_mlp.cuh's layout), weights from the image w
// (pack_wg_forward); `smem_raw` the block's dynamic shared memory
// (kSmemBytes).
__device__ __forceinline__ void forward(const float* __restrict__ pts, const float* __restrict__ dc,
                                        const float* __restrict__ params,
                                        const bf16* __restrict__ w, float* __restrict__ out,
                                        long long n_points, int samples,
                                        unsigned char* smem_raw) {
  // Offset from the dynamic shared array itself, so that the compiler keeps
  // every access below in the shared state space.
  unsigned char* smem = smem_raw + ((1024u - (saddr(smem_raw) & 1023u)) & 1023u);
  float* f32 = reinterpret_cast<float*>(smem + kSmemF32);
  const uint32_t wsm = saddr(smem);
  const uint32_t wbar = saddr(smem + kSmemBars);
  const uint32_t full = wbar + 8;
  const uint32_t empty = full + 8 * kSlabs;

  for (int i = threadIdx.x; i < kF32Floats; i += kThreads) {
    float v;
    if (i < kFBx) {
      v = __ldg(params + kOffB1 + bias_col(i));
    } else if (i < kFBf) {
      const int l = (i - kFBx) / kHidden;
      v = __ldg(params + kOffWx + l * kLayerX + kHidden * kHidden +
                bias_col((i - kFBx) % kHidden));
    } else if (i < kFBd) {
      v = __ldg(params + kOffBf + bias_col(i - kFBf));
    } else if (i < kFWa) {
      v = __ldg(params + kOffBd + bias_col(i - kFBd));
    } else if (i < kFWr) {
      v = __bfloat162float(w[kWa + head_col(i - kFWa)]);
    } else if (i < kFBa) {
      const int j = i - kFWr;
      v = __bfloat162float(w[kWr + (j & ~(kDirHidden - 1)) + head_col(j & (kDirHidden - 1))]);
    } else if (i == kFBa) {
      v = __ldg(params + kOffBa);
    } else {
      v = __ldg(params + kOffBr + i - kFBr);
    }
    f32[i] = v;
  }
  if (threadIdx.x == 0) {
    bar_init(wbar, 1);
    for (int s = 0; s < kSlabs; ++s) {
      bar_init(full + 8 * s, 128);
      bar_init(empty + 8 * s, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {   // the wide layers, resident from here on
    constexpr int kParts = 5;
    constexpr uint32_t kPart = kWideBytes / kParts;
    static_assert(kWideBytes % (16 * kParts) == 0, "bulk copies move multiples of 16 bytes");
    bar_expect(wbar, kWideBytes);
    for (int i = 0; i < kParts; ++i) {
      bulk_load(wsm + i * kPart, reinterpret_cast<const unsigned char*>(w) + i * kPart, kPart,
                wbar);
    }
  }

  // Units of kConsumers tiles, walked with the grid's stride; consumer c
  // runs tile c of each. Fewer than 2^31 tiles (mlp_t.cu), so the count is
  // a 32-bit division.
  const unsigned int units =
      static_cast<unsigned int>((n_points + kConsumers * kRows - 1) / (kConsumers * kRows));
  const int count = blockIdx.x < units ? (units - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int role = threadIdx.x / 128;
  const int t = threadIdx.x & 127;

  if (role >= kConsumers) {   // producer role - kConsumers encodes every kProducers-th tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
#pragma unroll 1
    for (int it = 0; it < count; ++it) {
      const long long unit = blockIdx.x + static_cast<long long>(it) * gridDim.x;
#pragma unroll 1
      for (int c = 0; c < kConsumers; ++c) {
        if ((it * kConsumers + c) % kProducers != role - kConsumers) continue;
        const int s = c * kSlabsPer + it % kSlabsPer;
        bar_wait(empty + 8 * s, ((it / kSlabsPer) & 1) ^ 1);
        encode(pts, (unit * kConsumers + c) * kRows, n_points, smem + kSmemEnc + s * kSlabBytes,
               t);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        arrive(full + 8 * s);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int wg = role;
  const Turns turns{wg};
  if (wg == kConsumers - 1) named_arrive(1, 256);   // consumer 0 goes first
  const int r = 16 * (t >> 5) + ((t & 31) >> 2);    // the thread's rows r, r + 8
  const int q = t & 3;
  const float* const wa[1] = {f32 + kFWa};
  const float* const wr[3] = {f32 + kFWr, f32 + kFWr + kDirHidden, f32 + kFWr + 2 * kDirHidden};
  bar_wait(wbar, 0);

  // One accumulator and one set of A fragments serve every layer: the
  // 64-wide direction layer takes the first half.
  float d[64];
  uint32_t a[8][4];
  float(&d32)[32] = *reinterpret_cast<float(*)[32]>(&d[0]);
  // Issue layer1 of the consumer's it-th tile, from its slab, once the slab
  // is full; its products run on while the previous tile's rgb is summed.
  auto layer1 = [&](int it) {
    const int s = wg * kSlabsPer + it % kSlabsPer;
    bar_wait(full + 8 * s, (it / kSlabsPer) & 1);
    turns.wait();
    pin(d);
    wgmma_fence();
    const uint64_t da = sw128_desc(saddr(smem + kSmemEnc + s * kSlabBytes));
    const uint64_t db = sw128_desc(wsm + kW1 * 2);
#pragma unroll
    for (int k = 0; k < kEncK / 16; ++k) mma_ss<128>(d, da + 2 * k, db + 2 * k, k > 0);
    wgmma_commit();
    turns.pass();
  };
  if (count > 0) layer1(0);
  float4 b[8];   // the biases of the layer in flight
  float4 e[8];   // the dc terms of the direction layer
#pragma unroll 1
  for (int it = 0; it < count; ++it) {
    const long long unit = blockIdx.x + static_cast<long long>(it) * gridDim.x;
    const long long p0 = (unit * kConsumers + wg) * kRows;
    load_bias<128>(f32 + kFB1, b);
    wgmma_wait<0>();
    if (t == 0) arrive(empty + 8 * (wg * kSlabsPer + it % kSlabsPer));   // the slab is read
    pin(d);
    epilogue<128, false, false>(d, b, a);
#pragma unroll 1
    for (int i = 0; i < 3; ++i) {   // h1 .. h3
      issue_layer<128>(turns, d, a, wsm + (kWx0 + i * kHidden * kHidden) * 2);
      load_bias<128>(f32 + kFBx + kHidden * i, b);
      finish_layer<128>(d, a);
      epilogue<128, true, false>(d, b, a);
    }
    float sigma[1];
    heads<8, 1>(a, wa, sigma);
    issue_layer<128>(turns, d, a, wsm + kWf * 2);   // feat
    load_bias<128>(f32 + kFBf, b);
    finish_layer<128>(d, a);
    epilogue<128, true, false>(d, b, a);
    issue_layer<64>(turns, d32, a, wsm + kWd * 2);   // hd, + the rows' rays' dc
    const long long g0 = p0 + r;
    const long long g1 = g0 + 8;
    float4(&b4)[4] = *reinterpret_cast<float4(*)[4]>(&b[0]);
    load_bias<64>(f32 + kFBd, b4);
    load_dc(g0 < n_points ? dc + ray_of(g0, samples) * kDirHidden : nullptr,
            g1 < n_points ? dc + ray_of(g1, samples) * kDirHidden : nullptr, e);
    finish_layer<64>(d32, a);
    epilogue<64, true, true>(d32, b4, a, e);
    if (it + 1 < count) layer1(it + 1);
    float rgb[3];
    heads<4, 3>(a, wr, rgb);
    // Lane 0 of a row's quad writes row r, lane 2 row r + 8.
    const long long g = q >= 2 ? g1 : g0;
    if ((q & 1) == 0 && g < n_points) {
      *reinterpret_cast<float4*>(out + g * 4) =
          make_float4(rgb[0] + f32[kFBr], rgb[1] + f32[kFBr + 1], rgb[2] + f32[kFBr + 2],
                      sigma[0] + f32[kFBa]);
    }
  }
  if (wg == 0) named_sync(1, 256);   // the last consumer's last pass
}

}  // namespace wg
}  // namespace flex
