// Hopper device code of the bf16 PaperNeRF render forward: the bf16
// instance of paper_t.cu's paper_t_kernel, on wgmma. paper_tc.cuh's mma.sync
// tile body stays the training forward's (paper_train.cu), which must also
// write every layer's output to residual rows; this body never does. Its
// cluster wrappers below and wg_ptx.cuh's mbarrier, fence and wgmma wrappers,
// which flex_wg.cuh (#1's bf16 body) shares, are plain PTX.
//
// What bounds it: arithmetic. A point costs 626,176 multiply-adds (F = 10)
// against 28 bytes of input and output, so the only limit is the tensor
// cores' rate, and on Hopper only wgmma reaches it. On an H100 80GB HBM3 at
// 700 W a 131072 x 128 chunk takes ~31 ms (~680 TFLOP/s, ~68% of the 21.13 ms
// bound), against ~62 ms for paper_tc.cuh's mma.sync tile.
//
// Design (one persistent block of 384 threads an SM):
//   * Warp specialised: warpgroups 0 and 1 are consumers (setmaxnreg 240),
//     each owning a 64-point slab of the block's 128-point tile; warpgroup 2
//     is the producer (setmaxnreg 24), one thread of which streams the
//     weights. Blocks walk the tiles with the grid's stride.
//   * Weights through a ring of up to kMaxStages shared-memory stages, one
//     K-slice of 64 rows a stage (256 x 64 bf16 = 32 KB; 16 KB at the
//     128-wide direction layers), with mbarrier full/empty pairs. The wrapper
//     packs each slice as its exact shared-memory image, K-major with the
//     128-byte swizzle wgmma's descriptor names (kernels/paper_t.py
//     pack_wg_forward), so one bulk copy (cp.async.bulk, the TMA unit) moves
//     a slice. The producer walks the slices in the order the consumers read
//     them, tile after tile; both consumers read every stage.
//   * L2: the weights (623,232 bf16 at F = 10, 1.25 MB) are read once per
//     tile. A frame evaluates 40.96 M points (160,000 rays x (64 + 192)); at
//     128-point tiles that is 400 GB a frame, ~5.3 TB/s at the ~31 ms a
//     131072 x 128 chunk takes, near the L2's rate. So blocks run in clusters
//     of kCluster = 2: each block copies half of every slice and multicasts it
//     to both, and a stage is refilled once all four consumers of the pair
//     have released it: 200 GB a frame, ~2.6 TB/s. (Measured, the clusters
//     neither gained nor lost time at this rate: 30.6-31.3 ms a chunk against
//     31.2-31.8 without; they leave the L2 its headroom.)
//   * Every wide layer is wgmma m64nNk16 with f32 sums: the trunk, the skip
//     at layer 4 and fc_feat N = 256, layers_dir.* N = 128. B comes from the
//     ring. A comes from registers: a layer's f32 accumulator, biased,
//     ReLU'd and rounded to bf16, is already the next layer's A fragment
//     (the m64nN accumulator's n8 blocks 2k, 2k + 1 hold A's k-th 16-deep
//     slice), so activations never touch shared memory and a layer needs no
//     block-wide barrier: 128 accumulator and 64 fragment registers a thread.
//     Layer 0 and the skip's encoding rows read A from the consumer's
//     encoding slab in shared memory (64 points x pad16(dim), the same
//     swizzled layout), resident for the tile. (A variant with half of A in
//     shared memory ran 3-6% slower.)
//   * Ping-pong: the consumers take turns at issuing a layer's products
//     (named barriers 1 and 2), so one consumer's epilogue (bias, ReLU, dc,
//     rounding) and its tile's encoding overlap the other's products (~10%
//     against both issuing at once). Turns need a layer's slices in the ring
//     at once (the skip's 5 at F <= 10, of 6 stages); deeper encodings (a
//     6-slice skip, 5 stages) run without them.
//   * A slice's stage is released as soon as its products are done
//     (wgmma.wait_group 1 after the next slice's commit), so the producer
//     refills it while the layer runs on. The waits are unconditional and
//     every product names its accumulator read-write (a runtime scale-d for
//     the first), as CUTLASS does: otherwise ptxas serialises every wgmma.
//   * sigma (256 -> 1) and rgb (128 -> 3) stay on FMA in f32 from the bf16
//     activations, 4 threads a point, as in the mma.sync body.
//
// Numbers: bf16 operands, f32 sums; activations are rounded once, where a
// layer's output becomes the next layer's input; dc is added in f32; the
// encoding is sincosf of x * 2^f without fast math, the checkpoint's
// interleaved order, K padded to 16 with zero rows (63 -> 64, skip 319 ->
// 320). Only the order of the sums differs from paper_tc.cuh's body.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "paper_mlp.cuh"
#include "wg_ptx.cuh"

namespace paper {
namespace wg {

using namespace wgptx;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                          // consumer warpgroups a block
constexpr int kRows = 64;                              // points a consumer: wgmma's M
constexpr int kBlockPoints = kConsumers * kRows;       // 128
constexpr int kThreads = (kConsumers + 1) * 128;       // 384
constexpr int kMaxStages = 6;                          // ring stages, where they fit
constexpr int kCluster = 2;                            // blocks a cluster share each slice
constexpr int kSliceK = 64;                            // K rows a slice: one 128-byte atom
constexpr int kWideBytes = kWidth * kSliceK * 2;       // 32 KB
constexpr int kNarrowBytes = kDirWidth * kSliceK * 2;  // 16 KB
constexpr int kEncColBytes = kRows * kSliceK * 2;      // 8 KB: 64 columns of a slab
constexpr int kSmemMax = 232448;                       // shared memory a block can have
constexpr int kNarrowSlices = 8;                       // layers_dir.0: 4, .1 and .2: 2 each

__host__ __device__ constexpr int pad16(int x) { return (x + 15) & ~15; }
// 64-deep K slices of the encoding: layer 0's, and the skip's first ones.
__host__ __device__ constexpr int enc_slices(int dim) {
  return (pad16(dim) + kSliceK - 1) / kSliceK;
}
// 256-wide slices in the weight image: layer 0, layers 1-3, the skip's
// encoding and h rows, layers 5-7, fc_feat.
__host__ __device__ constexpr int wide_slices(int dim) { return 2 * enc_slices(dim) + 32; }
// bf16 offset of the heads (fc_alpha (256), fc_rgb (3, 128)) in the image,
// and its whole length.
__host__ __device__ constexpr int heads_offset(int dim) {
  return wide_slices(dim) * (kWideBytes / 2) + kNarrowSlices * (kNarrowBytes / 2);
}
__host__ __device__ constexpr int num_weights(int dim) {
  return heads_offset(dim) + kWidth + 3 * kDirWidth;
}

// The f32 copies a block keeps in shared memory (floats): the biases, and
// the heads' bf16 weights as f32.
constexpr int kFB = 0;                   // layers_xyz.i bias at kFB + 256 i
constexpr int kFBFeat = 8 * kWidth;      // 2048
constexpr int kFBDir = kFBFeat + kWidth; // layers_dir.i bias at kFBDir + 128 i
constexpr int kFWa = kFBDir + 3 * kDirWidth;
constexpr int kFWr = kFWa + kWidth;      // fc_rgb row c at kFWr + 128 c
constexpr int kFBa = kFWr + 3 * kDirWidth;
constexpr int kFBr = kFBa + 1;
constexpr int kF32Floats = kFBr + 3;     // 3332

// Dynamic shared memory (bytes from a 1024-aligned base): the consumers'
// encoding slabs, the f32 copies, the barriers, then the ring with as many
// stages as fit (kMaxStages; 5 at F > 10).
struct Smem {
  int enc, f32, bars, ring, stages, bytes;
};
__host__ __device__ inline Smem smem_layout(int dim) {
  Smem s{};
  s.enc = 0;
  s.f32 = kConsumers * enc_slices(dim) * kEncColBytes;
  s.bars = (s.f32 + kF32Floats * 4 + 15) & ~15;
  s.ring = (s.bars + 2 * kMaxStages * 8 + 1023) & ~1023;
  s.stages = (kSmemMax - 1024 - s.ring) / kWideBytes;
  if (s.stages > kMaxStages) s.stages = kMaxStages;
  s.bytes = s.ring + s.stages * kWideBytes + 1024;   // + the base's alignment
  return s;
}

// ---------------------------------------------------------------------------
// PTX wrappers that depend on the cluster: arrivals, bulk copies, the
// cluster's rank and barrier (the rest are wg_ptx.cuh's).

// Arrive on the barrier at the same offset in the cluster's block `rank`
// (the own block's at kCluster = 1).
__device__ __forceinline__ void bar_arrive(uint32_t bar, uint32_t rank) {
  if constexpr (kCluster == 1) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
  } else {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(bar), "r"(rank));
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
  }
}

// `bytes` from device memory to shared memory, completing on `bar`; with
// kCluster = 2 into the same offset of both blocks of the cluster.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  if constexpr (kCluster == 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
  } else {
    const uint16_t mask = (1u << kCluster) - 1;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
        " [%0], [%1], %2, [%3], %4;\n"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar), "h"(mask) : "memory");
  }
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r = 0;
  if constexpr (kCluster > 1) asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of the cluster (of the block at kCluster = 1).
__device__ __forceinline__ void cluster_sync() {
  if constexpr (kCluster == 1) {
    __syncthreads();
  } else {
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  }
}

// Before a block of a cluster exits: the other block may still arrive on
// its barriers.
__device__ __forceinline__ void cluster_exit() {
  if constexpr (kCluster > 1) cluster_sync();
}

// ---------------------------------------------------------------------------
// The consumers' side of the ring.

struct Ring {
  uint32_t base;    // stage 0; stage s at + s kWideBytes
  uint32_t full;    // full[0]; the barriers are 8 bytes apart
  uint32_t empty;   // empty[0]
  int stages;
  int stage = 0;
  uint32_t phase = 0;
  int held = -1;    // the stage whose products may still be in flight
  bool leader;      // the warpgroup's thread 0 signals its releases

  // The current stage's shared address, once its slice has landed.
  __device__ __forceinline__ uint32_t wait() {
    bar_wait(full + 8 * stage, phase);
    return base + stage * kWideBytes;
  }
  __device__ __forceinline__ void release(int s) {
    if (leader) {
#pragma unroll
      for (int r = 0; r < kCluster; ++r) bar_arrive(empty + 8 * s, r);
    }
  }
  // The current slice's products are issued: commit them as a group, and
  // once the slice before is done, hand its stage back.
  __device__ __forceinline__ void issued() {
    wgmma_commit();
    wgmma_wait<1>();
    if (held >= 0) release(held);
    held = stage;
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
  // Wait for the layer's last products and hand their stage back.
  __device__ __forceinline__ void drain() {
    wgmma_wait<0>();
    release(held);
    held = -1;
  }
};

// The consumers' turns at issuing a layer's products: consumer w waits on
// named barrier 1 + w, then lets the other go.
struct Turns {
  bool on;
  int wg;
  __device__ __forceinline__ void wait() const {
    if (on) named_sync(1 + wg, 256);
  }
  __device__ __forceinline__ void pass() const {
    if (on) named_arrive(1 + (wg ^ 1), 256);
  }
};


// The epilogue of an N-wide layer: a = bf16(act(d + bias (+ dc))), the next
// layer's A fragments. The thread's rows are r = 16 warp + lane / 4 and
// r + 8; accumulator n8 block j holds columns 8 j + 2 (lane % 4) + {0, 1},
// d[4 j] (r), d[4 j + 2] (r + 8); A's k-th slice is blocks 2 k and 2 k + 1.
// dc0 / dc1: the rows' dc rows (null: none).
template <int N, bool kRelu>
__device__ __forceinline__ void epilogue(const float (&d)[N / 2], const float* bias,
                                         uint32_t (&a)[16][4],
                                         const float* __restrict__ dc0 = nullptr,
                                         const float* __restrict__ dc1 = nullptr) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int k = 0; k < N / 16; ++k) {
    const int c = 16 * k + 2 * q;
    const float2 b0 = *reinterpret_cast<const float2*>(bias + c);
    const float2 b1 = *reinterpret_cast<const float2*>(bias + c + 8);
    float v[8] = {d[8 * k] + b0.x,     d[8 * k + 1] + b0.y, d[8 * k + 2] + b0.x,
                  d[8 * k + 3] + b0.y, d[8 * k + 4] + b1.x, d[8 * k + 5] + b1.y,
                  d[8 * k + 6] + b1.x, d[8 * k + 7] + b1.y};
    if (dc0 != nullptr) {
      const float2 e0 = __ldg(reinterpret_cast<const float2*>(dc0 + c));
      const float2 e2 = __ldg(reinterpret_cast<const float2*>(dc0 + c + 8));
      v[0] += e0.x, v[1] += e0.y, v[4] += e2.x, v[5] += e2.y;
    }
    if (dc1 != nullptr) {
      const float2 e1 = __ldg(reinterpret_cast<const float2*>(dc1 + c));
      const float2 e3 = __ldg(reinterpret_cast<const float2*>(dc1 + c + 8));
      v[2] += e1.x, v[3] += e1.y, v[6] += e3.x, v[7] += e3.y;
    }
    if (kRelu) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.f);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) a[k][e] = pack_bf16(v[2 * e], v[2 * e + 1]);
  }
}

// The thread's share of x . w over K for its two rows, from the bf16 A
// fragments a (K / 16 slices) and f32 weights w; complete in all 4 threads
// of the row's quad.
template <int KS>
__device__ __forceinline__ float2 head(const uint32_t (&a)[16][4], const float* w) {
  const int q = threadIdx.x & 3;
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const float2 w0 = *reinterpret_cast<const float2*>(w + 16 * k + 2 * q);
    const float2 w1 = *reinterpret_cast<const float2*>(w + 16 * k + 8 + 2 * q);
    float2 x = unpack_bf16(a[k][0]);
    s0 = fmaf(x.x, w0.x, s0);
    s0 = fmaf(x.y, w0.y, s0);
    x = unpack_bf16(a[k][2]);
    s0 = fmaf(x.x, w1.x, s0);
    s0 = fmaf(x.y, w1.y, s0);
    x = unpack_bf16(a[k][1]);
    s1 = fmaf(x.x, w0.x, s1);
    s1 = fmaf(x.y, w0.y, s1);
    x = unpack_bf16(a[k][3]);
    s1 = fmaf(x.x, w1.x, s1);
    s1 = fmaf(x.y, w1.y, s1);
  }
  s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
  return make_float2(s0, s1);
}

// d (+)= h . W^T over the KS 16-deep slices of the activation h held in
// the registers a (KS / 4 ring slices); kFirst: the first product
// overwrites d.
template <int N, int KS, bool kFirst>
__device__ __forceinline__ void h_part(Ring& ring, float (&d)[N / 2], uint32_t (&a)[16][4]) {
#pragma unroll
  for (int j = 0; j < KS / 4; ++j) {
    const uint64_t db = sw128_desc(ring.wait());
#pragma unroll
    for (int s = 0; s < 4; ++s) mma_rs<N>(d, a[4 * j + s], db + 2 * s, !kFirst || j + s > 0);
    ring.issued();
  }
}

// A layer on the previous one's activation: d = h . W^T.
template <int N, int KS>
__device__ __forceinline__ void h_layer(Ring& ring, const Turns& turns, float (&d)[N / 2],
                                        uint32_t (&a)[16][4]) {
  turns.wait();
  pin(d);
  pin(a);
  wgmma_fence();
  h_part<N, KS, true>(ring, d, a);
  turns.pass();
  ring.drain();
  pin(d);
  pin(a);
}

// d = enc . W^T over the encoding slab's kin columns (layer 0, and the
// skip's first part): one ring slice per 64 columns.
__device__ __forceinline__ void enc_part(Ring& ring, float (&d)[128], uint32_t enc, int kin) {
  for (int j = 0; j * kSliceK < kin; ++j) {
    const uint64_t db = sw128_desc(ring.wait());
    const uint64_t da = sw128_desc(enc + j * kEncColBytes);
    const int steps = min(4, (kin - j * kSliceK) / 16);
    for (int s = 0; s < steps; ++s) mma_ss<256>(d, da + 2 * s, db + 2 * s, j + s > 0);
    ring.issued();
  }
}

// Write v at (point p, column k) of an encoding slab: rows of 64 columns,
// 128 bytes, each 64-column block kEncColBytes on, 16-byte chunks swizzled.
__device__ __forceinline__ void put_enc(unsigned char* slab, int p, int k, float v) {
  const int off = (k >> 6) * kEncColBytes + p * 128 + ((((k >> 3) & 7) ^ (p & 7)) << 4) +
                  ((k & 7) << 1);
  *reinterpret_cast<bf16*>(slab + off) = __float2bfloat16_rn(v);
}

// The encoding of the slab's 64 points from p0 into its kin columns, by the
// consumer's 128 threads (t): points past n_points encode x = 0, columns
// dim .. kin - 1 are zero.
__device__ __forceinline__ void encode(const float* __restrict__ pts, long long p0,
                                       long long n_points, int num_freq, int dim, int kin,
                                       unsigned char* slab, int t) {
  const int items = 3 * kRows * (1 + num_freq);
  for (int i = t; i < items; i += 128) {
    const int f = i / (3 * kRows);
    const int pc = i - f * 3 * kRows;
    const int p = pc / 3;
    const int c = pc - 3 * p;
    const float x = p0 + p < n_points ? __ldg(pts + p0 * 3 + pc) : 0.f;
    if (f == 0) {
      put_enc(slab, p, c, x);
    } else {
      float s, co;
      sincosf(x * __int_as_float((126 + f) << 23), &s, &co);   // x * 2^(f - 1)
      put_enc(slab, p, 6 * f - 3 + c, s);
      put_enc(slab, p, 6 * f + c, co);
    }
  }
  const int pad = kin - dim;
  for (int i = t; i < kRows * pad; i += 128) put_enc(slab, i / pad, dim + i % pad, 0.f);
}

// The producer: one thread walks the weight image's slices, tile after
// tile, into the ring; with kCluster = 2 it copies its half of each slice
// to both blocks of the cluster.
__device__ __forceinline__ void produce(const bf16* __restrict__ w, int dim, int tiles,
                                        uint32_t ring, int stages, uint32_t full,
                                        uint32_t empty) {
  const int wide = wide_slices(dim);
  const uint32_t rank = cluster_rank();
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < tiles; ++it) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(w);
    for (int j = 0; j < wide + kNarrowSlices; ++j) {
      const uint32_t bytes = j < wide ? kWideBytes : kNarrowBytes;
      const uint32_t part = bytes / kCluster;
      bar_wait(empty + 8 * stage, phase ^ 1);
      bar_expect(full + 8 * stage, bytes);
      bulk_copy(ring + stage * kWideBytes + rank * part, src + rank * part, part,
                full + 8 * stage);
      src += bytes;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// The whole forward: paper_t.cu's bf16 paper_t_kernel. Biases from the f32
// parameters (layout L), weights from the image w (pack_wg_forward);
// `smem_raw` the block's dynamic shared memory (smem_layout(L.dim).bytes).
__device__ __forceinline__ void forward(const float* __restrict__ pts, const float* __restrict__ dc,
                                        const float* __restrict__ params,
                                        const bf16* __restrict__ w, const Layout& L,
                                        float* __restrict__ out, long long n_points, int samples,
                                        int num_freq, unsigned char* smem_raw) {
  const int dim = L.dim;
  const int kin = pad16(dim);
  const Smem S = smem_layout(dim);
  // Offset from the dynamic shared array itself, so that the compiler keeps
  // every access below in the shared state space (lds/sts, not generic).
  unsigned char* smem = smem_raw + ((1024u - (saddr(smem_raw) & 1023u)) & 1023u);
  float* f32 = reinterpret_cast<float*>(smem + S.f32);
  const uint32_t ring = saddr(smem + S.ring);
  const uint32_t full = saddr(smem + S.bars);
  const uint32_t empty = full + 8 * kMaxStages;

  // The biases and the heads' weights, once a block.
  for (int i = threadIdx.x; i < kF32Floats; i += kThreads) {
    float v = 0.f;
    if (i < kFBFeat) {
      v = __ldg(params + L.b[i / kWidth] + i % kWidth);
    } else if (i < kFBDir) {
      v = __ldg(params + L.bf + i - kFBFeat);
    } else if (i < kFWa) {
      v = __ldg(params + L.bd[(i - kFBDir) / kDirWidth] + (i - kFBDir) % kDirWidth);
    } else if (i < kFBa) {
      v = __bfloat162float(w[heads_offset(dim) + i - kFWa]);
    } else if (i == kFBa) {
      v = __ldg(params + L.ba);
    } else {
      v = __ldg(params + L.br + i - kFBr);
    }
    f32[i] = v;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S.stages; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(empty + 8 * s, kCluster * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  // The cluster's tiles: a unit of kCluster block tiles, the block's the
  // rank-th; units walked with the grid's stride.
  const int cluster_id = blockIdx.x / kCluster;
  const int clusters = gridDim.x / kCluster;
  const long long unit = static_cast<long long>(kCluster) * kBlockPoints;
  const long long units = (n_points + unit - 1) / unit;
  const int tiles = cluster_id < units
                        ? static_cast<int>((units - cluster_id + clusters - 1) / clusters)
                        : 0;
  const int role = threadIdx.x / 128;

  if (role == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) produce(w, dim, tiles, ring, S.stages, full, empty);
    __syncwarp();
    cluster_exit();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x & 127;
    const int wg = role;
    unsigned char* slab = smem + S.enc + wg * enc_slices(dim) * kEncColBytes;
    const uint32_t enc = saddr(slab);
    Ring rg{ring, full, empty, S.stages};
    rg.leader = t == 0;
    // Turns need every layer's slices in the ring at once: the skip's
    // enc_slices + 4.
    const Turns turns{enc_slices(dim) + 4 <= S.stages, wg};
    if (turns.on && wg == 1) named_arrive(1, 256);   // consumer 0 goes first
    const int r = 16 * (t >> 5) + ((t & 31) >> 2);   // the thread's rows r, r + 8
    const int q = t & 3;
    const unsigned int rank = cluster_rank();

    // One accumulator and one set of A fragments serve every layer: the
    // 128-wide direction layers take the first halves, so that every
    // product's registers stay where the trunk's are.
    float d[128];
    uint32_t a[16][4];
    float(&d64)[64] = *reinterpret_cast<float(*)[64]>(&d[0]);
    for (int it = 0; it < tiles; ++it) {
      const long long tile = static_cast<long long>(cluster_id + it * clusters) * kCluster + rank;
      const long long p0 = tile * kBlockPoints + wg * kRows;
      encode(pts, p0, n_points, num_freq, dim, kin, slab, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_sync(3 + wg, 128);

      // Layer 0. Its first product ignores d, but d is defined here, so that
      // no value of the last tile stays live across the direction layers.
#pragma unroll
      for (int i = 0; i < 128; ++i) d[i] = 0.f;
      turns.wait();
      pin(d);
      wgmma_fence();
      enc_part(rg, d, enc, kin);
      turns.pass();
      rg.drain();
      pin(d);
      epilogue<256, true>(d, f32 + kFB, a);
#pragma unroll 1
      for (int i = 1; i < 8; ++i) {
        if (i == 4) {  // the skip: [enc; h3] . W4 in one sum
          turns.wait();
          pin(d);
          pin(a);
          wgmma_fence();
          enc_part(rg, d, enc, kin);
          h_part<256, 16, false>(rg, d, a);
          turns.pass();
          rg.drain();
          pin(d);
          pin(a);
        } else {
          h_layer<256, 16>(rg, turns, d, a);
        }
        epilogue<256, true>(d, f32 + kFB + kWidth * i, a);
      }
      h_layer<256, 16>(rg, turns, d, a);       // fc_feat, no ReLU
      epilogue<256, false>(d, f32 + kFBFeat, a);
      const float2 sigma = head<16>(a, f32 + kFWa);

      // layers_dir.0 on feat, + dc of the rows' rays.
      h_layer<128, 16>(rg, turns, d64, a);
      const long long g0 = p0 + r;
      const long long g1 = g0 + 8;
      epilogue<128, true>(d64, f32 + kFBDir, a,
                          g0 < n_points ? dc + (g0 / samples) * kDirWidth : nullptr,
                          g1 < n_points ? dc + (g1 / samples) * kDirWidth : nullptr);
      h_layer<128, 8>(rg, turns, d64, a);
      epilogue<128, true>(d64, f32 + kFBDir + kDirWidth, a);
      h_layer<128, 8>(rg, turns, d64, a);
      epilogue<128, true>(d64, f32 + kFBDir + 2 * kDirWidth, a);

      // fc_rgb; lane q of a row's quad writes its component q, sigma at 3.
      float2 v = sigma;
      v.x += f32[kFBa];
      v.y += f32[kFBa];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float2 s = head<8>(a, f32 + kFWr + c * kDirWidth);
        if (q == c) v = make_float2(s.x + f32[kFBr + c], s.y + f32[kFBr + c]);
      }
      if (g0 < n_points) out[g0 * 4 + q] = v.x;
      if (g1 < n_points) out[g1 * 4 + q] = v.y;
    }
    if (turns.on && wg == 0) named_sync(1, 256);      // consumer 1's last pass
    cluster_exit();
  }
}

}  // namespace wg
}  // namespace paper
