// Hopper code of #9's bf16 weight-gradient pass (paper_train.cu's
// train_bwd_wgrad_kernel<1>) on wgmma: dW = X^T dY and db = sum dY of every
// weight block of a job table, each summed over a chunk of point tiles into
// that chunk's row of partial sums, which train_bwd_reduce then adds in a
// fixed order. X is the forward's bf16 residual rows, dY the f32 delta rows
// that the layer-gradient pass wrote, both point-major (res[point][row],
// delta[point][row]). paper_wg.cuh's render forward shares wg_ptx.cuh's PTX
// wrappers and nothing else.
//
// What bounds it: bytes. At F = 10 a point's residual row is 5,504 bytes and
// its delta row 10,768; the pass reads every byte of both (17.1 GB at
// paper_train's 1,048,576 points a step, 5.1 ms at 3.35 TB/s) and writes
// the chunks' partial sums (1.2 GB), against 1.31 TFLOP of products (1.33 ms
// at 989 TFLOP/s). The mma.sync tile before it staged X and dY synchronously,
// a barrier on each side of each tile's products, and took 14.5 ms a step;
// this body takes ~6.8 (4096 x 64 ~1.7 ms, 4096 x 192 ~5.1) on an NVIDIA
// H100 80GB HBM3 at 700 W, ~80% of the byte bound.
//
// Design (one persistent block of 512 threads an SM):
//   * Work items: an item is one job's 128-output tile over all of its
//     inputs (no job has more than kMaxIn = 256), summed over one chunk of
//     point tiles. A block walks (scene, chunk, item) chunk-major with the
//     grid's stride, so the blocks at work at once hold a few chunks, and the
//     items that share a chunk's X rows (a job's output tiles; layers_dir.0
//     and fc_alpha) or dY rows (layer 4's two blocks) run side by side: each
//     byte comes from device memory once and from L2 for the rest.
//   * A ring of kStages stages of kPoints points each: X as up to four
//     64-input boxes (the tensor copy's 128-byte swizzle: each point a row of
//     128 bytes, which is wgmma's MN-major operand as it lands) and dY as one
//     128-output f32 box, all on one mbarrier. Warpgroup 3's first thread
//     keeps the ring full with the tensor copies (TMA); the rest of it idles.
//     The ring's size is measured, not derived: three stages of 32 points
//     (96 KB) ran the pass in 5.0 ms at 4096 x 192, two or four of 32, three
//     of 64 and six of 16 in 5.6-7.3 (more bytes in flight did not help).
//   * Warpgroup 2 converts: it reads each stage's f32 dY, adds it to the
//     bias sums unrounded, and writes it back rounded to bf16 in the
//     operand's swizzled layout over the first half of the same box (every
//     thread reads the points under it first); a fence then hands it to the
//     async proxy and a second mbarrier to the consumers.
//   * Warpgroups 0 and 1 multiply: consumer w owns inputs 128 w .. 128 w +
//     127 of the item as two m64n128 accumulators (128 registers a thread),
//     both operands MN-major (K = points): the stage's 16-deep steps, one
//     commit, and the stage before is released once its products are done.
//     Inputs past the job's go on stale rows and are never stored. At an
//     item's end a consumer stores its f32 sums to the chunk's partial row
//     while the ring fills with the next item's points (the stores cost
//     ~0.6 ms of the 5.0; writing whole rows through shared memory did not
//     make them cheaper).
//
// Sums, bitwise those of the mma.sync tile this body replaced: each output's
// sum starts at 0.f in the chunk's first tile and adds
// the 16-deep products of its points in ascending order; dY is rounded once
// to bf16 (round to nearest) and the products are bf16 x bf16 in f32. Each
// bias is the sum over the eight residues w of a point index mod 8, in
// order from 0.f, of that residue's points' unrounded deltas, each residue
// summed in ascending point order from 0.f.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>

#include <cstdint>

#include "fma_wgrad.cuh"
#include "wg_ptx.cuh"

namespace wgrad_wg {

using namespace wgptx;

constexpr int kTile = 64;                           // points a tile (chunks count tiles)
constexpr int kPoints = 32;                         // points a stage: 16-deep steps of K
constexpr int kBoxIn = 64;                          // inputs a box of X: 128 bytes of bf16
constexpr int kMaxIn = 4 * kBoxIn;                  // inputs an item
constexpr int kOut = 128;                           // outputs an item: wgmma's N
constexpr int kBoxBytes = kPoints * kBoxIn * 2;     // a box of X
constexpr int kXBytes = 4 * kBoxBytes;
constexpr int kYBytes = kPoints * kOut * 4;         // f32 dY; the bf16 copy takes its first half
constexpr int kNBytes = kPoints * 64 * 2;           // 64 outputs of the bf16 copy
constexpr int kStageBytes = kXBytes + kYBytes;
constexpr int kStages = 3;
static_assert(kTile % kPoints == 0 && kPoints % 16 == 0, "stages split tiles into 16-deep steps");
static_assert(kStages >= 2, "a stage is released once the next one's products are issued");
constexpr int kConsumers = 2;
constexpr int kThreads = (kConsumers + 2) * 128;    // + the converter and the producer
constexpr int kProducerRegs = 24;
constexpr int kConverterRegs = 88;
constexpr int kConsumerRegs =
    ((65536 - 128 * (kProducerRegs + kConverterRegs)) / (128 * kConsumers)) & ~7;   // 200
constexpr int kMaxItems = 32;

// Dynamic shared memory (bytes from a 1024-aligned base): the stages, the
// barriers full[kStages], conv[kStages], empty[kStages], then the
// converter's exchange of bias sums (64 threads x 8).
constexpr int kSmemBars = kStages * kStageBytes;
constexpr int kSmemSums = kSmemBars + 3 * kStages * 8;
constexpr int kSmemBytes = kSmemSums + 64 * 8 * 4 + 1024;   // + the base's alignment

// A tensor copy starts its box's rows on 16 bytes: the item's dY box starts
// at delta row y_row, a multiple of 4, and output o0 + c - shift lies in its
// column c (shift 3 for fc_alpha's one output, at delta row 3).
struct Item {
  int x_row, in_dim;    // X: residual rows x_row .. x_row + in_dim - 1, in_dim <= kMaxIn
  int y_row, shift;     // dY: delta rows y_row .. y_row + kOut - 1
  int o0, out_dim;      // the item's outputs o0 .. of the job's out_dim
  int w_off, b_off;     // dW (in_dim, out_dim) and db in the packed layout (b_off -1: none)
};
struct Items {
  Item item[kMaxItems];
  int n;
};

// The items of a job table: each job's kOut-wide output tiles, in order.
// n = 0 where a job is wider than kMaxIn, its X rows do not start on 16
// bytes, its outputs do not fit their boxes or the items do not fit.
inline Items make_items(const wgrad::Job* jobs, int n_jobs) {
  Items t{};
  for (int j = 0; j < n_jobs; ++j) {
    const wgrad::Job& b = jobs[j];
    for (int o0 = 0; o0 < b.out_dim; o0 += kOut) {
      const int shift = (b.d_row + o0) & 3;
      if (b.in_dim > kMaxIn || b.x_row % 8 != 0 || shift + min(b.out_dim - o0, kOut) > kOut ||
          t.n == kMaxItems) {
        return Items{};
      }
      t.item[t.n++] = {b.x_row, b.in_dim, b.d_row + o0 - shift, shift, o0, b.out_dim, b.w_off,
                       b.b_off};
    }
  }
  return t;
}

// A 2-D tensor map over `rows` rows of `width` elements of `type` (`size`
// bytes each), rows packed, boxes of box_w x kPoints rows; swizzle128: the
// 128-byte swizzle of a wgmma operand, else none.
inline cudaError_t make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                            int size, long long width, long long rows, int box_w,
                            bool swizzle128) {
  static const PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn)
               : nullptr;
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width), static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(width) * size};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_w), kPoints};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, stride, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}


__device__ __forceinline__ void arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// The block's work items, (scene, chunk, item) chunk-major, with the grid's
// stride: f(scene, chunk, item) for each, in order. Fewer than 2^32 of them
// (the launch checks), so the walk divides in 32 bits.
template <class F>
__device__ __forceinline__ void walk(int n_scenes, int chunks, int n_items, F&& f) {
  const unsigned int per_scene = static_cast<unsigned int>(chunks) * n_items;
  const unsigned int total = per_scene * static_cast<unsigned int>(n_scenes);
#pragma unroll 1
  for (unsigned int w = blockIdx.x; w < total; w += gridDim.x) {
    const unsigned int sc = w / per_scene;
    const unsigned int r = w - sc * per_scene;
    const unsigned int c = r / n_items;
    f(static_cast<int>(sc), static_cast<int>(c), static_cast<int>(r - c * n_items));
  }
}

// The ring's position: stage and phase, advanced once a tile.
struct Pos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Store one m64n128 accumulator (inputs i0 .. i0 + 63 of the item) to the
// chunk's partial row `out`: the thread's rows r = 16 warp + lane / 4 and r
// + 8, n8 block j its columns c = 8 j + 2 (lane % 4) + {0, 1}, outputs
// o0 + c - shift.
__device__ __forceinline__ void store_sums(const float (&d)[64], int i0, const Item& it,
                                           float* __restrict__ out, int t) {
  const int r = 16 * (t >> 5) + ((t & 31) >> 2);
  const int q = t & 3;
  const bool pairs = ((it.w_off | it.out_dim | it.shift) & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + r + 8 * h;
    if (i >= it.in_dim) continue;
    float* row = out + it.w_off + i * it.out_dim;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int o = it.o0 + 8 * j + 2 * q - it.shift;
      const float a = d[4 * j + 2 * h];
      const float b = d[4 * j + 2 * h + 1];
      if (pairs && o < it.out_dim) {
        *reinterpret_cast<float2*>(row + o) = make_float2(a, b);
      } else {
        if (o >= 0 && o < it.out_dim) row[o] = a;
        if (o + 1 >= 0 && o + 1 < it.out_dim) row[o + 1] = b;
      }
    }
  }
}

// The whole pass: `xmap` the bf16 residuals and `ymap` the f32 deltas of all
// scenes as one table of rows (scene s's point tile t at rows (s n_tiles +
// t) kTile ..), boxes of kBoxIn x kPoints (128-byte swizzle) and kOut x kPoints;
// partial: scene s's chunk c's row at s partial_stride + c n_params;
// `smem_raw` the block's dynamic shared memory (kSmemBytes).
__device__ __forceinline__ void run(const CUtensorMap* xmap, const CUtensorMap* ymap,
                                    float* __restrict__ partial, long long partial_stride,
                                    int n_params, int n_tiles, int tiles_per_chunk, int chunks,
                                    int n_scenes, const Items& items, unsigned char* smem_raw) {
  // Offset from the dynamic shared array itself, so that every access below
  // stays in the shared state space.
  unsigned char* smem = smem_raw + ((1024u - (saddr(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = saddr(smem);
  const uint32_t full = base + kSmemBars;
  const uint32_t conv = full + 8 * kStages;
  const uint32_t empty = conv + 8 * kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(full + 8 * s, 1);
      bar_init(conv + 8 * s, 128);
      bar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int role = threadIdx.x / 128;
  const int t = threadIdx.x & 127;
  // The table rows p0 .. p1 - 1 of scene sc's chunk c.
  auto points = [&](int sc, int c, int& p0, int& p1) {
    const int t0 = c * tiles_per_chunk;
    p0 = (sc * n_tiles + t0) * kTile;
    p1 = p0 + (min(t0 + tiles_per_chunk, n_tiles) - t0) * kTile;
  };
  auto row_of = [&](int sc, long long c) {
    return partial + sc * partial_stride + c * n_params;
  };

  if (role == kConsumers + 1) {   // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs) : "memory");
    if (t != 0) return;
    Pos pos;
    walk(n_scenes, chunks, items.n, [&](int sc, int c, int k) {
      const Item& it = items.item[k];
      const int boxes = (it.in_dim + kBoxIn - 1) / kBoxIn;
      const uint32_t bytes = boxes * kBoxBytes + kYBytes;
      int p0, p1;
      points(sc, c, p0, p1);
#pragma unroll 1
      for (int row = p0; row < p1; row += kPoints) {
        const uint32_t st = base + pos.stage * kStageBytes;
        const uint32_t bar = full + 8 * pos.stage;
        bar_wait(empty + 8 * pos.stage, pos.phase ^ 1);
        bar_expect(bar, bytes);
        for (int b = 0; b < boxes; ++b) {
          tma_load_2d(st + b * kBoxBytes, xmap, it.x_row + b * kBoxIn, row, bar);
        }
        tma_load_2d(st + kXBytes, ymap, it.y_row, row, bar);
        pos.next();
      }
    });
    return;
  }

  if (role == kConsumers) {   // the converter
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kConverterRegs) : "memory");
    const int op = t & 63;   // columns 2 op, 2 op + 1 of the item's dY box
    const int rg = t >> 6;   // residues 4 rg .. 4 rg + 3 of a point index mod 8
    float* xch = reinterpret_cast<float*>(smem + kSmemSums) + 8 * op;
    // Where the bf16 copy keeps (point p, outputs 2 op, 2 op + 1).
    const int nb = (2 * op) >> 6;
    const int chunk16 = ((2 * op) & 63) >> 3;
    const int in16 = ((2 * op) & 7) * 2;
    Pos pos;
    walk(n_scenes, chunks, items.n, [&](int sc, int c, int k) {
      const Item& it = items.item[k];
      const int o = it.o0 + 2 * op - it.shift;   // their outputs o, o + 1
      const bool in0 = o >= 0 && o < it.out_dim;
      const bool in1 = o + 1 >= 0 && o + 1 < it.out_dim;
      float s[4][2];
#pragma unroll
      for (int w = 0; w < 4; ++w) s[w][0] = s[w][1] = 0.f;
      int p0, p1;
      points(sc, c, p0, p1);
#pragma unroll 1
      for (int row = p0; row < p1; row += kPoints) {
        unsigned char* y = smem + pos.stage * kStageBytes + kXBytes;
        const float* yf = reinterpret_cast<const float*>(y) + 2 * op;
        unsigned char* yb = y + nb * kNBytes + in16;
        bar_wait(full + 8 * pos.stage, pos.phase);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          constexpr int kJ = kPoints / 16;
          float2 v[kJ][4];
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const int p = kPoints / 2 * h + 8 * j + 4 * rg + w;
              v[j][w] = *reinterpret_cast<const float2*>(yf + p * kOut);
            }
          }
          // The bf16 copy lies over the f32 box's first half of points.
          if (h == 0) named_sync(1, 128);
#pragma unroll
          for (int j = 0; j < kJ; ++j) {
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const int p = kPoints / 2 * h + 8 * j + 4 * rg + w;
              const float a = in0 ? v[j][w].x : 0.f;
              const float b = in1 ? v[j][w].y : 0.f;
              s[w][0] += a;
              s[w][1] += b;
              *reinterpret_cast<uint32_t*>(yb + p * 128 + ((chunk16 ^ (p & 7)) << 4)) =
                  pack_bf16(a, b);
            }
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        arrive(conv + 8 * pos.stage);
        pos.next();
      }
      if (it.b_off < 0) return;
      if (rg == 1) {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          xch[2 * w] = s[w][0];
          xch[2 * w + 1] = s[w][1];
        }
      }
      named_sync(1, 128);
      if (rg == 0) {
        float* out = row_of(sc, c) + it.b_off;
        const int pad = (it.out_dim + 3) & ~3;   // a short bias's pad gets a zero
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sum = 0.f;
#pragma unroll
          for (int w = 0; w < 4; ++w) sum += s[w][e];
#pragma unroll
          for (int w = 0; w < 4; ++w) sum += xch[2 * w + e];
          if (o + e >= 0 && o + e < pad) out[o + e] = o + e < it.out_dim ? sum : 0.f;
        }
      }
    });
    return;
  }

  // The consumers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs) : "memory");
  const int wg = role;
  float d0[64], d1[64];
  Pos pos;
  walk(n_scenes, chunks, items.n, [&](int sc, int c, int k) {
    const Item& it = items.item[k];
    int p0, p1;
    points(sc, c, p0, p1);
    int held = -1;
#pragma unroll 1
    for (int row = p0; row < p1; row += kPoints) {
      const uint32_t x = base + pos.stage * kStageBytes + 2 * wg * kBoxBytes;
      const uint32_t y = base + pos.stage * kStageBytes + kXBytes;
      bar_wait(full + 8 * pos.stage, pos.phase);
      bar_wait(conv + 8 * pos.stage, pos.phase);
      pin(d0);
      pin(d1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kPoints / 16; ++ks) {
        const uint64_t db = sw128_mn_desc(y + 2048 * ks, kNBytes);
        const int acc = row > p0 || ks > 0;
        mma_ss_mn<128>(d0, sw128_mn_desc(x + 2048 * ks, kBoxBytes), db, acc);
        mma_ss_mn<128>(d1, sw128_mn_desc(x + kBoxBytes + 2048 * ks, kBoxBytes), db, acc);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (held >= 0 && t == 0) arrive(empty + 8 * held);
      held = pos.stage;
      pos.next();
    }
    wgmma_wait<0>();
    if (t == 0) arrive(empty + 8 * held);
    pin(d0);
    pin(d1);
    float* out = row_of(sc, c);
    store_sums(d0, 128 * wg, it, out, t);
    store_sums(d1, 128 * wg + 64, it, out, t);
  });
}

}  // namespace wgrad_wg
