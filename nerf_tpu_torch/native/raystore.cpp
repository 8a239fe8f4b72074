// Native ray-store builder + binary cache packer.
//
// The reference's data path is host-side Python: per-image torch meshgrid ray
// generation (nerf/nerf_helpers.py:67-110) and thousands of per-image
// torch.save files from cache_dataset.py. This module is the TPU framework's
// native-IO equivalent: it expands (images, poses) into the flat
// [N*H*W, 3]x3 ray store consumed by the device pipelines, multithreaded
// across images, and packs/loads it through a single binary file with a
// fixed little-endian layout (see RayCacheHeader) so multi-GB caches load
// with one read per array instead of Python-side per-image work.
//
// Exposed as a plain C ABI consumed via ctypes (nerf_tpu_torch/native/__init__.py,
// which builds it with g++ into build/nerf_tpu_torch/ at first use).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x4E524359;  // "NRCY"
constexpr uint32_t kVersion = 1;

struct RayCacheHeader {
  uint32_t magic;
  uint32_t version;
  uint64_t num_rays;
  uint32_t height;
  uint32_t width;
  float focal;
  float near;
  float far;
  uint32_t reserved[5];
};

// Camera-to-world pose rows: c2w is row-major (3, 4).
// Pixel (row j, col i) -> dir = R @ ((i - W/2)/f, -(j - H/2)/f, -1),
// origin = t  (reference nerf/nerf_helpers.py:89-110 semantics).
void rays_for_image(const float* c2w, const float* rgb_in, int h, int w,
                    float focal, float* ro, float* rd, float* rgb_out) {
  const float r00 = c2w[0], r01 = c2w[1], r02 = c2w[2], tx = c2w[3];
  const float r10 = c2w[4], r11 = c2w[5], r12 = c2w[6], ty = c2w[7];
  const float r20 = c2w[8], r21 = c2w[9], r22 = c2w[10], tz = c2w[11];
  const float half_w = 0.5f * static_cast<float>(w);
  const float half_h = 0.5f * static_cast<float>(h);
  const float inv_f = 1.0f / focal;

  for (int j = 0; j < h; ++j) {
    const float y = -(static_cast<float>(j) - half_h) * inv_f;
    for (int i = 0; i < w; ++i) {
      const float x = (static_cast<float>(i) - half_w) * inv_f;
      const size_t p = (static_cast<size_t>(j) * w + i) * 3;
      rd[p + 0] = x * r00 + y * r01 - r02;
      rd[p + 1] = x * r10 + y * r11 - r12;
      rd[p + 2] = x * r20 + y * r21 - r22;
      ro[p + 0] = tx;
      ro[p + 1] = ty;
      ro[p + 2] = tz;
      if (rgb_in != nullptr) {
        rgb_out[p + 0] = rgb_in[p + 0];
        rgb_out[p + 1] = rgb_in[p + 1];
        rgb_out[p + 2] = rgb_in[p + 2];
      }
    }
  }
}

}  // namespace

extern "C" {

// poses: (n, 12) row-major 3x4 c2w matrices. images: (n, h, w, 3) float32 or
// nullptr. Outputs are (n*h*w, 3) float32, caller-allocated. Threaded across
// images.
void nerf_build_ray_store(const float* poses, const float* images, int n,
                          int h, int w, float focal, float* out_ro,
                          float* out_rd, float* out_rgb, int num_threads) {
  if (num_threads < 1) {
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (num_threads < 1) num_threads = 1;
  }
  const size_t per_img = static_cast<size_t>(h) * w * 3;

  auto work = [&](int start, int stop) {
    for (int k = start; k < stop; ++k) {
      const float* img = images ? images + per_img * k : nullptr;
      rays_for_image(poses + 12 * k, img, h, w, focal, out_ro + per_img * k,
                     out_rd + per_img * k,
                     out_rgb ? out_rgb + per_img * k : nullptr);
    }
  };

  if (num_threads == 1 || n <= 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  const int chunk = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    const int start = t * chunk;
    const int stop = std::min(n, start + chunk);
    if (start >= stop) break;
    threads.emplace_back(work, start, stop);
  }
  for (auto& th : threads) th.join();
}

// Pack a ray store into one binary file. Returns 0 on success.
int nerf_pack_ray_cache(const char* path, const float* ro, const float* rd,
                        const float* rgb, uint64_t num_rays, uint32_t height,
                        uint32_t width, float focal, float near, float far) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  RayCacheHeader hdr;
  std::memset(&hdr, 0, sizeof(hdr));
  hdr.magic = kMagic;
  hdr.version = kVersion;
  hdr.num_rays = num_rays;
  hdr.height = height;
  hdr.width = width;
  hdr.focal = focal;
  hdr.near = near;
  hdr.far = far;
  const size_t elems = static_cast<size_t>(num_rays) * 3;
  int ok = std::fwrite(&hdr, sizeof(hdr), 1, f) == 1 &&
           std::fwrite(ro, sizeof(float), elems, f) == elems &&
           std::fwrite(rd, sizeof(float), elems, f) == elems &&
           std::fwrite(rgb, sizeof(float), elems, f) == elems;
  std::fclose(f);
  return ok ? 0 : -2;
}

// Read the header. Returns 0 on success, negative on error/corruption.
int nerf_ray_cache_info(const char* path, uint64_t* num_rays, uint32_t* height,
                        uint32_t* width, float* focal, float* near,
                        float* far) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  RayCacheHeader hdr;
  if (std::fread(&hdr, sizeof(hdr), 1, f) != 1 || hdr.magic != kMagic ||
      hdr.version != kVersion) {
    std::fclose(f);
    return -2;
  }
  *num_rays = hdr.num_rays;
  *height = hdr.height;
  *width = hdr.width;
  *focal = hdr.focal;
  *near = hdr.near;
  *far = hdr.far;
  std::fclose(f);
  return 0;
}

// Load all three arrays into caller-allocated buffers. Returns 0 on success.
int nerf_load_ray_cache(const char* path, float* ro, float* rd, float* rgb,
                        uint64_t num_rays) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, sizeof(RayCacheHeader), SEEK_SET) != 0) {
    std::fclose(f);
    return -2;
  }
  const size_t elems = static_cast<size_t>(num_rays) * 3;
  int ok = std::fread(ro, sizeof(float), elems, f) == elems &&
           std::fread(rd, sizeof(float), elems, f) == elems &&
           std::fread(rgb, sizeof(float), elems, f) == elems;
  std::fclose(f);
  return ok ? 0 : -3;
}

}  // extern "C"
