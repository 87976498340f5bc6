// Native data plane: fused random-pixel batch assembly + ray casting.
//
// The host-side hot loop of the input pipeline: sample `batch` random
// (image, pixel) pairs, gather rgb/depth supervision, and cast world-space
// pinhole rays (origins, directions, viewdirs, cone radii) in one
// multithreaded pass. The port's own copy of the reference package's
// `native/dataplane.cpp`, byte for byte in everything below this comment, so
// a seed and a thread count give the reference's batches bit for bit.
//
// Zero dependencies: built with `g++ -O3 -shared -fPIC -std=c++17 -pthread`
// into build/ and loaded via ctypes
// (`outdoor_nerf_depth_torch/data/native_batcher.py`).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// SplitMix64: deterministic, seedable, cheap.
inline uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

struct Mat3 {
  float m[9];
};

inline void matvec3(const float* m, const float* v, float* out) {
  out[0] = m[0] * v[0] + m[1] * v[1] + m[2] * v[2];
  out[1] = m[3] * v[0] + m[4] * v[1] + m[5] * v[2];
  out[2] = m[6] * v[0] + m[7] * v[1] + m[8] * v[2];
}

}  // namespace

extern "C" {

// images:      [n_images, H, W, 3] float32
// depth_gt:    [n_images, H, W] float32 or nullptr
// depth_sup:   [n_images, H, W] float32 or nullptr
// pixtocams:   [3, 3] float32 (shared inverse intrinsics)
// camtoworlds: [n_images, 3, 4] float32 (OpenGL convention)
// outputs are dense float32 buffers sized for `batch` rays.
void sample_ray_batch(
    const float* images, const float* depth_gt, const float* depth_sup,
    const float* pixtocams, const float* camtoworlds,
    int n_images, int height, int width, int batch,
    uint64_t seed, int num_threads,
    float* out_rgb, float* out_depth_gt, float* out_depth_sup,
    float* out_origins, float* out_directions, float* out_viewdirs,
    float* out_radii, int32_t* out_cam_idx) {
  if (num_threads <= 0) {
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 1;
  }
  const int chunk = (batch + num_threads - 1) / num_threads;

  auto worker = [&](int t) {
    const int begin = t * chunk;
    const int end = std::min(batch, begin + chunk);
    uint64_t rng = seed + 0x9E3779B97F4A7C15ull * (t + 1);
    for (int i = begin; i < end; ++i) {
      const uint64_t r = splitmix64(rng);
      const int img = static_cast<int>(r % n_images);
      const int px = static_cast<int>((r >> 20) % width);
      const int py = static_cast<int>((r >> 42) % height);

      const size_t pix_off =
          ((static_cast<size_t>(img) * height + py) * width + px);
      std::memcpy(out_rgb + 3 * i, images + 3 * pix_off, 3 * sizeof(float));
      if (depth_gt) out_depth_gt[i] = depth_gt[pix_off];
      if (depth_sup) out_depth_sup[i] = depth_sup[pix_off];
      out_cam_idx[i] = img;

      // Camera-space direction trio (center, +x, +y neighbors) through the
      // inverse intrinsics, with the OpenCV->OpenGL flip folded in.
      const float xc = static_cast<float>(px) + 0.5f;
      const float yc = static_cast<float>(py) + 0.5f;
      float dirs_cam[3][3];
      const float offs[3][2] = {{0.f, 0.f}, {1.f, 0.f}, {0.f, 1.f}};
      for (int k = 0; k < 3; ++k) {
        const float pix[3] = {xc + offs[k][0], yc + offs[k][1], 1.0f};
        float v[3];
        matvec3(pixtocams, pix, v);
        dirs_cam[k][0] = v[0];
        dirs_cam[k][1] = -v[1];
        dirs_cam[k][2] = -v[2];
      }

      const float* c2w = camtoworlds + static_cast<size_t>(img) * 12;
      const float rot[9] = {c2w[0], c2w[1], c2w[2],  c2w[4], c2w[5],
                            c2w[6], c2w[8], c2w[9],  c2w[10]};
      float dirs_world[3][3];
      for (int k = 0; k < 3; ++k) matvec3(rot, dirs_cam[k], dirs_world[k]);

      out_origins[3 * i + 0] = c2w[3];
      out_origins[3 * i + 1] = c2w[7];
      out_origins[3 * i + 2] = c2w[11];
      std::memcpy(out_directions + 3 * i, dirs_world[0], 3 * sizeof(float));

      const float* d = dirs_world[0];
      const float inv_norm =
          1.0f / std::sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
      for (int c = 0; c < 3; ++c) out_viewdirs[3 * i + c] = d[c] * inv_norm;

      float dx = 0.f, dy = 0.f;
      for (int c = 0; c < 3; ++c) {
        const float ex = dirs_world[1][c] - d[c];
        const float ey = dirs_world[2][c] - d[c];
        dx += ex * ex;
        dy += ey * ey;
      }
      // Half mean neighbor offset, matched to a pixel-wide box's variance.
      out_radii[i] =
          0.5f * (std::sqrt(dx) + std::sqrt(dy)) * 2.0f / std::sqrt(12.0f);
    }
  };

  if (num_threads == 1) {
    worker(0);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();
}

}  // extern "C"
