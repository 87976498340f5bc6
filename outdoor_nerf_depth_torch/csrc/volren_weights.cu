// Alpha-compositing weights from optical depth, forward (K1a) and backward
// (K1b), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `ops/pallas_volren.py:_fwd_kernel` and
// `ops/pallas_volren.py:_bwd_kernel` of the reference package. Per ray of S
// samples, with tau clamped to 1e4 first (an opaque background makes the
// last tau infinite, and exp(-1e4) is already exactly 0 in f32):
//
//   forward:   P_i = sum_{j<i} tau_j          (exclusive prefix sum)
//              w_i = exp(-P_i) - exp(-(P_i + tau_i)),  e_i = exp(-(P_i + tau_i))
//   backward:  dtau_k = g_k e_k - sum_{i>k} g_i w_i  (exclusive suffix sum)
//
// The TPU kernels computed both sums as one triangular [S, S] matmul on the
// MXU, padded to 128 lanes. Here each ray is one warp: every lane holds
// k = ceil(S/32) consecutive samples (k <= 4), sums them sequentially in
// f32, and a __shfl_up_sync / __shfl_down_sync scan combines the lane
// totals. Rays longer than 128 samples are walked in chunks of 32*k samples
// with a running carry, so any S works. No padding, no matmul, no shared
// memory.
//
// Bound: memory. K1a reads tau and writes w and e, 12 B per sample; K1b
// reads g, w and e and writes dtau, 16 B per sample. Each does a handful of
// flops and two (K1a) or zero (K1b) exponentials per sample, far below the
// card's rate. At the train step's [4096, 64] f32, K1a moves 3 MiB, about
// 0.9 us at 3.35 TB/s, so launch latency dominates its time; fusing it with
// the optical depth and compositing is the way to make it faster.
//
// Interface: plain C, loaded with ctypes. The kernels launch on the caller's
// stream, allocate nothing, and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxPerLane = 4;      // samples per lane in one chunk
constexpr int kWarpsPerBlock = 8;   // rays per block
constexpr float kTauMax = 1e4f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clamp_tau(float t) {
  // Same as minimum(t, 1e4): NaN stays NaN.
  return t > kTauMax ? kTauMax : t;
}

template <int K>
__global__ void weights_fwd_kernel(const float* __restrict__ tau,
                                   float* __restrict__ w,
                                   float* __restrict__ e,
                                   int rays, int samples) {
  const int ray = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & (kWarp - 1);
  if (ray >= rays) return;  // whole warps exit together
  const long long row = static_cast<long long>(ray) * samples;
  const float* t_row = tau + row;
  float* w_row = w + row;
  float* e_row = e + row;

  float carry = 0.f;  // optical depth of all earlier chunks
  for (int base = 0; base < samples; base += kWarp * K) {
    const int first = base + lane * K;
    float v[K];
    float lane_sum = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int i = first + j;
      v[j] = i < samples ? clamp_tau(t_row[i]) : 0.f;
      lane_sum += v[j];
    }
    // Inclusive scan of the lane sums across the warp.
    float incl = lane_sum;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.f;
    const float chunk_total = __shfl_sync(kFull, incl, kWarp - 1);

    float p = carry + excl;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int i = first + j;
      const float p_next = p + v[j];
      const float trans_next = expf(-p_next);
      if (i < samples) {
        w_row[i] = expf(-p) - trans_next;
        e_row[i] = trans_next;
      }
      p = p_next;
    }
    carry += chunk_total;
  }
}

template <int K>
__global__ void weights_bwd_kernel(const float* __restrict__ g,
                                   const float* __restrict__ w,
                                   const float* __restrict__ e,
                                   float* __restrict__ dtau,
                                   int rays, int samples) {
  const int ray = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & (kWarp - 1);
  if (ray >= rays) return;
  const long long row = static_cast<long long>(ray) * samples;
  const float* g_row = g + row;
  const float* w_row = w + row;
  const float* e_row = e + row;
  float* d_row = dtau + row;

  const int chunk = kWarp * K;
  const int n_chunks = (samples + chunk - 1) / chunk;
  float carry = 0.f;  // sum of g*w over all later chunks
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int first = c * chunk + lane * K;
    float gw[K], ge[K];
    float lane_sum = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int i = first + j;
      const bool in = i < samples;
      const float gi = in ? g_row[i] : 0.f;
      gw[j] = in ? gi * w_row[i] : 0.f;
      ge[j] = in ? gi * e_row[i] : 0.f;
      lane_sum += gw[j];
    }
    // Inclusive suffix scan of the lane sums (lanes >= this one).
    float incl = lane_sum;
#pragma unroll
    for (int off = 1; off < kWarp; off <<= 1) {
      const float y = __shfl_down_sync(kFull, incl, off);
      if (lane + off < kWarp) incl += y;
    }
    float excl = __shfl_down_sync(kFull, incl, 1);
    if (lane == kWarp - 1) excl = 0.f;
    const float chunk_total = __shfl_sync(kFull, incl, 0);

    float s = carry + excl;  // sum of g*w strictly after this lane's samples
#pragma unroll
    for (int j = K - 1; j >= 0; --j) {
      const int i = first + j;
      if (i < samples) d_row[i] = ge[j] - s;
      s += gw[j];
    }
    carry += chunk_total;
  }
}

int per_lane(int samples) {
  const int k = (samples + kWarp - 1) / kWarp;
  return k < kMaxPerLane ? k : kMaxPerLane;
}

}  // namespace

extern "C" int volren_weights_fwd(const float* tau, float* w, float* e,
                                  int rays, int samples, cudaStream_t stream) {
  if (rays <= 0 || samples <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((rays + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * kWarp);
  switch (per_lane(samples)) {
    case 1: weights_fwd_kernel<1><<<grid, block, 0, stream>>>(tau, w, e, rays, samples); break;
    case 2: weights_fwd_kernel<2><<<grid, block, 0, stream>>>(tau, w, e, rays, samples); break;
    case 3: weights_fwd_kernel<3><<<grid, block, 0, stream>>>(tau, w, e, rays, samples); break;
    default: weights_fwd_kernel<4><<<grid, block, 0, stream>>>(tau, w, e, rays, samples); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int volren_weights_bwd(const float* g, const float* w, const float* e,
                                  float* dtau, int rays, int samples,
                                  cudaStream_t stream) {
  if (rays <= 0 || samples <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((rays + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * kWarp);
  switch (per_lane(samples)) {
    case 1: weights_bwd_kernel<1><<<grid, block, 0, stream>>>(g, w, e, dtau, rays, samples); break;
    case 2: weights_bwd_kernel<2><<<grid, block, 0, stream>>>(g, w, e, dtau, rays, samples); break;
    case 3: weights_bwd_kernel<3><<<grid, block, 0, stream>>>(g, w, e, dtau, rays, samples); break;
    default: weights_bwd_kernel<4><<<grid, block, 0, stream>>>(g, w, e, dtau, rays, samples); break;
  }
  return static_cast<int>(cudaGetLastError());
}
