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
// reads g, w and e and writes dtau, 16 B per sample, with a handful of
// flops per sample, far below the card's rate.
//
// K1a moves each lane's k samples in one access per array: a float4 when
// k = 4 and a float2 when k = 2, if S is a multiple of k and the three
// arrays are aligned to it, so a warp reads or writes 32 * 4k contiguous
// bytes per instruction (512 B at S = 128). Other S (k = 1 or 3, ragged S,
// unaligned views) take the scalar variant; at k = 1 it is coalesced
// already. It computes one exp per sample: the transmittance exp(-P) is
// carried from a sample to the next, because P_{i+1} = P_i + tau_i is the
// same f32 value the next sample starts from, so w and e are bit for bit
// what two exps per sample give. What bounds it on the card: at NGP's
// [8192, 128] the bytes (it runs close to their time at the HBM rate); at
// the mip step's [4096, 64] and [4096, 32] (3 and 1.5 MiB) the fixed cost of
// a launch, which chip_smoke.py reads as K1a's time for a single ray. The
// design before this one (scalar loads and stores at a 4k-byte stride, two
// exps per sample) took 10.03 us at [8192, 128] and 7.41 us per mip step
// (2 x [4096, 64] + [4096, 32]) on one NVIDIA H100 80GB HBM3 at a 700 W
// power limit (chip_smoke.py); PERF.md keeps the times of this one.
//
// Interface: plain C, loaded with ctypes. The kernels launch on the caller's
// stream, allocate nothing, and each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

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

// Loads samples first .. first + K - 1 (0 past the row's end), clamped. kVec
// (K = 2 or 4): one K-wide access; the caller guarantees S % K == 0 and
// rows aligned to it, so the K samples lie all inside the row or all past it.
template <int K, bool kVec>
__device__ __forceinline__ void load_samples(const float* __restrict__ row, int first, int samples,
                                             float (&v)[K]) {
  if constexpr (kVec && K == 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (first < samples) x = *reinterpret_cast<const float4*>(row + first);
    v[0] = clamp_tau(x.x), v[1] = clamp_tau(x.y), v[2] = clamp_tau(x.z), v[3] = clamp_tau(x.w);
  } else if constexpr (kVec && K == 2) {
    float2 x = make_float2(0.f, 0.f);
    if (first < samples) x = *reinterpret_cast<const float2*>(row + first);
    v[0] = clamp_tau(x.x), v[1] = clamp_tau(x.y);
  } else {
    static_assert(!kVec, "vector access takes K = 2 or 4");
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int i = first + j;
      v[j] = i < samples ? clamp_tau(row[i]) : 0.f;
    }
  }
}

// Stores x[0 .. K-1] at first .. first + K - 1, skipping what lies past the row.
template <int K, bool kVec>
__device__ __forceinline__ void store_samples(float* __restrict__ row, int first, int samples,
                                              const float (&x)[K]) {
  if constexpr (kVec && K == 4) {
    if (first < samples)
      *reinterpret_cast<float4*>(row + first) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (kVec && K == 2) {
    if (first < samples) *reinterpret_cast<float2*>(row + first) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (first + j < samples) row[first + j] = x[j];
  }
}

template <int K, bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
weights_fwd_kernel(const float* __restrict__ tau, float* __restrict__ w, float* __restrict__ e,
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
    load_samples<K, kVec>(t_row, first, samples, v);
    float lane_sum = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) lane_sum += v[j];
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
    float trans = expf(-p);  // exp(-P) of this lane's first sample
    float wv[K], ev[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float p_next = p + v[j];
      const float trans_next = expf(-p_next);
      wv[j] = trans - trans_next;
      ev[j] = trans_next;
      trans = trans_next;
      p = p_next;
    }
    store_samples<K, kVec>(w_row, first, samples, wv);
    store_samples<K, kVec>(e_row, first, samples, ev);
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

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int K, bool kVec>
void launch_fwd(const float* tau, float* w, float* e, int rays, int samples, cudaStream_t stream) {
  const dim3 grid((rays + kWarpsPerBlock - 1) / kWarpsPerBlock);
  weights_fwd_kernel<K, kVec><<<grid, kWarpsPerBlock * kWarp, 0, stream>>>(tau, w, e, rays,
                                                                          samples);
}

}  // namespace

// K1a. The vector variant runs where S is a multiple of k and tau, w and e
// are aligned to 4k bytes (then so is every row); the scalar one elsewhere.
extern "C" int volren_weights_fwd(const float* tau, float* w, float* e,
                                  int rays, int samples, cudaStream_t stream) {
  if (rays <= 0 || samples <= 0) return static_cast<int>(cudaSuccess);
  const int k = per_lane(samples);
  const bool vec = (k == 2 || k == 4) && samples % k == 0 && aligned(tau, 4 * k) &&
                   aligned(w, 4 * k) && aligned(e, 4 * k);
  switch (k) {
    case 1: launch_fwd<1, false>(tau, w, e, rays, samples, stream); break;
    case 2:
      if (vec) launch_fwd<2, true>(tau, w, e, rays, samples, stream);
      else launch_fwd<2, false>(tau, w, e, rays, samples, stream);
      break;
    case 3: launch_fwd<3, false>(tau, w, e, rays, samples, stream); break;
    default:
      if (vec) launch_fwd<4, true>(tau, w, e, rays, samples, stream);
      else launch_fwd<4, false>(tau, w, e, rays, samples, stream);
      break;
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
