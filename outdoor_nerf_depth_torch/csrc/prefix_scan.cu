// Inclusive prefix sums of row-major float32 arrays, for Hopper (sm_90a):
//
//   K2a  prefix_scan_f32:          [rows, lanes] along axis 0;
//   K2b  prefix_scan_batched_f32:  [batch, rows, lanes] along axis 1, one
//        independent scan per batch element (the carry resets at each).
//
// K2a replaces the Pallas TPU kernel `ops/pallas_scan.py:_scan_kernel` of
// the reference package (public op `cumsum`), which the Instant-NGP
// hash-table gradient runs once per level on the [samples, 8F] value stream
// sorted by table row. K2b replaces `_scan_kernel_batched` (public op
// `cumsum_batched`), the 16 levels' scans in one launch, which the osplit
// backward probe times. out[.., r, l] = sum_{i <= r} x[.., i, l],
// accumulated in f32; lanes divides 128, any rows >= 1.
//
// The TPU kernel folds 128/lanes rows into one 128-lane row and threads the
// carry through its sequential grid. Blocks on the card run in parallel and
// in no order, so this is a reduce-then-scan in three launches:
//
//   1. reduce: one block per tile of kTileElems elements (8192 / lanes rows)
//      writes the tile's per-lane totals;
//   2. carry:  one block scans the tile totals per lane, in place, into each
//      tile's exclusive carry;
//   3. apply:  one block per tile scans the tile again and adds its carry.
//
// K2b runs the same three kernels with blockIdx.y selecting the batch
// element in passes 1 and 3 and one carry block per batch element in pass
// 2; the scratch is [batch, n_tiles, lanes]. The batch offsets are a
// template switch (BATCHED), so K2a's kernels carry none of them: with them
// K2a's reduce pass took 48 registers instead of 26 and K2a ran ~1.4x
// slower on the card.
// Lanes are not folded into 128-wide rows: that is the TPU's layout.
//
// Inside a tile, thread t owns lane t % lanes and kPerThread consecutive rows
// of it: a warp's loads at one row step are 32 / lanes runs of `lanes`
// contiguous floats, so every 32-byte sector it fetches is used whole. Each
// thread sums its rows in registers; a shared-memory scan over the threads
// of one lane joins them.
//
// Bound: memory. The function reads 4 B and writes 4 B per element (at the
// hash-grid backward's [262144, 16], 33.6 MB, 10.0 us at 3.35 TB/s; K2b at
// the probe's [16, 524288, 16], 1.07 GB, 0.320 ms). This
// design reads the input twice (passes 1 and 3), so it moves 12 B per
// element; a single-pass chained scan with decoupled look-back would move 8.
//
// Interface: plain C, loaded with ctypes. The kernels launch on the caller's
// stream and allocate nothing: the caller passes the [batch, n_tiles, lanes]
// f32 scratch for the tile totals. Each entry point returns a cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                      // threads of a tile block
constexpr int kPerThread = 32;                     // rows per thread per tile
constexpr int kTileElems = kThreads * kPerThread;  // 8192 elements per tile
constexpr int kCarryThreads = 1024;                // threads of the carry block
constexpr int kMaxLanes = 128;
constexpr long long kMaxBatch = 65535;             // gridDim.y limit

// Inclusive scan of `v` over the threads t, t - LANES, t - 2 LANES, ... (the
// threads of one lane), in shared memory `sm` of `n` floats. Returns the sum
// over the threads of this lane before this one (exclusive).
template <int LANES>
__device__ __forceinline__ float exclusive_over_groups(float v, float* sm, int n) {
  const int t = threadIdx.x;
  sm[t] = v;
  __syncthreads();
  for (int off = LANES; off < n; off <<= 1) {
    const float y = t >= off ? sm[t - off] : 0.f;
    __syncthreads();
    sm[t] += y;
    __syncthreads();
  }
  const float excl = t >= LANES ? sm[t - LANES] : 0.f;
  __syncthreads();
  return excl;
}

template <int LANES, bool BATCHED>
__global__ void __launch_bounds__(kThreads)
prefix_scan_reduce_kernel(const float* __restrict__ x, float* __restrict__ tile_sums,
                          long long rows) {
  constexpr int kTileRows = kTileElems / LANES;
  const int t = threadIdx.x;
  const int lane = t % LANES;
  const long long row0 =
      static_cast<long long>(blockIdx.x) * kTileRows + (t / LANES) * kPerThread;
  if (BATCHED) x += static_cast<long long>(blockIdx.y) * rows * LANES;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long r = row0 + j;
    if (r < rows) s += x[r * LANES + lane];
  }
  __shared__ float sm[kThreads];
  sm[t] = s;
  __syncthreads();
  // Tree over the threads of each lane: stride and t + stride share a lane.
  for (int stride = kThreads / 2; stride >= LANES; stride >>= 1) {
    if (t < stride) sm[t] += sm[t + stride];
    __syncthreads();
  }
  const long long tile =
      BATCHED ? static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x : blockIdx.x;
  if (t < LANES) tile_sums[tile * LANES + t] = sm[t];
}

// One block per batch element b: tile_sums[b, k, l] <- sum_{i < k}
// tile_sums[b, i, l], in place.
template <int LANES, bool BATCHED>
__global__ void __launch_bounds__(kCarryThreads)
prefix_scan_carry_kernel(float* __restrict__ tile_sums, long long n_tiles) {
  constexpr int kGroups = kCarryThreads / LANES;
  if (BATCHED) tile_sums += static_cast<long long>(blockIdx.x) * n_tiles * LANES;
  const int t = threadIdx.x;
  const int lane = t % LANES;
  const long long per = (n_tiles + kGroups - 1) / kGroups;
  const long long first = (t / LANES) * per;
  long long last = first + per;
  if (last > n_tiles) last = n_tiles;
  float s = 0.f;
  for (long long k = first; k < last; ++k) s += tile_sums[k * LANES + lane];
  __shared__ float sm[kCarryThreads];
  float run = exclusive_over_groups<LANES>(s, sm, kCarryThreads);
  for (long long k = first; k < last; ++k) {
    const float v = tile_sums[k * LANES + lane];
    tile_sums[k * LANES + lane] = run;
    run += v;
  }
}

template <int LANES, bool BATCHED>
__global__ void __launch_bounds__(kThreads)
prefix_scan_apply_kernel(const float* __restrict__ x, const float* __restrict__ tile_carry,
                         float* __restrict__ out, long long rows) {
  constexpr int kTileRows = kTileElems / LANES;
  const int t = threadIdx.x;
  const int lane = t % LANES;
  const long long row0 =
      static_cast<long long>(blockIdx.x) * kTileRows + (t / LANES) * kPerThread;
  if (BATCHED) {
    const long long batch_off = static_cast<long long>(blockIdx.y) * rows * LANES;
    x += batch_off;
    out += batch_off;
  }
  float v[kPerThread];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long r = row0 + j;
    s += r < rows ? x[r * LANES + lane] : 0.f;
    v[j] = s;  // inclusive over this thread's rows
  }
  __shared__ float sm[kThreads];
  const float excl = exclusive_over_groups<LANES>(s, sm, kThreads);
  const long long tile =
      BATCHED ? static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x : blockIdx.x;
  const float base = tile_carry[tile * LANES + lane] + excl;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long r = row0 + j;
    if (r < rows) out[r * LANES + lane] = base + v[j];
  }
}

template <int LANES, bool BATCHED>
cudaError_t launch(const float* x, float* out, float* tile_sums, long long batch, long long rows,
                   long long n_tiles, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(batch));
  prefix_scan_reduce_kernel<LANES, BATCHED><<<grid, kThreads, 0, stream>>>(x, tile_sums, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  prefix_scan_carry_kernel<LANES, BATCHED>
      <<<static_cast<unsigned>(batch), kCarryThreads, 0, stream>>>(tile_sums, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  prefix_scan_apply_kernel<LANES, BATCHED><<<grid, kThreads, 0, stream>>>(x, tile_sums, out, rows);
  return cudaGetLastError();
}

template <bool BATCHED>
int scan(const float* x, float* out, float* tile_sums, long long batch, long long rows, int lanes,
         long long n_tiles, cudaStream_t stream) {
  if (lanes <= 0 || lanes > kMaxLanes || kMaxLanes % lanes != 0 || rows < 0 || batch < 0 ||
      batch > kMaxBatch)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  const long long tile_rows = kTileElems / lanes;
  if (n_tiles != (rows + tile_rows - 1) / tile_rows || n_tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (lanes) {
    case 1: err = launch<1, BATCHED>(x, out, tile_sums, batch, rows, n_tiles, stream); break;
    case 2: err = launch<2, BATCHED>(x, out, tile_sums, batch, rows, n_tiles, stream); break;
    case 4: err = launch<4, BATCHED>(x, out, tile_sums, batch, rows, n_tiles, stream); break;
    case 8: err = launch<8, BATCHED>(x, out, tile_sums, batch, rows, n_tiles, stream); break;
    case 16: err = launch<16, BATCHED>(x, out, tile_sums, batch, rows, n_tiles, stream); break;
    case 32: err = launch<32, BATCHED>(x, out, tile_sums, batch, rows, n_tiles, stream); break;
    case 64: err = launch<64, BATCHED>(x, out, tile_sums, batch, rows, n_tiles, stream); break;
    default: err = launch<128, BATCHED>(x, out, tile_sums, batch, rows, n_tiles, stream); break;
  }
  return static_cast<int>(err);
}

}  // namespace

// out = inclusive cumsum of x along rows (K2a). `tile_sums` is scratch of
// n_tiles * lanes floats, n_tiles = ceil(rows / (kTileElems / lanes)); any
// other n_tiles is refused.
extern "C" int prefix_scan_f32(const float* x, float* out, float* tile_sums, long long rows,
                               int lanes, long long n_tiles, cudaStream_t stream) {
  return scan<false>(x, out, tile_sums, 1, rows, lanes, n_tiles, stream);
}

// out[b] = inclusive cumsum of x[b] along rows, for each b < batch (K2b);
// `tile_sums` is scratch of batch * n_tiles * lanes floats, n_tiles as above.
extern "C" int prefix_scan_batched_f32(const float* x, float* out, float* tile_sums,
                                       long long batch, long long rows, int lanes,
                                       long long n_tiles, cudaStream_t stream) {
  return scan<true>(x, out, tile_sums, batch, rows, lanes, n_tiles, stream);
}
