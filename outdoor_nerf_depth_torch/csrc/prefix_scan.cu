// Inclusive prefix sums of row-major float32 arrays, for Hopper (sm_90a):
// prefix_scan_batched_f32 scans [batch, rows, lanes] along axis 1, one
// independent scan per batch element (the carry resets at each).
// out[b, r, l] = sum_{i <= r} x[b, i, l], accumulated in f32; lanes divides
// 128, any rows >= 1. It serves two TPU kernels of the reference package's
// `ops/pallas_scan.py`:
//
//   K2b  `_scan_kernel_batched` (public op `cumsum_batched`), the 16 hash
//        levels' scans in one launch, which the osplit backward probe times;
//   K2a  `_scan_kernel` (public op `cumsum`), [rows, lanes] along axis 0, as
//        batch = 1: the Instant-NGP hash-table gradient runs it once per
//        level on the [samples, 8F] value stream sorted by table row.
//
// The TPU kernel folds 128/lanes rows into one 128-lane row and threads the
// carry through its sequential grid. Blocks on the card run in parallel and
// in no order, so this is a single-pass scan with decoupled look-back
// (Merrill and Garland, "Single-pass Parallel Prefix Scan with Decoupled
// Look-back", NVIDIA 2016), one launch per call:
//
//   - Tiles of kTileElems elements (16384 / lanes rows) are numbered over
//     (batch element, tile within it), and a tile never straddles two
//     elements. A block takes its tile from a global ticket counter when it
//     starts, not from blockIdx: a tile then only waits on tiles taken by
//     blocks that are already running, so the look-back cannot wait on a
//     block that was never scheduled.
//   - Each tile publishes one 64-bit status word per lane, flag in the high
//     half and float bits in the low half, stored with st.release.gpu and
//     read with ld.acquire.gpu: first its aggregate (flag A) as soon as its
//     block-wide sum is known, then its inclusive prefix (flag P) once its
//     look-back ends. The first tile of each element publishes P at once
//     with a carry of 0: that is the batch reset.
//   - Look-back: thread t reads lane t % lanes of kLookItems consecutive
//     predecessors, so one step reads a window of 2 * 256 / lanes
//     predecessors of every lane at once (32 at lanes = 16); per lane, the
//     window's values are summed up to the nearest P with shuffles and one
//     shared-memory step, and the window moves on while some lane has met
//     only A's. A slot still unpublished is waited on.
//   - The scratch, [batch * tiles * lanes] status words and one ticket
//     word, must be all zero at each call: the wrapper allocates it zeroed
//     (one memset, which a CUDA graph records as a memset node).
//
// Which predecessors have published P when a tile looks back depends on
// timing, so the f32 carries are summed in an order that can change from
// run to run: the scan is not bit-reproducible. The difference between runs
// is a few ulps of the running |x| sum.
//
// Inside a tile, thread t owns a column of VEC lanes (a float4 where lanes
// >= 4 and the pointers are 16-byte aligned; one float otherwise, which is
// how lanes 1 and 2 run) and kPerThread / VEC consecutive rows of it: a
// warp's loads at one row step are runs of `lanes` contiguous floats, so
// every 32-byte sector it fetches is used whole. Each thread scans its rows
// in registers; warp shuffles, then one shared-memory step over the warps,
// join the threads of one column.
//
// Bound: memory. The function reads 4 B and writes 4 B per element, and this
// design moves just that (plus 8 B of status per tile and lane): at the
// probe's [16, 524288, 16], 1.07 GB, 0.320 ms at 3.35 TB/s. The three-pass
// reduce-then-scan it replaces (tile totals, one block scanning them, each
// tile scanned again with its carry) read the input twice, 12 B per element,
// and took 0.6515 ms there and 16.34 us at K2a's [262144, 16] on one H100
// 80GB HBM3 at 700 W (chip_smoke.py). Tiles of 16384 elements were faster
// than 8192 and 4096 at both shapes: fewer look-backs, more bytes in flight
// per block (~100 registers a thread, two blocks per SM).
//
// Interface: plain C, loaded with ctypes. The kernel launches on the
// caller's stream and allocates nothing: the caller passes the scratch. The
// entry point returns a cudaError_t.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;                      // threads of a tile block
constexpr int kPerThread = 64;                     // elements per thread per tile
constexpr int kTileElems = kThreads * kPerThread;  // 16384 elements per tile
constexpr int kMaxLanes = 128;
constexpr unsigned long long kFlagAggregate = 1ull << 32;
constexpr unsigned long long kFlagPrefix = 2ull << 32;
constexpr int kLookItems = 2;                      // predecessors a thread reads per step
constexpr unsigned int kMaxSpins = 1u << 24;       // reads of one status word, ~seconds

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long status_word(unsigned long long flag, float v) {
  return flag | __float_as_uint(v);
}

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
};
template <>
struct Vec<4> {
  using T = float4;
};

__device__ __forceinline__ float& at(float& v, int) { return v; }
__device__ __forceinline__ float& at(float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

template <int LANES, int VEC>
__global__ void __launch_bounds__(kThreads)
prefix_scan_lookback_kernel(const float* __restrict__ x, float* __restrict__ out,
                            unsigned long long* __restrict__ status,
                            unsigned int* __restrict__ ticket, long long rows,
                            unsigned int tiles_per_elem) {
  using V = typename Vec<VEC>::T;
  constexpr int kCols = LANES / VEC;                 // columns of a row
  constexpr int kRowsPerThread = kPerThread / VEC;
  constexpr int kTileRows = kTileElems / LANES;
  // Segments of a column: its threads in one warp where a warp holds several
  // threads of it, else each thread on its own.
  constexpr int kSegments = kThreads / (kCols < 32 ? 32 : kCols);
  constexpr int kGroups = kThreads / LANES;          // look-back groups of a lane
  constexpr int kParts = LANES < 32 ? kThreads / 32 : kGroups;

  __shared__ unsigned int s_tile;
  __shared__ float s_seg[kSegments * LANES];
  __shared__ float s_carry[LANES];
  __shared__ int s_done[LANES];
  __shared__ int s_first[LANES];
  __shared__ float s_part[kParts * LANES];

  const int t = threadIdx.x;
  if (t == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const unsigned int tile = s_tile;
  const unsigned int k = tile % tiles_per_elem;  // tile within its batch element
  const long long b = tile / tiles_per_elem;
  const long long row_begin = static_cast<long long>(k) * kTileRows;
  const long long n_rows = rows - row_begin < kTileRows ? rows - row_begin : kTileRows;
  const long long offset = (b * rows + row_begin) * LANES;
  const V* xt = reinterpret_cast<const V*>(x + offset);
  V* ot = reinterpret_cast<V*>(out + offset);

  const int col = t % kCols;
  const int r0 = (t / kCols) * kRowsPerThread;
  V v[kRowsPerThread];
  float run[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) run[i] = 0.f;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = r0 + j;
    if (r < n_rows) {
      v[j] = xt[r * kCols + col];
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) at(v[j], i) = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      run[i] += at(v[j], i);
      at(v[j], i) = run[i];  // inclusive over this thread's rows
    }
  }

  // Exclusive sum over the threads of this column before this one.
  const int wl = t & 31;
  float incl[VEC], excl[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) incl[i] = run[i];
  if (kCols < 32) {
#pragma unroll
    for (int off = kCols; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float y = __shfl_up_sync(0xffffffffu, incl[i], off);
        if (wl >= off) incl[i] += y;
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float y = __shfl_up_sync(0xffffffffu, incl[i], kCols);
      excl[i] = wl >= kCols ? y : 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) excl[i] = 0.f;
  }
  const int seg = kCols < 32 ? t / 32 : t / kCols;
  if (kCols >= 32 || wl >= 32 - kCols) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) s_seg[seg * LANES + col * VEC + i] = incl[i];
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kSegments - 1; ++s) {
    if (s < seg) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) excl[i] += s_seg[s * LANES + col * VEC + i];
    }
  }

  // Publish the tile's aggregate (or, for an element's first tile, its
  // inclusive prefix), then look back for the carry.
  unsigned long long* tile_status = status + static_cast<unsigned long long>(tile) * LANES;
  float aggregate = 0.f;
  if (t < LANES) {
#pragma unroll
    for (int s = 0; s < kSegments; ++s) aggregate += s_seg[s * LANES + t];
    store_release(tile_status + t, status_word(k == 0 ? kFlagPrefix : kFlagAggregate, aggregate));
    s_carry[t] = 0.f;
    s_done[t] = k == 0;
  }
  if (k > 0) {
    // Thread t reads kLookItems consecutive predecessors of lane t % LANES:
    // group g = t / LANES covers tiles 1 + g * kLookItems ... back, nearest
    // first, and sums them up to its first P. The window of a step is the
    // groups up to the nearest one that met a P.
    const int lane = t % LANES, group = t / LANES;
    long long back = 1 + group * kLookItems;
    if (t < LANES) s_first[t] = kGroups;
    __syncthreads();
    for (;;) {
      float sum = 0.f;
      bool hit = false;
      if (!s_done[lane]) {
        unsigned long long word[kLookItems];
#pragma unroll
        for (int m = 0; m < kLookItems; ++m)  // before the element's start: P of 0
          word[m] = back + m <= k ? load_acquire(tile_status - (back + m) * LANES + lane)
                                  : kFlagPrefix;
#pragma unroll
        for (int m = 0; m < kLookItems; ++m) {
          unsigned int spins = 0;
          while ((word[m] >> 32) == 0) {
            // A predecessor that never publishes is a fault: trap (an error
            // at the next synchronize) rather than hang the card.
            if (++spins == kMaxSpins) __trap();
            word[m] = load_acquire(tile_status - (back + m) * LANES + lane);
          }
          if (!hit) {
            sum += __uint_as_float(static_cast<unsigned int>(word[m]));
            hit = (word[m] & kFlagPrefix) != 0;
          }
        }
      }
      if (hit) atomicMin(&s_first[lane], group);
      __syncthreads();
      float part = group <= s_first[lane] ? sum : 0.f;
      // Sum over the groups of this lane: shuffles within a warp, then the
      // warps' (or, for LANES >= 32, the groups') partials in shared memory.
#pragma unroll
      for (int off = LANES; off < 32; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (LANES >= 32 || wl < LANES) s_part[(LANES < 32 ? t / 32 : group) * LANES + lane] = part;
      __syncthreads();
      if (t < LANES && !s_done[t]) {
        float carry = s_carry[t];
#pragma unroll
        for (int p = 0; p < kParts; ++p) carry += s_part[p * LANES + t];
        s_carry[t] = carry;
        s_done[t] = s_first[t] < kGroups;
        s_first[t] = kGroups;
      }
      if (__syncthreads_and(t >= LANES || s_done[t])) break;
      back += kGroups * kLookItems;
    }
    if (t < LANES)
      store_release(tile_status + t, status_word(kFlagPrefix, s_carry[t] + aggregate));
  }
  __syncthreads();

  float base[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) base[i] = s_carry[col * VEC + i] + excl[i];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = r0 + j;
    if (r < n_rows) {
      V o;
#pragma unroll
      for (int i = 0; i < VEC; ++i) at(o, i) = base[i] + at(v[j], i);
      ot[r * kCols + col] = o;
    }
  }
}

template <int LANES>
cudaError_t launch_lookback(const float* x, float* out, unsigned long long* scratch,
                            long long batch, long long rows, long long tiles_per_elem,
                            bool vec4, cudaStream_t stream) {
  const unsigned int n_tiles = static_cast<unsigned int>(batch * tiles_per_elem);
  unsigned int* ticket =
      reinterpret_cast<unsigned int*>(scratch + static_cast<unsigned long long>(n_tiles) * LANES);
  const unsigned int per = static_cast<unsigned int>(tiles_per_elem);
  if constexpr (LANES >= 4) {
    if (vec4) {
      prefix_scan_lookback_kernel<LANES, 4>
          <<<n_tiles, kThreads, 0, stream>>>(x, out, scratch, ticket, rows, per);
      return cudaGetLastError();
    }
  }
  prefix_scan_lookback_kernel<LANES, 1>
      <<<n_tiles, kThreads, 0, stream>>>(x, out, scratch, ticket, rows, per);
  return cudaGetLastError();
}

// f(std::integral_constant<int, lanes>) for lanes dividing kMaxLanes.
template <typename F>
cudaError_t with_lanes(int lanes, F&& f) {
  switch (lanes) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return f(std::integral_constant<int, 128>{});
  }
}

}  // namespace

// out[b] = inclusive cumsum of x[b] along rows, for each b < batch (K2b; K2a
// with batch = 1), in one launch. `scratch` is batch * tiles_per_elem * lanes + 1 64-bit words,
// all zero (the status words, then the ticket counter); tiles_per_elem =
// ceil(rows / (kTileElems / lanes)), any other value is refused.
extern "C" int prefix_scan_batched_f32(const float* x, float* out, unsigned long long* scratch,
                                       long long batch, long long rows, int lanes,
                                       long long tiles_per_elem, cudaStream_t stream) {
  if (lanes <= 0 || lanes > kMaxLanes || kMaxLanes % lanes != 0 || rows < 0 || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || batch == 0) return static_cast<int>(cudaSuccess);
  const long long tile_rows = kTileElems / lanes;
  if (tiles_per_elem != (rows + tile_rows - 1) / tile_rows || batch * tiles_per_elem > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec4 = lanes >= 4 && reinterpret_cast<unsigned long long>(x) % 16 == 0 &&
                    reinterpret_cast<unsigned long long>(out) % 16 == 0;
  return static_cast<int>(with_lanes(lanes, [&](auto l) {
    return launch_lookback<decltype(l)::value>(x, out, scratch, batch, rows, tiles_per_elem,
                                               vec4, stream);
  }));
}
