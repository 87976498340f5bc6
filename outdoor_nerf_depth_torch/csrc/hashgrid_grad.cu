// The osplit hash-table gradient's two streaming stages, for Hopper (sm_90a),
// over all levels of the grid in one launch each:
//
//   K3a  osplit_grad_products_f32: the bf16-rounded products of the corner
//        weights and the cotangent, in the order of the sorted row ids.
//   K3b  osplit_grad_fold_f32: each canonical table row's gradient, from the
//        prefix sums of those products at the segment ends, folded back from
//        the eight physical rows that hold it.
//
// Neither replaces a TPU kernel. The reference package computes these stages
// with XLA ops (`ops/hashgrid.py:_oct_split_grad_encode`: a product, a cast,
// a gather by the sort's permutation, the row sums at the segment ends and
// eight rolls a level). The port ran them the same way, as ~42 PyTorch
// launches a level; on an NGP train step of 16 levels that is ~670 launches
// paced by the host, and the two row gathers alone took ~6.8 ms of device
// time (row-count bound, 0.61 ns a 16-lane row). Between the two kernels
// one K2b launch (`prefix_scan.cu`) scans all levels at once.
//
// K3a. For level l and sorted position i, with p the point the sort put
// there, vals[l, i, c F + f] = f32(bf16(w[p, l, c] * g[p, l, f])). One
// thread per (l, i, c): the 8 threads of a sorted row read the point's 8
// weights (one 32-byte sector) and its F cotangent values (broadcast), and
// the warp writes 4 rows of 8F floats, contiguous. Bound: memory. Per row
// it reads the 8-byte sort index, 32 B of weights and 4F B of cotangent and
// writes 32F B: 0.47 GB at the NGP train step's 16 x 262,144 rows, F = 2,
// 0.14 ms at 3.35 TB/s. The weight and cotangent reads follow the sort's
// permutation, so their sectors come from anywhere in the [P, L, 8] and
// [P, L, F] arrays; each sector is used whole.
//
// K3b. For level l, canonical row j and feature f, it sums over the corners
// c = 0..7 in lane order: with r = (j - offset_c) mod T, the physical row
// that holds canonical row j in lane c, and e_r the number of sorted entries
// of rows <= r (a flat position, from the level's first entry l P on),
// add csum[e_r - 1, c F + f] - csum[e_{r-1} - 1, c F + f], each term 0 where
// its end is at the level's first entry, or 0 where r is at or past the
// level's trimmed row count. The first corner's term is the sum's start and
// each further term is added to it, as the port's `_fold` adds its rolls:
// given the same prefix sums the result is the plain version's, bit for bit.
// One thread per (l, j): neighbouring threads read neighbouring ends, so the
// ends are read coalesced and the prefix sums in runs. Bound: memory. It
// reads one prefix-sum row (32F B) at the end of each non-empty segment,
// not every sorted row, the ends of the trimmed rows (4 B each) and writes
// 4F B a table row: at the train step's shape about 2.8M of the 4.2M
// sorted rows end a segment (uniform row ids; the dense levels' 4,913 to
// 91,125 rows each take 262,144 points, ~60% of the hashed rows are
// empty), ~0.27 GB, ~0.08 ms at 3.35 TB/s. The prefix-sum reads jump by
// the corner offsets (a 32-byte sector serves four corners, read at four
// different j), so the card reads them up to four times, mostly from L2.
//
// The levels' eight offsets and trimmed row counts go to K3b by value, in a
// LevelPlan kernel argument (64 levels x 9 int32 = 2.3 KB of the 4 KB of
// kernel parameters): nothing is copied to the card for them, and nothing
// waits for the card.
//
// Interface: plain C, loaded with ctypes. The kernels launch on the caller's
// stream and allocate nothing. The entry points return a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kCorners = 8;
constexpr int kMaxLevels = 64;

struct LevelPlan {
  int offsets[kMaxLevels][kCorners];  // row offset of corner c, lane order
  int rows[kMaxLevels];               // trimmed physical rows of the level
};

template <int F>
__global__ void __launch_bounds__(kThreads)
osplit_grad_products_kernel(const long long* __restrict__ order, const float* __restrict__ w,
                            const float* __restrict__ g, float* __restrict__ vals,
                            long long points, int levels) {
  const long long l = blockIdx.y;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= points * kCorners) return;
  const long long i = t / kCorners;
  const int c = static_cast<int>(t % kCorners);
  const long long p = order[l * points + i] - l * points;  // the point at sorted position i
  const float wc = w[(p * levels + l) * kCorners + c];
  const float* gp = g + (p * levels + l) * F;
  float* out = vals + (l * points + i) * (kCorners * F) + c * F;
#pragma unroll
  for (int f = 0; f < F; ++f)
    out[f] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(wc, gp[f])));
}

template <int F>
__global__ void __launch_bounds__(kThreads)
osplit_grad_fold_kernel(const float* __restrict__ csum, const int* __restrict__ ends,
                        float* __restrict__ out, long long points, long long table_size,
                        LevelPlan plan) {
  const int l = blockIdx.y;
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= table_size) return;
  const long long mask = table_size - 1;  // T is a power of two
  const long long first = l * points;     // flat position of the level's first entry
  const long long rows = plan.rows[l];
  const int* e = ends + l * table_size;
  float acc[F];
#pragma unroll
  for (int c = 0; c < kCorners; ++c) {
    const long long r = (j - plan.offsets[l][c]) & mask;
    float v[F];
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = 0.f;
    if (r < rows) {
      const long long hi = e[r];
      const long long lo = r > 0 ? e[r - 1] : first;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const long long lane = c * F + f;
        const float ge_hi = hi > first ? csum[(hi - 1) * (kCorners * F) + lane] : 0.f;
        const float ge_lo = lo > first ? csum[(lo - 1) * (kCorners * F) + lane] : 0.f;
        v[f] = ge_hi - ge_lo;
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = c == 0 ? v[f] : acc[f] + v[f];
  }
  float* o = out + (l * table_size + j) * F;
#pragma unroll
  for (int f = 0; f < F; ++f) o[f] = acc[f];
}

// fn(std::integral_constant<int, F>) for F in {1, 2, 4, 8, 16}: 8F lanes
// divide the scan's 128.
template <typename Fn>
cudaError_t with_features(int features, Fn&& fn) {
  switch (features) {
    case 1: return fn(std::integral_constant<int, 1>{});
    case 2: return fn(std::integral_constant<int, 2>{});
    case 4: return fn(std::integral_constant<int, 4>{});
    case 8: return fn(std::integral_constant<int, 8>{});
    case 16: return fn(std::integral_constant<int, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

bool valid_shape(long long levels, long long points, int features) {
  return levels >= 1 && levels <= kMaxLevels && points >= 0 && points <= 0x0fffffffLL &&
         (features == 1 || features == 2 || features == 4 || features == 8 || features == 16);
}

}  // namespace

// K3a. order: [levels * points] int64, the flat positions l * points + p of
// the level-offset row ids in sorted order (each level's block holds its own
// points); w: [points, levels, 8] float32; g: [points, levels, features]
// float32; vals: [levels, points, 8 * features] float32, written.
extern "C" int osplit_grad_products_f32(const long long* order, const float* w, const float* g,
                                        float* vals, long long levels, long long points,
                                        int features, cudaStream_t stream) {
  if (!valid_shape(levels, points, features)) return static_cast<int>(cudaErrorInvalidValue);
  if (points == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(static_cast<unsigned int>((points * kCorners + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(levels));
  return static_cast<int>(with_features(features, [&](auto f) {
    osplit_grad_products_kernel<decltype(f)::value>
        <<<grid, kThreads, 0, stream>>>(order, w, g, vals, points, static_cast<int>(levels));
    return cudaGetLastError();
  }));
}

// K3b. csum: [levels, points, 8 * features] float32, each level's prefix
// sums; ends: [levels, table_size] int32, flat positions (from l * points)
// one past the level's last entry of each row; offsets: host [levels * 8]
// int32, the corners' row offsets in lane order; rows: host [levels] int32,
// each level's trimmed row count (<= table_size); out: [levels, table_size,
// features] float32, written. table_size is a power of two.
extern "C" int osplit_grad_fold_f32(const float* csum, const int* ends, float* out,
                                    long long levels, long long points, long long table_size,
                                    int features, const int* offsets, const int* rows,
                                    cudaStream_t stream) {
  if (!valid_shape(levels, points, features) || table_size < 1 ||
      table_size > 0x40000000LL || (table_size & (table_size - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  LevelPlan plan = {};
  for (long long l = 0; l < levels; ++l) {
    if (rows[l] < 0 || rows[l] > table_size) return static_cast<int>(cudaErrorInvalidValue);
    plan.rows[l] = rows[l];
    for (int c = 0; c < kCorners; ++c) plan.offsets[l][c] = offsets[l * kCorners + c];
  }
  const dim3 grid(static_cast<unsigned int>((table_size + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(levels));
  return static_cast<int>(with_features(features, [&](auto f) {
    osplit_grad_fold_kernel<decltype(f)::value>
        <<<grid, kThreads, 0, stream>>>(csum, ends, out, points, table_size, plan);
    return cudaGetLastError();
  }));
}
