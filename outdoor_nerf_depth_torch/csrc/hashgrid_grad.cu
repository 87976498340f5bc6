// The osplit hash grid's forward and its table gradient's two streaming
// stages, for Hopper (sm_90a), over all levels of the grid in one launch each:
//
//   K4   osplit_encode: the encoding itself, read from the canonical f32
//        table, and what the table gradient's one pass reads.
//   K3a  osplit_grad_products_f32: the bf16-rounded products of the corner
//        weights and the cotangent, in the order of the sorted row ids.
//   K3b  osplit_grad_fold_f32: each canonical table row's gradient, from the
//        prefix sums of those products at the segment ends, folded back from
//        the eight physical rows that hold it.
//
// K4 replaces no TPU kernel either. The reference package (and the port
// before it) packs each level's f32 table into a bf16 "physical" table whose
// row i holds the canonical rows i + offset_c of the cell's eight corners
// (`ops/hashgrid.py:build_oct_tables_split`), then gathers one packed row a
// point and level and blends it; the port rebuilt the sixteen packed tables
// on every forward (an int64 index tensor, a gather and a cast a level, ~1.5
// GB of traffic at T = 2^19) and ran the index and weight math level by
// level, ~340 launches and 32 synchronizing copies of host constants a
// forward. K4 computes, for one point and level per thread, exactly what
// that path computed, in the same f32 operations:
//   x clamped to [0, 1]; pos = x res; cell = clamp(floor(pos), 0, res - 1);
//   frac = pos - cell; weight of corner c = 4 cx + 2 cy + cz is
//   (f0 f1) f2 with f_d = frac_d where the corner's bit d is set, else
//   1 - frac_d; the base row x s^2 + y s + z (s = res + 1) on dense levels,
//   else (x P1 + y P2 + z) mod T; corner c's row (base + offset_c) mod T;
//   each table value rounded to bf16 (what the packed table held) and
//   widened; the products w_c v_c summed over the corners in the order
//   PyTorch's CUDA sum over that axis takes (`sum8` below).
// Every operation is an explicit round-to-nearest intrinsic, so no multiply
// and add contract into an FMA: the features equal the plain path's bit for
// bit. Without a gradient it writes the features only; for the table
// gradient it also writes the level-offset int32 row keys [L, P] that the
// backward sorts and the weights [P, L, 8]; for the points' gradient the
// bf16 corner values [P, L, 8F].
//
// K4's threads: a warp takes 32 consecutive points of one level, and the
// warps of a group of 32 points walk its levels. Points along a ray sit in
// consecutive rows, so on the coarse levels a warp's table reads fall in few
// sectors; the key writes are coalesced, and the feature and weight writes
// of the group's warps fill the same rows of [P, L F] and [P, L, 8] at about
// the same time. (Running the levels one after another, so that one level's
// 4 MB of table stays in L2, read 0.73 against 0.46 ms at 524,288 points
// along rays on an H100: the features' partial rows are written 16 times
// apart.)
// Under the linear hash the corners (cz = 0, cz = 1) are rows r and r + 1:
// for F <= 2 one 16-byte (8-byte) load at the even row below r reads both
// when r is even, and one more load reads row r + 1 (mod T: the pair wraps
// at T - 1) when r is odd. Bound: memory. Compulsory bytes a point are its
// 12 B of x and 4 L F B of features (plus 4 L B of keys and 32 L B of
// weights with the table gradient), and each distinct table row read is
// 4F B once; the table reads themselves are 32-byte sectors of rows
// scattered over the hashed levels, most from L2.
//
// Neither K3 kernel replaces a TPU kernel. The reference package computes
// these stages with XLA ops (`ops/hashgrid.py:_oct_split_grad_encode`: a
// product, a cast, a gather by the sort's permutation, the row sums at the
// segment ends and eight rolls a level). The port ran them the same way, as
// ~42 PyTorch launches a level; on an NGP train step of 16 levels that is
// ~670 launches paced by the host, and the two row gathers alone took ~6.8 ms of device
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
// kernel parameters), and K4's resolutions, dense strides and pair offsets
// in an EncodePlan (64 x 6 int32, 1.5 KB): nothing is copied to the card
// for them, and nothing waits for the card.
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

constexpr int kPairs = kCorners / 2;
constexpr unsigned kPrime1 = 2654435761u;  // the linear hash's y and x primes
constexpr unsigned kPrime2 = 805459861u;

struct EncodePlan {
  int res[kMaxLevels];                    // the level's grid resolution
  int stride[kMaxLevels];                 // s = res + 1 on a dense level, 0 on a hashed one
  int pair_offsets[kMaxLevels][kPairs];   // row offset of corner 2k; corner 2k + 1 is the next row
};

// e[0] + ... + e[7] as PyTorch's CUDA sum over the corner axis adds them
// (`torch.sum(..., dim=-2)` in `_blend_levels`, read off its reduction
// kernel and checked on the card). For F > 1 that axis is not the innermost:
// one thread, four accumulators started at 0, accumulator i takes e[i] then
// e[i + 4], and the four are combined left to right. For F = 1 it is the
// innermost: eight lanes hold 0 + e[c] each and a shuffle tree folds lane
// i + 4 onto lane i, then i + 2, then i + 1.
template <int F>
__device__ __forceinline__ float sum8(const float (&e)[kCorners]) {
  if constexpr (F == 1) {
    float u[kCorners];
#pragma unroll
    for (int c = 0; c < kCorners; ++c) u[c] = __fadd_rn(0.f, e[c]);
    const float a0 = __fadd_rn(u[0], u[4]), a1 = __fadd_rn(u[1], u[5]);
    const float a2 = __fadd_rn(u[2], u[6]), a3 = __fadd_rn(u[3], u[7]);
    return __fadd_rn(__fadd_rn(a0, a2), __fadd_rn(a1, a3));
  } else {
    float acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] = __fadd_rn(__fadd_rn(0.f, e[i]), e[i + 4]);
    return __fadd_rn(__fadd_rn(__fadd_rn(acc[0], acc[1]), acc[2]), acc[3]);
  }
}

__device__ __forceinline__ float lane(const float2& v, int i) { return i == 0 ? v.x : v.y; }
__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Rows r and r + 1 (mod T) of one level's [T, F] table. For F <= 2 the pair
// shares the aligned 8F-byte vector at the even row below r when r is even;
// when r is odd, row r + 1 starts the next vector (row 0's at r = T - 1).
template <int F>
__device__ __forceinline__ void load_pair(const float* __restrict__ level, unsigned r,
                                          unsigned mask, float (&a)[F], float (&b)[F]) {
  if constexpr (F <= 2) {
    using Vec = typename std::conditional<F == 1, float2, float4>::type;
    const Vec* rows2 = reinterpret_cast<const Vec*>(level);
    const Vec q = __ldg(rows2 + (r >> 1));
    if (r & 1u) {
      const Vec next = __ldg(rows2 + (((r + 1u) & mask) >> 1));
#pragma unroll
      for (int f = 0; f < F; ++f) {
        a[f] = lane(q, F + f);
        b[f] = lane(next, f);
      }
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        a[f] = lane(q, f);
        b[f] = lane(q, F + f);
      }
    }
  } else {
    const float4* ra = reinterpret_cast<const float4*>(level + static_cast<size_t>(r) * F);
    const float4* rb =
        reinterpret_cast<const float4*>(level + static_cast<size_t>((r + 1u) & mask) * F);
#pragma unroll
    for (int k = 0; k < F / 4; ++k) {
      const float4 u = __ldg(ra + k), v = __ldg(rb + k);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[4 * k + i] = lane(u, i);
        b[4 * k + i] = lane(v, i);
      }
    }
  }
}

// K4. One thread per (point p, level l): out[p, l F + f] in OutT; keys[l, p]
// (int32, the row id plus l T), w[p, l, 8] and rows[p, l, 8F] (bf16) where
// their pointers are not null.
template <int F, typename OutT>
__global__ void __launch_bounds__(kThreads)
osplit_encode_kernel(const float* __restrict__ x, const float* __restrict__ table,
                     OutT* __restrict__ out, int* __restrict__ keys, float* __restrict__ w_out,
                     __nv_bfloat16* __restrict__ rows_out, long long points, int levels,
                     unsigned table_size, EncodePlan plan) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long warp = t >> 5;
  const int l = static_cast<int>(warp % levels);
  const long long p = (warp / levels) * 32 + (threadIdx.x & 31);
  if (p >= points) return;
  const unsigned mask = table_size - 1u;
  const int res = plan.res[l];
  const float res_f = static_cast<float>(res);
  unsigned cell[3];
  float frac[3], rest[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    // min(max(v, 0), 1) as torch.clamp takes it: a NaN stays NaN.
    const float v = x[p * 3 + d];
    const float xd = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
    const float pos = __fmul_rn(xd, res_f);
    const int c = min(max(static_cast<int>(floorf(pos)), 0), res - 1);
    cell[d] = static_cast<unsigned>(c);
    frac[d] = __fsub_rn(pos, static_cast<float>(c));
    rest[d] = __fsub_rn(1.f, frac[d]);
  }
  float w[kCorners];
#pragma unroll
  for (int c = 0; c < kCorners; ++c) {
    const float f0 = (c & 4) ? frac[0] : rest[0];
    const float f1 = (c & 2) ? frac[1] : rest[1];
    const float f2 = (c & 1) ? frac[2] : rest[2];
    w[c] = __fmul_rn(__fmul_rn(f0, f1), f2);
  }
  const unsigned s = static_cast<unsigned>(plan.stride[l]);
  const unsigned base = s ? cell[0] * (s * s) + cell[1] * s + cell[2]
                          : (cell[0] * kPrime1 + cell[1] * kPrime2 + cell[2]) & mask;

  const float* level = table + static_cast<size_t>(l) * table_size * F;
  float v[kCorners][F];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) {
    const unsigned r = (base + static_cast<unsigned>(plan.pair_offsets[l][k])) & mask;
    load_pair<F>(level, r, mask, v[2 * k], v[2 * k + 1]);
  }
#pragma unroll
  for (int c = 0; c < kCorners; ++c)
#pragma unroll
    for (int f = 0; f < F; ++f) v[c][f] = __bfloat162float(__float2bfloat16_rn(v[c][f]));

  const long long pl = p * levels + l;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    float e[kCorners];
#pragma unroll
    for (int c = 0; c < kCorners; ++c) e[c] = __fmul_rn(w[c], v[c][f]);
    out[pl * F + f] = from_float<OutT>(sum8<F>(e));
  }
  if (keys) keys[l * points + p] = static_cast<int>(base + static_cast<unsigned>(l) * table_size);
  if (w_out) {
    float4* wo = reinterpret_cast<float4*>(w_out + pl * kCorners);
    wo[0] = make_float4(w[0], w[1], w[2], w[3]);
    wo[1] = make_float4(w[4], w[5], w[6], w[7]);
  }
  if (rows_out) {
    __nv_bfloat16* ro = rows_out + pl * (kCorners * F);
#pragma unroll
    for (int c = 0; c < kCorners; ++c)
#pragma unroll
      for (int f = 0; f < F; ++f) ro[c * F + f] = __float2bfloat16_rn(v[c][f]);
  }
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

// K4. x: [points, 3] float32; table: [levels, table_size, features] float32,
// 16-byte aligned; out: [points, levels * features], bfloat16 if out_bf16
// else float32, written; keys: [levels, points] int32, w: [points, levels, 8]
// float32 and rows: [points, levels, 8 * features] bfloat16, each written
// unless null. res, strides: host [levels] int32, each level's resolution
// and its dense stride res + 1 (0 on a hashed level); pair_offsets: host
// [levels * 4] int32, the row offsets of corners 0, 2, 4 and 6. table_size
// is a power of two, at least 2.
extern "C" int osplit_encode(const float* x, const float* table, void* out, int out_bf16,
                             int* keys, float* w, void* rows, long long levels, long long points,
                             long long table_size, int features, const int* res,
                             const int* strides, const int* pair_offsets, cudaStream_t stream) {
  if (!valid_shape(levels, points, features) || table_size < 2 ||
      table_size > 0x40000000LL || (table_size & (table_size - 1)) != 0 ||
      (keys != nullptr && levels * table_size > 0x7fffffffLL))
    return static_cast<int>(cudaErrorInvalidValue);
  EncodePlan plan = {};
  for (long long l = 0; l < levels; ++l) {
    if (res[l] < 1 || strides[l] < 0) return static_cast<int>(cudaErrorInvalidValue);
    plan.res[l] = res[l];
    plan.stride[l] = strides[l];
    for (int k = 0; k < kPairs; ++k) {
      const int off = pair_offsets[l * kPairs + k];
      if (off < 0) return static_cast<int>(cudaErrorInvalidValue);
      plan.pair_offsets[l][k] = off;
    }
  }
  if (points == 0) return static_cast<int>(cudaSuccess);
  const long long threads = (points + 31) / 32 * 32 * levels;
  const dim3 grid(static_cast<unsigned int>((threads + kThreads - 1) / kThreads));
  const unsigned t = static_cast<unsigned>(table_size);
  const int l = static_cast<int>(levels);
  auto* r = static_cast<__nv_bfloat16*>(rows);
  return static_cast<int>(with_features(features, [&](auto f) {
    constexpr int F = decltype(f)::value;
    if (out_bf16)
      osplit_encode_kernel<F, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(
          x, table, static_cast<__nv_bfloat16*>(out), keys, w, r, points, l, t, plan);
    else
      osplit_encode_kernel<F, float><<<grid, kThreads, 0, stream>>>(
          x, table, static_cast<float*>(out), keys, w, r, points, l, t, plan);
    return cudaGetLastError();
  }));
}
