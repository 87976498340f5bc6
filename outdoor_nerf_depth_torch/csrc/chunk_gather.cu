// Row gathers from a table chunk held in shared memory, for Hopper (sm_90a):
// the two Pallas kernels of the gather probe
// (`benchmarks/probes/gather_attack_probe.py`), which measure ways to get
// below the generic gather's cost for the hash grid's 16-lane rows.
//
//   P1  chunk_take_f32 (replaces `kernel` in `probe_pallas_vmem_take`):
//       out[q] = table[idx[q]], table f32 [chunk, 16] held on chip,
//       idx int32 in [0, chunk), out f32 [Q, 16].
//   P2  onehot_extract_bf16 (replaces `kernel` in
//       `probe_pallas_onehot_matmul`): for query q in tile t = q / tile,
//       out[q] = table[c * chunk + idx[q]] as f32 with c = t mod (rows /
//       chunk), computed as onehot(idx_tile)[tile, chunk] @ chunk_c[chunk, 16]
//       with bf16 inputs and f32 accumulation: row extraction with no
//       dynamic addressing, on the tensor cores.
//
// P1. The TPU kernel gives every grid step of 2048 queries its own copy of
// the 128 KiB table in VMEM. Blocks on the card are not sequential steps:
// one block per 2048 queries would read the table 4,096 times at the
// probe's size (537 MB, as much as the output). So the grid is persistent:
// one block per SM (128 KiB of dynamic shared memory leaves room for no
// second one) stages the table once, then strides over the queries. Four
// threads serve a query, each copying a 16-byte quarter of its row, so a
// warp writes 8 whole 64-byte rows. Bound: memory, 4 B of idx and 64 B of
// output per query (570 MB, 0.170 ms at 3.35 TB/s for 8.4M queries).
//
// P2. One block per tile: it stages its 512-row bf16 chunk (16 KiB) in
// shared memory, and each warp takes 16 queries at a time, 16 lanes wide,
// over all chunk / 16 k-steps of `mma.sync.m16n8k16` (two per k-step, one
// for each 8-lane half). The one-hot A fragment is built in registers from
// the two query indices a thread's rows hold; the B fragment is read from
// shared memory. Skipping the all-zero k-steps would make this a gather
// again, so every k-step runs. A product of a one-hot bf16 row with bf16
// values, summed in f32, is exact: the kernel equals table[...] in f32. A
// query index outside [0, chunk) gives a zero row (no k-step matches).
// Bound: memory, 4 B of idx and 64 B of output per query plus the chunks
// read (every distinct chunk once); 137 GFLOP of bf16 products at the
// probe's size is 0.14 ms at 989 TFLOP/s, below the byte time.
//
// Interface: plain C, loaded with ctypes. The kernels launch on the
// caller's stream and allocate nothing. Each entry point returns a
// cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 16;                 // floats (P1) or bf16 (P2) per row
constexpr int kTakeThreads = 1024;
constexpr int kTakeUnroll = 4;             // index loads in flight per thread
constexpr int kOneHotThreads = 256;        // 8 warps, 16 queries each at a time
constexpr int kMaxSmem = 232448;           // dynamic shared memory of one block
constexpr int kDefaultSmem = 48 * 1024;    // above this, opt in per kernel
constexpr uint32_t kBf16One = 0x3F80u;     // bf16 bits of 1.0

__global__ void __launch_bounds__(kTakeThreads)
chunk_take_kernel(const int* __restrict__ idx, const float4* __restrict__ table,
                  float4* __restrict__ out, long long n_queries, int chunk) {
  extern __shared__ float4 rows[];  // [chunk, 4] float4 = [chunk, 16] f32
  for (int i = threadIdx.x; i < chunk * 4; i += blockDim.x) rows[i] = table[i];
  __syncthreads();
  // Element i of the [Q, 4] float4 output: quarter i & 3 of query i >> 2.
  const long long n = n_queries * 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long base = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; base < n;
       base += stride * kTakeUnroll) {
    int r[kTakeUnroll];
#pragma unroll
    for (int u = 0; u < kTakeUnroll; ++u) {
      const long long i = base + u * stride;
      r[u] = i < n ? __ldg(idx + (i >> 2)) : 0;
    }
#pragma unroll
    for (int u = 0; u < kTakeUnroll; ++u) {
      const long long i = base + u * stride;
      if (i < n) out[i] = rows[r[u] * 4 + static_cast<int>(i & 3)];
    }
  }
}

// bf16 pair of a one-hot row whose 1 sits at column `hot`, at columns k
// (low half) and k + 1 (high half).
__device__ __forceinline__ uint32_t onehot_pair(int hot, int k) {
  return (hot == k ? kBf16One : 0u) | (hot == k + 1 ? kBf16One << 16 : 0u);
}

__global__ void __launch_bounds__(kOneHotThreads)
onehot_extract_kernel(const int* __restrict__ idx, const uint4* __restrict__ table,
                      float* __restrict__ out, long long n_queries, long long n_chunks,
                      int chunk, int tile) {
  extern __shared__ uint4 chunk_raw[];  // [chunk, 16] bf16, 2 uint4 per row
  const unsigned short* rows = reinterpret_cast<const unsigned short*>(chunk_raw);
  const long long t = blockIdx.x;
  const uint4* src = table + (t % n_chunks) * chunk * 2;
  for (int i = threadIdx.x; i < chunk * 2; i += blockDim.x) chunk_raw[i] = src[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int group = (threadIdx.x & 31) >> 2;  // fragment row (A, D) / column (B)
  const int tig = threadIdx.x & 3;            // thread in its group of four
  for (int g16 = warp; g16 < tile / 16; g16 += kOneHotThreads / 32) {
    const long long qa = t * tile + g16 * 16 + group;  // rows `group` and `group + 8`
    const long long qb = qa + 8;
    const int ia = qa < n_queries ? __ldg(idx + qa) : -1;
    const int ib = qb < n_queries ? __ldg(idx + qb) : -1;
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int k0 = 0; k0 < chunk; k0 += 16) {
      const int k = k0 + tig * 2;
      // A (16 x 16, row-major): {row group, cols k, k+1}, {row group+8, cols
      // k, k+1}, then the same rows at cols k+8, k+9.
      const uint32_t a0 = onehot_pair(ia, k), a1 = onehot_pair(ib, k);
      const uint32_t a2 = onehot_pair(ia, k + 8), a3 = onehot_pair(ib, k + 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // B (16 x 8, column-major): rows k, k+1 and k+8, k+9 of lane column
        // h * 8 + group.
        const int n = h * 8 + group;
        const uint32_t b0 = rows[k * kLanes + n] | (uint32_t(rows[(k + 1) * kLanes + n]) << 16);
        const uint32_t b1 =
            rows[(k + 8) * kLanes + n] | (uint32_t(rows[(k + 9) * kLanes + n]) << 16);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[h][0]), "+f"(d[h][1]), "+f"(d[h][2]), "+f"(d[h][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
    // D (16 x 8 f32): {row group, cols 2 tig, 2 tig + 1}, {row group + 8, same}.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = h * 8 + tig * 2;
      if (qa < n_queries)
        *reinterpret_cast<float2*>(out + qa * kLanes + col) = make_float2(d[h][0], d[h][1]);
      if (qb < n_queries)
        *reinterpret_cast<float2*>(out + qb * kLanes + col) = make_float2(d[h][2], d[h][3]);
    }
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory on the current device.
// Asked before every launch above the default: the setting is per device, and
// it is not a stream operation, so it is also allowed under stream capture.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

// P1: out [n_queries, 16] f32 = table [chunk, 16] f32 rows at idx; `max_blocks`
// is the number of SMs (one persistent block each). Indices must lie in
// [0, chunk): the kernel does not check them.
extern "C" int chunk_take_f32(const int* idx, const float* table, float* out, long long n_queries,
                              int chunk, int max_blocks, cudaStream_t stream) {
  const long long smem = static_cast<long long>(chunk) * kLanes * sizeof(float);
  if (chunk <= 0 || smem > kMaxSmem || n_queries < 0 || max_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_queries == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = allow_smem(chunk_take_kernel, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long needed = (n_queries * 4 + kTakeThreads - 1) / kTakeThreads;
  const int blocks = static_cast<int>(needed < max_blocks ? needed : max_blocks);
  chunk_take_kernel<<<blocks, kTakeThreads, smem, stream>>>(
      idx, reinterpret_cast<const float4*>(table), reinterpret_cast<float4*>(out), n_queries,
      chunk);
  return static_cast<int>(cudaGetLastError());
}

// P2: out [n_queries, 16] f32 from table [n_rows, 16] bf16 (raw bits), tile t
// of `tile` queries reading chunk t mod (n_rows / chunk) of `chunk` rows.
// chunk and tile are multiples of 16 and n_rows a multiple of chunk.
extern "C" int onehot_extract_bf16(const int* idx, const void* table, float* out,
                                   long long n_queries, long long n_rows, int chunk, int tile,
                                   cudaStream_t stream) {
  const long long smem = static_cast<long long>(chunk) * kLanes * 2;
  if (chunk <= 0 || chunk % 16 || tile <= 0 || tile % 16 || smem > kMaxSmem || n_queries < 0 ||
      n_rows < chunk || n_rows % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_queries == 0) return static_cast<int>(cudaSuccess);
  const long long n_tiles = (n_queries + tile - 1) / tile;
  if (n_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(onehot_extract_kernel, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  onehot_extract_kernel<<<static_cast<unsigned>(n_tiles), kOneHotThreads, smem, stream>>>(
      idx, static_cast<const uint4*>(table), out, n_queries, n_rows / chunk, chunk, tile);
  return static_cast<int>(cudaGetLastError());
}
