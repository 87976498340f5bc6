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
// P2. One warpgroup (128 threads) per block, as many blocks as fit on the
// card (persistent grid). A work item is a chunk c and a run of the tiles
// that read it (c, c + rows / chunk, ...): all of them, so that each
// distinct chunk is read from memory once, unless that leaves too few items
// to fill the card (tables of a few chunks). A block stages its item's chunk
// in one shared-memory buffer with cp.async, 16 bytes a thread, and the
// blocks of an SM (7 at 512 rows) overlap one another's staging: a second
// buffer per block, to stage the next chunk while this one computes, was
// measured as no faster at 256 and 512 rows and slower at 64. It loads each
// slab's query indices into registers while the slab before computes. The
// queries go in slabs of 64 rows through `wgmma.mma_async.m64n16k16` bf16 ->
// f32, one per k-step of 16 chunk rows; every k-step runs (skipping the
// all-zero ones would make this a gather again). Rows of a slab past the
// tile's end or past the last query get index -1: zero rows, not stored.
//
//   A, the one-hot [64 queries, 16 k] slice, comes from registers: warp w
//   holds rows 16w .. 16w + 15 in mma.m16n8k16's A layout. A row's one-hot
//   is non-zero in exactly one k-step, kh = idx >> 4, so a thread computes
//   once per query the two bf16 pairs it holds there, and each k-step's A
//   is `ks == kh ? pair : 0`. The fragments of 8 k-steps are built before
//   `wgmma.fence`, so no other instruction writes A between the products.
//   B, the chunk's [16 k, 16 lanes] slice, is read by `wgmma` straight from
//   shared memory through a matrix descriptor. The chunk's rows are 32
//   bytes with the 16 lanes contiguous: B is N-major, so the transpose bit
//   is set, in the 32-byte swizzle's canonical layout. Its atom is 8 rows of
//   32 bytes, the rows of the table as they are, except that each 16-byte
//   half is stored at its address with bit 4 XORed with bit 7, the
//   hardware's swizzle, which acts on absolute shared addresses: the
//   staging applies it to the address it writes. A k-step is two atoms,
//   256 bytes apart: the stride-dimension offset. N = 16 needs no second
//   atom along N, so the leading-dimension offset is not used (set to the
//   same 256).
//
// A product of a one-hot bf16 row with bf16 values, summed in f32, is exact:
// each output is 1.0 x the value plus zeros, so the kernel equals
// table[...] in f32 bit for bit. A query index outside [0, chunk) matches
// no k-step and gives a zero row. Bound: memory, 4 B of idx and 64 B of
// output per query plus each distinct chunk once, 0.230 ms at the probe's
// size (8.4M queries over 12,288 chunks of 512 rows); its 137 GFLOP of bf16
// products take 0.139 ms at 989 TFLOP/s. What bounds it on the card is the
// tensor-core phase, not the bytes: with the bytes fixed, its time grows
// with the k-steps per query (chip_smoke.py times it at chunks of 256 and
// 1024 rows too): a 64x16x16 product runs well under the bf16 peak, and the
// selects that build A each k-step add to it. The design before this one
// (one block per tile, `mma.sync.m16n8k16` with the one-hot rebuilt by
// eight compare-selects and B assembled from eight 16-bit shared-memory
// loads per k-step, staging not overlapped) took 1.1755 ms at the probe's
// size on one NVIDIA H100 80GB HBM3 at a 700 W power limit (chip_smoke.py).
// PERF.md keeps the times of this one.
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
constexpr int kOneHotThreads = 128;        // one warpgroup
constexpr int kSlab = 64;                  // queries of one wgmma (M)
constexpr int kKStep = 16;                 // chunk rows of one wgmma (K)
constexpr int kRowBytes = kLanes * 2;      // one bf16 table row
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared address of 16-byte piece i (row i / 2, lanes 8 (i % 2) .. + 7) of a
// chunk staged at `base` in wgmma's 32-byte swizzle: rows of 32 bytes as in
// the table, each 16-byte half stored at its address with bit 4 XORed with
// bit 7, as the hardware reads it (rows 4-7 of every 8 swap halves).
__device__ __forceinline__ uint32_t staged_piece(uint32_t base, int i) {
  const uint32_t a = base + 16u * i;
  return a ^ ((a >> 3) & 0x10u);
}

// wgmma matrix descriptor of B for k-step 0 of a chunk staged at `base`:
// start address, leading- and stride-dimension byte offsets (all >> 4), and
// the layout type in bits 62-63 (3: 32-byte swizzle). B is N-major, 32 bytes
// wide: the stride-dimension offset steps to the next 8 rows along K; with
// N = 16 there is no next block along N, so the leading one is not used.
__device__ __forceinline__ uint64_t chunk_desc(uint32_t base) {
  constexpr uint64_t kAtom = 8 * kRowBytes;  // 8 rows of 32 bytes
  return static_cast<uint64_t>((base & 0x3FFFF) >> 4) | ((kAtom >> 4) << 16) |
         ((kAtom >> 4) << 32) | (3ull << 62);
}

// Descriptor increment of one k-step (16 rows), in its 16-byte units.
constexpr uint64_t kDescKStep = kKStep * kRowBytes >> 4;

// Stages `chunk` rows of bf16 from `src` at `base`, 16 bytes per cp.async.
__device__ __forceinline__ void stage_chunk(uint32_t base, const uint4* __restrict__ src,
                                            int chunk) {
  for (int i = threadIdx.x; i < chunk * 2; i += kOneHotThreads)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(staged_piece(base, i)),
                 "l"(src + i)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Keeps a register's value where it is, so that the compiler moves no write
// of it between `wgmma.fence` and the products that read it.
__device__ __forceinline__ void fence_operand(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void fence_operand(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// d[64 x 16] += a[64 x 16] (registers) @ B[16 x 16] (shared, N-major):
// scale-d on, A and B not negated, B transposed.
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// Query of row r of a slab whose first row is query q0 (row r0 of its tile),
// if the row lies inside the tile and the queries; else -1.
__device__ __forceinline__ long long slab_query(long long q0, int r0, int r, int tile,
                                                long long n_queries) {
  return r0 + r < tile && q0 + r < n_queries ? q0 + r : -1;
}

// Fragments of kBatch k-steps are built before one wgmma group. Past the
// chunk's last k-step (chunk / 16 not a multiple of kBatch) a product reads
// that last k-step again with A all zero: it adds nothing.
constexpr int kBatch = 8;

// Work item w (of n_items) is chunk w mod n_used and a run of up to per_item
// of the tiles that read it.
__global__ void __launch_bounds__(kOneHotThreads)
onehot_extract_kernel(const int* __restrict__ idx, const uint4* __restrict__ table,
                      float* __restrict__ out, long long n_queries, long long n_chunks,
                      long long n_used, long long n_items, long long per_item, int chunk,
                      int tile) {
  extern __shared__ uint4 smem_raw[];
  const uint32_t buf = smem_addr(smem_raw);
  const uint64_t desc0 = chunk_desc(buf);
  const long long n_tiles = (n_queries + tile - 1) / tile;
  const int n_ksteps = chunk / kKStep;
  const int slabs = (tile + kSlab - 1) / kSlab;

  const int warp = threadIdx.x >> 5;
  const int group = (threadIdx.x & 31) >> 2;  // fragment row (A, D)
  const int tig = threadIdx.x & 3;            // thread in its group of four
  const int row_a = warp * 16 + group;        // this thread's slab rows: row_a, row_a + 8

  auto chunk_rows = [&](long long w) { return table + (w % n_used) * chunk * 2; };
  long long item = blockIdx.x;
  if (item < n_items) stage_chunk(buf, chunk_rows(item), chunk);
  cp_async_commit();
  for (; item < n_items; item += gridDim.x) {
    cp_async_wait<0>();
    // cp.async writes through the generic proxy, wgmma reads through the async one.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // Slabs of this item's tiles: tile c + j * n_chunks reads chunk c, for
    // j in [j0, j0 + per_item) as far as such tiles exist. (t, r0): the tile
    // and first tile row of the slab whose indices load next.
    const long long c = item % n_used, j0 = item / n_used * per_item;
    const long long j_end = (n_tiles - 1 - c) / n_chunks + 1;
    const long long n_slabs = (j_end - j0 < per_item ? j_end - j0 : per_item) * slabs;
    long long t = c + j0 * n_chunks;
    int r0 = 0;
    long long qa, qb;
    int next_a, next_b;
    auto load_next = [&]() {  // the indices of slab (t, r0), then step to the next slab
      const long long q0 = t * tile + r0;
      qa = slab_query(q0, r0, row_a, tile, n_queries);
      qb = slab_query(q0, r0, row_a + 8, tile, n_queries);
      next_a = qa >= 0 ? __ldg(idx + qa) : -1;
      next_b = qb >= 0 ? __ldg(idx + qb) : -1;
      r0 += kSlab;
      if (r0 >= tile) r0 = 0, t += n_chunks;
    };
    load_next();
    for (long long u = 0; u < n_slabs; ++u) {
      const int ia = next_a, ib = next_b;
      const long long out_a = qa, out_b = qb;
      if (u + 1 < n_slabs) load_next();  // the next slab's indices load while this one computes
      // The hot k-step of each row (none outside [0, chunk)) and the bf16
      // pairs the row holds there: cols 2 tig, +1 and 2 tig + 8, +9.
      const int kh_a = ia >= 0 && ia < chunk ? ia >> 4 : -1;
      const int kh_b = ib >= 0 && ib < chunk ? ib >> 4 : -1;
      const uint32_t pa_lo = onehot_pair(ia & 15, 2 * tig);
      const uint32_t pa_hi = onehot_pair(ia & 15, 2 * tig + 8);
      const uint32_t pb_lo = onehot_pair(ib & 15, 2 * tig);
      const uint32_t pb_hi = onehot_pair(ib & 15, 2 * tig + 8);

      float d[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int k0 = 0; k0 < n_ksteps; k0 += kBatch) {
        uint32_t a[kBatch][4];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          // A (16 x 16 per warp, row-major): {row g, cols k, k+1}, {row g+8,
          // cols k, k+1}, then the same rows at cols k+8, k+9.
          const bool hot_a = k0 + j == kh_a, hot_b = k0 + j == kh_b;
          a[j][0] = hot_a ? pa_lo : 0u;
          a[j][1] = hot_b ? pb_lo : 0u;
          a[j][2] = hot_a ? pa_hi : 0u;
          a[j][3] = hot_b ? pb_hi : 0u;
#pragma unroll
          for (int r = 0; r < 4; ++r) fence_operand(a[j][r]);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) fence_operand(d[r]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int ks = k0 + j < n_ksteps ? k0 + j : n_ksteps - 1;
          wgmma_m64n16k16(d, a[j], desc0 + ks * kDescKStep);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
        for (int r = 0; r < 8; ++r) fence_operand(d[r]);
      }
      // D (16 x 16 f32 per warp): {row g, cols 8h + 2 tig, +1}, {row g + 8, same}.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = h * 8 + tig * 2;
        if (out_a >= 0)
          *reinterpret_cast<float2*>(out + out_a * kLanes + col) =
              make_float2(d[4 * h], d[4 * h + 1]);
        if (out_b >= 0)
          *reinterpret_cast<float2*>(out + out_b * kLanes + col) =
              make_float2(d[4 * h + 2], d[4 * h + 3]);
      }
    }
    __syncthreads();  // every warp is done with the chunk before the next one stages
    const long long next = item + gridDim.x;
    if (next < n_items) stage_chunk(buf, chunk_rows(next), chunk);
    cp_async_commit();
  }
  cp_async_wait<0>();
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
  const long long chunk_bytes = static_cast<long long>(chunk) * kRowBytes;
  if (chunk <= 0 || chunk % kKStep || tile <= 0 || tile % 16 || chunk_bytes > kMaxSmem ||
      n_queries < 0 || n_rows < chunk || n_rows % chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_queries == 0) return static_cast<int>(cudaSuccess);
  const long long n_tiles = (n_queries + tile - 1) / tile;
  const long long n_chunks = n_rows / chunk;
  const long long n_used = n_tiles < n_chunks ? n_tiles : n_chunks;  // chunks some tile reads
  const long long passes = (n_tiles + n_chunks - 1) / n_chunks;      // most tiles of one chunk
  const int smem = static_cast<int>(chunk_bytes);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = allow_smem(onehot_extract_kernel, smem)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, onehot_extract_kernel,
                                                           kOneHotThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  // A persistent grid: as many blocks as fit on the card at once, or one per item.
  const long long resident = static_cast<long long>(sms) * per_sm;
  // A work item is one chunk and up to per_item of its tiles: all of them
  // (each chunk staged once) unless that leaves fewer than two items per
  // resident block, as it does for tables of a few chunks.
  const long long splits_wanted = (2 * resident + n_used - 1) / n_used;
  const long long splits = splits_wanted < passes ? splits_wanted : passes;
  const long long per_item = (passes + splits - 1) / splits;
  const long long n_items = n_used * ((passes + per_item - 1) / per_item);
  const int blocks = static_cast<int>(n_items < resident ? n_items : resident);
  onehot_extract_kernel<<<blocks, kOneHotThreads, smem, stream>>>(
      idx, static_cast<const uint4*>(table), out, n_queries, n_chunks, n_used, n_items, per_item,
      chunk, tile);
  return static_cast<int>(cudaGetLastError());
}
