"""Row gathers from a table chunk held on chip: CUDA kernels P1 and P2 and plain twins.

The gather probe (`probes/gather_attack.py`) measures these as ways to get
below the generic gather's cost for the hash grid's 16-lane rows. They
replace the two Pallas kernels of `benchmarks/probes/gather_attack_probe.py`:

- P1, `take_from_chunk(idx, table)`: out[q] = table[idx[q]] from an f32
  [chunk, 16] table held in shared memory (`kernel` of
  `probe_pallas_vmem_take`, which holds it in VMEM).
- P2, `onehot_extract(idx, table, chunk, tile)`: for query q in tile
  t = q // tile, out[q] = table[c * chunk + idx[q]] in f32 with
  c = t mod (rows // chunk), computed on the tensor cores as
  onehot(idx_tile) @ chunk_c with bf16 inputs and f32 accumulation
  (`kernel` of `probe_pallas_onehot_matmul`), exact, so equal to the plain
  gather bit for bit.

Both kernels live in `csrc/chunk_gather.cu`. Each function uses its plain
version only for tensors on the CPU; for CUDA tensors it launches the kernel
or raises (`cuda_build.use_kernel`). On the card, `idx` in [0, chunk) is the
caller's contract: P1 does not check it (an index outside reads outside the
table), P2 turns it into a zero row. The plain versions raise on it for CPU
tensors. `cuda_build.launches()` counts the launches of P1 and P2.
"""

from __future__ import annotations

import torch

from outdoor_nerf_depth_torch.ops import cuda_build
from outdoor_nerf_depth_torch.ops.cuda_build import I32, I64, PTR

SOURCE = "chunk_gather"
LANES = 16  # one oct-layout row: 8 corners x F = 2
TAKE_CHUNK = 2048  # P1: f32 rows held on chip (128 KiB)
ONEHOT_CHUNK, ONEHOT_TILE = 512, 256  # P2: rows per chunk, queries per tile
SMEM_BYTES = 232448  # dynamic shared memory one block can use on Hopper
P1 = cuda_build.Kernel("P1", SOURCE, "chunk_take_f32", PTR, PTR, PTR, I64, I32, I32)
P2 = cuda_build.Kernel("P2", SOURCE, "onehot_extract_bf16", PTR, PTR, PTR, I64, I64, I32, I32)


def _check(idx: torch.Tensor, table: torch.Tensor, dtype: torch.dtype):
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be 1-D int32, got {idx.dtype} {tuple(idx.shape)}")
    if table.dim() != 2 or table.shape[1] != LANES or table.dtype != dtype:
        raise ValueError(f"table must be {dtype} [rows, {LANES}], got {table.dtype} "
                         f"{tuple(table.shape)}")
    if idx.device != table.device:
        raise ValueError(f"idx on {idx.device}, table on {table.device}")


def _check_range(idx: torch.Tensor, chunk: int):
    """Raises on an index outside [0, chunk) of a CPU tensor. On the card the
    check would wait for the device (and break CUDA-graph capture), so there
    the range is the caller's contract, as for the kernels."""
    if idx.device.type == "cpu" and idx.numel() and (
            int(idx.min()) < 0 or int(idx.max()) >= chunk):
        raise ValueError(f"idx must lie in [0, {chunk})")


def _check_kernel_inputs(idx: torch.Tensor, table: torch.Tensor):
    """The kernels read the table in 16-byte vectors."""
    if not (idx.is_cuda and idx.is_contiguous() and table.is_contiguous()
            and table.data_ptr() % 16 == 0):
        raise ValueError(f"kernel takes contiguous CUDA tensors and a 16-byte-aligned table, "
                         f"got them on {idx.device}")


def take_from_chunk_plain(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    _check(idx, table, torch.float32)
    _check_range(idx, table.shape[0])
    return table[idx.long()]


def take_from_chunk_cuda(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """P1 on CUDA tensors; idx in [0, table rows) is the caller's contract."""
    _check(idx, table, torch.float32)
    _check_kernel_inputs(idx, table)
    chunk = table.shape[0]
    if chunk == 0 or chunk * LANES * 4 > SMEM_BYTES:
        raise ValueError(f"P1 holds 1 to {SMEM_BYTES // (LANES * 4)} table rows, got {chunk}")
    out = torch.empty((idx.shape[0], LANES), dtype=torch.float32, device=idx.device)
    sms = torch.cuda.get_device_properties(idx.device).multi_processor_count
    P1(idx.device, idx.data_ptr(), table.data_ptr(), out.data_ptr(), idx.shape[0], chunk, sms,
       key=lambda: (idx.shape[0], chunk))
    return out


def take_from_chunk(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """out[q] = table[idx[q]] for an f32 [chunk, 16] table and int32 idx in [0, chunk)."""
    if cuda_build.use_kernel(idx, "chunk gather"):
        return take_from_chunk_cuda(idx.contiguous(), table.contiguous())
    return take_from_chunk_plain(idx, table)


def _check_onehot(table: torch.Tensor, chunk: int, tile: int):
    if chunk <= 0 or chunk % 16 or tile <= 0 or tile % 16:
        raise ValueError(f"chunk and tile must be positive multiples of 16, got {chunk}, {tile}")
    if chunk * LANES * 2 > SMEM_BYTES:
        raise ValueError(f"a chunk of {chunk} rows does not fit in shared memory")
    if table.shape[0] < chunk or table.shape[0] % chunk:
        raise ValueError(f"table rows {table.shape[0]} must be a multiple of chunk {chunk}")


def onehot_rows(n_queries: int, n_rows: int, chunk: int, tile: int, device=None) -> torch.Tensor:
    """Table row of chunk c = (q // tile) mod (n_rows // chunk) where query q's
    index adds on: c * chunk, int64 [n_queries]."""
    tiles = torch.arange(n_queries, device=device) // tile
    return (tiles % (n_rows // chunk)) * chunk


def onehot_extract_plain(idx: torch.Tensor, table: torch.Tensor, chunk: int = ONEHOT_CHUNK,
                         tile: int = ONEHOT_TILE) -> torch.Tensor:
    _check(idx, table, torch.bfloat16)
    _check_onehot(table, chunk, tile)
    _check_range(idx, chunk)
    rows = onehot_rows(idx.shape[0], table.shape[0], chunk, tile, idx.device) + idx
    return table[rows].to(torch.float32)


def onehot_extract_cuda(idx: torch.Tensor, table: torch.Tensor, chunk: int = ONEHOT_CHUNK,
                        tile: int = ONEHOT_TILE) -> torch.Tensor:
    """P2 on CUDA tensors; idx in [0, chunk) is the caller's contract (an
    index outside gives a zero row)."""
    _check(idx, table, torch.bfloat16)
    _check_onehot(table, chunk, tile)
    _check_kernel_inputs(idx, table)
    out = torch.empty((idx.shape[0], LANES), dtype=torch.float32, device=idx.device)
    P2(idx.device, idx.data_ptr(), table.data_ptr(), out.data_ptr(), idx.shape[0],
       table.shape[0], chunk, tile, key=lambda: (idx.shape[0], table.shape[0], chunk, tile))
    return out


def onehot_extract(idx: torch.Tensor, table: torch.Tensor, chunk: int = ONEHOT_CHUNK,
                   tile: int = ONEHOT_TILE) -> torch.Tensor:
    """Rows of a bf16 [rows, 16] table as f32: query q of tile q // tile reads
    row (q // tile mod rows // chunk) * chunk + idx[q], idx int32 in [0, chunk)."""
    if cuda_build.use_kernel(idx, "one-hot extraction"):
        return onehot_extract_cuda(idx.contiguous(), table.contiguous(), chunk, tile)
    return onehot_extract_plain(idx, table, chunk, tile)
