"""The process group as a 1-D data mesh, and the collectives the port uses.

Port of the reference package's `parallel/mesh.py`. The reference puts every
device on one `data` mesh axis, shards each batch's ray axis over it,
replicates the parameters and lets XLA insert the gradient all-reduce. Here
the mesh is a `torch.distributed` process group, one rank per device:

- `init_from_env` joins the group torchrun describes (`RANK`, `WORLD_SIZE`,
  `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`): NCCL on `cuda:LOCAL_RANK`,
  gloo when the caller asks for the CPU or names the backend. A failed init
  raises; nothing falls back to another backend or device.
- `make_mesh` describes the world (rank and size; rank 0 of 1 without a
  group). `shard_batch` takes a rank's rows of a global batch (rank r holds
  rows [r n / W, (r + 1) n / W), as the reference assembles a global batch
  from its processes' shards in process order), and `put_replicated`
  broadcasts a module's parameters and buffers from rank 0. (The
  reference's `shard_batch_stack` has no counterpart: each rank's dataset
  already samples its own rows of each of the K steps' batches.)
- `all_reduce_sum_` sums a list of tensors over the ranks in place, as one
  flat all-reduce per dtype; `all_gather_rows` concatenates each rank's rows
  in rank order. Gloo takes CUDA tensors in `all_reduce` and `broadcast`
  only, so outside NCCL the gather is an all-reduce of zero-padded blocks
  (exact: each element is summed with zeros).
- `row_shard` marks the forward of one rank's share of a batch that `count`
  ranks hold together: `rand` and `randn` then draw the whole batch's values
  and return this rank's rows, so the draws of a W-rank step equal those of
  one process fed the concatenated batch; `kept_of_global_cut` gives the
  NGP batch plan (`ops/occupancy.py:batch_compaction_plan`) this rank's
  part of a cut over the whole batch. The
  context is a contextvar, which autograd's device threads do not see:
  code that autograd runs again in such a thread (a checkpoint's
  recompute) re-enters the forward's shard with `in_row_shard`.

Imports torch only.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
from typing import List, Optional

import torch
from torch import distributed as dist

ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data mesh: this process's rank among `size` ranks."""

    rank: int = 0
    size: int = 1

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of `n` rows."""
        if n % self.size:
            raise ValueError(f"a global batch of {n} rows does not divide over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


@dataclasses.dataclass(frozen=True)
class RowShard:
    """One rank's share of a batch that ranks [first, first + count) hold
    together, this rank's rows being the `index`-th block."""

    index: int
    count: int
    first: int


_ROW_SHARD: contextvars.ContextVar[Optional[RowShard]] = contextvars.ContextVar(
    "row_shard", default=None)


def active() -> bool:
    """Whether this process belongs to a process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def make_mesh() -> Mesh:
    return Mesh(rank(), world())


def in_torchrun_env(environ=None) -> bool:
    """Whether the environment describes a process group, as torchrun's does."""
    environ = os.environ if environ is None else environ
    return all(k in environ for k in ENV_KEYS)


def init_from_env(device=None, backend: Optional[str] = None,
                  timeout_s: float = 600.0) -> torch.device:
    """Join the process group torchrun's environment describes; returns this
    rank's device.

    `device` None means `cuda:LOCAL_RANK` (raising without CUDA), a CPU
    device takes gloo; `backend` overrides the choice (gloo with CUDA
    tensors on one card, say). Errors of the init propagate.
    """
    missing = [k for k in ENV_KEYS if k not in os.environ]
    if missing:
        raise RuntimeError(f"no process group in the environment: {missing} unset")
    rank_, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        device = torch.device("cuda", local)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
        rank=rank_, world_size=size, timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return device


def shutdown():
    """Leave the process group, if any."""
    if active():
        dist.destroy_process_group()


def barrier():
    if active():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def _map_rows(fn, obj):
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _map_rows(fn, getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _map_rows(fn, v) for k, v in obj.items()}
    return None if obj is None else fn(obj)


def shard_batch(batch, mesh: Optional[Mesh] = None):
    """This rank's rows of every leaf of a global batch (a ray dataclass, a
    dict or a tensor); ValueError when the rows do not divide over the ranks."""
    mesh = mesh or make_mesh()
    return _map_rows(lambda x: x[mesh.rows(x.shape[0])], batch)


@torch.no_grad()
def broadcast_(tensors, src: int = 0):
    """Overwrite each tensor with rank `src`'s, in place."""
    if active():
        for t in tensors:
            dist.broadcast(t, src)


def put_replicated(module: torch.nn.Module):
    """Rank 0's parameters and buffers on every rank (in place); returns the module."""
    broadcast_(list(module.parameters()) + list(module.buffers()))
    return module


@torch.no_grad()
def all_reduce_sum_(tensors: List[torch.Tensor]):
    """Sum each tensor over the ranks in place: one flat all-reduce per dtype."""
    if not active():
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


@torch.no_grad()
def all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` (equal shapes) concatenated along dim 0 in rank order."""
    if not active():
        return t
    size, r, n = world(), rank(), t.shape[0]
    if dist.get_backend() == "nccl":
        out = t.new_empty((size * n,) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous())
        return out
    src = t.to(torch.int32) if t.dtype == torch.bool else t
    out = src.new_zeros((size * n,) + tuple(t.shape[1:]))
    out[r * n:(r + 1) * n] = src
    dist.all_reduce(out)
    return out.to(torch.bool) if t.dtype == torch.bool else out


@contextlib.contextmanager
def row_shard(index: int, count: int):
    """Within the block, draws and the NGP batch plan treat this rank's
    tensors as the `index`-th of `count` equal blocks of rows held by ranks
    [rank - index, rank - index + count)."""
    if not 0 <= index < count:
        raise ValueError(f"row block {index} of {count}")
    with in_row_shard(RowShard(index, count, rank() - index)):
        yield


@contextlib.contextmanager
def in_row_shard(shard: Optional[RowShard]):
    """Within the block, the row shard is `shard` (one that
    `current_row_shard` returned, or None for none)."""
    token = _ROW_SHARD.set(shard)
    try:
        yield
    finally:
        _ROW_SHARD.reset(token)


def current_row_shard() -> Optional[RowShard]:
    return _ROW_SHARD.get()


def _draw_rows(fn, shape, generator, **kwargs):
    shard = _ROW_SHARD.get()
    if generator is None or shard is None or shard.count == 1 or not len(shape):
        return fn(shape, generator=generator, **kwargs)
    n = shape[0]
    full = fn((n * shard.count,) + tuple(shape[1:]), generator=generator, **kwargs)
    return full[shard.index * n:(shard.index + 1) * n]


def rand(shape, generator: Optional[torch.Generator] = None, **kwargs) -> torch.Tensor:
    """`torch.rand` over rows (dim 0): under `row_shard`, this rank's rows
    of the draw for the whole batch."""
    return _draw_rows(torch.rand, shape, generator, **kwargs)


def randn(shape, generator: Optional[torch.Generator] = None, **kwargs) -> torch.Tensor:
    """`torch.randn` over rows, as `rand`."""
    return _draw_rows(torch.randn, shape, generator, **kwargs)


def kept_of_global_cut(budget: int, counts_fn) -> int:
    """How many of its sorted items this rank keeps when the items of the
    ranks in the current row shard are sorted together by key (ties in rank
    order) and the first `budget` x (ranks in the shard) are kept.

    `counts_fn()` gives this rank's count of items of each key, keys in
    ascending order; `budget` is this rank's share of the cut. A rank's
    items of key q follow the peers' items of every smaller key and the
    lower peers' items of key q. Without a shard of several ranks the rank
    holds the whole batch and keeps `budget` (`counts_fn` is not called).
    """
    shard = _ROW_SHARD.get()
    if shard is None or shard.count == 1:
        return budget
    counts = counts_fn()
    peers = all_gather_rows(counts[None])[shard.first:shard.first + shard.count]
    per_key = peers.sum(dim=0)
    offset = torch.cumsum(per_key, 0) - per_key + peers[:shard.index].sum(dim=0)
    take = torch.minimum(torch.clamp(budget * shard.count - offset, min=0), counts)
    return int(take.sum())
