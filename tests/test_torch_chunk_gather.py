"""The port's row gathers P1 and P2 (their plain versions on the CPU) against
the gather probe's Pallas kernels run in interpret mode, on the same numpy
inputs, bit for bit.

The probe's kernels are closures inside its probe functions
(`benchmarks/probes/gather_attack_probe.py:111` and `:158`), so this file
carries a copy of each body with the probe's block specs, at small query
counts and at chunk and tile sizes whose tiles wrap around the chunks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from outdoor_nerf_depth_torch.ops import chunk_gather, cuda_build

LANES = chunk_gather.LANES


def _pallas_vmem_take(idx, table, tile):
    """`probe_pallas_vmem_take`'s kernel and specs, for len(idx) % tile == 0."""
    chunk = table.shape[0]

    def kernel(idx_ref, table_ref, out_ref):
        out_ref[:] = jnp.take(table_ref[:], idx_ref[:], axis=0)

    return pl.pallas_call(
        kernel,
        grid=(idx.shape[0] // tile,),
        in_specs=[
            pl.BlockSpec((tile,), lambda i: (i,), memory_space=pltpu.VMEM),
            pl.BlockSpec((chunk, LANES), lambda i: (0, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((tile, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((idx.shape[0], LANES), jnp.float32),
        interpret=True,
    )(idx, table)


def _pallas_onehot(idx, table, chunk, tile):
    """`probe_pallas_onehot_matmul`'s kernel and specs, for len(idx) % tile == 0."""
    n_chunks = table.shape[0] // chunk

    def kernel(idx_ref, chunk_ref, out_ref):
        onehot = (jax.lax.broadcasted_iota(jnp.int32, (tile, chunk), 1)
                  == idx_ref[:][:, None]).astype(jnp.bfloat16)
        out_ref[:] = jnp.dot(onehot, chunk_ref[:], preferred_element_type=jnp.float32)

    return pl.pallas_call(
        kernel,
        grid=(idx.shape[0] // tile,),
        in_specs=[
            pl.BlockSpec((tile,), lambda i: (i,), memory_space=pltpu.VMEM),
            pl.BlockSpec((chunk, LANES), lambda i: (i % n_chunks, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((tile, LANES), lambda i: (i, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((idx.shape[0], LANES), jnp.float32),
        interpret=True,
    )(idx, table)


def _inputs(queries, high, rows, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, high, queries).astype(np.int32)
    idx[0], idx[-1] = 0, high - 1
    return idx, rng.normal(size=(rows, LANES)).astype(np.float32)


@pytest.mark.parametrize("chunk,tile,queries", [(2048, 2048, 4096), (64, 32, 320)])
def test_take_matches_pallas_interpret(chunk, tile, queries):
    idx, table = _inputs(queries, chunk, chunk, chunk + queries)
    want = np.asarray(_pallas_vmem_take(jnp.asarray(idx), jnp.asarray(table), tile))
    got = chunk_gather.take_from_chunk(torch.from_numpy(idx), torch.from_numpy(table))
    assert got.dtype == torch.float32 and got.shape == (queries, LANES)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rows,chunk,tile,queries", [
    (2048, 512, 256, 2560),  # the probe's chunk and tile; 10 tiles over 4 chunks
    (256, 64, 32, 320),      # 10 tiles over 4 chunks
    (96, 32, 16, 48),        # 3 tiles over 3 chunks
])
def test_onehot_matches_pallas_interpret(rows, chunk, tile, queries):
    idx, table = _inputs(queries, chunk, rows, rows + queries)
    table_bf16 = jnp.asarray(table).astype(jnp.bfloat16)
    want = np.asarray(_pallas_onehot(jnp.asarray(idx), table_bf16, chunk, tile))
    table_t = torch.from_numpy(table).to(torch.bfloat16)
    # Both round f32 to nearest even: the same bf16 table bit for bit.
    np.testing.assert_array_equal(table_t.view(torch.int16).numpy(),
                                  np.asarray(table_bf16).view(np.int16))
    got = chunk_gather.onehot_extract(torch.from_numpy(idx), table_t, chunk, tile)
    assert got.dtype == torch.float32 and got.shape == (queries, LANES)
    # A one-hot product of bf16 values summed in f32 is exact.
    np.testing.assert_array_equal(got.numpy(), want)


def test_partial_last_tile_against_numpy():
    """Query counts the probe's grid cannot take (not a multiple of the tile)."""
    for queries in (1, 17, 2049):
        idx, table = _inputs(queries, 64, 256, queries)
        table_t = torch.from_numpy(table).to(torch.bfloat16)
        got = chunk_gather.onehot_extract(torch.from_numpy(idx), table_t, 64, 32)
        chunks = (np.arange(queries) // 32) % 4
        want = table_t.to(torch.float32).numpy()[chunks * 64 + idx]
        np.testing.assert_array_equal(got.numpy(), want)
        got = chunk_gather.take_from_chunk(torch.from_numpy(idx), torch.from_numpy(table[:64]))
        np.testing.assert_array_equal(got.numpy(), table[:64][idx])


def test_bad_inputs_raise():
    idx = torch.tensor([0, 3, 64], dtype=torch.int32)
    table = torch.zeros((64, LANES))
    with pytest.raises(ValueError, match=r"\[0, 64\)"):
        chunk_gather.take_from_chunk(idx, table)
    with pytest.raises(ValueError, match=r"\[0, 64\)"):
        chunk_gather.take_from_chunk(torch.tensor([-1], dtype=torch.int32), table)
    with pytest.raises(ValueError, match=r"\[0, 32\)"):
        chunk_gather.onehot_extract(torch.tensor([32], dtype=torch.int32),
                                    table.to(torch.bfloat16), 32, 16)
    with pytest.raises(ValueError, match="int32"):
        chunk_gather.take_from_chunk(idx.long(), table)
    with pytest.raises(ValueError, match="float32"):
        chunk_gather.take_from_chunk(idx[:2], table.to(torch.bfloat16))
    with pytest.raises(ValueError, match="multiples of 16"):
        chunk_gather.onehot_extract(idx[:2], table.to(torch.bfloat16), 24, 16)
    with pytest.raises(ValueError, match="multiple of chunk"):
        chunk_gather.onehot_extract(idx[:2], table[:48].to(torch.bfloat16), 32, 16)


def test_cpu_uses_the_plain_versions_and_counts_no_launch():
    cuda_build.reset_launches()
    idx = torch.tensor([1, 0, 5], dtype=torch.int32)
    chunk_gather.take_from_chunk(idx, torch.ones((8, LANES)))
    chunk_gather.onehot_extract(idx, torch.ones((32, LANES), dtype=torch.bfloat16), 16, 16)
    assert (cuda_build.launches()["P1"], cuda_build.launches()["P2"]) == (0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        chunk_gather.take_from_chunk_cuda(idx, torch.ones((8, LANES)))
    with pytest.raises(ValueError, match="CUDA"):
        chunk_gather.onehot_extract_cuda(idx, torch.ones((32, LANES), dtype=torch.bfloat16),
                                         16, 16)
    with pytest.raises(ValueError, match="no chunk gather"):
        chunk_gather.take_from_chunk(idx.to("meta"), torch.ones((8, LANES), device="meta"))
