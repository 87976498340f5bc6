"""The osplit table gradient in one pass over all levels (one sort, K3a, one
K2b scan, K3b; `ops/hashgrid_grad.py`) against the per-level pipeline it
replaced (`_oct_split_table_grad_per_level`: `_oct_split_row_sums` and
`_fold` a level), on the CPU, where the kernels' plain versions run.

Levels as tests/test_torch_ngp_layouts.py has them: at T = 2^10, res 4 is
dense, res 9 dense at the boundary ((9 + 1)^3 = 1000 <= 1024, its fold
wraps past the trimmed rows) and res 31 hashed. Each case is one set of
points: some outside the unit cube, every point in one cell, a few points
over many empty rows, points whose rows are distinct at every level, and a
single level. Tolerance: 1e-6 of the largest entry (the two pipelines scan
the same bf16 products, but an unstable sort may order a row's equal keys
differently, and a row's sum is a difference of f32 prefix sums); exact
where no two points share a row, since the sorted order is then unique.

Also the binding that every kernel of the port shares (`ops/cuda_build.py`):
each declaration against its export in `csrc/`, and the launch record."""

import contextlib
import json
import re
import threading
import types

import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.ops import (chunk_gather, cuda_build, hashgrid, hashgrid_grad,
                                         prefix_scan, volren_weights)
from outdoor_nerf_depth_torch.utils import tracing

torch.set_num_threads(1)

T, F = 2**10, 2
RES = (4, 9, 31)
RTOL_OF_MAX = 1e-6


def _distinct_rows(x, res):
    """The points of x whose rows differ from every earlier kept point's at every level."""
    idx_levels, _ = hashgrid._oct_local_indices_weights(torch.from_numpy(x), res, T)
    seen = [set() for _ in res]
    keep = []
    for p in range(len(x)):
        rows = [int(i[p]) for i in idx_levels]
        if all(r not in s for r, s in zip(rows, seen)):
            keep.append(p)
            for r, s in zip(rows, seen):
                s.add(r)
    return x[keep]


def _points(case):
    rng = np.random.default_rng(12)
    if case == "outside_the_cube":
        return RES, rng.uniform(-0.05, 1.05, (301, 3)).astype(np.float32)
    if case == "one_cell":
        return RES, np.tile(np.float32([[0.43, 0.61, 0.27]]), (203, 1))
    if case == "few_points":
        return RES, rng.uniform(0.0, 1.0, (13, 3)).astype(np.float32)
    if case == "distinct_rows":
        return RES, _distinct_rows(rng.uniform(0.0, 1.0, (400, 3)).astype(np.float32), RES)[:61]
    if case == "one_level":
        return (9,), rng.uniform(-0.05, 1.05, (157, 3)).astype(np.float32)
    raise ValueError(case)


CASES = ["outside_the_cube", "one_cell", "few_points", "distinct_rows", "one_level"]


def _inputs(case):
    res, x = _points(case)
    rng = np.random.default_rng(3)
    g = rng.normal(size=(len(x), len(res) * F)).astype(np.float32)
    idx_levels, w_all = hashgrid._oct_local_indices_weights(torch.from_numpy(x), res, T)
    return res, x, idx_levels, w_all, torch.from_numpy(g).reshape(len(x), len(res), F)


@pytest.mark.parametrize("case", CASES)
def test_one_pass_matches_the_per_level_pipeline(case):
    res, x, idx_levels, w_all, g_lf = _inputs(case)
    if case == "distinct_rows":
        assert len(x) > 8 * len(res) and len(x) % 8
        for i in idx_levels:
            assert len(set(i.tolist())) == len(x)
    if case == "one_cell":
        assert all(len(set(i.tolist())) == 1 for i in idx_levels)
    cuda_build.reset_launches()
    got = hashgrid._oct_split_table_grad(hashgrid._level_keys(idx_levels, T), w_all, g_lf,
                                         res, T)
    want = hashgrid._oct_split_table_grad_per_level(idx_levels, w_all, g_lf, res, T)
    assert got.shape == (len(res), T, F) and got.dtype == torch.float32
    scale = float(want.abs().max())
    assert scale > 0.1
    if case == "distinct_rows":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=RTOL_OF_MAX * scale)
    # Table rows no corner of any point reads stay exactly 0.
    assert int((want == 0).all(-1).sum()) > 0
    assert torch.equal(got[(want == 0).all(-1)], torch.zeros_like(got[(want == 0).all(-1)]))
    # The CPU takes the plain versions: no kernel launch is counted.
    assert set(cuda_build.launches().values()) == {0}


@pytest.mark.parametrize("case", CASES)
def test_backward_matches_float64_sums_of_the_bf16_products(case):
    """Through OctSplitEncode's backward: each canonical row collects, in
    float64, the bf16-rounded w g of every (point, corner) that reads it."""
    res, x, idx_levels, w_all, g_lf = _inputs(case)
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(0.0, 0.1, (len(res), T, F)).astype(np.float32))
    table.requires_grad_(True)
    out = hashgrid.OctSplitEncode.apply(torch.from_numpy(x), table, res, T)
    (out * g_lf.reshape(len(x), -1)).sum().backward()
    prod = (w_all[..., None] * g_lf[:, :, None, :]).to(torch.bfloat16).double()  # [P, L, 8, F]
    want = np.zeros((len(res), T, F))
    for level, r in enumerate(res):
        offs = hashgrid._oct_offsets(r, T)
        base = idx_levels[level].numpy()
        for c, o in enumerate(offs):
            np.add.at(want[level], (base + o) % T, prod[:, level, c].numpy())
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(table.grad.numpy(), want, rtol=0, atol=RTOL_OF_MAX * scale)


def test_products_in_sorted_order():
    """K3a's plain version: row i of level l holds the bf16-rounded products
    of the point the sort put there, lanes in (corner, feature) order."""
    res, x, idx_levels, w_all, g_lf = _inputs("outside_the_cube")
    n_points, n_levels = len(x), len(res)
    _, order = hashgrid._sorted_level_keys(hashgrid._level_keys(idx_levels, T))
    got = hashgrid_grad.sorted_products(order, w_all, g_lf)
    assert got.shape == (n_levels, n_points, 8 * F)
    for level in range(n_levels):
        p = order[level * n_points:(level + 1) * n_points] - level * n_points
        assert torch.equal(torch.sort(p).values, torch.arange(n_points))
        want = (w_all[p, level, :, None] * g_lf[p, level, None, :]).reshape(n_points, -1)
        assert torch.equal(got[level], want.to(torch.bfloat16).float())


def test_backward_counts_its_levels_under_the_profiler():
    """`hashgrid.grad_levels`: the levels one backward folds, while a
    profiler records (the port's spans and counters)."""
    res, x, *_ = _inputs("outside_the_cube")
    table = torch.zeros((len(res), T, F), requires_grad=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            hashgrid.OctSplitEncode.apply(torch.from_numpy(x), table, res, T).sum().backward()
        counters = tracing.snapshot()["counters"]
    assert counters["hashgrid.grad_levels"] == 2 * len(res)


def test_level_keys_and_segment_ends():
    """Level l's entries fill positions l P to (l + 1) P of the one sort;
    the ends count the entries at or below each level-offset row; keys that
    would overflow int32 are refused."""
    res, x, idx_levels, *_ = _inputs("outside_the_cube")
    n_points, n_levels = len(x), len(res)
    sorted_keys, order = hashgrid._sorted_level_keys(hashgrid._level_keys(idx_levels, T))
    assert sorted_keys.dtype == torch.int32 and order.shape == (n_levels * n_points,)
    blocks = sorted_keys.reshape(n_levels, n_points).long()
    for level, i in enumerate(idx_levels):
        assert torch.equal(blocks[level] - level * T, torch.sort(i.reshape(-1)).values)
    ends = hashgrid._level_segment_ends(sorted_keys, n_levels, T)
    assert ends.dtype == torch.int32 and ends.shape == (n_levels * T,)
    for level, i in enumerate(idx_levels):
        counts = torch.bincount(i.reshape(-1), minlength=T)
        want = level * n_points + torch.cumsum(counts, 0)
        assert torch.equal(ends[level * T:(level + 1) * T].long(), want)
    with pytest.raises(ValueError, match="int32"):
        hashgrid._level_keys(idx_levels, 2**30)


# The four wrappers above declare every kernel of the port.
KERNELS = cuda_build.kernels()
C_TYPES = {cuda_build.PTR: "pointer", cuda_build.I32: "int", cuda_build.I64: "long long"}


def test_the_wrappers_declare_every_kernel():
    assert {volren_weights.K1A, volren_weights.K1B, prefix_scan.K2A, prefix_scan.K2B,
            hashgrid_grad.K3A, hashgrid_grad.K3B, hashgrid_grad.K4, chunk_gather.P1,
            chunk_gather.P2} == set(KERNELS.values())


@pytest.mark.parametrize("kid", sorted(KERNELS))
def test_declaration_matches_its_export(kid):
    """The symbol is exported once as `extern "C" int`, its parameters are
    the declared pointers, ints and long longs, and the last is the stream."""
    kernel = KERNELS[kid]
    source = (cuda_build.CSRC_DIR / f"{kernel.source}.cu").read_text()
    exports = re.findall(rf'extern "C" int {kernel.symbol}\(([^)]*)\)', source)
    assert len(exports) == 1, exports
    params = [" ".join(p.split()) for p in exports[0].split(",")]
    assert len(params) == len(kernel.argtypes) + 1
    assert params[-1].startswith("cudaStream_t ")
    kinds = ["pointer" if "*" in p else p.rsplit(" ", 1)[0].removeprefix("const ")
             for p in params[:-1]]
    assert kinds == [C_TYPES[t] for t in kernel.argtypes]


def test_launch_record(monkeypatch):
    """Counts by id from any thread, and their reset; a key built only
    inside a recording, and kept by every recording open; the keys' JSON
    round trip; a failed launch raised and not counted; and the device
    policy, which refuses a device that is neither the CPU nor CUDA. The
    symbol and the stream are stand-ins: the CPU has no kernel to launch."""
    kernel, codes, built = KERNELS["K4"], [], []
    monkeypatch.setattr(kernel, "_fn", lambda *args: codes.append(args[-1]) or args[0])
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=7))
    dev = torch.device("cpu")

    def launch(key, code=0):
        kernel(dev, code, key=lambda: built.append(key) or key)

    cuda_build.reset_launches()
    launch((1,))
    assert built == [] and codes == [7]
    with cuda_build.recording() as outer:
        launch((2, (16, 32), "float32", True))
        with cuda_build.recording() as inner:
            thread = threading.Thread(target=launch, args=((3, ((0, 1), (2, 3)), (5,)),))
            thread.start()
            thread.join(timeout=60)
            assert not thread.is_alive()
    launch((4,))
    assert built == [(2, (16, 32), "float32", True), (3, ((0, 1), (2, 3)), (5,))]
    assert inner == {"K4": {(3, ((0, 1), (2, 3)), (5,))}}
    assert outer == {"K4": {(2, (16, 32), "float32", True), (3, ((0, 1), (2, 3)), (5,))}}
    merged = {"K4": {(9,)}}
    cuda_build.merge_keys(merged, json.loads(json.dumps(cuda_build.keys_json(outer))))
    assert merged == {"K4": outer["K4"] | {(9,)}}
    with pytest.raises(RuntimeError, match="osplit_encode launch failed: cudaError 2"):
        launch((5,), code=2)
    assert cuda_build.launches() == dict.fromkeys(KERNELS, 0) | {"K4": 4}
    cuda_build.reset_launches()
    assert cuda_build.launches() == dict.fromkeys(KERNELS, 0)
    assert cuda_build.use_kernel(torch.ones(2), "osplit encode") is False
    with pytest.raises(ValueError, match="no osplit encode implementation on meta"):
        cuda_build.use_kernel(torch.ones(2, device="meta"), "osplit encode")
