"""The kernel probes' port: the "merged" hash-table row sums against the
reference package's (selected there by ONDT_OSPLIT_ROWSUMS=merged) and the
port's own row sums, and the probes' entry points at tiny sizes on the CPU."""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outdoor_nerf_depth_torch.ops import hashgrid as t_hg
from outdoor_nerf_depth_torch.probes import gather_attack, ngp_layout, osplit_bwd
from outdoor_nerf_depth_tpu.ops import hashgrid as j_hg

torch.set_num_threads(1)

OSPLIT_KEYS = {
    "osplit_fwd_s", "osplit_fwd_bwd_s", "sort_data_1lvl_s", "vgather_1lvl_s",
    "sentinel_sorts_1lvl_s", "cumsum_plain_1lvl_s", "cumsum_kernel_1lvl_s", "row_sums_1lvl_s",
    "row_sums_merged_1lvl_s", "merged_matches", "osplit_fwd_bwd_plain_scan_derived_s",
    "sort_16_separate_s", "sort_batched_s", "cumsum_plain_16_s", "cumsum_kernel_batched_s",
    "vgather_16_separate_s", "vgather_batched_s", "table_grad_one_pass_s",
    "table_grad_per_level_s", "one_pass_matches", "sort_level_keys_int64_s",
    "sort_level_keys_int32_s", "products_kernel_s", "products_plain_s", "segment_ends_s",
    "fold_kernel_s", "fold_plain_s",
}


@pytest.mark.parametrize("m,n_rows,high", [(2000, 300, 250), (4096, 1024, 1024), (50, 7, 7)])
def test_merged_row_sums_match_reference_and_port(monkeypatch, m, n_rows, high):
    rng = np.random.default_rng(m)
    idx = rng.integers(0, high, m).astype(np.int32)  # rows >= high stay empty
    vals = rng.normal(size=(m, 16)).astype(np.float32)
    monkeypatch.setenv("ONDT_OSPLIT_ROWSUMS", "merged")
    want = np.asarray(j_hg._oct_split_row_sums(jnp.asarray(idx), jnp.asarray(vals), n_rows))
    idx_t = torch.from_numpy(idx).to(torch.int64)
    got = t_hg._oct_split_row_sums_merged(idx_t, torch.from_numpy(vals), n_rows)
    assert got.shape == (n_rows, 16) and got.dtype == torch.float32
    # Differences of f32 prefix sums of bf16-rounded values, in other orders
    # of equal keys: rounding scales with the prefix (as test_torch_hashgrid).
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(),
                               t_hg._oct_split_row_sums(idx_t, torch.from_numpy(vals), n_rows),
                               rtol=1e-4, atol=1e-4)
    assert np.all(got[high:].numpy() == 0)


def _times_ok(results):
    for key, value in results.items():
        if key.endswith(("_s", "_ns_per_row")):
            assert isinstance(value, float) and math.isfinite(value) and value > 0, key


def test_osplit_probe_on_cpu(tmp_path):
    out = tmp_path / "osplit.json"
    osplit_bwd.main(["--device", "cpu", "--samples", "512", "--log2t", "10", "--reps", "1",
                     "--out", str(out)])
    results = json.loads(out.read_text())
    assert OSPLIT_KEYS <= set(results)
    assert results["merged_matches"] and results["device"] == "cpu" and results["m"] == 512
    _times_ok(results)
    # The CPU runs the plain versions: the timed calls launch no kernel.
    assert results["one_pass_matches"]
    for group in ("cumsum_kernel_batched", "osplit_fwd_bwd", "table_grad_one_pass",
                  "table_grad_per_level", "products_kernel", "fold_kernel"):
        assert results["launches"][group] == {"calls": 2, "launches": 0}, group
    assert "derived" in results["notes"]["osplit_fwd_bwd_plain_scan_derived_s"]


def test_gather_probe_on_cpu():
    results = gather_attack.run(device="cpu", queries=4096, reps=1, table_log2_rows=(8, 10),
                                onehot_rows=2048)
    want = {"A_take_2^8rows_ns_per_row", "A_take_2^10rows_ns_per_row", "C_smem_take_ns_per_row",
            "C_library_ns_per_row", "D_onehot_ns_per_row", "D_onehot_total_s",
            "D_library_ns_per_row", "B_method"} | {f"B_sort_{n}ops_s" for n in (1, 2, 5, 10)}
    assert want <= set(results)
    _times_ok(results)
    assert results["C_max_abs_err"] == 0.0 and results["D_max_abs_err"] == 0.0
    assert results["D_shape"]["tiles"] == 16 and results["D_shape"]["chunks"] == 4
    assert results["launches"]["P1"] == {"calls": 2, "launches": 0}


def test_probes_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device would run the full probe")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gather_attack.run()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        osplit_bwd.main([])


LAYOUT_KEYS = {"fwd_s", "fwd_bwd_s", "launches", "full"}


def test_ngp_layout_probe_on_cpu(tmp_path):
    out = tmp_path / "layouts.json"
    ngp_layout.main(["--device", "cpu", "--samples", "512", "--log2t", "10", "--batch", "64",
                     "--grid-res", "16", "--reps", "1", "--step-reps", "1", "--out", str(out)])
    results = json.loads(out.read_text())
    assert results["backend"] == "cpu" and results["samples"] == 512
    for layout in ngp_layout.LAYOUTS:
        assert LAYOUT_KEYS <= set(results[layout]), layout
        assert results[layout]["launches"]["K2a"] == {"calls": 2, "launches": 0}
        _times_ok(results[layout])
        _times_ok(results[layout]["full"])
        assert results[layout]["full"]["rays_per_sec"] > 0
    with pytest.raises(SystemExit):
        ngp_layout.main(["--device", "cpu", "--layouts", "oct,nope"])
