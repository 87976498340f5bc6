"""The control, on the card: the reference one precision below the
configuration's (TF32 for float32 with TF32 off) in the program's place
fails at least one of the cell's numbers, while the program passes them.

At a size a test run holds: the published widths on a quarter of the
batch, a short window. The full-size readings are `perfbench.readings
--control` on the chip (see PERF.md)."""

import time

import pytest

from perfbench import harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32, which only the card has")


@pytest.mark.cuda
@pytest.mark.parametrize("workload,program,traffic", [
    ("mip360_kitti.train", {"batch_size": 1024}, {"warmup_steps": 10}),
    ("ngp_kitti.train", {"batch_size": 2048}, {"warmup_steps": 272}),
    ("ngp_kitti.view", {}, {"warmup_train_steps": 64, "check_views": 2}),
])
def test_control_fails_and_program_passes(card, workload, program, traffic):
    harness.prepare_process()
    cell = harness.load_cell(workload)
    run = harness.Run(cell, 20_000_000_003, 1.0, False, "cuda", time.perf_counter(),
                      program_overrides=program, traffic_overrides=traffic, control=True)
    checks = harness.execute(run)["checks"]
    mine = {k: v for k, v in checks.items() if not k.startswith(("control.", "fault."))}
    control = {k[len("control."):]: v for k, v in checks.items() if k.startswith("control.")}
    assert all(v["value"] <= v["limit"] for v in mine.values()), mine
    assert any(v["value"] > v["limit"] for v in control.values()), control
