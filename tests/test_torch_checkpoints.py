"""The port's checkpoints on the CPU: save, restore and keep-N pruning, an
interrupted write, the model-identity sidecar, slim checkpoints, a resumed
run against the uninterrupted one, the idempotent-run guard, and a run
stopped early of its schedule."""

import json
import os

import pytest
import torch

from outdoor_nerf_depth_torch.data import datasets as t_datasets
from outdoor_nerf_depth_torch.train import checkpoints as ckpt_lib
from outdoor_nerf_depth_torch.train import loop as t_loop
from outdoor_nerf_depth_torch.train import step as t_step
from outdoor_nerf_depth_torch.train.config import load_config

torch.set_num_threads(1)

CONFIG = "configs/kitti_ngp.json"
MODEL = dict(scale=0.5, max_samples=16, n_candidates=64, grid_resolution=16, sample_budget=8,
             field_params=dict(n_levels=2, log2_table_size=10, base_resolution=4,
                               max_resolution=16, hidden_width=16, geo_features=7))
SMALL = ["dataset=synthetic", "batch_size=64", "max_steps=4", "print_every=1",
         "checkpoint_every=2", "occupancy_update_every=2", "occupancy_cells_per_update=64",
         "keep_checkpoints=5", "model_params=" + json.dumps(MODEL)]


def _state(i):
    return {"model": {"w": torch.full((3,), float(i))}, "step": i}


def test_save_restore_and_keep_n_pruning(tmp_path):
    mgr = ckpt_lib.CheckpointManager(str(tmp_path), keep=2)
    assert mgr.restore() == (None, 0)
    for i in (1, 2, 3, 4):
        mgr.save(i, _state(i))
    assert sorted(os.listdir(tmp_path)) == ["3", "4"]
    assert ckpt_lib.latest_step(str(tmp_path)) == 4
    state, step = mgr.restore()
    assert step == 4 and state["step"] == 4 and torch.equal(state["model"]["w"], torch.full((3,), 4.0))
    state, step = mgr.restore(step=3)
    assert step == 3 and torch.equal(state["model"]["w"], torch.full((3,), 3.0))
    mgr.save(4, _state(40))  # the same step again replaces it
    assert mgr.restore()[0]["step"] == 40
    assert ckpt_lib.latest_step(str(tmp_path / "missing")) is None


def test_interrupted_write_is_not_picked_up(tmp_path, monkeypatch):
    mgr = ckpt_lib.CheckpointManager(str(tmp_path), keep=3)
    mgr.save(2, _state(2))
    real_save = torch.save

    def killed(obj, f):
        f.write(b"half a checkpoint")
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", killed)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(4, _state(4))
    monkeypatch.setattr(torch, "save", real_save)
    assert ckpt_lib.latest_step(str(tmp_path)) == 2
    assert mgr.restore()[1] == 2
    assert any(n.startswith(".tmp") for n in os.listdir(tmp_path))
    ckpt_lib.CheckpointManager(str(tmp_path))  # the next run clears what the killed one left
    assert sorted(os.listdir(tmp_path)) == ["2"]


def test_meta_mismatch_raises(tmp_path):
    ckpt_lib.write_model_meta(str(tmp_path), {"model": "ngp", "hash_function": "corner"})
    ckpt_lib.check_model_meta(str(tmp_path), {"model": "ngp", "other": 1})  # unshared keys pass
    with pytest.raises(ValueError, match="hash_function"):
        ckpt_lib.check_model_meta(str(tmp_path), {"model": "ngp", "hash_function": "linear"})
    exp = tmp_path / "exp"
    ckpt_lib.write_model_meta(str(exp / "checkpoints"), {"model": "mipnerf360"})
    config = load_config(CONFIG, SMALL + [f"exp_dir={exp}"])
    with pytest.raises(ValueError, match="model"):
        t_loop.train(config, device="cpu", log_fn=lambda line: None)
    with pytest.raises(ValueError, match="model"):
        t_step.load_checkpoint(config)


def test_slim_round_trip(tmp_path):
    config = load_config(CONFIG, SMALL + [f"exp_dir={tmp_path}"])
    model = t_step.build_model(config, generator=torch.Generator().manual_seed(5))
    model.occupancy.uniform_(0.0, 1.0)
    path = str(tmp_path / "slim" / "model.pt")
    ckpt_lib.export_slim(path, dict(model.named_parameters()), model.occupancy,
                         meta=t_step.checkpoint_meta(config, model), step=7)
    payload = ckpt_lib.load_slim(path)
    assert set(payload) == {"params", "meta", "step", "occupancy"}
    assert payload["meta"] == {"model": "ngp", "hash_function": "linear"}
    restored, step = t_step.load_checkpoint(config.replace(slim_checkpoint=path))
    assert step == 7
    for name, value in model.state_dict().items():
        assert torch.equal(restored.state_dict()[name], value), name
    ckpt_lib.export_slim(path, dict(model.named_parameters()), meta={"model": "mipnerf360"})
    with pytest.raises(ValueError, match="incompatible"):
        t_step.load_checkpoint(config.replace(slim_checkpoint=path))
    ckpt_lib.export_slim(path, {"field.rgb_out.weight": model.field.rgb_out.weight})
    with pytest.raises(ValueError, match="parameters"):
        t_step.load_checkpoint(config.replace(slim_checkpoint=path))


class _OneBatch(t_datasets.SyntheticDataset):
    """Serves one batch every step, so two runs see the same batches."""

    def __init__(self):
        super().__init__("train", global_batch_size=64, seed=1)
        self._batch = super().sample_batch()

    def sample_batch(self):
        return self._batch


class _Interrupt(Exception):
    pass


def _train(exp, stop_at=None):
    """train() in `exp`; raises _Interrupt when the log reaches `stop_at`."""
    lines = []

    def log(line):
        lines.append(json.loads(line))
        if stop_at is not None and lines[-1].get("step") == stop_at:
            raise _Interrupt

    # The batches come from `_OneBatch.sample_batch`, not the C++ dataplane
    # (which restarts its stream on a resume, as the reference's does).
    config = load_config(CONFIG, SMALL + [f"exp_dir={exp}", "use_native_batcher=false"])
    model, history = t_loop.train(config, device="cpu", log_fn=log, dataset=_OneBatch())
    return model, history, lines


def _checkpoint(exp, step):
    return torch.load(os.path.join(exp, "checkpoints", str(step), ckpt_lib.STATE_FILENAME),
                      weights_only=True)


def _assert_same(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}/{i}")
    else:
        assert a == b, path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    whole = tmp_path_factory.mktemp("whole")
    model, history, _ = _train(whole)
    cut = tmp_path_factory.mktemp("cut")
    with pytest.raises(_Interrupt):  # killed after step 3, before its checkpoint
        _train(cut, stop_at=3)
    assert sorted(os.listdir(cut / "checkpoints")) == ["2", "model_meta.json"]
    resumed_model, resumed_history, resumed_lines = _train(cut)
    return whole, model, history, cut, resumed_model, resumed_history, resumed_lines


def test_resumed_run_equals_the_uninterrupted_run(runs):
    whole, model, history, cut, resumed_model, resumed_history, lines = runs
    assert lines[0] == {"restored_step": 2}
    # What the resume restored: parameters, Adam moments and step counts,
    # the occupancy grid and the generator, exactly as the uninterrupted run
    # left them after step 2.
    _assert_same(_checkpoint(cut, 2), _checkpoint(whole, 2))
    state = _checkpoint(whole, 2)
    assert {"field.encoder.table", "occupancy"} <= set(state["model"])
    assert {"exp_avg", "exp_avg_sq", "step"} <= set(state["optimizer"]["state"][0])
    assert state["step"] == 2 and state["generator"].dtype == torch.uint8
    # The steps after the resume are the uninterrupted run's steps.
    assert [h["step"] for h in resumed_history] == [3, 4]
    for got, want in zip(resumed_history, history[2:]):
        for key in ("loss", "psnr", "grad_norm", "rm_s", "vr_s"):
            assert got[key] == want[key], (got["step"], key)
    _assert_same(_checkpoint(cut, 4), _checkpoint(whole, 4))
    for name, value in model.state_dict().items():
        assert torch.equal(resumed_model.state_dict()[name], value), name


def test_idempotent_guard_trains_nothing(runs):
    whole, model = runs[0], runs[1]

    class NoData(_OneBatch):
        def sample_batch(self):
            raise AssertionError("a finished run loaded a batch")

    lines = []
    config = load_config(CONFIG, SMALL + [f"exp_dir={whole}"])
    again, history = t_loop.train(config, device="cpu", log_fn=lines.append, dataset=NoData())
    assert history == [] and json.loads(lines[0]) == {"step": 4, "already_complete": True}
    assert sorted(os.listdir(whole / "checkpoints")) == ["2", "4", "model_meta.json"]
    for name, value in model.state_dict().items():
        assert torch.equal(again.state_dict()[name], value), name
    restored, step = t_step.load_checkpoint(config)
    assert step == 4
    for name, value in model.state_dict().items():
        assert torch.equal(restored.state_dict()[name], value), name


def test_stopping_early_keeps_the_schedule(tmp_path):
    """train(max_steps=2) of a 4-step config stops after 2 steps with the
    4-step LR schedule; the guard then holds, and a full run resumes."""
    config = load_config(CONFIG, SMALL + [f"exp_dir={tmp_path}"])
    _, history = t_loop.train(config, device="cpu", log_fn=lambda line: None,
                              dataset=_OneBatch(), max_steps=2)
    assert [h["step"] for h in history] == [1, 2]
    state = _checkpoint(tmp_path, 2)
    _, lr_fn = t_step.make_optimizer(config, t_step.build_model(config))
    assert state["optimizer"]["param_groups"][0]["lr"] == lr_fn(1)  # the 2nd update's rate
    lines = []
    _, history = t_loop.train(config, device="cpu", log_fn=lines.append, dataset=_OneBatch(),
                              max_steps=2)
    assert history == [] and json.loads(lines[0])["already_complete"]
    _, history = t_loop.train(config, device="cpu", log_fn=lambda line: None,
                              dataset=_OneBatch())
    assert [h["step"] for h in history] == [3, 4]
