"""Checkpoint and resume on `torch.save`: keep-N, one directory per step.

Port of the reference package's `train/checkpoints.py`. A checkpoint of
step N lives in `<directory>/<N>/state.pt`; it is written under a hidden
temporary name and renamed into place, so a run killed while writing never
leaves a directory that `latest_step` would pick. What a checkpoint holds
is the caller's dict (the train loop stores the model's `state_dict` with
the NGP occupancy grid, the optimizer's state, the step and the state of
the device `torch.Generator`).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import torch

# Sidecar recording non-restorable model identity next to the step dirs.
# Checkpoints whose hash function (or model family) disagrees with the code
# restoring them would load without error and silently render garbage; the
# meta file makes that a loud failure.
META_FILENAME = "model_meta.json"
STATE_FILENAME = "state.pt"
_TMP_PREFIX = ".tmp-"


def latest_step(directory: str) -> Optional[int]:
    """Latest checkpointed step under `directory`, or None when no
    checkpoint exists: a cheap directory probe for the idempotent-run guard."""
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name)
        for name in os.listdir(directory)
        if name.isdigit() and os.path.isdir(os.path.join(directory, name))
    ]
    return max(steps) if steps else None


def write_model_meta(directory: str, meta: Dict[str, Any]):
    """Write the model-identity sidecar (idempotent)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, META_FILENAME), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)


def read_model_meta(directory: str) -> Optional[Dict[str, Any]]:
    """Read the sidecar; None when absent."""
    path = os.path.join(directory, META_FILENAME)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def meta_mismatches(stored: Dict[str, Any], expected: Dict[str, Any]) -> Dict[str, tuple]:
    """{key: (stored, expected)} for keys on both sides that disagree."""
    return {k: (stored[k], expected[k]) for k in expected if k in stored and stored[k] != expected[k]}


def check_model_meta(directory: str, expected: Dict[str, Any]):
    """Raise ValueError when a stored sidecar disagrees with `expected`.

    Keys present in only one side are ignored (forward compatibility);
    a missing sidecar passes (nothing to check against).
    """
    stored = read_model_meta(directory)
    mismatches = {} if stored is None else meta_mismatches(stored, expected)
    if mismatches:
        detail = ", ".join(
            f"{k}: checkpoint={s!r} vs current={e!r}" for k, (s, e) in sorted(mismatches.items())
        )
        raise ValueError(
            f"checkpoint at {directory!r} was written by an incompatible "
            f"model configuration ({detail}). Restoring it would silently "
            "produce garbage: match the stored configuration or start a fresh exp_dir."
        )


def _load(path: str):
    """A file of tensors (saved from any device) with its tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def export_slim(path: str, params: Dict[str, torch.Tensor], occupancy: Optional[torch.Tensor] = None,
                meta: Optional[Dict[str, Any]] = None, step: int = 0):
    """Params-only checkpoint (no optimizer state) for rendering and
    distribution, one file; the NGP occupancy grid is embedded when given."""
    payload = {"params": {k: v.detach() for k, v in params.items()}, "meta": dict(meta or {}),
               "step": int(step)}
    if occupancy is not None:
        payload["occupancy"] = occupancy
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(payload, path)


def load_slim(path: str) -> Dict[str, Any]:
    """Load a slim checkpoint written by `export_slim`.

    Returns {"params", "meta", "step"[, "occupancy"]}, tensors on the CPU."""
    return _load(path)


class CheckpointManager:
    """Step-indexed checkpoints under `directory`, the newest `keep` kept."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        # Writes a killed run left unfinished.
        for name in os.listdir(self.directory):
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name))

    def save(self, step: int, state: Dict[str, Any]):
        """Write `state` (tensors on any device) as the checkpoint of `step`,
        then drop all but the newest `keep`."""
        tmp = os.path.join(self.directory, f"{_TMP_PREFIX}{step}")
        os.makedirs(tmp)
        with open(os.path.join(tmp, STATE_FILENAME), "wb") as f:
            torch.save(state, f)
            f.flush()
            os.fsync(f.fileno())
        final = os.path.join(self.directory, str(int(step)))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        steps = sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())
        for old in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: Optional[int] = None):
        """The state of the latest (or given) step, tensors on the CPU.

        Returns (state, step), or (None, 0) when no checkpoint exists.
        """
        step = latest_step(self.directory) if step is None else step
        if step is None:
            return None, 0
        return _load(os.path.join(self.directory, str(step), STATE_FILENAME)), int(step)
