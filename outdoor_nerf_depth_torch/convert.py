"""Load a Flax parameter tree into the port's model.

The reference package's `ProposalModel` keeps its weights as nested dicts
`{"params": {"nerf_mlp": {"trunk0": {"kernel", "bias"}, ...}, "prop_mlp":
...}}`. Here each Flax `Dense` is an `nn.Linear` of the same name; a Dense
kernel is [in, out] and a Linear weight is [out, in].
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def params_from_flax(tree: Mapping, model: torch.nn.Module) -> torch.nn.Module:
    """Copy `tree` (numpy leaves, with or without the "params" level) into `model`.

    Raises ValueError on any parameter that is missing, left over, or of
    another shape. Returns `model`.
    """
    tree = tree.get("params", tree)
    wanted = dict(model.named_parameters())
    state = {}
    for path, val in _flatten(tree):
        *module, leaf = path
        val = np.array(val, dtype=np.float32)  # a writable copy
        if leaf == "kernel":
            name, val = ".".join(module) + ".weight", val.T
        elif leaf == "bias":
            name = ".".join(module) + ".bias"
        else:
            raise ValueError(f"unexpected Flax leaf {'/'.join(path)}")
        if name not in wanted:
            raise ValueError(f"Flax parameter {'/'.join(path)} has no counterpart {name}")
        if tuple(val.shape) != tuple(wanted[name].shape):
            raise ValueError(
                f"{name}: Flax shape {val.shape} (transposed) vs torch {tuple(wanted[name].shape)}"
            )
        state[name] = torch.from_numpy(np.ascontiguousarray(val))
    missing = sorted(set(wanted) - set(state))
    if missing:
        raise ValueError(f"no Flax parameters for {missing}")
    with torch.no_grad():
        for name, val in state.items():
            wanted[name].copy_(val)
    return model
