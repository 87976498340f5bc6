"""Load a Flax parameter tree into the port's model.

The reference package's models keep their weights as nested dicts
`{"params": {"nerf_mlp": {"trunk0": {"kernel", "bias"}, ...}, ...}}`. Here
each Flax `Dense` is an `nn.Linear` of the same name; a Dense kernel is
[in, out] and a Linear weight is [out, in]. A module that lists
`flax_dense_names` (NeRF++'s `PointFieldMLP`) takes Flax's auto-named
`Dense_{i}` as its i-th named layer. A Flax `Embed` (`embedding`, NeRF++'s
autoexposure) is an `nn.Embedding` weight and, like the hash-grid table
(`field/encoder/table`, [L, T, F]), is copied as it is.

The depth-prior nets (`depth_priors/`) hold 2D and 3D `Conv` kernels
[*kernel, in, out], which become torch weights [out, in, *kernel], GroupNorm
`scale`/`bias` (weight and bias), MMAF's `Dense` layers and StereoNet's
`range_gamma`, a parameter of the model itself. A module that lists
`flax_names` maps Flax's auto-names of its children (`ConvBlock_0`,
`ResBlock_3`, `Hourglass3d_0`, ...) to torch attribute paths.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _module_name(model: torch.nn.Module, path) -> str:
    """The torch name of the Flax module at `path`, auto-named Dense layers
    resolved through their parent's `flax_dense_names`."""
    names, module = [], model
    for key in path:
        auto = re.fullmatch(r"Dense_(\d+)", key)
        dense_names = getattr(module, "flax_dense_names", None)
        if auto and dense_names is not None:
            if int(auto.group(1)) >= len(dense_names):
                raise ValueError(f"Flax module {'/'.join(path)} has no counterpart")
            key = dense_names[int(auto.group(1))]
        key = getattr(module, "flax_names", {}).get(key, key)
        names.append(key)
        for part in key.split("."):
            module = getattr(module, part, None)
    return ".".join(names)


def flax_submodule(model: torch.nn.Module, name: str):
    """The submodule of `model` that holds the Flax top-level module `name`,
    or None when the model has none."""
    path = _module_name(model, (name,))
    return model.get_submodule(path) if hasattr(model, path) else None


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
        module = _module_name(model, module)
        prefix = module + "." if module else ""
        val = np.array(val, dtype=np.float32)  # a writable copy
        if leaf == "kernel":
            # [*kernel, in, out] -> [out, in, *kernel]; a Dense kernel is transposed.
            name = prefix + "weight"
            val = val.transpose((val.ndim - 1, val.ndim - 2) + tuple(range(val.ndim - 2)))
        elif leaf in ("embedding", "scale"):
            name = prefix + "weight"
        elif leaf in ("bias", "table") or prefix + leaf in wanted:
            name = prefix + leaf
        else:
            raise ValueError(f"unexpected Flax leaf {'/'.join(path)}")
        if name not in wanted:
            raise ValueError(f"Flax parameter {'/'.join(path)} has no counterpart {name}")
        if tuple(val.shape) != tuple(wanted[name].shape):
            raise ValueError(
                f"{name}: Flax shape {val.shape} (transposed) vs torch {tuple(wanted[name].shape)}"
            )
        state[name] = torch.from_numpy(val.copy(order="C"))
    missing = sorted(set(wanted) - set(state))
    if missing:
        raise ValueError(f"no Flax parameters for {missing}")
    with torch.no_grad():
        for name, val in state.items():
            wanted[name].copy_(val)
    return model
