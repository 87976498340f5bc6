"""The port's LPIPS weights exporter against the repository's root tool, on
stand-in `torchvision` and `lpips` modules (neither is installed here, and
the real weights need a download) that serve seeded random state dicts of
the real shapes: equal npz keys, shapes, values and provenance stamp; the
port's `load_weights` accepts the file; the port's tool runs with JAX and
the reference package unimportable."""

import importlib.util
import pathlib
import sys
import types

import numpy as np
import pytest
import torch
from torch import nn

from outdoor_nerf_depth_torch.tools import export_lpips_weights as t_export
from outdoor_nerf_depth_torch.train import lpips as t_lpips

REPO = pathlib.Path(__file__).resolve().parents[1]
LPIPS_CHANNELS = (64, 128, 256, 512, 512)


def _seeded(module: nn.Module, gen: torch.Generator):
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return module


def _standins(seed: int):
    """(torchvision, lpips) stand-ins: VGG16's `features` (13 3x3
    convolutions with ReLUs and max pools) and LPIPS's five 1x1 `lins`
    behind a dropout, with seeded weights (some calibration weights < 0)."""
    gen = torch.Generator().manual_seed(seed)
    layers, cin = [], 3
    for _, cout, pool in t_lpips.VGG16_CONVS:
        if pool:
            layers.append(nn.MaxPool2d(2, 2))
        layers += [_seeded(nn.Conv2d(cin, cout, 3, padding=1), gen), nn.ReLU(inplace=True)]
        cin = cout
    layers.append(nn.MaxPool2d(2, 2))
    features = nn.Sequential(*layers)

    torchvision = types.ModuleType("torchvision")
    torchvision.models = types.SimpleNamespace(
        VGG16_Weights=types.SimpleNamespace(IMAGENET1K_V1="IMAGENET1K_V1"),
        vgg16=lambda weights: types.SimpleNamespace(features=features)
        if weights == "IMAGENET1K_V1" else pytest.fail(f"weights {weights!r}"))
    lins = [types.SimpleNamespace(model=nn.Sequential(
        nn.Dropout(), _seeded(nn.Conv2d(c, 1, 1, bias=False), gen))) for c in LPIPS_CHANNELS]
    lpips = types.ModuleType("lpips")
    lpips.LPIPS = lambda net: types.SimpleNamespace(lins=lins) if net == "vgg" \
        else pytest.fail(f"net {net!r}")
    return torchvision, lpips


def _root_tool():
    spec = importlib.util.spec_from_file_location(
        "root_export_lpips_weights", REPO / "tools" / "export_lpips_weights.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The port's and the root tool's files from the same stand-ins."""
    out = tmp_path_factory.mktemp("lpips")
    torchvision, lpips = _standins(7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torchvision", torchvision)
        mp.setitem(sys.modules, "lpips", lpips)
        t_export.main(str(out / "port" / "lpips_vgg.npz"))
        _root_tool().main(str(out / "root" / "lpips_vgg.npz"))
    return np.load(out / "port" / "lpips_vgg.npz"), np.load(out / "root" / "lpips_vgg.npz"), out


def test_npz_equals_the_root_tools(exported):
    port, root, _ = exported
    assert sorted(port.files) == sorted(root.files)
    assert len(port.files) == 2 * len(t_lpips.VGG16_CONVS) + len(LPIPS_CHANNELS) + 1
    for key in port.files:
        assert port[key].shape == root[key].shape, key
        assert port[key].dtype == root[key].dtype, key
        assert np.array_equal(port[key], root[key]), key


def test_contract_layout_and_stamp(exported):
    port, _, _ = exported
    assert str(port[t_lpips.PROVENANCE_KEY]) == t_lpips.EXPORT_PROVENANCE
    cin = 3
    for name, cout, _ in t_lpips.VGG16_CONVS:
        assert port[f"{name}/kernel"].shape == (3, 3, cin, cout)
        assert port[f"{name}/bias"].shape == (cout,)
        cin = cout
    for k, c in enumerate(LPIPS_CHANNELS):
        w = port[f"lin{k}/weight"]
        assert w.shape == (c,) and w.min() == 0.0  # the stand-ins' negatives clipped


def test_the_port_loads_the_exported_file(exported):
    _, _, out = exported
    weights = t_lpips.load_weights(str(out / "port" / "lpips_vgg.npz"))
    assert t_lpips.PROVENANCE_KEY not in weights
    assert weights["conv5_3/kernel"].shape == (3, 3, 512, 512)
    assert t_lpips.make_lpips_fn(str(out / "port" / "lpips_vgg.npz"), device="cpu")(
        np.zeros((32, 32, 3)), np.zeros((32, 32, 3))) == 0.0


def test_the_port_tool_runs_without_the_reference_stack(tmp_path, monkeypatch, capsys):
    torchvision, lpips = _standins(8)
    monkeypatch.setitem(sys.modules, "torchvision", torchvision)
    monkeypatch.setitem(sys.modules, "lpips", lpips)
    for name in ("jax", "jaxlib", "flax", "outdoor_nerf_depth_tpu"):
        monkeypatch.setitem(sys.modules, name, None)
    t_export.main(str(tmp_path / "w.npz"))
    assert "provenance-stamped" in capsys.readouterr().out
    assert t_lpips.load_weights(str(tmp_path / "w.npz"))["lin4/weight"].shape == (512,)


def test_the_missing_file_error_names_the_ports_exporter(tmp_path):
    with pytest.raises(ValueError, match="-m outdoor_nerf_depth_torch.tools.export_lpips_weights"):
        t_lpips.load_weights(str(tmp_path / "absent.npz"))
