"""The port stands alone: it imports no module of the TPU package and no
part of its framework stack, and no file of it names either. It imports no
PIL, OpenCV or msgpack either (it reads and writes PNGs itself and saves
weights with torch; none of them is on the GPU machine). `chip_smoke.py`
imports none of them (it names the TPU kernels it replaces in its report)."""

import ast
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "outdoor_nerf_depth_torch"
BANNED = re.compile(r"\bjax\b|outdoor_nerf_depth_tpu", re.IGNORECASE)


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_without_the_reference_stack():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'outdoor_nerf_depth_tpu', 'PIL',\n"
        "             'cv2', 'msgpack'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {_port_modules()!r}:\n"
        "    importlib.import_module(mod)\n"
        "loaded = [m for m in sys.modules if m.startswith('outdoor_nerf_depth_tpu') and sys.modules[m]]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_port_file_names_the_reference_stack():
    files = [p for p in PORT.rglob("*") if p.is_file() and p.suffix in (".py", ".cu", ".cuh")]
    assert len(files) > 10
    offenders = [str(p.relative_to(REPO)) for p in files if BANNED.search(p.read_text())]
    assert not offenders, offenders


def test_chip_smoke_imports_only_the_port():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    allowed = {"torch", "numpy", "outdoor_nerf_depth_torch", "__future__"} | set(sys.stdlib_module_names)
    assert roots <= allowed, roots - allowed


@pytest.mark.parametrize("module", ["outdoor_nerf_depth_torch.ops.geometry",
                                    "outdoor_nerf_depth_torch.models.nerfpp",
                                    "outdoor_nerf_depth_torch.models.mlps",
                                    "outdoor_nerf_depth_torch.data.datasets"])
def test_the_nerfpp_modules_are_checked(module):
    """The NeRF++ slice's modules are among those the tests above import
    with the reference stack blocked and scan for its names."""
    assert module in _port_modules()
    path = REPO / (module.replace(".", "/") + ".py")
    assert not BANNED.search(path.read_text())


@pytest.mark.parametrize("module", [
    "outdoor_nerf_depth_torch.depth_priors.blocks",
    "outdoor_nerf_depth_torch.depth_priors.stereo",
    "outdoor_nerf_depth_torch.depth_priors.completion",
    "outdoor_nerf_depth_torch.depth_priors.datasets",
    "outdoor_nerf_depth_torch.depth_priors.generate",
    "outdoor_nerf_depth_torch.depth_priors.benchmark_data",
    "outdoor_nerf_depth_torch.ops.guided_conv",
    "outdoor_nerf_depth_torch.utils.image",
    "outdoor_nerf_depth_torch.tools.priors",
    "outdoor_nerf_depth_torch.tools.train_prior",
    "outdoor_nerf_depth_torch.tools.e2e_prior_loop",
])
def test_the_prior_modules_are_checked(module):
    """The depth-prior slice's modules are among those the tests above
    import with the reference stack blocked and scan for its names."""
    assert module in _port_modules()
    path = REPO / (module.replace(".", "/") + ".py")
    assert not BANNED.search(path.read_text())
