"""The port stands alone: it imports no module of the TPU package and no
part of its framework stack, and no file of it names either. `chip_smoke.py`
imports neither (it names the TPU kernels it replaces in its report)."""

import ast
import pathlib
import re
import subprocess
import sys

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
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'outdoor_nerf_depth_tpu'):\n"
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
