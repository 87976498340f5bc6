"""The port stands alone: it imports no module of the TPU package and no
part of its framework stack, and no file of it names either. It imports no
PIL, OpenCV or msgpack either (it reads and writes PNGs itself and saves
weights with torch; none of them is on the GPU machine), and matplotlib,
imageio and tensorboard only where a function needs them, never when a
module is imported (it carries the colormaps as tables; the video and the
TensorBoard events are optional). `chip_smoke.py` imports none of them (it
names the TPU kernels it replaces in its report)."""

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
        "             'cv2', 'msgpack', 'matplotlib', 'imageio', 'tensorboard'):\n"
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


@pytest.mark.parametrize("module", [
    "outdoor_nerf_depth_torch.utils.colormaps",
    "outdoor_nerf_depth_torch.utils.image",
    "outdoor_nerf_depth_torch.utils.vis",
    "outdoor_nerf_depth_torch.utils.logging",
    "outdoor_nerf_depth_torch.utils.tracing",
    "outdoor_nerf_depth_torch.train.lpips",
    "outdoor_nerf_depth_torch.train.metrics",
    "outdoor_nerf_depth_torch.train.offline_eval",
    "outdoor_nerf_depth_torch.train.loop",
    "outdoor_nerf_depth_torch.data.cameras",
    "outdoor_nerf_depth_torch.data.datasets",
    "outdoor_nerf_depth_torch.tools.eval",
    "outdoor_nerf_depth_torch.tools.render",
    "outdoor_nerf_depth_torch.tools.quality_gate",
    "outdoor_nerf_depth_torch.tools.sweep",
])
def test_the_eval_and_render_modules_are_checked(module):
    """The eval and render slice's modules are among those the tests above
    import with the reference stack, matplotlib, PIL, imageio and
    tensorboard blocked, and scan for the reference's names."""
    assert module in _port_modules()
    path = REPO / (module.replace(".", "/") + ".py")
    assert not BANNED.search(path.read_text())


@pytest.mark.parametrize("module", [
    "outdoor_nerf_depth_torch.data.cameras",
    "outdoor_nerf_depth_torch.data.datasets",
    "outdoor_nerf_depth_torch.train.losses",
    "outdoor_nerf_depth_torch.train.loop",
    "outdoor_nerf_depth_torch.tools.make_kitti_fixture",
    "outdoor_nerf_depth_torch.tools.make_blender_fixture",
])
def test_the_scene_reader_and_camera_modules_are_checked(module):
    """The modules of the scene readers, camera models and depth-loss
    families are among those the tests above import with the reference
    stack and PIL blocked and scan for the reference's names."""
    assert module in _port_modules()
    path = REPO / (module.replace(".", "/") + ".py")
    assert not BANNED.search(path.read_text())


@pytest.mark.parametrize("module", [
    "outdoor_nerf_depth_torch.ops.hashgrid",
    "outdoor_nerf_depth_torch.ops.occupancy",
    "outdoor_nerf_depth_torch.ops.prefix_scan",
    "outdoor_nerf_depth_torch.models.ngp",
    "outdoor_nerf_depth_torch.train.step",
    "outdoor_nerf_depth_torch.probes.ngp_layout",
])
def test_the_ngp_layout_and_option_modules_are_checked(module):
    """The modules of the hash layouts, the HDR field, extrinsics
    refinement, the visibility cull and the layout probe are among those
    the tests above import with the reference stack blocked and scan for
    its names."""
    assert module in _port_modules()
    path = REPO / (module.replace(".", "/") + ".py")
    assert not BANNED.search(path.read_text())


@pytest.mark.parametrize("module", [
    "outdoor_nerf_depth_torch.ops.refdirs",
    "outdoor_nerf_depth_torch.ops.volren",
    "outdoor_nerf_depth_torch.models.mlps",
    "outdoor_nerf_depth_torch.models.mipnerf360",
    "outdoor_nerf_depth_torch.train.losses",
    "outdoor_nerf_depth_torch.train.step",
    "outdoor_nerf_depth_torch.data.cameras",
    "outdoor_nerf_depth_torch.utils.raw",
])
def test_the_mip_option_and_raw_modules_are_checked(module):
    """The modules of the mip-NeRF 360 options (Ref-NeRF, GLO and exposure,
    cylinders, the rawnerf and normal losses), the last camera helpers and
    the raw-image utilities are among those the tests above import with the
    reference stack blocked and scan for its names."""
    assert module in _port_modules()
    path = REPO / (module.replace(".", "/") + ".py")
    assert not BANNED.search(path.read_text())


@pytest.mark.parametrize("module", [
    "outdoor_nerf_depth_torch.data.native_batcher",
    "outdoor_nerf_depth_torch.data.colmap_db",
    "outdoor_nerf_depth_torch.data.preprocess",
    "outdoor_nerf_depth_torch.depth_priors.pose",
    "outdoor_nerf_depth_torch.depth_priors.datasets",
    "outdoor_nerf_depth_torch.depth_priors.blocks",
    "outdoor_nerf_depth_torch.depth_priors.completion",
    "outdoor_nerf_depth_torch.depth_priors.stereo",
    "outdoor_nerf_depth_torch.tools.train_prior",
    "outdoor_nerf_depth_torch.train.loop",
])
def test_the_dataplane_pose_and_preprocessing_modules_are_checked(module):
    """The modules of the C++ dataplane, the OpenCV-free pose branch, the
    bf16 prior nets and the COLMAP preprocessing are among those the tests
    above import with the reference stack and OpenCV blocked and scan for
    the reference's names."""
    assert module in _port_modules()
    path = REPO / (module.replace(".", "/") + ".py")
    assert not BANNED.search(path.read_text())


def test_pose_estimation_runs_with_opencv_blocked():
    """`estimate_pose_pnp` (feature matching, PnP-RANSAC) imports and runs
    with `cv2` unimportable: on a textured pair shifted by 6 px at depth 10
    (fx 100) it finds tx ~0.6."""
    code = (
        "import sys\n"
        "for name in ('cv2', 'jax', 'outdoor_nerf_depth_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "from outdoor_nerf_depth_torch.depth_priors import pose\n"
        "rng = np.random.default_rng(33)\n"
        "base = rng.uniform(size=(16, 24, 3))\n"
        "rgb = np.clip(np.kron(base, np.ones((8, 8, 1))) + rng.normal(0, 0.02, (128, 192, 3)), 0, 1)\n"
        "rgb = rgb.astype(np.float32)\n"
        "K = np.array([[100.0, 0, 95.5], [0, 100.0, 63.5], [0, 0, 1]], np.float32)\n"
        "ok, R, t = pose.estimate_pose_pnp(rgb, np.roll(rgb, 6, axis=1),\n"
        "                                  np.full((128, 192), 10.0, np.float32), K)\n"
        "assert ok and abs(t[0] - 0.6) < 0.15 and np.abs(R - np.eye(3)).max() < 0.05, (R, t)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("module", [
    "outdoor_nerf_depth_torch.parallel",
    "outdoor_nerf_depth_torch.parallel.mesh",
    "outdoor_nerf_depth_torch.__main__",
    "outdoor_nerf_depth_torch.train.step",
    "outdoor_nerf_depth_torch.train.loop",
    "outdoor_nerf_depth_torch.train.losses",
    "outdoor_nerf_depth_torch.train.checkpoints",
    "outdoor_nerf_depth_torch.data.datasets",
    "outdoor_nerf_depth_torch.ops.occupancy",
    "outdoor_nerf_depth_torch.tools.slim_checkpoint",
    "outdoor_nerf_depth_torch.tools.eval_budget_checkpoint",
    "outdoor_nerf_depth_torch.tools.fixture_ablation",
])
def test_the_data_parallel_and_checkpoint_tool_modules_are_checked(module):
    """The modules of data parallelism (the collectives, the step, the loop,
    the CLI) and the checkpoint tools are among those the tests above import
    with the reference stack blocked and scan for its names."""
    assert module in _port_modules()
    path = REPO / (module.replace(".", "/") + ".py")
    if not path.is_file():
        path = REPO / module.replace(".", "/") / "__init__.py"
    assert not BANNED.search(path.read_text())


def test_the_collectives_module_imports_torch_only():
    """`parallel/` imports torch and the standard library, nothing else."""
    roots = set()
    for path in (PORT / "parallel").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                roots.add(node.module.split(".")[0])
    assert roots - set(sys.stdlib_module_names) - {"__future__"} == {"torch",
                                                                      "outdoor_nerf_depth_torch"}


@pytest.mark.parametrize("module", [
    "outdoor_nerf_depth_torch.utils.vis",
    "outdoor_nerf_depth_torch.tools.viewer",
    "outdoor_nerf_depth_torch.tools.export_lpips_weights",
    "outdoor_nerf_depth_torch.tools.run_public_benchmark",
    "outdoor_nerf_depth_torch.train.lpips",
    "outdoor_nerf_depth_torch.ops.hashgrid",
    "outdoor_nerf_depth_torch.probes",
    "outdoor_nerf_depth_torch.probes.workloads",
    "outdoor_nerf_depth_torch.probes.ngp_layout",
    "outdoor_nerf_depth_torch.probes.ngp_step",
    "outdoor_nerf_depth_torch.probes.ngp_bwd",
    "outdoor_nerf_depth_torch.probes.ngp_eval",
    "outdoor_nerf_depth_torch.probes.nerfpp_mfu",
    "outdoor_nerf_depth_torch.probes.nerfpp_ablate",
    "outdoor_nerf_depth_torch.probes.profile_step",
])
def test_the_viewer_exporter_runner_and_bench_probe_modules_are_checked(module):
    """The modules of the orbit viewer and frusta plot, the LPIPS exporter,
    the public-dataset runner and the bench probes are among those the tests
    above import with the reference stack and matplotlib blocked, and scan
    for the reference's names."""
    assert module in _port_modules()
    path = REPO / (module.replace(".", "/") + ".py")
    if not path.is_file():
        path = REPO / module.replace(".", "/") / "__init__.py"
    assert not BANNED.search(path.read_text())


def test_the_exporter_and_viewer_import_their_libraries_only_when_run():
    """torchvision, lpips and matplotlib are imported inside the functions
    that need them, never at module level."""
    for rel in ("tools/export_lpips_weights.py", "tools/viewer.py", "utils/vis.py"):
        tree = ast.parse((PORT / rel).read_text())
        top = set()
        for node in tree.body:
            if isinstance(node, ast.Import):
                top |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                top.add(node.module.split(".")[0])
        assert not top & {"torchvision", "lpips", "matplotlib"}, (rel, top)
