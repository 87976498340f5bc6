"""The port's depth-prior data and tools against the reference package on
the CPU: `save_depth_u16`'s codes, the stereo and completion datasets'
batches, the stereo benchmark layer (PFM, list files, scanners, augmented
and eval batches, EPE/D1), the PNGs `generate_*` write from converted
weights, and the port's `priors`, `train_prior` and `e2e_prior_loop`
tools at tiny sizes. Folders are written into `tmp_path` with the port's
PNG codec and read by both packages."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import test_torch_depth_priors as nets
from outdoor_nerf_depth_torch import convert
from outdoor_nerf_depth_torch.data import png
from outdoor_nerf_depth_torch.depth_priors import benchmark_data as t_bd
from outdoor_nerf_depth_torch.depth_priors import datasets as t_data
from outdoor_nerf_depth_torch.depth_priors import generate as t_generate
from outdoor_nerf_depth_torch.depth_priors import stereo as t_stereo
from outdoor_nerf_depth_torch.tools import e2e_prior_loop as t_e2e
from outdoor_nerf_depth_torch.tools import make_kitti_fixture
from outdoor_nerf_depth_torch.tools import priors as t_priors
from outdoor_nerf_depth_torch.tools import train_prior as t_train_prior
from outdoor_nerf_depth_torch.utils.image import save_depth_u16 as t_save_depth_u16
from outdoor_nerf_depth_tpu.data.datasets import load_image as j_load_image
from outdoor_nerf_depth_tpu.depth_priors import benchmark_data as j_bd
from outdoor_nerf_depth_tpu.depth_priors import completion as j_completion
from outdoor_nerf_depth_tpu.depth_priors import datasets as j_data
from outdoor_nerf_depth_tpu.depth_priors import generate as j_generate
from outdoor_nerf_depth_tpu.depth_priors import stereo as j_stereo
from outdoor_nerf_depth_tpu.utils.image import save_depth_u16 as j_save_depth_u16

torch.set_num_threads(1)

H, W = 40, 72  # not multiples of 32: generate pads and crops


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _save_rgb(path, rng, h=H, w=W):
    png.write_png(str(path), (rng.uniform(size=(h, w, 3)) * 255).astype(np.uint8))


def _save_u16(path, values):
    t_save_depth_u16(values, str(path))


def _stereo_root(root, names=("left", "right", "disp"), n=3, seed=0):
    rng = np.random.default_rng(seed)
    for sub in names:
        os.makedirs(root / sub)
    for i in range(n):
        name = f"{i:06d}.png"
        _save_rgb(root / names[0] / name, rng)
        _save_rgb(root / names[1] / name, rng)
        if len(names) > 2 and i != 1:  # frame 1 has no disparity file
            _save_u16(root / names[2] / name, rng.uniform(1, 60, (H, W)))
    return str(root)


def _completion_root(root, n=3, seed=1, with_gt=True):
    rng = np.random.default_rng(seed)
    for sub in ("image", "sparse") + (("groundtruth",) if with_gt else ()):
        os.makedirs(root / sub)
    for i in range(n):
        name = f"{i:06d}.png"
        _save_rgb(root / "image" / name, rng)
        d = rng.uniform(2, 60, (H, W))
        _save_u16(root / "sparse" / name, np.where(rng.uniform(size=d.shape) < 0.1, d, 0.0))
        if with_gt:
            _save_u16(root / "groundtruth" / name, d)
    return str(root)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# Depth PNGs and datasets.


def test_save_depth_u16_codes_match(tmp_path):
    """NaN -> 0, negatives -> 0, metres * 256 truncated, clipped at 65535."""
    values = np.array([[np.nan, -1.0, 0.0, 0.001, 0.0039, 0.00391, 1.0, 7.99999],
                       [80.0, 255.99, 255.998, 256.0, 1e6, np.inf, 12.3456, 3.14159]])
    t_save_depth_u16(values, str(tmp_path / "port.png"))
    j_save_depth_u16(values, str(tmp_path / "ref.png"))
    got, want = png.read_png(str(tmp_path / "port.png")), j_load_image(str(tmp_path / "ref.png"))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want.astype(np.uint16))
    np.testing.assert_array_equal(got[0, :4], [0, 0, 0, 0])
    assert got[1, 4] == got[1, 5] == 65535


@pytest.mark.parametrize("layout", [("left", "right", "disp"), ("image_2", "image_3", "disp_occ_0"),
                                    ("left", "right", "disp_occ"), ("left", "right")])
def test_stereo_pair_dataset_batches_match(tmp_path, layout):
    root = _stereo_root(tmp_path, layout)
    t_ds = t_data.StereoPairDataset(root, crop=(32, 48), seed=3)
    j_ds = j_data.StereoPairDataset(root, crop=(32, 48), seed=3)
    assert len(t_ds) == len(j_ds) == 3
    for batch in (2, 3):
        _assert_batches_equal(t_ds.sample_batch(batch), j_ds.sample_batch(batch))


def test_stereo_pair_dataset_needs_both_eyes(tmp_path):
    os.makedirs(tmp_path / "left")
    with pytest.raises(FileNotFoundError):
        t_data.StereoPairDataset(str(tmp_path))


@pytest.mark.parametrize("with_gt", [True, False])
def test_completion_dataset_batches_match(tmp_path, with_gt):
    root = _completion_root(tmp_path, with_gt=with_gt)
    t_ds = t_data.CompletionDataset(root, crop=(24, 64), seed=5)
    j_ds = j_data.CompletionDataset(root, crop=(24, 64), seed=5)
    for batch in (2, 1):
        _assert_batches_equal(t_ds.sample_batch(batch), j_ds.sample_batch(batch))
    np.testing.assert_array_equal(t_ds.intrinsics(24, 64), j_ds.intrinsics(24, 64))
    np.savetxt(tmp_path / "K.txt", np.array([[500.0, 0, 31.5], [0, 500.0, 11.5], [0, 0, 1]]))
    np.testing.assert_array_equal(t_ds.intrinsics(24, 64), j_ds.intrinsics(24, 64))
    with pytest.raises(FileNotFoundError):
        t_data.CompletionDataset(str(tmp_path / "missing"))


def test_jpeg_inputs_raise(tmp_path):
    """A deliberate difference: the port has no JPEG decoder."""
    root = _completion_root(tmp_path, n=1)
    (tmp_path / "image" / "000000.png").rename(tmp_path / "image" / "000000.jpg")
    ds = t_data.CompletionDataset(root, crop=(24, 64))
    with pytest.raises(ValueError, match="JPEG"):
        ds.sample_batch(1)


# --------------------------------------------------------------------------
# The stereo benchmark layer.


@pytest.mark.parametrize("shape", [(H, W), (H, W, 3)])
def test_pfm_round_trip_both_ways(tmp_path, shape):
    data = np.random.default_rng(0).uniform(-5, 100, shape).astype(np.float32)
    t_bd.write_pfm(str(tmp_path / "port.pfm"), data)
    j_bd.write_pfm(str(tmp_path / "ref.pfm"), data)
    assert (tmp_path / "port.pfm").read_bytes() == (tmp_path / "ref.pfm").read_bytes()
    back, scale = t_bd.read_pfm(str(tmp_path / "ref.pfm"))
    np.testing.assert_array_equal(back, data)
    assert scale == 1.0
    # A big-endian file (positive scale) reads the same.
    with open(tmp_path / "be.pfm", "wb") as f:
        f.write((b"PF" if len(shape) == 3 else b"Pf") + f"\n{shape[1]} {shape[0]}\n2.0\n".encode())
        np.flipud(data).astype(">f4").tofile(f)
    for mod in (t_bd, j_bd):
        back, scale = mod.read_pfm(str(tmp_path / "be.pfm"))
        np.testing.assert_array_equal(back, data)
        assert scale == 2.0
    np.testing.assert_array_equal(t_bd.load_disparity(str(tmp_path / "port.pfm")),
                                  j_bd.load_disparity(str(tmp_path / "port.pfm")))
    (tmp_path / "bad.pfm").write_bytes(b"P6\n1 1\n-1\n")
    with pytest.raises(ValueError, match="not a PFM"):
        t_bd.read_pfm(str(tmp_path / "bad.pfm"))


def test_load_disparity_png_matches(tmp_path):
    _save_u16(tmp_path / "d.png", np.random.default_rng(1).uniform(0, 200, (H, W)))
    np.testing.assert_array_equal(t_bd.load_disparity(str(tmp_path / "d.png")),
                                  j_bd.load_disparity(str(tmp_path / "d.png")))


def test_list_files(tmp_path):
    rows = [("a/l.png", "a/r.png", "a/d.pfm"), ("b/l.png", "b/r.png", None)]
    t_bd.write_list_file(str(tmp_path / "port.txt"), rows)
    j_bd.write_list_file(str(tmp_path / "ref.txt"), rows)
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "ref.txt").read_text()
    assert t_bd.read_list_file(str(tmp_path / "port.txt")) == rows
    (tmp_path / "bad.txt").write_text("a b c d\n")
    (tmp_path / "empty.txt").write_text("\n")
    for name in ("bad.txt", "empty.txt"):
        with pytest.raises(ValueError):
            t_bd.read_list_file(str(tmp_path / name))


def _kitti_layout(root, left, right, disp, n=2, seed=2):
    rng = np.random.default_rng(seed)
    for sub in (left, right, disp):
        os.makedirs(root / "training" / sub)
    for i in range(n):
        name = f"{i:06d}_10.png"
        _save_rgb(root / "training" / left / name, rng)
        _save_rgb(root / "training" / right / name, rng)
        if i == 0:  # the second frame has no ground truth
            _save_u16(root / "training" / disp / name, rng.uniform(1, 40, (H, W)))


def _sceneflow_layout(root, n=2, seed=3):
    rng = np.random.default_rng(seed)
    for i in range(n):
        for eye in ("left", "right"):
            d = root / "frames_finalpass" / "TRAIN" / "A" / "0000" / eye
            os.makedirs(d, exist_ok=True)
            _save_rgb(d / f"{i:04d}.png", rng)
        dd = root / "disparity" / "TRAIN" / "A" / "0000" / "left"
        os.makedirs(dd, exist_ok=True)
        disp = rng.uniform(1.0, 40.0, (H, W)).astype(np.float32)
        disp[0, :5] = np.inf  # unknown, as in Middlebury's PFMs
        t_bd.write_pfm(str(dd / f"{i:04d}.pfm"), disp)


def _pair_dirs_layout(root, seed=4):
    rng = np.random.default_rng(seed)
    for scene in ("s1", "s2", "s3"):
        os.makedirs(root / scene)
        if scene == "s3":
            continue  # no im0.png: skipped
        _save_rgb(root / scene / "im0.png", rng)
        _save_rgb(root / scene / "im1.png", rng)
        if scene == "s1":
            t_bd.write_pfm(str(root / scene / "disp0GT.pfm"), rng.uniform(1, 30, (H, W)))


@pytest.mark.parametrize("benchmark", ["kitti2015", "kitti2012", "sceneflow", "middlebury",
                                       "eth3d"])
def test_scanners_and_batches_match(tmp_path, benchmark):
    if benchmark == "kitti2015":
        _kitti_layout(tmp_path, "image_2", "image_3", "disp_occ_0")
    elif benchmark == "kitti2012":
        _kitti_layout(tmp_path, "colored_0", "colored_1", "disp_occ")
    elif benchmark == "sceneflow":
        _sceneflow_layout(tmp_path)
    else:
        _pair_dirs_layout(tmp_path)
    root = str(tmp_path)
    rows = t_bd.SCANNERS[benchmark](root)
    assert rows == j_bd.SCANNERS[benchmark](root) and len(rows) == 2
    assert sorted(t_bd.SCANNERS) == sorted(j_bd.SCANNERS)
    t_ds = t_bd.StereoBenchmarkDataset.from_scan(root, benchmark, crop=(32, 64), seed=7)
    j_ds = j_bd.StereoBenchmarkDataset.from_scan(root, benchmark, crop=(32, 64), seed=7)
    assert t_ds.variant == j_ds.variant
    for _ in range(3):  # the occlusion patch draws on some of these
        _assert_batches_equal(t_ds.sample_batch(2), j_ds.sample_batch(2))
    for i in range(len(rows)):
        got, want = t_ds.eval_batch(i), j_ds.eval_batch(i)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_unaugmented_list_file_dataset_matches(tmp_path):
    _kitti_layout(tmp_path, "image_2", "image_3", "disp_occ_0")
    rows = t_bd.scan_kitti2015(str(tmp_path))
    t_bd.write_list_file(str(tmp_path / "list.txt"), rows)
    kw = dict(augment=False, crop=(32, 48), seed=1)
    t_ds = t_bd.StereoBenchmarkDataset.from_list_file(str(tmp_path), str(tmp_path / "list.txt"),
                                                      **kw)
    j_ds = j_bd.StereoBenchmarkDataset.from_list_file(str(tmp_path), str(tmp_path / "list.txt"),
                                                      **kw)
    _assert_batches_equal(t_ds.sample_batch(3), j_ds.sample_batch(3))
    with pytest.raises(ValueError):
        t_bd.StereoBenchmarkDataset(str(tmp_path), rows, variant="middlebury")


def test_disparity_metrics_match():
    rng = np.random.default_rng(9)
    gt = rng.uniform(0, 250, (H, W)).astype(np.float32)
    pred = gt + rng.normal(scale=4.0, size=gt.shape).astype(np.float32)
    valid = rng.uniform(size=gt.shape) < 0.7
    for max_disp in (192.0, 100.0):
        assert t_bd.disparity_metrics(pred, gt, valid, max_disp) == \
            j_bd.disparity_metrics(pred, gt, valid, max_disp)
    assert t_bd.disparity_metrics(pred, gt, np.zeros_like(valid)) == \
        {"epe": 0.0, "d1": 0.0, "n_valid": 0}


# --------------------------------------------------------------------------
# generate_*: the PNG codes of converted weights.


def _codes(depth_m):
    return np.clip(np.nan_to_num(depth_m) * 256.0, 0, 65535).astype(np.uint16)


def _assert_codes_match(got_dir, want_dir, port_raw, ref_raw):
    """Each package writes the codes of its own float32 depths exactly, and
    the two agree wherever those depths truncate to the same code (they
    differ by the nets' float32 rounding): within one code everywhere."""
    names = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == names == sorted(ref_raw)
    for name in names:
        got = png.read_png(os.path.join(got_dir, name))
        want = png.read_png(os.path.join(want_dir, name))
        np.testing.assert_array_equal(got, _codes(port_raw[name]))
        np.testing.assert_array_equal(want, _codes(ref_raw[name]))
        same = _codes(port_raw[name]) == _codes(ref_raw[name])
        assert same.mean() > 0.9
        assert np.abs(got.astype(np.int64) - want).max() <= 1


def _padded(path, scale):
    """The image as `generate` feeds it to the port's net: padded to a
    multiple of 32, [1, ...] (a tensor's strides pick the CPU convolution's
    algorithm, whose rounding differs)."""
    return t_generate._batch(j_load_image(str(path)) / scale, "cpu")


@pytest.mark.parametrize("variant,ste_conf", [("cfnet", False), ("pcwnet", True)])
def test_generate_stereo_priors_match(tmp_path, variant, ste_conf):
    """`stereo_crop` from cfnet, `ste_conf` from pcwnet at a confidence
    threshold that keeps about half of the pixels."""
    rng = np.random.default_rng(10)
    for eye in ("left", "right"):
        os.makedirs(tmp_path / eye)
        for i in range(2):
            _save_rgb(tmp_path / eye / f"{i:03d}.png", rng)
    kwargs = {k: v for k, v in nets.TINY_STEREO.items() if k != "max_disparity"}
    j_net = j_stereo.StereoNet(variant=variant, **nets.TINY_STEREO)
    variables = nets._variables(j_net, np.zeros((1, 64, 96, 3), np.float32),
                                np.zeros((1, 64, 96, 3), np.float32), seed=11)
    t_net = convert.params_from_flax(jax.device_get(variables),
                                     t_stereo.StereoNet(variant=variant, **nets.TINY_STEREO))
    # Both nets' outputs at the padded size: the threshold, and each
    # package's depths.
    outputs = {}
    for i in range(2):
        name = f"{i:03d}.png"
        left, right = (_padded(tmp_path / eye / name, 255.0) for eye in ("left", "right"))
        ref = nets._apply(j_net, variables, left.numpy(), right.numpy())
        with torch.no_grad():
            port = t_net(left, right)
        outputs[name] = [(np.asarray(out["disparity"])[0, :H, :W],
                          np.asarray(out["confidence"])[0, :H, :W]) for out in (ref, port)]
    focal, baseline = 100.0, 0.5
    threshold = float(np.median(outputs["000.png"][0][1])) if ste_conf else 0.0
    common = dict(focal=focal, baseline=baseline, variant=variant, max_disparity=32,
                  confidence_threshold=threshold, model_kwargs=kwargs, log_fn=lambda s: None)
    j_generate.generate_stereo_priors(variables, str(tmp_path / "left"), str(tmp_path / "right"),
                                      str(tmp_path / "ref"), **common)
    t_generate.generate_stereo_priors(t_net.state_dict(), str(tmp_path / "left"),
                                      str(tmp_path / "right"), str(tmp_path / "port"),
                                      device="cpu", **common)
    ref_raw, port_raw = {}, {}
    for name, pair in outputs.items():
        for raw, (disp, conf) in zip((ref_raw, port_raw), pair):
            depth = np.asarray(j_stereo.disparity_to_depth(disp, focal, baseline))
            raw[name] = np.where(conf >= threshold, depth, 0.0) if ste_conf else depth
    if ste_conf:
        assert 0.3 < np.mean([(r == 0).mean() for r in ref_raw.values()]) < 0.7
    _assert_codes_match(tmp_path / "port", tmp_path / "ref", port_raw, ref_raw)


def test_generate_completion_priors_match(tmp_path):
    """The reference builds its default GuidedCompletionNet (base 32)."""
    root = _completion_root(tmp_path, n=2, with_gt=False)
    j_net = j_completion.GuidedCompletionNet()
    variables = nets._variables(j_net, np.zeros((1, 64, 96, 3), np.float32),
                                np.zeros((1, 64, 96), np.float32), seed=12)
    t_net = convert.params_from_flax(jax.device_get(variables),
                                     t_generate.build_completion_net("guided"))
    args = (os.path.join(root, "image"), os.path.join(root, "sparse"))
    j_generate.generate_completion_priors(variables, *args, str(tmp_path / "ref"),
                                          log_fn=lambda s: None)
    t_generate.generate_completion_priors(t_net.state_dict(), *args, str(tmp_path / "port"),
                                          device="cpu", log_fn=lambda s: None)
    ref_raw, port_raw = {}, {}
    for name in sorted(os.listdir(args[0])):
        rgb = _padded(os.path.join(args[0], name), 255.0)
        sparse = _padded(os.path.join(args[1], name), 256.0)
        ref_raw[name] = np.asarray(nets._apply(j_net, variables, rgb.numpy(),
                                               sparse.numpy()))[0, :H, :W]
        with torch.no_grad():
            port = t_net(rgb, sparse)
        port_raw[name] = port.numpy()[0, :H, :W]
    _assert_codes_match(tmp_path / "port", tmp_path / "ref", port_raw, ref_raw)
    with pytest.raises(ValueError):
        t_generate.build_completion_net("unet")


# --------------------------------------------------------------------------
# The tools, through their command lines.


def test_tools_raise_without_cuda(tmp_path):
    """No device fallback: without --device the tools want CUDA."""
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only path")
    root = _completion_root(tmp_path, n=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train_prior.main(["complete", "--data", root, "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_priors.main(["complete", "--images", os.path.join(root, "image"), "--sparse",
                       os.path.join(root, "sparse"), "--out", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_e2e.main([f"fixture={tmp_path / 'fx'}"])


def test_train_prior_complete_and_priors_cli(tmp_path, capsys):
    root = _completion_root(tmp_path / "data", n=2)
    params = str(tmp_path / "guided.pt")
    model = t_train_prior.main(["complete", "--data", root, "--steps", "2", "--batch", "1",
                                "--crop", "32", "64", "--print-every", "1", "--out", params,
                                "--seed", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 2: loss" in out and f"saved params to {params}" in out
    saved = torch.load(params, weights_only=True)
    assert all(torch.equal(saved[k], v) for k, v in model.state_dict().items())
    images, sparse = os.path.join(root, "image"), os.path.join(root, "sparse")
    t_priors.main(["complete", "--images", images, "--sparse", sparse, "--out",
                   str(tmp_path / "trained"), "--params", params, "--device", "cpu"])
    assert "WARNING" not in capsys.readouterr().out
    t_priors.main(["complete", "--images", images, "--sparse", sparse, "--out",
                   str(tmp_path / "random"), "--arch", "resnet", "--device", "cpu"])
    assert "WARNING: no --params given; using random weights" in capsys.readouterr().out
    for sub in ("trained", "random"):
        assert sorted(os.listdir(tmp_path / sub)) == ["000000.png", "000001.png"]
        assert png.read_png(str(tmp_path / sub / "000000.png")).shape == (H, W)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_train_prior.main(["complete", "--data", root, "--photo", "--device", "cpu"])


def test_train_prior_stereo_with_eval_list_and_priors_cli(tmp_path, capsys):
    _kitti_layout(tmp_path, "image_2", "image_3", "disp_occ_0")
    rows = t_bd.scan_kitti2015(str(tmp_path))
    t_bd.write_list_file(str(tmp_path / "list.txt"), rows)
    params = str(tmp_path / "stereo.pt")
    t_train_prior.main(["stereo", "--data", str(tmp_path), "--list-file",
                        str(tmp_path / "list.txt"), "--eval-list", str(tmp_path / "list.txt"),
                        "--max-disparity", "32", "--steps", "1", "--batch", "1",
                        "--crop", "32", "64", "--print-every", "1", "--out", params,
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 1: loss" in out
    assert f"eval [{tmp_path / 'list.txt'}]: n=1 EPE" in out  # frame 1 has no gt
    t_train_prior.main(["stereo", "--data", str(tmp_path), "--benchmark", "kitti2015",
                        "--split", "training", "--variant", "pcwnet", "--max-disparity", "32",
                        "--steps", "1", "--batch", "1", "--crop", "32", "64",
                        "--device", "cpu"])
    left, right = (str(tmp_path / "training" / eye) for eye in ("image_2", "image_3"))
    t_priors.main(["stereo", "--left", left, "--right", right, "--out", str(tmp_path / "ste"),
                   "--focal", "100", "--baseline", "0.5", "--max-disparity", "32",
                   "--conf-threshold", "0.5", "--params", params, "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "ste")) == ["000000_10.png", "000001_10.png"]


def test_e2e_prior_loop_runs_its_four_stages(tmp_path):
    """At tiny sizes: a 12-view fixture, 2 prior steps, 2 NeRF steps of a
    small mip model per leg; the reference tool's keys plus `device` and
    `prior_seed`."""
    make_kitti_fixture.main(str(tmp_path / "fx"), 12)
    small = {"num_prop_samples": 8, "num_nerf_samples": 4, "num_levels": 3,
             "raydist_fn": "reciprocal", "opaque_background": True, "single_jitter": True,
             "nerf_mlp_params": {"net_depth": 2, "net_width": 16, "bottleneck_width": 8,
                                 "net_width_viewdirs": 8, "max_deg_point": 4},
             "prop_mlp_params": {"net_depth": 2, "net_width": 16, "max_deg_point": 4}}
    out = tmp_path / "e2e.json"
    t_e2e.main(["--device", "cpu", f"out={out}", f"fixture={tmp_path / 'fx'}",
                f"work={tmp_path / 'work'}", "prior_steps=2", "nerf_steps=2", "batch_size=64",
                f"model_params={json.dumps(small)}"])
    result = json.loads(out.read_text())
    with open("E2E_PRIOR_r05.json") as f:
        reference = json.load(f)
    assert sorted(result) == sorted(list(reference) + ["device", "prior_seed"])
    assert result["device"] == "cpu" and result["prior_seed"] == 0
    assert [r["depth_sup_type"] for r in result["nerf_runs"]] == ["mffgen_crop", "rgbonly"]
    for run in result["nerf_runs"]:
        assert sorted(run) == sorted(reference["nerf_runs"][0])
        assert sorted(run["metrics"]) == sorted(reference["nerf_runs"][0]["metrics"])
    scene = tmp_path / "fx" / "dtu_format"
    assert sorted(os.listdir(scene / "depths_mffgen_crop")) == sorted(os.listdir(scene / "images"))
    data = tmp_path / "work" / "completion_data"
    sparse, gt = (png.read_png(str(data / sub / "0000.png")) for sub in ("sparse", "groundtruth"))
    assert np.array_equal(sparse[sparse > 0], gt[sparse > 0])
    assert 0.03 < (sparse > 0).sum() / (gt > 0).sum() < 0.07  # 5% of the returns
    # stages=nerf reuses both legs at the same step count.
    t_e2e.main(["--device", "cpu", f"out={out}", f"fixture={tmp_path / 'fx'}",
                f"work={tmp_path / 'work'}", "stages=nerf", "nerf_steps=2"])
    assert json.loads(out.read_text())["nerf_runs"] == result["nerf_runs"]


def test_e2e_prior_loop_refuses_an_all_zero_prior(tmp_path):
    """A prior that collapsed in training (every pixel 0) has no RMSE and
    would supervise nothing: the NeRF stage raises before training."""
    make_kitti_fixture.main(str(tmp_path / "fx"), 12)
    scene = tmp_path / "fx" / "dtu_format"
    os.makedirs(scene / "depths_mffgen_crop")
    for name in os.listdir(scene / "depths_gt"):
        shape = png.read_png(str(scene / "depths_gt" / name)).shape
        t_save_depth_u16(np.zeros(shape), str(scene / "depths_mffgen_crop" / name))
    assert t_e2e.prior_quality(str(scene)) == {"prior_rmse_m": None, "prior_density": 0.0}
    with pytest.raises(RuntimeError, match="all zero"):
        t_e2e.main(["--device", "cpu", f"out={tmp_path / 'e2e.json'}",
                    f"fixture={tmp_path / 'fx'}", f"work={tmp_path / 'work'}", "stages=nerf"])
    assert not (tmp_path / "work" / "mip_mffgen_crop").exists()
