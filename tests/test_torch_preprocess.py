"""The port's COLMAP preprocessing (`data/colmap_db.py`, `data/preprocess.py`)
against the reference package's, on the CPU: the database rows, the JSON
files and the NeRF++ layout's files equal, the transforms at 1e-6, and the
COLMAP command lines equal (a stand-in `colmap` on PATH records them; with
none on PATH both raise FileNotFoundError)."""

import json
import os
import sqlite3
import stat

import numpy as np
import pytest

from outdoor_nerf_depth_torch.data import colmap_db as t_db
from outdoor_nerf_depth_torch.data import preprocess as t_pre
from outdoor_nerf_depth_tpu.data import colmap as j_colmap
from outdoor_nerf_depth_tpu.data import colmap_db as j_db
from outdoor_nerf_depth_tpu.data import preprocess as j_pre
from tests.test_data import _toy_model

TOL = 1e-6


def _write_model(d):
    cams, images, points = _toy_model()
    os.makedirs(d, exist_ok=True)
    j_colmap.write_cameras_bin(cams, os.path.join(d, "cameras.bin"))
    j_colmap.write_images_bin(images, os.path.join(d, "images.bin"))
    j_colmap.write_points3d_bin(points, os.path.join(d, "points3D.bin"))
    return d


def _rows(path):
    with sqlite3.connect(path) as conn:
        tables = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")]
        return {t: conn.execute(f"SELECT * FROM {t}").fetchall() for t in tables}


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def test_pair_ids_match():
    for a, b in [(1, 2), (2, 1), (7, 7), (2**31 - 2, 3), (0, 5)]:
        assert t_db.pair_id(a, b) == j_db.pair_id(a, b)
        pid = j_db.pair_id(a, b)
        assert t_db.pair_id_to_image_ids(pid) == j_db.pair_id_to_image_ids(pid)
    assert t_db.CAMERA_MODELS == j_db.CAMERA_MODELS


@pytest.mark.parametrize("with_poses", [True, False])
@pytest.mark.parametrize("model", ["PINHOLE", "SIMPLE_PINHOLE"])
def test_posed_database_rows_equal(tmp_path, with_poses, model):
    rng = np.random.default_rng(3)
    names = [f"{i:06d}.png" for i in range(4)]
    K = np.array([[700.0, 0, 320.5], [0, 710.0, 180.25], [0, 0, 1]])
    poses = None
    if with_poses:
        poses = []
        for _ in names:
            q = rng.normal(size=4)
            R = j_colmap.quaternion_to_rotation(q / np.linalg.norm(q) * np.sign(q[0]))
            poses.append(np.concatenate([R, rng.normal(size=(3, 1))], 1))
        poses = np.stack(poses)
    ids = {}
    for name, pre in (("port", t_pre), ("ref", j_pre)):
        ids[name] = pre.build_posed_database(str(tmp_path / f"{name}.db"), names, K, 640, 360,
                                             poses, camera_model=model)
    assert ids["port"] == ids["ref"]
    assert _rows(tmp_path / "port.db") == _rows(tmp_path / "ref.db")
    with t_db.ColmapDatabase(str(tmp_path / "port.db")) as db:
        np.testing.assert_array_equal(db.read_camera_params(1),
                                      j_db.ColmapDatabase(str(tmp_path / "ref.db"))
                                      .read_camera_params(1))
        assert db.image_ids_by_name() == ids["ref"]
    with pytest.raises(ValueError, match="unsupported"):
        t_pre.build_posed_database(str(tmp_path / "x.db"), names, K, 640, 360,
                                   camera_model="OPENCV")


def test_database_writer_rows_equal(tmp_path):
    for name, mod in (("port", t_db), ("ref", j_db)):
        with mod.ColmapDatabase(str(tmp_path / f"{name}.db")) as db:
            cam = db.add_camera("OPENCV", 64, 48, [60.0, 61.0, 32.0, 24.0, 0.1, -0.01, 0, 0],
                                prior_focal=False, camera_id=5)
            db.add_image("a.png", cam, qvec=[1.0, 0, 0, 0], tvec=[0.5, 0, 1], image_id=9)
            db.add_image("b.png", cam)
            db.commit()
    assert _rows(tmp_path / "port.db") == _rows(tmp_path / "ref.db")


def test_extract_sfm_json_equal(tmp_path):
    sparse = _write_model(str(tmp_path / "sparse"))
    n_port = t_pre.extract_sfm_json(sparse, str(tmp_path / "port.json"))
    n_ref = j_pre.extract_sfm_json(sparse, str(tmp_path / "ref.json"))
    assert n_port == n_ref == 3
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()


def test_centers_and_unit_sphere_transform_match(tmp_path):
    _, images, _ = j_colmap.read_model(_write_model(str(tmp_path / "sparse")))
    from outdoor_nerf_depth_torch.data import colmap as t_colmap

    _, t_images, _ = t_colmap.read_model(str(tmp_path / "sparse"))
    got = t_pre.camera_centers_from_model(t_images)
    want = j_pre.camera_centers_from_model(images)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    centers = np.random.default_rng(0).normal(0, 50, (20, 3)) + 100
    (c, s), (jc, js) = t_pre.unit_sphere_transform(centers), j_pre.unit_sphere_transform(centers)
    np.testing.assert_allclose(c, jc, atol=TOL, rtol=0)
    assert s == pytest.approx(js, rel=TOL)
    assert np.linalg.norm((centers - c) / s, axis=-1).max() < 1.0


@pytest.mark.parametrize("normalize,depth_scale", [(True, None), (False, 0.25)])
def test_nerfpp_layout_files_equal(tmp_path, normalize, depth_scale):
    sparse = _write_model(str(tmp_path / "sparse"))
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    (img_dir / "img_001.png").write_bytes(b"not really a png")
    results = {}
    for name, pre in (("port", t_pre), ("ref", j_pre)):
        logs = []
        results[name] = pre.export_nerfpp_layout(
            sparse, str(img_dir), str(tmp_path / name), split="train", normalize=normalize,
            depth_scale=depth_scale, log_fn=logs.append)
        results[name + "_log"] = [line.replace(str(tmp_path / name), "<out>") for line in logs]
    np.testing.assert_allclose(results["port"][0], results["ref"][0], atol=TOL, rtol=0)
    assert results["port"][1] == pytest.approx(results["ref"][1], rel=TOL)
    assert results["port_log"] == results["ref_log"]
    port, ref = _tree(tmp_path / "port"), _tree(tmp_path / "ref")
    assert port == ref
    assert "train/rgb/img_001.png" in port and len([k for k in port if "/pose/" in k]) == 3


def test_frusta_json_equal(tmp_path):
    sparse = _write_model(str(tmp_path / "sparse"))
    for depth in (0.1, 0.5):
        assert t_pre.export_camera_frusta_json(sparse, str(tmp_path / "port.json"), depth) == \
            j_pre.export_camera_frusta_json(sparse, str(tmp_path / "ref.json"), depth) == 3
        assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
        assert len(json.loads((tmp_path / "port.json").read_text())["frusta"][0]["corners"]) == 5


def test_run_colmap_raises_without_the_binary(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    for pre in (t_pre, j_pre):
        with pytest.raises(FileNotFoundError):
            pre.run_colmap(str(tmp_path), str(tmp_path / "w"))
        with pytest.raises(FileNotFoundError):
            pre.run_colmap_posed(str(tmp_path), str(tmp_path / "w"), np.zeros((0, 3, 4)),
                                 np.eye(3), 4, 4)


def _stand_in_colmap(bin_dir, log):
    """A `colmap` that records its arguments and creates nothing."""
    bin_dir.mkdir()
    exe = bin_dir / "colmap"
    exe.write_text(f'#!/bin/sh\necho "$@" >> "{log}"\n')
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)


def test_colmap_command_lines_equal(tmp_path, monkeypatch):
    images = tmp_path / "images"
    images.mkdir()
    for i in range(3):
        (images / f"{i:06d}.png").write_bytes(b"x")
    poses = np.stack([np.concatenate([np.eye(3), [[i], [0.0], [0.0]]], 1) for i in range(3)])
    K = np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])
    outputs = {}
    for name, pre in (("port", t_pre), ("ref", j_pre)):
        log = tmp_path / f"{name}.log"
        _stand_in_colmap(tmp_path / f"bin_{name}", log)
        monkeypatch.setenv("PATH", f"{tmp_path / f'bin_{name}'}:{os.environ['PATH']}")
        ws = tmp_path / name
        printed = []
        sparse = pre.run_colmap(str(images), str(ws / "sfm"), use_gpu=True, log_fn=printed.append)
        posed = pre.run_colmap_posed(str(images), str(ws / "posed"), poses, K, 64, 48,
                                     log_fn=printed.append)
        text = log.read_text().replace(str(ws), "<ws>")
        outputs[name] = (os.path.relpath(sparse, ws), os.path.relpath(posed, ws),
                         [p.replace(str(ws), "<ws>") for p in printed], text,
                         _rows(ws / "posed" / "database.db"), _tree(ws / "posed" / "sparse_prior"))
        monkeypatch.undo()
    assert outputs["port"] == outputs["ref"]
    assert outputs["port"][3].count("\n") == 6  # three calls for each pipeline
