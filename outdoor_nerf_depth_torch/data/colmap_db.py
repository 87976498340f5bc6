"""Minimal COLMAP SQLite database writer (for known-pose reconstruction).

Port of the reference package's `data/colmap_db.py`, with the stdlib
sqlite3 module and numpy: a database COLMAP's feature extractor and matcher
can populate, pre-registering cameras and images (with pose priors) so
`point_triangulator` can triangulate against fixed poses. The standard
COLMAP schema (version 3.8+), only the subset the posed pipeline needs.
"""

from __future__ import annotations

import sqlite3
from typing import Optional

import numpy as np

# COLMAP camera model ids (core enum, stable across versions).
CAMERA_MODELS = {
    "SIMPLE_PINHOLE": 0,
    "PINHOLE": 1,
    "SIMPLE_RADIAL": 2,
    "RADIAL": 3,
    "OPENCV": 4,
    "OPENCV_FISHEYE": 5,
    "FULL_OPENCV": 6,
}

_MAX_IMAGE_ID = 2**31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""


def pair_id(image_id1: int, image_id2: int) -> int:
    """COLMAP's canonical unordered pair key."""
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * _MAX_IMAGE_ID + image_id2


def pair_id_to_image_ids(pid: int):
    image_id2 = pid % _MAX_IMAGE_ID
    return (pid - image_id2) // _MAX_IMAGE_ID, image_id2


class ColmapDatabase:
    """Thin context-managed writer over a COLMAP database file."""

    def __init__(self, path: str):
        self.conn = sqlite3.connect(path)
        self.conn.executescript(_SCHEMA)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def add_camera(
        self,
        model: str,
        width: int,
        height: int,
        params: np.ndarray,
        prior_focal: bool = True,
        camera_id: Optional[int] = None,
    ) -> int:
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (
                camera_id,
                CAMERA_MODELS[model],
                width,
                height,
                np.asarray(params, np.float64).tobytes(),
                int(prior_focal),
            ),
        )
        return cur.lastrowid

    def add_image(
        self,
        name: str,
        camera_id: int,
        qvec: Optional[np.ndarray] = None,
        tvec: Optional[np.ndarray] = None,
        image_id: Optional[int] = None,
    ) -> int:
        q = [None] * 4 if qvec is None else list(np.asarray(qvec, np.float64))
        t = [None] * 3 if tvec is None else list(np.asarray(tvec, np.float64))
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *q, *t),
        )
        return cur.lastrowid

    def read_camera_params(self, camera_id: int) -> np.ndarray:
        row = self.conn.execute(
            "SELECT params FROM cameras WHERE camera_id=?", (camera_id,)
        ).fetchone()
        return np.frombuffer(row[0], np.float64)

    def image_ids_by_name(self):
        return {
            name: image_id
            for image_id, name in self.conn.execute(
                "SELECT image_id, name FROM images"
            )
        }

    def commit(self):
        self.conn.commit()

    def close(self):
        self.conn.commit()
        self.conn.close()
