"""COLMAP sqlite database IO (a copy of nerfloc_tpu/data/colmap_db.py):
COLMAP's schema (colmap.github.io/database.html), inserting cameras,
images, keypoints, descriptors and matches, and reading them back. sqlite3
from the standard library.
"""
from __future__ import annotations

import sqlite3
from typing import Optional, Tuple

import numpy as np

MAX_IMAGE_ID = 2 ** 31 - 1

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL, F BLOB, E BLOB, H BLOB,
    qvec BLOB, tvec BLOB);
"""


def image_ids_to_pair_id(id1: int, id2: int) -> int:
    if id1 > id2:
        id1, id2 = id2, id1
    return id1 * MAX_IMAGE_ID + id2


def pair_id_to_image_ids(pair_id: int) -> Tuple[int, int]:
    id2 = pair_id % MAX_IMAGE_ID
    return (pair_id - id2) // MAX_IMAGE_ID, id2


class COLMAPDatabase(sqlite3.Connection):

    @staticmethod
    def connect(path: str) -> "COLMAPDatabase":
        return sqlite3.connect(path, factory=COLMAPDatabase)

    def create_tables(self):
        self.executescript(_SCHEMA)

    def add_camera(self, model: int, width: int, height: int,
                   params: np.ndarray, prior_focal_length: bool = False,
                   camera_id: Optional[int] = None) -> int:
        params = np.asarray(params, np.float64)
        cur = self.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (camera_id, model, width, height, params.tobytes(),
             int(prior_focal_length)))
        return cur.lastrowid

    def add_image(self, name: str, camera_id: int,
                  prior_q=(None,) * 4, prior_t=(None,) * 3,
                  image_id: Optional[int] = None) -> int:
        cur = self.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, camera_id, *prior_q, *prior_t))
        return cur.lastrowid

    def add_keypoints(self, image_id: int, keypoints: np.ndarray):
        keypoints = np.asarray(keypoints, np.float32)
        self.execute("INSERT INTO keypoints VALUES (?, ?, ?, ?)",
                     (image_id,) + keypoints.shape + (keypoints.tobytes(),))

    def add_descriptors(self, image_id: int, descriptors: np.ndarray):
        descriptors = np.ascontiguousarray(descriptors, np.uint8)
        self.execute("INSERT INTO descriptors VALUES (?, ?, ?, ?)",
                     (image_id,) + descriptors.shape
                     + (descriptors.tobytes(),))

    def add_matches(self, id1: int, id2: int, matches: np.ndarray):
        matches = np.asarray(matches, np.uint32)
        if id1 > id2:
            matches = matches[:, ::-1]
        self.execute("INSERT INTO matches VALUES (?, ?, ?, ?)",
                     (image_ids_to_pair_id(id1, id2),) + matches.shape
                     + (matches.tobytes(),))

    def read_keypoints(self, image_id: int) -> Optional[np.ndarray]:
        row = self.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?",
            (image_id,)).fetchone()
        if row is None:
            return None
        r, c, blob = row
        return np.frombuffer(blob, np.float32).reshape(r, c)

    def read_matches(self, id1: int, id2: int) -> Optional[np.ndarray]:
        row = self.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id=?",
            (image_ids_to_pair_id(id1, id2),)).fetchone()
        if row is None:
            return None
        r, c, blob = row
        m = np.frombuffer(blob, np.uint32).reshape(r, c)
        return m[:, ::-1] if id1 > id2 else m
