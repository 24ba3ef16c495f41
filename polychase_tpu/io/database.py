"""Persistent optical-flow database, schema-compatible with the reference.

Rebuild of the reference's COLMAP-style SQLite store (cpp/database.{h,cc}).
The on-disk format is preserved bit-for-bit so databases written by either
implementation are interchangeable (SURVEY.md §5.4):

- table ``keypoints(image_id INTEGER PRIMARY KEY, rows INTEGER,
  keypoints BLOB)`` — float32 (N, 2) pixel positions
  (cpp/database.cc:108-118);
- table ``optical_flow(image_id_from, image_id_to, rows,
  src_keypoints_indices BLOB, tgt_keypoints BLOB, flow_errors BLOB)`` with a
  composite primary key and a cascade FK to keypoints
  (cpp/database.cc:120-135);
- blobs are raw little-endian memcpy of float32 / uint32 arrays
  (cpp/database.cc:137-158);
- pragmas: synchronous=OFF, WAL journaling, in-memory temp store, FK on,
  auto_vacuum (cpp/database.cc:64-93).

This implementation is numpy-native: keypoints are (N, 2) float32 arrays,
indices (N,) uint32, errors (N,) float32.
"""

from __future__ import annotations

import contextlib
import functools
import sqlite3
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

INVALID_ID = np.iinfo(np.int32).max  # kInvalidId (cpp/database.h:13)


@dataclass
class ImagePairFlow:
    """Flow of keypoints from one image to another (cpp/database.h:22-34)."""

    image_id_from: int = 0
    image_id_to: int = 0
    src_kps_indices: np.ndarray = field(
        default_factory=lambda: np.empty((0,), np.uint32)
    )
    tgt_kps: np.ndarray = field(
        default_factory=lambda: np.empty((0, 2), np.float32)
    )
    flow_errors: np.ndarray = field(
        default_factory=lambda: np.empty((0,), np.float32)
    )

    def clear(self):
        self.src_kps_indices = np.empty((0,), np.uint32)
        self.tgt_kps = np.empty((0, 2), np.float32)
        self.flow_errors = np.empty((0,), np.float32)


_KEYPOINTS_SQL = """
CREATE TABLE IF NOT EXISTS keypoints(
    image_id   INTEGER  PRIMARY KEY  NOT NULL,
    rows       INTEGER               NOT NULL,
    keypoints  BLOB                  NOT NULL
);
"""

_FLOW_SQL = """
CREATE TABLE IF NOT EXISTS optical_flow(
    image_id_from           INTEGER  NOT NULL,
    image_id_to             INTEGER  NOT NULL,
    rows                    INTEGER  NOT NULL,
    src_keypoints_indices   BLOB     NOT NULL,
    tgt_keypoints           BLOB     NOT NULL,
    flow_errors             BLOB     NOT NULL,
    PRIMARY KEY(image_id_from, image_id_to),
    FOREIGN KEY(image_id_from) REFERENCES keypoints(image_id) ON DELETE CASCADE
);
"""


def _locked(fn):
    """Serialize access to the shared sqlite3 connection — the analogue of
    the reference's GuardedDatabase mutex (cpp/opticalflow.cc:39-69)."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper


class Database:
    """Thread-safe wrapper over sqlite3 (one connection per instance, all
    operations serialized by an internal lock like the reference's
    GuardedDatabase, cpp/opticalflow.cc:39-69).

    API mirrors cpp/database.h:36-100 / the pybind surface
    (cpp/polychase_pybind.cc:71-109).
    """

    def __init__(self, path: str):
        self._lock = threading.RLock()
        self._conn: Optional[sqlite3.Connection] = None
        self._defer_depth = 0
        self.open(path)

    # -- lifecycle ----------------------------------------------------------

    @_locked
    def open(self, path: str) -> None:
        self.close()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        cur = self._conn.cursor()
        cur.execute("PRAGMA synchronous=OFF")
        cur.execute("PRAGMA journal_mode=WAL")
        cur.execute("PRAGMA temp_store=MEMORY")
        cur.execute("PRAGMA foreign_keys=ON")
        cur.execute("PRAGMA auto_vacuum=1")
        cur.execute(_KEYPOINTS_SQL)
        cur.execute(_FLOW_SQL)
        self._conn.commit()

    @_locked
    def close(self) -> None:
        if self._conn is not None:
            self._conn.commit()
            self._conn.close()
            self._conn = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _commit(self) -> None:
        if self._defer_depth == 0:
            self._conn.commit()

    @contextlib.contextmanager
    def deferred_commits(self):
        """Batch every write inside the block into ONE sqlite commit.

        The analyze loop writes 1 keypoint row + up to 8 flow rows per
        frame; per-write commits would cost milliseconds per frame of
        host time.  Durability
        granularity becomes the with-block (per frame in the analyze
        loop) — the same resume granularity the reference gets from its
        per-pair transactions, since a torn frame is simply re-analyzed.
        Reentrant; commits once when the outermost block exits.
        """
        with self._lock:
            self._defer_depth += 1
        try:
            yield self
        finally:
            with self._lock:
                self._defer_depth -= 1
                if self._defer_depth == 0 and self._conn is not None:
                    self._conn.commit()

    # -- keypoints ----------------------------------------------------------

    @_locked
    def write_keypoints(self, image_id: int, keypoints: np.ndarray) -> None:
        kps = np.ascontiguousarray(keypoints, np.float32).reshape(-1, 2)
        self._conn.execute(
            "INSERT OR REPLACE INTO keypoints(image_id, rows, keypoints)"
            " VALUES(?, ?, ?)",
            (int(image_id), kps.shape[0], kps.tobytes()),
        )
        self._commit()

    @_locked
    def read_keypoints(self, image_id: int) -> np.ndarray:
        row = self._conn.execute(
            "SELECT rows, keypoints FROM keypoints WHERE image_id = ?",
            (int(image_id),),
        ).fetchone()
        if row is None:
            return np.empty((0, 2), np.float32)
        n, blob = row
        kps = np.frombuffer(blob, np.float32)
        if kps.size != 2 * n:
            raise ValueError(
                f"keypoints blob size mismatch for image {image_id}"
            )
        return kps.reshape(n, 2).copy()

    @_locked
    def keypoints_exist(self, image_id: int) -> bool:
        row = self._conn.execute(
            "SELECT 1 FROM keypoints WHERE image_id = ? LIMIT 1",
            (int(image_id),),
        ).fetchone()
        return row is not None

    @_locked
    def get_min_image_id_with_keypoints(self) -> int:
        row = self._conn.execute("SELECT MIN(image_id) FROM keypoints").fetchone()
        return INVALID_ID if row is None or row[0] is None else int(row[0])

    @_locked
    def get_max_image_id_with_keypoints(self) -> int:
        row = self._conn.execute("SELECT MAX(image_id) FROM keypoints").fetchone()
        return INVALID_ID if row is None or row[0] is None else int(row[0])

    # -- pair flows ---------------------------------------------------------

    @_locked
    def write_image_pair_flow(
        self,
        image_id_from,
        image_id_to: int = None,
        src_kps_indices: np.ndarray = None,
        tgt_kps: np.ndarray = None,
        flow_errors: np.ndarray = None,
    ) -> None:
        if isinstance(image_id_from, ImagePairFlow):
            f = image_id_from
            return self.write_image_pair_flow(
                f.image_id_from, f.image_id_to, f.src_kps_indices, f.tgt_kps,
                f.flow_errors,
            )
        idx = np.ascontiguousarray(src_kps_indices, np.uint32).reshape(-1)
        tgt = np.ascontiguousarray(tgt_kps, np.float32).reshape(-1, 2)
        err = np.ascontiguousarray(flow_errors, np.float32).reshape(-1)
        if not (idx.shape[0] == tgt.shape[0] == err.shape[0]):
            raise ValueError("flow component length mismatch")
        self._conn.execute(
            "INSERT OR REPLACE INTO optical_flow(image_id_from, image_id_to,"
            " rows, src_keypoints_indices, tgt_keypoints, flow_errors)"
            " VALUES(?, ?, ?, ?, ?, ?)",
            (
                int(image_id_from), int(image_id_to), idx.shape[0],
                idx.tobytes(), tgt.tobytes(), err.tobytes(),
            ),
        )
        self._commit()

    @_locked
    def read_image_pair_flow(
        self, image_id_from: int, image_id_to: int
    ) -> ImagePairFlow:
        flow = ImagePairFlow(int(image_id_from), int(image_id_to))
        row = self._conn.execute(
            "SELECT rows, src_keypoints_indices, tgt_keypoints, flow_errors"
            " FROM optical_flow WHERE image_id_from = ? AND image_id_to = ?",
            (int(image_id_from), int(image_id_to)),
        ).fetchone()
        if row is None:
            return flow
        n, idx_b, tgt_b, err_b = row
        flow.src_kps_indices = np.frombuffer(idx_b, np.uint32).copy()
        flow.tgt_kps = np.frombuffer(tgt_b, np.float32).reshape(n, 2).copy()
        flow.flow_errors = np.frombuffer(err_b, np.float32).copy()
        if flow.src_kps_indices.size != n or flow.flow_errors.size != n:
            raise ValueError("flow blob size mismatch")
        return flow

    @_locked
    def read_flows_to_image_range(self, lo: int, hi: int) -> dict:
        """All flows whose target frame lies in [lo, hi], in ONE query.

        Extension over the reference surface (cpp/database.h only offers
        per-pair reads): the tracking scan chain reads every flow of the
        run up front, and ~17 point queries per frame dominate its host
        DB cost.  Returns ``{target_id: [ImagePairFlow, ...]}``; arrays
        are READ-ONLY views over the sqlite blobs (no copies).
        """
        rows = self._conn.execute(
            "SELECT image_id_from, image_id_to, rows,"
            " src_keypoints_indices, tgt_keypoints, flow_errors"
            " FROM optical_flow WHERE image_id_to BETWEEN ? AND ?"
            " ORDER BY image_id_to, image_id_from",
            (int(lo), int(hi)),
        ).fetchall()
        out: dict = {}
        for f, t, n, idx_b, tgt_b, err_b in rows:
            flow = ImagePairFlow(int(f), int(t))
            flow.src_kps_indices = np.frombuffer(idx_b, np.uint32)
            flow.tgt_kps = np.frombuffer(tgt_b, np.float32).reshape(n, 2)
            flow.flow_errors = np.frombuffer(err_b, np.float32)
            if flow.src_kps_indices.size != n or flow.flow_errors.size != n:
                raise ValueError("flow blob size mismatch")
            out.setdefault(int(t), []).append(flow)
        return out

    @_locked
    def read_keypoints_range(self, lo: int, hi: int) -> dict:
        """Keypoints for every image in [lo, hi], in ONE query.

        Extension (see read_flows_to_image_range).  Returns
        ``{image_id: (N, 2) float32}``; arrays are READ-ONLY views.
        """
        rows = self._conn.execute(
            "SELECT image_id, rows, keypoints FROM keypoints"
            " WHERE image_id BETWEEN ? AND ?",
            (int(lo), int(hi)),
        ).fetchall()
        out = {}
        for image_id, n, blob in rows:
            kps = np.frombuffer(blob, np.float32)
            if kps.size != 2 * n:
                raise ValueError(
                    f"keypoints blob size mismatch for image {image_id}"
                )
            out[int(image_id)] = kps.reshape(n, 2)
        return out

    @_locked
    def image_pair_flow_exists(
        self, image_id_from: int, image_id_to: int
    ) -> bool:
        row = self._conn.execute(
            "SELECT 1 FROM optical_flow WHERE image_id_from = ?"
            " AND image_id_to = ? LIMIT 1",
            (int(image_id_from), int(image_id_to)),
        ).fetchone()
        return row is not None

    @_locked
    def find_optical_flows_from_image(self, image_id_from: int) -> list:
        rows = self._conn.execute(
            "SELECT image_id_to FROM optical_flow WHERE image_id_from = ?",
            (int(image_id_from),),
        ).fetchall()
        return [r[0] for r in rows]

    @_locked
    def find_optical_flows_to_image(self, image_id_to: int) -> list:
        rows = self._conn.execute(
            "SELECT image_id_from FROM optical_flow WHERE image_id_to = ?",
            (int(image_id_to),),
        ).fetchall()
        return [r[0] for r in rows]
