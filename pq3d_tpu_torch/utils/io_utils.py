"""Serialization helpers; copy of ``pq3d_tpu/utils/io_utils.py``.

Plain-file IO for evaluators and tools: json, jsonl, pickle and a minimal
ASCII/binary PLY reader-writer for point-cloud dumps (no ``plyfile``
dependency).  ``load_pickle`` unpickles, so give it only files this
program wrote.
"""
from __future__ import annotations

import json
import pickle
import struct
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

import numpy as np


def load_json(path) -> Any:
    with open(path) as f:
        return json.load(f)


def save_json(obj: Any, path, indent: int = 2) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=indent)


def load_jsonl(path) -> List[Any]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def save_jsonl(rows: Iterable[Any], path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def load_pickle(path) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(obj: Any, path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


# ---------------------------------------------------------------------------
# PLY (point clouds with optional uchar colors)
# ---------------------------------------------------------------------------

def save_ply(path, points: np.ndarray, colors: Optional[np.ndarray] = None
             ) -> None:
    """Binary little-endian PLY of xyz (+ rgb uint8)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255 if colors.max() <= 1.0 + 1e-6
                             else colors, 0, 255).astype(np.uint8)
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header.append("end_header")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        for i in range(n):
            f.write(struct.pack("<fff", *points[i]))
            if has_color:
                f.write(struct.pack("<BBB", *colors[i]))


def load_ply(path) -> Dict[str, np.ndarray]:
    """Reads the PLY subset written by save_ply (+ ASCII xyz[rgb])."""
    with open(path, "rb") as f:
        header: List[str] = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = int(next(h.split()[-1] for h in header
                     if h.startswith("element vertex")))
        props = [h.split()[-1] for h in header if h.startswith("property")]
        has_color = "red" in props
        binary = any("binary_little_endian" in h for h in header)
        pts = np.zeros((n, 3), np.float32)
        cols = np.zeros((n, 3), np.uint8) if has_color else None
        if binary:
            rec = struct.Struct("<fff" + ("BBB" if has_color else ""))
            for i in range(n):
                vals = rec.unpack(f.read(rec.size))
                pts[i] = vals[:3]
                if has_color:
                    cols[i] = vals[3:6]
        else:
            for i in range(n):
                vals = f.readline().split()
                pts[i] = [float(v) for v in vals[:3]]
                if has_color:
                    cols[i] = [int(v) for v in vals[3:6]]
    out = {"points": pts}
    if has_color:
        out["colors"] = cols
    return out
