"""Binary PLY mesh writer (port of ``bundlefusion_tpu.io.ply``: the same
bytes for the same arrays)."""

from __future__ import annotations

import numpy as np


def write_ply(
    path: str,
    vertices: np.ndarray,  # [V, 3] float32
    colors: np.ndarray | None = None,  # [V, 3] float in [0,1] or uint8
    faces: np.ndarray | None = None,  # [F, 3] int
) -> None:
    v = np.asarray(vertices, dtype="<f4")
    has_color = colors is not None
    if has_color:
        c = np.asarray(colors)
        if c.dtype != np.uint8:
            c = (np.clip(c, 0.0, 1.0) * 255).astype(np.uint8)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {len(v)}"]
    header += ["property float x", "property float y", "property float z"]
    if has_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    if faces is not None:
        header += [f"element face {len(faces)}", "property list uchar int vertex_indices"]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            rec = np.zeros(len(v), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = v
            rec["rgb"] = c
            f.write(rec.tobytes())
        else:
            f.write(v.tobytes())
        if faces is not None:
            fr = np.zeros(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
            fr["n"] = 3
            fr["idx"] = np.asarray(faces, dtype="<i4")
            f.write(fr.tobytes())
