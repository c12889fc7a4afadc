"""TUM RGB-D dataset reader (port of ``bundlefusion_tpu.io.tum``).

Format: ``rgb.txt`` / ``depth.txt`` / ``groundtruth.txt`` with timestamped
entries; depth PNGs hold depth x 5000. Reading the images needs PIL,
imported only when a sequence is loaded.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from ..geometry.camera import CameraModel

# default intrinsics of TUM freiburg1/2/3 (the dataset's calibration page)
TUM_INTRINSICS = {
    "fr1": (517.3, 516.5, 318.6, 255.3),
    "fr2": (520.9, 521.0, 325.1, 249.7),
    "fr3": (535.4, 539.2, 320.1, 247.6),
}
TUM_DEPTH_SCALE = 5000.0  # depth png value -> meters


class TumSequence(NamedTuple):
    rgb_paths: list[str]
    depth_paths: list[str]
    timestamps: np.ndarray  # [N] float64, of the depth frames
    gt_poses: np.ndarray | None  # [N, 4, 4] float32 c2w, associated to frames
    camera: CameraModel


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading TUM images needs PIL (the Pillow package)") from e
    return Image


def _read_file_list(path: str) -> list[tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def _read_trajectory(path: str) -> list[tuple[float, np.ndarray]]:
    """groundtruth.txt: timestamp tx ty tz qx qy qz qw -> 4x4 c2w."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            t, (tx, ty, tz), (qx, qy, qz, qw) = vals[0], vals[1:4], vals[4:8]
            out.append((t, _quat_to_mat(qx, qy, qz, qw, tx, ty, tz)))
    return out


def _quat_to_mat(qx, qy, qz, qw, tx, ty, tz) -> np.ndarray:
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    T = np.eye(4, dtype=np.float32)
    T[0, 0] = 1 - 2 * (qy * qy + qz * qz)
    T[0, 1] = 2 * (qx * qy - qz * qw)
    T[0, 2] = 2 * (qx * qz + qy * qw)
    T[1, 0] = 2 * (qx * qy + qz * qw)
    T[1, 1] = 1 - 2 * (qx * qx + qz * qz)
    T[1, 2] = 2 * (qy * qz - qx * qw)
    T[2, 0] = 2 * (qx * qz - qy * qw)
    T[2, 1] = 2 * (qy * qz + qx * qw)
    T[2, 2] = 1 - 2 * (qx * qx + qy * qy)
    T[:3, 3] = (tx, ty, tz)
    return T


def _associate(a: list[float], b: list[float], max_dt: float = 0.02) -> list[tuple[int, int]]:
    """Greedy nearest-timestamp association (TUM associate.py semantics).
    ``b`` is scanned in sorted order (stray out-of-order entries happen in
    captures) and matches map back to original indices."""
    order = sorted(range(len(b)), key=lambda j: b[j])
    bs = [b[j] for j in order]
    pairs = []
    bi = 0
    used = set()
    for ai, ta in enumerate(a):
        best, best_dt = -1, max_dt
        while bi > 0 and bs[bi] > ta:
            bi -= 1
        for j in range(bi, len(bs)):
            dt = abs(bs[j] - ta)
            if dt <= best_dt and j not in used:
                best, best_dt = j, dt
            if bs[j] - ta > max_dt:
                break
        if best >= 0:
            pairs.append((ai, order[best]))
            used.add(best)
            bi = best
    return pairs


def load_tum_sequence(root: str) -> TumSequence:
    """Load a TUM sequence directory (rgb.txt/depth.txt[/groundtruth.txt])."""
    depth_list = _read_file_list(os.path.join(root, "depth.txt"))
    rgb_list = _read_file_list(os.path.join(root, "rgb.txt"))
    d_ts = [t for t, _ in depth_list]
    r_ts = [t for t, _ in rgb_list]
    pairs = _associate(d_ts, r_ts)
    depth_paths = [os.path.join(root, depth_list[i][1]) for i, _ in pairs]
    rgb_paths = [os.path.join(root, rgb_list[j][1]) for _, j in pairs]
    timestamps = np.array([d_ts[i] for i, _ in pairs], dtype=np.float64)

    gt_path = os.path.join(root, "groundtruth.txt")
    gt_poses = None
    if os.path.exists(gt_path):
        traj = _read_trajectory(gt_path)
        gpairs = dict(_associate(list(timestamps), [t for t, _ in traj]))
        gt_poses = np.stack(
            [traj[gpairs[i]][1] if i in gpairs else np.full((4, 4), np.nan, np.float32) for i in range(len(timestamps))]
        ).astype(np.float32)

    # published intrinsics are for 640x480; scale them to the on-disk frame
    # size, unless an `intrinsics.txt` ("fx fy cx cy" at that size) overrides
    w, h = 640, 480
    if depth_paths:
        with _pil_image().open(depth_paths[0]) as im:
            w, h = im.size
    intr_path = os.path.join(root, "intrinsics.txt")
    if os.path.exists(intr_path):
        with open(intr_path) as f:
            vals = [float(x) for line in f if line.strip() and not line.startswith("#") for x in line.split()]
        fx, fy, cx, cy = vals[:4]
        cam = CameraModel.create(fx, fy, cx, cy, w, h)
    else:
        key = next((k for k in TUM_INTRINSICS if k in root), "fr1")
        fx, fy, cx, cy = TUM_INTRINSICS[key]
        sx, sy = w / 640.0, h / 480.0
        cam = CameraModel.create(fx * sx, fy * sy, cx * sx, cy * sy, w, h)
    return TumSequence(rgb_paths, depth_paths, timestamps, gt_poses, cam)


def load_frame(seq: TumSequence, idx: int) -> tuple[np.ndarray, np.ndarray]:
    """Decode one (depth [H,W] meters, colour [H,W,3] in [0,1]) frame pair."""
    image = _pil_image()
    depth = np.asarray(image.open(seq.depth_paths[idx]), dtype=np.float32) / TUM_DEPTH_SCALE
    color = np.asarray(image.open(seq.rgb_paths[idx]), dtype=np.float32) / 255.0
    return depth, color[..., :3]
