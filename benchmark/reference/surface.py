"""Points of the surface that a scan ends on: the reference's side of the
judge's coverage number.

A scan's last frames (those the camera ends with, so within the streaming
radius of its last pose) are back-projected at the poses the frames are
fused at (the judge gives the trajectory the program published): a pixel
(u, v) with depth d lies at d ((u - cx) / fx, (v - cy) / fy, 1) in the
camera and at R p + t in the world. A model fused from those frames at
those poses holds weight in the voxel around each such point. Plain NumPy
in float64; imports nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import numpy as np

FRAMES = 20  # the scan's last frames
PIXELS = 256  # pixels drawn from each
MAX_DEPTH = 3.5  # metres: under the streaming radius and the integration distance


def points(depth: np.ndarray, c2w: np.ndarray, intrinsics, rng: np.random.Generator, frames: int = FRAMES,
           pixels: int = PIXELS, max_depth: float = MAX_DEPTH) -> np.ndarray:
    """World points [M, 3] (float64) of ``pixels`` valid pixels (depth in
    (0, ``max_depth``)) drawn with ``rng`` from each of the last ``frames``
    of ``depth`` [N, H, W], back-projected at camera-to-world ``c2w``
    [N, 4, 4]."""
    fx, fy, cx, cy = intrinsics
    n = len(depth)
    out = []
    for f in range(max(0, n - frames), n):
        v, u = np.nonzero((depth[f] > 0) & (depth[f] < max_depth))
        if v.size == 0:
            continue
        pick = rng.choice(v.size, size=min(pixels, v.size), replace=False)
        d = depth[f, v[pick], u[pick]].astype(np.float64)
        cam = np.stack([(u[pick] - cx) / fx * d, (v[pick] - cy) / fy * d, d], axis=-1)
        pose = np.asarray(c2w[f], np.float64)
        out.append(cam @ pose[:3, :3].T + pose[:3, 3])
    return np.concatenate(out) if out else np.zeros((0, 3))
