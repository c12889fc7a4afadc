"""Pinhole camera model (port of ``bundlefusion_tpu.geometry.camera``).

Intrinsics are plain Python floats/ints: per-sequence constants that enter
the tensor math as scalars.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CameraModel(NamedTuple):
    """Static pinhole intrinsics."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, width: int, height: int) -> "CameraModel":
        return CameraModel(float(fx), float(fy), float(cx), float(cy), int(width), int(height))

    def scaled(self, new_width: int, new_height: int) -> "CameraModel":
        """Intrinsics for a resampled image."""
        sx = new_width / self.width
        sy = new_height / self.height
        return CameraModel(
            self.fx * sx, self.fy * sy, self.cx * sx, self.cy * sy, new_width, new_height
        )

    def matrix(self, device: torch.device | str = "cuda") -> torch.Tensor:
        """The 3x3 intrinsic matrix K (float32) on ``device``."""
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]], dtype=torch.float32, device=device
        )


def pixel_grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(v, u) float32 pixel-coordinate planes [h, w]."""
    v = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    u = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return v, u


def unproject(cam: CameraModel, depth: torch.Tensor) -> torch.Tensor:
    """Depth image [..., H, W] -> camera-space points [..., H, W, 3].

    Invalid depth (<= 0 or non-finite) yields zero points.
    """
    h, w = depth.shape[-2], depth.shape[-1]
    v, u = pixel_grid(h, w, depth.device)
    z = depth
    x = (u - cam.cx) / cam.fx * z
    y = (v - cam.cy) / cam.fy * z
    pts = torch.stack([x, y, z], dim=-1)
    valid = torch.isfinite(z) & (z > 0.0)
    return torch.where(valid[..., None], pts, 0.0)


def project(cam: CameraModel, points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera-space points [..., 3] -> pixel coords [..., 2] (u, v) and validity."""
    z = points[..., 2]
    valid = z > 1e-6
    zsafe = torch.where(valid, z, 1.0)
    u = points[..., 0] / zsafe * cam.fx + cam.cx
    v = points[..., 1] / zsafe * cam.fy + cam.cy
    uv = torch.stack([u, v], dim=-1)
    inside = (u >= 0.0) & (u <= cam.width - 1.0) & (v >= 0.0) & (v <= cam.height - 1.0)
    return uv, valid & inside
