"""Synthetic RGB-D sequences with exact ground-truth poses
(port of the room scene of ``bundlefusion_tpu.io.synthetic``).

Depth and colour are sphere-traced from an analytic SDF room (floor, two
walls, sphere, box) with a high-frequency procedural albedo, on whatever
device the caller names: on a card, a 640x480 sequence renders in seconds.
The orbit's jitter is numpy with the same seed as the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.camera import CameraModel, pixel_grid


class SyntheticSequence(NamedTuple):
    depth: np.ndarray  # [N, H, W] float32 meters (0 = invalid)
    color: np.ndarray  # [N, H, W, 3] float32 in [0, 1]
    poses: np.ndarray  # [N, 4, 4] float32 camera-to-world
    camera: CameraModel
    timestamps: np.ndarray  # [N] float64 seconds


def _const(vals, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(vals, dtype=like.dtype, device=like.device)


def scene_sdf(p: torch.Tensor) -> torch.Tensor:
    """Analytic signed distance of the test scene at world points [..., 3]."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d_floor = y + 1.0
    d_back = 3.5 - z
    d_left = x + 2.5
    d_sphere = torch.linalg.vector_norm(p - _const([0.6, -0.45, 2.2], p), dim=-1) - 0.55
    q = torch.abs(p - _const([-0.9, -0.65, 2.6], p)) - _const([0.45, 0.35, 0.4], p)
    d_box = torch.linalg.vector_norm(torch.clamp(q, min=0.0), dim=-1) + torch.clamp(
        torch.amax(q, dim=-1), max=0.0
    )
    return torch.minimum(
        torch.minimum(torch.minimum(d_floor, d_back), d_left), torch.minimum(d_sphere, d_box)
    )


def scene_normal(p: torch.Tensor) -> torch.Tensor:
    eps = 1e-3
    offs = torch.eye(3, dtype=p.dtype, device=p.device) * eps
    n = torch.stack([scene_sdf(p + offs[i]) - scene_sdf(p - offs[i]) for i in range(3)], dim=-1)
    return n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-9)


def scene_albedo(p: torch.Tensor) -> torch.Tensor:
    """Procedural high-frequency RGB albedo at world points [..., 3] -> [..., 3]."""
    freqs = _const([[7.1, 3.3, 5.7], [2.9, 8.3, 4.1], [5.3, 2.1, 9.2], [11.3, 6.1, 3.7]], p)
    phases = _const([0.3, 1.7, 2.9, 0.9], p)
    waves = torch.sin(torch.einsum("...i,ki->...k", p, freqs) * 2.3 + phases)
    checker = torch.remainder(
        torch.floor(p[..., 0] * 4.0) + torch.floor(p[..., 1] * 4.0) + torch.floor(p[..., 2] * 4.0), 2.0
    )
    fine = torch.remainder(
        torch.floor(p[..., 0] * 6.0 + 0.35) + torch.floor(p[..., 1] * 6.0) + torch.floor(p[..., 2] * 6.0 + 0.7), 2.0
    )
    r = 0.45 + 0.15 * waves[..., 0] + 0.15 * checker + 0.12 * fine
    g = 0.45 + 0.15 * waves[..., 1] + 0.1 * waves[..., 3] + 0.12 * fine
    b = 0.45 + 0.15 * waves[..., 2] - 0.1 * checker + 0.12 * fine
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def render_frame(pose_c2w: torch.Tensor, width: int, height: int, cam: CameraModel):
    """Sphere-trace frames at poses [..., 4, 4] -> (depth [..., H, W],
    colour [..., H, W, 3])."""
    v, u = pixel_grid(height, width, pose_c2w.device)
    dirs_cam = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, torch.ones_like(u)], dim=-1)
    R = pose_c2w[..., :3, :3]
    origin = pose_c2w[..., None, None, :3, 3]
    dirs = torch.einsum("...ij,hwj->...hwi", R, dirs_cam)
    dir_norm = torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    dirs_n = dirs / dir_norm

    t = torch.full(dirs.shape[:-1], 0.05, dtype=torch.float32, device=pose_c2w.device)
    hit = torch.zeros_like(t, dtype=torch.bool)
    for _ in range(128):
        d = scene_sdf(origin + dirs_n * t[..., None])
        hit = hit | (d < 1e-3)
        t = torch.where(hit, t, t + torch.clamp(d, min=1e-3))
    p = origin + dirs_n * t[..., None]
    # depth = z in the camera frame: dirs_cam has z == 1, so z = t / |dirs_cam|
    z = t / dir_norm[..., 0]
    valid = hit & (z > 0.1) & (z < 8.0)
    depth = torch.where(valid, z, 0.0)
    n = scene_normal(p)
    light = torch.clamp(-torch.sum(n * dirs_n, dim=-1), 0.2, 1.0)
    color = torch.where(valid[..., None], scene_albedo(p) * light[..., None], 0.0)
    return depth, color


def orbit_poses(num_frames: int, radius: float = 0.35, seed: int = 0) -> np.ndarray:
    """Smooth camera trajectory: slow lateral arc + small rotation, looking at
    the scene centre (verbatim numpy of the JAX package, same seed)."""
    rng = np.random.default_rng(seed)
    jitter = rng.normal(scale=0.002, size=(num_frames, 3)).cumsum(axis=0)
    poses = np.zeros((num_frames, 4, 4), dtype=np.float32)
    target = np.array([0.0, -0.4, 2.4])
    for i in range(num_frames):
        ang = (i / max(num_frames - 1, 1) - 0.5) * 0.9
        eye = np.array(
            [radius * np.sin(ang), 0.15 * np.sin(ang * 2.3), -0.3 * np.cos(ang) + 0.3]
        ) + jitter[i] * np.array([1.0, 0.5, 1.0])
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        poses[i, :3, 0] = right
        poses[i, :3, 1] = down
        poses[i, :3, 2] = fwd
        poses[i, :3, 3] = eye
        poses[i, 3, 3] = 1.0
    return poses


def generate_sequence(
    num_frames: int,
    width: int = 64,
    height: int = 48,
    seed: int = 0,
    radius: float = 0.35,
    device: torch.device | str = "cpu",
    batch: int = 8,
) -> SyntheticSequence:
    """Render a full synthetic RGB-D sequence on ``device`` (``batch`` frames
    at a time) and return it as host numpy arrays with ground-truth poses."""
    fx = 0.9 * width
    cam = CameraModel.create(fx, fx, (width - 1) / 2.0, (height - 1) / 2.0, width, height)
    poses = orbit_poses(num_frames, radius=radius, seed=seed)
    pt = torch.as_tensor(poses, device=device)
    depth, color = [], []
    for s in range(0, num_frames, batch):
        d, c = render_frame(pt[s : s + batch], width, height, cam)
        depth.append(d.cpu().numpy())
        color.append(c.cpu().numpy())
    return SyntheticSequence(
        depth=np.concatenate(depth).astype(np.float32),
        color=np.concatenate(color).astype(np.float32),
        poses=poses,
        camera=cam,
        timestamps=np.arange(num_frames, dtype=np.float64) / 30.0,
    )
