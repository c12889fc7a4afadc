"""Synthetic RGB-D sequences with exact ground-truth poses
(port of ``bundlefusion_tpu.io.synthetic``).

Depth and colour are sphere-traced from analytic SDF scenes with a
high-frequency procedural albedo, on the device the caller names (the card
by default): the room (floor, two walls, sphere, box) seen from an orbit,
and the multi-room corridor walked along +x, which outgrows a small block
pool (out-of-core streaming). Camera paths and the sensor-noise model are
numpy with the same seeds as the JAX package.
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


def corridor_sdf(p: torch.Tensor) -> torch.Tensor:
    """Multi-room scene: a corridor along +x with room dividers every 3 m
    (a doorway for z in [0.4, 2.0], which the camera path at z = 1.2 passes)
    and one furniture sphere per room."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d_floor = y + 1.0
    d_ceil = 1.5 - y
    d_back = 3.0 - z  # far corridor wall
    d_front = z + 1.0  # near corridor wall (behind the camera path)
    xm = torch.remainder(x, 3.0) - 1.5  # distance to the nearest divider plane
    in_doorway = torch.abs(z - 1.2) <= 0.8
    d_div = torch.where(in_doorway, torch.inf, torch.abs(xm) - 0.08)
    room = torch.floor((x + 1.5) / 3.0)
    sph_c = torch.stack([room * 3.0 + 0.8, torch.full_like(room, -0.55), 1.9 + 0.4 * torch.cos(room * 2.1)], dim=-1)
    d_sph = torch.linalg.vector_norm(p - sph_c, dim=-1) - 0.45
    d = torch.minimum(torch.minimum(d_floor, d_ceil), torch.minimum(d_back, d_front))
    return torch.minimum(torch.minimum(d, d_div), d_sph)


def _normal(sdf, p: torch.Tensor) -> torch.Tensor:
    eps = 1e-3
    offs = torch.eye(3, dtype=p.dtype, device=p.device) * eps
    n = torch.stack([sdf(p + offs[i]) - sdf(p - offs[i]) for i in range(3)], dim=-1)
    return n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-9)


def scene_normal(p: torch.Tensor) -> torch.Tensor:
    """Unit normals [..., 3] of the room scene at points ``p`` [..., 3]
    (central differences of :func:`scene_sdf`)."""
    return _normal(scene_sdf, p)


def render_frame(pose_c2w: torch.Tensor, width: int, height: int, cam: CameraModel, sdf=scene_sdf,
                 steps: int = 128):
    """Sphere-trace frames of the scene ``sdf`` (``steps`` iterations) at
    poses [..., 4, 4] -> (depth [..., H, W], colour [..., H, W, 3])."""
    v, u = pixel_grid(height, width, pose_c2w.device)
    dirs_cam = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, torch.ones_like(u)], dim=-1)
    R = pose_c2w[..., :3, :3]
    origin = pose_c2w[..., None, None, :3, 3]
    dirs = torch.einsum("...ij,hwj->...hwi", R, dirs_cam)
    dir_norm = torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    dirs_n = dirs / dir_norm

    t = torch.full(dirs.shape[:-1], 0.05, dtype=torch.float32, device=pose_c2w.device)
    hit = torch.zeros_like(t, dtype=torch.bool)
    for _ in range(steps):
        d = sdf(origin + dirs_n * t[..., None])
        hit = hit | (d < 1e-3)
        t = torch.where(hit, t, t + torch.clamp(d, min=1e-3))
    p = origin + dirs_n * t[..., None]
    # depth = z in the camera frame: dirs_cam has z == 1, so z = t / |dirs_cam|
    z = t / dir_norm[..., 0]
    valid = hit & (z > 0.1) & (z < 8.0)
    depth = torch.where(valid, z, 0.0)
    n = _normal(sdf, p)
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


def _camera(width: int, height: int) -> CameraModel:
    fx = 0.9 * width
    return CameraModel.create(fx, fx, (width - 1) / 2.0, (height - 1) / 2.0, width, height)


def render_sequence(poses: np.ndarray, cam: CameraModel, device: torch.device | str = "cuda", sdf=scene_sdf,
                    steps: int = 128, batch: int = 8) -> SyntheticSequence:
    """Render the scene ``sdf`` at camera-to-world ``poses`` [N, 4, 4] on
    ``device``, ``batch`` frames at a time, into host numpy arrays."""
    pt = torch.as_tensor(np.asarray(poses, np.float32), device=device)
    depth, color = [], []
    for s in range(0, len(poses), batch):
        d, c = render_frame(pt[s : s + batch], cam.width, cam.height, cam, sdf, steps)
        depth.append(d.cpu().numpy())
        color.append(c.cpu().numpy())
    return SyntheticSequence(
        depth=np.concatenate(depth).astype(np.float32),
        color=np.concatenate(color).astype(np.float32),
        poses=np.asarray(poses, np.float32),
        camera=cam,
        timestamps=np.arange(len(poses), dtype=np.float64) / 30.0,
    )


def generate_sequence(
    num_frames: int,
    width: int = 64,
    height: int = 48,
    seed: int = 0,
    radius: float = 0.35,
    device: torch.device | str = "cuda",
    batch: int = 8,
) -> SyntheticSequence:
    """Render the room orbit on ``device`` and return it as host numpy
    arrays with ground-truth poses."""
    return render_sequence(orbit_poses(num_frames, radius=radius, seed=seed), _camera(width, height), device,
                           batch=batch)


def corridor_path_poses(num_frames: int, x_span: float = 9.0, seed: int = 0) -> np.ndarray:
    """Camera walks down the corridor (translating +x), looking at the far
    wall, with gentle handheld jitter (verbatim numpy of the JAX package)."""
    rng = np.random.default_rng(seed)
    jitter = rng.normal(scale=0.0015, size=(num_frames, 3)).cumsum(axis=0)
    poses = np.zeros((num_frames, 4, 4), dtype=np.float32)
    for i in range(num_frames):
        s = i / max(num_frames - 1, 1)
        eye = np.array([s * x_span, 0.0, 1.2]) + jitter[i]
        target = np.array([s * x_span + 0.5, -0.3, 2.7])
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


def generate_corridor_sequence(
    num_frames: int,
    width: int = 64,
    height: int = 48,
    x_span: float = 9.0,
    seed: int = 0,
    out_and_back: bool = False,
    device: torch.device | str = "cuda",
    batch: int = 8,
) -> SyntheticSequence:
    """The corridor walk rendered on ``device``. With ``out_and_back`` the
    camera walks to x_span and retraces its path."""
    if out_and_back:
        p_out = corridor_path_poses(num_frames // 2 + 1, x_span=x_span, seed=seed)
        poses = np.concatenate([p_out, p_out[-2::-1]])[:num_frames]
    else:
        poses = corridor_path_poses(num_frames, x_span=x_span, seed=seed)
    return render_sequence(poses, _camera(width, height), device, sdf=corridor_sdf, steps=160, batch=batch)


def apply_sensor_noise(
    seq: SyntheticSequence,
    seed: int = 0,
    axial: bool = True,
    lateral: bool = True,
    quantize: bool = True,
    edge_dropout: bool = True,
    exposure_drift: bool = True,
) -> SyntheticSequence:
    """Degrade a clean sequence with Kinect-v1-style sensor statistics
    (numpy, seeded; the JAX package's model verbatim):

      * axial noise     sigma_z(z) = 1.2 mm + 1.9 mm * (z - 0.4)^2
      * lateral noise   ~0.8 px jitter, by resampling depth at randomly
                        offset pixel coordinates
      * quantization    disparity rounding z -> 1 / (round(K/z) / K), K = 360
      * edge dropout    pixels with local depth contrast over 10 cm, plus
                        0.5% speckle, become invalid
      * exposure drift  slow per-frame global gain in [0.9, 1.1]
    """
    rng = np.random.default_rng(seed)
    depth = seq.depth.copy()
    color = seq.color.copy()
    n, h, w = depth.shape
    if lateral:
        du = rng.normal(scale=0.8, size=(n, h, w))
        dv = rng.normal(scale=0.8, size=(n, h, w))
        uu = np.clip(np.arange(w)[None, None, :] + du, 0, w - 1).astype(np.int32)
        vv = np.clip(np.arange(h)[None, :, None] + dv, 0, h - 1).astype(np.int32)
        depth = np.take_along_axis(depth.reshape(n, -1), (vv * w + uu).reshape(n, -1), axis=1).reshape(n, h, w)
    if axial:
        sigma = 0.0012 + 0.0019 * np.square(np.maximum(depth - 0.4, 0.0))
        depth = np.where(depth > 0, depth + rng.normal(size=depth.shape) * sigma, 0.0)
    if quantize:
        K = 360.0
        dq = np.round(K / np.maximum(depth, 1e-3))
        depth = np.where(depth > 0, K / np.maximum(dq, 1.0), 0.0)
    if edge_dropout:
        gx = np.abs(np.diff(depth, axis=2, prepend=depth[:, :, :1]))
        gy = np.abs(np.diff(depth, axis=1, prepend=depth[:, :1, :]))
        edge = (gx > 0.1) | (gy > 0.1)
        speckle = rng.random(depth.shape) < 0.005
        depth = np.where(edge | speckle, 0.0, depth)
    if exposure_drift:
        gain = 1.0 + 0.1 * np.sin(np.arange(n) * 0.21 + 0.5)
        color = np.clip(color * gain[:, None, None, None], 0.0, 1.0)
    return seq._replace(depth=depth.astype(np.float32), color=color.astype(np.float32))
