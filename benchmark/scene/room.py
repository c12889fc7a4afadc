"""The room scene, frozen for the benchmark: floor, two walls, a sphere and a
box with a high-frequency procedural albedo, sphere-traced on the device.

A copy of the port's ``io/synthetic.py`` room (``scene_sdf``,
``scene_albedo``, ``render_frame`` and the camera), kept here so that no
change to the program can change the benchmark's frames or its ground
truth. Other scenes (``office.py``) render their own signed distance with
this renderer and albedo.
"""

from __future__ import annotations

import numpy as np
import torch

def _const(vals, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(vals, dtype=like.dtype, device=like.device)


def scene_sdf(p: torch.Tensor) -> torch.Tensor:
    """Signed distance of the room at world points [..., 3]."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d_floor = y + 1.0
    d_back = 3.5 - z
    d_left = x + 2.5
    d_sphere = torch.linalg.vector_norm(p - _const([0.6, -0.45, 2.2], p), dim=-1) - 0.55
    q = torch.abs(p - _const([-0.9, -0.65, 2.6], p)) - _const([0.45, 0.35, 0.4], p)
    d_box = torch.linalg.vector_norm(torch.clamp(q, min=0.0), dim=-1) + torch.clamp(torch.amax(q, dim=-1), max=0.0)
    return torch.minimum(torch.minimum(torch.minimum(d_floor, d_back), d_left), torch.minimum(d_sphere, d_box))


def scene_albedo(p: torch.Tensor) -> torch.Tensor:
    """Procedural RGB albedo at world points [..., 3] -> [..., 3]."""
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


def _normal(sdf, p: torch.Tensor) -> torch.Tensor:
    eps = 1e-3
    offs = torch.eye(3, dtype=p.dtype, device=p.device) * eps
    n = torch.stack([sdf(p + offs[i]) - sdf(p - offs[i]) for i in range(3)], dim=-1)
    return n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-9)


def intrinsics(width: int, height: int) -> tuple[float, float, float, float]:
    """(fx, fy, cx, cy) of the synthetic camera: 0.9 * width focal length."""
    fx = 0.9 * width
    return fx, fx, (width - 1) / 2.0, (height - 1) / 2.0


def render_frame(pose_c2w: torch.Tensor, width: int, height: int, sdf=scene_sdf, steps: int = 128):
    """Sphere-trace frames of the scene ``sdf`` (``steps`` iterations) at
    camera-to-world poses [..., 4, 4] (float32) -> (depth [..., H, W]
    metres, 0 where invalid; colour [..., H, W, 3])."""
    fx, fy, cx, cy = intrinsics(width, height)
    dev = pose_c2w.device
    v = torch.arange(height, dtype=torch.float32, device=dev)[:, None].expand(height, width)
    u = torch.arange(width, dtype=torch.float32, device=dev)[None, :].expand(height, width)
    dirs_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], dim=-1)
    R = pose_c2w[..., :3, :3]
    origin = pose_c2w[..., None, None, :3, 3]
    dirs = torch.einsum("...ij,hwj->...hwi", R, dirs_cam)
    dir_norm = torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    dirs_n = dirs / dir_norm
    t = torch.full(dirs.shape[:-1], 0.05, dtype=torch.float32, device=dev)
    hit = torch.zeros_like(t, dtype=torch.bool)
    for i in range(steps):
        d = sdf(origin + dirs_n * t[..., None])
        hit = hit | (d < 1e-3)
        t = torch.where(hit, t, t + torch.clamp(d, min=1e-3))
        if i % 8 == 7 and bool(hit.all()):  # every ray has hit: the steps left change nothing
            break
    p = origin + dirs_n * t[..., None]
    z = t / dir_norm[..., 0]  # dirs_cam has z == 1
    valid = hit & (z > 0.1) & (z < 8.0)
    depth = torch.where(valid, z, 0.0)
    light = torch.clamp(-torch.sum(_normal(sdf, p) * dirs_n, dim=-1), 0.2, 1.0)
    color = torch.where(valid[..., None], scene_albedo(p) * light[..., None], 0.0)
    return depth, color


def render(poses: np.ndarray, width: int, height: int, device, batch: int = 8, sdf=scene_sdf, steps: int = 128,
           post=None) -> tuple[np.ndarray, np.ndarray]:
    """Render camera-to-world ``poses`` [N, 4, 4] of the scene ``sdf`` on
    ``device``, ``batch`` frames at a time, into host arrays (depth [N, H,
    W], colour [N, H, W, 3], float32). ``post(depth, colour, first)``, if
    given, degrades each batch on the device before it is copied (frames
    ``first`` on). The batch sets how the batched product rounds the rays:
    at the port's 8 the frames are ``io/synthetic.py``'s bit for bit."""
    n = len(poses)
    depth = np.empty((n, height, width), np.float32)
    color = np.empty((n, height, width, 3), np.float32)
    pt = torch.as_tensor(np.asarray(poses, np.float32), device=device)
    for s in range(0, n, batch):
        d, c = render_frame(pt[s : s + batch], width, height, sdf, steps)
        if post is not None:
            d, c = post(d, c, s)
        depth[s : s + batch] = d.cpu().numpy()
        color[s : s + batch] = c.cpu().numpy()
    return depth, color
