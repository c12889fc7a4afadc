"""TSDF raycasting for live previews (port of ``bundlefusion_tpu.fusion.raycast``).

Two phases, as in the JAX package:

  phase 1 (splat): scatter-min/max every block's projected depth interval
    into a coarse pixel-tile grid (:func:`splat_intervals`), the compute
    stand-in for the reference's rasterized ray intervals;
  phase 2 (fine): march every ray inside its tile's [near, far] with
    trilinear TSDF samples, detect the +/- zero crossing, and refine it by
    linear interpolation.

The march is ``raycast_max_steps`` iterations of a Python loop over
fixed-shape tensors (masked lanes, no early exit), so it enqueues a fixed
number of launches and reads nothing back on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..config import AppConfig
from ..geometry import se3
from ..geometry.camera import CameraModel, pixel_grid, project
from .blocks import BLOCK, INVALID_KEY, BlockTable, sample_trilinear, unpack_key


@dataclass
class RaycastResult:
    depth: torch.Tensor  # [H, W] float32 (0 = miss)
    normal: torch.Tensor  # [H, W, 3]
    color: torch.Tensor  # [H, W, 3]
    hit: torch.Tensor  # [H, W] bool
    splat_truncated: torch.Tensor  # int32: tile coverage dropped by the splat window cap


def splat_span(cam: CameraModel, cfg: AppConfig, tile: int = 16, cap: int = 8) -> int:
    """Static per-axis tile span of the splat window, from the worst-case
    projected block footprint (bounding sphere at depth_min), capped."""
    rad = 0.5 * BLOCK * cfg.voxel_size * math.sqrt(3.0)
    pr_max = rad * max(cam.fx, cam.fy) / max(cfg.depth_min, 1e-3)
    needed = int(math.ceil(2.0 * pr_max / tile)) + 1
    return max(2, min(needed, cap))


def splat_intervals(
    table: BlockTable, pose_c2w: torch.Tensor, cam: CameraModel, cfg: AppConfig, tile: int = 16
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-tile camera-z bounds [th, tw] (near, far; far == 0 marks an empty
    tile) from every live block's projected bounding sphere, and the count
    of block-tile coverage dropped by the bounded scatter window."""
    dev = pose_c2w.device
    th = -(-cam.height // tile)
    tw = -(-cam.width // tile)
    ext = BLOCK * cfg.voxel_size
    ctr = (unpack_key(table.key_of_slot).to(torch.float32) + 0.5) * ext
    p_cam = se3.transform_points(se3.mat_inverse(pose_c2w), ctr)  # [C, 3]
    z = p_cam[:, 2]
    # the bounding radius and its product with fx rounded to float32 as the
    # JAX package's float32 scalars are, so tile edges land identically
    rad32 = np.float32(0.5 * ext) * np.sqrt(np.float32(3.0))
    rad, rad_fx = float(rad32), float(rad32 * np.float32(cam.fx))
    act = (table.key_of_slot != INVALID_KEY) & (z > rad)
    zs = torch.where(act, z, 1.0)
    uv, _ = project(cam, p_cam)
    pr = rad_fx / zs  # projected radius in pixels (conservative)
    u0 = torch.clamp(((uv[:, 0] - pr) / tile).to(torch.int32), 0, tw - 1)
    u1 = torch.clamp(((uv[:, 0] + pr) / tile).to(torch.int32), 0, tw - 1)
    v0 = torch.clamp(((uv[:, 1] - pr) / tile).to(torch.int32), 0, th - 1)
    v1 = torch.clamp(((uv[:, 1] + pr) / tile).to(torch.int32), 0, th - 1)
    on_screen = (
        act & (uv[:, 0] + pr > 0) & (uv[:, 0] - pr < cam.width) & (uv[:, 1] + pr > 0) & (uv[:, 1] - pr < cam.height)
    )
    # one scratch entry past the grid takes the masked scatters; min and max
    # are exact in any order, so the scatter is deterministic
    near = torch.full((th * tw + 1,), torch.inf, device=dev)
    far = torch.zeros((th * tw + 1,), device=dev)
    max_span = splat_span(cam, cfg, tile)
    sentinel = th * tw
    z_near, z_far = z - rad, z + rad
    for dv in range(max_span):
        for du in range(max_span):
            tu = torch.minimum(u0 + du, u1)
            tv = torch.minimum(v0 + dv, v1)
            flat = torch.where(on_screen & (u0 + du <= u1) & (v0 + dv <= v1), tv * tw + tu, sentinel).long()
            near.scatter_reduce_(0, flat, z_near, "amin")
            far.scatter_reduce_(0, flat, z_far, "amax")
    near = near[:sentinel].reshape(th, tw)
    far = far[:sentinel].reshape(th, tw)
    near = torch.where(torch.isfinite(near), torch.clamp(near, min=cfg.depth_min), 0.0)
    span_u = u1 - u0 + 1
    span_v = v1 - v0 + 1
    dropped = span_u * span_v - torch.clamp(span_u, max=max_span) * torch.clamp(span_v, max=max_span)
    truncated = torch.sum(torch.where(on_screen, dropped, 0)).to(torch.int32)
    return near, far, truncated


def raycast(table: BlockTable, pose_c2w: torch.Tensor, cam: CameraModel, cfg: AppConfig) -> RaycastResult:
    """Raycast the TSDF from the view ``pose_c2w`` [4, 4] (camera-to-world)."""
    h, w = cam.height, cam.width
    dev = pose_c2w.device
    v, u = pixel_grid(h, w, dev)
    dirs_cam = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, torch.ones_like(u)], dim=-1)
    R = pose_c2w[:3, :3]
    origin = pose_c2w[:3, 3]
    dirs = torch.einsum("ij,hwj->hwi", R, dirs_cam)
    inv_norm = 1.0 / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    dirs_n = dirs * inv_norm

    t_min = cfg.depth_min
    block_step = BLOCK * cfg.voxel_size * 0.8

    # phase 1: per-tile ray intervals from the block splat
    tile = 16
    near, far, splat_trunc = splat_intervals(table, pose_c2w, cam, cfg, tile=tile)
    tv = (v / tile).to(torch.int64)
    tu = (u / tile).to(torch.int64)
    near_px = near[tv, tu]  # camera-z bounds per pixel
    far_px = far[tv, tu]
    ray_scale = 1.0 / inv_norm[..., 0]  # unit-ray distance = z * |dirs_cam|
    t = torch.clamp(near_px * ray_scale - block_step, min=t_min)
    t_far = far_px * ray_scale + block_step
    empty = far_px <= 0.0

    # phase 2: fine march with trilinear TSDF samples, find the zero crossing
    fine_step = cfg.truncation * cfg.raycast_step_scale
    prev_sdf = torch.full((h, w), torch.inf, device=dev)
    prev_t = t
    hit_t = torch.zeros((h, w), device=dev)
    hit = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for _ in range(cfg.raycast_max_steps):
        p = (origin + dirs_n * t[..., None]).reshape(-1, 3)
        sdf, _, valid = sample_trilinear(table, p, cfg.voxel_size, with_color=False)
        sdf = sdf.reshape(h, w)
        valid = valid.reshape(h, w) & ~empty & (t <= t_far)
        crossing = valid & torch.isfinite(prev_sdf) & (prev_sdf > 0) & (sdf <= 0) & ~hit
        denom = prev_sdf - sdf
        alpha = torch.where(torch.abs(denom) > 1e-9, prev_sdf / torch.clamp(denom, min=1e-9), 0.0)
        hit_t = torch.where(crossing, prev_t + alpha * (t - prev_t), hit_t)
        hit = hit | crossing
        # far from the surface step by |sdf| (at least a voxel, at most a
        # block), never more than the fine step
        step = torch.clamp(torch.abs(sdf), cfg.voxel_size, block_step)
        step = torch.where(valid, torch.clamp(step, max=fine_step), fine_step)
        prev_sdf = torch.where(valid, sdf, prev_sdf)
        prev_t = torch.where(valid, t, prev_t)
        done = hit | empty | (t > t_far)
        t = torch.where(done, t, t + step)

    # shade: normals from SDF central differences, trilinear colour
    p_hit = origin + dirs_n * hit_t[..., None]
    eps = cfg.voxel_size
    grads = []
    for axis in range(3):
        off = torch.zeros(3, device=dev)
        off[axis] = eps
        s_p, _, _ = sample_trilinear(table, (p_hit + off).reshape(-1, 3), cfg.voxel_size, with_color=False)
        s_m, _, _ = sample_trilinear(table, (p_hit - off).reshape(-1, 3), cfg.voxel_size, with_color=False)
        grads.append((s_p - s_m).reshape(h, w))
    nrm = torch.stack(grads, dim=-1)
    nn = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    normal = torch.where((nn > 1e-9) & torch.isfinite(nn), nrm / torch.clamp(nn, min=1e-9), 0.0)
    _, color, _ = sample_trilinear(table, p_hit.reshape(-1, 3), cfg.voxel_size)
    color = torch.where(hit[..., None], color.reshape(h, w, 3), 0.0)
    # hit_t is distance along the unit ray; camera-z depth = t / |dirs_cam|
    depth = torch.where(hit, hit_t * inv_norm[..., 0], 0.0)
    return RaycastResult(depth=depth, normal=normal, color=color, hit=hit, splat_truncated=splat_trunc)


def shade_preview(result: RaycastResult, light_dir=(0.3, -0.5, 0.8)) -> torch.Tensor:
    """Lambertian shading of a raycast for preview images [H, W, 3]."""
    lx, ly, lz = light_dir
    n = math.sqrt(lx * lx + ly * ly + lz * lz)
    nrm = result.normal
    lam = torch.clamp(torch.abs(nrm[..., 0] * (lx / n) + nrm[..., 1] * (ly / n) + nrm[..., 2] * (lz / n)), 0.15, 1.0)
    img = result.color * lam[..., None]
    return torch.where(result.hit[..., None], img, 0.1)
