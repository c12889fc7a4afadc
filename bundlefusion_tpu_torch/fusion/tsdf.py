"""TSDF integration / de-integration over the dense-block pool
(port of ``bundlefusion_tpu.fusion.tsdf``).

Per-frame block allocation along the depth frustum, weighted TSDF + colour
integration with depth-scaled truncation, and exact **de-integration** (the
weighted running mean is reversible: de-integrate == integrate with negated
weight).

The projective update of one row of blocks is kernel K1
(``csrc/tsdf_integrate.cu``), reached through :func:`integrate_blocks`. Its
plain twin :func:`_integrate_blocks_torch` sits beside it and runs for CPU
tensors only. The pools are updated IN PLACE (the JAX package donates them).

The port has no sampling window (the TPU kernel's one-hot MXU window is
gone), so no voxel is ever skipped for lying outside one and every
``patch_overflow`` it reports is 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..config import AppConfig
from ..geometry import se3
from ..geometry.camera import CameraModel, unproject
from .blocks import (
    BLOCK,
    INVALID_KEY,
    BlockTable,
    allocate,
    dedup_keys_counted,
    lookup,
    pack_key,
    unpack_key,
    voxel_centers,
    world_to_block,
)

_INV255 = float(np.float32(1.0 / 255.0))


def truncation_at(depth: torch.Tensor, cfg: AppConfig) -> torch.Tensor:
    """Depth-scaled truncation (``VoxelUtilHashSDF getTruncation``)."""
    return cfg.truncation + cfg.truncation_scale * depth


@dataclass
class FuseDiag:
    """Integration diagnostics; ``upd_mask`` records which rows of a frame's
    update-key list actually updated the table, so a later de-integration
    subtracts exactly what was added."""

    overflow: torch.Tensor  # int32 — block allocations dropped
    upd_truncated: torch.Tensor  # int32 — unique update blocks cut by blocks_per_frame_cap
    patch_overflow: torch.Tensor  # int32 — always 0 in the port (no sampling window)
    upd_mask: torch.Tensor  # [cap] or [B, cap] bool
    upd_keys: torch.Tensor | None = None  # [B, cap] int32 update-key lists


def alloc_stride(cam: CameraModel, cfg: AppConfig) -> int:
    """Pixel stride of the allocation rays (``alloc_stride_auto`` scales it to
    half the block footprint at the farthest integration distance)."""
    stride = max(int(cfg.alloc_stride), 1)
    if getattr(cfg, "alloc_stride_auto", False):
        fp_px = BLOCK * cfg.voxel_size * cam.fx / cfg.max_integration_distance
        stride = max(stride, min(int(fp_px / 2), 8))
    return stride


def frame_alloc_keys(
    depth: torch.Tensor,  # [..., H, W]
    pose_c2w: torch.Tensor,  # [..., 4, 4]
    cam: CameraModel,
    cfg: AppConfig,
    samples_per_ray: int = 3,
) -> torch.Tensor:
    """Packed block keys along each (strided) depth ray's truncation band,
    [..., samples * h * w] (duplicated, fixed size); batched over frames."""
    stride = alloc_stride(cam, cfg)
    d = depth[..., ::stride, ::stride]
    pts_cam = unproject(cam, depth)[..., ::stride, ::stride, :]
    valid = ((d > 0) & (d < cfg.max_integration_distance)).flatten(-2)
    trunc = truncation_at(d, cfg)
    ray = pts_cam / torch.clamp(d[..., None], min=1e-6)
    offs = torch.linspace(-1.0, 1.0, samples_per_ray, dtype=torch.float32, device=depth.device)
    lead = depth.shape[:-2]
    keys = []
    for i in range(samples_per_ray):
        p = pts_cam + ray * (trunc * offs[i])[..., None]
        pw = se3.transform_points(pose_c2w, p.reshape(*lead, -1, 3))
        k = pack_key(world_to_block(pw, cfg.voxel_size))
        keys.append(torch.where(valid, k, INVALID_KEY))
    return torch.cat(keys, dim=-1)


def color_wire(color: torch.Tensor) -> torch.Tensor:
    """Colour image for the integrate kernel: uint8 passes through (the wire
    format); float [0, 1] colour is quantized to uint8 exactly as the TPU
    kernel quantizes it (``pallas_tsdf.color_planes``)."""
    if color.dtype == torch.uint8:
        return color
    return torch.clamp(torch.round(color * 255.0), 0.0, 255.0).to(torch.uint8)


def match_color_res(depth: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
    """Nearest-upsample a reduced-resolution colour image [..., Hc, Wc, 3] to
    the depth resolution (the wire ships colour at half resolution)."""
    fy = depth.shape[-2] // color.shape[-3]
    fx = depth.shape[-1] // color.shape[-2]
    if (fy, fx) == (1, 1):
        return color
    return torch.repeat_interleave(torch.repeat_interleave(color, fy, dim=-3), fx, dim=-2)


def row_params(poses: torch.Tensor, signs: torch.Tensor, cam: CameraModel) -> torch.Tensor:
    """[N, 17] float32 per-row kernel parameters, computed on the device:
    w2c rows (3x4, row-major), fx, fy, cx, cy, sign (the TPU kernel's packing)."""
    n = poses.shape[0]
    w2c = se3.mat_inverse(poses)[:, :3, :4].reshape(n, 12)
    intr = [torch.full((n, 1), v, dtype=torch.float32, device=poses.device) for v in (cam.fx, cam.fy, cam.cx, cam.cy)]
    return torch.cat([w2c, *intr, signs.to(torch.float32).reshape(n, 1)], dim=1).contiguous()


def _integrate_blocks_torch(
    table: BlockTable,
    slots: torch.Tensor,  # [B] int32 data slots (masked rows: anything)
    mask: torch.Tensor,  # [B] bool
    depth: torch.Tensor,  # [H, W] float32
    color8: torch.Tensor,  # [Hc, Wc, 3] uint8 (H/Hc, W/Wc integer)
    params: torch.Tensor,  # [17] float32 (row_params)
    cfg: AppConfig,
) -> None:
    """Plain PyTorch twin of kernel K1 (the XLA ``tsdf._integrate_blocks``
    with a direct gather and no window). Updates the pools in place; masked
    rows write their old values back to the scratch row."""
    cap = table.capacity
    h, w = depth.shape
    slots = torch.where(mask, slots, cap).to(torch.int64)
    coords = unpack_key(table.key_of_slot[torch.clamp(slots, max=cap - 1)])
    ctr = voxel_centers(coords, cfg.voxel_size).reshape(-1, 512, 3)
    wx, wy, wz = ctr[..., 0], ctr[..., 1], ctr[..., 2]
    P = params
    # explicit multiply-adds in the kernel's order (not a matmul)
    px = P[0] * wx + P[1] * wy + P[2] * wz + P[3]
    py = P[4] * wx + P[5] * wy + P[6] * wz + P[7]
    pz = P[8] * wx + P[9] * wy + P[10] * wz + P[11]
    zok = pz > 1e-6
    zsafe = torch.where(zok, pz, 1.0)
    u = px / zsafe * P[12] + P[14]
    v = py / zsafe * P[13] + P[15]
    in_img = zok & (u >= 0.0) & (u <= w - 1.0) & (v >= 0.0) & (v <= h - 1.0)
    ui = torch.clamp(u + 0.5, 0, w - 1).to(torch.int64)
    vi = torch.clamp(v + 0.5, 0, h - 1).to(torch.int64)
    d = depth[vi, ui]
    c = match_color_res(depth, color8)[vi, ui].to(torch.float32) * _INV255  # [B, 512, 3]
    trunc = truncation_at(d, cfg)
    sdf_val = d - pz
    upd_ok = mask[:, None] & in_img & (d > 0) & (d < cfg.max_integration_distance) & (sdf_val > -trunc)
    sdf_new = torch.minimum(torch.maximum(sdf_val, -trunc), trunc)
    dw = torch.where(upd_ok, cfg.integration_weight_sample * P[16], 0.0)

    old_w = table.weight[slots]
    old_sdf = table.sdf[slots]
    old_col = table.color[slots].reshape(-1, 3, 512)
    new_w = old_w + dw
    num = old_sdf * old_w + sdf_new * dw
    upd_sdf = torch.where(new_w > 1e-6, num / torch.clamp(new_w, min=1e-6), 0.0)
    upd_col = old_col + c.transpose(1, 2) * dw[:, None, :]
    new_w = torch.clamp(new_w, 0.0, cfg.max_integration_weight)
    upd_w = torch.where(new_w > 1e-6, new_w, 0.0)
    live = upd_w > 0
    upd_sdf = torch.where(live, upd_sdf, 0.0)
    upd_col = torch.where(live[:, None, :], upd_col, 0.0)
    m = mask[:, None]
    table.sdf[slots] = torch.where(m, upd_sdf, old_sdf)
    table.weight[slots] = torch.where(m, upd_w, old_w)
    table.color[slots] = torch.where(m, upd_col.reshape(-1, 1536), old_col.reshape(-1, 1536))


def integrate_blocks(
    table: BlockTable,
    slots: torch.Tensor,  # [B] int32
    mask: torch.Tensor,  # [B] bool
    depth: torch.Tensor,  # [H, W] float32
    color8: torch.Tensor,  # [Hc, Wc, 3] uint8
    params: torch.Tensor,  # [17] float32 on the device
    cfg: AppConfig,
) -> None:
    """Kernel K1: integrate (sign +1) or exactly de-integrate (sign -1) one
    row of update blocks, in place. CUDA tensors launch the kernel; CPU
    tensors run the plain twin."""
    if not depth.is_cuda:
        _integrate_blocks_torch(table, slots, mask, depth, color8, params, cfg)
        return
    h, w = depth.shape
    hc, wc = color8.shape[0], color8.shape[1]
    if h % hc or w % wc:
        raise ValueError(f"colour {hc}x{wc} must integer-divide depth {h}x{w}")
    b = slots.shape[0]
    rows = table.capacity + 1
    kernels.require(table.sdf, "sdf", torch.float32, (rows, 512))
    kernels.require(table.weight, "weight", torch.float32, (rows, 512))
    kernels.require(table.color, "color", torch.float32, (rows, 1536))
    kernels.require(table.key_of_slot, "key_of_slot", torch.int32)
    kernels.require(slots, "slots", torch.int32, (b,))
    kernels.require(mask, "mask", torch.bool, (b,))
    kernels.require(depth, "depth", torch.float32)
    kernels.require(color8, "color", torch.uint8, (hc, wc, 3))
    kernels.require(params, "params", torch.float32, (17,))
    err = kernels.library().bf_tsdf_integrate(
        table.sdf.data_ptr(), table.weight.data_ptr(), table.color.data_ptr(),
        table.key_of_slot.data_ptr(), slots.data_ptr(), mask.data_ptr(), b,
        depth.data_ptr(), h, w, color8.data_ptr(), hc, wc, params.data_ptr(),
        float(np.float32(cfg.voxel_size)), float(np.float32(BLOCK * cfg.voxel_size)),
        cfg.truncation, cfg.truncation_scale, cfg.max_integration_distance,
        cfg.max_integration_weight, cfg.integration_weight_sample, _INV255,
        kernels.stream_ptr(depth.device),
    )
    kernels.check(err, "tsdf_integrate")
    integrate_blocks.launches += 1


integrate_blocks.launches = 0


def patch_overflow_count(
    upd_keys: torch.Tensor,  # [B] packed block keys
    mask: torch.Tensor,  # [B]
    pose_c2w: torch.Tensor,
    cam: CameraModel,
    cfg: AppConfig,
    window: tuple[int, int],
) -> torch.Tensor:
    """Count update blocks whose projected corner AABB spans at least
    ``window`` (u, v) pixels — the blocks a kernel with that sampling window
    would partly skip. The port's kernel has no window, so its pipeline never
    calls this; it mirrors the JAX counter for comparisons."""
    pu, pv = window
    w2c = se3.mat_inverse(pose_c2w)
    coords = unpack_key(upd_keys)
    ctr = (coords.to(torch.float32) + 0.5) * (BLOCK * cfg.voxel_size)
    offs = torch.tensor(
        [[dx, dy, dz] for dx in (-0.5, 0.5) for dy in (-0.5, 0.5) for dz in (-0.5, 0.5)],
        dtype=torch.float32, device=upd_keys.device,
    ) * (BLOCK * cfg.voxel_size)
    corners = ctr[:, None, :] + offs[None]
    pc = se3.transform_points(w2c, corners.reshape(-1, 3)).reshape(-1, 8, 3)
    z = torch.clamp(pc[..., 2], min=1e-3)
    u = torch.clamp(pc[..., 0] / z * cam.fx + cam.cx, 0, cam.width - 1)
    v = torch.clamp(pc[..., 1] / z * cam.fy + cam.cy, 0, cam.height - 1)
    span_u = torch.amax(u, dim=1) - torch.amin(u, dim=1)
    span_v = torch.amax(v, dim=1) - torch.amin(v, dim=1)
    return torch.sum(mask & ((span_u >= pu) | (span_v >= pv))).to(torch.int32)


def _upd_keys_batch(
    depths: torch.Tensor,  # [N, H, W]
    poses: torch.Tensor,  # [N, 4, 4]
    active: torch.Tensor,  # [N] bool — inactive rows yield all-INVALID lists
    cam: CameraModel,
    cfg: AppConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row deduped update-key lists [N, cap] + per-row dropped-unique
    counts [N]. Each row is a pure function of (depth, pose), so integrate
    and a later de-integrate of a frame touch exactly the same blocks."""
    keys = frame_alloc_keys(depths, poses, cam, cfg)
    keys = torch.where(active[:, None], keys, INVALID_KEY)
    return dedup_keys_counted(keys, cfg.blocks_per_frame_cap)


def _union_counted(upd_keys: torch.Tensor, union_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Union of the per-row key lists, compacted to [union_cap], plus the
    count of unique keys the cap dropped."""
    return dedup_keys_counted(upd_keys.reshape(-1), union_cap)


def _fuse_rows_scan(
    table: BlockTable,
    depths: torch.Tensor,  # [B, H, W] frame storage (rows index into it)
    colors8: torch.Tensor,  # [B, Hc, Wc, 3] uint8
    fidx: list[int],  # [N] frame-storage index per row
    poses: torch.Tensor,  # [N, 4, 4]
    active: torch.Tensor,  # [N] bool
    keys_rows: torch.Tensor,  # [N, cap] per-row update-key lists
    rec_rows: torch.Tensor,  # [N, cap] recorded update masks
    signs: torch.Tensor,  # [N] float32 — +1 integrate / -1 de-integrate
    cam: CameraModel,
    cfg: AppConfig,
) -> tuple[BlockTable, torch.Tensor]:
    """Run K1 over the rows in order (the max-weight clip makes order matter).
    Allocation has already happened, so the index arrays are row-invariant
    and every row's lookup runs as one batched search. Returns (table,
    applied masks [N, cap])."""
    slots, found = lookup(table, keys_rows)
    masks = found & rec_rows & active[:, None]
    params = row_params(poses, signs, cam)
    for i, fi in enumerate(fidx):
        integrate_blocks(table, slots[i], masks[i], depths[fi], colors8[fi], params[i], cfg)
    return table, masks


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def integrate(
    table: BlockTable,
    depth: torch.Tensor,
    color: torch.Tensor,
    pose_c2w: torch.Tensor,
    cam: CameraModel,
    cfg: AppConfig,
) -> tuple[BlockTable, FuseDiag]:
    """Allocate + integrate one frame. Returns (table, FuseDiag)."""
    keys = frame_alloc_keys(depth, pose_c2w, cam, cfg)
    upd_keys, f_trunc = dedup_keys_counted(keys, cfg.blocks_per_frame_cap)
    table, overflow = allocate(table, upd_keys, assume_unique_sorted=True)
    slots, mask = lookup(table, upd_keys)
    params = row_params(pose_c2w[None], torch.ones(1, device=depth.device), cam)[0]
    integrate_blocks(table, slots, mask, depth, color_wire(color), params, cfg)
    return table, FuseDiag(
        overflow=overflow, upd_truncated=f_trunc, patch_overflow=_zero(depth.device), upd_mask=mask
    )


def integrate_batch(
    table: BlockTable,
    depths: torch.Tensor,  # [B, H, W]
    colors: torch.Tensor,  # [B, H, W, 3] (or [B, Hc, Wc, 3] uint8)
    poses: torch.Tensor,  # [B, 4, 4]
    valid: torch.Tensor,  # [B] bool
    cam: CameraModel,
    cfg: AppConfig,
) -> tuple[BlockTable, FuseDiag]:
    """Integrate a frame batch: one allocation merge of the rows' key union,
    then one K1 launch per row."""
    b = depths.shape[0]
    cap = cfg.blocks_per_frame_cap
    dev = depths.device
    upd_keys_all, f_truncs = _upd_keys_batch(depths, poses, valid, cam, cfg)
    union, union_overflow = _union_counted(upd_keys_all, cap * 4)
    table, overflow = allocate(table, union, assume_unique_sorted=True)
    table, upd_masks = _fuse_rows_scan(
        table, depths, color_wire(colors), list(range(b)), poses, valid, upd_keys_all,
        torch.ones((b, cap), dtype=torch.bool, device=dev),
        torch.ones(b, device=dev), cam, cfg,
    )
    return table, FuseDiag(
        overflow=overflow + union_overflow,
        upd_truncated=torch.sum(f_truncs).to(torch.int32),
        patch_overflow=_zero(dev),
        upd_mask=upd_masks,
        upd_keys=upd_keys_all,
    )


def deintegrate_batch(
    table: BlockTable,
    depths: torch.Tensor,
    colors: torch.Tensor,
    poses: torch.Tensor,  # the poses the frames were integrated with
    valid: torch.Tensor,
    cam: CameraModel,
    cfg: AppConfig,
    upd_masks: torch.Tensor | None = None,  # [B, cap] recorded at integrate time
) -> BlockTable:
    """Batched exact removal (one K1 launch per row, sign -1)."""
    b = depths.shape[0]
    dev = depths.device
    if upd_masks is None:
        upd_masks = torch.ones((b, cfg.blocks_per_frame_cap), dtype=torch.bool, device=dev)
    upd_keys_all, _ = _upd_keys_batch(depths, poses, valid, cam, cfg)
    table, _ = _fuse_rows_scan(
        table, depths, color_wire(colors), list(range(b)), poses, valid, upd_keys_all,
        upd_masks, -torch.ones(b, device=dev), cam, cfg,
    )
    return table


def fuse_batch(
    table: BlockTable,
    depths: torch.Tensor,  # [B, H, W]
    colors: torch.Tensor,  # [B, Hc, Wc, 3] uint8 (or float [B, H, W, 3])
    old_poses: torch.Tensor,  # [B, 4, 4] poses the frames were integrated with
    new_poses: torch.Tensor,  # [B, 4, 4] current optimized poses
    deint_mask: torch.Tensor,  # [B] de-integrate at old_poses
    reint_mask: torch.Tensor,  # [B] (re-)integrate at new_poses
    upd_masks_rec: torch.Tensor,  # [B, cap] recorded update masks for the deints
    cam: CameraModel,
    cfg: AppConfig,
    upd_keys_rec: torch.Tensor | None = None,  # [B, cap] recorded update-key lists
    deint_rows: int | None = None,  # only the LAST deint_rows rows may de-integrate
) -> tuple[BlockTable, FuseDiag]:
    """De-integrate + (re-)integrate a frame batch: one allocation merge, then
    K1 over B + deint_rows rows, all de-integrations first. Returns (table,
    FuseDiag) with the [B, cap] re-integration record in ``upd_mask``."""
    b = depths.shape[0]
    dr = b if deint_rows is None else deint_rows
    lo = b - dr
    cap = cfg.blocks_per_frame_cap
    dev = depths.device
    deint_mask = deint_mask & (torch.arange(b, device=dev) >= lo)
    reint_keys, trunc_r = _upd_keys_batch(depths, new_poses, reint_mask, cam, cfg)
    if upd_keys_rec is None:
        deint_keys, _ = _upd_keys_batch(depths[lo:], old_poses[lo:], deint_mask[lo:], cam, cfg)
    else:
        deint_keys = torch.where(deint_mask[lo:, None], upd_keys_rec[lo:], INVALID_KEY)
    keys2 = torch.cat([deint_keys, reint_keys])
    union, union_overflow = _union_counted(reint_keys, cap * 4)
    table, overflow = allocate(table, union, assume_unique_sorted=True)
    act2 = torch.cat([deint_mask[lo:], reint_mask])
    fidx2 = list(range(lo, b)) + list(range(b))
    poses2 = torch.cat([old_poses[lo:], new_poses])
    rec2 = torch.cat([upd_masks_rec[lo:], torch.ones((b, cap), dtype=torch.bool, device=dev)])
    sign2 = torch.cat([-torch.ones(dr, device=dev), torch.ones(b, device=dev)])
    table, masks2 = _fuse_rows_scan(
        table, depths, color_wire(colors), fidx2, poses2, act2, keys2, rec2, sign2, cam, cfg
    )
    return table, FuseDiag(
        overflow=overflow + union_overflow,
        upd_truncated=torch.sum(trunc_r).to(torch.int32),
        patch_overflow=_zero(dev),
        upd_mask=masks2[dr:],
        upd_keys=reint_keys,
    )
