"""TSDF integration / de-integration over the dense-block pool
(port of ``bundlefusion_tpu.fusion.tsdf``).

Per-frame block allocation along the depth frustum, weighted TSDF + colour
integration with depth-scaled truncation, and exact **de-integration** (the
weighted running mean is reversible: de-integrate == integrate with negated
weight).

The projective update of a batch's update rows (de-integrations first,
then integrations, each row one frame's block list) is kernel K1
(``csrc/tsdf_integrate.cu``), ONE launch for all rows, reached through
:func:`integrate_blocks`. Its plain twin :func:`_integrate_rows_torch` (the
single-row update :func:`_integrate_blocks_torch` applied row by row) sits
beside it and runs for CPU tensors only. The pools are updated IN PLACE (the
JAX package donates them).

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
from ..geometry.camera import CameraModel, project, unproject
from ..utils.tensor_ops import top_k
from .blocks import (
    BLOCK,
    INVALID_KEY,
    BlockTable,
    allocate,
    dedup_keys,
    dedup_keys_counted,
    lookup,
    lower_bound,
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


def visible_blocks(
    table: BlockTable, pose_c2w: torch.Tensor, cam: CameraModel, cfg: AppConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """The compacted visible-block set (``compactifyVisibleBlocks``): (slots
    [cap] int32, mask [cap]) with cap = ``cfg.blocks_per_frame_cap``, the
    allocated blocks whose centre lies in the frustum inflated by a block's
    projected size, nearest first."""
    coords = unpack_key(table.key_of_slot)
    ctr = (coords.to(torch.float32) + 0.5) * (BLOCK * cfg.voxel_size)
    p_cam = se3.transform_points(se3.mat_inverse(pose_c2w), ctr)
    uv, _ = project(cam, p_cam)
    z = p_cam[..., 2]
    margin = BLOCK * cfg.voxel_size * cam.fx / torch.clamp(z, min=1e-3)
    u, v = uv[..., 0], uv[..., 1]
    near = (
        (z > 0.05) & (z < cfg.max_integration_distance + 1.0)
        & (u > -margin) & (u < cam.width + margin) & (v > -margin) & (v < cam.height + margin)
        & (table.key_of_slot != INVALID_KEY)
    )
    top, slots = top_k(torch.where(near, -z, -torch.inf), cfg.blocks_per_frame_cap)
    return slots.to(torch.int32), torch.isfinite(top)


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


@dataclass
class FuseRows:
    """The update rows of one K1 launch, applied in order. Row r updates the
    applied entries of its block list with frame ``fidx[r]`` at
    ``params[r]`` (sign +1 integrates, -1 de-integrates)."""

    keys: torch.Tensor  # [R, cap] int32 per-row update-key lists
    slots: torch.Tensor  # [R, cap] int32 data slots of the keys
    masks: torch.Tensor  # [R, cap] bool applied entries
    fidx: torch.Tensor  # [R] int64 frame-storage index per row
    params: torch.Tensor  # [R, 17] float32 (row_params)

    def inverse(self) -> "FuseRows":
        """The rows that undo these: reversed order, negated signs (exact in
        the weights while no voxel reaches the weight cap)."""
        params = self.params.flip(0)
        params[:, 16] = -params[:, 16]
        return FuseRows(self.keys.flip(0), self.slots.flip(0), self.masks.flip(0), self.fidx.flip(0), params)


def _integrate_rows_torch(
    table: BlockTable, rows: FuseRows, depths: torch.Tensor, colors8: torch.Tensor, cfg: AppConfig
) -> None:
    """Plain twin of K1: the single-row update applied row by row."""
    for r in range(rows.fidx.shape[0]):
        f = rows.fidx[r]
        _integrate_blocks_torch(
            table, rows.slots[r], rows.masks[r], depths[f], colors8[f], rows.params[r], cfg
        )


def fuse_worklist(rows: FuseRows, capacity: int) -> torch.Tensor:
    """K1's work list, built on the device with a fixed size and no host
    read: the sorted union of the rows' applied keys, INVALID_KEY-padded to
    min(R * cap, capacity) entries (applied keys are table entries, so that
    always holds the union). The kernel finds an entry's position in row r
    by a binary search of the row's sorted key list; the row applies the
    entry where the key is there and its mask is set."""
    r, cap = rows.keys.shape
    applied_keys = torch.where(rows.masks, rows.keys, INVALID_KEY)
    return dedup_keys(applied_keys.reshape(-1), min(r * cap, capacity))


def _log2_ratio(n: int, m: int, what: str) -> int:
    shift = (n // m).bit_length() - 1
    if m << shift != n:
        raise ValueError(f"{what}: colour {m} must divide depth {n} by a power of two")
    return shift


@kernels.counted
def integrate_blocks(
    table: BlockTable,
    rows: FuseRows,
    depths: torch.Tensor,  # [B, H, W] float32 frame storage (rows index into it)
    colors8: torch.Tensor,  # [B, Hc, Wc, 3] uint8
    cfg: AppConfig,
) -> None:
    """Kernel K1: integrate (sign +1) or exactly de-integrate (sign -1) every
    row of ``rows`` in order, in place, in ONE launch. Each row's key list
    is sorted ascending (INVALID_KEY last), as dedup_keys leaves it. CUDA
    tensors launch the kernel; CPU tensors run the plain twin."""
    if not depths.is_cuda:
        _integrate_rows_torch(table, rows, depths, colors8, cfg)
        return
    r, cap = rows.keys.shape
    nrows = table.capacity + 1
    kernels.require(table.sdf, "sdf", torch.float32, (nrows, 512))
    kernels.require(table.weight, "weight", torch.float32, (nrows, 512))
    kernels.require(table.color, "color", torch.float32, (nrows, 1536))
    for t, name, dtype in ((rows.keys, "keys", torch.int32), (rows.slots, "slots", torch.int32),
                           (rows.masks, "masks", torch.bool)):
        kernels.require(t, name, dtype, (r, cap), contiguous=False)
        if t.stride(1) != 1:
            raise ValueError(f"{name}: each row must be contiguous")
    kernels.require(rows.fidx, "fidx", torch.int64, (r,))
    kernels.require(rows.params, "params", torch.float32, (r, 17))
    kernels.require(depths, "depths", torch.float32)
    kernels.require(colors8, "colors", torch.uint8)
    if depths.dim() != 3 or colors8.dim() != 4 or colors8.shape[0] != depths.shape[0] or colors8.shape[3] != 3:
        raise ValueError(f"expected depths [B, H, W] and colours [B, Hc, Wc, 3], got "
                         f"{tuple(depths.shape)} and {tuple(colors8.shape)}")
    rgba = torch.nn.functional.pad(colors8, (0, 1))  # one 4-byte load per colour sample
    _launch_fuse(table, rows, fuse_worklist(rows, table.capacity), depths, rgba, cfg)


def _launch_fuse(table: BlockTable, rows: FuseRows, union: torch.Tensor, depths: torch.Tensor,
                 rgba: torch.Tensor, cfg: AppConfig) -> None:
    """The K1 launch itself, on a work list and RGBA colour frames that
    :func:`integrate_blocks` has checked and built."""
    _, h, w = depths.shape
    sy, sx = _log2_ratio(h, rgba.shape[1], "height"), _log2_ratio(w, rgba.shape[2], "width")
    r, cap = rows.keys.shape
    err = kernels.library().bf_tsdf_fuse(
        table.sdf.data_ptr(), table.weight.data_ptr(), table.color.data_ptr(),
        union.data_ptr(), union.shape[0],
        rows.keys.data_ptr(), rows.keys.stride(0), rows.slots.data_ptr(), rows.slots.stride(0),
        rows.masks.data_ptr(), rows.masks.stride(0), cap, r,
        depths.data_ptr(), h, w, rgba.data_ptr(), sy, sx,
        rows.fidx.data_ptr(), rows.params.data_ptr(),
        float(np.float32(cfg.voxel_size)), float(np.float32(BLOCK * cfg.voxel_size)),
        cfg.truncation, cfg.truncation_scale, cfg.max_integration_distance,
        cfg.max_integration_weight, cfg.integration_weight_sample, _INV255,
        kernels.stream_ptr(depths.device),
    )
    kernels.check(err, "tsdf_fuse")
    integrate_blocks.launches += 1


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


def _fuse_rows(
    table: BlockTable,
    keys_rows: torch.Tensor,  # [N, cap] per-row update-key lists
    rec_rows: torch.Tensor,  # [N, cap] recorded update masks
    active: torch.Tensor,  # [N] bool
    fidx: torch.Tensor,  # [N] int64 frame-storage index per row
    poses: torch.Tensor,  # [N, 4, 4]
    signs: torch.Tensor,  # [N] float32 — +1 integrate / -1 de-integrate
    cam: CameraModel,
) -> FuseRows:
    """The K1 rows of a batch. Allocation has already happened, so every
    row's lookup runs as one batched search; all of it stays on the device."""
    slots, found = lookup(table, keys_rows)
    return FuseRows(
        keys=keys_rows, slots=slots, masks=found & rec_rows & active[:, None],
        fidx=fidx, params=row_params(poses, signs, cam),
    )


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
    dev = depth.device
    keys = frame_alloc_keys(depth, pose_c2w, cam, cfg)
    upd_keys, f_trunc = dedup_keys_counted(keys, cfg.blocks_per_frame_cap)
    table, overflow = allocate(table, upd_keys, assume_unique_sorted=True)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    rows = _fuse_rows(
        table, upd_keys[None], one[:, None], one, torch.zeros(1, dtype=torch.int64, device=dev),
        pose_c2w[None], torch.ones(1, device=dev), cam,
    )
    integrate_blocks(table, rows, depth[None], color_wire(color)[None], cfg)
    return table, FuseDiag(
        overflow=overflow, upd_truncated=f_trunc, patch_overflow=_zero(dev), upd_mask=rows.masks[0]
    )


def deintegrate(
    table: BlockTable,
    depth: torch.Tensor,
    color: torch.Tensor,
    pose_c2w: torch.Tensor,
    cam: CameraModel,
    cfg: AppConfig,
    upd_mask: torch.Tensor | None = None,
) -> BlockTable:
    """Exactly remove one frame's contribution: K1 with one inverse row (the
    pose and depth must be the ones it was integrated with). No allocation:
    the blocks must exist. Pass the ``FuseDiag.upd_mask`` recorded at
    integrate time: a block the frame failed to update then (allocation
    overflow) may exist now, and must not lose a contribution it never got."""
    dev = depth.device
    cap = cfg.blocks_per_frame_cap
    upd_keys = dedup_keys(frame_alloc_keys(depth, pose_c2w, cam, cfg), cap)
    rec = torch.ones((1, cap), dtype=torch.bool, device=dev) if upd_mask is None else upd_mask[None]
    rows = _fuse_rows(
        table, upd_keys[None], rec, torch.ones(1, dtype=torch.bool, device=dev),
        torch.zeros(1, dtype=torch.int64, device=dev), pose_c2w[None], -torch.ones(1, device=dev), cam,
    )
    integrate_blocks(table, rows, depth[None], color_wire(color)[None], cfg)
    return table


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
    then one K1 launch over all rows."""
    b = depths.shape[0]
    cap = cfg.blocks_per_frame_cap
    dev = depths.device
    upd_keys_all, f_truncs = _upd_keys_batch(depths, poses, valid, cam, cfg)
    union, union_overflow = _union_counted(upd_keys_all, cap * 4)
    table, overflow = allocate(table, union, assume_unique_sorted=True)
    rows = _fuse_rows(
        table, upd_keys_all, torch.ones((b, cap), dtype=torch.bool, device=dev), valid,
        torch.arange(b, device=dev), poses, torch.ones(b, device=dev), cam,
    )
    integrate_blocks(table, rows, depths, color_wire(colors), cfg)
    return table, FuseDiag(
        overflow=overflow + union_overflow,
        upd_truncated=torch.sum(f_truncs).to(torch.int32),
        patch_overflow=_zero(dev),
        upd_mask=rows.masks,
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
    """Batched exact removal (one K1 launch over all rows, sign -1)."""
    b = depths.shape[0]
    dev = depths.device
    if upd_masks is None:
        upd_masks = torch.ones((b, cfg.blocks_per_frame_cap), dtype=torch.bool, device=dev)
    upd_keys_all, _ = _upd_keys_batch(depths, poses, valid, cam, cfg)
    rows = _fuse_rows(
        table, upd_keys_all, upd_masks, valid, torch.arange(b, device=dev), poses,
        -torch.ones(b, device=dev), cam,
    )
    integrate_blocks(table, rows, depths, color_wire(colors), cfg)
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
    ONE K1 launch over B + deint_rows rows, all de-integrations first.
    Returns (table, FuseDiag) with the [B, cap] re-integration record in
    ``upd_mask``."""
    table, rows, diag = fuse_batch_rows(
        table, depths, old_poses, new_poses, deint_mask, reint_mask, upd_masks_rec, cam, cfg,
        upd_keys_rec, deint_rows,
    )
    integrate_blocks(table, rows, depths, color_wire(colors), cfg)
    return table, diag


def fuse_batch_rows(
    table: BlockTable,
    depths: torch.Tensor,
    old_poses: torch.Tensor,
    new_poses: torch.Tensor,
    deint_mask: torch.Tensor,
    reint_mask: torch.Tensor,
    upd_masks_rec: torch.Tensor,
    cam: CameraModel,
    cfg: AppConfig,
    upd_keys_rec: torch.Tensor | None = None,
    deint_rows: int | None = None,
) -> tuple[BlockTable, FuseRows, FuseDiag]:
    """:func:`fuse_batch` up to its K1 launch: the allocation merge and the
    rows (deint_rows de-integrations, then B integrations). Returns (table,
    rows, FuseDiag)."""
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
    union, union_overflow = _union_counted(reint_keys, cap * 4)
    table, overflow = allocate(table, union, assume_unique_sorted=True)
    rows = _fuse_rows(
        table,
        torch.cat([deint_keys, reint_keys]),
        torch.cat([upd_masks_rec[lo:], torch.ones((b, cap), dtype=torch.bool, device=dev)]),
        torch.cat([deint_mask[lo:], reint_mask]),
        torch.cat([torch.arange(lo, b, device=dev), torch.arange(b, device=dev)]),
        torch.cat([old_poses[lo:], new_poses]),
        torch.cat([-torch.ones(dr, device=dev), torch.ones(b, device=dev)]),
        cam,
    )
    return table, rows, FuseDiag(
        overflow=overflow + union_overflow,
        upd_truncated=torch.sum(trunc_r).to(torch.int32),
        patch_overflow=_zero(dev),
        upd_mask=rows.masks[dr:],
        upd_keys=reint_keys,
    )
