"""Intra-chunk (local) bundling (port of ``bundlefusion_tpu.bundle.chunk``):
for the S+1 frames of a chunk — preprocessing (kernel K2), SIFT, all-pairs
matching, 3-stage filtering, sparse+dense local BA anchored at the chunk's
first frame (the keyframe), solve verification, and fusion of the chunk's
keys into the keyframe's key set.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..config import BundlingConfig
from ..features import filters, matcher, sift
from ..geometry import se3
from ..geometry.camera import CameraModel
from ..ops.preprocess import FrameCache, preprocess_frames, preprocess_frames_y
from ..solver import gn, residuals
from ..utils.tensor_ops import top_k

_INT32_MAX = 2**31 - 1


@dataclass
class ChunkResult:
    local_traj: torch.Tensor  # [S+1, 4, 4] frame i -> chunk (frame 0) coords
    chunk_valid: torch.Tensor  # bool
    keyframe_keys: sift.SiftKeys  # fused keys, p3d in keyframe coords
    keyframe_cache: FrameCache  # frame 0's cache
    num_keys: torch.Tensor  # [S+1] int32
    num_matches: torch.Tensor  # [P] int32 filtered matches per pair
    pair_valid: torch.Tensor  # [P] bool
    solve_sparse_res: torch.Tensor  # [gn_iters]


def fuse_keys_to_keyframe(keys: sift.SiftKeys, local_traj, frame_valid, cfg: BundlingConfig,
                          dedup_cell: float = 0.03) -> sift.SiftKeys:
    """Merge the chunk's keys into one keyframe key set: positions move into
    keyframe coordinates, duplicates (same ~3 cm cell) keep the strongest
    response, keyframe-native keys preferred. Sort-based dedup."""
    s1, cap = keys.valid.shape
    dev = keys.valid.device
    p_kf = torch.einsum("fij,fkj->fki", local_traj[:, :3, :3], keys.p3d) + local_traj[:, None, :3, 3]
    valid = keys.valid & frame_valid[:, None]

    p = p_kf.reshape(s1 * cap, 3)
    v = valid.reshape(-1)
    resp = keys.response.reshape(-1)
    frame_idx = torch.repeat_interleave(torch.arange(s1, device=dev), cap)
    prio = resp + torch.where(frame_idx == 0, 10.0, 0.0)

    cell = torch.floor(p / dedup_cell).to(torch.int32)
    cell_key = (cell[:, 0] + 512) + (cell[:, 1] + 512) * 1024 + (cell[:, 2] + 512) * 1024 * 1024
    cell_key = torch.where(v, cell_key, _INT32_MAX)
    # lexsort by (cell, -priority): stable sort by the minor key, then the major
    _, o1 = torch.sort(-prio, stable=True)
    _, o2 = torch.sort(cell_key[o1], stable=True)
    order = o1[o2]
    ck_sorted = cell_key[order]
    first = torch.ones_like(ck_sorted, dtype=torch.bool)
    first[1:] = ck_sorted[1:] != ck_sorted[:-1]
    keep = first & (ck_sorted != _INT32_MAX)

    score = torch.where(keep, prio[order], -torch.inf)
    top, sel = top_k(score, cap)
    pick = order[sel]
    out_valid = torch.isfinite(top)

    def g(x):
        fx = x.reshape((s1 * cap,) + x.shape[2:])[pick]
        return torch.where(out_valid.reshape((-1,) + (1,) * (fx.dim() - 1)), fx, torch.zeros_like(fx))

    return sift.SiftKeys(
        xy=g(keys.xy),
        sigma=g(keys.sigma),
        response=g(keys.response),
        orientation=g(keys.orientation),
        depth=g(keys.depth),
        p3d=torch.where(out_valid[:, None], p[pick], 0.0),
        desc=g(keys.desc),
        valid=out_valid,
    )


def process_chunk(
    depth_raw: torch.Tensor,  # [S+1, H, W] int16-stored uint16 mm wire (or f32 meters)
    color: torch.Tensor,  # [S+1, H, W] uint8 luma (v2 wire) or [S+1, H, W, 3] RGB (v1 wire, or f32)
    cam: CameraModel,
    cache_cam: CameraModel,
    cfg: BundlingConfig,
    sigma_d: float = 2.0,
    sigma_r: float = 0.1,
    filter_depth: bool = True,
) -> ChunkResult:
    """The whole local pipeline for one chunk, from the luma wire (ndim 3)
    or from RGB (ndim 4); the two give different intensities by design."""
    s1 = depth_raw.shape[0]
    dev = depth_raw.device
    # only the filtered depth and the intensity are read below: no geometry
    prep = preprocess_frames_y if color.dim() == 3 else preprocess_frames
    frames, cache = prep(
        depth_raw, color, cam, cache_cam, sigma_d=sigma_d, sigma_r=sigma_r, filter_depth=filter_depth,
        geometry=False,
    )
    keys = sift.detect_batch(frames.intensity, frames.depth, cam, cfg)

    # all pairs (a < b) in row-major order, made on the device (a tensor from
    # Python data would be a host->device copy and a sync per chunk)
    pairs_a, pairs_b = torch.triu_indices(s1, s1, offset=1, device=dev)
    m = matcher.match_all_pairs(keys, pairs_a, pairs_b, cfg)
    pa, pb = matcher.gather_match_points(keys, pairs_a, pairs_b, m)
    filt = filters.filter_pairs_batch(
        pa, pb, m, cache.index(pairs_a), cache.index(pairs_b), cache_cam, cfg, cfg.min_matches_local
    )

    # correspondences from the filtered matches
    fm = filt.matches  # [P, Mf]
    p_m = fm.valid.shape[1]
    corrs = residuals.SparseCorrs(
        img_a=torch.repeat_interleave(pairs_a, p_m),
        img_b=torch.repeat_interleave(pairs_b, p_m),
        p_a=keys.p3d[pairs_a[:, None], fm.idx_i].reshape(-1, 3),
        p_b=keys.p3d[pairs_b[:, None], fm.idx_j].reshape(-1, 3),
        weight=(fm.valid & filt.pair_valid[:, None]).reshape(-1).to(torch.float32),
    )
    # cap the local sparse system at the configured residual capacity,
    # keeping the best-descriptor-distance correspondences
    if corrs.weight.shape[0] > cfg.max_residuals_local:
        score = torch.where(corrs.weight > 0, -fm.dist.reshape(-1), -torch.inf)
        _, keep = top_k(score, cfg.max_residuals_local)
        corrs = corrs.index(keep)
        corrs = dataclasses.replace(corrs, weight=torch.where(torch.isfinite(score[keep]), corrs.weight, 0.0))

    # initial local poses: chain the consecutive pairwise filter transforms
    # index of pair (i, i+1) in the row-major enumeration
    i = torch.arange(s1 - 1, device=dev)
    consec_idx = i * (s1 - 1) - torch.div(i * (i - 1), 2, rounding_mode="floor")
    T_rel = filt.transform[consec_idx]  # maps i-cam -> (i+1)-cam
    inv_rel = se3.mat_inverse(T_rel)
    traj = [torch.eye(4, device=dev)]
    for i in range(s1 - 1):
        traj.append(traj[-1] @ inv_rel[i])
    init_traj = torch.stack(traj)

    problem = gn.GNProblem(
        corrs=corrs,
        dense_pairs_a=pairs_a,
        dense_pairs_b=pairs_b,
        dense_pair_active=filt.pair_valid,
        free_mask=torch.arange(s1, device=dev) > 0,
    )
    solved, problem, stats, _ = gn.solve_and_prune(
        init_traj, problem, cache, cache_cam, cfg,
        gn_iters=cfg.local_gn_iters, pcg_iters=cfg.local_pcg_iters,
        use_dense=cfg.use_dense_local, prune_rounds=2,
    )

    # chunk validity: the consecutive chain must hold and the solved
    # consecutive poses must pass dense verification (verifyOpt)
    chain_ok = torch.all(filt.pair_valid[consec_idx])
    T_ij = torch.einsum("nij,njk->nik", se3.mat_inverse(solved[1:]), solved[:-1])
    v = filters.dense_verify(cache.index(slice(None, -1)), cache.index(slice(1, None)), T_ij, cache_cam, cfg)
    opt_ok = torch.all((v.err < cfg.verify_opt_err_thresh) & (v.corr > cfg.verify_opt_corr_thresh))
    chunk_valid = chain_ok & opt_ok

    keyframe_keys = fuse_keys_to_keyframe(
        keys, solved, torch.ones(s1, dtype=torch.bool, device=dev) & chunk_valid, cfg
    )
    return ChunkResult(
        local_traj=solved,
        chunk_valid=chunk_valid,
        keyframe_keys=keyframe_keys,
        keyframe_cache=cache.index(0),
        num_keys=torch.sum(keys.valid, dim=-1).to(torch.int32),
        num_matches=fm.count().to(torch.int32),
        pair_valid=filt.pair_valid,
        solve_sparse_res=stats.sparse_res_sum,
    )
