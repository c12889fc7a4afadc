"""The three-stage geometric correspondence filter
(port of ``bundlefusion_tpu.features.filters``):

  1. :func:`kabsch_filter` — fixed-iteration reweighted trimming around the
     batched closed-form Kabsch solve;
  2. :func:`surface_area_filter` — PCA spread of the matched keys;
  3. :func:`dense_verify_filter` — warp the cached low-res frames with the
     candidate relative pose and require depth/normal/photometric agreement.

Everything is batched over a leading pair axis; a pair that fails has its
matches zeroed (valid=False).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..config import BundlingConfig
from ..geometry import se3
from ..geometry.camera import CameraModel, project
from ..ops.preprocess import FrameCache, bilinear_sample_matmul
from ..utils.tensor_ops import top_k
from .matcher import PairMatches


@dataclass
class VerifyStats:
    ok_frac: torch.Tensor  # agreeing / projected
    overlap: torch.Tensor  # projected / valid
    err: torch.Tensor  # mean projective depth error over projected pixels
    corr: torch.Tensor  # agreeing / valid


@dataclass
class FilterResult:
    matches: PairMatches  # filtered, fixed capacity [..., Mf]
    transform: torch.Tensor  # [..., 4, 4] T_ba: p_b = T @ p_a
    pair_valid: torch.Tensor  # [...] bool
    inlier_count: torch.Tensor  # [...] int32


def kabsch_filter(pa, pb, valid, cfg: BundlingConfig, num_iters: int = 6):
    """Largest self-consistent rigid set by iterative trimming, batched:
    pa/pb [..., M, 3], valid [..., M]. Returns (T_ba, inliers, ok)."""
    w = valid.to(pa.dtype)
    for _ in range(num_iters):
        T = se3.kabsch(pa, pb, w)
        res = torch.linalg.vector_norm(se3.transform_points(T, pa) - pb, dim=-1)
        keep = (res < cfg.kabsch_max_res_thresh) & valid
        any_keep = torch.any(keep, dim=-1, keepdim=True)
        w = torch.where(any_keep, keep.to(pa.dtype), w)
    T = se3.kabsch(pa, pb, w)
    res = torch.linalg.vector_norm(se3.transform_points(T, pa) - pb, dim=-1)
    inliers = (res < cfg.kabsch_max_res_thresh) & valid
    ok = torch.sum(inliers, dim=-1) >= cfg.kabsch_min_inliers
    return T, inliers, ok


def _sym3_top2_eigvals(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Largest and middle eigenvalue of symmetric [..., 3, 3] matrices, in
    closed form (trigonometric solution of the characteristic cubic).
    ``torch.linalg.eigvalsh`` would read its error flags back to the host, a
    sync on every call."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p = torch.sqrt((b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1) / 6.0)
    ps = torch.clamp(p, min=1e-12)  # p = 0: det_b = 0 and all three equal q
    det_b = (
        b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02) + a02 * (a01 * a12 - b11 * a02)
    ) / (ps * ps * ps)
    phi = torch.arccos(torch.clamp(det_b * 0.5, -1.0, 1.0)) / 3.0
    e_max = q + 2.0 * p * torch.cos(phi)
    e_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    return e_max, 3.0 * q - e_max - e_min


def surface_area_filter(pa, pb, inliers, cfg: BundlingConfig) -> torch.Tensor:
    """The inlier points must span enough area (two dominant PCA axes) in
    BOTH frames; batched over pairs."""

    def spread(p):
        w = inliers.to(p.dtype)
        wsum = torch.clamp(torch.sum(w, dim=-1), min=1.0)
        mu = torch.einsum("...m,...mi->...i", w, p) / wsum[..., None]
        d = (p - mu[..., None, :]) * w[..., None]
        cov = d.transpose(-1, -2) @ d / wsum[..., None, None]
        e_max, e_mid = _sym3_top2_eigvals(cov)
        return torch.sqrt(torch.clamp(e_max, min=0.0)) * torch.sqrt(torch.clamp(e_mid, min=0.0))

    return (spread(pa) > cfg.surf_area_pca_thresh) & (spread(pb) > cfg.surf_area_pca_thresh)


def dense_verify(cache_a: FrameCache, cache_b: FrameCache, T_ba, cam: CameraModel, cfg: BundlingConfig) -> VerifyStats:
    """Project frame a's cached points into frame b and measure agreement;
    caches and T_ba carry a leading batch axis."""
    lead = cache_a.depth.shape[:-2]
    pts_a = cache_a.points.reshape(*lead, -1, 3)
    valid_a = cache_a.depth.reshape(*lead, -1) > 0.0
    pts_in_b = se3.transform_points(T_ba, pts_a)
    uv, proj_ok = project(cam, pts_in_b)
    stack_b = torch.cat(
        [cache_b.depth[..., None], cache_b.normals, cache_b.intensity[..., None]], dim=-1
    )
    samp, inb = bilinear_sample_matmul(stack_b, uv)
    depth_b = samp[..., 0]
    normal_b = samp[..., 1:4]
    inten_b = samp[..., 4]
    proj_ok = proj_ok & inb & valid_a & (depth_b > 0.0)

    dist = torch.abs(pts_in_b[..., 2] - depth_b)
    n_a = se3.rotate_vectors(T_ba, cache_a.normals.reshape(*lead, -1, 3))
    nb_norm = normal_b / torch.clamp(torch.linalg.vector_norm(normal_b, dim=-1, keepdim=True), min=1e-9)
    ndot = torch.sum(n_a * nb_norm, dim=-1)
    dint = torch.abs(cache_a.intensity.reshape(*lead, -1) - inten_b)

    agree = (
        proj_ok
        & (dist < cfg.verify_dist_thresh)
        & (ndot > cfg.verify_normal_thresh)
        & (dint < cfg.verify_color_thresh)
    )
    n_valid = torch.clamp(torch.sum(valid_a, dim=-1), min=1)
    n_proj = torch.sum(proj_ok, dim=-1)
    n_agree = torch.sum(agree, dim=-1)
    return VerifyStats(
        ok_frac=n_agree / torch.clamp(n_proj, min=1),
        overlap=n_proj / n_valid,
        err=torch.sum(torch.where(proj_ok, dist, 0.0), dim=-1) / torch.clamp(n_proj, min=1),
        corr=n_agree / n_valid,
    )


def dense_verify_filter(cache_a, cache_b, T_ba, cam: CameraModel, cfg: BundlingConfig) -> torch.Tensor:
    """Symmetric pass/fail dense verification, batched over pairs."""
    v_ab = dense_verify(cache_a, cache_b, T_ba, cam, cfg)
    v_ba = dense_verify(cache_b, cache_a, se3.mat_inverse(T_ba), cam, cfg)
    ok_frac = 0.5 * (v_ab.ok_frac + v_ba.ok_frac)
    overlap = 0.5 * (v_ab.overlap + v_ba.overlap)
    return (ok_frac > cfg.verify_ok_fraction) & (overlap > cfg.verify_min_overlap)


def filter_pairs_batch(
    pa: torch.Tensor,  # [P, M, 3]
    pb: torch.Tensor,  # [P, M, 3]
    matches: PairMatches,  # batched [P, M]
    caches_a: FrameCache,  # batched [P, ...]
    caches_b: FrameCache,
    cache_cam: CameraModel,
    cfg: BundlingConfig,
    min_matches: int,
    use_dense_verify: bool = True,
) -> FilterResult:
    """The full 3-stage filter for every pair of the batch."""
    T, inliers, kabsch_ok = kabsch_filter(pa, pb, matches.valid, cfg)
    area_ok = surface_area_filter(pa, pb, inliers, cfg)
    if use_dense_verify:
        dense_ok = dense_verify_filter(caches_a, caches_b, T, cache_cam, cfg)
    else:
        dense_ok = torch.ones_like(kabsch_ok)
    count = torch.sum(inliers, dim=-1)
    pair_ok = kabsch_ok & area_ok & dense_ok & (count >= min_matches)

    score = torch.where(inliers & pair_ok[..., None], -matches.dist, -torch.inf)
    top, sel = top_k(score, cfg.max_matches_per_pair_filtered)
    fvalid = torch.isfinite(top)
    filtered = PairMatches(
        idx_i=torch.where(fvalid, torch.gather(matches.idx_i, -1, sel), 0),
        idx_j=torch.where(fvalid, torch.gather(matches.idx_j, -1, sel), 0),
        dist=torch.where(fvalid, torch.gather(matches.dist, -1, sel), torch.inf),
        valid=fvalid,
    )
    eye = torch.eye(4, dtype=T.dtype, device=T.device)
    return FilterResult(
        matches=filtered,
        transform=torch.where(pair_ok[..., None, None], T, eye),
        pair_valid=pair_ok,
        inlier_count=count.to(torch.int32),
    )
