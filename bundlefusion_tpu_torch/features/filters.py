"""The three-stage geometric correspondence filter
(port of ``bundlefusion_tpu.features.filters``):

  1. :func:`kabsch_filter` — fixed-iteration reweighted trimming around the
     batched closed-form Kabsch solve;
  2. :func:`surface_area_filter` — PCA spread of the matched keys;
  3. :func:`dense_verify_filter` — warp the cached low-res frames with the
     candidate relative pose and require depth/normal/photometric agreement.

Everything is batched over a leading pair axis; a pair that fails has its
matches zeroed (valid=False).

The dense verification reduces each (pair, direction) to four sums in
:func:`dense_verify_sums`: kernel K5 (``csrc/dense_verify.cu``) on CUDA
tensors, its twin :func:`_dense_verify_torch` on CPU tensors. The JAX
package's matmul-form sampling (``ops/preprocess.py::
bilinear_sample_matmul``) is not on this path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import kernels
from ..config import BundlingConfig
from ..geometry import se3
from ..geometry.camera import CameraModel, project
from ..ops.preprocess import FrameCache, bilinear_sample_gather
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


# csrc/dense_verify.cu's CTA: thread t sums pixels t, t + _THREADS, ... in
# order, then each warp's 32 sums and the warps' sums are halved in turn
_THREADS = 512
_WARPS = _THREADS // 32


def _sum_in_kernel_order(x: torch.Tensor) -> torch.Tensor:
    """Sum [..., D] over D in K5's order: a running sum per thread over its
    strided pixels (from +0.0), then a halving tree over each warp's 32
    lanes (lane i + lane i + off, off = 16, ..., 1), then one over the
    warps' sums (off = _WARPS / 2, ..., 1)."""
    d = x.shape[-1]
    rows = -(-d // _THREADS)
    x = torch.nn.functional.pad(x, (0, rows * _THREADS - d)).reshape(*x.shape[:-1], rows, _THREADS)
    acc = torch.zeros_like(x[..., 0, :])
    for r in range(rows):
        acc = acc + x[..., r, :]
    acc = acc.reshape(*acc.shape[:-1], _WARPS, 32)
    for width in (32, _WARPS):
        off = width // 2
        while off:
            acc = acc[..., :off] + acc[..., off:2 * off]
            off //= 2
        acc = acc[..., 0]
    return acc


def _verify_terms(cache_a: FrameCache, cache_b: FrameCache, T_ba, cam: CameraModel, cfg: BundlingConfig):
    """Per pixel of frame a, [..., D]: (valid, projected, agreeing, depth
    error), as K5 computes them: the transform as ((r0 x + r1 y) + r2 z) +
    t (``se3.transform_points`` is an einsum), then ``project`` and
    ``bilinear_sample_gather`` on frame b's five channels, the normal
    normalised by max(sqrt((x x + y y) + z z), 1e-9)."""
    lead = cache_a.depth.shape[:-2]
    h, w = cache_a.depth.shape[-2:]
    d = h * w
    px, py, pz = cache_a.points.reshape(*lead, d, 3).unbind(-1)
    nx, ny, nz = cache_a.normals.reshape(*lead, d, 3).unbind(-1)
    valid_a = cache_a.depth.reshape(*lead, d) > 0.0
    R = [[T_ba[..., i, j, None] for j in range(4)] for i in range(3)]

    def rot(i, a, b, c):
        return (R[i][0] * a + R[i][1] * b) + R[i][2] * c

    x, y, z = (rot(i, px, py, pz) + R[i][3] for i in range(3))
    uv, ok = project(cam, torch.stack([x, y, z], dim=-1))
    stack_b = torch.cat([cache_b.depth[..., None], cache_b.normals, cache_b.intensity[..., None]], dim=-1)
    samp, inb = bilinear_sample_gather(stack_b.reshape(-1, h, w, 5), uv.reshape(-1, d, 2))
    depth_b, nbx, nby, nbz, inten_b = samp.reshape(*lead, d, 5).unbind(-1)
    proj_ok = valid_a & ok & inb.reshape(*lead, d) & (depth_b > 0.0)

    dist = torch.abs(z - depth_b)
    nrm = torch.clamp(torch.sqrt((nbx * nbx + nby * nby) + nbz * nbz), min=1e-9)
    ndot = (rot(0, nx, ny, nz) * (nbx / nrm) + rot(1, nx, ny, nz) * (nby / nrm)) + rot(2, nx, ny, nz) * (nbz / nrm)
    dint = torch.abs(cache_a.intensity.reshape(*lead, d) - inten_b)
    agree = (
        proj_ok
        & (dist < cfg.verify_dist_thresh)
        & (ndot > cfg.verify_normal_thresh)
        & (dint < cfg.verify_color_thresh)
    )
    return valid_a, proj_ok, agree, dist


def _dense_verify_torch(cache_a: FrameCache, cache_b: FrameCache, T_ba, cam: CameraModel,
                        cfg: BundlingConfig) -> torch.Tensor:
    """K5's twin for one direction: [..., 4] float32 (valid, projected and
    agreeing pixels of frame a, the projected pixels' depth-error sum in
    K5's order)."""
    valid_a, proj_ok, agree, dist = _verify_terms(cache_a, cache_b, T_ba, cam, cfg)
    counts = [torch.sum(m, dim=-1).to(torch.float32) for m in (valid_a, proj_ok, agree)]
    return torch.stack([*counts, _sum_in_kernel_order(torch.where(proj_ok, dist, 0.0))], dim=-1)


def _kernel_side(cache: FrameCache, pairs: int, h: int, w: int):
    """One side's (depth, points, normals, intensity, pixel stride per
    pair) as K5 reads them: each frame contiguous, all four fields at one
    pair stride (0 for a frame broadcast to every pair); a side that is not
    so laid out is copied."""
    fields = [cache.depth.reshape(pairs, h, w), cache.points.reshape(pairs, h, w, 3),
              cache.normals.reshape(pairs, h, w, 3), cache.intensity.reshape(pairs, h, w)]
    stride = fields[0].stride(0) if pairs > 1 else 0

    def fits(t, c):
        inner = (w, 1) if c == 1 else (3 * w, 3, 1)
        return t.stride()[1:] == inner and (pairs == 1 or t.stride(0) == c * stride)

    if not all(fits(t, c) for t, c in zip(fields, (1, 3, 3, 1))):
        fields, stride = [t.contiguous() for t in fields], h * w
    for name, t in zip(("depth", "points", "normals", "intensity"), fields):
        kernels.require(t, name, torch.float32, contiguous=False)
    return (*fields, stride)


@kernels.counted
def dense_verify_sums(cache_a: FrameCache, cache_b: FrameCache, transforms: tuple, cam: CameraModel,
                      cfg: BundlingConfig) -> torch.Tensor:
    """Kernel K5: the dense verification of frame pairs (caches with
    leading pair axes ``...``) reduced to [len(transforms), ..., 4] float32:
    valid, projected and agreeing pixels and the depth-error sum, for a -> b
    under ``transforms[0]`` and, given a second transform, for b -> a under
    ``transforms[1]``; both directions in one launch. CUDA tensors launch
    the kernel (bit-equal to the twin on the card); CPU tensors run the
    twin, :func:`_dense_verify_torch`."""
    sides = ((cache_a, cache_b), (cache_b, cache_a))[: len(transforms)]
    if not cache_a.depth.is_cuda:
        return torch.stack([_dense_verify_torch(a, b, T, cam, cfg) for (a, b), T in zip(sides, transforms)])
    lead = cache_a.depth.shape[:-2]
    h, w = cache_a.depth.shape[-2:]
    if cache_b.depth.shape != cache_a.depth.shape or not 1 <= len(transforms) <= 2:
        raise ValueError(f"dense_verify_sums: caches {tuple(cache_a.depth.shape)} and "
                         f"{tuple(cache_b.depth.shape)}, {len(transforms)} transforms")
    pairs = math.prod(lead)
    out = torch.empty((len(transforms), pairs, 4), dtype=torch.float32, device=cache_a.depth.device)
    if pairs == 0:
        return out.reshape(len(transforms), *lead, 4)
    a, b = _kernel_side(cache_a, pairs, h, w), _kernel_side(cache_b, pairs, h, w)
    ts = [T.reshape(pairs, 16).contiguous() for T in transforms]
    for t in ts:
        kernels.require(t, "transform", torch.float32, (pairs, 16))
    err = kernels.library().bf_dense_verify(
        *(x if isinstance(x, int) else x.data_ptr() for x in (*a, *b)), ts[0].data_ptr(),
        ts[-1].data_ptr() if len(ts) == 2 else None, out.data_ptr(), pairs, len(ts), h, w,
        cam.fx, cam.fy, cam.cx, cam.cy, cam.width - 1.0, cam.height - 1.0, w - 1.0 + 1e-4, h - 1.0 + 1e-4,
        w - 1.001, h - 1.001, cfg.verify_dist_thresh, cfg.verify_normal_thresh, cfg.verify_color_thresh,
        kernels.stream_ptr(cache_a.depth.device),
    )
    kernels.check(err, "dense_verify")
    kernels.launched(dense_verify_sums)
    return out.reshape(len(transforms), *lead, 4)


def _verify_stats(sums: torch.Tensor) -> VerifyStats:
    """The four ratios from [..., 4] sums, as the JAX package divides its
    counts (each at least 1 where it divides)."""
    n_valid = torch.clamp(sums[..., 0], min=1.0)
    n_proj = torch.clamp(sums[..., 1], min=1.0)
    return VerifyStats(
        ok_frac=sums[..., 2] / n_proj,
        overlap=sums[..., 1] / n_valid,
        err=sums[..., 3] / n_proj,
        corr=sums[..., 2] / n_valid,
    )


def dense_verify(cache_a: FrameCache, cache_b: FrameCache, T_ba, cam: CameraModel, cfg: BundlingConfig) -> VerifyStats:
    """Project frame a's cached points into frame b and measure agreement;
    caches and T_ba carry a leading batch axis. One K5 launch on the card,
    its twin on the CPU (:func:`dense_verify_sums`)."""
    return _verify_stats(dense_verify_sums(cache_a, cache_b, (T_ba,), cam, cfg)[0])


def dense_verify_filter(cache_a, cache_b, T_ba, cam: CameraModel, cfg: BundlingConfig) -> torch.Tensor:
    """Symmetric pass/fail dense verification, batched over pairs: both
    directions in one :func:`dense_verify_sums`."""
    sums = dense_verify_sums(cache_a, cache_b, (T_ba, se3.mat_inverse(T_ba)), cam, cfg)
    v_ab, v_ba = _verify_stats(sums[0]), _verify_stats(sums[1])
    ok_frac = 0.5 * (v_ab.ok_frac + v_ba.ok_frac)
    overlap = 0.5 * (v_ab.overlap + v_ba.overlap)
    return (ok_frac > cfg.verify_ok_fraction) & (overlap > cfg.verify_min_overlap)


def filter_pair(
    pa: torch.Tensor,  # [M, 3]
    pb: torch.Tensor,  # [M, 3]
    matches: PairMatches,  # [M]
    cache_a: FrameCache,  # one frame's cache
    cache_b: FrameCache,
    cache_cam: CameraModel,
    cfg: BundlingConfig,
    min_matches: int,
    use_dense_verify: bool = True,
) -> FilterResult:
    """The full 3-stage filter for one pair: :func:`filter_pairs_batch` over
    a batch of one."""
    m = PairMatches(matches.idx_i[None], matches.idx_j[None], matches.dist[None], matches.valid[None])
    r = filter_pairs_batch(pa[None], pb[None], m, cache_a.index(None), cache_b.index(None), cache_cam, cfg,
                           min_matches, use_dense_verify)
    fm = r.matches
    return FilterResult(
        matches=PairMatches(fm.idx_i[0], fm.idx_j[0], fm.dist[0], fm.valid[0]),
        transform=r.transform[0],
        pair_valid=r.pair_valid[0],
        inlier_count=r.inlier_count[0],
    )


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
