"""Residuals and hand Jacobians for sparse+dense bundle adjustment
(port of ``bundlefusion_tpu.solver.residuals``).

Convention: pose T maps camera points to world; the GN update perturbs on
the left, T' = exp(xi) T with twist xi = (omega, upsilon). For a world point
p = T p_cam the derivative is d p / d xi = [ -hat(p) | I3 ] (3x6). Each term
contributes a 12-column block ([6 for pose a | 6 for pose b]).

The dense term of every dense-pair slot is kernel K6
(``csrc/dense_pairs.cu``, :func:`dense_pair_blocks`) on CUDA tensors and
its twin :func:`_dense_pair_blocks_torch` on CPU tensors. The JAX
package's per-pixel einsum form is not on this path.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import kernels
from ..config import BundlingConfig
from ..geometry import se3
from ..geometry.camera import CameraModel
from ..ops.preprocess import FrameCache


@dataclass
class SparseCorrs:
    """Fixed-capacity sparse 3D-3D correspondence store (weight 0 = empty)."""

    img_a: torch.Tensor  # [R] int image index of endpoint a
    img_b: torch.Tensor  # [R] int
    p_a: torch.Tensor  # [R, 3] camera-space point in image a
    p_b: torch.Tensor  # [R, 3]
    weight: torch.Tensor  # [R] float32

    @property
    def capacity(self) -> int:
        return self.img_a.shape[0]

    def index(self, idx) -> "SparseCorrs":
        return SparseCorrs(self.img_a[idx], self.img_b[idx], self.p_a[idx], self.p_b[idx], self.weight[idx])


def empty_corrs(capacity: int, device) -> SparseCorrs:
    return SparseCorrs(
        img_a=torch.zeros(capacity, dtype=torch.int32, device=device),
        img_b=torch.zeros(capacity, dtype=torch.int32, device=device),
        p_a=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        p_b=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
        weight=torch.zeros(capacity, dtype=torch.float32, device=device),
    )


def point_jacobian(p_world: torch.Tensor) -> torch.Tensor:
    """d(p_world)/d(twist) = [-hat(p) | I] : [..., 3] -> [..., 3, 6]."""
    eye = torch.eye(3, dtype=p_world.dtype, device=p_world.device).expand(*p_world.shape[:-1], 3, 3)
    return torch.cat([-se3.hat(p_world), eye], dim=-1)


def sparse_residuals(poses: torch.Tensor, corrs: SparseCorrs):
    """r_k = T_a p_a - T_b p_b with 12-col Jacobians: (r [R,3], J [R,3,12], |r| [R])."""
    Ta = poses[corrs.img_a.long()]
    Tb = poses[corrs.img_b.long()]
    pa_w = se3.transform_points(Ta, corrs.p_a)
    pb_w = se3.transform_points(Tb, corrs.p_b)
    r = pa_w - pb_w
    J = torch.cat([point_jacobian(pa_w), -point_jacobian(pb_w)], dim=-1)
    return r, J, torch.linalg.vector_norm(r, dim=-1)


def sparse_corr_blocks(poses: torch.Tensor, corrs: SparseCorrs, weight_sparse: float):
    """Per-correspondence normal-equation blocks: (JtJ [R,12,12], Jtr [R,12], |r| [R])."""
    r, J, rn = sparse_residuals(poses, corrs)
    w = corrs.weight * weight_sparse
    JtJ_k = torch.einsum("kri,krj->kij", J, J * w[:, None, None])
    Jtr_k = torch.einsum("kri,kr->ki", J, r * w[:, None])
    return JtJ_k, Jtr_k, rn


@dataclass
class DenseStats:
    num_valid_depth: torch.Tensor  # [P] int pixels contributing to the depth term
    num_valid_color: torch.Tensor  # [P]
    sum_sq_depth: torch.Tensor  # [P] float32
    sum_sq_color: torch.Tensor  # [P]


# csrc/dense_pairs.cu's CTA and work items: a pair's pixels in up to
# _K6_SPLITS splits of ``rows`` rows of _K6_THREADS pixels, split while the
# pairs number fewer than _K6_ITEMS
_K6_THREADS = 256
_K6_WARPS = _K6_THREADS // 32
_K6_SPLITS = 4
_K6_ITEMS = 512
# each row kind's H (21 upper entries, row-major) and g (6), the depth row's
# at 0 and the colour row's at _K6_ROW; then the two squared-residual sums
_K6_ROW = 27
_K6_SUMS = 2 * _K6_ROW + 2
_K6_TWIN_PAIRS = 256  # the twin's pairs a pass (its memory; each pair's blocks are its own)
_UPPER = [(i, j) for i in range(6) for j in range(i, 6)]


def _k6_grid(pairs: int, pixels: int) -> tuple[int, int]:
    """(splits, rows): how K6 cuts each of ``pairs`` pairs' ``pixels`` into
    work items. Few pairs (the local solve's 55) take several CTAs a pair;
    a long list (the global solve's 4,096 slots) one a pair, its slots not
    live costing one load each."""
    rows = -(-pixels // _K6_THREADS)
    splits = max(1, min(_K6_SPLITS, rows, _K6_ITEMS // max(pairs, 1)))
    return splits, -(-rows // splits)


def _k6_row(p, v, weight: float, r, ok) -> tuple[torch.Tensor, torch.Tensor]:
    """One Jacobian row [p x v, v] (a's half; b's is its negation) per
    pixel: its terms of H ((weight * J_i) * J_j, i <= j) and of g ((weight
    * J_i) * r) [P, M, _K6_ROW], and r * r [P, M]; zero where ``ok`` is
    false."""
    px, py, pz = p
    J = [py * v[2] - pz * v[1], pz * v[0] - px * v[2], px * v[1] - py * v[0], *v]
    wJ = [weight * j for j in J]
    terms = torch.stack([wJ[i] * J[j] for i, j in _UPPER] + [wJ[i] * r for i in range(6)], -1)
    return torch.where(ok[..., None], terms, 0.0), torch.where(ok, r * r, 0.0)


def _k6_pixel_rows(poses, pa, pb, caches: FrameCache, table, cam: CameraModel, cfg: BundlingConfig,
                   weight_depth: float, weight_color: float):
    """Per pixel of a for pairs (``pa``, ``pb``), as K6 computes it: the
    terms of its sums [P, M, _K6_SUMS] (the depth row's, the colour row's,
    the two squared residuals; zero where the pixel does not associate)
    and the two association masks. ``table`` [N * h * w, 10] holds b's
    channels for the taps (depth, normal, point, intensity, gradient); the
    taps are ``bilinear_sample_gather``'s."""
    n, h, w = caches.depth.shape
    m = h * w
    A, B = poses[pa], poses[pb]
    ra = [[A[:, i, j, None] for j in range(3)] for i in range(3)]
    rb = [[B[:, i, j, None] for j in range(3)] for i in range(3)]
    ta = [A[:, i, 3, None] for i in range(3)]
    tb = [B[:, i, 3, None] for i in range(3)]
    tbi = [-((rb[0][i] * tb[0] + rb[1][i] * tb[1]) + rb[2][i] * tb[2]) for i in range(3)]

    def rot(R, a, b, c, i):
        return (R[i][0] * a + R[i][1] * b) + R[i][2] * c

    def rot_t(R, a, b, c, i):
        return (R[0][i] * a + R[1][i] * b) + R[2][i] * c

    ax, ay, az = caches.points.reshape(n, m, 3)[pa].unbind(-1)
    pw = [rot(ra, ax, ay, az, i) + ta[i] for i in range(3)]
    x, y, z = (rot_t(rb, *pw, i) + tbi[i] for i in range(3))
    zok = z > 1e-6
    zs = torch.where(zok, z, 1.0)
    u = x / zs * cam.fx + cam.cx
    v = y / zs * cam.fy + cam.cy
    inside = (u >= 0.0) & (u <= cam.width - 1.0) & (v >= 0.0) & (v <= cam.height - 1.0)
    inb = (u >= 0.0) & (u < w - 1.0 + 1e-4) & (v >= 0.0) & (v < h - 1.0 + 1e-4)
    uc = torch.clamp(u, 0.0, w - 1.001)
    vc = torch.clamp(v, 0.0, h - 1.001)
    u0 = torch.nan_to_num(torch.floor(uc), nan=0.0)  # a NaN coordinate gathers pixel 0 and fails inb
    v0 = torch.nan_to_num(torch.floor(vc), nan=0.0)
    tv0, tv1 = (torch.clamp(1.0 - torch.abs(vc - at), min=0.0)[..., None] for at in (v0, v0 + 1.0))
    tu0, tu1 = (torch.clamp(1.0 - torch.abs(uc - at), min=0.0)[..., None] for at in (u0, u0 + 1.0))
    base = pb[:, None] * m + v0.long() * w + u0.long()
    col0 = tv0 * table[base] + tv1 * table[base + w]
    col1 = tv0 * table[base + 1] + tv1 * table[base + w + 1]
    db, nb0, nb1, nb2, qb0, qb1, qb2, ib, gx, gy = (col0 * tu0 + col1 * tu1).unbind(-1)

    nrm = torch.sqrt((nb0 * nb0 + nb1 * nb1) + nb2 * nb2)
    nw = [rot(rb, nb0 / nrm, nb1 / nrm, nb2 / nrm, i) for i in range(3)]
    d = [pw[i] - (rot(rb, qb0, qb1, qb2, i) + tb[i]) for i in range(3)]
    dist = torch.sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])
    na = caches.normals.reshape(n, m, 3)[pa].unbind(-1)
    naw = [rot(ra, *na, i) for i in range(3)]
    ndot = (naw[0] * nw[0] + naw[1] * nw[1]) + naw[2] * nw[2]
    depth_ok = ((caches.depth.reshape(n, m)[pa] > 0.0) & zok & inside & inb & (db > 0.0) & (nrm > 0.5)
                & (dist < cfg.dense_dist_thresh) & (ndot > cfg.dense_normal_thresh))
    rd = (nw[0] * d[0] + nw[1] * d[1]) + nw[2] * d[2]

    # photometric: r = I_a - I_b(pi(h)); its row is -[p x c, c] for c = R_b (g^T dpi/dh)
    rc = caches.intensity.reshape(n, m)[pa] - ib
    color_ok = (depth_ok & (torch.abs(rc) < cfg.dense_color_thresh)
                & (torch.sqrt(gx * gx + gy * gy) > cfg.dense_color_grad_min))
    zz = zs * zs
    c = [gx * (zs.new_full((), cam.fx) / zs), gy * (zs.new_full((), cam.fy) / zs),
         gx * ((-cam.fx) * x / zz) + gy * ((-cam.fy) * y / zz)]
    e = [-rot(rb, *c, i) for i in range(3)]
    (D, dd), (C, cc) = _k6_row(pw, nw, weight_depth, rd, depth_ok), _k6_row(pw, e, weight_color, rc, color_ok)
    return torch.cat([D, C, dd[..., None], cc[..., None]], -1), depth_ok, color_ok


def _k6_sum(T: torch.Tensor, splits: int, rows: int) -> torch.Tensor:
    """Sum the per-pixel terms [P, M, E] over M in K6's order: thread t of
    split s adds, for row r = 0, 1, ..., pixel (s * rows + r) *
    _K6_THREADS + t's terms to its sums (from +0.0); each warp's 32 sums
    and then the warps' sums are halved in turn (lane i + lane i + off,
    off = 16, ..., 1, then _K6_WARPS / 2, ..., 1); the splits' sums are
    added in order."""
    p, m, e = T.shape
    pad = splits * rows * _K6_THREADS - m
    T = torch.nn.functional.pad(T, (0, 0, 0, pad)).reshape(p, splits, rows, _K6_THREADS, e)
    acc = T.new_zeros((p, splits, _K6_THREADS, e))
    for r in range(rows):
        acc = acc + T[:, :, r]
    acc = acc.reshape(p, splits, _K6_WARPS, 32, e)
    for width in (32, _K6_WARPS):
        off = width // 2
        while off:
            acc = acc[..., :off, :] + acc[..., off:2 * off, :]
            off //= 2
        acc = acc[..., 0, :]
    out = acc.new_zeros((p, e))
    for s in range(splits):
        out = out + acc[:, s]
    return out


def _k6_blocks(sums: torch.Tensor, n_depth, n_color, active):
    """(JtJ [P, 12, 12], Jtr [P, 12], stats) from each pair's sums: H and g
    the depth row's plus the colour row's, JtJ = [[H, -H], [-H, H]], Jtr =
    [g, -g]; zeros where ``active`` is false."""
    upper = {ij: k for k, ij in enumerate(_UPPER)}
    hg = sums[:, :_K6_ROW] + sums[:, _K6_ROW:2 * _K6_ROW]
    H = torch.stack([torch.stack([hg[:, upper[min(i, j), max(i, j)]] for j in range(6)], -1) for i in range(6)], -2)
    g = hg[:, 21:27]
    JtJ = torch.cat([torch.cat([H, -H], -1), torch.cat([-H, H], -1)], -2)
    Jtr = torch.cat([g, -g], -1)
    return (
        torch.where(active[:, None, None], JtJ, 0.0),
        torch.where(active[:, None], Jtr, 0.0),
        DenseStats(torch.where(active, n_depth, 0), torch.where(active, n_color, 0),
                   torch.where(active, sums[:, -2], 0.0), torch.where(active, sums[:, -1], 0.0)),
    )


def _dense_pair_blocks_torch(poses, pairs_a, pairs_b, pair_active, caches: FrameCache, cache_cam: CameraModel,
                             cfg: BundlingConfig, weight_depth: float, weight_color: float):
    """K6's twin: :func:`dense_pair_blocks` in the kernel's arithmetic and
    summing order, every slot computed and the ones not active zeroed."""
    p = pairs_a.shape[0]
    n, h, w = caches.depth.shape
    splits, rows = _k6_grid(p, h * w)
    table = torch.cat([caches.depth[..., None], caches.normals, caches.points, caches.intensity[..., None],
                       caches.grad], -1).reshape(n * h * w, 10)
    sums, counts = [poses.new_zeros((0, _K6_SUMS))], [torch.zeros((0, 2), dtype=torch.int32, device=poses.device)]
    for lo in range(0, p, _K6_TWIN_PAIRS):
        pa, pb = (x[lo:lo + _K6_TWIN_PAIRS].long() for x in (pairs_a, pairs_b))
        T, depth_ok, color_ok = _k6_pixel_rows(poses, pa, pb, caches, table, cache_cam, cfg, weight_depth,
                                               weight_color)
        sums.append(_k6_sum(T, splits, rows))
        counts.append(torch.stack([depth_ok.sum(-1), color_ok.sum(-1)], -1).to(torch.int32))
    counts = torch.cat(counts)
    return _k6_blocks(torch.cat(sums), counts[:, 0], counts[:, 1], pair_active)


@kernels.counted
def dense_pair_blocks(poses, pairs_a, pairs_b, pair_active, caches: FrameCache, cache_cam: CameraModel,
                      cfg: BundlingConfig, weight_depth: float, weight_color: float):
    """Kernel K6: the dense point-to-plane and photometric normal-equation
    blocks of every slot of a dense-pair list, a's cached pixels
    projectively associated into b: (JtJ [P, 12, 12], Jtr [P, 12], stats),
    zero where ``pair_active`` is false. The caches are read in place by
    the pairs' keyframe indices. CUDA tensors launch the kernel (bit-equal
    to the twin on the card); CPU tensors run the twin,
    :func:`_dense_pair_blocks_torch`."""
    if not poses.is_cuda:
        return _dense_pair_blocks_torch(poses, pairs_a, pairs_b, pair_active, caches, cache_cam, cfg, weight_depth,
                                        weight_color)
    p = pairs_a.shape[0]
    n, h, w = caches.depth.shape
    if pairs_a.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"pairs_a: expected int32 or int64, got {pairs_a.dtype}")
    poses, pairs_a, pairs_b, pair_active = (x.contiguous() for x in (poses, pairs_a, pairs_b, pair_active))
    fields = [x.contiguous() for x in (caches.depth, caches.points, caches.normals, caches.intensity, caches.grad)]
    kernels.require(poses, "poses", torch.float32, (poses.shape[0], 4, 4))
    kernels.require(pairs_a, "pairs_a", pairs_a.dtype, (p,))
    kernels.require(pairs_b, "pairs_b", pairs_a.dtype, (p,))
    kernels.require(pair_active, "pair_active", torch.bool, (p,))
    for name, t, c in zip(("depth", "points", "normals", "intensity", "grad"), fields, (0, 3, 3, 0, 2)):
        kernels.require(t, name, torch.float32, (n, h, w, c) if c else (n, h, w))
    dev = poses.device
    JtJ = torch.empty((p, 12, 12), dtype=torch.float32, device=dev)
    Jtr = torch.empty((p, 12), dtype=torch.float32, device=dev)
    n_depth, n_color = (torch.empty(p, dtype=torch.int32, device=dev) for _ in range(2))
    ss_depth, ss_color = (torch.empty(p, dtype=torch.float32, device=dev) for _ in range(2))
    stats = DenseStats(n_depth, n_color, ss_depth, ss_color)
    if p == 0:
        return JtJ, Jtr, stats
    splits, rows = _k6_grid(p, h * w)
    partial = torch.empty((p, splits, _K6_SUMS + 2), dtype=torch.float32, device=dev)
    err = kernels.library().bf_dense_pairs(
        poses.data_ptr(), pairs_a.data_ptr(), pairs_b.data_ptr(), int(pairs_a.dtype == torch.int64),
        pair_active.data_ptr(), *(t.data_ptr() for t in fields), partial.data_ptr(), JtJ.data_ptr(), Jtr.data_ptr(),
        n_depth.data_ptr(), n_color.data_ptr(), ss_depth.data_ptr(), ss_color.data_ptr(), p, splits, rows, h, w,
        cache_cam.fx, cache_cam.fy, cache_cam.cx, cache_cam.cy, cache_cam.width - 1.0, cache_cam.height - 1.0,
        w - 1.0 + 1e-4, h - 1.0 + 1e-4, w - 1.001, h - 1.001, cfg.dense_dist_thresh, cfg.dense_normal_thresh, cfg.dense_color_thresh,
        cfg.dense_color_grad_min, weight_depth, weight_color, kernels.stream_ptr(dev),
    )
    kernels.check(err, "dense_pairs")
    kernels.launched(dense_pair_blocks)
    return JtJ, Jtr, stats
