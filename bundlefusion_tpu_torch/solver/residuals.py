"""Residuals and hand Jacobians for sparse+dense bundle adjustment
(port of ``bundlefusion_tpu.solver.residuals``).

Convention: pose T maps camera points to world; the GN update perturbs on
the left, T' = exp(xi) T with twist xi = (omega, upsilon). For a world point
p = T p_cam the derivative is d p / d xi = [ -hat(p) | I3 ] (3x6). Each term
contributes a 12-column block ([6 for pose a | 6 for pose b]).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import BundlingConfig
from ..geometry import se3
from ..geometry.camera import CameraModel, project
from ..ops.preprocess import FrameCache, bilinear_sample_gather


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


def _dense_pair_system(Ta, Tb, cache_a: FrameCache, cache_b: FrameCache, cam: CameraModel,
                       cfg: BundlingConfig, weight_depth: float, weight_color: float):
    """Dense point-to-plane depth + photometric normal equations for a batch
    of pairs [P]: projective association of a's cached pixels into b."""
    p = Ta.shape[0]
    pts_a = cache_a.points.reshape(p, -1, 3)
    valid_a = cache_a.depth.reshape(p, -1) > 0.0

    Tb_inv = se3.mat_inverse(Tb)
    Rb_inv = Tb_inv[:, :3, :3]
    p_aw = se3.transform_points(Ta, pts_a)
    p_in_b = se3.transform_points(Tb_inv, p_aw)
    uv, proj_ok = project(cam, p_in_b)

    stack_b = torch.cat(
        [cache_b.points, cache_b.normals, cache_b.intensity[..., None], cache_b.grad, cache_b.depth[..., None]],
        dim=-1,
    )
    # the matmul form's [P, M, W, C] product does not fit the card at the
    # global solve's P (every slot of the dense-pair list)
    samp, inb = bilinear_sample_gather(stack_b, uv)
    q_b = samp[..., 0:3]
    n_b = samp[..., 3:6]
    i_b = samp[..., 6]
    g_b = samp[..., 7:9]
    d_b = samp[..., 9]

    n_b_norm = torch.linalg.vector_norm(n_b, dim=-1, keepdim=True)
    n_b = n_b / torch.clamp(n_b_norm, min=1e-9)
    q_w = se3.transform_points(Tb, q_b)
    n_w = se3.rotate_vectors(Tb, n_b)

    diff = p_aw - q_w
    dist = torch.linalg.vector_norm(diff, dim=-1)
    n_a_w = se3.rotate_vectors(Ta, cache_a.normals.reshape(p, -1, 3))
    ndot = torch.sum(n_a_w * n_w, dim=-1)
    assoc_ok = (
        valid_a & proj_ok & inb & (d_b > 0.0) & (n_b_norm[..., 0] > 0.5)
        & (dist < cfg.dense_dist_thresh) & (ndot > cfg.dense_normal_thresh)
    )

    # depth point-to-plane: r = n_w . (p_aw - q_w)
    r_d = torch.sum(n_w * diff, dim=-1)
    Jd_a = torch.cat([torch.linalg.cross(p_aw, n_w, dim=-1), n_w], dim=-1)
    Jd_b = torch.cat(
        [torch.linalg.cross(n_w, diff, dim=-1) - torch.linalg.cross(q_w, n_w, dim=-1), -n_w], dim=-1
    )
    J_d = torch.cat([Jd_a, Jd_b], dim=-1)  # [P, M, 12]
    w_d = torch.where(assoc_ok, weight_depth, 0.0)

    # photometric: r = I_a - I_b(pi(h)), h = p_in_b
    i_a = cache_a.intensity.reshape(p, -1)
    r_c = i_a - i_b
    z = torch.clamp(p_in_b[..., 2], min=1e-6)
    zero = torch.zeros_like(z)
    dpi = torch.stack(
        [
            torch.stack([cam.fx / z, zero, -cam.fx * p_in_b[..., 0] / (z * z)], dim=-1),
            torch.stack([zero, cam.fy / z, -cam.fy * p_in_b[..., 1] / (z * z)], dim=-1),
        ],
        dim=-2,
    )  # [P, M, 2, 3]
    dh_da = torch.einsum("pij,pmjk->pmik", Rb_inv, point_jacobian(p_aw))  # [P, M, 3, 6]
    g_dpi = torch.einsum("pmc,pmck->pmk", g_b, dpi)
    Jc_a = -torch.einsum("pmk,pmkj->pmj", g_dpi, dh_da)
    J_c = torch.cat([Jc_a, -Jc_a], dim=-1)
    grad_mag = torch.linalg.vector_norm(g_b, dim=-1)
    color_ok = assoc_ok & (torch.abs(r_c) < cfg.dense_color_thresh) & (grad_mag > cfg.dense_color_grad_min)
    w_c = torch.where(color_ok, weight_color, 0.0)

    JtJ = torch.einsum("pmi,pm,pmj->pij", J_d, w_d, J_d) + torch.einsum("pmi,pm,pmj->pij", J_c, w_c, J_c)
    Jtr = torch.einsum("pmi,pm->pi", J_d, w_d * r_d) + torch.einsum("pmi,pm->pi", J_c, w_c * r_c)
    stats = DenseStats(
        num_valid_depth=torch.sum(assoc_ok, dim=-1).to(torch.int32),
        num_valid_color=torch.sum(color_ok, dim=-1).to(torch.int32),
        sum_sq_depth=torch.sum(torch.where(assoc_ok, r_d * r_d, 0.0), dim=-1),
        sum_sq_color=torch.sum(torch.where(color_ok, r_c * r_c, 0.0), dim=-1),
    )
    return JtJ, Jtr, stats


def dense_pair_blocks(poses, pairs_a, pairs_b, pair_active, caches: FrameCache, cache_cam: CameraModel,
                      cfg: BundlingConfig, weight_depth: float, weight_color: float):
    """Dense normal-equation blocks for every active pair:
    (JtJ [P,12,12], Jtr [P,12], stats)."""
    pa, pb = pairs_a.long(), pairs_b.long()
    JtJ, Jtr, stats = _dense_pair_system(
        poses[pa], poses[pb], caches.index(pa), caches.index(pb), cache_cam, cfg, weight_depth, weight_color
    )
    act = pair_active.to(JtJ.dtype)
    return (
        JtJ * act[:, None, None],
        Jtr * act[:, None],
        DenseStats(
            stats.num_valid_depth * pair_active,
            stats.num_valid_color * pair_active,
            stats.sum_sq_depth * act,
            stats.sum_sq_color * act,
        ),
    )
