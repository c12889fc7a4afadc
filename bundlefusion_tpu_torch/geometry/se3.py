"""SE(3) / SO(3) math for pose optimization (port of ``bundlefusion_tpu.geometry.se3``).

Poses are ``[..., 4, 4]`` float32 matrices for composition and ``[..., 6]``
se(3) twists (omega, upsilon) for solver updates. Every function broadcasts
over leading axes. Taylor fallbacks near theta=0 keep exp/log finite and
differentiable (the ``torch.func`` Jacobian tests rely on it).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: [..., 3, 3] -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    # theta < 1e-4; the sqrt only ever sees safe values, so reverse-mode
    # autodiff stays finite at w = 0
    small = theta2 < 1e-8
    safe_theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe_theta2)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_theta2)
    W = hat(w)
    W2 = W @ W
    return _eye(3, w) + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    # atan2 form: |v| = 2 sin(theta); well-conditioned except at theta = pi,
    # which the diagonal branch below handles
    sin_theta = 0.5 * torch.linalg.vector_norm(v, dim=-1)
    theta = torch.atan2(sin_theta, cos_theta)
    small = theta < 1e-4
    near_pi = theta > math.pi - 1e-3
    scale = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / torch.clamp(2.0 * sin_theta, min=_EPS),
    )
    w_generic = scale[..., None] * v
    # near pi: axis from the largest diagonal of (R + I) / 2
    B = (R + _eye(3, R)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    idx = k[..., None, None].expand(*B.shape[:-1], 1)
    cols = torch.take_along_dim(B, idx, dim=-1)[..., 0]
    axis = cols / torch.clamp(torch.linalg.vector_norm(cols, dim=-1, keepdim=True), min=_EPS)
    sign = torch.where(torch.sum(axis * v, dim=-1) < 0.0, -1.0, 1.0)
    w_pi = theta[..., None] * sign[..., None] * axis
    return torch.where(near_pi[..., None], w_pi, w_generic)


def _so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J of SO(3): exp((w+dw)^) ~ exp(dw_l^) exp(w^) with dw_l = J dw."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8  # theta < 1e-4, autodiff-safe as in so3_exp
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_t = torch.sqrt(safe_t2)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe_t)) / safe_t2)
    c = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (safe_t - torch.sin(safe_t)) / (safe_t2 * safe_t),
    )
    W = hat(w)
    W2 = W @ W
    return _eye(3, w) + b[..., None, None] * W + c[..., None, None] * W2


def _so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    small = theta < 1e-4
    half = theta * 0.5
    cot = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS))
        / torch.where(small, torch.ones_like(theta2), theta2),
    )
    W = hat(w)
    W2 = W @ W
    return _eye(3, w) - 0.5 * W + cot[..., None, None] * W2


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) twist [..., 6] (omega, upsilon) -> [..., 4, 4] rigid transform."""
    w, u = xi[..., :3], xi[..., 3:]
    R = so3_exp(w)
    J = _so3_left_jacobian(w)
    t = torch.einsum("...ij,...j->...i", J, u)
    return rt_to_mat(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] rigid transform -> se(3) twist [..., 6]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    Jinv = _so3_left_jacobian_inv(w)
    u = torch.einsum("...ij,...j->...i", Jinv, t)
    return torch.cat([w, u], dim=-1)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation + [..., 3] translation -> [..., 4, 4]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    # [0, 0, 0, 1] made on the device (a tensor from Python data would be a
    # host->device copy, and a sync, on every call)
    bottom = torch.cat(
        [torch.zeros(*batch, 1, 3, dtype=R.dtype, device=R.device),
         torch.ones(*batch, 1, 1, dtype=R.dtype, device=R.device)],
        dim=-1,
    )
    return torch.cat([top, bottom], dim=-2)


def mat_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid transform [..., 4, 4]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply rigid transform(s) [..., 4, 4] to points [..., N, 3] or [..., 3]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if p.dim() == T.dim() - 1:  # [..., 3]
        return torch.einsum("...ij,...j->...i", R, p) + t
    return torch.einsum("...ij,...nj->...ni", R, p) + t[..., None, :]


def rotate_vectors(T: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Apply only the rotation part of [..., 4, 4] to vectors (for normals)."""
    R = T[..., :3, :3]
    if v.dim() == T.dim() - 1:
        return torch.einsum("...ij,...j->...i", R, v)
    return torch.einsum("...ij,...nj->...ni", R, v)


def pose_distance(Ta: torch.Tensor, Tb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rotation angle [rad], translation distance) between two rigid transforms."""
    dR = torch.einsum("...ij,...kj->...ik", Ta[..., :3, :3], Tb[..., :3, :3])
    trace = dR[..., 0, 0] + dR[..., 1, 1] + dR[..., 2, 2]
    angle = torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))
    dist = torch.linalg.vector_norm(Ta[..., :3, 3] - Tb[..., :3, 3], dim=-1)
    return angle, dist


def kabsch(
    src: torch.Tensor,
    dst: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Weighted rigid alignment: T with dst ~= T @ src, batched over leading axes.

    Horn's quaternion method with the top eigenvector of the 4x4 matrix found
    by repeated squaring (12 squarings ~ 4096 power steps), exactly as the
    JAX package computes it: fixed-count, branch-free arithmetic.
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wsum = torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=_EPS)
    wn = weights / wsum
    mu_s = torch.einsum("...n,...ni->...i", wn, src)
    mu_d = torch.einsum("...n,...ni->...i", wn, dst)
    s = src - mu_s[..., None, :]
    d = dst - mu_d[..., None, :]
    H = torch.einsum("...ni,...n,...nj->...ij", s, wn, d)
    Sxx, Sxy, Sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    Syx, Syy, Syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    Szx, Szy, Szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    N = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        -2,
    )

    def _frob(M):
        return torch.sqrt(torch.sum(M * M, dim=(-2, -1), keepdim=True))

    sig = _frob(N)
    M = N + sig * _eye(4, N)
    M = M / torch.clamp(_frob(M), min=_EPS)
    for _ in range(12):
        M = torch.einsum("...ij,...jk->...ik", M, M)
        M = M / torch.clamp(_frob(M), min=_EPS)
    q = torch.einsum("...ij,...j->...i", M, torch.ones(N.shape[:-1], dtype=N.dtype, device=N.device))
    q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)], -1),
            torch.stack([2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)], -1),
            torch.stack([2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)], -1),
        ],
        -2,
    )
    t = mu_d - torch.einsum("...ij,...j->...i", R, mu_s)
    return rt_to_mat(R, t)


def umeyama_alignment(src: torch.Tensor, dst: torch.Tensor, with_scale: bool = False):
    """Umeyama/Horn alignment: (scale, R, t) with dst ~= scale * R @ src + t."""
    n = src.shape[0]
    mu_s = torch.mean(src, dim=0)
    mu_d = torch.mean(dst, dim=0)
    s = src - mu_s
    d = dst - mu_d
    cov = (d.T @ s) / n
    U, S, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    D = torch.diag(torch.stack([torch.ones_like(det), torch.ones_like(det), torch.sign(det)]))
    R = U @ D @ Vt
    if with_scale:
        var_s = torch.mean(torch.sum(s * s, dim=-1))
        scale = torch.trace(torch.diag(S) @ D) / torch.clamp(var_s, min=_EPS)
    else:
        scale = torch.ones((), dtype=src.dtype, device=src.device)
    t = mu_d - scale * (R @ mu_s)
    return scale, R, t
