"""Plain reference of BundleFusion's global bundle adjustment with its dense
terms (Dai et al., BundleFusion, ACM TOG 36(4), 2017, section 4): the
energy of keyframe poses is a sparse term over 3D feature correspondences
plus, for each listed pair of keyframes (a, b), a dense geometric term
(point-to-plane) and a dense photometric term over a's pixels of the
low-resolution frame cache, projectively associated into b.

Plain PyTorch in float64, written from that description: no kernel, no
batching beyond a block of pairs, nothing from the program. Conventions,
the ones the configuration's numbers are stated in:

* a pose T maps camera points to world; a GN update perturbs it on the
  left, T' = exp(xi) T, xi = (omega, upsilon);
* a cache frame holds depth (0 invalid), camera-space points and normals,
  intensity and its image gradient (d/du, d/dv) at every pixel; pixel
  (u, v) has its centre at (u, v); the camera is the cache's pinhole;
* for a pixel x of a with depth: p = T_a p_a(x) in the world,
  h = T_b^-1 p in b's camera, (u, v) = pi(h); b's cache is sampled
  bilinearly at (u, v) (every channel, depth included) when h lies in
  front of b and (u, v) inside [0, w-1] x [0, h-1];
* geometric residual r_d = n_b^w . (p - q_b^w), with q_b and the sampled
  normal n_b (normalised) carried to the world by T_b; photometric
  residual r_c = I_a(x) - I_b(u, v).

Departures from the paper, each from the configuration (the reference
implementation's parameters as the program records them) rather than from
the paper's equations:

1. Association tests: a pixel enters the geometric term only if b's
   sampled depth is positive, the sampled normal's length exceeds 0.5
   before normalising, |p - q_b^w| < ``dense_dist_thresh`` and
   (R_a n_a) . n_b^w > ``dense_normal_thresh``; it enters the photometric
   term only if it passes those, |r_c| < ``dense_color_thresh`` and the
   sampled gradient's length exceeds ``dense_color_grad_min``.
2. Weights: every associated pixel weighs ``weight_dense_depth`` or
   ``weight_dense_color`` (no robust kernel, no per-pixel weighting), both
   scaled in GN iteration i of n by (i + 1) / n with
   ``dense_weight_ramp`` (1 otherwise, and when n is 1).
3. One direction per listed pair: a's pixels into b (the pair list holds
   each pair once).
4. The sampled quantities of b are constants of the linearisation (as in
   projective ICP); only the photometric term differentiates I_b through
   the projection, with the sampled gradient.
5. The photometric term is on the cache's intensity (the program smooths
   it before the gradient); the repository holds no copy of the reference
   implementation to check whether it uses another image.
6. The GN step is solved exactly (Cholesky of the free poses' block), where
   the program runs a fixed number of preconditioned CG iterations with a
   small damping; keyframes not free (the gauge, keyframe 0, and invalid
   ones) do not move.
"""

from __future__ import annotations

import torch

DTYPE = torch.float64


class Cache:
    """Frame caches of a batch [B]: depth [B, h, w], points and normals
    [B, h, w, 3], intensity [B, h, w], gradient [B, h, w, 2]."""

    def __init__(self, depth, points, normals, intensity, grad):
        self.depth, self.points, self.normals, self.intensity, self.grad = depth, points, normals, intensity, grad

    def take(self, idx) -> "Cache":
        return Cache(*(getattr(self, f)[idx].to(DTYPE) for f in ("depth", "points", "normals", "intensity", "grad")))


class Camera:
    """The cache's pinhole: focal lengths, principal point, size."""

    def __init__(self, fx, fy, cx, cy, width, height):
        self.fx, self.fy, self.cx, self.cy, self.width, self.height = fx, fy, cx, cy, width, height


class Params:
    """The dense terms' settings of a configuration's ``bundling``."""

    def __init__(self, bundling: dict):
        b = bundling
        self.dist_thresh, self.normal_thresh = b["dense_dist_thresh"], b["dense_normal_thresh"]
        self.color_thresh, self.color_grad_min = b["dense_color_thresh"], b["dense_color_grad_min"]
        self.weight_depth, self.weight_color = b["weight_dense_depth"], b["weight_dense_color"]
        self.weight_sparse, self.weight_ramp = b["weight_sparse"], b["dense_weight_ramp"]

    def scale(self, i: int, n: int) -> float:
        """The dense weights' factor in GN iteration ``i`` of ``n``."""
        return (i + 1) / n if self.weight_ramp and n > 1 else 1.0


class PairTerms:
    """Each pair's normal-equation block over (xi_a, xi_b), JtJ [B, 12, 12]
    and Jtr [B, 12], and its counts of pixels in the geometric and in the
    photometric term, n_depth and n_color [B]."""

    def __init__(self, JtJ, Jtr, n_depth, n_color):
        self.JtJ, self.Jtr, self.n_depth, self.n_color = JtJ, Jtr, n_depth, n_color


def hat(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] with hat(v) w = v x w."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def transform(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """T [B, 4, 4] applied to points [B, M, 3]."""
    return p @ T[:, :3, :3].transpose(1, 2) + T[:, None, :3, 3]


def rotate(T: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return v @ T[:, :3, :3].transpose(1, 2)


def inverse(T: torch.Tensor) -> torch.Tensor:
    R_t = T[:, :3, :3].transpose(1, 2)
    out = torch.zeros_like(T)
    out[:, :3, :3] = R_t
    out[:, :3, 3] = -(R_t @ T[:, :3, 3:])[..., 0]
    out[:, 3, 3] = 1.0
    return out


def bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """img [B, h, w, C] at (u, v) [B, M] inside [0, w-1] x [0, h-1] ->
    [B, M, C]: the four neighbours' tent-weighted sum."""
    b, h, w, c = img.shape
    x0 = torch.clamp(torch.floor(u), 0, w - 2)
    y0 = torch.clamp(torch.floor(v), 0, h - 2)
    fx, fy = (u - x0)[..., None], (v - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = img.reshape(b, h * w, c)

    def at(yy, xx):
        return torch.gather(flat, 1, (yy * w + xx)[..., None].expand(-1, -1, c))

    return ((1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x0 + 1))
            + fy * ((1 - fx) * at(y0 + 1, x0) + fx * at(y0 + 1, x0 + 1)))


def pair_terms(Ta: torch.Tensor, Tb: torch.Tensor, a: Cache, b: Cache, cam: Camera, prm: Params,
               scale: float = 1.0) -> PairTerms:
    """The dense terms of pairs (a, b) [B] at poses Ta, Tb [B, 4, 4], with
    the dense weights times ``scale``."""
    Ta, Tb = Ta.to(DTYPE), Tb.to(DTYPE)
    B = Ta.shape[0]
    pa = a.points.reshape(B, -1, 3)
    has_depth = a.depth.reshape(B, -1) > 0
    p = transform(Ta, pa)  # a's pixels in the world
    h = transform(inverse(Tb), p)  # ... in b's camera
    z = h[..., 2]
    zs = torch.where(z > 0, z, torch.ones_like(z))
    u = cam.fx * h[..., 0] / zs + cam.cx
    v = cam.fy * h[..., 1] / zs + cam.cy
    seen = has_depth & (z > 0) & (u >= 0) & (u <= cam.width - 1) & (v >= 0) & (v <= cam.height - 1)
    uc = torch.clamp(torch.nan_to_num(u), 0, cam.width - 1)
    vc = torch.clamp(torch.nan_to_num(v), 0, cam.height - 1)
    stack = torch.cat([b.points, b.normals, b.intensity[..., None], b.grad, b.depth[..., None]], -1)
    s = bilinear(stack, uc, vc)
    q_b, n_raw, i_b, g_b, d_b = s[..., 0:3], s[..., 3:6], s[..., 6], s[..., 7:9], s[..., 9]
    n_len = torch.linalg.vector_norm(n_raw, dim=-1)
    n_b = n_raw / torch.clamp(n_len, min=1e-12)[..., None]
    q = transform(Tb, q_b)
    n = rotate(Tb, n_b)
    diff = p - q
    n_a = rotate(Ta, a.normals.reshape(B, -1, 3))
    geo = (seen & (d_b > 0) & (n_len > 0.5) & (torch.linalg.vector_norm(diff, dim=-1) < prm.dist_thresh)
           & ((n_a * n).sum(-1) > prm.normal_thresh))
    r_d = (n * diff).sum(-1)
    # d r_d / d xi_a = [p x n, n]; d r_d / d xi_b = [n x (p - q) - q x n, -n]
    J_d = torch.cat([torch.linalg.cross(p, n, dim=-1), n,
                     torch.linalg.cross(n, diff, dim=-1) - torch.linalg.cross(q, n, dim=-1), -n], -1)

    r_c = a.intensity.reshape(B, -1) - i_b
    # d h / d xi_a = R_b^T [-hat(p) | I]; d h / d xi_b = -(the same); d pi / d h at h
    dh = torch.cat([-hat(p), torch.eye(3, dtype=DTYPE, device=p.device).expand(*p.shape[:-1], 3, 3)], -1)
    dh = Tb[:, None, :3, :3].transpose(-1, -2) @ dh  # [B, M, 3, 6]
    dpi = torch.zeros(*p.shape[:-1], 2, 3, dtype=DTYPE, device=p.device)
    dpi[..., 0, 0] = cam.fx / zs
    dpi[..., 0, 2] = -cam.fx * h[..., 0] / zs**2
    dpi[..., 1, 1] = cam.fy / zs
    dpi[..., 1, 2] = -cam.fy * h[..., 1] / zs**2
    Jc_a = -(g_b[..., None, :] @ dpi @ dh)[..., 0, :]  # [B, M, 6]
    J_c = torch.cat([Jc_a, -Jc_a], -1)
    col = geo & (r_c.abs() < prm.color_thresh) & (torch.linalg.vector_norm(g_b, dim=-1) > prm.color_grad_min)

    w_d = geo.to(DTYPE) * (prm.weight_depth * scale)
    w_c = col.to(DTYPE) * (prm.weight_color * scale)
    JtJ = (J_d * w_d[..., None]).transpose(1, 2) @ J_d + (J_c * w_c[..., None]).transpose(1, 2) @ J_c
    Jtr = ((J_d * (w_d * r_d)[..., None]) + (J_c * (w_c * r_c)[..., None])).sum(1)
    return PairTerms(JtJ, Jtr, geo.sum(-1), col.sum(-1))


def pairs_in_blocks(poses: torch.Tensor, pairs_a: torch.Tensor, pairs_b: torch.Tensor, caches: Cache, cam: Camera,
                    prm: Params, scale: float = 1.0, block: int = 128, device=None) -> PairTerms:
    """:func:`pair_terms` of every listed pair, ``block`` pairs at a time on
    ``device`` (default the caches'), gathered on the host in float64."""
    out = []
    for lo in range(0, pairs_a.shape[0], block):
        ia, ib = pairs_a[lo:lo + block].long(), pairs_b[lo:lo + block].long()
        a, b = caches.take(ia), caches.take(ib)
        if device is not None:
            a, b = (Cache(*(getattr(c, f).to(device) for f in ("depth", "points", "normals", "intensity", "grad")))
                    for c in (a, b))
        t = pair_terms(poses[ia].to(a.depth.device), poses[ib].to(a.depth.device), a, b, cam, prm, scale)
        out.append([x.cpu() for x in (t.JtJ, t.Jtr, t.n_depth, t.n_color)])
    return PairTerms(*(torch.cat(x) for x in zip(*out)))


def sparse_terms(poses: torch.Tensor, img_a, img_b, p_a, p_b, weight, weight_sparse: float):
    """Correspondences' blocks: r = T_a p_a - T_b p_b (3 rows), weighted
    ``weight * weight_sparse``; (JtJ [R, 12, 12], Jtr [R, 12])."""
    poses = poses.to(DTYPE)
    Ta, Tb = poses[img_a.long()], poses[img_b.long()]
    pa = (Ta[:, :3, :3] @ p_a.to(DTYPE)[..., None])[..., 0] + Ta[:, :3, 3]
    pb = (Tb[:, :3, :3] @ p_b.to(DTYPE)[..., None])[..., 0] + Tb[:, :3, 3]
    eye = torch.eye(3, dtype=DTYPE).expand(pa.shape[0], 3, 3)
    J = torch.cat([-hat(pa), eye, hat(pb), -eye], -1)  # [R, 3, 12]
    w = (weight.to(DTYPE) * weight_sparse)[:, None, None]
    return (J * w).transpose(1, 2) @ J, ((J * w).transpose(1, 2) @ (pa - pb)[..., None])[..., 0]


def assemble(n: int, ia, ib, JtJ, Jtr):
    """Sum pair blocks into the gradient system (H [6n, 6n], g [6n])."""
    H = torch.zeros(n, n, 6, 6, dtype=DTYPE)
    g = torch.zeros(n, 6, dtype=DTYPE)
    ia, ib = ia.long(), ib.long()
    for (x, xs), (y, ys) in (((ia, 0), (ia, 0)), ((ia, 0), (ib, 6)), ((ib, 6), (ia, 0)), ((ib, 6), (ib, 6))):
        H.index_put_((x, y), JtJ[:, xs:xs + 6, ys:ys + 6].to(DTYPE), accumulate=True)
    g.index_put_((ia,), Jtr[:, :6].to(DTYPE), accumulate=True)
    g.index_put_((ib,), Jtr[:, 6:].to(DTYPE), accumulate=True)
    return H.permute(0, 2, 1, 3).reshape(6 * n, 6 * n), g.reshape(-1)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(omega, upsilon) [N, 6] -> [N, 4, 4]: rotation by Rodrigues' formula,
    translation V upsilon with V the left Jacobian of SO(3)."""
    w, u = xi[:, :3], xi[:, 3:]
    th = torch.linalg.vector_norm(w, dim=-1)[:, None, None]
    K = hat(w)
    small = th < 1e-8
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1 - th**2 / 6, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th**2 / 24, (1 - torch.cos(ths)) / ths**2)
    c = torch.where(small, 1.0 / 6 - th**2 / 120, (ths - torch.sin(ths)) / ths**3)
    eye = torch.eye(3, dtype=DTYPE).expand_as(K)
    R = eye + a * K + b * (K @ K)
    V = eye + b * K + c * (K @ K)
    T = torch.zeros(xi.shape[0], 4, 4, dtype=DTYPE)
    T[:, :3, :3], T[:, :3, 3], T[:, 3, 3] = R, (V @ u[..., None])[..., 0], 1.0
    return T


def gn_step(poses, free, sparse: tuple, pairs: tuple, caches: Cache, cam: Camera, prm: Params, i: int = 0,
            n_iters: int = 1) -> torch.Tensor:
    """One Gauss-Newton step of the global energy, solved exactly: the
    sparse blocks of ``sparse`` (img_a, img_b, p_a, p_b, weight) and the
    dense blocks of the live pairs of ``pairs`` (a, b, live) at the weights
    of iteration ``i`` of ``n_iters``, assembled, and the free poses'
    block solved by Cholesky; each free pose moves by exp(dx) on the left.
    Returns the poses [N, 4, 4] in float64."""
    poses = poses.to(DTYPE)
    n = poses.shape[0]
    sJ, sr = sparse_terms(poses, *sparse, prm.weight_sparse)
    pa, pb, live = pairs
    keep = live.bool()
    d = pairs_in_blocks(poses, pa[keep], pb[keep], caches, cam, prm, prm.scale(i, n_iters))
    H, g = assemble(n, torch.cat([sparse[0].long(), pa[keep].long()]), torch.cat([sparse[1].long(), pb[keep].long()]),
                    torch.cat([sJ, d.JtJ]), torch.cat([sr, d.Jtr]))
    f = torch.repeat_interleave(free.bool(), 6)
    dx = torch.zeros(6 * n, dtype=DTYPE)
    L = torch.linalg.cholesky(H[f][:, f])
    dx[f] = torch.cholesky_solve(-g[f][:, None], L)[:, 0]
    new = se3_exp(dx.reshape(n, 6)) @ poses
    return torch.where(free.bool()[:, None, None], new, poses)
