"""The plain reference of the fused model: a projective TSDF of the scan's
frames at given poses (the judge gives the trajectory the program
published), evaluated at given voxel centres.

It follows the configuration's stated rule and nothing of the program's
code: a voxel centre p seen by frame f at camera point (x, y, z) projects to
pixel (round(u), round(v)) with u = x / z * fx + cx and v = y / z * fy + cy
inside the image; with that pixel's depth d in (0, max_integration_distance)
and the truncation tr = truncation + truncation_scale * d, the frame updates
p when d - z > -tr, with the sample clamp(d - z, -tr, tr) and weight 1, as a
running mean whose weight stops at max_integration_weight (the later frames
then move the mean by 1 / (cap + 1) each). Frames fuse in scan order.

Everything runs in the ``dtype`` it is given: float32 for the reference,
bfloat16 for the control. The camera transform is written as multiply-adds,
not a matrix product, so no TF32 path can enter it. Plain PyTorch; imports
nothing of the program and nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def world_to_camera(c2w: torch.Tensor) -> torch.Tensor:
    """[N, 4, 4] camera-to-world -> [N, 3, 4] world-to-camera (R^T | -R^T t)
    in the tensor's dtype."""
    rt = c2w[:, :3, :3].transpose(1, 2)
    t = c2w[:, :3, 3]
    tt = -(rt[:, :, 0] * t[:, None, 0] + rt[:, :, 1] * t[:, None, 1] + rt[:, :, 2] * t[:, None, 2])
    return torch.cat([rt, tt[:, :, None]], dim=2)


def fuse(points: np.ndarray, depth: np.ndarray, c2w: np.ndarray, intrinsics, app: dict, dtype, device,
         batch: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """The TSDF (sdf [V] metres, weight [V]) at world ``points`` [V, 3] of
    the frames ``depth`` [N, H, W] (metres, 0 invalid) at camera-to-world
    ``c2w`` [N, 4, 4], fused in order; computed in ``dtype`` on ``device``.
    ``app`` holds the configuration's ``truncation``, ``truncation_scale``,
    ``max_integration_distance`` and ``max_integration_weight``."""
    fx, fy, cx, cy = (torch.tensor(v, dtype=dtype, device=device) for v in intrinsics)
    n, h, w = depth.shape
    p = torch.as_tensor(np.asarray(points, np.float64), device=device).to(dtype)
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    w2c = world_to_camera(torch.as_tensor(np.asarray(c2w, np.float64), device=device).to(dtype))
    trunc = torch.tensor(app["truncation"], dtype=dtype, device=device)
    trunc_scale = torch.tensor(app["truncation_scale"], dtype=dtype, device=device)
    max_d = app["max_integration_distance"]
    cap = torch.tensor(app["max_integration_weight"], dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    sdf = torch.zeros(p.shape[0], dtype=dtype, device=device)
    weight = torch.zeros_like(sdf)
    for s in range(0, n, batch):
        m = w2c[s : s + batch]
        x = m[:, 0, 0, None] * px + m[:, 0, 1, None] * py + m[:, 0, 2, None] * pz + m[:, 0, 3, None]
        y = m[:, 1, 0, None] * px + m[:, 1, 1, None] * py + m[:, 1, 2, None] * pz + m[:, 1, 3, None]
        z = m[:, 2, 0, None] * px + m[:, 2, 1, None] * py + m[:, 2, 2, None] * pz + m[:, 2, 3, None]
        zok = z > 1e-6
        zs = torch.where(zok, z, one)
        u = x / zs * fx + cx
        v = y / zs * fy + cy
        inside = zok & (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
        ui = torch.clamp(torch.floor(u.float() + 0.5), 0, w - 1).long()
        vi = torch.clamp(torch.floor(v.float() + 0.5), 0, h - 1).long()
        frames = torch.as_tensor(depth[s : s + batch], device=device).to(dtype).reshape(m.shape[0], -1)
        d = torch.gather(frames, 1, vi * w + ui)
        tr = trunc + trunc_scale * d
        sample = d - z
        ok = inside & (d > 0) & (d < max_d) & (sample > -tr)
        sample = torch.minimum(torch.maximum(sample, -tr), tr)
        for j in range(m.shape[0]):
            upd = ok[j]
            sdf = torch.where(upd, (sdf * weight + sample[j]) / (weight + one), sdf)
            weight = torch.where(upd, torch.minimum(weight + one, cap), weight)
    return sdf.float().cpu().numpy(), weight.float().cpu().numpy()
