"""Frame preprocessing (port of ``bundlefusion_tpu.ops.preprocess``).

The bilateral filter -> unprojection -> normals chain of
``_preprocess_core`` is kernel K2 (``csrc/preprocess.cu``, one launch),
reached through :func:`fused_preprocess`; its plain twin
:func:`_preprocess_chain_torch` sits beside it and runs for CPU tensors only.
The point and normal maps are optional (``geometry``): the chunk pipeline
reads only the filtered depth, so it asks for that alone. Everything
downstream — the cache downsample, the banded Gaussian, the gradients — is
plain PyTorch.

All functions take [..., H, W] (or [..., H, W, C]) and broadcast over
leading axes. Invalid depth is 0.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import kernels
from ..geometry.camera import CameraModel, pixel_grid, unproject


def _shift2d(x: torch.Tensor, dy: int, dx: int, fill: float = 0.0) -> torch.Tensor:
    """Shift the last two axes by (dy, dx): out[y, x] = x[y - dy, x - dx],
    vacated pixels filled."""
    h, w = x.shape[-2], x.shape[-1]
    out = torch.full_like(x, fill)
    ys0, ys1 = max(dy, 0), h + min(dy, 0)
    xs0, xs1 = max(dx, 0), w + min(dx, 0)
    if ys1 > ys0 and xs1 > xs0:
        out[..., ys0:ys1, xs0:xs1] = x[..., ys0 - dy : ys1 - dy, xs0 - dx : xs1 - dx]
    return out


def bilateral_filter_depth(
    depth: torch.Tensor, sigma_d: float = 2.0, sigma_r: float = 0.1, radius: int = 3
) -> torch.Tensor:
    """Edge-preserving zero-aware depth smoothing (the XLA chain's form)."""
    valid = depth > 0.0
    acc = torch.zeros_like(depth)
    wacc = torch.zeros_like(depth)
    inv_2sd2 = 1.0 / (2.0 * sigma_d * sigma_d)
    inv_2sr2 = 1.0 / (2.0 * sigma_r * sigma_r)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            d_n = _shift2d(depth, dy, dx)
            w_spatial = float(np.exp(np.float32(-(dy * dy + dx * dx) * inv_2sd2)))
            diff = d_n - depth
            w = torch.where((d_n > 0.0) & valid, w_spatial * torch.exp(-(diff * diff) * inv_2sr2), 0.0)
            acc = acc + w * d_n
            wacc = wacc + w
    out = torch.where(wacc > 1e-8, acc / torch.clamp(wacc, min=1e-8), 0.0)
    return torch.where(valid, out, 0.0)


def gaussian_filter(x: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """Separable zero-padded Gaussian blur over the last two axes, as two
    banded-matrix products y = G_h @ x @ G_w^T (the JAX package's form)."""
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    h, w = x.shape[-2:]
    gh = _gauss_band(h, float(sigma), int(radius), x.device)
    gw = _gauss_band(w, float(sigma), int(radius), x.device)
    out = torch.matmul(gh, x)
    return torch.matmul(out, gw.T)


@functools.lru_cache(maxsize=None)
def _gauss_band(n: int, sigma: float, radius: int, device: torch.device) -> torch.Tensor:
    """The banded [n, n] Gaussian matrix, built once per device: a fresh
    host->device copy on every blur would sync the host with the card."""
    idx = np.arange(n)
    diff = idx[None, :] - idx[:, None]
    k = np.exp(-(np.arange(-radius, radius + 1) ** 2) / (2.0 * sigma * sigma))
    k = k / k.sum()
    g = np.where(np.abs(diff) <= radius, k[np.clip(diff + radius, 0, 2 * radius)], 0.0)
    return torch.as_tensor(g.astype(np.float32), device=device)


def compute_normals(points: torch.Tensor) -> torch.Tensor:
    """Camera-space normals from the point map via central differences,
    [..., H, W, 3] -> [..., H, W, 3]; zero where a neighbour is invalid,
    oriented toward the camera (n.z <= 0)."""
    pc = torch.movedim(points, -1, -3)
    right = _shift2d(pc, 0, -1)
    left = _shift2d(pc, 0, 1)
    down = _shift2d(pc, -1, 0)
    up = _shift2d(pc, 1, 0)
    dx = torch.movedim(right - left, -3, -1)
    dy = torch.movedim(down - up, -3, -1)
    n = torch.linalg.cross(dy, dx, dim=-1)
    norm = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    valid = (
        (right[..., 2, :, :] > 0)
        & (left[..., 2, :, :] > 0)
        & (down[..., 2, :, :] > 0)
        & (up[..., 2, :, :] > 0)
        & (norm[..., 0] > 1e-9)
    )
    n = torch.where(valid[..., None], n / torch.clamp(norm, min=1e-9), 0.0)
    flip = torch.where(n[..., 2:3] > 0.0, -1.0, 1.0)
    return n * flip


def image_gradients(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients (gx, gy) of [..., H, W] intensity."""
    gx = 0.5 * (_shift2d(x, 0, -1) - _shift2d(x, 0, 1))
    gy = 0.5 * (_shift2d(x, -1, 0) - _shift2d(x, 1, 0))
    return gx, gy


def downsample_depth(depth: torch.Tensor, factor_h: int, factor_w: int) -> torch.Tensor:
    """Valid-aware block-mean depth downsample."""
    *lead, h, w = depth.shape
    d = depth.reshape(*lead, h // factor_h, factor_h, w // factor_w, factor_w)
    valid = (d > 0.0).to(depth.dtype)
    s = torch.sum(d * valid, dim=(-3, -1))
    c = torch.sum(valid, dim=(-3, -1))
    return torch.where(c > 0, s / torch.clamp(c, min=1.0), 0.0)


def downsample_mean(x: torch.Tensor, factor_h: int, factor_w: int) -> torch.Tensor:
    """Plain block-mean downsample for intensity/colour channels."""
    *lead, h, w = x.shape
    d = x.reshape(*lead, h // factor_h, factor_h, w // factor_w, factor_w)
    return torch.mean(d, dim=(-3, -1))


@dataclass
class FrameCache:
    """Downsampled per-frame geometry cache for dense BA and dense verify."""

    depth: torch.Tensor  # [N, h, w] float32 meters, 0 invalid
    points: torch.Tensor  # [N, h, w, 3]
    normals: torch.Tensor  # [N, h, w, 3]
    intensity: torch.Tensor  # [N, h, w]
    grad: torch.Tensor  # [N, h, w, 2]

    @property
    def num_frames(self) -> int:
        return self.depth.shape[0]

    def index(self, idx) -> "FrameCache":
        """The cache rows ``idx`` (an int, slice or index tensor) of every field."""
        return FrameCache(
            self.depth[idx], self.points[idx], self.normals[idx], self.intensity[idx], self.grad[idx]
        )


@dataclass
class ProcessedFrames:
    """Full-resolution per-frame products."""

    depth: torch.Tensor  # [N, H, W] filtered depth
    points: torch.Tensor | None  # [N, H, W, 3]; None when geometry was not asked for
    normals: torch.Tensor | None  # [N, H, W, 3]; None likewise
    intensity: torch.Tensor  # [N, H, W]
    color: torch.Tensor  # [N, H, W, 3] pass-through; [N, 1, 1, 3] placeholder from the luma wire


def _preprocess_chain_torch(
    depth: torch.Tensor, cam: CameraModel, sigma_d: float, sigma_r: float, radius: int,
    geometry: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """Plain PyTorch twin of kernel K2, in the TPU kernel's operation order:
    bilateral filter, unprojection, normals cross(dy, dx); (fdepth, None,
    None) without ``geometry``.

    Every operand is a tensor on the data's device, so each op rounds as the
    kernel's does: the spatial weights come from the same device ``exp`` as
    the range weights, and no division is by a host scalar (PyTorch turns
    that into a multiply by the reciprocal on the card)."""
    dev = depth.device

    def scalar(v):
        return torch.full((), v, dtype=torch.float32, device=dev)

    valid = depth > 0.0
    acc = torch.zeros_like(depth)
    wacc = torch.zeros_like(depth)
    inv_2sd2 = float(np.float32(1.0 / (2.0 * sigma_d * sigma_d)))
    inv_2sr2 = float(np.float32(1.0 / (2.0 * sigma_r * sigma_r)))
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            d_n = _shift2d(depth, dy, dx)
            w_s = torch.exp(scalar(-(dy * dy + dx * dx)) * inv_2sd2)
            diff = d_n - depth
            wgt = torch.where((d_n > 0.0) & valid, w_s * torch.exp(-(diff * diff) * inv_2sr2), 0.0)
            acc = acc + wgt * d_n
            wacc = wacc + wgt
    fdepth = torch.where(valid & (wacc > 1e-8), acc / torch.clamp(wacc, min=1e-8), 0.0)
    if not geometry:
        return fdepth, None, None

    v, u = pixel_grid(depth.shape[-2], depth.shape[-1], dev)
    z = fdepth
    ok = z > 0.0
    px = torch.where(ok, (u - cam.cx) / scalar(cam.fx) * z, 0.0)
    py = torch.where(ok, (v - cam.cy) / scalar(cam.fy) * z, 0.0)
    points = torch.stack([px, py, z], dim=-1)

    parts = []
    for c in (px, py, z):
        parts.append((_shift2d(c, 0, -1) - _shift2d(c, 0, 1), _shift2d(c, -1, 0) - _shift2d(c, 1, 0)))
    (ax, ay), (bx, by), (cx_, cy_) = parts
    nx = by * cx_ - cy_ * bx
    ny = cy_ * ax - ay * cx_
    nz = ay * bx - by * ax
    nrm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    nvalid = (
        (_shift2d(z, 0, -1) > 0) & (_shift2d(z, 0, 1) > 0)
        & (_shift2d(z, -1, 0) > 0) & (_shift2d(z, 1, 0) > 0) & (nrm > 1e-9)
    )
    inv = torch.where(nvalid, 1.0 / torch.clamp(nrm, min=1e-9), 0.0)
    nx, ny, nz = nx * inv, ny * inv, nz * inv
    flip = torch.where(nz > 0.0, -1.0, 1.0)
    normals = torch.stack([nx * flip, ny * flip, nz * flip], dim=-1)
    return fdepth, points, normals


@kernels.counted
def fused_preprocess(
    depth: torch.Tensor,  # [N, H, W] float32, 0 = invalid
    cam: CameraModel,
    sigma_d: float = 2.0,
    sigma_r: float = 0.1,
    radius: int = 3,
    geometry: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor | None]:
    """Kernel K2: (fdepth [N,H,W], points [N,H,W,3], normals [N,H,W,3]), or
    (fdepth, None, None) without ``geometry``. ``radius=0`` is the identity
    filter; the kernel takes radii up to 3. CUDA tensors launch the kernel;
    CPU tensors run the plain twin."""
    if not depth.is_cuda:
        return _preprocess_chain_torch(depth, cam, sigma_d, sigma_r, radius, geometry)
    kernels.require(depth, "depth", torch.float32)
    if depth.dim() != 3:
        raise ValueError(f"depth: expected [N, H, W], got {tuple(depth.shape)}")
    if not 0 <= radius <= 3:
        raise ValueError(f"radius {radius}: the kernel's halo holds radii 0..3")
    n, h, w = depth.shape
    fdepth = torch.empty_like(depth)
    points = normals = None
    if geometry:
        points = torch.empty((n, h, w, 3), dtype=torch.float32, device=depth.device)
        normals = torch.empty_like(points)
    err = kernels.library().bf_preprocess(
        depth.data_ptr(), fdepth.data_ptr(),
        None if points is None else points.data_ptr(),
        None if normals is None else normals.data_ptr(),
        n, h, w, cam.fx, cam.fy, cam.cx, cam.cy,
        1.0 / (2.0 * sigma_d * sigma_d), 1.0 / (2.0 * sigma_r * sigma_r), radius,
        kernels.stream_ptr(depth.device),
    )
    kernels.check(err, "preprocess")
    fused_preprocess.launches += 1
    return fdepth, points, normals


def color_to_intensity(color: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] RGB -> [..., H, W] luminance (``convertColorToIntensityFloat``),
    summed in channel order."""
    return color[..., 0] * 0.299 + color[..., 1] * 0.587 + color[..., 2] * 0.114


def preprocess_frames(
    depth_raw: torch.Tensor,  # [N, H, W] f32 meters, or int16-stored uint16 mm wire
    color: torch.Tensor,  # [N, H, W, 3] f32 in [0, 1], or the uint8 v1 wire
    cam: CameraModel,
    cache_cam: CameraModel,
    sigma_d: float = 2.0,
    sigma_r: float = 0.1,
    filter_depth: bool = True,
    geometry: bool = True,
) -> tuple[ProcessedFrames, FrameCache]:
    """Preprocess a frame batch from full RGB (the v1 wire): intensity is the
    luminance of the float colour, which differs from the luma wire's 8-bit
    Y by design. Depth is filtered by K2 as on the luma path."""
    if depth_raw.dtype == torch.int16:
        depth_raw = wire_depth_to_m(depth_raw)
    if color.dtype == torch.uint8:
        color = color.to(torch.float32) * (1.0 / 255.0)
    return _preprocess_core(
        depth_raw, color_to_intensity(color), color, cam, cache_cam, sigma_d, sigma_r, filter_depth, geometry
    )


def preprocess_frames_y(
    depth_raw: torch.Tensor,  # [N, H, W] f32 meters, or int16-stored uint16 mm wire
    y8: torch.Tensor,  # [N, H, W] uint8 luma wire (or f32 intensity)
    cam: CameraModel,
    cache_cam: CameraModel,
    sigma_d: float = 2.0,
    sigma_r: float = 0.1,
    filter_depth: bool = True,
    geometry: bool = True,
) -> tuple[ProcessedFrames, FrameCache]:
    """Preprocess a frame batch from the v2 wire (uint16 mm depth, uint8
    luma). ``ProcessedFrames.color`` is a placeholder: nothing reads it.
    Without ``geometry`` the full-resolution points and normals are None."""
    if depth_raw.dtype == torch.int16:
        depth_raw = wire_depth_to_m(depth_raw)
    intensity = y8.to(torch.float32) * (1.0 / 255.0) if y8.dtype == torch.uint8 else y8
    color = torch.zeros((intensity.shape[0], 1, 1, 3), dtype=torch.float32, device=y8.device)
    return _preprocess_core(
        depth_raw, intensity, color, cam, cache_cam, sigma_d, sigma_r, filter_depth, geometry
    )


def wire_depth_to_m(d16: torch.Tensor) -> torch.Tensor:
    """uint16 millimetre wire depth (held in int16 storage) -> float32 meters."""
    return (d16.to(torch.int32) & 0xFFFF).to(torch.float32) * 1e-3


def _preprocess_core(depth_raw, intensity, color, cam, cache_cam, sigma_d, sigma_r, filter_depth, geometry):
    depth = torch.where((depth_raw > 0.0) & torch.isfinite(depth_raw), depth_raw, 0.0)
    depth, points, normals = fused_preprocess(
        depth.contiguous(), cam, sigma_d, sigma_r, radius=3 if filter_depth else 0, geometry=geometry
    )
    fh = cam.height // cache_cam.height
    fw = cam.width // cache_cam.width
    if fh < 1 or fw < 1:
        raise ValueError("cache resolution must divide the frame resolution")
    d_lo = downsample_depth(depth, fh, fw)
    p_lo = unproject(cache_cam, d_lo)
    n_lo = compute_normals(p_lo)
    i_lo = downsample_mean(intensity, fh, fw)
    # smooth intensity slightly before differentiating (photometric term stability)
    i_lo_s = gaussian_filter(i_lo, 0.8, radius=2)
    gx, gy = image_gradients(i_lo_s)
    cache = FrameCache(
        depth=d_lo, points=p_lo, normals=n_lo, intensity=i_lo_s, grad=torch.stack([gx, gy], dim=-1)
    )
    return ProcessedFrames(depth, points, normals, intensity, color), cache


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Bilinear interpolation of [H, W(, C)] at uv [..., 2] -> (values, in-bounds mask)."""
    h, w = img.shape[0], img.shape[1]
    u, v = uv[..., 0], uv[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    u0i = u0.to(torch.int64)
    v0i = v0.to(torch.int64)
    inb = (u0i >= 0) & (u0i < w - 1) & (v0i >= 0) & (v0i < h - 1)
    u0c = torch.clamp(u0i, 0, w - 2)
    v0c = torch.clamp(v0i, 0, h - 2)
    x00 = img[v0c, u0c]
    x01 = img[v0c, u0c + 1]
    x10 = img[v0c + 1, u0c]
    x11 = img[v0c + 1, u0c + 1]
    if img.dim() == 3:
        du = du[..., None]
        dv = dv[..., None]
    val = x00 * (1 - du) * (1 - dv) + x01 * du * (1 - dv) + x10 * (1 - du) * dv + x11 * du * dv
    return val, inb


def bilinear_sample_matmul(img: torch.Tensor, uv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Bilinear sampling of [..., H, W, C] at uv [..., D, 2] as two separable
    tent-weight contractions (border clamp); batched over leading axes."""
    h, w = img.shape[-3], img.shape[-2]
    u = uv[..., 0]
    v = uv[..., 1]
    inb = (u >= 0.0) & (u < w - 1.0 + 1e-4) & (v >= 0.0) & (v < h - 1.0 + 1e-4)
    uc = torch.clamp(u, 0.0, w - 1.001)
    vc = torch.clamp(v, 0.0, h - 1.001)
    hh = torch.arange(h, dtype=img.dtype, device=img.device)
    ww = torch.arange(w, dtype=img.dtype, device=img.device)
    tv = torch.clamp(1.0 - torch.abs(vc[..., None] - hh), min=0.0)  # [..., D, H]
    tu = torch.clamp(1.0 - torch.abs(uc[..., None] - ww), min=0.0)  # [..., D, W]
    lead = img.shape[:-3]
    c = img.shape[-1]
    tmp = torch.matmul(tv, img.reshape(*lead, h, w * c)).reshape(*lead, -1, w, c)  # [..., D, W, C]
    val = torch.einsum("...dwc,...dw->...dc", tmp, tu)
    return val, inb


def bilinear_sample_gather(img: torch.Tensor, uv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`bilinear_sample_matmul`'s result from the two rows and two
    columns its tent weights leave non-zero, gathered: the same clamp,
    in-bounds test and tent weights, and the same order of the contractions
    (along v, then along u). ``img`` [L, H, W, C] and ``uv`` [L, D, 2] share
    their leading axis; memory is [L, D, C] where the matmul form needs
    [L, D, W, C]. The two forms may differ by an FMA's rounding."""
    lead, h, w, c = img.shape
    u = uv[..., 0]
    v = uv[..., 1]
    inb = (u >= 0.0) & (u < w - 1.0 + 1e-4) & (v >= 0.0) & (v < h - 1.0 + 1e-4)
    uc = torch.clamp(u, 0.0, w - 1.001)
    vc = torch.clamp(v, 0.0, h - 1.001)
    # a NaN coordinate gathers pixel 0 and keeps NaN weights, as the matmul
    # form's NaN tent rows make its value NaN
    u0 = torch.nan_to_num(torch.floor(uc), nan=0.0)
    v0 = torch.nan_to_num(torch.floor(vc), nan=0.0)
    tv0 = torch.clamp(1.0 - torch.abs(vc - v0), min=0.0)[..., None]
    tv1 = torch.clamp(1.0 - torch.abs(vc - (v0 + 1.0)), min=0.0)[..., None]
    tu0 = torch.clamp(1.0 - torch.abs(uc - u0), min=0.0)[..., None]
    tu1 = torch.clamp(1.0 - torch.abs(uc - (u0 + 1.0)), min=0.0)[..., None]
    flat = img.reshape(lead, h * w, c)
    base = v0.to(torch.int64) * w + u0.to(torch.int64)

    def pixel(offset):
        return torch.gather(flat, 1, (base + offset)[..., None].expand(-1, -1, c))

    col0 = tv0 * pixel(0) + tv1 * pixel(w)
    col1 = tv0 * pixel(1) + tv1 * pixel(w + 1)
    return col0 * tu0 + col1 * tu1, inb


def nearest_sample(img: torch.Tensor, uv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-neighbour sample of [H, W(, C)] at uv [..., 2] -> (values, mask)."""
    h, w = img.shape[0], img.shape[1]
    ui = torch.round(uv[..., 0]).to(torch.int64)
    vi = torch.round(uv[..., 1]).to(torch.int64)
    inb = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    return img[torch.clamp(vi, 0, h - 1), torch.clamp(ui, 0, w - 1)], inb
