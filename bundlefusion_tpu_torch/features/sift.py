"""Batched depth-aware SIFT (port of ``bundlefusion_tpu.features.sift``).

Gaussian/DoG pyramid, dense 3x3x3 extremum detection with subpixel
refinement, a stable top-k compaction into the fixed key capacity, 36-bin
orientation and 128-D descriptors from 16x16 resampled windows, and depth
lifting to 3D keys. The frame axis is a batch dimension throughout (the JAX
package vmaps one frame's program).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..config import BundlingConfig
from ..geometry.camera import CameraModel
from ..ops.preprocess import _shift2d, gaussian_filter
from ..utils.tensor_ops import top_k


@dataclass
class SiftKeys:
    """Fixed-capacity keypoint sets, [..., K] (leading axes: frames)."""

    xy: torch.Tensor  # [..., K, 2] base-image pixel coords (x, y)
    sigma: torch.Tensor  # [..., K] scale in base-image pixels
    response: torch.Tensor  # [..., K] |DoG| response after refinement
    orientation: torch.Tensor  # [..., K] radians
    depth: torch.Tensor  # [..., K] associated depth (meters)
    p3d: torch.Tensor  # [..., K, 3] camera-space 3D position
    desc: torch.Tensor  # [..., K, 128] L2-normalized descriptor
    valid: torch.Tensor  # [..., K] bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    def index(self, idx) -> "SiftKeys":
        """Rows ``idx`` of the leading (frame) axis of every field."""
        return SiftKeys(*(getattr(self, f)[idx] for f in _KEY_FIELDS))


_KEY_FIELDS = ("xy", "sigma", "response", "orientation", "depth", "p3d", "desc", "valid")


def _build_octave(base: torch.Tensor, sigma0: float, num_scales: int) -> torch.Tensor:
    """Gaussian stack [..., S+3, h, w] for one octave from its base image."""
    imgs = [base]
    prev_sigma = sigma0
    for s in range(1, num_scales + 3):
        target = sigma0 * (2.0 ** (s / num_scales))
        inc = math.sqrt(max(target**2 - prev_sigma**2, 1e-6))
        imgs.append(gaussian_filter(imgs[-1], inc))
        prev_sigma = target
    return torch.stack(imgs, dim=-3)


def _extremum_mask(dog: torch.Tensor, contrast_thresh: float, edge_thresh: float):
    """Dense detection over the DoG stack [..., D, h, w]. Returns (mask,
    refined offsets [..., D-2, h, w, 3], refined response) for levels 1..D-2."""
    d = dog[..., 1:-1, :, :]
    lo = dog[..., :-2, :, :]
    hi = dog[..., 2:, :, :]

    def win3(x, op, fill):
        m = op(op(_shift2d(x, 0, -1, fill), x), _shift2d(x, 0, 1, fill))
        return op(op(_shift2d(m, -1, 0, fill), m), _shift2d(m, 1, 0, fill))

    mx = win3(dog, torch.maximum, -math.inf)
    mn = win3(dog, torch.minimum, math.inf)
    wmax = torch.maximum(torch.maximum(mx[..., :-2, :, :], mx[..., 1:-1, :, :]), mx[..., 2:, :, :])
    wmin = torch.minimum(torch.minimum(mn[..., :-2, :, :], mn[..., 1:-1, :, :]), mn[..., 2:, :, :])
    mask = ((d == wmax) | (d == wmin)) & (torch.abs(d) > 0.8 * contrast_thresh)

    dx = 0.5 * (_shift2d(d, 0, -1) - _shift2d(d, 0, 1))
    dy = 0.5 * (_shift2d(d, -1, 0) - _shift2d(d, 1, 0))
    ds = 0.5 * (hi - lo)
    dxx = _shift2d(d, 0, -1) + _shift2d(d, 0, 1) - 2 * d
    dyy = _shift2d(d, -1, 0) + _shift2d(d, 1, 0) - 2 * d
    dss = hi + lo - 2 * d
    dxy = 0.25 * (_shift2d(d, -1, -1) - _shift2d(d, -1, 1) - _shift2d(d, 1, -1) + _shift2d(d, 1, 1))
    dxs = 0.25 * ((_shift2d(hi, 0, -1) - _shift2d(hi, 0, 1)) - (_shift2d(lo, 0, -1) - _shift2d(lo, 0, 1)))
    dys = 0.25 * ((_shift2d(hi, -1, 0) - _shift2d(hi, 1, 0)) - (_shift2d(lo, -1, 0) - _shift2d(lo, 1, 0)))

    tr = dxx + dyy
    det2 = dxx * dyy - dxy * dxy
    r = edge_thresh
    edge_ok = (det2 > 0) & (tr * tr * r < (r + 1) * (r + 1) * det2)

    # closed-form adjugate solve of H @ offset = -g per pixel
    c00 = dyy * dss - dys * dys
    c01 = dxs * dys - dxy * dss
    c02 = dxy * dys - dxs * dyy
    c11 = dxx * dss - dxs * dxs
    c12 = dxy * dxs - dxx * dys
    c22 = dxx * dyy - dxy * dxy
    detH = dxx * c00 + dxy * c01 + dxs * c02
    ok_det = torch.abs(detH) > 1e-12
    inv_det = torch.where(ok_det, 1.0 / torch.where(ok_det, detH, 1.0), 0.0)
    off_x = -(c00 * dx + c01 * dy + c02 * ds) * inv_det
    off_y = -(c01 * dx + c11 * dy + c12 * ds) * inv_det
    off_s = -(c02 * dx + c12 * dy + c22 * ds) * inv_det
    offset = torch.clamp(torch.stack([off_x, off_y, off_s], dim=-1), -0.6, 0.6)
    refined = d + 0.5 * (dx * offset[..., 0] + dy * offset[..., 1] + ds * offset[..., 2])
    mask = mask & edge_ok & ok_det & (torch.abs(refined) > contrast_thresh)
    return mask, offset, refined


_GRID = 16  # samples per axis for the key window
_NBINS_ORI = 36
_DESC_SPATIAL = 4
_DESC_ORI = 8
_PATCH = 64  # per-key patch extent (rows); covers the widest descriptor window
_BLK = 64  # column-block granularity of the patch origin
_PATCH_W = 2 * _BLK  # column extent of block-aligned patches


@functools.lru_cache(maxsize=None)
def _spatial_weights(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Static [256, 16] bilinear spatial-bin weights of the 16x16 descriptor
    grid over 4x4 bins, plus the Gaussian window [256]; built once per
    device (a per-call host->device copy would sync the host)."""
    g = np.arange(_GRID) + 0.5
    bin_coord = g / (_GRID / _DESC_SPATIAL) - 0.5
    w = np.zeros((_GRID, _DESC_SPATIAL), dtype=np.float32)
    for i, c in enumerate(bin_coord):
        b0 = int(np.floor(c))
        f = c - b0
        if 0 <= b0 < _DESC_SPATIAL:
            w[i, b0] = 1.0 - f
        if 0 <= b0 + 1 < _DESC_SPATIAL:
            w[i, b0 + 1] = f
    spatial = (w[:, None, :, None] * w[None, :, None, :]).reshape(
        _GRID * _GRID, _DESC_SPATIAL * _DESC_SPATIAL
    )
    c = (_GRID - 1) / 2.0
    yy, xx = np.meshgrid(np.arange(_GRID), np.arange(_GRID), indexing="ij")
    r2 = ((yy - c) ** 2 + (xx - c) ** 2) / (0.5 * _GRID) ** 2
    gauss = np.exp(-r2 * 2.0).astype(np.float32).reshape(-1)
    return torch.as_tensor(spatial, device=device), torch.as_tensor(gauss, device=device)


def _window_coords(xy, sigma, theta, spacing_factor: float) -> torch.Tensor:
    """Rotated, scale-adaptive 16x16 sample grid around each key:
    [..., K, 256, 2] (x, y) octave coordinates."""
    g = torch.arange(_GRID, dtype=torch.float32, device=xy.device) - (_GRID - 1) / 2.0
    gy, gx = torch.meshgrid(g, g, indexing="ij")
    grid = torch.stack([gx, gy], dim=-1).reshape(-1, 2)
    spacing = (sigma * spacing_factor)[..., None, None]
    cos = torch.cos(theta)[..., None]
    sin = torch.sin(theta)[..., None]
    rx = grid[:, 0] * cos - grid[:, 1] * sin
    ry = grid[:, 0] * sin + grid[:, 1] * cos
    rot = torch.stack([rx, ry], dim=-1)
    return xy[..., None, :] + rot * spacing


def _pack_grads(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Two gradient planes as ONE plane of exact integers qx*4096 + qy
    (12 bits each): the quantization is part of the reference's numerics."""
    qx = torch.clamp(torch.round((gx + 0.5) * 4095.0), 0.0, 4095.0)
    qy = torch.clamp(torch.round((gy + 0.5) * 4095.0), 0.0, 4095.0)
    return qx * 4096.0 + qy


def _unpack_grads(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    qx = torch.floor(packed * (1.0 / 4096.0))
    qy = packed - qx * 4096.0
    inv = 1.0 / 4095.0
    return qx * inv - 0.5, qy * inv - 0.5


def _patch_origin(ht: int, wp: int, x0a: torch.Tensor, row0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Where each key's [_PATCH, _PATCH_W] patch starts in the tall image
    [Ht, Wp]: (row, column), clamped so that every patch fits, as
    lax.gather's clip mode clamps it."""
    r0 = torch.clamp(row0, 0, ht - _PATCH)
    c0 = torch.clamp(torch.div(x0a, _BLK, rounding_mode="floor"), 0, wp // _BLK - _PATCH_W // _BLK) * _BLK
    return r0, c0


def _extract_patches(tall: torch.Tensor, x0a: torch.Tensor, row0: torch.Tensor) -> torch.Tensor:
    """Gather [N, K] patches [_PATCH, _PATCH_W] from the tall images [N, Ht, Wp]."""
    n, ht, wp = tall.shape
    r0, c0 = _patch_origin(ht, wp, x0a, row0)
    dev = tall.device
    rows = r0[..., None] + torch.arange(_PATCH, device=dev)
    cols = c0[..., None] + torch.arange(_PATCH_W, device=dev)
    idx = rows[..., :, None] * wp + cols[..., None, :]  # [N, K, P, Pw]
    k = x0a.shape[1]
    g = torch.gather(tall.reshape(n, -1), 1, idx.reshape(n, -1))
    return g.reshape(n, k, _PATCH, _PATCH_W)


def _sample_in_patches(patches: torch.Tensor, lx: torch.Tensor, ly: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling inside per-key patches as tent-weight contractions:
    patches [..., Pr, Pc], lx/ly [..., S] -> [..., S]."""
    pr, pc = patches.shape[-2], patches.shape[-1]
    ty = torch.clamp(1.0 - torch.abs(ly[..., None] - torch.arange(pr, dtype=patches.dtype, device=patches.device)), min=0.0)
    tx = torch.clamp(1.0 - torch.abs(lx[..., None] - torch.arange(pc, dtype=patches.dtype, device=patches.device)), min=0.0)
    tmp = torch.matmul(ty, patches)  # [..., S, Pc]
    return torch.sum(tmp * tx, dim=-1)


def _window_frame(coords, x0, y0, h: int, w: int):
    """The window's patch-local coordinates (lx, ly), clamped into the
    patch, and its mask (in the image and in the patch)."""
    x = coords[..., 0]
    y = coords[..., 1]
    inb = (x >= 0.0) & (x <= w - 1.001) & (y >= 0.0) & (y <= h - 1.001)
    rx = x - x0[..., None].to(x.dtype)
    ry = y - y0[..., None].to(y.dtype)
    lx = torch.clamp(rx, 0.0, _PATCH_W - 1.001)
    ly = torch.clamp(ry, 0.0, _PATCH - 1.001)
    in_patch = (rx >= 0) & (rx < _PATCH_W - 1) & (ry >= 0) & (ry < _PATCH - 1)
    return lx, ly, inb & in_patch


def _gather_grads_patches(patches_x, patches_y, coords, x0, y0, h: int, w: int):
    """Sample both gradient planes at window coords -> (gx, gy, mask): the
    JAX package's matmul form over gathered patches. The port samples with
    :func:`sample_window` (K4); this form stays as the kernel's yardstick
    on the card and is held to it by the tests."""
    lx, ly, mask = _window_frame(coords, x0, y0, h, w)
    return _sample_in_patches(patches_x, lx, ly), _sample_in_patches(patches_y, lx, ly), mask


@kernels.counted
def sample_window(g_tall: torch.Tensor, coords: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                  row0: torch.Tensor, h: int, w: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K4: both gradient planes of the packed tall image ``g_tall``
    [N, Ht, Wp] sampled bilinearly at the window ``coords`` [N, K, S, 2] of
    keys whose patches start at (``row0``, ``x0``) [N, K] (window origin
    ``x0``, ``y0``): (gx, gy, mask) [N, K, S], what
    :func:`_gather_grads_patches` gives from the gathered patches, up to an
    FMA's rounding. CUDA tensors launch the kernel (bit-equal to the twin on
    the card); CPU tensors run the twin."""
    if not g_tall.is_cuda:
        return _sample_window_torch(g_tall, coords, x0, y0, row0, h, w)
    kernels.require(g_tall, "g_tall", torch.float32)
    if g_tall.dim() != 3:
        raise ValueError(f"g_tall: expected [N, Ht, Wp], got {tuple(g_tall.shape)}")
    nf, ht, wp = g_tall.shape
    if ht < _PATCH or wp < _PATCH_W or wp % _BLK:
        raise ValueError(f"g_tall {tuple(g_tall.shape)}: a [{_PATCH}, {_PATCH_W}] patch of {_BLK}-column blocks "
                         "must fit")
    coords = coords.contiguous()
    nk, ns = coords.shape[1], coords.shape[2]
    kernels.require(coords, "coords", torch.float32, (nf, nk, ns, 2))
    x0, y0, row0 = (t.contiguous() for t in (x0, y0, row0))
    for name, t in (("x0", x0), ("y0", y0), ("row0", row0)):
        kernels.require(t, name, torch.int64, (nf, nk))
    gx = torch.empty((nf, nk, ns), dtype=torch.float32, device=g_tall.device)
    gy = torch.empty_like(gx)
    mask = torch.empty((nf, nk, ns), dtype=torch.bool, device=g_tall.device)
    err = kernels.library().bf_sift_sample(
        g_tall.data_ptr(), coords.data_ptr(), x0.data_ptr(), y0.data_ptr(), row0.data_ptr(), gx.data_ptr(),
        gy.data_ptr(), mask.data_ptr(), nf, nk, ns, ht, wp, w - 1.001, h - 1.001, _PATCH_W - 1.001,
        _PATCH - 1.001, kernels.stream_ptr(g_tall.device),
    )
    kernels.check(err, "sift_sample")
    kernels.launched(sample_window)
    return gx, gy, mask


def _sample_window_torch(g_tall, coords, x0, y0, row0, h: int, w: int):
    """K4's twin: the matmul form's two non-zero rows and columns of tent
    weights, gathered (as ``ops/preprocess.py::bilinear_sample_gather``):
    the same clamps, the tents clamp(1 - |l - l0|, 0) and clamp(1 - |l -
    (l0 + 1)|, 0) with l0 = floor(l), the same order (along rows, then
    along columns). The taps are read from the tall image where the
    clamped patch holds them, each unpacked by :func:`_unpack_grads`. A NaN
    coordinate reads the patch's first tap with NaN weights."""
    n, ht, wp = g_tall.shape
    lx, ly, mask = _window_frame(coords, x0, y0, h, w)
    r0, c0 = _patch_origin(ht, wp, x0, row0)
    lx0 = torch.nan_to_num(torch.floor(lx), nan=0.0)
    ly0 = torch.nan_to_num(torch.floor(ly), nan=0.0)
    ty0 = torch.clamp(1.0 - torch.abs(ly - ly0), min=0.0)
    ty1 = torch.clamp(1.0 - torch.abs(ly - (ly0 + 1.0)), min=0.0)
    tx0 = torch.clamp(1.0 - torch.abs(lx - lx0), min=0.0)
    tx1 = torch.clamp(1.0 - torch.abs(lx - (lx0 + 1.0)), min=0.0)
    base = ((r0[..., None] + ly0.to(torch.int64)) * wp + c0[..., None] + lx0.to(torch.int64)).reshape(n, -1)
    flat = g_tall.reshape(n, -1)

    def tap(offset):
        return _unpack_grads(torch.gather(flat, 1, base + offset).reshape(lx.shape))

    (ax, ay), (bx, by), (cx, cy), (dx, dy) = tap(0), tap(wp), tap(1), tap(wp + 1)
    gx = (ty0 * ax + ty1 * bx) * tx0 + (ty0 * cx + ty1 * dx) * tx1
    gy = (ty0 * ay + ty1 * by) * tx0 + (ty0 * cy + ty1 * dy) * tx1
    return gx, gy, mask


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _orientation_and_desc(g_tall, xy_oct, sigma_oct, scale_idx, h: int, w: int):
    """Dominant orientation, then the rotated 128-D descriptor, per key."""
    spatial, gauss_w = _spatial_weights(g_tall.device)

    xi = torch.round(xy_oct[..., 0]).to(torch.int64)
    yi = torch.round(xy_oct[..., 1]).to(torch.int64)
    x0 = torch.clamp(xi - _PATCH // 2, 0, max(w - _PATCH, 0))
    x0 = torch.div(x0, _BLK, rounding_mode="floor") * _BLK
    y0 = torch.clamp(yi - _PATCH // 2, 0, max(h - _PATCH, 0))
    row0 = scale_idx * h + y0

    # orientation: unrotated window, 36-bin histogram
    coords = _window_coords(xy_oct, sigma_oct, torch.zeros_like(sigma_oct), 0.4)
    gx, gy, m = sample_window(g_tall, coords, x0, y0, row0, h, w)
    mag = torch.sqrt(gx * gx + gy * gy) * m * gauss_w
    ang = torch.atan2(gy, gx)
    binf = (ang + math.pi) / (2 * math.pi) * _NBINS_ORI
    b0 = torch.floor(binf)
    f = binf - b0
    b0i = torch.remainder(b0.to(torch.int64), _NBINS_ORI)
    b1i = torch.remainder(b0i + 1, _NBINS_ORI)
    oh0 = _one_hot(b0i, _NBINS_ORI, mag.dtype)
    oh1 = _one_hot(b1i, _NBINS_ORI, mag.dtype)
    hist = torch.einsum("...s,...sb->...b", mag * (1 - f), oh0) + torch.einsum(
        "...s,...sb->...b", mag * f, oh1
    )
    for _ in range(2):
        hist = (torch.roll(hist, 1, dims=-1) + hist + torch.roll(hist, -1, dims=-1)) / 3.0
    peak = torch.argmax(hist, dim=-1, keepdim=True)
    hp = torch.gather(hist, -1, peak)[..., 0]
    hl = torch.gather(hist, -1, torch.remainder(peak - 1, _NBINS_ORI))[..., 0]
    hr = torch.gather(hist, -1, torch.remainder(peak + 1, _NBINS_ORI))[..., 0]
    denom = hl - 2 * hp + hr
    interp = torch.where(torch.abs(denom) > 1e-9, 0.5 * (hl - hr) / denom, 0.0)
    theta = ((peak[..., 0].to(torch.float32) + 0.5 + interp) / _NBINS_ORI) * 2 * math.pi - math.pi

    # descriptor: rotated window
    coords_d = _window_coords(xy_oct, sigma_oct, theta, 0.75)
    gx, gy, m = sample_window(g_tall, coords_d, x0, y0, row0, h, w)
    mag = torch.sqrt(gx * gx + gy * gy) * m * gauss_w
    ang = torch.atan2(gy, gx) - theta[..., None]
    binf = (ang / (2 * math.pi)) * _DESC_ORI
    b0 = torch.floor(binf)
    f = binf - b0
    b0i = torch.remainder(b0.to(torch.int64), _DESC_ORI)
    b1i = torch.remainder(b0i + 1, _DESC_ORI)
    orient = _one_hot(b0i, _DESC_ORI, mag.dtype) * (1 - f)[..., None] + _one_hot(
        b1i, _DESC_ORI, mag.dtype
    ) * f[..., None]
    weighted = orient * mag[..., None]  # [..., K, 256, 8]
    desc = torch.einsum("...so,sb->...bo", weighted, spatial)
    desc = desc.reshape(*desc.shape[:-2], 128)
    n1 = torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-9)
    desc = torch.clamp(desc / n1, 0.0, 0.2)
    n2 = torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-9)
    return theta, desc / n2


def detect_batch(
    intensity: torch.Tensor,  # [N, H, W] float32
    depth: torch.Tensor,  # [N, H, W] float32 (0 invalid)
    cam: CameraModel,
    cfg: BundlingConfig,
) -> SiftKeys:
    """SIFT keypoints + descriptors + depth lifting for a frame batch."""
    num_scales = cfg.sift_scales_per_octave
    sigma0 = cfg.sift_sigma
    k_cap = cfg.max_keys_per_image
    n = intensity.shape[0]
    dev = intensity.device

    base = gaussian_filter(intensity, math.sqrt(sigma0**2 - 0.5**2))
    per_octave = []
    for o in range(cfg.sift_octaves):
        h, w = base.shape[-2:]
        if h < 16 or w < 16:
            break
        gauss = _build_octave(base, sigma0, num_scales)  # [N, S+3, h, w]
        dog = gauss[:, 1:] - gauss[:, :-1]
        mask, offset, refined = _extremum_mask(dog, cfg.sift_contrast_thresh, cfg.sift_edge_thresh)
        border = 5
        yy = torch.arange(h, device=dev)[:, None]
        xx = torch.arange(w, device=dev)[None, :]
        inner = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
        mask = mask & inner

        score = torch.where(mask, torch.abs(refined), -1.0).reshape(n, -1)
        top_scores, top_idx = top_k(score, k_cap)
        sel_valid = top_scores > 0.0
        d_hw = h * w
        s_idx = torch.div(top_idx, d_hw, rounding_mode="floor")
        yx = top_idx % d_hw
        y_idx = torch.div(yx, w, rounding_mode="floor")
        x_idx = yx % w
        off = torch.gather(offset.reshape(n, -1, 3), 1, top_idx[..., None].expand(n, k_cap, 3))
        x_oct = x_idx.to(torch.float32) + off[..., 0]
        y_oct = y_idx.to(torch.float32) + off[..., 1]
        s_cont = s_idx.to(torch.float32) + 1.0 + off[..., 2]
        sigma_oct = sigma0 * (2.0 ** (s_cont / num_scales))

        g_stack = gauss[:, 1 : num_scales + 2]
        gxs = 0.5 * (_shift2d(g_stack, 0, -1) - _shift2d(g_stack, 0, 1))
        gys = 0.5 * (_shift2d(g_stack, -1, 0) - _shift2d(g_stack, 1, 0))
        wp = max(-(-(w + _BLK) // _BLK) * _BLK, _PATCH_W)
        g_tall = F.pad(_pack_grads(gxs, gys).reshape(n, -1, w), (0, wp - w, 0, _PATCH))
        scale_row = torch.clamp(torch.round(s_cont - 1.0).to(torch.int64), 0, g_stack.shape[1] - 1)

        xy_o = torch.stack([x_oct, y_oct], dim=-1)
        theta, desc = _orientation_and_desc(g_tall, xy_o, sigma_oct, scale_row, h, w)
        factor = 2.0**o
        per_octave.append(
            dict(
                xy=xy_o * factor,
                sigma=sigma_oct * factor,
                response=torch.where(sel_valid, top_scores, -1.0),
                theta=theta,
                desc=desc,
            )
        )
        base = gauss[:, num_scales, ::2, ::2]

    def cat(name):
        return torch.cat([p[name] for p in per_octave], dim=1)

    top_resp, pick = top_k(cat("response"), k_cap)

    def take(x):
        idx = pick.reshape(pick.shape + (1,) * (x.dim() - 2)).expand(*pick.shape, *x.shape[2:])
        return torch.gather(x, 1, idx)

    xy = take(cat("xy"))
    sigma = take(cat("sigma"))
    theta = take(cat("theta"))
    desc = take(cat("desc"))
    valid = top_resp > 0.0

    # depth lifting; keys on depth discontinuities are rejected
    hh, ww = cam.height, cam.width
    xi = torch.clamp(torch.round(xy[..., 0]).to(torch.int64), 0, ww - 1)
    yi = torch.clamp(torch.round(xy[..., 1]).to(torch.int64), 0, hh - 1)
    flat = yi * ww + xi

    def at_keys(img):
        return torch.gather(img.reshape(n, -1), 1, flat)

    d = at_keys(depth)
    d3_min = depth
    d3_max = depth
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = _shift2d(depth, dy, dx)
            d3_min = torch.minimum(d3_min, torch.where(nb > 0, nb, math.inf))
            d3_max = torch.maximum(d3_max, nb)
    smooth = (at_keys(d3_max) - at_keys(d3_min)) < 0.25
    d_ok = (d > cfg.sift_depth_min) & (d < cfg.sift_depth_max) & smooth
    valid = valid & d_ok
    z = torch.where(d_ok, d, 0.0)
    p3d = torch.stack(
        [(xy[..., 0] - cam.cx) / cam.fx * z, (xy[..., 1] - cam.cy) / cam.fy * z, z], dim=-1
    )
    v1 = valid[..., None]
    return SiftKeys(
        xy=torch.where(v1, xy, 0.0),
        sigma=torch.where(valid, sigma, 0.0),
        response=torch.where(valid, top_resp, 0.0),
        orientation=torch.where(valid, theta, 0.0),
        depth=z * valid,
        p3d=torch.where(v1, p3d, 0.0),
        desc=torch.where(v1, desc, 0.0),
        valid=valid,
    )


def detect_and_describe(
    intensity: torch.Tensor, depth: torch.Tensor, cam: CameraModel, cfg: BundlingConfig
) -> SiftKeys:
    """SIFT for one frame [H, W] (a batch of one)."""
    return detect_batch(intensity[None], depth[None], cam, cfg).index(0)
