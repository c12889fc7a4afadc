"""Frame wire formats (numpy mirror of ``bundlefusion_tpu.io.framewire``'s
portable branches; the native converter ``native/framewire.cpp`` is not
loaded).

* v1 wire (:func:`frame_to_wire`): float depth [H, W] + float colour
  [H, W, 3] -> (uint16 mm depth, uint8 RGB [H, W, 3]). The multi-sequence
  driver (``parallel/spmd_pipeline.py``) runs on it.
* v2 wire (:func:`frame_to_wire2`): -> (uint16 mm depth, uint8 luma [H, W],
  uint8 RGB at half resolution [H/2, W/2, 3]). The serial pipeline runs on it.
* :func:`bilateral_wire`: the 5x5 zero-aware bilateral on wire depth that
  ``integrate_filtered_depth`` applies before the frame is stored, so every
  consumer sees the same filtered bytes.

The quantization is part of the pipeline's numerics (SIFT reads the 8-bit
luma, fusion the 8-bit colour), so every expression keeps the JAX package's
dtypes.
"""

from __future__ import annotations

import numpy as np


def frame_to_wire(depth: np.ndarray, color: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """v1 wire: depth clipped to [0, 65] m."""
    d16 = (np.clip(depth, 0.0, 65.0) * 1000.0 + 0.5).astype(np.uint16)
    c8 = (np.clip(color, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return d16, c8


def frame_to_wire2(
    depth: np.ndarray,
    color: np.ndarray,
    depth_min: float = 0.0,
    depth_max: float = 65.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Depth outside [depth_min, depth_max] becomes invalid (0). H and W
    must be even."""
    din = np.where((depth >= depth_min) & (depth <= depth_max), depth, 0.0)
    d16 = (din.astype(np.float32) * np.float32(1000.0) + np.float32(0.5)).astype(np.uint16)
    lum = color[..., 0] * 0.299 + color[..., 1] * 0.587 + color[..., 2] * 0.114
    y8 = (np.clip(lum, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    half = 0.25 * (color[0::2, 0::2] + color[0::2, 1::2] + color[1::2, 0::2] + color[1::2, 1::2])
    c8h = (np.clip(half, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return d16, y8, c8h


def _shifted(a: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """out[y, x] = a[y - dy, x - dx]; vacated pixels are 0."""
    out = np.zeros_like(a)
    ys0, ys1 = max(dy, 0), a.shape[0] + min(dy, 0)
    xs0, xs1 = max(dx, 0), a.shape[1] + min(dx, 0)
    out[ys0:ys1, xs0:xs1] = a[ys0 - dy : ys1 - dy, xs0 - dx : xs1 - dx]
    return out


def bilateral_wire(d16: np.ndarray, sigma_d: float, sigma_r: float) -> np.ndarray:
    """5x5 zero-aware bilateral on wire-format depth (uint16 mm); a
    neighbour outside the frame contributes nothing.

    The dtypes are NumPy 2's for the JAX package's expressions, written out
    so that they hold under any NumPy: the spatial weight is a float64
    scalar, so each tap's weight and weighted depth are float64, while the
    accumulators stay float32 (each ``+=`` rounds its float64 sum)."""
    d = d16.astype(np.float32) * np.float32(1e-3)
    acc = np.zeros_like(d)
    wacc = np.zeros_like(d)
    inv_2sd2 = 1.0 / (2.0 * sigma_d * sigma_d)
    inv_2sr2 = np.float32(1.0 / (2.0 * sigma_r * sigma_r))
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            n = _shifted(d, dy, dx)
            w_range = np.exp(-((n - d) ** 2) * inv_2sr2).astype(np.float64)
            w = np.float64(np.exp(-(dy * dy + dx * dx) * inv_2sd2)) * w_range * (n > 0)
            acc = (acc.astype(np.float64) + w * n.astype(np.float64)).astype(np.float32)
            wacc = (wacc.astype(np.float64) + w).astype(np.float32)
    out = np.where((d > 0) & (wacc > 0), acc / np.maximum(wacc, np.float32(1e-12)), np.float32(0.0))
    return np.clip(out * np.float32(1000.0) + np.float32(0.5), 0, 65535).astype(np.uint16)
