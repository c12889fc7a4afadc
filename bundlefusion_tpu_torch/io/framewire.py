"""Frame wire format (numpy mirror of ``bundlefusion_tpu.io.framewire``'s
portable ``frame_to_wire2`` branch).

v2 wire: float depth [H, W] + float colour [H, W, 3] -> (uint16 mm depth,
uint8 luma [H, W], uint8 RGB at half resolution [H/2, W/2, 3]). The
quantization is part of the pipeline's numerics (SIFT reads the 8-bit luma,
fusion the half-res colour), so it is kept exactly.
"""

from __future__ import annotations

import numpy as np


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
