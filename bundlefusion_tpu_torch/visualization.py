"""Debug image dumpers (port of ``bundlefusion_tpu.visualization``): keypoint
overlays, match lines, residual colourings and raycast previews, written as
PNG through PIL when it is installed, else as ``.npy`` (numpy only)."""

from __future__ import annotations

import numpy as np


def _save_image(path: str, img: np.ndarray) -> str:
    """img float [H, W, 3] in [0,1] (or [H, W]) -> PNG (PIL) or .npy fallback.
    Returns the path written."""
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    arr8 = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    try:
        from PIL import Image
    except ImportError:
        alt = path.rsplit(".", 1)[0] + ".npy"
        np.save(alt, arr8)
        return alt
    Image.fromarray(arr8).save(path)
    return path


def draw_keypoints(color: np.ndarray, xy: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Burn 3x3 key markers into a copy of the image."""
    img = np.array(color, copy=True)
    h, w = img.shape[:2]
    for (x, y), ok in zip(np.asarray(xy), np.asarray(valid)):
        if not ok:
            continue
        xi, yi = int(round(x)), int(round(y))
        if 1 <= xi < w - 1 and 1 <= yi < h - 1:
            img[yi - 1 : yi + 2, xi - 1 : xi + 2] = [1.0, 0.1, 0.1]
    return img


def draw_matches(color_a: np.ndarray, color_b: np.ndarray, xy_a: np.ndarray, xy_b: np.ndarray,
                 valid: np.ndarray) -> np.ndarray:
    """Side-by-side image with straight correspondence lines."""
    h, w = color_a.shape[:2]
    canvas = np.concatenate([np.array(color_a), np.array(color_b)], axis=1)
    for (xa, ya), (xb, yb), ok in zip(np.asarray(xy_a), np.asarray(xy_b), np.asarray(valid)):
        if not ok:
            continue
        x0, y0 = float(xa), float(ya)
        x1, y1 = float(xb) + w, float(yb)
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        xs = np.linspace(x0, x1, n).round().astype(int)
        ys = np.linspace(y0, y1, n).round().astype(int)
        m = (xs >= 0) & (xs < 2 * w) & (ys >= 0) & (ys < h)
        canvas[ys[m], xs[m]] = [0.1, 1.0, 0.2]
    return canvas


def save_keypoint_image(path: str, color, keys) -> str:
    """``keys``: the port's ``SiftKeys`` of one image (tensors)."""
    return _save_image(path, draw_keypoints(np.asarray(color), keys.xy.cpu().numpy(), keys.valid.cpu().numpy()))


def save_match_image(path: str, color_a, color_b, keys_a, keys_b, matches) -> str:
    """``matches``: the port's ``Matches`` of one image pair (tensors)."""
    v = matches.valid.cpu().numpy()
    xy_a = keys_a.xy.cpu().numpy()[matches.idx_i.cpu().numpy()]
    xy_b = keys_b.xy.cpu().numpy()[matches.idx_j.cpu().numpy()]
    return _save_image(path, draw_matches(np.asarray(color_a), np.asarray(color_b), xy_a, xy_b, v))


def save_preview(path: str, shaded: np.ndarray) -> str:
    """Save a raycast preview (``BundleFusion.render_preview`` output)."""
    return _save_image(path, shaded)


def residual_colormap(res: np.ndarray, max_res: float) -> np.ndarray:
    """Per-residual green->red colouring."""
    t = np.clip(np.asarray(res) / max_res, 0.0, 1.0)
    return np.stack([t, 1.0 - t, np.zeros_like(t)], axis=-1)
