"""Frame wire formats (port of ``bundlefusion_tpu.io.framewire``).

* v1 wire (:func:`frame_to_wire`): float depth [H, W] + float colour
  [H, W, 3] -> (uint16 mm depth, uint8 RGB [H, W, 3]). The multi-sequence
  driver (``parallel/spmd_pipeline.py``) runs on it.
* v2 wire (:func:`frame_to_wire2`): -> (uint16 mm depth, uint8 luma [H, W],
  uint8 RGB at half resolution [H/2, W/2, 3]). The serial pipeline runs on it.
* :func:`pack_depth12`: two depth pixels in three bytes, the chunk upload's
  depth format whenever every value is below 4096 mm.
* :func:`bilateral_wire`: the 5x5 zero-aware bilateral on wire depth that
  ``integrate_filtered_depth`` applies before the frame is stored, so every
  consumer sees the same filtered bytes.

Each runs in the port's native converter (``native/framewire.cpp``, OpenMP
C++) when ``g++`` can build it, and otherwise in numpy; :func:`have_native`
says which. The library is built on first use with ``g++ -O3 -fopenmp
-ffp-contract=off -shared -fPIC`` into the git-ignored
``bundlefusion_tpu_torch/_build/`` and rebuilt when the source is newer.

The numpy branches (``_*_np``) are the reference. The quantization is part
of the pipeline's numerics (SIFT reads the 8-bit luma, fusion the 8-bit
colour), so every expression keeps the JAX package's dtypes, and the native
conversions and packing give their bytes. The native bilateral computes
each range weight with the C library's ``expf``, which may differ from
numpy's float32 ``exp`` in the last bit: a pixel can then land 1 mm apart.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(_HERE, "..", "native", "framewire.cpp"))
LIB_PATH = os.path.abspath(os.path.join(_HERE, "..", "_build", "libframewire.so"))
GXX_FLAGS = ("-O3", "-fopenmp", "-ffp-contract=off", "-shared", "-fPIC")

_L, _P, _F = ctypes.c_long, ctypes.c_void_p, ctypes.c_float
_SIGNATURES = {
    "frame_to_wire": [_P, _P, _L, _L, _P, _P],
    "frame_to_wire2": [_P, _P, _L, _L, _F, _F, _P, _P, _P],
    "pack_depth12": [_P, _L, _P],
    "bilateral_wire_u16": [_P, _L, _L, _P, _F, _P],
}


def build() -> None:
    """Compile ``native/framewire.cpp`` into ``_build/libframewire.so`` if it
    is missing or older than the source (raises on a failed build)."""
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SRC):
        return
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SRC], check=True, capture_output=True)
    os.replace(tmp, LIB_PATH)


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL | None:
    """The converter library, built and loaded once per process; None where
    it cannot be built or loaded."""
    try:
        build()
        lib = ctypes.CDLL(LIB_PATH)
    except (OSError, subprocess.CalledProcessError):
        return None
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = None
    return lib


def have_native() -> bool:
    return _load() is not None


def _out(out, shapes_dtypes, name):
    """The caller's C-contiguous output buffers, checked, or new ones."""
    if out is None:
        return tuple(np.empty(s, d) for s, d in shapes_dtypes)
    for a, (s, d) in zip(out, shapes_dtypes):
        if a.shape != tuple(s) or a.dtype != d or not a.flags.c_contiguous:
            raise ValueError(f"{name}: out buffers must be C-contiguous {s} {np.dtype(d).name}")
    return tuple(out)


def _f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _native_inputs(depth: np.ndarray, color: np.ndarray) -> bool:
    """The native conversions compute in float32: other inputs take the
    numpy branch, whose arithmetic follows their dtype."""
    h, w = depth.shape
    return depth.dtype == color.dtype == np.float32 and color.shape == (h, w, 3)


def frame_to_wire(depth: np.ndarray, color: np.ndarray, out=None) -> tuple[np.ndarray, np.ndarray]:
    """v1 wire: depth clipped to [0, 65] m. ``out=(d16, c8)`` writes into the
    caller's buffers."""
    h, w = depth.shape
    d16, c8 = _out(out, (((h, w), np.uint16), ((h, w, 3), np.uint8)), "frame_to_wire")
    lib = _load()
    if lib is None or not _native_inputs(depth, color):
        d16[:], c8[:] = _frame_to_wire_np(depth, color)
        return d16, c8
    d, c = _f32(depth), _f32(color)
    lib.frame_to_wire(d.ctypes.data, c.ctypes.data, h, w, d16.ctypes.data, c8.ctypes.data)
    return d16, c8


def _frame_to_wire_np(depth: np.ndarray, color: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    d16 = (np.clip(depth, 0.0, 65.0) * 1000.0 + 0.5).astype(np.uint16)
    c8 = (np.clip(color, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return d16, c8


def frame_to_wire2(
    depth: np.ndarray,
    color: np.ndarray,
    out=None,
    depth_min: float = 0.0,
    depth_max: float = 65.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Depth outside [depth_min, depth_max] becomes invalid (0). H and W
    must be even. ``out=(d16, y8, c8h)`` writes into the caller's buffers
    (the pipeline's FrameStore slab rows)."""
    h, w = depth.shape
    d16, y8, c8h = _out(out, (((h, w), np.uint16), ((h, w), np.uint8), ((h // 2, w // 2, 3), np.uint8)),
                        "frame_to_wire2")
    lib = _load()
    if lib is None or not _native_inputs(depth, color):
        d16[:], y8[:], c8h[:] = _frame_to_wire2_np(depth, color, depth_min, depth_max)
        return d16, y8, c8h
    d, c = _f32(depth), _f32(color)
    lib.frame_to_wire2(d.ctypes.data, c.ctypes.data, h, w, depth_min, depth_max, d16.ctypes.data,
                       y8.ctypes.data, c8h.ctypes.data)
    return d16, y8, c8h


def _frame_to_wire2_np(depth, color, depth_min: float = 0.0, depth_max: float = 65.0):
    din = np.where((depth >= depth_min) & (depth <= depth_max), depth, 0.0)
    d16 = (din.astype(np.float32) * np.float32(1000.0) + np.float32(0.5)).astype(np.uint16)
    lum = color[..., 0] * 0.299 + color[..., 1] * 0.587 + color[..., 2] * 0.114
    y8 = (np.clip(lum, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    half = 0.25 * (color[0::2, 0::2] + color[0::2, 1::2] + color[1::2, 0::2] + color[1::2, 1::2])
    c8h = (np.clip(half, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return d16, y8, c8h


def pack_depth12(d16: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """2 depth pixels -> 3 wire bytes, row-major (values must be below 4096
    mm: callers gate on the sensor ceiling; the size must be even).
    ``out`` is a C-contiguous uint8 buffer of size/2*3 bytes, any shape."""
    flat = np.ascontiguousarray(d16, dtype=np.uint16).reshape(-1)
    n = flat.shape[0]
    if n % 2:
        raise ValueError("pack_depth12 needs an even number of pixels")
    if out is None:
        out = np.empty((n // 2 * 3,), np.uint8)
    elif out.dtype != np.uint8 or out.size != n // 2 * 3 or not out.flags.c_contiguous:
        raise ValueError(f"pack_depth12: out must be C-contiguous uint8 of {n // 2 * 3} bytes")
    lib = _load()
    if lib is None:
        out.reshape(-1)[:] = _pack_depth12_np(flat)
        return out
    lib.pack_depth12(flat.ctypes.data, n, out.ctypes.data)
    return out


def _pack_depth12_np(d16: np.ndarray) -> np.ndarray:
    p = d16.reshape(-1, 2).astype(np.uint32)
    trip = np.empty((p.shape[0], 3), np.uint8)
    trip[:, 0] = p[:, 0] & 0xFF
    trip[:, 1] = (p[:, 0] >> 8) | ((p[:, 1] & 0xF) << 4)
    trip[:, 2] = p[:, 1] >> 4
    return trip.reshape(-1)


def _spatial_weights(sigma_d: float) -> np.ndarray:
    """The 25 float64 spatial weights in tap order, as the numpy twin makes them."""
    inv_2sd2 = 1.0 / (2.0 * sigma_d * sigma_d)
    return np.array([np.float64(np.exp(-(dy * dy + dx * dx) * inv_2sd2)) for dy in range(-2, 3)
                     for dx in range(-2, 3)])


def bilateral_wire(d16: np.ndarray, sigma_d: float, sigma_r: float) -> np.ndarray:
    """5x5 zero-aware bilateral on wire-format depth (uint16 mm); a
    neighbour outside the frame contributes nothing."""
    lib = _load()
    if lib is None:
        return _bilateral_wire_np(d16, sigma_d, sigma_r)
    h, w = d16.shape
    src = np.ascontiguousarray(d16, dtype=np.uint16)
    out = np.empty((h, w), np.uint16)
    spatial = _spatial_weights(sigma_d)
    lib.bilateral_wire_u16(src.ctypes.data, h, w, spatial.ctypes.data,
                           float(np.float32(1.0 / (2.0 * sigma_r * sigma_r))), out.ctypes.data)
    return out


def _shifted(a: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """out[y, x] = a[y - dy, x - dx]; vacated pixels are 0."""
    out = np.zeros_like(a)
    ys0, ys1 = max(dy, 0), a.shape[0] + min(dy, 0)
    xs0, xs1 = max(dx, 0), a.shape[1] + min(dx, 0)
    out[ys0:ys1, xs0:xs1] = a[ys0 - dy : ys1 - dy, xs0 - dx : xs1 - dx]
    return out


def _bilateral_wire_np(d16: np.ndarray, sigma_d: float, sigma_r: float) -> np.ndarray:
    """The numpy bilateral. The dtypes are NumPy 2's for the JAX package's
    expressions, written out so that they hold under any NumPy: the spatial
    weight is a float64 scalar, so each tap's weight and weighted depth are
    float64, while the accumulators stay float32 (each ``+=`` rounds its
    float64 sum)."""
    d = d16.astype(np.float32) * np.float32(1e-3)
    acc = np.zeros_like(d)
    wacc = np.zeros_like(d)
    inv_2sr2 = np.float32(1.0 / (2.0 * sigma_r * sigma_r))
    spatial = _spatial_weights(sigma_d)
    for t, (dy, dx) in enumerate((dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)):
        n = _shifted(d, dy, dx)
        w_range = np.exp(-((n - d) ** 2) * inv_2sr2).astype(np.float64)
        w = spatial[t] * w_range * (n > 0)
        acc = (acc.astype(np.float64) + w * n.astype(np.float64)).astype(np.float32)
        wacc = (wacc.astype(np.float64) + w).astype(np.float32)
    out = np.where((d > 0) & (wacc > 0), acc / np.maximum(wacc, np.float32(1e-12)), np.float32(0.0))
    return np.clip(out * np.float32(1000.0) + np.float32(0.5), 0, 65535).astype(np.uint16)
