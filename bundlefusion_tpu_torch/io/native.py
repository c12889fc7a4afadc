"""ctypes bindings for the native .sens codec (port of
``bundlefusion_tpu.io.native``): RVL encode/decode and zlib inflate/deflate
from ``native/sensio.cpp``.

The library is built on first use with ``g++ -O3 -shared -fPIC ... -lz``
into the git-ignored ``bundlefusion_tpu_torch/_build/`` (never into
``native/``) and rebuilt when the source is newer. Where it cannot be built,
every entry point falls back to pure Python (the RVL codec of ``io/sens.py``
and the standard library's zlib), as in the JAX package; :func:`have_native`
says which path runs, and ``chip_smoke.py`` prints it.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import zlib

import numpy as np

from . import sens

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(_HERE, "..", "..", "native", "sensio.cpp"))
LIB_PATH = os.path.abspath(os.path.join(_HERE, "..", "_build", "libsensio.so"))

_L, _P = ctypes.c_long, ctypes.c_void_p
_SIGNATURES = {
    "rvl_encode": [_P, _L, _P],
    "rvl_decode": [_P, _L, _P, _L],
    "zlib_inflate": [_P, _L, _P, _L],
    "zlib_deflate": [_P, _L, _P, _L, ctypes.c_int],
}


def build() -> None:
    """Compile ``native/sensio.cpp`` into ``_build/libsensio.so`` if it is
    missing or older than the source (raises on a failed build)."""
    if os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SRC):
        return
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, SRC, "-lz"], check=True, capture_output=True)
    os.replace(tmp, LIB_PATH)


@functools.lru_cache(maxsize=1)
def _load() -> ctypes.CDLL | None:
    """The codec library, built and loaded once per process; None where it
    cannot be built or loaded."""
    try:
        build()
        lib = ctypes.CDLL(LIB_PATH)
    except (OSError, subprocess.CalledProcessError):
        return None
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_long
    return lib


def have_native() -> bool:
    return _load() is not None


def rvl_encode(depth: np.ndarray) -> bytes:
    """uint16 array (any shape) -> RVL bytes."""
    d = np.ascontiguousarray(depth, dtype=np.uint16).reshape(-1)
    lib = _load()
    if lib is None:
        return sens.rvl_encode(d)
    out = np.empty(d.size * 3 + 16, dtype=np.uint8)
    n = lib.rvl_encode(d.ctypes.data, d.size, out.ctypes.data)
    return out[:n].tobytes()


def rvl_decode(data: bytes, npix: int) -> np.ndarray:
    """RVL bytes -> uint16 array [npix]."""
    lib = _load()
    if lib is None:
        return sens.rvl_decode(data, npix)
    buf = np.frombuffer(data, dtype=np.uint8)
    # pad to whole 32-bit words, plus slack for the reader
    buf = np.concatenate([buf, np.zeros((-len(buf)) % 4 + 8, np.uint8)])
    out = np.empty(npix, dtype=np.uint16)
    n = lib.rvl_decode(buf.ctypes.data, len(buf), out.ctypes.data, npix)
    if n != npix:
        raise ValueError(f"RVL decode produced {n} of {npix} pixels")
    return out


def inflate(data: bytes, out_size: int) -> bytes:
    """zlib-decompress ``data``, whose output holds at most ``out_size`` bytes."""
    lib = _load()
    if lib is None:
        return zlib.decompress(data)
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(out_size, dtype=np.uint8)
    n = lib.zlib_inflate(buf.ctypes.data, len(buf), out.ctypes.data, out_size)
    if n < 0:
        raise ValueError("zlib inflate failed")
    return out[:n].tobytes()


def deflate(data: bytes, level: int = 1) -> bytes:
    lib = _load()
    if lib is None:
        return zlib.compress(data, level)
    buf = np.frombuffer(data, dtype=np.uint8)
    cap = len(data) + (len(data) >> 9) + 64
    out = np.empty(cap, dtype=np.uint8)
    n = lib.zlib_deflate(buf.ctypes.data, len(buf), out.ctypes.data, cap, level)
    if n < 0:
        raise ValueError("zlib deflate failed")
    return out[:n].tobytes()
