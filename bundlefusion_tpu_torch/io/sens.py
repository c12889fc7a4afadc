"""Reader/writer for the ScanNet/BundleFusion ``.sens`` container
(port of ``bundlefusion_tpu.io.sens``, with its own copies of the pure-Python
codecs of ``bundlefusion_tpu.io.native``; ``io/native.py`` binds the C
codecs and falls back to these).

Layout (little-endian), version 4 (the reference's ``sensorData.h``):
  u32 version
  u64 strlen; char[strlen] sensor name
  calibrationColor: 16 f32 intrinsic + 16 f32 extrinsic
  calibrationDepth: 16 f32 intrinsic + 16 f32 extrinsic
  u32 colorCompressionType   (0 raw, 1 png, 2 jpeg)
  u32 depthCompressionType   (0 raw, 1 zlib, 2 occi/RVL)
  u32 colorWidth, colorHeight, depthWidth, depthHeight
  f32 depthShift             (depth value -> mm scale, typically 1000)
  u64 numFrames, then per frame:
    f32[16] cameraToWorld; u64 timestampColor, timestampDepth;
    u64 colorSizeBytes, depthSizeBytes; bytes...

Depth decodes with zlib or RVL through ``io/native.py`` (the C codec of
``native/sensio.cpp`` where it builds, else ``zlib`` and the RVL codec
below); JPEG/PNG colour needs PIL, imported only when such a file is read or
written.
"""

from __future__ import annotations

import io
import struct
import zlib
from typing import Iterator, NamedTuple

import numpy as np

from ..geometry.camera import CameraModel

COMPRESSION_COLOR = {0: "raw", 1: "png", 2: "jpeg"}
COMPRESSION_DEPTH = {0: "raw_ushort", 1: "zlib_ushort", 2: "occi_ushort"}


class SensHeader(NamedTuple):
    version: int
    sensor_name: str
    color_intrinsic: np.ndarray  # [4,4]
    color_extrinsic: np.ndarray
    depth_intrinsic: np.ndarray
    depth_extrinsic: np.ndarray
    color_compression: str
    depth_compression: str
    color_width: int
    color_height: int
    depth_width: int
    depth_height: int
    depth_shift: float
    num_frames: int


class SensFrame(NamedTuple):
    camera_to_world: np.ndarray  # [4,4] float32 (identity/-inf if untracked)
    timestamp_color: int
    timestamp_depth: int
    color_bytes: bytes
    depth_bytes: bytes


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("JPEG/PNG colour in a .sens file needs PIL (the Pillow package); "
                          "raw colour does not") from e
    return Image


def _read_mat4(f) -> np.ndarray:
    return np.frombuffer(f.read(64), dtype="<f4").reshape(4, 4).copy()


def read_header(f) -> SensHeader:
    (version,) = struct.unpack("<I", f.read(4))
    if version != 4:
        raise ValueError(f".sens version {version} unsupported (expected 4)")
    (strlen,) = struct.unpack("<Q", f.read(8))
    name = f.read(strlen).decode("ascii", errors="replace")
    ci, ce = _read_mat4(f), _read_mat4(f)
    di, de = _read_mat4(f), _read_mat4(f)
    cc, dc = struct.unpack("<II", f.read(8))
    cw, ch, dw, dh = struct.unpack("<IIII", f.read(16))
    (shift,) = struct.unpack("<f", f.read(4))
    (num_frames,) = struct.unpack("<Q", f.read(8))
    return SensHeader(
        version, name, ci, ce, di, de,
        COMPRESSION_COLOR.get(cc, "?"), COMPRESSION_DEPTH.get(dc, "?"),
        cw, ch, dw, dh, shift, num_frames,
    )


def iter_frames(path: str) -> Iterator[tuple[SensHeader, SensFrame]]:
    with open(path, "rb") as f:
        header = read_header(f)
        for _ in range(header.num_frames):
            c2w = _read_mat4(f)
            ts_c, ts_d = struct.unpack("<QQ", f.read(16))
            csz, dsz = struct.unpack("<QQ", f.read(16))
            cbytes = f.read(csz)
            dbytes = f.read(dsz)
            yield header, SensFrame(c2w, ts_c, ts_d, cbytes, dbytes)


# ---------------------------------------------------------------------------
# RVL depth codec (nibble varints of zero/nonzero run lengths and zigzag
# deltas, packed low nibble first into little-endian 32-bit words)
# ---------------------------------------------------------------------------


def rvl_encode(d: np.ndarray) -> bytes:
    """uint16 array (any shape) -> RVL bytes."""
    d = np.ascontiguousarray(d, dtype=np.uint16).reshape(-1)
    nibbles: list[int] = []

    def put(value: int) -> None:
        while True:
            nib = value & 0x7
            value >>= 3
            if value:
                nib |= 0x8
            nibbles.append(nib)
            if not value:
                break

    i, n, prev = 0, d.size, 0
    while i < n:
        start = i
        while i < n and d[i] == 0:
            i += 1
        put(i - start)
        start = i
        while i < n and d[i] != 0:
            i += 1
        put(i - start)
        for j in range(start, i):
            delta = int(d[j]) - prev
            prev = int(d[j])
            put((delta << 1) ^ (delta >> 63) if delta >= 0 else ((delta << 1) ^ -1) & 0xFFFFFFFF)
    if len(nibbles) % 8:
        nibbles += [0] * (8 - len(nibbles) % 8)
    arr = np.asarray(nibbles, dtype=np.uint32).reshape(-1, 8)
    words = np.zeros(arr.shape[0], dtype=np.uint32)
    for k in range(8):
        words |= arr[:, k] << (4 * k)
    return words.astype("<u4").tobytes()


def rvl_decode(data: bytes, npix: int) -> np.ndarray:
    """RVL bytes -> uint16 array [npix]."""
    words = np.frombuffer(data.ljust((len(data) + 3) // 4 * 4 + 8, b"\0"), dtype="<u4")
    nibbles = np.zeros(len(words) * 8, dtype=np.uint8)
    for k in range(8):
        nibbles[k::8] = (words >> (4 * k)) & 0xF
    pos = 0

    def get() -> int:
        nonlocal pos
        value, shift = 0, 0
        while True:
            nib = int(nibbles[pos])
            pos += 1
            value |= (nib & 0x7) << shift
            shift += 3
            if not (nib & 0x8):
                return value

    out = np.zeros(npix, dtype=np.uint16)
    i, current = 0, 0
    while i < npix:
        i += get()
        if i >= npix:
            break
        for _ in range(get()):
            zig = get()
            current += (zig >> 1) ^ -(zig & 1)
            out[i] = current
            i += 1
    return out


def decode_depth(header: SensHeader, frame: SensFrame) -> np.ndarray:
    """Decode depth to float32 meters [H, W] (through the native codec
    where it is built, ``io/native.py``)."""
    from . import native

    h, w = header.depth_height, header.depth_width
    if header.depth_compression == "zlib_ushort":
        d = np.frombuffer(native.inflate(frame.depth_bytes, h * w * 2), dtype="<u2").reshape(h, w)
    elif header.depth_compression == "raw_ushort":
        d = np.frombuffer(frame.depth_bytes, dtype="<u2").reshape(h, w)
    elif header.depth_compression == "occi_ushort":  # RVL (ScanNet v2 style)
        d = native.rvl_decode(frame.depth_bytes, h * w).reshape(h, w)
    else:
        raise NotImplementedError(header.depth_compression)
    return d.astype(np.float32) / header.depth_shift


def decode_color(header: SensHeader, frame: SensFrame) -> np.ndarray:
    """Decode colour to float32 [H, W, 3] in [0, 1]."""
    if header.color_compression == "raw":
        arr = np.frombuffer(frame.color_bytes, dtype=np.uint8)
        return arr.reshape(header.color_height, header.color_width, -1)[..., :3].astype(np.float32) / 255.0
    img = _pil_image().open(io.BytesIO(frame.color_bytes))
    return np.asarray(img, dtype=np.float32)[..., :3] / 255.0


def camera_from_header(header: SensHeader) -> CameraModel:
    k = header.depth_intrinsic
    return CameraModel.create(k[0, 0], k[1, 1], k[0, 2], k[1, 2], header.depth_width, header.depth_height)


def write_sens(
    path: str,
    depth: np.ndarray,  # [N, H, W] float32 meters
    color: np.ndarray,  # [N, H, W, 3] float32
    poses: np.ndarray,  # [N, 4, 4]
    camera: CameraModel,
    depth_shift: float = 1000.0,
    sensor_name: str = "bundlefusion_tpu_synth",
    color_compression: str = "raw",  # "raw" | "jpeg"
    jpeg_quality: int = 90,
) -> None:
    """Write a .sens (zlib depth; raw or JPEG colour): the same bytes as the
    JAX package's writer for the same arrays."""
    n, h, w = depth.shape
    ch, cw = color.shape[1], color.shape[2]
    cc_code = {"raw": 0, "jpeg": 2}[color_compression]
    intr = np.eye(4, dtype="<f4")
    intr[0, 0], intr[1, 1] = float(camera.fx), float(camera.fy)
    intr[0, 2], intr[1, 2] = float(camera.cx), float(camera.cy)
    with open(path, "wb") as f:
        f.write(struct.pack("<I", 4))
        name = sensor_name.encode("ascii")
        f.write(struct.pack("<Q", len(name)))
        f.write(name)
        for _ in range(2):  # colour, then depth calibration
            f.write(intr.tobytes())
            f.write(np.eye(4, dtype="<f4").tobytes())
        f.write(struct.pack("<II", cc_code, 1))  # colour codec, zlib depth
        f.write(struct.pack("<IIII", cw, ch, w, h))
        f.write(struct.pack("<f", depth_shift))
        f.write(struct.pack("<Q", n))
        for i in range(n):
            f.write(np.asarray(poses[i], dtype="<f4").tobytes())
            f.write(struct.pack("<QQ", i, i))
            c8 = (np.clip(color[i], 0, 1) * 255).astype(np.uint8)
            if color_compression == "jpeg":
                buf = io.BytesIO()
                # 4:4:4 chroma: subsampling wrecks small high-frequency images
                _pil_image().fromarray(c8).save(buf, format="JPEG", quality=jpeg_quality, subsampling=0)
                cbytes = buf.getvalue()
            else:
                cbytes = c8.tobytes()
            dbytes = zlib.compress(np.round(depth[i] * depth_shift).astype("<u2").tobytes(), level=1)
            f.write(struct.pack("<QQ", len(cbytes), len(dbytes)))
            f.write(cbytes)
            f.write(dbytes)
