"""Dataset replayer (port of ``bundlefusion_tpu.io.replayer``): the sensor
layer is an iterator of fixed-shape numpy frame batches, decoded by a
prefetch thread while the caller consumes the previous batch."""

from __future__ import annotations

import queue
import threading
from typing import Iterator, NamedTuple

import numpy as np

from ..geometry.camera import CameraModel
from . import sens as sens_io
from . import tum as tum_io
from .synthetic import SyntheticSequence


class FrameBatch(NamedTuple):
    depth: np.ndarray  # [B, H, W] float32 meters (0 invalid)
    color: np.ndarray  # [B, H, W, 3] float32 [0,1]
    frame_ids: np.ndarray  # [B] int32 global frame indices
    valid: np.ndarray  # [B] bool — False rows are padding at sequence end


class Replayer:
    """Yields fixed-size FrameBatch objects; pads the tail batch."""

    def __init__(self, source, batch_size: int, prefetch: int = 2):
        self._source = source  # object with __len__, get(i) -> (depth, color)
        self.batch_size = batch_size
        self.camera: CameraModel = source.camera
        self.num_frames = len(source)
        self._prefetch = prefetch

    def __len__(self) -> int:
        return -(-self.num_frames // self.batch_size)

    def _make_batch(self, start: int) -> FrameBatch:
        b = self.batch_size
        h, w = self.camera.height, self.camera.width
        depth = np.zeros((b, h, w), dtype=np.float32)
        color = np.zeros((b, h, w, 3), dtype=np.float32)
        ids = np.arange(start, start + b, dtype=np.int32)
        valid = ids < self.num_frames
        for k in range(b):
            if valid[k]:
                depth[k], color[k] = self._source.get(start + k)
        return FrameBatch(depth, color, ids, valid)

    def __iter__(self) -> Iterator[FrameBatch]:
        """Iterate with a decode-prefetch thread. A decode error is raised
        here, in the consumer."""
        q: queue.Queue = queue.Queue(maxsize=self._prefetch)

        def worker():
            try:
                for i in range(len(self)):
                    q.put(self._make_batch(i * self.batch_size))
                q.put(None)
            except Exception as e:  # handed to the consumer, which re-raises it
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            yield item
        t.join(timeout=10.0)


class SyntheticSource:
    def __init__(self, seq: SyntheticSequence):
        self._seq = seq
        self.camera = seq.camera

    def __len__(self) -> int:
        return self._seq.depth.shape[0]

    def get(self, i: int):
        return self._seq.depth[i], self._seq.color[i]


class TumSource:
    def __init__(self, seq: tum_io.TumSequence):
        self._seq = seq
        self.camera = seq.camera

    def __len__(self) -> int:
        return len(self._seq.depth_paths)

    def get(self, i: int):
        return tum_io.load_frame(self._seq, i)


class SensSource:
    """Indexes a .sens file once; frames decode on demand (random access)."""

    def __init__(self, path: str):
        self._path = path
        self._frames: list[sens_io.SensFrame] = []
        header = None
        for h, fr in sens_io.iter_frames(path):
            header = h
            self._frames.append(fr)
        if header is None:
            raise ValueError(f"{path}: empty .sens file")
        self._header = header
        self.camera = sens_io.camera_from_header(header)
        self.gt_poses = np.stack([f.camera_to_world for f in self._frames])

    def __len__(self) -> int:
        return len(self._frames)

    def get(self, i: int):
        h, fr = self._header, self._frames[i]
        depth = sens_io.decode_depth(h, fr)
        color = sens_io.decode_color(h, fr)
        if color.shape[:2] != depth.shape:
            # nearest resample of colour to the depth resolution (registered frames)
            ys = (np.linspace(0, color.shape[0] - 1, depth.shape[0])).astype(int)
            xs = (np.linspace(0, color.shape[1] - 1, depth.shape[1])).astype(int)
            color = color[ys][:, xs]
        return depth, color
