"""Sensor interface: the contract a live input would implement
(port of ``bundlefusion_tpu.io.sensor``). Live device backends are not
ported; recorded-data replayers implement it."""

from __future__ import annotations

import abc
from typing import Iterator

import numpy as np

from ..geometry.camera import CameraModel


class RGBDSensor(abc.ABC):
    """Frame source contract: dataset replayers today, live devices later."""

    @property
    @abc.abstractmethod
    def camera(self) -> CameraModel:
        """Depth-registered intrinsics."""

    @abc.abstractmethod
    def frames(self) -> Iterator[tuple[np.ndarray, np.ndarray, float]]:
        """Yield (depth [H,W] float32 meters, colour [H,W,3] float32 [0,1],
        timestamp seconds) until the stream ends."""

    def record_to(self, path: str, poses: np.ndarray | None = None) -> None:
        """Dump the whole stream to a ``.sens`` container."""
        from . import sens

        depth, color = [], []
        for d, c, _ in self.frames():
            depth.append(d)
            color.append(c)
        if poses is None:
            poses = np.tile(np.eye(4, dtype=np.float32), (len(depth), 1, 1))
        sens.write_sens(path, np.stack(depth), np.stack(color), poses, self.camera)


class ReplaySensor(RGBDSensor):
    """Any replayer source (Synthetic/Tum/SensSource) as an RGBDSensor."""

    def __init__(self, source, fps: float = 30.0):
        self._source = source
        self._fps = fps

    @property
    def camera(self) -> CameraModel:
        return self._source.camera

    def frames(self):
        for i in range(len(self._source)):
            d, c = self._source.get(i)
            yield d, c, i / self._fps
