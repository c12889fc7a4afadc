"""Time-parallel chunk processing with a halo exchange
(port of ``bundlefusion_tpu.parallel.timeshard``).

Chunks of one sequence are sharded along time: given D shards and frames
[D*S + 1] (S = submap size), shard d processes chunk d = frames
[d*S, (d+1)*S]. Each chunk's local BA is anchored at its own first frame, so
chunks are independent given their frames; the one cross-shard dependency is
the overlap frame (the first frame of chunk d+1), which arrives from the
right neighbour by :func:`~.mesh.ppermute`; the last shard uses the tail
frame D*S. The keyframe chaining that follows is a cheap serial tail.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..bundle import chunk as chunk_mod
from ..config import BundlingConfig
from ..features.sift import SiftKeys
from ..geometry.camera import CameraModel
from ..ops.preprocess import FrameCache
from .mesh import Mesh, all_gather, ppermute


def make_timeshard_chunk_fn(mesh: Mesh, cam: CameraModel, cache_cam: CameraModel, cfg: BundlingConfig):
    """Returns fn(depth [D*S, H, W], color [D*S, H, W, 3], tail_depth [H, W],
    tail_color [H, W, 3]) -> (local_trajs [D, S+1, 4, 4], chunk_valid [D],
    keyframe keys [D, ...], keyframe caches [D, ...])."""
    s = cfg.submap_size

    def fn(depth, color, tail_depth, tail_color):
        d = mesh.size
        if depth.shape[0] != d * s:
            raise ValueError(f"expected {d} x {s} frames, got {depth.shape[0]}")
        dep = [torch.as_tensor(depth[i * s : (i + 1) * s]).to(dev) for i, dev in enumerate(mesh.devices)]
        col = [torch.as_tensor(color[i * s : (i + 1) * s]).to(dev) for i, dev in enumerate(mesh.devices)]
        # shard i receives shard i+1's first frame; the last shard, whose
        # right neighbour wraps around, takes the tail frame instead
        perm = [(i, (i - 1) % d) for i in range(d)]
        halo_d = ppermute(mesh, [x[0] for x in dep], perm)
        halo_c = ppermute(mesh, [x[0] for x in col], perm)
        halo_d[-1] = torch.as_tensor(tail_depth).to(mesh.devices[-1])
        halo_c[-1] = torch.as_tensor(tail_color).to(mesh.devices[-1])
        res = [
            chunk_mod.process_chunk(torch.cat([dep[i], halo_d[i][None]]), torch.cat([col[i], halo_c[i][None]]),
                                    cam, cache_cam, cfg)
            for i in range(d)
        ]

        def gather(cls, field):
            return cls(*(all_gather(mesh, [getattr(field(r), f.name)[None] for r in res])
                         for f in dataclasses.fields(cls)))

        return (
            all_gather(mesh, [r.local_traj[None] for r in res]),
            all_gather(mesh, [r.chunk_valid[None] for r in res]),
            gather(SiftKeys, lambda r: r.keyframe_keys),
            gather(FrameCache, lambda r: r.keyframe_cache),
        )

    return fn


def chain_keyframe_poses(local_trajs: np.ndarray, anchor: np.ndarray) -> np.ndarray:
    """Serial composition of the chunk-parallel results [D, S+1, 4, 4]:
    keyframe d's world pose = anchor o prod_{c<d} local_traj_c[-1]."""
    d = local_trajs.shape[0]
    poses = np.zeros((d, 4, 4), np.float32)
    cur = anchor.astype(np.float32)
    for c in range(d):
        poses[c] = cur
        cur = cur @ local_trajs[c, -1]
    return poses
