"""Multi-sequence data parallelism (port of ``bundlefusion_tpu.parallel.multiseq``).

The scale-out axis is sequences: one sequence per shard, each running the
whole chunk program (preprocess, SIFT, matching, filters, local BA) or the
TSDF integration on its own device, with no traffic between shards. The
sharded state is a list with one entry per shard, on that shard's device;
per-shard results are gathered onto shard 0's device in rank order.
"""

from __future__ import annotations

import torch

from ..bundle import chunk as chunk_mod
from ..config import AppConfig, BundlingConfig
from ..fusion import tsdf
from ..fusion.blocks import BlockTable
from ..geometry.camera import CameraModel
from .mesh import Mesh, all_gather


def make_multiseq_chunk_fn(mesh: Mesh, cam: CameraModel, cache_cam: CameraModel, cfg: BundlingConfig):
    """Returns fn(depth [D, S+1, H, W], color [D, S+1, H, W, 3]) ->
    (local_trajs [D, S+1, 4, 4], chunk_valid [D]): one chunk of D
    independent sequences, sequence i on shard i."""

    def fn(depth, color):
        res = [
            chunk_mod.process_chunk(
                torch.as_tensor(depth[i]).to(dev, non_blocking=True),
                torch.as_tensor(color[i]).to(dev, non_blocking=True),
                cam, cache_cam, cfg,
            )
            for i, dev in enumerate(mesh.devices)
        ]
        return (all_gather(mesh, [r.local_traj[None] for r in res]),
                all_gather(mesh, [r.chunk_valid[None] for r in res]))

    return fn


def make_multiseq_fusion_fn(mesh: Mesh, cam: CameraModel, app_cfg: AppConfig):
    """Returns fn(tables [D] (table i on shard i), depth [D, H, W], color
    [D, H, W, 3], poses [D, 4, 4]) -> tables: every shard integrates its
    sequence's frame into its own block table."""

    def fn(tables: list[BlockTable], depth, color, poses) -> list[BlockTable]:
        out = []
        for i, (t, dev) in enumerate(zip(tables, mesh.devices)):
            t, _ = tsdf.integrate(
                t, torch.as_tensor(depth[i]).to(dev), torch.as_tensor(color[i]).to(dev),
                torch.as_tensor(poses[i]).to(dev), cam, app_cfg,
            )
            out.append(t)
        return out

    return fn
