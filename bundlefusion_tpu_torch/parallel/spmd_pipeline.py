"""End-to-end multi-sequence pipeline over a mesh
(port of ``bundlefusion_tpu.parallel.spmd_pipeline``).

:func:`run_sequences_sharded` replays D sequences over a D-shard mesh in
lockstep: each chunk round runs, for every shard on its own device, the
same steps as the serial pipeline (``bundle/pipeline.py``) — the chunk
program (preprocess with K2, SIFT, matching, filters, local BA), the
keyframe-graph step (add, match, relocalize, the tracking-lost state
machine), global BA, trajectory publish, and the plan + ring + de/re-
integrate TSDF step (K1) — on that shard's sequence, with no traffic between
shards.

Frames travel as the v1 wire (``framewire.frame_to_wire``: uint16 mm depth
and full-resolution uint8 RGB), so the chunk program takes its RGB branch
and the frame ring holds full-resolution colour [R, H, W, 3]; with
``integrate_filtered_depth`` the wire depth is filtered first, as in the
serial pipeline.

The driver reads nothing back until the final fetch: chunk validity,
relocalization, re-integration plans and diagnostics stay on the devices.

Not supported in the sharded driver (as in the JAX package): out-of-core
streaming, stale-keyframe revalidation and the finalize-time ring-spill
service; run those through the serial pipeline. The driver integrates at
the input resolution whatever the configuration's integration resolution,
as the JAX package's does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..bundle import chunk as chunk_mod
from ..bundle import global_graph
from ..bundle.pipeline import (
    FusionState,
    _graph_step,
    _plan_and_fuse,
    _publish_all,
    make_fusion_state,
    step_inputs,
)
from ..config import Config
from ..fusion import blocks, marching_cubes
from ..geometry.camera import CameraModel
from ..io import framewire
from ..utils.tensor_ops import copy_into
from .mesh import Mesh


class ShardedOutputs(NamedTuple):
    poses: np.ndarray  # [D, F, 4, 4]
    valid: np.ndarray  # [D, F]
    num_keyframes: int
    tables: list[blocks.BlockTable]  # table i on shard i's device
    runlogs: np.ndarray  # [D, C, RUNREC_WIDTH] per-sequence diagnostics rows


def _upload(d16: np.ndarray, c8: np.ndarray, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk's v1 wire in one pinned buffer (on a card) and one
    non-blocking copy -> (depth [cf, H, W] int16, colour [cf, H, W, 3] uint8)."""
    n1 = d16.nbytes
    pinned = device.type == "cuda"
    flat = torch.empty(n1 + c8.nbytes, dtype=torch.uint8, pin_memory=pinned)
    host = flat.numpy()
    host[:n1].view(np.uint16).reshape(d16.shape)[:] = d16
    host[n1:].reshape(c8.shape)[:] = c8
    dev = flat.to(device, non_blocking=pinned)
    return dev[:n1].view(torch.int16).view(d16.shape), dev[n1:].view(c8.shape)


class ShardedRun:
    """The state and steps of :func:`run_sequences_sharded`: set up on
    construction (wire conversion of every frame, the shards' state),
    :meth:`step` runs one chunk round over every shard, :meth:`outputs`
    fetches the results (the run's first device reads)."""

    def __init__(self, sequences, mesh: Mesh, config: Config | None = None, anchor_poses: np.ndarray | None = None):
        cfg = config or Config()
        cfg.validate()
        bc, ac = cfg.bundling, cfg.app
        d = mesh.size
        if len(sequences) != d:
            raise ValueError(f"need {d} sequences for a {d}-shard mesh, got {len(sequences)}")
        cam: CameraModel = sequences[0].camera
        if any(s.camera != cam for s in sequences):
            raise ValueError("sequences must share intrinsics")
        self.mesh, self.config, self.cam = mesh, cfg, cam
        self.cache_cam = cam.scaled(bc.cache_width, bc.cache_height)
        n_frames = min(s.depth.shape[0] for s in sequences)
        self.n_chunks = max(0, (n_frames - 1) // bc.submap_size)
        if self.n_chunks > min(bc.max_frames // bc.submap_size, bc.max_num_images):
            raise ValueError(f"{self.n_chunks} chunks exceed the keyframe/chunk capacity")
        anchors = np.broadcast_to(np.eye(4, dtype=np.float32), (d, 4, 4)) if anchor_poses is None else anchor_poses

        def to_wire(seq, f):
            d16, c8 = framewire.frame_to_wire(seq.depth[f], seq.color[f])
            if ac.integrate_filtered_depth:
                d16 = framewire.bilateral_wire(d16, ac.depth_sigma_d, ac.depth_sigma_r)
            return d16, c8

        self.wires = []  # per shard: (depth [F, H, W] uint16, colour [F, H, W, 3] uint8)
        for s in sequences:
            frames = [to_wire(s, f) for f in range(n_frames)]
            self.wires.append((np.stack([x for x, _ in frames]), np.stack([y for _, y in frames])))
        # one state per shard; the ring holds full-resolution colour (v1 wire)
        self.shards = [make_fusion_state(cfg, cam, (cam.height, cam.width), anchors[i], dev)
                       for i, dev in enumerate(mesh.devices)]

    def step(self, c: int) -> None:
        """Chunk round ``c``: every shard consumes frames [c*S, c*S + S]."""
        bc = self.config.bundling
        first, cf = c * bc.submap_size, bc.chunk_size
        for sh, dev, (d16, c8) in zip(self.shards, self.mesh.devices, self.wires):
            self._shard_chunk(sh, c, *_upload(d16[first : first + cf], c8[first : first + cf], dev))

    def _shard_chunk(self, sh: FusionState, c: int, dep: torch.Tensor, col: torch.Tensor) -> None:
        bc, ac = self.config.bundling, self.config.app
        S, cf = bc.submap_size, bc.chunk_size
        res = chunk_mod.process_chunk(
            dep, col, self.cam, self.cache_cam, bc, sigma_d=ac.depth_sigma_d, sigma_r=ac.depth_sigma_r,
            filter_depth=ac.depth_filter and not ac.integrate_filtered_depth,
        )
        # the chunk's inputs, made on the device; the step updates sh in place
        step = step_inputs(c, S, cf, dep.device)
        integrate_mask, stats_in = _graph_step(sh, step, res, self.cache_cam, bc, is_first=(c == 0))
        if c > 0:
            global_graph.global_solve(sh.graph, self.cache_cam, bc)
        _publish_all(sh, S, cf)
        # a fixed new-frame width: the overlap frame (already integrated)
        # is a masked row after chunk 0
        _plan_and_fuse(sh, ac, self.cam, step, stats_in, dep, col, integrate_mask,
                       budget=ac.max_reintegrations_per_frame * S)
        if ac.gc_every_chunks and (c + 1) % ac.gc_every_chunks == 0:
            table, freed = blocks.garbage_collect(sh.table)
            copy_into(sh.table, table)
            sh.gc_freed_total.add_(freed.to(torch.float32))

    def outputs(self) -> ShardedOutputs:
        """The run's first device reads: poses, validity and runlogs, each
        stacked on shard 0's device and fetched once."""
        S = self.config.bundling.submap_size
        n_out = self.n_chunks * S + 1 if self.n_chunks else 0
        dev0 = self.mesh.devices[0]

        def fetch(get):
            return torch.stack([get(sh).to(dev0) for sh in self.shards]).cpu().numpy()

        return ShardedOutputs(
            poses=fetch(lambda sh: sh.traj.opt_pose[:n_out]),
            valid=fetch(lambda sh: sh.traj.opt_valid[:n_out]),
            num_keyframes=self.n_chunks,
            tables=[sh.table for sh in self.shards],
            runlogs=fetch(lambda sh: sh.runlog_rows[: self.n_chunks]),
        )


def run_sequences_sharded(
    sequences,  # D sequences (depth [F, H, W], color [F, H, W, 3], camera), one per shard
    mesh: Mesh,
    config: Config | None = None,
    anchor_poses: np.ndarray | None = None,  # [D, 4, 4]
) -> ShardedOutputs:
    run = ShardedRun(sequences, mesh, config, anchor_poses)
    for c in range(run.n_chunks):
        run.step(c)
    return run.outputs()


def extract_mesh_for(outputs: ShardedOutputs, seq_idx: int, cfg: Config):
    """Mesh one sequence's reconstruction."""
    return marching_cubes.extract_mesh(outputs.tables[seq_idx], cfg.app)
