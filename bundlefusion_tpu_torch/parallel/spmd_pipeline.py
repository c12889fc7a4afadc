"""End-to-end multi-sequence pipeline over a mesh
(port of ``bundlefusion_tpu.parallel.spmd_pipeline``).

:func:`run_sequences_sharded` replays D sequences over a D-shard mesh in
lockstep, with no traffic between shards: each chunk round runs, for every
shard on its own device and stream, the serial pipeline's chunk step
(``bundle/step.py``: ``step.ChunkStep``, without stamps, with the plain
global solve) on that shard's sequence, as the JAX package runs each stage
as one ``jax.jit(shard_map(...))`` program per round. Every shard checks out
an executable of its own from the chunk step's cache, keyed by
configuration, device, camera and the v1 wire (its static wire buffers:
depth [cf, H, W] int16, colour [cf, H, W, 3] uint8), and uploads its chunk
from a warm pinned 3-deep rotation (``ingest.staging_checkout``) straight
into that wire, after waiting on the event recorded behind the buffer's
last copy (a host wait, no readback).

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

from ..bundle import global_graph, ingest, step as step_mod
from ..config import Config
from ..fusion import blocks, marching_cubes
from ..geometry.camera import CameraModel
from ..io import framewire
from ..utils import graphs
from .mesh import Mesh


class ShardedOutputs(NamedTuple):
    poses: np.ndarray  # [D, F, 4, 4]
    valid: np.ndarray  # [D, F]
    num_keyframes: int
    tables: list[blocks.BlockTable]  # table i on shard i's device (the shard executable's own: see ShardedRun)
    runlogs: np.ndarray  # [D, C, RUNREC_WIDTH] per-sequence diagnostics rows


class _Tables(list):
    """The shards' block tables, which live in their executables' state:
    the executables return to the cache only when the run and every holder
    of this list are gone, so that a later run cannot reset tables a caller
    still reads."""


class ShardedRun:
    """The state and steps of :func:`run_sequences_sharded`: set up on
    construction (wire conversion of every frame, one executable per shard),
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

        # one executable per shard: the ring holds full-resolution colour (v1 wire)
        cf, h, w = bc.chunk_size, cam.height, cam.width
        self.tables = _Tables()
        self.exes: list[graphs.Executable] = []
        self._steps: list[step_mod.ChunkStep] = []
        for i, dev in enumerate(mesh.devices):
            def fresh(i=i, dev=dev):
                return step_mod.make_fusion_state(cfg, cam, (h, w), anchors[i], dev)

            def wire(dev=dev):
                return (torch.zeros((cf, h, w), dtype=torch.int16, device=dev),
                        torch.zeros((cf, h, w, 3), dtype=torch.uint8, device=dev))

            key = (cfg.to_json(), str(dev), tuple(cam), "v1 wire")
            exe = step_mod.checkout_step(self.tables, key, dev, fresh, anchors[i], wire, bc.submap_size, cf)
            self.exes.append(exe)
            self.tables.append(exe.state.fusion.table)
            # integration at the input resolution, from the wire's depth and RGB
            self._steps.append(step_mod.ChunkStep(
                exe, cfg, cam, cam, solve=(global_graph.global_solve, exe.state.fusion.graph, self.cache_cam, bc),
                route=graphs.route_for(dev)))
        self.shards: list[step_mod.FusionState] = [exe.state.fusion for exe in self.exes]
        # per shard, a warm 3-deep rotation of host buffers (pinned on a card)
        spec = (((cf, h, w), np.uint16), ((cf, h, w, 3), np.uint8))
        self._staging = [ingest.staging_checkout(self, spec, pinned=dev.type == "cuda") for dev in mesh.devices]

    @property
    def graph_stats(self) -> list[dict[str, dict]]:
        """Per shard, per stage (after this run ran it once): ``graph``
        (captured), ``replays`` by this run, ``captured`` (by this run),
        ``capture_s`` and ``route`` ("graph", or why it runs eagerly)."""
        return [s.stats() for s in self._steps]

    def step(self, c: int) -> None:
        """Chunk round ``c`` (rounds run in order from 0): every shard
        consumes frames [c*S, c*S + S], on its own stream."""
        if c != self._steps[0].at:
            raise ValueError(f"chunk round {c} out of order: the shards' step inputs hold round {self._steps[0].at}")
        bc = self.config.bundling
        first, cf = c * bc.submap_size, bc.chunk_size
        for i, (d16, c8) in enumerate(self.wires):
            exe = self.exes[i]
            with graphs.stream_ctx(exe.device, exe.stream):
                self._upload(i, c, d16[first : first + cf], c8[first : first + cf])
                self._steps[i](c)

    def _upload(self, i: int, c: int, d16: np.ndarray, c8: np.ndarray) -> None:
        """Shard ``i``'s chunk into its static wire: one warm host buffer of
        the rotation, refilled once its last copy is done, then two copies
        (non-blocking from pinned memory on a card) in the shard's stream
        order."""
        buf = self._staging[i][c % ingest.STAGING_DEPTH]
        if buf.copied is not None:
            buf.copied.synchronize()  # an event of the shard's stream: no data comes back
        buf.arrays[0][:] = d16
        buf.arrays[1][:] = c8
        dw, cw = self.exes[i].state.wire
        n1 = d16.nbytes
        dw.copy_(buf.flat[:n1].view(torch.int16).view(dw.shape), non_blocking=True)
        cw.copy_(buf.flat[n1:].view(cw.shape), non_blocking=True)
        if self.exes[i].stream is not None:
            buf.copied = torch.cuda.Event()
            buf.copied.record()

    def outputs(self) -> ShardedOutputs:
        """The run's first device reads: poses, validity and runlogs, each
        stacked on shard 0's device and fetched once, after the caller's
        stream on each device has waited for the shards' streams."""
        S = self.config.bundling.submap_size
        n_out = self.n_chunks * S + 1 if self.n_chunks else 0
        dev0 = self.mesh.devices[0]
        for exe in self.exes:
            if exe.stream is not None:
                torch.cuda.current_stream(exe.device).wait_stream(exe.stream)

        def fetch(get):
            return torch.stack([get(sh).to(dev0) for sh in self.shards]).cpu().numpy()

        return ShardedOutputs(
            poses=fetch(lambda sh: sh.traj.opt_pose[:n_out]),
            valid=fetch(lambda sh: sh.traj.opt_valid[:n_out]),
            num_keyframes=self.n_chunks,
            tables=self.tables,
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
