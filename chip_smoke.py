#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``bundlefusion_tpu_torch``) once on one
NVIDIA card and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; a failing phase raises and the script
exits non-zero; there is no CPU fallback):

  1. device   — a CUDA device must be present; its name and power limit.
  2. build    — nvcc builds the kernels in ``bundlefusion_tpu_torch/csrc``.
  3. kernels  — each kernel against its plain PyTorch twin on the card at the
                flagship shapes, with CUDA-event timings (median of 20) and
                the least time the card could take for the same work:
                K1 over one flagship chunk's fuse (31 rows: 10 frames
                de-integrated, then re-integrated at moved poses, and 11 new
                frames integrated), once with the v2 wire's half-res colour
                and once with the v1 ring's full-res colour (bit-equal to the
                twin), and ``tsdf.deintegrate``'s single inverse row; K2 over
                a chunk's 11 frames with and without the point and normal
                maps; K3 (the normal-equation assembly, ``k3_cases``) at the
                global solve's 16,384 slots and n = 128 (filled by 60
                keyframes; by 7, as the flagship pass's last solve fills
                them; with the 4,096 dense-pair slots), at the local solve's
                shape, as a sharded partial (damping 0), at 262,144 slots and
                at n = 512, slots filled as a global graph fills them
                (``assembly_inputs``), against its twin (today's
                deterministic index_add_ body) and the six index_add_ calls
                alone, each case timed eagerly and in a CUDA graph beside its
                byte bound and its chain bound (the longest chain of
                dependent adds), then its edge cases
                (``assembly_edge_inputs``) bit for bit; K4 (SIFT's window
                sampling) at one flagship octave (11
                frames x 512 keys x 256 window points, border keys, clamped
                patch origins), both windows, against its twin and the matmul
                form it replaced; K5 (the dense verification) at its three
                call shapes on rendered 80x60 caches (``k5_cases``: a
                chunk's filter, its opt-verify, graph_step's match with 7
                and with 128 keyframe slots filled) and its edge cases
                (``verify_edge_inputs``), timed eagerly and in a CUDA graph
                against its twin and the matmul- and gather-form dense
                verification it replaced. Every kernel bit-equal to its
                twin.
  4. slice    — the flagship configuration of ``bench.py`` (640x480, 262,144
                blocks, 1 cm voxels) on 66 rendered frames through
                push_frame -> flush -> outputs (async ingest, the default):
                a warm pass, then a timed pass; every chunk valid, ATE <= 0.5
                cm, all five kernels launched (K1, K2, K4, K5 as counted per
                chunk).
                Then a small configuration (128x96, 13 frames) run on the CPU
                (twins) and twice on the card (kernels): CPU and card agree,
                and the card runs are bit-identical.
  5. syncs    — host syncs in the steady state, counted under
                ``torch.cuda.set_sync_debug_mode("warn")``: there must be no
                readback (deliberate syncs first show that the count works,
                on the caller's thread and on the ingest worker, and that
                "error" mode's exception comes back through the worker's
                future, and that waiting on a CUDA event is not counted);
                the ingest's waits that blocked (backpressure, staging,
                runahead) are reported by site from the pipeline's own count.
                The pass replays phase 4's graphs, chunk 0's included: every
                program at every chunk it runs, no capture.
  6. stream   — the flagship configuration with the default streaming
                schedule (a check every 16 chunks until streaming engages)
                on a 241-frame corridor walk rendered on the card, with the
                block pool cut to 4,480 blocks so that the walk outgrows it
                and the streaming radius to 2.5 m (see STREAM below):
                fps, stream-in/out counts and seconds, the host syncs and the
                chunks they occur at (streaming checks only), tracking, ATE,
                and the streaming-aware mesh (extract_mesh seconds and
                triangles; it must span the walked corridor). Then two more
                passes that digest the whole state after every stage of
                every chunk: the digests and all three meshes must be equal.
                The ``gc`` program (chunks 7, 15 and 23) is captured at its
                first call and replayed at the others, and replayed at all
                three by the first digested pass (the second, on a fresh
                executable, captures at chunk 7).
  7. reloc    — the out-and-back orbit with the depth blacked out over four
                frames, at 640x480 on the flagship configuration: a
                relocalization, finalize()'s revalidation, valid frames after
                the cut and their ATE; then the same scenario at 128x96 on
                the CPU (twins) and on the card (kernels) agreeing.
  8. app      — ``bundlefusion_tpu_torch.app.main`` on the card through the
                --synthetic and --sens routes at 640x480 with the flagship
                configuration: summary, mesh, trajectory, previews and
                checkpoint, ATE <= 0.5 cm on both; render_preview at 320x240.
  9. multiseq — the multi-sequence driver (``parallel/spmd_pipeline.py``) on
                two flagship sequences of 66 frames (seeds 0 and 1) over a
                2-shard mesh (both shards on cuda:0 with one card), each
                shard's stages captured as CUDA graphs in an executable of
                its own: a first run on fresh executables (fps over both,
                capture seconds, every chunk valid, ATE <= 0.5 cm each, one
                K1 and one K2 launch per shard and chunk, 0 host syncs in
                the chunk rounds, peak memory with two shard executables;
                the graphed runs on the reused executables, whose state is
                reset in place, peak within 0.05 GiB of it),
                then timed runs interleaved graphed / eager / eager /
                graphed (``graphs.disable_graphs()``): fps each way, the
                replays per shard and stage, each shard's state digests
                bit-equal in every run; a device-only trace of a graphed and
                an eager run (busy share, host launch calls per frame); the
                app's --multiseq 2 route; 2 shards at 128x96 on the CPU
                against the card.
 10. sharded  — phase 4's flagship pass with the global BA sharded over a
                2-shard mesh on the card, through the ``global_solve``
                program: a pass that captures, one that replays and an eager
                pass, bit-equal; fps, ATE, validity and the largest pose gap
                against phase 4's pass, global_solve time per chunk against
                phase 4's, 0 host syncs.
 11. configs  — the flagship pass with integrate_filtered_depth and with a
                320x240 integration resolution (fps, ATE, blocks, launches);
                the host time of the wire bilateral; the native .sens codecs
                (built or not) against pure Python, with equal bytes.
 12. ingest   — the native wire converter (it must be built) against numpy
                on a 640x480 frame: host ms and equal bytes or differing
                pixels; the flagship pass with async ingest and with
                BF_SYNC_INGEST=1: fps, the caller's seconds in push_frame,
                upload bytes of the first and steady chunks, readbacks (0)
                and the ingest's waits by site, equal state digests; a
                profile=True pass's stage table, its digests equal too; the
                filtered-depth pass on the native bilateral (fps, ATE);
                ``tools/profile_stages`` at 640x480 and
                ``tools/offline_matching`` on two orbit frames.
 13. paths    — the paths no earlier phase runs, each at 640x480 on the
                flagship configuration with async ingest and one K1 and one
                K2 launch per chunk, each printing fps, ATE and validity with
                the card's name and power limit:
                the dense global BA (``use_dense_global``, all 4,096 slots of
                the dense-pair list) on phase 4's frames: every chunk valid,
                ATE <= 0.5 cm (its ratio to phase 4's printed: the
                reference's colour term doubles it on this orbit), dense
                pairs collected and none dropped, no readback, global_solve
                against phase 4's, peak memory; then the out-and-back orbit
                sparse only and dense: correspondences between keyframes 3 or
                more apart, ATE < 2 cm and dense <= 1.10 x sparse + 1e-4 m
                (``tests/test_loopclosure.py``'s bar on its scenario); then
                at 128x96 on the CPU (twins) against the card;
                tracking loss: the out-and-back orbit (81 frames) with the
                depth zeroed over three whole chunks: the lost flag is not
                set before the third invalid chunk, is set on it and is
                clear at the end, a relocalization, valid frames after;
                noisy input (``apply_sensor_noise`` on phase 4's frames):
                bench.py's ``ate_noisy_cm`` and ``noisy_valid_fraction``, no
                lost chunk, ATE < 2 cm;
                4 mm voxels (``voxel_size`` 0.004, ``truncation`` 0.02) at
                262,144 blocks and ``blocks_per_frame_cap`` 4,096: the
                runlog's ``alloc_overflow`` and ``upd_truncated`` (reported,
                not asserted), active blocks, peak memory, ATE <= 0.5 cm,
                render_preview at 320x240.
 14. bench    — after an untraced warm pass (it captures the chunk step's
                graphs), two flagship passes of the bench's ``run_pass`` in
                this process: one with the device's activity alone traced
                (the busy share: the union of device intervals over the
                pass's host seconds; the longest idle gaps; one K1 and one
                K2 launch per chunk), one under torch.profiler with host ops
                of every thread (kernel launches and host launch calls per
                frame, the top 10
                device operations, the 5 longest idle gaps with the host
                spans open during each, idle time by stage, device time by
                stage and the port's five kernels by stage; the gzipped
                trace goes to ``chiprun_out/``); a profile without device
                events fails. Then the port's bench, ``python -m
                bundlefusion_tpu_torch.bench`` (the counterpart of
                bench.py), in a subprocess at the flagship (5 timed passes)
                and at 320x240 with 32,768 blocks (3 passes): its result
                line (the median fps) and diagnostics with the card's name
                and power limit; ATE <= 0.5 cm, the noisy pass's valid
                fraction 1.0, every chunk valid, every timed pass replaying
                the warm pass's graphs, and equal GN iterations and blocks
                updated in every pass (the bench raises otherwise).

 15. graphs   — the chunk step as captured CUDA graphs (``utils/graphs.py``,
                the default everywhere above) against the eager step
                (``graphs.disable_graphs()``) on phase 4's 66 frames: a
                graphed pass on a fresh executable (capture seconds per
                stage, its readbacks), then interleaved timed passes (E G G
                E E G: fps, stage means, peak memory each way), a graphed
                pass under the sync counter, and a device-only trace each
                way (busy share, device kernels and host launch calls per
                frame). Every pass bit-equal in its state digests and poses;
                the first pass captures each program at its first call; a
                later graphed pass replays every program at every chunk it
                runs (``graph_step_first`` once, ``chunk_local`` at every
                chunk); one K1 and one K2 launch per chunk, K4 twice per
                SIFT octave and chunk, K5 three times per chunk but the
                first (twice) and K3 at least once per GN iteration,
                counted through replays; 0 readbacks; ATE <= 0.5 cm, every
                chunk valid. Then a 70-chunk scan that crosses the graph
                step's first slot tier (``graph_step@64`` to
                ``graph_step@128``), graphed on a fresh executable and
                eager: every tier of the ladder captured once chunk 1 is
                dispatched, each replayed at every chunk that uses it,
                ``graph_slots`` the ladder's, state, poses and validity
                bit-equal; graph_step's device ms by tier. Then two
                programs of one executable: the outputs of the one
                captured second survive a replay of the first (they are
                not in the shared pool).
 16. denseref — the dense global term on the benchmark's dense cell
                (``bf640-1cm-denseglobal.room-sweep``'s configuration and
                traffic at ``DENSE_SEED``), through ``push_frame`` to chunk
                ``DENSE_CHUNK``: after chunks 0 and 1 (the captures),
                readbacks only at the streaming checks;
                global_solve's inputs at that chunk snapshotted on the
                pipeline's stream, and the blocks that its replayed graph's
                first GN iteration computed at all 4,096 slots (copied
                into a buffer by a copy captured with the stage), against
                the plain float64 reference
                (``benchmark/reference/dense_ba.py``, in blocks of pairs on
                the card): the share of live pairs within every tolerance
                (``dense_pair_errors``), slots not live all zero, and a
                bfloat16 control that fails; the card's name and power
                limit, the pipeline's peak memory and graph_step,
                global_solve and global_dense medians by slot tier.

Phases 4-14 run the chunk step graphed (each program captured at its first
call when its executable is fresh, chunk 0's stages at chunk 0, the graph
step's slot tiers all at chunk 1, and replayed after); phase 5's window replays the executable phase 4 captured,
and says so. Phases 4 and 6-15 set the kernels' launch counts to 0 before
their run and read them after it (a replay adds the launches its graph
captured): each of their paths must launch all five kernels. Small outputs
(summaries, trajectories, previews) go to the git-ignored ``chiprun_out/``.

The last two lines are a JSON object of the kernels' checks and timings and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import bisect
import contextlib
import copy
import dataclasses
import gc
import gzip
import hashlib
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback
import warnings
import zlib

import numpy as np

FLAGSHIP_FRAMES = 66
SMALL = dict(width=128, height=96, frames=13)
FULL = (640, 480)  # the flagship frame size of phases 6-11
# phase 6: a corridor walk long enough that the default streaming check
# (every 16 chunks) fires on its own (chunk 15 starts at frame 150), moving
# 0.0125 m per frame (the JAX package's streaming test moves 0.031 m). The
# walk stops at x = 3 m: further on, the second room's sphere passes within
# 0.3 m of the camera, and faster walks lose the keyframe chain at the first
# divider and never relocalize (the JAX package's known corridor fault,
# ROADMAP Queue 3). The view is at most ~2.3 m deep, so nothing is farther
# than the default 4 m radius before the walk is ~3 m long: the radius is
# cut to 2.5 m (the JAX package's streaming tests use 1.8-2.2 m). The pool
# is cut to 4,480 blocks: the walk fills ~4,100 by the first check and more
# than the pool by its end, so nothing overflows before streaming can
# engage, and the scene outgrows the pool after. The triangle cap is raised
# so that the whole corridor (~1.1 M triangles) is meshed.
STREAM = dict(frames=241, x_span=3.0, streaming_radius=2.5, block_capacity=4480, mc_max_triangles=1 << 23)
OUT_DIR = "chiprun_out"
HERE = os.path.dirname(os.path.abspath(__file__))
ATE_BAR = 0.005  # m, on the clean synthetic orbit at 640x480 (phases 9-11)
KEEP_BYTES = 48 << 20  # larger app outputs are checked, then deleted
# phase 13's tracking loss: the out-and-back orbit, long enough that the
# depth can be zeroed over three whole chunks (submap 10: chunks 2 and 3 have
# no depth at all, chunk 4 only in its last frame, 50) and the return
# relocalizes against the keyframes of the way out
TRACK = dict(frames=81, blackout=(20, 50))
# phase 14: the port's bench as a user runs it (a subprocess each), with
# bench.py's two lines: the flagship and the 320x240, 32,768-block line
BENCH_RUNS = (
    ("flagship", {"BENCH_PASSES": "5"}),
    ("320x240", {"BENCH_WIDTH": "320", "BENCH_HEIGHT": "240", "BENCH_BLOCKS": "32768", "BENCH_PASSES": "3"}),
)
# the diagnostics bench.py prints (bench.py:138-166), and the port's own
BENCH_KEYS = ("ate_cm", "keyframes", "blocks", "gn_iters_per_sec", "voxel_updates_per_sec", "timing",
              "ate_noisy_cm", "noisy_valid_fraction", "fps_passes", "device", "graph_replays", "capture_s",
              "timed_replayed_cached_graphs")

# The least time the card could take (the larger of bytes over the memory
# rate and operations over their unit's rate). Published peaks of one H100
# SXM: 3.35 TB/s HBM and 67 TFLOP/s f32 outside the tensor cores; the MUFU
# unit (expf, IEEE divide's reciprocal) gives 16 results per clock per SM
# (CUDA C++ Programming Guide, arithmetic throughput for compute capability
# 9.0) on 132 SMs at the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
MUFU_PER_S = 16 * 132 * 1.98e9
# operations of one K1 row update of one voxel (fusion/tsdf.py::
# _integrate_blocks_torch): projection 18, pixel 6, colour 3, truncation and
# sdf 3, running mean 12; three IEEE divides
K1_FLOPS, K1_MUFU = 42, 3
# one K2 tap: difference, square, scale, spatial x range, weight x depth, two
# sums; one expf
K2_TAP_FLOPS, K2_TAP_MUFU = 7, 1
# points and normals of one pixel: 4 neighbours' points (3 flops each
# coordinate), differences 6, cross product 9, norm 6, scaling and flip 7;
# the divides and the square root
K2_GEOM_FLOPS, K2_GEOM_MUFU = 64, 12


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(torch, fn, n: int = 20, batch: int = 5) -> float:
    """Median device time of one call of ``fn`` over ``n`` samples (CUDA
    events around ``batch`` calls back to back, so that the card, not the
    host's enqueueing of the first call, sets the time)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def graph_ms(torch, fn, calls: int = 20, n: int = 10) -> float:
    """Median device time of one call of ``fn`` with no host time in the
    way: ``calls`` calls captured in one CUDA graph (after a warm eager
    call), the graph replayed ``n`` times between CUDA events. A kernel
    shorter than its wrapper's host time (~20 us) is timed by ``cuda_ms``
    as the host's enqueue rate; here as the card runs it in a captured
    stage."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def host_ms(fn, n: int = 5) -> float:
    """Median host milliseconds of ``fn`` over ``n`` calls after a warm one."""
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def flagship_config():
    """bench.py's flagship configuration (the reference's 512^3-equivalent
    volume), as the port's bench defines it."""
    from bundlefusion_tpu_torch import bench

    return bench.bench_config(640, 480, 262144)


def small_config(T):
    c = T.tiny_test_config()
    w, h = SMALL["width"], SMALL["height"]
    app = dataclasses.replace(c.app, input_width=w, input_height=h, integration_width=w, integration_height=h)
    return dataclasses.replace(c, app=app)


def wire(seq, i, ac):
    from bundlefusion_tpu_torch.io import framewire

    return framewire.frame_to_wire2(seq.depth[i], seq.color[i], depth_min=ac.depth_min, depth_max=ac.depth_max)


def bound(nbytes: float, flops: float, mufu: float) -> tuple[float, str]:
    """(least milliseconds, "bytes" or "operations") for work of that size."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / F32_FLOPS, mufu / MUFU_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_entry(name, source, replaces, err, ms, plain_ms, bound_ms, bound_by, library_ms=None, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=0, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                share_of_bound=bound_ms / ms, **extra)


def check_k1(torch, T, dev, depth, c8, poses, cam, label="K1 tsdf_fuse"):
    """K1 over one flagship chunk's fuse, as plan_fuse builds it: the batch
    holds 11 new frames, then 10 frames integrated earlier; those 10 are
    de-integrated at their poses, then all 21 are integrated, the 10 at
    moved poses (R = 31 rows). ``c8`` is the half-res colour of the v2 wire
    or the full-res colour of the v1 ring (the multi-sequence driver's)."""
    from bundlefusion_tpu_torch.fusion import blocks, tsdf

    ac = flagship_config().app
    n_new, n_old = 11, 10
    n = n_new + n_old
    order = torch.cat([torch.arange(n_old, n, device=dev), torch.arange(n_old, device=dev)])
    depth, c8, poses = depth[order], c8[order], poses[order]
    old = torch.arange(n, device=dev) >= n_new
    table = blocks.make_table(ac.block_capacity, dev)
    table, diag = tsdf.integrate_batch(table, depth[n_new:], c8[n_new:], poses[n_new:], old[n_new:], cam, ac)
    moved = poses.clone()
    moved[n_new:, :3, 3] += torch.tensor([0.004, -0.003, 0.002], device=dev)
    rec = torch.zeros((n, ac.blocks_per_frame_cap), dtype=torch.bool, device=dev)
    rec[n_new:] = diag.upd_mask
    keys = torch.full(rec.shape, blocks.INVALID_KEY, dtype=torch.int32, device=dev)
    keys[n_new:] = diag.upd_keys
    table, rows, _ = tsdf.fuse_batch_rows(
        table, depth, poses, moved, old, torch.ones(n, dtype=torch.bool, device=dev), rec, cam, ac,
        upd_keys_rec=keys, deint_rows=n_old,
    )
    del diag

    def copy(t):
        return dataclasses.replace(t, sdf=t.sdf.clone(), weight=t.weight.clone(), color=t.color.clone())

    tk, tt = copy(table), copy(table)
    tsdf.integrate_blocks(tk, rows, depth, c8, ac)
    tsdf._integrate_rows_torch(tt, rows, depth, c8, ac)
    torch.cuda.synchronize()
    if not torch.equal(tk.weight, tt.weight):
        raise AssertionError(f"K1 weights differ from the twin at {int((tk.weight != tt.weight).sum())} voxels")
    err = max(float((tk.sdf - tt.sdf).abs().max()), float((tk.color - tt.color).abs().max()))
    if err > 1e-5:
        raise AssertionError(f"K1 sdf/colour differ from the twin by {err}")
    del tt
    tsdf.integrate_blocks(tk, rows.inverse(), depth, c8, ac)
    torch.cuda.synchronize()
    if not torch.equal(tk.weight, table.weight):
        raise AssertionError("K1 integrate then de-integrate did not restore the weights exactly")
    union = tsdf.fuse_worklist(rows, table.capacity)
    rgba = torch.nn.functional.pad(c8, (0, 1))
    live, applied, r = int((union != blocks.INVALID_KEY).sum()), int(rows.masks.sum()), rows.fidx.shape[0]
    ms = cuda_ms(torch, lambda: tsdf._launch_fuse(tk, rows, union, depth, rgba, ac))
    wrapper_ms = cuda_ms(torch, lambda: tsdf.integrate_blocks(tk, rows, depth, c8, ac))
    plain_ms = cuda_ms(torch, lambda: tsdf._integrate_rows_torch(tk, rows, depth, c8, ac), n=5, batch=1)
    # each live block read and written once (20 B per voxel each way), the
    # chunk's frames once, the rows' key, slot and mask lists once
    h, w = depth.shape[1:]
    nbytes = live * 512 * 40 + n * (h * w * 4 + c8[0].numel()) + rows.masks.numel() * 9
    bound_ms, bound_by = bound(nbytes, applied * 512 * K1_FLOPS, applied * 512 * K1_MUFU)
    phase("kernels", f"{label}: colour {tuple(c8.shape[1:3])}, R={r} rows, union {live} live blocks of {union.shape[0]} entries, "
          f"{applied} applied (row, block) pairs; weights bit-equal, max |sdf/colour err| {err:.3g}, "
          f"integrate+deintegrate exact; kernel {ms:.4f} ms, with its work list and checks "
          f"{wrapper_ms:.4f} ms, twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"share {bound_ms / ms:.3f}")
    return kernel_entry(
        "tsdf_integrate", "bundlefusion_tpu_torch/csrc/tsdf_integrate.cu",
        "bundlefusion_tpu/fusion/pallas_tsdf.py:84", err, ms, plain_ms, bound_ms, bound_by,
        rows=r, union_live=live, applied_pairs=applied, wrapper_ms=wrapper_ms,
    )


def check_deintegrate(torch, T, dev, depth, c8, poses, cam):
    """``tsdf.deintegrate`` (K1 with one inverse row) on a table that holds
    the chunk's first 11 frames: bit-equal to the twin on the same row, and
    integrate followed by it restores the weights exactly."""
    from bundlefusion_tpu_torch.fusion import blocks, tsdf

    ac = flagship_config().app
    table = blocks.make_table(ac.block_capacity, dev)
    table, _ = tsdf.integrate_batch(table, depth[:11], c8[:11], poses[:11], torch.ones(11, dtype=torch.bool,
                                    device=dev), cam, ac)
    f = 5
    cap = ac.blocks_per_frame_cap
    keys = blocks.dedup_keys(tsdf.frame_alloc_keys(depth[f], poses[f], cam, ac), cap)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    rows = tsdf._fuse_rows(table, keys[None], torch.ones((1, cap), dtype=torch.bool, device=dev), one,
                           torch.zeros(1, dtype=torch.int64, device=dev), poses[f][None], -torch.ones(1, device=dev),
                           cam)

    def copy(t):
        return dataclasses.replace(t, sdf=t.sdf.clone(), weight=t.weight.clone(), color=t.color.clone())

    tk, tt = copy(table), copy(table)
    tsdf.deintegrate(tk, depth[f], c8[f], poses[f], cam, ac)
    tsdf._integrate_rows_torch(tt, rows, depth[f][None], c8[f][None], ac)
    torch.cuda.synchronize()
    if not torch.equal(tk.weight, tt.weight):
        flips = int((tk.weight != tt.weight).sum())
        raise AssertionError(f"deintegrate's weights differ from the twin at {flips} voxels")
    err = max(float((tk.sdf - tt.sdf).abs().max()), float((tk.color - tt.color).abs().max()))
    if err > 1e-5:
        raise AssertionError(f"deintegrate's sdf/colour differ from the twin by {err}")
    del tt
    back, diag = tsdf.integrate(copy(tk), depth[f], c8[f], poses[f], cam, ac)
    tsdf.deintegrate(back, depth[f], c8[f], poses[f], cam, ac, diag.upd_mask)
    exact = torch.equal(back.weight, tk.weight)
    applied = int(rows.masks.sum())
    d1, rgba = depth[f][None], torch.nn.functional.pad(c8[f][None], (0, 1))
    union = tsdf.fuse_worklist(rows, table.capacity)
    ms = cuda_ms(torch, lambda: tsdf._launch_fuse(tk, rows, union, d1, rgba, ac))
    whole_ms = cuda_ms(torch, lambda: tsdf.deintegrate(tk, depth[f], c8[f], poses[f], cam, ac), n=10)
    plain_ms = cuda_ms(torch, lambda: tsdf._integrate_rows_torch(tk, rows, d1, c8[f][None], ac), n=5, batch=1)
    h, w = depth.shape[1:]
    bound_ms, bound_by = bound(applied * 512 * 40 + h * w * 4 + c8[0].numel(), applied * 512 * K1_FLOPS,
                               applied * 512 * K1_MUFU)
    phase("kernels", f"deintegrate (K1, one inverse row): {applied} applied blocks; bit-equal to the twin; integrate "
          f"then deintegrate restores the weights exactly: {exact}; kernel {ms:.4f} ms, the whole function (keys, "
          f"lookup, work list, launch) {whole_ms:.4f} ms, twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by})")
    if not exact:
        raise AssertionError("integrate then deintegrate did not restore the weights exactly")
    return dict(max_abs_err=err, applied_blocks=applied, ms=ms, function_ms=whole_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def check_k2(torch, T, dev, depth, cam):
    """K2 over a chunk's 11 frames, without geometry (the main path) and with."""
    from bundlefusion_tpu_torch.ops import preprocess as pp

    ac = flagship_config().app
    sd, sr = ac.depth_sigma_d, ac.depth_sigma_r
    fd, pts, nrm = pp.fused_preprocess(depth, cam, sd, sr, geometry=True)
    fd2, pts2, nrm2 = pp._preprocess_chain_torch(depth, cam, sd, sr, 3, True)
    fd0, _, _ = pp.fused_preprocess(depth, cam, sd, sr, geometry=False)
    errs = [float((a - b).abs().max()) for a, b in ((fd, fd2), (pts, pts2), (nrm, nrm2), (fd0, fd2))]
    if errs[0] > 1e-5 or errs[1] > 1e-5 or errs[2] > 1e-4 or errs[3] > 1e-5:
        raise AssertionError(f"K2 differs from the twin: fdepth/points/normals/fdepth-only {errs}")
    del fd, pts, nrm, fd2, pts2, nrm2, fd0
    ms = cuda_ms(torch, lambda: pp.fused_preprocess(depth, cam, sd, sr, geometry=False))
    ms_geo = cuda_ms(torch, lambda: pp.fused_preprocess(depth, cam, sd, sr, geometry=True))
    plain_ms = cuda_ms(torch, lambda: pp._preprocess_chain_torch(depth, cam, sd, sr, 3, False), n=5, batch=1)
    plain_geo = cuda_ms(torch, lambda: pp._preprocess_chain_torch(depth, cam, sd, sr, 3, True), n=5, batch=1)
    # taps this data needs: a valid centre and a valid neighbour (the rest
    # weigh 0 without an expf)
    valid = depth > 0
    taps = sum(int((valid & (pp._shift2d(depth, dy, dx) > 0)).sum()) for dy in range(-3, 4) for dx in range(-3, 4))
    npx, nvalid = depth.numel(), int(valid.sum())
    bound_ms, bound_by = bound(npx * 8, taps * K2_TAP_FLOPS + nvalid * 2, taps * K2_TAP_MUFU + nvalid)
    bound_geo, by_geo = bound(npx * 32, taps * K2_TAP_FLOPS + nvalid * (2 + K2_GEOM_FLOPS),
                              taps * K2_TAP_MUFU + nvalid * (1 + K2_GEOM_MUFU))
    phase("kernels", f"K2 preprocess {tuple(depth.shape)}: {taps} valid taps; fdepth/points/normals max err "
          f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g}, fdepth-only {errs[3]:.3g}; fdepth only: kernel {ms:.4f} ms, "
          f"twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.3f}; with "
          f"geometry: kernel {ms_geo:.4f} ms, twin {plain_geo:.4f} ms, bound {bound_geo:.4f} ms ({by_geo}), "
          f"share {bound_geo / ms_geo:.3f}")
    return kernel_entry(
        "preprocess", "bundlefusion_tpu_torch/csrc/preprocess.cu", "bundlefusion_tpu/ops/pallas_kernels.py:27",
        max(errs), ms, plain_ms, bound_ms, bound_by, ms_geometry=ms_geo, plain_ms_geometry=plain_geo,
        bound_ms_geometry=bound_geo,
    )


def assembly_inputs(seed: int, n: int, slots: int, live_images: int, per_pair: int, live_share: float,
                    dense: int = 0, dense_live: int = 0, pruned: float = 0.1, idx64: bool = False,
                    interleave: bool = False):
    """Normal-equation blocks for ``assemble_system``, filled as a global
    graph fills its correspondence slots: runs of ``per_pair / 2`` to
    ``per_pair`` consecutive slots per live pair (each new keyframe against
    its predecessor, then loop pairs; either end first) among the first ``live_images``
    keyframes up to ``live_share`` of the slots, a ``pruned`` share of the
    live slots at weight 0, the rest empty at (0, 0) with weight 0 (blocks of
    exact zeros, -0.0 among them). With ``interleave`` the live slots are in
    the order a global graph's compaction leaves them
    (``bundle/global_graph.py::_append_corrs``): the first slot of every
    pair, pairs in (pa, pb) order, then the second of every pair, and so
    on. Then ``dense`` dense-pair slots, of which
    ``dense_live`` are active, the others at (0, 0) with zero blocks. Keyframe
    0 is the gauge and keyframes from ``live_images`` on are not valid.
    Returns numpy (pa, pb, JtJ [P, 12, 12], Jtr [P, 12], free [n])."""
    rng = np.random.default_rng(seed)
    pa, pb, w = np.zeros(slots, np.int64), np.zeros(slots, np.int64), np.zeros(slots, np.float32)
    pairs = [(c - 1, c) for c in range(1, live_images)]
    cursor, i = 0, 0
    while True:
        if i >= len(pairs):
            a, b = sorted(rng.choice(live_images, 2, replace=False))
            pairs.append((int(a), int(b)))
        k = int(rng.integers(per_pair // 2, per_pair + 1))
        if cursor + k > live_share * slots:
            break
        a, b = pairs[i] if rng.random() < 0.5 else pairs[i][::-1]  # either end may be the newer keyframe
        pa[cursor:cursor + k], pb[cursor:cursor + k], w[cursor:cursor + k] = a, b, 1.0
        cursor, i = cursor + k, i + 1
    w[:cursor][rng.random(cursor) < pruned] = 0.0
    if interleave:
        pid = pa[:cursor] * n + pb[:cursor]
        order = np.argsort(pid, kind="stable")
        first = np.r_[True, pid[order][1:] != pid[order][:-1]]
        rank = np.arange(cursor) - np.maximum.accumulate(np.where(first, np.arange(cursor), 0))
        final = order[np.lexsort((np.arange(cursor), rank))]
        pa[:cursor], pb[:cursor], w[:cursor] = pa[:cursor][final], pb[:cursor][final], w[:cursor][final]
    J = rng.standard_normal((slots, 3, 12)).astype(np.float32)
    r = (rng.standard_normal((slots, 3)) * 0.01).astype(np.float32)
    JtJ = np.einsum("kri,krj->kij", J, J * w[:, None, None]).astype(np.float32)
    Jtr = np.einsum("kri,kr->ki", J, r * w[:, None]).astype(np.float32)
    if dense:
        da, db = np.zeros(dense, np.int64), np.zeros(dense, np.int64)
        on = rng.choice(dense, dense_live, replace=False)
        for j in on:
            da[j], db[j] = sorted(rng.choice(live_images, 2, replace=False))
        Jd = rng.standard_normal((dense, 8, 12)).astype(np.float32)
        wd = np.isin(np.arange(dense), on).astype(np.float32)
        pa, pb = np.concatenate([pa, da]), np.concatenate([pb, db])
        JtJ = np.concatenate([JtJ, np.einsum("kri,krj->kij", Jd, Jd * wd[:, None, None]).astype(np.float32)])
        Jtr = np.concatenate([Jtr, np.einsum("kri,kr->ki", Jd, wd[:, None] * 0.01).astype(np.float32)])
    free = (np.arange(n) > 0) & (np.arange(n) < live_images)
    if not idx64:
        pa, pb = pa.astype(np.int32), pb.astype(np.int32)
    return pa, pb, JtJ, Jtr, free


K3_EDGE_CASES = ("empty", "one_keyframe", "gauge_negative", "negative_zero", "out_of_range", "nan_empty_slot")


def assembly_edge_inputs(case: str, idx64: bool = False):
    """K3's edge cases at n = 8, 300 slots (``K3_EDGE_CASES``): every slot
    empty; one keyframe in every slot (pa or pb, the other end any keyframe,
    itself included); the gauge keyframe's sums of H negative and of b
    positive (so its gauge-masked b entries are -0.0); every empty slot's
    values -0.0, and -0.0 entries in live blocks; indices out of [0, n); a
    NaN in an empty slot at (0, 0). Returns (the inputs, the inputs of the
    twin): the same arrays, except for out-of-range indices, which the
    kernel drops and the twin cannot take, so the twin's inputs move them to
    keyframe 0 with that end's values zeroed."""
    n, slots = 8, 300
    rng = np.random.default_rng(100 + K3_EDGE_CASES.index(case))
    pa, pb, JtJ, Jtr, free = assembly_inputs(17, n, slots, 6, 40, 0.0 if case == "empty" else 0.6, idx64=idx64)
    empty = ~(JtJ != 0).reshape(slots, -1).any(1)
    if case == "one_keyframe":
        _, _, JtJ, Jtr, _ = assembly_inputs(18, n, slots, 6, 40, 1.0, pruned=0.0, idx64=idx64)
        other = rng.integers(0, n, slots).astype(pa.dtype)
        side = rng.random(slots) < 0.5
        pa, pb = np.where(side, 3, other).astype(pa.dtype), np.where(side, other, 3).astype(pa.dtype)
    elif case == "gauge_negative":
        touch = (pa == 0) | (pb == 0)
        JtJ[touch] *= -1.0
        Jtr[touch] = np.abs(Jtr[touch])
    elif case == "negative_zero":
        JtJ[empty], Jtr[empty] = -0.0, -0.0
        live = np.flatnonzero(~empty)[::3]
        JtJ[live, 2, :] = -0.0
        JtJ[live, :, 9] = -0.0
        Jtr[live, 4] = -0.0
    elif case == "nan_empty_slot":
        JtJ[np.flatnonzero(empty)[-1], 8, 2] = np.nan
    ref = [x.copy() for x in (pa, pb, JtJ, Jtr, free)]
    if case == "out_of_range":
        bad_a, bad_b = rng.random(slots) < 0.15, rng.random(slots) < 0.15
        pa[bad_a] = np.where(rng.random(int(bad_a.sum())) < 0.5, n + 3, -1)
        pb[bad_b] = np.where(rng.random(int(bad_b.sum())) < 0.5, n, -2)
        ref[0][bad_a], ref[1][bad_b] = 0, 0
        ref[2][bad_a, :6, :], ref[2][bad_a, :, :6], ref[3][bad_a, :6] = 0.0, 0.0, 0.0
        ref[2][bad_b, 6:, :], ref[2][bad_b, :, 6:], ref[3][bad_b, 6:] = 0.0, 0.0, 0.0
    return (pa, pb, JtJ, Jtr, free), tuple(ref)


def k3_cases(bc) -> dict:
    """K3's cases at the shapes of the bundling configuration ``bc`` (the
    flagship's): name -> (maker of ``assembly_inputs``' arrays, damping).
    The global solve's slots at n keyframes, filled by 60 keyframes, as the
    flagship pass's last solve fills them (7 keyframes; in runs of one pair,
    and interleaved as there) and with the dense pairs appended; the local solve; a sharded partial (half the global
    slots, damping 0); and two shapes that a shared-memory flag per slot
    could not hold: 262,144 slots at n, and the default configuration's 512
    keyframes with its global and dense-pair slots."""
    n, slots, nd = bc.max_num_images, bc.max_residuals_global, bc.max_dense_pairs_global
    return {
        "global": (lambda: assembly_inputs(1, n, slots, 60, 400, 0.7), 1e-6),
        # as the flagship pass's last solve holds them: 7 keyframes, 1,344 slots live (corr_cursor), in runs
        # of one pair, and interleaved as the graph's compaction leaves them
        "global_7_keyframes": (lambda: assembly_inputs(6, n, slots, 7, 192, 1344 / slots), 1e-6),
        "global_7_keyframes_interleaved": (lambda: assembly_inputs(6, n, slots, 7, 64, 1344 / slots, interleave=True),
                                           1e-6),
        "global_dense": (lambda: assembly_inputs(2, n, slots, 60, 400, 0.7, dense=nd, dense_live=21, idx64=True),
                         1e-6),
        "local": (lambda: assembly_inputs(3, bc.chunk_size, bc.max_residuals_local, bc.chunk_size, 60, 0.9,
                                          dense=55, dense_live=50, idx64=True), 1e-6),
        "sharded_partial": (lambda: assembly_inputs(4, n, slots // 2, 60, 400, 0.7), 0.0),
        "slots_262144": (lambda: assembly_inputs(7, n, 262144, 60, 400, 0.7), 1e-6),
        "n512": (lambda: assembly_inputs(8, 512, slots, 500, 40, 0.7, dense=nd, dense_live=21, idx64=True), 1e-6),
    }


# K3's second bound: its order is fixed (the twin's, for bit-equality), so
# a cell's non-zero updates are a chain of dependent float adds, each
# waiting for the last: 4 cycles per add (the FP32 add's dependent-issue
# latency that published microbenchmarks measure on Volta through Hopper)
# at the 1.98 GHz boost clock
FADD_CYCLES, CLOCK_HZ = 4, 1.98e9


def k3_longest_chain(torch, n, pa, pb, JtJ, Jtr) -> int:
    """The most non-zero updates that one entry of H or b receives in the
    twin's order: H's four passes chain into one sum per cell; b sums the
    pa side and the pb side apart, then adds them (one add more)."""
    a, b = pa.long(), pb.long()
    ok_a, ok_b = (a >= 0) & (a < n), (b >= 0) & (b < n)
    nz = (JtJ != 0).float()
    cnt = torch.zeros((n * n, 6, 6), device=JtJ.device)
    for keep, idx, blk in ((ok_a, a * n + a, nz[:, :6, :6]), (ok_a & ok_b, a * n + b, nz[:, :6, 6:]),
                           (ok_a & ok_b, b * n + a, nz[:, 6:, :6]), (ok_b, b * n + b, nz[:, 6:, 6:])):
        cnt.index_add_(0, idx[keep], blk[keep])
    jz = (Jtr != 0).float()
    sa = torch.zeros((n, 6), device=JtJ.device).index_add_(0, a[ok_a], jz[ok_a, :6])
    sb = torch.zeros((n, 6), device=JtJ.device).index_add_(0, b[ok_b], jz[ok_b, 6:])
    return int(max(float(cnt.max()), float(torch.maximum(sa, sb).max()) + 1))


def check_k3(torch, dev):
    """K3 against its twin (today's deterministic index_add_ body) at every
    case of ``k3_cases``: bit-equal, the sign of zero included; the kernel,
    the twin and the twin's six index_add_ calls alone timed in each, beside
    both bounds (bytes, and the longest chain of dependent adds)."""
    from bundlefusion_tpu_torch.solver import system
    from bundlefusion_tpu_torch.utils.tensor_ops import deterministic

    out = {}
    for name, (make, damping) in k3_cases(flagship_config().bundling).items():
        pa, pb, JtJ, Jtr, free = (torch.as_tensor(a, device=dev) for a in make())
        m = free.shape[0]
        args = (m, pa, pb, JtJ, Jtr, free, damping)
        Hk, bk = system.assemble_system(*args)
        Ht, bt = system._assemble_system_torch(*args)
        torch.cuda.synchronize()
        err = max(float((Hk - Ht).abs().max()), float((bk - bt).abs().max()))
        signs = torch.equal(torch.signbit(Hk), torch.signbit(Ht)) and torch.equal(torch.signbit(bk), torch.signbit(bt))
        if err != 0.0 or not (torch.equal(Hk, Ht) and torch.equal(bk, bt) and signs):
            raise AssertionError(f"K3 {name}: not bit-equal to its twin (max |err| {err}, signs equal {signs})")
        del Hk, bk, Ht, bt
        # bytes: every block value and index read once, H and b written once;
        # operations: the additions of the non-zero updates (six values each)
        p = JtJ.shape[0]
        nbytes = p * (144 + 12) * 4 + 2 * p * pa.element_size() + m + (36 * m * m + 6 * m) * 4
        blk = JtJ.reshape(p, 2, 6, 2, 6)
        nonzero = int((blk != 0).any(dim=-1).sum()) + int((Jtr != 0).sum())  # rows of updates, b's entries
        bound_ms, bound_by = bound(nbytes, nonzero * 6, 0)
        chain = k3_longest_chain(torch, m, pa, pb, JtJ, Jtr)
        chain_ms = 1e3 * chain * FADD_CYCLES / CLOCK_HZ
        ms = cuda_ms(torch, lambda: system.assemble_system(*args))
        gms = graph_ms(torch, lambda: system.assemble_system(*args))
        plain_ms = cuda_ms(torch, lambda: system._assemble_system_torch(*args), n=5, batch=1)

        def index_adds():  # the twin's six deterministic index_add_ calls alone (no gauge or permute)
            Hb = torch.zeros((m * m, 6, 6), device=dev)
            bv = torch.zeros((m, 6), device=dev)
            a, b = pa.long(), pb.long()
            with deterministic():
                for idx, blkv in ((a * m + a, JtJ[:, :6, :6]), (a * m + b, JtJ[:, :6, 6:]),
                                  (b * m + a, JtJ[:, 6:, :6]), (b * m + b, JtJ[:, 6:, 6:])):
                    Hb.index_add_(0, idx, blkv)
                bv.index_add_(0, a, Jtr[:, :6])
                bv.index_add_(0, b, Jtr[:, 6:])

        lib_ms = cuda_ms(torch, index_adds, n=5, batch=1)
        rec = dict(n=m, slots=p, live_slots=int((JtJ != 0).flatten(1).any(1).sum()), damping=damping,
                   max_abs_err=err, ms=ms, graph_ms=gms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                   bound_by=bound_by, longest_chain=chain, bound_chain_ms=chain_ms)
        phase("kernels", f"K3 assemble {name}: n={m}, {p} slots ({rec['live_slots']} with a non-zero block), "
              f"damping {damping}; bit-equal to the twin, signs of zero included; kernel {ms:.4f} ms (five eager "
              f"calls), {gms:.4f} ms in a graph; twin {plain_ms:.4f} ms, the six index_add_ calls {lib_ms:.4f} ms; "
              f"bound {bound_ms:.4f} ms ({bound_by}), share {bound_ms / gms:.3f} in a graph; longest chain {chain} "
              f"adds, {chain_ms:.4f} ms at {FADD_CYCLES} cycles each, share {chain_ms / gms:.3f}")
        out[name] = rec
        del pa, pb, JtJ, Jtr, free
        torch.cuda.empty_cache()
    edges = []
    for case in K3_EDGE_CASES:
        for idx64 in (False, True):
            arrays, ref = assembly_edge_inputs(case, idx64)
            m = arrays[4].shape[0]
            Hk, bk = system.assemble_system(m, *(torch.as_tensor(a, device=dev) for a in arrays), 1e-6)
            Ht, bt = system._assemble_system_torch(m, *(torch.as_tensor(a, device=dev) for a in ref), 1e-6)
            for got, want in ((Hk, Ht), (bk, bt)):
                nan = torch.isnan(want)
                if not (torch.equal(torch.isnan(got), nan)
                        and torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))):
                    raise AssertionError(f"K3 edge case {case} ({'int64' if idx64 else 'int32'}): not bit-equal to "
                                         "its twin")
        edges.append(case)
    phase("kernels", f"K3 edge cases, int32 and int64 indices, bit for bit (NaN where NaN): {', '.join(edges)}")
    g = out["global"]
    return kernel_entry("assemble", "bundlefusion_tpu_torch/csrc/assemble.cu", "bundlefusion_tpu/solver/system.py:24",
                        max(r["max_abs_err"] for r in out.values()), g["ms"], g["plain_ms"], g["bound_ms"],
                        g["bound_by"], g["library_ms"],
                        library_ms_is="the six deterministic index_add_ calls of the twin, not one call",
                        graph_ms=g["graph_ms"], share_of_bound_in_graph=g["bound_ms"] / g["graph_ms"],
                        bound_chain_ms=g["bound_chain_ms"], edge_cases=edges, cases=out)


# K4 (SIFT window sampling): operations of one window point (offsets,
# clamps, floors, tents 12, four taps unpacked 32, both planes combined 12,
# masks 8)
K4_FLOPS = 74


def sift_inputs(seed: int, frames: int, keys: int, h: int, w: int, levels: int):
    """One octave's packed gradient image (exact integers qx * 4096 + qy) of
    ``frames`` frames, and ``keys`` keys per frame spread over the image,
    four of them at its borders (their windows leave the image and the
    patch) and two more with patch origins the gather clamps. Returns numpy
    (g_tall [F, Ht, Wp], xy [F, K, 2], sigma, theta [F, K], x0, y0, row0 [F, K])."""
    rng = np.random.default_rng(seed)
    patch, blk, patch_w = 64, 64, 128
    wp = max(-(-(w + blk) // blk) * blk, patch_w)
    ht = levels * h + patch
    q = rng.integers(0, 4096, size=(frames, ht, wp, 2))
    g_tall = (q[..., 0] * 4096.0 + q[..., 1]).astype(np.float32)
    xy = np.stack([rng.uniform(0, w - 1, (frames, keys)), rng.uniform(0, h - 1, (frames, keys))], -1)
    xy[:, :4] = [[0.2, 3.0], [w - 1.2, 5.5], [7.0, 0.1], [w - 2.0, h - 1.5]]
    xy = xy.astype(np.float32)
    sigma = rng.uniform(1.6, 6.0, (frames, keys)).astype(np.float32)
    theta = rng.uniform(-np.pi, np.pi, (frames, keys)).astype(np.float32)
    xi, yi = np.round(xy[..., 0]).astype(np.int64), np.round(xy[..., 1]).astype(np.int64)
    x0 = np.clip(xi - patch // 2, 0, max(w - patch, 0)) // blk * blk
    y0 = np.clip(yi - patch // 2, 0, max(h - patch, 0))
    row0 = rng.integers(0, levels, (frames, keys)) * h + y0
    x0[:, 4], row0[:, 5] = wp, ht - 10  # clamped by the gather
    return g_tall, xy, sigma, theta, x0, y0, row0


def check_k4(torch, dev):
    """K4 against its twin at one flagship octave (11 frames x 512 keys x 256
    window points at 640x480, 4 Gaussian levels): the unrotated orientation
    window and the rotated descriptor window, each bit-equal; times for the
    descriptor window, against the matmul form it replaced (patch gather,
    unpack, tent-weight GEMMs)."""
    from bundlefusion_tpu_torch.features import sift

    bc = flagship_config().bundling
    h, w = FULL[1], FULL[0]
    g_tall, xy, sigma, theta, x0, y0, row0 = (torch.as_tensor(a, device=dev) for a in sift_inputs(
        5, bc.chunk_size, bc.max_keys_per_image, h, w, bc.sift_scales_per_octave + 1))
    windows = {"orientation": sift._window_coords(xy, sigma, torch.zeros_like(theta), 0.4),
               "descriptor": sift._window_coords(xy, sigma, theta, 0.75)}
    errs = {}
    for name, coords in windows.items():
        got = sift.sample_window(g_tall, coords, x0, y0, row0, h, w)
        want = sift._sample_window_torch(g_tall, coords, x0, y0, row0, h, w)
        torch.cuda.synchronize()
        errs[name] = max(float((got[0] - want[0]).abs().max()), float((got[1] - want[1]).abs().max()))
        if errs[name] != 0.0 or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"K4 {name} window: not bit-equal to its twin (max |err| {errs[name]})")
    coords = windows["descriptor"]
    args = (g_tall, coords, x0, y0, row0, h, w)
    ms = cuda_ms(torch, lambda: sift.sample_window(*args))
    plain_ms = cuda_ms(torch, lambda: sift._sample_window_torch(*args), n=5, batch=1)
    px, py = sift._unpack_grads(sift._extract_patches(g_tall, x0, row0))
    lib_ms = cuda_ms(torch, lambda: sift._gather_grads_patches(px, py, coords, x0, y0, h, w), n=5, batch=1)
    gather_ms = cuda_ms(torch, lambda: sift._unpack_grads(sift._extract_patches(g_tall, x0, row0)), n=5, batch=1)
    mm = sift._gather_grads_patches(px, py, coords, x0, y0, h, w)
    got = sift.sample_window(*args)
    mm_err = max(float((got[0] - mm[0]).abs().max()), float((got[1] - mm[1]).abs().max()))
    if not torch.equal(got[2], mm[2]) or mm_err > 2e-6:
        raise AssertionError(f"K4 against the matmul form: masks equal {torch.equal(got[2], mm[2])}, max err {mm_err}")
    del px, py, mm
    # bytes: coordinates and key origins read once, each tall element a tap
    # touches read once, gx, gy and the mask written once
    lx, ly, mask = sift._window_frame(coords, x0, y0, h, w)
    r0, c0 = sift._patch_origin(g_tall.shape[1], g_tall.shape[2], x0, row0)
    wp = g_tall.shape[2]
    base = (g_tall.shape[1] * torch.arange(g_tall.shape[0], device=dev)[:, None, None] + r0[..., None]
            + torch.nan_to_num(torch.floor(ly), nan=0.0).long()) * wp + c0[..., None] \
        + torch.nan_to_num(torch.floor(lx), nan=0.0).long()
    taps = int(torch.unique(torch.cat([base + o for o in (0, 1, wp, wp + 1)]).reshape(-1)).numel())
    pts = coords.shape[0] * coords.shape[1] * coords.shape[2]
    nbytes = pts * (8 + 9) + x0.numel() * 24 + taps * 4
    bound_ms, bound_by = bound(nbytes, pts * K4_FLOPS, 0)
    phase("kernels", f"K4 sift_sample {tuple(coords.shape[:3])} points ({int(mask.sum())} in the masks, {taps} "
          f"tall elements read): both windows bit-equal to the twin, max |err| against the matmul form "
          f"{mm_err:.3g}, masks equal; kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, matmul form {lib_ms:.4f} ms "
          f"(+ {gather_ms:.4f} ms for its patch gather per octave), bound {bound_ms:.4f} ms ({bound_by}), share "
          f"{bound_ms / ms:.3f}")
    return kernel_entry("sift_sample", "bundlefusion_tpu_torch/csrc/sift_sample.cu",
                        "bundlefusion_tpu/features/sift.py:277", max(errs.values()), ms, plain_ms, bound_ms, bound_by,
                        lib_ms, library_ms_is="the matmul form on gathered patches (its patch gather not included)",
                        patch_gather_ms=gather_ms, err_vs_matmul=mm_err)


K5_EDGE_CASES = ("all_invalid", "z_tiny", "band", "no_projection", "nan_transform")


def _field_frame(rng, h: int, w: int, cam):
    """One cache frame of a smooth random surface 0.9-1.5 m away: depth with
    8% holes, points unprojected by ``cam`` (fx, fy, cx, cy), unit normals
    near -z, intensity in [0, 1]. Returns numpy (depth, points, normals,
    intensity, grad)."""
    fx, fy, cx, cy = cam[:4]
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    f1, f2, p1, p2 = rng.uniform(0.5, 2.0, 2).tolist() + rng.uniform(0, 2 * np.pi, 2).tolist()
    z = 1.2 + 0.3 * np.sin(2 * np.pi * u / w * f1 + p1) * np.cos(2 * np.pi * v / h * f2 + p2)
    z = np.where(rng.random((h, w)) < 0.08, 0.0, z + 0.002 * rng.standard_normal((h, w)))
    pts = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1)
    n = np.stack([0.15 * rng.standard_normal((h, w)), 0.15 * rng.standard_normal((h, w)), -np.ones((h, w))], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    inten = 0.5 + 0.3 * np.sin(2 * np.pi * (u / w + v / h) * f2 + p1) + 0.02 * rng.standard_normal((h, w))
    inten = np.clip(inten, 0, 1)
    f32 = np.float32
    return z.astype(f32), pts.astype(f32), n.astype(f32), inten.astype(f32), np.zeros((h, w, 2), f32)


def _small_motion(rng, angle: float, shift: float) -> np.ndarray:
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
    T[:3, 3] = rng.standard_normal(3) * shift
    return T.astype(np.float32)


def verify_edge_inputs(case: str, pairs: int = 4, h: int = 24, w: int = 32):
    """K5's edge cases (``K5_EDGE_CASES``) on random cache frames: pair 0
    carries the case, the other pairs are ordinary (frame b is frame a
    with noise, turned by up to 0.05 rad and shifted by ~1.5 cm an axis):
    every a-side pixel invalid; points at z in {0, 1e-7, 1e-6 (f32), the
    next float, 1e-5} under the identity; points projecting exactly onto w - 1 and h - 1, into
    the 1e-4 band past them, just past it and onto the clamp, under the
    identity with fx = fy = 1, cx = cy = 0 (the case's camera); a transform
    that puts every point behind the camera; a NaN in the transform.
    Returns numpy (cache a, cache b: tuples of [P, h, w(, c)] fields as
    FrameCache orders them, T_ba [P, 4, 4], camera (fx, fy, cx, cy, width,
    height))."""
    rng = np.random.default_rng(200 + K5_EDGE_CASES.index(case))
    cam = (1.0, 1.0, 0.0, 0.0, w, h) if case == "band" else (0.9 * w, 0.9 * w, (w - 1) / 2, (h - 1) / 2, w, h)
    fa = [_field_frame(rng, h, w, cam) for _ in range(pairs)]
    fb = []
    for d, p, n, i, g in fa:
        db = np.where(d > 0, d + 0.004 * rng.standard_normal(d.shape).astype(np.float32), 0.0).astype(np.float32)
        pb = (p * np.where(d > 0, db / np.where(d > 0, d, 1.0), 0.0)[..., None]).astype(np.float32)
        nb = n + 0.02 * rng.standard_normal(n.shape).astype(np.float32)
        nb = (nb / np.linalg.norm(nb, axis=-1, keepdims=True)).astype(np.float32)
        fb.append((db, pb, nb, (i + 0.03 * rng.standard_normal(i.shape)).astype(np.float32), g))
    T = np.stack([_small_motion(rng, rng.uniform(0, 0.05), 0.015) for _ in range(pairs)])
    a = [np.stack(x) for x in zip(*fa)]
    b = [np.stack(x) for x in zip(*fb)]
    if case == "all_invalid":
        a[0][0], a[1][0] = 0.0, 0.0
    elif case == "z_tiny":
        T[0] = np.eye(4, dtype=np.float32)
        zs = np.array([0.0, 1e-7, np.float32(1e-6), np.nextafter(np.float32(1e-6), np.float32(1)), 1e-5], np.float32)
        band = a[1][0, : h // 2]
        band[..., 2] = np.resize(zs, band.shape[:2])
        a[0][0, : h // 2] = 1.0
    elif case == "band":
        T[0] = np.eye(4, dtype=np.float32)
        f32 = np.float32
        us = np.array([w - 1.0, w - 1.0 + 5e-5, w - 1.0 + 9e-5, w - 1.0 + 2e-4, w - 1.001, w - 2.0, 0.0, -1e-7], f32)
        vs = np.array([h - 1.0, h - 1.0 + 5e-5, h - 1.0 + 9e-5, h - 1.0 + 2e-4, h - 1.001, 1.5, 0.0, -1e-7], f32)
        a[0][0] = 1.0
        a[1][0, ..., 0] = np.resize(us, (h, w))
        a[1][0, ..., 1] = np.resize(vs, (w, h)).T
        a[1][0, ..., 2] = f32(1.0)
    elif case == "no_projection":
        T[0, 2, 3] = -10.0
    elif case == "nan_transform":
        T[0, 0, 0] = np.nan
    return tuple(a), tuple(b), T, cam


# K5 (dense verification): operations of one valid source pixel (transform 18,
# project 4, the z, inside and in-bounds tests 9) and two divides; of one
# pixel that projects (clamps, floors and tents 18, five channels sampled
# 45, depth error 2, normal rotated 15, its norm 5, dot 5, intensity 2,
# tests 3) and a square root and three divides
K5_PIXEL_FLOPS, K5_PIXEL_MUFU = 31, 2
K5_PROJ_FLOPS, K5_PROJ_MUFU = 95, 4


def sampled_dense_verify(cache_a, cache_b, T_ba, cam, cfg, sample):
    """The port's dense verification before K5 (sampling with ``sample``:
    ``ops/preprocess.py::bilinear_sample_matmul``, the JAX package's matmul
    form, or ``bilinear_sample_gather``), for one direction: [..., 4]
    float32 (valid, projected, agreeing pixels, depth-error sum). K5's
    yardstick on the card; the port does not call it."""
    import torch
    from bundlefusion_tpu_torch.geometry import se3
    from bundlefusion_tpu_torch.geometry.camera import project

    lead = cache_a.depth.shape[:-2]
    pts_a = cache_a.points.reshape(*lead, -1, 3)
    valid_a = cache_a.depth.reshape(*lead, -1) > 0.0
    pts_in_b = se3.transform_points(T_ba, pts_a)
    uv, proj_ok = project(cam, pts_in_b)
    stack_b = torch.cat([cache_b.depth[..., None], cache_b.normals, cache_b.intensity[..., None]], dim=-1)
    samp, inb = sample(stack_b, uv)
    depth_b, normal_b, inten_b = samp[..., 0], samp[..., 1:4], samp[..., 4]
    proj_ok = proj_ok & inb & valid_a & (depth_b > 0.0)
    dist = torch.abs(pts_in_b[..., 2] - depth_b)
    n_a = se3.rotate_vectors(T_ba, cache_a.normals.reshape(*lead, -1, 3))
    nb_norm = normal_b / torch.clamp(torch.linalg.vector_norm(normal_b, dim=-1, keepdim=True), min=1e-9)
    ndot = torch.sum(n_a * nb_norm, dim=-1)
    dint = torch.abs(cache_a.intensity.reshape(*lead, -1) - inten_b)
    agree = (proj_ok & (dist < cfg.verify_dist_thresh) & (ndot > cfg.verify_normal_thresh)
             & (dint < cfg.verify_color_thresh))
    return torch.stack([valid_a.sum(-1).float(), proj_ok.sum(-1).float(), agree.sum(-1).float(),
                        torch.sum(torch.where(proj_ok, dist, 0.0), dim=-1)], dim=-1)


def k5_cases(torch, cache, poses, bc) -> dict:
    """K5's call shapes on rendered flagship caches (80x60, from 640x480
    frames of the orbit), with the ground-truth relative poses, each as
    (cache a, cache b, transforms): a chunk's filter (its 55 pairs both
    ways, each side a gathered copy as ``cache.index(pairs)`` makes it), its
    opt-verify (the 10 consecutive pairs one way, views of the chunk's
    cache) and graph_step's global match (128 keyframe slots against the new
    keyframe, broadcast at stride 0, both ways), with 7 slots filled (the
    flagship pass's last chunk) and with all 128."""
    from bundlefusion_tpu_torch.geometry import se3

    dev = cache.depth.device
    s1 = bc.chunk_size
    chunk = cache.index(slice(0, s1))
    pa, pb = torch.triu_indices(s1, s1, offset=1, device=dev)
    rel = se3.mat_inverse(poses[pb]) @ poses[pa]
    cases = {"chunk_filter": (chunk.index(pa), chunk.index(pb), (rel, se3.mat_inverse(rel)))}
    cases["opt_verify"] = (chunk.index(slice(None, -1)), chunk.index(slice(1, None)),
                           (se3.mat_inverse(poses[1:s1]) @ poses[: s1 - 1],))
    kmax, new = bc.max_num_images, cache.num_frames - 1

    def fields(c):
        return [getattr(c, f.name) for f in dataclasses.fields(c)]

    for name, filled in (("graph_step_7", 7), ("graph_step_128", kmax)):
        slots = torch.arange(filled, device=dev) * 3 % new
        graph = type(cache)(*(torch.zeros((kmax,) + f.shape[1:], device=dev) for f in fields(cache)))
        for f, src in zip(fields(graph), fields(cache.index(slots))):
            f[:filled] = src
        T = torch.eye(4, device=dev).repeat(kmax, 1, 1)
        T[:filled] = se3.mat_inverse(poses[new])[None] @ poses[slots]
        ncache = type(cache)(*(f[new][None].expand(kmax, *f.shape[1:]) for f in fields(cache)))
        cases[name] = (graph, ncache, (T, se3.mat_inverse(T)))
    return cases


def _k5_bound(torch, a, b, ts, cam, bc, sums):
    """K5's least time on this call's data. Bytes: each cache frame it is
    given (by storage: a frame broadcast to every pair once, rows shared by
    two views once) read once, and of it only what the function needs: the
    depth of every pixel of a frame that is a source, the point of each
    valid source pixel, the normal and intensity of each source pixel that
    projected; of the destination, the depth at the taps of non-zero weight
    of every pixel that passed the geometric tests, and the normal and
    intensity at those of every pixel that projected; the transforms read
    and the sums written once. Operations: those of every valid source
    pixel and of every pixel that projected."""
    from bundlefusion_tpu_torch.features import filters
    from bundlefusion_tpu_torch.geometry import se3
    from bundlefusion_tpu_torch.geometry.camera import project

    h, w = a.depth.shape[-2:]
    d = h * w
    dev = a.depth.device
    pairs = a.depth.reshape(-1, h, w).shape[0]

    def frames(side):
        dep = side.depth.reshape(-1, h, w)
        step = dep.stride(0) if dep.shape[0] > 1 else 0
        return [dep.data_ptr() + 4 * step * i for i in range(dep.shape[0])]

    index = {k: i for i, k in enumerate(dict.fromkeys(frames(a) + frames(b)))}
    ia, ib = (torch.tensor([index[k] for k in frames(side)], device=dev)[:, None] * d for side in (a, b))
    need = torch.zeros((3, len(index) * d), dtype=torch.bool, device=dev)  # depth; point; normal, intensity
    pix = torch.arange(d, device=dev)
    for (src, dst, T), fs, fd in zip(((a, b, ts[0]), (b, a, ts[-1]))[: len(ts)], (ia, ib), (ib, ia)):
        valid, proj_ok = (m.reshape(pairs, d) for m in filters._verify_terms(src, dst, T, cam, bc)[:2])
        pts = se3.transform_points(T.reshape(pairs, 4, 4), src.points.reshape(pairs, d, 3))
        uv, ok = project(cam, pts)
        u, v = uv.unbind(-1)
        geo = valid & ok & (u < w - 1.0 + 1e-4) & (v < h - 1.0 + 1e-4)
        uc, vc = torch.clamp(u, 0.0, w - 1.001), torch.clamp(v, 0.0, h - 1.001)
        u0, v0 = torch.nan_to_num(torch.floor(uc)), torch.nan_to_num(torch.floor(vc))
        base = fd + v0.long() * w + u0.long()
        need[0, (fs + pix).reshape(-1)] = True
        need[1, (fs + pix)[valid]] = True
        need[2, (fs + pix)[proj_ok]] = True
        for off, tap in ((0, None), (1, uc > u0), (w, vc > v0), (w + 1, (uc > u0) & (vc > v0))):
            at = geo if tap is None else geo & tap
            need[0, (base + off)[at]] = True
            need[2, (base + off)[at & proj_ok]] = True
    n_depth, n_point, n_rest = (int(x) for x in need.sum(-1))
    nbytes = 4 * n_depth + 12 * n_point + 16 * n_rest + len(ts) * pairs * (64 + 16)
    pixels, proj = float(sums[..., 0].sum()), float(sums[..., 1].sum())
    return bound(nbytes, pixels * K5_PIXEL_FLOPS + proj * K5_PROJ_FLOPS, pixels * K5_PIXEL_MUFU + proj * K5_PROJ_MUFU)


def check_k5(torch, dev, cache, poses, cam):
    """K5 against its twin at its three call shapes (``k5_cases``) and its
    edge cases (``verify_edge_inputs`` at 80x60), every sum bit-equal; each
    shape timed eagerly (five calls back to back) and in a CUDA graph,
    against the twin, the matmul-form dense verification it replaced and
    the gather form, beside its bound; the pairs whose counts differ from
    the matmul form's."""
    from bundlefusion_tpu_torch.features import filters
    from bundlefusion_tpu_torch.geometry import se3
    from bundlefusion_tpu_torch.geometry.camera import CameraModel
    from bundlefusion_tpu_torch.ops import preprocess as pp
    from bundlefusion_tpu_torch.ops.preprocess import FrameCache

    bc = flagship_config().bundling
    out = {}
    for name, (a, b, ts) in k5_cases(torch, cache, poses, bc).items():
        sides = ((a, b), (b, a))[: len(ts)]
        got = filters.dense_verify_sums(a, b, ts, cam, bc)
        want = torch.stack([filters._dense_verify_torch(x, y, t, cam, bc) for (x, y), t in zip(sides, ts)])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"K5 {name}: not bit-equal to its twin (max |err| {err})")
        forms = {}
        for form, sample in (("matmul", pp.bilinear_sample_matmul), ("gather", pp.bilinear_sample_gather)):
            def run(sample=sample):
                return torch.stack([sampled_dense_verify(x, y, t, cam, bc, sample) for (x, y), t in zip(sides, ts)])
            ref = run()
            flips = int((ref[..., :3] != got[..., :3]).any(-1).sum())
            rel = float(((ref[..., 3] - got[..., 3]).abs() / ref[..., 3].abs().clamp(min=1e-30)).max())
            forms[form] = dict(ms=cuda_ms(torch, run, n=5, batch=1), pairs_whose_counts_differ=flips, err_rel=rel)
            del ref
        ms = cuda_ms(torch, lambda: filters.dense_verify_sums(a, b, ts, cam, bc))
        gms = graph_ms(torch, lambda: filters.dense_verify_sums(a, b, ts, cam, bc))
        plain_ms = cuda_ms(torch, lambda: [filters._dense_verify_torch(x, y, t, cam, bc)
                                           for (x, y), t in zip(sides, ts)], n=5, batch=1)
        bound_ms, bound_by = _k5_bound(torch, a, b, ts, cam, bc, got)
        pairs = a.depth.shape[0]
        rec = dict(pairs=pairs, directions=len(ts), projected=int(got[..., 1].sum()), agreeing=int(got[..., 2].sum()),
                   max_abs_err=err, ms=ms, graph_ms=gms, plain_ms=plain_ms, library_ms=forms["matmul"]["ms"],
                   gather_ms=forms["gather"]["ms"], bound_ms=bound_ms, bound_by=bound_by, forms=forms)
        phase("kernels", f"K5 dense_verify {name}: {pairs} pairs x {len(ts)} direction(s) at 80x60, "
              f"{rec['projected']} pixels projected, {rec['agreeing']} agreeing; bit-equal to the twin; kernel "
              f"{ms:.4f} ms (five eager calls), {gms:.4f} ms in a graph; twin {plain_ms:.4f} ms; matmul form "
              f"{forms['matmul']['ms']:.4f} ms, gather form {forms['gather']['ms']:.4f} ms; pairs whose counts "
              f"differ from the matmul form's {forms['matmul']['pairs_whose_counts_differ']} (err within "
              f"{forms['matmul']['err_rel']:.2g} relative); bound {bound_ms:.4f} ms ({bound_by}), share "
              f"{bound_ms / gms:.3f} in a graph")
        out[name] = rec
        del a, b, ts, got, want
        torch.cuda.empty_cache()
    edges = []
    for case in K5_EDGE_CASES:
        a, b, T, ecam = verify_edge_inputs(case, h=bc.cache_height, w=bc.cache_width)
        a, b = (FrameCache(*(torch.as_tensor(x, device=dev) for x in side)) for side in (a, b))
        T, ecam = torch.as_tensor(T, device=dev), CameraModel(*ecam)
        ts = (T, se3.mat_inverse(T))
        got = filters.dense_verify_sums(a, b, ts, ecam, bc)
        want = torch.stack([filters._dense_verify_torch(a, b, T, ecam, bc),
                            filters._dense_verify_torch(b, a, ts[1], ecam, bc)])
        if not torch.equal(got, want):
            raise AssertionError(f"K5 edge case {case}: not bit-equal to its twin: {got[:, 0]} against {want[:, 0]}")
        edges.append(case)
    phase("kernels", f"K5 edge cases at 80x60, both directions, bit for bit: {', '.join(edges)}")
    g = out["graph_step_128"]
    return kernel_entry("dense_verify", "bundlefusion_tpu_torch/csrc/dense_verify.cu",
                        "bundlefusion_tpu/features/filters.py:111", max(r["max_abs_err"] for r in out.values()),
                        g["ms"], g["plain_ms"], g["bound_ms"], g["bound_by"], g["library_ms"],
                        library_ms_is="the matmul-form dense verification it replaced (both directions), not "
                                      "one call", graph_ms=g["graph_ms"],
                        share_of_bound_in_graph=g["bound_ms"] / g["graph_ms"], edge_cases=edges, cases=out)


def check_kernels(torch, T, dev):
    """Phase 3: K1-K5 against their twins at flagship shapes."""
    from bundlefusion_tpu_torch.io import framewire
    from bundlefusion_tpu_torch.io.synthetic import generate_sequence
    from bundlefusion_tpu_torch.ops import preprocess as pp

    ac = flagship_config().app
    seq = generate_sequence(21, 640, 480, radius=0.5, device=dev)
    wires = [wire(seq, i, ac) for i in range(21)]
    d16 = torch.as_tensor(np.stack([w[0] for w in wires]).view(np.int16), device=dev)
    depth = pp.wire_depth_to_m(d16)
    c8 = torch.as_tensor(np.stack([w[2] for w in wires]), device=dev)
    poses = torch.as_tensor(seq.poses, device=dev)
    k1 = check_k1(torch, T, dev, depth, c8, poses, seq.camera)
    torch.cuda.empty_cache()
    # the v1 ring's full-res colour (the multi-sequence driver's layout)
    c8_full = torch.as_tensor(np.stack([framewire.frame_to_wire(seq.depth[i], seq.color[i])[1] for i in range(21)]),
                              device=dev)
    full = check_k1(torch, T, dev, depth, c8_full, poses, seq.camera, label="K1 tsdf_fuse, full-res colour")
    if full["max_abs_err"] != 0.0:
        raise AssertionError(f"K1 with full-res colour is not bit-equal to its twin: {full['max_abs_err']}")
    k1["full_res_colour"] = {k: full[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                                  "share_of_bound", "wrapper_ms")}
    del c8_full
    torch.cuda.empty_cache()
    k1["deintegrate"] = check_deintegrate(torch, T, dev, depth, c8, poses, seq.camera)
    torch.cuda.empty_cache()
    k2 = check_k2(torch, T, dev, depth[:11].contiguous(), seq.camera)
    bc = flagship_config().bundling
    cache_cam = seq.camera.scaled(bc.cache_width, bc.cache_height)
    y8 = torch.as_tensor(np.stack([w[1] for w in wires]), device=dev)
    _, cache = pp.preprocess_frames_y(d16, y8, seq.camera, cache_cam, geometry=False)
    del seq, wires, d16, depth, c8, y8
    torch.cuda.empty_cache()
    k3 = check_k3(torch, dev)
    torch.cuda.empty_cache()
    k4 = check_k4(torch, dev)
    torch.cuda.empty_cache()
    k5 = check_k5(torch, dev, cache, poses, cache_cam)
    check_stamps(torch, dev)
    return [k1, k2, k3, k4, k5]


def stamped_chunk(s) -> None:
    """One chunk's device stamps as the pipeline's stage programs make them
    (``pipeline._stamped``, with its row offsets): each stage's begin and
    end, ``chunk_local``'s three parts inside it, and ``plan_fuse``
    advancing the chunk tensor before its end, as ``advance_step`` does."""
    from bundlefusion_tpu_torch.bundle import pipeline as pipe
    from bundlefusion_tpu_torch.utils import timeline

    def parts(s):
        for name in timeline.CHILDREN:
            with s.span(name):
                pass

    work = {"chunk_local": parts, "plan_fuse": lambda s: s.row.add_(1)}
    for span in timeline.STAGES:
        pipe._stamped(work.get(span, lambda s: None), span, s, s)


def stamp_run(torch, dev, rows: int, starts: list[int], stream=None, copy=None, program=None) -> dict:
    """``stamped_chunk`` for a chunk at each row of ``starts`` (the chunk
    tensor set from the host before it), each after an eager upload stamp
    at that row from the host: on ``dev`` through ``program`` (a captured
    graph) on ``stream``, the upload on ``copy``, the two streams made to
    wait on each other so that the stamps keep one order; on the CPU in
    turn. Returns the table, the host clock (ns) just before each chunk's
    first stamp and just after its last, and the stamps launched."""
    from bundlefusion_tpu_torch.utils import timeline

    table = timeline.make_table(rows, dev)
    s = timeline.Stamps(table, torch.zeros((), dtype=torch.int32, device=dev))
    col = timeline.COLUMN["upload"]
    cuda = dev.type == "cuda"
    if cuda:  # the warm-up run and the capture, then a clean table
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            program(s)
            table.zero_()
        torch.cuda.synchronize()
    launches = timeline.stamp.launches
    windows = []
    for r in starts:
        t0 = time.perf_counter_ns()
        with torch.cuda.stream(copy) if cuda else contextlib.nullcontext():
            if cuda:
                copy.wait_stream(stream)
            timeline.stamp(table, col, host_row=r)
            timeline.stamp(table, col + 1, host_row=r)
        with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
            if cuda:
                stream.wait_stream(copy)
                s.row.fill_(r)
                program(s)
                stream.synchronize()
            else:
                s.row.fill_(r)
                stamped_chunk(s)
        windows.append((t0, time.perf_counter_ns()))
    return dict(table=table.cpu().numpy(), windows=windows, launches=timeline.stamp.launches - launches)


def check_stamps(torch, dev) -> dict:
    """Phase 3: the timeline's stamp kernel (``csrc/stamp.cu``) against its
    CPU twin at the main path's table shape [Cmax + 1, 20]: one chunk's
    stamps as the pipeline makes them (``stamped_chunk``), captured once in
    a CUDA graph and replayed for chunks at rows 0-2, then at the last
    chunk's row, the scratch row and past the table's end and before its
    start, each after an eager upload stamp on a copy stream at a row from
    the host. The cells written equal the twin's on the same rows; the
    stamps rise in the order the twin wrote them; each chunk's stamps,
    placed on the host clock by ``timeline.calibrate``, lie within its
    half-width of the host's clock around that chunk; the launches count
    2 per stage, 6 for ``chunk_local``'s parts and 2 for the upload a
    chunk."""
    from bundlefusion_tpu_torch.utils import graphs, timeline

    bc = flagship_config().bundling
    rows = bc.max_frames // bc.submap_size + 1
    starts = [0, 1, 2, rows - 2, rows - 1, rows, rows + 5, -3]
    exe = graphs.Executable(dev, None)
    copy = torch.cuda.Stream(dev)
    program = exe.program("stamps", stamped_chunk)
    card = stamp_run(torch, dev, rows, starts, exe.stream, copy, program)
    offset_ns, err_ns = timeline.calibrate(dev)
    twin = stamp_run(torch, torch.device("cpu"), rows, starts)
    per_chunk = 2 * len(timeline.STAGES) + 2 * len(timeline.CHILDREN) + 2
    cells = sorted(zip(*np.nonzero(twin["table"])), key=lambda rc: twin["table"][rc])  # in the order written
    card_cells = set(zip(*np.nonzero(card["table"])))
    rising = [int(card["table"][rc]) for rc in cells]

    def chunk_of(t_ns, windows):
        return next(i for i, (a, b) in enumerate(windows) if a <= t_ns <= b)

    outside = []
    for rc in cells:
        i = chunk_of(int(twin["table"][rc]), twin["windows"])
        t = int(card["table"][rc]) + offset_ns
        a, b = card["windows"][i]
        if not a - err_ns <= t <= b + err_ns:
            outside.append((int(rc[0]), int(rc[1]), i, (t - a) * 1e-3, (t - b) * 1e-3))
    phase("kernels", f"stamp: table [{rows}, {card['table'].shape[1]}], chunks at rows {starts}: {len(cells)} cells "
          f"written (twin) / {len(card_cells)} (card), equal {set(cells) == card_cells}; rising in the twin's order "
          f"{rising == sorted(rising)}; clock half-width {err_ns * 1e-3:.2f} us, stamps off their chunk's host window "
          f"{outside[:4]}; launches {card['launches']} (want {per_chunk} x {len(starts)}); graph replays "
          f"{program.replays}")
    if set(cells) != card_cells or rising != sorted(rising) or outside or card["launches"] != per_chunk * len(starts):
        raise AssertionError("stamp kernel against its twin: cells, order, host clock or launch count differ")
    return dict(cells=len(cells), err_us=err_ns * 1e-3, launches=card["launches"])


def run_pass(seq, cfg, dev, push_seconds: list | None = None, wrap=None, profile: bool = False):
    """The bench's pass (``bench.run_pass``: push_frame -> flush over a whole
    sequence on a fresh pipeline; returns (pipeline, seconds)) with two
    extras: ``push_seconds`` collects the caller's seconds inside
    push_frame, and ``wrap(steady)`` runs the pushes and the flush (the sync
    counter)."""
    from bundlefusion_tpu_torch import bench

    def outer(bf, steady):
        if push_seconds is not None:
            push = bf.push_frame

            def timed_push(*frame):
                t1 = time.perf_counter()
                push(*frame)
                push_seconds.append(time.perf_counter() - t1)

            bf.push_frame = timed_push
        try:
            steady() if wrap is None else wrap(steady)
        finally:
            if push_seconds is not None:
                del bf.push_frame  # no cycle through the hook: the pipeline frees its executable when dropped

    return bench.run_pass(seq, cfg, dev, profile=profile, wrap=outer)


def run_slice(torch, T, dev, kernels_out):
    """Phase 4: the flagship slice, then the small CPU-vs-card and
    determinism checks. Returns the flagship sequence and configuration."""
    from bundlefusion_tpu_torch.eval.ate import ate_rmse
    from bundlefusion_tpu_torch.io.synthetic import generate_sequence

    cfg = flagship_config()
    seq = generate_sequence(FLAGSHIP_FRAMES, 640, 480, radius=0.5, device=dev)
    bf, dt_warm = run_pass(seq, cfg, dev)
    del bf
    phase("slice", f"warm pass {dt_warm:.2f} s")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    bf, dt = run_pass(seq, cfg, dev)
    out = bf.outputs()
    torch.cuda.synchronize()
    launches = read_launches()
    for k in kernels_out:
        k["launches"] = launches[k["name"]]
    n = min(len(out.poses), len(seq.poses))
    ate = ate_rmse(out.poses[:n], seq.poses[:n], valid=out.valid[:n])
    recs = [r for r in bf.runlog.records if "chunk" in r]
    phase("slice", f"flagship 640x480, {FLAGSHIP_FRAMES} frames: {FLAGSHIP_FRAMES / dt:.3f} fps "
          f"({dt:.3f} s, push_frame -> flush), ATE {ate * 100:.4f} cm, keyframes {out.num_keyframes}, "
          f"active blocks {int(bf.state.table.num_active())}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    phase("slice", "stage timing (device stamps):\n" + bf.timing.report())
    ints = ("num_keys", "filtered_matches", "pairs_valid", "corr_cursor", "alloc_overflow", "upd_truncated",
            "patch_overflow", "reint_frames", "ring_miss", "blocks_touched", "active_blocks", "lost_chunks")
    for r in recs:
        phase("slice", "runlog " + json.dumps({k: r[k] for k in ("chunk", "chunk_valid", "kf_valid") + ints}))
    want = expected_launches(cfg, len(recs))
    phase("slice", f"kernel launches in the timed pass: {launches} over {len(recs)} chunks (K3 from the solves' "
          f"count {want['assemble']}: {bc_solves(cfg, len(recs))})")
    check_launches(launches, want, "the timed flagship pass")
    if not all(r["chunk_valid"] for r in recs):
        raise AssertionError("a flagship chunk was invalid")
    if not ate <= 0.005:
        raise AssertionError(f"flagship ATE {ate * 100:.4f} cm > 0.5 cm")
    if any(r["patch_overflow"] for r in recs):
        raise AssertionError("patch_overflow is not 0")
    ref = dict(poses=out.poses, valid=out.valid, fps=FLAGSHIP_FRAMES / dt, ate=ate,
               global_solve_ms=bf.timing.summary()["global_solve"]["mean_ms"])
    del bf

    # small configuration: CPU (twins) vs card (kernels), and card determinism
    scfg = small_config(T)
    sseq = generate_sequence(SMALL["frames"], SMALL["width"], SMALL["height"], device=dev)
    cpu_bf, _ = run_pass(sseq, scfg, "cpu")
    cpu_out = cpu_bf.outputs()
    gpu = []
    for _ in range(2):
        b, _ = run_pass(sseq, scfg, dev)
        gpu.append((b, b.outputs()))
    (g1, o1), (g2, o2) = gpu

    def masks(b):
        return [(r["chunk_valid"], r["kf_valid"]) for r in b.runlog.records if "chunk" in r]

    if masks(cpu_bf) != masks(g1):
        raise AssertionError(f"chunk/keyframe masks differ: cpu {masks(cpu_bf)} card {masks(g1)}")
    pose_err = float(np.abs(cpu_out.poses - o1.poses).max())
    if pose_err > 1e-4:
        raise AssertionError(f"CPU and card poses differ by {pose_err}")
    if not (np.array_equal(o1.poses, o2.poses) and torch.equal(g1.state.table.weight, g2.state.table.weight)):
        raise AssertionError("two card runs are not bit-identical")
    phase("slice", f"small {SMALL['width']}x{SMALL['height']}, {SMALL['frames']} frames: masks equal "
          f"{masks(g1)}, max |pose cpu - card| {pose_err:.3g}; two card runs bit-identical")
    return seq, cfg, ref


def counted_kernels() -> dict:
    """The kernel wrappers by the name their entries carry."""
    from bundlefusion_tpu_torch.features.filters import dense_verify_sums
    from bundlefusion_tpu_torch.features.sift import sample_window
    from bundlefusion_tpu_torch.fusion.tsdf import integrate_blocks
    from bundlefusion_tpu_torch.ops.preprocess import fused_preprocess
    from bundlefusion_tpu_torch.solver.system import assemble_system
    from bundlefusion_tpu_torch.utils.timeline import stamp

    return {"tsdf_integrate": integrate_blocks, "preprocess": fused_preprocess, "assemble": assemble_system,
            "sift_sample": sample_window, "dense_verify": dense_verify_sums, "stamp": stamp}


def reset_launches() -> None:
    for fn in counted_kernels().values():
        fn.launches = 0


def read_launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in counted_kernels().items()}


def bc_solves(cfg, chunks: int) -> str:
    bc = cfg.bundling
    return (f"{chunks} chunks x 2 local prune rounds x {bc.local_gn_iters} GN iterations + {chunks - 1} global "
            f"solves x {bc.global_gn_iters}")


def expected_launches(cfg, chunks: int) -> dict[str, int]:
    """Kernel launches of a pass of ``chunks`` chunks: one K1 and one K2 per
    chunk; K4 twice (orientation, descriptor) per SIFT octave of each chunk;
    K3 once per GN iteration of the local solve (two prune rounds) and of
    the global solve (one round, from the second chunk on); K5 twice per
    chunk (the filter, the opt-verify) and once per global match (from the
    second chunk on); the timeline's stamps twice per stage the chunk runs
    (``global_solve`` from the second chunk on, ``gc`` every
    ``gc_every_chunks``), six for ``chunk_local``'s parts and two for the
    upload (``finalize()``'s clock calibration is not counted), and with
    the dense global term two more per global GN iteration."""
    bc, ac = cfg.bundling, cfg.app
    h, w, octaves = ac.input_height, ac.input_width, 0
    for _ in range(bc.sift_octaves):
        if h < 16 or w < 16:
            break
        octaves, h, w = octaves + 1, -(-h // 2), -(-w // 2)
    gcs = chunks // ac.gc_every_chunks if ac.gc_every_chunks else 0
    dense = 2 * bc.global_gn_iters if bc.use_dense_global else 0  # global_dense, each GN iteration
    return {"tsdf_integrate": chunks, "preprocess": chunks, "sift_sample": 2 * octaves * chunks,
            "assemble": chunks * 2 * bc.local_gn_iters + (chunks - 1) * bc.global_gn_iters,
            "dense_verify": 3 * chunks - 1, "stamp": 16 * chunks + (2 + dense) * (chunks - 1) + 2 * gcs}


def check_launches(launches: dict[str, int], want: dict[str, int], what: str) -> None:
    """K1, K2, K4, K5 and the stamps as ``expected_launches`` counts them;
    K3 at least once per solve iteration counted there (a relocalization or
    revalidation solves more)."""
    exact = {k: launches[k] for k in ("tsdf_integrate", "preprocess", "sift_sample", "dense_verify", "stamp")}
    if exact != {k: want[k] for k in exact} or launches["assemble"] < want["assemble"]:
        raise AssertionError(f"{what}: kernel launches {launches}, expected {want} (K3 at least)")


def record_launches(kernels_out, path: str, launches: dict[str, int]) -> None:
    """Attach a path's launch counts to the kernels' entries; every kernel
    of the path (K1-K5; the stamps are counted where the timeline is) must
    have launched."""
    for k in kernels_out:
        k.setdefault("launches_by_path", {})[path] = launches[k["name"]]
    if not all(launches[k["name"]] for k in kernels_out):
        raise AssertionError(f"{path}: a kernel of the path was never launched: {launches}")


def sync_sites(torch, fn, where=None) -> list[str]:
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")`` and return
    one line per synchronizing CUDA operation it called, on any thread (the
    ingest workers' warnings reach the global handler): the innermost frame
    of the port's code, then the innermost frame overall, prefixed by
    ``where()`` when given. Every such line is a readback: waiting on a CUDA
    event (the pipeline's backpressure and staging waits) is not a sync
    PyTorch reports, so those waits are read from the pipeline's own
    ``ingest_waits``. Only PyTorch's per-operation warning counts; turning
    the mode on prints a notice of its own, which is not a sync."""
    sites: list[str] = []

    def on_warning(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            stack = traceback.extract_stack()[:-1]
            ours = [f for f in stack if "bundlefusion_tpu_torch" in f.filename] or stack
            site = " <- ".join(f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} ({f.name})" for f in (ours[-1], stack[-1]))
            sites.append(site if where is None else f"{where()}|{site}")

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = on_warning
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sites


def by_site(sites: list[str]) -> dict[str, int]:
    return {x: sites.count(x) for x in sorted(set(sites))}


def count_syncs(torch, T, seq, cfg, dev) -> None:
    """Phase 5: no readback during the steady-state pushes of one flagship
    pass (async ingest); deliberate ``.item()`` calls first show that the
    count sees syncs on the caller's thread and on the ingest's dispatch
    worker, and that "error" mode's exception on that worker comes back
    through its future."""
    from bundlefusion_tpu_torch import bench
    from bundlefusion_tpu_torch.bundle import pipeline as pipe
    from bundlefusion_tpu_torch.bundle.pipeline import BundleFusion

    def readback():
        return torch.ones(1, device=dev).sum().item()

    control = sync_sites(torch, readback)
    worker = sync_sites(torch, lambda: pipe._executor("dispatch").submit(readback).result())
    if len(control) != 1 or len(worker) != 1:
        raise AssertionError(f"the sync counter missed a deliberate sync: caller {control}, worker {worker}")
    # the pipeline's backpressure and staging waits are event waits: the
    # counter must not see them (the pipeline counts them in ingest_waits)
    torch.cuda._sleep(1_000_000)
    ev = torch.cuda.Event()
    ev.record()
    event_wait = sync_sites(torch, ev.synchronize)
    if event_wait:
        raise AssertionError(f"the sync counter reports a CUDA event wait: {event_wait}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe._executor("dispatch").submit(readback).result()
        raised = None
    except RuntimeError as e:
        raised = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if raised is None:
        raise AssertionError("a readback on the dispatch worker in error mode did not raise through its future")
    bf = BundleFusion(seq.camera, cfg, anchor_pose=seq.poses[0], device=dev)
    torch.cuda.synchronize()

    def steady():
        for i in range(len(seq.poses)):
            bf.push_frame(seq.depth[i], seq.color[i])
        bf.flush()

    sites = sync_sites(torch, steady)
    stats = bf.graph_stats
    captured = sorted(k for k, v in stats.items() if v["captured"])
    replays = {k: v["replays"] for k, v in stats.items() if v["replays"]}  # (tiers the pass does not reach: 0)
    want = {k: n for k, n in bench.expected_replays(bf.chunk_count, cfg).items() if n}
    phase("syncs", f"the chunk step replayed the graphs phase 4 captured, chunk 0's included (captured in this "
          f"window: {captured}); replays {replays}")
    if captured:
        raise AssertionError(f"phase 5's window holds a capture ({captured}): the flagship executable was not reused")
    if replays != want:
        raise AssertionError(f"phase 5's pass did not replay every stage of every chunk: {replays} against {want}")
    phase("syncs", f"{len(sites)} readbacks in {FLAGSHIP_FRAMES} steady-state pushes (controls: 1 of 1 seen on the "
          f"caller's thread, 1 of 1 on the dispatch worker, 0 for a CUDA event wait; error mode on the worker raised "
          f"through its future: {raised!r}); by site {by_site(sites)}; ingest waits that blocked (CUDA events and worker futures, "
          f"not readbacks), by site {dict(bf.ingest_waits)}")
    if sites:
        raise AssertionError(f"readbacks in the steady state: {by_site(sites)}")


def keep_or_drop(path: str) -> str:
    """Keep a checked output under the git-ignored output directory when it
    is small; larger files are deleted (the output directory is size-capped)."""
    size = os.path.getsize(path)
    if size <= KEEP_BYTES:
        return f"{path} ({size / 2**20:.1f} MiB, kept)"
    os.remove(path)
    return f"{path} ({size / 2**20:.1f} MiB, checked and deleted)"


def read_ply_header(path: str) -> tuple[int, int]:
    """(vertex count, face count) of a binary PLY, checked against its size."""
    with open(path, "rb") as f:
        head = b""
        while not head.endswith(b"end_header\n"):
            head += f.readline()
        body = os.fstat(f.fileno()).st_size - len(head)
    lines = head.decode("ascii").splitlines()
    nv = int(next(x for x in lines if x.startswith("element vertex")).split()[-1])
    nf = int(next(x for x in lines if x.startswith("element face")).split()[-1])
    if body != nv * 15 + nf * 13:
        raise AssertionError(f"{path}: body of {body} bytes does not hold {nv} vertices and {nf} faces")
    return nv, nf


def tensor_digest(torch, t) -> int:
    """An order-sensitive digest of a tensor's bytes, computed on its device:
    the sum of each element's bits (as an integer) times a position weight,
    in int64 arithmetic that wraps, so the sum's order cannot change it."""
    x = t.detach().contiguous().reshape(-1)
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    v = x.view(ints).to(torch.int64)
    w = torch.arange(v.numel(), device=v.device, dtype=torch.int64) % 65521 + 1
    return int((v * w).sum())


def fusion_digests(torch, objs: dict) -> dict[str, int]:
    """Digests of every tensor of each named nest of dataclasses (a
    ``FusionState``: graph, control, trajectory, block table, update
    records, per-chunk stores, runlog), but the timeline's stamps: device
    clock readings, which differ from run to run."""
    out = {}

    def walk(prefix, obj):
        if dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                if f.name != "stamps":
                    walk(f"{prefix}.{f.name}", getattr(obj, f.name))
        elif isinstance(obj, torch.Tensor):
            out[prefix] = tensor_digest(torch, obj)

    for name, obj in objs.items():
        walk(name, obj)
    return out


def state_digests(torch, bf, extra=None) -> dict[str, object]:
    """Digests of every tensor of a pipeline's device state and of its host
    block store; ``extra`` adds a stage's own outputs."""
    out = fusion_digests(torch, {"state": bf.state, **(extra or {})})
    st = bf.block_store
    h = hashlib.blake2b()
    for a in (st._keys, st._sdf, st._wgt, st._col, np.asarray(st._free, np.int64)):
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(repr(sorted((k, tuple(v)) for k, v in st._chunks.items())).encode())
    out["block_store"] = h.hexdigest()
    return out


def digest_run(torch, T, seq, cfg, dev):
    """One pass over ``seq`` that records, after every stage of every chunk,
    the digests of the whole state (the chunk step's result too, after
    chunk_local: the program's outputs where it has a graph, else
    ``process_chunk``'s return). Returns ([(chunk, stage,
    digests)], pipeline). The digests read the device, so such a pass is
    neither timed nor counted."""
    from bundlefusion_tpu_torch.bundle import chunk as chunk_mod
    from bundlefusion_tpu_torch.bundle.pipeline import BundleFusion

    bf = BundleFusion(seq.camera, cfg, anchor_pose=seq.poses[0], device=dev)
    recs, last = [], {}
    stage_of = bf.timing.stage
    process_chunk = chunk_mod.process_chunk

    def captured(*a, **k):
        last["chunk_result"] = process_chunk(*a, **k)
        return last["chunk_result"]

    @contextlib.contextmanager
    def stage(name, block=False, **kw):
        with stage_of(name, block=block, **kw):
            yield
        if name == "upload":  # the upload worker: it runs beside the chunk step
            return
        extra = None
        if name == "chunk_local":  # a graph's results are its program's outputs (a replay runs no Python, a
            # capture's own return is never computed); an eager stage's are process_chunk's return
            prog, ran = bf._exe.programs[name], last.pop("chunk_result", None)
            extra = {"chunk_result": prog.outputs if prog.graph is not None else ran}
        recs.append((bf.chunk_count, name, state_digests(torch, bf, extra)))

    bf.timing.stage = stage
    chunk_mod.process_chunk = captured
    try:
        for i in range(len(seq.poses)):
            bf.push_frame(seq.depth[i], seq.color[i])
        bf.flush()
    finally:
        chunk_mod.process_chunk = process_chunk
        del bf.timing.stage  # no cycle through the hook: the pipeline frees its executable when dropped
    return recs, bf


def first_difference(a, b):
    """(chunk, stage, differing fields) of the first stage at which two
    digest records differ, or None."""
    if len(a) != len(b):
        return (None, f"{len(a)} against {len(b)} stages", [])
    for (ca, sa, da), (cb, sb, db) in zip(a, b):
        if (ca, sa) != (cb, sb):
            return (ca, f"stage order {sa} / {sb}", [])
        diff = sorted(k for k in da if da[k] != db.get(k))
        if diff:
            return (ca, sa, diff)
    return None


def run_stream(torch, T, dev, kernels_out) -> None:
    """Phase 6: out-of-core streaming with the default check schedule."""
    from bundlefusion_tpu_torch.bundle.pipeline import BundleFusion
    from bundlefusion_tpu_torch.eval.ate import ate_rmse
    from bundlefusion_tpu_torch.fusion.blocks import INVALID_KEY
    from bundlefusion_tpu_torch.io import ply
    from bundlefusion_tpu_torch.io.synthetic import generate_corridor_sequence

    base = flagship_config()
    cfg = dataclasses.replace(base, app=dataclasses.replace(base.app, **{
        k: STREAM[k] for k in ("streaming_radius", "block_capacity", "mc_max_triangles")}))
    ac = cfg.app
    n = STREAM["frames"]
    t0 = time.perf_counter()
    seq = generate_corridor_sequence(n, *FULL, x_span=STREAM["x_span"], device=dev)
    phase("stream", f"corridor {n} frames {FULL[0]}x{FULL[1]} rendered in {time.perf_counter() - t0:.2f} s; streaming radius "
          f"{ac.streaming_radius} m, watermark {ac.streaming_watermark}, check every {ac.streaming_check_every} "
          f"chunks, block_capacity {ac.block_capacity}")
    bf = BundleFusion(seq.camera, cfg, anchor_pose=seq.poses[0], device=dev)
    torch.cuda.synchronize()
    reset_launches()

    def walk():
        for i in range(n):
            bf.push_frame(seq.depth[i], seq.color[i])
        bf.flush()

    t0 = time.perf_counter()
    sites = sync_sites(torch, walk, where=lambda: bf.chunk_count)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    record_launches(kernels_out, "stream", launches)
    gc_stats = bf.graph_stats.get("gc")
    out = bf.outputs()
    recs = [r for r in bf.runlog.records if "stream_out" in r]
    chunks = [r for r in bf.runlog.records if "chunk_valid" in r]
    gc_calls = len(chunks) // ac.gc_every_chunks
    st = bf.timing.summary().get("streaming", {"count": 0, "total_s": 0.0, "max_ms": 0.0})
    n_in, n_out = sum(r["stream_in"] for r in recs), sum(r["stream_out"] for r in recs)
    device_blocks, host_blocks = int(bf.state.table.num_active()), len(bf.block_store)
    # distinct blocks of the scene: the device's and the host store's keys
    # (a block re-allocated while cold is in both until a stream-in merges it)
    keys = [bf.state.table.keys[bf.state.table.keys != INVALID_KEY].cpu().numpy()]
    keys += [k for k, _, _, _ in bf.block_store.snapshot_batches(4096)]
    distinct = len(np.unique(np.concatenate(keys)))
    ate = ate_rmse(out.poses[:n], seq.poses[:n], valid=out.valid[:n])
    sync_chunks = sorted({int(x.split("|", 1)[0]) for x in sites})
    per_site = by_site([x.split("|", 1)[1] for x in sites])
    phase("stream", f"{n / dt:.3f} fps ({dt:.3f} s push_frame -> flush, {len(chunks)} chunks, under sync debug "
          f"mode); kernel launches {launches}; streaming steps {st['count']} ({st['total_s']:.3f} s in all, "
          f"max {st['max_ms']:.1f} ms), stream-in {n_in} blocks, stream-out {n_out} blocks, engaged at chunk "
          f"{recs[0]['chunk'] if recs else None}; device {device_blocks} + host {host_blocks} blocks, {distinct} "
          f"distinct, against a pool of {ac.block_capacity}; active blocks by chunk "
          f"{[r['active_blocks'] for r in chunks]}; alloc_overflow {sum(r['alloc_overflow'] for r in chunks)}; "
          f"tracking_lost_chunks {out.tracking_lost_chunks}; ATE {ate * 100:.4f} cm")
    phase("stream", "stage timing (device stamps; streaming: host clock, with its host reads):\n" + bf.timing.report())
    phase("stream", f"{len(sites)} readbacks at chunks {sync_chunks}; by site {per_site}; ingest waits that "
          f"blocked {dict(bf.ingest_waits)}")
    phase("stream", "runlog streaming steps " + json.dumps(recs))
    phase("stream", f"gc program at chunks {[c - 1 for c in range(ac.gc_every_chunks, len(chunks) + 1, ac.gc_every_chunks)]}: "
          f"{gc_stats}; gc_freed_total {chunks[-1]['gc_freed_total']}")
    if not (gc_stats and gc_stats["captured"] and gc_stats["route"] == "graph" and gc_stats["replays"] == gc_calls - 1):
        raise AssertionError(f"the corridor's gc program was not captured at its first call and replayed after: "
                             f"{gc_stats} over {gc_calls} calls")
    first_check = ac.streaming_check_every - 1
    if not recs or recs[0]["chunk"] != first_check:
        raise AssertionError(f"streaming did not engage at the first check (chunk {first_check}): {recs[:2]}")
    if not sites or min(sync_chunks) < first_check:
        raise AssertionError(f"host syncs before the first streaming check: chunks {sync_chunks}")
    if host_blocks == 0 or device_blocks + host_blocks <= ac.block_capacity or distinct <= ac.block_capacity:
        raise AssertionError(f"the walk did not outgrow the pool: device {device_blocks}, host {host_blocks}, "
                             f"distinct {distinct}")
    if any(r["alloc_overflow"] for r in chunks):
        raise AssertionError("the pool overflowed")
    if out.tracking_lost_chunks != 0 or not ate < 0.02:
        raise AssertionError(f"corridor tracking: lost chunks {out.tracking_lost_chunks}, ATE {ate * 100:.3f} cm")

    t0 = time.perf_counter()
    verts, cols, faces = bf.extract_mesh()
    t_mesh = time.perf_counter() - t0
    x_lo, x_hi = float(verts[:, 0].min()), float(verts[:, 0].max())
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "stream_mesh.ply")
    ply.write_ply(path, verts, cols, faces)
    nv, nf = read_ply_header(path)
    phase("stream", f"extract_mesh {t_mesh:.3f} s, {len(faces)} triangles (device table and {host_blocks} host "
          f"blocks), x from {x_lo:.3f} to {x_hi:.3f} m; {path} ({os.path.getsize(path) / 2**20:.1f} MiB)")
    if nf != len(faces) or not (x_lo < 0.3 and x_hi > STREAM["x_span"] + 1.0):
        raise AssertionError(f"the mesh does not span the walked corridor: x {x_lo:.3f}..{x_hi:.3f}, {nf} faces")
    del bf

    # determinism: two more passes, each digesting the whole state after
    # every stage of every chunk; then their meshes against the first pass's
    t0 = time.perf_counter()
    (ra, ba), (rb, bb) = digest_run(torch, T, seq, cfg, dev), digest_run(torch, T, seq, cfg, dev)
    diff = first_difference(ra, rb)
    meshes = [bx.extract_mesh() for bx in (ba, bb)]
    same_mesh = [all(np.array_equal(x, y) for x, y in zip(m, (verts, cols, faces))) for m in meshes]
    # the first digested pass reuses the timed pass's executable; the second
    # runs while the first is alive, so it takes a fresh one and captures
    gc_replays = [(bx.graph_stats["gc"]["replays"], bx.graph_stats["gc"]["captured"]) for bx in (ba, bb)]
    phase("stream", f"determinism: two digested passes ({time.perf_counter() - t0:.1f} s), {len(ra)} stages "
          f"compared; first difference (chunk, stage, fields): {diff}; meshes {[len(m[2]) for m in meshes]} "
          f"triangles, equal to the timed pass's {same_mesh}; gc (replays, captured) {gc_replays}")
    if diff is not None or not all(same_mesh):
        raise AssertionError(f"the corridor is not deterministic: first difference {diff}, meshes equal {same_mesh}")
    if gc_replays != [(gc_calls, False), (gc_calls - 1, True)]:
        raise AssertionError(f"the digested passes did not replay gc at each of its {gc_calls} calls on the reused "
                             f"executable and at each after the first on a fresh one: {gc_replays}")


def out_and_back_sequence(w: int, h: int, dev, num_frames: int = 41, blackout: tuple[int, int] | None = (20, 24)):
    """The JAX package's out-and-back orbit (``tests/test_loopclosure.py``)
    rendered at w x h, with the depth blacked out over the frames
    ``blackout`` (start, stop), 20..23 unless given; None keeps every frame."""
    from bundlefusion_tpu_torch.geometry.camera import CameraModel
    from bundlefusion_tpu_torch.io.synthetic import orbit_poses, render_sequence

    fx = 0.9 * w
    cam = CameraModel.create(fx, fx, (w - 1) / 2, (h - 1) / 2, w, h)
    base = orbit_poses(num_frames, radius=0.45, seed=3)
    half = num_frames // 2
    seq = render_sequence(np.concatenate([base[: half + 1], base[half - 1 :: -1]])[:num_frames], cam, device=dev)
    if blackout is None:
        return seq
    depth = seq.depth.copy()
    depth[slice(*blackout)] = 0.0
    return seq._replace(depth=depth)


def run_reloc(torch, T, dev, kernels_out) -> None:
    """Phase 7: relocalization after a depth blackout, and its aftermath."""
    from bundlefusion_tpu_torch.eval.ate import ate_rmse

    seq = out_and_back_sequence(*FULL, dev)
    cfg = flagship_config()
    reset_launches()
    bf, dt = run_pass(seq, cfg, dev)
    t0 = time.perf_counter()
    out = bf.outputs()  # finalize(): revalidation, then the re-integration service
    torch.cuda.synchronize()
    t_fin = time.perf_counter() - t0
    launches = read_launches()
    record_launches(kernels_out, "reloc", launches)
    reloc = int(bf.state.ctrl.reloc_events)
    valid = out.valid
    cut = 30  # the first chunk after the blackout starts at frame 30 (submap 10)
    sel = valid.copy()
    sel[:cut] = False
    ate_tail = ate_rmse(out.poses, seq.poses[: len(out.poses)], valid=sel)
    phase("reloc", f"{FULL[0]}x{FULL[1]}, {len(seq.poses)} frames, depth blacked out at 20..23: {dt:.3f} s push_frame -> flush, "
          f"finalize {t_fin:.3f} s; relocalizations {reloc}, keyframes valid "
          f"{bf.state.graph.valid[: bf.num_keyframes].cpu().numpy().astype(int).tolist()}, frames valid "
          f"{''.join('1' if v else '0' for v in valid)}; post-cut ATE {ate_tail * 100:.4f} cm; launches {launches}")
    if reloc < 1 or not valid[cut:].all() or not ate_tail < 0.04:
        raise AssertionError(f"relocalization: events {reloc}, valid after the cut {valid[cut:].tolist()}, "
                             f"post-cut ATE {ate_tail * 100:.3f} cm")
    del bf

    sseq = out_and_back_sequence(SMALL["width"], SMALL["height"], dev)
    scfg = small_config(T)
    runs = {}
    for d in ("cpu", dev):
        b, _ = run_pass(sseq, scfg, d)
        runs[str(d)] = (b, b.outputs())
    (cb, co), (gb, go) = runs["cpu"], runs[str(dev)]
    err = float(np.abs(co.poses - go.poses).max())
    phase("reloc", f"128x96 on the CPU and on the card: relocalizations {int(cb.state.ctrl.reloc_events)} / "
          f"{int(gb.state.ctrl.reloc_events)}, valid masks equal {np.array_equal(co.valid, go.valid)}, "
          f"max |pose cpu - card| {err:.3g}")
    if not np.array_equal(co.valid, go.valid) or err > 1e-4 or int(gb.state.ctrl.reloc_events) < 1:
        raise AssertionError(f"128x96 relocalization: CPU and card differ (pose error {err})")


def run_app(torch, T, dev, kernels_out) -> None:
    """Phase 8: the app's --synthetic and --sens routes on the card."""
    from bundlefusion_tpu_torch import app
    from bundlefusion_tpu_torch.bundle.checkpoint import load_checkpoint
    from bundlefusion_tpu_torch.io import sens
    from bundlefusion_tpu_torch.io.synthetic import generate_sequence

    cfg = flagship_config()
    root = os.path.join(OUT_DIR, "app")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    common = [*write_config_json(cfg, root), "--device", str(dev)]
    n = FLAGSHIP_FRAMES
    routes = {}
    reset_launches()
    t0 = time.perf_counter()
    synth = os.path.join(root, "synthetic")
    app.main(["--synthetic", str(n), "--width", str(FULL[0]), "--height", str(FULL[1]), "--preview-every", "33",
              "--checkpoint-every", "3", "--out", synth, *common])
    routes["synthetic"] = (synth, time.perf_counter() - t0)
    seq = generate_sequence(n, *FULL, device=dev)  # the frames the --synthetic route rendered
    sens_path = os.path.join(root, "in.sens")
    sens.write_sens(sens_path, seq.depth, seq.color, seq.poses, seq.camera)
    t0 = time.perf_counter()
    sens_out = os.path.join(root, "sens")
    app.main(["--sens", sens_path, "--out", sens_out, *common])
    routes["sens"] = (sens_out, time.perf_counter() - t0)
    os.remove(sens_path)
    launches = read_launches()
    record_launches(kernels_out, "app", launches)

    problems = []  # raised together once every output has been checked and printed
    for name, (d, secs) in routes.items():
        with open(os.path.join(d, "summary.json")) as f:
            summary = json.load(f)
        nv, nf = read_ply_header(os.path.join(d, "mesh.ply"))
        traj = np.loadtxt(os.path.join(d, "trajectory.txt"), ndmin=2)
        previews = sorted(x for x in os.listdir(d) if x.startswith("preview_"))
        phase("app", f"--{name}: {secs:.2f} s; frames {summary['frames']}, keyframes {summary['keyframes']}, "
              f"lost chunks {summary['tracking_lost_chunks']}, ATE {summary['ate_rmse_m'] * 100:.4f} cm, active "
              f"blocks {summary['active_blocks']}, triangles {summary['mesh_triangles']}; trajectory.txt "
              f"{len(traj)} rows; previews {previews}; {keep_or_drop(os.path.join(d, 'mesh.ply'))}")
        if not (summary["frames"] >= n and summary["ate_rmse_m"] <= 0.005 and nf == summary["mesh_triangles"] > 0
                and len(traj) == summary["frames"] and np.isfinite(traj).all()):
            problems.append(f"--{name}: bad outputs (frames, ATE, mesh or trajectory)")
    if [x.split(".")[0] for x in sorted(os.listdir(synth)) if x.startswith("preview_")] != [
            f"preview_{f:05d}" for f in range(33, n + 1, 33)]:
        problems.append("--synthetic: previews missing")

    # the app checkpoints after a replayer batch (8 frames) that leaves a
    # multiple of 3 chunks done; chunk c is done once 1 + S * (c + 1) frames are in
    s = cfg.bundling.submap_size
    done = [(min(f, n) - 1) // s for f in range(8, n + 8, 8)]
    chunks = max(c for c in done if c and c % 3 == 0)
    ck = os.path.join(synth, "checkpoint.pkl")
    bf = load_checkpoint(ck, device=dev)
    phase("app", f"checkpoint: {bf.chunk_count} chunks, {bf.num_frames} frames, {int(bf.state.table.num_active())} "
          f"blocks restored; {keep_or_drop(ck)}")
    if bf.chunk_count != chunks or bf.num_frames != s * chunks + 1:
        problems.append(f"checkpoint holds {bf.chunk_count} chunks / {bf.num_frames} frames, not {chunks}")
    for i in range(bf._next_fid, n):  # the restored pipeline keeps consuming frames
        bf.push_frame(seq.depth[i], seq.color[i])
    bf.flush()
    out = bf.outputs()
    pose = out.poses[-1]
    bf.render_preview(pose)  # warm
    ms = cuda_ms(torch, lambda: bf.render_preview(pose), n=5, batch=1)
    img = bf.render_preview(pose)
    phase("app", f"restored pipeline finished {out.poses.shape[0]} frames; render_preview "
          f"{bf.config.app.raycast_width}x{bf.config.app.raycast_height}: {ms:.2f} ms (median of 5, host reads "
          f"included), "
          f"splat_truncated {bf.splat_truncated}, {(img != 0.1).any(axis=-1).mean():.3f} of pixels hit")
    ac = bf.config.app
    if img.shape != (ac.raycast_height, ac.raycast_width, 3) or not np.isfinite(img).all():
        problems.append(f"render_preview gave {img.shape}")
    if problems:
        raise AssertionError("; ".join(problems))


MULTISEQ_ORDER = ("graphed", "eager", "eager", "graphed")  # phase 9's timed runs, interleaved


def sharded_pass(torch, seqs, mesh, cfg, mode: str, keep=None, trace: bool = False) -> dict:
    """One ``ShardedRun`` over ``seqs``, built graphed (the default) or under
    ``graphs.disable_graphs()``: its chunk rounds timed (ending in a
    synchronize) under the sync counter, launches, replays per shard and
    stage, peak memory (construction and rounds), per-shard state digests,
    outputs; with ``trace`` the rounds run
    under ``device_only_trace``; ``keep(run, out)`` reads more before the
    run is dropped (a live run holds its executables)."""
    from bundlefusion_tpu_torch.parallel.spmd_pipeline import ShardedRun
    from bundlefusion_tpu_torch.utils import graphs

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with graphs.disable_graphs() if mode == "eager" else contextlib.nullcontext():
        run = ShardedRun(seqs, mesh, cfg, anchor_poses=np.stack([s.poses[0] for s in seqs]))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    frames = len(seqs) * (run.n_chunks * cfg.bundling.submap_size + 1)
    traced = {}

    def rounds():
        for c in range(run.n_chunks):
            run.step(c)

    reset_launches()
    t0 = time.perf_counter()
    if trace:
        sites = sync_sites(torch, lambda: traced.update(device_only_trace(torch, rounds, frames, "multiseq")))
    else:
        sites = sync_sites(torch, rounds)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rec = dict(mode=mode, seconds=dt, fps=frames / dt, setup_s=t_setup, launches=read_launches(), syncs=sites,
               chunks=run.n_chunks, stats=run.graph_stats, trace=traced,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               digests=[fusion_digests(torch, {"shard": sh}) for sh in run.shards])
    out = run.outputs()
    rec.update(poses=out.poses, valid=out.valid, runlogs=out.runlogs)
    if keep is not None:
        rec.update(keep(run, out))
    del run, out
    gc.collect()
    return rec


def run_multiseq(torch, T, dev, kernels_out, ref) -> None:
    """Phase 9: the multi-sequence driver on 2 flagship sequences over a
    2-shard mesh: a first graphed run on fresh shard executables (it
    captures), then timed runs interleaved graphed / eager / eager /
    graphed, each shard's state digests equal in all; then a device-only
    trace of a graphed and an eager run; then the app's --multiseq route,
    then 2 shards at 128x96 on the CPU against the card."""
    from bundlefusion_tpu_torch import app, bench
    from bundlefusion_tpu_torch.eval.ate import ate_rmse
    from bundlefusion_tpu_torch.io.synthetic import generate_sequence
    from bundlefusion_tpu_torch.parallel.mesh import make_mesh
    from bundlefusion_tpu_torch.parallel.spmd_pipeline import extract_mesh_for, run_sequences_sharded
    from bundlefusion_tpu_torch.utils import graphs

    smi = bench.device_line(dev)
    cfg = flagship_config()
    seqs = [generate_sequence(FLAGSHIP_FRAMES, *FULL, seed=s, radius=0.5, device=dev) for s in (0, 1)]
    mesh = make_mesh(2, "cuda")
    phase("multiseq", f"mesh {mesh!r}")

    def mesh0(run, out):
        verts, _, faces = extract_mesh_for(out, 0, cfg)
        return dict(triangles=len(faces))

    first = sharded_pass(torch, seqs, mesh, cfg, "graphed", keep=mesh0)
    launches, sites, n_chunks = first["launches"], first["syncs"], first["chunks"]
    record_launches(kernels_out, "multiseq", launches)
    n_out = first["poses"].shape[1]
    ates = [ate_rmse(first["poses"][i], seqs[i].poses[:n_out], valid=first["valid"][i]) for i in range(2)]
    chunk_valid = first["runlogs"][..., 0].astype(bool)
    capture = [{k: round(v["capture_s"], 3) for k, v in st.items()} for st in first["stats"]]
    phase("multiseq", f"2 flagship sequences x {n_chunks} chunks ({n_out} frames each; {smi}), first run on fresh "
          f"shard executables: {2 * n_out / first['seconds']:.3f} fps over both ({first['seconds']:.3f} s for the "
          f"chunk rounds, capture included; wire conversion and executables {first['setup_s']:.2f} s); capture s per "
          f"shard and stage {json.dumps(capture)}; phase 4's serial pass {ref['fps']:.3f} fps; ATE "
          f"{ates[0] * 100:.4f} / {ates[1] * 100:.4f} cm; chunks valid {chunk_valid.astype(int).tolist()}; launches "
          f"{launches}; {len(sites)} host syncs; peak memory with two shard executables {first['peak_gib']:.3f} GiB; "
          f"sequence 0 meshes to {first['triangles']} triangles")
    per_shard_chunk = 2 * n_chunks
    if launches["tsdf_integrate"] != per_shard_chunk or launches["preprocess"] != per_shard_chunk:
        raise AssertionError(f"expected one K1 and one K2 launch per shard and chunk: {launches}")
    if not chunk_valid.all() or not first["valid"].all() or max(ates) > ATE_BAR:
        raise AssertionError(f"multiseq: chunks valid {chunk_valid.tolist()}, ATE {ates}")
    if sites:
        raise AssertionError(f"host syncs in the sharded driver's steady state: {sorted(set(sites))}")
    if any(not v["captured"] or v["route"] != "graph" for st in first["stats"] for v in st.values()):
        raise AssertionError(f"the first run did not capture every stage of every shard: {first['stats']}")

    want = {k: n for k, n in bench.expected_replays(n_chunks, cfg).items() if n}
    timed = [sharded_pass(torch, seqs, mesh, cfg, mode) for mode in MULTISEQ_ORDER]
    for p in timed:
        diff = [sorted(k for k in a if a[k] != b.get(k)) for a, b in zip(first["digests"], p["digests"])]
        if any(diff) or not np.array_equal(first["poses"], p["poses"]) or not np.array_equal(first["valid"], p["valid"]):
            raise AssertionError(f"a {p['mode']} run differs from the first graphed run: {[d[:8] for d in diff]}")
        if p["syncs"] or p["launches"] != launches:
            raise AssertionError(f"{p['mode']}: {len(p['syncs'])} host syncs, launches {p['launches']}")
        replays = [{k: v["replays"] for k, v in st.items() if v["replays"]} for st in p["stats"]]
        routes = {v["route"] for st in p["stats"] for v in st.values()}
        if p["mode"] == "graphed" and (replays != [want, want] or any(v["captured"] for st in p["stats"] for v in st.values())):
            raise AssertionError(f"a graphed run on the reused executables does not replay every stage: {p['stats']}")
        if p["mode"] == "eager" and routes != {"eager: disable_graphs()"}:
            raise AssertionError(f"an eager run's routes: {routes}")
    for mode in ("graphed", "eager"):
        fps = [round(p["fps"], 3) for p in timed if p["mode"] == mode]
        peak = max(p["peak_gib"] for p in timed if p["mode"] == mode)
        phase("multiseq", f"{mode} ({smi}): {fps} fps over both sequences (interleaved {'/'.join(MULTISEQ_ORDER)}), "
              f"median {statistics.median(fps):.3f}; peak memory {peak:.3f} GiB")
    # a reused executable's state is reset in place: no second state beside it
    reused_peak = max(p["peak_gib"] for p in timed if p["mode"] == "graphed")
    phase("multiseq", f"peak memory, graphed: {reused_peak:.3f} GiB on reused shard executables against "
          f"{first['peak_gib']:.3f} GiB on fresh ones")
    if reused_peak > first["peak_gib"] + 0.05:
        raise AssertionError(f"reused shard executables peak at {reused_peak:.3f} GiB, fresh ones at "
                             f"{first['peak_gib']:.3f} GiB")
    phase("multiseq", f"replays per shard and stage, graphed: {[{k: v['replays'] for k, v in st.items()} for st in timed[0]['stats']]}; "
          f"{len(timed)} runs' state digests ({len(first['digests'][0])} fields per shard), poses and validity "
          f"bit-equal to the first run's; 0 host syncs and {launches} launches in each")

    busy = {}
    for mode in ("graphed", "eager"):
        busy[mode] = sharded_pass(torch, seqs, mesh, cfg, mode, trace=True)["trace"]
        phase("multiseq", f"device-only trace, {mode} ({smi}): busy {busy[mode]['busy_share'] * 100:.1f}% of the "
              f"chunk rounds' {busy[mode]['window_ms']:.1f} ms; device kernels {busy[mode]['launches_per_frame']:.1f} "
              f"per frame (of both sequences); host launch calls {busy[mode]['host_launch_calls_per_frame']:.1f} per "
              f"frame {busy[mode]['host_launch_calls']}")
    with open(os.path.join(OUT_DIR, "multiseq_phase.json"), "w") as f:
        json.dump(dict(device=smi, chunks=n_chunks, first={k: first[k] for k in ("seconds", "setup_s", "stats", "peak_gib")},
                       timed=[{k: p[k] for k in ("mode", "fps", "seconds", "stats", "peak_gib")} for p in timed],
                       busy=busy), f,
                  indent=1)

    root = os.path.join(OUT_DIR, "app_multiseq")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cfg_args = write_config_json(cfg, root)
    reset_launches()
    t0 = time.perf_counter()
    app.main(["--synthetic", str(FLAGSHIP_FRAMES), "--width", str(FULL[0]), "--height", str(FULL[1]),
              "--multiseq", "2", "--out", root, *cfg_args, "--device", str(dev)])
    secs = time.perf_counter() - t0
    record_launches(kernels_out, "app_multiseq", read_launches())
    with open(os.path.join(root, "summary.json")) as f:
        summary = json.load(f)
    nv, nf = read_ply_header(os.path.join(root, "mesh_0.ply"))
    phase("multiseq", f"app --multiseq 2: {secs:.2f} s; {summary['mesh']}; ATE (m) {summary['ate_rmse_m']}; "
          f"{nf} triangles; {keep_or_drop(os.path.join(root, 'mesh_0.ply'))}")
    if max(summary["ate_rmse_m"].values()) > ATE_BAR or nf != summary["mesh_triangles"] or nf == 0:
        raise AssertionError(f"app --multiseq: bad outputs {summary}")

    scfg = small_config(T)
    sseqs = [generate_sequence(SMALL["frames"], SMALL["width"], SMALL["height"], seed=s, device=dev) for s in (0, 1)]
    anchors = np.stack([s.poses[0] for s in sseqs])
    cpu = run_sequences_sharded(sseqs, make_mesh(2, "cpu"), scfg, anchor_poses=anchors)
    gpu = run_sequences_sharded(sseqs, mesh, scfg, anchor_poses=anchors)
    err = float(np.abs(cpu.poses - gpu.poses).max())
    phase("multiseq", f"128x96, 2 shards, CPU against the card: validity equal {np.array_equal(cpu.valid, gpu.valid)}, "
          f"max |pose cpu - card| {err:.3g}")
    if not np.array_equal(cpu.valid, gpu.valid) or err > 2e-5:
        raise AssertionError(f"sharded driver: CPU and card differ (pose error {err})")


def write_config_json(cfg, root: str) -> list[str]:
    """The configuration as the app's two JSON files; returns their flags."""
    paths = []
    for name, part in (("app.json", cfg.app), ("bundling.json", cfg.bundling)):
        paths.append(os.path.join(root, name))
        with open(paths[-1], "w") as f:
            json.dump(dataclasses.asdict(part), f)
    return ["--app-config", paths[0], "--bundling-config", paths[1]]


def run_sharded(torch, T, dev, kernels_out, seq, cfg, ref) -> None:
    """Phase 10: the serial flagship pipeline with its global BA sharded over
    a 2-shard mesh (both shards on the pipeline's card, so the sharded
    solve runs through the global_solve program): a first pass on a fresh
    executable (it captures), a second (it replays) and an eager pass under
    ``graphs.disable_graphs()``; all three bit-equal, against phase 4's
    unsharded pass."""
    from bundlefusion_tpu_torch import bench
    from bundlefusion_tpu_torch.bundle.pipeline import BundleFusion
    from bundlefusion_tpu_torch.eval.ate import ate_rmse
    from bundlefusion_tpu_torch.parallel.mesh import make_mesh
    from bundlefusion_tpu_torch.utils import graphs

    smi = bench.device_line(dev)
    mesh = make_mesh(2, "cuda")
    passes = []
    for mode in ("graphed", "graphed", "eager"):
        with graphs.disable_graphs() if mode == "eager" else contextlib.nullcontext():
            bf = BundleFusion(seq.camera, cfg, anchor_pose=seq.poses[0], mesh=mesh, device=dev)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()

        def steady():
            for i in range(len(seq.poses)):
                bf.push_frame(seq.depth[i], seq.color[i])
            bf.flush()

        sites = sync_sites(torch, steady)
        del steady  # it holds the pipeline, which must be freed before the next is built
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches()
        digests = state_digests(torch, bf)
        out = bf.outputs()
        passes.append(dict(mode=mode, fps=FLAGSHIP_FRAMES / dt, syncs=sites, launches=launches, digests=digests,
                           poses=out.poses, valid=out.valid, stats=bf.graph_stats, chunks=bf.chunk_count,
                           global_solve_ms=bf.timing.summary()["global_solve"]["mean_ms"],
                           report=bf.timing.report()))
        del bf, out
        gc.collect()
    first, replayed, eager = passes
    record_launches(kernels_out, "sharded", replayed["launches"])
    n = min(len(first["poses"]), len(seq.poses))
    ate = ate_rmse(first["poses"][:n], seq.poses[:n], valid=first["valid"][:n])
    gap = float(np.abs(first["poses"] - ref["poses"]).max())
    gs = replayed["stats"]["global_solve"]
    for p in passes:
        phase("sharded", f"{mesh!r}, {p['mode']} ({smi}): {p['fps']:.3f} fps (phase 4: {ref['fps']:.3f}); "
              f"global_solve {p['global_solve_ms']:.2f} ms per chunk (phase 4: {ref['global_solve_ms']:.2f}); "
              f"global_solve program {p['stats']['global_solve']}; launches {p['launches']}; {len(p['syncs'])} host "
              f"syncs")
    phase("sharded", f"ATE {ate * 100:.4f} cm; max |pose - phase 4's| {gap:.3g}; validity equal "
          f"{np.array_equal(first['valid'], ref['valid'])}; the three passes' state digests, poses and validity "
          f"bit-equal")
    phase("sharded", "stage timing of the replayed pass (device stamps):\n" + replayed["report"])
    if ate > ATE_BAR or not np.array_equal(first["valid"], ref["valid"]):
        raise AssertionError(f"sharded pipeline: ATE {ate}, validity equal {np.array_equal(first['valid'], ref['valid'])}")
    for p in passes[1:]:
        diff = sorted(k for k in first["digests"] if first["digests"][k] != p["digests"].get(k))
        if diff or not np.array_equal(first["poses"], p["poses"]) or not np.array_equal(first["valid"], p["valid"]):
            raise AssertionError(f"the {p['mode']} sharded pass differs from the first: {diff[:8]}")
    if not (gs["graph"] and gs["route"] == "graph" and not gs["captured"] and gs["replays"] == replayed["chunks"] - 1):
        raise AssertionError(f"the sharded global solve did not replay once per chunk after the first: {gs}")
    if eager["stats"]["global_solve"]["route"] != "eager: disable_graphs()":
        raise AssertionError(f"the eager pass's route: {eager['stats']['global_solve']}")
    if any(p["syncs"] for p in passes):
        raise AssertionError(f"host syncs in the sharded pipeline: {[by_site(p['syncs']) for p in passes]}")


def run_configs(torch, T, dev, kernels_out, seq, ref) -> None:
    """Phase 11: the flagship pass with filtered-depth integration and with a
    320x240 integration resolution; the host cost of the wire bilateral; the
    native .sens codecs against pure Python."""
    from bundlefusion_tpu_torch.eval.ate import ate_rmse
    from bundlefusion_tpu_torch.io import framewire, native, sens

    base = flagship_config()
    wi, hi = FULL[0] // 2, FULL[1] // 2
    settings = {
        "filtered_depth": dict(integrate_filtered_depth=True),
        f"integration_{wi}x{hi}": dict(integration_width=wi, integration_height=hi),
    }
    for name, change in settings.items():
        cfg = dataclasses.replace(base, app=dataclasses.replace(base.app, **change))
        reset_launches()
        bf, dt = run_pass(seq, cfg, dev)
        launches = read_launches()
        record_launches(kernels_out, name, launches)
        out = bf.outputs()
        n = min(len(out.poses), len(seq.poses))
        ate = ate_rmse(out.poses[:n], seq.poses[:n], valid=out.valid[:n])
        recs = [r for r in bf.runlog.records if "chunk" in r]
        phase("configs", f"{name}: {FLAGSHIP_FRAMES / dt:.3f} fps (phase 4: {ref['fps']:.3f}); ATE {ate * 100:.4f} cm; "
              f"blocks {int(bf.state.table.num_active())}; ring {tuple(bf.state.hist_d16.shape[1:])}; "
              f"launches {launches} over {len(recs)} chunks")
        if ate > ATE_BAR or not all(r["chunk_valid"] for r in recs) or launches["tsdf_integrate"] != len(recs) \
                or launches["preprocess"] != len(recs):
            raise AssertionError(f"{name}: ATE {ate}, launches {launches}")
        del bf

    ac = base.app
    d16 = framewire.frame_to_wire(seq.depth[0], seq.color[0])[0]
    ms = host_ms(lambda: framewire.bilateral_wire(d16, ac.depth_sigma_d, ac.depth_sigma_r))
    phase("configs", f"bilateral_wire on the host (native: {framewire.have_native()}): {ms:.2f} ms per "
          f"{FULL[0]}x{FULL[1]} frame (median of 5)")

    have = native.have_native()
    enc = sens.rvl_encode(d16)
    z = native.deflate(d16.tobytes())
    dec_t, ok = {}, True
    for label, rvl, inflate in (("native", native.rvl_decode, native.inflate),
                                ("python", sens.rvl_decode, lambda b, n: zlib.decompress(b))):
        t0 = time.perf_counter()
        r = rvl(enc, d16.size)
        t1 = time.perf_counter()
        zz = inflate(z, d16.nbytes)
        t2 = time.perf_counter()
        dec_t[label] = (1e3 * (t1 - t0), 1e3 * (t2 - t1))
        ok = ok and r.tobytes() == d16.tobytes() and zz == d16.tobytes()
    phase("configs", f"native codecs built: {have} ({native.LIB_PATH}); one {FULL[0]}x{FULL[1]} depth frame, RVL / zlib decode "
          f"ms: native {dec_t['native'][0]:.3f} / {dec_t['native'][1]:.3f}, pure Python {dec_t['python'][0]:.3f} / "
          f"{dec_t['python'][1]:.3f}; equal bytes {ok}")
    if not have or not ok or native.rvl_encode(d16) != enc:
        raise AssertionError(f"native codecs: built {have}, equal bytes {ok}")


def run_ingest(torch, T, dev, kernels_out, seq, cfg, ref) -> None:
    """Phase 12: the ingest stage. The native converter against numpy; the
    flagship pass with async ingest, with BF_SYNC_INGEST=1 and with
    profile=True (equal digests); the filtered-depth pass on the native
    bilateral; the two developer tools."""
    from bundlefusion_tpu_torch.bundle import pipeline as pipe
    from bundlefusion_tpu_torch.eval.ate import ate_rmse
    from bundlefusion_tpu_torch.io import framewire
    from bundlefusion_tpu_torch.tools import offline_matching, profile_stages

    ac = cfg.app
    have = framewire.have_native()
    phase("ingest", f"native wire converter built: {have} ({framewire.LIB_PATH}); OMP threads "
          f"{os.environ.get('OMP_NUM_THREADS', 'default')}, {os.cpu_count()} CPUs")
    if not have:
        raise AssertionError("the native wire converter did not build")
    depth, color = seq.depth[0], seq.color[0]
    wire_nat = framewire.frame_to_wire2(depth, color, depth_min=ac.depth_min, depth_max=ac.depth_max)
    wire_np = framewire._frame_to_wire2_np(depth, color, ac.depth_min, ac.depth_max)
    equal_wire = all(a.tobytes() == b.tobytes() for a, b in zip(wire_nat, wire_np))
    d16 = wire_nat[0]
    bil_nat = framewire.bilateral_wire(d16, ac.depth_sigma_d, ac.depth_sigma_r)
    bil_np = framewire._bilateral_wire_np(d16, ac.depth_sigma_d, ac.depth_sigma_r)
    diff = np.abs(bil_nat.astype(np.int64) - bil_np.astype(np.int64))
    pack_equal = framewire.pack_depth12(d16).tobytes() == framewire._pack_depth12_np(d16).tobytes()
    t = {
        "frame_to_wire2": (host_ms(lambda: framewire.frame_to_wire2(depth, color, depth_min=ac.depth_min,
                                                                    depth_max=ac.depth_max)),
                           host_ms(lambda: framewire._frame_to_wire2_np(depth, color, ac.depth_min, ac.depth_max))),
        "bilateral": (host_ms(lambda: framewire.bilateral_wire(d16, ac.depth_sigma_d, ac.depth_sigma_r)),
                      host_ms(lambda: framewire._bilateral_wire_np(d16, ac.depth_sigma_d, ac.depth_sigma_r))),
        "pack_depth12": (host_ms(lambda: framewire.pack_depth12(d16)),
                         host_ms(lambda: framewire._pack_depth12_np(d16))),
    }
    phase("ingest", f"one {FULL[0]}x{FULL[1]} frame, host ms native / numpy (median of 5): "
          + "; ".join(f"{k} {a:.3f} / {b:.3f}" for k, (a, b) in t.items())
          + f"; frame_to_wire2 equal bytes {equal_wire}, pack_depth12 equal bytes {pack_equal}; bilateral: "
          f"{int((diff > 0).sum())} of {diff.size} pixels differ, max {int(diff.max())} mm, zero masks equal "
          f"{np.array_equal(bil_nat == 0, bil_np == 0)}")
    if not (equal_wire and pack_equal and diff.max() <= 1 and np.array_equal(bil_nat == 0, bil_np == 0)):
        raise AssertionError("the native wire converter disagrees with numpy")

    n = len(seq.poses)
    runs = {}
    # the last pass repeats the async one under the sync counter
    for mode in ("async", "sync", "profile", "async, sync counter on"):
        if mode == "sync":
            os.environ["BF_SYNC_INGEST"] = "1"
        sites = None
        counted = {}
        try:
            reset_launches()
            push = []
            wrap = (lambda steady: counted.update(r=sync_sites(torch, steady))) if mode.startswith("async, ") else None
            bf, dt = run_pass(seq, cfg, dev, push, wrap=wrap, profile=(mode == "profile"))
            if counted:
                sites = counted["r"]
        finally:
            os.environ.pop("BF_SYNC_INGEST", None)
        launches = read_launches()
        record_launches(kernels_out, f"ingest_{mode.split(',')[0]}", launches)
        out = bf.outputs()
        runs[mode] = dict(poses=out.poses, digests=state_digests(torch, bf), upload_bytes=bf.upload_bytes,
                          report=bf.timing.report(), wire=(bf.chunk_frames, bf.S, bf._wire_dims))
        phase("ingest", f"{mode} stage table:\n" + runs[mode]["report"])
        phase("ingest", f"{mode}: {n / dt:.3f} fps ({dt:.3f} s push_frame -> flush; the caller's thread spent "
              f"{sum(push):.3f} s in push_frame, max {1e3 * max(push):.2f} ms in one call); upload bytes first "
              f"{bf.upload_bytes[0]:,}, steady {sorted(set(bf.upload_bytes[1:]))} over {len(bf.upload_bytes)} "
              f"chunks; ingest waits that blocked {dict(bf.ingest_waits)}; launches {launches}"
              + ("" if sites is None else f"; readbacks {len(sites)} {by_site(sites)}"))
        if sites:
            raise AssertionError(f"readbacks in the async steady state: {by_site(sites)}")
        if bf._async_ingest != mode.startswith("async"):
            raise AssertionError(f"{mode}: async ingest is {bf._async_ingest}")
        if launches["tsdf_integrate"] != len(bf.upload_bytes) or launches["preprocess"] != len(bf.upload_bytes):
            raise AssertionError(f"{mode}: expected one K1 and one K2 launch per chunk: {launches}")
        del bf, out
    a = runs["async"]
    cf, sub, dims = a["wire"]
    want = [pipe._wire_nbytes(cf, *dims), pipe._wire_nbytes(sub, *dims)]
    phase("ingest", f"upload bytes predicted first {want[0]:,} / steady {want[1]:,} (12-bit depth {dims[-1]})")
    if a["upload_bytes"][0] != want[0] or set(a["upload_bytes"][1:]) != {want[1]}:
        raise AssertionError(f"upload bytes {a['upload_bytes']} against {want}")
    for mode in ("sync", "profile", "async, sync counter on"):
        r = runs[mode]
        diff = sorted(k for k in a["digests"] if a["digests"][k] != r["digests"].get(k))
        same_poses = np.array_equal(a["poses"], r["poses"])
        phase("ingest", f"{mode} against async: digests of {len(a['digests'])} state fields equal {not diff}, "
              f"poses equal {same_poses}")
        if diff or not same_poses:
            raise AssertionError(f"{mode} ingest differs from async: {diff[:8]}")
    phase("ingest", "(the profile pass's stages wait for the device at their end and are host-clock times; the "
          "others are CUDA-event spans)")
    del runs
    torch.cuda.empty_cache()

    fcfg = dataclasses.replace(cfg, app=dataclasses.replace(cfg.app, integrate_filtered_depth=True))
    reset_launches()
    bf, dt = run_pass(seq, fcfg, dev)
    launches = read_launches()
    record_launches(kernels_out, "filtered_native", launches)
    out = bf.outputs()
    m = min(len(out.poses), n)
    ate = ate_rmse(out.poses[:m], seq.poses[:m], valid=out.valid[:m])
    phase("ingest", f"filtered depth on the native bilateral: {n / dt:.3f} fps (phase 4: {ref['fps']:.3f}); ATE "
          f"{ate * 100:.4f} cm; launches {launches}")
    if ate > ATE_BAR:
        raise AssertionError(f"filtered depth on the native bilateral: ATE {ate}")
    del bf
    torch.cuda.empty_cache()

    times = profile_stages.main([str(FULL[0]), str(FULL[1]), "--device", str(dev), "--reps", "5"])
    phase("ingest", "profile_stages at 640x480 (median of 5, CUDA events): " + json.dumps(times))
    if not all(np.isfinite(v) and v > 0 for v in times.values()):
        raise AssertionError(f"profile_stages: {times}")
    torch.cuda.empty_cache()
    root = os.path.join(OUT_DIR, "offline_matching")
    shutil.rmtree(root, ignore_errors=True)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        offline_matching.main(["--synthetic", "8", "--frames", "0", "5", "--width", str(FULL[0]), "--height",
                               str(FULL[1]), "--out", root, "--device", str(dev)])
    text = buf.getvalue()
    stats = json.loads(text[text.index("{"):])
    phase("ingest", f"offline_matching on orbit frames 0 and 5 at 640x480: {json.dumps(stats)}; images "
          f"{sorted(os.listdir(root))}")
    if not (stats["keys_a"] > 0 and stats["keys_b"] > 0 and len(os.listdir(root)) == 4
            and np.isfinite(stats["relative_rotation_rad"])):
        raise AssertionError(f"offline_matching: {stats}")


def chunk_records(bf) -> list[dict]:
    return [r for r in bf.runlog.records if "chunk_valid" in r]


def one_launch_per_chunk(kernels_out, path: str, launches: dict[str, int], chunks: int) -> None:
    record_launches(kernels_out, path, launches)
    if launches["tsdf_integrate"] != chunks or launches["preprocess"] != chunks:
        raise AssertionError(f"{path}: expected one K1 and one K2 launch per chunk: {launches} over {chunks} chunks")


def frames_valid(valid) -> str:
    return "".join("1" if v else "0" for v in valid)


def run_paths(torch, T, dev, kernels_out, seq, cfg, ref) -> None:
    """Phase 13: the paths no earlier phase runs, each at 640x480 on the
    flagship configuration with async ingest and one K1 and one K2 launch
    per chunk: the dense global BA (no readback, its peak memory, the
    out-and-back loop, CPU against the card at 128x96), tracking loss and
    its clearing by relocalization, noisy sensor input and 4 mm voxels."""
    from bundlefusion_tpu_torch import bench
    from bundlefusion_tpu_torch.io.synthetic import apply_sensor_noise, generate_sequence

    smi = bench.device_line(dev)
    n = len(seq.poses)
    bc = cfg.bundling
    dcfg = dataclasses.replace(cfg, bundling=dataclasses.replace(bc, use_dense_global=True))

    # the dense global BA on phase 4's frames, under the sync counter
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    counted = {}
    bf, dt = run_pass(seq, dcfg, dev, wrap=lambda steady: counted.update(r=sync_sites(torch, steady)))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = bf.outputs()
    recs = chunk_records(bf)
    g = bf.state.graph
    cursor, overflow = int(g.dense_cursor), int(g.dense_overflow)
    ate = bench.ate_of(out, seq)
    gs = bf.timing.summary()["global_solve"]["mean_ms"]
    sites = counted["r"]
    phase("paths", f"dense global BA ({smi}), flagship {n} frames: {n / dt:.3f} fps (phase 4: {ref['fps']:.3f}, "
          f"under the sync counter); ATE {ate * 100:.4f} cm (phase 4: {ref['ate'] * 100:.4f}, ratio "
          f"{ate / ref['ate']:.3f}); chunks valid "
          f"{[int(r['chunk_valid']) for r in recs]}; dense pairs {cursor} of {bc.max_dense_pairs_global} slots, "
          f"overflow {overflow}; global_solve {gs:.2f} ms per chunk (phase 4: {ref['global_solve_ms']:.2f}); peak "
          f"memory {peak:.3f} GiB; {len(sites)} readbacks {by_site(sites)}; launches {launches}")
    phase("paths", "dense global stage timing (device stamps):\n" + bf.timing.report())
    one_launch_per_chunk(kernels_out, "dense_global", launches, len(recs))
    if sites:
        raise AssertionError(f"readbacks in the dense global pass: {by_site(sites)}")
    # (on this orbit the reference's own dense terms double the ATE: the
    # colour term; ROADMAP Queue 3. The JAX test's 1.10 x bar is held on its
    # own scenario, the out-and-back below)
    if not all(r["chunk_valid"] for r in recs) or not ate <= ATE_BAR:
        raise AssertionError(f"dense global: chunks valid {[r['chunk_valid'] for r in recs]}, ATE {ate}")
    if cursor == 0 or overflow != 0:
        raise AssertionError(f"dense global: cursor {cursor}, overflow {overflow}")
    del bf, out, g

    # the out-and-back orbit, sparse only and with the dense global BA: the
    # return closes the loop against the first keyframes, and the dense terms
    # keep the ATE within the JAX test's bar (tests/test_loopclosure.py)
    lseq = out_and_back_sequence(*FULL, dev, blackout=None)
    loop_ate = {}
    for dense, c in ((False, cfg), (True, dcfg)):
        reset_launches()
        bf, dt = run_pass(lseq, c, dev)
        launches = read_launches()
        out = bf.outputs()
        recs = chunk_records(bf)
        corrs = bf.state.graph.corrs
        loop = int(((corrs.weight > 0) & ((corrs.img_a - corrs.img_b).abs() >= 3)).sum())
        cursor = int(bf.state.graph.dense_cursor)
        loop_ate[dense] = ate = bench.ate_of(out, lseq)
        phase("paths", f"out-and-back orbit, use_dense_global={dense} ({smi}), {len(lseq.poses)} frames: "
              f"{len(lseq.poses) / dt:.3f} fps; ATE {ate * 100:.4f} cm; frames valid {frames_valid(out.valid)}; "
              f"{loop} weighted correspondences between keyframes 3 or more apart; dense pairs {cursor}; launches "
              f"{launches}")
        one_launch_per_chunk(kernels_out, f"out_and_back{'_dense' if dense else ''}", launches, len(recs))
        if loop == 0 or cursor == 0 or out.tracking_lost_chunks != 0 or not ate < 0.02:
            raise AssertionError(f"out-and-back: {loop} loop correspondences, cursor {cursor}, "
                                 f"lost chunks {out.tracking_lost_chunks}, ATE {ate}")
        del bf, out, corrs
    if not loop_ate[True] <= 1.10 * loop_ate[False] + 1e-4:
        raise AssertionError(f"out-and-back: dense ATE {loop_ate[True]} against sparse {loop_ate[False]}")

    # the dense global BA at 128x96 on the CPU (twins) and on the card
    scfg = small_config(T)
    scfg = dataclasses.replace(scfg, bundling=dataclasses.replace(scfg.bundling, use_dense_global=True))
    sseq = generate_sequence(SMALL["frames"], SMALL["width"], SMALL["height"], device=dev)
    small = {}
    for d in ("cpu", dev):
        b, _ = run_pass(sseq, scfg, d)
        small[str(d)] = (b, b.outputs())
    (cb, co), (gb, go) = small["cpu"], small[str(dev)]
    err = float(np.abs(co.poses - go.poses).max())
    cursors = (int(cb.state.graph.dense_cursor), int(gb.state.graph.dense_cursor))

    def masks(b):
        return [(r["chunk_valid"], r["kf_valid"]) for r in chunk_records(b)]

    phase("paths", f"dense global BA at {SMALL['width']}x{SMALL['height']}, {SMALL['frames']} frames, CPU against the "
          f"card: masks equal {masks(cb) == masks(gb)}, dense cursors {cursors}, max |pose cpu - card| {err:.3g}")
    if masks(cb) != masks(gb) or cursors[0] != cursors[1] or cursors[0] == 0 or err > 1e-4:
        raise AssertionError(f"dense global at 128x96: CPU and card differ (pose error {err}, cursors {cursors})")
    del small, cb, gb

    # tracking loss: three whole chunks without depth, then the return
    s = bc.submap_size
    tseq = out_and_back_sequence(*FULL, dev, num_frames=TRACK["frames"], blackout=TRACK["blackout"])
    reset_launches()
    bf, dt = run_pass(tseq, cfg, dev)
    launches = read_launches()
    out = bf.outputs()
    recs = chunk_records(bf)
    lost = [bool(r["tracking_lost"]) for r in recs]
    ok = np.array([bool(r["chunk_valid"]) for r in recs])
    bad = np.flatnonzero(~ok)
    reloc = int(bf.state.ctrl.reloc_events)
    after = s * (int(bad[-1]) + 1) if len(bad) else 0
    phase("paths", f"tracking loss ({smi}), out-and-back {len(tseq.poses)} frames with the depth zeroed over "
          f"{TRACK['blackout'][0]}..{TRACK['blackout'][1] - 1}: {len(tseq.poses) / dt:.3f} fps; chunks valid "
          f"{ok.astype(int).tolist()}; tracking_lost {[int(x) for x in lost]}; reloc "
          f"{[int(r['reloc']) for r in recs]} ({reloc} events); lost chunks {out.tracking_lost_chunks}; frames valid "
          f"{frames_valid(out.valid)}; ATE over the valid frames {bench.ate_of(out, tseq) * 100:.4f} cm; launches {launches}")
    one_launch_per_chunk(kernels_out, "tracking_loss", launches, len(recs))
    first = int(bad[0]) if len(bad) else -1
    run3 = len(bad) >= 3 and (bad[:3] == first + np.arange(3)).all()
    if not (run3 and not any(lost[: first + 2]) and lost[first + 2] and not lost[-1]):
        raise AssertionError(f"tracking loss: the flag's sequence {lost} over chunks valid {ok.tolist()}")
    if reloc < 1 or not (ok[int(bad[-1]) + 1:].all() and out.valid[after:].all()):
        raise AssertionError(f"tracking loss: {reloc} relocalizations, frames valid after {after}: "
                             f"{frames_valid(out.valid[after:])}")
    del bf, out

    # noisy sensor input (bench.py's noisy pass) on phase 4's frames
    t0 = time.perf_counter()
    nseq = apply_sensor_noise(seq)
    t_noise = time.perf_counter() - t0
    reset_launches()
    bf, dt = run_pass(nseq, cfg, dev)
    launches = read_launches()
    out = bf.outputs()
    recs = chunk_records(bf)
    ate = bench.ate_of(out, nseq)
    m = min(len(out.poses), n)
    noisy = {"ate_noisy_cm": ate * 100, "noisy_valid_fraction": float(np.asarray(out.valid[:m]).mean())}
    phase("paths", f"noisy input ({smi}), {n} frames (noise applied in {t_noise:.2f} s on the host): "
          f"{n / dt:.3f} fps; {json.dumps(noisy)}; chunks valid {[int(r['chunk_valid']) for r in recs]}; lost "
          f"chunks {out.tracking_lost_chunks}; launches {launches}")
    one_launch_per_chunk(kernels_out, "noisy", launches, len(recs))
    if out.tracking_lost_chunks != 0 or not ate < 0.02:
        raise AssertionError(f"noisy input: lost chunks {out.tracking_lost_chunks}, ATE {ate * 100:.3f} cm")
    del bf, out, nseq

    # 4 mm voxels (the AppConfig defaults) at the flagship's capacities
    mcfg = dataclasses.replace(cfg, app=dataclasses.replace(cfg.app, voxel_size=0.004, truncation=0.02))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    bf, dt = run_pass(seq, mcfg, dev)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = bf.outputs()
    recs = chunk_records(bf)
    ate = bench.ate_of(out, seq)
    pose = out.poses[-1]
    bf.render_preview(pose)  # warm
    ms = cuda_ms(torch, lambda: bf.render_preview(pose), n=5, batch=1)
    ac = mcfg.app
    phase("paths", f"4 mm voxels ({smi}), {n} frames, {ac.block_capacity} blocks, blocks_per_frame_cap "
          f"{ac.blocks_per_frame_cap}: {n / dt:.3f} fps; ATE {ate * 100:.4f} cm; chunks valid "
          f"{[int(r['chunk_valid']) for r in recs]}; alloc_overflow {sum(int(r['alloc_overflow']) for r in recs)} "
          f"{[int(r['alloc_overflow']) for r in recs]}; upd_truncated {sum(int(r['upd_truncated']) for r in recs)} "
          f"{[int(r['upd_truncated']) for r in recs]}; active blocks {int(bf.state.table.num_active())}; peak memory "
          f"{peak:.3f} GiB; render_preview {ac.raycast_width}x{ac.raycast_height} {ms:.2f} ms (median of 5, host "
          f"reads included); launches {launches}")
    one_launch_per_chunk(kernels_out, "voxels_4mm", launches, len(recs))
    if not all(r["chunk_valid"] for r in recs) or not out.valid.all() or not ate <= ATE_BAR:
        raise AssertionError(f"4 mm voxels: chunks valid {[r['chunk_valid'] for r in recs]}, ATE {ate}")


# phase 16: the dense cell's traffic to chunk DENSE_CHUNK at DENSE_SEED
DENSE_CELL = "bf640-1cm-denseglobal.room-sweep"
DENSE_SPARSE_PEAK = 18.55e9  # bytes: bf640-1cm.room-sweep's memory_peak_bytes (PERF.md §4)
DENSE_SEED = 2147480117
DENSE_CHUNK = 100
# the dense term against its plain reference, per live pair: counts of
# depth and colour associations within 0.2% of the reference's (at least
# one pixel: float32 tests flip pixels within rounding of a threshold), JtJ
# within 1e-4 relative Frobenius error (float32 sums of a pair's per-pixel
# products), Jtr within 1e-3 (its signed terms cancel, so its relative
# error exceeds theirs); a pixel that flips moves its pair's blocks by
# about one part in its count, so on the card at least DENSE_PAIR_SHARE of
# the live pairs pass all four
DENSE_COUNT_SHARE, DENSE_JTJ_TOL, DENSE_JTR_TOL, DENSE_PAIR_SHARE = 0.002, 1e-4, 1e-3, 0.995


def dense_pair_errors(torch, JtJ, Jtr, n_depth, n_color, want) -> np.ndarray:
    """[P, 4] per pair: each count's difference over its allowance, JtJ's
    and Jtr's relative Frobenius errors against the reference ``want``
    (``dense_ba.PairTerms``; 0 where both are 0)."""
    def rel(got, ref):
        d = torch.linalg.vector_norm((got.double().cpu() - ref).reshape(ref.shape[0], -1), dim=-1)
        r = torch.linalg.vector_norm(ref.reshape(ref.shape[0], -1), dim=-1)
        return torch.where(r > 0, d / torch.where(r > 0, r, 1.0), d)

    def over(got, ref):
        allow = torch.clamp((DENSE_COUNT_SHARE * ref.double()).floor(), min=1.0)
        return (got.cpu().double() - ref.double()).abs() / allow

    return torch.stack([over(n_depth, want.n_depth), over(n_color, want.n_color), rel(JtJ, want.JtJ),
                        rel(Jtr, want.Jtr)], -1).numpy()


def dense_pairs_within(err: np.ndarray) -> np.ndarray:
    """Which pairs of :func:`dense_pair_errors` pass every tolerance."""
    return (err[:, 0] <= 1) & (err[:, 1] <= 1) & (err[:, 2] <= DENSE_JTJ_TOL) & (err[:, 3] <= DENSE_JTR_TOL)


def run_dense_reference(torch, T, dev) -> None:
    """Phase 16: the dense global term of the benchmark's dense cell against
    its plain reference: the blocks the timed path computed at chunk
    ``DENSE_CHUNK``, against the reference at that chunk's inputs."""
    from benchmark import drive, spec
    from benchmark.reference import dense_ba as ref
    from bundlefusion_tpu_torch import bench
    from bundlefusion_tpu_torch.bundle.pipeline import DENSE_FIELDS
    from bundlefusion_tpu_torch.ops.preprocess import FrameCache
    from bundlefusion_tpu_torch.solver import gn, residuals

    smi = bench.device_line(dev)
    cell = spec.cell(DENSE_CELL)
    cfg = spec.port_config(cell.config)
    bc, ac = cfg.bundling, cfg.app
    slots = bc.max_dense_pairs_global
    if not (bc.dense_weight_ramp and bc.global_gn_iters > 1):
        raise AssertionError("dense cell: the first GN iteration is told by its ramped weight; the ramp is off")
    frames = DENSE_CHUNK * bc.submap_size + bc.chunk_size
    t0 = time.perf_counter()
    scan = drive.make_scan(cell.mix, ac.input_width, ac.input_height, DENSE_SEED, dev, frames=frames)
    phase("denseref", f"{DENSE_CELL}: {frames} frames of {cell.mix['scan_frames']} rendered from seed {DENSE_SEED} "
          f"in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # the term as the solve calls it; in a global solve's first GN iteration
    # (its slots, its ramped weight) its outputs are copied into ``probe``
    # too: a device copy, captured with global_solve's graph and replayed
    # with it, so the probe holds the blocks of the chunk last solved
    probe = (torch.zeros(slots, 12, 12, device=dev), torch.zeros(slots, 12, device=dev),
             torch.zeros(slots, dtype=torch.int32, device=dev), torch.zeros(slots, dtype=torch.int32, device=dev))
    scale = np.float32(1.0) / np.float32(bc.global_gn_iters)  # the ramp's first step, as solve_gn computes it
    weights = (float(np.float32(bc.weight_dense_depth) * scale), float(np.float32(bc.weight_dense_color) * scale))
    blocks, probed = gn.dense_pair_blocks, []

    def dense_pair_blocks(poses, pairs_a, pairs_b, pair_active, caches, cache_cam, bcfg, w_depth, w_color):
        JtJ, Jtr, st = blocks(poses, pairs_a, pairs_b, pair_active, caches, cache_cam, bcfg, w_depth, w_color)
        if pairs_a.shape[0] == slots and (w_depth, w_color) == weights:
            for dst, src in zip(probe, (JtJ, Jtr, st.num_valid_depth, st.num_valid_color)):
                dst.copy_(src)
            probed.append(torch.cuda.is_current_stream_capturing())
        return JtJ, Jtr, st

    gn.dense_pair_blocks = dense_pair_blocks
    try:
        bf = drive.pipeline_factory(scan, cfg, dev)()
        snap = {}
        run_stage = bf._run

        def run(name, fn, *args):
            """The stage; at chunk DENSE_CHUNK global_solve's inputs copied
            on the pipeline's stream before it runs and the probe after it
            (device copies: no read)."""
            at = name == "global_solve" and bf.num_keyframes - 1 == DENSE_CHUNK
            if at:
                g = bf.state.graph
                snap.update(poses=g.poses.clone(), valid=g.valid.clone(), a=g.dense_pairs_a.clone(),
                            b=g.dense_pairs_b.clone(), on=g.dense_pair_on.clone(),
                            cache=FrameCache(*(getattr(g.cache, f.name).clone()
                                               for f in dataclasses.fields(FrameCache))))
            out = run_stage(name, fn, *args)
            if at:
                snap["timed"] = tuple(x.clone() for x in probe)
            return out

        bf._run = run
        # chunks 0 and 1 first: each program's eager run and capture (and
        # their constants' uploads) lie there; the steady state is what follows
        warm = 2 * bc.submap_size + 1
        for i in range(warm):
            bf.push_frame(scan.depth[i], scan.color[i])
        bf.sync()

        def steady():
            for i in range(warm, frames):
                bf.push_frame(scan.depth[i], scan.color[i])
            bf.flush()

        t0 = time.perf_counter()
        sites = sync_sites(torch, steady)
        dt = time.perf_counter() - t0
        del bf._run  # no cycle through the hook
        bf.outputs()
        stats = bf.graph_stats["global_solve"]
    finally:
        gn.dense_pair_blocks = blocks
    peak = torch.cuda.max_memory_allocated()
    recs = chunk_records(bf)
    stray = [x for x in sites if "_streaming_step" not in x]
    phase("denseref", f"({smi}) {frames} frames through push_frame, {frames - warm} of them in {dt:.2f} s under the "
          f"sync counter: {len(sites)} readbacks, every one at a streaming check: {not stray} {by_site(sites)}; "
          f"chunks valid "
          f"{sum(r['chunk_valid'] for r in recs)} of {len(recs)}; pipeline peak memory {peak / 1e9:.3f} GB "
          f"({(peak - DENSE_SPARSE_PEAK) / 1e9:+.3f} GB against bf640-1cm's {DENSE_SPARSE_PEAK / 1e9:.2f}); "
          f"global_solve {stats}, its first-iteration blocks probed in {len(probed)} runs of the stage's code "
          f"(capturing: {probed})")
    if stray or not snap:
        raise AssertionError(f"dense cell: readbacks off the streaming checks {by_site(stray)}, snapshot {bool(snap)}")
    if not (stats["captured"] and stats["replays"] > 0 and True in probed):
        raise AssertionError(f"dense cell: global_solve not replayed from a graph holding the probe: {stats}, "
                             f"{probed}")

    # graph_step, global_solve and global_dense medians by slot tier (kept chunks)
    tiers: dict[int, dict[str, list]] = {}
    for r in recs:
        tl = r["timeline"]
        if r["chunk"] == 0 or tl["flush"] or tl["profiled"]:
            continue
        t = tiers.setdefault(tl["graph_slots"], {"graph_step": [], "global_solve": [], "global_dense": []})
        for s in ("graph_step", "global_solve"):
            t[s].append(tl["device"][s][1] - tl["device"][s][0])
        t["global_dense"].append(sum(e - b for b, e in tl["device_iters"]["global_dense"]))
    phase("denseref", "device ms a chunk by slot tier (medians; chunks): " + json.dumps(
        {t: {"chunks": len(v["graph_step"]), **{s: round(statistics.median(x) * 1e3, 3) for s, x in v.items()}}
         for t, v in sorted(tiers.items())}))
    rec = recs[DENSE_CHUNK]
    phase("denseref", f"chunk {DENSE_CHUNK}'s counters: " + json.dumps({k: rec[k] for k in DENSE_FIELDS}))

    # the timed path's first-iteration blocks at every slot against the
    # reference at the inputs it had
    on = snap["on"] & snap["valid"][snap["a"].long()] & snap["valid"][snap["b"].long()]
    live = int(on.sum())
    if live != rec["dense_pairs_live"] or snap["on"].shape[0] != slots:
        raise AssertionError(f"dense cell: {live} live pairs in the snapshot, {rec['dense_pairs_live']} counted")
    prm = ref.Params(dataclasses.asdict(bc))
    rcache = ref.Cache(*(getattr(snap["cache"], f.name) for f in dataclasses.fields(FrameCache)))
    t0 = time.perf_counter()
    want = ref.pairs_in_blocks(snap["poses"].double().cpu(), snap["a"][on].cpu(), snap["b"][on].cpu(), rcache,
                               ref.Camera(*bf.cache_cam), prm, prm.scale(0, bc.global_gn_iters), device=dev)
    t_ref = time.perf_counter() - t0

    def bf16(x):
        return x.bfloat16().float()

    JtJ, Jtr, st = residuals.dense_pair_blocks(  # the control: the term from bfloat16-rounded inputs
        bf16(snap["poses"]), snap["a"], snap["b"], on,
        FrameCache(*(bf16(getattr(snap["cache"], f.name)) for f in dataclasses.fields(FrameCache))),
        bf.cache_cam, bc, *weights)
    out = {}
    for name, (JtJ, Jtr, n_depth, n_color) in (("timed", snap["timed"]),
                                               ("bfloat16", (JtJ, Jtr, st.num_valid_depth, st.num_valid_color))):
        err = dense_pair_errors(torch, JtJ[on], Jtr[on], n_depth[on], n_color[on], want)
        ok = dense_pairs_within(err)
        zero = not (JtJ[~on].any() or Jtr[~on].any() or n_depth[~on].any())
        out[name] = {"pairs_within": float(ok.mean()), "inactive_zero": bool(zero),
                     **{f"{k}_max": float(err[:, i].max())
                        for i, k in enumerate(("depth_over", "color_over", "JtJ", "Jtr"))},
                     **{f"{k}_p99": float(np.quantile(err[:, i], 0.99)) for i, k in ((2, "JtJ"), (3, "Jtr"))}}
    phase("denseref", f"first-iteration dense blocks of the replayed global_solve at {slots} slots ({live} live, "
          f"{int(want.n_depth.sum())} depth and {int(want.n_color.sum())} colour associations in the reference, "
          f"computed in float64 on the card in {t_ref:.1f} s): " + json.dumps(out))
    if not (out["timed"]["pairs_within"] >= DENSE_PAIR_SHARE and out["timed"]["inactive_zero"]):
        raise AssertionError(f"dense cell: the timed path's blocks against the reference {out['timed']}")
    if out["bfloat16"]["pairs_within"] >= DENSE_PAIR_SHARE:
        raise AssertionError(f"dense cell: the bfloat16 control passes {out['bfloat16']}")
    del bf, snap, scan


def bench_subprocess(name: str, env_extra: dict, smi: str) -> dict:
    """``python -m bundlefusion_tpu_torch.bench`` as a user runs it; its
    output goes to ``chiprun_out/bench_<name>.log``. Checks the result
    line's keys and median, every diagnostic key of bench.py and the port's,
    the ATE, the noisy pass and every chunk's validity. The bench itself
    raises when a pass counts other GN iterations or blocks updated."""
    env = {**os.environ, **env_extra}
    passes = int(env.get("BENCH_PASSES", 5))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "bundlefusion_tpu_torch.bench"], cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"bench_{name}.log"), "w") as f:
        f.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"bench {name} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    diag = json.loads([line for line in proc.stderr.splitlines() if line.startswith("{")][-1])
    fps = diag["fps_passes"]
    lo, hi = min(fps), max(fps)
    shown = {k: v for k, v in diag.items() if k != "timing"}
    phase("bench", f"{name} ({smi}; {secs:.1f} s in the subprocess): {json.dumps(result)}")
    phase("bench", f"{name} diagnostics: {json.dumps(shown)}; median {statistics.median(fps):.3f} fps, range "
          f"{lo:.3f}-{hi:.3f} ({(hi - lo) / statistics.median(fps) * 100:.1f}% of the median); GN iterations and "
          f"blocks updated equal in all {passes + 1} passes")
    for which in ("warm_profiled", "timed"):
        table = {k: round(v["mean_ms"], 2) for k, v in diag["timing"][which].items()}
        phase("bench", f"{name} {which} stage means (ms): {json.dumps(table)}")
    if set(result) != {"metric", "value", "unit", "vs_baseline"} or result["metric"] != "end_to_end_fps":
        raise AssertionError(f"bench {name}: result line {result}")
    if len(fps) != passes or result["value"] != round(statistics.median(fps), 2):
        raise AssertionError(f"bench {name}: value {result['value']} is not the median of {fps}")
    missing = [k for k in BENCH_KEYS if k not in diag]
    if missing:
        raise AssertionError(f"bench {name}: diagnostics lack {missing}")
    if not diag["timed_replayed_cached_graphs"]:
        raise AssertionError(f"bench {name}: a timed pass did not replay the warm pass's graphs: "
                             f"{diag['graph_replays']}")
    if not (diag["ate_cm"] <= 0.5 and diag["noisy_valid_fraction"] == 1.0 and all(diag["chunks_valid"])):
        raise AssertionError(f"bench {name}: ATE {diag['ate_cm']} cm, noisy valid fraction "
                             f"{diag['noisy_valid_fraction']}, chunks valid {diag['chunks_valid']}")
    return dict(result=result, diagnostics=shown, seconds=secs)


def innermost_spans(spans: list, points: list) -> dict:
    """For host spans (start, end, name) of one thread, which nest, and
    points (t, key): {key: name of the innermost span holding t}."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(points):
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[key] = stack[-1][2]
    return out


def short_kernel(name: str) -> str:
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for sep in ("<", "("):
        name = name.split(sep)[0]
    return name[:70]


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the port's kernels by the name of their __global__ function
OUR_KERNELS = {"tsdf_fuse_kernel": "tsdf_integrate", "preprocess_kernel": "preprocess",
               "assemble_flags_kernel": "assemble pass 1", "assemble_rows_kernel": "assemble pass 2",
               "sift_sample_kernel": "sift_sample", "dense_verify_kernel": "dense_verify", "stamp_kernel": "stamp"}
# the host's calls that put work on the device: a kernel launch, a whole
# CUDA graph's launch, an asynchronous copy or fill
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def launch_calls(events: list, w0: float, w1: float) -> dict:
    """The host's launch calls (``LAUNCH_CALLS``) in a trace window, by name."""
    out: dict = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and e["name"] in LAUNCH_CALLS and w0 <= float(e["ts"]) < w1:
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def trace_events(prof, path: str) -> list:
    """The complete events of a torch.profiler run, read back from its
    chrome trace, which is written to ``path``."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]


def busy_intervals(dev: list, w0: float, w1: float) -> list:
    """The union of the device events' intervals (us), clipped to [w0, w1]."""
    merged = []
    for s, e in sorted((max(float(x["ts"]), w0), min(float(x["ts"]) + float(x["dur"]), w1)) for x in dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize_trace(events: list, span: str, frames: int) -> dict:
    """The device profile of one pass from a torch.profiler trace with host
    ops: the window is the host span ``span`` (the first push_frame to the
    final synchronize). Busy share: the union of kernel, memcpy and memset
    intervals over the window; launches per frame; the device operations
    (kernels grouped by the host op that launched them, found through the
    launch's correlation id) by total time; the longest idle gaps, each with
    the host spans open at its middle on every thread."""
    win = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == span]
    if len(win) != 1:
        raise AssertionError(f"the trace holds {len(win)} '{span}' spans")
    w0, w1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    caller = win[0]["tid"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and w0 <= float(e["ts"]) < w1]
    if not dev:
        raise AssertionError(f"the profile holds no device event in the pass ({(w1 - w0) / 1e3:.1f} ms)")
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")]
    by_tid: dict = {}
    for e in host:
        by_tid.setdefault(e["tid"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    # the host op that launched each kernel: the innermost cpu_op around its runtime call
    launch_at: dict = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launch_at.setdefault(e["tid"], []).append((float(e["ts"]), e["args"]["correlation"]))
    op_of: dict = {}
    for tid, points in launch_at.items():
        ops = [sp for sp in by_tid.get(tid, []) if not sp[2].startswith(("cuda", "cu"))]
        op_of.update(innermost_spans(ops, points))
    groups: dict = {}
    by_op: dict = {}  # device ms by the host op that launched it (a graph's kernels: its stage's span)
    ours: dict = {}  # the port's own kernels by the op that launched them: [ms, count]
    for e in dev:
        if e["cat"] == "kernel":
            op = op_of.get(e.get("args", {}).get("correlation"), "(launch not traced)")
            name = short_kernel(e["name"])
            key = f"{op} | {name}"
            by_op[op] = by_op.get(op, 0.0) + float(e["dur"]) / 1e3
            if name.split("::")[-1] in OUR_KERNELS:
                o = ours.setdefault(f"{OUR_KERNELS[name.split('::')[-1]]} in {op}", [0.0, 0])
                o[0] += float(e["dur"]) / 1e3
                o[1] += 1
        else:
            key = e["name"]
        g = groups.setdefault(key, [0.0, 0])
        g[0] += float(e["dur"])
        g[1] += 1
    total = sum(g[0] for g in groups.values())
    top = sorted(groups.items(), key=lambda kv: -kv[1][0])[:10]
    by_stage: dict = {}  # each stage's five longest device operations
    for key, (us, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        op, _, name = key.partition(" | ")
        if name and op in STAGES and len(by_stage.setdefault(op, [])) < 5:
            by_stage[op].append(dict(op=name, ms=round(us / 1e3, 3), count=count))
    # busy intervals and idle gaps inside the window
    merged = busy_intervals(dev, w0, w1)
    busy = sum(e - s for s, e in merged)
    edges = [w0] + [v for se in merged for v in se] + [w1]
    all_gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)]
    gaps = sorted(all_gaps, reverse=True)[:5]
    # idle time by the pipeline stages open on the worker threads (the
    # stages of one thread do not overlap)
    stages = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["tid"] != caller:
            stages.setdefault(e["tid"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    for spans in stages.values():
        spans.sort()
    starts = {tid: [sp[0] for sp in spans] for tid, spans in stages.items()}
    idle_by_stage: dict = {}
    for length, start in all_gaps:
        mid, names = start + length / 2, []
        for tid, spans in stages.items():
            i = bisect.bisect_right(starts[tid], mid) - 1
            if i >= 0 and spans[i][1] >= mid:
                names.append(spans[i][2])
        key = "+".join(sorted(names)) or "(no stage open)"
        idle_by_stage[key] = idle_by_stage.get(key, 0.0) + length / 1e3
    gap_rows = []
    for spans in by_tid.values():
        spans.sort()
    for length, start in gaps:
        mid = start + length / 2
        open_spans = {}
        for tid, spans in by_tid.items():
            chain = [n for s, e, n in spans if s <= mid <= e]
            if chain:
                open_spans["caller" if tid == caller else f"thread {tid}"] = " > ".join(chain[-3:])
        gap_rows.append(dict(ms=length / 1e3, at_ms=(start - w0) / 1e3, host=open_spans))
    kernels = sum(1 for e in dev if e["cat"] == "kernel")
    calls = launch_calls(events, w0, w1)
    return dict(
        window_ms=(w1 - w0) / 1e3, busy_share=busy / (w1 - w0), device_ms=total / 1e3, kernels=kernels,
        launches_per_frame=kernels / frames, memcpy_memset=len(dev) - kernels,
        host_launch_calls=calls, host_launch_calls_per_frame=sum(calls.values()) / frames,
        top=[dict(op=k, ms=v[0] / 1e3, count=v[1], share=v[0] / total) for k, v in top], gaps=gap_rows,
        threads=len(by_tid), idle_by_stage=dict(sorted(idle_by_stage.items(), key=lambda kv: -kv[1])),
        device_ms_by_op=dict(sorted(((k, round(v, 3)) for k, v in by_op.items()), key=lambda kv: -kv[1])[:10]),
        our_kernels={k: dict(ms=round(v[0], 3), count=v[1]) for k, v in ours.items()}, top_by_stage=by_stage,
    )


def device_only_trace(torch, fn, frames: int, name: str = "device_only") -> dict:
    """``fn()`` with the device's activity alone traced (no host op is
    recorded, so the host runs near its unprofiled rate). Busy share: the
    union of kernel, memcpy and memset intervals over the host's seconds
    from the start of ``fn`` to the synchronize after it, inside which
    every device event of the trace lies; the longest idle gaps between
    device events; device kernels and host launch calls per frame."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    with prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    path = os.path.join(OUT_DIR, f"{name}_trace.json")
    events = trace_events(prof, path)
    dev_events = [e for e in events if e.get("cat") in DEVICE_CATS]
    calls = launch_calls(events, float("-inf"), float("inf"))
    os.remove(path)
    if not dev_events:
        raise AssertionError("the device-only trace holds no device event")
    merged = busy_intervals(dev_events, float("-inf"), float("inf"))
    busy_us = sum(e - s for s, e in merged)
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1] - merged[0][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:5]
    kernels = sum(1 for e in dev_events if e["cat"] == "kernel")
    return dict(window_ms=secs * 1e3, fps=frames / secs, busy_share=busy_us / (secs * 1e6),
                device_span_ms=(merged[-1][1] - merged[0][0]) / 1e3, kernels=kernels,
                launches_per_frame=kernels / frames, gaps=[dict(ms=g / 1e3, at_ms=t / 1e3) for g, t in gaps],
                host_launch_calls=calls, host_launch_calls_per_frame=sum(calls.values()) / frames)


def device_busy(torch, seq, cfg, dev) -> dict:
    """One warm flagship pass of ``bench.run_pass`` with the device's
    activity alone traced (``device_only_trace`` over the pushes and the
    flush); K1 and K2 launches, counted over this pass alone."""
    from bundlefusion_tpu_torch import bench

    got = {}

    def traced(bf, steady):
        got.update(device_only_trace(torch, steady, len(seq.poses), "bench_profile_cuda"))

    reset_launches()
    bf, _ = bench.run_pass(seq, cfg, dev, wrap=traced)
    got.update(launches=read_launches(), chunks=bf.chunk_count)
    del bf
    return got


def device_profile(torch, seq, cfg, dev) -> dict:
    """One warm flagship pass of ``bench.run_pass`` under torch.profiler (CPU
    and CUDA activities, host ops of every thread: the chunk step runs on
    the dispatch worker), summarized by ``summarize_trace``; the gzipped
    chrome trace goes to ``chiprun_out/``."""
    from bundlefusion_tpu_torch import bench

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=acts, experimental_config=every_thread) as prof:
        bf, dt = bench.run_pass(seq, cfg, dev)
    del bf
    path = os.path.join(OUT_DIR, "bench_profile.json")
    t0 = time.perf_counter()
    summary = summarize_trace(trace_events(prof, path), bench.PASS_SPAN, len(seq.poses))
    with open(path, "rb") as f_in, gzip.open(path + ".gz", "wb", compresslevel=1) as f_out:
        shutil.copyfileobj(f_in, f_out)
    summary.update(fps=len(seq.poses) / dt, trace_mib=os.path.getsize(path) / 2**20,
                   kept=keep_or_drop(path + ".gz"), read_s=time.perf_counter() - t0)
    os.remove(path)
    return summary


def run_bench(torch, T, dev, kernels_out, seq) -> None:
    """Phase 14: in this process, after an untraced warm pass (it captures
    the chunk step's graphs), two flagship passes of the bench's
    ``run_pass``: one with the device's activity alone traced (the busy
    share near the unprofiled rate, and one K1 and one K2 launch per
    chunk), one under the full profiler (launches per frame, the top device
    operations, the idle gaps and the host at each; device time by stage
    and the port's kernels by stage). Then the port's bench, ``python -m
    bundlefusion_tpu_torch.bench``, at bench.py's two sizes in
    subprocesses."""
    from bundlefusion_tpu_torch import bench
    from bundlefusion_tpu_torch.bundle import pipeline as pipe

    smi = bench.device_line(dev)
    cfg = bench.bench_config(*FULL, 262144)
    os.makedirs(OUT_DIR, exist_ok=True)
    # a warm pass first: it captures the chunk step's graphs (the phase
    # starts without idle executables) and warms the allocator's cache, so
    # the traced passes replay and make no cudaMalloc
    bf, _ = bench.run_pass(seq, cfg, dev)
    del bf
    busy = device_busy(torch, seq, cfg, dev)
    one_launch_per_chunk(kernels_out, "bench", busy["launches"], busy["chunks"])
    full = device_profile(torch, seq, cfg, dev)
    phase("bench", f"device-only trace ({smi}): a warm flagship pass, {busy['fps']:.3f} fps; busy "
          f"{busy['busy_share'] * 100:.1f}% of {busy['window_ms']:.1f} ms (union of kernels, memcpy, memset; first "
          f"to last device event {busy['device_span_ms']:.1f} ms); {busy['kernels']} kernels, "
          f"{busy['launches_per_frame']:.1f} per frame; launches {busy['launches']} over {busy['chunks']} chunks; "
          f"host launch calls {busy['host_launch_calls']} ({busy['host_launch_calls_per_frame']:.1f} per frame)")
    for i, g in enumerate(busy["gaps"]):
        phase("bench", f"  device-only idle gap {i + 1}: {g['ms']:.3f} ms at +{g['at_ms']:.1f} ms after the first "
              "device event")
    phase("bench", f"full profile ({smi}; host ops of every thread): a warm flagship pass, {full['fps']:.3f} fps "
          f"under the profiler; trace {full['trace_mib']:.1f} MiB, gzipped to {full['kept']}, read in "
          f"{full['read_s']:.1f} s")
    phase("bench", f"full profile: window {full['window_ms']:.1f} ms, busy {full['busy_share'] * 100:.1f}% (union of "
          f"kernels, memcpy, memset); {full['kernels']} kernels, {full['launches_per_frame']:.1f} per frame; "
          f"{full['memcpy_memset']} memcpy/memset; device time {full['device_ms']:.1f} ms; {full['threads']} host "
          f"threads traced; host launch calls {full['host_launch_calls']}, "
          f"{full['host_launch_calls_per_frame']:.1f} per frame")
    for i, row in enumerate(full["top"]):
        phase("bench", f"  top {i + 1}: {row['ms']:9.2f} ms {row['share'] * 100:5.1f}% x{row['count']:<6} {row['op']}")
    for i, g in enumerate(full["gaps"]):
        phase("bench", f"  idle gap {i + 1}: {g['ms']:.3f} ms at +{g['at_ms']:.1f} ms; host: {json.dumps(g['host'])}")
    idle = {k: round(v, 2) for k, v in full["idle_by_stage"].items()}
    phase("bench", f"  idle ms by the stage open on the worker threads: {json.dumps(idle)}")
    phase("bench", f"  device ms by the host op that launched the kernels (a graph's: its stage): "
          f"{json.dumps(full['device_ms_by_op'])}; the port's kernels (ms, count): {json.dumps(full['our_kernels'])}")
    for stage, rows in full["top_by_stage"].items():
        phase("bench", f"  {stage}'s longest device operations: {json.dumps(rows)}")

    pipe._EXECUTABLES.clear()  # the card's memory is the subprocesses'
    torch.cuda.empty_cache()
    runs = {name: bench_subprocess(name, env, smi) for name, env in BENCH_RUNS}
    fps = runs["flagship"]["result"]["value"]
    phase("bench", f"the bench's flagship median {fps} fps unprofiled against {busy['fps']:.3f} with the "
          f"device-only trace and {full['fps']:.3f} under the full profiler")
    runs.update(busy=busy, profile=full)
    with open(os.path.join(OUT_DIR, "bench_runs.json"), "w") as f:
        json.dump(runs, f, indent=1)


STAGES = ("chunk_local", "graph_step", "global_solve", "publish", "plan_fuse")
GRAPH_ORDER = ("eager", "graphed", "graphed", "eager", "eager", "graphed")  # the timed passes, interleaved


def graph_pass(torch, seq, cfg, dev, mode: str, watch: bool = False) -> dict:
    """One flagship pass of ``bench.run_pass`` with the chunk step graphed
    (the default) or eager (``graphs.disable_graphs()``): fps, launches,
    peak memory, the programs' graphs and replays, the state's digests
    before finalize, poses, validity, stage means; with ``watch`` the
    readbacks of the pushes and the flush."""
    from bundlefusion_tpu_torch import bench
    from bundlefusion_tpu_torch.utils import graphs

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    sites: dict = {}
    wrap = (lambda steady: sites.update(r=sync_sites(torch, steady))) if watch else None
    with graphs.disable_graphs() if mode == "eager" else contextlib.nullcontext():
        bf, dt = run_pass(seq, cfg, dev, wrap=wrap)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    digests = state_digests(torch, bf)
    out = bf.outputs()
    rec = dict(mode=mode, fps=len(seq.poses) / dt, launches=launches, chunks=bf.chunk_count, peak_gib=peak,
               stats=bf.graph_stats, digests=digests, poses=out.poses, valid=out.valid, ate=bench.ate_of(out, seq),
               syncs=sites.get("r"), valid_chunks=[r["chunk_valid"] for r in bf.runlog.records if "chunk" in r],
               means={k: v["mean_ms"] for k, v in bf.timing.summary().items()})
    del bf, out
    return rec


def program_outputs_survive(torch, graphs, dev) -> dict:
    """Two programs of one executable (``graphs`` is a ``utils/graphs.py``
    module): ``first``, captured first, keeps a temporary of 2^20 floats
    that its capture frees into the shared pool; ``second``, captured after
    it, returns 2^20 floats. Replay ``second``, then ``first``, then read
    ``second``'s outputs: they must still hold its values. (Where a graph's
    outputs live in the pool, ``second``'s take the freed temporary's
    storage and ``first``'s replay overwrites them.)"""
    exe = graphs.Executable(dev, None)
    n = 1 << 20
    with torch.cuda.stream(exe.stream):
        x = torch.zeros(n, device=dev)
        sink = torch.zeros(1, device=dev)

        def first(x, sink):
            sink.copy_((x + 7.0)[:1])

        first_p, second_p = exe.program("first", first), exe.program("second", lambda x: x + 5.0)
        first_p(x, sink)
        out = second_p(x)
        second_p(x)
        first_p(x, sink)
    torch.cuda.synchronize()
    return dict(survived=bool(torch.all(out == 5.0)), replays=second_p.replays + first_p.replays,
                in_pool_values=sorted(set(out[:: n // 8].tolist())))


TIER_CHUNKS = 70  # phase 15's tier scan: chunks 1-63 at the graph step's 64-slot tier, 64-69 at 128


def tier_scan(torch, seq, cfg, dev, mode: str) -> dict:
    """One pass of a fresh pipeline over ``seq``, long enough that the
    graph step crosses a slot tier, with the chunk step graphed (the
    default) or eager (``graphs.disable_graphs()``): which graph-step tiers
    had a graph once chunk 1, the first steady chunk, was dispatched
    (``ready``); per chunk, the tier its graph step ran over (``slots``,
    the timeline's ``graph_slots``) and that stage's device ms; the
    programs' stats, the state's digests before finalize, poses and
    validity."""
    from bundlefusion_tpu_torch.bundle.pipeline import BundleFusion
    from bundlefusion_tpu_torch.utils import graphs

    with graphs.disable_graphs() if mode == "eager" else contextlib.nullcontext():
        bf = BundleFusion(seq.camera, cfg, anchor_pose=seq.poses[0], device=dev)
    ready = None
    for i in range(len(seq.poses)):
        bf.push_frame(seq.depth[i], seq.color[i])
        if i == 2 * cfg.bundling.submap_size:  # chunk 1's last frame
            bf.sync()
            ready = {n: p.graph is not None for n, p in bf._exe.programs.items() if n.startswith("graph_step@")}
    bf.flush()
    digests = state_digests(torch, bf)
    out = bf.outputs()
    same = tier_against_capacity(torch, bf) if mode == "graphed" else None
    recs = [r["timeline"] for r in bf.runlog.records if "timeline" in r]
    rec = dict(mode=mode, ready=ready, slots=[t["graph_slots"] for t in recs],
               graph_step_ms=[(t["device"]["graph_step"][1] - t["device"]["graph_step"][0]) * 1e3 for t in recs],
               stats=bf.graph_stats, digests=digests, poses=out.poses, valid=out.valid, tier_vs_capacity=same,
               valid_chunks=[r["chunk_valid"] for r in bf.runlog.records if "chunk_valid" in r])
    del bf, out
    return rec


def tier_against_capacity(torch, bf) -> dict:
    """A keyframe of ``bf``'s graph within the first tier (the last one
    there) matched again, eagerly, on two copies of the graph, over its
    chunk's slot tier and over every slot: which per-slot results (on the
    tier's slots) and which tensors of the graph after the append are
    bit-equal, the largest transform difference, and the keyframe's
    links."""
    from bundlefusion_tpu_torch.bundle import global_graph as gg

    bc, k = bf.config.bundling, min(bf.chunk_count, gg.GRAPH_TIER_MIN) - 1
    tier = gg.graph_tier(k, bc.max_num_images)
    runs = []
    for slots in (tier, None):
        g = copy.deepcopy(bf.state.graph)
        r = gg.global_match(g, torch.full((), k, dtype=torch.int32, device=bf.device), bf.cache_cam, bc, slots=slots)
        runs.append((r, fusion_digests(torch, {"graph": g})))
    (a, ga), (b, gb) = runs
    equal = {f: bool(torch.equal(getattr(a, f), getattr(b, f)[:tier]))
             for f in ("pair_valid", "inlier_counts", "transforms")}
    equal.update(best_prev=bool(torch.equal(a.best_prev, b.best_prev)), graph=ga == gb)
    return dict(chunk=k, tier=tier, links=int(a.pair_valid.sum()), equal=equal,
                transform_max_diff=float((a.transforms - b.transforms[:tier]).abs().max()))


def check_tier_scan(graphed: dict, eager: dict, cfg, chunks: int) -> dict:
    """``tier_scan``'s graphed pass on a fresh executable against its eager
    pass: every tier of the ladder captured once chunk 1 was dispatched,
    each tier replayed at every chunk that uses it but the first tier's
    first (its eager run), the timeline's ``graph_slots`` the ladder's
    tiers, state digests, poses and validity bit-equal; a keyframe matched
    over its tier and over every slot gives the same links, counts, best
    match and graph, and transforms within 1e-6 (``tier_against_capacity``).
    Returns the tiers' capture seconds and graph_step device ms (median) by
    tier."""
    from bundlefusion_tpu_torch import bench
    from bundlefusion_tpu_torch.bundle import global_graph, pipeline as pipe

    cap = cfg.bundling.max_num_images
    tiers = [f"graph_step@{t}" for t in global_graph.graph_tiers(cap)]
    want_slots = [pipe.graph_step_program(c, cap)[1] for c in range(chunks)]
    uses = {k: n for k, n in bench.expected_replays(chunks, cfg).items() if k in tiers}
    first = pipe.graph_step_program(1, cap)[0]
    stats = graphed["stats"]
    if graphed["ready"] != dict.fromkeys(tiers, True) or not all(stats.get(k, {}).get("captured") for k in tiers):
        raise AssertionError(f"tiers not all captured at the first steady chunk: {graphed['ready']}, {stats}")
    replays = {k: stats[k]["replays"] for k in tiers}
    if replays != {k: n - (k == first) for k, n in uses.items()}:
        raise AssertionError(f"tier replays {replays} against uses {uses}: a tier captured at its first use")
    for p in (graphed, eager):
        if p["slots"] != want_slots:
            raise AssertionError(f"{p['mode']}: graph_slots {p['slots']} against {want_slots}")
    diff = sorted(k for k in graphed["digests"] if graphed["digests"][k] != eager["digests"].get(k))
    if diff or not np.array_equal(graphed["poses"], eager["poses"]) or not np.array_equal(graphed["valid"],
                                                                                          eager["valid"]):
        raise AssertionError(f"the tier scan's graphed and eager passes differ: {diff[:8]}")
    same = graphed["tier_vs_capacity"]
    if not all(v for k, v in same["equal"].items() if k != "transforms") or same["transform_max_diff"] > 1e-6:
        raise AssertionError(f"a keyframe matched over its tier and over every slot differs: {same}")
    ms = {}
    for p in (graphed, eager):
        for t, x in zip(p["slots"][1:], p["graph_step_ms"][1:]):
            ms.setdefault(p["mode"], {}).setdefault(t, []).append(x)
    return dict(capture_s={k: round(stats[k]["capture_s"], 4) for k in tiers}, replays=replays,
                tier_vs_capacity=graphed["tier_vs_capacity"],
                graph_step_ms={m: {t: round(statistics.median(v), 4) for t, v in d.items()} for m, d in ms.items()},
                chunks_valid=sum(map(bool, graphed["valid_chunks"])))


def run_graphs(torch, T, dev, kernels_out, seq, cfg) -> None:
    """Phase 15: the chunk step as captured CUDA graphs (``utils/graphs.py``)
    against the eager step (``graphs.disable_graphs()``) on the flagship 66
    frames. A graphed pass on a fresh executable (each program captured at
    its first call, chunk 0's stages at chunk 0; its readbacks counted), an
    eager warm pass, then interleaved timed passes (E G G E E G) on the
    reused executable, then a graphed pass under the sync counter, a scan
    of ``TIER_CHUNKS`` chunks that crosses the graph step's first slot tier
    graphed and eager (``tier_scan``, ``check_tier_scan``), and one
    device-only trace each way. Every pass's state digests and poses equal;
    a graphed pass on a reused executable replays every program at every
    chunk it runs, chunk 0 included (``bench.expected_replays``), and
    captures nothing; one K1 and one K2 launch per chunk, counted through
    replays; 0 readbacks; ATE <= 0.5 cm, every chunk valid."""
    from bundlefusion_tpu_torch import bench
    from bundlefusion_tpu_torch.bundle import pipeline as pipe
    from bundlefusion_tpu_torch.utils import graphs

    smi = bench.device_line(dev)
    pipe._EXECUTABLES.clear()  # a fresh executable: this phase's first pass captures
    torch.cuda.empty_cache()
    first = graph_pass(torch, seq, cfg, dev, "graphed", watch=True)
    passes = [first, graph_pass(torch, seq, cfg, dev, "eager")]
    timed = [graph_pass(torch, seq, cfg, dev, mode) for mode in GRAPH_ORDER]
    watched = graph_pass(torch, seq, cfg, dev, "graphed", watch=True)
    passes += timed + [watched]
    chunks = first["chunks"]
    capture = {k: v["capture_s"] for k, v in first["stats"].items()}
    phase("graphs", f"flagship {FULL[0]}x{FULL[1]}, {len(seq.poses)} frames, {chunks} chunks ({smi}): first graphed "
          f"pass on a fresh executable {first['fps']:.3f} fps, capture s by stage {json.dumps(capture)} "
          f"({sum(capture.values()):.3f} s in all), its readbacks {len(first['syncs'])} {by_site(first['syncs'])}")
    for mode in ("graphed", "eager"):
        fps = [p["fps"] for p in timed if p["mode"] == mode]
        means = {k: round(statistics.mean(p["means"][k] for p in timed if p["mode"] == mode), 3)
                 for k in STAGES + ("whole_chunk_step",)}
        peak = max(p["peak_gib"] for p in timed if p["mode"] == mode)
        phase("graphs", f"{mode}: timed fps {[round(x, 3) for x in fps]} (interleaved {'/'.join(GRAPH_ORDER)}), "
              f"median {statistics.median(fps):.3f}; stage means (ms, device stamps; whole_chunk_step host clock) "
              f"{json.dumps(means)}; peak memory {peak:.3f} GiB")
    replays = {k: v["replays"] for k, v in watched["stats"].items()}
    phase("graphs", f"graphed pass on the reused executable: replays {replays} over {chunks} chunks, chunk 0's "
          f"included; launches {watched['launches']}; readbacks {len(watched['syncs'])}; ATE "
          f"{watched['ate'] * 100:.4f} cm")
    ref = first
    for p in passes:
        diff = sorted(k for k in ref["digests"] if ref["digests"][k] != p["digests"].get(k))
        if diff or not np.array_equal(ref["poses"], p["poses"]) or not np.array_equal(ref["valid"], p["valid"]):
            raise AssertionError(f"a {p['mode']} pass differs from the first graphed pass: {diff[:8]}")
        check_launches(p["launches"], expected_launches(cfg, chunks), f"{p['mode']} pass")
        if p["chunks"] != chunks or not all(p["valid_chunks"]) or not p["ate"] <= 0.005:
            raise AssertionError(f"{p['mode']}: chunks valid {p['valid_chunks']}, ATE {p['ate'] * 100:.4f} cm")
    phase("graphs", f"{len(passes)} passes ({sum(p['mode'] == 'graphed' for p in passes)} graphed): state digests "
          f"({len(ref['digests'])} fields), poses and validity bit-equal; one K1 and one K2 launch per chunk in "
          "each, K3, K4 and K5 as the solves, SIFT octaves and verifications count them")
    want = {k: n for k, n in bench.expected_replays(chunks, cfg).items() if n}
    # the graph step's tiers the pass does not reach are captured at chunk 1 and never replayed
    first_replays = {k: v["replays"] for k, v in first["stats"].items() if v["replays"] or k in want}
    if first_replays != {k: n - 1 for k, n in want.items()} or not all(v["captured"] for v in first["stats"].values()):
        raise AssertionError(f"the first pass did not capture every program at its first call and replay it at "
                             f"every later one: {first['stats']}")
    for p in passes[1:]:
        if p["mode"] == "graphed" and ({k: v["replays"] for k, v in p["stats"].items() if v["replays"]} != want
                                       or any(v["captured"] for v in p["stats"].values())):
            raise AssertionError(f"a graphed pass on the reused executable does not replay every program at every "
                                 f"chunk: {p['stats']}")
        if p["mode"] == "eager" and {v["route"] for v in p["stats"].values()} != {"eager: disable_graphs()"}:
            raise AssertionError(f"an eager pass's routes: {p['stats']}")
    if watched["syncs"]:
        raise AssertionError(f"readbacks in the graphed steady state: {by_site(watched['syncs'])}")
    record_launches(kernels_out, "graphs", watched["launches"])

    # a scan that crosses the graph step's first slot tier: each tier is a
    # program captured at the first steady chunk, graphed and eager equal
    from bundlefusion_tpu_torch.io.synthetic import generate_sequence

    tseq = generate_sequence(TIER_CHUNKS * cfg.bundling.submap_size + 1, *FULL, radius=0.5, device=dev)
    pipe._EXECUTABLES.clear()
    torch.cuda.empty_cache()
    tg = tier_scan(torch, tseq, cfg, dev, "graphed")
    te = tier_scan(torch, tseq, cfg, dev, "eager")
    del tseq
    tiers = check_tier_scan(tg, te, cfg, TIER_CHUNKS)
    phase("graphs", f"tier scan, {TIER_CHUNKS} chunks ({smi}): every tier of the graph step captured at chunk 1 "
          f"(capture s {json.dumps(tiers['capture_s'])}), replays {json.dumps(tiers['replays'])}, graph_slots the "
          f"ladder's, graphed and eager state, poses and validity bit-equal; {tiers['chunks_valid']} chunks valid; "
          f"graph_step device ms by tier (median) {json.dumps(tiers['graph_step_ms'])}; the last keyframe matched "
          f"over its tier and over every slot: {json.dumps(tiers['tier_vs_capacity'])}")

    alias = program_outputs_survive(torch, graphs, dev)
    phase("graphs", f"a program's outputs after another program captured before it replays: {alias}")
    if not alias["survived"] or alias["replays"] != 2:
        raise AssertionError(f"a program's outputs were overwritten by another program's replay: {alias}")

    # the device-only trace each way (phase 14's, on this phase's executable)
    busy = {"graphed": device_busy(torch, seq, cfg, dev)}
    with graphs.disable_graphs():
        busy["eager"] = device_busy(torch, seq, cfg, dev)
    for mode, b in busy.items():
        phase("graphs", f"device-only trace, {mode}: {b['fps']:.3f} fps; busy {b['busy_share'] * 100:.1f}% of "
              f"{b['window_ms']:.1f} ms; device kernels {b['kernels'] / len(seq.poses):.1f} per frame; host launch "
              f"calls {b['host_launch_calls_per_frame']:.1f} per frame {b['host_launch_calls']}")
    with open(os.path.join(OUT_DIR, "graphs_phase.json"), "w") as f:
        json.dump(dict(device=smi, chunks=chunks, capture_s=capture, busy=busy, tiers=tiers,
                       passes=[{k: p[k] for k in ("mode", "fps", "peak_gib", "means", "stats", "launches")}
                               for p in passes]), f, indent=1)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only on a card", file=sys.stderr)
        return 1
    import bundlefusion_tpu_torch as T
    from bundlefusion_tpu_torch import bench, kernels
    from bundlefusion_tpu_torch.bundle import pipeline as pipe
    from bundlefusion_tpu_torch.parallel import spmd_pipeline as spmd

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = bench.device_line(dev)
    phase("device", f"{name}; nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    secs = kernels.build()
    kernels.library()
    phase("build", f"nvcc build {secs:.2f} s -> {kernels.LIB_PATH}")

    def timed(name, fn, *args):
        # each phase starts without the idle executables (graphs and state)
        # of the phases before it, but for phase 5, which replays phase 4's
        if name != "syncs":
            pipe._EXECUTABLES.clear()
            spmd._EXECUTABLES.clear()
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = fn(*args)
        gc.collect()
        phase(name, f"phase {time.perf_counter() - t0:.1f} s; card memory after it: allocated "
              f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB, reserved {torch.cuda.memory_reserved() / 2**30:.3f} "
              f"GiB, {len(pipe._EXECUTABLES._free)} + {len(spmd._EXECUTABLES._free)} idle executables (serial + "
              f"shards)")
        return out

    kern = timed("kernels", check_kernels, torch, T, dev)
    seq, cfg, ref = timed("slice", run_slice, torch, T, dev, kern)
    timed("syncs", count_syncs, torch, T, seq, cfg, dev)
    timed("stream", run_stream, torch, T, dev, kern)
    timed("reloc", run_reloc, torch, T, dev, kern)
    timed("app", run_app, torch, T, dev, kern)
    timed("multiseq", run_multiseq, torch, T, dev, kern, ref)
    timed("sharded", run_sharded, torch, T, dev, kern, seq, cfg, ref)
    timed("configs", run_configs, torch, T, dev, kern, seq, ref)
    timed("ingest", run_ingest, torch, T, dev, kern, seq, cfg, ref)
    timed("paths", run_paths, torch, T, dev, kern, seq, cfg, ref)
    timed("bench", run_bench, torch, T, dev, kern, seq)
    timed("graphs", run_graphs, torch, T, dev, kern, seq, cfg)
    timed("denseref", run_dense_reference, torch, T, dev)

    print(smi)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
