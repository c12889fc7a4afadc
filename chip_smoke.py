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
                frames integrated), K2 over a chunk's 11 frames with and
                without the point and normal maps.
  4. slice    — the flagship configuration of ``bench.py`` (640x480, 262,144
                blocks, 1 cm voxels) on 66 rendered frames through
                push_frame -> flush -> outputs: a warm pass, then a timed
                pass; every chunk valid, ATE <= 0.5 cm, both kernels launched.
                Then a small configuration (128x96, 13 frames) run on the CPU
                (twins) and twice on the card (kernels): CPU and card agree,
                and the card runs are bit-identical.
  5. syncs    — host syncs in the steady state, counted under
                ``torch.cuda.set_sync_debug_mode("warn")``: there must be
                none (a deliberate sync first shows that the count works).

The last two lines are a JSON object of the kernels' checks and timings and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

FLAGSHIP_FRAMES = 66
SMALL = dict(width=128, height=96, frames=13)

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


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


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


def flagship_config(T):
    """bench.py's flagship configuration (the reference's 512^3-equivalent volume)."""
    return T.Config(
        app=T.AppConfig(
            input_width=640, input_height=480, integration_width=640, integration_height=480,
            voxel_size=0.01, truncation=0.04, block_capacity=262144, blocks_per_frame_cap=4096,
            raycast_width=320, raycast_height=240,
        ),
        bundling=T.BundlingConfig(
            submap_size=10, max_num_images=128, max_keys_per_image=512, sift_octaves=3,
            cache_width=80, cache_height=60, verify_width=80, verify_height=60,
            verify_ok_fraction=0.45, verify_color_thresh=0.08,
        ),
    )


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


def kernel_entry(name, source, replaces, err, ms, plain_ms, bound_ms, bound_by, **extra):
    return dict(name=name, route="cuda", source=source, replaces=replaces, launches=0, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                share_of_bound=bound_ms / ms, **extra)


def check_k1(torch, T, dev, depth, c8, poses, cam):
    """K1 over one flagship chunk's fuse, as plan_fuse builds it: the batch
    holds 11 new frames, then 10 frames integrated earlier; those 10 are
    de-integrated at their poses, then all 21 are integrated, the 10 at
    moved poses (R = 31 rows)."""
    from bundlefusion_tpu_torch.fusion import blocks, tsdf

    ac = flagship_config(T).app
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
    phase("kernels", f"K1 tsdf_fuse: R={r} rows, union {live} live blocks of {union.shape[0]} entries, "
          f"{applied} applied (row, block) pairs; weights bit-equal, max |sdf/colour err| {err:.3g}, "
          f"integrate+deintegrate exact; kernel {ms:.4f} ms, with its work list and checks "
          f"{wrapper_ms:.4f} ms, twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"share {bound_ms / ms:.3f}")
    return kernel_entry(
        "tsdf_integrate", "bundlefusion_tpu_torch/csrc/tsdf_integrate.cu",
        "bundlefusion_tpu/fusion/pallas_tsdf.py:84", err, ms, plain_ms, bound_ms, bound_by,
        rows=r, union_live=live, applied_pairs=applied, wrapper_ms=wrapper_ms,
    )


def check_k2(torch, T, dev, depth, cam):
    """K2 over a chunk's 11 frames, without geometry (the main path) and with."""
    from bundlefusion_tpu_torch.ops import preprocess as pp

    ac = flagship_config(T).app
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


def check_kernels(torch, T, dev):
    """Phase 3: K1 and K2 against their twins at flagship shapes."""
    from bundlefusion_tpu_torch.io.synthetic import generate_sequence
    from bundlefusion_tpu_torch.ops import preprocess as pp

    ac = flagship_config(T).app
    seq = generate_sequence(21, 640, 480, radius=0.5, device=dev)
    wires = [wire(seq, i, ac) for i in range(21)]
    d16 = torch.as_tensor(np.stack([w[0] for w in wires]).view(np.int16), device=dev)
    depth = pp.wire_depth_to_m(d16)
    c8 = torch.as_tensor(np.stack([w[2] for w in wires]), device=dev)
    poses = torch.as_tensor(seq.poses, device=dev)
    k1 = check_k1(torch, T, dev, depth, c8, poses, seq.camera)
    torch.cuda.empty_cache()
    k2 = check_k2(torch, T, dev, depth[:11].contiguous(), seq.camera)
    return [k1, k2]


def run_pass(T, seq, cfg, dev):
    """push_frame -> flush over a whole sequence; returns (pipeline, seconds)."""
    import torch

    from bundlefusion_tpu_torch.bundle.pipeline import BundleFusion

    bf = BundleFusion(seq.camera, cfg, anchor_pose=seq.poses[0], device=dev)
    if bf.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(len(seq.poses)):
        bf.push_frame(seq.depth[i], seq.color[i])
    bf.flush()
    if bf.device.type == "cuda":
        torch.cuda.synchronize()
    return bf, time.perf_counter() - t0


def run_slice(torch, T, dev, kernels_out):
    """Phase 4: the flagship slice, then the small CPU-vs-card and
    determinism checks. Returns the flagship sequence and configuration."""
    from bundlefusion_tpu_torch.eval.ate import ate_rmse
    from bundlefusion_tpu_torch.fusion.tsdf import integrate_blocks
    from bundlefusion_tpu_torch.io.synthetic import generate_sequence
    from bundlefusion_tpu_torch.ops.preprocess import fused_preprocess

    cfg = flagship_config(T)
    seq = generate_sequence(FLAGSHIP_FRAMES, 640, 480, radius=0.5, device=dev)
    bf, dt_warm = run_pass(T, seq, cfg, dev)
    del bf
    phase("slice", f"warm pass {dt_warm:.2f} s")

    integrate_blocks.launches = 0
    fused_preprocess.launches = 0
    torch.cuda.reset_peak_memory_stats()
    bf, dt = run_pass(T, seq, cfg, dev)
    out = bf.outputs()
    torch.cuda.synchronize()
    launches = {"tsdf_integrate": integrate_blocks.launches, "preprocess": fused_preprocess.launches}
    for k in kernels_out:
        k["launches"] = launches[k["name"]]
    n = min(len(out.poses), len(seq.poses))
    ate = ate_rmse(out.poses[:n], seq.poses[:n], valid=out.valid[:n])
    recs = [r for r in bf.runlog.records if "chunk" in r]
    phase("slice", f"flagship 640x480, {FLAGSHIP_FRAMES} frames: {FLAGSHIP_FRAMES / dt:.3f} fps "
          f"({dt:.3f} s, push_frame -> flush), ATE {ate * 100:.4f} cm, keyframes {out.num_keyframes}, "
          f"active blocks {int(bf.table.num_active())}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    phase("slice", "stage timing (CUDA events):\n" + bf.timing.report())
    ints = ("num_keys", "filtered_matches", "pairs_valid", "corr_cursor", "alloc_overflow", "upd_truncated",
            "patch_overflow", "reint_frames", "ring_miss", "blocks_touched", "active_blocks", "lost_chunks")
    for r in recs:
        phase("slice", "runlog " + json.dumps({k: r[k] for k in ("chunk", "chunk_valid", "kf_valid") + ints}))
    phase("slice", f"kernel launches in the timed pass: {launches} over {len(recs)} chunks")
    if launches["tsdf_integrate"] != len(recs) or launches["preprocess"] != len(recs):
        raise AssertionError(f"expected one K1 and one K2 launch per chunk: {launches}")
    if not all(r["chunk_valid"] for r in recs):
        raise AssertionError("a flagship chunk was invalid")
    if not ate <= 0.005:
        raise AssertionError(f"flagship ATE {ate * 100:.4f} cm > 0.5 cm")
    if any(r["patch_overflow"] for r in recs):
        raise AssertionError("patch_overflow is not 0")
    del bf

    # small configuration: CPU (twins) vs card (kernels), and card determinism
    scfg = small_config(T)
    sseq = generate_sequence(SMALL["frames"], SMALL["width"], SMALL["height"], device=dev)
    cpu_bf, _ = run_pass(T, sseq, scfg, "cpu")
    cpu_out = cpu_bf.outputs()
    gpu = []
    for _ in range(2):
        b, _ = run_pass(T, sseq, scfg, dev)
        gpu.append((b, b.outputs()))
    (g1, o1), (g2, o2) = gpu

    def masks(b):
        return [(r["chunk_valid"], r["kf_valid"]) for r in b.runlog.records if "chunk" in r]

    if masks(cpu_bf) != masks(g1):
        raise AssertionError(f"chunk/keyframe masks differ: cpu {masks(cpu_bf)} card {masks(g1)}")
    pose_err = float(np.abs(cpu_out.poses - o1.poses).max())
    if pose_err > 1e-4:
        raise AssertionError(f"CPU and card poses differ by {pose_err}")
    if not (np.array_equal(o1.poses, o2.poses) and torch.equal(g1.table.weight, g2.table.weight)):
        raise AssertionError("two card runs are not bit-identical")
    phase("slice", f"small {SMALL['width']}x{SMALL['height']}, {SMALL['frames']} frames: masks equal "
          f"{masks(g1)}, max |pose cpu - card| {pose_err:.3g}; two card runs bit-identical")
    return seq, cfg


def sync_sites(torch, fn) -> list[str]:
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")`` and return
    one line per synchronizing CUDA operation it called: the innermost frame
    of the port's code, then the innermost frame overall. Only PyTorch's
    per-operation warning counts; turning the mode on prints a notice of its
    own, which is not a sync."""
    sites: list[str] = []

    def on_warning(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            stack = traceback.extract_stack()[:-1]
            ours = [f for f in stack if "bundlefusion_tpu_torch" in f.filename] or stack
            sites.append(" <- ".join(f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} ({f.name})" for f in (ours[-1], stack[-1])))

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = on_warning
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sites


def count_syncs(torch, T, seq, cfg, dev) -> None:
    """Phase 5: no host sync during the steady-state pushes of one flagship
    pass; a deliberate ``.item()`` first shows that the count sees syncs."""
    from bundlefusion_tpu_torch.bundle.pipeline import BundleFusion

    control = sync_sites(torch, lambda: torch.ones(1, device=dev).sum().item())
    if len(control) != 1:
        raise AssertionError(f"the sync counter missed a deliberate sync: {control}")
    bf = BundleFusion(seq.camera, cfg, anchor_pose=seq.poses[0], device=dev)
    torch.cuda.synchronize()

    def steady():
        for i in range(len(seq.poses)):
            bf.push_frame(seq.depth[i], seq.color[i])
        bf.flush()

    sites = sync_sites(torch, steady)
    counts = {s: sites.count(s) for s in sorted(set(sites))}
    phase("syncs", f"{len(sites)} host syncs in {FLAGSHIP_FRAMES} steady-state pushes (control: 1 of 1 seen); "
          f"by site {counts}")
    if sites:
        raise AssertionError(f"host syncs in the steady state: {counts}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs only on a card", file=sys.stderr)
        return 1
    import bundlefusion_tpu_torch as T
    from bundlefusion_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    phase("device", f"{name}; nvidia-smi: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    secs = kernels.build()
    kernels.library()
    phase("build", f"nvcc build {secs:.2f} s -> {kernels.LIB_PATH}")

    kern = check_kernels(torch, T, dev)
    seq, cfg = run_slice(torch, T, dev, kern)
    count_syncs(torch, T, seq, cfg, dev)

    print(smi)
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
