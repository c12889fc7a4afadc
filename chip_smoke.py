#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (``bundlefusion_tpu_torch``) once on one
NVIDIA card and check it.

    python3 chip_smoke.py

Phases (each prints its own lines; a failing phase raises and the script
exits non-zero; there is no CPU fallback):

  1. device   — a CUDA device must be present; its name and power limit.
  2. build    — nvcc builds the kernels in ``bundlefusion_tpu_torch/csrc``.
  3. kernels  — each kernel against its plain PyTorch twin on the card at the
                flagship shapes, with CUDA-event timings (median of 20).
  4. slice    — the flagship configuration of ``bench.py`` (640x480, 262,144
                blocks, 1 cm voxels) on 66 rendered frames through
                push_frame -> flush -> outputs: a warm pass, then a timed
                pass; every chunk valid, ATE <= 0.5 cm, both kernels launched.
                Then a small configuration (128x96, 13 frames) run on the CPU
                (twins) and twice on the card (kernels): CPU and card agree,
                and the card runs are bit-identical.
  5. syncs    — host syncs in the steady state, counted under
                ``torch.cuda.set_sync_debug_mode("warn")`` (recorded only).

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


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, n: int = 20) -> float:
    """Median device time of ``fn`` over ``n`` launches (CUDA events)."""
    fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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


def check_kernels(torch, T, dev):
    """Phase 3: K1 and K2 against their twins at flagship shapes."""
    from bundlefusion_tpu_torch.fusion import blocks, tsdf
    from bundlefusion_tpu_torch.io.synthetic import generate_sequence
    from bundlefusion_tpu_torch.ops import preprocess as pp

    cfg = flagship_config(T)
    ac = cfg.app
    seq = generate_sequence(11, 640, 480, radius=0.5, device=dev)
    cam = seq.camera
    wires = [wire(seq, i, ac) for i in range(11)]
    d16 = torch.as_tensor(np.stack([w[0] for w in wires]).view(np.int16), device=dev)
    depth = pp.wire_depth_to_m(d16)
    c8 = torch.as_tensor(np.stack([w[2] for w in wires]), device=dev)
    poses = torch.as_tensor(seq.poses, device=dev)

    # K1: a table pre-filled from 3 frames, then frame 3's 4,096-slot row
    table = blocks.make_table(ac.block_capacity, dev)
    table, _ = tsdf.integrate_batch(
        table, depth[:3], c8[:3], poses[:3], torch.ones(3, dtype=torch.bool, device=dev), cam, ac
    )
    keys, _ = tsdf._upd_keys_batch(depth[3:4], poses[3:4], torch.ones(1, dtype=torch.bool, device=dev), cam, ac)
    table, _ = blocks.allocate(table, keys[0], assume_unique_sorted=True)
    slots, mask = blocks.lookup(table, keys[0])
    plus = tsdf.row_params(poses[3:4], torch.ones(1, device=dev), cam)[0]
    minus = tsdf.row_params(poses[3:4], -torch.ones(1, device=dev), cam)[0]

    def copy(t):
        return dataclasses.replace(t, sdf=t.sdf.clone(), weight=t.weight.clone(), color=t.color.clone())

    tk, tt = copy(table), copy(table)
    tsdf.integrate_blocks(tk, slots, mask, depth[3], c8[3], plus, ac)
    tsdf._integrate_blocks_torch(tt, slots, mask, depth[3], c8[3], plus, ac)
    torch.cuda.synchronize()
    if not torch.equal(tk.weight, tt.weight):
        raise AssertionError(f"K1 weights differ from the twin at {int((tk.weight != tt.weight).sum())} voxels")
    k1_err = max(float((tk.sdf - tt.sdf).abs().max()), float((tk.color - tt.color).abs().max()))
    if k1_err > 1e-5:
        raise AssertionError(f"K1 sdf/colour differ from the twin by {k1_err}")
    updated = int(mask.sum())
    tsdf.integrate_blocks(tk, slots, mask, depth[3], c8[3], minus, ac)
    torch.cuda.synchronize()
    if not torch.equal(tk.weight, table.weight):
        raise AssertionError("K1 integrate then de-integrate did not restore the weights exactly")
    k1_ms = cuda_ms(torch, lambda: tsdf.integrate_blocks(tk, slots, mask, depth[3], c8[3], plus, ac))
    k1_plain = cuda_ms(torch, lambda: tsdf._integrate_blocks_torch(tt, slots, mask, depth[3], c8[3], plus, ac))
    phase("kernels", f"K1 tsdf_integrate: {updated} live of {slots.shape[0]} slots, weights bit-equal, "
          f"max |sdf/colour err| {k1_err:.3g}, integrate+deintegrate exact; "
          f"kernel {k1_ms:.4f} ms, twin {k1_plain:.4f} ms")
    del table, tk, tt

    # K2: the 11 frames of a chunk
    fd, pts, nrm = pp.fused_preprocess(depth, cam, ac.depth_sigma_d, ac.depth_sigma_r)
    fd2, pts2, nrm2 = pp._preprocess_chain_torch(depth, cam, ac.depth_sigma_d, ac.depth_sigma_r, 3)
    errs = [float((a - b).abs().max()) for a, b in ((fd, fd2), (pts, pts2), (nrm, nrm2))]
    if errs[0] > 1e-5 or errs[1] > 1e-5 or errs[2] > 1e-4:
        raise AssertionError(f"K2 differs from the twin: fdepth/points/normals {errs}")
    k2_ms = cuda_ms(torch, lambda: pp.fused_preprocess(depth, cam, ac.depth_sigma_d, ac.depth_sigma_r))
    k2_plain = cuda_ms(torch, lambda: pp._preprocess_chain_torch(depth, cam, ac.depth_sigma_d, ac.depth_sigma_r, 3))
    phase("kernels", f"K2 preprocess: fdepth/points/normals max err {errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g}; "
          f"kernel {k2_ms:.4f} ms, twin {k2_plain:.4f} ms")
    return [
        dict(name="tsdf_integrate", route="cuda", source="bundlefusion_tpu_torch/csrc/tsdf_integrate.cu",
             replaces="bundlefusion_tpu/fusion/pallas_tsdf.py:84", launches=0, max_abs_err=k1_err,
             ms=k1_ms, plain_ms=k1_plain),
        dict(name="preprocess", route="cuda", source="bundlefusion_tpu_torch/csrc/preprocess.cu",
             replaces="bundlefusion_tpu/ops/pallas_kernels.py:27", launches=0, max_abs_err=max(errs),
             ms=k2_ms, plain_ms=k2_plain),
    ]


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
    phase("slice", f"kernel launches in the timed pass: {launches}")
    if not all(r["chunk_valid"] for r in recs):
        raise AssertionError("a flagship chunk was invalid")
    if not ate <= 0.005:
        raise AssertionError(f"flagship ATE {ate * 100:.4f} cm > 0.5 cm")
    if any(r["patch_overflow"] for r in recs):
        raise AssertionError("patch_overflow is not 0")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was never launched: {launches}")
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


def count_syncs(torch, T, seq, cfg, dev) -> int:
    """Phase 5: host syncs during the steady-state pushes of one flagship pass."""
    from bundlefusion_tpu_torch.bundle.pipeline import BundleFusion

    bf = BundleFusion(seq.camera, cfg, anchor_pose=seq.poses[0], device=dev)
    torch.cuda.synchronize()
    sites: list[str] = []

    def on_warning(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            # the innermost frame of the port's own code names the site
            stack = traceback.extract_stack()[:-1]
            ours = [f for f in stack if "bundlefusion_tpu_torch" in f.filename]
            f = ours[-1] if ours else stack[-1]
            sites.append(f"{f.filename.rsplit('/', 2)[-2]}/{f.filename.rsplit('/', 1)[-1]}:{f.lineno} ({f.name})")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for i in range(len(seq.poses)):
                bf.push_frame(seq.depth[i], seq.color[i])
            bf.flush()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counts = {s: sites.count(s) for s in sorted(set(sites))}
    phase("syncs", f"{len(sites)} host syncs in {FLAGSHIP_FRAMES} steady-state pushes; by site {counts}")
    return len(sites)


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
