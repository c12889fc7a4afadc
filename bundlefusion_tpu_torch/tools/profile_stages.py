"""Per-stage device times of the chunk step at the flagship shapes (port of
``tools/profile_stages.py``): each sub-stage of ``process_chunk``
(preprocess with K2, SIFT, matching, the filters, their dense verification
alone (K5), the local BA, the opt-verify (K5)), the whole chunk step, and
``fuse_batch``'s internals (the update-key lists at allocation strides 1
and 4, union + allocate, the whole fuse with K1).

    python -m bundlefusion_tpu_torch.tools.profile_stages [width height] [--device cuda] [--reps 10]

On a card each line is the median of ``--reps`` (at least 1) timings between
CUDA events (after one warm call), then the kernels one more call launches
and their summed device time, from ``torch.profiler``'s device events; with
``--device cpu`` it is the host clock of the plain PyTorch twins, which says
nothing about a card. The bundling
configuration is the flagship's, with the cache at an eighth of the frame
size (80x60 at 640x480), and the flagship's block pool of 262,144 blocks.
``--tiny`` takes the tiny test configuration instead (capacities for a smoke
run on the CPU, e.g. ``32 24 --tiny --device cpu --reps 1``).
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

# stages of the JAX tool that were design experiments on the TPU; K1's
# single launch over all rows replaced both
NO_COUNTERPART = ("upd_keys scan+cond", "fuse scan")


def timer(device):
    """``time(fn, reps) -> (median ms, fn's last result)`` on ``device``:
    CUDA events around each call on a card, after one warm call (kernel
    build, allocator); the host clock on the CPU, with no warm call."""
    import torch

    def run(fn, reps):
        if device.type == "cuda":
            fn()
        times = []
        for _ in range(reps):
            if device.type == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                result = fn()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                result = fn()
                times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times), result

    return run


def device_kernels(fn) -> tuple[int, float]:
    """(kernels launched, their summed device ms) in one call of ``fn``,
    from the profiler's device events (copies and fills left out)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.name.startswith(("Memcpy", "Memset"))]
    return len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def main(argv=None) -> dict[str, float]:
    p = argparse.ArgumentParser()
    p.add_argument("size", type=int, nargs="*", default=[640, 480], help="width height")
    p.add_argument("--device", default="cuda")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)
    w, h = args.size
    if args.reps < 1:
        p.error("--reps must be at least 1")

    import numpy as np
    import torch

    from ..bundle.chunk import process_chunk
    from ..config import AppConfig, BundlingConfig, tiny_test_config
    from ..features import filters, matcher, sift
    from ..fusion import blocks, tsdf
    from ..geometry import se3
    from ..io import framewire
    from ..io.synthetic import generate_sequence
    from ..ops.preprocess import preprocess_frames_y, wire_depth_to_m
    from ..solver import gn, residuals
    from ..utils.tensor_ops import top_k

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_stages: no CUDA device (pass --device cpu for the CPU twins)")
    if args.tiny:
        tiny = tiny_test_config()
        cfg = dataclasses.replace(tiny.bundling, cache_width=w // 2, cache_height=h // 2, verify_width=w // 2,
                                  verify_height=h // 2)
        ac = dataclasses.replace(tiny.app, input_width=w, input_height=h, integration_width=w, integration_height=h)
    else:
        cfg = BundlingConfig(
            submap_size=10, max_num_images=128, max_keys_per_image=512, sift_octaves=3,
            cache_width=w // 8, cache_height=h // 8, verify_width=w // 8, verify_height=h // 8,
            verify_ok_fraction=0.45, verify_color_thresh=0.08,
        )
        ac = AppConfig(input_width=w, input_height=h, integration_width=w, integration_height=h, voxel_size=0.01,
                       truncation=0.04, block_capacity=262144, blocks_per_frame_cap=4096)
    s1 = cfg.submap_size + 1
    seq = generate_sequence(s1, w, h, radius=0.5, device=dev)
    cam = seq.camera
    cache_cam = cam.scaled(cfg.cache_width, cfg.cache_height)
    wires = [framewire.frame_to_wire2(seq.depth[i], seq.color[i]) for i in range(s1)]
    d16 = torch.as_tensor(np.stack([x[0] for x in wires]).view(np.int16), device=dev)
    y8 = torch.as_tensor(np.stack([x[1] for x in wires]), device=dev)
    c8 = torch.as_tensor(np.stack([x[2] for x in wires]), device=dev)
    time_ms = timer(dev)
    out: dict[str, float] = {}

    def line(name, fn, note=""):
        ms, result = time_ms(fn, args.reps)
        out[name] = ms
        if dev.type == "cuda":
            kernels, device_ms = device_kernels(fn)
            out[f"{name} kernels"], out[f"{name} device ms"] = kernels, device_ms
            note = f"; {kernels} kernels, {device_ms:.3f} ms of device time{note}"
        print(f"{name:<28}{ms:10.3f} ms{note}", flush=True)
        return result

    print(f"== {w}x{h}, chunk of {s1} frames, {dev} "
          f"({torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'host clock'}) ==", flush=True)

    def pre():
        return preprocess_frames_y(d16, y8, cam, cache_cam, filter_depth=True, geometry=False)

    frames, cache = line("preprocess (K2)", pre)
    keys = line("sift", lambda: sift.detect_batch(frames.intensity, frames.depth, cam, cfg))
    pairs_a, pairs_b = torch.triu_indices(s1, s1, offset=1, device=dev)
    m = line("match_all_pairs", lambda: matcher.match_all_pairs(keys, pairs_a, pairs_b, cfg))

    def filt_fn():
        pa, pb = matcher.gather_match_points(keys, pairs_a, pairs_b, m)
        return filters.filter_pairs_batch(pa, pb, m, cache.index(pairs_a), cache.index(pairs_b), cache_cam, cfg,
                                          cfg.min_matches_local)

    filt = line("filters", filt_fn)
    pa_c, pb_c = cache.index(pairs_a), cache.index(pairs_b)
    line("dense_verify_filter (K5)",
         lambda: filters.dense_verify_filter(pa_c, pb_c, filt.transform, cache_cam, cfg))

    def local_ba():
        fm = filt.matches
        p_m = fm.valid.shape[1]
        corrs = residuals.SparseCorrs(
            img_a=torch.repeat_interleave(pairs_a, p_m), img_b=torch.repeat_interleave(pairs_b, p_m),
            p_a=keys.p3d[pairs_a[:, None], fm.idx_i].reshape(-1, 3),
            p_b=keys.p3d[pairs_b[:, None], fm.idx_j].reshape(-1, 3),
            weight=(fm.valid & filt.pair_valid[:, None]).reshape(-1).to(torch.float32),
        )
        if corrs.weight.shape[0] > cfg.max_residuals_local:
            score = torch.where(corrs.weight > 0, -fm.dist.reshape(-1), -torch.inf)
            _, keep = top_k(score, cfg.max_residuals_local)
            corrs = corrs.index(keep)
            corrs = dataclasses.replace(corrs, weight=torch.where(torch.isfinite(score[keep]), corrs.weight, 0.0))
        problem = gn.GNProblem(corrs=corrs, dense_pairs_a=pairs_a, dense_pairs_b=pairs_b,
                               dense_pair_active=filt.pair_valid, free_mask=torch.arange(s1, device=dev) > 0)
        init = torch.eye(4, device=dev).repeat(s1, 1, 1)
        return gn.solve_and_prune(init, problem, cache, cache_cam, cfg, gn_iters=cfg.local_gn_iters,
                                  pcg_iters=cfg.local_pcg_iters, use_dense=cfg.use_dense_local, prune_rounds=2)

    solved = line("local BA (GN+prune)", local_ba)[0]
    T_ij = torch.einsum("nij,njk->nik", se3.mat_inverse(solved[1:]), solved[:-1])
    line("opt-verify (K5)", lambda: filters.dense_verify(cache.index(slice(None, -1)), cache.index(slice(1, None)),
                                                          T_ij, cache_cam, cfg))
    line("process_chunk FULL", lambda: process_chunk(d16, y8, cam, cache_cam, cfg))

    # the fusion side: fuse_batch's internals at the pipeline's row count
    budget = ac.max_reintegrations_per_frame * cfg.submap_size
    b = s1 + budget
    rep = torch.arange(b, device=dev) % s1
    depths, colors = wire_depth_to_m(d16)[rep], c8[rep]
    poses = torch.as_tensor(seq.poses, device=dev)[rep]
    # about half the budget rows active (steady state: every new frame and some re-integrations)
    active = torch.arange(b, device=dev) < s1 + budget // 2
    upd_keys, _ = line(f"upd_keys_batch[{b}]", lambda: tsdf._upd_keys_batch(depths, poses, active, cam, ac))
    ac4 = dataclasses.replace(ac, alloc_stride=4)
    line("upd_keys stride4", lambda: tsdf._upd_keys_batch(depths, poses, active, cam, ac4))

    def alloc():
        union, _ = tsdf._union_counted(upd_keys, ac.blocks_per_frame_cap * 4)
        return blocks.allocate(blocks.make_table(ac.block_capacity, dev), union, assume_unique_sorted=True)

    table, _ = line("union+allocate", alloc, " (a fresh pool each call)")
    deint = active & (torch.arange(b, device=dev) >= s1)
    rec = torch.ones((b, ac.blocks_per_frame_cap), dtype=torch.bool, device=dev)
    tsdf.integrate_batch(table, depths, colors, poses, active, cam, ac)

    def fuse():
        # de-integrates the old rows and integrates every row again: the
        # table keeps growing in weight, as the pipeline's does
        return tsdf.fuse_batch(table, depths, colors, poses, poses, deint, active, rec, cam, ac,
                               upd_keys_rec=upd_keys, deint_rows=b - s1)

    line("fuse_batch FULL (K1)", fuse)
    for name in NO_COUNTERPART:
        print(f"{name:<28}no counterpart: replaced by K1's single launch", flush=True)
    return out


if __name__ == "__main__":
    main()
