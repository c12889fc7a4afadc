"""Offline matching harness (port of ``tools/offline_matching.py``, the
rebuild of the reference's ``TestMatching``): pick two frames of any input
source, run SIFT, matching and the 3-stage filter on them, print the
statistics as JSON and write overlay images.

    python -m bundlefusion_tpu_torch.tools.offline_matching --synthetic 8 --frames 0 5 --out out/match
    python -m bundlefusion_tpu_torch.tools.offline_matching --sens scan.sens --frames 0 30 --out out/match

``--device`` defaults to ``cuda``; ``--device cpu`` runs the plain PyTorch
twins on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--sens")
    src.add_argument("--tum")
    src.add_argument("--synthetic", type=int)
    p.add_argument("--frames", type=int, nargs=2, default=[0, 1])
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--out", default="offline_matching")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from .. import visualization as viz
    from ..config import BundlingConfig
    from ..features import filters, matcher, sift
    from ..geometry import se3
    from ..io.replayer import SensSource, SyntheticSource, TumSource
    from ..ops.preprocess import preprocess_frames

    dev = torch.device(args.device)
    if args.sens:
        source = SensSource(args.sens)
    elif args.tum:
        from ..io.tum import load_tum_sequence

        source = TumSource(load_tum_sequence(args.tum))
    else:
        from ..io.synthetic import generate_sequence

        source = SyntheticSource(generate_sequence(args.synthetic, width=args.width, height=args.height, device=dev))

    cam = source.camera
    cfg = BundlingConfig(
        cache_width=max(cam.width // 4, 8),
        cache_height=max(cam.height // 4, 8),
        verify_width=max(cam.width // 4, 8),
        verify_height=max(cam.height // 4, 8),
    )
    fa, fb = args.frames
    da, ca = source.get(fa)
    db, cb = source.get(fb)
    depth = torch.as_tensor(np.stack([da, db]).astype(np.float32), device=dev)
    color = torch.as_tensor(np.stack([ca, cb]).astype(np.float32), device=dev)
    cache_cam = cam.scaled(cfg.cache_width, cfg.cache_height)
    frames, cache = preprocess_frames(depth, color, cam, cache_cam)
    keys = sift.detect_batch(frames.intensity, frames.depth, cam, cfg)
    k0, k1 = keys.index(0), keys.index(1)
    m = matcher.match_pair(k0, k1, cfg)
    res = filters.filter_pair(k0.p3d[m.idx_i], k1.p3d[m.idx_j], m, cache.index(0), cache.index(1), cache_cam, cfg,
                              cfg.min_matches_local)
    ang = float(torch.linalg.vector_norm(se3.se3_log(res.transform)[:3]))

    os.makedirs(args.out, exist_ok=True)
    viz.save_keypoint_image(os.path.join(args.out, f"keys_{fa}.png"), ca, k0)
    viz.save_keypoint_image(os.path.join(args.out, f"keys_{fb}.png"), cb, k1)
    viz.save_match_image(os.path.join(args.out, "matches_raw.png"), ca, cb, k0, k1, m)
    viz.save_match_image(os.path.join(args.out, "matches_filtered.png"), ca, cb, k0, k1, res.matches)
    stats = {
        "keys_a": int(k0.valid.sum()),
        "keys_b": int(k1.valid.sum()),
        "raw_matches": int(m.count()),
        "filtered_matches": int(res.matches.count()),
        "pair_valid": bool(res.pair_valid),
        "inliers": int(res.inlier_count),
        "relative_rotation_rad": ang,
        "relative_translation_m": float(torch.linalg.vector_norm(res.transform[:3, 3])),
    }
    print(json.dumps(stats, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
