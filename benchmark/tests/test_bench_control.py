"""The control: the reference put in the program's place and computed in
bfloat16 (the precision below the float32 the configuration states) is
not correct under each cell's limits, while the float32 reference in the
same place is. At a size a CPU test holds: 31 frames at 96x72 of the
cell's own walk; the numbers compared do not scale with the image (pose
errors are read at 2 m through the image's corners, TSDF gaps in metres,
weights and coverage as shares)."""

import functools
import json

import numpy as np
import pytest
import torch

from benchmark import drive, judge, spec
from benchmark.reference import tsdf as ref
from benchmark import scene

CELLS = [w["name"] for w in spec.load()["workloads"]]
W, H, N = 96, 72, 31


def near_surface_points(depth, poses, intrinsics, stride=6):
    """World points along the rays of a few frames' pixels, within 6 mm of
    the surface they hit (voxel centres where a scan observes)."""
    fx, fy, cx, cy = intrinsics
    v, u = np.mgrid[0:H:stride, 0:W:stride]
    pts = []
    for f in (0, N // 2, N - 1):
        d = depth[f, v, u]
        ok = d > 0
        ray = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u, dtype=float)], -1)[ok]
        for off in (-0.006, -0.003, 0.0, 0.003, 0.006):
            cam = ray * (d[ok] + off)[:, None]
            pts.append(cam @ poses[f, :3, :3].T.astype(np.float64) + poses[f, :3, 3])
    return np.concatenate(pts)


@functools.lru_cache(maxsize=None)
def rendered(mix: str):
    """The mix's walk (``mix``, as JSON) for seed 77 and its frames."""
    mix = json.loads(mix)
    truth = drive.scan_poses(mix, 77, N).to(torch.float32).numpy()
    return truth, scene.load(mix["scene"]).render(truth, W, H, "cpu")[0]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_reference_passes(name):
    cell = spec.cell(name)
    app = cell.config["app"]
    truth, depth = rendered(json.dumps({k: cell.mix[k] for k in ("scene", "path")}, sort_keys=True))
    intr = scene.load(cell.mix["scene"]).intrinsics(W, H)
    pts = near_surface_points(depth, truth, intr)
    rsdf, rw = ref.fuse(pts, depth, truth.astype(np.float64), intr, app, torch.float32, "cpu")
    band = 0.5 * app["truncation"]
    limits = judge.load_limits(spec.ROOT, name)

    def judged(poses, sdf, weight):
        scan = {"frames": N, "poses": poses, "valid": np.ones(N, bool), "dropped": 0, "voxel_sdf": sdf,
                "voxel_weight": weight, "surface_weight": np.ones(judge.MIN_SAMPLES)}
        nums = judge.numbers([scan], truth, [(rsdf, rw)], intr, W, H, band, app["max_integration_weight"])
        return judge.decide(nums, limits)

    ok, compared = judged(truth, rsdf, rw)
    assert ok, compared
    c2w = drive.scan_poses(cell.mix, 77, N, torch.bfloat16)
    csdf, cw = ref.fuse(pts, depth, c2w.to(torch.float64).numpy(), intr, app, torch.bfloat16, "cpu")
    ok, compared = judged(c2w.to(torch.float32).numpy(), csdf, cw)
    assert not ok, compared
    failing = {k for k, c in compared.items() if c["value"] > c["limit"]}
    assert {"rpe_rms_mm", "tsdf_med_mm"} <= failing, compared
