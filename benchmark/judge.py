"""The comparison that decides ``correct``: what the timed path produced,
scan by scan, against the plain reference (``reference/``) and the scene's
ground truth.

For every scan that the window ran (the partial last one included) it
compares

* the trajectory: each frame's published pose against the ground-truth
  pose, and each frame's motion from the frame before against the truth's
  (the relative pose error). A pose error is read as the displacement it
  causes in the scene: the most that any of five camera-space points at 2 m
  (the optical axis and the image's four corners) moves between the two
  poses. The anchor is the ground truth's first pose, so no alignment is
  made;
* the fused TSDF: the sdf of voxels sampled from the seed among the
  program's observed voxels, against the reference's projective TSDF of the
  same frames at the trajectory the program published
  (``reference/tsdf.py``), on the voxels that the reference puts within
  ``near_band`` of the surface. The trajectory is judged against the truth
  above; this judges the model against the trajectory: a model fused at
  stale poses, never re-integrated, shows here;
* the fused weights: on the same voxels, where the reference's weight is
  under the cap, the program's weight against the reference's (how many
  frames fused there), so that a model fused from part of the frames shows
  (noise-free or not, any subset of frames gives about the same sdf);
* the model's coverage: points of the surface that the scan's last frames
  see, at the published trajectory (``reference/surface.py``, drawn from
  the reference's side, not from the program's blocks), and the share of
  them whose voxel holds no weight in the program's model, so that surface
  the program never allocated, or dropped without counting it, shows;
* validity: the frames the program publishes as invalid, and the updates
  it reports dropped (allocation overflow, truncated update lists), where
  the reference invalidates and drops none.

``numbers`` computes every candidate; the cell's limits file names those
that decide, each with its limit. The rest are printed for the record.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

# camera-space points at 2 m whose displacement measures a pose error: the
# optical axis and the four image corners (in units of the focal length)
VIEW_DEPTH = 2.0


def view_points(intrinsics, width: int, height: int) -> np.ndarray:
    fx, fy, cx, cy = intrinsics
    us, vs = (0.0, width - 1.0), (0.0, height - 1.0)
    pts = [(0.0, 0.0)] + [((u - cx) / fx, (v - cy) / fy) for u in us for v in vs]
    return np.array([(x * VIEW_DEPTH, y * VIEW_DEPTH, VIEW_DEPTH) for x, y in pts])


def pose_errors(poses: np.ndarray, truth: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Per frame, the largest displacement (metres) of ``points`` (camera
    space) between camera-to-world ``poses`` and ``truth`` [N, 4, 4]."""
    p, t = np.asarray(poses, np.float64), np.asarray(truth, np.float64)
    a = np.einsum("nij,kj->nki", p[:, :3, :3], points) + p[:, None, :3, 3]
    b = np.einsum("nij,kj->nki", t[:, :3, :3], points) + t[:, None, :3, 3]
    return np.linalg.norm(a - b, axis=-1).max(axis=1)


def relative_errors(poses: np.ndarray, truth: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Per pair of consecutive frames, the largest displacement (metres) of
    ``points`` between the program's and the truth's motion from one frame
    to the next (frame i's camera moved by T_i^-1 T_i+1): the relative pose
    error, blind to drift that the two frames share."""
    p, t = np.asarray(poses, np.float64), np.asarray(truth, np.float64)
    if len(p) < 2:
        return np.zeros(0)
    rel_p = np.linalg.inv(p[:-1]) @ p[1:]
    rel_t = np.linalg.inv(t[:-1]) @ t[1:]
    return pose_errors(rel_p, rel_t, points)


MIN_SAMPLES = 1000  # voxels or points a share or a median is read from; fewer read as infinite


def numbers(scans: list, truth: np.ndarray, ref_tsdf: list, intrinsics, width: int, height: int,
            near_band: float, weight_cap: float) -> dict:
    """Every candidate number over the judged ``scans`` (dicts with
    ``frames``, ``poses``, ``valid``, ``dropped``, ``voxel_sdf``,
    ``voxel_weight`` and ``surface_weight``) given the reference sdf and
    weight at each scan's voxels (``ref_tsdf[i]`` = (sdf, weight))."""
    pts = view_points(intrinsics, width, height)
    errs, rels, invalid, dropped, gaps, wgaps, surface = [], [], 0, 0, [], [], []
    for scan, (rsdf, rw) in zip(scans, ref_tsdf):
        n = scan["frames"]
        errs.append(pose_errors(scan["poses"][:n], truth[:n], pts))
        rels.append(relative_errors(scan["poses"][:n], truth[:n], pts))
        invalid += int(n - np.count_nonzero(scan["valid"][:n]))
        dropped += int(scan["dropped"])
        psdf, pw = scan["voxel_sdf"], scan["voxel_weight"]
        near = (rw > 0) & (pw > 0) & (np.abs(rsdf) < near_band)
        gaps.append(np.abs(psdf[near] - rsdf[near]))
        uncapped = (rw > 0) & (rw < weight_cap)
        wgaps.append(np.abs(pw[uncapped] - rw[uncapped]) / rw[uncapped])
        surface.append(scan["surface_weight"])
    err = np.concatenate(errs) if errs else np.zeros(0)
    rel = np.concatenate(rels) if rels else np.zeros(0)
    gap = np.concatenate(gaps) if gaps else np.zeros(0)
    wgap = np.concatenate(wgaps) if wgaps else np.zeros(0)
    surf = np.concatenate(surface) if surface else np.zeros(0)
    out = {
        "invalid_frames": invalid,
        "dropped_updates": dropped,
        "pose_max_mm": float(err.max() * 1e3) if err.size else math.inf,
        "pose_rms_mm": float(np.sqrt(np.mean(err**2)) * 1e3) if err.size else math.inf,
        "rpe_max_mm": float(rel.max() * 1e3) if rel.size else math.inf,
        "rpe_rms_mm": float(np.sqrt(np.mean(rel**2)) * 1e3) if rel.size else math.inf,
        "tsdf_med_mm": float(np.median(gap) * 1e3) if gap.size >= MIN_SAMPLES else math.inf,
        "tsdf_p90_mm": float(np.percentile(gap, 90) * 1e3) if gap.size >= MIN_SAMPLES else math.inf,
        "weight_gap_pct": float(np.median(wgap) * 100) if wgap.size >= MIN_SAMPLES else math.inf,
        "weight_off_pct": float(np.mean(wgap > 0.05) * 100) if wgap.size >= MIN_SAMPLES else math.inf,
        "surface_missed_pct": float(np.mean(surf <= 0) * 100) if surf.size >= MIN_SAMPLES else math.inf,
        "near_voxels": int(gap.size),
        "uncapped_voxels": int(wgap.size),
        "surface_points": int(surf.size),
        "frames_judged": int(err.size),
    }
    return out


def load_limits(root: str, cell: str) -> dict:
    """The cell's limits: ``benchmark/limits/<cell>.json``, {number: {"limit":
    x, ...}}; a number passes when it is at most its limit."""
    with open(os.path.join(root, "benchmark", "limits", f"{cell}.json")) as f:
        return json.load(f)["limits"]


def decide(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}) for the numbers that decide."""
    compared = {k: {"value": nums[k], "limit": v["limit"]} for k, v in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in compared.values())
    return ok, compared
