"""Trajectory manager: re-integration scheduling
(port of ``bundlefusion_tpu.bundle.trajectory``). Per frame, the pose it was
*integrated* with vs. the *currently optimized* pose; after each
optimization the frames whose pose moved most are de-integrated (old pose)
and re-integrated (new pose) under a per-step budget, and invalidated frames
are purely de-integrated.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..geometry import se3
from ..utils.tensor_ops import set_drop, top_k


@dataclass
class TrajectoryState:
    integrated_pose: torch.Tensor  # [F, 4, 4] pose each frame was last fused with
    integrated: torch.Tensor  # [F] bool
    opt_pose: torch.Tensor  # [F, 4, 4] current optimized pose
    opt_valid: torch.Tensor  # [F] bool — frame currently part of a valid chunk


def make_trajectory(max_frames: int, device) -> TrajectoryState:
    eye = torch.eye(4, device=device).repeat(max_frames, 1, 1)
    return TrajectoryState(
        integrated_pose=eye,
        integrated=torch.zeros(max_frames, dtype=torch.bool, device=device),
        opt_pose=eye.clone(),
        opt_valid=torch.zeros(max_frames, dtype=torch.bool, device=device),
    )


def update_optimized(ts: TrajectoryState, frame_ids, poses, valid, keep=None) -> TrajectoryState:
    """Set optimized pose/validity of ``frame_ids`` (unique among kept rows);
    rows with ``keep`` False or an out-of-range id are dropped."""
    return dataclasses.replace(
        ts,
        opt_pose=set_drop(ts.opt_pose, frame_ids, poses, keep),
        opt_valid=set_drop(ts.opt_valid, frame_ids, valid, keep),
    )


@dataclass
class ReintPlan:
    frames: torch.Tensor  # [budget] frame ids to touch
    deint_mask: torch.Tensor  # [budget] bool — de-integrate at integrated_pose
    reint_mask: torch.Tensor  # [budget] bool — (re-)integrate at opt_pose
    max_delta: torch.Tensor  # largest pending pose delta (for logging)


def plan_reintegration(ts: TrajectoryState, budget: int, rot_thresh: float = 0.008, trans_thresh: float = 0.004,
                       exclude_from=None, ring_frame=None) -> ReintPlan:
    """Pick the ``budget`` frames most in need of fusion work: invalidated
    (de-integrate only), then missing (integrate only), then moved (both,
    worst drift first). Frames from ``exclude_from`` on are no candidates:
    a 0-d int32 device tensor in the chunk step (a Python int there would
    bake the chunk into its captured graph). With ``ring_frame`` (the device
    ring's residency map, slot = id % R) every ring-resident candidate
    outranks every spilled one."""
    ang, dist = se3.pose_distance(ts.integrated_pose, ts.opt_pose)
    delta = ang + dist
    moved = ts.integrated & ts.opt_valid & ((ang > rot_thresh) | (dist > trans_thresh))
    invalidated = ts.integrated & ~ts.opt_valid
    missing = ~ts.integrated & ts.opt_valid
    fids = torch.arange(ts.integrated.shape[0], device=ts.integrated.device)
    if exclude_from is not None:
        allowed = fids < exclude_from
        moved = moved & allowed
        invalidated = invalidated & allowed
        missing = missing & allowed
    delta_c = torch.clamp(delta, max=1e3)
    score = torch.where(
        invalidated, 5e4, torch.where(missing, 4e4, torch.where(moved, 2e4 + delta_c, -torch.inf))
    )
    if ring_frame is not None:
        resident = ring_frame[fids % ring_frame.shape[0]] == fids
        spilled = torch.where(
            invalidated, 300.0,
            torch.where(missing, 200.0, torch.where(moved, torch.clamp(delta_c, max=99.0), -torch.inf)),
        )
        score = torch.where(resident, score, spilled)
    top, idx = top_k(score, budget)
    work = top > -torch.inf
    return ReintPlan(
        frames=idx,
        deint_mask=work & ts.integrated[idx],
        reint_mask=work & ts.opt_valid[idx],
        max_delta=torch.amax(torch.where(moved, delta, 0.0)),
    )


def mark_integrated(ts: TrajectoryState, frame_id: int, pose: torch.Tensor) -> TrajectoryState:
    pose_all = ts.integrated_pose.clone()
    integrated = ts.integrated.clone()
    pose_all[frame_id] = pose
    integrated[frame_id] = True
    return dataclasses.replace(ts, integrated_pose=pose_all, integrated=integrated)


def mark_integrated_batch(ts: TrajectoryState, frame_ids, poses) -> TrajectoryState:
    return dataclasses.replace(
        ts,
        integrated_pose=set_drop(ts.integrated_pose, frame_ids, poses),
        integrated=set_drop(ts.integrated, frame_ids, True),
    )


def mark_deintegrated(ts: TrajectoryState, frame_id: int) -> TrajectoryState:
    integrated = ts.integrated.clone()
    integrated[frame_id] = False
    return dataclasses.replace(ts, integrated=integrated)
