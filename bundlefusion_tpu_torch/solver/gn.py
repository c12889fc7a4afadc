"""Gauss-Newton driver for sparse+dense bundle adjustment
(port of ``bundlefusion_tpu.solver.gn``): per nonlinear iteration, rebuild
the dense system by projective association, add the sparse term, PCG-solve,
apply left-multiplicative se3 updates; afterwards prune max-residual
correspondences.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..config import BundlingConfig
from ..geometry import se3
from ..geometry.camera import CameraModel
from ..ops.preprocess import FrameCache
from ..utils.tensor_ops import top_k
from .residuals import SparseCorrs, dense_pair_blocks, sparse_corr_blocks, sparse_residuals
from .system import assemble_system, pcg_solve


@dataclass
class SolveStats:
    sparse_res_sum: torch.Tensor  # [iters] sum of squared sparse residual norms
    dense_depth_res: torch.Tensor  # [iters] mean squared dense depth residual
    dense_color_res: torch.Tensor  # [iters]
    pcg_final_rz: torch.Tensor  # [iters]
    final_res_norms: torch.Tensor  # [R] per-correspondence residual after solve
    pcg_rows: torch.Tensor  # [iters] int32: the live rows each PCG solved (PCGResult.rows)
    pcg_iters_run: torch.Tensor  # [iters] int32: the iterations each PCG ran before converging
    # [iters, 2] the dense term's depth and colour associations, where it ran
    dense_assoc: torch.Tensor | None = None
    # [5] int32 of a global solve with its dense term (global_graph.dense_counts)
    dense_counts: torch.Tensor | None = None


@dataclass
class GNProblem:
    corrs: SparseCorrs  # [R]
    dense_pairs_a: torch.Tensor  # [P]
    dense_pairs_b: torch.Tensor  # [P]
    dense_pair_active: torch.Tensor  # [P] bool
    free_mask: torch.Tensor  # [N] bool


def solve_gn(poses, problem: GNProblem, caches: FrameCache | None, cache_cam: CameraModel | None,
             cfg: BundlingConfig, gn_iters: int, pcg_iters: int, use_dense: bool = True, stamps=None):
    """Run GN; returns (updated poses [N,4,4], SolveStats). With ``stamps``
    (``utils/timeline.Stamps``) the dense term of each iteration is stamped
    (``timeline.ITERATED``)."""
    n = poses.shape[0]
    dev = poses.device
    # the ramp is f32 arithmetic in the reference: (i + 1) / n, then * weight
    if cfg.dense_weight_ramp and gn_iters > 1:
        ramp = [np.float32(i + 1) / np.float32(gn_iters) for i in range(gn_iters)]
    else:
        ramp = [np.float32(1.0)] * gn_iters
    stats, assoc = [], []
    for i, scale in enumerate(ramp):
        sJtJ, sJtr, res_norms = sparse_corr_blocks(poses, problem.corrs, cfg.weight_sparse)
        idx_a, idx_b = problem.corrs.img_a, problem.corrs.img_b
        JtJ, Jtr = sJtJ, sJtr
        if use_dense and caches is not None:
            with stamps.iteration(i) if stamps is not None else contextlib.nullcontext():
                dJtJ, dJtr, dstats = dense_pair_blocks(
                    poses, problem.dense_pairs_a, problem.dense_pairs_b, problem.dense_pair_active,
                    caches, cache_cam, cfg,
                    float(np.float32(cfg.weight_dense_depth) * scale),
                    float(np.float32(cfg.weight_dense_color) * scale),
                )
            idx_a = torch.cat([idx_a.long(), problem.dense_pairs_a.long()])
            idx_b = torch.cat([idx_b.long(), problem.dense_pairs_b.long()])
            JtJ = torch.cat([JtJ, dJtJ])
            Jtr = torch.cat([Jtr, dJtr])
            assoc.append(torch.stack([torch.sum(dstats.num_valid_depth), torch.sum(dstats.num_valid_color)]))
            nd, nc = torch.clamp(assoc[-1], min=1).unbind()
            dd = torch.sum(dstats.sum_sq_depth) / nd
            dc = torch.sum(dstats.sum_sq_color) / nc
        else:
            dd = torch.zeros((), device=dev)
            dc = torch.zeros((), device=dev)
        H, b = assemble_system(n, idx_a, idx_b, JtJ, Jtr, problem.free_mask)
        sol = pcg_solve(H, b, pcg_iters, free_mask=problem.free_mask)
        upd = se3.se3_exp(sol.x.reshape(n, 6))
        new_poses = torch.einsum("nij,njk->nik", upd, poses)
        poses = torch.where(problem.free_mask[:, None, None], new_poses, poses)
        s = torch.sum(problem.corrs.weight * res_norms**2)
        stats.append((s, dd, dc, sol.final_rz, sol.rows, sol.iters_run))

    _, _, final_norms = sparse_residuals(poses, problem.corrs)
    s, dd, dc, rz, rows, run = (torch.stack(list(x)) for x in zip(*stats))
    return poses, SolveStats(s, dd, dc, rz, final_norms, rows, run, torch.stack(assoc) if assoc else None)


def prune_max_residuals(corrs: SparseCorrs, res_norms, max_res_thresh: float, max_removals: int):
    """Zero the weight of up to ``max_removals`` worst correspondences whose
    residual exceeds the threshold. Returns (corrs, num_removed)."""
    score = torch.where(corrs.weight > 0, res_norms, -torch.inf)
    top, idx = top_k(score, max_removals)
    remove = top > max_res_thresh
    weight = corrs.weight.clone()
    weight[idx] = weight[idx] * torch.where(remove, 0.0, 1.0)
    return dataclasses.replace(corrs, weight=weight), torch.sum(remove).to(torch.int32)


def solve_and_prune(poses, problem: GNProblem, caches, cache_cam, cfg: BundlingConfig, gn_iters: int,
                    pcg_iters: int, use_dense: bool = True, prune_rounds: int = 1, stamps=None):
    """solve -> prune, ``prune_rounds`` times. Returns (poses, updated
    problem, stats of the last round, total removed). ``stamps`` as in
    :func:`solve_gn` (one round: a round's iterations take the same
    columns)."""
    removed_acc = torch.zeros((), dtype=torch.int32, device=poses.device)
    stats = None
    for _ in range(prune_rounds):
        poses, stats = solve_gn(poses, problem, caches, cache_cam, cfg, gn_iters, pcg_iters, use_dense, stamps)
        corrs, removed = prune_max_residuals(problem.corrs, stats.final_res_norms, cfg.max_res_thresh, cfg.prune_iters)
        problem = dataclasses.replace(problem, corrs=corrs)
        removed_acc = removed_acc + removed
    return poses, problem, stats, removed_acc
