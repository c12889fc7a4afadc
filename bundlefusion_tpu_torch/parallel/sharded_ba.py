"""Global bundle adjustment sharded over a mesh
(port of ``bundlefusion_tpu.parallel.sharded_ba``).

The normal-equation system is distributed two ways, as in the JAX package:

  * **residual-parallel assembly**: each shard scatters its slice of the
    correspondences (and of the dense keyframe pairs) into a partial
    [6N, 6N] system on its device; one :func:`~.mesh.psum` in rank order
    makes it whole.
  * **row-sharded PCG**: H lives as row blocks [6N/d, 6N], one per shard;
    each matvec computes the row blocks on their devices and
    :func:`~.mesh.all_gather` joins them. The JAX package runs the
    replicated vector arithmetic on every device with identical results;
    the port, one controller, runs it once on shard 0's device.

Each shard's partial system passes through ``assemble_system``, which
gives every fixed (gauge) row an identity and adds 1e-8 to the diagonal;
after the sum the identity is taken back out d - 1 times, and the 1e-8 stays
d times, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import BundlingConfig
from ..geometry import se3
from ..solver import gn, residuals
from ..solver.residuals import SparseCorrs
from ..solver.system import assemble_system
from .mesh import Mesh, all_gather, psum

_CORR_FIELDS = ("img_a", "img_b", "p_a", "p_b", "weight")


def check_rows(n_rows: int, mesh: Mesh, what: str = "rows") -> None:
    """Sharded arrays split into equal row blocks: raise unless the shard
    count divides ``n_rows`` (the JAX package's ``shard_map`` raises too)."""
    if n_rows % mesh.size:
        raise ValueError(f"{n_rows} {what} do not divide over a mesh of {mesh.size} shards")


def _shard(x: torch.Tensor, i: int, d: int, device) -> torch.Tensor:
    rows = x.shape[0] // d
    return x[i * rows : (i + 1) * rows].to(device, non_blocking=True)


def _corrs_shard(corrs: SparseCorrs, i: int, d: int, device) -> SparseCorrs:
    return SparseCorrs(*(_shard(getattr(corrs, f), i, d, device) for f in _CORR_FIELDS))


def _pad_to_multiple(x: torch.Tensor, d: int) -> torch.Tensor:
    r = (-x.shape[0]) % d
    if r == 0:
        return x
    return torch.cat([x, torch.zeros((r,) + x.shape[1:], dtype=x.dtype, device=x.device)])


def _sum_partials(mesh: Mesh, parts: list[tuple[torch.Tensor, torch.Tensor]], free_mask: torch.Tensor):
    """psum the shards' (H, b), then take out the fixed rows' identity that
    every shard but one added. Returns (H, b) on ``free_mask``'s device."""
    home = free_mask.device
    H = psum(mesh, [h for h, _ in parts])[0].to(home, non_blocking=True)
    b = psum(mesh, [v for _, v in parts])[0].to(home, non_blocking=True)
    fm = torch.repeat_interleave(free_mask.to(H.dtype), 6)
    return H - torch.diag((mesh.size - 1.0) * (1.0 - fm)), b


def assemble_system_sharded(
    mesh: Mesh,
    num_images: int,
    corrs: SparseCorrs,  # [R], R divisible by the shard count
    poses: torch.Tensor,  # [N, 4, 4]
    free_mask: torch.Tensor,  # [N]
    weight_sparse: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual-parallel assembly: each shard's correspondences -> partial
    (H, b) -> one rank-order sum. No damping (the caller adds it)."""
    d = mesh.size
    check_rows(corrs.capacity, mesh, "correspondences")
    parts = []
    for i, dev in enumerate(mesh.devices):
        c = _corrs_shard(corrs, i, d, dev)
        JtJ, Jtr, _ = residuals.sparse_corr_blocks(poses.to(dev, non_blocking=True), c, weight_sparse)
        parts.append(
            assemble_system(num_images, c.img_a, c.img_b, JtJ, Jtr, free_mask.to(dev, non_blocking=True), damping=0.0)
        )
    return _sum_partials(mesh, parts, free_mask)


def pcg_solve_rowsharded(mesh: Mesh, H: torch.Tensor, b: torch.Tensor, num_iters: int) -> torch.Tensor:
    """Row-sharded Jacobi-PCG (the JAX package's body, with its own gate
    ``rz > 1e-10`` and guards; not ``system.pcg_solve``): each matvec is the
    row blocks' products, gathered in rank order. Returns x on ``b``'s
    device."""
    d = mesh.size
    n = b.shape[0]
    check_rows(n, mesh)
    rows = n // d
    home = b.device
    blocks = [_shard(H, i, d, dev) for i, dev in enumerate(mesh.devices)]
    diag_full = all_gather(mesh, [blk[:, i * rows : (i + 1) * rows].diagonal() for i, blk in enumerate(blocks)])
    diag_full = diag_full.to(home, non_blocking=True)
    Minv = torch.where(torch.abs(diag_full) > 1e-12, 1.0 / diag_full, 0.0)

    def matvec(p):
        return all_gather(mesh, [blk @ p.to(blk.device, non_blocking=True) for blk in blocks]).to(home)

    x = torch.zeros_like(b)
    r = b
    z = Minv * r
    p = z
    rz = torch.dot(r, z)
    for _ in range(num_iters):
        active = rz > 1e-10
        Ap = matvec(p)
        pAp = torch.dot(p, Ap)
        alpha = torch.where(active & (torch.abs(pAp) > 1e-20), rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv * r
        rz_new = torch.dot(r, z)
        beta = torch.where(active & (rz > 1e-20), rz_new / rz, 0.0)
        p = torch.where(active, z + beta * p, p)
        rz = torch.where(active, rz_new, rz)
    return x


def _gn_update(poses, x, free_mask):
    n = poses.shape[0]
    upd = se3.se3_exp(x.reshape(n, 6))
    new_poses = torch.einsum("nij,njk->nik", upd, poses)
    return torch.where(free_mask[:, None, None], new_poses, poses)


def _damp(H: torch.Tensor) -> torch.Tensor:
    """The damping ``assemble_system`` leaves out when ``damping=0``, once."""
    return H + torch.diag(1e-6 * torch.diagonal(H) + 1e-8)


def global_solve_sharded(
    mesh: Mesh,
    poses: torch.Tensor,  # [N, 4, 4]
    corrs: SparseCorrs,
    free_mask: torch.Tensor,
    cfg: BundlingConfig,
    gn_iters: int | None = None,
    pcg_iters: int | None = None,
) -> torch.Tensor:
    """Sparse-only sharded GN: sharded assembly + row-sharded PCG per
    iteration. The correspondence capacity and 6N must divide over the
    mesh. Returns the updated poses."""
    n = poses.shape[0]
    for _ in range(gn_iters or cfg.global_gn_iters):
        H, b = assemble_system_sharded(mesh, n, corrs, poses, free_mask, cfg.weight_sparse)
        x = pcg_solve_rowsharded(mesh, _damp(H), b, pcg_iters or cfg.global_pcg_iters)
        poses = _gn_update(poses, x, free_mask)
    return poses


def solve_and_prune_sharded(
    mesh: Mesh,
    poses: torch.Tensor,  # [N, 4, 4]
    problem: gn.GNProblem,
    caches,  # FrameCache [N, ...] or None
    cache_cam,
    cfg: BundlingConfig,
    gn_iters: int,
    pcg_iters: int,
    use_dense: bool = True,
    prune_rounds: int = 1,
):
    """The sharded counterpart of ``gn.solve_and_prune``, which the pipeline
    runs when it has a mesh: sparse + dense terms with the dense weight
    ramp, correspondences and dense pairs sharded (padded with empty entries
    to a multiple of the shard count), row-sharded PCG, then max-residual
    pruning on the whole set. Returns (poses, problem, total_removed)."""
    d = mesh.size
    n = poses.shape[0]
    check_rows(6 * n, mesh)
    corrs0 = problem.corrs
    corrs_p = SparseCorrs(*(_pad_to_multiple(getattr(corrs0, f), d) for f in _CORR_FIELDS))
    dense = [_pad_to_multiple(x, d) for x in (problem.dense_pairs_a, problem.dense_pairs_b, problem.dense_pair_active)]
    r_real = corrs0.capacity
    # the JAX package's sharded ramp: Python floats, rounded to f32 where used
    if cfg.dense_weight_ramp and gn_iters > 1:
        ramp = [(i + 1.0) / gn_iters for i in range(gn_iters)]
    else:
        ramp = [1.0] * gn_iters
    with_dense = use_dense and caches is not None
    # each shard's constant inputs, on its device
    shards = []
    for i, dev in enumerate(mesh.devices):
        shards.append(dict(
            dev=dev,
            corrs=_corrs_shard(corrs_p, i, d, dev),
            dense=[_shard(x, i, d, dev) for x in dense],
            caches=None if not with_dense else type(caches)(
                *(getattr(caches, f.name).to(dev, non_blocking=True) for f in dataclasses.fields(caches))),
            free=problem.free_mask.to(dev, non_blocking=True),
        ))

    def local_system(sh, poses_l, weight_l, scale):
        c = dataclasses.replace(sh["corrs"], weight=weight_l)
        JtJ, Jtr, _ = residuals.sparse_corr_blocks(poses_l, c, cfg.weight_sparse)
        idx_a, idx_b = c.img_a, c.img_b
        if with_dense:
            dpa, dpb, don = sh["dense"]
            dJtJ, dJtr, _ = residuals.dense_pair_blocks(
                poses_l, dpa, dpb, don, sh["caches"], cache_cam, cfg,
                cfg.weight_dense_depth * scale, cfg.weight_dense_color * scale,
            )
            idx_a = torch.cat([idx_a.long(), dpa.long()])
            idx_b = torch.cat([idx_b.long(), dpb.long()])
            JtJ = torch.cat([JtJ, dJtJ])
            Jtr = torch.cat([Jtr, dJtr])
        return assemble_system(n, idx_a, idx_b, JtJ, Jtr, sh["free"], damping=0.0)

    total_removed = torch.zeros((), dtype=torch.int32, device=poses.device)
    weight = corrs_p.weight
    for _ in range(prune_rounds):
        for scale in ramp:
            parts = [
                local_system(sh, poses.to(sh["dev"], non_blocking=True),
                             _shard(weight, i, d, sh["dev"]), scale)
                for i, sh in enumerate(shards)
            ]
            H, b = _sum_partials(mesh, parts, problem.free_mask)
            x = pcg_solve_rowsharded(mesh, _damp(H), b, pcg_iters)
            poses = _gn_update(poses, x, problem.free_mask)
        # max-residual pruning over all correspondences, on the caller's device
        cw = dataclasses.replace(corrs_p, weight=weight)
        _, _, res_norms = residuals.sparse_residuals(poses, cw)
        pruned, removed = gn.prune_max_residuals(cw, res_norms, cfg.max_res_thresh, cfg.prune_iters)
        weight = pruned.weight
        total_removed = total_removed + removed
    problem = dataclasses.replace(problem, corrs=dataclasses.replace(corrs0, weight=weight[:r_real]))
    return poses, problem, total_removed
