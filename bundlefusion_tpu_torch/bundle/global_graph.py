"""Inter-chunk (global) bundling: the keyframe graph
(port of ``bundlefusion_tpu.bundle.global_graph``). Every chunk's keyframe is
matched against ALL previous keyframes (loop closure and relocalization are
one mechanism), surviving correspondences go into the fixed-capacity global
buffer, and a global BA over keyframe poses runs with max-residual pruning,
on one device (:func:`global_solve`) or sharded over a mesh
(:func:`global_solve_sharded`).

:func:`global_match` may run over a prefix of the slots (``slots``): the
graph step takes the smallest tier of :func:`graph_tiers` that holds the
keyframes so far, chosen on the host from the chunk index, so that its work
follows the graph's fill and not its capacity. Slots past the new keyframe
are masked out of the match in either case, so a tier gives the capacity's
result.

The graph is updated in place where the JAX pipeline donates it: the
keyframe slot write of :func:`add_keyframe`, and every tensor that
:func:`global_match`, :func:`global_solve` and :func:`global_solve_sharded`
produce as the graph's new state is written into the graph's own storage
(``copy_into``); each returns the graph it was given. The keyframe slot is a
0-d int32 device tensor, as in the JAX step, so that one captured step
serves every chunk; the host-driven re-match of a stale keyframe may pass a
Python int.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..config import BundlingConfig
from ..features import filters, matcher, sift
from ..geometry.camera import CameraModel
from ..ops.preprocess import FrameCache
from ..solver import gn, residuals
from ..utils.tensor_ops import copy_into, put_row, row, set_drop, top_k

_INT32_MAX = 2**31 - 1


@dataclass
class GlobalGraph:
    keys: sift.SiftKeys  # batched [K] fused keyframe key sets
    cache: FrameCache  # batched [K] keyframe caches
    poses: torch.Tensor  # [K, 4, 4] optimized keyframe world poses
    valid: torch.Tensor  # [K] bool
    corrs: residuals.SparseCorrs  # [Rg] keyframe-indexed correspondences
    corr_cursor: torch.Tensor  # int32 next write position
    corr_overflow: torch.Tensor  # int32 dropped correspondences
    dense_pairs_a: torch.Tensor  # [Pg] int32
    dense_pairs_b: torch.Tensor  # [Pg] int32
    dense_pair_on: torch.Tensor  # [Pg] bool
    dense_cursor: torch.Tensor  # int32
    dense_overflow: torch.Tensor  # int32


def make_graph(cfg: BundlingConfig, cache_h: int, cache_w: int, device) -> GlobalGraph:
    k = cfg.max_num_images
    kk = cfg.max_keys_per_image

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def scalar():
        return torch.zeros((), dtype=torch.int32, device=device)

    keys = sift.SiftKeys(
        xy=zeros(k, kk, 2), sigma=zeros(k, kk), response=zeros(k, kk), orientation=zeros(k, kk),
        depth=zeros(k, kk), p3d=zeros(k, kk, 3), desc=zeros(k, kk, 128), valid=zeros(k, kk, dtype=torch.bool),
    )
    cache = FrameCache(
        depth=zeros(k, cache_h, cache_w), points=zeros(k, cache_h, cache_w, 3),
        normals=zeros(k, cache_h, cache_w, 3), intensity=zeros(k, cache_h, cache_w),
        grad=zeros(k, cache_h, cache_w, 2),
    )
    return GlobalGraph(
        keys=keys,
        cache=cache,
        poses=torch.eye(4, device=device).repeat(k, 1, 1),
        valid=zeros(k, dtype=torch.bool),
        corrs=residuals.empty_corrs(cfg.max_residuals_global, device),
        corr_cursor=scalar(),
        corr_overflow=scalar(),
        dense_pairs_a=zeros(cfg.max_dense_pairs_global, dtype=torch.int32),
        dense_pairs_b=zeros(cfg.max_dense_pairs_global, dtype=torch.int32),
        dense_pair_on=zeros(cfg.max_dense_pairs_global, dtype=torch.bool),
        dense_cursor=scalar(),
        dense_overflow=scalar(),
    )


GRAPH_TIER_MIN = 64  # the smallest slot tier of the graph step


def graph_tiers(capacity: int) -> tuple[int, ...]:
    """The slot counts the graph step runs over: powers of two from
    :data:`GRAPH_TIER_MIN` below ``capacity``, then ``capacity`` (a capacity
    of 64 or less is one tier)."""
    tiers, t = [], GRAPH_TIER_MIN
    while t < capacity:
        tiers.append(t)
        t *= 2
    return (*tiers, capacity)


def graph_tier(c: int, capacity: int) -> int:
    """The slots chunk ``c``'s graph step runs over: the smallest tier that
    holds its ``c + 1`` keyframes (keyframe slot = chunk index)."""
    return next(t for t in graph_tiers(capacity) if t > c)


def _slot(k_idx, device) -> torch.Tensor:
    """A keyframe slot as a 0-d int32 tensor on ``device`` (a Python int
    becomes one by a fill on the device, not a copy from the host)."""
    if isinstance(k_idx, torch.Tensor):
        return k_idx
    return torch.full((), k_idx, dtype=torch.int32, device=device)


def add_keyframe(graph: GlobalGraph, k_idx: torch.Tensor, keys: sift.SiftKeys, cache: FrameCache,
                 init_pose: torch.Tensor, is_valid: torch.Tensor) -> GlobalGraph:
    """Write keyframe slot ``k_idx`` (0-d int32) in place (the JAX pipeline
    donates the graph)."""
    for f in dataclasses.fields(sift.SiftKeys):
        put_row(getattr(graph.keys, f.name), k_idx, getattr(keys, f.name))
    for f in dataclasses.fields(FrameCache):
        put_row(getattr(graph.cache, f.name), k_idx, getattr(cache, f.name))
    put_row(graph.poses, k_idx, init_pose)
    put_row(graph.valid, k_idx, is_valid)
    return graph


@dataclass
class GlobalMatchResult:
    any_valid: torch.Tensor  # bool — the new keyframe linked to the graph
    pair_valid: torch.Tensor  # [K]
    transforms: torch.Tensor  # [K, 4, 4] kf_j-cam -> new-kf-cam
    inlier_counts: torch.Tensor  # [K]
    best_prev: torch.Tensor  # index of the best-matching previous keyframe
    graph: GlobalGraph


def _append_corrs(graph: GlobalGraph, kmax: int, append_cap: int, cand: residuals.SparseCorrs,
                  sel_ok: torch.Tensor, n_new: torch.Tensor):
    """Compact the standing correspondence set with round-robin-fair eviction
    to ``cap - append_cap`` entries, then append the new block. Returns
    (corrs, cursor, overflow)."""
    corrs = graph.corrs
    cap = corrs.capacity
    dev = corrs.weight.device
    live = corrs.weight > 0
    pid = torch.where(live, corrs.img_a.to(torch.int64) * kmax + corrs.img_b, _INT32_MAX)
    pid_s, order1 = torch.sort(pid, stable=True)
    idx = torch.arange(cap, device=dev)
    first = torch.ones(cap, dtype=torch.bool, device=dev)
    first[1:] = pid_s[1:] != pid_s[:-1]
    seg_start = torch.cummax(torch.where(first, idx, 0), dim=0).values
    rank = idx - seg_start
    prio = torch.where(live[order1], -rank.to(torch.float32), -torch.inf)
    top1, sel1 = top_k(prio, cap - append_cap)
    kept = torch.isfinite(top1)
    compact = corrs.index(order1[sel1])
    compact = dataclasses.replace(compact, weight=torch.where(kept, compact.weight, 0.0))

    def pad(x):
        return torch.cat([x, torch.zeros((append_cap,) + x.shape[1:], dtype=x.dtype, device=dev)])

    cursor = torch.sum(kept).to(torch.int32)
    evicted = torch.sum(live).to(torch.int32) - cursor
    overflow = graph.corr_overflow + torch.clamp(evicted, min=0)
    tgt = cursor + torch.arange(sel_ok.shape[0], device=dev)  # at most append_cap candidates
    new = residuals.SparseCorrs(
        *(set_drop(pad(getattr(compact, f)), tgt, getattr(cand, f), sel_ok)
          for f in ("img_a", "img_b", "p_a", "p_b", "weight"))
    )
    return new, cursor + n_new, overflow


def global_match(graph: GlobalGraph, k_idx, cache_cam: CameraModel, cfg: BundlingConfig,
                 against_all: bool = False, slots: int | None = None) -> GlobalMatchResult:
    """Match keyframe ``k_idx`` (0-d int32, or a Python int on a host-driven
    path) against every previous keyframe, filter, and append the surviving
    correspondences to ``graph`` in place; one batched pass over the first
    ``slots`` slots (default: all K), which must hold ``k_idx`` and every
    candidate. The per-slot results are [slots]; the store's eviction and
    append width keep the capacity's, so a tier evolves it as K slots do.

    With ``against_all=True`` the candidates are every *valid* keyframe other
    than ``k_idx``, later ones included: the re-match of a stale keyframe
    after relocalization (``BundleFusion._revalidate_stale``)."""
    kmax = cfg.max_num_images
    n = kmax if slots is None else slots
    dev = graph.poses.device
    k_idx = _slot(k_idx, dev)
    # the first n slots: contiguous views of the graph's own storage
    keys = sift.SiftKeys(*(getattr(graph.keys, f.name)[:n] for f in dataclasses.fields(sift.SiftKeys)))
    caches = FrameCache(*(getattr(graph.cache, f.name)[:n] for f in dataclasses.fields(FrameCache)))
    slot_ids = torch.arange(n, device=dev)
    prev_mask = ((slot_ids != k_idx) if against_all else (slot_ids < k_idx)) & graph.valid[:n]
    new_keys = sift.SiftKeys(*(row(getattr(graph.keys, f.name), k_idx) for f in dataclasses.fields(sift.SiftKeys)))
    new_cache = FrameCache(*(row(getattr(graph.cache, f.name), k_idx) for f in dataclasses.fields(FrameCache)))

    m = matcher.match_pairs(keys.desc, keys.valid, new_keys.desc, new_keys.valid, cfg)
    pa = keys.p3d[slot_ids[:, None], m.idx_i]  # [n, M, 3]
    pb = new_keys.p3d[m.idx_j]
    m = dataclasses.replace(m, valid=m.valid & prev_mask[:, None])

    ncache = FrameCache(*(getattr(new_cache, f.name).expand(n, *getattr(new_cache, f.name).shape)
                          for f in dataclasses.fields(FrameCache)))
    res = filters.filter_pairs_batch(
        pa, pb, m, caches, ncache, cache_cam, cfg, cfg.min_matches_global, use_dense_verify=True
    )
    pair_valid = res.pair_valid & prev_mask
    any_valid = torch.any(pair_valid)
    best_prev = torch.argmax(torch.where(pair_valid, res.inlier_count, -1))

    # --- append correspondences (fixed-length block write at the cursor) ---
    fm = res.matches  # [K, Mf]
    mf = fm.valid.shape[1]
    cand_ok = (fm.valid & pair_valid[:, None]).reshape(-1)
    append_cap = min(kmax * mf, 1024, max(graph.corrs.capacity // 4, 128))
    # (fewer than append_cap candidates where n * mf is less: the rest of the
    # block is never written)
    top, sel = top_k(torch.where(cand_ok, 1.0, -torch.inf), append_cap)
    sel_ok = torch.isfinite(top)
    n_new = torch.sum(sel_ok).to(torch.int32)
    cand = residuals.SparseCorrs(
        img_a=torch.repeat_interleave(slot_ids, mf)[sel].to(torch.int32),
        img_b=k_idx.to(torch.int32).expand(sel.shape[0]),
        p_a=keys.p3d[slot_ids[:, None], fm.idx_i].reshape(-1, 3)[sel],
        p_b=new_keys.p3d[fm.idx_j].reshape(-1, 3)[sel],
        weight=torch.ones(sel.shape[0], device=dev),
    )
    # a keyframe with no surviving matches leaves the standing set untouched
    # (no compaction, no evictions): both outcomes are computed and selected
    # on the device, so the host never reads n_new
    app_corrs, app_cursor, app_overflow = _append_corrs(graph, kmax, append_cap, cand, sel_ok, n_new)
    do = n_new > 0
    corrs = residuals.SparseCorrs(
        *(torch.where(do, getattr(app_corrs, f), getattr(graph.corrs, f))
          for f in ("img_a", "img_b", "p_a", "p_b", "weight"))
    )
    new = dataclasses.replace(
        graph,
        corrs=corrs,
        corr_cursor=torch.where(do, app_cursor, graph.corr_cursor),
        corr_overflow=torch.where(do, app_overflow, graph.corr_overflow),
    )

    # --- append dense-term keyframe pairs (top overlapping prev keyframes) ---
    if cfg.dense_pairs_per_kf > 0:
        gate = pair_valid if cfg.dense_overlap_check else (
            (res.inlier_count >= cfg.min_matches_global) & prev_mask
        )
        dscore = torch.where(gate, res.inlier_count.to(torch.float32), -torch.inf)
        dtop, dsel = top_k(dscore, cfg.dense_pairs_per_kf)
        d_ok = torch.isfinite(dtop)
        dn = torch.sum(d_ok).to(torch.int32)
        dcap = graph.dense_pairs_a.shape[0]
        dslots = graph.dense_cursor + torch.arange(cfg.dense_pairs_per_kf, device=dev)
        new = dataclasses.replace(
            new,
            dense_pairs_a=set_drop(graph.dense_pairs_a, dslots, dsel.to(torch.int32), d_ok),
            dense_pairs_b=set_drop(graph.dense_pairs_b, dslots, k_idx.to(torch.int32).expand(dslots.shape[0]), d_ok),
            dense_pair_on=set_drop(graph.dense_pair_on, dslots, True, d_ok),
            dense_cursor=torch.clamp(graph.dense_cursor + dn, max=dcap),
            dense_overflow=graph.dense_overflow + torch.clamp(graph.dense_cursor + dn - dcap, min=0),
        )
    copy_into(graph, new)  # in place: the JAX step donates the graph
    return GlobalMatchResult(
        any_valid=any_valid,
        pair_valid=pair_valid,
        transforms=res.transform,
        inlier_counts=res.inlier_count,
        best_prev=best_prev,
        graph=graph,
    )


def global_solve(graph: GlobalGraph, cache_cam: CameraModel | None, cfg: BundlingConfig, stamps=None):
    """Global BA over keyframe poses + pruning; keyframe 0 is the gauge.
    Updates ``graph`` in place; returns (graph, stats, removed). With the
    dense term (``use_dense_global``) ``stats.dense_counts`` holds its
    counters (:func:`dense_counts`) and ``stamps`` (``utils/timeline``), if
    given, stamps the term in each GN iteration."""
    kmax = cfg.max_num_images
    dev = graph.poses.device
    free = graph.valid & (torch.arange(kmax, device=dev) > 0)
    dense_on = (
        graph.dense_pair_on & graph.valid[graph.dense_pairs_a.long()] & graph.valid[graph.dense_pairs_b.long()]
    )
    problem = gn.GNProblem(
        corrs=graph.corrs,
        dense_pairs_a=graph.dense_pairs_a,
        dense_pairs_b=graph.dense_pairs_b,
        dense_pair_active=dense_on,
        free_mask=free,
    )
    poses, problem, stats, removed = gn.solve_and_prune(
        graph.poses, problem, graph.cache if cfg.use_dense_global else None, cache_cam, cfg,
        gn_iters=cfg.global_gn_iters, pcg_iters=cfg.global_pcg_iters,
        use_dense=cfg.use_dense_global, prune_rounds=1, stamps=stamps,
    )
    if cfg.use_dense_global:
        stats = dataclasses.replace(stats, dense_counts=dense_counts(graph, dense_on, stats.dense_assoc))
    return _finish_global_solve(graph, poses, problem, cfg), stats, removed


def dense_counts(graph: GlobalGraph, dense_on: torch.Tensor, assoc: torch.Tensor) -> torch.Tensor:
    """The dense term's counters, [5] int32 on the device: the live pairs
    (``dense_on``); the keyframes in a live pair, as a or as b (the caches
    the term reads); the valid-depth pixels of the live pairs' first frames,
    a's, summed (the pixels a live pair projects, in each GN iteration); and
    the depth and the colour associations, summed over the GN iterations
    (``assoc``, ``SolveStats.dense_assoc``)."""
    valid_px = torch.sum(graph.cache.depth > 0.0, dim=(1, 2))  # [K] per keyframe
    a, b = graph.dense_pairs_a.long(), graph.dense_pairs_b.long()
    px = torch.sum(torch.where(dense_on, valid_px[a], 0))
    in_pair = torch.zeros_like(valid_px).index_add_(0, a, dense_on.long()).index_add_(0, b, dense_on.long())
    return torch.cat([torch.stack([torch.sum(dense_on), torch.sum(in_pair > 0), px]),
                      torch.sum(assoc, dim=0)]).to(torch.int32)


def _finish_global_solve(graph: GlobalGraph, poses, problem: gn.GNProblem, cfg: BundlingConfig) -> GlobalGraph:
    """Store poses and pruned weights in ``graph`` (in place); invalidate
    keyframes (except 0) that lost all correspondences."""
    kmax = cfg.max_num_images
    corrs = problem.corrs
    dev = poses.device
    w_ok = (corrs.weight > 0).to(torch.int32)
    has_corr = torch.zeros(kmax, dtype=torch.int32, device=dev)
    has_corr = has_corr.scatter_reduce(0, corrs.img_a.long(), w_ok, "amax")
    has_corr = has_corr.scatter_reduce(0, corrs.img_b.long(), w_ok, "amax")
    new_valid = graph.valid & ((has_corr > 0) | (torch.arange(kmax, device=dev) == 0))
    copy_into(graph, dataclasses.replace(graph, poses=poses, corrs=corrs, valid=new_valid))
    return graph


def global_solve_sharded(graph: GlobalGraph, mesh, cache_cam: CameraModel | None, cfg: BundlingConfig):
    """:func:`global_solve` with the system assembly sharded over the
    correspondences and the PCG row-sharded across ``mesh``
    (``parallel/sharded_ba.py``): the same sparse + dense terms, weight
    ramp, pruning and keyframe invalidation. Updates ``graph`` in place;
    returns (graph, removed)."""
    from ..parallel import sharded_ba

    kmax = cfg.max_num_images
    dev = graph.poses.device
    free = graph.valid & (torch.arange(kmax, device=dev) > 0)
    dense_on = (
        graph.dense_pair_on & graph.valid[graph.dense_pairs_a.long()] & graph.valid[graph.dense_pairs_b.long()]
    )
    problem = gn.GNProblem(
        corrs=graph.corrs,
        dense_pairs_a=graph.dense_pairs_a,
        dense_pairs_b=graph.dense_pairs_b,
        dense_pair_active=dense_on,
        free_mask=free,
    )
    poses, problem, removed = sharded_ba.solve_and_prune_sharded(
        mesh, graph.poses, problem, graph.cache if cfg.use_dense_global else None, cache_cam, cfg,
        gn_iters=cfg.global_gn_iters, pcg_iters=cfg.global_pcg_iters,
        use_dense=cfg.use_dense_global, prune_rounds=1,
    )
    return _finish_global_solve(graph, poses, problem, cfg), removed
