"""The global bundle adjustment's dense term (``use_dense_global``) against
its plain float64 reference, ``benchmark/reference/dense_ba.py``, on the
CPU at a small size: six keyframes of the synthetic room rendered at 80x60
along a seeded orbit, their 40x30 frame caches made as the pipeline makes
the 80x60 one (depth, points, normals, smoothed intensity and its
gradient), at seeded random poses (each keyframe but the first moved off
its true pose by about 0.6 degrees and 1 cm).

One parametrised test, a case each:

* ``live_and_inactive``: eight listed pairs, one of them not live; a live
  pair's blocks and counts match the reference's, an inactive one's are 0;
* ``no_overlap``: b turned away from a: no pixel associates on either side;
* ``invalid_depth``: a quarter of a's depth and a band of b's zeroed;
* ``outside_b``: b moved sideways, so that part of a projects outside b;
* ``ramp_first``, ``ramp_last``: the dense weights of GN iterations 0 and
  2 of 3 (``dense_weight_ramp``);
* ``gn_step``: one GN step of ``global_graph.global_solve`` (sparse and
  dense terms, PCG) against the reference's step solved by Cholesky;
* ``bfloat16_control``: the port's blocks from bfloat16-rounded poses and
  caches fail at least one tolerance on every live pair.

Tolerances, per live pair, ``chip_smoke.py``'s (its phase 16 holds the
card to them at 4,096 slots; a pair passes when it meets all four, and
at least 99.5% of the live pairs must pass, here all of them):

* counts of depth and colour associations within 0.2% of the reference's
  (at least one pixel): the port's float32 tests flip only pixels whose
  distance, normal or colour test lies within float32 rounding of its
  threshold (none here);
* JtJ within 1e-4 relative Frobenius error: float32 rounding of sums of
  ~1,000 per-pixel products (measured here: <= 3.4e-7);
* Jtr within 1e-3: its per-pixel terms carry the residual's sign and
  largely cancel, so the sum's relative error exceeds each term's (measured
  here: <= 2.6e-5);
* poses after the GN step within 2e-5 (rotation entries, metres; the
  pipeline parity tests' pose bar): PCG's float32 iterations against an
  exact solve (measured here: 4.2e-7, of a step of 1.6e-2).

The bfloat16 control reads 7e-3 to 6e-2 on JtJ, 0.13 to 0.82 on Jtr and
counts up to 29 allowances off.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference import dense_ba as ref
from chip_smoke import DENSE_PAIR_SHARE, dense_pair_errors, dense_pairs_within
from bundlefusion_tpu_torch.bundle import global_graph
from bundlefusion_tpu_torch.config import BundlingConfig
from bundlefusion_tpu_torch.io.synthetic import _camera, orbit_poses, render_sequence
from bundlefusion_tpu_torch.ops.preprocess import FrameCache, preprocess_frames
from bundlefusion_tpu_torch.solver import residuals

K = 6  # keyframes
POSE_TOL = 2e-5
PAIRS_A = [0, 0, 1, 1, 2, 3, 4, 0]
PAIRS_B = [1, 2, 2, 3, 3, 4, 5, 5]
CFG = BundlingConfig(max_num_images=8, max_residuals_global=256, max_dense_pairs_global=16, global_gn_iters=1,
                     global_pcg_iters=64, use_dense_global=True, cache_width=40, cache_height=30, verify_width=40,
                     verify_height=30)
CASES = ("live_and_inactive", "no_overlap", "invalid_depth", "outside_b", "ramp_first", "ramp_last", "gn_step",
         "bfloat16_control")


@pytest.fixture(scope="module")
def scene():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        truth = orbit_poses(3 * K, seed=1)[::3].astype(np.float32)
        cam = _camera(80, 60)
        seq = render_sequence(truth, cam, "cpu")
        ccam = cam.scaled(40, 30)
        _, cache = preprocess_frames(torch.as_tensor(seq.depth), torch.as_tensor(seq.color), cam, ccam)
    finally:
        torch.set_num_threads(n)
    rng = np.random.default_rng(7)
    poses = torch.as_tensor(truth).clone()
    for k in range(1, K):
        poses[k] = _moved(poses[k], rng.normal(scale=0.006, size=3), rng.normal(scale=0.006, size=3))
    return torch.as_tensor(truth), poses, cache, ccam


def _moved(T, rotvec, shift):
    """T moved on the left by a rotation (``rotvec``) and a shift."""
    R = ref.se3_exp(torch.as_tensor(np.concatenate([rotvec, shift]))[None])[0].to(T.dtype)
    return R @ T


def _with_b_copies(poses, cache, move):
    """The keyframes followed by copies of them whose poses ``move(T)``
    gives: pair (a, b + K) then has b moved and a not."""
    moved = torch.stack([move(T) for T in poses])
    return torch.cat([poses, moved]), FrameCache(*(torch.cat([x, x]) for x in (
        cache.depth, cache.points, cache.normals, cache.intensity, cache.grad)))


def _ref_cache(cache: FrameCache) -> ref.Cache:
    return ref.Cache(cache.depth, cache.points, cache.normals, cache.intensity, cache.grad)


def _blocks(poses, cache, ccam, live, i=0, n=1, shift_b=0):
    """The port's and the reference's blocks of the listed pairs at GN
    iteration ``i`` of ``n``, b's index moved by ``shift_b``."""
    pa, pb = torch.tensor(PAIRS_A, dtype=torch.int32), torch.tensor(PAIRS_B, dtype=torch.int32) + shift_b
    scale = np.float32(i + 1) / np.float32(n) if n > 1 else np.float32(1.0)
    port = residuals.dense_pair_blocks(poses, pa, pb, live, cache, ccam, CFG,
                                       float(np.float32(CFG.weight_dense_depth) * scale),
                                       float(np.float32(CFG.weight_dense_color) * scale))
    prm = ref.Params(dataclasses.asdict(CFG))
    want = ref.pairs_in_blocks(poses.double(), pa, pb, _ref_cache(cache), ref.Camera(*ccam), prm, prm.scale(i, n))
    return port, want


def _errors(port, want, live) -> np.ndarray:
    """Per live pair: each count's difference over its allowance, JtJ's and
    Jtr's relative Frobenius errors (``chip_smoke.dense_pair_errors``)."""
    JtJ, Jtr, st = port
    keep = ref.PairTerms(want.JtJ[live], want.Jtr[live], want.n_depth[live], want.n_color[live])
    return dense_pair_errors(torch, JtJ[live], Jtr[live], st.num_valid_depth[live], st.num_valid_color[live], keep)


def _graph(truth, poses, cache, rng):
    """A graph of K keyframes at ``poses``: every listed pair dense and 24
    exact correspondences (at the true poses) between each pair."""
    g = global_graph.make_graph(CFG, 30, 40, "cpu")
    for f in dataclasses.fields(FrameCache):
        getattr(g.cache, f.name)[:K] = getattr(cache, f.name)
    g.poses[:K] = poses
    g.valid[:K] = True
    r = 0
    for a, b in zip(PAIRS_A, PAIRS_B):
        px = rng.choice(np.flatnonzero(cache.depth[a].reshape(-1).numpy() > 0), 24, replace=False)
        p_a = cache.points[a].reshape(-1, 3)[px]
        rel = torch.linalg.inv(truth[b]) @ truth[a]
        g.corrs.img_a[r:r + 24], g.corrs.img_b[r:r + 24] = a, b
        g.corrs.p_a[r:r + 24], g.corrs.p_b[r:r + 24] = p_a, p_a @ rel[:3, :3].T + rel[:3, 3]
        g.corrs.weight[r:r + 24] = 1.0
        r += 24
    n = len(PAIRS_A)
    g.dense_pairs_a[:n], g.dense_pairs_b[:n] = torch.tensor(PAIRS_A), torch.tensor(PAIRS_B)
    g.dense_pair_on[:n] = True
    g.dense_cursor.fill_(n)
    return g


@pytest.mark.parametrize("case", CASES)
def test_dense_term_matches_the_reference(scene, case):
    truth, poses, cache, ccam = scene
    live = torch.ones(len(PAIRS_A), dtype=torch.bool)
    i, n, shift_b = 0, 1, 0
    if case == "live_and_inactive":
        live[3] = False
    elif case == "no_overlap":  # b turned half a turn about its own vertical axis
        poses, cache = _with_b_copies(poses, cache, lambda T: torch.cat(
            [T[:, :3] @ torch.diag(torch.tensor([-1.0, 1.0, -1.0])), T[:, 3:]], 1))
        shift_b = K
    elif case == "invalid_depth":
        cache = FrameCache(*(x.clone() for x in (cache.depth, cache.points, cache.normals, cache.intensity,
                                                  cache.grad)))
        cache.depth[:, :15, :20] = 0.0  # a quarter of every frame, as a's
        cache.depth[:, :, 26:32] = 0.0  # a band, as b's
    elif case == "outside_b":  # b moved 25 cm along its own x axis
        poses, cache = _with_b_copies(poses, cache, lambda T: _moved(T, np.zeros(3), T[:3, 0].numpy() * 0.25))
        shift_b = K
    elif case in ("ramp_first", "ramp_last"):
        i, n = (0, 3) if case == "ramp_first" else (2, 3)
    elif case == "gn_step":
        rng = np.random.default_rng(11)
        g = _graph(truth, poses, cache, rng)
        sparse = (g.corrs.img_a.clone(), g.corrs.img_b.clone(), g.corrs.p_a.clone(), g.corrs.p_b.clone(),
                  g.corrs.weight.clone())
        pairs = (g.dense_pairs_a.clone(), g.dense_pairs_b.clone(), g.dense_pair_on.clone())
        free = g.valid.clone() & (torch.arange(CFG.max_num_images) > 0)
        caches = _ref_cache(FrameCache(*(getattr(g.cache, f.name).clone() for f in dataclasses.fields(FrameCache))))
        before = g.poses.clone()
        want = ref.gn_step(before, free, sparse, pairs, caches, ref.Camera(*ccam), ref.Params(dataclasses.asdict(CFG)))
        _, stats, _ = global_graph.global_solve(g, ccam, CFG)
        err = float((g.poses.double() - want).abs().max())
        moved = float((want - before.double()).abs().max())
        print(f"GN step: max |port - reference| {err:.3g} of a step of {moved:.3g}")
        assert moved > 100 * POSE_TOL and err <= POSE_TOL
        # the counters: live pairs, their keyframes, a's valid pixels, and
        # the associations of the one iteration, the reference's
        prm = ref.Params(dataclasses.asdict(CFG))
        terms = ref.pairs_in_blocks(before.double(), torch.tensor(PAIRS_A), torch.tensor(PAIRS_B), caches,
                                    ref.Camera(*ccam), prm, prm.scale(0, 1))
        assert stats.dense_assoc.tolist() == [[int(terms.n_depth.sum()), int(terms.n_color.sum())]]
        assert stats.dense_counts.tolist() == [len(PAIRS_A), len(set(PAIRS_A + PAIRS_B)),
                                               int(sum((cache.depth[a] > 0).sum() for a in PAIRS_A)),
                                               *stats.dense_assoc.sum(0).tolist()]
        return

    if case == "bfloat16_control":
        def bf16(x):
            return x.to(torch.bfloat16).to(torch.float32)
        rounded = FrameCache(*(bf16(x) for x in (cache.depth, cache.points, cache.normals, cache.intensity,
                                                  cache.grad)))
        port, _ = _blocks(bf16(poses), rounded, ccam, live)
        _, want = _blocks(poses, cache, ccam, live)
        errs = _errors(port, want, live)
        print("bfloat16: max over the live pairs", errs.max(axis=0), "min", errs.min(axis=0))
        assert dense_pairs_within(errs).mean() < DENSE_PAIR_SHARE and not dense_pairs_within(errs).any()
        return

    port, want = _blocks(poses, cache, ccam, live, i, n, shift_b)
    errs = _errors(port, want, live)
    print(case, "max over the live pairs", errs.max(axis=0))
    assert dense_pairs_within(errs).all(), errs
    JtJ, Jtr, st = port
    off = ~live
    assert not JtJ[off].any() and not Jtr[off].any() and not st.num_valid_depth[off].any()
    n_depth = want.n_depth[live].tolist()
    if case == "no_overlap":
        assert n_depth == [0] * len(n_depth) and not JtJ.any()
    else:
        assert min(n_depth) > 100
    if case in ("invalid_depth", "outside_b"):
        _, full = _blocks(scene[1], scene[2], ccam, live)
        assert all(int(a) < int(b) for a, b in zip(want.n_depth, full.n_depth))
