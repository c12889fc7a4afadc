"""The graph step's slot tiers (``global_graph.graph_tiers``): global
matching runs over the first T keyframe slots, T the smallest tier that
holds the chunk's keyframes, and gives what a run over every slot gives.

* the ladder: powers of two from 64 below the capacity, then the
  capacity, at the chunks either side of each tier boundary;
* ``global_match`` on one graph of 160 slots, 20 of them live keyframes
  (copies of a pipeline run's three), at the tier and at the capacity:
  the per-slot results agree on the tier's slots (the rest are the
  capacity's masked slots), and the correspondence store, its cursor and
  overflow, the dense pairs and the best match are equal; with the tiny
  configuration's store, and with a narrow one whose append block is wider
  than the tier's candidates (the block keeps the capacity's width).

128x96 at the tiny configuration with 160 keyframe slots: 13 frames
(chunks 0-2).
"""

import dataclasses

import numpy as np
import pytest
import torch

from bundlefusion_tpu_torch.bundle import global_graph as gg
from bundlefusion_tpu_torch.bundle import pipeline as tpipe
from bundlefusion_tpu_torch.bundle import step as tstep
from bundlefusion_tpu_torch.config import tiny_test_config
from bundlefusion_tpu_torch.io.synthetic import generate_sequence
from bundlefusion_tpu_torch.solver import residuals
from bundlefusion_tpu_torch.utils import graphs

CAP, KF = 160, 20  # keyframe slots, live keyframes
W, H = 128, 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LADDER = (64, 128, 256, 512, 1024, 1200)


@pytest.mark.parametrize("capacity, chunk, tier", [
    (32, 0, 32), (32, 1, 32), (32, 31, 32),
    (64, 0, 64), (64, 62, 64), (64, 63, 64),
    (100, 1, 64), (100, 63, 64), (100, 64, 100), (100, 99, 100),
    *[(1200, c, t) for lo, t in zip((0, *LADDER), LADDER) for c in (lo, t - 1)],
    (1200, 1, 64), (1200, 145, 256),
])
def test_tier_of_a_chunk(capacity, chunk, tier):
    """The smallest tier that holds chunk ``chunk``'s ``chunk + 1``
    keyframes; at chunks >= 1 the graph step's program is named by it."""
    assert gg.graph_tier(chunk, capacity) == tier
    name, slots = tstep.graph_step_program(chunk, capacity)
    if chunk == 0:
        assert (name, slots) == ("graph_step_first", 0)
    else:
        assert (name, slots) == (f"graph_step@{tier}", tier)


@pytest.mark.parametrize("capacity, tiers", [
    (32, (32,)), (64, (64,)), (65, (64, 65)), (100, (64, 100)), (128, (64, 128)), (1200, LADDER),
])
def test_ladder(capacity, tiers):
    assert gg.graph_tiers(capacity) == tiers


def _cfg():
    c = tiny_test_config()
    return dataclasses.replace(
        c, app=dataclasses.replace(c.app, input_width=W, input_height=H, integration_width=W, integration_height=H),
        bundling=dataclasses.replace(c.bundling, max_num_images=CAP))


@pytest.fixture(scope="module")
def keyframes():
    """A 3-chunk pipeline run with 160 slots: its keyframe graph, camera
    and configuration."""
    cfg = _cfg()
    seq = generate_sequence(3 * cfg.bundling.submap_size + 1, W, H, device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setenv("BF_SYNC_INGEST", "1")
    try:
        bf = tpipe.BundleFusion(seq.camera, cfg, anchor_pose=seq.poses[0], device="cpu")
    finally:
        mp.undo()
    for i in range(len(seq.poses)):
        bf.push_frame(seq.depth[i], seq.color[i])
    bf.finalize()
    assert [r["timeline"]["graph_slots"] for r in bf.runlog.records if "chunk_valid" in r] == [0, 64, 64]
    return bf.state.graph, bf.cache_cam, cfg.bundling


# the tiny configuration's store (an append block of 256 candidates, which
# a tier of 64 slots x 32 filtered matches fills), and a narrow one: one
# filtered match a pair and a 256-entry store, whose append block (128)
# is wider than a 64-slot tier's candidates
STORES = {"tiny": {}, "narrow": dict(max_matches_per_pair_filtered=1, max_residuals_global=256)}


@pytest.fixture(scope="module", params=sorted(STORES))
def graph(keyframes, request):
    """A 160-slot keyframe graph with 20 live keyframes, its camera and
    bundling configuration: slots 0-2 hold the run's keyframes (keys,
    caches, poses), slots 3-19 copy them in turn (a copy of the same
    keyframe links perfectly, another one as the scan saw it), slot 7 is
    invalid, and keyframes 3-18 are matched in turn at the capacity into an
    empty store, which fills it and evicts from it as a scan does."""
    g0, cam, bc = keyframes
    bc = dataclasses.replace(bc, **STORES[request.param])
    g = dataclasses.replace(_clone(g0), corrs=residuals.empty_corrs(bc.max_residuals_global, "cpu"))
    for t in graphs.tensors((g.corr_cursor, g.corr_overflow, g.dense_pair_on, g.dense_cursor, g.dense_overflow)):
        t.zero_()
    for t in graphs.tensors((g.keys, g.cache, g.poses)):
        t[3:KF] = t[torch.arange(3, KF) % 3]
    g.valid[:KF] = True
    g.valid[7] = False  # an invalid keyframe is never a candidate
    for k in range(3, KF - 1):
        gg.global_match(g, torch.tensor(k, dtype=torch.int32), cam, bc)
    assert int(g.corr_cursor) > g.corrs.capacity // 2 and int(g.corr_overflow) > 0 and int(g.dense_cursor) > 0
    return g, cam, bc


def _clone(graph: gg.GlobalGraph) -> gg.GlobalGraph:
    def walk(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        return type(x)(**{f.name: walk(getattr(x, f.name)) for f in dataclasses.fields(x)})

    return walk(graph)


def _store(g: gg.GlobalGraph) -> dict:
    c = g.corrs
    return dict(img_a=c.img_a, img_b=c.img_b, p_a=c.p_a, p_b=c.p_b, weight=c.weight, cursor=g.corr_cursor,
                overflow=g.corr_overflow, dense_a=g.dense_pairs_a, dense_b=g.dense_pairs_b, dense_on=g.dense_pair_on,
                dense_cursor=g.dense_cursor, dense_overflow=g.dense_overflow)


@pytest.mark.parametrize("k", (KF - 1, KF // 2))
def test_global_match_at_a_tier_equals_the_capacity(graph, k):
    """Keyframe ``k`` matched over the first 64 slots and over all 160 of
    the same graph: the same links, counts, transforms, best match, and
    the same correspondence store and dense pairs after the append."""
    g0, cam, bc = graph
    tier = gg.graph_tier(k, CAP)
    assert tier == 64 < CAP
    ga, gb = _clone(g0), _clone(g0)
    a = gg.global_match(ga, torch.tensor(k, dtype=torch.int32), cam, bc, slots=tier)
    b = gg.global_match(gb, torch.tensor(k, dtype=torch.int32), cam, bc)
    assert a.pair_valid.shape == (tier,) and b.pair_valid.shape == (CAP,)
    assert int(a.pair_valid.sum()) > 0  # the keyframe links: the comparison covers matches that pass
    assert torch.equal(a.any_valid, b.any_valid) and torch.equal(a.best_prev, b.best_prev)
    assert torch.equal(a.pair_valid, b.pair_valid[:tier]) and not b.pair_valid[tier:].any()
    assert torch.equal(a.inlier_counts, b.inlier_counts[:tier]) and not b.inlier_counts[tier:].any()
    assert torch.equal(a.transforms, b.transforms[:tier])
    assert torch.equal(b.transforms[tier:], torch.eye(4).expand(CAP - tier, 4, 4))
    sa, sb = _store(ga), _store(gb)
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name
    assert int(sa["cursor"]) > int(_store(g0)["cursor"]) or int(sa["overflow"]) > int(_store(g0)["overflow"])
    # nothing else of the graph is written
    for f in ("poses", "valid"):
        assert torch.equal(getattr(ga, f), getattr(g0, f))
    np.testing.assert_array_equal(ga.keys.desc.numpy(), g0.keys.desc.numpy())
