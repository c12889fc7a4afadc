"""SIFT, matcher and filters: the port against the JAX package on the same
preprocessed chunk (128x96 frames, tiny config). Bars: key counts exact, key
xy and descriptors within 1e-4 (``tests/test_golden.py``); match sets equal
except matches whose ratio or distance test lies within bf16 error of its
threshold (counted and printed); pair validity equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.config import tiny_test_config as j_tiny
from bundlefusion_tpu.features import filters as jf
from bundlefusion_tpu.features import matcher as jm
from bundlefusion_tpu.features import sift as js
from bundlefusion_tpu.ops import preprocess as jpp
from bundlefusion_tpu_torch import interop
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.features import filters as tf
from bundlefusion_tpu_torch.features import matcher as tm
from bundlefusion_tpu_torch.features import sift as ts
from bundlefusion_tpu_torch.io.framewire import frame_to_wire2
from bundlefusion_tpu_torch.ops.preprocess import FrameCache
from util import cached_sequence

BC_J = j_tiny().bundling
BC_T = t_tiny().bundling
NF = 5


@pytest.fixture(scope="module")
def chunk():
    seq = cached_sequence(NF, width=128, height=96)
    cam = seq.camera
    cc = cam.scaled(BC_J.cache_width, BC_J.cache_height)
    w = [frame_to_wire2(seq.depth[i], seq.color[i], depth_min=0.1, depth_max=4.0) for i in range(NF)]
    frames, cache = jpp.preprocess_frames_y(
        jnp.asarray(np.stack([x[0] for x in w])), jnp.asarray(np.stack([x[1] for x in w])), cam, cc
    )
    keys = js.detect_batch(frames.intensity, frames.depth, cam, BC_J)
    pa, pb = np.triu_indices(NF, 1)
    return dict(
        cam=cam, cc=cc, intensity=np.asarray(frames.intensity), depth=np.asarray(frames.depth),
        keys=jax.tree.map(np.asarray, keys), cache=jax.tree.map(np.asarray, cache),
        pa=pa.astype(np.int32), pb=pb.astype(np.int32),
    )


def test_sift_matches_jax(chunk):
    c = chunk
    kt = ts.detect_batch(torch.as_tensor(c["intensity"]), torch.as_tensor(c["depth"]), c["cam"], BC_T)
    kj = c["keys"]
    assert kj.valid.sum() > 100
    np.testing.assert_array_equal(kj.valid.sum(-1), kt.valid.sum(-1).numpy())
    np.testing.assert_array_equal(kj.valid, kt.valid.numpy())
    np.testing.assert_allclose(kj.xy, kt.xy.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(kj.desc, kt.desc.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(kj.p3d, kt.p3d.numpy(), atol=1e-4, rtol=0)


def _near_threshold(desc_i, desc_j, i, cfg, eps=2e-2):
    """Is key i's ratio or distance test within bf16 error of its threshold?"""
    sim = desc_i[i].astype(np.float64) @ desc_j.T.astype(np.float64)
    s = np.sort(sim)[::-1]
    d1, d2 = np.sqrt(max(2 - 2 * s[0], 0)), np.sqrt(max(2 - 2 * s[1], 0))
    return abs(d1 - cfg.match_ratio_thresh * d2) < eps or abs(d1 - cfg.match_dist_thresh) < eps


def test_matcher_matches_jax(chunk):
    c = chunk
    kj = c["keys"]
    mj = jm.match_all_pairs(jax.tree.map(jnp.asarray, kj), jnp.asarray(c["pa"]), jnp.asarray(c["pb"]), BC_J)
    kt = interop.state_from_numpy(kj, "cpu")
    mt = tm.match_all_pairs(kt, torch.as_tensor(c["pa"]).long(), torch.as_tensor(c["pb"]).long(), BC_T)
    exceptions = 0
    total = 0
    for p in range(len(c["pa"])):
        sj = {(int(a), int(b)) for a, b, v in zip(mj.idx_i[p], mj.idx_j[p], mj.valid[p]) if v}
        st = {(int(a), int(b)) for a, b, v in zip(mt.idx_i[p], mt.idx_j[p], mt.valid[p]) if v}
        total += len(sj)
        for a, _ in sj ^ st:
            assert _near_threshold(kj.desc[c["pa"][p]], kj.desc[c["pb"][p]], a, BC_J)
            exceptions += 1
    print(f"matches: {total} (JAX), near-threshold differences: {exceptions}")
    assert total > 50


def test_filters_match_jax(chunk):
    c = chunk
    kj = jax.tree.map(jnp.asarray, c["keys"])
    pa, pb = jnp.asarray(c["pa"]), jnp.asarray(c["pb"])
    m = jm.match_all_pairs(kj, pa, pb, BC_J)
    xa, xb = jm.gather_match_points(kj, pa, pb, m)
    cache = jax.tree.map(jnp.asarray, c["cache"])
    ca = jax.tree.map(lambda x: x[pa], cache)
    cb = jax.tree.map(lambda x: x[pb], cache)
    rj = jf.filter_pairs_batch(xa, xb, m, ca, cb, c["cc"], BC_J, BC_J.min_matches_local)

    tcache = interop.state_from_numpy(c["cache"], "cpu")
    tpa, tpb = torch.as_tensor(c["pa"]).long(), torch.as_tensor(c["pb"]).long()
    mt = tm.PairMatches(*(torch.as_tensor(np.asarray(x)) for x in m))
    rt = tf.filter_pairs_batch(
        torch.as_tensor(np.asarray(xa)), torch.as_tensor(np.asarray(xb)), mt,
        FrameCache.index(tcache, tpa), FrameCache.index(tcache, tpb), c["cc"], BC_T, BC_T.min_matches_local,
    )
    np.testing.assert_array_equal(np.asarray(rj.pair_valid), rt.pair_valid.numpy())
    np.testing.assert_array_equal(np.asarray(rj.inlier_count), rt.inlier_count.numpy())
    np.testing.assert_array_equal(np.asarray(rj.matches.valid), rt.matches.valid.numpy())
    np.testing.assert_array_equal(np.asarray(rj.matches.idx_i), rt.matches.idx_i.numpy())
    np.testing.assert_allclose(np.asarray(rj.transform), rt.transform.numpy(), atol=1e-4, rtol=0)
    assert int(rt.pair_valid.sum()) >= 4


@pytest.mark.parametrize("pair", [0, 3, 9])
def test_filter_pair_matches_jax(chunk, pair):
    """One pair through ``filter_pair`` on both sides (exact masks and counts,
    transform within 1e-5), and the port's single pair equal to its row of
    the batched filter."""
    c = chunk
    kj = jax.tree.map(jnp.asarray, c["keys"])
    a, b = int(c["pa"][pair]), int(c["pb"][pair])
    ka, kb = jax.tree.map(lambda x: x[a], kj), jax.tree.map(lambda x: x[b], kj)
    m = jm.match_pair(ka, kb, BC_J)
    cache = jax.tree.map(jnp.asarray, c["cache"])
    rj = jf.filter_pair(ka.p3d[m.idx_i], kb.p3d[m.idx_j], m, jax.tree.map(lambda x: x[a], cache),
                        jax.tree.map(lambda x: x[b], cache), c["cc"], BC_J, BC_J.min_matches_local)

    tcache = interop.state_from_numpy(c["cache"], "cpu")
    mt = tm.PairMatches(*(torch.as_tensor(np.array(x)) for x in m))
    pa = torch.as_tensor(np.asarray(ka.p3d[m.idx_i]))
    pb = torch.as_tensor(np.asarray(kb.p3d[m.idx_j]))
    rt = tf.filter_pair(pa, pb, mt, FrameCache.index(tcache, a), FrameCache.index(tcache, b), c["cc"], BC_T,
                        BC_T.min_matches_local)
    assert bool(rj.pair_valid) == bool(rt.pair_valid)
    assert int(rj.inlier_count) == int(rt.inlier_count)
    for k in ("valid", "idx_i", "idx_j"):
        np.testing.assert_array_equal(np.asarray(getattr(rj.matches, k)), getattr(rt.matches, k).numpy())
    np.testing.assert_allclose(np.asarray(rj.transform), rt.transform.numpy(), atol=1e-5, rtol=0)
    mb = tm.PairMatches(*(x[None] for x in (mt.idx_i, mt.idx_j, mt.dist, mt.valid)))
    rb = tf.filter_pairs_batch(pa[None], pb[None], mb, FrameCache.index(tcache, [a]), FrameCache.index(tcache, [b]),
                               c["cc"], BC_T, BC_T.min_matches_local)
    assert torch.equal(rb.transform[0], rt.transform) and torch.equal(rb.matches.idx_i[0], rt.matches.idx_i)
