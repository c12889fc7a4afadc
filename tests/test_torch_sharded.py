"""The serial pipeline with a mesh: global BA sharded over 8 CPU shards
(``global_graph.global_solve_sharded``), the port against the JAX package on
its 8 simulated devices, on 13 frames (3 chunks) at 128x96 with the tiny
configuration (``max_num_images`` 32, so 6N = 192 rows divide over 8).

Bars: validity equal and poses within 2e-5, the pipeline's bar (ROADMAP
Queue 3: the global solves' f32 sums in another order stop at PCG's gate);
on one keyframe graph carried across by ``interop``, the port's sharded
solve within 2e-5 of the JAX package's sharded solve with equal validity,
and within the JAX package's own 1e-3 of the port's serial solve
(``tests/test_parallel.py``); the same with the dense terms
(``use_dense_global``) on a 2-shard mesh, within 2e-5 of the JAX package's
and apart from the sparse-only solve.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from bundlefusion_tpu.bundle import global_graph as jgg
from bundlefusion_tpu.bundle.pipeline import BundleFusion as JBundleFusion
from bundlefusion_tpu.config import tiny_test_config as j_tiny
from bundlefusion_tpu.io import framewire as jfw
from bundlefusion_tpu.parallel import mesh as jmesh
from bundlefusion_tpu_torch import interop
from bundlefusion_tpu_torch.bundle import global_graph as tgg
from bundlefusion_tpu_torch.bundle.pipeline import BundleFusion
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.parallel.mesh import make_mesh
from util import cached_sequence

W, H, N = 128, 96, 13


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tiny):
    c = tiny()
    return dataclasses.replace(c, app=dataclasses.replace(c.app, input_width=W, input_height=H,
                                                          integration_width=W, integration_height=H))


def _run(bf, seq):
    for i in range(N):
        bf.push_frame(seq.depth[i], seq.color[i])
    bf.flush()
    return bf, bf.outputs()


@pytest.fixture(scope="module")
def runs():
    seq = cached_sequence(N, width=W, height=H)
    mp = pytest.MonkeyPatch()
    mp.setattr(jfw, "_load", lambda: None)
    try:
        j = _run(JBundleFusion(seq.camera, _cfg(j_tiny), anchor_pose=seq.poses[0], mesh=jmesh.make_mesh(8)), seq)
    finally:
        mp.undo()
    t = _run(BundleFusion(seq.camera, _cfg(t_tiny), anchor_pose=seq.poses[0], mesh=make_mesh(8, "cpu"),
                          device="cpu"), seq)
    return j, t


def test_pipeline_with_mesh_matches_jax(runs):
    (bj, oj), (bt, ot) = runs
    assert ot.num_keyframes == oj.num_keyframes == 3
    np.testing.assert_array_equal(oj.valid, ot.valid)
    assert ot.valid.all()
    err = float(np.abs(oj.poses - ot.poses).max())
    print(f"pipeline with an 8-shard mesh: max |pose jax - port| {err:.3g}")
    assert err <= 2e-5
    chunks_j = [r for r in bj.runlog.records if "chunk" in r]
    chunks_t = [r for r in bt.runlog.records if "chunk" in r]
    for a, b in zip(chunks_j, chunks_t):
        for k in ("chunk_valid", "kf_valid", "reloc", "num_keys", "pairs_valid"):
            assert a[k] == b[k], (a["chunk"], k)


def test_global_solve_sharded_matches_jax(runs):
    """One graph (the JAX run's, carried across) solved by both sharded
    solvers, and by the port's serial solver."""
    (bj, _), (bt, _) = runs
    cfg_j, cfg_t = _cfg(j_tiny).bundling, _cfg(t_tiny).bundling
    # move keyframes 1 and 2 off the converged solution, so the solves work
    poses = np.asarray(bj.graph.poses).copy()
    poses[1:3, :3, 3] += np.array([[0.01, -0.005, 0.004], [-0.006, 0.008, 0.003]], np.float32)
    graph = bj.graph._replace(poses=poses)
    graph_t = interop.state_from_numpy(graph, "cpu")
    gj, _ = jgg.global_solve_sharded(graph, jmesh.make_mesh(8), bj.cache_cam, cfg_j)
    gs, removed = tgg.global_solve_sharded(graph_t, make_mesh(8, "cpu"), bt.cache_cam, cfg_t)
    np.testing.assert_array_equal(np.asarray(gj.valid), gs.valid.numpy())
    err = float(np.abs(np.asarray(gj.poses) - gs.poses.numpy()).max())
    print(f"global_solve_sharded on one graph: max |pose jax - port| {err:.3g}")
    assert err <= 2e-5
    np.testing.assert_array_equal(np.asarray(gj.corrs.weight), gs.corrs.weight.numpy())
    assert float(np.abs(gs.poses.numpy() - poses).max()) > 1e-3  # the solve moved them
    g1, _, _ = tgg.global_solve(interop.state_from_numpy(graph, "cpu"), bt.cache_cam, cfg_t)
    np.testing.assert_array_equal(g1.valid.numpy(), gs.valid.numpy())
    np.testing.assert_allclose(g1.poses.numpy(), gs.poses.numpy(), atol=1e-3, rtol=0)
    assert removed.dtype == torch.int32


def test_dense_global_solve_sharded_matches_jax(runs):
    """The sharded global solve with its dense terms on a 2-shard mesh, the
    port against the JAX package on one graph carried across: the JAX run's,
    keyframes 1 and 2 moved, its dense-pair list (3 live pairs) cut to its
    first 64 slots, since every GN iteration evaluates every slot. Validity
    and pruned weights equal, poses within 2e-5; the dense terms move the
    solution away from the sparse-only solve."""
    (bj, _), (bt, _) = runs
    cut = 64
    cfg_j, cfg_t = (dataclasses.replace(_cfg(tiny).bundling, use_dense_global=True, max_dense_pairs_global=cut)
                    for tiny in (j_tiny, t_tiny))
    g = jax.tree_util.tree_map(np.asarray, bj.graph)  # off the run's 8-device mesh
    poses = g.poses.copy()
    poses[1:3, :3, 3] += np.array([[0.01, -0.005, 0.004], [-0.006, 0.008, 0.003]], np.float32)
    graph = g._replace(poses=poses, dense_pairs_a=g.dense_pairs_a[:cut], dense_pairs_b=g.dense_pairs_b[:cut],
                       dense_pair_on=g.dense_pair_on[:cut])
    assert int(graph.dense_cursor) == int(np.asarray(graph.dense_pair_on).sum()) == 3
    gj, _ = jgg.global_solve_sharded(graph, jmesh.make_mesh(2), bj.cache_cam, cfg_j)
    mesh = make_mesh(2, "cpu")
    gs, _ = tgg.global_solve_sharded(interop.state_from_numpy(graph, "cpu"), mesh, bt.cache_cam, cfg_t)
    np.testing.assert_array_equal(np.asarray(gj.valid), gs.valid.numpy())
    np.testing.assert_array_equal(np.asarray(gj.corrs.weight), gs.corrs.weight.numpy())
    err = float(np.abs(np.asarray(gj.poses) - gs.poses.numpy()).max())
    sparse, _ = tgg.global_solve_sharded(interop.state_from_numpy(graph, "cpu"), mesh, bt.cache_cam,
                                         dataclasses.replace(cfg_t, use_dense_global=False))
    moved = float(np.abs(sparse.poses.numpy() - gs.poses.numpy()).max())
    print(f"dense global_solve_sharded on 2 shards: max |pose jax - port| {err:.3g}; dense against sparse-only "
          f"{moved:.3g}")
    assert err <= 2e-5
    assert moved > 1e-6
