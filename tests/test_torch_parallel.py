"""Multi-device execution on CPU meshes: the port's mesh and collectives, its
sharded assembly and row-sharded PCG, and the chunk fan-outs, against the
JAX package on its simulated CPU devices (``tests/conftest.py``).

Bars: sharded assembly within 1e-5 (plus 1e-6 relative: the entries reach
~1e3) and PCG within 1e-5 of the JAX package's at 8 shards;
the sparse sharded GN recovers the poses and agrees with the serial one
to the JAX package's own 1e-3 (``tests/test_parallel.py``); the
multi-sequence and time-sharded chunk fan-outs against the JAX package's
``process_chunk`` per sequence / chunk with the chunk bars of
``test_torch_pipeline.py`` (validity equal, local poses within 1e-4); the
keyframe chaining equal; the per-shard fusion with equal block key sets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.bundle.chunk import process_chunk as j_process_chunk
from bundlefusion_tpu.config import tiny_test_config as j_tiny
from bundlefusion_tpu.fusion import blocks as jblocks
from bundlefusion_tpu.geometry import se3 as jse3
from bundlefusion_tpu.parallel import mesh as jmesh
from bundlefusion_tpu.parallel import multiseq as jmultiseq
from bundlefusion_tpu.parallel import sharded_ba as jsba
from bundlefusion_tpu.parallel import timeshard as jtimeshard
from bundlefusion_tpu_torch import interop
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.fusion import blocks as tblocks
from bundlefusion_tpu_torch.parallel import mesh as tmesh
from bundlefusion_tpu_torch.parallel import multiseq as tmultiseq
from bundlefusion_tpu_torch.parallel import sharded_ba as tsba
from bundlefusion_tpu_torch.parallel import timeshard as ttimeshard
from test_solver import make_sparse_problem
from util import cached_sequence

W, H = 128, 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mesh_and_collectives():
    m = tmesh.make_mesh(3, "cpu")
    assert m.size == 3 and all(d.type == "cpu" for d in m.devices)
    assert "3 shards share 1 device" in repr(m)
    parts = [torch.full((2,), float(i + 1)) for i in range(3)]
    assert all(torch.equal(x, torch.full((2,), 6.0)) for x in tmesh.psum(m, parts))
    assert torch.equal(tmesh.all_gather(m, parts), torch.cat(parts))
    # the timeshard ring: shard i receives shard i+1's tensor
    got = tmesh.ppermute(m, parts, [(i, (i - 1) % 3) for i in range(3)])
    assert [float(x[0]) for x in got] == [2.0, 3.0, 1.0]
    assert [float(x[0]) for x in tmesh.ppermute(m, parts, [(0, 1)])] == [0.0, 1.0, 0.0]
    with pytest.raises(ValueError):
        tmesh.make_mesh(0, "cpu")


def _problem(seed, noise_xi=0.05):
    rng = np.random.default_rng(seed)
    poses_gt, problem = make_sparse_problem(rng, n_images=4, n_corr=96)
    xi = (rng.standard_normal((4, 6)) * noise_xi).astype(np.float32)
    xi[0] = 0
    init = np.einsum("nij,njk->nik", np.asarray(jse3.se3_exp(jnp.asarray(xi))), poses_gt).astype(np.float32)
    return poses_gt, init, problem


def test_sharded_assembly_matches_jax():
    _, init, problem = _problem(11)
    H_j, b_j = jsba.assemble_system_sharded(jmesh.make_mesh(8), 4, problem.corrs, jnp.asarray(init),
                                            problem.free_mask, 1.0)
    H_t, b_t = tsba.assemble_system_sharded(
        tmesh.make_mesh(8, "cpu"), 4, interop.state_from_numpy(problem.corrs, "cpu"), torch.as_tensor(init),
        torch.as_tensor(np.asarray(problem.free_mask)), 1.0,
    )
    # entries reach ~1e3, where one f32 ulp of another summation order is
    # 6e-5: the bar is 1e-5 absolute plus 1e-6 relative
    np.testing.assert_allclose(np.asarray(H_j), H_t.numpy(), atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(b_j), b_t.numpy(), atol=1e-5, rtol=1e-6)
    assert float(b_t.abs().max()) > 1e-2  # the perturbed poses leave a real right-hand side


def test_pcg_rowsharded_matches_jax():
    rng = np.random.default_rng(12)
    n = 96  # 6N rows, divisible by 8
    A = rng.standard_normal((n, n)).astype(np.float32)
    Hm = (A @ A.T / n + np.eye(n, dtype=np.float32)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    x_j = jsba.pcg_solve_rowsharded(jmesh.make_mesh(8), jnp.asarray(Hm), jnp.asarray(b), 60)
    x_t = tsba.pcg_solve_rowsharded(tmesh.make_mesh(8, "cpu"), torch.as_tensor(Hm), torch.as_tensor(b), 60)
    np.testing.assert_allclose(np.asarray(x_j), x_t.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(Hm @ x_t.numpy(), b, atol=1e-3, rtol=0)


def test_sparse_sharded_gn_recovers_poses():
    """The sparse-only sharded GN (the JAX package's test of it): it recovers
    the poses and agrees with the port's serial sparse GN to the JAX test's
    1e-3."""
    from bundlefusion_tpu_torch.solver import gn as tgn

    poses_gt, init, problem = _problem(13)
    cfg = t_tiny().bundling
    corrs = interop.state_from_numpy(problem.corrs, "cpu")
    free = torch.as_tensor(np.asarray(problem.free_mask))
    got = tsba.global_solve_sharded(tmesh.make_mesh(8, "cpu"), torch.as_tensor(init), corrs, free, cfg,
                                    gn_iters=4, pcg_iters=48)
    assert float(np.abs(got.numpy()[:, :3, 3] - poses_gt[:, :3, 3]).max()) < 2e-3
    tp = tgn.GNProblem(corrs, torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=torch.int32),
                       torch.zeros(1, dtype=torch.bool), free)
    serial, _ = tgn.solve_gn(torch.as_tensor(init), tp, None, None, cfg, 4, 48, use_dense=False)
    np.testing.assert_allclose(got.numpy(), serial.numpy(), atol=1e-3, rtol=0)


def test_shard_counts_must_divide():
    m5 = tmesh.make_mesh(5, "cpu")
    with pytest.raises(ValueError, match="divide"):
        tsba.pcg_solve_rowsharded(m5, torch.eye(96), torch.ones(96), 4)
    _, init, problem = _problem(14)
    with pytest.raises(ValueError, match="correspondences"):
        tsba.assemble_system_sharded(m5, 4, interop.state_from_numpy(problem.corrs, "cpu"), torch.as_tensor(init),
                                     torch.ones(4, dtype=torch.bool), 1.0)


def _chunk_cfgs():
    return j_tiny().bundling, t_tiny().bundling


def _check_chunk(ref, traj_t, valid_t):
    assert bool(ref.chunk_valid) == bool(valid_t)
    np.testing.assert_allclose(np.asarray(ref.local_traj), traj_t.numpy(), atol=1e-4, rtol=0)


def test_multiseq_chunk_fanout_matches_jax():
    """Two sequences, one chunk each, one per shard."""
    jc, tc = _chunk_cfgs()
    s1 = jc.chunk_size
    seqs = [cached_sequence(s1, width=W, height=H, seed=i) for i in range(2)]
    cam = seqs[0].camera
    cc = cam.scaled(jc.cache_width, jc.cache_height)
    depth = np.stack([s.depth for s in seqs])
    color = np.stack([s.color for s in seqs])
    trajs, valid = tmultiseq.make_multiseq_chunk_fn(tmesh.make_mesh(2, "cpu"), cam, cc, tc)(depth, color)
    assert tuple(trajs.shape) == (2, s1, 4, 4) and bool(valid.all())
    for i in range(2):
        _check_chunk(j_process_chunk(jnp.asarray(depth[i]), jnp.asarray(color[i]), cam, cc, jc), trajs[i], valid[i])


def test_timeshard_chunk_fanout_matches_jax():
    """Two chunks of one sequence in parallel: shard 0's overlap frame comes
    from shard 1 by the ring exchange, shard 1's is the tail frame."""
    jc, tc = _chunk_cfgs()
    S, D = jc.submap_size, 2
    seq = cached_sequence(D * S + 1, width=W, height=H, radius=0.3)
    cam = seq.camera
    cc = cam.scaled(jc.cache_width, jc.cache_height)
    fn = ttimeshard.make_timeshard_chunk_fn(tmesh.make_mesh(D, "cpu"), cam, cc, tc)
    trajs, valid, keys, caches = fn(seq.depth[: D * S], seq.color[: D * S], seq.depth[D * S], seq.color[D * S])
    assert tuple(trajs.shape) == (D, S + 1, 4, 4) and keys.valid.shape[0] == D and caches.depth.shape[0] == D
    for d in range(D):
        ref = j_process_chunk(jnp.asarray(seq.depth[d * S : d * S + S + 1]),
                              jnp.asarray(seq.color[d * S : d * S + S + 1]), cam, cc, jc)
        _check_chunk(ref, trajs[d], valid[d])
        assert int(np.asarray(ref.keyframe_keys.valid).sum()) == int(keys.valid[d].sum())
        np.testing.assert_allclose(np.asarray(ref.keyframe_cache.depth), caches.depth[d].numpy(), atol=1e-5, rtol=0)
    chained = ttimeshard.chain_keyframe_poses(trajs.numpy(), seq.poses[0])
    assert np.array_equal(chained, jtimeshard.chain_keyframe_poses(trajs.numpy(), seq.poses[0]))
    assert np.abs(chained[:, :3, 3] - seq.poses[::S][:D, :3, 3]).max() < 0.02


def test_multiseq_fusion_matches_jax():
    """Each shard fuses its sequence's frame into its own block table."""
    ja, ta = j_tiny().app, t_tiny().app
    n = 2
    seqs = [cached_sequence(2, width=64, height=48, seed=i) for i in range(n)]
    cam = seqs[0].camera
    depth = np.stack([s.depth[0] for s in seqs])
    color = np.stack([s.color[0] for s in seqs])
    poses = np.stack([s.poses[0] for s in seqs])
    jt = jmultiseq.make_multiseq_fusion_fn(jmesh.make_mesh(n), cam, ja)(
        jmultiseq.stack_tables([jblocks.make_table(2048) for _ in range(n)]),
        jnp.asarray(depth), jnp.asarray(color), jnp.asarray(poses),
    )
    m = tmesh.make_mesh(n, "cpu")
    tt = tmultiseq.make_multiseq_fusion_fn(m, cam, ta)(
        [tblocks.make_table(2048, d) for d in m.devices], depth, color, poses)
    for i, (j, t) in enumerate(zip(interop.stacked_from_numpy(jt, m.devices), tt)):
        assert int(t.num_active()) > 50
        assert set(j.keys.tolist()) == set(t.keys.tolist()), i
    stacked = interop.stacked_to_numpy(tt)
    assert stacked["weight"].shape == (n,) + tuple(tt[0].weight.shape)
