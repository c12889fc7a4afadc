"""The whole slice: the port's ``run_sequence`` against the JAX package's on
the tiny config, 13 frames (3 chunks) at 128x96 with the integration
resolution set to the input resolution (the port does not implement a
distinct one). At 128x96 the JAX package's 128-px XLA sampling window covers
every block, so both sides report patch_overflow 0. (At 64x48 every chunk of
this sequence is invalid in both implementations and nothing is fused.)

The JAX side runs its portable numpy wire (``framewire._load`` -> None):
its native converter disagrees with the numpy one (ROADMAP, Queue 3)."""

import dataclasses

import numpy as np
import pytest
import torch

from bundlefusion_tpu.bundle import trajectory as jtraj
from bundlefusion_tpu.bundle.pipeline import run_sequence as jax_run
from bundlefusion_tpu.config import tiny_test_config as j_tiny
from bundlefusion_tpu.io import framewire as jfw
from bundlefusion_tpu.io.replayer import Replayer, SyntheticSource
from bundlefusion_tpu_torch import interop
from bundlefusion_tpu_torch.bundle import trajectory as ttraj
from bundlefusion_tpu_torch.bundle.pipeline import BundleFusion
from bundlefusion_tpu_torch.bundle.pipeline import run_sequence as port_run
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.eval.ate import ate_rmse
from util import cached_sequence

W, H, N = 128, 96, 13
EXACT = ("chunk_valid", "kf_valid", "reloc", "tracking_lost", "num_keys", "patch_overflow",
         "pairs_valid", "alloc_overflow", "upd_truncated", "ring_miss", "reint_frames", "lost_chunks")
WITHIN_1PCT = ("filtered_matches", "blocks_touched", "active_blocks", "corr_cursor")


def _cfg(tiny, **app):
    c = tiny()
    a = dataclasses.replace(c.app, input_width=W, input_height=H, integration_width=W,
                            integration_height=H, **app)
    return dataclasses.replace(c, app=a)


@pytest.fixture(scope="module")
def runs():
    seq = cached_sequence(N, width=W, height=H)
    mp = pytest.MonkeyPatch()
    mp.setattr(jfw, "_load", lambda: None)
    try:
        bj, oj = jax_run(Replayer(SyntheticSource(seq), batch_size=4), _cfg(j_tiny), anchor_pose=seq.poses[0])
    finally:
        mp.undo()
    bt, ot = port_run(Replayer(SyntheticSource(seq), batch_size=4), _cfg(t_tiny), anchor_pose=seq.poses[0],
                      device="cpu")
    return seq, (bj, oj), (bt, ot)


def _chunks(bf):
    return [r for r in bf.runlog.records if "chunk" in r]


def test_runlog_matches_jax(runs):
    _, (bj, _), (bt, _) = runs
    rj, rt = _chunks(bj), _chunks(bt)
    assert len(rj) == len(rt) == 3
    assert all(r["chunk_valid"] for r in rt)
    for a, b in zip(rj, rt):
        for k in EXACT:
            assert a[k] == b[k], (a["chunk"], k, a[k], b[k])
        for k in WITHIN_1PCT:
            assert abs(a[k] - b[k]) <= 0.01 * max(abs(a[k]), 1), (a["chunk"], k, a[k], b[k])
        assert b["patch_overflow"] == 0


def test_poses_and_ate_match_jax(runs):
    seq, (_, oj), (_, ot) = runs
    np.testing.assert_array_equal(oj.valid, ot.valid)
    err = float(np.abs(oj.poses - ot.poses).max())
    print(f"max |pose jax - port| = {err:.3g}")
    assert err <= 1e-4
    n = min(len(ot.poses), N)
    ate_j = ate_rmse(oj.poses[:n], seq.poses[:n], valid=oj.valid[:n])
    ate_t = ate_rmse(ot.poses[:n], seq.poses[:n], valid=ot.valid[:n])
    print(f"ATE jax {ate_j * 100:.5f} cm, port {ate_t * 100:.5f} cm")
    assert abs(ate_j - ate_t) <= 0.0005
    assert oj.num_keyframes == ot.num_keyframes


def test_tsdf_matches_jax(runs):
    _, (bj, _), (bt, _) = runs
    kj = set(np.asarray(bj.table.keys).tolist())
    kt = set(bt.table.keys.numpy().tolist())
    print(f"block key sets: symmetric difference {len(kj ^ kt)} of {len(kj)}")
    assert len(kj ^ kt) <= 0.01 * len(kj)
    wj = float(np.asarray(bj.table.weight, np.float64).sum())
    wt = float(bt.table.weight.double().sum())
    print(f"TSDF weight sum jax {wj}, port {wt}")
    assert abs(wj - wt) <= 1e-3 * wj
    tj = interop.state_from_numpy(bj.traj, "cpu")
    assert torch.equal(tj.integrated, bt.traj.integrated)
    assert torch.equal(tj.opt_valid, bt.traj.opt_valid)


def test_trajectory_plan_matches_jax():
    import jax.numpy as jnp

    eye = np.eye(4, dtype=np.float32)
    moved = eye.copy()
    moved[0, 3] = 0.5
    ids = np.array([0, 1, 2])
    opt = np.stack([moved, eye, eye])
    valid = np.array([True, False, True])
    js = jtraj.make_trajectory(16)
    js = jtraj.mark_integrated_batch(js, jnp.asarray(ids), jnp.asarray(np.stack([eye] * 3)))
    js = jtraj.update_optimized(js, jnp.asarray(ids), jnp.asarray(opt), jnp.asarray(valid))
    ts = ttraj.make_trajectory(16, "cpu")
    ts = ttraj.mark_integrated_batch(ts, torch.as_tensor(ids), torch.as_tensor(np.stack([eye] * 3)))
    ts = ttraj.update_optimized(ts, torch.as_tensor(ids), torch.as_tensor(opt), torch.as_tensor(valid))
    pj = jtraj.plan_reintegration(js, budget=4)
    pt = ttraj.plan_reintegration(ts, budget=4)
    for k in ("frames", "deint_mask", "reint_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(pj, k)), getattr(pt, k).numpy())
    assert set(pt.frames[pt.deint_mask].tolist()) == {0, 1}
    assert set(pt.frames[pt.reint_mask].tolist()) == {0}


def test_ring_spilled_frames_are_reintegrated():
    """Frames evicted from the device ring are re-uploaded from the host
    FrameStore by finalize's service (the port of the JAX scenario)."""
    seq = cached_sequence(21, width=W, height=H)
    cfg = _cfg(t_tiny, history_ring_frames=6)
    bf, _ = port_run(Replayer(SyntheticSource(seq), batch_size=4), cfg, anchor_pose=seq.poses[0], device="cpu")
    assert int(bf._ring_frame[0]) != 0 and bool(bf.traj.integrated[0])
    shifted = bf.traj.integrated_pose[0].clone()
    shifted[0, 3] += 0.05
    bf.traj = ttraj.update_optimized(bf.traj, torch.tensor([0]), shifted[None], torch.tensor([True]))
    uploads = bf._ring_uploads
    assert bf._service_reintegration(max_rounds=1) >= 1
    assert bf._ring_uploads > uploads
    torch.testing.assert_close(bf.traj.integrated_pose[0], shifted, atol=1e-6, rtol=0)
    # invalidate frame 2: de-integrated; revalidate: integrated again
    bf.traj = dataclasses.replace(bf.traj, opt_valid=bf.traj.opt_valid.clone().index_fill_(0, torch.tensor([2]), False))
    bf._service_reintegration(max_rounds=1)
    assert not bool(bf.traj.integrated[2])
    bf.traj = dataclasses.replace(bf.traj, opt_valid=bf.traj.opt_valid.clone().index_fill_(0, torch.tensor([2]), True))
    bf._service_reintegration(max_rounds=1)
    assert bool(bf.traj.integrated[2])


def test_steady_state_reads_nothing_back(monkeypatch):
    """Between push_frame and flush() the host never reads a tensor (the
    JAX package's design rule; on a card such a read is a sync)."""
    seq = cached_sequence(N, width=W, height=H)
    bf = BundleFusion(seq.camera, _cfg(t_tiny), anchor_pose=seq.poses[0], device="cpu")
    reads: list[str] = []
    # (numpy() is absent: a CUDA tensor must pass through cpu() first)
    for name in ("item", "tolist", "cpu", "__bool__", "__int__", "__float__", "__index__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            reads.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    for i in range(N):
        bf.push_frame(seq.depth[i], seq.color[i])
    bf.flush()
    monkeypatch.undo()
    assert not reads, reads[:5]
    assert bf.outputs().num_keyframes == 3
