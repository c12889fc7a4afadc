"""Relocalization aftermath: the port's ``_revalidate_stale``, ``global_match
(against_all=True)`` and ``finalize()`` after a relocalization, against the
JAX package.

The revalidation scenario is the JAX package's own (``tests/
test_loopclosure.py``): 21 frames at 128x96 on the tiny config (integration
at the input resolution, which is all the port implements); keyframe 2 is
invalidated after the fact, its interior frames are de-integrated, then
``_revalidate_stale`` re-links it and the service re-integrates them. Both
sides run the same steps; the JAX side runs its portable numpy wire.

Bars: counts, validity masks and integration flags equal; poses within
2e-5 (on these frames the two global solves already differ by 1.13e-5 m in
translation before any revalidation: f32 GN/PCG sums in another order, see
ROADMAP Queue 3); the match's transforms within 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bundlefusion_tpu.bundle import global_graph as jgg
from bundlefusion_tpu.bundle.pipeline import BundleFusion as JaxBF
from bundlefusion_tpu.config import tiny_test_config as j_tiny
from bundlefusion_tpu.io import framewire as jfw
from bundlefusion_tpu_torch import interop
from bundlefusion_tpu_torch.bundle import global_graph as tgg
from bundlefusion_tpu_torch.bundle.pipeline import BundleFusion as PortBF
from bundlefusion_tpu_torch.bundle.pipeline import run_sequence as port_run
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.eval.ate import ate_rmse
from bundlefusion_tpu_torch.geometry.camera import CameraModel
from bundlefusion_tpu_torch.io.replayer import Replayer, SyntheticSource
from bundlefusion_tpu_torch.io.synthetic import orbit_poses, render_sequence
from util import cached_sequence

W, H, N = 128, 96, 21
K = 2  # the victim keyframe
POSE_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU; PyTorch's
    own thread pool per process would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tiny, **bundling):
    c = tiny()
    app = dataclasses.replace(c.app, input_width=W, input_height=H, integration_width=W, integration_height=H)
    return dataclasses.replace(c, app=app, bundling=dataclasses.replace(c.bundling, **bundling))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _state(bf):
    """Where each side keeps its device state (graph, trajectory)."""
    return bf.state if isinstance(bf, PortBF) else bf


def _invalidate(bf, k):
    if isinstance(bf, PortBF):
        bf.state.graph.valid[k] = False
    else:
        bf.graph = bf.graph._replace(valid=bf.graph.valid.at[k].set(False))


@pytest.fixture(scope="module")
def scenario():
    """Runs the scenario on both sides; returns what each step observed."""
    seq = cached_sequence(N, width=W, height=H)
    mp = pytest.MonkeyPatch()
    mp.setattr(jfw, "_load", lambda: None)
    obs = {}
    try:
        sides = {
            "jax": JaxBF(seq.camera, _cfg(j_tiny), anchor_pose=seq.poses[0]),
            "port": PortBF(seq.camera, _cfg(t_tiny), anchor_pose=seq.poses[0], device="cpu"),
        }
        for name, bf in sides.items():
            for i in range(N):
                bf.push_frame(seq.depth[i], seq.color[i])
            bf.flush()
            s = bf.S
            frames = np.arange(2 * s + 1, 3 * s)
            st = _state(bf)
            o = obs[name] = {"frames": frames, "integrated0": _np(st.traj.integrated)[frames].copy()}
            _invalidate(bf, K)
            bf._publish_trajectory()
            bf._service_reintegration()
            o["integrated1"] = _np(st.traj.integrated)[frames].copy()
            o["n_re"] = bf._revalidate_stale()
            o["valid"] = _np(st.graph.valid).copy()
            o["poses"] = _np(st.graph.poses).copy()
            bf._publish_trajectory()
            bf._service_reintegration()
            o["integrated2"] = _np(st.traj.integrated).copy()
            o["bf"] = bf
    finally:
        mp.undo()
    return obs


def test_revalidation_matches_jax(scenario):
    j, t = scenario["jax"], scenario["port"]
    for o in (j, t):
        assert o["integrated0"].all(), "the victim's frames start integrated"
        assert not o["integrated1"].any(), "an invalidated keyframe's frames are de-integrated"
        assert o["integrated2"][o["frames"]].all(), "revalidated frames are re-integrated"
    assert t["n_re"] == j["n_re"] >= 1
    np.testing.assert_array_equal(j["valid"], t["valid"])
    assert t["valid"][K]
    n = t["bf"].num_keyframes
    err = float(np.abs(j["poses"][:n] - t["poses"][:n]).max())
    print(f"max |keyframe pose jax - port| after revalidation = {err:.3g}")
    assert err <= POSE_TOL
    np.testing.assert_array_equal(j["integrated2"], t["integrated2"])


def test_global_match_against_all_matches_jax(scenario):
    """The re-match alone, from one graph state carried across: keyframe K,
    invalid, against every valid keyframe, later ones included."""
    jbf, tbf = scenario["jax"]["bf"], scenario["port"]["bf"]
    jgraph = jbf.graph._replace(valid=jbf.graph.valid.at[K].set(False))
    tgraph = interop.state_from_numpy(jgraph, "cpu")
    bc_j, bc_t = jbf.config.bundling, tbf.config.bundling
    mj = jgg.global_match(jgraph, np.int32(K), jbf.cache_cam, bc_j, against_all=True)
    mt = tgg.global_match(tgraph, K, tbf.cache_cam, bc_t, against_all=True)
    pv = _np(mj.pair_valid)
    np.testing.assert_array_equal(pv, mt.pair_valid.numpy())
    assert pv[K + 1 :].any(), "a later keyframe is a candidate"
    assert bool(mj.any_valid) == bool(mt.any_valid)
    assert int(mj.best_prev) == int(mt.best_prev)
    np.testing.assert_array_equal(_np(mj.inlier_counts), mt.inlier_counts.numpy())
    np.testing.assert_allclose(mt.transforms.numpy()[pv], _np(mj.transforms)[pv], rtol=0, atol=1e-4)
    assert int(mj.graph.corr_cursor) == int(mt.graph.corr_cursor)
    # without against_all only earlier keyframes are candidates
    early = tgg.global_match(tgraph, K, tbf.cache_cam, bc_t)
    assert not early.pair_valid[K:].any()


def _out_and_back(num_frames=41, keep=33):
    """The first ``keep`` frames of the JAX package's out-and-back orbit
    (``tests/test_loopclosure.py``), rendered by the port: the return pass
    retraces the outbound views."""
    fx = 0.9 * W
    cam = CameraModel.create(fx, fx, (W - 1) / 2, (H - 1) / 2, W, H)
    base = orbit_poses(num_frames, radius=0.45, seed=3)
    half = num_frames // 2
    poses = np.concatenate([base[: half + 1], base[half - 1 :: -1]])[:keep]
    return render_sequence(poses, cam, device="cpu")


def test_finalize_after_relocalization_with_periodic_revalidation():
    """A depth blackout breaks the odometry chain; the keyframe after it
    relocalizes by global matching. The periodic hook revalidates during
    the run, finalize() does not repeat it, and the frames after the cut
    are tracked."""
    seq = _out_and_back()
    depth = seq.depth.copy()
    depth[20:24] = 0.0
    cfg = _cfg(t_tiny, revalidate_every_chunks=2)
    bf, out = port_run(Replayer(SyntheticSource(seq._replace(depth=depth)), batch_size=8), cfg,
                       anchor_pose=seq.poses[0], device="cpu")
    reloc = int(bf.state.ctrl.reloc_events)
    assert reloc >= 1
    assert bf._reloc_seen == reloc, "the periodic hook saw every relocalization"
    valid = out.valid
    assert not valid[20:24].all()
    assert valid[28:].any(), "should relocalize after the blackout"
    n = min(len(out.poses), len(seq.poses))
    sel = valid[:n].copy()
    sel[:28] = False
    ate_tail = ate_rmse(out.poses[:n], seq.poses[:n], valid=sel)
    print(f"relocalizations {reloc}, post-cut ATE {ate_tail * 100:.3f} cm")
    assert ate_tail < 0.04
