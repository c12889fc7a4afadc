"""The port's command-line app and checkpoints.

``bundlefusion_tpu_torch.app.main`` runs 11 synthetic frames at 128x96 on
the CPU with the tiny configuration as JSON (integration at the input
resolution), a checkpoint every chunk and previews; its outputs are checked
against the JAX package's ``run_sequence`` + ``extract_mesh`` on the same
frames (the JAX side runs its portable numpy wire). Bars: frame, keyframe
and lost-chunk counts and the runlog's counters as in
``test_torch_pipeline.py``; trajectory within 1e-5 (as written, 6 decimals);
ATE within 5e-6 m; active blocks and mesh triangles within 1% (the TSDFs
differ in a few voxels, ROADMAP Queue 3).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from bundlefusion_tpu.bundle.pipeline import run_sequence as jax_run
from bundlefusion_tpu.config import tiny_test_config as j_tiny
from bundlefusion_tpu.eval.ate import ate_rmse as j_ate
from bundlefusion_tpu.io import framewire as jfw
from bundlefusion_tpu.io.replayer import Replayer, SyntheticSource
from bundlefusion_tpu_torch import app, interop
from bundlefusion_tpu_torch.bundle.checkpoint import load_checkpoint, save_checkpoint
from bundlefusion_tpu_torch.bundle.pipeline import BundleFusion
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.io.synthetic import generate_sequence

W, H, N = 128, 96, 11
EXACT = ("chunk_valid", "kf_valid", "reloc", "tracking_lost", "num_keys", "pairs_valid", "alloc_overflow",
         "upd_truncated", "ring_miss", "reint_frames", "lost_chunks")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU; PyTorch's
    own thread pool per process would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tiny):
    c = tiny()
    app_cfg = dataclasses.replace(c.app, input_width=W, input_height=H, integration_width=W, integration_height=H)
    return dataclasses.replace(c, app=app_cfg)


@pytest.fixture(scope="module")
def seq():
    """The frames the app's --synthetic route renders (on the CPU)."""
    return generate_sequence(N, width=W, height=H, device="cpu")


@pytest.fixture(scope="module")
def cfg_args(tmp_path_factory):
    d = tmp_path_factory.mktemp("cfg")
    c = _cfg(t_tiny)
    (d / "app.json").write_text(json.dumps(dataclasses.asdict(c.app)))
    (d / "bundling.json").write_text(json.dumps(dataclasses.asdict(c.bundling)))
    return ["--app-config", str(d / "app.json"), "--bundling-config", str(d / "bundling.json"), "--device", "cpu"]


@pytest.fixture(scope="module")
def port_out(tmp_path_factory, cfg_args):
    out = tmp_path_factory.mktemp("port_out")
    rc = app.main(["--synthetic", str(N), "--width", str(W), "--height", str(H), "--out", str(out),
                   "--checkpoint-every", "1", "--preview-every", "5", *cfg_args])
    assert rc == 0
    return out


@pytest.fixture(scope="module")
def jax_ref(seq):
    mp = pytest.MonkeyPatch()
    mp.setattr(jfw, "_load", lambda: None)
    try:
        bf, out = jax_run(Replayer(SyntheticSource(seq), batch_size=8), _cfg(j_tiny), anchor_pose=seq.poses[0])
        mesh = bf.extract_mesh()
    finally:
        mp.undo()
    return bf, out, mesh


def test_app_summary_matches_jax(port_out, jax_ref, seq):
    bj, oj, (_, _, fj) = jax_ref
    s = json.loads((port_out / "summary.json").read_text())
    assert s["frames"] == len(oj.poses) >= N
    assert s["keyframes"] == oj.num_keyframes
    assert s["tracking_lost_chunks"] == oj.tracking_lost_chunks == 0
    active_j = int(bj.table.num_active())
    assert abs(s["active_blocks"] - active_j) <= 0.01 * active_j
    n = min(len(oj.poses), N)
    ate_j = j_ate(oj.poses[:n], seq.poses[:n], valid=oj.valid[:n])
    print(f"ATE jax {ate_j * 100:.5f} cm, port {s['ate_rmse_m'] * 100:.5f} cm; "
          f"triangles jax {len(fj)}, port {s['mesh_triangles']}")
    assert abs(s["ate_rmse_m"] - ate_j) <= 5e-6
    assert abs(s["mesh_triangles"] - len(fj)) <= 0.01 * len(fj)
    assert {"chunk_local", "graph_step", "plan_fuse"} <= set(s["timing"])


def test_app_mesh_ply(port_out, jax_ref):
    _, _, (vj, _, fj) = jax_ref
    data = (port_out / "mesh.ply").read_bytes()
    head, body = data.split(b"end_header\n", 1)
    s = json.loads((port_out / "summary.json").read_text())
    nv, nf = 3 * s["mesh_triangles"], s["mesh_triangles"]
    assert f"element vertex {nv}".encode() in head and f"element face {nf}".encode() in head
    assert len(body) == nv * 15 + nf * 13
    verts = np.frombuffer(body[: nv * 15], dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])["xyz"]
    # the mesh spans the same volume as the JAX package's
    np.testing.assert_allclose(verts.min(0), vj.min(0), atol=0.05)
    np.testing.assert_allclose(verts.max(0), vj.max(0), atol=0.05)


def test_app_trajectory_and_runlog_match_jax(port_out, jax_ref):
    bj, oj, _ = jax_ref
    rows = np.loadtxt(port_out / "trajectory.txt")
    assert len(rows) == int(oj.valid.sum())
    tj = oj.poses[oj.valid][:, :3, 3]
    np.testing.assert_allclose(rows[:, 1:4], tj, rtol=0, atol=1e-5 + 1e-6)
    np.testing.assert_array_equal(np.load(port_out / "trajectory_valid.npy"), oj.valid)
    np.testing.assert_allclose(np.load(port_out / "trajectory.npy"), oj.poses, rtol=0, atol=1e-5)
    recs = [json.loads(line) for line in (port_out / "run.jsonl").read_text().splitlines()]
    chunks_t = [r for r in recs if "chunk" in r]
    chunks_j = [r for r in bj.runlog.records if "chunk" in r]
    assert len(chunks_t) == len(chunks_j) >= 2
    for a, b in zip(chunks_j, chunks_t):
        for k in EXACT:
            assert a[k] == b[k], (a["chunk"], k, a[k], b[k])


def test_app_previews_and_checkpoint(port_out):
    previews = sorted(p.name for p in port_out.glob("preview_*"))
    assert previews and previews[0].startswith("preview_00005.")
    bf = load_checkpoint(str(port_out / "checkpoint.pkl"), device="cpu")
    assert bf.chunk_count >= 2 and bf.num_frames >= 9 and len(bf._ingest.frame_store) == bf._ingest.next_fid


def test_checkpoint_restores_the_state_and_keeps_consuming_frames(tmp_path, seq, port_out):
    """A pipeline saved after 7 frames and restored equals the saved one; fed
    the remaining frames, it ends bit-equal to the app's uninterrupted run."""
    cfg = _cfg(t_tiny)
    a = BundleFusion(seq.camera, cfg, anchor_pose=seq.poses[0], device="cpu")
    for i in range(7):  # chunk 0 done; frames 4..6 wait for chunk 1
        a.push_frame(seq.depth[i], seq.color[i])
    path = str(tmp_path / "ck.pkl")
    save_checkpoint(a, path)
    b = load_checkpoint(path, device="cpu")
    sa, sb = a.state, b.state
    for name in ("graph", "traj", "ctrl"):
        for x, y in zip(_leaves(interop.state_to_numpy(getattr(sa, name))),
                        _leaves(interop.state_to_numpy(getattr(sb, name)))):
            assert np.array_equal(x, y), name
    for name in ("anchor", "ring_frame", "local_trajs", "chunk_valid", "runlog_rows", "blocks_updated",
                 "gc_freed_total"):
        assert torch.equal(getattr(sa, name), getattr(sb, name)), name
    # the pools, the ring and the update records carry one scratch row past
    # the end that masked writes land in; it is never read and not saved
    for name in ("sdf", "weight", "color", "keys", "slot_of", "key_of_slot"):
        x, y = getattr(sa.table, name), getattr(sb.table, name)
        assert torch.equal(x[: sa.table.capacity], y[: sa.table.capacity]), name
    for name in ("hist_d16", "hist_c8", "upd_masks", "upd_keys"):
        assert torch.equal(getattr(sa, name)[:-1], getattr(sb, name)[:-1]), name
    assert (b.chunk_count, b.num_frames, b._ingest.next_fid, len(b._ingest.pending)) == (a.chunk_count, a.num_frames, 7, 3)
    for i in range(7, N):
        b.push_frame(seq.depth[i], seq.color[i])
    b.flush()
    ob = b.outputs()
    assert np.array_equal(ob.poses, np.load(port_out / "trajectory.npy"))
    assert np.array_equal(ob.valid, np.load(port_out / "trajectory_valid.npy"))
    assert int(sb.table.num_active()) == json.loads((port_out / "summary.json").read_text())["active_blocks"]


def _leaves(d):
    for v in d.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def test_tum_trajectory_writer_matches_jax(tmp_path, seq):
    from bundlefusion_tpu.app import _write_tum_trajectory

    valid = np.arange(N) % 4 != 2
    poses = seq.poses.copy()
    poses[3, :3, :3] = np.diag([-1.0, -1.0, 1.0])  # a trace below 0
    _write_tum_trajectory(str(tmp_path / "j.txt"), poses, valid)
    app.write_tum_trajectory(str(tmp_path / "t.txt"), poses, valid)
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()

