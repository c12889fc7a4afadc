"""Two pipeline settings against the JAX package, each on 13 frames (3 chunks)
of 128x96 input with the tiny configuration:

* ``integrate_filtered_depth=True``: the depth is bilateral-filtered at the
  wire (``framewire.bilateral_wire``), so the ring, the FrameStore and K1
  hold the filtered bytes and the chunk step skips its own filter;
* a 64x48 integration resolution: depth and half-res colour decimated at the
  wire, the ring and FrameStore at 64x48, K1 with the integration camera;
  plus a checkpoint round trip that keeps the integration dimensions.

Bars, as ``test_torch_pipeline.py``: validity, keyframe counts and the
runlog's exact counters equal; poses within 2e-5 (the pipeline's bar,
ROADMAP Queue 3); block key sets within 1% and the TSDF weight sum within
1e-3 relative (a few voxels flip, Queue 3).
"""

import dataclasses

import numpy as np
import pytest
import torch

from bundlefusion_tpu.bundle.pipeline import run_sequence as jax_run
from bundlefusion_tpu.config import tiny_test_config as j_tiny
from bundlefusion_tpu.io import framewire as jfw
from bundlefusion_tpu.io.replayer import Replayer, SyntheticSource
from bundlefusion_tpu_torch.bundle.checkpoint import load_checkpoint, save_checkpoint
from bundlefusion_tpu_torch.bundle.pipeline import BundleFusion
from bundlefusion_tpu_torch.bundle.pipeline import run_sequence as port_run
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.io import framewire as tfw
from util import cached_sequence

W, H, N = 128, 96, 13
EXACT = ("chunk_valid", "kf_valid", "reloc", "tracking_lost", "num_keys", "pairs_valid", "alloc_overflow",
         "upd_truncated", "ring_miss", "reint_frames", "lost_chunks")
SETTINGS = {
    "filtered_depth": dict(integration_width=W, integration_height=H, integrate_filtered_depth=True),
    "integration_64x48": dict(integration_width=64, integration_height=48),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tiny, name):
    c = tiny()
    return dataclasses.replace(c, app=dataclasses.replace(c.app, input_width=W, input_height=H, **SETTINGS[name]))


@pytest.fixture(scope="module", params=sorted(SETTINGS))
def runs(request):
    name = request.param
    seq = cached_sequence(N, width=W, height=H)
    mp = pytest.MonkeyPatch()
    # both sides on their numpy wire (the native bilateral may land a pixel
    # 1 mm apart; it is held to the numpy one in test_torch_ingest.py)
    mp.setattr(jfw, "_load", lambda: None)
    mp.setattr(tfw, "_load", lambda: None)
    try:
        j = jax_run(Replayer(SyntheticSource(seq), batch_size=4), _cfg(j_tiny, name), anchor_pose=seq.poses[0])
        t = port_run(Replayer(SyntheticSource(seq), batch_size=4), _cfg(t_tiny, name), anchor_pose=seq.poses[0],
                     device="cpu")
    finally:
        mp.undo()
    return name, seq, j, t


def test_setting_matches_jax(runs):
    name, _, (bj, oj), (bt, ot) = runs
    assert ot.num_keyframes == oj.num_keyframes == 3
    np.testing.assert_array_equal(oj.valid, ot.valid)
    assert ot.valid.all()
    err = float(np.abs(oj.poses - ot.poses).max())
    rj = [r for r in bj.runlog.records if "chunk" in r]
    rt = [r for r in bt.runlog.records if "chunk" in r]
    assert len(rj) == len(rt) == 3
    for a, b in zip(rj, rt):
        for k in EXACT:
            assert a[k] == b[k], (name, a["chunk"], k, a[k], b[k])
    kj = set(np.asarray(bj.table.keys).tolist())
    kt = set(bt.state.table.keys.numpy().tolist())
    wj = float(np.asarray(bj.table.weight, np.float64).sum())
    wt = float(bt.state.table.weight.double().sum())
    print(f"{name}: max |pose jax - port| {err:.3g}; block keys differ in {len(kj ^ kt)} of {len(kj)}; "
          f"weight sums {wj} / {wt}")
    assert err <= 2e-5
    assert len(kj ^ kt) <= 0.01 * len(kj)
    assert abs(wj - wt) <= 1e-3 * wj


def test_ring_holds_what_k1_integrates(runs):
    """The ring and the FrameStore hold the integration-resolution (and, with
    filtered depth, filtered) wire bytes that the JAX package's hold."""
    name, seq, (bj, _), (bt, _) = runs
    h, w = (48, 64) if name == "integration_64x48" else (H, W)
    st = bt.state
    assert tuple(st.hist_d16.shape[1:]) == (h, w) and tuple(st.hist_c8.shape[1:]) == (h // 2, w // 2, 3)
    assert bt.int_cam.width == w and bt.int_cam.height == h
    for f in (0, 5, 12):
        dj, cj = bj._frame_store[f]
        dt, ct = bt._frame_store[f]
        assert np.array_equal(dj, dt) and np.array_equal(cj, ct), f
    r = st.history_cap
    slots = [f % r for f in range(N)]
    np.testing.assert_array_equal(np.asarray(bj._hist_d16)[slots], st.hist_d16[slots].numpy().view(np.uint16))
    np.testing.assert_array_equal(np.asarray(bj._hist_c8)[slots], st.hist_c8[slots].numpy())
    if name == "filtered_depth":
        raw = jfw.frame_to_wire2(seq.depth[5], seq.color[5])[0]
        assert not np.array_equal(bt._frame_store[5][0], raw)


def test_integration_resolution_checkpoint_round_trip(tmp_path):
    """A checkpoint of a 64x48-integration pipeline restores its dimensions
    and, fed the remaining frames, finishes bit-equal to an uninterrupted run."""
    seq = cached_sequence(N, width=W, height=H)
    cfg = _cfg(t_tiny, "integration_64x48")

    def fresh():
        return BundleFusion(seq.camera, cfg, anchor_pose=seq.poses[0], device="cpu")

    a = fresh()
    for i in range(7):
        a.push_frame(seq.depth[i], seq.color[i])
    save_checkpoint(a, str(tmp_path / "ck.pkl"))
    b = load_checkpoint(str(tmp_path / "ck.pkl"), device="cpu")
    sa, sb = a.state, b.state
    assert (b.int_cam.width, b.int_cam.height) == (64, 48) and tuple(sb.hist_d16.shape[1:]) == (48, 64)
    # (the scratch row past the ring's end is never read, and not saved)
    assert torch.equal(sa.hist_d16[:-1], sb.hist_d16[:-1]) and torch.equal(sa.hist_c8[:-1], sb.hist_c8[:-1])
    for bf in (a, b):  # frames 7 and 8 complete chunk 1
        for i in range(7, 9):
            bf.push_frame(seq.depth[i], seq.color[i])
        bf.flush()
    oa, ob = a.outputs(), b.outputs()
    assert np.array_equal(oa.poses, ob.poses) and np.array_equal(oa.valid, ob.valid)
    assert torch.equal(sa.table.weight[: sa.table.capacity], sb.table.weight[: sb.table.capacity])
    # the restored pipeline has no overlap row on the device: its first
    # chunk uploads every row, the uninterrupted one the S new rows
    assert a.upload_bytes[1] < b.upload_bytes[0] == a.upload_bytes[0] and len(b.upload_bytes) == 1

