"""Long-run drift: the JAX package's out-of-core streaming configuration
(``tests/test_aux.py::test_streaming_multiroom_out_of_core``: the 81-frame
corridor at 128x96, a streaming check every chunk, radius 1.8 m, watermark
0.3, 2,048 blocks) through both packages on the CPU, on the same frames and
their numpy wire.

Opt-in (``slow``, outside Tier-1; several minutes here):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_longscan.py -m slow -s -q

Bars, over the whole walk, the reference's own:

* chunk and keyframe validity, keyframes and lost chunks equal;
* every streaming check's stream-in and stream-out counts and host-store
  size equal, and the host store's and the device table's key sets equal
  (``test_torch_streaming.py`` over 21 frames);
* poses within 2e-5 (``test_torch_streaming.py``: the global solves' f32
  sums in another order stop at PCG's gate at other points, ROADMAP
  Queue 3).

The first holds. The other two do not (ROADMAP Queue 3, "long-run drift",
with sizes): the poses part by up to 2.6e-3 at frame 68; a re-integration
decision differs at chunk 7, the active block counts follow, and the
streaming checks fire at other chunks. The tests print what differs.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bundlefusion_tpu.bundle.pipeline import run_sequence as jax_run
from bundlefusion_tpu.config import tiny_test_config as j_tiny
from bundlefusion_tpu.io import framewire as jfw
from bundlefusion_tpu.io.replayer import Replayer, SyntheticSource
from bundlefusion_tpu.io.synthetic import generate_corridor_sequence
from bundlefusion_tpu_torch.bundle.pipeline import run_sequence as port_run
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.io import framewire as tfw

POSE_BAR = 2e-5

pytestmark = pytest.mark.slow


def _cfg(tiny):
    c = tiny()
    app = dataclasses.replace(c.app, streaming_enabled=True, streaming_radius=1.8, streaming_watermark=0.3,
                              streaming_check_every=1, block_capacity=2048)
    return dataclasses.replace(c, app=app)


@pytest.fixture(scope="module")
def runs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    seq = generate_corridor_sequence(81, width=128, height=96, x_span=2.5)
    mp = pytest.MonkeyPatch()
    mp.setattr(jfw, "_load", lambda: None)
    mp.setattr(tfw, "_load", lambda: None)
    try:
        j = jax_run(Replayer(SyntheticSource(seq), batch_size=8), _cfg(j_tiny), anchor_pose=seq.poses[0])
        t = port_run(Replayer(SyntheticSource(seq), batch_size=8), _cfg(t_tiny), anchor_pose=seq.poses[0],
                     device="cpu")
    finally:
        mp.undo()
        torch.set_num_threads(n)
    return j, t


def _stream_records(bf):
    return [(r["chunk"], r["stream_in"], r["stream_out"], r["host_blocks"]) for r in bf.runlog.records
            if "stream_out" in r]


def _store_keys(store):
    return set(np.concatenate([store._keys[rows] for rows in store._chunks.values()] or [np.zeros(0)]).tolist())


def test_longscan_validity_matches_jax(runs):
    (bj, oj), (bt, ot) = runs
    rj, rt = ([r for r in bf.runlog.records if "chunk_valid" in r] for bf in (bj, bt))
    for a, b in zip(rj, rt):
        diff = {k: (a[k], b[k]) for k in a if k in b and not isinstance(a[k], float) and a[k] != b[k]}
        if diff:
            print(f"chunk {a['chunk']}: runlog counters (JAX, port) that differ {diff}")
    np.testing.assert_array_equal(oj.valid, ot.valid)
    assert ot.tracking_lost_chunks == oj.tracking_lost_chunks
    assert ot.num_keyframes == oj.num_keyframes
    kv = [[r["kf_valid"] for r in bf.runlog.records if "kf_valid" in r] for bf in (bj, bt)]
    assert kv[0] == kv[1]


def test_longscan_streaming_matches_jax(runs):
    (bj, _), (bt, _) = runs
    rj, rt = _stream_records(bj), _stream_records(bt)
    kj, kt = _store_keys(bj.block_store), _store_keys(bt.block_store)
    dj = set(np.asarray(bj.table.keys).tolist())
    dt = set(bt.state.table.keys.numpy().tolist())
    print(f"streaming checks (chunk, in, out, host blocks): JAX {rj}; port {rt}")
    print(f"host store: {len(kt)} keys (JAX {len(kj)}), {len(kj ^ kt)} differ; device table: {len(dt)} keys "
          f"(JAX {len(dj)}), {len(dj ^ dt)} differ")
    assert len(kt) > 0
    assert rt == rj
    assert kt == kj and dt == dj


def test_longscan_poses_match_jax(runs):
    (_, oj), (_, ot) = runs
    err = np.abs(oj.poses - ot.poses).reshape(len(ot.poses), -1).max(axis=1)
    print(f"max |pose jax - port| {err.max():.3g} (frame {int(err.argmax())}); by 20 frames "
          f"{[float(err[i:i + 20].max()) for i in range(0, len(err), 20)]}")
    assert err.max() <= POSE_BAR
