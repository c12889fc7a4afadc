"""Out-of-core streaming: the port's ``fusion/streaming.py`` and the
pipeline's streaming step against the JAX package.

The stream passes run from one table the JAX package fused and ``interop``
carried across. Bars: evicted keys equal and in the same order, host-store
arrays and the tables after stream-out and stream-in bit-equal, and within
1e-6 relative where a block re-allocated while cold is merged (a weighted
mean of two accumulations). The pipeline runs the streaming settings of the
JAX package's own streaming test (radius 2.2 m, watermark 0, a check every
chunk) on 21 frames at 128x96; the JAX side runs its portable numpy wire, as
in ``test_torch_pipeline.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.bundle.pipeline import BundleFusion as JaxBF
from bundlefusion_tpu.bundle.pipeline import run_sequence as jax_run
from bundlefusion_tpu.config import tiny_test_config as j_tiny
from bundlefusion_tpu.fusion import blocks as jb
from bundlefusion_tpu.fusion import streaming as js
from bundlefusion_tpu.fusion import tsdf as jt
from bundlefusion_tpu.io import framewire as jfw
from bundlefusion_tpu.io.replayer import Replayer, SyntheticSource
from bundlefusion_tpu_torch import interop
from bundlefusion_tpu_torch.bundle.pipeline import BundleFusion as PortBF
from bundlefusion_tpu_torch.bundle.pipeline import run_sequence as port_run
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.fusion import blocks as tb
from bundlefusion_tpu_torch.fusion import marching_cubes as tmc
from bundlefusion_tpu_torch.fusion import streaming as ts
from util import cached_sequence

APP_J = j_tiny().app
APP_T = t_tiny().app
TABLE_FIELDS = ("keys", "slot_of", "key_of_slot", "sdf", "weight", "color")
STORE_ARRAYS = ("_keys", "_sdf", "_wgt", "_col")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU; PyTorch's
    own thread pool per process would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fused():
    """Six frames fused by the JAX package (numpy leaves) and a camera position."""
    seq = cached_sequence(8, width=64, height=48)
    table = jb.make_table(APP_J.block_capacity)
    table, _ = jt.integrate_batch(
        table, jnp.asarray(seq.depth[:6]), jnp.asarray(seq.color[:6]), jnp.asarray(seq.poses[:6]),
        jnp.ones(6, bool), seq.camera, APP_J,
    )
    return jax.tree.map(np.asarray, table), seq.poses[0][:3, 3]


def _jax_table(np_table):
    return jax.tree.map(jnp.asarray, np_table)


def _assert_tables_equal(jtab, ttab):
    for k in TABLE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jtab, k)), getattr(ttab, k).numpy(), err_msg=k)


def _assert_stores_equal(jstore, tstore):
    assert len(jstore) == len(tstore)
    for k in STORE_ARRAYS:
        np.testing.assert_array_equal(getattr(jstore, k), getattr(tstore, k), err_msg=k)
    assert jstore._free == tstore._free
    assert jstore._chunks == tstore._chunks


def _evicted(store, n):
    """The keys of a first stream-out of ``n`` blocks, in eviction order
    (``put`` fills the last ``n`` rows of the grown arrays in order)."""
    return store._keys[store._cap - n :]


def _radius(app, r):
    return dataclasses.replace(app, streaming_radius=r)


def test_stream_out_then_in_matches_jax(fused):
    np_table, cam_pos = fused
    jtab, ttab = _jax_table(np_table), interop.state_from_numpy(np_table, "cpu")
    jstore, tstore = js.HostBlockStore(), ts.HostBlockStore()
    jtab, nj = js.stream_out(jtab, jstore, cam_pos, _radius(APP_J, 1.0))
    ttab, nt = ts.stream_out(ttab, tstore, cam_pos, _radius(APP_T, 1.0))
    assert nj == nt > 0
    # the evicted keys, farthest first
    np.testing.assert_array_equal(_evicted(jstore, nj), _evicted(tstore, nt))
    assert len(set(_evicted(tstore, nt).tolist())) == nt
    _assert_stores_equal(jstore, tstore)
    _assert_tables_equal(jtab, ttab)
    jtab, nj = js.stream_in(jtab, jstore, cam_pos, _radius(APP_J, 100.0))
    ttab, nt = ts.stream_in(ttab, tstore, cam_pos, _radius(APP_T, 100.0))
    assert nj == nt > 0 and len(tstore) == 0
    _assert_stores_equal(jstore, tstore)
    _assert_tables_equal(jtab, ttab)


def _reallocate(jtab, ttab, back, data=None):
    """Allocate ``back`` on both devices again with the same fresh data (the
    camera came back while their cold copies sit in the host store): the
    (sdf, weight, colour) rows of ``data``, or random ones. Returns both
    tables and the port's slots of ``back``."""
    if data is None:
        rng = np.random.default_rng(7)
        data = (rng.uniform(-0.05, 0.05, (len(back), 512)).astype(np.float32),
                rng.uniform(0.0, 3.0, (len(back), 512)).astype(np.float32),
                rng.uniform(0.0, 2.0, (len(back), 1536)).astype(np.float32))
    sdf, wgt, col = data
    jtab, _ = jb.allocate(jtab, jnp.asarray(back))
    sj, _ = jb.lookup(jtab, jnp.asarray(back))
    jtab = jtab._replace(sdf=jtab.sdf.at[sj].set(sdf), weight=jtab.weight.at[sj].set(wgt),
                         color=jtab.color.at[sj].set(col))
    back_t = torch.as_tensor(back)
    ttab, _ = tb.allocate(ttab, back_t)
    st, _ = tb.lookup(ttab, back_t)
    st = st.long()
    ttab.sdf[st], ttab.weight[st], ttab.color[st] = torch.as_tensor(sdf), torch.as_tensor(wgt), torch.as_tensor(col)
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    return jtab, ttab, st


def test_stream_in_merges_a_block_reallocated_while_cold(fused):
    """Blocks re-allocated on the device while their cold copies sit in the
    host store (the camera came back) are merged by weighted mean."""
    np_table, cam_pos = fused
    jtab, ttab = _jax_table(np_table), interop.state_from_numpy(np_table, "cpu")
    jstore, tstore = js.HostBlockStore(), ts.HostBlockStore()
    jtab, n = js.stream_out(jtab, jstore, cam_pos, _radius(APP_J, 1.0))
    ttab, _ = ts.stream_out(ttab, tstore, cam_pos, _radius(APP_T, 1.0))
    # half of the evicted keys come back on the device with fresh data
    jtab, ttab, st = _reallocate(jtab, ttab, np.sort(_evicted(jstore, n)[::2]))
    jtab, nj = js.stream_in(jtab, jstore, cam_pos, _radius(APP_J, 100.0))
    ttab, nt = ts.stream_in(ttab, tstore, cam_pos, _radius(APP_T, 100.0))
    assert nj == nt == n
    for k in ("keys", "slot_of", "key_of_slot"):
        np.testing.assert_array_equal(np.asarray(getattr(jtab, k)), getattr(ttab, k).numpy())
    merged = st.numpy()
    for k in ("sdf", "weight", "color"):
        a, b = np.asarray(getattr(jtab, k)), getattr(ttab, k).numpy()
        np.testing.assert_allclose(b[merged], a[merged], rtol=1e-6, atol=1e-9, err_msg=k)
        np.testing.assert_array_equal(np.delete(a, merged, axis=0), np.delete(b, merged, axis=0), err_msg=k)


@pytest.fixture
def stored_twice(fused):
    """Stores that hold keys twice: blocks evicted, re-allocated while cold
    (their surface seen again 1 cm further out, with more weight and another
    colour), and evicted again before a stream-in merged them. Returns the
    JAX and the port (table, store) and the camera position."""
    np_table, cam_pos = fused
    jtab, ttab = _jax_table(np_table), interop.state_from_numpy(np_table, "cpu")
    jstore, tstore = js.HostBlockStore(), ts.HostBlockStore()
    jtab, n = js.stream_out(jtab, jstore, cam_pos, _radius(APP_J, 1.0))
    ttab, _ = ts.stream_out(ttab, tstore, cam_pos, _radius(APP_T, 1.0))
    rows = np.arange(jstore._cap - n, jstore._cap)[::2]  # every second evicted block
    back, wgt = jstore._keys[rows], jstore._wgt[rows]
    again = (jstore._sdf[rows] + 0.01, np.where(wgt > 0, wgt + 1.0, 0.0).astype(np.float32), 0.5 * jstore._col[rows])
    jtab, ttab, _ = _reallocate(jtab, ttab, back, again)
    jtab, nj = js.stream_out(jtab, jstore, cam_pos, _radius(APP_J, 1.0))
    ttab, nt = ts.stream_out(ttab, tstore, cam_pos, _radius(APP_T, 1.0))
    assert nj == nt == len(back)
    _assert_stores_equal(jstore, tstore)
    live = np.concatenate([tstore._keys[rows] for rows in tstore._chunks.values()])
    assert len(live) == n + len(back) and len(np.unique(live)) == n
    return (jtab, jstore), (ttab, tstore), cam_pos


def test_stream_in_of_a_key_stored_twice_matches_jax(stored_twice):
    """The JAX package scatters such a batch in order (the last copy's sdf
    and weight, every copy's colour); the port writes the same. Bit-equal:
    the device rows are fresh, so each merge is a copy's own data."""
    (jtab, jstore), (ttab, tstore), cam_pos = stored_twice
    n = len(tstore)
    jtab, nj = js.stream_in(jtab, jstore, cam_pos, _radius(APP_J, 100.0))
    ttab, nt = ts.stream_in(ttab, tstore, cam_pos, _radius(APP_T, 100.0))
    assert nj == nt == n and len(tstore) == 0
    _assert_stores_equal(jstore, tstore)
    _assert_tables_equal(jtab, ttab)


def test_mesh_paging_of_a_key_stored_twice_matches_jax(stored_twice):
    """``extract_mesh`` pages the host store through scratch tables, where
    the JAX package keeps the last copy of a key stored twice; so does the
    port. Bars of ``test_torch_mesh.py``: equal faces, vertices and colours
    within 1e-5."""
    (jtab, jstore), (ttab, tstore), _ = stored_twice
    cam = cached_sequence(8, width=64, height=48).camera
    jbf = JaxBF(cam, j_tiny())
    tbf = PortBF(cam, t_tiny(), device="cpu")
    jbf.table, jbf.block_store = jtab, jstore
    tbf.state.table, tbf.block_store = ttab, tstore
    vj, cj, fj = jbf.extract_mesh()
    vt, ct, ft = tbf.extract_mesh()
    device_only = len(tmc.extract_mesh(ttab, APP_T)[2])
    assert len(ft) == len(fj) > device_only
    np.testing.assert_array_equal(fj, ft)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-5)


def test_free_slots_by_mask_matches_jax(fused):
    np_table, _ = fused
    dead = np.zeros(APP_J.block_capacity, bool)
    dead[np.flatnonzero(np_table.key_of_slot != jb.INVALID_KEY)[::3]] = True
    j = jb.free_slots_by_mask(_jax_table(np_table), jnp.asarray(dead))
    t = tb.free_slots_by_mask(interop.state_from_numpy(np_table, "cpu"), torch.as_tensor(dead))
    _assert_tables_equal(j, t)


def test_host_store_carries_across(fused):
    np_table, cam_pos = fused
    jstore = js.HostBlockStore(chunk_blocks=4)
    js.stream_out(_jax_table(np_table), jstore, cam_pos, _radius(APP_J, 1.0))
    tstore = interop.host_store_from(jstore)
    _assert_stores_equal(jstore, tstore)
    near = cam_pos + 1.0
    assert tstore.chunks_near(near, 2.0, APP_T.voxel_size) == jstore.chunks_near(near, 2.0, APP_J.voxel_size)
    for a, b in zip(jstore.take_chunks(list(jstore._chunks)[:2], 50), tstore.take_chunks(list(tstore._chunks)[:2], 50)):
        np.testing.assert_array_equal(a, b)
    _assert_stores_equal(jstore, tstore)


# --- the pipeline with streaming on ---------------------------------------

W, H, N = 128, 96, 21


def _stream_cfg(tiny):
    c = tiny()
    app = dataclasses.replace(
        c.app, input_width=W, input_height=H, integration_width=W, integration_height=H,
        streaming_enabled=True, streaming_radius=2.2, streaming_watermark=0.0, streaming_check_every=1,
    )
    return dataclasses.replace(c, app=app)


@pytest.fixture(scope="module")
def stream_runs():
    seq = cached_sequence(N, width=W, height=H)
    mp = pytest.MonkeyPatch()
    mp.setattr(jfw, "_load", lambda: None)
    try:
        bj, oj = jax_run(Replayer(SyntheticSource(seq), batch_size=8), _stream_cfg(j_tiny), anchor_pose=seq.poses[0])
    finally:
        mp.undo()
    bt, ot = port_run(Replayer(SyntheticSource(seq), batch_size=8), _stream_cfg(t_tiny), anchor_pose=seq.poses[0],
                      device="cpu")
    return (bj, oj), (bt, ot)


def _stream_records(bf):
    return [(r["chunk"], r["stream_in"], r["stream_out"], r["host_blocks"]) for r in bf.runlog.records
            if "stream_out" in r]


def test_pipeline_streaming_matches_jax(stream_runs):
    (bj, oj), (bt, ot) = stream_runs
    assert len(bt.block_store) > 0, "the tight radius must evict far blocks"
    assert len(bt.block_store) == len(bj.block_store)
    assert _stream_records(bt) == _stream_records(bj)
    np.testing.assert_array_equal(oj.valid, ot.valid)
    err = float(np.abs(oj.poses - ot.poses).max())
    print(f"max |pose jax - port| = {err:.3g}")
    # Streaming moves TSDF blocks only; tracking never reads the TSDF. On
    # these 21 frames the two implementations' global solves already differ
    # by 1.13e-5 m in translation (4.2e-6 in rotation) with streaming off:
    # f32 GN/PCG sums in another order stop at the PCG gate at other points
    # (ROADMAP Queue 3). Hence 2e-5, not 1e-5.
    assert err <= 2e-5
    assert int(bt.state.table.num_active()) == int(bj.table.num_active())


def test_pipeline_streaming_mesh_covers_the_host_store(stream_runs):
    _, (bt, _) = stream_runs
    verts, cols, faces = bt.extract_mesh()
    dev_only, _, _ = tmc.extract_mesh(bt.state.table, bt.config.app)
    assert len(verts) > 500 and len(verts) > len(dev_only)
    assert faces.shape == (len(verts) // 3, 3) and cols.shape == verts.shape
    assert np.isfinite(verts).all()
