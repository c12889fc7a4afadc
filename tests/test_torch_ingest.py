"""The ingest stage: the port's wire (12-bit depth, the flat chunk layout and
its device unpack), its native converter, and the pipeline's async ingest,
against the JAX package and across the port's three ingest modes.

Bars: packing, unpacking, layout and the native conversions give equal
bytes; the native bilateral with four OpenMP threads is within 1 mm of the
numpy one with equal zero masks (the JAX package's native bilateral fails
that bar with more than one thread: its range table is filled on the calling
thread only); async ingest, ``BF_SYNC_INGEST=1`` and ``profile=True`` give
bit-identical state; the held-to-JAX pipeline bars stay in
``test_torch_pipeline.py``, which runs the port's default (async) ingest.
"""

import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.bundle import pipeline as jpipe
from bundlefusion_tpu.io import framewire as jfw
from bundlefusion_tpu_torch.bundle import chunk as tchunk
from bundlefusion_tpu_torch.bundle import pipeline as tpipe
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.io import framewire as tfw
from util import cached_sequence

W, H, N = 128, 96, 9  # two chunks: chunk 0 and one steady chunk
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_numpy_wire(monkeypatch):
    """The JAX package's numpy branch is the reference (its native bilateral
    is wrong with more than one thread)."""
    monkeypatch.setattr(jfw, "_load", lambda: None)


@pytest.fixture(scope="module")
def native():
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native converter cannot be built on this host")
    assert tfw.have_native()


def _d16(shape, seed, top=4096):
    rng = np.random.default_rng(seed)
    d = rng.integers(1, top, shape).astype(np.uint16)
    d[rng.random(shape) < 0.1] = 0
    return d


def _frame(h, w, seed):
    """A float32 frame with out-of-range depth and colour and depth holes."""
    rng = np.random.default_rng(seed)
    depth = (rng.uniform(-0.5, 5.0, (h, w)) * (rng.random((h, w)) > 0.07)).astype(np.float32)
    color = rng.uniform(-0.2, 1.2, (h, w, 3)).astype(np.float32)
    return depth, color


SHAPES = [(48, 64), (480, 640)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("branch", ["native", "numpy"])
def test_pack_depth12_matches_jax(shape, branch, monkeypatch):
    if branch == "native":
        if shutil.which("g++") is None:
            pytest.skip("g++ is missing")
    else:
        monkeypatch.setattr(tfw, "_load", lambda: None)
    d = _d16(shape, 1)
    want = jfw.pack_depth12(d)
    got = tfw.pack_depth12(d)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    out = np.zeros((shape[0], shape[1] // 2 * 3), np.uint8)
    assert tfw.pack_depth12(d, out=out) is out and out.tobytes() == want.tobytes()


@pytest.mark.parametrize("pack12", [True, False])
@pytest.mark.parametrize("int_res", [(96, 128), (48, 64)])
def test_unpack_wire_matches_jax(pack12, int_res):
    """A chunk buffer laid out by the port's ``_wire_views`` unpacks on both
    sides to the same arrays, and to the rows that were packed."""
    cf, h, w = 3, 96, 128
    hi, wi = int_res
    dims = (h, w, hi, wi, pack12)
    n = tpipe._wire_nbytes(cf, *dims)
    assert n == jpipe._wire_nbytes(cf, *dims)
    rng = np.random.default_rng(2)
    top = 4096 if pack12 else 65536
    rows = [(_d16((h, w), 10 + i, top), rng.integers(0, 256, (h, w), dtype=np.uint8),
             rng.integers(0, 256, (h // 2, w // 2, 3), dtype=np.uint8), _d16((hi, wi), 20 + i, top),
             rng.integers(0, 256, (hi // 2, wi // 2, 3), dtype=np.uint8)) for i in range(cf)]
    flat = np.zeros(n, np.uint8)
    views = tpipe._wire_views(flat, cf, *dims)
    assert len(views) == (3 if (hi, wi) == (h, w) else 5)
    for i, r in enumerate(rows):
        for k, (v, x) in enumerate(zip(views, r)):
            if pack12 and k in (0, 3):
                tfw.pack_depth12(x, out=v[i])
            else:
                v[i] = x
    got = tpipe._unpack_wire(torch.as_tensor(flat), cf, *dims)
    want = jpipe._unpack_wire(jnp.asarray(flat), cf, *dims)
    for k, (g, j) in enumerate(zip(got, want)):
        g = g.numpy()
        if g.dtype == np.int16:
            g = g.view(np.uint16)
        assert g.dtype == np.asarray(j).dtype and np.array_equal(g, np.asarray(j)), k
        ref = np.stack([r[k if len(views) == 5 else (0, 1, 2, 0, 2)[k]] for r in rows])
        assert np.array_equal(g, ref), k


@pytest.mark.parametrize("shape", SHAPES)
def test_native_conversions_match_numpy(native, shape):
    h, w = shape
    depth, color = _frame(h, w, 3)
    for got, want in ((tfw.frame_to_wire(depth, color), tfw._frame_to_wire_np(depth, color)),
                      (tfw.frame_to_wire2(depth, color, depth_min=0.1, depth_max=4.0),
                       tfw._frame_to_wire2_np(depth, color, 0.1, 4.0))):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # into the caller's buffers (the pipeline's FrameStore slab rows)
    slab = (np.empty((2, h, w), np.uint16), np.empty((2, h, w), np.uint8), np.empty((2, h // 2, w // 2, 3), np.uint8))
    out = tfw.frame_to_wire2(depth, color, out=tuple(x[1] for x in slab), depth_min=0.1, depth_max=4.0)
    assert all(np.shares_memory(o, x) for o, x in zip(out, slab))
    d16 = out[0]
    assert d16.max() < 4096 and tfw.pack_depth12(d16).tobytes() == tfw._pack_depth12_np(d16).tobytes()


_BILATERAL = """
import json, numpy as np
from bundlefusion_tpu_torch.io import framewire as f
h, w = 480, 640
rng = np.random.default_rng(0)
yy, xx = np.mgrid[0:h, 0:w]
d = (1.5 + 0.3 * np.sin(xx / 17.0) + 0.2 * np.cos(yy / 11.0) + rng.normal(0, 0.004, (h, w))).astype(np.float32)
d[rng.random((h, w)) < 0.05] = 0
d16 = f.frame_to_wire(d, np.zeros((h, w, 3), np.float32))[0]
res = {"native": f.have_native()}
for sd, sr in ((2.0, 0.1), (1.0, 0.03)):
    a, b = f.bilateral_wire(d16, sd, sr), f._bilateral_wire_np(d16, sd, sr)
    diff = np.abs(a.astype(np.int64) - b.astype(np.int64))
    res[f"{sd}/{sr}"] = dict(differ=int((diff > 0).sum()), max=int(diff.max()),
                             zeros_equal=bool(np.array_equal(a == 0, b == 0)), zeroed=int(((a == 0) & (b != 0)).sum()),
                             moved=int((b != d16).sum()))
print(json.dumps(res))
"""


def test_native_bilateral_with_four_threads(native):
    """The native bilateral in a process with four OpenMP threads: within
    1 mm of numpy with equal zero masks at 640x480 (a table filled on the
    calling thread only would zero about three quarters of the frame)."""
    env = dict(os.environ, OMP_NUM_THREADS="4", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _BILATERAL], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"native bilateral, 4 threads, 640x480: {res}")
    assert res.pop("native")
    for r in res.values():
        assert r["max"] <= 1 and r["zeros_equal"] and r["zeroed"] == 0 and r["moved"] > 100_000
        assert r["differ"] <= 0.001 * 640 * 480


# --- the pipeline's ingest ------------------------------------------------------------

def _cfg(**app):
    c = t_tiny()
    return dataclasses.replace(c, app=dataclasses.replace(
        c.app, input_width=W, input_height=H, integration_width=W, integration_height=H, **app))


def _run(monkeypatch, mode):
    seq = cached_sequence(N, width=W, height=H)
    with monkeypatch.context() as mp:
        if mode == "sync":
            mp.setenv("BF_SYNC_INGEST", "1")
        bf = tpipe.BundleFusion(seq.camera, _cfg(), anchor_pose=seq.poses[0], device="cpu",
                                profile=(mode == "profile"))
    for i in range(N):
        bf.push_frame(seq.depth[i], seq.color[i])
    bf.flush()
    return bf, bf.outputs()


@pytest.fixture(scope="module")
def modes():
    mp = pytest.MonkeyPatch()
    try:
        return {m: _run(mp, m) for m in ("async", "sync", "profile")}
    finally:
        mp.undo()


def test_ingest_modes_are_bit_identical(modes):
    (ba, oa) = modes["async"]
    assert ba._async_ingest and not modes["sync"][0]._async_ingest and not modes["profile"][0]._async_ingest
    assert oa.num_keyframes == 2 and oa.valid.all()
    for m in ("sync", "profile"):
        b, o = modes[m]
        assert np.array_equal(o.poses, oa.poses) and np.array_equal(o.valid, oa.valid), m
        for k in ("keys", "sdf", "weight", "color"):
            assert torch.equal(getattr(b.state.table, k), getattr(ba.state.table, k)), (m, k)
        assert torch.equal(b.state.hist_d16, ba.state.hist_d16) and torch.equal(b.state.hist_c8, ba.state.hist_c8)
        assert b.runlog.records == ba.runlog.records, m
        assert b.upload_bytes == ba.upload_bytes
    assert set(modes["profile"][0].timing.summary()) >= {"upload", "chunk_local", "plan_fuse"}


def test_upload_bytes_match_jax_wire(modes):
    """Chunk 0 carries chunk_frames rows, every later chunk the S new ones,
    in the JAX package's layout with the 12-bit depth wire (depth_max 4 m)."""
    bf = modes["async"][0]
    assert bf._pack12
    cf, s = bf.chunk_frames, bf.S
    dims = (H, W, H, W, True)
    assert bf.upload_bytes == [jpipe._wire_nbytes(cf, *dims), jpipe._wire_nbytes(s, *dims)]
    assert bf.upload_bytes[1] == s * (W * H // 2 * 3 + W * H + W * H // 4 * 3)


def test_sixteen_bit_wire_without_the_ceiling(monkeypatch):
    """Above a 4.095 m ceiling depth travels as uint16 and the chunk step
    receives the same depth rows as the FrameStore (the step itself is
    replaced by a recorder: the modes above run it)."""
    seen = []

    def record(bf, d_wire, *a):
        seen.append(d_wire.clone())
        bf.chunk_count += 1

    monkeypatch.setattr(tpipe.BundleFusion, "_process_chunk", record)
    seq = cached_sequence(9, width=W, height=H)
    bf = tpipe.BundleFusion(seq.camera, _cfg(depth_max=5.0), anchor_pose=seq.poses[0], device="cpu")
    for i in range(9):
        bf.push_frame(seq.depth[i], seq.color[i])
    bf.sync()
    assert len(seen) == bf.chunk_count == 2
    assert not bf._pack12 and bf.upload_bytes[1] == bf.S * (W * H * 2 + W * H + W * H // 4 * 3)
    for c, d in enumerate(seen):
        want = np.stack([bf._frame_store[c * bf.S + i][0] for i in range(bf.chunk_frames)])
        assert np.array_equal(d.numpy().view(np.uint16), want)


@pytest.mark.parametrize("stage", ["dispatch", "upload"])
def test_worker_failure_reraises_from_sync(monkeypatch, stage):
    """An exception on a worker surfaces from sync(), in chunk order (an
    upload's through its chunk's dispatch)."""
    seq = cached_sequence(9, width=W, height=H)

    def boom(*a, **k):
        raise RuntimeError(f"injected {stage} failure")

    monkeypatch.setattr(tchunk, "process_chunk", boom)
    if stage == "upload":
        monkeypatch.setattr(tpipe, "_unpack_wire", boom)
    bf = tpipe.BundleFusion(seq.camera, _cfg(), anchor_pose=seq.poses[0], device="cpu")
    for i in range(9):
        bf.push_frame(seq.depth[i], seq.color[i])
    with pytest.raises(RuntimeError, match=f"injected {stage} failure"):
        bf.sync()
    assert bf.chunk_count == 0


def test_second_pipeline_reuses_pooled_buffers():
    # earlier pipelines return their buffers first: a failed one is held by a
    # cycle through its futures' tracebacks until a collection
    gc.collect()
    seq = cached_sequence(2, width=W, height=H)
    cfg = _cfg()
    bf = tpipe.BundleFusion(seq.camera, cfg, anchor_pose=seq.poses[0], device="cpu")
    bf.push_frame(seq.depth[0], seq.color[0])
    ptrs = {b.flat.data_ptr() for b in [bf._stage_full, *bf._stage, *bf._fs_slabs]}
    assert len(ptrs) == 5
    del bf
    gc.collect()
    bf2 = tpipe.BundleFusion(seq.camera, cfg, anchor_pose=seq.poses[0], device="cpu")
    bf2.push_frame(seq.depth[0], seq.color[0])
    assert {b.flat.data_ptr() for b in [bf2._stage_full, *bf2._stage, *bf2._fs_slabs]} == ptrs
    # the FrameStore row lives in the pooled slab
    assert np.shares_memory(bf2._frame_store[0][0], bf2._fs_slabs[0].flat.numpy())
