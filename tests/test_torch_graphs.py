"""The chunk step's execution model (``utils/graphs.py``): what a CUDA graph
captured at one chunk needs in order to replay correctly at the next, shown
on the CPU, where nothing is captured (the card's graphed and eager passes
are held bit-equal by ``chip_smoke.py``'s phase "graphs").

* chunk invariance: each steady stage runs the same operations, with the
  same argument shapes, dtypes and non-tensor arguments, at chunks 2 and 3
  (a graph replays exactly the captured launches), and chunk 0's
  chunk_local, publish and plan_fuse run chunk 2's (one program serves
  every chunk; chunk 0's graph step is a program of its own);
* stable addresses: no state tensor, step input, static wire buffer or
  carry moves during chunks 0-3 (a graph addresses them);
* reuse: a pipeline on a reused executable gives bit for bit what a fresh
  one gives (over chunks 0 and 1: chunk 0's step and a steady one); the
  in-place reset leaves every state tensor as a fresh executable's;
* ``disable_graphs()`` nests and restores; a replay on inputs at other
  addresses raises.

128x96 at the tiny configuration: one pass of 17 frames (chunks 0-3) with
the operations of every chunk recorded, and 9 frames on the reused
executable. The multi-sequence driver, the mesh pipeline's global solve
and GC are ``test_torch_graphs_sharded.py``.

On a card (marked ``cuda``, skipped elsewhere; this file imports no JAX
there: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_graphs.py`` from the repo root), the graph step's slot
tiers: a 256-slot pipeline over a 70-chunk scan crosses tiers 64 and 128;
every tier is captured at the first steady chunk and replayed at every
chunk that uses it, the timeline's ``graph_slots`` reads the ladder, and
the graphed and ``disable_graphs()`` passes are bit-equal
(``chip_smoke.tier_scan``).
"""

import contextlib
import dataclasses
import gc

import numpy as np
import pytest
import torch

from bundlefusion_tpu_torch.bundle import pipeline as tpipe
from bundlefusion_tpu_torch.bundle import step as tstep
from bundlefusion_tpu_torch.config import tiny_test_config
from bundlefusion_tpu_torch.utils import graphs
from torch_oplog import OpLog, assert_same_ops

W, H, N = 128, 96, 17  # chunks 0-3 (S = 4)
STEADY = ("chunk_local", "graph_step", "global_solve", "publish", "plan_fuse")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    c = tiny_test_config()
    return dataclasses.replace(c, app=dataclasses.replace(
        c.app, input_width=W, input_height=H, integration_width=W, integration_height=H))


def _state_tensors(bf) -> dict:
    out = {}

    def walk(prefix, obj):
        if dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                walk(f"{prefix}.{f.name}", getattr(obj, f.name))
        elif isinstance(obj, torch.Tensor):
            out[prefix] = obj
        elif isinstance(obj, tuple):
            for i, x in enumerate(obj):
                walk(f"{prefix}[{i}]", x)

    walk("state", bf.state)
    walk("step", bf._exe.state.step)
    walk("wire", bf._exe.state.wire)
    walk("carry", bf._exe.state.carry)
    return out


def _snapshot(bf) -> dict:
    """Poses, TSDF and runlog rows as they stand (copies)."""
    poses, valid = bf.current_poses()
    t = bf.state.table
    return dict(poses=poses, valid=valid, weight=t.weight.numpy().copy(), sdf=t.sdf.numpy().copy(),
                color=t.color.numpy().copy(), keys=t.keys.numpy().copy(),
                runlog=bf.state.runlog_rows[: bf.chunk_count].numpy().copy())


@pytest.fixture(scope="module")
def seq():
    from util import cached_sequence  # (the JAX package's renderer: the card's tests import no JAX)

    return cached_sequence(N, width=W, height=H)


def _pipeline(seq):
    """A pipeline that runs its ingest on the caller's thread."""
    mp = pytest.MonkeyPatch()
    mp.setenv("BF_SYNC_INGEST", "1")
    try:
        return tpipe.BundleFusion(seq.camera, _cfg(), anchor_pose=seq.poses[0], device="cpu")
    finally:
        mp.undo()


def _push_recorded(bf, seq, frames: int, ptrs: dict | None = None, snapshot_at: int | None = None):
    """Push ``frames`` frames with every operation of the stages recorded by
    (chunk, stage), and with ``ptrs`` the state's addresses before and after
    each stage. Returns (operations, the snapshot after frame
    ``snapshot_at``)."""
    log, snap = OpLog(), None
    stage_of = bf.timing.stage

    @contextlib.contextmanager
    def stage(name, block=False, **kw):
        key = (bf.chunk_count, name)
        if ptrs is not None:
            ptrs[(key, "before")] = {k: t.data_ptr() for k, t in _state_tensors(bf).items()}
        log.key = key if name in STEADY else None
        with stage_of(name, block=block, **kw):
            yield
        log.key = None
        if ptrs is not None:
            ptrs[(key, "after")] = {k: t.data_ptr() for k, t in _state_tensors(bf).items()}

    bf.timing.stage = stage
    try:
        with log:
            for i in range(frames):
                bf.push_frame(seq.depth[i], seq.color[i])
                if i == snapshot_at:
                    snap = _snapshot(bf)
    finally:
        del bf.timing.stage  # no cycle through the hook: the pipeline frees its executable when dropped
    bf.sync()
    return log.ops, snap


@pytest.fixture(scope="module")
def recorded(seq):
    """One pass (chunks 0-3) with every operation of the stages recorded,
    and the addresses of the state before and after each stage; the state
    after chunk 1 is kept. Then the pipeline is dropped, so its executable
    returns to the cache. The cache starts empty: an idle executable of this
    configuration left by an earlier test in the process would be lent
    first."""
    gc.collect()
    tstep.EXECUTABLES.clear()
    bf, ptrs = _pipeline(seq), {}
    ops, after_chunk1 = _push_recorded(bf, seq, N, ptrs, snapshot_at=8)
    assert bf.chunk_count == 4
    exe = bf._exe
    del bf
    gc.collect()
    return dict(ops=ops, ptrs=ptrs, after_chunk1=after_chunk1, exe=exe)


@pytest.fixture(scope="module")
def reused(recorded, seq):
    """A second pipeline of the configuration, on the executable the
    recorded pass returned, over chunks 0 and 1 with their operations
    recorded."""
    bf = _pipeline(seq)
    ops, _ = _push_recorded(bf, seq, 9)
    assert bf.chunk_count == 2
    return dict(bf=bf, ops=ops)


@pytest.mark.parametrize("stage", STEADY)
def test_steady_stage_is_chunk_invariant(recorded, stage):
    """A stage runs the same operations with the same arguments at chunks
    2 and 3: a graph captured at one replays the other's work."""
    assert_same_ops(recorded["ops"][(2, stage)], recorded["ops"][(3, stage)], stage)


@pytest.mark.parametrize("stage", ("chunk_local", "publish", "plan_fuse"))
def test_chunk0_stage_is_the_steady_program(recorded, reused, stage):
    """Chunk 0 runs these stages through the programs every later chunk
    replays: the same operations with the same arguments as chunk 2's.
    Chunk 0 is the second pipeline's: a process's first call of a stage
    builds constants that it caches (``ops/preprocess.py::_gauss_band``),
    which on a card the eager run before each capture absorbs."""
    assert_same_ops(reused["ops"][(0, stage)], recorded["ops"][(2, stage)], f"{stage} at chunks 0 and 2")


def test_state_keeps_its_addresses(recorded):
    """No state tensor, step input, wire buffer or carry moves during chunks
    0-3 (every stage writes in place; chunk 0 has no global solve)."""
    ptrs = recorded["ptrs"]
    start = ptrs[((0, "chunk_local"), "before")]
    assert len(start) > 40
    for c in range(4):
        for stage in STEADY:
            if ((c, stage), "after") in ptrs:
                moved = sorted(k for k, p in ptrs[((c, stage), "after")].items() if p != start[k])
                assert not moved, f"chunk {c}, {stage}: {moved} moved"


def test_reused_executable_gives_the_same_result(recorded, reused, seq):
    """A pipeline on the executable the recorded pass returned (its state
    reset in place, after two more chunks) gives the fresh pipeline's poses,
    TSDF and runlog rows after chunk 1 bit for bit."""
    bf = reused["bf"]
    assert bf._exe is recorded["exe"]
    got, want = _snapshot(bf), recorded["after_chunk1"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a second live pipeline of the same configuration gets its own
    other = tpipe.BundleFusion(seq.camera, _cfg(), anchor_pose=seq.poses[0], device="cpu")
    assert other._exe is not bf._exe


def test_reset_state_equals_a_fresh_one(seq):
    """A reused executable's reset (in place, nothing of the state's size
    allocated) leaves every tensor of the fusion state and the step inputs
    as a fresh executable's, with the new anchor; the fresh state's anchor
    is a copy, so the reset does not write the caller's array."""
    cfg, anchor = _cfg(), seq.poses[0].copy()
    bf = _pipeline(seq)
    st, step = bf.state, bf._exe.state.step
    fresh = tstep.make_fusion_state(cfg, bf.int_cam, tuple(bf.state.hist_c8.shape[1:3]), anchor, "cpu")
    ptrs = [t.data_ptr() for t in graphs.tensors(st)]
    for t in graphs.tensors((st, step)):
        t.fill_(True) if t.dtype == torch.bool else t.fill_(3)
    tstep.reset_fusion_state(st, anchor)
    tstep.reset_step(step)
    assert [t.data_ptr() for t in graphs.tensors(st)] == ptrs
    want = graphs.tensors((fresh, tstep.step_inputs(0, bf.S, bf.chunk_frames, "cpu")))
    for got, w in zip(graphs.tensors((st, step)), want, strict=True):
        assert torch.equal(got, w)
    np.testing.assert_array_equal(anchor, seq.poses[0])


def test_disable_graphs_nests_and_restores():
    assert graphs.graphs_enabled()
    with graphs.disable_graphs():
        assert not graphs.graphs_enabled()
        with graphs.disable_graphs():
            assert not graphs.graphs_enabled()
        assert not graphs.graphs_enabled()
    assert graphs.graphs_enabled()
    with pytest.raises(ValueError):
        with graphs.disable_graphs():
            raise ValueError("inside")
    assert graphs.graphs_enabled()


def test_program_checks_its_inputs():
    """A program runs its function on the CPU or when not graphed; the
    signature it bakes in covers addresses, shapes and other values."""
    calls = []
    prog = graphs.Program("p", lambda x, n: calls.append(n) or x + n, None)
    x = torch.zeros(3)
    assert torch.equal(prog(x, 2, graphed=False), torch.full((3,), 2.0))
    assert calls == [2] and prog.graph is None and not prog.warm
    assert graphs._signature((x, 2)) == graphs._signature((x, 2))
    assert graphs._signature((x, 2)) != graphs._signature((x.clone(), 2))
    assert graphs._signature((x, 2)) != graphs._signature((x, 3))


def test_executable_cache_lends_one_owner_at_a_time():
    class Owner:
        pass

    cache = graphs.ExecutableCache(max_free=1)
    built = []

    def build():
        built.append(graphs.Executable(torch.device("cpu"), len(built)))
        return built[-1]

    a, b = Owner(), Owner()
    ea, reused_a = cache.checkout(a, "k", build)
    eb, reused_b = cache.checkout(b, "k", build)
    assert ea is not eb and not reused_a and not reused_b
    del a
    gc.collect()
    c = Owner()
    ec, reused_c = cache.checkout(c, "k", build)
    assert ec is ea and reused_c
    del b, c
    gc.collect()  # two returned, one kept
    assert len(cache._free) == 1


@pytest.mark.cuda
def test_slot_tiers_on_the_card():
    """A 256-slot pipeline (tiers 64, 128, 256) over a 70-chunk scan on the
    card, graphed on a fresh executable and eager: each tier's graph step
    is captured once, at chunk 1, before any chunk that uses it (it
    replays at every chunk of its tier, the first tier at all but its
    first, eager one); ``graph_slots`` is 0, then 64 for chunks 1-63 and
    128 after; state digests, poses and validity bit-equal
    (``chip_smoke.check_tier_scan``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from chip_smoke import TIER_CHUNKS, check_tier_scan, tier_scan

    from bundlefusion_tpu_torch.io.synthetic import generate_sequence

    dev = torch.device("cuda", 0)
    c = _cfg()
    cfg = dataclasses.replace(c, bundling=dataclasses.replace(c.bundling, max_num_images=256, max_frames=512))
    seq = generate_sequence(TIER_CHUNKS * cfg.bundling.submap_size + 1, W, H, device=dev)
    gc.collect()
    tstep.EXECUTABLES.clear()
    graphed = tier_scan(torch, seq, cfg, dev, "graphed")
    eager = tier_scan(torch, seq, cfg, dev, "eager")
    out = check_tier_scan(graphed, eager, cfg, TIER_CHUNKS)
    assert out["replays"] == {"graph_step@64": 62, "graph_step@128": 6, "graph_step@256": 0}, out
