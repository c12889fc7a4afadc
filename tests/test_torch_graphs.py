"""The chunk step's execution model (``utils/graphs.py``): what a CUDA graph
captured at one chunk needs in order to replay correctly at the next, shown
on the CPU, where nothing is captured (the card's graphed and eager passes
are held bit-equal by ``chip_smoke.py``'s phase "graphs").

* chunk invariance: each steady stage runs the same operations, with the
  same argument shapes, dtypes and non-tensor arguments, at chunks 2 and 3
  (a graph replays exactly the captured launches);
* stable addresses: no state tensor, step input or static wire buffer moves
  during a steady chunk (a graph addresses them);
* reuse: a pipeline on a reused executable gives bit for bit what a fresh
  one gives (over chunks 0 and 1: chunk 0's step and a steady one);
* ``disable_graphs()`` nests and restores; a replay on inputs at other
  addresses raises.

128x96 at the tiny configuration: one pass of 17 frames (chunks 0-3) with
the operations of chunks 2 and 3 recorded, and 9 frames on the reused
executable.
"""

import contextlib
import dataclasses
import gc

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from bundlefusion_tpu_torch.bundle import pipeline as tpipe
from bundlefusion_tpu_torch.config import tiny_test_config
from bundlefusion_tpu_torch.utils import graphs
from util import cached_sequence

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


def _arg(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype)
    return repr(x)


class _OpLog(TorchDispatchMode):
    """Every operation, with its arguments described, under the current
    (chunk, stage) key."""

    def __init__(self):
        super().__init__()
        self.key = None
        self.ops: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # (the profiler's span markers are no device work)
        if self.key is not None and not str(func).startswith("profiler."):
            leaves, _ = tree_flatten((args, kwargs or {}))
            self.ops.setdefault(self.key, []).append((str(func), tuple(_arg(x) for x in leaves)))
        return func(*args, **(kwargs or {}))


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
    walk("step", bf._step)
    walk("wire", bf._wire)
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
    return cached_sequence(N, width=W, height=H)


@pytest.fixture(scope="module")
def recorded(seq):
    """One pass on the caller's thread with every operation of the steady
    stages of chunks 2 and 3 recorded, and the addresses of the state
    before and after each stage; the state after chunk 1 is kept. Then the
    pipeline is dropped, so its executable returns to the cache."""
    mp = pytest.MonkeyPatch()
    mp.setenv("BF_SYNC_INGEST", "1")
    try:
        bf = tpipe.BundleFusion(seq.camera, _cfg(), anchor_pose=seq.poses[0], device="cpu")
    finally:
        mp.undo()
    log, ptrs = _OpLog(), {}
    stage_of = bf.timing.stage

    @contextlib.contextmanager
    def stage(name, block=False):
        key = (bf.chunk_count, name)
        ptrs[(key, "before")] = {k: t.data_ptr() for k, t in _state_tensors(bf).items()}
        log.key = key if name in STEADY else None
        with stage_of(name, block=block):
            yield
        log.key = None
        ptrs[(key, "after")] = {k: t.data_ptr() for k, t in _state_tensors(bf).items()}

    bf.timing.stage = stage
    for i in range(12):  # chunks 0 and 1
        bf.push_frame(seq.depth[i], seq.color[i])
        if i == 8:
            after_chunk1 = _snapshot(bf)
    with log:
        for i in range(12, N):  # chunks 2 and 3
            bf.push_frame(seq.depth[i], seq.color[i])
    del bf.timing.stage
    assert bf.chunk_count == 4
    exe = bf._exe
    del bf, stage
    gc.collect()
    return dict(ops=log.ops, ptrs=ptrs, after_chunk1=after_chunk1, exe=exe)


@pytest.mark.parametrize("stage", STEADY)
def test_steady_stage_is_chunk_invariant(recorded, stage):
    """A stage runs the same operations with the same arguments at chunks
    2 and 3: a graph captured at one replays the other's work."""
    a, b = recorded["ops"][(2, stage)], recorded["ops"][(3, stage)]
    assert len(a) > 10
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    assert first is None and len(a) == len(b), (
        f"{stage}: {len(a)} against {len(b)} operations; first difference at {first}: "
        f"{a[first] if first is not None else ''} / {b[first] if first is not None else ''}")


def test_state_keeps_its_addresses(recorded):
    """No state tensor, step input or wire buffer moves during steady chunks
    2 and 3 (every stage writes in place)."""
    ptrs = recorded["ptrs"]
    start = ptrs[((2, "chunk_local"), "before")]
    assert len(start) > 40
    for c in (2, 3):
        for stage in STEADY:
            moved = sorted(k for k, p in ptrs[((c, stage), "after")].items() if p != start[k])
            assert not moved, f"chunk {c}, {stage}: {moved} moved"


def test_reused_executable_gives_the_same_result(recorded, seq):
    """A pipeline on the executable the recorded pass returned (its state
    reset in place, after two more chunks) gives the fresh pipeline's poses,
    TSDF and runlog rows after chunk 1 bit for bit."""
    bf = tpipe.BundleFusion(seq.camera, _cfg(), anchor_pose=seq.poses[0], device="cpu")
    assert bf._exe is recorded["exe"]
    for i in range(9):
        bf.push_frame(seq.depth[i], seq.color[i])
    bf.sync()
    assert bf.chunk_count == 2
    got, want = _snapshot(bf), recorded["after_chunk1"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a second live pipeline of the same configuration gets its own
    other = tpipe.BundleFusion(seq.camera, _cfg(), anchor_pose=seq.poses[0], device="cpu")
    assert other._exe is not bf._exe


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
