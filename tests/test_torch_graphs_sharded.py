"""The execution model (``utils/graphs.py``) of the multi-sequence driver,
the mesh pipeline's global solve and GC, shown on the CPU, where nothing is
captured (on the card ``chip_smoke.py`` holds graphed and eager runs of
each bit-equal):

* chunk invariance: each stage of each shard of ``ShardedRun`` runs the
  same operations, with the same argument shapes, dtypes and non-tensor
  arguments, at chunk rounds 2 and 3; so do a mesh pipeline's
  ``global_solve`` (the sharded solve) and ``gc`` at two calls;
* stable addresses: no shard state, step input, static wire buffer or carry
  moves during a round;
* reuse: a second ``ShardedRun`` on the executables the first returned
  gives, bit for bit, what the first gave;
* the eager route of a mesh over several devices is chosen from the mesh's
  layout.

128x96 at the tiny configuration: 2 CPU shards over 17 frames each (rounds
0-3), 9 frames each on the reused executables, and a 2-shard mesh pipeline
over 13 frames (chunks 0-2) with GC after every chunk.
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
from bundlefusion_tpu_torch.parallel.mesh import Mesh, make_mesh
from bundlefusion_tpu_torch.parallel.spmd_pipeline import ShardedRun
from bundlefusion_tpu_torch.utils import graphs
from torch_oplog import OpLog, assert_same_ops
from util import cached_sequence

W, H, N, D = 128, 96, 17, 2  # rounds 0-3 (S = 4)
SHARD_STAGES = ("chunk_local", "graph_step", "global_solve", "publish", "plan_fuse")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**app):
    c = tiny_test_config()
    return dataclasses.replace(c, app=dataclasses.replace(
        c.app, input_width=W, input_height=H, integration_width=W, integration_height=H, **app))


def _addresses(state) -> dict:
    out = {}

    def walk(prefix, obj):
        if dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                walk(f"{prefix}.{f.name}", getattr(obj, f.name))
        elif isinstance(obj, torch.Tensor):
            out[prefix] = obj.data_ptr()
        elif isinstance(obj, tuple):
            for i, x in enumerate(obj):
                walk(f"{prefix}[{i}]", x)

    walk("", state)
    return out


def _shard_snapshot(st) -> dict:
    t = st.table
    return dict(poses=st.traj.opt_pose.numpy().copy(), valid=st.traj.opt_valid.numpy().copy(),
                weight=t.weight.numpy().copy(), sdf=t.sdf.numpy().copy(), color=t.color.numpy().copy(),
                keys=t.keys.numpy().copy(), runlog=st.runlog_rows.numpy().copy())


@pytest.fixture(scope="module")
def seqs():
    return [cached_sequence(N, width=W, height=H, seed=s) for s in range(D)]


def _new_run(seqs):
    return ShardedRun(seqs, make_mesh(D, "cpu"), _cfg(), anchor_poses=np.stack([s.poses[0] for s in seqs]))


@pytest.fixture(scope="module")
def sharded(seqs):
    """Rounds 0-3 of a 2-shard run with each shard's addresses before and
    after every program call and, in rounds 2 and 3, every call's
    operations recorded by (round, shard, program); each shard's state
    after round 1 is kept. Then the run is dropped, so its executables
    return to the cache."""
    gc.collect()
    tstep.EXECUTABLES.clear()  # idle executables of earlier tests would be lent first
    run = _new_run(seqs)
    log, ptrs, at = OpLog(), {}, {}
    call = graphs.Program.__call__

    def logged(prog, *args, graphed=True):
        i = next(i for i, exe in enumerate(run.exes) if exe.programs.get(prog.name) is prog)
        key = (at["round"], i, prog.name.partition("@")[0])  # graph_step@T: the graph step at tier T
        ptrs[(key, "before")] = _addresses(run.exes[i].state)
        log.key = key
        try:
            return call(prog, *args, graphed=graphed)
        finally:
            log.key = None
            ptrs[(key, "after")] = _addresses(run.exes[i].state)

    mp = pytest.MonkeyPatch()
    mp.setattr(graphs.Program, "__call__", logged)
    try:
        for c in range(run.n_chunks):
            at["round"] = c
            with log if c >= 2 else contextlib.nullcontext():
                run.step(c)
            if c == 1:
                after_round1 = [_shard_snapshot(st) for st in run.shards]
    finally:
        mp.undo()
    assert run.n_chunks == 4
    exes, stats = list(run.exes), run.graph_stats
    del run, logged
    gc.collect()
    return dict(ops=log.ops, ptrs=ptrs, after_round1=after_round1, exes=exes, stats=stats)


@pytest.mark.parametrize("stage", SHARD_STAGES)
@pytest.mark.parametrize("shard", range(D))
def test_shard_stage_is_round_invariant(sharded, shard, stage):
    """Each shard's program runs the same operations with the same
    arguments at rounds 2 and 3."""
    ops = sharded["ops"]
    assert_same_ops(ops[(2, shard, stage)], ops[(3, shard, stage)], f"shard {shard}, {stage}")


def test_shard_state_keeps_its_addresses(sharded):
    """No shard state, step input, wire buffer or carry moves within a round
    (every program writes in place), and nothing moves between rounds."""
    ptrs = sharded["ptrs"]
    for shard in range(D):
        start = ptrs[((0, shard, "chunk_local"), "before")]
        assert len(start) > 40
        for (key, _), p in ptrs.items():
            if key[1] == shard:
                moved = sorted(k for k, a in p.items() if a != start[k])
                assert not moved, f"round {key[0]}, shard {shard}, {key[2]}: {moved} moved"


def test_shard_programs_and_stats(sharded):
    """Every shard runs chunk 0's graph step as a program of its own and
    the others once per round, the graph step as the program of its slot
    tier (the tiny configuration's 32 slots are one tier); on the CPU
    nothing is captured."""
    tier = f"graph_step@{_cfg().bundling.max_num_images}"
    for shard_stats in sharded["stats"]:
        assert set(shard_stats) == {tier if s == "graph_step" else s for s in SHARD_STAGES} | {"graph_step_first"}
        assert all(v["route"] == "eager: cpu" and not v["graph"] and v["replays"] == 0
                   for v in shard_stats.values())


def test_second_run_on_reused_executables(sharded, seqs):
    """A second run takes the executables the first returned (each shard's
    state reset in place) and gives the first run's state after round 1
    bit for bit."""
    run = _new_run(seqs)
    assert {id(e) for e in run.exes} == {id(e) for e in sharded["exes"]}
    for c in range(2):
        run.step(c)
    for shard, (st, want) in enumerate(zip(run.shards, sharded["after_round1"])):
        got = _shard_snapshot(st)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"shard {shard}, {k}")
    with pytest.raises(ValueError, match="out of order"):
        run.step(3)


@pytest.fixture(scope="module")
def mesh_recorded():
    """A pipeline whose global BA is sharded over a 2-shard CPU mesh, with
    GC after every chunk, over chunks 0-2; the operations of its
    global_solve and gc stages recorded by chunk."""
    seq = cached_sequence(13, width=W, height=H)
    mp = pytest.MonkeyPatch()
    mp.setenv("BF_SYNC_INGEST", "1")
    try:
        bf = tpipe.BundleFusion(seq.camera, _cfg(gc_every_chunks=1), anchor_pose=seq.poses[0],
                                mesh=make_mesh(2, "cpu"), device="cpu")
    finally:
        mp.undo()
    log = OpLog()
    stage_of = bf.timing.stage

    @contextlib.contextmanager
    def stage(name, block=False, **kw):
        log.key = (bf.chunk_count, name) if name in ("global_solve", "gc") else None
        with stage_of(name, block=block, **kw):
            yield
        log.key = None

    bf.timing.stage = stage
    for i in range(13):
        with log if i > 4 else contextlib.nullcontext():  # chunk 0 ends at frame 4
            bf.push_frame(seq.depth[i], seq.color[i])
    del bf.timing.stage
    assert bf.chunk_count == 3
    return dict(ops=log.ops, stats=bf.graph_stats)


@pytest.mark.parametrize("stage", ("global_solve", "gc"))
def test_mesh_pipeline_stage_is_chunk_invariant(mesh_recorded, stage):
    """The sharded global solve and GC, each a program of the pipeline, run
    the same operations at chunks 1 and 2."""
    assert_same_ops(mesh_recorded["ops"][(1, stage)], mesh_recorded["ops"][(2, stage)], stage)
    assert mesh_recorded["stats"][stage]["route"] == "eager: cpu"


def test_solve_route_follows_the_mesh_layout():
    """The sharded solve is captured only when every shard lives on the
    pipeline's device; a mesh over several devices keeps it eager, decided
    from the layout."""
    cpu, c0, c1 = torch.device("cpu"), torch.device("cuda", 0), torch.device("cuda", 1)
    assert tstep.solve_route(None, c0) is None
    assert tstep.solve_route(Mesh((cpu, cpu)), cpu) is None
    assert tstep.solve_route(Mesh((c0, c0)), c0) is None
    assert tstep.solve_route(Mesh((c0, c1)), c0) == "eager: the mesh spans 2 devices"
    assert tstep.solve_route(Mesh((c1, c1)), c0) == "eager: the mesh is on cuda:1, the pipeline on cuda:0"
