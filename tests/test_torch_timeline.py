"""The pipeline's per-chunk timeline (``utils/timeline.py``): device stamps
and host spans on one clock (on the CPU the stamps' twin reads the host's
``perf_counter``), emitted with each chunk's runlog record at
``finalize()``.

* every chunk record carries a ``timeline``; its marks are in order (last
  frame pushed, upload, dispatch, the stages one after the other), and
  ``chunk_local``'s parts lie inside it, in order;
* ``profiled`` is true exactly for the chunk dispatched while
  ``torch.profiler`` recorded;
* a pipeline restored from a checkpoint gives its earlier chunks no
  timeline; a reused executable's stamp table starts at zero;
* no profiler span opens inside a stage's span (a kernel is charged to the
  innermost span around its launch);
* the ``TimingLog`` is a view of the timeline: it creates no CUDA event,
  and its stage totals are the stamped spans;
* ``timeline.idle_account`` splits a run into its stamped stages and the
  device's idle time by cause: the known answer on synthetic records, and
  the whole of the pipeline's run from its host spans;
* with the dense global term (``use_dense_global``), ``global_solve``
  stamps the term in each GN iteration (``device_iters["global_dense"]``,
  inside the stage, in order), and each chunk's runlog record carries its
  counters: the live pairs (``dense_on`` summed), their keyframes, a's
  valid pixels over the live pairs and the associations, equal with the
  chunk step's programs run eagerly (``disable_graphs``); a checkpoint
  keeps them, and one saved without them restores them as 0; without the
  term the counters read 0 and nothing is stamped;
* each chunk's record carries its global solve's PCG counters: the live
  rows (6 x (the last free keyframe slot + 1)) and the iterations run
  before convergence over the GN iterations; 0 at chunk 0, which solves
  nothing globally; equal eagerly, and kept by a checkpoint as the dense
  term's are.

64x48 at the tiny configuration, 15 frames: chunks 0-2 and a flush chunk,
``gc`` after chunks 1 and 3; the dense term's runs at 128x96 (where the
orbit's keyframes pass the inlier gate), 15 frames.
"""

import contextlib
import dataclasses
import gc
import pickle
import threading

import pytest
import torch

from bundlefusion_tpu_torch.bundle import pipeline as tpipe
from bundlefusion_tpu_torch.bundle import step as tstep
from bundlefusion_tpu_torch.bundle.checkpoint import load_checkpoint, save_checkpoint
from bundlefusion_tpu_torch.config import tiny_test_config
from bundlefusion_tpu_torch.io.synthetic import generate_sequence
from bundlefusion_tpu_torch.utils import graphs, timeline
from bundlefusion_tpu_torch.utils.timing import TimingLog

N = 15
PROFILED = 2  # the chunk dispatched under the profiler
STAGE_SPANS = (*timeline.STAGES, "upload", "streaming")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**app):
    c = tiny_test_config()
    return dataclasses.replace(c, app=dataclasses.replace(c.app, gc_every_chunks=2, **app))


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(N, width=64, height=48, device="cpu")


class _SpanSpy:
    """``torch.profiler.record_function`` that notes, per thread, every span
    opened while a stage's span is open."""

    real = torch.profiler.record_function
    opened: list = []
    nested: list = []
    _open = threading.local()

    def __init__(self, name, args=None):
        self.name, self.inner = name, self.real(name, args)

    def __enter__(self):
        stack = self._open.__dict__.setdefault("stack", [])
        if any(s in STAGE_SPANS for s in stack):
            self.nested.append((tuple(stack), self.name))
        stack.append(self.name)
        self.opened.append(self.name)
        return self.inner.__enter__()

    def __exit__(self, *exc):
        self._open.stack.pop()
        return self.inner.__exit__(*exc)


@pytest.fixture(scope="module")
def run(seq):
    """One pass (async ingest) with chunk PROFILED dispatched under
    ``torch.profiler`` and every profiler span watched."""
    mp = pytest.MonkeyPatch()
    mp.setattr(torch.profiler, "record_function", _SpanSpy)
    try:
        bf = tpipe.BundleFusion(seq.camera, _cfg(), anchor_pose=seq.poses[0], device="cpu")
        assert bf._ingest.async_ingest
        s = bf.S
        for i in range(N):
            if i == PROFILED * s + 1:  # chunk PROFILED's first new frame
                bf.sync()
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
                prof.__enter__()
            bf.push_frame(seq.depth[i], seq.color[i])
            if i == PROFILED * s + s:
                bf.sync()
                prof.__exit__(None, None, None)
        bf.flush()
        out = bf.outputs()
    finally:
        mp.undo()
    return bf, out


def _records(bf):
    return [r for r in bf.runlog.records if "chunk_valid" in r]


def test_every_chunk_has_a_timeline(run):
    bf, _ = run
    recs = _records(bf)
    assert [r["chunk"] for r in recs] == [0, 1, 2, 3]
    for r in recs:
        tl = r["timeline"]
        assert set(tl["device"]) >= {"upload", "chunk_local", "graph_step", "publish", "plan_fuse", *timeline.CHILDREN}
        assert ("global_solve" in tl["device"]) == (r["chunk"] > 0)
        assert ("gc" in tl["device"]) == (r["chunk"] in (1, 3))
        assert tl["ingest_s"] > 0 and tl["clock_err_s"] >= 0
        assert set(tl["host"]) >= {"upload", "wait.upload", "wire", "chunk_local", "plan_fuse"}
    assert [r["timeline"]["flush"] for r in recs] == [False, False, False, True]


def test_marks_are_in_order(run):
    bf, _ = run
    for r in _records(bf):
        tl = r["timeline"]
        dev, host = tl["device"], tl["host"]
        chain = [tl["pushed"], host["upload"][0], *dev["upload"], host["wait.upload"][1], *host["wire"]]
        for s in timeline.STAGES:
            if s in dev:
                assert host[s][0] <= dev[s][0] <= dev[s][1] <= host[s][1], (r["chunk"], s)
                chain += dev[s]
        assert chain == sorted(chain), r["chunk"]


def test_parts_of_chunk_local_lie_within_it(run):
    bf, _ = run
    for r in _records(bf):
        dev = r["timeline"]["device"]
        (b, e), parts = dev["chunk_local"], [dev[s] for s in timeline.CHILDREN]
        flat = [t for p in parts for t in p]
        assert flat == sorted(flat) and b <= flat[0] and flat[-1] <= e
        assert sum(p[1] - p[0] for p in parts) <= e - b


def test_profiled_marks_the_chunk_dispatched_under_the_profiler(run):
    bf, _ = run
    assert [r["timeline"]["profiled"] for r in _records(bf)] == [c == PROFILED for c in range(4)]


def test_no_span_opens_inside_a_stage(run):
    assert {"ingest", "upload", "wait.upload", "wire", "chunk_local", "gc"} <= set(_SpanSpy.opened)
    assert _SpanSpy.nested == []


def test_timing_log_is_a_view_of_the_timeline(run, monkeypatch):
    bf, _ = run
    summary = bf.timing.summary()
    recs = _records(bf)
    for s in ("upload", *timeline.STAGES):
        spans = [r["timeline"]["device"][s] for r in recs if s in r["timeline"]["device"]]
        assert summary[s]["count"] == len(spans) > 0, s
        assert summary[s]["total_s"] == pytest.approx(sum(e - b for b, e in spans)), s
    assert not set(timeline.CHILDREN) & set(summary)

    events = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: events.append(a) or pytest.fail("a CUDA event"))
    log = TimingLog(torch.device("cuda"))
    for name, record in (("chunk_local", False), ("streaming", True)):
        with log.stage(name, record=record):
            pass
    assert events == [] and set(log.summary()) == {"streaming"}


def test_restored_pipeline_times_only_its_own_chunks(seq, tmp_path):
    a = tpipe.BundleFusion(seq.camera, _cfg(), anchor_pose=seq.poses[0], device="cpu")
    for i in range(7):  # chunk 0 and two frames of chunk 1
        a.push_frame(seq.depth[i], seq.color[i])
    path = str(tmp_path / "ck.pkl")
    save_checkpoint(a, path)
    b = load_checkpoint(path, device="cpu")
    for i in range(7, 9):
        b.push_frame(seq.depth[i], seq.color[i])
    b.flush()
    b.outputs()
    assert [("timeline" in r) for r in _records(b)] == [False, True]
    assert b.timing.summary()["chunk_local"]["count"] == 1


def test_reused_executable_starts_with_a_zeroed_table(seq):
    cfg = _cfg(raycast_max_steps=95)  # an executable of its own
    a = tpipe.BundleFusion(seq.camera, cfg, anchor_pose=seq.poses[0], device="cpu")
    for i in range(5):
        a.push_frame(seq.depth[i], seq.color[i])
    a.outputs()
    exe = a._exe
    assert torch.count_nonzero(a.state.stamps) > 0
    del a
    gc.collect()
    b = tpipe.BundleFusion(seq.camera, cfg, anchor_pose=seq.poses[0], device="cpu")
    assert b._exe is exe
    assert torch.count_nonzero(b.state.stamps) == 0


def _known_chunk(t, ms=1e-3):
    """Stages chunk_local [t+1, t+11] and graph_step [t+12, t+15] ms. On the
    host: the caller waited on its staging buffer over [t-5, t-4.8], the
    upload was enqueued at t-4.5 and copied by t-3 (the dispatch worker
    waiting on it until then), the wire copy over [t-1, t-0.5],
    chunk_local's enqueue over [t-0.5, t+0.2], graph_step's until t+11.5."""
    return {"device": {"chunk_local": [t + 1 * ms, t + 11 * ms], "graph_step": [t + 12 * ms, t + 15 * ms],
                       "upload": [t - 4 * ms, t - 3 * ms]},
            "host": {"wait.staging": [t - 5 * ms, t - 4.8 * ms], "upload": [t - 4.5 * ms, t - 3.5 * ms],
                     "wait.upload": [t - 20 * ms, t - 3 * ms], "wire": [t - 1 * ms, t - 0.5 * ms],
                     "chunk_local": [t - 0.5 * ms, t + 0.2 * ms], "graph_step": [t + 0.2 * ms, t + 11.5 * ms]}}


def test_idle_account_on_a_known_run():
    # two pipelines of three chunks 20 ms apart, the second 0.1 s after the first
    scans = [[{"chunk": c, "timeline": _known_chunk(t0 + 0.02 * c)} for c in range(3)] for t0 in (100.0, 100.1)]
    scans[1].insert(0, {"chunk": 0})  # a record without a timeline (a restored chunk) is skipped
    acc = timeline.idle_account(scans, 99.99, 100.2)
    # each later chunk's 6 ms gap: 0.2 staging, 0.3 ingest, 1.5 upload, 0.5 wire, 0.7 launch, 2.8 other; each
    # chunk's 1 ms between its stages: 0.5 launch (graph_step not yet enqueued), 0.5 between stages
    want = {"stages": 6 * 13e-3, "between_stages": 6 * 0.5e-3, "between_scans": 11e-3 + 46e-3,
            "after_last_scan": 45e-3, "staging": 4 * 0.2e-3, "runahead": 0.0, "ingest": 4 * 0.3e-3,
            "upload": 4 * 1.5e-3, "backpressure": 0.0, "wire": 4 * 0.5e-3, "launch": 4 * 0.7e-3 + 6 * 0.5e-3,
            "other": 4 * 2.8e-3, "unaccounted": 0.0}
    assert acc == pytest.approx(want, abs=1e-9)


def test_idle_account_covers_the_pipelines_run(run):
    bf, _ = run
    recs = _records(bf)
    t0 = recs[0]["timeline"]["pushed"]
    t_end = max(e for r in recs for _, e in r["timeline"]["device"].values()) + 1e-3
    acc = timeline.idle_account([recs], t0, t_end)
    assert all(v >= 0 for k, v in acc.items() if k != "unaccounted"), acc
    assert acc["unaccounted"] == pytest.approx(0.0, abs=1e-9)
    assert acc["stages"] > 0 and acc["upload"] > 0 and acc["launch"] > 0


DENSE_PAIRS = 16  # the dense-pair list's slots in the dense runs


def _dense_cfg():
    c = tiny_test_config()
    return dataclasses.replace(
        c, app=dataclasses.replace(c.app, input_width=128, input_height=96, integration_width=128,
                                   integration_height=96),
        bundling=dataclasses.replace(c.bundling, use_dense_global=True, max_dense_pairs_global=DENSE_PAIRS))


@pytest.fixture(scope="module")
def dense_runs():
    """The same 15 frames with the dense global term, the chunk step's
    programs as the pipeline runs them and under ``disable_graphs``."""
    seq = generate_sequence(N, width=128, height=96, device="cpu")
    out = {}
    for mode in ("graphed", "eager"):
        with graphs.disable_graphs() if mode == "eager" else contextlib.nullcontext():
            bf = tpipe.BundleFusion(seq.camera, _dense_cfg(), anchor_pose=seq.poses[0], device="cpu")
            for i in range(N):
                bf.push_frame(seq.depth[i], seq.color[i])
            bf.flush()
            bf.outputs()
        out[mode] = bf
    return out


def test_global_dense_is_stamped_inside_global_solve(dense_runs):
    bf = dense_runs["graphed"]
    iters = bf.config.bundling.global_gn_iters
    recs = _records(bf)
    assert recs[0]["timeline"]["device_iters"] == {}
    for r in recs[1:]:
        tl = r["timeline"]
        (b, e), spans = tl["device"]["global_solve"], tl["device_iters"]["global_dense"]
        flat = [t for s in spans for t in s]
        assert len(spans) == iters and flat == sorted(flat) and b <= flat[0] and flat[-1] <= e, r["chunk"]


def test_dense_counters(dense_runs):
    bf = dense_runs["graphed"]
    g = bf.state.graph
    assert bool(g.valid[: bf.num_keyframes].all())  # no keyframe dropped: the final graph's flags held throughout
    valid_px = (g.cache.depth > 0).sum(dim=(1, 2))
    recs = _records(bf)
    iters = bf.config.bundling.global_gn_iters
    assert [r[k] for k in tstep.DENSE_FIELDS for r in recs[:1]] == [0] * len(tstep.DENSE_FIELDS)
    for r in recs[1:]:
        c = r["chunk"]
        on = g.dense_pair_on & g.valid[g.dense_pairs_a.long()] & g.valid[g.dense_pairs_b.long()] & (
            g.dense_pairs_b <= c)  # the pairs of keyframes 0..c: those of the chunk's solve
        frames = set(g.dense_pairs_a[on].tolist()) | set(g.dense_pairs_b[on].tolist())
        assert r["dense_pairs_live"] == int(on.sum()) and r["dense_frames_live"] == len(frames), c
        assert r["dense_px_valid"] == int(valid_px[g.dense_pairs_a.long()][on].sum()), c
        # each iteration associates at most every valid pixel of a, and some
        for k in ("dense_assoc_depth", "dense_assoc_color"):
            assert 0 < r[k] <= iters * r["dense_px_valid"], (c, k)
    dense_on = g.dense_pair_on & g.valid[g.dense_pairs_a.long()] & g.valid[g.dense_pairs_b.long()]
    assert recs[-1]["dense_pairs_live"] == int(dense_on.sum()) > 0


def test_graphed_and_eager_dense_counters_are_equal(dense_runs):
    a, b = (_records(dense_runs[m]) for m in ("graphed", "eager"))
    assert [{k: r[k] for k in tstep.DENSE_FIELDS} for r in a] == [{k: r[k] for k in tstep.DENSE_FIELDS} for r in b]
    assert [r["dense_pairs_live"] for r in a][-1] > 0


@pytest.mark.parametrize("saved", ("with_counters", "before_counters"))
def test_checkpoint_keeps_the_dense_counters(dense_runs, tmp_path, saved):
    bf = dense_runs["graphed"]
    path = str(tmp_path / "dense.ckpt")
    save_checkpoint(bf, path)
    want = bf.state.dense_counts
    if saved == "before_counters":  # a checkpoint written before the counters existed
        with open(path, "rb") as f:
            data = pickle.load(f)
        del data["device"]["dense_counts"]
        with open(path, "wb") as f:
            pickle.dump(data, f)
        want = torch.zeros_like(want)
    assert bool(bf.state.dense_counts.any())
    assert torch.equal(load_checkpoint(path, device="cpu").state.dense_counts, want)


@pytest.mark.parametrize("which", ("sparse", "dense"))
def test_pcg_counters(run, dense_runs, which):
    """At 64x48 no keyframe is kept, so nothing is free and no row is
    solved; at 128x96 (the dense runs) every keyframe is."""
    bf = run[0] if which == "sparse" else dense_runs["graphed"]
    bc = bf.config.bundling
    g = bf.state.graph
    recs = _records(bf)
    assert [recs[0][k] for k in tstep.PCG_FIELDS] == [0, 0]
    for r in recs[1:]:
        c = r["chunk"]
        if which == "sparse":
            assert not bool(g.valid.any()) and (r["pcg_rows"], r["pcg_iters_run"]) == (0, 0), c
            continue
        assert bool(g.valid[: c + 1].all()) and r["pcg_rows"] == 6 * (c + 1), c
        assert 1 <= r["pcg_iters_run"] <= bc.global_gn_iters * bc.global_pcg_iters, c


def test_graphed_and_eager_pcg_counters_are_equal(dense_runs):
    a, b = (_records(dense_runs[m]) for m in ("graphed", "eager"))
    assert [[r[k] for k in tstep.PCG_FIELDS] for r in a] == [[r[k] for k in tstep.PCG_FIELDS] for r in b]
    assert a[-1]["pcg_rows"] > 0


@pytest.mark.parametrize("saved", ("with_counters", "before_counters"))
def test_checkpoint_keeps_the_pcg_counters(dense_runs, tmp_path, saved):
    bf = dense_runs["graphed"]
    path = str(tmp_path / "pcg.ckpt")
    save_checkpoint(bf, path)
    want = bf.state.pcg_counts
    if saved == "before_counters":  # a checkpoint written before the counters existed
        with open(path, "rb") as f:
            data = pickle.load(f)
        del data["device"]["pcg_counts"]
        with open(path, "wb") as f:
            pickle.dump(data, f)
        want = torch.zeros_like(want)
    assert bool(bf.state.pcg_counts.any())
    assert torch.equal(load_checkpoint(path, device="cpu").state.pcg_counts, want)


def test_sparse_pipeline_has_no_dense_term(run):
    bf, _ = run
    for r in _records(bf):
        assert r["timeline"]["device_iters"] == {} and not any(r[k] for k in tstep.DENSE_FIELDS)
    assert bf.state.stamps.shape[1] == 2 * len(timeline.SPANS)


@pytest.mark.cuda
def test_dense_counters_graphed_and_eager_on_the_card():
    """On a card the dense runs' counters and stamps from the captured
    graphs (global_solve captured at chunk 1, replayed after) equal those
    of the eager step (``disable_graphs``); this file imports no JAX, so
    ``python -m pytest --noconftest -p no:cacheprovider -m cuda
    tests/test_torch_timeline.py`` runs it there."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    seq = generate_sequence(N, width=128, height=96, device=dev)
    gc.collect()
    tstep.EXECUTABLES.clear()
    recs = {}
    for mode in ("graphed", "eager"):
        with graphs.disable_graphs() if mode == "eager" else contextlib.nullcontext():
            bf = tpipe.BundleFusion(seq.camera, _dense_cfg(), anchor_pose=seq.poses[0], device=dev)
            for i in range(N):
                bf.push_frame(seq.depth[i], seq.color[i])
            bf.flush()
            bf.outputs()
        stats = bf.graph_stats["global_solve"]
        assert (stats["captured"], stats["replays"] > 0) == ((True, True) if mode == "graphed" else (False, False))
        recs[mode] = _records(bf)
        del bf
        gc.collect()
    a, b = recs["graphed"], recs["eager"]
    assert [[r[k] for k in tstep.DENSE_FIELDS] for r in a] == [[r[k] for k in tstep.DENSE_FIELDS] for r in b]
    assert a[-1]["dense_pairs_live"] > 0
    for r in a[1:]:
        assert len(r["timeline"]["device_iters"]["global_dense"]) == tiny_test_config().bundling.global_gn_iters
