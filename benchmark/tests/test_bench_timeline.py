"""The readers of the program's per-chunk timeline (``benchmark/timeline.py``
and its metrics) give the known answer on a synthetic window, leave out
each scan's chunk 0, its flush chunk and the profiled chunks, and find
nothing on the harness's stand-in pipeline. The tiny cell's pipeline on the
CPU gives every one of them a reading, and ``benchmark/idle.py``'s account
of its window covers the window."""

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import drive, spec
from bundlefusion_tpu_torch.utils.timeline import idle_account

from . import tiny_cell
from .test_bench_openloop import run_open

READERS = ("sift_ms", "pair_match_ms", "local_ba_ms", "step_idle_pct", "ingest_host_ms", "queue_ms.live",
           "step_ms.live")
PERIOD = 0.030  # a chunk every 30 ms


def timeline(t0, profiled=False, flush=False, scale=1.0):
    """A chunk whose step starts 1 ms after t0: chunk_local 10 ms (sift 3,
    pair_match 2, local_ba 4), idle 1 ms, graph_step 3, global_solve 5,
    publish 1, idle 0.5, plan_fuse 3.5; its last frame pushed 5 ms before
    t0, 2 ms of ingest. ``scale`` stretches every span."""
    ms = 1e-3 * scale

    def at(a, b):
        return [t0 + a * ms, t0 + b * ms]

    device = {"chunk_local": at(1, 11), "sift": at(1.2, 4.2), "pair_match": at(4.3, 6.3), "local_ba": at(6.5, 10.5),
              "graph_step": at(12, 15), "global_solve": at(15, 20), "publish": at(20, 21), "plan_fuse": at(21.5, 25),
              "upload": [t0 - 4e-3, t0 - 3e-3]}
    return {"profiled": profiled, "flush": flush, "clock_err_s": 2e-6, "pushed": t0 - 5e-3, "ingest_s": 2e-3 * scale,
            "device": device, "host": {"wire": [t0, t0 + 1e-4]}}


def scan(n, profiled=(), flush_last=False, late=()):
    """A scan's runlog of ``n`` chunks: chunk 0 and the profiled ones with
    every span ten times as long, a flush chunk the same, and the chunks in
    ``late`` a second late."""
    rows, t = [], 100.0
    for c in range(n):
        t += PERIOD + (1.0 if c in late else 0.0)
        odd = c == 0 or c in profiled or (flush_last and c == n - 1)
        rows.append({"chunk": c, "chunk_valid": True,
                     "timeline": timeline(t, c in profiled, flush_last and c == n - 1, 10.0 if odd else 1.0)})
    return {"runlog": rows}


def ctx_of(scans):
    return SimpleNamespace(window=SimpleNamespace(scans=scans), trace=None, config={})


def read_all(ctx):
    return {m: spec.reader(m).read(ctx) for m in READERS}


def test_readers_on_a_known_window():
    # the chunk after a profiled one starts a second late: step_idle_pct leaves it out
    ctx = ctx_of([scan(9, profiled=(3, 4), late=(5,)), scan(6, flush_last=True)])
    got = read_all(ctx)
    want = {"sift_ms": 3.0, "pair_match_ms": 2.0, "local_ba_ms": 4.0, "ingest_host_ms": 2.0, "queue_ms.live": 6.0,
            "step_ms.live": 24.0, "step_idle_pct": 100.0 * 7.5 / 30.0}
    assert got == pytest.approx(want)
    assert got["sift_ms"] + got["pair_match_ms"] + got["local_ba_ms"] <= 10.0


def test_readers_keep_only_what_they_should():
    only_odd = ctx_of([scan(1), {"runlog": [dict(r) for r in scan(3, profiled=(1, 2))["runlog"]]}])
    assert all(v is None for v in read_all(only_odd).values())
    # a runlog without timelines (the parent program) reads nothing
    bare = scan(5)
    for r in bare["runlog"]:
        del r["timeline"]
    assert all(v is None for v in read_all(ctx_of([bare])).values())


def test_readers_find_nothing_on_the_stand_in_pipeline():
    win, _ = run_open(n=41, rate=200.0, seconds=0.2)
    assert win.scans and all(not s["runlog"] for s in win.scans)
    assert all(v is None for v in read_all(SimpleNamespace(window=win, trace=None, config={})).values())


def test_readers_read_the_tiny_cell_on_the_host(tmp_path):
    root = tiny_cell.make_root(str(tmp_path))
    cell = spec.cell(tiny_cell.CELL, root)
    app, submap = cell.config["app"], cell.config["bundling"]["submap_size"]
    card = tiny_cell.HostCard()
    sc = drive.make_scan(cell.mix, app["input_width"], app["input_height"], 5, card.device)
    win = drive.closed_loop(card, sc, drive.pipeline_factory(sc, spec.port_config(cell.config), card.device),
                            np.inf, np.random.default_rng(5), drive.Slice((0, 0), submap, None), judge=False, scans=2)
    got = read_all(SimpleNamespace(window=win, trace=None, config=cell.config))
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert got["sift_ms"] + got["pair_match_ms"] + got["local_ba_ms"] <= got["step_ms.live"]
    assert 0 <= got["step_idle_pct"] < 100
    # the account benchmark/idle.py prints, over the same window
    acc = idle_account([s["runlog"] for s in win.scans], win.t0, win.t_end)
    assert all(v >= 0 for k, v in acc.items() if k != "unaccounted"), acc
    assert acc["unaccounted"] == pytest.approx(0.0, abs=1e-9)
    assert acc["stages"] > 0 and acc["between_scans"] > 0 and acc["after_last_scan"] > 0
