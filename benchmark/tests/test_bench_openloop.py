"""The open loop times every frame from its due time: a stall of the
pipeline shows in the latency of the frames due during it, and the frames
after it are counted late, not re-timed."""

import time

import numpy as np
import pytest

from benchmark import drive

from .tiny_cell import HostCard


class FakePipeline:
    """push_frame / sync / flush / outputs of a pipeline whose chunk step
    takes ``step_s`` at sync() after each chunk, and ``stall_s`` once at the
    chunk given."""

    def __init__(self, n, submap, step_s, stall_at=None, stall_s=0.0):
        self.n, self.submap, self.step_s = n, submap, step_s
        self.stall_at, self.stall_s = stall_at, stall_s
        self.pushed = 0
        self.chunks_synced = 0
        self.runlog = type("R", (), {"records": []})()
        self.chunk_count = 0
        self.ingest_waits = {}
        self.graph_stats = {}
        self.state = type("S", (), {"graph": type("G", (), {"corr_overflow": 0})()})()

    def push_frame(self, depth, color):
        self.pushed += 1

    def sync(self):
        done = max(0, (self.pushed - 1) // self.submap)
        while self.chunks_synced < done:
            self.chunks_synced += 1
            time.sleep(self.step_s + (self.stall_s if self.chunks_synced == self.stall_at else 0.0))

    def flush(self):
        self.sync()

    def outputs(self):
        self.chunk_count = self.chunks_synced
        return type("O", (), {"poses": np.zeros((self.pushed, 4, 4)), "valid": np.ones(self.pushed, bool)})()


def run_open(n, rate, seconds, stall_at=None, stall_s=0.0, step_s=0.002):
    scan = drive.Scan(np.zeros((n, 2, 2), np.float32), np.zeros((n, 2, 2, 3), np.float32), np.zeros((n, 4, 4)),
                      (1.0, 1.0, 0.5, 0.5), 2, 2)
    fakes = []

    def new():
        fakes.append(FakePipeline(n, 10, step_s, stall_at, stall_s))
        return fakes[-1]

    deadline = time.perf_counter() + seconds
    sl = drive.Slice((0, 0), 10, None)
    win = drive.open_loop(HostCard(), scan, new, deadline, rate, 10, np.random.default_rng(0), sl, judge=False)
    return win, fakes


def test_frames_are_pushed_on_schedule_and_timed_from_due():
    win, fakes = run_open(n=61, rate=100.0, seconds=0.5)
    assert 45 <= win.pushed <= 50
    assert len(win.latency_s) == win.pushed
    assert max(win.lateness_s) < 0.02
    lat = np.sort(win.latency_s)
    # a chunk's first frame waits for the nine after it (90 ms at 100 Hz) and the step
    assert 0.085 < lat[-1] < 0.2
    assert len(win.dispatch_s) == sum(1 for i in range(1, win.pushed) if i % 10 == 0 and i >= 10)


def test_a_stall_counts_against_the_frames_due_during_it():
    calm, _ = run_open(n=121, rate=100.0, seconds=0.9)
    stalled, _ = run_open(n=121, rate=100.0, seconds=0.9, stall_at=3, stall_s=0.25)
    assert stalled.pushed == pytest.approx(calm.pushed, abs=2)  # the schedule does not move
    assert max(stalled.lateness_s) > 0.2  # the frames due in the stall were pushed late
    assert np.percentile(stalled.latency_s, 95) > np.percentile(calm.latency_s, 95) + 0.1
    assert max(stalled.dispatch_s) > 0.25


def test_a_new_scan_starts_when_one_ends():
    win, fakes = run_open(n=21, rate=200.0, seconds=0.3)
    assert len(fakes) >= 2 and len(win.scans) == len(fakes)
    assert [s["frames"] for s in win.scans[:-1]] == [21] * (len(win.scans) - 1)
    assert win.pushed == sum(s["frames"] for s in win.scans)
