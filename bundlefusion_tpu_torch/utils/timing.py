"""Per-stage timing accumulators (port of ``bundlefusion_tpu.utils.timing``).

Each stage is a ``torch.profiler.record_function`` span of its name and
records the host clock around it. ``stage(name, record=False)`` records
nothing: its caller records the stage's device time itself (the pipeline,
at ``finalize()``, from the stamps of its per-chunk timeline,
``utils/timeline.py``), so that it costs no host sync and no event.
``stage(name, block=True)`` waits for the device at the stage's end and
records the host clock from its start to then, as the JAX package's
``block=`` does: with every stage ending so, the device is idle when a
stage starts, and a stage's time is really that stage's.

Stages may be timed from several threads (the pipeline's ingest workers).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch


class TimingLog:
    """Accumulates time per named stage: count, total, max."""

    def __init__(self, device: torch.device | str = "cuda"):
        self.cuda = torch.device(device).type == "cuda"
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.maxes: dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str, block: bool = False, record: bool = True):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if block and self.cuda:
                    done = torch.cuda.Event()
                    done.record()
                    done.synchronize()
                if record:
                    self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1
            self.maxes[name] = max(self.maxes[name], seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {
                k: {
                    "total_s": self.totals[k],
                    "count": self.counts[k],
                    "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1),
                    "max_ms": 1e3 * self.maxes[k],
                }
                for k in sorted(self.totals)
            }

    def report(self) -> str:
        lines = [f"{'stage':<24}{'count':>7}{'mean ms':>10}{'max ms':>10}{'total s':>10}"]
        for k, v in self.summary().items():
            lines.append(
                f"{k:<24}{v['count']:>7}{v['mean_ms']:>10.2f}{v['max_ms']:>10.2f}{v['total_s']:>10.2f}"
            )
        return "\n".join(lines)
