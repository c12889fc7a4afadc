"""Per-stage timing accumulators (port of ``bundlefusion_tpu.utils.timing``).

On a CUDA device a stage is bracketed by two ``torch.cuda.Event``s recorded
on the current stream: the stage costs no host sync, and its time is the
device's, resolved when :meth:`TimingLog.summary` is read. On the CPU the
host clock is used.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class TimingLog:
    """Accumulates time per named stage: count, total, max."""

    def __init__(self, device: torch.device | str = "cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.maxes: dict[str, float] = defaultdict(float)
        self._pending: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            try:
                yield
            finally:
                end.record()
                self._pending.append((name, start, end))
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1
        self.maxes[name] = max(self.maxes[name], seconds)

    def _resolve(self) -> None:
        """Fold the recorded event pairs into the totals (waits for them)."""
        for name, start, end in self._pending:
            end.synchronize()
            self.record(name, start.elapsed_time(end) * 1e-3)
        self._pending.clear()

    def summary(self) -> dict[str, dict[str, float]]:
        self._resolve()
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
