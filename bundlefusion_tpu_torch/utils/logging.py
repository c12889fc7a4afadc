"""Structured JSONL run logging: per-chunk records of key/match/solve
statistics (mirror of ``bundlefusion_tpu.utils.logging``)."""

from __future__ import annotations

import json
from typing import IO, Any


class RunLog:
    def __init__(self, path: str | None = None):
        self._f: IO[str] | None = open(path, "a") if path else None
        self.records: list[dict[str, Any]] = []

    def log(self, **record: Any) -> None:
        rec = {k: _tofloat(v) for k, v in record.items()}
        self.records.append(rec)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


def _tofloat(v: Any) -> Any:
    """0-d numpy/torch values -> Python scalars (JSON-serializable)."""
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    return v
