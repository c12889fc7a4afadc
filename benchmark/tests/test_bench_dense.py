"""The dense global term's readers (``global_dense_ms``, ``dense_live_pct``,
``dense_roofline_pct``) and its count (``counts/dense.py``) give the known
answer on a stub window, leave out each scan's chunk 0, its flush chunk and
the profiled chunks, and find nothing in a runlog without the term's stamps
and counters (the program before it had them, or a sparse configuration)."""

from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.counts import dense, peaks

READERS = ("global_dense_ms", "dense_live_pct", "dense_roofline_pct")
ITERS, SLOTS = 3, 4096


def record(c, live, px, dense_ms=None, profiled=False, flush=False, counters=True):
    """A chunk's runlog record: the dense term ``dense_ms`` in each of its
    GN iterations, ``live`` of 4,096 slots live over ``live // 2 + 1``
    keyframes, ``px`` valid pixels, half of them depth and a third colour
    associations in each iteration."""
    t0, ms = 100.0 + c, 1e-3
    tl = {"profiled": profiled, "flush": flush, "device": {"global_solve": [t0, t0 + 50 * ms]},
          "device_iters": ({"global_dense": [[t0 + (1 + 10 * i) * ms, t0 + (1 + 10 * i + dense_ms) * ms]
                                             for i in range(ITERS)]} if dense_ms else {})}
    rec = {"chunk": c, "chunk_valid": True, "timeline": tl}
    if counters:
        rec.update(dense_pairs_live=live, dense_frames_live=live // 2 + 1 if live else 0, dense_px_valid=px,
                   dense_assoc_depth=ITERS * px // 2, dense_assoc_color=ITERS * px // 3)
    return rec


def ctx_of(scans, use_dense=True):
    bundling = {"global_gn_iters": ITERS, "use_dense_global": use_dense, "max_dense_pairs_global": SLOTS,
                "cache_width": 80, "cache_height": 60}
    return SimpleNamespace(window=SimpleNamespace(scans=[{"runlog": r} for r in scans]), trace=None,
                           config={"bundling": bundling})


def least(live, px):
    """:func:`dense.least_ms` of a :func:`record`'s counters."""
    return dense.least_ms(live, live // 2 + 1, px, ITERS * px // 2, ITERS * px // 3, ITERS, 4800)[0]


def read_all(ctx):
    return {m: spec.reader(m).read(ctx) for m in READERS}


def test_count_of_a_chunk():
    # 100 live pairs over 20 keyframes holding 400,000 valid pixels: the
    # caches are read once, however many pairs share them, so the
    # operations bound it
    assoc_d, assoc_c = ITERS * 300_000, ITERS * 250_000
    ms, by = dense.least_ms(100, 20, 400_000, assoc_d, assoc_c, ITERS, 4800)
    flops = ITERS * 400_000 * dense.FLOPS_PER_PIXEL + assoc_d * dense.FLOPS_PER_DEPTH + assoc_c * dense.FLOPS_PER_COLOR
    assert by == "operations" and ms == pytest.approx(1e3 * flops / peaks.F32_FLOPS)
    # the same over 80 keyframes: the bytes bound it
    ms, by = dense.least_ms(100, 80, 400_000, assoc_d, assoc_c, ITERS, 4800)
    assert by == "bytes" and ms == pytest.approx(1e3 * ITERS * (80 * 4800 * 40 + 100 * 624) / peaks.HBM_BYTES_PER_S)
    assert dense.least_ms(0, 0, 0, 0, 0, ITERS, 4800)[0] == 0.0


def test_readers_on_a_stub_window():
    scans = [
        [record(0, 0, 0), record(1, 10, 40_000, 2.0), record(2, 20, 80_000, 4.0),
         record(3, 99, 1, 50.0, profiled=True), record(4, 30, 120_000, 6.0, flush=True)],
        [record(0, 0, 0), record(1, 40, 160_000, 8.0)],
    ]
    got = read_all(ctx_of(scans))
    # kept chunks: (1, 2) of the first scan, 1 of the second; 3 iterations each
    assert got["global_dense_ms"] == pytest.approx(3 * 4.0)
    assert got["dense_live_pct"] == pytest.approx(100.0 * (10 + 20 + 40) / (3 * SLOTS))
    want = sum(least(live, px) for live, px in ((10, 40_000), (20, 80_000), (40, 160_000)))
    assert got["dense_roofline_pct"] == pytest.approx(100.0 * want / (3 * (2.0 + 4.0 + 8.0)))
    assert 0 < got["dense_roofline_pct"] <= 100


@pytest.mark.parametrize("runlog", ("no_counters_no_stamps", "sparse_configuration"))
def test_readers_find_nothing_without_the_term(runlog):
    if runlog == "no_counters_no_stamps":  # the program before the term had counters and stamps
        ctx = ctx_of([[record(c, 0, 0, counters=False) for c in range(4)]])
    else:  # counters of 0, nothing stamped
        ctx = ctx_of([[record(c, 0, 0) for c in range(4)]], use_dense=False)
    assert read_all(ctx) == dict.fromkeys(READERS)
