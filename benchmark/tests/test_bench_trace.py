"""The copied trace reduction gives ``chip_smoke.py``'s numbers on a canned
trace, and the per-layer readers read them as documented."""

import math
from types import SimpleNamespace

import pytest

import chip_smoke
from benchmark import spec, trace
from benchmark.counts import k3

SPAN = trace.SLICE_SPAN


def _x(cat, name, ts, dur, tid, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def canned_events():
    """Two chunks of a slice: the caller's span, the dispatch worker's stage
    spans with graph launches, an eager op's launch, kernels of the port and
    of PyTorch, a copy, and a kernel whose launch came before the slice."""
    ev = [_x("user_annotation", SPAN, 0, 2000, 1)]
    for c, t0 in enumerate((100, 1100)):
        for name, a, b, corr in (("chunk_local", 0, 300, 10), ("graph_step", 300, 350, 11),
                                 ("global_solve", 350, 450, 12), ("publish", 450, 470, 13),
                                 ("plan_fuse", 470, 560, 14)):
            corr += 100 * c
            ev.append(_x("user_annotation", name, t0 + a, b - a, 2))
            ev.append(_x("cuda_runtime", "cudaGraphLaunch", t0 + a + 5, 10, 2, corr))
        ev += [
            _x("kernel", "void at::native::elementwise_kernel<128, 2>(int)", t0 + 20, 200, 7, 10 + 100 * c),
            _x("kernel", "assemble_flags_kernel(int, float const*)", t0 + 230, 4, 7, 10 + 100 * c),
            _x("kernel", "assemble_rows_kernel(int, float const*)", t0 + 240, 16, 7, 10 + 100 * c),
            _x("kernel", "void (anonymous namespace)::reduce_kernel<512, 1>(float*)", t0 + 310, 30, 7, 11 + 100 * c),
            _x("kernel", "assemble_flags_kernel(int, float const*)", t0 + 360, 3, 7, 12 + 100 * c),
            _x("kernel", "assemble_rows_kernel(int, float const*)", t0 + 365, 21, 7, 12 + 100 * c),
            _x("kernel", "gemv2N_kernel<int, int, float>(float*)", t0 + 390, 40, 7, 12 + 100 * c),
            _x("kernel", "tsdf_fuse_kernel(float*, int)", t0 + 480, 60, 7, 14 + 100 * c),
        ]
    ev += [
        _x("cpu_op", "aten::copy_", 1700, 40, 2),
        _x("cuda_runtime", "cudaLaunchKernel", 1710, 5, 2, 900),
        _x("kernel", "void at::native::vectorized_elementwise_kernel<4>(int)", 1750, 12, 7, 900),
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 1800, 30, 7, 901),
        _x("kernel", "void at::native::elementwise_kernel<128, 2>(int)", 10, 50, 7, 5),  # launched before
    ]
    return ev


def test_summary_equals_chip_smoke():
    events = canned_events()
    ours = trace.summarize_trace(events, SPAN, 20)
    theirs = chip_smoke.summarize_trace(events, SPAN, 20)
    for key, value in theirs.items():
        assert ours[key] == value, key
    assert ours["span_counts"]["chunk_local"] == 2
    assert ours["device_ms_by_op_all"]["(launch not traced)"] == pytest.approx(0.05)


def ctx_of(summary, bundling, dispatch=()):
    return SimpleNamespace(trace=summary, config={"bundling": bundling}, window=SimpleNamespace(dispatch_s=list(dispatch)))


def test_readers_on_the_canned_trace():
    summary = trace.summarize_trace(canned_events(), SPAN, 20)
    # the canned K3 times are those of a 128-slot graph
    bundling = dict(spec.cell("bf640-1cm.room-sweep").config["bundling"], max_num_images=128)
    ctx = ctx_of(summary, bundling, dispatch=[0.004, 0.002, 0.010])
    read = {m: spec.reader(m).read(ctx) for m in ("chunk_local_ms", "graph_step_ms", "global_solve_ms", "plan_fuse_ms",
                                                  "idle_pct", "k3_roofline_pct", "chunk_device_ms.live",
                                                  "dispatch_ms.live")}
    assert read["chunk_local_ms"] == pytest.approx((200 + 4 + 16) / 1e3)
    assert read["graph_step_ms"] == pytest.approx(0.030)
    assert read["global_solve_ms"] == pytest.approx((3 + 21 + 40) / 1e3)
    assert read["plan_fuse_ms"] == pytest.approx(0.060)
    assert read["chunk_device_ms.live"] == pytest.approx((220 + 30 + 64 + 60) / 1e3 + 0.012 / 2)
    assert read["dispatch_ms.live"] == pytest.approx(4.0)
    busy = summary["busy_ms"] / 2.0
    assert read["idle_pct"] == pytest.approx(100 * (1 - busy))
    (n_l, s_l, b_l), (n_g, s_g, b_g) = k3.shapes(bundling).values()
    least = 2 * k3.least_ms(n_l, s_l, b_l)[0] + 2 * k3.least_ms(n_g, s_g, b_g)[0]
    assert read["k3_roofline_pct"] == pytest.approx(100 * least / (2 * (4 + 16 + 3 + 21) / 1e3))
    assert 0 < read["k3_roofline_pct"] < 100


def test_readers_find_nothing_without_a_trace():
    bundling = spec.cell("bf640-1cm.room-sweep").config["bundling"]
    ctx = ctx_of(None, bundling)
    for m in ("chunk_local_ms", "idle_pct", "k3_roofline_pct", "chunk_device_ms.live", "dispatch_ms.live"):
        assert spec.reader(m).read(ctx) is None
    assert not math.isnan(trace.breakdown(trace.summarize_trace(canned_events(), SPAN, 20))["device_ops"][0][1])
