"""The traced slice of a run: ``torch.profiler`` over a bounded span of
chunks, with host activity on every thread, and the reduction of its events
to the numbers the per-layer readers take.

``innermost_spans``, ``short_kernel``, ``launch_calls``, ``busy_intervals``
and ``summarize_trace`` are copies of ``chip_smoke.py``'s (the version of
the commit that added this benchmark), frozen here so that the yardstick
does not move with the program. ``summarize_trace`` gains three keys of its
own (``span_counts``, ``device_ms_by_op_all``, ``our_kernels_raw``: unrounded
and complete); the rest is as it was. The port's stage spans come from
``utils/timing.py::TimingLog.stage``, a ``record_function`` of the stage's
name around each stage on whichever thread runs it, so a kernel launched
by a stage's CUDA graph is charged to that stage.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

SLICE_SPAN = "benchmark.slice"  # the traced slice, on the caller's thread
STAGES = ("chunk_local", "graph_step", "global_solve", "publish", "plan_fuse")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the port's kernels by the name of their __global__ function
OUR_KERNELS = {"tsdf_fuse_kernel": "tsdf_integrate", "preprocess_kernel": "preprocess",
               "assemble_flags_kernel": "assemble pass 1", "assemble_rows_kernel": "assemble pass 2",
               "sift_sample_kernel": "sift_sample", "dense_verify_kernel": "dense_verify"}
# the host's calls that put work on the device: a kernel launch, a whole
# CUDA graph's launch, an asynchronous copy or fill
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def innermost_spans(spans: list, points: list) -> dict:
    """For host spans (start, end, name) of one thread, which nest, and
    points (t, key): {key: name of the innermost span holding t}."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = {}, [], 0
    for t, key in sorted(points):
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[key] = stack[-1][2]
    return out


def short_kernel(name: str) -> str:
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    for sep in ("<", "("):
        name = name.split(sep)[0]
    return name[:70]


def launch_calls(events: list, w0: float, w1: float) -> dict:
    """The host's launch calls (``LAUNCH_CALLS``) in a trace window, by name."""
    out: dict = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and e["name"] in LAUNCH_CALLS and w0 <= float(e["ts"]) < w1:
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def busy_intervals(dev: list, w0: float, w1: float) -> list:
    """The union of the device events' intervals (us), clipped to [w0, w1]."""
    merged = []
    for s, e in sorted((max(float(x["ts"]), w0), min(float(x["ts"]) + float(x["dur"]), w1)) for x in dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize_trace(events: list, span: str, frames: int) -> dict:
    """The device profile of the host span ``span`` from a torch.profiler
    trace with host ops. Busy share: the union of kernel, memcpy and memset
    intervals over the window; launches per frame; the device operations
    (kernels grouped by the host op that launched them, found through the
    launch's correlation id) by total time; the longest idle gaps, each with
    the host spans open at its middle on every thread."""
    win = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == span]
    if len(win) != 1:
        raise AssertionError(f"the trace holds {len(win)} '{span}' spans")
    w0, w1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    caller = win[0]["tid"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and w0 <= float(e["ts"]) < w1]
    if not dev:
        raise AssertionError(f"the profile holds no device event in the pass ({(w1 - w0) / 1e3:.1f} ms)")
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")]
    by_tid: dict = {}
    for e in host:
        by_tid.setdefault(e["tid"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    # the host op that launched each kernel: the innermost cpu_op around its runtime call
    launch_at: dict = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launch_at.setdefault(e["tid"], []).append((float(e["ts"]), e["args"]["correlation"]))
    op_of: dict = {}
    for tid, points in launch_at.items():
        ops = [sp for sp in by_tid.get(tid, []) if not sp[2].startswith(("cuda", "cu"))]
        op_of.update(innermost_spans(ops, points))
    groups: dict = {}
    by_op: dict = {}  # device ms by the host op that launched it (a graph's kernels: its stage's span)
    ours: dict = {}  # the port's own kernels by the op that launched them: [ms, count]
    for e in dev:
        if e["cat"] == "kernel":
            op = op_of.get(e.get("args", {}).get("correlation"), "(launch not traced)")
            name = short_kernel(e["name"])
            key = f"{op} | {name}"
            by_op[op] = by_op.get(op, 0.0) + float(e["dur"]) / 1e3
            if name.split("::")[-1] in OUR_KERNELS:
                o = ours.setdefault(f"{OUR_KERNELS[name.split('::')[-1]]} in {op}", [0.0, 0])
                o[0] += float(e["dur"]) / 1e3
                o[1] += 1
        else:
            key = e["name"]
        g = groups.setdefault(key, [0.0, 0])
        g[0] += float(e["dur"])
        g[1] += 1
    total = sum(g[0] for g in groups.values())
    top = sorted(groups.items(), key=lambda kv: -kv[1][0])[:10]
    by_stage: dict = {}  # each stage's five longest device operations
    for key, (us, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        op, _, name = key.partition(" | ")
        if name and op in STAGES and len(by_stage.setdefault(op, [])) < 5:
            by_stage[op].append(dict(op=name, ms=round(us / 1e3, 3), count=count))
    # busy intervals and idle gaps inside the window
    merged = busy_intervals(dev, w0, w1)
    busy = sum(e - s for s, e in merged)
    edges = [w0] + [v for se in merged for v in se] + [w1]
    all_gaps = [(edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)]
    gaps = sorted(all_gaps, reverse=True)[:5]
    # idle time by the pipeline stages open on the worker threads (the
    # stages of one thread do not overlap)
    stages = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["tid"] != caller:
            stages.setdefault(e["tid"], []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    for spans in stages.values():
        spans.sort()
    starts = {tid: [sp[0] for sp in spans] for tid, spans in stages.items()}
    idle_by_stage: dict = {}
    for length, start in all_gaps:
        mid, names = start + length / 2, []
        for tid, spans in stages.items():
            i = bisect.bisect_right(starts[tid], mid) - 1
            if i >= 0 and spans[i][1] >= mid:
                names.append(spans[i][2])
        key = "+".join(sorted(names)) or "(no stage open)"
        idle_by_stage[key] = idle_by_stage.get(key, 0.0) + length / 1e3
    gap_rows = []
    for spans in by_tid.values():
        spans.sort()
    for length, start in gaps:
        mid = start + length / 2
        open_spans = {}
        for tid, spans in by_tid.items():
            chain = [n for s, e, n in spans if s <= mid <= e]
            if chain:
                open_spans["caller" if tid == caller else f"thread {tid}"] = " > ".join(chain[-3:])
        gap_rows.append(dict(ms=length / 1e3, at_ms=(start - w0) / 1e3, host=open_spans))
    kernels = sum(1 for e in dev if e["cat"] == "kernel")
    calls = launch_calls(events, w0, w1)
    span_counts: dict = {}  # user spans (the port's stages among them) that lie in the window, by name
    for e in events:
        if e.get("cat") == "user_annotation" and w0 <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= w1:
            span_counts[e["name"]] = span_counts.get(e["name"], 0) + 1
    return dict(
        window_ms=(w1 - w0) / 1e3, busy_share=busy / (w1 - w0), device_ms=total / 1e3, kernels=kernels,
        launches_per_frame=kernels / frames, memcpy_memset=len(dev) - kernels,
        host_launch_calls=calls, host_launch_calls_per_frame=sum(calls.values()) / frames,
        top=[dict(op=k, ms=v[0] / 1e3, count=v[1], share=v[0] / total) for k, v in top], gaps=gap_rows,
        threads=len(by_tid), idle_by_stage=dict(sorted(idle_by_stage.items(), key=lambda kv: -kv[1])),
        device_ms_by_op=dict(sorted(((k, round(v, 3)) for k, v in by_op.items()), key=lambda kv: -kv[1])[:10]),
        our_kernels={k: dict(ms=round(v[0], 3), count=v[1]) for k, v in ours.items()}, top_by_stage=by_stage,
        span_counts=span_counts, device_ms_by_op_all=by_op,
        our_kernels_raw={k: dict(ms=v[0], count=v[1]) for k, v in ours.items()},
        busy_ms=busy / 1e3,
    )


def profiler(torch):
    """A ``torch.profiler.profile`` of CPU and CUDA activity that records
    host ops on every thread (the chunk step runs on the pipeline's dispatch
    worker)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    every_thread = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return torch.profiler.profile(activities=acts, experimental_config=every_thread)


def events_of(prof) -> tuple[list, int]:
    """The complete events of a finished profile, and the bytes of the
    chrome trace they pass through: a file in ``TMPDIR``, deleted once read
    (the profiler of the card machine's PyTorch gives its events' kinds only
    in that trace)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
        return events, os.path.getsize(path)
    finally:
        os.remove(path)


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the device operations that took most
    time and the idle time by the host activity open during it, in seconds."""
    return {
        "device_ops": [[row["op"], row["ms"] / 1e3] for row in summary["top"][:10]],
        "idle_gaps": [[name, ms / 1e3] for name, ms in list(summary["idle_by_stage"].items())[:10]],
    }
