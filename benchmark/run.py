"""Run one cell of the port's benchmark on the card this machine holds.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up renders the cell's scan from the seed on the card, builds the
pipeline and runs the scan's first ``warm_frames`` frames through it (every
program of the chunk step runs eagerly once and is captured; kernels build
into the port's ``_build/`` at a checkout's first run; the host staging
pools fill), then
the window runs the mix's loop for ``--seconds``. With ``--trace 1`` a
slice of the window's first scan (the mix's ``trace_chunks``) runs under
``torch.profiler`` and the per-layer readers (``metrics/``) take their
numbers from it. Once the window has closed, the peak memory is read and
``judge.py`` compares every scan the window ran with the plain reference.

The last line of stdout is the result (JSON); the numbers compared for
``correct`` close stderr, each beside its limit. Without a CUDA card, or
with fewer cards than the cell asks for, it exits with 2 and prints no
result; with JAX or the JAX package loaded when the result is due (after
the window, the readers and the judge), 3.
"""

import os
import time

_T_START = time.perf_counter()
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout (the port's own
# kernels build into bundlefusion_tpu_torch/_build/; importing torch._dynamo
# makes the inductor's cache directory, by default a fixed path under /tmp)
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = os.path.join(_ROOT, ".bench_cache", _sub)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

from . import judge, spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "bundlefusion_tpu")


def process_age() -> float:
    """Seconds since this process started (the kernel's start time, at its
    clock tick), or since this module was first imported where /proc is
    not there."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _T_START


def say(msg: str) -> None:
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def reference_tsdf(scans: list, scan, app: dict, device) -> list:
    """The reference's (sdf, weight) at each judged scan's sampled voxels:
    the scan's frames fused at the trajectory the program published."""
    import torch

    from .reference import tsdf as ref

    out = []
    for s in scans:
        n = s["frames"]
        out.append(ref.fuse(s["voxel_centres"], scan.depth[:n], np.asarray(s["poses"][:n], np.float64),
                            scan.intrinsics, app, torch.float32, device))
    return out


def end_to_end(cell, win, setup_s: float) -> dict:
    wall = win.t_end - win.t0
    values = {
        "setup_s": setup_s,
        "fps": win.pushed / wall if wall > 0 else None,
        "latency_p95_ms": float(np.percentile(win.latency_s, 95) * 1e3) if win.latency_s else None,
    }
    return {m["name"]: {"value": values.get(m["name"]), "unit": m["unit"]} for m in cell.end_to_end
            if values.get(m["name"]) is not None}


def per_layer(cell, ctx, root: str) -> dict:
    out = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"], root).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def open_card(chips: int):
    """The card to measure on (``drive.Card``), or None, with the reason on
    stderr, where CUDA has no card or fewer than ``chips``."""
    import torch

    from . import drive

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; nothing was measured", file=sys.stderr)
        return None
    if torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} cards, this machine has {torch.cuda.device_count()}; "
              "nothing was measured", file=sys.stderr)
        return None
    return drive.Card(0)


def main(argv=None, root: str = _ROOT) -> int:
    p = argparse.ArgumentParser(description="one cell of the port's benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload, root)

    from . import drive
    from .trace import SLICE_SPAN, breakdown, events_of, summarize_trace

    card = open_card(cell.chips)
    if card is None:
        return 2
    device = card.device
    cfg = spec.port_config(cell.config)
    app = cell.config["app"]
    mix = cell.mix
    submap = cell.config["bundling"]["submap_size"]

    say(f"{cell.name}: rendering {mix['scan_frames']} frames at {app['input_width']}x{app['input_height']} "
        f"from seed {args.seed}")
    scan = drive.make_scan(mix, app["input_width"], app["input_height"], args.seed, device)
    new_pipeline = drive.pipeline_factory(scan, cfg, device)
    rng = np.random.default_rng(args.seed)
    say(f"warm scan of {mix['warm_frames']} frames (every program runs and is captured once)")
    warm = drive.closed_loop(card, scan, new_pipeline, math.inf, rng, drive.Slice((0, 0), submap, None), judge=False,
                             scans=1, frames=mix["warm_frames"])
    warm_scan = warm.scans[0]
    del warm
    gc.collect()
    card.synchronize()
    setup_s = process_age()
    say(f"set-up {setup_s:.2f} s; window of {args.seconds} s ({mix['loop']} loop)")

    sl = drive.Slice(mix["trace_chunks"], submap, card if args.trace else None)
    if sl.enabled:
        drive.warm_profiler(card)  # the profiler's first start takes seconds: not inside the window
    deadline = time.perf_counter() + args.seconds
    if mix["loop"] == "closed":
        win = drive.closed_loop(card, scan, new_pipeline, deadline, rng, sl)
    else:
        win = drive.open_loop(card, scan, new_pipeline, deadline, mix["rate_hz"], submap, rng, sl)
    sl.close()
    memory_peak = card.peak_bytes()
    say(f"window: {win.pushed} frames in {win.t_end - win.t0:.3f} s, {len(win.scans)} scans")

    captured = sorted({k for s in win.scans for k in s["captured"]})
    if captured:
        print(f"benchmark: the window captured programs {captured}: it compiled inside the window; no result",
              file=sys.stderr)
        return 4

    device_info = {"platform": "gpu", "kind": card.name(), "count": 1, "memory_peak_bytes": memory_peak}
    result_extra = {}
    if args.trace:
        if not sl.done:
            print("benchmark: the window ended before the traced slice did; no result", file=sys.stderr)
            return 5
        events, trace_bytes = events_of(sl.prof)
        sl.prof = None
        summary = summarize_trace(events, SLICE_SPAN, (sl.k1 - sl.k0) * submap)
        del events
        device_info.update(busy_s=summary["busy_ms"] / 1e3, window_s=summary["window_ms"] / 1e3)
        result_extra["breakdown"] = breakdown(summary)
        ctx = SimpleNamespace(trace=summary, window=win, config=cell.config)
        metrics = per_layer(cell, ctx, root)
        say(f"slice ({trace_bytes / 2**20:.1f} MiB of chrome trace, deleted): " + json.dumps(
            {k: summary[k] for k in ("window_ms", "busy_share", "device_ms", "kernels", "device_ms_by_op",
                                     "our_kernels", "span_counts")}))
    else:
        metrics = end_to_end(cell, win, setup_s)

    # the judge, once the window has closed and its peak memory is read
    ref = reference_tsdf(win.scans, scan, app, device)
    nums = judge.numbers(win.scans, scan.poses, ref, scan.intrinsics, scan.width, scan.height,
                         near_band=0.5 * app["truncation"], weight_cap=app["max_integration_weight"])
    limits = judge.load_limits(root, cell.name)
    correct, compared = judge.decide(nums, limits)
    failed = sum(int(s["frames"] - np.count_nonzero(s["valid"][: s["frames"]])) for s in win.scans)
    store = cell.config["bundling"]["max_residuals_global"]
    diag = {
        "numbers": nums,
        "scans": [{"frames": s["frames"], "chunks": s["chunks"], "dropped": s["dropped"],
                   "store_full_at_chunk": next((r["chunk"] for r in s["runlog"] if r["corr_cursor"] >= store), None),
                   "corr_overflow": s["corr_overflow"], "ingest_waits": s["ingest_waits"],
                   **{f"max_{k}": max((r[k] for r in s["runlog"]), default=None)
                      for k in ("active_blocks", "blocks_touched", "ring_miss", "reint_frames")}}
                  for s in win.scans],
        "warm_scan_chunks": warm_scan["chunks"],
        "lateness_ms_max": max(win.lateness_s) * 1e3 if win.lateness_s else None,
        "dispatch_ms_median": statistics.median(win.dispatch_s) * 1e3 if win.dispatch_s else None,
        "device_line": device_line(),
    }
    print(json.dumps(diag), file=sys.stderr)
    for name, c in compared.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {', '.join(found)}; no result", file=sys.stderr)
        return 3
    result = {"correct": bool(correct), "attempted": int(win.pushed), "failed": int(failed), "metrics": metrics,
              "device": device_info, **result_extra, "compared": compared}
    print(json.dumps(result), flush=True)
    return 0


def device_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    import shutil
    import subprocess

    if not shutil.which("nvidia-smi"):
        return "nvidia-smi not found"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


if __name__ == "__main__":
    sys.exit(main())
