"""Where an unprofiled window of a cell leaves the card idle, from the
program's per-chunk timeline, on the card this machine holds.

    python -m benchmark.idle --workload <cell> --seed <n> --seconds <s>

Set-up and the window are the cell's, as ``benchmark.run`` makes them with
``--trace 0`` (the scan rendered from the seed, a warm scan, then the mix's
loop for ``--seconds``, each scan judged as the window runs it). The window
is then accounted for by ``bundlefusion_tpu_torch.utils.timeline.idle_account``:
the stamped stages, the time between scans and after the last, the gaps
between a chunk's stages and the gap before each chunk's ``chunk_local`` by
what the host was doing then (ingest, upload, backpressure, wire copy, the
stage's enqueue, other). One JSON line on stdout: each part in ms and in %
of the window, and the largest half-width of the device clock's
calibration over the window's pipelines. The benchmark's runs do not run
this.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    from . import run  # first: it points the build caches into the checkout
    from . import drive, spec

    from bundlefusion_tpu_torch.utils.timeline import idle_account

    cell = spec.cell(args.workload)
    card = run.open_card(cell.chips)
    if card is None:
        return 2
    cfg = spec.port_config(cell.config)
    app, mix = cell.config["app"], cell.mix
    submap = cell.config["bundling"]["submap_size"]
    scan = drive.make_scan(mix, app["input_width"], app["input_height"], args.seed, card.device)
    new_pipeline = drive.pipeline_factory(scan, cfg, card.device)
    rng = np.random.default_rng(args.seed)
    drive.closed_loop(card, scan, new_pipeline, math.inf, rng, drive.Slice((0, 0), submap, None), judge=False,
                      scans=1, frames=mix["warm_frames"])
    gc.collect()
    card.synchronize()
    untraced = drive.Slice(mix["trace_chunks"], submap, None)
    deadline = time.perf_counter() + args.seconds
    if mix["loop"] == "closed":
        win = drive.closed_loop(card, scan, new_pipeline, deadline, rng, untraced)
    else:
        win = drive.open_loop(card, scan, new_pipeline, deadline, mix["rate_hz"], submap, rng, untraced)
    acc = idle_account([s["runlog"] for s in win.scans], win.t0, win.t_end)
    span = win.t_end - win.t0
    err = max((r["timeline"]["clock_err_s"] for s in win.scans for r in s["runlog"] if "timeline" in r), default=None)
    print(json.dumps({"workload": cell.name, "seed": args.seed, "window_ms": span * 1e3, "scans": len(win.scans),
                      "chunks": sum(s["chunks"] for s in win.scans), "device_line": run.device_line(),
                      "clock_err_us_max": None if err is None else err * 1e6,
                      "ms": {k: v * 1e3 for k, v in acc.items()},
                      "pct": {k: 100.0 * v / span for k, v in acc.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
