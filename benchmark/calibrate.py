"""Readings for a cell's correctness limits, on the card, in one process:
the program's numbers over a dozen seeds or more, the control's, and the
program's with a fault planted in its timed path.

    python -m benchmark.calibrate --workload <cell> --seeds 11 12 ... [--control 3] [--fault NAME]

For each seed it renders the cell's scan, runs it once through a fresh
pipeline (closed loop, as fast as the pipeline takes it: the timed path's
entry, programs and sizes; the pace does not change what it computes) and
prints ``judge.numbers`` (the program's reading). For the first
``--control`` seeds it also reads the control: the reference put in the
program's place and computed in bfloat16, the precision below the float32
the configuration states: the camera path computed in bfloat16 as the
published trajectory, and the reference TSDF computed in bfloat16 at the
same voxels, all frames valid, nothing dropped, the surface covered. With
``--fault`` the process plants that fault (``FAULTS``) before any pipeline
is built (a later pipeline would replay the captured programs of an
earlier one) and reads only the faulted program. ``--frames`` judges a
scan's first N frames, as a cell whose window ends inside a scan does. The
benchmark's runs do not run this. Each line of stdout is one JSON reading.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import sys
from contextlib import ExitStack
from unittest import mock

import numpy as np


def every_other_frame(orig):
    @functools.wraps(orig)
    def wrapped(table, rows, depths, colors8, cfg):
        """K1 fuses every other frame: the integration rows of the odd frames
        of each fuse apply nothing, though they are recorded as applied."""
        skip = (rows.params[:, 16] > 0) & (rows.fidx % 2 == 1)
        return orig(table, dataclasses.replace(rows, masks=rows.masks & ~skip[:, None]), depths, colors8, cfg)
    return wrapped


def half_the_surface(orig):
    @functools.wraps(orig)
    def wrapped(table, keys, *args, **kwargs):
        """Allocation takes every other block (by the parity of its x) and
        counts none of the rest as dropped: their updates find no block."""
        import torch

        from bundlefusion_tpu_torch.fusion.blocks import INVALID_KEY

        keys = torch.sort(torch.where(keys % 2 == 1, INVALID_KEY, keys)).values
        return orig(table, keys, *args, **kwargs)
    return wrapped


def no_reintegration(orig):
    @functools.wraps(orig)
    def wrapped(*args, **kwargs):
        """Re-integration skipped: every plan is empty, so each frame stays
        fused at the pose it had when it arrived."""
        import torch

        plan = orig(*args, **kwargs)
        none = torch.zeros_like(plan.deint_mask)
        return dataclasses.replace(plan, deint_mask=none, reint_mask=none)
    return wrapped


# fault -> (module path, attribute, wrapper of the original)
FAULTS = {
    "every_other_frame": ("bundlefusion_tpu_torch.fusion.tsdf", "integrate_blocks", every_other_frame),
    "half_the_surface": ("bundlefusion_tpu_torch.fusion.tsdf", "allocate", half_the_surface),
    "no_reintegration": ("bundlefusion_tpu_torch.bundle.trajectory", "plan_reintegration", no_reintegration),
}


def planted(fault: str | None) -> ExitStack:
    """A context in which ``fault`` (a key of ``FAULTS``, or None) is planted."""
    import importlib

    stack = ExitStack()
    if fault is not None:
        path, name, wrap = FAULTS[fault]
        module = importlib.import_module(path)
        stack.enter_context(mock.patch.object(module, name, wrap(getattr(module, name))))
    return stack


def read(cell, card, seed: int, frames: int | None, control: bool) -> list[dict]:
    """The program's numbers for ``seed`` (and the control's, with
    ``control``), as JSON-ready dicts."""
    import torch

    from . import drive, judge, spec
    from .reference import tsdf as ref

    cfg = spec.port_config(cell.config)
    app = cell.config["app"]
    band, cap = 0.5 * app["truncation"], app["max_integration_weight"]
    scan = drive.make_scan(cell.mix, app["input_width"], app["input_height"], seed, card.device, frames)
    win = drive.closed_loop(card, scan, drive.pipeline_factory(scan, cfg, card.device), math.inf,
                            np.random.default_rng(seed), drive.Slice((0, 0), 1, None), scans=1)
    s = win.scans[0]
    r = ref.fuse(s["voxel_centres"], scan.depth, np.asarray(s["poses"], np.float64), scan.intrinsics, app,
                 torch.float32, card.device)
    nums = judge.numbers([s], scan.poses, [r], scan.intrinsics, scan.width, scan.height, band, cap)
    rows = s["runlog"]
    counts = {k: max(row[k] for row in rows) for k in ("upd_truncated", "alloc_overflow", "active_blocks",
                                                        "blocks_touched", "ring_miss", "corr_cursor")}
    full = [row["chunk"] for row in rows if row["corr_cursor"] >= cell.config["bundling"]["max_residuals_global"]]
    out = [{"seed": seed, "side": "program", "numbers": nums, "max": counts,
            "corr_full_at_chunk": full[0] if full else None, "corr_overflow": s["corr_overflow"],
            "chunks": s["chunks"], "peak_bytes": card.peak_bytes()}]
    if control:
        path = drive.scan_poses(cell.mix, seed, len(scan.poses), torch.bfloat16).to(torch.float64).numpy()
        csdf, cw = ref.fuse(s["voxel_centres"], scan.depth, path, scan.intrinsics, app, torch.bfloat16, card.device)
        rc = ref.fuse(s["voxel_centres"], scan.depth, path, scan.intrinsics, app, torch.float32, card.device)
        c = dict(s, poses=path, valid=np.ones(len(path), bool), dropped=0, voxel_sdf=csdf, voxel_weight=cw,
                 surface_weight=np.ones_like(s["surface_weight"]))
        cnums = judge.numbers([c], scan.poses, [rc], scan.intrinsics, scan.width, scan.height, band, cap)
        out.append({"seed": seed, "side": "control", "numbers": cnums})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3, help="seeds (the first ones) whose control is read")
    p.add_argument("--fault", choices=sorted(FAULTS), default=None, help="plant this fault for the whole run")
    p.add_argument("--frames", type=int, default=None, help="judge the first N frames of each scan")
    args = p.parse_args(argv)

    from . import run, spec

    cell = spec.cell(args.workload)
    card = run.open_card(cell.chips)
    if card is None:
        return 2
    with planted(args.fault):
        for k, seed in enumerate(args.seeds):
            for line in read(cell, card, seed, args.frames, args.fault is None and k < args.control):
                print(json.dumps(dict(line, side=args.fault or line["side"])), flush=True)
            gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
