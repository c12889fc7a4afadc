"""A throwaway cell added as new files only: a 128x96 scan of the office
with the port's tiny configuration, in a copy of the benchmark's data under
a temporary root. The harness's code is this checkout's; only data is new.
``HostCard`` stands in for the card, so that the harness runs on the CPU
(the port's plain PyTorch twins)."""

import json
import os
import shutil
import time

import torch

from benchmark import spec


class HostEvent:
    """A timing event on the host clock."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, later) -> float:
        return (later.t - self.t) * 1e3


class HostCard:
    """The harness's card, stood in for by the CPU."""

    device = torch.device("cpu")

    def synchronize(self):
        pass

    def event(self):
        return HostEvent()

    def name(self) -> str:
        return "host stand-in"

    def peak_bytes(self) -> int:
        return 0


def no_card(chips):
    return HostCard()

CELL = "tiny128.sweep"
LIMITS = {  # sound CPU runs of this cell (seeds 1-3): invalid 0, rpe_rms 2.3-2.7 mm, tsdf_med 0.2-0.6 mm,
    # weight_gap 0, surface_missed 0.17-0.24%; every other frame fused (seed 2): weight_gap 52%
    "invalid_frames": {"limit": 0},
    "rpe_rms_mm": {"limit": 4.0},
    "tsdf_med_mm": {"limit": 2.0},
    "weight_gap_pct": {"limit": 15.0},
    "surface_missed_pct": {"limit": 5.0},
}
PROBE = '''"""scans_in_window: the scans the window ran (a probe of a new reader)."""


def read(ctx):
    return float(len(ctx.window.scans))
'''


def make_root(root: str) -> str:
    """Copy BENCHMARK.json and the benchmark's data files under ``root`` and
    add the throwaway cell's configuration, mix, metric and limits."""
    from bundlefusion_tpu_torch.config import tiny_test_config

    os.makedirs(os.path.join(root, "benchmark"), exist_ok=True)
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(os.path.join(spec.ROOT, "benchmark", sub), os.path.join(root, "benchmark", sub),
                        dirs_exist_ok=True)
    cfg = json.loads(tiny_test_config().to_json())
    cfg["app"].update(input_width=128, input_height=96, integration_width=128, integration_height=96)
    cfg.update(source="the port's tiny_test_config at 128x96", reduced=[], assumed={}, chips=1)
    with open(os.path.join(root, "benchmark", "configs", "tiny128.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(spec.ROOT, "benchmark", "traffic", "room-sweep.json")) as f:
        mix = json.load(f)
    mix.update(scan_frames=21, warm_frames=21, noise=False, trace_chunks=[1, 3])
    with open(os.path.join(root, "benchmark", "traffic", "tiny-sweep.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "benchmark", "metrics", "scans_in_window.py"), "w") as f:
        f.write(PROBE)
    with open(os.path.join(root, "benchmark", "limits", f"{CELL}.json"), "w") as f:
        json.dump({"limits": LIMITS}, f)
    bench = spec.load()
    bench["configs"].append({"name": "tiny128", "source": cfg["source"], "file": "benchmark/configs/tiny128.json",
                             "reduced": [], "why": "a throwaway configuration for the harness's tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny128", "traffic": "tiny-sweep", "chips": 1,
                               "why": "a throwaway cell for the harness's tests"})
    for m in bench["end_to_end"]:
        if m["name"] == "fps":
            m["workloads"].append(CELL)
    bench["per_layer"].append({"name": "scans_in_window", "unit": "scans", "better": "higher",
                               "source": "host_clock", "layer": "harness", "moves": "fps", "workloads": [CELL]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return root
