"""Find a cell's parts by name: ``BENCHMARK.json`` names the cell, its
configuration and its traffic mix, and the metrics; each part is a file of
its own under ``benchmark/``:

* a configuration: the file ``BENCHMARK.json`` gives it (``configs/<name>.json``:
  the port's ``Config`` fields under ``app`` and ``bundling``, with
  ``source``, ``reduced``, ``assumed`` and ``chips``);
* a traffic mix: ``traffic/<mix>.json``, parameters for ``drive.py``;
* a per-layer metric: ``metrics/<metric>.py``, a reader with ``read(ctx)``;
* a cell's correctness limits: ``limits/<cell>.json`` (``judge.py``).

Adding a cell, a mix or a metric is adding files and entries; no file that
is there changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict  # the configuration file's contents
    mix: dict  # the traffic mix's parameters
    end_to_end: list  # BENCHMARK.json's end-to-end metrics that this cell reports
    per_layer: list  # ... and its per-layer metrics


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _one(items: list, name: str, what: str) -> dict:
    found = [x for x in items if x["name"] == name]
    if len(found) != 1:
        raise KeyError(f"BENCHMARK.json has {len(found)} {what} named {name!r}")
    return found[0]


def cell(name: str, root: str = ROOT) -> Cell:
    bench = load(root)
    w = _one(bench["workloads"], name, "workloads")
    c = _one(bench["configs"], w["config"], "configs")
    with open(os.path.join(root, c["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic", f"{w['traffic']}.json")) as f:
        mix = json.load(f)
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]
    return Cell(name, w["chips"], w["config"], config, mix, e2e, per_layer)


def port_config(config: dict):
    """The port's ``Config`` of a configuration file."""
    from bundlefusion_tpu_torch.config import Config

    return Config.from_json(json.dumps({"app": config["app"], "bundling": config["bundling"]}))


def reader(metric: str, root: str = ROOT):
    """The reader module of a per-layer metric (``metrics/<metric>.py``)."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod
