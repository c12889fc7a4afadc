"""The harness finds each cell's configuration, traffic mix, metric readers
and limits by the names in BENCHMARK.json."""

import json
import os

import pytest

from benchmark import spec

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_parts_found_by_name(name):
    cell = spec.cell(name)
    assert cell.config["chips"] == cell.chips == 1
    assert cell.mix["loop"] in ("closed", "open")
    cfg = spec.port_config(cell.config)
    assert cfg.app.input_width == 640 and cfg.app.input_height == 480
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in names, f"{m['name']} moves {m['moves']}, which {name} does not report"
        assert callable(spec.reader(m["name"]).read)
    with open(os.path.join(spec.ROOT, "benchmark", "limits", f"{name}.json")) as f:
        assert json.load(f)["limits"]


def test_every_metric_has_a_reader_and_every_config_a_file():
    for m in BENCH["per_layer"]:
        assert os.path.exists(os.path.join(spec.ROOT, "benchmark", "metrics", f"{m['name']}.py"))
    for c in BENCH["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such.cell")
