"""A throwaway cell, added as new files only, runs through the harness on
the CPU (the port's plain PyTorch twins, a stand-in for the card); with
the timed path broken underneath, ``correct`` comes out false."""

import dataclasses
import io
import json
from contextlib import redirect_stdout

import pytest

from benchmark import calibrate, run, spec
from bundlefusion_tpu_torch.bundle import chunk as chunk_mod
from bundlefusion_tpu_torch.bundle import pipeline, trajectory
from bundlefusion_tpu_torch.fusion import tsdf

from . import tiny_cell


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_cell.make_root(str(tmp_path_factory.mktemp("bench_root")))


@pytest.fixture(autouse=True)
def host_card(monkeypatch):
    monkeypatch.setattr(run, "open_card", tiny_cell.no_card)


def run_cell(root, seed):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", tiny_cell.CELL, "--seed", str(seed), "--seconds", "6", "--trace", "0"],
                      root=root)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_new_cell_is_found_and_runs(root):
    cell = spec.cell(tiny_cell.CELL, root)
    assert [m["name"] for m in cell.per_layer] == ["scans_in_window"]
    assert spec.reader("scans_in_window", root).read(type("C", (), {"window": type("W", (), {"scans": [1, 2]})})) == 2
    res = run_cell(root, 1)
    assert res["correct"] is True, res["compared"]
    assert set(res["metrics"]) == {"fps", "setup_s"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "compared"


def publish_nothing(ts, frame_ids, poses, valid, keep=None):
    """A step that returns its state unchanged: the trajectory is never published."""
    return ts


def fuse_nothing(st, *args, **kwargs):
    """A step that returns its state unchanged: plan_fuse fuses nothing."""


def half_the_chunk(orig):
    def wrapped(*args, **kwargs):
        """Half of each chunk's frames left out of its local solve: each odd
        frame takes the pose of the kept frame before it."""
        res = orig(*args, **kwargs)
        lt = res.local_traj.clone()
        lt[1::2] = lt[0::2][: lt[1::2].shape[0]]
        return dataclasses.replace(res, local_traj=lt)
    return wrapped


def altered_answer(orig):
    def wrapped(ts, frame_ids, poses, valid, keep=None):
        """An answer altered where it is produced: frame 7's published pose
        moves 2 cm."""
        ts = orig(ts, frame_ids, poses, valid, keep)
        opt = ts.opt_pose.clone()
        opt[7, 0, 3] += 0.02
        return dataclasses.replace(ts, opt_pose=opt)
    return wrapped


FAULTS = {
    "publish_unchanged": (trajectory, "update_optimized", lambda orig: publish_nothing),
    "fuse_unchanged": (pipeline, "_plan_and_fuse", lambda orig: fuse_nothing),
    "half_the_chunk": (chunk_mod, "process_chunk", half_the_chunk),
    "altered_answer": (trajectory, "update_optimized", altered_answer),
    # the faults read on the card for the limits (benchmark/calibrate.py)
    "every_other_frame": (tsdf, "integrate_blocks", calibrate.every_other_frame),
    "half_the_surface": (tsdf, "allocate", calibrate.half_the_surface),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(root, fault, monkeypatch):
    module, name, make = FAULTS[fault]
    monkeypatch.setattr(module, name, make(getattr(module, name)))
    res = run_cell(root, 2)
    assert res["correct"] is False, res["compared"]
