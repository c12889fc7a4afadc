"""The measurement path refuses to run without a card, and in a directory
that holds only BENCHMARK.json and the benchmark's files: it exits with
another code than 0 and prints no result."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import spec


ARGS = ["--workload", "bf640-1cm.room-sweep", "--seed", "3", "--seconds", "1", "--trace", "0"]


def run_cell(cwd, stand_in=False):
    if stand_in:  # past the look for a card, as on a machine that has one
        cmd = [sys.executable, "-c", "import sys, torch; from benchmark import run, drive; "
               "run.open_card = lambda chips: type('C', (), {'device': torch.device('cpu')})(); "
               f"sys.exit(run.main({ARGS!r}))"]
    else:
        cmd = [sys.executable, "-m", "benchmark.run", *ARGS]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=600, env=env)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = run_cell(spec.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    for p in spec.load()["paths"]:
        shutil.copytree(os.path.join(spec.ROOT, p), tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    for stand_in in (False, True):
        out = run_cell(tmp_path, stand_in)
        assert out.returncode != 0
        assert out.stdout.strip() == ""
    assert "bundlefusion_tpu_torch" in out.stderr  # the program is not there
