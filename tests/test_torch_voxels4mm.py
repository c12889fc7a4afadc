"""4 mm voxels, the ``AppConfig`` defaults (``voxel_size=0.004``,
``truncation=0.02``, ``block_capacity=16384``, ``blocks_per_frame_cap=4096``;
``BASELINE.json`` config 3), through the port against the JAX package on 9
frames (2 chunks) at 128x96 with the tiny configuration otherwise (the JAX
side integrates 4,096 blocks a frame, the slowest case of the suite).

At these defaults each chunk's update lists lose blocks to
``blocks_per_frame_cap`` on both sides (ROADMAP Queue 1): the runlog's
``upd_truncated`` is non-zero, and it and ``alloc_overflow`` must be equal.

Bars: those of ``torch_parity`` (validity, keyframes and the runlog's exact
counters equal; poses within 2e-5; block keys within 1%, weight sums within
1e-3 relative).
"""

import pytest

from torch_parity import CHECKS, assert_pipelines_match, chunk_records, one_torch_thread, run_both  # noqa: F401
from util import cached_sequence

APP = dict(voxel_size=0.004, truncation=0.02, block_capacity=16384, blocks_per_frame_cap=4096)


@pytest.fixture(scope="module")
def runs():
    return run_both(cached_sequence(9, width=128, height=96), app=APP)


@pytest.mark.parametrize("check", CHECKS)
def test_4mm_voxels_match_jax(runs, check):
    assert_pipelines_match(*runs, "4 mm voxels", check)


def test_4mm_voxels_truncate_updates(runs):
    """The runlog's counters are equal (the ``runlog`` check above); at
    these defaults the update lists lose blocks to the cap."""
    _, t = runs
    recs = chunk_records(t[0])
    trunc = [int(r["upd_truncated"]) for r in recs]
    print(f"4 mm voxels: upd_truncated per chunk {trunc}, alloc_overflow {[int(r['alloc_overflow']) for r in recs]}, "
          f"active blocks {int(t[0].state.table.num_active())}")
    assert sum(trunc) > 0
    assert t[1].valid.all()
