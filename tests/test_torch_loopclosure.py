"""The JAX package's loop-closure scenario (``tests/test_loopclosure.py``:
the out-and-back orbit, 41 frames at 128x96, batches of 8) through the port,
with the global BA sparse only and with its dense terms
(``use_dense_global``), each against the JAX package on the same frames.

Bars: those of ``torch_parity`` (validity, keyframes and the runlog's exact
counters equal; poses within 2e-5; block keys within 1%, weight sums within
1e-3 relative), and on the port ``test_dense_global_ba_tightens_loop``'s own
assertions: no lost chunk, dense pairs collected, ATE < 2 cm with the dense
terms and no worse than 1.10 x the sparse ATE + 1e-4 m; and
``test_loop_closure_creates_nonadjacent_correspondences``'s: weighted
correspondences between keyframes 3 or more apart.

The dense-pair list has 64 slots (the default 4,096 on the card,
``chip_smoke.py`` phase 13): every GN iteration evaluates every slot on both
sides, and the run collects 44 pairs.
"""

import numpy as np
import pytest

from bundlefusion_tpu_torch.eval.ate import ate_rmse
from test_loopclosure import _out_and_back_sequence
from torch_parity import CHECKS, assert_pipelines_match, one_torch_thread, run_both  # noqa: F401


@pytest.fixture(scope="module")
def runs():
    seq = _out_and_back_sequence()
    return seq, {dg: run_both(seq, bundling=dict(use_dense_global=dg, max_dense_pairs_global=64), batch_size=8)
                 for dg in (False, True)}


def _ate(seq, out):
    n = min(len(out.poses), len(seq.poses))
    return ate_rmse(out.poses[:n], seq.poses[:n], valid=out.valid[:n])


@pytest.mark.parametrize("check", CHECKS)
@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
def test_out_and_back_matches_jax(runs, dense, check):
    _, r = runs
    assert_pipelines_match(*r[dense], f"out-and-back, use_dense_global={dense}", check)


def test_dense_global_tightens_loop_on_the_port(runs):
    seq, r = runs
    ates = {}
    for dg, (_, (bt, ot)) in r.items():
        ates[dg] = _ate(seq, ot)
        assert ot.tracking_lost_chunks == 0
    print(f"port ATE sparse {ates[False] * 100:.4f} cm, dense {ates[True] * 100:.4f} cm; dense cursor "
          f"{int(r[True][1][0].state.graph.dense_cursor)}")
    assert int(r[True][1][0].state.graph.dense_cursor) > 0
    assert ates[True] < 0.02
    assert ates[True] <= ates[False] * 1.10 + 1e-4, ates


def test_loop_closes_against_early_keyframes_on_the_port(runs):
    _, r = runs
    for dg, (_, (bt, _)) in r.items():
        corrs = bt.state.graph.corrs
        gap = (corrs.img_a - corrs.img_b).abs().numpy()
        loop = int(((corrs.weight.numpy() > 0) & (gap >= 3)).sum())
        print(f"use_dense_global={dg}: {loop} weighted correspondences between keyframes 3 or more apart")
        assert loop > 0
