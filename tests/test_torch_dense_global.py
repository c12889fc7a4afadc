"""The paper's sparse + dense global bundle adjustment
(``use_dense_global=True``, the reference's ``s_useGlobalDenseOpt``) against
the JAX package, on 21 frames (5 chunks, 5 keyframes, at most 10 dense
pairs) at 128x96 with the tiny configuration:

* with the dense-pair gate on the dense-verify filter
  (``dense_overlap_check``, the default), on clean orbit frames, with a list
  of 8 slots that the 10 pairs overflow: the pairs past the last slot are
  dropped (the lowest inlier counts of the last keyframe) and counted in
  ``dense_overflow``;
* with the gate on the inlier count alone and a list of 64 slots, on the
  noisy frames of ``test_torch_noisy.py``, where the two gates differ: the
  inlier gate keeps all 10 pairs, the dense-verify gate 8 (it rejects
  keyframe 4's pairs with keyframes 1 and 2).

Every GN iteration evaluates every slot of the list, live or not, on both
sides; the lists are cut from the default 4,096 slots so that the two runs
fit the suite's time (the card runs 4,096, ``chip_smoke.py`` phase 13).

Bars: those of ``torch_parity`` (validity, keyframes and the runlog's exact
counters equal; poses within 2e-5; block keys within 1%, weight sums within
1e-3 relative), and the dense-pair list equal: its cursor, the pairs and
their live flags up to the cursor, and the overflow count.
"""

import numpy as np
import pytest

from bundlefusion_tpu.io.synthetic import apply_sensor_noise, generate_sequence
from torch_parity import CHECKS, assert_pipelines_match, one_torch_thread, run_both  # noqa: F401
from util import cached_sequence

N = 21
CASES = {
    "overlap_check_overflow": dict(dense_overlap_check=True, max_dense_pairs_global=8),
    "inlier_gate_noisy": dict(dense_overlap_check=False, max_dense_pairs_global=64),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    if request.param == "inlier_gate_noisy":
        seq, batch = apply_sensor_noise(generate_sequence(N, width=128, height=96, radius=0.35)), 8
    else:
        seq, batch = cached_sequence(N, width=128, height=96), 4
    return request.param, run_both(seq, bundling=dict(use_dense_global=True, **CASES[request.param]),
                                   batch_size=batch)


@pytest.mark.parametrize("check", CHECKS)
def test_dense_global_matches_jax(runs, check):
    name, (j, t) = runs
    assert_pipelines_match(j, t, f"dense global, {name}", check)
    assert t[1].valid.all() and t[1].num_keyframes == 5


def test_dense_pair_list_matches_jax(runs):
    name, ((bj, _), (bt, _)) = runs
    gj, gt = bj.graph, bt.state.graph
    cur, over = int(gj.dense_cursor), int(gj.dense_overflow)
    print(f"{name}: dense cursor {cur}, overflow {over}, pairs (a, b) "
          f"{list(zip(np.asarray(gj.dense_pairs_a)[:cur].tolist(), np.asarray(gj.dense_pairs_b)[:cur].tolist()))}")
    assert int(gt.dense_cursor) == cur > 0 and int(gt.dense_overflow) == over
    assert (over > 0) == (CASES[name]["max_dense_pairs_global"] < 10)
    for f in ("dense_pairs_a", "dense_pairs_b", "dense_pair_on"):
        np.testing.assert_array_equal(np.asarray(getattr(gj, f))[:cur], getattr(gt, f)[:cur].numpy(), err_msg=f)
