"""Two solver switches of the port against the JAX package, each on 13
frames (3 chunks) at 128x96 with the tiny configuration:

* ``use_dense_local=False``: the intra-chunk BA on sparse terms only;
* ``dense_weight_ramp=False``: the dense weights at full strength in every
  GN iteration instead of ramping in as (i + 1) / n.

Bars: those of ``torch_parity`` (validity, keyframes and the runlog's exact
counters equal; poses within 2e-5; block keys within 1%, weight sums within
1e-3 relative).
"""

import pytest

from torch_parity import CHECKS, assert_pipelines_match, one_torch_thread, run_both  # noqa: F401
from util import cached_sequence

SETTINGS = {
    "sparse_local": dict(use_dense_local=False),
    "no_dense_ramp": dict(dense_weight_ramp=False),
}


@pytest.fixture(scope="module", params=sorted(SETTINGS))
def runs(request):
    return request.param, run_both(cached_sequence(13, width=128, height=96), bundling=SETTINGS[request.param])


@pytest.mark.parametrize("check", CHECKS)
def test_solver_switch_matches_jax(runs, check):
    name, (j, t) = runs
    assert_pipelines_match(j, t, name, check)
    assert t[1].valid.all() and t[1].num_keyframes == 3
