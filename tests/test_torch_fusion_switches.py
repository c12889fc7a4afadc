"""Two fusion switches of the port against the JAX package, each on 13
frames (3 chunks) at 128x96 with the tiny configuration:

* ``depth_filter=False``: the chunk step uses the raw depth, with no
  bilateral filter before K2's geometry and the cache;
* ``max_reintegrations_per_frame=2``: the re-integration planner may pick
  a frame twice per chunk step.

Bars: those of ``torch_parity`` (validity, keyframes and the runlog's exact
counters, ``alloc_overflow``, ``upd_truncated`` and ``reint_frames`` among
them, equal; poses within 2e-5; block keys within 1%, weight sums within
1e-3 relative).
"""

import pytest

from torch_parity import CHECKS, assert_pipelines_match, one_torch_thread, run_both  # noqa: F401
from util import cached_sequence

SETTINGS = {
    "no_depth_filter": dict(depth_filter=False),
    "reintegrate_twice": dict(max_reintegrations_per_frame=2),
}


@pytest.fixture(scope="module", params=sorted(SETTINGS))
def runs(request):
    return request.param, run_both(cached_sequence(13, width=128, height=96), app=SETTINGS[request.param])


@pytest.mark.parametrize("check", CHECKS)
def test_fusion_switch_matches_jax(runs, check):
    name, (j, t) = runs
    assert_pipelines_match(j, t, name, check)
    assert t[1].valid.all() and t[1].num_keyframes == 3
