"""Tracking loss and a corrupt chunk through the port against the JAX
package, in the JAX package's own scenarios (``tests/test_pipeline.py``):

* tracking loss: 41 frames at 128x96 with the depth zeroed over frames
  12..24, batches of 8: the lost flag is set only after
  ``max_invalid_chunks_lost`` (3) consecutive invalid chunks and cleared by
  relocalization (``test_tracking_lost_after_consecutive_invalid_chunks``);
* a corrupt chunk: 21 frames with the depth zeroed over frames 9..12,
  batches of 4 (``test_pipeline_handles_corrupt_chunk``).

Bars: those of ``torch_parity`` (validity, keyframes and the runlog's exact
counters, ``tracking_lost`` and ``reloc`` per chunk among them, equal; poses
within 2e-5; block keys within 1%, weight sums within 1e-3 relative), and
the JAX tests' own assertions on the port.
"""

import numpy as np
import pytest

from bundlefusion_tpu_torch.eval.ate import ate_rmse
from torch_parity import CHECKS, assert_pipelines_match, chunk_records, one_torch_thread, run_both  # noqa: F401
from util import cached_sequence

SCENARIOS = {
    "tracking_loss": dict(frames=41, zero=(12, 25), batch_size=8),
    "corrupt_chunk": dict(frames=21, zero=(9, 13), batch_size=4),
}


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def runs(request):
    s = SCENARIOS[request.param]
    seq = cached_sequence(s["frames"], width=128, height=96)
    depth = seq.depth.copy()
    depth[slice(*s["zero"])] = 0.0
    seq = seq._replace(depth=depth)
    return request.param, seq, run_both(seq, batch_size=s["batch_size"])


@pytest.mark.parametrize("check", CHECKS)
def test_scenario_matches_jax(runs, check):
    name, _, (j, t) = runs
    assert_pipelines_match(j, t, name, check)


def test_jax_assertions_hold_on_the_port(runs):
    name, seq, (_, (bt, ot)) = runs
    recs = chunk_records(bt)
    valid = np.asarray(ot.valid)
    if name == "corrupt_chunk":
        assert not valid[9:13].all()
        assert ate_rmse(ot.poses[:9], seq.poses[:9], valid=valid[:9]) < 0.02
        assert valid[13:].any()
        return
    lost = np.array([bool(r["tracking_lost"]) for r in recs])
    print(f"{name}: tracking_lost per chunk {lost.astype(int).tolist()}, reloc per chunk "
          f"{[int(r['reloc']) for r in recs]}")
    chunk_valid = np.array([bool(r["chunk_valid"]) for r in recs])
    bad = np.flatnonzero(~chunk_valid)
    first = int(bad[0])
    assert first >= 2 and len(bad) >= 4
    assert (bad[:4] == np.arange(first, first + 4)).all()
    assert not lost[first] and not lost[first + 1]
    assert lost[first + 2]
    assert not lost[-1]
    assert any(r["reloc"] for r in recs)
    assert valid[28:].all()
