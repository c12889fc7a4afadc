"""Noisy sensor input through the port against the JAX package: the JAX
package's ``apply_sensor_noise`` (axial and lateral noise, disparity
quantization, edge dropout, exposure drift) on 21 orbit frames at 128x96,
batches of 8, as ``tests/test_aux.py::test_pipeline_on_kinect_noise`` builds
them; both sides on the same noisy frames.

Bars: those of ``torch_parity`` (validity, keyframes and the runlog's exact
counters equal; poses within 2e-5; block keys within 1%, weight sums within
1e-3 relative), and the JAX test's own on the port: no lost chunk and ATE
< 2 cm.
"""

import pytest

from bundlefusion_tpu.io.synthetic import apply_sensor_noise, generate_sequence
from bundlefusion_tpu_torch.eval.ate import ate_rmse
from torch_parity import CHECKS, assert_pipelines_match, one_torch_thread, run_both  # noqa: F401


@pytest.fixture(scope="module")
def runs():
    seq = apply_sensor_noise(generate_sequence(21, width=128, height=96, radius=0.35))
    return seq, run_both(seq, batch_size=8)


@pytest.mark.parametrize("check", CHECKS)
def test_noisy_input_matches_jax(runs, check):
    _, (j, t) = runs
    assert_pipelines_match(j, t, "noisy input", check)


def test_noisy_input_tracks_on_the_port(runs):
    seq, (_, (_, ot)) = runs
    n = min(len(ot.poses), len(seq.poses))
    ate = ate_rmse(ot.poses[:n], seq.poses[:n], valid=ot.valid[:n])
    print(f"noisy input: port ATE {ate * 100:.4f} cm, valid fraction {ot.valid[:n].mean():.3f}")
    assert ot.tracking_lost_chunks == 0
    assert ate < 0.02
