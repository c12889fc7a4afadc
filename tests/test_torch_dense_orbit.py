"""The dense global BA on the orbit at the flagship's bundling configuration
(submap 10, 128 keyframes, 512 keys, 3 octaves, an 80x60 cache) and 320x240
input, 33 frames: where the reference's dense terms double the ATE of the
sparse-only solve (ROADMAP Queue 3). Opt-in (``slow``, ~15 minutes here):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_dense_orbit.py -m slow -s -q

* the JAX package and the port, sparse only and dense, on the same frames:
  validity equal, poses within 2e-5, ATE within 2e-6 m of each other: the
  port reproduces the reference's result;
* the port with one dense term at a time: which term moves the ATE. The
  synthetic renderer shades by the view ray (``io/synthetic.py``,
  ``render_frame``), so a surface's intensity changes between views, which
  the photometric term assumes it does not.

The dense-pair list has 64 slots (21 pairs are collected).
"""

import dataclasses

import numpy as np
import pytest

import bundlefusion_tpu as J
import bundlefusion_tpu_torch as T
from bundlefusion_tpu.bundle.pipeline import run_sequence as jax_run
from bundlefusion_tpu.io import framewire as jfw
from bundlefusion_tpu.io.replayer import Replayer, SyntheticSource
from bundlefusion_tpu.io.synthetic import generate_sequence
from bundlefusion_tpu_torch.bundle.pipeline import run_sequence as port_run
from bundlefusion_tpu_torch.eval.ate import ate_rmse
from bundlefusion_tpu_torch.io import framewire as tfw

W, H, N = 320, 240, 33


def _cfg(M, **bundling):
    return M.Config(
        app=M.AppConfig(input_width=W, input_height=H, integration_width=W, integration_height=H,
                        voxel_size=0.01, truncation=0.04, block_capacity=65536, blocks_per_frame_cap=4096,
                        raycast_width=160, raycast_height=120),
        bundling=M.BundlingConfig(submap_size=10, max_num_images=128, max_keys_per_image=512, sift_octaves=3,
                                  cache_width=80, cache_height=60, verify_width=80, verify_height=60,
                                  verify_ok_fraction=0.45, verify_color_thresh=0.08, max_dense_pairs_global=64,
                                  **bundling),
    )


@pytest.fixture(scope="module")
def seq():
    return generate_sequence(N, width=W, height=H, radius=0.5)


@pytest.fixture(autouse=True)
def _numpy_wire(monkeypatch):
    monkeypatch.setattr(jfw, "_load", lambda: None)
    monkeypatch.setattr(tfw, "_load", lambda: None)


def _ate(seq, out):
    return ate_rmse(out.poses[:N], seq.poses[:N], valid=out.valid[:N])


@pytest.mark.slow
def test_dense_global_orbit_matches_jax(seq):
    ates = {}
    for dense in (False, True):
        _, oj = jax_run(Replayer(SyntheticSource(seq), batch_size=11), _cfg(J, use_dense_global=dense),
                        anchor_pose=seq.poses[0])
        _, ot = port_run(Replayer(SyntheticSource(seq), batch_size=11), _cfg(T, use_dense_global=dense),
                         anchor_pose=seq.poses[0], device="cpu")
        np.testing.assert_array_equal(oj.valid, ot.valid)
        err = float(np.abs(oj.poses - ot.poses).max())
        ates[dense] = (_ate(seq, oj), _ate(seq, ot))
        print(f"use_dense_global={dense}: ATE JAX {ates[dense][0] * 100:.4f} cm, port {ates[dense][1] * 100:.4f} cm; "
              f"max |pose jax - port| {err:.3g}")
        assert ot.valid.all() and err <= 2e-5
        assert abs(ates[dense][0] - ates[dense][1]) <= 2e-6


@pytest.mark.slow
@pytest.mark.parametrize("term", ["depth_only", "colour_only"])
def test_dense_terms_on_the_orbit(seq, term):
    zero = dict(depth_only=dict(weight_dense_color=0.0), colour_only=dict(weight_dense_depth=0.0))[term]
    _, ot = port_run(Replayer(SyntheticSource(seq), batch_size=11), _cfg(T, use_dense_global=True, **zero),
                     anchor_pose=seq.poses[0], device="cpu")
    print(f"dense global BA, {term}: port ATE {_ate(seq, ot) * 100:.4f} cm")
    assert ot.valid.all() and np.isfinite(ot.poses).all()
