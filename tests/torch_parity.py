"""Helpers of the pipeline parity tests that hold one code path of the port
against the JAX package (``test_torch_dense_global.py``,
``test_torch_loopclosure.py``, ``test_torch_tracking.py``,
``test_torch_noisy.py``, ``test_torch_solver_switches.py``,
``test_torch_fusion_switches.py``,
``test_torch_voxels4mm.py``): both sides run ``run_sequence`` on the same
frames at 128x96 with the tiny configuration, on their numpy wire, and are
compared with the bars of ``test_torch_pipeline.py``:

* validity, keyframe counts and the runlog's exact counters (``EXACT``,
  ``tracking_lost`` and ``reloc`` among them) equal;
* poses within 2e-5 (the global solves' f32 sums in another order stop at
  PCG's gate, ROADMAP Queue 3);
* block key sets within 1% and the TSDF weight sum within 1e-3 relative (a
  few voxels flip, ROADMAP Queue 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from bundlefusion_tpu.bundle.pipeline import run_sequence as jax_run
from bundlefusion_tpu.config import tiny_test_config as j_tiny
from bundlefusion_tpu.io import framewire as jfw
from bundlefusion_tpu.io.replayer import Replayer, SyntheticSource
from bundlefusion_tpu_torch.bundle.pipeline import run_sequence as port_run
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.io import framewire as tfw

W, H = 128, 96
POSE_BAR = 2e-5
EXACT = ("chunk_valid", "kf_valid", "reloc", "tracking_lost", "num_keys", "pairs_valid", "alloc_overflow",
         "upd_truncated", "ring_miss", "reint_frames", "lost_chunks")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(app: dict | None = None, bundling: dict | None = None):
    """(JAX, port) tiny configurations at 128x96 input and integration, with
    the given fields of ``AppConfig`` and ``BundlingConfig`` changed."""
    out = []
    for tiny in (j_tiny, t_tiny):
        c = tiny()
        out.append(dataclasses.replace(
            c,
            app=dataclasses.replace(c.app, input_width=W, input_height=H, integration_width=W,
                                    integration_height=H, **(app or {})),
            bundling=dataclasses.replace(c.bundling, **(bundling or {})),
        ))
    return tuple(out)


def run_both(seq, app=None, bundling=None, batch_size=4):
    """``run_sequence`` of the JAX package and of the port (on the CPU) on
    ``seq``, both on their numpy wire; returns ((bf, out) JAX, (bf, out) port)."""
    jcfg, tcfg = configs(app, bundling)
    mp = pytest.MonkeyPatch()
    mp.setattr(jfw, "_load", lambda: None)
    mp.setattr(tfw, "_load", lambda: None)
    try:
        j = jax_run(Replayer(SyntheticSource(seq), batch_size=batch_size), jcfg, anchor_pose=seq.poses[0])
        t = port_run(Replayer(SyntheticSource(seq), batch_size=batch_size), tcfg, anchor_pose=seq.poses[0],
                     device="cpu")
    finally:
        mp.undo()
    return j, t


def chunk_records(bf):
    return [r for r in bf.runlog.records if "chunk_valid" in r]


CHECKS = ("runlog", "poses", "volume")


def assert_pipelines_match(j, t, label: str, check: str) -> None:
    """One of the bars above (``CHECKS``): the runlog (validity, keyframes
    and the exact counters), the poses, or the volume (block keys and the
    TSDF weight sum)."""
    (bj, oj), (bt, ot) = j, t
    if check == "runlog":
        assert ot.num_keyframes == oj.num_keyframes, label
        np.testing.assert_array_equal(oj.valid, ot.valid, err_msg=label)
        assert ot.tracking_lost_chunks == oj.tracking_lost_chunks, label
        rj, rt = chunk_records(bj), chunk_records(bt)
        assert len(rj) == len(rt) > 0, label
        for a, b in zip(rj, rt):
            for k in EXACT:
                assert a[k] == b[k], (label, a["chunk"], k, a[k], b[k])
        print(f"{label}: runlogs equal; chunks valid {[int(r['chunk_valid']) for r in rt]}")
    elif check == "poses":
        err = float(np.abs(oj.poses - ot.poses).max())
        print(f"{label}: max |pose jax - port| {err:.3g}")
        assert err <= POSE_BAR, label
    else:
        kj = set(np.asarray(bj.table.keys).tolist())
        kt = set(bt.state.table.keys.numpy().tolist())
        wj = float(np.asarray(bj.table.weight, np.float64).sum())
        wt = float(bt.state.table.weight.double().sum())
        print(f"{label}: block keys differ in {len(kj ^ kt)} of {len(kj)}; weight sums {wj} / {wt}")
        assert len(kj ^ kt) <= 0.01 * len(kj), label
        assert abs(wj - wt) <= 1e-3 * wj, label
