"""The multi-sequence driver (``parallel/spmd_pipeline.py``): the port on a
2-shard CPU mesh against the JAX package on 2 of its simulated devices, 2 sequences of 13 frames (3 chunks) at
128x96 with the tiny configuration.

Bars: validity and the runlog's exact counters equal, its other counters
within 1% (as ``test_torch_pipeline.py``); poses within 2e-5 (the
pipeline's bar, ROADMAP Queue 3); equal block key sets, and TSDF weights
equal but for at most 4 voxels per sequence (the FMA-contraction flips of
ROADMAP Queue 3). The driver reads nothing back before its final fetch.
The app's ``--multiseq`` route is ``test_torch_spmd_app.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bundlefusion_tpu.io import framewire as jfw
from bundlefusion_tpu.parallel import mesh as jmesh
from bundlefusion_tpu.parallel.spmd_pipeline import run_sequences_sharded as j_run_sharded
from bundlefusion_tpu_torch import interop
from bundlefusion_tpu_torch.bundle.pipeline import RUNREC_FIELDS
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.fusion.blocks import INVALID_KEY
from bundlefusion_tpu_torch.parallel.mesh import make_mesh
from bundlefusion_tpu_torch.parallel.spmd_pipeline import extract_mesh_for, run_sequences_sharded
from util import cached_sequence

W, H, N, D = 128, 96, 13, 2
EXACT = ("chunk_valid", "kf_valid", "reloc", "tracking_lost", "num_keys", "pairs_valid", "alloc_overflow",
         "upd_truncated", "ring_miss", "reint_frames", "lost_chunks", "patch_overflow")
WITHIN_1PCT = ("filtered_matches", "blocks_touched", "active_blocks", "corr_cursor")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    c = t_tiny()
    return dataclasses.replace(c, app=dataclasses.replace(c.app, input_width=W, input_height=H,
                                                          integration_width=W, integration_height=H))


@pytest.fixture(scope="module")
def runs():
    """Both drivers on the same frames; the port's run counts every host
    read of a tensor it makes."""
    from bundlefusion_tpu.config import tiny_test_config as j_tiny

    seqs = [cached_sequence(N, width=W, height=H, seed=s) for s in range(D)]
    anchors = np.stack([s.poses[0] for s in seqs])
    jc = j_tiny()
    jc = dataclasses.replace(jc, app=dataclasses.replace(jc.app, input_width=W, input_height=H,
                                                         integration_width=W, integration_height=H))
    mp = pytest.MonkeyPatch()
    mp.setattr(jfw, "_load", lambda: None)
    try:
        jout = j_run_sharded(seqs, jmesh.make_mesh(D), jc, anchor_poses=anchors)
    finally:
        mp.undo()
    reads: list[str] = []
    mp = pytest.MonkeyPatch()
    # (numpy() is absent: a device tensor must pass through cpu() first, and
    # the upload's staging buffer is a host tensor)
    for name in ("item", "tolist", "cpu", "__array__", "__bool__", "__int__", "__float__", "__index__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            reads.append(_name)
            return _orig(self, *a, **k)

        mp.setattr(torch.Tensor, name, counted)
    try:
        tout = run_sequences_sharded(seqs, make_mesh(D, "cpu"), _cfg(), anchor_poses=anchors)
    finally:
        mp.undo()
    return seqs, jout, tout, reads


def test_driver_is_readback_free(runs):
    """The only host reads are the final fetch: poses, validity, runlogs."""
    _, _, tout, reads = runs
    assert reads == ["cpu"] * 3, reads[:8]
    assert tout.poses.shape == (D, N, 4, 4)


def test_sharded_driver_matches_jax(runs):
    seqs, jout, tout, _ = runs
    assert tout.num_keyframes == jout.num_keyframes == 3
    np.testing.assert_array_equal(jout.valid, tout.valid)
    assert tout.valid.all()
    err = float(np.abs(jout.poses - tout.poses).max())
    print(f"sharded driver: max |pose jax - port| {err:.3g}")
    assert err <= 2e-5
    assert jout.runlogs.shape == tout.runlogs.shape
    for i, k in enumerate(RUNREC_FIELDS):
        a, b = jout.runlogs[..., i], tout.runlogs[..., i]
        if k in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif k in WITHIN_1PCT:
            assert (np.abs(a - b) <= 0.01 * np.maximum(np.abs(a), 1)).all(), (k, a, b)


def test_sharded_tsdf_matches_jax(runs):
    _, jout, tout, _ = runs
    jt = interop.stacked_to_numpy(interop.stacked_from_numpy(jout.tables, ["cpu"] * D))
    tt = interop.stacked_to_numpy(tout.tables)
    for i in range(D):
        kj, kt = jt["key_of_slot"][i], tt["key_of_slot"][i]
        assert set(kj[kj != INVALID_KEY].tolist()) == set(kt[kt != INVALID_KEY].tolist())
        # voxel weights by block key
        wj = dict(zip(kj.tolist(), jt["weight"][i]))
        wt = dict(zip(kt.tolist(), tt["weight"][i]))
        flips = sum(int((wj[k] != wt[k]).sum()) for k in wj if k != INVALID_KEY)
        print(f"sequence {i}: {len(wj) - 1} blocks, {flips} voxel weights differ")
        assert flips <= 4
    verts, _, faces = extract_mesh_for(tout, 0, _cfg())
    assert len(faces) > 500 and np.isfinite(verts).all()
