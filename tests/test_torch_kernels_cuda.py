"""The CUDA kernels against their plain PyTorch twins, on the card.

These tests need an NVIDIA card and skip elsewhere. They import neither JAX
nor the JAX package, so they run on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from bundlefusion_tpu_torch.config import tiny_test_config
from bundlefusion_tpu_torch.fusion import blocks, tsdf
from bundlefusion_tpu_torch.io.framewire import frame_to_wire2
from bundlefusion_tpu_torch.io.synthetic import generate_sequence
from bundlefusion_tpu_torch.ops import preprocess as pp

pytestmark = pytest.mark.cuda
APP = tiny_test_config().app


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def frames(dev):
    seq = generate_sequence(5, 64, 48, device=dev)
    w = [frame_to_wire2(seq.depth[i], seq.color[i], depth_min=0.1, depth_max=4.0) for i in range(5)]
    depth = pp.wire_depth_to_m(torch.as_tensor(np.stack([x[0] for x in w]).view(np.int16), device=dev))
    c8 = torch.as_tensor(np.stack([x[2] for x in w]), device=dev)
    return seq.camera, depth, c8, torch.as_tensor(seq.poses, device=dev)


def _fuse(dev, frames):
    """A table holding frames 0..2, and the rows of a fuse_batch over frames
    0..4 that de-integrates 0..2 and re-integrates all five at moved poses
    (R = 10 rows, two of them fully masked; most blocks in several rows)."""
    cam, depth, c8, poses = frames
    table = blocks.make_table(APP.block_capacity, dev)
    ones = torch.ones(5, dtype=torch.bool, device=dev)
    table, diag = tsdf.integrate_batch(table, depth[:3], c8[:3], poses[:3], ones[:3], cam, APP)
    moved = poses.clone()
    moved[:, :3, 3] += torch.tensor([0.01, -0.004, 0.006], device=dev)
    rec = torch.zeros((5, APP.blocks_per_frame_cap), dtype=torch.bool, device=dev)
    rec[:3] = diag.upd_mask
    keys = torch.full_like(rec, blocks.INVALID_KEY, dtype=torch.int32)
    keys[:3] = diag.upd_keys
    table, rows, _ = tsdf.fuse_batch_rows(
        table, depth, poses, moved, ones & (torch.arange(5, device=dev) < 3), ones, rec, cam, APP,
        upd_keys_rec=keys,
    )
    return table, rows


def _copy(t):
    return dataclasses.replace(t, sdf=t.sdf.clone(), weight=t.weight.clone(), color=t.color.clone())


def test_k1_kernel_matches_twin(dev, frames):
    _, depth, c8, _ = frames
    table, rows = _fuse(dev, frames)
    assert rows.fidx.shape[0] == 10
    tk, tt = _copy(table), _copy(table)
    launches = tsdf.integrate_blocks.launches
    tsdf.integrate_blocks(tk, rows, depth, c8, APP)
    tsdf._integrate_rows_torch(tt, rows, depth, c8, APP)
    torch.cuda.synchronize()
    assert tsdf.integrate_blocks.launches == launches + 1
    assert torch.equal(tk.weight[:-1], tt.weight[:-1])
    assert torch.equal(tk.sdf[:-1], tt.sdf[:-1])
    assert torch.equal(tk.color[:-1], tt.color[:-1])
    assert not torch.equal(tk.weight, table.weight)


def test_k1_deintegrate_restores_weights(dev, frames):
    _, depth, c8, _ = frames
    table, rows = _fuse(dev, frames)
    before = table.weight.clone()
    tsdf.integrate_blocks(table, rows, depth, c8, APP)
    assert not torch.equal(table.weight, before)
    tsdf.integrate_blocks(table, rows.inverse(), depth, c8, APP)
    assert torch.equal(table.weight, before)


@pytest.fixture(scope="module")
def depths(dev, frames):
    """The synthetic 64x48 frames, and random 70x45 frames with holes: the
    K2 tiles are 32x16 (30x14 with geometry), so 70x45 leaves ragged tiles."""
    rng = np.random.default_rng(0)
    d = rng.uniform(0.5, 3.0, size=(3, 45, 70)).astype(np.float32)
    d[rng.random(d.shape) < 0.1] = 0.0
    return {"synthetic": frames[1], "ragged": torch.as_tensor(d, device=dev)}


@pytest.mark.parametrize("geometry", [True, False])
@pytest.mark.parametrize("radius", [3, 0])
@pytest.mark.parametrize("which", ["synthetic", "ragged"])
def test_k2_kernel_matches_twin(dev, frames, depths, which, radius, geometry):
    cam = frames[0]
    depth = depths[which]
    launches = pp.fused_preprocess.launches
    got = pp.fused_preprocess(depth, cam, radius=radius, geometry=geometry)
    want = pp._preprocess_chain_torch(depth, cam, 2.0, 0.1, radius, geometry)
    torch.cuda.synchronize()
    assert pp.fused_preprocess.launches == launches + 1
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert (g is None and w is None) if not geometry else torch.equal(g, w)


def test_wrappers_reject_bad_inputs(dev, frames):
    cam, depth, c8, _ = frames
    table, rows = _fuse(dev, frames)
    with pytest.raises(ValueError):
        tsdf.integrate_blocks(table, dataclasses.replace(rows, slots=rows.slots.long()), depth, c8, APP)
    with pytest.raises(ValueError):
        pp.fused_preprocess(depth.double(), cam)
    with pytest.raises(ValueError):
        pp.fused_preprocess(depth, cam, radius=4)
