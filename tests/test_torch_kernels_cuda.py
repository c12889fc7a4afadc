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


def _row(dev, frames):
    cam, depth, c8, poses = frames
    table = blocks.make_table(APP.block_capacity, dev)
    table, _ = tsdf.integrate_batch(table, depth[:3], c8[:3], poses[:3], torch.ones(3, dtype=torch.bool, device=dev), cam, APP)
    keys, _ = tsdf._upd_keys_batch(depth[3:4], poses[3:4], torch.ones(1, dtype=torch.bool, device=dev), cam, APP)
    table, _ = blocks.allocate(table, keys[0], assume_unique_sorted=True)
    slots, mask = blocks.lookup(table, keys[0])
    return table, slots, mask


def _copy(t):
    return dataclasses.replace(t, sdf=t.sdf.clone(), weight=t.weight.clone(), color=t.color.clone())


def test_k1_kernel_matches_twin(dev, frames):
    cam, depth, c8, poses = frames
    table, slots, mask = _row(dev, frames)
    params = tsdf.row_params(poses[3:4], torch.ones(1, device=dev), cam)[0]
    tk, tt = _copy(table), _copy(table)
    launches = tsdf.integrate_blocks.launches
    tsdf.integrate_blocks(tk, slots, mask, depth[3], c8[3], params, APP)
    tsdf._integrate_blocks_torch(tt, slots, mask, depth[3], c8[3], params, APP)
    torch.cuda.synchronize()
    assert tsdf.integrate_blocks.launches == launches + 1
    assert torch.equal(tk.weight[:-1], tt.weight[:-1])
    assert torch.equal(tk.sdf[:-1], tt.sdf[:-1])
    assert torch.equal(tk.color[:-1], tt.color[:-1])
    assert not torch.equal(tk.weight, table.weight)


def test_k1_deintegrate_restores_weights(dev, frames):
    cam, depth, c8, poses = frames
    table, slots, mask = _row(dev, frames)
    before = table.weight.clone()
    for sign in (1.0, -1.0):
        params = tsdf.row_params(poses[3:4], torch.full((1,), sign, device=dev), cam)[0]
        tsdf.integrate_blocks(table, slots, mask, depth[3], c8[3], params, APP)
    assert torch.equal(table.weight, before)


@pytest.mark.parametrize("radius", [3, 0])
def test_k2_kernel_matches_twin(dev, frames, radius):
    cam, depth, _, _ = frames
    got = pp.fused_preprocess(depth, cam, radius=radius)
    want = pp._preprocess_chain_torch(depth, cam, 2.0, 0.1, radius)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrappers_reject_bad_inputs(dev, frames):
    cam, depth, c8, poses = frames
    table, slots, mask = _row(dev, frames)
    params = tsdf.row_params(poses[3:4], torch.ones(1, device=dev), cam)[0]
    with pytest.raises(ValueError):
        tsdf.integrate_blocks(table, slots.long(), mask, depth[3], c8[3], params, APP)
    with pytest.raises(ValueError):
        pp.fused_preprocess(depth.double(), cam)
