"""Preprocessing: kernel K2's twin against the Pallas kernel in interpret mode
(1e-5 / 1e-5 / 1e-4, ``tests/test_pallas.py``), and the port's
``preprocess_frames_y`` and sampling helpers against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.ops import preprocess as jpp
from bundlefusion_tpu.ops.pallas_kernels import fused_preprocess_pallas
from bundlefusion_tpu_torch.io.framewire import frame_to_wire2
from bundlefusion_tpu_torch.ops import preprocess as tpp
from util import cached_sequence


@pytest.fixture(scope="module")
def seq():
    return cached_sequence(4, width=64, height=48)


def test_k2_twin_matches_pallas_interpret(seq):
    depth = seq.depth[:2]
    want = fused_preprocess_pallas(jnp.asarray(depth), seq.camera, interpret=True)
    got = tpp.fused_preprocess(torch.as_tensor(depth), seq.camera)
    for w, g, tol in zip(want, got, (1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(np.asarray(w), g.numpy(), atol=tol, rtol=0)


def test_k2_twin_without_geometry(seq):
    """geometry=False: the same filtered depth, and no point or normal maps."""
    depth = seq.depth[:2]
    want = fused_preprocess_pallas(jnp.asarray(depth), seq.camera, interpret=True)[0]
    fd, pts, nrm = tpp.fused_preprocess(torch.as_tensor(depth), seq.camera, geometry=False)
    assert pts is None and nrm is None
    assert torch.equal(fd, tpp.fused_preprocess(torch.as_tensor(depth), seq.camera)[0])
    np.testing.assert_allclose(np.asarray(want), fd.numpy(), atol=1e-5, rtol=0)


def test_k2_twin_invalid_depth_and_identity_radius(seq):
    d = np.zeros((1, 48, 64), np.float32)
    d[0, 10:20, 10:20] = 2.0
    fd, pts, nrm = tpp.fused_preprocess(torch.as_tensor(d), seq.camera)
    assert float(fd[0, :5, :5].abs().max()) == 0.0 and float(fd[0, 15, 15]) > 1.9
    # radius 0 is the identity filter (the depth_filter=False configuration)
    depth = torch.as_tensor(seq.depth[:1])
    fd0, pts0, _ = tpp.fused_preprocess(depth, seq.camera, radius=0)
    assert torch.equal(fd0, depth)
    want = jpp.unproject(seq.camera, jnp.asarray(seq.depth[:1]))
    np.testing.assert_allclose(np.asarray(want), pts0.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("filter_depth", [True, False])
def test_preprocess_frames_y_matches_jax(seq, filter_depth):
    cam = seq.camera
    cc = cam.scaled(32, 24)
    w = [frame_to_wire2(seq.depth[i], seq.color[i], depth_min=0.1, depth_max=4.0) for i in range(4)]
    d16 = np.stack([x[0] for x in w])
    y8 = np.stack([x[1] for x in w])
    fj, cj = jpp.preprocess_frames_y(jnp.asarray(d16), jnp.asarray(y8), cam, cc, filter_depth=filter_depth)
    ft, ct = tpp.preprocess_frames_y(
        torch.as_tensor(d16.view(np.int16)), torch.as_tensor(y8), cam, cc, filter_depth=filter_depth
    )
    np.testing.assert_allclose(np.asarray(fj.depth), ft.depth.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(fj.intensity), ft.intensity.numpy(), atol=1e-6, rtol=0)
    for k in ("depth", "points", "normals", "intensity", "grad"):
        np.testing.assert_allclose(np.asarray(getattr(cj, k)), getattr(ct, k).numpy(), atol=1e-5, rtol=0, err_msg=k)


def _img(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


HELPERS = {
    "gaussian_filter": lambda m, x: m.gaussian_filter(x, 1.3),
    "image_gradients": lambda m, x: m.image_gradients(x)[1],
    "downsample_depth": lambda m, x: m.downsample_depth(x * (x > 0.3), 2, 4),
    "downsample_mean": lambda m, x: m.downsample_mean(x, 4, 2),
    "bilateral_filter_depth": lambda m, x: m.bilateral_filter_depth(x * (x > 0.2) + 1.0),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_image_helpers_match_jax(name):
    x = _img(1, (2, 24, 32))
    j = HELPERS[name](jpp, jnp.asarray(x))
    t = HELPERS[name](tpp, torch.as_tensor(x))
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=2e-6, rtol=0)


def test_compute_normals_matches_jax(seq):
    cam = seq.camera
    pts_j = jpp.unproject(cam, jnp.asarray(seq.depth[:2]))
    j = jpp.compute_normals(pts_j)
    t = tpp.compute_normals(torch.as_tensor(np.asarray(pts_j)))
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=1e-5, rtol=0)


def test_samplers_match_jax():
    img = _img(2, (24, 32, 5))
    uv = (np.random.default_rng(3).random((200, 2)) * [34, 26] - 1).astype(np.float32)
    for fn in ("bilinear_sample", "bilinear_sample_matmul", "nearest_sample"):
        vj, mj = getattr(jpp, fn)(jnp.asarray(img), jnp.asarray(uv))
        vt, mt = getattr(tpp, fn)(torch.as_tensor(img), torch.as_tensor(uv))
        np.testing.assert_allclose(np.asarray(vj), vt.numpy(), atol=2e-6, rtol=0, err_msg=fn)
        np.testing.assert_array_equal(np.asarray(mj), mt.numpy(), err_msg=fn)


def test_gather_sampler_matches_matmul_form():
    """The dense BA's gather sampler against the matmul form it replaces
    (and JAX's), batched over pairs, with coordinates on and just past every
    border (the 1e-4 slack of the in-bounds test, the clamp to w - 1.001),
    on integer pixels, out of the image and NaN. Bar: 2e-6 on values in
    [0, 1), the two forms differ only where a matmul rounds through an FMA;
    the in-bounds masks and the NaNs are equal."""
    h, w = 24, 32
    img = _img(4, (3, h, w, 5))
    rng = np.random.default_rng(5)
    edges_u = [-1.0, -1e-6, 0.0, 0.5, 3.0, w - 1.001, w - 1.0005, w - 1.0, w - 1.0 + 5e-5, w - 1.0 + 2e-4, w, 40.0]
    edges_v = [-1.0, -1e-6, 0.0, 0.5, 3.0, h - 1.001, h - 1.0005, h - 1.0, h - 1.0 + 5e-5, h - 1.0 + 2e-4, h, 30.0]
    grid = np.array([(u, v) for u in edges_u for v in edges_v], np.float32)
    rand = (rng.random((3, 100, 2)) * [w + 2, h + 2] - 1).astype(np.float32)
    uv = np.concatenate([np.broadcast_to(grid, (3, *grid.shape)), rand, np.full((3, 1, 2), np.nan, np.float32)], 1)
    vg, mg = tpp.bilinear_sample_gather(torch.as_tensor(img), torch.as_tensor(uv))
    vm, mm = tpp.bilinear_sample_matmul(torch.as_tensor(img), torch.as_tensor(uv))
    assert vg.shape == vm.shape == (3, uv.shape[1], 5)
    assert torch.equal(mg, mm)
    assert torch.equal(torch.isnan(vg), torch.isnan(vm)) and bool(torch.isnan(vg[:, -1]).all())
    np.testing.assert_allclose(vg[:, :-1].numpy(), vm[:, :-1].numpy(), atol=2e-6, rtol=0)
    for i in range(3):
        vj, mj = jpp.bilinear_sample_matmul(jnp.asarray(img[i]), jnp.asarray(uv[i, :-1]))
        np.testing.assert_allclose(np.asarray(vj), vg[i, :-1].numpy(), atol=2e-6, rtol=0)
        np.testing.assert_array_equal(np.asarray(mj), mg[i, :-1].numpy())
