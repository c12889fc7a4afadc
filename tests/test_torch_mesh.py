"""Meshing and previews: the port's marching cubes, PLY writer, trilinear
sampling and raycast against the JAX package, on one table the JAX package
fused (eight frames at 64x48, tiny config) and ``interop`` carried across.

Bars: the same triangle count and order, vertices and colours within 1e-5;
byte-identical PLY files; trilinear samples within 1e-5 with equal validity;
raycast at 64x48 with ``splat_truncated`` equal, hit masks differing in at
most 1% of the pixels, depth within 1e-4 m and normals within 1e-3 where both
sides hit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.config import tiny_test_config as j_tiny
from bundlefusion_tpu.fusion import blocks as jb
from bundlefusion_tpu.fusion import marching_cubes as jmc
from bundlefusion_tpu.fusion import raycast as jrc
from bundlefusion_tpu.fusion import tsdf as jt
from bundlefusion_tpu.io import ply as jply
from bundlefusion_tpu_torch import interop
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.fusion import blocks as tb
from bundlefusion_tpu_torch.fusion import marching_cubes as tmc
from bundlefusion_tpu_torch.fusion import raycast as trc
from bundlefusion_tpu_torch.io import ply as tply
from util import cached_sequence

APP_J = j_tiny().app
APP_T = t_tiny().app


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU; PyTorch's
    own thread pool per process would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fused():
    """(numpy JAX table, the port's table, sequence)."""
    seq = cached_sequence(8, width=64, height=48)
    table = jb.make_table(APP_J.block_capacity)
    table, _ = jt.integrate_batch(
        table, jnp.asarray(seq.depth), jnp.asarray(seq.color), jnp.asarray(seq.poses),
        jnp.ones(8, bool), seq.camera, APP_J,
    )
    np_table = jax.tree.map(np.asarray, table)
    return np_table, interop.state_from_numpy(np_table, "cpu"), seq


@pytest.fixture(scope="module")
def meshes(fused):
    np_table, ttab, _ = fused
    return jmc.extract_mesh(jax.tree.map(jnp.asarray, np_table), APP_J), tmc.extract_mesh(ttab, APP_T)


def test_marching_cubes_matches_jax(meshes):
    (vj, cj, fj), (vt, ct, ft) = meshes
    print(f"triangles: jax {len(fj)}, port {len(ft)}")
    assert len(ft) == len(fj) > 1000
    np.testing.assert_array_equal(fj, ft)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-5)


@pytest.mark.parametrize("block_batch", [7, 4096])
def test_marching_cubes_order_is_independent_of_the_batch(fused, meshes, block_batch):
    _, ttab, _ = fused
    _, (vt, ct, ft) = meshes
    v, c, f = tmc.extract_mesh(ttab, APP_T, block_batch=block_batch)
    assert np.array_equal(v, vt) and np.array_equal(c, ct) and np.array_equal(f, ft)


def test_marching_cubes_truncates_as_jax(fused, meshes):
    import dataclasses

    _, ttab, _ = fused
    (vj, _, _), _ = meshes
    cap = 1000
    with pytest.warns(UserWarning, match="mc_max_triangles"):
        v, c, f = tmc.extract_mesh(ttab, dataclasses.replace(APP_T, mc_max_triangles=cap))
    assert f.shape == (cap, 3)
    np.testing.assert_allclose(v, vj[: 3 * cap], rtol=0, atol=1e-5)


@pytest.mark.parametrize("colors", ["float", "uint8", "none"])
@pytest.mark.parametrize("with_faces", [True, False])
def test_write_ply_is_byte_identical(tmp_path, meshes, colors, with_faces):
    _, (v, c, f) = meshes
    col = {"float": c, "uint8": (c * 255).astype(np.uint8), "none": None}[colors]
    faces = f if with_faces else None
    jply.write_ply(str(tmp_path / "j.ply"), v, col, faces)
    tply.write_ply(str(tmp_path / "t.ply"), v, col, faces)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()


def test_sample_trilinear_matches_jax(fused):
    np_table, ttab, seq = fused
    rng = np.random.default_rng(3)
    # points on and around the observed surface
    d = seq.depth[0]
    v, u = np.nonzero(d > 0)
    pick = rng.choice(len(v), 600, replace=False)
    z = d[v[pick], u[pick]]
    cam = seq.camera
    pc = np.stack([(u[pick] - cam.cx) / cam.fx * z, (v[pick] - cam.cy) / cam.fy * z, z], -1)
    pw = pc @ seq.poses[0][:3, :3].T + seq.poses[0][:3, 3]
    pw = (pw + rng.normal(scale=0.02, size=pw.shape)).astype(np.float32)
    sj, cj, okj = jb.sample_trilinear(jax.tree.map(jnp.asarray, np_table), jnp.asarray(pw), APP_J.voxel_size)
    st, ct, okt = tb.sample_trilinear(ttab, torch.as_tensor(pw), APP_T.voxel_size)
    okj = np.asarray(okj)
    np.testing.assert_array_equal(okj, okt.numpy())
    assert okj.mean() > 0.5
    np.testing.assert_allclose(st.numpy()[okj], np.asarray(sj)[okj], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ct.numpy()[okj], np.asarray(cj)[okj], rtol=0, atol=1e-5)
    s_only, none, ok_only = tb.sample_trilinear(ttab, torch.as_tensor(pw), APP_T.voxel_size, with_color=False)
    assert none is None and torch.equal(ok_only, okt) and torch.equal(s_only, st)


@pytest.mark.parametrize("frame", [0, 7])
def test_raycast_matches_jax(fused, frame):
    np_table, ttab, seq = fused
    pose = seq.poses[frame]
    rj = jrc.raycast(jax.tree.map(jnp.asarray, np_table), jnp.asarray(pose), seq.camera, APP_J)
    rt = trc.raycast(ttab, torch.as_tensor(pose), seq.camera, APP_T)
    assert int(rj.splat_truncated) == int(rt.splat_truncated)
    hj, ht = np.asarray(rj.hit), rt.hit.numpy()
    both = hj & ht
    print(f"hits: jax {hj.sum()}, port {ht.sum()}, differing {(hj != ht).sum()} of {hj.size}")
    assert hj.mean() > 0.5
    assert (hj != ht).mean() <= 0.01
    np.testing.assert_allclose(rt.depth.numpy()[both], np.asarray(rj.depth)[both], rtol=0, atol=1e-4)
    np.testing.assert_allclose(rt.normal.numpy()[both], np.asarray(rj.normal)[both], rtol=0, atol=1e-3)
    np.testing.assert_allclose(rt.color.numpy()[both], np.asarray(rj.color)[both], rtol=0, atol=1e-3)
    np.testing.assert_allclose(
        trc.shade_preview(rt).numpy()[both], np.asarray(jrc.shade_preview(rj))[both], rtol=0, atol=1e-3
    )


def test_splat_intervals_match_jax(fused):
    np_table, ttab, seq = fused
    pose = seq.poses[3]
    nj, fj, tj = jrc.splat_intervals(jax.tree.map(jnp.asarray, np_table), jnp.asarray(pose), seq.camera, APP_J)
    nt, ft, tt = trc.splat_intervals(ttab, torch.as_tensor(pose), seq.camera, APP_T)
    assert int(tj) == int(tt)
    assert trc.splat_span(seq.camera, APP_T) == jrc.splat_span(seq.camera, APP_J)
    np.testing.assert_array_equal(np.asarray(fj) > 0, ft.numpy() > 0)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-6)
