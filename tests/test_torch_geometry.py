"""Geometry, camera, wire, ATE and the synthetic renderer: the port against
the JAX package on the same numpy inputs (1e-6 unless stated), plus the
se(3) Jacobian checks redone with ``torch.func``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.eval import ate as jate
from bundlefusion_tpu.geometry import camera as jcam
from bundlefusion_tpu.geometry import se3 as jse3
from bundlefusion_tpu.io import framewire as jfw
from bundlefusion_tpu.io import synthetic as jsyn
from bundlefusion_tpu_torch.eval import ate as tate
from bundlefusion_tpu_torch.geometry import camera as tcam
from bundlefusion_tpu_torch.geometry import se3 as tse3
from bundlefusion_tpu_torch.io import framewire as tfw
from bundlefusion_tpu_torch.io import synthetic as tsyn
from util import cached_sequence


def _twists(seed, n=32, scale=0.8):
    return (np.random.default_rng(seed).standard_normal((n, 6)) * scale).astype(np.float32)


def _poses(seed, n=32):
    return np.asarray(jse3.se3_exp(jnp.asarray(_twists(seed, n))))


def _close(j, t, atol=1e-6):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), atol=atol, rtol=0)


CASES = {
    "hat": lambda m, x: m.hat(x[..., :3]),
    "so3_exp": lambda m, x: m.so3_exp(x[..., :3]),
    "se3_exp": lambda m, x: m.se3_exp(x),
    "so3_log": lambda m, x: m.so3_log(m.so3_exp(x[..., :3])),
    "se3_log": lambda m, x: m.se3_log(m.se3_exp(x)),
    "mat_inverse": lambda m, x: m.mat_inverse(m.se3_exp(x)),
    "rt_to_mat": lambda m, x: m.rt_to_mat(m.so3_exp(x[..., :3]), x[..., 3:]),
    "transform_points": lambda m, x: m.transform_points(m.se3_exp(x), x[..., None, 3:] * 2.0),
    "rotate_vectors": lambda m, x: m.rotate_vectors(m.se3_exp(x), x[..., :3]),
    "pose_distance": lambda m, x: m.pose_distance(m.se3_exp(x), m.se3_exp(x * 0.5))[0],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_se3_matches_jax(name):
    x = _twists(1)
    fn = CASES[name]
    _close(fn(jse3, jnp.asarray(x)), fn(tse3, torch.as_tensor(x)))


def test_so3_log_near_pi():
    axis = np.array([[0.3, -0.5, 0.8]], np.float32)
    axis /= np.linalg.norm(axis)
    for ang in (np.pi - 1e-4, np.pi - 5e-4, 2.0):
        w = (axis * ang).astype(np.float32)
        j = jse3.so3_log(jse3.so3_exp(jnp.asarray(w)))
        t = tse3.so3_log(tse3.so3_exp(torch.as_tensor(w)))
        _close(j, t, atol=1e-5)  # the pi branch divides by a norm near 0
        np.testing.assert_allclose(t.numpy(), w, atol=2e-3)


def test_kabsch_and_umeyama_match_jax():
    rng = np.random.default_rng(2)
    src = rng.standard_normal((4, 40, 3)).astype(np.float32)
    T = _poses(3, 4)
    dst = np.einsum("bij,bnj->bni", T[:, :3, :3], src) + T[:, None, :3, 3]
    w = (rng.random((4, 40)) > 0.2).astype(np.float32)
    jk = jse3.kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))
    tk = tse3.kabsch(torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(w))
    _close(jk, tk, atol=2e-6)
    np.testing.assert_allclose(tk.numpy(), T, atol=1e-4)
    js, jR, jt = jse3.umeyama_alignment(jnp.asarray(src[0]), jnp.asarray(dst[0]), with_scale=True)
    ts, tR, tt = tse3.umeyama_alignment(torch.as_tensor(src[0]), torch.as_tensor(dst[0]), with_scale=True)
    for a, b in ((js, ts), (jR, tR), (jt, tt)):
        _close(a, b, atol=2e-6)


def test_point_jacobian_with_torch_func():
    """d(exp(xi) p)/d xi at xi = 0 is [-hat(p) | I] (the solver's convention)."""
    p = torch.tensor([0.3, -1.2, 2.5])
    J = torch.func.jacrev(lambda xi: tse3.transform_points(tse3.se3_exp(xi), p))(torch.zeros(6))
    want = torch.cat([-tse3.hat(p), torch.eye(3)], dim=-1)
    torch.testing.assert_close(J, want, atol=1e-6, rtol=0)


def test_log_exp_jacobian_is_identity():
    xi = torch.as_tensor(_twists(4, 1, 0.5)[0])
    J = torch.func.jacrev(lambda x: tse3.se3_log(tse3.se3_exp(x)))(xi)
    torch.testing.assert_close(J, torch.eye(6), atol=2e-4, rtol=0)


def test_camera_matches_jax():
    seq = cached_sequence(2, width=64, height=48)
    jc = seq.camera
    tc = tcam.CameraModel.create(*jc)
    assert tuple(tc.scaled(32, 24)) == tuple(jc.scaled(32, 24))
    _close(jcam.unproject(jc, jnp.asarray(seq.depth)), tcam.unproject(tc, torch.as_tensor(seq.depth)))
    pts = np.random.default_rng(5).standard_normal((100, 3)).astype(np.float32) + [0, 0, 2]
    juv, jok = jcam.project(jc, jnp.asarray(pts))
    tuv, tok = tcam.project(tc, torch.as_tensor(pts))
    _close(juv, tuv, atol=2e-5)
    assert np.array_equal(np.asarray(jok), tok.numpy())


def test_framewire_and_ate_match_jax(monkeypatch):
    monkeypatch.setattr(jfw, "_load", lambda: None)  # the JAX package's numpy branch
    seq = cached_sequence(4, width=64, height=48)
    for i in range(4):
        for a, b in zip(
            jfw.frame_to_wire2(seq.depth[i], seq.color[i], depth_min=0.1, depth_max=4.0),
            tfw.frame_to_wire2(seq.depth[i], seq.color[i], depth_min=0.1, depth_max=4.0),
        ):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    est = seq.poses.copy()
    est[:, :3, 3] += np.random.default_rng(6).normal(scale=0.01, size=(4, 3))
    assert jate.ate_rmse(est, seq.poses) == tate.ate_rmse(est, seq.poses)
    assert jate.rpe(est, seq.poses) == tate.rpe(est, seq.poses)


def test_synthetic_renderer_matches_jax():
    assert np.array_equal(tsyn.orbit_poses(5, seed=3), jsyn.orbit_poses(5, seed=3))
    j = jsyn.generate_sequence(3, width=48, height=32)
    t = tsyn.generate_sequence(3, width=48, height=32, device="cpu")
    assert tuple(t.camera) == tuple(j.camera)
    # sphere tracing amplifies last-ulp differences only at silhouettes
    dd = np.abs(j.depth - t.depth)
    assert np.mean(dd < 1e-4) > 0.99
    assert np.mean(np.abs(j.color - t.color) < 1e-3) > 0.99
