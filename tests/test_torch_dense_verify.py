"""The dense verification (kernel K5, ``features/filters.py::
dense_verify_sums``): its twin, which the wrapper runs on CPU tensors,
against the JAX package's ``dense_verify`` and ``dense_verify_filter``
(the matmul-form sampling) on the same numpy inputs.

* Rendered frames (``util.cached_sequence``), preprocessed by the JAX
  package into its cache: the tiny configuration's 32x24 cache and the
  flagship's 80x60, every pair of four frames at the ground-truth relative
  pose and at poses moved off it.
* The edge cases of ``chip_smoke.verify_edge_inputs``: every a-side pixel
  invalid; points at z <= 1e-6; uv exactly on w - 1 and h - 1 and inside
  the 1e-4 band past them; a pair with no projected pixel; a NaN in T_ba.
* The order in which K5 sums the depth errors, as a numpy model: the twin
  follows it bit for bit, and one mutation of the order is told apart.

Bars: the counts exact (the ratios bit-equal: they divide the same
integers), ``err`` within 1e-6 relative (the twin sums in the kernel's
order, XLA in its own; the two samplings may differ by an FMA's rounding),
filter masks equal. The kernel itself is held bit-equal to this twin on the
card (``test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.config import Config as JConfig
from bundlefusion_tpu.config import tiny_test_config as j_tiny
from bundlefusion_tpu.features import filters as jf
from bundlefusion_tpu.geometry.camera import CameraModel as JCam
from bundlefusion_tpu.ops import preprocess as jpp
from bundlefusion_tpu_torch.config import Config as TConfig
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.features import filters as tf
from bundlefusion_tpu_torch.geometry.camera import CameraModel as TCam
from bundlefusion_tpu_torch.io.framewire import frame_to_wire2
from bundlefusion_tpu_torch.ops.preprocess import FrameCache
from chip_smoke import K5_EDGE_CASES, verify_edge_inputs
from util import cached_sequence

ERR_RTOL = 1e-6
# (JAX config, port config, frame width, frame height): the cache is the config's
SIZES = {"tiny": (j_tiny, t_tiny, 128, 96), "flagship": (JConfig, TConfig, 160, 120)}
NF = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k


@pytest.fixture(scope="module", params=list(SIZES))
def rendered(request):
    """Four rendered frames' caches, and every pair (a < b) at the true
    relative pose, moved 2 cm, and turned 3 degrees: numpy (cache a, cache b,
    T_ba [P, 4, 4], camera, configs)."""
    jc, tc, fw, fh = SIZES[request.param]
    jb, tb = jc().bundling, tc().bundling
    seq = cached_sequence(NF, width=fw, height=fh)
    cam = seq.camera
    cc = cam.scaled(jb.cache_width, jb.cache_height)
    wires = [frame_to_wire2(seq.depth[i], seq.color[i], depth_min=0.1, depth_max=4.0) for i in range(NF)]
    _, cache = jpp.preprocess_frames_y(jnp.asarray(np.stack([x[0] for x in wires])),
                                       jnp.asarray(np.stack([x[1] for x in wires])), cam, cc)
    cache = [np.asarray(f) for f in cache]
    pa, pb = np.triu_indices(NF, 1)
    poses = np.asarray(seq.poses, np.float64)
    rel = np.stack([np.linalg.inv(poses[b]) @ poses[a] for a, b in zip(pa, pb)])
    moved, turned = rel.copy(), rel.copy()
    moved[:, :3, 3] += [0.02, -0.01, 0.015]
    turned[:, :3, :3] = _rot([0.3, 1.0, -0.2], np.deg2rad(3.0)) @ rel[:, :3, :3]
    T = np.concatenate([rel, moved, turned]).astype(np.float32)
    ia, ib = np.tile(pa, 3), np.tile(pb, 3)
    a = tuple(f[ia] for f in cache)
    b = tuple(f[ib] for f in cache)
    return a, b, T, tuple(cc), (jb, tb)


def _jax_stats(a, b, T, cam, jb):
    jcam = JCam(*cam)
    ca, cb = jpp.FrameCache(*map(jnp.asarray, a)), jpp.FrameCache(*map(jnp.asarray, b))
    stats = jax.vmap(lambda x, y, t: jf.dense_verify(x, y, t, jcam, jb))(ca, cb, jnp.asarray(T))
    ok = jax.vmap(lambda x, y, t: jf.dense_verify_filter(x, y, t, jcam, jb))(ca, cb, jnp.asarray(T))
    return {k: np.asarray(v) for k, v in stats._asdict().items()}, np.asarray(ok)


def _port(a, b, T, cam, tb):
    tcam = TCam(*cam)
    ca, cb = FrameCache(*map(torch.as_tensor, a)), FrameCache(*map(torch.as_tensor, b))
    stats = tf.dense_verify(ca, cb, torch.as_tensor(T), tcam, tb)
    ok = tf.dense_verify_filter(ca, cb, torch.as_tensor(T), tcam, tb)
    sums = tf.dense_verify_sums(ca, cb, (torch.as_tensor(T),), tcam, tb)[0]
    return {k: getattr(stats, k).numpy() for k in ("ok_frac", "overlap", "err", "corr")}, ok.numpy(), sums.numpy()


def _check(a, b, T, cam, cfgs):
    jb, tb = cfgs
    js, jok = _jax_stats(a, b, T, cam, jb)
    ts, tok, sums = _port(a, b, T, cam, tb)
    # the valid count is the a-side's depth > 0; the other two follow from
    # the ratios, which divide the same integers on both sides
    np.testing.assert_array_equal(sums[:, 0], (a[0] > 0).reshape(len(T), -1).sum(1))
    for k in ("ok_frac", "overlap", "corr"):
        np.testing.assert_array_equal(js[k], ts[k], err_msg=k)
    np.testing.assert_allclose(ts["err"], js["err"], rtol=ERR_RTOL, atol=0)
    np.testing.assert_array_equal(jok, tok)
    return sums


def test_twin_matches_jax_on_rendered_frames(rendered):
    a, b, T, cam, cfgs = rendered
    sums = _check(a, b, T, cam, cfgs)
    # the pairs exercise every outcome: projected, agreeing, and a filter pass
    assert sums[:, 1].min() > 0 and sums[:, 2].max() > 0
    assert (sums[:, 2] < sums[:, 1]).any()


@pytest.mark.parametrize("case", K5_EDGE_CASES)
@pytest.mark.parametrize("size", ["tiny", "flagship"])
def test_twin_matches_jax_on_edge_cases(case, size):
    jc, tc = SIZES[size][:2]
    cb = jc().bundling
    a, b, T, cam = verify_edge_inputs(case, h=cb.cache_height, w=cb.cache_width)
    sums = _check(a, b, T, cam, (cb, tc().bundling))
    if case == "all_invalid":
        assert sums[0].tolist() == [0.0, 0.0, 0.0, 0.0]
    if case in ("no_projection", "nan_transform"):
        assert sums[0, 0] > 0 and sums[0, 1:].tolist() == [0.0, 0.0, 0.0]
    if case == "z_tiny":
        # only z above 1e-6 (f32) projects: the next float up and 1e-5
        _, proj, _, _ = tf._verify_terms(*(FrameCache(*map(torch.as_tensor, x)) for x in (a, b)),
                                             torch.as_tensor(T), TCam(*cam), tc().bundling)
        z = torch.as_tensor(a[1][..., 2]).reshape(len(T), -1)
        assert not bool((proj[0] & (z[0] <= np.float32(1e-6))).any())
        assert bool((proj[0] & (z[0] > np.float32(1e-6)) & (z[0] < 2e-5)).any())
    if case == "band":
        # u on w - 1 projects; u in the band past it is in bounds but not inside
        _, proj, _, _ = tf._verify_terms(*(FrameCache(*map(torch.as_tensor, x)) for x in (a, b)),
                                             torch.as_tensor(T), TCam(*cam), tc().bundling)
        u = torch.as_tensor(a[1][0, ..., 0]).reshape(-1)
        v = torch.as_tensor(a[1][0, ..., 1]).reshape(-1)
        w1, h1 = cam[4] - 1.0, cam[5] - 1.0
        assert bool(proj[0][(u == w1) & (v <= h1) & (v >= 0)].any())
        assert not bool(proj[0][(u > w1) | (v > h1)].any())


def _kernel_order_model(x: np.ndarray, threads: int = tf._THREADS) -> np.ndarray:
    """K5's order in numpy, float32 throughout: thread t's running sum over
    pixels t, t + threads, ... from +0.0; each warp's 32 sums halved
    (lane i + lane i + off, off = 16 ... 1); the warps' sums halved too."""
    x = np.asarray(x, np.float32)
    lead, d = x.shape[:-1], x.shape[-1]
    acc = np.zeros(lead + (threads,), np.float32)
    for p0 in range(0, d, threads):
        chunk = x[..., p0:p0 + threads]
        acc[..., : chunk.shape[-1]] = acc[..., : chunk.shape[-1]] + chunk
    acc = acc.reshape(lead + (threads // 32, 32))
    for width in (32, threads // 32):
        off = width // 2
        while off:
            acc = acc[..., :off] + acc[..., off:2 * off]
            off //= 2
        acc = acc[..., 0]
    return acc


def _blocked_model(x: np.ndarray, threads: int = tf._THREADS) -> np.ndarray:
    """A mutation of the order: each thread sums a contiguous block of pixels
    instead of a strided set (the warp and block trees unchanged)."""
    d = x.shape[-1]
    per = -(-d // threads)
    pad = np.zeros(x.shape[:-1] + (per * threads,), np.float32)
    pad[..., :d] = x
    blocked = pad.reshape(x.shape[:-1] + (threads, per)).swapaxes(-1, -2).reshape(pad.shape)
    return _kernel_order_model(blocked, threads)


@pytest.mark.parametrize("d", [768, 4800, 1000])
def test_err_sum_order_model(d):
    """The twin's sum is the model's bit for bit on 64 rows of depth-error
    like data (a 70% share of pixels projected), and the blocked mutation
    differs from it in the last bit on some of them (both orders are
    trees, so most rows round alike)."""
    rng = np.random.default_rng(d)
    x = (rng.random((64, d)) * (rng.random((64, d)) < 0.7)).astype(np.float32)
    twin = tf._sum_in_kernel_order(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(twin, _kernel_order_model(x))
    assert (_blocked_model(x) != twin).sum() >= 8
    np.testing.assert_allclose(twin, x.astype(np.float64).sum(-1), rtol=1e-5)


def test_twin_err_follows_the_model(rendered):
    a, b, T, cam, (_, tb) = rendered
    ca, cb = (FrameCache(*map(torch.as_tensor, x)) for x in (a, b))
    _, proj, _, dist = tf._verify_terms(ca, cb, torch.as_tensor(T), TCam(*cam), tb)
    sums = tf.dense_verify_sums(ca, cb, (torch.as_tensor(T),), TCam(*cam), tb)[0].numpy()
    np.testing.assert_array_equal(sums[:, 3], _kernel_order_model(torch.where(proj, dist, 0.0).numpy()))
