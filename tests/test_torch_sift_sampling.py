"""SIFT's window sampling (kernel K4, ``features/sift.py::sample_window``):
its twin, which the wrapper runs on CPU tensors, against the JAX package's
matmul form (``_extract_patches`` + ``_unpack_grads`` +
``_gather_grads_patches``) and against the port's own matmul form, on the
same numpy inputs.

Each case holds one octave's packed gradient image (exact integers qx * 4096
+ qy, as ``_pack_grads`` makes them) of 2 frames and 40 keys, windows as
``_orientation_and_desc`` places them (unrotated and rotated), and:

* keys at the image borders, whose windows leave the image and the patch;
* patch origins that the gather clamps (a column block past the last one
  that fits, a row past the image), read where the clamped patch holds
  them;
* a NaN coordinate, which gives NaN samples and a False mask on every side.

Bars: gx and gy within 2e-6 (the 4-tap form and the GEMM form round an FMA
differently), masks equal. The kernel itself is held bit-equal to this twin
on the card (``test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.features import sift as jsift
from bundlefusion_tpu_torch.features import sift as tsift

H, W, LEVELS, FRAMES, KEYS = 48, 96, 3, 2, 40
BAR = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case: str, theta_on: bool):
    """(g_tall [F, Ht, Wp], coords [F, K, 256, 2], x0, y0, row0 [F, K])."""
    rng = np.random.default_rng(11)
    wp = max(-(-(W + tsift._BLK) // tsift._BLK) * tsift._BLK, tsift._PATCH_W)
    ht = LEVELS * H + tsift._PATCH
    q = rng.integers(0, 4096, size=(FRAMES, ht, wp, 2))
    g_tall = (q[..., 0] * 4096.0 + q[..., 1]).astype(np.float32)
    xy = np.stack([rng.uniform(0, W - 1, (FRAMES, KEYS)), rng.uniform(0, H - 1, (FRAMES, KEYS))], -1)
    xy[:, :4] = [[0.2, 3.0], [W - 1.2, 5.5], [7.0, 0.1], [W - 2.0, H - 1.5]]  # border keys
    xy = xy.astype(np.float32)
    sigma = rng.uniform(1.6, 4.0, (FRAMES, KEYS)).astype(np.float32)
    theta = (rng.uniform(-np.pi, np.pi, (FRAMES, KEYS)) if theta_on else np.zeros((FRAMES, KEYS))).astype(np.float32)
    factor = 0.75 if theta_on else 0.4
    coords = tsift._window_coords(torch.as_tensor(xy), torch.as_tensor(sigma), torch.as_tensor(theta), factor).numpy()
    scale = rng.integers(0, LEVELS, (FRAMES, KEYS))
    xi = np.round(xy[..., 0]).astype(np.int64)
    yi = np.round(xy[..., 1]).astype(np.int64)
    x0 = np.clip(xi - tsift._PATCH // 2, 0, max(W - tsift._PATCH, 0)) // tsift._BLK * tsift._BLK
    y0 = np.clip(yi - tsift._PATCH // 2, 0, max(H - tsift._PATCH, 0))
    row0 = scale * H + y0
    if case == "clamped":  # origins the patch gather clamps: past the last column block, past the last row
        x0[:, :6] = wp  # nb - 2 blocks is the last origin that fits
        row0[:, 6:12] = ht - 10
        y0[:, 6:12] = H - 10
    if case == "nan":
        coords[0, 5, 17] = np.nan
        coords[1, 9, 200, 1] = np.nan
    return g_tall, coords.astype(np.float32), x0, y0, row0


def _jax(g_tall, coords, x0, y0, row0):
    out = []
    for f in range(FRAMES):
        px, py = jsift._unpack_grads(jsift._extract_patches(jnp.asarray(g_tall[f]), jnp.asarray(x0[f], jnp.int32),
                                                            jnp.asarray(row0[f], jnp.int32)))
        out.append([np.asarray(x) for x in jsift._gather_grads_patches(
            px, py, jnp.asarray(coords[f]), jnp.asarray(x0[f], jnp.int32), jnp.asarray(y0[f], jnp.int32), H, W)])
    return [np.stack(x) for x in zip(*out)]


def _port_matmul(g_tall, coords, x0, y0, row0):
    t = torch.as_tensor
    px, py = tsift._unpack_grads(tsift._extract_patches(t(g_tall), t(x0), t(row0)))
    return [x.numpy() for x in tsift._gather_grads_patches(px, py, t(coords), t(x0), t(y0), H, W)]


@pytest.mark.parametrize("theta_on", [False, True], ids=["orientation", "descriptor"])
@pytest.mark.parametrize("case", ["keys", "clamped", "nan"])
def test_twin_matches_the_matmul_forms(case, theta_on):
    args = _inputs(case, theta_on)
    t = [torch.as_tensor(a) for a in args]
    gx, gy, mask = (x.numpy() for x in tsift.sample_window(*t, H, W))  # CPU tensors: the twin
    assert tsift.sample_window.launches == 0
    assert mask.dtype == np.bool_ and 0 < mask.sum() < mask.size
    for label, (rx, ry, rm) in (("jax", _jax(*args)), ("port matmul", _port_matmul(*args))):
        np.testing.assert_array_equal(mask, rm, err_msg=label)
        np.testing.assert_allclose(gx, rx, rtol=0, atol=BAR, equal_nan=True, err_msg=label)
        np.testing.assert_allclose(gy, ry, rtol=0, atol=BAR, equal_nan=True, err_msg=label)
    if case == "nan":
        assert np.isnan(gx[0, 5, 17]) and np.isnan(gy[1, 9, 200]) and not mask[0, 5, 17] and not mask[1, 9, 200]
        assert np.isfinite(gx).sum() == gx.size - 2
    if case == "clamped":  # the clamped patches were read: some of their points are in the patch
        assert mask[:, :12].any()
