"""K6's twin (``solver/residuals.py::_dense_pair_blocks_torch``, the dense
pair term on CPU tensors) against the einsum form it replaced
(``chip_smoke.einsum_dense_pair_blocks``), and its summing order against a
plain-Python model of the kernel's threads.

Scenes: ``reference``, the six keyframes of
``tests/test_torch_dense_reference.py`` (40x30 caches of the room orbit at
poses moved by ~0.6 degrees and 1 cm) with its eight pairs, one of them not
live; ``solver``, the three frames of ``tests/test_torch_solver.py``'s dense
case (128x96, the tiny configuration's 32x24 cache) with all three pairs
live and frames 1-2 shifted by ~1.5 cm; and K6's edge cases
(``chip_smoke.pair_edge_inputs``, 32x24).

Tolerances, per live pair, against the einsum form:

* the depth and colour association counts equal: the two forms round the
  tests' operands differently, so a pixel within float32 rounding of a
  threshold could flip; none does here;
* JtJ within 2e-6 relative Frobenius error (measured: <= 2.3e-7): float32
  sums of ~1,000 per-pixel products in another order, and b's half of each
  row as a's negated where the einsum form computes it;
* Jtr within 1e-4 (measured: <= 6.1e-6): its signed terms cancel, so its
  relative error exceeds JtJ's;
* squared-residual sums within 2e-5 relative (measured: <= 3.1e-6).

In ``nan_coords`` the einsum form's blocks are NaN: it multiplies the NaN
Jacobian of every pixel it does not associate by a zero weight. K6 and its
twin leave such pixels out; their counts are compared there.
"""

import numpy as np
import pytest
import torch

from bundlefusion_tpu_torch.config import BundlingConfig, tiny_test_config
from bundlefusion_tpu_torch.geometry import se3
from bundlefusion_tpu_torch.geometry.camera import CameraModel
from bundlefusion_tpu_torch.io.synthetic import _camera, generate_sequence, orbit_poses, render_sequence
from bundlefusion_tpu_torch.ops.preprocess import FrameCache, preprocess_frames
from bundlefusion_tpu_torch.solver import residuals
from chip_smoke import K6_EDGE_CASES, einsum_dense_pair_blocks, pair_edge_inputs

JTJ_TOL, JTR_TOL, SQ_TOL = 2e-6, 1e-4, 2e-5
REF_CFG = BundlingConfig(cache_width=40, cache_height=30, verify_width=40, verify_height=30)
TINY = tiny_test_config().bundling


def _one_thread(fn):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(n)


def _reference_scene():
    truth = orbit_poses(18, seed=1)[::3].astype(np.float32)
    cam = _camera(80, 60)
    seq = render_sequence(truth, cam, "cpu")
    ccam = cam.scaled(40, 30)
    _, cache = preprocess_frames(torch.as_tensor(seq.depth), torch.as_tensor(seq.color), cam, ccam)
    rng = np.random.default_rng(7)
    poses = torch.as_tensor(truth).clone()
    for k in range(1, len(poses)):
        xi = np.concatenate([rng.normal(scale=0.006, size=3), rng.normal(scale=0.006, size=3)])
        poses[k] = se3.se3_exp(torch.as_tensor(xi, dtype=torch.float32)) @ poses[k]
    pa = torch.tensor([0, 0, 1, 1, 2, 3, 4, 0], dtype=torch.int32)
    pb = torch.tensor([1, 2, 2, 3, 3, 4, 5, 5], dtype=torch.int32)
    live = torch.ones(8, dtype=torch.bool)
    live[3] = False
    return (poses, pa, pb, live, cache, ccam, REF_CFG)


def _solver_scene():
    seq = generate_sequence(3, width=128, height=96, device="cpu")
    ccam = seq.camera.scaled(TINY.cache_width, TINY.cache_height)
    _, cache = preprocess_frames(torch.as_tensor(seq.depth), torch.as_tensor(seq.color), seq.camera, ccam)
    rel = torch.as_tensor((np.linalg.inv(seq.poses[0]) @ seq.poses).astype(np.float32))
    rel[1:, :3, 3] += torch.tensor([0.01, -0.01, 0.005])
    pa, pb = torch.triu_indices(3, 3, offset=1)
    return (rel, pa, pb, torch.ones(3, dtype=torch.bool), cache, ccam, TINY)


def _edge_scene(case):
    P, pa, pb, on, fields, cam = pair_edge_inputs(case)
    return (*(torch.as_tensor(x) for x in (P, pa, pb, on)), FrameCache(*(torch.as_tensor(x) for x in fields)),
            CameraModel(*cam), TINY)


@pytest.fixture(scope="module")
def scenes():
    return {"reference": _one_thread(_reference_scene), "solver": _one_thread(_solver_scene)}


def _rel(got, want):
    d = (got.double() - want.double()).reshape(got.shape[0], -1).norm(dim=-1)
    r = want.double().reshape(want.shape[0], -1).norm(dim=-1)
    return torch.where(r > 0, d / torch.where(r > 0, r, 1.0), d)


@pytest.mark.parametrize("scene", ["reference", "solver", *(f"edge_{c}" for c in K6_EDGE_CASES)])
@pytest.mark.parametrize("weights", [(0.5, 0.1), (1.0 / 3.0, 0.1 / 3.0)], ids=["full", "ramp_first"])
def test_twin_matches_einsum_form(scenes, scene, weights):
    args = scenes[scene] if scene in scenes else _edge_scene(scene.removeprefix("edge_"))
    P, pa, pb, on, cache, cam, cfg = args
    got = residuals.dense_pair_blocks(P, pa, pb, on, cache, cam, cfg, *weights)
    want = einsum_dense_pair_blocks(P, pa, pb, on, cache, cam, cfg, *weights)
    JtJ, Jtr, st = got
    assert torch.equal(st.num_valid_depth, want[2].num_valid_depth)
    assert torch.equal(st.num_valid_color, want[2].num_valid_color)
    off = ~on
    assert not (JtJ[off].any() or Jtr[off].any() or st.num_valid_depth[off].any() or st.sum_sq_depth[off].any())
    assert torch.isfinite(JtJ).all() and torch.isfinite(Jtr).all()
    # b's half of each row is a's negated, so the blocks are [[H, -H], [-H, H]] and [g, -g]
    assert torch.equal(JtJ[:, :6, 6:], -JtJ[:, :6, :6]) and torch.equal(JtJ[:, 6:, 6:], JtJ[:, :6, :6])
    assert torch.equal(JtJ, JtJ.transpose(1, 2)) and torch.equal(Jtr[:, 6:], -Jtr[:, :6])
    if scene == "edge_nan_coords":
        assert torch.isnan(want[0][on]).any()
        return
    errs = [float(_rel(x[on], y[on]).max()) if on.any() else 0.0 for x, y in zip(
        (JtJ, Jtr, st.sum_sq_depth[:, None], st.sum_sq_color[:, None]),
        (want[0], want[1], want[2].sum_sq_depth[:, None], want[2].sum_sq_color[:, None]))]
    print(scene, weights, "max over the live pairs: JtJ, Jtr, squared sums", errs)
    assert errs[0] <= JTJ_TOL and errs[1] <= JTR_TOL and max(errs[2:]) <= SQ_TOL, errs
    if scene in ("reference", "solver"):
        assert int(st.num_valid_color[on].min()) > 100


def _kernel_model(T: np.ndarray, splits: int, rows: int, threads: int) -> np.ndarray:
    """csrc/dense_pairs.cu's summing order, thread by thread in float32:
    each thread's running sums over its rows, ``__shfl_down_sync`` (every
    lane adds the value ``off`` lanes up, all at once), one thread per sum
    halving the warps' sums, then the finishing kernel's sum of the splits
    from +0.0."""
    p, m, e = T.shape
    warps = threads // 32
    out = np.zeros((p, e), np.float32)
    for i in range(p):
        for s in range(splits):
            acc = np.zeros((threads, e), np.float32)
            for t in range(threads):
                for r in range(rows):
                    px = (s * rows + r) * threads + t
                    if px >= m:
                        break
                    acc[t] = acc[t] + T[i, px]
            sums = np.zeros((warps, e), np.float32)
            for wp in range(warps):
                lanes = acc[32 * wp: 32 * wp + 32].copy()
                off = 16
                while off:
                    up = np.concatenate([lanes[off:], lanes[32 - off:]])  # lanes past 31 read their own
                    lanes = lanes + up
                    off //= 2
                sums[wp] = lanes[0]
            off = warps // 2
            while off:
                sums[:off] = sums[:off] + sums[off:2 * off]
                off //= 2
            out[i] = out[i] + sums[0]
    return out


@pytest.mark.parametrize("pixels", [700, 4800], ids=["700px", "4800px"])
def test_k6_sum_follows_the_kernel_order(pixels):
    """The twin's vectorised sum (``_k6_sum``) against the model of the
    kernel's threads, bit for bit, on terms of mixed signs and magnitudes
    with zeros where a pixel does not associate."""
    rng = np.random.default_rng(pixels)
    shape = (2, pixels, residuals._K6_SUMS)
    T = np.where(rng.random(shape) < 0.3, 0.0,
                 rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 4, shape)).astype(np.float32)
    splits, rows = residuals._k6_grid(2, pixels)
    assert splits * rows * residuals._K6_THREADS >= pixels > (splits * rows - rows) * residuals._K6_THREADS
    got = residuals._k6_sum(torch.as_tensor(T), splits, rows).numpy()
    want = _kernel_model(T, splits, rows, residuals._K6_THREADS)
    np.testing.assert_array_equal(got, want)
