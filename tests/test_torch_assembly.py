"""The normal-equation assembly (kernel K3, ``solver/system.py::
assemble_system``) on the CPU, where the wrapper runs its twin (the
deterministic ``index_add_`` body):

* the twin against the JAX package's ``assemble_system`` on the same numpy
  blocks (H and b within 1e-5 relative to their largest entry), and the
  pose update a PCG solve takes from each (within 1e-5);
* a plain-Python model of the kernel's algorithm (per row of H, the updates
  in the twin's order, each added to its cell's running sum unless all six
  of its values are +-0) bit-equal to the twin, and to the card's
  small-stride ``index_add_`` for b (each call's run summed from +0.0, then
  added), which the kernel follows; so the kernel's order is held here,
  where the kernel cannot run. The kernel itself is held bit-equal to the
  twin on the card (``test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase
  3).

The blocks are filled as a global graph fills its slots
(``chip_smoke.assembly_inputs``): runs of duplicate pairs, a tenth of the
live slots pruned to weight 0, the empty rest at (0, 0) with blocks of
exact zeros (-0.0 among them), dense-pair slots appended, the gauge row and
an invalid keyframe masked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.solver import system as jsys
from bundlefusion_tpu_torch.solver import system as tsys
from chip_smoke import assembly_inputs

CASES = {
    # n, slots, live keyframes, slots per pair, live share, dense slots, live dense, damping
    "sparse": (10, 480, 8, 40, 0.1, 0, 0, 1e-6),
    "dense_appended": (10, 480, 8, 40, 0.6, 64, 6, 1e-6),
    "partial": (10, 240, 8, 30, 0.5, 0, 0, 0.0),
    "local": (11, 256, 11, 16, 0.9, 55, 50, 1e-6),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case: str, nan: bool = False):
    n, slots, live, per_pair, share, dense, dense_live, damping = CASES[case]
    pa, pb, JtJ, Jtr, free = assembly_inputs(sum(map(ord, case)), n, slots, live, per_pair, share, dense=dense,
                                             dense_live=dense_live, idx64=dense > 0)
    if nan:  # in an empty slot's block (cell (0, 0)) and in a live slot's Jtr
        JtJ[slots - 1, 8, 2] = np.nan
        Jtr[3, 9] = np.nan
    return n, pa, pb, JtJ, Jtr, free, damping


def k3_model(n, pa, pb, JtJ, Jtr, free, damping, b_split: bool):
    """K3's algorithm in numpy float32 with plain loops. For row R = 6i + r:
    the (a,a) updates of every slot with pa = i (row r of the block's top
    left), then (a,b) (top right, into cell pb), (b,a) (row r of the bottom
    left, into cell pa, for pb = i), (b,b) (bottom right), each six values
    added to the cell's running sum from +0.0 unless all are +-0; b[R] sums
    Jtr[:, r] over pa = i and Jtr[:, 6 + r] over pb = i, in one running sum
    or (``b_split``) each from +0.0 and then added. Then the gauge mask, its
    identity diagonal and the damping, rounded as the twin rounds them."""
    f32 = np.float32
    H = np.zeros((6 * n, 6 * n), f32)
    b = np.zeros(6 * n, f32)
    fm = np.repeat(free.astype(f32), 6)
    passes = ((pa, lambda s: pa[s], slice(0, 6), slice(0, 6)), (pa, lambda s: pb[s], slice(0, 6), slice(6, 12)),
              (pb, lambda s: pa[s], slice(6, 12), slice(0, 6)), (pb, lambda s: pb[s], slice(6, 12), slice(6, 12)))
    for i in range(n):
        for r in range(6):
            acc = np.zeros(6 * n, f32)
            for which, target, rows, cols in passes:
                for s in np.flatnonzero(which == i):
                    v = JtJ[s, rows, cols][r]
                    if np.any(v != 0):  # NaN != 0
                        j = target(s)
                        acc[6 * j: 6 * j + 6] += v
            sums = []
            for which, col in ((pa, r), (pb, 6 + r)):
                acc_b = f32(0.0) if b_split or not sums else sums.pop()
                for s in np.flatnonzero(which == i):
                    if Jtr[s, col] != 0:
                        acc_b = f32(acc_b + Jtr[s, col])
                sums.append(acc_b)
            R = 6 * i + r
            h = acc * fm[R] * fm
            eye = np.zeros(6 * n, f32)
            eye[R] = f32(1.0) - fm[R]
            h = h + eye
            damp = np.zeros(6 * n, f32)
            damp[R] = f32(damping) * h[R] + f32(1e-8)
            H[R] = h + damp
            b[R] = -(sums[0] + sums[1] if b_split else sums[0]) * fm[R]
    return H, b


def _bits_equal(got: np.ndarray, want: np.ndarray, what: str) -> None:
    """Equal bit for bit (the sign of zero included), NaN where NaN."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32), err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_twin_matches_jax(case):
    n, pa, pb, JtJ, Jtr, free, damping = _inputs(case)
    Hj, bj = jsys.assemble_system(n, jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(JtJ), jnp.asarray(Jtr),
                                  jnp.asarray(free), damping)
    Ht, bt = tsys.assemble_system(n, *(torch.as_tensor(a) for a in (pa, pb, JtJ, Jtr, free)), damping)
    assert tsys.assemble_system.launches == 0  # CPU tensors: the twin
    Hj, bj = np.asarray(Hj), np.asarray(bj)
    np.testing.assert_allclose(Ht.numpy(), Hj, rtol=0, atol=1e-5 * np.abs(Hj).max())
    np.testing.assert_allclose(bt.numpy(), bj, rtol=0, atol=1e-5 * np.abs(bj).max())
    xj = np.asarray(jsys.pcg_solve(jnp.asarray(Hj), jnp.asarray(bj), 32).x)
    xt = tsys.pcg_solve(Ht, bt, 32).x.numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-5)


@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_order_matches_the_twin(case, nan):
    n, pa, pb, JtJ, Jtr, free, damping = args = _inputs(case, nan)
    Ht, bt = (x.numpy() for x in tsys._assemble_system_torch(n, *(torch.as_tensor(a) for a in args[1:6]), damping))
    assert np.isnan(Ht).any() == nan
    # the CPU's index_add_ adds b's second call to the first's running sum
    Hm, bm = k3_model(*args, b_split=False)
    _bits_equal(Hm, Ht, "H, model against the twin")
    _bits_equal(bm, bt, "b, model against the twin")
    # the card's small-stride index_add_ (b's calls) sums each call's run from
    # +0.0, then adds it: the same split on the CPU
    fm = torch.repeat_interleave(torch.as_tensor(free).float(), 6)
    calls = [torch.zeros((n, 6)).index_add_(0, torch.as_tensor(idx).long(), torch.as_tensor(Jtr[:, cols]))
             for idx, cols in ((pa, slice(0, 6)), (pb, slice(6, 12)))]
    b_card = (-(calls[0] + calls[1]).reshape(-1) * fm).numpy()
    _, bk = k3_model(*args, b_split=True)
    _bits_equal(bk, b_card, "b, model (split) against the small-stride sums")
