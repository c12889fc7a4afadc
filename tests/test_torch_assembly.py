"""The normal-equation assembly (kernel K3, ``solver/system.py::
assemble_system``) on the CPU, where the wrapper runs its twin (the
deterministic ``index_add_`` body):

* the twin against the JAX package's ``assemble_system`` on the same numpy
  blocks (H and b within 1e-5 relative to their largest entry), and the
  pose update a PCG solve takes from each (within 1e-5);
* a plain-Python model of the kernel's two passes (``k3_model``: live
  sides and flags, then per keyframe a sweep over its pa side and one over
  its pb side, each feeding block (i, i) and the cross blocks, with the
  self pairs' cross halves between them, flushed in stages) bit-equal
  to the twin, and to the card's small-stride ``index_add_`` for b (each
  call's run summed from +0.0, then added), which the kernel follows; also
  with other sub-tile, step, list, stage and row-group sizes, and at the
  edge cases of
  ``chip_smoke.assembly_edge_inputs`` (every slot empty, one keyframe in
  every slot, a gauge row's signed zeros, -0.0 blocks, out-of-range
  indices, a NaN in an empty slot). So the kernel's order is held here,
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
from chip_smoke import K3_EDGE_CASES, assembly_edge_inputs, assembly_inputs

CASES = {
    # n, slots, live keyframes, slots per pair, live share, dense slots, live dense, damping
    "sparse": (10, 480, 8, 40, 0.1, 0, 0, 1e-6),
    "dense_appended": (10, 480, 8, 40, 0.6, 64, 6, 1e-6),
    "partial": (10, 240, 8, 30, 0.5, 0, 0, 0.0),
    "local": (11, 256, 11, 16, 0.9, 55, 50, 1e-6),
    # the live pairs interleaved as a global graph's compaction leaves them
    "interleaved": (10, 480, 8, 20, 0.6, 0, 0, 1e-6),
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
                                             dense_live=dense_live, idx64=dense > 0, interleave=case == "interleaved")
    if nan:  # in an empty slot's block (cell (0, 0)) and in a live slot's Jtr
        JtJ[slots - 1, 8, 2] = np.nan
        Jtr[3, 9] = np.nan
    return n, pa, pb, JtJ, Jtr, free, damping


# csrc/assemble.cu's constants: slots per flag byte, per compaction step;
# items per list, per stage
K3_SUB, K3_STEP, K3_LIST, K3_STAGE = 64, 1024, 1024, 512
LIVE, NONE = 1 << 31, (1 << 31) - 1
FLAG_A, FLAG_B, FLAG_SELF = 1, 2, 4


def k3_model(n, pa, pb, JtJ, Jtr, free, damping, b_split: bool, sub=K3_SUB, step=K3_STEP, lst=K3_LIST,
             stage=K3_STAGE, rows=6):
    """K3's two passes in numpy float32 with plain loops.

    Pass 1: each slot's pa side (rows 0-5 of its block, Jtr[:6]) and pb
    side (rows 6-11, Jtr[6:]) is live if a value is not +-0; its record
    holds each index (NONE outside [0, n)) with its side's LIVE bit, and
    each (keyframe, sub-tile of ``sub`` slots) flags: a live pa side there,
    a live pb side, a self pair (pa = pb) with a live side.

    Pass 2, per keyframe i and group of ``rows`` rows from r0: sweep 0 over
    the steps of ``step`` slots whose flags say pa or pb side, compacting
    the slots with a live pa side at i in slot order and flushing them
    whenever the next step's would overflow a list of ``lst``, ``stage`` at
    a time: the left half of their rows into block (i, i) item by item, a
    warp per group of rows; the right half into block (i, pb) (pb not i, in
    range), each (pb, group) by one of the other warps, which lists the
    stage's items of that pb in order; and b's pa-side sums;
    on the same walk it keeps sweep 3's items in a second list while they
    fit. Where a self pair is flagged, sweep 1 adds the self pairs' (a,b)
    halves (pa side live) and sweep 2 their (b,a) halves (pb side live)
    into (i, i). Then sweep 3's kept items are flushed and sweep 3 resumes
    where they stopped, mirroring sweep 0 for the pb side: (b,b) into
    (i, i), (b,a) into (i, pa), b's pb-side sums from +0.0 (b = S(pa) +
    S(pb)), or (``b_split`` False) continuing the pa side's sum. Then the
    gauge mask, its identity diagonal and the damping, rounded as the twin
    rounds them."""
    f32 = np.float32
    P = len(pa)
    steps = -(-P // step)
    live = [(JtJ[:, 6 * k:6 * k + 6] != 0).any((1, 2)) | (Jtr[:, 6 * k:6 * k + 6] != 0).any(1) for k in (0, 1)]
    ok = [(x >= 0) & (x < n) for x in (pa, pb)]
    rec = [np.where(ok[k], idx, NONE).astype(np.int64) | np.where(live[k], LIVE, 0) for k, idx in ((0, pa), (1, pb))]
    flags = np.zeros((n, steps * step // sub), np.int64)
    for s in range(P):
        if live[0][s] and ok[0][s]:
            flags[pa[s], s // sub] |= FLAG_A
        if live[1][s] and ok[1][s]:
            flags[pb[s], s // sub] |= FLAG_B
        if (live[0][s] or live[1][s]) and ok[0][s] and pa[s] == pb[s]:
            flags[pa[s], s // sub] |= FLAG_SELF
    step_flags = np.bitwise_or.reduce(flags.reshape(n, steps, step // sub), axis=2) if steps else flags

    H = np.zeros((6 * n, 6 * n), f32)
    b = np.zeros(6 * n, f32)
    fm = np.repeat(free.astype(f32), 6)
    groups = 2 if rows > 3 else 1  # a warp's group of a block's rows
    per = rows // groups

    def item(p, s, i):
        """Sweep p's item of slot s for keyframe i: None, or its cross target
        (-1: none, or a self pair's, which sweeps 1 and 2 take)."""
        side = 0 if p < 2 else 1
        mine, other = rec[side][s], rec[1 - side][s] & ~LIVE
        if mine != i | LIVE:
            return None
        if p in (0, 3):
            return int(other) if other not in (NONE, i) else -1
        return i if other == i else None

    for i in range(n):
        self_pairs = bool((step_flags[i] & FLAG_SELF).any())
        for r0 in range(0, 6, rows):
            acc = np.zeros((n, rows, 6), f32)
            bacc = np.zeros((2, rows), f32)

            def flush(p, items):
                side, both = p >> 1, p in (0, 3)
                row0 = 6 * side + r0
                cd = 0 if p in (0, 2) else 6
                cx = 6 - cd
                for k0 in range(0, len(items), stage):
                    chunk = items[k0:k0 + stage]
                    vals = [JtJ[s, row0:row0 + rows, :] for s, _ in chunk]
                    for g in range(groups):  # block (i, i): a warp per group of rows, every item in order
                        rg = slice(g * per, (g + 1) * per)
                        for v in vals:
                            acc[i, rg] = acc[i, rg] + v[rg, cd:cd + 6]
                    if not both:
                        continue
                    # a cross block's warp lists the stage's items of its target in order
                    for j in sorted({x for _, x in chunk if x >= 0}):
                        mine = [k for k, (_, x) in enumerate(chunk) if x == j]
                        for g in range(groups):
                            rg = slice(g * per, (g + 1) * per)
                            for k in mine:
                                acc[j, rg] = acc[j, rg] + vals[k][rg, cx:cx + 6]
                    for s, _ in chunk:
                        bacc[side] = bacc[side] + Jtr[s, row0:row0 + rows]

            def sweep(p, start=0):
                """Sweep p from step ``start``; sweep 0 also keeps sweep 3's
                items while its list has room, and returns them and the
                step where sweep 3 resumes."""
                bit = {0: FLAG_A | FLAG_B, 3: FLAG_B}.get(p, FLAG_SELF)
                items, kept, b_from = [], [], steps
                for t in range(start, steps):
                    if not step_flags[i, t] & bit:
                        continue
                    slots = range(t * step, min(P, (t + 1) * step))
                    hits = [(s, x) for s in slots if (x := item(p, s, i)) is not None]
                    b_hits = [(s, x) for s in slots if (x := item(3, s, i)) is not None] if p == 0 else []
                    if len(items) + len(hits) > lst:
                        flush(p, items)
                        items = []
                    if p == 0 and b_from == steps and len(kept) + len(b_hits) > lst:
                        b_from = t
                    items += hits
                    if p == 0 and b_from == steps:
                        kept += b_hits
                if items:
                    flush(p, items)
                return kept, b_from

            kept, b_from = sweep(0)
            if not b_split:  # the CPU twin's b: the pb side continues the pa side's sum
                bacc[1] = bacc[0]
            if self_pairs:
                sweep(1)
                sweep(2)
            if kept:
                flush(3, kept)
            if b_from < steps:
                sweep(3, b_from)
            for rr in range(rows):
                R = 6 * i + r0 + rr
                h = acc[:, rr, :].reshape(-1) * fm[R] * fm
                eye = np.zeros(6 * n, f32)
                eye[R] = f32(1.0) - fm[R]
                h = h + eye
                damp = np.zeros(6 * n, f32)
                damp[R] = f32(damping) * h[R] + f32(1e-8)
                H[R] = h + damp
                bv = bacc[0, rr] + bacc[1, rr] if b_split else bacc[1, rr]
                b[R] = -bv * fm[R]
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
    _, bk = k3_model(*args, b_split=True)
    _bits_equal(bk, _card_b(n, pa, pb, Jtr, free), "b, model (split) against the small-stride sums")


def _card_b(n, pa, pb, Jtr, free):
    """b as the card's twin sums it: each small-stride index_add_ call's run
    from +0.0, then added."""
    fm = torch.repeat_interleave(torch.as_tensor(free).float(), 6)
    calls = [torch.zeros((n, 6)).index_add_(0, torch.as_tensor(idx).long(), torch.as_tensor(Jtr[:, cols]))
             for idx, cols in ((pa, slice(0, 6)), (pb, slice(6, 12)))]
    return (-(calls[0] + calls[1]).reshape(-1) * fm).numpy()


@pytest.mark.parametrize("idx64", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("case", K3_EDGE_CASES)
def test_kernel_order_edge_cases(case, idx64):
    """The model on each edge case against the twin on the twin's inputs
    (out-of-range indices moved to keyframe 0 with that end's values
    zeroed: what the kernel drops)."""
    (pa, pb, JtJ, Jtr, free), ref = assembly_edge_inputs(case, idx64)
    n = free.shape[0]
    Ht, bt = (x.numpy() for x in tsys._assemble_system_torch(n, *(torch.as_tensor(a) for a in ref), 1e-6))
    Hm, bm = k3_model(n, pa, pb, JtJ, Jtr, free, 1e-6, b_split=False)
    _bits_equal(Hm, Ht, f"{case}: H, model against the twin")
    _bits_equal(bm, bt, f"{case}: b, model against the twin")
    _, bk = k3_model(n, pa, pb, JtJ, Jtr, free, 1e-6, b_split=True)
    _bits_equal(bk, _card_b(n, *ref[:2], ref[3], ref[4]), f"{case}: b, model (split) against the small-stride sums")
    if case == "gauge_negative":  # keyframe 0 is the gauge: its b entries are -0.0
        assert not free[0] and np.signbit(bt[:6]).all() and (bt[:6] == 0).all()
    if case == "nan_empty_slot":
        assert np.isnan(Ht[:6, :6]).any() and not np.isnan(Ht[6:]).any()


@pytest.mark.parametrize("tiling", [(4, 16, 20, 5, 3), (8, 32, 40, 24, 2), (2, 8, 9, 7, 1), (4, 16, 16, 9, 6)],
                         ids=lambda t: "sub%d-step%d-list%d-stage%d-rows%d" % t)
@pytest.mark.parametrize("case", ["dense_appended", "local"])
def test_kernel_order_any_tiling(case, tiling):
    """The order does not depend on the sub-tile, the step, the list, the
    stage or the row group: small ones (many steps per keyframe, many
    flushes and stages per sweep, two to six CTAs per keyframe) give the
    twin's bits too."""
    sub, step, lst, stage, rows = tiling
    n, pa, pb, JtJ, Jtr, free, damping = args = _inputs(case, nan=False)
    Ht, _ = (x.numpy() for x in tsys._assemble_system_torch(n, *(torch.as_tensor(a) for a in args[1:6]), damping))
    Hm, bm = k3_model(*args, b_split=True, sub=sub, step=step, lst=lst, stage=stage, rows=rows)
    _bits_equal(Hm, Ht, "H, model against the twin")
    _bits_equal(bm, _card_b(n, pa, pb, Jtr, free), "b, model (split) against the small-stride sums")
