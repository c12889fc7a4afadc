"""TSDF fusion: the port's block table and kernel K1's twin against the JAX
package (its XLA path, which is what the JAX package runs on the CPU), on a
table the JAX package pre-integrated and ``interop`` carried across.

Bars: key sets, FuseDiag counters, update masks and weights exactly; sdf and
colour within 1e-5 (``tests/test_pallas.py``). Inputs are the pipeline's:
uint16-mm wire depth and half-resolution uint8 colour.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.config import tiny_test_config as j_tiny
from bundlefusion_tpu.fusion import blocks as jb
from bundlefusion_tpu.fusion import tsdf as jt
from bundlefusion_tpu_torch import interop
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.fusion import blocks as tb
from bundlefusion_tpu_torch.fusion import tsdf as tt
from bundlefusion_tpu_torch.io.framewire import frame_to_wire2
from util import cached_sequence

APP_J = j_tiny().app
APP_T = t_tiny().app
N = 6


@pytest.fixture(scope="module")
def frames():
    """Wire-format frames (depth m from uint16 mm, half-res colour) + poses."""
    seq = cached_sequence(N, width=64, height=48)
    w = [frame_to_wire2(seq.depth[i], seq.color[i], depth_min=0.1, depth_max=4.0) for i in range(N)]
    d16 = np.stack([x[0] for x in w])
    c8 = np.stack([x[2] for x in w])
    return dict(
        cam=seq.camera,
        poses=seq.poses,
        depth=d16.astype(np.float32) * np.float32(1e-3),
        c8=c8,
        colf=c8.astype(np.float32) * np.float32(1.0 / 255.0),
    )


@pytest.fixture(scope="module")
def prefilled(frames):
    """A JAX table with frames 0..2 integrated (numpy leaves)."""
    table = jb.make_table(APP_J.block_capacity)
    f = frames
    table, _ = jt.integrate_batch(
        table, jnp.asarray(f["depth"][:3]), jnp.asarray(f["colf"][:3]), jnp.asarray(f["poses"][:3]),
        jnp.ones(3, bool), f["cam"], APP_J,
    )
    return jax.tree.map(np.asarray, table)


def _port_table(jtable):
    return interop.state_from_numpy(jtable, "cpu")


def _assert_tables(jtab, ttab, atol=1e-5):
    """Index arrays exact. Weights exact except for voxels whose update
    decision flips: XLA:CPU contracts the projection into FMAs, while the
    port's kernel and twin round op by op as the TPU kernel does, so a voxel
    within one ulp of a pixel or truncation edge may land on the other side
    (measured: ~1 voxel in 10^5 of the observed ones, flipping either its
    update or its nearest pixel). At most 4 flipped voxels are allowed;
    everywhere else weights are equal and sdf and colour agree within 1e-5."""
    for k in ("keys", "slot_of", "key_of_slot"):
        np.testing.assert_array_equal(np.asarray(getattr(jtab, k)), getattr(ttab, k).numpy())
    wj, wt = np.asarray(jtab.weight)[:-1], ttab.weight.numpy()[:-1]
    dsdf = np.abs(np.asarray(jtab.sdf)[:-1] - ttab.sdf.numpy()[:-1])
    dcol = np.abs(np.asarray(jtab.color)[:-1] - ttab.color.numpy()[:-1]).reshape(-1, 3, 512).max(axis=1)
    flips = (wj != wt) | (dsdf > atol) | (dcol > atol)
    print(f"flipped voxels: {int(flips.sum())} of {int((wj > 0).sum())} observed "
          f"({int((wj != wt).sum())} with a weight change)")
    assert flips.sum() <= 4


def _row(frames, i, table_j, table_t):
    """Frame i's update row on both sides: (jax slots, mask), (port slots, mask)."""
    f = frames
    d, T = f["depth"][i], f["poses"][i]
    keys_j = jb.dedup_keys(jt.frame_alloc_keys(jnp.asarray(d), jnp.asarray(T), f["cam"], APP_J), APP_J.blocks_per_frame_cap)
    keys_t = tb.dedup_keys(tt.frame_alloc_keys(torch.as_tensor(d), torch.as_tensor(T), f["cam"], APP_T), APP_T.blocks_per_frame_cap)
    np.testing.assert_array_equal(np.asarray(keys_j), keys_t.numpy())
    table_j, ovf_j = jb.allocate(table_j, keys_j, assume_unique_sorted=True)
    table_t, ovf_t = tb.allocate(table_t, keys_t, assume_unique_sorted=True)
    assert int(ovf_j) == int(ovf_t)
    sj, mj = jb.lookup(table_j, keys_j)
    st, mt = tb.lookup(table_t, keys_t)
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    return table_j, table_t, (sj, mj), (st, mt)


def _one_row(frames, i, slots, mask, sign):
    """K1 rows holding frame i's update row alone (its keys are not read on
    the CPU)."""
    pose = torch.as_tensor(frames["poses"][i : i + 1])
    return tt.FuseRows(
        keys=torch.zeros_like(slots)[None], slots=slots[None], masks=mask[None],
        fidx=torch.tensor([i]), params=tt.row_params(pose, torch.full((1,), sign), frames["cam"]),
    )


def test_interop_round_trip(prefilled):
    t = _port_table(prefilled)
    back = interop.state_to_numpy(t)
    for k in ("keys", "slot_of", "key_of_slot", "sdf", "weight", "color"):
        np.testing.assert_array_equal(back[k], np.asarray(getattr(prefilled, k)))


def test_k1_twin_matches_xla(frames, prefilled):
    f = frames
    table_j = jax.tree.map(jnp.asarray, prefilled)
    table_j, table_t, (sj, mj), (st, mt) = _row(f, 3, table_j, _port_table(prefilled))
    ref = jt._integrate_blocks_dispatch(
        sj, mj, table_j, jnp.asarray(f["depth"][3]), jnp.asarray(f["colf"][3]), jnp.asarray(f["poses"][3]),
        f["cam"], APP_J, 1.0,
    )
    rows = _one_row(f, 3, st, mt, 1.0)
    tt.integrate_blocks(table_t, rows, torch.as_tensor(f["depth"]), torch.as_tensor(f["c8"]), APP_T)
    assert int(mt.sum()) > 50
    _assert_tables(ref, table_t)


def test_deintegrate_restores_weights_exactly(frames, prefilled):
    f = frames
    table_j = jax.tree.map(jnp.asarray, prefilled)
    _, table_t, _, (st, mt) = _row(f, 4, table_j, _port_table(prefilled))
    before_w = table_t.weight.clone()
    args = (torch.as_tensor(f["depth"]), torch.as_tensor(f["c8"]))
    tt.integrate_blocks(table_t, _one_row(f, 4, st, mt, 1.0), *args, APP_T)
    assert not torch.equal(table_t.weight, before_w)
    tt.integrate_blocks(table_t, _one_row(f, 4, st, mt, -1.0), *args, APP_T)
    assert torch.equal(table_t.weight[:-1], before_w[:-1])
    fresh = (before_w[:-1] == 0)
    assert float(table_t.sdf[:-1][fresh].abs().max()) < 1e-6


@pytest.mark.parametrize("recorded", [False, True])
def test_deintegrate_matches_jax(frames, prefilled, recorded):
    """Remove integrated frame 1 with ``deintegrate`` on both sides, without
    and with a recorded update mask (every other entry)."""
    f = frames
    cap = APP_J.blocks_per_frame_cap
    mask = (np.arange(cap) % 2 == 0) if recorded else None
    args = (f["cam"],)
    tj = jt.deintegrate(jax.tree.map(jnp.asarray, prefilled), jnp.asarray(f["depth"][1]), jnp.asarray(f["colf"][1]),
                        jnp.asarray(f["poses"][1]), *args, APP_J, None if mask is None else jnp.asarray(mask))
    table_t = _port_table(prefilled)
    before = table_t.weight.clone()
    t_t = tt.deintegrate(table_t, torch.as_tensor(f["depth"][1]), torch.as_tensor(f["c8"][1]),
                         torch.as_tensor(f["poses"][1]), *args, APP_T, None if mask is None else torch.as_tensor(mask))
    assert int((t_t.weight != before).sum()) > 1000
    _assert_tables(tj, t_t)


def test_integrate_then_deintegrate_restores_weights_exactly(frames, prefilled):
    """``integrate`` then ``deintegrate`` with the recorded mask (K1, one
    row each way) leaves every weight as it was."""
    f = frames
    table_t = _port_table(prefilled)
    before = table_t.weight.clone()
    d, c, T = torch.as_tensor(f["depth"][4]), torch.as_tensor(f["c8"][4]), torch.as_tensor(f["poses"][4])
    table_t, diag = tt.integrate(table_t, d, c, T, f["cam"], APP_T)
    assert int(diag.upd_mask.sum()) > 50 and not torch.equal(table_t.weight, before)
    table_t = tt.deintegrate(table_t, d, c, T, f["cam"], APP_T, diag.upd_mask)
    assert torch.equal(table_t.weight[:-1], before[:-1])


def test_visible_blocks_matches_jax(frames, prefilled):
    f = frames
    for i in (0, 3):
        sj, mj = jt.visible_blocks(jax.tree.map(jnp.asarray, prefilled), jnp.asarray(f["poses"][i]), f["cam"], APP_J)
        st, mt = tt.visible_blocks(_port_table(prefilled), torch.as_tensor(f["poses"][i]), f["cam"], APP_T)
        np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
        np.testing.assert_array_equal(np.asarray(sj), st.numpy())
        assert st.dtype == torch.int32 and int(mt.sum()) > 0


def test_fuse_batch_matches_jax(frames, prefilled):
    """De-integrate frames at their old poses, re-integrate at moved poses,
    and integrate new frames, all in one fuse_batch, on both sides."""
    f = frames
    b = 4
    ids = [0, 1, 2, 5]  # three integrated frames + one new
    depth, colf, c8 = f["depth"][ids], f["colf"][ids], f["c8"][ids]
    old = f["poses"][ids]
    new = old.copy()
    new[:, :3, 3] += np.array([0.01, -0.004, 0.006], np.float32)
    deint = np.array([True, True, False, False])
    reint = np.array([True, True, True, True])
    cap = APP_J.blocks_per_frame_cap
    rec = np.ones((b, cap), bool)
    table_j = jax.tree.map(jnp.asarray, prefilled)
    tj, dj = jt.fuse_batch(
        table_j, jnp.asarray(depth), jnp.asarray(colf), jnp.asarray(old), jnp.asarray(new),
        jnp.asarray(deint), jnp.asarray(reint), jnp.asarray(rec), f["cam"], APP_J,
    )
    table_t = _port_table(prefilled)
    t_t, dt = tt.fuse_batch(
        table_t, torch.as_tensor(depth), torch.as_tensor(c8), torch.as_tensor(old), torch.as_tensor(new),
        torch.as_tensor(deint), torch.as_tensor(reint), torch.as_tensor(rec), f["cam"], APP_T,
    )
    for k in ("overflow", "upd_truncated", "patch_overflow"):
        assert int(getattr(dj, k)) == int(getattr(dt, k)), k
    np.testing.assert_array_equal(np.asarray(dj.upd_mask), dt.upd_mask.numpy())
    np.testing.assert_array_equal(np.asarray(dj.upd_keys), dt.upd_keys.numpy())
    assert int(dt.upd_mask.sum()) > 100
    _assert_tables(tj, t_t)


@pytest.fixture(scope="module")
def three_rows(frames, prefilled):
    """K1 rows over the prefilled table: frame 3 integrates, frame 5's row is
    fully masked, frame 4 integrates with every third entry masked. Frames
    3 and 4 share most of their blocks."""
    f = frames
    table = _port_table(prefilled)
    ids = torch.tensor([3, 5, 4])
    depths = torch.as_tensor(f["depth"])
    keys, _ = tt._upd_keys_batch(depths[ids], torch.as_tensor(f["poses"][ids]), torch.ones(3, dtype=torch.bool), f["cam"], APP_T)
    union, _ = tt._union_counted(keys, keys.numel())
    table, _ = tb.allocate(table, union, assume_unique_sorted=True)
    rec = torch.ones_like(keys, dtype=torch.bool)
    rec[2, ::3] = False
    active = torch.tensor([True, False, True])
    rows = tt._fuse_rows(table, keys, rec, active, ids, torch.as_tensor(f["poses"][ids]), torch.ones(3), f["cam"])
    return table, rows


def _kernel_positions(rows, union):
    """K1's rule for an entry's position in each row: a binary search of the
    row's sorted key list; -1 where the key is absent or masked. [U, R]."""
    cap = rows.keys.shape[1]
    pos = []
    for r in range(rows.keys.shape[0]):
        j = torch.clamp(torch.searchsorted(rows.keys[r].contiguous(), union), max=cap - 1)
        hit = (rows.keys[r, j] == union) & rows.masks[r, j]
        pos.append(torch.where(hit, j, -1))
    return torch.stack(pos, dim=1)


def test_fuse_worklist_covers_each_applied_entry_once(three_rows):
    table, rows = three_rows
    union = tt.fuse_worklist(rows, table.capacity)
    n = int((union != tb.INVALID_KEY).sum())
    applied = rows.masks
    r, j = torch.nonzero(applied, as_tuple=True)
    keys = rows.keys[r, j]
    # repeated blocks: the union is smaller than the applied entries
    assert n == len(set(keys.tolist())) < int(applied.sum())
    assert union.shape[0] == min(rows.keys.numel(), table.capacity)
    assert torch.all(union[1:n] > union[: n - 1]) and torch.all(union[n:] == tb.INVALID_KEY)
    # every applied (row, entry) found at its position under exactly one union entry
    pos = _kernel_positions(rows, union[:n])
    u = torch.searchsorted(union[:n], keys)
    assert torch.equal(union[u], keys)
    assert torch.equal(pos[u, r], j)
    # and no unapplied one: the fully masked row and the masked entries are absent
    assert int((pos >= 0).sum()) == int(applied.sum())
    assert torch.all(pos[:, 1] == -1)
    assert int(applied[2].sum()) < int((rows.keys[2] != tb.INVALID_KEY).sum())


def test_k1_multi_row_plain_matches_row_loop(frames, three_rows):
    """One multi-row call equals the row loop (one single-row update per
    row), and so does the kernel's schedule: the row updates driven by the
    work list (each union entry, with the rows that apply it), bit for bit."""
    table, rows = three_rows
    depths, c8 = torch.as_tensor(frames["depth"]), torch.as_tensor(frames["c8"])

    def copy():
        return dataclasses.replace(table, sdf=table.sdf.clone(), weight=table.weight.clone(), color=table.color.clone())

    fused, loop, listed = copy(), copy(), copy()
    tt.integrate_blocks(fused, rows, depths, c8, APP_T)
    union = tt.fuse_worklist(rows, table.capacity)
    pos = _kernel_positions(rows, union)
    union_slots, _ = tb.lookup(table, union)
    for r in range(3):
        f = int(rows.fidx[r])
        tt._integrate_blocks_torch(loop, rows.slots[r], rows.masks[r], depths[f], c8[f], rows.params[r], APP_T)
        tt._integrate_blocks_torch(listed, union_slots, pos[:, r] >= 0, depths[f], c8[f], rows.params[r], APP_T)
    assert not torch.equal(fused.weight, table.weight)
    for t in (loop, listed):
        for k in ("sdf", "weight", "color"):
            assert torch.equal(getattr(fused, k), getattr(t, k)), k


def test_allocate_lookup_gc_match_jax():
    rng = np.random.default_rng(7)
    coords = rng.integers(-40, 40, size=(3, 300, 3)).astype(np.int32)
    tj = jb.make_table(512)
    ttab = tb.make_table(512, "cpu")
    for k in range(3):  # the third round overflows the 512-slot pool
        kj = jb.pack_key(jnp.asarray(coords[k]))
        kt = tb.pack_key(torch.as_tensor(coords[k]))
        np.testing.assert_array_equal(np.asarray(kj), kt.numpy())
        tj, oj = jb.allocate(tj, kj)
        ttab, ot = tb.allocate(ttab, kt)
        assert int(oj) == int(ot)
        np.testing.assert_array_equal(np.asarray(tj.keys), ttab.keys.numpy())
        np.testing.assert_array_equal(np.asarray(tj.slot_of), ttab.slot_of.numpy())
        np.testing.assert_array_equal(np.asarray(tj.key_of_slot), ttab.key_of_slot.numpy())
    q = rng.integers(-45, 45, size=(400, 3)).astype(np.int32)
    sj, fj = jb.lookup(tj, jb.pack_key(jnp.asarray(q)))
    st, ft = tb.lookup(ttab, tb.pack_key(torch.as_tensor(q)))
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())
    # observe half of the live slots, then collect the rest
    w = np.zeros((513, 512), np.float32)
    w[rng.choice(512, 256, replace=False), 0] = 1.0
    tj = tj._replace(weight=jnp.asarray(w))
    ttab = dataclasses.replace(ttab, weight=torch.as_tensor(w))
    gj, nj = jb.garbage_collect(tj)
    gt, nt = tb.garbage_collect(ttab)
    assert int(nj) == int(nt) > 0
    for k in ("keys", "slot_of", "key_of_slot"):
        np.testing.assert_array_equal(np.asarray(getattr(gj, k)), getattr(gt, k).numpy())


def test_patch_overflow_count_matches_jax(frames):
    f = frames
    keys = jb.dedup_keys(
        jt.frame_alloc_keys(jnp.asarray(f["depth"][0]), jnp.asarray(f["poses"][0]), f["cam"], APP_J),
        APP_J.blocks_per_frame_cap,
    )
    mask = keys != jb.INVALID_KEY
    want = int(jt.patch_overflow_count(keys, mask, jnp.asarray(f["poses"][0]), f["cam"], APP_J))

    def port(window):
        return int(tt.patch_overflow_count(
            torch.as_tensor(np.asarray(keys)), torch.as_tensor(np.asarray(mask)),
            torch.as_tensor(f["poses"][0]), f["cam"], APP_T, window,
        ))

    # the JAX package's XLA window (128 px) covers a 64x48 frame: nothing overflows
    assert port((128, 128)) == want == 0
    assert port((4, 4)) > 0  # a window smaller than a block's footprint does
