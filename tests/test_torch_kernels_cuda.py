"""The CUDA kernels against their plain PyTorch twins, on the card, and the
CUDA graphs' output storage.

These tests need an NVIDIA card and skip elsewhere. They import neither JAX
nor the JAX package, so they run on a machine without JAX (from the repo
root, whose ``chip_smoke.py`` makes the K3-K7 inputs):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from bundlefusion_tpu_torch.bench import bench_config
from bundlefusion_tpu_torch.config import tiny_test_config
from bundlefusion_tpu_torch.features import filters, sift
from bundlefusion_tpu_torch.fusion import blocks, tsdf
from bundlefusion_tpu_torch.geometry import se3
from bundlefusion_tpu_torch.geometry.camera import CameraModel
from bundlefusion_tpu_torch.io.framewire import frame_to_wire2
from bundlefusion_tpu_torch.io.synthetic import generate_sequence
from bundlefusion_tpu_torch.ops import preprocess as pp
from bundlefusion_tpu_torch.solver import residuals, system
from bundlefusion_tpu_torch.utils import graphs, timeline
from chip_smoke import (K3_EDGE_CASES, K5_EDGE_CASES, K6_EDGE_CASES, K7_CASES, K7_EDGE_CASES, assembly_edge_inputs,
                        assembly_inputs, dense_outputs, k5_cases, k6_cases, pair_edge_inputs, pcg_against,
                        pcg_edge_inputs, pcg_inputs, pcg_within, program_outputs_survive, sift_inputs,
                        verify_edge_inputs)

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


def _fuse(dev, frames):
    """A table holding frames 0..2, and the rows of a fuse_batch over frames
    0..4 that de-integrates 0..2 and re-integrates all five at moved poses
    (R = 10 rows, two of them fully masked; most blocks in several rows)."""
    cam, depth, c8, poses = frames
    table = blocks.make_table(APP.block_capacity, dev)
    ones = torch.ones(5, dtype=torch.bool, device=dev)
    table, diag = tsdf.integrate_batch(table, depth[:3], c8[:3], poses[:3], ones[:3], cam, APP)
    moved = poses.clone()
    moved[:, :3, 3] += torch.tensor([0.01, -0.004, 0.006], device=dev)
    rec = torch.zeros((5, APP.blocks_per_frame_cap), dtype=torch.bool, device=dev)
    rec[:3] = diag.upd_mask
    keys = torch.full_like(rec, blocks.INVALID_KEY, dtype=torch.int32)
    keys[:3] = diag.upd_keys
    table, rows, _ = tsdf.fuse_batch_rows(
        table, depth, poses, moved, ones & (torch.arange(5, device=dev) < 3), ones, rec, cam, APP,
        upd_keys_rec=keys,
    )
    return table, rows


def _copy(t):
    return dataclasses.replace(t, sdf=t.sdf.clone(), weight=t.weight.clone(), color=t.color.clone())


def test_k1_kernel_matches_twin(dev, frames):
    _, depth, c8, _ = frames
    table, rows = _fuse(dev, frames)
    assert rows.fidx.shape[0] == 10
    tk, tt = _copy(table), _copy(table)
    launches = tsdf.integrate_blocks.launches
    tsdf.integrate_blocks(tk, rows, depth, c8, APP)
    tsdf._integrate_rows_torch(tt, rows, depth, c8, APP)
    torch.cuda.synchronize()
    assert tsdf.integrate_blocks.launches == launches + 1
    assert torch.equal(tk.weight[:-1], tt.weight[:-1])
    assert torch.equal(tk.sdf[:-1], tt.sdf[:-1])
    assert torch.equal(tk.color[:-1], tt.color[:-1])
    assert not torch.equal(tk.weight, table.weight)


def test_k1_deintegrate_restores_weights(dev, frames):
    _, depth, c8, _ = frames
    table, rows = _fuse(dev, frames)
    before = table.weight.clone()
    tsdf.integrate_blocks(table, rows, depth, c8, APP)
    assert not torch.equal(table.weight, before)
    tsdf.integrate_blocks(table, rows.inverse(), depth, c8, APP)
    assert torch.equal(table.weight, before)


@pytest.fixture(scope="module")
def depths(dev, frames):
    """The synthetic 64x48 frames, and random 70x45 frames with holes: the
    K2 tiles are 32x16 (30x14 with geometry), so 70x45 leaves ragged tiles."""
    rng = np.random.default_rng(0)
    d = rng.uniform(0.5, 3.0, size=(3, 45, 70)).astype(np.float32)
    d[rng.random(d.shape) < 0.1] = 0.0
    return {"synthetic": frames[1], "ragged": torch.as_tensor(d, device=dev)}


@pytest.mark.parametrize("geometry", [True, False])
@pytest.mark.parametrize("radius", [3, 0])
@pytest.mark.parametrize("which", ["synthetic", "ragged"])
def test_k2_kernel_matches_twin(dev, frames, depths, which, radius, geometry):
    cam = frames[0]
    depth = depths[which]
    launches = pp.fused_preprocess.launches
    got = pp.fused_preprocess(depth, cam, radius=radius, geometry=geometry)
    want = pp._preprocess_chain_torch(depth, cam, 2.0, 0.1, radius, geometry)
    torch.cuda.synchronize()
    assert pp.fused_preprocess.launches == launches + 1
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert (g is None and w is None) if not geometry else torch.equal(g, w)


# K3 at a small shape and at the flagship's: the global solve (n = 128,
# 16,384 slots; with the 4,096 dense-pair slots), the local solve (n = 11,
# 1,024 slots + 55 dense pairs), a sharded partial (damping 0), the global
# solve's pairs interleaved as the graph's compaction leaves them; shapes
# that a shared-memory flag per slot could not launch (262,144 slots; the
# default configuration's 512 keyframes, whose sums take half a block row
# per CTA); and 2,048 keyframes (a third of a block row per CTA)
K3_CASES = {
    "small": (lambda: assembly_inputs(10, 8, 300, 6, 40, 0.6), 1e-6),
    "global": (lambda: assembly_inputs(11, 128, 16384, 60, 400, 0.7), 1e-6),
    "global_dense": (lambda: assembly_inputs(12, 128, 16384, 60, 400, 0.7, dense=4096, dense_live=21, idx64=True),
                     1e-6),
    "local": (lambda: assembly_inputs(13, 11, 1024, 11, 60, 0.9, dense=55, dense_live=50, idx64=True), 1e-6),
    "partial": (lambda: assembly_inputs(14, 128, 8192, 60, 400, 0.7), 0.0),
    "interleaved": (lambda: assembly_inputs(16, 128, 16384, 7, 64, 0.08, interleave=True), 1e-6),
    "slots_262144": (lambda: assembly_inputs(7, 128, 262144, 60, 400, 0.7), 1e-6),
    "n512": (lambda: assembly_inputs(8, 512, 16384, 500, 40, 0.7, dense=4096, dense_live=21, idx64=True), 1e-6),
    "n2048": (lambda: assembly_inputs(9, 2048, 16384, 2000, 16, 0.7), 1e-6),
}


def _k3_args(dev, case):
    make, damping = K3_CASES[case]
    pa, pb, JtJ, Jtr, free = (torch.as_tensor(a, device=dev) for a in make())
    return (free.shape[0], pa, pb, JtJ, Jtr, free, damping)


@pytest.mark.parametrize("case", list(K3_CASES))
def test_k3_kernel_matches_twin(dev, case):
    args = _k3_args(dev, case)
    launches = system.assemble_system.launches
    H, b = system.assemble_system(*args)
    Ht, bt = system._assemble_system_torch(*args)
    torch.cuda.synchronize()
    assert system.assemble_system.launches == launches + 1
    assert torch.equal(H, Ht) and torch.equal(b, bt)
    assert torch.equal(torch.signbit(H), torch.signbit(Ht)) and torch.equal(torch.signbit(b), torch.signbit(bt))


@pytest.mark.parametrize("idx64", [False, True], ids=["int32", "int64"])
@pytest.mark.parametrize("case", K3_EDGE_CASES)
def test_k3_edge_cases(dev, case, idx64):
    """Every slot empty, one keyframe in every slot, a gauge row's signed
    zeros, -0.0 blocks, out-of-range indices (dropped: the twin runs on
    them moved to keyframe 0 with that end's values zeroed), a NaN in an
    empty slot: bit for bit, NaN where NaN."""
    arrays, ref = assembly_edge_inputs(case, idx64)
    n = arrays[4].shape[0]
    H, b = system.assemble_system(n, *(torch.as_tensor(a, device=dev) for a in arrays), 1e-6)
    Ht, bt = system._assemble_system_torch(n, *(torch.as_tensor(a, device=dev) for a in ref), 1e-6)
    for got, want in ((H, Ht), (b, bt)):
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))
    if case == "gauge_negative":
        assert bool(torch.signbit(b[:6]).all()) and bool((b[:6] == 0).all())


def test_k3_propagates_nan(dev):
    """A NaN in an empty slot's block (cell (0, 0)) and in a live slot's Jtr
    reaches H and b as in the twin."""
    pa, pb, JtJ, Jtr, free = assembly_inputs(15, 8, 300, 6, 40, 0.6)
    JtJ[-1, 2, 3] = np.nan
    Jtr[5, 7] = np.nan
    args = (8, *(torch.as_tensor(a, device=dev) for a in (pa, pb, JtJ, Jtr, free)), 1e-6)
    H, b = system.assemble_system(*args)
    Ht, bt = system._assemble_system_torch(*args)
    assert torch.isnan(H).any() and torch.isnan(b).any()
    np.testing.assert_array_equal(H.cpu().numpy(), Ht.cpu().numpy())
    np.testing.assert_array_equal(b.cpu().numpy(), bt.cpu().numpy())


def test_k3_replays_in_a_graph(dev):
    """Captured in a CUDA graph (static shapes, no host sync), K3 replays
    twice to the twin's result, and each replay counts one launch."""
    args = _k3_args(dev, "global")
    Ht, bt = system._assemble_system_torch(*args)
    exe = graphs.Executable(dev, None)
    prog = exe.program("assemble", system.assemble_system)
    exe.stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(exe.stream):
        H, b = prog(*args)  # eager, then captured
        launches = system.assemble_system.launches
        for _ in range(2):
            H.zero_()
            prog(*args)
            torch.cuda.current_stream().synchronize()
            assert torch.equal(H, Ht) and torch.equal(b, bt)
    assert prog.replays == 2 and system.assemble_system.launches == launches + 2


@pytest.mark.parametrize("window", ["orientation", "descriptor"])
@pytest.mark.parametrize("shape", ["small", "flagship"])
def test_k4_kernel_matches_twin(dev, shape, window):
    """Border keys, patch origins the gather clamps, and a NaN coordinate
    (NaN samples, False mask) as in the twin."""
    frames, keys, h, w = (2, 40, 48, 96) if shape == "small" else (11, 512, 480, 640)
    g_tall, xy, sigma, theta, x0, y0, row0 = (torch.as_tensor(a, device=dev)
                                               for a in sift_inputs(16, frames, keys, h, w, 4))
    if window == "orientation":
        coords = sift._window_coords(xy, sigma, torch.zeros_like(theta), 0.4)
    else:
        coords = sift._window_coords(xy, sigma, theta, 0.75)
    coords[0, 7, 19] = float("nan")
    launches = sift.sample_window.launches
    got = sift.sample_window(g_tall, coords, x0, y0, row0, h, w)
    want = sift._sample_window_torch(g_tall, coords, x0, y0, row0, h, w)
    torch.cuda.synchronize()
    assert sift.sample_window.launches == launches + 1
    assert torch.equal(got[2], want[2]) and not bool(got[2][0, 7, 19])
    for g, t in zip(got[:2], want[:2]):
        assert bool(torch.isnan(g[0, 7, 19])) and int(torch.isnan(g).sum()) == 1
        np.testing.assert_array_equal(g.cpu().numpy(), t.cpu().numpy())


BC = bench_config(640, 480, 262144).bundling  # the flagship's bundling: 80x60 cache, 128 keyframes


@pytest.fixture(scope="module")
def verify_cache(dev):
    """Twelve rendered frames' flagship caches (80x60, from 160x120 frames)
    and their poses."""
    seq = generate_sequence(12, 160, 120, radius=0.5, device=dev)
    w = [frame_to_wire2(seq.depth[i], seq.color[i], depth_min=0.1, depth_max=4.0) for i in range(12)]
    d16 = torch.as_tensor(np.stack([x[0] for x in w]).view(np.int16), device=dev)
    y8 = torch.as_tensor(np.stack([x[1] for x in w]), device=dev)
    cc = seq.camera.scaled(BC.cache_width, BC.cache_height)
    _, cache = pp.preprocess_frames_y(d16, y8, seq.camera, cc, geometry=False)
    return cache, torch.as_tensor(seq.poses, device=dev), cc


def _k5_twin(a, b, ts, cam, bc):
    sides = ((a, b), (b, a))[: len(ts)]
    return torch.stack([filters._dense_verify_torch(x, y, t, cam, bc) for (x, y), t in zip(sides, ts)])


@pytest.mark.parametrize("case", ["chunk_filter", "opt_verify", "graph_step_7", "graph_step_128"])
def test_k5_kernel_matches_twin(dev, verify_cache, case):
    """K5 at its call shapes (a chunk's filter on gathered copies, the
    opt-verify on views, graph_step's match with the new keyframe broadcast
    at stride 0): the four sums bit-equal to the twin, one launch."""
    cache, poses, cam = verify_cache
    a, b, ts = k5_cases(torch, cache, poses, BC)[case]
    launches = filters.dense_verify_sums.launches
    got = filters.dense_verify_sums(a, b, ts, cam, BC)
    want = _k5_twin(a, b, ts, cam, BC)
    torch.cuda.synchronize()
    assert filters.dense_verify_sums.launches == launches + 1
    assert int(got[..., 1].sum()) > 0
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("case", K5_EDGE_CASES)
@pytest.mark.parametrize("hw", [(24, 32), (60, 80)], ids=["32x24", "80x60"])
def test_k5_edge_cases(dev, case, hw):
    a, b, T, cam = verify_edge_inputs(case, h=hw[0], w=hw[1])
    a, b = (pp.FrameCache(*(torch.as_tensor(x, device=dev) for x in side)) for side in (a, b))
    T = torch.as_tensor(T, device=dev)
    ts = (T, se3.mat_inverse(T))
    got = filters.dense_verify_sums(a, b, ts, CameraModel(*cam), BC)
    want = _k5_twin(a, b, ts, CameraModel(*cam), BC)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_k5_replays_in_a_graph(dev, verify_cache):
    """Captured in a CUDA graph, K5 replays to the twin's sums, each replay
    one launch."""
    cache, poses, cam = verify_cache
    a, b, ts = k5_cases(torch, cache, poses, BC)["graph_step_7"]
    want = _k5_twin(a, b, ts, cam, BC)
    exe = graphs.Executable(dev, None)
    prog = exe.program("dense_verify", filters.dense_verify_sums)
    exe.stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(exe.stream):
        out = prog(a, b, ts, cam, BC)  # eager, then captured
        launches = filters.dense_verify_sums.launches
        for _ in range(2):
            out.zero_()
            prog(a, b, ts, cam, BC)
            torch.cuda.current_stream().synchronize()
            assert torch.equal(out, want)
    assert prog.replays == 2 and filters.dense_verify_sums.launches == launches + 2


@pytest.fixture(scope="module")
def pair_inputs(dev, verify_cache):
    """K6's call shapes (``k6_cases``) on the rendered 80x60 caches."""
    cache, poses, cam = verify_cache
    return k6_cases(torch, cache, poses, BC), cam


def _k6_args(cases, cam, case):
    return (*cases[case], cam, BC, BC.weight_dense_depth, BC.weight_dense_color)


@pytest.mark.parametrize("case", ["local_55", "global_4096"])
def test_k6_kernel_matches_twin(dev, pair_inputs, case):
    """K6 at its call shapes (the local solve's 55 pairs, all live; the
    global list's 4,096 slots, 425 live among 101 keyframes): JtJ, Jtr,
    both counts and both squared sums bit-equal to the twin, zeros in the
    slots not live, one launch a call."""
    args = _k6_args(*pair_inputs, case)
    launches = residuals.dense_pair_blocks.launches
    got = residuals.dense_pair_blocks(*args)
    want = residuals._dense_pair_blocks_torch(*args)
    torch.cuda.synchronize()
    assert residuals.dense_pair_blocks.launches == launches + 1
    on = args[3]
    assert int(got[2].num_valid_color[on].min()) > 0 and not got[0][~on].any()
    for x, y in zip(dense_outputs(got), dense_outputs(want)):
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())


@pytest.mark.parametrize("case", K6_EDGE_CASES)
@pytest.mark.parametrize("hw", [(24, 32), (60, 80)], ids=["32x24", "80x60"])
def test_k6_edge_cases(dev, case, hw):
    """K6's edge cases (``pair_edge_inputs``): no slot live, a without
    depth, projections off the image and behind it, NaN coordinates, every
    colour test failing, points on and just past the image's edges; every
    output bit-equal to the twin, slots not live exactly zero."""
    P, pa, pb, on, fields, cam = pair_edge_inputs(case, h=hw[0], w=hw[1])
    args = (*(torch.as_tensor(x, device=dev) for x in (P, pa, pb, on)),
            pp.FrameCache(*(torch.as_tensor(x, device=dev) for x in fields)), CameraModel(*cam), BC,
            BC.weight_dense_depth, BC.weight_dense_color)
    launches = residuals.dense_pair_blocks.launches
    got = residuals.dense_pair_blocks(*args)
    want = residuals._dense_pair_blocks_torch(*args)
    assert residuals.dense_pair_blocks.launches == launches + 1
    for x, y in zip(dense_outputs(got), dense_outputs(want)):
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
    off = ~args[3]
    assert all(not bool(x[off].any()) for x in dense_outputs(got))
    if case == "colour_fails":
        assert int(got[2].num_valid_depth[2]) > 0 and int(got[2].num_valid_color[2]) == 0
    if case == "no_valid_depth":
        assert int(got[2].num_valid_depth[2]) == 0 and not got[0][2].any()


def test_k6_replays_in_a_graph(dev, pair_inputs):
    """Captured in a CUDA graph, K6 replays to the twin's blocks, each
    replay one launch."""
    args = _k6_args(*pair_inputs, "global_4096")
    want = dense_outputs(residuals._dense_pair_blocks_torch(*args))
    exe = graphs.Executable(dev, None)
    prog = exe.program("dense_pairs", residuals.dense_pair_blocks)
    exe.stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(exe.stream):
        out = prog(*args)  # eager, then captured
        launches = residuals.dense_pair_blocks.launches
        for _ in range(2):
            for x in dense_outputs(out):
                x.zero_()
            prog(*args)
            torch.cuda.current_stream().synchronize()
            assert all(torch.equal(x, y) for x, y in zip(dense_outputs(out), want))
    assert prog.replays == 2 and residuals.dense_pair_blocks.launches == launches + 2


def _k7_args(dev, case):
    arrays, iters = pcg_inputs(case)
    n = arrays[4].shape[0]
    H, b = system.assemble_system(n, *(torch.as_tensor(a, device=dev) for a in arrays))
    return H, b, iters, 1e-10, torch.as_tensor(arrays[4], device=dev)


@pytest.mark.parametrize("case", list(K7_CASES))
def test_k7_kernel_matches_twin(dev, case):
    """The local shape (n = 11) and the global one (1,200 slots; 7, 64 and
    146 keyframes, a slot inside the live bound not free): one launch a
    call, reruns bit-identical, x within 1e-4 of the twin's (the cuBLAS
    form) in norm, the residual within 1.1 times the twin's, the same live
    rows and zeros past them."""
    args = _k7_args(dev, case)
    launches = system.pcg_solve.launches
    got = system.pcg_solve(*args)
    again = system.pcg_solve(*args)
    want = system._pcg_solve_torch(*args)
    torch.cuda.synchronize()
    assert system.pcg_solve.launches == launches + 2
    assert torch.equal(got.x, again.x) and torch.equal(got.final_rz, again.final_rz)
    cmp = pcg_against(torch, got, want, args[0], args[1])
    assert pcg_within(cmp), cmp
    assert bool((got.x[cmp["rows"]:] == 0).all()) and abs(cmp["iters_run"] - cmp["iters_run_cublas"]) <= 1, cmp


@pytest.mark.parametrize("case", K7_EDGE_CASES)
def test_k7_edge_cases(dev, case):
    """Nothing free, a system solved in the first iteration (both bit for
    bit with the twin, iterations included), a zero diagonal entry (its x
    0 in both)."""
    H, b, free = (torch.as_tensor(a, device=dev) for a in pcg_edge_inputs(case))
    got = system.pcg_solve(H, b, 64, 1e-10, free)
    want = system._pcg_solve_torch(H, b, 64, 1e-10, free)
    if case == "zero_diagonal":
        assert pcg_within(pcg_against(torch, got, want, H, b))
        assert float(got.x[6 * 5 + 2]) == 0.0 == float(want.x[6 * 5 + 2])
    else:
        assert torch.equal(got.x, want.x) and torch.equal(got.final_rz, want.final_rz)
        assert (int(got.rows), int(got.iters_run)) == (int(want.rows), int(want.iters_run))
        assert int(got.iters_run) == (0 if case == "nothing_free" else 1)


def test_k7_replays_in_a_graph(dev):
    """Captured once at 1,200 slots, K7 replays to the twin's result while
    the live bound changes between replays: systems of 7, 146 and 64
    keyframes copied into the captured inputs in place."""
    systems = [_k7_args(dev, c) for c in ("global_64", "global_7", "global_146")]
    H, b, iters, tol, free = (x.clone() if isinstance(x, torch.Tensor) else x for x in systems[0])
    exe = graphs.Executable(dev, None)
    prog = exe.program("pcg", system.pcg_solve)
    exe.stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(exe.stream):
        prog(H, b, iters, tol, free)  # eager, then captured
        launches = system.pcg_solve.launches
        for Hs, bs, _, _, fs in systems[1:] + systems[:1]:
            H.copy_(Hs)
            b.copy_(bs)
            free.copy_(fs)
            got = prog(H, b, iters, tol, free)
            torch.cuda.current_stream().synchronize()
            cmp = pcg_against(torch, got, system._pcg_solve_torch(Hs, bs, iters, tol, fs), Hs, bs)
            assert pcg_within(cmp) and cmp["rows"] == int(system.live_rows(fs, bs.shape[0], dev)), cmp
    assert prog.replays == 3 and system.pcg_solve.launches == launches + 3


def test_stamps_replay_in_a_graph(dev):
    """A captured stamp reads its row on the device: each replay stamps the
    row the chunk tensor holds then (an offset of -1 after the program
    advanced it), later than the replay before; an eager stamp takes its row
    from the host, and a row outside the table goes to the scratch row."""
    table = timeline.make_table(5, dev)
    stamps = timeline.Stamps(table, torch.zeros((), dtype=torch.int32, device=dev))
    col = timeline.COLUMN["sift"]

    def step(s):
        s.begin("sift")
        s.row.add_(1)
        s.end("sift", -1)

    exe = graphs.Executable(dev, None)
    prog = exe.program("stamps", step)
    exe.stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(exe.stream):
        prog(stamps)  # eager (row 0), then captured
        prog(stamps)
        prog(stamps)
        timeline.stamp(table, 0, host_row=3)
        timeline.stamp(table, 1, host_row=9)
        torch.cuda.current_stream().synchronize()
    t = table.cpu().numpy()
    seq = [t[r, col + k] for r in range(3) for k in (0, 1)]
    assert int(stamps.row) == 3 and all(v > 0 for v in seq) and seq == sorted(seq)
    assert t[3, 0] > seq[-1] and t[4, 1] >= t[3, 0]
    offset, err = timeline.calibrate(dev)
    assert 0 <= err < 1e6  # within a millisecond


def test_capture_counts_only_its_own_threads_launches(dev):
    """A graph's launch count is what its capture launched on the capturing
    thread: stamps another thread launches eagerly meanwhile (as the
    pipeline's upload worker does) count once, and no replay repeats them."""
    table = timeline.make_table(3, dev)
    stamps = timeline.Stamps(table, torch.zeros((), dtype=torch.int32, device=dev))
    go, done = threading.Event(), threading.Event()

    def other():
        go.wait()
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            for _ in range(5):
                timeline.stamp(table, 2, host_row=2)
        done.set()

    def step(s):
        s.begin("sift")
        if torch.cuda.is_current_stream_capturing():  # the other thread stamps while this one captures
            go.set()
            assert done.wait(30)
        s.end("sift")

    worker = threading.Thread(target=other)
    worker.start()
    exe = graphs.Executable(dev, None)
    prog = exe.program("stamps", step)
    exe.stream.wait_stream(torch.cuda.current_stream())
    before = timeline.stamp.launches
    with torch.cuda.stream(exe.stream):
        prog(stamps)  # eager, then captured
        prog(stamps)
        prog(stamps)
        torch.cuda.current_stream().synchronize()
    worker.join()
    assert prog.replays == 2 and timeline.stamp.launches - before == 2 + 5 + 2 * 2


def test_program_outputs_survive_other_programs(dev):
    """A program's graph outputs are not overwritten when a program captured
    before it replays (they live outside the executable's shared pool)."""
    assert program_outputs_survive(torch, graphs, dev)["survived"]


def test_wrappers_reject_bad_inputs(dev, frames):
    cam, depth, c8, _ = frames
    table, rows = _fuse(dev, frames)
    with pytest.raises(ValueError):
        tsdf.integrate_blocks(table, dataclasses.replace(rows, slots=rows.slots.long()), depth, c8, APP)
    with pytest.raises(ValueError):
        pp.fused_preprocess(depth.double(), cam)
    with pytest.raises(ValueError):
        pp.fused_preprocess(depth, cam, radius=4)
    n, pa, pb, JtJ, Jtr, free, damping = _k3_args(dev, "small")
    with pytest.raises(ValueError):
        system.assemble_system(n, pa, pb, JtJ.double(), Jtr, free, damping)
    with pytest.raises(ValueError):
        system.assemble_system(n, pa.float(), pb, JtJ, Jtr, free, damping)
    g_tall, xy, sigma, theta, x0, y0, row0 = (torch.as_tensor(a, device=dev) for a in sift_inputs(17, 1, 8, 48, 96, 4))
    coords = sift._window_coords(xy, sigma, theta, 0.75)
    with pytest.raises(ValueError):
        sift.sample_window(g_tall, coords, x0.int(), y0, row0, 48, 96)
    a, b, T, ecam = verify_edge_inputs("nan_transform")
    a, b = (pp.FrameCache(*(torch.as_tensor(x, device=dev) for x in side)) for side in (a, b))
    T = torch.as_tensor(T, device=dev)
    with pytest.raises(ValueError):
        filters.dense_verify_sums(a, b, (T.double(),), CameraModel(*ecam), BC)
    with pytest.raises(ValueError):
        filters.dense_verify_sums(a, pp.FrameCache(*(f[:2] for f in (b.depth, b.points, b.normals, b.intensity,
                                                                      b.grad))), (T,), CameraModel(*ecam), BC)
    P, pa, pb, on, fields, ecam = pair_edge_inputs("not_live")
    P, pa, pb, on = (torch.as_tensor(x, device=dev) for x in (P, pa, pb, on))
    cache = pp.FrameCache(*(torch.as_tensor(x, device=dev) for x in fields))
    for bad in ((P.double(), pa, pb, on, cache), (P, pa.float(), pb, on, cache), (P, pa, pb.long(), on, cache),
                (P, pa, pb, on.int(), cache), (P, pa, pb, on, dataclasses.replace(cache, grad=cache.grad[..., :1]))):
        with pytest.raises(ValueError):
            residuals.dense_pair_blocks(*bad, CameraModel(*ecam), BC, 0.5, 0.1)
    H, b, iters, tol, free = _k7_args(dev, "local_11")
    for bad in ((H.double(), b, iters, tol, free), (H, b[:-6], iters, tol, free), (H, b, iters, tol, free.int()),
                (H, b, -1, tol, free)):
        with pytest.raises(ValueError):
            system.pcg_solve(*bad)
    m = 6 * 2048  # 2,048 slots: the vectors alone exceed a CTA's shared memory
    with pytest.raises(ValueError):
        system.pcg_solve(torch.empty((m, m), device=dev), torch.zeros(m, device=dev), 4)
