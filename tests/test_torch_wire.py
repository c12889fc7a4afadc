"""The RGB (v1) wire, the wire-level bilateral, the RGB preprocessing and
chunk entry, and the native .sens codecs: the port against the JAX package.

Bars: wire conversion and the bilateral give equal bytes (both sides on
their numpy branch, ``framewire._load`` -> None: the JAX package's native
converter disagrees with its numpy one, ROADMAP Queue 3); ``preprocess_frames`` as
``preprocess_frames_y`` in ``test_torch_preprocess.py`` (1e-5, intensity
1e-6); the RGB chunk as the chunk bars of ``test_torch_pipeline.py``
(validity, key counts and pair validity equal, filtered matches within 1%,
local poses within 1e-4); the codecs give equal bytes.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.bundle import chunk as jchunk
from bundlefusion_tpu.config import tiny_test_config as j_tiny
from bundlefusion_tpu.io import framewire as jfw
from bundlefusion_tpu.io import native as jnative
from bundlefusion_tpu.ops import preprocess as jpp
from bundlefusion_tpu_torch.bundle import chunk as tchunk
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.io import framewire as tfw
from bundlefusion_tpu_torch.io import native as tnative
from bundlefusion_tpu_torch.io import sens as tsens
from bundlefusion_tpu_torch.ops import preprocess as tpp
from util import cached_sequence


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_numpy_wire(monkeypatch):
    """Both sides on their numpy branch; the port's native converter is held
    to its numpy branch in ``test_torch_ingest.py``."""
    monkeypatch.setattr(jfw, "_load", lambda: None)
    monkeypatch.setattr(tfw, "_load", lambda: None)


def _frames(w, h, seed):
    """Rendered frames with out-of-range depth and colour mixed in, and
    depth holes (the filter's zero-aware path)."""
    seq = cached_sequence(2, width=w, height=h, seed=seed)
    rng = np.random.default_rng(seed)
    depth = seq.depth.copy()
    depth[:, : h // 8] = rng.uniform(-1.0, 70.0, depth[:, : h // 8].shape)
    depth[rng.random(depth.shape) < 0.05] = 0.0
    color = seq.color.copy()
    color[:, :2] = rng.uniform(-0.2, 1.2, color[:, :2].shape)
    return depth.astype(np.float32), color.astype(np.float32)


SIZES = [(64, 48, s) for s in (0, 1, 2)] + [(128, 96, s) for s in (0, 3)]


@pytest.mark.parametrize("w,h,seed", SIZES)
def test_frame_to_wire_matches_jax(w, h, seed):
    depth, color = _frames(w, h, seed)
    for i in range(2):
        for a, b in zip(jfw.frame_to_wire(depth[i], color[i]), tfw.frame_to_wire(depth[i], color[i])):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("w,h,seed", SIZES)
def test_bilateral_wire_matches_jax(w, h, seed):
    depth, color = _frames(w, h, seed)
    d16 = tfw.frame_to_wire(depth[0], color[0])[0]
    for sd, sr in ((2.0, 0.1), (1.0, 0.03)):
        want = jfw.bilateral_wire(d16, sd, sr)
        got = tfw.bilateral_wire(d16, sd, sr)
        assert got.dtype == np.uint16 and want.tobytes() == got.tobytes()
    assert not np.array_equal(tfw.bilateral_wire(d16, 2.0, 0.1), d16)


def test_color_to_intensity_matches_jax():
    c = np.random.default_rng(4).random((3, 12, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jpp.color_to_intensity(jnp.asarray(c))), tpp.color_to_intensity(torch.as_tensor(c)).numpy(),
        atol=1e-6, rtol=0,
    )


@pytest.mark.parametrize("filter_depth", [True, False])
def test_preprocess_frames_matches_jax(filter_depth):
    seq = cached_sequence(4, width=64, height=48)
    cam = seq.camera
    cc = cam.scaled(32, 24)
    fj, cj = jpp.preprocess_frames(jnp.asarray(seq.depth), jnp.asarray(seq.color), cam, cc,
                                   filter_depth=filter_depth)
    ft, ct = tpp.preprocess_frames(torch.as_tensor(seq.depth), torch.as_tensor(seq.color), cam, cc,
                                   filter_depth=filter_depth)
    np.testing.assert_allclose(np.asarray(fj.depth), ft.depth.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(fj.intensity), ft.intensity.numpy(), atol=1e-6, rtol=0)
    assert torch.equal(ft.color, torch.as_tensor(seq.color))
    for k in ("depth", "points", "normals", "intensity", "grad"):
        np.testing.assert_allclose(np.asarray(getattr(cj, k)), getattr(ct, k).numpy(), atol=1e-5, rtol=0, err_msg=k)


def test_process_chunk_rgb_matches_jax():
    """One chunk from the v1 wire (uint16 depth, uint8 RGB) at 128x96."""
    seq = cached_sequence(13, width=128, height=96)
    jc, tc = j_tiny().bundling, t_tiny().bundling
    cam = seq.camera
    cc = cam.scaled(jc.cache_width, jc.cache_height)
    wires = [tfw.frame_to_wire(seq.depth[i], seq.color[i]) for i in range(jc.chunk_size)]
    d16 = np.stack([x[0] for x in wires])
    c8 = np.stack([x[1] for x in wires])
    rj = jchunk.process_chunk(jnp.asarray(d16), jnp.asarray(c8), cam, cc, jc)
    rt = tchunk.process_chunk(torch.as_tensor(d16.view(np.int16)), torch.as_tensor(c8), cam, cc, tc)
    assert bool(rj.chunk_valid) == bool(rt.chunk_valid) is True
    np.testing.assert_array_equal(np.asarray(rj.num_keys), rt.num_keys.numpy())
    np.testing.assert_array_equal(np.asarray(rj.pair_valid), rt.pair_valid.numpy())
    mj, mt = int(np.asarray(rj.num_matches).sum()), int(rt.num_matches.sum())
    assert abs(mj - mt) <= 0.01 * mj, (mj, mt)
    err = float(np.abs(np.asarray(rj.local_traj) - rt.local_traj.numpy()).max())
    print(f"RGB chunk: max |local pose jax - port| {err:.3g}, filtered matches {mj} / {mt}")
    assert err <= 1e-4
    # the RGB branch reads float luminance, not the 8-bit luma plane
    y8 = np.stack([tfw.frame_to_wire2(seq.depth[i], seq.color[i])[1] for i in range(jc.chunk_size)])
    ry = tchunk.process_chunk(torch.as_tensor(d16.view(np.int16)), torch.as_tensor(y8), cam, cc, tc)
    assert not torch.equal(ry.keyframe_cache.intensity, rt.keyframe_cache.intensity)


@pytest.fixture(scope="module")
def native_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native codec cannot be built on this host")
    assert tnative.have_native() and jnative.have_native()


def _depth(seed, shape=(48, 64)):
    rng = np.random.default_rng(seed)
    d = rng.integers(300, 4000, shape).astype(np.uint16)
    d[rng.random(shape) < 0.3] = 0
    return d


@pytest.mark.parametrize("seed", [0, 1])
def test_native_codecs_match_jax(native_lib, seed):
    d = _depth(seed)
    enc = tnative.rvl_encode(d)
    assert enc == jnative.rvl_encode(d) == tsens.rvl_encode(d)
    dec = tnative.rvl_decode(enc, d.size)
    assert dec.tobytes() == jnative.rvl_decode(enc, d.size).tobytes() == d.tobytes()
    z = tnative.deflate(d.tobytes())
    assert z == jnative.deflate(d.tobytes())
    assert tnative.inflate(z, d.nbytes) == jnative.inflate(z, d.nbytes) == d.tobytes()


def test_native_build_lands_in_the_port(native_lib):
    import os

    assert os.path.exists(tnative.LIB_PATH) and "/bundlefusion_tpu_torch/_build/" in tnative.LIB_PATH


def test_codecs_fall_back_to_python(monkeypatch):
    """Without the library every entry point gives the same bytes in Python."""
    d = _depth(5)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    enc = tnative.rvl_encode(d)
    assert enc == tsens.rvl_encode(d)
    assert tnative.rvl_decode(enc, d.size).tobytes() == d.tobytes()
    assert tnative.inflate(tnative.deflate(d.tobytes()), d.nbytes) == d.tobytes()
    assert not tnative.have_native()
