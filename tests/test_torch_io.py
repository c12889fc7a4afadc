"""The port's input layer against the JAX package's: ``.sens`` files and
their codecs, TUM directories, the replayer, the corridor scene and the
sensor-noise model, and the preview writer.

Bars: decoded frames, headers, poses, timestamps and batches bit-equal;
written files byte-identical; the corridor render as close as the room
render's test allows (``test_torch_geometry.py``: sphere tracing amplifies
last-ulp differences at silhouettes only).
"""

import os
import sys

import numpy as np
import pytest
import torch

from bundlefusion_tpu import visualization as jvis
from bundlefusion_tpu.io import native as jnative
from bundlefusion_tpu.io import replayer as jrep
from bundlefusion_tpu.io import sens as jsens
from bundlefusion_tpu.io import synthetic as jsyn
from bundlefusion_tpu.io import tum as jtum
from bundlefusion_tpu_torch import visualization as tvis
from bundlefusion_tpu_torch.geometry.camera import CameraModel
from bundlefusion_tpu_torch.io import replayer as trep
from bundlefusion_tpu_torch.io import sens as tsens
from bundlefusion_tpu_torch.io import sensor as tsensor
from bundlefusion_tpu_torch.io import synthetic as tsyn
from bundlefusion_tpu_torch.io import tum as ttum
from util import cached_sequence


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU; PyTorch's
    own thread pool per process would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def seq():
    return cached_sequence(5, width=48, height=32)


def _port_seq(s):
    return tsyn.SyntheticSequence(s.depth, s.color, s.poses, CameraModel(*s.camera), s.timestamps)


def _assert_batches_equal(jr, tr):
    jb, tb = list(jr), list(tr)
    assert len(jb) == len(tb) == len(jr)
    for a, b in zip(jb, tb):
        for k in ("depth", "color", "frame_ids", "valid"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and np.array_equal(x, y), k


def _needs_pil(color_compression="jpeg"):
    if color_compression != "raw":
        pytest.importorskip("PIL.Image")


@pytest.mark.parametrize("color_compression", ["raw", "jpeg"])
def test_sens_written_by_jax_decodes_bit_equal(tmp_path, seq, color_compression):
    _needs_pil(color_compression)
    path = str(tmp_path / "j.sens")
    jsens.write_sens(path, seq.depth, seq.color, seq.poses, seq.camera, color_compression=color_compression)
    jframes, tframes = list(jsens.iter_frames(path)), list(tsens.iter_frames(path))
    assert len(jframes) == len(tframes) == len(seq.depth)
    for (jh, jf), (th, tf) in zip(jframes, tframes):
        for k in jh._fields:
            a, b = getattr(jh, k), getattr(th, k)
            assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b, k
        for k in jf._fields:
            a, b = getattr(jf, k), getattr(tf, k)
            assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b, k
        assert np.array_equal(jsens.decode_depth(jh, jf), tsens.decode_depth(th, tf))
        assert np.array_equal(jsens.decode_color(jh, jf), tsens.decode_color(th, tf))
    assert tuple(tsens.camera_from_header(tframes[0][0])) == tuple(jsens.camera_from_header(jframes[0][0]))
    js, ts = jrep.SensSource(path), trep.SensSource(path)
    assert np.array_equal(js.gt_poses, ts.gt_poses)
    _assert_batches_equal(jrep.Replayer(js, batch_size=2), trep.Replayer(ts, batch_size=2))


@pytest.mark.parametrize("color_compression", ["raw", "jpeg"])
def test_sens_writer_writes_the_same_bytes(tmp_path, seq, color_compression):
    _needs_pil(color_compression)
    jp, tp = str(tmp_path / "j.sens"), str(tmp_path / "t.sens")
    jsens.write_sens(jp, seq.depth, seq.color, seq.poses, seq.camera, color_compression=color_compression)
    tsens.write_sens(tp, seq.depth, seq.color, seq.poses, CameraModel(*seq.camera),
                     color_compression=color_compression)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()


def test_rvl_codec_matches_jax():
    rng = np.random.default_rng(11)
    d = rng.integers(300, 4000, size=(24, 32)).astype(np.uint16)
    d[rng.random(d.shape) < 0.3] = 0  # runs of invalid depth
    d[5, :] = 0
    enc = tsens.rvl_encode(d)
    assert enc == jnative._rvl_encode_py(d.reshape(-1))
    dec = tsens.rvl_decode(enc, d.size)
    assert np.array_equal(dec, jnative._rvl_decode_py(enc, d.size))
    assert np.array_equal(dec.reshape(d.shape), d)


def test_rvl_depth_in_a_sens_frame_decodes():
    d = (np.arange(12, dtype=np.uint16) * 250).reshape(3, 4)
    header = tsens.SensHeader(4, "x", *(np.eye(4, dtype=np.float32),) * 4, "raw", "occi_ushort", 4, 3, 4, 3,
                              1000.0, 1)
    frame = tsens.SensFrame(np.eye(4, dtype=np.float32), 0, 0, b"", tsens.rvl_encode(d))
    assert np.array_equal(tsens.decode_depth(header, frame), d.astype(np.float32) / 1000.0)


@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory, seq):
    """A small TUM directory: 16-bit depth PNGs (x5000), RGB PNGs, jittered
    and one out-of-order timestamp, ground truth at its own rate."""
    Image = pytest.importorskip("PIL.Image")
    root = tmp_path_factory.mktemp("rgbd_dataset_freiburg2_test")
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    rng = np.random.default_rng(5)
    d_lines, c_lines, g_lines = ["# depth"], ["# rgb"], ["# ground truth"]
    for i in range(len(seq.depth)):
        td = 100.0 + i / 30.0
        tc = td + rng.uniform(-0.01, 0.01)
        Image.fromarray((seq.depth[i] * 5000).astype(np.uint16)).save(root / "depth" / f"{i}.png")
        Image.fromarray((seq.color[i] * 255).astype(np.uint8)).save(root / "rgb" / f"{i}.png")
        d_lines.append(f"{td:.6f} depth/{i}.png")
        c_lines.append(f"{tc:.6f} rgb/{i}.png")
    c_lines[2], c_lines[3] = c_lines[3], c_lines[2]
    for k in range(3 * len(seq.depth)):
        t = 100.0 + k / 90.0
        q = rng.normal(size=4)
        g_lines.append(f"{t:.6f} " + " ".join(f"{x:.5f}" for x in [*rng.normal(size=3), *q]))
    (root / "depth.txt").write_text("\n".join(d_lines) + "\n")
    (root / "rgb.txt").write_text("\n".join(c_lines) + "\n")
    (root / "groundtruth.txt").write_text("\n".join(g_lines) + "\n")
    return str(root)


def test_tum_sequence_and_frames_match_jax(tum_dir):
    j, t = jtum.load_tum_sequence(tum_dir), ttum.load_tum_sequence(tum_dir)
    assert j.rgb_paths == t.rgb_paths and j.depth_paths == t.depth_paths
    assert np.array_equal(j.timestamps, t.timestamps)
    assert np.array_equal(j.gt_poses, t.gt_poses, equal_nan=True)
    assert tuple(j.camera) == tuple(t.camera)
    for i in range(len(t.depth_paths)):
        for a, b in zip(jtum.load_frame(j, i), ttum.load_frame(t, i)):
            assert np.array_equal(a, b)
    _assert_batches_equal(jrep.Replayer(jrep.TumSource(j), batch_size=3), trep.Replayer(trep.TumSource(t), 3))


def test_tum_intrinsics_file_overrides_defaults(tum_dir, tmp_path):
    import shutil

    root = tmp_path / "seq"
    shutil.copytree(tum_dir, root)
    (root / "intrinsics.txt").write_text("# fx fy cx cy\n40.0 41.0 23.5 15.5\n")
    j, t = jtum.load_tum_sequence(str(root)), ttum.load_tum_sequence(str(root))
    assert tuple(t.camera) == tuple(j.camera) == (40.0, 41.0, 23.5, 15.5, 48, 32)


def test_synthetic_replayer_batches_match_jax(seq):
    _assert_batches_equal(jrep.Replayer(jrep.SyntheticSource(seq), batch_size=2),
                          trep.Replayer(trep.SyntheticSource(_port_seq(seq)), batch_size=2))


def test_replaysensor_records_a_sens(tmp_path, seq):
    path = str(tmp_path / "rec.sens")
    tsensor.ReplaySensor(trep.SyntheticSource(_port_seq(seq))).record_to(path, poses=seq.poses)
    src = trep.SensSource(path)
    d, c = src.get(2)
    np.testing.assert_allclose(d, seq.depth[2], atol=1e-3)  # 1 mm quantization
    np.testing.assert_allclose(c, seq.color[2], atol=1 / 255.0 + 1e-6)


def test_corridor_matches_jax():
    assert np.array_equal(tsyn.corridor_path_poses(7, x_span=2.5, seed=2), jsyn.corridor_path_poses(7, 2.5, 2))
    for oab in (False, True):
        j = jsyn.generate_corridor_sequence(5, width=48, height=32, x_span=2.5, out_and_back=oab)
        t = tsyn.generate_corridor_sequence(5, width=48, height=32, x_span=2.5, out_and_back=oab, device="cpu")
        assert np.array_equal(j.poses, t.poses) and tuple(j.camera) == tuple(t.camera)
        assert (t.depth > 0).mean() > 0.9
        assert np.mean(np.abs(j.depth - t.depth) < 1e-4) > 0.99
        assert np.mean(np.abs(j.color - t.color) < 1e-3) > 0.99


def test_sensor_noise_matches_jax(seq):
    j = jsyn.apply_sensor_noise(seq, seed=4)
    t = tsyn.apply_sensor_noise(_port_seq(seq), seed=4)
    assert np.array_equal(j.depth, t.depth) and np.array_equal(j.color, t.color)
    assert not np.array_equal(t.depth, seq.depth)


def test_save_preview_matches_jax_and_falls_back_to_npy(tmp_path, monkeypatch):
    _needs_pil()
    img = np.random.default_rng(2).uniform(size=(12, 16, 3)).astype(np.float32)
    jp = jvis.save_preview(str(tmp_path / "j.png"), img)
    tp = tvis.save_preview(str(tmp_path / "t.png"), img)
    assert tp.endswith(".png")
    with open(jp, "rb") as a, open(tp, "rb") as b:
        assert a.read() == b.read()
    monkeypatch.setitem(sys.modules, "PIL", None)
    out = tvis.save_preview(str(tmp_path / "n.png"), img)
    assert out.endswith("n.npy")
    assert np.array_equal(np.load(out), (np.clip(img, 0, 1) * 255).astype(np.uint8))


def test_jpeg_without_pil_fails_with_a_clear_message(tmp_path, seq, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="Pillow"):
        tsens.write_sens(str(tmp_path / "x.sens"), seq.depth, seq.color, seq.poses, CameraModel(*seq.camera),
                         color_compression="jpeg")
