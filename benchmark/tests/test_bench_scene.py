"""The benchmark's frozen room renders the frames of the port's
``io/synthetic.py`` for a seed; its noise model degrades them as the port's
does, given the same draws; the office walk has the extent, pace and
angular speed of TUM RGB-D fr1/room that its traffic file gives it."""

import json

import numpy as np
import pytest
import torch

from benchmark import drive, spec
from benchmark.scene import noise, office, room
from bundlefusion_tpu_torch.io import synthetic


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_render_and_noise_match_the_port(seed):
    seq = synthetic.generate_sequence(9, 64, 48, seed=seed, radius=0.5, device="cpu")
    depth, color = room.render(seq.poses, 64, 48, "cpu")
    assert np.array_equal(depth, seq.depth) and np.array_equal(color, seq.color)
    assert room.intrinsics(64, 48) == tuple(seq.camera)[:4]
    # the port's model draws lateral offsets, axial noise and speckle in this order
    rng = np.random.default_rng(seed)
    shape = depth.shape
    du, dv = rng.normal(scale=0.8, size=shape), rng.normal(scale=0.8, size=shape)
    axial, speckle = rng.normal(size=shape), rng.random(shape)
    nd, nc = noise.degrade(torch.as_tensor(depth), torch.as_tensor(color), 0,
                           *(torch.as_tensor(x) for x in (du, dv, axial, speckle)))
    ref = synthetic.apply_sensor_noise(seq, seed=seed)
    assert np.array_equal(nd.numpy(), ref.depth)
    np.testing.assert_allclose(nc.numpy(), ref.color, rtol=1e-6, atol=1e-7)


def test_device_noise_is_seeded_and_degrades():
    depth, color = room.render(synthetic.orbit_poses(4, radius=0.5, seed=1), 64, 48, "cpu")
    a = room.render(synthetic.orbit_poses(4, radius=0.5, seed=1), 64, 48, "cpu", post=noise.on_device(9, "cpu"))
    b = room.render(synthetic.orbit_poses(4, radius=0.5, seed=1), 64, 48, "cpu", post=noise.on_device(9, "cpu"))
    c = room.render(synthetic.orbit_poses(4, radius=0.5, seed=1), 64, 48, "cpu", post=noise.on_device(10, "cpu"))
    assert np.array_equal(a[0], b[0]) and not np.array_equal(a[0], c[0])
    ok = (a[0] > 0) & (depth > 0)
    assert 0.0 < np.median(np.abs(a[0][ok] - depth[ok])) < 0.02
    assert np.mean(a[0] == 0) > np.mean(depth == 0)  # dropout at edges and speckle


def walk_stats(poses: np.ndarray, rate_hz: float) -> tuple:
    """(mean speed m/s, mean angular speed deg/s, extent [3] m) of a path."""
    rot, eye = poses[:, :3, :3], poses[:, :3, 3]
    rel = np.einsum("nji,njk->nik", rot[:-1], rot[1:])
    ang = np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1))
    speed = np.linalg.norm(np.diff(eye, axis=0), axis=-1)
    return speed.mean() * rate_hz, np.degrees(ang).mean() * rate_hz, eye.max(0) - eye.min(0)


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_walk_has_fr1_room_statistics(seed):
    mix = spec.cell("bf640-1cm.room-sweep").mix
    poses = drive.scan_poses(mix, seed).numpy()
    speed, turn, extent = walk_stats(poses, mix["path"]["rate_hz"])
    # TUM RGB-D fr1/room: 0.334 m/s, 29.882 deg/s, 2.50 x 2.15 x 0.47 m (x, z, height here), 48.9 s
    assert speed == pytest.approx(0.334, rel=0.02)
    assert turn == pytest.approx(29.882, rel=0.05)
    assert extent[[0, 2, 1]] == pytest.approx([2.50, 2.15, 0.47], abs=0.05)
    assert len(poses) / mix["path"]["rate_hz"] == pytest.approx(48.9, abs=0.3)
    rot = poses[:, :3, :3]
    assert np.allclose(rot.transpose(0, 2, 1) @ rot, np.eye(3), atol=1e-9)
    # every view sees the room within the integration distance, from outside the furniture
    assert float(office.scene_sdf(torch.as_tensor(poses[:, :3, 3])).min()) > 0.3


def test_walk_jitter_is_seeded_and_bounded():
    path = dict(json.load(open(f"{spec.ROOT}/benchmark/traffic/room-sweep.json"))["path"])
    path.pop("kind")
    a = office.loop_poses(400, 11, **path)
    b = office.loop_poses(400, 11, **path)
    c = office.loop_poses(400, 12, **path)
    base = office.loop_poses(400, 11, **dict(path, jitter_step=0.0))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float((a[:, :3, 3] - base[:, :3, 3]).abs().max()) < 0.05
    low = office.loop_poses(400, 11, **path, dtype=torch.bfloat16).to(torch.float64)
    assert 1e-4 < float((low[:, :3, 3] - a[:, :3, 3]).abs().max()) < 0.05  # the control's path rounds, not breaks
