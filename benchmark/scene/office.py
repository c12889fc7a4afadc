"""An office-sized room walked around on a loop, the way a hand-held scan of a
room is recorded: the benchmark's own scene, rendered with the frozen room's
sphere tracer and procedural albedo (``room.py``).

The room is 6.0 m by 5.2 m and 2.6 m high, closed on every side, with a
desk and a screen, a tall cabinet, a sofa, a box and a ball along its walls.
The world's up is +y, as in the frozen room (whose floor is y = -1): the
floor is the plane y = -1.35, the ceiling y = 1.25, and the camera walks at
y = 0.

``loop_poses`` is the camera path: an ellipse around the room's middle,
walked at a fixed speed and looked out of (at the walls and the furniture),
with a panning sway, a slow rise and fall, a downward tilt and a seeded
hand-held jitter. The traffic file gives its numbers; the benchmark's are
those of TUM RGB-D's fr1/room (a walk around an office): 2.50 m by 2.15 m by
0.47 m of extent, 0.334 m/s and about 30 deg/s on average, ~49 s at 30 Hz.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import room

HALF_X, HALF_Z = 3.0, 2.6  # the walls: x = +-3.0, z = +-2.6
FLOOR, CEILING = -1.35, 1.25  # y of the floor and the ceiling (up is +y)
# furniture boxes: (centre, half sizes)
BOXES = (
    ((2.55, -0.95, 0.3), (0.4, 0.4, 0.75)),  # desk, 0.8 m high
    ((2.7, -0.35, 0.3), (0.05, 0.2, 0.3)),  # a screen on it
    ((-2.6, -0.4, -1.2), (0.35, 0.95, 0.45)),  # cabinet, 1.9 m high
    ((-0.6, -1.05, 2.3), (0.8, 0.3, 0.25)),  # sofa
    ((0.9, -1.1, -2.25), (0.4, 0.25, 0.3)),  # a box on the floor
)
BALL = ((-2.1, -1.0, 1.9), 0.35)
STEPS = 160  # sphere-tracing iterations: rays that graze a wall converge slowly

intrinsics = room.intrinsics


def scene_sdf(p: torch.Tensor) -> torch.Tensor:
    """Signed distance of the office at world points [..., 3] (positive in
    the room's free space)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d = torch.minimum(torch.minimum(HALF_X - torch.abs(x), HALF_Z - torch.abs(z)), torch.minimum(y - FLOOR, CEILING - y))
    for centre, half in BOXES:
        q = torch.abs(p - room._const(centre, p)) - room._const(half, p)
        box = torch.linalg.vector_norm(torch.clamp(q, min=0.0), dim=-1) + torch.clamp(torch.amax(q, dim=-1), max=0.0)
        d = torch.minimum(d, box)
    centre, radius = BALL
    return torch.minimum(d, torch.linalg.vector_norm(p - room._const(centre, p), dim=-1) - radius)


def render(poses: np.ndarray, width: int, height: int, device, batch: int = 8, post=None):
    """The office at camera-to-world ``poses`` [N, 4, 4]: ``room.render``
    with this scene's signed distance."""
    return room.render(poses, width, height, device, batch, sdf=scene_sdf, steps=STEPS, post=post)


def loop_angles(num_frames: int, semi_x: float, semi_z: float, speed: float, rate_hz: float) -> np.ndarray:
    """The ellipse's parameter (radians, float64) at each frame when it is
    walked at ``speed`` m/s from its +z end, ``rate_hz`` frames a second:
    the arc length inverted on a fine grid, taken modulo one turn."""
    g = np.linspace(0.0, 2.0 * math.pi, 20001)
    ds = np.hypot(semi_x * np.cos(g), semi_z * np.sin(g))
    s = np.concatenate([[0.0], np.cumsum(0.5 * (ds[1:] + ds[:-1]) * np.diff(g))])
    walked = np.arange(num_frames) * (speed / rate_hz)
    return np.interp(np.mod(walked, s[-1]), s, g)


def loop_poses(num_frames: int, seed: int, semi_x: float, semi_z: float, speed: float, rate_hz: float,
               pan: float, pan_period: float, rise: float, rise_period: float, tilt: float, jitter_step: float,
               jitter_keep: float, dtype=torch.float64) -> torch.Tensor:
    """Camera-to-world poses [N, 4, 4] of the loop, on the CPU in ``dtype``.

    Frame i (at t = i / rate_hz) stands at (semi_x sin a, rise / 2 sin(2 pi t
    / rise_period), semi_z cos a) plus the jitter, where a is the ellipse's
    parameter walked at ``speed`` (``loop_angles``), and looks out along the
    heading a + pan sin(2 pi t / pan_period), tilted ``tilt`` radians down.
    The jitter is a seeded random walk pulled back toward the path (j[i] =
    jitter_keep * j[i-1] + N(0, jitter_step) per axis, half as much in
    height), so that it stays bounded over a long scan. The angles are
    worked out in float64 and reduced to one turn; everything from them on
    (the trigonometry, the jitter, the frame's axes) runs in ``dtype``, so
    that the reference can also be computed in a lower precision."""
    rng = np.random.default_rng(seed)
    steps = torch.as_tensor(rng.normal(scale=jitter_step, size=(num_frames, 3))).to(dtype)
    jit = torch.zeros((num_frames, 3), dtype=dtype)
    for i in range(num_frames):
        jit[i] = steps[i] if i == 0 else jit[i - 1] * jitter_keep + steps[i]
    t = np.arange(num_frames) / rate_hz
    a = loop_angles(num_frames, semi_x, semi_z, speed, rate_hz)
    heading = np.mod(a + pan * np.sin(2.0 * math.pi * t / pan_period), 2.0 * math.pi)
    lift = np.sin(np.mod(2.0 * math.pi * t / rise_period, 2.0 * math.pi))
    a, heading, lift = (torch.as_tensor(v).to(dtype) for v in (a, heading, lift))
    eye = torch.stack([semi_x * torch.sin(a), (0.5 * rise) * lift, semi_z * torch.cos(a)], dim=-1)
    eye = eye + jit * torch.tensor([1.0, 0.5, 1.0], dtype=dtype)
    tilt_t = torch.tensor(tilt, dtype=dtype)
    ct, st = torch.cos(tilt_t), torch.sin(tilt_t)
    fwd = torch.stack([ct * torch.sin(heading), -st.expand_as(heading), ct * torch.cos(heading)], dim=-1)
    up = torch.tensor([0.0, -1.0, 0.0], dtype=dtype).expand_as(fwd)  # the frozen room's: image rows run down -y
    right = torch.linalg.cross(up, fwd)
    right = right / torch.linalg.vector_norm(right, dim=-1, keepdim=True)
    down = torch.linalg.cross(fwd, right)
    poses = torch.zeros((num_frames, 4, 4), dtype=dtype)
    poses[:, :3, 0], poses[:, :3, 1], poses[:, :3, 2], poses[:, :3, 3] = right, down, fwd, eye
    poses[:, 3, 3] = 1.0
    return poses
