"""Kinect-v1-style sensor noise for mixes that ask for ``"noise": true``: the
model of the port's ``io/synthetic.py::apply_sensor_noise``, op for op, in
PyTorch, so that it runs on the card beside the renderer.

``degrade`` applies the model to a batch of frames given its random draws;
``on_device`` draws them on the device with a ``torch.Generator`` seeded
from the run's seed. Given numpy's draws, in numpy's order, ``degrade``
gives the port's frames (the benchmark's tests hold it to them).
"""

from __future__ import annotations

import torch

K_DISPARITY = 360.0


def degrade(depth: torch.Tensor, color: torch.Tensor, first: int, du: torch.Tensor, dv: torch.Tensor,
            axial: torch.Tensor, speckle: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Degrade clean frames ``first`` .. of a scan (depth [B, H, W] float32,
    colour [B, H, W, 3]): ~0.8 px lateral jitter (``du``, ``dv``: N(0, 0.8)
    pixel offsets), axial noise 1.2 mm + 1.9 mm * (z - 0.4)^2 (``axial``:
    N(0, 1)), disparity quantization (K = 360), dropout at depth edges over
    10 cm and 0.5% speckle (``speckle``: U(0, 1)), and a slow exposure gain
    in [0.9, 1.1] by frame index. The draws are float64 [B, H, W]. Returns
    float32 (depth, colour)."""
    n, h, w = depth.shape
    dev = depth.device
    uu = torch.clamp(torch.arange(w, device=dev)[None, None, :] + du, 0, w - 1).to(torch.int32)
    vv = torch.clamp(torch.arange(h, device=dev)[None, :, None] + dv, 0, h - 1).to(torch.int32)
    depth = torch.gather(depth.reshape(n, -1), 1, (vv * w + uu).reshape(n, -1).long()).reshape(n, h, w)
    sigma = 0.0012 + 0.0019 * torch.square(torch.clamp(depth - 0.4, min=0.0))
    depth = torch.where(depth > 0, depth + axial * sigma, 0.0)
    k = torch.full_like(depth, K_DISPARITY)  # a tensor quotient rounds once; a scalar's is a reciprocal times K
    dq = torch.round(k / torch.clamp(depth, min=1e-3))
    depth = torch.where(depth > 0, k / torch.clamp(dq, min=1.0), 0.0)
    gx = torch.abs(torch.diff(depth, dim=2, prepend=depth[:, :, :1]))
    gy = torch.abs(torch.diff(depth, dim=1, prepend=depth[:, :1, :]))
    depth = torch.where((gx > 0.1) | (gy > 0.1) | (speckle < 0.005), 0.0, depth)
    gain = 1.0 + 0.1 * torch.sin(torch.arange(first, first + n, dtype=torch.float64, device=dev) * 0.21 + 0.5)
    color = torch.clamp(color * gain[:, None, None, None], 0.0, 1.0)
    return depth.to(torch.float32), color.to(torch.float32)


def on_device(seed: int, device):
    """``post(depth, colour, first)`` for ``room.render``: ``degrade`` with
    draws from a generator on ``device`` seeded with ``seed``, batch after
    batch."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def post(depth: torch.Tensor, color: torch.Tensor, first: int):
        shape = depth.shape
        f64 = dict(generator=gen, dtype=torch.float64, device=depth.device)
        du = torch.randn(shape, **f64) * 0.8
        dv = torch.randn(shape, **f64) * 0.8
        axial = torch.randn(shape, **f64)
        speckle = torch.rand(shape, **f64)
        return degrade(depth, color, first, du, dv, axial, speckle)

    return post
