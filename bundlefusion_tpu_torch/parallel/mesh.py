"""The shard mesh and its collectives (port of ``bundlefusion_tpu.parallel.mesh``).

The JAX package is single-controller: one process drives every device
through ``shard_map``, and the collectives are ``psum``, ``all_gather`` and
``ppermute`` inside it. The port keeps that shape without
``torch.distributed``: a :class:`Mesh` is a list of devices, one per shard,
driven by one Python process; a per-shard step is the same port function
applied to that shard's tensors on its device; and each collective below is
a plain function over the shards' tensors in rank order, so its result does
not depend on the order in which devices finish (an NCCL ring makes no such
promise against a sequential sum).

With fewer cards than shards, several shards share a card (shard i runs on
``cuda:(i % device_count)``): the counterpart of the JAX package's virtual
CPU devices. The port never falls back from the card to the CPU; the tests
ask for CPU shards explicitly (``make_mesh(n, "cpu")``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: shard i runs on ``devices[i]``."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        distinct = list(dict.fromkeys(str(d) for d in self.devices))
        shared = f", {self.size} shards share {len(distinct)} device(s)" if len(distinct) < self.size else ""
        return f"Mesh(devices=[{', '.join(str(d) for d in self.devices)}]{shared})"


def make_mesh(n_devices: int, device: torch.device | str = "cuda") -> Mesh:
    """A mesh of ``n_devices`` shards over the cards (``device="cuda"``,
    shard i on ``cuda:(i % device_count)``) or over one named device (all
    shards on it, e.g. ``"cpu"`` for tests)."""
    if n_devices < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_devices}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device (ask for device='cpu' explicitly)")
        devices = tuple(torch.device("cuda", i % count) for i in range(n_devices))
    else:
        devices = (dev,) * n_devices
    return Mesh(devices)


def psum(mesh: Mesh, parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """``lax.psum``: the shards' tensors summed in rank order on shard 0's
    device, then one copy on each shard's device."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device, non_blocking=True)
    return [total.to(d, non_blocking=True) for d in mesh.devices]


def all_gather(mesh: Mesh, parts: list[torch.Tensor]) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)``: the shards' tensors concatenated
    along axis 0 in rank order, on shard 0's device (every shard's copy
    would be the same)."""
    dev = mesh.devices[0]
    return torch.cat([p.to(dev, non_blocking=True) for p in parts])


def ppermute(mesh: Mesh, parts: list[torch.Tensor], perm: list[tuple[int, int]]) -> list[torch.Tensor]:
    """``lax.ppermute``: shard ``dst`` receives shard ``src``'s tensor for
    each (src, dst) pair, on its own device; a shard that receives nothing
    gets zeros."""
    out = [torch.zeros_like(p, device=d) for p, d in zip(parts, mesh.devices)]
    for src, dst in perm:
        out[dst] = parts[src].to(mesh.devices[dst], non_blocking=True)
    return out
