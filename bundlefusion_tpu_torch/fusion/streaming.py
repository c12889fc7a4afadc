"""Out-of-core block streaming, device <-> host
(port of ``bundlefusion_tpu.fusion.streaming``).

The world is partitioned into coarse chunks; blocks outside an active radius
around the camera move off the device into host memory, and come back when
the camera returns. Each stream step is one device compaction plus one
vectorized host-array update between pipeline steps; it reads device state
on the host by design (the pipeline runs it at its streaming checks only).

Host storage is array-batched (contiguous numpy arrays + a free-row list)
with a coarse chunk-grid index over the rows, so stream-in inspects only the
chunks near the camera. :class:`HostBlockStore` is numpy and a copy of the
JAX package's.

Data-safety invariants:
  * stream-in never discards: the batch is sized by the device pool's free
    capacity, and any row the allocator still rejects is re-inserted.
  * a streamed-in block whose key re-appeared on the device meanwhile is
    merged: sdf = (w_d*s_d + w_h*s_h)/(w_d+w_h), weights and colour
    accumulators add (the weighted-mean TSDF of two disjoint accumulations).

The store can hold one key twice (a block evicted, re-allocated on the
device while cold, and evicted again before a stream-in merged it). Where
the JAX package scatters such a batch with duplicate indices, XLA writes
them in order: the last copy's sdf and weight win and every copy's colour
adds. The port writes the same, explicitly, because a CUDA indexed write
with duplicate indices keeps an arbitrary one (:func:`last_of_each`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import AppConfig
from ..utils.tensor_ops import deterministic, top_k
from .blocks import BLOCK, INVALID_KEY, NVOX, BlockTable, allocate, block_origin, free_slots_by_mask, lookup, unpack_key

_GROW = 4096  # host array growth quantum (rows)


def last_of_each(keys: np.ndarray) -> np.ndarray:
    """Ascending indices of the last occurrence of each distinct key: the
    rows whose writes survive an in-order scatter with duplicate indices."""
    _, first_rev = np.unique(keys[::-1], return_index=True)
    return np.sort(len(keys) - 1 - first_rev)


def _unpack_np(key: np.ndarray) -> np.ndarray:
    x = (key & 1023) - 512
    y = ((key >> 10) & 1023) - 512
    z = ((key >> 20) & 1023) - 512
    return np.stack([x, y, z], axis=-1)


class HostBlockStore:
    """Cold block storage: contiguous arrays + chunk-grid index.

    ``chunk_blocks`` is the coarse chunk edge in blocks (the reference's
    ChunkGrid cell); membership and radius queries go per chunk, never per
    block.
    """

    def __init__(self, chunk_blocks: int = 16) -> None:
        self.chunk_blocks = chunk_blocks
        self._cap = 0
        self._n_live = 0
        self._keys = np.zeros((0,), np.int32)
        self._sdf = np.zeros((0, NVOX), np.float32)
        self._wgt = np.zeros((0, NVOX), np.float32)
        self._col = np.zeros((0, 3 * NVOX), np.float32)
        self._free: list[int] = []
        self._chunks: dict[int, list[int]] = {}  # chunk key -> live row list

    def __len__(self) -> int:
        return self._n_live

    def _chunk_keys_of(self, block_keys: np.ndarray) -> np.ndarray:
        c = np.floor_divide(_unpack_np(block_keys), self.chunk_blocks) + 512
        return c[..., 0] | (c[..., 1] << 10) | (c[..., 2] << 20)

    def _grow_to(self, need: int) -> None:
        if need <= self._cap:
            return
        new_cap = max(need, self._cap + _GROW)
        add = new_cap - self._cap

        def ext(a, shape):
            return np.concatenate([a, np.zeros((add,) + shape, a.dtype)])

        self._keys = ext(self._keys, ())
        self._sdf = ext(self._sdf, (NVOX,))
        self._wgt = ext(self._wgt, (NVOX,))
        self._col = ext(self._col, (3 * NVOX,))
        self._free.extend(range(self._cap, new_cap))
        self._cap = new_cap

    def put(self, keys: np.ndarray, sdf: np.ndarray, weight: np.ndarray, color: np.ndarray) -> None:
        """Insert a batch of blocks. O(batch) host work."""
        n = len(keys)
        if n == 0:
            return
        self._grow_to(self._n_live + n)
        rows = np.asarray(self._free[-n:], np.int64)
        del self._free[-n:]
        self._keys[rows] = keys
        self._sdf[rows] = sdf
        self._wgt[rows] = weight
        self._col[rows] = color
        self._n_live += n
        ck = self._chunk_keys_of(np.asarray(keys))
        order = np.argsort(ck, kind="stable")
        uniq, starts = np.unique(ck[order], return_index=True)
        bounds = np.append(starts, n)
        for i, c in enumerate(uniq):
            self._chunks.setdefault(int(c), []).extend(rows[order[bounds[i] : bounds[i + 1]]].tolist())

    def chunks_near(self, center: np.ndarray, radius: float, voxel_size: float) -> list[int]:
        """Chunk keys whose centre lies within ``radius`` of ``center``."""
        if not self._chunks:
            return []
        ck = np.fromiter(self._chunks.keys(), np.int64, len(self._chunks))
        cc = _unpack_np(ck)
        edge = self.chunk_blocks * BLOCK * voxel_size
        ctr = cc.astype(np.float32) * edge + 0.5 * edge
        near = np.linalg.norm(ctr - center[None], axis=-1) <= radius
        return [int(k) for k in ck[near]]

    def take_chunks(self, chunk_keys: list[int], limit: int) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Pop up to ``limit`` blocks from the given chunks (whole chunks
        first, then a partial chunk if the limit cuts one). Returns copies."""
        rows: list[int] = []
        for c in chunk_keys:
            lst = self._chunks.get(c)
            if lst is None:
                continue
            room = limit - len(rows)
            if room <= 0:
                break
            if len(lst) <= room:
                rows.extend(lst)
                del self._chunks[c]
            else:
                rows.extend(lst[-room:])
                del lst[-room:]
        if not rows:
            return (
                np.zeros((0,), np.int32),
                np.zeros((0, NVOX), np.float32),
                np.zeros((0, NVOX), np.float32),
                np.zeros((0, 3 * NVOX), np.float32),
            )
        r = np.asarray(rows, np.int64)
        out = (self._keys[r].copy(), self._sdf[r].copy(), self._wgt[r].copy(), self._col[r].copy())
        self._free.extend(rows)
        self._n_live -= len(rows)
        return out

    def snapshot_batches(self, batch_rows: int):
        """Yield (keys, sdf, weight, colour) over ALL stored blocks without
        removing them (streaming-aware mesh extraction)."""
        rows: list[int] = []
        for lst in self._chunks.values():
            rows.extend(lst)
        for i in range(0, len(rows), batch_rows):
            r = np.asarray(rows[i : i + batch_rows], np.int64)
            yield self._keys[r], self._sdf[r], self._wgt[r], self._col[r]


# ----------------------------------------------------------------------
# device-side stream passes
# ----------------------------------------------------------------------


def _far_mask(table: BlockTable, center: torch.Tensor, radius: float, voxel_size: float):
    """(occupied live slots farther than ``radius`` from ``center``, each
    slot's centre distance). The distance is summed as x² + y² + z², the
    order of XLA's norm, so ties and near-ties rank as in the JAX package."""
    ctr = block_origin(unpack_key(table.key_of_slot), voxel_size) + 0.5 * BLOCK * voxel_size
    diff = ctr - center
    d = torch.sqrt(diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1] + diff[:, 2] * diff[:, 2])
    occupied = torch.any(table.weight[: table.capacity] > 0, dim=1)
    live = table.key_of_slot != INVALID_KEY
    return (d > radius) & occupied & live, torch.where(live, d, 0.0)


def _collect_far(table: BlockTable, center: torch.Tensor, radius: float, voxel_size: float, max_out: int = 1024):
    """Data slots of the ``max_out`` farthest far blocks, farthest first
    (ties to the lower slot, as ``lax.top_k``), and which entries are real."""
    far, d = _far_mask(table, center, radius, voxel_size)
    top, idx = top_k(torch.where(far, d, -torch.inf), max_out)
    return idx, torch.isfinite(top)


def stream_out(
    table: BlockTable, store: HostBlockStore, camera_pos: np.ndarray, cfg: AppConfig, max_out: int = 1024
) -> tuple[BlockTable, int]:
    """Move up to ``max_out`` farthest blocks outside the streaming radius to
    the host (collect on the device, one batched copy)."""
    dev = table.keys.device
    center = torch.as_tensor(np.asarray(camera_pos, np.float32), device=dev)
    idx, ok = _collect_far(table, center, cfg.streaming_radius, cfg.voxel_size, max_out=max_out)
    mask = ok.cpu().numpy()
    if not mask.any():
        return table, 0
    sel = idx[torch.as_tensor(mask, device=dev)]  # data slots to evict, in eviction order
    store.put(
        table.key_of_slot[sel].cpu().numpy(),
        table.sdf[sel].cpu().numpy(),
        table.weight[sel].cpu().numpy(),
        table.color[sel].cpu().numpy(),
    )
    dead = torch.zeros(table.capacity, dtype=torch.bool, device=dev)
    dead[sel] = True
    return free_slots_by_mask(table, dead), int(mask.sum())


def stream_in(
    table: BlockTable,
    store: HostBlockStore,
    camera_pos: np.ndarray,
    cfg: AppConfig,
    max_in: int = 1024,
    free_capacity: int | None = None,
) -> tuple[BlockTable, int]:
    """Bring stored blocks within the streaming radius back onto the device,
    merging into any block that re-appeared there while cold. Each slot is
    written once by a plain indexed write (no scatter-add)."""
    if len(store) == 0:
        return table, 0
    chunks = store.chunks_near(np.asarray(camera_pos, np.float32), cfg.streaming_radius, cfg.voxel_size)
    if not chunks:
        return table, 0
    if free_capacity is None:
        free_capacity = int(table.capacity - table.num_active())
    take = min(max_in, free_capacity)
    if take <= 0:
        return table, 0
    keys, sdf, wgt, col = store.take_chunks(chunks, take)
    if len(keys) == 0:
        return table, 0
    dev = table.keys.device
    keys_t = torch.as_tensor(keys, device=dev)
    table, _ = allocate(table, keys_t)
    slots, found = lookup(table, keys_t)
    ok = found.cpu().numpy()
    if not ok.all():
        bad = ~ok
        store.put(keys[bad], sdf[bad], wgt[bad], col[bad])
        keys, sdf, wgt, col = keys[ok], sdf[ok], wgt[ok], col[ok]
        slots = slots[torch.as_tensor(ok, device=dev)]
    if len(keys) == 0:
        return table, 0
    s = slots.long()
    w_d, s_d = table.weight[s], table.sdf[s]
    w_h = torch.as_tensor(wgt, device=dev)
    s_h = torch.as_tensor(sdf, device=dev)
    w_sum = w_d + w_h
    sdf_m = torch.where(w_sum > 0, (w_d * s_d + w_h * s_h) / torch.clamp(w_sum, min=1e-9), 0.0)
    last = torch.as_tensor(last_of_each(keys), device=dev)
    table.sdf[s[last]] = sdf_m[last]
    table.weight[s[last]] = w_sum[last]
    with deterministic():  # duplicates add in row order
        table.color.index_add_(0, s, torch.as_tensor(col, device=dev))
    return table, int(len(keys))
