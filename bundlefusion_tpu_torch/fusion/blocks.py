"""Dense-block TSDF volume (port of ``bundlefusion_tpu.fusion.blocks``).

A fixed-capacity block pool with a *sorted key index* kept apart from the
voxel data:

  * ``keys``  [C] int32 — packed block coordinates, ascending; empty entries
    hold INVALID_KEY and sort to the end. Lookup = ``torch.searchsorted``.
  * ``slot_of`` [C] int32 — the data slot behind each sorted index entry (a
    permutation of [0, C)); ``key_of_slot`` [C] is the reverse map.
  * ``sdf/weight`` [C+1, 512] and ``color`` [C+1, 1536] — planar pools
    addressed by data slot (flat voxel index v = z*64 + y*8 + x; colour
    channel-major, element ch*512 + v). Row C is a scratch row: masked
    updates are routed there and never read.

Block data never moves: allocation and GC re-sort only the [C] index pair.
The pools are updated IN PLACE (the JAX package donates them): ``allocate``
zeroes newly assigned rows of the table it is given, and the integrate
kernel writes its rows directly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..utils.tensor_ops import set_drop

BLOCK = 8  # voxels per block axis (kernels are specialized to 8^3)
NVOX = BLOCK**3  # voxels per block, flat order v = z*64 + y*8 + x
_OFF = 512  # coordinate offset for packing
INVALID_KEY = 1 << 30  # sorts after every valid key


@dataclass
class BlockTable:
    """Fixed-capacity block pool with a sorted key index (scratch row at C)."""

    keys: torch.Tensor  # [C] int32 sorted packed coords; INVALID_KEY = empty
    slot_of: torch.Tensor  # [C] int32 data slot per sorted index entry
    key_of_slot: torch.Tensor  # [C] int32 packed coord per data slot
    sdf: torch.Tensor  # [C+1, 512] float32
    weight: torch.Tensor  # [C+1, 512] float32
    color: torch.Tensor  # [C+1, 1536] float32 weight-scaled colour accumulator

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def num_active(self) -> torch.Tensor:
        return torch.sum(self.keys != INVALID_KEY)


def make_table(capacity: int, device) -> BlockTable:
    return BlockTable(
        keys=torch.full((capacity,), INVALID_KEY, dtype=torch.int32, device=device),
        slot_of=torch.arange(capacity, dtype=torch.int32, device=device),
        key_of_slot=torch.full((capacity,), INVALID_KEY, dtype=torch.int32, device=device),
        sdf=torch.zeros((capacity + 1, NVOX), dtype=torch.float32, device=device),
        weight=torch.zeros((capacity + 1, NVOX), dtype=torch.float32, device=device),
        color=torch.zeros((capacity + 1, 3 * NVOX), dtype=torch.float32, device=device),
    )


def pack_key(block_coord: torch.Tensor) -> torch.Tensor:
    """[..., 3] int32 block coords -> packed int32 key; out-of-range -> INVALID."""
    c = block_coord.to(torch.int32) + _OFF
    in_range = torch.all((c >= 0) & (c < 1024), dim=-1)
    key = c[..., 0] | (c[..., 1] << 10) | (c[..., 2] << 20)
    return torch.where(in_range, key, INVALID_KEY)


def unpack_key(key: torch.Tensor) -> torch.Tensor:
    """packed int32 -> [..., 3] int32 block coords (INVALID gives garbage)."""
    x = (key & 1023) - _OFF
    y = ((key >> 10) & 1023) - _OFF
    z = ((key >> 20) & 1023) - _OFF
    return torch.stack([x, y, z], dim=-1)


def lower_bound(sorted_keys: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """#(sorted_keys < q) per query (int64)."""
    return torch.searchsorted(sorted_keys, query.contiguous(), side="left")


def lookup(table: BlockTable, query: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Find DATA slots of packed keys. Returns (slot [...] int32, found [...]).

    Not-found queries return slot 0 with found=False — callers mask.
    """
    idx = torch.clamp(lower_bound(table.keys, query), 0, table.capacity - 1)
    found = (table.keys[idx] == query) & (query != INVALID_KEY)
    slot = table.slot_of[idx]
    return torch.where(found, slot, 0).to(torch.int32), found


def world_to_block(p: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """World points [..., 3] -> integer block coords [..., 3]."""
    return torch.floor(p / (BLOCK * voxel_size)).to(torch.int32)


def block_origin(block_coord: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Block coord [..., 3] -> world position of its (0,0,0) voxel corner."""
    return block_coord.to(torch.float32) * (BLOCK * voxel_size)


def voxel_centers(block_coord: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """[..., 3] block coords -> [..., 8, 8, 8, 3] world centres (x fastest)."""
    g = torch.arange(BLOCK, dtype=torch.float32, device=block_coord.device) + 0.5
    zz, yy, xx = torch.meshgrid(g, g, g, indexing="ij")
    local = torch.stack([xx, yy, zz], dim=-1) * voxel_size
    org = block_origin(block_coord, voxel_size)
    return org[..., None, None, None, :] + local


def compact_sorted(vals: torch.Tensor, keep: torch.Tensor, out_capacity: int) -> torch.Tensor:
    """Stable-compact ``vals[keep]`` along the last axis to [..., out_capacity],
    INVALID_KEY-padded (a cumsum + scatter; dropped rows land in a trash
    column that is sliced off)."""
    pos = torch.cumsum(keep.to(torch.int64), dim=-1) - 1
    pos = torch.where(keep & (pos < out_capacity), pos, out_capacity)
    out = torch.full(
        vals.shape[:-1] + (out_capacity + 1,), INVALID_KEY, dtype=vals.dtype, device=vals.device
    )
    out.scatter_(-1, pos, vals)
    return out[..., :out_capacity]


def dedup_keys_counted(keys: torch.Tensor, out_capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort + drop duplicates + compact to [..., out_capacity] along the last
    axis; also returns how many unique keys the capacity cut DROPPED (int32).
    The deterministic replacement for atomic hash insertion."""
    s, _ = torch.sort(keys, dim=-1)
    first = torch.ones_like(s, dtype=torch.bool)
    first[..., 1:] = s[..., 1:] != s[..., :-1]
    valid_first = first & (s != INVALID_KEY)
    n_uniq = torch.sum(valid_first, dim=-1).to(torch.int32)
    truncated = torch.clamp(n_uniq - out_capacity, min=0)
    return compact_sorted(s, valid_first, out_capacity), truncated


def dedup_keys(keys: torch.Tensor, out_capacity: int) -> torch.Tensor:
    return dedup_keys_counted(keys, out_capacity)[0]


def allocate(
    table: BlockTable, new_keys: torch.Tensor, assume_unique_sorted: bool = False
) -> tuple[BlockTable, torch.Tensor]:
    """Insert blocks for ``new_keys`` (packed, possibly duplicated/INVALID).

    Returns (table, overflow count). Existing blocks keep their data slots;
    new blocks take slots from the free tail and have their voxel rows zeroed
    IN PLACE. Only the [C] index pair is rebuilt: a sorted merge of the old
    keys with the compacted new ones (one searchsorted each side).
    """
    cap = table.capacity
    dev = table.keys.device
    cand = new_keys if assume_unique_sorted else dedup_keys(new_keys, new_keys.shape[0])
    _, found = lookup(table, cand)
    cand = torch.where(found, INVALID_KEY, cand)

    num_free = cap - table.num_active()
    is_new = cand != INVALID_KEY
    rank = torch.cumsum(is_new.to(torch.int64), dim=0) - 1
    can_host = is_new & (rank < num_free)
    overflow = torch.sum(is_new & ~can_host).to(torch.int32)
    cand = torch.where(can_host, cand, INVALID_KEY)

    # free data slots come from the END of the sorted index's free tail
    free_idx = torch.clamp(cap - 1 - rank, 0, cap - 1)
    assigned = torch.where(can_host, table.slot_of[free_idx], 0).to(torch.int32)

    # zero the newly assigned rows; masked rows hit the scratch row C
    zslots = torch.where(can_host, assigned, cap).to(torch.int64)
    for pool in (table.sdf, table.weight, table.color):
        pool.index_fill_(0, zslots, 0.0)
    key_of_slot = set_drop(table.key_of_slot, zslots, cand)

    a = cand.shape[0]
    pos_c = torch.where(can_host, rank, a)
    cand_c = torch.full((a + 1,), INVALID_KEY, dtype=torch.int32, device=dev)
    cand_c[pos_c] = cand
    cand_c = cand_c[:a]  # compacted sorted new keys (INVALID tail)
    slot_c = torch.zeros((a + 1,), dtype=torch.int32, device=dev)
    slot_c[pos_c] = assigned
    slot_c = slot_c[:a]
    pos_a = torch.arange(cap, device=dev) + lower_bound(cand_c, table.keys)
    pos_b = torch.arange(a, device=dev) + lower_bound(table.keys, cand_c)
    pos_b = torch.where(cand_c != INVALID_KEY, pos_b, cap)
    keys = torch.full((cap,), INVALID_KEY, dtype=torch.int32, device=dev)
    keys = set_drop(set_drop(keys, pos_a, table.keys), pos_b, cand_c)
    slot_of = torch.zeros((cap,), dtype=torch.int32, device=dev)
    slot_of = set_drop(set_drop(slot_of, pos_a, table.slot_of), pos_b, slot_c)
    return (
        dataclasses.replace(table, keys=keys, slot_of=slot_of, key_of_slot=key_of_slot),
        overflow,
    )


def garbage_collect(table: BlockTable) -> tuple[BlockTable, torch.Tensor]:
    """Drop blocks whose every voxel weight is zero. Only the index re-sorts;
    freed rows are zeroed lazily on reuse. Returns (table, num_freed)."""
    occupied = torch.any(table.weight[: table.capacity] > 0.0, dim=1)
    allocated = table.key_of_slot != INVALID_KEY
    freed = torch.sum(allocated & ~occupied).to(torch.int32)
    key_of_slot = torch.where(occupied & allocated, table.key_of_slot, INVALID_KEY)
    keys, order = torch.sort(key_of_slot, stable=True)
    return (
        dataclasses.replace(
            table, keys=keys, slot_of=order.to(torch.int32), key_of_slot=key_of_slot
        ),
        freed,
    )
