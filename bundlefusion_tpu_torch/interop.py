"""State carried between the JAX package and the port, as numpy arrays.

The system has no weights: its state is the block table, the keyframe graph
and the trajectory (plus the caches and key sets inside them). The JAX
package holds each as a ``NamedTuple``; the port holds the same field names
in dataclasses. :func:`state_from_numpy` builds the port's dataclass from any
object with those fields (a JAX ``NamedTuple`` whose leaves convert with
``np.asarray``, or a dict by field name); :func:`state_to_numpy` returns
nested dicts of numpy arrays. A sharded state (the JAX package's stacked
``[D, ...]`` pytrees, e.g. ``ShardedOutputs.tables``) is a list of per-shard
dataclasses in the port: :func:`stacked_from_numpy` and
:func:`stacked_to_numpy` convert between the two. :func:`host_store_from`
copies a host block store (the streaming layer's cold blocks). This module
imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bundle.global_graph import GlobalGraph
from .bundle.trajectory import TrajectoryState
from .features.sift import SiftKeys
from .fusion.blocks import BlockTable
from .fusion.streaming import HostBlockStore
from .ops.preprocess import FrameCache
from .solver.residuals import SparseCorrs

STATE_CLASSES = {
    cls.__name__: cls
    for cls in (BlockTable, GlobalGraph, TrajectoryState, FrameCache, SiftKeys, SparseCorrs)
}
# nested state fields and the class each one holds
_NESTED = {("GlobalGraph", "keys"): SiftKeys, ("GlobalGraph", "cache"): FrameCache,
           ("GlobalGraph", "corrs"): SparseCorrs}


def state_from_numpy(obj, device, cls=None):
    """JAX state (``NamedTuple`` of arrays), or a dict of arrays by field
    name, -> the port's dataclass on ``device``. ``cls`` defaults to the port
    class of the same name as ``type(obj)``."""
    cls = cls or STATE_CLASSES[type(obj).__name__]
    out = {}
    for f in dataclasses.fields(cls):
        val = obj[f.name] if isinstance(obj, dict) else getattr(obj, f.name)
        sub = _NESTED.get((cls.__name__, f.name))
        if sub is not None:
            out[f.name] = state_from_numpy(val, device, sub)
        else:
            out[f.name] = torch.as_tensor(np.array(val), device=device)
    return cls(**out)


def state_to_numpy(state) -> dict:
    """The port's state dataclass -> nested dict of numpy arrays, by field name."""
    out = {}
    for f in dataclasses.fields(state):
        val = getattr(state, f.name)
        out[f.name] = state_to_numpy(val) if dataclasses.is_dataclass(val) else val.detach().cpu().numpy()
    return out


def _shard_of(obj, i: int):
    """Shard ``i`` of a stacked state, as a dict by field name (nested)."""
    if isinstance(obj, dict):
        return {k: _shard_of(v, i) for k, v in obj.items()}
    if hasattr(obj, "_fields"):  # a NamedTuple
        return {k: _shard_of(getattr(obj, k), i) for k in obj._fields}
    return np.asarray(obj)[i]


def stacked_from_numpy(obj, devices, cls=None) -> list:
    """A stacked state (leaves [D, ...]: a JAX ``NamedTuple`` or a dict by
    field name) -> one port dataclass per shard, shard i on ``devices[i]``.
    ``cls`` defaults to the port class of the same name as ``type(obj)``."""
    cls = cls or STATE_CLASSES[type(obj).__name__]
    return [state_from_numpy(_shard_of(obj, i), dev, cls) for i, dev in enumerate(devices)]


def stacked_to_numpy(states: list) -> dict:
    """Per-shard port states -> nested dict of stacked [D, ...] numpy arrays."""
    parts = [state_to_numpy(s) for s in states]

    def stack(items):
        if isinstance(items[0], dict):
            return {k: stack([x[k] for x in items]) for k in items[0]}
        return np.stack(items)

    return stack(parts)


def host_store_from(store) -> HostBlockStore:
    """Copy a host block store (the JAX package's or the port's: the same
    numpy layout) into a new port store: rows (keys, sdf, weight, colour),
    free list and chunk-grid index."""
    out = HostBlockStore(chunk_blocks=store.chunk_blocks)
    out._cap, out._n_live = store._cap, store._n_live
    out._keys, out._sdf = store._keys.copy(), store._sdf.copy()
    out._wgt, out._col = store._wgt.copy(), store._col.copy()
    out._free = list(store._free)
    out._chunks = {k: list(v) for k, v in store._chunks.items()}
    return out
