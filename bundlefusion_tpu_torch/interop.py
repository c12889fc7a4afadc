"""State carried between the JAX package and the port, as numpy arrays.

The system has no weights: its state is the block table, the keyframe graph
and the trajectory (plus the caches and key sets inside them). The JAX
package holds each as a ``NamedTuple``; the port holds the same field names
in dataclasses. :func:`state_from_numpy` builds the port's dataclass from any
object with those fields (a JAX ``NamedTuple`` whose leaves convert with
``np.asarray``); :func:`state_to_numpy` returns nested dicts of numpy arrays.
This module imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .bundle.global_graph import GlobalGraph
from .bundle.trajectory import TrajectoryState
from .features.sift import SiftKeys
from .fusion.blocks import BlockTable
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
    """JAX state (``NamedTuple`` of arrays) -> the port's dataclass on ``device``.
    ``cls`` defaults to the port class of the same name as ``type(obj)``."""
    cls = cls or STATE_CLASSES[type(obj).__name__]
    out = {}
    for f in dataclasses.fields(cls):
        val = getattr(obj, f.name)
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
