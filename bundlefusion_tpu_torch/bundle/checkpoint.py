"""Checkpoint / resume of the whole pipeline state
(port of ``bundlefusion_tpu.bundle.checkpoint``).

The format is the port's own. The port cannot read the JAX package's file
(that pickle holds ``bundlefusion_tpu`` classes, which the port does not
import), and the JAX package cannot read this one. Device state is stored as
dicts of numpy arrays by field name (``interop.state_to_numpy``), beside the
JAX package's host fields plus the frames waiting for the next chunk, so a
restored pipeline continues exactly where the saved one stood.

Three device arrays are stored sparsely, because at the flagship sizes they
are gigabytes of which a run touches little: the block pools keep the rows
of allocated blocks only (a free row is never read: allocation zeroes it),
the frame ring its resident slots only, and the per-frame update records the
frames seen so far. Load only files this program wrote: unpickling runs
code.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..config import Config
from ..fusion.blocks import INVALID_KEY
from ..geometry.camera import CameraModel
from ..interop import state_from_numpy, state_to_numpy
from ..utils.tensor_ops import copy_into
from .global_graph import GlobalGraph
from .pipeline import BundleFusion, DeviceCtrl
from .trajectory import TrajectoryState

# device state: fields of the pipeline's FusionState
_STATES = {"graph": GlobalGraph, "traj": TrajectoryState, "ctrl": DeviceCtrl}
_DENSE = ("ring_frame", "local_trajs", "chunk_valid", "runlog_rows", "blocks_updated", "gc_freed_total")
# host state: pipeline attribute -> key in the file (the JAX package's keys)
_HOST_FIELDS = {
    "num_frames": "num_frames",
    "num_keyframes": "num_keyframes",
    "chunk_count": "chunk_count",
    "_next_fid": "next_fid",
    "anchor": "anchor",
    "_frame_store": "frame_store",
    "gn_iters_executed": "gn_iters_executed",
    "_reloc_seen": "reloc_seen",
    "_streaming_on": "streaming_on",
    "_ring_uploads": "ring_uploads",
    "block_store": "block_store",
    "_pending": "pending",
}


def _rows(t: torch.Tensor, idx: torch.Tensor) -> np.ndarray:
    return t[idx].cpu().numpy()


def save_checkpoint(bf: BundleFusion, path: str) -> None:
    """Serialize the full pipeline state to one file."""
    bf.sync()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    st = bf.state
    dev = {name: state_to_numpy(getattr(st, name)) for name in _STATES}
    dev.update({name: getattr(st, name).cpu().numpy() for name in (*_DENSE, "dense_counts")})
    t = st.table
    live = torch.nonzero(t.key_of_slot != INVALID_KEY).reshape(-1)
    dev["table"] = {
        "keys": t.keys.cpu().numpy(), "slot_of": t.slot_of.cpu().numpy(), "key_of_slot": t.key_of_slot.cpu().numpy(),
        "live": live.cpu().numpy(), "sdf": _rows(t.sdf, live), "weight": _rows(t.weight, live),
        "color": _rows(t.color, live),
    }
    ring = torch.nonzero(st.ring_frame >= 0).reshape(-1)
    dev["ring"] = {"slots": ring.cpu().numpy(), "d16": _rows(st.hist_d16, ring), "c8": _rows(st.hist_c8, ring)}
    n = bf.num_frames
    dev["upd"] = {"masks": st.upd_masks[:n].cpu().numpy(), "keys": st.upd_keys[:n].cpu().numpy()}
    host = {key: getattr(bf, name) for name, key in _HOST_FIELDS.items()}
    host["config_json"] = bf.config.to_json()
    host["camera"] = tuple(bf.cam)
    with open(path, "wb") as f:
        pickle.dump({"device": dev, "host": host}, f)


def load_checkpoint(path: str, *, device: torch.device | str = "cuda") -> BundleFusion:
    """Restore a pipeline onto ``device``; it is ready to keep consuming
    frames."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    host, dev = data["host"], data["device"]
    bf = BundleFusion(
        CameraModel(*host["camera"]), Config.from_json(host["config_json"]), anchor_pose=host["anchor"], device=device
    )

    def put(x):
        return torch.as_tensor(np.asarray(x), device=bf.device)

    # in place, on the pipeline's stream: the state's storage is its
    # executable's (captured graphs address it)
    st = bf.state
    with bf._device_ctx():
        for name, cls in _STATES.items():
            copy_into(getattr(st, name), state_from_numpy(dev[name], bf.device, cls))
        for name in _DENSE:
            getattr(st, name).copy_(put(dev[name]))
        if "dense_counts" in dev:  # a checkpoint from before the dense-term counters: they stay 0
            st.dense_counts.copy_(put(dev["dense_counts"]))
        tab = dev["table"]
        t = st.table
        for name in ("keys", "slot_of", "key_of_slot"):
            getattr(t, name).copy_(put(tab[name]))
        live = put(tab["live"])
        t.sdf[live], t.weight[live], t.color[live] = put(tab["sdf"]), put(tab["weight"]), put(tab["color"])
        ring = put(dev["ring"]["slots"])
        st.hist_d16[ring], st.hist_c8[ring] = put(dev["ring"]["d16"]), put(dev["ring"]["c8"])
        n = host["num_frames"]
        st.upd_masks[:n], st.upd_keys[:n] = put(dev["upd"]["masks"]), put(dev["upd"]["keys"])
    for name, key in _HOST_FIELDS.items():
        setattr(bf, name, host[key])
    return bf
