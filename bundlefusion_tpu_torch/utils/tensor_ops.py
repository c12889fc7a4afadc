"""Small tensor helpers that pin down JAX semantics PyTorch does not share.

* ``top_k``: ``lax.top_k`` breaks ties toward the lowest index;
  ``torch.topk`` promises no order. A stable descending sort does.
* ``set_drop``: JAX drops out-of-range scatter indices; torch raises (or
  trips a device assert). Rows to drop are routed to one scratch row past the
  end, which is sliced off, so no real row ever sees a duplicate write.
* ``deterministic``: CUDA ``index_add_`` accumulates with float atomics in a
  run-dependent order. Inside this context it takes PyTorch's sort-based
  deterministic path, which sums duplicates in index order, as the JAX
  package's CPU and TPU scatters do.
* ``row`` / ``put_row``: read or write row ``k`` of a tensor, ``k`` a 0-d
  index tensor on the device (the JAX step's traced index). Indexing with a
  0-d tensor would read it on the host, and a Python int would bake the row
  into a captured step, so both go through a 1-element index.
* ``copy_into``: the port's donation. A step's new state is written into the
  old state's tensors, which keep their storage (a captured CUDA graph
  addresses them).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Largest ``k`` along the last axis, ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def set_drop(dst: torch.Tensor, idx: torch.Tensor, vals, keep: torch.Tensor | None = None) -> torch.Tensor:
    """``dst.at[idx].set(vals, mode="drop")``: a new tensor in which rows with
    ``keep`` False or an index outside [0, len) are not written. Kept indices
    must be unique (as in every caller: JAX leaves their order unspecified)."""
    n = dst.shape[0]
    ok = (idx >= 0) & (idx < n)
    if keep is not None:
        ok = ok & keep
    idx = torch.where(ok, idx, n)
    buf = torch.cat([dst, dst[:1]])
    if isinstance(vals, torch.Tensor):
        buf[idx] = vals
    else:  # a Python scalar: fill on the device (a tensor from it would be a sync)
        buf.index_fill_(0, idx, vals)
    return buf[:n]


@contextlib.contextmanager
def deterministic():
    """Run the enclosed scatter-adds on PyTorch's deterministic kernels."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def _at(k: torch.Tensor) -> torch.Tensor:
    return k.reshape(1).long()


def row(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``x[k]`` for a 0-d index tensor ``k``, without a host read."""
    return x.index_select(0, _at(k))[0]


def put_row(x: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """``x[k] = v`` in place for a 0-d index tensor ``k``."""
    x.index_copy_(0, _at(k), v.to(x.dtype).unsqueeze(0))


def copy_into(dst, src) -> None:
    """Write every tensor of ``src`` into the tensor in the same field of
    ``dst`` (nested dataclasses of the same classes), in place. A field
    holding the very same tensor is left alone."""
    for f in dataclasses.fields(dst):
        d, s = getattr(dst, f.name), getattr(src, f.name)
        if s is d:
            continue
        if isinstance(d, torch.Tensor):
            d.copy_(s)
        elif dataclasses.is_dataclass(d):
            copy_into(d, s)
        else:
            raise TypeError(f"copy_into: field {f.name} holds {type(d).__name__}, not state")
