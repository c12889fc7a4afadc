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
"""

from __future__ import annotations

import contextlib

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
