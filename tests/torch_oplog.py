"""Operation recording for the execution-model tests
(``test_torch_graphs.py``, ``test_torch_graphs_sharded.py``): a CUDA graph
replays exactly the launches it captured, so a stage is fit to be captured
once and replayed at every chunk only if it runs the same operations, with
the same argument shapes, dtypes and non-tensor arguments, at every chunk.
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def _arg(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype)
    return repr(x)


class OpLog(TorchDispatchMode):
    """Every operation, with its arguments described, under the current
    (chunk, stage) key."""

    def __init__(self):
        super().__init__()
        self.key = None
        self.ops: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # (the profiler's span markers are no device work)
        if self.key is not None and not str(func).startswith("profiler."):
            leaves, _ = tree_flatten((args, kwargs or {}))
            self.ops.setdefault(self.key, []).append((str(func), tuple(_arg(x) for x in leaves)))
        return func(*args, **(kwargs or {}))


def assert_same_ops(a: list, b: list, label: str) -> None:
    assert len(a) > 10
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    assert first is None and len(a) == len(b), (
        f"{label}: {len(a)} against {len(b)} operations; first difference at {first}: "
        f"{a[first] if first is not None else ''} / {b[first] if first is not None else ''}")
