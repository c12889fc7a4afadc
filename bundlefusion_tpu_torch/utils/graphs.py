"""CUDA graphs for the chunk step: the port's counterpart of ``jax.jit`` with
donated arguments.

The JAX package runs each stage of the chunk step as one compiled XLA
program and donates the state's buffers to it; one program serves every
chunk, and jit's process-wide cache serves every pipeline of the same
configuration. Here:

  * capture once  ≙ compile: a :class:`Program` runs its function eagerly
    once (the warm-up: lazy initialisation and allocator growth happen
    outside any capture), then captures it on the caller's current stream
    into a ``torch.cuda.CUDAGraph`` whose memory comes from a pool shared
    by every program of one :class:`Executable`;
  * replay ≙ dispatch: every later call replays the graph, one launch;
  * in-place update of persistent state ≙ donation: a program's inputs are
    the same tensors at every call (checked: a replay against inputs at
    other addresses raises), and it writes its results into them.

An :class:`ExecutableCache` keeps executables (their programs and the state
they address) by key, as jit's cache keeps compiled programs by
configuration and shapes; a pipeline checks one out and returns it when it
is garbage-collected. Two live owners never share an executable.

On the CPU a program calls its function directly (its owner passes
``graphed=False``): the caller asked for the CPU, and there is no graph to
capture. A pipeline built under :func:`disable_graphs` (the counterpart of
``jax.disable_jit()``) runs its programs eagerly on a card too. On a card, a capture or a replay that fails raises; nothing falls back
to the eager step.

Launch counts: a kernel wrapper registered with ``kernels.counted`` counts
its launches in ``.launches``. A capture records the launches its function
made (and takes them back: nothing ran), and every replay adds them again,
so the counts stay one per kernel launch on the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import weakref
from collections import OrderedDict

import torch

from .. import kernels

_DISABLED = 0
_LOCK = threading.Lock()


@contextlib.contextmanager
def disable_graphs():
    """Run the chunk step eagerly on a card (``jax.disable_jit()``): a
    pipeline built inside this context never captures or replays. Nests;
    process-wide (the chunk step runs on worker threads)."""
    global _DISABLED
    with _LOCK:
        _DISABLED += 1
    try:
        yield
    finally:
        with _LOCK:
            _DISABLED -= 1


def graphs_enabled() -> bool:
    return _DISABLED == 0


def _leaves(obj, out: list) -> list:
    """The tensors and other values of a nest of dataclasses, tuples and
    lists, in order."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _leaves(getattr(obj, f.name), out)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _leaves(x, out)
    else:
        out.append(obj)
    return out


def _signature(args) -> tuple:
    """What a graph bakes in about its inputs: each tensor's address, shape,
    strides and dtype, and every other value."""
    return tuple(
        (x.data_ptr(), tuple(x.shape), x.stride(), x.dtype) if isinstance(x, torch.Tensor) else x
        for x in _leaves(args, [])
    )


def _launch_counts() -> list[int]:
    return [fn.launches for fn in kernels.COUNTED]


class Program:
    """One stage of the step: ``fn(*args)`` eager at its first call on a
    card, captured at its second, replayed from then on. ``graphed=False``
    (what an owner on the CPU or built under :func:`disable_graphs`
    passes) calls ``fn`` every time."""

    def __init__(self, name: str, fn, pool):
        self.name, self.fn, self.pool = name, fn, pool
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs = None
        self.warm = False
        self.replays = 0
        self.capture_s = 0.0
        self._signature: tuple | None = None
        self._launches: list[int] = []

    def __call__(self, *args, graphed: bool = True):
        if not graphed:
            return self.fn(*args)
        if self.graph is None:
            if not self.warm:
                self.warm = True
                return self.fn(*args)
            self._capture(args)
        elif _signature(args) != self._signature:
            raise RuntimeError(f"program {self.name}: replayed on other inputs than it was captured with "
                               "(a state tensor was rebound, not updated in place)")
        self.graph.replay()
        self.replays += 1
        for fn, n in zip(kernels.COUNTED, self._launches):
            fn.launches += n
        return self.outputs

    def _capture(self, args) -> None:
        t0 = time.perf_counter()
        before = _launch_counts()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        try:
            outputs = self.fn(*args)
        except BaseException:
            with contextlib.suppress(RuntimeError):  # the capture is invalid; the function's error is the one to see
                graph.capture_end()
            raise
        graph.capture_end()
        # the capture launched nothing: take back what the wrappers counted
        self._launches = [a - b for a, b in zip(_launch_counts(), before)]
        for fn, n in zip(kernels.COUNTED, self._launches):
            fn.launches -= n
        self.graph, self.outputs, self._signature = graph, outputs, _signature(args)
        self.capture_s = time.perf_counter() - t0


class Executable:
    """The programs of one step and what they address: ``state`` (whatever
    the owner keeps there), one stream to run and capture them on and one
    memory pool shared by all of them (they run in one order, one at a
    time, as they were captured)."""

    def __init__(self, device: torch.device, state):
        self.device = device
        self.state = state
        cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if cuda else None
        self._pool = torch.cuda.graph_pool_handle() if cuda else None
        self.programs: dict[str, Program] = {}

    def program(self, name: str, fn) -> Program:
        if name not in self.programs:
            self.programs[name] = Program(name, fn, self._pool)
        return self.programs[name]


class ExecutableCache:
    """Executables by key, each lent to one owner at a time. At most
    ``max_free`` idle executables are kept (least recently returned dropped
    first): each holds a pipeline's whole device state."""

    def __init__(self, max_free: int = 4):
        self.max_free = max_free
        self._free: OrderedDict[int, tuple] = OrderedDict()
        self._lock = threading.Lock()
        self._serial = 0

    def checkout(self, owner, key, build) -> tuple[Executable, bool]:
        """An idle executable of ``key``, or ``build()``'s; it returns to
        the cache when ``owner`` is garbage-collected. Returns (executable,
        reused)."""
        with self._lock:
            found = next((s for s, (k, _) in self._free.items() if k == key), None)
            exe = self._free.pop(found)[1] if found is not None else None
        reused = exe is not None
        if exe is None:
            exe = build()
        weakref.finalize(owner, self._checkin, key, exe)
        return exe, reused

    def _checkin(self, key, exe: Executable) -> None:
        with self._lock:
            self._serial += 1
            self._free[self._serial] = (key, exe)
            while len(self._free) > self.max_free:
                self._free.popitem(last=False)

    def clear(self) -> None:
        """Drop every idle executable (their graphs, pools and state)."""
        with self._lock:
            self._free.clear()
