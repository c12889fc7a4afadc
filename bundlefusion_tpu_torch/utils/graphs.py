"""CUDA graphs for the chunk step: the port's counterpart of ``jax.jit`` with
donated arguments.

The JAX package runs each stage of the chunk step as one compiled XLA
program and donates the state's buffers to it; one program serves every
chunk, and jit's process-wide cache serves every pipeline of the same
configuration. Here:

  * capture once  ≙ compile: a :class:`Program`'s first call on a card runs
    its function eagerly on the real inputs (the warm-up: lazy
    initialisation, library handles and kernel loading happen outside any
    capture, and the call's work is this run's), then captures the function
    on the caller's current stream into a ``torch.cuda.CUDAGraph`` (a
    capture runs nothing) and copies the eager run's results into the
    graph's output buffers. So a program captures at its first call, which
    a stage that runs once per pipeline needs (chunk 0's graph step): the
    first pipeline of a configuration captures it, every later one replays
    it. The graphs of one :class:`Executable` draw on one memory pool;
  * replay ≙ dispatch: every later call replays the graph, one launch;
  * in-place update of persistent state ≙ donation: a program's inputs are
    the same tensors at every call (checked: a replay against inputs at
    other addresses raises), and it writes its results into them.

The programs of an executable share its pool: a graph's outputs may lie
where a program captured before it keeps its temporaries. So read a
program's outputs before another program of the executable runs (the chunk
step's only such output, ``chunk_local``'s, is read by the graph step right
after it, and ``chunk_local`` is always captured first).

An :class:`ExecutableCache` keeps executables (their programs and the state
they address) by key, as jit's cache keeps compiled programs by
configuration and shapes; a pipeline checks one out and returns it when it
is garbage-collected. Two live owners never share an executable.

On the CPU a program calls its function directly (its owner passes
``graphed=False``): the caller asked for the CPU, and there is no graph to
capture. A pipeline built under :func:`disable_graphs` (the counterpart of
``jax.disable_jit()``) runs its programs eagerly on a card too. On a card, a
capture or a replay that fails raises; nothing falls back to the eager step.

Launch counts: a kernel wrapper registered with ``kernels.counted`` counts
its launches in ``.launches``. The warm-up's launches count (they ran); a
capture records the launches its function made and takes them back
(nothing ran), and every replay adds them again, so the counts stay one per
kernel launch on the device.
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


def route_for(device: torch.device) -> str:
    """How an owner built now on ``device`` runs its programs: ``"graph"``
    (captured and replayed), ``"eager: cpu"`` or ``"eager:
    disable_graphs()"``."""
    if device.type != "cuda":
        return "eager: cpu"
    return "graph" if graphs_enabled() else "eager: disable_graphs()"


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
    """One stage of the step: ``fn(*args)`` run eagerly and captured at its
    first call on a card, replayed from then on. ``graphed=False`` (what an
    owner on the CPU or built under :func:`disable_graphs` passes) calls
    ``fn`` every time."""

    def __init__(self, name: str, fn, pool):
        self.name, self.fn, self.pool = name, fn, pool
        self.graph: torch.cuda.CUDAGraph | None = None
        self.outputs = None
        self.warm = False  # fn has run eagerly on a card, as the warm-up of a capture
        self.replays = 0
        self.capture_s = 0.0
        self._signature: tuple | None = None
        self._launches: list[int] = []

    def __call__(self, *args, graphed: bool = True):
        if not graphed:
            return self.fn(*args)
        if self.graph is None:
            eager = self.fn(*args)
            self.warm = True
            self._capture(args)
            for dst, src in zip(_leaves(self.outputs, []), _leaves(eager, [])):
                if isinstance(dst, torch.Tensor) and dst is not src:
                    dst.copy_(src)
            return self.outputs
        if _signature(args) != self._signature:
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
    memory pool shared by all of them (they run one at a time, in stream
    order)."""

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

    def counters(self) -> dict[str, tuple[int, bool]]:
        """Per program: (replays, whether it has a graph); an owner takes
        them at checkout, and :meth:`stats` counts from there."""
        return {n: (p.replays, p.graph is not None) for n, p in self.programs.items()}

    def stats(self, start: dict[str, tuple[int, bool]], route) -> dict[str, dict]:
        """Per program since ``start`` (:meth:`counters` at checkout):
        ``graph`` (it has one), ``replays``, ``captured`` (since start),
        ``capture_s`` (of that capture) and ``route`` (``route(name)``: how
        the owner runs it)."""
        out = {}
        for name, p in self.programs.items():
            replays0, had_graph = start.get(name, (0, False))
            here = p.graph is not None and not had_graph
            out[name] = {"graph": p.graph is not None, "replays": p.replays - replays0, "captured": here,
                         "capture_s": p.capture_s if here else 0.0, "route": route(name)}
        return out


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
