"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each source compiles with its own nvcc for ``sm_90a``, all at once, and the
objects link into ONE shared library with a plain C interface, loaded with
ctypes (no PyTorch headers: a build takes seconds, not minutes). The build
runs at first use into ``_build/`` next to this file and reruns whenever a
source is newer than the library. Nothing is built or loaded at import:
CPU-only hosts import every module freely.

``-O3 --fmad=false`` and never ``--use_fast_math`` (it changes ``/``,
``exp`` and ``sqrt``): the kernels round op by op in the order of their plain
PyTorch twins.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("tsdf_integrate.cu", "preprocess.cu", "assemble.cu", "sift_sample.cu", "dense_verify.cu", "dense_pairs.cu",
           "pcg.cu", "stamp.cu")
LIB_PATH = os.path.join(BUILD_DIR, "libbf_kernels.so")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "bf_tsdf_fuse": [_P, _P, _P, _P, _I, _P, _L, _P, _L, _P, _L, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P]
    + [_F] * 8 + [_P],
    "bf_preprocess": [_P, _P, _P, _P, _I, _I, _I] + [_F] * 6 + [_I, _P],
    "bf_assemble": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _P],
    "bf_assemble_scratch_bytes": [_I, _I],
    "bf_sift_sample": [_P] * 8 + [_I] * 5 + [_F] * 4 + [_P],
    "bf_dense_verify": [_P] * 4 + [_L] + [_P] * 4 + [_L] + [_P] * 3 + [_I] * 4 + [_F] * 13 + [_P],
    "bf_dense_pairs": [_P] * 3 + [_I] + [_P] * 13 + [_I] * 5 + [_F] * 16 + [_P],
    "bf_pcg": [_P] * 6 + [_I, _I, _F, _I, _I, _I, _P],
    "bf_pcg_config": [_I, _IP, _IP, _IP],
    "bf_stamp": [_P, _P] + [_I] * 5 + [_P],
}
_RESTYPES = {"bf_assemble_scratch_bytes": _L}  # every other function returns its cudaError


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this host")
    return found


def build() -> float:
    """Compile ``csrc/*.cu`` into ``_build/libbf_kernels.so`` if it is missing
    or older than a source. Returns the seconds spent (0.0 when up to date).
    The ptxas report (registers, spills per kernel) goes to
    ``_build/build.log``."""
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    if (
        os.path.exists(LIB_PATH)
        and all(os.path.getmtime(LIB_PATH) >= os.path.getmtime(s) for s in srcs)
    ):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in srcs]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for s, o in zip(srcs, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    failed = [(s, p.returncode, log) for s, p, log in zip(srcs, procs, logs) if p.returncode != 0]
    tmp = f"{LIB_PATH}.{tag}"
    if not failed:
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(("link", link.returncode, link.stderr))
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write("\n".join(logs))
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if failed:
        src, rc, log = failed[0]
        raise RuntimeError(f"nvcc failed on {src} ({rc}):\n{log[-4000:]}")
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    build()
    lib = ctypes.CDLL(LIB_PATH)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib


# the kernel wrappers, each counting its kernel's launches in ``.launches``
# (a captured CUDA graph adds its kernels' launches at every replay)
COUNTED: list = []
_COUNT_LOCK = threading.Lock()  # wrappers launch from several threads (the pipeline's ingest workers)
_TALLY = threading.local()


def counted(fn):
    """Register a kernel wrapper whose ``.launches`` counts its launches."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def launched(fn) -> None:
    """Count one launch of ``fn``'s kernel: in ``fn.launches``, and in the
    calling thread's tally, which a graph capture reads (the eager launches
    another thread makes meanwhile are not the graph's)."""
    add_launches({fn: 1})
    tally = _TALLY.__dict__.setdefault("counts", {})
    tally[fn] = tally.get(fn, 0) + 1


def add_launches(counts: dict) -> None:
    """Add ``counts`` ({wrapper: launches}) to the wrappers' ``.launches``."""
    with _COUNT_LOCK:
        for fn, n in counts.items():
            fn.launches += n


def thread_launches() -> dict:
    """The calling thread's launches so far, by wrapper."""
    return dict(_TALLY.__dict__.get("counts", {}))


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(
    t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple | None = None, contiguous: bool = True
) -> None:
    """Validate a tensor handed to a kernel: device, dtype, shape and (for
    the ones the kernel reads by raw pointer) contiguity."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
