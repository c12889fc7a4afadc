"""Kernel K3 (the normal-equation assembly, ``csrc/assemble.cu``) built
from several sources and timed against each other on one card, in turns.

    python -m bundlefusion_tpu_torch.tools.k3_compare NAME=SOURCE[:DEF,...] ... [--cases a,b] [--rounds 4]
        [--noflood] [--out FILE]

Run from the repo root: the cases are ``chip_smoke.py``'s (``k3_cases``).
Each SOURCE defines ``bf_assemble`` with the C interface of
``csrc/assemble.cu``: today's, which takes a scratch buffer sized by
``bf_assemble_scratch_bytes``, or the one-launch design's without it (an
older ``assemble.cu``, e.g. from ``git show <commit>:...``). Each compiles
alone with the port's nvcc flags, plus ``-D`` for each DEF, into
``_build/k3_<NAME>.so``; all build at once. For every case each build's
result is compared with the twin (a variant with parts compiled out is not
bit-equal, and says so), then each build is timed in ``--rounds``
rounds whose order alternates (A B, B A, ...), two ways: ``ms``, CUDA
events around five back-to-back calls (``chip_smoke.cuda_ms``, which a
kernel shorter than the wrapper's host time cannot go below), and
``graph_ms``, twenty calls captured in a CUDA graph and replayed
(``chip_smoke.graph_ms``: the device time per call, as a captured stage
runs it); the medians over the rounds are reported. ``--noflood`` adds
the flagship fill with its empty slots' indices moved out of range: the
kernel drops them, H is unchanged, and the slots that every design must
read as zeros at cell (0, 0) are gone.

Prints one JSON line per case and writes the list to ``--out``. Needs a
card; there is no CPU route.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def build_all(specs: list[tuple[str, str, list[str]]]) -> dict[str, str]:
    """Compile every (name, source, defines) at once; returns name -> .so path."""
    from bundlefusion_tpu_torch import kernels

    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, src, defs in specs:
        out = os.path.join(kernels.BUILD_DIR, f"k3_{name}.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *(f"-D{d}" for d in defs), "-shared", "-o", out, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    paths = {}
    for name, (p, out) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} ({p.returncode}):\n{log[-4000:]}")
        paths[name] = out
    return paths


def launcher(torch, path: str):
    """``run(n, pa, pb, JtJ, Jtr, free, damping) -> (H, b)`` through the
    ``bf_assemble`` of the library at ``path``."""
    lib = ctypes.CDLL(path)
    fn = lib.bf_assemble
    scratch = hasattr(lib, "bf_assemble_scratch_bytes")
    if scratch:
        lib.bf_assemble_scratch_bytes.argtypes = [_I, _I]
        lib.bf_assemble_scratch_bytes.restype = ctypes.c_longlong
        fn.argtypes = [_P] * 2 + [_I] + [_P] * 6 + [_I, _I, _F, _F, _P]
    else:
        fn.argtypes = [_P] * 2 + [_I] + [_P] * 5 + [_I, _I, _F, _F, _P]
    fn.restype = ctypes.c_int

    def run(n, pa, pb, JtJ, Jtr, free, damping):
        dev = JtJ.device
        p = JtJ.shape[0]
        H = torch.empty((6 * n, 6 * n), dtype=torch.float32, device=dev)
        b = torch.empty(6 * n, dtype=torch.float32, device=dev)
        common = (pa.data_ptr(), pb.data_ptr(), int(pa.dtype == torch.int64), JtJ.data_ptr(), Jtr.data_ptr(),
                  free.data_ptr(), H.data_ptr(), b.data_ptr())
        stream = torch.cuda.current_stream(dev).cuda_stream
        if scratch:
            buf = torch.empty(int(lib.bf_assemble_scratch_bytes(n, p)), dtype=torch.uint8, device=dev)
            err = fn(*common, buf.data_ptr(), n, p, damping, 1e-8, stream)
        else:
            err = fn(*common, n, p, damping, 1e-8, stream)
        if err:
            raise RuntimeError(f"bf_assemble of {path} failed: cudaError {err}")
        return H, b

    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("builds", nargs="+", help="NAME=SOURCE[:DEF,DEF...]")
    ap.add_argument("--cases", default=None, help="comma-separated case names (default: all)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--noflood", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke
    from bundlefusion_tpu_torch import bench
    from bundlefusion_tpu_torch.solver import system

    if not torch.cuda.is_available():
        raise SystemExit("k3_compare needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    specs = []
    for spec in args.builds:
        name, rest = spec.split("=", 1)
        src, _, defs = rest.partition(":")
        specs.append((name, src, [d for d in defs.split(",") if d]))
    runs = {name: launcher(torch, path) for name, path in build_all(specs).items()}
    names = list(runs)
    cases = chip_smoke.k3_cases(chip_smoke.flagship_config().bundling)
    if args.noflood:
        make, damping = cases["global_7_keyframes"]
        cases["global_7_keyframes_noflood"] = (make, damping)
    wanted = args.cases.split(",") if args.cases else list(cases)
    device = bench.device_line(dev)
    results = []
    for case in wanted:
        make, damping = cases[case]
        arrays = make()
        pa, pb, JtJ, Jtr, free = (torch.as_tensor(a, device=dev) for a in arrays)
        n = free.shape[0]
        Ht, bt = system._assemble_system_torch(n, pa, pb, JtJ, Jtr, free, damping)
        if case.endswith("_noflood"):  # the empty slots (all-zero blocks) out of range
            empty = ~(JtJ != 0).flatten(1).any(1) & ~(Jtr != 0).any(1)
            pa, pb = torch.where(empty, n, pa), torch.where(empty, n, pb)
        args_k = (n, pa, pb, JtJ, Jtr, free, damping)
        rec = dict(case=case, n=n, slots=JtJ.shape[0], device=device, bit_equal={})
        for name in names:
            H, b = runs[name](*args_k)
            torch.cuda.synchronize()
            rec["bit_equal"][name] = bool(
                torch.equal(H, Ht) and torch.equal(b, bt)
                and torch.equal(torch.signbit(H), torch.signbit(Ht)) and torch.equal(torch.signbit(b), torch.signbit(bt)))
        samples = {name: ([], []) for name in names}
        for r in range(args.rounds):
            for name in (names if r % 2 == 0 else names[::-1]):
                samples[name][0].append(chip_smoke.cuda_ms(torch, lambda: runs[name](*args_k)))
                samples[name][1].append(chip_smoke.graph_ms(torch, lambda: runs[name](*args_k)))
        rec["ms"] = {name: statistics.median(v[0]) for name, v in samples.items()}
        rec["graph_ms"] = {name: statistics.median(v[1]) for name, v in samples.items()}
        rec["samples"] = samples
        print(json.dumps(rec), flush=True)
        results.append(rec)
        del Ht, bt, JtJ, Jtr
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
