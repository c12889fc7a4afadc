"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the port."""

import ast
import json
import os
import subprocess
import sys

from benchmark import spec

BENCH_DIR = os.path.join(spec.ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "bundlefusion_tpu"}


def imported_tops(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def sources(sub: str = ""):
    for dirpath, dirnames, files in os.walk(os.path.join(BENCH_DIR, sub)):
        dirnames[:] = [d for d in dirnames if d not in ("tests", "__pycache__")]
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax():
    for path in sources():
        assert not imported_tops(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in sources("reference"):
        tops = imported_tops(path)
        assert not tops & (FORBIDDEN | {"bundlefusion_tpu_torch", "chip_smoke"}), path
        assert tops <= {"__future__", "numpy", "torch"}, path


def test_loaded_modules_hold_no_jax():
    """Every module of the harness, the port's modules it loads and every
    reader, imported in a fresh process: no top-level name is forbidden."""
    readers = [m["name"] for m in spec.load()["per_layer"]]
    code = (
        "import sys, json\n"
        "import benchmark.run, benchmark.drive, benchmark.judge, benchmark.trace, benchmark.calibrate\n"
        "import benchmark.reference.tsdf, benchmark.scene.room, benchmark.scene.noise\n"
        "import bundlefusion_tpu_torch.bundle.pipeline, bundlefusion_tpu_torch.geometry.camera\n"
        "from benchmark import spec\n"
        f"[spec.reader(m) for m in {readers!r}]\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "bundlefusion_tpu_torch" in tops
    assert not tops & FORBIDDEN
