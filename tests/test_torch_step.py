"""The chunk step's one owner (``bundle/step.py``): both drivers run chunk c
through ``step.ChunkStep``, and the modules of the main path import one
way.

* layering: no module of ``parallel/`` imports an underscore name from
  ``bundle/``; ``bundle/step.py`` imports neither the serial driver
  (``pipeline``) nor the ingest, and ``bundle/ingest.py`` not the driver;
* one stage order: over three chunks of the tiny configuration (``gc``
  every second chunk), the serial pipeline and a one-shard multi-sequence
  run ask their executables for the same programs in the same order, at
  chunk 0 and after.
"""

import ast
import dataclasses
import pathlib

import pytest
import torch

from bundlefusion_tpu_torch.bundle.pipeline import BundleFusion
from bundlefusion_tpu_torch.config import tiny_test_config
from bundlefusion_tpu_torch.io.synthetic import generate_sequence
from bundlefusion_tpu_torch.parallel.mesh import make_mesh
from bundlefusion_tpu_torch.parallel.spmd_pipeline import ShardedRun
from bundlefusion_tpu_torch.utils import graphs

PORT = pathlib.Path(__file__).resolve().parents[1] / "bundlefusion_tpu_torch"
N = 13  # chunks 0-2 (S = 4)


def _imports(path: pathlib.Path) -> list[tuple[str, str]]:
    """(module, name) of every import in ``path``, the module resolved to a
    path inside the port (``bundle.step``), or as written outside it;
    ``import a.b`` gives (a.b, "")."""
    pkg = path.relative_to(PORT).parent.parts
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [(a.name.removeprefix("bundlefusion_tpu_torch."), "") for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = list(pkg[: len(pkg) - node.level + 1]) if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            mod = mod.removeprefix("bundlefusion_tpu_torch.")
            for a in node.names:
                # ``from . import step`` names a module
                out.append((f"{mod}.{a.name}", "") if not node.module else (mod, a.name))
    return out


def test_imports_point_one_way():
    for path in sorted((PORT / "parallel").glob("*.py")):
        private = [(m, n) for m, n in _imports(path) if m.startswith("bundle") and n.startswith("_")]
        assert not private, f"{path.name} imports private names of bundle/: {private}"
    for name, banned in (("step", ("pipeline", "ingest")), ("ingest", ("pipeline",))):
        mods = {m if not n else f"{m}.{n}" for m, n in _imports(PORT / "bundle" / f"{name}.py")}
        hits = sorted(m for m in mods for b in banned if m == f"bundle.{b}" or m.startswith(f"bundle.{b}."))
        assert not hits, f"bundle/{name}.py imports {hits}"


@pytest.fixture(scope="module")
def programs():
    """The program names each driver asked for, chunk by chunk."""
    c = tiny_test_config()
    cfg = dataclasses.replace(c, app=dataclasses.replace(c.app, gc_every_chunks=2))
    seq = generate_sequence(N, width=cfg.app.input_width, height=cfg.app.input_height, device="cpu")
    asked, at = [], {}
    program = graphs.Executable.program

    def spy(exe, name, fn):
        asked.append((at["chunk"], name))
        return program(exe, name, fn)

    mp = pytest.MonkeyPatch()
    mp.setattr(graphs.Executable, "program", spy)
    mp.setenv("BF_SYNC_INGEST", "1")  # chunks run on this thread, as they complete
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        bf = BundleFusion(seq.camera, cfg, anchor_pose=seq.poses[0], device="cpu")
        for i in range(N):
            at["chunk"] = max(0, (i - 1) // cfg.bundling.submap_size)  # the chunk frame i completes
            bf.push_frame(seq.depth[i], seq.color[i])
        bf.sync()
        serial, asked[:] = list(asked), []
        run = ShardedRun([seq], make_mesh(1, "cpu"), cfg, anchor_poses=seq.poses[:1])
        for k in range(run.n_chunks):
            at["chunk"] = k
            run.step(k)
        sharded = list(asked)
    finally:
        torch.set_num_threads(n)
        mp.undo()
    assert bf.chunk_count == run.n_chunks == 3
    return serial, sharded


def test_both_drivers_run_the_same_programs(programs):
    serial, sharded = programs
    assert serial == sharded
    by_chunk = [[name for c, name in serial if c == k] for k in range(3)]
    tier = f"graph_step@{tiny_test_config().bundling.max_num_images}"
    assert by_chunk == [
        ["chunk_local", "graph_step_first", "publish", "plan_fuse"],
        ["chunk_local", tier, "global_solve", "publish", "plan_fuse", "gc"],
        ["chunk_local", tier, "global_solve", "publish", "plan_fuse"],
    ]
