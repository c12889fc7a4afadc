"""The port's config mirror against the JAX package's, the port's import
boundary (no JAX), and the settings the port rejects."""

import dataclasses
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import bundlefusion_tpu.config as jcfg
import bundlefusion_tpu_torch.config as tcfg
from bundlefusion_tpu_torch.bundle.pipeline import BundleFusion
from bundlefusion_tpu_torch.geometry.camera import CameraModel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU; PyTorch's
    own thread pool per process would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["AppConfig", "BundlingConfig", "Config"])
def test_config_fields_and_defaults_match(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(jc)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tc)]
    assert jf == tf
    assert dataclasses.asdict(jc()) == dataclasses.asdict(tc())


def test_tiny_config_and_json_round_trip():
    jt, tt = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    assert dataclasses.asdict(jt) == dataclasses.asdict(tt)
    assert jt.to_json() == tt.to_json()
    assert tcfg.Config.from_json(jt.to_json()) == tt
    assert tt.bundling.chunk_size == jt.bundling.chunk_size


def test_port_imports_no_jax():
    code = (
        "import sys, bundlefusion_tpu_torch, bundlefusion_tpu_torch.bundle.pipeline, "
        "bundlefusion_tpu_torch.interop, bundlefusion_tpu_torch.io.synthetic, "
        "bundlefusion_tpu_torch.eval.ate, bundlefusion_tpu_torch.app, "
        "bundlefusion_tpu_torch.bundle.checkpoint, bundlefusion_tpu_torch.fusion.streaming, "
        "bundlefusion_tpu_torch.fusion.marching_cubes, bundlefusion_tpu_torch.fusion.raycast, "
        "bundlefusion_tpu_torch.io.ply, bundlefusion_tpu_torch.io.sens, bundlefusion_tpu_torch.io.tum, "
        "bundlefusion_tpu_torch.io.sensor, bundlefusion_tpu_torch.io.replayer, "
        "bundlefusion_tpu_torch.visualization, bundlefusion_tpu_torch.bench\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'bundlefusion_tpu.'))"
        " or m == 'bundlefusion_tpu']\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)
    imports = re.compile(r"^\s*(import|from)\s+(jax|bundlefusion_tpu)(\.|\s|$)", re.M)
    for path in (REPO / "bundlefusion_tpu_torch").rglob("*.py"):
        assert not imports.search(path.read_text()), path


def _cam(w=64, h=48):
    return CameraModel.create(0.9 * w, 0.9 * w, (w - 1) / 2, (h - 1) / 2, w, h)


@pytest.mark.parametrize(
    "app_change,shards,match",
    [
        # an integration resolution must integer-divide the input resolution
        (dict(integration_width=48, integration_height=36), 0, "integer-divide"),
        # a mesh's shard count must divide the 6 x max_num_images system rows
        ({}, 5, "192 rows"),
    ],
)
def test_settings_that_cannot_run_are_rejected(app_change, shards, match):
    from bundlefusion_tpu_torch.parallel.mesh import make_mesh

    c = tcfg.tiny_test_config()
    c = dataclasses.replace(c, app=dataclasses.replace(c.app, **app_change))
    with pytest.raises(ValueError, match=match):
        BundleFusion(_cam(), c, mesh=make_mesh(shards, "cpu") if shards else None, device="cpu")


def test_mesh_on_another_device_type_is_rejected():
    """The sharded solve copies the pipeline's tensors to the mesh's devices
    without waiting: between a card and the CPU that copy could be read
    before it lands, so a mesh must hold devices of the pipeline's type."""
    from bundlefusion_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="must be cpu devices"):
        BundleFusion(_cam(), tcfg.tiny_test_config(), mesh=make_mesh(2, "cuda:0"), device="cpu")


def test_streaming_check_runs_where_it_fires():
    """The streaming step runs at every streaming_check_every-th chunk until
    streaming engages, then at every chunk (with the default settings the
    first check is chunk 15)."""
    c = tcfg.tiny_test_config()
    c = dataclasses.replace(c, app=dataclasses.replace(c.app, streaming_check_every=3))
    bf = BundleFusion(_cam(), c, device="cpu")
    calls = []

    def step(k_idx, chunk):
        calls.append(chunk)
        bf._streaming_on = chunk >= 5  # engages at the second check

    bf._streaming_step = step
    frame = (np.full((48, 64), 2.0, np.float32), np.full((48, 64, 3), 0.5, np.float32))
    for _ in range(1 + 8 * c.bundling.submap_size):
        bf.push_frame(*frame)
    bf.sync()  # the chunk steps run on the ingest worker
    assert bf.chunk_count == 8
    assert calls == [2, 5, 6, 7]
    assert tcfg.AppConfig().streaming_check_every == 16

