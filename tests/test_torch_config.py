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
        "bundlefusion_tpu_torch.eval.ate\n"
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
    "app_change,bundling_change",
    [
        (dict(integrate_filtered_depth=True), {}),
        (dict(integration_width=32, integration_height=24), {}),
        ({}, dict(revalidate_every_chunks=2)),
    ],
)
def test_unported_settings_are_rejected(app_change, bundling_change):
    c = tcfg.tiny_test_config()
    c = dataclasses.replace(
        c,
        app=dataclasses.replace(c.app, **app_change),
        bundling=dataclasses.replace(c.bundling, **bundling_change),
    )
    with pytest.raises(NotImplementedError):
        BundleFusion(_cam(), c, device="cpu")


def test_streaming_check_raises_where_it_would_fire():
    c = tcfg.tiny_test_config()
    c = dataclasses.replace(c, app=dataclasses.replace(c.app, streaming_check_every=1))
    bf = BundleFusion(_cam(), c, device="cpu")
    frame = (np.full((48, 64), 2.0, np.float32), np.full((48, 64, 3), 0.5, np.float32))
    with pytest.raises(NotImplementedError, match="streaming"):
        for _ in range(c.bundling.chunk_size):
            bf.push_frame(*frame)
    assert bf.chunk_count == 0
    assert torch.all(bf.table.weight == 0)


def test_mesh_is_rejected():
    with pytest.raises(NotImplementedError, match="mesh"):
        BundleFusion(_cam(), tcfg.tiny_test_config(), mesh=object(), device="cpu")
