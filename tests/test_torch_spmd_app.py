"""The app's ``--multiseq 2`` route: the port's ``app.main`` on a 2-shard CPU
mesh against the JAX package's on 2 of its simulated devices, both on the
9 frames (2 chunks) per sequence at 128x96 that the port renders (the two
renderers differ in the last bits), with the tiny configuration as JSON.

Bars: per-sequence ATE within 1e-4 m and saved poses within 1e-4, the pose
bar of ``test_torch_pipeline.py``. The 2e-5 of the other pipeline tests does
not hold here: in sequence 0's first chunk, two SIFT keys of frame 3 whose
responses the JAX package computes equal (0.01882166) differ by 5e-8 in the
port, so they sort in the other order, the matcher's cap of 32 filtered
matches per pair keeps other correspondences, and the chunk's local poses
differ by 5.4e-5 (sequence 1: 2.8e-7; ROADMAP Queue 3). That moves sequence
0's TSDF (59 voxel weights differ) and its mesh, the one the app writes: its
triangle count is held within 1e-4 of the JAX app's (209,180 against
209,186). Sequence 1, whose poses agree, is held to the driver's bars: equal
block key sets, voxel weights equal but for at most 4 (the FMA-contraction
flips of ROADMAP Queue 3), and equal triangle counts.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from bundlefusion_tpu import app as japp
from bundlefusion_tpu.config import tiny_test_config as j_tiny
from bundlefusion_tpu.geometry.camera import CameraModel as JCameraModel
from bundlefusion_tpu.io import framewire as jfw
from bundlefusion_tpu.io import synthetic as jsyn
from bundlefusion_tpu.parallel import spmd_pipeline as jspmd
from bundlefusion_tpu_torch import app as tapp
from bundlefusion_tpu_torch import interop
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.fusion import marching_cubes as tmc
from bundlefusion_tpu_torch.fusion.blocks import INVALID_KEY
from bundlefusion_tpu_torch.io.synthetic import generate_sequence
from bundlefusion_tpu_torch.parallel import spmd_pipeline as tspmd

W, H, D = 128, 96, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record_outputs(monkeypatch, module, into: dict, side: str) -> None:
    """Keep the driver outputs that an app hands to ``extract_mesh_for``."""
    orig = module.extract_mesh_for

    def recording(outputs, seq_idx, cfg):
        into[side] = outputs
        return orig(outputs, seq_idx, cfg)

    monkeypatch.setattr(module, "extract_mesh_for", recording)


def _weights_by_key(jtab, ttab):
    """Both tables' voxel weights of the same blocks, in the port table's
    slot order (the block key sets must be equal)."""
    kj, kt = jtab.key_of_slot.numpy(), ttab.key_of_slot.numpy()
    live = np.flatnonzero(kt != INVALID_KEY)
    assert set(kj[kj != INVALID_KEY].tolist()) == set(kt[live].tolist())
    slot_of_j = {k: i for i, k in enumerate(kj.tolist())}
    rows = np.array([slot_of_j[k] for k in kt[live].tolist()])
    return jtab.weight.numpy()[rows], ttab.weight.numpy()[live]


def test_app_multiseq_matches_jax(tmp_path, monkeypatch):
    """``--multiseq 2``: the port's app against the JAX package's on the
    frames the port renders (the two renderers differ in the last bits)."""
    n = 9
    outs: dict = {}
    _record_outputs(monkeypatch, tspmd, outs, "port")
    _record_outputs(monkeypatch, jspmd, outs, "jax")
    c = t_tiny()
    c = dataclasses.replace(c, app=dataclasses.replace(c.app, input_width=W, input_height=H,
                                                       integration_width=W, integration_height=H))
    (tmp_path / "app.json").write_text(json.dumps(dataclasses.asdict(c.app)))
    (tmp_path / "bundling.json").write_text(json.dumps(dataclasses.asdict(c.bundling)))
    common = ["--synthetic", str(n), "--width", str(W), "--height", str(H), "--multiseq", str(D),
              "--app-config", str(tmp_path / "app.json"), "--bundling-config", str(tmp_path / "bundling.json")]
    assert tapp.main([*common, "--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    frames = {s: generate_sequence(n, width=W, height=H, seed=s, device="cpu") for s in range(D)}

    def rendered(num_frames, width, height, seed=0, radius=0.35):
        t = frames[seed]
        return jsyn.SyntheticSequence(t.depth, t.color, t.poses, JCameraModel(*tuple(t.camera)), t.timestamps)

    monkeypatch.setattr(jsyn, "generate_sequence", rendered)
    monkeypatch.setattr(jfw, "_load", lambda: None)
    assert japp.main([*common, "--out", str(tmp_path / "jax")]) == 0
    sj = json.loads((tmp_path / "jax" / "summary.json").read_text())
    st = json.loads((tmp_path / "port" / "summary.json").read_text())
    assert st["sequences"] == sj["sequences"] == D and st["keyframes_per_seq"] == sj["keyframes_per_seq"]
    print(f"app --multiseq: ATE jax {sj['ate_rmse_m']}, port {st['ate_rmse_m']}")
    for i in map(str, range(D)):
        assert abs(st["ate_rmse_m"][i] - sj["ate_rmse_m"][i]) <= 1e-4
    for i in range(D):
        pt, pj = (np.load(tmp_path / side / f"trajectory_{i}.npy") for side in ("port", "jax"))
        assert pt.shape == pj.shape == (n, 4, 4)
        err = float(np.abs(pt - pj).max())
        print(f"sequence {i}: max |pose jax - port| {err:.3g}")
        assert err <= 1e-4, i
    head = (tmp_path / "jax" / "mesh_0.ply").read_bytes().split(b"end_header")[0].decode()
    faces_j = int(next(x for x in head.splitlines() if x.startswith("element face")).split()[-1])
    print(f"mesh_0 triangles: jax {faces_j}, port {st['mesh_triangles']}")
    # sequence 0: the key-order flip moves the poses, and with them the
    # TSDF (59 voxel weights and the count differ)
    assert abs(st["mesh_triangles"] - faces_j) <= 1e-4 * faces_j
    # sequence 1, whose poses agree: the TSDF by block key and the mesh
    ttab = outs["port"].tables[1]
    wgt_j, wgt_t = _weights_by_key(interop.stacked_from_numpy(outs["jax"].tables, ["cpu"] * D)[1], ttab)
    flips = int((wgt_t != wgt_j).sum())
    jcfg = j_tiny()
    jcfg = dataclasses.replace(jcfg, app=dataclasses.replace(jcfg.app, input_width=W, input_height=H,
                                                               integration_width=W, integration_height=H))
    faces_j1 = len(jspmd.extract_mesh_for(outs["jax"], 1, jcfg)[2])
    faces_t1 = len(tmc.extract_mesh(ttab, c.app)[2])
    print(f"sequence 1: {flips} voxel weights differ; triangles jax {faces_j1}, port {faces_t1}")
    assert flips <= 4 and faces_t1 == faces_j1


def test_multiseq_requires_synthetic(tmp_path):
    with pytest.raises(SystemExit, match="--synthetic"):
        tapp.main(["--tum", str(tmp_path), "--multiseq", "2", "--out", str(tmp_path / "o"), "--device", "cpu"])
