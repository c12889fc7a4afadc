"""The port's bench (``bundlefusion_tpu_torch/bench.py``) against the JAX
package's ``bench.py``, as ``test_torch_tools.py`` holds the tools to theirs:

* the configuration: ``bench_config`` equals the ``Config`` that
  ``bench.py`` builds at its flagship and 320x240 sizes (``bench.py`` is
  stopped at its first pipeline, before it renders or compiles anything);
* end to end: both benches' ``main`` with the same environment (128x96,
  11 frames, 4,096 blocks, one timed pass, the noisy pass) on the same
  frames, rendered once by the JAX package (the two renderers differ in the
  last ulp at silhouettes). Both run the tiny test configuration at that
  size and pool instead of ``bench.py``'s, the same cut on both sides: its
  80x60 cache does not divide 128x96, and here its bundling (512 keys in 3
  octaves: about a minute of SIFT per chunk) and its 4,096-block
  ``blocks_per_frame_cap`` (the JAX fuse: ~26 s per chunk) take minutes per
  pass; 11 frames (3 chunks) keep the file near 150 s. The raw counters
  are equal, the ATEs within 1e-3 cm (one unit of the printed rounding),
  the JAX diagnostics' keys a subset of the port's, and the stage names of
  both timing tables equal;
* no fallback: the default device without a card raises.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import types

import numpy as np
import pytest
import torch

import bundlefusion_tpu.bundle.pipeline as jpipe
import bundlefusion_tpu.config as jcfg
import bundlefusion_tpu.io.synthetic as jsyn
import bundlefusion_tpu_torch.config as tcfg
import bundlefusion_tpu_torch.io.synthetic as tsyn
from bundlefusion_tpu.eval.ate import ate_rmse as jax_ate
from bundlefusion_tpu.io import framewire as jfw
from bundlefusion_tpu_torch import bench
from bundlefusion_tpu_torch.geometry.camera import CameraModel
from bundlefusion_tpu_torch.io import framewire as tfw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(BENCH_WIDTH="128", BENCH_HEIGHT="96", BENCH_FRAMES="11", BENCH_BLOCKS="4096", BENCH_PASSES="1",
              BENCH_NOISE="1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


@pytest.mark.parametrize("size", [(640, 480, 262144), (320, 240, 32768)])
def test_bench_config_matches_jax(monkeypatch, size):
    w, h, blocks = size
    seen = []

    def pipeline(cam, cfg, **kw):
        seen.append(cfg)
        raise _Stop

    monkeypatch.setattr(jsyn, "generate_sequence",
                        lambda *a, **k: types.SimpleNamespace(camera=None, poses=[None]))
    monkeypatch.setattr(jpipe, "BundleFusion", pipeline)
    for k, v in dict(BENCH_WIDTH=w, BENCH_HEIGHT=h, BENCH_BLOCKS=blocks).items():
        monkeypatch.setenv(k, str(v))
    with pytest.raises(_Stop):
        _jax_bench().main()
    assert len(seen) == 1
    assert dataclasses.asdict(bench.bench_config(w, h, blocks)) == dataclasses.asdict(seen[0])


def _tiny(tiny_config, width: int, height: int, block_capacity: int):
    """The tiny test configuration at a bench's frame size and pool."""
    c = tiny_config()
    return dataclasses.replace(c, app=dataclasses.replace(
        c.app, input_width=width, input_height=height, integration_width=width, integration_height=height,
        block_capacity=block_capacity))


@pytest.fixture(scope="module")
def both_benches():
    """Both benches' ``main`` on the same frames and configuration, on their
    numpy wire; returns the JAX pipelines and sequences, and each side's
    (return value, stdout lines, stderr lines)."""
    w, h, n = int(SMALL["BENCH_WIDTH"]), int(SMALL["BENCH_HEIGHT"]), int(SMALL["BENCH_FRAMES"])
    seq = jsyn.generate_sequence(n, width=w, height=h, radius=0.5)
    mp = pytest.MonkeyPatch()
    pipelines, seqs = [], {}

    class Recorded(jpipe.BundleFusion):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            pipelines.append(self)

    def rendered(num_frames, width, height, seed=0, radius=0.35):
        assert (num_frames, width, height, seed, radius) == (n, w, h, 0, 0.5)
        seqs["clean"] = seq
        return seq

    def noisy(s, *a, **k):
        seqs["noisy"] = jax_noise(s, *a, **k)
        return seqs["noisy"]

    def port_rendered(num_frames, width, height, seed=0, radius=0.35, device="cuda", batch=8):
        assert (num_frames, width, height, seed, radius, str(device)) == (n, w, h, 0, 0.5, "cpu")
        return tsyn.SyntheticSequence(seq.depth, seq.color, seq.poses, CameraModel(*seq.camera), seq.timestamps)

    blocks = int(SMALL["BENCH_BLOCKS"])
    jax_tiny = _tiny(jcfg.tiny_test_config, w, h, blocks)

    def jax_config(app, bundling):
        assert (app.input_width, app.input_height, app.block_capacity) == (w, h, blocks)
        return jax_tiny

    jax_noise = jsyn.apply_sensor_noise
    printed = {}
    try:
        for k, v in SMALL.items():
            mp.setenv(k, v)
        mp.setattr(jfw, "_load", lambda: None)
        mp.setattr(tfw, "_load", lambda: None)
        mp.setattr(jsyn, "generate_sequence", rendered)
        mp.setattr(jsyn, "apply_sensor_noise", noisy)
        mp.setattr(jpipe, "BundleFusion", Recorded)
        mp.setattr(jcfg, "Config", jax_config)
        mp.setattr(tsyn, "generate_sequence", port_rendered)
        mp.setattr(bench, "bench_config", lambda *a: _tiny(tcfg.tiny_test_config, *a))
        printed["jax"] = _run_printing(_jax_bench().main)
        printed["port"] = _run_printing(lambda: bench.main(["--device", "cpu"]))
    finally:
        mp.undo()
    return pipelines, seqs, printed


def _run_printing(fn):
    """(fn's return value, its stdout lines, its stderr lines)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        ret = fn()
    return ret, out.getvalue().splitlines(), err.getvalue().splitlines()


def test_bench_end_to_end_matches_jax(both_benches):
    pipelines, seqs, printed = both_benches
    _, jout, jerr = printed["jax"]
    (result, diag, counters), tout, terr = printed["port"]
    jres, jdiag = json.loads(jout[-1]), json.loads(jerr[-1])
    assert json.loads(tout[-1]) == result and json.loads(terr[-1]) == diag
    print("jax", jres, {k: v for k, v in jdiag.items() if k != "timing"})
    print("port", result, {k: v for k, v in diag.items() if k != "timing"}, counters)

    # the pipelines bench.py ran: warm, the timed pass, noisy
    assert len(pipelines) == 3 and counters["pipelines"] == 3
    _, timed, noisy = pipelines
    jo, jn = timed.outputs(), noisy.outputs()  # bench.py finalized both; outputs() is idempotent
    assert counters["gn_iters_executed"] == timed.gn_iters_executed
    assert counters["blocks_updated"] == float(np.asarray(timed.blocks_updated))
    assert counters["num_keyframes"] == jo.num_keyframes == jdiag["keyframes"] == diag["keyframes"]
    assert counters["active_blocks"] == int(timed.table.num_active()) == jdiag["blocks"] == diag["blocks"]
    assert diag["noisy_valid_fraction"] == jdiag["noisy_valid_fraction"]
    m = min(len(jn.poses), len(seqs["noisy"].poses))
    assert counters["noisy_valid_fraction"] == float(np.asarray(jn.valid[:m]).mean())

    def ate(out, seq):
        k = min(len(out.poses), len(seq.poses))
        return jax_ate(out.poses[:k], seq.poses[:k], valid=out.valid[:k])

    assert abs(counters["ate_m"] - ate(jo, seqs["clean"])) * 100 <= 1e-3
    assert abs(counters["ate_noisy_m"] - ate(jn, seqs["noisy"])) * 100 <= 1e-3

    assert set(jdiag) <= set(diag), set(jdiag) - set(diag)
    assert set(jres) == set(result) == {"metric", "value", "unit", "vs_baseline"}
    assert result["metric"] == jres["metric"] == "end_to_end_fps"
    assert result["unit"] == f"frames/sec ({SMALL['BENCH_WIDTH']}x{SMALL['BENCH_HEIGHT']}, full pipeline, 1 cpu)"
    assert len(diag["fps_passes"]) == 1 and result["value"] == round(diag["fps_passes"][0], 2)
    assert sorted(diag["timing"]["warm_profiled"]) == sorted(jdiag["timing"]["warm_profiled"])
    assert sorted(diag["timing"]["timed"]) == sorted(jdiag["timing"]["timed"])


def test_bench_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
