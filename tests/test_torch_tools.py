"""The developer tools of the port against the JAX package's ``tools/``:
``offline_matching`` prints the same statistics (key, match and inlier
counts and pair validity equal; rotation and translation within 1e-5), and
``profile_stages`` runs on the CPU at a tiny size and prints every line.
The pair's transform is held to JAX's in ``test_torch_features.py``
(``filter_pair``)."""

import importlib.util
import json
import os

import pytest
import torch

from bundlefusion_tpu_torch.tools import offline_matching, profile_stages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT = ("keys_a", "keys_b", "raw_matches", "filtered_matches", "pair_valid", "inliers")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stats(capsys, main, argv):
    assert main(argv) == 0
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


@pytest.mark.parametrize("args", [
    ["--synthetic", "8", "--frames", "0", "5", "--width", "64", "--height", "48"],
])
def test_offline_matching_matches_jax(capsys, tmp_path, args):
    j = _stats(capsys, _jax_tool("offline_matching").main, args + ["--out", str(tmp_path / "jax")])
    t = _stats(capsys, offline_matching.main, args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    print(j, t)
    for k in EXACT:
        assert j[k] == t[k], k
    for k in ("relative_rotation_rad", "relative_translation_m"):
        assert abs(j[k] - t[k]) <= 1e-5, k
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_profile_stages_prints_every_line(capsys):
    times = profile_stages.main(["32", "24", "--tiny", "--device", "cpu", "--reps", "1"])
    out = capsys.readouterr().out
    names = ["preprocess (K2)", "sift", "match_all_pairs", "filters", "dense_verify_filter (K5)",
             "local BA (GN+prune)", "opt-verify (K5)", "process_chunk FULL", "upd_keys_batch[9]", "upd_keys stride4",
             "union+allocate", "fuse_batch FULL (K1)"]
    assert list(times) == names and all(v > 0 for v in times.values())
    for name in names:
        assert f"\n{name}" in out, name
    for name in profile_stages.NO_COUNTERPART:
        assert f"{name}" in out and "no counterpart: replaced by K1's single launch" in out
