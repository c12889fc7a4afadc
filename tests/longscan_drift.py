"""Long-run drift, traced chunk by chunk: the JAX package's 81-frame
streaming corridor (``test_torch_longscan.py``'s configuration and frames)
through the JAX package twice, once as it is and once with one float32 ulp
moved in one place, and through the port; every global solve's input and
output poses are recorded in each run.

    JAX_PLATFORMS=cpu python tests/longscan_drift.py [--perturb global|local]

Prints, for the perturbed reference against the reference and for the port
against the reference: the largest pose gap by 20-frame window, the first
chunk whose streaming check differs, and per chunk the largest gap of the
global solve's input and output keyframe poses and the runlog counters that
differ. ``--perturb global`` (the default) moves keyframe 1's x translation
by one ulp after the first global solve (the port's global solves sum in
another order); ``--perturb local`` moves frame 1's x translation in chunk
0's local trajectory (the local solve's sums). Only the JAX package's public
functions are called; a perturbation wraps a module attribute for the run.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

# as tests/conftest.py sets it up, before jax is imported
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import test_torch_longscan as ls  # noqa: E402


def _ulp(x: np.ndarray, idx) -> np.ndarray:
    x = np.array(x, dtype=np.float32)
    x[idx] = np.nextafter(x[idx], np.float32(np.inf))
    return x


def _pair_counts(img_a, img_b, weight) -> dict:
    """Live correspondences per keyframe pair of the solve's input."""
    live = weight > 0
    keys, counts = np.unique(np.stack([img_a[live], img_b[live]], 1), axis=0, return_counts=True)
    return {(int(a), int(b)): int(n) for (a, b), n in zip(keys, counts)}


def run_jax(perturb: str | None = None):
    """The reference's run with each global solve's poses recorded."""
    import jax.numpy as jnp
    from bundlefusion_tpu.bundle import chunk as jchunk
    from bundlefusion_tpu.bundle import global_graph as jgg
    from bundlefusion_tpu.io.replayer import Replayer, SyntheticSource

    solves = []
    orig_solve, orig_chunk = jgg.global_solve, jchunk.process_chunk

    def solve(graph, cam, cfg):
        pre = np.asarray(graph.poses)
        g, stats, removed = orig_solve(graph, cam, cfg)
        if perturb == "global" and not solves:
            g = g._replace(poses=jnp.asarray(_ulp(g.poses, (1, 0, 3))))
        solves.append(dict(pre=pre, post=np.asarray(g.poses), cursor=int(g.corr_cursor),
                           pairs=_pair_counts(*map(np.asarray, (graph.corrs.img_a, graph.corrs.img_b,
                                                                graph.corrs.weight)))))
        return g, stats, removed

    calls = []

    def process_chunk(*a, **k):
        res = orig_chunk(*a, **k)
        if perturb == "local" and not calls:
            res = res._replace(local_traj=jnp.asarray(_ulp(res.local_traj, (1, 0, 3))))
        calls.append(1)
        return res

    jgg.global_solve, jchunk.process_chunk = solve, process_chunk
    try:
        seq = ls.generate_corridor_sequence(81, width=128, height=96, x_span=2.5)
        bf, out = ls.jax_run(Replayer(SyntheticSource(seq), batch_size=8), ls._cfg(ls.j_tiny),
                             anchor_pose=seq.poses[0])
    finally:
        jgg.global_solve, jchunk.process_chunk = orig_solve, orig_chunk
    return bf, out, solves


def run_port():
    import torch
    from bundlefusion_tpu.io.replayer import Replayer, SyntheticSource
    from bundlefusion_tpu_torch.bundle import global_graph as tgg

    solves = []
    orig = tgg.global_solve

    def solve(graph, cam, cfg):
        pre = graph.poses.clone().numpy()
        pairs = _pair_counts(*(x.numpy() for x in (graph.corrs.img_a, graph.corrs.img_b, graph.corrs.weight)))
        g, stats, removed = orig(graph, cam, cfg)
        solves.append(dict(pre=pre, post=g.poses.clone().numpy(), cursor=int(g.corr_cursor), pairs=pairs))
        return g, stats, removed

    tgg.global_solve = solve
    torch.set_num_threads(1)
    try:
        seq = ls.generate_corridor_sequence(81, width=128, height=96, x_span=2.5)
        bf, out = ls.port_run(Replayer(SyntheticSource(seq), batch_size=8), ls._cfg(ls.t_tiny),
                              anchor_pose=seq.poses[0], device="cpu")
    finally:
        tgg.global_solve = orig
    return bf, out, solves


def _stages_jax(graph, k: int, j: int, cam, cfg) -> dict:
    """The reference's filter stages for pair (j, k) of ``global_match``."""
    from bundlefusion_tpu.features import filters as jf
    from bundlefusion_tpu.features import matcher as jm
    from bundlefusion_tpu.geometry import se3 as jse3

    kj = jax.tree.map(lambda x: x[j], graph.keys)
    kn = jax.tree.map(lambda x: x[k], graph.keys)
    m = jm.match_pair(kj, kn, cfg)
    pa, pb = kj.p3d[m.idx_i], kn.p3d[m.idx_j]
    T, inl, kok = jf.kabsch_filter(pa, pb, m.valid, cfg)
    area = jf.surface_area_filter(pa, pb, inl, cfg)
    ca, cb = (jax.tree.map(lambda x: x[i], graph.cache) for i in (j, k))
    v1 = jf.dense_verify(ca, cb, T, cam, cfg)
    v2 = jf.dense_verify(cb, ca, jse3.mat_inverse(T), cam, cfg)
    return dict(matches=int(m.valid.sum()), inliers=int(inl.sum()), kabsch_ok=bool(kok), area_ok=bool(area),
                ok_frac=(float(v1.ok_frac), float(v2.ok_frac)), overlap=(float(v1.overlap), float(v2.overlap)),
                T=np.asarray(T))


def _stages_port(graph, k: int, j: int, cam, cfg) -> dict:
    """The port's filter stages for pair (j, k) of ``global_match``."""
    from bundlefusion_tpu_torch.features import filters as tf
    from bundlefusion_tpu_torch.features import matcher as tm
    from bundlefusion_tpu_torch.geometry import se3 as tse3

    g = graph
    m = tm.match_pairs(g.keys.desc[j], g.keys.valid[j], g.keys.desc[k], g.keys.valid[k], cfg)
    pa, pb = g.keys.p3d[j][m.idx_i], g.keys.p3d[k][m.idx_j]
    T, inl, kok = tf.kabsch_filter(pa, pb, m.valid, cfg)
    area = tf.surface_area_filter(pa, pb, inl, cfg)
    ca, cb = g.cache.index(j), g.cache.index(k)
    v1 = tf.dense_verify(ca, cb, T, cam, cfg)
    v2 = tf.dense_verify(cb, ca, tse3.mat_inverse(T), cam, cfg)
    return dict(matches=int(m.valid.sum()), inliers=int(inl.sum()), kabsch_ok=bool(kok), area_ok=bool(area),
                ok_frac=(float(v1.ok_frac), float(v2.ok_frac)), overlap=(float(v1.overlap), float(v2.overlap)),
                T=T.numpy())


def inspect(chunk: int, pair: int) -> None:
    """Both packages' global-match filter stages for pair (``pair``,
    ``chunk``) on the reference's and on the port's keyframe graph after
    that chunk: on one graph the two packages agree or a branch is
    mis-ported; across graphs the inputs decide."""
    import jax.numpy as jnp
    from bundlefusion_tpu.bundle import pipeline as jpipe
    from bundlefusion_tpu.bundle.global_graph import GlobalGraph as JGraph
    from bundlefusion_tpu.features.sift import SiftKeys as JKeys
    from bundlefusion_tpu.ops.preprocess import FrameCache as JCache
    from bundlefusion_tpu.solver.residuals import SparseCorrs as JCorrs
    from bundlefusion_tpu_torch import interop
    from bundlefusion_tpu_torch.bundle import pipeline as tpipe

    snaps = {}

    def hook(mod, key, graph_of):
        orig = mod.BundleFusion._process_chunk

        def wrapped(self, *a, **k):
            orig(self, *a, **k)
            if self.chunk_count - 1 == chunk:
                snaps[key] = graph_of(self)
        mod.BundleFusion._process_chunk = wrapped
        return orig

    oj = hook(jpipe, "jax", lambda bf: jax.tree.map(np.asarray, bf.graph))
    ot = hook(tpipe, "port", lambda bf: interop.state_to_numpy(bf.state.graph))
    try:
        run_jax()
        run_port()
    finally:
        jpipe.BundleFusion._process_chunk, tpipe.BundleFusion._process_chunk = oj, ot
    cfg_j, cfg_t = ls._cfg(ls.j_tiny).bundling, ls._cfg(ls.t_tiny).bundling
    seq_cam = ls.generate_corridor_sequence(1, width=128, height=96, x_span=2.5).camera
    cam = seq_cam.scaled(cfg_j.cache_width, cfg_j.cache_height)
    port_graph = snaps["port"]
    jgraphs = {"reference's graph": snaps["jax"],
               "port's graph": JGraph(**{**port_graph, "keys": JKeys(**port_graph["keys"]),
                                         "cache": JCache(**port_graph["cache"]),
                                         "corrs": JCorrs(**port_graph["corrs"])})}
    for name, jg in jgraphs.items():
        tg = interop.state_from_numpy(jg if name.startswith("reference") else port_graph, "cpu",
                                      interop.STATE_CLASSES["GlobalGraph"])
        sj = _stages_jax(jax.tree.map(jnp.asarray, jg), chunk, pair, cam, cfg_j)
        st = _stages_port(tg, chunk, pair, cam, cfg_t)
        gap = float(np.abs(sj.pop("T") - st.pop("T")).max())
        print(f"pair ({pair}, {chunk}) on the {name}: reference {sj}; port {st}; |T gap| {gap:.3g}")
    kj, kt = snaps["jax"].keys, port_graph["keys"]
    for k in (pair, chunk):
        same = np.array_equal(np.asarray(kj.valid[k]), kt["valid"][k])
        gaps = {f: float(np.abs(np.asarray(getattr(kj, f)[k]) - kt[f][k]).max()) for f in ("p3d", "desc", "xy")}
        xj, xt = np.asarray(kj.xy[k])[np.asarray(kj.valid[k])], kt["xy"][k][kt["valid"][k]]
        near = np.abs(xj[:, None, :] - xt[None, :, :]).max(-1)
        unmatched = int((near.min(1) > 1e-3).sum()), int((near.min(0) > 1e-3).sum())
        print(f"  keyframe {k}: valid keys equal {same} ({int(kt['valid'][k].sum())}); max |reference - port| {gaps}; "
              f"keys with no counterpart within 1e-3 px (reference, port): {unmatched}")


def compare(name: str, ref, other) -> None:
    (bj, oj, sj), (bo, oo, so) = ref, other
    err = np.abs(oj.poses - oo.poses).reshape(len(oo.poses), -1).max(axis=1)
    print(f"== {name}")
    print(f"  max |pose gap| {err.max():.3g} (frame {int(err.argmax())}); by 20 frames "
          f"{[float(f'{err[i:i + 20].max():.3g}') for i in range(0, len(err), 20)]}")
    rj, ro = ls._stream_records(bj), ls._stream_records(bo)
    first = next((a[0] for a, b in zip(rj, ro) if a != b), None)
    print(f"  streaming checks equal: {rj == ro}; first that differs at chunk {first}")
    print(f"  validity equal: {np.array_equal(oj.valid, oo.valid)}; keyframes {oj.num_keyframes} / "
          f"{oo.num_keyframes}")
    recs_j = [r for r in bj.runlog.records if "chunk_valid" in r]
    recs_o = [r for r in bo.runlog.records if "chunk_valid" in r]
    for c, (a, b) in enumerate(zip(recs_j, recs_o)):
        line = ""
        if c >= 1 and c - 1 < min(len(sj), len(so)):
            s1, s2 = sj[c - 1], so[c - 1]
            k = c + 1
            gin = np.abs(s1["pre"][:k] - s2["pre"][:k]).max()
            gout = np.abs(s1["post"][:k] - s2["post"][:k]).max()
            line = f"solve in {gin:.3g} out {gout:.3g} cursor {s1['cursor']}/{s2['cursor']}"
            pj, po = s1["pairs"], s2["pairs"]
            moved = {k: (pj.get(k, 0), po.get(k, 0)) for k in set(pj) | set(po) if pj.get(k, 0) != po.get(k, 0)}
            if moved:
                line += f" live corrs by pair (a, b): {moved}"
        diff = {k: (a[k], b[k]) for k in a if k in b and not isinstance(a[k], float) and a[k] != b[k]}
        print(f"  chunk {a['chunk']:2d}: {line} {diff if diff else ''}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--perturb", choices=("global", "local"), default="global")
    ap.add_argument("--no-port", action="store_true", help="the two reference runs only")
    ap.add_argument("--inspect", nargs=2, type=int, metavar=("CHUNK", "PAIR"),
                    help="instead: the global match's filter stages for keyframe pair (PAIR, CHUNK)")
    args = ap.parse_args()
    t0 = time.perf_counter()
    if args.inspect:
        inspect(*args.inspect)
        return 0
    ref = run_jax()
    pert = run_jax(args.perturb)
    compare(f"reference with one ulp moved ({args.perturb}) against the reference", ref, pert)
    if not args.no_port:
        compare("port against the reference", ref, run_port())
    print(f"({time.perf_counter() - t0:.0f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
