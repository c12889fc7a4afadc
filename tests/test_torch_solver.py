"""Solver: the port's hand Jacobians against ``torch.func``, and its GN / PCG /
pruning against the JAX package on fixed problems (per-iteration residual
sums and solved poses within 1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bundlefusion_tpu.config import tiny_test_config as j_tiny
from bundlefusion_tpu.geometry import se3 as jse3
from bundlefusion_tpu.ops import preprocess as jpp
from bundlefusion_tpu.solver import gn as jgn
from bundlefusion_tpu.solver import residuals as jres
from bundlefusion_tpu.solver import system as jsys
from bundlefusion_tpu_torch import interop
from bundlefusion_tpu_torch.config import tiny_test_config as t_tiny
from bundlefusion_tpu_torch.geometry import se3 as tse3
from bundlefusion_tpu_torch.solver import gn as tgn
from bundlefusion_tpu_torch.solver import residuals as tres
from bundlefusion_tpu_torch.solver import system as tsys
from util import cached_sequence

BC_J = j_tiny().bundling
BC_T = t_tiny().bundling


def _sparse_problem(seed, n_images=3, n_corr=64, noise=0.0):
    """World points seen from several poses; one image pair per correspondence."""
    rng = np.random.default_rng(seed)
    xi = (rng.standard_normal((n_images, 6)) * 0.3).astype(np.float32)
    xi[0] = 0
    poses = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    pts = rng.uniform(-1, 1, size=(n_corr, 3)).astype(np.float32) + [0, 0, 3.0]
    pairs = [(a, b) for a in range(n_images) for b in range(a + 1, n_images)]
    pair_of = np.arange(n_corr) % len(pairs)
    img_a = np.array([pairs[p][0] for p in pair_of], np.int32)
    img_b = np.array([pairs[p][1] for p in pair_of], np.int32)
    inv = np.linalg.inv(poses)
    p_a = np.einsum("kij,kj->ki", inv[img_a, :3, :3], pts) + inv[img_a, :3, 3]
    p_b = np.einsum("kij,kj->ki", inv[img_b, :3, :3], pts) + inv[img_b, :3, 3]
    p_a = p_a + rng.normal(scale=noise, size=p_a.shape)
    corrs = dict(img_a=img_a, img_b=img_b, p_a=p_a.astype(np.float32), p_b=p_b.astype(np.float32),
                 weight=np.ones(n_corr, np.float32))
    return poses, corrs


def _problems(kind, corrs, n):
    """(jax GNProblem, port GNProblem) with no dense pairs or all pairs."""
    pa, pb = (np.triu_indices(n, 1) if kind == "dense" else (np.zeros(1), np.zeros(1)))
    active = np.ones(len(pa), bool) if kind == "dense" else np.zeros(1, bool)
    free = np.arange(n) > 0
    jp = jgn.GNProblem(jres.SparseCorrs(**{k: jnp.asarray(v) for k, v in corrs.items()}),
                       jnp.asarray(pa, jnp.int32), jnp.asarray(pb, jnp.int32), jnp.asarray(active), jnp.asarray(free))
    tp = tgn.GNProblem(tres.SparseCorrs(**{k: torch.as_tensor(v) for k, v in corrs.items()}),
                       torch.as_tensor(pa).long(), torch.as_tensor(pb).long(), torch.as_tensor(active),
                       torch.as_tensor(free))
    return jp, tp


def test_sparse_jacobian_vs_torch_func():
    poses, corrs = _sparse_problem(0)
    c = tres.SparseCorrs(**{k: torch.as_tensor(v) for k, v in corrs.items()})
    P = torch.as_tensor(poses)

    def res_fn(xi_all):
        p = torch.einsum("nij,njk->nik", tse3.se3_exp(xi_all), P)
        return tres.sparse_residuals(p, c)[0]

    J_auto = torch.func.jacrev(res_fn)(torch.zeros(3, 6))  # [R, 3, 3, 6]
    _, J, _ = tres.sparse_residuals(P, c)
    idx = torch.arange(len(corrs["img_a"]))
    Ja = J_auto[idx, :, c.img_a.long()]
    Jb = J_auto[idx, :, c.img_b.long()]
    torch.testing.assert_close(torch.cat([Ja, Jb], -1), J, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def dense_case():
    """A 3-frame cache at 128x96 with ground-truth poses relative to frame 0."""
    seq = cached_sequence(3, width=128, height=96)
    cc = seq.camera.scaled(BC_J.cache_width, BC_J.cache_height)
    color = jnp.asarray(seq.color)
    _, cache = jpp.preprocess_frames(jnp.asarray(seq.depth), color, seq.camera, cc)
    rel = np.linalg.inv(seq.poses[0]) @ seq.poses
    return jax.tree.map(np.asarray, cache), rel.astype(np.float32), cc


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_solve_gn_matches_jax(kind, dense_case):
    cache_np, rel, cc = dense_case
    if kind == "sparse":
        poses, corrs = _sparse_problem(1, noise=0.01)
        caches_j = caches_t = None
    else:
        poses = rel
        _, corrs = _sparse_problem(1, n_corr=16)
        corrs["weight"][:] = 0.0  # dense terms only
        caches_j = jax.tree.map(jnp.asarray, cache_np)
        caches_t = interop.state_from_numpy(cache_np, "cpu")
    init = poses.copy()
    init[1:, :3, 3] += np.array([0.01, -0.01, 0.005], np.float32)
    jp, tp = _problems(kind, corrs, len(poses))
    pj, sj = jgn.solve_gn(jnp.asarray(init), jp, caches_j, cc, BC_J, 3, 16, use_dense=kind == "dense")
    pt, st = tgn.solve_gn(torch.as_tensor(init), tp, caches_t, cc, BC_T, 3, 16, use_dense=kind == "dense")
    np.testing.assert_allclose(np.asarray(sj.sparse_res_sum), st.sparse_res_sum.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(sj.dense_depth_res), st.dense_depth_res.numpy(), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), atol=1e-5, rtol=0)
    if kind == "dense":
        assert float(st.dense_depth_res[0]) > 0


def test_assemble_pcg_and_prune_match_jax():
    rng = np.random.default_rng(3)
    n, p = 4, 9
    A = rng.standard_normal((p, 12, 12)).astype(np.float32)
    JtJ = np.einsum("pij,pkj->pik", A, A)
    Jtr = rng.standard_normal((p, 12)).astype(np.float32)
    pa = rng.integers(0, n, p).astype(np.int32)
    pb = ((pa + 1 + rng.integers(0, n - 1, p)) % n).astype(np.int32)
    free = np.array([False, True, True, True])
    Hj, bj = jsys.assemble_system(n, jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(JtJ), jnp.asarray(Jtr), jnp.asarray(free))
    Ht, bt = tsys.assemble_system(n, torch.as_tensor(pa), torch.as_tensor(pb), torch.as_tensor(JtJ), torch.as_tensor(Jtr), torch.as_tensor(free))
    np.testing.assert_allclose(np.asarray(Hj), Ht.numpy(), atol=1e-4, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(bj), bt.numpy(), atol=1e-6, rtol=0)
    xj = jsys.pcg_solve(Hj, bj, 24).x
    xt = tsys.pcg_solve(Ht, bt, 24).x
    np.testing.assert_allclose(np.asarray(xj), xt.numpy(), atol=1e-5, rtol=1e-4)

    _, corrs = _sparse_problem(4, n_corr=40)
    res = rng.random(40).astype(np.float32) * 0.3
    cj, rj = jgn.prune_max_residuals(jres.SparseCorrs(**{k: jnp.asarray(v) for k, v in corrs.items()}),
                                     jnp.asarray(res), 0.16, 4)
    ct, rt = tgn.prune_max_residuals(tres.SparseCorrs(**{k: torch.as_tensor(v) for k, v in corrs.items()}),
                                     torch.as_tensor(res), 0.16, 4)
    assert int(rj) == int(rt) == 4
    np.testing.assert_array_equal(np.asarray(cj.weight), ct.weight.numpy())
