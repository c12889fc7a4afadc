"""The semantics kernel K7 (``csrc/pcg.cu``) relies on, held on the CPU
against ``solver/system.py::pcg_solve``'s twin, the JAX package's masked
loop over every row:

* past the last free slot the assembly (K3's twin here) leaves gauge-fixed
  rows, so solving only the leading live block gives the full solve's x,
  with exact zeros on the rows past it;
* once rz <= tol every later iteration is a masked no-op, so stopping there
  gives the same x and final rz as running the iterations out.

``k7_model`` is what K7 computes, up to the order of its sums; the card
test ``tests/test_torch_kernels_cuda.py`` holds the kernel to the twin.
"""

import pytest
import torch

from bundlefusion_tpu_torch.solver import system
from chip_smoke import gauge_system_inputs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test files at once, one per CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gauge_system(seed: int, n: int, keyframes: int, not_free=(), j_rows: int = 24):
    """``chip_smoke.gauge_system_inputs`` assembled by K3's twin: (H, b,
    free_mask)."""
    arrays = gauge_system_inputs(seed, n, keyframes, not_free, j_rows)
    H, b = system._assemble_system_torch(n, *(torch.as_tensor(a) for a in arrays))
    return H, b, torch.as_tensor(arrays[4])


def pcg_stopping(H, b, num_iters: int, tol: float = 1e-10):
    """The twin's loop without its masks, stopped at the first iteration
    whose rz <= tol: (x, rz, iterations run)."""
    diag = torch.diagonal(H)
    Minv = torch.where(torch.abs(diag) > 1e-12, 1.0 / diag, 0.0)
    x = torch.zeros_like(b)
    r = b
    z = Minv * r
    p = z
    rz = torch.dot(r, z)
    it = 0
    while it < num_iters and bool(rz > tol):
        Ap = H @ p
        pAp = torch.dot(p, Ap)
        alpha = torch.where(torch.abs(pAp) > 1e-20, rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv * r
        rz_new = torch.dot(r, z)
        beta = torch.where(rz > 1e-20, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x, rz, it


def k7_model(H, b, free_mask, num_iters: int, tol: float = 1e-10):
    """K7's solve: the leading 6 x (last free slot + 1) rows and columns,
    stopped once converged, x 0 past them. (x, rz, rows, iterations run)."""
    rows = int(system.live_rows(free_mask, b.shape[0], b.device))
    x_live, rz, it = pcg_stopping(H[:rows, :rows], b[:rows], num_iters, tol)
    return torch.cat([x_live, torch.zeros(b.shape[0] - rows)]), rz, rows, it


# (seed, slots, keyframes, slots inside the bound that are not free, rows of
# each pair's J, PCG iterations); global_64_of_128 runs all 64 iterations
LIVE_CASES = {
    "global_7_of_200": (1, 200, 7, (), 24, 64),
    "global_30_of_200_one_dropped": (2, 200, 30, (17,), 24, 64),
    "global_64_of_128": (3, 128, 64, (5, 40), 8, 64),
    "local_11": (4, 11, 11, (), 24, 32),
    "nothing_free": (5, 16, 1, (), 24, 64),
}


@pytest.mark.parametrize("case", list(LIVE_CASES))
def test_live_block_matches_full_solve(case):
    seed, n, keyframes, not_free, j_rows, iters = LIVE_CASES[case]
    H, b, free = gauge_system(seed, n, keyframes, not_free, j_rows)
    full = system.pcg_solve(H, b, iters, free_mask=free)
    x, rz, rows, it = k7_model(H, b, free, iters)
    live = 6 * (int(torch.nonzero(free).max()) + 1) if bool(free.any()) else 0
    assert rows == live == int(full.rows)
    assert int(full.iters_run) == it
    assert bool((x[rows:] == 0).all()) and bool((full.x[rows:] == 0).all())
    scale = float(torch.linalg.vector_norm(full.x))
    assert float(torch.linalg.vector_norm(x - full.x)) <= 1e-5 * scale
    # rz ends near rounding level, so its difference is measured against where it started
    minv = torch.where(torch.abs(torch.diagonal(H)) > 1e-12, 1.0 / torch.diagonal(H), 0.0)
    assert abs(float(rz) - float(full.final_rz)) <= 1e-5 * float(torch.dot(b, minv * b))
    if case == "nothing_free":
        assert rows == 0 and it == 0 and scale == 0.0 and float(full.final_rz) == 0.0
    if case == "global_64_of_128":
        assert it == iters


# (seed, slots, keyframes, PCG iterations): systems small enough to converge
STOP_CASES = {"three_keyframes": (11, 8, 3, 200), "five_keyframes": (12, 8, 5, 200),
              "local_11": (13, 11, 11, 400)}


@pytest.mark.parametrize("case", list(STOP_CASES))
def test_stopping_at_tol_matches_masked_iterations(case):
    seed, n, keyframes, iters = STOP_CASES[case]
    H, b, free = gauge_system(seed, n, keyframes)
    rows = int(system.live_rows(free, b.shape[0], b.device))
    Hl, bl = H[:rows, :rows].contiguous(), b[:rows].contiguous()
    x, rz, it = pcg_stopping(Hl, bl, iters)
    masked = system.pcg_solve(Hl, bl, iters)
    assert 0 < it < iters  # it converged, and the iterations after that were masked
    assert int(masked.iters_run) == it
    assert torch.equal(x, masked.x) and torch.equal(rz, masked.final_rz)
    assert float(rz) <= 1e-10
