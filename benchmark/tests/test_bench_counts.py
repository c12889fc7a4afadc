"""The frozen K3 count equals ``chip_smoke.py``'s at its phase-3 shapes."""

import numpy as np
import pytest

import chip_smoke
from benchmark.counts import k3, peaks


def test_peaks_are_chip_smokes():
    assert (peaks.HBM_BYTES_PER_S, peaks.F32_FLOPS, peaks.MUFU_PER_S) == (
        chip_smoke.HBM_BYTES_PER_S, chip_smoke.F32_FLOPS, chip_smoke.MUFU_PER_S)


@pytest.mark.parametrize("case", sorted(chip_smoke.k3_cases(chip_smoke.flagship_config().bundling)))
def test_k3_count(case):
    make, _ = chip_smoke.k3_cases(chip_smoke.flagship_config().bundling)[case]
    pa, pb, JtJ, Jtr, free = make()
    p, m = JtJ.shape[0], free.shape[0]
    # chip_smoke.py::check_k3's count, as it states it
    nbytes = p * (144 + 12) * 4 + 2 * p * pa.itemsize + m + (36 * m * m + 6 * m) * 4
    nonzero = int((JtJ.reshape(p, 2, 6, 2, 6) != 0).any(axis=-1).sum()) + int((Jtr != 0).sum())
    want = chip_smoke.bound(nbytes, nonzero * 6, 0)
    assert k3.least_ms(m, p, pa.itemsize, nonzero) == want
    # from the shape alone (the most additions a slot can take) the bound is the same: bytes bound it
    assert k3.least_ms(m, p, pa.itemsize) == want and want[1] == "bytes"


def test_k3_shapes_of_the_flagship():
    bc = chip_smoke.flagship_config().bundling
    shapes = k3.shapes({k: getattr(bc, k) for k in ("submap_size", "use_dense_local", "max_residuals_local",
                                                     "use_dense_global", "max_num_images", "max_residuals_global",
                                                     "max_dense_pairs_global")})
    assert shapes == {"chunk_local": (11, 1024 + 55, 8), "global_solve": (128, 16384, 4)}
    assert np.isfinite(k3.least_ms(*shapes["global_solve"])[0])
