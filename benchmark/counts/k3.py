"""Kernel K3 (``csrc/assemble.cu``, the normal-equation assembly: two
launches, ``assemble_flags_kernel`` then ``assemble_rows_kernel``): the
count of ``chip_smoke.py::check_k3``, frozen. Every slot's 12x12 block,
12-vector and two indices are read once, the free mask once, H (6n x 6n)
and b (6n) written once; the additions are six per non-zero row of
updates, which never bound it: at most 36 rows a slot, 216 operations
against 624 bytes, two orders of magnitude under the bytes' time at the
card's peaks. So the least time follows from the launch's shape alone."""

from .peaks import bound


def least_ms(n: int, slots: int, index_bytes: int, nonzero_rows: int | None = None) -> tuple[float, str]:
    """The least time of one assembly (both launches) of ``slots`` slots
    into n keyframes, with indices of ``index_bytes`` bytes; the additions
    count ``nonzero_rows`` rows when given, else their most (36 a slot)."""
    nbytes = slots * (144 + 12) * 4 + 2 * slots * index_bytes + n + (36 * n * n + 6 * n) * 4
    rows = 36 * slots if nonzero_rows is None else nonzero_rows
    return bound(nbytes, rows * 6, 0)


def shapes(bundling: dict) -> dict[str, tuple[int, int, int]]:
    """(n, slots, index bytes) of K3's assemblies by the stage that runs
    them: chunk_local's local solve (the chunk's frames; its sparse slots,
    plus every pair of the chunk's frames as dense slots when
    ``use_dense_local``, whose indices are then int64), and global_solve's
    (the keyframe capacity, the global sparse slots, plus the dense-pair
    slots when ``use_dense_global``)."""
    cf = bundling["submap_size"] + 1
    local_dense = cf * (cf - 1) // 2 if bundling["use_dense_local"] else 0
    local = (cf, bundling["max_residuals_local"] + local_dense, 8 if local_dense else 4)
    global_dense = bundling["max_dense_pairs_global"] if bundling["use_dense_global"] else 0
    glob = (bundling["max_num_images"], bundling["max_residuals_global"] + global_dense, 8 if global_dense else 4)
    return {"chunk_local": local, "global_solve": glob}
