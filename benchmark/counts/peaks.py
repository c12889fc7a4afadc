"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at the
700 W power limit), as ``chip_smoke.py`` uses them: 3.35 TB/s HBM, 67
TFLOP/s float32 outside the tensor cores, and the MUFU unit's 16 results
per clock per SM (CUDA C++ Programming Guide, arithmetic throughput for
compute capability 9.0) on 132 SMs at the 1.98 GHz boost clock."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
MUFU_PER_S = 16 * 132 * 1.98e9


def bound(nbytes: float, flops: float, mufu: float) -> tuple[float, str]:
    """(least milliseconds, "bytes" or "operations") for work of that size."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(flops / F32_FLOPS, mufu / MUFU_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
