"""Normal-equation assembly and PCG (port of ``bundlefusion_tpu.solver.system``).

The per-pair 12x12 blocks are summed once into a dense [6N, 6N] system and
PCG runs with plain matvecs. On a card the assembly is kernel K3
(``csrc/assemble.cu``); its twin, for CPU tensors, scatter-adds on
PyTorch's deterministic kernels (``tensor_ops.deterministic``): duplicates
sum in index order, so runs are bit-reproducible as in the JAX package. On
a card the PCG is kernel K7 (``csrc/pcg.cu``), the whole solve in one
launch over the live rows; its twin is the JAX package's masked loop.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .. import kernels
from ..utils.tensor_ops import deterministic

_CUDA_ERROR_INVALID_VALUE = 1  # cudaErrorInvalidValue


@kernels.counted
def assemble_system(num_images, pairs_a, pairs_b, JtJ_pairs, Jtr_pairs, free_mask, damping: float = 1e-6):
    """Kernel K3: sum per-pair blocks into (H [6N, 6N], b [6N]); gauge-fix the
    rows of poses that are not free. CUDA tensors launch the kernel (bit-equal
    to the twin on the card); CPU tensors run the twin."""
    if not JtJ_pairs.is_cuda:
        return _assemble_system_torch(num_images, pairs_a, pairs_b, JtJ_pairs, Jtr_pairs, free_mask, damping)
    n, p = num_images, JtJ_pairs.shape[0]
    if pairs_a.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"pairs_a: expected int32 or int64, got {pairs_a.dtype}")
    pairs_a, pairs_b, JtJ_pairs, Jtr_pairs, free_mask = (
        x.contiguous() for x in (pairs_a, pairs_b, JtJ_pairs, Jtr_pairs, free_mask))
    kernels.require(pairs_a, "pairs_a", pairs_a.dtype, (p,))
    kernels.require(pairs_b, "pairs_b", pairs_a.dtype, (p,))
    kernels.require(JtJ_pairs, "JtJ_pairs", torch.float32, (p, 12, 12))
    kernels.require(Jtr_pairs, "Jtr_pairs", torch.float32, (p, 12))
    kernels.require(free_mask, "free_mask", torch.bool, (n,))
    # the kernel reads the blocks and Jtr as float4
    JtJ_pairs, Jtr_pairs = (x.clone() if x.data_ptr() % 16 else x for x in (JtJ_pairs, Jtr_pairs))
    dev = JtJ_pairs.device
    lib = kernels.library()
    H = torch.empty((6 * n, 6 * n), dtype=torch.float32, device=dev)
    b = torch.empty(6 * n, dtype=torch.float32, device=dev)
    scratch = torch.empty(lib.bf_assemble_scratch_bytes(n, p), dtype=torch.uint8, device=dev)
    err = lib.bf_assemble(
        pairs_a.data_ptr(), pairs_b.data_ptr(), int(pairs_a.dtype == torch.int64), JtJ_pairs.data_ptr(),
        Jtr_pairs.data_ptr(), free_mask.data_ptr(), H.data_ptr(), b.data_ptr(), scratch.data_ptr(), n, p, damping,
        1e-8, kernels.stream_ptr(dev),
    )
    kernels.check(err, "assemble")
    kernels.launched(assemble_system)
    return H, b


def _assemble_system_torch(num_images, pairs_a, pairs_b, JtJ_pairs, Jtr_pairs, free_mask, damping: float = 1e-6):
    """K3's twin: scatter per-pair blocks into (H [6N, 6N], b [6N]); gauge-fix
    the rows of poses that are not free."""
    n = num_images
    pa, pb = pairs_a.long(), pairs_b.long()
    Hb = torch.zeros((n * n, 6, 6), dtype=JtJ_pairs.dtype, device=JtJ_pairs.device)
    bv = torch.zeros((n, 6), dtype=Jtr_pairs.dtype, device=Jtr_pairs.device)

    def B(i, j):
        return JtJ_pairs[:, 6 * i : 6 * i + 6, 6 * j : 6 * j + 6]

    with deterministic():
        Hb.index_add_(0, pa * n + pa, B(0, 0))
        Hb.index_add_(0, pa * n + pb, B(0, 1))
        Hb.index_add_(0, pb * n + pa, B(1, 0))
        Hb.index_add_(0, pb * n + pb, B(1, 1))
        bv.index_add_(0, pa, Jtr_pairs[:, :6])
        bv.index_add_(0, pb, Jtr_pairs[:, 6:])
    H = Hb.reshape(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n)
    b = -bv.reshape(-1)  # GN solves H dx = -Jtr

    fm = torch.repeat_interleave(free_mask.to(H.dtype), 6)
    H = H * fm[:, None] * fm[None, :]
    H = H + torch.diag(1.0 - fm)
    b = b * fm
    diag = torch.diagonal(H)
    H = H + torch.diag(damping * diag + 1e-8)
    return H, b


@dataclass
class PCGResult:
    x: torch.Tensor  # [6N]
    iterations: int
    final_rz: torch.Tensor  # residual quadratic norm
    rows: torch.Tensor  # int32 0-d: the live rows solved, 6 x (the last free slot + 1)
    iters_run: torch.Tensor  # int32 0-d: the iterations run before rz <= tol


@kernels.counted
def pcg_solve(H: torch.Tensor, b: torch.Tensor, num_iters: int, tol: float = 1e-10,
              free_mask: torch.Tensor | None = None) -> PCGResult:
    """Jacobi-preconditioned CG with a fixed iteration count; converged
    systems keep iterating with masked (no-op) updates. ``free_mask`` [N]
    (all free if None) gives the live rows: past the last free slot H is
    the assembly's gauge-fixed identity and b is 0, so x is 0 there.

    CUDA tensors launch kernel K7 (``csrc/pcg.cu``): the whole solve in one
    launch over the live rows, stopping once rz <= tol (equal to the twin
    up to the order of its sums); CPU tensors run the twin."""
    if not H.is_cuda:
        return _pcg_solve_torch(H, b, num_iters, tol, free_mask)
    m = b.shape[0]
    if m % 6 or m == 0:
        raise ValueError(f"b: expected 6 x N rows, got {m}")
    n = m // 6
    if num_iters < 0:
        raise ValueError(f"num_iters: expected >= 0, got {num_iters}")
    dev = H.device
    if free_mask is None:
        free_mask = torch.ones(n, dtype=torch.bool, device=dev)
    H, b, free_mask = (t.contiguous() for t in (H, b, free_mask))
    kernels.require(H, "H", torch.float32, (m, m))
    kernels.require(b, "b", torch.float32, (m,))
    kernels.require(free_mask, "free_mask", torch.bool, (n,))
    cluster, threads, smem = _k7_launch(n, dev.index if dev.index is not None else torch.cuda.current_device())
    x = torch.empty(m, dtype=torch.float32, device=dev)
    rz = torch.empty((), dtype=torch.float32, device=dev)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    err = kernels.library().bf_pcg(
        H.data_ptr(), b.data_ptr(), free_mask.data_ptr(), x.data_ptr(), rz.data_ptr(), counts.data_ptr(), n,
        num_iters, tol, cluster, threads, smem, kernels.stream_ptr(dev),
    )
    kernels.check(err, "pcg")
    kernels.launched(pcg_solve)
    return PCGResult(x=x, iterations=num_iters, final_rz=rz, rows=counts[0], iters_run=counts[1])


@functools.lru_cache(maxsize=None)
def _k7_launch(n: int, device_index: int) -> tuple[int, int, int]:
    """K7's launch shape for ``n`` slots on a card: (cluster size, threads,
    shared memory bytes), fixed by ``n`` alone so that a captured graph
    serves every live bound."""
    out = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(device_index):
        err = kernels.library().bf_pcg_config(n, *(ctypes.byref(v) for v in out))
    if err == _CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"pcg_solve: a system of {n} slots does not fit kernel K7's shared memory")
    kernels.check(err, "pcg (launch shape)")
    return tuple(v.value for v in out)


def _pcg_solve_torch(H: torch.Tensor, b: torch.Tensor, num_iters: int, tol: float = 1e-10,
                     free_mask: torch.Tensor | None = None) -> PCGResult:
    """K7's twin: every row, every iteration, masked once converged."""
    diag = torch.diagonal(H)
    Minv = torch.where(torch.abs(diag) > 1e-12, 1.0 / diag, 0.0)
    x = torch.zeros_like(b)
    r = b
    z = Minv * r
    p = z
    rz = torch.dot(r, z)
    actives = []
    for _ in range(num_iters):
        active = rz > tol
        actives.append(active)
        Ap = H @ p
        pAp = torch.dot(p, Ap)
        alpha = torch.where(active & (torch.abs(pAp) > 1e-20), rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Minv * r
        rz_new = torch.dot(r, z)
        beta = torch.where(active & (rz > 1e-20), rz_new / rz, 0.0)
        p = torch.where(active, z + beta * p, p)
        rz = torch.where(active, rz_new, rz)
    run = torch.stack(actives).sum(dtype=torch.int32) if actives else torch.zeros((), dtype=torch.int32,
                                                                                    device=b.device)
    return PCGResult(x=x, iterations=num_iters, final_rz=rz, rows=live_rows(free_mask, b.shape[0], b.device),
                     iters_run=run)


def live_rows(free_mask: torch.Tensor | None, m: int, device) -> torch.Tensor:
    """6 x (the last free slot + 1), int32 0-d on ``device``: the rows K7
    solves (``m``, every row, without a mask)."""
    if free_mask is None:
        return torch.full((), m, dtype=torch.int32, device=device)
    slots = torch.arange(1, free_mask.shape[0] + 1, dtype=torch.int32, device=free_mask.device)
    return 6 * torch.max(torch.where(free_mask, slots, 0))
