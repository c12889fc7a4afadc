"""Normal-equation assembly and PCG (port of ``bundlefusion_tpu.solver.system``).

The per-pair 12x12 blocks are summed once into a dense [6N, 6N] system and
PCG runs with plain matvecs. On a card the assembly is kernel K3
(``csrc/assemble.cu``); its twin, for CPU tensors, scatter-adds on
PyTorch's deterministic kernels (``tensor_ops.deterministic``): duplicates
sum in index order, so runs are bit-reproducible as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import kernels
from ..utils.tensor_ops import deterministic


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


def pcg_solve(H: torch.Tensor, b: torch.Tensor, num_iters: int, tol: float = 1e-10) -> PCGResult:
    """Jacobi-preconditioned CG with a fixed iteration count; converged
    systems keep iterating with masked (no-op) updates."""
    diag = torch.diagonal(H)
    Minv = torch.where(torch.abs(diag) > 1e-12, 1.0 / diag, 0.0)
    x = torch.zeros_like(b)
    r = b
    z = Minv * r
    p = z
    rz = torch.dot(r, z)
    for _ in range(num_iters):
        active = rz > tol
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
    return PCGResult(x=x, iterations=num_iters, final_rz=rz)
