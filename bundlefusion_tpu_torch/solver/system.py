"""Normal-equation assembly and PCG (port of ``bundlefusion_tpu.solver.system``).

The per-pair 12x12 blocks are scattered once into a dense [6N, 6N] system
and PCG runs with plain matvecs. The scatter-adds run on PyTorch's
deterministic kernels (``tensor_ops.deterministic``): duplicates sum in index
order, so runs are bit-reproducible on the card as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..utils.tensor_ops import deterministic


def assemble_system(num_images, pairs_a, pairs_b, JtJ_pairs, Jtr_pairs, free_mask, damping: float = 1e-6):
    """Scatter per-pair blocks into (H [6N, 6N], b [6N]); gauge-fix the rows
    of poses that are not free."""
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
