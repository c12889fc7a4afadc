"""SIFT descriptor matching (port of ``bundlefusion_tpu.features.matcher``).

Descriptors are L2-normalized, so dist^2 = 2 - 2 * sim with
sim = desc_i @ desc_j.T: one batched matmul over all pairs. Top-2 by two
max/argmax passes, Lowe ratio + absolute distance tests, mutual check, then a
stable top-k compaction into the fixed per-pair capacity.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import BundlingConfig
from ..utils.tensor_ops import top_k
from .sift import SiftKeys


@dataclass
class PairMatches:
    """Fixed-capacity matches for a batch of image pairs, [..., M]."""

    idx_i: torch.Tensor  # [..., M] int64 key index in image i
    idx_j: torch.Tensor  # [..., M] int64 key index in image j
    dist: torch.Tensor  # [..., M] float32 descriptor distance
    valid: torch.Tensor  # [..., M] bool

    @property
    def capacity(self) -> int:
        return self.idx_i.shape[-1]

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid, dim=-1)


def match_pairs(desc_i, valid_i, desc_j, valid_j, cfg: BundlingConfig) -> PairMatches:
    """Match batched descriptor sets [..., Ki, 128] x [..., Kj, 128].

    The similarity takes bf16 inputs with f32 accumulation, as the reference
    chooses: descriptors round to bf16 and the product runs in f32 (products
    of bf16 values are exact in f32).
    """
    di = desc_i.to(torch.bfloat16).to(torch.float32)
    dj = desc_j.to(torch.bfloat16).to(torch.float32)
    sim = torch.matmul(di, dj.transpose(-1, -2))  # [..., Ki, Kj]
    pairmask = valid_i[..., :, None] & valid_j[..., None, :]
    sim = torch.where(pairmask, sim, -2.0)

    best_j = torch.argmax(sim, dim=-1)  # [..., Ki] first maximum
    s1 = torch.amax(sim, dim=-1)
    cols = torch.arange(sim.shape[-1], device=sim.device)
    s2 = torch.amax(torch.where(cols == best_j[..., None], -2.0, sim), dim=-1)
    d1 = torch.sqrt(torch.clamp(2.0 - 2.0 * s1, min=0.0))
    d2 = torch.sqrt(torch.clamp(2.0 - 2.0 * s2, min=0.0))

    ratio_ok = d1 < cfg.match_ratio_thresh * d2
    dist_ok = d1 < cfg.match_dist_thresh
    best_i_of_j = torch.argmax(sim, dim=-2)  # [..., Kj]
    krange = torch.arange(sim.shape[-2], device=sim.device)
    mutual = torch.gather(best_i_of_j, -1, best_j) == krange
    ok = valid_i & ratio_ok & dist_ok & mutual

    score = torch.where(ok, -d1, -torch.inf)
    top_scores, sel = top_k(score, cfg.max_matches_per_pair_raw)
    valid = torch.isfinite(top_scores)
    return PairMatches(
        idx_i=torch.where(valid, sel, 0),
        idx_j=torch.where(valid, torch.gather(best_j, -1, sel), 0),
        dist=torch.where(valid, -top_scores, torch.inf),
        valid=valid,
    )


def match_pair(keys_i: SiftKeys, keys_j: SiftKeys, cfg: BundlingConfig) -> PairMatches:
    """Match two (batches of) images' key sets."""
    return match_pairs(keys_i.desc, keys_i.valid, keys_j.desc, keys_j.valid, cfg)


def match_all_pairs(
    keys: SiftKeys,  # batched [N]
    pairs_a: torch.Tensor,  # [P]
    pairs_b: torch.Tensor,  # [P]
    cfg: BundlingConfig,
) -> PairMatches:
    """Match a list of image pairs from one batched key set."""
    return match_pairs(keys.desc[pairs_a], keys.valid[pairs_a], keys.desc[pairs_b], keys.valid[pairs_b], cfg)


def gather_match_points(keys: SiftKeys, pairs_a, pairs_b, matches: PairMatches):
    """3D camera-space points of matched keys: ([P, M, 3] in frame a, same in b)."""
    pa = keys.p3d[pairs_a[:, None], matches.idx_i]
    pb = keys.p3d[pairs_b[:, None], matches.idx_j]
    return pa, pb
