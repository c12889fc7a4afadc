"""Absolute trajectory error (numpy mirror of ``bundlefusion_tpu.eval.ate``):
RMSE of translational error after rigid Umeyama alignment, as the TUM
benchmark's ``evaluate_ate.py`` defines it."""

from __future__ import annotations

import numpy as np


def _umeyama_np(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """float64 rigid (no-scale) Umeyama: dst ~= R @ src + t."""
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    U, _, Vt = np.linalg.svd(cov)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U) * np.linalg.det(Vt))])
    R = U @ D @ Vt
    return R, mu_d - R @ mu_s


def ate_rmse(estimated, ground_truth, valid=None, align: bool = True) -> float:
    """RMSE of translational error after rigid alignment, in the GT units (m)."""
    est = np.asarray(estimated, dtype=np.float64)
    gt = np.asarray(ground_truth, dtype=np.float64)
    mask = np.ones(len(est), dtype=bool) if valid is None else np.array(valid, dtype=bool)
    mask &= np.isfinite(gt.reshape(len(gt), -1)).all(axis=1)
    mask &= np.isfinite(est.reshape(len(est), -1)).all(axis=1)
    p_est = est[mask][:, :3, 3]
    p_gt = gt[mask][:, :3, 3]
    if len(p_est) < 2:
        return float("nan")
    if align:
        R, t = _umeyama_np(p_est, p_gt)
        p_est = p_est @ R.T + t
    err = p_est - p_gt
    return float(np.sqrt(np.mean(np.sum(err * err, axis=-1))))


def rpe(estimated, ground_truth, delta: int = 1) -> tuple[float, float]:
    """Relative pose error over frame gaps of ``delta``: (trans RMSE m, rot RMSE rad)."""
    est = np.asarray(estimated, dtype=np.float64)
    gt = np.asarray(ground_truth, dtype=np.float64)
    terr, rerr = [], []
    for i in range(len(est) - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        terr.append(np.linalg.norm(e[:3, 3]))
        rerr.append(np.arccos(np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)))
    return float(np.sqrt(np.mean(np.square(terr)))), float(np.sqrt(np.mean(np.square(rerr))))
