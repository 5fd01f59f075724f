"""Evaluation metrics (host-side numpy).

The port's copy of ``coponerf_tpu/eval/metrics.py`` (numpy and scipy
only), held equal to it by ``tests/test_torch_eval_data.py``.

Parity targets of the reference: test.py:90-91 (PSNR from MSE), :265-269
(SSIM via skimage structural_similarity, win 11, gaussian weights,
data_range=1), :34-48 + :232-243 (rotation geodesic, translation L2,
translation angular error), :271-302 (overlap-binned running statistics).

``ssim`` is the JAX package's gaussian-weighted SSIM (win 11, sigma 1.5)
written with scipy.ndimage, unchanged.

LPIPS is not ported yet (ROADMAP P8): ``lpips_vgg`` returns None without
weights and raises with them, so a run never passes off a missing LPIPS
column as a computed one.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional

import numpy as np
from scipy.ndimage import gaussian_filter


def psnr(img: np.ndarray, target: np.ndarray) -> float:
    mse = float(np.mean((img - target) ** 2))
    return -10.0 * np.log10(mse) if mse > 0 else float("inf")


def ssim(img1: np.ndarray, img2: np.ndarray, win_size: int = 11, sigma: float = 1.5, data_range: float = 1.0) -> float:
    """Mean SSIM over channels, matching skimage's gaussian-weighted variant."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if img1.ndim == 2:
        img1, img2 = img1[..., None], img2[..., None]
    truncate = (win_size - 1) / 2 / sigma  # radius = 5 for win 11
    pad = (win_size - 1) // 2
    vals = []
    for c in range(img1.shape[-1]):
        x, y = img1[..., c], img2[..., c]
        filt = lambda a: gaussian_filter(a, sigma, truncate=truncate)
        ux, uy = filt(x), filt(y)
        uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
        vx = uxx - ux * ux
        vy = uyy - uy * uy
        vxy = uxy - ux * uy
        C1 = (0.01 * data_range) ** 2
        C2 = (0.03 * data_range) ** 2
        s = ((2 * ux * uy + C1) * (2 * vxy + C2)) / ((ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))
        vals.append(s[pad:-pad, pad:-pad].mean())
    return float(np.mean(vals))


def rotation_geodesic(R1: np.ndarray, R2: np.ndarray) -> np.ndarray:
    m = R1 @ np.swapaxes(R2, -1, -2)
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1) / 2
    return np.arccos(np.clip(cos, -1.0, 1.0))


def translation_error(t1: np.ndarray, t2: np.ndarray):
    l2 = np.linalg.norm(t1 - t2, axis=-1)
    n1 = t1 / (np.linalg.norm(t1, axis=-1, keepdims=True) + 1e-12)
    n2 = t2 / (np.linalg.norm(t2, axis=-1, keepdims=True) + 1e-12)
    angle = np.arccos(np.clip(np.sum(n1 * n2, axis=-1), -1.0, 1.0))
    return l2, angle


def lpips_vgg(img1, img2, weights_path: Optional[str] = None) -> Optional[float]:
    """None without weights; with weights it raises: the LPIPS network is
    not ported yet (ROADMAP P8)."""
    if weights_path is None:
        return None
    raise NotImplementedError(
        "LPIPS is not ported to coponerf_tpu_torch yet (ROADMAP P8); run without --lpips_weights "
        "and with --allow_missing_lpips"
    )


def overlap_bin(overlap: float) -> str:
    """test.py:271-272 binning."""
    if overlap > 0.75:
        return "large"
    if overlap >= 0.5:
        return "medium"
    return "small"


class MetricAccumulator:
    """Running, overlap-binned statistics (test.py:148-302)."""

    BINS = ("all", "small", "medium", "large")

    def __init__(self):
        self.metrics = {b: collections.defaultdict(list) for b in self.BINS}

    def add(self, bin_key: str, **values):
        for k, v in values.items():
            if v is None:
                continue
            self.metrics["all"][k].append(float(v))
            self.metrics[bin_key][k].append(float(v))

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for b in self.BINS:
            stats = {}
            for k, vals in self.metrics[b].items():
                arr = np.asarray(vals)
                stats[f"{k}_avg"] = float(arr.mean())
                stats[f"{k}_median"] = float(np.median(arr))
                stats[f"{k}_std"] = float(arr.std())
            if stats:
                out[b] = stats
        return out

    def format(self) -> str:
        lines = []
        for b, stats in self.summary().items():
            keys = sorted(stats)
            lines.append(f"{b}: " + ", ".join(f"{k}: {stats[k]:.4f}" for k in keys))
        return "\n".join(lines)
