"""Quality metrics: PSNR / SSIM (the north-star RD harness primitives).

The reference maintains quality by eyeballing + its user base (SURVEY.md §4
"the reference ships no automated test suite"); here PSNR/SSIM-vs-bitrate is
measured in-repo (tools/rd_harness.py) so codec changes regress against a
tracked JSON.
"""
from __future__ import annotations

import numpy as np


def psnr(ref: np.ndarray, test: np.ndarray, peak: float = 255.0) -> float:
    """PSNR in dB between two planes/frames (any matching shape)."""
    ref = ref.astype(np.float64)
    test = test.astype(np.float64)
    mse = np.mean((ref - test) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def psnr_yuv(ref_yuv, test_yuv, weights=(6.0, 1.0, 1.0)) -> float:
    """Weighted YUV PSNR (the common 6/1/1 convention)."""
    ws = 0.0
    acc = 0.0
    for (r, t), w in zip(zip(ref_yuv, test_yuv), weights):
        acc += w * psnr(r, t)
        ws += w
    return acc / ws


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    ax = np.arange(size) - size // 2
    k = np.exp(-(ax ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def _filter2_sep(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' convolution with 1-D kernel k along both axes."""
    pad = len(k) // 2
    out = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"),
                              1, img)
    out = np.apply_along_axis(lambda c: np.convolve(c, k, mode="same"),
                              0, out)
    return out[pad:-pad, pad:-pad]


def ssim(ref: np.ndarray, test: np.ndarray, peak: float = 255.0) -> float:
    """Single-scale SSIM (Wang et al.), gaussian 11x1.5 window, valid crop."""
    x = ref.astype(np.float64)
    y = test.astype(np.float64)
    k = _gaussian_kernel()
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mx = _filter2_sep(x, k)
    my = _filter2_sep(y, k)
    mxx = _filter2_sep(x * x, k)
    myy = _filter2_sep(y * y, k)
    mxy = _filter2_sep(x * y, k)
    vx = mxx - mx * mx
    vy = myy - my * my
    cxy = mxy - mx * my
    s = ((2 * mx * my + c1) * (2 * cxy + c2)) / (
        (mx * mx + my * my + c1) * (vx + vy + c2))
    return float(s.mean())
