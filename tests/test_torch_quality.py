"""``handbrake_tpu_torch/utils/quality.py`` (PSNR, SSIM) on the cases of
``tests/test_quality.py``, and equal to the JAX package's functions on the
same seeded planes (the copy check is in ``tests/test_torch_avcodec.py``)."""
import numpy as np
import pytest

from handbrake_tpu.utils import quality as jq
from handbrake_tpu_torch.utils.quality import psnr, psnr_yuv, ssim


def test_psnr_basics():
    a = np.full((32, 32), 100, np.uint8)
    assert psnr(a, a) == float("inf")
    b = a.copy()
    b[0, 0] = 110  # mse = 100/1024
    expect = 10 * np.log10(255 ** 2 / (100 / 1024))
    assert abs(psnr(a, b) - expect) < 1e-9


def test_ssim_range_and_identity():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (64, 64)).astype(np.uint8)
    assert ssim(a, a) == pytest.approx(1.0, abs=1e-9)
    noisy = np.clip(a.astype(int) + rng.integers(-40, 41, a.shape),
                    0, 255).astype(np.uint8)
    s = ssim(a, noisy)
    assert 0.0 < s < 1.0
    assert ssim(a, 255 - a) < s


def test_psnr_yuv_weighting():
    y = np.full((16, 16), 100, np.uint8)
    c = np.full((8, 8), 100, np.uint8)
    y2 = y.copy()
    y2 += 10
    p = psnr_yuv((y, c, c), (y2, c, c))
    assert p > psnr(y, y2)


@pytest.mark.parametrize("shape", [(64, 48), (66, 50), (1, 1)])
def test_equals_reference(shape):
    rng = np.random.default_rng(sum(shape))
    h, w = shape
    a = [rng.integers(0, 256, (h, w)).astype(np.uint8)] + [
        rng.integers(0, 256, (max(1, h // 2), max(1, w // 2))).astype(
            np.uint8) for _ in range(2)]
    b = [np.clip(p.astype(int) + rng.integers(-9, 10, p.shape), 0,
                 255).astype(np.uint8) for p in a]
    assert psnr(a[0], b[0]) == jq.psnr(a[0], b[0])
    assert psnr_yuv(a, b) == jq.psnr_yuv(a, b)
    if min(shape) >= 8:
        assert ssim(a[0], b[0]) == jq.ssim(a[0], b[0])
