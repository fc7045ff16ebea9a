"""The banded resample kernel (``csrc/resample.cu``, through
``filters/resample_cuda.py``) against its plain version
(``filters/kernels.py`` ``resample_plain``) on the card, bit for bit: every
kind, 8 and 10 bits, down, up, odd sizes, a single row and column, the
letterbox job's planes; ``resample_plane`` on a card tensor launches the
kernel once and counts it; the wrapper refuses what the kernel does not
take.  They need an NVIDIA GPU and skip elsewhere; on a machine with one:

    python -m pytest tests/test_torch_resample_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from handbrake_tpu_torch.filters import kernels as K
from handbrake_tpu_torch.filters import resample_cuda

pytestmark = pytest.mark.cuda

KINDS = ("lanczos", "bicubic", "bilinear", "point")
# (in_h, in_w, out_h, out_w, chroma siting shift)
SHAPES = {"down2": (48, 64, 24, 32, -0.25), "down-odd": (45, 61, 32, 40, 0.0),
          "up": (24, 32, 40, 56, 0.0), "one-row": (1, 97, 1, 50, 0.0),
          "one-col": (97, 1, 50, 1, 0.0), "odd-up": (37, 53, 91, 129, -0.25),
          "letterbox-luma": (1608, 3840, 804, 1920, 0.0),
          "letterbox-chroma": (804, 1920, 402, 960, -0.25)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _plane(h, w, bits, seed):
    rng = np.random.default_rng(seed)
    mx = (1 << bits) - 1
    return rng.integers(0, mx + 1, (h, w)).astype(
        np.uint8 if bits == 8 else np.uint16)


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_equals_plain(dev, kind, shape, bits):
    in_h, in_w, out_h, out_w, sh = SHAPES[shape]
    mx = (1 << bits) - 1
    x = torch.from_numpy(_plane(in_h, in_w, bits, in_h + out_w)).to(dev)
    bands = [torch.from_numpy(b).to(dev) for b in
             K.resample_band(in_h, out_h, kind) +
             K.resample_band(in_w, out_w, kind, sh, sh)]
    got = resample_cuda.resample_cuda(x, *bands, mx)
    want = K.resample_plain(x, *bands, mx)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == (out_h, out_w)
    assert torch.equal(got, want)


def test_resample_plane_launches_the_kernel(dev):
    plane = torch.from_numpy(_plane(64, 96, 8, 1)).to(dev)
    before = resample_cuda.launches
    out = K.resample_plane(plane, 30, 50, "lanczos")
    assert resample_cuda.launches == before + 1
    assert out.device.type == "cuda"
    assert torch.equal(out.cpu(), K.resample_plane(plane.cpu(), 30, 50,
                                                   "lanczos"))


def test_wrapper_checks_inputs(dev):
    bands = [torch.from_numpy(b).to(dev) for b in
             K.resample_band(16, 8) + K.resample_band(16, 8)]
    x = torch.zeros((16, 16), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError):
        resample_cuda.resample_cuda(x.float(), *bands, 255)
    with pytest.raises(ValueError):
        resample_cuda.resample_cuda(x.cpu(), *bands, 255)
    with pytest.raises(ValueError):
        resample_cuda.resample_cuda(x[:, :8], *bands, 255)
    with pytest.raises(ValueError):
        resample_cuda.resample_cuda(x, bands[0].long(), *bands[1:], 255)
    with pytest.raises(ValueError):
        resample_cuda.resample_cuda(x, *bands, 1 << 16)
