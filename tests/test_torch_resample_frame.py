"""The resample kernel's frame entry (``filters/resample_cuda.py``
``resample_frame``: up to three planes in one launch) against the plain
version (``filters/kernels.py`` ``resample_plain``) on the card, bit for
bit: tiles with ragged edges (a tile multiple and one more or one less),
odd pitches and a base off the 16-byte grid (the byte-copy path), 8- and
16-bit planes, 16-bit output from 8-bit input, an 8x down lanczos, and
widths whose summation order has two and four lanes, blocks and a tail;
a frame's three planes count one launch.  They need an NVIDIA GPU and
skip elsewhere; on a machine with one:

    python -m pytest --noconftest tests/test_torch_resample_frame.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from handbrake_tpu_torch.filters import kernels as K
from handbrake_tpu_torch.filters import resample_cuda

pytestmark = pytest.mark.cuda

# (in_h, in_w, out_h, out_w, horizontal shift, kind, in bits, maxval)
CASES = {
    "tile+1": (66, 516, 17, 129, 0.0, "lanczos", 8, 255),
    "tile-1": (62, 508, 15, 127, -0.25, "lanczos", 8, 255),
    "tiles-2x": (70, 520, 33, 257, 0.0, "lanczos", 8, 255),
    "odd-pitch": (101, 333, 50, 166, 0.0, "lanczos", 8, 255),
    "u16-out": (64, 512, 32, 256, 0.0, "bicubic", 8, 1023),
    "u16-both": (97, 200, 48, 100, -0.25, "lanczos", 10, 1023),
    "down8": (544, 1024, 68, 128, 0.0, "lanczos", 8, 255),
    "lanes2": (600, 2080, 40, 88, 0.0, "bilinear", 8, 255),
    "lanes4-tail": (40, 2051, 30, 40, 0.0, "lanczos", 8, 255),
    "narrow": (1203, 12, 600, 6, 0.0, "lanczos", 10, 1023),
    "blocks": (1608, 130, 804, 65, 0.0, "lanczos", 8, 255),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _case(name, dev, seed=0, offset=0):
    in_h, in_w, out_h, out_w, sh, kind, bits, mx = CASES[name]
    rng = np.random.default_rng(seed + in_h + out_w)
    dt = np.uint8 if bits == 8 else np.uint16
    host = rng.integers(0, 1 << bits, in_h * in_w + offset).astype(dt)
    # a base `offset` samples past the allocation's start
    x = torch.from_numpy(host).to(dev)[offset:].view(in_h, in_w)
    bands = [torch.from_numpy(b).to(dev) for b in
             K.resample_band(in_h, out_h, kind)
             + K.resample_band(in_w, out_w, kind, sh, sh)]
    return x, bands, mx


@pytest.mark.parametrize("name", list(CASES))
def test_frame_equals_plain(dev, name):
    x, bands, mx = _case(name, dev)
    got = resample_cuda.resample_cuda(x, *bands, mx)
    want = K.resample_plain(x, *bands, mx)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [1, 3, 8])
def test_base_off_the_16_byte_grid(dev, offset):
    x, bands, mx = _case("tiles-2x", dev, offset=offset)
    assert not resample_cuda.vector_path(x.data_ptr(), x.shape[1],
                                         x.element_size())
    got = resample_cuda.resample_cuda(x, *bands, mx)
    assert torch.equal(got, K.resample_plain(x, *bands, mx))


def test_three_planes_one_launch(dev):
    items = [_case(n, dev) for n in ("tile+1", "odd-pitch", "down8")]
    before = resample_cuda.launches
    got = resample_cuda.resample_frame([(x, *b, mx) for x, b, mx in items])
    assert resample_cuda.launches == before + 1
    for (x, b, mx), g in zip(items, got):
        assert torch.equal(g, K.resample_plain(x, *b, mx))


def test_resample_planes_one_launch(dev):
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.integers(0, 256, (96, 160)).astype(
        np.uint8)).to(dev)
    u = torch.from_numpy(rng.integers(0, 256, (48, 80)).astype(
        np.uint8)).to(dev)
    specs = [(y, 40, 64, "lanczos", (0.0, 0.0), (0.0, 0.0), 255),
             (u, 20, 32, "lanczos", (0.0, -0.25), (0.0, -0.25), 255),
             (u, 20, 32, "lanczos", (0.0, -0.25), (0.0, -0.25), 255)]
    before = resample_cuda.launches
    got = K.resample_planes(specs)
    assert resample_cuda.launches == before + 1
    want = K.resample_planes([(p.cpu(), *rest) for p, *rest in specs])
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_frame_refuses_mixed_sample_sizes(dev):
    a, ba, _ = _case("tile+1", dev)
    b, bb, _ = _case("u16-both", dev)
    with pytest.raises(ValueError):
        resample_cuda.resample_frame([(a, *ba, 255), (b, *bb, 1023)])
