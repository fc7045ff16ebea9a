"""The port's crop/scale resample (``filters/kernels.py``
``resample_plane`` on the CPU) equals the JAX package's byte for byte at
the DVD upscales to 1080p: 720x480 to 1440x1080 and 720x576 to
1920x1080, luma and 4:2:0 chroma (left-sited, the horizontal shift
-0.25), 8 and 10 bits.  These planes are 720 and 360 wide, not multiples
of 64, and have more output rows than input rows: XLA:CPU sums their
vertical product with four lanes (``vertical_order``), where the rule
before it kept one chain and 8-10 samples of a luma plane differed.

The same holds for a source so small that its planes are under 64 wide,
upscaled to 320x240: XLA sums their vertical product with four or two
lanes, by the plane's width, from 51 output rows on."""
import numpy as np
import pytest

from handbrake_tpu.filters import kernels as jk
from handbrake_tpu_torch.filters import kernels as tk

# (in_h, in_w, out_h, out_w, horizontal shift)
DVD = {"ntsc-luma": (480, 720, 1080, 1440, 0.0),
       "ntsc-chroma": (240, 360, 540, 720, -0.25),
       "pal-luma": (576, 720, 1080, 1920, 0.0),
       "pal-chroma": (288, 360, 540, 960, -0.25),
       "40x30-to-320x240-luma": (30, 40, 240, 320, 0.0),
       "40x30-to-320x240-chroma": (15, 20, 120, 160, -0.25),
       "60x46-to-320x240-chroma": (23, 30, 120, 160, -0.25)}


def _plane(h, w, bits, seed):
    """Smooth content plus noise, as a film frame's plane."""
    mx = (1 << bits) - 1
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = mx / 2 * (1 + np.sin(xx / 9.0) * np.cos(yy / 11.0))
    return np.clip(smooth + rng.normal(0, mx / 12, smooth.shape), 0,
                   mx).astype(np.uint8 if bits == 8 else np.uint16)


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("geometry", list(DVD))
def test_dvd_upscale_equals_reference(geometry, bits):
    in_h, in_w, out_h, out_w, sh = DVD[geometry]
    mx = (1 << bits) - 1
    plane = _plane(in_h, in_w, bits, in_w * 7 + in_h + bits)
    want = np.asarray(jk.resample_plane(plane, out_h, out_w, "lanczos",
                                        (0.0, sh), (0.0, sh), mx))
    got = tk.resample_plane(plane, out_h, out_w, "lanczos", (0.0, sh),
                            (0.0, sh), mx, device="cpu").numpy()
    assert got.shape == (out_h, out_w) and got.dtype == want.dtype
    assert np.array_equal(got, want), int((got != want).sum())
