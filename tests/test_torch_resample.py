"""The port's banded resample (``filters/kernels.py``: ``resample_band``
and ``resample_plain``, the plain version of ``csrc/resample.cu``) held
against the JAX package's ``_apply_separable`` on the CPU, pass by pass.

- Pass 1 (vertical) must equal XLA's ``einsum("oh,hw->ow")`` bit for bit
  in every case: XLA:CPU sums it as a chain of f32 fmas over the taps in
  ascending order from 0, which is the port's order.
- Pass 2 (horizontal), on the same intermediate, equals XLA's
  ``einsum("ow,cw->oc")`` where XLA runs that chain too; at other shapes
  XLA:CPU picks another order.  The share of f32 values and of output
  samples that differ is printed, and the output must stay within
  PERF.md §2's gate: at most 1 LSB, on under 1 % of the samples.
- The band holds every nonzero weight of its matrix row, in order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handbrake_tpu.filters import kernels as jk
from handbrake_tpu_torch.filters import kernels as tk

KINDS = ("lanczos", "bicubic", "bilinear", "point")
# the cropscale cases (down by 2, by a non-integer ratio, up) and a
# 216x384 -> 108x192 case, where XLA's pass 2 is the ascending chain too
SHAPES = {"down2": (48, 64, 24, 32), "down-odd": (45, 61, 32, 40),
          "up": (24, 32, 40, 56), "down2-wide": (216, 384, 108, 192)}
# pass 2 equals XLA's at these shapes (an ascending chain there)
CHAIN_SHAPES = ("up", "down2-wide")

_pass1 = jax.jit(lambda a, x: jnp.einsum("oh,hw->ow", a,
                                         x.astype(jnp.float32)))
_pass2 = jax.jit(lambda x, a: jnp.einsum("ow,cw->oc", x, a))


def _plane(in_h, in_w, bits, seed):
    maxval = (1 << bits) - 1
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:in_h, 0:in_w]
    smooth = (maxval / 2 * (1 + np.sin(xx / 5.0) * np.cos(yy / 7.0)))
    return np.clip(smooth + rng.normal(0, maxval / 16, smooth.shape), 0,
                   maxval).astype(np.uint8 if bits == 8 else np.uint16)


def _bands(in_h, in_w, out_h, out_w, kind, shift):
    return [torch.from_numpy(b) for b in
            tk.resample_band(in_h, out_h, kind, shift[0], shift[0])
            + tk.resample_band(in_w, out_w, kind, shift[1], shift[1])]


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", KINDS)
def test_resample_passes_against_xla(kind, shape, bits):
    in_h, in_w, out_h, out_w = SHAPES[shape]
    maxval = (1 << bits) - 1
    plane = _plane(in_h, in_w, bits, in_h * 1000 + out_w + bits)
    shift = (0.0, -0.25) if shape.startswith("down2") else (0.0, 0.0)
    lo_v, taps_v, lo_h, taps_h = _bands(in_h, in_w, out_h, out_w, kind,
                                        shift)
    av = jk.resample_matrix(in_h, out_h, kind, shift[0], shift[0])
    ah = jk.resample_matrix(in_w, out_w, kind, shift[1], shift[1])
    x = torch.from_numpy(plane.astype(np.float32))
    p1 = tk._band_pass(x, lo_v, taps_v)
    want1 = np.asarray(_pass1(av, plane))
    assert np.array_equal(p1.numpy().view(np.uint32),
                          want1.view(np.uint32)), "pass 1 differs from XLA"
    p2 = tk._band_pass(p1.T, lo_h, taps_h).T
    want2 = np.asarray(_pass2(p1.numpy(), ah))
    f32_share = float((p2.numpy() != want2).mean())
    got = tk.resample_plane(plane, out_h, out_w, kind, shift, shift, maxval,
                            device="cpu").numpy()
    assert got.dtype == (np.uint8 if bits == 8 else np.uint16)
    assert np.array_equal(
        got, tk.resample_plain(torch.from_numpy(plane), lo_v, taps_v, lo_h,
                               taps_h, maxval).numpy())
    want = np.asarray(jk.resample_plane(plane, out_h, out_w, kind, shift,
                                        shift, maxval))
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    share = float((d != 0).mean())
    print(f"resample {kind} {shape} {bits}-bit: pass 1 equal; pass 2 f32 "
          f"values that differ from XLA's {f32_share:.4g}; output samples "
          f"that differ from the JAX package's {share:.4g} (max "
          f"{int(d.max())} LSB)")
    assert int(d.max()) <= 1 and share < 0.01
    if shape in CHAIN_SHAPES or kind == "point":
        assert f32_share == 0.0 and share == 0.0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_in,n_out,shift", [(64, 32, 0.0), (61, 40, 0.0),
                                              (32, 56, 0.0), (31, 20, -0.25),
                                              (1608, 804, 0.0),
                                              (1920, 960, -0.25), (7, 3, 0.0),
                                              (3, 7, -0.25)])
def test_band_holds_the_matrix_rows(kind, n_in, n_out, shift):
    a = tk.resample_matrix(n_in, n_out, kind, shift, shift)
    lo, taps = tk.resample_band(n_in, n_out, kind, shift, shift)
    assert lo.dtype == np.int32 and taps.dtype == np.float32
    assert lo.min() >= 0 and lo.max() + taps.shape[0] <= n_in
    assert taps.shape[1] == n_out and taps.flags.c_contiguous
    rebuilt = np.zeros_like(a)
    for o in range(n_out):
        rebuilt[o, lo[o]:lo[o] + taps.shape[0]] = taps[:, o]
    assert np.array_equal(rebuilt, a)
