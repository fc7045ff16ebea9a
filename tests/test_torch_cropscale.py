"""The port's crop/scale (handbrake_tpu_torch.filters, on the CPU) held
against the JAX package's (handbrake_tpu.filters, JAX on the CPU).

Tolerance: the weight matrices are equal array for array; a resampled
sample may differ by at most 1 LSB (the two f32 products sum in another
order than XLA's), and the fraction that differs is printed; ``point``
(0/1 weights) is exact.  Filter-graph ordering and negotiated geometry
are equal."""
from fractions import Fraction

import numpy as np
import pytest
import torch

from handbrake_tpu.core.buffer import Buffer as JBuffer
from handbrake_tpu.core.buffer import Geometry as JGeometry
from handbrake_tpu.core.buffer import PIX_FMTS as J_PIX_FMTS
from handbrake_tpu.filters import kernels as jk
from handbrake_tpu.filters.base import FilterInit as JFilterInit
from handbrake_tpu.filters.cropscale import CropScaleFilter as JCropScale
from handbrake_tpu.filters.graph import FilterGraph as JFilterGraph
from handbrake_tpu.job import schema as JS
from handbrake_tpu_torch.core.buffer import PIX_FMTS, Buffer, Geometry
from handbrake_tpu_torch.filters import kernels as tk
from handbrake_tpu_torch.filters.base import FilterInit
from handbrake_tpu_torch.filters.cropscale import CropScaleFilter
from handbrake_tpu_torch.filters.graph import FilterGraph
from handbrake_tpu_torch.job import schema as S

KINDS = ("lanczos", "bicubic", "bilinear", "point")
# (in_h, in_w, out_h, out_w): down by 2, down by a non-integer ratio, up
SHAPES = {"down2": (48, 64, 24, 32), "down-odd": (45, 61, 32, 40),
          "up": (24, 32, 40, 56)}


def _within_one_lsb(got, want, exact, label):
    d = np.abs(np.asarray(got).astype(np.int64)
               - np.asarray(want).astype(np.int64))
    frac = float((d != 0).mean())
    print(f"{label}: max_abs_err {int(d.max())}, fraction that differs "
          f"{frac:.4g}")
    assert got.shape == want.shape and got.dtype == want.dtype
    assert int(d.max()) <= (0 if exact else 1), label
    return frac


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_in,n_out,shift", [(64, 32, 0.0), (61, 40, 0.0),
                                              (32, 56, 0.0), (32, 16, -0.25),
                                              (31, 20, -0.25),
                                              (16, 28, -0.25)])
def test_resample_matrix_equals_reference(kind, n_in, n_out, shift):
    got = tk.resample_matrix(n_in, n_out, kind, shift, shift)
    want = jk.resample_matrix(n_in, n_out, kind, shift, shift)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", KINDS)
def test_resample_plane_within_one_lsb(kind, shape, bits):
    in_h, in_w, out_h, out_w = SHAPES[shape]
    maxval = (1 << bits) - 1
    rng = np.random.default_rng(in_h * 1000 + out_w + bits)
    yy, xx = np.mgrid[0:in_h, 0:in_w]
    smooth = (maxval / 2 * (1 + np.sin(xx / 5.0) * np.cos(yy / 7.0)))
    plane = np.clip(smooth + rng.normal(0, maxval / 16, smooth.shape), 0,
                    maxval).astype(np.uint8 if bits == 8 else np.uint16)
    shift = (0.0, -0.25) if shape == "down2" else (0.0, 0.0)
    want = np.asarray(jk.resample_plane(plane, out_h, out_w, kind, shift,
                                        shift, maxval))
    got = tk.resample_plane(plane, out_h, out_w, kind, shift, shift, maxval,
                            device="cpu")
    assert got.device.type == "cpu"
    _within_one_lsb(got.numpy(), want, kind == "point",
                    f"resample {kind} {shape} {bits}-bit")


def _frame(w, h, seed, bits=8):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bits == 8 else np.uint16
    mx = (1 << bits) - 1
    return [rng.integers(0, mx + 1, s).astype(dt)
            for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]


# settings: odd crops, crop only (no resample), scale only, both, and a
# 10-bit frame
CROPSCALE = {
    "crop-odd-scale": (64, 48, 8, {"crop-top": 3, "crop-bottom": 5,
                                   "crop-left": 7, "crop-right": 1,
                                   "width": 32, "height": 24}),
    "crop-even-only": (64, 48, 8, {"crop-top": 4, "crop-bottom": 2,
                                   "crop-left": 6, "crop-right": 8}),
    "scale-up-bicubic": (48, 32, 8, {"width": 64, "height": 40,
                                     "method": "bicubic"}),
    "crop-scale-point": (64, 48, 8, {"crop-top": 2, "crop-left": 4,
                                     "width": 30, "height": 22,
                                     "method": "point"}),
    "crop-scale-10bit": (64, 48, 10, {"crop-top": 2, "crop-bottom": 2,
                                      "width": 40, "height": 26}),
}


@pytest.mark.parametrize("case", list(CROPSCALE))
def test_cropscale_filter_within_one_lsb(case):
    w, h, bits, st = CROPSCALE[case]
    fmt = "yuv420p" if bits == 8 else "yuv420p10"
    planes = _frame(w, h, len(case), bits)
    jf = JCropScale(dict(st))
    jfi = jf.init(JFilterInit(geometry=JGeometry(w, h),
                              pix_fmt=J_PIX_FMTS[fmt]))
    tf = CropScaleFilter(dict(st))
    tfi = tf.init(FilterInit(geometry=Geometry(w, h), pix_fmt=PIX_FMTS[fmt],
                             device="cpu"))
    assert (tfi.geometry, tfi.crop) == (
        Geometry(jfi.geometry.width, jfi.geometry.height), jfi.crop)
    jout = jf.work(JBuffer(planes=[p.copy() for p in planes],
                           pix_fmt=J_PIX_FMTS[fmt], pts=0, duration=3003))
    tout = tf.work(Buffer(planes=[p.copy() for p in planes],
                          pix_fmt=PIX_FMTS[fmt], pts=0, duration=3003))
    assert len(jout) == len(tout) == 1
    assert (tout[0].pts, tout[0].duration) == (0, 3003)
    exact = st.get("method") == "point" or "width" not in st
    for name, g, want in zip("YUV", tout[0].planes, jout[0].planes):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        _within_one_lsb(g, np.asarray(want), exact, f"{case} {name}")
    if "width" not in st:
        # a crop with no resample stays a numpy slice off the device
        assert all(isinstance(p, np.ndarray) for p in tout[0].planes)


# filter lists out of order, with the framerate shaper in each mode
GRAPHS = {
    "vfr-after-cropscale": [
        (S.FILTER_CROP_SCALE, {"crop-top": 2, "width": 32, "height": 24}),
        (S.FILTER_VFR, {"mode": 2, "rate-num": 30, "rate-den": 1})],
    "cfr-then-scale": [
        (S.FILTER_VFR, {"mode": 1, "rate-num": 25, "rate-den": 1}),
        (S.FILTER_CROP_SCALE, {"crop-left": 4, "crop-right": 4})],
    "vfr-only": [(S.FILTER_VFR, {"mode": 0})],
    "none": [],
}


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_filter_graph_order_and_geometry(graph):
    specs = GRAPHS[graph]
    assert S.FILTER_ORDER == JS.FILTER_ORDER
    jg = JFilterGraph([{"ID": i, "Settings": dict(s)} for i, s in specs],
                      JFilterInit(geometry=JGeometry(64, 48, 8, 9),
                                  vrate=Fraction(30000, 1001)))
    tg = FilterGraph([{"ID": i, "Settings": dict(s)} for i, s in specs],
                     FilterInit(geometry=Geometry(64, 48, 8, 9),
                                vrate=Fraction(30000, 1001), device="cpu"))
    assert [f.name for f in tg.filters] == [f.name for f in jg.filters]
    a, b = tg.fi_out, jg.fi_out
    assert (a.geometry.width, a.geometry.height, a.geometry.par_num,
            a.geometry.par_den) == (b.geometry.width, b.geometry.height,
                                    b.geometry.par_num, b.geometry.par_den)
    assert (a.vrate, a.cfr, a.crop) == (b.vrate, b.cfr, b.crop)


def test_unported_filter_raises_in_graph():
    fi = FilterInit(geometry=Geometry(64, 48), device="cpu")
    # render_sub is ported, and nlmeans takes tile_parallel (one card
    # runs every tile count as the untiled filter): the graph builds them
    g = FilterGraph([{"ID": S.FILTER_CROP_SCALE, "Settings": {}},
                     {"ID": S.FILTER_NLMEANS,
                      "Settings": {"tile_parallel": 2}}], fi)
    assert [f.name for f in g.filters] == ["nlmeans", "crop_scale"]
    assert g.filters[0].settings["tile_parallel"] == 2
    # an id no package knows is dropped by both, as the reference does
    assert FilterGraph([{"ID": 999, "Settings": {}}], fi).filters == []
