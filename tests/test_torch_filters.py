"""The port's device filter suite (handbrake_tpu_torch.filters, on the
CPU) held against the JAX package's (handbrake_tpu.filters, JAX on the
CPU), filter class by filter class, on the same frames made from a seed
with numpy, at 8 and 10 bits where the filter takes both.

Tolerances: every integer filter (yadif, bwdif, comb_detect, decomb,
detelecine's weaves, deblock, deband, rotate, grayscale, pad, format's
depth shift) equals the reference byte for byte, with the same frames,
timestamps, flags and verdicts.  The float filters (hqdn3d, nlmeans, bm3d,
unsharp, lapsharp, chroma_smooth, colorspace) sum, raise to powers and
exponentiate in PyTorch's order and with its libm, not XLA's (which may
also contract a multiply and an add into one fma), so a sample whose f32
value lands within an ulp of a rounding boundary may differ by 1 LSB:
each such case asserts at most 1 LSB on under 1 % of samples and prints
the share.  bm3d's hard threshold on DCT sums is the exception the test
states with its measured bound.
"""
from fractions import Fraction

import numpy as np
import pytest
import torch

from handbrake_tpu.cli.__main__ import build_parser as jparser
from handbrake_tpu.cli.__main__ import main as jcli
from handbrake_tpu.core.buffer import PIX_FMTS as J_PIX_FMTS
from handbrake_tpu.core.buffer import Buffer as JBuffer
from handbrake_tpu.core.buffer import Geometry as JGeometry
from handbrake_tpu.filters import base as jbase
from handbrake_tpu.filters import graph as jgraph
from handbrake_tpu.filters.denoise import hqdn3d_plane as j_hqdn3d_plane
from handbrake_tpu_torch.cli.__main__ import apply_cli_overrides
from handbrake_tpu_torch.cli.__main__ import build_parser
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.core.buffer import PIX_FMTS, Buffer, BufFlags
from handbrake_tpu_torch.core.buffer import Geometry
from handbrake_tpu_torch.filters import base as tbase
from handbrake_tpu_torch.filters import graph as tgraph
from handbrake_tpu_torch.filters.deblock import deblock_plane
from handbrake_tpu_torch.filters.denoise import _gamma, hqdn3d_plane
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.job.schema import Job
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.utils.synth import make_interlaced_clip, write_y4m


@pytest.fixture(autouse=True)
def _reference_device_path(monkeypatch):
    """The JAX package's jobs run on its device path, as the port's do:
    some of its own tests leave HB_TPU_DISABLE_DEVICE=1 set for the rest
    of their process, which switches it to its host encoder."""
    monkeypatch.delenv("HB_TPU_DISABLE_DEVICE", raising=False)


SIZES = ((64, 48), (66, 50))


def _planes(w, h, bits, rng, t, interlaced):
    """One frame: smooth moving structure, steps and noise (so that every
    filter has work), optionally with its odd rows from a later time."""
    mx = (1 << bits) - 1
    out = []
    for pw, ph in ((w, h), ((w + 1) // 2, (h + 1) // 2),
                   ((w + 1) // 2, (h + 1) // 2)):
        yy, xx = np.mgrid[0:ph, 0:pw].astype(np.float64)
        shift = np.where(yy % 2 == 1, 3.0, 0.0) if interlaced else 0.0
        xs = xx + 2 * t + shift
        v = (0.45 + 0.25 * np.sin(xs / 5.0) * np.cos(yy / 7.0)
             + 0.15 * ((xs // 8 + yy // 8) % 2))
        v = v * mx + rng.normal(0, mx / 40, v.shape)
        out.append(np.clip(np.round(v), 0, mx).astype(
            np.uint8 if bits == 8 else np.uint16))
    return out


def _clip(w, h, n, bits, seed, interlaced=False):
    rng = np.random.default_rng(seed)
    return [_planes(w, h, bits, rng, t, interlaced) for t in range(n)]


def _fmt(bits):
    return "yuv420p" if bits == 8 else "yuv420p10"


def _feed(base, B, G, pix_fmts, fid, settings, clip, bits, fi_kw,
          flags=0, device=None):
    """Run one package's filter over `clip` and an EOF; returns the filter
    and its output buffers (EOF removed)."""
    h, w = clip[0][0].shape
    kw = dict(fi_kw)
    if device is not None:
        kw["device"] = device
    fi = base.FilterInit(geometry=G(w, h), pix_fmt=pix_fmts[_fmt(bits)],
                         **kw)
    f = base.create_filter(fid, dict(settings))
    f.init(fi)
    out = []
    for i, planes in enumerate(clip):
        b = B(planes=[p.copy() for p in planes], pix_fmt=pix_fmts[_fmt(bits)],
              pts=i * 3003, duration=3003, stop=(i + 1) * 3003)
        b.flags = flags
        out += f.work(b)
    out += f.work(B.eof())
    return f, [b for b in out if not b.is_eof()]


def _host(p):
    return p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)


def _close(got, want, exact, label):
    """At most 0 (exact) or 1 LSB apart, under 1 % of samples differing."""
    got, want = _host(got), _host(want)
    assert got.shape == want.shape and got.dtype == want.dtype, label
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    frac = float((d != 0).mean())
    print(f"{label}: max_abs_err {int(d.max())}, share that differs "
          f"{frac:.3g}")
    assert int(d.max()) <= (0 if exact else 1), label
    assert frac < 0.01, label
    return int(d.max()), frac


def _compare(fid, settings, clip, bits, exact, fi_kw=(), flags=0,
             label=""):
    fi_kw = dict(fi_kw)
    jf, jout = _feed(jbase, JBuffer, JGeometry, J_PIX_FMTS, fid, settings,
                     clip, bits, fi_kw, flags)
    tf, tout = _feed(tbase, Buffer, Geometry, PIX_FMTS, fid, settings,
                     clip, bits, fi_kw, flags, device="cpu")
    assert len(tout) == len(jout), label
    for k, (t, j) in enumerate(zip(tout, jout)):
        assert (t.pts, t.duration, t.stop, int(t.flags), t.combed) == \
            (j.pts, j.duration, j.stop, int(j.flags), j.combed), (label, k)
        assert len(t.planes) == len(j.planes)
        for n, (a, b) in enumerate(zip(t.planes, j.planes)):
            _close(a, b, exact, f"{label} frame {k} plane {n}")
    return tf, jf, tout, jout


# -- integer filters: byte for byte --------------------------------------
INTEGER = {
    "yadif": (S.FILTER_YADIF, {"mode": 3}, True),
    "yadif-no-spatial": (S.FILTER_YADIF, {"mode": 1}, True),
    "yadif-bob-parity0": (S.FILTER_YADIF, {"mode": 7, "parity": 0}, True),
    "bwdif": (S.FILTER_BWDIF, {"mode": 3}, True),
    "bwdif-bob": (S.FILTER_BWDIF, {"mode": 7}, True),
    "decomb-yadif-unanalysed": (S.FILTER_DECOMB, {"mode": 7}, True),
    "decomb-blend": (S.FILTER_DECOMB, {"mode": 2}, True),
    "decomb-cubic": (S.FILTER_DECOMB, {"mode": 4}, True),
    "deblock-weak": (S.FILTER_DEBLOCK, {"strength": "weak", "thresh": 20,
                                        "blocksize": 8}, False),
    "deblock-strong": (S.FILTER_DEBLOCK, {"strength": "strong",
                                          "thresh": 50, "blocksize": 4},
                       False),
    "deband-medium": (S.FILTER_DEBAND, {"range": 16, "thresh": 48}, False),
    "deband-light": (S.FILTER_DEBAND, {"range": 12, "thresh": 24}, False),
    "grayscale": (S.FILTER_GRAYSCALE, {}, False),
    "rotate-90": (S.FILTER_ROTATE, {"angle": 90}, False),
    "rotate-180-hflip": (S.FILTER_ROTATE, {"angle": 180, "hflip": 1}, False),
    "rotate-270": (S.FILTER_ROTATE, {"angle": 270}, False),
    "pad": (S.FILTER_PAD, {"width": 80, "height": 60, "color": "red"},
            False),
    "format-to-10bit": (S.FILTER_FORMAT, {"format": "yuv420p10"}, False),
}


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("size", SIZES, ids=["64x48", "66x50"])
@pytest.mark.parametrize("case", list(INTEGER))
def test_integer_filter_equals_reference(case, size, bits):
    fid, st, interlaced = INTEGER[case]
    if case == "format-to-10bit" and bits == 10:
        st = {"format": "yuv420p"}       # 10 → 8 bits
    clip = _clip(*size, 4, bits, seed=len(case) + bits, interlaced=interlaced)
    # top field first on the odd size: the deinterlacers' other parity
    flags = BufFlags.INTERLACED | (BufFlags.TOP_FIRST if size == (66, 50)
                                   else 0)
    _compare(fid, st, clip, bits, True, flags=int(flags),
             label=f"{case} {size} {bits}-bit")


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("preset", ["default", "fast"])
def test_comb_detect_and_decomb_equal_reference(preset, bits):
    """comb_detect's verdicts and mask, then decomb on the analysed frames
    (clean frames pass, the mask applies on luma only), as a graph."""
    from handbrake_tpu_torch.job import param
    st = param.generate_filter_settings(S.FILTER_COMB_DETECT, preset)
    # progressive frames, then interlaced ones, then progressive again
    clip = (_clip(64, 48, 2, bits, 3) + _clip(64, 48, 3, bits, 4, True)
            + _clip(64, 48, 2, bits, 5))
    specs = [{"ID": S.FILTER_COMB_DETECT, "Settings": st},
             {"ID": S.FILTER_DECOMB, "Settings": {"mode": 7}}]
    jg = jgraph.FilterGraph([dict(s) for s in specs], jbase.FilterInit(
        geometry=JGeometry(64, 48), pix_fmt=J_PIX_FMTS[_fmt(bits)]))
    tg = tgraph.FilterGraph([dict(s) for s in specs], tbase.FilterInit(
        geometry=Geometry(64, 48), pix_fmt=PIX_FMTS[_fmt(bits)],
        device="cpu"))
    jout, tout = [], []
    for i, planes in enumerate(clip):
        jout += jg.work(JBuffer(planes=[p.copy() for p in planes],
                                pix_fmt=J_PIX_FMTS[_fmt(bits)],
                                pts=i * 3003, duration=3003))
        tout += tg.work(Buffer(planes=[p.copy() for p in planes],
                               pix_fmt=PIX_FMTS[_fmt(bits)], pts=i * 3003,
                               duration=3003))
    jout += jg.flush()
    tout += tg.flush()
    assert len(tout) == len(jout) == len(clip)
    combed = [t.combed for t in tout]
    assert combed == [j.combed for j in jout]
    assert any(combed) and not all(combed), combed
    for k, (t, j) in enumerate(zip(tout, jout)):
        assert (t.pts, int(t.flags)) == (j.pts, int(j.flags))
        assert ("comb_mask" in t.side_data) == ("comb_mask" in j.side_data)
        for a, b in zip(t.planes, j.planes):
            _close(a, b, True, f"comb_detect {preset} + decomb frame {k}")


def test_comb_detect_mask_and_blocks_equal_reference():
    from handbrake_tpu.filters.comb_detect import comb_mask_and_blocks as jcm
    from handbrake_tpu_torch.filters.comb_detect import comb_mask_and_blocks
    clip = _clip(66, 50, 2, 8, 9, True)
    for metric in (0, 2):
        jm, jb = jcm(clip[1][0], clip[0][0], spatial_metric=metric,
                     block_w=8, block_h=8)
        tm, tb = comb_mask_and_blocks(
            torch.from_numpy(clip[1][0]).int(),
            torch.from_numpy(clip[0][0]).int(), spatial_metric=metric,
            block_w=8, block_h=8)
        assert np.array_equal(tm.numpy(), np.asarray(jm))
        assert np.array_equal(tb.numpy(), np.asarray(jb))
        assert int(tb.sum()) > 0


@pytest.mark.parametrize("bs", [2, 3, 4, 8])
@pytest.mark.parametrize("strong", [False, True])
def test_deblock_plane_edges_equal_reference(bs, strong):
    """The vectorized edges (bs >= 4) and the loop (bs < 4) against the
    reference's sequential .at[].set() loop."""
    from handbrake_tpu.filters.deblock import deblock_plane as jdeblock
    plane = _clip(66, 50, 1, 8, bs)[0][0]
    want = np.asarray(jdeblock(plane, bs=bs, thresh=40, strong=strong))
    got = deblock_plane(torch.from_numpy(plane), bs=bs, thresh=40,
                        strong=strong)
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, plane)


def _telecined(w, h, bits, seed):
    """3:2 pulldown of 8 film frames into 10 video frames: (top, bottom)
    source indices (0,0) (1,0) (1,1) (2,2) (3,3) per 4 film frames."""
    film = _clip(w, h, 8, bits, seed)
    pattern = [(0, 0), (1, 0), (1, 1), (2, 2), (3, 3)]
    frames = []
    for g in (0, 4):
        for t, b in pattern:
            fr = []
            for pt, pb in zip(film[g + t], film[g + b]):
                p = pt.copy()
                p[1::2] = pb[1::2]
                fr.append(p)
            frames.append(fr)
    return frames


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("kind", ["telecined", "still", "interlaced"])
def test_detelecine_equals_reference(kind, bits):
    """The same matches, drops and weaves as the reference; the weaves are
    exact.  Prints the smallest gap between a frame's best score and the
    next, the margin its f32 means had."""
    from handbrake_tpu.filters import detelecine as jdt
    clip = {"telecined": lambda: _telecined(64, 48, bits, 7),
            "still": lambda: _clip(64, 48, 1, bits, 8) * 8,
            "interlaced": lambda: _clip(64, 48, 8, bits, 9, True)}[kind]()
    gaps = []
    seen = []
    orig = jdt.comb_energy

    def spy(y):
        v = orig(y)
        seen.append(float(v))
        return v

    jdt.comb_energy = spy
    try:
        tf, jf, tout, jout = _compare(S.FILTER_DETELECINE, {}, clip, bits,
                                      True, label=f"detelecine {kind}")
    finally:
        jdt.comb_energy = orig
    for k in range(0, len(seen) - 2, 3):
        s = sorted(seen[k:k + 3])
        gaps.append(s[1] - s[0])
    assert tf.fi.cfr == jf.fi.cfr == 0
    assert [b.pts for b in tout] == [b.pts for b in jout]
    ties = sum(g == 0 for g in gaps)
    print(f"detelecine {kind} {bits}-bit: {len(tout)} of {len(clip)} frames "
          f"kept; {ties} of {len(gaps)} frames' best scores tied (equal "
          f"f32 means of equal weaves); smallest gap between unequal "
          f"scores {min((g for g in gaps if g > 0), default=None)}")
    if kind == "telecined":
        assert len(tout) < len(clip)


# -- float filters: within 1 LSB ------------------------------------------
FLOAT = {
    "hqdn3d-medium": (S.FILTER_DENOISE, {"y_spatial": 3.0, "cb_spatial": 2.0,
                                         "y_temporal": 2.0,
                                         "cb_temporal": 3.0}),
    "hqdn3d-strong": (S.FILTER_DENOISE, {"y_spatial": 7.0, "cb_spatial": 7.0,
                                         "y_temporal": 5.0,
                                         "cb_temporal": 5.0}),
    "hqdn3d-temporal-only": (S.FILTER_DENOISE, {"y_spatial": 0.0,
                                                "cb_spatial": 0.0,
                                                "y_temporal": 6.0}),
    "hqdn3d-spatial-only": (S.FILTER_DENOISE, {"y_spatial": 5.0,
                                               "y_temporal": 0.0,
                                               "cb_temporal": 0.0}),
    "unsharp-medium": (S.FILTER_UNSHARP, {"y_strength": 0.5, "y_size": 7}),
    "unsharp-chroma": (S.FILTER_UNSHARP, {"y_strength": 0.0,
                                          "cb_strength": 0.8,
                                          "cb_size": 5}),
    "lapsharp-isolap": (S.FILTER_LAPSHARP, {"y_strength": 0.3}),
    "lapsharp-log": (S.FILTER_LAPSHARP, {"y_strength": 0.5,
                                         "kernel": "isolog",
                                         "cb_kernel": "log"}),
    "chroma_smooth": (S.FILTER_CHROMA_SMOOTH, {"cb_strength": 1.3}),
    "chroma_smooth-sizes": (S.FILTER_CHROMA_SMOOTH, {"cb_strength": 0.6,
                                                     "cb_size": 3,
                                                     "cr_size": 9}),
}


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("size", SIZES, ids=["64x48", "66x50"])
@pytest.mark.parametrize("case", list(FLOAT))
def test_float_filter_within_one_lsb(case, size, bits):
    fid, st = FLOAT[case]
    clip = _clip(*size, 3, bits, seed=len(case) * 3 + bits)
    _compare(fid, st, clip, bits, False, label=f"{case} {size} {bits}-bit")


NLMEANS = {
    "medium": {"y_strength": 6.0, "y_origin_tune": 0.9, "cb_strength": 6.0,
               "cb_origin_tune": 0.9},
    "small-patch-3-frames": {"y_strength": 3.0, "y_patch_size": 3,
                             "y_range": 2, "cb_strength": 0.0,
                             "frame_count": 3},
}


# nlmeans is the slowest filter of the reference to compile (a 7x7 search
# over 2 frames is ~100 unrolled offsets), so fewer sizes than the others
@pytest.mark.parametrize("case,size,bits", [
    ("medium", (66, 50), 8), ("small-patch-3-frames", (64, 48), 10)])
def test_nlmeans_within_one_lsb(case, size, bits):
    """The search offsets and frames in the reference's order, the ring of
    previous frames carried (3 frames, so the third searches two)."""
    clip = _clip(*size, 3, bits, seed=len(case) + bits)
    _compare(S.FILTER_NLMEANS, NLMEANS[case], clip, bits, False,
             label=f"nlmeans {case} {size} {bits}-bit")


def test_hqdn3d_plain_state_within_reference():
    """The plain version's f32 state stays within a few ulps of the
    reference's over 4 frames with the temporal state carried."""
    clip = _clip(66, 50, 4, 8, 21)
    g_sp, g_tmp = _gamma(4.0), _gamma(6.0)
    ja = ta = None
    worst = 0.0
    for planes in clip:
        y = planes[0]
        if ja is None:
            ja = y.astype(np.float32)
            ta = torch.from_numpy(ja.copy())
        jo, ja = j_hqdn3d_plane(y, ja, g_sp=g_sp, g_tmp=g_tmp)
        to, ta = hqdn3d_plane(torch.from_numpy(y), ta, g_sp, g_tmp)
        ja = np.asarray(ja)
        _close(to, jo, False, "hqdn3d plane")
        worst = max(worst, float(np.abs(ta.numpy() - ja).max()))
    print(f"hqdn3d: largest f32 state difference {worst:.3g}")
    assert worst < 1e-3


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("sigma", [2.0, 4.0])
def test_bm3d_within_measured_bound(sigma, bits):
    """bm3d keeps a DCT coefficient where |c| > 2.7 sigma.  The port's DCT
    products sum in PyTorch's order, so a coefficient within an ulp of
    the threshold can be kept by one package and dropped by the other;
    that moves the block's estimate by that coefficient and its weight
    1/(1+N) for all the samples of the block.  The block matching is
    exact (integer SSDs below 2^24 at these sizes), so the groups are the
    same.  Measured on these inputs: equal in every sample (no threshold
    flipped), so the test holds bm3d to the bound of the other float
    filters, at most 1 LSB on under 1 % of samples."""
    clip = _clip(64, 48, 2, bits, seed=int(sigma) + bits)
    _compare(S.FILTER_BM3D, {"sigma": sigma}, clip, bits, False,
             label=f"bm3d sigma {sigma} {bits}-bit")


COLORSPACE = {
    "601-to-709": ({"matrix": "bt709"}, dict(color_matrix="bt601"), 8),
    "709-to-2020-full": ({"matrix": "bt2020", "range": "full",
                          "primaries": "bt2020"}, {}, 8),
    "pq-to-709-hable": ({"primaries": "bt709", "transfer": "bt709",
                         "matrix": "bt709", "tonemap": "hable"},
                        dict(color_prim="bt2020",
                             color_transfer="smpte2084",
                             color_matrix="bt2020"), 10),
    "hlg-to-709-reinhard": ({"primaries": "bt709", "transfer": "bt709",
                             "matrix": "bt709", "tonemap": "reinhard",
                             "desat": 0.0},
                            dict(color_prim="bt2020",
                                 color_transfer="arib-std-b67",
                                 color_matrix="bt2020"), 10),
    "pq-to-709-mobius": ({"primaries": "bt709", "transfer": "bt709",
                          "matrix": "bt709", "tonemap": "mobius",
                          "npl": 4000},
                         dict(color_prim="bt2020",
                              color_transfer="smpte2084",
                              color_matrix="bt2020"), 10),
    "pq-to-709-clip": ({"primaries": "bt709", "transfer": "bt709",
                        "matrix": "bt709", "tonemap": "clip"},
                       dict(color_prim="bt2020",
                            color_transfer="smpte2084",
                            color_matrix="bt2020"), 10),
    "full-range-601-to-709": ({"matrix": "bt709", "range": "limited"},
                              dict(color_matrix="bt601",
                                   color_range="full"), 8),
    "709-to-pq": ({"primaries": "bt2020", "transfer": "smpte2084",
                   "matrix": "bt2020"}, {}, 10),
    "709-to-hlg": ({"primaries": "bt2020", "transfer": "arib-std-b67",
                    "matrix": "bt2020"}, {}, 10),
    "noop": ({"matrix": "bt709"}, {}, 8),
}


@pytest.mark.parametrize("size", SIZES, ids=["64x48", "66x50"])
@pytest.mark.parametrize("case", list(COLORSPACE))
def test_colorspace_within_one_lsb(case, size):
    st, fi_kw, bits = COLORSPACE[case]
    clip = _clip(*size, 2, bits, seed=len(case))
    _compare(S.FILTER_COLORSPACE, st, clip, bits, False, fi_kw=fi_kw,
             label=f"colorspace {case} {size}")


def test_avfilter_graph_equals_reference():
    clip = _clip(64, 48, 3, 8, 11)
    _compare(S.FILTER_AVFILTER,
             {"graph": "deblock=thresh=30,deband=range=8:thresh=20,"
                       "transpose=angle=90"},
             clip, 8, True, label="avfilter")


def test_rpu_active_area_equals_reference():
    def run(base, B, G):
        f = base.create_filter(S.FILTER_RPU, {"source-width": 128,
                                              "source-height": 96})
        fi = base.FilterInit(geometry=G(64, 48))
        fi.crop = (4, 2, 6, 8)
        f.init(fi)
        b = B(planes=[np.zeros((48, 64), np.uint8)] * 3, pts=0)
        b.side_data["dovi_rpu"] = {"active_area": (16, 12, 8, 10)}
        return f.work(b)[0].side_data["dovi_rpu"]
    assert run(tbase, Buffer, Geometry) == run(jbase, JBuffer, JGeometry)


# -- the graph ----------------------------------------------------------
def test_graph_order_with_the_new_filters():
    """Every filter id the reference registers is accepted (render_sub
    included), in the reference's order; deband, missing from
    FILTER_ORDER, goes last in both."""
    specs = [{"ID": fid, "Settings": {}} for fid in sorted(
        jbase.registry()) if fid != S.FILTER_AVFILTER]
    specs.reverse()
    fi_kw = dict(geometry=(64, 48))
    jg = jgraph.FilterGraph([dict(s) for s in specs], jbase.FilterInit(
        geometry=JGeometry(*fi_kw["geometry"]), vrate=Fraction(30000, 1001)))
    tg = tgraph.FilterGraph([dict(s) for s in specs], tbase.FilterInit(
        geometry=Geometry(*fi_kw["geometry"]), vrate=Fraction(30000, 1001),
        device="cpu"))
    names = [f.name for f in tg.filters]
    assert names == [f.name for f in jg.filters]
    assert names[-1] == "deband"
    assert set(tbase.registry()) == set(jbase.registry())
    assert "render_sub" in names
    a, b = tg.fi_out, jg.fi_out
    assert (a.geometry.width, a.geometry.height, a.vrate, a.cfr) == \
        (b.geometry.width, b.geometry.height, b.vrate, b.cfr)


def test_mt_frame_is_disabled_like_the_reference():
    """mt_frame has a name but no filter class: both graphs disable it
    (logged), neither raises; render_sub, ported, is kept by both."""
    specs = [{"ID": S.FILTER_MT_FRAME, "Settings": {}},
             {"ID": S.FILTER_GRAYSCALE, "Settings": {}}]
    jg = jgraph.FilterGraph([dict(s) for s in specs],
                            jbase.FilterInit(geometry=JGeometry(64, 48)))
    tg = tgraph.FilterGraph([dict(s) for s in specs], tbase.FilterInit(
        geometry=Geometry(64, 48), device="cpu"))
    assert [f.name for f in tg.filters] == [f.name for f in jg.filters] \
        == ["grayscale"]
    specs = [{"ID": S.FILTER_MT_FRAME, "Settings": {}},
             {"ID": S.FILTER_RENDER_SUB, "Settings": {}}]
    jg = jgraph.FilterGraph([dict(s) for s in specs],
                            jbase.FilterInit(geometry=JGeometry(64, 48)))
    tg = tgraph.FilterGraph([dict(s) for s in specs], tbase.FilterInit(
        geometry=Geometry(64, 48), device="cpu"))
    assert [f.name for f in tg.filters] == [f.name for f in jg.filters] \
        == ["render_sub"]


def test_formerly_unported_nlmeans_tile_parallel_runs():
    """tile_parallel raised NotImplementedError; now the filter takes it
    and runs (on one card every tile count is the untiled filter)."""
    f = tbase.create_filter(S.FILTER_NLMEANS, {"tile_parallel": 2})
    f.init(tbase.FilterInit(geometry=Geometry(64, 48), device="cpu"))
    rng = np.random.default_rng(1)
    planes = [rng.integers(0, 256, (48, 64), np.uint8),
              rng.integers(0, 256, (24, 32), np.uint8),
              rng.integers(0, 256, (24, 32), np.uint8)]
    out = f.work(Buffer(planes=planes, pix_fmt=PIX_FMTS["yuv420p"]))[0]
    assert [tuple(p.shape) for p in out.planes] == [(48, 64), (24, 32),
                                                    (24, 32)]


def _cli_filters(argv, parser, apply):
    """The filter list the CLI's overrides give a bare job."""
    args = parser().parse_args(["-i", "x.y4m", "-o", "x.mp4"] + argv)
    job = apply(Job(path="x.y4m"), args)
    return [{"ID": f.id, "Settings": dict(f.settings)} for f in job.filters]


def test_graph_with_hqdn3d_nlmeans_within_one_lsb():
    """The filters `--hqdn3d --nlmeans` give, through the port's graph and
    the reference's, on 4 frames: within 1 LSB, under 1 % of samples."""
    from handbrake_tpu.cli.__main__ import apply_cli_overrides as japply
    from handbrake_tpu.job.schema import Job as JJob
    argv = ["--hqdn3d", "--nlmeans"]
    specs = _cli_filters(argv, build_parser, apply_cli_overrides)
    args = jparser().parse_args(["-i", "x.y4m", "-o", "x.mp4"] + argv)
    jspecs = [{"ID": f.id, "Settings": dict(f.settings)}
              for f in japply(JJob(path="x.y4m"), args).filters]
    assert specs == jspecs
    assert [s["ID"] for s in specs] == [S.FILTER_DENOISE, S.FILTER_NLMEANS]
    clip = _clip(66, 50, 4, 8, 31)
    jg = jgraph.FilterGraph(jspecs, jbase.FilterInit(
        geometry=JGeometry(66, 50)))
    tg = tgraph.FilterGraph(specs, tbase.FilterInit(
        geometry=Geometry(66, 50), device="cpu"))
    for i, planes in enumerate(clip):
        jo = jg.work(JBuffer(planes=[p.copy() for p in planes],
                             pix_fmt=J_PIX_FMTS["yuv420p"], pts=i))
        to = tg.work(Buffer(planes=[p.copy() for p in planes],
                            pix_fmt=PIX_FMTS["yuv420p"], pts=i))
        assert len(to) == len(jo) == 1
        for a, b in zip(to[0].planes, jo[0].planes):
            _close(a, b, False, f"--hqdn3d --nlmeans frame {i}")


# -- the CLI on an interlaced y4m ------------------------------------------
CLIP_W, CLIP_H, CLIP_N = 64, 48, 8


@pytest.fixture(scope="module")
def interlaced_y4m(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tfilt") / "woven.y4m")
    return write_y4m(path, make_interlaced_clip(CLIP_W, CLIP_H, CLIP_N,
                                                seed=3),
                     CLIP_W, CLIP_H, interlace="t")


def _samples(path):
    d = MP4Demuxer(path)
    try:
        ti = d.tracks[0]
        return ([bytes(b.data) for _, b in d.packets()], ti.extradata,
                (ti.width, ti.height))
    finally:
        d.close()


BASE_ARGV = ["-e", "h264", "-q", "28", "--encoder-profile", "high"]


def test_cli_integer_filters_equal_reference(interlaced_y4m, tmp_path):
    """--comb-detect --decomb --deblock --deband through the port's CLI and
    the JAX CLI on the CPU: byte-identical mp4 files."""
    argv = ["-i", interlaced_y4m, *BASE_ARGV, "--comb-detect", "--decomb",
            "--deblock", "--deband"]
    jout, tout = str(tmp_path / "ref.mp4"), str(tmp_path / "port.mp4")
    assert jcli(argv + ["-o", jout]) == 0
    assert cli(argv + ["-o", tout, "--device", "cpu"]) == 0
    with open(jout, "rb") as a, open(tout, "rb") as b:
        assert a.read() == b.read()
    got = _samples(tout)
    assert len(got[0]) == CLIP_N and got[2] == (CLIP_W, CLIP_H)
