"""The port's HEVC codec (``handbrake_tpu_torch/codecs/hevc``) against the
JAX package's, on the CPU.  Tolerance: none; every comparison is
equality.

- Every copied module equals its original; the encoder differs only in
  the listed replacements (its device analysis is the port's torch
  analyzer, on the encoder's device).
- ``analyzer.analyze_ctus`` equals the reference's
  ``build_ctu_analyzer_fn`` on XLA:CPU, mv and sad, at 3x2 and 4x3 CTUs
  on gradient, noise and motion-at-the-coarse-edge frames, Main 8
  (maxval 255) and Main 10 (1023).
- ``HEVCEncoder(device="cpu")`` streams equal the JAX encoder's
  ``backend="device"`` streams over 6 frames at 96x64 and 88x56 with a
  per-frame qp, Main and Main 10, and the host search's streams equal
  its host search's; each stream decodes with the port's decoder to the
  encoder's reconstructions.
- A stream beyond the native decoder's subset (an SPS with SAO on, an
  NxN intra CU) raises ValueError naming the feature and ROADMAP item
  1.10; the reference's native decoder raises a bare AssertionError, and
  its registry (with libavcodec) switches the stream to libavcodec.
"""
import filecmp
import functools
import os

import jax
import numpy as np
import pytest
import torch

import handbrake_tpu
import handbrake_tpu_torch
from handbrake_tpu.codecs import registry as jreg
from handbrake_tpu.codecs.hevc import encoder as jenc
from handbrake_tpu.codecs.hevc import encoder_tpu
from handbrake_tpu.core.buffer import Buffer as JBuffer
from handbrake_tpu_torch.codecs import registry
from handbrake_tpu_torch.codecs.h264.bits import BitReader, split_annexb
from handbrake_tpu_torch.codecs.hevc import analyzer
from handbrake_tpu_torch.codecs.hevc import encoder as tenc
from handbrake_tpu_torch.codecs.hevc.decoder import HEVCDecoder
from handbrake_tpu_torch.codecs.hevc.syntax import NAL_SPS, nal_unit
from handbrake_tpu_torch.core.buffer import Buffer
from handbrake_tpu_torch.utils.synth import make_clip
from torch_catalog import reference  # noqa: F401  (a fixture)

# the encoder's device analysis is the port's torch analyzer, on the
# encoder's device, and the device backend is the default
_ENCODER = (
    ("""SURVEY.md §2.5). The batched TPU analysis path lives in encoder_tpu.py;
this walker owns the sequential CABAC (SURVEY.md §7 "Hard parts #1").
""", """SURVEY.md §2.5). The batched P-frame analysis runs as torch ops on the
encoder's device (analyzer.py); this walker owns the sequential CABAC
(SURVEY.md §7 "Hard parts #1").
"""),
    ("""from .tables import chroma_qp
""", """from .tables import chroma_qp
from ...utils.device import resolve_device
"""),
    ("""    backend: str = "host"   # "device" = batched jax CTU analysis for P frames
""", """    backend: str = "device"  # batched torch CTU analysis of P frames on the
                             # encoder's device; "host" = motion_search
"""),
    ('''    """Stateful one-ref HEVC encoder. encode_frame() -> annex-B bytes."""

    def __init__(self, cfg: EncoderConfig):
        self.cfg = cfg
''', '''    """Stateful one-ref HEVC encoder. encode_frame() -> annex-B bytes.
    device=None analyses P frames on the CUDA card; "cpu" on the CPU."""

    def __init__(self, cfg: EncoderConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
'''),
    ("""            from .encoder_tpu import build_ctu_analyzer
            self._analyzer = build_ctu_analyzer(self.cw, self.ch, cfg.qp,
                                                maxval=(1 << self.bd) - 1)
""", """            from .analyzer import build_ctu_analyzer
            self._analyzer = build_ctu_analyzer(self.cw, self.ch, cfg.qp,
                                                maxval=(1 << self.bd) - 1,
                                                device=self.device)
"""))

# the job's pixel aspect in the SPS's VUI (the reference writes
# aspect_ratio_info_present = 0)
_SYNTAX_SAR = (
    ("""from ..h264.bits import BitReader, BitWriter, ebsp_to_rbsp, rbsp_to_ebsp

""",
     """from ..h264.bits import BitReader, BitWriter, ebsp_to_rbsp, rbsp_to_ebsp
from ..vui import SAR_TABLE

"""),
    ("""    bit_depth: int = 8             # 8 (Main) or 10 (Main 10)

""",
     """    bit_depth: int = 8             # 8 (Main) or 10 (Main 10)
    sar: tuple = (1, 1)            # VUI aspect: Extended_SAR unless 1:1

"""),
    ("""            bw.put(1, 1)   # vui_parameters_present
            bw.put(0, 1)   # aspect_ratio_info_present
            bw.put(0, 1)   # overscan_info_present
""",
     """            bw.put(1, 1)   # vui_parameters_present
            if self.sar != (1, 1):
                bw.put(1, 1)   # aspect_ratio_info_present
                bw.put(255, 8)  # Extended_SAR
                bw.put(self.sar[0], 16)
                bw.put(self.sar[1], 16)
            else:
                bw.put(0, 1)   # aspect_ratio_info_present
            bw.put(0, 1)   # overscan_info_present
"""),
    ("""        vui = None
        if br.u(1):
            br.u(8)
            if br.u(1):
""",
     """        vui = None
        sar = (1, 1)
        if br.u(1):
            if br.u(1):    # aspect_ratio_info_present
                idc = br.u(8)
                sar = (br.u(16), br.u(16)) if idc == 255 \\
                    else SAR_TABLE.get(idc, (1, 1))
            br.u(7)
            if br.u(1):
"""),
    ("""                   level_idc=level, log2_max_poc_lsb=log2poc,
                   vui_timing=vui, bit_depth=bd)

""",
     """                   level_idc=level, log2_max_poc_lsb=log2poc,
                   vui_timing=vui, bit_depth=bd, sar=sar)

"""),
)

_ENCODER_SAR = (
    ("""from ...utils.device import resolve_device

""",
     """from ...utils.device import resolve_device
from ..vui import sar16

"""),
    ("""    bit_depth: int = 8      # 8 (Main) or 10 (Main 10) — encx265 multi-depth

""",
     """    bit_depth: int = 8      # 8 (Main) or 10 (Main 10) — encx265 multi-depth
    sar: tuple = (1, 1)     # the pixel aspect the VUI signals (1:1: none)

"""),
    ("""                       vui_timing=(cfg.fps[1], cfg.fps[0]),
                       bit_depth=self.bd)
        self.pps = PPS(init_qp=cfg.qp)
""",
     """                       vui_timing=(cfg.fps[1], cfg.fps[0]),
                       bit_depth=self.bd,
                       sar=sar16(*cfg.sar, "hevc: the pixel aspect"))
        self.pps = PPS(init_qp=cfg.qp)
"""),
)

COPIES = {f"codecs/hevc/{m}.py": () for m in (
    "__init__", "transform", "cabac", "residual", "predict", "decoder")}
COPIES["codecs/hevc/syntax.py"] = _SYNTAX_SAR
COPIES["codecs/hevc/encoder.py"] = _ENCODER + _ENCODER_SAR


@pytest.mark.parametrize("rel", list(COPIES))
def test_copy_equals_original(rel):
    port = os.path.join(os.path.dirname(handbrake_tpu_torch.__file__), rel)
    ref = os.path.join(os.path.dirname(handbrake_tpu.__file__), rel)
    if not COPIES[rel]:
        assert filecmp.cmp(port, ref, shallow=False)
        return
    with open(port) as f:
        got = f.read()
    with open(ref) as f:
        want = f.read()
    for old, new in COPIES[rel]:
        assert want.count(old) == 1 and got.count(new) == 1
        want = want.replace(old, new)
    assert got == want


def test_tables_copy_differs_only_in_a_path():
    """``codecs/hevc/tables.py`` is a copy whose docstring names
    HandBrake's ``libhb/encx265.c`` where the original names a path on
    the machine that wrote it."""
    def lines(pkg):
        path = os.path.join(os.path.dirname(pkg.__file__),
                            "codecs/hevc/tables.py")
        with open(path) as f:
            return f.readlines()
    got, want = lines(handbrake_tpu_torch), lines(handbrake_tpu)
    assert len(got) == len(want)
    assert [i for i, (a, b) in enumerate(zip(got, want)) if a != b] == [4]
    tail = "libhb/encx265.c wraps x265; we implement\n"
    assert got[4] == "SURVEY.md §2.5 — HandBrake's " + tail
    assert want[4].endswith(tail)


@pytest.fixture(scope="module", autouse=True)
def _shared_jax_analyzers():
    """The reference's encoders of one shape share one jitted analyzer."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(encoder_tpu, "build_ctu_analyzer",
                   functools.lru_cache(None)(encoder_tpu.build_ctu_analyzer))
        yield


@functools.lru_cache(None)
def _jax_analyzer(cw, ch, maxval):
    return jax.jit(encoder_tpu.build_ctu_analyzer_fn(cw, ch, 26, maxval))


def _analyzer_frames(kind, cw, ch, maxval, seed):
    """(src, ref) luma planes of 32 ch x 32 cw samples."""
    rng = np.random.default_rng(seed)
    h, w = 32 * ch, 32 * cw
    yy, xx = np.mgrid[0:h + 64, 0:w + 64]
    if kind == "noise":
        ref = rng.integers(0, maxval + 1, (h, w))
        src = rng.integers(0, maxval + 1, (h, w))
    elif kind == "gradient":
        big = (xx * 5 + yy * 3) * (maxval + 1) // (8 * (w + h + 128))
        ref = big[:h, :w]
        src = np.clip(big[2:h + 2, 3:w + 3]
                      + rng.integers(-2, 3, (h, w)), 0, maxval)
    else:
        # a texture moved by 20 columns and 21 rows: the coarse search's
        # edge (+-20 px) and past it
        big = (maxval * (0.5 + 0.25 * np.sin(xx / 5.0) * np.cos(yy / 7.0)
                         + 0.2 * ((xx // 9 + yy // 11) % 2))).astype(int)
        ref = big[32:32 + h, 32:32 + w]
        src = big[32 - 21:32 - 21 + h, 32 + 20:32 + 20 + w]
    return (np.clip(src, 0, maxval).astype(np.int32),
            np.clip(ref, 0, maxval).astype(np.int32))


@pytest.mark.parametrize("maxval", [255, 1023])
@pytest.mark.parametrize("kind", ["gradient", "noise", "clamp"])
@pytest.mark.parametrize("cw,ch", [(3, 2), (4, 3)])
def test_analyzer_equals_reference(cw, ch, kind, maxval):
    src, ref = _analyzer_frames(kind, cw, ch, maxval, seed=cw * 10 + ch)
    sub = src[::2, ::2]
    want = _jax_analyzer(cw, ch, maxval)(src, sub, sub, ref, ref[::2, ::2],
                                         ref[::2, ::2])
    got = analyzer.analyze_ctus(torch.from_numpy(src), torch.from_numpy(ref),
                                cw, ch, maxval)
    assert got["mv"].dtype == torch.int32 and got["sad"].dtype == torch.float32
    np.testing.assert_array_equal(got["mv"].numpy(), np.asarray(want["mv"]))
    np.testing.assert_array_equal(got["sad"].numpy(), np.asarray(want["sad"]))
    if kind == "clamp":
        # the coarse search went to its edge
        assert np.abs(got["mv"].numpy()).max() >= 4 * 20


def test_analyzer_builder_takes_numpy():
    """The encoder's call site: numpy planes in, numpy {"mv", "sad"} out,
    equal to the tensor function's."""
    src, ref = _analyzer_frames("gradient", 3, 2, 255, seed=1)
    f = analyzer.build_ctu_analyzer(3, 2, 30, device="cpu")
    got = f(src, None, None, ref, None, None)
    want = analyzer.analyze_ctus(torch.from_numpy(src), torch.from_numpy(ref),
                                 3, 2)
    assert set(got) == {"mv", "sad"}
    np.testing.assert_array_equal(got["mv"], want["mv"].numpy())
    np.testing.assert_array_equal(got["sad"], want["sad"].numpy())


QPS = (30, 26, 34, 22, 38, 28)


def _frames(w, h, bd, seed):
    frames = make_clip(w, h, len(QPS), seed=seed)
    if bd == 8:
        return frames
    rng = np.random.default_rng(seed)
    return [tuple((p.astype(np.uint16) << 2)
                  | rng.integers(0, 4, p.shape).astype(np.uint16)
                  for p in f) for f in frames]


def _encode(enc, frames):
    """(per-frame access units, the reconstructions after each frame)."""
    aus, recons = [], []
    for f, qp in zip(frames, QPS):
        aus.append(enc.encode_frame(*f, qp=qp))
        recons.append(tuple(np.array(p) for p in (enc.recon_y, enc.recon_u,
                                                  enc.recon_v)))
    return aus, recons


def _decodes_to(aus, recons, w, h):
    dec = HEVCDecoder()
    frames = [f for au in aus for f in dec.decode(au)]
    assert len(frames) == len(recons)
    for f, r in zip(frames, recons):
        for p, q, (ph, pw) in zip(f, r, ((h, w), (h // 2, w // 2),
                                         (h // 2, w // 2))):
            assert p.shape == (ph, pw)
            np.testing.assert_array_equal(p, q[:ph, :pw])


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("w,h", [(96, 64), (88, 56)])
def test_encoder_stream_equals_reference(w, h, bd, backend):
    frames = _frames(w, h, bd, seed=w + bd)
    kw = dict(width=w, height=h, qp=30, gop=4, bit_depth=bd, backend=backend)
    want, _ = _encode(jenc.HEVCEncoder(jenc.EncoderConfig(**kw)), frames)
    port = tenc.HEVCEncoder(tenc.EncoderConfig(**kw), device="cpu")
    got, recons = _encode(port, frames)
    assert got == want
    _decodes_to(got, recons, w, h)


def test_encoder_runs_on_the_card_by_default():
    """device=None is the CUDA card: without one, the encoder raises
    instead of analysing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tenc.HEVCEncoder(tenc.EncoderConfig(width=64, height=64))


# ---------------------------------------------------------------------------
# streams beyond the native subset
# ---------------------------------------------------------------------------
def sao_stream(w=64, h=64, n=2) -> bytes:
    """An annex-B stream of the port's encoder whose SPS sets
    sample_adaptive_offset_enabled_flag, which the native decoder does
    not implement."""
    enc = tenc.HEVCEncoder(tenc.EncoderConfig(width=w, height=h, qp=30),
                           device="cpu")
    out = b""
    for f in make_clip(w, h, n, seed=5):
        for nal in split_annexb(enc.encode_frame(*f)):
            if (nal[0] >> 1) & 0x3F == NAL_SPS:
                nal = nal_unit(NAL_SPS, _set_sao(_rbsp(nal)))
            else:
                nal = b"\x00\x00\x00\x01" + nal
            out += nal
    return out


def _rbsp(nal: bytes) -> bytes:
    from handbrake_tpu_torch.codecs.h264.bits import ebsp_to_rbsp
    return ebsp_to_rbsp(nal[2:])


def _set_sao(rbsp: bytes) -> bytes:
    """Set the SAO flag: read the SPS as SPS.parse does up to it."""
    br = BitReader(rbsp)
    br.u(8)
    br.u(8 + 32 + 4 + 32 + 12 + 8)      # profile_tier_level, general
    br.ue(), br.ue(), br.ue(), br.ue()  # ids, chroma format, size
    if br.u(1):
        for _ in range(4):
            br.ue()
    for _ in range(3):                  # bit depths, log2 max poc lsb
        br.ue()
    if br.u(1):
        for _ in range(3):
            br.ue()
    for _ in range(6):                  # CTB, TU sizes, hierarchy depths
        br.ue()
    br.u(2)                             # scaling lists, AMP
    b = bytearray(rbsp)
    b[br.pos // 8] |= 0x80 >> (br.pos % 8)
    return bytes(b)


class _NxN:
    """A CABAC encoder proxy that codes an intra CU's part_mode as NxN."""

    def __init__(self, enc):
        self._enc = enc

    def __getattr__(self, name):
        return getattr(self._enc, name)

    def bin(self, name, ctx, val):
        return self._enc.bin(name, ctx, 0 if name == "part_mode" else val)


class _NxNEncoder(tenc.HEVCEncoder):
    def _write_intra_ctu(self, enc, *a, **k):
        return super()._write_intra_ctu(_NxN(enc), *a, **k)


def nxn_stream(w=64, h=64) -> bytes:
    """An IDR whose intra CUs signal part_mode NxN (four PUs), which the
    native decoder does not implement."""
    enc = _NxNEncoder(tenc.EncoderConfig(width=w, height=h, qp=30),
                      device="cpu")
    return enc.encode_frame(*make_clip(w, h, 1, seed=6)[0])


BEYOND = {"sao": (sao_stream, "SAO unsupported"),
          "nxn": (nxn_stream, "NxN intra unsupported")}


@pytest.mark.parametrize("feature", list(BEYOND))
def test_beyond_subset_raises_stated_error(feature, monkeypatch, tmp_path,
                                           reference):
    """Where libavcodec is missing, the port raises ValueError naming the
    feature, ROADMAP item 1.10 and the missing library; the reference's
    native decoder raises a bare AssertionError, and its registry, where
    libavcodec is present, switches to it.  (With the library the port
    switches too, before the first frame: test_torch_avcodec_faults.)"""
    import torch_catalog_ref as ref_side
    from handbrake_tpu_torch.codecs import avcodec
    from torch_catalog import hide
    build, words = BEYOND[feature]
    stream = build()
    with monkeypatch.context() as m:
        hide(m, tmp_path)
        dec = registry.create_video_decoder("hevc")
        with pytest.raises(ValueError, match=r"ROADMAP item 1\.10\), and "
                           r"libavcodec is missing") as e:
            dec.feed(Buffer(data=stream, pts=0))
    assert words in str(e.value)
    with pytest.raises(AssertionError, match=words):
        jreg.HEVCVideoDecoder().feed(JBuffer(data=stream, pts=0))
    if avcodec.available():
        # the reference's libavcodec decode runs in the child
        _fed, _tail, name, fallback = reference(
            ref_side.decode, "hevc", b"", [dict(data=stream, pts=0)],
            flush=False)                           # no error
        assert name == "ResilientHEVCDecoder" and fallback


def test_beyond_subset_hvcc_raises(monkeypatch, tmp_path):
    """The same refusal where the SPS arrives in an hvcC (an mp4 or mkv
    track's configuration), with libavcodec missing."""
    from torch_catalog import hide
    hide(monkeypatch, tmp_path)
    from handbrake_tpu_torch.mux.nal import build_hvcc, extract_vps_sps_pps
    vps, sps, pps = extract_vps_sps_pps(sao_stream())
    with pytest.raises(ValueError, match="SAO unsupported"):
        registry.create_video_decoder(
            "hevc", build_hvcc(vps[0], sps[0], pps[0]))


def test_registry_decoder_labels_bit_depth():
    """Main 10 frames carry 10 bits (the reference labels them 8-bit,
    so its job path reads 10-bit samples as 8-bit ones)."""
    w, h = 64, 64
    frames = _frames(w, h, 10, seed=3)[:2]
    enc = tenc.HEVCEncoder(tenc.EncoderConfig(width=w, height=h, qp=30,
                                              bit_depth=10), device="cpu")
    got, jgot = [], []
    dec, jdec = registry.create_video_decoder("hevc"), jreg.HEVCVideoDecoder()
    for i, f in enumerate(frames):
        au = enc.encode_frame(*f)
        got += dec.feed(Buffer(data=au, pts=i))
        jgot += jdec.feed(JBuffer(data=au, pts=i))
    assert [f.pix_fmt.name for f in got] == ["yuv420p10"] * 2
    assert [f.pix_fmt.name for f in jgot] == ["yuv420p"] * 2
    assert dec.info()["pix_fmt"] == "yuv420p10"
    for a, b in zip(got, jgot):
        assert all(np.array_equal(p, q) for p, q in zip(a.planes, b.planes))
