"""The port's Matroska/WebM writer (``mux/mkv.py``) and demuxer
(``sources/mkv.py``) held against the JAX package's: the same samples,
chapters and WebM flag give the same bytes, and the port's demuxer reads
those files into the reference's tracks, chapters and packets.  Also the
copies themselves: each copied file equals its original (the decoder's
Python wrapper up to its one rewritten import)."""
import filecmp
import os

import pytest

import handbrake_tpu
import handbrake_tpu_torch
from handbrake_tpu.mux.mkv import MKVWriter as JMKVWriter
from handbrake_tpu.sources.mkv import MKVDemuxer as JMKVDemuxer
from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig, H264Encoder
from handbrake_tpu_torch.mux.mkv import MKVWriter
from handbrake_tpu_torch.sources.mkv import MKVDemuxer, probe_is_mkv
from handbrake_tpu_torch.sources.probe import open_source
from handbrake_tpu_torch.utils.synth import make_clip


def _aus(n=5, gop=3):
    """H.264 access units (annex-B, SPS/PPS on each IDR) of the port's
    encoder on the CPU."""
    enc = H264Encoder(EncoderConfig(width=48, height=32, qp=30, gop=gop,
                                    deblock=True, cabac=True,
                                    transform8x8=True), device="cpu")
    return [enc.encode_frame(*f) for f in make_clip(48, 32, n, seed=6)]


AUS = []


def _samples():
    if not AUS:
        AUS.extend(_aus())
    return AUS


# (webm, chapters, audio and subtitle tracks, fps)
WRITES = {
    "mkv-video": (False, False, False, 29.97),
    "mkv-chapters-audio-subs": (False, True, True, 25.0),
    "webm-video": (True, False, False, 30.0),
    "webm-chapters-audio": (True, True, True, 0.0),
}


def _write(Writer, path, case):
    webm, chapters, extra, fps = WRITES[case]
    w = Writer(path, webm=webm)
    v = w.add_video_track(codec="h264", width=48, height=32, fps=fps)
    a = s = None
    if extra:
        a = w.add_audio_track(codec="opus" if webm else "aac",
                              sample_rate=48000, channels=2,
                              private=b"\x12\x10", language="eng")
        if not webm:
            s = w.add_subtitle_track(codec="srt", language="fre")
    if chapters:
        w.add_chapter(0, "One")
        w.add_chapter(6006, "Two")
    for i, au in enumerate(_samples()):
        # 2.5 s apart from frame 3 on, so a new cluster starts there
        pts = i * 3003 + (225000 if i >= 3 else 0)
        w.write_sample(v, au, pts_90k=pts, duration_90k=3003,
                       sync=i % 3 == 0, annexb=True)
        if a is not None:
            w.write_sample(a, bytes([i]) * 9, pts_90k=pts + 100,
                           duration_90k=1920)
        if s is not None and i == 1:
            w.write_sample(s, b"hello", pts_90k=pts, duration_90k=9000)
    w.finalize()
    with open(path, "rb") as f:
        return f.read()


def _read(Demuxer, path):
    d = Demuxer(path)
    try:
        tracks = [(t.kind, t.codec, t.width, t.height, t.frame_rate,
                   t.extradata, t.sample_rate, t.channels, t.language)
                  for t in d.tracks]
        pkts = [(trk, b.pts, b.dts, b.duration, b.stop, int(b.frametype),
                 b.track_kind, bytes(b.data)) for trk, b in d.packets()]
        return (tracks, pkts, d.duration, list(getattr(d, "chapters", [])),
                d.seek(6006))
    finally:
        d.close()


@pytest.mark.parametrize("case", list(WRITES))
def test_mkv_writer_bytes_and_demuxer_equal_reference(tmp_path, case):
    got = _write(MKVWriter, str(tmp_path / "port.mkv"), case)
    want = _write(JMKVWriter, str(tmp_path / "ref.mkv"), case)
    assert got == want
    assert probe_is_mkv(got[:16])
    assert (b"webm" in got[:64]) == WRITES[case][0]
    for path in (str(tmp_path / "port.mkv"), str(tmp_path / "ref.mkv")):
        assert _read(MKVDemuxer, path) == _read(JMKVDemuxer, path)
    tracks, pkts, *_ = _read(MKVDemuxer, str(tmp_path / "port.mkv"))
    video = [p for p in pkts if p[0] == 0]
    # the samples come back as the annex-B the writer was given, less the
    # parameter sets, which went into the CodecPrivate (avcC)
    assert tracks[0][:2] == ("video", "h264") and \
        tracks[0][5].startswith(b"\x01")
    assert len(video) == len(_samples())
    # open_source takes Matroska now
    src = open_source(str(tmp_path / "port.mkv"))
    assert isinstance(src, MKVDemuxer)
    src.close()


# the port's motion compensation reads reference samples at coordinates
# clamped to the picture (spec 8.4.2.2.1); the reference slices its padded
# plane without bounds (test_torch_bframes holds the two)
_MC_CLAMP = (
    ("def mc_luma_block(",
     '''def _window(ref_pad: np.ndarray, pad: int, y: int, x: int, h: int,
            w: int) -> np.ndarray:
    """The h x w reference samples from picture coordinate (x, y), each
    read at its coordinate clamped to the picture (8.4.2.2.1), as int32.
    Inside the padded plane that is a plain slice of it."""
    r0, c0 = y + pad, x + pad
    if 0 <= r0 and r0 + h <= ref_pad.shape[0] \\
            and 0 <= c0 and c0 + w <= ref_pad.shape[1]:
        return ref_pad[r0:r0 + h, c0:c0 + w].astype(np.int32)
    rows = np.clip(np.arange(y, y + h), 0, ref_pad.shape[0] - 2 * pad - 1)
    cols = np.clip(np.arange(x, x + w), 0, ref_pad.shape[1] - 2 * pad - 1)
    return ref_pad[(rows + pad)[:, None], (cols + pad)[None, :]].astype(
        np.int32)


def mc_luma_block('''),
    ("""    r0, c0 = yi - 2 + pad, xi - 2 + pad
    win = ref_pad[r0:r0 + h + 5, c0:c0 + w + 5].astype(np.int32)
""", """    win = _window(ref_pad, pad, yi - 2, xi - 2, h + 5, w + 5)
"""),
    ("""    r0, c0 = yi + pad, xi + pad
    A = ref_pad[r0:r0 + h, c0:c0 + w].astype(np.int32)
    B = ref_pad[r0:r0 + h, c0 + 1:c0 + 1 + w].astype(np.int32)
    C = ref_pad[r0 + 1:r0 + 1 + h, c0:c0 + w].astype(np.int32)
    D = ref_pad[r0 + 1:r0 + 1 + h, c0 + 1:c0 + 1 + w].astype(np.int32)
""", """    win = _window(ref_pad, pad, yi, xi, h + 1, w + 1)
    A = win[:h, :w]
    B = win[:h, 1:]
    C = win[1:, :w]
    D = win[1:, 1:]
"""))

# every file the port copies from the JAX package, and the lines a copy
# may change
# the decoder's picture state moves from one global into each decoder
# (struct Dec), so decoders on different threads share nothing
_DEC_STATE = (
    ("""struct PicCtx {
    std::vector<uint8_t> blk_done;     // per luma 4x4: reconstructed
    std::vector<uint8_t> blk_parsed;   // per luma 4x4: syntax consumed
    std::vector<uint8_t> cblk_parsed[2];  // per chroma 4x4 (2x2 per MB)
    std::vector<int> mb_slice;         // slice id per MB (-1 = none)
    int slice_id = 0;
};

static PicCtx g_pc;    // single-threaded decode state
""", """// Each decoder owns its picture state (Dec::pc), so decoders on
// different threads share nothing; g_pc names the state of the decoder
// D that every function below has in scope.
#define g_pc (D.pc)
"""),
    ("""struct Dec {
""", """struct PicCtx {
    std::vector<uint8_t> blk_done;     // per luma 4x4: reconstructed
    std::vector<uint8_t> blk_parsed;   // per luma 4x4: syntax consumed
    std::vector<uint8_t> cblk_parsed[2];  // per chroma 4x4 (2x2 per MB)
    std::vector<int> mb_slice;         // slice id per MB (-1 = none)
    int slice_id = 0;
};

struct Dec {
"""),
    ("""    int slice_count_cur_pic = 0;
""", """    int slice_count_cur_pic = 0;
    PicCtx pc;                         // this decoder's picture state
"""))

# the job's pixel aspect: DisplayWidth/DisplayHeight written, read back
# with the stream's VUI aspect, and the B walker's SPS aspect (the
# reference writes and reads none)
_MKV_DISPLAY = (
    ("""    default_duration_ns: int = 0

""",
     """    default_duration_ns: int = 0
    display: tuple = ()        # DisplayWidth/Height where PAR is not 1:1

"""),
    ("""                        height: int = 0, private: bytes = b"",
                        fps: float = 0.0, language: str = "und") -> int:
        cid = {"h264": "V_MPEG4/ISO/AVC", "hevc": "V_MPEGH/ISO/HEVC",
""",
     """                        height: int = 0, private: bytes = b"",
                        fps: float = 0.0, language: str = "und",
                        par=(1, 1)) -> int:
        cid = {"h264": "V_MPEG4/ISO/AVC", "hevc": "V_MPEGH/ISO/HEVC",
"""),
    ("""                    default_duration_ns=dd)
        self.tracks.append(t)
""",
     """                    default_duration_ns=dd)
        if tuple(par) != (1, 1):
            from ..codecs.vui import display_size
            t.display = display_size(width, height, *par)
        self.tracks.append(t)
"""),
    ("""            if t.kind == "video":
                te += elem(0xE0, uint_e(0xB0, t.width)
                           + uint_e(0xBA, t.height))
            elif t.kind == "audio":
""",
     """            if t.kind == "video":
                # DisplayWidth/DisplayHeight in pixels (DisplayUnit 0)
                te += elem(0xE0, uint_e(0xB0, t.width)
                           + uint_e(0xBA, t.height)
                           + b"".join(uint_e(e, v) for e, v in
                                      zip((0x54B0, 0x54BA), t.display)))
            elif t.kind == "audio":
"""),
)

_MKV_SOURCE_ASPECT = (
    ("""import struct
from typing import Optional

from ..core.buffer import Buffer, FrameType
from ..mux.nal import avcc_to_annexb
from .common import DemuxError, TrackInfo

""",
     """import struct
from fractions import Fraction
from typing import Optional

from ..codecs.vui import display_size
from ..core.buffer import Buffer, FrameType
from ..mux.nal import avcc_to_annexb
from .common import DemuxError, TrackInfo, vui_sar

"""),
    ("""            dd_ns = 0
            for ceid, cp in _children(p):
""",
     """            dd_ns = 0
            display = {0x54B2: 0}     # DisplayWidth/Height/Unit
            for ceid, cp in _children(p):
"""),
    ("""                            ti.height = _uint(vp)
                elif ceid == 0xE1:    # audio
""",
     """                            ti.height = _uint(vp)
                        elif veid in (0x54B0, 0x54BA, 0x54B2):
                            display[veid] = _uint(vp)
                elif ceid == 0xE1:    # audio
"""),
    ("""                ti.frame_rate = (1000000000, dd_ns)
            if ti.codec == "h264" and len(ti.extradata) > 4:
""",
     """                ti.frame_rate = (1000000000, dd_ns)
            if ti.kind == "video":
                # the display size in pixels (DisplayUnit 0) gives the
                # pixel aspect, and the stream's VUI its exact value where
                # the two agree to the rounding of the display width (the
                # reference reads neither)
                sar = vui_sar(ti, ti.extradata, "mkv")
                dw, dh = display.get(0x54B0), display.get(0x54BA)
                if dw and dh and not display[0x54B2] and ti.width \\
                        and ti.height and not (sar and display_size(
                            ti.width, ti.height, *sar) == (dw, dh)):
                    f = Fraction(dw * ti.height, dh * ti.width)
                    sar = (f.numerator, f.denominator)
                if sar:
                    ti.par_num, ti.par_den = sar
            if ti.codec == "h264" and len(ti.extradata) > 4:
"""),
)

_B_SAR = (
    ("""from .tables import CBP_INTER_INV, ZIGZAG_4x4

""",
     """from .tables import CBP_INTER_INV, ZIGZAG_4x4
from ..vui import sar16

"""),
    ("""                       max_num_ref_frames=self.refs + 1,
                       vui_timing=(cfg.fps[1], 2 * cfg.fps[0]))
        self.pps = PPS(pic_init_qp=cfg.qp,
""",
     """                       max_num_ref_frames=self.refs + 1,
                       vui_timing=(cfg.fps[1], 2 * cfg.fps[0]),
                       sar=sar16(*cfg.sar, "h264: the pixel aspect"))
        self.pps = PPS(pic_init_qp=cfg.qp,
"""),
)

# an audio codec without a CodecID raises MuxError naming it (the
# reference raises a bare KeyError); the table moves to the module, where
# the job reads the codecs mkv carries
_MKV_AUDIO_REFUSAL = (
    ("""import struct
from dataclasses import dataclass, field

""",
     """import struct
from dataclasses import dataclass, field

from .common import MuxError

# the CodecID of each sound codec the writer carries
AUDIO_CODEC_IDS = {"aac": "A_AAC", "opus": "A_OPUS", "flac": "A_FLAC",
                   "vorbis": "A_VORBIS", "ac3": "A_AC3", "eac3": "A_EAC3",
                   "mp3": "A_MPEG/L3", "mp2": "A_MPEG/L2",
                   "pcm_s16le": "A_PCM/INT/LIT",
                   "truehd": "A_TRUEHD", "dts": "A_DTS"}

"""),
    ("""        cid = {"aac": "A_AAC", "opus": "A_OPUS", "flac": "A_FLAC",
               "vorbis": "A_VORBIS", "ac3": "A_AC3", "eac3": "A_EAC3",
               "mp3": "A_MPEG/L3", "mp2": "A_MPEG/L2",
               "pcm_s16le": "A_PCM/INT/LIT",
               "truehd": "A_TRUEHD", "dts": "A_DTS"}[codec]
""",
     """        if codec not in AUDIO_CODEC_IDS:
            raise MuxError(f"mkv: no CodecID for {codec!r} audio (it "
                           f"carries {', '.join(AUDIO_CODEC_IDS)})")
        cid = AUDIO_CODEC_IDS[codec]
"""),
)

COPIES = {
    "native/hbdec264.cpp": _DEC_STATE,
    "mux/mkv.py": _MKV_DISPLAY + _MKV_AUDIO_REFUSAL,
    "sources/mkv.py": _MKV_SOURCE_ASPECT,
    "codecs/h264/native_decoder.py": (
        ("        from ...native import get_lib\n",
         "        from ...native import get_decoder_lib as get_lib\n"),),
    "codecs/hdr.py": (),
    "codecs/h264/cavlc.py": (),
    "codecs/h264/encoder_b.py": _B_SAR,
    "codecs/h264/predict.py": _MC_CLAMP,
}


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
