"""The port's audio modules (``handbrake_tpu_torch/audio/`` and
``job/lang.py``, copies of the JAX package's host code) held to their
originals on seeded numpy input, with no tolerance: the outputs are bytes
and integer PCM, and the decoders' float PCM must be equal too.

- the tables of the AAC, AC-3 and MP2 codecs and the language table;
- the AAC-LC encoder's access units at 44.1 and 48 kHz, mono and stereo,
  two bit rates, and the AAC decoder's PCM of those streams;
- the AC-3 encoder and decoder at 1, 2 and 6 channels and 32, 44.1 and
  48 kHz;
- FLAC at 16 and 24 bits, encoder bytes and decoded samples;
- the MP2 decoder on Layer II and Layer I frames that this file writes
  itself (allocations, scalefactor selection, grouped and plain samples,
  joint stereo; no libavcodec);
- every ``dsp`` function, and the resample's weights: the port's
  ``filters/kernels.py`` ``resample_matrix`` against the JAX package's;
- ``AudioChain``'s packets and extradata for aac, ac3, flac, pcm and copy;
- the refusals: the libavcodec encoders (mp3, opus, vorbis) and decoders
  raise, and so do an unknown source codec, bad AAC extradata and a FLAC
  track without STREAMINFO.  Nothing is passed through or dropped.

No test here loads libavcodec."""
import functools

import numpy as np
import pytest

from handbrake_tpu import work as jwork
from handbrake_tpu.audio import aac as jaac
from handbrake_tpu.audio import aac_tables as jaac_tables
from handbrake_tpu.audio import aacdec as jaacdec
from handbrake_tpu.audio import ac3_tables as jac3_tables
from handbrake_tpu.audio import ac3dec as jac3dec
from handbrake_tpu.audio import ac3enc as jac3enc
from handbrake_tpu.audio import chain as jchain
from handbrake_tpu.audio import dsp as jdsp
from handbrake_tpu.audio import flac as jflac
from handbrake_tpu.audio import mp2_tables as jmp2_tables
from handbrake_tpu.audio import mp2dec as jmp2dec
from handbrake_tpu.core.buffer import Buffer as JBuffer
from handbrake_tpu.filters import kernels as jkernels
from handbrake_tpu.job import lang as jlang
from handbrake_tpu.job.schema import AudioJobTrack as JAudioJobTrack
from handbrake_tpu.sources.common import TrackInfo as JTrackInfo
from handbrake_tpu_torch import work
from handbrake_tpu_torch.audio import aac, aac_tables, aacdec, ac3_tables
from handbrake_tpu_torch.audio import ac3dec, ac3enc, chain, dsp, flac
from handbrake_tpu_torch.audio import mp2_tables, mp2dec
from handbrake_tpu_torch.core.buffer import Buffer
from handbrake_tpu_torch.filters import kernels
from handbrake_tpu_torch.job import lang
from handbrake_tpu_torch.job.schema import AudioJobTrack
from handbrake_tpu_torch.sources.common import TrackInfo


def _signal(sr, ch, n, seed=5):
    """Tones (one a channel) plus noise, float32 (n, ch)."""
    t = np.arange(n) / sr
    rng = np.random.default_rng(seed)
    return np.stack([0.3 * np.sin(2 * np.pi * (220 + 110 * c) * t)
                     + 0.05 * rng.standard_normal(n) for c in range(ch)],
                    1).astype(np.float32)


def _equal(a, b):
    """Equal values of equal type and shape (float arrays bit for bit)."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("__") and not callable(v)
            and not isinstance(v, type(np))}


@pytest.mark.parametrize("pair", ["aac_tables", "ac3_tables", "mp2_tables",
                                  "lang"])
def test_tables_equal(pair):
    ref, port = {"aac_tables": (jaac_tables, aac_tables),
                 "ac3_tables": (jac3_tables, ac3_tables),
                 "mp2_tables": (jmp2_tables, mp2_tables),
                 "lang": (jlang, lang)}[pair]
    want, got = _public(ref), _public(port)
    assert sorted(got) == sorted(want) and want
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert _equal(got[k], v), k
        else:
            assert got[k] == v, k
    if pair == "lang":
        for code in ("en", "fre", "deu", "Japanese", "xx", ""):
            assert lang.lookup(code) == jlang.lookup(code)
            assert lang.to_iso639_2(code) == jlang.to_iso639_2(code)


# -- AAC ---------------------------------------------------------------------
AAC_CASES = [(sr, ch, kbps) for sr in (44100, 48000) for ch in (1, 2)
             for kbps in (96, 160)]


@functools.lru_cache(None)
def _aac_streams(sr, ch, kbps):
    """(ASC, AUs) of the JAX encoder and of the port's, on 0.25 s."""
    pcm = _signal(sr, ch, sr // 4, seed=sr + ch + kbps)
    out = []
    for mod in (jaac, aac):
        enc = mod.AACEncoder(sr, ch, quality=132, bitrate=kbps * 1000)
        aus = enc.encode(pcm[:sr // 8]) + enc.encode(pcm[sr // 8:]) \
            + enc.flush()
        out.append((enc.audio_specific_config(), aus))
    return out


@pytest.mark.parametrize("sr,ch,kbps", AAC_CASES)
def test_aac_encoder_bytes_equal(sr, ch, kbps):
    (jasc, jaus), (asc, aus) = _aac_streams(sr, ch, kbps)
    assert asc == jasc
    assert len(aus) == len(jaus) >= sr // 4 // 1024
    assert aus == jaus


@pytest.mark.parametrize("sr,ch,kbps", AAC_CASES)
def test_aac_decoder_pcm_equal(sr, ch, kbps):
    (asc, aus), _ = _aac_streams(sr, ch, kbps)
    jd, d = jaacdec.AACDecoder(asc), aacdec.AACDecoder(asc)
    for au in aus:
        want = jd.decode_frame(au)
        assert _equal(d.decode_frame(au), want)
    assert (d.sample_rate, d.channels) == (jd.sample_rate, jd.channels)


def test_aac_mdct_matrix_built_once_is_the_same_product():
    """The port builds the MDCT matrix once; the JAX package rebuilds the
    same np.cos product on every call, so the coefficients are equal."""
    x = np.random.default_rng(1).standard_normal((3, 2048))
    assert _equal(aac._mdct_long(x), jaac._mdct_long(x))


# -- AC-3 --------------------------------------------------------------------
AC3_CASES = [(sr, ch) for ch in (1, 2, 6) for sr in (32000, 44100, 48000)]


@pytest.mark.parametrize("sr,ch", AC3_CASES)
def test_ac3_encoder_and_decoder_equal(sr, ch):
    pcm = _signal(sr, ch, 1536 * 3 + 700, seed=sr + ch)
    br = {1: 96000, 2: 192000, 6: 384000}[ch]
    jenc, enc = jac3enc.Ac3Encoder(sr, ch, br), ac3enc.Ac3Encoder(sr, ch, br)
    want = jenc.encode(pcm) + jenc.flush()
    got = enc.encode(pcm) + enc.flush()
    assert len(got) == 4 and got == want
    assert (enc.fscod, enc.acmod, enc.lfeon, enc.frmsizecod) == \
        (jenc.fscod, jenc.acmod, jenc.lfeon, jenc.frmsizecod)
    stream = b"".join(want)
    jd, d = jac3dec.Ac3Decoder(), ac3dec.Ac3Decoder()
    # split feeds: a syncframe cut between two packets
    cut = len(stream) // 3
    jout = jd.feed(stream[:cut]) + jd.feed(stream[cut:])
    out = d.feed(stream[:cut]) + d.feed(stream[cut:])
    assert len(out) == len(jout) == 4
    for a, b in zip(out, jout):
        assert _equal(a, b)
    assert (d.sample_rate, d.channels) == (jd.sample_rate, jd.channels)


# -- FLAC --------------------------------------------------------------------
@pytest.mark.parametrize("bits,ch", [(16, 1), (16, 2), (24, 1), (24, 2)])
def test_flac_encoder_and_decoder_equal(bits, ch):
    sr = 48000
    pcm = _signal(sr, ch, 4096 * 2 + 1000, seed=bits + ch)
    ints = np.round(pcm * ((1 << (bits - 1)) - 1)).astype(np.int32)
    jenc, enc = jflac.FlacEncoder(sr, ch, bits), flac.FlacEncoder(sr, ch, bits)
    want = jenc.encode(ints[:5000]) + jenc.encode(ints[5000:]) + jenc.flush()
    got = enc.encode(ints[:5000]) + enc.encode(ints[5000:]) + enc.flush()
    assert got == want
    assert enc.header() == jenc.header()
    # the float path of encode
    assert flac.FlacEncoder(sr, ch, bits).encode(pcm) == \
        jflac.FlacEncoder(sr, ch, bits).encode(pcm)
    dec = flac.FlacDecoder(enc.header() + got).decode_all()
    assert _equal(dec, jflac.FlacDecoder(jenc.header() + want).decode_all())
    assert np.array_equal(dec, ints)          # lossless


# -- MP2 ---------------------------------------------------------------------
class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, v, n):
        self.bits += [(v >> (n - 1 - i)) & 1 for i in range(n)]

    def bytes(self, size):
        b = self.bits + [0] * (size * 8 - len(self.bits))
        assert len(b) == size * 8
        return np.packbits(np.array(b, np.uint8)).tobytes()


def _mp2_frame(rng, layer, sr, kbps, mode, mode_ext=0):
    """One MPEG-1 Layer I or II frame with random allocations (the lowest
    subbands, within the frame's bit budget), scalefactor selection,
    scalefactors and sample codes, written to the decoder's syntax (ISO
    11172-3 tables B.2 for Layer II)."""
    M = jmp2dec
    nch = 1 if mode == 3 else 2
    br_idx = (M._BITRATES_L2 if layer == 2 else M._BITRATES_L1).index(kbps)
    sr_idx = M._SRATES.index(sr)
    if layer == 2:
        size = 144 * kbps * 1000 // sr
    else:
        size = 12 * kbps * 1000 // sr * 4
    bw = _BitWriter()
    bw.put(0xFFF, 12)
    bw.put(1, 1)                                  # MPEG-1
    bw.put(4 - layer, 2)
    bw.put(1, 1)                                  # no CRC
    bw.put(br_idx, 4)
    bw.put(sr_idx, 2)
    bw.put(0, 1)                                  # no padding
    bw.put(0, 1)
    bw.put(mode, 2)
    bw.put(mode_ext, 2)
    bw.put(0, 4)                                  # copyright ... emphasis
    budget = size * 8 - 32 - 200
    if layer == 2:
        table = M._TABLES[M._select_table(sr, kbps, nch)]
        nsb = len(table)
        bound = min((mode_ext + 1) * 4, nsb) if mode == 1 else nsb
        chans = [nch if sb < bound else 1 for sb in range(nsb)]
        alloc = np.zeros((nch, nsb), np.int64)
        used = sum(nbal * c for (nbal, _s), c in zip(table, chans))
        for sb in range(nsb):
            nbal, steps = table[sb]
            for c in range(chans[sb]):
                a = int(rng.integers(1, min(len(steps), 6) + 1))
                n = steps[a - 1]
                bits, grouped = M._QBITS[n]
                cost = 2 + 18 + 12 * (bits if grouped else 3 * bits)
                if used + cost * (2 if chans[sb] == 1 and nch == 2 else 1) \
                        > budget:
                    continue
                used += cost * (2 if chans[sb] == 1 and nch == 2 else 1)
                alloc[c, sb] = a
            if chans[sb] == 1:
                alloc[1:, sb] = alloc[0, sb]
        for sb in range(nsb):
            for c in range(chans[sb]):
                bw.put(int(alloc[c, sb]), table[sb][0])
        scfsi = rng.integers(0, 4, (nch, nsb))
        for sb in range(nsb):
            for c in range(nch):
                if alloc[c, sb]:
                    bw.put(int(scfsi[c, sb]), 2)
        for sb in range(nsb):
            for c in range(nch):
                if alloc[c, sb]:
                    k = {0: 3, 1: 2, 2: 1, 3: 2}[int(scfsi[c, sb])]
                    for _ in range(k):
                        bw.put(int(rng.integers(0, 40)), 6)
        for _gr in range(12):
            for sb in range(nsb):
                for c in range(chans[sb]):
                    a = int(alloc[c, sb])
                    if not a:
                        continue
                    n = table[sb][1][a - 1]
                    bits, grouped = M._QBITS[n]
                    if grouped:
                        bw.put(int(rng.integers(0, n ** 3)), bits)
                    else:
                        for _ in range(3):
                            bw.put(int(rng.integers(0, n)), bits)
    else:
        bound = (mode_ext + 1) * 4 if mode == 1 else 32
        chans = [nch if sb < bound else 1 for sb in range(32)]
        alloc = np.zeros((nch, 32), np.int64)
        used = 4 * sum(chans)
        for sb in range(32):
            for c in range(chans[sb]):
                a = int(rng.integers(1, 6))
                cost = (6 + 12 * (a + 1)) * (2 if chans[sb] == 1
                                             and nch == 2 else 1)
                if used + cost <= budget:
                    used += cost
                    alloc[c, sb] = a
            if chans[sb] == 1:
                alloc[1:, sb] = alloc[0, sb]
        for sb in range(32):
            for c in range(chans[sb]):
                bw.put(int(alloc[c, sb]), 4)
        for sb in range(32):
            for c in range(nch):
                if alloc[c, sb]:
                    bw.put(int(rng.integers(0, 40)), 6)
        for _gr in range(12):
            for sb in range(32):
                for c in range(chans[sb]):
                    a = int(alloc[c, sb])
                    if a:
                        bw.put(int(rng.integers(0, (1 << (a + 1)) - 1)),
                               a + 1)
    return bw.bytes(size)


# (layer, sample rate, kb/s, mode, mode_ext): each Layer II allocation
# table of ISO 11172-3 B.2, mono, stereo and joint stereo, and Layer I
MP2_CASES = [(2, 48000, 192, 0, 0), (2, 44100, 160, 0, 0),
             (2, 48000, 64, 0, 0), (2, 32000, 64, 0, 0),
             (2, 48000, 96, 3, 0), (2, 44100, 224, 1, 2),
             (1, 48000, 384, 0, 0), (1, 44100, 256, 1, 1)]


@functools.lru_cache(None)
def _mp2_stream(layer, sr, kbps, mode, mode_ext):
    rng = np.random.default_rng(layer * 7 + sr + kbps + mode)
    return b"".join(_mp2_frame(rng, layer, sr, kbps, mode, mode_ext)
                    for _ in range(4))


@pytest.mark.parametrize("layer,sr,kbps,mode,mode_ext", MP2_CASES)
def test_mp2_decoder_equal(layer, sr, kbps, mode, mode_ext):
    stream = _mp2_stream(layer, sr, kbps, mode, mode_ext)
    jd, d = jmp2dec.Mp2Decoder(), mp2dec.Mp2Decoder()
    cut = len(stream) // 2 + 3
    want = jd.feed(stream[:cut]) + jd.feed(stream[cut:])
    got = d.feed(stream[:cut]) + d.feed(stream[cut:])
    # every frame the writer built decodes (none skipped as malformed)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert _equal(a, b) and np.abs(a).max() > 0
    assert (d.sample_rate, d.channels) == (sr, 1 if mode == 3 else 2)


# -- dsp ---------------------------------------------------------------------
MIXDOWNS = ["mono", "stereo", "dpl2", "5point1", "7point1", "none"]


@pytest.mark.parametrize("in_ch", [1, 2, 3, 4, 6, 8])
def test_dsp_mixdown_equal(in_ch):
    pcm = _signal(48000, in_ch, 300, seed=in_ch)
    for m in MIXDOWNS:
        assert _equal(dsp.mixdown_matrix(in_ch, m),
                      jdsp.mixdown_matrix(in_ch, m)), m
        assert _equal(dsp.apply_mixdown(pcm, m), jdsp.apply_mixdown(pcm, m))


@pytest.mark.parametrize("sr_in,sr_out", [(44100, 48000), (48000, 44100),
                                          (48000, 32000), (22050, 48000),
                                          (48000, 48000)])
def test_dsp_resample_equal(sr_in, sr_out):
    pcm = _signal(sr_in, 2, 1537, seed=sr_in)
    assert _equal(dsp.resample(pcm, sr_in, sr_out),
                  jdsp.resample(pcm, sr_in, sr_out))
    n_out = int(round(1537 * sr_out / sr_in))
    # the weights come from the port's own crop/scale module
    assert _equal(kernels.resample_matrix(1537, n_out, "lanczos"),
                  jkernels.resample_matrix(1537, n_out, "lanczos"))


def test_dsp_gain_drc_compressor_gate_equal():
    pcm = _signal(48000, 2, 4000, seed=9) * 3
    for g in (0.0, -6.0, 3.5):
        assert _equal(dsp.apply_gain(pcm, g), jdsp.apply_gain(pcm, g))
    for drc in (0.0, 1.0, 2.5, 4.0):
        assert _equal(dsp.apply_drc(pcm, drc), jdsp.apply_drc(pcm, drc))
    for cls, kw in ((dsp.Compressor, {"ratio": 4.0}),
                    (dsp.Gate, {"threshold_db": -20.0})):
        jcls = getattr(jdsp, cls.__name__)
        a, b = cls(48000, **kw), jcls(48000, **kw)
        for part in (pcm[:1500], pcm[1500:], pcm[:700, 0]):
            assert _equal(a.process(part), b.process(part))
        assert a.env == b.env


# -- AudioChain --------------------------------------------------------------
def _ti(mod, codec, sr, ch, extradata=b""):
    return mod(kind="audio", codec=codec, sample_rate=sr, channels=ch,
               extradata=extradata)


# (encoder, mixdown, samplerate, gain, drc, compressor, gate, source
# rate, channels)
CHAIN_CASES = {
    "aac": ("aac", "stereo", 0, 0.0, 0.0, 0.0, 0.0, 48000, 2),
    "aac-5.1-44k": ("aac", "stereo", 44100, -2.0, 2.0, 0.0, 0.0, 48000, 6),
    "ac3-5.1": ("ac3", "5point1", 0, 0.0, 0.0, 0.0, 0.0, 48000, 6),
    "ac3-44k-to-48k": ("ac3", "stereo", 48000, 0.0, 0.0, 3.0, -50.0,
                       44100, 2),
    "flac-mono": ("flac", "mono", 0, 1.5, 0.0, 0.0, 0.0, 48000, 2),
    "pcm": ("pcm", "stereo", 32000, 0.0, 0.0, 0.0, 0.0, 48000, 2),
}


def _run_chain(ch_mod, spec_cls, ti_cls, buf_cls, case):
    enc, mix, rate, gain, drc, comp, gate, sr, ch = CHAIN_CASES[case]
    spec = spec_cls(track=0, encoder=enc, bitrate=128, mixdown=mix,
                    samplerate=rate, gain=gain, drc=drc, compressor=comp,
                    gate=gate)
    c = ch_mod.AudioChain(spec, _ti(ti_cls, "pcm_s16le", sr, ch))
    pcm = _signal(sr, ch, sr // 10, seed=ch)
    pkts = []
    for i in range(0, len(pcm), 1601):
        b = buf_cls(track_kind="audio", pts=i * 90000 // sr)
        b.planes = [pcm[i:i + 1601]]
        pkts += c.process(b)
    pkts += c.flush()
    return ([(bytes(p.data), p.pts, p.duration, p.stop) for p in pkts],
            c.extradata(), c.extradata(initial=True), c.out_codec(),
            c.sr_out, c.out_channels)


@pytest.mark.parametrize("case", list(CHAIN_CASES))
def test_audio_chain_packets_equal(case):
    got = _run_chain(chain, AudioJobTrack, TrackInfo, Buffer, case)
    want = _run_chain(jchain, JAudioJobTrack, JTrackInfo, JBuffer, case)
    assert got[0] and got == want


def test_audio_chain_copy_equal():
    """copy: the packets pass through unchanged, with the source's
    extradata; the codec is the source's."""
    out = []
    for ch_mod, spec_cls, ti_cls, buf_cls in (
            (chain, AudioJobTrack, TrackInfo, Buffer),
            (jchain, JAudioJobTrack, JTrackInfo, JBuffer)):
        c = ch_mod.AudioChain(spec_cls(track=0, encoder="copy:aac"),
                              _ti(ti_cls, "aac", 48000, 2, b"\x11\x90"))
        pkts = []
        for i in range(3):
            b = buf_cls(data=bytes([i]) * 9, track_kind="audio",
                        pts=i * 1920, duration=1920)
            pkts += c.process(b)
        empty = buf_cls(track_kind="audio")
        pkts += c.process(empty) + c.flush()
        out.append(([(bytes(p.data), p.pts, p.duration) for p in pkts],
                    c.extradata(), c.out_codec(), c.is_passthrough()))
    assert out[0] == out[1]
    assert out[0][1:] == (b"\x11\x90", "aac", True)


# -- refusals ----------------------------------------------------------------
@pytest.mark.parametrize("codec", ["mp3", "opus", "vorbis"])
def test_libavcodec_encoders_raise(codec, monkeypatch, tmp_path):
    """With libavcodec missing, the chain raises naming it; the reference
    encodes FLAC instead."""
    from torch_catalog import MISSING, hide
    hide(monkeypatch, tmp_path)
    spec = AudioJobTrack(track=0, encoder=codec)
    with pytest.raises(work.WorkError, match=rf"{codec}.*{MISSING}"):
        chain.AudioChain(spec, _ti(TrackInfo, "pcm_s16le", 48000, 2))


@pytest.mark.parametrize("codec", ["eac3", "opus", "dts", "truehd", "mp3",
                                   "vorbis"])
def test_libavcodec_decoders_raise(codec, monkeypatch, tmp_path):
    """The reference decodes these through libavcodec, or passes the
    packets to a chain that drops them where libavcodec is missing; the
    port raises naming the codec and the missing library there."""
    from torch_catalog import MISSING, hide
    hide(monkeypatch, tmp_path)
    with pytest.raises(work.WorkError, match=rf"{codec}.*{MISSING}"):
        work._make_audio_decoder(_ti(TrackInfo, codec, 48000, 2),
                                 AudioJobTrack(track=0, encoder="aac"))
    # the copy of such a track needs no decoder, as in the reference
    assert isinstance(work._make_audio_decoder(
        _ti(TrackInfo, codec, 48000, 2),
        AudioJobTrack(track=0, encoder=f"copy:{codec}")),
        work._CopyAudioDecoder)


def test_undecodable_tracks_raise():
    spec = AudioJobTrack(track=0, encoder="aac")
    with pytest.raises(work.WorkError, match="alac"):
        work._make_audio_decoder(_ti(TrackInfo, "alac", 48000, 2), spec)
    # bad extradata: the reference's decoder cannot start, and it passes
    # the track through to a chain that drops it
    with pytest.raises(Exception):
        jaacdec.AACDecoder(b"\x12")
    assert isinstance(jwork._make_audio_decoder(
        _ti(JTrackInfo, "aac", 48000, 2, b"\x12"),
        JAudioJobTrack(track=0, encoder="aac")), jwork._CopyAudioDecoder)
    with pytest.raises(work.WorkError, match="aac"):
        work._make_audio_decoder(_ti(TrackInfo, "aac", 48000, 2, b"\x12"),
                                 spec)
    with pytest.raises(work.WorkError, match="flac"):
        work._make_audio_decoder(_ti(TrackInfo, "flac", 48000, 2), spec)
    for codec, cls in (("aac", work._AacPacketDecoder),
                       ("ac3", work._Ac3PacketDecoder),
                       ("mp2", work._Mp2PacketDecoder),
                       ("pcm_s16le", work._PcmDecoder)):
        assert isinstance(work._make_audio_decoder(
            _ti(TrackInfo, codec, 48000, 2), spec), cls)


def _asc(aot, sfi=3, ch=2):
    return ((aot << 11) | (sfi << 7) | (ch << 3)).to_bytes(2, "big")


@pytest.mark.parametrize("aot", [1, 3, 4])
def test_aac_object_types_other_than_lc_raise(aot):
    """AAC Main, SSR and LTP: the decoder reads their ASC, and each frame
    that uses the object type's own tool would then fail, so the track
    would be silence; the port refuses the track when it starts."""
    spec = AudioJobTrack(track=0, encoder="aac")
    with pytest.raises(work.WorkError, match=f"object type {aot}"):
        work._make_audio_decoder(_ti(TrackInfo, "aac", 48000, 2, _asc(aot)),
                                 spec)
    for ok in (2, 5):           # LC, and HE-AAC's LC core
        assert isinstance(work._make_audio_decoder(
            _ti(TrackInfo, "aac", 48000, 2, _asc(ok)), spec),
            work._AacPacketDecoder)


def test_adts_main_profile_raises():
    dec = work._make_audio_decoder(_ti(TrackInfo, "aac", 48000, 2),
                                   AudioJobTrack(track=0, encoder="aac"))
    # an ADTS header of profile 0 (Main), 48 kHz stereo, 64 bytes
    hdr = bytes([0xFF, 0xF1, (0 << 6) | (3 << 2), (2 << 6), 64 >> 3,
                 ((64 & 7) << 5) | 0x1F, 0xFC])
    buf = Buffer(track_kind="audio")
    buf.data, buf.pts = hdr + bytes(57), 0
    with pytest.raises(work.WorkError, match="ADTS profile 0"):
        dec.feed(buf)


def test_aac_frame_with_an_unsupported_tool_raises():
    """A mono LC frame whose predictor_data_present bit (bit 25: after
    the SCE's id, tag, global gain and the long ics_info's fields) is
    set: the reference logs and drops each such frame, so a stream of
    them becomes silence; the port's job raises."""
    (asc, aus), _ = _aac_streams(48000, 1, 96)
    bad = bytearray(aus[1])
    bad[3] |= 0x40
    with pytest.raises(aacdec.AACUnsupported, match="prediction"):
        aacdec.AACDecoder(asc).decode_frame(bytes(bad))
    jdec = jwork._make_audio_decoder(
        _ti(JTrackInfo, "aac", 48000, 1, asc),
        JAudioJobTrack(track=0, encoder="aac"))
    jbuf = JBuffer(track_kind="audio")
    jbuf.data, jbuf.pts = bytes(bad), 0
    assert jdec.feed(jbuf) == []
    dec = work._make_audio_decoder(_ti(TrackInfo, "aac", 48000, 1, asc),
                                   AudioJobTrack(track=0, encoder="aac"))
    buf = Buffer(track_kind="audio")
    buf.data, buf.pts = bytes(bad), 0
    with pytest.raises(work.WorkError, match="prediction"):
        dec.feed(buf)


def test_audio_modules_import_with_jax_blocked():
    """The audio modules are among those that import with jax and
    handbrake_tpu blocked (the walk of tests/test_torch_imports.py)."""
    import subprocess
    import sys

    import test_torch_imports as ti
    code = ti._IMPORT_ALL % (ti.BLOCKED, ti.os.path.join(ti.ROOT,
                                                         "chip_smoke.py"))
    r = subprocess.run([sys.executable, "-c", code], cwd=ti.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    walked = set(r.stdout.split())
    for m in ("audio.aac", "audio.aac_tables", "audio.aacdec",
              "audio.ac3_tables", "audio.ac3dec", "audio.ac3enc",
              "audio.chain", "audio.dsp", "audio.flac", "audio.mp2_tables",
              "audio.mp2dec", "job.lang"):
        assert "handbrake_tpu_torch." + m in walked, m
