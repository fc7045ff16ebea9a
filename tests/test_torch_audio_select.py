"""Which sound a job gets from a preset and its copy rules, in the port
(``job/presets.py`` ``select_audio``, ``work.resolve_audio_encoder``):

- a preset's audio list is applied as HandBrake's hb_preset_job_add_audio
  applies it: the tracks of ``AudioLanguageList`` by
  ``AudioTrackSelectionBehavior`` ("none", "first", "all"; "und" matches
  any language), every AudioList entry to each selected track, only the
  first to the tracks after the first with ``AudioSecondaryEncoderMode``;
  the built-in presets give the JAX package's audio list;
- each copy resolves as HandBrake's sanitize_audio_codec and
  hb_autopassthru_get_encoder resolve it: ``copy`` by the copy mask,
  ``copy:<codec>`` by the track's codec, then the encoder of that codec
  or the fallback, and the fallback where the container cannot carry the
  copy; each resolution is logged;
- a route that cannot run raises WorkError before a file exists: a
  catalog fallback with libavcodec hidden, the DTS decode an AAC fallback
  needs, and the CLI's refusal before its scan where no source decides.

Everything here runs on the CPU at 176x144 or smaller."""
import os

import pytest

from handbrake_tpu.job import presets as jpresets
from handbrake_tpu.job import title as jtitle
from handbrake_tpu_torch import work
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.job import presets as tpresets
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.job import title as ttitle
from handbrake_tpu_torch.sources.common import TrackInfo
from handbrake_tpu_torch.tools import source_builders as B
from handbrake_tpu_torch.utils import logging as hblog
from test_torch_sources import FRAME, T0

ENTRY_AAC = {"AudioEncoder": "aac", "AudioBitrate": 160,
             "AudioMixdown": "stereo"}
ENTRY_COPY = {"AudioEncoder": "copy", "AudioBitrate": 0,
              "AudioMixdown": "none"}
LANGS = ["fre", "eng", "en", "spa", "eng"]      # "en" is English too


def _preset(langs, behavior, secondary=None, entries=(ENTRY_AAC,
                                                     ENTRY_COPY)):
    p = {"AudioLanguageList": langs, "AudioTrackSelectionBehavior":
         behavior, "AudioList": [dict(e) for e in entries]}
    if secondary is not None:
        p["AudioSecondaryEncoderMode"] = secondary
    return p


# (AudioLanguageList, behaviour, secondary mode) → [(track, encoder)]
SELECTIONS = {
    "eng-first": (["eng"], "first", None, [(1, "aac"), (1, "copy")]),
    "eng-all": (["eng"], "all", False,
                [(1, "aac"), (1, "copy"), (2, "aac"), (2, "copy"),
                 (4, "aac"), (4, "copy")]),
    "eng-all-secondary": (["eng"], "all", True,
                          [(1, "aac"), (1, "copy"), (2, "aac"),
                           (4, "aac")]),
    "spa-eng-first": (["spa", "eng"], "first", None,
                      [(3, "aac"), (3, "copy"), (1, "aac"), (1, "copy")]),
    "spa-eng-first-secondary": (["spa", "eng"], "first", True,
                                [(3, "aac"), (3, "copy"), (1, "aac")]),
    "und-first": (["und"], "first", None, [(0, "aac"), (0, "copy")]),
    "und-all-secondary": (["und"], "all", True,
                          [(0, "aac"), (0, "copy"), (1, "aac"), (2, "aac"),
                           (3, "aac"), (4, "aac")]),
    "empty-list": ([], "first", None, [(0, "aac"), (0, "copy")]),
    "no-match": (["jpn"], "first", None, [(0, "aac"), (0, "copy")]),
    "none": (["eng"], "none", None, []),
    "eng-then-und": (["eng", "und"], "first", None,
                     [(1, "aac"), (1, "copy"), (0, "aac"), (0, "copy")]),
}


@pytest.mark.parametrize("name", list(SELECTIONS))
def test_preset_selection(name):
    langs, behavior, secondary, want = SELECTIONS[name]
    job = tpresets.preset_encoders(_preset(langs, behavior, secondary),
                                   LANGS)
    assert [(a.track, a.encoder) for a in job.audio] == want


def test_selection_of_a_title_without_sound():
    assert tpresets.preset_encoders(_preset(["eng"], "all"), []).audio \
        == []
    assert tpresets.preset_encoders(_preset(["und"], "first")).audio == []


def test_reference_maps_the_list_track_by_track():
    """The reference gives AudioList entry i to track i, whatever the
    languages: on LANGS it encodes French to AAC and copies track 2."""
    title = jtitle.Title(index=1, path="x", width=64, height=48)
    title.audio = [jtitle.AudioTrack(track=i, language=lang)
                   for i, lang in enumerate(LANGS)]
    job = jpresets.preset_to_job(title, _preset(["eng"], "first"))
    assert [(a.track, a.encoder) for a in job.audio] == [(0, "aac"),
                                                         (1, "copy")]


PRESETS = [p["PresetName"]
           for p in jpresets.flatten(jpresets.get_builtin())]


@pytest.mark.parametrize("name", PRESETS)
def test_builtin_preset_audio_equals_reference(name):
    """Every built-in preset (one AudioList entry, ["und"], "first") gives
    one output from track 0 on a title of French and English tracks, as
    the reference's does."""
    def job(T, P):
        title = T.Title(index=1, path="x", width=720, height=480)
        title.audio = [T.AudioTrack(track=i, codec=c, language=lang)
                       for i, (c, lang) in enumerate(
                           [("ac3", "fre"), ("dts", "eng"), ("lpcm", "eng")])]
        return P.preset_to_job(title, P.preset_search(name))
    got, want = job(ttitle, tpresets), job(jtitle, jpresets)
    assert got.to_json()["Audio"] == want.to_json()["Audio"]
    assert [a.track for a in got.audio] == [0]


# ---------------------------------------------------------------------------
# resolve_audio_encoder
# ---------------------------------------------------------------------------
def _ti(codec, ch=2):
    return TrackInfo(kind="audio", codec=codec, sample_rate=48000,
                     channels=ch)


MASK = ["copy:aac", "copy:ac3"]

# (encoder, track codec, mux, mask, fallback) → resolved encoder
RESOLUTIONS = {
    "copy-in-mask": ("copy", "ac3", "mp4", MASK, "aac", "copy:ac3"),
    "copy-out-of-mask": ("copy", "dts", "mkv", MASK, "ac3", "ac3"),
    "copy-bare-mask-names": ("copy", "eac3", "mkv", ["eac3"], "aac",
                             "copy:eac3"),
    "copy-no-mask": ("copy", "dts", "mkv", [], "aac", "copy:dts"),
    "copy-no-passthrough": ("copy", "lpcm", "mkv", [], "flac", "flac"),
    "copy-codec-match": ("copy:ac3", "ac3", "mp4", [], "aac", "copy:ac3"),
    "copy-codec-encoder": ("copy:ac3", "lpcm", "mkv", [], "aac", "ac3"),
    "copy-aac-on-ac3": ("copy:aac", "ac3", "mp4", [], "ac3", "aac"),
    "copy-codec-fallback": ("copy:dts", "lpcm", "mkv", [], "flac", "flac"),
    "copy-eac3-no-encoder": ("copy:eac3", "ac3", "mkv", [], "aac", "aac"),
    "mp4-cannot-carry-dts": ("copy:dts", "dts", "mp4", [], "ac3", "ac3"),
    "mp4-cannot-carry-truehd": ("copy", "truehd", "mp4", [], "aac", "aac"),
    "mp4-vorbis-encoder": ("copy:vorbis", "aac", "mp4", [], "ac3", "ac3"),
    "webm-copy-ac3": ("copy:ac3", "ac3", "webm", [], "vorbis", "vorbis"),
    "webm-default": ("copy", "ac3", "webm", [], "aac", "opus"),
    "webm-opus": ("copy", "opus", "webm", MASK, "aac", "opus"),
    "plain-encoder": ("flac", "dts", "mkv", MASK, "aac", "flac"),
}


@pytest.mark.parametrize("name", list(RESOLUTIONS))
def test_resolve_audio_encoder(name, capfd):
    enc, codec, mux, mask, fb, want = RESOLUTIONS[name]
    job = S.Job(mux=mux, audio_copy_mask=list(mask), audio_fallback=fb)
    spec = S.AudioJobTrack(track=2, encoder=enc)
    assert work.resolve_audio_encoder(spec, _ti(codec), job) == want
    if enc.startswith("copy"):
        assert f"audio: track 3 ({codec}), {enc}: {want} (" in \
            capfd.readouterr().err


@pytest.mark.parametrize("enc,mux", [("vorbis", "mp4"), ("aac", "webm")])
def test_encoder_the_container_cannot_hold_raises(enc, mux):
    job = S.Job(mux=mux)
    with pytest.raises(work.WorkError, match=f"{enc!r}: {mux} cannot hold"):
        work.resolve_audio_encoder(S.AudioJobTrack(track=0, encoder=enc),
                                   _ti("ac3"), job)


def test_fallback_that_is_no_encoder_raises():
    job = S.Job(mux="mkv", audio_copy_mask=["copy:aac"],
                audio_fallback="copy")
    with pytest.raises(work.WorkError, match="fallback 'copy'"):
        work.resolve_audio_encoder(S.AudioJobTrack(track=0, encoder="copy"),
                                   _ti("dts"), job)


def test_chain_follows_the_resolved_encoder():
    """The chain's copy passes the codec its resolved encoder names."""
    from handbrake_tpu_torch.audio.chain import AudioChain
    ch = AudioChain(S.AudioJobTrack(track=0, encoder="copy:ac3"), _ti("ac3"))
    assert ch.is_passthrough() and ch.out_codec() == "ac3"
    ch = AudioChain(S.AudioJobTrack(track=0, encoder="ac3"), _ti("lpcm"))
    assert not ch.is_passthrough() and ch.out_codec() == "ac3"


# ---------------------------------------------------------------------------
# routes that cannot run raise before a file exists
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dts_vob(tmp_path_factory):
    """The 176x144 MPEG-2 fixture with a 5.1 DTS track (substream 0x88)
    of header-only core frames."""
    es = B.fixture("mpeg2_176x144.m2v")
    units = B.video_units(es, T0, FRAME)
    units += [(T0 + k * 960, 0xBD, B.dts_core_frame(), B.dts_sub,
               T0 + k * 960) for k in range(12)]
    p = str(tmp_path_factory.mktemp("dts") / "dts.vob")
    with open(p, "wb") as f:
        f.write(B.build_ps(units))
    return p


def _job(src, out, mux, encoders, **kw):
    j = S.Job(path=src, file=out, mux=mux, vcodec="h264", quality=28.0,
              **kw)
    j.audio = [S.AudioJobTrack(track=0, encoder=e) for e in encoders]
    return j


@pytest.mark.parametrize("fallback", ["mp3", "opus"])
def test_catalog_fallback_refused_without_libavcodec(dts_vob, tmp_path,
                                                     monkeypatch, fallback):
    from torch_catalog import MISSING, hide
    hide(monkeypatch, tmp_path)
    out = str(tmp_path / "x.mkv")
    with pytest.raises(work.WorkError, match=MISSING):
        work.do_job(_job(dts_vob, out, "mkv", ["copy"],
                         audio_copy_mask=["copy:ac3"],
                         audio_fallback=fallback), device="cpu")
    assert not os.path.exists(out)


def test_dts_fallback_needs_a_decoder(dts_vob, tmp_path, monkeypatch,
                                      capfd):
    """``copy`` with the default preset's mask (AAC, AC-3) on a DTS track
    falls back to AAC, which needs a DTS decoder: without libavcodec the
    job raises, naming it, before its file exists."""
    from torch_catalog import MISSING, hide
    hide(monkeypatch, tmp_path)
    out = str(tmp_path / "x.mp4")
    with pytest.raises(work.WorkError, match=rf"dts: decoding.*{MISSING}"):
        work.do_job(_job(dts_vob, out, "mp4", ["copy"],
                         audio_copy_mask=MASK), device="cpu")
    assert not os.path.exists(out)
    assert "audio: track 1 (dts), copy: aac (dts is not in the copy mask" \
        in capfd.readouterr().err


def test_cli_refuses_a_catalog_fallback_before_its_scan(dts_vob, tmp_path,
                                                        monkeypatch,
                                                        capsys):
    """copy:dts into mp4 falls back whatever the track holds: with the
    preset's fallback an MP3 encoder and libavcodec hidden, the CLI
    refuses before it scans; copy:ac3 leaves it to the track, so the
    scan runs and the job refuses after it."""
    import json

    from handbrake_tpu_torch import hb
    from torch_catalog import hide
    hide(monkeypatch, tmp_path)
    preset = str(tmp_path / "p.json")
    with open(preset, "w") as f:
        json.dump(dict(tpresets.preset_search("Fast 1080p30"),
                       AudioEncoderFallback="mp3"), f)
    scans = []
    real = hb.Handle.scan
    monkeypatch.setattr(hb.Handle, "scan",
                        lambda self, *a, **k: (scans.append(a),
                                               real(self, *a, **k))[1])
    out = str(tmp_path / "x.mp4")
    args = ["-i", dts_vob, "-o", out, "--preset-import-file", preset,
            "-e", "h264", "-q", "28", "--device", "cpu", "-a", "1"]
    assert cli([*args, "-E", "copy:dts"]) == 3
    assert "libavcodec.so.59 not found" in capsys.readouterr().err
    assert scans == [] and not os.path.exists(out)
    assert cli([*args, "-E", "copy:ac3"]) == 3
    assert len(scans) == 1 and not os.path.exists(out)


def test_logged_resolution_reaches_a_registered_logger():
    lines = []
    hblog.register_logger(lines.append)
    try:
        work.resolve_audio_encoder(S.AudioJobTrack(track=0, encoder="copy"),
                                   _ti("aac"), S.Job(mux="mp4"))
    finally:
        hblog.register_logger(None)
    assert any("audio: track 1 (aac), copy: copy:aac (no copy mask given)"
               in ln for ln in lines)
