"""The libavcodec catalog's audio on the port's job path (``work.do_job`` on
the CPU), held byte for byte against the JAX package's output file on
the same source: MP3, Opus and Vorbis encoders (mkv, and MP3 in mp4),
and E-AC-3, DTS, MP3, Vorbis and Opus source tracks decoded to AAC.
The sources are 96x64, 8-frame H.264 mkv files from the port's encoder,
with 0.3 s of seeded tone coded by libavcodec's own encoders.  The
reference's jobs and scans run in a child process
(``torch_catalog.reference``)."""
import numpy as np
import pytest

import torch_catalog_ref as ref_side
from handbrake_tpu_torch import work
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.scan import scan_title
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from torch_catalog import file_bytes, lavc_audio, mkv_source, \
    needs_libavcodec, pcm_packets, reference

pytestmark = needs_libavcodec


@pytest.fixture(scope="module")
def pcm_src(tmp_path_factory):
    return mkv_source(str(tmp_path_factory.mktemp("pcm") / "src.mkv"),
                      acodec="pcm_s16le", apackets=pcm_packets())


def _both(reference, src, tmp_path, mux, encoder, bitrate=128):
    """The job through both packages: (port bytes, reference bytes)."""
    fields = dict(path=src, mux=mux, quality=30.0)
    audio = [dict(track=0, encoder=encoder, mixdown="stereo",
                  bitrate=bitrate)]
    out = str(tmp_path / f"port.{mux}")
    j = S.Job(file=out, **fields)
    j.audio = [S.AudioJobTrack(**a) for a in audio]
    assert work.do_job(j, device="cpu")["frames_out"] == 8
    stats, want = reference(ref_side.job, dict(
        fields, file=str(tmp_path / f"ref.{mux}")), audio)
    assert stats["frames_out"] == 8
    return file_bytes(out), want


@pytest.mark.parametrize("codec", ["mp3", "opus", "vorbis"])
def test_lossy_encoder_job_equals_reference(reference, pcm_src, tmp_path,
                                            codec):
    got, want = _both(reference, pcm_src, tmp_path, "mkv", codec)
    assert got == want
    d = MKVDemuxer(str(tmp_path / "port.mkv"))
    try:
        ti = [t for t in d.tracks if t.kind == "audio"][0]
        assert ti.codec == codec
        assert bool(ti.extradata) == (codec != "mp3")   # OpusHead / Xiph
        assert ti.sample_rate == 48000
    finally:
        d.close()


def test_mp3_in_mp4_equals_reference(reference, pcm_src, tmp_path):
    got, want = _both(reference, pcm_src, tmp_path, "mp4", "mp3")
    assert got == want


# source codec → (libavcodec encoder, bit rate)
SOURCES = {"eac3": ("eac3", 192000), "dts": ("dca", 768000),
           "mp3": ("libmp3lame", 128000), "vorbis": ("libvorbis", 128000),
           "opus": ("libopus", 96000)}


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("lavc")
    out = {}
    for codec, (enc, rate) in SOURCES.items():
        pkts, xd = lavc_audio(enc, bit_rate=rate)
        out[codec] = mkv_source(str(d / f"{codec}.mkv"), acodec=codec,
                                apackets=pkts, apriv=xd)
    return out


@pytest.mark.parametrize("codec", list(SOURCES))
def test_source_track_to_aac_equals_reference(reference, sources, tmp_path,
                                              codec):
    got, want = _both(reference, sources[codec], tmp_path, "mp4", "aac",
                      bitrate=160)
    assert got == want


@pytest.mark.parametrize("codec", list(SOURCES))
def test_scan_of_source_equals_reference(reference, sources, codec):
    t = scan_title(sources[codec], preview_count=2)
    j = reference(ref_side.scan, sources[codec], preview_count=2)
    assert [(a.codec, a.sample_rate, a.channels) for a in t.audio] == \
        [(a.codec, a.sample_rate, a.channels) for a in j.audio] == \
        [(codec, 48000, 2)]
    assert (t.width, t.height, t.crop, t.duration, t.nframes) == \
        (j.width, j.height, j.crop, j.duration, j.nframes)
    assert np.isfinite(t.duration)
