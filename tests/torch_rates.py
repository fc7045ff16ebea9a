"""Test helpers that hold the port's files byte for byte against the JAX
package's where the port reads or shapes a rate as HandBrake does and
the reference does not:

- ``reference_reads_rate``: the JAX package's annex-B reader given the
  frame rate the stream states.  The port reads that rate from the
  stream's VUI (or HEVC VPS); the reference parses no VUI and labels
  every elementary stream 25 fps unless its ``AnnexBReader`` is built
  with ``fps=``, which the fixture does with the rate
  ``codecs/vui.stream_rate`` reads from the file;
- ``reference_reads_mp4_rate``: the same for an mp4 video track, which
  the port labels with the rate its ``stts`` states where every sample
  (the last aside) lasts one time; the reference labels none, and its
  jobs take 30000/1001;
- ``vfr_c_rule`` and ``reference_rule``: the peak-rate (PFR) shaper's
  rule, libhb vfr.c's ``adjust_frame_rate`` (the port's), and the
  reference's own, written out over a timeline of (start, duration);
  ``vfr_c_shaper`` makes the reference's shaper follow the first while
  a block runs, ``shaper_input`` records what the port's shaper takes,
  and ``video_times`` and ``times_of`` read a file's video times and
  write a rule's as a file holds them."""
import contextlib
import math
from fractions import Fraction

import pytest

from handbrake_tpu.filters import vfr as jvfr
from handbrake_tpu.sources import mp4 as jmp4
from handbrake_tpu.sources import raw as jraw
from handbrake_tpu_torch.codecs.vui import stream_rate
from handbrake_tpu_torch.filters import vfr
from handbrake_tpu_torch.sources.mkv import MKVDemuxer
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer


def stated_rate(path: str, codec: str = "h264"):
    """The rate the stream at ``path`` states, or None."""
    with open(path, "rb") as f:
        return stream_rate(codec, f.read(1 << 16))[0]


@pytest.fixture
def reference_reads_rate(monkeypatch):
    """While a test runs, the reference's AnnexBReader built without
    ``fps`` takes the stream's stated rate (25 where it states none)."""
    build = jraw.AnnexBReader.__init__

    def init(self, path, codec="h264", fps=None):
        build(self, path, codec,
              fps or stated_rate(path, codec) or Fraction(25, 1))
    monkeypatch.setattr(jraw.AnnexBReader, "__init__", init)


@pytest.fixture
def reference_reads_mp4_rate(monkeypatch):
    """While a test runs, the reference's mp4 demuxer labels each video
    track with the rate the port's demuxer reads from its ``stts``."""
    parse = jmp4.MP4Demuxer._parse_moov

    def parse_moov(self):
        parse(self)
        d = MP4Demuxer(self.path)
        try:
            for jt, t in zip(self.tracks, d.tracks):
                if jt.kind == "video" and t.frame_rate:
                    jt.frame_rate = t.frame_rate
        finally:
            d.close()
    monkeypatch.setattr(jmp4.MP4Demuxer, "_parse_moov", parse_moov)


def vfr_c_rule(frames, peak):
    """libhb vfr.c adjust_frame_rate in PFR mode: [(source index, pts,
    duration)] of the frames kept from `frames` [(start, duration)]."""
    F = Fraction(90000 * peak.denominator, peak.numerator)
    count, origin = 0, frames[0][0]
    last_stop = origin
    out = []
    for i, (start, duration) in enumerate(frames):
        stop = start + duration
        cfr_stop = origin + F * (count + 1)
        if cfr_stop - stop >= F:
            continue
        out_stop = stop if stop > cfr_stop else math.trunc(cfr_stop)
        out.append((i, last_stop, out_stop - last_stop))
        count += 1
        last_stop = out_stop
    return out


def reference_rule(frames, peak):
    """The JAX package's PFR: drop a frame that starts more than a third
    of a peak frame time before the last kept start plus a frame time;
    a kept frame keeps its own times."""
    F = Fraction(90000 * peak.denominator, peak.numerator)
    nxt, out = None, []
    for i, (start, duration) in enumerate(frames):
        if nxt is None:
            nxt = Fraction(start)
        if start < nxt - F / 3:
            continue
        out.append((i, start, duration))
        nxt = start + F
    return out


@contextlib.contextmanager
def vfr_c_shaper():
    """While the block runs, the reference's shaper in PFR mode follows
    ``vfr_c_rule`` frame by frame, and the rate that leaves it is the
    lower of its input's and the peak, as in the port: so a reference
    job's file can be held byte for byte against the port's where the
    rule re-times frames."""
    init = jvfr.VFRFilter.init

    def shaped_init(self, fi):
        fo = init(self, fi)
        self.vfr_c = {"count": 0, "origin": None, "last_stop": None}
        if self.mode == 2:
            fo.vrate = min(fi.vrate, self.rate)
        return fo

    def shaped(self, buf):
        st, F = self.vfr_c, self.frame_ticks
        stop = buf.pts + (buf.duration or int(F))
        if st["origin"] is None:
            st["origin"] = st["last_stop"] = buf.pts
        cfr_stop = st["origin"] + F * (st["count"] + 1)
        if cfr_stop - stop >= F:
            self.drops += 1
            return []
        buf.pts = st["last_stop"]
        buf.stop = stop if stop > cfr_stop else math.trunc(cfr_stop)
        buf.duration = buf.stop - buf.pts
        st["count"] += 1
        st["last_stop"] = buf.stop
        return [buf]
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jvfr.VFRFilter, "init", shaped_init)
        m.setattr(jvfr.VFRFilter, "_emit_pfr", shaped)
        yield


@contextlib.contextmanager
def shaper_input():
    """[(pts, duration)] of each frame the port's PFR shaper takes while
    the block runs."""
    seen = []
    emit = vfr.VFRFilter._emit_pfr

    def record(self, buf):
        seen.append((buf.pts, buf.duration))
        return emit(self, buf)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(vfr.VFRFilter, "_emit_pfr", record)
        yield seen


def video_times(path):
    """[(pts, duration)] of an mp4's video samples in display order, or
    [(pts, None)] of an mkv's video blocks (times in whole ms)."""
    mkv = path.endswith((".mkv", ".webm"))
    d = MKVDemuxer(path) if mkv else MP4Demuxer(path)
    try:
        return sorted((b.pts, None if mkv else b.duration)
                      for t, b in d.packets()
                      if d.tracks[t].kind == "video")
    finally:
        d.close()


def times_of(kept, mkv=False):
    """A rule's kept frames [(index, pts, duration)] as ``video_times``
    reads them from an mp4 or mkv (mkv floors a time to the ms)."""
    return [(p // 90 * 90, None) if mkv else (p, d) for _i, p, d in kept]
