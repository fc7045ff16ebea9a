"""A/V synchronizer — the semantics of sync.c ported as deterministic host
logic (reference: libhb/sync.c, 3,382 lines; see SURVEY.md §3.3).

Responsibilities, in reference order:
  * per-stream sorted queues absorbing out-of-order arrivals
    (SortedQueueBuffer sync.c:2003)
  * common start: wait until every stream has data, compute the max first
    PTS, trim/align every stream to it (checkFirstPts sync.c:696,
    computeInitialTS sync.c:625)
  * interleave output by lowest head PTS, needing ≥2 buffers per stream so
    durations are known (OutputBuffer sync.c:1434-1751)
  * per-stream timestamp repair: dejitter (duration vs next-pts drift),
    gap fill (silence/black or frame extension), overlap trim
    (fixAudioGap/Overlap sync.c:1049/1111, fixVideoOverlap sync.c:927)
  * p-to-p (pts_to_pts) start/stop ranges (sync.c:1518-1628)
  * SCR-discontinuity rebase (UpdateSCR sync.c:1887): a stream whose pts
    jumps backward by more than a threshold gets a per-stream offset so the
    output timeline stays monotonic.

No device code — this is pure control logic, tested with synthetic
timelines (tests/test_sync.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.buffer import Buffer, BufFlags, CLOCK

# jitter tolerance: reference uses 100ms-scale slack for audio gaps
GAP_THRESHOLD = CLOCK * 3 // 100       # 30 ms → fill
JITTER_THRESHOLD = CLOCK // 1000 * 10  # 10 ms → absorb silently
SCR_BACKJUMP = CLOCK * 2               # >2 s backward = discontinuity


@dataclasses.dataclass
class StreamState:
    kind: str                       # video | audio | subtitle
    id: int = 0
    queue: list = dataclasses.field(default_factory=list)
    eof: bool = False
    first_pts: Optional[int] = None
    next_pts: Optional[int] = None  # expected pts of next output
    scr_offset: int = 0
    last_pts_in: Optional[int] = None
    gap_ticks: int = 0
    overlap_ticks: int = 0
    drops: int = 0
    # PCM geometry for silence synthesis (None for passthrough/video —
    # no fill possible in the compressed domain)
    sample_rate: Optional[int] = None
    channels: int = 2
    # video geometry for black-frame gap synthesis (CreateBlackBuf
    # sync.c:349); None → leave a timeline hole
    width: Optional[int] = None
    height: Optional[int] = None
    frame_duration: Optional[int] = None
    black_fills: int = 0


class SyncCore:
    """Feed buffers per stream; pull a merged, repaired, monotonic timeline.

    Usage: add_stream() for each track, then queue(stream_idx, buf) /
    set_eof(stream_idx); poll() returns output buffers in timeline order.
    """

    def __init__(self, pts_start: Optional[int] = None,
                 pts_stop: Optional[int] = None):
        self.streams: list[StreamState] = []
        self.start_found = pts_start is None
        self.pts_start = pts_start
        self.pts_stop = pts_stop
        self.common_start: Optional[int] = None
        self.done = False
        self.cadence = CadenceTracker()

    def add_stream(self, kind: str, sid: int = 0,
                   sample_rate: Optional[int] = None,
                   channels: int = 2, width: Optional[int] = None,
                   height: Optional[int] = None,
                   frame_duration: Optional[int] = None) -> int:
        self.streams.append(StreamState(kind=kind, id=sid,
                                        sample_rate=sample_rate,
                                        channels=channels, width=width,
                                        height=height,
                                        frame_duration=frame_duration))
        return len(self.streams) - 1

    # -- input side ----------------------------------------------------------
    def queue(self, idx: int, buf: Buffer):
        st = self.streams[idx]
        if buf.is_eof():
            st.eof = True
            return
        if buf.pts is None:
            # inherit: previous stop, else 0 (reference treats NOPTS as glue)
            buf.pts = _glued(st, idx)
        # SCR discontinuity: large backward jump → rebase this stream
        if (st.last_pts_in is not None
                and buf.pts + st.scr_offset
                < st.last_pts_in - SCR_BACKJUMP):
            st.scr_offset = st.last_pts_in - buf.pts
        buf = _shifted(buf, st.scr_offset)
        st.last_pts_in = buf.pts
        # sorted insert (decoder reorder absorb)
        q = st.queue
        i = len(q)
        while i > 0 and q[i - 1].pts > buf.pts:
            i -= 1
        q.insert(i, buf)

    def set_eof(self, idx: int):
        self.streams[idx].eof = True

    # -- output side ---------------------------------------------------------
    def _ready(self) -> bool:
        for st in self.streams:
            if st.kind == "subtitle":
                continue      # sparse: never gates the pipeline
            if not st.eof and len(st.queue) < 2:
                return False
        return True

    def _establish_start(self):
        firsts = []
        for st in self.streams:
            if st.kind == "subtitle":
                continue  # subtitles never define the common start
            if st.queue:
                firsts.append(st.queue[0].pts)
            elif not st.eof:
                return False
        if not firsts:
            return False
        start = max(firsts)
        if self.pts_start is not None:
            start = max(start, self.pts_start)
        self.common_start = start
        # trim every stream to the common start (unknown-duration buffers
        # are kept when they start exactly at the cut)
        for st in self.streams:
            q = st.queue
            while q and (q[0].pts < start if q[0].stop is None
                         else q[0].stop <= start):
                if st.kind == "subtitle" and q[0].stop is None:
                    # stop-less bitmap events (PGS/SPU display sets)
                    # persist until the next set: clamp to the start
                    # instead of dropping — the screen state they
                    # establish is still current at the cut
                    break
                q.pop(0)
                st.drops += 1
            if st.kind == "subtitle":
                for b in q:
                    if b.pts < start:
                        b.pts = start
                        if b.stop is not None:
                            b.stop = max(b.stop, start)
            elif q and q[0].pts < start:
                b = q[0]
                if st.kind == "audio" and b.duration:
                    # trim head proportionally (reference trims samples)
                    b.duration = (b.stop or b.pts + b.duration) - start
                b.pts = start
                b.stop = b.pts + (b.duration or 0)
            st.next_pts = start
        return True

    def _repair(self, st: StreamState, buf: Buffer) -> list:
        """Dejitter + gap/overlap repair against the stream's running clock.
        Returns 0..2 buffers (a synthesized silence fill may precede buf)."""
        if st.kind == "subtitle":
            # subtitle cues keep author timing: overlaps/gaps are legal
            # at sync level (decsrtsub semantics; burn-in consumes cues
            # the moment they arrive).  Containers whose sample model
            # forbids overlap repair it at mux time (mp4 tx3g trims the
            # late cue's start — sync.c:1162 overlap role).
            return [buf]
        out = []
        if st.next_pts is None:
            st.next_pts = buf.pts
        delta = buf.pts - st.next_pts
        if abs(delta) <= JITTER_THRESHOLD:
            # absorb jitter: snap to the running clock
            buf.pts = st.next_pts
            buf.stop = buf.pts + (buf.duration or 0)
        elif delta < 0:
            # overlap: trim (audio) / drop if fully covered
            st.overlap_ticks += -delta
            if (buf.stop or buf.pts) <= st.next_pts:
                st.drops += 1
                return out
            buf.duration = (buf.stop or buf.pts + (buf.duration or 0)) \
                - st.next_pts
            buf.pts = st.next_pts
            buf.stop = buf.pts + buf.duration
        elif delta > GAP_THRESHOLD:
            st.gap_ticks += delta
            if st.kind == "audio" and st.sample_rate:
                # synthesize silence covering the hole (CreateSilenceBuf
                # sync.c:290); video/passthrough leave a legal timeline hole
                out.append(fill_audio_gap(st.next_pts, delta,
                                          st.sample_rate, st.channels,
                                          sid=st.id))
            elif (st.kind == "video" and st.width and st.height
                  and st.frame_duration):
                # black-frame synthesis (CreateBlackBuf sync.c:349):
                # whole frames of frame_duration until the gap closes
                t = st.next_pts
                while t + st.frame_duration <= buf.pts:
                    out.append(black_frame(t, st.frame_duration,
                                           st.width, st.height,
                                           sid=st.id))
                    st.black_fills += 1
                    t += st.frame_duration
        if st.kind == "video" and buf.duration:
            self.cadence.push(buf.duration)
        st.next_pts = buf.stop if buf.stop is not None \
            else buf.pts + (buf.duration or 0)
        out.append(buf)
        return out

    # -- p-to-p search progress (UpdateSearchState sync.c:1518) -----------
    def search_state(self) -> Optional[dict]:
        """While seeking to pts_start: {"state": "SEARCHING", "progress"}.
        None once the common start is established (or no start requested).
        """
        if self.pts_start is None or self.common_start is not None:
            return None
        seen = 0
        for st in self.streams:
            if st.last_pts_in is not None:
                seen = max(seen, st.last_pts_in)
        return {"state": "SEARCHING",
                "progress": min(1.0, seen / self.pts_start)
                if self.pts_start else 1.0}

    def poll(self) -> list:
        """Emit everything currently safe to emit, merged by lowest PTS."""
        out = []
        if self.common_start is None:
            if not self._ready():
                return out
            if not self._establish_start():
                return out
        while True:
            # pick stream with lowest head pts that is safe (≥2 or EOF)
            best = None
            for st in self.streams:
                if not st.queue:
                    continue
                if len(st.queue) < 2 and not st.eof \
                        and st.kind != "subtitle":
                    best = None
                    break
                if best is None or st.queue[0].pts < best.queue[0].pts:
                    best = st
            if best is None:
                break
            buf = best.queue.pop(0)
            if (self.pts_stop is not None and buf.pts >= self.pts_stop):
                best.eof = True
                best.queue.clear()
                if all(s.eof and not s.queue for s in self.streams):
                    self.done = True
                continue
            if (self.pts_stop is not None and buf.stop is not None
                    and buf.stop > self.pts_stop
                    and best.kind == "audio"):
                # trim the straddling audio buffer at the range stop so
                # the tail doesn't drag the video timeline past it
                # (sync.c stop-condition truncation)
                new_dur = self.pts_stop - buf.pts
                if buf.planes is not None and best.sample_rate:
                    n = max(0, int(round(new_dur * best.sample_rate
                                         / CLOCK)))
                    buf.planes = [np.asarray(buf.planes[0])[:n]]
                buf.duration = new_dur
                buf.stop = self.pts_stop
            out.extend(self._repair(best, buf))
        if all(s.eof and not s.queue for s in self.streams):
            self.done = True
        return out


def _glued(st: StreamState, idx: int) -> int:
    """The time of a buffer without a pts queued on stream `st`: its
    predecessor's stop, or its predecessor's pts plus its duration, or 0
    where the queue is empty.  A predecessor with neither raises
    WorkError naming the stream."""
    if not st.queue:
        return 0
    prev = st.queue[-1]
    if prev.stop is not None:
        return prev.stop
    if prev.duration:
        return prev.pts + prev.duration
    from ..work import WorkError
    raise WorkError(f"sync: a {st.kind} buffer of stream {idx} (id {st.id}) "
                    f"has no pts, and the one before it neither a stop nor "
                    f"a duration to take its time from")


def _shifted(buf: Buffer, off: int) -> Buffer:
    if off:
        buf.pts = buf.pts + off
        if buf.stop is not None:
            buf.stop += off
        if buf.dts is not None:
            buf.dts += off
    return buf


def fill_audio_gap(st_next_pts: int, gap_ticks: int, sample_rate: int,
                   channels: int, sid: int = 0):
    """Silence buffer covering a gap (CreateSilenceBuf analog sync.c:290)."""
    import numpy as np
    nsamples = gap_ticks * sample_rate // CLOCK
    pcm = np.zeros((nsamples, channels), np.float32)
    b = Buffer(track_kind="audio", pts=st_next_pts, duration=gap_ticks)
    b.stop = b.pts + gap_ticks
    b.planes = [pcm]
    b.stream_id = sid
    return b


def black_frame(pts: int, duration: int, width: int, height: int,
                sid: int = 0) -> Buffer:
    """Black YUV frame covering a video gap (CreateBlackBuf sync.c:349)."""
    import numpy as np
    y = np.full((height, width), 16, np.uint8)
    u = np.full((height // 2, width // 2), 128, np.uint8)
    v = np.full((height // 2, width // 2), 128, np.uint8)
    b = Buffer(track_kind="video", pts=pts, duration=duration)
    b.stop = pts + duration
    b.planes = [y, u, v]
    b.stream_id = sid
    return b


class CadenceTracker:
    """Frame-duration cadence classifier (checkCadence sync.c:1305).

    Watches video frame durations for the 3:2 telecine pattern (period-2
    alternation with a 3:2 tick ratio), constant-rate cadence, or broken
    cadence; counts breaks so VFR/detelecine decisions and diagnostics can
    react.
    """

    WINDOW = 12

    def __init__(self):
        self.durations: list = []
        self.breaks = 0
        self._last_kind = "unknown"

    def push(self, duration: int):
        d = self.durations
        d.append(int(duration))
        if len(d) > self.WINDOW:
            d.pop(0)
        kind = self.classify()
        if (kind != self._last_kind
                and "unknown" not in (kind, self._last_kind)):
            self.breaks += 1
        self._last_kind = kind

    def classify(self) -> str:
        d = self.durations
        if len(d) < 4:
            return "unknown"
        tol = max(2, d[-1] // 50)

        def near(a, b):
            return abs(a - b) <= tol
        if all(near(x, d[-1]) for x in d[-4:]):
            return "constant"
        # 3:2 alternation: even/odd positions each constant, ratio 3:2
        a, b = d[-4], d[-3]
        if (near(d[-2], a) and near(d[-1], b) and a != b
                and near(2 * max(a, b), 3 * min(a, b))):
            return "telecine_32"
        return "broken"

    def info(self) -> dict:
        return {"cadence": self.classify(), "breaks": self.breaks}
