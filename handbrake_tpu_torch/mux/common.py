"""Mux core — track interleave in time chunks (reference: muxcommon.c).

One Muxer consumes encoded Buffers from per-track queues and forwards them
to an MP4Writer/MKVWriter in interleave-sized chunks of 90 kHz time
(OutputTrackChunk muxcommon.c:354, muxWork :368): tracks are drained
round-robin up to the chunk boundary so the file stays streamable without
libavformat's scheduler. Readiness bitvector semantics (rdy/eof/allRdy
muxcommon.c:42-57): a chunk is cut only when every track has either
reached the boundary or hit EOF.
"""
from __future__ import annotations

import dataclasses

from ..core.buffer import Buffer, CLOCK

INTERLEAVE_TICKS = CLOCK // 2   # 0.5 s chunks, like the reference's mp4 mux


class MuxError(Exception):
    """A writer was asked for what its container cannot hold (a sound
    codec without a sample entry or a CodecID)."""


@dataclasses.dataclass
class _MuxTrack:
    idx: int                    # writer track index
    queue: list
    eof: bool = False
    written_through: int = 0
    write: object = None        # optional per-track write callable(buf)


class Muxer:
    """Feed with mux_queue(track, buf) / mux_eof(track); drives a writer
    exposing write_sample(track_idx, data, duration, sync, cts_offset) —
    the MP4Writer/MKVWriter adapters below normalize the two APIs. A track
    may instead carry its own write(buf) callable (the work pipeline routes
    through its format adapter that way) — the interleave engine is the
    same either way."""

    def __init__(self, writer, kind: str):
        self.writer = writer
        self.kind = kind            # "mp4" | "mkv"
        self.tracks: list[_MuxTrack] = []
        self.chunk_end = INTERLEAVE_TICKS
        self.frames_muxed = 0

    def add_track(self, writer_track_idx: int = 0, write=None) -> int:
        self.tracks.append(_MuxTrack(writer_track_idx, [], write=write))
        return len(self.tracks) - 1

    def queue(self, track: int, buf: Buffer):
        if buf.is_eof():
            self.tracks[track].eof = True
        else:
            self.tracks[track].queue.append(buf)
        self._pump()

    def eof(self, track: int):
        self.tracks[track].eof = True
        self._pump()

    def _all_ready(self) -> bool:
        for t in self.tracks:
            if t.eof:
                continue
            if not t.queue or t.queue[-1].pts is None \
                    or t.queue[-1].pts < self.chunk_end:
                return False
        return True

    def _pump(self):
        while self._all_ready():
            for t in self.tracks:
                while t.queue and (t.queue[0].pts or 0) < self.chunk_end:
                    self._write(t, t.queue.pop(0))
            if all(t.eof and not t.queue for t in self.tracks):
                break
            self.chunk_end += INTERLEAVE_TICKS

    def _write(self, t: _MuxTrack, buf: Buffer):
        if t.write is not None:
            t.write(buf)
            self.frames_muxed += 1
            return
        dur = buf.duration or 0
        sync = bool(buf.frametype & 0x3)  # IDR|I
        cts = buf.renderOffset or 0
        if self.kind == "mp4":
            self.writer.write_sample(t.idx, buf.data or b"", dur,
                                     sync=sync, cts_offset=cts,
                                     annexb=True)
        else:
            self.writer.write_sample(t.idx, buf.data or b"", buf.pts or 0,
                                     dur, sync=sync, annexb=True)
        self.frames_muxed += 1

    def finish(self):
        for t in self.tracks:
            t.eof = True
        self._pump()
        # drain any tail past the last chunk boundary
        for t in self.tracks:
            while t.queue:
                self._write(t, t.queue.pop(0))
        if self.writer is not None:
            self.writer.finalize()
