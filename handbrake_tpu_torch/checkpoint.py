"""GOP-boundary checkpoint journal (``<dest>.ckpt``) — the counterpart of
``_CkptJournal`` in ``handbrake_tpu/work.py``.

The journal holds every muxed sample of a job, and at each resume point
after the first an fsynced ``gop`` marker with the frames done and the
rate controller's state at that boundary.  A resume point is an IDR that
carries that state: every IDR, but in a GOP-parallel job only the first
of each window, so that a resumed run cuts the windows the uninterrupted
one cut.  A job killed at any point leaves a
prefix of complete GOPs: resume replays them into a new output file and
restarts the pipeline at the boundary.

Since version 3 a marker also holds what a resume needs to skip the
decode ahead of a keyframe: the frames the filter graph had taken when it
gave the boundary frame, whether the synchronizer had dropped or added a
video frame by then, the decode-order packet index, display index and
pts of the last random access point at or before the boundary frame, and
the timing of the decoder's frames ahead of that point not yet in an
earlier marker (``Timeline``).  A version 2 journal still resumes, with
a full decode, and the markers that resume adds stay version 2.

The format is the port's own, and is read without running anything: an
8-byte magic, then records of a 9-byte header (tag, body length, CRC-32
of the body) and a body of typed values (``_put``/``_get``: None, bool,
int, float, bytes, str, list, tuple, dict).  The reference pickles its
records and unpickles whatever the file holds; here a file without the
magic, or a committed record that does not parse, is refused with
``JournalError``.  Records after the last marker are a torn tail: resume
cuts the file there before it appends, so a second crash finds only
complete GOPs followed by the new run's records (the reference appends
after the stale tail and replays it).
"""
from __future__ import annotations

import os
import struct
import sys
import zlib
from array import array

# version 2 keys each audio record by the output's index in the job's
# audio list; version 1 keyed it by the source track, which two outputs
# of one track share, so such a journal is refused, not replayed;
# version 3 adds the resume point to each marker
MAGIC = b"HBTCKP3\n"
_MAGIC_V2 = b"HBTCKP2\n"
_MAGIC_V1 = b"HBTCKP1\n"
_HDR = struct.Struct(">BII")          # tag, body length, CRC-32 of body
TAGS = {b"v"[0]: "v", b"a"[0]: "a", b"s"[0]: "s", b"g"[0]: "g"}
_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")
_U32 = struct.Struct(">I")


class JournalError(Exception):
    """The file is not a checkpoint journal, or a committed record in it
    does not parse."""


def _put(out: bytearray, v) -> None:
    if v is None:
        out += b"N"
    elif v is True or v is False:
        out += b"T" if v else b"F"
    elif isinstance(v, int):
        out += b"i" + _I64.pack(v)
    elif isinstance(v, float):
        out += b"d" + _F64.pack(v)
    elif isinstance(v, bytes):
        out += b"b" + _U32.pack(len(v)) + v
    elif isinstance(v, str):
        b = v.encode("utf-8")
        out += b"s" + _U32.pack(len(b)) + b
    elif isinstance(v, (list, tuple)):
        out += (b"l" if isinstance(v, list) else b"t") + _U32.pack(len(v))
        for x in v:
            _put(out, x)
    elif isinstance(v, dict):
        out += b"m" + _U32.pack(len(v))
        for k, x in v.items():
            _put(out, k)
            _put(out, x)
    else:
        raise TypeError(f"checkpoint journal: cannot store {type(v).__name__}")


def _get(buf: bytes, i: int):
    """(value, next offset) of the typed value at buf[i]."""
    t = buf[i:i + 1]
    i += 1
    if t == b"N":
        return None, i
    if t in (b"T", b"F"):
        return t == b"T", i
    if t == b"i":
        return _I64.unpack_from(buf, i)[0], i + 8
    if t == b"d":
        return _F64.unpack_from(buf, i)[0], i + 8
    if t in (b"b", b"s", b"l", b"t", b"m"):
        (n,) = _U32.unpack_from(buf, i)
        i += 4
        if t in (b"b", b"s"):
            raw = buf[i:i + n]
            if len(raw) != n:
                raise JournalError("checkpoint journal: value past its record")
            return (bytes(raw) if t == b"b" else raw.decode("utf-8")), i + n
        if t == b"m":
            d = {}
            for _ in range(n):
                k, i = _get(buf, i)
                d[k], i = _get(buf, i)
            return d, i
        items = []
        for _ in range(n):
            x, i = _get(buf, i)
            items.append(x)
        return (items if t == b"l" else tuple(items)), i
    raise JournalError(f"checkpoint journal: unknown value type {t!r}")


def encode_record(tag: str, fields: tuple) -> bytes:
    body = bytearray()
    _put(body, tuple(fields))
    return _HDR.pack(ord(tag), len(body), zlib.crc32(body)) + bytes(body)


class Timeline:
    """The timing (pts, stop, duration) of each frame the video decoder
    gave, in the order it gave them.  A resume that skips the decode
    ahead of a keyframe hands the synchronizer these in place of the
    frames ahead of it, so its timeline is the uninterrupted run's.
    Appended on the decode thread, read on the mux thread."""
    _NONE = -(1 << 63)

    def __init__(self):
        self._a = array("q")

    def __len__(self) -> int:
        return len(self._a) // 3

    def append(self, pts, stop, duration) -> None:
        self._a.extend(tuple(self._NONE if v is None else int(v)
                             for v in (pts, stop, duration)))

    def __getitem__(self, i: int) -> tuple:
        return tuple(None if v == self._NONE else v
                     for v in self._a[3 * i:3 * i + 3])

    def pack(self, lo: int, hi: int) -> bytes:
        """Frames lo..hi-1, big-endian, compressed."""
        a = self._a[3 * lo:3 * hi]
        if sys.byteorder == "little":
            a.byteswap()
        return zlib.compress(a.tobytes())

    def extend_packed(self, data: bytes) -> None:
        a = array("q")
        a.frombytes(zlib.decompress(data))
        if sys.byteorder == "little":
            a.byteswap()
        self._a.extend(a)


def rc_snapshot(rc) -> dict:
    """The rate controller's state that a resume restores: its numbers,
    flags and lists (the reference's choice of attributes)."""
    return {k: v for k, v in rc.__dict__.items()
            if isinstance(v, (int, float, bool, list, tuple))}


class CkptJournal:
    """Writer: one record per muxed sample, a ``gop`` marker at each
    resume point after the first (an IDR with its rate-control state and,
    in version 3, its resume point).  A resumed job's journal continues
    after its last marker (frames0), in the journal's version, and its
    first IDR, which that marker already commits, adds none (the
    reference adds a second one, which a later resume counts as a GOP).
    ``timeline`` is the decoder's (``Timeline``), of which the journal
    holds the first ``timed`` frames."""

    def __init__(self, path: str, rc, append: bool = False, frames0: int = 0,
                 version: int = 3, timeline=None, timed: int = 0):
        self.path = path
        self.rc = rc
        self.frames = frames0
        self._marked = frames0       # frames the last marker commits
        self.version = version
        self.timeline = timeline
        self.timed = timed
        self.f = open(path, "ab" if append else "wb")
        if not append:
            self.f.write(MAGIC)

    def _write(self, tag: str, *fields):
        self.f.write(encode_record(tag, fields))

    def video(self, au, pts, dur, idr, side_data, rc_state=None,
              point=None):
        """`point`: the boundary's (frames the graph had taken, sync
        touched, random access point (packet, display index, pts) or
        None), as the encode stage saw it."""
        if idr and rc_state is not None and self.frames > self._marked:
            self.commit(rc_state, point)
        self._write("v", bytes(au), pts, dur, bool(idr),
                    {k: v for k, v in (side_data or {}).items()
                     if isinstance(v, (bytes, int, float, str))})
        self.frames += 1

    def audio(self, k, data, pts, dur, stop):
        """A sample of audio output k (its index in the job's list)."""
        self._write("a", k, bytes(data), pts, dur, stop)

    def subtitle(self, k, data, pts, dur, stop):
        self._write("s", k, bytes(data), pts, dur, stop)

    def _resume_fields(self, point) -> dict:
        fed, touched, rap = point if point is not None else (0, True, None)
        packet, display, rap_pts = rap if rap is not None else (None,) * 3
        timing = b""
        if display is not None and self.timeline is not None:
            timing = self.timeline.pack(self.timed, display)
            self.timed = max(self.timed, display)
        return {"graph_in": fed, "sync_touched": bool(touched),
                "packet": packet, "display": display, "rap_pts": rap_pts,
                "timing": timing}

    def commit(self, rc_state=None, point=None):
        rc_state = rc_state if rc_state is not None else rc_snapshot(self.rc)
        if self.version >= 3:
            self._write("g", self.frames, rc_state,
                        self._resume_fields(point))
        else:
            self._write("g", self.frames, rc_state)
        self._marked = self.frames
        self.f.flush()
        os.fsync(self.f.fileno())

    def close(self, complete=False):
        if complete:
            self.commit()
        self.f.close()
        if complete and os.path.exists(self.path):
            os.unlink(self.path)     # job finished: journal obsolete


def load(path: str):
    """→ (records of the complete GOPs, frames done, rc state, or None,
    and the file offset just past the last complete GOP).  The rc state
    carries ``_gops_done``, ``_version`` and ``_resume``: the last
    marker's resume point with ``timing`` the ``Timeline`` of all the
    markers, or None in a version 2 journal.  Raises JournalError for a
    file that is not a journal or a committed record that does not
    parse; a record cut short, or one whose CRC fails, ends the journal
    (a torn tail)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_MAGIC_V1):
        raise JournalError(f"{path}: a version 1 journal, whose audio "
                           "records are keyed by source track, not by "
                           "output (refused, not replayed)")
    if not data.startswith((MAGIC, _MAGIC_V2)):
        raise JournalError(f"{path}: not a checkpoint journal of this "
                           "package (refused, not read)")
    version = 3 if data.startswith(MAGIC) else 2
    timeline = Timeline()
    out, pending = [], []
    n_done, rc_state, gops_done = 0, None, 0
    i = cut = len(MAGIC)
    while i + _HDR.size <= len(data):
        tag, ln, crc = _HDR.unpack_from(data, i)
        body = data[i + _HDR.size:i + _HDR.size + ln]
        if len(body) != ln or zlib.crc32(body) != crc:
            break                    # torn tail
        if tag not in TAGS:
            raise JournalError(f"{path}: unknown record tag {tag}")
        try:
            fields, end = _get(body, 0)
        except (struct.error, UnicodeDecodeError, ValueError) as e:
            raise JournalError(f"{path}: malformed record: {e}") from None
        if end != ln or not isinstance(fields, tuple):
            raise JournalError(f"{path}: malformed {TAGS[tag]!r} record")
        i += _HDR.size + ln
        if TAGS[tag] == "g":
            if len(fields) != (3 if version == 3 else 2):
                raise JournalError(f"{path}: malformed 'g' record")
            out.extend(pending)
            pending = []
            n_done = fields[0]
            gops_done += 1
            rc_state = dict(fields[1])
            rc_state["_gops_done"] = gops_done
            rc_state["_version"] = version
            rc_state["_resume"] = None
            if version == 3:
                resume = dict(fields[2])
                try:
                    if resume["timing"]:
                        timeline.extend_packed(resume["timing"])
                except zlib.error as e:
                    raise JournalError(f"{path}: malformed timing: "
                                       f"{e}") from None
                resume["timing"] = timeline
                rc_state["_resume"] = resume
            cut = i
        else:
            pending.append((TAGS[tag],) + fields)
    return out, n_done, rc_state, cut


def spans(data: bytes) -> list:
    """[(tag, start, end)] of the complete records in a journal's bytes,
    in order (for tools that cut a journal as a crash would)."""
    out = []
    i = len(MAGIC)
    while i + _HDR.size <= len(data):
        tag, ln, _crc = _HDR.unpack_from(data, i)
        end = i + _HDR.size + ln
        if end > len(data):
            break
        out.append((TAGS.get(tag, "?"), i, end))
        i = end
    return out


def cut_to(path: str, offset: int) -> None:
    """Drop everything past `offset` (the last complete GOP), durably."""
    with open(path, "r+b") as f:
        f.truncate(offset)
        f.flush()
        os.fsync(f.fileno())
