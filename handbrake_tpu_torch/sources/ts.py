"""MPEG transport stream demuxer (reference: libhb/stream.c TS path +
demuxmpeg.c hb_demux_ts).

Supports 188-byte TS and 192-byte M2TS (Blu-ray style, 4-byte timecode
prefix). Walks PAT → PMT → elementary PIDs, reassembles PES packets,
extracts 33-bit PTS/DTS into 90 kHz (SCR/wrap repair is the sync layer's
job, sync.py), and reports per-track codec info. Video geometry comes from
parsing the in-band SPS (the reference gets it from the decoder's info()
hook, decavcodec.c:2407).

A Blu-ray's streams are listed as libavformat's mpegts.c lists them: a
TrueHD PID (stream type 0x83) carries its AC-3 core on the same PID, told
apart by the PES stream_id_extension (0x72 TrueHD, 0x76 AC-3), and
becomes two tracks, TrueHD then its core; a PGS PID (0x90) carries bare
segments, joined here into whole display sets.  Tracks are video first,
then audio in PMT order, then subtitles; each PMT entry of a type with
no track is logged with its PID.
"""
from __future__ import annotations

import os

from ..core.buffer import Buffer
from ..utils.logging import log
from .common import (DemuxError, TrackInfo, read_audio_header,
                     read_mpeg2_header, read_stream_rate, read_vui_sar)

_STREAM_TYPES = {
    0x01: ("video", "mpeg2"), 0x02: ("video", "mpeg2"),
    0x1B: ("video", "h264"), 0x24: ("video", "hevc"),
    0x10: ("video", "mpeg4"),
    0x03: ("audio", "mp2"), 0x04: ("audio", "mp2"),
    0x0F: ("audio", "aac"), 0x11: ("audio", "aac_latm"),
    0x81: ("audio", "ac3"), 0x87: ("audio", "eac3"),
    0x82: ("audio", "dts"), 0x86: ("audio", "dts"),
    0x80: ("audio", "lpcm"),
    # Blu-ray: TrueHD (with its AC-3 core), E-AC-3 and secondary E-AC-3,
    # DTS-HD High Resolution and DTS Express, PGS
    0x83: ("audio", "truehd"), 0x84: ("audio", "eac3"),
    0xA1: ("audio", "eac3"), 0x85: ("audio", "dts"),
    0xA2: ("audio", "dts"), 0x90: ("subtitle", "pgs"),
}
# the substreams of a TrueHD PID, by stream_id_extension: 0x76 is the
# AC-3 core, any other (0x72, or none) the TrueHD stream, as in mpegts.c
_TRUEHD_SUBSTREAMS = ((0x72, "truehd"), (0x76, "ac3"))
_KIND_ORDER = {"video": 0, "audio": 1, "subtitle": 2}


class _DisplaySets:
    """A PGS track's PES payloads → whole display sets (its segments,
    type u8, size u16 and payload, up to the END segment), each with the
    PTS and DTS of the PES its first byte came in.  A segment cut across
    PES packets is joined."""

    def __init__(self):
        self.buf = bytearray()
        self.stamp = (None, None)

    def feed(self, data: bytes, pts, dts) -> list:
        if not self.buf:
            self.stamp = (pts, dts)
        self.buf += data
        out = []
        i = 0
        while i + 3 <= len(self.buf):
            end = i + 3 + int.from_bytes(self.buf[i + 1:i + 3], "big")
            if end > len(self.buf):
                break
            seg, i = self.buf[i], end
            if seg == 0x80:               # END: the display set is whole
                out.append((bytes(self.buf[:i]), *self.stamp))
                del self.buf[:i]
                i = 0
                self.stamp = (pts, dts)
        return out


def probe_is_ts(path: str) -> bool:
    with open(path, "rb") as f:
        head = f.read(192 * 5 + 4)
    for psz, off in ((188, 0), (192, 4)):
        if len(head) >= off + psz * 3 + 1 and all(
                head[off + i * psz] == 0x47 for i in range(3)):
            return True
    return False


class TSDemuxer:
    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "rb")
        self._detect_packet_size()
        self.tracks = []
        self._pid_to_track = {}
        self._pes_buf = {}         # pid → bytearray of current PES
        self._pes_meta = {}        # pid → (pts, dts)
        self.duration = 0
        self.chapters = []
        self._scan()

    # -- layout -------------------------------------------------------------
    def _detect_packet_size(self):
        head = self.f.read(192 * 8 + 4)
        self.psz, self.off = 188, 0
        for psz, off in ((188, 0), (192, 4)):
            if len(head) >= off + psz * 4 and all(
                    head[off + i * psz] == 0x47 for i in range(4)):
                self.psz, self.off = psz, off
                break
        else:
            raise DemuxError("no TS sync")
        self.f.seek(0)

    def _packets_raw(self, start_byte=0):
        self.f.seek(start_byte)
        if start_byte == 0:
            self.f.seek(0)
        while True:
            pos0 = self.f.tell()
            raw = self.f.read(self.psz)
            if len(raw) < self.psz:
                return
            pkt = raw[self.off:self.off + 188]
            if not pkt or pkt[0] != 0x47:
                # Resync: find the next 0x47 and seek so the *next* read puts
                # it at offset self.off.  Searching from self.off+1 guarantees
                # the seek target is > pos0 (forward progress even on M2TS
                # where the sync byte sits 4 bytes into the packet).
                data = self.f.read(188 * 2)
                idx = (raw + data).find(b"\x47", self.off + 1)
                if idx < 0:
                    return
                self.f.seek(pos0 + idx - self.off)
                continue
            yield pkt

    # -- PSI ------------------------------------------------------------------
    @staticmethod
    def _section(payload, pusi):
        if pusi:
            ptr = payload[0]
            return payload[1 + ptr:]
        return payload

    def _parse_pat(self, sec):
        # skip table header (8 bytes), walk program entries
        slen = ((sec[1] & 0x0F) << 8) | sec[2]
        body = sec[8:3 + slen - 4]
        pmts = []
        for i in range(0, len(body) - 3, 4):
            prog = (body[i] << 8) | body[i + 1]
            pid = ((body[i + 2] & 0x1F) << 8) | body[i + 3]
            if prog != 0:
                pmts.append(pid)
        return pmts

    def _parse_pmt(self, sec):
        slen = ((sec[1] & 0x0F) << 8) | sec[2]
        pinfo_len = ((sec[10] & 0x0F) << 8) | sec[11]
        i = 12 + pinfo_len
        end = 3 + slen - 4
        streams = []
        while i + 5 <= end:
            stype = sec[i]
            pid = ((sec[i + 1] & 0x1F) << 8) | sec[i + 2]
            eslen = ((sec[i + 3] & 0x0F) << 8) | sec[i + 4]
            desc = sec[i + 5:i + 5 + eslen]
            lang = "und"
            j = 0
            while j + 2 <= len(desc):
                tag, dl = desc[j], desc[j + 1]
                if tag == 0x0A and dl >= 3:       # ISO 639 language
                    lang = desc[j + 2:j + 5].decode("latin-1")
                if tag == 0x6A and stype == 0x06:
                    stype = 0x81                  # private + AC-3 descriptor
                if tag == 0x7A and stype == 0x06:
                    stype = 0x87                  # private + E-AC-3
                j += 2 + dl
            streams.append((pid, stype, lang))
            i += 5 + eslen
        return streams

    # -- PES ------------------------------------------------------------------
    @staticmethod
    def _pes_ts(b, off):
        return (((b[off] >> 1) & 0x7) << 30) | (b[off + 1] << 22) \
            | ((b[off + 2] >> 1) << 15) | (b[off + 3] << 7) \
            | (b[off + 4] >> 1)

    #: sentinel — the PES header continues in the next TS packet
    _PES_SHORT = "short"

    def _parse_pes_header(self, data):
        """Returns (pts, dts, payload_offset, stream_id_extension or
        None), None if not a PES start, or _PES_SHORT when the header
        (incl. PTS/DTS fields, and the PES extension where its flag is
        set) is split across TS packets by a large adaptation field and
        more bytes are needed."""
        if len(data) >= 3 and data[:3] != b"\x00\x00\x01":
            return None
        if len(data) < 9:
            return self._PES_SHORT
        flags = data[7]
        need = 9
        if flags & 0x80:
            need = 14
        if flags & 0x40:
            need = 19
        if flags & 0x01:
            need = max(need, 9 + data[8])
        if len(data) < need:
            return self._PES_SHORT
        pts = dts = None
        if flags & 0x80:
            pts = self._pes_ts(data, 9)
        if flags & 0x40:
            dts = self._pes_ts(data, 14)
        return pts, dts, 9 + data[8], self._pes_extension(data)

    @staticmethod
    def _pes_extension(data):
        """The 7-bit stream_id_extension of a whole PES header: after the
        fields its flags announce, the PES extension's flags, the fields
        they announce, then PES_extension_flag_2, the field length and
        the id (ISO/IEC 13818-1 2.4.3.7); None where there is none."""
        flags = data[7]
        if not flags & 0x01:
            return None
        i = 9 + (5 if flags & 0x80 else 0) + (5 if flags & 0x40 else 0) \
            + (6 if flags & 0x20 else 0) + (3 if flags & 0x10 else 0) \
            + (1 if flags & 0x08 else 0) + (1 if flags & 0x04 else 0) \
            + (2 if flags & 0x02 else 0)
        end = 9 + data[8]
        if i >= end:
            return None
        ext = data[i]
        i += 1 + (16 if ext & 0x80 else 0)
        if ext & 0x40 and i < end:
            i += 1 + data[i]
        i += (2 if ext & 0x20 else 0) + (2 if ext & 0x10 else 0)
        if not ext & 0x01 or i + 2 > end or not data[i] & 0x7F \
                or data[i + 1] & 0x80:
            return None
        return data[i + 1] & 0x7F

    # -- scan -----------------------------------------------------------------
    def _scan(self):
        from ..utils.logging import log
        pmts = set()
        es = {}
        skipped = set()
        first_pts = {}
        last_pts = {}
        n = 0
        for pkt in self._packets_raw():
            n += 1
            if n > 400000 and es:
                break
            pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
            pusi = bool(pkt[1] & 0x40)
            afc = (pkt[3] >> 4) & 3
            i = 4
            if afc & 2:
                i += 1 + pkt[4]
            if not (afc & 1) or i >= 188:
                continue
            payload = pkt[i:]
            if pid == 0 and pusi:
                pmts.update(self._parse_pat(self._section(payload, pusi)))
            elif pid in pmts and pusi:
                for spid, stype, lang in self._parse_pmt(
                        self._section(payload, pusi)):
                    if spid not in es and stype in _STREAM_TYPES:
                        es[spid] = (stype, lang)
                    elif stype not in _STREAM_TYPES \
                            and (spid, stype) not in skipped:
                        skipped.add((spid, stype))
                        log(f"ts: PMT entry of stream type {stype:#04x} on "
                            f"PID {spid:#06x} skipped: no track of that "
                            f"type is read")
            elif pid in es and pusi:
                hdr = self._parse_pes_header(payload)
                if isinstance(hdr, tuple) and hdr[0] is not None:
                    first_pts.setdefault(pid, hdr[0])
                    last_pts[pid] = hdr[0]
        if not es:
            raise DemuxError("no elementary streams in TS")
        # build TrackInfo: video first, then audio, then subtitles, each
        # in PMT order; a TrueHD PID's tracks are keyed (PID, extension)
        ordered = sorted(es.items(), key=lambda kv: _KIND_ORDER[
            _STREAM_TYPES[kv[1][0]][0]])
        self._ext_pids = set()
        self._pgs = set()
        for pid, (stype, lang) in ordered:
            kind, codec = _STREAM_TYPES[stype]
            subs = _TRUEHD_SUBSTREAMS if stype == 0x83 else ((None, codec),)
            for ext, codec in subs:
                if ext is not None:
                    self._ext_pids.add(pid)
                if codec == "pgs":
                    self._pgs.add(len(self.tracks))
                ti = TrackInfo(kind=kind, codec=codec, language=lang)
                self._pid_to_track[pid if ext is None else (pid, ext)] = \
                    len(self.tracks)
                self.tracks.append(ti)
        if first_pts:
            span = [last_pts[p] - first_pts[p] for p in first_pts
                    if last_pts[p] >= first_pts[p]]
            self.duration = max(span) if span else 0
        self._fill_video_info()
        self._fill_dts_info()

    def _fill_dts_info(self):
        """A DTS track's rate and channels from its first frame: a DTS-HD
        Master Audio track's are its lossless asset's (the reference
        leaves every DTS track at 48 kHz stereo)."""
        dts = {i: bytearray() for i, t in enumerate(self.tracks)
               if t.codec == "dts"}
        if not dts:
            return
        # a listed DTS PID that carries little stops the read at 16 MB
        seen = 0
        for trk, buf in self.packets():
            seen += len(buf.data or b"")
            if trk in dts and buf.data and len(dts[trk]) < 1 << 16:
                dts[trk] += buf.data
            if seen >= 1 << 24 or all(len(v) >= 1 << 16
                                      for v in dts.values()):
                break
        for i, es in dts.items():
            read_audio_header(self.tracks[i], es, f"ts: track {i}")

    def _fill_video_info(self):
        """Parse the first video SPS for geometry/rate (scan info hook)."""
        vids = [i for i, t in enumerate(self.tracks) if t.kind == "video"]
        if not vids:
            return
        ti = self.tracks[vids[0]]
        where = "ts: pid {:#x}".format(next(
            k for k, v in self._pid_to_track.items() if v == vids[0]))
        es = bytearray()
        for trk, buf in self.packets():
            if trk == vids[0] and buf.data:
                es += buf.data
                if len(es) > 1 << 18:
                    break
        if ti.codec == "mpeg2":
            # stream types 0x01/0x02: size, pixel aspect and rate from the
            # sequence header (the reference leaves the track 0x0, 1:1,
            # 30000/1001)
            read_mpeg2_header(ti, es, "ts")
        if ti.codec == "h264":
            try:
                from ..codecs.h264.bits import ebsp_to_rbsp, split_annexb
                from ..codecs.h264.syntax import SPS
                for nal in split_annexb(bytes(es)):
                    if (nal[0] & 0x1F) == 7:
                        sps = SPS.parse(ebsp_to_rbsp(nal[1:]))
                        ti.width = sps.width
                        ti.height = sps.height
                        break
            except (IndexError, ValueError) as e:
                log(f"{where}: the h264 SPS gives no picture size "
                    f"({e or 'cut short'}); the track keeps 0x0")
        elif ti.codec == "hevc":
            # the picture's size: the SPS's coded size less its
            # conformance window (the reference reads no HEVC SPS here and
            # leaves the track 0x0)
            try:
                from ..codecs.h264.bits import ebsp_to_rbsp, split_annexb
                from ..codecs.hevc.syntax import SPS as HSPS
                for nal in split_annexb(bytes(es)):
                    if ((nal[0] >> 1) & 0x3F) == 33:
                        sps = HSPS.parse(ebsp_to_rbsp(nal[2:]))
                        ti.width = sps.width - sps.crop_right
                        ti.height = sps.height - sps.crop_bottom
                        break
            except AssertionError:
                pass            # beyond the native subset: the decoder says so
        if ti.frame_rate is None:
            ti.frame_rate = (30000, 1001)
        if ti.codec in ("h264", "hevc"):
            # the rate the stream states (the reference labels every
            # H.264 and HEVC track 30000/1001)
            read_stream_rate(ti, es, where)
            read_vui_sar(ti, es, "ts")

    # -- packet iteration -------------------------------------------------------
    def packets(self, start_state=None):
        """Iterate (track_index, Buffer) — one Buffer per PES packet, with
        per-track durations inferred by one-packet lookahead
        (compute_frame_duration analog, decavcodec.c:2333)."""
        held = {}                  # track → held Buffer
        last_dur = {}
        for trk, b in self._packets_nodur(start_state):
            if trk in self._pgs:
                yield trk, b       # a display set lasts until the next
                continue
            prev = held.get(trk)
            if prev is not None:
                if prev.pts is not None and b.pts is not None \
                        and b.pts > prev.pts:
                    prev.duration = b.pts - prev.pts
                    prev.stop = prev.pts + prev.duration
                    last_dur[trk] = prev.duration
                yield trk, prev
            held[trk] = b
        for trk, b in held.items():
            if b.pts is not None and last_dur.get(trk):
                b.duration = last_dur[trk]
                b.stop = b.pts + b.duration
            yield trk, b

    def _packets_nodur(self, start_state=None):
        from ..utils.logging import log
        bufs = {key: bytearray() for key in self._pid_to_track}
        meta = {key: (None, None) for key in self._pid_to_track}
        pids = {k[0] if isinstance(k, tuple) else k for k in bufs}
        cur = {pid: pid for pid in pids if pid not in self._ext_pids}
        pending = {}               # pid → partial PES header bytes
        sets = {trk: _DisplaySets() for trk in self._pgs}

        def buffers(trk, got):
            out = []
            for data, pts, dts in got:
                b = Buffer(pts=pts, dts=dts)
                b.data = data
                b.track_kind = self.tracks[trk].kind
                b.stream_id = trk
                out.append((trk, b))
            return out

        def flush(key):
            if key not in bufs:
                return []
            data = bytes(bufs[key])
            bufs[key] = bytearray()
            if not data:
                return []
            return buffers(self._pid_to_track[key], [(data, *meta[key])])

        def start(pid, hdr, payload):
            """A PES header of ``pid`` read: the key its payload now
            feeds (a TrueHD PID's by its extension) takes its
            timestamps; returns the payload."""
            pts, dts, poff, ext = hdr
            key = (pid, 0x76 if ext == 0x76 else 0x72) \
                if pid in self._ext_pids else pid
            cur[pid] = key
            meta[key] = (pts, dts)
            return payload[poff:]

        for pkt in self._packets_raw(start_state or 0):
            pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
            if pid not in pids:
                continue
            pusi = bool(pkt[1] & 0x40)
            afc = (pkt[3] >> 4) & 3
            i = 4
            if afc & 2:
                i += 1 + pkt[4]
            if not (afc & 1) or i >= 188:
                continue
            payload = pkt[i:]
            if pusi:
                yield from flush(cur.get(pid))
                pending.pop(pid, None)
                hdr = self._parse_pes_header(payload)
                if hdr is self._PES_SHORT:
                    pending[pid] = bytearray(payload)
                    continue
                if hdr:
                    payload = start(pid, hdr, payload)
            elif pid in pending:
                # PES header split across TS packets: accumulate until the
                # timestamp fields are complete, then resume normal payload.
                pending[pid] += payload
                hdr = self._parse_pes_header(bytes(pending[pid]))
                if hdr is self._PES_SHORT:
                    continue
                buffered = bytes(pending.pop(pid))
                if hdr:
                    payload = start(pid, hdr, buffered)
                else:
                    payload = buffered
            key = cur.get(pid)
            if self._pid_to_track.get(key) in sets:
                # a PGS display set goes out once its END segment is in,
                # not at the next PES
                trk = self._pid_to_track[key]
                yield from buffers(trk, sets[trk].feed(payload, *meta[key]))
            elif key in bufs:
                bufs[key] += payload
        for key in list(bufs):
            yield from flush(key)
        for trk, ds in sets.items():
            if ds.buf:
                log(f"ts: track {trk}: {len(ds.buf)} bytes of PGS segments "
                    f"after its last display set dropped")

    def seek(self, pts):
        return 0

    def close(self):
        self.f.close()
