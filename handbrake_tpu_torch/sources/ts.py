"""MPEG transport stream demuxer (reference: libhb/stream.c TS path +
demuxmpeg.c hb_demux_ts).

Supports 188-byte TS and 192-byte M2TS (Blu-ray style, 4-byte timecode
prefix). Walks PAT → PMT → elementary PIDs, reassembles PES packets,
extracts 33-bit PTS/DTS into 90 kHz (SCR/wrap repair is the sync layer's
job, sync.py), and reports per-track codec info. Video geometry comes from
parsing the in-band SPS (the reference gets it from the decoder's info()
hook, decavcodec.c:2407).
"""
from __future__ import annotations

import os

from ..core.buffer import Buffer
from .common import DemuxError, TrackInfo, read_mpeg2_header, read_vui_sar

_STREAM_TYPES = {
    0x01: ("video", "mpeg2"), 0x02: ("video", "mpeg2"),
    0x1B: ("video", "h264"), 0x24: ("video", "hevc"),
    0x10: ("video", "mpeg4"),
    0x03: ("audio", "mp2"), 0x04: ("audio", "mp2"),
    0x0F: ("audio", "aac"), 0x11: ("audio", "aac_latm"),
    0x81: ("audio", "ac3"), 0x87: ("audio", "eac3"),
    0x82: ("audio", "dts"), 0x86: ("audio", "dts"),
    0x80: ("audio", "lpcm"),
}


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
        """Returns (pts, dts, payload_offset), None if not a PES start, or
        _PES_SHORT when the header (incl. PTS/DTS fields) is split across TS
        packets by a large adaptation field and more bytes are needed."""
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
        if len(data) < need:
            return self._PES_SHORT
        pts = dts = None
        if flags & 0x80:
            pts = self._pes_ts(data, 9)
        if flags & 0x40:
            dts = self._pes_ts(data, 14)
        return pts, dts, 9 + data[8]

    # -- scan -----------------------------------------------------------------
    def _scan(self):
        pmts = set()
        es = {}
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
            elif pid in es and pusi:
                hdr = self._parse_pes_header(payload)
                if isinstance(hdr, tuple) and hdr[0] is not None:
                    first_pts.setdefault(pid, hdr[0])
                    last_pts[pid] = hdr[0]
        if not es:
            raise DemuxError("no elementary streams in TS")
        # build TrackInfo, video first
        ordered = sorted(es.items(),
                         key=lambda kv: 0 if _STREAM_TYPES[kv[1][0]][0]
                         == "video" else 1)
        for pid, (stype, lang) in ordered:
            kind, codec = _STREAM_TYPES[stype]
            ti = TrackInfo(kind=kind, codec=codec, language=lang)
            self._pid_to_track[pid] = len(self.tracks)
            self.tracks.append(ti)
        if first_pts:
            span = [last_pts[p] - first_pts[p] for p in first_pts
                    if last_pts[p] >= first_pts[p]]
            self.duration = max(span) if span else 0
        self._fill_video_info()

    def _fill_video_info(self):
        """Parse the first video SPS for geometry/rate (scan info hook)."""
        vids = [i for i, t in enumerate(self.tracks) if t.kind == "video"]
        if not vids:
            return
        ti = self.tracks[vids[0]]
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
                        if sps.vui_timing:
                            num_units, time_scale = sps.vui_timing
                            ti.frame_rate = (time_scale, num_units * 2)
                        break
            except Exception:
                pass
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
            read_vui_sar(ti, es, "ts")

    # -- packet iteration -------------------------------------------------------
    def packets(self, start_state=None):
        """Iterate (track_index, Buffer) — one Buffer per PES packet, with
        per-track durations inferred by one-packet lookahead
        (compute_frame_duration analog, decavcodec.c:2333)."""
        held = {}                  # track → held Buffer
        last_dur = {}
        for trk, b in self._packets_nodur(start_state):
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
        bufs = {pid: bytearray() for pid in self._pid_to_track}
        meta = {pid: (None, None) for pid in self._pid_to_track}
        pending = {}               # pid → partial PES header bytes

        def flush(pid):
            data = bytes(bufs[pid])
            bufs[pid] = bytearray()
            if not data:
                return None
            pts, dts = meta[pid]
            b = Buffer(pts=pts, dts=dts)
            b.data = data
            trk = self._pid_to_track[pid]
            b.track_kind = self.tracks[trk].kind
            b.stream_id = trk
            return trk, b

        for pkt in self._packets_raw(start_state or 0):
            pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
            if pid not in self._pid_to_track:
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
                out = flush(pid)
                if out:
                    yield out
                pending.pop(pid, None)
                hdr = self._parse_pes_header(payload)
                if hdr is self._PES_SHORT:
                    pending[pid] = bytearray(payload)
                    continue
                if hdr:
                    pts, dts, poff = hdr
                    meta[pid] = (pts, dts)
                    payload = payload[poff:]
            elif pid in pending:
                # PES header split across TS packets: accumulate until the
                # timestamp fields are complete, then resume normal payload.
                pending[pid] += payload
                hdr = self._parse_pes_header(bytes(pending[pid]))
                if hdr is self._PES_SHORT:
                    continue
                buffered = bytes(pending.pop(pid))
                if hdr:
                    pts, dts, poff = hdr
                    meta[pid] = (pts, dts)
                    payload = buffered[poff:]
                else:
                    payload = buffered
            bufs[pid] += payload
        for pid in list(bufs):
            out = flush(pid)
            if out:
                yield out

    def seek(self, pts):
        return 0

    def close(self):
        self.f.close()
