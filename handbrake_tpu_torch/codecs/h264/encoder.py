"""H.264 encoder, device path — the counterpart of ``H264Encoder`` with
``backend="device"`` in ``handbrake_tpu/codecs/h264/encoder.py``.

IDR frames are coded by the native C++ I slice and filtered by the
native deblock; the recon is then uploaded once, so the next P frame's
reference lies on the device.  P frames run the analyzer
(``analyzer.py``, with the deblock kernel chained when the in-loop
filter is on) on the device; the native CABAC/CAVLC P slice then codes
them on the host from a compact device→host fetch.  MBs whose inter SAD
is poor fall back to intra in the native stage, which patches a host
copy of the recon; in-flight analyses that used the stale reference are
re-run against the patched one (``_propagate_refs``).

Pipelined use overlaps the device analysis of frame N+1 with the host
entropy coding of frame N::

    p0 = enc.begin_frame(y0, u0, v0)
    p1 = enc.begin_frame(y1, u1, v1)   # device starts frame 1
    out0 = enc.finish_frame(p0)         # host codes frame 0

Not ported: the pure-Python CAVLC walker (host analysis input,
``intra4x4``), B-frames and the GOP-parallel entry.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses

import numpy as np
import torch

from . import transform as T
from ...native import get_lib
from ...utils.device import resolve_device
from .analyzer import (build_p_analyzer, build_p_analyzer_batch,
                       intra_thresh_for_qp)
from .syntax import NAL_IDR, NAL_SLICE, PPS, SLICE_I, SLICE_P, SPS, \
    SliceHeader


@dataclasses.dataclass
class EncoderConfig:
    width: int
    height: int
    qp: int = 26
    gop: int = 60                 # IDR interval in frames
    fps: tuple = (30000, 1001)
    chroma_qp_offset: int = 0
    level_idc: int = 40
    # the port has the device path only; "host" raises
    backend: str = "device"
    deblock: bool = False         # in-loop deblocking (spec 8.7)
    cabac: bool = False           # CABAC entropy coding (Main/High)
    intra4x4: bool = False        # host walker only: raises
    transform8x8: bool = False    # 8x8 transform for inter MBs (High)
    # analyze N consecutive P frames per dispatch, chaining the recon on
    # the device; the batch shares one qp
    dispatch_batch: int = 1


def _to_np(x) -> np.ndarray:
    return x if isinstance(x, np.ndarray) else x.cpu().numpy()


class _D2H:
    """A device→host copy started ahead of use: a non_blocking copy into
    pinned host memory, recorded with a CUDA event (the role of
    copy_to_host_async)."""
    __slots__ = ("host", "event")

    def __init__(self, t):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t, None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _fetch(items, pre=None) -> list:
    """Host copies of `items` (tensors or numpy arrays), using the
    copies started for them where there are any (pre: id → _D2H)."""
    out = []
    for x in items:
        d = pre.get(id(x)) if pre else None
        out.append(d.numpy() if d is not None else _to_np(x))
    return out


class _Pending:
    """In-flight frame: device analysis dispatched, entropy not yet done."""
    __slots__ = ("kind", "done_bytes", "dev", "qp", "qpc", "src",
                 "packed_src", "refs", "redo_refs", "frame_num",
                 "batch", "batch_next")

    def __init__(self):
        self.kind = "done"
        self.done_bytes = b""
        self.dev = None
        self.redo_refs = None
        self.batch = None            # (rec, k) once dispatched batched
        self.batch_next = None       # next pending of the same batch


class _BatchRec:
    """One dispatched N-frame batch: stacked analyzer outputs and the
    host copy of what the entropy stage reads, started at dispatch."""
    __slots__ = ("outs", "n_real", "small_np", "payload_np", "nch",
                 "next_first", "_pre")

    def __init__(self, outs, n_real, guess):
        self.outs = outs
        self.n_real = n_real
        self.small_np = None
        self.payload_np = None
        self.next_first = None       # first pending of the next batch
                                     # that consumed this batch's carry
        src = outs["payload_nib"]
        self.nch = max(1, min(guess, src.shape[1]))
        self._pre = (_D2H(outs["packed_small"]), _D2H(src[:, :self.nch]))

    def fetch(self):
        if self.small_np is None:
            self.small_np, self.payload_np = (d.numpy() for d in self._pre)


class H264Encoder:
    """Stateful one-ref H.264 encoder on the device. encode_frame() →
    annex-B bytes.  device=None runs on the CUDA card."""

    def __init__(self, cfg: EncoderConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.backend != "device":
            raise NotImplementedError(
                "h264: the port has the device path only (backend='device')")
        if cfg.intra4x4:
            raise NotImplementedError(
                "h264: intra4x4 runs in the host CAVLC walker, not ported")
        self._natlib = get_lib()
        w, h = cfg.width, cfg.height
        self.mb_w = (w + 15) // 16
        self.mb_h = (h + 15) // 16
        self.sps = SPS(profile_idc=100 if cfg.transform8x8
                       else (77 if cfg.cabac else 66),
                       width_mbs=self.mb_w, height_mbs=self.mb_h,
                       crop_right=self.mb_w * 16 - w,
                       crop_bottom=self.mb_h * 16 - h,
                       level_idc=cfg.level_idc,
                       vui_timing=(cfg.fps[1], 2 * cfg.fps[0]))
        self.pps = PPS(pic_init_qp=cfg.qp,
                       chroma_qp_index_offset=cfg.chroma_qp_offset,
                       cabac=cfg.cabac,
                       transform_8x8=cfg.transform8x8)
        self.frame_num = 0
        self.idr_pic_id = 0
        self.frame_idx = 0
        self.recon_y = None
        self.recon_u = None
        self.recon_v = None
        self.last_frame_was_idr = False
        self._queue = collections.deque()   # in-flight begin_frame order
        self._nch_guess = 8                 # payload chunks likely needed
        self._batch_accum = []
        self._batch_n = 1
        self._batch_analyzer = None
        self._last_batch_rec = None
        self._last_carry = None
        self._dummy_rec = None
        self.n_redo = 0     # analyses re-run after an intra-fallback patch
        self._analyzer = build_p_analyzer(
            self.mb_w, self.mb_h, deblock=cfg.deblock,
            transform8x8=cfg.transform8x8)
        if cfg.dispatch_batch > 1:
            self._batch_n = int(cfg.dispatch_batch)
            self._batch_analyzer = build_p_analyzer_batch(
                self.mb_w, self.mb_h, self._batch_n,
                deblock=cfg.deblock, transform8x8=cfg.transform8x8)

    @classmethod
    def from_reference_state(cls, cfg: EncoderConfig, state: dict,
                             device=None) -> "H264Encoder":
        """Continue a stream another encoder began.  state holds what
        ``handbrake_tpu``'s encoder keeps between frames, as numpy and
        ints: recon_y/u/v, frame_num, frame_idx, idr_pic_id.  No frame
        may be in flight in that encoder."""
        enc = cls(cfg, device)
        enc.frame_num = int(state["frame_num"])
        enc.frame_idx = int(state["frame_idx"])
        enc.idr_pic_id = int(state["idr_pic_id"])
        enc.recon_y, enc.recon_u, enc.recon_v = enc._upload_planes(
            state["recon_y"], state["recon_u"], state["recon_v"])
        return enc

    # -- frame-level -------------------------------------------------------
    def headers(self) -> bytes:
        return self.sps.to_nal() + self.pps.to_nal()

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _upload_planes(self, *planes):
        return tuple(self._upload(np.asarray(p, np.uint8)) for p in planes)

    def _pad_to_mb(self, plane, mbsize):
        Ht, Wt = self.mb_h * mbsize, self.mb_w * mbsize
        h, w = plane.shape
        if (h, w) == (Ht, Wt):
            return np.ascontiguousarray(plane, np.uint8)
        return np.pad(plane.astype(np.uint8),
                      ((0, Ht - h), (0, Wt - w)), mode="edge")

    def encode_frame(self, y, u, v, analysis=None, qp=None) -> bytes:
        """Encode one frame (y: HxW, u/v: H/2 x W/2, uint8). Returns NALs.
        qp overrides cfg.qp for this frame."""
        return self.finish_frame(self.begin_frame(y, u, v, analysis, qp))

    def begin_frame(self, y, u, v, analysis=None, qp=None):
        """Dispatch frame analysis. IDR frames are encoded at once (native
        I slice); P frames return with the device analysis in flight.
        Call finish_frame() in FIFO order."""
        if analysis is not None:
            raise NotImplementedError(
                "h264: host analysis input runs in the CAVLC walker, "
                "not ported")
        idr = (self.frame_idx % self.cfg.gop) == 0
        if idr and self._batch_accum:
            # the accumulated P frames anchor on the pre-IDR recon chain
            self._dispatch_batch()
        self.last_frame_was_idr = idr
        qp = self.cfg.qp if qp is None else int(qp)
        out = b""
        if idr:
            out += self.headers()
            self.frame_num = 0
        yp = self._pad_to_mb(y, 16)
        up = self._pad_to_mb(u, 8)
        vp = self._pad_to_mb(v, 8)
        p = _Pending()
        p.qp = qp
        p.frame_num = self.frame_num
        if not idr:
            p.kind = "p"
            p.qpc = T.chroma_qp(qp, self.cfg.chroma_qp_offset)
            p.src = (yp, up, vp)
            # one host→device transfer per frame (planes packed)
            p.packed_src = np.concatenate([yp.ravel(), up.ravel(),
                                           vp.ravel()])
            p.done_bytes = out
            if self._batch_analyzer is not None:
                p.refs = None
                self._batch_accum.append(p)
                if len(self._batch_accum) >= self._batch_n:
                    self._dispatch_batch()
            else:
                p.refs = (self.recon_y, self.recon_u, self.recon_v)
                p.dev = self._analyze(p)
                # next frame's reference = this frame's device recon
                self.recon_y = p.dev["recon_y"]
                self.recon_u = p.dev["urec"]
                self.recon_v = p.dev["vrec"]
        else:
            p.done_bytes = out + self._encode_idr(yp, up, vp, qp)
        self.frame_num = ((self.frame_num + 1)
                          % (1 << self.sps.log2_max_frame_num))
        self.frame_idx += 1
        self._queue.append(p)
        return p

    def _analyze(self, p):
        """Run the single-frame analyzer for p against p.refs and start
        the device→host copies of what the entropy stage reads: under
        pipelined use they overlap the next frame's device work."""
        dev = self._analyzer(self._upload(p.packed_src), *p.refs, p.qp,
                             p.qpc)
        chunks = dev["payload_nib"]
        items = [dev["packed_small"]] + chunks[:min(len(chunks),
                                                    self._nch_guess)]
        dev["_pre"] = {id(t): _D2H(t) for t in items}
        return dev

    def _dispatch_batch(self):
        """Run the accumulated P frames through the batched analyzer in
        one dispatch (cfg.dispatch_batch)."""
        accum = self._batch_accum
        if not accum:
            return
        self._batch_accum = []
        qp, qpc = accum[0].qp, accum[0].qpc
        for p in accum:              # the batch shares one qp (RC per batch)
            p.qp, p.qpc = qp, qpc
        srcs = np.stack([p.packed_src for p in accum])
        refs = (self.recon_y, self.recon_u, self.recon_v)
        outs = self._batch_analyzer(self._upload(srcs), *refs, qp, qpc)
        rec = _BatchRec(outs, len(accum), self._nch_guess)
        for k, p in enumerate(accum):
            p.batch = (rec, k)
            p.batch_next = accum[k + 1] if k + 1 < len(accum) else None
        # link for carry-patch propagation: if our refs were the carry of
        # a previous batch record, that record must know whom to redo
        prev = self._last_batch_rec
        if prev is not None and refs[0] is self._last_carry:
            prev.next_first = accum[0]
        k_last = len(accum) - 1
        self.recon_y = outs["recon_y"][k_last]
        self.recon_u = outs["urec"][k_last]
        self.recon_v = outs["vrec"][k_last]
        self._last_batch_rec = rec
        self._last_carry = self.recon_y

    def _batched_dev(self, p):
        """Per-frame view dict over a _BatchRec, shaped like a
        single-frame analyzer output for _encode_slice_device."""
        rec, k = p.batch
        rec.fetch()
        outs = rec.outs
        n_chunks = outs["payload"].shape[1]
        dev = {"packed_small": rec.small_np[k],
               "payload": [outs["payload"][k, c] for c in range(n_chunks)],
               "payload_nib": [rec.payload_np[k, c] if c < rec.nch
                               else outs["payload_nib"][k, c]
                               for c in range(n_chunks)]}
        for key in ("luma_lv", "udc", "uac", "vdc", "vac",
                    "recon_y", "urec", "vrec",
                    "recon_y_nf", "urec_nf", "vrec_nf"):
            if key in outs:
                dev[key] = outs[key][k]
        dev["_batch_next"] = p.batch_next
        dev["_batch_last"] = (k == rec.n_real - 1)
        dev["_batch_rec"] = rec
        return dev

    def finish_frame(self, p) -> bytes:
        """Entropy-code a begun frame. Must be called in begin order."""
        if not (self._queue and self._queue[0] is p):
            raise RuntimeError("h264: finish_frame order must be FIFO")
        self._queue.popleft()
        if p.kind == "done":
            return p.done_bytes
        if p.kind == "p" and p.dev is None and p.batch is None \
                and p.redo_refs is None:
            self._dispatch_batch()   # partial-batch flush
        if p.redo_refs is not None:
            # a predecessor patched the reference this analysis consumed
            # (intra fallback after dispatch) — re-run against the fix
            old = p.dev if p.dev is not None else \
                (self._batched_dev(p) if p.batch is not None else None)
            p.refs = p.redo_refs
            p.dev = self._analyze(p)
            self.n_redo += 1
            new = (p.dev["recon_y"], p.dev["urec"], p.dev["vrec"])
            if old is not None:
                self._propagate_refs(old, new)
            if p.batch_next is not None:
                # the batch successor's analysis also used stale refs
                p.batch_next.redo_refs = new
            p.batch = None
        dev = p.dev if p.dev is not None else self._batched_dev(p)
        return p.done_bytes + self._encode_slice_device(
            p.src[0], p.src[1], p.src[2], dev, p.qp, p.frame_num)

    def _propagate_refs(self, old_dev, new_refs):
        """Re-point everything that referenced old_dev's recon planes."""
        for q in self._queue:
            if q.kind == "p" and q.refs is not None \
                    and q.refs[0] is old_dev["recon_y"]:
                # keep q.refs current so a later propagation (e.g. the
                # re-dispatched frame itself getting patched) still matches
                q.refs = new_refs
                q.redo_refs = new_refs
        # batched frames chain explicitly (views break identity checks)
        nxt = old_dev.get("_batch_next")
        if nxt is not None and nxt in self._queue:
            nxt.redo_refs = new_refs
        if old_dev.get("_batch_last"):
            rec = old_dev.get("_batch_rec")
            if rec is not None and rec.next_first is not None \
                    and rec.next_first in self._queue:
                # a later batch consumed this batch's (now stale) carry
                rec.next_first.redo_refs = new_refs
            if self.recon_y is self._last_carry \
                    and rec is self._last_batch_rec:
                self.recon_y, self.recon_u, self.recon_v = new_refs
                self._last_carry = self.recon_y
        if self.recon_y is old_dev["recon_y"]:
            self.recon_y, self.recon_u, self.recon_v = new_refs

    # -- native (C++) stage ------------------------------------------------
    def _nal(self, ref_idc: int, ntype: int, rbsp: bytes) -> bytes:
        inb = np.frombuffer(rbsp, np.uint8)
        out = np.empty(len(rbsp) + len(rbsp) // 2 + 8, np.uint8)
        n = self._natlib.hb264_rbsp_to_ebsp(
            self._u8p(inb), len(rbsp), self._u8p(out), out.size)
        if n < 0:
            raise RuntimeError("h264: NAL emulation-prevention overflow")
        return (b"\x00\x00\x00\x01" + bytes([(ref_idc << 5) | ntype])
                + out[:n].tobytes())

    @staticmethod
    def _u8p(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    @staticmethod
    def _i8p(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))

    @staticmethod
    def _i16p(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))

    @staticmethod
    def _i32p(arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    def _native_i_slice(self, y, u, v, qp, qpc, hdr_bw):
        """Native IDR I slice; returns (NAL bytes, recon planes)."""
        sy, su, sv = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
        ry, ru, rv = (np.zeros_like(p) for p in (sy, su, sv))
        cap = self.mb_w * self.mb_h * 900 + len(hdr_bw._bytes) + 64
        out = np.empty(cap, np.uint8)
        hdr = np.frombuffer(bytes(hdr_bw._bytes), np.uint8)
        n = self._natlib.hb264_encode_i_slice(
            self.mb_w, self.mb_h, qp, qpc, int(self.cfg.cabac),
            self._u8p(hdr), hdr.size, hdr_bw._cur, hdr_bw._nbits,
            self._u8p(sy), self._u8p(su), self._u8p(sv),
            self._u8p(ry), self._u8p(ru), self._u8p(rv),
            self._u8p(out), cap)
        if n < 0:
            raise RuntimeError("h264: native I slice overflowed its buffer")
        return self._nal(3, NAL_IDR, out[:n].tobytes()), (ry, ru, rv)

    def _encode_idr(self, y, u, v, qp) -> bytes:
        """IDR frame: native I slice, native in-loop deblock (all-intra:
        bS 4/3 everywhere), then one upload of the recon."""
        qpc = T.chroma_qp(qp, self.cfg.chroma_qp_offset)
        hdr = SliceHeader(slice_type=SLICE_I, idr=True, frame_num=0,
                          idr_pic_id=self.idr_pic_id, qp=qp,
                          disable_deblocking=0 if self.cfg.deblock else 1)
        payload, (ry, ru, rv) = self._native_i_slice(
            y, u, v, qp, qpc, hdr.write(self.sps, self.pps))
        self.idr_pic_id = (self.idr_pic_id + 1) % 16
        if self.cfg.deblock:
            n_mb = self.mb_w * self.mb_h
            im = np.ones(n_mb, np.int8)
            mv32 = np.zeros(n_mb * 2, np.int32)
            nz = np.zeros(n_mb * 16, np.int8)
            self._natlib.hb264_deblock(
                self._u8p(ry), self._u8p(ru), self._u8p(rv),
                self.mb_w, self.mb_h, qp, qpc,
                self._i8p(im), self._i32p(mv32), self._i8p(nz), None)
        self.recon_y, self.recon_u, self.recon_v = self._upload_planes(
            ry, ru, rv)
        return payload

    def _parse_packed(self, buf, n_mb, cap):
        """Decode the analyzer's packed_small byte buffer into the
        walker's per-MB arrays."""
        buf = np.ascontiguousarray(buf, np.uint8)
        out = {}
        hdr = np.frombuffer(buf, np.int32, 3, 0)
        out["n_intra"], out["n_coded"], out["overflow"] = (int(x) for x in hdr)
        off = 12
        out["mv"] = np.frombuffer(buf, np.int16, n_mb * 2, off).reshape(
            n_mb, 2)
        off += n_mb * 4
        out["sad"] = np.frombuffer(buf, np.int32, n_mb, off)
        off += n_mb * 4
        out["cbp_luma"] = np.frombuffer(buf, np.int8, n_mb, off)
        off += n_mb
        out["t8"] = np.frombuffer(buf, np.int8, n_mb, off)
        off += n_mb
        out["unnz"] = np.frombuffer(buf, np.int8, n_mb * 4, off).reshape(
            n_mb, 4)
        off += n_mb * 4
        out["vnnz"] = np.frombuffer(buf, np.int8, n_mb * 4, off).reshape(
            n_mb, 4)
        off += n_mb * 4
        idx_dt = np.int16 if n_mb <= 32767 else np.int32
        out["coded_idx"] = np.frombuffer(buf, idx_dt, cap, off)
        off += cap * np.dtype(idx_dt).itemsize
        out["nib_ok"] = np.frombuffer(buf, np.int8, n_mb, off)
        return out

    def _dummy_recon(self):
        """Zero planes handed to the native walker when no MB can take the
        intra-fallback path (n_intra == 0): the walker never reads or
        writes them, so the device recon never crosses to the host."""
        if self._dummy_rec is None:
            H, W = self.mb_h * 16, self.mb_w * 16
            self._dummy_rec = (np.zeros((H, W), np.uint8),
                               np.zeros((H // 2, W // 2), np.uint8),
                               np.zeros((H // 2, W // 2), np.uint8))
        return self._dummy_rec

    def _native_p_slice(self, y, u, v, small, dev, n_intra, qp, qpc,
                        hdr_bw) -> bytes:
        sy, su, sv = (np.ascontiguousarray(p, np.uint8) for p in (y, u, v))
        if n_intra > 0:
            # recon planes pre-filled with the device recon; the walker
            # patches intra-fallback MBs in place.  With deblock the
            # patch base is the UNFILTERED recon (intra prediction reads
            # pre-filter samples); the whole frame re-filters below.
            keys = (("recon_y_nf", "urec_nf", "vrec_nf")
                    if self.cfg.deblock else ("recon_y", "urec", "vrec"))
            ry, ru, rv = (np.array(x, np.uint8)
                          for x in _fetch([dev[k] for k in keys]))
        else:
            ry, ru, rv = self._dummy_recon()
        cap = self.mb_w * self.mb_h * 900 + len(hdr_bw._bytes) + 64
        out = np.empty(cap, np.uint8)
        hdr = np.frombuffer(bytes(hdr_bw._bytes), np.uint8)

        def arr(name, dt):
            return np.ascontiguousarray(small[name], dt)

        n_mb = self.mb_w * self.mb_h
        mv = arr("mv", np.int16)
        sad = arr("sad", np.int32)
        luma_lv = arr("luma_lv", np.int16)
        cbp_luma = arr("cbp_luma", np.int8)
        t8a = (arr("t8", np.int8) if self.cfg.transform8x8
               else np.zeros(n_mb, np.int8))
        udc, vdc = arr("udc", np.int16), arr("vdc", np.int16)
        uac, vac = arr("uac", np.int16), arr("vac", np.int16)
        unnz, vnnz = arr("unnz", np.int8), arr("vnnz", np.int8)
        out_intra = np.zeros(n_mb, np.int8)
        out_nnz = np.zeros(n_mb * 16, np.int8)
        n = self._natlib.hb264_encode_p_slice(
            self.mb_w, self.mb_h, qp, qpc, intra_thresh_for_qp(qp),
            int(self.cfg.cabac), int(self.cfg.transform8x8),
            self._u8p(hdr), hdr.size, hdr_bw._cur, hdr_bw._nbits,
            self._u8p(sy), self._u8p(su), self._u8p(sv),
            self._i16p(mv), self._i32p(sad),
            self._i16p(luma_lv), self._i8p(cbp_luma), self._i8p(t8a),
            self._i16p(udc), self._i16p(vdc), self._i16p(uac),
            self._i16p(vac), self._i8p(unnz), self._i8p(vnnz),
            self._u8p(ry), self._u8p(ru), self._u8p(rv),
            self._u8p(out), cap, self._i8p(out_intra), self._i8p(out_nnz))
        if n < 0:
            raise RuntimeError("h264: native P slice overflowed its buffer")
        if n_intra > 0:
            if self.cfg.deblock:
                # re-filter the patched frame with the true intra mask +
                # final nnz grid (native spec 8.7 filter)
                mvs32 = np.ascontiguousarray(mv.astype(np.int32).ravel())
                t8eff = np.ascontiguousarray(t8a * (1 - out_intra), np.int8)
                self._natlib.hb264_deblock(
                    self._u8p(ry), self._u8p(ru), self._u8p(rv),
                    self.mb_w, self.mb_h, qp, qpc,
                    self._i8p(out_intra), self._i32p(mvs32),
                    self._i8p(out_nnz),
                    self._i8p(t8eff) if self.cfg.transform8x8 else None)
            # intra-fallback MBs were patched into the host recon copy —
            # upload it once and re-point the reference chain (in-flight
            # analyses re-dispatch)
            self._propagate_refs(dev, self._upload_planes(ry, ru, rv))
        return self._nal(3, NAL_SLICE, out[:n].tobytes())

    # -- device-assisted P slice ------------------------------------------
    def _encode_slice_device(self, y, u, v, dev, qp, frame_num) -> bytes:
        """Native syntax walk over the device analysis: the exact skip
        decision, the (rare) intra fallback, and the entropy coding.
        Levels arrive through the compact nibble payload (coded MBs only,
        fetched chunk by chunk); the int16 arrays are the fallback for
        level overflow or dense frames."""
        qpc = T.chroma_qp(qp, self.cfg.chroma_qp_offset)
        hdr = SliceHeader(slice_type=SLICE_P, idr=False,
                          frame_num=frame_num, qp=qp,
                          disable_deblocking=0 if self.cfg.deblock else 1)
        n_mb = self.mb_w * self.mb_h
        per = dev["payload"][0].shape[0]
        n_chunks = len(dev["payload"])
        nib = dev["payload_nib"]
        pre = dev.get("_pre")
        guess = min(n_chunks, self._nch_guess)
        got = _fetch([dev["packed_small"]] + nib[:guess], pre)
        small = self._parse_packed(got[0], n_mb, per * n_chunks)
        chunks = got[1:]
        n_intra = int(small["n_intra"])
        n_coded = int(small["n_coded"])
        if int(small["overflow"]) or n_coded > per * n_chunks:
            keys = ("luma_lv", "udc", "uac", "vdc", "vac")
            for k, a in zip(keys, _fetch([dev[k] for k in keys])):
                small[k] = np.ascontiguousarray(a, np.int16)
            self._nch_guess = n_chunks
        else:
            nch = -(-n_coded // per) if n_coded else 0
            if nch > guess:
                chunks += _fetch(nib[guess:nch], pre)
            self._nch_guess = min(n_chunks, nch + 1)
            pay = np.zeros((n_mb, 392), np.int16)
            if nch:
                rows = np.concatenate(chunks[:nch])[:n_coded]
                cidx = small["coded_idx"][:n_coded]
                # unpack 4-bit two's complement pairs
                b = rows.view(np.uint8).astype(np.int16)
                unp = np.empty((rows.shape[0], 392), np.int16)
                unp[:, 0::2] = ((b & 15) ^ 8) - 8
                unp[:, 1::2] = ((b >> 4) ^ 8) - 8
                bad = np.nonzero(small["nib_ok"][cidx] == 0)[0]
                if bad.size:
                    # int8 rows for the out-of-range MBs
                    full_rows = _fetch([dev["payload"][k // per][k % per]
                                        for k in bad])
                    for j, r8 in zip(bad, full_rows):
                        unp[j] = np.asarray(r8, np.int16)
                pay[cidx] = unp
            small["luma_lv"] = pay[:, :256].reshape(n_mb, 16, 4, 4)
            small["udc"] = pay[:, 256:260]
            small["uac"] = pay[:, 260:324].reshape(n_mb, 4, 4, 4)
            small["vdc"] = pay[:, 324:328]
            small["vac"] = pay[:, 328:392].reshape(n_mb, 4, 4, 4)
        return self._native_p_slice(y, u, v, small, dev, n_intra, qp, qpc,
                                    hdr.write(self.sps, self.pps))
