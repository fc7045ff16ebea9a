"""Universal H.264 decoder — Python wrapper over native/hbdec264.cpp.

Role of decavcodec.c's H.264 video personality (decodeFrame
decavcodec.c:1709): decode arbitrary conformant streams (CAVLC + CABAC,
I/P slices, all intra modes and inter partition shapes, multi-ref,
deblocking, per-MB QP), not just this framework's encoder subset.
Output frames are MB-aligned planes in decode order with POC attached;
`decode()` reorders by POC before returning (no-op until B frames land).
"""
from __future__ import annotations

import ctypes

import numpy as np

from .bits import split_annexb
from .syntax import NAL_SPS, SPS


class NativeH264Decoder:
    """Feed annex-B bytes or single NALs; yields (y, u, v) uint8 frames."""

    def __init__(self):
        from ...native import get_decoder_lib as get_lib
        self.lib = get_lib()
        if self.lib is None or not hasattr(self.lib, "hbdec264_create"):
            raise RuntimeError("native decoder unavailable")
        self.h = self.lib.hbdec264_create()
        self.sps = None            # python-side SPS mirror for info()
        self._wh = None

    def close(self):
        if self.h:
            self.lib.hbdec264_free(self.h)
            self.h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- low level ----------------------------------------------------------
    def _u8p(self, arr):
        return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    def send_nal(self, nal: bytes) -> int:
        if (nal[0] & 0x1F) == NAL_SPS:
            try:
                from .bits import ebsp_to_rbsp
                self.sps = SPS.parse(ebsp_to_rbsp(nal[1:]))
            except Exception:
                pass
        buf = np.frombuffer(nal, np.uint8)
        n = self.lib.hbdec264_send_nal(self.h, self._u8p(buf), buf.size)
        if n < 0:
            err = self.lib.hbdec264_error(self.h)
            raise RuntimeError("hbdec264: %s" %
                               (err.decode() if err else "decode error"))
        return n

    def _geometry(self):
        w = ctypes.c_int()
        h = ctypes.c_int()
        cw = ctypes.c_int()
        ch = ctypes.c_int()
        if self.lib.hbdec264_geometry(self.h, ctypes.byref(w),
                                      ctypes.byref(h), ctypes.byref(cw),
                                      ctypes.byref(ch)):
            self._wh = (w.value, h.value, cw.value, ch.value)
        return self._wh

    def _drain(self):
        out = []
        g = self._geometry()
        if g is None:
            return out
        W, H = g[0], g[1]
        while True:
            y = np.empty((H, W), np.uint8)
            u = np.empty((H // 2, W // 2), np.uint8)
            v = np.empty((H // 2, W // 2), np.uint8)
            w = ctypes.c_int()
            h = ctypes.c_int()
            poc = ctypes.c_longlong()
            idr = ctypes.c_int()
            ok = self.lib.hbdec264_get_frame(
                self.h, self._u8p(y), self._u8p(u), self._u8p(v),
                ctypes.byref(w), ctypes.byref(h), ctypes.byref(poc),
                ctypes.byref(idr))
            if not ok:
                break
            cw, ch = g[2], g[3]
            if (cw, ch) != (W, H):     # SPS frame cropping
                y = np.ascontiguousarray(y[:ch, :cw])
                u = np.ascontiguousarray(u[:ch // 2, :cw // 2])
                v = np.ascontiguousarray(v[:ch // 2, :cw // 2])
            out.append((y, u, v, int(poc.value), bool(idr.value)))
        return out

    # -- high level ---------------------------------------------------------
    def decode_nal(self, nal: bytes):
        """Returns one (y,u,v) frame if the NAL completed a picture."""
        self.send_nal(nal)
        got = self._drain()
        return got[0][:3] if got else None

    def decode(self, data: bytes):
        """Decode a complete annex-B stream → list of (y,u,v) frames in
        output (POC) order."""
        frames = []
        for nal in split_annexb(data):
            self.send_nal(nal)
            frames.extend(self._drain())
        # reorder by POC within IDR periods (stable for P-only streams)
        out = []
        group = []
        for f in frames:
            if f[4] and group:          # IDR starts a new period
                group.sort(key=lambda t: t[3])
                out.extend(g[:3] for g in group)
                group = []
            group.append(f)
        group.sort(key=lambda t: t[3])
        out.extend(g[:3] for g in group)
        return out
