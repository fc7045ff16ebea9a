"""Frame/packet buffer — the single payload type flowing through the pipeline.

Semantics modeled on the reference's ``hb_buffer_t`` (libhb/handbrake/internal.h:65-165):
a buffer carries either compressed data (``data``) or planar video (``planes``), plus
timing (pts/stop/duration, 90 kHz clock), frame-type flags, chapter marks, and
arbitrary side data (HDR metadata, DoVi RPU, closed captions) that must ride along
through every stage.

Port differences: planes are numpy arrays on the host side of a stage boundary and
may be torch tensors (on the CUDA card or the CPU) between the filters and the
encoder; there is no global size-binned pool (the caching allocator owns device
memory; host arrays are GC'd).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import numpy as np

# 90 kHz clock, like the reference (libhb uses 90000 ticks/sec everywhere).
CLOCK = 90000
CLOCK_RATE = CLOCK

# Frame type flags — semantics of internal.h:65-114.
class FrameType(enum.IntFlag):
    UNKNOWN = 0
    IDR = 1 << 0       # instantaneous decoder refresh / key
    I = 1 << 1
    P = 1 << 2
    B = 1 << 3
    BREF = 1 << 4      # B used as reference
    KEY = 1 << 5       # generic keyframe (audio sync points etc.)
    REF = 1 << 6


class BufFlags(enum.IntFlag):
    NONE = 0
    DISCONTINUITY = 1 << 0   # SCR break upstream
    EOF = 1 << 1             # flush marker (explicit EOF buffers, like HB_BUF_FLAG_EOF)
    EOS = 1 << 2             # end of stream/title
    TOP_FIRST = 1 << 3       # interlaced, top field first
    INTERLACED = 1 << 4
    REPEAT_FIRST_FIELD = 1 << 5
    CHAPTER = 1 << 6         # new_chap set


@dataclasses.dataclass
class Geometry:
    """Picture geometry (mirrors hb_geometry_t + PAR)."""
    width: int
    height: int
    par_num: int = 1
    par_den: int = 1

    def display_width(self) -> int:
        return int(round(self.width * self.par_num / self.par_den))


# Pixel formats we support natively. Planar YUV with bit depth.
@dataclasses.dataclass(frozen=True)
class PixFmt:
    name: str
    bit_depth: int
    subsampling: tuple  # (sub_w, sub_h) for chroma
    nplanes: int = 3

    @property
    def dtype(self):
        return np.uint8 if self.bit_depth <= 8 else np.uint16


YUV420P = PixFmt("yuv420p", 8, (2, 2))
YUV420P10 = PixFmt("yuv420p10", 10, (2, 2))
YUV420P12 = PixFmt("yuv420p12", 12, (2, 2))
YUV422P = PixFmt("yuv422p", 8, (2, 1))
YUV422P10 = PixFmt("yuv422p10", 10, (2, 1))
YUV444P = PixFmt("yuv444p", 8, (1, 1))
YUV444P10 = PixFmt("yuv444p10", 10, (1, 1))
GRAY8 = PixFmt("gray8", 8, (1, 1), nplanes=1)
RGBA = PixFmt("rgba", 8, (1, 1), nplanes=1)  # packed, for subtitle bitmaps

PIX_FMTS = {f.name: f for f in
            [YUV420P, YUV420P10, YUV420P12, YUV422P, YUV422P10, YUV444P,
             YUV444P10, GRAY8, RGBA]}


def chroma_size(fmt: PixFmt, width: int, height: int) -> tuple:
    sw, sh = fmt.subsampling
    return ((width + sw - 1) // sw, (height + sh - 1) // sh)


@dataclasses.dataclass
class Buffer:
    """One unit of pipeline payload: compressed packet OR raw frame.

    Timing fields are in 90 kHz ticks; ``pts`` may be None for unknown
    (the reference uses AV_NOPTS_VALUE).
    """
    # --- payload ---
    data: Optional[bytes] = None               # compressed packet payload
    planes: Optional[list] = None              # list of numpy/torch 2-D arrays (Y, U, V)
    pix_fmt: Optional[PixFmt] = None

    # --- stream routing ---
    stream_id: int = 0                         # which track this belongs to
    track_kind: str = "video"                  # video|audio|subtitle

    # --- timing (90 kHz) ---
    pts: Optional[int] = None
    stop: Optional[int] = None
    duration: Optional[int] = None
    dts: Optional[int] = None
    renderOffset: Optional[int] = None         # ctts-style offset, mux side

    # --- frame classification ---
    frametype: FrameType = FrameType.UNKNOWN
    flags: BufFlags = BufFlags.NONE
    new_chap: int = 0                          # chapter index starting at this buffer
    combed: int = 0                            # comb_detect verdict (s.combed analog)

    # --- side data: dict name -> payload (HDR10+, DoVi RPU, CC, A53, mastering) ---
    side_data: dict = dataclasses.field(default_factory=dict)

    # --- subtitle payloads ---
    text: Optional[str] = None                 # text subtitle event
    rect: Optional[tuple] = None               # (x, y, w, h) for bitmap subs

    def is_eof(self) -> bool:
        return bool(self.flags & BufFlags.EOF)

    @property
    def width(self) -> int:
        return self.planes[0].shape[1] if self.planes else 0

    @property
    def height(self) -> int:
        return self.planes[0].shape[0] if self.planes else 0

    def copy_props(self, src: "Buffer") -> "Buffer":
        """Carry timing/flags/side-data from src (hb_buffer_copy_props analog)."""
        self.pts, self.stop = src.pts, src.stop
        self.duration, self.dts = src.duration, src.dts
        self.renderOffset = src.renderOffset
        self.frametype, self.flags = src.frametype, src.flags
        self.new_chap, self.combed = src.new_chap, src.combed
        self.stream_id, self.track_kind = src.stream_id, src.track_kind
        self.side_data = dict(src.side_data)
        return self

    @staticmethod
    def eof() -> "Buffer":
        return Buffer(flags=BufFlags.EOF)

    @staticmethod
    def frame(fmt: PixFmt, width: int, height: int, fill: int = 0) -> "Buffer":
        """Allocate a black/filled frame (CreateBlackBuf analog, sync.c:349)."""
        planes = []
        dt = fmt.dtype
        if fmt.nplanes == 1:
            planes.append(np.full((height, width), fill, dtype=dt))
        else:
            planes.append(np.full((height, width), 16 << (fmt.bit_depth - 8), dtype=dt))
            cw, ch = chroma_size(fmt, width, height)
            mid = 128 << (fmt.bit_depth - 8)
            planes.append(np.full((ch, cw), mid, dtype=dt))
            planes.append(np.full((ch, cw), mid, dtype=dt))
        return Buffer(planes=planes, pix_fmt=fmt)

    def nbytes(self) -> int:
        n = len(self.data) if self.data else 0
        if self.planes is not None:
            for p in self.planes:
                n += getattr(p, "nbytes", 0)
        return n
