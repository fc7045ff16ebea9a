"""Filter protocol — hb_filter_object_t re-expressed (common.h:1670-1711).

A filter negotiates geometry/pixfmt/framerate in ``init`` (the
hb_filter_init_t contract, work.c:1831-1877: each filter receives the
upstream format and returns what it outputs) and transforms buffers in
``work``. Temporal filters may buffer internally; an EOF buffer flushes.

Each filter class says whether its output for a frame depends on that
frame alone, one frame out for each frame in (``state`` None), or why
not: the default is that it keeps state.  A resumed job whose filters
all keep none may skip the decode ahead of its last keyframe
(``work.py``, ``checkpoint.py``).

Port notes: pixel work is torch operations on the device the job runs
on; ``create_filter`` raises FilterError for an id nobody registered, and
the port's FilterGraph turns a known but unported id into
NotImplementedError before it gets here.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Optional

from ..core.buffer import Buffer, Geometry, PixFmt, YUV420P


@dataclasses.dataclass
class FilterInit:
    """Negotiated stream parameters handed down the chain (hb_filter_init_t)."""
    geometry: Geometry = dataclasses.field(
        default_factory=lambda: Geometry(0, 0))
    pix_fmt: PixFmt = YUV420P
    vrate: Fraction = Fraction(30000, 1001)
    cfr: int = 0              # 0=vfr 1=cfr 2=pfr
    crop: tuple = (0, 0, 0, 0)  # top, bottom, left, right (applied so far)
    color_prim: str = "bt709"
    color_transfer: str = "bt709"
    color_matrix: str = "bt709"
    color_range: str = "limited"
    # where the filters' device work runs: "cuda", "cpu" or a
    # torch.device; None means the CUDA card
    device: object = None

    def copy(self) -> "FilterInit":
        return dataclasses.replace(self)


class FilterError(Exception):
    pass


class Filter:
    """Base filter. Subclasses set ``id``/``name`` and override init/work."""
    id: int = -1
    name: str = "?"
    # why the output for a frame depends on other frames, or the frame
    # count changes; None where neither holds
    state: Optional[str] = "keeps state across frames"

    def __init__(self, settings: Optional[dict] = None):
        self.settings = dict(settings or {})
        self.fi: Optional[FilterInit] = None

    # -- negotiation --------------------------------------------------------
    def init(self, fi: FilterInit) -> FilterInit:
        """Consume upstream format, return downstream format."""
        self.fi = fi.copy()
        return self.fi

    # -- processing ---------------------------------------------------------
    def work(self, buf: Buffer) -> list:
        """Transform one buffer into zero or more buffers.

        An EOF buffer must be propagated (after any flush output).
        """
        if buf.is_eof():
            return self.flush() + [buf]
        return [buf]

    def flush(self) -> list:
        """Emit internally buffered frames at end of stream."""
        return []

    def close(self):
        pass

    def keeps_state(self) -> Optional[str]:
        """None where the output for a frame depends on that frame alone,
        one frame out for each frame in; else why not (settings may
        decide: a filter overrides this where they do)."""
        return self.state


_REGISTRY: dict = {}


def register(cls):
    """Class decorator: add to the filter registry (hb_register analog)."""
    _REGISTRY[cls.id] = cls
    return cls


def create_filter(filter_id: int, settings: Optional[dict] = None) -> Filter:
    if filter_id not in _REGISTRY:
        raise FilterError(f"unknown filter id {filter_id}")
    return _REGISTRY[filter_id](settings)


def registry() -> dict:
    return dict(_REGISTRY)
