"""Filter chain assembly + negotiation (reference: work.c:1788-1899 filter
init loop and common.c:5491 hb_filter_init) — the counterpart of
``handbrake_tpu/filters/graph.py``.

Builds Filter instances from a job's FilterList (ordered by FILTER_ORDER —
the enum-order contract), runs the init negotiation down the chain (a
ported filter that refuses its settings with FilterError is disabled, not
fatal — work.c:1852-1859), and processes buffers through the chain with
fan-out (one input buffer may produce 0..n outputs at each stage).

Every filter the reference package registers is ported, the subtitle
burn-in (render_sub) included.  An id no package registers (mt_frame, or
an unknown one) is disabled and logged, as the reference does.
"""
from __future__ import annotations

from ..core.buffer import Buffer
from ..job import schema as S
from ..utils.logging import error
from .base import FilterError, FilterInit, create_filter

# the filter modules, so that their @register decorators run
from . import (avfilter, bm3d, colorspace, comb_detect,  # noqa: F401
               cropscale, deband, deblock, decomb, deinterlace, denoise,
               detelecine, nlmeans, rendersub, rpu, sharp, simple, vfr)


class FilterGraph:
    def __init__(self, filter_list: list, fi: FilterInit):
        """filter_list: [{"ID": int, "Settings": dict}] (job JSON schema)."""
        order = {fid: i for i, fid in enumerate(S.FILTER_ORDER)}
        specs = sorted(filter_list, key=lambda f: order.get(f["ID"], 99))
        self.filters: list = []
        self.fi_in = fi.copy()
        cur = fi.copy()
        for spec in specs:
            try:
                f = create_filter(spec["ID"], spec.get("Settings"))
                cur = f.init(cur)
                self.filters.append(f)
            except FilterError as e:
                # disabled, not fatal (work.c:1852-1859)
                error(f"filter {spec['ID']} disabled: {e}")
        self.fi_out = cur

    def queue_subtitle(self, ev: Buffer) -> bool:
        """Route a subtitle event straight to the burn-in filter (subtitle
        buffers never traverse the video chain — fifo routing analog)."""
        for f in self.filters:
            if getattr(f, "name", "") == "render_sub":
                f.queue_subtitle(ev)
                return True
        return False

    def keeps_state(self):
        """None where every filter is frame-local; else the first filter
        that is not, named, and why."""
        return next((f"{f.name} {why}" for f in self.filters
                     if (why := f.keeps_state()) is not None), None)

    def work(self, buf: Buffer) -> list:
        bufs = [buf]
        for f in self.filters:
            nxt = []
            for b in bufs:
                nxt.extend(f.work(b))
            bufs = nxt
            if not bufs:
                break
        return bufs

    def flush(self) -> list:
        """Flush every stage in order, feeding downstream stages."""
        out = self.work(Buffer.eof())
        return [b for b in out if not b.is_eof()]

    def close(self):
        for f in self.filters:
            f.close()
