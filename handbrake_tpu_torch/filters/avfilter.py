"""FILTER_AVFILTER — the user escape hatch (avfilter.c/hbavfilter.c
role).

The reference lets jobs splice an arbitrary FFmpeg filter graph into
the pipeline via a graph string.  There is no libavfilter on the TPU
path, so the escape hatch composes OUR native/device filters instead:
the graph string names filters from the registry (the same short names
the reference's aliases map to — hqdn3d, unsharp, deblock, nlmeans,
yadif, ...) with `name=key=val:key=val` settings, chained left to
right:

    {"ID": 16, "Settings": {"graph": "hqdn3d=y_spatial=4,unsharp"}}

Each stage goes through the normal Filter init negotiation, so
geometry/vrate changes propagate exactly as in the static pipeline.
"""
from __future__ import annotations

from ..core.buffer import Buffer
from ..job import schema as S
from .base import Filter, FilterError, FilterInit, create_filter, register

_NAME_TO_ID = {name: fid for fid, name in S.FILTER_NAMES.items()}
# reference alias spellings → our registry names
_ALIASES = {"denoise": "hqdn3d", "scale": "crop_scale",
            "zscale": "crop_scale", "transpose": "rotate",
            "format": "format", "deinterlace": "yadif"}


def _parse_graph(graph: str):
    """'name=k=v:k=v,name2,...' → [(filter_id, settings dict)]."""
    out = []
    for seg in graph.split(","):
        seg = seg.strip()
        if not seg:
            continue
        name, _, rest = seg.partition("=")
        name = _ALIASES.get(name.strip(), name.strip())
        fid = _NAME_TO_ID.get(name)
        if fid is None:
            raise FilterError(f"avfilter: unknown filter {name!r}")
        settings = {}
        if rest:
            for kv in rest.split(":"):
                k, _, v = kv.partition("=")
                if not k:
                    continue
                try:
                    val = float(v) if "." in v else int(v)
                except ValueError:
                    val = v
                settings[k.strip()] = val
        out.append((fid, settings))
    return out


@register
class AvfilterEscape(Filter):
    id = S.FILTER_AVFILTER
    name = "avfilter"

    def init(self, fi: FilterInit) -> FilterInit:
        graph = str(self.settings.get("graph",
                                      self.settings.get("Graph", "")))
        if not graph:
            raise FilterError("avfilter: empty graph")
        self.chain = []
        cur = fi
        for fid, settings in _parse_graph(graph):
            f = create_filter(fid, settings)
            cur = f.init(cur)
            self.chain.append(f)
        self.fi = cur.copy()
        return self.fi

    def keeps_state(self):
        return next((f"({f.name}) {why}" for f in self.chain
                     if (why := f.keeps_state()) is not None), None)

    def work(self, buf: Buffer) -> list:
        bufs = [buf]
        for f in self.chain:
            nxt = []
            for b in bufs:
                nxt.extend(f.work(b))
            bufs = nxt
        return bufs

    def flush(self) -> list:
        bufs: list = []
        for f in self.chain:
            nxt = []
            for b in bufs:
                nxt.extend(f.work(b))
            if hasattr(f, "flush"):
                nxt.extend(f.flush())
            bufs = nxt
        return bufs
