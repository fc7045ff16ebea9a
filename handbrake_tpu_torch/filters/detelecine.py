"""Inverse telecine (reference: detelecine.c — MPlayer pullup) — the
counterpart of ``handbrake_tpu/filters/detelecine.py``.

Field-matching IVTC: for each incoming frame, evaluate three weave
candidates — C (keep both fields), P (current top + previous bottom),
N (current bottom + previous top) — score each by the vertical combing
energy of the woven result (a device reduction, the pullup "breaks/affinity"
metric analog, detelecine.c:15-51), weave the best, and drop the 5th frame
of a stable 3:2 cadence (the duplicate), restoring 4 progressive frames
from every 5 telecined ones.

The weaves are exact.  The scores and the motion test are f32 means, as
in the reference, summed in PyTorch's order rather than XLA's: a choice
could differ from the reference's only where two scores (or the motion
and its limit of 2.0) lie within that rounding of each other.
"""
from __future__ import annotations

import torch

from ..core.buffer import Buffer, BufFlags
from ..job import schema as S
from ..utils.device import resolve_device
from .base import Filter, FilterInit, register
from .kernels import to_tensor


def comb_energy(y: torch.Tensor) -> torch.Tensor:
    """Vertical alternation energy — high for interlaced weaves (f32)."""
    a = y.to(torch.float32)
    d = a[:-2] - 2 * a[1:-1] + a[2:]
    return torch.mean(torch.abs(d))


def _weave(top_src, bot_src) -> list:
    """Take even rows from top_src, odd rows from bot_src (per plane)."""
    out = []
    for t, b in zip(top_src, bot_src):
        even = (torch.arange(t.shape[0], device=t.device) % 2 == 0)[:, None]
        # in int32: few operations take uint16 tensors
        out.append(torch.where(even, t.to(torch.int32),
                               b.to(torch.int32)).to(t.dtype))
    return out


@register
class DetelecineFilter(Filter):
    id = S.FILTER_DETELECINE
    name = "detelecine"
    state = "keeps state across frames and drops frames"

    def init(self, fi: FilterInit) -> FilterInit:
        self.prev: Buffer | None = None
        self.cadence: list = []   # recent match choices, for dup detection
        self.since_drop = 0
        self.device = resolve_device(fi.device)
        self.fi = fi.copy()
        # 3:2 pulldown removal: 30000/1001 → 24000/1001 when cadence locks
        self.fi.cfr = 0
        self.maxval = (1 << fi.pix_fmt.bit_depth) - 1
        self.scores: dict = {}    # the last frame's scores, for tests
        return self.fi

    def work(self, buf: Buffer) -> list:
        if buf.is_eof():
            self.prev = None
            return [buf]
        if buf.planes is None:
            return [buf]
        buf.planes = [to_tensor(p, self.device) for p in buf.planes]
        if self.prev is None:
            self.prev = buf
            return [buf]
        prev = self.prev
        self.prev = buf
        cands = {
            "c": buf.planes,
            "p": _weave(buf.planes, prev.planes),
            "n": _weave(prev.planes, buf.planes),
        }
        vals = torch.stack([comb_energy(v[0]) for v in cands.values()]).cpu()
        scores = dict(zip(cands, (float(v) for v in vals)))
        self.scores = scores
        best = min(scores, key=scores.get)
        self.cadence.append(best)
        if len(self.cadence) > 10:
            self.cadence.pop(0)
        self.since_drop += 1
        # duplicate detection: a matched weave that equals the previous
        # output (low combing AND low motion) in a 5-frame cadence → drop
        if best != "c" and self.since_drop >= 5:
            motion = float(torch.mean(torch.abs(
                cands[best][0].to(torch.float32)
                - prev.planes[0].to(torch.float32))))
            if motion < 2.0:
                self.since_drop = 0
                return []  # drop the duplicate; VFR filter re-times
        if best == "c":
            return [buf]
        out = Buffer(planes=cands[best],
                     pix_fmt=buf.pix_fmt).copy_props(buf)
        out.flags &= ~(BufFlags.INTERLACED | BufFlags.TOP_FIRST)
        return [out]
