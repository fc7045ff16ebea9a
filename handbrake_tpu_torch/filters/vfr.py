"""VFR/CFR/PFR framerate shaper (reference: vfr.c + motion_metric.c).

Settings: mode (0=vfr passthrough, 1=cfr, 2=pfr), rate (Fraction or
"num/den"). CFR re-times to a fixed grid, duplicating into gaps and
dropping on overruns; like the reference (find_drop_frame vfr.c:133) a
small candidate queue is kept and the frame with the lowest motion metric
(most similar to its neighbours — SAD on device, motion_metric.c analog)
is the one dropped.

PFR holds the stream at or under a peak rate as vfr.c's
adjust_frame_rate does: a clock counts the frames kept, each a peak
frame time F long from the first frame's start; a frame that stops a
whole F or more before the clock's next tick is dropped, and a kept
frame starts where the last kept one stopped and stops at its own stop
or at the clock's tick, whichever is later.  So a faster source keeps
its length (60 fps into peak 30: every other frame, each 2 source
frames long), and a source at or under the peak keeps its own times
where its frames are contiguous.  The rate that leaves the filter is
the lower of the source's and the peak.

The counterpart of ``handbrake_tpu/filters/vfr.py``: the motion metric
is the reference's f32 mean, summed in the order XLA:CPU sums it (see
``motion_metric``), so a near-tie between two candidates, where the f32
sum has rounded, is broken as the reference breaks it, on the card and
on the CPU alike.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..core.buffer import Buffer, CLOCK
from ..utils.device import resolve_device
from .base import Filter, FilterInit, register
from .kernels import to_tensor
from ..job import schema as S


# XLA:CPU's tree reduction: windows of 32 along each axis longer than 32
# (the axis padded with zeros to a multiple of 32, half the padding in
# front), an axis of 32 or less in one window; repeated until no axis is
# longer than 32
_WINDOW = 32


def _windows(n: int) -> tuple:
    """(windows, window size, zeros in front) of one axis of length n."""
    if n <= _WINDOW:
        return 1, n, 0
    k = -(-n // _WINDOW)
    return k, _WINDOW, (k * _WINDOW - n) // 2


def _window_view(x: torch.Tensor) -> torch.Tensor:
    """(H, W) → (windows down, windows across, elements of a window in row
    order), the zero padding included."""
    (kh, sh, th), (kw, sw, tw) = _windows(x.shape[0]), _windows(x.shape[1])
    p = torch.zeros((kh * sh, kw * sw), dtype=x.dtype, device=x.device)
    p[th:th + x.shape[0], tw:tw + x.shape[1]] = x
    return p.reshape(kh, sh, kw, sw).transpose(1, 2).reshape(kh, kw, -1)


def _chain(x: np.ndarray) -> np.ndarray:
    """Sums over the last axis as f32 chains from 0 in index order."""
    return np.add.accumulate(x.astype(np.float32), axis=-1,
                             dtype=np.float32)[..., -1]


def motion_metric(a, b, device=None) -> float:
    """Mean absolute difference between two luma planes (numpy or
    tensors), as the reference's jitted ``jnp.mean`` computes it on the
    CPU: XLA sums the f32 values as a tree of window chains
    (``_windows``); each window's sum is a chain of f32 adds in row order;
    the last level, of at most 32 x 32 sums, is a chain in row order, but
    two rows are summed as two chains added at the end (LLVM vectorizes
    that loop); the mean is that sum times f32(1/n).  The first level runs
    on `device` (None: the CUDA card) as exact integer sums, which equal
    the f32 chains while a window's sum stays below 2**24 (samples of up
    to 14 bits); the rest is a few thousand values, summed on the host."""
    dev = resolve_device(device)
    d = (to_tensor(a, dev).to(torch.int32)
         - to_tensor(b, dev).to(torch.int32)).abs()
    if max(d.shape) > _WINDOW:
        x = _window_view(d.to(torch.int64)).sum(-1).cpu().numpy()
        if x.max() >= 1 << 24:
            x = _chain(_window_view(d.cpu()).numpy())
        while max(x.shape) > _WINDOW:
            x = _chain(_window_view(torch.from_numpy(x)).numpy())
    else:
        x = d.cpu().numpy()
    r = _chain(x if x.shape[0] == 2 else x.reshape(1, -1))
    total = r[0] + r[1] if len(r) == 2 else r[0]
    return float(total * np.float32(1.0 / d.numel()))


def _parse_rate(v, default):
    if v is None:
        return default
    if isinstance(v, Fraction):
        return v
    if isinstance(v, (int, float)):
        return Fraction(v).limit_denominator(1001 * 120)
    num, den = str(v).split("/")
    return Fraction(int(num), int(den))


@register
class VFRFilter(Filter):
    id = S.FILTER_VFR
    name = "vfr"

    def init(self, fi: FilterInit) -> FilterInit:
        s = self.settings
        self.device = fi.device
        self.mode = int(s.get("mode", 0))
        if "rate-num" in s and "rate-den" in s:
            self.rate = Fraction(int(s["rate-num"]), int(s["rate-den"]))
        else:
            self.rate = _parse_rate(s.get("rate"), fi.vrate)
        self.frame_ticks = Fraction(CLOCK, 1) / self.rate
        self.out_pts = None       # next CFR grid position (Fraction)
        self.pending: list = []   # candidate queue (≤2) for drop choice
        self.last_emitted = None
        self.drops = 0
        self.dups = 0
        self.count = 0            # PFR: frames kept
        self.origin = None        # PFR: the first frame's start
        self.last_stop = None     # PFR: the last kept frame's stop
        self.fi = fi.copy()
        self.fi.cfr = self.mode
        if self.mode == 1:
            self.fi.vrate = self.rate
        elif self.mode == 2 and fi.vrate:
            # the frames kept run at the lower of the two rates
            self.fi.vrate = min(fi.vrate, self.rate)
        return self.fi

    def keeps_state(self):
        """Frame-local in VFR mode (it passes every frame on); CFR
        duplicates and drops frames against its grid, and PFR drops a
        frame by how many frames it has kept and re-times each kept frame
        from the last one's stop."""
        if self.mode == 1:
            return "changes the frame count (CFR mode)"
        if self.mode == 2:
            return ("drops and re-times frames by the frames kept before "
                    "(PFR mode)")
        return None

    # -- CFR engine ----------------------------------------------------------
    def _emit_cfr(self, buf: Buffer) -> list:
        out = []
        if self.out_pts is None:
            self.out_pts = Fraction(buf.pts or 0)
        start = Fraction(buf.pts if buf.pts is not None else self.out_pts)
        dur = Fraction(buf.duration or int(self.frame_ticks))
        end = start + dur
        # frame covers no grid point → drop candidate
        if end <= self.out_pts:
            self.pending.append(buf)
            if len(self.pending) >= 2:
                # drop the candidate most similar to its neighbour
                a, b = self.pending[0], self.pending[1]
                ref = (self.last_emitted or a).planes[0]
                ma = motion_metric(ref, a.planes[0], self.device)
                mb = motion_metric(ref, b.planes[0], self.device)
                keep = b if ma <= mb else a
                self.pending = [keep]
                self.drops += 1
            return out
        # a pending candidate competes with buf for this grid point: keep
        # whichever differs more from the last output (drop the redundant
        # one — find_drop_frame vfr.c:133 picks the lowest-metric frame)
        src = buf
        dropped_buf = False
        if self.pending:
            cand = self.pending.pop()
            self.drops += len(self.pending)
            self.pending = []
            ref = (self.last_emitted or cand).planes[0]
            mc = motion_metric(ref, cand.planes[0], self.device)
            mb2 = motion_metric(ref, buf.planes[0], self.device)
            if mc >= mb2:
                src = cand
                dropped_buf = True
            else:
                self.drops += 1
        # emit copies of src (and dup if it spans several grid points)
        while end > self.out_pts:
            ob = Buffer(planes=src.planes,
                        pix_fmt=src.pix_fmt).copy_props(src)
            ob.pts = int(self.out_pts)
            ob.duration = int(self.frame_ticks)
            ob.stop = int(self.out_pts + self.frame_ticks)
            out.append(ob)
            self.out_pts += self.frame_ticks
            if len(out) > 1:
                self.dups += 1
            if src is not buf and end > self.out_pts:
                src = buf  # newest frame takes over remaining grid points
                dropped_buf = False
        if dropped_buf:
            self.drops += 1
        self.last_emitted = out[-1] if out else self.last_emitted
        return out

    def _emit_pfr(self, buf: Buffer) -> list:
        # vfr.c adjust_frame_rate: cfr_stop is where this frame would
        # stop if every frame kept so far had run at the peak rate
        start = buf.pts if buf.pts is not None else (self.last_stop or 0)
        stop = start + (buf.duration or int(self.frame_ticks))
        if self.origin is None:
            self.origin = self.last_stop = start
        cfr_stop = self.origin + self.frame_ticks * (self.count + 1)
        if cfr_stop - stop >= self.frame_ticks:
            # a whole peak frame time or more behind the clock
            self.drops += 1
            return []
        buf.pts = self.last_stop
        buf.stop = stop if stop > cfr_stop else int(cfr_stop)
        buf.duration = buf.stop - buf.pts
        self.count += 1
        self.last_stop = buf.stop
        return [buf]

    def work(self, buf: Buffer) -> list:
        if buf.is_eof():
            return self.flush() + [buf]
        if buf.planes is None:
            return [buf]
        if self.mode == 1:
            return self._emit_cfr(buf)
        if self.mode == 2:
            return self._emit_pfr(buf)
        return [buf]

    def flush(self) -> list:
        out = []
        if self.mode == 1 and self.pending:
            for b in self.pending:
                ob = Buffer(planes=b.planes, pix_fmt=b.pix_fmt).copy_props(b)
                ob.pts = int(self.out_pts)
                ob.duration = int(self.frame_ticks)
                ob.stop = int(self.out_pts + self.frame_ticks)
                out.append(ob)
                self.out_pts += self.frame_ticks
            self.pending = []
        return out
