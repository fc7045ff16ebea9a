"""HQDN3D denoise (reference: denoise.c, avfilter alias of FFmpeg hqdn3d) —
the counterpart of ``handbrake_tpu/filters/denoise.py``.

Classic 3-pass IIR denoiser: horizontal low-pass, vertical low-pass,
temporal low-pass against the stored filtered previous frame. The low-pass
is the published hqdn3d curve out = cur + simil^gamma * (prev - cur) with
gamma = ln(0.25)/ln(1 - strength/255*0.98), in float32 as the reference
computes it.

Each spatial pass is a nonlinear recurrence along its axis, with no
parallel-scan form.  On the card a frame is one call of the hand-written
kernel ``csrc/hqdn3d.cu`` (``hqdn3d_cuda.py``): in each block one warp
runs a pass's recurrence for 32 rows (then 32 columns) on samples staged
through shared memory, and other warps load, store, and run the temporal
pass, the rescale, the rounding and the new f32 state.
``hqdn3d_plane`` is its plain version: a Python loop over columns, then
rows, each step a vector operation.  A plane on the CPU takes the plain
version; on the card the kernel, with no fallback.
"""
from __future__ import annotations

import math

import torch

from ..core.buffer import Buffer
from ..job import schema as S
from ..utils.device import resolve_device
from . import hqdn3d_cuda
from .base import Filter, FilterInit, register
from .kernels import out_dtype, to_tensor


def _gamma(strength: float) -> float:
    if strength <= 0:
        return 0.0
    s = min(strength, 252.0)
    return math.log(0.25) / math.log(1.0 - s / 255.0 * 0.98 - 1e-5)


def _lowpass(prev, cur, gamma: float, k255: torch.Tensor):
    """cur + max(0, 1 - |prev - cur| / 255)^gamma * (prev - cur), one f32
    operation at a time (k255: 255.0 as a 0-dim tensor, so the division
    is a true one on every device)."""
    d = prev - cur
    simil = torch.clamp_min(1.0 - torch.abs(d) / k255, 0.0)
    return cur + torch.pow(simil, gamma) * d


def hqdn3d_plane(cur: torch.Tensor, frame_ant: torch.Tensor, g_sp: float,
                 g_tmp: float, maxval: int = 255):
    """The plain version.  cur: (H, W) integer tensor; frame_ant: (H, W)
    float32 filtered previous (or the scaled cur on the first frame).
    Returns (out_plane, new_frame_ant) on cur's device."""
    x = cur.to(torch.float32) * (255.0 / maxval)
    k255 = torch.full((), 255.0, device=x.device)
    if g_sp > 0.0:
        xt = x.T.contiguous()                # columns as rows
        for j in range(1, xt.shape[0]):
            xt[j] = _lowpass(xt[j - 1], xt[j], g_sp, k255)
        x = xt.T.contiguous()
        for i in range(1, x.shape[0]):
            x[i] = _lowpass(x[i - 1], x[i], g_sp, k255)
    if g_tmp > 0.0:
        x = _lowpass(frame_ant, x, g_tmp, k255)
    out = torch.clamp(torch.round(x * (maxval / 255.0)), 0, maxval)
    return out.to(out_dtype(maxval)), x


def hqdn3d_frame(planes, ants, g_sp, g_tmp, maxval: int) -> list:
    """All planes of a frame: [(out, new_ant)] per plane.  CPU planes take
    the plain version; CUDA planes one launch of the kernel."""
    dev = planes[0].device
    if dev.type == "cpu":
        return [hqdn3d_plane(p, a, gs, gt, maxval)
                for p, a, gs, gt in zip(planes, ants, g_sp, g_tmp)]
    return hqdn3d_cuda.hqdn3d_cuda(planes, ants, g_sp, g_tmp, maxval)


@register
class DenoiseFilter(Filter):
    id = S.FILTER_DENOISE
    name = "hqdn3d"
    state = "keeps state across frames (its temporal low-pass)"

    def init(self, fi: FilterInit) -> FilterInit:
        s = self.settings
        ys = float(s.get("y_spatial", 4.0))
        cs = float(s.get("cb_spatial", 0.75 * ys))
        crs = float(s.get("cr_spatial", cs))
        yt = float(s.get("y_temporal", 6.0 * ys / 4.0))
        ct = float(s.get("cb_temporal", yt * cs / max(ys, 1e-9)))
        crt = float(s.get("cr_temporal", ct))
        self.g_sp = [_gamma(v) for v in (ys, cs, crs)]
        self.g_tmp = [_gamma(v) for v in (yt, ct, crt)]
        self.ant = [None, None, None]
        self.maxval = (1 << fi.pix_fmt.bit_depth) - 1
        self.device = resolve_device(fi.device)
        self.fi = fi.copy()
        return self.fi

    def work(self, buf: Buffer) -> list:
        if buf.is_eof() or buf.planes is None:
            return [buf]
        planes = [to_tensor(p, self.device) for p in buf.planes]
        ants = [a if a is not None else
                p.to(torch.float32) * (255.0 / self.maxval)
                for p, a in zip(planes, self.ant)]
        res = hqdn3d_frame(planes, ants, self.g_sp, self.g_tmp, self.maxval)
        self.ant = [a for _, a in res]
        return [Buffer(planes=[o for o, _ in res],
                       pix_fmt=buf.pix_fmt).copy_props(buf)]
