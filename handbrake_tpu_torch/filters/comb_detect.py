"""Interlacing detection (reference: comb_detect.c) — the counterpart of
``handbrake_tpu/filters/comb_detect.py``.

Per-pixel combing evidence on the luma plane, motion-gated against the
previous frame, accumulated over block_width x block_height tiles; a frame
is tagged combed (buf.combed: 0 none / 1 light / 2 heavy, the s.combed
analog internal.h:110-113) when any block exceeds block_thresh.  The mask
stays on the filter's device as ``side_data["comb_mask"]`` for decomb.

spatial_metric: 0 = sign test (up-cur)(down-cur) > T^2,
2 = 5-tap filtered metric (the reference's default "filtered combing").
"""
from __future__ import annotations

import torch

from ..core.buffer import Buffer
from ..job import schema as S
from ..utils.device import resolve_device
from .base import Filter, FilterInit, register
from .kernels import rows as _rows
from .kernels import to_int32

COMBED_NONE = 0
COMBED_LIGHT = 1
COMBED_HEAVY = 2


def comb_mask_and_blocks(cur, prev, spatial_metric: int = 2,
                         spatial_thresh: int = 3, motion_thresh: int = 1,
                         block_w: int = 16, block_h: int = 16):
    """cur/prev: int32 (H, W) luma tensors.  Returns (mask uint8 HxW,
    block_scores (H//bh, W//bw) int32)."""
    c = cur
    up, down = _rows(c, -1), _rows(c, 1)
    if spatial_metric == 0:
        comb = ((up - c) * (down - c)) > (spatial_thresh * spatial_thresh)
    else:
        up2, down2 = _rows(c, -2), _rows(c, 2)
        # 5-tap vertical high-pass; strong response = alternating fields
        val = torch.abs(up2 - 4 * up + 6 * c - 4 * down + down2)
        comb = val > (6 * spatial_thresh)
        comb = comb & (((up - c) * (down - c)) > 0)
    motion = torch.abs(c - prev) > motion_thresh
    mask = (comb & motion).to(torch.uint8)
    h, w = cur.shape
    bh, bw = h // block_h, w // block_w
    blocks = mask[:bh * block_h, :bw * block_w].to(torch.int32)
    blocks = blocks.reshape(bh, block_h, bw, block_w).sum((1, 3),
                                                          dtype=torch.int32)
    return mask, blocks


@register
class CombDetectFilter(Filter):
    id = S.FILTER_COMB_DETECT
    name = "comb_detect"
    state = ("keeps state across frames (each frame is measured against "
             "the one before)")

    def init(self, fi: FilterInit) -> FilterInit:
        s = self.settings
        self.spatial_metric = int(s.get("spatial_metric", 2))
        self.spatial_thresh = int(s.get("spatial_thresh", 3))
        self.motion_thresh = int(s.get("motion_thresh", 1))
        self.block_thresh = int(s.get("block_thresh", 40))
        self.block_w = int(s.get("block_width", 16))
        self.block_h = int(s.get("block_height", 16))
        self.force = int(s.get("force_analysis", 0))
        self.device = resolve_device(fi.device)
        self.prev = None
        self.fi = fi.copy()
        return self.fi

    def work(self, buf: Buffer) -> list:
        if buf.is_eof() or buf.planes is None:
            return [buf]
        # progressive-flagged content is analysed too (the reference
        # checks everything unless told otherwise)
        y = to_int32(buf.planes[0], self.device)
        prev = self.prev if self.prev is not None else y
        mask, blocks = comb_mask_and_blocks(
            y, prev, spatial_metric=self.spatial_metric,
            spatial_thresh=self.spatial_thresh,
            motion_thresh=self.motion_thresh,
            block_w=self.block_w, block_h=self.block_h)
        self.prev = y
        peak, total = (int(v) for v in torch.stack(
            [blocks.max(), blocks.sum(dtype=torch.int32)]).cpu())
        if peak > self.block_thresh:
            buf.combed = COMBED_HEAVY
        elif total > self.block_thresh:
            buf.combed = COMBED_LIGHT
        else:
            buf.combed = COMBED_NONE
        buf.side_data["comb_mask"] = mask
        return [buf]
