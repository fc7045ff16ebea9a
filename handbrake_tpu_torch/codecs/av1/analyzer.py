"""AV1 P-frame motion search as torch ops — the counterpart of
``handbrake_tpu/codecs/av1/encoder_tpu.py`` (``build_me``).

For each 16x16 block: the SAD against every full-pel shift of the
sr-edge-padded reference, (2 sr + 1)^2 shifts with dy outer, plus
4 * (|dx| + |dy|); the first minimum, as ``jnp.argmin`` takes it.  The
shifts are views of the padded reference (``unfold``); a pass takes a
chunk of dy rows, SHIFT_ELEMS samples of differences at most, so 1080p's
289 shifts run in 6 passes.  Samples and differences are int16 and sums
int32, so the card, the CPU and the reference give the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..hevc.analyzer import edge_pad
from ...utils.device import resolve_device

SHIFT_ELEMS = 1 << 27     # difference samples per pass (256 MiB of int16)

calls = 0                 # search calls, read around a job by the smoke run


def motion_search(cur: torch.Tensor, ref: torch.Tensor, sr: int):
    """cur, ref: (16 rows, 16 cols) luma planes (any integer dtype) on one
    device.  Returns (mvx, mvy, sad), each (rows, cols) int32 on that
    device: the best full-pel vector of each block and its cost (SAD
    plus the vector's penalty)."""
    global calls
    calls += 1
    h, w = cur.shape
    rows, cols = h // 16, w // 16
    side = 2 * sr + 1
    cur = cur.to(torch.int16)
    win = edge_pad(ref.to(torch.int16), sr).unfold(0, h, 1).unfold(
        1, w, 1)                                    # (side, side, h, w)
    step = max(1, SHIFT_ELEMS // (side * h * w))
    costs = []
    for i in range(0, side, step):
        k = min(side, i + step) - i
        d = (cur - win[i:i + k]).abs_()
        costs.append(d.reshape(k * side, rows, 16, cols, 16).sum(
            (2, 4), dtype=torch.int32))
    d = torch.arange(-sr, sr + 1, device=cur.device, dtype=torch.int32)
    pen = 4 * (d.abs()[:, None] + d.abs()[None, :]).reshape(-1, 1, 1)
    c = torch.cat(costs) + pen                      # (side^2, rows, cols)
    best = torch.argmin(c, dim=0)
    sad = c.gather(0, best[None])[0]
    mvx = (best % side - sr).to(torch.int32)
    mvy = (best // side - sr).to(torch.int32)
    return mvx, mvy, sad


def build_me(rows: int, cols: int, sr: int, device=None):
    """f(cur_y, ref_y) -> (mvx, mvy, sad), each (rows, cols) int32 numpy,
    searched on `device` (None: the CUDA card)."""
    dev = resolve_device(device)

    def run(cur, ref):
        assert cur.shape == ref.shape == (rows * 16, cols * 16)
        c = torch.from_numpy(np.ascontiguousarray(cur)).to(dev)
        r = torch.from_numpy(np.ascontiguousarray(ref)).to(dev)
        return tuple(t.cpu().numpy() for t in motion_search(c, r, sr))

    return run
