"""The framerate shaper's motion metric and drop choice held against the
JAX package's on the CPU.

The reference's metric is a jitted f32 ``jnp.mean``: above 2**24 its sum
rounds, so two candidates whose exact sums differ can tie, and the tie
decides which frame the CFR shaper drops.  The port reproduces XLA:CPU's
summation order (``filters/vfr.py`` ``motion_metric``); the metric must
equal the reference's bit for bit, and on a constructed 1920x1080
near-tie the port must drop the frame the reference drops, which is not
the frame the exact sums would drop.
"""
from fractions import Fraction

import numpy as np
import pytest

from handbrake_tpu.core.buffer import Buffer as JBuffer
from handbrake_tpu.core.buffer import Geometry as JGeometry
from handbrake_tpu.core.buffer import YUV420P as J_YUV420P
from handbrake_tpu.filters.base import FilterInit as JFilterInit
from handbrake_tpu.filters.vfr import VFRFilter as JVFR
from handbrake_tpu.filters.vfr import motion_metric as jmetric
from handbrake_tpu_torch.core.buffer import YUV420P, Buffer, Geometry
from handbrake_tpu_torch.filters.base import FilterInit
from handbrake_tpu_torch.filters.vfr import VFRFilter, motion_metric

# (height, width): 1080p, the letterbox job's 804 rows, 2160p, sizes
# whose padding is odd, small planes with and without windows, one row
SHAPES = [(1080, 1920), (804, 1920), (2160, 3840), (1079, 1917), (33, 33),
          (48, 64), (16, 16), (1, 5000), (3100, 64)]


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_motion_metric_equals_reference(shape):
    h, w = shape
    rng = np.random.default_rng(h * 7 + w)
    ref = rng.integers(0, 40, (h, w)).astype(np.uint8)
    a = rng.integers(120, 256, (h, w)).astype(np.uint8)
    assert motion_metric(ref, a, "cpu") == float(jmetric(ref, a))


def test_motion_metric_16bit_equals_reference():
    """Window sums above 2**24 (16-bit samples): the first level is a
    chain of f32 adds too."""
    ref = np.zeros((300, 300), np.uint16)
    a = np.full((300, 300), 60000, np.uint16)
    a[::3] = 61237
    assert motion_metric(ref, a, "cpu") == float(jmetric(ref, a))


def _near_tie():
    """(f0, f1, f2): luma planes where |f1 - f0| sums to one less than
    |f2 - f0| exactly, and the reference's f32 metrics are equal."""
    h, w = 1080, 1920
    rng = np.random.default_rng(11)
    f0 = rng.integers(0, 60, (h, w)).astype(np.uint8)
    f2 = rng.integers(100, 256, (h, w)).astype(np.uint8)
    m2 = float(jmetric(f0, f2))
    for y, x in zip(rng.integers(0, h, 64), rng.integers(0, w, 64)):
        f1 = f2.copy()
        f1[y, x] -= 1              # one step closer to f0 there
        if float(jmetric(f0, f1)) == m2:
            return f0, f1, f2
    raise AssertionError("no near-tie found")


def test_cfr_near_tie_drop_choice_equals_reference():
    f0, f1, f2 = _near_tie()
    exact = [int(np.abs(f.astype(np.int64) - f0).sum()) for f in (f1, f2)]
    assert exact[0] + 1 == exact[1] and exact[0] > 1 << 24
    assert motion_metric(f0, f1, "cpu") == motion_metric(f0, f2, "cpu")
    h, w = f0.shape
    chroma = np.full((h // 2, w // 2), 128, np.uint8)
    frames = [[f, chroma, chroma] for f in (f0, f1, f2)]
    index = {id(f): i for i, f in enumerate(frames)}
    settings = {"mode": 1, "rate": "30000/1001"}
    jf, tf = JVFR(dict(settings)), VFRFilter(dict(settings))
    jf.init(JFilterInit(geometry=JGeometry(w, h), vrate=Fraction(60)))
    tf.init(FilterInit(geometry=Geometry(w, h), vrate=Fraction(60),
                       device="cpu"))
    outs = []
    for f, Buf, fmt in ((jf, JBuffer, J_YUV420P), (tf, Buffer, YUV420P)):
        out = []
        # 60 fps into 29.97 fps: f1 covers no grid point, so it competes
        # with f2 for the second one
        for i, planes in enumerate(frames + [None]):
            buf = (Buf.eof() if planes is None else
                   Buf(planes=planes, pix_fmt=fmt, pts=1500 * i,
                       duration=1500))
            out += [(index[id(b.planes)], b.pts) for b in f.work(buf)
                    if not b.is_eof()]
        outs.append((out, f.drops))
    assert outs[0] == outs[1]
    # the tie keeps f1, the candidate; its smaller exact sum would have
    # dropped it
    assert outs[0][0][:2] == [(0, 0), (1, 3003)]
