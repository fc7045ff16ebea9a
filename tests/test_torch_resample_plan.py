"""The resample kernel's tile plan (``filters/resample_cuda.py`` ``plan``),
on the CPU: for the card checks' geometries (``chip_smoke.py``'s
``RS_CASES``, the letterbox job's luma and chroma), one row, one column,
one sample, 16-bit planes and an 8x down lanczos, each output sample lies
in exactly one tile, each tile's input window holds every tap of its
bands and starts inside the plane on a 16-byte boundary, a block's shared
memory (two ring stages of the window, the tile's taps and band starts;
the f32 tile; the output tile) stays within the H100's 227 KB, and the
16-byte copy and store paths are taken only where the pitch and the base
allow them.
"""
import numpy as np
import pytest

from handbrake_tpu_torch.filters import kernels as K
from handbrake_tpu_torch.filters import resample_cuda as R

# (in_h, in_w, out_h, out_w, horizontal shift, kind, in bytes, out bytes)
GEOMETRIES = {
    "letterbox-luma": (1608, 3840, 804, 1920, 0.0, "lanczos", 1, 1),
    "letterbox-chroma": (804, 1920, 402, 960, -0.25, "lanczos", 1, 1),
    "odd-down": (999, 1777, 541, 1103, -0.25, "lanczos", 1, 1),
    "odd-up": (37, 53, 91, 129, 0.0, "bicubic", 1, 1),
    "1080p-720p": (1080, 1920, 720, 1280, 0.0, "lanczos", 2, 2),
    "one-row": (1, 97, 1, 50, 0.0, "lanczos", 1, 1),
    "one-col": (97, 1, 50, 1, 0.0, "lanczos", 1, 2),
    "one-sample": (1, 1, 3, 2, 0.0, "bilinear", 2, 1),
    "ragged": (517, 1023, 257, 511, 0.0, "lanczos", 2, 2),
    "down8": (2160, 3840, 270, 480, 0.0, "lanczos", 1, 1),
    "up4": (270, 480, 1080, 1920, 0.0, "lanczos", 2, 2),
}


def _plan(name):
    in_h, in_w, out_h, out_w, sh, kind, ib, ob = GEOMETRIES[name]
    lo_v, taps_v = K.resample_band(in_h, out_h, kind)
    lo_h, taps_h = K.resample_band(in_w, out_w, kind, sh, sh)
    return (R.plan(in_h, in_w, lo_v, taps_v.shape[0], lo_h, taps_h.shape[0],
                   ib, ob), lo_v, taps_v.shape[0], lo_h, taps_h.shape[0])


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_tiles_cover_each_output_once(name):
    p, lo_v, _tv, lo_h, _th = _plan(name)
    out_h, out_w = lo_v.size, lo_h.size
    count = np.zeros((out_h, out_w), np.int64)
    for ty in range(p.row0.size):
        for tx in range(p.col0.size):
            count[ty * p.tile_h:(ty + 1) * p.tile_h,
                  tx * p.tile_w:(tx + 1) * p.tile_w] += 1
    assert (count == 1).all()
    assert p.tile_w % 16 == 0 and p.tiles == p.row0.size * p.col0.size


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_windows_hold_every_tap(name):
    in_h, in_w, *_rest, ib, _ob = GEOMETRIES[name]
    p, lo_v, tv, lo_h, th = _plan(name)
    for ty, r0 in enumerate(p.row0):
        lo = lo_v[ty * p.tile_h:(ty + 1) * p.tile_h]
        assert 0 <= r0 <= lo.min() and lo.max() + tv <= r0 + p.win_h
        assert lo.max() + tv <= in_h
    for tx, c0 in enumerate(p.col0):
        lo = lo_h[tx * p.tile_w:(tx + 1) * p.tile_w]
        assert 0 <= c0 <= lo.min() and lo.max() + th <= c0 + p.win_w
        assert lo.max() + th <= in_w and (c0 * ib) % 16 == 0
    assert (p.win_w * ib) % 16 == 0 and p.win_w % 4 == 0
    assert p.win_w <= R.MAX_WIN_W


def test_item_split_by_reciprocal_is_exact():
    """The kernel's vertical pass takes item // groups as
    int((item + 0.5f) * (1.0f / groups)) in f32: exact for every window
    the plan allows (up to MAX_WIN_W / 4 groups, items up to 16 rows)."""
    for groups in range(1, R.MAX_WIN_W // 4 + 1):
        inv = np.float32(1.0) / np.float32(groups)
        items = np.arange(16 * groups, dtype=np.int64)
        q = ((items.astype(np.float32) + np.float32(0.5)) * inv).astype(
            np.int64)
        assert np.array_equal(q, items // groups), groups


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_shared_memory_fits(name):
    p, _lo_v, tv, _lo_h, th = _plan(name)
    assert p.smem <= R.SMEM_LIMIT == 232448
    stage = (p.win_h * p.win_w * p.in_bytes
             + 4 * (tv * p.tile_h + th * p.tile_w + p.tile_h + p.tile_w))
    assert p.stage_bytes % 16 == 0 and 0 <= p.stage_bytes - stage < 16
    assert p.smem == (2 * p.stage_bytes + 4 * p.tile_h * p.win_w
                      + p.tile_h * p.tile_w * p.out_bytes)


def test_main_path_tile_shares_an_sm():
    """Job (a)'s planes take the first tile, and two blocks fit an SM."""
    for name in ("letterbox-luma", "letterbox-chroma"):
        p = _plan(name)[0]
        assert (p.tile_h, p.tile_w) == R.TILES[0]
        assert p.smem <= R.SMEM_SHARED
    frame = R.smem_bytes([_plan("letterbox-luma")[0],
                          _plan("letterbox-chroma")[0]])
    assert 2 * frame <= 228 * 1024


def test_plan_shrinks_tiles_and_refuses_what_none_holds():
    p = _plan("down8")[0]
    assert (p.tile_h, p.tile_w) != R.TILES[0]
    # a band of 4,000 taps: no tile's window fits
    lo_v, taps_v = K.resample_band(8000, 2)
    lo_h, taps_h = K.resample_band(8000, 2)
    with pytest.raises(ValueError, match="no tile fits"):
        R.plan(8000, 8000, lo_v, taps_v.shape[0], lo_h, taps_h.shape[0], 1,
               1)


@pytest.mark.parametrize("ptr,width,size,want", [
    (0x7f0000000000, 3840, 1, True), (0x7f0000000000, 1920, 2, True),
    (0x7f0000000008, 3840, 1, False), (0x7f0000000001, 64, 1, False),
    (0x7f0000000000, 1777, 1, False), (0x7f0000000000, 97, 2, False),
    (0x7f0000000000, 8, 2, True), (0x7f0000000000, 1, 1, False)])
def test_vector_path_needs_aligned_pitch_and_base(ptr, width, size, want):
    assert R.vector_path(ptr, width, size) is want
