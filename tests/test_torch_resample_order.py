"""The order in which XLA:CPU sums the reference's two resample products
(``handbrake_tpu/filters/kernels.py`` ``_apply_separable``), mapped, and
the port's rule for it (``filters/kernels.py`` ``vertical_order``,
``horizontal_order``) held to it.

- The map: each product ``einsum("oh,hw->ow")`` (vertical) and
  ``einsum("ow,cw->oc")`` (horizontal) on random f32 data, at the test
  shapes of ``tests/test_torch_resample.py``, the crop/scale geometries of
  the presets (1080p to 720p, 2160p to 1080p, the letterbox job's
  3840x1608 to 1920x804, each with its 4:2:0 chroma) and shapes that
  show each lane count, block and tail, against the rule emulated in
  numpy with exact f32 fmas, on a seeded sample of output rows.  Each
  case prints its shape, the rule (lanes, block, main) and the share of
  outputs that differ from the rule and from the plain ascending chain.
- The bands: the port's ``_band_pass`` in that order on real bands at the
  preset geometries, 8 and 10 bits, pass by pass against XLA's products
  and the JAX package's ``_apply_separable``, bit for bit, on the rows
  whose vertical band crosses a block and a seeded sample of the rest.

From 51 output rows on, the vertical product takes the horizontal
product's kernels by the plane's width, which covers a plane whose width
is not a multiple of 64 (999x1777 to 541 rows, the DVD upscales) and a
plane under 64 wide (the chroma of a small source upscaled); the 50/51-row
boundary is held at widths 20, 30, 40, 720 and 1777 and at 240 to 4500
input rows.  With fewer rows, a plane wider than 64 is cut into column
tiles of 128 or 64 by the size of its panels (``FEW_ROWS_SHAPES``, both
sides of the cut).  A product with one output row has its own order:
one fma chain if vertical (``ONE_ROW_SHAPES``), a matrix-vector kernel in
eight lanes if horizontal (``GEMV_SHAPES``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handbrake_tpu.filters import kernels as jk
from handbrake_tpu_torch.filters import kernels as tk

_vertical = jax.jit(lambda a, x: jnp.einsum("oh,hw->ow", a, x))
_horizontal = jax.jit(lambda x, a: jnp.einsum("ow,cw->oc", x, a))


def fma32(a, b, c):
    """f32 a * b + c rounded once, from float64 (a * b is exact there;
    the error of the f64 sum decides the halfway cases)."""
    p = a.astype(np.float64) * b.astype(np.float64)
    cd = c.astype(np.float64)
    s = p + cd
    bb = s - p
    e = (p - (s - bb)) + (cd - bb)
    r = s.astype(np.float32)
    d = s - r.astype(np.float64)
    r2 = r.astype(np.float64) + 2.0 * d
    mid = (d != 0) & (r2.astype(np.float32).astype(np.float64) == r2)
    up = mid & (e != 0) & ((e > 0) == (d > 0))
    return np.where(up, r2.astype(np.float32), r)


def _lanes_added(acc, split):
    """The lanes added as neighbours, (l0 + l1) + (l2 + l3), and in the
    columns from split on as halves, (l0 + l2) + (l1 + l3)."""
    near, half = list(acc), list(acc)
    while len(near) > 1:
        near = [near[i] + near[i + 1] for i in range(0, len(near), 2)]
        h = len(half) // 2
        half = [half[i] + half[i + h] for i in range(h)]
    return np.concatenate([near[0][:, :split], half[0][:, split:]], axis=1)


def ordered_dot(x, a, lanes, block, main, split=None, tail_fma=False):
    """x (m, K) times a (n, K)^T in the rule's order: blocks of K from 0,
    lane k mod lanes as fma chains, added as neighbours (the columns from
    split on as halves), the blocks added in order, then the tail from
    main on (products rounded, added in order from 0; an fma chain where
    tail_fma)."""
    m, k_all = x.shape
    out = np.zeros((m, a.shape[0]), np.float32)
    split = a.shape[0] if split is None else split
    for b0 in range(0, main, block):
        acc = [np.zeros_like(out) for _ in range(lanes)]
        for k in range(b0, min(b0 + block, main)):
            acc[k % lanes] = fma32(x[:, k, None], a[None, :, k],
                                   acc[k % lanes])
        out = out + _lanes_added(acc, split)
    tail = np.zeros_like(out)
    for k in range(main, k_all):
        tail = (fma32(x[:, k, None], a[None, :, k], tail) if tail_fma else
                (x[:, k, None] * a[None, :, k]).astype(np.float32) + tail)
    return out + tail


def chain_dot(x, a):
    return ordered_dot(x, a, 1, x.shape[1], x.shape[1])


# (pass, out rows M, terms K, columns N): the vertical product is
# av (M, K) @ plane (K, N = the plane's width); the horizontal one is
# mid (M, K = the plane's width) @ ah (N = the output width, K)^T
TEST_SHAPES = [("v", 24, 48, 64), ("h", 24, 64, 32), ("v", 32, 45, 61),
               ("h", 32, 61, 40), ("v", 40, 24, 32), ("h", 40, 32, 56),
               ("v", 108, 216, 384), ("h", 108, 384, 192)]
PRESET_SHAPES = [("v", 720, 1080, 1920), ("h", 720, 1920, 1280),
                 ("v", 360, 540, 960), ("h", 360, 960, 640),
                 ("v", 1080, 2160, 3840), ("h", 1080, 3840, 1920),
                 ("v", 540, 1080, 1920), ("h", 540, 1920, 960),
                 ("v", 804, 1608, 3840), ("h", 804, 3840, 1920),
                 ("v", 402, 804, 1920), ("h", 402, 1920, 960)]
# lanes 2 and 4, blocks of 2048 and 4096 with a tail, narrow planes, a
# narrow last column tile, few output rows, and a vertical product with
# many output rows on a plane whose width is not a multiple of 64: wide,
# and under 64 wide (20, 30 and 40: four, two and four lanes, where the
# tile rule of fewer rows keeps one), on both sides of 51 output rows
RULE_SHAPES = [("h", 8, 3001, 20), ("h", 8, 2051, 40), ("h", 6, 2050, 88),
               ("h", 4, 1777, 1103), ("h", 3, 600, 12), ("h", 2, 97, 50),
               ("v", 6, 1203, 12), ("v", 4, 1100, 40), ("v", 8, 1100, 80),
               ("v", 8, 1030, 129), ("v", 100, 900, 128),
               ("v", 541, 999, 1777), ("v", 51, 480, 720),
               ("v", 300, 1500, 84), ("v", 50, 1500, 720),
               ("v", 51, 240, 20), ("v", 100, 480, 30), ("v", 540, 240, 40),
               ("v", 51, 4500, 30), ("v", 51, 1500, 40),
               ("v", 51, 480, 1777), ("v", 51, 2100, 720),
               ("v", 50, 240, 20), ("v", 50, 4500, 30), ("v", 50, 1500, 40)]
# the DVD upscales to 1080p: 720x480 to 1440x1080 and 720x576 to
# 1920x1080, with their 4:2:0 chroma
DVD_SHAPES = [("v", 1080, 480, 720), ("h", 1080, 720, 1440),
              ("v", 540, 240, 360), ("h", 540, 360, 720),
              ("v", 1080, 576, 720), ("h", 1080, 720, 1920),
              ("v", 540, 288, 360), ("h", 540, 360, 960)]
# a vertical product with few output rows (up to 50) on a plane wider
# than 64: tiles of 128 columns where n_in x (the rows, rounded up to 32
# or 64 past 16, + 64) f32 stay below 65536, wider ones (256, 512, 1024)
# where n_in x (rows + half the tile) do, else of 64, each with a narrower
# last tile (one of up to 8 columns of 2 to 4 rows rounds each product);
# the six shapes PR 8 left open, both sides of the fit at 2, 8, 9, 16,
# 17, 30, 40 and 50 rows, tiles of 256 to 1024, and last tiles of 1 to 12
FEW_ROWS_SHAPES = [("v", 8, 900, 80), ("v", 2, 600, 129), ("v", 8, 540, 960),
                   ("v", 50, 480, 720), ("v", 50, 480, 1777),
                   ("v", 8, 910, 80), ("v", 8, 911, 80), ("v", 2, 992, 80),
                   ("v", 2, 993, 80), ("v", 9, 897, 80), ("v", 9, 898, 80),
                   ("v", 16, 819, 80), ("v", 16, 820, 80),
                   ("v", 17, 682, 300), ("v", 17, 683, 300),
                   ("v", 30, 682, 129), ("v", 30, 683, 129),
                   ("v", 40, 512, 200), ("v", 40, 514, 200),
                   ("v", 50, 512, 80), ("v", 50, 514, 80),
                   ("v", 8, 500, 140), ("v", 8, 700, 200),
                   ("v", 2, 990, 133), ("v", 8, 600, 137), ("v", 8, 600, 264),
                   ("v", 2, 300, 300), ("v", 3, 100, 1500), ("v", 8, 200, 600),
                   ("v", 2, 250, 520), ("v", 2, 300, 130), ("v", 2, 300, 257),
                   ("v", 4, 300, 520), ("v", 5, 300, 520), ("v", 2, 1100, 65),
                   ("v", 3, 1100, 70), ("v", 4, 1100, 72), ("v", 2, 700, 100)]
# a vertical product with one output row: one fma chain
ONE_ROW_SHAPES = [("v", 1, 1500, 300), ("v", 1, 300, 12), ("v", 1, 40, 20)]
# a horizontal product with one output row (a matrix-vector product):
# eight lanes, no blocks, the last n_out % 8 columns adding them as halves
GEMV_SHAPES = [("h", 1, 97, 50), ("h", 1, 97, 4), ("h", 1, 97, 8),
               ("h", 1, 101, 127), ("h", 1, 2100, 50), ("h", 1, 5003, 20),
               ("h", 1, 300, 1281)]


def _map_case(which, m, k, n, seed):
    rng = np.random.default_rng(seed)
    if which == "v":
        a = rng.standard_normal((m, k)).astype(np.float32)
        x = rng.standard_normal((k, n)).astype(np.float32)
        want = np.asarray(_vertical(a, x))
        rows = np.sort(rng.choice(m, min(m, 2), replace=False))
        got, chain, rule = np.zeros((rows.size, n), np.float32), None, []
        for c0, c1, lanes, block, main in tk.vertical_order(k, n, m):
            got[:, c0:c1] = ordered_dot(a[rows], x[:, c0:c1].T, lanes,
                                        block, main)
            rule.append((c0, c1, lanes, block, main))
        chain = chain_dot(a[rows], x.T)
    else:
        x = rng.standard_normal((m, k)).astype(np.float32)
        a = rng.standard_normal((n, k)).astype(np.float32)
        want = np.asarray(_horizontal(x, a))
        rows = np.sort(rng.choice(m, min(m, 2), replace=False))
        rule = tk.horizontal_order(k, n, m)
        got = ordered_dot(x[rows], a, *rule)
        chain = chain_dot(x[rows], a)
    want = want[rows]
    share = float((got != want).mean())
    chain_share = float((chain != want).mean())
    print(f"order map: {which} M={m} K={k} N={n}: rule {rule}; outputs "
          f"that differ from XLA's: the rule {share:.4g}, the ascending "
          f"chain {chain_share:.4g}")
    return share


@pytest.mark.parametrize("which,m,k,n", TEST_SHAPES + PRESET_SHAPES
                         + RULE_SHAPES + DVD_SHAPES + FEW_ROWS_SHAPES
                         + ONE_ROW_SHAPES + GEMV_SHAPES)
def test_xla_order_map(which, m, k, n):
    assert _map_case(which, m, k, n, m * 131 + k * 7 + n) == 0.0


# crop/scale geometries (in_h, in_w, out_h, out_w) of the presets, luma
# and 4:2:0 chroma (left-sited: the horizontal shift -0.25)
GEOMETRIES = {"1080p-720p-luma": (1080, 1920, 720, 1280, 0.0),
              "1080p-720p-chroma": (540, 960, 360, 640, -0.25),
              "2160p-1080p-luma": (2160, 3840, 1080, 1920, 0.0),
              "2160p-1080p-chroma": (1080, 1920, 540, 960, -0.25),
              "letterbox-luma": (1608, 3840, 804, 1920, 0.0),
              "letterbox-chroma": (804, 1920, 402, 960, -0.25),
              "ntsc-dvd-1080p-luma": (480, 720, 1080, 1440, 0.0),
              "ntsc-dvd-1080p-chroma": (240, 360, 540, 720, -0.25),
              "pal-dvd-1080p-luma": (576, 720, 1080, 1920, 0.0),
              "pal-dvd-1080p-chroma": (288, 360, 540, 960, -0.25),
              "40x30-to-320x240-luma": (30, 40, 240, 320, 0.0),
              "40x30-to-320x240-chroma": (15, 20, 120, 160, -0.25),
              "60x46-to-320x240-chroma": (23, 30, 120, 160, -0.25)}


def _plane(h, w, bits, seed):
    mx = (1 << bits) - 1
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = mx / 2 * (1 + np.sin(xx / 9.0) * np.cos(yy / 11.0))
    return np.clip(smooth + rng.normal(0, mx / 12, smooth.shape), 0,
                   mx).astype(np.uint8 if bits == 8 else np.uint16)


@pytest.mark.parametrize("bits", [8, 10])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_band_passes_equal_xla(geometry, bits):
    in_h, in_w, out_h, out_w, sh = GEOMETRIES[geometry]
    mx = (1 << bits) - 1
    plane = _plane(in_h, in_w, bits, in_h + out_w + bits)
    av = jk.resample_matrix(in_h, out_h, "lanczos")
    ah = jk.resample_matrix(in_w, out_w, "lanczos", sh, sh)
    lo_v, taps_v = tk.resample_band(in_h, out_h)
    lo_h, taps_h = tk.resample_band(in_w, out_w, "lanczos", sh, sh)
    # the rows whose vertical band crosses a block of the vertical order,
    # and a seeded sample of the others
    blocks = {b for *_c, _l, b, _m in tk.vertical_order(in_h, in_w, out_h)}
    cross = [o for o in range(out_h) for b in blocks
             if lo_v[o] // b != (lo_v[o] + taps_v.shape[0] - 1) // b]
    rng = np.random.default_rng(bits)
    rows = np.unique(np.concatenate([np.asarray(cross, np.int64),
                                     rng.choice(out_h, 12, replace=False)]))
    x = torch.from_numpy(plane.astype(np.float32))
    lo_s = torch.from_numpy(lo_v[rows])
    taps_s = torch.from_numpy(np.ascontiguousarray(taps_v[:, rows]))
    p1 = torch.cat([tk._band_pass(x[:, c0:c1], lo_s, taps_s, (ln, b, mn))
                    for c0, c1, ln, b, mn
                    in tk.vertical_order(in_h, in_w, out_h)],
                   dim=1).numpy()
    want1 = np.asarray(_vertical(av, plane.astype(np.float32)))
    assert np.array_equal(p1.view(np.uint32), want1[rows].view(np.uint32))
    p2 = tk._band_pass(torch.from_numpy(p1.T.copy()),
                       torch.from_numpy(lo_h), torch.from_numpy(taps_h),
                       tk.horizontal_order(in_w, out_w)).T.numpy()
    want2 = np.asarray(_horizontal(want1, ah))
    assert np.array_equal(p2.view(np.uint32), want2[rows].view(np.uint32))
    got = np.clip(np.round(p2), 0, mx)
    want = np.asarray(jk.resample_plane(plane, out_h, out_w, "lanczos",
                                        (0.0, sh), (0.0, sh), mx))
    assert np.array_equal(got, want[rows].astype(np.float32))
    print(f"bands {geometry} {bits}-bit: {rows.size} rows ({len(cross)} "
          f"crossing a block of {sorted(blocks)}), both passes and the "
          f"output equal to XLA's")
