"""The port's P-frame analyzer (handbrake_tpu_torch.codecs.h264.analyzer)
held against the JAX package's encoder_tpu.build_p_analyzer_fn on the
JAX CPU backend (where the chained deblock is deblock_tpu's scan).

Every output key must be equal: same dtype, same shape, same values.
The comparison is exact, the f32 spots included (8x8 forward quant,
RDO cost, exp2-derived constants)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handbrake_tpu.codecs.h264 import encoder_tpu as J
from handbrake_tpu_torch.codecs.h264 import analyzer as A


def _frames(seed, mb_w, mb_h, kind):
    """(src_y, src_u, src_v, ref_y, ref_u, ref_v) uint8 planes.

    kind: "nat" — shifted textured content (motion + noise); "flat" — two
    nearly flat frames, where most candidate SADs tie; "cut" — a noise
    source against a smooth reference, so most MBs exceed the intra
    threshold (n_intra > 0)."""
    rng = np.random.default_rng(seed)
    H, W = mb_h * 16, mb_w * 16
    yy, xx = np.mgrid[0:H + 64, 0:W + 64]
    base = np.clip(96 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
                   + rng.normal(0, 4, xx.shape), 0, 255).astype(np.uint8)
    ref = base[8:8 + H, 8:8 + W]
    src = base[10:10 + H, 13:13 + W]
    if kind == "flat":
        ref = np.full((H, W), 100, np.uint8)
        src = np.full((H, W), 101, np.uint8)
        src[:, ::7] = 99
    elif kind == "cut":
        src = rng.integers(0, 256, (H, W)).astype(np.uint8)
    chroma = [np.clip(128 + 30 * np.sin(xx[::2, ::2][o:o + H // 2,
                                                     o:o + W // 2] / 5.0)
                      + rng.normal(0, 3, (H // 2, W // 2)), 0,
                      255).astype(np.uint8) for o in (4, 5, 6, 7)]
    return src, chroma[0], chroma[1], ref, chroma[2], chroma[3]


def _assert_same(got, want, key):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
    assert got.shape == want.shape, (key, got.shape, want.shape)
    assert np.array_equal(got, want), (key, int((got != want).sum()))


def _assert_outputs(to, jo):
    assert set(to) == set(jo)
    for k in jo:
        if k in ("payload", "payload_nib"):
            assert len(to[k]) == len(jo[k])
            for c, (a, b) in enumerate(zip(to[k], jo[k])):
                _assert_same(a, b, f"{k}[{c}]")
        else:
            _assert_same(to[k], jo[k], k)


# (mb_w, mb_h, qp, deblock, transform8x8, kind)
CASES = [(6, 4, 30, True, True, "nat"),
         (5, 3, 22, False, True, "nat"),
         (7, 5, 38, True, False, "nat"),
         (4, 6, 45, False, False, "nat"),
         (6, 4, 26, True, True, "flat"),
         (6, 4, 30, True, True, "cut")]


@pytest.mark.parametrize("mb_w,mb_h,qp,deblock,t8,kind", CASES)
def test_analyzer_matches_jax(mb_w, mb_h, qp, deblock, t8, kind):
    qpc = min(51, qp - 2)
    planes = _frames(mb_w * 100 + qp, mb_w, mb_h, kind)
    jo = jax.jit(J.build_p_analyzer_fn(mb_w, mb_h, deblock=deblock,
                                       transform8x8=t8))(
        *(jnp.asarray(p) for p in planes), qp, qpc)
    to = A.build_p_analyzer_fn(mb_w, mb_h, deblock=deblock,
                               transform8x8=t8)(
        *(torch.from_numpy(p) for p in planes), qp, qpc)
    _assert_outputs(to, jo)
    n_intra = int(to["n_intra"])
    if kind == "cut":
        assert n_intra > 0
    if kind == "flat":
        # tie-heavy: many candidates share the best quarter-pel SAD
        assert int((to["sad"] == to["sad"][0]).sum()) > mb_w * mb_h // 2
    if (mb_w, qp, kind) == (6, 30, "nat"):
        assert int(to["t8"].sum()) > 0      # the 8x8 choice fires


def test_batched_analyzer_matches_per_frame_loop():
    """The batched form chains the recon on the device: frame k's
    reference is frame k-1's (deblocked) recon, as in a loop of the
    single-frame analyzer; a partial batch runs its own frames only."""
    mb_w, mb_h, qp, qpc = 5, 4, 28, 27
    H, W = mb_h * 16, mb_w * 16
    frames = [_frames(s, mb_w, mb_h, "nat") for s in range(3)]
    packed = torch.from_numpy(np.stack([
        np.concatenate([p.ravel() for p in f[:3]]) for f in frames]))
    refs = tuple(torch.from_numpy(p) for p in frames[0][3:])
    batch = A.build_p_analyzer_batch(mb_w, mb_h, 4, deblock=True,
                                     transform8x8=True)
    outs = batch(packed, *refs, qp, qpc)
    one = A.build_p_analyzer(mb_w, mb_h, deblock=True, transform8x8=True)
    r = refs
    for k in range(3):
        d = one(packed[k], *r, qp, qpc)
        for key, val in d.items():
            want = torch.stack(val) if isinstance(val, list) else val
            assert torch.equal(outs[key][k], want), (k, key)
        r = (d["recon_y"], d["urec"], d["vrec"])
    for key, want in zip(("carry_y", "carry_u", "carry_v"), r):
        assert torch.equal(outs[key], want)
    assert outs["recon_y"].shape == (3, H, W)
    with pytest.raises(ValueError):
        batch(packed.repeat(2, 1), *refs, qp, qpc)


def test_fquant8x8_matches_jax_f32():
    """The 8x8 forward quant is f32 (transform, divide, floor): one
    rounding difference is a different level.  1e5 random residual
    blocks (half of them small, as real residuals are) at five qps."""
    rng = np.random.default_rng(7)
    n = 25_000                                  # x 4 quads = 1e5 blocks
    res = rng.integers(-255, 256, (n, 4, 8, 8)).astype(np.int32)
    res[:n // 2] = rng.integers(-20, 21, (n // 2, 4, 8, 8))
    C = A._consts(torch.device("cpu"))
    fq = jax.jit(J._fquant8x8_t)
    for qp in (0, 17, 27, 36, 51):
        want = np.asarray(fq(jnp.asarray(res), qp))
        got = A._fquant8x8(torch.from_numpy(res), qp, C).numpy()
        assert np.array_equal(got, want), (qp, int((got != want).sum()))


def test_exp2_tables_match_jax():
    """intra_thresh_for_qp and the RDO lambda come from f32 exp2 in the
    reference; the port keeps them as typed-in 52-entry tables."""
    qps = jnp.arange(52, dtype=jnp.int32)
    thresh = np.asarray(jax.jit(jax.vmap(J.intra_thresh_for_qp))(qps))
    assert list(thresh) == list(A.INTRA_THRESH)
    assert [J.intra_thresh_for_qp(q) for q in range(52)] == \
        [A.intra_thresh_for_qp(q) for q in range(52)]
    lam2 = np.asarray(jax.jit(jax.vmap(
        lambda q: 0.85 * jnp.exp2((q.astype(jnp.float32) - 12.0) / 3.0)))(
        qps))
    assert lam2.dtype == np.float32 and A.LAM2.dtype == np.float32
    assert np.array_equal(lam2, A.LAM2)


def test_payload_cap_matches_jax():
    for n_mb in (1, 7, 24, 64, 65, 130, 8160):
        assert A._payload_cap(n_mb) == J._payload_cap(n_mb)


def test_compact_idx_pads_like_nonzero():
    """jnp.nonzero(coded, size=cap, fill_value=0): indices of the coded
    MBs in order, cut or padded with 0 to cap."""
    rng = np.random.default_rng(3)
    for n, cap in ((10, 16), (40, 16), (64, 64), (5, 8)):
        coded = rng.random(n) < 0.4
        want = np.asarray(jnp.nonzero(jnp.asarray(coded), size=cap,
                                      fill_value=0)[0])
        got = A._compact_idx(torch.from_numpy(coded), cap).numpy()
        assert np.array_equal(got, want)
