"""The port's H.264 deblock (handbrake_tpu_torch.codecs.h264.deblock_torch)
held against the JAX package's: compute_bs, the plain wavefront in both
with_strong variants, the spec-order Python filter, deblock_tpu's scan
and the Pallas kernel itself (interpret mode).  Every comparison is
exact: the filter is integer arithmetic."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handbrake_tpu.codecs.h264 import deblock as jdeblock
from handbrake_tpu.codecs.h264 import deblock_pallas as jpallas
from handbrake_tpu.codecs.h264 import deblock_tpu as jdt
from handbrake_tpu_torch.codecs.h264 import deblock as tdeblock
from handbrake_tpu_torch.codecs.h264 import deblock_torch as DT

CASES = [(6, 4, 30, 0.0), (5, 3, 40, 0.0), (8, 2, 24, 0.0), (3, 7, 36, 0.2),
         (1, 1, 30, 0.3)]


def _deblock_case(seed, mb_w, mb_h, qp, p_intra):
    """Copy of test_h264_primitives._deblock_case."""
    rng = np.random.default_rng(seed)
    H, W = mb_h * 16, mb_w * 16
    n_mb = mb_w * mb_h
    y = rng.integers(0, 256, (H, W)).astype(np.uint8)
    u = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    v = rng.integers(0, 256, (H // 2, W // 2)).astype(np.uint8)
    # smooth half the frame so the |p0-q0|<alpha conditions trigger
    y[:H // 2] = (y[:H // 2] // 8) + 100
    u //= 2
    v //= 2
    mv = rng.integers(-20, 20, (n_mb, 2)).astype(np.int32)
    nnz = rng.integers(0, 3, (n_mb, 16)).astype(np.int32)
    nnz[rng.random((n_mb, 16)) < 0.6] = 0
    t8 = rng.random(n_mb) < 0.3
    intra = rng.random(n_mb) < p_intra
    nnz = np.where(intra[:, None], 0, nnz)
    t8 = t8 & ~intra
    return y, u, v, mv, nnz, intra, t8


def _case(mb_w, mb_h, qp, p_intra):
    return _deblock_case(qp * 7 + mb_w, mb_w, mb_h, qp, p_intra)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _python_filter(y, u, v, mv, nnz, intra, t8, qp, qpc, mb_w, mb_h):
    ry, ru, rv = (p.astype(np.int32).copy() for p in (y, u, v))
    jdeblock.deblock_frame(
        ry, ru, rv, qp, qpc, intra.reshape(mb_h, mb_w),
        mv.reshape(mb_h, mb_w, 2).copy(),
        nnz.reshape(mb_h, mb_w, 4, 4).transpose(0, 2, 1, 3)
        .reshape(mb_h * 4, mb_w * 4), t8.reshape(mb_h, mb_w))
    return tuple(p.astype(np.uint8) for p in (ry, ru, rv))


def _port(case, qp, qpc, with_strong):
    out = DT.deblock(*(_t(a) for a in case), qp, qpc,
                     with_strong=with_strong)
    return tuple(p.numpy() for p in out)


def _assert_planes(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == np.uint8 and g.shape == w.shape
        assert np.array_equal(g, w)


@pytest.mark.parametrize("mb_w,mb_h,qp,p_intra", CASES)
def test_compute_bs_matches_jax(mb_w, mb_h, qp, p_intra):
    y, u, v, mv, nnz, intra, t8 = _case(mb_w, mb_h, qp, p_intra)
    for t8_arg in (t8, None):
        bv, bh = DT.compute_bs(mb_w, mb_h, _t(mv), _t(nnz), _t(intra),
                               None if t8_arg is None else _t(t8_arg))
        jv, jh = jax.jit(jdt.compute_bs, static_argnums=(0, 1))(
            mb_w, mb_h, jnp.asarray(mv), jnp.asarray(nnz),
            jnp.asarray(intra),
            None if t8_arg is None else jnp.asarray(t8_arg))
        assert bv.dtype == torch.int32 and bh.dtype == torch.int32
        assert np.array_equal(bv.numpy(), np.asarray(jv))
        assert np.array_equal(bh.numpy(), np.asarray(jh))


@pytest.mark.parametrize("mb_w,mb_h,qp,p_intra", CASES)
def test_plain_wavefront_matches_reference(mb_w, mb_h, qp, p_intra):
    """with_strong=True equals the spec-order Python filter and
    deblock_tpu's scan; with_strong=False equals the scan's bS ≤ 2
    variant (and the spec filter too on all-inter frames)."""
    qpc = max(0, qp - 3)
    case = _case(mb_w, mb_h, qp, p_intra)
    spec = _python_filter(*case, qp, qpc, mb_w, mb_h)
    for with_strong in (True, False):
        got = _port(case, qp, qpc, with_strong)
        scan = jax.jit(jdt.build_deblock_fn(mb_w, mb_h, with_strong))(
            *(jnp.asarray(a) for a in case), qp, qpc)
        _assert_planes(got, scan)
        if with_strong or p_intra == 0:
            _assert_planes(got, spec)
        # the filter did something (the case is not vacuous)
        if mb_w * mb_h > 1:
            assert any(not np.array_equal(g, p)
                       for g, p in zip(got, case[:3]))


def _pallas_case(mb_w, mb_h, qp, p_intra, with_strong):
    qpc = max(0, qp - 3)
    case = _case(mb_w, mb_h, qp, p_intra)
    fn = jpallas.build_deblock_pallas(mb_w, mb_h, with_strong=with_strong,
                                      interpret=True)
    want = fn(*(jnp.asarray(a) for a in case), qp, qpc,
              scal=jnp.asarray(jpallas.deblock_scal(qp, qpc)))
    _assert_planes(_port(case, qp, qpc, with_strong), want)


def test_plain_wavefront_matches_pallas_kernel():
    """The Pallas kernel itself (interpret mode), the variant the analyzer
    chains: 6x4 MBs, with_strong=False."""
    _pallas_case(6, 4, 30, 0.0, False)


@pytest.mark.slow
@pytest.mark.parametrize("mb_w,mb_h,qp,p_intra,with_strong",
                         [(6, 4, 30, 0.0, True), (5, 3, 40, 0.0, False),
                          (3, 7, 36, 0.2, True), (3, 7, 36, 0.2, False),
                          (1, 1, 30, 0.3, True)])
def test_plain_wavefront_matches_pallas_kernel_more(mb_w, mb_h, qp, p_intra,
                                                    with_strong):
    _pallas_case(mb_w, mb_h, qp, p_intra, with_strong)


def test_deblock_scal_matches_jax():
    for qp in range(-2, 54):
        for qpc in (0, 17, 39, 51):
            assert np.array_equal(tdeblock.deblock_scal(qp, qpc),
                                  jpallas.deblock_scal(qp, qpc))


def test_deblock_tables_match_jax():
    for name in ("ALPHA", "BETA", "TC0"):
        a, b = getattr(tdeblock, name), np.asarray(getattr(jdeblock, name))
        assert np.array_equal(a, b) and a.shape == b.shape


def test_deblock_refuses_other_devices():
    """A CPU tensor takes the plain version; a tensor on another device
    is refused, never filtered silently on the CPU."""
    case = _case(3, 2, 30, 0.0)
    t = [_t(a) for a in case]
    with pytest.raises(ValueError):
        DT.deblock(*(x.to("meta") for x in t), 30, 27)
