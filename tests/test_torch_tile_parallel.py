"""nlmeans with ``tile_parallel`` on the CPU, held against the port's
filter without it and against the JAX package's mesh-sharded filter
(``make_mesh`` on the 8 host devices of ``tests/conftest.py``).

The reference cuts each plane into row tiles with halos to spread them
over its devices.  The port runs on one card, where row tiles would
compute the same function a second way, so the filter takes the tile
count and runs untiled: with any tile count its output must equal the
untiled ``nlmeans_plane`` exactly, and the reference's sharded call
within the float filters' 1 LSB on under 1 % of samples.  On smooth
content the reference's sharded call differs from its own unsharded
filter at the picture's top and bottom rows (its replicated halo rows
enter the patch distances); the port follows the unsharded filter
there, and that is held beside it."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handbrake_tpu.filters.nlmeans import nlmeans_plane as j_nlmeans
from handbrake_tpu.parallel import mesh as jmesh
from handbrake_tpu_torch.core.buffer import Buffer, Geometry, PIX_FMTS
from handbrake_tpu_torch.filters import base
from handbrake_tpu_torch.filters.nlmeans import nlmeans_plane
from handbrake_tpu_torch.job import schema as S

H, W = 96, 64
KW = dict(strength=6.0, origin_tune=0.9, maxval=255)


def _plane(kind, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w), np.uint8)
    return ((np.add.outer(np.arange(h), np.arange(w)) * 3 % 256)
            + rng.integers(0, 4, (h, w))).astype(np.uint8)


def _frame(y):
    return [y, y[::2, ::2].copy(), y[1::2, 1::2].copy()]


def _filter(h, w, **settings):
    f = base.create_filter(S.FILTER_NLMEANS, settings)
    f.init(base.FilterInit(geometry=Geometry(w, h), device="cpu",
                           pix_fmt=PIX_FMTS["yuv420p"]))
    return f


def _run(f, frames):
    """The filter's output planes (numpy) for each frame in turn."""
    return [[p.numpy() for p in f.work(Buffer(
        planes=planes, pix_fmt=PIX_FMTS["yuv420p"], pts=i))[0].planes]
        for i, planes in enumerate(frames)]


def _close(got, want):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return int(d.max()) <= 1 and float((d != 0).mean()) < 0.01


@pytest.mark.parametrize("kind", ["smooth", "noise"])
@pytest.mark.parametrize("patch,rng", [(7, 3), (5, 2), (3, 1)])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_tile_parallel_filter_equals_untiled_plane(kind, patch, rng, n):
    """Each plane of a frame through the filter with tile_parallel n is
    the untiled nlmeans_plane of that plane at the filter's settings."""
    planes = _frame(_plane(kind))
    f = _filter(H, W, tile_parallel=n, y_patch_size=patch, y_range=rng,
                cb_patch_size=patch, cb_range=rng)
    got = _run(f, [planes])[0]
    for g, p in zip(got, planes):
        t = torch.from_numpy(p)
        want = nlmeans_plane(t, t[None], patch=patch, rng=rng, **KW)
        assert np.array_equal(g, want.numpy())


@functools.lru_cache(None)
def _ref_sharded(n, patch, rng):
    return jmesh.tile_shard_nlmeans(jmesh.make_mesh(n, tile=n), patch=patch,
                                    rng=rng, **KW)


@pytest.mark.parametrize("kind", ["smooth", "noise"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_tile_parallel_beside_reference(kind, n):
    """The filter's luma with tile_parallel n (a 3x3 patch, range 1, the
    frame before as its temporal reference; 48x32 planes: 8 tiles of 6
    rows in the reference) against the reference's sharded call and its
    unsharded filter."""
    h, patch, rng = 48, 3, 1
    cur = _plane(kind, h=h, w=32)
    prev = np.roll(cur, 1, 1)
    f = _filter(h, 32, tile_parallel=n, y_patch_size=patch, y_range=rng,
                cb_patch_size=patch, cb_range=rng)
    got = _run(f, [_frame(prev), _frame(cur)])[1][0]
    refs = np.stack([cur, prev])
    ref_sharded = np.asarray(_ref_sharded(n, patch, rng)(
        jnp.asarray(cur), jnp.asarray(refs)))
    ref_untiled = np.asarray(j_nlmeans(jnp.asarray(cur), jnp.asarray(refs),
                                       patch=patch, rng=rng, **KW))
    assert _close(got, ref_untiled)
    reach = rng + patch // 2
    inner = slice(reach, h - reach)
    assert _close(got[inner], ref_sharded[inner])
    if kind == "noise":
        # the weights vanish: the reference's edge rows agree too
        assert _close(got, ref_sharded)
    else:
        # the reference's fault: its tiled edge rows differ from its own
        # untiled filter
        edge = np.nonzero((ref_sharded != ref_untiled).any(1))[0]
        assert len(edge) and all(r < reach or r >= h - reach for r in edge)


@pytest.mark.parametrize("h,n", [(50, 4), (61, 3), (37, 2)])
def test_tile_parallel_uneven_height(h, n):
    """A height the tile count does not divide (the reference pads the
    plane with its edge rows first): the filter's luma is still the
    untiled plane's."""
    y = _plane("smooth", h=h, w=40, seed=h)
    f = _filter(h, 40, tile_parallel=n, y_patch_size=5, y_range=2)
    got = _run(f, [[y, y[::2, ::2].copy(), y[::2, ::2].copy()]])[0][0]
    t = torch.from_numpy(y)
    assert np.array_equal(got, nlmeans_plane(t, t[None], patch=5, rng=2,
                                             **KW).numpy())


def test_filter_with_tile_parallel_equals_untiled():
    """The nlmeans filter with tile_parallel 2 and 4 (temporal refs
    carried over three frames) equals the filter without it."""
    frames = [_frame(_plane("smooth", seed=i)) for i in range(3)]
    outs = {tp: _run(_filter(H, W, tile_parallel=tp), frames)
            for tp in (0, 2, 4)}
    for tp in (2, 4):
        assert all(np.array_equal(a, b) for fa, fb in zip(outs[tp], outs[0])
                   for a, b in zip(fa, fb))
