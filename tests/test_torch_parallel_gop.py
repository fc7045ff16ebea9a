"""The port's GOP-parallel encode (``parallel/gop.py``, the GOP analyzer
``build_p_analyzer_gops`` and ``H264Encoder.encode_p_from_analysis``)
held against the JAX package's on the CPU: the reference runs under
``make_mesh(G, tile=1)`` on the 8 host devices of ``tests/conftest.py``,
so both take the same G (the port takes G = min(gop_parallel, frames) on
its one device).  Streams, budgets and qps must be equal, and a do_job
with ``gop_parallel`` must write the reference's file byte for byte."""
import functools

import jax
import numpy as np
import pytest
import torch

from handbrake_tpu import work as jwork
from handbrake_tpu.codecs.h264 import encoder_tpu
from handbrake_tpu.job import schema as JS
from handbrake_tpu.parallel import gop as jgop
from handbrake_tpu.parallel.mesh import make_mesh
from handbrake_tpu_torch import work
from handbrake_tpu_torch.codecs.h264.analyzer import (build_p_analyzer,
                                                      build_p_analyzer_gops)
from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig, H264Encoder
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.parallel import gop
from handbrake_tpu_torch.utils.synth import make_clip, write_y4m

W, H = 64, 48
FPS = (30000, 1001)


class _CachedVmapJax:
    """jax, with vmap cached by (function, in_axes): with the analyzer
    builder cached too, each of the reference's encode_gop_parallel calls
    of one shape and G reuses one compiled executable."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    @functools.lru_cache(None)
    def _vmap(f, in_axes):
        return jax.vmap(f, in_axes=in_axes)

    def vmap(self, f, in_axes=0):
        return self._vmap(f, in_axes)


@pytest.fixture(scope="module", autouse=True)
def _reference_setup():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("HB_TPU_DISABLE_DEVICE", raising=False)
        for name in ("build_p_analyzer", "build_p_analyzer_batch",
                     "build_p_analyzer_fn"):
            mp.setattr(encoder_tpu, name,
                       functools.lru_cache(None)(getattr(encoder_tpu, name)))
        mp.setattr(jgop, "jax", _CachedVmapJax())
        yield


def _frames(n, w=W, h=H):
    """tests/test_parallel_gop.py's clip."""
    base = (np.add.outer(np.arange(h), np.arange(w)) * 3 % 256).astype(
        np.uint8)
    return [(np.roll(base, i, axis=1),
             np.full((h // 2, w // 2), 110 + i, np.uint8),
             np.full((h // 2, w // 2), 60, np.uint8)) for i in range(n)]


@pytest.mark.parametrize("n,g", [(8, 2), (7, 3), (10, 4), (5, 5), (9, 8)])
def test_split_gops(n, g):
    assert gop.split_gops(n, g) == jgop.split_gops(n, g)


# (frames, G, qp): even and uneven chunks, a qp a GOP, a qp a frame
CASES = {
    "g2": (8, 2, 28),
    "g4-uneven": (10, 4, 28),
    "g2-qp-per-gop": (8, 2, [24, 32]),
    "g4-qp-per-frame": (10, 4, [[26, 27, 28], [30, 29], [22, 36, 40],
                                [41]]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_encode_gop_parallel_equals_reference(case):
    n, g, qp = CASES[case]
    frames = _frames(n)
    streams, full, aus = gop.encode_gop_parallel(frames, W, H, qp, g,
                                                 device="cpu")
    jstreams, jfull, jaus = jgop.encode_gop_parallel(
        frames, W, H, qp, make_mesh(g, tile=1))
    assert streams == jstreams and full == jfull
    assert aus == jaus
    assert [len(a) for a in aus] == [ln for _, ln in gop.split_gops(n, g)]


def test_gops_equal_serial_encoders():
    """tests/test_parallel_gop.py's invariant on the port: each GOP's
    stream is its chunk encoded serially by its own encoder."""
    frames = _frames(10)
    streams, _, _ = gop.encode_gop_parallel(frames, W, H, 28, 4,
                                            device="cpu")
    for (s, ln), got in zip(gop.split_gops(10, 4), streams):
        enc = H264Encoder(EncoderConfig(width=W, height=H, qp=28, gop=ln),
                          device="cpu")
        assert got == b"".join(enc.encode_frame(*frames[i])
                               for i in range(s, s + ln))


def test_gop_analyzer_equals_single_frame_analyzer():
    """Each frame of a GOP-analyzer call equals the single-frame analyzer
    on that frame's own reference and qp (the streams above hold it
    against the reference's vmapped analyzer)."""
    mb_w, mb_h = W // 16, H // 16
    clip = make_clip(W, H, 6, seed=2)
    srcs, refs = clip[:3], clip[3:]
    qps = [22, 30, 38]
    qpcs = [q - 1 for q in qps]
    t = [torch.from_numpy(np.stack([f[k] for f in srcs])) for k in range(3)]
    r = [[torch.from_numpy(f[k]) for f in refs] for k in range(3)]
    outs = build_p_analyzer_gops(mb_w, mb_h)(*t, *r, qps, qpcs)
    one = build_p_analyzer(mb_w, mb_h)
    for g, d in enumerate(outs):
        packed = torch.cat([x.reshape(-1) for x in (t[0][g], t[1][g],
                                                    t[2][g])])
        e = one(packed, *(p[g] for p in r), qps[g], qpcs[g])
        for k in ("packed_small", "recon_y", "urec", "vrec", "luma_lv"):
            assert torch.equal(d[k], e[k]), k
        for c in range(len(d["payload"])):
            assert torch.equal(d["payload"][c], e["payload"][c])


@pytest.mark.parametrize("cplx", [[8000.0, 24000.0], [1.0, 2.0, 3.0, 5.0],
                                  [12345.0, 0.0, 777.0, 31.0]])
@pytest.mark.parametrize("total", [96000.0, 1234567.0])
def test_exchange_rc_stats_equals_reference(cplx, total):
    got = gop.exchange_rc_stats(np.asarray(cplx), total)
    want = jgop.exchange_rc_stats(make_mesh(len(cplx), tile=1),
                                  np.asarray(cplx), total)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


def test_two_pass_equals_reference():
    frames = _frames(12)
    streams, full, st = gop.encode_gop_parallel_2pass(
        frames, W, H, 60.0, 2, fps=(30, 1), device="cpu")
    jstreams, jfull, jst = jgop.encode_gop_parallel_2pass(
        frames, W, H, 60.0, make_mesh(2, tile=1), fps=(30, 1))
    assert streams == jstreams and full == jfull
    for k in ("budgets", "pass1_bits", "qps", "actual_kbps", "frame_aus"):
        assert st[k] == jst[k], k


@pytest.fixture(scope="module")
def y4m(tmp_path_factory):
    d = tmp_path_factory.mktemp("gp")
    return write_y4m(str(d / "in.y4m"), _frames(12), W, H, 0, FPS)


def _job(Sm, src, out, **kw):
    j = Sm.Job(path=src, file=out, mux="mp4", vcodec="h264",
               quality=28.0, gop_parallel=4)
    for k, v in kw.items():
        setattr(j, k, v)
    return j


@pytest.mark.parametrize("rate", [False, True], ids=["quality", "2pass"])
def test_do_job_gop_parallel_equals_reference(y4m, tmp_path, rate):
    """A gop_parallel=4 job (and one with a multipass bitrate, which runs
    the two-pass allocator): the port's mp4 equals the reference's."""
    kw = dict(quality=None, vbitrate=300, multipass=True) if rate else {}
    out = str(tmp_path / "t.mp4")
    jout = str(tmp_path / "j.mp4")
    stats = work.do_job(_job(S, y4m, out, **kw), device="cpu")
    jwork.do_job(_job(JS, y4m, jout, **kw))
    assert stats["frames_out"] == 12
    with open(out, "rb") as a, open(jout, "rb") as b:
        assert a.read() == b.read()
