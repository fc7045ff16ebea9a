"""Tests that need an NVIDIA GPU: the deblock kernel against its plain
version, a short encode on the card against the CPU path, the crop/scale
filter on the card against the CPU (equal), and the hqdn3d kernel
against its plain version (bit for bit, output and f32 state, the state
carried over frames, at shapes on every edge of its 32-lane blocks and
32-step tiles), with its division by 255 checked against the IEEE one
over every f32 in [0, 256).  They skip where there is no card; on a
machine with one:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from handbrake_tpu_torch.codecs.h264 import deblock_cuda
from handbrake_tpu_torch.codecs.h264.deblock import deblock_scal
from handbrake_tpu_torch.codecs.h264.deblock_torch import (compute_bs,
                                                           deblock,
                                                           deblock_plain)
from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig, H264Encoder
from handbrake_tpu_torch.core.buffer import YUV420P, Buffer, Geometry
from handbrake_tpu_torch.filters.base import FilterInit
from handbrake_tpu_torch.filters import hqdn3d_cuda
from handbrake_tpu_torch.filters.cropscale import CropScaleFilter
from handbrake_tpu_torch.filters.denoise import (DenoiseFilter, _gamma,
                                                 hqdn3d_plane)
from handbrake_tpu_torch.utils.synth import make_clip

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _case(seed, mb_w, mb_h):
    """Random planes (half of the luma smooth) and MB data with intra MBs;
    mv int16, nnz int32, flags bool, the kernel's dtypes."""
    rng = np.random.default_rng(seed)
    H, W = mb_h * 16, mb_w * 16
    n_mb = mb_w * mb_h
    y = rng.integers(0, 256, (H, W)).astype(np.uint8)
    y[:H // 2] = (y[:H // 2] // 8) + 100
    u = (rng.integers(0, 256, (H // 2, W // 2)) // 2).astype(np.uint8)
    v = (rng.integers(0, 256, (H // 2, W // 2)) // 2).astype(np.uint8)
    mv = rng.integers(-20, 20, (n_mb, 2)).astype(np.int16)
    nnz = rng.integers(0, 3, (n_mb, 16)).astype(np.int32)
    nnz[rng.random((n_mb, 16)) < 0.6] = 0
    intra = rng.random(n_mb) < 0.2
    nnz = np.where(intra[:, None], 0, nnz).astype(np.int32)
    t8 = (rng.random(n_mb) < 0.3) & ~intra
    return y, u, v, mv, nnz, intra, t8


def _all_filtering_case(seed, mb_w, mb_h):
    """Flat planes with small steps between 4x4 blocks and every bS >= 2
    (every block coded, no 8x8 transform, some intra MBs): every edge
    filters, so every step of the chain is driven."""
    rng = np.random.default_rng(seed)
    H, W = mb_h * 16, mb_w * 16
    n_mb = mb_w * mb_h

    def steps(h, w, base):
        i, j = np.mgrid[0:h, 0:w]
        return (base + 2 * ((i // 4 + j // 4) % 2)).astype(np.uint8)

    mv = rng.integers(-20, 20, (n_mb, 2)).astype(np.int16)
    nnz = rng.integers(1, 4, (n_mb, 16)).astype(np.int32)
    intra = rng.random(n_mb) < 0.2
    t8 = np.zeros(n_mb, bool)
    return (steps(H, W, 100), steps(H // 2, W // 2, 120),
            steps(H // 2, W // 2, 130), mv, nnz, intra, t8)


@pytest.mark.parametrize("mb_w,mb_h,qp", [(1, 1, 30), (3, 7, 36), (8, 2, 24),
                                          (45, 30, 28), (1, 68, 32),
                                          (120, 1, 26), (120, 51, 28)])
@pytest.mark.parametrize("with_strong", [False, True])
def test_kernel_matches_plain(dev, mb_w, mb_h, qp, with_strong):
    y, u, v, mv, nnz, intra, t8 = (torch.from_numpy(a).to(dev)
                                   for a in _case(qp + mb_w, mb_w, mb_h))
    bs_v, bs_h = compute_bs(mb_w, mb_h, mv, nnz, intra, t8)
    scal = deblock_scal(qp, qp - 2)
    n0 = deblock_cuda.launches
    got = deblock_cuda.deblock_cuda(y, u, v, mv, nnz, intra, t8, scal,
                                    with_strong)
    assert deblock_cuda.launches == n0 + 1
    want = deblock_plain(y, u, v, bs_v, bs_h, scal, with_strong)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the public entry launches the kernel for CUDA tensors
    pub = deblock(y, u, v, mv, nnz, intra, t8, qp, qp - 2, with_strong)
    assert deblock_cuda.launches == n0 + 2
    for g, w in zip(pub, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("with_strong", [False, True])
def test_kernel_matches_plain_all_filtering(dev, with_strong):
    mb_w, mb_h, qp = 9, 5, 36
    case = _all_filtering_case(3, mb_w, mb_h)
    y, u, v, mv, nnz, intra, t8 = (torch.from_numpy(a).to(dev) for a in case)
    bs_v, bs_h = compute_bs(mb_w, mb_h, mv, nnz, intra, t8)
    # every edge but the frame's border: bS >= 2
    inner_v = torch.ones_like(bs_v, dtype=torch.bool)
    inner_v[:, 0, 0] = False
    inner_h = torch.ones_like(bs_h, dtype=torch.bool)
    inner_h[0, :, 0] = False
    assert bool((bs_v[inner_v] >= 2).all() and (bs_h[inner_h] >= 2).all())
    scal = deblock_scal(qp, qp)
    got = deblock_cuda.deblock_cuda(y, u, v, mv, nnz, intra, t8, scal,
                                    with_strong)
    want = deblock_plain(y, u, v, bs_v, bs_h, scal, with_strong)
    torch.cuda.synchronize()
    for g, w, p in zip(got, want, (y, u, v)):
        assert torch.equal(g, w)
        assert int((g != p).sum()) > p.numel() // 8


def test_deblock_on_card_skips_compute_bs(dev, monkeypatch):
    """deblock() on CUDA tensors launches the kernel once and derives no
    bS on the host; mb_intra=None is all inter."""
    from handbrake_tpu_torch.codecs.h264 import deblock_torch

    y, u, v, mv, nnz, intra, t8 = (torch.from_numpy(a).to(dev)
                                   for a in _case(5, 6, 4))
    want = deblock_plain(y, u, v,
                         *compute_bs(6, 4, mv, nnz, None, t8),
                         deblock_scal(30, 28), False)

    def refuse(*a, **k):
        raise AssertionError("compute_bs called on the CUDA path")

    monkeypatch.setattr(deblock_torch, "compute_bs", refuse)
    n0 = deblock_cuda.launches
    got = deblock(y, u, v, mv, nnz, None, t8, 30, 28, with_strong=False)
    assert deblock_cuda.launches == n0 + 1
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_checks_inputs(dev):
    y, u, v, mv, nnz, intra, t8 = (torch.from_numpy(a).to(dev)
                                   for a in _case(1, 3, 2))
    scal = deblock_scal(30, 28)
    ok = (y, u, v, mv, nnz, intra, t8, scal, False)

    def call(i, x):
        args = list(ok)
        args[i] = x
        deblock_cuda.deblock_cuda(*args)

    for i, bad in ((0, y.int()), (1, u[:, :8]), (0, y.t()),
                   (3, mv.int()), (4, nnz.to(torch.int8)), (4, nnz.cpu()),
                   (5, intra.to(torch.uint8)), (6, t8[:-1])):
        with pytest.raises(ValueError):
            call(i, bad)
    # above the size limit (8192 samples a side): named in the error
    H, W = 4800, 9600
    n_mb = (H // 16) * (W // 16)
    big = (torch.zeros((H, W), dtype=torch.uint8, device=dev),
           torch.zeros((H // 2, W // 2), dtype=torch.uint8, device=dev),
           torch.zeros((H // 2, W // 2), dtype=torch.uint8, device=dev),
           torch.zeros((n_mb, 2), dtype=torch.int16, device=dev),
           torch.zeros((n_mb, 16), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="8192x4320"):
        deblock_cuda.deblock_cuda(*big, None, None, scal, False)


@pytest.mark.parametrize("batch", [1, 8])
def test_encode_on_card_matches_cpu(dev, batch):
    frames = make_clip(320, 192, 10, seed=2)
    cfg = dict(width=320, height=192, qp=28, gop=6, deblock=True,
               cabac=True, transform8x8=True, dispatch_batch=batch)
    n0 = deblock_cuda.launches
    gpu = H264Encoder(EncoderConfig(**cfg))
    # all frames begun before any is finished: full batches, redo path
    pend = [gpu.begin_frame(*f) for f in frames]
    a = [gpu.finish_frame(p) for p in pend]
    assert deblock_cuda.launches - n0 == 8 + gpu.n_redo   # 8 P frames
    cpu = H264Encoder(EncoderConfig(**cfg), device="cpu")
    assert a == [cpu.encode_frame(*f) for f in frames]


@pytest.mark.parametrize("settings", [
    {"crop-top": 60, "crop-bottom": 60, "width": 480, "height": 200},
    {"crop-left": 3, "crop-right": 5, "crop-top": 1, "width": 720,
     "height": 400, "method": "bicubic"},
    {"crop-top": 2, "width": 300, "height": 170, "method": "point"}],
    ids=["letterbox-down", "odd-crop-up", "point"])
def test_cropscale_on_card_matches_cpu(dev, settings):
    """Card against CPU, every plane equal (the resample kernel and its
    plain version sum in one order); the resampled planes stay on the
    card."""
    frame = make_clip(640, 360, 1, seed=6)[0]

    def run(device):
        f = CropScaleFilter(dict(settings))
        f.init(FilterInit(geometry=Geometry(640, 360), device=device))
        return f.work(Buffer(planes=list(frame), pix_fmt=YUV420P, pts=0))[0]

    got, want = run(dev), run("cpu")
    for g, w in zip(got.planes, want.planes):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)


def _noisy_frames(w, h, n, bits, seed):
    rng = np.random.default_rng(seed)
    mx = (1 << bits) - 1
    out = []
    for t in range(n):
        planes = []
        cw, ch = (w + 1) // 2, (h + 1) // 2
        for pw, ph in ((w, h), (cw, ch), (cw, ch)):
            yy, xx = np.mgrid[0:ph, 0:pw]
            v = mx * (0.5 + 0.3 * np.sin((xx + 3 * t) / 9.0)) \
                + rng.normal(0, mx / 30, (ph, pw))
            planes.append(np.clip(np.round(v), 0, mx).astype(
                np.uint8 if bits == 8 else np.uint16))
        out.append(planes)
    return out


_HQ = ((3.0, 2.0, 2.0), (2.0, 3.0, 3.0))
# (id, w, h, (spatial, temporal) strengths, bit depths): a single sample,
# a column, a row, sizes off the 32-lane blocks and 32-step tiles (65 is
# one past two tiles), 1080p and 2160p at 10 bits; gammas of 0
_HQ_CASES = (
    ("1x1", 1, 1, _HQ, (8, 10)), ("1x97", 1, 97, _HQ, (8, 10)),
    ("97x1", 97, 1, _HQ, (8, 10)), ("33x17", 33, 17, _HQ, (8, 10)),
    ("65x40", 65, 40, _HQ, (8, 10)), ("small", 64, 48, _HQ, (8, 10)),
    ("odd", 322, 178, ((7.0, 7.0, 7.0), (5.0, 5.0, 5.0)), (8, 10)),
    ("1080p", 1920, 1080, _HQ, (8, 10)), ("2160p", 3840, 2160, _HQ, (10,)),
    ("zero-gammas", 130, 66, ((0.0, 4.0, 0.0), (6.0, 0.0, 0.0)), (8, 10)),
    ("no-spatial", 65, 40, ((0.0, 0.0, 0.0), (3.0, 3.0, 3.0)), (8, 10)))


@pytest.mark.parametrize("w,h,strengths,bits", [
    pytest.param(w, h, st, b, id=f"{name}-{b}")
    for name, w, h, st, bits in _HQ_CASES for b in bits])
def test_hqdn3d_kernel_matches_plain(dev, w, h, strengths, bits):
    """One launch a frame over all three planes, against the plain version
    on the card, three frames with the state carried: outputs and f32
    states equal; a gamma of 0 skips its pass in both."""
    maxval = (1 << bits) - 1
    g_sp = [_gamma(s) for s in strengths[0]]
    g_tmp = [_gamma(s) for s in strengths[1]]
    frames = _noisy_frames(w, h, 3, bits, w + bits)
    ka = pa = None
    for planes in frames:
        pt = [torch.from_numpy(p).to(dev) for p in planes]
        if ka is None:
            ka = [p.float() * (255.0 / maxval) for p in pt]
            pa = [a.clone() for a in ka]
        n0 = hqdn3d_cuda.launches
        res = hqdn3d_cuda.hqdn3d_cuda(pt, ka, g_sp, g_tmp, maxval)
        assert hqdn3d_cuda.launches == n0 + 1
        want = [hqdn3d_plane(p, a, gs, gt, maxval)
                for p, a, gs, gt in zip(pt, pa, g_sp, g_tmp)]
        torch.cuda.synchronize()
        for (o, a), (wo, wa) in zip(res, want):
            assert o.dtype == wo.dtype and o.shape == wo.shape
            assert torch.equal(o, wo)
            assert torch.equal(a, wa)
        ka = [a for _, a in res]
        pa = [a for _, a in want]


@pytest.fixture(scope="module")
def hqdn3d_variants():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    from handbrake_tpu_torch.tools import ablate_hqdn3d
    with open(hqdn3d_cuda.SOURCE) as f:
        return ablate_hqdn3d.build_variants(f.read())


@pytest.mark.parametrize("w,h,strengths,bits", [
    (1, 1, _HQ, 8), (33, 17, _HQ, 10), (65, 40, _HQ, 8),
    (130, 66, ((0.0, 4.0, 0.0), (6.0, 0.0, 0.0)), 8)],
    ids=["1x1", "33x17-10", "65x40", "zero-gammas"])
def test_hqdn3d_ablation_variants_match_kernel(dev, hqdn3d_variants, w, h,
                                               strengths, bits):
    """The ablation tool's variants that compute the kernel's function
    (the chain alone, the temporal pass on the chain, the IEEE division)
    give the kernel's outputs and states, bit for bit."""
    from handbrake_tpu_torch.tools import ablate_hqdn3d
    maxval = (1 << bits) - 1
    planes = [torch.from_numpy(p).to(dev)
              for p in _noisy_frames(w, h, 1, bits, w + h)[0]]
    ants = [p.float() * (255.0 / maxval) + 1.5 for p in planes]
    outs, args, _keep = hqdn3d_cuda.prepare(
        planes, ants, [_gamma(s) for s in strengths[0]],
        [_gamma(s) for s in strengths[1]], maxval)
    ablate_hqdn3d.check_exact(hqdn3d_variants, args, outs)


def test_hqdn3d_division_exhaustive(dev):
    """The kernel's division by 255 equals __fdiv_rn for every f32 bit
    pattern in [0, 256)."""
    r = hqdn3d_cuda.div_check()
    assert r["checked"] == 0x43800000
    assert r["mismatches"] == 0, r


def test_hqdn3d_chain_probe(dev):
    """The chain probe runs with both divisions and counts cycles."""
    for ieee in (False, True):
        r = hqdn3d_cuda.chain_probe(4096, 2.5, ieee)
        assert r["cycles"] > 0 and r["ms"] > 0


def test_hqdn3d_wrapper_checks_inputs(dev):
    p = torch.zeros((48, 64), dtype=torch.uint8, device=dev)
    a = torch.zeros((48, 64), dtype=torch.float32, device=dev)
    for planes, ants in (([p.int()], [a]), ([p], [a.double()]),
                         ([p], [a[:, :32]]), ([p.cpu()], [a]),
                         ([p.t()], [a.t()]), ([p] * 4, [a] * 4)):
        n = len(planes)
        with pytest.raises(ValueError):
            hqdn3d_cuda.hqdn3d_cuda(planes, ants, [0.5] * n, [0.5] * n, 255)
    with pytest.raises(ValueError):
        hqdn3d_cuda.hqdn3d_cuda([p], [a], [0.5], [0.5], 1023)  # not uint16


def test_denoise_filter_on_card_matches_cpu(dev):
    """The filter launches the kernel once a frame on the card, within
    1 LSB of the CPU path (the plain version)."""
    frames = _noisy_frames(96, 64, 4, 8, 3)

    def run(device):
        f = DenoiseFilter({"y_spatial": 3.0, "cb_spatial": 2.0,
                           "y_temporal": 2.0, "cb_temporal": 3.0})
        f.init(FilterInit(geometry=Geometry(96, 64), device=device))
        return [f.work(Buffer(planes=list(p), pix_fmt=YUV420P, pts=i))[0]
                for i, p in enumerate(frames)]

    n0 = hqdn3d_cuda.launches
    got = run(dev)
    assert hqdn3d_cuda.launches == n0 + len(frames)
    for g, w in zip(got, run("cpu")):
        for a, b in zip(g.planes, w.planes):
            assert a.device.type == "cuda"
            assert int((a.cpu().int() - b.int()).abs().max()) <= 1
