"""Tests that need an NVIDIA GPU: the deblock kernel against its plain
version, and a short encode on the card against the CPU path.  They skip
where there is no card; on a machine with one:

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
from handbrake_tpu_torch.utils.synth import make_clip

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _case(seed, mb_w, mb_h):
    rng = np.random.default_rng(seed)
    H, W = mb_h * 16, mb_w * 16
    n_mb = mb_w * mb_h
    y = rng.integers(0, 256, (H, W)).astype(np.uint8)
    y[:H // 2] = (y[:H // 2] // 8) + 100
    u = (rng.integers(0, 256, (H // 2, W // 2)) // 2).astype(np.uint8)
    v = (rng.integers(0, 256, (H // 2, W // 2)) // 2).astype(np.uint8)
    mv = rng.integers(-20, 20, (n_mb, 2)).astype(np.int32)
    nnz = rng.integers(0, 3, (n_mb, 16)).astype(np.int32)
    nnz[rng.random((n_mb, 16)) < 0.6] = 0
    intra = rng.random(n_mb) < 0.2
    nnz = np.where(intra[:, None], 0, nnz)
    t8 = (rng.random(n_mb) < 0.3) & ~intra
    return y, u, v, mv, nnz, intra, t8


@pytest.mark.parametrize("mb_w,mb_h,qp", [(1, 1, 30), (3, 7, 36), (8, 2, 24),
                                          (45, 30, 28)])
@pytest.mark.parametrize("with_strong", [False, True])
def test_kernel_matches_plain(dev, mb_w, mb_h, qp, with_strong):
    y, u, v, mv, nnz, intra, t8 = (torch.from_numpy(a).to(dev)
                                   for a in _case(qp + mb_w, mb_w, mb_h))
    bs_v, bs_h = compute_bs(mb_w, mb_h, mv, nnz, intra, t8)
    scal = deblock_scal(qp, qp - 2)
    n0 = deblock_cuda.launches
    got = deblock_cuda.deblock_cuda(y, u, v, bs_v, bs_h, scal, with_strong)
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


def test_wrapper_checks_inputs(dev):
    y, u, v, mv, nnz, intra, t8 = (torch.from_numpy(a).to(dev)
                                   for a in _case(1, 3, 2))
    bs_v, bs_h = compute_bs(3, 2, mv, nnz, intra, t8)
    scal = deblock_scal(30, 28)
    with pytest.raises(ValueError):
        deblock_cuda.deblock_cuda(y.int(), u, v, bs_v, bs_h, scal, False)
    with pytest.raises(ValueError):
        deblock_cuda.deblock_cuda(y, u[:, :8], v, bs_v, bs_h, scal, False)
    with pytest.raises(ValueError):
        deblock_cuda.deblock_cuda(y, u, v, bs_v.cpu(), bs_h, scal, False)
    with pytest.raises(ValueError):
        deblock_cuda.deblock_cuda(y.t(), u, v, bs_v, bs_h, scal, False)


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
