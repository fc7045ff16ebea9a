"""Worlds of ranks on NVIDIA cards (``parallel/mesh.py``): two ranks on
one card over gloo, which stages each CUDA tensor through the host, and
one rank a card over NCCL.  Each world's GOP-parallel streams and tiled
nlmeans must equal one rank's on the same card.  They skip where the
cards are missing; on a machine with them:

    python -m pytest -p no:cacheprovider --noconftest \\
        tests/test_torch_mesh_cuda.py -q -m cuda
"""
import os

import pytest
import torch

from handbrake_tpu_torch.filters.nlmeans import nlmeans_plane
from handbrake_tpu_torch.parallel import gop
from handbrake_tpu_torch.utils.synth import make_clip
from torch_mesh_world import Call, MeshSpec, spawn

pytestmark = pytest.mark.cuda

W, H = 192, 128
LIMIT_S = 300


def _cards(n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA GPUs, {torch.cuda.device_count()} "
                    f"visible")


def _world_equals_one_rank(ranks, tmp_path, env=None):
    frames = make_clip(W, H, 10, seed=3)
    refs = torch.stack([torch.from_numpy(f[0]) for f in frames[1::-1]])
    got = spawn(ranks, [
        Call("handbrake_tpu_torch.parallel.gop:encode_gop_parallel",
             (frames, W, H, 28, 4)),
        Call("handbrake_tpu_torch.parallel.mesh:tile_shard_nlmeans",
             (MeshSpec(ranks, ranks),), {}, (refs[0], refs))],
        workdir=str(tmp_path), limit_s=LIMIT_S, env=env)
    assert got[0] == gop.encode_gop_parallel(frames, W, H, 28, 4)
    dev = refs.cuda()
    assert torch.equal(got[1].cpu(), nlmeans_plane(dev[0], dev).cpu())
    with open(os.path.join(str(tmp_path), "rank1.log")) as f:
        return f.read()


def test_two_ranks_on_one_card_over_gloo(tmp_path):
    _cards(1)
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    log = _world_equals_one_rank(2, tmp_path,
                                 env={"CUDA_VISIBLE_DEVICES": first})
    assert "on cuda:0, backend gloo: 2 ranks share each card" in log


def test_nccl_one_rank_a_card(tmp_path):
    _cards(2)
    n = min(4, torch.cuda.device_count())
    log = _world_equals_one_rank(n, tmp_path)
    assert "on cuda:1, backend nccl: every rank has a card" in log
