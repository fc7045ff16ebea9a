"""Jobs over a world of gloo ranks on the CPU, through the entry points a
user calls: the CLI under ``torchrun`` (``parallel/launch.py``'s
``torchrun``: ``python -m torch.distributed.run --standalone``, its own
session, a hard time limit) and ``work.do_job`` on rank 0 of a world of
``torch_mesh_world.spawn``.  Rank 0 runs the job and the other ranks serve it; each file must
equal the one-rank port's and the JAX CLI's byte for byte (the JAX
package's GOP-parallel job takes min(N, 8 devices, frames) GOPs, the same
G here; its nlmeans job runs untiled, since its tiles differ from its
untiled filter at the picture's edges).  A GOP-parallel job resumed over
two ranks equals its uninterrupted run."""
import json
import os

import pytest

from handbrake_tpu.cli.__main__ import main as jcli
from handbrake_tpu_torch import checkpoint
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.job import schema as S
from handbrake_tpu_torch.job.presets import preset_search
from handbrake_tpu_torch.parallel.launch import torchrun
from handbrake_tpu_torch.utils.synth import make_clip, write_y4m
from torch_mesh_world import Call, spawn

W, H, N = 96, 64, 12
FPS = (30000, 1001)
LIMIT_S = 120
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# nlmeans with 3x3 patches and range 1 (a halo of 4 rows), so the 32-row
# chroma planes tile 4 ways too and XLA compiles it quickly: the CLI's
# --nlmeans takes a preset name only, so a preset file carries it
NLMEANS = "y_patch_size=3:y_range=1:cb_patch_size=3:cb_range=1"


@pytest.fixture(autouse=True)
def _reference_device_path(monkeypatch):
    """The JAX package's jobs run on its device path, as the port's do
    (some of its tests leave HB_TPU_DISABLE_DEVICE=1 set)."""
    monkeypatch.delenv("HB_TPU_DISABLE_DEVICE", raising=False)


@pytest.fixture(scope="module")
def y4m(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_job")
    return write_y4m(str(d / "in.y4m"), make_clip(W, H, N, seed=11), W, H,
                     0, FPS)


@pytest.fixture(scope="module")
def nlmeans_preset(tmp_path_factory):
    """The default preset with the light nlmeans, as a preset file."""
    p = dict(preset_search("Fast 1080p30"), PresetName="Mesh nlmeans",
             PictureDenoiseFilter="nlmeans", PictureDenoisePreset="medium",
             PictureDenoiseCustom=NLMEANS)
    path = tmp_path_factory.mktemp("preset") / "nlmeans.json"
    path.write_text(json.dumps(p))
    return str(path)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _argv(src, out, *extra):
    return ["-i", src, "-o", out, "-e", "h264", *extra]


def _torchrun(ranks, argv, cwd):
    """The port's CLI under torchrun on `ranks` CPU ranks; its output."""
    rc, out = torchrun(ranks, ["-m", "handbrake_tpu_torch.cli", *argv,
                               "--device", "cpu"], limit_s=LIMIT_S,
                       env=dict(os.environ, PYTHONPATH=ROOT), cwd=cwd)
    assert rc == 0, out[-3000:]
    return out


JOBS = {"gop-parallel": (2, ["-q", "28", "--gop-parallel", "4"]),
        "gop-parallel-2pass": (2, ["-b", "300", "--two-pass",
                                   "--gop-parallel", "4"]),
        "tile-parallel": (4, ["-q", "28", "--preset-import-file", None,
                              "--tile-parallel", "4"])}


@pytest.mark.parametrize("name", list(JOBS))
def test_cli_under_torchrun_equals_one_rank_and_reference(
        y4m, nlmeans_preset, tmp_path, name):
    ranks, extra = JOBS[name]
    extra = [nlmeans_preset if a is None else a for a in extra]
    out = str(tmp_path / "ranks.mp4")
    log = _torchrun(ranks, _argv(y4m, out, *extra), str(tmp_path))
    if name == "tile-parallel":
        assert "4 row tiles over 4 ranks" in log
        # 12 frames of 3 planes, each plane a work item
        assert "mesh: rank 3 served {'items': 36" in log
    else:
        assert "12 frames as 4 GOPs over 2 rank(s)" in log
    one = str(tmp_path / "one.mp4")
    assert cli(_argv(y4m, one, *extra, "--device", "cpu")) == 0
    assert _bytes(out) == _bytes(one)
    if name == "gop-parallel-2pass":
        return      # one rank's two-pass job: test_torch_parallel_gop.py
    ref = str(tmp_path / "ref.mp4")
    jextra = extra[:-2] if name == "tile-parallel" else extra
    assert jcli(_argv(y4m, ref, *jextra)) == 0
    assert _bytes(out) == _bytes(ref)


def test_do_job_on_rank_zero(y4m, tmp_path):
    """work.do_job on rank 0 of a spawned world of two, the other rank
    serving: the file of the one-rank job."""
    job = S.Job(path=y4m, file=str(tmp_path / "ranks.mp4"), mux="mp4",
                vcodec="h264", quality=28.0, gop_parallel=4)
    stats = spawn(2, [Call("handbrake_tpu_torch.work:do_job", (job,),
                           {"device": "cpu"})],
                  workdir=str(tmp_path / "w"), limit_s=LIMIT_S,
                  device="cpu")[0]
    assert stats["frames_out"] == N
    one = job.clone()
    one.file = str(tmp_path / "one.mp4")
    from handbrake_tpu_torch import work
    work.do_job(one, device="cpu")
    assert _bytes(job.file) == _bytes(one.file)


def test_gop_parallel_resume_over_two_ranks(y4m, tmp_path, monkeypatch):
    """A checkpointed GOP-parallel job (keyint 4, two GOPs a window of 8)
    killed inside its second window: its journal, cut there, resumes over
    two ranks under torchrun to the uninterrupted file."""
    extra = ["-q", "28", "-x", "keyint=4", "--gop-parallel", "2"]
    ref = str(tmp_path / "ref.mp4")
    assert cli(_argv(y4m, ref, *extra, "--device", "cpu")) == 0
    out = str(tmp_path / "gp.mp4")
    with monkeypatch.context() as m:
        m.setattr(checkpoint.CkptJournal, "close",
                  lambda self, complete=False: self.f.close())
        assert cli(_argv(y4m, out, *extra, "--checkpoint",
                         "--device", "cpu")) == 0
    ck = out + ".ckpt"
    data = _bytes(ck)
    spans = checkpoint.spans(data)
    marks = [k for k, (tag, _s, _e) in enumerate(spans) if tag == "g"]
    assert len(marks) == 1                  # the second window's start
    with open(ck, "wb") as f:               # and 3 samples after it
        f.write(data[:spans[marks[0] + 3][2]])
    os.unlink(out)
    log = _torchrun(2, _argv(y4m, out, *extra, "--resume"), str(tmp_path))
    assert "resume: 8 frames from checkpoint" in log
    assert "4 frames as 2 GOPs over 2 rank(s)" in log
    assert not os.path.exists(ck)
    assert _bytes(out) == _bytes(ref)
