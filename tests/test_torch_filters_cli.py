"""Every filter flag of the port's CLI (handbrake_tpu_torch.cli) runs on
the CPU on a small interlaced y4m.  Where the filter computes in
integers, the mp4 equals the JAX CLI's byte for byte; for the float
filters (held within 1 LSB of the reference in
``tests/test_torch_filters.py``) the mp4 holds every frame at the
source's geometry."""
import pytest

from handbrake_tpu.cli.__main__ import main as jcli
from handbrake_tpu_torch.cli.__main__ import main as cli
from handbrake_tpu_torch.sources.mp4 import MP4Demuxer
from handbrake_tpu_torch.utils.synth import make_interlaced_clip, write_y4m


@pytest.fixture(autouse=True)
def _reference_device_path(monkeypatch):
    """The JAX package's jobs run on its device path, as the port's do:
    some of its own tests leave HB_TPU_DISABLE_DEVICE=1 set for the rest
    of their process, which switches it to its host encoder."""
    monkeypatch.delenv("HB_TPU_DISABLE_DEVICE", raising=False)


W, H, N = 64, 48, 4
BASE_ARGV = ["-e", "h264", "-q", "28", "--encoder-profile", "high"]
# flag → (argv, computes in integers)
FLAGS = {
    "comb-detect": (["--comb-detect"], True),
    "decomb": (["--comb-detect", "--decomb"], True),
    "deinterlace": (["--deinterlace"], True),
    "detelecine": (["--detelecine"], True),
    "deblock": (["--deblock"], True),
    "deband": (["--deband"], True),
    "grayscale": (["--grayscale"], True),
    "rotate": (["--rotate", "angle=90"], True),
    "pad": (["--pad", "80:64:blue"], True),
    "colorspace": (["--colorspace", "bt709"], True),
    "hqdn3d": (["--hqdn3d"], False),
    "nlmeans": (["--nlmeans"], False),
    "bm3d": (["--bm3d"], False),
    "unsharp": (["--unsharp"], False),
    "lapsharp": (["--lapsharp"], False),
    "chroma-smooth": (["--chroma-smooth"], False),
}


@pytest.fixture(scope="module")
def woven(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tfcli") / "woven.y4m")
    return write_y4m(path, make_interlaced_clip(W, H, N, seed=5), W, H,
                     interlace="t")


def _mp4(path):
    d = MP4Demuxer(path)
    try:
        ti = d.tracks[0]
        return ([bytes(b.data) for _, b in d.packets()], ti.extradata,
                (ti.width, ti.height))
    finally:
        d.close()


@pytest.mark.parametrize("flag", list(FLAGS))
def test_cli_runs_each_filter_flag(woven, tmp_path, flag):
    extra, integer = FLAGS[flag]
    argv = ["-i", woven, *BASE_ARGV, *extra]
    tout = str(tmp_path / "port.mp4")
    assert cli(argv + ["-o", tout, "--device", "cpu"]) == 0
    got = _mp4(tout)
    assert got[1].startswith(b"\x01") and len(got[0]) == N
    if integer:
        jout = str(tmp_path / "ref.mp4")
        assert jcli(argv + ["-o", jout]) == 0
        assert got == _mp4(jout)
        with open(jout, "rb") as a, open(tout, "rb") as b:
            assert a.read() == b.read()
    else:
        assert got[2] == (W, H)
