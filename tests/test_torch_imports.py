"""The port stands alone: every module of handbrake_tpu_torch, and
chip_smoke.py, imports with jax and handbrake_tpu blocked, and no source
file of the port names either in an import.  Its entry points run on the
CUDA card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

import handbrake_tpu_torch
from handbrake_tpu_torch.codecs.h264.encoder import EncoderConfig, H264Encoder
from handbrake_tpu_torch.utils.device import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(handbrake_tpu_torch.__file__))
BLOCKED = ("jax", "jaxlib", "handbrake_tpu")
# what only the fixture generator's main() may import: OpenCV and the
# libavcodec loaders of tests/, which the machine with the card lacks
HOST_ONLY = ("cv2", "ffvideo", "ffdec", "ffaudio")

_IMPORT_ALL = r"""
import importlib, importlib.util, pkgutil, sys

BLOCKED = %r


def blocked(name):
    return name.split(".")[0] in BLOCKED


class Blocker:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("blocked: " + name)
        return None


for m in [m for m in sys.modules if blocked(m)]:
    del sys.modules[m]
sys.meta_path.insert(0, Blocker())
import handbrake_tpu_torch
names = ["handbrake_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(handbrake_tpu_torch.__path__,
                                          "handbrake_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", %r)
spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not any(blocked(m) for m in sys.modules)
print(" ".join(names))
"""

# every module of the job path, cli.__main__ and the filters included,
# must be walked
JOB_PATH = ("core.buffer", "core.fifo", "core.pipeline", "core.state",
            "job.schema", "job.geometry", "job.title", "job.param",
            "job.presets", "sources.common", "sources.raw", "sources.mp4",
            "sources.probe", "sync.sync", "codecs.registry",
            "codecs.ratecontrol", "mux.common", "mux.nal", "mux.mp4",
            "filters.base", "filters.graph", "filters.kernels",
            "filters.cropscale", "filters.vfr", "work", "scan", "hb",
            "cli.__main__", "job.colormap", "utils.fp", "filters.avfilter",
            "filters.bm3d", "filters.colorspace", "filters.comb_detect",
            "filters.deband", "filters.deblock", "filters.decomb",
            "filters.deinterlace", "filters.denoise", "filters.hqdn3d_cuda",
            "filters.detelecine", "filters.nlmeans", "filters.rpu",
            "filters.sharp", "filters.simple", "filters.resample_cuda",
            "sources.mkv", "mux.mkv", "codecs.h264.native_decoder",
            "native.build", "filters.rendersub", "subtitles",
            "subtitles.srt", "subtitles.raster", "subtitles.pgs",
            "subtitles.vobsub", "subtitles.cea608", "codecs.hdr",
            "codecs.h264.cavlc", "codecs.h264.predict",
            "codecs.h264.encoder_b", "sources.ps", "sources.dvd",
            "sources.ts", "sources.bd", "sources.avi", "codecs.mpeg2",
            "tools.source_builders", "tools.make_source_fixtures")


def test_port_imports_with_jax_blocked():
    code = _IMPORT_ALL % (BLOCKED + HOST_ONLY,
                          os.path.join(ROOT, "chip_smoke.py"))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    walked = set(r.stdout.split())
    assert len(walked) >= 15 + len(JOB_PATH)    # every module was walked
    for m in JOB_PATH:
        assert "handbrake_tpu_torch." + m in walked, m


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_no_source_imports_jax_or_the_jax_package():
    """Catches imports inside functions too, which the import test above
    does not execute."""
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in BLOCKED, (path, n)


def test_entry_points_default_to_cuda():
    cfg = EncoderConfig(width=64, height=48, deblock=True, cabac=True,
                        transform8x8=True)
    if torch.cuda.is_available():
        assert H264Encoder(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            H264Encoder(cfg)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    enc = H264Encoder(cfg, device="cpu")
    assert enc.device == torch.device("cpu")
    assert resolve_device(None if torch.cuda.is_available() else "cpu")


def test_tf32_is_off():
    resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_host_only_modules_are_imported_inside_functions():
    """cv2 and the libavcodec loaders are imported only in function
    bodies (the fixture generator's main()), never by a module."""
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in tree.body:
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in HOST_ONLY, (path, n)
