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
print(len(names))
"""


def test_port_imports_with_jax_blocked():
    code = _IMPORT_ALL % (BLOCKED, os.path.join(ROOT, "chip_smoke.py"))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 15      # every module was walked


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
