"""Test helper: the JAX package's annex-B reader given the frame rate the
stream states, so that the reference's files and scans of an H.264 or
HEVC elementary stream can be held byte for byte against the port's.
The port reads that rate from the stream's VUI (or HEVC VPS); the
reference parses no VUI and labels every elementary stream 25 fps
unless its ``AnnexBReader`` is built with ``fps=``, which the fixture
does with the rate ``codecs/vui.stream_rate`` reads from the file."""
from fractions import Fraction

import pytest

from handbrake_tpu.sources import raw as jraw
from handbrake_tpu_torch.codecs.vui import stream_rate


def stated_rate(path: str, codec: str = "h264"):
    """The rate the stream at ``path`` states, or None."""
    with open(path, "rb") as f:
        return stream_rate(codec, f.read(1 << 16))[0]


@pytest.fixture
def reference_reads_rate(monkeypatch):
    """While a test runs, the reference's AnnexBReader built without
    ``fps`` takes the stream's stated rate (25 where it states none)."""
    build = jraw.AnnexBReader.__init__

    def init(self, path, codec="h264", fps=None):
        build(self, path, codec,
              fps or stated_rate(path, codec) or Fraction(25, 1))
    monkeypatch.setattr(jraw.AnnexBReader, "__init__", init)
