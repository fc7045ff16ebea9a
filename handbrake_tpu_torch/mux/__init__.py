"""Muxers: the host-native MP4 (isobmff) writer + interleave core
(reference: muxcommon.c, muxavformat.c, extradata.c, nal_units.c).  The
MKV writer is not ported yet."""
from .common import Muxer  # noqa: F401
from .mp4 import MP4Writer  # noqa: F401
from . import nal  # noqa: F401
