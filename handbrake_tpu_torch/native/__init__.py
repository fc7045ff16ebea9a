"""Native (C++) host stages: the H.264 encoder's CAVLC/CABAC slice
coding, host deblock and NAL packing (``hb264.cpp``), and the H.264
decoder (``hbdec264.cpp``)."""
from .build import get_decoder_lib, get_lib  # noqa: F401
