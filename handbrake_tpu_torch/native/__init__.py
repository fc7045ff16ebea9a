"""Native (C++) host stage of the H.264 encoder: CAVLC/CABAC slice
coding, the host deblock and NAL packing (``hb264.cpp``)."""
from .build import get_lib  # noqa: F401
