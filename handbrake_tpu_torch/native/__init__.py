"""Native (C++) host stages: the H.264 encoder's CAVLC/CABAC slice
coding, host deblock and NAL packing (``hb264.cpp``), the H.264
decoder (``hbdec264.cpp``) and the baseline JPEG decoder of MJPEG
sources (``hbdecmjpeg.cpp``)."""
from .build import get_decoder_lib, get_lib, get_mjpeg_lib  # noqa: F401
