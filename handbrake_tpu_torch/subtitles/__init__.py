"""Subtitle subsystem: text parsers (SRT/SSA/WebVTT) + rasterizer for
burn-in + PGS bitmap decode.

Reference: libhb/decsrtsub.c (SRT parse: charset, timing, overlap),
decssasub.c (SSA/ASS), rendersub.c (burn-in consumer), decavsub.c:739
(PGS personality — see pgs.py).

The counterpart of ``handbrake_tpu/subtitles/``: host code, copied
(``raster.py`` alone narrows its fallback to a missing OpenCV); the
burn-in's blend is ``filters/rendersub.py`` on the filter's device.
"""
from .srt import (parse_srt, parse_ssa, parse_vtt,  # noqa: F401
                  parse_textsub, SubEvent)
