"""Anamorphic geometry calculator (hb_set_anamorphic_size2, hb.c:1231).

Given source geometry + crop and the UI's geometry request, compute the
output storage dimensions and pixel aspect ratio for the five anamorphic
modes (none / strict / loose / custom / automatic), honouring modulus
rounding, max-dimension clamps and keep-display-aspect.  Modes 0-3 are
the reference's; the automatic mode (HB_ANAMORPHIC_AUTO, what a preset's
``"PicturePAR": "auto"`` asks for) is the port's.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Optional, Tuple

ANAMORPHIC_NONE = 0
ANAMORPHIC_STRICT = 1
ANAMORPHIC_LOOSE = 2
ANAMORPHIC_CUSTOM = 3
ANAMORPHIC_AUTO = 4

MIN_DIM = 32


@dataclasses.dataclass
class GeometrySettings:
    """The UI-side request (hb_geometry_settings_t analog)."""
    mode: int = ANAMORPHIC_NONE
    width: int = 0                # 0 = derive from source
    height: int = 0
    max_width: int = 0            # 0 = unlimited
    max_height: int = 0
    modulus: int = 2
    keep_display_aspect: bool = True
    par_num: int = 0              # custom mode PAR (0 = keep source)
    par_den: int = 0
    crop: Tuple[int, int, int, int] = (0, 0, 0, 0)   # top bottom left right


def _mod_round(v: int, mod: int) -> int:
    mod = max(1, mod)
    return max(MIN_DIM, ((v + mod // 2) // mod) * mod)


def _mod_down(v: int, mod: int) -> int:
    mod = max(1, mod)
    return max(MIN_DIM, (v // mod) * mod)


def _fit16(par: Fraction) -> Fraction:
    """The closest ratio to `par` whose terms both fit 16 bits (an
    H.264/HEVC sar_width and sar_height)."""
    if par.numerator <= 0xFFFF and par.denominator <= 0xFFFF:
        return par
    den = min(0xFFFF, int(0xFFFF / par))
    while True:
        fit = par.limit_denominator(max(1, den))
        if fit.numerator <= 0xFFFF:
            return fit
        den -= 1


def _auto(cw: int, ch: int, src_par: Fraction, dar: Fraction,
          ui: GeometrySettings):
    """The automatic mode: the storage size asked for (a preset's scale
    of the cropped picture; the cropped size where none is asked), held
    to the modulus and within the max clamps at its own aspect, and the
    pixel aspect that keeps the cropped display aspect.  Square pixels
    stay square, and an unscaled picture keeps the source's aspect, so a
    square-pixel job is the preset's scale at 1:1."""
    mod = max(1, ui.modulus)
    w = ui.width or cw
    h = ui.height or ch
    if w % mod:
        w = _mod_round(w, mod)
    if h % mod:
        h = _mod_round(h, mod)
    if ui.max_width and w > ui.max_width:
        h = _mod_round(int(round(h * ui.max_width / w)), mod)
        w = _mod_down(ui.max_width, mod)
    if ui.max_height and h > ui.max_height:
        w = _mod_round(int(round(w * ui.max_height / h)), mod)
        h = _mod_down(ui.max_height, mod)
    if src_par == 1:
        par = Fraction(1)
    elif (w, h) == (cw, ch):
        par = src_par
    else:
        par = _fit16(dar * Fraction(h, w))
    return w, h, par, int(round(w * par))


def set_anamorphic_size2(src_w: int, src_h: int, src_par: Fraction,
                         ui: GeometrySettings):
    """→ (width, height, par: Fraction, display_width: int).

    Mirrors hb_set_anamorphic_size2's observable behaviour:
      auto:   the requested storage size at the pixel aspect that keeps
              the display aspect (``_auto``)
      none:   square pixels; dimensions mod-rounded, display aspect kept
              by deriving height from the cropped DAR
      strict: storage = cropped source, PAR = source PAR
      loose:  storage mod-rounded/clamped; PAR rescaled so the display
              aspect of the cropped source is preserved exactly
      custom: caller-provided PAR (or source PAR), optional keep-DAR
    """
    top, bottom, left, right = ui.crop
    cw = max(MIN_DIM, src_w - left - right)
    ch = max(MIN_DIM, src_h - top - bottom)
    src_par = Fraction(src_par) if src_par else Fraction(1)
    dar = Fraction(cw, ch) * src_par
    mod = max(1, ui.modulus)

    if ui.mode == ANAMORPHIC_STRICT:
        return cw, ch, src_par, int(round(cw * src_par))

    if ui.mode == ANAMORPHIC_AUTO:
        return _auto(cw, ch, src_par, dar, ui)

    if ui.mode == ANAMORPHIC_NONE:
        w = ui.width or cw
        if ui.max_width:
            w = min(w, ui.max_width)
        w = _mod_round(w, mod)
        if ui.keep_display_aspect or not ui.height:
            h = _mod_round(int(round(w / dar)), mod)
        else:
            h = _mod_round(ui.height, mod)
        if ui.max_height and h > ui.max_height:
            h = _mod_down(ui.max_height, mod)
            if ui.keep_display_aspect:
                w = _mod_round(int(round(h * dar)), mod)
        return w, h, Fraction(1), w

    if ui.mode == ANAMORPHIC_LOOSE:
        w = ui.width or cw
        if ui.max_width:
            w = min(w, ui.max_width)
        w = _mod_round(w, mod)
        h = ui.height or ch
        if ui.max_height:
            h = min(h, ui.max_height)
        h = _mod_round(h, mod)
        # rescale PAR so displayed aspect is exactly the cropped DAR
        par = dar * Fraction(h, w)
        return w, h, par.limit_denominator(65535), int(round(w * par))

    # custom — max-dimension clamps apply here too (hb_set_anamorphic_size2
    # clamps every mode; a queue job with maxWidth/maxHeight must not
    # produce oversized storage)
    w = _mod_round(ui.width or cw, mod)
    h = _mod_round(ui.height or ch, mod)
    if ui.max_width and w > ui.max_width:
        if ui.keep_display_aspect and not (ui.par_num and ui.par_den):
            h = _mod_round(int(round(h * ui.max_width / w)), mod)
        w = _mod_down(ui.max_width, mod)
    if ui.max_height and h > ui.max_height:
        if ui.keep_display_aspect and not (ui.par_num and ui.par_den):
            w = _mod_round(int(round(w * ui.max_height / h)), mod)
            if ui.max_width:
                w = min(w, _mod_down(ui.max_width, mod))
        h = _mod_down(ui.max_height, mod)
    if ui.par_num and ui.par_den:
        par = Fraction(ui.par_num, ui.par_den)
    elif ui.keep_display_aspect:
        par = dar * Fraction(h, w)
    else:
        par = src_par
    return w, h, par.limit_denominator(65535), int(round(w * par))
