"""Filter preset/tune/custom-string → settings dict (param.c analog).

Each filter has named presets and optional tunes; a custom string
``key=value:key=value`` overrides. Keys are validated against each filter's
settings template (the reference's ``settings_template`` regex idea,
common.h:1691), implemented as an allowed-key set + type coercion.
"""
from __future__ import annotations

from . import schema as S


class ParamError(ValueError):
    pass


def _parse_custom(s: str) -> dict:
    out = {}
    if not s:
        return out
    for kv in s.split(":"):
        if not kv:
            continue
        if "=" not in kv:
            raise ParamError(f"bad custom setting {kv!r}")
        k, v = kv.split("=", 1)
        out[k.strip()] = _coerce(v.strip())
    return out


def _coerce(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


# ---- per-filter tables (content is ours; structure mirrors param.c:18-311) ----

NLMEANS_PRESETS = {
    # y-strength, y-origin-tune, cb-strength, cb-origin-tune
    "ultralight": dict(y_strength=1.5, y_origin_tune=0.9, cb_strength=1.5, cb_origin_tune=0.9),
    "light":      dict(y_strength=3.0, y_origin_tune=0.9, cb_strength=3.0, cb_origin_tune=0.9),
    "medium":     dict(y_strength=6.0, y_origin_tune=0.9, cb_strength=6.0, cb_origin_tune=0.9),
    "strong":     dict(y_strength=10.0, y_origin_tune=0.8, cb_strength=10.0, cb_origin_tune=0.8),
}
NLMEANS_TUNES = {
    "none": {}, "film": dict(y_strength_scale=0.9), "grain": dict(y_strength_scale=0.6),
    "highmotion": dict(frame_count=1), "animation": dict(y_strength_scale=1.15),
}
NLMEANS_KEYS = {"y_strength", "y_origin_tune", "y_patch_size", "y_range",
                "y_frame_count", "y_prefilter", "cb_strength", "cb_origin_tune",
                "cb_patch_size", "cb_range", "cb_frame_count", "cb_prefilter",
                "cr_strength", "cr_origin_tune", "frame_count",
                "y_strength_scale", "threads"}

HQDN3D_PRESETS = {
    "ultralight": dict(y_spatial=1.0, cb_spatial=0.7, y_temporal=1.0, cb_temporal=0.7),
    "light":      dict(y_spatial=2.0, cb_spatial=1.0, y_temporal=2.0, cb_temporal=1.0),
    "medium":     dict(y_spatial=3.0, cb_spatial=2.0, y_temporal=2.0, cb_temporal=3.0),
    "strong":     dict(y_spatial=7.0, cb_spatial=7.0, y_temporal=5.0, cb_temporal=5.0),
}
HQDN3D_KEYS = {"y_spatial", "cb_spatial", "cr_spatial", "y_temporal",
               "cb_temporal", "cr_temporal"}

CHROMA_SMOOTH_PRESETS = {
    "ultralight": dict(cb_strength=0.9), "light": dict(cb_strength=1.1),
    "medium": dict(cb_strength=1.3), "strong": dict(cb_strength=1.8),
    "stronger": dict(cb_strength=2.4), "verystrong": dict(cb_strength=3.2),
}
CHROMA_SMOOTH_KEYS = {"cb_strength", "cr_strength", "cb_size", "cr_size"}

UNSHARP_PRESETS = {
    "ultralight": dict(y_strength=0.15, y_size=7), "light": dict(y_strength=0.25, y_size=7),
    "medium": dict(y_strength=0.5, y_size=7), "strong": dict(y_strength=0.8, y_size=7),
}
UNSHARP_KEYS = {"y_strength", "y_size", "cb_strength", "cb_size"}

LAPSHARP_PRESETS = {
    "ultralight": dict(y_strength=0.1), "light": dict(y_strength=0.2),
    "medium": dict(y_strength=0.3), "strong": dict(y_strength=0.5),
}
LAPSHARP_TUNES = {"none": dict(kernel="isolap"), "film": dict(kernel="isolap"),
                  "grain": dict(kernel="isolog"), "animation": dict(kernel="lap")}
LAPSHARP_KEYS = {"y_strength", "y_kernel", "cb_strength", "cb_kernel", "kernel"}

DEBLOCK_PRESETS = {
    "ultralight": dict(strength="weak", thresh=20, blocksize=8),
    "light": dict(strength="weak", thresh=50, blocksize=8),
    "medium": dict(strength="strong", thresh=20, blocksize=8),
    "strong": dict(strength="strong", thresh=50, blocksize=8),
}
DEBLOCK_KEYS = {"strength", "thresh", "blocksize"}

DEBAND_PRESETS = {
    "ultralight": dict(range=8, thresh=12), "light": dict(range=12, thresh=24),
    "medium": dict(range=16, thresh=48), "strong": dict(range=24, thresh=64),
}
DEBAND_KEYS = {"range", "thresh", "grain"}

BM3D_PRESETS = {
    "ultralight": dict(sigma=1.0), "light": dict(sigma=2.0),
    "medium": dict(sigma=4.0), "strong": dict(sigma=7.0),
}
BM3D_KEYS = {"sigma", "block_size", "block_step", "group_size", "bm_range"}

DECOMB_PRESETS = {
    "default": dict(mode=7),      # yadif+blend+cubic
    "bob": dict(mode=7 | 8),
    "eedi2": dict(mode=15),
    "eedi2bob": dict(mode=15 | 8),
}
DECOMB_KEYS = {"mode", "magnitude_thresh", "variance_thresh", "laplacian_thresh",
               "dilation_thresh", "erosion_thresh", "noise_thresh",
               "search_distance", "postproc"}

YADIF_PRESETS = {"default": dict(mode=3), "skip_spatial": dict(mode=1),
                 "bob": dict(mode=7)}
YADIF_KEYS = {"mode", "parity"}

DETELECINE_PRESETS = {"default": dict(skip_left=1, skip_right=1, skip_top=4,
                                      skip_bottom=4, strict_breaks=0,
                                      plane=0)}
DETELECINE_KEYS = {"skip_left", "skip_right", "skip_top", "skip_bottom",
                   "strict_breaks", "plane", "parity"}

COMB_DETECT_PRESETS = {
    "default": dict(spatial_metric=2, motion_thresh=1, spatial_thresh=3,
                    filter_mode=2, block_thresh=40, block_width=16,
                    block_height=16),
    "permissive": dict(spatial_metric=2, motion_thresh=2, spatial_thresh=3,
                       filter_mode=0, block_thresh=80, block_width=16,
                       block_height=16),
    "fast": dict(spatial_metric=0, motion_thresh=2, spatial_thresh=3,
                 filter_mode=0, block_thresh=80, block_width=16,
                 block_height=16),
}
COMB_DETECT_KEYS = {"spatial_metric", "motion_thresh", "spatial_thresh",
                    "filter_mode", "block_thresh", "block_width",
                    "block_height", "force_analysis"}

_TABLE = {
    S.FILTER_NLMEANS: (NLMEANS_PRESETS, NLMEANS_TUNES, NLMEANS_KEYS),
    S.FILTER_DENOISE: (HQDN3D_PRESETS, None, HQDN3D_KEYS),
    S.FILTER_CHROMA_SMOOTH: (CHROMA_SMOOTH_PRESETS, None, CHROMA_SMOOTH_KEYS),
    S.FILTER_UNSHARP: (UNSHARP_PRESETS, None, UNSHARP_KEYS),
    S.FILTER_LAPSHARP: (LAPSHARP_PRESETS, LAPSHARP_TUNES, LAPSHARP_KEYS),
    S.FILTER_DEBLOCK: (DEBLOCK_PRESETS, None, DEBLOCK_KEYS),
    S.FILTER_DEBAND: (DEBAND_PRESETS, None, DEBAND_KEYS),
    S.FILTER_BM3D: (BM3D_PRESETS, None, BM3D_KEYS),
    S.FILTER_DECOMB: (DECOMB_PRESETS, None, DECOMB_KEYS),
    S.FILTER_YADIF: (YADIF_PRESETS, None, YADIF_KEYS),
    S.FILTER_BWDIF: (YADIF_PRESETS, None, YADIF_KEYS),
    S.FILTER_DETELECINE: (DETELECINE_PRESETS, None, DETELECINE_KEYS),
    S.FILTER_COMB_DETECT: (COMB_DETECT_PRESETS, None, COMB_DETECT_KEYS),
}


def generate_filter_settings(filter_id: int, preset: str = "medium",
                             tune: str = "", custom: str = "") -> dict:
    """hb_generate_filter_settings analog."""
    if filter_id not in _TABLE:
        # filters with no presets (crop_scale, pad, rotate...) — custom only
        return _parse_custom(custom)
    presets, tunes, keys = _TABLE[filter_id]
    settings = {}
    if preset == "custom":
        settings.update(_parse_custom(custom))
    else:
        if preset not in presets:
            if "default" in presets:
                preset = "default"
            else:
                raise ParamError(
                    f"unknown preset {preset!r} for filter {filter_id}")
        settings.update(presets[preset])
        if tune and tunes:
            if tune not in tunes:
                raise ParamError(f"unknown tune {tune!r} for filter {filter_id}")
            settings.update(tunes[tune])
        settings.update(_parse_custom(custom))
    return settings


def validate_filter_settings(filter_id: int, settings: dict) -> bool:
    """hb_validate_filter_settings analog: unknown keys are an error."""
    if filter_id not in _TABLE:
        return True
    _, _, keys = _TABLE[filter_id]
    for k in settings:
        if k not in keys:
            raise ParamError(
                f"unknown key {k!r} for filter "
                f"{S.FILTER_NAMES.get(filter_id, filter_id)}")
    return True
