"""Pixel aspect and frame rate in H.264 and HEVC streams: the VUI's
sample aspect ratio and timing read from a sequence parameter set (H.264
E.1.1, HEVC E.2.1), an HEVC VPS's timing, and the 16-bit check a writer
of ``sar_width``/``sar_height`` needs.

The SPS parsers of ``h264/syntax.py`` and ``hevc/syntax.py`` stop before
the VUI's aspect (the first) or take only the encoder's subset (the
second), so these read the whole SPS syntax up to the VUI's timing:
scaling lists, every picture order count type, short- and long-term
reference picture sets, sub-layers.  The aspect is ``None`` where the
stream signals none (no VUI, no aspect info, ``aspect_ratio_idc`` 0
"unspecified" or a reserved value, a zero term).  ``stream_rate`` gives
the rate as libavcodec's decoders set ``framerate`` from that timing.
"""
from __future__ import annotations

from fractions import Fraction

from .h264.bits import BitReader, ebsp_to_rbsp, split_annexb

# aspect_ratio_idc 1-16 (Table E-1 of both standards); 255 is
# Extended_SAR, with sar_width and sar_height following
SAR_TABLE = {1: (1, 1), 2: (12, 11), 3: (10, 11), 4: (16, 11),
             5: (40, 33), 6: (24, 11), 7: (20, 11), 8: (32, 11),
             9: (80, 33), 10: (18, 11), 11: (15, 11), 12: (64, 33),
             13: (160, 99), 14: (4, 3), 15: (3, 2), 16: (2, 1)}
EXTENDED_SAR = 255

_H264_HIGH = (100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135)


def sar16(num: int, den: int, what: str = "the pixel aspect"):
    """(num, den) reduced, as a 16-bit ``sar_width``/``sar_height`` pair
    holds it; ValueError where a term is not positive or does not fit."""
    if num <= 0 or den <= 0:
        raise ValueError(f"{what} {num}:{den} is not a positive ratio")
    f = Fraction(num, den)
    if f.numerator > 0xFFFF or f.denominator > 0xFFFF:
        raise ValueError(
            f"{what} {num}:{den} reduces to {f.numerator}:{f.denominator}, "
            f"which does not fit the 16-bit sar_width/sar_height")
    return f.numerator, f.denominator


def display_size(width: int, height: int, num: int, den: int):
    """The display size of a width x height picture of pixel aspect
    num:den: the width scaled, rounded half up, the height kept."""
    return (2 * width * num + den) // (2 * den), height


def _vui(br: BitReader, hevc: bool) -> dict:
    """{"sar", "timing"} of a VUI whose present flag is next: the aspect
    (None where none is signalled) and (num_units_in_tick, time_scale)
    (None where absent)."""
    out = {"sar": None, "timing": None}
    if not br.u(1):                         # vui_parameters_present
        return out
    if br.u(1):                             # aspect_ratio_info_present
        idc = br.u(8)
        if idc == EXTENDED_SAR:
            n, d = br.u(16), br.u(16)
            if n and d:
                f = Fraction(n, d)
                out["sar"] = (f.numerator, f.denominator)
        else:
            out["sar"] = SAR_TABLE.get(idc)
    if br.u(1):                             # overscan_info_present
        br.u(1)
    if br.u(1):                             # video_signal_type_present
        br.u(4)
        if br.u(1):                         # colour_description_present
            br.u(24)
    if br.u(1):                             # chroma_loc_info_present
        br.ue()
        br.ue()
    if hevc:
        br.u(3)                             # neutral chroma, field_seq,
        if br.u(1):                         # frame_field_info; default
            for _ in range(4):              # display window
                br.ue()
    if br.u(1):                             # timing_info_present
        out["timing"] = (br.u(32), br.u(32))
    return out


def _skip_scaling_list(br: BitReader, size: int):
    last = nxt = 8
    for _ in range(size):
        if nxt:
            nxt = (last + br.se() + 256) % 256
        last = nxt or last


def h264_sps_vui(rbsp: bytes) -> dict:
    """The VUI's aspect and timing of an H.264 SPS (its RBSP after the
    NAL header byte)."""
    br = BitReader(rbsp)
    h264_to_vui(br)
    return _vui(br, hevc=False)


def h264_to_vui(br: BitReader):
    """Read an H.264 SPS up to its vui_parameters_present_flag."""
    profile = br.u(8)
    br.u(16)                                # constraints, level_idc
    br.ue()                                 # seq_parameter_set_id
    if profile in _H264_HIGH:
        chroma = br.ue()
        if chroma == 3:
            br.u(1)                         # separate_colour_plane
        br.ue()
        br.ue()                             # bit depths
        br.u(1)                             # qpprime_y_zero_transform_bypass
        if br.u(1):                         # seq_scaling_matrix_present
            for i in range(8 if chroma != 3 else 12):
                if br.u(1):
                    _skip_scaling_list(br, 16 if i < 6 else 64)
    br.ue()                                 # log2_max_frame_num_minus4
    poc_type = br.ue()
    if poc_type == 0:
        br.ue()
    elif poc_type == 1:
        br.u(1)
        br.se()
        br.se()
        for _ in range(br.ue()):
            br.se()
    br.ue()                                 # max_num_ref_frames
    br.u(1)                                 # gaps_in_frame_num_allowed
    br.ue()
    br.ue()                                 # picture size in MBs
    if not br.u(1):                         # frame_mbs_only
        br.u(1)
    br.u(1)                                 # direct_8x8_inference
    if br.u(1):                             # frame_cropping
        for _ in range(4):
            br.ue()


def _hevc_ptl(br: BitReader, max_sub_layers_minus1: int):
    br.u(2 + 1 + 5 + 32 + 4 + 43 + 1 + 8)   # general profile, tier, level
    present = [(br.u(1), br.u(1)) for _ in range(max_sub_layers_minus1)]
    if max_sub_layers_minus1 > 0:
        br.u(2 * (8 - max_sub_layers_minus1))
    for profile, level in present:
        if profile:
            br.u(88)
        if level:
            br.u(8)


def _hevc_scaling_list_data(br: BitReader):
    for size_id in range(4):
        for _ in range(0, 6, 3 if size_id == 3 else 1):
            if not br.u(1):                 # scaling_list_pred_mode
                br.ue()
                continue
            if size_id > 1:
                br.se()                     # dc coefficient
            for _ in range(min(64, 1 << (4 + (size_id << 1)))):
                br.se()


def _hevc_st_rps(br: BitReader, idx: int, n_deltas: list):
    """One st_ref_pic_set of the SPS; appends its NumDeltaPocs."""
    if idx and br.u(1):                     # inter_ref_pic_set_prediction
        br.u(1)
        br.ue()                             # delta_rps sign and size
        n = 0
        for _ in range(n_deltas[idx - 1] + 1):
            used = br.u(1)
            n += used or br.u(1)            # use_delta_flag
        n_deltas.append(n)
        return
    neg, pos = br.ue(), br.ue()
    for _ in range(neg + pos):
        br.ue()
        br.u(1)
    n_deltas.append(neg + pos)


def hevc_sps_vui(rbsp: bytes) -> dict:
    """The VUI's aspect and timing of an HEVC SPS (its RBSP after the
    two-byte NAL header)."""
    br = BitReader(rbsp)
    hevc_to_vui(br)
    return _vui(br, hevc=True)


def hevc_to_vui(br: BitReader):
    """Read an HEVC SPS up to its vui_parameters_present_flag."""
    br.u(4)                                 # sps_video_parameter_set_id
    msl = br.u(3)
    br.u(1)
    _hevc_ptl(br, msl)
    br.ue()                                 # sps_seq_parameter_set_id
    if br.ue() == 3:                        # chroma_format_idc
        br.u(1)
    br.ue()
    br.ue()                                 # picture size
    if br.u(1):                             # conformance_window
        for _ in range(4):
            br.ue()
    br.ue()
    br.ue()                                 # bit depths
    log2_poc = br.ue() + 4
    first = 0 if br.u(1) else msl           # sub_layer_ordering_info
    for _ in range(first, msl + 1):
        br.ue()
        br.ue()
        br.ue()
    for _ in range(6):                      # block sizes, depths
        br.ue()
    if br.u(1) and br.u(1):                 # scaling lists, in the SPS
        _hevc_scaling_list_data(br)
    br.u(2)                                 # amp, sample_adaptive_offset
    if br.u(1):                             # pcm
        br.u(8)
        br.ue()
        br.ue()
        br.u(1)
    n_deltas = []
    for i in range(br.ue()):
        _hevc_st_rps(br, i, n_deltas)
    if br.u(1):                             # long_term_ref_pics_present
        for _ in range(br.ue()):
            br.u(log2_poc)
            br.u(1)
    br.u(2)                                 # temporal mvp, strong intra


def _config_nals(codec: str, config: bytes) -> list:
    """The parameter-set NAL units (no start codes) of an avcC or hvcC
    payload."""
    out = []
    if codec == "h264" and len(config) > 6 and config[0] == 1:
        i = 6
        for _ in range(config[5] & 0x1F):
            ln = int.from_bytes(config[i:i + 2], "big")
            out.append(config[i + 2:i + 2 + ln])
            i += 2 + ln
    elif codec == "hevc" and len(config) > 23 and config[0] == 1:
        i = 23
        for _ in range(config[22]):
            n = int.from_bytes(config[i + 1:i + 3], "big")
            i += 3
            for _ in range(n):
                ln = int.from_bytes(config[i:i + 2], "big")
                out.append(config[i + 2:i + 2 + ln])
                i += 2 + ln
    return out


def hevc_vps_timing(rbsp: bytes):
    """(vps_num_units_in_tick, vps_time_scale) of an HEVC VPS (its RBSP
    after the two-byte NAL header), or None where
    vps_timing_info_present_flag is 0 (F.7.3.2.1 read as 7.3.2.1)."""
    br = BitReader(rbsp)
    br.u(4 + 1 + 1 + 6)                     # id, base layer flags, layers
    msl = br.u(3)                           # vps_max_sub_layers_minus1
    br.u(1 + 16)                            # nesting, reserved 0xffff
    _hevc_ptl(br, msl)
    first = 0 if br.u(1) else msl           # sub_layer_ordering_info
    for _ in range(first, msl + 1):
        br.ue()
        br.ue()
        br.ue()
    max_layer_id = br.u(6)
    for _ in range(br.ue()):                # vps_num_layer_sets_minus1
        br.u(max_layer_id + 1)              # layer_id_included_flag
    if br.u(1):                             # vps_timing_info_present
        return br.u(32), br.u(32)
    return None


def _nals(codec: str, data: bytes) -> list:
    return _config_nals(codec, data) if data[0] == 1 \
        else list(split_annexb(data))


def _vps_timing(data: bytes):
    """The timing of the first HEVC VPS in ``data`` (hvcC or annex-B), or
    None; ValueError where the VPS cannot be read."""
    for nal in _nals("hevc", data):
        if nal and ((nal[0] >> 1) & 0x3F) == 32:
            try:
                return hevc_vps_timing(ebsp_to_rbsp(nal[2:]))
            except (IndexError, ValueError) as e:
                raise ValueError(f"hevc: the VPS cannot be read up to its "
                                 f"timing ({e or 'cut short'})") from None
    return None


def stream_rate(codec: str, data: bytes) -> tuple:
    """The frame rate an H.264 or HEVC stream states (``data``: an avcC
    or hvcC payload, or an annex-B stream), as libavcodec's decoders set
    ``framerate``: H.264 time_scale / (2 * num_units_in_tick) of the
    first SPS's VUI (ticks_per_frame 2); HEVC time_scale /
    num_units_in_tick of the SPS's VUI, or of the VPS where the VUI has
    no timing (hevcdec.c export_stream_params).  (rate, where it was
    read) with the fraction reduced, or (None, why there is none): no
    timing, or a zero num_units_in_tick or time_scale.  ValueError where
    the SPS or VPS cannot be read."""
    if codec not in ("h264", "hevc") or not data:
        return None, "no H.264 or HEVC parameter set"
    timing, source = stream_vui(codec, data)["timing"], "the SPS's VUI"
    if timing is None and codec == "hevc":
        timing, source = _vps_timing(data), "the VPS"
    if timing is None:
        return None, ("no timing in the SPS's VUI" if codec == "h264" else
                      "no timing in the SPS's VUI or the VPS")
    nu, scale = timing
    if not nu or not scale:
        return None, (f"{source} states num_units_in_tick {nu} and "
                      f"time_scale {scale}, which is no rate")
    return Fraction(scale, nu * (2 if codec == "h264" else 1)), source


def stream_vui(codec: str, data: bytes) -> dict:
    """The VUI's {"sar", "timing"} of the first SPS in ``data``: an avcC
    or hvcC payload, or an annex-B stream.  Both None where there is no
    SPS; ValueError where the SPS cannot be read."""
    if codec not in ("h264", "hevc") or not data:
        return {"sar": None, "timing": None}
    for nal in _nals(codec, data):
        if codec == "h264" and nal and (nal[0] & 0x1F) == 7:
            rbsp = ebsp_to_rbsp(nal[1:])
            parse = h264_sps_vui
        elif codec == "hevc" and nal and ((nal[0] >> 1) & 0x3F) == 33:
            rbsp = ebsp_to_rbsp(nal[2:])
            parse = hevc_sps_vui
        else:
            continue
        try:
            return parse(rbsp)
        except (IndexError, ValueError) as e:
            raise ValueError(f"{codec}: the SPS cannot be read up to its "
                             f"VUI ({e or 'cut short'})") from None
    return {"sar": None, "timing": None}
