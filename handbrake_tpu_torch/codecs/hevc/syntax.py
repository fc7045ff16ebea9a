"""HEVC high-level syntax: NAL framing, VPS/SPS/PPS, slice segment headers.

Configured for the encoder's operating point: Main profile, one slice per
picture, CTB 32 = min CB 32 (no CU quadtree), TU = CU (no RQT), SAO and
deblocking off, one reference picture, TMVP off, MaxNumMergeCand = 1.
Writers and parsers are symmetric; the parsers reject streams outside this
subset loudly rather than mis-decoding.

Role of the reference's encx265.c parameter plumbing + extradata.c hvcC
building (SURVEY.md §2.5).
"""
from __future__ import annotations

import dataclasses

from ..h264.bits import BitReader, BitWriter, ebsp_to_rbsp, rbsp_to_ebsp
from ..vui import SAR_TABLE

# NAL unit types (Table 7-1)
NAL_TRAIL_R = 1
NAL_IDR_W_RADL = 19
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34


def nal_unit(nal_type: int, rbsp: bytes, annexb: bool = True) -> bytes:
    hdr = bytes([(nal_type << 1) & 0x7E, 1])  # layer 0, tid+1 = 1
    payload = hdr + rbsp_to_ebsp(rbsp)
    return (b"\x00\x00\x00\x01" + payload) if annexb else payload


def parse_nal_header(data: bytes) -> int:
    return (data[0] >> 1) & 0x3F


def _write_ptl(bw: BitWriter, level_idc: int, profile_idc: int = 1):
    """profile_tier_level, general only (Main / Main 10, Main tier)."""
    bw.put(0, 2)           # general_profile_space
    bw.put(0, 1)           # general_tier_flag
    bw.put(profile_idc, 5)  # 1 = Main, 2 = Main 10
    bw.put(1 << (31 - profile_idc), 32)  # compatibility flag[profile_idc]
    bw.put(1, 1)           # progressive_source
    bw.put(0, 1)           # interlaced_source
    bw.put(1, 1)           # non_packed_constraint
    bw.put(1, 1)           # frame_only_constraint
    bw.put(0, 32)          # reserved 44 bits
    bw.put(0, 12)
    bw.put(level_idc, 8)


def _read_ptl(br: BitReader) -> int:
    br.u(2 + 1 + 5)
    br.u(32)
    br.u(4)
    br.u(32)
    br.u(12)
    return br.u(8)


@dataclasses.dataclass
class VPS:
    level_idc: int = 120
    bit_depth: int = 8

    def to_nal(self) -> bytes:
        bw = BitWriter()
        bw.put(0, 4)   # vps_video_parameter_set_id
        bw.put(3, 2)   # base_layer_internal/available
        bw.put(0, 6)   # vps_max_layers_minus1
        bw.put(0, 3)   # vps_max_sub_layers_minus1
        bw.put(1, 1)   # vps_temporal_id_nesting_flag
        bw.put(0xFFFF, 16)
        _write_ptl(bw, self.level_idc, 2 if self.bit_depth > 8 else 1)
        bw.put(1, 1)   # vps_sub_layer_ordering_info_present
        bw.ue(1)       # max_dec_pic_buffering_minus1
        bw.ue(0)       # max_num_reorder_pics
        bw.ue(0)       # max_latency_increase_plus1
        bw.put(0, 6)   # vps_max_layer_id
        bw.ue(0)       # vps_num_layer_sets_minus1
        bw.put(0, 1)   # vps_timing_info_present
        bw.put(0, 1)   # vps_extension
        bw.rbsp_trailing()
        return nal_unit(NAL_VPS, bw.get_rbsp())


@dataclasses.dataclass
class SPS:
    width: int = 0                 # coded (padded) luma width, mult of 32
    height: int = 0
    crop_right: int = 0            # conformance window, luma samples
    crop_bottom: int = 0
    level_idc: int = 120
    log2_max_poc_lsb: int = 8
    vui_timing: tuple | None = None  # (num_units_in_tick, time_scale)
    bit_depth: int = 8             # 8 (Main) or 10 (Main 10)
    sar: tuple = (1, 1)            # VUI aspect: Extended_SAR unless 1:1

    LOG2_CTB = 5                   # CTB = min CB = 32

    def to_nal(self) -> bytes:
        bw = BitWriter()
        bw.put(0, 4)   # sps_video_parameter_set_id
        bw.put(0, 3)   # sps_max_sub_layers_minus1
        bw.put(1, 1)   # sps_temporal_id_nesting_flag
        _write_ptl(bw, self.level_idc, 2 if self.bit_depth > 8 else 1)
        bw.ue(0)       # sps_seq_parameter_set_id
        bw.ue(1)       # chroma_format_idc = 4:2:0
        bw.ue(self.width)
        bw.ue(self.height)
        if self.crop_right or self.crop_bottom:
            bw.put(1, 1)
            bw.ue(0)
            bw.ue(self.crop_right // 2)
            bw.ue(0)
            bw.ue(self.crop_bottom // 2)
        else:
            bw.put(0, 1)
        bw.ue(self.bit_depth - 8)   # bit_depth_luma_minus8
        bw.ue(self.bit_depth - 8)   # bit_depth_chroma_minus8
        bw.ue(self.log2_max_poc_lsb - 4)
        bw.put(1, 1)   # sps_sub_layer_ordering_info_present
        bw.ue(1)       # max_dec_pic_buffering_minus1
        bw.ue(0)       # max_num_reorder_pics
        bw.ue(0)       # max_latency_increase_plus1
        bw.ue(2)       # log2_min_luma_coding_block_size_minus3 -> 32
        bw.ue(0)       # log2_diff_max_min_luma_coding_block_size
        bw.ue(0)       # log2_min_luma_transform_block_size_minus2 -> 4
        bw.ue(3)       # log2_diff_max_min_luma_transform_block_size -> 32
        bw.ue(0)       # max_transform_hierarchy_depth_inter
        bw.ue(0)       # max_transform_hierarchy_depth_intra
        bw.put(0, 1)   # scaling_list_enabled
        bw.put(0, 1)   # amp_enabled
        bw.put(0, 1)   # sample_adaptive_offset_enabled
        bw.put(0, 1)   # pcm_enabled
        bw.ue(0)       # num_short_term_ref_pic_sets
        bw.put(0, 1)   # long_term_ref_pics_present
        bw.put(0, 1)   # sps_temporal_mvp_enabled
        bw.put(0, 1)   # strong_intra_smoothing_enabled
        if self.vui_timing is not None:
            bw.put(1, 1)   # vui_parameters_present
            if self.sar != (1, 1):
                bw.put(1, 1)   # aspect_ratio_info_present
                bw.put(255, 8)  # Extended_SAR
                bw.put(self.sar[0], 16)
                bw.put(self.sar[1], 16)
            else:
                bw.put(0, 1)   # aspect_ratio_info_present
            bw.put(0, 1)   # overscan_info_present
            bw.put(0, 1)   # video_signal_type_present
            bw.put(0, 1)   # chroma_loc_info_present
            bw.put(0, 1)   # neutral_chroma_indication
            bw.put(0, 1)   # field_seq
            bw.put(0, 1)   # frame_field_info_present
            bw.put(0, 1)   # default_display_window
            bw.put(1, 1)   # vui_timing_info_present
            bw.put(self.vui_timing[0], 32)
            bw.put(self.vui_timing[1], 32)
            bw.put(0, 1)   # poc_proportional_to_timing
            bw.put(0, 1)   # vui_hrd_parameters_present
            bw.put(0, 1)   # bitstream_restriction
        else:
            bw.put(0, 1)
        bw.put(0, 1)   # sps_extension
        bw.rbsp_trailing()
        return nal_unit(NAL_SPS, bw.get_rbsp())

    @classmethod
    def parse(cls, rbsp: bytes) -> "SPS":
        br = BitReader(rbsp)
        br.u(4 + 3 + 1)
        level = _read_ptl(br)
        assert br.ue() == 0, "sps id"
        assert br.ue() == 1, "chroma_format"
        w = br.ue()
        h = br.ue()
        cr = cb = 0
        if br.u(1):
            br.ue()
            cr = br.ue() * 2
            br.ue()
            cb = br.ue() * 2
        bd = br.ue() + 8
        bdc = br.ue() + 8
        assert bd == bdc and bd in (8, 10, 12), "luma/chroma depth must match"
        log2poc = br.ue() + 4
        if br.u(1):
            br.ue()
            br.ue()
            br.ue()
        assert br.ue() == 2 and br.ue() == 0, "CTB32 subset"
        assert br.ue() == 0 and br.ue() == 3, "TU subset"
        br.ue()
        br.ue()
        assert br.u(1) == 0, "scaling lists unsupported"
        br.u(1)
        assert br.u(1) == 0, "SAO unsupported"
        assert br.u(1) == 0, "PCM unsupported"
        assert br.ue() == 0, "sps RPS unsupported"
        br.u(1)
        assert br.u(1) == 0, "TMVP unsupported"
        br.u(1)
        vui = None
        sar = (1, 1)
        if br.u(1):
            if br.u(1):    # aspect_ratio_info_present
                idc = br.u(8)
                sar = (br.u(16), br.u(16)) if idc == 255 \
                    else SAR_TABLE.get(idc, (1, 1))
            br.u(7)
            if br.u(1):
                vui = (br.u(32), br.u(32))
        return cls(width=w, height=h, crop_right=cr, crop_bottom=cb,
                   level_idc=level, log2_max_poc_lsb=log2poc,
                   vui_timing=vui, bit_depth=bd, sar=sar)


@dataclasses.dataclass
class PPS:
    init_qp: int = 26

    def to_nal(self) -> bytes:
        bw = BitWriter()
        bw.ue(0)       # pps_pic_parameter_set_id
        bw.ue(0)       # pps_seq_parameter_set_id
        bw.put(0, 1)   # dependent_slice_segments_enabled
        bw.put(0, 1)   # output_flag_present
        bw.put(0, 3)   # num_extra_slice_header_bits
        bw.put(0, 1)   # sign_data_hiding_enabled
        bw.put(0, 1)   # cabac_init_present
        bw.ue(0)       # num_ref_idx_l0_default_active_minus1
        bw.ue(0)       # num_ref_idx_l1_default_active_minus1
        bw.se(self.init_qp - 26)
        bw.put(0, 1)   # constrained_intra_pred
        bw.put(0, 1)   # transform_skip_enabled
        bw.put(0, 1)   # cu_qp_delta_enabled
        bw.se(0)       # pps_cb_qp_offset
        bw.se(0)       # pps_cr_qp_offset
        bw.put(0, 1)   # pps_slice_chroma_qp_offsets_present
        bw.put(0, 1)   # weighted_pred
        bw.put(0, 1)   # weighted_bipred
        bw.put(0, 1)   # transquant_bypass_enabled
        bw.put(0, 1)   # tiles_enabled
        bw.put(0, 1)   # entropy_coding_sync_enabled
        bw.put(1, 1)   # pps_loop_filter_across_slices_enabled
        bw.put(1, 1)   # deblocking_filter_control_present
        bw.put(0, 1)   # deblocking_filter_override_enabled
        bw.put(1, 1)   # pps_deblocking_filter_disabled
        bw.put(0, 1)   # pps_scaling_list_data_present
        bw.put(0, 1)   # lists_modification_present
        bw.ue(0)       # log2_parallel_merge_level_minus2
        bw.put(0, 1)   # slice_segment_header_extension_present
        bw.put(0, 1)   # pps_extension
        bw.rbsp_trailing()
        return nal_unit(NAL_PPS, bw.get_rbsp())

    @classmethod
    def parse(cls, rbsp: bytes) -> "PPS":
        br = BitReader(rbsp)
        assert br.ue() == 0 and br.ue() == 0
        br.u(1 + 1 + 3)
        assert br.u(1) == 0, "SDH unsupported"
        assert br.u(1) == 0, "cabac_init unsupported"
        assert br.ue() == 0 and br.ue() == 0, "one ref"
        qp = br.se() + 26
        br.u(1)
        assert br.u(1) == 0, "transform_skip unsupported"
        assert br.u(1) == 0, "cu_qp_delta unsupported"
        assert br.se() == 0 and br.se() == 0
        br.u(1 + 1 + 1 + 1)
        assert br.u(1) == 0, "tiles unsupported"
        assert br.u(1) == 0, "WPP unsupported"
        br.u(1)
        if br.u(1):  # deblocking control present
            br.u(1)
            assert br.u(1) == 1, "deblocking must be disabled"
        return cls(init_qp=qp)


SLICE_B, SLICE_P, SLICE_I = 0, 1, 2


@dataclasses.dataclass
class SliceHeader:
    slice_type: int = SLICE_I
    idr: bool = False
    poc_lsb: int = 0
    qp: int = 26
    max_merge: int = 1

    def write(self, sps: SPS, pps: PPS) -> BitWriter:
        bw = BitWriter()
        bw.put(1, 1)            # first_slice_segment_in_pic_flag
        if self.idr:
            bw.put(0, 1)        # no_output_of_prior_pics_flag
        bw.ue(0)                # slice_pic_parameter_set_id
        bw.ue(self.slice_type)
        if not self.idr:
            bw.put(self.poc_lsb, sps.log2_max_poc_lsb)
            bw.put(0, 1)        # short_term_ref_pic_set_sps_flag
            bw.ue(1)            # num_negative_pics
            bw.ue(0)            # num_positive_pics
            bw.ue(0)            # delta_poc_s0_minus1
            bw.put(1, 1)        # used_by_curr_pic_s0_flag
        if self.slice_type == SLICE_P:
            bw.put(0, 1)        # num_ref_idx_active_override_flag
            bw.ue(5 - self.max_merge)  # five_minus_max_num_merge_cand
        bw.se(self.qp - pps.init_qp)
        bw.put(1, 1)            # byte_alignment: stop bit
        bw.byte_align_zero()
        return bw

    @classmethod
    def parse(cls, br: BitReader, sps: SPS, pps: PPS,
              nal_type: int) -> "SliceHeader":
        idr = nal_type == NAL_IDR_W_RADL
        assert br.u(1) == 1, "multi-slice unsupported"
        if idr:
            br.u(1)
        assert br.ue() == 0
        st = br.ue()
        poc = 0
        if not idr:
            poc = br.u(sps.log2_max_poc_lsb)
            assert br.u(1) == 0
            nneg = br.ue()
            npos = br.ue()
            assert nneg == 1 and npos == 0, "single-ref subset"
            br.ue()
            br.u(1)
        max_merge = 1
        if st == SLICE_P:
            assert br.u(1) == 0
            max_merge = 5 - br.ue()
        qp = br.se() + pps.init_qp
        assert br.u(1) == 1
        while br.pos % 8:
            br.u(1)
        return cls(slice_type=st, idr=idr, poc_lsb=poc, qp=qp,
                   max_merge=max_merge)


def split_annexb(data: bytes):
    """Yield (nal_type, rbsp) for each NAL in an annex-B HEVC stream."""
    from ..h264.bits import split_annexb as _split
    for payload in _split(data):
        if len(payload) < 3:
            continue
        yield parse_nal_header(payload), ebsp_to_rbsp(payload[2:])
