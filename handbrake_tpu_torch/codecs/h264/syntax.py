"""H.264 high-level syntax: SPS, PPS, slice headers (write + parse).

Encoder profile: Baseline/Main-compatible CAVLC streams — I + P slices,
one reference frame, pic_order_cnt_type=2, optional deblocking control.
Reference-parity role: encx264.c's header plumbing + nal_units.c/extradata.c
(avcC construction lives in mux/).
"""
from __future__ import annotations

import dataclasses

from .bits import BitReader, BitWriter, nal_unit

NAL_SLICE = 1
NAL_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8

SLICE_P = 0
SLICE_B = 1
SLICE_I = 2


@dataclasses.dataclass
class SPS:
    profile_idc: int = 66           # Baseline (constrained)
    level_idc: int = 40
    sps_id: int = 0
    log2_max_frame_num: int = 8
    pic_order_cnt_type: int = 2
    max_num_ref_frames: int = 1
    width_mbs: int = 0              # pic width in MBs
    height_mbs: int = 0
    crop_right: int = 0             # luma samples
    crop_bottom: int = 0
    vui_timing: tuple = ()          # (num_units_in_tick, time_scale) or ()
    sar: tuple = (1, 1)

    def write(self) -> bytes:
        bw = BitWriter()
        bw.put(self.profile_idc, 8)
        # constraint_set0..5 + reserved: set0/1 for baseline/main compat
        bw.put(0b11000000 if self.profile_idc == 66 else 0, 8)
        bw.put(self.level_idc, 8)
        bw.ue(self.sps_id)
        if self.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128):
            bw.ue(1)        # chroma_format_idc 4:2:0
            bw.ue(0)        # bit_depth_luma_minus8
            bw.ue(0)        # bit_depth_chroma_minus8
            bw.put_bit(0)   # qpprime_y_zero_transform_bypass
            bw.put_bit(0)   # seq_scaling_matrix_present
        bw.ue(self.log2_max_frame_num - 4)
        bw.ue(self.pic_order_cnt_type)
        if self.pic_order_cnt_type == 0:
            bw.ue(12)  # log2_max_pic_order_cnt_lsb_minus4... unused path
        bw.ue(self.max_num_ref_frames)
        bw.put_bit(0)  # gaps_in_frame_num_value_allowed
        bw.ue(self.width_mbs - 1)
        bw.ue(self.height_mbs - 1)
        bw.put_bit(1)  # frame_mbs_only
        bw.put_bit(1)  # direct_8x8_inference
        have_crop = self.crop_right or self.crop_bottom
        bw.put_bit(1 if have_crop else 0)
        if have_crop:
            bw.ue(0)
            bw.ue(self.crop_right // 2)
            bw.ue(0)
            bw.ue(self.crop_bottom // 2)
        # VUI
        have_vui = bool(self.vui_timing) or self.sar != (1, 1)
        bw.put_bit(1 if have_vui else 0)
        if have_vui:
            if self.sar != (1, 1):
                bw.put_bit(1)
                bw.put(255, 8)  # Extended_SAR
                bw.put(self.sar[0], 16)
                bw.put(self.sar[1], 16)
            else:
                bw.put_bit(0)
            bw.put_bit(0)  # overscan
            bw.put_bit(0)  # video_signal_type
            bw.put_bit(0)  # chroma_loc
            if self.vui_timing:
                bw.put_bit(1)
                bw.put(self.vui_timing[0], 32)
                bw.put(self.vui_timing[1], 32)
                bw.put_bit(1)  # fixed_frame_rate
            else:
                bw.put_bit(0)
            bw.put_bit(0)  # nal_hrd
            bw.put_bit(0)  # vcl_hrd
            bw.put_bit(0)  # pic_struct_present
            bw.put_bit(0)  # bitstream_restriction
        bw.rbsp_trailing()
        return bw.get_rbsp()

    def to_nal(self, annexb=True) -> bytes:
        return nal_unit(3, NAL_SPS, self.write(), annexb)

    @property
    def width(self):
        return self.width_mbs * 16 - self.crop_right

    @property
    def height(self):
        return self.height_mbs * 16 - self.crop_bottom

    @staticmethod
    def parse(rbsp: bytes) -> "SPS":
        br = BitReader(rbsp)
        s = SPS()
        s.profile_idc = br.u(8)
        br.u(8)
        s.level_idc = br.u(8)
        s.sps_id = br.ue()
        if s.profile_idc in (100, 110, 122, 244, 44, 83, 86, 118, 128):
            chroma = br.ue()
            if chroma == 3:
                br.u(1)
            br.ue()  # bit_depth_luma_minus8
            br.ue()  # bit_depth_chroma_minus8
            br.u(1)  # qpprime
            if br.u(1):  # seq_scaling_matrix_present
                raise NotImplementedError("scaling matrices")
        s.log2_max_frame_num = br.ue() + 4
        s.pic_order_cnt_type = br.ue()
        if s.pic_order_cnt_type == 0:
            br.ue()
        elif s.pic_order_cnt_type == 1:
            br.u(1)
            br.se()
            br.se()
            n = br.ue()
            for _ in range(n):
                br.se()
        s.max_num_ref_frames = br.ue()
        br.u(1)
        s.width_mbs = br.ue() + 1
        s.height_mbs = br.ue() + 1
        frame_mbs_only = br.u(1)
        if not frame_mbs_only:
            br.u(1)
        br.u(1)
        if br.u(1):  # cropping
            cl = br.ue()
            cr = br.ue()
            ct = br.ue()
            cb = br.ue()
            s.crop_right = 2 * (cl + cr)
            s.crop_bottom = 2 * (ct + cb) * (1 if frame_mbs_only else 2)
        return s


@dataclasses.dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    pic_init_qp: int = 26
    deblocking_filter_control_present: bool = True
    chroma_qp_index_offset: int = 0
    cabac: bool = False            # entropy_coding_mode_flag
    transform_8x8: bool = False    # transform_8x8_mode_flag (High)

    def write(self) -> bytes:
        bw = BitWriter()
        bw.ue(self.pps_id)
        bw.ue(self.sps_id)
        bw.put_bit(1 if self.cabac else 0)  # entropy_coding_mode
        bw.put_bit(0)  # bottom_field_pic_order_in_frame_present
        bw.ue(0)       # num_slice_groups_minus1
        bw.ue(0)       # num_ref_idx_l0_default_active_minus1
        bw.ue(0)       # num_ref_idx_l1_default_active_minus1
        bw.put_bit(0)  # weighted_pred
        bw.put(0, 2)   # weighted_bipred_idc
        bw.se(self.pic_init_qp - 26)
        bw.se(0)       # pic_init_qs
        bw.se(self.chroma_qp_index_offset)
        bw.put_bit(1 if self.deblocking_filter_control_present else 0)
        bw.put_bit(0)  # constrained_intra_pred
        bw.put_bit(0)  # redundant_pic_cnt_present
        if self.transform_8x8:
            # optional trailer (present via more_rbsp_data, spec 7.3.2.2)
            bw.put_bit(1)  # transform_8x8_mode_flag
            bw.put_bit(0)  # pic_scaling_matrix_present
            bw.se(self.chroma_qp_index_offset)  # second_chroma_qp_offset
        bw.rbsp_trailing()
        return bw.get_rbsp()

    def to_nal(self, annexb=True) -> bytes:
        return nal_unit(3, NAL_PPS, self.write(), annexb)

    @staticmethod
    def parse(rbsp: bytes) -> "PPS":
        br = BitReader(rbsp)
        p = PPS()
        p.pps_id = br.ue()
        p.sps_id = br.ue()
        p.cabac = bool(br.u(1))
        br.u(1)
        nsg = br.ue()
        if nsg:
            raise NotImplementedError("slice groups")
        br.ue()
        br.ue()
        br.u(1)
        br.u(2)
        p.pic_init_qp = br.se() + 26
        br.se()
        p.chroma_qp_index_offset = br.se()
        p.deblocking_filter_control_present = bool(br.u(1))
        br.u(1)
        br.u(1)
        return p


@dataclasses.dataclass
class SliceHeader:
    slice_type: int = SLICE_I      # SLICE_P / SLICE_B / SLICE_I
    first_mb: int = 0
    pps_id: int = 0
    frame_num: int = 0
    idr: bool = False
    idr_pic_id: int = 0
    qp: int = 26
    disable_deblocking: int = 1     # 0=on 1=off 2=no cross-slice
    num_ref_idx_override: bool = False
    poc_lsb: int = 0                # pic_order_cnt_lsb (poc type 0)
    is_ref: bool = True             # nal_ref_idc != 0 → marking present
    direct_spatial: bool = True     # B: direct_spatial_mv_pred_flag
    num_ref_l0: int = 1             # active refs (override vs PPS default 1)
    num_ref_l1: int = 1

    def write(self, sps: SPS, pps: PPS) -> BitWriter:
        bw = BitWriter()
        bw.ue(self.first_mb)
        bw.ue(self.slice_type + 5)  # +5: all slices in pic share type
        bw.ue(self.pps_id)
        bw.put(self.frame_num & ((1 << sps.log2_max_frame_num) - 1),
               sps.log2_max_frame_num)
        if self.idr:
            bw.ue(self.idr_pic_id)
        if sps.pic_order_cnt_type == 0:
            bw.put(self.poc_lsb & 0xFFFF, 16)
        if self.slice_type == SLICE_B:
            bw.put_bit(1 if self.direct_spatial else 0)
        if self.slice_type in (SLICE_P, SLICE_B):
            override = (self.num_ref_l0 != 1
                        or (self.slice_type == SLICE_B
                            and self.num_ref_l1 != 1))
            bw.put_bit(1 if override else 0)
            if override:
                bw.ue(self.num_ref_l0 - 1)
                if self.slice_type == SLICE_B:
                    bw.ue(self.num_ref_l1 - 1)
            bw.put_bit(0)  # ref_pic_list_modification_flag_l0
            if self.slice_type == SLICE_B:
                bw.put_bit(0)  # ref_pic_list_modification_flag_l1
        # dec_ref_pic_marking: only when nal_ref_idc != 0 (spec 7.3.3)
        if self.idr:
            bw.put_bit(0)  # no_output_of_prior_pics
            bw.put_bit(0)  # long_term_reference_flag
        elif self.is_ref:
            bw.put_bit(0)  # adaptive_ref_pic_marking_mode_flag
        if pps.cabac and self.slice_type != SLICE_I:
            bw.ue(0)       # cabac_init_idc
        bw.se(self.qp - pps.pic_init_qp)
        if pps.deblocking_filter_control_present:
            bw.ue(self.disable_deblocking)
            if self.disable_deblocking != 1:
                bw.se(0)  # slice_alpha_c0_offset_div2
                bw.se(0)  # slice_beta_offset_div2
        return bw

    @staticmethod
    def parse(br: BitReader, sps: SPS, pps: PPS, nal_type: int) -> "SliceHeader":
        h = SliceHeader()
        h.first_mb = br.ue()
        st = br.ue()
        h.slice_type = st % 5
        h.pps_id = br.ue()
        h.frame_num = br.u(sps.log2_max_frame_num)
        h.idr = (nal_type == NAL_IDR)
        if h.idr:
            h.idr_pic_id = br.ue()
        if sps.pic_order_cnt_type == 0:
            br.u(16)
        if h.slice_type == SLICE_P:
            if br.u(1):
                br.ue()
            if br.u(1):
                raise NotImplementedError("ref list modification")
        if h.idr:
            br.u(1)
            br.u(1)
        else:
            if br.u(1):
                raise NotImplementedError("adaptive ref marking")
        if pps.cabac and h.slice_type != SLICE_I:
            br.ue()        # cabac_init_idc
        h.qp = pps.pic_init_qp + br.se()
        if pps.deblocking_filter_control_present:
            h.disable_deblocking = br.ue()
            if h.disable_deblocking != 1:
                br.se()
                br.se()
        return h
