// hbdec264 — universal H.264 decoder (host native stage).
//
// Role of decavcodec.c's video personality (decodeFrame decavcodec.c:1709):
// decode *anyone's* H.264 — not just this framework's own encoder output.
// Scope: progressive 4:2:0 8-bit, frame_mbs_only streams (what x264/FFmpeg
// emit for the overwhelming majority of real-world content): CAVLC + CABAC
// entropy, I/P/B slices, Intra_4x4/8x8*/16x16/PCM, all inter partition
// shapes down to 4x4, multiple reference frames with list reordering,
// weighted prediction, POC types 0/2, in-loop deblocking, per-MB QP.
// (* 8x8 transform support arrives with the High-profile encoder work.)
//
// Built from the ITU-T H.264 spec; CABAC constant tables come from
// cabac_tables_h264.h (see extract_fftables.py for provenance).  Bit-exact
// conformance against libavcodec is enforced by tests/test_h264_decoder.py.
//
// Entropy decode is inherently serial → host C++ (SURVEY.md §7 hard part
// 1); inverse transform / MC / deblock are candidates for the device path
// later (same split the hwaccel layer makes, hwaccel.c:15).
#include <stdint.h>
#include <string.h>
#include <stdlib.h>
#include <stdio.h>
#include <vector>
#include <map>
#include <memory>
#include <algorithm>
#include "cabac_tables_h264.h"

namespace hbdec {

static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }
static inline int iclip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}
static inline uint8_t clip255(int v) {
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}
static inline int med3(int a, int b, int c) {
    int mx = imax(a, imax(b, c)), mn = imin(a, imin(b, c));
    return a + b + c - mx - mn;
}

// ---------------------------------------------------------------------------
// Bit reader over RBSP (caller strips emulation-prevention bytes)
// ---------------------------------------------------------------------------
struct BR {
    const uint8_t* d;
    int n;            // bytes
    int pos;          // bit position
    bool err;

    void init(const uint8_t* data, int nbytes) {
        d = data; n = nbytes; pos = 0; err = false;
    }
    int bit() {
        if (pos >= n * 8) { err = true; return 0; }
        int b = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
        pos++;
        return b;
    }
    uint32_t u(int k) {
        uint32_t v = 0;
        while (k--) v = (v << 1) | bit();
        return v;
    }
    uint32_t ue() {
        int lz = 0;
        while (!bit()) {
            if (++lz > 31 || err) { err = true; return 0; }
        }
        return ((1u << lz) - 1) + (lz ? u(lz) : 0);
    }
    int32_t se() {
        uint32_t k = ue();
        return (k & 1) ? (int32_t)((k + 1) >> 1) : -(int32_t)(k >> 1);
    }
    bool more_rbsp() const {
        if (pos >= n * 8) return false;
        // stop-bit check: any bit set after pos other than trailing pattern
        for (int i = n * 8 - 1; i >= pos; i--)
            if ((d[i >> 3] >> (7 - (i & 7))) & 1)
                return i != pos ? true : false;  // pos itself = stop bit
        return false;
    }
};

// ---------------------------------------------------------------------------
// Parameter sets
// ---------------------------------------------------------------------------
struct SPSd {
    int profile_idc = 0, level_idc = 0;
    int chroma_format_idc = 1;
    int bit_depth_luma = 8, bit_depth_chroma = 8;
    int log2_max_frame_num = 4;
    int poc_type = 0;
    int log2_max_poc_lsb = 4;
    int delta_pic_order_always_zero = 0;
    int offset_for_non_ref_pic = 0, offset_for_top_to_bottom = 0;
    std::vector<int> offset_for_ref_frame;
    int max_num_ref_frames = 1;
    int gaps_allowed = 0;
    int mb_w = 0, mb_h = 0;
    int frame_mbs_only = 1;
    int direct_8x8_inference = 1;
    int crop_l = 0, crop_r = 0, crop_t = 0, crop_b = 0;
    uint8_t scaling4[6][16];
    uint8_t scaling8[6][64];
    bool seq_scaling_present = false;
    bool valid = false;
};

struct PPSd {
    int sps_id = 0;
    int cabac = 0;
    int pic_order_present = 0;
    int num_ref_idx_default[2] = {1, 1};
    int weighted_pred = 0, weighted_bipred_idc = 0;
    int pic_init_qp = 26;
    int chroma_qp_offset[2] = {0, 0};   // [0]=cb, [1]=cr (2nd from High ext)
    int deblocking_control_present = 0;
    int constrained_intra = 0;
    int redundant_pic_cnt_present = 0;
    int transform_8x8_mode = 0;
    uint8_t scaling4[6][16];
    uint8_t scaling8[6][64];
    bool pic_scaling_present = false;
    bool valid = false;
};

// default scaling matrices (Tables 7-3/7-4), de-zigzagged to raster order
static const uint8_t kDefaultScaling4Intra[16] = {
     6, 13, 20, 28, 13, 20, 28, 32, 20, 28, 32, 37, 28, 32, 37, 42};
static const uint8_t kDefaultScaling4Inter[16] = {
    10, 14, 20, 24, 14, 20, 24, 27, 20, 24, 27, 30, 24, 27, 30, 34};
static const uint8_t kDefaultScaling8Intra[64] = {
     6, 10, 13, 16, 18, 23, 25, 27, 10, 11, 16, 18, 23, 25, 27, 29,
    13, 16, 18, 23, 25, 27, 29, 31, 16, 18, 23, 25, 27, 29, 31, 33,
    18, 23, 25, 27, 29, 31, 33, 36, 23, 25, 27, 29, 31, 33, 36, 38,
    25, 27, 29, 31, 33, 36, 38, 40, 27, 29, 31, 33, 36, 38, 40, 42};
static const uint8_t kDefaultScaling8Inter[64] = {
     9, 13, 15, 17, 19, 21, 22, 24, 13, 13, 17, 19, 21, 22, 24, 25,
    15, 17, 19, 21, 22, 24, 25, 27, 17, 19, 21, 22, 24, 25, 27, 28,
    19, 21, 22, 24, 25, 27, 28, 30, 21, 22, 24, 25, 27, 28, 30, 32,
    22, 24, 25, 27, 28, 30, 32, 33, 24, 25, 27, 28, 30, 32, 33, 35};

// zigzag scans
static const uint8_t kZig4[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10,
                                  7, 11, 14, 15};
static const uint8_t kZig8[64] = {
     0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// scaling_list parse (spec 7.3.2.1.1.1)
static void scaling_list(BR& br, uint8_t* sl, int size,
                         const uint8_t* fallback, const uint8_t* def) {
    int last = 8, next = 8;
    bool use_default = false;
    const uint8_t* scan = size == 16 ? kZig4 : kZig8;
    for (int i = 0; i < size; i++) {
        if (next != 0) {
            int delta = br.se();
            next = (last + delta + 256) & 255;
            if (i == 0 && next == 0) { use_default = true; break; }
        }
        sl[scan[i]] = next == 0 ? last : next;
        last = sl[scan[i]];
    }
    if (use_default) memcpy(sl, def, size);
    (void)fallback;
}

// dequant level-scale tables (spec 8.5.9): normAdjust4x4[m][i]
static const int kV4[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16},
                              {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
static inline int v4_idx(int i) {
    int r = i >> 2, c = i & 3;
    if ((r & 1) == 0 && (c & 1) == 0) return 0;
    if ((r & 1) == 1 && (c & 1) == 1) return 1;
    return 2;
}
// 8x8 normAdjust (spec Table 8-15 column sets)
static const int kV8[6][6] = {
    {20, 18, 32, 19, 25, 24}, {22, 19, 35, 21, 28, 26},
    {26, 23, 42, 24, 33, 31}, {28, 25, 45, 26, 35, 33},
    {32, 28, 51, 30, 40, 38}, {36, 32, 58, 34, 46, 43}};
static inline int v8_idx(int i) {
    int r = i >> 3, c = i & 7;
    int rm = r & 3, cm = c & 3;
    if (rm == 0 && cm == 0) return 0;
    if ((r & 1) == 1 && (c & 1) == 1) return 1;
    if (rm == 2 && cm == 2) return 2;
    if ((rm == 0 && (c & 1) == 1) || ((r & 1) == 1 && cm == 0)) return 3;
    if ((rm == 0 && cm == 2) || (rm == 2 && cm == 0)) return 4;
    return 5;
}

static const uint8_t kChromaQpMap[52] = {
     0,  1,  2,  3,  4,  5,  6,  7,  8,  9, 10, 11, 12, 13, 14, 15, 16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30, 31, 32,
    32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39,
    39};

// ---------------------------------------------------------------------------
// Reference picture
// ---------------------------------------------------------------------------
struct Pic {
    std::vector<uint8_t> y, u, v;
    int w = 0, h = 0;               // luma dims (MB aligned)
    int poc = 0;
    int frame_num = 0;              // as coded
    int frame_num_wrap = 0;
    long pic_num = 0;
    bool ref = false;               // short-term reference
    bool long_term = false;
    int long_term_idx = 0;
    bool output_done = false;
    // motion info for temporal direct + co-located (per 4x4, list 0/1)
    std::vector<int16_t> mv[2];     // (mb_w*4 * mb_h*4) * 2
    std::vector<int8_t> refidx[2];
    std::vector<int> refpoc[2];     // POC of the referenced picture
    std::vector<uint8_t> intra4;    // per 4x4: block was intra
};

enum { I_SLICE = 2, P_SLICE = 0, B_SLICE = 1, SP_SLICE = 3, SI_SLICE = 4 };

struct SliceHdr {
    int first_mb = 0;
    int type = 0;                   // 0 P, 1 B, 2 I (mod 5)
    int pps_id = 0;
    int frame_num = 0;
    bool idr = false;
    int idr_pic_id = 0;
    int poc_lsb = 0;
    int delta_poc0 = 0, delta_poc1 = 0;
    int redundant_pic_cnt = 0;
    int direct_spatial = 1;
    int num_ref_idx[2] = {1, 1};
    int cabac_init_idc = 0;
    int qp = 26;
    int disable_deblock = 0;
    int alpha_off = 0, beta_off = 0;
    // ref list modification ops: list of (op, val) per list
    std::vector<std::pair<int, uint32_t>> reorder[2];
    // MMCO ops
    bool adaptive_marking = false;
    std::vector<std::pair<int, std::pair<uint32_t, uint32_t>>> mmco;
    bool no_output_prior = false, long_term_ref_flag = false;
    // weighted prediction
    int luma_log2_wd = 0, chroma_log2_wd = 0;
    struct Wt { int w, o; bool present; };
    Wt wp[2][32][3];               // [list][refidx][comp: y,cb,cr]
};

}  // namespace hbdec

namespace hbdec {

// ---------------------------------------------------------------------------
// CABAC decoding engine (spec 9.3.3.2)
// ---------------------------------------------------------------------------
struct CabacDec {
    const uint8_t* d;
    int nbytes;
    int bitpos;
    uint32_t range, offset;
    uint8_t state[1024], mps[1024];
    bool err;

    int bit() {
        if (bitpos >= nbytes * 8) { err = true; return 0; }
        int b = (d[bitpos >> 3] >> (7 - (bitpos & 7))) & 1;
        bitpos++;
        return b;
    }
    void init(const uint8_t* data, int n, int startbit, int slice_qp,
              bool i_slice, int init_idc) {
        d = data; nbytes = n; bitpos = startbit; err = false;
        range = 510;
        offset = 0;
        for (int i = 0; i < 9; i++) offset = (offset << 1) | bit();
        int qp = iclip(slice_qp, 0, 51);
        for (int i = 0; i < 1024; i++) {
            const int8_t* mn = i_slice ? kCabacInitI[i]
                                       : kCabacInitPB[init_idc][i];
            int pre = iclip(((mn[0] * qp) >> 4) + mn[1], 1, 126);
            if (pre <= 63) { state[i] = 63 - pre; mps[i] = 0; }
            else           { state[i] = pre - 64; mps[i] = 1; }
        }
    }
    int decode(int ctx) {
        int v = decode_inner(ctx);
        if (getenv("HBDEC_BINTRACE"))
            fprintf(stderr, "D %d %d\n", ctx, v);
        return v;
    }
    int decode_inner(int ctx) {
        uint32_t rlps = kRangeTabLPS[state[ctx]][(range >> 6) & 3];
        range -= rlps;
        int b;
        if (offset >= range) {
            b = 1 - mps[ctx];
            offset -= range;
            range = rlps;
            if (state[ctx] == 0) mps[ctx] ^= 1;
            state[ctx] = kTransIdxLPS[state[ctx]];
        } else {
            b = mps[ctx];
            state[ctx] = kTransIdxMPS[state[ctx]];
        }
        while (range < 256) {
            range <<= 1;
            offset = (offset << 1) | bit();
        }
        return b;
    }
    int bypass() {
        offset = (offset << 1) | bit();
        if (offset >= range) { offset -= range; return 1; }
        return 0;
    }
    int terminate() {
        range -= 2;
        if (offset >= range) return 1;
        while (range < 256) {
            range <<= 1;
            offset = (offset << 1) | bit();
        }
        return 0;
    }
    // UEGk suffix
    uint32_t eg(int k) {
        int lz = 0;
        while (bypass() && lz < 30) lz++;
        uint32_t v = 0;
        for (int i = 0; i < k + lz; i++) v = (v << 1) | bypass();
        return ((1u << lz) - 1 << k) + v;
    }
};

// ---------------------------------------------------------------------------
// CAVLC decode tables — built once from the spec-structured encode tables
// in cavlc_tables.h (generated by gen_tables.py).  Decoding walks prefix
// trees keyed on (len, bits).
// ---------------------------------------------------------------------------
struct VlcMap {
    // map from (len<<16 | code) → value; decode by extending bit by bit
    std::map<uint32_t, int> m;
    int maxlen = 0;
    void add(int len, uint32_t code, int value) {
        m[((uint32_t)len << 24) | code] = value;
        if (len > maxlen) maxlen = len;
    }
    // returns value or -1
    int read(BR& br) const {
        uint32_t code = 0;
        for (int len = 1; len <= maxlen; len++) {
            code = (code << 1) | br.bit();
            auto it = m.find(((uint32_t)len << 24) | code);
            if (it != m.end()) return it->second;
            if (br.err) return -1;
        }
        return -1;
    }
};

struct CavlcTables {
    VlcMap coeff_token[3];   // nC bands 0-1, 2-3, 4-7
    VlcMap coeff_token_cdc;  // chroma DC
    VlcMap total_zeros[16];  // [tc] for maxcoeff 15/16
    VlcMap total_zeros_cdc[4];
    VlcMap run_before[8];    // [min(zeros_left,7)]
    bool built = false;
};

}  // namespace hbdec

namespace hbdec {

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------
struct PicCtx {
    std::vector<uint8_t> blk_done;     // per luma 4x4: reconstructed
    std::vector<uint8_t> blk_parsed;   // per luma 4x4: syntax consumed
    std::vector<uint8_t> cblk_parsed[2];  // per chroma 4x4 (2x2 per MB)
    std::vector<int> mb_slice;         // slice id per MB (-1 = none)
    int slice_id = 0;
};

struct Dec {
    std::map<int, SPSd> spss;
    std::map<int, PPSd> ppss;
    SPSd sps;                       // active
    PPSd pps;
    bool have_size = false;
    int mb_w = 0, mb_h = 0, W = 0, H = 0;

    // DPB
    std::vector<std::unique_ptr<Pic>> dpb;   // reference + waiting-output
    std::unique_ptr<Pic> cur;
    std::vector<Pic*> ready;        // decoded pictures pending host fetch

    // POC state
    int prev_poc_msb = 0, prev_poc_lsb = 0;
    int prev_frame_num = 0, prev_frame_num_offset = 0;
    int last_idr_poc_base = 0;

    // current-picture decode state (per-MB / per-4x4 grids)
    SliceHdr sh;
    std::vector<Pic*> reflist[2];
    std::vector<int16_t> mv[2];        // per 4x4 (gw x gh) x2
    std::vector<int8_t> refidx[2];     // per 4x4; -1 = none/intra
    std::vector<int8_t> nnz_l;         // per 4x4 luma (TotalCoeff / cbf)
    std::vector<int8_t> nnz_c[2];      // per 4x4 chroma (2x2 grid per MB)
    std::vector<uint8_t> mb_intra, mb_skip, mb_i16, mb_dc_cbf, mb_pcm;
    std::vector<uint8_t> mb_cdc_cbf[2];
    std::vector<uint8_t> mb_cbp, mb_cmode, mb_t8x8;
    std::vector<uint8_t> mb_bds;       // B_Skip / B_Direct_16x16 (ctx 27)
    int16_t imp_w[32][32];             // implicit bipred w1 per (r0,r1)
    std::vector<int8_t> mb_qp;
    std::vector<int8_t> ipred4;        // per 4x4: intra4x4 pred mode (-1)
    std::vector<int16_t> mvd_grid[2];  // per 4x4 per comp: |mvd| for cabac
    std::vector<Pic*> refpic[2];       // resolved reference picture per 4x4
    std::vector<uint8_t> mv_done[2];   // motion decoded per 4x4 (decode order)
    std::vector<uint8_t> bdirect;      // 4x4 coded in B direct mode (ref ctx)
    std::vector<int8_t> mb_dbf_disable, mb_alpha_off, mb_beta_off;
    std::vector<uint8_t> mb_done;
    std::vector<uint8_t> mb_field;     // always 0 (progressive)
    int gw = 0, gh = 0;                // 4x4 grid dims
    int prev_qp_delta_nz = 0;
    int cur_qp = 26;
    int slice_count_cur_pic = 0;
    PicCtx pc;                         // this decoder's picture state

    CavlcTables vlc;
    CabacDec cb;
    bool err = false;
    char errmsg[256] = {0};

    int dq4[52][16];                   // dequant scale per qp (flat lists)
    int dq4i[52][16];                  // intra (same when flat)

    void fail(const char* m) {
        if (!err) {
            err = true;
            strncpy(errmsg, m, sizeof(errmsg) - 1);
        }
    }

    // ---------------- parameter sets ----------------
    void parse_sps(BR& br) {
        SPSd s;
        s.profile_idc = br.u(8);
        br.u(8);
        s.level_idc = br.u(8);
        int id = br.ue();
        for (int i = 0; i < 6; i++) {
            memset(s.scaling4[i], 16, 16);
            memset(s.scaling8[i], 16, 64);
        }
        if (s.profile_idc == 100 || s.profile_idc == 110 ||
            s.profile_idc == 122 || s.profile_idc == 244 ||
            s.profile_idc == 44 || s.profile_idc == 83 ||
            s.profile_idc == 86 || s.profile_idc == 118 ||
            s.profile_idc == 128 || s.profile_idc == 138) {
            s.chroma_format_idc = br.ue();
            if (s.chroma_format_idc == 3) br.u(1);
            s.bit_depth_luma = br.ue() + 8;
            s.bit_depth_chroma = br.ue() + 8;
            br.u(1);  // qpprime_y_zero_transform_bypass
            if (br.u(1)) {
                s.seq_scaling_present = true;
                for (int i = 0; i < 8; i++) {
                    if (br.u(1)) {
                        if (i < 6)
                            scaling_list(br, s.scaling4[i], 16, nullptr,
                                         i < 3 ? kDefaultScaling4Intra
                                               : kDefaultScaling4Inter);
                        else
                            scaling_list(br, s.scaling8[i - 6], 64, nullptr,
                                         (i & 1) == 0 ? kDefaultScaling8Intra
                                                      : kDefaultScaling8Inter);
                    } else {
                        // fall-back rule A (spec Table 7-2)
                        if (i == 0)
                            memcpy(s.scaling4[0], kDefaultScaling4Intra, 16);
                        else if (i == 3)
                            memcpy(s.scaling4[3], kDefaultScaling4Inter, 16);
                        else if (i < 6)
                            memcpy(s.scaling4[i], s.scaling4[i - 1], 16);
                        else if (i == 6)
                            memcpy(s.scaling8[0], kDefaultScaling8Intra, 64);
                        else
                            memcpy(s.scaling8[1], kDefaultScaling8Inter, 64);
                    }
                }
            }
        }
        s.log2_max_frame_num = br.ue() + 4;
        s.poc_type = br.ue();
        if (s.poc_type == 0) {
            s.log2_max_poc_lsb = br.ue() + 4;
        } else if (s.poc_type == 1) {
            s.delta_pic_order_always_zero = br.u(1);
            s.offset_for_non_ref_pic = br.se();
            s.offset_for_top_to_bottom = br.se();
            int n = br.ue();
            for (int i = 0; i < n; i++)
                s.offset_for_ref_frame.push_back(br.se());
        }
        s.max_num_ref_frames = br.ue();
        s.gaps_allowed = br.u(1);
        s.mb_w = br.ue() + 1;
        s.mb_h = br.ue() + 1;
        s.frame_mbs_only = br.u(1);
        if (!s.frame_mbs_only) {
            fail("interlaced (frame_mbs_only=0) unsupported");
            br.u(1);
        }
        s.direct_8x8_inference = br.u(1);
        if (br.u(1)) {
            s.crop_l = br.ue(); s.crop_r = br.ue();
            s.crop_t = br.ue(); s.crop_b = br.ue();
        }
        // VUI ignored (timing handled at demux layer)
        s.valid = !br.err;
        spss[id] = s;
    }

    void parse_pps(BR& br) {
        PPSd p;
        int id = br.ue();
        p.sps_id = br.ue();
        p.cabac = br.u(1);
        p.pic_order_present = br.u(1);
        int nsg = br.ue();
        if (nsg > 0) fail("FMO slice groups unsupported");
        p.num_ref_idx_default[0] = br.ue() + 1;
        p.num_ref_idx_default[1] = br.ue() + 1;
        p.weighted_pred = br.u(1);
        p.weighted_bipred_idc = br.u(2);
        p.pic_init_qp = br.se() + 26;
        br.se();  // pic_init_qs
        p.chroma_qp_offset[0] = p.chroma_qp_offset[1] = br.se();
        p.deblocking_control_present = br.u(1);
        p.constrained_intra = br.u(1);
        if (p.constrained_intra) fail("constrained_intra_pred unsupported");
        p.redundant_pic_cnt_present = br.u(1);
        for (int i = 0; i < 6; i++) {
            memset(p.scaling4[i], 16, 16);
            memset(p.scaling8[i], 16, 64);
        }
        if (br.more_rbsp()) {  // High profile extension
            p.transform_8x8_mode = br.u(1);
            if (br.u(1)) {
                p.pic_scaling_present = true;
                auto its = spss.find(p.sps_id);
                const SPSd* rs = its != spss.end() ? &its->second : nullptr;
                bool seq = rs && rs->valid && rs->seq_scaling_present;
                for (int i = 0; i < 6 + 2 * p.transform_8x8_mode; i++) {
                    if (br.u(1)) {
                        if (i < 6)
                            scaling_list(br, p.scaling4[i], 16, nullptr,
                                         i < 3 ? kDefaultScaling4Intra
                                               : kDefaultScaling4Inter);
                        else
                            scaling_list(br, p.scaling8[i - 6], 64, nullptr,
                                         (i & 1) == 0 ? kDefaultScaling8Intra
                                                      : kDefaultScaling8Inter);
                    } else if (seq) {
                        // fall-back rule B: 0/3/6/7 inherit the SPS list
                        if (i == 0 || i == 3)
                            memcpy(p.scaling4[i], rs->scaling4[i], 16);
                        else if (i < 6)
                            memcpy(p.scaling4[i], p.scaling4[i - 1], 16);
                        else
                            memcpy(p.scaling8[i - 6], rs->scaling8[i - 6],
                                   64);
                    } else {
                        // fall-back rule A
                        if (i == 0)
                            memcpy(p.scaling4[0], kDefaultScaling4Intra, 16);
                        else if (i == 3)
                            memcpy(p.scaling4[3], kDefaultScaling4Inter, 16);
                        else if (i < 6)
                            memcpy(p.scaling4[i], p.scaling4[i - 1], 16);
                        else if (i == 6)
                            memcpy(p.scaling8[0], kDefaultScaling8Intra, 64);
                        else
                            memcpy(p.scaling8[1], kDefaultScaling8Inter, 64);
                    }
                }
            }
            p.chroma_qp_offset[1] = br.se();
        }
        p.valid = !br.err;
        ppss[id] = p;
    }

    void build_dequant() {
        // flat-list dequant: LevelScale4x4(m,i) = norm * 16 (weight 16)
        for (int qp = 0; qp < 52; qp++)
            for (int i = 0; i < 16; i++) {
                dq4[qp][i] = kV4[qp % 6][v4_idx(i)] * 16;
                dq4i[qp][i] = dq4[qp][i];
            }
    }

    // ---------------- slice header ----------------
    bool parse_slice_header(BR& br, int nal_type, int nal_ref_idc) {
        sh = SliceHdr();
        sh.first_mb = br.ue();
        int st = br.ue();
        sh.type = st % 5;
        if (sh.type == SP_SLICE || sh.type == SI_SLICE) {
            fail("SP/SI slices unsupported");
            return false;
        }
        sh.pps_id = br.ue();
        auto itp = ppss.find(sh.pps_id);
        if (itp == ppss.end()) { fail("unknown PPS"); return false; }
        pps = itp->second;
        auto its = spss.find(pps.sps_id);
        if (its == spss.end()) { fail("unknown SPS"); return false; }
        sps = its->second;
        setup_size();
        sh.frame_num = br.u(sps.log2_max_frame_num);
        sh.idr = (nal_type == 5);
        if (sh.idr) sh.idr_pic_id = br.ue();
        if (sps.poc_type == 0) {
            sh.poc_lsb = br.u(sps.log2_max_poc_lsb);
            if (pps.pic_order_present) sh.delta_poc1 = br.se();
        } else if (sps.poc_type == 1 && !sps.delta_pic_order_always_zero) {
            sh.delta_poc0 = br.se();
            if (pps.pic_order_present) sh.delta_poc1 = br.se();
        }
        if (pps.redundant_pic_cnt_present) sh.redundant_pic_cnt = br.ue();
        if (sh.type == B_SLICE) sh.direct_spatial = br.u(1);
        sh.num_ref_idx[0] = pps.num_ref_idx_default[0];
        sh.num_ref_idx[1] = pps.num_ref_idx_default[1];
        if (sh.type == P_SLICE || sh.type == B_SLICE) {
            if (br.u(1)) {
                sh.num_ref_idx[0] = br.ue() + 1;
                if (sh.type == B_SLICE) sh.num_ref_idx[1] = br.ue() + 1;
            }
            // ref_pic_list_modification
            for (int l = 0; l < (sh.type == B_SLICE ? 2 : 1); l++) {
                if (br.u(1)) {
                    while (true) {
                        uint32_t op = br.ue();
                        if (op == 3 || br.err) break;
                        uint32_t val = br.ue();
                        sh.reorder[l].push_back({(int)op, val});
                    }
                }
            }
        }
        if ((pps.weighted_pred && sh.type == P_SLICE) ||
            (pps.weighted_bipred_idc == 1 && sh.type == B_SLICE)) {
            parse_pred_weight_table(br);
        } else {
            default_weights();
        }
        if (nal_ref_idc) {
            if (sh.idr) {
                sh.no_output_prior = br.u(1);
                sh.long_term_ref_flag = br.u(1);
            } else {
                sh.adaptive_marking = br.u(1);
                if (sh.adaptive_marking) {
                    while (true) {
                        uint32_t op = br.ue();
                        if (op == 0 || br.err) break;
                        uint32_t v1 = 0, v2 = 0;
                        if (op == 1 || op == 3) v1 = br.ue();
                        if (op == 2) v1 = br.ue();
                        if (op == 3 || op == 6) v2 = br.ue();
                        if (op == 4) v1 = br.ue();
                        sh.mmco.push_back({(int)op, {v1, v2}});
                    }
                }
            }
        }
        if (pps.cabac && sh.type != I_SLICE) sh.cabac_init_idc = br.ue();
        sh.qp = pps.pic_init_qp + br.se();
        if (pps.deblocking_control_present) {
            sh.disable_deblock = br.ue();
            if (sh.disable_deblock != 1) {
                sh.alpha_off = br.se() * 2;
                sh.beta_off = br.se() * 2;
            }
        }
        return !br.err;
    }

    void default_weights() {
        for (int l = 0; l < 2; l++)
            for (int r = 0; r < 32; r++)
                for (int c = 0; c < 3; c++)
                    sh.wp[l][r][c] = {c == 0 ? 1 : 1, 0, false};
        sh.luma_log2_wd = 0;
        sh.chroma_log2_wd = 0;
    }

    void parse_pred_weight_table(BR& br) {
        sh.luma_log2_wd = br.ue();
        sh.chroma_log2_wd = br.ue();
        for (int l = 0; l < (sh.type == B_SLICE ? 2 : 1); l++) {
            for (int r = 0; r < sh.num_ref_idx[l] && r < 32; r++) {
                sh.wp[l][r][0] = {1 << sh.luma_log2_wd, 0, false};
                sh.wp[l][r][1] = {1 << sh.chroma_log2_wd, 0, false};
                sh.wp[l][r][2] = {1 << sh.chroma_log2_wd, 0, false};
                if (br.u(1)) {
                    sh.wp[l][r][0].w = br.se();
                    sh.wp[l][r][0].o = br.se();
                    sh.wp[l][r][0].present = true;
                }
                if (br.u(1)) {
                    for (int c = 1; c < 3; c++) {
                        sh.wp[l][r][c].w = br.se();
                        sh.wp[l][r][c].o = br.se();
                        sh.wp[l][r][c].present = true;
                    }
                }
            }
            for (int r = sh.num_ref_idx[l]; r < 32; r++) {
                sh.wp[l][r][0] = {1 << sh.luma_log2_wd, 0, false};
                sh.wp[l][r][1] = {1 << sh.chroma_log2_wd, 0, false};
                sh.wp[l][r][2] = {1 << sh.chroma_log2_wd, 0, false};
            }
        }
    }

    void setup_size();

    void setup_size_inner() {
        if (have_size && sps.mb_w == mb_w && sps.mb_h == mb_h) return;
        mb_w = sps.mb_w; mb_h = sps.mb_h;
        W = mb_w * 16; H = mb_h * 16;
        gw = mb_w * 4; gh = mb_h * 4;
        have_size = true;
        build_dequant();
    }

    // ---------------- POC (spec 8.2.1) ----------------
    int compute_poc(int nal_ref_idc) {
        if (sps.poc_type == 0) {
            int max_lsb = 1 << sps.log2_max_poc_lsb;
            if (sh.idr) { prev_poc_msb = 0; prev_poc_lsb = 0; }
            int msb;
            if (sh.poc_lsb < prev_poc_lsb &&
                prev_poc_lsb - sh.poc_lsb >= max_lsb / 2)
                msb = prev_poc_msb + max_lsb;
            else if (sh.poc_lsb > prev_poc_lsb &&
                     sh.poc_lsb - prev_poc_lsb > max_lsb / 2)
                msb = prev_poc_msb - max_lsb;
            else
                msb = prev_poc_msb;
            if (nal_ref_idc) { prev_poc_msb = msb; prev_poc_lsb = sh.poc_lsb; }
            return msb + sh.poc_lsb;
        }
        if (sps.poc_type == 2) {
            int max_fn = 1 << sps.log2_max_frame_num;
            int fn_offset;
            if (sh.idr) fn_offset = 0;
            else if (prev_frame_num > sh.frame_num)
                fn_offset = prev_frame_num_offset + max_fn;
            else fn_offset = prev_frame_num_offset;
            prev_frame_num_offset = fn_offset;
            prev_frame_num = sh.frame_num;
            int cnt = fn_offset + sh.frame_num;
            return nal_ref_idc ? 2 * cnt : 2 * cnt - 1;
        }
        fail("poc_type 1 unsupported");
        return 0;
    }

    // ---------------- DPB / reference lists (spec 8.2.4 / 8.2.5) --------
    void idr_flush() {
        for (auto& p : dpb) { p->ref = false; p->long_term = false; }
        // pictures already output are dropped; others stay for output order
        std::vector<std::unique_ptr<Pic>> keep;
        for (auto& p : dpb)
            if (!p->output_done) keep.push_back(std::move(p));
        dpb.swap(keep);
    }

    void sliding_window() {
        int n_ref = 0;
        Pic* oldest = nullptr;
        for (auto& p : dpb)
            if (p->ref && !p->long_term) {
                n_ref++;
                if (!oldest || p->frame_num_wrap < oldest->frame_num_wrap)
                    oldest = p.get();
            }
        for (auto& p : dpb) if (p->long_term) n_ref++;
        if (n_ref >= imax(1, sps.max_num_ref_frames) && oldest)
            oldest->ref = false;
    }

    void update_frame_num_wrap() {
        int max_fn = 1 << sps.log2_max_frame_num;
        for (auto& p : dpb) {
            if (!p->ref) continue;
            p->frame_num_wrap = p->frame_num > sh.frame_num
                                    ? p->frame_num - max_fn : p->frame_num;
            p->pic_num = p->frame_num_wrap;
        }
    }

    void build_ref_lists() {
        reflist[0].clear();
        reflist[1].clear();
        update_frame_num_wrap();
        std::vector<Pic*> st, lt;
        for (auto& p : dpb) {
            if (p->ref && !p->long_term) st.push_back(p.get());
            if (p->long_term) lt.push_back(p.get());
        }
        auto by_lt = [](Pic* a, Pic* b) {
            return a->long_term_idx < b->long_term_idx;
        };
        std::sort(lt.begin(), lt.end(), by_lt);
        if (sh.type == P_SLICE) {
            std::sort(st.begin(), st.end(), [](Pic* a, Pic* b) {
                return a->pic_num > b->pic_num;
            });
            reflist[0] = st;
            for (auto* p : lt) reflist[0].push_back(p);
        } else if (sh.type == B_SLICE) {
            std::vector<Pic*> before, after;
            for (auto* p : st)
                (p->poc <= cur->poc ? before : after).push_back(p);
            std::sort(before.begin(), before.end(),
                      [](Pic* a, Pic* b) { return a->poc > b->poc; });
            std::sort(after.begin(), after.end(),
                      [](Pic* a, Pic* b) { return a->poc < b->poc; });
            reflist[0] = before;
            for (auto* p : after) reflist[0].push_back(p);
            for (auto* p : lt) reflist[0].push_back(p);
            reflist[1] = after;
            for (auto* p : before) reflist[1].push_back(p);
            for (auto* p : lt) reflist[1].push_back(p);
            if (reflist[1].size() > 1 && reflist[0] == reflist[1])
                std::swap(reflist[1][0], reflist[1][1]);
        }
        // apply reordering commands
        int max_fn = 1 << sps.log2_max_frame_num;
        for (int l = 0; l < 2; l++) {
            if (sh.reorder[l].empty()) continue;
            std::vector<Pic*>& lst = reflist[l];
            long pred = cur->frame_num;      // picNumLXPred init CurrPicNum
            int insert = 0;
            for (auto& op : sh.reorder[l]) {
                Pic* target = nullptr;
                if (op.first == 0 || op.first == 1) {
                    long abs_diff = (long)op.second + 1;
                    long picnum = op.first == 0 ? pred - abs_diff
                                                : pred + abs_diff;
                    if (picnum < 0) picnum += max_fn;
                    else if (picnum >= max_fn) picnum -= max_fn;
                    pred = picnum;
                    long wrap = picnum > cur->frame_num ? picnum - max_fn
                                                        : picnum;
                    for (auto& p : dpb)
                        if (p->ref && !p->long_term && p->pic_num == wrap)
                            target = p.get();
                } else if (op.first == 2) {
                    for (auto& p : dpb)
                        if (p->long_term &&
                            p->long_term_idx == (int)op.second)
                            target = p.get();
                }
                if (!target) continue;
                // shift into position `insert`, dedupe later entries
                lst.insert(lst.begin() + imin(insert, (int)lst.size()),
                           target);
                for (size_t k = insert + 1; k < lst.size(); k++)
                    if (lst[k] == target) { lst.erase(lst.begin() + k); break; }
                insert++;
            }
        }
        for (int l = 0; l < 2; l++) {
            // trim / pad to num_ref_idx
            while ((int)reflist[l].size() > sh.num_ref_idx[l])
                reflist[l].pop_back();
            while (!reflist[l].empty() &&
                   (int)reflist[l].size() < sh.num_ref_idx[l])
                reflist[l].push_back(reflist[l].back());
        }
        if (sh.type == B_SLICE && pps.weighted_bipred_idc == 2)
            compute_implicit();
    }

    // implicit weighted bipred table (spec 8.4.2.3.1): w1 per ref pair
    void compute_implicit() {
        for (size_t r0 = 0; r0 < reflist[0].size() && r0 < 32; r0++)
            for (size_t r1 = 0; r1 < reflist[1].size() && r1 < 32; r1++) {
                int w = 32;
                Pic* p0 = reflist[0][r0];
                Pic* p1 = reflist[1][r1];
                int td = iclip(p1->poc - p0->poc, -128, 127);
                if (td != 0 && !p0->long_term && !p1->long_term) {
                    int tb = iclip(cur->poc - p0->poc, -128, 127);
                    int tx = (16384 + (td >= 0 ? td : -td) / 2) / td;
                    int dsf = iclip((tb * tx + 32) >> 6, -1024, 1023) >> 2;
                    if (dsf >= -64 && dsf <= 128) w = dsf;
                }
                imp_w[r0][r1] = (int16_t)w;
            }
    }

    void mark_references(int nal_ref_idc) {
        if (!nal_ref_idc) return;
        if (sh.idr) {
            cur->long_term = sh.long_term_ref_flag;
            cur->long_term_idx = 0;
            cur->ref = true;
            return;
        }
        if (!sh.adaptive_marking) {
            sliding_window();
        } else {
            int max_fn = 1 << sps.log2_max_frame_num;
            for (auto& op : sh.mmco) {
                int o = op.first;
                uint32_t v1 = op.second.first, v2 = op.second.second;
                if (o == 1) {
                    long picnum = cur->frame_num - ((long)v1 + 1);
                    if (picnum < 0) picnum += max_fn;
                    long wrap = picnum > cur->frame_num ? picnum - max_fn
                                                        : picnum;
                    for (auto& p : dpb)
                        if (p->ref && !p->long_term && p->pic_num == wrap)
                            p->ref = false;
                } else if (o == 2) {
                    for (auto& p : dpb)
                        if (p->long_term && p->long_term_idx == (int)v1) {
                            p->long_term = false; p->ref = false;
                        }
                } else if (o == 3) {
                    long picnum = cur->frame_num - ((long)v1 + 1);
                    if (picnum < 0) picnum += max_fn;
                    long wrap = picnum > cur->frame_num ? picnum - max_fn
                                                        : picnum;
                    for (auto& p : dpb)
                        if (p->ref && !p->long_term && p->pic_num == wrap) {
                            p->long_term = true;
                            p->long_term_idx = v2;
                        }
                } else if (o == 4) {
                    for (auto& p : dpb)
                        if (p->long_term && p->long_term_idx >= (int)v1) {
                            p->long_term = false; p->ref = false;
                        }
                } else if (o == 5) {
                    for (auto& p : dpb) { p->ref = false; p->long_term = false; }
                    prev_poc_msb = prev_poc_lsb = 0;
                    cur->poc = 0;
                    cur->frame_num = 0;
                } else if (o == 6) {
                    cur->long_term = true;
                    cur->long_term_idx = v2;
                }
            }
        }
        cur->ref = true;
    }
};

}  // namespace hbdec

#include <algorithm>

namespace hbdec {

// ---------------------------------------------------------------------------
// Reconstruction primitives
// ---------------------------------------------------------------------------
// inverse 4x4 transform (spec 8.5.12.2), d in raster, adds into pred/clip
static void idct4_add(uint8_t* dst, int stride, const int* d) {
    int f[16], g[16];
    for (int r = 0; r < 4; r++) {
        int d0 = d[r * 4], d1 = d[r * 4 + 1], d2 = d[r * 4 + 2],
            d3 = d[r * 4 + 3];
        int e0 = d0 + d2, e1 = d0 - d2;
        int e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
        f[r * 4] = e0 + e3; f[r * 4 + 1] = e1 + e2;
        f[r * 4 + 2] = e1 - e2; f[r * 4 + 3] = e0 - e3;
    }
    for (int c = 0; c < 4; c++) {
        int f0 = f[c], f1 = f[4 + c], f2 = f[8 + c], f3 = f[12 + c];
        int g0 = f0 + f2, g1 = f0 - f2;
        int g2 = (f1 >> 1) - f3, g3 = f1 + (f3 >> 1);
        g[c] = g0 + g3; g[4 + c] = g1 + g2;
        g[8 + c] = g1 - g2; g[12 + c] = g0 - g3;
    }
    for (int i = 0; i < 16; i++) {
        int r = i >> 2, c = i & 3;
        dst[r * stride + c] =
            clip255(dst[r * stride + c] + ((g[i] + 32) >> 6));
    }
}

static void hadamard4x4_ip(int* d) {
    int t[16];
    for (int c = 0; c < 4; c++) {
        int d0 = d[c], d1 = d[4 + c], d2 = d[8 + c], d3 = d[12 + c];
        t[c] = d0 + d1 + d2 + d3;
        t[4 + c] = d0 + d1 - d2 - d3;
        t[8 + c] = d0 - d1 - d2 + d3;
        t[12 + c] = d0 - d1 + d2 - d3;
    }
    for (int r = 0; r < 4; r++) {
        int t0 = t[r * 4], t1 = t[r * 4 + 1], t2 = t[r * 4 + 2],
            t3 = t[r * 4 + 3];
        d[r * 4] = t0 + t1 + t2 + t3;
        d[r * 4 + 1] = t0 + t1 - t2 - t3;
        d[r * 4 + 2] = t0 - t1 - t2 + t3;
        d[r * 4 + 3] = t0 - t1 + t2 - t3;
    }
}

// 8x8 inverse transform (spec 8.5.12.3)
static void idct8_add(uint8_t* dst, int stride, const int* d) {
    int t[64];
    for (int i = 0; i < 8; i++) {          // horizontal
        const int* a = d + i * 8;
        int e0 = a[0] + a[4];
        int e1 = -a[3] + a[5] - a[7] - (a[7] >> 1);
        int e2 = a[0] - a[4];
        int e3 = a[1] + a[7] - a[3] - (a[3] >> 1);
        int e4 = (a[2] >> 1) - a[6];
        int e5 = -a[1] + a[7] + a[5] + (a[5] >> 1);
        int e6 = a[2] + (a[6] >> 1);
        int e7 = a[3] + a[5] + a[1] + (a[1] >> 1);
        int f0 = e0 + e6, f1 = e1 + (e7 >> 2), f2 = e2 + e4;
        int f3 = e3 + (e5 >> 2), f4 = e2 - e4, f5 = (e3 >> 2) - e5;
        int f6 = e0 - e6, f7 = e7 - (e1 >> 2);
        int* o = t + i * 8;
        o[0] = f0 + f7; o[1] = f2 + f5; o[2] = f4 + f3; o[3] = f6 + f1;
        o[4] = f6 - f1; o[5] = f4 - f3; o[6] = f2 - f5; o[7] = f0 - f7;
    }
    for (int j = 0; j < 8; j++) {          // vertical
        int a[8];
        for (int i = 0; i < 8; i++) a[i] = t[i * 8 + j];
        int e0 = a[0] + a[4];
        int e1 = -a[3] + a[5] - a[7] - (a[7] >> 1);
        int e2 = a[0] - a[4];
        int e3 = a[1] + a[7] - a[3] - (a[3] >> 1);
        int e4 = (a[2] >> 1) - a[6];
        int e5 = -a[1] + a[7] + a[5] + (a[5] >> 1);
        int e6 = a[2] + (a[6] >> 1);
        int e7 = a[3] + a[5] + a[1] + (a[1] >> 1);
        int f0 = e0 + e6, f1 = e1 + (e7 >> 2), f2 = e2 + e4;
        int f3 = e3 + (e5 >> 2), f4 = e2 - e4, f5 = (e3 >> 2) - e5;
        int f6 = e0 - e6, f7 = e7 - (e1 >> 2);
        int g[8] = {f0 + f7, f2 + f5, f4 + f3, f6 + f1,
                    f6 - f1, f4 - f3, f2 - f5, f0 - f7};
        for (int i = 0; i < 8; i++) {
            uint8_t* p = dst + i * stride + j;
            *p = clip255(*p + ((g[i] + 32) >> 6));
        }
    }
}

// Intra 8x8 prediction (spec 8.3.2.2): reference filtering + 9 modes
static void intra8x8_pred(uint8_t* dst, int stride, int mode,
                          bool ha, bool hb, bool hc, bool hd) {
    // raw references
    int top[17], left[9];                  // top[0]=-1,-1 corner; top[1..16]
    uint8_t* up = dst - stride;
    for (int x = 0; x < 8; x++) top[1 + x] = hb ? up[x] : 0;
    for (int x = 8; x < 16; x++)
        top[1 + x] = hb ? (hc ? up[x] : up[7]) : 0;
    top[0] = hd ? up[-1] : 0;
    for (int y = 0; y < 8; y++) left[1 + y] = ha ? dst[y * stride - 1] : 0;
    left[0] = top[0];
    // filtering (8.3.2.2.1)
    int ft[17], fl[9];
    if (hd) {
        int a = hb ? top[1] : top[0];
        int l = ha ? left[1] : top[0];
        ft[0] = fl[0] = (a + 2 * top[0] + l + 2) >> 2;
    } else {
        ft[0] = fl[0] = 0;
    }
    if (hb) {
        ft[1] = hd ? ((top[0] + 2 * top[1] + top[2] + 2) >> 2)
                   : ((3 * top[1] + top[2] + 2) >> 2);
        for (int x = 2; x <= 15; x++)
            ft[x] = (top[x - 1] + 2 * top[x] + top[x + 1] + 2) >> 2;
        ft[16] = (top[15] + 3 * top[16] + 2) >> 2;
    }
    if (ha) {
        fl[1] = hd ? ((top[0] + 2 * left[1] + left[2] + 2) >> 2)
                   : ((3 * left[1] + left[2] + 2) >> 2);
        for (int y = 2; y <= 7; y++)
            fl[y] = (left[y - 1] + 2 * left[y] + left[y + 1] + 2) >> 2;
        fl[8] = (left[7] + 3 * left[8] + 2) >> 2;
    }
    // prediction on filtered refs; p(x,-1)=ft[1+x], p(-1,y)=fl[1+y],
    // p(-1,-1)=ft[0]
    auto P = [&](int x, int y) -> int {
        if (y == -1) return x == -1 ? ft[0] : ft[1 + x];
        return fl[1 + y];
    };
    switch (mode) {
    case 0:                                // vertical
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++)
                dst[y * stride + x] = (uint8_t)P(x, -1);
        break;
    case 1:                                // horizontal
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++)
                dst[y * stride + x] = (uint8_t)P(-1, y);
        break;
    case 2: {                              // DC
        int s = 0, n = 0;
        if (hb) { for (int x = 0; x < 8; x++) s += P(x, -1); n += 8; }
        if (ha) { for (int y = 0; y < 8; y++) s += P(-1, y); n += 8; }
        int v = n == 16 ? (s + 8) >> 4 : (n == 8 ? (s + 4) >> 3 : 128);
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++)
                dst[y * stride + x] = (uint8_t)v;
        break;
    }
    case 3:                                // diagonal down-left
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) {
                int v;
                if (x == 7 && y == 7)
                    v = (P(14, -1) + 3 * P(15, -1) + 2) >> 2;
                else
                    v = (P(x + y, -1) + 2 * P(x + y + 1, -1)
                         + P(x + y + 2, -1) + 2) >> 2;
                dst[y * stride + x] = (uint8_t)v;
            }
        break;
    case 4:                                // diagonal down-right
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) {
                int v;
                if (x > y)
                    v = (P(x - y - 2, -1) + 2 * P(x - y - 1, -1)
                         + P(x - y, -1) + 2) >> 2;
                else if (x < y)
                    v = (P(-1, y - x - 2) + 2 * P(-1, y - x - 1)
                         + P(-1, y - x) + 2) >> 2;
                else
                    v = (P(0, -1) + 2 * P(-1, -1) + P(-1, 0) + 2) >> 2;
                dst[y * stride + x] = (uint8_t)v;
            }
        break;
    case 5:                                // vertical right
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) {
                int z = 2 * x - y, v;
                if (z >= 0 && (z & 1) == 0)
                    v = (P(x - (y >> 1) - 1, -1)
                         + P(x - (y >> 1), -1) + 1) >> 1;
                else if (z >= 0)
                    v = (P(x - (y >> 1) - 2, -1)
                         + 2 * P(x - (y >> 1) - 1, -1)
                         + P(x - (y >> 1), -1) + 2) >> 2;
                else if (z == -1)
                    v = (P(-1, 0) + 2 * P(-1, -1) + P(0, -1) + 2) >> 2;
                else
                    v = (P(-1, y - 2 * x - 1) + 2 * P(-1, y - 2 * x - 2)
                         + P(-1, y - 2 * x - 3) + 2) >> 2;
                dst[y * stride + x] = (uint8_t)v;
            }
        break;
    case 6:                                // horizontal down
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) {
                int z = 2 * y - x, v;
                if (z >= 0 && (z & 1) == 0)
                    v = (P(-1, y - (x >> 1) - 1)
                         + P(-1, y - (x >> 1)) + 1) >> 1;
                else if (z >= 0)
                    v = (P(-1, y - (x >> 1) - 2)
                         + 2 * P(-1, y - (x >> 1) - 1)
                         + P(-1, y - (x >> 1)) + 2) >> 2;
                else if (z == -1)
                    v = (P(-1, 0) + 2 * P(-1, -1) + P(0, -1) + 2) >> 2;
                else
                    v = (P(x - 2 * y - 1, -1) + 2 * P(x - 2 * y - 2, -1)
                         + P(x - 2 * y - 3, -1) + 2) >> 2;
                dst[y * stride + x] = (uint8_t)v;
            }
        break;
    case 7:                                // vertical left
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) {
                int v;
                if ((y & 1) == 0)
                    v = (P(x + (y >> 1), -1)
                         + P(x + (y >> 1) + 1, -1) + 1) >> 1;
                else
                    v = (P(x + (y >> 1), -1)
                         + 2 * P(x + (y >> 1) + 1, -1)
                         + P(x + (y >> 1) + 2, -1) + 2) >> 2;
                dst[y * stride + x] = (uint8_t)v;
            }
        break;
    default:                               // 8: horizontal up
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) {
                int z = x + 2 * y, v;
                if ((z & 1) == 0 && z < 13)
                    v = (P(-1, y + (x >> 1))
                         + P(-1, y + (x >> 1) + 1) + 1) >> 1;
                else if (z < 13)
                    v = (P(-1, y + (x >> 1))
                         + 2 * P(-1, y + (x >> 1) + 1)
                         + P(-1, y + (x >> 1) + 2) + 2) >> 2;
                else if (z == 13)
                    v = (P(-1, 6) + 3 * P(-1, 7) + 2) >> 2;
                else
                    v = P(-1, 7);
                dst[y * stride + x] = (uint8_t)v;
            }
        break;
    }
}

// ---------------------------------------------------------------------------
// Intra prediction (spec 8.3).  `rec` points at the block origin in the
// picture plane.  Availability flags describe neighbour sample groups.
// ---------------------------------------------------------------------------
enum { // 4x4 / 8x8 luma modes
    IM_V = 0, IM_H = 1, IM_DC = 2, IM_DDL = 3, IM_DDR = 4,
    IM_VR = 5, IM_HD = 6, IM_VL = 7, IM_HU = 8 };

static void intra4x4_pred(uint8_t* dst, int stride, int mode,
                          bool ha, bool hb, bool hc, bool hd) {
    // neighbours: a=left, b=top, c=top-right, d=top-left
    uint8_t L[4], T[8], X = 128;
    if (ha) for (int i = 0; i < 4; i++) L[i] = dst[i * stride - 1];
    if (hb) {
        for (int i = 0; i < 4; i++) T[i] = dst[-stride + i];
        if (hc) for (int i = 4; i < 8; i++) T[i] = dst[-stride + i];
        else for (int i = 4; i < 8; i++) T[i] = T[3];
    }
    if (hd) X = dst[-stride - 1];
    auto P = [&](int x, int y) -> int {   // p[x,y] spec coords
        if (y == -1) return x == -1 ? X : T[x];
        return L[y];
    };
    switch (mode) {
    case IM_V:
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) dst[y * stride + x] = T[x];
        break;
    case IM_H:
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) dst[y * stride + x] = L[y];
        break;
    case IM_DC: {
        int s = 0, n = 0;
        if (hb) { for (int i = 0; i < 4; i++) s += T[i]; n += 4; }
        if (ha) { for (int i = 0; i < 4; i++) s += L[i]; n += 4; }
        int dc = n == 8 ? (s + 4) >> 3 : (n == 4 ? (s + 2) >> 2 : 128);
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) dst[y * stride + x] = dc;
        break;
    }
    case IM_DDL:
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) {
                int i = x + y;
                dst[y * stride + x] = i == 6
                    ? (T[6] + 3 * T[7] + 2) >> 2
                    : (T[i] + 2 * T[i + 1] + T[i + 2] + 2) >> 2;
            }
        break;
    case IM_DDR:
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) {
                if (x > y) {
                    int i = x - y;
                    dst[y * stride + x] =
                        (P(i - 2, -1) + 2 * P(i - 1, -1) + P(i, -1) + 2) >> 2;
                } else if (x < y) {
                    int i = y - x;
                    dst[y * stride + x] =
                        (P(-1, i - 2) + 2 * P(-1, i - 1) + P(-1, i) + 2) >> 2;
                } else {
                    dst[y * stride + x] =
                        (P(0, -1) + 2 * P(-1, -1) + P(-1, 0) + 2) >> 2;
                }
            }
        break;
    case IM_VR:
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) {
                int z = 2 * x - y;
                if (z >= 0 && (z & 1) == 0)
                    dst[y * stride + x] =
                        (P(x - (y >> 1) - 1, -1) + P(x - (y >> 1), -1) + 1)
                        >> 1;
                else if (z >= 0)
                    dst[y * stride + x] =
                        (P(x - (y >> 1) - 2, -1) +
                         2 * P(x - (y >> 1) - 1, -1) +
                         P(x - (y >> 1), -1) + 2) >> 2;
                else if (z == -1)
                    dst[y * stride + x] =
                        (P(-1, 0) + 2 * P(-1, -1) + P(0, -1) + 2) >> 2;
                else
                    dst[y * stride + x] =
                        (P(-1, y - 1) + 2 * P(-1, y - 2) + P(-1, y - 3) + 2)
                        >> 2;
            }
        break;
    case IM_HD:
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) {
                int z = 2 * y - x;
                if (z >= 0 && (z & 1) == 0)
                    dst[y * stride + x] =
                        (P(-1, y - (x >> 1) - 1) + P(-1, y - (x >> 1)) + 1)
                        >> 1;
                else if (z >= 0)
                    dst[y * stride + x] =
                        (P(-1, y - (x >> 1) - 2) +
                         2 * P(-1, y - (x >> 1) - 1) +
                         P(-1, y - (x >> 1)) + 2) >> 2;
                else if (z == -1)
                    dst[y * stride + x] =
                        (P(-1, 0) + 2 * P(-1, -1) + P(0, -1) + 2) >> 2;
                else
                    dst[y * stride + x] =
                        (P(x - 1, -1) + 2 * P(x - 2, -1) + P(x - 3, -1) + 2)
                        >> 2;
            }
        break;
    case IM_VL:
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) {
                int i = x + (y >> 1);
                dst[y * stride + x] = (y & 1) == 0
                    ? (T[i] + T[i + 1] + 1) >> 1
                    : (T[i] + 2 * T[i + 1] + T[i + 2] + 2) >> 2;
            }
        break;
    case IM_HU:
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) {
                int z = x + 2 * y;
                if (z > 5) dst[y * stride + x] = L[3];
                else if (z == 5)
                    dst[y * stride + x] = (L[2] + 3 * L[3] + 2) >> 2;
                else if (z & 1)
                    dst[y * stride + x] =
                        (L[y + (x >> 1)] + 2 * L[y + (x >> 1) + 1] +
                         L[y + (x >> 1) + 2] + 2) >> 2;
                else
                    dst[y * stride + x] =
                        (L[y + (x >> 1)] + L[y + (x >> 1) + 1] + 1) >> 1;
            }
        break;
    }
}

// Intra 16x16 (modes 0..3 = V,H,DC,Plane) — dst at MB origin
static void intra16_pred(uint8_t* dst, int stride, int mode,
                         bool ha, bool hb) {
    switch (mode) {
    case 0:
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++)
                dst[y * stride + x] = dst[-stride + x];
        break;
    case 1:
        for (int y = 0; y < 16; y++) {
            uint8_t v = dst[y * stride - 1];
            for (int x = 0; x < 16; x++) dst[y * stride + x] = v;
        }
        break;
    case 2: {
        int s = 0, dc;
        if (ha && hb) {
            for (int i = 0; i < 16; i++)
                s += dst[-stride + i] + dst[i * stride - 1];
            dc = (s + 16) >> 5;
        } else if (hb) {
            for (int i = 0; i < 16; i++) s += dst[-stride + i];
            dc = (s + 8) >> 4;
        } else if (ha) {
            for (int i = 0; i < 16; i++) s += dst[i * stride - 1];
            dc = (s + 8) >> 4;
        } else dc = 128;
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++) dst[y * stride + x] = dc;
        break;
    }
    case 3: {
        long hsum = 0, vsum = 0;
        long tl = dst[-stride - 1];
        for (int x = 0; x < 8; x++) {
            long lo = x < 7 ? (long)dst[-stride + 6 - x] : tl;
            hsum += (x + 1) * ((long)dst[-stride + 8 + x] - lo);
        }
        for (int y = 0; y < 8; y++) {
            long lo = y < 7 ? (long)dst[(6 - y) * stride - 1] : tl;
            vsum += (y + 1) * ((long)dst[(8 + y) * stride - 1] - lo);
        }
        long b = (5 * hsum + 32) >> 6;
        long c = (5 * vsum + 32) >> 6;
        long a = 16 * ((long)dst[15 * stride - 1] + (long)dst[-stride + 15]);
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++) {
                long p = (a + b * (x - 7) + c * (y - 7) + 16) >> 5;
                dst[y * stride + x] = clip255((int)p);
            }
        break;
    }
    }
}

// Chroma 8x8 (modes 0..3 = DC,H,V,Plane)
static void chroma_pred(uint8_t* dst, int stride, int mode,
                        bool ha, bool hb) {
    switch (mode) {
    case 0: {  // DC per 4x4 quadrant
        for (int q = 0; q < 4; q++) {
            int qx = (q & 1) * 4, qy = (q >> 1) * 4;
            int s = 0, n = 0;
            bool ut = hb && (q >> 1) == 0;       // quadrant uses top row
            bool ul = ha && (q & 1) == 0;
            // spec: q(0,0) uses both; q(1,0) top only (left fallback);
            // q(0,1) left only (top fallback); q(1,1) both
            bool use_t, use_l;
            if (q == 0) { use_t = hb; use_l = ha; }
            else if (q == 1) { use_t = hb; use_l = hb ? false : ha; }
            else if (q == 2) { use_l = ha; use_t = ha ? false : hb; }
            else { use_t = hb; use_l = ha; }
            if (use_t) { for (int i = 0; i < 4; i++)
                             s += dst[-stride + qx + i]; n += 4; }
            if (use_l) { for (int i = 0; i < 4; i++)
                             s += dst[(qy + i) * stride - 1]; n += 4; }
            int dc = n == 8 ? (s + 4) >> 3 : (n == 4 ? (s + 2) >> 2 : 128);
            for (int y = 0; y < 4; y++)
                for (int x = 0; x < 4; x++)
                    dst[(qy + y) * stride + qx + x] = dc;
            (void)ut; (void)ul;
        }
        break;
    }
    case 1:
        for (int y = 0; y < 8; y++) {
            uint8_t v = dst[y * stride - 1];
            for (int x = 0; x < 8; x++) dst[y * stride + x] = v;
        }
        break;
    case 2:
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++)
                dst[y * stride + x] = dst[-stride + x];
        break;
    case 3: {
        long hsum = 0, vsum = 0;
        long tl = dst[-stride - 1];
        for (int x = 0; x < 4; x++) {
            long lo = x < 3 ? (long)dst[-stride + 2 - x] : tl;
            hsum += (x + 1) * ((long)dst[-stride + 4 + x] - lo);
        }
        for (int y = 0; y < 4; y++) {
            long lo = y < 3 ? (long)dst[(2 - y) * stride - 1] : tl;
            vsum += (y + 1) * ((long)dst[(4 + y) * stride - 1] - lo);
        }
        long b = (17 * hsum + 16) >> 5;
        long c = (17 * vsum + 16) >> 5;
        long a = 16 * ((long)dst[7 * stride - 1] + (long)dst[-stride + 7]);
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) {
                long p = (a + b * (x - 3) + c * (y - 3) + 16) >> 5;
                dst[y * stride + x] = clip255((int)p);
            }
        break;
    }
    }
}

// ---------------------------------------------------------------------------
// Motion compensation (spec 8.4.2.2): 6-tap luma, bilinear chroma, with
// edge clamping of reference coordinates.
// ---------------------------------------------------------------------------
static inline int tap6(int a, int b, int c, int d, int e, int f) {
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

// luma block bw x bh from ref plane at full-pel (ix,iy) + frac (fx,fy)
static void mc_luma(const uint8_t* ref, int rw, int rh,
                    int16_t* dst, int dstride, int bw, int bh,
                    int ix, int iy, int fx, int fy) {
    auto S = [&](int x, int y) -> int {
        return ref[iclip(y, 0, rh - 1) * rw + iclip(x, 0, rw - 1)];
    };
    if (fx == 0 && fy == 0) {
        for (int y = 0; y < bh; y++)
            for (int x = 0; x < bw; x++)
                dst[y * dstride + x] = S(ix + x, iy + y);
        return;
    }
    // half-pel intermediates
    // b = horizontal filter at integer rows; h = vertical at integer cols;
    // j = vertical filter of b-row values
    int tmpw = bw + 8, tmph = bh + 8;
    std::vector<int> bh_(tmpw * tmph);       // horizontal-filtered, unscaled
    for (int y = -2; y < bh + 3; y++)
        for (int x = -2; x < bw + 3; x++) {
            int gx = ix + x, gy = iy + y;
            bh_[(y + 2) * tmpw + (x + 2)] =
                tap6(S(gx - 2, gy), S(gx - 1, gy), S(gx, gy),
                     S(gx + 1, gy), S(gx + 2, gy), S(gx + 3, gy));
        }
    auto Braw = [&](int x, int y) -> int {   // unscaled b at (x,y)
        return bh_[(y + 2) * tmpw + (x + 2)];
    };
    auto B = [&](int x, int y) -> int {      // rounded half-pel b
        return iclip((Braw(x, y) + 16) >> 5, 0, 255);
    };
    auto Hraw = [&](int x, int y) -> int {   // vertical 6-tap on samples
        int gx = ix + x, gy = iy + y;
        return tap6(S(gx, gy - 2), S(gx, gy - 1), S(gx, gy),
                    S(gx, gy + 1), S(gx, gy + 2), S(gx, gy + 3));
    };
    auto Hh = [&](int x, int y) -> int {
        return iclip((Hraw(x, y) + 16) >> 5, 0, 255);
    };
    auto Jraw = [&](int x, int y) -> int {   // 2-D: vertical filter on Braw
        return tap6(Braw(x, y - 2), Braw(x, y - 1), Braw(x, y),
                    Braw(x, y + 1), Braw(x, y + 2), Braw(x, y + 3));
    };
    auto J = [&](int x, int y) -> int {
        return iclip((Jraw(x, y) + 512) >> 10, 0, 255);
    };
    for (int y = 0; y < bh; y++)
        for (int x = 0; x < bw; x++) {
            int v;
            if (fy == 0) {                       // horizontal only
                int b = B(x, y);
                if (fx == 2) v = b;
                else {
                    int g = S(ix + x + (fx >> 1), iy + y);
                    v = (g + b + 1) >> 1;
                }
            } else if (fx == 0) {                // vertical only
                int h = Hh(x, y);
                if (fy == 2) v = h;
                else {
                    int g = S(ix + x, iy + y + (fy >> 1));
                    v = (g + h + 1) >> 1;
                }
            } else if (fx == 2 && fy == 2) {
                v = J(x, y);
            } else if (fx == 2) {                // j averaged with b
                int j = J(x, y);
                int b = B(x, y + (fy >> 1));
                v = (j + b + 1) >> 1;
            } else if (fy == 2) {
                int j = J(x, y);
                int h = Hh(x + (fx >> 1), y);
                v = (j + h + 1) >> 1;
            } else {                             // quarter diagonal
                int b = B(x, y + (fy >> 1));
                int h = Hh(x + (fx >> 1), y);
                v = (b + h + 1) >> 1;
            }
            dst[y * dstride + x] = v;
        }
}

static void mc_chroma(const uint8_t* ref, int rw, int rh,
                      int16_t* dst, int dstride, int bw, int bh,
                      int ix, int iy, int fx, int fy) {
    auto S = [&](int x, int y) -> int {
        return ref[iclip(y, 0, rh - 1) * rw + iclip(x, 0, rw - 1)];
    };
    for (int y = 0; y < bh; y++)
        for (int x = 0; x < bw; x++) {
            int a = S(ix + x, iy + y), b = S(ix + x + 1, iy + y);
            int c = S(ix + x, iy + y + 1), d = S(ix + x + 1, iy + y + 1);
            dst[y * dstride + x] =
                ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b +
                 (8 - fx) * fy * c + fx * fy * d + 32) >> 6;
        }
}

}  // namespace hbdec

#include "cavlc_tables.h"

namespace hbdec {

// ---------------------------------------------------------------------------
// CAVLC decode tables (built from the encode-direction arrays)
// ---------------------------------------------------------------------------
static void build_vlc(CavlcTables& V);

void Dec::setup_size() {
    build_vlc(vlc);
    setup_size_inner();
}

static void build_vlc(CavlcTables& V) {
    if (V.built) return;
    auto fill_ct = [](VlcMap& m, const int32_t* len, const int32_t* bits) {
        for (int tc = 0; tc <= 16; tc++)
            for (int t1 = 0; t1 < 4; t1++) {
                int idx = tc * 4 + t1;
                if (len[idx] > 0) m.add(len[idx], bits[idx], idx);
            }
    };
    fill_ct(V.coeff_token[0], CT_NC0_LEN, CT_NC0_BITS);
    fill_ct(V.coeff_token[1], CT_NC2_LEN, CT_NC2_BITS);
    fill_ct(V.coeff_token[2], CT_NC4_LEN, CT_NC4_BITS);
    fill_ct(V.coeff_token_cdc, CT_CDC_LEN, CT_CDC_BITS);
    for (int tc = 1; tc < 16; tc++)
        for (int tz = 0; tz < 16; tz++) {
            int idx = tc * 16 + tz;
            if (TZ_LEN[idx] > 0) V.total_zeros[tc].add(TZ_LEN[idx],
                                                       TZ_BITS[idx], tz);
        }
    for (int tc = 1; tc < 4; tc++)
        for (int tz = 0; tz < 4; tz++) {
            int idx = tc * 4 + tz;
            if (TZC_LEN[idx] > 0)
                V.total_zeros_cdc[tc].add(TZC_LEN[idx], TZC_BITS[idx], tz);
        }
    for (int zl = 1; zl < 8; zl++)
        for (int run = 0; run < 15; run++) {
            int idx = zl * 15 + run;
            if (RB_LEN[idx] > 0)
                V.run_before[zl].add(RB_LEN[idx], RB_BITS[idx], run);
        }
    V.built = true;
}

// CAVLC residual (spec 9.2).  coeffs[maxcoeff] in scan order.  Returns
// TotalCoeff, or -1 on error.
static int cavlc_residual(Dec& D, BR& br, int* coeffs, int maxcoeff,
                          int nC) {
    memset(coeffs, 0, sizeof(int) * maxcoeff);
    int token;
    int startpos = br.pos;
    if (nC == -1) token = D.vlc.coeff_token_cdc.read(br);
    else if (nC < 2) token = D.vlc.coeff_token[0].read(br);
    else if (nC < 4) token = D.vlc.coeff_token[1].read(br);
    else if (nC < 8) token = D.vlc.coeff_token[2].read(br);
    else {
        uint32_t code = br.u(6);
        token = code == 3 ? 0 : (int)(((code >> 2) + 1) * 4 + (code & 3));
    }
    if (token < 0) {
        if (getenv("HBDEC_TRACE"))
            fprintf(stderr, "  coeff_token fail nC %d at bit %d\n", nC,
                    startpos);
        return -1;
    }
    int tc = token >> 2, t1 = token & 3;
    if (tc == 0) return 0;
    if (tc > maxcoeff) return -1;
    int level[16];
    for (int i = 0; i < t1; i++) level[i] = br.bit() ? -1 : 1;
    int suffix_len = (tc > 10 && t1 < 3) ? 1 : 0;
    for (int i = t1; i < tc; i++) {
        int prefix = 0;
        while (!br.bit()) {
            if (++prefix > 31 || br.err) return -1;
        }
        int sz = suffix_len;
        if (prefix == 14 && suffix_len == 0) sz = 4;
        else if (prefix >= 15) sz = prefix - 3;
        int code = imin(15, prefix) << suffix_len;
        if (sz) code += br.u(sz);
        if (prefix >= 15 && suffix_len == 0) code += 15;
        if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
        if (i == t1 && t1 < 3) code += 2;
        level[i] = (code & 1) ? -((code + 1) >> 1) : (code + 2) >> 1;
        if (suffix_len == 0) suffix_len = 1;
        int a = level[i] < 0 ? -level[i] : level[i];
        if (a > (3 << (suffix_len - 1)) && suffix_len < 6) suffix_len++;
    }
    int zeros_left = 0;
    if (tc < maxcoeff) {
        int tz;
        if (nC == -1) tz = D.vlc.total_zeros_cdc[tc].read(br);
        else tz = D.vlc.total_zeros[tc].read(br);
        if (tz < 0) return -1;
        zeros_left = tz;
    }
    int idx = zeros_left + tc - 1;
    for (int i = 0; i < tc; i++) {
        if (idx >= maxcoeff) return -1;
        coeffs[idx] = level[i];
        if (i < tc - 1) {
            int run = 0;
            if (zeros_left > 0) {
                run = D.vlc.run_before[imin(zeros_left, 7)].read(br);
                if (run < 0) return -1;
            }
            zeros_left -= run;
            idx -= 1 + run;
        }
    }
    return tc;
}

// ---------------------------------------------------------------------------
// Per-picture state & helpers
// ---------------------------------------------------------------------------
struct MBDec;          // forward

// Each decoder owns its picture state (Dec::pc), so decoders on
// different threads share nothing; g_pc names the state of the decoder
// D that every function below has in scope.
#define g_pc (D.pc)

static inline bool mb_avail(Dec& D, int mbx, int mby) {
    if (mbx < 0 || mby < 0 || mbx >= D.mb_w || mby >= D.mb_h) return false;
    int i = mby * D.mb_w + mbx;
    return D.mb_done[i] && g_pc.mb_slice[i] == g_pc.slice_id;
}

static inline bool blk_avail(Dec& D, int gx, int gy) {
    if (gx < 0 || gy < 0 || gx >= D.gw || gy >= D.gh) return false;
    int mb = (gy >> 2) * D.mb_w + (gx >> 2);
    if (g_pc.mb_slice[mb] != g_pc.slice_id) return false;
    return g_pc.blk_done[gy * D.gw + gx] != 0;
}

// nC for CAVLC coeff_token (spec 9.2.1) — parse-order availability
static inline bool blk_parsed_at(Dec& D, int gx, int gy) {
    if (gx < 0 || gy < 0 || gx >= D.gw || gy >= D.gh) return false;
    int mb = (gy >> 2) * D.mb_w + (gx >> 2);
    if (g_pc.mb_slice[mb] != g_pc.slice_id) return false;
    return g_pc.blk_parsed[gy * D.gw + gx] != 0;
}

static int luma_nc(Dec& D, int gx, int gy) {
    bool aa = blk_parsed_at(D, gx - 1, gy);
    bool ab = blk_parsed_at(D, gx, gy - 1);
    int na = aa ? D.nnz_l[gy * D.gw + gx - 1] : 0;
    int nb = ab ? D.nnz_l[(gy - 1) * D.gw + gx] : 0;
    if (aa && ab) return (na + nb + 1) >> 1;
    if (aa) return na;
    if (ab) return nb;
    return 0;
}

static int chroma_nc(Dec& D, int comp, int cx, int cy) {
    int cw = D.mb_w * 2, ch = D.mb_h * 2;
    auto av = [&](int x, int y) -> bool {
        if (x < 0 || y < 0 || x >= cw || y >= ch) return false;
        int mb = (y >> 1) * D.mb_w + (x >> 1);
        if (g_pc.mb_slice[mb] != g_pc.slice_id) return false;
        return g_pc.cblk_parsed[comp][y * cw + x] != 0;
    };
    bool aa = av(cx - 1, cy), ab = av(cx, cy - 1);
    int na = aa ? D.nnz_c[comp][cy * cw + cx - 1] : 0;
    int nb = ab ? D.nnz_c[comp][(cy - 1) * cw + cx] : 0;
    if (aa && ab) return (na + nb + 1) >> 1;
    if (aa) return na;
    if (ab) return nb;
    return 0;
}

}  // namespace hbdec

namespace hbdec {

// ---------------------------------------------------------------------------
// Macroblock container filled by either entropy parser, then reconstructed
// ---------------------------------------------------------------------------
struct MB {
    bool skip = false, intra = false, i16 = false, pcm = false;
    bool b_direct = false;
    bool t8x8 = false;            // transform_size_8x8_flag
    int ipred8[4] = {2, 2, 2, 2}; // intra 8x8 modes (when t8x8 && !i16)
    int nnz8[4] = {0, 0, 0, 0};   // per-8x8 total coeffs (t8x8)
    int coeff8[4][64];            // per-8x8 coeffs, scan order (t8x8)
    int i16mode = 0, cmode = 0;
    int ipred[16];                // per 4x4 raster: intra4x4 mode
    int cbp = 0;                  // luma(4) | chroma(2)<<4
    int qp = 26;
    int part = 0;                 // inter: 0 16x16, 1 16x8, 2 8x16, 3 8x8
    int sub[4] = {0, 0, 0, 0};    // sub_mb_type per 8x8
    int8_t ref[2][16];            // per 4x4 raster
    int16_t mvs[2][16][2];
    int16_t mvd[2][16][2];        // for CABAC neighbour ctx
    int coeff_l[16][16];          // per 4x4 raster block, scan order
    int coeff_ldc[16];
    int coeff_cdc[2][4];
    int coeff_cac[2][4][16];      // AC at idx 1..15
    uint8_t nnz[16], cnnz[2][4];
    uint8_t pcm_data[384];
};

// neighbour motion info for prediction
struct NB {
    bool avail = false;           // partition exists (inter, same slice)
    bool mbav = false;            // macroblock exists
    int ref = -1;
    int mvx = 0, mvy = 0;
};

static NB nb_at(Dec& D, int l, int gx, int gy) {
    NB n;
    if (gx < 0 || gy < 0 || gx >= D.gw || gy >= D.gh) return n;
    int mb = (gy >> 2) * D.mb_w + (gx >> 2);
    if (g_pc.mb_slice[mb] != g_pc.slice_id) return n;
    int8_t r = D.refidx[l][gy * D.gw + gx];
    if (r == -2) return n;        // not yet parsed (after current MB)
    if (!D.mv_done[l][gy * D.gw + gx]) return n;  // ref parsed, mv pending:
                                  // later partition in decode order
    n.mbav = true;
    if (r >= 0) {
        n.avail = true;
        n.ref = r;
        n.mvx = D.mv[l][(gy * D.gw + gx) * 2];
        n.mvy = D.mv[l][(gy * D.gw + gx) * 2 + 1];
    }
    return n;
}

// spec 8.4.1.3 — pred for partition at (gx,gy) size (w4,h4), list l, ref r
static void mv_pred(Dec& D, int l, int gx, int gy, int w4, int h4, int r,
                    int* px, int* py) {
    NB A = nb_at(D, l, gx - 1, gy);
    NB B = nb_at(D, l, gx, gy - 1);
    NB C = nb_at(D, l, gx + w4, gy - 1);
    // same-MB topright later in z-scan order is "not yet decoded"
    // (6.4.11.7) even when a direct quadrant derived its motion early
    if ((gx + w4) >> 2 == gx >> 2 && gy > 0 && (gy - 1) >> 2 == gy >> 2) {
        auto zidx = [](int bx, int by) {
            return (((by >> 1) * 2 + (bx >> 1)) << 2) |
                   ((by & 1) * 2 + (bx & 1));
        };
        if (zidx((gx + w4) & 3, (gy - 1) & 3) > zidx(gx & 3, gy & 3))
            C = NB();
    }
    if (!C.mbav) C = nb_at(D, l, gx - 1, gy - 1);   // D substitution
    // directional special cases
    if (w4 == 4 && h4 == 2) {                       // 16x8
        if ((gy & 3) == 0 && B.avail && B.ref == r) { *px = B.mvx; *py = B.mvy; return; }
        if ((gy & 3) == 2 && A.avail && A.ref == r) { *px = A.mvx; *py = A.mvy; return; }
    } else if (w4 == 2 && h4 == 4) {                // 8x16
        if ((gx & 3) == 0 && A.avail && A.ref == r) { *px = A.mvx; *py = A.mvy; return; }
        if ((gx & 3) == 2 && C.avail && C.ref == r) { *px = C.mvx; *py = C.mvy; return; }
    }
    if (!B.mbav && !C.mbav) {
        if (A.avail) { *px = A.mvx; *py = A.mvy; return; }
        *px = 0; *py = 0; return;
    }
    int match = 0;
    NB* only = nullptr;
    for (NB* n : {&A, &B, &C})
        if (n->avail && n->ref == r) { match++; only = n; }
    if (match == 1) { *px = only->mvx; *py = only->mvy; return; }
    int ax = A.avail ? A.mvx : 0, ay = A.avail ? A.mvy : 0;
    int bx = B.avail ? B.mvx : 0, by = B.avail ? B.mvy : 0;
    int cx = C.avail ? C.mvx : 0, cy = C.avail ? C.mvy : 0;
    *px = med3(ax, bx, cx);
    *py = med3(ay, by, cy);
}

static void pskip_mv(Dec& D, int gx, int gy, int* px, int* py) {
    NB A = nb_at(D, 0, gx - 1, gy);
    NB B = nb_at(D, 0, gx, gy - 1);
    if (!A.mbav || !B.mbav ||
        (A.avail && A.ref == 0 && A.mvx == 0 && A.mvy == 0) ||
        (B.avail && B.ref == 0 && B.mvx == 0 && B.mvy == 0)) {
        // A/B unavailable or zero-mv ref0 neighbour → zero mv
        if (!A.mbav || !B.mbav) { *px = 0; *py = 0; return; }
        if ((A.avail && A.ref == 0 && A.mvx == 0 && A.mvy == 0) ||
            (B.avail && B.ref == 0 && B.mvx == 0 && B.mvy == 0)) {
            *px = 0; *py = 0; return;
        }
    }
    mv_pred(D, 0, gx, gy, 4, 4, 0, px, py);
}

// store partition motion into the MB and the picture grids (the grids
// must update immediately: later partitions of the same MB predict from
// earlier ones)
static void set_mv(Dec& D, MB& m, int mbx, int mby, int l, int bx0, int by0,
                   int w4, int h4, int r, int mvx, int mvy,
                   int mdx, int mdy) {
    for (int y = 0; y < h4; y++)
        for (int x = 0; x < w4; x++) {
            int bi = (by0 + y) * 4 + bx0 + x;
            m.ref[l][bi] = (int8_t)r;
            m.mvs[l][bi][0] = (int16_t)mvx;
            m.mvs[l][bi][1] = (int16_t)mvy;
            m.mvd[l][bi][0] = (int16_t)mdx;
            m.mvd[l][bi][1] = (int16_t)mdy;
            int gi = (mby * 4 + by0 + y) * D.gw + mbx * 4 + bx0 + x;
            D.refidx[l][gi] = (int8_t)r;
            D.mv[l][gi * 2] = (int16_t)mvx;
            D.mv[l][gi * 2 + 1] = (int16_t)mvy;
            D.mvd_grid[l][gi * 2] = (int16_t)(mdx < 0 ? -mdx : mdx);
            D.mvd_grid[l][gi * 2 + 1] = (int16_t)(mdy < 0 ? -mdy : mdy);
            D.refpic[l][gi] = (r >= 0 && r < (int)D.reflist[l].size())
                                  ? D.reflist[l][r] : nullptr;
            D.mv_done[l][gi] = 1;
        }
}

static void flush_mv_grids(Dec& D, MB& m, int mbx, int mby) {
    int g0 = mby * 4 * D.gw + mbx * 4;
    for (int l = 0; l < 2; l++)
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) {
                int gi = g0 + y * D.gw + x;
                int bi = y * 4 + x;
                D.refidx[l][gi] = m.intra || m.pcm ? -1 : m.ref[l][bi];
                D.mv[l][gi * 2] = m.mvs[l][bi][0];
                D.mv[l][gi * 2 + 1] = m.mvs[l][bi][1];
                D.mvd_grid[l][gi * 2] = m.mvd[l][bi][0] < 0
                    ? -m.mvd[l][bi][0] : m.mvd[l][bi][0];
                D.mvd_grid[l][gi * 2 + 1] = m.mvd[l][bi][1] < 0
                    ? -m.mvd[l][bi][1] : m.mvd[l][bi][1];
                D.mv_done[l][gi] = 1;
            }
}

// write refidx only (B MBs: all ref_idx precede all mvd in the syntax, and
// CABAC ref_idx contexts read earlier partitions' refidx from the grids)
static void set_ref_only(Dec& D, MB& m, int mbx, int mby, int l, int bx0,
                         int by0, int w4, int h4, int r) {
    for (int y = 0; y < h4; y++)
        for (int x = 0; x < w4; x++) {
            int bi = (by0 + y) * 4 + bx0 + x;
            m.ref[l][bi] = (int8_t)r;
            int gi = (mby * 4 + by0 + y) * D.gw + mbx * 4 + bx0 + x;
            D.refidx[l][gi] = (int8_t)r;
            D.refpic[l][gi] = (r >= 0 && r < (int)D.reflist[l].size())
                                  ? D.reflist[l][r] : nullptr;
        }
}

// a decoded partition that does not use list l: refidx -1, zero mv, and
// motion-decoded (available-with-no-list for later predictors)
static void mark_list_unused(Dec& D, MB& m, int mbx, int mby, int l,
                             int bx0, int by0, int w4, int h4) {
    for (int y = 0; y < h4; y++)
        for (int x = 0; x < w4; x++) {
            int bi = (by0 + y) * 4 + bx0 + x;
            m.ref[l][bi] = -1;
            m.mvs[l][bi][0] = m.mvs[l][bi][1] = 0;
            m.mvd[l][bi][0] = m.mvd[l][bi][1] = 0;
            int gi = (mby * 4 + by0 + y) * D.gw + mbx * 4 + bx0 + x;
            D.refidx[l][gi] = -1;
            D.refpic[l][gi] = nullptr;
            D.mv[l][gi * 2] = D.mv[l][gi * 2 + 1] = 0;
            D.mvd_grid[l][gi * 2] = D.mvd_grid[l][gi * 2 + 1] = 0;
            D.mv_done[l][gi] = 1;
        }
}

// ---------------------------------------------------------------------------
// B direct motion (spec 8.4.1.2) — spatial & temporal, 8x8 inference
// ---------------------------------------------------------------------------
struct DirectCtx {
    bool prepared = false;
    Pic* col = nullptr;            // RefPicList1[0]
    bool col_st = false;           // colocated picture is short-term
    // spatial MB-level derivation (8.4.1.2.2)
    bool zero_pred = false;
    int ref[2] = {-1, -1};
    int mvx[2] = {0, 0}, mvy[2] = {0, 0};
};

static void direct_prepare(Dec& D, int mbx, int mby, DirectCtx& dc) {
    if (dc.prepared) return;
    dc.prepared = true;
    dc.col = D.reflist[1].empty() ? nullptr : D.reflist[1][0];
    dc.col_st = dc.col && !dc.col->long_term;
    if (!D.sh.direct_spatial) return;
    int gx = mbx * 4, gy = mby * 4;
    auto minpos = [](int a, int b) {
        return (a >= 0 && b >= 0) ? imin(a, b) : imax(a, b);
    };
    for (int l = 0; l < 2; l++) {
        NB A = nb_at(D, l, gx - 1, gy);
        NB B = nb_at(D, l, gx, gy - 1);
        NB C = nb_at(D, l, gx + 4, gy - 1);
        if (!C.mbav) C = nb_at(D, l, gx - 1, gy - 1);
        dc.ref[l] = minpos(minpos(A.avail ? A.ref : -1,
                                  B.avail ? B.ref : -1),
                           C.avail ? C.ref : -1);
    }
    if (dc.ref[0] < 0 && dc.ref[1] < 0) {
        dc.zero_pred = true;               // directZeroPredictionFlag
        dc.ref[0] = dc.ref[1] = 0;
        return;
    }
    for (int l = 0; l < 2; l++)
        if (dc.ref[l] >= 0)
            mv_pred(D, l, gx, gy, 4, 4, dc.ref[l], &dc.mvx[l], &dc.mvy[l]);
}

// colZeroFlag for the colocated 4x4 at grid (cgx, cgy)
static bool col_zero(Dec& D, DirectCtx& dc, int cgx, int cgy) {
    if (!dc.col || !dc.col_st) return false;
    size_t gi = (size_t)cgy * D.gw + cgx;
    int l = dc.col->refidx[0][gi] >= 0 ? 0 : 1;
    if (dc.col->refidx[l][gi] != 0) return false;  // intra (-1) or ref > 0
    int mx = dc.col->mv[l][gi * 2], my = dc.col->mv[l][gi * 2 + 1];
    return mx >= -1 && mx <= 1 && my >= -1 && my <= 1;
}

// temporal direct (8.4.1.2.3) for one 4x4, colocated sampled at (cgx,cgy)
static void direct_temporal_block(Dec& D, MB& m, int mbx, int mby,
                                  DirectCtx& dc, int bx, int by,
                                  int cgx, int cgy) {
    int mvcx = 0, mvcy = 0, r0 = 0;
    Pic* col = dc.col;
    if (!col || D.reflist[0].empty()) { D.fail("temporal direct: no refs");
                                        return; }
    size_t gi = (size_t)cgy * D.gw + cgx;
    int l = col->refidx[0][gi] >= 0 ? 0 : 1;
    int rc = col->refidx[l][gi];
    if (rc >= 0) {                       // inter colocated: map ref by POC
        mvcx = col->mv[l][gi * 2];
        mvcy = col->mv[l][gi * 2 + 1];
        int rpoc = col->refpoc[l][gi];
        for (size_t k = 0; k < D.reflist[0].size(); k++)
            if (D.reflist[0][k]->poc == rpoc) { r0 = (int)k; break; }
    }
    Pic* pic0 = D.reflist[0][r0];
    int m0x, m0y, m1x, m1y;
    int td = iclip(col->poc - pic0->poc, -128, 127);
    if (pic0->long_term || td == 0) {
        m0x = mvcx; m0y = mvcy; m1x = 0; m1y = 0;
    } else {
        int tb = iclip(D.cur->poc - pic0->poc, -128, 127);
        int tx = (16384 + (td >= 0 ? td : -td) / 2) / td;
        int dsf = iclip((tb * tx + 32) >> 6, -1024, 1023);
        m0x = (dsf * mvcx + 128) >> 8;
        m0y = (dsf * mvcy + 128) >> 8;
        m1x = m0x - mvcx; m1y = m0y - mvcy;
    }
    set_mv(D, m, mbx, mby, 0, bx, by, 1, 1, r0, m0x, m0y, 0, 0);
    set_mv(D, m, mbx, mby, 1, bx, by, 1, 1, 0, m1x, m1y, 0, 0);
}

// apply direct prediction to 8x8 quadrant q of the MB
static void direct_apply_quad(Dec& D, MB& m, int mbx, int mby,
                              DirectCtx& dc, int q) {
    direct_prepare(D, mbx, mby, dc);
    int qx = (q & 1) * 2, qy = (q >> 1) * 2;
    int g0x = mbx * 4, g0y = mby * 4;
    for (int sy = 0; sy < 2; sy++)
        for (int sx = 0; sx < 2; sx++)
            D.bdirect[(g0y + qy + sy) * D.gw + g0x + qx + sx] = 1;
    bool inf = D.sps.direct_8x8_inference != 0;
    int corner_x = (q & 1) ? 3 : 0, corner_y = (q >> 1) ? 3 : 0;
    for (int sy = 0; sy < 2; sy++)
        for (int sx = 0; sx < 2; sx++) {
            int bx = qx + sx, by = qy + sy;
            int cgx = inf ? g0x + corner_x : g0x + bx;
            int cgy = inf ? g0y + corner_y : g0y + by;
            if (D.sh.direct_spatial) {
                bool cz = !dc.zero_pred && col_zero(D, dc, cgx, cgy);
                for (int l = 0; l < 2; l++) {
                    int r = dc.ref[l];
                    if (r < 0) {
                        mark_list_unused(D, m, mbx, mby, l, bx, by, 1, 1);
                        continue;
                    }
                    int mx = dc.mvx[l], my = dc.mvy[l];
                    if (dc.zero_pred || (cz && r == 0)) { mx = 0; my = 0; }
                    set_mv(D, m, mbx, mby, l, bx, by, 1, 1, r, mx, my, 0, 0);
                }
            } else {
                direct_temporal_block(D, m, mbx, mby, dc, bx, by, cgx, cgy);
            }
        }
}

// ---------------------------------------------------------------------------
// Reconstruction
// ---------------------------------------------------------------------------
static void dequant_block(Dec& D, int* c, int qp, bool intra, bool is_dc_sub,
                          const uint8_t* weight) {
    // 4x4 AC/full block dequant (spec 8.5.12.1) with scaling-list weight
    int qp6 = qp / 6, qpm = qp % 6;
    int start = is_dc_sub ? 1 : 0;
    for (int i = start; i < 16; i++) {
        int ls = weight[i] * kV4[qpm][v4_idx(i)];
        if (qp6 >= 4) c[i] = (c[i] * ls) << (qp6 - 4);
        else c[i] = (c[i] * ls + (1 << (3 - qp6))) >> (4 - qp6);
    }
}

// scaling-list selection: idx 0..5 (Y intra, Cb intra, Cr intra, Y inter,
// Cb inter, Cr inter); PPS lists override SPS when present
static const uint8_t* w4_list(Dec& D, int comp, bool intra) {
    int idx = (intra ? 0 : 3) + comp;
    if (D.pps.pic_scaling_present || D.sps.seq_scaling_present) {
        // PPS scaling parsed into pps.scaling4 (flat when absent)
        return D.pps.pic_scaling_present ? D.pps.scaling4[idx]
                                         : D.sps.scaling4[idx];
    }
    static const uint8_t flat[16] = {16, 16, 16, 16, 16, 16, 16, 16,
                                     16, 16, 16, 16, 16, 16, 16, 16};
    return flat;
}

// 8x8 scaling list (idx 0 intra Y, 1 inter Y) with flat fallback
static const uint8_t* w8_list(Dec& D, bool intra) {
    int idx = intra ? 0 : 1;
    if (D.pps.pic_scaling_present) return D.pps.scaling8[idx];
    if (D.sps.seq_scaling_present) return D.sps.scaling8[idx];
    return D.pps.scaling8[idx];            // flat (16s) when absent
}

// dequantize one 8x8 block in raster order (spec 8.5.13.1)
static void dequant8_block(Dec& D, int* c, int qp, bool intra) {
    const uint8_t* w = w8_list(D, intra);
    int qp6 = qp / 6, qpm = qp % 6;
    for (int i = 0; i < 64; i++) {
        if (!c[i]) continue;
        int ls = w[i] * kV8[qpm][v8_idx(i)];
        if (qp6 >= 6) c[i] = (c[i] * ls) << (qp6 - 6);
        else c[i] = (c[i] * ls + (1 << (5 - qp6))) >> (6 - qp6);
    }
}

static void recon_luma_residual(Dec& D, MB& m, uint8_t* py_, int stride,
                                bool intra) {
    const uint8_t* w = w4_list(D, 0, intra);
    if (m.i16) {
        // luma DC: inverse hadamard + scale (spec 8.5.10)
        int f[16];
        for (int i = 0; i < 16; i++) f[i] = m.coeff_ldc[i];
        // coeff_ldc arrives in raster block order already
        hadamard4x4_ip(f);
        int qp = m.qp, qp6 = qp / 6, qpm = qp % 6;
        int ls = w[0] * kV4[qpm][0];
        int dc[16];
        for (int i = 0; i < 16; i++) {
            if (qp >= 36) dc[i] = (f[i] * ls) << (qp6 - 6);
            else dc[i] = (f[i] * ls + (1 << (5 - qp6))) >> (6 - qp6);
        }
        for (int b = 0; b < 16; b++) {
            int d[16];
            for (int i = 0; i < 16; i++)
                d[kZig4[i]] = i == 0 ? 0 : m.coeff_l[b][i];
            dequant_block(D, d, qp, intra, true, w);
            d[0] = dc[b];
            int bx = (b & 3) * 4, by = (b >> 2) * 4;
            idct4_add(py_ + by * stride + bx, stride, d);
        }
    } else if (m.t8x8) {
        for (int b8 = 0; b8 < 4; b8++) {
            if (!m.nnz8[b8]) continue;
            int d[64];
            for (int i = 0; i < 64; i++) d[kZig8[i]] = m.coeff8[b8][i];
            dequant8_block(D, d, m.qp, intra);
            int bx = (b8 & 1) * 8, by = (b8 >> 1) * 8;
            idct8_add(py_ + by * stride + bx, stride, d);
        }
    } else {
        for (int b = 0; b < 16; b++) {
            if (!m.nnz[b]) continue;
            int d[16];
            for (int i = 0; i < 16; i++) d[kZig4[i]] = m.coeff_l[b][i];
            dequant_block(D, d, m.qp, intra, false, w);
            int bx = (b & 3) * 4, by = (b >> 2) * 4;
            idct4_add(py_ + by * stride + bx, stride, d);
        }
    }
}

static void recon_chroma_residual(Dec& D, MB& m, uint8_t* pu_, uint8_t* pv_,
                                  int cstride, bool intra) {
    for (int comp = 0; comp < 2; comp++) {
        uint8_t* p = comp == 0 ? pu_ : pv_;
        int qpc_raw = iclip(m.qp + D.pps.chroma_qp_offset[comp], 0, 51);
        int qpc = kChromaQpMap[qpc_raw];
        const uint8_t* w = w4_list(D, 1 + comp, intra);
        // chroma DC 2x2 hadamard + scale (spec 8.5.11)
        int a = m.coeff_cdc[comp][0], b = m.coeff_cdc[comp][1];
        int c = m.coeff_cdc[comp][2], e = m.coeff_cdc[comp][3];
        int f0 = a + b + c + e, f1 = a - b + c - e;
        int f2 = a + b - c - e, f3 = a - b - c + e;
        int qp6 = qpc / 6, qpm = qpc % 6;
        int ls = w[0] * kV4[qpm][0];
        int dc[4] = {((f0 * ls) << qp6) >> 5, ((f1 * ls) << qp6) >> 5,
                     ((f2 * ls) << qp6) >> 5, ((f3 * ls) << qp6) >> 5};
        for (int blk = 0; blk < 4; blk++) {
            int d[16];
            bool any = m.cnnz[comp][blk] || dc[blk];
            if (!any) continue;
            for (int i = 0; i < 16; i++)
                d[kZig4[i]] = i == 0 ? 0 : m.coeff_cac[comp][blk][i];
            dequant_block(D, d, qpc, intra, true, w);
            d[0] = dc[blk];
            int bx = (blk & 1) * 4, by = (blk >> 1) * 4;
            idct4_add(p + by * cstride + bx, cstride, d);
        }
    }
}

}  // namespace hbdec

namespace hbdec {

// ---------------------------------------------------------------------------
// Inter prediction for one MB (list-0 + optional list-1 bi-prediction)
// ---------------------------------------------------------------------------
static bool sh_uses_list1(Dec& D, MB& m, int b4);
static void combine_pred(Dec& D, MB& m, int b4, bool bi,
                         int16_t bufy[2][256], int16_t bufu[2][64],
                         int16_t bufv[2][64],
                         uint8_t* py_, uint8_t* pu_, uint8_t* pv_);

static void inter_pred_mb(Dec& D, MB& m, int mbx, int mby) {
    int x0 = mbx * 16, y0 = mby * 16;
    // gather partition rectangles from the per-4x4 grids: process in 4x4
    // units but batch runs of equal (ref,mv) rows for speed later; here we
    // MC per 4x4-aligned partition block by scanning distinct regions.
    // Simpler: per 8x8 quadrant, per sub-block as stored (uniform 4x4).
    int16_t bufy[2][256], bufu[2][64], bufv[2][64];
    for (int b4 = 0; b4 < 16; b4++) {
        int bx = (b4 & 3), by = (b4 >> 2);
        bool bi = sh_uses_list1(D, m, b4);
        for (int l = 0; l < (bi ? 2 : 1); l++) {
            int li = bi ? l : (m.ref[0][b4] >= 0 ? 0 : 1);
            int r = m.ref[li][b4];
            if (r < 0 || r >= (int)D.reflist[li].size()) { D.fail("bad refidx"); return; }
            Pic* rp = D.reflist[li][r];
            int mvx = m.mvs[li][b4][0], mvy = m.mvs[li][b4][1];
            int lx = x0 + bx * 4, ly = y0 + by * 4;
            mc_luma(rp->y.data(), D.W, D.H, bufy[l] , 16, 4, 4,
                    lx + (mvx >> 2), ly + (mvy >> 2), mvx & 3, mvy & 3);
            int cx = lx >> 1, cy = ly >> 1;
            mc_chroma(rp->u.data(), D.W / 2, D.H / 2, bufu[l], 8, 2, 2,
                      cx + (mvx >> 3), cy + (mvy >> 3), mvx & 7, mvy & 7);
            mc_chroma(rp->v.data(), D.W / 2, D.H / 2, bufv[l], 8, 2, 2,
                      cx + (mvx >> 3), cy + (mvy >> 3), mvx & 7, mvy & 7);
            if (!bi) break;
        }
        // weighted / bi combination → write into picture planes
        uint8_t* py_ = D.cur->y.data() + (y0 + by * 4) * D.W + x0 + bx * 4;
        uint8_t* pu_ = D.cur->u.data() + (y0 / 2 + by * 2) * (D.W / 2)
                       + x0 / 2 + bx * 2;
        uint8_t* pv_ = D.cur->v.data() + (y0 / 2 + by * 2) * (D.W / 2)
                       + x0 / 2 + bx * 2;
        combine_pred(D, m, b4, bi, bufy, bufu, bufv, py_, pu_, pv_);
    }
}

// whether this 4x4 uses both lists (B MBs); defined below combine helpers
static bool sh_uses_list1(Dec& D, MB& m, int b4) {
    return D.sh.type == B_SLICE && m.ref[0][b4] >= 0 && m.ref[1][b4] >= 0;
}

static void combine_pred(Dec& D, MB& m, int b4, bool bi,
                         int16_t bufy[2][256], int16_t bufu[2][64],
                         int16_t bufv[2][64],
                         uint8_t* py_, uint8_t* pu_, uint8_t* pv_) {
    SliceHdr& sh = D.sh;
    bool weighted = false;
    int l_single = m.ref[0][b4] >= 0 ? 0 : 1;
    int r0 = m.ref[0][b4], r1 = m.ref[1][b4];
    if (sh.type == P_SLICE && D.pps.weighted_pred) weighted = true;
    if (sh.type == B_SLICE && D.pps.weighted_bipred_idc == 1) weighted = true;
    int wy[2] = {1, 1}, oy[2] = {0, 0}, ldy = 0;
    int wc[2][2] = {{1, 1}, {1, 1}}, oc[2][2] = {{0, 0}, {0, 0}}, ldc = 0;
    // implicit weighted bipred (idc 2, spec 8.4.2.3.1): only bipred blocks
    // are weighted, with the POC-distance table built per slice
    if (sh.type == B_SLICE && D.pps.weighted_bipred_idc == 2 && bi) {
        weighted = true;
        ldy = ldc = 5;
        int w1 = D.imp_w[r0 & 31][r1 & 31];
        wy[0] = 64 - w1; wy[1] = w1;
        for (int c = 0; c < 2; c++) {
            wc[0][c] = 64 - w1; wc[1][c] = w1;
        }
    } else if (weighted) {
        ldy = sh.luma_log2_wd; ldc = sh.chroma_log2_wd;
        for (int l = 0; l < 2; l++) {
            int r = l == 0 ? r0 : r1;
            if (r < 0) continue;
            wy[l] = sh.wp[l][r][0].w; oy[l] = sh.wp[l][r][0].o;
            for (int c = 0; c < 2; c++) {
                wc[l][c] = sh.wp[l][r][1 + c].w;
                oc[l][c] = sh.wp[l][r][1 + c].o;
            }
        }
    }
    auto put = [&](uint8_t* dst, int dstride, const int16_t* b0,
                   const int16_t* b1, int bw, int bh, int bstride,
                   int w0, int w1, int o0, int o1, int ld) {
        for (int y = 0; y < bh; y++)
            for (int x = 0; x < bw; x++) {
                int v;
                if (bi) {
                    if (weighted || ld)
                        v = ((b0[y * bstride + x] * w0 +
                              b1[y * bstride + x] * w1 +
                              (1 << ld)) >> (ld + 1)) + ((o0 + o1 + 1) >> 1);
                    else
                        v = (b0[y * bstride + x] +
                             b1[y * bstride + x] + 1) >> 1;
                } else {
                    if (weighted) {
                        int wl = l_single == 0 ? w0 : w1;
                        int ol = l_single == 0 ? o0 : o1;
                        v = ld > 0 ? ((b0[y * bstride + x] * wl +
                                       (1 << (ld - 1))) >> ld) + ol
                                   : b0[y * bstride + x] * wl + ol;
                    } else {
                        v = b0[y * bstride + x];
                    }
                }
                dst[y * dstride + x] = clip255(v);
            }
    };
    // weights for the single-list path must come from that list
    if (weighted && !bi && l_single == 1) {
        wy[0] = sh.wp[1][r1][0].w; oy[0] = sh.wp[1][r1][0].o;
        for (int c = 0; c < 2; c++) {
            wc[0][c] = sh.wp[1][r1][1 + c].w;
            oc[0][c] = sh.wp[1][r1][1 + c].o;
        }
        l_single = 0;
    }
    put(py_, D.W, bufy[0], bufy[1], 4, 4, 16,
        wy[0], wy[1], oy[0], oy[1], ldy);
    put(pu_, D.W / 2, bufu[0], bufu[1], 2, 2, 8,
        wc[0][0], wc[1][0], oc[0][0], oc[1][0], ldc);
    put(pv_, D.W / 2, bufv[0], bufv[1], 2, 2, 8,
        wc[0][1], wc[1][1], oc[0][1], oc[1][1], ldc);
}

}  // namespace hbdec

namespace hbdec {

// ---------------------------------------------------------------------------
// Full MB reconstruction (prediction + residual), marks blk_done
// ---------------------------------------------------------------------------
static void recon_mb(Dec& D, MB& m, int mbx, int mby) {
    int x0 = mbx * 16, y0 = mby * 16;
    int cs = D.W / 2;
    uint8_t* py_ = D.cur->y.data() + y0 * D.W + x0;
    uint8_t* pu_ = D.cur->u.data() + (y0 / 2) * cs + x0 / 2;
    uint8_t* pv_ = D.cur->v.data() + (y0 / 2) * cs + x0 / 2;
    int g0x = mbx * 4, g0y = mby * 4;

    if (m.pcm) {
        for (int y = 0; y < 16; y++)
            memcpy(py_ + y * D.W, m.pcm_data + y * 16, 16);
        for (int y = 0; y < 8; y++) {
            memcpy(pu_ + y * cs, m.pcm_data + 256 + y * 8, 8);
            memcpy(pv_ + y * cs, m.pcm_data + 320 + y * 8, 8);
        }
    } else if (m.intra && !m.i16 && m.t8x8) {
        // Intra 8x8: per-block predict + residual, z order
        for (int b8 = 0; b8 < 4; b8++) {
            int bx = (b8 & 1) * 2, by = (b8 >> 1) * 2;
            int gx = g0x + bx, gy = g0y + by;
            uint8_t* dst = py_ + by * 4 * D.W + bx * 4;
            bool ha = blk_avail(D, gx - 1, gy);
            bool hb = blk_avail(D, gx, gy - 1);
            bool hc = blk_avail(D, gx + 2, gy - 1);
            bool hd = blk_avail(D, gx - 1, gy - 1);
            intra8x8_pred(dst, D.W, m.ipred8[b8], ha, hb, hc, hd);
            if (m.nnz8[b8]) {
                int d[64];
                for (int i = 0; i < 64; i++)
                    d[kZig8[i]] = m.coeff8[b8][i];
                dequant8_block(D, d, m.qp, true);
                idct8_add(dst, D.W, d);
            }
            for (int yy = 0; yy < 2; yy++)
                for (int xx = 0; xx < 2; xx++)
                    g_pc.blk_done[(gy + yy) * D.gw + gx + xx] = 1;
        }
    } else if (m.intra && !m.i16) {
        // Intra 4x4: per-block predict + residual, z-scan order
        static const int zs[16] = {0, 1, 4, 5, 2, 3, 6, 7,
                                   8, 9, 12, 13, 10, 11, 14, 15};
        const uint8_t* w = w4_list(D, 0, true);
        for (int k = 0; k < 16; k++) {
            int b = zs[k];
            int bx = (b & 3), by = (b >> 2);
            int gx = g0x + bx, gy = g0y + by;
            uint8_t* dst = py_ + by * 4 * D.W + bx * 4;
            bool ha = blk_avail(D, gx - 1, gy);
            bool hb = blk_avail(D, gx, gy - 1);
            bool hc = blk_avail(D, gx + 1, gy - 1);
            bool hd = blk_avail(D, gx - 1, gy - 1);
            intra4x4_pred(dst, D.W, m.ipred[b], ha, hb, hc, hd);
            if (m.nnz[b]) {
                int d[16];
                for (int i = 0; i < 16; i++) d[kZig4[i]] = m.coeff_l[b][i];
                dequant_block(D, d, m.qp, true, false, w);
                idct4_add(dst, D.W, d);
            }
            g_pc.blk_done[gy * D.gw + gx] = 1;
        }
    } else if (m.i16) {
        bool ha = mb_avail(D, mbx - 1, mby);
        bool hb = mb_avail(D, mbx, mby - 1);
        intra16_pred(py_, D.W, m.i16mode, ha, hb);
        recon_luma_residual(D, m, py_, D.W, true);
    } else {
        inter_pred_mb(D, m, mbx, mby);
        if (D.err) return;
        recon_luma_residual(D, m, py_, D.W, false);
    }
    // chroma prediction
    if (m.intra && !m.pcm) {
        bool ha = mb_avail(D, mbx - 1, mby);
        bool hb = mb_avail(D, mbx, mby - 1);
        chroma_pred(pu_, cs, m.cmode, ha, hb);
        chroma_pred(pv_, cs, m.cmode, ha, hb);
    }
    if (!m.pcm)
        recon_chroma_residual(D, m, pu_, pv_, cs, m.intra);
    for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++)
            g_pc.blk_done[(g0y + y) * D.gw + g0x + x] = 1;
    D.mb_done[mby * D.mb_w + mbx] = 1;
}

// ---------------------------------------------------------------------------
// Per-MB bookkeeping shared by both entropy parsers
// ---------------------------------------------------------------------------
static void store_mb_state(Dec& D, MB& m, int mbx, int mby) {
    int i = mby * D.mb_w + mbx;
    D.mb_intra[i] = m.intra || m.pcm;
    D.mb_skip[i] = m.skip;
    D.mb_i16[i] = m.i16;
    D.mb_pcm[i] = m.pcm;
    D.mb_bds[i] = m.b_direct ? 1 : 0;
    D.mb_cbp[i] = (uint8_t)(m.pcm ? 0x2F : m.cbp);
    D.mb_t8x8[i] = m.t8x8 ? 1 : 0;
    D.mb_cmode[i] = (uint8_t)m.cmode;
    D.mb_qp[i] = (int8_t)m.qp;
    int g0 = mby * 4 * D.gw + mbx * 4;
    for (int y = 0; y < 4; y++)
        for (int x = 0; x < 4; x++) {
            int b = y * 4 + x;
            D.nnz_l[g0 + y * D.gw + x] = m.pcm ? 16 : m.nnz[b];
            g_pc.blk_parsed[g0 + y * D.gw + x] = 1;
            D.ipred4[g0 + y * D.gw + x] =
                (m.intra && !m.i16 && !m.pcm) ? (int8_t)m.ipred[b]
                                              : (int8_t)(m.intra ? 2 : -1);
        }
    int c0 = mby * 2 * (D.mb_w * 2) + mbx * 2;
    for (int comp = 0; comp < 2; comp++)
        for (int y = 0; y < 2; y++)
            for (int x = 0; x < 2; x++) {
                D.nnz_c[comp][c0 + y * D.mb_w * 2 + x] =
                    m.pcm ? 16 : m.cnnz[comp][y * 2 + x];
                g_pc.cblk_parsed[comp][c0 + y * D.mb_w * 2 + x] = 1;
            }
    D.mb_dc_cbf[i] = 0;
    for (int k = 0; k < 16; k++) if (m.coeff_ldc[k]) D.mb_dc_cbf[i] = 1;
    for (int comp = 0; comp < 2; comp++) {
        D.mb_cdc_cbf[comp][i] = 0;
        for (int k = 0; k < 4; k++)
            if (m.coeff_cdc[comp][k]) D.mb_cdc_cbf[comp][i] = 1;
    }
    flush_mv_grids(D, m, mbx, mby);
    D.mb_dbf_disable[i] = (int8_t)D.sh.disable_deblock;
    D.mb_alpha_off[i] = (int8_t)D.sh.alpha_off;
    D.mb_beta_off[i] = (int8_t)D.sh.beta_off;
    g_pc.mb_slice[i] = g_pc.slice_id;
}

static void init_mb(MB& m, int qp) {
    memset(m.ref, -1, sizeof(m.ref));
    memset(m.mvs, 0, sizeof(m.mvs));
    memset(m.mvd, 0, sizeof(m.mvd));
    memset(m.coeff_l, 0, sizeof(m.coeff_l));
    memset(m.coeff8, 0, sizeof(m.coeff8));
    m.t8x8 = false;
    for (int i = 0; i < 4; i++) { m.ipred8[i] = 2; m.nnz8[i] = 0; }
    memset(m.coeff_ldc, 0, sizeof(m.coeff_ldc));
    memset(m.coeff_cdc, 0, sizeof(m.coeff_cdc));
    memset(m.coeff_cac, 0, sizeof(m.coeff_cac));
    memset(m.nnz, 0, sizeof(m.nnz));
    memset(m.cnnz, 0, sizeof(m.cnnz));
    for (int i = 0; i < 16; i++) m.ipred[i] = 2;
    m.qp = qp;
}

// intra4x4 most-probable-mode (spec 8.3.1.1).  Blocks inside the current
// (still-parsing) MB come from m.ipred — left/top neighbours always
// precede the current block in z-scan order.
static int mpm4(Dec& D, MB& m, int mbx, int mby, int gx, int gy) {
    auto mode_of = [&](int x, int y) -> int {
        if (x < 0 || y < 0 || x >= D.gw || y >= D.gh) return -1;
        if ((x >> 2) == mbx && (y >> 2) == mby)
            return m.ipred[(y & 3) * 4 + (x & 3)];
        int mb = (y >> 2) * D.mb_w + (x >> 2);
        if (g_pc.mb_slice[mb] != g_pc.slice_id) return -1;
        if (!g_pc.blk_parsed[y * D.gw + x]) return -1;
        int v = D.ipred4[y * D.gw + x];
        return v < 0 ? 2 : v;         // inter neighbour → DC
    };
    int a = mode_of(gx - 1, gy), b = mode_of(gx, gy - 1);
    if (a < 0 || b < 0) return 2;
    return imin(a, b);
}

}  // namespace hbdec

namespace hbdec {

static const int kZScan16[16] = {0, 1, 4, 5, 2, 3, 6, 7,
                                 8, 9, 12, 13, 10, 11, 14, 15};

// te(v) with range max (spec 9.1.1)
static int te(BR& br, int maxv) {
    if (maxv == 0) return 0;
    if (maxv == 1) return 1 - br.bit();
    return (int)br.ue();
}

// ---------------------------------------------------------------------------
// Residual parse — CAVLC (writes nnz grids progressively for nC context)
// ---------------------------------------------------------------------------
static bool parse_residual_cavlc(Dec& D, BR& br, MB& m, int mbx, int mby) {
    int g0x = mbx * 4, g0y = mby * 4;
    int tmp[16];
    if (m.i16) {
        int nc = luma_nc(D, g0x, g0y);
        int tc = cavlc_residual(D, br, tmp, 16, nc);
        if (tc < 0) return false;
        for (int i = 0; i < 16; i++) m.coeff_ldc[kZig4[i]] = tmp[i];
    }
    if (m.cbp & 15) {
        for (int k = 0; k < 16; k++) {
            int b = kZScan16[k];
            int quad = (b >> 3) * 2 + ((b & 3) >> 1);
            int gx = g0x + (b & 3), gy = g0y + (b >> 2);
            if (!m.i16 && !((m.cbp >> quad) & 1)) {
                D.nnz_l[gy * D.gw + gx] = 0;
                g_pc.blk_parsed[gy * D.gw + gx] = 1;
                continue;
            }
            int nc = luma_nc(D, gx, gy);
            int maxc = m.i16 ? 15 : 16;
            int tc = cavlc_residual(D, br, tmp, maxc, nc);
            if (tc < 0) return false;
            if (getenv("HBDEC_RTRACE")) {
                fprintf(stderr, "RT g(%d,%d) k%d nc%d tc%d:", gx, gy, k,
                        nc, tc);
                for (int i = 0; i < maxc; i++)
                    fprintf(stderr, " %d", tmp[i]);
                fprintf(stderr, "\n");
            }
            if (m.t8x8) {
                // 8x8 transform: sub-stream k&3 interleaves into the 8x8
                // scan (spec 8.5.6 [xD,yD] mapping)
                for (int i = 0; i < 16; i++)
                    m.coeff8[quad][4 * i + (k & 3)] = tmp[i];
                m.nnz8[quad] += tc;
            } else if (m.i16)
                for (int i = 0; i < 15; i++) m.coeff_l[b][i + 1] = tmp[i];
            else
                for (int i = 0; i < 16; i++) m.coeff_l[b][i] = tmp[i];
            m.nnz[b] = tc;
            D.nnz_l[gy * D.gw + gx] = tc;
            g_pc.blk_parsed[gy * D.gw + gx] = 1;
        }
    } else {
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) {
                D.nnz_l[(g0y + y) * D.gw + g0x + x] = 0;
                g_pc.blk_parsed[(g0y + y) * D.gw + g0x + x] = 1;
            }
    }
    int cw = D.mb_w * 2;
    int c0x = mbx * 2, c0y = mby * 2;
    int cbp_c = m.cbp >> 4;
    if (cbp_c) {
        for (int comp = 0; comp < 2; comp++) {
            int tc = cavlc_residual(D, br, tmp, 4, -1);
            if (tc < 0) return false;
            for (int i = 0; i < 4; i++) m.coeff_cdc[comp][i] = tmp[i];
        }
    }
    if (cbp_c == 2) {
        for (int comp = 0; comp < 2; comp++)
            for (int b = 0; b < 4; b++) {
                int cx = c0x + (b & 1), cy = c0y + (b >> 1);
                int nc = chroma_nc(D, comp, cx, cy);
                int tc = cavlc_residual(D, br, tmp, 15, nc);
                if (tc < 0) return false;
                for (int i = 0; i < 15; i++)
                    m.coeff_cac[comp][b][i + 1] = tmp[i];
                m.cnnz[comp][b] = tc;
                D.nnz_c[comp][cy * cw + cx] = tc;
                g_pc.cblk_parsed[comp][cy * cw + cx] = 1;
            }
    } else {
        for (int comp = 0; comp < 2; comp++)
            for (int y = 0; y < 2; y++)
                for (int x = 0; x < 2; x++) {
                    D.nnz_c[comp][(c0y + y) * cw + c0x + x] = 0;
                    g_pc.cblk_parsed[comp][(c0y + y) * cw + c0x + x] = 1;
                }
    }
    return true;
}

// ---------------------------------------------------------------------------
// Inter partition parse (shared shape logic; `rd` abstracts ref/mvd reads)
// ---------------------------------------------------------------------------
// transform_size_8x8_flag present for this inter MB? (spec 7.3.5)
static bool t8_allowed_inter(Dec& D, MB& m, bool b_slice, int mb_type) {
    if (!D.pps.transform_8x8_mode) return false;
    if (!(m.cbp & 15)) return false;
    if (b_slice) {
        if (mb_type == 0)                      // B_Direct_16x16
            return D.sps.direct_8x8_inference != 0;
        if (mb_type == 22)
            for (int q = 0; q < 4; q++) {
                int st = m.sub[q];
                if (st == 0) {
                    if (!D.sps.direct_8x8_inference) return false;
                } else if (st > 3) {
                    return false;              // sub-8x8 partition
                }
            }
        return true;
    }
    if (mb_type >= 3)                          // P_8x8: all subs 8x8
        for (int q = 0; q < 4; q++)
            if (m.sub[q] != 0) return false;
    return true;
}

static void apply_qp_delta(Dec& D, MB& m, int delta) {
    D.cur_qp = (D.cur_qp + delta + 52) % 52;
    m.qp = D.cur_qp;
}

// entropy-coder-agnostic symbol source for inter partition parsing
struct SymIO {
    virtual int sub_type() = 0;                       // P/B sub_mb_type
    virtual int ref(int l, int gx, int gy) = 0;       // ref_idx
    virtual int mvd(int l, int comp, int gx, int gy) = 0;
    virtual ~SymIO() {}
};

static bool parse_p_partitions(Dec& D, MB& m, int mbx, int mby,
                               int mb_type, SymIO& io) {
    int nref = D.sh.num_ref_idx[0];
    int g0x = mbx * 4, g0y = mby * 4;
    if (mb_type == 0) {                        // 16x16
        int r = nref > 1 ? io.ref(0, g0x, g0y) : 0;
        int px, py;
        mv_pred(D, 0, g0x, g0y, 4, 4, r, &px, &py);
        int dx = io.mvd(0, 0, g0x, g0y), dy = io.mvd(0, 1, g0x, g0y);
        set_mv(D, m, mbx, mby, 0, 0, 0, 4, 4, r, px + dx, py + dy, dx, dy);
        m.part = 0;
    } else if (mb_type == 1) {                 // 16x8
        int r0 = nref > 1 ? io.ref(0, g0x, g0y) : 0;
        set_ref_only(D, m, mbx, mby, 0, 0, 0, 4, 2, r0);
        int r1 = nref > 1 ? io.ref(0, g0x, g0y + 2) : 0;
        set_ref_only(D, m, mbx, mby, 0, 0, 2, 4, 2, r1);
        for (int p = 0; p < 2; p++) {
            int r = p == 0 ? r0 : r1;
            int px, py;
            mv_pred(D, 0, g0x, g0y + p * 2, 4, 2, r, &px, &py);
            int dx = io.mvd(0, 0, g0x, g0y + p * 2);
            int dy = io.mvd(0, 1, g0x, g0y + p * 2);
            set_mv(D, m, mbx, mby, 0, 0, p * 2, 4, 2, r,
                   px + dx, py + dy, dx, dy);
        }
        m.part = 1;
    } else if (mb_type == 2) {                 // 8x16
        int r0 = nref > 1 ? io.ref(0, g0x, g0y) : 0;
        set_ref_only(D, m, mbx, mby, 0, 0, 0, 2, 4, r0);
        int r1 = nref > 1 ? io.ref(0, g0x + 2, g0y) : 0;
        set_ref_only(D, m, mbx, mby, 0, 2, 0, 2, 4, r1);
        for (int p = 0; p < 2; p++) {
            int r = p == 0 ? r0 : r1;
            int px, py;
            mv_pred(D, 0, g0x + p * 2, g0y, 2, 4, r, &px, &py);
            int dx = io.mvd(0, 0, g0x + p * 2, g0y);
            int dy = io.mvd(0, 1, g0x + p * 2, g0y);
            set_mv(D, m, mbx, mby, 0, p * 2, 0, 2, 4, r,
                   px + dx, py + dy, dx, dy);
        }
        m.part = 2;
    } else {                                   // P_8x8 / P_8x8ref0
        bool ref0 = mb_type == 4;
        for (int q = 0; q < 4; q++) m.sub[q] = io.sub_type();
        int refs[4] = {0, 0, 0, 0};
        for (int q = 0; q < 4; q++) {
            if (!ref0 && nref > 1)
                refs[q] = io.ref(0, g0x + (q & 1) * 2, g0y + (q >> 1) * 2);
            set_ref_only(D, m, mbx, mby, 0, (q & 1) * 2, (q >> 1) * 2,
                         2, 2, refs[q]);
        }
        for (int q = 0; q < 4; q++) {
            int qx = (q & 1) * 2, qy = (q >> 1) * 2;
            int st = m.sub[q];
            int nsub = st == 0 ? 1 : (st == 3 ? 4 : 2);
            for (int sp = 0; sp < nsub; sp++) {
                int bx, by, w4, h4;
                if (st == 0) { bx = qx; by = qy; w4 = 2; h4 = 2; }
                else if (st == 1) { bx = qx; by = qy + sp; w4 = 2; h4 = 1; }
                else if (st == 2) { bx = qx + sp; by = qy; w4 = 1; h4 = 2; }
                else { bx = qx + (sp & 1); by = qy + (sp >> 1);
                       w4 = 1; h4 = 1; }
                int px, py;
                mv_pred(D, 0, g0x + bx, g0y + by, w4, h4, refs[q],
                        &px, &py);
                int dx = io.mvd(0, 0, g0x + bx, g0y + by);
                int dy = io.mvd(0, 1, g0x + bx, g0y + by);
                set_mv(D, m, mbx, mby, 0, bx, by, w4, h4, refs[q],
                       px + dx, py + dy, dx, dy);
            }
        }
        m.part = 3;
    }
    return true;
}

// B mb_type tables (spec Table 7-14): partition shape (0 16x16, 1 16x8,
// 2 8x16, 3 8x8) and per-partition prediction masks (1 L0, 2 L1, 3 Bi)
static const int8_t kBShape[23] = {0, 0, 0, 0, 1, 2, 1, 2, 1, 2, 1, 2,
                                   1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 3};
static const int8_t kBPred[23][2] = {
    {0, 0}, {1, 0}, {2, 0}, {3, 0},
    {1, 1}, {1, 1}, {2, 2}, {2, 2}, {1, 2}, {1, 2}, {2, 1}, {2, 1},
    {1, 3}, {1, 3}, {2, 3}, {2, 3}, {3, 1}, {3, 1}, {3, 2}, {3, 2},
    {3, 3}, {3, 3}, {0, 0}};
// B sub_mb_type (Table 7-18): pred mask + shape (0 8x8, 1 8x4, 2 4x8, 3 4x4)
static const int8_t kBSubPred[13] = {0, 1, 2, 3, 1, 1, 2, 2, 3, 3, 1, 2, 3};
static const int8_t kBSubShape[13] = {0, 0, 0, 0, 1, 2, 1, 2, 1, 2, 3, 3, 3};

static bool parse_b_partitions(Dec& D, MB& m, int mbx, int mby, int mb_type,
                               SymIO& io, DirectCtx& dc) {
    int g0x = mbx * 4, g0y = mby * 4;
    if (mb_type == 0) {                            // B_Direct_16x16
        for (int q = 0; q < 4; q++) direct_apply_quad(D, m, mbx, mby, dc, q);
        m.b_direct = true;
        m.part = 3;
        return true;
    }
    if (mb_type < 22) {
        int shape = kBShape[mb_type];
        int np = shape == 0 ? 1 : 2;
        int refs[2][2] = {{-1, -1}, {-1, -1}};
        // all ref_idx_l0, then all ref_idx_l1 (spec 7.3.5.1 mb_pred)
        for (int l = 0; l < 2; l++)
            for (int p = 0; p < np; p++) {
                int bx0 = shape == 2 ? p * 2 : 0;
                int by0 = shape == 1 ? p * 2 : 0;
                int w4 = shape == 2 ? 2 : 4, h4 = shape == 1 ? 2 : 4;
                int r = -1;
                if ((kBPred[mb_type][p] >> l) & 1)
                    r = D.sh.num_ref_idx[l] > 1
                            ? io.ref(l, g0x + bx0, g0y + by0) : 0;
                refs[l][p] = r;
                set_ref_only(D, m, mbx, mby, l, bx0, by0, w4, h4, r);
            }
        // all mvd_l0, then all mvd_l1
        for (int l = 0; l < 2; l++)
            for (int p = 0; p < np; p++) {
                int bx0 = shape == 2 ? p * 2 : 0;
                int by0 = shape == 1 ? p * 2 : 0;
                int w4 = shape == 2 ? 2 : 4, h4 = shape == 1 ? 2 : 4;
                if (refs[l][p] < 0) {
                    mark_list_unused(D, m, mbx, mby, l, bx0, by0, w4, h4);
                    continue;
                }
                int px, py;
                mv_pred(D, l, g0x + bx0, g0y + by0, w4, h4, refs[l][p],
                        &px, &py);
                int dx = io.mvd(l, 0, g0x + bx0, g0y + by0);
                int dy = io.mvd(l, 1, g0x + bx0, g0y + by0);
                set_mv(D, m, mbx, mby, l, bx0, by0, w4, h4, refs[l][p],
                       px + dx, py + dy, dx, dy);
            }
        m.part = shape;
        return true;
    }
    // B_8x8
    for (int q = 0; q < 4; q++) {
        m.sub[q] = io.sub_type();
        if ((unsigned)m.sub[q] > 12) { D.fail("bad B sub_mb_type");
                                       return false; }
    }
    // direct quadrants derive motion before any ref/mvd parse: their
    // refidx/mv feed later quadrants' contexts and predictors
    for (int q = 0; q < 4; q++)
        if (m.sub[q] == 0) direct_apply_quad(D, m, mbx, mby, dc, q);
    for (int l = 0; l < 2; l++)
        for (int q = 0; q < 4; q++) {
            int st = m.sub[q];
            if (st == 0) continue;
            int qx = (q & 1) * 2, qy = (q >> 1) * 2;
            int r = -1;
            if ((kBSubPred[st] >> l) & 1)
                r = D.sh.num_ref_idx[l] > 1
                        ? io.ref(l, g0x + qx, g0y + qy) : 0;
            set_ref_only(D, m, mbx, mby, l, qx, qy, 2, 2, r);
        }
    for (int l = 0; l < 2; l++)
        for (int q = 0; q < 4; q++) {
            int st = m.sub[q];
            if (st == 0) continue;
            int qx = (q & 1) * 2, qy = (q >> 1) * 2;
            if (!((kBSubPred[st] >> l) & 1)) {
                mark_list_unused(D, m, mbx, mby, l, qx, qy, 2, 2);
                continue;
            }
            int r = m.ref[l][qy * 4 + qx];
            int shape = kBSubShape[st];
            int nsub = shape == 0 ? 1 : (shape == 3 ? 4 : 2);
            for (int sp = 0; sp < nsub; sp++) {
                int bx, by, w4, h4;
                if (shape == 0) { bx = qx; by = qy; w4 = 2; h4 = 2; }
                else if (shape == 1) { bx = qx; by = qy + sp; w4 = 2; h4 = 1; }
                else if (shape == 2) { bx = qx + sp; by = qy; w4 = 1; h4 = 2; }
                else { bx = qx + (sp & 1); by = qy + (sp >> 1);
                       w4 = 1; h4 = 1; }
                int px, py;
                mv_pred(D, l, g0x + bx, g0y + by, w4, h4, r, &px, &py);
                int dx = io.mvd(l, 0, g0x + bx, g0y + by);
                int dy = io.mvd(l, 1, g0x + bx, g0y + by);
                set_mv(D, m, mbx, mby, l, bx, by, w4, h4, r,
                       px + dx, py + dy, dx, dy);
            }
        }
    m.part = 3;
    return true;
}

}  // namespace hbdec

namespace hbdec {

struct CavlcIO : SymIO {
    Dec& D; BR& br;
    CavlcIO(Dec& d, BR& b) : D(d), br(b) {}
    int sub_type() override { return (int)br.ue(); }
    int ref(int l, int, int) override {
        return te(br, D.sh.num_ref_idx[l] - 1);
    }
    int mvd(int, int, int, int) override { return br.se(); }
};

// decode one non-skip MB, CAVLC (spec 7.3.5 macroblock_layer)
static bool parse_mb_cavlc(Dec& D, BR& br, int mbx, int mby, MB& m) {
    init_mb(m, D.cur_qp);
    int mb_type = (int)br.ue();
    if (getenv("HBDEC_TRACE"))
        fprintf(stderr, "  mbtype %d at bit %d\n", mb_type, br.pos);
    bool p_slice = D.sh.type == P_SLICE;
    int t = mb_type;
    if (p_slice) {
        if (mb_type < 5) {
            m.intra = false;
            CavlcIO io(D, br);
            if (!parse_p_partitions(D, m, mbx, mby, mb_type, io))
                return false;
            int code = (int)br.ue();
            if (code > 47) return false;
            m.cbp = CBP_INTER_DEC[code];
            if (getenv("HBDEC_TRACE"))
                fprintf(stderr, "  P cbp %d at bit %d allowed %d\n",
                        m.cbp, br.pos, t8_allowed_inter(D, m, false, mb_type));
            if (t8_allowed_inter(D, m, false, mb_type))
                m.t8x8 = br.bit();
            if (getenv("HBDEC_TRACE"))
                fprintf(stderr, "  P t8 %d at bit %d\n", (int)m.t8x8, br.pos);
            if (m.cbp) apply_qp_delta(D, m, br.se());
            return parse_residual_cavlc(D, br, m, mbx, mby);
        }
        t = mb_type - 5;
    } else if (D.sh.type == B_SLICE) {
        if (mb_type < 23) {
            m.intra = false;
            CavlcIO io(D, br);
            DirectCtx dc;
            if (!parse_b_partitions(D, m, mbx, mby, mb_type, io, dc))
                return false;
            int code = (int)br.ue();
            if (code > 47) return false;
            m.cbp = CBP_INTER_DEC[code];
            if (t8_allowed_inter(D, m, true, mb_type))
                m.t8x8 = br.bit();
            if (m.cbp) apply_qp_delta(D, m, br.se());
            return parse_residual_cavlc(D, br, m, mbx, mby);
        }
        t = mb_type - 23;
    }
    m.intra = true;
    if (t == 0) {                              // I_NxN (4x4 / 8x8)
        if (D.pps.transform_8x8_mode) m.t8x8 = br.bit();
        if (m.t8x8) {
            for (int b8 = 0; b8 < 4; b8++) {
                int bx = (b8 & 1) * 2, by = (b8 >> 1) * 2;
                int gx = mbx * 4 + bx, gy = mby * 4 + by;
                int pred = mpm4(D, m, mbx, mby, gx, gy);
                int mode;
                if (br.bit()) mode = pred;
                else {
                    int r = (int)br.u(3);
                    mode = r < pred ? r : r + 1;
                }
                m.ipred8[b8] = mode;
                for (int yy = 0; yy < 2; yy++)
                    for (int xx = 0; xx < 2; xx++)
                        m.ipred[(by + yy) * 4 + bx + xx] = mode;
            }
        } else
        for (int k = 0; k < 16; k++) {
            int b = kZScan16[k];
            int gx = mbx * 4 + (b & 3), gy = mby * 4 + (b >> 2);
            int pred = mpm4(D, m, mbx, mby, gx, gy);
            if (br.bit()) m.ipred[b] = pred;
            else {
                int r = (int)br.u(3);
                m.ipred[b] = r < pred ? r : r + 1;
            }
        }
        m.cmode = (int)br.ue();
        int code = (int)br.ue();
        if (code > 47) return false;
        m.cbp = CBP_INTRA_DEC[code];
        if (m.cbp) apply_qp_delta(D, m, br.se());
        return parse_residual_cavlc(D, br, m, mbx, mby);
    }
    if (t == 25) {                             // I_PCM
        m.pcm = true;
        m.qp = 0;          // spec 8.7: I_PCM filters with QPY = 0
        while (br.pos & 7) br.bit();           // pcm_alignment_zero_bit
        for (int i = 0; i < 384; i++) m.pcm_data[i] = (uint8_t)br.u(8);
        for (int i = 0; i < 16; i++) m.nnz[i] = 16;
        for (int c = 0; c < 2; c++)
            for (int i = 0; i < 4; i++) m.cnnz[c][i] = 16;
        // PCM leaves QP unchanged; mark parse grids
        int g0 = mby * 4 * D.gw + mbx * 4;
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) {
                D.nnz_l[g0 + y * D.gw + x] = 16;
                g_pc.blk_parsed[g0 + y * D.gw + x] = 1;
            }
        return !br.err;
    }
    m.i16 = true;
    m.i16mode = (t - 1) & 3;
    int cc = ((t - 1) >> 2) % 3;
    int ac = (t - 1) / 12;
    m.cbp = (ac ? 15 : 0) | (cc << 4);
    m.cmode = (int)br.ue();
    apply_qp_delta(D, m, br.se());
    return parse_residual_cavlc(D, br, m, mbx, mby);
}

// P_Skip / B_Skip macroblock
static void decode_skip_mb(Dec& D, int mbx, int mby, MB& m) {
    init_mb(m, D.cur_qp);
    m.skip = true;
    m.intra = false;
    m.part = 0;
    g_pc.mb_slice[mby * D.mb_w + mbx] = g_pc.slice_id;
    if (D.sh.type == B_SLICE) {                 // B_Skip = direct, no coeffs
        DirectCtx dc;
        for (int q = 0; q < 4; q++) direct_apply_quad(D, m, mbx, mby, dc, q);
        m.b_direct = true;
        m.part = 3;
        return;
    }
    int px, py;
    pskip_mv(D, mbx * 4, mby * 4, &px, &py);
    set_mv(D, m, mbx, mby, 0, 0, 0, 4, 4, 0, px, py, 0, 0);
}

// ---------------------------------------------------------------------------
// Slice data — CAVLC
// ---------------------------------------------------------------------------
static bool decode_slice_cavlc(Dec& D, BR& br) {
    int n_mb = D.mb_w * D.mb_h;
    int mb = D.sh.first_mb;
    D.cur_qp = D.sh.qp;
    while (mb < n_mb) {
        if (D.sh.type != I_SLICE) {
            if (!br.more_rbsp()) break;
            int run = (int)br.ue();
            while (run-- > 0 && mb < n_mb) {
                int mbx = mb % D.mb_w, mby = mb / D.mb_w;
                MB m;
                if (getenv("HBDEC_TRACE"))
                    fprintf(stderr, "mb %d skip qp %d\n", mb, D.cur_qp);
                decode_skip_mb(D, mbx, mby, m);
                recon_mb(D, m, mbx, mby);
                store_mb_state(D, m, mbx, mby);
                mb++;
            }
            if (mb >= n_mb) break;
        }
        if (!br.more_rbsp()) break;
        int mbx = mb % D.mb_w, mby = mb / D.mb_w;
        g_pc.mb_slice[mby * D.mb_w + mbx] = g_pc.slice_id;
        MB m;
        if (!parse_mb_cavlc(D, br, mbx, mby, m)) {
            if (getenv("HBDEC_TRACE"))
                fprintf(stderr, "parse fail at mb %d (%d,%d) bitpos %d/%d\n",
                        mb, mbx, mby, br.pos, br.n * 8);
            D.fail("cavlc mb parse error");
            return false;
        }
        if (getenv("HBDEC_TRACE"))
            fprintf(stderr,
                    "mb %d (%d,%d): intra%d i16:%d mode%d cbp %x qp %d "
                    "cmode %d nnz0 %d bit %d\n",
                    mb, mbx, mby, m.intra, m.i16, m.i16mode, m.cbp, m.qp,
                    m.cmode, m.nnz[0], br.pos);
        recon_mb(D, m, mbx, mby);
        if (D.err) return false;
        store_mb_state(D, m, mbx, mby);
        mb++;
    }
    return !br.err;
}

}  // namespace hbdec

namespace hbdec {

// spec Tables 8-16 / 8-17 (indexA/indexB 0..51)
static const uint8_t kAlpha[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36,
    40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203,
    226, 255, 255};
static const uint8_t kBeta[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11,
    11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18};
static const uint8_t kTc0[52][3] = {
    {0,0,0},{0,0,0},{0,0,0},{0,0,0},{0,0,0},{0,0,0},{0,0,0},{0,0,0},
    {0,0,0},{0,0,0},{0,0,0},{0,0,0},{0,0,0},{0,0,0},{0,0,0},{0,0,0},
    {0,0,0},{0,0,1},{0,0,1},{0,0,1},{0,0,1},{0,1,1},{0,1,1},{1,1,1},
    {1,1,1},{1,1,1},{1,1,1},{1,1,2},{1,1,2},{1,1,2},{1,1,2},{1,2,3},
    {1,2,3},{2,2,3},{2,2,4},{2,3,4},{2,3,4},{3,3,5},{3,4,6},{3,4,6},
    {4,5,7},{4,5,8},{4,6,9},{5,7,10},{6,8,11},{6,8,13},{7,10,14},
    {8,11,16},{9,12,18},{10,13,20},{11,15,23},{13,17,25}};

// filter 4 luma samples across an edge at dst (p0 at dst[-step])
static void luma_edge_px(uint8_t* dst, int step, int bs, int idxA, int idxB) {
    int alpha = kAlpha[idxA], beta = kBeta[idxB];
    int p0 = dst[-step], p1 = dst[-2 * step], p2 = dst[-3 * step],
        p3 = dst[-4 * step];
    int q0 = dst[0], q1 = dst[step], q2 = dst[2 * step], q3 = dst[3 * step];
    if (abs(p0 - q0) >= alpha || abs(p1 - p0) >= beta ||
        abs(q1 - q0) >= beta)
        return;
    int ap = abs(p2 - p0), aq = abs(q2 - q0);
    if (bs < 4) {
        int tc0 = kTc0[idxA][bs - 1];
        int tc = tc0 + (ap < beta) + (aq < beta);
        int delta = iclip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc);
        dst[-step] = clip255(p0 + delta);
        dst[0] = clip255(q0 - delta);
        if (ap < beta)
            dst[-2 * step] = (uint8_t)(p1 + iclip(
                (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1, -tc0, tc0));
        if (aq < beta)
            dst[step] = (uint8_t)(q1 + iclip(
                (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1, -tc0, tc0));
    } else {
        bool small = abs(p0 - q0) < ((alpha >> 2) + 2);
        if (small && ap < beta) {
            dst[-step] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4)
                                   >> 3);
            dst[-2 * step] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
            dst[-3 * step] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4)
                                       >> 3);
        } else {
            dst[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
        }
        if (small && aq < beta) {
            dst[0] = (uint8_t)((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3);
            dst[step] = (uint8_t)((q2 + q1 + q0 + p0 + 2) >> 2);
            dst[2 * step] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4)
                                      >> 3);
        } else {
            dst[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
        }
    }
}

static void chroma_edge_px(uint8_t* dst, int step, int bs, int idxA,
                           int idxB) {
    int alpha = kAlpha[idxA], beta = kBeta[idxB];
    int p0 = dst[-step], p1 = dst[-2 * step];
    int q0 = dst[0], q1 = dst[step];
    if (abs(p0 - q0) >= alpha || abs(p1 - p0) >= beta ||
        abs(q1 - q0) >= beta)
        return;
    if (bs < 4) {
        int tc = kTc0[idxA][bs - 1] + 1;
        int delta = iclip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc);
        dst[-step] = clip255(p0 + delta);
        dst[0] = clip255(q0 - delta);
    } else {
        dst[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
        dst[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
    }
}

// boundary strength between 4x4 blocks p (gxp,gyp) and q (gxq,gyq)
static int block_bs(Dec& D, bool mb_edge, int gxp, int gyp, int gxq,
                    int gyq) {
    int mbp = (gyp >> 2) * D.mb_w + (gxp >> 2);
    int mbq = (gyq >> 2) * D.mb_w + (gxq >> 2);
    if (D.mb_intra[mbp] || D.mb_intra[mbq]) return mb_edge ? 4 : 3;
    int gp = gyp * D.gw + gxp, gq = gyq * D.gw + gxq;
    auto nzl = [&](int mb, int gx, int gy) -> int {
        if (!D.mb_t8x8[mb]) return D.nnz_l[gy * D.gw + gx];
        int bx = gx & ~1, by = gy & ~1;     // covering 8x8 block
        int g0 = by * D.gw + bx;
        return D.nnz_l[g0] || D.nnz_l[g0 + 1] ||
               D.nnz_l[g0 + D.gw] || D.nnz_l[g0 + D.gw + 1];
    };
    if (nzl(mbp, gxp, gyp) || nzl(mbq, gxq, gyq)) return 2;
    // motion comparison
    Pic* rp0 = D.refidx[0][gp] >= 0 ? D.refpic[0][gp] : nullptr;
    Pic* rp1 = D.refidx[1][gp] >= 0 ? D.refpic[1][gp] : nullptr;
    Pic* rq0 = D.refidx[0][gq] >= 0 ? D.refpic[0][gq] : nullptr;
    Pic* rq1 = D.refidx[1][gq] >= 0 ? D.refpic[1][gq] : nullptr;
    int np = (rp0 != nullptr) + (rp1 != nullptr);
    int nq = (rq0 != nullptr) + (rq1 != nullptr);
    if (np != nq) return 1;
    auto mvdiff = [&](int lp, int lq) -> bool {
        return abs(D.mv[lp][gp * 2] - D.mv[lq][gq * 2]) >= 4 ||
               abs(D.mv[lp][gp * 2 + 1] - D.mv[lq][gq * 2 + 1]) >= 4;
    };
    if (np == 1) {
        int lp = rp0 ? 0 : 1, lq = rq0 ? 0 : 1;
        Pic* a = lp == 0 ? rp0 : rp1;
        Pic* b = lq == 0 ? rq0 : rq1;
        if (a != b) return 1;
        return mvdiff(lp, lq) ? 1 : 0;
    }
    if (np == 2) {
        // both bi-predicted: same pair of pictures required
        if (!((rp0 == rq0 && rp1 == rq1) || (rp0 == rq1 && rp1 == rq0)))
            return 1;
        if (rp0 == rp1) {
            // same picture both lists: either pairing may satisfy
            bool straight = !mvdiff(0, 0) && !mvdiff(1, 1);
            bool crossed = !mvdiff(0, 1) && !mvdiff(1, 0);
            return (straight || crossed) ? 0 : 1;
        }
        if (rp0 == rq0) return (mvdiff(0, 0) || mvdiff(1, 1)) ? 1 : 0;
        return (mvdiff(0, 1) || mvdiff(1, 0)) ? 1 : 0;
    }
    return 0;
}

static void deblock_picture(Dec& D) {
    int cs = D.W / 2;
    for (int mby = 0; mby < D.mb_h; mby++)
        for (int mbx = 0; mbx < D.mb_w; mbx++) {
            int i = mby * D.mb_w + mbx;
            if (D.mb_dbf_disable[i] == 1) continue;
            int x0 = mbx * 16, y0 = mby * 16;
            int qp_c = D.mb_qp[i];
            int aoff = D.mb_alpha_off[i], boff = D.mb_beta_off[i];
            bool skip_slice_edges = D.mb_dbf_disable[i] == 2;
            // vertical edges
            for (int e = 0; e < 4; e++) {
                int ex = x0 + 4 * e;
                if (ex == 0) continue;
                if ((e & 1) && D.mb_t8x8[i]) continue;  // 8x8 transform
                bool mbe = e == 0;
                int ni = mbe ? i - 1 : i;
                if (mbe && skip_slice_edges &&
                    g_pc.mb_slice[ni] != g_pc.mb_slice[i]) continue;
                int qpav = (qp_c + D.mb_qp[ni] + 1) >> 1;
                int idxA = iclip(qpav + aoff, 0, 51);
                int idxB = iclip(qpav + boff, 0, 51);
                for (int k = 0; k < 4; k++) {
                    int gyp = mby * 4 + k;
                    int bs = block_bs(D, mbe, (ex >> 2) - 1, gyp,
                                      ex >> 2, gyp);
                    if (getenv("HBDEC_BSTRACE"))
                        fprintf(stderr,
                                "V poc%d mb(%d,%d) e%d k%d bs%d A%d B%d "
                                "qp%d t8:%d nnzq%d\n",
                                D.cur->poc, mbx, mby, e, k, bs, idxA, idxB,
                                D.mb_qp[i], D.mb_t8x8[i],
                                D.nnz_l[(mby * 4 + k) * D.gw + (ex >> 2)]);
                    if (!bs) continue;
                    for (int r = 0; r < 4; r++)
                        luma_edge_px(D.cur->y.data() +
                                     (gyp * 4 + r) * D.W + ex, 1, bs,
                                     idxA, idxB);
                    if ((e & 1) == 0) {
                        for (int comp = 0; comp < 2; comp++) {
                            int qpc = (kChromaQpMap[iclip(
                                           qp_c + D.pps.chroma_qp_offset[comp],
                                           0, 51)] +
                                       kChromaQpMap[iclip(
                                           D.mb_qp[ni] +
                                           D.pps.chroma_qp_offset[comp],
                                           0, 51)] + 1) >> 1;
                            int iA = iclip(qpc + aoff, 0, 51);
                            int iB = iclip(qpc + boff, 0, 51);
                            uint8_t* pl = (comp ? D.cur->v : D.cur->u)
                                              .data();
                            for (int r = 0; r < 2; r++)
                                chroma_edge_px(
                                    pl + (gyp * 2 + r) * cs + (ex >> 1),
                                    1, bs, iA, iB);
                        }
                    }
                }
            }
            // horizontal edges
            for (int e = 0; e < 4; e++) {
                int ey = y0 + 4 * e;
                if (ey == 0) continue;
                if ((e & 1) && D.mb_t8x8[i]) continue;  // 8x8 transform
                bool mbe = e == 0;
                int ni = mbe ? i - D.mb_w : i;
                if (mbe && skip_slice_edges &&
                    g_pc.mb_slice[ni] != g_pc.mb_slice[i]) continue;
                int qpav = (qp_c + D.mb_qp[ni] + 1) >> 1;
                int idxA = iclip(qpav + aoff, 0, 51);
                int idxB = iclip(qpav + boff, 0, 51);
                for (int k = 0; k < 4; k++) {
                    int gxp = mbx * 4 + k;
                    int bs = block_bs(D, mbe, gxp, (ey >> 2) - 1,
                                      gxp, ey >> 2);
                    if (!bs) continue;
                    for (int c = 0; c < 4; c++)
                        luma_edge_px(D.cur->y.data() + ey * D.W +
                                     gxp * 4 + c, D.W, bs, idxA, idxB);
                    if ((e & 1) == 0) {
                        for (int comp = 0; comp < 2; comp++) {
                            int qpc = (kChromaQpMap[iclip(
                                           qp_c + D.pps.chroma_qp_offset[comp],
                                           0, 51)] +
                                       kChromaQpMap[iclip(
                                           D.mb_qp[ni] +
                                           D.pps.chroma_qp_offset[comp],
                                           0, 51)] + 1) >> 1;
                            int iA = iclip(qpc + aoff, 0, 51);
                            int iB = iclip(qpc + boff, 0, 51);
                            uint8_t* pl = (comp ? D.cur->v : D.cur->u)
                                              .data();
                            for (int c = 0; c < 2; c++)
                                chroma_edge_px(
                                    pl + (ey >> 1) * cs + gxp * 2 + c,
                                    cs, bs, iA, iB);
                        }
                    }
                }
            }
        }
}

}  // namespace hbdec

namespace hbdec {

// ---------------------------------------------------------------------------
// Picture lifecycle
// ---------------------------------------------------------------------------
struct OutFrame {
    std::vector<uint8_t> y, u, v;
    int poc;
    int idr;
};

struct Handle {
    Dec D;
    std::vector<OutFrame> ready;
    int decoded_mbs = 0;
    int cur_ref_idc = 0;
};

static void begin_picture(Dec& D, int nal_ref_idc) {
    D.cur.reset(new Pic());
    D.cur->w = D.W; D.cur->h = D.H;
    D.cur->y.assign((size_t)D.W * D.H, 0);
    D.cur->u.assign((size_t)D.W * D.H / 4, 0);
    D.cur->v.assign((size_t)D.W * D.H / 4, 0);
    D.cur->frame_num = D.sh.frame_num;
    D.cur->poc = D.compute_poc(nal_ref_idc);
    size_t ng = (size_t)D.gw * D.gh;
    size_t nmb = (size_t)D.mb_w * D.mb_h;
    for (int l = 0; l < 2; l++) {
        D.mv[l].assign(ng * 2, 0);
        D.refidx[l].assign(ng, -2);
        D.mvd_grid[l].assign(ng * 2, 0);
        D.refpic[l].assign(ng, nullptr);
        D.mv_done[l].assign(ng, 0);
        D.nnz_c[l].assign((size_t)D.mb_w * 2 * D.mb_h * 2, 0);
        D.mb_cdc_cbf[l].assign(nmb, 0);
    }
    D.nnz_l.assign(ng, 0);
    D.bdirect.assign(ng, 0);
    D.ipred4.assign(ng, -1);
    D.mb_intra.assign(nmb, 0);
    D.mb_skip.assign(nmb, 0);
    D.mb_i16.assign(nmb, 0);
    D.mb_pcm.assign(nmb, 0);
    D.mb_dc_cbf.assign(nmb, 0);
    D.mb_bds.assign(nmb, 0);
    D.mb_t8x8.assign(nmb, 0);
    D.mb_cbp.assign(nmb, 0);
    D.mb_cmode.assign(nmb, 0);
    D.mb_qp.assign(nmb, (int8_t)D.sh.qp);
    D.mb_done.assign(nmb, 0);
    D.mb_dbf_disable.assign(nmb, 0);
    D.mb_alpha_off.assign(nmb, 0);
    D.mb_beta_off.assign(nmb, 0);
    g_pc.blk_done.assign(ng, 0);
    g_pc.blk_parsed.assign(ng, 0);
    g_pc.cblk_parsed[0].assign((size_t)D.mb_w * 2 * D.mb_h * 2, 0);
    g_pc.cblk_parsed[1].assign((size_t)D.mb_w * 2 * D.mb_h * 2, 0);
    g_pc.mb_slice.assign(nmb, -1);
    g_pc.slice_id = 0;
}

static void finish_picture(Handle& H, int nal_ref_idc) {
    Dec& D = H.D;
    if (!getenv("HBDEC_NODEBLOCK"))
        deblock_picture(D);
    // save co-located motion for temporal direct (B slices)
    size_t ng = (size_t)D.gw * D.gh;
    for (int l = 0; l < 2; l++) {
        D.cur->mv[l].assign(D.mv[l].begin(), D.mv[l].end());
        D.cur->refidx[l].assign(D.refidx[l].begin(), D.refidx[l].end());
        D.cur->refpoc[l].assign(ng, 0);
        for (size_t i = 0; i < ng; i++)
            D.cur->refpoc[l][i] =
                D.refpic[l][i] ? D.refpic[l][i]->poc : 0;
    }
    D.cur->intra4.assign(ng, 0);
    for (size_t i = 0; i < ng; i++)
        D.cur->intra4[i] = D.refidx[0][i] == -1 && D.refidx[1][i] == -1;
    // output copy (decode order; caller reorders by POC)
    OutFrame of;
    of.y = D.cur->y; of.u = D.cur->u; of.v = D.cur->v;
    of.poc = D.cur->poc;
    of.idr = D.sh.idr;
    H.ready.push_back(std::move(of));
    // reference marking + DPB insert
    if (D.sh.idr) D.idr_flush();
    D.mark_references(nal_ref_idc);
    if (D.cur->ref || D.cur->long_term) {
        D.cur->output_done = true;
        D.dpb.push_back(std::move(D.cur));
    } else {
        D.cur.reset();
    }
    // drop dpb entries that are no longer references
    std::vector<std::unique_ptr<Pic>> keep;
    for (auto& p : D.dpb)
        if (p->ref || p->long_term) keep.push_back(std::move(p));
    D.dpb.swap(keep);
    H.decoded_mbs = 0;
}

// forward (defined with the CABAC parser below)
static bool decode_slice_cabac(Dec& D, const uint8_t* rbsp, int nbytes,
                               int startbit);

// returns 0 ok
static int handle_slice(Handle& H, BR& br, const uint8_t* rbsp, int nbytes,
                        int nal_type, int nal_ref_idc) {
    Dec& D = H.D;
    if (!D.parse_slice_header(br, nal_type, nal_ref_idc)) return -1;
    if (D.err) return -1;
    if (D.sh.redundant_pic_cnt > 0) return 0;   // ignore redundant slices
    if (D.sh.first_mb == 0) {
        if (D.cur) finish_picture(H, H.cur_ref_idc);  // truncated picture
        begin_picture(D, nal_ref_idc);
        H.cur_ref_idc = nal_ref_idc;
    } else if (!D.cur) {
        D.fail("slice without picture start");
        return -1;
    } else {
        g_pc.slice_id++;
    }
    D.build_ref_lists();
    if ((D.sh.type == P_SLICE) && D.reflist[0].empty()) {
        D.fail("P slice without references");
        return -1;
    }
    if (getenv("HBDEC_TRACE"))
        fprintf(stderr, "=== slice first_mb %d type %d qp %d dbl %d ao %d bo %d\n",
                D.sh.first_mb, D.sh.type, D.sh.qp, D.sh.disable_deblock,
                D.sh.alpha_off, D.sh.beta_off);
    bool ok;
    if (D.pps.cabac) {
        int startbit = (br.pos + 7) & ~7;       // cabac_alignment_one_bits
        ok = decode_slice_cabac(D, rbsp, nbytes, startbit);
    } else {
        ok = decode_slice_cavlc(D, br);
    }
    if (!ok || D.err) return -1;
    int done = 0;
    for (auto v : D.mb_done) done += v;
    if (done == D.mb_w * D.mb_h)
        finish_picture(H, nal_ref_idc);
    return 0;
}

}  // namespace hbdec

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------
extern "C" {

void* hbdec264_create() { return new hbdec::Handle(); }
void hbdec264_free(void* h) { delete (hbdec::Handle*)h; }
const char* hbdec264_error(void* h) {
    return ((hbdec::Handle*)h)->D.errmsg;
}

// Feed one NAL unit (EBSP, no start code).  Returns number of frames
// ready, or -1 on error.
int hbdec264_send_nal(void* hv, const uint8_t* nal, int n) {
    hbdec::Handle& H = *(hbdec::Handle*)hv;
    if (n < 1) return -1;
    int nal_type = nal[0] & 0x1F;
    int ref_idc = (nal[0] >> 5) & 3;
    // EBSP → RBSP
    std::vector<uint8_t> rbsp;
    rbsp.reserve(n);
    int zeros = 0;
    for (int i = 1; i < n; i++) {
        if (zeros >= 2 && nal[i] == 3 && i + 1 < n && nal[i + 1] <= 3) {
            zeros = 0;
            continue;
        }
        zeros = nal[i] == 0 ? zeros + 1 : 0;
        rbsp.push_back(nal[i]);
    }
    hbdec::BR br;
    br.init(rbsp.data(), (int)rbsp.size());
    hbdec::Dec& D = H.D;
    switch (nal_type) {
    case 7: D.parse_sps(br); break;
    case 8: D.parse_pps(br); break;
    case 1: case 5:
        if (handle_slice(H, br, rbsp.data(), (int)rbsp.size(), nal_type,
                         ref_idc) < 0)
            return -1;
        break;
    default: break;            // SEI / AUD / filler ignored
    }
    if (D.err) return -1;
    return (int)H.ready.size();
}

// Pop the oldest ready frame (decode order).  Returns 1 on success.
int hbdec264_get_frame(void* hv, uint8_t* y, uint8_t* u, uint8_t* v,
                       int* w, int* h, long long* poc, int* idr) {
    hbdec::Handle& H = *(hbdec::Handle*)hv;
    if (H.ready.empty()) return 0;
    hbdec::OutFrame& f = H.ready.front();
    hbdec::Dec& D = H.D;
    memcpy(y, f.y.data(), f.y.size());
    memcpy(u, f.u.data(), f.u.size());
    memcpy(v, f.v.data(), f.v.size());
    *w = D.W; *h = D.H;
    *poc = f.poc;
    *idr = f.idr;
    H.ready.erase(H.ready.begin());
    return 1;
}

// picture geometry incl. cropping (valid after first SPS-activating slice)
int hbdec264_geometry(void* hv, int* w, int* h, int* cw, int* ch) {
    hbdec::Handle& H = *(hbdec::Handle*)hv;
    hbdec::Dec& D = H.D;
    if (!D.have_size) return 0;
    *w = D.W; *h = D.H;
    *cw = D.W - 2 * (D.sps.crop_l + D.sps.crop_r);
    *ch = D.H - 2 * (D.sps.crop_t + D.sps.crop_b);
    return 1;
}

}  // extern "C"

namespace hbdec {

// ---------------------------------------------------------------------------
// CABAC slice decoding (spec 9.3) — general feature set
// ---------------------------------------------------------------------------
enum { CAT_LUMA_DC = 0, CAT_LUMA_AC = 1, CAT_LUMA_4x4 = 2,
       CAT_CHROMA_DC = 3, CAT_CHROMA_AC = 4 };

// Table 9-43 ctxIdxInc maps for 8x8 residual blocks (frame coding)
static const uint8_t kSigMap8x8[63] = {
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5, 4, 4, 4, 4, 3, 3, 6, 7, 
    7, 7, 8, 9, 10, 9, 8, 7, 7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 
    6, 11, 12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12};
static const uint8_t kLast8x8[63] = {
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 
    2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4, 
    5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8};


struct CabacCtxHelp {
    Dec& D;
    int mbx, mby, mbi;
    bool cur_intra = false;

    CabacCtxHelp(Dec& d, int x, int y) : D(d), mbx(x), mby(y),
                                         mbi(y * d.mb_w + x) {}
    bool av(int x, int y) const {
        if (x < 0 || y < 0 || x >= D.mb_w || y >= D.mb_h) return false;
        int i = y * D.mb_w + x;
        return g_pc.mb_slice[i] == g_pc.slice_id && D.mb_done[i];
    }
    int left() const { return av(mbx - 1, mby) ? mbi - 1 : -1; }
    int top() const { return av(mbx, mby - 1) ? mbi - D.mb_w : -1; }
};

static int cbf_ctx_dc(Dec& D, CabacCtxHelp& h, int cat, int comp) {
    auto term = [&](int ni) -> int {
        if (ni < 0) return h.cur_intra ? 1 : 0;
        if (D.mb_pcm[ni]) return 1;
        if (cat == CAT_LUMA_DC)
            return D.mb_i16[ni] ? D.mb_dc_cbf[ni] : 0;
        return D.mb_cdc_cbf[comp][ni];
    };
    return term(h.left()) + 2 * term(h.top());
}

static int cbf_ctx_grid(Dec& D, bool cur_intra, const std::vector<int8_t>& g,
                        int gw, int gh, int gx, int gy, bool chroma,
                        int comp) {
    auto term = [&](int x, int y) -> int {
        if (x < 0 || y < 0 || x >= gw || y >= gh)
            return cur_intra ? 1 : 0;
        int mb = chroma ? (y >> 1) * D.mb_w + (x >> 1)
                        : (y >> 2) * D.mb_w + (x >> 2);
        if (g_pc.mb_slice[mb] != g_pc.slice_id)
            return cur_intra ? 1 : 0;
        if (D.mb_pcm[mb]) return 1;
        return g[y * gw + x] > 0 ? 1 : 0;
    };
    return term(gx - 1, gy) + 2 * term(gx, gy - 1);
}

// decode one residual block; writes coeffs in scan order, returns count
static int cabac_residual_dec(Dec& D, CabacDec& cb, int* coeffs, int n,
                              int cat, int inc, bool has_cbf) {
    static const int CBF[5] = {85, 89, 93, 97, 101};
    static const int SIG[5] = {105, 120, 134, 149, 152};
    static const int LST[5] = {166, 181, 195, 210, 213};
    static const int LVL[5] = {227, 237, 247, 257, 266};
    static const uint8_t L1[8] = {1, 2, 3, 4, 0, 0, 0, 0};
    static const uint8_t LG[8] = {5, 5, 5, 5, 6, 7, 8, 9};
    static const uint8_t TR[2][8] = {{1, 2, 3, 3, 4, 5, 6, 7},
                                     {4, 4, 4, 4, 5, 6, 7, 7}};
    memset(coeffs, 0, sizeof(int) * n);
    if (has_cbf && !cb.decode(CBF[cat] + inc)) return 0;
    int sig[16] = {0};
    int last = -1;
    for (int i = 0; i < n - 1; i++) {
        sig[i] = cb.decode(SIG[cat] + i);
        if (sig[i] && cb.decode(LST[cat] + i)) { last = i; break; }
    }
    if (last < 0) { sig[n - 1] = 1; last = n - 1; }
    int node = 0, count = 0;
    for (int i = last; i >= 0; i--) {
        if (!sig[i]) continue;
        int a;
        if (!cb.decode(LVL[cat] + L1[node])) {
            a = 1;
            node = TR[0][node];
        } else {
            int gctx = LVL[cat] + LG[node];
            int m = 0;
            while (m < 13 && cb.decode(gctx)) m++;
            if (m < 13) a = 2 + m;
            else a = 15 + (int)cb.eg(0);
            node = TR[1][node];
        }
        coeffs[i] = cb.bypass() ? -a : a;
        count++;
    }
    return count;
}

// one 8x8 residual block, category 5 (no coded_block_flag; presence is
// implied by the cbp bit).  sig/last ctx from Table 9-43 maps.
static int cabac_residual8_dec(Dec& D, CabacDec& cb, int* coeffs) {
    static const int SIG8 = 402, LST8 = 417, LVL8 = 426;
    static const uint8_t L1[8] = {1, 2, 3, 4, 0, 0, 0, 0};
    static const uint8_t LG[8] = {5, 5, 5, 5, 6, 7, 8, 9};
    static const uint8_t TR[2][8] = {{1, 2, 3, 3, 4, 5, 6, 7},
                                     {4, 4, 4, 4, 5, 6, 7, 7}};
    memset(coeffs, 0, sizeof(int) * 64);
    int sig[64] = {0};
    int last = -1;
    for (int i = 0; i < 63; i++) {
        sig[i] = cb.decode(SIG8 + kSigMap8x8[i]);
        if (sig[i] && cb.decode(LST8 + kLast8x8[i])) { last = i; break; }
    }
    if (last < 0) { sig[63] = 1; last = 63; }
    int node = 0, count = 0;
    for (int i = last; i >= 0; i--) {
        if (!sig[i]) continue;
        int a;
        if (!cb.decode(LVL8 + L1[node])) {
            a = 1;
            node = TR[0][node];
        } else {
            int gctx = LVL8 + LG[node];
            int mcnt = 0;
            while (mcnt < 13 && cb.decode(gctx)) mcnt++;
            if (mcnt < 13) a = 2 + mcnt;
            else a = 15 + (int)cb.eg(0);
            node = TR[1][node];
        }
        coeffs[i] = cb.bypass() ? -a : a;
        count++;
    }
    return count;
}

static int cabac_mvd_dec(Dec& D, CabacDec& cb, int base, int l, int comp,
                         int gx, int gy) {
    static const int off[8] = {3, 4, 5, 6, 6, 6, 6, 6};
    auto amvd = [&](int x, int y) -> int {
        if (x < 0 || y < 0 || x >= D.gw || y >= D.gh) return 0;
        int mb = (y >> 2) * D.mb_w + (x >> 2);
        if (g_pc.mb_slice[mb] != g_pc.slice_id) return 0;
        if (D.refidx[l][y * D.gw + x] == -2) return 0;
        return D.mvd_grid[l][(y * D.gw + x) * 2 + comp];
    };
    int e = amvd(gx - 1, gy) + amvd(gx, gy - 1);
    int inc = e < 3 ? 0 : (e > 32 ? 2 : 1);
    if (!cb.decode(base + inc)) return 0;
    uint32_t a = 1;
    int j = 0;
    while (a < 9 && cb.decode(base + off[j < 8 ? j : 7])) { a++; j++; }
    if (a == 9) a += cb.eg(3);
    return cb.bypass() ? -(int)a : (int)a;
}

struct CabacIO : SymIO {
    Dec& D; CabacDec& cb;
    CabacIO(Dec& d, CabacDec& c) : D(d), cb(c) {}
    int sub_type() override {
        int v = sub_type_inner();
        if (getenv("HBDEC_TRACE") && D.sh.type == B_SLICE)
            fprintf(stderr, "  sub %d\n", v);
        return v;
    }
    int sub_type_inner() {
        if (D.sh.type == B_SLICE) {            // Table 9-38, ctx 36..39
            if (!cb.decode(36)) return 0;      // B_Direct_8x8
            if (!cb.decode(37)) return 1 + cb.decode(39);
            int type = 3;
            if (cb.decode(38)) {
                if (cb.decode(39)) return 11 + cb.decode(39);
                type += 4;
            }
            type += 2 * cb.decode(39);
            type += cb.decode(39);
            return type;
        }
        if (cb.decode(21)) return 0;
        if (!cb.decode(22)) return 1;
        return cb.decode(23) ? 2 : 3;
    }
    int ref(int l, int gx, int gy) override {
        int v = ref_inner(l, gx, gy);
        if (getenv("HBDEC_TRACE"))
            fprintf(stderr, "  ref l%d (%d,%d) = %d\n", l, gx, gy, v);
        return v;
    }
    int ref_inner(int l, int gx, int gy) {
        auto term = [&](int x, int y) -> int {
            if (x < 0 || y < 0 || x >= D.gw || y >= D.gh) return 0;
            int mb = (y >> 2) * D.mb_w + (x >> 2);
            if (g_pc.mb_slice[mb] != g_pc.slice_id) return 0;
            if (D.bdirect[y * D.gw + x]) return 0;  // 9.3.3.1.1.6: direct
            int8_t r = D.refidx[l][y * D.gw + x];
            return r > 0 ? 1 : 0;
        };
        int inc = term(gx - 1, gy) + 2 * term(gx, gy - 1);
        if (!cb.decode(54 + inc)) return 0;
        int r = 1;
        if (cb.decode(58)) {
            r = 2;
            while (r < 32 && cb.decode(59)) r++;
        }
        return r;
    }
    int mvd(int l, int comp, int gx, int gy) override {
        return cabac_mvd_dec(D, cb, comp == 0 ? 40 : 47, l, comp, gx, gy);
    }
};

static int cabac_mb_qp_delta(Dec& D, CabacDec& cb) {
    if (!cb.decode(60 + (D.prev_qp_delta_nz ? 1 : 0))) {
        D.prev_qp_delta_nz = 0;
        return 0;
    }
    int k = 1;
    if (cb.decode(62)) {
        k = 2;
        while (k < 79 && cb.decode(63)) k++;
    }
    D.prev_qp_delta_nz = 1;
    return (k & 1) ? (k + 1) / 2 : -(k / 2);
}

static int cabac_intra_chroma_mode(Dec& D, CabacDec& cb, CabacCtxHelp& h) {
    auto term = [&](int ni) -> int {
        if (ni < 0) return 0;
        return (D.mb_intra[ni] && !D.mb_pcm[ni] && D.mb_cmode[ni] != 0)
                   ? 1 : 0;
    };
    int inc = term(h.left()) + term(h.top());
    if (!cb.decode(64 + inc)) return 0;
    if (!cb.decode(67)) return 1;
    return cb.decode(67) ? 3 : 2;
}

static int cabac_cbp(Dec& D, CabacDec& cb, CabacCtxHelp& h) {
    int li = h.left(), ti = h.top();
    int cbp_l = li >= 0 ? (D.mb_cbp[li] & 0xF) : 0xF;
    int cbp_t = ti >= 0 ? (D.mb_cbp[ti] & 0xF) : 0xF;
    int cur = 0;
    for (int q = 0; q < 4; q++) {
        int abit = (q & 1) ? (cur >> (q - 1)) & 1 : (cbp_l >> (q + 1)) & 1;
        int bbit = (q & 2) ? (cur >> (q - 2)) & 1 : (cbp_t >> (q + 2)) & 1;
        int inc = (abit ? 0 : 1) + 2 * (bbit ? 0 : 1);
        cur |= cb.decode(73 + inc) << q;
    }
    int ca = li >= 0 ? (D.mb_cbp[li] >> 4) : 0;
    int ct = ti >= 0 ? (D.mb_cbp[ti] >> 4) : 0;
    if (li >= 0 && D.mb_pcm[li]) ca = 2;
    if (ti >= 0 && D.mb_pcm[ti]) ct = 2;
    int inc0 = (ca > 0) + 2 * (ct > 0);
    int cc = 0;
    if (cb.decode(77 + inc0)) {
        int inc1 = (ca == 2) + 2 * (ct == 2);
        cc = cb.decode(81 + inc1) ? 2 : 1;
    }
    return cur | (cc << 4);
}

// CABAC residual parse for a whole MB (mirrors parse_residual_cavlc)
static bool parse_residual_cabac(Dec& D, CabacDec& cb, MB& m, int mbx,
                                 int mby) {
    CabacCtxHelp h(D, mbx, mby);
    h.cur_intra = m.intra;
    int g0x = mbx * 4, g0y = mby * 4;
    int tmp[16];
    if (m.i16) {
        int inc = cbf_ctx_dc(D, h, CAT_LUMA_DC, 0);
        cabac_residual_dec(D, cb, tmp, 16, CAT_LUMA_DC, inc, true);
        for (int i = 0; i < 16; i++) m.coeff_ldc[kZig4[i]] = tmp[i];
    }
    if (m.t8x8 && (m.cbp & 15)) {
        for (int b8 = 0; b8 < 4; b8++) {
            int bx = (b8 & 1) * 2, by = (b8 >> 1) * 2;
            if (!((m.cbp >> b8) & 1)) {
                for (int yy = 0; yy < 2; yy++)
                    for (int xx = 0; xx < 2; xx++) {
                        int gi = (g0y + by + yy) * D.gw + g0x + bx + xx;
                        D.nnz_l[gi] = 0;
                        g_pc.blk_parsed[gi] = 1;
                    }
                continue;
            }
            int tmp64[64];
            int tc = cabac_residual8_dec(D, cb, tmp64);
            for (int i = 0; i < 64; i++) m.coeff8[b8][i] = tmp64[i];
            m.nnz8[b8] = tc;
            int cell = imin(tc, 16);
            for (int yy = 0; yy < 2; yy++)
                for (int xx = 0; xx < 2; xx++) {
                    int gi = (g0y + by + yy) * D.gw + g0x + bx + xx;
                    D.nnz_l[gi] = (int8_t)cell;
                    g_pc.blk_parsed[gi] = 1;
                    m.nnz[(by + yy) * 4 + bx + xx] = (uint8_t)cell;
                }
        }
    } else if (m.cbp & 15) {
        for (int k = 0; k < 16; k++) {
            int b = kZScan16[k];
            int quad = (b >> 3) * 2 + ((b & 3) >> 1);
            int gx = g0x + (b & 3), gy = g0y + (b >> 2);
            if (!m.i16 && !((m.cbp >> quad) & 1)) {
                D.nnz_l[gy * D.gw + gx] = 0;
                g_pc.blk_parsed[gy * D.gw + gx] = 1;
                continue;
            }
            int inc = cbf_ctx_grid(D, m.intra, D.nnz_l, D.gw, D.gh,
                                   gx, gy, false, 0);
            int cat = m.i16 ? CAT_LUMA_AC : CAT_LUMA_4x4;
            int maxc = m.i16 ? 15 : 16;
            int tc = cabac_residual_dec(D, cb, tmp, maxc, cat, inc, true);
            if (m.i16)
                for (int i = 0; i < 15; i++) m.coeff_l[b][i + 1] = tmp[i];
            else
                for (int i = 0; i < 16; i++) m.coeff_l[b][i] = tmp[i];
            m.nnz[b] = (uint8_t)tc;
            D.nnz_l[gy * D.gw + gx] = (int8_t)tc;
            g_pc.blk_parsed[gy * D.gw + gx] = 1;
        }
    } else {
        for (int y = 0; y < 4; y++)
            for (int x = 0; x < 4; x++) {
                D.nnz_l[(g0y + y) * D.gw + g0x + x] = 0;
                g_pc.blk_parsed[(g0y + y) * D.gw + g0x + x] = 1;
            }
    }
    int cw = D.mb_w * 2;
    int c0x = mbx * 2, c0y = mby * 2;
    int cbp_c = m.cbp >> 4;
    if (cbp_c) {
        for (int comp = 0; comp < 2; comp++) {
            int inc = cbf_ctx_dc(D, h, CAT_CHROMA_DC, comp);
            int tc = cabac_residual_dec(D, cb, tmp, 4, CAT_CHROMA_DC, inc,
                                        true);
            for (int i = 0; i < 4; i++) m.coeff_cdc[comp][i] = tmp[i];
            (void)tc;
        }
    }
    if (cbp_c == 2) {
        for (int comp = 0; comp < 2; comp++)
            for (int b = 0; b < 4; b++) {
                int cx = c0x + (b & 1), cy = c0y + (b >> 1);
                int inc = cbf_ctx_grid(D, m.intra, D.nnz_c[comp], cw,
                                       D.mb_h * 2, cx, cy, true, comp);
                int tc = cabac_residual_dec(D, cb, tmp, 15, CAT_CHROMA_AC,
                                            inc, true);
                for (int i = 0; i < 15; i++)
                    m.coeff_cac[comp][b][i + 1] = tmp[i];
                m.cnnz[comp][b] = (uint8_t)tc;
                D.nnz_c[comp][cy * cw + cx] = (int8_t)tc;
                g_pc.cblk_parsed[comp][cy * cw + cx] = 1;
            }
    } else {
        for (int comp = 0; comp < 2; comp++)
            for (int y = 0; y < 2; y++)
                for (int x = 0; x < 2; x++) {
                    D.nnz_c[comp][(c0y + y) * cw + c0x + x] = 0;
                    g_pc.cblk_parsed[comp][(c0y + y) * cw + c0x + x] = 1;
                }
    }
    return !cb.err;
}

// returns false on error
static bool parse_mb_cabac(Dec& D, CabacDec& cb, int mbx, int mby, MB& m) {
    init_mb(m, D.cur_qp);
    CabacCtxHelp h(D, mbx, mby);
    bool p_slice = D.sh.type == P_SLICE;
    bool is_i16 = false, is_i4 = false, is_pcm = false;
    int t = 0;
    if (p_slice) {
        if (!cb.decode(14)) {
            // P macroblock
            int b1 = cb.decode(15);
            int b2 = cb.decode(b1 ? 17 : 16);
            int mb_type = b1 ? (b2 ? 1 : 2) : (b2 ? 3 : 0);
            m.intra = false;
            CabacIO io(D, cb);
            parse_p_partitions(D, m, mbx, mby, mb_type, io);
            m.cbp = cabac_cbp(D, cb, h);
            if (t8_allowed_inter(D, m, false, mb_type)) {
                int a = h.left() >= 0 && D.mb_t8x8[h.left()];
                int b = h.top() >= 0 && D.mb_t8x8[h.top()];
                m.t8x8 = cb.decode(399 + a + b);
            }
            if (m.cbp) apply_qp_delta(D, m, cabac_mb_qp_delta(D, cb));
            else D.prev_qp_delta_nz = 0;
            return parse_residual_cabac(D, cb, m, mbx, mby);
        }
        if (!cb.decode(17)) is_i4 = true;
        else if (cb.terminate()) is_pcm = true;
        else {
            is_i16 = true;
            int ac = cb.decode(18);
            int cc = cb.decode(19) ? (cb.decode(19) ? 2 : 1) : 0;
            int mode = 2 * cb.decode(20) + cb.decode(20);
            t = 1 + mode + 4 * cc + 12 * ac;
        }
    } else if (D.sh.type == B_SLICE) {
        // B mb_type binarization (Table 9-37, ctx 27..32)
        auto bdterm = [&](int ni) -> int {
            if (ni < 0) return 0;
            return D.mb_bds[ni] ? 0 : 1;       // skip/direct16 neighbours
        };
        int inc = bdterm(h.left()) + bdterm(h.top());
        int mb_type;
        if (!cb.decode(27 + inc)) mb_type = 0;
        else if (!cb.decode(30)) mb_type = 1 + cb.decode(32);
        else {
            int bits = cb.decode(31) << 3;
            bits |= cb.decode(32) << 2;
            bits |= cb.decode(32) << 1;
            bits |= cb.decode(32);
            if (bits < 8) mb_type = bits + 3;
            else if (bits == 13) mb_type = -1;          // intra escape
            else if (bits == 14) mb_type = 11;
            else if (bits == 15) mb_type = 22;
            else mb_type = ((bits << 1) | cb.decode(32)) - 4;
        }
        if (mb_type >= 0) {
            m.intra = false;
            if (getenv("HBDEC_TRACE"))
                fprintf(stderr, "mb (%d,%d) btype %d\n", mbx, mby, mb_type);
            CabacIO io(D, cb);
            DirectCtx dc;
            if (!parse_b_partitions(D, m, mbx, mby, mb_type, io, dc))
                return false;
            m.cbp = cabac_cbp(D, cb, h);
            if (t8_allowed_inter(D, m, true, mb_type)) {
                int a = h.left() >= 0 && D.mb_t8x8[h.left()];
                int b = h.top() >= 0 && D.mb_t8x8[h.top()];
                m.t8x8 = cb.decode(399 + a + b);
            }
            if (m.cbp) apply_qp_delta(D, m, cabac_mb_qp_delta(D, cb));
            else D.prev_qp_delta_nz = 0;
            return parse_residual_cabac(D, cb, m, mbx, mby);
        }
        // intra suffix, ctx base 32
        if (!cb.decode(32)) is_i4 = true;
        else if (cb.terminate()) is_pcm = true;
        else {
            is_i16 = true;
            int ac = cb.decode(33);
            int cc = cb.decode(34) ? (cb.decode(34) ? 2 : 1) : 0;
            int mode = 2 * cb.decode(35) + cb.decode(35);
            t = 1 + mode + 4 * cc + 12 * ac;
        }
    } else {
        auto term = [&](int ni) -> int {
            if (ni < 0) return 0;
            // condTerm: available and not I_NxN
            return (D.mb_i16[ni] || D.mb_pcm[ni]) ? 1 : 0;
        };
        int inc = term(h.left()) + term(h.top());
        if (!cb.decode(3 + inc)) is_i4 = true;
        else if (cb.terminate()) is_pcm = true;
        else {
            is_i16 = true;
            int ac = cb.decode(6);
            int cc = cb.decode(7) ? (cb.decode(8) ? 2 : 1) : 0;
            int mode = 2 * cb.decode(9) + cb.decode(10);
            t = 1 + mode + 4 * cc + 12 * ac;
        }
    }
    m.intra = true;
    h.cur_intra = true;
    if (is_pcm) {
        m.pcm = true;
        // pcm samples are bypass-aligned raw bytes (spec 9.3.1, re-init)
        // CABAC decoder: PCM reads aligned bytes from bitstream position
        int pos = (cb.bitpos + 7) & ~7;
        // offset register holds 9 read-ahead bits + renorm lookahead; the
        // spec defines decoding continues at the aligned position BEFORE
        // the lookahead: reconstruct byte pos from engine state
        pos = cb.bitpos;  // engine consumed exactly the bins' bits + 9
        // Per spec 9.3.3.2.4 (DecodeBypass not used): samples start at the
        // next byte boundary relative to the arithmetic-coded prefix.
        D.fail("I_PCM in CABAC streams not yet supported");
        return false;
    }
    if (is_i4) {
        if (D.pps.transform_8x8_mode) {
            int a = h.left() >= 0 && D.mb_t8x8[h.left()];
            int b = h.top() >= 0 && D.mb_t8x8[h.top()];
            m.t8x8 = cb.decode(399 + a + b);
        }
        if (m.t8x8) {
            for (int b8 = 0; b8 < 4; b8++) {
                int bx = (b8 & 1) * 2, by = (b8 >> 1) * 2;
                int gx = mbx * 4 + bx, gy = mby * 4 + by;
                int pred = mpm4(D, m, mbx, mby, gx, gy);
                int mode;
                if (cb.decode(68)) mode = pred;
                else {
                    int r = cb.decode(69);
                    r += cb.decode(69) << 1;
                    r += cb.decode(69) << 2;
                    mode = r < pred ? r : r + 1;
                }
                m.ipred8[b8] = mode;
                for (int yy = 0; yy < 2; yy++)
                    for (int xx = 0; xx < 2; xx++)
                        m.ipred[(by + yy) * 4 + bx + xx] = mode;
            }
        } else
        for (int k = 0; k < 16; k++) {
            int b = kZScan16[k];
            int gx = mbx * 4 + (b & 3), gy = mby * 4 + (b >> 2);
            int pred = mpm4(D, m, mbx, mby, gx, gy);
            if (cb.decode(68)) m.ipred[b] = pred;
            else {
                int r = cb.decode(69);
                r += cb.decode(69) << 1;
                r += cb.decode(69) << 2;
                m.ipred[b] = r < pred ? r : r + 1;
            }
        }
        m.cmode = cabac_intra_chroma_mode(D, cb, h);
        m.cbp = cabac_cbp(D, cb, h);
        if (m.cbp) apply_qp_delta(D, m, cabac_mb_qp_delta(D, cb));
        else D.prev_qp_delta_nz = 0;
        return parse_residual_cabac(D, cb, m, mbx, mby);
    }
    m.i16 = true;
    m.i16mode = (t - 1) & 3;
    int cc2 = ((t - 1) >> 2) % 3;
    int ac2 = (t - 1) / 12;
    m.cbp = (ac2 ? 15 : 0) | (cc2 << 4);
    m.cmode = cabac_intra_chroma_mode(D, cb, h);
    apply_qp_delta(D, m, cabac_mb_qp_delta(D, cb));
    return parse_residual_cabac(D, cb, m, mbx, mby);
}

static bool decode_slice_cabac(Dec& D, const uint8_t* rbsp, int nbytes,
                               int startbit) {
    int n_mb = D.mb_w * D.mb_h;
    int mb = D.sh.first_mb;
    D.cur_qp = D.sh.qp;
    D.prev_qp_delta_nz = 0;
    CabacDec& cb = D.cb;
    cb.init(rbsp, nbytes, startbit, D.sh.qp, D.sh.type == I_SLICE,
            D.sh.cabac_init_idc);
    while (mb < n_mb) {
        int mbx = mb % D.mb_w, mby = mb / D.mb_w;
        g_pc.mb_slice[mby * D.mb_w + mbx] = g_pc.slice_id;
        MB m;
        bool skip = false;
        if (D.sh.type != I_SLICE) {
            CabacCtxHelp h(D, mbx, mby);
            int a = h.left() >= 0 && !D.mb_skip[h.left()];
            int b = h.top() >= 0 && !D.mb_skip[h.top()];
            int base = D.sh.type == B_SLICE ? 24 : 11;
            skip = cb.decode(base + a + b);
        }
        if (skip) {
            decode_skip_mb(D, mbx, mby, m);
            D.prev_qp_delta_nz = 0;
            if (getenv("HBDEC_TRACE"))
                fprintf(stderr, "mb %d skip\n", mb);
        } else {
            if (!parse_mb_cabac(D, cb, mbx, mby, m)) {
                D.fail("cabac mb parse error");
                return false;
            }
        }
        recon_mb(D, m, mbx, mby);
        if (D.err) return false;
        store_mb_state(D, m, mbx, mby);
        mb++;
        if (cb.err) { D.fail("cabac bitstream exhausted"); return false; }
        if (cb.terminate()) break;            // end_of_slice_flag
    }
    return true;
}

}  // namespace hbdec
