// H.264 CABAC encoder — arithmetic engine (spec 9.3.4) + the context
// bookkeeping for the syntax elements this encoder emits (I_16x16,
// P_L0_16x16, P_Skip, 4x4 residuals).
//
// Role of x264's cabac.c/macroblock write path (encx264.c drives it in the
// reference); built from ITU-T H.264 clause 9.3 with the spec constant
// tables in cabac_tables_h264.h (see extract_fftables.py for provenance).
// Conformance: tests decode these streams with libavcodec and require
// bit-exact recon equality (tests/test_h264_codec.py).
#pragma once
#include <stdint.h>
#include <string.h>
#include <vector>
#include "cabac_tables_h264.h"

namespace {

struct CabacEnc {
    // engine registers (spec 9.3.4.2)
    uint32_t low, range;
    int bits_outstanding;
    bool first_bit;
    BitWriter* bw;           // byte-aligned at engine start
    uint8_t state[1024];     // pStateIdx per context
    uint8_t mps[1024];       // valMPS per context

    void init(BitWriter* w, int slice_qp, bool i_slice, int init_idc) {
        bw = w;
        low = 0; range = 510; bits_outstanding = 0; first_bit = true;
        int qp = slice_qp < 0 ? 0 : (slice_qp > 51 ? 51 : slice_qp);
        for (int i = 0; i < 1024; i++) {
            const int8_t* mn = i_slice ? kCabacInitI[i]
                                       : kCabacInitPB[init_idc][i];
            int pre = ((mn[0] * qp) >> 4) + mn[1];
            pre = pre < 1 ? 1 : (pre > 126 ? 126 : pre);
            if (pre <= 63) { state[i] = 63 - pre; mps[i] = 0; }
            else           { state[i] = pre - 64; mps[i] = 1; }
        }
    }

    void put_bit(int b) {
        if (first_bit) first_bit = false;
        else bw->put_bit(b);
        while (bits_outstanding > 0) {
            bw->put_bit(1 - b);
            bits_outstanding--;
        }
    }

    void renorm() {
        while (range < 256) {
            if (low >= 512) { put_bit(1); low -= 512; }
            else if (low < 256) put_bit(0);
            else { low -= 256; bits_outstanding++; }
            range <<= 1;
            low <<= 1;
        }
    }

    void encode(int ctx, int bin) {
        uint32_t rlps = kRangeTabLPS[state[ctx]][(range >> 6) & 3];
        range -= rlps;
        if (bin != mps[ctx]) {
            low += range;
            range = rlps;
            if (state[ctx] == 0) mps[ctx] ^= 1;
            state[ctx] = kTransIdxLPS[state[ctx]];
        } else {
            state[ctx] = kTransIdxMPS[state[ctx]];
        }
        renorm();
    }

    void bypass(int bin) {
        low <<= 1;
        if (bin) low += range;
        if (low >= 1024) { put_bit(1); low -= 1024; }
        else if (low < 512) put_bit(0);
        else { low -= 512; bits_outstanding++; }
    }

    // end_of_slice_flag / I_PCM escape (ctxIdx 276, no state)
    void terminate(int bin) {
        range -= 2;
        if (bin) {
            low += range;
            // EncodeFlush (spec 9.3.4.5): last bit is rbsp_stop_one_bit
            range = 2;
            renorm();
            put_bit((low >> 9) & 1);
            bw->put(((low >> 7) & 3) | 1, 2);
        } else {
            renorm();
        }
    }

    // unsigned Exp-Golomb suffix of order k, bypass coded (UEGk suffix)
    void eg_suffix(uint32_t v, int k) {
        while (v >= (1u << k)) {
            bypass(1);
            v -= 1u << k;
            k++;
        }
        bypass(0);
        while (k--) bypass((v >> k) & 1);
    }
};

// ---------------------------------------------------------------------------
// Per-slice CABAC coding state beyond the raw contexts: the neighbour maps
// the ctxIdx increments need (spec 9.3.3.1.1).  MB grid indexed mby*mb_w+mbx.
// ---------------------------------------------------------------------------
struct CabacSliceState {
    int mb_w, mb_h;
    std::vector<uint8_t> skip;        // mb_skip_flag per MB
    std::vector<uint8_t> intra;       // coded with intra pred
    std::vector<uint8_t> i16;         // Intra_16x16 (has luma DC block)
    std::vector<uint8_t> dc_cbf;      // luma DC coded_block_flag (I16)
    std::vector<uint8_t> cdc_cbf[2];  // chroma DC cbf per component
    std::vector<uint8_t> cbp;         // 6-bit cbp (luma | chroma<<4)
    std::vector<uint8_t> cmode;       // intra_chroma_pred_mode
    std::vector<int16_t> mvdx, mvdy;  // per MB (16x16 partitions)
    std::vector<uint8_t> done;        // MB decoded (availability)
    std::vector<uint8_t> t8;          // transform_size_8x8_flag per MB

    void init(int w, int h) {
        mb_w = w; mb_h = h;
        size_t n = (size_t)w * h;
        skip.assign(n, 0); intra.assign(n, 0); i16.assign(n, 0);
        dc_cbf.assign(n, 0); cdc_cbf[0].assign(n, 0); cdc_cbf[1].assign(n, 0);
        cbp.assign(n, 0); cmode.assign(n, 0);
        mvdx.assign(n, 0); mvdy.assign(n, 0);
        done.assign(n, 0); t8.assign(n, 0);
    }
    bool avail(int x, int y) const {
        return x >= 0 && y >= 0 && x < mb_w && y < mb_h &&
               done[(size_t)y * mb_w + x];
    }
    int idx(int x, int y) const { return y * mb_w + x; }
};

// residual block categories (ctxBlockCat)
enum { CAT_LUMA_DC = 0, CAT_LUMA_AC = 1, CAT_LUMA_4x4 = 2,
       CAT_CHROMA_DC = 3, CAT_CHROMA_AC = 4 };

static const int kCbfBase[5]  = {85, 89, 93, 97, 101};
static const int kSigBase[5]  = {105, 105 + 15, 105 + 29, 105 + 44, 105 + 47};
static const int kLastBase[5] = {166, 166 + 15, 166 + 29, 166 + 44, 166 + 47};
static const int kLvlBase[5]  = {227, 237, 247, 257, 266};
// abs-level node machine (spec Table 9-41 semantics)
static const uint8_t kLvl1Ctx[8]   = {1, 2, 3, 4, 0, 0, 0, 0};
static const uint8_t kLvlGt1Ctx[8] = {5, 5, 5, 5, 6, 7, 8, 9};
static const uint8_t kLvlTrans[2][8] = {
    {1, 2, 3, 3, 4, 5, 6, 7},   // after coding a level with abs == 1
    {4, 4, 4, 4, 5, 6, 7, 7},   // after coding a level with abs  > 1
};

// Encode one residual block (spec 9.3.2.3 residual_block_cabac), 4x4-path
// categories only.  coeffs = levels in scan order, n = maxNumCoeff.
// Returns coded_block_flag.  write_cbf=false for categories whose cbf is
// implied by cbp (never the case in the 4x4 path — always true here).
static int cabac_residual(CabacEnc& e, const int32_t* coeffs, int n,
                          int cat, int cbf_ctx_inc) {
    int nsig = 0, last = -1;
    for (int i = 0; i < n; i++)
        if (coeffs[i]) { nsig++; last = i; }
    e.encode(kCbfBase[cat] + cbf_ctx_inc, nsig != 0);
    if (!nsig) return 0;
    // significance map (positions 0..n-2; last position inferred)
    for (int i = 0; i < n - 1 && i <= last; i++) {
        e.encode(kSigBase[cat] + i, coeffs[i] != 0);
        if (coeffs[i])
            e.encode(kLastBase[cat] + i, i == last);
    }
    // levels in reverse scan order
    int node = 0;
    for (int i = last; i >= 0; i--) {
        if (!coeffs[i]) continue;
        int32_t v = coeffs[i];
        uint32_t a = (v < 0 ? -v : v) - 1;     // coeff_abs_level_minus1
        int base = kLvlBase[cat];
        if (a == 0) {
            e.encode(base + kLvl1Ctx[node], 0);
            node = kLvlTrans[0][node];
        } else {
            e.encode(base + kLvl1Ctx[node], 1);
            int gctx = base + kLvlGt1Ctx[node];
            uint32_t m = a - 1;                // TU part codes m+... (a>=1)
            // UEG0: prefix TU cMax 13 over (a-1), suffix EG0
            if (m < 13) {
                for (uint32_t j = 0; j < m; j++) e.encode(gctx, 1);
                e.encode(gctx, 0);
            } else {
                for (int j = 0; j < 13; j++) e.encode(gctx, 1);
                e.eg_suffix(m - 13, 0);
            }
            node = kLvlTrans[1][node];
        }
        e.bypass(v < 0);
    }
    return 1;
}

// coded_block_flag ctxIdxInc for a luma-grid 4x4 block (cats 1/2) from the
// nnz grids kept by Ctx; cur_intra resolves the unavailable-neighbour rule.
static inline int cbf_inc_from(int a, int b) { return a + 2 * b; }

// Encode one 8x8 residual block (cat 5, High profile): no cbf; the
// significance map uses the 8x8 context index tables and the abs-level
// node machine at ctx base 426.  Mirrors hbdec264.cpp
// cabac_residual8_dec bit-for-bit.  coeffs: 64 levels in 8x8 scan order.
// Returns total nonzero count.
static int cabac_residual8(CabacEnc& e, const int32_t* c) {
    static const int SIG8 = 402, LST8 = 417, LVL8 = 426;
    static const uint8_t L1[8] = {1, 2, 3, 4, 0, 0, 0, 0};
    static const uint8_t LG[8] = {5, 5, 5, 5, 6, 7, 8, 9};
    static const uint8_t TR[2][8] = {{1, 2, 3, 3, 4, 5, 6, 7},
                                     {4, 4, 4, 4, 5, 6, 7, 7}};
    int last = -1, count = 0;
    for (int i = 0; i < 64; i++)
        if (c[i]) { last = i; count++; }
    for (int i = 0; i < 63; i++) {
        int s = c[i] != 0;
        e.encode(SIG8 + kSigCoeff8x8Frame[i], s);
        if (s) {
            e.encode(LST8 + kLastCoeff8x8[i], i == last);
            if (i == last) break;
        }
    }
    int node = 0;
    for (int i = last; i >= 0; i--) {
        if (!c[i]) continue;
        int32_t v = c[i];
        uint32_t a = v < 0 ? -v : v;
        if (a == 1) {
            e.encode(LVL8 + L1[node], 0);
            node = TR[0][node];
        } else {
            e.encode(LVL8 + L1[node], 1);
            int gctx = LVL8 + LG[node];
            uint32_t m = a - 2;
            if (m < 13) {
                for (uint32_t j = 0; j < m; j++) e.encode(gctx, 1);
                e.encode(gctx, 0);
            } else {
                for (int j = 0; j < 13; j++) e.encode(gctx, 1);
                e.eg_suffix(a - 15, 0);
            }
            node = TR[1][node];
        }
        e.bypass(v < 0);
    }
    return count;
}

}  // namespace
