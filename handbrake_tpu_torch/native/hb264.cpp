// Native H.264 slice coder — the sequential host stage of the TPU encoder.
//
// Role of the reference's entropy/bitstream host code (encx264.c drives
// x264's CAVLC; bitstream.c/nal_units.c do NAL packing). Our TPU device
// path (codecs/h264/encoder_tpu.py) produces per-MB analysis arrays
// (mv, levels, recon); this module does the inherently serial walk —
// skip decisions, MV prediction, CAVLC bit packing, intra fallback —
// at native speed. Bit-exact against the Python reference
// (codecs/h264/encoder.py); tests/test_native.py asserts equality.
//
// Built by native/build.py with g++ (no external deps); tables are
// generated from the Python tables by gen_tables.py.
#include <stdint.h>
#include <string.h>
#include <math.h>
#include <vector>
#include "cavlc_tables.h"

namespace {

// ---------------------------------------------------------------------------
// Bit writer (MSB-first), seeded from the Python slice-header writer state.
// ---------------------------------------------------------------------------
struct BitWriter {
    uint8_t* buf;
    int cap;
    int pos;         // bytes written
    uint64_t cur;    // pending bits (LSB-aligned)
    int nbits;       // number of pending bits
    bool overflow;

    void init(uint8_t* b, int c) {
        buf = b; cap = c; pos = 0; cur = 0; nbits = 0; overflow = false;
    }
    void put(uint32_t value, int n) {
        cur = (cur << n) | (uint64_t)value;
        nbits += n;
        while (nbits >= 8) {
            nbits -= 8;
            if (pos >= cap) { overflow = true; return; }
            buf[pos++] = (uint8_t)((cur >> nbits) & 0xFF);
        }
        cur &= (nbits ? ((1ULL << nbits) - 1) : 0);
    }
    void put_bit(int b) { put(b & 1, 1); }
    void ue(uint32_t v) {
        uint32_t vv = v + 1;
        int n = 32 - __builtin_clz(vv);
        if (n > 1) put(0, n - 1);
        put(vv, n);
    }
    void se(int32_t v) { ue(v > 0 ? (uint32_t)(2 * v - 1) : (uint32_t)(-2 * v)); }
    void rbsp_trailing() {
        put_bit(1);
        if (nbits) put(0, 8 - nbits);
    }
};

static inline int floordiv2(int x) { return x >> 1; }  // gcc: arithmetic shift

}  // namespace (reopened below — cabac264.h needs BitWriter)
#include "cabac264.h"
namespace {

// ---------------------------------------------------------------------------
// CAVLC residual coding (spec 9.2) — port of codecs/h264/cavlc.py
// ---------------------------------------------------------------------------
static inline int nc_context(int na, int nb, bool avail_a, bool avail_b) {
    if (avail_a && avail_b) return (na + nb + 1) >> 1;
    if (avail_a) return na;
    if (avail_b) return nb;
    return 0;
}

// coeff_token lookup: nc == -1 → chroma DC table; nc >= 8 → FLC.
static inline void coeff_token(BitWriter& bw, int nc, int tc, int t1) {
    const int32_t *len_tbl, *bits_tbl;
    if (nc == -1)      { len_tbl = CT_CDC_LEN; bits_tbl = CT_CDC_BITS; }
    else if (nc < 2)   { len_tbl = CT_NC0_LEN; bits_tbl = CT_NC0_BITS; }
    else if (nc < 4)   { len_tbl = CT_NC2_LEN; bits_tbl = CT_NC2_BITS; }
    else if (nc < 8)   { len_tbl = CT_NC4_LEN; bits_tbl = CT_NC4_BITS; }
    else {
        // FLC (coeff_token_flc): (0,0) → 000011, else ((tc-1)<<2)|t1, 6 bits
        if (tc == 0) bw.put(0x03, 6);
        else bw.put(((tc - 1) << 2) | t1, 6);
        return;
    }
    int idx = tc * 4 + t1;
    bw.put(bits_tbl[idx], len_tbl[idx]);
}

// coeffs: levels in zigzag scan order, length max_coeff. Returns TotalCoeff.
static int encode_residual(BitWriter& bw, const int32_t* coeffs, int nc,
                           int max_coeff) {
    int pos_[16], val_[16];
    int tc = 0;
    for (int i = 0; i < max_coeff; i++) {
        if (coeffs[i] != 0) { pos_[tc] = i; val_[tc] = coeffs[i]; tc++; }
    }
    int trailing = 0;
    for (int i = tc - 1; i >= 0; i--) {
        if ((val_[i] == 1 || val_[i] == -1) && trailing < 3) trailing++;
        else break;
    }
    coeff_token(bw, nc, tc, trailing);
    if (tc == 0) return 0;

    for (int i = tc - 1; i > tc - 1 - trailing; i--)
        bw.put_bit(val_[i] < 0 ? 1 : 0);

    int suffix_len = (tc > 10 && trailing < 3) ? 1 : 0;
    bool first = true;
    for (int i = tc - 1 - trailing; i >= 0; i--) {
        int lvl = val_[i];
        int alvl = lvl < 0 ? -lvl : lvl;
        int level_code = 2 * (alvl - 1) + (lvl < 0 ? 1 : 0);
        if (first && trailing < 3) level_code -= 2;
        first = false;
        if (suffix_len == 0) {
            if (level_code < 14) bw.put(1, level_code + 1);
            else if (level_code < 30) { bw.put(1, 15); bw.put(level_code - 14, 4); }
            else { bw.put(1, 16); bw.put(level_code - 30, 12); }
        } else {
            if ((level_code >> suffix_len) < 15) {
                bw.put(1, (level_code >> suffix_len) + 1);
                bw.put(level_code & ((1 << suffix_len) - 1), suffix_len);
            } else {
                bw.put(1, 16);
                bw.put(level_code - (15 << suffix_len), 12);
            }
        }
        if (suffix_len == 0) suffix_len = 1;
        if (alvl > (3 << (suffix_len - 1)) && suffix_len < 6) suffix_len++;
    }

    int last_pos = pos_[tc - 1];
    int total_zeros = last_pos + 1 - tc;
    if (tc < max_coeff) {
        if (max_coeff == 4) {
            int idx = tc * 4 + total_zeros;
            bw.put(TZC_BITS[idx], TZC_LEN[idx]);
        } else {
            int idx = tc * 16 + total_zeros;
            bw.put(TZ_BITS[idx], TZ_LEN[idx]);
        }
    }
    int zeros_left = total_zeros;
    for (int i = tc - 1; i > 0; i--) {
        if (zeros_left <= 0) break;
        int run = pos_[i] - pos_[i - 1] - 1;
        int zl = zeros_left < 7 ? zeros_left : 7;
        int idx = zl * 15 + run;
        bw.put(RB_BITS[idx], RB_LEN[idx]);
        zeros_left -= run;
    }
    return tc;
}

// ---------------------------------------------------------------------------
// Transforms & quantization — port of codecs/h264/transform.py
// ---------------------------------------------------------------------------
static void fdct4x4(const int32_t d[16], int32_t w[16]) {
    int32_t t[16];
    for (int c = 0; c < 4; c++) {          // t = C @ d
        int32_t d0 = d[c], d1 = d[4 + c], d2 = d[8 + c], d3 = d[12 + c];
        t[c]      = d0 + d1 + d2 + d3;
        t[4 + c]  = 2 * d0 + d1 - d2 - 2 * d3;
        t[8 + c]  = d0 - d1 - d2 + d3;
        t[12 + c] = d0 - 2 * d1 + 2 * d2 - d3;
    }
    for (int r = 0; r < 4; r++) {          // w = t @ C^T
        int32_t t0 = t[r * 4], t1 = t[r * 4 + 1], t2 = t[r * 4 + 2],
                t3 = t[r * 4 + 3];
        w[r * 4]     = t0 + t1 + t2 + t3;
        w[r * 4 + 1] = 2 * t0 + t1 - t2 - 2 * t3;
        w[r * 4 + 2] = t0 - t1 - t2 + t3;
        w[r * 4 + 3] = t0 - 2 * t1 + 2 * t2 - t3;
    }
}

static void hadamard4x4(const int32_t d[16], int32_t w[16]) {
    int32_t t[16];
    for (int c = 0; c < 4; c++) {
        int32_t d0 = d[c], d1 = d[4 + c], d2 = d[8 + c], d3 = d[12 + c];
        t[c]      = d0 + d1 + d2 + d3;
        t[4 + c]  = d0 + d1 - d2 - d3;
        t[8 + c]  = d0 - d1 - d2 + d3;
        t[12 + c] = d0 - d1 + d2 - d3;
    }
    for (int r = 0; r < 4; r++) {
        int32_t t0 = t[r * 4], t1 = t[r * 4 + 1], t2 = t[r * 4 + 2],
                t3 = t[r * 4 + 3];
        w[r * 4]     = t0 + t1 + t2 + t3;
        w[r * 4 + 1] = t0 + t1 - t2 - t3;
        w[r * 4 + 2] = t0 - t1 - t2 + t3;
        w[r * 4 + 3] = t0 - t1 + t2 - t3;
    }
}

static void hadamard2x2(const int32_t d[4], int32_t w[4]) {
    // H @ d @ H with H = [[1,1],[1,-1]]
    int32_t a = d[0], b = d[1], c = d[2], e = d[3];
    w[0] = a + b + c + e;
    w[1] = a - b + c - e;
    w[2] = a + b - c - e;
    w[3] = a - b - c + e;
}

static inline int32_t quant_one(int32_t w, int32_t mf, int64_t f, int qbits) {
    int64_t aw = w < 0 ? -(int64_t)w : (int64_t)w;
    int32_t lv = (int32_t)((aw * mf + f) >> qbits);
    return w < 0 ? -lv : lv;
}

static void quant4x4(const int32_t w[16], int qp, bool intra, int32_t lv[16]) {
    int qbits = QBITS_BASE + qp / 6;
    const int32_t* mf = &MF4x4[(qp % 6) * 16];
    int64_t f = intra ? ((1LL << qbits) / 3) : ((1LL << qbits) / 6);
    for (int i = 0; i < 16; i++) lv[i] = quant_one(w[i], mf[i], f, qbits);
}

static void quant_dc(const int32_t* w, int n, int qp, bool intra,
                     int32_t* lv) {
    int qbits = QBITS_BASE + qp / 6;
    int32_t mf00 = MF4x4[(qp % 6) * 16];
    int64_t f = intra ? ((1LL << qbits) / 3) : ((1LL << qbits) / 6);
    for (int i = 0; i < n; i++) lv[i] = quant_one(w[i], mf00, 2 * f, qbits + 1);
}

static void dequant4x4(const int32_t lv[16], int qp, int32_t d[16]) {
    const int32_t* v = &V4x4[(qp % 6) * 16];
    int sh = qp / 6;
    for (int i = 0; i < 16; i++) d[i] = (lv[i] * v[i]) << sh;
}

static void dequant_luma_dc(const int32_t f[16], int qp, int32_t out[16]) {
    int32_t ls = 16 * V4x4[(qp % 6) * 16];
    if (qp >= 36) {
        int sh = qp / 6 - 6;
        for (int i = 0; i < 16; i++) out[i] = (f[i] * ls) << sh;
    } else {
        int32_t rnd = 1 << (5 - qp / 6);
        int sh = 6 - qp / 6;
        for (int i = 0; i < 16; i++) out[i] = (f[i] * ls + rnd) >> sh;
    }
}

static void dequant_chroma_dc(const int32_t f[4], int qp, int32_t out[4]) {
    int32_t ls = 16 * V4x4[(qp % 6) * 16];
    int sh = qp / 6;
    for (int i = 0; i < 4; i++) out[i] = ((f[i] * ls) << sh) >> 5;
}

static void idct4x4(const int32_t d[16], int32_t r[16]) {
    int32_t f[16];
    for (int row = 0; row < 4; row++) {
        int32_t d0 = d[row * 4], d1 = d[row * 4 + 1], d2 = d[row * 4 + 2],
                d3 = d[row * 4 + 3];
        int32_t e0 = d0 + d2, e1 = d0 - d2;
        int32_t e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
        f[row * 4]     = e0 + e3;
        f[row * 4 + 1] = e1 + e2;
        f[row * 4 + 2] = e1 - e2;
        f[row * 4 + 3] = e0 - e3;
    }
    for (int col = 0; col < 4; col++) {
        int32_t f0 = f[col], f1 = f[4 + col], f2 = f[8 + col], f3 = f[12 + col];
        int32_t g0 = f0 + f2, g1 = f0 - f2;
        int32_t g2 = (f1 >> 1) - f3, g3 = f1 + (f3 >> 1);
        r[col]      = (g0 + g3 + 32) >> 6;
        r[4 + col]  = (g1 + g2 + 32) >> 6;
        r[8 + col]  = (g1 - g2 + 32) >> 6;
        r[12 + col] = (g0 - g3 + 32) >> 6;
    }
}

static inline uint8_t clip255(int32_t v) {
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

static void zigzag16(const int32_t blk[16], int32_t z[16]) {
    for (int i = 0; i < 16; i++) z[i] = blk[ZIGZAG_4x4[i]];
}

// coded order of the 16 4x4 luma blocks within a MB (raster index)
static const int CODED_ORDER[16] =
    {0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15};

// ---------------------------------------------------------------------------
// Per-slice coding context — port of encoder.py MBCtx
// ---------------------------------------------------------------------------
struct Ctx {
    int mb_w, mb_h;
    std::vector<int32_t> nnz_l;    // (mb_h*4) x (mb_w*4)
    std::vector<int32_t> nnz_cb, nnz_cr;  // (mb_h*2) x (mb_w*2)
    std::vector<int32_t> mvx, mvy; // per MB
    std::vector<int8_t> ref;       // 0 inter, -1 intra (valid if processed)
    int cur;                       // index of MB being coded (raster)

    void init(int w, int h) {
        mb_w = w; mb_h = h; cur = 0;
        nnz_l.assign(h * 4 * w * 4, 0);
        nnz_cb.assign(h * 2 * w * 2, 0);
        nnz_cr.assign(h * 2 * w * 2, 0);
        mvx.assign(w * h, 0); mvy.assign(w * h, 0);
        ref.assign(w * h, 0);
    }
    bool processed(int x, int y) const {
        if (x < 0 || y < 0 || x >= mb_w || y >= mb_h) return false;
        return y * mb_w + x < cur;
    }
    int nc_luma(int by, int bx) const {
        int W = mb_w * 4;
        int na = bx > 0 ? nnz_l[by * W + bx - 1] : 0;
        int nb = by > 0 ? nnz_l[(by - 1) * W + bx] : 0;
        return nc_context(na, nb, bx > 0, by > 0);
    }
    int nc_chroma(const std::vector<int32_t>& p, int by, int bx) const {
        int W = mb_w * 2;
        int na = bx > 0 ? p[by * W + bx - 1] : 0;
        int nb = by > 0 ? p[(by - 1) * W + bx] : 0;
        return nc_context(na, nb, bx > 0, by > 0);
    }
};

static inline int med3(int a, int b, int c) {
    int mx = a > b ? (a > c ? a : c) : (b > c ? b : c);
    int mn = a < b ? (a < c ? a : c) : (b < c ? b : c);
    return a + b + c - mx - mn;
}

// port of predict.predict_mv_16x16
static void predict_mv(const Ctx& ctx, int mbx, int mby, int* px, int* py) {
    // neighbour state: 0 = unavailable, 1 = inter (mv valid), -1 = intra
    int st[3] = {0, 0, 0};
    int vx[3] = {0, 0, 0}, vy[3] = {0, 0, 0};
    int coords[3][2] = {{mbx - 1, mby}, {mbx, mby - 1}, {mbx + 1, mby - 1}};
    for (int k = 0; k < 3; k++) {
        int x = coords[k][0], y = coords[k][1];
        if (k == 2 && !ctx.processed(x, y)) { x = mbx - 1; y = mby - 1; }  // D
        if (!ctx.processed(x, y)) continue;
        int i = y * ctx.mb_w + x;
        if (ctx.ref[i] != 0) { st[k] = -1; }
        else { st[k] = 1; vx[k] = ctx.mvx[i]; vy[k] = ctx.mvy[i]; }
    }
    if (st[1] == 0 && st[2] == 0) {
        if (st[0] == 1) { *px = vx[0]; *py = vy[0]; return; }
        *px = 0; *py = 0; return;
    }
    // unavailable → available-intra ((0,0), ref -1)
    int nsame = 0, sx = 0, sy = 0;
    for (int k = 0; k < 3; k++)
        if (st[k] == 1) { nsame++; sx = vx[k]; sy = vy[k]; }
    if (nsame == 1) { *px = sx; *py = sy; return; }
    *px = med3(vx[0], vx[1], vx[2]);
    *py = med3(vy[0], vy[1], vy[2]);
}

// port of predict.skip_mv
static void skip_mv(const Ctx& ctx, int mbx, int mby, int* px, int* py) {
    if (!ctx.processed(mbx - 1, mby) || !ctx.processed(mbx, mby - 1)) {
        *px = 0; *py = 0; return;
    }
    int ia = mby * ctx.mb_w + mbx - 1;
    int ib = (mby - 1) * ctx.mb_w + mbx;
    if (ctx.ref[ia] == 0 && ctx.mvx[ia] == 0 && ctx.mvy[ia] == 0) {
        *px = 0; *py = 0; return;
    }
    if (ctx.ref[ib] == 0 && ctx.mvx[ib] == 0 && ctx.mvy[ib] == 0) {
        *px = 0; *py = 0; return;
    }
    predict_mv(ctx, mbx, mby, px, py);
}

// ---------------------------------------------------------------------------
// Intra prediction — port of predict.intra16_pred / chroma_pred
// ---------------------------------------------------------------------------
// Planes are uint8, stride = plane width; availability from mbx/mby > 0.
enum { I16_V = 0, I16_H = 1, I16_DC = 2, I16_PLANE = 3 };
enum { C_DC = 0, C_H = 1, C_V = 2, C_PLANE = 3 };

static void intra16_pred(int mode, const uint8_t* rec, int stride,
                         int x0, int y0, bool has_top, bool has_left,
                         int32_t pred[256]) {
    // form neighbour pointers only when the neighbour exists (forming an
    // out-of-bounds pointer is UB even if never dereferenced)
    const uint8_t* top = has_top ? &rec[(y0 - 1) * stride + x0] : rec;
    const uint8_t* leftcol = has_left ? &rec[y0 * stride + x0 - 1] : rec;
    switch (mode) {
    case I16_V:
        for (int r = 0; r < 16; r++)
            for (int c = 0; c < 16; c++) pred[r * 16 + c] = top[c];
        break;
    case I16_H:
        for (int r = 0; r < 16; r++) {
            int32_t v = leftcol[r * stride];
            for (int c = 0; c < 16; c++) pred[r * 16 + c] = v;
        }
        break;
    case I16_DC: {
        int32_t dc;
        if (has_top && has_left) {
            int s = 0;
            for (int i = 0; i < 16; i++) s += top[i] + leftcol[i * stride];
            dc = (s + 16) >> 5;
        } else if (has_top) {
            int s = 0; for (int i = 0; i < 16; i++) s += top[i];
            dc = (s + 8) >> 4;
        } else if (has_left) {
            int s = 0; for (int i = 0; i < 16; i++) s += leftcol[i * stride];
            dc = (s + 8) >> 4;
        } else dc = 128;
        for (int i = 0; i < 256; i++) pred[i] = dc;
        break;
    }
    case I16_PLANE: {
        int64_t tl = rec[(y0 - 1) * stride + x0 - 1];
        int64_t h = 0, v = 0;
        for (int x = 0; x < 8; x++) {
            int64_t hi = top[8 + x];
            int64_t lo = x < 7 ? (int64_t)top[6 - x] : tl;
            h += (x + 1) * (hi - lo);
        }
        for (int y = 0; y < 8; y++) {
            int64_t hi = leftcol[(8 + y) * stride];
            int64_t lo = y < 7 ? (int64_t)leftcol[(6 - y) * stride] : tl;
            v += (y + 1) * (hi - lo);
        }
        int64_t b = (5 * h + 32) >> 6;
        int64_t c = (5 * v + 32) >> 6;
        int64_t a = 16 * ((int64_t)leftcol[15 * stride] + (int64_t)top[15]);
        for (int y = 0; y < 16; y++)
            for (int x = 0; x < 16; x++) {
                int64_t p = (a + b * (x - 7) + c * (y - 7) + 16) >> 5;
                pred[y * 16 + x] = (int32_t)(p < 0 ? 0 : (p > 255 ? 255 : p));
            }
        break;
    }
    }
}

static void chroma_pred(int mode, const uint8_t* rec, int stride,
                        int x0, int y0, bool has_top, bool has_left,
                        int32_t pred[64]) {
    const uint8_t* top = has_top ? &rec[(y0 - 1) * stride + x0] : rec;
    const uint8_t* leftcol = has_left ? &rec[y0 * stride + x0 - 1] : rec;
    switch (mode) {
    case C_V:
        for (int r = 0; r < 8; r++)
            for (int c = 0; c < 8; c++) pred[r * 8 + c] = top[c];
        break;
    case C_H:
        for (int r = 0; r < 8; r++) {
            int32_t v = leftcol[r * stride];
            for (int c = 0; c < 8; c++) pred[r * 8 + c] = v;
        }
        break;
    case C_DC: {
        auto dc4 = [&](const uint8_t* tseg, const uint8_t* lseg) -> int32_t {
            if (tseg && lseg) {
                int s = 0;
                for (int i = 0; i < 4; i++) s += tseg[i] + lseg[i * stride];
                return (s + 4) >> 3;
            }
            if (tseg) { int s = 0; for (int i = 0; i < 4; i++) s += tseg[i];
                        return (s + 2) >> 2; }
            if (lseg) { int s = 0; for (int i = 0; i < 4; i++) s += lseg[i * stride];
                        return (s + 2) >> 2; }
            return 128;
        };
        const uint8_t* t0 = has_top ? top : nullptr;
        const uint8_t* t1 = has_top ? top + 4 : nullptr;
        const uint8_t* l0 = has_left ? leftcol : nullptr;
        const uint8_t* l1 = has_left ? leftcol + 4 * stride : nullptr;
        int32_t q00 = dc4(t0, l0);
        int32_t q01 = has_top ? dc4(t1, nullptr)
                              : (has_left ? dc4(nullptr, l0) : 128);
        int32_t q10 = has_left ? dc4(nullptr, l1)
                               : (has_top ? dc4(t0, nullptr) : 128);
        int32_t q11 = dc4(t1, l1);
        for (int r = 0; r < 8; r++)
            for (int c = 0; c < 8; c++)
                pred[r * 8 + c] = r < 4 ? (c < 4 ? q00 : q01)
                                        : (c < 4 ? q10 : q11);
        break;
    }
    case C_PLANE: {
        int64_t tl = rec[(y0 - 1) * stride + x0 - 1];
        int64_t h = 0, v = 0;
        for (int x = 0; x < 4; x++) {
            int64_t hi = top[4 + x];
            int64_t lo = x < 3 ? (int64_t)top[2 - x] : tl;
            h += (x + 1) * (hi - lo);
        }
        for (int y = 0; y < 4; y++) {
            int64_t hi = leftcol[(4 + y) * stride];
            int64_t lo = y < 3 ? (int64_t)leftcol[(2 - y) * stride] : tl;
            v += (y + 1) * (hi - lo);
        }
        int64_t b = (17 * h + 16) >> 5;
        int64_t c = (17 * v + 16) >> 5;
        int64_t a = 16 * ((int64_t)leftcol[7 * stride] + (int64_t)top[7]);
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) {
                int64_t p = (a + b * (x - 3) + c * (y - 3) + 16) >> 5;
                pred[y * 8 + x] = (int32_t)(p < 0 ? 0 : (p > 255 ? 255 : p));
            }
        break;
    }
    }
}

// ---------------------------------------------------------------------------
// Intra MB encode (shared by I slices and the P-slice intra fallback) —
// port of encoder.encode_i16_luma / encode_chroma / _write_intra_mb
// ---------------------------------------------------------------------------
struct Planes {
    const uint8_t *src_y, *src_u, *src_v;
    uint8_t *rec_y, *rec_u, *rec_v;
    int w, h;       // luma plane dims (MB-aligned)
};

static int64_t sad16(const uint8_t* src, int stride, const int32_t* pred) {
    int64_t s = 0;
    for (int r = 0; r < 16; r++)
        for (int c = 0; c < 16; c++) {
            int d = (int)src[r * stride + c] - pred[r * 16 + c];
            s += d < 0 ? -d : d;
        }
    return s;
}

static int64_t sad8(const uint8_t* src, int stride, const int32_t* pred) {
    int64_t s = 0;
    for (int r = 0; r < 8; r++)
        for (int c = 0; c < 8; c++) {
            int d = (int)src[r * stride + c] - pred[r * 8 + c];
            s += d < 0 ? -d : d;
        }
    return s;
}

// Encode one chroma component: returns nnz per block in nnz[4], AC levels in
// aclv[4][16] (raster), DC scan in dc4[4]; writes recon into rec plane.
static void encode_chroma_comp(const uint8_t* src, int sstride,
                               const int32_t pred[64], int qpc, bool intra,
                               int32_t dc4[4], int32_t aclv[4][16],
                               uint8_t* rec, int rstride,
                               int* has_dc, int* has_ac, int32_t nnz[4]) {
    int32_t blocks[4][16];
    for (int b = 0; b < 4; b++) {
        int by = (b / 2) * 4, bx = (b % 2) * 4;
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++)
                blocks[b][r * 4 + c] =
                    (int32_t)src[(by + r) * sstride + bx + c]
                    - pred[(by + r) * 8 + bx + c];
    }
    int32_t w[4][16];
    for (int b = 0; b < 4; b++) fdct4x4(blocks[b], w[b]);
    int32_t dc[4] = {w[0][0], w[1][0], w[2][0], w[3][0]};
    int32_t dch[4];
    hadamard2x2(dc, dch);
    quant_dc(dch, 4, qpc, intra, dc4);
    for (int b = 0; b < 4; b++) {
        int32_t ac[16];
        memcpy(ac, w[b], sizeof(ac));
        ac[0] = 0;
        quant4x4(ac, qpc, intra, aclv[b]);
    }
    // reconstruction
    int32_t fdc[4];
    hadamard2x2(dc4, fdc);
    int32_t dcq[4];
    dequant_chroma_dc(fdc, qpc, dcq);
    *has_dc = (dc4[0] | dc4[1] | dc4[2] | dc4[3]) != 0;
    *has_ac = 0;
    for (int b = 0; b < 4; b++) {
        int32_t dq[16];
        dequant4x4(aclv[b], qpc, dq);
        dq[0] = dcq[b];
        int32_t r4[16];
        idct4x4(dq, r4);
        int by = (b / 2) * 4, bx = (b % 2) * 4;
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++)
                rec[(by + r) * rstride + bx + c] =
                    clip255(pred[(by + r) * 8 + bx + c] + r4[r * 4 + c]);
        int n = 0;
        for (int i = 0; i < 16; i++) if (aclv[b][i]) n++;
        nnz[b] = n;
        if (n) *has_ac = 1;
    }
}

static void write_chroma_residual(BitWriter& bw, Ctx& ctx, int mbx, int mby,
                                  int cbp_chroma,
                                  const int32_t udc[4],
                                  const int32_t uac[4][16],
                                  const int32_t vdc[4],
                                  const int32_t vac[4][16]) {
    int b0y = mby * 2, b0x = mbx * 2;
    int W = ctx.mb_w * 2;
    if (cbp_chroma == 0) {
        for (int r = 0; r < 2; r++)
            for (int c = 0; c < 2; c++) {
                ctx.nnz_cb[(b0y + r) * W + b0x + c] = 0;
                ctx.nnz_cr[(b0y + r) * W + b0x + c] = 0;
            }
        return;
    }
    encode_residual(bw, udc, -1, 4);
    encode_residual(bw, vdc, -1, 4);
    if (cbp_chroma == 2) {
        for (int plane = 0; plane < 2; plane++) {
            const int32_t (*aclv)[16] = plane == 0 ? uac : vac;
            std::vector<int32_t>& nnzmap = plane == 0 ? ctx.nnz_cb : ctx.nnz_cr;
            for (int k = 0; k < 4; k++) {
                int by = b0y + k / 2, bx = b0x + k % 2;
                int nc = ctx.nc_chroma(nnzmap, by, bx);
                int32_t z[16];
                zigzag16(aclv[k], z);
                int tc = encode_residual(bw, z + 1, nc, 15);
                nnzmap[by * W + bx] = tc;
            }
        }
    } else {
        for (int r = 0; r < 2; r++)
            for (int c = 0; c < 2; c++) {
                ctx.nnz_cb[(b0y + r) * W + b0x + c] = 0;
                ctx.nnz_cr[(b0y + r) * W + b0x + c] = 0;
            }
    }
}

// ---------------------------------------------------------------------------
// CABAC syntax writers (spec 9.3.3) for the emitted MB types.  Neighbour
// ctxIdx increments follow 9.3.3.1.1; cross-checked against libavcodec by
// the conformance tests.
// ---------------------------------------------------------------------------
struct Cabac {
    CabacEnc e;
    CabacSliceState s;
};

// coded_block_flag ctxIdxInc for the luma/chroma 4x4 grids: nnz grids hold
// per-block counts (cbf == count>0).  Unavailable neighbour: intra MBs use
// 1, inter 0 (spec 9.3.3.1.1.9); skipped/uncoded blocks read 0 from grids.
static int cbf_inc_grid(const Ctx& ctx, const std::vector<int32_t>& grid,
                        int gw, int by, int bx, bool cur_intra) {
    int a = bx > 0 ? (grid[by * gw + bx - 1] > 0) : (cur_intra ? 1 : 0);
    int b = by > 0 ? (grid[(by - 1) * gw + bx] > 0) : (cur_intra ? 1 : 0);
    return a + 2 * b;
}

// DC-category cbf inc from per-MB flag vectors (luma DC / chroma DC)
static int cbf_inc_mb(const CabacSliceState& S,
                      const std::vector<uint8_t>& flag,
                      int mbx, int mby, bool cur_intra) {
    int a = S.avail(mbx - 1, mby) ? flag[S.idx(mbx - 1, mby)]
                                  : (cur_intra ? 1 : 0);
    int b = S.avail(mbx, mby - 1) ? flag[S.idx(mbx, mby - 1)]
                                  : (cur_intra ? 1 : 0);
    return a + 2 * b;
}

// For CAT_LUMA_DC the neighbour block only exists when the neighbour MB is
// Intra_16x16; otherwise condTerm = 0 (available MB, absent block).
static int cbf_inc_lumadc(const CabacSliceState& S, int mbx, int mby) {
    auto term = [&](int x, int y) -> int {
        if (!S.avail(x, y)) return 1;          // current MB is always intra
        int i = S.idx(x, y);
        return S.i16[i] ? S.dc_cbf[i] : 0;
    };
    return term(mbx - 1, mby) + 2 * term(mbx, mby - 1);
}

static int cbf_inc_chromadc(const CabacSliceState& S, int comp,
                            int mbx, int mby, bool cur_intra) {
    auto term = [&](int x, int y) -> int {
        if (!S.avail(x, y)) return cur_intra ? 1 : 0;
        return S.cdc_cbf[comp][S.idx(x, y)];
    };
    return term(mbx - 1, mby) + 2 * term(mbx, mby - 1);
}

static void cabac_mb_skip(Cabac& cb, int mbx, int mby, int skip) {
    CabacSliceState& S = cb.s;
    int a = S.avail(mbx - 1, mby) && !S.skip[S.idx(mbx - 1, mby)];
    int b = S.avail(mbx, mby - 1) && !S.skip[S.idx(mbx, mby - 1)];
    cb.e.encode(11 + a + b, skip);
}

// mvd component (spec 9.3.2.3 UEG3, uCoff 9); base 40 for x, 47 for y.
static void cabac_mvd(CabacEnc& e, int base, int mvd, int e_nb) {
    static const int off[8] = {3, 4, 5, 6, 6, 6, 6, 6};
    int inc = e_nb < 3 ? 0 : (e_nb > 32 ? 2 : 1);
    uint32_t a = mvd < 0 ? -mvd : mvd;
    if (a == 0) { e.encode(base + inc, 0); return; }
    e.encode(base + inc, 1);
    if (a < 9) {
        for (uint32_t j = 1; j < a; j++) e.encode(base + off[j - 1], 1);
        e.encode(base + off[a - 1], 0);
    } else {
        for (int j = 1; j < 9; j++) e.encode(base + off[j - 1], 1);
        e.eg_suffix(a - 9, 3);
    }
    e.bypass(mvd < 0);
}

static void cabac_intra_chroma_mode(Cabac& cb, int mbx, int mby, int mode) {
    CabacSliceState& S = cb.s;
    auto term = [&](int x, int y) -> int {
        if (!S.avail(x, y)) return 0;
        int i = S.idx(x, y);
        return (S.intra[i] && S.cmode[i] != 0) ? 1 : 0;
    };
    int inc = term(mbx - 1, mby) + term(mbx, mby - 1);
    cb.e.encode(64 + inc, mode > 0);
    if (mode > 0) {
        cb.e.encode(67, mode > 1);
        if (mode > 1) cb.e.encode(67, mode > 2);
    }
}

static void cabac_cbp(Cabac& cb, int mbx, int mby, int cbp_luma,
                      int cbp_chroma) {
    CabacSliceState& S = cb.s;
    int cbp_l = S.avail(mbx - 1, mby) ? (S.cbp[S.idx(mbx - 1, mby)] & 0xF)
                                      : 0xF;   // unavailable → condTerm 0
    int cbp_t = S.avail(mbx, mby - 1) ? (S.cbp[S.idx(mbx, mby - 1)] & 0xF)
                                      : 0xF;
    // quadrant neighbours: q^1 horizontally, q^2 vertically; bits from the
    // neighbour MB when crossing the MB edge, else from cbp_luma itself.
    int cur = 0;
    for (int q = 0; q < 4; q++) {
        int abit = (q & 1) ? (cur >> (q - 1)) & 1 : (cbp_l >> (q + 1)) & 1;
        int bbit = (q & 2) ? (cur >> (q - 2)) & 1 : (cbp_t >> (q + 2)) & 1;
        int inc = (abit ? 0 : 1) + 2 * (bbit ? 0 : 1);
        int bit = (cbp_luma >> q) & 1;
        cb.e.encode(73 + inc, bit);
        cur |= bit << q;
    }
    int ca = S.avail(mbx - 1, mby) ? (S.cbp[S.idx(mbx - 1, mby)] >> 4) : 0;
    int ct = S.avail(mbx, mby - 1) ? (S.cbp[S.idx(mbx, mby - 1)] >> 4) : 0;
    int inc0 = (ca > 0) + 2 * (ct > 0);
    cb.e.encode(77 + inc0, cbp_chroma != 0);
    if (cbp_chroma != 0) {
        int inc1 = (ca == 2) + 2 * (ct == 2);
        cb.e.encode(81 + inc1, cbp_chroma == 2);
    }
}

// Intra_16x16 mb_type: prefix differs between I and P slices, suffix is
// (not-I_NxN, PCM-terminate, cbp_ac, cbp_chroma x2, pred-mode x2).
static void cabac_mb_type_i16(Cabac& cb, int mbx, int mby, bool p_slice,
                              int imode, int cbp_ac, int cbp_chroma) {
    CabacSliceState& S = cb.s;
    CabacEnc& e = cb.e;
    if (p_slice) {
        e.encode(14, 1);                     // prefix: intra in P
        e.encode(17, 1);                     // not I_NxN
    } else {
        auto term = [&](int x, int y) -> int {
            // condTerm: available and not I_NxN (we never emit I_NxN)
            return S.avail(x, y) && S.intra[S.idx(x, y)] ? 1 : 0;
        };
        int inc = term(mbx - 1, mby) + term(mbx, mby - 1);
        e.encode(3 + inc, 1);                // not I_NxN
    }
    e.terminate(0);                          // not I_PCM
    if (p_slice) {                           // suffix ctx shared per pair
        e.encode(18, cbp_ac != 0);
        e.encode(19, cbp_chroma != 0);
        if (cbp_chroma != 0) e.encode(19, cbp_chroma == 2);
        e.encode(20, (imode >> 1) & 1);
        e.encode(20, imode & 1);
    } else {
        e.encode(6, cbp_ac != 0);
        e.encode(7, cbp_chroma != 0);
        if (cbp_chroma != 0) e.encode(8, cbp_chroma == 2);
        e.encode(9, (imode >> 1) & 1);
        e.encode(10, imode & 1);
    }
}

static void cabac_mb_qp_delta(Cabac& cb, int prev_nz, int delta) {
    // we always emit 0: single bin with ctx 60 + (prev delta != 0)
    cb.e.encode(60 + (prev_nz ? 1 : 0), delta != 0);
    // non-zero deltas would need the full unary tail (ctx 62, 63)
}

// CABAC entropy for a fully analysed intra MB (data from write_intra_mb).
static void cabac_write_intra(Cabac& cb, Ctx& ctx, int mbx, int mby,
                              bool p_slice, int imode, int cmode,
                              int cbp_ac, int cbp_chroma,
                              const int32_t dclv[16],
                              const int32_t aclv[16][16],
                              const int32_t udc[4], const int32_t uac[4][16],
                              const int32_t vdc[4], const int32_t vac[4][16]) {
    CabacSliceState& S = cb.s;
    CabacEnc& e = cb.e;
    int mi = S.idx(mbx, mby);
    cabac_mb_type_i16(cb, mbx, mby, p_slice, imode, cbp_ac, cbp_chroma);
    cabac_intra_chroma_mode(cb, mbx, mby, cmode);
    cabac_mb_qp_delta(cb, 0, 0);

    int b0y = mby * 4, b0x = mbx * 4, W4 = ctx.mb_w * 4;
    // luma DC (cat 0)
    int32_t z[16];
    zigzag16(dclv, z);
    S.dc_cbf[mi] = cabac_residual(e, z, 16, CAT_LUMA_DC,
                                  cbf_inc_lumadc(S, mbx, mby));
    // luma AC (cat 1)
    if (cbp_ac) {
        for (int k = 0; k < 16; k++) {
            int ridx = CODED_ORDER[k];
            int by = b0y + ridx / 4, bx = b0x + ridx % 4;
            zigzag16(aclv[ridx], z);
            int inc = cbf_inc_grid(ctx, ctx.nnz_l, W4, by, bx, true);
            cabac_residual(e, z + 1, 15, CAT_LUMA_AC, inc);
            int n = 0;
            for (int t = 1; t < 16; t++) if (z[t]) n++;
            ctx.nnz_l[by * W4 + bx] = n;
        }
    } else {
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++)
                ctx.nnz_l[(b0y + r) * W4 + b0x + c] = 0;
    }
    // chroma (cats 3, 4)
    int b0cy = mby * 2, b0cx = mbx * 2, W2 = ctx.mb_w * 2;
    if (cbp_chroma != 0) {
        S.cdc_cbf[0][mi] = cabac_residual(
            e, udc, 4, CAT_CHROMA_DC, cbf_inc_chromadc(S, 0, mbx, mby, true));
        S.cdc_cbf[1][mi] = cabac_residual(
            e, vdc, 4, CAT_CHROMA_DC, cbf_inc_chromadc(S, 1, mbx, mby, true));
    }
    if (cbp_chroma == 2) {
        for (int plane = 0; plane < 2; plane++) {
            const int32_t (*ac)[16] = plane == 0 ? uac : vac;
            std::vector<int32_t>& g = plane == 0 ? ctx.nnz_cb : ctx.nnz_cr;
            for (int k = 0; k < 4; k++) {
                int by = b0cy + k / 2, bx = b0cx + k % 2;
                zigzag16(ac[k], z);
                int inc = cbf_inc_grid(ctx, g, W2, by, bx, true);
                cabac_residual(e, z + 1, 15, CAT_CHROMA_AC, inc);
                int n = 0;
                for (int t = 1; t < 16; t++) if (z[t]) n++;
                g[by * W2 + bx] = n;
            }
        }
    } else {
        for (int r = 0; r < 2; r++)
            for (int c = 0; c < 2; c++) {
                ctx.nnz_cb[(b0cy + r) * W2 + b0cx + c] = 0;
                ctx.nnz_cr[(b0cy + r) * W2 + b0cx + c] = 0;
            }
    }
    S.intra[mi] = 1; S.i16[mi] = 1; S.skip[mi] = 0;
    S.cmode[mi] = (uint8_t)cmode;
    S.cbp[mi] = (uint8_t)((cbp_ac ? 15 : 0) | (cbp_chroma << 4));
    S.mvdx[mi] = 0; S.mvdy[mi] = 0;
    S.done[mi] = 1;
}

// CABAC entropy for a P_L0_16x16 MB.
static void cabac_write_inter(Cabac& cb, Ctx& ctx, int mbx, int mby,
                              int mvdx, int mvdy, int cbp_luma,
                              int cbp_chroma,
                              const int32_t lv[16][16],
                              const int32_t udc[4], const int32_t uac[4][16],
                              const int32_t vdc[4], const int32_t vac[4][16],
                              int t8_mode = 0, int t8 = 0) {
    CabacSliceState& S = cb.s;
    CabacEnc& e = cb.e;
    int mi = S.idx(mbx, mby);
    e.encode(14, 0); e.encode(15, 0); e.encode(16, 0);  // P_L0_16x16
    auto amvd = [&](int x, int y, const std::vector<int16_t>& m) -> int {
        if (!S.avail(x, y)) return 0;
        int v = m[S.idx(x, y)];
        return v < 0 ? -v : v;
    };
    cabac_mvd(e, 40, mvdx,
              amvd(mbx - 1, mby, S.mvdx) + amvd(mbx, mby - 1, S.mvdx));
    cabac_mvd(e, 47, mvdy,
              amvd(mbx - 1, mby, S.mvdy) + amvd(mbx, mby - 1, S.mvdy));
    cabac_cbp(cb, mbx, mby, cbp_luma, cbp_chroma);
    if (t8_mode && cbp_luma) {
        // transform_size_8x8_flag, ctx 399 + left_t8 + top_t8 (7.3.5;
        // hbdec264.cpp parse path mirror)
        int a = S.avail(mbx - 1, mby) && S.t8[S.idx(mbx - 1, mby)];
        int b = S.avail(mbx, mby - 1) && S.t8[S.idx(mbx, mby - 1)];
        e.encode(399 + a + b, t8);
    }
    if (cbp_luma || cbp_chroma) cabac_mb_qp_delta(cb, 0, 0);

    int b0y = mby * 4, b0x = mbx * 4, W4 = ctx.mb_w * 4;
    int32_t z[16];
    if (t8 && cbp_luma) {
        // 8x8 residuals: lv[] holds the four CAVLC sub-streams per quad
        // (slot k = quad k>>2, phase k&3); rebuild the 64-coeff scans
        for (int q = 0; q < 4; q++) {
            int cy = b0y + (q >> 1) * 2, cx = b0x + (q & 1) * 2;
            if (!((cbp_luma >> q) & 1)) {
                for (int yy = 0; yy < 2; yy++)
                    for (int xx = 0; xx < 2; xx++)
                        ctx.nnz_l[(cy + yy) * W4 + cx + xx] = 0;
                continue;
            }
            int32_t c64[64];
            for (int i = 0; i < 16; i++)
                for (int j = 0; j < 4; j++)
                    c64[4 * i + j] = lv[q * 4 + j][i];
            int tc = cabac_residual8(e, c64);
            int cell = tc > 16 ? 16 : tc;
            for (int yy = 0; yy < 2; yy++)
                for (int xx = 0; xx < 2; xx++)
                    ctx.nnz_l[(cy + yy) * W4 + cx + xx] = cell;
        }
    } else
    for (int k = 0; k < 16; k++) {
        int ridx = CODED_ORDER[k];
        int quad = (ridx / 8) * 2 + (ridx % 4) / 2;
        int by = b0y + ridx / 4, bx = b0x + ridx % 4;
        if (!((cbp_luma >> quad) & 1)) {
            ctx.nnz_l[by * W4 + bx] = 0;
            continue;
        }
        zigzag16(lv[ridx], z);
        int inc = cbf_inc_grid(ctx, ctx.nnz_l, W4, by, bx, false);
        cabac_residual(e, z, 16, CAT_LUMA_4x4, inc);
        int n = 0;
        for (int t = 0; t < 16; t++) if (z[t]) n++;
        ctx.nnz_l[by * W4 + bx] = n;
    }
    int b0cy = mby * 2, b0cx = mbx * 2, W2 = ctx.mb_w * 2;
    if (cbp_chroma != 0) {
        S.cdc_cbf[0][mi] = cabac_residual(
            e, udc, 4, CAT_CHROMA_DC,
            cbf_inc_chromadc(S, 0, mbx, mby, false));
        S.cdc_cbf[1][mi] = cabac_residual(
            e, vdc, 4, CAT_CHROMA_DC,
            cbf_inc_chromadc(S, 1, mbx, mby, false));
    }
    if (cbp_chroma == 2) {
        for (int plane = 0; plane < 2; plane++) {
            const int32_t (*ac)[16] = plane == 0 ? uac : vac;
            std::vector<int32_t>& g = plane == 0 ? ctx.nnz_cb : ctx.nnz_cr;
            for (int k = 0; k < 4; k++) {
                int by = b0cy + k / 2, bx = b0cx + k % 2;
                zigzag16(ac[k], z);
                int inc = cbf_inc_grid(ctx, g, W2, by, bx, false);
                cabac_residual(e, z + 1, 15, CAT_CHROMA_AC, inc);
                int n = 0;
                for (int t = 1; t < 16; t++) if (z[t]) n++;
                g[by * W2 + bx] = n;
            }
        }
    } else {
        for (int r = 0; r < 2; r++)
            for (int c = 0; c < 2; c++) {
                ctx.nnz_cb[(b0cy + r) * W2 + b0cx + c] = 0;
                ctx.nnz_cr[(b0cy + r) * W2 + b0cx + c] = 0;
            }
    }
    if (cbp_luma == 0)
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++)
                ctx.nnz_l[(b0y + r) * W4 + b0x + c] = 0;
    S.intra[mi] = 0; S.i16[mi] = 0; S.skip[mi] = 0;
    S.cbp[mi] = (uint8_t)(cbp_luma | (cbp_chroma << 4));
    S.mvdx[mi] = (int16_t)mvdx; S.mvdy[mi] = (int16_t)mvdy;
    S.t8[mi] = (uint8_t)(t8 && cbp_luma ? 1 : 0);
    S.done[mi] = 1;
}

static void cabac_write_skip(Cabac& cb, int mbx, int mby, Ctx& ctx) {
    CabacSliceState& S = cb.s;
    int mi = S.idx(mbx, mby);
    cabac_mb_skip(cb, mbx, mby, 1);
    S.skip[mi] = 1; S.intra[mi] = 0; S.i16[mi] = 0;
    S.cbp[mi] = 0; S.mvdx[mi] = 0; S.mvdy[mi] = 0;
    S.done[mi] = 1;
    int b0y = mby * 4, b0x = mbx * 4, W4 = ctx.mb_w * 4;
    for (int r = 0; r < 4; r++)
        for (int c = 0; c < 4; c++)
            ctx.nnz_l[(b0y + r) * W4 + b0x + c] = 0;
    int b0cy = mby * 2, b0cx = mbx * 2, W2 = ctx.mb_w * 2;
    for (int r = 0; r < 2; r++)
        for (int c = 0; c < 2; c++) {
            ctx.nnz_cb[(b0cy + r) * W2 + b0cx + c] = 0;
            ctx.nnz_cr[(b0cy + r) * W2 + b0cx + c] = 0;
        }
}

// Full intra-16x16 MB: mode decision done by caller (imode/ipred given).
static void write_intra_mb(BitWriter& bw, Ctx& ctx, Planes& P,
                           int mbx, int mby, int imode,
                           const int32_t ipred[256], int qp, int qpc,
                           bool p_slice, int* skip_run, Cabac* cb = nullptr) {
    int x0 = mbx * 16, y0 = mby * 16;
    int cx0 = mbx * 8, cy0 = mby * 8;
    int ls = P.w, cs = P.w / 2;
    // ---- luma I16: DC hadamard + AC quant + recon ----
    int32_t blocks[16][16], w16[16][16];
    for (int b = 0; b < 16; b++) {
        int by = (b / 4) * 4, bx = (b % 4) * 4;
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++)
                blocks[b][r * 4 + c] =
                    (int32_t)P.src_y[(y0 + by + r) * ls + x0 + bx + c]
                    - ipred[(by + r) * 16 + bx + c];
        fdct4x4(blocks[b], w16[b]);
    }
    int32_t dc16[16];
    for (int b = 0; b < 16; b++) dc16[b] = w16[b][0];   // raster per block
    int32_t dch[16];
    hadamard4x4(dc16, dch);
    for (int i = 0; i < 16; i++) dch[i] = floordiv2(dch[i]);
    int32_t dclv[16];
    quant_dc(dch, 16, qp, true, dclv);
    int32_t aclv[16][16];
    int cbp_ac = 0;
    for (int b = 0; b < 16; b++) {
        int32_t ac[16];
        memcpy(ac, w16[b], sizeof(ac));
        ac[0] = 0;
        quant4x4(ac, qp, true, aclv[b]);
        for (int i = 0; i < 16; i++) if (aclv[b][i]) { cbp_ac = 1; break; }
    }
    // recon
    int32_t fdc[16];
    hadamard4x4(dclv, fdc);
    int32_t dcq[16];
    dequant_luma_dc(fdc, qp, dcq);
    for (int b = 0; b < 16; b++) {
        int32_t dq[16];
        dequant4x4(aclv[b], qp, dq);
        dq[0] = dcq[b];
        int32_t r4[16];
        idct4x4(dq, r4);
        int by = (b / 4) * 4, bx = (b % 4) * 4;
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++)
                P.rec_y[(y0 + by + r) * ls + x0 + bx + c] =
                    clip255(ipred[(by + r) * 16 + bx + c] + r4[r * 4 + c]);
    }
    // ---- chroma mode decision on reconstructed neighbours ----
    bool ht = mby > 0, hl = mbx > 0;
    int cmodes[4], ncm = 0;
    cmodes[ncm++] = C_DC;
    if (hl) cmodes[ncm++] = C_H;
    if (ht) cmodes[ncm++] = C_V;
    if (ht && hl) cmodes[ncm++] = C_PLANE;
    int best_cm = C_DC;
    int64_t best_c = -1;
    int32_t predu[64], predv[64];
    for (int k = 0; k < ncm; k++) {
        int32_t pu[64], pv[64];
        chroma_pred(cmodes[k], P.rec_u, cs, cx0, cy0, ht, hl, pu);
        chroma_pred(cmodes[k], P.rec_v, cs, cx0, cy0, ht, hl, pv);
        int64_t c = sad8(&P.src_u[cy0 * cs + cx0], cs, pu)
                  + sad8(&P.src_v[cy0 * cs + cx0], cs, pv);
        if (best_c < 0 || c < best_c) {
            best_c = c; best_cm = cmodes[k];
            memcpy(predu, pu, sizeof(pu));
            memcpy(predv, pv, sizeof(pv));
        }
    }
    int32_t udc[4], uaclv[4][16], vdc[4], vaclv[4][16];
    int u_dc, u_ac, v_dc, v_ac;
    int32_t nnzu[4], nnzv[4];
    encode_chroma_comp(&P.src_u[cy0 * cs + cx0], cs, predu, qpc, true,
                       udc, uaclv, &P.rec_u[cy0 * cs + cx0], cs,
                       &u_dc, &u_ac, nnzu);
    encode_chroma_comp(&P.src_v[cy0 * cs + cx0], cs, predv, qpc, true,
                       vdc, vaclv, &P.rec_v[cy0 * cs + cx0], cs,
                       &v_dc, &v_ac, nnzv);
    int cbp_chroma = (u_ac || v_ac) ? 2 : ((u_dc || v_dc) ? 1 : 0);

    if (cb) {
        if (p_slice) cabac_mb_skip(*cb, mbx, mby, 0);
        cabac_write_intra(*cb, ctx, mbx, mby, p_slice, imode, best_cm,
                          cbp_ac, cbp_chroma, dclv, aclv,
                          udc, uaclv, vdc, vaclv);
        ctx.ref[mby * ctx.mb_w + mbx] = -1;
        return;
    }
    int mb_type = 1 + imode + 4 * cbp_chroma + 12 * cbp_ac;
    if (p_slice) {
        bw.ue(*skip_run);
        *skip_run = 0;
        mb_type += 5;
    }
    bw.ue(mb_type);
    bw.ue(best_cm);
    bw.se(0);  // mb_qp_delta

    // ---- luma residual (I16 DC + AC) ----
    int b0y = mby * 4, b0x = mbx * 4;
    int W4 = ctx.mb_w * 4;
    {
        int nc = ctx.nc_luma(b0y, b0x);
        int32_t z[16];
        zigzag16(dclv, z);
        encode_residual(bw, z, nc, 16);
    }
    if (cbp_ac) {
        for (int k = 0; k < 16; k++) {
            int ridx = CODED_ORDER[k];
            int by = b0y + ridx / 4, bx = b0x + ridx % 4;
            int nc = ctx.nc_luma(by, bx);
            int32_t z[16];
            zigzag16(aclv[ridx], z);
            int tc = encode_residual(bw, z + 1, nc, 15);
            ctx.nnz_l[by * W4 + bx] = tc;
        }
    } else {
        for (int r = 0; r < 4; r++)
            for (int c = 0; c < 4; c++)
                ctx.nnz_l[(b0y + r) * W4 + b0x + c] = 0;
    }
    write_chroma_residual(bw, ctx, mbx, mby, cbp_chroma,
                          udc, uaclv, vdc, vaclv);
    int i = mby * ctx.mb_w + mbx;
    ctx.ref[i] = -1;
}

// intra mode decision — candidate order matches encoder.i16_candidate_modes
static int pick_i16_mode(Planes& P, int mbx, int mby, int32_t pred_out[256]) {
    bool ht = mby > 0, hl = mbx > 0;
    int modes[4], nm = 0;
    modes[nm++] = I16_DC;
    if (ht) modes[nm++] = I16_V;
    if (hl) modes[nm++] = I16_H;
    if (ht && hl) modes[nm++] = I16_PLANE;
    int x0 = mbx * 16, y0 = mby * 16;
    int best = I16_DC;
    int64_t best_c = -1;
    for (int k = 0; k < nm; k++) {
        int32_t pred[256];
        intra16_pred(modes[k], P.rec_y, P.w, x0, y0, ht, hl, pred);
        int64_t c = sad16(&P.src_y[y0 * P.w + x0], P.w, pred);
        if (best_c < 0 || c < best_c) {
            best_c = c; best = modes[k];
            memcpy(pred_out, pred, sizeof(pred));
        }
    }
    return best;
}

}  // namespace

// ---------------------------------------------------------------------------
// Exported API
// ---------------------------------------------------------------------------
// ---------------------------------------------------------------------------
// In-loop deblocking filter (spec 8.7) — encoder-side frame filter.
// Same semantics as codecs/h264/deblock.py deblock_frame (fixed slice qp,
// single reference, zero alpha/beta offsets); used for the host walker's
// loop filter and for re-filtering frames the device path patched with
// intra-fallback MBs (the all-inter frames deblock on device,
// codecs/h264/deblock_tpu.py).
// ---------------------------------------------------------------------------
static const uint8_t kDbAlpha[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36,
    40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203,
    226, 255, 255};
static const uint8_t kDbBeta[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11,
    11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18};
static const uint8_t kDbTc0[52][3] = {
    {0,0,0},{0,0,0},{0,0,0},{0,0,0},{0,0,0},{0,0,0},{0,0,0},{0,0,0},
    {0,0,0},{0,0,0},{0,0,0},{0,0,0},{0,0,0},{0,0,0},{0,0,0},{0,0,0},
    {0,0,0},{0,0,1},{0,0,1},{0,0,1},{0,0,1},{0,1,1},{0,1,1},{1,1,1},
    {1,1,1},{1,1,1},{1,1,1},{1,1,2},{1,1,2},{1,1,2},{1,1,2},{1,2,3},
    {1,2,3},{2,2,3},{2,2,4},{2,3,4},{2,3,4},{3,3,5},{3,4,6},{3,4,6},
    {4,5,7},{4,5,8},{4,6,9},{5,7,10},{6,8,11},{6,8,13},{7,10,14},
    {8,11,16},{9,12,18},{10,13,20},{11,15,23},{13,17,25}};

static inline int db_iclip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

static void db_luma_edge_px(uint8_t* dst, int step, int bs, int idx) {
    int alpha = kDbAlpha[idx], beta = kDbBeta[idx];
    int p0 = dst[-step], p1 = dst[-2 * step], p2 = dst[-3 * step],
        p3 = dst[-4 * step];
    int q0 = dst[0], q1 = dst[step], q2 = dst[2 * step], q3 = dst[3 * step];
    if (abs(p0 - q0) >= alpha || abs(p1 - p0) >= beta ||
        abs(q1 - q0) >= beta)
        return;
    int ap = abs(p2 - p0), aq = abs(q2 - q0);
    if (bs < 4) {
        int tc0 = kDbTc0[idx][bs - 1];
        int tc = tc0 + (ap < beta) + (aq < beta);
        int delta = db_iclip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3,
                             -tc, tc);
        dst[-step] = clip255(p0 + delta);
        dst[0] = clip255(q0 - delta);
        if (ap < beta)
            dst[-2 * step] = (uint8_t)(p1 + db_iclip(
                (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1, -tc0, tc0));
        if (aq < beta)
            dst[step] = (uint8_t)(q1 + db_iclip(
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

static void db_chroma_edge_px(uint8_t* dst, int step, int bs, int idx) {
    int alpha = kDbAlpha[idx], beta = kDbBeta[idx];
    int p0 = dst[-step], p1 = dst[-2 * step];
    int q0 = dst[0], q1 = dst[step];
    if (abs(p0 - q0) >= alpha || abs(p1 - p0) >= beta ||
        abs(q1 - q0) >= beta)
        return;
    if (bs < 4) {
        int tc = kDbTc0[idx][bs - 1] + 1;
        int delta = db_iclip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3,
                             -tc, tc);
        dst[-step] = clip255(p0 + delta);
        dst[0] = clip255(q0 - delta);
    } else {
        dst[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
        dst[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
    }
}

struct DbCtx {
    int mb_w, mb_h, gw;
    const int8_t* mb_intra;
    const int32_t* mvs;     // (n_mb, 2)
    const int8_t* nnz;      // effective per-4x4 grid (t8 already folded)
    const int8_t* t8;       // per MB, may be null
};

static int db_block_bs(const DbCtx& D, bool mb_edge, int mbp, int mbq,
                       int gxp, int gyp, int gxq, int gyq) {
    if (D.mb_intra[mbp] || D.mb_intra[mbq]) return mb_edge ? 4 : 3;
    if (D.nnz[gyp * D.gw + gxp] || D.nnz[gyq * D.gw + gxq]) return 2;
    if (abs(D.mvs[mbp * 2] - D.mvs[mbq * 2]) >= 4 ||
        abs(D.mvs[mbp * 2 + 1] - D.mvs[mbq * 2 + 1]) >= 4)
        return 1;
    return 0;
}

static void db_frame(uint8_t* y, uint8_t* u, uint8_t* v, const DbCtx& D,
                     int qp, int qpc) {
    int W = D.mb_w * 16, cs = W / 2;
    int idx = db_iclip(qp, 0, 51), idxc = db_iclip(qpc, 0, 51);
    for (int mby = 0; mby < D.mb_h; mby++)
        for (int mbx = 0; mbx < D.mb_w; mbx++) {
            int i = mby * D.mb_w + mbx;
            int x0 = mbx * 16, y0 = mby * 16;
            bool t8 = D.t8 && D.t8[i];
            for (int e = 0; e < 4; e++) {       // vertical edges
                int ex = x0 + 4 * e;
                if (ex == 0) continue;
                if ((e & 1) && t8) continue;
                bool mbe = e == 0;
                int ni = mbe ? i - 1 : i;
                for (int k = 0; k < 4; k++) {
                    int gyp = mby * 4 + k;
                    int bs = db_block_bs(D, mbe, ni, i, (ex >> 2) - 1, gyp,
                                         ex >> 2, gyp);
                    if (!bs) continue;
                    for (int r = 0; r < 4; r++)
                        db_luma_edge_px(y + (gyp * 4 + r) * W + ex, 1, bs,
                                        idx);
                    if ((e & 1) == 0)
                        for (int r = 0; r < 2; r++) {
                            db_chroma_edge_px(
                                u + (gyp * 2 + r) * cs + (ex >> 1), 1, bs,
                                idxc);
                            db_chroma_edge_px(
                                v + (gyp * 2 + r) * cs + (ex >> 1), 1, bs,
                                idxc);
                        }
                }
            }
            for (int e = 0; e < 4; e++) {       // horizontal edges
                int ey = y0 + 4 * e;
                if (ey == 0) continue;
                if ((e & 1) && t8) continue;
                bool mbe = e == 0;
                int ni = mbe ? i - D.mb_w : i;
                for (int k = 0; k < 4; k++) {
                    int gxp = mbx * 4 + k;
                    int bs = db_block_bs(D, mbe, ni, i, gxp, (ey >> 2) - 1,
                                         gxp, ey >> 2);
                    if (!bs) continue;
                    for (int c = 0; c < 4; c++)
                        db_luma_edge_px(y + ey * W + gxp * 4 + c, W, bs,
                                        idx);
                    if ((e & 1) == 0)
                        for (int c = 0; c < 2; c++) {
                            db_chroma_edge_px(
                                u + (ey >> 1) * cs + gxp * 2 + c, cs, bs,
                                idxc);
                            db_chroma_edge_px(
                                v + (ey >> 1) * cs + gxp * 2 + c, cs, bs,
                                idxc);
                        }
                }
            }
        }
}

extern "C" {

// Append RBSP of an IDR I slice after the given header bits.
// Returns bytes written (>=0) or -1 on buffer overflow.
int hb264_encode_i_slice(
    int mb_w, int mb_h, int qp, int qpc, int cabac,
    const uint8_t* hdr_bytes, int hdr_nbytes, uint64_t hdr_cur, int hdr_nbits,
    const uint8_t* src_y, const uint8_t* src_u, const uint8_t* src_v,
    uint8_t* rec_y, uint8_t* rec_u, uint8_t* rec_v,
    uint8_t* out, int out_cap) {
    BitWriter bw;
    bw.init(out, out_cap);
    if (hdr_nbytes > out_cap) return -1;
    memcpy(out, hdr_bytes, hdr_nbytes);
    bw.pos = hdr_nbytes;
    bw.cur = hdr_cur;
    bw.nbits = hdr_nbits;

    Ctx ctx;
    ctx.init(mb_w, mb_h);
    Planes P = {src_y, src_u, src_v, rec_y, rec_u, rec_v,
                mb_w * 16, mb_h * 16};
    Cabac cbo;
    Cabac* cb = nullptr;
    if (cabac) {
        if (bw.nbits)                         // cabac_alignment_one_bits
            bw.put((1u << (8 - bw.nbits)) - 1, 8 - bw.nbits);
        cbo.e.init(&bw, qp, /*i_slice=*/true, 0);
        cbo.s.init(mb_w, mb_h);
        cb = &cbo;
    }
    int skip_run = 0;
    int n_mb = mb_w * mb_h;
    for (int mby = 0; mby < mb_h; mby++)
        for (int mbx = 0; mbx < mb_w; mbx++) {
            ctx.cur = mby * mb_w + mbx;
            int32_t ipred[256];
            int imode = pick_i16_mode(P, mbx, mby, ipred);
            write_intra_mb(bw, ctx, P, mbx, mby, imode, ipred, qp, qpc,
                           false, &skip_run, cb);
            if (cb) cb->e.terminate(ctx.cur == n_mb - 1);  // end_of_slice
            if (bw.overflow) return -1;
        }
    if (cb) {
        if (bw.nbits) bw.put(0, 8 - bw.nbits);  // trailing alignment zeros
    } else {
        bw.rbsp_trailing();
    }
    if (bw.overflow) return -1;
    return bw.pos;
}

// P slice from device analysis arrays (see encoder_tpu.build_p_analyzer):
//   mv (n,2) i16; sad (n) i32; luma_lv (n,16,16) i16 raster blocks;
//   cbp_luma (n) i8; udc/vdc (n,4) i16; uac/vac (n,4,16) i16;
//   unnz/vnnz (n,4) i8. rec planes arrive PRE-FILLED with the device
//   recon (assembled on device); only intra-fallback MBs are rewritten.
int hb264_encode_p_slice(
    int mb_w, int mb_h, int qp, int qpc, int intra_thresh, int cabac,
    int t8_mode,
    const uint8_t* hdr_bytes, int hdr_nbytes, uint64_t hdr_cur, int hdr_nbits,
    const uint8_t* src_y, const uint8_t* src_u, const uint8_t* src_v,
    const int16_t* mv, const int32_t* sad,
    const int16_t* luma_lv, const int8_t* cbp_luma_arr,
    const int8_t* t8_arr,
    const int16_t* udc_a, const int16_t* vdc_a,
    const int16_t* uac_a, const int16_t* vac_a,
    const int8_t* unnz_a, const int8_t* vnnz_a,
    uint8_t* rec_y, uint8_t* rec_u, uint8_t* rec_v,
    uint8_t* out, int out_cap,
    int8_t* out_intra, int8_t* out_nnz) {
    BitWriter bw;
    bw.init(out, out_cap);
    if (hdr_nbytes > out_cap) return -1;
    memcpy(out, hdr_bytes, hdr_nbytes);
    bw.pos = hdr_nbytes;
    bw.cur = hdr_cur;
    bw.nbits = hdr_nbits;

    Ctx ctx;
    ctx.init(mb_w, mb_h);
    Planes P = {src_y, src_u, src_v, rec_y, rec_u, rec_v,
                mb_w * 16, mb_h * 16};
    Cabac cbo;
    Cabac* cb = nullptr;
    if (cabac) {
        if (bw.nbits)                         // cabac_alignment_one_bits
            bw.put((1u << (8 - bw.nbits)) - 1, 8 - bw.nbits);
        cbo.e.init(&bw, qp, /*i_slice=*/false, 0);
        cbo.s.init(mb_w, mb_h);
        cb = &cbo;
    }
    int ls = P.w;
    int skip_run = 0;
    int n_mb = mb_w * mb_h;
    for (int mby = 0; mby < mb_h; mby++)
        for (int mbx = 0; mbx < mb_w; mbx++) {
            int i = mby * mb_w + mbx;
            ctx.cur = i;
            int x0 = mbx * 16, y0 = mby * 16;
            int mvx_ = mv[i * 2], mvy_ = mv[i * 2 + 1];
            int u_dc = (udc_a[i * 4] | udc_a[i * 4 + 1] | udc_a[i * 4 + 2]
                        | udc_a[i * 4 + 3]) != 0;
            int v_dc = (vdc_a[i * 4] | vdc_a[i * 4 + 1] | vdc_a[i * 4 + 2]
                        | vdc_a[i * 4 + 3]) != 0;
            int u_ac = (unnz_a[i * 4] + unnz_a[i * 4 + 1] + unnz_a[i * 4 + 2]
                        + unnz_a[i * 4 + 3]) > 0;
            int v_ac = (vnnz_a[i * 4] + vnnz_a[i * 4 + 1] + vnnz_a[i * 4 + 2]
                        + vnnz_a[i * 4 + 3]) > 0;
            int cbp_chroma = (u_ac || v_ac) ? 2 : ((u_dc || v_dc) ? 1 : 0);
            int cbp_luma = cbp_luma_arr[i];
            int cbp = cbp_luma | (cbp_chroma << 4);
            int t8 = t8_mode && t8_arr && t8_arr[i];

            bool done_mb = false;
            if (sad[i] > intra_thresh) {
                // host intra fallback against current recon neighbours
                int32_t ipred[256];
                int imode = pick_i16_mode(P, mbx, mby, ipred);
                int64_t icost = sad16(&src_y[y0 * ls + x0], ls, ipred);
                if (icost < (int64_t)sad[i]) {
                    write_intra_mb(bw, ctx, P, mbx, mby, imode, ipred, qp,
                                   qpc, true, &skip_run, cb);
                    done_mb = true;
                }
            }

            if (!done_mb) {
                int smx, smy;
                skip_mv(ctx, mbx, mby, &smx, &smy);
                if (cbp == 0 && mvx_ == smx && mvy_ == smy) {
                    // P_Skip — recon already in the pre-filled planes
                    ctx.mvx[i] = mvx_; ctx.mvy[i] = mvy_; ctx.ref[i] = 0;
                    if (cb) cabac_write_skip(*cb, mbx, mby, ctx);
                    else skip_run++;
                    done_mb = true;
                }
            }

            if (!done_mb) {
                int pmx, pmy;
                predict_mv(ctx, mbx, mby, &pmx, &pmy);
                int32_t udc4[4], vdc4[4], uac4[4][16], vac4[4][16];
                for (int k = 0; k < 4; k++) {
                    udc4[k] = udc_a[i * 4 + k];
                    vdc4[k] = vdc_a[i * 4 + k];
                    for (int t = 0; t < 16; t++) {
                        uac4[k][t] = uac_a[(i * 4 + k) * 16 + t];
                        vac4[k][t] = vac_a[(i * 4 + k) * 16 + t];
                    }
                }
                if (cb) {
                    int32_t lv16[16][16];
                    for (int blk = 0; blk < 16; blk++)
                        for (int t = 0; t < 16; t++)
                            lv16[blk][t] = luma_lv[(i * 16 + blk) * 16 + t];
                    cabac_mb_skip(*cb, mbx, mby, 0);
                    cabac_write_inter(*cb, ctx, mbx, mby,
                                      mvx_ - pmx, mvy_ - pmy,
                                      cbp_luma, cbp_chroma, lv16,
                                      udc4, uac4, vdc4, vac4,
                                      t8_mode, t8);
                } else {
                    bw.ue(skip_run);
                    skip_run = 0;
                    bw.ue(0);  // mb_type P_L0_16x16
                    bw.se(mvx_ - pmx);
                    bw.se(mvy_ - pmy);
                    bw.ue(CBP_INTER_INV[cbp]);
                    if (t8_mode && (cbp & 15))
                        bw.put_bit(t8 ? 1 : 0);  // transform_size_8x8_flag
                    if (cbp != 0) bw.se(0);  // mb_qp_delta
                    int b0y = mby * 4, b0x = mbx * 4;
                    int W4 = mb_w * 4;
                    if (cbp_luma && t8) {
                        // 8x8: four interleaved CAVLC sub-streams per
                        // coded quadrant, already in scan order
                        for (int k = 0; k < 16; k++) {
                            int ridx = CODED_ORDER[k];
                            int quad = (ridx / 8) * 2 + (ridx % 4) / 2;
                            int by = b0y + ridx / 4, bx = b0x + ridx % 4;
                            if (!((cbp_luma >> quad) & 1)) {
                                ctx.nnz_l[by * W4 + bx] = 0;
                                continue;
                            }
                            int nc = ctx.nc_luma(by, bx);
                            const int16_t* sub = &luma_lv[(i * 16 + k) * 16];
                            int32_t z[16];
                            for (int t = 0; t < 16; t++) z[t] = sub[t];
                            int tc = encode_residual(bw, z, nc, 16);
                            ctx.nnz_l[by * W4 + bx] = tc;
                        }
                    } else if (cbp_luma) {
                        for (int k = 0; k < 16; k++) {
                            int ridx = CODED_ORDER[k];
                            int quad = (ridx / 8) * 2 + (ridx % 4) / 2;
                            int by = b0y + ridx / 4, bx = b0x + ridx % 4;
                            if (!((cbp_luma >> quad) & 1)) {
                                ctx.nnz_l[by * W4 + bx] = 0;
                                continue;
                            }
                            int nc = ctx.nc_luma(by, bx);
                            const int16_t* blk = &luma_lv[(i * 16 + ridx) * 16];
                            int32_t z[16];
                            for (int t = 0; t < 16; t++)
                                z[t] = blk[ZIGZAG_4x4[t]];
                            int tc = encode_residual(bw, z, nc, 16);
                            ctx.nnz_l[by * W4 + bx] = tc;
                        }
                    } else {
                        for (int r = 0; r < 4; r++)
                            for (int c = 0; c < 4; c++)
                                ctx.nnz_l[(b0y + r) * W4 + b0x + c] = 0;
                    }
                    write_chroma_residual(bw, ctx, mbx, mby, cbp_chroma,
                                          udc4, uac4, vdc4, vac4);
                }
                // recon already in the pre-filled planes
                ctx.mvx[i] = mvx_; ctx.mvy[i] = mvy_; ctx.ref[i] = 0;
            }
            if (cb) cb->e.terminate(i == n_mb - 1);  // end_of_slice_flag
            if (bw.overflow) return -1;
        }
    if (cb) {
        if (bw.nbits) bw.put(0, 8 - bw.nbits);  // trailing alignment zeros
    } else {
        if (skip_run > 0) bw.ue(skip_run);
        bw.rbsp_trailing();
    }
    if (bw.overflow) return -1;
    // per-MB coding state for the caller's loop filter (deblock bS needs
    // the final intra mask and nnz grid, incl. intra-fallback MBs)
    if (out_intra)
        for (int i = 0; i < n_mb; i++)
            out_intra[i] = (int8_t)(ctx.ref[i] == -1);
    if (out_nnz) {
        int G = mb_h * 4 * mb_w * 4;
        for (int g = 0; g < G; g++)
            out_nnz[g] = (int8_t)(ctx.nnz_l[g] != 0);
    }
    return bw.pos;
}

// In-loop deblock of one frame in place (spec 8.7; encoder-side fixed-qp
// variant).  mb_intra: n_mb int8; mvs: n_mb*2 int32 qpel; nnz: per-4x4
// grid (mb_h*4 x mb_w*4) int8 — pass the RAW grid; 8x8-transform folding
// is applied here when t8 is non-null.
void hb264_deblock(uint8_t* y, uint8_t* u, uint8_t* v,
                   int mb_w, int mb_h, int qp, int qpc,
                   const int8_t* mb_intra, const int32_t* mvs,
                   const int8_t* nnz, const int8_t* t8) {
    DbCtx D;
    D.mb_w = mb_w; D.mb_h = mb_h; D.gw = mb_w * 4;
    D.mb_intra = mb_intra; D.mvs = mvs; D.t8 = t8;
    std::vector<int8_t> eff;
    if (t8) {
        eff.assign(nnz, nnz + mb_h * 4 * mb_w * 4);
        for (int i = 0; i < mb_w * mb_h; i++) {
            if (!t8[i]) continue;
            int mbx = i % mb_w, mby = i / mb_w;
            for (int qy = 0; qy < 4; qy += 2)
                for (int qx = 0; qx < 4; qx += 2) {
                    int g0 = (mby * 4 + qy) * D.gw + mbx * 4 + qx;
                    int any = eff[g0] || eff[g0 + 1] || eff[g0 + D.gw] ||
                              eff[g0 + D.gw + 1];
                    eff[g0] = eff[g0 + 1] = eff[g0 + D.gw] =
                        eff[g0 + D.gw + 1] = (int8_t)any;
                }
        }
        D.nnz = eff.data();
    } else {
        D.nnz = nnz;
    }
    db_frame(y, u, v, D, qp, qpc);
}

// Emulation prevention: RBSP → EBSP. Returns output length or -1 on overflow.
int hb264_rbsp_to_ebsp(const uint8_t* in, int n, uint8_t* out, int cap) {
    int zeros = 0, o = 0;
    for (int i = 0; i < n; i++) {
        uint8_t b = in[i];
        if (zeros >= 2 && b <= 3) {
            if (o >= cap) return -1;
            out[o++] = 3;
            zeros = 0;
        }
        if (o >= cap) return -1;
        out[o++] = b;
        zeros = b == 0 ? zeros + 1 : 0;
    }
    return o;
}

}  // extern "C"
