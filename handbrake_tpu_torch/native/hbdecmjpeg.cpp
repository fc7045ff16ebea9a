// hbdecmjpeg — baseline JPEG / MJPEG decoder (host native stage).
//
// Role of decavcodec.c's MJPEG personality: decode Motion-JPEG video as
// found in AVI files from cameras/OpenCV (ITU-T T.81 baseline DCT,
// Huffman, interleaved scan, restart markers; 4:2:0/4:2:2/4:4:4).
// All entropy tables arrive in-stream (DQT/DHT), so this is built purely
// from the JPEG spec.  The inverse DCT is the classic 32-bit fixed-point
// "islow" AAN variant; JPEG does not mandate a bit-exact IDCT, so
// conformance tests compare against libavcodec within the IEEE-1180
// style tolerance (tests/test_mjpeg.py).
#include <stdint.h>
#include <string.h>
#include <vector>

namespace hbmj {

static inline int iclip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

static const uint8_t kZig[64] = {
     0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ---------------------------------------------------------------------------
// integer IDCT (jpeglib islow constants, 13-bit fixed point)
// ---------------------------------------------------------------------------
#define C(x) x
static const int F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433,
                 F_0_765 = 6270, F_0_899 = 7373, F_1_175 = 9633,
                 F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069,
                 F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

static void idct8(int* blk, uint8_t* dst, int stride) {
    int ws[64];
    for (int c = 0; c < 8; c++) {
        int* col = blk + c;
        if (!(col[8] | col[16] | col[24] | col[32] | col[40] | col[48] |
              col[56])) {
            int dc = col[0] << 2;
            for (int r = 0; r < 8; r++) ws[r * 8 + c] = dc;
            continue;
        }
        int z2 = col[16], z3 = col[48];
        int z1 = (z2 + z3) * F_0_541;
        int tmp2 = z1 + z3 * (-F_1_847);
        int tmp3 = z1 + z2 * F_0_765;
        z2 = col[0]; z3 = col[32];
        int tmp0 = (z2 + z3) << 13;
        int tmp1 = (z2 - z3) << 13;
        int t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
        int t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
        tmp0 = col[56]; tmp1 = col[40]; tmp2 = col[24]; tmp3 = col[8];
        z1 = tmp0 + tmp3; z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2; int z4 = tmp1 + tmp3;
        int z5 = (z3 + z4) * F_1_175;
        tmp0 *= F_0_298; tmp1 *= F_2_053; tmp2 *= F_3_072; tmp3 *= F_1_501;
        z1 *= -F_0_899; z2 *= -F_2_562; z3 *= -F_1_961; z4 *= -F_0_390;
        z3 += z5; z4 += z5;
        tmp0 += z1 + z3; tmp1 += z2 + z4; tmp2 += z2 + z3; tmp3 += z1 + z4;
        const int R1 = 1 << 10;                  // DESCALE rounding
        ws[c]      = (t10 + tmp3 + R1) >> 11;
        ws[56 + c] = (t10 - tmp3 + R1) >> 11;
        ws[8 + c]  = (t11 + tmp2 + R1) >> 11;
        ws[48 + c] = (t11 - tmp2 + R1) >> 11;
        ws[16 + c] = (t12 + tmp1 + R1) >> 11;
        ws[40 + c] = (t12 - tmp1 + R1) >> 11;
        ws[24 + c] = (t13 + tmp0 + R1) >> 11;
        ws[32 + c] = (t13 - tmp0 + R1) >> 11;
    }
    for (int r = 0; r < 8; r++) {
        int* row = ws + r * 8;
        int z2 = row[2], z3 = row[6];
        int z1 = (z2 + z3) * F_0_541;
        int tmp2 = z1 + z3 * (-F_1_847);
        int tmp3 = z1 + z2 * F_0_765;
        z2 = row[0]; z3 = row[4];
        int tmp0 = (z2 + z3) << 13;
        int tmp1 = (z2 - z3) << 13;
        int t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
        int t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
        tmp0 = row[7]; tmp1 = row[5]; tmp2 = row[3]; tmp3 = row[1];
        z1 = tmp0 + tmp3; z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2; int z4 = tmp1 + tmp3;
        int z5 = (z3 + z4) * F_1_175;
        tmp0 *= F_0_298; tmp1 *= F_2_053; tmp2 *= F_3_072; tmp3 *= F_1_501;
        z1 *= -F_0_899; z2 *= -F_2_562; z3 *= -F_1_961; z4 *= -F_0_390;
        z3 += z5; z4 += z5;
        tmp0 += z1 + z3; tmp1 += z2 + z4; tmp2 += z2 + z3; tmp3 += z1 + z4;
        uint8_t* d = dst + r * stride;
        const int R2 = 1 << 17;
        d[0] = (uint8_t)iclip(((t10 + tmp3 + R2) >> 18) + 128, 0, 255);
        d[7] = (uint8_t)iclip(((t10 - tmp3 + R2) >> 18) + 128, 0, 255);
        d[1] = (uint8_t)iclip(((t11 + tmp2 + R2) >> 18) + 128, 0, 255);
        d[6] = (uint8_t)iclip(((t11 - tmp2 + R2) >> 18) + 128, 0, 255);
        d[2] = (uint8_t)iclip(((t12 + tmp1 + R2) >> 18) + 128, 0, 255);
        d[5] = (uint8_t)iclip(((t12 - tmp1 + R2) >> 18) + 128, 0, 255);
        d[3] = (uint8_t)iclip(((t13 + tmp0 + R2) >> 18) + 128, 0, 255);
        d[4] = (uint8_t)iclip(((t13 - tmp0 + R2) >> 18) + 128, 0, 255);
    }
}

// ---------------------------------------------------------------------------
// Huffman tables (canonical, from DHT)
// ---------------------------------------------------------------------------
struct Huff {
    int maxcode[17];               // largest code of length l
    int mincode[17];
    int valptr[17];
    uint8_t vals[256];
    bool valid = false;

    void build(const uint8_t* bits, const uint8_t* v, int nv) {
        memcpy(vals, v, nv);
        int code = 0, k = 0;
        for (int l = 1; l <= 16; l++) {
            valptr[l] = k;
            mincode[l] = code;
            code += bits[l - 1];
            k += bits[l - 1];
            maxcode[l] = code - 1;
            code <<= 1;
        }
        valid = true;
    }
};

struct BitIn {
    const uint8_t* d;
    int n, pos;                    // byte pos
    uint32_t acc = 0;
    int nbits = 0;
    bool marker_hit = false;

    void refill() {
        while (nbits <= 24) {
            if (pos >= n) { acc <<= 8; nbits += 8; continue; }
            uint8_t b = d[pos];
            if (b == 0xFF) {
                if (pos + 1 < n && d[pos + 1] == 0x00) {
                    pos += 2;
                } else {
                    marker_hit = true;       // restart or EOI
                    acc = (acc << 8);
                    nbits += 8;
                    continue;
                }
            } else {
                pos++;
            }
            acc = (acc << 8) | b;
            nbits += 8;
        }
    }
    int get(int k) {
        if (k == 0) return 0;
        if (nbits < k) refill();
        int v = (acc >> (nbits - k)) & ((1u << k) - 1);
        nbits -= k;
        return v;
    }
    int bit() { return get(1); }
    int decode(const Huff& h) {
        int code = bit();
        for (int l = 1; l <= 16; l++) {
            if (code <= h.maxcode[l])
                return h.vals[h.valptr[l] + code - h.mincode[l]];
            code = (code << 1) | bit();
        }
        return -1;
    }
    void align_restart() {
        // drop to byte boundary, skip FF D0-D7
        nbits -= nbits & 7;
        acc &= (nbits ? ((1u << nbits) - 1) : 0);
        // the marker bytes themselves were not consumed into acc
        while (pos + 1 < n && d[pos] == 0xFF &&
               d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7)
            pos += 2;
        marker_hit = false;
        nbits = 0;
        acc = 0;
    }
};

static inline int extend(int v, int t) {
    return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v;
}

struct Comp {
    int id, h, v, tq;
    int td, ta;
    int dc_pred;
    int bw, bh;                    // plane dims (blocks * 8)
    std::vector<uint8_t> plane;
};

struct Jpeg {
    int W = 0, H = 0;
    int ncomp = 0;
    Comp comp[4];
    uint16_t qt[4][64];
    Huff hdc[4], hac[4];
    int restart_interval = 0;
    int hmax = 1, vmax = 1;
    const char* err = nullptr;
};

static int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

static bool parse_headers(Jpeg& J, const uint8_t* d, int n, int* scan_off) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) { J.err = "no SOI"; return false; }
    int i = 2;
    while (i + 4 <= n) {
        if (d[i] != 0xFF) { i++; continue; }
        uint8_t m = d[i + 1];
        if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7)) { i += 2; continue; }
        if (m == 0xD9) break;
        int len = u16(d + i + 2);
        const uint8_t* p = d + i + 4;
        int plen = len - 2;
        if (i + 2 + len > n) { J.err = "truncated segment"; return false; }
        switch (m) {
        case 0xDB:                                     // DQT
            while (plen > 0) {
                int pq = p[0] >> 4, tq = p[0] & 15;
                p++; plen--;
                for (int k = 0; k < 64; k++) {
                    J.qt[tq][kZig[k]] = pq ? u16(p + 2 * k) : p[k];
                }
                int sz = pq ? 128 : 64;
                p += sz; plen -= sz;
            }
            break;
        case 0xC4:                                     // DHT
            while (plen > 0) {
                int tc = p[0] >> 4, th = p[0] & 15;
                const uint8_t* bits = p + 1;
                int nv = 0;
                for (int k = 0; k < 16; k++) nv += bits[k];
                if (tc == 0) J.hdc[th].build(bits, p + 17, nv);
                else J.hac[th].build(bits, p + 17, nv);
                p += 17 + nv; plen -= 17 + nv;
            }
            break;
        case 0xC0: case 0xC1: {                        // SOF0/1 baseline
            J.H = u16(p + 1); J.W = u16(p + 3);
            J.ncomp = p[5];
            if (J.ncomp > 4) { J.err = "too many components"; return false; }
            for (int c = 0; c < J.ncomp; c++) {
                J.comp[c].id = p[6 + 3 * c];
                J.comp[c].h = p[7 + 3 * c] >> 4;
                J.comp[c].v = p[7 + 3 * c] & 15;
                J.comp[c].tq = p[8 + 3 * c];
                if (J.comp[c].h > J.hmax) J.hmax = J.comp[c].h;
                if (J.comp[c].v > J.vmax) J.vmax = J.comp[c].v;
            }
            break;
        }
        case 0xC2:
            J.err = "progressive JPEG unsupported";
            return false;
        case 0xDD:                                     // DRI
            J.restart_interval = u16(p);
            break;
        case 0xDA: {                                   // SOS
            int ns = p[0];
            for (int s = 0; s < ns; s++) {
                int cid = p[1 + 2 * s];
                for (int c = 0; c < J.ncomp; c++)
                    if (J.comp[c].id == cid) {
                        J.comp[c].td = p[2 + 2 * s] >> 4;
                        J.comp[c].ta = p[2 + 2 * s] & 15;
                    }
            }
            *scan_off = i + 2 + len;
            return true;
        }
        default:
            break;
        }
        i += 2 + len;
    }
    J.err = "no SOS";
    return false;
}

static bool decode_scan(Jpeg& J, const uint8_t* d, int n, int off) {
    int mcux = (J.W + 8 * J.hmax - 1) / (8 * J.hmax);
    int mcuy = (J.H + 8 * J.vmax - 1) / (8 * J.vmax);
    for (int c = 0; c < J.ncomp; c++) {
        Comp& C = J.comp[c];
        C.bw = mcux * C.h * 8;
        C.bh = mcuy * C.v * 8;
        C.plane.assign((size_t)C.bw * C.bh, 128);
        C.dc_pred = 0;
    }
    BitIn b{d + off, n - off, 0};
    int rst = J.restart_interval;
    int mcu_count = 0;
    int blk[64];
    for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
            if (rst && mcu_count == rst) {
                b.align_restart();
                for (int c = 0; c < J.ncomp; c++) J.comp[c].dc_pred = 0;
                mcu_count = 0;
            }
            for (int c = 0; c < J.ncomp; c++) {
                Comp& C = J.comp[c];
                const uint16_t* q = J.qt[C.tq];
                for (int by = 0; by < C.v; by++)
                    for (int bx = 0; bx < C.h; bx++) {
                        memset(blk, 0, sizeof(blk));
                        int t = b.decode(J.hdc[C.td]);
                        if (t < 0) { J.err = "bad DC code"; return false; }
                        int diff = t ? extend(b.get(t), t) : 0;
                        C.dc_pred += diff;
                        blk[0] = C.dc_pred * q[0];
                        int k = 1;
                        while (k < 64) {
                            int rs = b.decode(J.hac[C.ta]);
                            if (rs < 0) { J.err = "bad AC code"; return false; }
                            int r = rs >> 4, s2 = rs & 15;
                            if (s2 == 0) {
                                if (r == 15) { k += 16; continue; }
                                break;                       // EOB
                            }
                            k += r;
                            if (k > 63) { J.err = "AC overflow"; return false; }
                            blk[kZig[k]] = extend(b.get(s2), s2) * q[kZig[k]];
                            k++;
                        }
                        int px = (mx * C.h + bx) * 8;
                        int py = (my * C.v + by) * 8;
                        idct8(blk, C.plane.data() + (size_t)py * C.bw + px,
                              C.bw);
                    }
            }
            mcu_count++;
        }
    return true;
}

}  // namespace hbmj

extern "C" {

// Probe geometry: returns 0 on success.
int hbdecmjpeg_info(const uint8_t* d, int n, int* w, int* h,
                    int* hs, int* vs) {
    hbmj::Jpeg J;
    int so;
    if (!hbmj::parse_headers(J, d, n, &so)) return -1;
    *w = J.W; *h = J.H;
    // chroma subsampling relative to luma (assume comp0 = Y)
    *hs = J.ncomp > 1 ? J.comp[0].h / J.comp[1].h : 1;
    *vs = J.ncomp > 1 ? J.comp[0].v / J.comp[1].v : 1;
    return 0;
}

// Decode one JPEG into caller buffers: y (w x h), u/v (cw x ch) where
// cw = ceil(w/hs), ch = ceil(h/vs).  Grayscale fills u/v with 128.
int hbdecmjpeg_decode(const uint8_t* d, int n,
                      uint8_t* y, uint8_t* u, uint8_t* v) {
    hbmj::Jpeg J;
    int so;
    if (!hbmj::parse_headers(J, d, n, &so)) return -1;
    if (!hbmj::decode_scan(J, d, n, so)) return -2;
    hbmj::Comp& Y = J.comp[0];
    for (int r = 0; r < J.H; r++)
        memcpy(y + (size_t)r * J.W, Y.plane.data() + (size_t)r * Y.bw, J.W);
    if (J.ncomp >= 3) {
        int hs = J.comp[0].h / J.comp[1].h;
        int vs = J.comp[0].v / J.comp[1].v;
        int cw = (J.W + hs - 1) / hs, ch = (J.H + vs - 1) / vs;
        for (int ci = 1; ci < 3; ci++) {
            hbmj::Comp& C = J.comp[ci];
            uint8_t* dst = ci == 1 ? u : v;
            for (int r = 0; r < ch; r++)
                memcpy(dst + (size_t)r * cw,
                       C.plane.data() + (size_t)r * C.bw, cw);
        }
    } else {
        int cw = (J.W + 1) / 2, ch = (J.H + 1) / 2;
        memset(u, 128, (size_t)cw * ch);
        memset(v, 128, (size_t)cw * ch);
    }
    return 0;
}

}  // extern "C"
