// H.264 in-loop deblock of one frame (spec 8.7) on Hopper.
//
// Replaces handbrake_tpu/codecs/h264/deblock_pallas.py build_deblock_pallas
// together with its wrapper's compute_bs (deblock_pallas.deblock): planes
// and per-MB side data (mv, nnz, t8, intra) in, filtered copies out, bit
// for bit, for both with_strong variants.  bS is derived here, per member
// MB, from its own side data and its left and top neighbours'.
//
// Order.  Raster MBs, per MB the vertical edges then the horizontal ones,
// is a slope-2 wavefront: the MBs of one anti-diagonal t = x + 2y touch
// disjoint samples in both phases, and MB (x,y) needs (x-1,y) and
// (x+1,y-1) done.  Each plane (Y, U, V) is cut into bands of about 16 MB
// rows, one CTA per band and plane, all resident (a cooperative launch):
// a CTA walks its band's diagonals with one __syncthreads() each, and
// before a diagonal whose first-row member needs the band above, it waits
// until that band has published the diagonal before it as done (a
// counter per band in global memory, kept by the CTA's last warp, which
// takes no member).  The bands run as a pipeline, each a diagonal or two
// behind the one above.
//
// Data.  Each sample is read from `in` once.  The member tiles of
// diagonal t+1 and their side data come into shared memory with cp.async
// while diagonal t is filtered (double-buffered).  What later diagonals
// still modify stays in shared memory, as the Pallas kernel keeps L/T in
// VMEM: after MB (x,y), its columns BS-HALO.. (HALO = 4 luma, 2 chroma)
// are changed by the right neighbour at t+1 (carried in rcar[y]), and its
// rows BS-HALO.. by the bottom neighbour at t+2, after the right one
// changed their corner (carried in bcar[x]).  A band's last row hands
// those rows on through `out` instead, and the band below loads them from
// there (bypassing L1) with the top neighbours' side data.  Each row of
// `out` is stored with one 16-byte (chroma 8-byte) store; the last HALO
// bytes of a row that the right neighbour still filters are stored again,
// final, by it.
//
// Lines.  One half-warp per luma member (a quarter-warp per chroma
// member), one thread per line.  bS comes from the members' coded-block
// masks with bit operations.  In the vertical phase a thread holds its
// row, HALO + BS samples, in registers and runs all its edges there;
// after __syncwarp the same threads do the columns, but only where the
// column's bS is not 0 (most MBs of an inter frame filter no edge).  No
// memory access lies between two edges of a line.
//
// Bounds on an H100 SXM at 1080p (120x68 MBs):
// - bytes: the planes read once and written once, 2 x 3,133,440 B, plus
//   the side data the function needs, 7 B per MB (coded flags of the 16
//   blocks 2 B, mv 4 B, t8 and intra 1 B): 6,324,000 B, 1.89 us at
//   3.35 TB/s.  The design reads each sample once, has no copy pass, and
//   prefetches.
// - dependency chain: each MB waits for its left and top-right neighbours,
//   so 254 MB steps of 8 dependent edge filters (4 vertical, then 4
//   horizontal), each about 10 dependent integer operations of ~4 cycles:
//   ~81,000 cycles, about 41 us at 1.98 GHz.  The design keeps the chain
//   in registers, orders the two phases of an MB with __syncwarp only, and
//   has one barrier per diagonal.
// - neither bounds this kernel in practice.  A band's CTA spends about a
//   microsecond on each diagonal even where nothing filters: every row
//   piece of an MB is its own L1 request (the members of a diagonal sit in
//   different rows), and each line costs some 250 instructions of bS,
//   strips, addresses, loads and stores.  Bands divide that work over 15
//   SMs at 1080p; the diagonals of the frame still follow one another.
//   handbrake_tpu_torch/tools/ablate_deblock264.py measures the parts.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface, loaded by deblock_cuda.py (ctypes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSmem = 232448;    // dynamic shared memory of one block
constexpr int kMaxSide = 8192;      // samples, in width and in height
constexpr int kBandRows = 16;       // MB rows a band takes, about
constexpr int kMaxBands = 64;       // per plane
constexpr int kStage = 80;          // staged side data of one member:
                                    // nnz 64 B, mv 4 B, flags 4 B, pad
constexpr uint32_t kIntra = 1u << 16;   // info word: bits 0-15 coded 4x4
                                        // blocks (t8-folded), bit 16 intra

struct Params {
    int alpha, beta, tc0[3];
};

struct Args {
    const uint8_t* in[3];
    uint8_t* out[3];
    const int16_t* mv;      // (n_mb, 2) qpel
    const int32_t* nnz;     // (n_mb, 16) raster 4x4 blocks
    const uint8_t* intra;   // (n_mb,) bool, or null: all inter
    const uint8_t* t8;      // (n_mb,) bool, or null: no 8x8 transform
    // per (plane, band): (gen << 32) | diagonals finished; gen grows with
    // every launch, so a buffer may serve launches one after another
    unsigned long long* done;
    unsigned long long gen;
    int mb_w, mb_h;
    int bands, rows;        // bands per plane, MB rows per band
    int maxm;               // members of a diagonal in one band, at most
    Params lp, cp;
};

// The MB rows [y_lo, y_hi) of one band, and its members on diagonal t:
// rows first(t) .. first(t) + count(t) - 1.
struct Band {
    int y_lo, y_hi, mb_w;
    __host__ __device__ int first(int t) const {
        const int y = (t - mb_w + 2) >> 1;
        return y > y_lo ? y : y_lo;
    }
    __host__ __device__ int count(int t) const {
        const int hi = (t >> 1) < y_hi - 1 ? (t >> 1) : y_hi - 1;
        const int n = hi - first(t) + 1;
        return n > 0 ? n : 0;
    }
    // whether diagonal t has a member in the band's first row whose top
    // neighbour lies in the band above
    __host__ __device__ bool top_from_out(int t) const {
        return y_lo > 0 && t - 2 * y_lo >= 0 && t - 2 * y_lo < mb_w;
    }
};

// halo of a plane: the lines of an MB its right and bottom neighbours
// still filter (and read as p samples)
template <int BS>
__host__ __device__ constexpr int halo() { return BS == 16 ? 4 : 2; }

// tiles (2 x maxm), staged side data (2 x maxm), the bottom strips per MB
// column (HALO rows), the right strips per MB row of the band (a word per
// row), and the left/top neighbour info per MB row/column
template <int BS>
__host__ __device__ inline size_t smem_bytes(int mb_w, int rows, int maxm) {
    return (size_t)2 * maxm * (BS * BS + kStage) +
           (size_t)mb_w * halo<BS>() * BS + (size_t)rows * BS * 4 +
           (size_t)(mb_w + rows) * 8;
}

// progress of a band: diagonals < the value are finished and in `out`
__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
    __threadfence();
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
}

__device__ __forceinline__ void wait_for(const unsigned long long* p,
                                         unsigned long long v) {
    unsigned long long x;
    for (;;) {
        asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                     : "=l"(x) : "l"(p) : "memory");
        if (x >= v) break;
        __nanosleep(64);
    }
    __threadfence();
}

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------
template <int N>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(N));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// edge filters on a line held in registers
// ---------------------------------------------------------------------------
__device__ __forceinline__ int clip3(int lo, int hi, int x) {
    return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int clip1(int x) { return clip3(0, 255, x); }

__device__ __forceinline__ int tc0_of(const Params& p, int bs) {
    return bs <= 1 ? p.tc0[0] : (bs == 2 ? p.tc0[1] : p.tc0[2]);
}

// v[0..7] = p3 p2 p1 p0 q0 q1 q2 q3.  STRONG=false applies the normal
// filter for every bS > 0 (the analyzer's all-inter variant).
template <bool STRONG>
__device__ __forceinline__ void luma_edge(int* v, int bs, const Params& p) {
    if (bs <= 0) return;
    const int p3 = v[0], p2 = v[1], p1 = v[2], p0 = v[3];
    const int q0 = v[4], q1 = v[5], q2 = v[6], q3 = v[7];
    const int al = p.alpha, bl = p.beta;
    if (!(abs(p0 - q0) < al && abs(p1 - p0) < bl && abs(q1 - q0) < bl))
        return;
    const int ap = abs(p2 - p0), aq = abs(q2 - q0);
    if (!STRONG || bs < 4) {
        const int tc0 = tc0_of(p, bs);
        const int tc = tc0 + (ap < bl) + (aq < bl);
        const int delta =
            clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
        const int avg = (p0 + q0 + 1) >> 1;
        v[3] = clip1(p0 + delta);
        v[4] = clip1(q0 - delta);
        if (ap < bl) v[2] = p1 + clip3(-tc0, tc0, (p2 + avg - (p1 << 1)) >> 1);
        if (aq < bl) v[5] = q1 + clip3(-tc0, tc0, (q2 + avg - (q1 << 1)) >> 1);
        return;
    }
    const bool small = abs(p0 - q0) < ((al >> 2) + 2);
    if (small && ap < bl) {
        v[3] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
        v[2] = (p2 + p1 + p0 + q0 + 2) >> 2;
        v[1] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
        v[3] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (small && aq < bl) {
        v[4] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
        v[5] = (q2 + q1 + q0 + p0 + 2) >> 2;
        v[6] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
        v[4] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
}

// v[0..3] = p1 p0 q0 q1
template <bool STRONG>
__device__ __forceinline__ void chroma_edge(int* v, int bs, const Params& p) {
    if (bs <= 0) return;
    const int p1 = v[0], p0 = v[1], q0 = v[2], q1 = v[3];
    if (!(abs(p0 - q0) < p.alpha && abs(p1 - p0) < p.beta &&
          abs(q1 - q0) < p.beta))
        return;
    if (STRONG && bs == 4) {
        v[1] = (2 * p1 + p0 + q1 + 2) >> 2;
        v[2] = (2 * q1 + q0 + p1 + 2) >> 2;
        return;
    }
    const int tc = tc0_of(p, bs) + 1;
    const int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
    v[1] = clip1(p0 + delta);
    v[2] = clip1(q0 - delta);
}

// s = HALO neighbour samples, then the member's BS samples; edge e's
// window starts at s[4e] for luma (p3) and chroma (p1) alike.  bs4 holds
// 4 bits of bS per edge.
template <int BS, bool STRONG>
__device__ __forceinline__ void filter_line(int* s, uint32_t bs4,
                                            const Params& p) {
#pragma unroll
    for (int e = 0; e < BS / 4; e++) {
        const int bs = (bs4 >> (4 * e)) & 15;
        if constexpr (BS == 16)
            luma_edge<STRONG>(s + 4 * e, bs, p);
        else
            chroma_edge<STRONG>(s + 4 * e, bs, p);
    }
}

// samples <-> little-endian bytes of a word (sample values stay in 0..255)
template <int N>
__device__ __forceinline__ uint32_t pack(const int* v) {
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < N; j++) w |= (uint32_t)v[j] << (8 * j);
    return w;
}

template <int N>
__device__ __forceinline__ void unpack(uint32_t w, int* v) {
#pragma unroll
    for (int j = 0; j < N; j++) v[j] = (w >> (8 * j)) & 255u;
}

// a tile row of BS bytes in shared memory <-> BS samples
template <int BS>
__device__ __forceinline__ void load_row(const uint8_t* p, int* v) {
    if constexpr (BS == 16) {
        const uint4 q = *reinterpret_cast<const uint4*>(p);
        unpack<4>(q.x, v); unpack<4>(q.y, v + 4);
        unpack<4>(q.z, v + 8); unpack<4>(q.w, v + 12);
    } else {
        const uint2 q = *reinterpret_cast<const uint2*>(p);
        unpack<4>(q.x, v); unpack<4>(q.y, v + 4);
    }
}

template <int BS>
__device__ __forceinline__ void store_row(uint8_t* p, const int* v) {
    if constexpr (BS == 16)
        *reinterpret_cast<uint4*>(p) = make_uint4(
            pack<4>(v), pack<4>(v + 4), pack<4>(v + 8), pack<4>(v + 12));
    else
        *reinterpret_cast<uint2*>(p) = make_uint2(pack<4>(v), pack<4>(v + 4));
}

// a row as one vector: 16 luma or 8 chroma samples
template <int BS> struct RowT;
template <> struct RowT<16> { using T = uint4; };
template <> struct RowT<8> { using T = uint2; };

// its last HALO bytes, the strip the right neighbour still filters
__device__ __forceinline__ uint32_t tail(uint4 q) { return q.w; }
__device__ __forceinline__ uint32_t tail(uint2 q) { return q.y >> 16; }

// HALO bytes of a strip
template <int HALO>
__device__ __forceinline__ void store_strip(uint8_t* o, uint32_t w) {
    if constexpr (HALO == 4)
        *reinterpret_cast<uint32_t*>(o) = w;
    else
        *reinterpret_cast<uint16_t*>(o) = (uint16_t)w;
}

// ---------------------------------------------------------------------------
// boundary strengths (spec 8.7.2.1, single reference), as compute_bs
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t fold8x8(uint32_t m) {
    // 8x8-transform MBs: a 4x4 block counts as coded if any block of its
    // 8x8 quadrant is
    uint32_t r = 0;
    if (m & 0x0033u) r |= 0x0033u;
    if (m & 0x00CCu) r |= 0x00CCu;
    if (m & 0x3300u) r |= 0x3300u;
    if (m & 0xCC00u) r |= 0xCC00u;
    return r;
}

__device__ __forceinline__ bool mv_far(uint32_t a, uint32_t b) {
    const int dx = (int)(int16_t)(a & 0xffffu) - (int)(int16_t)(b & 0xffffu);
    const int dy = (int)(int16_t)(a >> 16) - (int)(int16_t)(b >> 16);
    return abs(dx) >= 4 || abs(dy) >= 4;
}

// bS of the 4 edges of one line group, 4 bits per edge (edge E in bits
// 4E..4E+3).  n: bit E set if edge E has a coded 4x4 block on either side;
// intra: the MB's own flag; the MB edge (E = 0) also takes the
// neighbour's presence, its intra flag and whether the mvs differ by 4
// or more quarter-pels.
__device__ __forceinline__ uint32_t bs_nibbles(uint32_t n, bool intra,
                                               bool t8, bool has_nb,
                                               bool nb_intra, bool mv_diff) {
    // inner edges: 3 if intra, else 2 if coded, else 0; odd edges are no
    // transform edges in 8x8-transform MBs
    const uint32_t allowed = t8 ? 0x4u : 0xEu;
    const uint32_t sel = intra ? allowed : (n & allowed);
    const uint32_t spread =
        ((sel & 2u) << 3) | ((sel & 4u) << 6) | ((sel & 8u) << 9);
    const uint32_t b0 = !has_nb ? 0u
                        : (intra || nb_intra) ? 4u
                        : (n & 1u) ? 2u
                        : mv_diff ? 1u : 0u;
    return spread * (intra ? 3u : 2u) | b0;
}

// ---------------------------------------------------------------------------
// one plane
// ---------------------------------------------------------------------------
// Issue the copies of diagonal t's member tiles and side data into buffer
// t & 1, and return this thread's member's t8/intra flags (plain loads:
// they are single bytes), which the caller stores after its own work.
template <int BS>
__device__ __forceinline__ uint32_t prefetch(const Args& a, const Band& B,
                                             const uint8_t* in,
                                             uint8_t* tiles, uint8_t* stage,
                                             int t) {
    const int y0 = B.first(t), n = B.count(t);
    const int W = a.mb_w * BS;
    uint8_t* tb = tiles + (t & 1) * a.maxm * BS * BS;
    uint8_t* sb = stage + (t & 1) * a.maxm * kStage;
    // offsets fit in int: frames are at most 8192x8192
    for (int i = threadIdx.x; i < n * BS; i += blockDim.x) {
        const int m = i / BS, r = i % BS, y = y0 + m, x = t - 2 * y;
        const int mb = y * a.mb_w + x;
        cp_async<BS>(tb + i * BS, in + (y * BS + r) * W + x * BS);
        if (r < 4)
            cp_async<16>(sb + m * kStage + 16 * r, a.nnz + mb * 16 + 4 * r);
        else if (r == 4)
            cp_async<4>(sb + m * kStage + 64, a.mv + mb * 2);
    }
    cp_async_commit();
    uint32_t fl = 0;
    if ((int)threadIdx.x < n) {
        const int y = y0 + threadIdx.x;
        const int mb = y * a.mb_w + (t - 2 * y);
        if (a.t8 && a.t8[mb]) fl |= 1u;
        if (a.intra && a.intra[mb]) fl |= 2u;
    }
    return fl;
}

__device__ __forceinline__ void store_flags(const Args& a, const Band& B,
                                            uint8_t* stage, int t,
                                            uint32_t fl) {
    if ((int)threadIdx.x < B.count(t))
        *reinterpret_cast<uint32_t*>(
            stage + ((t & 1) * a.maxm + threadIdx.x) * kStage + 68) = fl;
}

// The strip above a band's first MB row at column x comes from `out`,
// where the band above stored it (thread j loads row j, bypassing L1).
template <int BS>
__device__ __forceinline__ typename RowT<BS>::T top_load(
        const Band& B, const uint8_t* out, int t) {
    using Row = typename RowT<BS>::T;
    Row v{};
    if (B.top_from_out(t) && (int)threadIdx.x < halo<BS>())
        v = __ldcg(reinterpret_cast<const Row*>(
            out + ((size_t)B.y_lo * BS - halo<BS>() + threadIdx.x) *
                      ((size_t)B.mb_w * BS) +
            (size_t)(t - 2 * B.y_lo) * BS));
    return v;
}

template <int BS>
__device__ __forceinline__ void top_store(const Band& B, uint8_t* bcar,
                                          int t,
                                          typename RowT<BS>::T v) {
    if (B.top_from_out(t) && (int)threadIdx.x < halo<BS>())
        *reinterpret_cast<typename RowT<BS>::T*>(
            bcar + ((t - 2 * B.y_lo) * halo<BS>() + threadIdx.x) * BS) = v;
}

template <int BS, bool STRONG>
__device__ void deblock_plane(const Args& a, int band,
                              const uint8_t* __restrict__ in,
                              uint8_t* __restrict__ out, const Params& prm,
                              unsigned long long* done) {
    using Row = typename RowT<BS>::T;
    constexpr int HALO = halo<BS>();
    constexpr int CL = BS - HALO;             // lines final after the MB
    constexpr int GSHIFT = BS == 16 ? 2 : 1;  // line -> bS group
    const int mb_w = a.mb_w, maxm = a.maxm;
    const size_t W = (size_t)mb_w * BS;
    const Band B{band * a.rows, min(a.mb_h, (band + 1) * a.rows), mb_w};

    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* tiles = smem;
    uint8_t* stage = tiles + 2 * maxm * BS * BS;
    uint8_t* bcar = stage + 2 * maxm * kStage;
    uint32_t* rcar = reinterpret_cast<uint32_t*>(bcar + mb_w * HALO * BS);
    uint2* rinfo = reinterpret_cast<uint2*>(rcar + a.rows * BS);
    uint2* cinfo = rinfo + a.rows;

    // the last warp keeps the band in step with the one above it; the
    // others take the members, BS threads each
    const int tid = threadIdx.x, l = tid % BS;
    const int G = (blockDim.x - 32) / BS;       // members per pass
    const bool sync_thread = tid == (int)blockDim.x - 32;
    const unsigned mmask = ((1u << BS) - 1u) << ((tid & 31) & ~(BS - 1));
    const int t_lo = 2 * B.y_lo, t_hi = mb_w - 1 + 2 * (B.y_hi - 1);

    if (band > 0) {
        // the top neighbours' info for the band's first row
        for (int x = tid; x < mb_w; x += blockDim.x) {
            const int mb = (B.y_lo - 1) * mb_w + x;
            const int4* nz = reinterpret_cast<const int4*>(a.nnz + mb * 16);
            uint32_t bits = 0;
#pragma unroll
            for (int q = 0; q < 4; q++) {
                const int4 v = nz[q];
                bits |= ((v.x != 0) | (v.y != 0) << 1 | (v.z != 0) << 2 |
                         (v.w != 0) << 3) << (4 * q);
            }
            const bool t8 = a.t8 && a.t8[mb];
            const bool intra = a.intra && a.intra[mb];
            cinfo[x] = make_uint2((t8 ? fold8x8(bits) : bits) |
                                      (intra ? kIntra : 0u),
                                  *reinterpret_cast<const uint32_t*>(
                                      a.mv + mb * 2));
        }
        if (sync_thread) wait_for(done - 1, a.gen << 32 | t_lo);
        __syncthreads();
    }
    store_flags(a, B, stage, t_lo, prefetch<BS>(a, B, in, tiles, stage, t_lo));
    top_store<BS>(B, bcar, t_lo, top_load<BS>(B, out, t_lo));
    for (int t = t_lo; t <= t_hi; t++) {
        cp_async_wait_all();
        const bool more = t < t_hi;
        // the next diagonal's first-row member reads the band above's
        // last rows: wait until that band has finished diagonal t
        if (sync_thread && more && B.top_from_out(t + 1))
            wait_for(done - 1, a.gen << 32 | (t + 1));
        __syncthreads();
        if (sync_thread) publish(done, a.gen << 32 | t);
        uint32_t next_fl = 0;
        Row next_top{};
        if (more) {
            next_fl = prefetch<BS>(a, B, in, tiles, stage, t + 1);
            next_top = top_load<BS>(B, out, t + 1);
        }

        const int y0 = B.first(t), n = B.count(t);
        uint8_t* tb = tiles + (t & 1) * maxm * BS * BS;
        const uint8_t* sb = stage + (t & 1) * maxm * kStage;
        for (int base = 0; base < n; base += G) {
            const int m = base + tid / BS;
            // whole members leave, so mmask stays full; the last warp
            // takes no member
            if (m >= n || tid >= (int)blockDim.x - 32) break;
            const int y = y0 + m, x = t - 2 * y, yb = y - B.y_lo;
            // a band's last row hands its last rows on through `out`
            const bool last_row = y == B.y_hi - 1, last_col = x == mb_w - 1;
            uint8_t* tile = tb + m * BS * BS;
            uint8_t* strip = bcar + x * HALO * BS;   // top MB's last rows

            // --- own info: coded 4x4 blocks (t8-folded), flags, mv ---
            const uint8_t* st = sb + m * kStage;
            const int32_t* nz = reinterpret_cast<const int32_t*>(st);
            uint32_t bits;
            if constexpr (BS == 16)
                bits = nz[l] != 0 ? 1u << l : 0u;
            else
                bits = (nz[2 * l] != 0 ? 1u << (2 * l) : 0u) |
                       (nz[2 * l + 1] != 0 ? 2u << (2 * l) : 0u);
#pragma unroll
            for (int o = BS / 2; o > 0; o >>= 1)
                bits |= __shfl_xor_sync(mmask, bits, o);
            const uint32_t fl = *reinterpret_cast<const uint32_t*>(st + 68);
            const uint32_t mv = *reinterpret_cast<const uint32_t*>(st + 64);
            const bool t8 = fl & 1u, intra = fl & 2u;
            const uint32_t cm = t8 ? fold8x8(bits) : bits;
            const uint2 left = rinfo[yb], top = cinfo[x];

            // --- bS of this thread's row (V) and column (H) group k:
            // bit 4k+E of cv / 4E+k of ch: edge E coded on either side ---
            const int k = l >> GSHIFT;
            const uint32_t cv = ((cm | (cm << 1)) & 0xEEEEu) |
                                ((cm | (left.x >> 3)) & 0x1111u);
            const uint32_t ch = ((cm | (cm << 4)) & 0xFFF0u) |
                                ((cm | (top.x >> 12)) & 0x000Fu);
            const uint32_t hb = (ch >> k) & 0x1111u;
            uint32_t bsv = bs_nibbles((cv >> (4 * k)) & 15u, intra, t8, x > 0,
                                      left.x & kIntra, mv_far(mv, left.y));
            uint32_t bsh = bs_nibbles((hb | (hb >> 3) | (hb >> 6) | (hb >> 9))
                                          & 15u,
                                      intra, t8, y > 0, top.x & kIntra,
                                      mv_far(mv, top.y));
            if constexpr (BS == 8) {   // chroma: luma edges 0 and 2
                bsv = (bsv & 15u) | ((bsv >> 4) & 0xF0u);
                bsh = (bsh & 15u) | ((bsh >> 4) & 0xF0u);
            }

            // --- vertical edges: this thread's row, in registers ---
            uint32_t lw = x > 0 ? rcar[yb * BS + l] : 0u;
            if (bsv) {
                int s[HALO + BS];
                unpack<HALO>(lw, s);
                load_row<BS>(tile + l * BS, s + HALO);
                filter_line<BS, STRONG>(s, bsv, prm);
                store_row<BS>(tile + l * BS, s + HALO);
                lw = pack<HALO>(s);
            }
            if (x > 0) {
                // the left MB's last HALO columns of this row are final,
                // except in its last HALO rows, which the MB below it
                // still filters: those go to its bottom strip
                if (l < CL || last_row)
                    store_strip<HALO>(out + ((size_t)y * BS + l) * W +
                                          (size_t)x * BS - HALO, lw);
                else
                    store_strip<HALO>(bcar + ((x - 1) * HALO + l - CL) * BS +
                                          CL, lw);
            }
            __syncwarp(mmask);

            // --- horizontal edges: this thread's column, in registers ---
            if (bsh) {
                int s[HALO + BS];
#pragma unroll
                for (int j = 0; j < HALO; j++)
                    s[j] = y > 0 ? strip[j * BS + l] : 0;
#pragma unroll
                for (int i = 0; i < BS; i++) s[HALO + i] = tile[i * BS + l];
                filter_line<BS, STRONG>(s, bsh, prm);
                if (y > 0) {
#pragma unroll
                    for (int j = 0; j < HALO; j++)
                        strip[j * BS + l] = (uint8_t)s[j];
                }
#pragma unroll
                for (int i = 0; i < BS; i++)
                    tile[i * BS + l] = (uint8_t)s[HALO + i];
            }
            __syncwarp(mmask);

            // --- this thread's row out: the row to `out` (its last HALO
            // bytes are provisional unless last_col: the right neighbour
            // stores them again, final, at t+1), the rest to the strips;
            // the top MB's strip row is final now ---
            const Row q = *reinterpret_cast<const Row*>(tile + l * BS);
            uint8_t* orow = out + ((size_t)y * BS + l) * W + (size_t)x * BS;
            if (l < CL || last_row) *reinterpret_cast<Row*>(orow) = q;
            if (!last_col) rcar[yb * BS + l] = tail(q);
            if (l >= CL) {
                Row* srow = reinterpret_cast<Row*>(strip + (l - CL) * BS);
                if (y > 0)   // row l - CL of the strip is BS rows up
                    *reinterpret_cast<Row*>(orow - BS * W) = *srow;
                if (!last_row) *srow = q;
            }
            if (l == 0) {
                const uint2 info = make_uint2(cm | (intra ? kIntra : 0u), mv);
                rinfo[yb] = info;
                cinfo[x] = info;
            }
        }
        if (more) {
            store_flags(a, B, stage, t + 1, next_fl);
            top_store<BS>(B, bcar, t + 1, next_top);
        }
    }
    __syncthreads();
    if (sync_thread) publish(done, a.gen << 32 | 0xFFFFFFFFull);
}

// One CTA per (plane, band): blockIdx.x / bands is the plane, 0 = Y
// (16x16 MBs, 4 edges), 1 = U, 2 = V (8x8, 2 edges); blockIdx.x % bands
// the band.  Launched cooperatively: a band waits for the one above it.
template <bool STRONG>
__global__ void __launch_bounds__(kThreads) deblock264_kernel(Args a) {
    const int p = blockIdx.x / a.bands, band = blockIdx.x % a.bands;
    unsigned long long* done = a.done + blockIdx.x;
    if (p == 0)
        deblock_plane<16, STRONG>(a, band, a.in[0], a.out[0], a.lp, done);
    else
        deblock_plane<8, STRONG>(a, band, a.in[p], a.out[p], a.cp, done);
}

// members of a diagonal on rows [0, rows), at most
int max_members(int mb_w, int rows) {
    const Band b{0, rows, mb_w};
    int best = 0;
    for (int t = 0; t < mb_w + 2 * (rows - 1); t++)
        best = b.count(t) > best ? b.count(t) : best;
    return best;
}

}  // namespace

extern "C" {

// scal: host int32[10] = luma alpha, beta, tc0[3], chroma alpha, beta,
// tc0[3] (deblock.deblock_scal).  intra and t8 may be null.  done: 3 x
// kMaxBands int64, zeros before their first launch, used by one stream
// at a time.  Launches on
// `stream` without synchronising; returns the launch's error, or
// cudaErrorInvalidValue for a frame the kernel does not take.
int deblock264_launch(const void* in_y, const void* in_u, const void* in_v,
                      void* out_y, void* out_u, void* out_v, const void* mv,
                      const void* nnz, const void* intra, const void* t8,
                      void* done, int mb_w, int mb_h, const int32_t* scal,
                      int with_strong, int device, void* stream) {
    static bool attr_set[64][2];
    static unsigned long long launch_gen = 0;
    if (mb_w < 1 || mb_h < 1 || mb_w * 16 > kMaxSide || mb_h * 16 > kMaxSide ||
        device < 0 || device >= 64)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    // bands of about kBandRows MB rows, one CTA per band and plane, all
    // resident at once
    int bands = (mb_h + kBandRows - 1) / kBandRows;
    const int cap = sms / 3 < kMaxBands ? sms / 3 : kMaxBands;
    bands = bands < cap ? bands : (cap > 0 ? cap : 1);
    Args a;
    a.rows = (mb_h + bands - 1) / bands;
    a.bands = (mb_h + a.rows - 1) / a.rows;
    a.in[0] = (const uint8_t*)in_y;
    a.in[1] = (const uint8_t*)in_u;
    a.in[2] = (const uint8_t*)in_v;
    a.out[0] = (uint8_t*)out_y;
    a.out[1] = (uint8_t*)out_u;
    a.out[2] = (uint8_t*)out_v;
    a.mv = (const int16_t*)mv;
    a.nnz = (const int32_t*)nnz;
    a.intra = (const uint8_t*)intra;
    a.t8 = (const uint8_t*)t8;
    a.done = (unsigned long long*)done;
    a.gen = __atomic_add_fetch(&launch_gen, 1ull, __ATOMIC_RELAXED);
    a.mb_w = mb_w;
    a.mb_h = mb_h;
    a.maxm = max_members(mb_w, a.rows);
    a.lp = {scal[0], scal[1], {scal[2], scal[3], scal[4]}};
    a.cp = {scal[5], scal[6], {scal[7], scal[8], scal[9]}};
    const size_t smem = smem_bytes<16>(mb_w, a.rows, a.maxm);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    // the members' threads in whole warps, and one warp more
    int threads = (a.maxm * 16 + 31) / 32 * 32 + 32;
    threads = threads < kThreads ? threads : kThreads;
    void (*kern)(Args) = with_strong ? deblock264_kernel<true>
                                     : deblock264_kernel<false>;
    if (!attr_set[device][with_strong ? 1 : 0]) {
        err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
        if (err != cudaSuccess) return (int)err;
        attr_set[device][with_strong ? 1 : 0] = true;
    }
    void* args[] = {&a};
    err = cudaLaunchCooperativeKernel((const void*)kern, dim3(3 * a.bands),
                                      dim3(threads), args, smem,
                                      (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // extern "C"
