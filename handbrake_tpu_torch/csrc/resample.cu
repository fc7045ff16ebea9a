// Separable resample of the planes of a frame on Hopper, in one launch, in
// XLA:CPU's summation order.
//
// Replaces the XLA graph handbrake_tpu/filters/kernels.py _apply_separable
// (:90-96): out = A_v @ img @ A_h^T in f32, round half to even, clip to
// [0, maxval], cast to uint8/uint16, with the (out x in) weight matrices
// of resample_matrix.  Each row of such a matrix is nonzero only on a
// short band (lanczos 2x down: 12 of 3,840 columns), so the kernel takes
// the band of each output sample instead: lo (int32, the band's first
// input index) and T weights (f32, zero where the matrix is zero, tap-
// major), built on the host once per geometry (filters/kernels.py
// resample_band).
//
// Order: each output sample sums its band in the order in which XLA:CPU
// sums the reference's product (filters/kernels.py vertical_order and
// horizontal_order; mapped by tests/test_torch_resample_order.py): over
// the absolute input index k, in blocks [0, B), [B, 2B), ... each summed
// from 0 and added in order; within a block, lane k mod L (L = 1, 2, 4 or
// 8) as a chain acc = __fmaf_rn(w, x, acc), the lanes added as neighbours,
// (l0 + l1) + (l2 + l3), or in the output columns from h_split on as
// halves, (l0 + l4) + (l2 + l6) and (l1 + l5) + (l3 + l7); from main on
// (n_in - n_in % L, or 0 for a run of columns that rounds every product),
// the tail, each product rounded and added in order from 0 (__fmul_rn,
// __fadd_rn; an fma chain where h_tail_fma), added last.
// On job (a)'s planes that is L = 1, B = 512: a chain, cut where a band
// crosses a multiple of 512.  A zero weight adds a zero (0 * x + acc is
// acc; no sum here is ever -0), so the zero-padded band, and the blocks
// and lanes a band does not reach, change no bit.  The file is built with
// --fmad=false and no fast math, so nvcc contracts nothing else; the
// plain version (filters/kernels.py resample_plain, the same order
// through utils/fp.fma32) gives the same bits on the CPU and on the card.
//
// Bounds on an H100 SXM, one 2160p letterbox frame (3840x1608 4:2:0 to
// 1920x804, lanczos): each input sample read once and each output sample
// written once, 11.6 MB, and the nonzero weights: 3.53 us at 3.35 TB/s;
// the taps' multiply-adds, 0.17 GFLOP, 2.5 us at 67 TFLOP/s f32.  So
// bytes bound it.
//
// Design (the kernel before this one, kept as tools/resample_v1.cu, took
// 71.4 us of device time on that frame: six launches, a thread a sample,
// each input row read through L1 about six times in 1-byte loads, and an
// f32 intermediate of 18.5 MB written to and read back from device
// memory):
// - One launch a frame: the wrapper passes up to three planes' descriptors
//   (pointers, bands, order, tile plan) as one __grid_constant__
//   parameter; the grid is persistent (as many blocks as fit on the SMs:
//   3 of 256 threads at 80 registers), and a block walks the output tiles
//   of all the planes, tile t, t + gridDim.x, ...
// - A block owns a tile of tile_h x tile_w outputs (16 x 128 on the main
//   path; the host plan, resample_cuda.plan, shrinks it where a window
//   would not fit).  Into a two-stage ring in shared memory it copies, a
//   tile ahead with cp.async, the input window the tile's bands need
//   (rows row0[ty] on, columns col0[tx] on, aligned down to 16 bytes;
//   16-byte copies where the plane's pitch and base are 16-byte aligned,
//   else byte by byte) and the tile's taps and band starts (4-byte
//   copies).  Each input byte the tile needs is read from device memory
//   or L2 once.
// - Vertical pass into an f32 tile in shared memory (the intermediate
//   never leaves the chip): an item is four neighbouring columns of two
//   rows (eight independent chains; one 4- or 8-byte shared load a row a
//   tap; the samples made f32 exactly by a byte permute and a
//   subtraction).
// - Horizontal pass: a thread takes one output column, its taps in
//   registers, two rows at a time; rintf, clamp and cast into a shared
//   output tile, which leaves as 16-byte stores where the output's pitch
//   allows.
// - A band that crosses one block boundary (L = 1) runs as two unrolled
//   chains added (split_chain); the general order (ordered_sum) only
//   where lanes, a tail or several boundaries ask for it.  In the
//   horizontal pass a warp takes one of the three paths for all its
//   lanes, so a lane with a crossing band does not split the warp.
// - T = 12 (lanczos 2x down, luma and chroma) is a template case; any
//   other tap count runs the same loops with a runtime bound.
// Measured (chip_smoke.py and tools/ablate_resample.py in one call on an
// NVIDIA H100 80GB HBM3, 700.00 W): 35.8 us of device time on that frame
// (36.8 us by CUDA events, 47.0 us with a cold L2), 9.9 % of the bound,
// against 79.2 us for the one before it in the same call.  Without the
// vertical pass 24.3 us, without the horizontal 28.7, copies alone 16.7:
// the two passes' issue and the per-tile latency of a block's three
// barriers, not bytes, hold it (PERF.md §6).
// Switches (for tools/ablate_resample.py): RESAMPLE_FUSED 0 sends the
// intermediate tile to a global scratch plane and reads it back from
// there; RESAMPLE_VEC 1 computes one column a thread in the vertical pass
// and stores the output a sample at a time; RESAMPLE_PHASES (a mask: 1 the
// window copies, 2 the vertical pass, 4 the horizontal pass, 8 the
// stores) leaves phases out, for their times alone (the taps and band
// starts are staged in every variant); RESAMPLE_SLOW 0 runs every band as
// one chain (wrong where a band crosses a block; its time only).
// RESAMPLE_IN and RESAMPLE_OUT (1 or 2, the bytes of a sample in and out)
// pick the one kernel a build holds: nvcc's cicc takes most of a minute
// for each, so each pair is a library of its own, and the four build at
// once in parallel processes (chip_smoke.py's build line, PERF.md §6).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef RESAMPLE_FUSED
#define RESAMPLE_FUSED 1
#endif
#ifndef RESAMPLE_VEC
#define RESAMPLE_VEC 4
#endif
#ifndef RESAMPLE_PHASES
#define RESAMPLE_PHASES 15
#endif
#ifndef RESAMPLE_SLOW
#define RESAMPLE_SLOW 1
#endif
#ifndef RESAMPLE_IN
#define RESAMPLE_IN 1
#endif
#ifndef RESAMPLE_OUT
#define RESAMPLE_OUT 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPlanes = 3;
constexpr int kFastTaps = 12;

// One plane's work.  Field order and types mirror resample_cuda.Plane.
struct Plane {
    const void* x;          // in_h x in_w samples, contiguous
    void* out;              // out_h x out_w samples, contiguous
    const int* lo_v;        // out_h
    const float* taps_v;    // tv x out_h
    const int* lo_h;        // out_w
    const float* taps_h;    // th x out_w
    const int* row0;        // tiles_y: the window's first input row
    const int* col0;        // tiles_x: its first input column (16 B aligned)
    int in_h, in_w, out_h, out_w;
    int tv, th;
    int in_bytes, out_bytes;
    float maxval;
    int tile_h, tile_w, tiles_y, tiles_x, first_tile;
    int win_h, win_w;       // window rows, columns (a multiple of 16 bytes)
    int v_lanes, v_block, v_block2, v_split, v_main, v_main2;
    int h_lanes, h_block, h_main, h_split, h_tail_fma;
    int copy16, store16;
};

struct Params {
    Plane p[kMaxPlanes];
    float* scratch;         // the unfused variant's intermediate, else null
    int n_planes, n_tiles;
    int stage_bytes, mid_floats;    // one ring stage; the f32 tile
};

// ---- small vector helpers: V is float (one column) or float4 (four) ----
__device__ __forceinline__ float vzero(float) { return 0.0f; }
__device__ __forceinline__ float4 vzero(float4) {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}
__device__ __forceinline__ float vadd(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float vfma(float w, float x, float a) {
    return __fmaf_rn(w, x, a);
}
__device__ __forceinline__ float4 vfma(float w, float4 x, float4 a) {
    return make_float4(__fmaf_rn(w, x.x, a.x), __fmaf_rn(w, x.y, a.y),
                       __fmaf_rn(w, x.z, a.z), __fmaf_rn(w, x.w, a.w));
}
__device__ __forceinline__ float vmuladd(float w, float x, float a) {
    return __fadd_rn(__fmul_rn(w, x), a);
}
__device__ __forceinline__ float4 vmuladd(float w, float4 x, float4 a) {
    return make_float4(vmuladd(w, x.x, a.x), vmuladd(w, x.y, a.y),
                       vmuladd(w, x.z, a.z), vmuladd(w, x.w, a.w));
}

// The lanes added over their absolute index, as neighbours ((l0 + l1) +
// (l2 + l3)) or as halves ((l0 + l2) + (l1 + l3)); acc[r] holds lane
// (phase + r) mod L.
template <int L, typename V>
__device__ __forceinline__ V lane_sum(const V (&acc)[L], int phase,
                                      bool halves) {
    if constexpr (L == 1) {
        return acc[0];
    } else {
        V c[L];
#pragma unroll
        for (int a = 0; a < L; ++a) {
            const int r = (a - phase) & (L - 1);
            c[a] = acc[0];
#pragma unroll
            for (int q = 1; q < L; ++q)
                if (q == r) c[a] = acc[q];
        }
#pragma unroll
        for (int n = L / 2; n >= 1; n /= 2) {
#pragma unroll
            for (int a = 0; a < n; ++a)
                c[a] = halves ? vadd(c[a], c[a + n])
                              : vadd(c[2 * a], c[2 * a + 1]);
        }
        return c[0];
    }
}

// The band's sum in the full order: taps t = 0..n-1 at absolute index
// k0 + t, weight w[t * ws] (shared memory), value load(t).
template <int L, typename V, typename Load>
__device__ V ordered_sum(Load load, const float* __restrict__ w, int ws,
                         int n, int k0, int block, int main, bool halves,
                         bool tail_fma) {
    V acc[L];
#pragma unroll
    for (int r = 0; r < L; ++r) acc[r] = vzero(V());
    V total = vzero(V()), tail = vzero(V());
    const int phase = k0 & (L - 1);
    int next = (k0 / block + 1) * block;
    for (int t0 = 0; t0 < n; t0 += L) {
#pragma unroll
        for (int r = 0; r < L; ++r) {
            const int t = t0 + r;
            if (t < n) {
                const int k = k0 + t;
                const float wt = w[t * ws];
                const V v = load(t);
                if (k >= main) {
                    tail = tail_fma ? vfma(wt, v, tail)
                                    : vmuladd(wt, v, tail);
                } else {
                    if (k == next) {
                        total = vadd(total, lane_sum<L>(acc, phase, halves));
#pragma unroll
                        for (int q = 0; q < L; ++q) acc[q] = vzero(V());
                        next += block;
                    }
                    acc[r] = vfma(wt, v, acc[r]);
                }
            }
        }
    }
    total = vadd(total, lane_sum<L>(acc, phase, halves));
    return vadd(total, tail);
}

template <typename V, typename Load>
__device__ V ordered_any(Load load, const float* __restrict__ w, int ws,
                         int n, int k0, int lanes, int block, int main,
                         bool halves = false, bool tail_fma = false) {
    if (lanes == 8)
        return ordered_sum<8, V>(load, w, ws, n, k0, block, main, halves,
                                 tail_fma);
    if (lanes == 4)
        return ordered_sum<4, V>(load, w, ws, n, k0, block, main, halves,
                                 tail_fma);
    if (lanes == 2)
        return ordered_sum<2, V>(load, w, ws, n, k0, block, main, halves,
                                 tail_fma);
    return ordered_sum<1, V>(load, w, ws, n, k0, block, main, halves,
                             tail_fma);
}

// The chain from 0 when the band lies in one block and one lane (the
// common case): T taps, T = 0 meaning n at run time.
template <int T, typename V, typename Load>
__device__ __forceinline__ V chain(Load load, const float* __restrict__ w,
                                   int ws, int n) {
    V acc = vzero(V());
    if constexpr (T > 0) {
#pragma unroll
        for (int t = 0; t < T; ++t) acc = vfma(w[t * ws], load(t), acc);
    } else {
        for (int t = 0; t < n; ++t) acc = vfma(w[t * ws], load(t), acc);
    }
    return acc;
}

// The tap at which a one-lane band with no tail crosses into the next
// block (n where it does not), or -1 where the band needs the full order
// (lanes, a tail, or more than one block boundary).
__device__ __forceinline__ int split_at(int k0, int n, int lanes, int block,
                                        int main) {
    if (lanes != 1 || k0 + n > main || n > block) return -1;
    const int r = (block & (block - 1)) == 0 ? k0 & (block - 1) : k0 % block;
    return block - r < n ? block - r : n;
}

// The two chains of a one-lane band cut at tap s (0 <= s <= n): taps
// [0, s) from 0, plus taps [s, n) from 0 (s == n: the one chain, plus 0).
template <int T, typename V, typename Load>
__device__ __forceinline__ V split_chain(Load load,
                                         const float* __restrict__ w, int ws,
                                         int n, int s) {
    V a = vzero(V()), b = vzero(V());
    const int m = T > 0 ? T : n;
#pragma unroll
    for (int t = 0; t < m; ++t) {
        const V x = load(t);
        if (t < s)
            a = vfma(w[t * ws], x, a);
        else
            b = vfma(w[t * ws], x, b);
    }
    return vadd(a, b);
}

// samples -> exact f32: 0x4B000000 | s is 2^23 + s
__device__ __forceinline__ float u2f(uint32_t bits) {
    return __fsub_rn(__uint_as_float(bits), 8388608.0f);
}

template <typename Tin>
struct Samples;

template <>
struct Samples<uint8_t> {
    static __device__ __forceinline__ float4 four(const uint8_t* p) {
        const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
        return make_float4(u2f(__byte_perm(v, 0x4B000000u, 0x7540)),
                           u2f(__byte_perm(v, 0x4B000000u, 0x7541)),
                           u2f(__byte_perm(v, 0x4B000000u, 0x7542)),
                           u2f(__byte_perm(v, 0x4B000000u, 0x7543)));
    }
    static __device__ __forceinline__ float one(const uint8_t* p) {
        return u2f(0x4B000000u | *p);
    }
    template <typename V>
    static __device__ __forceinline__ V get(const uint8_t* p) {
        if constexpr (sizeof(V) == 16) return four(p); else return one(p);
    }
};

template <>
struct Samples<uint16_t> {
    static __device__ __forceinline__ float4 four(const uint8_t* p) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        return make_float4(u2f(__byte_perm(v.x, 0x4B000000u, 0x7410)),
                           u2f(__byte_perm(v.x, 0x4B000000u, 0x7432)),
                           u2f(__byte_perm(v.y, 0x4B000000u, 0x7410)),
                           u2f(__byte_perm(v.y, 0x4B000000u, 0x7432)));
    }
    static __device__ __forceinline__ float one(const uint8_t* p) {
        return u2f(0x4B000000u |
                   *reinterpret_cast<const uint16_t*>(p));
    }
    template <typename V>
    static __device__ __forceinline__ V get(const uint8_t* p) {
        if constexpr (sizeof(V) == 16) return four(p); else return one(p);
    }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Tile {
    int plane, o0, c0, rows, cols, r0, cw0;
};

// A ring stage: the tile's input window (win_h rows of win_w * in_bytes),
// then its vertical taps (tv x tile_h f32, tap-major), horizontal taps (th
// x tile_w), and the band starts of its rows (tile_h) and columns (tile_w).
struct Stage {
    const uint8_t* win;
    const float* wv;
    const float* wh;
    const int* lv;
    const int* lh;
};

__device__ __forceinline__ Stage stage_at(const Plane& P, uint8_t* base) {
    Stage S;
    S.win = base;
    S.wv = reinterpret_cast<const float*>(base + P.win_h * P.win_w *
                                          P.in_bytes);
    S.wh = S.wv + P.tv * P.tile_h;
    S.lv = reinterpret_cast<const int*>(S.wh + P.th * P.tile_w);
    S.lh = S.lv + P.tile_h;
    return S;
}

__device__ __forceinline__ Tile find_tile(const Params& prm, int t) {
    int pi = 0;
    while (pi + 1 < prm.n_planes && t >= prm.p[pi + 1].first_tile) ++pi;
    const Plane& P = prm.p[pi];
    const int local = t - P.first_tile;
    const int ty = local / P.tiles_x, tx = local - ty * P.tiles_x;
    Tile T;
    T.plane = pi;
    T.o0 = ty * P.tile_h;
    T.c0 = tx * P.tile_w;
    T.rows = min(P.tile_h, P.out_h - T.o0);
    T.cols = min(P.tile_w, P.out_w - T.c0);
    T.r0 = __ldg(P.row0 + ty);
    T.cw0 = __ldg(P.col0 + tx);
    return T;
}

// Copy the tile's input window, taps and band starts into a ring stage
// (rows past the plane's end and columns past a row's end are left as
// they are: no band reaches them).
__device__ __forceinline__ void load_window(const Plane& P, const Tile& T,
                                            uint8_t* dst) {
    const int eb = P.in_bytes;
    const size_t pitch = static_cast<size_t>(P.in_w) * eb;
    const int wb = P.win_w * eb;
    const int rows = min(P.win_h, P.in_h - T.r0);
    const int nb = min(wb, P.in_w * eb - T.cw0 * eb);
    const uint8_t* src = static_cast<const uint8_t*>(P.x) +
                         static_cast<size_t>(T.r0) * pitch +
                         static_cast<size_t>(T.cw0) * eb;
    if (!(RESAMPLE_PHASES & 1)) {
    } else if (P.copy16) {
        const int chunks = (nb + 15) >> 4;
        for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
            const int r = i / chunks, c = i - r * chunks;
            cp_async16(dst + r * wb + c * 16, src + r * pitch + c * 16);
        }
    } else {
        for (int i = threadIdx.x; i < rows * nb; i += kThreads) {
            const int r = i / nb, c = i - r * nb;
            dst[r * wb + c] = __ldg(src + r * pitch + c);
        }
    }
    const Stage S = stage_at(P, dst);
    float* wv = const_cast<float*>(S.wv);
    float* wh = const_cast<float*>(S.wh);
    int* lv = const_cast<int*>(S.lv);
    int* lh = const_cast<int*>(S.lh);
    for (int t = 0; t < P.tv; ++t)
        for (int o = threadIdx.x; o < T.rows; o += kThreads)
            cp_async4(wv + t * P.tile_h + o,
                      P.taps_v + static_cast<size_t>(t) * P.out_h + T.o0 + o);
    for (int t = 0; t < P.th; ++t)
        for (int c = threadIdx.x; c < T.cols; c += kThreads)
            cp_async4(wh + t * P.tile_w + c,
                      P.taps_h + static_cast<size_t>(t) * P.out_w + T.c0 + c);
    for (int i = threadIdx.x; i < T.rows; i += kThreads)
        cp_async4(lv + i, P.lo_v + T.o0 + i);
    for (int i = threadIdx.x; i < T.cols; i += kThreads)
        cp_async4(lh + i, P.lo_h + T.c0 + i);
}

// The vertical pass into the f32 tile mid (rows x win_w): an item is
// kVec neighbouring columns of two rows, i and i + half, so that a thread
// runs 2 * kVec independent chains.
template <typename Tin, int T>
__device__ __forceinline__ void vertical(const Plane& P, const Tile& Tl,
                                         const Stage& S, float* mid) {
    using V = typename std::conditional<RESAMPLE_VEC == 4, float4,
                                        float>::type;
    constexpr int kVec = RESAMPLE_VEC;
    const int eb = sizeof(Tin);
    const int wb = P.win_w * eb;
    const int groups = P.win_w / kVec;
    const int half = (Tl.rows + 1) >> 1;
    // item / groups without an integer division: (item + 0.5) / groups is
    // at least 0.5 / groups from an integer, far above f32's error here
    const float inv_groups = 1.0f / groups;
    for (int item = threadIdx.x; item < half * groups; item += kThreads) {
        const int i0 = static_cast<int>((item + 0.5f) * inv_groups);
        const int g = item - i0 * groups;
        const int i1 = min(i0 + half, Tl.rows - 1);
        const int col = Tl.cw0 + g * kVec;
        const int block = col >= P.v_split ? P.v_block2 : P.v_block;
        const int main = col >= P.v_split ? P.v_main2 : P.v_main;
        const int k0 = S.lv[i0], k1 = S.lv[i1];
        const float* w0 = S.wv + i0;
        const float* w1 = S.wv + i1;
        const uint8_t* s0 = S.win + (k0 - Tl.r0) * wb + g * kVec * eb;
        const uint8_t* s1 = S.win + (k1 - Tl.r0) * wb + g * kVec * eb;
        auto load0 = [&](int t) {
            return Samples<Tin>::template get<V>(s0 + t * wb);
        };
        auto load1 = [&](int t) {
            return Samples<Tin>::template get<V>(s1 + t * wb);
        };
        V r0 = vzero(V()), r1 = vzero(V());
        const int n = T > 0 ? T : P.tv;
        const int cut0 = split_at(k0, n, P.v_lanes, block, main);
        const int cut1 = split_at(k1, n, P.v_lanes, block, main);
        if (col < P.in_w) {
            if ((cut0 == n && cut1 == n) || !RESAMPLE_SLOW) {
#pragma unroll
                for (int t = 0; t < n; ++t) {
                    r0 = vfma(w0[t * P.tile_h], load0(t), r0);
                    r1 = vfma(w1[t * P.tile_h], load1(t), r1);
                }
            } else if (cut0 >= 0 && cut1 >= 0) {
                r0 = split_chain<T, V>(load0, w0, P.tile_h, n, cut0);
                r1 = split_chain<T, V>(load1, w1, P.tile_h, n, cut1);
            } else {
                r0 = ordered_any<V>(load0, w0, P.tile_h, n, k0, P.v_lanes,
                                    block, main);
                r1 = ordered_any<V>(load1, w1, P.tile_h, n, k1, P.v_lanes,
                                    block, main);
            }
        }
        *reinterpret_cast<V*>(mid + i0 * P.win_w + g * kVec) = r0;
        if (i0 + half < Tl.rows)
            *reinterpret_cast<V*>(mid + i1 * P.win_w + g * kVec) = r1;
    }
}

// The horizontal pass from mid, rounded, clamped and cast into the
// shared output tile (rows x tile_w): a thread takes one column (its taps
// in registers) and kRows rows of it at once, rows rg, rg + groups, ...,
// as independent chains.
template <typename Tout, int T>
__device__ __forceinline__ void horizontal(const Plane& P, const Tile& Tl,
                                           const Stage& S, const float* mid,
                                           Tout* outs) {
    constexpr int kRows = 2;
    const int groups = kThreads / P.tile_w;
    const int cl = threadIdx.x % P.tile_w, rg = threadIdx.x / P.tile_w;
    if (cl >= Tl.cols) return;
    const int k0 = S.lh[cl];
    const float* w = S.wh + cl;
    const float* base = mid + (k0 - Tl.cw0);
    const int n = T > 0 ? T : P.th;
    const int s = split_at(k0, n, P.h_lanes, P.h_block, P.h_main);
    // the warp takes one path: the one chain, the cut chain (for a band
    // that crosses a block), or the full order
    const unsigned lanes = __activemask();
    const bool any_cut = __any_sync(lanes, s != n);
    const bool any_full = __any_sync(lanes, s < 0);
    float wr[T > 0 ? T : 1];
    if constexpr (T > 0) {
#pragma unroll
        for (int t = 0; t < T; ++t) wr[t] = w[t * P.tile_w];
    }
    for (int i0 = rg; i0 < Tl.rows; i0 += groups * kRows) {
        const float* m[kRows];
        float acc[kRows];
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
            m[q] = base + min(i0 + q * groups, Tl.rows - 1) * P.win_w;
            acc[q] = 0.0f;
        }
        if (!any_cut || !RESAMPLE_SLOW) {
#pragma unroll
            for (int t = 0; t < n; ++t) {
                const float wt = T > 0 ? wr[T > 0 ? t : 0]
                                       : w[t * P.tile_w];
#pragma unroll
                for (int q = 0; q < kRows; ++q)
                    acc[q] = __fmaf_rn(wt, m[q][t], acc[q]);
            }
        } else if (!any_full) {
            float b[kRows];
#pragma unroll
            for (int q = 0; q < kRows; ++q) b[q] = 0.0f;
#pragma unroll
            for (int t = 0; t < n; ++t) {
                const float wt = T > 0 ? wr[T > 0 ? t : 0]
                                       : w[t * P.tile_w];
                const bool first = t < s;
#pragma unroll
                for (int q = 0; q < kRows; ++q) {
                    const float x = m[q][t];
                    if (first)
                        acc[q] = __fmaf_rn(wt, x, acc[q]);
                    else
                        b[q] = __fmaf_rn(wt, x, b[q]);
                }
            }
#pragma unroll
            for (int q = 0; q < kRows; ++q) acc[q] = __fadd_rn(acc[q], b[q]);
        } else {
#pragma unroll
            for (int q = 0; q < kRows; ++q) {
                const float* mq = m[q];
                acc[q] = ordered_any<float>([&](int t) { return mq[t]; }, w,
                                            P.tile_w, n, k0, P.h_lanes,
                                            P.h_block, P.h_main,
                                            Tl.c0 + cl >= P.h_split,
                                            P.h_tail_fma != 0);
            }
        }
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
            const int i = i0 + q * groups;
            if (i < Tl.rows)
                outs[i * P.tile_w + cl] = static_cast<Tout>(
                    fminf(fmaxf(rintf(acc[q]), 0.0f), P.maxval));
        }
    }
}

// The shared output tile to the plane: 16-byte stores where the plane's
// pitch and base allow (and RESAMPLE_VEC is 4), the rest a sample at a
// time.
template <typename Tout>
__device__ __forceinline__ void store_tile(const Plane& P, const Tile& Tl,
                           const Tout* outs) {
    constexpr int kPer = 16 / sizeof(Tout);
    Tout* dst = static_cast<Tout*>(P.out) +
                static_cast<size_t>(Tl.o0) * P.out_w + Tl.c0;
    int full = 0;
    if (RESAMPLE_VEC == 4 && P.store16) {
        full = Tl.cols / kPer;
        for (int i = threadIdx.x; i < Tl.rows * full; i += kThreads) {
            const int r = i / full, q = i - r * full;
            *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r) *
                                      P.out_w + q * kPer) =
                *reinterpret_cast<const uint4*>(outs + r * P.tile_w +
                                                q * kPer);
        }
    }
    const int done = full * kPer, rest = Tl.cols - done;
    if (rest > 0) {
        for (int i = threadIdx.x; i < Tl.rows * rest; i += kThreads) {
            const int r = i / rest, c = done + (i - r * rest);
            dst[static_cast<size_t>(r) * P.out_w + c] =
                outs[r * P.tile_w + c];
        }
    }
}

template <typename Tin, typename Tout>
__device__ __forceinline__ void run_tile(const Plane& P, const Tile& Tl,
                                         uint8_t* stage, float* m,
                                         Tout* outs) {
    const Stage S = stage_at(P, stage);
    if (RESAMPLE_PHASES & 2) {
        if (P.tv == kFastTaps)
            vertical<Tin, kFastTaps>(P, Tl, S, m);
        else
            vertical<Tin, 0>(P, Tl, S, m);
    }
    __syncthreads();
    if (RESAMPLE_PHASES & 4) {
        if (P.th == kFastTaps)
            horizontal<Tout, kFastTaps>(P, Tl, S, m, outs);
        else
            horizontal<Tout, 0>(P, Tl, S, m, outs);
    }
    __syncthreads();
    if (RESAMPLE_PHASES & 8) store_tile<Tout>(P, Tl, outs);
}

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads, 3)
resample_frame(const __grid_constant__ Params prm) {
    extern __shared__ __align__(16) uint8_t smem[];
    float* mid = reinterpret_cast<float*>(smem + 2 * prm.stage_bytes);
    Tout* outs = reinterpret_cast<Tout*>(mid + prm.mid_floats);
    if constexpr (!RESAMPLE_FUSED)
        mid = prm.scratch + static_cast<size_t>(blockIdx.x) * prm.mid_floats;
    int t = blockIdx.x;
    const int step = gridDim.x, end = prm.n_tiles;
    if (t < end) {
        const Tile Tl = find_tile(prm, t);
        load_window(prm.p[Tl.plane], Tl, smem);
    }
    cp_async_commit();
    for (int s = 0; t < end; t += step, s ^= 1) {
        const int tn = t + step;
        if (tn < end) {
            const Tile Tn = find_tile(prm, tn);
            load_window(prm.p[Tn.plane], Tn, smem + (s ^ 1) * prm.stage_bytes);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const Tile Tl = find_tile(prm, t);
        // (the next pass's first barrier also keeps this tile's output
        // tile until every thread has stored its part)
        run_tile<Tin, Tout>(prm.p[Tl.plane], Tl, smem + s * prm.stage_bytes,
                            mid, outs);
    }
    cp_async_wait<0>();
}

template <typename Tin, typename Tout>
int launch(const Params& prm, int smem, cudaStream_t st) {
    // the grid: as many blocks as fit on the card at this shared memory
    // (the occupancy found once for each size)
    static int known_smem = -1, blocks = 0;
    auto kern = resample_frame<Tin, Tout>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (smem != known_smem) {
        int dev = 0, sms = 0, per_sm = 0;
        if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
            (err = cudaDeviceGetAttribute(
                 &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
            (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, kern, kThreads, smem)) != cudaSuccess)
            return static_cast<int>(err);
        if (per_sm < 1)
            return static_cast<int>(cudaErrorInvalidConfiguration);
        known_smem = smem;
        blocks = sms * per_sm;
    }
    kern<<<min(prm.n_tiles, blocks), kThreads, smem, st>>>(prm);
    return static_cast<int>(cudaGetLastError());
}

using TIn = std::conditional<RESAMPLE_IN == 2, uint16_t, uint8_t>::type;
using TOut = std::conditional<RESAMPLE_OUT == 2, uint16_t, uint8_t>::type;

}  // namespace

extern "C" {

// The planes of one frame (all of this build's sample sizes in and out),
// as the wrapper (filters/resample_cuda.py) plans them: prm points to a
// Params on the host; smem is the dynamic shared memory a block needs.
// Launches once on `stream` without synchronising; returns the launch's
// error, or cudaErrorInvalidValue for arguments the kernel does not take.
int resample_frame_launch(const void* params, int smem, int device,
                          void* stream) {
    const Params* prm = static_cast<const Params*>(params);
    if (prm == nullptr || prm->n_planes < 1 || prm->n_planes > kMaxPlanes ||
        prm->n_tiles < 1 || smem < 1 || device < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < prm->n_planes; ++i)
        if (prm->p[i].in_bytes != RESAMPLE_IN ||
            prm->p[i].out_bytes != RESAMPLE_OUT)
            return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch<TIn, TOut>(*prm, smem, static_cast<cudaStream_t>(stream));
}

// sizeof(Params), for the wrapper's check of its mirror of the struct.
int resample_params_size() { return static_cast<int>(sizeof(Params)); }

// The registers a thread and the local (spill) bytes of the kernel for
// these sample sizes (this build's), as compiled; returns the query's
// error.
int resample_kernel_attrs(int in_bytes, int out_bytes, int* regs,
                          int* local_bytes) {
    if (in_bytes != RESAMPLE_IN || out_bytes != RESAMPLE_OUT)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaFuncAttributes a;
    const cudaError_t err =
        cudaFuncGetAttributes(&a, resample_frame<TIn, TOut>);
    if (err != cudaSuccess) return static_cast<int>(err);
    *regs = a.numRegs;
    *local_bytes = static_cast<int>(a.localSizeBytes);
    return 0;
}

// The blocks an SM holds at `smem` bytes of dynamic shared memory (this
// build's sample sizes).
int resample_blocks_per_sm(int in_bytes, int out_bytes, int smem,
                           int* blocks) {
    if (in_bytes != RESAMPLE_IN || out_bytes != RESAMPLE_OUT)
        return static_cast<int>(cudaErrorInvalidValue);
    auto kern = resample_frame<TIn, TOut>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                            kThreads, smem);
    return static_cast<int>(err);
}

}  // extern "C"
