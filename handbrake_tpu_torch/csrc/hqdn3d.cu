// HQDN3D denoise of one frame (all its planes) on Hopper.
//
// Replaces handbrake_tpu/filters/denoise.py hqdn3d_plane: the horizontal
// and the vertical lax.scan recurrences (denoise.py:49, :54), then the
// temporal low-pass against the stored f32 frame, the rescale, the round
// half to even and the clip, for planes of up to 16 bits.  Each pass is
// the recurrence f = c + simil(f_prev - c)^g * (f_prev - c), with
// simil(d) = max(0, 1 - |d| / 255): nonlinear, so it has no parallel-scan
// form, and each step waits for the one before.
//
// Bounds on an H100 SXM at 1080p 4:2:0 (3,110,400 samples):
// - bytes: each sample read once and written once (8-bit: 2 B) and the
//   f32 state read once and written once (8 B): 10 B a sample, 31.1 MB,
//   9.3 us at 3.35 TB/s (the scratch plane is the kernel's, not the
//   function's);
// - the dependency chain: luma's 1,919 horizontal then 1,079 vertical
//   steps (a fused wavefront would not shorten it: the last column's
//   vertical chain starts only when the rows reach that column).  One
//   step (sub, abs, the division by 255, sub, max, powf, mul, add) is
//   measured by hqdn3d_chain_probe below (one warp, register values
//   only, clock64): 306.25 cycles with this kernel's division, 343.50
//   with __fdiv_rn, on an H100 80GB HBM3 at 700 W.  The floor is 2,998 x
//   306.25 cycles, 463.7 us at 1,980 MHz, and this bounds the kernel:
//   the bytes bound is 50 times smaller.  Measured there
//   (chip_smoke.py, tools/ablate_hqdn3d.py): 0.516 ms a 1080p frame,
//   1.11x the floor (the thread-per-row kernel this replaces: 1.16 ms).
//
// Design: each step of the chain takes the latency of its arithmetic and
// nothing more.
// - One chain warp a block, blocks across the SMs: a block owns 32 rows
//   (hpass) or 32 columns (vpass) of a plane, one lane each; all planes in
//   one launch a pass (1080p 4:2:0: 68 and 120 blocks).  Its warp 0 runs
//   the recurrence and nothing else.
// - Samples through shared memory, loaded far ahead: loader warps fill a
//   ring of kStages tiles of kTile steps x 32 lanes (hpass: samples,
//   scaled to f32; vpass: the scratch plane, or the samples where the
//   spatial gamma is 0), signalled by mbarriers.  A slot holds each
//   lane's steps as one 16-byte aligned row (pitch kTile + 4): the chain
//   warp reads its inputs and writes its results, into a second ring,
//   four steps at a time, and the eight lanes of each phase of such a
//   request cover the 32 banks.  hpass's store warp writes that ring's
//   rows to the f32 scratch plane as whole 128-byte rows, which stay in
//   L2 for vpass.
// - The temporal pass off the chain: vpass's consumer warps load the
//   state rows of a tile before its results arrive, then run the temporal
//   low-pass, store the new state, rescale, round half to even, clip and
//   store the samples, all coalesced; the chain step carries one powf and
//   one division.
// - The division by 255 is a product by r = RN(1/255) with one fma
//   correction, which equals __fdiv_rn(a, 255) for every f32 a in [0, 256)
//   (hqdn3d_div_check checks all 1,132,462,080 of them on the card;
//   |d| < 256 because the samples are scaled by 255 / maxval).
// Every other operation is rounded on its own (__fsub_rn, __fmul_rn,
// __fadd_rn: nvcc contracts into fma by default) and powf is the accurate
// one (no --use_fast_math), so the kernel computes what the plain version
// (filters/denoise.py) computes on the card, bit for bit.  A plane whose
// spatial gamma is 0 skips hpass; a temporal gamma of 0 skips the
// temporal step, as the reference's branches do.
//
// Switches (the defaults are the kernel; tools/ablate_hqdn3d.py defines
// them ahead of the source): HQDN3D_IEEE_DIV 1 divides with __fdiv_rn,
// HQDN3D_PASSES 1 or 2 launches hpass or vpass alone.  The tool's other
// variants (the chain warp alone on global memory, the temporal pass on
// the chain warp) are in tools/hqdn3d_ablate.cu, which includes this
// source.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef HQDN3D_IEEE_DIV
#define HQDN3D_IEEE_DIV 0
#endif
#ifndef HQDN3D_PASSES
#define HQDN3D_PASSES 3
#endif

namespace {

constexpr int kMaxPlanes = 3;
constexpr int kLanes = 32;            // rows (hpass) or columns (vpass) a block
constexpr int kTile = 32;             // steps a ring slot holds
constexpr int kStages = 3;            // ring slots
constexpr int kPitch = kTile + 4;     // a lane's row of steps in a slot
constexpr int kGroup = 8;             // steps the chain runs between loads
static_assert(kGroup % 4 == 0 && kTile % kGroup == 0, "float4 groups");
constexpr int kThreads = 128;
constexpr bool kIeeeDiv = HQDN3D_IEEE_DIV != 0;

struct Plane {
    const void* src;     // samples in, h x w, row-major
    const float* ant;    // f32 state in (the previous frame's), h x w
    float* hbuf;         // f32 scratch, h x w (null when g_sp is 0)
    void* out;           // samples out, h x w
    float* ant_out;      // f32 state out, h x w
    int h, w;
    float g_sp, g_tmp;
};

struct Args {
    Plane p[kMaxPlanes];
    // the blocks of plane i are [hblock[i], hblock[i + 1]) in hpass and
    // [vblock[i], vblock[i + 1]) in vpass
    int hblock[kMaxPlanes + 1];
    int vblock[kMaxPlanes + 1];
    float scale_in;      // 255 / maxval, as f32
    float scale_out;     // maxval / 255, as f32
    float maxval;
};

// RN(|d| / 255).  The product by RN(1/255) alone is wrong for about 3 in 4
// values; the fma correction makes it exact on [0, 256) (see the note).
template <bool kIeee>
__device__ __forceinline__ float div255(float a) {
    if (kIeee) return __fdiv_rn(a, 255.0f);
    const float r = 0x1.010102p-8f;   // RN(1/255)
    const float q = __fmul_rn(a, r);
    return __fmaf_rn(__fmaf_rn(-q, 255.0f, a), r, q);
}

template <bool kIeee>
__device__ __forceinline__ float lowpass(float prev, float cur, float g) {
    const float d = __fsub_rn(prev, cur);
    const float simil = fmaxf(__fsub_rn(1.0f, div255<kIeee>(fabsf(d))), 0.0f);
    return __fadd_rn(cur, __fmul_rn(powf(simil, g), d));
}

__device__ __forceinline__ float step(float prev, float cur, float g) {
    return lowpass<kIeeeDiv>(prev, cur, g);
}

template <typename T>
__device__ __forceinline__ float scaled(T v, float scale_in) {
    return __fmul_rn((float)v, scale_in);
}

template <typename T>
__device__ __forceinline__ T rounded(float t, float scale_out, float maxval) {
    const float q = rintf(__fmul_rn(t, scale_out));
    return (T)fminf(fmaxf(q, 0.0f), maxval);
}

__device__ __forceinline__ int plane_of(const int* first, int b) {
    int i = 0;
    while (i + 1 < kMaxPlanes && b >= first[i + 1]) ++i;
    return i;
}

// mbarriers in shared memory: the ring's full and empty signals.  A
// producer of fill t waits for phase parity ((t / kStages) & 1) ^ 1 of the
// slot's empty barrier (a fresh barrier counts that phase as complete), a
// consumer for parity (t / kStages) & 1 of its full barrier.  arrive
// releases and try_wait acquires, both at CTA scope.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* b, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_addr(b)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* b) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(smem_addr(b)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* b, unsigned parity) {
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@!P1 bra WAIT;\n"
        "}\n" :: "r"(smem_addr(b)), "r"(parity) : "memory");
}

struct Ring {
    uint64_t full[kStages], empty[kStages];

    __device__ void init(unsigned producers, unsigned consumers) {
        for (int s = 0; s < kStages; ++s) {
            bar_init(&full[s], producers);
            bar_init(&empty[s], consumers);
        }
    }
    __device__ void wait_empty(int t) {
        bar_wait(&empty[t % kStages], ((t / kStages) & 1) ^ 1);
    }
    __device__ void wait_full(int t) {
        bar_wait(&full[t % kStages], (t / kStages) & 1);
    }
    __device__ void filled(int t) { bar_arrive(&full[t % kStages]); }
    __device__ void emptied(int t) { bar_arrive(&empty[t % kStages]); }
};

// The chain over one ring slot's n steps: the lane's inputs xi[0, n), its
// results to xo[0, n) (kSp false copies).  The steps run in groups of
// kGroup with no test between them; a group's inputs are read, four at a
// time, a group ahead, and its results written four at a time, so the
// chain warp puts four shared-memory requests, not sixteen, beside a
// group's eight powf; only a slot's ragged end (a plane's last tile) runs
// step by step.
template <bool kSp>
__device__ __forceinline__ float chain_slot(float f, const float* xi,
                                            float* xo, int n, float g) {
    constexpr int kV = kGroup / 4;
    const float4* xv = reinterpret_cast<const float4*>(xi);
    float4* ov = reinterpret_cast<float4*>(xo);
    float4 a[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) a[j] = xv[j];
    int k = 0;
#pragma unroll 1
    for (; k + kGroup <= n; k += kGroup) {
        const int next = min(k + kGroup, kTile - kGroup) / 4;
        float4 b[kV];
#pragma unroll
        for (int j = 0; j < kV; ++j) b[j] = xv[next + j];
        float x[kGroup];
#pragma unroll
        for (int j = 0; j < kV; ++j) {
            x[4 * j] = a[j].x;
            x[4 * j + 1] = a[j].y;
            x[4 * j + 2] = a[j].z;
            x[4 * j + 3] = a[j].w;
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
            f = kSp ? step(f, x[j], g) : x[j];
            x[j] = f;
        }
#pragma unroll
        for (int j = 0; j < kV; ++j) {
            ov[k / 4 + j] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2],
                                        x[4 * j + 3]);
            a[j] = b[j];
        }
    }
    for (; k < n; ++k) {
        f = kSp ? step(f, xi[k], g) : xi[k];
        xo[k] = f;
    }
    return f;
}

// hpass: warp 0 the chain, warps 1-2 load and scale the samples (16 rows
// each), warp 3 stores the results.  Lanes of rows past the plane run on
// zeros and store nothing.
template <typename T>
__global__ void __launch_bounds__(kThreads) hpass(Args a) {
    __shared__ __align__(16) float xin[kStages][kLanes * kPitch];
    __shared__ __align__(16) float xout[kStages][kLanes * kPitch];
    __shared__ Ring rin, rout;
    const int pl = plane_of(a.hblock, blockIdx.x);
    const Plane P = a.p[pl];
    const int r0 = (blockIdx.x - a.hblock[pl]) * kLanes;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
        rin.init(64, 32);
        rout.init(32, 32);
    }
    __syncthreads();
    const int tiles = (P.w + kTile - 1) / kTile;
    if (warp == 0) {
        float f = 0.0f;
        for (int t = 0; t < tiles; ++t) {
            const int s = t % kStages;
            const int n = min(kTile, P.w - t * kTile);
            const float* xi = &xin[s][lane * kPitch];
            float* xo = &xout[s][lane * kPitch];
            rin.wait_full(t);
            rout.wait_empty(t);
            if (t == 0) f = xi[0];          // lowpass(x, x) is x
            f = chain_slot<true>(f, xi, xo, n, P.g_sp);
            rin.emptied(t);
            rout.filled(t);
        }
    } else if (warp <= 2) {
        const T* src = static_cast<const T*>(P.src);
        for (int t = 0; t < tiles; ++t) {
            const int s = t % kStages, c = t * kTile + lane;
            float v[kLanes / 2];
#pragma unroll
            for (int j = 0; j < kLanes / 2; ++j) {
                const int r = r0 + warp - 1 + 2 * j;
                v[j] = (r < P.h && c < P.w)
                    ? scaled(src[(size_t)r * P.w + c], a.scale_in) : 0.0f;
            }
            rin.wait_empty(t);
#pragma unroll
            for (int j = 0; j < kLanes / 2; ++j)
                xin[s][(warp - 1 + 2 * j) * kPitch + lane] = v[j];
            rin.filled(t);
        }
    } else {
        for (int t = 0; t < tiles; ++t) {
            const int s = t % kStages, c = t * kTile + lane;
            rout.wait_full(t);
            for (int row = 0; row < kLanes; ++row) {
                const int r = r0 + row;
                if (r < P.h && c < P.w)
                    P.hbuf[(size_t)r * P.w + c] = xout[s][row * kPitch + lane];
            }
            rout.emptied(t);
        }
    }
}

// vpass: warp 0 the chain, warp 1 loads its inputs (the scratch plane, or
// the scaled samples), warps 2-3 the temporal pass and the stores (16 rows
// of a tile each).  Lanes of columns past the plane run on zeros and
// store nothing.
template <typename T>
__global__ void __launch_bounds__(kThreads) vpass(Args a) {
    __shared__ __align__(16) float xin[kStages][kLanes * kPitch];
    __shared__ __align__(16) float vout[kStages][kLanes * kPitch];
    __shared__ Ring rin, rout;
    const int pl = plane_of(a.vblock, blockIdx.x);
    const Plane P = a.p[pl];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int c = (blockIdx.x - a.vblock[pl]) * kLanes + lane;
    const bool sp = P.g_sp > 0.0f, tmp = P.g_tmp > 0.0f;
    if (threadIdx.x == 0) {
        rin.init(32, 32);
        rout.init(32, 64);
    }
    __syncthreads();
    const int tiles = (P.h + kTile - 1) / kTile;
    if (warp == 0) {
        float f = 0.0f;
        for (int t = 0; t < tiles; ++t) {
            const int s = t % kStages;
            const int n = min(kTile, P.h - t * kTile);
            const float* xi = &xin[s][lane * kPitch];
            float* vo = &vout[s][lane * kPitch];
            rin.wait_full(t);
            rout.wait_empty(t);
            if (t == 0) f = xi[0];          // lowpass(x, x) is x
            f = sp ? chain_slot<true>(f, xi, vo, n, P.g_sp)
                   : chain_slot<false>(f, xi, vo, n, 0.0f);
            rin.emptied(t);
            rout.filled(t);
        }
    } else if (warp == 1) {
        const T* src = static_cast<const T*>(P.src);
        for (int t = 0; t < tiles; ++t) {
            const int s = t % kStages;
            float v[kTile];
#pragma unroll
            for (int k = 0; k < kTile; ++k) {
                const int r = t * kTile + k;
                const size_t i = (size_t)r * P.w + c;
                v[k] = !(r < P.h && c < P.w) ? 0.0f
                     : sp ? P.hbuf[i] : scaled(src[i], a.scale_in);
            }
            rin.wait_empty(t);
#pragma unroll
            for (int k = 0; k < kTile; ++k) xin[s][lane * kPitch + k] = v[k];
            rin.filled(t);
        }
    } else {
        T* out = static_cast<T*>(P.out);
        for (int t = 0; t < tiles; ++t) {
            const int s = t % kStages;
            float prev[kTile / 2], v[kTile / 2];
#pragma unroll
            for (int j = 0; j < kTile / 2; ++j) {
                const int r = t * kTile + warp - 2 + 2 * j;
                prev[j] = (tmp && r < P.h && c < P.w)
                    ? P.ant[(size_t)r * P.w + c] : 0.0f;
            }
            rout.wait_full(t);
#pragma unroll
            for (int j = 0; j < kTile / 2; ++j)
                v[j] = vout[s][lane * kPitch + warp - 2 + 2 * j];
            rout.emptied(t);
#pragma unroll
            for (int j = 0; j < kTile / 2; ++j) {
                const int r = t * kTile + warp - 2 + 2 * j;
                if (r < P.h && c < P.w) {
                    const size_t i = (size_t)r * P.w + c;
                    const float tv = tmp ? step(prev[j], v[j], P.g_tmp)
                                         : v[j];
                    P.ant_out[i] = tv;
                    out[i] = rounded<T>(tv, a.scale_out, a.maxval);
                }
            }
        }
    }
}

// One warp through n dependent low-pass steps on register values only
// (the inputs, noise of +-8 around 100, are computed off the chain):
// the chain's cycles a step, with the kernel's division or __fdiv_rn.
template <bool kIeee>
__global__ void chain_probe(int n, float g, float* out, long long* cycles) {
    const int lane = threadIdx.x;
    float f = 100.0f + (float)lane;
    const long long t0 = clock64();
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
        const float x = 92.0f + (float)((k * 7 + lane) & 15);
        f = lowpass<kIeee>(f, x, g);
    }
    const long long t1 = clock64();
    out[lane] = f;
    if (lane == 0) *cycles = t1 - t0;
}

// Every f32 bit pattern below `end` (256.0f's: every a in [0, 256)): the
// kernel's division against __fdiv_rn, bit for bit; counts the values it
// compares and the mismatches, and keeps the smallest bit pattern that
// differs.
__global__ void div_check(uint32_t end, unsigned long long* checked,
                          unsigned long long* mismatches,
                          uint32_t* first_bad) {
    unsigned long long n = 0, bad = 0;
    uint32_t first = 0xFFFFFFFFu;
    const uint32_t stride = gridDim.x * blockDim.x;
    for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < end;
         i += stride) {
        const float a = __uint_as_float(i);
        ++n;
        if (__float_as_uint(div255<false>(a))
                != __float_as_uint(__fdiv_rn(a, 255.0f))) {
            ++bad;
            first = min(first, i);
        }
    }
    for (int o = 16; o > 0; o >>= 1) {
        n += __shfl_xor_sync(0xFFFFFFFFu, n, o);
        bad += __shfl_xor_sync(0xFFFFFFFFu, bad, o);
        first = min(first, __shfl_xor_sync(0xFFFFFFFFu, first, o));
    }
    if ((threadIdx.x & 31) == 0) {
        atomicAdd(checked, n);
        if (bad != 0) {
            atomicAdd(mismatches, bad);
            atomicMin(first_bad, first);
        }
    }
}

// Checks hqdn3d_launch's arguments, selects the device and fills *a: the
// planes, and each pass's first block of each plane (a->hblock[kMaxPlanes]
// and a->vblock[kMaxPlanes] are the passes' block counts).  Returns
// cudaErrorInvalidValue for arguments the kernel does not take.
int plan(int n, const void* const* src, const void* const* ant,
         void* const* hbuf, void* const* out, void* const* ant_out,
         const int* h, const int* w, const float* g_sp, const float* g_tmp,
         int sample_bytes, float scale_in, float scale_out, int maxval,
         int device, Args* a) {
    if (n < 1 || n > kMaxPlanes || (sample_bytes != 1 && sample_bytes != 2)
        || device < 0)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    *a = Args{};
    int hb = 0, vb = 0;
    for (int i = 0; i < kMaxPlanes; ++i) {
        a->hblock[i] = hb;
        a->vblock[i] = vb;
        if (i >= n) continue;
        if (h[i] < 1 || w[i] < 1 || (g_sp[i] > 0.0f && hbuf[i] == nullptr))
            return (int)cudaErrorInvalidValue;
        a->p[i] = Plane{src[i], static_cast<const float*>(ant[i]),
                        static_cast<float*>(hbuf[i]), out[i],
                        static_cast<float*>(ant_out[i]), h[i], w[i],
                        g_sp[i], g_tmp[i]};
        if (g_sp[i] > 0.0f) hb += (h[i] + kLanes - 1) / kLanes;
        vb += (w[i] + kLanes - 1) / kLanes;
    }
    a->hblock[kMaxPlanes] = hb;
    a->vblock[kMaxPlanes] = vb;
    a->scale_in = scale_in;
    a->scale_out = scale_out;
    a->maxval = (float)maxval;
    return (int)cudaSuccess;
}

template <typename T>
void launch(const Args& a, cudaStream_t st) {
    const int hb = a.hblock[kMaxPlanes], vb = a.vblock[kMaxPlanes];
    if ((HQDN3D_PASSES & 1) && hb > 0) hpass<T><<<hb, kThreads, 0, st>>>(a);
    if (HQDN3D_PASSES & 2) vpass<T><<<vb, kThreads, 0, st>>>(a);
}

}  // namespace

extern "C" {

// n planes (1..3), each h[i] x w[i]: src and out of sample_bytes (1 or 2)
// a sample, ant and ant_out f32, hbuf f32 scratch (may be null where
// g_sp[i] is 0).  Launches hpass, then vpass, on `stream` without
// synchronising; returns the launches' error, or cudaErrorInvalidValue
// for arguments the kernel does not take.
int hqdn3d_launch(int n, const void* const* src, const void* const* ant,
                  void* const* hbuf, void* const* out,
                  void* const* ant_out, const int* h, const int* w,
                  const float* g_sp, const float* g_tmp, int sample_bytes,
                  float scale_in, float scale_out, int maxval, int device,
                  void* stream) {
    Args a;
    const int err = plan(n, src, ant, hbuf, out, ant_out, h, w, g_sp, g_tmp,
                         sample_bytes, scale_in, scale_out, maxval, device,
                         &a);
    if (err != (int)cudaSuccess) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (sample_bytes == 1) launch<uint8_t>(a, st);
    else launch<uint16_t>(a, st);
    return (int)cudaGetLastError();
}

// The chain probe: one warp, n_steps dependent low-pass steps at gamma g
// with the kernel's division (ieee_div 0) or __fdiv_rn (1); writes the
// warp's 32 results to out (f32) and the clock64 cycles of the loop to
// cycles (int64).  Does not synchronise.
int hqdn3d_chain_probe(int n_steps, float g, int ieee_div, void* out,
                       void* cycles, int device, void* stream) {
    if (n_steps < 1 || device < 0) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    float* o = static_cast<float*>(out);
    long long* c = static_cast<long long*>(cycles);
    if (ieee_div) chain_probe<true><<<1, 32, 0, st>>>(n_steps, g, o, c);
    else chain_probe<false><<<1, 32, 0, st>>>(n_steps, g, o, c);
    return (int)cudaGetLastError();
}

// The division's check over the f32 bit patterns below `end` (0x43800000,
// 256.0f's, for every a in [0, 256)): adds the values it compared to
// *checked and the mismatches to *mismatches (uint64 each, zeroed by the
// caller) and lowers *first_bad (uint32, set to 0xFFFFFFFF by the caller)
// to the smallest differing bit pattern.  Does not synchronise.
int hqdn3d_div_check(unsigned int end, void* checked, void* mismatches,
                     void* first_bad, int device, void* stream) {
    if (device < 0) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    div_check<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        end, static_cast<unsigned long long*>(checked),
        static_cast<unsigned long long*>(mismatches),
        static_cast<uint32_t*>(first_bad));
    return (int)cudaGetLastError();
}

}  // extern "C"
