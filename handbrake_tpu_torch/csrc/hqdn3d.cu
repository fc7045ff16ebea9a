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
// Design.  Two launches a frame, each over every plane at once
// (blockIdx.y is the plane):
// - hpass: one thread per row walks its columns and writes the
//   horizontally filtered row, f32, into a scratch plane;
// - vpass: one thread per column walks its rows through the scratch
//   plane (neighbouring threads read neighbouring addresses) and, fused in
//   the same step, runs the temporal low-pass against the stored frame,
//   writes the new f32 state, and rounds, clips and stores the sample.
// Each thread loads the inputs of its next kChunk steps before it runs
// them, so a pass waits for memory once a chunk, not once a step.
// A plane whose spatial gamma is 0 skips hpass, and vpass reads its
// samples directly; a temporal gamma of 0 skips the temporal step, as the
// reference's branches do.  Every operation is rounded on its own
// (__fsub_rn, __fdiv_rn, __fmul_rn, __fadd_rn: no contraction into fma)
// and powf is the accurate one (no --use_fast_math), so the kernel
// computes what the plain version (filters/denoise.py) computes on the
// card, operation for operation.
//
// Bounds on an H100 SXM at 1080p 4:2:0 (3,110,400 samples):
// - bytes: each sample read once and written once (8-bit: 2 B) and the
//   f32 state read once and written once (8 B): 10 B a sample, 31.1 MB,
//   9.3 us at 3.35 TB/s (the scratch plane is the kernel's, not the
//   function's);
// - operations: about 3 x 12 f32 operations a sample, powf counted as a
//   few, ~0.11 GFLOP: under 2 us at 67 TFLOP/s;
// - dependency chain: luma's 1,919 horizontal then 1,079 vertical steps,
//   each a chain of sub, abs, div, sub, max, powf, mul, add: 2,998 steps;
//   at ~60 cycles a step, ~91 us at 1.98 GHz.  The chroma planes run
//   beside luma, in the same launches.
// Latency bounds this design: 1,080 + 2 x 540 rows (or 1,920 + 2 x 960
// columns) give ~31 CTAs of 4 warps a pass, one warp per scheduler, so
// each step's latency is paid in full.  Measured on an H100 80GB HBM3
// (700 W) by tools/ablate_hqdn3d.py: 1.17 ms a 1080p frame, ~770 cycles a
// step; the horizontal pass 0.48 ms (its f32 stores touch 32 cache lines
// a warp and step), the vertical 0.68 ms; with the fast power and
// division 0.70 ms.  Tiles transposed through shared memory (rows
// coalesced, several rows a warp) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPlanes = 3;
constexpr int kChunk = 8;      // steps whose inputs are loaded together

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
    float scale_in;      // 255 / maxval, as f32
    float scale_out;     // maxval / 255, as f32
    float maxval;
};

__device__ __forceinline__ float lowpass(float prev, float cur, float g) {
    const float d = __fsub_rn(prev, cur);
    const float simil =
        fmaxf(__fsub_rn(1.0f, __fdiv_rn(fabsf(d), 255.0f)), 0.0f);
    return __fadd_rn(cur, __fmul_rn(powf(simil, g), d));
}

template <typename T>
__device__ __forceinline__ float scaled(T v, float scale_in) {
    return __fmul_rn((float)v, scale_in);
}

// One thread per row: the horizontal recurrence.  The samples of the next
// kChunk columns are loaded before their steps run, so the loads wait
// once per chunk and not once per step (the pointers are __restrict__:
// an 8-bit sample may otherwise alias the f32 stores, which would keep
// every load behind the store before it).
template <typename T>
__global__ void __launch_bounds__(kThreads) hpass(Args a) {
    const Plane P = a.p[blockIdx.y];
    const int r = blockIdx.x * kThreads + threadIdx.x;
    if (!(P.g_sp > 0.0f) || r >= P.h) return;
    const T* __restrict__ s = static_cast<const T*>(P.src) + (size_t)r * P.w;
    float* __restrict__ o = P.hbuf + (size_t)r * P.w;
    float f = scaled(s[0], a.scale_in);
    o[0] = f;
    for (int c0 = 1; c0 < P.w; c0 += kChunk) {
        float x[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
            if (c0 + k < P.w) x[k] = scaled(s[c0 + k], a.scale_in);
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            if (c0 + k < P.w) {
                f = lowpass(f, x[k], P.g_sp);
                o[c0 + k] = f;
            }
        }
    }
}

// One thread per column: the vertical recurrence, with the temporal
// low-pass, the new state, the rescale and the rounding fused in; the
// next kChunk rows' inputs are loaded before their steps run.
template <typename T>
__global__ void __launch_bounds__(kThreads) vpass(Args a) {
    const Plane P = a.p[blockIdx.y];
    const int c = blockIdx.x * kThreads + threadIdx.x;
    if (c >= P.w) return;
    const bool sp = P.g_sp > 0.0f, tmp = P.g_tmp > 0.0f;
    const T* __restrict__ s = static_cast<const T*>(P.src) + c;
    const float* __restrict__ hb = P.hbuf + c;
    const float* __restrict__ ant = P.ant + c;
    float* __restrict__ ant_out = P.ant_out + c;
    T* __restrict__ out = static_cast<T*>(P.out) + c;
    float f = 0.0f;
    for (int r0 = 0; r0 < P.h; r0 += kChunk) {
        float x[kChunk], prev[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            const size_t i = (size_t)(r0 + k) * P.w;
            if (r0 + k < P.h) {
                x[k] = sp ? hb[i] : scaled(s[i], a.scale_in);
                prev[k] = tmp ? ant[i] : 0.0f;
            }
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            const int r = r0 + k;
            if (r < P.h) {
                const size_t i = (size_t)r * P.w;
                f = (sp && r > 0) ? lowpass(f, x[k], P.g_sp) : x[k];
                const float t = tmp ? lowpass(prev[k], f, P.g_tmp) : f;
                ant_out[i] = t;
                const float q = rintf(__fmul_rn(t, a.scale_out));
                out[i] = (T)fminf(fmaxf(q, 0.0f), a.maxval);
            }
        }
    }
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
    if (n < 1 || n > kMaxPlanes || (sample_bytes != 1 && sample_bytes != 2)
        || device < 0)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Args a = {};
    int max_h = 0, max_w = 0;
    bool spatial = false;
    for (int i = 0; i < n; ++i) {
        if (h[i] < 1 || w[i] < 1 || (g_sp[i] > 0.0f && hbuf[i] == nullptr))
            return (int)cudaErrorInvalidValue;
        a.p[i] = Plane{src[i], static_cast<const float*>(ant[i]),
                       static_cast<float*>(hbuf[i]), out[i],
                       static_cast<float*>(ant_out[i]), h[i], w[i],
                       g_sp[i], g_tmp[i]};
        spatial = spatial || g_sp[i] > 0.0f;
        max_h = h[i] > max_h ? h[i] : max_h;
        max_w = w[i] > max_w ? w[i] : max_w;
    }
    a.scale_in = scale_in;
    a.scale_out = scale_out;
    a.maxval = (float)maxval;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 gh((max_h + kThreads - 1) / kThreads, n);
    const dim3 gv((max_w + kThreads - 1) / kThreads, n);
    if (sample_bytes == 1) {
        if (spatial) hpass<uint8_t><<<gh, kThreads, 0, st>>>(a);
        vpass<uint8_t><<<gv, kThreads, 0, st>>>(a);
    } else {
        if (spatial) hpass<uint16_t><<<gh, kThreads, 0, st>>>(a);
        vpass<uint16_t><<<gv, kThreads, 0, st>>>(a);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
