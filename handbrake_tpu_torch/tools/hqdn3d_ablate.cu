// Variants of the hqdn3d kernel (csrc/hqdn3d.cu) that
// tools/ablate_hqdn3d.py times beside it.  This file includes the
// kernel's source (the tool compiles the two together), so the variants
// share its device functions and its launch plan, and the kernel keeps
// one path.  Both compute what the kernel computes, bit for bit; the tool
// checks their outputs and states against the kernel's before it times
// them.
// - variant 1, the chain alone: a thread a row (hpass), then a column
//   (vpass), 32 threads a block on the kernel's blocks, on global memory:
//   each step's loads and stores, and in vpass the temporal low-pass, in
//   the chain thread;
// - variant 2, the temporal pass on the chain: the kernel's hpass, and a
//   vpass whose loader warp also stages the f32 state, so that the chain
//   warp runs the temporal low-pass after each vertical step, and its
//   other warps only round and store.
#include "hqdn3d.cu"

namespace {

template <typename T>
__global__ void __launch_bounds__(kLanes) hpass_alone(Args a) {
    const int pl = plane_of(a.hblock, blockIdx.x);
    const Plane P = a.p[pl];
    const int r = (blockIdx.x - a.hblock[pl]) * kLanes + threadIdx.x;
    if (r >= P.h) return;
    const T* __restrict__ s = static_cast<const T*>(P.src) + (size_t)r * P.w;
    float* __restrict__ o = P.hbuf + (size_t)r * P.w;
    float f = scaled(s[0], a.scale_in);
    o[0] = f;
    for (int c = 1; c < P.w; ++c) {
        f = step(f, scaled(s[c], a.scale_in), P.g_sp);
        o[c] = f;
    }
}

template <typename T>
__global__ void __launch_bounds__(kLanes) vpass_alone(Args a) {
    const int pl = plane_of(a.vblock, blockIdx.x);
    const Plane P = a.p[pl];
    const int c = (blockIdx.x - a.vblock[pl]) * kLanes + threadIdx.x;
    if (c >= P.w) return;
    const bool sp = P.g_sp > 0.0f, tmp = P.g_tmp > 0.0f;
    const T* src = static_cast<const T*>(P.src);
    T* out = static_cast<T*>(P.out);
    float f = 0.0f;
    for (int r = 0; r < P.h; ++r) {
        const size_t i = (size_t)r * P.w + c;
        const float x = sp ? P.hbuf[i] : scaled(src[i], a.scale_in);
        f = (sp && r > 0) ? step(f, x, P.g_sp) : x;
        const float t = tmp ? step(P.ant[i], f, P.g_tmp) : f;
        P.ant_out[i] = t;
        out[i] = rounded<T>(t, a.scale_out, a.maxval);
    }
}

// The kernel's chain_slot with the temporal low-pass of each result
// against ai[k] (where the temporal gamma gt is above 0) in its place.
template <bool kSp>
__device__ __forceinline__ float chain_slot_temporal(
        float f, const float* xi, float* xo, int n, float g, const float* ai,
        float gt) {
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
            x[j] = gt > 0.0f ? step(ai[k + j], f, gt) : f;
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
        xo[k] = gt > 0.0f ? step(ai[k], f, gt) : f;
    }
    return f;
}

// The kernel's vpass with the state staged beside the inputs (a third
// ring of slots) and the temporal low-pass on warp 0.
template <typename T>
__global__ void __launch_bounds__(kThreads) vpass_temporal(Args a) {
    __shared__ __align__(16) float xin[kStages][kLanes * kPitch];
    __shared__ __align__(16) float ain[kStages][kLanes * kPitch];
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
            const float* ai = &ain[s][lane * kPitch];
            float* vo = &vout[s][lane * kPitch];
            rin.wait_full(t);
            rout.wait_empty(t);
            if (t == 0) f = xi[0];          // lowpass(x, x) is x
            f = sp ? chain_slot_temporal<true>(f, xi, vo, n, P.g_sp, ai,
                                               P.g_tmp)
                   : chain_slot_temporal<false>(f, xi, vo, n, 0.0f, ai,
                                                P.g_tmp);
            rin.emptied(t);
            rout.filled(t);
        }
    } else if (warp == 1) {
        const T* src = static_cast<const T*>(P.src);
        for (int t = 0; t < tiles; ++t) {
            const int s = t % kStages;
            float v[kTile], av[kTile];
#pragma unroll
            for (int k = 0; k < kTile; ++k) {
                const int r = t * kTile + k;
                const size_t i = (size_t)r * P.w + c;
                const bool in = r < P.h && c < P.w;
                v[k] = !in ? 0.0f
                     : sp ? P.hbuf[i] : scaled(src[i], a.scale_in);
                av[k] = (in && tmp) ? P.ant[i] : 0.0f;
            }
            rin.wait_empty(t);
#pragma unroll
            for (int k = 0; k < kTile; ++k) {
                xin[s][lane * kPitch + k] = v[k];
                ain[s][lane * kPitch + k] = av[k];
            }
            rin.filled(t);
        }
    } else {
        T* out = static_cast<T*>(P.out);
        for (int t = 0; t < tiles; ++t) {
            const int s = t % kStages;
            float v[kTile / 2];
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
                    P.ant_out[i] = v[j];
                    out[i] = rounded<T>(v[j], a.scale_out, a.maxval);
                }
            }
        }
    }
}

template <typename T>
void launch_variant(int variant, const Args& a, cudaStream_t st) {
    const int hb = a.hblock[kMaxPlanes], vb = a.vblock[kMaxPlanes];
    if (variant == 1) {
        if (hb > 0) hpass_alone<T><<<hb, kLanes, 0, st>>>(a);
        vpass_alone<T><<<vb, kLanes, 0, st>>>(a);
    } else if (variant == 2) {
        if (hb > 0) hpass<T><<<hb, kThreads, 0, st>>>(a);
        vpass_temporal<T><<<vb, kThreads, 0, st>>>(a);
    }
}

}  // namespace

extern "C" {

// hqdn3d_launch's arguments after the variant (1 or 2, above).
int hqdn3d_ablate_launch(int variant, int n, const void* const* src,
                         const void* const* ant, void* const* hbuf,
                         void* const* out, void* const* ant_out,
                         const int* h, const int* w, const float* g_sp,
                         const float* g_tmp, int sample_bytes,
                         float scale_in, float scale_out, int maxval,
                         int device, void* stream) {
    if (variant != 1 && variant != 2) return (int)cudaErrorInvalidValue;
    Args a;
    const int err = plan(n, src, ant, hbuf, out, ant_out, h, w, g_sp, g_tmp,
                         sample_bytes, scale_in, scale_out, maxval, device,
                         &a);
    if (err != (int)cudaSuccess) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (sample_bytes == 1) launch_variant<uint8_t>(variant, a, st);
    else launch_variant<uint16_t>(variant, a, st);
    return (int)cudaGetLastError();
}

}  // extern "C"
