// Separable resample of one plane on Hopper, in one summation order.
//
// Replaces the XLA graph handbrake_tpu/filters/kernels.py _apply_separable
// (:90-96): out = A_v @ img @ A_h^T in f32, round half to even, clip to
// [0, maxval], cast to uint8/uint16, with the (out x in) weight matrices
// of resample_matrix.  Each row of such a matrix is nonzero only on a
// short band (lanczos 2x down: 13 of 3,840 columns), so the kernel takes
// the band of each output sample instead: lo (int32, the band's first
// input index) and T weights (f32, zero where the matrix is zero, tap-
// major), built on the host once per geometry (filters/kernels.py
// resample_band).
//
// Order: XLA:CPU computes the vertical product as a chain of f32 fmas over
// a row's taps in ascending input order, starting from 0; this kernel
// computes both passes that way (band_chain): acc = __fmaf_rn(w[k],
// x[lo + k], acc) for k = 0..T-1.  A zero weight leaves acc as it is
// (0 * x is a signed zero, and adding it changes no nonzero acc and
// leaves +0 at +0), so the zero-padded band gives the chain over the
// nonzero taps.  The file is
// built with --fmad=false and no fast math, so nvcc contracts nothing
// else; the plain version (filters/kernels.py resample_plain, the same
// chain through utils/fp.fma32) gives the same bits on the CPU and on the
// card.
//
// Bounds on an H100 SXM, one 2160p letterbox frame (3840x1608 4:2:0 to
// 1920x804, lanczos): each input sample read once and each output sample
// written once, 11.6 MB, and the nonzero weights: 3.53 us at 3.35 TB/s;
// the taps' multiply-adds, 0.17 GFLOP, 2.5 us at 67 TFLOP/s f32.  So
// bytes bound it.
//
// Design (simple first; wgmma and TMA are later work):
// - vpass: one thread per intermediate sample (o, w), a row of threads
//   along w, so each tap's load is one coalesced row segment and the rows
//   a block reads stay in L1/L2 for its neighbours; the f32 intermediate
//   (out_h x in_w) goes to a scratch plane the wrapper allocates, which
//   stays in L2 for hpass.
// - hpass: one thread per output sample (o, c) over the intermediate's row
//   o, then rintf, clamp and the cast.
// - The taps are tap-major (T x n_out): tap k of output sample o at
//   taps[k * n_out + o], so in hpass neighbouring threads read
//   neighbouring weights; in vpass a block's threads share o.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 71.6 us of
// device time on the frame above, 20x the bound.  Neither loading eight
// taps ahead of their fmas (90.5 us) nor the tap-major weights (row-major:
// 71.4 us) moved it; PERF.md §6 keeps the readings.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 65535;       // gridDim.y

// acc = the fma chain of t[k * t_stride] * v[k * v_stride] over
// k = 0..n-1, from 0, in that order.
template <typename T>
__device__ __forceinline__ float band_chain(const float* __restrict__ t,
                                            size_t t_stride,
                                            const T* __restrict__ v,
                                            size_t v_stride, int n) {
    float acc = 0.0f;
    for (int k = 0; k < n; ++k)
        acc = __fmaf_rn(__ldg(t + k * t_stride), (float)v[k * v_stride],
                        acc);
    return acc;
}

template <typename Tin>
__global__ void __launch_bounds__(kThreads)
vpass(const Tin* __restrict__ x, int in_w, const int* __restrict__ lo,
      const float* __restrict__ taps, int n_taps, int out_h,
      float* __restrict__ mid) {
    const int w = blockIdx.x * kThreads + threadIdx.x;
    const int o = blockIdx.y;
    if (w >= in_w) return;
    mid[(size_t)o * in_w + w] = band_chain(
        taps + o, (size_t)out_h, x + (size_t)__ldg(lo + o) * in_w + w,
        (size_t)in_w, n_taps);
}

template <typename Tout>
__global__ void __launch_bounds__(kThreads)
hpass(const float* __restrict__ mid, int in_w, const int* __restrict__ lo,
      const float* __restrict__ taps, int n_taps, Tout* __restrict__ out,
      int out_w, float maxval) {
    const int c = blockIdx.x * kThreads + threadIdx.x;
    const int o = blockIdx.y;
    if (c >= out_w) return;
    const float acc = band_chain(taps + c, (size_t)out_w,
                                 mid + (size_t)o * in_w + __ldg(lo + c), 1,
                                 n_taps);
    const float r = fminf(fmaxf(rintf(acc), 0.0f), maxval);
    out[(size_t)o * out_w + c] = (Tout)r;
}

template <typename Tin, typename Tout>
void launch(const void* x, int in_w, int out_h, int out_w, const int* lo_v,
            const float* taps_v, int tv, const int* lo_h, const float* taps_h,
            int th, float* mid, void* out, float maxval, cudaStream_t st) {
    const dim3 gv((in_w + kThreads - 1) / kThreads, out_h);
    vpass<Tin><<<gv, kThreads, 0, st>>>(static_cast<const Tin*>(x), in_w,
                                        lo_v, taps_v, tv, out_h, mid);
    const dim3 gh((out_w + kThreads - 1) / kThreads, out_h);
    hpass<Tout><<<gh, kThreads, 0, st>>>(mid, in_w, lo_h, taps_h, th,
                                         static_cast<Tout*>(out), out_w,
                                         maxval);
}

}  // namespace

extern "C" {

// One plane x (in_h x in_w, in_bytes 1 or 2 a sample) to out (out_h x
// out_w, out_bytes 1 or 2): the vertical band (lo_v: out_h int32, taps_v:
// tv x out_h f32) into mid (out_h x in_w f32 scratch), then the
// horizontal band (lo_h: out_w, taps_h: th x out_w).  Every band must lie
// inside its input (lo + T <= n_in), as resample_band builds them.
// Launches vpass, then hpass, on `stream` without synchronising; returns
// the launches' error, or cudaErrorInvalidValue for arguments the kernel
// does not take.
int resample_launch(const void* x, int in_bytes, int in_h, int in_w,
                    const int* lo_v, const float* taps_v, int tv,
                    const int* lo_h, const float* taps_h, int th, float* mid,
                    void* out, int out_bytes, int out_h, int out_w,
                    float maxval, int device, void* stream) {
    if ((in_bytes != 1 && in_bytes != 2) || (out_bytes != 1 && out_bytes != 2)
        || in_h < 1 || in_w < 1 || out_h < 1 || out_h > kMaxRows
        || out_w < 1 || tv < 1 || tv > in_h || th < 1 || th > in_w
        || device < 0)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (in_bytes == 1 && out_bytes == 1)
        launch<uint8_t, uint8_t>(x, in_w, out_h, out_w, lo_v, taps_v, tv,
                                 lo_h, taps_h, th, mid, out, maxval, st);
    else if (in_bytes == 1)
        launch<uint8_t, uint16_t>(x, in_w, out_h, out_w, lo_v, taps_v, tv,
                                  lo_h, taps_h, th, mid, out, maxval, st);
    else if (out_bytes == 1)
        launch<uint16_t, uint8_t>(x, in_w, out_h, out_w, lo_v, taps_v, tv,
                                  lo_h, taps_h, th, mid, out, maxval, st);
    else
        launch<uint16_t, uint16_t>(x, in_w, out_h, out_w, lo_v, taps_v, tv,
                                   lo_h, taps_h, th, mid, out, maxval, st);
    return (int)cudaGetLastError();
}

}  // extern "C"
