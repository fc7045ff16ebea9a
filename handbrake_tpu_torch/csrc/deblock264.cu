// H.264 in-loop deblock of one frame (spec 8.7) on Hopper.
//
// Replaces handbrake_tpu/codecs/h264/deblock_pallas.py
// build_deblock_pallas: the same function, bit for bit, for both
// with_strong variants.  bS comes from deblock_torch.compute_bs and
// alpha/beta/tc0 from deblock.deblock_scal, as launch arguments.
//
// Design: the normative order (raster MBs; per MB the vertical edges,
// then the horizontal ones) is a slope-2 wavefront: the MBs of one
// anti-diagonal t = x + 2y touch disjoint samples.  One CTA per plane
// (Y, U, V) copies its plane to the output and filters the copy in
// place, looping over the mb_w + 2(mb_h-1) diagonals (254 at 1080p).
// Each diagonal has a vertical phase, one thread per (member MB, row)
// running that row's edges in order, then a horizontal phase, one
// thread per (member MB, column); __syncthreads() closes each phase.
// Up to 68 x 16 luma lines per phase at 1080p, so threads loop.
//
// Bound on an H100 SXM: each plane byte read once and written once,
// 2 x 3,133,440 B = 6.27 MB at 1080p, plus bS read once at the one
// byte its values 0..4 need (261,120 entries), about 1.9 us at 3.35 TB/s.
// The kernel is in fact bound by its 254 dependent diagonal steps:
// latency and barriers on 3 of 132 SMs.  Making it fast (one warp per
// member, shared-memory staging, fewer barriers) is later work.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a into a shared
// library with a plain C interface, loaded by deblock_cuda.py (ctypes).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Params {
    int alpha, beta, tc0[3];
};

__device__ __forceinline__ int clip3(int lo, int hi, int x) {
    return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ int clip1(int x) { return clip3(0, 255, x); }

__device__ __forceinline__ int tc0_of(const Params& p, int bs) {
    return bs <= 1 ? p.tc0[0] : (bs == 2 ? p.tc0[1] : p.tc0[2]);
}

// One luma line across an edge: s points at q0, p samples at negative
// multiples of step.  STRONG=false applies the normal filter for every
// bS > 0 (the analyzer's all-inter variant).
template <bool STRONG>
__device__ __forceinline__ void luma_line(uint8_t* s, int step, int bs,
                                          const Params& p) {
    if (bs <= 0) return;
    const int p3 = s[-4 * step], p2 = s[-3 * step], p1 = s[-2 * step];
    const int p0 = s[-step], q0 = s[0], q1 = s[step], q2 = s[2 * step];
    const int q3 = s[3 * step];
    const int al = p.alpha, bl = p.beta;
    if (!(abs(p0 - q0) < al && abs(p1 - p0) < bl && abs(q1 - q0) < bl))
        return;
    const int ap = abs(p2 - p0), aq = abs(q2 - q0);
    if (!STRONG || bs < 4) {
        const int tc0 = tc0_of(p, bs);
        const int tc = tc0 + (ap < bl) + (aq < bl);
        const int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
        const int avg = (p0 + q0 + 1) >> 1;
        s[-step] = (uint8_t)clip1(p0 + delta);
        s[0] = (uint8_t)clip1(q0 - delta);
        if (ap < bl)
            s[-2 * step] = (uint8_t)(p1 + clip3(-tc0, tc0, (p2 + avg - (p1 << 1)) >> 1));
        if (aq < bl)
            s[step] = (uint8_t)(q1 + clip3(-tc0, tc0, (q2 + avg - (q1 << 1)) >> 1));
        return;
    }
    const bool small = abs(p0 - q0) < ((al >> 2) + 2);
    if (small && ap < bl) {
        s[-step] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
        s[-2 * step] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
        s[-3 * step] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
    } else {
        s[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
    }
    if (small && aq < bl) {
        s[0] = (uint8_t)((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3);
        s[step] = (uint8_t)((q2 + q1 + q0 + p0 + 2) >> 2);
        s[2 * step] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
    } else {
        s[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
    }
}

template <bool STRONG>
__device__ __forceinline__ void chroma_line(uint8_t* s, int step, int bs,
                                            const Params& p) {
    if (bs <= 0) return;
    const int p1 = s[-2 * step], p0 = s[-step], q0 = s[0], q1 = s[step];
    if (!(abs(p0 - q0) < p.alpha && abs(p1 - p0) < p.beta &&
          abs(q1 - q0) < p.beta))
        return;
    if (STRONG && bs == 4) {
        s[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
        s[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
        return;
    }
    const int tc = tc0_of(p, bs) + 1;
    const int delta = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
    s[-step] = (uint8_t)clip1(p0 + delta);
    s[0] = (uint8_t)clip1(q0 - delta);
}

// blockIdx.x: 0 = Y (16x16 MBs, 4 edges), 1 = U, 2 = V (8x8, 2 edges).
// bs_v/bs_h: (mb_h, mb_w, 4 edges, 4 groups) int32.
template <bool STRONG>
__global__ void __launch_bounds__(1024)
deblock264_kernel(const uint8_t* __restrict__ in_y,
                  const uint8_t* __restrict__ in_u,
                  const uint8_t* __restrict__ in_v,
                  uint8_t* out_y, uint8_t* out_u, uint8_t* out_v,
                  const int32_t* __restrict__ bs_v,
                  const int32_t* __restrict__ bs_h,
                  int mb_w, int mb_h, Params lp, Params cp) {
    const int plane = blockIdx.x;
    const bool luma = plane == 0;
    const uint8_t* in = luma ? in_y : (plane == 1 ? in_u : in_v);
    uint8_t* out = luma ? out_y : (plane == 1 ? out_u : out_v);
    const Params& prm = luma ? lp : cp;
    const int bsz = luma ? 16 : 8;
    const int n_edges = luma ? 4 : 2;
    const int eskip = luma ? 1 : 2;     // chroma edges use luma edges 0, 2
    const int gshift = luma ? 2 : 1;    // line → bS group
    const int W = mb_w * bsz;
    const size_t n = (size_t)W * (mb_h * bsz);

    // copy the plane: the kernel filters the copy in place
    if ((((uintptr_t)in | (uintptr_t)out) & 15) == 0 && (n & 15) == 0) {
        const uint4* s4 = reinterpret_cast<const uint4*>(in);
        uint4* d4 = reinterpret_cast<uint4*>(out);
        for (size_t i = threadIdx.x; i < n / 16; i += blockDim.x) d4[i] = s4[i];
    } else {
        for (size_t i = threadIdx.x; i < n; i += blockDim.x) out[i] = in[i];
    }
    __syncthreads();

    const int sk = mb_w + 2 * (mb_h - 1);
    for (int t = 0; t < sk; t++) {
        const int y_lo = max(0, (t - mb_w + 2) >> 1);
        const int y_hi = min(mb_h - 1, t >> 1);
        const int items = (y_hi - y_lo + 1) * bsz;
        // vertical edges: one thread per (member, row)
        for (int i = threadIdx.x; i < items; i += blockDim.x) {
            const int y = y_lo + i / bsz, r = i % bsz;
            const int x = t - 2 * y;
            const int32_t* b = bs_v + (size_t)(y * mb_w + x) * 16 + (r >> gshift);
            uint8_t* row = out + (size_t)(y * bsz + r) * W + x * bsz;
            for (int e = 0; e < n_edges; e++) {
                const int bs = b[4 * e * eskip];
                if (STRONG) {
                    if (luma) luma_line<true>(row + 4 * e, 1, bs, prm);
                    else chroma_line<true>(row + 4 * e, 1, bs, prm);
                } else {
                    if (luma) luma_line<false>(row + 4 * e, 1, bs, prm);
                    else chroma_line<false>(row + 4 * e, 1, bs, prm);
                }
            }
        }
        __syncthreads();
        // horizontal edges: one thread per (member, column)
        for (int i = threadIdx.x; i < items; i += blockDim.x) {
            const int y = y_lo + i / bsz, c = i % bsz;
            const int x = t - 2 * y;
            const int32_t* b = bs_h + (size_t)(y * mb_w + x) * 16 + (c >> gshift);
            uint8_t* col = out + (size_t)(y * bsz) * W + x * bsz + c;
            for (int e = 0; e < n_edges; e++) {
                const int bs = b[4 * e * eskip];
                uint8_t* s = col + (size_t)(4 * e) * W;
                if (STRONG) {
                    if (luma) luma_line<true>(s, W, bs, prm);
                    else chroma_line<true>(s, W, bs, prm);
                } else {
                    if (luma) luma_line<false>(s, W, bs, prm);
                    else chroma_line<false>(s, W, bs, prm);
                }
            }
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" {

// scal: host int32[10] = luma alpha, beta, tc0[3], chroma alpha, beta,
// tc0[3] (deblock.deblock_scal).  Launches on `stream` without
// synchronising; returns cudaGetLastError().
int deblock264_launch(const void* in_y, const void* in_u, const void* in_v,
                      void* out_y, void* out_u, void* out_v,
                      const void* bs_v, const void* bs_h,
                      int mb_w, int mb_h, const int32_t* scal,
                      int with_strong, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Params lp = {scal[0], scal[1], {scal[2], scal[3], scal[4]}};
    Params cp = {scal[5], scal[6], {scal[7], scal[8], scal[9]}};
    const dim3 grid(3), block(1024);
    cudaStream_t s = (cudaStream_t)stream;
    const uint8_t *iy = (const uint8_t*)in_y, *iu = (const uint8_t*)in_u,
                  *iv = (const uint8_t*)in_v;
    uint8_t *oy = (uint8_t*)out_y, *ou = (uint8_t*)out_u, *ov = (uint8_t*)out_v;
    const int32_t *bv = (const int32_t*)bs_v, *bh = (const int32_t*)bs_h;
    if (with_strong)
        deblock264_kernel<true><<<grid, block, 0, s>>>(
            iy, iu, iv, oy, ou, ov, bv, bh, mb_w, mb_h, lp, cp);
    else
        deblock264_kernel<false><<<grid, block, 0, s>>>(
            iy, iu, iv, oy, ou, ov, bv, bh, mb_w, mb_h, lp, cp);
    return (int)cudaGetLastError();
}

}  // extern "C"
