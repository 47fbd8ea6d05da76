// K3: the fused inference temporal step of SVGF, and K4-K6: the
// differentiable reprojection of the training step and its adjoints.
//
// Replaces the TPU kernel raymarchdenoisercuda_tpu/ops/pallas/temporal_tpu.py
// _make_kernel as called by temporal_accumulate_pallas.  Its plain twin is
// temporal_accumulate in ops/temporal.py; the arithmetic below follows that
// function operation by operation (built with --fmad=false; the one fused
// multiply-add, in the reprojection sum, is explicit on both sides).
//
// Per pixel:
//   1. bounded-motion bilinear reprojection of the 10 history planes
//      (colour 3, moments 2, length, previous depth, previous normal 3):
//      |m0| or |m1| > max_motion counts as disocclusion; taps outside the
//      image read zero;
//   2. validity (in bounds, depth within 10 %, n.n_prev > 0.8, length > 0);
//   3. clamp of the history colour to the 3x3 min/max of the current frame
//      (taps beyond the border dropped), EMA blend with
//      alpha = max(alpha_min, 1/n);
//   4. moments, and the 7x7 spatial-variance fallback while the new length
//      is below variance_boost_frames (skipped when that is 0).
// The TPU kernel's per-band offset ranges and lane rolls exist because a TPU
// has no cheap gather; here each thread gathers its own four taps.
//
// Bound on the card: memory, 104 B a pixel (render, motion, depth, normal
// and the 10 history planes read once, 7 planes written).  Read through
// the caches pixel by pixel, the 3x3 clamp takes 27 render values and the
// 7x7 window 147 values and 49 lumas, each column sum recomputed by 7
// neighbouring pixels (0.24 ms against the bound's 0.064 at 1080p).  So a
// block of 32 x 8 threads stages its tile's render with a 3-pixel halo in
// shared memory (cp.async, in flight while the threads gather their
// history; plain loads ran 1.07x slower on a served frame's inputs and
// K3b's tiles, 0.9x on small random motion), the clamp reads it there,
// and only a block with a short pixel (__syncthreads_or) takes each
// staged pixel's luma and each 7-row column sum once; the short pixels add
// seven column sums (temporal_kernel).  The tent gather stays in the
// caches: staging the history window too ((32 + 13) x (8 + 13) pixels of
// 10 planes, 37.8 KB a block) took 0.73x the time on uniform random
// motion but 1.33x on a served frame's inputs, whose motion is coherent,
// and was dropped.
//
// K4 replaces temporal_tpu.py _make_gather_kernel (wrapper _gather_call):
// the same bounded tent gather as K3's step 1, alone, for the 10-plane
// history stack, so that the rest of the step can run in PyTorch, where
// autograd differentiates it.  Plain twin: gather_ref in ops/temporal.py.
// The TPU kernel loops over every integer offset that the band's motion
// brackets; here each thread reads only its own <= 4 taps.  Bound: memory,
// 88 B/px (40 in, 8 motion, 40 out).
//
// K5 and K6 replace _make_gather_bwd_kernel (_gather_bwd_call) and
// _make_gather_bwd_hist_kernel (_gather_bwd_hist_call): one kernel here,
// the motion term behind a flag.  Plain twin: gather_bwd_ref.
//   d_hist: the TPU kernel restructures the transposed tent scatter as a
//   gather over every offset the band brackets (up to (2M+2)^2 candidates).
//   Here each source pixel scatters its tent-weighted cotangent into its
//   <= 4 taps with atomicAdd, into an output the wrapper zeroed: 4 targets
//   instead of 196 candidates, at the price of a summation order that is
//   not fixed (at most 4 addends a target, so the results differ from the
//   twin's by rounding only).  Only the leading grad_planes planes are
//   written; the rest stay zero.
//   d_motion (K5): a gather at the pixel itself over the offsets
//   floor(m)-1 .. floor(m)+1 inside [-M, M+1]; at integer motion the tent
//   derivative (JAX's kink convention: -sign with sign(0) = +1, half weight
//   at |x| = 1) is nonzero on all three, which is why the TPU kernel keeps
//   floor+1 upper bounds.
// Bound: memory; K6 reads 6 cotangent planes and the motion and writes the
// 10-plane d_hist (72 B/px); K5 also reads 6 history planes and writes
// d_motion (104 B/px).
//
// Tiles (the sharded pipeline, parallel/sharded.py).  Each kernel computes
// the H x W centre of a tile whose pixel (0, 0) is the global pixel
// (gy0, gx0) of an Hg x Wg frame, and tests every tap, and the reprojected
// position, against the frame in global coordinates, so a tile gives what
// the whole frame gives at its pixels.  The history planes come as a
// canvas: the tile plus a margin of h_m >= max_motion + 1 pixels on every
// side (row stride h_rs, plane stride h_ps), which the halo exchange has
// filled from the neighbouring tiles; K3 reads the render the same way
// (margin r_m >= 3, for the 3x3 clamp and the 7x7 window).  Motion, depth,
// normal, cotangents and outputs are contiguous H x W planes, except K5's
// and K6's d_hist, which covers the history canvas, margins included: the
// gradients of the margins go back to the tiles that own them through the
// exchange's adjoint.  These are the canvas forms of the TPU package: K3b
// (temporal_accumulate_canvas_pallas), K4c (_gather_canvas_call) and
// K5c/K6c (_gather_canvas_bwd_call).  The tile comes as a TemporalTile
// passed beside the other parameters; a null pointer is the whole frame,
// which runs the kernels' TILE = false instantiation: it indexes and
// masks as if there were no tile, with the parameters it had before tiles
// existed, and computes what it computed then, operation by operation.
//
// The clamped gather and its adjoint (no TPU kernel: with
// SVGFParams.max_motion = None the JAX package runs its jnp step,
// raymarchdenoisercuda_tpu/ops/temporal.py bilinear_gather_many, beside the
// Pallas sweep).  clamped_gather_kernel is the unbounded reprojection of
// the P history planes: one thread a pixel samples p + motion bilinearly
// with its four taps clamped to the image (floor, clamp, and the sums as
// fused multiply-adds, as the plain twin bilinear_gather_clamped in
// ops/temporal.py rounds them).  clamped_gather_bwd_kernel is its adjoint:
// each pixel scatters its bilinear-weighted cotangent into its four
// clamped taps (coinciding clamped taps add up), and takes the motion
// cotangent from the derivative of the bilinear weights, sum over planes
// of g.(d out/d fy, d out/d fx).  A texel at the border takes the taps of
// every pixel whose motion clamps there, hundreds of addends, so a float
// sum in the atomics' order changes from run to run; the scatter adds the
// float products into a float64 scratch instead (atomicAdd on double is
// native on sm_90), where the order moves the sum by ~1e-16 of it, and
// round_planes_kernel rounds it once to float32 (and zeroes the planes
// beyond the scattered ones): two runs agree to within that one
// rounding.  Bound: memory, 88 B/px forward (10 planes and the motion in,
// 10 out) and 88 B/px backward at 6 planes with both gradients (motion, 6
// cotangent and 6 history planes in; 6 history gradients and the
// motion's out), plus the scratch: 48 B/px zeroed, scattered and read
// back.

#include <cuda_runtime.h>
#include <math.h>

// Launch parameters, passed by pointer from ops/temporal_cuda.py (ctypes).
struct TemporalParams {
    int H, W, max_motion, history_clamp, boost_frames;
    float alpha, alpha_m;
};

// The tile of a launch of K3 or K4-K6 (the render canvas is K3's only).
struct TemporalTile {
    int Hg, Wg, gy0, gx0;
    int h_rs, h_ps, h_m;    // history canvas (and K5/K6's d_hist)
    int r_rs, r_ps, r_m;    // render canvas
};

namespace {

constexpr float kL0 = 0.2126f, kL1 = 0.7152f, kL2 = 0.0722f;

// The frame's bounds and the tile's origin, and the index of tile pixel
// (y, x) (centre coordinates, negative in the margin) in the history and
// render canvases, with their plane strides, for a tile of H x W; TILE =
// false: the whole frame, contiguous planes.
template <bool TILE>
__device__ __forceinline__ int bound_h(const TemporalTile& t, int H) {
    return TILE ? t.Hg : H;
}
template <bool TILE>
__device__ __forceinline__ int bound_w(const TemporalTile& t, int W) {
    return TILE ? t.Wg : W;
}
template <bool TILE>
__device__ __forceinline__ int origin_y(const TemporalTile& t) {
    return TILE ? t.gy0 : 0;
}
template <bool TILE>
__device__ __forceinline__ int origin_x(const TemporalTile& t) {
    return TILE ? t.gx0 : 0;
}
template <bool TILE>
__device__ __forceinline__ int hidx(const TemporalTile& t, int W, int y,
                                    int x) {
    return TILE ? (y + t.h_m) * t.h_rs + (x + t.h_m) : y * W + x;
}
template <bool TILE>
__device__ __forceinline__ int ridx(const TemporalTile& t, int W, int y,
                                    int x) {
    return TILE ? (y + t.r_m) * t.r_rs + (x + t.r_m) : y * W + x;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src));
}

// K3's block: 32 x 8 threads, each computing PX pixels 32 columns apart
// (a (32 PX) x 8 output tile); its render is staged with a 3-pixel halo,
// the reach of the 7x7 window.  The launches take one pixel a thread: two
// ran 1.14-1.19x faster on uniform random motion but 0.92x on a served
// frame's inputs (H100, 1080p).  The same body written for one pixel
// without the loop over PX compiled to code of the same length, scheduled
// otherwise, and ran 1.05-1.2x slower.
constexpr int K3_TX = 32, K3_TY = 8, K3_HALO = 3;
constexpr int K3_PX = 1;

template <int PX>
struct K3Tile {
    static constexpr int TW = K3_TX * PX;
    static constexpr int SW = TW + 2 * K3_HALO, SH = K3_TY + 2 * K3_HALO;
    float c[3][SH][SW];     // the render (zero where not read)
    float l[SH][SW];        // its luma (zero outside the frame)
    float s1[K3_TY][SW];    // 7-row column sums of luma and luma^2 at
    float s2[K3_TY][SW];    // each output row (zero outside the frame)
};

// K3/K3b (see the header): the render tile is staged by cp.async while
// each thread gathers its pixels' history through the caches; the 3x3
// clamp then reads the staged render, and a block any of whose pixels
// needs the 7x7 variance boost computes each staged pixel's luma once
// and each (output row, staged column) 7-row sum once, which its short
// pixels add up: the floats of the per-pixel loops, in their order (rows
// 0, +1, -1, +2, -2, +3, -3 of a column, with + 0.0f for a row outside
// the frame; columns x, x+1, x-1, ..., x-3, a column outside the frame
// adding 0).  Threads outside the tile stay through every barrier.
template <bool TILE, int PX>
__global__ void __launch_bounds__(K3_TX * K3_TY)
temporal_kernel(const float* __restrict__ render,
                const float* __restrict__ motion,
                const float* __restrict__ depth,
                const float* __restrict__ normal,
                const float* __restrict__ h_color,
                const float* __restrict__ h_moments,
                const float* __restrict__ h_length,
                const float* __restrict__ h_depth,
                const float* __restrict__ h_normal,
                float* __restrict__ out_integ,
                float* __restrict__ out_var,
                float* __restrict__ out_moments,
                float* __restrict__ out_length,
                TemporalParams p, TemporalTile t) {
    using Tl = K3Tile<PX>;
    __shared__ Tl sm;
    const int H = p.H, W = p.W, hw = H * W;
    const int Hg = bound_h<TILE>(t, H), Wg = bound_w<TILE>(t, W);
    const int oy = origin_y<TILE>(t), ox = origin_x<TILE>(t);
    const int bx0 = blockIdx.x * Tl::TW, by0 = blockIdx.y * K3_TY;
    const int tid = threadIdx.y * K3_TX + threadIdx.x;
    const int rps = TILE ? t.r_ps : hw;

    // the render tile and its halo, where it lies in the frame (and, for
    // a tile, in the render canvas: only threads outside the tile reach
    // past its margin)
    for (int e = tid; e < Tl::SH * Tl::SW; e += K3_TX * K3_TY) {
        const int sy = e / Tl::SW, sx = e - sy * Tl::SW;
        const int ry = by0 + sy - K3_HALO, rx = bx0 + sx - K3_HALO;
        bool in = oy + ry >= 0 && oy + ry < Hg && ox + rx >= 0
            && ox + rx < Wg;
        if (TILE) {
            in = in && ry >= -t.r_m && ry < H + t.r_m && rx >= -t.r_m
                && rx < W + t.r_m;
        }
        if (in) {
            const int q = ridx<TILE>(t, W, ry, rx);
            cp_async4(&sm.c[0][sy][sx], render + q);
            cp_async4(&sm.c[1][sy][sx], render + rps + q);
            cp_async4(&sm.c[2][sy][sx], render + 2 * rps + q);
        } else {
            sm.c[0][sy][sx] = 0.0f;
            sm.c[1][sy][sx] = 0.0f;
            sm.c[2][sy][sx] = 0.0f;
        }
    }

    // 1. reprojection: history planes in the order colour, moments, length,
    //    previous depth, previous normal
    const int hps = TILE ? t.h_ps : hw;
    const float* planes[10] = {h_color, h_color + hps, h_color + 2 * hps,
                               h_moments, h_moments + hps, h_length, h_depth,
                               h_normal, h_normal + hps, h_normal + 2 * hps};
    const int y = by0 + threadIdx.y, gy = oy + y;
    bool live[PX], in_bounds[PX];
    float g[PX][10];
#pragma unroll
    for (int k = 0; k < PX; ++k) {
        const int x = bx0 + threadIdx.x + K3_TX * k, gx = ox + x;
        live[k] = x < W && y < H;
        in_bounds[k] = false;
#pragma unroll
        for (int j = 0; j < 10; ++j) g[k][j] = 0.0f;
        if (!live[k]) continue;
        const int i = y * W + x;
        const float m0 = motion[i], m1 = motion[hw + i];
        const float ys = (float)gy + m0, xs = (float)gx + m1;
        const bool within = fabsf(m0) <= (float)p.max_motion
            && fabsf(m1) <= (float)p.max_motion;
        in_bounds[k] = ys >= 0.0f && ys <= (float)(Hg - 1)
            && xs >= 0.0f && xs <= (float)(Wg - 1) && within;
        if (!within) continue;
        const float y0 = floorf(m0), x0 = floorf(m1);
        for (int ay = 0; ay <= 1; ++ay) {
            const float dyf = y0 + (float)ay;
            const float ty = fmaxf(1.0f - fabsf(m0 - dyf), 0.0f);
            const int ry = y + (int)dyf;
            for (int ax = 0; ax <= 1; ++ax) {
                const float dxf = x0 + (float)ax;
                const float tx = fmaxf(1.0f - fabsf(m1 - dxf), 0.0f);
                const int rx = x + (int)dxf;
                const bool inside = gy + (int)dyf >= 0 && gy + (int)dyf < Hg
                    && gx + (int)dxf >= 0 && gx + (int)dxf < Wg;
                const float w = ty * tx;
                const int q = hidx<TILE>(t, W, ry, rx);
                // explicit fused multiply-adds, as the plain version rounds
#pragma unroll
                for (int j = 0; j < 10; ++j) {
                    g[k][j] = __fmaf_rn(w, inside ? planes[j][q] : 0.0f,
                                        g[k][j]);
                }
            }
        }
    }
    // a thread's own copies are visible to it once they complete, the
    // others' after the barrier
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // 2.-4. validity, clamp + blend, moments and variance
    float var[PX];
    bool short_px[PX], any_short = false;
#pragma unroll
    for (int k = 0; k < PX; ++k) {
        short_px[k] = false;
        var[k] = 0.0f;
        if (!live[k]) continue;
        const int lx = threadIdx.x + K3_TX * k + K3_HALO;
        const int ly = threadIdx.y + K3_HALO;
        const int x = bx0 + threadIdx.x + K3_TX * k, gx = ox + x;
        const int i = y * W + x;
        const float pm0 = g[k][3], pm1 = g[k][4], plen = g[k][5];
        const float pdepth = g[k][6];
        const float z = depth[i];
        const float n0 = normal[i], n1 = normal[hw + i],
                    n2 = normal[2 * hw + i];
        const bool depth_ok =
            fabsf(pdepth - z) <= 0.1f * fmaxf(fabsf(z), 1e-3f);
        const float ndot = g[k][7] * n0 + g[k][8] * n1 + g[k][9] * n2;
        const bool valid =
            in_bounds[k] && depth_ok && ndot > 0.8f && plen > 0.0f;

        const float c[3] = {sm.c[0][ly][lx], sm.c[1][ly][lx],
                            sm.c[2][ly][lx]};
        float prev[3] = {g[k][0], g[k][1], g[k][2]};
        if (p.history_clamp) {
            for (int ch = 0; ch < 3; ++ch) {
                float lo = INFINITY, hi = -INFINITY;
                for (int dy = -1; dy <= 1; ++dy) {
                    if (gy + dy < 0 || gy + dy >= Hg) continue;
                    for (int dx = -1; dx <= 1; ++dx) {
                        if (gx + dx < 0 || gx + dx >= Wg) continue;
                        const float v = sm.c[ch][ly + dy][lx + dx];
                        lo = fminf(lo, v);
                        hi = fmaxf(hi, v);
                    }
                }
                prev[ch] = fminf(fmaxf(prev[ch], lo), hi);
            }
        }
        const float n_new = (valid ? plen : 0.0f) + 1.0f;
        const float alpha = fmaxf(1.0f / n_new, p.alpha);
        const float alpha_m = fmaxf(1.0f / n_new, p.alpha_m);
        for (int ch = 0; ch < 3; ++ch) {
            out_integ[ch * hw + i] = valid
                ? (1.0f - alpha) * prev[ch] + alpha * c[ch] : c[ch];
        }
        const float lum = kL0 * c[0] + kL1 * c[1] + kL2 * c[2];
        const float lum2 = lum * lum;
        const float mom0 =
            valid ? (1.0f - alpha_m) * pm0 + alpha_m * lum : lum;
        const float mom1 =
            valid ? (1.0f - alpha_m) * pm1 + alpha_m * lum2 : lum2;
        var[k] = fmaxf(mom1 - mom0 * mom0, 0.0f);
        out_moments[i] = mom0;
        out_moments[hw + i] = mom1;
        out_length[i] = n_new;
        short_px[k] = p.boost_frames > 0 && n_new < (float)p.boost_frames;
        any_short = any_short || short_px[k];
    }

    // the 7x7 variance boost, where the new history is short
    if (__syncthreads_or(any_short)) {
        for (int e = tid; e < Tl::SH * Tl::SW; e += K3_TX * K3_TY) {
            const int sy = e / Tl::SW, sx = e - sy * Tl::SW;
            sm.l[sy][sx] = kL0 * sm.c[0][sy][sx] + kL1 * sm.c[1][sy][sx]
                + kL2 * sm.c[2][sy][sx];
        }
        __syncthreads();
        for (int e = tid; e < K3_TY * Tl::SW; e += K3_TX * K3_TY) {
            const int r = e / Tl::SW, sx = e - r * Tl::SW;
            const int gqx = ox + bx0 + sx - K3_HALO;
            float a1 = 0.0f, a2 = 0.0f;
            if (gqx >= 0 && gqx < Wg) {
                const int sy = r + K3_HALO;
                a1 = sm.l[sy][sx];
                a2 = a1 * a1;
                for (int d = 1; d <= K3_HALO; ++d) {
                    // rows outside the frame hold a luma of 0
                    const float lp = sm.l[sy + d][sx], lm = sm.l[sy - d][sx];
                    a1 = (a1 + lp) + lm;
                    a2 = (a2 + lp * lp) + lm * lm;
                }
            }
            sm.s1[r][sx] = a1;
            sm.s2[r][sx] = a2;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < PX; ++k) {
            if (!short_px[k]) continue;
            const int r = threadIdx.y, sx = threadIdx.x + K3_TX * k + K3_HALO;
            const int gx = ox + bx0 + threadIdx.x + K3_TX * k;
            float s1 = sm.s1[r][sx], s2 = sm.s2[r][sx];
            for (int d = 1; d <= K3_HALO; ++d) {
                s1 = s1 + sm.s1[r][sx + d];
                s2 = s2 + sm.s2[r][sx + d];
                s1 = s1 + sm.s1[r][sx - d];
                s2 = s2 + sm.s2[r][sx - d];
            }
            const float fy = (float)gy, fx = (float)gx;
            const float cy = fminf(fy, 3.0f)
                + fminf((float)(Hg - 1) - fy, 3.0f) + 1.0f;
            const float cx = fminf(fx, 3.0f)
                + fminf((float)(Wg - 1) - fx, 3.0f) + 1.0f;
            const float inv_cnt = 1.0f / (cy * cx);
            const float sm1 = s1 * inv_cnt, sm2 = s2 * inv_cnt;
            var[k] = fmaxf(sm2 - sm1 * sm1, 0.0f);
        }
    }
#pragma unroll
    for (int k = 0; k < PX; ++k) {
        if (live[k]) out_var[y * W + bx0 + threadIdx.x + K3_TX * k] = var[k];
    }
}


// K4: bounded tent gather of the 10-plane stack (see the header).
// Whether the tap at offset (dy, dx) of tile pixel (y, x) lies in the
// frame.
template <bool TILE>
__device__ __forceinline__ bool tap_inside(const TemporalTile& t, int H,
                                           int W, int y, int x, int dy,
                                           int dx) {
    const int gy = origin_y<TILE>(t) + y + dy;
    const int gx = origin_x<TILE>(t) + x + dx;
    return gy >= 0 && gy < bound_h<TILE>(t, H) && gx >= 0
        && gx < bound_w<TILE>(t, W);
}

template <bool TILE>
__global__ void gather_kernel(const float* __restrict__ stack,
                              const float* __restrict__ motion,
                              float* __restrict__ out, int H, int W, int M,
                              TemporalTile t) {
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= W || y >= H) return;
    const int hw = H * W, i = y * W + x, hps = TILE ? t.h_ps : hw;
    const float m0 = motion[i], m1 = motion[hw + i];
    float g[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) g[k] = 0.0f;
    if (fabsf(m0) <= (float)M && fabsf(m1) <= (float)M) {
        const float y0 = floorf(m0), x0 = floorf(m1);
        for (int ay = 0; ay <= 1; ++ay) {
            const float dyf = y0 + (float)ay;
            const float ty = fmaxf(1.0f - fabsf(m0 - dyf), 0.0f);
            const int ry = y + (int)dyf;
            for (int ax = 0; ax <= 1; ++ax) {
                const float dxf = x0 + (float)ax;
                const float tx = fmaxf(1.0f - fabsf(m1 - dxf), 0.0f);
                const int rx = x + (int)dxf;
                const bool inside = tap_inside<TILE>(t, H, W, y, x, (int)dyf, (int)dxf);
                const float w = ty * tx;
                const int q = hidx<TILE>(t, W, ry, rx);
#pragma unroll
                for (int k = 0; k < 10; ++k) {
                    g[k] = __fmaf_rn(w, inside ? stack[k * hps + q] : 0.0f, g[k]);
                }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < 10; ++k) out[k * hw + i] = g[k];
}

// d/dx max(0, 1 - |x|) with JAX's kink convention (ops.common.tent_prime).
__device__ __forceinline__ float tent_prime(float x) {
    const float a = fabsf(x);
    const float sgn = x >= 0.0f ? 1.0f : -1.0f;
    const float w = a < 1.0f ? 1.0f : (a == 1.0f ? 0.5f : 0.0f);
    return -sgn * w;
}

__device__ __forceinline__ float tent(float x) {
    return fmaxf(1.0f - fabsf(x), 0.0f);
}

// K5 (motion_grad = 1) / K6 (motion_grad = 0): adjoint of K4 (see the
// header).  dh must be zeroed; hist may be null when motion_grad is 0.
template <bool TILE>
__global__ void gather_bwd_kernel(const float* __restrict__ hist,
                                  const float* __restrict__ motion,
                                  const float* __restrict__ g,
                                  float* __restrict__ dh,
                                  float* __restrict__ dm, int H, int W,
                                  int M, int np, int motion_grad,
                                  TemporalTile t) {
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= W || y >= H) return;
    const int hw = H * W, i = y * W + x, hps = TILE ? t.h_ps : hw;
    const float m0 = motion[i], m1 = motion[hw + i];
    const bool within = fabsf(m0) <= (float)M && fabsf(m1) <= (float)M;
    if (!within) {
        if (motion_grad) {
            dm[i] = 0.0f;
            dm[hw + i] = 0.0f;
        }
        return;
    }
    const float y0 = floorf(m0), x0 = floorf(m1);
    for (int ay = 0; ay <= 1; ++ay) {
        const float dyf = y0 + (float)ay;
        const float ty = tent(m0 - dyf);
        const int ry = y + (int)dyf;
        for (int ax = 0; ax <= 1; ++ax) {
            const float dxf = x0 + (float)ax;
            const float tx = tent(m1 - dxf);
            const int rx = x + (int)dxf;
            if (!tap_inside<TILE>(t, H, W, y, x, (int)dyf, (int)dxf)) continue;
            const float w = ty * tx;
            const int q = hidx<TILE>(t, W, ry, rx);
            for (int c = 0; c < np; ++c) {
                atomicAdd(&dh[c * hps + q], w * g[c * hw + i]);
            }
        }
    }
    if (!motion_grad) return;
    float dm0 = 0.0f, dm1 = 0.0f;
    for (int ay = -1; ay <= 1; ++ay) {
        const float dyf = y0 + (float)ay;
        const float ty = tent(m0 - dyf), typ = tent_prime(m0 - dyf);
        const int ry = y + (int)dyf;
        const bool row_ok = dyf >= (float)-M && dyf <= (float)(M + 1);
        for (int ax = -1; ax <= 1; ++ax) {
            const float dxf = x0 + (float)ax;
            const float tx = tent(m1 - dxf), txp = tent_prime(m1 - dxf);
            const int rx = x + (int)dxf;
            const bool ok = row_ok && dxf >= (float)-M && dxf <= (float)(M + 1)
                && tap_inside<TILE>(t, H, W, y, x, (int)dyf, (int)dxf);
            const int q = hidx<TILE>(t, W, ry, rx);
            float gdot = 0.0f;
            for (int c = 0; c < np; ++c) {
                gdot = gdot + g[c * hw + i] * (ok ? hist[c * hps + q] : 0.0f);
            }
            dm0 = dm0 + (typ * tx) * gdot;
            dm1 = dm1 + (ty * txp) * gdot;
        }
    }
    dm[i] = dm0;
    dm[hw + i] = dm1;
}

// The clamped gather's tap geometry at pixel (y, x) of an H x W frame:
// the four clamped tap indices and the bilinear fractions.
struct ClampedTaps {
    int i00, i01, i10, i11;
    float fy, fx;
};

__device__ __forceinline__ ClampedTaps clamped_taps(const float* motion,
                                                    int H, int W, int y,
                                                    int x) {
    const int hw = H * W, i = y * W + x;
    const float ys = (float)y + motion[i], xs = (float)x + motion[hw + i];
    const float y0 = floorf(ys), x0 = floorf(xs);
    ClampedTaps c;
    c.fy = ys - y0;
    c.fx = xs - x0;
    // floor is integral: clamping in float, then converting, is the
    // twin's clamp of the converted index
    const int y0i = (int)fminf(fmaxf(y0, 0.0f), (float)(H - 1));
    const int x0i = (int)fminf(fmaxf(x0, 0.0f), (float)(W - 1));
    const int y1i = min(y0i + 1, H - 1), x1i = min(x0i + 1, W - 1);
    c.i00 = y0i * W + x0i;
    c.i01 = y0i * W + x1i;
    c.i10 = y1i * W + x0i;
    c.i11 = y1i * W + x1i;
    return c;
}

__global__ void clamped_gather_kernel(const float* __restrict__ stack,
                                      const float* __restrict__ motion,
                                      float* __restrict__ out, int H, int W,
                                      int P) {
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= W || y >= H) return;
    const int hw = H * W, i = y * W + x;
    const ClampedTaps c = clamped_taps(motion, H, W, y, x);
    const float gx = 1.0f - c.fx, gy = 1.0f - c.fy;
    for (int k = 0; k < P; ++k) {
        const float* a = stack + k * hw;
        const float top = __fmaf_rn(a[c.i00], gx, a[c.i01] * c.fx);
        const float bot = __fmaf_rn(a[c.i10], gx, a[c.i11] * c.fx);
        out[k * hw + i] = __fmaf_rn(top, gy, bot * c.fy);
    }
}

// scratch (zeroed, np float64 planes; may be null: no history gradient)
// gets the leading np planes' scatter; d_motion (may be null) the motion
// cotangent over them.
__global__ void clamped_gather_bwd_kernel(const float* __restrict__ stack,
                                          const float* __restrict__ motion,
                                          const float* __restrict__ g,
                                          double* __restrict__ scratch,
                                          float* __restrict__ d_motion,
                                          int H, int W, int np) {
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= W || y >= H) return;
    const int hw = H * W, i = y * W + x;
    const ClampedTaps c = clamped_taps(motion, H, W, y, x);
    const float gx = 1.0f - c.fx, gy = 1.0f - c.fy;
    float dfy = 0.0f, dfx = 0.0f;
    for (int k = 0; k < np; ++k) {
        const float gk = g[k * hw + i];
        if (scratch) {
            double* d = scratch + k * hw;
            atomicAdd(&d[c.i00], (double)(gk * (gy * gx)));
            atomicAdd(&d[c.i01], (double)(gk * (gy * c.fx)));
            atomicAdd(&d[c.i10], (double)(gk * (c.fy * gx)));
            atomicAdd(&d[c.i11], (double)(gk * (c.fy * c.fx)));
        }
        if (d_motion) {
            const float* a = stack + k * hw;
            const float a00 = a[c.i00], a01 = a[c.i01], a10 = a[c.i10],
                        a11 = a[c.i11];
            const float top = __fmaf_rn(a00, gx, a01 * c.fx);
            const float bot = __fmaf_rn(a10, gx, a11 * c.fx);
            dfy = dfy + gk * (bot - top);
            dfx = dfx + gk * (gy * (a01 - a00) + c.fy * (a11 - a10));
        }
    }
    if (d_motion) {
        d_motion[i] = dfy;
        d_motion[hw + i] = dfx;
    }
}

// d_stack's P planes of n elements: the first np rounded once from the
// float64 scratch, the rest zero.
__global__ void round_planes_kernel(const double* __restrict__ scratch,
                                    float* __restrict__ d_stack, int n,
                                    int np, int P) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    for (int k = 0; k < P; ++k)
        d_stack[k * n + e] = k < np ? (float)scratch[k * n + e] : 0.0f;
}

}  // namespace

// The clamped gather of P planes, and its adjoint (see the header).
extern "C" int rdt_clamped_gather(const float* stack, const float* motion,
                                  float* out, int H, int W, int P,
                                  void* stream) {
    dim3 block(32, 8);
    dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
    clamped_gather_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        stack, motion, out, H, W, P);
    return (int)cudaGetLastError();
}

// d_stack (P planes; may be null) needs scratch, grad_planes zeroed
// float64 planes.
extern "C" int rdt_clamped_gather_bwd(const float* stack, const float* motion,
                                      const float* g, float* d_stack,
                                      double* scratch, float* d_motion,
                                      int H, int W, int grad_planes, int P,
                                      void* stream) {
    dim3 block(32, 8);
    dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
    const cudaStream_t s = (cudaStream_t)stream;
    if (d_stack && !scratch) return (int)cudaErrorInvalidValue;
    clamped_gather_bwd_kernel<<<grid, block, 0, s>>>(
        stack, motion, g, d_stack ? scratch : nullptr, d_motion, H, W,
        grad_planes);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || !d_stack) return (int)err;
    const int n = H * W;
    round_planes_kernel<<<(n + 255) / 256, 256, 0, s>>>(scratch, d_stack, n,
                                                       grad_planes, P);
    return (int)cudaGetLastError();
}

// K3, K3b.
extern "C" int rdt_temporal(const float* render, const float* motion,
                            const float* depth, const float* normal,
                            const float* h_color, const float* h_moments,
                            const float* h_length, const float* h_depth,
                            const float* h_normal, float* out_integ,
                            float* out_var, float* out_moments,
                            float* out_length, const TemporalParams* params,
                            const TemporalTile* tile, void* stream) {
    constexpr int PX = K3_PX;
    const dim3 block(K3_TX, K3_TY);
    const dim3 grid((params->W + K3Tile<PX>::TW - 1) / K3Tile<PX>::TW,
                    (params->H + K3_TY - 1) / K3_TY);
    cudaStream_t s = (cudaStream_t)stream;
    const TemporalTile t = tile ? *tile : TemporalTile{};
#define RDT_TEMPORAL(T)                                                   \
    temporal_kernel<T, PX><<<grid, block, 0, s>>>(                        \
        render, motion, depth, normal, h_color, h_moments, h_length,      \
        h_depth, h_normal, out_integ, out_var, out_moments, out_length,   \
        *params, t)
    if (tile) RDT_TEMPORAL(true); else RDT_TEMPORAL(false);
#undef RDT_TEMPORAL
    return (int)cudaGetLastError();
}

// K4, K4c (tile given).
extern "C" int rdt_gather(const float* stack, const float* motion, float* out,
                          int H, int W, int max_motion,
                          const TemporalTile* tile, void* stream) {
    dim3 block(32, 8);
    dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
    cudaStream_t s = (cudaStream_t)stream;
    const TemporalTile t = tile ? *tile : TemporalTile{};
    if (tile) {
        gather_kernel<true><<<grid, block, 0, s>>>(stack, motion, out, H, W,
                                                   max_motion, t);
    } else {
        gather_kernel<false><<<grid, block, 0, s>>>(stack, motion, out, H, W,
                                                    max_motion, t);
    }
    return (int)cudaGetLastError();
}

// K5/K6, K5c/K6c (tile given); dh (the history canvas's shape) must be
// zeroed.
extern "C" int rdt_gather_bwd(const float* hist, const float* motion,
                              const float* g, float* dh, float* dm, int H,
                              int W, int max_motion, int grad_planes,
                              int motion_grad, const TemporalTile* tile,
                              void* stream) {
    dim3 block(32, 8);
    dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
    cudaStream_t s = (cudaStream_t)stream;
    const TemporalTile t = tile ? *tile : TemporalTile{};
    if (tile) {
        gather_bwd_kernel<true><<<grid, block, 0, s>>>(
            hist, motion, g, dh, dm, H, W, max_motion, grad_planes,
            motion_grad, t);
    } else {
        gather_bwd_kernel<false><<<grid, block, 0, s>>>(
            hist, motion, g, dh, dm, H, W, max_motion, grad_planes,
            motion_grad, t);
    }
    return (int)cudaGetLastError();
}
