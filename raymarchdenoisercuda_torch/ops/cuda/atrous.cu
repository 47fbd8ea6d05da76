// The edge-aware à-trous SVGF filter, one level at a time: the forward (K1,
// K1b) and its three adjoints (K2/K2b from stored weights, K14 with the
// weights recomputed, K9 through the weights).
//
// K1 replaces the TPU kernel raymarchdenoisercuda_tpu/ops/pallas/atrous_tpu.py
// _make_level_kernel(mode="fwd", fuse_isd=True) as driven by
// atrous_level_fwd_canvas / _svgf_chained_fwd: with bwd_impl="none"
// (inference, no weight writes), "stored" (bf16 weight store) or
// "stored_f32" (float weight store).  K1b, the same kernel body with the
// sigma denominator read from an input instead of the fused blur, replaces
// atrous_level_fwd_pallas (the per-level forward of the recompute and
// weight-gradient paths); it always writes N.  Their plain twin is
// atrous_level_ref in ops/atrous.py; the arithmetic follows that function
// operation by operation (the library is built with --fmad=false, so no
// multiply-add is contracted), which keeps the kernel within float
// rounding of the twin.
//
// One thread per output pixel.  The TPU kernel's row bands, 128-lane
// canvases, manual DMA and lane rolls do not carry over: a thread reads its
// (2r+1)^2 taps at spacing 2^level straight from global memory with bounds
// checks, and a tap outside the image is dropped (zero weight), which is
// what the TPU kernel's border mask achieves.  The 3x3 variance blur that
// sets the luminance sigma is fused in, as on the TPU, unless a sigma
// denominator is given (K1b).
//
// Store mode (w_out and n_out non-null, the training forward): the thread
// also writes its (2r+1)^2 tap weights, h and the border mask included, as
// bf16 (round to nearest even) or float, and N = max(sum w, eps) as float.
// The colour and variance use the float weights, and N is their float sum;
// only the adjoint sees the rounded weights, as on the TPU.
//
// Bound on the card: memory.  Per pixel and level the taps read
// (2r+1)^2 x 9 floats (colour, variance, normal, depth) that neighbouring
// threads share through L1/L2; the weight math is ~40 flops a tap.  The
// least traffic is 56 B/px (inputs once, outputs once), 78 B/px in store mode
// at radius 1; K1b 64 B/px, 100 (r1) or 164 (r2) with float weights.  This
// first version leaves the reuse to the caches (no shared-memory tiling).
//
// K2 (bf16 weights) and K2b (float weights) replace
// _make_level_kernel(mode="stored") as called by
// atrous_level_bwd_stored_canvas and _make_bwd_stored_kernel as called by
// atrous_level_bwd_stored_pallas; their plain twin is
// atrous_level_bwd_stored_ref.  In gather form: the thread of output pixel x
// sums, over taps d, the centre p = x - d*2^level's stored weight w_p(d)
// against u = gc_p / max(N_p, eps) and, squared, against
// u2 = gv_p / max(N_p, eps)^2.  A gather needs no atomics, so the sum is
// deterministic and in the twin's tap order.  Bound: memory, 54 (K2 r1),
// 86 (K2 r2), 72 (K2b r1) or 136 (K2b r2) B/px (weights, N, gc, gv in; dc,
// dv out); the centres' reads are shared between threads through the
// caches.
//
// K14 replaces _make_level_kernel(mode="bwd") as called by
// atrous_level_bwd_pallas and atrous_level_bwd_canvas: the same gather as
// K2, with each centre's weight recomputed from p's luminance, normal,
// depth, depth gradient and sigma denominator and x's, by exact_tap, the
// function K1's exact weight goes through, so the adjoint is the exact
// transpose of K1's stencil.  Luminance, 1/N, u and u2 are derived in the
// kernel (no PyTorch pass).  Plain twin: atrous_level_bwd_ref.  Bound:
// memory, 76 B/px (colour, normal, depth, zgrad, sigma, N, gc, gv in; dc,
// dv out); ~40 flops a tap.
//
// K9 replaces _make_wgrad_center_kernel and _make_wgrad_neighbor_kernel as
// called by atrous_level_wgrad_bwd_pallas: the adjoint of one level
// through its weights.  With A_p(d) = dL/dw_p(d), every input theta gets
// sum A dw/dtheta in two shapes, each a gather with one thread per pixel
// and no atomics:
//  * wgrad_center_kernel, x as the centre, over its own taps: the normal,
//    depth, depth-gradient, sigma and luminance terms;
//  * wgrad_neighbor_kernel, x as the neighbour of the centres p = x - d:
//    the normal, depth and luminance terms, and the detached data stencil
//    of colour and variance (K14's sum).  It adds the centre kernel's
//    partial planes at x (left in the output buffers) and folds the
//    luminance gradient into d_color by the Rec.709 weights.
// The weights are K1's exact ones (expf, powf), not the TPU's polynomial
// exp and Newton reciprocals; the derivative of |.| at 0 is 0.  Plain twin:
// atrous_level_wgrad_bwd_ref.  Bound: 124 B/px of inputs and outputs, and
// ~150 flops a tap (two kernels), so memory at radius 1 and the float32
// rate at radius 2.
//
// Radius: K1/K1b, K14 and K9 take any r >= 0 ((2r+1) taps a row, from
// _spline_taps).  Up to r = 2 the 1-D taps ride in AtrousParams.taps[5];
// a larger radius passes them as a small device array (wide_taps) and runs
// the kernels' WIDE = true instantiation, so the launches at r <= 2 keep
// their parameter struct, code and time.  K2/K2b read their stored weights
// and need no taps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

// Launch parameters, passed by pointer from ops/atrous_cuda.py (ctypes).
struct AtrousParams {
    int H, W, spacing, radius, fast, luma_only;
    float sigma_color, sigma_depth, sigma_normal;
    // fast weights: log2(e)-folded constants, rounded from double on the host
    float sz2, eps2, c_s1, c_s2;
    float taps[5];
};

// The tile of a launch, passed by pointer beside the parameters; a null
// pointer is the whole frame.
//
// Tiles (the sharded sweep, parallel/sharded.py): a launch computes the
// H x W centre of a tile whose pixel (0, 0) is the global pixel
// (gy0, gx0) of an Hg x Wg frame.  A tap is dropped when its GLOBAL
// coordinate falls outside the frame, so a tile gives what the whole
// frame gives at its pixels.  The planes read around a pixel come as
// canvases: the tile plus a margin of m pixels on every side, with their
// own row and plane strides (a view into a larger canvas works as it is):
// colour and variance share one canvas geometry (d_*), normal and depth
// another (g_*).  The planes read at the pixel itself (depth gradient,
// sigma denominator, N, cotangents, weights, outputs) are contiguous
// H x W planes.  The adjoints K2 and K14 write an output region of the
// centre plus o_m pixels on every side (the gradients of the canvas
// margins, which the halo exchange's adjoint sends to the tiles that own
// them).  A whole-frame launch runs the kernels' TILE = false
// instantiation, which indexes and masks as if there were no tile, with
// the parameters it had before tiles existed: putting the tile's fields
// into AtrousParams made the whole-frame K1 and K14 14 % slower on an
// H100 (the struct's size alone: the kernels index its taps at run time).
// Both instantiations compute the same floats.
struct AtrousTile {
    int Hg, Wg, gy0, gx0;
    int d_rs, d_ps, d_m;    // colour/variance canvas
    int g_rs, g_ps, g_m;    // normal/depth canvas
    int o_m;                // adjoints: the output region's margin
};

namespace {

constexpr float kEps = 1e-8f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kL0 = 0.2126f, kL1 = 0.7152f, kL2 = 0.0722f;

// 2^y for y <= 0 with the degree-3 near-minimax polynomial of the TPU
// kernel's _exp2_fast3 (max relative error 1.37e-4).
__device__ __forceinline__ float exp2_fast3(float y) {
    float yi = floorf(y + 0.5f);
    float z = (y - yi) * kLn2;
    float p = 0.999951338657045f
        + z * (1.0001527445243588f + z * (0.5042261676140843f + z * 0.16524081962961631f));
    int i = (int)fmaxf(yi, -126.0f);
    return p * __int_as_float((i + 127) << 23);
}

__device__ __forceinline__ float luma(const float* c, int i, int hw) {
    return kL0 * c[i] + kL1 * c[hw + i] + kL2 * c[2 * hw + i];
}

// Index of tile pixel (y, x) (centre coordinates, negative in the margin)
// in the colour/variance canvas and in the normal/depth canvas, and their
// plane strides; W is the tile's width.
template <bool TILE>
__device__ __forceinline__ int didx(const AtrousTile& t, int W, int y, int x) {
    return TILE ? (y + t.d_m) * t.d_rs + (x + t.d_m) : y * W + x;
}
template <bool TILE>
__device__ __forceinline__ int gidx(const AtrousTile& t, int W, int y, int x) {
    return TILE ? (y + t.g_m) * t.g_rs + (x + t.g_m) : y * W + x;
}

// Whether tile row y (of H) / column x (of W) lies in the frame.
template <bool TILE>
__device__ __forceinline__ bool row_in(const AtrousTile& t, int H, int y) {
    return TILE ? t.gy0 + y >= 0 && t.gy0 + y < t.Hg : y >= 0 && y < H;
}
template <bool TILE>
__device__ __forceinline__ bool col_in(const AtrousTile& t, int W, int x) {
    return TILE ? t.gx0 + x >= 0 && t.gx0 + x < t.Wg : x >= 0 && x < W;
}

__global__ void zgrad_kernel(const float* __restrict__ z, float* __restrict__ g,
                             int H, int W) {
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= W || y >= H) return;
    int i = y * W + x;
    float zc = z[i];
    // shifted-out neighbours read zero, as in finite_diff_gradients
    float fwd_y = (y + 1 < H ? z[i + W] : 0.0f) - zc;
    float bwd_y = zc - (y > 0 ? z[i - W] : 0.0f);
    float fwd_x = (x + 1 < W ? z[i + 1] : 0.0f) - zc;
    float bwd_x = zc - (x > 0 ? z[i - 1] : 0.0f);
    g[i] = y == 0 ? fwd_y : (y == H - 1 ? bwd_y : 0.5f * (fwd_y + bwd_y));
    g[H * W + i] = x == 0 ? fwd_x : (x == W - 1 ? bwd_x : 0.5f * (fwd_x + bwd_x));
}

// The exact weight of centre a for its tap at offset (oy, ox), whose
// neighbour is b, with the intermediate values the adjoints reuse.  K1,
// K14 and K9 all go through this one function, so K14's and K9's
// recomputed weights are bit-equal to the forward's.
struct Tap {
    float w, dz, dl, zs, ndot;
};

__device__ __forceinline__ Tap exact_tap(float h, float l_a, float l_b,
                                         float sden_a, float z_a, float z_b,
                                         float zg0_a, float zg1_a, int oy,
                                         int ox, float na0, float na1,
                                         float na2, float nb0, float nb1,
                                         float nb2, const AtrousParams& p) {
    Tap t;
    t.dl = l_a - l_b;
    t.dz = z_a - z_b;
    t.zs = zg0_a * (float)oy + zg1_a * (float)ox;
    float wl = -fabsf(t.dl) / sden_a;
    float wz = -fabsf(t.dz) / (p.sigma_depth * fabsf(t.zs) + kEps);
    t.ndot = fmaxf(na0 * nb0 + na1 * nb1 + na2 * nb2, 0.0f);
    float wn = powf(fmaxf(t.ndot, 1e-20f), p.sigma_normal);
    t.w = h * expf(wz + wl) * wn;
    return t;
}

// The 2-D tap weight h of offset (dy + r, dx + r): from the parameters'
// taps, or (WIDE) from the device array of a radius above 2.
template <bool WIDE>
__device__ __forceinline__ float tap_h(const AtrousParams& p,
                                       const float* __restrict__ wide_taps,
                                       int ky, int kx) {
    return WIDE ? wide_taps[ky] * wide_taps[kx] : p.taps[ky] * p.taps[kx];
}

__device__ __forceinline__ float sgnf(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ void store_w(__nv_bfloat16* w, int k, float v) {
    w[k] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_w(float* w, int k, float v) { w[k] = v; }
__device__ __forceinline__ float load_w(const __nv_bfloat16* w, int k) {
    return __bfloat162float(w[k]);
}
__device__ __forceinline__ float load_w(const float* w, int k) { return w[k]; }

// K1 (sden_in null: the fused blur) and K1b (sden_in given); WT is the
// stored weights' type.
template <typename WT, bool TILE, bool WIDE>
__global__ void atrous_level_kernel(const float* __restrict__ color,
                                    const float* __restrict__ var,
                                    const float* __restrict__ normal,
                                    const float* __restrict__ depth,
                                    const float* __restrict__ zgrad,
                                    const float* __restrict__ sden_in,
                                    float* __restrict__ color_out,
                                    float* __restrict__ var_out,
                                    WT* __restrict__ w_out,
                                    float* __restrict__ n_out,
                                    AtrousParams p, AtrousTile t,
                                    const float* __restrict__ wide_taps) {
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.W || y >= p.H) return;
    const int H = p.H, W = p.W, hw = H * W;
    const int i = y * W + x;
    const int dp = TILE ? t.d_ps : hw, gp = TILE ? t.g_ps : hw;

    float sden;
    if (sden_in) {
        sden = sden_in[i];
    } else {
        // fused sigma denominator: (1/4, 1/2, 1/4)^2 blur of the variance
        // over in-image taps, renormalised (variance_blur3x3); a tile pixel
        // outside the frame (a padded tile) has no such tap and gets 0
        const float k1[3] = {0.25f, 0.5f, 0.25f};
        float num = 0.0f, kden = 0.0f;
        for (int dy = -1; dy <= 1; ++dy) {
            for (int dx = -1; dx <= 1; ++dx) {
                if (!row_in<TILE>(t, H, y + dy) || !col_in<TILE>(t, W, x + dx))
                    continue;
                float k = k1[dy + 1] * k1[dx + 1];
                num = num + k * var[didx<TILE>(t, W, y + dy, x + dx)];
                kden = kden + k;
            }
        }
        if (TILE) kden = fmaxf(kden, 1e-20f);
        sden = p.sigma_color * sqrtf(fmaxf(num / kden, 0.0f)) + kEps;
    }
    const float isd2 = kLog2e / fmaxf(sden, kEps);

    const int dc = didx<TILE>(t, W, y, x), gc = gidx<TILE>(t, W, y, x);
    const float lum_c = luma(color, dc, dp);
    const float z_c = depth[gc];
    const float n0 = normal[gc], n1 = normal[gp + gc],
                n2 = normal[2 * gp + gc];
    const float zg0 = zgrad[i], zg1 = zgrad[hw + i];

    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc_v = 0.0f, den = 0.0f;
    const int r = p.radius;
    const int side = 2 * r + 1;
    for (int dy = -r; dy <= r; ++dy) {
        const int oy = dy * p.spacing;
        const int qy = y + oy;
        const bool rin = row_in<TILE>(t, H, qy);
        for (int dx = -r; dx <= r; ++dx) {
            const int ox = dx * p.spacing;
            const int qx = x + ox;
            const int k = ((dy + r) * side + (dx + r)) * hw + i;
            if (!rin || !col_in<TILE>(t, W, qx)) {
                // dropped tap: its stored weight is zero
                if (w_out) store_w(w_out, k, 0.0f);
                continue;
            }
            const int q = didx<TILE>(t, W, qy, qx);
            const int g = gidx<TILE>(t, W, qy, qx);
            const float h = tap_h<WIDE>(p, wide_taps, dy + r, dx + r);
            const float lum_q = luma(color, q, dp);
            float w;
            if (p.fast) {
                float arg = -fabsf(lum_c - lum_q) * isd2;
                if (!p.luma_only) {
                    float zdot = fabsf(zg0 * (float)oy + zg1 * (float)ox);
                    float wz2 = -fabsf(z_c - depth[g]) / (p.sz2 * zdot + p.eps2);
                    float d0 = n0 - normal[g];
                    float d1 = n1 - normal[gp + g];
                    float d2 = n2 - normal[2 * gp + g];
                    float s = d0 * d0 + d1 * d1 + d2 * d2;
                    arg = wz2 + arg - (p.c_s1 * s + p.c_s2 * (s * s));
                }
                w = h * exp2_fast3(arg);
            } else if (p.luma_only) {
                w = h * expf(-fabsf(lum_c - lum_q) / sden);
            } else {
                w = exact_tap(h, lum_c, lum_q, sden, z_c, depth[g], zg0, zg1,
                              oy, ox, n0, n1, n2, normal[g], normal[gp + g],
                              normal[2 * gp + g], p).w;
            }
            if (w_out) store_w(w_out, k, w);
            acc0 = acc0 + w * color[q];
            acc1 = acc1 + w * color[dp + q];
            acc2 = acc2 + w * color[2 * dp + q];
            acc_v = acc_v + (w * w) * var[q];
            den = den + w;
        }
    }
    den = fmaxf(den, kEps);
    color_out[i] = acc0 / den;
    color_out[hw + i] = acc1 / den;
    color_out[2 * hw + i] = acc2 / den;
    var_out[i] = acc_v / (den * den);
    if (n_out) n_out[i] = den;
}

// K2 (WT = bf16) and K2b (WT = float): gather-form stored-weight adjoint
// (see the header).
template <typename WT, bool TILE>
__global__ void atrous_bwd_stored_kernel(const WT* __restrict__ w,
                                         const float* __restrict__ norm,
                                         const float* __restrict__ gc,
                                         const float* __restrict__ gv,
                                         float* __restrict__ dc,
                                         float* __restrict__ dv,
                                         int H, int W, int spacing, int r,
                                         AtrousTile t) {
    // output pixel (yo, xo) of the centre-plus-o_m region is tile pixel
    // (y, x); its centres p = x - d lie in the tile (their weights hold the
    // border mask)
    const int om = TILE ? t.o_m : 0;
    const int Ho = H + 2 * om, Wo = W + 2 * om;
    int xo = blockIdx.x * blockDim.x + threadIdx.x;
    int yo = blockIdx.y * blockDim.y + threadIdx.y;
    if (xo >= Wo || yo >= Ho) return;
    const int hw = H * W, hwo = Ho * Wo, i = yo * Wo + xo;
    const int y = yo - om, x = xo - om;
    const int side = 2 * r + 1;
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc_v = 0.0f;
    for (int dy = -r; dy <= r; ++dy) {
        const int py = y - dy * spacing;
        if (py < 0 || py >= H) continue;
        for (int dx = -r; dx <= r; ++dx) {
            const int px = x - dx * spacing;
            if (px < 0 || px >= W) continue;
            const int c = py * W + px;
            const float wk = load_w(w, ((dy + r) * side + (dx + r)) * hw + c);
            const float inv_n = 1.0f / fmaxf(norm[c], kEps);
            const float u2 = gv[c] * (inv_n * inv_n);
            acc0 = acc0 + wk * (gc[c] * inv_n);
            acc1 = acc1 + wk * (gc[hw + c] * inv_n);
            acc2 = acc2 + wk * (gc[2 * hw + c] * inv_n);
            acc_v = acc_v + (wk * wk) * u2;
        }
    }
    dc[i] = acc0;
    dc[hwo + i] = acc1;
    dc[2 * hwo + i] = acc2;
    dv[i] = acc_v;
}

// K14: the recompute adjoint (see the header).  Exact, full weights only.
// Output pixel (yo, xo) of the centre-plus-o_m region is tile pixel (y, x);
// a centre's tap to it was dropped in the forward when (y, x) lies outside
// the frame, so such a pixel gets zero.
template <bool TILE, bool WIDE>
__global__ void atrous_bwd_kernel(const float* __restrict__ color,
                                  const float* __restrict__ normal,
                                  const float* __restrict__ depth,
                                  const float* __restrict__ zgrad,
                                  const float* __restrict__ sden,
                                  const float* __restrict__ norm,
                                  const float* __restrict__ gc,
                                  const float* __restrict__ gv,
                                  float* __restrict__ dc,
                                  float* __restrict__ dv, AtrousParams p,
                                  AtrousTile t,
                                  const float* __restrict__ wide_taps) {
    const int H = p.H, W = p.W, hw = H * W;
    const int om = TILE ? t.o_m : 0;
    const int Ho = H + 2 * om, Wo = W + 2 * om, hwo = Ho * Wo;
    int xo = blockIdx.x * blockDim.x + threadIdx.x;
    int yo = blockIdx.y * blockDim.y + threadIdx.y;
    if (xo >= Wo || yo >= Ho) return;
    const int i = yo * Wo + xo;
    const int y = yo - om, x = xo - om;
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc_v = 0.0f;
    if (!TILE || (row_in<TILE>(t, H, y) && col_in<TILE>(t, W, x))) {
        const int dp = TILE ? t.d_ps : hw, gp = TILE ? t.g_ps : hw;
        const int dx_ = didx<TILE>(t, W, y, x), gx_ = gidx<TILE>(t, W, y, x);
        const float lum_x = luma(color, dx_, dp);
        const float z_x = depth[gx_];
        const float n0 = normal[gx_], n1 = normal[gp + gx_],
                    n2 = normal[2 * gp + gx_];
        const int r = p.radius;
        for (int dy = -r; dy <= r; ++dy) {
            const int oy = dy * p.spacing;
            const int py = y - oy;
            if (py < 0 || py >= H) continue;
            for (int dx = -r; dx <= r; ++dx) {
                const int ox = dx * p.spacing;
                const int px = x - ox;
                if (px < 0 || px >= W) continue;
                const int c = py * W + px;
                const int dq = didx<TILE>(t, W, py, px);
                const int gq = gidx<TILE>(t, W, py, px);
                const float h = tap_h<WIDE>(p, wide_taps, dy + r, dx + r);
                // centre p's weight for its tap (oy, ox), whose neighbour
                // is x
                const float wk = exact_tap(
                    h, luma(color, dq, dp), lum_x, sden[c], depth[gq], z_x,
                    zgrad[c], zgrad[hw + c], oy, ox, normal[gq],
                    normal[gp + gq], normal[2 * gp + gq], n0, n1, n2, p).w;
                const float inv_n = 1.0f / fmaxf(norm[c], kEps);
                const float u2 = gv[c] * (inv_n * inv_n);
                acc0 = acc0 + wk * (gc[c] * inv_n);
                acc1 = acc1 + wk * (gc[hw + c] * inv_n);
                acc2 = acc2 + wk * (gc[2 * hw + c] * inv_n);
                acc_v = acc_v + (wk * wk) * u2;
            }
        }
    }
    dc[i] = acc0;
    dc[hwo + i] = acc1;
    dc[2 * hwo + i] = acc2;
    dv[i] = acc_v;
}

// K9, first kernel: the centre terms at x over x's own taps.  Writes its
// partial d_normal and d_depth into those outputs and its partial d_lum
// into d_color's first plane; the second kernel completes them.
template <bool WIDE>
__global__ void wgrad_center_kernel(
    const float* __restrict__ color, const float* __restrict__ var,
    const float* __restrict__ normal, const float* __restrict__ depth,
    const float* __restrict__ zgrad, const float* __restrict__ sden,
    const float* __restrict__ out_c, const float* __restrict__ out_v,
    const float* __restrict__ norm, const float* __restrict__ gc,
    const float* __restrict__ gv, float* __restrict__ d_color,
    float* __restrict__ d_normal, float* __restrict__ d_depth,
    float* __restrict__ d_zgrad, float* __restrict__ d_sden,
    AtrousParams p, const float* __restrict__ wide_taps) {
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.W || y >= p.H) return;
    const int H = p.H, W = p.W, hw = H * W, i = y * W + x;
    const float lum_x = luma(color, i, hw);
    const float z_x = depth[i];
    const float n0 = normal[i], n1 = normal[hw + i], n2 = normal[2 * hw + i];
    const float zg0 = zgrad[i], zg1 = zgrad[hw + i];
    const float sd = sden[i];
    const float isd = 1.0f / sd;
    const float inv_n = 1.0f / fmaxf(norm[i], kEps);
    const float g0 = gc[i], g1 = gc[hw + i], g2 = gc[2 * hw + i], g_v = gv[i];
    const float oc0 = out_c[i], oc1 = out_c[hw + i], oc2 = out_c[2 * hw + i];
    const float ov = out_v[i];
    float dn0 = 0.0f, dn1 = 0.0f, dn2 = 0.0f, dz = 0.0f, dzg0 = 0.0f,
          dzg1 = 0.0f, dsd = 0.0f, dl = 0.0f;
    const int r = p.radius;
    for (int dy = -r; dy <= r; ++dy) {
        const int oy = dy * p.spacing;
        const int qy = y + oy;
        if (qy < 0 || qy >= H) continue;
        for (int dx = -r; dx <= r; ++dx) {
            const int ox = dx * p.spacing;
            const int qx = x + ox;
            if (qx < 0 || qx >= W) continue;
            const int q = qy * W + qx;
            const float h = tap_h<WIDE>(p, wide_taps, dy + r, dx + r);
            const float nq0 = normal[q], nq1 = normal[hw + q],
                        nq2 = normal[2 * hw + q];
            const Tap t = exact_tap(h, lum_x, luma(color, q, hw), sd, z_x,
                                    depth[q], zg0, zg1, oy, ox, n0, n1, n2,
                                    nq0, nq1, nq2, p);
            const float rz = 1.0f / (p.sigma_depth * fabsf(t.zs) + kEps);
            const float a =
                ((g0 * (color[q] - oc0) + g1 * (color[hw + q] - oc1)
                  + g2 * (color[2 * hw + q] - oc2))
                 + g_v * (2.0f * t.w * var[q] * inv_n - 2.0f * ov)) * inv_n;
            const float b = a * t.w;
            dz = dz - b * sgnf(t.dz) * rz;
            dl = dl - b * sgnf(t.dl) * isd;
            dsd = dsd + b * fabsf(t.dl) * (isd * isd);
            const float gz = b * fabsf(t.dz) * (rz * rz) * p.sigma_depth
                             * sgnf(t.zs);
            dzg0 = dzg0 + gz * (float)oy;
            dzg1 = dzg1 + gz * (float)ox;
            const float nf = b * p.sigma_normal / fmaxf(t.ndot, 1e-20f);
            dn0 = dn0 + nf * nq0;
            dn1 = dn1 + nf * nq1;
            dn2 = dn2 + nf * nq2;
        }
    }
    d_normal[i] = dn0;
    d_normal[hw + i] = dn1;
    d_normal[2 * hw + i] = dn2;
    d_depth[i] = dz;
    d_zgrad[i] = dzg0;
    d_zgrad[hw + i] = dzg1;
    d_sden[i] = dsd;
    d_color[i] = dl;
}

// K9, second kernel: the neighbour terms at x over the centres p = x - d,
// the detached data stencil, and the sums with the first kernel's partial
// planes (read and written at x only).
template <bool WIDE>
__global__ void wgrad_neighbor_kernel(
    const float* __restrict__ color, const float* __restrict__ var,
    const float* __restrict__ normal, const float* __restrict__ depth,
    const float* __restrict__ zgrad, const float* __restrict__ sden,
    const float* __restrict__ out_c, const float* __restrict__ out_v,
    const float* __restrict__ norm, const float* __restrict__ gc,
    const float* __restrict__ gv, float* __restrict__ d_color,
    float* __restrict__ d_var, float* __restrict__ d_normal,
    float* __restrict__ d_depth, AtrousParams p,
    const float* __restrict__ wide_taps) {
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.W || y >= p.H) return;
    const int H = p.H, W = p.W, hw = H * W, i = y * W + x;
    const float c0 = color[i], c1 = color[hw + i], c2 = color[2 * hw + i];
    const float lum_x = luma(color, i, hw);
    const float z_x = depth[i], v_x = var[i];
    const float n0 = normal[i], n1 = normal[hw + i], n2 = normal[2 * hw + i];
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc_v = 0.0f;
    float dn0 = 0.0f, dn1 = 0.0f, dn2 = 0.0f, dz = 0.0f, dl = 0.0f;
    const int r = p.radius;
    for (int dy = -r; dy <= r; ++dy) {
        const int oy = dy * p.spacing;
        const int py = y - oy;
        if (py < 0 || py >= H) continue;
        for (int dx = -r; dx <= r; ++dx) {
            const int ox = dx * p.spacing;
            const int px = x - ox;
            if (px < 0 || px >= W) continue;
            const int c = py * W + px;
            const float h = tap_h<WIDE>(p, wide_taps, dy + r, dx + r);
            const float np0 = normal[c], np1 = normal[hw + c],
                        np2 = normal[2 * hw + c];
            const float sd = sden[c];
            const Tap t = exact_tap(h, luma(color, c, hw), lum_x, sd, depth[c],
                                    z_x, zgrad[c], zgrad[hw + c], oy, ox, np0,
                                    np1, np2, n0, n1, n2, p);
            const float inv_n = 1.0f / fmaxf(norm[c], kEps);
            const float gp0 = gc[c], gp1 = gc[hw + c], gp2 = gc[2 * hw + c];
            const float gpv = gv[c];
            const float u2 = gpv * (inv_n * inv_n);
            acc0 = acc0 + t.w * (gp0 * inv_n);
            acc1 = acc1 + t.w * (gp1 * inv_n);
            acc2 = acc2 + t.w * (gp2 * inv_n);
            acc_v = acc_v + (t.w * t.w) * u2;
            const float rz = 1.0f / (p.sigma_depth * fabsf(t.zs) + kEps);
            const float a =
                ((gp0 * (c0 - out_c[c]) + gp1 * (c1 - out_c[hw + c])
                  + gp2 * (c2 - out_c[2 * hw + c]))
                 + gpv * (2.0f * t.w * v_x * inv_n - 2.0f * out_v[c])) * inv_n;
            const float b = a * t.w;
            dz = dz + b * sgnf(t.dz) * rz;
            dl = dl + b * sgnf(t.dl) * (1.0f / sd);
            const float nf = b * p.sigma_normal / fmaxf(t.ndot, 1e-20f);
            dn0 = dn0 + nf * np0;
            dn1 = dn1 + nf * np1;
            dn2 = dn2 + nf * np2;
        }
    }
    const float d_lum = d_color[i] + dl;
    d_color[i] = acc0 + kL0 * d_lum;
    d_color[hw + i] = acc1 + kL1 * d_lum;
    d_color[2 * hw + i] = acc2 + kL2 * d_lum;
    d_var[i] = acc_v;
    d_normal[i] = d_normal[i] + dn0;
    d_normal[hw + i] = d_normal[hw + i] + dn1;
    d_normal[2 * hw + i] = d_normal[2 * hw + i] + dn2;
    d_depth[i] = d_depth[i] + dz;
}

dim3 grid_for(int H, int W, dim3 block) {
    return dim3((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
}

}  // namespace

extern "C" const char* rdt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

extern "C" int rdt_zgrad(const float* depth, float* zgrad, int H, int W,
                         void* stream) {
    dim3 block(32, 8);
    zgrad_kernel<<<grid_for(H, W, block), block, 0, (cudaStream_t)stream>>>(
        depth, zgrad, H, W);
    return (int)cudaGetLastError();
}

// K1/K1b.  sden null: the fused blur (K1), else read (K1b).  w_out and
// n_out null: no store; n_out alone: N only; both: the weights too, float
// if w_f32 else bf16.  tile null: the whole frame.  wide_taps null: the
// taps of params (radius <= 2), else the 2r+1 taps of a larger radius.
extern "C" int rdt_atrous_level(const float* color, const float* var,
                                const float* normal, const float* depth,
                                const float* zgrad, const float* sden,
                                float* color_out, float* var_out, void* w_out,
                                float* n_out, int w_f32,
                                const AtrousParams* params,
                                const AtrousTile* tile,
                                const float* wide_taps, void* stream) {
    dim3 block(32, 8);
    dim3 grid = grid_for(params->H, params->W, block);
    cudaStream_t s = (cudaStream_t)stream;
    const AtrousTile t = tile ? *tile : AtrousTile{};
#define RDT_LEVEL(WT, T, WI)                                              \
    atrous_level_kernel<WT, T, WI><<<grid, block, 0, s>>>(                \
        color, var, normal, depth, zgrad, sden, color_out, var_out,       \
        (WT*)w_out, n_out, *params, t, wide_taps)
#define RDT_LEVEL_T(WT, WI)                                               \
    if (tile) RDT_LEVEL(WT, true, WI); else RDT_LEVEL(WT, false, WI)
#define RDT_LEVEL_WT(WI)                                                  \
    if (w_f32) { RDT_LEVEL_T(float, WI); }                                \
    else { RDT_LEVEL_T(__nv_bfloat16, WI); }
    if (wide_taps) {
        RDT_LEVEL_WT(true)
    } else {
        RDT_LEVEL_WT(false)
    }
#undef RDT_LEVEL_WT
#undef RDT_LEVEL_T
#undef RDT_LEVEL
    return (int)cudaGetLastError();
}

// K2 (bf16 weights) / K2b (w_f32: float weights); with a tile the grid
// covers its output region (the centre plus o_m on every side).
extern "C" int rdt_atrous_bwd_stored(const void* w, const float* norm,
                                     const float* gc, const float* gv,
                                     float* dc, float* dv, int H, int W,
                                     int spacing, int radius, int w_f32,
                                     const AtrousTile* tile, void* stream) {
    dim3 block(32, 8);
    const AtrousTile t = tile ? *tile : AtrousTile{};
    dim3 grid = grid_for(H + 2 * t.o_m, W + 2 * t.o_m, block);
    cudaStream_t s = (cudaStream_t)stream;
#define RDT_STORED(WT, T)                                                 \
    atrous_bwd_stored_kernel<WT, T><<<grid, block, 0, s>>>(               \
        (const WT*)w, norm, gc, gv, dc, dv, H, W, spacing, radius, t)
    if (w_f32) {
        if (tile) RDT_STORED(float, true); else RDT_STORED(float, false);
    } else {
        if (tile) RDT_STORED(__nv_bfloat16, true);
        else RDT_STORED(__nv_bfloat16, false);
    }
#undef RDT_STORED
    return (int)cudaGetLastError();
}

// K14, over the output region as K2; wide_taps as in rdt_atrous_level.
extern "C" int rdt_atrous_bwd(const float* color, const float* normal,
                              const float* depth, const float* zgrad,
                              const float* sden, const float* norm,
                              const float* gc, const float* gv, float* dc,
                              float* dv, const AtrousParams* params,
                              const AtrousTile* tile, const float* wide_taps,
                              void* stream) {
    dim3 block(32, 8);
    const AtrousTile t = tile ? *tile : AtrousTile{};
    dim3 grid = grid_for(params->H + 2 * t.o_m, params->W + 2 * t.o_m, block);
    cudaStream_t s = (cudaStream_t)stream;
#define RDT_BWD(T, WI)                                                    \
    atrous_bwd_kernel<T, WI><<<grid, block, 0, s>>>(                      \
        color, normal, depth, zgrad, sden, norm, gc, gv, dc, dv, *params, \
        t, wide_taps)
    if (wide_taps) {
        if (tile) RDT_BWD(true, true); else RDT_BWD(false, true);
    } else {
        if (tile) RDT_BWD(true, false); else RDT_BWD(false, false);
    }
#undef RDT_BWD
    return (int)cudaGetLastError();
}

// K9: the centre kernel, then the neighbour kernel on the same stream;
// wide_taps as in rdt_atrous_level.
template <bool WIDE>
cudaError_t wgrad_launch(dim3 grid, dim3 block, cudaStream_t s,
                         const float* color, const float* var,
                         const float* normal, const float* depth,
                         const float* zgrad, const float* sden,
                         const float* out_c, const float* out_v,
                         const float* norm, const float* gc, const float* gv,
                         float* d_color, float* d_var, float* d_normal,
                         float* d_depth, float* d_zgrad, float* d_sden,
                         const AtrousParams& p, const float* wide_taps) {
    wgrad_center_kernel<WIDE><<<grid, block, 0, s>>>(
        color, var, normal, depth, zgrad, sden, out_c, out_v, norm, gc, gv,
        d_color, d_normal, d_depth, d_zgrad, d_sden, p, wide_taps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    wgrad_neighbor_kernel<WIDE><<<grid, block, 0, s>>>(
        color, var, normal, depth, zgrad, sden, out_c, out_v, norm, gc, gv,
        d_color, d_var, d_normal, d_depth, p, wide_taps);
    return cudaGetLastError();
}

extern "C" int rdt_atrous_wgrad_bwd(
    const float* color, const float* var, const float* normal,
    const float* depth, const float* zgrad, const float* sden,
    const float* out_c, const float* out_v, const float* norm,
    const float* gc, const float* gv, float* d_color, float* d_var,
    float* d_normal, float* d_depth, float* d_zgrad, float* d_sden,
    const AtrousParams* params, const float* wide_taps, void* stream) {
    dim3 block(32, 8);
    dim3 grid = grid_for(params->H, params->W, block);
    cudaStream_t s = (cudaStream_t)stream;
#define RDT_WGRAD(WI)                                                     \
    wgrad_launch<WI>(grid, block, s, color, var, normal, depth, zgrad,    \
                     sden, out_c, out_v, norm, gc, gv, d_color, d_var,    \
                     d_normal, d_depth, d_zgrad, d_sden, *params, wide_taps)
    const cudaError_t err = wide_taps ? RDT_WGRAD(true) : RDT_WGRAD(false);
#undef RDT_WGRAD
    return (int)err;
}
