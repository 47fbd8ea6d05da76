// K1/K1b, the à-trous level forward (see atrous.cu's header): one kernel
// body, specialised at compile time on the radius, the weight math, a
// fused or given sigma denominator, the store and the tile form.  Each
// atrous_level_r*.cu instantiates one radius, so nvcc builds them in
// parallel.

#pragma once

#include <type_traits>

#include "atrous_common.cuh"

namespace {

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

// K1's weight math, chosen at compile time.
enum WeightMath { M_FAST, M_FAST_LUMA, M_EXACT, M_EXACT_LUMA };

// The weight of centre c's tap at offset (oy, ox) to neighbour q: the fast
// base-2 form (the normal term folded into the exponent), its luminance-
// only form, the exact form (exact_tap) or its luminance-only form.
// sden is the centre's sigma denominator, isd2 = log2(e) / max(sden, eps).
template <int MATH>
__device__ __forceinline__ float tap_weight(
    float h, float lum_c, float lum_q, float sden, float isd2, float z_c,
    float z_q, float zg0, float zg1, int oy, int ox, float n0, float n1,
    float n2, float q0, float q1, float q2, const AtrousParams& p) {
    if (MATH == M_FAST || MATH == M_FAST_LUMA) {
        float arg = -fabsf(lum_c - lum_q) * isd2;
        if (MATH == M_FAST) {
            float zdot = fabsf(zg0 * (float)oy + zg1 * (float)ox);
            float wz2 = -fabsf(z_c - z_q) / (p.sz2 * zdot + p.eps2);
            float d0 = n0 - q0;
            float d1 = n1 - q1;
            float d2 = n2 - q2;
            float s = d0 * d0 + d1 * d1 + d2 * d2;
            arg = wz2 + arg - (p.c_s1 * s + p.c_s2 * (s * s));
        }
        return h * exp2_fast3(arg);
    }
    if (MATH == M_EXACT_LUMA)
        return h * expf(-fabsf(lum_c - lum_q) / sden);
    return exact_tap(h, lum_c, lum_q, sden, z_c, z_q, zg0, zg1, oy, ox, n0,
                     n1, n2, q0, q1, q2, p).w;
}

// The fused sigma denominator of K1 at tile pixel (y, x): the
// (1/4, 1/2, 1/4)^2 blur of the variance over in-image taps, renormalised
// (variance_blur3x3); a tile pixel outside the frame (a padded tile) has
// no such tap and gets 0.
template <bool TILE>
__device__ __forceinline__ float fused_sden(const float* __restrict__ var,
                                            const AtrousTile& t, int H,
                                            int W, int y, int x,
                                            const AtrousParams& p) {
    const float k1[3] = {0.25f, 0.5f, 0.25f};
    float num = 0.0f, kden = 0.0f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
            if (!row_in<TILE>(t, H, y + dy) || !col_in<TILE>(t, W, x + dx))
                continue;
            float k = k1[dy + 1] * k1[dx + 1];
            num = num + k * var[didx<TILE>(t, W, y + dy, x + dx)];
            kden = kden + k;
        }
    }
    if (TILE) kden = fmaxf(kden, 1e-20f);
    return p.sigma_color * sqrtf(fmaxf(num / kden, 0.0f)) + kEps;
}

__device__ __forceinline__ void store_w(__nv_bfloat16* w, int k, float v) {
    w[k] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_w(float* w, int k, float v) { w[k] = v; }
// The block: 64 columns by 4 thread rows, two lattice rows a thread (the
// second 4 below the first), so a block computes 64 x 8 pixels.
constexpr int K1_TW = 64, K1_TY = 4, K1_PY = 2, K1_TR = K1_TY * K1_PY;

// What a launch stores beside c and v: nothing (inference), N (K1b), or
// the tap weights, bf16 or float, and N.
enum LevelStore { ST_NONE, ST_N, ST_BF16, ST_F32 };

// One neighbour's planes as the tap loop reads them.
struct LevelPix {
    float4 cv;    // colour, variance
    float4 nz;    // normal, depth (the full weight maths only)
    float lum;
};

template <bool TILE, bool GEOM>
__device__ __forceinline__ LevelPix level_load(
    const float* __restrict__ color, const float* __restrict__ var,
    const float* __restrict__ normal, const float* __restrict__ depth,
    const AtrousTile& t, int W, int dp, int gp, int y, int x) {
    LevelPix v;
    const int q = didx<TILE>(t, W, y, x);
    v.cv = make_float4(color[q], color[dp + q], color[2 * dp + q], var[q]);
    v.lum = luma3(v.cv.x, v.cv.y, v.cv.z);
    if (GEOM) {
        const int g = gidx<TILE>(t, W, y, x);
        v.nz = make_float4(normal[g], normal[gp + g], normal[2 * gp + g],
                           depth[g]);
    }
    return v;
}

// R > 0: the radius, the neighbourhood staged in shared memory over the
// block's row-lattice tile (colour and variance, luminance, normal and
// depth; the canvas's content wherever the canvas has memory, zero
// beyond), the taps unrolled, p.taps indexed by constants.  R = 0: the one
// tap read from the planes.  R = -1: any radius (p.radius), taps from
// wide_taps, neighbours read through the caches.  A tap is dropped by its
// coordinate (row_in/col_in), as before staging.
template <int R, int MATH, bool SDEN, int STORE, bool TILE>
__device__ __forceinline__ void level_body(
    const float* __restrict__ color, const float* __restrict__ var,
    const float* __restrict__ normal, const float* __restrict__ depth,
    const float* __restrict__ zgrad, const float* __restrict__ sden_in,
    float* __restrict__ color_out, float* __restrict__ var_out,
    void* __restrict__ w_out_, float* __restrict__ n_out, AtrousParams p,
    AtrousTile t, const float* __restrict__ wide_taps) {
    using WT = std::conditional_t<STORE == ST_BF16, __nv_bfloat16, float>;
    constexpr bool GEOM = MATH == M_FAST || MATH == M_EXACT;
    // radius 0 reads each neighbour once: nothing to share, no staging
    constexpr bool WIDE = R < 0, STAGED = R > 0;
    WT* __restrict__ w_out = (WT*)w_out_;
    const int H = p.H, W = p.W, hw = H * W;
    const int dp = TILE ? t.d_ps : hw, gp = TILE ? t.g_ps : hw;
    const int r = WIDE ? p.radius : R;
    const int side = 2 * r + 1;
    const Lattice<K1_TW, K1_TR> L(p.spacing, r);
    const int tx = threadIdx.x;

    extern __shared__ float4 smem[];
    const int n = L.sw * L.sh;
    float4* s_cv = smem;
    float4* s_nz = smem + n;
    float* s_l = (float*)(smem + (GEOM ? 2 : 1) * n);
    if (STAGED) {
        for (int j = threadIdx.y; j < L.sh; j += K1_TY) {
            const int y = L.row(j);
            for (int c = tx; c < L.sw; c += K1_TW) {
                const int x = L.col(c);
                LevelPix v = {};
                if (in_canvas(H, W, TILE ? t.d_m : 0, y, x)) {
                    const int q = didx<TILE>(t, W, y, x);
                    v.cv = make_float4(color[q], color[dp + q],
                                       color[2 * dp + q], var[q]);
                    v.lum = luma3(v.cv.x, v.cv.y, v.cv.z);
                }
                s_cv[j * L.sw + c] = v.cv;
                s_l[j * L.sw + c] = v.lum;
                if (GEOM) {
                    if (in_canvas(H, W, TILE ? t.g_m : 0, y, x)) {
                        const int g = gidx<TILE>(t, W, y, x);
                        v.nz = make_float4(normal[g], normal[gp + g],
                                           normal[2 * gp + g], depth[g]);
                    }
                    s_nz[j * L.sw + c] = v.nz;
                }
            }
        }
        __syncthreads();
    }

#pragma unroll 1
    for (int jj = 0; jj < K1_PY; ++jj) {
        const int kl = threadIdx.y + jj * K1_TY;
        const int y = L.out_row(kl), x = L.x0 + tx;
        if (y >= H || x >= W) continue;
        const int i = y * W + x;
        const float sden = SDEN ? sden_in[i]
                                : fused_sden<TILE>(var, t, H, W, y, x, p);
        const float isd2 = kLog2e / fmaxf(sden, kEps);
        LevelPix c = {};
        if (STAGED) {
            const int ci = L.at(kl, tx, 0, 0);
            c.lum = s_l[ci];
            if (GEOM) c.nz = s_nz[ci];
        } else {
            c = level_load<TILE, GEOM>(color, var, normal, depth, t, W, dp,
                                       gp, y, x);
        }
        float zg0 = 0.0f, zg1 = 0.0f;
        if (GEOM) {
            zg0 = zgrad[i];
            zg1 = zgrad[hw + i];
        }

        float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc_v = 0.0f, den = 0.0f;
#pragma unroll
        for (int dy = -r; dy <= r; ++dy) {
            const int oy = dy * L.s;
            const bool rin = row_in<TILE>(t, H, y + oy);
#pragma unroll
            for (int dx = -r; dx <= r; ++dx) {
                const int ox = dx * L.s;
                const int k = ((dy + r) * side + (dx + r)) * hw + i;
                if (!rin || !col_in<TILE>(t, W, x + ox)) {
                    // dropped tap: its stored weight is zero
                    if (STORE == ST_BF16 || STORE == ST_F32)
                        store_w(w_out, k, 0.0f);
                    continue;
                }
                LevelPix q = {};
                if (STAGED) {
                    const int e = L.at(kl, tx, dy, dx);
                    q.cv = s_cv[e];
                    q.lum = s_l[e];
                    if (GEOM) q.nz = s_nz[e];
                } else {
                    q = level_load<TILE, GEOM>(color, var, normal, depth, t,
                                               W, dp, gp, y + oy, x + ox);
                }
                const float h = tap_h<WIDE>(p, wide_taps, dy + r, dx + r);
                const float w = tap_weight<MATH>(
                    h, c.lum, q.lum, sden, isd2, c.nz.w, q.nz.w, zg0, zg1,
                    oy, ox, c.nz.x, c.nz.y, c.nz.z, q.nz.x, q.nz.y, q.nz.z,
                    p);
                if (STORE == ST_BF16 || STORE == ST_F32) store_w(w_out, k, w);
                acc0 = acc0 + w * q.cv.x;
                acc1 = acc1 + w * q.cv.y;
                acc2 = acc2 + w * q.cv.z;
                acc_v = acc_v + (w * w) * q.cv.w;
                den = den + w;
            }
        }
        den = fmaxf(den, kEps);
        color_out[i] = acc0 / den;
        color_out[hw + i] = acc1 / den;
        color_out[2 * hw + i] = acc2 / den;
        var_out[i] = acc_v / (den * den);
        if (STORE != ST_NONE) n_out[i] = den;
    }
}

#define RDT_LEVEL_PARAMS                                                   \
    const float* __restrict__ color, const float* __restrict__ var,        \
        const float* __restrict__ normal, const float* __restrict__ depth, \
        const float* __restrict__ zgrad, const float* __restrict__ sden_in,\
        float* __restrict__ color_out, float* __restrict__ var_out,        \
        void* __restrict__ w_out, float* __restrict__ n_out,               \
        AtrousParams p, AtrousTile t, const float* __restrict__ wide_taps
#define RDT_LEVEL_ARGS                                                     \
    color, var, normal, depth, zgrad, sden_in, color_out, var_out, w_out,  \
        n_out, p, t, wide_taps

template <int R, int MATH, bool SDEN, int STORE, bool TILE>
__global__ void __launch_bounds__(K1_TW * K1_TY)
    level_kernel(RDT_LEVEL_PARAMS) {
    level_body<R, MATH, SDEN, STORE, TILE>(RDT_LEVEL_ARGS);
}

// The radius-2 fast weights: ptxas's own choice there (64 registers, four
// blocks an SM) spills, so it is told that two blocks suffice.
template <int R, int MATH, bool SDEN, int STORE, bool TILE>
__global__ void __launch_bounds__(K1_TW * K1_TY, 2)
    level_kernel_2b(RDT_LEVEL_PARAMS) {
    level_body<R, MATH, SDEN, STORE, TILE>(RDT_LEVEL_ARGS);
}

#undef RDT_LEVEL_ARGS
#undef RDT_LEVEL_PARAMS

template <int R, int MATH, bool SDEN, int STORE, bool TILE>
constexpr auto level_kernel_for() {
    if constexpr (R == 2 && MATH == M_FAST)
        return level_kernel_2b<R, MATH, SDEN, STORE, TILE>;
    else
        return level_kernel<R, MATH, SDEN, STORE, TILE>;
}

template <int R, int MATH, bool SDEN, int STORE, bool TILE>
cudaError_t launch_level(const LevelArgs& a) {
    constexpr bool GEOM = MATH == M_FAST || MATH == M_EXACT;
    const AtrousParams& p = *a.params;
    auto kernel = level_kernel_for<R, MATH, SDEN, STORE, TILE>();
    // colour and variance (16 B), luminance (4 B), normal and depth (16 B)
    const size_t bytes =
        lattice_entries<K1_TW, K1_TR>(p.spacing, R > 0 ? R : -1)
        * (GEOM ? 36 : 20);
    static size_t opted = 0;
    cudaError_t err = allow_smem(kernel, bytes, opted);
    if (err != cudaSuccess) return err;
    kernel<<<lattice_grid<K1_TW, K1_TR>(p.H, p.W, p.spacing),
             dim3(K1_TW, K1_TY), bytes, a.stream>>>(
        a.color, a.var, a.normal, a.depth, a.zgrad, a.sden, a.color_out,
        a.var_out, a.w_out, a.n_out, p, a.tile ? *a.tile : AtrousTile{},
        a.wide_taps);
    return cudaGetLastError();
}

template <int R, int MATH, bool SDEN, int STORE>
cudaError_t launch_level_tile(const LevelArgs& a) {
    return a.tile ? launch_level<R, MATH, SDEN, STORE, true>(a)
                  : launch_level<R, MATH, SDEN, STORE, false>(a);
}

// The stores the wrappers launch: K1 none, or weights (bf16 or float) and
// N; K1b (exact maths only) N, or float weights and N.
template <int R, int MATH>
cudaError_t launch_level_store(const LevelArgs& a) {
    if (!a.sden) {
        if (!a.w_out && !a.n_out)
            return launch_level_tile<R, MATH, false, ST_NONE>(a);
        if (a.w_out && a.n_out)
            return a.w_f32 ? launch_level_tile<R, MATH, false, ST_F32>(a)
                           : launch_level_tile<R, MATH, false, ST_BF16>(a);
    } else if constexpr (MATH == M_EXACT || MATH == M_EXACT_LUMA) {
        if (!a.w_out && a.n_out)
            return launch_level_tile<R, MATH, true, ST_N>(a);
        if (a.w_out && a.n_out && a.w_f32)
            return launch_level_tile<R, MATH, true, ST_F32>(a);
    }
    return cudaErrorNotSupported;
}

// ---------------------------------------------------------------------
// K1b's bf16 form (precision="bf16"; the TPU kernel _make_level_kernel(
// mode="fwd", dtype=jnp.bfloat16) as called by atrous_level_fwd_pallas).
// Plain twin: atrous_level_ref(..., precision="bf16") in ops/atrous.py.
//
// Design: K1's row-lattice tile (Lattice<64, 8>: 64 columns by 8 lattice
// rows of one residue modulo the spacing), 32 x 8 threads, each computing
// the two horizontally adjacent pixels (x, x + 1) of one lattice row in
// the two lanes of an __nv_bfloat162.  A block stages once per pixel of
// its tile and halo what a tap reads, rounded from the f32 planes as they
// are loaded (no separate cast pass): colour and variance as float32
// values already rounded to bf16 (four float planes: they feed only the
// float32 fmas, so a tap reads them with no unpacking, one 8-byte load a
// plane for an aligned lane pair), and luminance (bf16, from the rounded
// colour), normal and depth as five bf16 planes: 26 B a pixel.  At
// spacing 1 every other dx reads an unaligned pair: two loads a plane.
// The tap math runs on both pixels at once in packed bf16 (PTX
// add/sub/mul.rn.bf16x2: each operation rounded once, as the TPU body
// rounds it; no fma where it rounds twice).  Per thread, before the taps:
// the 2-D tap weights h_y*h_x in bf16 (one a distinct |dy|, |dx|: the taps
// are symmetric), and the depth weight's scale rz = 1/(sz2*|dz.d| + eps2)
// of each lane, one true float32 division for each distinct offset (a tap
// and its mirror share |dz.d|: 5 at r1, 13 at r2, the centre included),
// rounded to bf16 (the TPU kernel's Newton reciprocal from a bf16 seed
// differs by ~2^-16 before that rounding; the twin divides as this kernel
// does).  2^i in the exponential comes from the bf16 bits
// (exp2_fast_bf16x2).  Sums are float32: each lane's weight times its
// neighbour's value is exact in float32 and enters by one fma (the JAX
// kernel keeps these products unrounded: XLA drops their bf16 round trip
// into the float32 sum; w*w is rounded), N adds the weight's exact float32
// value h*2^arg.  The end is float32: N = max(N, eps), c = sum*(1/N), v =
// sum_v*(1/N)^2, true division; an aligned lane pair stores its two
// outputs as one float2.  A dropped tap is masked, not skipped (no branch
// but at radius 2).  Radius 1 and 2 compile spacing 1 apart (S1), so every
// lane pair's alignment is known at compile time.  FUSED: the sigma
// denominator is not read but computed from the float32 variance through
// the caches (fused_sden_pair: K1's fused_sden<false> for both lanes from
// one 3 x 4 window; the operations and order of ops.atrous.
// sigma_denominator, which the other form is fed), and written where
// sden_out is set (for K14's bf16 form).  Bound: memory, 64 B/px with a
// given sigma (colour, variance, normal, depth, zgrad, sigma in; c, v, N
// out); fused 60 B/px, 64 with the sigma written.  R: 0, 1, 2 at compile
// time, or -1: any radius, taps from wide_taps, the scales and tap weights
// a tap; STAGED false (a WIDE tile above kBf16MaxStaged): each tap reads
// its two neighbours through the caches and rounds them there.
constexpr int KB_FWD_F32 = 4;            // c0 c1 c2 v, rounded to bf16
constexpr int KB_FWD_PLANES = 5;         // lum n0 n1 n2 z
constexpr size_t KB_FWD_BYTES =
    KB_FWD_F32 * sizeof(float) + KB_FWD_PLANES * sizeof(__nv_bfloat16);
constexpr size_t kBf16MaxStaged = 200 * 1024;

// One pixel's values for the forward's taps; zero outside the frame.
struct FwdPixBf16 {
    float f[KB_FWD_F32];
    __nv_bfloat16 a[KB_FWD_PLANES];
};

__device__ __forceinline__ FwdPixBf16 fwd_pixel_bf16(
    const float* __restrict__ color, const float* __restrict__ var,
    const float* __restrict__ normal, const float* __restrict__ depth,
    int H, int W, int y, int x, const Bf16K& k) {
    FwdPixBf16 v;
    if (y < 0 || y >= H || x < 0 || x >= W) {
        const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
#pragma unroll
        for (int q = 0; q < KB_FWD_F32; ++q) v.f[q] = 0.0f;
#pragma unroll
        for (int q = 0; q < KB_FWD_PLANES; ++q) v.a[q] = zero;
        return v;
    }
    const int hw = H * W, i = y * W + x;
    // colour rounded, then its luminance in bf16: (l0*c0 + l1*c1) + l2*c2
    const bf2 c01 = __floats2bfloat162_rn(color[i], color[hw + i]);
    const bf2 c2v = __floats2bfloat162_rn(color[2 * hw + i], var[i]);
    const bf2 lum = add2(add2(mul2(k.l0, __low2bfloat162(c01)),
                              mul2(k.l1, __high2bfloat162(c01))),
                         mul2(k.l2, __low2bfloat162(c2v)));
    const bf2 n01 = __floats2bfloat162_rn(normal[i], normal[hw + i]);
    const bf2 n2z = __floats2bfloat162_rn(normal[2 * hw + i], depth[i]);
    const float2 c01f = __bfloat1622float2(c01);
    const float2 c2vf = __bfloat1622float2(c2v);
    v.f[0] = c01f.x;
    v.f[1] = c01f.y;
    v.f[2] = c2vf.x;
    v.f[3] = c2vf.y;
    v.a[0] = __low2bfloat16(lum);
    v.a[1] = __low2bfloat16(n01);
    v.a[2] = __high2bfloat16(n01);
    v.a[3] = __low2bfloat16(n2z);
    v.a[4] = __high2bfloat16(n2z);
    return v;
}

// The depth weight's scale rz = 1/(sz2*|zg.(ky, kx)| + eps2) of the two
// lanes (depth gradients (zg00, zg10) and (zg01, zg11)), true float32
// divisions rounded to bf16.
__device__ __forceinline__ bf2 depth_scale_bf16(float zg00, float zg10,
                                                float zg01, float zg11,
                                                float ky, float kx,
                                                const AtrousParams& p) {
    const float rz0 = 1.0f / (p.sz2 * fabsf(zg00 * ky + zg10 * kx) + p.eps2);
    const float rz1 = 1.0f / (p.sz2 * fabsf(zg01 * ky + zg11 * kx) + p.eps2);
    return __floats2bfloat162_rn(rz0, rz1);
}

// fused_sden<false> of the lane pair (x, x + 1) of row y (0 for lane 1
// past the frame's edge), in its operations and order for each lane, from
// one 3 x 4 window of variance loads (the lanes share two columns).
__device__ __forceinline__ float2 fused_sden_pair(
    const float* __restrict__ var, int H, int W, int y, int x, bool in1,
    const AtrousParams& p) {
    const float k1[3] = {0.25f, 0.5f, 0.25f};
    float v[3][4];
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int yy = y + dy, xx = x - 1 + c;
            v[dy + 1][c] = yy >= 0 && yy < H && xx >= 0 && xx < W
                               ? var[yy * W + xx] : 0.0f;
        }
    }
    float num0 = 0.0f, kden0 = 0.0f, num1 = 0.0f, kden1 = 0.0f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
        if (y + dy < 0 || y + dy >= H) continue;
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
            const float k = k1[dy + 1] * k1[dx + 1];
            if (x + dx >= 0 && x + dx < W) {
                num0 = num0 + k * v[dy + 1][dx + 1];
                kden0 = kden0 + k;
            }
            if (x + 1 + dx < W) {
                num1 = num1 + k * v[dy + 1][dx + 2];
                kden1 = kden1 + k;
            }
        }
    }
    return make_float2(
        p.sigma_color * sqrtf(fmaxf(num0 / kden0, 0.0f)) + kEps,
        in1 ? p.sigma_color * sqrtf(fmaxf(num1 / kden1, 0.0f)) + kEps
            : 0.0f);
}

template <int R, bool STAGED, bool STORE, bool FUSED, bool S1>
__global__ void __launch_bounds__(KB_TX * KB_TY) level_bf16_kernel(
    const float* __restrict__ color, const float* __restrict__ var,
    const float* __restrict__ normal, const float* __restrict__ depth,
    const float* __restrict__ zgrad, const float* __restrict__ sden,
    float* __restrict__ sden_out, float* __restrict__ color_out,
    float* __restrict__ var_out, float* __restrict__ w_out,
    float* __restrict__ n_out, AtrousParams p, AtrousBf16 kb,
    const float* __restrict__ wide_taps) {
    constexpr bool WIDE = R < 0;
    // compiled radius: its taps, and the distinct |dz.d| (centre first)
    constexpr int NT = WIDE ? 1 : (2 * R + 1) * (2 * R + 1);
    constexpr int NRZ = NT / 2 + 1;
    const int H = p.H, W = p.W, hw = H * W;
    const int r = WIDE ? p.radius : R;
    const int side = 2 * r + 1;
    const Lattice<K1_TW, K1_TR> L(p.spacing, r);
    const Bf16K k = bf16_k(kb);
    const int tx = threadIdx.x;

    // the staged planes: four float planes, then five bf16 planes (the
    // tile's width is even, so every plane's pairs align alike)
    extern __shared__ float4 smem[];
    const int n = L.sw * L.sh;
    float* s_f = (float*)smem;
    __nv_bfloat16* s_b = (__nv_bfloat16*)(s_f + KB_FWD_F32 * n);
    if (STAGED) {
        const int tid = threadIdx.y * KB_TX + tx;
        for (int j = tid / K1_TW; j < L.sh; j += KB_TX * KB_TY / K1_TW) {
            const int y = L.row(j);
            for (int c = tid % K1_TW; c < L.sw; c += K1_TW) {
                const FwdPixBf16 v = fwd_pixel_bf16(color, var, normal,
                                                    depth, H, W, y, L.col(c),
                                                    k);
                const int e = j * L.sw + c;
#pragma unroll
                for (int q = 0; q < KB_FWD_F32; ++q) s_f[q * n + e] = v.f[q];
#pragma unroll
                for (int q = 0; q < KB_FWD_PLANES; ++q)
                    s_b[q * n + e] = v.a[q];
            }
        }
        __syncthreads();
    }

    const int kl = threadIdx.y;
    const int y = L.out_row(kl), x = L.x0 + 2 * tx;
    if (y >= H || x >= W) return;
    const bool in1 = x + 1 < W;
    const int i = y * W + x;
    // the pair's own luminance, normal and depth (the tap d = 0)
    bf2 c[KB_FWD_PLANES];
    if (STAGED) {
        const int e = L.at(kl, 2 * tx, 0, 0);
#pragma unroll
        for (int q = 0; q < KB_FWD_PLANES; ++q)
            c[q] = lds_pair(s_b + q * n, e, bf16_pair_odd<R, S1>(e, 0));
    } else {
        const FwdPixBf16 a = fwd_pixel_bf16(color, var, normal, depth, H, W,
                                            y, x, k);
        const FwdPixBf16 b = fwd_pixel_bf16(color, var, normal, depth, H, W,
                                            y, x + 1, k);
#pragma unroll
        for (int q = 0; q < KB_FWD_PLANES; ++q)
            c[q] = __halves2bfloat162(a.a[q], b.a[q]);
    }
    const float zg00 = zgrad[i], zg10 = zgrad[hw + i];
    const float zg01 = in1 ? zgrad[i + 1] : 0.0f;
    const float zg11 = in1 ? zgrad[hw + i + 1] : 0.0f;
    float sd0, sd1;
    if (FUSED) {
        const float2 sd = fused_sden_pair(var, H, W, y, x, in1, p);
        sd0 = sd.x;
        sd1 = sd.y;
        if (sden_out) store_pair(sden_out, i, sd0, sd1, in1);
    } else {
        sd0 = sden[i];
        sd1 = in1 ? sden[i + 1] : 0.0f;
    }
    const bf2 isd2 = __floats2bfloat162_rn(kLog2e / fmaxf(sd0, kEps),
                                           kLog2e / fmaxf(sd1, kEps));
    // per thread, before the taps (a compiled radius): rz of each distinct
    // offset, the rows outside the frame included (the tap j = NT/2 + t,
    // dy-major, and its mirror NT/2 - t), h_y*h_x of each |dy|, |dx|, and
    // the lane mask of each column dx
    bf2 rz_t[NRZ], h_t[WIDE ? 1 : (R + 1) * (R + 1)];
    unsigned cmask[WIDE ? 1 : 2 * R + 1];
    if constexpr (!WIDE) {
#pragma unroll
        for (int dx = -R; dx <= R; ++dx) {
            const int ox = dx * L.s;
            cmask[dx + R] = lane_mask(x + ox >= 0 && x + ox < W,
                                      x + 1 + ox >= 0 && x + 1 + ox < W);
        }
#pragma unroll
        for (int t = 0; t < NRZ; ++t) {
            const int j = NT / 2 + t;
            rz_t[t] = depth_scale_bf16(
                zg00, zg10, zg01, zg11, (float)((j / (2 * R + 1) - R) * L.s),
                (float)((j % (2 * R + 1) - R) * L.s), p);
        }
#pragma unroll
        for (int a = 0; a <= R; ++a)
#pragma unroll
            for (int b = 0; b <= R; ++b)
                h_t[a * (R + 1) + b] = tap_h2(p.taps[R + a], p.taps[R + b]);
    }

    float a00 = 0.0f, a01 = 0.0f, a02 = 0.0f, av0 = 0.0f, den0 = 0.0f;
    float a10 = 0.0f, a11 = 0.0f, a12 = 0.0f, av1 = 0.0f, den1 = 0.0f;
#pragma unroll
    for (int dy = -r; dy <= r; ++dy) {
        const int oy = dy * L.s;
        const bool rin = y + oy >= 0 && y + oy < H;
#pragma unroll
        for (int dx = -r; dx <= r; ++dx) {
            const int ox = dx * L.s;
            const int kidx = ((dy + r) * side + (dx + r)) * hw + i;
            // a dropped tap (its lane's half of the mask 0) reads the
            // staged zeros of the frame's outside, weighs +0, and adds
            // exact zeros (a sum starts at +0): the skipped tap's bits.  No
            // branch but at radius 2, where the straight-line taps ran 13 %
            // slower (PERF.md, PR 18)
            unsigned mask = 0u;
            if (rin) {
                if constexpr (WIDE)
                    mask = lane_mask(x + ox >= 0 && x + ox < W,
                                     x + 1 + ox >= 0 && x + 1 + ox < W);
                else
                    mask = cmask[dx + R];
            }
            if (R == 2 && !mask) {
                if (STORE) store_pair(w_out, kidx, 0.0f, 0.0f, in1);
                continue;
            }
            float2 q0, q1, q2, qv;    // colour and variance, both lanes
            bf2 q[KB_FWD_PLANES];
            if (STAGED) {
                const int e = L.at(kl, 2 * tx, dy, dx);
                const bool odd = bf16_pair_odd<R, S1>(e, dx);
                q0 = lds_pair_f32(s_f, e, odd);
                q1 = lds_pair_f32(s_f + n, e, odd);
                q2 = lds_pair_f32(s_f + 2 * n, e, odd);
                qv = lds_pair_f32(s_f + 3 * n, e, odd);
#pragma unroll
                for (int t = 0; t < KB_FWD_PLANES; ++t)
                    q[t] = lds_pair(s_b + t * n, e, odd);
            } else {
                const FwdPixBf16 a = fwd_pixel_bf16(
                    color, var, normal, depth, H, W, y + oy, x + ox, k);
                const FwdPixBf16 b = fwd_pixel_bf16(
                    color, var, normal, depth, H, W, y + oy, x + 1 + ox, k);
                q0 = make_float2(a.f[0], b.f[0]);
                q1 = make_float2(a.f[1], b.f[1]);
                q2 = make_float2(a.f[2], b.f[2]);
                qv = make_float2(a.f[3], b.f[3]);
#pragma unroll
                for (int t = 0; t < KB_FWD_PLANES; ++t)
                    q[t] = __halves2bfloat162(a.a[t], b.a[t]);
            }
            bf2 h, rz;
            if constexpr (!WIDE) {
                const int j = (dy + R) * (2 * R + 1) + (dx + R);
                h = h_t[(dy < 0 ? -dy : dy) * (R + 1) + (dx < 0 ? -dx : dx)];
                rz = rz_t[j >= NT / 2 ? j - NT / 2 : NT / 2 - j];
            } else {
                // |dz.d| of a tap and its mirror is one expression
                const bool pos = dy > 0 || (dy == 0 && dx >= 0);
                h = tap_h2(wide_taps[dy + r], wide_taps[dx + r]);
                rz = depth_scale_bf16(zg00, zg10, zg01, zg11,
                                      (float)(pos ? oy : -oy),
                                      (float)(pos ? ox : -ox), p);
            }
            const bf2 hfm = tap_hfm(h, mask);
            const bf2 wl2 = mul2(neg_abs2(sub2(c[0], q[0])), isd2);
            const bf2 wz2 = mul2(neg_abs2(sub2(c[4], q[4])), rz);
            const bf2 e2 = edge_exp_bf16x2(wz2, wl2, c[1], c[2], c[3], q[1],
                                           q[2], q[3], k);
            const bf2 w = mul2(hfm, e2);
            const float2 hf = bf2_floats(hfm);
            const float2 ef = bf2_floats(e2);
            // h*2^arg exact in float32: N's addend and the stored weight
            const float wf0 = hf.x * ef.x, wf1 = hf.y * ef.y;
            if (STORE) store_pair(w_out, kidx, wf0, wf1, in1);
            den0 = den0 + wf0;
            den1 = den1 + wf1;
            const float2 wr = bf2_floats(w);
            const float2 ww = bf2_floats(mul2(w, w));
            a00 = __fmaf_rn(wr.x, q0.x, a00);
            a01 = __fmaf_rn(wr.x, q1.x, a01);
            a02 = __fmaf_rn(wr.x, q2.x, a02);
            av0 = __fmaf_rn(ww.x, qv.x, av0);
            a10 = __fmaf_rn(wr.y, q0.y, a10);
            a11 = __fmaf_rn(wr.y, q1.y, a11);
            a12 = __fmaf_rn(wr.y, q2.y, a12);
            av1 = __fmaf_rn(ww.y, qv.y, av1);
        }
    }
    // lane 1 past the frame's edge computes and stores nothing
    den0 = fmaxf(den0, kEps);
    den1 = fmaxf(den1, kEps);
    const float inv0 = 1.0f / den0, inv1 = 1.0f / den1;
    store_pair(color_out, i, a00 * inv0, a10 * inv1, in1);
    store_pair(color_out, hw + i, a01 * inv0, a11 * inv1, in1);
    store_pair(color_out, 2 * hw + i, a02 * inv0, a12 * inv1, in1);
    store_pair(var_out, i, av0 * (inv0 * inv0), av1 * (inv1 * inv1), in1);
    store_pair(n_out, i, den0, den1, in1);
}

template <int R, bool STAGED, bool STORE, bool FUSED, bool S1 = false>
cudaError_t launch_level_bf16_kernel(const LevelArgs& a,
                                     const AtrousBf16& kb, size_t bytes) {
    const AtrousParams& p = *a.params;
    auto kernel = level_bf16_kernel<R, STAGED, STORE, FUSED, S1>;
    static size_t opted = 0;
    cudaError_t err = allow_smem(kernel, bytes, opted);
    if (err != cudaSuccess) return err;
    kernel<<<lattice_grid<K1_TW, K1_TR>(p.H, p.W, p.spacing),
             dim3(KB_TX, KB_TY), bytes, a.stream>>>(
        a.color, a.var, a.normal, a.depth, a.zgrad, a.sden, a.sden_out,
        a.color_out, a.var_out, (float*)a.w_out, a.n_out, p, kb,
        a.wide_taps);
    return cudaGetLastError();
}

// A launch at the radius of a.params: 0-2 compiled (1 and 2 apart at
// spacing 1, S1), any other the WIDE instantiation, staged while its tile
// fits kBf16MaxStaged.
template <bool STORE, bool FUSED>
cudaError_t launch_level_bf16_radius(const LevelArgs& a,
                                     const AtrousBf16& kb) {
    const AtrousParams& p = *a.params;
    const size_t staged =
        lattice_entries<K1_TW, K1_TR>(p.spacing, p.radius) * KB_FWD_BYTES;
    if (a.wide_taps) {
        return staged <= kBf16MaxStaged
                   ? launch_level_bf16_kernel<-1, true, STORE, FUSED>(
                         a, kb, staged)
                   : launch_level_bf16_kernel<-1, false, STORE, FUSED>(
                         a, kb, 0);
    }
    switch (p.radius) {
    case 0:
        return launch_level_bf16_kernel<0, true, STORE, FUSED>(a, kb, staged);
    case 1:
        return p.spacing == 1
                   ? launch_level_bf16_kernel<1, true, STORE, FUSED, true>(
                         a, kb, staged)
                   : launch_level_bf16_kernel<1, true, STORE, FUSED>(a, kb,
                                                                     staged);
    case 2:
        return p.spacing == 1
                   ? launch_level_bf16_kernel<2, true, STORE, FUSED, true>(
                         a, kb, staged)
                   : launch_level_bf16_kernel<2, true, STORE, FUSED>(a, kb,
                                                                     staged);
    default:
        return cudaErrorInvalidValue;
    }
}

}  // namespace

template <int R>
cudaError_t launch_level_radius(const LevelArgs& a) {
    const AtrousParams& p = *a.params;
    if (p.fast)
        return p.luma_only ? launch_level_store<R, M_FAST_LUMA>(a)
                           : launch_level_store<R, M_FAST>(a);
    return p.luma_only ? launch_level_store<R, M_EXACT_LUMA>(a)
                       : launch_level_store<R, M_EXACT>(a);
}
