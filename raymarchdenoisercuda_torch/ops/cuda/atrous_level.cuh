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
// its tile and halo the nine bf16 values a tap reads (colour, variance,
// luminance, normal, depth), rounded from the f32 planes as they are
// loaded (no separate cast pass over the planes), 18 B a pixel as nine
// planes, so a tap reads nine lane pairs: one 4-byte load each where the
// pair is aligned (spacing >= 2; at spacing 1 every other dx), else two.
// The tap math then runs on both pixels at once in packed bf16 (PTX
// add/sub/mul.rn.bf16x2: each operation rounded once, as the TPU body
// rounds it; no fma where it rounds twice); the depth weight's scale rz =
// 1/(sz2*|dz.d| + eps2) is a true float32 division a lane, rounded to
// bf16 (the TPU kernel's Newton reciprocal from a bf16 seed differs by
// ~2^-16 before that rounding; the twin divides as the kernel does), and
// shared between a tap and its mirror (the same expression).  Sums are
// float32: each lane's weight times its neighbour's value is exact in
// float32 and enters by one fma (the JAX kernel keeps these products
// unrounded: XLA drops their bf16 round trip into the float32 sum; w*w is
// rounded), N adds the weight's exact float32 value h*2^arg.  The end is
// float32: N = max(N, eps), c = sum*(1/N), v = sum_v*(1/N)^2, true
// division.  Bound: memory as K1b's f32 form, 64 B/px (the planes are read
// as f32 and rounded on staging); the lever over it is the instruction
// count (two pixels an instruction in the tap math).  R: 0, 1, 2 at
// compile time, or -1: any radius, taps from wide_taps; STAGED false (a
// WIDE tile above kBf16MaxStaged): each tap reads its two neighbours
// through the caches and rounds them there.
constexpr int KB_FWD_PLANES = 9;         // c0 c1 c2 v lum n0 n1 n2 z
constexpr size_t kBf16MaxStaged = 200 * 1024;

// One pixel's bf16 values for the forward's taps; zero outside the frame.
struct FwdPixBf16 {
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
    v.a[0] = __low2bfloat16(c01);
    v.a[1] = __high2bfloat16(c01);
    v.a[2] = __low2bfloat16(c2v);
    v.a[3] = __high2bfloat16(c2v);
    v.a[4] = __low2bfloat16(lum);
    v.a[5] = __low2bfloat16(n01);
    v.a[6] = __high2bfloat16(n01);
    v.a[7] = __low2bfloat16(n2z);
    v.a[8] = __high2bfloat16(n2z);
    return v;
}

// The lane pairs of a tap's two neighbours.
struct FwdPairBf16 {
    bf2 a[KB_FWD_PLANES];
};

template <int R, bool STAGED, bool STORE>
__global__ void __launch_bounds__(KB_TX * KB_TY) level_bf16_kernel(
    const float* __restrict__ color, const float* __restrict__ var,
    const float* __restrict__ normal, const float* __restrict__ depth,
    const float* __restrict__ zgrad, const float* __restrict__ sden,
    float* __restrict__ color_out, float* __restrict__ var_out,
    float* __restrict__ w_out, float* __restrict__ n_out, AtrousParams p,
    AtrousBf16 kb, const float* __restrict__ wide_taps) {
    constexpr bool WIDE = R < 0;
    const int H = p.H, W = p.W, hw = H * W;
    const int r = WIDE ? p.radius : R;
    const int side = 2 * r + 1;
    const Lattice<K1_TW, K1_TR> L(p.spacing, r);
    const Bf16K k = bf16_k(kb);
    const int tx = threadIdx.x;

    extern __shared__ float4 smem[];
    __nv_bfloat16* s_b = (__nv_bfloat16*)smem;
    const int n = L.sw * L.sh;
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
    // the pair's own values (the tap d = 0)
    FwdPairBf16 c;
    if (STAGED) {
        const int e = L.at(kl, 2 * tx, 0, 0);
#pragma unroll
        for (int q = 0; q < KB_FWD_PLANES; ++q)
            c.a[q] = lds_pair(s_b + q * n, e, e & 1);
    } else {
        const FwdPixBf16 a = fwd_pixel_bf16(color, var, normal, depth, H, W,
                                            y, x, k);
        const FwdPixBf16 b = fwd_pixel_bf16(color, var, normal, depth, H, W,
                                            y, x + 1, k);
#pragma unroll
        for (int q = 0; q < KB_FWD_PLANES; ++q)
            c.a[q] = __halves2bfloat162(a.a[q], b.a[q]);
    }
    const float zg00 = zgrad[i], zg10 = zgrad[hw + i];
    const float zg01 = in1 ? zgrad[i + 1] : 0.0f;
    const float zg11 = in1 ? zgrad[hw + i + 1] : 0.0f;
    const bf2 isd2 = __floats2bfloat162_rn(
        kLog2e / fmaxf(sden[i], kEps),
        kLog2e / fmaxf(in1 ? sden[i + 1] : 0.0f, kEps));

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
            const bool m0 = rin && x + ox >= 0 && x + ox < W;
            const bool m1 = rin && x + 1 + ox >= 0 && x + 1 + ox < W;
            if (!m0 && !m1) {
                if (STORE) {
                    w_out[kidx] = 0.0f;
                    if (in1) w_out[kidx + 1] = 0.0f;
                }
                continue;
            }
            FwdPairBf16 q;
            if (STAGED) {
                const int e = L.at(kl, 2 * tx, dy, dx);
                const bool odd = e & 1;
#pragma unroll
                for (int t = 0; t < KB_FWD_PLANES; ++t)
                    q.a[t] = lds_pair(s_b + t * n, e, odd);
            } else {
                const FwdPixBf16 a = fwd_pixel_bf16(
                    color, var, normal, depth, H, W, y + oy, x + ox, k);
                const FwdPixBf16 b = fwd_pixel_bf16(
                    color, var, normal, depth, H, W, y + oy, x + 1 + ox, k);
#pragma unroll
                for (int t = 0; t < KB_FWD_PLANES; ++t)
                    q.a[t] = __halves2bfloat162(a.a[t], b.a[t]);
            }
            const float hy = WIDE ? wide_taps[dy + r] : p.taps[dy + r];
            const float hx = WIDE ? wide_taps[dx + r] : p.taps[dx + r];
            const bf2 hfm = tap_hfm(hy, hx, m0, m1);
            // |dz.d| of a tap and its mirror is one expression
            const bool pos = dy > 0 || (dy == 0 && dx >= 0);
            const float ky = (float)(pos ? oy : -oy);
            const float kx = (float)(pos ? ox : -ox);
            const float rz0 = 1.0f / (p.sz2 * fabsf(zg00 * ky + zg10 * kx)
                                      + p.eps2);
            const float rz1 = 1.0f / (p.sz2 * fabsf(zg01 * ky + zg11 * kx)
                                      + p.eps2);
            const bf2 rz = __floats2bfloat162_rn(rz0, rz1);
            const bf2 wl2 = mul2(neg_abs2(sub2(c.a[4], q.a[4])), isd2);
            const bf2 wz2 = mul2(neg_abs2(sub2(c.a[8], q.a[8])), rz);
            const bf2 e2 = edge_exp_bf16x2(wz2, wl2, c.a[5], c.a[6], c.a[7],
                                           q.a[5], q.a[6], q.a[7], k);
            const bf2 w = mul2(hfm, e2);
            const float2 hf = __bfloat1622float2(hfm);
            const float2 ef = __bfloat1622float2(e2);
            // h*2^arg exact in float32: N's addend and the stored weight
            const float wf0 = hf.x * ef.x, wf1 = hf.y * ef.y;
            if (STORE) {
                w_out[kidx] = wf0;
                if (in1) w_out[kidx + 1] = wf1;
            }
            den0 = den0 + wf0;
            den1 = den1 + wf1;
            const float2 wr = __bfloat1622float2(w);
            const float2 ww = __bfloat1622float2(mul2(w, w));
            const float2 q0 = __bfloat1622float2(q.a[0]);
            const float2 q1 = __bfloat1622float2(q.a[1]);
            const float2 q2 = __bfloat1622float2(q.a[2]);
            const float2 qv = __bfloat1622float2(q.a[3]);
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
    den0 = fmaxf(den0, kEps);
    const float inv0 = 1.0f / den0;
    color_out[i] = a00 * inv0;
    color_out[hw + i] = a01 * inv0;
    color_out[2 * hw + i] = a02 * inv0;
    var_out[i] = av0 * (inv0 * inv0);
    n_out[i] = den0;
    if (in1) {
        den1 = fmaxf(den1, kEps);
        const float inv1 = 1.0f / den1;
        color_out[i + 1] = a10 * inv1;
        color_out[hw + i + 1] = a11 * inv1;
        color_out[2 * hw + i + 1] = a12 * inv1;
        var_out[i + 1] = av1 * (inv1 * inv1);
        n_out[i + 1] = den1;
    }
}

template <int R, bool STAGED, bool STORE>
cudaError_t launch_level_bf16_kernel(const LevelArgs& a,
                                     const AtrousBf16& kb, size_t bytes) {
    const AtrousParams& p = *a.params;
    auto kernel = level_bf16_kernel<R, STAGED, STORE>;
    static size_t opted = 0;
    cudaError_t err = allow_smem(kernel, bytes, opted);
    if (err != cudaSuccess) return err;
    kernel<<<lattice_grid<K1_TW, K1_TR>(p.H, p.W, p.spacing),
             dim3(KB_TX, KB_TY), bytes, a.stream>>>(
        a.color, a.var, a.normal, a.depth, a.zgrad, a.sden, a.color_out,
        a.var_out, (float*)a.w_out, a.n_out, p, kb, a.wide_taps);
    return cudaGetLastError();
}

template <int R, bool STAGED>
cudaError_t launch_level_bf16_store(const LevelArgs& a, const AtrousBf16& kb,
                                    size_t bytes) {
    return a.w_out ? launch_level_bf16_kernel<R, STAGED, true>(a, kb, bytes)
                   : launch_level_bf16_kernel<R, STAGED, false>(a, kb, bytes);
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
