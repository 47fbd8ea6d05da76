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
