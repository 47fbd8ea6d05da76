// Declarations and device helpers shared by the à-trous kernels: atrous.cu
// (the entry points, K2/K2b, K14, K9) and the level forward K1/K1b
// (atrous_level.cuh, instantiated in atrous_level_r*.cu).  See atrous.cu's
// header for the kernels' design.

#pragma once

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
// instantiation, which indexes and masks as if there were no tile.  Both
// instantiations compute the same floats.
struct AtrousTile {
    int Hg, Wg, gy0, gx0;
    int d_rs, d_ps, d_m;    // colour/variance canvas
    int g_rs, g_ps, g_m;    // normal/depth canvas
    int o_m;                // adjoints: the output region's margin
};

// The pointers and parameters of one K1/K1b launch (rdt_atrous_level's
// arguments), handed to the instantiations of each radius.
struct LevelArgs {
    const float *color, *var, *normal, *depth, *zgrad, *sden;
    float *color_out, *var_out;
    void* w_out;
    float* n_out;
    int w_f32;
    const AtrousParams* params;
    const AtrousTile* tile;
    const float* wide_taps;
    cudaStream_t stream;
    // K1b's bf16 form with the sigma denominator fused (sden null): where
    // set, the denominator is written here too (K14's bf16 form reads it)
    float* sden_out;
};

// K1/K1b at radius R (0, 1, 2), or R = -1: any radius, taps in wide_taps;
// defined in atrous_level.cuh, instantiated one radius a source.
template <int R>
cudaError_t launch_level_radius(const LevelArgs& a);

// The constants of K1b's and K14's bf16 forms (ops.atrous.bf16_constants),
// passed by pointer beside AtrousParams (which stays as it is): each a
// float that bfloat16 represents exactly, rounded from the double on the
// host as the JAX package rounds its Python constants.
struct AtrousBf16 {
    float l0, l1, l2, ln2, sixth, floor, sz2, eps2, c_s1, c_s2;
};

// K1b's bf16 form (atrous_level.cuh): a.n_out set, no tile; a.sden set
// (atrous_level_bf16.cu), a.w_out null or float weights; or a.sden null,
// the sigma denominator fused (atrous_level_bf16_fused.cu), a.w_out null,
// a.sden_out null or the plane it is written to.
cudaError_t launch_level_bf16(const LevelArgs& a, const AtrousBf16& kb);
cudaError_t launch_level_bf16_fused(const LevelArgs& a, const AtrousBf16& kb);

namespace {

constexpr float kEps = 1e-8f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kL0 = 0.2126f, kL1 = 0.7152f, kL2 = 0.0722f;

// Rec.709 luminance, rounded op by op (no contraction: --fmad=false).
__device__ __forceinline__ float luma3(float c0, float c1, float c2) {
    return kL0 * c0 + kL1 * c1 + kL2 * c2;
}

__device__ __forceinline__ float luma(const float* c, int i, int hw) {
    return luma3(c[i], c[hw + i], c[2 * hw + i]);
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

// Whether tile pixel (y, x) lies in a canvas of margin m (the image when
// m = 0): the memory a staged entry may be read from.
__device__ __forceinline__ bool in_canvas(int H, int W, int m, int y, int x) {
    return y >= -m && y < H + m && x >= -m && x < W + m;
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

// The row-lattice tile of K1 and K9.  At spacing s = 2^level every tap of
// pixel (y, x) lies on the rows y + k*s, so a block owns the output pixels
// of the TW columns x0 + [0, TW) on the TR lattice rows k0 + [0, TR) of one
// residue rho (image rows rho + s*k).  Its taps then touch TR + 2r rows of
// the same lattice (the row halo is r at every level) and, along a row,
// the columns x0 + dx*s + [0, TW), |dx| <= r: staged as TW + 2r*sp
// columns, sp = min(s, TW) -- one contiguous run while s <= TW, else 2r+1
// runs of TW.  Staged rows and columns are read along the image rows, so
// the loads that fill the tile stay coalesced.
template <int TW, int TR>
struct Lattice {
    int s, r, sp, lsp, sw, sh, x0, k0, rho;

    __device__ __forceinline__ Lattice(int spacing, int radius)
        : s(spacing), r(radius) {
        sp = spacing < TW ? spacing : TW;
        lsp = __ffs(sp) - 1;
        sw = TW + 2 * radius * sp;
        sh = TR + 2 * radius;
        x0 = blockIdx.x * TW;
        k0 = blockIdx.y * TR;
        rho = blockIdx.z;
    }
    // the image row of staged row j and the image column of staged column c
    __device__ __forceinline__ int row(int j) const {
        return rho + s * (k0 - r + j);
    }
    __device__ __forceinline__ int col(int c) const {
        return x0 + ((c >> lsp) - r) * s + (c & (sp - 1));
    }
    // the image row of the block's lattice row kl
    __device__ __forceinline__ int out_row(int kl) const {
        return rho + s * (k0 + kl);
    }
    // the staged entry of the tap (dy, dx) of the output at lattice row kl,
    // column x0 + tx
    __device__ __forceinline__ int at(int kl, int tx, int dy, int dx) const {
        return (kl + dy + r) * sw + tx + (dx + r) * sp;
    }
};

// The grid of a lattice launch: column bands, lattice-row groups of the
// longest residue, residues (a spacing above H leaves the rest empty).
template <int TW, int TR>
dim3 lattice_grid(int H, int W, int spacing) {
    return dim3((W + TW - 1) / TW, ((H + spacing - 1) / spacing + TR - 1) / TR,
                spacing < H ? spacing : H);
}

// Entries of a block's staged tile (0 without staging: radius < 0).
template <int TW, int TR>
size_t lattice_entries(int spacing, int radius) {
    if (radius < 0) return 0;
    const int sp = spacing < TW ? spacing : TW;
    return (size_t)(TW + 2 * radius * sp) * (TR + 2 * radius);
}

// ---------------------------------------------------------------------
// The bf16 forms (K1b, K14 with precision="bf16"): two horizontally
// adjacent pixels a thread, one in each lane of an __nv_bfloat162, every
// operation rounded once to bfloat16 as the TPU kernel's bf16 body rounds
// it (PTX add/sub/mul .rn.bf16x2, which are never contracted into an fma).
using bf2 = __nv_bfloat162;
// Their block: 32 pairs of columns by 8 lattice rows (Lattice<64, 8>).
constexpr int KB_TX = 32, KB_TY = 8;

__device__ __forceinline__ unsigned bf2_bits(bf2 a) {
    return *reinterpret_cast<unsigned*>(&a);
}
__device__ __forceinline__ bf2 bf2_of(unsigned u) {
    return *reinterpret_cast<bf2*>(&u);
}
__device__ __forceinline__ bf2 add2(bf2 a, bf2 b) {
    unsigned d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(bf2_bits(a)),
        "r"(bf2_bits(b)));
    return bf2_of(d);
}
__device__ __forceinline__ bf2 sub2(bf2 a, bf2 b) {
    unsigned d;
    asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(bf2_bits(a)),
        "r"(bf2_bits(b)));
    return bf2_of(d);
}
__device__ __forceinline__ bf2 mul2(bf2 a, bf2 b) {
    unsigned d;
    asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(bf2_bits(a)),
        "r"(bf2_bits(b)));
    return bf2_of(d);
}
// -|a| (exact)
__device__ __forceinline__ bf2 neg_abs2(bf2 a) {
    return bf2_of(bf2_bits(a) | 0x80008000u);
}
__device__ __forceinline__ bf2 bf2_splat(float x) {
    return __float2bfloat162_rn(x);
}

// The bf16 constants as lane pairs, and 1/2, 1, -126 and 255 (all exact
// in bf16).
struct Bf16K {
    bf2 l0, l1, l2, ln2, sixth, floor, sz2, eps2, c_s1, c_s2, half, one,
        m126, c255;
};

__device__ __forceinline__ Bf16K bf16_k(const AtrousBf16& b) {
    return Bf16K{bf2_splat(b.l0), bf2_splat(b.l1), bf2_splat(b.l2),
                 bf2_splat(b.ln2), bf2_splat(b.sixth), bf2_splat(b.floor),
                 bf2_splat(b.sz2), bf2_splat(b.eps2), bf2_splat(b.c_s1),
                 bf2_splat(b.c_s2), bf2_splat(0.5f), bf2_splat(1.0f),
                 bf2_splat(-126.0f), bf2_splat(255.0f)};
}

// 2^y in bfloat16, y <= 0 (the TPU kernel's _exp2_fast_bf16,
// ops.atrous.exp2_fast_bf16): y clamped at -1e4 (its bf16 value), i =
// floor(y + 1/2), the degree-3 Taylor polynomial at z = (y - i)*ln2, times
// 2^i built in the bf16 bit layout (exponent field i + 127, i clipped to
// [-126, 127]).  i <= 0 here, so 2^i comes from the bf16 bits with no
// conversion: t = max(i, -126) + 255 is an integer in [129, 255], exact in
// bf16, whose 7-bit mantissa field is t - 128 = max(i, -126) + 127, the
// exponent field 2^i needs (tests/test_torch_bf16_bits.py enumerates it
// against the clamp of the integer i).
__device__ __forceinline__ bf2 exp2_fast_bf16x2(bf2 y, const Bf16K& k) {
    y = __hmax2(y, k.floor);
    const bf2 yi = h2floor(add2(y, k.half));
    const bf2 z = mul2(sub2(y, yi), k.ln2);
    bf2 p = add2(k.half, mul2(z, k.sixth));
    p = add2(k.one, mul2(z, p));
    p = add2(k.one, mul2(z, p));
    const bf2 t = add2(__hmax2(yi, k.m126), k.c255);
    return mul2(p, bf2_of((bf2_bits(t) & 0x007F007Fu) << 7));
}

// The bf16 tap weight's exponential, 2^(wz2 + wl2 - (c1*s + c2*s^2)) with
// s = |n_a - n_b|^2 (the exp-form normal weight; edge_weight's bf16
// branch, in its operation order).  The weight is hfm times it.
__device__ __forceinline__ bf2 edge_exp_bf16x2(bf2 wz2, bf2 wl2, bf2 a0,
                                               bf2 a1, bf2 a2, bf2 b0,
                                               bf2 b1, bf2 b2,
                                               const Bf16K& k) {
    const bf2 d0 = sub2(a0, b0), d1 = sub2(a1, b1), d2 = sub2(a2, b2);
    const bf2 s = add2(add2(mul2(d0, d0), mul2(d1, d1)), mul2(d2, d2));
    const bf2 arg = sub2(add2(wz2, wl2),
                         add2(mul2(k.c_s1, s), mul2(k.c_s2, mul2(s, s))));
    return exp2_fast_bf16x2(arg, k);
}

// The two lanes of a bf16 pair as floats (exact: each lane's bits moved
// into a float's high half, as __bfloat1622float2 does, in one operation a
// lane).
__device__ __forceinline__ float2 bf2_floats(bf2 a) {
    const unsigned u = bf2_bits(a);
    return make_float2(__uint_as_float(u << 16),
                       __uint_as_float(u & 0xFFFF0000u));
}

// The lane mask of a tap's column pair: 0xFFFF where lane 0's tap lies in
// the frame, 0xFFFF0000 where lane 1's does.
__device__ __forceinline__ unsigned lane_mask(bool m0, bool m1) {
    return (m0 ? 0x0000FFFFu : 0u) | (m1 ? 0xFFFF0000u : 0u);
}

// h = h_y*h_x rounded to bf16 in both lanes (the tap's 2-D weight).
__device__ __forceinline__ bf2 tap_h2(float hy, float hx) {
    return mul2(bf2_splat(hy), bf2_splat(hx));
}

// hfm of a tap for the two lanes: h where the lane's tap lies in the frame
// (its half of lane_mask), else +0 (bits 0).
__device__ __forceinline__ bf2 tap_hfm(bf2 h, unsigned mask) {
    return bf2_of(bf2_bits(h) & mask);
}

// A pair of adjacent bf16 entries of a staged plane: one 4-byte load where
// the pair is aligned, else two.
__device__ __forceinline__ bf2 lds_pair(const __nv_bfloat16* plane, int e,
                                        bool odd) {
    if (!odd) return *reinterpret_cast<const bf2*>(plane + e);
    return __halves2bfloat162(plane[e], plane[e + 1]);
}

// Whether the lane pair at staged entry e of a row-lattice tile, read for
// its tap column dx, is unaligned.  e = row*sw + 2*tx + (dx + r)*sp with sw
// even, so only (dx + r)*sp can be odd: never at a spacing above 1, at
// spacing 1 (S1) where dx + r is odd; a compiled radius (R >= 0) knows it
// at compile time, the WIDE one reads e's low bit.
template <int R, bool S1>
__device__ __forceinline__ bool bf16_pair_odd(int e, int dx) {
    if constexpr (R < 0) return e & 1;
    else return S1 && ((dx + R) & 1);
}

// A pair of adjacent entries of a staged float plane: one 8-byte load
// where the pair is aligned, else two.
__device__ __forceinline__ float2 lds_pair_f32(const float* plane, int e,
                                               bool odd) {
    if (!odd) return *reinterpret_cast<const float2*>(plane + e);
    return make_float2(plane[e], plane[e + 1]);
}

// x rounded to bf16, as a float (the value the float32 sums multiply).
__device__ __forceinline__ float bf16_value(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// The two outputs (a at element k, b at k + 1 where in1) of a lane pair:
// one 8-byte store where k is even, else one or two 4-byte stores.
__device__ __forceinline__ void store_pair(float* __restrict__ out, int k,
                                           float a, float b, bool in1) {
    if (in1 && !(k & 1)) {
        *reinterpret_cast<float2*>(out + k) = make_float2(a, b);
        return;
    }
    out[k] = a;
    if (in1) out[k + 1] = b;
}

// Raise a kernel's dynamic shared-memory limit to ``bytes`` (the default
// leaves 48 KB to static and dynamic shared memory together); ``opted`` is
// the limit already set for that kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& opted) {
    if (bytes <= opted) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) opted = bytes;
    return err;
}

}  // namespace
