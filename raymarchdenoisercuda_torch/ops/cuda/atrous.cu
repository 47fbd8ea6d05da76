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
// K1/K1b (atrous_level.cuh, one source a radius: atrous_level_r*.cu) is
// one body specialised at compile time on the radius (0, 1, 2), the weight
// math (fast, fast luminance-only, exact, exact luminance-only), a fused
// or given sigma denominator, the store (none, N, bf16 or float weights
// and N) and the tile form: the tap loops unroll, p.taps is indexed by
// constants, and no mode is tested inside the loop.  A block owns a
// row-lattice tile: 64 columns by 8 lattice rows of one residue modulo the
// spacing s = 2^level, whose taps all lie on the same lattice (Lattice in
// atrous_common.cuh).  It stages, once per pixel of the tile plus its halo
// (r lattice rows, r*min(s, 64) columns a side), colour and variance,
// the luminance (computed once, the same float as the per-tap
// expression), normal and depth: 36 B a pixel in shared memory (20 with
// the luminance-only weights), read with coalesced loads.  The taps then
// read shared memory only; a tap outside the image (tile: the frame) is
// dropped by its coordinate, with a zero stored weight.  Each thread
// computes two pixels (the tile holds 512).  The 3x3 variance blur that
// sets the luminance sigma (K1) and the depth gradient are read through
// the caches (staging them too was slower).  Radius 0 stages nothing (a
// neighbour is read once).  The radius-2 fast weights run with a bound of
// two blocks an SM: ptxas's own choice spilled.  Bit-equality: every
// weight goes through the same operations in the same order (tap_weight,
// exact_tap), every sum adds its taps in the same (dy, dx) order, and a
// value staged once per pixel is the float the per-tap expression gave,
// so the outputs are those of the one-thread-per-pixel kernel this design
// replaced, bit for bit.  Bound on the card: memory would allow 56 B/px
// (inputs once, outputs once), 78 B/px in store mode at radius 1 (bf16
// weights), and for K1b 64 B/px, 100 (r1) or 164 (r2) with float weights;
// the kernel is held by its instructions instead: ~70 a fast tap (a true
// division, the polynomial exp with two conversions), ~130 an exact one.
// Radius > 2 (R = -1, the WIDE instantiation): taps from a device array,
// neighbours read through the caches (a staged tile at r = 3 would need up
// to 226 KB).
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
// dv out).  Design (radius >= 1): K14's row-lattice
// tile (64 columns by 8 lattice rows) laid over the OUTPUT region, whose
// centres p = x - d*2^level lie on the output's own lattice.  A block
// stages once per centre of its tile and halo one float4, (u, u2) =
// (gc0, gc1, gc2, gv) scaled by inv_n = 1/max(N, eps) and inv_n^2: the
// floats each tap's own expression gave, so a tap reads one float4 from
// shared memory and its stored weight, where it read N, gc and gv and
// divided.  The raw planes are staged by cp.async (all of a thread's
// copies in flight at once, no register held) and each thread then scales
// the entries it copied.  The weights are read from device memory: each is
// read once across the grid.  Each thread computes two horizontally
// adjacent outputs, so that one load brings both outputs' weights of a tap
// (a bf16 pair, a float2) where the pair is aligned (not at spacing 1 for
// dx != 0).  Measured on the H100 at 1080p: one output a thread, a warp's
// 2-byte weight loads held the bf16 kernel to ~1.5 TB/s; two outputs 32
// columns or 4 lattice rows apart ran 5-25 % slower, and the tile form of
// the latter up to 30 % slower than its whole frame; staging with plain
// loads and stores, or loading a thread's weights into registers first,
// 10-55 % slower; staged rows split into even and odd columns (no bank
// conflicts for the pairs' reads) 1-4 % slower.  Radius 1, 2 and 3 are
// compiled (the taps unroll); a larger radius runs the same body with the
// radius at run time (R = -1).  The wrapper picks the form
// (utils/tiling.py, adjoint_staged): staged while the tile takes at most
// 56 KB a block up to spacing 16 (four blocks an SM: the weights stream
// from device memory) and 40 KB at spacing 32, which is radius 1 to level
// 5, 2 and 3 to level 4, 4 and 5 to level 3, 8 to level 1; else the
// centres read through the caches, one output a thread in 32 x 8 blocks
// (the kernel this design replaced), as at radius 0, whose one tap reads
// each centre once.  Past those limits the staged form lost at 1080p
// (utils/profile.py forms): a wide spacing leaves a lattice residue's
// last row group part empty while each block stages its whole halo.
// Every sum adds its taps in the same (dy, dx) order, and an out-of-frame
// centre is dropped by its coordinate, so the outputs are bit-equal to
// that kernel's and to the twin's.
//
// K14 replaces _make_level_kernel(mode="bwd") as called by
// atrous_level_bwd_pallas and atrous_level_bwd_canvas: the same gather as
// K2, with each centre's weight recomputed from p's luminance, normal,
// depth, depth gradient and sigma denominator and x's, by exact_tap, the
// function K1's exact weight goes through, so the adjoint is the exact
// transpose of K1's stencil.  Luminance, 1/N, u and u2 are derived in the
// kernel (no PyTorch pass).  Plain twin: atrous_level_bwd_ref.  Bound:
// memory, 76 B/px (colour, normal, depth, zgrad, sigma, N, gc, gv in; dc,
// dv out); ~40 flops a tap, and ~130 instructions (exact_tap's powf, expf
// and two divisions), which hold it.  Design: K1's row-lattice tile (64
// columns by 8 lattice rows) laid over the OUTPUT region (the tile form:
// the centre plus o_m), since the centres p = x - d*2^level of an output
// lie on its own lattice.  A block stages once per centre of its tile and
// halo, with coalesced loads, what every tap of that centre reads: normal
// and depth, u = gc/max(N, eps) and u2 = gv/max(N, eps)^2, luminance
// (luma3, the float the per-tap expression gives), sigma and depth
// gradient, 48 B, so that a tap reads three float4 from shared memory in
// place of ~15 plane reads, a luminance and a 1/N.  x's own luminance,
// depth and normal stay in registers.  Radius 1 and 2 compute two outputs
// a thread (64 x 4 threads); past radius 2 one output a thread (64 x 8):
// two a thread made radius 3 5-16 % slower than the cache-read kernel.
// Specialised at compile time on the radius (0 stages nothing; 1, 2 with
// the taps in the parameters; 3 and 4 with the taps in device memory, the
// rows run as a loop and each row's taps unrolled; -1 any radius) and the
// tile form.  The wrapper picks staged or not (utils/tiling.py,
// adjoint_staged): staged while the tile fits a block up to spacing 16
// (one block of 512 threads an SM still won) and takes at most 110 KB
// (two blocks an SM) at spacing 32, which is radius 1 and 2 to level 5,
// 3-5 to level 4, 8 to level 3; else, and at radius 0, the centres are
// read through the caches, one output a thread (past radius 2 the WIDE
// instantiation, the kernel this design replaced), as K2 for the same
// reason.  Every weight
// goes through exact_tap unchanged and every sum adds its taps in the
// same (dy, dx) order, so the outputs are those of the one-thread-per-
// pixel kernel it replaced, bit for bit.
//
// K9 replaces the TPU package's two weight-gradient kernels, centre and
// neighbour (_make_wgrad_*_kernel, atrous_tpu.py:1196 and :1326), as
// called by atrous_level_wgrad_bwd_pallas: the adjoint of one level
// through its weights.  With A_p(d) = dL/dw_p(d), every input theta gets
// sum A dw/dtheta in two shapes, both gathers without atomics: the centre
// terms, x over its own taps q = x + d (normal, depth, depth gradient,
// sigma and luminance), and the neighbour terms, x as the tap of the
// centres p = x - d (normal, depth, luminance, and the detached data
// stencil of colour and variance, K14's sum).  One kernel, one launch: a
// block owns a row-lattice tile of 32 columns by 8 lattice rows and runs
// two warp groups over it, one thread a pixel in each; the first computes
// the centre terms and hands d_normal, d_depth and d_lum to the second
// through shared memory, the second computes the neighbour terms, adds
// them in the order of the two-kernel form it replaced (d_lum = centre +
// neighbour, then folded into d_color by the Rec.709 weights) and writes
// the outputs; no partial plane goes through device memory.  One thread
// doing both passes held both passes' accumulators and its own values at
// once: ptxas gave it 64 registers with spills, or fewer blocks an SM,
// and it lost to the two kernels at radius 2 and above.  Both groups read
// one staged tile: colour and variance, normal and depth, luminance,
// sigma, 1/sigma and 1/max(N, eps), the cotangents, the forward's outputs
// and the depth gradient, 88 B a pixel (u = gc/N' and u2 = gv/N'^2 are one
// multiply a tap from these, the same floats); a tile above 110 KB (two
// blocks an SM; radius 3 at spacing 16) and radius 0 read through the
// caches instead.  Radius 2 runs its rows as a loop (unrolled, its 25
// taps spilled more).  The weights are K1's exact ones (expf, powf), not
// the TPU's polynomial exp and Newton reciprocals; the derivative of |.|
// at 0 is 0.  Plain twin: atrous_level_wgrad_bwd_ref.  Bound: 124 B/px of
// inputs and outputs, and ~169 flops a tap (two exact weights), so the
// float32 rate from radius 2; the kernel is held by its instructions
// (~4100 a pixel at radius 1: divisions, powf, expf) and their latency.
//
// Radius: K1/K1b, K14 and K9 take any r >= 0 ((2r+1) taps a row, from
// _spline_taps).  Up to r = 2 the 1-D taps ride in AtrousParams.taps[5];
// a larger radius passes them as a small device array (wide_taps) and runs
// the kernels' WIDE instantiation.  K2/K2b read their stored weights and
// need no taps.

#include "atrous_common.cuh"

namespace {

__device__ __forceinline__ float sgnf(float x) {
    return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

__device__ __forceinline__ float load_w(const __nv_bfloat16* w, int k) {
    return __bfloat162float(w[k]);
}
__device__ __forceinline__ float load_w(const float* w, int k) { return w[k]; }

// f(dy) for dy = -r..r: unrolled, or (ROLL) as a loop, which keeps fewer
// taps' values live at once.
template <bool ROLL, typename F>
__device__ __forceinline__ void for_rows(int r, F&& f) {
    if constexpr (ROLL) {
#pragma unroll 1
        for (int dy = -r; dy <= r; ++dy) f(dy);
    } else {
#pragma unroll
        for (int dy = -r; dy <= r; ++dy) f(dy);
    }
}

dim3 grid_for(int H, int W, dim3 block) {
    return dim3((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
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

// K2 (WT = bf16) and K2b (WT = float), the centres read through the
// caches: radius R (0) at compile time, or (R = -1) any radius r.
template <typename WT, int R, bool TILE>
__global__ void atrous_bwd_stored_kernel(const WT* __restrict__ w,
                                         const float* __restrict__ norm,
                                         const float* __restrict__ gc,
                                         const float* __restrict__ gv,
                                         float* __restrict__ dc,
                                         float* __restrict__ dv,
                                         int H, int W, int spacing, int r_,
                                         AtrousTile t) {
    // output pixel (yo, xo) of the centre-plus-o_m region is tile pixel
    // (y, x); its centres p = x - d lie in the tile (their weights hold the
    // border mask)
    const int r = R < 0 ? r_ : R;
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

// K14's block: 64 columns by 8 lattice rows of outputs; staged at radius
// 1 and 2, K1's 64 x 4 threads, two lattice rows a thread, else 64 x 8
// threads, one each.
constexpr int K14_TW = 64, K14_TR = 8;
template <int R, bool STAGED>
struct K14Rows {
    // lattice rows a thread, thread rows a block
    static constexpr int PY = STAGED && (R == 1 || R == 2) ? 2 : 1;
    static constexpr int TY = K14_TR / PY;
    static constexpr int THREADS = K14_TW * TY;
};
// bytes a staged centre: three float4
constexpr int K14_STAGED_BYTES = 48;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src));
}

// The two weights of tap plane k at the horizontally adjacent centres
// (py, px) and (py, px + 1), each read only where in0 / in1 (the other is
// 0): one 4-byte (bf16) or 8-byte (float) load where both are wanted and
// the pair is aligned, else one load each.
__device__ __forceinline__ float2 load_w2(const __nv_bfloat16* w, int idx,
                                          bool in0, bool in1) {
    if (in0 && in1 && !((size_t)(w + idx) & 3)) {
        const __nv_bfloat162 v = *(const __nv_bfloat162*)(w + idx);
        return make_float2(__low2float(v), __high2float(v));
    }
    return make_float2(in0 ? load_w(w, idx) : 0.0f,
                       in1 ? load_w(w, idx + 1) : 0.0f);
}
__device__ __forceinline__ float2 load_w2(const float* w, int idx, bool in0,
                                          bool in1) {
    if (in0 && in1 && !((size_t)(w + idx) & 7))
        return *(const float2*)(w + idx);
    return make_float2(in0 ? w[idx] : 0.0f, in1 ? w[idx + 1] : 0.0f);
}

// K2/K2b's block: 64 columns by 8 lattice rows of outputs (K14's tile), 32
// x 8 threads, each computing two horizontally adjacent outputs.
constexpr int K2_TX = 32, K2_TY = 8;

// Stage (u, u2) of the block's centres: raw gc, gv and N by cp.async (no
// register holds them in flight), then each thread scales the entries it
// copied: u = gc * inv_n, u2 = gv * (inv_n * inv_n), inv_n = 1/max(N, eps),
// the floats of the per-tap expression.  The block's 256 threads walk the
// staged tile as 64 columns by 4 rows, so that a warp reads one run of a
// staged row.  A centre outside the tile is never read (its taps are
// dropped by their coordinate): zero.
__device__ __forceinline__ void stage_u(float4* s_u, float* s_n,
                                        const Lattice<K14_TW, K14_TR>& L,
                                        const float* __restrict__ norm,
                                        const float* __restrict__ gc,
                                        const float* __restrict__ gv, int H,
                                        int W, int om) {
    const int hw = H * W;
    const int tid = threadIdx.y * blockDim.x + threadIdx.x;
    const int c0 = tid % K14_TW, j0 = tid / K14_TW;
    constexpr int kRows = K2_TX * K2_TY / K14_TW;
    for (int j = j0; j < L.sh; j += kRows) {
        const int py = L.row(j) - om;
        for (int c = c0; c < L.sw; c += K14_TW) {
            const int px = L.col(c) - om;
            const int e = j * L.sw + c;
            if (py >= 0 && py < H && px >= 0 && px < W) {
                const int q = py * W + px;
                float* u = (float*)(s_u + e);
                cp_async4(u, gc + q);
                cp_async4(u + 1, gc + hw + q);
                cp_async4(u + 2, gc + 2 * hw + q);
                cp_async4(u + 3, gv + q);
                cp_async4(s_n + e, norm + q);
            } else {
                s_u[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                s_n[e] = 1.0f;
            }
        }
    }
    // a thread's own copies are visible to it once they complete
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    for (int j = j0; j < L.sh; j += kRows) {
        for (int c = c0; c < L.sw; c += K14_TW) {
            const int e = j * L.sw + c;
            const float inv_n = 1.0f / fmaxf(s_n[e], kEps);
            const float4 g = s_u[e];
            s_u[e] = make_float4(g.x * inv_n, g.y * inv_n, g.z * inv_n,
                                 g.w * (inv_n * inv_n));
        }
    }
    __syncthreads();
}

// K2/K2b at radius R (1, 2, 3; -1: any radius r_ >= 1) on K14's
// row-lattice tile over the output region (see the header).
template <typename WT, int R, bool TILE>
__global__ void __launch_bounds__(K2_TX * K2_TY)
    atrous_bwd_stored_staged_kernel(const WT* __restrict__ w,
                                    const float* __restrict__ norm,
                                    const float* __restrict__ gc,
                                    const float* __restrict__ gv,
                                    float* __restrict__ dc,
                                    float* __restrict__ dv, int H, int W,
                                    int spacing, int r_, AtrousTile t) {
    const int r = R < 0 ? r_ : R;
    const int side = 2 * r + 1;
    const int hw = H * W;
    const int om = TILE ? t.o_m : 0;
    const int Ho = H + 2 * om, Wo = W + 2 * om, hwo = Ho * Wo;
    // the lattice of the output region: its staged rows and columns are
    // output coordinates, a centre's tile coordinates those less om
    const Lattice<K14_TW, K14_TR> L(spacing, r);
    const int tx = threadIdx.x, kl = threadIdx.y;
    extern __shared__ float4 s_u[];
    stage_u(s_u, (float*)(s_u + L.sw * L.sh), L, norm, gc, gv, H, W, om);

    // outputs (yo, xo) and (yo, xo + 1)
    const int yo = L.out_row(kl), xo = L.x0 + 2 * tx;
    if (yo >= Ho || xo >= Wo) return;
    const bool two = xo + 1 < Wo;
    const int y = yo - om, x = xo - om;
    float a0[2] = {0.0f, 0.0f}, a1[2] = {0.0f, 0.0f}, a2[2] = {0.0f, 0.0f},
          av[2] = {0.0f, 0.0f};
#pragma unroll
    for (int dy = -r; dy <= r; ++dy) {
        const int py = y - dy * L.s;
        if (py < 0 || py >= H) continue;
#pragma unroll
        for (int dx = -r; dx <= r; ++dx) {
            const int px = x - dx * L.s;
            const bool in0 = px >= 0 && px < W;
            const bool in1 = two && px + 1 >= 0 && px + 1 < W;
            if (!in0 && !in1) continue;
            const int k = (dy + r) * side + (dx + r);
            const float2 wk = load_w2(w, k * hw + py * W + px, in0, in1);
            const int e = L.at(kl, 2 * tx, -dy, -dx);
            if (in0) {
                const float4 u = s_u[e];
                a0[0] = a0[0] + wk.x * u.x;
                a1[0] = a1[0] + wk.x * u.y;
                a2[0] = a2[0] + wk.x * u.z;
                av[0] = av[0] + (wk.x * wk.x) * u.w;
            }
            if (in1) {
                const float4 u = s_u[e + 1];
                a0[1] = a0[1] + wk.y * u.x;
                a1[1] = a1[1] + wk.y * u.y;
                a2[1] = a2[1] + wk.y * u.z;
                av[1] = av[1] + (wk.y * wk.y) * u.w;
            }
        }
    }
    const int i = yo * Wo + xo;
    if (two && !(((size_t)(dc + i) | (size_t)(dc + hwo + i)
                  | (size_t)(dv + i)) & 7)) {
        *(float2*)(dc + i) = make_float2(a0[0], a0[1]);
        *(float2*)(dc + hwo + i) = make_float2(a1[0], a1[1]);
        *(float2*)(dc + 2 * hwo + i) = make_float2(a2[0], a2[1]);
        *(float2*)(dv + i) = make_float2(av[0], av[1]);
    } else {
        dc[i] = a0[0];
        dc[hwo + i] = a1[0];
        dc[2 * hwo + i] = a2[0];
        dv[i] = av[0];
        if (two) {
            dc[i + 1] = a0[1];
            dc[hwo + i + 1] = a1[1];
            dc[2 * hwo + i + 1] = a2[1];
            dv[i + 1] = av[1];
        }
    }
}

// K2/K2b's arguments, handed to the instantiation a launch picks.
struct StoredArgs {
    const void* w;
    const float *norm, *gc, *gv;
    float *dc, *dv;
    int H, W, spacing, radius;
};

template <typename WT, int R, bool TILE>
cudaError_t launch_stored_staged(const StoredArgs& a, const AtrousTile& t,
                                 cudaStream_t s) {
    const int Ho = a.H + 2 * t.o_m, Wo = a.W + 2 * t.o_m;
    auto kernel = atrous_bwd_stored_staged_kernel<WT, R, TILE>;
    const size_t bytes = lattice_entries<K14_TW, K14_TR>(a.spacing, a.radius)
                         * (sizeof(float4) + sizeof(float));
    static size_t opted = 0;
    cudaError_t err = allow_smem(kernel, bytes, opted);
    if (err != cudaSuccess) return err;
    kernel<<<lattice_grid<K14_TW, K14_TR>(Ho, Wo, a.spacing),
             dim3(K2_TX, K2_TY), bytes, s>>>(
        (const WT*)a.w, a.norm, a.gc, a.gv, a.dc, a.dv, a.H, a.W, a.spacing,
        a.radius, t);
    return cudaGetLastError();
}

template <typename WT, int R, bool TILE>
cudaError_t launch_stored_cached(const StoredArgs& a, const AtrousTile& t,
                                 cudaStream_t s) {
    const int Ho = a.H + 2 * t.o_m, Wo = a.W + 2 * t.o_m;
    dim3 block(32, 8);
    atrous_bwd_stored_kernel<WT, R, TILE><<<grid_for(Ho, Wo, block), block,
                                            0, s>>>(
        (const WT*)a.w, a.norm, a.gc, a.gv, a.dc, a.dv, a.H, a.W, a.spacing,
        a.radius, t);
    return cudaGetLastError();
}

// staged: the form the wrapper picked; radius 0 has nothing to stage
template <typename WT, bool TILE>
cudaError_t launch_stored_radius(const StoredArgs& a, const AtrousTile& t,
                                 bool staged, cudaStream_t s) {
    if (!staged) {
        return a.radius == 0 ? launch_stored_cached<WT, 0, TILE>(a, t, s)
                             : launch_stored_cached<WT, -1, TILE>(a, t, s);
    }
    switch (a.radius) {
    case 0: return cudaErrorInvalidValue;
    case 1: return launch_stored_staged<WT, 1, TILE>(a, t, s);
    case 2: return launch_stored_staged<WT, 2, TILE>(a, t, s);
    case 3: return launch_stored_staged<WT, 3, TILE>(a, t, s);
    default: return launch_stored_staged<WT, -1, TILE>(a, t, s);
    }
}

// What K14's taps read of a centre p: normal and depth; u = gc/N' and
// u2 = gv/N'^2 (N' = max(N, eps)); luminance, sigma, depth gradient.
struct BwdCentre {
    float4 nz, u, ls;
};

template <bool TILE>
__device__ __forceinline__ BwdCentre bwd_centre(
    const float* __restrict__ color, const float* __restrict__ normal,
    const float* __restrict__ depth, const float* __restrict__ zgrad,
    const float* __restrict__ sden, const float* __restrict__ norm,
    const float* __restrict__ gc, const float* __restrict__ gv,
    const AtrousTile& t, int W, int hw, int dp, int gp, int py, int px) {
    BwdCentre v;
    const int c = py * W + px;
    const int dq = didx<TILE>(t, W, py, px), gq = gidx<TILE>(t, W, py, px);
    v.nz = make_float4(normal[gq], normal[gp + gq], normal[2 * gp + gq],
                       depth[gq]);
    const float inv_n = 1.0f / fmaxf(norm[c], kEps);
    v.u = make_float4(gc[c] * inv_n, gc[hw + c] * inv_n,
                      gc[2 * hw + c] * inv_n, gv[c] * (inv_n * inv_n));
    v.ls = make_float4(luma(color, dq, dp), sden[c], zgrad[c],
                       zgrad[hw + c]);
    return v;
}

// K14: the recompute adjoint (see the header).  Exact, full weights only.
// R: the radius (0-2 taps in the parameters, 3 and 4 in wide_taps), or -1
// (any radius, taps in wide_taps); STAGED: the centres staged over the
// block's lattice tile, else read through the caches.  Output pixel (yo,
// xo) of the centre-plus-o_m region is tile pixel (y, x); its centres p =
// x - d lie in the tile, and a centre's tap to x was dropped in the
// forward when (y, x) lies outside the frame, so such a pixel gets zero.
template <int R, bool STAGED, bool TILE>
__global__ void __launch_bounds__(K14Rows<R, STAGED>::THREADS)
    atrous_bwd_kernel(const float* __restrict__ color,
                      const float* __restrict__ normal,
                      const float* __restrict__ depth,
                      const float* __restrict__ zgrad,
                      const float* __restrict__ sden,
                      const float* __restrict__ norm,
                      const float* __restrict__ gc,
                      const float* __restrict__ gv, float* __restrict__ dc,
                      float* __restrict__ dv, AtrousParams p, AtrousTile t,
                      const float* __restrict__ wide_taps) {
    constexpr bool WIDE = R < 0;
    constexpr int PY = K14Rows<R, STAGED>::PY, TY = K14Rows<R, STAGED>::TY;
    const int H = p.H, W = p.W, hw = H * W;
    const int om = TILE ? t.o_m : 0;
    const int Ho = H + 2 * om, Wo = W + 2 * om, hwo = Ho * Wo;
    const int dp = TILE ? t.d_ps : hw, gp = TILE ? t.g_ps : hw;
    const int r = WIDE ? p.radius : R;
    // the lattice of the output region: its staged rows and columns are
    // output coordinates, a centre's tile coordinates those less om
    const Lattice<K14_TW, K14_TR> L(p.spacing, r);
    const int tx = threadIdx.x;

    extern __shared__ float4 smem[];
    const int n = L.sw * L.sh;
    float4 *s_nz = smem, *s_u = smem + n, *s_ls = smem + 2 * n;
    if (STAGED) {
        for (int j = threadIdx.y; j < L.sh; j += TY) {
            const int py = L.row(j) - om;
            for (int c = tx; c < L.sw; c += K14_TW) {
                const int px = L.col(c) - om;
                // a centre outside the tile is never read (its taps are
                // dropped by their coordinate)
                const BwdCentre v =
                    py >= 0 && py < H && px >= 0 && px < W
                        ? bwd_centre<TILE>(color, normal, depth, zgrad, sden,
                                           norm, gc, gv, t, W, hw, dp, gp,
                                           py, px)
                        : BwdCentre{};
                const int e = j * L.sw + c;
                s_nz[e] = v.nz;
                s_u[e] = v.u;
                s_ls[e] = v.ls;
            }
        }
        __syncthreads();
    }

#pragma unroll 1
    for (int jj = 0; jj < PY; ++jj) {
        const int kl = threadIdx.y + jj * TY;
        const int yo = L.out_row(kl), xo = L.x0 + tx;
        if (yo >= Ho || xo >= Wo) continue;
        const int i = yo * Wo + xo;
        const int y = yo - om, x = xo - om;
        float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc_v = 0.0f;
        if (!TILE || (row_in<TILE>(t, H, y) && col_in<TILE>(t, W, x))) {
            const int dx_ = didx<TILE>(t, W, y, x),
                      gx_ = gidx<TILE>(t, W, y, x);
            const float lum_x = luma(color, dx_, dp);
            const float z_x = depth[gx_];
            const float n0 = normal[gx_], n1 = normal[gp + gx_],
                        n2 = normal[2 * gp + gx_];
            // centre p = x - d's weight for its tap (oy, ox), whose
            // neighbour is x, into the sums (p in the tile's rows)
            auto tap = [&](int dy, int dx) {
                const int oy = dy * L.s, ox = dx * L.s;
                const int py = y - oy, px = x - ox;
                if (px < 0 || px >= W) return;
                BwdCentre q;
                if (STAGED) {
                    const int e = L.at(kl, tx, -dy, -dx);
                    q.nz = s_nz[e];
                    q.u = s_u[e];
                    q.ls = s_ls[e];
                } else {
                    q = bwd_centre<TILE>(color, normal, depth, zgrad, sden,
                                         norm, gc, gv, t, W, hw, dp, gp, py,
                                         px);
                }
                // taps in the parameters up to radius 2, else in wide_taps
                // (read a tap: the cached loads cost less than the
                // registers that would hold them)
                const float h =
                    tap_h<(R < 0 || R > 2)>(p, wide_taps, dy + r, dx + r);
                const float wk = exact_tap(
                    h, q.ls.x, lum_x, q.ls.y, q.nz.w, z_x, q.ls.z, q.ls.w,
                    oy, ox, q.nz.x, q.nz.y, q.nz.z, n0, n1, n2, p).w;
                acc0 = acc0 + wk * q.u.x;
                acc1 = acc1 + wk * q.u.y;
                acc2 = acc2 + wk * q.u.z;
                acc_v = acc_v + (wk * wk) * q.u.w;
            };
            if constexpr (R >= 0 && R <= 2) {
#pragma unroll
                for (int dy = -r; dy <= r; ++dy) {
                    const int py = y - dy * L.s;
                    if (py < 0 || py >= H) continue;
#pragma unroll
                    for (int dx = -r; dx <= r; ++dx) tap(dy, dx);
                }
            } else {
                // past radius 2 the rows run as a loop (fewer taps' values
                // live: ptxas spilled 280 B of the radius-3 tile form
                // unrolled); the columns unroll at a compiled radius, by 4
                // in the staged form at any radius (rolled, ptxas kept it to
                // 40 registers and spilled 16 B) and not in the cache-read
                // form (by 4 it took 58 registers and ran 10-16 % slower)
                constexpr int COLS = R > 2 ? 2 * R + 1 : STAGED ? 4 : 1;
#pragma unroll 1
                for (int dy = -r; dy <= r; ++dy) {
                    const int py = y - dy * L.s;
                    if (py < 0 || py >= H) continue;
#pragma unroll (COLS)
                    for (int dx = -r; dx <= r; ++dx) tap(dy, dx);
                }
            }
        }
        dc[i] = acc0;
        dc[hwo + i] = acc1;
        dc[2 * hwo + i] = acc2;
        dv[i] = acc_v;
    }
}

// K14's arguments, handed to the instantiation a launch picks.
struct BwdArgs {
    const float *color, *normal, *depth, *zgrad, *sden, *norm, *gc, *gv;
    float *dc, *dv;
    const float* wide_taps;
};

template <int R, bool STAGED, bool TILE>
cudaError_t launch_bwd(const BwdArgs& a, const AtrousParams& p,
                       const AtrousTile& t, cudaStream_t s) {
    auto kernel = atrous_bwd_kernel<R, STAGED, TILE>;
    const size_t bytes = STAGED ? lattice_entries<K14_TW, K14_TR>(
                                      p.spacing, p.radius) * K14_STAGED_BYTES
                                : 0;
    static size_t opted = 0;
    cudaError_t err = allow_smem(kernel, bytes, opted);
    if (err != cudaSuccess) return err;
    const int om = TILE ? t.o_m : 0;
    kernel<<<lattice_grid<K14_TW, K14_TR>(p.H + 2 * om, p.W + 2 * om,
                                          p.spacing),
             dim3(K14_TW, K14Rows<R, STAGED>::TY), bytes, s>>>(
        a.color, a.normal, a.depth, a.zgrad, a.sden, a.norm, a.gc, a.gv,
        a.dc, a.dv, p, t, a.wide_taps);
    return cudaGetLastError();
}

template <int R, bool STAGED>
cudaError_t launch_bwd_tile(const BwdArgs& a, const AtrousParams& p,
                            const AtrousTile* tile, cudaStream_t s) {
    return tile ? launch_bwd<R, STAGED, true>(a, p, *tile, s)
                : launch_bwd<R, STAGED, false>(a, p, AtrousTile{}, s);
}

// ---------------------------------------------------------------------
// K14's bf16 form (precision="bf16"; _make_level_kernel(mode="bwd",
// dtype=jnp.bfloat16) as called by atrous_level_bwd_pallas): the adjoint of
// K1b's bf16 stencil, weights recomputed in bf16.  Plain twin:
// atrous_level_bwd_ref(..., precision="bf16").  Design: K1b-bf16's (the
// row-lattice tile over the output, 32 x 8 threads, two adjacent outputs a
// thread in the lanes of an __nv_bfloat162).  A block stages once per
// centre of its tile and halo the values its taps read, rounded from what
// the TPU kernel's wrapper computes in float32 before casting: u =
// gc/max(N, eps) and u2 = gv/max(N, eps)^2 (true divisions) as float32
// values already rounded to bf16 (four float planes: they feed only the
// float32 fmas, so a tap reads them with no unpacking), and luminance
// (luma3), normal, depth, log2(e)/max(sigma, eps) and depth gradient as
// eight bf16 planes: 32 B a centre.  The sigma is the one K1b-bf16 read or
// (fused) wrote.  Per tap: dz2 = sz2*|dz_p.d| + eps2 in bf16 (d in bf16,
// converted once a thread at a compiled radius) and rz its bf16 quotient:
// the reciprocal by rcp.approx.f32 (no .ftz; 1 ulp), rounded to bf16,
// which equals the correctly rounded reciprocal rounded to bf16 for every
// positive bf16 dz2 (the exact 1/dz2 lies > 128 float32 ulps from every
// bf16 rounding midpoint: tests/test_torch_bf16_bits.py; the card test
// test_bf16_bit_formulas_equal_on_every_pattern checks the two device
// formulas on all 65,536 patterns); then the weight as in K1b-bf16, and
// each lane's w*u_p and (w*w)*u2_p (w*w rounded) by one float32 fma.
// h_y*h_x in bf16 and the lane masks of the columns once a thread, as in
// K1b-bf16; a dropped centre is masked, not skipped, and radius 1 and 2
// compile spacing 1 apart (S1).  Bound: memory as K14, 76 B/px.  R: 0, 1,
// 2, or -1 (wide_taps; the offsets converted a tap); STAGED false for a
// WIDE tile above kBf16BwdMaxStaged.
constexpr int KB_BWD_F32 = 4;       // u0 u1 u2 uv, rounded to bf16
constexpr int KB_BWD_PLANES = 8;    // lum n0 n1 n2 z isd2 zg0 zg1
constexpr size_t KB_BWD_BYTES =
    KB_BWD_F32 * sizeof(float) + KB_BWD_PLANES * sizeof(__nv_bfloat16);
constexpr size_t kBf16BwdMaxStaged = 220 * 1024;

struct BwdPixBf16 {
    float f[KB_BWD_F32];
    __nv_bfloat16 a[KB_BWD_PLANES];
};

__device__ __forceinline__ BwdPixBf16 bwd_centre_bf16(
    const float* __restrict__ color, const float* __restrict__ normal,
    const float* __restrict__ depth, const float* __restrict__ zgrad,
    const float* __restrict__ sden, const float* __restrict__ norm,
    const float* __restrict__ gc, const float* __restrict__ gv, int H, int W,
    int y, int x) {
    BwdPixBf16 v;
    if (y < 0 || y >= H || x < 0 || x >= W) {
        const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
#pragma unroll
        for (int q = 0; q < KB_BWD_F32; ++q) v.f[q] = 0.0f;
#pragma unroll
        for (int q = 0; q < KB_BWD_PLANES; ++q) v.a[q] = zero;
        return v;
    }
    const int hw = H * W, i = y * W + x;
    const float inv_n = 1.0f / fmaxf(norm[i], kEps);
    const float vals[KB_BWD_PLANES] = {
        luma(color, i, hw), normal[i], normal[hw + i], normal[2 * hw + i],
        depth[i], kLog2e / fmaxf(sden[i], kEps), zgrad[i], zgrad[hw + i]};
#pragma unroll
    for (int q = 0; q < KB_BWD_PLANES; ++q)
        v.a[q] = __float2bfloat16_rn(vals[q]);
    v.f[0] = bf16_value(gc[i] * inv_n);
    v.f[1] = bf16_value(gc[hw + i] * inv_n);
    v.f[2] = bf16_value(gc[2 * hw + i] * inv_n);
    v.f[3] = bf16_value(gv[i] * (inv_n * inv_n));
    return v;
}

// rcp.approx.f32 without .ftz: within 1 ulp of 1/x, subnormals kept.
__device__ __forceinline__ float rcp_approx(float x) {
    float r;
    asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}

// The bf16 quotient 1/dz2 of both lanes (see K14-bf16's design).
__device__ __forceinline__ bf2 rcp_bf16x2(bf2 dz2) {
    const float2 f = bf2_floats(dz2);
    return __floats2bfloat162_rn(rcp_approx(f.x), rcp_approx(f.y));
}

template <int R, bool STAGED, bool S1>
__global__ void __launch_bounds__(KB_TX * KB_TY) atrous_bwd_bf16_kernel(
    const float* __restrict__ color, const float* __restrict__ normal,
    const float* __restrict__ depth, const float* __restrict__ zgrad,
    const float* __restrict__ sden, const float* __restrict__ norm,
    const float* __restrict__ gc, const float* __restrict__ gv,
    float* __restrict__ dc, float* __restrict__ dv, AtrousParams p,
    AtrousBf16 kb, const float* __restrict__ wide_taps) {
    constexpr bool WIDE = R < 0;
    const int H = p.H, W = p.W, hw = H * W;
    const int r = WIDE ? p.radius : R;
    const Lattice<K14_TW, K14_TR> L(p.spacing, r);
    const Bf16K k = bf16_k(kb);
    const int tx = threadIdx.x;

    // four float planes, then eight bf16 planes (an even tile width: every
    // plane's pairs align alike)
    extern __shared__ float4 smem[];
    const int n = L.sw * L.sh;
    float* s_f = (float*)smem;
    __nv_bfloat16* s_b = (__nv_bfloat16*)(s_f + KB_BWD_F32 * n);
    if (STAGED) {
        const int tid = threadIdx.y * KB_TX + tx;
        for (int j = tid / K14_TW; j < L.sh; j += KB_TX * KB_TY / K14_TW) {
            const int y = L.row(j);
            for (int c = tid % K14_TW; c < L.sw; c += K14_TW) {
                const BwdPixBf16 v = bwd_centre_bf16(
                    color, normal, depth, zgrad, sden, norm, gc, gv, H, W, y,
                    L.col(c));
                const int e = j * L.sw + c;
#pragma unroll
                for (int q = 0; q < KB_BWD_F32; ++q) s_f[q * n + e] = v.f[q];
#pragma unroll
                for (int q = 0; q < KB_BWD_PLANES; ++q)
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
    // the outputs' own luminance, normal and depth (staged at d = 0)
    bf2 own[5];
    if (STAGED) {
        const int e = L.at(kl, 2 * tx, 0, 0);
#pragma unroll
        for (int q = 0; q < 5; ++q)
            own[q] = lds_pair(s_b + q * n, e, bf16_pair_odd<R, S1>(e, 0));
    } else {
        const BwdPixBf16 a = bwd_centre_bf16(color, normal, depth, zgrad,
                                             sden, norm, gc, gv, H, W, y, x);
        const BwdPixBf16 b = bwd_centre_bf16(color, normal, depth, zgrad,
                                             sden, norm, gc, gv, H, W, y,
                                             x + 1);
#pragma unroll
        for (int q = 0; q < 5; ++q)
            own[q] = __halves2bfloat162(a.a[q], b.a[q]);
    }
    // a compiled radius, once a thread: the tap offsets d*s in bf16 (exact:
    // r <= 2 times a power of two), h_y*h_x of each |dy|, |dx| (the taps
    // are symmetric) and the lane mask of each column dx (its centres')
    bf2 off[WIDE ? 1 : 2 * R + 1], h_t[WIDE ? 1 : (R + 1) * (R + 1)];
    unsigned cmask[WIDE ? 1 : 2 * R + 1];
    if constexpr (!WIDE) {
#pragma unroll
        for (int dx = -R; dx <= R; ++dx) {
            const int ox = dx * L.s;
            cmask[dx + R] = lane_mask(x - ox >= 0 && x - ox < W,
                                      x + 1 - ox >= 0 && x + 1 - ox < W);
        }
#pragma unroll
        for (int d = -R; d <= R; ++d) off[d + R] = bf2_splat((float)(d * L.s));
#pragma unroll
        for (int a = 0; a <= R; ++a)
#pragma unroll
            for (int b = 0; b <= R; ++b)
                h_t[a * (R + 1) + b] = tap_h2(p.taps[R + a], p.taps[R + b]);
    }

    float a00 = 0.0f, a01 = 0.0f, a02 = 0.0f, av0 = 0.0f;
    float a10 = 0.0f, a11 = 0.0f, a12 = 0.0f, av1 = 0.0f;
#pragma unroll
    for (int dy = -r; dy <= r; ++dy) {
        const int oy = dy * L.s;
        const int py = y - oy;
        const bool rin = py >= 0 && py < H;
#pragma unroll
        for (int dx = -r; dx <= r; ++dx) {
            const int ox = dx * L.s;
            // the centres p = x - d of the two lanes; no branch: a dropped
            // centre reads the staged zeros of the frame's outside, weighs
            // +0 and adds exact zeros (K1b-bf16's dropped taps)
            unsigned mask = 0u;
            if (rin) {
                if constexpr (WIDE)
                    mask = lane_mask(x - ox >= 0 && x - ox < W,
                                     x + 1 - ox >= 0 && x + 1 - ox < W);
                else
                    mask = cmask[dx + R];
            }
            float2 u0, u1, u2, uv;
            bf2 q[KB_BWD_PLANES];
            if (STAGED) {
                const int e = L.at(kl, 2 * tx, -dy, -dx);
                const bool odd = bf16_pair_odd<R, S1>(e, -dx);
                u0 = lds_pair_f32(s_f, e, odd);
                u1 = lds_pair_f32(s_f + n, e, odd);
                u2 = lds_pair_f32(s_f + 2 * n, e, odd);
                uv = lds_pair_f32(s_f + 3 * n, e, odd);
#pragma unroll
                for (int t = 0; t < KB_BWD_PLANES; ++t)
                    q[t] = lds_pair(s_b + t * n, e, odd);
            } else {
                const BwdPixBf16 a = bwd_centre_bf16(
                    color, normal, depth, zgrad, sden, norm, gc, gv, H, W, py,
                    x - ox);
                const BwdPixBf16 b = bwd_centre_bf16(
                    color, normal, depth, zgrad, sden, norm, gc, gv, H, W, py,
                    x + 1 - ox);
                u0 = make_float2(a.f[0], b.f[0]);
                u1 = make_float2(a.f[1], b.f[1]);
                u2 = make_float2(a.f[2], b.f[2]);
                uv = make_float2(a.f[3], b.f[3]);
#pragma unroll
                for (int t = 0; t < KB_BWD_PLANES; ++t)
                    q[t] = __halves2bfloat162(a.a[t], b.a[t]);
            }
            bf2 h, oyb, oxb;
            if constexpr (!WIDE) {
                h = h_t[(dy < 0 ? -dy : dy) * (R + 1) + (dx < 0 ? -dx : dx)];
                oyb = off[dy + R];
                oxb = off[dx + R];
            } else {
                h = tap_h2(wide_taps[dy + r], wide_taps[dx + r]);
                oyb = bf2_splat((float)oy);
                oxb = bf2_splat((float)ox);
            }
            const bf2 hfm = tap_hfm(h, mask);
            // centre p's weight for its tap d, whose neighbour is x
            const bf2 dz2 = add2(
                mul2(k.sz2, __habs2(add2(mul2(q[6], oyb), mul2(q[7], oxb)))),
                k.eps2);
            const bf2 rz = rcp_bf16x2(dz2);
            const bf2 wz2 = mul2(neg_abs2(sub2(q[4], own[4])), rz);
            const bf2 wl2 = mul2(neg_abs2(sub2(q[0], own[0])), q[5]);
            const bf2 w = mul2(hfm, edge_exp_bf16x2(wz2, wl2, q[1], q[2], q[3],
                                                    own[1], own[2], own[3],
                                                    k));
            const float2 wr = bf2_floats(w);
            const float2 ww = bf2_floats(mul2(w, w));
            a00 = __fmaf_rn(wr.x, u0.x, a00);
            a01 = __fmaf_rn(wr.x, u1.x, a01);
            a02 = __fmaf_rn(wr.x, u2.x, a02);
            av0 = __fmaf_rn(ww.x, uv.x, av0);
            a10 = __fmaf_rn(wr.y, u0.y, a10);
            a11 = __fmaf_rn(wr.y, u1.y, a11);
            a12 = __fmaf_rn(wr.y, u2.y, a12);
            av1 = __fmaf_rn(ww.y, uv.y, av1);
        }
    }
    store_pair(dc, i, a00, a10, in1);
    store_pair(dc, hw + i, a01, a11, in1);
    store_pair(dc, 2 * hw + i, a02, a12, in1);
    store_pair(dv, i, av0, av1, in1);
}

template <int R, bool STAGED, bool S1 = false>
cudaError_t launch_bwd_bf16(const BwdArgs& a, const AtrousParams& p,
                            const AtrousBf16& kb, size_t bytes,
                            cudaStream_t s) {
    auto kernel = atrous_bwd_bf16_kernel<R, STAGED, S1>;
    static size_t opted = 0;
    cudaError_t err = allow_smem(kernel, bytes, opted);
    if (err != cudaSuccess) return err;
    kernel<<<lattice_grid<K14_TW, K14_TR>(p.H, p.W, p.spacing),
             dim3(KB_TX, KB_TY), bytes, s>>>(
        a.color, a.normal, a.depth, a.zgrad, a.sden, a.norm, a.gc, a.gv,
        a.dc, a.dv, p, kb, a.wide_taps);
    return cudaGetLastError();
}

// The bf16 forms' bit tricks against the formulas they replaced, on every
// bf16 pattern (tests/test_torch_cuda.py): thread j takes pattern j in its
// low lane and pattern (j * 40503) mod 2^16 in its high lane (a
// permutation), and writes the lane pair of exp2_fast_bf16x2 with 2^i by
// conversion, clamp and shift (the replaced assembly) and from the bf16
// bits (exp2_fast_bf16x2's), and of the reciprocal by __frcp_rn (the
// replaced one) and by rcp.approx (rcp_bf16x2), each rounded to bf16.
__device__ __forceinline__ bf2 exp2_bf16x2_by_conversion(bf2 y,
                                                         const Bf16K& k) {
    y = __hmax2(y, k.floor);
    const bf2 yi = h2floor(add2(y, k.half));
    const bf2 z = mul2(sub2(y, yi), k.ln2);
    bf2 p = add2(k.half, mul2(z, k.sixth));
    p = add2(k.one, mul2(z, p));
    p = add2(k.one, mul2(z, p));
    const float2 yf = __bfloat1622float2(yi);
    const int i0 = max(-126, min(127, (int)yf.x));
    const int i1 = max(-126, min(127, (int)yf.y));
    const unsigned two_i = ((unsigned)(i0 + 127) << 7)
                           | ((unsigned)(i1 + 127) << 23);
    return mul2(p, bf2_of(two_i));
}

__global__ void bf16_formulas_kernel(unsigned* __restrict__ out,
                                     AtrousBf16 kb) {
    const unsigned j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= 65536u) return;
    const Bf16K k = bf16_k(kb);
    const bf2 v = bf2_of(j | (((j * 40503u) & 0xFFFFu) << 16));
    const float2 f = __bfloat1622float2(v);
    out[j] = bf2_bits(exp2_bf16x2_by_conversion(v, k));
    out[65536 + j] = bf2_bits(exp2_fast_bf16x2(v, k));
    out[2 * 65536 + j] = bf2_bits(
        __floats2bfloat162_rn(__frcp_rn(f.x), __frcp_rn(f.y)));
    out[3 * 65536 + j] = bf2_bits(rcp_bf16x2(v));
}

// K9's inputs.
struct WgradIn {
    const float *color, *var, *normal, *depth, *zgrad, *sden, *out_c, *out_v,
        *norm, *gc, *gv;
};

// One pixel's values as K9's passes read them.
struct WgradPix {
    float4 cv;    // colour, variance
    float4 nz;    // normal, depth
    float4 ls;    // luminance, sigma, 1/sigma, 1/max(N, eps)
    float4 g;     // cotangents gc, gv
    float4 o;     // the forward's outputs out_c, out_v
    float2 zg;    // depth gradient
};

__device__ __forceinline__ WgradPix wgrad_load(const WgradIn& in, int q,
                                               int hw) {
    WgradPix v;
    v.cv = make_float4(in.color[q], in.color[hw + q], in.color[2 * hw + q],
                       in.var[q]);
    v.nz = make_float4(in.normal[q], in.normal[hw + q],
                       in.normal[2 * hw + q], in.depth[q]);
    const float sd = in.sden[q];
    v.ls = make_float4(luma3(v.cv.x, v.cv.y, v.cv.z), sd, 1.0f / sd,
                       1.0f / fmaxf(in.norm[q], kEps));
    v.g = make_float4(in.gc[q], in.gc[hw + q], in.gc[2 * hw + q], in.gv[q]);
    v.o = make_float4(in.out_c[q], in.out_c[hw + q], in.out_c[2 * hw + q],
                      in.out_v[q]);
    v.zg = make_float2(in.zgrad[q], in.zgrad[hw + q]);
    return v;
}

// The centre terms of x (own values in x) over its tap q at (oy, ox).
struct WgradCentre {
    float dn0, dn1, dn2, dz, dzg0, dzg1, dsd, dl;
};

__device__ __forceinline__ void wgrad_centre_tap(WgradCentre& a,
                                                 const WgradPix& x,
                                                 const WgradPix& q, float h,
                                                 int oy, int ox,
                                                 const AtrousParams& p) {
    const float isd = x.ls.z, inv_n = x.ls.w;
    const Tap t = exact_tap(h, x.ls.x, q.ls.x, x.ls.y, x.nz.w, q.nz.w,
                            x.zg.x, x.zg.y, oy, ox, x.nz.x, x.nz.y, x.nz.z,
                            q.nz.x, q.nz.y, q.nz.z, p);
    const float rz = 1.0f / (p.sigma_depth * fabsf(t.zs) + kEps);
    const float aa =
        ((x.g.x * (q.cv.x - x.o.x) + x.g.y * (q.cv.y - x.o.y)
          + x.g.z * (q.cv.z - x.o.z))
         + x.g.w * (2.0f * t.w * q.cv.w * inv_n - 2.0f * x.o.w)) * inv_n;
    const float b = aa * t.w;
    a.dz = a.dz - b * sgnf(t.dz) * rz;
    a.dl = a.dl - b * sgnf(t.dl) * isd;
    a.dsd = a.dsd + b * fabsf(t.dl) * (isd * isd);
    const float gz = b * fabsf(t.dz) * (rz * rz) * p.sigma_depth
                     * sgnf(t.zs);
    a.dzg0 = a.dzg0 + gz * (float)oy;
    a.dzg1 = a.dzg1 + gz * (float)ox;
    const float nf = b * p.sigma_normal / fmaxf(t.ndot, 1e-20f);
    a.dn0 = a.dn0 + nf * q.nz.x;
    a.dn1 = a.dn1 + nf * q.nz.y;
    a.dn2 = a.dn2 + nf * q.nz.z;
}

// The neighbour terms of x as the tap (oy, ox) of the centre c = x - d.
struct WgradNeighbour {
    float acc0, acc1, acc2, acc_v, dn0, dn1, dn2, dz, dl;
};

__device__ __forceinline__ void wgrad_neighbour_tap(WgradNeighbour& a,
                                                    const WgradPix& x,
                                                    const WgradPix& c,
                                                    float h, int oy, int ox,
                                                    const AtrousParams& p) {
    const Tap t = exact_tap(h, c.ls.x, x.ls.x, c.ls.y, c.nz.w, x.nz.w,
                            c.zg.x, c.zg.y, oy, ox, c.nz.x, c.nz.y, c.nz.z,
                            x.nz.x, x.nz.y, x.nz.z, p);
    const float inv_n = c.ls.w;
    const float u2 = c.g.w * (inv_n * inv_n);
    a.acc0 = a.acc0 + t.w * (c.g.x * inv_n);
    a.acc1 = a.acc1 + t.w * (c.g.y * inv_n);
    a.acc2 = a.acc2 + t.w * (c.g.z * inv_n);
    a.acc_v = a.acc_v + (t.w * t.w) * u2;
    const float rz = 1.0f / (p.sigma_depth * fabsf(t.zs) + kEps);
    const float aa =
        ((c.g.x * (x.cv.x - c.o.x) + c.g.y * (x.cv.y - c.o.y)
          + c.g.z * (x.cv.z - c.o.z))
         + c.g.w * (2.0f * t.w * x.cv.w * inv_n - 2.0f * c.o.w)) * inv_n;
    const float b = aa * t.w;
    a.dz = a.dz + b * sgnf(t.dz) * rz;
    a.dl = a.dl + b * sgnf(t.dl) * c.ls.z;
    const float nf = b * p.sigma_normal / fmaxf(t.ndot, 1e-20f);
    a.dn0 = a.dn0 + nf * c.nz.x;
    a.dn1 = a.dn1 + nf * c.nz.y;
    a.dn2 = a.dn2 + nf * c.nz.z;
}

// K9's block: a tile of 32 columns by 8 lattice rows, and two warp groups
// of 32 x 8 threads over it, one thread a pixel in each: the first group
// computes the pixels' centre terms, the second their neighbour terms and
// the outputs (see the header for why).
constexpr int K9_TW = 32, K9_TR = 8, K9_THREADS = 2 * K9_TW * K9_TR;
// bytes a staged pixel: five float4 and a float2
constexpr int K9_STAGED_BYTES = 5 * 16 + 8;

// The largest staged tile K9 takes: two blocks an SM.
constexpr size_t K9_MAX_STAGED = 110 * 1024;

// K9 (see the header): R >= 0 the radius, R = -1 any radius with the taps
// in wide_taps; STAGED: the neighbourhood staged over the row-lattice
// tile, else read through the caches.
template <int R, bool STAGED>
__global__ void __launch_bounds__(K9_THREADS) wgrad_kernel(
    WgradIn in, float* __restrict__ d_color, float* __restrict__ d_var,
    float* __restrict__ d_normal, float* __restrict__ d_depth,
    float* __restrict__ d_zgrad, float* __restrict__ d_sden, AtrousParams p,
    const float* __restrict__ wide_taps) {
    constexpr bool WIDE = R < 0;
    // radius 2 runs its rows as a loop: fewer taps' values live at once
    // (unrolled, its 25 taps spilled twice as many bytes at ptxas's 64
    // registers and ran 12-24 % slower)
    constexpr bool ROLL = R == 2;
    const int H = p.H, W = p.W, hw = H * W;
    const int r = WIDE ? p.radius : R;
    const Lattice<K9_TW, K9_TR> L(p.spacing, r);
    const int tx = threadIdx.x, kl = threadIdx.y % K9_TR;
    const bool neighbour = threadIdx.y >= K9_TR;

    extern __shared__ float4 smem[];
    // the centre terms each neighbour-group thread adds: d_normal,
    // d_depth, d_lum
    __shared__ float s_centre[5][K9_TR][K9_TW];
    const int n = L.sw * L.sh;
    float4 *s_cv = smem, *s_nz = smem + n, *s_ls = smem + 2 * n,
           *s_g = smem + 3 * n, *s_o = smem + 4 * n;
    float2* s_zg = (float2*)(smem + 5 * n);
    if (STAGED) {
        for (int j = threadIdx.y; j < L.sh; j += 2 * K9_TR) {
            const int y = L.row(j);
            for (int c = tx; c < L.sw; c += K9_TW) {
                const int x = L.col(c);
                const WgradPix v = in_canvas(H, W, 0, y, x)
                                       ? wgrad_load(in, y * W + x, hw)
                                       : WgradPix{};
                const int e = j * L.sw + c;
                s_cv[e] = v.cv;
                s_nz[e] = v.nz;
                s_ls[e] = v.ls;
                s_g[e] = v.g;
                s_o[e] = v.o;
                s_zg[e] = v.zg;
            }
        }
        __syncthreads();
    }
    auto staged = [&](int e) {
        WgradPix v;
        v.cv = s_cv[e];
        v.nz = s_nz[e];
        v.ls = s_ls[e];
        v.g = s_g[e];
        v.o = s_o[e];
        v.zg = s_zg[e];
        return v;
    };

    const int y = L.out_row(kl), x = L.x0 + tx;
    const bool valid = y < H && x < W;
    const int i = y * W + x;
    WgradNeighbour nb = {};
    if (valid && !neighbour) {
        const WgradPix me = STAGED ? staged(L.at(kl, tx, 0, 0))
                                   : wgrad_load(in, i, hw);
        WgradCentre ce = {};
        for_rows<ROLL>(r, [&](int dy) {
            const int oy = dy * L.s;
            const int qy = y + oy;
            if (qy < 0 || qy >= H) return;
#pragma unroll
            for (int dx = -r; dx <= r; ++dx) {
                const int ox = dx * L.s;
                const int qx = x + ox;
                if (qx < 0 || qx >= W) continue;
                const WgradPix q = STAGED ? staged(L.at(kl, tx, dy, dx))
                                          : wgrad_load(in, qy * W + qx, hw);
                wgrad_centre_tap(ce, me, q,
                                 tap_h<WIDE>(p, wide_taps, dy + r, dx + r),
                                 oy, ox, p);
            }
        });
        d_zgrad[i] = ce.dzg0;
        d_zgrad[hw + i] = ce.dzg1;
        d_sden[i] = ce.dsd;
        s_centre[0][kl][tx] = ce.dn0;
        s_centre[1][kl][tx] = ce.dn1;
        s_centre[2][kl][tx] = ce.dn2;
        s_centre[3][kl][tx] = ce.dz;
        s_centre[4][kl][tx] = ce.dl;
    } else if (valid) {
        const WgradPix me = STAGED ? staged(L.at(kl, tx, 0, 0))
                                   : wgrad_load(in, i, hw);
        for_rows<ROLL>(r, [&](int dy) {
            const int oy = dy * L.s;
            const int py = y - oy;
            if (py < 0 || py >= H) return;
#pragma unroll
            for (int dx = -r; dx <= r; ++dx) {
                const int ox = dx * L.s;
                const int px = x - ox;
                if (px < 0 || px >= W) continue;
                const WgradPix c = STAGED ? staged(L.at(kl, tx, -dy, -dx))
                                          : wgrad_load(in, py * W + px, hw);
                wgrad_neighbour_tap(nb, me, c,
                                    tap_h<WIDE>(p, wide_taps, dy + r, dx + r),
                                    oy, ox, p);
            }
        });
    }
    __syncthreads();
    if (!valid || !neighbour) return;
    // the sums in the order of the two-kernel form: centre + neighbour
    const float d_lum = s_centre[4][kl][tx] + nb.dl;
    d_color[i] = nb.acc0 + kL0 * d_lum;
    d_color[hw + i] = nb.acc1 + kL1 * d_lum;
    d_color[2 * hw + i] = nb.acc2 + kL2 * d_lum;
    d_var[i] = nb.acc_v;
    d_normal[i] = s_centre[0][kl][tx] + nb.dn0;
    d_normal[hw + i] = s_centre[1][kl][tx] + nb.dn1;
    d_normal[2 * hw + i] = s_centre[2][kl][tx] + nb.dn2;
    d_depth[i] = s_centre[3][kl][tx] + nb.dz;
}

template <int R, bool STAGED>
cudaError_t launch_wgrad(const WgradIn& in, float* d_color, float* d_var,
                         float* d_normal, float* d_depth, float* d_zgrad,
                         float* d_sden, const AtrousParams& p,
                         const float* wide_taps, cudaStream_t s) {
    auto kernel = wgrad_kernel<R, STAGED>;
    const size_t bytes = STAGED ? lattice_entries<K9_TW, K9_TR>(
                                      p.spacing, p.radius) * K9_STAGED_BYTES
                                : 0;
    static size_t opted = 0;
    cudaError_t err = allow_smem(kernel, bytes, opted);
    if (err != cudaSuccess) return err;
    kernel<<<lattice_grid<K9_TW, K9_TR>(p.H, p.W, p.spacing),
             dim3(K9_TW, 2 * K9_TR), bytes, s>>>(
        in, d_color, d_var, d_normal, d_depth, d_zgrad, d_sden, p,
        wide_taps);
    return cudaGetLastError();
}

}  // namespace

extern "C" const char* rdt_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// The bit-trick probe (bf16_formulas_kernel): out holds 4 x 65536 words.
extern "C" int rdt_bf16_formulas(unsigned* out, const AtrousBf16* bf16,
                                 void* stream) {
    bf16_formulas_kernel<<<256, 256, 0, (cudaStream_t)stream>>>(out, *bf16);
    return (int)cudaGetLastError();
}

extern "C" int rdt_zgrad(const float* depth, float* zgrad, int H, int W,
                         void* stream) {
    dim3 block(32, 8);
    zgrad_kernel<<<grid_for(H, W, block), block, 0, (cudaStream_t)stream>>>(
        depth, zgrad, H, W);
    return (int)cudaGetLastError();
}

// K1/K1b.  sden null: the fused blur (K1), else read (K1b).  K1: w_out and
// n_out null (no store), or both (the weights, float if w_f32 else bf16,
// and N); K1b: n_out alone (N), or both with w_f32 (float weights and N),
// exact weights only.  Any other combination returns cudaErrorNotSupported
// (no wrapper launches it).  tile null: the whole frame.  wide_taps null:
// the taps of params (radius <= 2), else the 2r+1 taps of a larger radius.
extern "C" int rdt_atrous_level(const float* color, const float* var,
                                const float* normal, const float* depth,
                                const float* zgrad, const float* sden,
                                float* color_out, float* var_out, void* w_out,
                                float* n_out, int w_f32,
                                const AtrousParams* params,
                                const AtrousTile* tile,
                                const float* wide_taps, void* stream) {
    const LevelArgs a{color, var, normal, depth, zgrad, sden, color_out,
                      var_out, w_out, n_out, w_f32, params, tile, wide_taps,
                      (cudaStream_t)stream};
    if (wide_taps) return (int)launch_level_radius<-1>(a);
    switch (params->radius) {
    case 0: return (int)launch_level_radius<0>(a);
    case 1: return (int)launch_level_radius<1>(a);
    case 2: return (int)launch_level_radius<2>(a);
    default: return (int)cudaErrorInvalidValue;
    }
}

// K2 (bf16 weights) / K2b (w_f32: float weights); with a tile the grid
// covers its output region (the centre plus o_m on every side).  staged:
// the staged form (radius >= 1), else the centres through the caches.
extern "C" int rdt_atrous_bwd_stored(const void* w, const float* norm,
                                     const float* gc, const float* gv,
                                     float* dc, float* dv, int H, int W,
                                     int spacing, int radius, int w_f32,
                                     const AtrousTile* tile, int staged,
                                     void* stream) {
    const StoredArgs a{w, norm, gc, gv, dc, dv, H, W, spacing, radius};
    const AtrousTile t = tile ? *tile : AtrousTile{};
    const cudaStream_t s = (cudaStream_t)stream;
    const bool st = staged != 0;
    if (w_f32) {
        return (int)(tile ? launch_stored_radius<float, true>(a, t, st, s)
                          : launch_stored_radius<float, false>(a, t, st, s));
    }
    return (int)(tile
                     ? launch_stored_radius<__nv_bfloat16, true>(a, t, st, s)
                     : launch_stored_radius<__nv_bfloat16, false>(a, t, st,
                                                                  s));
}

// K14, over the output region as K2; wide_taps as in rdt_atrous_level;
// staged: the staged form (radius >= 1), else the centres through the
// caches.
extern "C" int rdt_atrous_bwd(const float* color, const float* normal,
                              const float* depth, const float* zgrad,
                              const float* sden, const float* norm,
                              const float* gc, const float* gv, float* dc,
                              float* dv, const AtrousParams* params,
                              const AtrousTile* tile, const float* wide_taps,
                              int staged, void* stream) {
    const BwdArgs a{color, normal, depth, zgrad, sden, norm, gc, gv, dc, dv,
                    wide_taps};
    const AtrousParams& p = *params;
    const cudaStream_t s = (cudaStream_t)stream;
    // taps in the parameters up to radius 2, in wide_taps above
    if ((wide_taps != nullptr) != (p.radius > 2))
        return (int)cudaErrorInvalidValue;
    cudaError_t err;
    switch (p.radius) {
    // radius 0 reads each centre once: nothing to stage
    case 0: err = staged ? cudaErrorInvalidValue
                         : launch_bwd_tile<0, false>(a, p, tile, s);
        break;
    case 1: err = staged ? launch_bwd_tile<1, true>(a, p, tile, s)
                         : launch_bwd_tile<1, false>(a, p, tile, s);
        break;
    case 2: err = staged ? launch_bwd_tile<2, true>(a, p, tile, s)
                         : launch_bwd_tile<2, false>(a, p, tile, s);
        break;
    case 3: err = staged ? launch_bwd_tile<3, true>(a, p, tile, s)
                         : launch_bwd_tile<-1, false>(a, p, tile, s);
        break;
    case 4: err = staged ? launch_bwd_tile<4, true>(a, p, tile, s)
                         : launch_bwd_tile<-1, false>(a, p, tile, s);
        break;
    default: err = staged ? launch_bwd_tile<-1, true>(a, p, tile, s)
                          : launch_bwd_tile<-1, false>(a, p, tile, s);
    }
    return (int)err;
}

// K1b's bf16 form: n_out always, w_out null or float weights (h*2^arg,
// exact in float32); bf16 holds the bf16 constants; whole frame only.
extern "C" int rdt_atrous_level_bf16(const float* color, const float* var,
                                     const float* normal, const float* depth,
                                     const float* zgrad, const float* sden,
                                     float* sden_out, float* color_out,
                                     float* var_out, float* w_out,
                                     float* n_out,
                                     const AtrousParams* params,
                                     const AtrousBf16* bf16,
                                     const float* wide_taps, void* stream) {
    const LevelArgs a{color, var, normal, depth, zgrad, sden, color_out,
                      var_out, w_out, n_out, 1, params, nullptr, wide_taps,
                      (cudaStream_t)stream, sden_out};
    return (int)(sden ? launch_level_bf16(a, *bf16)
                      : launch_level_bf16_fused(a, *bf16));
}

// K14's bf16 form, whole frame; bf16 and wide_taps as above.
extern "C" int rdt_atrous_bwd_bf16(const float* color, const float* normal,
                                   const float* depth, const float* zgrad,
                                   const float* sden, const float* norm,
                                   const float* gc, const float* gv,
                                   float* dc, float* dv,
                                   const AtrousParams* params,
                                   const AtrousBf16* bf16,
                                   const float* wide_taps, void* stream) {
    const BwdArgs a{color, normal, depth, zgrad, sden, norm, gc, gv, dc, dv,
                    wide_taps};
    const AtrousParams& p = *params;
    const cudaStream_t s = (cudaStream_t)stream;
    const size_t staged = lattice_entries<K14_TW, K14_TR>(p.spacing,
                                                          p.radius)
                          * KB_BWD_BYTES;
    cudaError_t err;
    if (wide_taps) {
        err = staged <= kBf16BwdMaxStaged
                  ? launch_bwd_bf16<-1, true>(a, p, *bf16, staged, s)
                  : launch_bwd_bf16<-1, false>(a, p, *bf16, 0, s);
    } else {
        switch (p.radius) {
        case 0: err = launch_bwd_bf16<0, true>(a, p, *bf16, staged, s); break;
        // radius 1 and 2 apart at spacing 1, where a lane pair can be
        // unaligned (bf16_pair_odd)
        case 1:
            err = p.spacing == 1
                      ? launch_bwd_bf16<1, true, true>(a, p, *bf16, staged, s)
                      : launch_bwd_bf16<1, true>(a, p, *bf16, staged, s);
            break;
        case 2:
            err = p.spacing == 1
                      ? launch_bwd_bf16<2, true, true>(a, p, *bf16, staged, s)
                      : launch_bwd_bf16<2, true>(a, p, *bf16, staged, s);
            break;
        default: err = cudaErrorInvalidValue;
        }
    }
    return (int)err;
}

// K9, one launch; wide_taps as in rdt_atrous_level.
extern "C" int rdt_atrous_wgrad_bwd(
    const float* color, const float* var, const float* normal,
    const float* depth, const float* zgrad, const float* sden,
    const float* out_c, const float* out_v, const float* norm,
    const float* gc, const float* gv, float* d_color, float* d_var,
    float* d_normal, float* d_depth, float* d_zgrad, float* d_sden,
    const AtrousParams* params, const float* wide_taps, void* stream) {
    const WgradIn in{color, var, normal, depth, zgrad, sden, out_c, out_v,
                     norm, gc, gv};
    const cudaStream_t s = (cudaStream_t)stream;
    // radius 0 reads each neighbour once a pass: nothing to stage; a tile
    // above K9_MAX_STAGED (radius 3 and more at spacing 16) is not staged
    const bool staged =
        params->radius > 0
        && lattice_entries<K9_TW, K9_TR>(params->spacing, params->radius)
                   * K9_STAGED_BYTES
               <= K9_MAX_STAGED;
#define RDT_WGRAD(R, S)                                                   \
    launch_wgrad<R, S>(in, d_color, d_var, d_normal, d_depth, d_zgrad,    \
                       d_sden, *params, wide_taps, s)
    cudaError_t err;
    if (wide_taps) {
        err = staged ? RDT_WGRAD(-1, true) : RDT_WGRAD(-1, false);
    } else {
        switch (params->radius) {
        case 0: err = RDT_WGRAD(0, false); break;
        case 1: err = staged ? RDT_WGRAD(1, true) : RDT_WGRAD(1, false);
            break;
        case 2: err = staged ? RDT_WGRAD(2, true) : RDT_WGRAD(2, false);
            break;
        default: err = cudaErrorInvalidValue;
        }
    }
#undef RDT_WGRAD
    return (int)err;
}
