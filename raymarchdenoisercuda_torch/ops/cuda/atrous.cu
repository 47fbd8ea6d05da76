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
// dv out); ~40 flops a tap, and ~130 instructions (exact_tap's powf, expf
// and two divisions), which hold it.  Design: K1's row-lattice tile (64
// columns by 8 lattice rows) laid over the OUTPUT region (the tile form:
// the centre plus o_m), since the centres p = x - d*2^level of an output
// lie on its own lattice.  A block stages once per centre of its tile and
// halo, with coalesced loads, what every tap of that centre reads: normal
// and depth, u = gc/max(N, eps) and u2 = gv/max(N, eps)^2, luminance
// (luma3, the float the per-tap expression gives), sigma and depth
// gradient, 48 B, so that a tap reads three float4 from shared memory in
// place of ~15 plane reads, a luminance and a 1/N; each thread then
// computes two outputs.  x's own luminance, depth and normal stay in
// registers.  Specialised at compile time on the radius (0 stages
// nothing, 1, 2; above 2 the WIDE instantiation, taps in device memory)
// and the tile form.  Radius 0, WIDE and a tile above K14_MAX_STAGED read
// the centres through the caches, one output a thread (two a thread made
// radius 3 5-16 % slower than the kernel this one replaced).  Every
// weight goes through exact_tap unchanged and every sum adds its taps in
// the same (dy, dx) order, so the outputs are those of the one-thread-per-
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

// K14's block: 64 columns by 8 lattice rows of outputs; staged, K1's 64
// x 4 threads, two lattice rows a thread, else 64 x 8 threads, one each.
constexpr int K14_TW = 64, K14_TR = 8;
template <bool STAGED>
struct K14Rows {
    static constexpr int PY = STAGED ? 2 : 1;      // lattice rows a thread
    static constexpr int TY = K14_TR / PY;         // thread rows a block
    static constexpr int THREADS = K14_TW * TY;
};
// bytes a staged centre: three float4
constexpr int K14_STAGED_BYTES = 48;
// the largest staged tile (two blocks an SM): radius 2 up to spacing 32;
// radius 1's is at most 92 KB at any spacing
constexpr size_t K14_MAX_STAGED = 110 * 1024;

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
// R: the radius, or -1 (any radius, taps in wide_taps); STAGED: the
// centres staged over the block's lattice tile, else read through the
// caches.  Output pixel (yo, xo) of the centre-plus-o_m region is tile
// pixel (y, x); its centres p = x - d lie in the tile, and a centre's tap
// to x was dropped in the forward when (y, x) lies outside the frame, so
// such a pixel gets zero.
template <int R, bool STAGED, bool TILE>
__global__ void __launch_bounds__(K14Rows<STAGED>::THREADS) atrous_bwd_kernel(
    const float* __restrict__ color, const float* __restrict__ normal,
    const float* __restrict__ depth, const float* __restrict__ zgrad,
    const float* __restrict__ sden, const float* __restrict__ norm,
    const float* __restrict__ gc, const float* __restrict__ gv,
    float* __restrict__ dc, float* __restrict__ dv, AtrousParams p,
    AtrousTile t, const float* __restrict__ wide_taps) {
    constexpr bool WIDE = R < 0;
    constexpr int PY = K14Rows<STAGED>::PY, TY = K14Rows<STAGED>::TY;
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
#pragma unroll
            for (int dy = -r; dy <= r; ++dy) {
                const int oy = dy * L.s;
                const int py = y - oy;
                if (py < 0 || py >= H) continue;
#pragma unroll
                for (int dx = -r; dx <= r; ++dx) {
                    const int ox = dx * L.s;
                    const int px = x - ox;
                    if (px < 0 || px >= W) continue;
                    BwdCentre q;
                    if (STAGED) {
                        const int e = L.at(kl, tx, -dy, -dx);
                        q.nz = s_nz[e];
                        q.u = s_u[e];
                        q.ls = s_ls[e];
                    } else {
                        q = bwd_centre<TILE>(color, normal, depth, zgrad,
                                             sden, norm, gc, gv, t, W, hw,
                                             dp, gp, py, px);
                    }
                    const float h = tap_h<WIDE>(p, wide_taps, dy + r, dx + r);
                    // centre p's weight for its tap (oy, ox), whose
                    // neighbour is x
                    const float wk = exact_tap(
                        h, q.ls.x, lum_x, q.ls.y, q.nz.w, z_x, q.ls.z,
                        q.ls.w, oy, ox, q.nz.x, q.nz.y, q.nz.z, n0, n1, n2,
                        p).w;
                    acc0 = acc0 + wk * q.u.x;
                    acc1 = acc1 + wk * q.u.y;
                    acc2 = acc2 + wk * q.u.z;
                    acc_v = acc_v + (wk * wk) * q.u.w;
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
             dim3(K14_TW, K14Rows<STAGED>::TY), bytes, s>>>(
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
    const BwdArgs a{color, normal, depth, zgrad, sden, norm, gc, gv, dc, dv,
                    wide_taps};
    const AtrousParams& p = *params;
    const cudaStream_t s = (cudaStream_t)stream;
    // radius 0 reads each centre once: nothing to stage
    const bool staged = lattice_entries<K14_TW, K14_TR>(p.spacing, p.radius)
                            * K14_STAGED_BYTES
                        <= K14_MAX_STAGED;
    cudaError_t err;
    if (wide_taps) {
        err = launch_bwd_tile<-1, false>(a, p, tile, s);
    } else {
        switch (p.radius) {
        case 0: err = launch_bwd_tile<0, false>(a, p, tile, s); break;
        case 1: err = launch_bwd_tile<1, true>(a, p, tile, s); break;
        case 2: err = staged ? launch_bwd_tile<2, true>(a, p, tile, s)
                             : launch_bwd_tile<2, false>(a, p, tile, s);
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
