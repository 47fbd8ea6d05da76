// K3: the fused inference temporal step of SVGF (bounded motion, and with
// the clamped gather for unbounded motion), and K4-K6: the
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
// Bound: memory, 88 B/px (40 in, 8 motion, 40 out).  The TPU kernel loops
// over every integer offset that its band's motion brackets; here each
// thread reads its own <= 4 taps through the caches (on random motion one
// line a lane, out of L1: a block's window of taps fits there).  The
// canvas's margin and strides come in once and each tap is one offset from
// the pixel's address, so K4c costs what K4 does; all 40 loads go out
// before the multiply-adds, in the parent's order, by the same fused
// multiply-adds: K4 and K4c are bit-equal to the kernels they replace.  A
// block that staged the window its pixels' floors span (cp.async, zeros
// outside the frame) ran 1.28x slower than the parent on random motion and
// 1.30x on a served frame's (H100), and was dropped.
//
// K5 and K6 replace _make_gather_bwd_kernel (_gather_bwd_call) and
// _make_gather_bwd_hist_kernel (_gather_bwd_hist_call): one kernel here,
// gather_bwd_kernel<TILE, MG, NP>, the motion term compiled in (MG) or
// not, NP (6 or 10) gradient planes compiled, the leading np <= NP of
// them computed.  Plain twin: gather_bwd_ref.
//   d_hist: the transposed tent scatter, restructured as a gather, as the
//   TPU kernel does: a texel q takes w * g[p] from every source p with
//   q - p - floor(m_p) in {0, 1}^2, each texel's addends in one fixed
//   order (offset rows, then columns, ascending), so every launch gives
//   the same bits (an atomic scatter did not: uniform random motion brings
//   up to (2M + 2)^2 = 196 candidates a texel, and even a served frame's
//   coherent motion changed between launches).  A block of 32 x 8 texels
//   stages the motion of the (9 + 2M) x (33 + 2M) sources that can reach
//   it (cp.async), codes each one's floors in shared memory (a packed int,
//   kNoSource when rejected or reaching no texel of the block), reduces
//   the floor range of those that reach it, and each thread scans the
//   candidate offsets of that range only (3 x 3 or so on coherent motion,
//   14 x 14 on uniform random motion at max_motion 6): per row of offsets
//   it marks its matches in a bit mask (one subtraction and one mask test
//   a candidate), then adds them in order, the weight
//   tent(m0 - oy) * tent(m1 - ox) and the products rounded as the twin
//   rounds them.  Every texel is written once (the planes beyond np as
//   zeros): no zeroing pass.
//   d_motion (K5): a gather at the pixel itself over the offsets
//   floor(m)-1 .. floor(m)+1 inside [-M, M+1]; at integer motion the tent
//   derivative (JAX's kink convention: -sign with sign(0) = +1, half weight
//   at |x| = 1) is nonzero on all three, which is why the TPU kernel keeps
//   floor+1 upper bounds.  The same thread computes it after its texel's
//   d_hist, in the parent's loops and order (bit-equal to it).
// Bound: memory; K6 reads 6 cotangent planes and the motion and writes the
// 10-plane d_hist (72 B/px); K5 also reads 6 history planes and writes
// d_motion (104 B/px).  The gather costs more instructions than the
// parent's atomics, which a coherent frame's motion keeps cheap: on a
// served frame the staging and coding of 3.7 sources a texel and the
// writes take most of the time (H100), and on uniform random motion the
// candidate scan.  Tried and dropped (H100, served frame / random, against
// this kernel): two texels a thread, 1.14x / 1.0x (a wider tile widens
// the floor range); a first pass of codes and block ranges with the scan
// reading them through the caches, 1.17x / 1.15x; every match's loads
// unrolled over a 3 x 3 window, 1.42x served; the motion term in a kernel
// of its own, 1.10x served; its blocks interleaved with the gather's, 0.98x
// served but 1.04x random; more blocks an SM by launch bounds spilled.
//   Above max_motion 59 a block's (9 + 2M) x (33 + 2M) sources no longer
//   fit in the 227 KB of shared memory a block can have.  The banded form
//   that staged them in row bands cost O(M^2) a block (every block coded
//   the whole region, every texel scanned (2M + 2)^2 candidates on motion
//   spanning the bound: 13.2 ms at M60, 29.5 at M96 on the H100, against a
//   bound of 0.064).  Its replacement is a bucketed scatter, O(1) a source
//   at any M, the same bound (bytes): (1) each accepted source's anchor,
//   the top left tap of its 2 x 2, is counted on a grid over the canvas
//   one row and column wider (scatter_count_kernel; no anchor for a
//   source none of whose taps lands on a texel that gathers); (2) the
//   counts are scanned into segment offsets (scan_blocks_kernel,
//   scan_sums_kernel, scan_add_kernel); (3) each source's index is placed
//   in its anchor's segment (scatter_place_kernel; both atomics taken once
//   a warp's run of lanes with one anchor); (4) each segment is sorted in
//   descending source index (scatter_sort_kernel: a thread sorts up to 16
//   by insertion, the block a longer one through a bitmap of its keys in
//   the window of sources that can reach its anchor); (5) each texel q
//   merges the four segments of the anchors q - (1, 1), q - (1, 0), q -
//   (0, 1) and q in descending source index (scatter_gather_kernel).
//   Descending source index is the staged kernel's order of ascending
//   offset rows, then columns: every texel adds the same addends in the
//   same order, so the route gives the staged kernel's and the banded
//   form's floats bit for bit, on every launch.  K5's motion term runs
//   last in a kernel of its own (motion_term_kernel, the same sums).  The
//   workspace, through PyTorch's allocator: counts and offsets over the
//   anchor grid and one source index a pixel.

// K16 (temporal_bwd_kernel; no TPU kernel: the JAX package differentiates
// its epilogue by autodiff) is the adjoint of K3's whole-frame step with
// respect to the render, for the training step, where only the render
// takes a gradient (ops/temporal_cuda.py _FusedTemporalStep: forward K3,
// backward K16).  Plain twin: temporal_step_bwd_ref in ops/temporal.py,
// which it follows operation by operation.  With a = alpha where the
// history is valid, else 1, the render's cotangent at pixel p is
//   g_c(p) * a(p)                                      (its own blend)
//   + the clamp's: the clamped colour min(max(prev, cmin), cmax) takes
//     (1 - alpha) g_c at a valid pixel; cmin's and cmax's cotangents go
//     back through the separable 3x3 min/max (rows, then columns, the
//     offsets -1 then +1: m(m(v(p), v(p - e)), v(p + e)) a pass), the
//     cotangent of a link split in halves between tied sides, as
//     torch.minimum/torch.maximum (and jnp.minimum/maximum) split it;
//   + L_c * (the luma's): the moments' cotangents, plus those of the
//     temporal variance max(m2 - m1^2, 0) where the pixel is not short,
//     times a_m, through (l, l^2); and where a pixel q within 3 is short
//     (n_new < variance_boost_frames), the spatial variance
//     max(s2 - s1^2, 0) of q's 7x7 window sums, whose cotangents G1 =
//     -2 s1 dv / n_q and G2 = dv / n_q are summed over p's own 7x7 window
//     (the window sum is its own adjoint): W(G1) + 2 l W(G2).
// max(., 0) halves its cotangent at 0, as torch.maximum does.  Gather
// form: each pixel adds its terms in a fixed order, no atomics.  History,
// motion, depth and normal take no gradient here.  The bound: memory,
// 108 B a pixel (read the render, motion, depth and normal, the 8 history
// planes validity and the clamp read, n_new and the new moments, the
// cotangents of integrated and variance, 92 B; write d_render, 12 B):
// 0.27 ms at 3840x2160 and 3.35 TB/s; a block re-reads its render tile
// with a 6-pixel halo (3.4x) and regathers the history of a 1-pixel ring
// (1.33x) through the caches.  Measured at 3840x2160 on an H100 (device
// time, a served frame's inputs / uniform random motion): 0.74 / 0.89 ms,
// of which the clamp ~0.33 and the 7x7 ~0.18 on the served frame.  Tried
// and dropped: each receiver recomputing the three shares it takes from
// its neighbours' min/max triples (all three channels a pass; 0.80 /
// 0.94 ms); a register cap for 5 blocks an SM (__launch_bounds__(256,
// 5): 48 registers with spills, 0.73 / 0.94 ms, 1.27x slower without the
// clamp on random motion); a 32 x 16 tile of 512 threads (less halo a
// pixel, 2 blocks an SM: 0.76 / 0.92 ms).

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
// Pallas sweep).  clamped_gather_kernel (KG) is the unbounded reprojection
// of the 10 history planes: one thread a pixel samples p + motion
// bilinearly with its four taps clamped to the image (floor, clamp, and the
// sums as fused multiply-adds, as the plain twin bilinear_gather_clamped in
// ops/temporal.py rounds them).  clamped_gather_bwd_kernel (KGb) is its
// adjoint: each pixel scatters its bilinear-weighted cotangent into its
// four clamped taps (coinciding clamped taps add up), and takes the motion
// cotangent from the derivative of the bilinear weights, sum over planes
// of g.(d out/d fy, d out/d fx).  Bound: memory, 88 B/px forward (10
// planes and the motion in, 10 out) and 88 B/px backward at 6 planes with
// both gradients (motion, 6 cotangent and 6 history planes in; 6 history
// gradients and the motion's out).
//
// K3's unbounded step, temporal_kernel<false, 1, true> (no TPU kernel
// either: the JAX package's jnp step is bilinear_gather_many, then
// _temporal_epilogue), is the serving route with max_motion = None: K3's
// body with its step 1 replaced by KG's clamped gather (clamped_taps_at,
// the sums rounded as KG rounds them), in_bounds the landing test alone
// (no bound); steps 2-4 are K3's code.  It replaces KGp, KG and PyTorch's
// epilogue (~60 operations on whole planes, 7.5 ms at 3840x2160) by one
// launch, bit-equal to them.  Bound: K3's, memory, 104 B a pixel, 0.2575
// ms at 3840x2160 and 3.35 TB/s.  It reads the history planar, as K3
// does, not KGp's channel-minor stack: the served motion is coherent, so
// a warp's taps of one plane are neighbouring floats.  At 3840x2160 on a
// frame of serve_4k_unbounded's orbit (device time, H100): 0.394 ms
// planar, against 0.376 for a channel-minor read after KGp's 0.216; at
// 1080p on a served frame 0.106 against 0.104 + 0.052.  Only on uniform
// random motion (±28 px, 1080p) did the channel-minor read win, 0.155 +
// 0.052 against 0.278.  The tile form and K3b keep bounded motion.
//
// KG and KGb read the stack channel-minor (a texel's 10 planes
// contiguous: the differentiable step builds it so on the card with
// stack_channel_minor_kernel, KGp, as the JAX package stacks its planes
// (H*W, 10) for its gather; the wrappers lay a planar stack out with KGp
// first).  Planar, each tap would read one float from each of 10 planes,
// 10 sectors through L2 for 4 useful bytes each; channel-minor, a tap's
// 10 planes are 40 contiguous bytes and the right tap's follow them.  On
// random motion the gather is held by the cache lines a load instruction
// touches (one a lane), so KG loads a row's two taps as one 80-byte run
// in 16-byte loads where the run's alignment allows.
//
// KGb's history gradient: a texel at the border takes the taps of every
// pixel whose motion clamps there, hundreds of addends, so a float sum in
// the atomics' order changes from run to run; the float products are
// added into a float64 scratch instead (atomicAdd on double is native on
// sm_90), where the order moves the sum by ~1e-16 of it, and
// round_planes_kernel rounds it once to float32: two runs agree to within
// that one rounding.  The scratch, zeroed by a memset in the C entry, is
// channel-minor (48 B a texel).  A thread first adds, in fixed order, the
// addends that meet on one texel: its own taps clamped together, its
// right taps with the next lane's left taps, and its top taps with the
// bottom taps of the pixel above, one warp up (on coherent motion every
// pixel's right and bottom taps are its neighbours' left and top ones:
// a texel then takes one atomic instead of four); then the warp issues
// each tap's addends through shared memory so that consecutive lanes add
// into consecutive doubles: a RED instruction covers ~5 texels' contiguous
// 48 bytes instead of 32 scattered sectors.  The planes beyond the
// scattered ones are zeroed by a memset, not written by the round.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

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

// The clamped gather's tap geometry at the reprojected position (ys, xs)
// of an H x W frame: the four clamped tap indices and the bilinear
// fractions; clamped_taps takes pixel (y, x)'s, ys = y + m0, xs = x + m1.
struct ClampedTaps {
    int i00, i01, i10, i11;
    float fy, fx;
};

__device__ __forceinline__ ClampedTaps clamped_taps_at(float ys, float xs,
                                                       int H, int W) {
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

__device__ __forceinline__ ClampedTaps clamped_taps(const float* motion,
                                                    int H, int W, int y,
                                                    int x) {
    const int hw = H * W, i = y * W + x;
    return clamped_taps_at((float)y + motion[i], (float)x + motion[hw + i],
                           H, W);
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
// CLAMPED (whole frame only): the unbounded step, its reprojection KG's
// clamped bilinear gather of the planar history (see the header); steps
// 2-4 are the same code.
template <bool TILE, int PX, bool CLAMPED = false>
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
    static_assert(!(CLAMPED && TILE), "the clamped gather has no tile form");
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
        if (CLAMPED) {
            // KG's taps and sums: each row's blend as a fused multiply-add
            // of the right tap's product, then the rows'
            in_bounds[k] = ys >= 0.0f && ys <= (float)(Hg - 1)
                && xs >= 0.0f && xs <= (float)(Wg - 1);
            const ClampedTaps c = clamped_taps_at(ys, xs, H, W);
            const float wx = 1.0f - c.fx, wy = 1.0f - c.fy;
            float a[4][10];
#pragma unroll
            for (int j = 0; j < 10; ++j) {
                a[0][j] = planes[j][c.i00];
                a[1][j] = planes[j][c.i01];
                a[2][j] = planes[j][c.i10];
                a[3][j] = planes[j][c.i11];
            }
#pragma unroll
            for (int j = 0; j < 10; ++j) {
                const float top = __fmaf_rn(a[0][j], wx, a[1][j] * c.fx);
                const float bot = __fmaf_rn(a[2][j], wx, a[3][j] * c.fx);
                g[k][j] = __fmaf_rn(top, wy, bot * c.fy);
            }
            continue;
        }
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


// K4-K6's block: KT_X x KT_Y threads (one row a warp), one pixel (K4, and
// K5's motion term) or one history texel (K5/K6's d_hist) a thread.
constexpr int KT_X = 32, KT_Y = 8;
// A block's floor range: none of its pixels accepted when lo > hi.
constexpr int kNoLo = 0x7fffffff, kNoHi = -0x7fffffff - 1;

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

__device__ __forceinline__ float tent(float x) {
    return fmaxf(1.0f - fabsf(x), 0.0f);
}

// d/dx max(0, 1 - |x|) with JAX's kink convention (ops.common.tent_prime).
__device__ __forceinline__ float tent_prime(float x) {
    const float a = fabsf(x);
    const float sgn = x >= 0.0f ? 1.0f : -1.0f;
    const float w = a < 1.0f ? 1.0f : (a == 1.0f ? 0.5f : 0.0f);
    return -sgn * w;
}

// The motion floors' range over a K5/K6 block: each thread gives its own
// (lo, hi) pairs (kNoLo, kNoHi for none), the warps reduce them and put
// one value each in ``red``; every thread reads the block's.  Holds a
// __syncthreads, so every thread of the block must call it.
struct FloorRange {
    int y_lo, y_hi, x_lo, x_hi;
};

__device__ __forceinline__ FloorRange block_floor_range(
    int y_lo, int y_hi, int x_lo, int x_hi, int (*red)[4]) {
    const unsigned full = 0xffffffffu;
    y_lo = __reduce_min_sync(full, y_lo);
    y_hi = __reduce_max_sync(full, y_hi);
    x_lo = __reduce_min_sync(full, x_lo);
    x_hi = __reduce_max_sync(full, x_hi);
    if (threadIdx.x == 0) {
        red[threadIdx.y][0] = y_lo;
        red[threadIdx.y][1] = y_hi;
        red[threadIdx.y][2] = x_lo;
        red[threadIdx.y][3] = x_hi;
    }
    __syncthreads();
    FloorRange r = {kNoLo, kNoHi, kNoLo, kNoHi};
#pragma unroll
    for (int w = 0; w < KT_Y; ++w) {
        r.y_lo = min(r.y_lo, red[w][0]);
        r.y_hi = max(r.y_hi, red[w][1]);
        r.x_lo = min(r.x_lo, red[w][2]);
        r.x_hi = max(r.x_hi, red[w][3]);
    }
    return r;
}

// 4 bytes to shared memory, or 4 zero bytes when ``fill`` is false (src
// then only has to be a valid address: nothing is read).
__device__ __forceinline__ void cp_async4_or_zero(void* dst, const void* src,
                                                  bool fill) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(fill ? 4 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K4/K4c: bounded tent gather of the 10-plane stack (see the header).
// The canvas's margin and strides come in once; each tap's address is one
// offset from the pixel's, and all four taps' loads go out before the
// multiply-adds.
template <bool TILE>
__global__ void __launch_bounds__(KT_X * KT_Y)
gather_kernel(const float* __restrict__ stack,
              const float* __restrict__ motion, float* __restrict__ out,
              int H, int W, int M, TemporalTile t) {
    const int x = blockIdx.x * KT_X + threadIdx.x;
    const int y = blockIdx.y * KT_Y + threadIdx.y;
    if (x >= W || y >= H) return;
    const int hw = H * W, i = y * W + x;
    // the history canvas: margin, row and plane strides
    const int hm = TILE ? t.h_m : 0, rs = TILE ? t.h_rs : W;
    const int ps = TILE ? t.h_ps : hw;
    const float m0 = motion[i], m1 = motion[hw + i];
    float g[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) g[k] = 0.0f;
    if (fabsf(m0) <= (float)M && fabsf(m1) <= (float)M) {
        const float y0 = floorf(m0), x0 = floorf(m1);
        const int fy = (int)y0, fx = (int)x0;
        const float* p = stack + (y + fy + hm) * rs + x + fx + hm;
        float v[4][10], w[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
            const int ay = a >> 1, ax = a & 1;
            const float ty = fmaxf(1.0f - fabsf(m0 - (y0 + (float)ay)), 0.0f);
            const float tx = fmaxf(1.0f - fabsf(m1 - (x0 + (float)ax)), 0.0f);
            w[a] = ty * tx;
            const bool in = tap_inside<TILE>(t, H, W, y, x, fy + ay, fx + ax);
            const float* q = p + ay * rs + ax;
#pragma unroll
            for (int k = 0; k < 10; ++k) v[a][k] = in ? q[k * ps] : 0.0f;
        }
        // the taps in the parent's order, by the same fused multiply-adds
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int k = 0; k < 10; ++k) g[k] = __fmaf_rn(w[a], v[a][k], g[k]);
        }
    }
#pragma unroll
    for (int k = 0; k < 10; ++k) out[k * hw + i] = g[k];
}

// K5/K6's source codes: a source's motion floors (fy, fx) packed as
// ((fy + kCodeBias) << 16) + fx + kCodeBias, and kNoSource for a pixel
// that adds to no texel of the block (rejected, outside the tile, or
// reaching no texel of the block).  For candidate offset (oy, ox),
// d = ((oy + kCodeBias) << 16) + ox + kCodeBias - code is
// ((oy - fy) << 16) + (ox - fx), which is 0, 1, 0x10000 or 0x10001
// exactly when (oy - fy, ox - fx) is in {0, 1}^2: one subtraction and one
// mask a candidate.  The bias takes max_motion up to 8190 (the wrapper
// bounds it by the frame's larger side plus one, beyond which no source
// reaches the frame).
constexpr int kCodeBias = 8192;
constexpr int kNoSource = 0x7fff7fff;

// K5's motion term at pixel (y, x) of the tile: the sums of the kernel
// that this one replaced, in its order and in its loops (with the
// cotangents held in registers, K5 ran 1.06x slower on a served frame).
template <bool TILE>
__device__ __forceinline__ void motion_term(
    const float* __restrict__ hist, const float* __restrict__ motion,
    const float* __restrict__ g, float* __restrict__ dm, int H, int W,
    int M, int np, const TemporalTile& t, int y, int x) {
    const int hw = H * W, i = y * W + x;
    const int hm = TILE ? t.h_m : 0, rs = TILE ? t.h_rs : W;
    const int ps = TILE ? t.h_ps : hw;
    const float m0 = motion[i], m1 = motion[hw + i];
    if (!(fabsf(m0) <= (float)M && fabsf(m1) <= (float)M)) {
        dm[i] = 0.0f;
        dm[hw + i] = 0.0f;
        return;
    }
    const float y0 = floorf(m0), x0 = floorf(m1);
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
            const int q = (ry + hm) * rs + rx + hm;
            float gdot = 0.0f;
            for (int c = 0; c < np; ++c) {
                gdot = gdot + g[c * hw + i] * (ok ? hist[c * ps + q] : 0.0f);
            }
            dm0 = dm0 + (typ * tx) * gdot;
            dm1 = dm1 + (ty * txp) * gdot;
        }
    }
    dm[i] = dm0;
    dm[hw + i] = dm1;
}

// K5 (MG, with hist) / K6: the adjoint of K4 (see the header), d_hist's
// leading np <= NP planes (the others 0), every texel of dh written once,
// then K5's motion term at the texel's pixel of the tile.  A block is a
// KT_X x KT_Y tile of texels of the history canvas.  Shared memory, for
// the block's source region: its motion planes (staged by cp.async), then
// the sources' codes.
template <bool TILE, bool MG, int NP>
__global__ void __launch_bounds__(KT_X * KT_Y)
gather_bwd_kernel(const float* __restrict__ hist,
                  const float* __restrict__ motion,
                  const float* __restrict__ g, float* __restrict__ dh,
                  float* __restrict__ dm, int H, int W, int M, int np,
                  TemporalTile t) {
    extern __shared__ float sm[];
    __shared__ int red[KT_Y][4];
    const int hw = H * W;
    const int hm = TILE ? t.h_m : 0, rs = TILE ? t.h_rs : W;
    const int ps = TILE ? t.h_ps : hw;
    // the block's first texel of the history canvas at (cy0, cx0), at
    // (qy0, qx0) in tile coordinates
    const int cx0 = blockIdx.x * KT_X, cy0 = blockIdx.y * KT_Y;
    const int qx0 = cx0 - hm, qy0 = cy0 - hm;
    // the sources that can reach the block: rows qy0 - M - 1 .. qy0 +
    // KT_Y - 1 + M, columns likewise
    const int rh = KT_Y + 2 * M + 1, rw = KT_X + 2 * M + 1, n = rh * rw;
    const int ry0 = qy0 - M - 1, rx0 = qx0 - M - 1;
    float* s0 = sm;
    float* s1 = sm + n;
    int* code = reinterpret_cast<int*>(sm + 2 * n);
    for (int ry = threadIdx.y; ry < rh; ry += KT_Y) {
        const int sy = ry0 + ry;
        for (int rx = threadIdx.x; rx < rw; rx += KT_X) {
            const int sx = rx0 + rx;
            const bool in = sy >= 0 && sy < H && sx >= 0 && sx < W;
            const float* src = motion + (in ? sy * W + sx : 0);
            cp_async4_or_zero(s0 + ry * rw + rx, src, in);
            cp_async4_or_zero(s1 + ry * rw + rx, src + hw, in);
        }
    }
    cp_async_wait_all();
    __syncthreads();
    int y_lo = kNoLo, y_hi = kNoHi, x_lo = kNoLo, x_hi = kNoHi;
    for (int ry = threadIdx.y; ry < rh; ry += KT_Y) {
        const int sy = ry0 + ry;
        for (int rx = threadIdx.x; rx < rw; rx += KT_X) {
            const int sx = rx0 + rx, e = ry * rw + rx;
            const float m0 = s0[e], m1 = s1[e];
            int c = kNoSource;
            if (sy >= 0 && sy < H && sx >= 0 && sx < W
                && fabsf(m0) <= (float)M && fabsf(m1) <= (float)M) {
                const int fy = (int)floorf(m0), fx = (int)floorf(m1);
                // its taps' top left, relative to the block
                const int ay = sy + fy - qy0, ax = sx + fx - qx0;
                if (ay >= -1 && ay < KT_Y && ax >= -1 && ax < KT_X) {
                    c = ((fy + kCodeBias) << 16) + fx + kCodeBias;
                    y_lo = min(y_lo, fy);
                    y_hi = max(y_hi, fy);
                    x_lo = min(x_lo, fx);
                    x_hi = max(x_hi, fx);
                }
            }
            code[e] = c;
        }
    }
    const FloorRange r = block_floor_range(y_lo, y_hi, x_lo, x_hi, red);
    const int cx = cx0 + threadIdx.x, cy = cy0 + threadIdx.y;
    if (cy >= H + 2 * hm || cx >= W + 2 * hm) return;
    const int qx = qx0 + threadIdx.x, qy = qy0 + threadIdx.y;
    float acc[NP];
#pragma unroll
    for (int c = 0; c < NP; ++c) acc[c] = 0.0f;
    if (!TILE || tap_inside<TILE>(t, H, W, qy, qx, 0, 0)) {
        // candidate offsets o = q - p: floor .. floor + 1 of the block's
        // floors; for each row of offsets, the lanes mark their matches in
        // a mask (32 offsets at a time), then add them in order (offset
        // rows, then columns, ascending)
        const int nx = r.x_hi - r.x_lo + 2;
        for (int oy = r.y_lo; oy <= r.y_hi + 1; ++oy) {
            const int ty = ((oy + kCodeBias) << 16) + kCodeBias;
            // the region index of source (qy - oy, qx)
            const int row = (qy - oy - ry0) * rw + qx - rx0;
            for (int k0 = 0; k0 < nx; k0 += 32) {
                const int kn = min(nx - k0, 32);
                const int ox0 = r.x_lo + k0;
                unsigned mask = 0u;
                for (int k = 0; k < kn; ++k) {
                    const int d = ty + ox0 + k - code[row - ox0 - k];
                    mask |= ((d & 0xfffefffe) == 0 ? 1u : 0u) << k;
                }
                while (mask) {
                    const int k = __ffs(mask) - 1;
                    mask &= mask - 1u;
                    const int ox = ox0 + k, e = row - ox;
                    // the twin's weight: tent(m0 - dyf) * tent(m1 - dxf)
                    const float w = tent(s0[e] - (float)oy)
                        * tent(s1[e] - (float)ox);
                    const float* gs = g + (qy - oy) * W + qx - ox;
#pragma unroll
                    for (int c = 0; c < NP; ++c) {
                        if (c < np) acc[c] = acc[c] + w * gs[c * hw];
                    }
                }
            }
        }
    }
    float* d = dh + cy * rs + cx;
#pragma unroll
    for (int c = 0; c < 10; ++c) d[c * ps] = c < NP ? acc[c] : 0.0f;
    if (MG && qy >= 0 && qy < H && qx >= 0 && qx < W)
        motion_term<TILE>(hist, motion, g, dm, H, W, M, np, t, qy, qx);
}

// K5/K6 (K5c/K6c) above kStagedMaxMotion: the bucketed scatter (see the
// header).  Every kernel below takes the route's geometry: the tile's H x
// W sources, the bound M, the canvas (Hc x Wc, margin hm) and the anchor
// grid over it, one row and one column wider (an anchor a, the top left
// tap of a source's 2 x 2, at tile coordinates (ay, ax) has the index
// (ay + hm + 1) Wa + ax + hm + 1), and the rows and columns [ylo, yhi] x
// [xlo, xhi] (tile coordinates) of the texels that gather: the canvas's
// inside the frame.
struct ScatterGeom {
    int H, W, M, hm, Hc, Wc, Wa, Na;
    int ylo, yhi, xlo, xhi;
};

// Threads a block of the scatter's one-dimensional launches; the counts a
// thread of the scan's first pass adds, and a block's share; a segment a
// thread sorts by insertion, longer ones a block sorts through a bitmap of
// its keys, kSortWords words (with one pad word each 32 against bank
// conflicts); sources a thread of the gather takes from the merge before
// loading their values, and the sources past which a warp merges a texel.
constexpr int KS_THREADS = 256;
constexpr int kScanItems = 8;
constexpr int kScanBlock = KS_THREADS * kScanItems;
constexpr int kSortShort = 16;
constexpr int kSortWords = 8192;
constexpr int kMergeBatch = 4;
// A texel whose four segments hold more sources than this (a sink's) is
// merged by a warp, 32 sources at a time.
constexpr int kLongTexel = 64;

template <bool TILE>
__host__ __device__ inline ScatterGeom scatter_geom(int H, int W, int M,
                                                    const TemporalTile& t) {
    ScatterGeom g;
    g.H = H;
    g.W = W;
    g.M = M;
    g.hm = TILE ? t.h_m : 0;
    g.Hc = H + 2 * g.hm;
    g.Wc = W + 2 * g.hm;
    g.Wa = g.Wc + 1;
    g.Na = (g.Hc + 1) * g.Wa;
    // the texels inside the frame and the canvas
    g.ylo = TILE ? (g.hm < t.gy0 ? -g.hm : -t.gy0) : 0;
    g.xlo = TILE ? (g.hm < t.gx0 ? -g.hm : -t.gx0) : 0;
    g.yhi = TILE ? (H + g.hm < t.Hg - t.gy0 ? H + g.hm : t.Hg - t.gy0) - 1
                 : H - 1;
    g.xhi = TILE ? (W + g.hm < t.Wg - t.gx0 ? W + g.hm : t.Wg - t.gx0) - 1
                 : W - 1;
    return g;
}

// The workspace: counts and segment offsets, each over the anchor grid
// and its total rounded up to whole scan blocks, the scan's block sums
// (rounded to four), and a source index for each source.
__host__ __device__ inline long long scatter_counts(const ScatterGeom& g) {
    return ((long long)g.Na + 1 + kScanBlock - 1) / kScanBlock * kScanBlock;
}

__host__ __device__ inline long long scatter_workspace_ints(
    const ScatterGeom& g) {
    const long long np = scatter_counts(g);
    return 2 * np + (np / kScanBlock + 3) / 4 * 4 + (long long)g.H * g.W;
}

// Source i's anchor index, or -1: rejected (|m| > M on an axis) or none of
// its taps on a texel that gathers.
__device__ __forceinline__ int scatter_anchor(const float* __restrict__ motion,
                                              const ScatterGeom& g, int i) {
    const int hw = g.H * g.W;
    const float m0 = motion[i], m1 = motion[hw + i];
    if (!(fabsf(m0) <= (float)g.M && fabsf(m1) <= (float)g.M)) return -1;
    const int py = i / g.W, px = i - py * g.W;
    const int ay = py + (int)floorf(m0), ax = px + (int)floorf(m1);
    if (ay < g.ylo - 1 || ay > g.yhi || ax < g.xlo - 1 || ax > g.xhi) {
        return -1;
    }
    return (ay + g.hm + 1) * g.Wa + ax + g.hm + 1;
}

// 1. Code and count: count[a] += the sources anchored at a, one atomic a
// warp's run of lanes that share an anchor (a sink's sources would
// otherwise queue on one address).
__global__ void __launch_bounds__(KS_THREADS)
scatter_count_kernel(const float* __restrict__ motion, int* __restrict__ count,
                     ScatterGeom g) {
    const int i = blockIdx.x * KS_THREADS + threadIdx.x;
    const int a = i < g.H * g.W ? scatter_anchor(motion, g, i) : -1;
    const unsigned live = __ballot_sync(0xffffffffu, a >= 0);
    if (a < 0) return;
    const unsigned peers = __match_any_sync(live, a);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1) {
        atomicAdd(&count[a], __popc(peers));
    }
}

// A block's exclusive sum of one int a thread (KS_THREADS threads);
// ``total`` gets the block's sum.  Holds two __syncthreads.
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_sums,
                                                   int& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += u;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int before = 0;
    total = 0;
#pragma unroll
    for (int w = 0; w < KS_THREADS / 32; ++w) {
        before += w < warp ? warp_sums[w] : 0;
        total += warp_sums[w];
    }
    __syncthreads();
    return before + incl - v;
}

// 2. The exclusive scan of the counts into segment offsets, in three
// passes: each block's kScanBlock counts (off gets their exclusive sums
// within the block, bsum the block's total), the block totals (one block,
// in place), and the block totals added back.
__global__ void __launch_bounds__(KS_THREADS)
scan_blocks_kernel(const int* __restrict__ count, int* __restrict__ off,
                   int* __restrict__ bsum) {
    __shared__ int warp_sums[KS_THREADS / 32];
    const size_t base = (size_t)blockIdx.x * kScanBlock
        + threadIdx.x * kScanItems;
    const int4 c0 = *reinterpret_cast<const int4*>(count + base);
    const int4 c1 = *reinterpret_cast<const int4*>(count + base + 4);
    const int v[kScanItems] = {c0.x, c0.y, c0.z, c0.w,
                               c1.x, c1.y, c1.z, c1.w};
    int sum = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) sum += v[k];
    int total;
    int run = block_exclusive_sum(sum, warp_sums, total);
    int e[kScanItems];
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
        e[k] = run;
        run += v[k];
    }
    *reinterpret_cast<int4*>(off + base) = make_int4(e[0], e[1], e[2], e[3]);
    *reinterpret_cast<int4*>(off + base + 4) =
        make_int4(e[4], e[5], e[6], e[7]);
    if (threadIdx.x == 0) bsum[blockIdx.x] = total;
}

__global__ void __launch_bounds__(KS_THREADS)
scan_sums_kernel(int* __restrict__ bsum, int nb) {
    __shared__ int warp_sums[KS_THREADS / 32];
    int carry = 0;
    for (int b0 = 0; b0 < nb; b0 += KS_THREADS) {
        const int b = b0 + threadIdx.x;
        const int v = b < nb ? bsum[b] : 0;
        int total;
        const int e = block_exclusive_sum(v, warp_sums, total);
        if (b < nb) bsum[b] = carry + e;
        carry += total;
    }
}

__global__ void __launch_bounds__(KS_THREADS)
scan_add_kernel(int* __restrict__ off, const int* __restrict__ bsum,
                long long n) {
    const long long i = ((long long)blockIdx.x * KS_THREADS + threadIdx.x) * 4;
    if (i >= n) return;
    int4 v = *reinterpret_cast<int4*>(off + i);
    const int s = bsum[i / kScanBlock];
    v.x += s;
    v.y += s;
    v.z += s;
    v.w += s;
    *reinterpret_cast<int4*>(off + i) = v;
}

// 3. Placement: each source's index into its anchor's segment, at a slot
// counted down from the segment's end (count[a] returns to 0); the order
// within a segment is the atomics', which step 4 sorts.
__global__ void __launch_bounds__(KS_THREADS)
scatter_place_kernel(const float* __restrict__ motion, int* __restrict__ count,
                     const int* __restrict__ off, int* __restrict__ idx,
                     ScatterGeom g) {
    const int i = blockIdx.x * KS_THREADS + threadIdx.x;
    const int a = i < g.H * g.W ? scatter_anchor(motion, g, i) : -1;
    const unsigned live = __ballot_sync(0xffffffffu, a >= 0);
    if (a < 0) return;
    const unsigned peers = __match_any_sync(live, a);
    const int lane = threadIdx.x & 31, leader = __ffs(peers) - 1;
    const int n = __popc(peers);
    int end = 0;
    if (lane == leader) end = atomicSub(&count[a], n);
    end = __shfl_sync(peers, end, leader);
    // the run's slots: [end - n, end) of the segment
    const int rank = __popc(peers & ((1u << lane) - 1u));
    idx[off[a] + end - n + rank] = i;
}

// A long segment (anchor a, n > kSortShort sources) sorted by the block in
// descending source index.  A source p of it lies in the window of
// sources whose floors reach a, [ay - M, ay + M] x [ax - M, ax + M]
// clipped to the tile; its key, (py - row0) KW + px - col0, ascends with
// p.  The block sets each source's key in a bitmap of kSortWords * 32 keys
// at a time, counts the set bits of each thread's 32 words, and writes
// each source at n - 1 - its rank, into scratch (the counts' array, free
// after placement: the segment's own n ints at its offset), then copies
// the segment back.  Cost: ceil(KR / 262144) passes over the n sources,
// KR <= min((2M + 1)^2, H W) keys (a sink of (2M + 1)^2 sources at M 128:
// one pass over 66,049 of them).
__device__ void sort_long_segment(int a, int s, int n, int* __restrict__ idx,
                                  int* __restrict__ scratch,
                                  const ScatterGeom& g, unsigned* bits,
                                  int* warp_sums) {
    const int ay = a / g.Wa - g.hm - 1, ax = a % g.Wa - g.hm - 1;
    const int row0 = max(ay - g.M, 0), row1 = min(ay + g.M, g.H - 1);
    const int col0 = max(ax - g.M, 0), col1 = min(ax + g.M, g.W - 1);
    const int KW = col1 - col0 + 1;
    const int KR = (row1 - row0 + 1) * KW;          // <= H W
    constexpr int kChunk = kSortWords * 32;
    constexpr int kPer = kSortWords / KS_THREADS;   // words a thread scans
    int done = 0;
    for (int k0 = 0; k0 < KR; k0 += kChunk) {
        for (int w = threadIdx.x; w < kSortWords; w += KS_THREADS) {
            bits[w + (w >> 5)] = 0u;
        }
        __syncthreads();
        for (int e = threadIdx.x; e < n; e += KS_THREADS) {
            const int p = idx[s + e];
            const int py = p / g.W, px = p - py * g.W;
            const int key = (py - row0) * KW + px - col0 - k0;
            if (key >= 0 && key < kChunk) {
                const int w = key >> 5;
                atomicOr(&bits[w + (w >> 5)], 1u << (key & 31));
            }
        }
        __syncthreads();
        // thread t's words t kPer .. (t + 1) kPer - 1, at t (kPer + 1) + j
        const unsigned* mine = bits + threadIdx.x * (kPer + 1);
        int c = 0;
#pragma unroll 4
        for (int j = 0; j < kPer; ++j) c += __popc(mine[j]);
        int total;
        int rank = done + block_exclusive_sum(c, warp_sums, total);
        for (int j = 0; j < kPer; ++j) {
            unsigned b = mine[j];
            while (b) {
                const int bit = __ffs(b) - 1;
                b &= b - 1u;
                const int key = k0 + ((threadIdx.x * kPer + j) << 5) + bit;
                const int dy = key / KW;
                scratch[s + n - 1 - rank] = (row0 + dy) * g.W + col0 + key
                    - dy * KW;
                ++rank;
            }
        }
        done += total;
        __syncthreads();
    }
    for (int e = threadIdx.x; e < n; e += KS_THREADS) idx[s + e] = scratch[s + e];
    __syncthreads();
}

// 4. Sorting: each segment in descending source index (the parent's
// order of ascending offset rows, then columns, at every texel): a thread
// a segment of up to kSortShort by insertion, the block the longer ones
// of its KS_THREADS anchors, one after another.
__global__ void __launch_bounds__(KS_THREADS)
scatter_sort_kernel(const int* __restrict__ off, int* __restrict__ idx,
                    int* __restrict__ scratch, ScatterGeom g) {
    __shared__ unsigned bits[kSortWords + kSortWords / 32];
    __shared__ int warp_sums[KS_THREADS / 32];
    __shared__ int longs[KS_THREADS];
    __shared__ int n_long;
    const int a = blockIdx.x * KS_THREADS + threadIdx.x;
    int s = 0, n = 0;
    if (a < g.Na) {
        s = off[a];
        n = off[a + 1] - s;
    }
    if (n >= 2 && n <= kSortShort) {
        int* seg = idx + s;
        for (int i = 1; i < n; ++i) {
            const int v = seg[i];
            int j = i - 1;
            while (j >= 0 && seg[j] < v) {
                seg[j + 1] = seg[j];
                --j;
            }
            seg[j + 1] = v;
        }
    }
    if (threadIdx.x == 0) n_long = 0;
    __syncthreads();
    if (n > kSortShort) longs[atomicAdd(&n_long, 1)] = a;
    __syncthreads();
    // each long segment's result is its own: the list's order is free
    for (int k = 0; k < n_long; ++k) {
        const int b = longs[k];
        sort_long_segment(b, off[b], off[b + 1] - off[b], idx, scratch, g,
                          bits, warp_sums);
    }
}

// Run k's next head: its source at position h + 1, or -1 past its end e.
__device__ __forceinline__ void run_advance(const int* __restrict__ idx,
                                            int& v, int& h, int e) {
    ++h;
    v = h < e ? idx[h] : -1;
}

// The next source of a texel's four sorted runs, in descending index (-1
// when all are spent); v_k is run k's head, h_k its position, e_k its end.
// (Written out run by run: a loop over the runs with an exit compiled to
// an indexed array in local memory.)
__device__ __forceinline__ int merge_next(const int* __restrict__ idx,
                                          int (&v)[4], int (&h)[4],
                                          const int (&e)[4]) {
    const int best = max(max(v[0], v[1]), max(v[2], v[3]));
    if (best >= 0) {
        if (v[0] == best) {
            run_advance(idx, v[0], h[0], e[0]);
        } else if (v[1] == best) {
            run_advance(idx, v[1], h[1], e[1]);
        } else if (v[2] == best) {
            run_advance(idx, v[2], h[2], e[2]);
        } else {
            run_advance(idx, v[3], h[3], e[3]);
        }
    }
    return best;
}

// The segments of texel (cy, cx) of the canvas: the anchors q - (1, 1)
// and q - (1, 0), then q - (0, 1) and q (two pairs of adjacent segments):
// starts h, ends e.
__device__ __forceinline__ void texel_runs(const int* __restrict__ off,
                                           const ScatterGeom& sg, int cy,
                                           int cx, int (&h)[4], int (&e)[4]) {
    const int* o0 = off + cy * sg.Wa + cx;
    const int* o1 = o0 + sg.Wa;
    h[0] = o0[0];
    h[1] = e[0] = o0[1];
    e[1] = o0[2];
    h[2] = o1[0];
    h[3] = e[2] = o1[1];
    e[3] = o1[2];
}

// The weight of source p at texel q (tile coordinates), as the parent
// rounds it: tent(m0 - oy) * tent(m1 - ox) at the offset o = q - p.
__device__ __forceinline__ float scatter_weight(float m0, float m1, int p,
                                                int qy, int qx, int W) {
    const int py = p / W, px = p - py * W;
    return tent(m0 - (float)(qy - py)) * tent(m1 - (float)(qx - px));
}

// A long texel's sums, by the calling warp (every lane gets them): each
// round loads the next 32 sources of each of the four runs, ranks the
// 128 candidates (how many are larger), takes the 32 largest (the next 32
// of the merge, in order), computes their products a lane each, and adds
// them in order, every lane the same floats.
template <int NP>
__device__ __forceinline__ void merge_long_texel(
    const float* __restrict__ motion, const float* __restrict__ g,
    const int* __restrict__ off, const int* __restrict__ idx, int np,
    const ScatterGeom& sg, int cy, int cx, int* sel, float (&acc)[NP]) {
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x, hw = sg.H * sg.W;
    const int qy = cy - sg.hm, qx = cx - sg.hm;
    int h[4], e[4];
    texel_runs(off, sg, cy, cx, h, e);
#pragma unroll
    for (int c = 0; c < NP; ++c) acc[c] = 0.0f;
    while (h[0] < e[0] || h[1] < e[1] || h[2] < e[2] || h[3] < e[3]) {
        int cand[4], rank[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            cand[k] = h[k] + lane < e[k] ? idx[h[k] + lane] : -1;
            rank[k] = 0;
        }
#pragma unroll 4
        for (int l2 = 0; l2 < 32; ++l2) {
            int v[4];
#pragma unroll
            for (int k2 = 0; k2 < 4; ++k2) {
                v[k2] = __shfl_sync(full, cand[k2], l2);
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                rank[k] += (v[0] > cand[k]) + (v[1] > cand[k])
                    + (v[2] > cand[k]) + (v[3] > cand[k]);
            }
        }
        int n = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const bool take = cand[k] >= 0 && rank[k] < 32;
            if (take) sel[rank[k]] = cand[k];
            const int taken = __popc(__ballot_sync(full, take));
            h[k] += taken;
            n += taken;
        }
        __syncwarp();
        float prod[NP];
        const int p = sel[lane];
#pragma unroll
        for (int c = 0; c < NP; ++c) prod[c] = 0.0f;
        if (lane < n) {
            const float w = scatter_weight(motion[p], motion[hw + p], p, qy,
                                           qx, sg.W);
#pragma unroll
            for (int c = 0; c < NP; ++c) {
                if (c < np) prod[c] = w * g[c * hw + p];
            }
        }
        for (int j = 0; j < n; ++j) {
#pragma unroll
            for (int c = 0; c < NP; ++c) {
                const float t = __shfl_sync(full, prod[c], j);
                if (c < np) acc[c] = acc[c] + t;
            }
        }
        __syncwarp();
    }
}

// 5. The gather: texel q of the canvas takes w * g[p] from the sources of
// the anchors q - (1, 1), q - (1, 0), q - (0, 1) and q, merged in
// descending source index (the parent's order), kMergeBatch at a time
// (their loads go out together), with the parent's weight and rounding;
// a texel of more than kLongTexel sources is left to a warp of the block
// (merge_long_texel), the block's long texels one a warp.  A 32 x 8
// block writes its texels' 10 planes, zeros beyond np.
template <int NP>
__global__ void __launch_bounds__(KT_X * KT_Y)
scatter_gather_kernel(const float* __restrict__ motion,
                      const float* __restrict__ g, const int* __restrict__ off,
                      const int* __restrict__ idx, float* __restrict__ dh,
                      int np, ScatterGeom sg) {
    __shared__ int long_list[KT_X * KT_Y];
    __shared__ int n_long;
    __shared__ float long_acc[KT_X * KT_Y][NP];
    __shared__ int sel[KT_Y][32];
    const int tid = threadIdx.y * KT_X + threadIdx.x;
    const int cx = blockIdx.x * KT_X + threadIdx.x;
    const int cy = blockIdx.y * KT_Y + threadIdx.y;
    const bool live = cy < sg.Hc && cx < sg.Wc;
    const int hw = sg.H * sg.W;
    const int qy = cy - sg.hm, qx = cx - sg.hm;
    float acc[NP];
#pragma unroll
    for (int c = 0; c < NP; ++c) acc[c] = 0.0f;
    bool is_long = false;
    if (live && qy >= sg.ylo && qy <= sg.yhi && qx >= sg.xlo
        && qx <= sg.xhi) {
        int h[4], e[4];
        texel_runs(off, sg, cy, cx, h, e);
        is_long = (e[0] - h[0]) + (e[1] - h[1]) + (e[2] - h[2])
            + (e[3] - h[3]) > kLongTexel;
        int v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            v[k] = !is_long && h[k] < e[k] ? idx[h[k]] : -1;
        }
#pragma unroll 1
        while (true) {
            int p[kMergeBatch];
#pragma unroll
            for (int b = 0; b < kMergeBatch; ++b) p[b] = merge_next(idx, v, h, e);
            if (p[0] < 0) break;
            float m0[kMergeBatch], m1[kMergeBatch], gv[kMergeBatch][NP];
#pragma unroll
            for (int b = 0; b < kMergeBatch; ++b) {
                const int s = max(p[b], 0);
                m0[b] = motion[s];
                m1[b] = motion[hw + s];
#pragma unroll
                for (int c = 0; c < NP; ++c) {
                    gv[b][c] = p[b] >= 0 && c < np ? g[c * hw + s] : 0.0f;
                }
            }
#pragma unroll
            for (int b = 0; b < kMergeBatch; ++b) {
                if (p[b] >= 0) {
                    const float w = scatter_weight(m0[b], m1[b], p[b], qy,
                                                   qx, sg.W);
#pragma unroll
                    for (int c = 0; c < NP; ++c) {
                        if (c < np) acc[c] = acc[c] + w * gv[b][c];
                    }
                }
            }
        }
    }
    if (tid == 0) n_long = 0;
    __syncthreads();
    if (is_long) long_list[atomicAdd(&n_long, 1)] = tid;
    __syncthreads();
    if (n_long) {
        // each long texel's result is its own: the list's order is free
        for (int k = threadIdx.y; k < n_long; k += KT_Y) {
            const int t = long_list[k];
            float sum[NP];
            merge_long_texel<NP>(motion, g, off, idx, np, sg,
                                 blockIdx.y * KT_Y + t / KT_X,
                                 blockIdx.x * KT_X + t % KT_X,
                                 sel[threadIdx.y], sum);
            if (threadIdx.x == 0) {
#pragma unroll
                for (int c = 0; c < NP; ++c) long_acc[t][c] = sum[c];
            }
        }
        __syncthreads();
        if (is_long) {
#pragma unroll
            for (int c = 0; c < NP; ++c) acc[c] = long_acc[tid][c];
        }
    }
    if (!live) return;
    float* d = dh + cy * sg.Wc + cx;
    const int ps = sg.Hc * sg.Wc;
#pragma unroll
    for (int c = 0; c < 10; ++c) d[c * ps] = c < NP ? acc[c] : 0.0f;
}

// K5's motion term (motion_term) at every pixel of the tile, one a thread:
// the scatter route's last launch.
template <bool TILE>
__global__ void __launch_bounds__(KT_X * KT_Y)
motion_term_kernel(const float* __restrict__ hist,
                   const float* __restrict__ motion,
                   const float* __restrict__ g, float* __restrict__ dm,
                   int H, int W, int M, int np, TemporalTile t) {
    const int x = blockIdx.x * KT_X + threadIdx.x;
    const int y = blockIdx.y * KT_Y + threadIdx.y;
    if (x < W && y < H) motion_term<TILE>(hist, motion, g, dm, H, W, M, np,
                                          t, y, x);
}

constexpr int KG_PLANES = 10;

// The NP leading planes of texel q of the channel-minor stack, in float2
// loads (a texel's 40 bytes are 8-byte aligned: the launch checks the
// stack's start).
template <int NP>
__device__ __forceinline__ void load_texel(const float* __restrict__ s,
                                           int q, float (&a)[NP]) {
    static_assert(NP % 2 == 0 && NP <= KG_PLANES, "whole float2 of a texel");
    const float2* v = reinterpret_cast<const float2*>(s + q * KG_PLANES);
#pragma unroll
    for (int j = 0; j < NP / 2; ++j) {
        const float2 t = v[j];
        a[2 * j] = t.x;
        a[2 * j + 1] = t.y;
    }
}

// KG on the channel-minor stack of the 10 history planes: one thread a
// pixel, its 40 loads issued before its multiply-adds.  A tap's planes
// are 40 bytes at 40 q, and the right tap's follow them: a row's two taps
// are one run of 80 bytes, which starts 16-byte aligned at an even q
// (five float4 loads) and 8 bytes past at an odd one (a float2, four
// float4, a float2).  So a pixel issues 10-12 loads, not 20 float2, and a
// warp's load instruction, whose lanes take one side of the parity each,
// touches about half the cache lines: on random motion the lines a load
// instruction touches (one a lane) are what holds the gather.  A tap
// clamped onto its neighbour (the last column) loads its texel alone.
__device__ __forceinline__ void load_run(const float* __restrict__ s, int q,
                                         float (&a)[KG_PLANES],
                                         float (&b)[KG_PLANES]) {
    const float* r = s + q * KG_PLANES;
    float v[2 * KG_PLANES];
    if ((q & 1) == 0) {
#pragma unroll
        for (int j = 0; j < 5; ++j) {
            const float4 t = reinterpret_cast<const float4*>(r)[j];
            v[4 * j] = t.x;
            v[4 * j + 1] = t.y;
            v[4 * j + 2] = t.z;
            v[4 * j + 3] = t.w;
        }
    } else {
        const float2 h = reinterpret_cast<const float2*>(r)[0];
        const float2 e = reinterpret_cast<const float2*>(r)[9];
        v[0] = h.x;
        v[1] = h.y;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float4 t = reinterpret_cast<const float4*>(r + 2)[j];
            v[2 + 4 * j] = t.x;
            v[3 + 4 * j] = t.y;
            v[4 + 4 * j] = t.z;
            v[5 + 4 * j] = t.w;
        }
        v[18] = e.x;
        v[19] = e.y;
    }
#pragma unroll
    for (int k = 0; k < KG_PLANES; ++k) {
        a[k] = v[k];
        b[k] = v[KG_PLANES + k];
    }
}

__global__ void __launch_bounds__(256)
clamped_gather_kernel(const float* __restrict__ stack,
                      const float* __restrict__ motion,
                      float* __restrict__ out, int H, int W) {
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= W || y >= H) return;
    const int hw = H * W, i = y * W + x;
    const ClampedTaps c = clamped_taps(motion, H, W, y, x);
    const float gx = 1.0f - c.fx, gy = 1.0f - c.fy;
    float a00[KG_PLANES], a01[KG_PLANES], a10[KG_PLANES], a11[KG_PLANES];
    if (c.i01 == c.i00 + 1) {
        load_run(stack, c.i00, a00, a01);
        load_run(stack, c.i10, a10, a11);
    } else {
        load_texel(stack, c.i00, a00);
        load_texel(stack, c.i01, a01);
        load_texel(stack, c.i10, a10);
        load_texel(stack, c.i11, a11);
    }
#pragma unroll
    for (int k = 0; k < KG_PLANES; ++k) {
        const float top = __fmaf_rn(a00[k], gx, a01[k] * c.fx);
        const float bot = __fmaf_rn(a10[k], gx, a11[k] * c.fx);
        out[k * hw + i] = __fmaf_rn(top, gy, bot * c.fy);
    }
}

// KGb's block: 32 x 8 threads, a warp a row of 32 pixels.  The history
// gradient has kGradPlanes planes (the temporal epilogue's).
constexpr int KGB_TX = 32, KGB_TY = 8;
constexpr int kGradPlanes = 6;

// KGb's scatter of a pixel's four clamped taps (c, weights from gx, gy)
// times its cotangent gk into the channel-minor float64 scratch (see the
// header); every thread of the block calls it, or none (dead pixels with
// c's taps at -1).
__device__ __forceinline__ void scatter_clamped_taps(
        const ClampedTaps& c, const float (&gk)[kGradPlanes], float gx,
        float gy, double* __restrict__ scratch) {
    constexpr int NP = kGradPlanes;
    constexpr unsigned kFull = 0xffffffffu;
    const int lane = threadIdx.x, wy = threadIdx.y;
    // a warp's addends of one tap, pixel-major (lane p's plane k at
    // p * NP + k), and their texels (-1: none); each warp's taps and its
    // bottom taps' addends for the warp below
    __shared__ double s_val[KGB_TY][KGB_TX * NP];
    __shared__ int s_q[KGB_TY][KGB_TX];
    __shared__ int s_taps[KGB_TY][4][KGB_TX];
    __shared__ double s_bottom[KGB_TY][2][NP][KGB_TX];

    // the float products, each added in float64 (taps 00, 01, 10, 11)
    int q[4] = {c.i00, c.i01, c.i10, c.i11};
    const float w[4] = {gy * gx, gy * c.fx, c.fy * gx, c.fy * c.fx};
    double v[4][NP];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int k = 0; k < NP; ++k) v[t][k] = (double)(gk[k] * w[t]);
    }
    // taps clamped onto one texel (at the last column 00 = 01 and 10 = 11,
    // at the last row 00 = 10 and 01 = 11) add up in the thread, into the
    // first of them
#pragma unroll
    for (int t = 1; t < 4; ++t) {
#pragma unroll
        for (int s = 0; s < t; ++s) {
            if (q[t] >= 0 && q[s] == q[t]) {
#pragma unroll
                for (int k = 0; k < NP; ++k) v[s][k] += v[t][k];
                q[t] = -1;
            }
        }
    }
    // a lane's right taps (01, 11) are often the next lane's left taps
    // (00, 10): where they are, the lane adds the next lane's addends after
    // its own, and the next lane drops them
#pragma unroll
    for (int r = 0; r < 4; r += 2) {
        const int q_next = __shfl_down_sync(kFull, q[r], 1);
        const int q_prev = __shfl_up_sync(kFull, q[r + 1], 1);
        const bool take = lane < 31 && q[r + 1] >= 0 && q_next == q[r + 1];
#pragma unroll
        for (int k = 0; k < NP; ++k) {
            const double nb = __shfl_down_sync(kFull, v[r][k], 1);
            if (take) v[r + 1][k] += nb;
        }
        if (lane > 0 && q[r] >= 0 && q_prev == q[r]) q[r] = -1;
    }
    // a pixel's bottom taps (10, 11) are often the top taps (00, 01) of
    // the pixel below it, the same lane of the next warp: where they are,
    // the lower pixel adds the upper one's addends after its own, and the
    // upper one drops them
#pragma unroll
    for (int t = 0; t < 4; ++t) s_taps[wy][t][lane] = q[t];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
        for (int k = 0; k < NP; ++k) s_bottom[wy][b][k][lane] = v[2 + b][k];
    }
    __syncthreads();
#pragma unroll
    for (int b = 0; b < 2; ++b) {
        if (wy > 0 && q[b] >= 0 && q[b] == s_taps[wy - 1][2 + b][lane]) {
#pragma unroll
            for (int k = 0; k < NP; ++k)
                v[b][k] += s_bottom[wy - 1][b][k][lane];
        }
        if (wy < KGB_TY - 1 && q[2 + b] >= 0
            && q[2 + b] == s_taps[wy + 1][b][lane]) {
            q[2 + b] = -1;
        }
    }
    // one tap at a time, the warp issues the tap's 32 x NP addends so that
    // consecutive lanes add into consecutive doubles of the scratch (NP
    // instructions, each over about 32 / NP texels, where one plane a lane
    // would touch 32)
    double* sv = s_val[wy];
    int* sq = s_q[wy];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        __syncwarp();
#pragma unroll
        for (int k = 0; k < NP; ++k) sv[lane * NP + k] = v[t][k];
        sq[lane] = q[t];
        __syncwarp();
#pragma unroll
        for (int e0 = 0; e0 < KGB_TX * NP; e0 += KGB_TX) {
            const int e = e0 + lane, p = e / NP;
            const int qt = sq[p];
            if (qt >= 0) atomicAdd(scratch + qt * NP + (e - p * NP), sv[e]);
        }
    }
}

// KGb (see the header).  scratch (channel-minor, kGradPlanes doubles a
// texel, zeroed; null: no history gradient) gets the scatter; d_motion
// (null: no motion gradient) the motion cotangent over those planes, read
// from the channel-minor stack in float2 loads.  A launch without the
// scatter keeps its shared memory: an instantiation without it (39
// registers against 64) ran 1.2x slower on random motion (H100).
__global__ void __launch_bounds__(KGB_TX * KGB_TY)
clamped_gather_bwd_kernel(const float* __restrict__ stack,
                          const float* __restrict__ motion,
                          const float* __restrict__ g,
                          double* __restrict__ scratch,
                          float* __restrict__ d_motion, int H, int W) {
    constexpr int NP = kGradPlanes;
    const int x = blockIdx.x * KGB_TX + threadIdx.x;
    const int y = blockIdx.y * KGB_TY + threadIdx.y;
    const bool live = x < W && y < H;
    const int hw = H * W, i = y * W + x;
    ClampedTaps c = {-1, -1, -1, -1, 0.0f, 0.0f};
    float gk[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) gk[k] = 0.0f;
    if (live) {
        c = clamped_taps(motion, H, W, y, x);
#pragma unroll
        for (int k = 0; k < NP; ++k) gk[k] = g[k * hw + i];
    }
    const float gx = 1.0f - c.fx, gy = 1.0f - c.fy;
    if (d_motion && live) {
        float a00[NP], a01[NP], a10[NP], a11[NP];
        load_texel(stack, c.i00, a00);
        load_texel(stack, c.i01, a01);
        load_texel(stack, c.i10, a10);
        load_texel(stack, c.i11, a11);
        float dfy = 0.0f, dfx = 0.0f;
#pragma unroll
        for (int k = 0; k < NP; ++k) {
            const float top = __fmaf_rn(a00[k], gx, a01[k] * c.fx);
            const float bot = __fmaf_rn(a10[k], gx, a11[k] * c.fx);
            dfy = dfy + gk[k] * (bot - top);
            dfx = dfx + gk[k] * (gy * (a01[k] - a00[k])
                                 + c.fy * (a11[k] - a10[k]));
        }
        d_motion[i] = dfy;
        d_motion[hw + i] = dfx;
    }
    if (scratch) scatter_clamped_taps(c, gk, gx, gy, scratch);
}

// KGp: the channel-minor stack of the 10 history planes (colour 3,
// moments 2, length, previous depth, previous normal 3) that KG and KGb
// read.  A block of KGP_TEXELS threads reads its texels' planes coalesced,
// one texel a thread, transposes them in shared memory and writes the
// block's contiguous 40 * KGP_TEXELS bytes as float4 (a thread writing
// its own texel's 40 bytes as float2 wrote each sector in five pieces and
// ran at 2.4x the bound on an H100).  Bound: memory, 80 B/px.
constexpr int KGP_TEXELS = 256;

__global__ void __launch_bounds__(KGP_TEXELS)
stack_channel_minor_kernel(const float* __restrict__ color,
                           const float* __restrict__ moments,
                           const float* __restrict__ length,
                           const float* __restrict__ depth,
                           const float* __restrict__ normal,
                           float* __restrict__ out, int n) {
    __shared__ float4 tile4[KGP_TEXELS * KG_PLANES / 4];
    float* tile = reinterpret_cast<float*>(tile4);
    const int e0 = blockIdx.x * KGP_TEXELS, e = e0 + threadIdx.x;
    if (e < n) {
        const float v[KG_PLANES] = {color[e], color[n + e],
                                    color[2 * n + e], moments[e],
                                    moments[n + e], length[e], depth[e],
                                    normal[e], normal[n + e],
                                    normal[2 * n + e]};
#pragma unroll
        for (int k = 0; k < KG_PLANES; ++k)
            tile[threadIdx.x * KG_PLANES + k] = v[k];
    }
    __syncthreads();
    // the block's floats: whole float4 (its start is 16-byte aligned: 40
    // bytes a texel, KGP_TEXELS texels a block), then any tail
    const int m = min(KGP_TEXELS, n - e0) * KG_PLANES;
    float4* o4 = reinterpret_cast<float4*>(out + e0 * KG_PLANES);
    for (int j = threadIdx.x; j < m / 4; j += KGP_TEXELS) o4[j] = tile4[j];
    for (int j = m / 4 * 4 + threadIdx.x; j < m; j += KGP_TEXELS)
        out[e0 * KG_PLANES + j] = tile[j];
}

// d_stack's first kGradPlanes planes of n elements, rounded once from the
// channel-minor float64 scratch.
__global__ void round_planes_kernel(const double* __restrict__ scratch,
                                    float* __restrict__ d_stack, int n) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    const double2* s = reinterpret_cast<const double2*>(
        scratch + e * kGradPlanes);
#pragma unroll
    for (int j = 0; j < kGradPlanes / 2; ++j) {
        const double2 v = s[j];
        d_stack[2 * j * n + e] = (float)v.x;
        d_stack[(2 * j + 1) * n + e] = (float)v.y;
    }
}

// K16: the adjoint, with respect to the render, of the bounded whole-frame
// step (see the header).  A block of 32 x 8 threads, one output pixel a
// thread, stages its render tile with a 6-pixel halo (cp.async, in flight
// while the threads regather their history) and runs three stages in
// shared memory, each in the plain twin's order (temporal_step_bwd_ref):
//   1. the clamp, a channel at a time: the rows' pass (min and max over a
//      column's 3 rows, K16Tile::cl.r) at rows -1..8 and columns -2..33;
//      at the tile and a 1-pixel ring, cmin and cmax (the columns' pass of
//      cl.r), the cotangents (1 - alpha) g of the clamped colour that
//      reach them, and the shares of each that the columns' pass sends to
//      the pixel and to its -x and +x neighbours (cl.s); at rows -1..8, the
//      rows' pass's cotangent (the pixel's own share, then its +x
//      neighbour's, then its -x neighbour's) and the shares of it that the
//      rows' pass sends to the pixel and to its -y and +y neighbours
//      (cl.v, in cl.r's memory); at the pixel, its own share, then its +y
//      neighbour's, then its -y neighbour's;
//   2. the moments and the temporal variance at the pixel, in registers;
//   3. where a pixel within 3 of the tile is short (__syncthreads_or), the
//      spatial variance: the 7-row sums of luma and luma^2 (K3's order),
//      each pixel's cotangents of its two window sums (vb.g1, vb.g2) at
//      rows -3..10 and columns -3..34, and their 7x7 window sums at the
//      tile (their own adjoint), in the same order.
// Threads outside the frame stay through every barrier.
constexpr int K16_TX = 32, K16_TY = 8, K16_HALO = 6;
// the ring of the clamp's cotangents around the tile: its top and bottom
// rows, then its left and right columns
constexpr int K16_RING = 2 * (K16_TX + 2) + 2 * K16_TY;

struct K16Tile {
    static constexpr int SW = K16_TX + 2 * K16_HALO;      // staged render
    static constexpr int SH = K16_TY + 2 * K16_HALO;
    static constexpr int CW = K16_TX + 2, CH = K16_TY + 2;   // tile + ring
    static constexpr int RW = K16_TX + 4;     // the rows' pass, cols -2..33
    static constexpr int VW = K16_TX + 6, VH = K16_TY + 6;   // 7x7 reach
    float c[3][SH][SW];     // the render (zero outside the frame)
    union {
        struct {            // one channel's clamp (min, max)
            union {
                float r[2][CH][RW];      // the rows' pass (+-inf out)
                float v[2][3][CH][K16_TX];   // shares of its cotangent:
                                             // own, to -y, to +y
            };
            float s[2][3][CH][CW];       // shares of cmin's, cmax's
                                         // cotangents: own, to -x, to +x
        } cl;
        struct {
            float l[SH][SW];             // luma
            float s1[VH][SW], s2[VH][SW];    // 7-row sums at rows -3..10
            float g1[VH][VW], g2[VH][VW];    // window sums' cotangents
            float t1[K16_TY][VW], t2[K16_TY][VW];  // their 7-row sums
        } vb;
    } u;
};

// The share a side takes of a link's cotangent: all where it alone is the
// extreme, half where the two tie (torch.minimum/maximum's rule).
__device__ __forceinline__ float tie_share(bool strict, bool tie) {
    return strict ? 1.0f : (tie ? 0.5f : 0.0f);
}

// The shares of the cotangent of m(m(a, b), c) (m = min for LO, else max)
// that reach a, b and c.
template <bool LO>
__device__ __forceinline__ void chain_shares(float a, float b, float c,
                                             float& wa, float& wb,
                                             float& wc) {
    // a link's two shares sum to 1 (0 and 1, or halves)
    const float o1 = LO ? fminf(a, b) : fmaxf(a, b);
    wc = tie_share(LO ? c < o1 : c > o1, c == o1);
    const float wo = 1.0f - wc;
    const float sa = tie_share(LO ? a < b : a > b, a == b);
    wa = wo * sa;
    wb = wo * (1.0f - sa);
}

// K3's reprojection of the 8 planes validity and the clamp read (colour,
// length, previous depth and normal), in its arithmetic: whether pixel
// (y, x) of the frame takes its history, and its history colour.
__device__ __forceinline__ bool k16_regather(
    const float* __restrict__ motion, const float* __restrict__ depth,
    const float* __restrict__ normal, const float* __restrict__ h_color,
    const float* __restrict__ h_length, const float* __restrict__ h_depth,
    const float* __restrict__ h_normal, int H, int W, int M, int y, int x,
    float prev[3]) {
    const int hw = H * W, i = y * W + x;
    const float* planes[8] = {h_color, h_color + hw, h_color + 2 * hw,
                              h_length, h_depth, h_normal, h_normal + hw,
                              h_normal + 2 * hw};
    float g[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) g[j] = 0.0f;
    const float m0 = motion[i], m1 = motion[hw + i];
    const float ys = (float)y + m0, xs = (float)x + m1;
    const bool within = fabsf(m0) <= (float)M && fabsf(m1) <= (float)M;
    const bool in_bounds = ys >= 0.0f && ys <= (float)(H - 1) && xs >= 0.0f
        && xs <= (float)(W - 1) && within;
    if (within) {
        const float y0 = floorf(m0), x0 = floorf(m1);
        for (int ay = 0; ay <= 1; ++ay) {
            const float dyf = y0 + (float)ay;
            const float ty = fmaxf(1.0f - fabsf(m0 - dyf), 0.0f);
            const int ry = y + (int)dyf;
            for (int ax = 0; ax <= 1; ++ax) {
                const float dxf = x0 + (float)ax;
                const float tx = fmaxf(1.0f - fabsf(m1 - dxf), 0.0f);
                const int rx = x + (int)dxf;
                const bool inside = ry >= 0 && ry < H && rx >= 0 && rx < W;
                const float w = ty * tx;
                const int q = ry * W + rx;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    g[j] = __fmaf_rn(w, inside ? planes[j][q] : 0.0f, g[j]);
                }
            }
        }
    }
    prev[0] = g[0];
    prev[1] = g[1];
    prev[2] = g[2];
    const float z = depth[i];
    const bool depth_ok = fabsf(g[4] - z) <= 0.1f * fmaxf(fabsf(z), 1e-3f);
    const float ndot = g[5] * normal[i] + g[6] * normal[hw + i]
        + g[7] * normal[2 * hw + i];
    return in_bounds && depth_ok && ndot > 0.8f && g[3] > 0.0f;
}

__global__ void __launch_bounds__(K16_TX * K16_TY)
temporal_bwd_kernel(const float* __restrict__ render,
                    const float* __restrict__ motion,
                    const float* __restrict__ depth,
                    const float* __restrict__ normal,
                    const float* __restrict__ h_color,
                    const float* __restrict__ h_length,
                    const float* __restrict__ h_depth,
                    const float* __restrict__ h_normal,
                    const float* __restrict__ moments,
                    const float* __restrict__ n_new,
                    const float* __restrict__ g_integ,
                    const float* __restrict__ g_var,
                    const float* __restrict__ g_mom,
                    float* __restrict__ d_render, TemporalParams p) {
    using T = K16Tile;
    __shared__ T sm;
    const int H = p.H, W = p.W, hw = H * W;
    const int bx0 = blockIdx.x * K16_TX, by0 = blockIdx.y * K16_TY;
    const int tid = threadIdx.y * K16_TX + threadIdx.x;
    constexpr int NT = K16_TX * K16_TY;

    for (int e = tid; e < T::SH * T::SW; e += NT) {
        const int sy = e / T::SW, sx = e - sy * T::SW;
        const int ry = by0 + sy - K16_HALO, rx = bx0 + sx - K16_HALO;
        if (ry >= 0 && ry < H && rx >= 0 && rx < W) {
            const int q = ry * W + rx;
            cp_async4(&sm.c[0][sy][sx], render + q);
            cp_async4(&sm.c[1][sy][sx], render + hw + q);
            cp_async4(&sm.c[2][sy][sx], render + 2 * hw + q);
        } else {
            sm.c[0][sy][sx] = 0.0f;
            sm.c[1][sy][sx] = 0.0f;
            sm.c[2][sy][sx] = 0.0f;
        }
    }

    // the clamp's positions: the thread's pixel (k = 0) and one pixel of
    // the ring (k = 1, the first K16_RING threads); the history regathered
    // while the render tile is in flight
    const int y = by0 + threadIdx.y, x = bx0 + threadIdx.x;
    const bool live = y < H && x < W;
    int cy[2], cx[2];
    bool at[2];
    float gp[2][3], prev[2][3];
    bool valid = false;
    float alpha = 0.0f, alpha_m = 0.0f, nn = 1.0f, gi[3] = {0, 0, 0};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        if (k == 0) {
            cy[k] = threadIdx.y;
            cx[k] = threadIdx.x;
        } else {
            const int e = tid;
            cy[k] = e < K16_TX + 2 ? -1
                : e < 2 * (K16_TX + 2) ? K16_TY
                : e < 2 * (K16_TX + 2) + K16_TY ? e - 2 * (K16_TX + 2)
                : e - 2 * (K16_TX + 2) - K16_TY;
            cx[k] = e < K16_TX + 2 ? e - 1
                : e < 2 * (K16_TX + 2) ? e - (K16_TX + 2) - 1
                : e < 2 * (K16_TX + 2) + K16_TY ? -1 : K16_TX;
        }
        const int py = by0 + cy[k], px = bx0 + cx[k];
        at[k] = (k == 0 || (p.history_clamp && tid < K16_RING)) && py >= 0
            && py < H && px >= 0 && px < W;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) gp[k][ch] = prev[k][ch] = 0.0f;
        if (!at[k]) continue;
        const int i = py * W + px;
        float g[3] = {0.0f, 0.0f, 0.0f};
        if (g_integ) {
            g[0] = g_integ[i];
            g[1] = g_integ[hw + i];
            g[2] = g_integ[2 * hw + i];
        }
        const float n = n_new[i];
        const float a = fmaxf(1.0f / n, p.alpha);
        const bool v = k16_regather(motion, depth, normal, h_color, h_length,
                                    h_depth, h_normal, H, W, p.max_motion,
                                    py, px, prev[k]);
        if (p.history_clamp && v) {
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) gp[k][ch] = g[ch] * (1.0f - a);
        }
        if (k == 0) {
            valid = v;
            alpha = a;
            alpha_m = fmaxf(1.0f / n, p.alpha_m);
            nn = n;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) gi[ch] = g[ch];
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    const int ly = threadIdx.y + K16_HALO, lx = threadIdx.x + K16_HALO;
    float clamp[3] = {0.0f, 0.0f, 0.0f};
    // 1. the clamp, a channel at a time
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        if (!p.history_clamp) break;
        // the rows' pass (min and max over a column's 3 rows) at rows
        // -1..8 and columns -2..33; +-inf outside the frame
        for (int e = tid; e < T::CH * T::RW; e += NT) {
            const int r = e / T::RW, s = e - r * T::RW;
            const int gy = by0 + r - 1, gx = bx0 + s - 2;
            const int sy = r - 1 + K16_HALO, sx = s - 2 + K16_HALO;
            const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
            const float a = sm.c[ch][sy][sx];
            const float up = gy - 1 >= 0 ? sm.c[ch][sy - 1][sx] : INFINITY;
            const float dn = gy + 1 < H ? sm.c[ch][sy + 1][sx] : INFINITY;
            const float upx = gy - 1 >= 0 ? sm.c[ch][sy - 1][sx] : -INFINITY;
            const float dnx = gy + 1 < H ? sm.c[ch][sy + 1][sx] : -INFINITY;
            sm.u.cl.r[0][r][s] = in ? fminf(fminf(a, up), dn) : INFINITY;
            sm.u.cl.r[1][r][s] = in ? fmaxf(fmaxf(a, upx), dnx) : -INFINITY;
        }
        __syncthreads();
        // at the tile and its ring: cmin and cmax (the columns' pass of
        // the rows' pass), their cotangents, and the shares of each that
        // the columns' pass sends to the pixel and to its -x and +x
        // neighbours
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            if (k == 1 && tid >= K16_RING) continue;
            const int dy = cy[k] + 1, dx = cx[k] + 1;
            float w[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
            float d[2] = {0.0f, 0.0f};
            if (at[k]) {
                const float* lo = &sm.u.cl.r[0][dy][cx[k] + 2];
                const float* hi = &sm.u.cl.r[1][dy][cx[k] + 2];
                chain_shares<true>(lo[0], lo[-1], lo[1], w[0][0], w[0][1],
                                   w[0][2]);
                chain_shares<false>(hi[0], hi[-1], hi[1], w[1][0], w[1][1],
                                    w[1][2]);
                const float cmin = fminf(fminf(lo[0], lo[-1]), lo[1]);
                const float cmax = fmaxf(fmaxf(hi[0], hi[-1]), hi[1]);
                const float pc = prev[k][ch];
                const float u = fmaxf(pc, cmin);
                d[1] = gp[k][ch] * tie_share(cmax < u, cmax == u);
                d[0] = gp[k][ch] * (tie_share(u < cmax, u == cmax)
                                    * tie_share(cmin > pc, cmin == pc));
            }
#pragma unroll
            for (int m = 0; m < 2; ++m) {
#pragma unroll
                for (int j = 0; j < 3; ++j) {
                    sm.u.cl.s[m][j][dy][dx] = d[m] * w[m][j];
                }
            }
        }
        __syncthreads();
        // at rows -1..8 of the tile's columns: the rows' pass's cotangent
        // (the pixel's own share, then its +x neighbour's, then its -x
        // neighbour's), and the shares of it that the rows' pass sends to
        // the pixel and to its -y and +y neighbours
        for (int e = tid; e < T::CH * K16_TX; e += NT) {
            const int r = e / K16_TX, s = e - r * K16_TX;
            const int gy = by0 + r - 1, gx = bx0 + s;
            const bool in = gy >= 0 && gy < H && gx < W;
            const int sy = r - 1 + K16_HALO, sx = s + K16_HALO;
            const float a = sm.c[ch][sy][sx];
            const float b = sm.c[ch][sy - 1][sx], c = sm.c[ch][sy + 1][sx];
            const bool up = gy - 1 >= 0, dn = gy + 1 < H;
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                float dr = 0.0f, w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
                if (in) {
                    const float* sa = &sm.u.cl.s[m][0][r][s + 1];
                    const float* sb = &sm.u.cl.s[m][1][r][s + 1];
                    const float* sc = &sm.u.cl.s[m][2][r][s + 1];
                    dr = (sa[0] + sb[1]) + sc[-1];
                    if (m == 0) {
                        chain_shares<true>(a, up ? b : INFINITY,
                                           dn ? c : INFINITY, w0, w1, w2);
                    } else {
                        chain_shares<false>(a, up ? b : -INFINITY,
                                            dn ? c : -INFINITY, w0, w1, w2);
                    }
                }
                sm.u.cl.v[m][0][r][s] = dr * w0;
                sm.u.cl.v[m][1][r][s] = dr * w1;
                sm.u.cl.v[m][2][r][s] = dr * w2;
            }
        }
        __syncthreads();
        // the pixel's own share, then its +y neighbour's, then its -y
        // neighbour's
        if (live) {
            float part[2];
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                const int r = threadIdx.y + 1, s = threadIdx.x;
                part[m] = (sm.u.cl.v[m][0][r][s] + sm.u.cl.v[m][1][r + 1][s])
                    + sm.u.cl.v[m][2][r - 1][s];
            }
            clamp[ch] = part[0] + part[1];
        }
        // the next channel's rows' pass overwrites cl.v
        __syncthreads();
    }

    // 2. the moments and the temporal variance at the pixel
    const bool short_px = live && p.boost_frames > 0
        && nn < (float)p.boost_frames;
    float dlum_m = 0.0f, lum = 0.0f;
    if (live) {
        const int i = y * W + x;
        lum = kL0 * sm.c[0][ly][lx] + kL1 * sm.c[1][ly][lx]
            + kL2 * sm.c[2][ly][lx];
        const float m0 = moments[i], m1 = moments[hw + i];
        const float gv = g_var ? g_var[i] : 0.0f;
        const float gm0 = g_mom ? g_mom[i] : 0.0f;
        const float gm1 = g_mom ? g_mom[hw + i] : 0.0f;
        const float t = m1 - m0 * m0;
        const float dv = short_px ? 0.0f : gv * tie_share(t > 0.0f, t == 0.0f);
        const float d_m1 = gm1 + dv;
        const float sq = dv * m0;
        const float d_m0 = gm0 - (sq + sq);
        const float am = valid ? alpha_m : 1.0f;
        const float t1 = (d_m1 * am) * lum;
        dlum_m = (d_m0 * am) + (t1 + t1);
    }

    // 3. the spatial variance, where a pixel within 3 of the tile is short
    constexpr int NV = (T::VH * T::VW + NT - 1) / NT;
    bool vshort[NV];
    float vg[NV];
    bool any = false;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
        const int e = tid + k * NT;
        const int vy = e / T::VW, vx = e - vy * T::VW;
        const int gy = by0 + vy - 3, gx = bx0 + vx - 3;
        vshort[k] = false;
        vg[k] = 0.0f;
        if (p.boost_frames > 0 && e < T::VH * T::VW && gy >= 0 && gy < H
            && gx >= 0 && gx < W) {
            const int i = gy * W + gx;
            vshort[k] = n_new[i] < (float)p.boost_frames;
            vg[k] = g_var ? g_var[i] : 0.0f;
            any = any || vshort[k];
        }
    }
    float dlum_s = 0.0f;
    if (__syncthreads_or(any)) {
        for (int e = tid; e < T::SH * T::SW; e += NT) {
            const int sy = e / T::SW, sx = e - sy * T::SW;
            sm.u.vb.l[sy][sx] = kL0 * sm.c[0][sy][sx] + kL1 * sm.c[1][sy][sx]
                + kL2 * sm.c[2][sy][sx];
        }
        __syncthreads();
        // 7-row sums of luma and luma^2 at rows -3..10 (K3's order)
        for (int e = tid; e < T::VH * T::SW; e += NT) {
            const int r = e / T::SW, sx = e - r * T::SW;
            const int gx = bx0 + sx - K16_HALO;
            float a1 = 0.0f, a2 = 0.0f;
            if (gx >= 0 && gx < W) {
                const int sy = r + K16_HALO - 3;
                a1 = sm.u.vb.l[sy][sx];
                a2 = a1 * a1;
                for (int d = 1; d <= 3; ++d) {
                    const float lp = sm.u.vb.l[sy + d][sx];
                    const float lm = sm.u.vb.l[sy - d][sx];
                    a1 = (a1 + lp) + lm;
                    a2 = (a2 + lp * lp) + lm * lm;
                }
            }
            sm.u.vb.s1[r][sx] = a1;
            sm.u.vb.s2[r][sx] = a2;
        }
        __syncthreads();
        // each pixel's cotangents of its two window sums
#pragma unroll
        for (int k = 0; k < NV; ++k) {
            const int e = tid + k * NT;
            if (e >= T::VH * T::VW) continue;
            const int vy = e / T::VW, vx = e - vy * T::VW;
            const int gy = by0 + vy - 3, gx = bx0 + vx - 3;
            float g1 = 0.0f, g2 = 0.0f;
            if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
                const int sx = vx - 3 + K16_HALO;
                float s1 = sm.u.vb.s1[vy][sx], s2 = sm.u.vb.s2[vy][sx];
                for (int d = 1; d <= 3; ++d) {
                    s1 = s1 + sm.u.vb.s1[vy][sx + d];
                    s2 = s2 + sm.u.vb.s2[vy][sx + d];
                    s1 = s1 + sm.u.vb.s1[vy][sx - d];
                    s2 = s2 + sm.u.vb.s2[vy][sx - d];
                }
                const float fy = (float)gy, fx = (float)gx;
                const float cyn = fminf(fy, 3.0f)
                    + fminf((float)(H - 1) - fy, 3.0f) + 1.0f;
                const float cxn = fminf(fx, 3.0f)
                    + fminf((float)(W - 1) - fx, 3.0f) + 1.0f;
                const float inv = 1.0f / (cyn * cxn);
                const float sm1 = s1 * inv, sm2 = s2 * inv;
                const float ts = sm2 - sm1 * sm1;
                const float dvs = vshort[k]
                    ? vg[k] * tie_share(ts > 0.0f, ts == 0.0f) : 0.0f;
                const float q = dvs * sm1;
                g1 = (-(q + q)) * inv;
                g2 = dvs * inv;
            }
            sm.u.vb.g1[vy][vx] = g1;
            sm.u.vb.g2[vy][vx] = g2;
        }
        __syncthreads();
        // their 7x7 window sums at the tile: 7-row sums, then the row
        for (int e = tid; e < K16_TY * T::VW; e += NT) {
            const int r = e / T::VW, s = e - r * T::VW;
            float a1 = sm.u.vb.g1[r + 3][s], a2 = sm.u.vb.g2[r + 3][s];
            for (int d = 1; d <= 3; ++d) {
                a1 = (a1 + sm.u.vb.g1[r + 3 + d][s]) + sm.u.vb.g1[r + 3 - d][s];
                a2 = (a2 + sm.u.vb.g2[r + 3 + d][s]) + sm.u.vb.g2[r + 3 - d][s];
            }
            sm.u.vb.t1[r][s] = a1;
            sm.u.vb.t2[r][s] = a2;
        }
        __syncthreads();
        const float* t1 = &sm.u.vb.t1[threadIdx.y][threadIdx.x + 3];
        const float* t2 = &sm.u.vb.t2[threadIdx.y][threadIdx.x + 3];
        float w1 = t1[0], w2 = t2[0];
        for (int d = 1; d <= 3; ++d) {
            w1 = (w1 + t1[d]) + t1[-d];
            w2 = (w2 + t2[d]) + t2[-d];
        }
        const float tt = w2 * lum;
        dlum_s = w1 + (tt + tt);
    }

    if (!live) return;
    const int i = y * W + x;
    const float dlum = dlum_m + dlum_s;
    const float own_w = valid ? alpha : 1.0f;
    const float kl[3] = {kL0, kL1, kL2};
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
        d_render[ch * hw + i] = (gi[ch] * own_w + clamp[ch]) + kl[ch] * dlum;
    }
}

bool aligned(const void* p, unsigned long long bytes) {
    return ((unsigned long long)p & (bytes - 1)) == 0;
}

// Whether the kernels take a stack of P planes with texel stride ts: the
// 10 history planes channel-minor, 16-byte aligned (KG's float4 loads).
bool channel_minor_stack(const float* stack, int P, int ts) {
    return P == KG_PLANES && ts == KG_PLANES && aligned(stack, 16);
}

}  // namespace

// The clamped gather of the P = 10 history planes, channel-minor (texel
// stride ts = 10; any other stack is refused), and its adjoint (see the
// header).
extern "C" int rdt_clamped_gather(const float* stack, const float* motion,
                                  float* out, int H, int W, int P, int ts,
                                  void* stream) {
    if (!channel_minor_stack(stack, P, ts)) {
        return (int)cudaErrorInvalidValue;
    }
    dim3 block(32, 8);
    dim3 grid((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
    clamped_gather_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        stack, motion, out, H, W);
    return (int)cudaGetLastError();
}

// d_stack (P planes, planar; may be null) needs scratch, room for
// grad_planes (kGradPlanes) float64 planes, which the call zeroes.
extern "C" int rdt_clamped_gather_bwd(const float* stack, const float* motion,
                                      const float* g, float* d_stack,
                                      double* scratch, float* d_motion,
                                      int H, int W, int grad_planes, int P,
                                      int ts, void* stream) {
    if (!channel_minor_stack(stack, P, ts) || grad_planes != kGradPlanes
        || (d_stack && !scratch)) {
        return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t s = (cudaStream_t)stream;
    const int n = H * W;
    if (d_stack) {
        cudaError_t err = cudaMemsetAsync(
            scratch, 0, sizeof(double) * kGradPlanes * (size_t)n, s);
        if (err == cudaSuccess) {
            err = cudaMemsetAsync(d_stack + (size_t)kGradPlanes * n, 0,
                                  sizeof(float) * (KG_PLANES - kGradPlanes)
                                  * (size_t)n, s);
        }
        if (err != cudaSuccess) return (int)err;
    }
    dim3 block(KGB_TX, KGB_TY);
    dim3 grid((W + KGB_TX - 1) / KGB_TX, (H + KGB_TY - 1) / KGB_TY);
    clamped_gather_bwd_kernel<<<grid, block, 0, s>>>(
        stack, motion, g, d_stack ? scratch : nullptr, d_motion, H, W);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || !d_stack) return (int)err;
    round_planes_kernel<<<(n + 255) / 256, 256, 0, s>>>(scratch, d_stack, n);
    return (int)cudaGetLastError();
}

// KGp: out (16-byte aligned) gets the n texels' 10 planes, channel-minor.
extern "C" int rdt_stack_channel_minor(const float* color,
                                       const float* moments,
                                       const float* length, const float* depth,
                                       const float* normal, float* out, int n,
                                       void* stream) {
    if (!aligned(out, 16)) return (int)cudaErrorInvalidValue;
    stack_channel_minor_kernel<<<(n + KGP_TEXELS - 1) / KGP_TEXELS,
                                 KGP_TEXELS, 0, (cudaStream_t)stream>>>(
        color, moments, length, depth, normal, out, n);
    return (int)cudaGetLastError();
}

// K3, K3b; K3's unbounded step (the clamped gather) where
// params->max_motion is -1, which a tile refuses.
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
    const bool clamped = params->max_motion == -1;
    if (params->max_motion < -1 || (clamped && tile)) {
        return (int)cudaErrorInvalidValue;
    }
#define RDT_TEMPORAL(T, C)                                                \
    temporal_kernel<T, PX, C><<<grid, block, 0, s>>>(                     \
        render, motion, depth, normal, h_color, h_moments, h_length,      \
        h_depth, h_normal, out_integ, out_var, out_moments, out_length,   \
        *params, t)
    if (tile) {
        RDT_TEMPORAL(true, false);
    } else if (clamped) {
        RDT_TEMPORAL(false, true);
    } else {
        RDT_TEMPORAL(false, false);
    }
#undef RDT_TEMPORAL
    return (int)cudaGetLastError();
}

// K4, K4c (tile given).
extern "C" int rdt_gather(const float* stack, const float* motion, float* out,
                          int H, int W, int max_motion,
                          const TemporalTile* tile, void* stream) {
    const dim3 block(KT_X, KT_Y);
    const dim3 grid((W + KT_X - 1) / KT_X, (H + KT_Y - 1) / KT_Y);
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

// K5/K6's shared memory: the motion (two floats) and the code of each of
// a gather block's (KT_Y + 2M + 1) x (KT_X + 2M + 1) sources.
static size_t gather_bwd_smem(int M) {
    const size_t n = (size_t)(KT_Y + 2 * (size_t)M + 1)
        * (KT_X + 2 * (size_t)M + 1);
    return (2 * sizeof(float) + sizeof(int)) * n;
}

// The shared memory a block can have (sm_90): the staged gather takes
// max_motion up to 59 (225 KB), the scatter route any.
constexpr size_t kSmemOptin = 227 * 1024;

static int grid_1d(long long n) {
    return (int)((n + KS_THREADS - 1) / KS_THREADS);
}

// The scatter route's launches (see the header), on the workspace ws of
// ws_ints ints: counts, offsets, the scan's block sums, source indices.
template <bool TILE, bool MG, int NP>
static int launch_gather_bwd_scatter(const float* hist, const float* motion,
                                     const float* g, float* dh, float* dm,
                                     int H, int W, int M, int np,
                                     const TemporalTile& t, int* ws,
                                     int ws_ints, cudaStream_t s) {
    const ScatterGeom sg = scatter_geom<TILE>(H, W, M, t);
    if (!ws || ws_ints < scatter_workspace_ints(sg) || !aligned(ws, 16)) {
        return (int)cudaErrorInvalidValue;
    }
    const long long nc = scatter_counts(sg);
    const int nb = (int)(nc / kScanBlock);
    int* count = ws;
    int* off = count + nc;
    int* bsum = off + nc;
    int* idx = bsum + (nb + 3) / 4 * 4;
    cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int) * nc, s);
    if (err != cudaSuccess) return (int)err;
    const int n_src = grid_1d((long long)H * W);
    scatter_count_kernel<<<n_src, KS_THREADS, 0, s>>>(motion, count, sg);
    scan_blocks_kernel<<<nb, KS_THREADS, 0, s>>>(count, off, bsum);
    scan_sums_kernel<<<1, KS_THREADS, 0, s>>>(bsum, nb);
    scan_add_kernel<<<grid_1d(nc / 4), KS_THREADS, 0, s>>>(off, bsum, nc);
    scatter_place_kernel<<<n_src, KS_THREADS, 0, s>>>(motion, count, off, idx,
                                                       sg);
    scatter_sort_kernel<<<grid_1d(sg.Na), KS_THREADS, 0, s>>>(off, idx, count,
                                                              sg);
    const dim3 block(KT_X, KT_Y);
    const dim3 grid((sg.Wc + KT_X - 1) / KT_X, (sg.Hc + KT_Y - 1) / KT_Y);
    scatter_gather_kernel<NP><<<grid, block, 0, s>>>(motion, g, off, idx, dh,
                                                      np, sg);
    if (MG) {
        const dim3 px((W + KT_X - 1) / KT_X, (H + KT_Y - 1) / KT_Y);
        motion_term_kernel<TILE><<<px, block, 0, s>>>(hist, motion, g, dm, H,
                                                      W, M, np, t);
    }
    return (int)cudaGetLastError();
}

template <bool TILE, bool MG, int NP>
static int launch_gather_bwd(const float* hist, const float* motion,
                             const float* g, float* dh, float* dm, int H,
                             int W, int M, int np, const TemporalTile& t,
                             int* ws, int ws_ints, cudaStream_t s) {
    if (ws) {
        // the bucketed scatter (max_motion > 59, or asked for)
        return launch_gather_bwd_scatter<TILE, MG, NP>(
            hist, motion, g, dh, dm, H, W, M, np, t, ws, ws_ints, s);
    }
    const size_t smem = gather_bwd_smem(M);
    if (smem > kSmemOptin) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            gather_bwd_kernel<TILE, MG, NP>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int hm = TILE ? t.h_m : 0;
    const dim3 block(KT_X, KT_Y);
    const dim3 grid((W + 2 * hm + KT_X - 1) / KT_X,
                    (H + 2 * hm + KT_Y - 1) / KT_Y);
    gather_bwd_kernel<TILE, MG, NP><<<grid, block, smem, s>>>(
        hist, motion, g, dh, dm, H, W, M, np, t);
    return (int)cudaGetLastError();
}

// K5/K6, K5c/K6c (tile given): dh (the history canvas's shape) is written
// whole; dm is written by K5 (motion_grad) only.  Given the workspace ws
// (ws_ints ints, 16-byte aligned; scatter_workspace_ints, and
// utils/tiling.py's), the scatter route runs, which max_motion past 59
// needs; null, the staged gather.
extern "C" int rdt_gather_bwd(const float* hist, const float* motion,
                              const float* g, float* dh, float* dm, int H,
                              int W, int max_motion, int grad_planes,
                              int motion_grad, const TemporalTile* tile,
                              int* ws, int ws_ints, void* stream) {
    if (grad_planes < 1 || grad_planes > 10 || max_motion < 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    const TemporalTile t = tile ? *tile : TemporalTile{};
    const int M = max_motion, np = grad_planes;
#define RDT_GATHER_BWD(T, MG, NP)                                          \
    return launch_gather_bwd<T, MG, NP>(hist, motion, g, dh, dm, H, W, M,  \
                                         np, t, ws, ws_ints, s)
#define RDT_GATHER_BWD_NP(T, MG)                                           \
    if (np <= 6) { RDT_GATHER_BWD(T, MG, 6); }                             \
    RDT_GATHER_BWD(T, MG, 10)
    if (tile) {
        if (motion_grad) { RDT_GATHER_BWD_NP(true, true); }
        RDT_GATHER_BWD_NP(true, false);
    }
    if (motion_grad) { RDT_GATHER_BWD_NP(false, true); }
    RDT_GATHER_BWD_NP(false, false);
#undef RDT_GATHER_BWD_NP
#undef RDT_GATHER_BWD
}

// K16: d_render (3 planes) from the step's inputs, its outputs moments and
// n_new, and the cotangents of integrated, variance and moments (each may
// be null: zero).
extern "C" int rdt_temporal_bwd(const float* render, const float* motion,
                                const float* depth, const float* normal,
                                const float* h_color, const float* h_length,
                                const float* h_depth, const float* h_normal,
                                const float* moments, const float* n_new,
                                const float* g_integ, const float* g_var,
                                const float* g_mom, float* d_render,
                                const TemporalParams* params, void* stream) {
    const dim3 block(K16_TX, K16_TY);
    const dim3 grid((params->W + K16_TX - 1) / K16_TX,
                    (params->H + K16_TY - 1) / K16_TY);
    temporal_bwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        render, motion, depth, normal, h_color, h_length, h_depth, h_normal,
        moments, n_new, g_integ, g_var, g_mom, d_render, *params);
    return (int)cudaGetLastError();
}
