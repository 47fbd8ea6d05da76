// K10 (iterated box average), K11 (separable gaussian) and K12
// (cross-bilateral filter): the AVERAGE, GAUSSIAN and CROSS filter types of
// ops/filters.py's apply_filter.
//
// K10 replaces raymarchdenoisercuda_tpu/ops/pallas/box_tpu.py
// box_filter_pallas; its plain twin is box_filter in ops/boxfilter.py.  K11
// replaces filters_tpu.py _make_gaussian_kernel (gaussian_filter_pallas) and
// K12 _make_cross_kernel (cross_bilateral_pallas); their plain twins are
// gaussian_filter and cross_bilateral_filter in ops/filters.py.
//
// The TPU kernels stage halo-extended row bands in VMEM (K10 runs all
// levels on one band with a halo of r·depth, K11 both passes of an
// iteration); the bands' 128-lane padding and VMEM-sized heights are the
// TPU's layout and are not carried over.  K10 and K11 share one design
// here: a block owns a 128 x 32 output tile of one plane and stages it
// with its halo in shared memory by cp.async (zeros beyond the frame: the
// cooperative halo load of the reference's filterKernelTiled,
// src/filter.cu:60-158, whose unused cacheBuffer flag would keep the
// levels there), and a thread computes four outputs along a row from
// float4 windows of the staged rows, so a row's values, loaded once,
// serve all of its taps.  Where a tile's outputs and their taps all lie
// in the frame, the tap count or weight sum is the full one, computed
// once.  The radius is a template parameter, r 0-4 (kBodyRadius).  From
// r 5 (BOX_PASS_RADIUS, GAUSS_PASS_RADIUS in utils/tiling.py), K10 and
// K11 run as their twins do: two 1-D passes a level (pass_y_kernel into a
// global intermediate, pass_x_kernel from it), O(r) work an output where
// the 2-D body takes O(r^2), each thread sliding register windows over its
// column or its staged row; K12 reads its gaussian taps from a device
// array past r 16 (the à-trous WIDE instantiation's way), not from the
// launch's parameter struct.
//
// * K10: all the levels of a launch in shared memory (ping-pong between
//   two staged buffers), the halo r·levels; only the last level's tile is
//   written.  The wrapper gives a launch as many levels as keep r·levels
//   within BOX_HALO_CAP = 8 (ops/filters_cuda.py, box_level_groups, with
//   the measurement behind it; one level a launch where r alone exceeds
//   it).  Each output adds its taps dy-major, dx-minor (the TPU kernel's
//   order and the per-level kernel's before it; a staged zero adds +0.0)
//   and divides by the in-range tap count: the per-level launches'
//   floats bit for bit at any depth.
// * K11: one launch an iteration: the pass along y over the tile and its
//   x-halo into shared memory, then the pass along x from there.  Each
//   divides by the ordered sum of its in-range 1-D tap weights (the taps
//   are launch arguments), and the intermediate is rounded to float as
//   the two-launch kernel's global buffer was.  The plain twin adds the
//   same products in the same order, so the two agree to the bit (the
//   library is built with --fmad=false).
// * K12: all (2r+1)^2 taps directly; the albedo and depth terms share one
//   exp2f of log2(e)-scaled arguments, and the normal term is repeated
//   squaring for a power-of-two sigma_n up to 1024, else powf.  For r <= 4
//   a block stages the ten colour and guidance planes of its output tile and
//   an r-pixel halo in shared memory by cp.async (the cooperative halo
//   load of the reference's tiled box filter, src/filter.cu:60-158), and
//   every tap reads the staged tile at offsets fixed at compile time (the
//   radius is a template parameter); a thread computes two pixels, one
//   above the other, and its taps of one staged row first take their
//   normal terms together, so the squaring loop runs once a row.
//   For r > 4 the rolling-row tile (cross_bilateral_rolling_kernel)
//   replaces the first-generation body, one thread a pixel with each tap's
//   ten values read through L1 (11.82 ms at r17, 23.02 at r24 on the H100,
//   8.4x its operation bound).  Its bound is operations (~37 flops a tap:
//   1.40 ms at r17, 2.75 at r24); the design keeps a tap's instructions
//   (~50 with --fmad=false) the work: a block of 32 x 8 threads, two
//   pixels a thread one above the other (a 32 x 16 output tile), walks its
//   2r + 16 source rows once, keeping a ring of 16 rows of the ten planes
//   (the 15 a step reads and the next, cp.async'd one step ahead) of 32 +
//   2r columns in shared memory, 41.4 KB at r17, 50.2 KB at r24, 133.2 KB
//   at r90 with the 2r + 1 spatial taps; at step t thread row ty takes the
//   taps of row t + 2ty for both of its pixels, which are rows dy = t - r
//   and t - r - 1 of them, so a staged value serves two pixel-taps and
//   every pixel's rows still come in ascending order.  A thread takes a
//   row's taps in chunks of 8 columns (normal terms, their squaring over
//   the chunk, then the sums; with powf one tap at a time, which wastes
//   none on a chunk past the row's end), the columns clipped to the
//   frame.  Past
//   r 164 the ring would exceed 227 KB: each step then stages only the 8
//   rows it reads, in segments of 256 taps' columns, ascending (chunked).
//   Every form adds the same floats in the same order (dy-major,
//   dx-minor, taps beyond the frame skipped), so they agree to the bit.
//
// Bound on the card: bytes (K10, K11: 24 B a pixel of three planes, for a
// launch of any depth or an iteration; K12: 52 B a pixel), with K12 close
// to its operation bound (~37 flops a tap).  K10 at r2 and K11 reach
// about half the HBM rate: their adds, divisions and shared-memory loads
// (~35 instructions an output) do not overlap the staging fully; the
// staged K12 is held by its instructions (~50 a tap
// with --fmad=false) and its shared-memory reads (40 B a staged tap, 24 B
// a pixel's tap at r2 with two pixels a thread).  The 1-D passes are held
// by their adds at large r (4r an output for K10, a product and a sum a
// tap for K11, at the card's 33.5e12 a second: K10 r90 0.067 ms) and by
// device memory at small r (each pass reads and writes 24 B a pixel).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kMaxTaps = 33;  // the taps K12's parameter struct holds: r <= 16
constexpr int kBodyRadius = 4;  // K10's and K11's 2-D bodies: r 0-4

// Launch parameters, passed by pointer from ops/filters_cuda.py (ctypes).
struct GaussParams {
    int C, H, W, radius;
    float taps[2 * kBodyRadius + 1];  // _gauss_taps(radius, sigma)
};

struct CrossParams {
    int H, W, radius;
    int pow2_steps;   // >= 0: sigma_n = 2^pow2_steps; -1: powf
    float inv_2sa2;   // log2(e) / (2 sigma_albedo^2 + eps)
    float inv_sz;     // log2(e) / (sigma_depth + eps)
    float sigma_normal, eps;
    float gt[kMaxTaps];  // _gauss_taps(radius, sigma_space), r <= 16
};

namespace {

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src));
}

// K12 past r 4: the rolling-row tile (see the header).  A block of KR_TX x
// KR_TY threads, each computing KR_PX pixels one above the other, over a
// KR_TX x KR_OH output tile.  At step t, thread row ty takes the taps of
// frame row y0 - r + t + ty KR_PX, which is row dy = t - r - k of its pixel
// k: every pixel's rows come in ascending order, and a staged row's
// values, loaded once, serve the thread's KR_PX pixels (kr_row_taps takes
// a row's taps, ascending).
constexpr int KR_TX = 32, KR_TY = 8, KR_PX = 2;
constexpr int KR_OH = KR_TY * KR_PX;
// Rows in the ring: the KR_OH - KR_PX + 1 rows a step reads, and the next
// one in flight.
constexpr int KR_RING = KR_OH - KR_PX + 2;
constexpr int KR_CH = 8;
// Past the ring's shared memory (r > 164), each step stages the KR_TY rows
// it reads, a segment of KR_SEG taps' columns at a time (chunked).
constexpr int KR_SEG = 256;
constexpr size_t kSmemOptin = 232448;   // the shared memory a block can have

// Floats of one plane of a staged row: the whole row's KR_TX + 2r columns
// (ring), or a segment's KR_SEG + KR_TX - 1 (chunked).
__host__ __device__ inline int kr_cols(bool roll, int r) {
    return roll ? KR_TX + 2 * r : KR_SEG + KR_TX - 1;
}

// A launch's shared memory: its staged rows of 10 planes, and (ring) the
// 2r + 1 spatial taps.
__host__ __device__ inline size_t kr_smem(bool roll, int r) {
    const size_t rows = roll ? KR_RING : KR_TY;
    return sizeof(float)
        * (rows * 10 * kr_cols(roll, r) + (roll ? 2 * r + 1 : 0));
}

// One staged row: frame row y, columns x_begin .. x_begin + n - 1 of the
// ten planes into dst (plane stride cols); what lies beyond the frame is
// not staged (never read: its taps are skipped).
__device__ __forceinline__ void kr_stage(float* dst, int cols,
                                         const float* const (&planes)[10],
                                         int H, int W, int y, int x_begin,
                                         int n) {
    if (y < 0 || y >= H) return;
    const int tid = threadIdx.y * KR_TX + threadIdx.x;
    const int c_lo = max(0, -x_begin), c_hi = min(n, W - x_begin);
    for (int c = c_lo + tid; c < c_hi; c += KR_TX * KR_TY) {
        const int q = y * W + x_begin + c;
#pragma unroll
        for (int j = 0; j < 10; ++j) cp_async4(dst + j * cols + c, planes[j] + q);
    }
}

// A thread's state: its pixels' centres (albedo, normal, depth) and sums.
struct CrossPixels {
    float ctr[KR_PX][7];
    float num0[KR_PX], num1[KR_PX], num2[KR_PX], den[KR_PX];
};

// One tap (its staged values at v, plane stride cols; spatial weight gx)
// for the thread's pixels: pixel k takes it where live[k], its normal term
// nd[k] given.  The parent's floats, in its order.
__device__ __forceinline__ void kr_tap(const float* v, int cols, float gx,
                                       const float (&nd)[KR_PX],
                                       const float (&gy)[KR_PX],
                                       const bool (&live)[KR_PX],
                                       CrossPixels& px,
                                       const CrossParams& p) {
    const float c0 = v[0], c1 = v[cols], c2 = v[2 * cols];
    const float b0 = v[3 * cols], b1 = v[4 * cols];
    const float b2 = v[5 * cols], zq = v[9 * cols];
#pragma unroll
    for (int k = 0; k < KR_PX; ++k) {
        if (!live[k]) continue;
        const float e0 = px.ctr[k][0] - b0;
        const float e1 = px.ctr[k][1] - b1;
        const float e2 = px.ctr[k][2] - b2;
        const float da2 = e0 * e0 + e1 * e1 + e2 * e2;
        const float arg = -(da2 * p.inv_2sa2
                            + fabsf(px.ctr[k][6] - zq) * p.inv_sz);
        const float w = gy[k] * gx * exp2f(arg) * nd[k];
        px.num0[k] = px.num0[k] + w * c0;
        px.num1[k] = px.num1[k] + w * c1;
        px.num2[k] = px.num2[k] + w * c2;
        px.den[k] = px.den[k] + w;
    }
}

// The normal term's base, max(n . n_q, 0), of the tap at v for pixel k.
__device__ __forceinline__ float kr_ndot(const float* v, int cols,
                                         const CrossPixels& px, int k) {
    return fmaxf(px.ctr[k][3] * v[6 * cols] + px.ctr[k][4] * v[7 * cols]
                 + px.ctr[k][5] * v[8 * cols], 0.0f);
}

// The taps d = lo .. hi (dx = d - r) of one staged row for the thread's
// pixels: row + d is tap d's colour in plane 0 (plane stride cols); pixel
// k takes them where live[k], with its row's spatial weight gy[k].  A
// power-of-two sigma_n takes the taps in chunks of KR_CH (the normal
// terms, their squaring over the chunk, then the sums); powf one tap at a
// time (a chunk past the row's end would waste it).
__device__ __forceinline__ void kr_row_taps(const float* row, int cols,
                                            int lo, int hi, const float* gt,
                                            const float (&gy)[KR_PX],
                                            const bool (&live)[KR_PX],
                                            CrossPixels& px,
                                            const CrossParams& p) {
    if (p.pow2_steps < 0) {
        for (int d = lo; d <= hi; ++d) {
            float nd[KR_PX];
#pragma unroll
            for (int k = 0; k < KR_PX; ++k) {
                nd[k] = live[k] ? powf(fmaxf(kr_ndot(row + d, cols, px, k),
                                             1e-20f), p.sigma_normal)
                                : 0.0f;
            }
            kr_tap(row + d, cols, gt[d], nd, gy, live, px, p);
        }
        return;
    }
    for (int d0 = lo; d0 <= hi; d0 += KR_CH) {
        float nd[KR_PX][KR_CH];
#pragma unroll
        for (int j = 0; j < KR_CH; ++j) {
            const bool in = d0 + j <= hi;
#pragma unroll
            for (int k = 0; k < KR_PX; ++k) {
                nd[k][j] = in ? kr_ndot(row + d0 + j, cols, px, k) : 0.0f;
            }
        }
        for (int st = 0; st < p.pow2_steps; ++st) {
#pragma unroll
            for (int k = 0; k < KR_PX; ++k) {
#pragma unroll
                for (int j = 0; j < KR_CH; ++j) nd[k][j] = nd[k][j] * nd[k][j];
            }
        }
#pragma unroll
        for (int j = 0; j < KR_CH; ++j) {
            if (d0 + j > hi) break;
            float n2[KR_PX];
#pragma unroll
            for (int k = 0; k < KR_PX; ++k) n2[k] = nd[k][j];
            kr_tap(row + d0 + j, cols, gt[d0 + j], n2, gy, live, px, p);
        }
    }
}

// Step t of a thread's rows: its frame row ys = y0 - r + t + ty KR_PX,
// which is row dy = t - r - k of pixel k; the taps d_lo .. d_hi of the
// staged row at row (column tx at row[0]).
__device__ __forceinline__ void kr_step(int t, int r, int ys, int H,
                                        const float* row, int cols,
                                        int d_lo, int d_hi, const float* gt,
                                        const bool (&on)[KR_PX],
                                        CrossPixels& px,
                                        const CrossParams& p) {
    if (ys < 0 || ys >= H || d_lo > d_hi) return;
    float gy[KR_PX];
    bool live[KR_PX];
    bool any = false;
#pragma unroll
    for (int k = 0; k < KR_PX; ++k) {
        const int dy = t - r - k;
        live[k] = on[k] && dy >= -r && dy <= r;
        gy[k] = live[k] ? gt[dy + r] : 0.0f;
        any = any || live[k];
    }
    if (any) kr_row_taps(row, cols, d_lo, d_hi, gt, gy, live, px, p);
}

// K12 for r > kMaxStagedRadius: ROLL, the ring of rows (each row staged
// once, one step ahead, by cp.async); else chunked (each step stages the
// rows it reads a segment at a time).  The spatial taps from p.gt (r <=
// 16) or the device array wide_gt, staged as a table (ring) or read
// through the caches (chunked, r > 164).
template <bool ROLL>
__global__ void __launch_bounds__(KR_TX * KR_TY)
cross_bilateral_rolling_kernel(const float* __restrict__ color,
                               const float* __restrict__ albedo,
                               const float* __restrict__ normal,
                               const float* __restrict__ depth,
                               float* __restrict__ out, CrossParams p,
                               const float* __restrict__ wide_gt) {
    extern __shared__ float kr_buf[];
    const int r = p.radius, H = p.H, W = p.W, hw = H * W;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int x0 = blockIdx.x * KR_TX, y0 = blockIdx.y * KR_OH;
    const int cols = kr_cols(ROLL, r), row_floats = 10 * cols;
    const float* const planes[10] = {
        color, color + hw, color + 2 * hw, albedo, albedo + hw,
        albedo + 2 * hw, normal, normal + hw, normal + 2 * hw, depth};
    const float* gt = wide_gt;
    if (ROLL) {
        float* taps = kr_buf + KR_RING * row_floats;
        for (int i = ty * KR_TX + tx; i <= 2 * r; i += KR_TX * KR_TY) {
            taps[i] = wide_gt ? wide_gt[i] : p.gt[i];
        }
        gt = taps;
    }
    // pixel k at (y0 + ty KR_PX + k, x); its taps' columns clipped to the
    // frame (the parent skips the others)
    const int x = x0 + tx;
    const int lo = max(0, r - x), hi = min(2 * r, r + W - 1 - x);
    CrossPixels px;
    bool on[KR_PX];
#pragma unroll
    for (int k = 0; k < KR_PX; ++k) {
        const int y = y0 + ty * KR_PX + k;
        on[k] = x < W && y < H;
        const int i = on[k] ? y * W + x : 0;
#pragma unroll
        for (int j = 0; j < 7; ++j) px.ctr[k][j] = planes[3 + j][i];
        px.num0[k] = px.num1[k] = px.num2[k] = px.den[k] = 0.0f;
    }
    const int steps = 2 * r + KR_PX;
    if (ROLL) {
        // row j (frame row y0 - r + j) in slot j % KR_RING
        const int n_rows = 2 * r + KR_OH;
        for (int j = 0; j <= KR_RING - 2 && j < n_rows; ++j) {
            kr_stage(kr_buf + (j % KR_RING) * row_floats, cols, planes, H, W,
                     y0 - r + j, x0 - r, KR_TX + 2 * r);
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
        for (int t = 0; t < steps; ++t) {
            // the row step t + 1 adds, into the slot of the row step t - 1
            // read last
            const int jn = t + KR_RING - 1;
            if (jn < n_rows) {
                kr_stage(kr_buf + (jn % KR_RING) * row_floats, cols, planes,
                         H, W, y0 - r + jn, x0 - r, KR_TX + 2 * r);
            }
            const int j = t + ty * KR_PX;
            kr_step(t, r, y0 - r + j, H, kr_buf + (j % KR_RING) * row_floats
                    + tx, cols, lo, hi, gt, on, px, p);
            asm volatile("cp.async.wait_all;\n" ::: "memory");
            __syncthreads();
        }
    } else {
        for (int t = 0; t < steps; ++t) {
            for (int c0 = 0; c0 <= 2 * r; c0 += KR_SEG) {
                __syncthreads();   // the previous segment's readers are done
                for (int rr = 0; rr < KR_TY; ++rr) {
                    kr_stage(kr_buf + rr * row_floats, cols, planes, H, W,
                             y0 - r + t + rr * KR_PX, x0 - r + c0,
                             min(cols, KR_TX + 2 * r - c0));
                }
                asm volatile("cp.async.wait_all;\n" ::: "memory");
                __syncthreads();
                kr_step(t, r, y0 - r + t + ty * KR_PX, H,
                        kr_buf + ty * row_floats + tx - c0, cols,
                        max(lo, c0), min(hi, c0 + KR_SEG - 1), gt, on, px,
                        p);
            }
        }
    }
#pragma unroll
    for (int k = 0; k < KR_PX; ++k) {
        if (!on[k]) continue;
        const int i = (y0 + ty * KR_PX + k) * W + x;
        const float d = fmaxf(px.den[k], p.eps);
        out[i] = px.num0[k] / d;
        out[hw + i] = px.num1[k] / d;
        out[2 * hw + i] = px.num2[k] / d;
    }
}

// K12's staged form (r <= kMaxStagedRadius): a block of K12_TX x K12_TY
// threads, each computing PX pixels one above the other, over a K12_TX x
// (K12_TY PX) output tile; a staged row's ten values, loaded once, serve
// every pixel of the thread whose taps reach it.  Two pixels a thread: one
// took 1.11x and four (32 x 4 threads) 1.12x the time at r2, sigma_n 128,
// 1920x1080 on the H100.
constexpr int K12_TX = 32, K12_TY = 8, kMaxStagedRadius = 4;
constexpr int kCrossPx = 2;

template <int R, int PX>
struct CrossTile {
    static constexpr int OH = K12_TY * PX;
    static constexpr int SW = K12_TX + 2 * R, SH = OH + 2 * R;
    // colour, albedo, normal (3 planes each), depth; zeros beyond the frame
    float v[10][SH][SW];
};

template <int R, int PX>
__global__ void __launch_bounds__(K12_TX * K12_TY)
cross_bilateral_staged_kernel(const float* __restrict__ color,
                              const float* __restrict__ albedo,
                              const float* __restrict__ normal,
                              const float* __restrict__ depth,
                              float* __restrict__ out, CrossParams p) {
    using Tl = CrossTile<R, PX>;
    constexpr int T = 2 * R + 1;
    __shared__ Tl sm;
    const int bx0 = blockIdx.x * K12_TX, by0 = blockIdx.y * Tl::OH;
    const int hw = p.H * p.W;
    const float* planes[10] = {color, color + hw, color + 2 * hw,
                               albedo, albedo + hw, albedo + 2 * hw,
                               normal, normal + hw, normal + 2 * hw, depth};
    for (int e = threadIdx.y * K12_TX + threadIdx.x; e < Tl::SH * Tl::SW;
         e += K12_TX * K12_TY) {
        const int sy = e / Tl::SW, sx = e - sy * Tl::SW;
        const int y = by0 + sy - R, x = bx0 + sx - R;
        if (y >= 0 && y < p.H && x >= 0 && x < p.W) {
            const int q = y * p.W + x;
#pragma unroll
            for (int j = 0; j < 10; ++j) {
                cp_async4(&sm.v[j][sy][sx], planes[j] + q);
            }
        } else {
#pragma unroll
            for (int j = 0; j < 10; ++j) sm.v[j][sy][sx] = 0.0f;
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    const int tx = threadIdx.x, ty0 = threadIdx.y * PX, x = bx0 + tx;
    if (x >= p.W || by0 + ty0 >= p.H) return;
    // pixel k's centre (tile row ty0 + k): albedo, normal, depth
    float ctr[PX][7], num0[PX], num1[PX], num2[PX], den[PX];
#pragma unroll
    for (int k = 0; k < PX; ++k) {
#pragma unroll
        for (int j = 0; j < 7; ++j) {
            ctr[k][j] = sm.v[3 + j][ty0 + k + R][tx + R];
        }
        num0[k] = num1[k] = num2[k] = den[k] = 0.0f;
    }
    // staged row s (frame row by0 + ty0 + s - R) is pixel k's row dy = s -
    // R - k: the rows come in order for every pixel, and within a row the
    // columns dx = -R..R
#pragma unroll
    for (int s = 0; s < 2 * R + PX; ++s) {
        const int yy = by0 + ty0 + s - R;
        if (yy < 0 || yy >= p.H) continue;
        const int sy = ty0 + s;
        float nd[PX][T];
#pragma unroll
        for (int dx = 0; dx < T; ++dx) {
            const float q0 = sm.v[6][sy][tx + dx], q1 = sm.v[7][sy][tx + dx];
            const float q2 = sm.v[8][sy][tx + dx];
#pragma unroll
            for (int k = 0; k < PX; ++k) {
                if (s - k < 0 || s - k > 2 * R) continue;
                nd[k][dx] = fmaxf(ctr[k][3] * q0 + ctr[k][4] * q1
                                  + ctr[k][5] * q2, 0.0f);
            }
        }
        // pow_sigma_n of each of the row's taps
        if (p.pow2_steps < 0) {
#pragma unroll
            for (int k = 0; k < PX; ++k) {
                if (s - k < 0 || s - k > 2 * R) continue;
#pragma unroll
                for (int dx = 0; dx < T; ++dx) {
                    nd[k][dx] = powf(fmaxf(nd[k][dx], 1e-20f), p.sigma_normal);
                }
            }
        } else {
            for (int st = 0; st < p.pow2_steps; ++st) {
#pragma unroll
                for (int k = 0; k < PX; ++k) {
                    if (s - k < 0 || s - k > 2 * R) continue;
#pragma unroll
                    for (int dx = 0; dx < T; ++dx) {
                        nd[k][dx] = nd[k][dx] * nd[k][dx];
                    }
                }
            }
        }
#pragma unroll
        for (int dx = 0; dx < T; ++dx) {
            const int xx = x + dx - R;
            if (xx < 0 || xx >= p.W) continue;
            const float c0 = sm.v[0][sy][tx + dx], c1 = sm.v[1][sy][tx + dx];
            const float c2 = sm.v[2][sy][tx + dx];
            const float b0 = sm.v[3][sy][tx + dx], b1 = sm.v[4][sy][tx + dx];
            const float b2 = sm.v[5][sy][tx + dx], zq = sm.v[9][sy][tx + dx];
#pragma unroll
            for (int k = 0; k < PX; ++k) {
                const int dy = s - R - k;
                if (dy < -R || dy > R) continue;
                const float d0 = ctr[k][0] - b0;
                const float d1 = ctr[k][1] - b1;
                const float d2 = ctr[k][2] - b2;
                const float da2 = d0 * d0 + d1 * d1 + d2 * d2;
                const float arg = -(da2 * p.inv_2sa2
                                    + fabsf(ctr[k][6] - zq) * p.inv_sz);
                const float w = p.gt[dy + R] * p.gt[dx] * exp2f(arg)
                    * nd[k][dx];
                num0[k] = num0[k] + w * c0;
                num1[k] = num1[k] + w * c1;
                num2[k] = num2[k] + w * c2;
                den[k] = den[k] + w;
            }
        }
    }
#pragma unroll
    for (int k = 0; k < PX; ++k) {
        const int y = by0 + ty0 + k;
        if (y >= p.H) break;
        const int i = y * p.W + x;
        const float d = fmaxf(den[k], p.eps);
        out[i] = num0[k] / d;
        out[hw + i] = num1[k] / d;
        out[2 * hw + i] = num2[k] / d;
    }
}

// K10 and K11: a block owns a KF_TW x KF_TH output tile of one plane; a
// thread computes KF_PX outputs along a row (K11's pass along y: four
// columns of one row).  K10 runs 512 threads a block, K11 256 (measured
// against 64 x 32, 64 x 64, 128 x 16, 128 x 64 and 256 x 16 tiles, eight
// outputs a thread, K11 one, two or four rows a thread and the other
// thread count: PERF.md, PR 15).
constexpr int KF_TW = 128, KF_TH = 32, KF_PX = 4;
constexpr int K10_THREADS = 512, K11_THREADS = 256;

// The row stride of a staged region `cols` wide: a multiple of four floats
// (16-byte rows), with room for the float4 window of a row's last group,
// which reads up to KF_PX + 1 columns past the region.
__host__ __device__ __forceinline__ int staged_stride(int cols) {
    return (cols + KF_PX + 2 + 3) & ~3;
}

// Stages frame rows [fy0, fy0 + rows) x columns [fx0, fx0 + cols) of one
// plane into s (row stride sw) by cp.async, a warp a row (NT threads a
// block), with zeros beyond the frame; returns with the block
// synchronised.
template <int NT>
__device__ void stage_plane(float* s, int sw, const float* __restrict__ plane,
                            int H, int W, int fy0, int fx0, int rows,
                            int cols) {
    const int lane = threadIdx.x & 31;
    for (int i = threadIdx.x >> 5; i < rows; i += NT / 32) {
        const int y = fy0 + i;
        float* row = s + i * sw;
        if (y < 0 || y >= H) {
            for (int j = lane; j < cols; j += 32) row[j] = 0.0f;
            continue;
        }
        const float* src = plane + (size_t)y * W;
        for (int j = lane; j < cols; j += 32) {
            const int x = fx0 + j;
            if (x >= 0 && x < W) {
                cp_async4(row + j, src + x);
            } else {
                row[j] = 0.0f;
            }
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
}

template <typename F>
__device__ __forceinline__ void window_quad(float4 q, int c, int span, F& f) {
    const float v[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int k = 0; k < KF_PX; ++k) {
            const int d = 4 * c + e - k;
            if (d >= 0 && d <= span) f(k, d, v[e]);
        }
    }
}

// Feeds one staged row's window to KF_PX outputs along it: output k takes
// the row's columns k + d, d = 0..2R in that order, through f(k, d,
// value).  `row` is 16-byte aligned; the window's KF_PX + 2R floats are
// loaded once, as float4.
template <int R, typename F>
__device__ __forceinline__ void row_window(const float* row, F&& f) {
    const float4* q = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int c = 0; c < (KF_PX + 2 * R + 3) / 4; ++c) {
        window_quad(q[c], c, 2 * R, f);
    }
}

// Stores a thread's KF_PX outputs at o, the first `room` of them (all when
// room >= KF_PX), as float4 where `vec` says o is 16-byte aligned.
__device__ __forceinline__ void store_outputs(float* o, const float* res,
                                              int room, bool vec) {
    if (vec && room >= KF_PX) {
#pragma unroll
        for (int q = 0; q < KF_PX; q += 4) {
            *reinterpret_cast<float4*>(o + q) =
                make_float4(res[q], res[q + 1], res[q + 2], res[q + 3]);
        }
    } else {
#pragma unroll
        for (int q = 0; q < KF_PX; ++q) {
            if (q < room) o[q] = res[q];
        }
    }
}

// K10: `levels` levels of the (2r+1)^2 box average (r = R) on one plane's
// tile.  The block stages the tile and a halo of h = r·levels (zeros beyond
// the frame) and runs the levels in shared memory, ping-pong: level l over the
// tile grown by r·(levels - l), its pixels beyond the frame stored as 0; the
// last level's tile goes to `out`.  Each output adds its taps dy-major,
// dx-minor (a staged zero adds +0.0 to a sum that starts at +0.0: the
// per-level kernel's sum of the in-range taps, bit for bit) and divides by the
// in-range tap count.
template <int R>
__global__ void __launch_bounds__(K10_THREADS)
box_filter_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int H, int W, int levels, bool vec_out) {
    extern __shared__ float4 kf_smem[];
    constexpr int r = R;
    const int h = r * levels;
    const int sw = staged_stride(KF_TW + 2 * h);
    float* src = reinterpret_cast<float*>(kf_smem);   // KF_TH + 2h rows
    float* dst = src + (KF_TH + 2 * h) * sw;          // KF_TH + 2(h - r)
    const int x0 = blockIdx.x * KF_TW, y0 = blockIdx.y * KF_TH;
    const size_t hw = (size_t)H * W;
    stage_plane<K10_THREADS>(src, sw, in + blockIdx.z * hw, H, W, y0 - h,
                             x0 - h, KF_TH + 2 * h, KF_TW + 2 * h);
    float* plane_out = out + blockIdx.z * hw;
    for (int l = 1; l <= levels; ++l) {
        const int g = r * (levels - l);
        const bool last = l == levels;
        // every output of the level and every tap of it in the frame
        const bool inner = y0 - g - r >= 0 && y0 + KF_TH + g + r <= H
            && x0 - g - r >= 0 && x0 + KF_TW + g + r <= W;
        const float full = (float)((2 * r + 1) * (2 * r + 1));
        // the outputs at region row i, columns c.. of the level
        auto item = [&](int i, int c) {
            float acc[KF_PX];
#pragma unroll
            for (int k = 0; k < KF_PX; ++k) acc[k] = 0.0f;
#pragma unroll
            for (int dy = 0; dy <= 2 * r; ++dy) {
                row_window<R>(src + (i + dy) * sw + c,
                              [&](int k, int, float v) { acc[k] = acc[k] + v; });
            }
            const int y = y0 - g + i, x = x0 - g + c;
            const bool y_in = y >= 0 && y < H;
            float res[KF_PX];
            if (inner) {
#pragma unroll
                for (int k = 0; k < KF_PX; ++k) res[k] = acc[k] / full;
            } else {
                const int ny = min(y + r, H - 1) - max(y - r, 0) + 1;
#pragma unroll
                for (int k = 0; k < KF_PX; ++k) {
                    const int xk = x + k;
                    const int nx = min(xk + r, W - 1) - max(xk - r, 0) + 1;
                    res[k] = y_in && xk >= 0 && xk < W
                        ? acc[k] / (float)(ny * nx) : 0.0f;
                }
            }
            if (!last) {
                store_outputs(dst + i * sw + c, res, KF_PX, true);
            } else if (y_in) {
                store_outputs(plane_out + (size_t)y * W + x, res, W - x,
                              vec_out);
            }
        };
        if (last) {
            constexpr int groups = KF_TW / KF_PX;
            for (int it = threadIdx.x; it < KF_TH * groups;
                 it += K10_THREADS) {
                item(it / groups, it % groups * KF_PX);
            }
        } else {
            const int groups = (KF_TW + 2 * g + KF_PX - 1) / KF_PX;
            for (int it = threadIdx.x; it < (KF_TH + 2 * g) * groups;
                 it += K10_THREADS) {
                const int i = it / groups;
                item(i, (it - i * groups) * KF_PX);
            }
            __syncthreads();
            float* t = src;
            src = dst;
            dst = t;
        }
    }
}

// K11: one iteration of the border-renormalised separable gaussian (r = R) on
// one plane's tile.  The block stages the tile and an r-pixel halo (zeros
// beyond the frame), computes the pass along y over the tile's width and its
// x-halo into shared memory (a column beyond the frame holds 0), then the pass
// along x from there, and writes the result once.  Each pass adds tap·value
// for k = 0..2r in order and divides by the ordered sum of its in-range taps,
// as the row and column launches did (a staged zero adds +0.0; the
// intermediate is rounded to float as their global buffer was): bit for bit
// the same floats.
template <int R>
__global__ void __launch_bounds__(K11_THREADS)
gaussian_filter_kernel(const float* __restrict__ in, float* __restrict__ out,
                       GaussParams p, bool vec_out) {
    extern __shared__ float4 kf_smem[];
    constexpr int r = R;
    const int H = p.H, W = p.W;
    const int sw = staged_stride(KF_TW + 2 * r);
    float* s = reinterpret_cast<float*>(kf_smem);   // KF_TH + 2r rows
    float* v = s + (KF_TH + 2 * r) * sw;            // KF_TH rows
    float* taps = v + KF_TH * sw;                   // 2r + 1
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k <= 2 * R; ++k) taps[k] = p.taps[k];
    }
    const int x0 = blockIdx.x * KF_TW, y0 = blockIdx.y * KF_TH;
    const size_t hw = (size_t)H * W;
    stage_plane<K11_THREADS>(s, sw, in + blockIdx.z * hw, H, W, y0 - r,
                             x0 - r, KF_TH + 2 * r, KF_TW + 2 * r);
    // the taps in registers, through shared memory (read from the
    // parameters directly, K11 r2-r4 ran 1.7-2.4% slower on the H100)
    float t[2 * R + 1];
#pragma unroll
    for (int k = 0; k <= 2 * R; ++k) t[k] = taps[k];
    // the denominator where every tap lies in the frame
    float den_all = 0.0f;
#pragma unroll
    for (int k = 0; k <= 2 * r; ++k) den_all = den_all + t[k];

    // pass along y: a column quad of one row a thread
    const int quads = (KF_TW + 2 * r + 3) / 4;
    for (int it = threadIdx.x; it < KF_TH * quads; it += K11_THREADS) {
        const int i = it / quads, c = (it - i * quads) * 4;
        float num[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k <= 2 * r; ++k) {
            const float4 q = *reinterpret_cast<const float4*>(
                s + (i + k) * sw + c);
            const float tk = t[k];
            num[0] = num[0] + tk * q.x;
            num[1] = num[1] + tk * q.y;
            num[2] = num[2] + tk * q.z;
            num[3] = num[3] + tk * q.w;
        }
        const int y = y0 + i;
        float den = den_all;
        if (y - r < 0 || y + r >= H) {
            den = 0.0f;
#pragma unroll
            for (int k = 0; k <= 2 * r; ++k) {
                const int yy = y + k - r;
                den = den + (yy >= 0 && yy < H ? t[k] : 0.0f);
            }
        }
        float res[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int x = x0 - r + c + e;
            res[e] = x >= 0 && x < W ? num[e] / den : 0.0f;
        }
        *reinterpret_cast<float4*>(v + i * sw + c) =
            make_float4(res[0], res[1], res[2], res[3]);
    }
    __syncthreads();

    // pass along x: KF_PX outputs along a row a thread
    float* plane_out = out + blockIdx.z * hw;
    constexpr int groups = KF_TW / KF_PX;
    for (int it = threadIdx.x; it < KF_TH * groups; it += K11_THREADS) {
        const int i = it / groups, c = (it - i * groups) * KF_PX;
        const int y = y0 + i, x = x0 + c;
        if (y >= H) continue;
        float num[KF_PX];
#pragma unroll
        for (int k = 0; k < KF_PX; ++k) num[k] = 0.0f;
        row_window<R>(v + i * sw + c, [&](int k, int d, float val) {
            num[k] = num[k] + t[d] * val;
        });
        const bool inner = x - r >= 0 && x + KF_PX + r <= W;
        float res[KF_PX];
#pragma unroll
        for (int k = 0; k < KF_PX; ++k) {
            float den = den_all;
            if (!inner) {
                den = 0.0f;
#pragma unroll
                for (int d = 0; d <= 2 * r; ++d) {
                    const int xx = x + k + d - r;
                    den = den + (xx >= 0 && xx < W ? t[d] : 0.0f);
                }
            }
            res[k] = num[k] / den;
        }
        store_outputs(plane_out + (size_t)y * W + x, res, W - x, vec_out);
    }
}

// K10 and K11 as two 1-D passes a level (pass_y_kernel into an
// intermediate, pass_x_kernel from it), the twins' passes (box_filter in
// ops/boxfilter.py, gaussian_filter in ops/filters.py) term for term.  A
// thread owns P consecutive outputs of one column (along y) or one row
// (along x) and keeps the values its taps read in registers, in windows
// that slide one value a step: output j at tap k reads the value that
// output j + 1 reads at tap k - 1, so a step loads one new value (the
// gaussian) or two (the box: one window moves forward, one back) for P
// outputs' adds.  The tap loops are unrolled by P, so the windows rotate
// by renaming registers.  One load then serves P adds where a thread a
// tap would issue one load an add (the load units take a quarter of the
// FP32 rate), and the P chains of adds overlap.
//
// Bit for bit the twins' floats (built with --fmad=false; __fmul_rn and
// __fadd_rn besides):
// * GAUSS: output o adds tap(k)·v[o + k - r] for k ascending from +0.0
//   and divides by the ordered sum of its in-range taps, which depends on
//   o's row (along y) or column (along x) alone: the wrapper sums them
//   once, as the twin does, into the tables den_y and den_x that follow
//   the taps in `taps` (a loop of O(r) an output at the borders held the
//   border warps ~10x as long as the rest).  A value
//   beyond the frame reads as 0 (staged, or a predicated load): its
//   product +0.0 leaves the sum where the twin adds t·0·0 = +0.0 and the
//   parent kernel skipped the tap (a sum that starts at +0.0 is never
//   -0.0).  Taps whose values all lie beyond the frame for every output
//   of the warp are not stepped through: they add +0.0 too.
// * Box: acc = v[o], then acc = (acc + v[o + d]) + v[o - d] for d = 1..r,
//   0.0 beyond the frame (the twin's _sep_sum order; its shift pads with
//   +0.0).  Steps past d_end = max(n - o0, o0 + P) (the frame's extent n,
//   the warp's first output o0) add +0.0 + +0.0 to every output, and the
//   step at d_end already did, so no sum is -0.0 after it: they change
//   nothing and are not run.  The pass along x divides by ny·nx, the
//   in-range tap count.
//
// Along y (KY_P outputs down a column a thread): a warp covers 32
// adjacent columns, so each step's load is one 128-byte row segment,
// through the read-only cache; a warp whose rows and taps all lie in the
// frame loads with no predicate.  (Staging the block's column strip in
// shared memory by cp.async instead ran 1.00-1.09x the read-only path's
// time at r17-r90 on the H100.)  Along x (KX_P outputs along a row a
// thread, a warp a row): the warp stages its row's segment [x0 - r, x0 +
// KX_TW + r) in shared memory by cp.async, zeros beyond the frame, and
// its lanes read it at a stride of KX_P: KX_P is odd, so the 32 lanes hit
// 32 banks.  The outputs go back through the segment and out in
// coalesced rows.  A segment past KX_SMEM a block (2781 gaussian taps,
// r 1390; 1242 box steps, r 1242, each side's values staged apart) is
// staged in chunks of steps, ascending; the windows carry over.  A level
// in one launch, the pass along y of a 32-row tile and its x-halo into
// shared memory and the pass along x from there, took 0.94-0.98x the two
// launches' time at r 5-8 and 1.01-1.68x at r 12-90 (K10; K11 1.08-1.47x
// at r 17-90): the halo's columns are summed along y by both blocks
// beside them.  Not kept.
constexpr int KY_P = 8, KY_WARPS = 8;
constexpr int KX_P = 9, KX_WARPS = 4;
constexpr int KX_TW = 32 * KX_P;
constexpr int KX_SMEM = 48 * 1024;

// The steps of the pass along x a chunk stages (a multiple of KX_P): all
// the steps a warp can take when they fit KX_SMEM, else as many as fit.
// The gaussian stages one segment of chunk + KX_TW values a warp, the box
// two (the values ahead and behind).
__host__ inline int kx_chunk(bool gauss, int r, int W) {
    const long long most = (long long)W + KX_TW - 1;
    const long long want = gauss ? 2LL * r + 1 : r;
    const int steps = (int)(want < most ? want : most);
    const int fits = (KX_SMEM / (4 * KX_WARPS * (gauss ? 1 : 2)) - KX_TW)
        / KX_P * KX_P;
    const int all = (steps + KX_P - 1) / KX_P * KX_P;
    return all < KX_P ? KX_P : all < fits ? all : fits;
}

__host__ inline size_t kx_smem_bytes(bool gauss, int chunk) {
    return sizeof(float) * KX_WARPS * (gauss ? 1 : 2) * (chunk + KX_TW);
}

// Runs steps [0, n) of a pass, P at a time: step(a, s) with a = s mod P
// known at compile time (the windows' registers), the last group checked.
template <int P, typename F>
__device__ __forceinline__ void run_steps(int n, F&& step) {
    int s0 = 0;
    for (; s0 + P <= n; s0 += P) {
#pragma unroll
        for (int a = 0; a < P; ++a) step(a, s0 + a);
    }
#pragma unroll
    for (int a = 0; a < P; ++a) {
        if (s0 + a < n) step(a, s0 + a);
    }
}

// The gaussian along y for the KY_P outputs from row yb of column `col`;
// EDGE: loads beyond the frame read 0.
template <bool EDGE>
__device__ __forceinline__ void gauss_y(const float* __restrict__ col, int H,
                                        int W, int yb, int r,
                                        const float* __restrict__ taps,
                                        float (&res)[KY_P]) {
    constexpr int P = KY_P;
    const int k_lo = max(0, r - (yb + P - 1));
    const int k_hi = min(2 * r, r + H - 1 - yb);
    // value q is row row0 + q; step s reads value s + j for output j
    const int row0 = yb - r + k_lo;
    auto load = [&](int q) {
        const int y = row0 + q;
        if (EDGE && (y < 0 || y >= H)) return 0.0f;
        return __ldg(col + (ptrdiff_t)y * W);
    };
    float num[P], w[P];
#pragma unroll
    for (int j = 0; j < P; ++j) num[j] = 0.0f;
#pragma unroll
    for (int q = 0; q < P - 1; ++q) w[q] = load(q);
    const float* t = taps + k_lo;
    run_steps<P>(k_hi - k_lo + 1, [&](int a, int s) {
        w[(a + P - 1) % P] = load(s + P - 1);
        const float tk = __ldg(t + s);
#pragma unroll
        for (int j = 0; j < P; ++j) {
            num[j] = __fadd_rn(num[j], __fmul_rn(tk, w[(a + j) % P]));
        }
    });
    const float* den = taps + 2 * r + 1;   // den_y
#pragma unroll
    for (int j = 0; j < P; ++j) {
        res[j] = num[j] / __ldg(den + min(yb + j, H - 1));
    }
}

// The box's pass along y (the sums, undivided), as gauss_y.
template <bool EDGE>
__device__ __forceinline__ void box_y(const float* __restrict__ col, int H,
                                      int W, int yb, int r,
                                      float (&res)[KY_P]) {
    constexpr int P = KY_P;
    auto load = [&](int y) {
        if (EDGE && (y < 0 || y >= H)) return 0.0f;
        return __ldg(col + (ptrdiff_t)y * W);
    };
    // F[(s + 1 + j) % P] holds v[yb + j + d] and B[(j - s - 1) mod P]
    // v[yb + j - d] at step s (d = s + 1); both start as the centres
    float acc[P], F[P], B[P];
#pragma unroll
    for (int j = 0; j < P; ++j) acc[j] = F[j] = B[j] = load(yb + j);
    run_steps<P>(min(r, max(H - yb, yb + P)), [&](int a, int s) {
        F[a] = load(yb + P + s);
        B[P - 1 - a] = load(yb - 1 - s);
#pragma unroll
        for (int j = 0; j < P; ++j) {
            acc[j] = __fadd_rn(__fadd_rn(acc[j], F[(a + 1 + j) % P]),
                               B[(j + 2 * P - a - 1) % P]);
        }
    });
#pragma unroll
    for (int j = 0; j < P; ++j) res[j] = acc[j];
}

template <bool GAUSS>
__global__ void __launch_bounds__(32 * KY_WARPS)
pass_y_kernel(const float* __restrict__ in, float* __restrict__ out, int H,
              int W, int r, const float* __restrict__ taps) {
    const int x = blockIdx.x * 32 + (threadIdx.x & 31);
    const int yb = (blockIdx.y * KY_WARPS + (threadIdx.x >> 5)) * KY_P;
    if (x >= W || yb >= H) return;
    const size_t plane = (size_t)blockIdx.z * H * W;
    const float* col = in + plane + x;
    // every value the warp's taps read lies in the frame
    const bool inner = yb - r >= 0 && yb + KY_P + r <= H;
    float res[KY_P];
    if constexpr (GAUSS) {
        if (inner) {
            gauss_y<false>(col, H, W, yb, r, taps, res);
        } else {
            gauss_y<true>(col, H, W, yb, r, taps, res);
        }
    } else {
        if (inner) {
            box_y<false>(col, H, W, yb, r, res);
        } else {
            box_y<true>(col, H, W, yb, r, res);
        }
    }
    float* o = out + plane + (size_t)yb * W + x;
#pragma unroll
    for (int j = 0; j < KY_P; ++j) {
        if (yb + j < H) o[(size_t)j * W] = res[j];
    }
}

// Stages columns [c0, c0 + n) of `row` into s by cp.async (zeros beyond
// the frame), the warp's lanes in turn; returns with the warp's copies
// complete and visible to the warp.
__device__ __forceinline__ void stage_row(float* s, const float* row, int W,
                                          int c0, int n, int lane) {
    for (int i = lane; i < n; i += 32) {
        const int c = c0 + i;
        if (c >= 0 && c < W) {
            cp_async4(s + i, row + c);
        } else {
            s[i] = 0.0f;
        }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();
}

// The gaussian along x for the KX_P outputs from column x0 + xl of `row`,
// staged a chunk of steps at a time in `seg`.
__device__ __forceinline__ void gauss_x(const float* row, int H, int W,
                                        int x0, int xl, int r,
                                        const float* __restrict__ taps,
                                        int chunk, float* seg, int lane,
                                        float (&res)[KX_P]) {
    constexpr int P = KX_P;
    const int k_lo = max(0, r - (x0 + KX_TW - 1));
    const int n = min(2 * r, r + W - 1 - x0) - k_lo + 1;
    float num[P], w[P];
#pragma unroll
    for (int j = 0; j < P; ++j) num[j] = 0.0f;
    // seg[i] holds column x0 - r + k_lo + c0 + i: the value that output j
    // of lane 0 reads at step c0 + i - j
    const float* sv = seg + xl;
    for (int c0 = 0; c0 < n; c0 += chunk) {
        const int cn = min(chunk, n - c0);
        __syncwarp();
        stage_row(seg, row, W, x0 - r + k_lo + c0, cn + KX_TW - 1, lane);
        if (c0 == 0) {
#pragma unroll
            for (int q = 0; q < P - 1; ++q) w[q] = sv[q];
        }
        const float* t = taps + k_lo + c0;
        run_steps<P>(cn, [&](int a, int s) {
            w[(a + P - 1) % P] = sv[s + P - 1];
            const float tk = __ldg(t + s);
#pragma unroll
            for (int j = 0; j < P; ++j) {
                num[j] = __fadd_rn(num[j], __fmul_rn(tk, w[(a + j) % P]));
            }
        });
    }
    // the denominators first: read between the divisions, one spilled
    const float* den = taps + 2 * r + 1 + H;   // den_x
    float d[P];
#pragma unroll
    for (int j = 0; j < P; ++j) d[j] = __ldg(den + min(x0 + xl + j, W - 1));
#pragma unroll
    for (int j = 0; j < P; ++j) res[j] = num[j] / d[j];
}

// The box's pass along x, divided by the in-range tap count, as gauss_x:
// each chunk stages the values ahead of the outputs in sf and those behind
// in sb.
__device__ __forceinline__ void box_x(const float* row, int H, int W, int y,
                                      int x0, int xl, int r, int chunk,
                                      float* seg, int lane,
                                      float (&res)[KX_P]) {
    constexpr int P = KX_P;
    const int n = min(r, max(W - x0, x0 + KX_TW));
    float* sf = seg;
    float* sb = seg + chunk + KX_TW;
    float acc[P], F[P], B[P];
    int c0 = 0;
    do {
        const int cn = min(chunk, n - c0);
        __syncwarp();
        // sf: columns [x0 + c0, x0 + c0 + cn + KX_TW) (the centres in the
        // first chunk); sb: columns [x0 - c0 - cn, x0 - c0 + KX_TW)
        stage_row(sf, row, W, x0 + c0, cn + KX_TW, lane);
        stage_row(sb, row, W, x0 - c0 - cn, cn + KX_TW, lane);
        if (c0 == 0) {
#pragma unroll
            for (int j = 0; j < P; ++j) acc[j] = F[j] = B[j] = sf[xl + j];
        }
        const float* pf = sf + xl + P;
        const float* pb = sb + xl - 1 + cn;
        run_steps<P>(cn, [&](int a, int t) {
            F[a] = pf[t];
            B[P - 1 - a] = pb[-t];
#pragma unroll
            for (int j = 0; j < P; ++j) {
                acc[j] = __fadd_rn(__fadd_rn(acc[j], F[(a + 1 + j) % P]),
                                   B[(j + 2 * P - a - 1) % P]);
            }
        });
        c0 += chunk;
    } while (c0 < n);
    const int ny = min(y + r, H - 1) - max(y - r, 0) + 1;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const int x = x0 + xl + j;
        const int nx = min(x + r, W - 1) - max(x - r, 0) + 1;
        res[j] = acc[j] / (float)(ny * nx);
    }
}

template <bool GAUSS>
__global__ void __launch_bounds__(32 * KX_WARPS)
pass_x_kernel(const float* __restrict__ in, float* __restrict__ out, int H,
              int W, int r, const float* __restrict__ taps, int chunk) {
    extern __shared__ float kx_seg[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int y = blockIdx.y * KX_WARPS + warp;
    if (y >= H) return;
    const int x0 = blockIdx.x * KX_TW, xl = lane * KX_P;
    const size_t at = (size_t)blockIdx.z * H * W + (size_t)y * W;
    float* seg = kx_seg + warp * (GAUSS ? 1 : 2) * (chunk + KX_TW);
    float res[KX_P];
    if constexpr (GAUSS) {
        gauss_x(in + at, H, W, x0, xl, r, taps, chunk, seg, lane, res);
    } else {
        box_x(in + at, H, W, y, x0, xl, r, chunk, seg, lane, res);
    }
    // out through the segment, a row at a time
    __syncwarp();
#pragma unroll
    for (int j = 0; j < KX_P; ++j) seg[xl + j] = res[j];
    __syncwarp();
    float* o = out + at + x0;
    const int n = min(KX_TW, W - x0);
    for (int i = lane; i < n; i += 32) o[i] = seg[i];
}

// Dynamic shared memory above the default 48 KB needs the kernel's
// attribute raised first; a size the card cannot give fails here.
template <typename K>
static cudaError_t allow_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

static bool vec_aligned(const float* out, int W) {
    return W % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

template <int R>
static int launch_box(const float* in, float* out, int C, int H, int W,
                      int levels, cudaStream_t s) {
    const int h = R * levels;
    const size_t rows = (KF_TH + 2 * h)
        + (levels > 1 ? KF_TH + 2 * (h - R) : 0);
    const size_t smem = sizeof(float) * staged_stride(KF_TW + 2 * h) * rows;
    const cudaError_t err = allow_smem(box_filter_kernel<R>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((W + KF_TW - 1) / KF_TW, (H + KF_TH - 1) / KF_TH, C);
    box_filter_kernel<R><<<grid, K10_THREADS, smem, s>>>(
        in, out, H, W, levels, vec_aligned(out, W));
    return (int)cudaGetLastError();
}

template <int R>
static int launch_gaussian(const float* in, float* out, const GaussParams& p,
                           cudaStream_t s) {
    const size_t smem = sizeof(float)
        * ((size_t)staged_stride(KF_TW + 2 * R) * (2 * KF_TH + 2 * R)
           + 2 * R + 1);
    const cudaError_t err = allow_smem(gaussian_filter_kernel<R>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((p.W + KF_TW - 1) / KF_TW, (p.H + KF_TH - 1) / KF_TH,
                    p.C);
    gaussian_filter_kernel<R><<<grid, K11_THREADS, smem, s>>>(
        in, out, p, vec_aligned(out, p.W));
    return (int)cudaGetLastError();
}

}  // namespace

// K10: `levels` levels of the box average in one launch, r 0-4 (past it
// the 1-D passes, rdt_filter_pass).
extern "C" int rdt_box_filter(const float* in, float* out, int C, int H,
                              int W, int radius, int levels, void* stream) {
    if (levels < 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (radius) {
    case 0: return launch_box<0>(in, out, C, H, W, levels, s);
    case 1: return launch_box<1>(in, out, C, H, W, levels, s);
    case 2: return launch_box<2>(in, out, C, H, W, levels, s);
    case 3: return launch_box<3>(in, out, C, H, W, levels, s);
    case 4: return launch_box<4>(in, out, C, H, W, levels, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

// K11: one iteration of the gaussian, both passes, r 0-4 (past it the 1-D
// passes, rdt_filter_pass).
extern "C" int rdt_gaussian_filter(const float* in, float* out,
                                   const GaussParams* params, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (params->radius) {
    case 0: return launch_gaussian<0>(in, out, *params, s);
    case 1: return launch_gaussian<1>(in, out, *params, s);
    case 2: return launch_gaussian<2>(in, out, *params, s);
    case 3: return launch_gaussian<3>(in, out, *params, s);
    case 4: return launch_gaussian<4>(in, out, *params, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

// K10 and K11 in 1-D passes: one pass, the gaussian's with its 2r + 1
// taps and its denominators by row and by column from the device array
// `taps` (2r + 1 + H + W floats), the box's where taps is NULL.
extern "C" int rdt_filter_pass(const float* in, float* out, int C, int H,
                               int W, int radius, const float* taps,
                               int along_y, void* stream) {
    if (radius < 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (along_y) {
        const dim3 grid((W + 31) / 32,
                        (H + KY_P * KY_WARPS - 1) / (KY_P * KY_WARPS), C);
        if (taps) {
            pass_y_kernel<true><<<grid, 32 * KY_WARPS, 0, s>>>(
                in, out, H, W, radius, taps);
        } else {
            pass_y_kernel<false><<<grid, 32 * KY_WARPS, 0, s>>>(
                in, out, H, W, radius, taps);
        }
    } else {
        const bool gauss = taps != nullptr;
        const int chunk = kx_chunk(gauss, radius, W);
        const size_t smem = kx_smem_bytes(gauss, chunk);
        const dim3 grid((W + KX_TW - 1) / KX_TW,
                        (H + KX_WARPS - 1) / KX_WARPS, C);
        if (gauss) {
            pass_x_kernel<true><<<grid, 32 * KX_WARPS, smem, s>>>(
                in, out, H, W, radius, taps, chunk);
        } else {
            pass_x_kernel<false><<<grid, 32 * KX_WARPS, smem, s>>>(
                in, out, H, W, radius, taps, chunk);
        }
    }
    return (int)cudaGetLastError();
}

// K12: the staged form for r <= kMaxStagedRadius, else the rolling-row
// tile (r > 16: the spatial taps from the device array wide_gt, NULL below)
extern "C" int rdt_cross_bilateral(const float* color, const float* albedo,
                                   const float* normal, const float* depth,
                                   float* out, const CrossParams* params,
                                   const float* wide_gt, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int H = params->H, W = params->W, r = params->radius;
    if (r < 0 || (r > kMaxTaps / 2 && !wide_gt)) {
        return (int)cudaErrorInvalidValue;
    }
    const dim3 block(K12_TX, K12_TY);
    const dim3 staged((W + K12_TX - 1) / K12_TX,
                      (H + K12_TY * kCrossPx - 1) / (K12_TY * kCrossPx));
#define RDT_CROSS(R)                                                       \
    cross_bilateral_staged_kernel<R, kCrossPx><<<staged, block, 0, s>>>(   \
        color, albedo, normal, depth, out, *params)
    switch (r) {
    case 0: RDT_CROSS(0); break;
    case 1: RDT_CROSS(1); break;
    case 2: RDT_CROSS(2); break;
    case 3: RDT_CROSS(3); break;
    case 4: RDT_CROSS(4); break;
    default: {
        const dim3 rb(KR_TX, KR_TY);
        const dim3 grid((W + KR_TX - 1) / KR_TX, (H + KR_OH - 1) / KR_OH);
        if (kr_smem(true, r) <= kSmemOptin) {
            const size_t smem = kr_smem(true, r);
            const cudaError_t err = allow_smem(
                cross_bilateral_rolling_kernel<true>, smem);
            if (err != cudaSuccess) return (int)err;
            cross_bilateral_rolling_kernel<true><<<grid, rb, smem, s>>>(
                color, albedo, normal, depth, out, *params, wide_gt);
        } else {
            const size_t smem = kr_smem(false, r);
            const cudaError_t err = allow_smem(
                cross_bilateral_rolling_kernel<false>, smem);
            if (err != cudaSuccess) return (int)err;
            cross_bilateral_rolling_kernel<false><<<grid, rb, smem, s>>>(
                color, albedo, normal, depth, out, *params, wide_gt);
        }
    }
    }
#undef RDT_CROSS
    return (int)cudaGetLastError();
}
