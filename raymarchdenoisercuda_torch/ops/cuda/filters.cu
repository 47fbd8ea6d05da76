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
// once.  The radius is a template parameter for r <= 4; a generic body
// takes r up to 16.  Past r 16, K10 and K11 run as their twins do: two
// 1-D passes (sep_pass_kernel), along y into a global intermediate and
// along x from it, each tap read through the caches (O(r) work an output
// where a staged tile would hold a halo of 2r rows); K12's one-thread-a-
// pixel body reads its gaussian taps from a device array there (the
// à-trous WIDE instantiation's way), not from the launch's parameter struct.
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
//   normal terms together, so the squaring loop runs once a row.  The
//   one-thread-a-pixel body, reading each tap's ten values through L1
//   (250 loads a pixel at r2), stays for r > 4.  Both add the same floats
//   in the same order (dy-major, dx-minor, taps beyond the frame
//   skipped), so they agree to the bit.
//
// Bound on the card: bytes (K10, K11: 24 B a pixel of three planes, for a
// launch of any depth or an iteration; K12: 52 B a pixel), with K12 close
// to its operation bound (~37 flops a tap).  K10 at r2 and K11 reach
// about half the HBM rate: their adds, divisions and shared-memory loads
// (~35 instructions an output) do not overlap the staging fully; the
// staged K12 is held by its instructions (~50 a tap
// with --fmad=false) and its shared-memory reads (40 B a staged tap, 24 B
// a pixel's tap at r2 with two pixels a thread).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int kMaxTaps = 33;  // the taps a parameter struct holds: r <= 16

// Launch parameters, passed by pointer from ops/filters_cuda.py (ctypes).
struct GaussParams {
    int C, H, W, radius;
    float taps[kMaxTaps];       // _gauss_taps(radius, sigma), r <= 16
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

__device__ float pow_sigma_n(float x, const CrossParams& p) {
    if (p.pow2_steps < 0) return powf(fmaxf(x, 1e-20f), p.sigma_normal);
    for (int k = 0; k < p.pow2_steps; ++k) x = x * x;
    return x;
}

// color, albedo, normal (3, H, W) and depth (H, W) -> out (3, H, W); the
// spatial taps from p.gt, or (WIDE, r > 16) from the device array wide_gt
template <bool WIDE>
__global__ void cross_bilateral_kernel(const float* __restrict__ color,
                                       const float* __restrict__ albedo,
                                       const float* __restrict__ normal,
                                       const float* __restrict__ depth,
                                       float* __restrict__ out,
                                       CrossParams p,
                                       const float* __restrict__ wide_gt) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.W || y >= p.H) return;
    const int hw = p.H * p.W, i = y * p.W + x, r = p.radius;
    const float a0 = albedo[i], a1 = albedo[hw + i], a2 = albedo[2 * hw + i];
    const float n0 = normal[i], n1 = normal[hw + i], n2 = normal[2 * hw + i];
    const float z = depth[i];
    float num0 = 0.0f, num1 = 0.0f, num2 = 0.0f, den = 0.0f;
    for (int dy = -r; dy <= r; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= p.H) continue;
        for (int dx = -r; dx <= r; ++dx) {
            const int xx = x + dx;
            if (xx < 0 || xx >= p.W) continue;
            const int q = yy * p.W + xx;
            const float d0 = a0 - albedo[q];
            const float d1 = a1 - albedo[hw + q];
            const float d2 = a2 - albedo[2 * hw + q];
            const float da2 = d0 * d0 + d1 * d1 + d2 * d2;
            const float ndot = fmaxf(
                n0 * normal[q] + n1 * normal[hw + q] + n2 * normal[2 * hw + q],
                0.0f);
            const float arg = -(da2 * p.inv_2sa2 + fabsf(z - depth[q]) * p.inv_sz);
            const float gy = WIDE ? wide_gt[dy + r] : p.gt[dy + r];
            const float gx = WIDE ? wide_gt[dx + r] : p.gt[dx + r];
            const float w = gy * gx * exp2f(arg) * pow_sigma_n(ndot, p);
            num0 = num0 + w * color[q];
            num1 = num1 + w * color[hw + q];
            num2 = num2 + w * color[2 * hw + q];
            den = den + w;
        }
    }
    den = fmaxf(den, p.eps);
    out[i] = num0 / den;
    out[hw + i] = num1 / den;
    out[2 * hw + i] = num2 / den;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src));
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
// the row's columns k + d, d = 0..2r in that order (r = R, or the runtime
// radius when R < 0), through f(k, d, value).  `row` is 16-byte aligned;
// the window's KF_PX + 2r floats are loaded once, as float4.
template <int R, typename F>
__device__ __forceinline__ void row_window(const float* row, int r, F&& f) {
    const float4* q = reinterpret_cast<const float4*>(row);
    if constexpr (R >= 0) {
#pragma unroll
        for (int c = 0; c < (KF_PX + 2 * R + 3) / 4; ++c) {
            window_quad(q[c], c, 2 * R, f);
        }
    } else {
        for (int c = 0; c < (KF_PX + 2 * r + 3) / 4; ++c) {
            window_quad(q[c], c, 2 * r, f);
        }
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

// K10: `levels` levels of the (2r+1)^2 box average (r = R, or `radius`
// when R < 0) on one plane's tile.  The block stages the tile and a halo
// of h = r·levels (zeros beyond the frame) and runs the levels in shared
// memory, ping-pong: level l over the tile grown by r·(levels - l), its
// pixels beyond the frame stored as 0; the last level's tile goes to
// `out`.  Each output adds its taps dy-major, dx-minor (a staged zero adds
// +0.0 to a sum that starts at +0.0: the per-level kernel's sum of the
// in-range taps, bit for bit) and divides by the in-range tap count.
template <int R>
__global__ void __launch_bounds__(K10_THREADS)
box_filter_kernel(const float* __restrict__ in, float* __restrict__ out,
                  int H, int W, int radius, int levels, bool vec_out) {
    extern __shared__ float4 kf_smem[];
    const int r = R >= 0 ? R : radius;
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
                row_window<R>(src + (i + dy) * sw + c, r,
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

// K11: one iteration of the border-renormalised separable gaussian (r = R,
// or p.radius when R < 0) on one plane's tile.  The block stages the tile
// and an r-pixel halo (zeros beyond the frame), computes the pass along y
// over the tile's width and its x-halo into shared memory (a column beyond
// the frame holds 0), then the pass along x from there, and writes the
// result once.  Each pass adds tap·value for k = 0..2r in order and divides
// by the ordered sum of its in-range taps, as the row and column launches
// did (a staged zero adds +0.0; the intermediate is rounded to float as
// their global buffer was): bit for bit the same floats.
template <int R>
__global__ void __launch_bounds__(K11_THREADS)
gaussian_filter_kernel(const float* __restrict__ in, float* __restrict__ out,
                       GaussParams p, bool vec_out) {
    extern __shared__ float4 kf_smem[];
    const int r = R >= 0 ? R : p.radius;
    const int H = p.H, W = p.W;
    const int sw = staged_stride(KF_TW + 2 * r);
    float* s = reinterpret_cast<float*>(kf_smem);   // KF_TH + 2r rows
    float* v = s + (KF_TH + 2 * r) * sw;            // KF_TH rows
    float* taps = v + KF_TH * sw;                   // kMaxTaps
    if (threadIdx.x == 0) {
#pragma unroll
        for (int k = 0; k < kMaxTaps; ++k) taps[k] = p.taps[k];
    }
    const int x0 = blockIdx.x * KF_TW, y0 = blockIdx.y * KF_TH;
    const size_t hw = (size_t)H * W;
    stage_plane<K11_THREADS>(s, sw, in + blockIdx.z * hw, H, W, y0 - r,
                             x0 - r, KF_TH + 2 * r, KF_TW + 2 * r);
    // the taps in registers at a compiled radius
    float t[R >= 0 ? 2 * R + 1 : 1];
    if constexpr (R >= 0) {
#pragma unroll
        for (int k = 0; k <= 2 * R; ++k) t[k] = taps[k];
    }
    auto tap = [&](int k) {
        if constexpr (R >= 0) {
            return t[k];
        } else {
            return taps[k];
        }
    };
    // the denominator where every tap lies in the frame
    float den_all = 0.0f;
#pragma unroll
    for (int k = 0; k <= 2 * r; ++k) den_all = den_all + tap(k);

    // pass along y: a column quad of one row a thread
    const int quads = (KF_TW + 2 * r + 3) / 4;
    for (int it = threadIdx.x; it < KF_TH * quads; it += K11_THREADS) {
        const int i = it / quads, c = (it - i * quads) * 4;
        float num[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k <= 2 * r; ++k) {
            const float4 q = *reinterpret_cast<const float4*>(
                s + (i + k) * sw + c);
            const float tk = tap(k);
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
                den = den + (yy >= 0 && yy < H ? tap(k) : 0.0f);
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
        row_window<R>(v + i * sw + c, r, [&](int k, int d, float val) {
            num[k] = num[k] + tap(d) * val;
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
                    den = den + (xx >= 0 && xx < W ? tap(d) : 0.0f);
                }
            }
            res[k] = num[k] / den;
        }
        store_outputs(plane_out + (size_t)y * W + x, res, W - x, vec_out);
    }
}

// K10 and K11 past r 16: one 1-D pass of the twins (box_filter in
// ops/boxfilter.py, gaussian_filter in ops/filters.py), one output a
// thread (KS_TX x KS_TY a block, one plane a grid layer), every tap read
// through the caches: a warp's loads of one tap are one row segment.
// GAUSS: tap·value for the in-range taps k = 0..2r in order, divided by
// the ordered sum of those taps (the pass along y rounded to float in the
// intermediate).  The box: the centre, then the values at +d and -d for
// d = 1..r (0 beyond the frame), the twin's order; the pass along x
// divides by the in-range tap count.  The twins' floats, bit for bit.
constexpr int KS_TX = 32, KS_TY = 8;

template <bool GAUSS, bool ALONG_Y>
__global__ void __launch_bounds__(KS_TX * KS_TY)
sep_pass_kernel(const float* __restrict__ in, float* __restrict__ out,
                int H, int W, int r, const float* __restrict__ taps) {
    const int x = blockIdx.x * KS_TX + threadIdx.x;
    const int y = blockIdx.y * KS_TY + threadIdx.y;
    if (x >= W || y >= H) return;
    const size_t o = blockIdx.z * (size_t)H * W + (size_t)y * W + x;
    const float* c = in + o;
    const int pos = ALONG_Y ? y : x, n = ALONG_Y ? H : W;
    const ptrdiff_t step = ALONG_Y ? W : 1;
    float res;
    if constexpr (GAUSS) {
        float num = 0.0f, den = 0.0f;
        const int k1 = min(2 * r, n - 1 - pos + r);
        for (int k = max(r - pos, 0); k <= k1; ++k) {
            num = num + taps[k] * c[(k - r) * step];
            den = den + taps[k];
        }
        res = num / den;
    } else {
        float acc = c[0];
        for (int d = 1; d <= r; ++d) {
            const float a = pos + d < n ? c[d * step] : 0.0f;
            const float b = pos - d >= 0 ? c[-d * step] : 0.0f;
            acc = acc + a + b;
        }
        if constexpr (ALONG_Y) {
            res = acc;
        } else {
            const int ny = min(y + r, H - 1) - max(y - r, 0) + 1;
            const int nx = min(x + r, W - 1) - max(x - r, 0) + 1;
            res = acc / (float)(ny * nx);
        }
    }
    out[o] = res;
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
                      int radius, int levels, cudaStream_t s) {
    const int h = radius * levels;
    const size_t rows = (KF_TH + 2 * h)
        + (levels > 1 ? KF_TH + 2 * (h - radius) : 0);
    const size_t smem = sizeof(float) * staged_stride(KF_TW + 2 * h) * rows;
    const cudaError_t err = allow_smem(box_filter_kernel<R>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((W + KF_TW - 1) / KF_TW, (H + KF_TH - 1) / KF_TH, C);
    box_filter_kernel<R><<<grid, K10_THREADS, smem, s>>>(
        in, out, H, W, radius, levels, vec_aligned(out, W));
    return (int)cudaGetLastError();
}

template <int R>
static int launch_gaussian(const float* in, float* out, const GaussParams& p,
                           cudaStream_t s) {
    const int r = p.radius;
    const size_t smem = sizeof(float)
        * ((size_t)staged_stride(KF_TW + 2 * r) * (2 * KF_TH + 2 * r)
           + kMaxTaps);
    const cudaError_t err = allow_smem(gaussian_filter_kernel<R>, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((p.W + KF_TW - 1) / KF_TW, (p.H + KF_TH - 1) / KF_TH,
                    p.C);
    gaussian_filter_kernel<R><<<grid, K11_THREADS, smem, s>>>(
        in, out, p, vec_aligned(out, p.W));
    return (int)cudaGetLastError();
}

dim3 grid_for(int H, int W, int C, dim3 block) {
    return dim3((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, C);
}

}  // namespace

// K10: `levels` levels of the box average in one launch (the radius
// compiled for r <= 4).
extern "C" int rdt_box_filter(const float* in, float* out, int C, int H,
                              int W, int radius, int levels, void* stream) {
    if (radius < 0 || radius > kMaxTaps / 2 || levels < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t s = (cudaStream_t)stream;
    switch (radius) {
    case 0: return launch_box<0>(in, out, C, H, W, radius, levels, s);
    case 1: return launch_box<1>(in, out, C, H, W, radius, levels, s);
    case 2: return launch_box<2>(in, out, C, H, W, radius, levels, s);
    case 3: return launch_box<3>(in, out, C, H, W, radius, levels, s);
    case 4: return launch_box<4>(in, out, C, H, W, radius, levels, s);
    default: return launch_box<-1>(in, out, C, H, W, radius, levels, s);
    }
}

// K11: one iteration of the gaussian, both passes (the radius compiled for
// r <= 4).
extern "C" int rdt_gaussian_filter(const float* in, float* out,
                                   const GaussParams* params, void* stream) {
    if (params->radius < 0 || params->radius > kMaxTaps / 2) {
        return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t s = (cudaStream_t)stream;
    switch (params->radius) {
    case 0: return launch_gaussian<0>(in, out, *params, s);
    case 1: return launch_gaussian<1>(in, out, *params, s);
    case 2: return launch_gaussian<2>(in, out, *params, s);
    case 3: return launch_gaussian<3>(in, out, *params, s);
    case 4: return launch_gaussian<4>(in, out, *params, s);
    default: return launch_gaussian<-1>(in, out, *params, s);
    }
}

// K10 and K11 past r 16: one 1-D pass, the gaussian's with its 2r + 1
// taps from the device array `taps`, the box's where taps is NULL.
extern "C" int rdt_filter_pass(const float* in, float* out, int C, int H,
                               int W, int radius, const float* taps,
                               int along_y, void* stream) {
    if (radius < 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const dim3 block(KS_TX, KS_TY), grid = grid_for(H, W, C, block);
    if (taps && along_y) {
        sep_pass_kernel<true, true><<<grid, block, 0, s>>>(in, out, H, W,
                                                           radius, taps);
    } else if (taps) {
        sep_pass_kernel<true, false><<<grid, block, 0, s>>>(in, out, H, W,
                                                            radius, taps);
    } else if (along_y) {
        sep_pass_kernel<false, true><<<grid, block, 0, s>>>(in, out, H, W,
                                                            radius, taps);
    } else {
        sep_pass_kernel<false, false><<<grid, block, 0, s>>>(in, out, H, W,
                                                             radius, taps);
    }
    return (int)cudaGetLastError();
}

// K12: the staged form for r <= kMaxStagedRadius, else one thread a pixel
// (r > 16: the spatial taps from the device array wide_gt, NULL below)
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
    default:
        if (r > kMaxTaps / 2) {
            cross_bilateral_kernel<true>
                <<<grid_for(H, W, 1, block), block, 0, s>>>(
                    color, albedo, normal, depth, out, *params, wide_gt);
        } else {
            cross_bilateral_kernel<false>
                <<<grid_for(H, W, 1, block), block, 0, s>>>(
                    color, albedo, normal, depth, out, *params, nullptr);
        }
    }
#undef RDT_CROSS
    return (int)cudaGetLastError();
}
