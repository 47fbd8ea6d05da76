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
// levels on one band with a halo of r·depth); that is a layout of the TPU's
// memory.  K10 and K11 are one thread per output pixel with bounds-checked
// loads, the neighbouring taps from L1/L2; K12 stages its tile:
//
// * K10: one launch per level (ping-pong buffers in the wrapper), one
//   thread per pixel and channel; the in-range taps are summed dy-major,
//   dx-minor (the TPU kernel's order) and divided by their count.
// * K11: a row pass and a column pass, each a launch; each divides by the
//   sum of its in-range 1-D tap weights (the taps are launch arguments).
//   The plain twin adds the same products in the same order, so the two
//   agree to the bit (the library is built with --fmad=false).
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
// Bound on the card: bytes (K10, K11: 24 B a pixel and level or pass of
// three planes; K12: 52 B a pixel), with K12 close to its operation bound
// (~37 flops a tap); the staged K12 is held by its instructions (~50 a tap
// with --fmad=false) and its shared-memory reads (40 B a staged tap, 24 B
// a pixel's tap at r2 with two pixels a thread).

#include <cuda_runtime.h>
#include <math.h>

constexpr int kMaxTaps = 33;  // radius <= 16

// Launch parameters, passed by pointer from ops/filters_cuda.py (ctypes).
struct GaussParams {
    int C, H, W, radius, axis;  // axis 0: taps along y, 1: along x
    float taps[kMaxTaps];       // _gauss_taps(radius, sigma)
};

struct CrossParams {
    int H, W, radius;
    int pow2_steps;   // >= 0: sigma_n = 2^pow2_steps; -1: powf
    float inv_2sa2;   // log2(e) / (2 sigma_albedo^2 + eps)
    float inv_sz;     // log2(e) / (sigma_depth + eps)
    float sigma_normal, eps;
    float gt[kMaxTaps];  // _gauss_taps(radius, sigma_space)
};

namespace {

__global__ void box_level_kernel(const float* __restrict__ in,
                                 float* __restrict__ out, int H, int W,
                                 int r) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= W || y >= H) return;
    const size_t hw = (size_t)H * W;
    const float* plane = in + blockIdx.z * hw;
    float acc = 0.0f, cnt = 0.0f;
    for (int dy = -r; dy <= r; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= H) continue;
        for (int dx = -r; dx <= r; ++dx) {
            const int xx = x + dx;
            if (xx < 0 || xx >= W) continue;
            acc = acc + plane[(size_t)yy * W + xx];
            cnt = cnt + 1.0f;
        }
    }
    out[blockIdx.z * hw + (size_t)y * W + x] = acc / cnt;
}

__global__ void gauss_pass_kernel(const float* __restrict__ in,
                                  float* __restrict__ out, GaussParams p) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.W || y >= p.H) return;
    const size_t hw = (size_t)p.H * p.W;
    const float* plane = in + blockIdx.z * hw;
    float num = 0.0f, den = 0.0f;
    for (int k = 0; k <= 2 * p.radius; ++k) {
        const int d = k - p.radius;
        const int yy = p.axis == 0 ? y + d : y;
        const int xx = p.axis == 0 ? x : x + d;
        if (yy < 0 || yy >= p.H || xx < 0 || xx >= p.W) continue;
        num = num + p.taps[k] * plane[(size_t)yy * p.W + xx];
        den = den + p.taps[k];
    }
    out[blockIdx.z * hw + (size_t)y * p.W + x] = num / den;
}

__device__ float pow_sigma_n(float x, const CrossParams& p) {
    if (p.pow2_steps < 0) return powf(fmaxf(x, 1e-20f), p.sigma_normal);
    for (int k = 0; k < p.pow2_steps; ++k) x = x * x;
    return x;
}

// color, albedo, normal (3, H, W) and depth (H, W) -> out (3, H, W)
__global__ void cross_bilateral_kernel(const float* __restrict__ color,
                                       const float* __restrict__ albedo,
                                       const float* __restrict__ normal,
                                       const float* __restrict__ depth,
                                       float* __restrict__ out,
                                       CrossParams p) {
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
            const float w = p.gt[dy + r] * p.gt[dx + r] * exp2f(arg)
                * pow_sigma_n(ndot, p);
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

dim3 grid_for(int H, int W, int C, dim3 block) {
    return dim3((W + block.x - 1) / block.x, (H + block.y - 1) / block.y, C);
}

}  // namespace

extern "C" int rdt_box_level(const float* in, float* out, int C, int H, int W,
                             int radius, void* stream) {
    dim3 block(32, 8);
    box_level_kernel<<<grid_for(H, W, C, block), block, 0,
                       (cudaStream_t)stream>>>(in, out, H, W, radius);
    return (int)cudaGetLastError();
}

extern "C" int rdt_gauss_pass(const float* in, float* out,
                              const GaussParams* params, void* stream) {
    dim3 block(32, 8);
    gauss_pass_kernel<<<grid_for(params->H, params->W, params->C, block), block,
                        0, (cudaStream_t)stream>>>(in, out, *params);
    return (int)cudaGetLastError();
}

// K12: the staged form for r <= kMaxStagedRadius, else one thread a pixel
extern "C" int rdt_cross_bilateral(const float* color, const float* albedo,
                                   const float* normal, const float* depth,
                                   float* out, const CrossParams* params,
                                   void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int H = params->H, W = params->W;
    const dim3 block(K12_TX, K12_TY);
    const dim3 staged((W + K12_TX - 1) / K12_TX,
                      (H + K12_TY * kCrossPx - 1) / (K12_TY * kCrossPx));
#define RDT_CROSS(R)                                                       \
    cross_bilateral_staged_kernel<R, kCrossPx><<<staged, block, 0, s>>>(   \
        color, albedo, normal, depth, out, *params)
    switch (params->radius) {
    case 0: RDT_CROSS(0); break;
    case 1: RDT_CROSS(1); break;
    case 2: RDT_CROSS(2); break;
    case 3: RDT_CROSS(3); break;
    case 4: RDT_CROSS(4); break;
    default:
        cross_bilateral_kernel<<<grid_for(H, W, 1, block), block, 0, s>>>(
            color, albedo, normal, depth, out, *params);
    }
#undef RDT_CROSS
    return (int)cudaGetLastError();
}
