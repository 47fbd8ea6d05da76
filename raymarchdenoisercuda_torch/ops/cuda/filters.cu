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
// memory.  Here every kernel is one thread per output pixel with
// bounds-checked loads, and the neighbouring taps come from L1/L2:
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
//   squaring for a power-of-two sigma_n up to 1024, else powf.
//
// Bound on the card: bytes (K10, K11: 24 B a pixel and level or pass of
// three planes; K12: 52 B a pixel), with K12 close to its operation bound
// (~37 flops a tap).  Shared-memory tiles of the halo are later work.

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

extern "C" int rdt_cross_bilateral(const float* color, const float* albedo,
                                   const float* normal, const float* depth,
                                   float* out, const CrossParams* params,
                                   void* stream) {
    dim3 block(32, 8);
    cross_bilateral_kernel<<<grid_for(params->H, params->W, 1, block), block,
                             0, (cudaStream_t)stream>>>(
        color, albedo, normal, depth, out, *params);
    return (int)cudaGetLastError();
}
