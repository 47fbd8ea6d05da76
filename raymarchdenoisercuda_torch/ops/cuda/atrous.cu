// K1: one level of the edge-aware à-trous SVGF filter, forward, and K2: the
// stored-weight adjoint of one level.
//
// K1 replaces the TPU kernel raymarchdenoisercuda_tpu/ops/pallas/atrous_tpu.py
// _make_level_kernel(mode="fwd", fuse_isd=True) as driven by
// atrous_level_fwd_canvas / _svgf_chained_fwd: with bwd_impl="none"
// (inference, no weight writes) or "stored" (the store mode below).  Its
// plain twin is atrous_level_ref in ops/atrous.py; the arithmetic follows
// that function operation by operation (the library is built with
// --fmad=false, so no multiply-add is contracted), which keeps the kernel
// within float rounding of the twin.
//
// One thread per output pixel.  The TPU kernel's row bands, 128-lane
// canvases, manual DMA and lane rolls do not carry over: a thread reads its
// (2r+1)^2 taps at spacing 2^level straight from global memory with bounds
// checks, and a tap outside the image is dropped (zero weight), which is
// what the TPU kernel's border mask achieves.  The 3x3 variance blur that
// sets the luminance sigma is fused in, as on the TPU.
//
// Store mode (w_out and n_out non-null, the training forward): the thread
// also writes its (2r+1)^2 tap weights, h and the border mask included, as
// bf16 (round to nearest even), and N = max(sum w, eps) as float.  The
// colour and variance use the float weights, and N is their float sum; only
// the adjoint sees the rounded weights, as on the TPU.
//
// Bound on the card: memory.  Per pixel and level the taps read
// (2r+1)^2 x 9 floats (colour, variance, normal, depth) that neighbouring
// threads share through L1/L2; the weight math is ~40 flops a tap.  The
// least traffic is 56 B/px (inputs once, outputs once), 78 B/px in store mode
// at radius 1.  This first version leaves the reuse to the caches (no
// shared-memory tiling).
//
// K2 replaces _make_level_kernel(mode="stored") as called by
// atrous_level_bwd_stored_canvas (the backward of _svgf_chained with
// bwd_impl="stored"); its plain twin is atrous_level_bwd_stored_ref.  In
// gather form: the thread of output pixel x sums, over taps d, the centre
// p = x - d*2^level's stored weight w_p(d) against u = gc_p / max(N_p, eps)
// and, squared, against u2 = gv_p / max(N_p, eps)^2.  A gather needs no
// atomics, so the sum is deterministic and in the twin's tap order.  Bound:
// memory, 54 B/px at radius 1 and 86 B/px at radius 2 (bf16 weights, N,
// gc, gv in; dc, dv out); the centres' reads are shared between threads
// through the caches.

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

namespace {

constexpr float kEps = 1e-8f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kL0 = 0.2126f, kL1 = 0.7152f, kL2 = 0.0722f;

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

__device__ __forceinline__ float luma(const float* c, int i, int hw) {
    return kL0 * c[i] + kL1 * c[hw + i] + kL2 * c[2 * hw + i];
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

__global__ void atrous_level_kernel(const float* __restrict__ color,
                                    const float* __restrict__ var,
                                    const float* __restrict__ normal,
                                    const float* __restrict__ depth,
                                    const float* __restrict__ zgrad,
                                    float* __restrict__ color_out,
                                    float* __restrict__ var_out,
                                    __nv_bfloat16* __restrict__ w_out,
                                    float* __restrict__ n_out,
                                    AtrousParams p) {
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.W || y >= p.H) return;
    const int H = p.H, W = p.W, hw = H * W;
    const int i = y * W + x;

    // fused sigma denominator: (1/4, 1/2, 1/4)^2 blur of the variance over
    // in-image taps, renormalised (variance_blur3x3)
    const float k1[3] = {0.25f, 0.5f, 0.25f};
    float num = 0.0f, kden = 0.0f;
    for (int dy = -1; dy <= 1; ++dy) {
        int qy = y + dy;
        for (int dx = -1; dx <= 1; ++dx) {
            int qx = x + dx;
            if (qy < 0 || qy >= H || qx < 0 || qx >= W) continue;
            float k = k1[dy + 1] * k1[dx + 1];
            num = num + k * var[qy * W + qx];
            kden = kden + k;
        }
    }
    const float sden = p.sigma_color * sqrtf(fmaxf(num / kden, 0.0f)) + kEps;
    const float isd2 = kLog2e / fmaxf(sden, kEps);

    const float lum_c = luma(color, i, hw);
    const float z_c = depth[i];
    const float n0 = normal[i], n1 = normal[hw + i], n2 = normal[2 * hw + i];
    const float zg0 = zgrad[i], zg1 = zgrad[hw + i];

    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc_v = 0.0f, den = 0.0f;
    const int r = p.radius;
    const int side = 2 * r + 1;
    for (int dy = -r; dy <= r; ++dy) {
        const int oy = dy * p.spacing;
        const int qy = y + oy;
        const bool row_in = qy >= 0 && qy < H;
        for (int dx = -r; dx <= r; ++dx) {
            const int ox = dx * p.spacing;
            const int qx = x + ox;
            if (!row_in || qx < 0 || qx >= W) {
                // dropped tap: its stored weight is zero
                if (w_out) {
                    w_out[((dy + r) * side + (dx + r)) * hw + i] =
                        __float2bfloat16_rn(0.0f);
                }
                continue;
            }
            const int q = qy * W + qx;
            const float h = p.taps[dy + r] * p.taps[dx + r];
            const float dl = fabsf(lum_c - luma(color, q, hw));
            float w;
            if (p.fast) {
                float arg = -dl * isd2;
                if (!p.luma_only) {
                    float zdot = fabsf(zg0 * (float)oy + zg1 * (float)ox);
                    float wz2 = -fabsf(z_c - depth[q]) / (p.sz2 * zdot + p.eps2);
                    float d0 = n0 - normal[q];
                    float d1 = n1 - normal[hw + q];
                    float d2 = n2 - normal[2 * hw + q];
                    float s = d0 * d0 + d1 * d1 + d2 * d2;
                    arg = wz2 + arg - (p.c_s1 * s + p.c_s2 * (s * s));
                }
                w = h * exp2_fast3(arg);
            } else {
                float wl = -dl / sden;
                if (p.luma_only) {
                    w = h * expf(wl);
                } else {
                    float zdot = fabsf(zg0 * (float)oy + zg1 * (float)ox);
                    float wz = -fabsf(z_c - depth[q]) / (p.sigma_depth * zdot + kEps);
                    float ndot = fmaxf(n0 * normal[q] + n1 * normal[hw + q]
                                       + n2 * normal[2 * hw + q], 0.0f);
                    float wn = powf(fmaxf(ndot, 1e-20f), p.sigma_normal);
                    w = h * expf(wz + wl) * wn;
                }
            }
            if (w_out) {
                w_out[((dy + r) * side + (dx + r)) * hw + i] = __float2bfloat16_rn(w);
            }
            acc0 = acc0 + w * color[q];
            acc1 = acc1 + w * color[hw + q];
            acc2 = acc2 + w * color[2 * hw + q];
            acc_v = acc_v + (w * w) * var[q];
            den = den + w;
        }
    }
    den = fmaxf(den, kEps);
    color_out[i] = acc0 / den;
    color_out[hw + i] = acc1 / den;
    color_out[2 * hw + i] = acc2 / den;
    var_out[i] = acc_v / (den * den);
    if (n_out) n_out[i] = den;
}

// K2: gather-form stored-weight adjoint (see the header).
__global__ void atrous_bwd_stored_kernel(const __nv_bfloat16* __restrict__ w,
                                         const float* __restrict__ norm,
                                         const float* __restrict__ gc,
                                         const float* __restrict__ gv,
                                         float* __restrict__ dc,
                                         float* __restrict__ dv,
                                         int H, int W, int spacing, int r) {
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= W || y >= H) return;
    const int hw = H * W, i = y * W + x;
    const int side = 2 * r + 1;
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc_v = 0.0f;
    for (int dy = -r; dy <= r; ++dy) {
        const int py = y - dy * spacing;
        if (py < 0 || py >= H) continue;
        for (int dx = -r; dx <= r; ++dx) {
            const int px = x - dx * spacing;
            if (px < 0 || px >= W) continue;
            const int c = py * W + px;
            const float wk = __bfloat162float(w[((dy + r) * side + (dx + r)) * hw + c]);
            const float inv_n = 1.0f / fmaxf(norm[c], kEps);
            const float u2 = gv[c] * (inv_n * inv_n);
            acc0 = acc0 + wk * (gc[c] * inv_n);
            acc1 = acc1 + wk * (gc[hw + c] * inv_n);
            acc2 = acc2 + wk * (gc[2 * hw + c] * inv_n);
            acc_v = acc_v + (wk * wk) * u2;
        }
    }
    dc[i] = acc0;
    dc[hw + i] = acc1;
    dc[2 * hw + i] = acc2;
    dv[i] = acc_v;
}

dim3 grid_for(int H, int W, dim3 block) {
    return dim3((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
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

// w_out and n_out null: inference; both set: store mode (K1 for training).
extern "C" int rdt_atrous_level(const float* color, const float* var,
                                const float* normal, const float* depth,
                                const float* zgrad, float* color_out,
                                float* var_out, void* w_out, float* n_out,
                                const AtrousParams* params, void* stream) {
    dim3 block(32, 8);
    atrous_level_kernel<<<grid_for(params->H, params->W, block), block, 0,
                          (cudaStream_t)stream>>>(
        color, var, normal, depth, zgrad, color_out, var_out,
        (__nv_bfloat16*)w_out, n_out, *params);
    return (int)cudaGetLastError();
}

extern "C" int rdt_atrous_bwd_stored(const void* w, const float* norm,
                                     const float* gc, const float* gv,
                                     float* dc, float* dv, int H, int W,
                                     int spacing, int radius, void* stream) {
    dim3 block(32, 8);
    atrous_bwd_stored_kernel<<<grid_for(H, W, block), block, 0,
                               (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)w, norm, gc, gv, dc, dv, H, W, spacing, radius);
    return (int)cudaGetLastError();
}
