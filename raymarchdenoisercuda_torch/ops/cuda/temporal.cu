// K3: the fused inference temporal step of SVGF.
//
// Replaces the TPU kernel raymarchdenoisercuda_tpu/ops/pallas/temporal_tpu.py
// _make_kernel as called by temporal_accumulate_pallas.  Its plain twin is
// temporal_accumulate in ops/temporal.py; the arithmetic below follows that
// function operation by operation (built with --fmad=false; the one fused
// multiply-add, in the reprojection sum, is explicit on both sides).
//
// One thread per pixel:
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
// Bound on the card: memory (~20 floats read and 7 written per pixel); the
// 7x7 window only runs on pixels whose history is short.

#include <cuda_runtime.h>
#include <math.h>

// Launch parameters, passed by pointer from ops/temporal_cuda.py (ctypes).
struct TemporalParams {
    int H, W, max_motion, history_clamp, boost_frames;
    float alpha, alpha_m;
};

namespace {

constexpr float kL0 = 0.2126f, kL1 = 0.7152f, kL2 = 0.0722f;

__device__ __forceinline__ float luma_at(const float* c, int i, int hw) {
    return kL0 * c[i] + kL1 * c[hw + i] + kL2 * c[2 * hw + i];
}

// Column sum of the 7x7 window at column qx (zero outside the image), in the
// order of spatial_moments: rows 0, +1, -1, +2, -2, +3, -3.
__device__ __forceinline__ void column_sums(const float* c, int y, int qx,
                                            int H, int W, float* s1, float* s2) {
    *s1 = 0.0f;
    *s2 = 0.0f;
    if (qx < 0 || qx >= W) return;
    const int hw = H * W;
    float l = luma_at(c, y * W + qx, hw);
    float a1 = l, a2 = l * l;
    for (int d = 1; d <= 3; ++d) {
        float lp = 0.0f, lm = 0.0f;
        if (y + d < H) lp = luma_at(c, (y + d) * W + qx, hw);
        if (y - d >= 0) lm = luma_at(c, (y - d) * W + qx, hw);
        a1 = (a1 + lp) + lm;
        a2 = (a2 + lp * lp) + lm * lm;
    }
    *s1 = a1;
    *s2 = a2;
}

__global__ void temporal_kernel(const float* __restrict__ render,
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
                                TemporalParams p) {
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.W || y >= p.H) return;
    const int H = p.H, W = p.W, hw = H * W;
    const int i = y * W + x;

    const float m0 = motion[i], m1 = motion[hw + i];
    const float ys = (float)y + m0, xs = (float)x + m1;
    const bool within = fabsf(m0) <= (float)p.max_motion
        && fabsf(m1) <= (float)p.max_motion;
    const bool in_bounds = ys >= 0.0f && ys <= (float)(H - 1)
        && xs >= 0.0f && xs <= (float)(W - 1) && within;

    // 1. reprojection: history planes in the order colour, moments, length,
    //    previous depth, previous normal
    const float* planes[10] = {h_color, h_color + hw, h_color + 2 * hw,
                               h_moments, h_moments + hw, h_length, h_depth,
                               h_normal, h_normal + hw, h_normal + 2 * hw};
    float g[10];
#pragma unroll
    for (int k = 0; k < 10; ++k) g[k] = 0.0f;
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
                // explicit fused multiply-adds, as the plain version rounds
#pragma unroll
                for (int k = 0; k < 10; ++k) {
                    g[k] = __fmaf_rn(w, inside ? planes[k][q] : 0.0f, g[k]);
                }
            }
        }
    }
    const float pc[3] = {g[0], g[1], g[2]};
    const float pm0 = g[3], pm1 = g[4], plen = g[5], pdepth = g[6];

    // 2. validity
    const float z = depth[i];
    const float n0 = normal[i], n1 = normal[hw + i], n2 = normal[2 * hw + i];
    const bool depth_ok = fabsf(pdepth - z) <= 0.1f * fmaxf(fabsf(z), 1e-3f);
    const float ndot = g[7] * n0 + g[8] * n1 + g[9] * n2;
    const bool valid = in_bounds && depth_ok && ndot > 0.8f && plen > 0.0f;

    // 3. clamp + blend
    const float c[3] = {render[i], render[hw + i], render[2 * hw + i]};
    float prev[3] = {pc[0], pc[1], pc[2]};
    if (p.history_clamp) {
        for (int k = 0; k < 3; ++k) {
            float lo = INFINITY, hi = -INFINITY;
            for (int dy = -1; dy <= 1; ++dy) {
                int qy = y + dy;
                if (qy < 0 || qy >= H) continue;
                for (int dx = -1; dx <= 1; ++dx) {
                    int qx = x + dx;
                    if (qx < 0 || qx >= W) continue;
                    float v = render[k * hw + qy * W + qx];
                    lo = fminf(lo, v);
                    hi = fmaxf(hi, v);
                }
            }
            prev[k] = fminf(fmaxf(prev[k], lo), hi);
        }
    }
    const float n_new = (valid ? plen : 0.0f) + 1.0f;
    const float alpha = fmaxf(1.0f / n_new, p.alpha);
    const float alpha_m = fmaxf(1.0f / n_new, p.alpha_m);
    for (int k = 0; k < 3; ++k) {
        out_integ[k * hw + i] = valid
            ? (1.0f - alpha) * prev[k] + alpha * c[k] : c[k];
    }

    // 4. moments and variance
    const float lum = kL0 * c[0] + kL1 * c[1] + kL2 * c[2];
    const float lum2 = lum * lum;
    const float mom0 = valid ? (1.0f - alpha_m) * pm0 + alpha_m * lum : lum;
    const float mom1 = valid ? (1.0f - alpha_m) * pm1 + alpha_m * lum2 : lum2;
    float variance = fmaxf(mom1 - mom0 * mom0, 0.0f);
    if (p.boost_frames > 0 && n_new < (float)p.boost_frames) {
        float s1, s2, a, b;
        column_sums(render, y, x, H, W, &s1, &s2);
        for (int d = 1; d <= 3; ++d) {
            column_sums(render, y, x + d, H, W, &a, &b);
            s1 = s1 + a;
            s2 = s2 + b;
            column_sums(render, y, x - d, H, W, &a, &b);
            s1 = s1 + a;
            s2 = s2 + b;
        }
        const float fy = (float)y, fx = (float)x;
        const float cy = fminf(fy, 3.0f) + fminf((float)(H - 1) - fy, 3.0f) + 1.0f;
        const float cx = fminf(fx, 3.0f) + fminf((float)(W - 1) - fx, 3.0f) + 1.0f;
        const float inv_cnt = 1.0f / (cy * cx);
        const float sm1 = s1 * inv_cnt, sm2 = s2 * inv_cnt;
        variance = fmaxf(sm2 - sm1 * sm1, 0.0f);
    }
    out_var[i] = variance;
    out_moments[i] = mom0;
    out_moments[hw + i] = mom1;
    out_length[i] = n_new;
}

}  // namespace

extern "C" int rdt_temporal(const float* render, const float* motion,
                            const float* depth, const float* normal,
                            const float* h_color, const float* h_moments,
                            const float* h_length, const float* h_depth,
                            const float* h_normal, float* out_integ,
                            float* out_var, float* out_moments,
                            float* out_length, const TemporalParams* params,
                            void* stream) {
    dim3 block(32, 8);
    dim3 grid((params->W + block.x - 1) / block.x,
              (params->H + block.y - 1) / block.y);
    temporal_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        render, motion, depth, normal, h_color, h_moments, h_length, h_depth,
        h_normal, out_integ, out_var, out_moments, out_length, *params);
    return (int)cudaGetLastError();
}
