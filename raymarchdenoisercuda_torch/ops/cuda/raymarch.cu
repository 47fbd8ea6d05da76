// K7 (primary march + G-buffer normals), K8 (shadow ray + shading +
// motion) and K13 (shadow-ray visibility alone) of the SDF raymarcher.
//
// K7 replaces raymarchdenoisercuda_tpu/ops/pallas/raymarch_tpu.py
// _make_march_kernel(emit_normals=True) (wrapper _march_call); its plain
// twin is march_gbuf in ops/raymarch.py.  K8 replaces
// _make_shadow_shade_kernel (wrapper _shade_call / shadow_shade_pallas);
// its plain twin is shadow_shade.  K13 replaces _make_shadow_kernel (wrapper
// shadow_factor_pallas, raymarch_tpu.py:967); its plain twin is
// shadow_factor.  K8 and K13 run one shadow march (shadow_visibility), so
// the two loops cannot drift.  All follow their twins operation by
// operation (the library is built with --fmad=false: no contracted
// multiply-adds, and true division everywhere, which the motion
// reprojection needs at zero motion).
//
// The scene is the flat vector of flatten_scene: spheres (Ns x 4), boxes
// (Nb x 6), planes (Np x 4), then the material ids of spheres, boxes and
// planes as floats.  Each block stages it in shared memory.
//
// One thread per pixel, each marching with its own early exit: a ray that
// stops never moves again, so stopping the loop gives the result of the
// lock-step loop, and the TPU kernel's per-band while-loop and tile padding
// have no counterpart.  Bound on the card: SDF evaluations (~10 flops per
// primitive and step); warps diverge where neighbouring rays need different
// step counts, which 16x8 blocks keep local.

#include <cuda_runtime.h>
#include <math.h>

// Launch parameters, passed by pointer from ops/raymarch_cuda.py (ctypes).
struct MarchParams {
    int H, W, n_sph, n_box, n_pl, max_steps;
    float max_dist, hit_eps, hit_eps4, normal_eps, relax_omega;
};

struct ShadeParams {
    int H, W, n_sph, n_box, n_pl, shadow_steps, has_prev, cam_w, cam_h;
    float hit_eps, relax_omega;
};

namespace {

constexpr float kMinStep = 0.01f;
constexpr float kPi = 3.141592653589793f;

struct Sdf {
    const float* sc;
    int n_sph, n_box, n_pl;

    // Distance to the nearest primitive; *mat gets its material id (first
    // primitive on ties, in the order spheres, boxes, planes).
    __device__ float operator()(float px, float py, float pz, int* mat) const {
        const int ob = 4 * n_sph, op = ob + 6 * n_box, om = op + 4 * n_pl;
        float d = INFINITY;
        int m = 0;
        for (int k = 0; k < n_sph; ++k) {
            const float* s = sc + 4 * k;
            float dx = px - s[0], dy = py - s[1], dz = pz - s[2];
            float di = sqrtf(dx * dx + dy * dy + dz * dz) - s[3];
            if (di < d) { d = di; m = (int)sc[om + k]; }
        }
        for (int k = 0; k < n_box; ++k) {
            const float* b = sc + ob + 6 * k;
            float qx = fabsf(px - b[0]) - b[3];
            float qy = fabsf(py - b[1]) - b[4];
            float qz = fabsf(pz - b[2]) - b[5];
            float ox = fmaxf(qx, 0.0f), oy = fmaxf(qy, 0.0f), oz = fmaxf(qz, 0.0f);
            float di = sqrtf(ox * ox + oy * oy + oz * oz)
                + fminf(fmaxf(qx, fmaxf(qy, qz)), 0.0f);
            if (di < d) { d = di; m = (int)sc[om + n_sph + k]; }
        }
        for (int k = 0; k < n_pl; ++k) {
            const float* pl = sc + op + 4 * k;
            float di = pl[0] * px + pl[1] * py + pl[2] * pz + pl[3];
            if (di < d) { d = di; m = (int)sc[om + n_sph + n_box + k]; }
        }
        if (mat) *mat = m;
        return d;
    }

    __device__ float operator()(float px, float py, float pz) const {
        return (*this)(px, py, pz, nullptr);
    }
};

struct ShadowRay {
    float ox, oy, oz;  // origin p + 0.02 n
    float dx, dy, dz;  // unit direction toward the light sample
    float dist;        // distance to the light sample
};

__device__ ShadowRay shadow_ray(float px, float py, float pz, float nx,
                                float ny, float nz, float lx, float ly,
                                float lz) {
    ShadowRay r;
    r.ox = px + 0.02f * nx;
    r.oy = py + 0.02f * ny;
    r.oz = pz + 0.02f * nz;
    const float tlx = lx - r.ox, tly = ly - r.oy, tlz = lz - r.oz;
    r.dist = sqrtf(tlx * tlx + tly * tly + tlz * tlz);
    const float dl = fmaxf(r.dist, 1e-8f);
    r.dx = tlx / dl;
    r.dy = tly / dl;
    r.dz = tlz / dl;
    return r;
}

// The shadow march of K8 and K13 (the rule of _shadow_march in
// ops/raymarch.py): minimum step 0.01, the relaxed branch for omega > 1;
// returns the visibility t >= dist - 0.03 as 0 or 1.
__device__ float shadow_visibility(const Sdf& sdf, const ShadowRay& r,
                                   int steps, float hit_eps, float omega) {
    float t = 0.0f;
    if (omega <= 1.0f) {
        for (int s = 0; s < steps; ++s) {
            float d = sdf(r.ox + t * r.dx, r.oy + t * r.dy, r.oz + t * r.dz);
            if (!(d > hit_eps && t < r.dist - 0.02f)) break;
            t = t + fmaxf(d, kMinStep);
        }
    } else {
        float d_prev = 0.0f, step_prev = 0.0f;
        for (int s = 0; s < steps; ++s) {
            float d = sdf(r.ox + t * r.dx, r.oy + t * r.dy, r.oz + t * r.dz);
            float cons = fmaxf(d_prev, kMinStep);
            bool fail = (d + d_prev) < step_prev && step_prev > cons;
            bool active = d > hit_eps && t < r.dist - 0.02f && !fail;
            if (!active && !fail) break;
            float step = fmaxf(omega * d, kMinStep);
            float delta = fail ? cons - step_prev : step;
            float new_step = fail ? cons : step;
            if (active) d_prev = d;
            step_prev = new_step;
            t = t + delta;
        }
    }
    return t >= r.dist - 0.03f ? 1.0f : 0.0f;
}

// Copies the scene vector into shared memory; every thread of the block
// must call it (it synchronises).
__device__ const float* stage_scene(const float* scene, int n, float* smem) {
    for (int k = threadIdx.y * blockDim.x + threadIdx.x; k < n;
         k += blockDim.x * blockDim.y) {
        smem[k] = scene[k];
    }
    __syncthreads();
    return smem;
}

__global__ void march_kernel(const float* __restrict__ scene,
                             const float* __restrict__ ro,
                             const float* __restrict__ rd,
                             float* __restrict__ t_out,
                             bool* __restrict__ hit_out,
                             int* __restrict__ mat_out,
                             float* __restrict__ n_out,
                             MarchParams p) {
    extern __shared__ float smem[];
    const int n_sc = 5 * p.n_sph + 7 * p.n_box + 5 * p.n_pl;
    const Sdf sdf{stage_scene(scene, n_sc, smem), p.n_sph, p.n_box, p.n_pl};
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.W || y >= p.H) return;
    const int hw = p.H * p.W, i = y * p.W + x;
    const float rox = ro[i], roy = ro[hw + i], roz = ro[2 * hw + i];
    const float rdx = rd[i], rdy = rd[hw + i], rdz = rd[2 * hw + i];

    float t = 0.0f;
    if (p.relax_omega <= 1.0f) {
        for (int s = 0; s < p.max_steps; ++s) {
            float d = sdf(rox + t * rdx, roy + t * rdy, roz + t * rdz);
            if (!(d > p.hit_eps && t < p.max_dist)) break;
            t = t + d;
        }
    } else {
        // over-relaxed march with rollback (the rule of _raymarch_loop)
        const float om = p.relax_omega;
        float d_prev = 0.0f, step_prev = 0.0f;
        for (int s = 0; s < p.max_steps; ++s) {
            float d = sdf(rox + t * rdx, roy + t * rdy, roz + t * rdz);
            bool fail = (d + d_prev) < step_prev && step_prev > d_prev;
            bool active = d > p.hit_eps && t < p.max_dist && !fail;
            if (!active && !fail) break;
            float delta = fail ? d_prev - step_prev : om * d;
            float new_step = fail ? d_prev : om * d;
            if (active) d_prev = d;
            step_prev = new_step;
            t = t + delta;
        }
    }
    const float px = rox + t * rdx, py = roy + t * rdy, pz = roz + t * rdz;
    int mat;
    const float d_final = sdf(px, py, pz, &mat);
    t_out[i] = t;
    hit_out[i] = d_final <= p.hit_eps4 && t < p.max_dist;
    mat_out[i] = mat;

    // central-difference normal, normalised, flipped toward the viewer
    const float e = p.normal_eps;
    float nx = sdf(px + e, py, pz) - sdf(px - e, py, pz);
    float ny = sdf(px, py + e, pz) - sdf(px, py - e, pz);
    float nz = sdf(px, py, pz + e) - sdf(px, py, pz - e);
    const float nn = fmaxf(sqrtf(nx * nx + ny * ny + nz * nz), 1e-8f);
    nx = nx / nn;
    ny = ny / nn;
    nz = nz / nn;
    if (nx * rdx + ny * rdy + nz * rdz > 0.0f) {
        nx = -nx;
        ny = -ny;
        nz = -nz;
    }
    n_out[i] = nx;
    n_out[hw + i] = ny;
    n_out[2 * hw + i] = nz;
}

// light: normal (3), radiance (3), area; prev: position, fwd, right, up
// (3 each), half_w, half_h of the previous camera
__global__ void shade_kernel(const float* __restrict__ scene,
                             const float* __restrict__ pos,
                             const float* __restrict__ nrm,
                             const float* __restrict__ light_p,
                             const float* __restrict__ albedo,
                             const float* __restrict__ emission,
                             const bool* __restrict__ hit,
                             const float* __restrict__ light,
                             const float* __restrict__ prev,
                             float* __restrict__ render,
                             float* __restrict__ vis_out,
                             float* __restrict__ motion,
                             ShadeParams p) {
    extern __shared__ float smem[];
    const int n_sc = 5 * p.n_sph + 7 * p.n_box + 5 * p.n_pl;
    const Sdf sdf{stage_scene(scene, n_sc, smem), p.n_sph, p.n_box, p.n_pl};
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.W || y >= p.H) return;
    const int hw = p.H * p.W, i = y * p.W + x;
    const float px = pos[i], py = pos[hw + i], pz = pos[2 * hw + i];
    const float nx = nrm[i], ny = nrm[hw + i], nz = nrm[2 * hw + i];
    const float lx = light_p[i], ly = light_p[hw + i], lz = light_p[2 * hw + i];
    const bool is_hit = hit[i];

    // shadow ray from p + 0.02 n toward the light sample; miss pixels get
    // dist_l = 0, so their march stops at once
    ShadowRay ray = shadow_ray(px, py, pz, nx, ny, nz, lx, ly, lz);
    if (!is_hit) ray.dist = 0.0f;
    const float vis = shadow_visibility(sdf, ray, p.shadow_steps, p.hit_eps,
                                        p.relax_omega);

    // direct light from p itself
    const float sx = lx - px, sy = ly - py, sz = lz - pz;
    const float dist2 = sx * sx + sy * sy + sz * sz;
    const float sn = fmaxf(sqrtf(dist2), 1e-8f);
    const float sdx = sx / sn, sdy = sy / sn, sdz = sz / sn;
    const float cos_s = fmaxf(nx * sdx + ny * sdy + nz * sdz, 0.0f);
    const float cos_l = fabsf(light[0] * sdx + light[1] * sdy + light[2] * sdz);
    const float geom = cos_s * cos_l * light[6] / fmaxf(dist2, 1e-4f);
    const float shade = vis * geom;
    for (int k = 0; k < 3; ++k) {
        const float irr = light[3 + k] * shade;
        render[k * hw + i] = albedo[k * hw + i] * (irr / kPi + 0.08f)
            + emission[k * hw + i];
    }
    vis_out[i] = vis;

    if (p.has_prev) {
        const float rx = px - prev[0], ry = py - prev[1], rz = pz - prev[2];
        const float zc = fmaxf(prev[3] * rx + prev[4] * ry + prev[5] * rz, 1e-6f);
        // true division (see the header)
        const float xc = (prev[6] * rx + prev[7] * ry + prev[8] * rz) / zc;
        const float yc = (prev[9] * rx + prev[10] * ry + prev[11] * rz) / zc;
        const float ppx = (xc / prev[12] * 0.5f + 0.5f) * (float)p.cam_w - 0.5f;
        const float ppy = (0.5f - yc / prev[13] * 0.5f) * (float)p.cam_h - 0.5f;
        const float hit_f = is_hit ? 1.0f : 0.0f;
        motion[i] = (ppy - (float)y) * hit_f;
        motion[hw + i] = (ppx - (float)x) * hit_f;
    }
}

// K13: the shadow-ray visibility alone, for the spp > 1 render (one launch
// per light sample).  Every pixel is marched, misses included.
__global__ void shadow_kernel(const float* __restrict__ scene,
                              const float* __restrict__ pos,
                              const float* __restrict__ nrm,
                              const float* __restrict__ light_p,
                              float* __restrict__ vis_out, ShadeParams p) {
    extern __shared__ float smem[];
    const int n_sc = 5 * p.n_sph + 7 * p.n_box + 5 * p.n_pl;
    const Sdf sdf{stage_scene(scene, n_sc, smem), p.n_sph, p.n_box, p.n_pl};
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.W || y >= p.H) return;
    const int hw = p.H * p.W, i = y * p.W + x;
    const ShadowRay ray = shadow_ray(
        pos[i], pos[hw + i], pos[2 * hw + i], nrm[i], nrm[hw + i],
        nrm[2 * hw + i], light_p[i], light_p[hw + i], light_p[2 * hw + i]);
    vis_out[i] = shadow_visibility(sdf, ray, p.shadow_steps, p.hit_eps,
                                   p.relax_omega);
}

dim3 grid_for(int H, int W, dim3 block) {
    return dim3((W + block.x - 1) / block.x, (H + block.y - 1) / block.y);
}

}  // namespace

extern "C" int rdt_march(const float* scene, const float* ro, const float* rd,
                         float* t, bool* hit, int* mat, float* normal,
                         const MarchParams* params, void* stream) {
    dim3 block(16, 8);
    size_t smem = sizeof(float)
        * (5 * params->n_sph + 7 * params->n_box + 5 * params->n_pl);
    march_kernel<<<grid_for(params->H, params->W, block), block, smem,
                   (cudaStream_t)stream>>>(scene, ro, rd, t, hit, mat, normal,
                                           *params);
    return (int)cudaGetLastError();
}

extern "C" int rdt_shadow_shade(const float* scene, const float* pos,
                                const float* normal, const float* light_p,
                                const float* albedo, const float* emission,
                                const bool* hit, const float* light,
                                const float* prev, float* render, float* vis,
                                float* motion, const ShadeParams* params,
                                void* stream) {
    dim3 block(16, 8);
    size_t smem = sizeof(float)
        * (5 * params->n_sph + 7 * params->n_box + 5 * params->n_pl);
    shade_kernel<<<grid_for(params->H, params->W, block), block, smem,
                   (cudaStream_t)stream>>>(scene, pos, normal, light_p, albedo,
                                           emission, hit, light, prev, render,
                                           vis, motion, *params);
    return (int)cudaGetLastError();
}

extern "C" int rdt_shadow(const float* scene, const float* pos,
                          const float* normal, const float* light_p,
                          float* vis, const ShadeParams* params,
                          void* stream) {
    dim3 block(16, 8);
    size_t smem = sizeof(float)
        * (5 * params->n_sph + 7 * params->n_box + 5 * params->n_pl);
    shadow_kernel<<<grid_for(params->H, params->W, block), block, smem,
                    (cudaStream_t)stream>>>(scene, pos, normal, light_p, vis,
                                            *params);
    return (int)cudaGetLastError();
}
