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
// K8's SDF is specialised on the scene's primitive counts (FixedSdf<NS,
// NB, NP>): its loops unroll, and each primitive's parameters are
// constant-bank operands at offsets fixed at compile time (c_scene, which
// the launch fills from the scene vector, device to device, on its
// stream): no load and no register a parameter.  The runtime-count SDF
// (Sdf) reads every parameter from shared memory at each evaluation, 42
// loads on the Cornell box, with the loops' own overhead.  Holding the
// Cornell box's 42 floats in registers instead took 88 registers a thread
// (42 with the constant bank) and ran 0.31 against 0.27 ms at 1080p;
// random_scene's 260 floats read from shared memory at fixed offsets
// were hoisted into registers and spilled (255 registers, 4.9 ms against
// 2.6).  K8 is compiled for the Cornell box (1, 3, 5), the scene of every
// main path, and random_scene's default (24, 24, 5); any other scene runs
// the runtime-count instantiation of the same kernel (shade_kernel<-1,
// -1, -1>).  The wrapper picks the instantiation from the scene's counts
// (raymarch_cuda.SHADE_SCENES names the same triples).  Both SDFs take
// the minimum in the same order (spheres, boxes, planes; the first
// primitive on ties) with the same operations, so the instantiations give
// the same floats.  K7, K13 and K15 keep the runtime-count SDF.  A shadow
// march's warps diverge (a random light sample a pixel: the rays of a
// warp are not coherent; on a 1080p Cornell frame 15.1 steps a pixel, 18.9
// for a 16 x 2 warp's longest lane, 0.80 of the SIMD lanes busy).
// Persistent warps that refill their stopped lanes from the block's tile
// once half of them stopped (shading those together) ran 1.5-1.7x slower
// on the Cornell box, and were dropped.
//
// One thread per pixel, each marching with its own early exit: a ray that
// stops never moves again, so stopping the loop gives the result of the
// lock-step loop, and the TPU kernel's per-band while-loop and tile padding
// have no counterpart.  Bound on the card: SDF evaluations (~10 flops per
// primitive and step); warps diverge where neighbouring rays need different
// step counts, which 16x8 blocks keep local.
//
// The cone pre-march seed (RaymarchParams.coarse_seed).  K15, cone_kernel,
// replaces _make_cone_kernel (wrappers _cone_seed_coarse and
// _cone_seed_coarse_analytic, raymarch_tpu.py:214-393); its plain twin is
// cone_march in ops/raymarch.py.  One thread a coarse cell (a 4x4 pixel
// block) sphere-traces the block's cone against the fattened distance
// margin = d - (hit_eps + base) - t * delta in steps of margin / (1 + delta),
// so that sdf >= hit_eps + base + s * delta along the marched segment and
// the stop is a skip-free start for every ray of the block.  delta and
// base are global maxima that PyTorch reduces on the device; as on the TPU
// they ride after the scene scalars in the flat scene vector, so the host
// never reads them.  Bound: its SDF evaluations (1/16 of the pixels).
// The seeded K7 (_make_march_kernel(seeded=True)) is march_kernel given the
// coarse grid of stops: each pixel starts at its own block's stop.  The TPU
// kernel takes the minimum over each 32x256 band because a tile reads one
// SMEM scalar; a thread here reads its own block's.  A null seed is the
// unseeded launch (t = 0).

#include <cuda_runtime.h>
#include <math.h>

// Launch parameters, passed by pointer from ops/raymarch_cuda.py (ctypes).
struct MarchParams {
    int H, W, n_sph, n_box, n_pl, max_steps;
    float max_dist, hit_eps, hit_eps4, normal_eps, relax_omega;
};

struct ShadeParams {
    int H, W, n_sph, n_box, n_pl, shadow_steps, has_prev, cam_w, cam_h;
    // global pixel of the window's (0, 0): the motion is taken against the
    // pixel's coordinates in the whole frame
    int row0, col0;
    float hit_eps, relax_omega;
};

namespace {

constexpr float kMinStep = 0.01f;
constexpr int kSeedBlock = 4;    // pixels a coarse cell's side (SEED_BLOCK)
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

// K8's compiled scene: the primitives' parameters (spheres, boxes,
// planes, as in the flat scene vector) of the largest scene K8 is compiled
// for, random_scene's default (24, 24, 5).  launch_shade copies them from
// the device's scene vector before each launch (device to device, on the
// launch's stream), so a kernel reads the scene its own launch was given;
// two launches on streams that run concurrently would share the buffer
// (the port launches every kernel on the current stream).
constexpr int kConstSceneFloats = 4 * 24 + 6 * 24 + 4 * 5;
__constant__ float c_scene[kConstSceneFloats];

// The scene SDF of NS spheres, NB boxes and NP planes, known at compile
// time (see the header): the loops unroll, and every parameter is a
// constant-bank operand at a fixed offset of c_scene (no load, no register
// held); distances only (the shadow march needs no material), each
// primitive as Sdf computes it.
template <int NS, int NB, int NP>
struct FixedSdf {
    static constexpr int kOb = 4 * NS, kOp = kOb + 6 * NB, kN = kOp + 4 * NP;
    static_assert(kN <= kConstSceneFloats, "scene larger than c_scene");

    __device__ __forceinline__ float operator()(float px, float py,
                                                float pz) const {
        // c_scene indexed by constants: constant-bank operands
        const float* c = c_scene;
        float d = INFINITY;
#pragma unroll
        for (int k = 0; k < NS; ++k) {
            const int o = 4 * k;
            float dx = px - c[o], dy = py - c[o + 1], dz = pz - c[o + 2];
            float di = sqrtf(dx * dx + dy * dy + dz * dz) - c[o + 3];
            if (di < d) d = di;
        }
#pragma unroll
        for (int k = 0; k < NB; ++k) {
            const int o = kOb + 6 * k;
            float qx = fabsf(px - c[o]) - c[o + 3];
            float qy = fabsf(py - c[o + 1]) - c[o + 4];
            float qz = fabsf(pz - c[o + 2]) - c[o + 5];
            float ox = fmaxf(qx, 0.0f), oy = fmaxf(qy, 0.0f), oz = fmaxf(qz, 0.0f);
            float di = sqrtf(ox * ox + oy * oy + oz * oz)
                + fminf(fmaxf(qx, fmaxf(qy, qz)), 0.0f);
            if (di < d) d = di;
        }
#pragma unroll
        for (int k = 0; k < NP; ++k) {
            const int o = kOp + 4 * k;
            float di = c[o] * px + c[o + 1] * py + c[o + 2] * pz + c[o + 3];
            if (di < d) d = di;
        }
        return d;
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
template <typename SDF>
__device__ float shadow_visibility(const SDF& sdf, const ShadowRay& r,
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
                             const float* __restrict__ seed,
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

    const int seed_w = (p.W + kSeedBlock - 1) / kSeedBlock;
    float t = seed ? seed[(y / kSeedBlock) * seed_w + x / kSeedBlock] : 0.0f;
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

// K15: the cone march of the coarse cells (see the header).  The scene
// vector carries delta and base after the primitives; p.H x p.W is the
// coarse grid.
__global__ void cone_kernel(const float* __restrict__ scene,
                            const float* __restrict__ ro,
                            const float* __restrict__ rd,
                            float* __restrict__ t_out, MarchParams p) {
    extern __shared__ float smem[];
    const int n_sc = 5 * p.n_sph + 7 * p.n_box + 5 * p.n_pl;
    const float* sc = stage_scene(scene, n_sc + 2, smem);
    const Sdf sdf{sc, p.n_sph, p.n_box, p.n_pl};
    int x = blockIdx.x * blockDim.x + threadIdx.x;
    int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.W || y >= p.H) return;
    const int hw = p.H * p.W, i = y * p.W + x;
    const float rox = ro[i], roy = ro[hw + i], roz = ro[2 * hw + i];
    const float rdx = rd[i], rdy = rd[hw + i], rdz = rd[2 * hw + i];
    const float delta = sc[n_sc];
    const float clear0 = p.hit_eps + sc[n_sc + 1];
    const float inv_g = 1.0f / (1.0f + delta);
    float t = 0.0f;
    for (int s = 0; s < p.max_steps; ++s) {
        const float d = sdf(rox + t * rdx, roy + t * rdy, roz + t * rdz);
        const float margin = d - clear0 - t * delta;
        if (!(margin > 0.0f && t < p.max_dist)) break;
        t = t + margin * inv_g;
    }
    t_out[i] = t;
}

// K8's SDF: FixedSdf (in c_scene), or (NS < 0) the runtime-count one on
// the scene staged in shared memory.
template <int NS, int NB, int NP>
struct ShadeSdf {
    __device__ static FixedSdf<NS, NB, NP> make(const float*, float*,
                                                const ShadeParams&) {
        return {};
    }
};
template <>
struct ShadeSdf<-1, -1, -1> {
    __device__ static Sdf make(const float* scene, float* smem,
                               const ShadeParams& p) {
        const int n_sc = 5 * p.n_sph + 7 * p.n_box + 5 * p.n_pl;
        return Sdf{stage_scene(scene, n_sc, smem), p.n_sph, p.n_box, p.n_pl};
    }
};

// light: normal (3), radiance (3), area; prev: position, fwd, right, up
// (3 each), half_w, half_h of the previous camera
template <int NS, int NB, int NP>
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
    const auto sdf = ShadeSdf<NS, NB, NP>::make(scene, smem, p);
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
        motion[i] = (ppy - (float)(p.row0 + y)) * hit_f;
        motion[hw + i] = (ppx - (float)(p.col0 + x)) * hit_f;
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

template <int NS, int NB, int NP>
cudaError_t launch_shade(const float* scene, const float* pos,
                         const float* normal, const float* light_p,
                         const float* albedo, const float* emission,
                         const bool* hit, const float* light,
                         const float* prev, float* render, float* vis,
                         float* motion, const ShadeParams& p,
                         cudaStream_t stream) {
    size_t smem = 0;
    if constexpr (NS >= 0) {
        // a compiled scene runs only the counts it was compiled for
        if (p.n_sph != NS || p.n_box != NB || p.n_pl != NP)
            return cudaErrorInvalidValue;
        cudaError_t err = cudaMemcpyToSymbolAsync(
            c_scene, scene, sizeof(float) * FixedSdf<NS, NB, NP>::kN, 0,
            cudaMemcpyDeviceToDevice, stream);
        if (err != cudaSuccess) return err;
    } else {
        smem = sizeof(float) * (5 * p.n_sph + 7 * p.n_box + 5 * p.n_pl);
    }
    dim3 block(16, 8);
    shade_kernel<NS, NB, NP><<<grid_for(p.H, p.W, block), block, smem,
                               stream>>>(scene, pos, normal, light_p, albedo,
                                         emission, hit, light, prev, render,
                                         vis, motion, p);
    return cudaGetLastError();
}

}  // namespace

// K7; seed null: every ray starts at 0, else at its block's cone stop
// (the (ceil(H/4), ceil(W/4)) grid of K15).
extern "C" int rdt_march(const float* scene, const float* ro, const float* rd,
                         const float* seed, float* t, bool* hit, int* mat,
                         float* normal, const MarchParams* params,
                         void* stream) {
    dim3 block(16, 8);
    size_t smem = sizeof(float)
        * (5 * params->n_sph + 7 * params->n_box + 5 * params->n_pl);
    march_kernel<<<grid_for(params->H, params->W, block), block, smem,
                   (cudaStream_t)stream>>>(scene, ro, rd, seed, t, hit, mat,
                                           normal, *params);
    return (int)cudaGetLastError();
}

// K15 over the coarse grid params->H x params->W; scene: the flat scene
// vector followed by delta and base.
extern "C" int rdt_cone_seed(const float* scene, const float* ro,
                             const float* rd, float* t,
                             const MarchParams* params, void* stream) {
    dim3 block(16, 8);
    size_t smem = sizeof(float)
        * (5 * params->n_sph + 7 * params->n_box + 5 * params->n_pl + 2);
    cone_kernel<<<grid_for(params->H, params->W, block), block, smem,
                  (cudaStream_t)stream>>>(scene, ro, rd, t, *params);
    return (int)cudaGetLastError();
}

// K8.  scene_key picks the instantiation: 0 the runtime counts, else the
// compiled scene of that key (raymarch_cuda.SHADE_SCENES, in this order).
extern "C" int rdt_shadow_shade(const float* scene, const float* pos,
                                const float* normal, const float* light_p,
                                const float* albedo, const float* emission,
                                const bool* hit, const float* light,
                                const float* prev, float* render, float* vis,
                                float* motion, const ShadeParams* params,
                                int scene_key, void* stream) {
#define RDT_SHADE(NS, NB, NP)                                              \
    launch_shade<NS, NB, NP>(scene, pos, normal, light_p, albedo, emission,\
                             hit, light, prev, render, vis, motion,        \
                             *params, (cudaStream_t)stream)
    switch (scene_key) {
    case 0: return (int)RDT_SHADE(-1, -1, -1);
    case 1: return (int)RDT_SHADE(1, 3, 5);
    case 2: return (int)RDT_SHADE(24, 24, 5);
    default: return (int)cudaErrorInvalidValue;
    }
#undef RDT_SHADE
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
