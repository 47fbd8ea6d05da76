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
// planes as floats.  A runtime-count instantiation stages it in shared
// memory; a compiled one reads it from the constant bank (below).
//
// K7's, K8's and K13's SDF is specialised on the scene's primitive counts
// (FixedSdf<NS, NB, NP>): its loops unroll, and each primitive's
// parameters and material id are constant-bank operands at offsets fixed
// at compile time (c_scene, which the launch fills from the scene vector,
// device to device, on its stream): no load and no register a parameter.
// The runtime-count SDF (Sdf) reads every parameter from shared memory at
// each evaluation, 42 loads on the Cornell box, with the loops' own
// overhead.  Holding the Cornell box's 42 floats in registers instead took
// 88 registers a thread in K8 (42 with the constant bank) and ran 0.31
// against 0.27 ms at 1080p; random_scene's 260 floats read from shared
// memory at fixed offsets were hoisted into registers and spilled (255
// registers, 4.9 ms against 2.6).  K7, K8 and K13 are compiled for the
// Cornell box (1, 3, 5), the scene of every main path, and random_scene's
// default (24, 24, 5); any other scene runs the runtime-count
// instantiation of the same kernel (march_kernel / shade_kernel /
// shadow_kernel<-1, -1, -1>).  The wrapper picks the instantiation from
// the scene's counts (raymarch_cuda.SHADE_SCENES names the same triples).
// Both SDFs take the minimum in the same order (spheres, boxes, planes;
// the first primitive on ties) with the same operations, and convert the
// winner's id with (int), so the instantiations give the same floats and
// ids.  K7 runs ~22 SDF evaluations a pixel on the Cornell box (15.1 march
// steps, the material, six for the normal) with 0.95 of its lanes busy:
// it is held by the SDF's instructions, not by divergence; K13 on the
// compiled Cornell box took 0.68x its runtime-count time (0.25 against
// 0.36 ms at 1080p), K15 0.64x (54 against 85 us from the camera).  A
// shadow march's warps diverge (a random light sample a pixel: the rays
// of a warp are not coherent; on a 1080p Cornell frame 15.1 steps a
// pixel, 18.9 for a 16 x 2 warp's longest lane, 0.80 of the SIMD lanes
// busy).  Persistent
// warps that refill their stopped lanes from the block's tile once half
// of them stopped (shading those together) ran 1.5-1.7x slower on the
// Cornell box, and were dropped.
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
// base are global maxima, read from the device (the host never reads
// them).  K15 is compiled per scene as K7, K8 and K13 are (FixedSdf
// through launch_scene; Sdf for other counts).  From ray planes, PyTorch
// builds the cones and reduces delta and base (cone_rays).  From the
// camera (the route of every seeded path), K15 builds its cones itself:
// a first launch (cone_delta_kernel) computes each block's centre ray and
// its four corner rays, as camera_basis and rays_at_pixels compute them
// operation by operation, and takes the GLOBAL maximum of the squared
// corner deviations by atomicMax on their bit patterns (non-negative
// floats order as their bits: the maximum is exact in any order) into a
// scratch from PyTorch's allocator; the march launch recomputes its
// centre ray and takes delta = sqrt(max), base = 0 from that scratch.
// The pass is then a memset and two launches, where ~40 small PyTorch ops
// of glue held it on the host.  Bound: the SDF evaluations (1/16 of the
// pixels).
// The seeded K7 (_make_march_kernel(seeded=True)) is march_kernel given the
// coarse grid of stops: each pixel starts at its own block's stop.  The TPU
// kernel takes the minimum over each 32x256 band because a tile reads one
// SMEM scalar; a thread here reads its own block's.  A null seed is the
// unseeded launch (t = 0).

#include <cuda_runtime.h>
#include <math.h>

#include <mutex>

// Launch parameters, passed by pointer from ops/raymarch_cuda.py (ctypes).
struct MarchParams {
    int H, W, n_sph, n_box, n_pl, max_steps;
    float max_dist, hit_eps, hit_eps4, normal_eps, relax_omega;
};

// K15 from the camera (rdt_cone_seed_camera): the camera's frame, its
// vertical field of view and the window, passed by pointer from
// ops/raymarch_cuda.py; the coarse grid is MarchParams' H x W (MarchParams
// stays the struct K7 takes).
struct ConeCamera {
    int cam_h, cam_w;    // the camera's frame
    int row0, col0;      // GLOBAL pixel of the window's (0, 0)
    float half_fov;      // fov_y / 2 as float32 (what torch.full stores)
    float aspect;        // cam_w / cam_h rounded once to float32
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

// The compiled scene of K7, K8 and K13: the flat scene vector (parameters
// of spheres, boxes, planes, then their material ids) of the largest scene
// they are compiled for, random_scene's default (24, 24, 5).  launch_scene
// copies it from the device's scene vector before each launch (device to
// device, on the launch's stream), so a kernel reads the scene its own
// launch was given.  One buffer serves every stream of the device, so
// launch_scene orders the launches that read it across streams (below).
constexpr int kConstSceneFloats = 5 * 24 + 7 * 24 + 5 * 5;
__constant__ float c_scene[kConstSceneFloats];

// The scene SDF of NS spheres, NB boxes and NP planes, known at compile
// time (see the header): the loops unroll, and every parameter and id is
// a constant-bank operand at a fixed offset of c_scene (no load, no
// register held); each primitive as Sdf computes it.  The material form
// keeps the improving primitive's id as the float it is stored as and
// converts the winner's once, which gives Sdf's int.
template <int NS, int NB, int NP>
struct FixedSdf {
    static constexpr int kOb = 4 * NS, kOp = kOb + 6 * NB, kN = kOp + 4 * NP;
    static constexpr int kAll = kN + NS + NB + NP;    // the ids after kN
    static_assert(kAll <= kConstSceneFloats, "scene larger than c_scene");

    template <bool MAT>
    __device__ __forceinline__ float eval(float px, float py, float pz,
                                          float& m) const {
        // c_scene indexed by constants: constant-bank operands
        const float* c = c_scene;
        float d = INFINITY;
#pragma unroll
        for (int k = 0; k < NS; ++k) {
            const int o = 4 * k;
            float dx = px - c[o], dy = py - c[o + 1], dz = pz - c[o + 2];
            float di = sqrtf(dx * dx + dy * dy + dz * dz) - c[o + 3];
            if (di < d) {
                d = di;
                if (MAT) m = c[kN + k];
            }
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
            if (di < d) {
                d = di;
                if (MAT) m = c[kN + NS + k];
            }
        }
#pragma unroll
        for (int k = 0; k < NP; ++k) {
            const int o = kOp + 4 * k;
            float di = c[o] * px + c[o + 1] * py + c[o + 2] * pz + c[o + 3];
            if (di < d) {
                d = di;
                if (MAT) m = c[kN + NS + NB + k];
            }
        }
        return d;
    }

    __device__ __forceinline__ float operator()(float px, float py,
                                                float pz) const {
        float m;
        return eval<false>(px, py, pz, m);
    }

    // distance; *mat gets the nearest primitive's material id
    __device__ __forceinline__ float operator()(float px, float py, float pz,
                                                int* mat) const {
        float m = 0.0f;
        const float d = eval<true>(px, py, pz, m);
        *mat = (int)m;
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

// The SDF of K7, K8 and K13: FixedSdf (the scene in c_scene), or (NS < 0) the
// runtime-count one on the scene staged in shared memory (every thread of
// the block must call make: it synchronises).
template <int NS, int NB, int NP>
struct SceneSdf {
    __device__ static FixedSdf<NS, NB, NP> make(const float*, float*, int,
                                                int, int) {
        return {};
    }
};
template <>
struct SceneSdf<-1, -1, -1> {
    __device__ static Sdf make(const float* scene, float* smem, int n_sph,
                               int n_box, int n_pl) {
        const int n_sc = 5 * n_sph + 7 * n_box + 5 * n_pl;
        return Sdf{stage_scene(scene, n_sc, smem), n_sph, n_box, n_pl};
    }
};

// K7's normal evaluates the SDF six times.  Unrolled, a compiled scene of
// up to this many primitives keeps them in flight together (the Cornell
// box's 9: 72 registers, 0.294 against 0.315 ms one at a time on the H100
// at 1080p); a larger scene (random_scene's 53 took 255 registers and
// spilled: 6.9 against 2.9 ms) and the runtime-count loops (0.84 against
// 0.78 ms) evaluate them one at a time.
constexpr int kUnrollNormalMax = 16;

// K7 on the compiled scene <NS, NB, NP> or (-1) any counts.
template <int NS, int NB, int NP>
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
    const auto sdf =
        SceneSdf<NS, NB, NP>::make(scene, smem, p.n_sph, p.n_box, p.n_pl);
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
    float nx, ny, nz;
    if constexpr (NS >= 0 && NS + NB + NP <= kUnrollNormalMax) {
        nx = sdf(px + e, py, pz) - sdf(px - e, py, pz);
        ny = sdf(px, py + e, pz) - sdf(px, py - e, pz);
        nz = sdf(px, py, pz + e) - sdf(px, py, pz - e);
    } else {
        // the six evaluations one at a time (px + (-e) is px - e)
        float d_plus = 0.0f;
#pragma unroll 1
        for (int k = 0; k < 6; ++k) {
            const int a = k >> 1;
            const float o = (k & 1) ? -e : e;
            const float d = sdf(a == 0 ? px + o : px, a == 1 ? py + o : py,
                                a == 2 ? pz + o : pz);
            if (!(k & 1)) {
                d_plus = d;
                continue;
            }
            const float g = d_plus - d;
            if (a == 0) nx = g;
            else if (a == 1) ny = g;
            else nz = g;
        }
    }
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

// K15's cones: from ray planes (ro, rd and the device scalars delta and
// base, which PyTorch reduced), or from the camera (its three vectors on
// the device, the configuration, and the scratch [max squared deviation,
// delta, base] that cone_delta_kernel fills; base stays the memset's 0).
struct ConeArgs {
    const float* ro;
    const float* rd;
    const float* delta;
    const float* base;
    const float* position;
    const float* look_at;
    const float* up;
    float* scratch;
    ConeCamera cam;
};

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
    // _normalize: the norm in the order x, y, z, clamped, true division
    const float n = fmaxf(sqrtf(x * x + y * y + z * z), 1e-8f);
    x = x / n;
    y = y / n;
    z = z / n;
}

// The camera of camera_basis and rays_at_pixels (ops/raymarch.py), each
// PyTorch op one rounding here (--fmad=false keeps every product and sum
// apart).  (rows + 0.5) / H is a division by a Python int, which PyTorch
// on the card does as a multiply by the float reciprocal 1 / H; the
// basis's divisions are by tensors, true divisions.
struct ConeRays {
    float fx, fy, fz, rx, ry, rz, ux, uy, uz;
    float half_w, half_h, inv_h, inv_w;

    __device__ explicit ConeRays(const ConeArgs& a) {
        const float* o = a.position;
        const float* l = a.look_at;
        const float* u = a.up;
        fx = l[0] - o[0];
        fy = l[1] - o[1];
        fz = l[2] - o[2];
        normalize3(fx, fy, fz);
        // right = normalize(up x fwd), up' = fwd x right (_cross)
        rx = u[1] * fz - u[2] * fy;
        ry = u[2] * fx - u[0] * fz;
        rz = u[0] * fy - u[1] * fx;
        normalize3(rx, ry, rz);
        ux = fy * rz - fz * ry;
        uy = fz * rx - fx * rz;
        uz = fx * ry - fy * rx;
        half_h = tanf(a.cam.half_fov);
        half_w = half_h * a.cam.aspect;
        inv_h = 1.0f / (float)a.cam.cam_h;
        inv_w = 1.0f / (float)a.cam.cam_w;
    }

    // the unit ray through GLOBAL pixel (row, col)
    __device__ void ray(float row, float col, float& dx, float& dy,
                        float& dz) const {
        const float ys = (0.5f - (row + 0.5f) * inv_h) * 2.0f * half_h;
        const float xs = ((col + 0.5f) * inv_w - 0.5f) * 2.0f * half_w;
        dx = fx + ux * ys + rx * xs;
        dy = fy + uy * ys + ry * xs;
        dz = fz + uz * ys + rz * xs;
        normalize3(dx, dy, dz);
    }
};

// The GLOBAL pixel of coarse cell (y, x)'s centre: cell * 4 + (origin +
// 1.5), as cone_rays_analytic makes it (small integers and halves: exact)
__device__ __forceinline__ float cell_centre(int cell, int origin) {
    return (float)(kSeedBlock * cell)
        + ((float)origin + 0.5f * (float)(kSeedBlock - 1));
}

// The first launch of K15 from the camera: the largest squared deviation
// of a block's four corner rays from its centre ray, over the window's
// coarse grid p.H x p.W, into scratch[0] (zeroed before the launch).
// Every thread of a warp reaches the reduction, in the grid or not.
__global__ void cone_delta_kernel(MarchParams p, ConeArgs a) {
    const ConeRays cam(a);
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    unsigned m = 0u;
    if (x < p.W && y < p.H) {
        const float row = cell_centre(y, a.cam.row0);
        const float col = cell_centre(x, a.cam.col0);
        const float c = 0.5f * (float)(kSeedBlock - 1);
        float cx, cy, cz;
        cam.ray(row, col, cx, cy, cz);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            float dx, dy, dz;
            cam.ray(k < 2 ? row - c : row + c, (k & 1) ? col + c : col - c,
                    dx, dy, dz);
            dx = dx - cx;
            dy = dy - cy;
            dz = dz - cz;
            m = max(m, __float_as_uint(dx * dx + dy * dy + dz * dz));
        }
    }
    m = __reduce_max_sync(0xffffffffu, m);
    if (((threadIdx.y * blockDim.x + threadIdx.x) & 31) == 0) {
        atomicMax(reinterpret_cast<unsigned*>(a.scratch), m);
    }
}

// K15: the cone march of the coarse cells p.H x p.W (see the header), on
// the compiled scene <NS, NB, NP> or (-1) any counts; CAMERA: the cones
// from the camera (after cone_delta_kernel), else from the ray planes.
template <int NS, int NB, int NP, bool CAMERA>
__global__ void cone_kernel(const float* __restrict__ scene,
                            float* __restrict__ t_out, MarchParams p,
                            ConeArgs a) {
    extern __shared__ float smem[];
    const auto sdf =
        SceneSdf<NS, NB, NP>::make(scene, smem, p.n_sph, p.n_box, p.n_pl);
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.W || y >= p.H) return;
    const int i = y * p.W + x;
    float rox, roy, roz, rdx, rdy, rdz, delta, base;
    if constexpr (CAMERA) {
        const ConeRays cam(a);
        rox = a.position[0];
        roy = a.position[1];
        roz = a.position[2];
        cam.ray(cell_centre(y, a.cam.row0), cell_centre(x, a.cam.col0), rdx,
                rdy, rdz);
        delta = sqrtf(a.scratch[0]);
        base = a.scratch[2];
        if (i == 0) a.scratch[1] = delta;
    } else {
        const int hw = p.H * p.W;
        rox = a.ro[i];
        roy = a.ro[hw + i];
        roz = a.ro[2 * hw + i];
        rdx = a.rd[i];
        rdy = a.rd[hw + i];
        rdz = a.rd[2 * hw + i];
        delta = *a.delta;
        base = *a.base;
    }
    const float clear0 = p.hit_eps + base;
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
    const auto sdf =
        SceneSdf<NS, NB, NP>::make(scene, smem, p.n_sph, p.n_box, p.n_pl);
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
// per light sample), on the compiled scene <NS, NB, NP> or (-1) any
// counts.  Every pixel is marched, misses included (K8 gives a miss
// dist = 0).
template <int NS, int NB, int NP>
__global__ void shadow_kernel(const float* __restrict__ scene,
                              const float* __restrict__ pos,
                              const float* __restrict__ nrm,
                              const float* __restrict__ light_p,
                              float* __restrict__ vis_out, ShadeParams p) {
    extern __shared__ float smem[];
    const auto sdf =
        SceneSdf<NS, NB, NP>::make(scene, smem, p.n_sph, p.n_box, p.n_pl);
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

// The order of the launches that read c_scene on one device.  A fill on
// one stream while a kernel of another stream reads the buffer would hand
// that kernel the other launch's scene, so each compiled-scene launch
// records an event after its kernel, and a fill on another stream than
// the last such launch's waits on that event first.  Each launch thus
// runs after the one issued before it (by stream order on the same
// stream, by the wait across streams), so every launch before it is done.
// On one stream the cost is the record alone: no wait is issued.
constexpr int kMaxDevices = 64;
struct SceneOrder {
    cudaEvent_t done = nullptr;    // recorded after the last launch
    cudaStream_t stream = nullptr; // that launch's stream
    bool any = false;              // a launch was recorded
};
std::mutex g_scene_mutex;
SceneOrder g_scene_order[kMaxDevices];

// Launches the instantiation <NS, NB, NP> by launch(smem bytes) on
// stream: a compiled scene checks the counts it was compiled for, copies
// the scene vector to c_scene and launches, ordered as above; the
// runtime-count one launches with the bytes it stages.
template <int NS, int NB, int NP, typename Launch>
cudaError_t launch_scene(const float* scene, int n_sph, int n_box, int n_pl,
                         cudaStream_t stream, Launch launch) {
    if constexpr (NS < 0) {
        launch(sizeof(float) * (5 * n_sph + 7 * n_box + 5 * n_pl));
        return cudaGetLastError();
    } else {
        if (n_sph != NS || n_box != NB || n_pl != NP)
            return cudaErrorInvalidValue;
        int dev;
        cudaError_t err = cudaGetDevice(&dev);
        if (err != cudaSuccess) return err;
        if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
        std::lock_guard<std::mutex> lock(g_scene_mutex);
        SceneOrder& order = g_scene_order[dev];
        if (!order.done) {
            err = cudaEventCreateWithFlags(&order.done,
                                           cudaEventDisableTiming);
            if (err != cudaSuccess) return err;
        }
        if (order.any && order.stream != stream) {
            err = cudaStreamWaitEvent(stream, order.done, 0);
            if (err != cudaSuccess) return err;
        }
        err = cudaMemcpyToSymbolAsync(
            c_scene, scene, sizeof(float) * FixedSdf<NS, NB, NP>::kAll, 0,
            cudaMemcpyDeviceToDevice, stream);
        if (err != cudaSuccess) return err;
        launch(size_t{0});
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        err = cudaEventRecord(order.done, stream);
        if (err != cudaSuccess) return err;
        order.stream = stream;
        order.any = true;
        return cudaSuccess;
    }
}

template <int NS, int NB, int NP>
cudaError_t launch_march(const float* scene, const float* ro, const float* rd,
                         const float* seed, float* t, bool* hit, int* mat,
                         float* normal, const MarchParams& p,
                         cudaStream_t stream) {
    const dim3 block(16, 8), grid = grid_for(p.H, p.W, block);
    return launch_scene<NS, NB, NP>(
        scene, p.n_sph, p.n_box, p.n_pl, stream, [&](size_t smem) {
            march_kernel<NS, NB, NP><<<grid, block, smem, stream>>>(
                scene, ro, rd, seed, t, hit, mat, normal, p);
        });
}

// K15's block of coarse cells (both launches): 8 x 4, 8 x 8 and 32 x 4
// blocks ran the Cornell camera route's march within 0.5 % of 16 x 8 at
// 1080p on the H100 (53.7-54.0 us)
constexpr int kConeBX = 16, kConeBY = 8;

template <int NS, int NB, int NP, bool CAMERA>
cudaError_t launch_cone(const float* scene, float* t, const MarchParams& p,
                        const ConeArgs& a, cudaStream_t stream) {
    const dim3 block(kConeBX, kConeBY), grid = grid_for(p.H, p.W, block);
    return launch_scene<NS, NB, NP>(
        scene, p.n_sph, p.n_box, p.n_pl, stream, [&](size_t smem) {
            cone_kernel<NS, NB, NP, CAMERA>
                <<<grid, block, smem, stream>>>(scene, t, p, a);
        });
}

// K15's march in the instantiation scene_key picks (as rdt_shadow_shade's)
template <bool CAMERA>
int launch_cone_key(const float* scene, float* t, const MarchParams& p,
                    const ConeArgs& a, int scene_key, cudaStream_t stream) {
#define RDT_CONE(NS, NB, NP)                                               \
    launch_cone<NS, NB, NP, CAMERA>(scene, t, p, a, stream)
    switch (scene_key) {
    case 0: return (int)RDT_CONE(-1, -1, -1);
    case 1: return (int)RDT_CONE(1, 3, 5);
    case 2: return (int)RDT_CONE(24, 24, 5);
    default: return (int)cudaErrorInvalidValue;
    }
#undef RDT_CONE
}

template <int NS, int NB, int NP>
cudaError_t launch_shade(const float* scene, const float* pos,
                         const float* normal, const float* light_p,
                         const float* albedo, const float* emission,
                         const bool* hit, const float* light,
                         const float* prev, float* render, float* vis,
                         float* motion, const ShadeParams& p,
                         cudaStream_t stream) {
    const dim3 block(16, 8), grid = grid_for(p.H, p.W, block);
    return launch_scene<NS, NB, NP>(
        scene, p.n_sph, p.n_box, p.n_pl, stream, [&](size_t smem) {
            shade_kernel<NS, NB, NP><<<grid, block, smem, stream>>>(
                scene, pos, normal, light_p, albedo, emission, hit, light,
                prev, render, vis, motion, p);
        });
}

template <int NS, int NB, int NP>
cudaError_t launch_shadow(const float* scene, const float* pos,
                          const float* normal, const float* light_p,
                          float* vis, const ShadeParams& p,
                          cudaStream_t stream) {
    const dim3 block(16, 8), grid = grid_for(p.H, p.W, block);
    return launch_scene<NS, NB, NP>(
        scene, p.n_sph, p.n_box, p.n_pl, stream, [&](size_t smem) {
            shadow_kernel<NS, NB, NP><<<grid, block, smem, stream>>>(
                scene, pos, normal, light_p, vis, p);
        });
}

}  // namespace

// K7; seed null: every ray starts at 0, else at its block's cone stop
// (the (ceil(H/4), ceil(W/4)) grid of K15).  scene_key picks the
// instantiation as in rdt_shadow_shade.
extern "C" int rdt_march(const float* scene, const float* ro, const float* rd,
                         const float* seed, float* t, bool* hit, int* mat,
                         float* normal, const MarchParams* params,
                         int scene_key, void* stream) {
#define RDT_MARCH(NS, NB, NP)                                              \
    launch_march<NS, NB, NP>(scene, ro, rd, seed, t, hit, mat, normal,     \
                             *params, (cudaStream_t)stream)
    switch (scene_key) {
    case 0: return (int)RDT_MARCH(-1, -1, -1);
    case 1: return (int)RDT_MARCH(1, 3, 5);
    case 2: return (int)RDT_MARCH(24, 24, 5);
    default: return (int)cudaErrorInvalidValue;
    }
#undef RDT_MARCH
}

// K15 from ray planes: the cones ro, rd (3 x H x W over the coarse grid
// params->H x params->W) and the device scalars delta and base; scene_key
// picks the instantiation as in rdt_shadow_shade.
extern "C" int rdt_cone_seed(const float* scene, const float* ro,
                             const float* rd, const float* delta,
                             const float* base, float* t,
                             const MarchParams* params, int scene_key,
                             void* stream) {
    ConeArgs a{};
    a.ro = ro;
    a.rd = rd;
    a.delta = delta;
    a.base = base;
    return launch_cone_key<false>(scene, t, *params, a, scene_key,
                                  (cudaStream_t)stream);
}

// K15 from the camera: its position, look_at and up (3 floats each, on the
// device) and configuration cam, over the window's coarse grid params->H x
// params->W; scratch (3 floats) gets [max squared deviation, delta, base =
// 0].  A memset, cone_delta_kernel, then the march.
extern "C" int rdt_cone_seed_camera(const float* scene, const float* position,
                                    const float* look_at, const float* up,
                                    const ConeCamera* cam, float* scratch,
                                    float* t, const MarchParams* params,
                                    int scene_key, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    ConeArgs a{};
    a.position = position;
    a.look_at = look_at;
    a.up = up;
    a.scratch = scratch;
    a.cam = *cam;
    cudaError_t err = cudaMemsetAsync(scratch, 0, 3 * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    const dim3 block(kConeBX, kConeBY);
    cone_delta_kernel<<<grid_for(params->H, params->W, block), block, 0, s>>>(
        *params, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return launch_cone_key<true>(scene, t, *params, a, scene_key, s);
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

// K13; scene_key picks the instantiation as in rdt_shadow_shade.
extern "C" int rdt_shadow(const float* scene, const float* pos,
                          const float* normal, const float* light_p,
                          float* vis, const ShadeParams* params,
                          int scene_key, void* stream) {
#define RDT_SHADOW(NS, NB, NP)                                             \
    launch_shadow<NS, NB, NP>(scene, pos, normal, light_p, vis, *params,   \
                              (cudaStream_t)stream)
    switch (scene_key) {
    case 0: return (int)RDT_SHADOW(-1, -1, -1);
    case 1: return (int)RDT_SHADOW(1, 3, 5);
    case 2: return (int)RDT_SHADOW(24, 24, 5);
    default: return (int)cudaErrorInvalidValue;
    }
#undef RDT_SHADOW
}
