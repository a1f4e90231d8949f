// Forward path-tracing megakernel for Hopper (sm_90a).
//
// Replaces computeraytracer_tpu/kernels/megakernel.py:897 build_forward in
// its plain mode (non-mesh scenes, untaped). One thread traces one ray to
// completion: up to max_depth+1 bounces of make_bounce (megakernel.py:467),
// each an in-order closest-hit scan over every primitive, next-event
// estimation with the power-heuristic MIS, diffuse / glass / mirror
// scattering with Beer-Lambert, Russian roulette, and masked pcg4d draws.
//
// What bounds it on this card: per-thread control flow that diverges
// (rays of one warp hit different materials and die at different depths)
// and register pressure from the live carry (16 f32, 4 u32 and 4 i32
// words plus a hit record), not bytes. Each ray reads 6+4 words, a few
// spectrum words per bounce, and writes 4: a few hundred bytes against
// thousands of flops per bounce.
//
// What the design does about it:
// - The carry stays in registers for the whole path; nothing round-trips
//   through memory between bounces.
// - A thread leaves the loop as soon as its ray is dead (the SIMT form of
//   the TPU kernel's all-dead-tile skip; exact, because every update of a
//   dead lane is a masked identity there).
// - Material branches are real branches: a lane computes only its own
//   material's work, where the TPU kernel computes all and selects. NEE
//   scans for the one light the ray picked; the TPU kernel scans for every
//   light and zeroes the others' contributions, which adds exact zeros.
// - The scene structure, which the TPU kernel unrolls as Python constants,
//   is a small runtime table: the primitive rows, per-slot (row, category,
//   material, emission, reflectance) and the light rows are loaded into
//   shared memory once per block, with the per-patch plane constants
//   precomputed there in the reference's op order. One build serves every
//   non-mesh scene up to MAX_PRIMS primitives and MAX_LIGHTS lights.
//
// Numerics: built with --fmad=false (no contraction of a*b+c into an FMA)
// and IEEE division and square root, so every operation rounds as the plain
// torch version's separate kernels do. expf/sinf/cosf are the full-precision
// library functions.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float T_MIN = 0.001f;
constexpr float ETA1 = 1.0f;
constexpr float ETA2 = 1.5f;
constexpr float ETA_IN = (float)(1.0 / 1.5);  // ETA1 / ETA2
constexpr float ETA_OUT = 1.5f;               // ETA2 / ETA1
constexpr float INV_PI = (float)(1.0 / 3.14159265358979323846);
constexpr float TWO_PI = (float)(2.0 * 3.14159265358979323846);

constexpr int MAX_PRIMS = 256;
constexpr int MAX_LIGHTS = 64;
constexpr int META = 5;  // row, category, material, emission, reflectance
constexpr int THREADS = 128;

enum { DIFFUSE = 0, LIGHT = 1, GLASS = 2, MIRROR = 3 };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 vadd(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 vscale(float s, V3 a) {
  return {s * a.x, s * a.y, s * a.z};
}
__device__ __forceinline__ float vdot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 vnormalize(V3 a) {
  float s = vdot(a, a);
  s = s < 1e-20f ? 1.0f : s;
  return vscale(1.0f / sqrtf(s), a);
}

struct Scene {
  float prim[MAX_PRIMS * 12];
  float n0[MAX_PRIMS * 3];  // unit patch normal
  float inv_e1[MAX_PRIMS];
  float inv_e2[MAX_PRIMS];
  int meta[MAX_PRIMS * META];
  int light_row[MAX_LIGHTS];
  int light_slot[MAX_LIGHTS];
  float light_area[MAX_LIGHTS];
};

struct Hit {
  float t;
  int idx;   // original row id, -1 on a miss
  int slot;  // packed slot of the winner
  V3 pos, nrm;
};

__device__ __forceinline__ V3 prim3(const Scene& s, int slot, int c) {
  const float* p = &s.prim[slot * 12 + c];
  return {p[0], p[1], p[2]};
}

// In-order closest-hit scan. `t <= best` lets the LAST hit win ties: the
// ceiling light is coplanar with the ceiling and visible only through it.
__device__ Hit scan(const Scene& s, int P, V3 o, V3 d, int exclude) {
  Hit h;
  h.t = INFINITY;
  h.idx = -1;
  h.slot = -1;
  h.pos = {0.0f, 0.0f, 0.0f};
  h.nrm = {0.0f, 0.0f, 0.0f};
  const float a = vdot(d, d);
  for (int slot = 0; slot < P; ++slot) {
    const int row = s.meta[slot * META + 0];
    const int cat = s.meta[slot * META + 1];
    if (row == exclude) continue;
    if (cat == 0) {
      const V3 p0 = prim3(s, slot, 0);
      const V3 e1 = prim3(s, slot, 3);
      const V3 e2 = prim3(s, slot, 6);
      const V3 n0 = {s.n0[slot * 3], s.n0[slot * 3 + 1], s.n0[slot * 3 + 2]};
      const float ndotd = n0.x * d.x + n0.y * d.y + n0.z * d.z;
      const bool flip = ndotd > 0.0f;
      const float ndotd_f = flip ? -ndotd : ndotd;
      if (fabsf(ndotd_f) < 1e-4f) continue;  // grazing
      const float num = n0.x * (p0.x - o.x) + n0.y * (p0.y - o.y) +
                        n0.z * (p0.z - o.z);
      const float t = num / ndotd;
      if (!(t >= T_MIN && t <= h.t)) continue;
      const V3 p = vadd(o, vscale(t, d));
      const V3 m = vsub(p, p0);
      const float u = vdot(m, e1) * s.inv_e1[slot];
      const float v = vdot(m, e2) * s.inv_e2[slot];
      if (!(u >= 0.0f && u <= 1.0f && v >= 0.0f && v <= 1.0f)) continue;
      const float sgn = flip ? -1.0f : 1.0f;
      h.t = t;
      h.idx = row;
      h.slot = slot;
      h.pos = p;
      h.nrm = {sgn * n0.x, sgn * n0.y, sgn * n0.z};
    } else {  // sphere: radius in column 3
      const V3 c = prim3(s, slot, 0);
      const float radius = s.prim[slot * 12 + 3];
      const V3 co = vsub(o, c);
      const float b = 2.0f * vdot(d, co);
      const float c2 = vdot(co, co) - radius * radius;
      const float disc = b * b - 4.0f * a * c2;
      if (!(disc > 0.0f) || !(a > 1e-12f)) continue;
      const float sq = sqrtf(disc);
      const float denom = 2.0f * a;
      const float t_near = (-b - sq) / denom;
      const float t_far = (-b + sq) / denom;
      const bool near_ok = t_near >= T_MIN && t_near <= h.t;
      const float t = near_ok ? t_near : t_far;
      if (!(t >= T_MIN && t <= h.t)) continue;
      const V3 p = vadd(o, vscale(t, d));
      h.t = t;
      h.idx = row;
      h.slot = slot;
      h.pos = p;
      h.nrm = vnormalize(vsub(p, c));
    }
  }
  return h;
}

__device__ __forceinline__ void pcg4d(uint32_t* v) {
  uint32_t x = v[0] * 1664525u + 1013904223u;
  uint32_t y = v[1] * 1664525u + 1013904223u;
  uint32_t z = v[2] * 1664525u + 1013904223u;
  uint32_t w = v[3] * 1664525u + 1013904223u;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  v[0] = x;
  v[1] = y;
  v[2] = z;
  v[3] = w;
}

// One masked draw: low 24 bits of the advanced state's x word, times 2^-24.
__device__ __forceinline__ float draw(uint32_t* seed) {
  pcg4d(seed);
  return (float)(int)(seed[0] & 0x00FFFFFFu) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float light_pdf(const Scene& s, int l, int n_lights,
                                           V3 n_at_light, V3 ray_dir, V3 l_pos,
                                           V3 r_origin) {
  const float abs_cos = fmaxf(1e-5f, fabsf(-vdot(n_at_light, ray_dir)));
  const V3 diff = vsub(l_pos, r_origin);
  const float dist2 = vdot(diff, diff);
  const float geo = abs_cos / fmaxf(dist2, 1e-12f);
  const float pdf =
      (1.0f / fmaxf(s.light_area[l], 1e-12f)) / geo / (float)n_lights;
  return fminf(fmaxf(pdf, 0.0f), 1e16f);
}

__device__ __forceinline__ float power_heuristic(float f, float g) {
  const float r = g / fmaxf(f, 1e-12f);
  return 1.0f / (1.0f + r * r);
}

__global__ void __launch_bounds__(THREADS)
    megakernel_fwd_kernel(const float* __restrict__ prims,
                          const int* __restrict__ meta, int P,
                          const int* __restrict__ lights, int n_lights,
                          const float* __restrict__ rays,
                          const int* __restrict__ seeds,
                          const float* __restrict__ spect, int S,
                          float* __restrict__ out, long long R, int max_depth,
                          int rr_start) {
  __shared__ Scene s;
  for (int i = threadIdx.x; i < P * 12; i += blockDim.x) s.prim[i] = prims[i];
  for (int i = threadIdx.x; i < P * META; i += blockDim.x) s.meta[i] = meta[i];
  for (int i = threadIdx.x; i < n_lights; i += blockDim.x) {
    s.light_row[i] = lights[2 * i];
    s.light_slot[i] = lights[2 * i + 1];
  }
  __syncthreads();
  // per-slot plane constants and per-light areas, in the reference's op
  // order (megakernel.py:273-295 and :496-500)
  for (int slot = threadIdx.x; slot < P; slot += blockDim.x) {
    if (s.meta[slot * META + 1] != 0) continue;
    const V3 e1 = prim3(s, slot, 3);
    const V3 e2 = prim3(s, slot, 6);
    const V3 n_raw = vcross(e1, e2);
    const float n_len2 = n_raw.x * n_raw.x + n_raw.y * n_raw.y + n_raw.z * n_raw.z;
    const float inv_len = 1.0f / sqrtf(fmaxf(n_len2, 1e-30f));
    s.n0[slot * 3 + 0] = n_raw.x * inv_len;
    s.n0[slot * 3 + 1] = n_raw.y * inv_len;
    s.n0[slot * 3 + 2] = n_raw.z * inv_len;
    s.inv_e1[slot] = 1.0f / fmaxf(e1.x * e1.x + e1.y * e1.y + e1.z * e1.z, 1e-12f);
    s.inv_e2[slot] = 1.0f / fmaxf(e2.x * e2.x + e2.y * e2.y + e2.z * e2.z, 1e-12f);
  }
  for (int l = threadIdx.x; l < n_lights; l += blockDim.x) {
    const int slot = s.light_slot[l];
    const V3 e1 = prim3(s, slot, 3);
    const V3 e2 = prim3(s, slot, 6);
    s.light_area[l] =
        sqrtf(fmaxf(e1.x * e1.x + e1.y * e1.y + e1.z * e1.z, 1e-30f)) *
        sqrtf(fmaxf(e2.x * e2.x + e2.y * e2.y + e2.z * e2.z, 1e-30f));
  }
  __syncthreads();

  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;

  // spectrum `row` at this ray's 4 hero wavelengths, ray axis minor
  auto gets = [&](int row, float* v) {
    for (int j = 0; j < 4; ++j) v[j] = spect[(long long)(row * 4 + j) * R + r];
  };

  V3 o = {rays[0 * R + r], rays[1 * R + r], rays[2 * R + r]};
  V3 d = {rays[3 * R + r], rays[4 * R + r], rays[5 * R + r]};
  uint32_t seed[4];
  for (int k = 0; k < 4; ++k) seed[k] = (uint32_t)seeds[k * R + r];
  float L[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float beta[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  float last_pdf = 1.0f;
  float eta_scale = 1.0f;
  int exclude = -1;
  bool specular = false;
  bool in_trans = false;

  for (int depth = 0; depth <= max_depth; ++depth) {
    const Hit hit = scan(s, P, o, d, exclude);
    if (hit.idx < 0) break;
    exclude = hit.idx;
    const int* m = &s.meta[hit.slot * META];
    const int mat = m[2];

    // ---- emissive hit
    if (mat == LIGHT) {
      float le[4];
      gets(m[3], le);
      float mis_w = 1.0f;
      if (!(depth == 0 || specular)) {
        float pdf_l_hit = 0.0f;
        for (int l = 0; l < n_lights; ++l)
          if (s.light_row[l] == hit.idx)
            pdf_l_hit = light_pdf(s, l, n_lights, hit.nrm, d, hit.pos, o);
        mis_w = power_heuristic(last_pdf, pdf_l_hit);
      }
      for (int j = 0; j < 4; ++j) L[j] = L[j] + beta[j] * le[j] * mis_w;
      break;
    }
    if (depth >= max_depth) break;

    // ---- Beer-Lambert inside glass
    if (in_trans) {
      float ext[4];
      gets(S - 1, ext);
      const V3 diffp = vsub(hit.pos, o);
      const float dsq = vdot(diffp, diffp);
      const float dist = sqrtf(dsq > 0.0f ? dsq : 1.0f) * (dsq > 0.0f ? 1.0f : 0.0f);
      for (int j = 0; j < 4; ++j) beta[j] = beta[j] * expf(-ext[j] * dist);
    }

    const V3 n = hit.nrm;
    if (mat == DIFFUSE) {
      // ---- NEE + cosine bounce (5 draws)
      const float u_l = draw(seed);
      const float u_p = draw(seed);
      const float v_p = draw(seed);
      const float u_h = draw(seed);
      const float v_h = draw(seed);
      float brdf[4];
      gets(m[4], brdf);
      for (int j = 0; j < 4; ++j) brdf[j] = brdf[j] * INV_PI;

      int li = (int)(u_l * (float)n_lights);
      li = li < 0 ? 0 : (li > n_lights - 1 ? n_lights - 1 : li);
      const int sl = s.light_slot[li];
      const V3 l_o = prim3(s, sl, 0);
      const V3 l_e1 = prim3(s, sl, 3);
      const V3 l_e2 = prim3(s, sl, 6);
      const V3 p_l = {l_o.x + u_p * l_e1.x + v_p * l_e2.x,
                      l_o.y + u_p * l_e1.y + v_p * l_e2.y,
                      l_o.z + u_p * l_e1.z + v_p * l_e2.z};
      const V3 ldir = vnormalize(vsub(p_l, hit.pos));
      const Hit sh = scan(s, P, hit.pos, ldir, hit.idx);
      const bool unocc = sh.idx >= 0 && sh.idx == s.light_row[li];
      if (unocc) {
        const float cos_t = fmaxf(0.0f, vdot(n, ldir));
        const float pdf_l = light_pdf(s, li, n_lights, sh.nrm, ldir, sh.pos, hit.pos);
        const float pdf_b = cos_t * INV_PI;
        const float w_l = power_heuristic(pdf_l, pdf_b);
        const float scale = cos_t * w_l / fmaxf(pdf_l, 1e-12f);
        float l_emis[4];
        gets(s.meta[sl * META + 3], l_emis);
        for (int j = 0; j < 4; ++j) {
          const float nee = l_emis[j] * scale;
          L[j] = L[j] + brdf[j] * nee * beta[j];
        }
      }

      // cosine hemisphere
      const float r_h = sqrtf(fmaxf(u_h, 0.0f));
      const float th = TWO_PI * v_h;
      const float xh = r_h * cosf(th);
      const float yh = r_h * sinf(th);
      const float zh = sqrtf(fmaxf(0.0f, 1.0f - u_h));
      const bool z_minor = fabsf(n.z) < 0.999f;
      const V3 up = {z_minor ? 0.0f : 1.0f, 0.0f, z_minor ? 1.0f : 0.0f};
      const V3 tangent = vnormalize(vcross(up, n));
      const V3 bitangent = vcross(n, tangent);
      const V3 bd = {tangent.x * xh + bitangent.x * yh + n.x * zh,
                     tangent.y * xh + bitangent.y * yh + n.y * zh,
                     tangent.z * xh + bitangent.z * yh + n.z * zh};
      const float bounce_pdf = zh * INV_PI;
      const float cos_b = fabsf(vdot(n, bd));
      const float bfac = cos_b / fmaxf(bounce_pdf, 1e-12f);
      for (int j = 0; j < 4; ++j) beta[j] = beta[j] * brdf[j] * bfac;
      d = bd;
      last_pdf = bounce_pdf;
      specular = false;
    } else if (mat == GLASS) {
      // ---- Fresnel-weighted reflect / refract (1 draw)
      const float u_g = draw(seed);
      const float cos_in = vdot(n, d);
      const float cosi = fminf(fmaxf(cos_in, -1.0f), 1.0f);
      const float fe = cosi > 0.0f ? ETA_OUT : ETA_IN;
      const float sint2 = fe * fe * (1.0f - cosi * cosi);
      const bool tir = sint2 > 1.0f;
      const float cost = sqrtf(tir ? 1.0f : 1.0f - sint2);
      const float ci = fabsf(cosi);
      const float rs = (ETA1 * ci - ETA2 * cost) / (ETA1 * ci + ETA2 * cost);
      const float rp = (ETA2 * ci - ETA1 * cost) / (ETA2 * ci + ETA1 * cost);
      const float pr = tir ? 1.0f : 0.5f * (rs * rs + rp * rp);
      const float eta = cos_in > 0.0f ? ETA_OUT : ETA_IN;
      const V3 ng = cos_in > 0.0f ? V3{-n.x, -n.y, -n.z} : n;
      const bool choose_refl = u_g < pr / fmaxf(pr + (1.0f - pr), 1e-12f);
      if (choose_refl) {
        const float nd2 = 2.0f * vdot(ng, d);
        d = vsub(d, vscale(nd2, ng));
      } else {
        const float ndoti = vdot(ng, d);
        const float kk = 1.0f - eta * eta * (1.0f - ndoti * ndoti);
        const bool ktir = kk < 0.0f;
        const float sqk = sqrtf(ktir ? 1.0f : kk);
        V3 rft = vsub(vscale(eta, d), vscale(eta * ndoti + sqk, ng));
        if (ktir) rft = {0.0f, 0.0f, 0.0f};
        d = vnormalize(rft);
        const float eta2v = eta * eta;
        for (int j = 0; j < 4; ++j) beta[j] = beta[j] * eta2v;
        eta_scale = eta_scale / eta2v;
        in_trans = !in_trans;
      }
      specular = true;
      exclude = -1;
    } else if (mat == MIRROR) {
      const float nd2m = 2.0f * vdot(n, d);
      d = vsub(d, vscale(nd2m, n));
      specular = true;
      exclude = -1;
    }
    o = hit.pos;

    // ---- Russian roulette
    const float r0 = beta[0] * eta_scale;
    const float r1 = beta[1] * eta_scale;
    const float r2 = beta[2] * eta_scale;
    const float max_c = fmaxf(r0, fmaxf(r1, r2));
    if (depth > rr_start && max_c < 1.0f) {
      const float u_r = draw(seed);
      const float q = fmaxf(0.0f, 1.0f - max_c);
      if (u_r < q) break;
      const float inv1q = 1.0f / fmaxf(1.0f - q, 1e-12f);
      for (int j = 0; j < 4; ++j) beta[j] = beta[j] * inv1q;
    }
  }
  for (int j = 0; j < 4; ++j) out[j * R + r] = L[j];
}

}  // namespace

extern "C" int megakernel_fwd(const float* prims, const int* meta, int n_prims,
                              const int* lights, int n_lights,
                              const float* rays, const int* seeds,
                              const float* spect, int n_spectra, float* out,
                              long long n_rays, int max_depth, int rr_start,
                              void* stream) {
  if (n_prims < 0 || n_prims > MAX_PRIMS || n_lights < 1 ||
      n_lights > MAX_LIGHTS || n_spectra < 1 || n_rays < 0 ||
      (n_rays + THREADS - 1) / THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const unsigned blocks = (unsigned)((n_rays + THREADS - 1) / THREADS);
  megakernel_fwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      prims, meta, n_prims, lights, n_lights, rays, seeds, spect, n_spectra,
      out, n_rays, max_depth, rr_start);
  return (int)cudaGetLastError();
}
