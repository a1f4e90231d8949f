// The reverse adjoint sweep of the backward megakernels, shared by the
// retrace kernel (megakernel_bwd.cu, build_backward) and the tape-fed
// kernel (megakernel_bwd_tape.cu, build_backward_from_tape): both run this
// same code on the same tape, so they give bit-equal cotangents.
//
// It computes what jax.vjp of make_bounce computes inside the TPU kernels
// (computeraytracer_tpu/kernels/megakernel.py:1410-1417 and :1524-1546),
// bounce by bounce from the last live one down to 0: recompute the bounce
// from its tape row (bounce.cuh, the forward's own code, so the same
// decisions), then apply the hand-written adjoint below. The carry
// cotangent starts as d_L = dL, every other word 0; what is left in d_o,
// d_d at depth 0 is d_rays.
//
// The adjoint follows autograd of the plain torch version
// (kernels/megakernel.py forward_reference) op for op, including its tie
// rules: torch.maximum splits the cotangent evenly at a tie, torch.clamp
// passes it where the input equals the bound, abs passes sign(x).
//
// Sums are deterministic. d_spect is per ray: each thread owns its column
// and accumulates into it directly. d_prims: each warp adds its lanes'
// per-bounce contributions (at most two primitive slots per bounce: the
// hit and the NEE light) into its own shared-memory table in lane order;
// the block sums its four warp tables in a fixed order into one partial
// row per block (block_partial), and reduce_partials sums the blocks in a
// fixed order. Two runs give bit-equal gradients, so a resumed training
// run repeats bit for bit.
//
// The launch is sweep_kernel, one thread per ray. What bounds it on this
// card: the recompute's scans and the adjoint's divergent per-thread code,
// at 128 registers and 4 resident blocks per SM; the tape reads, the
// d_spect traffic and the d_prims fold are small shares of it (the timed
// build's sections, PERF.md §6). The design holds both builds to 4 blocks
// per SM: the triangle-row build ran slower at its own budget, which fit
// 3. Measured against this layout and dropped, each slower at Cornell
// (PERF.md §6): the rays' spectrum and d_spect columns staged in shared
// memory, the contributions staged there, a scene table sized by the
// scene, a fold that groups the lanes by slot, 5 blocks per SM (96
// registers, spilled) and blocks of 32 or 64 threads.

#pragma once

#include "bounce.cuh"

namespace pathtrace {

constexpr int WARPS = THREADS / 32;
constexpr int NC = 9;  // gradient columns a primitive can receive (0..8)
constexpr unsigned FULL = 0xffffffffu;

// Sections of the sweep's timed build (the TIMED template argument; never
// launched on the main path), in clock64() cycles summed over warps
// (kernels/megakernel.py SWEEP_SECTIONS): the tape-row reads, the
// recompute's scans, the rest of the recompute, the adjoint, the d_spect
// traffic, the d_prims fold and the rest (the scene load, d_rays, the
// block's partial row and the wait for the block's slowest warp).
enum {
  T_TAPE = 0, T_SCAN = 1, T_RECOMP = 2, T_ADJOINT = 3, T_DSPECT = 4,
  T_FOLD = 5, T_OTHER = 6, T_KINDS = 7
};

// A warp's section clock in a timed build. mark(k) adds the cycles since
// the last mark to section k; every lane calls it, at a point where the
// warp has converged. Inside code where the lanes diverge, each lane
// counts its own cycles of a part (the tape read, its scans, its d_spect
// traffic); move() then moves the warp's largest such count out of the
// section that received the whole interval. A load's latency falls where
// its value is first used. With TIMED false, nothing is compiled.
template <bool TIMED>
struct SweepClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void move(int, int, long long) {}
  __device__ __forceinline__ void flush(unsigned long long*) {}
};

template <>
struct SweepClock<true> {
  long long sec[T_KINDS];
  long long last;
  __device__ __forceinline__ void start() {
    for (int k = 0; k < T_KINDS; ++k) sec[k] = 0;
    __syncwarp();
    last = clock64();
  }
  __device__ __forceinline__ void mark(int k) {
    __syncwarp();
    const long long now = clock64();
    sec[k] += now - last;
    last = now;
  }
  // Moves the warp's largest lane count `lane` from section `from` to `to`.
  __device__ __forceinline__ void move(int from, int to, long long lane) {
    long long w = (long long)__reduce_max_sync(
        FULL, (unsigned)(lane < 0 ? 0 : (lane > 0xffffffffLL ? 0xffffffffLL
                                                              : lane)));
    w = w < sec[from] ? w : sec[from];
    sec[from] -= w;
    sec[to] += w;
  }
  __device__ __forceinline__ void flush(unsigned long long* times) {
    if ((threadIdx.x & 31) == 0)
      for (int k = 0; k < T_KINDS; ++k)
        atomicAdd(times + k, (unsigned long long)sec[k]);
  }
};

// clock64() read after x is available: the timed builds end a load's
// interval with it, so that the load's latency counts there.
__device__ __forceinline__ long long clock_after(float x) {
  long long t;
  asm volatile("add.f32 %1, %1, 0f00000000;\n\tmov.u64 %0, %%clock64;"
               : "=l"(t), "+f"(x)::"memory");
  return t;
}

__device__ __forceinline__ V3 vzero() { return {0.0f, 0.0f, 0.0f}; }
__device__ __forceinline__ void vacc(V3& a, V3 b) { a = vadd(a, b); }
__device__ __forceinline__ float sgnf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// d(x / y) with respect to y, as autograd computes it: -g * ((x / y) / y).
__device__ __forceinline__ float div_other(float g, float x, float y) {
  return -g * ((x / y) / y);
}

// Adjoint of vnormalize(v) for cotangent g of its output.
__device__ V3 normalize_bwd(V3 v, V3 g) {
  const float s = vdot(v, v);
  const bool pass = !(s < 1e-20f);
  const float sq = sqrtf(pass ? s : 1.0f);
  const float inv = 1.0f / sq;
  V3 gv = vscale(inv, g);
  if (pass) {
    const float g_inv = vdot(g, v);
    const float g_sq = -g_inv * inv * inv;
    const float g_s = g_sq / (2.0f * sq);
    vacc(gv, vscale(2.0f * g_s, v));
  }
  return gv;
}

// Adjoint of the unit patch normal n0 = normalize'(e1 x e2) (the
// per-block constant of load_scene) into the patch edges.
__device__ void n0_bwd(V3 e1, V3 e2, V3 g_n0, V3& g_e1, V3& g_e2) {
  const V3 nr = vcross(e1, e2);
  const float nl2 = nr.x * nr.x + nr.y * nr.y + nr.z * nr.z;
  const float sq = sqrtf(fmaxf(nl2, 1e-30f));
  const float inv = 1.0f / sq;
  V3 g_nr = vscale(inv, g_n0);
  if (nl2 >= 1e-30f) {
    const float g_inv = vdot(g_n0, nr);
    const float g_m = (-g_inv * inv * inv) / (2.0f * sq);
    vacc(g_nr, vscale(2.0f * g_m, nr));
  }
  vacc(g_e1, vcross(e2, g_nr));
  vacc(g_e2, vcross(g_nr, e1));
}

// Adjoint of the light area sqrt(max(|e1|^2)) * sqrt(max(|e2|^2)).
__device__ void area_bwd(V3 e1, V3 e2, float g_area, V3& g_e1, V3& g_e2) {
  const float m1 = e1.x * e1.x + e1.y * e1.y + e1.z * e1.z;
  const float m2 = e2.x * e2.x + e2.y * e2.y + e2.z * e2.z;
  const float s1 = sqrtf(fmaxf(m1, 1e-30f));
  const float s2 = sqrtf(fmaxf(m2, 1e-30f));
  if (m1 >= 1e-30f) vacc(g_e1, vscale(2.0f * ((g_area * s2) / (2.0f * s1)), e1));
  if (m2 >= 1e-30f) vacc(g_e2, vscale(2.0f * ((g_area * s1) / (2.0f * s2)), e2));
}

// Adjoint of power_heuristic(f, g).
__device__ void ph_bwd(float f, float g, float g_out, float& g_f, float& g_g) {
  const float fm = fmaxf(f, 1e-12f);
  const float r = g / fm;
  const float w = 1.0f / (1.0f + r * r);
  const float g_den = -g_out * w * w;
  const float g_r = 2.0f * r * g_den;
  g_g += g_r / fm;
  if (f >= 1e-12f) g_f += div_other(g_r, g, fm);
}

// A primitive slot's cotangent contribution of one bounce.
struct Contrib {
  int slot;
  float v[NC];
};

__device__ __forceinline__ void contrib_init(Contrib& c, int slot) {
  c.slot = slot;
  for (int k = 0; k < NC; ++k) c.v[k] = 0.0f;
}
__device__ __forceinline__ void contrib_add3(Contrib& c, int col, V3 g) {
  c.v[col] += g.x;
  c.v[col + 1] += g.y;
  c.v[col + 2] += g.z;
}

// Adjoint of light_pdf(l, n_at, dir, l_pos, r_origin); the light's area
// cotangent goes into its edges in `c`.
__device__ void light_pdf_bwd(const Scene& s, int l, int n_lights, V3 n_at,
                              V3 dir, V3 l_pos, V3 r_origin, float g_out,
                              V3& g_n, V3& g_dir, V3& g_lpos, V3& g_rorig,
                              Contrib& c) {
  const float dt = vdot(n_at, dir);
  const float ax = fabsf(-dt);
  const float abs_cos = fmaxf(1e-5f, ax);
  const V3 diff = vsub(l_pos, r_origin);
  const float dist2 = vdot(diff, diff);
  const float dm = fmaxf(dist2, 1e-12f);
  const float geo = abs_cos / dm;
  const float area = s.light_area[l];
  const float ia = 1.0f / fmaxf(area, 1e-12f);
  const float a = ia / geo;
  const float pdf = a / (float)n_lights;
  if (!(pdf >= 0.0f && pdf <= 1e16f)) return;
  const float g_a = g_out / (float)n_lights;
  const float g_ia = g_a / geo;
  const float g_geo = div_other(g_a, ia, geo);
  if (area >= 1e-12f) {
    const int sl = s.light_slot[l];
    V3 g_e1 = vzero(), g_e2 = vzero();
    area_bwd(prim3(s, sl, 3), prim3(s, sl, 6), -g_ia * ia * ia, g_e1, g_e2);
    contrib_add3(c, 3, g_e1);
    contrib_add3(c, 6, g_e2);
  }
  const float g_ac = g_geo / dm;
  if (dist2 >= 1e-12f) {
    const V3 g_diff = vscale(2.0f * div_other(g_geo, abs_cos, dm), diff);
    vacc(g_lpos, g_diff);
    g_rorig = vsub(g_rorig, g_diff);
  }
  if (ax >= 1e-5f) {
    const float g_dt = -(sgnf(-dt) * g_ac);
    vacc(g_n, vscale(g_dt, dir));
    vacc(g_dir, vscale(g_dt, n_at));
  }
}

// Adjoint of the closest hit h of a ray (o, d): cotangents of its pos and
// nrm into o, d and the winning primitive's row. With TRI (the builds for
// scenes with triangle rows), a category-2 winner takes the plane test's
// adjoint too, with p0 = v0, e1 = v1 - v0 and e2 = v2 - v0: the edges'
// cotangents go to v1 and v2 and are taken from v0's (columns 0, 3, 6).
// Its inside test is boolean and carries no cotangent.
template <bool TRI>
__device__ void hit_bwd(const Scene& s, const Hit& h, V3 o, V3 d, V3 g_pos,
                        V3 g_nrm, V3& g_o, V3& g_d, Contrib& c) {
  const int w = h.slot;
  const int cat = s.meta[w * META + 1];
  if (cat == 0 || (TRI && cat == 2)) {
    const V3 p0 = prim3(s, w, 0);
    const V3 n0 = {s.n0[w * 3], s.n0[w * 3 + 1], s.n0[w * 3 + 2]};
    const float ndotd = n0.x * d.x + n0.y * d.y + n0.z * d.z;
    const float sgn = ndotd > 0.0f ? -1.0f : 1.0f;
    const float num = n0.x * (p0.x - o.x) + n0.y * (p0.y - o.y) +
                      n0.z * (p0.z - o.z);
    const float t = h.t;
    vacc(g_o, g_pos);
    vacc(g_d, vscale(t, g_pos));
    const float g_t = vdot(g_pos, d);
    const float g_num = g_t / ndotd;
    const float g_nd = div_other(g_t, num, ndotd);
    V3 g_n0 = vscale(sgn, g_nrm);
    vacc(g_n0, vscale(g_num, vsub(p0, o)));
    vacc(g_n0, vscale(g_nd, d));
    const V3 g_p0 = vscale(g_num, n0);
    g_o = vsub(g_o, g_p0);
    vacc(g_d, vscale(g_nd, n0));
    V3 g_e1 = vzero(), g_e2 = vzero();
    if (TRI && cat == 2) {
      n0_bwd(vsub(prim3(s, w, 3), p0), vsub(prim3(s, w, 6), p0), g_n0, g_e1,
             g_e2);
      contrib_add3(c, 0, vsub(vsub(g_p0, g_e1), g_e2));
    } else {
      n0_bwd(prim3(s, w, 3), prim3(s, w, 6), g_n0, g_e1, g_e2);
      contrib_add3(c, 0, g_p0);
    }
    contrib_add3(c, 3, g_e1);
    contrib_add3(c, 6, g_e2);
  } else {
    const V3 cc = prim3(s, w, 0);
    const float radius = s.prim[w * 12 + 3];
    const V3 co = vsub(o, cc);
    const float a = vdot(d, d);
    const float b = 2.0f * vdot(d, co);
    const float c2 = vdot(co, co) - radius * radius;
    const float disc = b * b - 4.0f * a * c2;
    const float sq = sqrtf(disc);
    const float denom = 2.0f * a;
    const float t_near = (-b - sq) / denom;
    const bool near = t_near == h.t;
    const float numer = near ? -b - sq : -b + sq;
    const V3 g_v = normalize_bwd(vsub(h.pos, cc), g_nrm);
    const V3 g_p = vadd(g_pos, g_v);
    V3 g_c = vscale(-1.0f, g_v);
    vacc(g_o, g_p);
    vacc(g_d, vscale(h.t, g_p));
    const float g_t = vdot(g_p, d);
    const float g_numer = g_t / denom;
    const float g_denom = div_other(g_t, numer, denom);
    float g_b = -g_numer;
    const float g_sq = near ? -g_numer : g_numer;
    float g_a = 2.0f * g_denom;
    const float g_disc = g_sq / (2.0f * sq);
    g_b += 2.0f * b * g_disc;
    g_a += 4.0f * (-g_disc * c2);
    const float g_c2 = -g_disc * (4.0f * a);
    V3 g_co = vscale(2.0f * g_c2, co);
    const float g_r = -2.0f * radius * g_c2;
    const float g_bd = 2.0f * g_b;
    vacc(g_d, vscale(g_bd, co));
    vacc(g_co, vscale(g_bd, d));
    vacc(g_d, vscale(2.0f * g_a, d));
    vacc(g_o, g_co);
    g_c = vsub(g_c, g_co);
    contrib_add3(c, 0, g_c);
    c.v[3] += g_r;
  }
}

// Cotangent of the carry (L's is dL on every bounce: L_out = L_in + ...).
struct Grad {
  V3 o, d;
  float L[4];
  float beta[4];
  float last_pdf;
  float eta_scale;
};

// Adjoint of a specular direction update out = d - (2 (m.d)) m.
__device__ void reflect_bwd(V3 d, V3 m, V3 g_out, V3& g_d, V3& g_m) {
  const float nd2 = 2.0f * vdot(m, d);
  vacc(g_d, g_out);
  const float g_nd2 = -vdot(g_out, m);
  vacc(g_m, vscale(-nd2, g_out));
  const float g_dot = 2.0f * g_nd2;
  vacc(g_m, vscale(g_dot, d));
  vacc(g_d, vscale(g_dot, m));
}

// Adjoint of one bounce. cin is the bounce's input carry, rec what its
// forward recompute recorded; g holds the output carry's cotangent on
// entry and the input carry's on exit. Primitive cotangents go to cA (the
// hit) and cB (the NEE light), spectrum cotangents into this ray's column
// of d_spect. TRI: the scene has triangle rows (hit_bwd). TIMED: add the
// cycles of the d_spect updates to *dsp_clk.
template <bool TRI, bool TIMED>
__device__ void bounce_bwd(const Scene& s, const Trace& tr, long long r,
                           int depth, const Carry& cin, const BounceRec& rec,
                           Grad& g, Contrib& cA, Contrib& cB,
                           float* __restrict__ dsp, long long* dsp_clk) {
  const Hit& h = rec.hit;
  if (h.idx < 0) return;  // a miss changes no differentiable word
  const int* m = &s.meta[h.slot * META];
  const int mat = m[2];
  auto dspect = [&](int row, int j, float v) {
    long long t = 0;
    if constexpr (TIMED) t = clock64();
    dsp[(long long)(row * 4 + j) * tr.R + r] += v;
    if constexpr (TIMED) *dsp_clk += clock64() - t;
  };
  if (mat != LIGHT && !rec.scatter) return;  // depth == max_depth
  contrib_init(cA, h.slot);
  V3 g_pos = vzero(), g_nrm = vzero();
  V3 g_o = g.o, g_d = g.d;

  if (mat == LIGHT) {
    // L += beta * le * mis_w; every other word passes through
    float le[4];
    gets(tr, r, m[3], le);
    const bool mis = !(depth == 0 || cin.specular);
    int l_hit = 0;
    float pdf_l_hit = 0.0f, mis_w = 1.0f;
    if (mis) {
      for (int l = 0; l < tr.n_lights; ++l)
        if (s.light_row[l] == h.idx) {
          l_hit = l;
          pdf_l_hit = light_pdf(s, l, tr.n_lights, h.nrm, cin.d, h.pos, cin.o);
        }
      mis_w = power_heuristic(cin.last_pdf, pdf_l_hit);
    }
    float g_mis = 0.0f;
    for (int j = 0; j < 4; ++j) {
      const float bl = cin.beta[j] * le[j];
      const float g_bl = g.L[j] * mis_w;
      g_mis += g.L[j] * bl;
      g.beta[j] += g_bl * le[j];
      dspect(m[3], j, g_bl * cin.beta[j]);
    }
    if (mis) {
      float g_pdf = 0.0f;
      ph_bwd(cin.last_pdf, pdf_l_hit, g_mis, g.last_pdf, g_pdf);
      light_pdf_bwd(s, l_hit, tr.n_lights, h.nrm, cin.d, h.pos, cin.o, g_pdf,
                    g_nrm, g_d, g_pos, g_o, cA);
    }
    hit_bwd<TRI>(s, h, cin.o, cin.d, g_pos, g_nrm, g_o, g_d, cA);
    g.o = g_o;
    g.d = g_d;
    return;
  }
  // the scattered carry: o_out = pos, so o_in and d_in get their
  // cotangents only through the scan, Beer-Lambert and the BSDF
  vacc(g_pos, g.o);
  g_o = vzero();
  g_d = vzero();
  const V3 n = h.nrm;
  float beta_m[4];      // beta after the BSDF, before Russian roulette
  float es_m = cin.eta_scale;
  float g_bl[4];        // cotangent of beta after Beer-Lambert
  float g_es_in = 0.0f, g_lp_in = g.last_pdf;

  // forward values of the BSDF, needed before Russian roulette's adjoint
  float brdf[4], bfac = 0.0f, eta2v = 1.0f;
  float xh = 0.0f, yh = 0.0f, zh = 0.0f, bpm = 1.0f;
  V3 up = vzero(), c1 = vzero(), tangent = vzero(), bd = vzero();
  if (mat == DIFFUSE) {
    gets(tr, r, m[4], brdf);
    for (int j = 0; j < 4; ++j) brdf[j] = brdf[j] * INV_PI;
    const float r_h = sqrtf(fmaxf(rec.u_h, 0.0f));
    const float th = TWO_PI * rec.v_h;
    xh = r_h * cosf(th);
    yh = r_h * sinf(th);
    zh = sqrtf(fmaxf(0.0f, 1.0f - rec.u_h));
    const bool z_minor = fabsf(n.z) < 0.999f;
    up = {z_minor ? 0.0f : 1.0f, 0.0f, z_minor ? 1.0f : 0.0f};
    c1 = vcross(up, n);
    tangent = vnormalize(c1);
    const V3 bitangent = vcross(n, tangent);
    bd = {tangent.x * xh + bitangent.x * yh + n.x * zh,
          tangent.y * xh + bitangent.y * yh + n.y * zh,
          tangent.z * xh + bitangent.z * yh + n.z * zh};
    bpm = fmaxf(zh * INV_PI, 1e-12f);
    bfac = fabsf(vdot(n, bd)) / bpm;
    for (int j = 0; j < 4; ++j) beta_m[j] = rec.beta_bl[j] * brdf[j] * bfac;
  } else if (mat == GLASS) {
    const float eta = vdot(n, cin.d) > 0.0f ? ETA_OUT : ETA_IN;
    eta2v = eta * eta;
    for (int j = 0; j < 4; ++j)
      beta_m[j] = rec.choose_refl ? rec.beta_bl[j] : rec.beta_bl[j] * eta2v;
    if (!rec.choose_refl) es_m = cin.eta_scale / eta2v;
  } else {
    for (int j = 0; j < 4; ++j) beta_m[j] = rec.beta_bl[j];
  }

  // ---- Russian roulette: beta_out = beta_m / max(1 - q, 1e-12)
  float g_bm[4];
  float g_esm = g.eta_scale;
  for (int j = 0; j < 4; ++j) g_bm[j] = g.beta[j];
  if (rec.rr_surv) {
    const float rc[3] = {beta_m[0] * es_m, beta_m[1] * es_m, beta_m[2] * es_m};
    const float m12 = fmaxf(rc[1], rc[2]);
    const float max_c = fmaxf(rc[0], m12);
    const float q = fmaxf(0.0f, 1.0f - max_c);
    const float omq = 1.0f - q;
    const float inv1q = 1.0f / fmaxf(omq, 1e-12f);
    float g_inv = 0.0f;
    for (int j = 0; j < 4; ++j) {
      g_inv += g.beta[j] * beta_m[j];
      g_bm[j] = g.beta[j] * inv1q;
    }
    const float g_om = omq >= 1e-12f ? -g_inv * inv1q * inv1q : 0.0f;
    const float g_maxc = (1.0f - max_c) >= 0.0f ? g_om : 0.0f;  // -(-g_om)
    // torch.maximum: an even split at a tie
    const float g_r0 = rc[0] > m12 ? g_maxc : (rc[0] == m12 ? g_maxc / 2.0f : 0.0f);
    const float g_m12 = rc[0] < m12 ? g_maxc : (rc[0] == m12 ? g_maxc / 2.0f : 0.0f);
    const float g_r1 = rc[1] > rc[2] ? g_m12 : (rc[1] == rc[2] ? g_m12 / 2.0f : 0.0f);
    const float g_r2 = rc[1] < rc[2] ? g_m12 : (rc[1] == rc[2] ? g_m12 / 2.0f : 0.0f);
    const float g_rc[3] = {g_r0, g_r1, g_r2};
    for (int k = 0; k < 3; ++k) {
      g_bm[k] += g_rc[k] * es_m;
      g_esm += g_rc[k] * beta_m[k];
    }
  }

  if (mat == DIFFUSE) {
    float g_brdf[4];
    g_lp_in = 0.0f;  // last_pdf_out = bounce_pdf, a function of the draws
    g_es_in = g_esm;
    // cosine hemisphere: beta_m = (beta_bl * brdf) * bfac, d_out = bd
    const float cos_dot = vdot(n, bd);
    float g_bfac = 0.0f;
    for (int j = 0; j < 4; ++j) {
      const float bb = rec.beta_bl[j] * brdf[j];
      const float g_bb = g_bm[j] * bfac;
      g_bfac += g_bm[j] * bb;
      g_bl[j] = g_bb * brdf[j];
      g_brdf[j] = g_bb * rec.beta_bl[j];
    }
    const float g_cd = sgnf(cos_dot) * (g_bfac / bpm);
    vacc(g_nrm, vscale(g_cd, bd));
    const V3 g_bd = vadd(g.d, vscale(g_cd, n));
    V3 g_tan = vscale(xh, g_bd);
    const V3 g_bit = vscale(yh, g_bd);
    vacc(g_nrm, vscale(zh, g_bd));
    vacc(g_nrm, vcross(tangent, g_bit));
    vacc(g_tan, vcross(g_bit, n));
    vacc(g_nrm, vcross(normalize_bwd(c1, g_tan), up));
    // NEE: L += (brdf * (l_emis * scale)) * beta_bl
    contrib_init(cB, -1);
    if (rec.unocc) {
      const int li = rec.li;
      const int sl = s.light_slot[li];
      contrib_init(cB, sl);
      const Hit& sh = rec.sh;
      const V3 vv = vsub(nee_target(s, li, rec.u_p, rec.v_p), h.pos);
      const V3 ldir = vnormalize(vv);
      const float cos_dot = vdot(n, ldir);
      const float cos_t = fmaxf(0.0f, cos_dot);
      const float pdf_l = light_pdf(s, li, tr.n_lights, sh.nrm, ldir, sh.pos, h.pos);
      const float pdf_b = cos_t * INV_PI;
      const float w_l = power_heuristic(pdf_l, pdf_b);
      const float pm = fmaxf(pdf_l, 1e-12f);
      const float cw = cos_t * w_l;
      const float scale = cw / pm;
      const int erow = s.meta[sl * META + 3];
      float l_emis[4];
      gets(tr, r, erow, l_emis);
      float g_scale = 0.0f;
      for (int j = 0; j < 4; ++j) {
        const float nee = l_emis[j] * scale;
        const float bn = brdf[j] * nee;
        const float g_bn = g.L[j] * rec.beta_bl[j];
        g_bl[j] += g.L[j] * bn;
        g_brdf[j] += g_bn * nee;
        const float g_nee = g_bn * brdf[j];
        dspect(erow, j, g_nee * scale);
        g_scale += g_nee * l_emis[j];
      }
      float g_pdfl = 0.0f, g_pdfb = 0.0f;
      if (pdf_l >= 1e-12f) g_pdfl += div_other(g_scale, cw, pm);
      const float g_cw = g_scale / pm;
      float g_cos = g_cw * w_l;
      ph_bwd(pdf_l, pdf_b, g_cw * cos_t, g_pdfl, g_pdfb);
      g_cos += g_pdfb * INV_PI;
      V3 g_ldir = vzero();
      if (cos_dot >= 0.0f) {
        vacc(g_nrm, vscale(g_cos, ldir));
        g_ldir = vscale(g_cos, n);
      }
      V3 g_shn = vzero(), g_shp = vzero();
      light_pdf_bwd(s, li, tr.n_lights, sh.nrm, ldir, sh.pos, h.pos, g_pdfl,
                    g_shn, g_ldir, g_shp, g_pos, cB);
      hit_bwd<TRI>(s, sh, h.pos, ldir, g_shp, g_shn, g_pos, g_ldir, cB);
      const V3 g_v = normalize_bwd(vv, g_ldir);
      g_pos = vsub(g_pos, g_v);
      contrib_add3(cB, 0, g_v);
      contrib_add3(cB, 3, vscale(rec.u_p, g_v));
      contrib_add3(cB, 6, vscale(rec.v_p, g_v));
    }
    for (int j = 0; j < 4; ++j) dspect(m[4], j, g_brdf[j] * INV_PI);
  } else if (mat == GLASS) {
    g_es_in = rec.choose_refl ? g_esm : g_esm / eta2v;
    for (int j = 0; j < 4; ++j)
      g_bl[j] = rec.choose_refl ? g_bm[j] : g_bm[j] * eta2v;
    const V3 d = cin.d;
    const bool flip = vdot(n, d) > 0.0f;
    const float eta = flip ? ETA_OUT : ETA_IN;
    const V3 ng = flip ? V3{-n.x, -n.y, -n.z} : n;
    V3 g_ng = vzero();
    if (rec.choose_refl) {
      reflect_bwd(d, ng, g.d, g_d, g_ng);
    } else {
      const float ndoti = vdot(ng, d);
      const float kk = 1.0f - eta * eta * (1.0f - ndoti * ndoti);
      if (!(kk < 0.0f)) {  // total internal reflection: d_out = 0
        const float sqk = sqrtf(kk);
        const float mm = eta * ndoti + sqk;
        const V3 rft = vsub(vscale(eta, d), vscale(mm, ng));
        const V3 g_rft = normalize_bwd(rft, g.d);
        vacc(g_d, vscale(eta, g_rft));
        const float g_mm = -vdot(g_rft, ng);
        vacc(g_ng, vscale(-mm, g_rft));
        float g_ndoti = g_mm * eta;
        const float g_kk = g_mm / (2.0f * sqk);
        const float g_w = -g_kk * (eta * eta);
        g_ndoti += 2.0f * ndoti * (-g_w);
        vacc(g_ng, vscale(g_ndoti, d));
        vacc(g_d, vscale(g_ndoti, ng));
      }
    }
    vacc(g_nrm, flip ? vscale(-1.0f, g_ng) : g_ng);
  } else {  // mirror
    g_es_in = g_esm;
    for (int j = 0; j < 4; ++j) g_bl[j] = g_bm[j];
    reflect_bwd(cin.d, n, g.d, g_d, g_nrm);
  }

  // ---- Beer-Lambert: beta_bl = beta_in * exp(-ext * dist)
  if (cin.in_trans) {
    float ext[4];
    gets(tr, r, tr.S - 1, ext);
    const V3 diffp = vsub(h.pos, cin.o);
    const float dsq = vdot(diffp, diffp);
    const float sq = sqrtf(dsq > 0.0f ? dsq : 1.0f);
    const float dist = sq * (dsq > 0.0f ? 1.0f : 0.0f);
    float g_dist = 0.0f;
    for (int j = 0; j < 4; ++j) {
      const float e = expf(-ext[j] * dist);
      const float g_x = (g_bl[j] * cin.beta[j]) * e;
      g.beta[j] = g_bl[j] * e;
      dspect(tr.S - 1, j, -(g_x * dist));
      g_dist += g_x * (-ext[j]);
    }
    if (dsq > 0.0f) {
      const V3 g_diff = vscale(2.0f * (g_dist / (2.0f * sq)), diffp);
      vacc(g_pos, g_diff);
      g_o = vsub(g_o, g_diff);
    }
  } else {
    for (int j = 0; j < 4; ++j) g.beta[j] = g_bl[j];
  }

  hit_bwd<TRI>(s, h, cin.o, cin.d, g_pos, g_nrm, g_o, g_d, cA);
  g.o = g_o;
  g.d = g_d;
  g.last_pdf = g_lp_in;
  g.eta_scale = g_es_in;
}

__device__ __forceinline__ void add_contrib(float* __restrict__ acc,
                                            const Contrib& c) {
  if (c.slot < 0) return;
  for (int k = 0; k < NC; ++k) acc[c.slot * 12 + k] += c.v[k];
}

// One thread's ray: the reverse sweep over the tape rows
// [0, n_live), warp-uniform so that the warp can add its d_prims
// contributions in lane order into its table acc. Writes d_rays; d_spect's
// column must be zero on entry. Every thread of the warp must call it.
// MESH: the scan mode of the recompute, MESH_ROWS for a scene with
// triangle rows (no mesh part reaches a backward kernel), so that it scans
// them as the forward did. TIMED: the timed build, clk its clock.
template <int MESH, bool TIMED>
__device__ void reverse_sweep(const Scene& s, const Trace& tr, long long r,
                              bool valid, int n_live,
                              const float* __restrict__ tape_f,
                              const int* __restrict__ tape_i,
                              const float* __restrict__ dL,
                              float* __restrict__ d_rays,
                              float* __restrict__ d_spect,
                              float* __restrict__ acc,
                              SweepClock<TIMED>& clk) {
  const long long R = tr.R;
  const int lane = threadIdx.x & 31;
  Grad g;
  g.o = vzero();
  g.d = vzero();
  for (int j = 0; j < 4; ++j) {
    g.L[j] = valid ? dL[j * R + r] : 0.0f;
    g.beta[j] = 0.0f;
  }
  g.last_pdf = 0.0f;
  g.eta_scale = 0.0f;
  const int warp_live = __reduce_max_sync(FULL, n_live);
  for (int depth = warp_live - 1; depth >= 0; --depth) {
    Contrib cA, cB;
    cA.slot = -1;
    cB.slot = -1;
    long long l_tape = 0, l_rec = 0, l_scan = 0, l_dsp = 0;
    if (depth < n_live) {
      long long t0 = 0;
      if constexpr (TIMED) t0 = clock64();
      const Carry cin = tape_read(tape_f, tape_i, R, r, depth);
      if constexpr (TIMED) {
        const long long t1 = clock_after(cin.o.x + cin.d.x + cin.beta[0] +
                                         cin.eta_scale +
                                         (float)cin.seed[0] +
                                         (float)cin.exclude);
        l_tape = t1 - t0;
        t0 = t1;
      }
      Carry c = cin;
      BounceRec rec;
      bounce<true, MESH, false, TIMED>(s, tr, r, depth, c, &rec, nullptr,
                                       nullptr, &l_scan);
      if constexpr (TIMED) l_rec = clock64() - t0;
      bounce_bwd<MESH != MESH_NONE, TIMED>(s, tr, r, depth, cin, rec, g, cA,
                                           cB, d_spect, &l_dsp);
    }
    clk.mark(T_ADJOINT);
    clk.move(T_ADJOINT, T_TAPE, l_tape);
    clk.move(T_ADJOINT, T_RECOMP, l_rec);
    clk.move(T_RECOMP, T_SCAN, l_scan);
    clk.move(T_ADJOINT, T_DSPECT, l_dsp);
    unsigned pending = __ballot_sync(FULL, cA.slot >= 0 || cB.slot >= 0);
    while (pending) {
      const int l = __ffs(pending) - 1;
      if (lane == l) {
        add_contrib(acc, cA);
        add_contrib(acc, cB);
      }
      __syncwarp();
      pending &= pending - 1;
    }
    clk.mark(T_FOLD);
  }
  if (valid) {
    d_rays[0 * R + r] = g.o.x;
    d_rays[1 * R + r] = g.o.y;
    d_rays[2 * R + r] = g.o.z;
    d_rays[3 * R + r] = g.d.x;
    d_rays[4 * R + r] = g.d.y;
    d_rays[5 * R + r] = g.d.z;
  }
}

// This block's d_prims: the warp tables summed in a fixed order into its
// row of partial. Every thread of the block must call it.
__device__ void block_partial(const float* __restrict__ acc_all, int P12,
                              float* __restrict__ partial) {
  __syncthreads();
  for (int i = threadIdx.x; i < P12; i += blockDim.x) {
    float v = acc_all[i];
    for (int w = 1; w < WARPS; ++w) v = v + acc_all[w * P12 + i];
    partial[(long long)blockIdx.x * P12 + i] = v;
  }
}

constexpr int RED_THREADS = 256;

// d_prims[i] = sum over blocks of partial[b, i], in a fixed order.
__global__ void __launch_bounds__(RED_THREADS)
    reduce_partials(const float* __restrict__ partial, int n_blocks, int P12,
                    float* __restrict__ d_prims) {
  __shared__ float buf[RED_THREADS];
  const int i = blockIdx.x;
  float v = 0.0f;
  for (int b = threadIdx.x; b < n_blocks; b += RED_THREADS)
    v = v + partial[(long long)b * P12 + i];
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int stride = RED_THREADS / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) buf[threadIdx.x] = buf[threadIdx.x] + buf[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) d_prims[i] = buf[0];
}


// Launches reduce_partials after a backward kernel; returns the CUDA error.
inline int finish_d_prims(const float* partial, unsigned blocks, int n_prims,
                          float* d_prims, cudaStream_t st) {
  reduce_partials<<<n_prims * 12, RED_THREADS, 0, st>>>(partial, (int)blocks,
                                                        n_prims * 12, d_prims);
  return (int)cudaGetLastError();
}

// The reverse sweep over a tape (build_backward_from_tape): one thread per
// ray. Its live depth is the number of leading tape rows whose active word
// is set. The tape-fed kernel (megakernel_bwd_tape.cu) is this launch; the
// retrace kernel (megakernel_bwd.cu) is the taped forward's launch, then
// this one. partial: (gridDim.x, P * 12) scratch for block_partial.
// TIMED: the timed build, which adds each section's cycles to times.
template <int MESH, bool TIMED>
__global__ void __launch_bounds__(THREADS, 4)
    sweep_kernel(const float* __restrict__ prims, const int* __restrict__ meta,
                 int P, const int* __restrict__ lights, int n_lights,
                 const float* __restrict__ spect, int S,
                 const float* __restrict__ tape_f,
                 const int* __restrict__ tape_i, const float* __restrict__ dL,
                 float* __restrict__ partial, float* __restrict__ d_rays,
                 float* __restrict__ d_spect, long long R, int max_depth,
                 int rr_start, unsigned long long* __restrict__ times) {
  SweepClock<TIMED> clk;
  clk.start();
  __shared__ Scene s;
  extern __shared__ float acc_all[];  // [WARPS][P * 12]
  const int P12 = P * 12;
  for (int i = threadIdx.x; i < WARPS * P12; i += blockDim.x) acc_all[i] = 0.0f;
  load_scene(s, prims, meta, P, lights, n_lights);

  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = r < R;
  const Trace tr = {P, n_lights, S, spect, R, max_depth, rr_start};

  clk.mark(T_OTHER);
  int n_live = 0;
  long long l_zero = 0;
  if (valid) {
    while (n_live <= max_depth &&
           tape_i[((long long)n_live * TAPE_I + 7) * R + r] != 0)
      ++n_live;
    long long t0 = 0;
    if constexpr (TIMED) t0 = clock64();
    for (int k = 0; k < S * 4; ++k) d_spect[(long long)k * R + r] = 0.0f;
    if constexpr (TIMED) l_zero = clock64() - t0;
  }
  clk.mark(T_TAPE);
  clk.move(T_TAPE, T_DSPECT, l_zero);
  reverse_sweep<MESH, TIMED>(s, tr, r, valid, n_live, tape_f, tape_i, dL,
                             d_rays, d_spect,
                             acc_all + (threadIdx.x >> 5) * P12, clk);
  block_partial(acc_all, P12, partial);
  clk.mark(T_OTHER);
  clk.flush(times);
}

// Checks the arguments of a backward launch; cudaErrorInvalidValue or 0.
inline int check_bwd_args(int n_prims, int n_lights, int n_spectra,
                          long long n_rays, int max_depth) {
  if (n_prims < 1 || n_prims > MAX_PRIMS || n_lights < 1 ||
      n_lights > MAX_LIGHTS || n_spectra < 1 || n_rays < 1 || max_depth < 0 ||
      (n_rays + THREADS - 1) / THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <int MESH, bool TIMED>
int launch_sweep_as(unsigned blocks, size_t dyn, cudaStream_t st,
                    const float* prims, const int* meta, int n_prims,
                    const int* lights, int n_lights, const float* spect,
                    int n_spectra, const float* tape_f, const int* tape_i,
                    const float* dL, float* partial, float* d_rays,
                    float* d_spect, long long n_rays, int max_depth,
                    int rr_start, unsigned long long* times) {
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<MESH, TIMED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn);
  if (err != cudaSuccess) return (int)err;
  sweep_kernel<MESH, TIMED><<<blocks, THREADS, dyn, st>>>(
      prims, meta, n_prims, lights, n_lights, spect, n_spectra, tape_f, tape_i,
      dL, partial, d_rays, d_spect, n_rays, max_depth, rr_start, times);
  return (int)cudaGetLastError();
}

// The reverse sweep's launches on stream st: sweep_kernel in the build of
// the scene's mode (mesh_mode: triangle rows), timed when times is given,
// then reduce_partials into d_prims. Arguments as megakernel_bwd_tape's;
// returns the CUDA error code (0 on success).
inline int launch_sweep(const float* prims, const int* meta, int n_prims,
                        const int* lights, int n_lights, const float* spect,
                        int n_spectra, const float* tape_f, const int* tape_i,
                        const float* dL, float* d_prims, float* partial,
                        float* d_rays, float* d_spect, long long n_rays,
                        int max_depth, int rr_start, int mesh_mode,
                        unsigned long long* times, cudaStream_t st) {
  const unsigned blocks = (unsigned)((n_rays + THREADS - 1) / THREADS);
  const size_t dyn = (size_t)WARPS * n_prims * 12 * sizeof(float);
  const int err =
      (times ? (mesh_mode ? launch_sweep_as<MESH_ROWS, true>
                          : launch_sweep_as<MESH_NONE, true>)
             : (mesh_mode ? launch_sweep_as<MESH_ROWS, false>
                          : launch_sweep_as<MESH_NONE, false>))(
          blocks, dyn, st, prims, meta, n_prims, lights, n_lights, spect,
          n_spectra, tape_f, tape_i, dL, partial, d_rays, d_spect, n_rays,
          max_depth, rr_start, times);
  if (err) return err;
  return finish_d_prims(partial, blocks, n_prims, d_prims, st);
}

}  // namespace pathtrace
