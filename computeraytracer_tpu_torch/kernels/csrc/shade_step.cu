// Shade step of the binned wavefront for Hopper (sm_90a): one bounce per
// launch, with the mesh casts done outside it.
//
// Replaces computeraytracer_tpu/kernels/megakernel.py:1087 build_shade_step
// in both of its variants. The wavefront (tracer/kernel.py
// wavefront_forward) launches it once per bounce, with the binned casts
// (candidates.cu, pair.cu, and walk.cu for the rays they leave unresolved)
// casting the rays against the mesh parts in between. Per ray it:
// - reads the carry from (k, R) planes: carry_f (16) o, d, L, beta,
//   last_pdf, eta_scale; carry_u (4) the seed words' bits; carry_i (4)
//   exclude, specular, in_trans, active;
// - takes the closest hit over the unrolled rows: its own scan in the first
//   bounce's build (scan_in_kernel=True), else the un_f / un_i record that
//   the previous step wrote for this ray, with pos = o + t*d;
// - folds the mesh winner (mesh_f [t, n.xyz], mesh_i [idx]) into it under
//   the tie rule of megakernel.py:1177-1185, with pos = o + t*d;
// - runs bounce.cuh's bounce with deferred NEE: the shadow scan covers the
//   unrolled rows only, and instead of adding to L it writes the picked
//   light's planes of sh_f (the shadow origin, then per light [ldir xyz,
//   t_unrolled, contrib x4]) and sh_i (per light [idx_unrolled, lsel]), and
//   (-1, 0, +inf, 0...) for every other light; the caller adds contrib
//   unless a mesh part occludes the shadow ray (megakernel.py:633-679);
// - scans the unrolled rows on its output ray and writes the winner to
//   un_f' / un_i' for the next step and for the next main cast's bound
//   (megakernel.py:1211-1219);
// - writes tape_idx, the merged main winner, for the guided replay.
// A ray dead at entry writes its carry unchanged, tape_idx -1, empty NEE
// planes and un_f' = (+inf, 0, 0, 0), un_i' = -1: the TPU kernel's
// all-dead-tile branch (:1222-1230) per ray. A ray that dies in the bounce
// writes the empty un record too: no later step reads it.
//
// The arithmetic is the in-kernel bounce's, op for op (--fmad=false), so
// the wavefront's radiance is the mesh forward kernel's bit for bit.
//
// What bounds it: as the forward kernel, per-thread divergent control flow
// over a few hundred bytes per ray (24 carry words in and out, the spectra,
// the NEE planes), not bytes; two scans of the unrolled rows per live ray
// (the first build three), no mesh walk.

#include "bounce.cuh"

namespace {

using namespace pathtrace;

constexpr int CARRY_F = 16;

__device__ __forceinline__ Carry carry_read(const float* __restrict__ cf,
                                            const int* __restrict__ cu,
                                            const int* __restrict__ ci,
                                            long long R, long long r) {
  Carry c;
  c.o = {cf[0 * R + r], cf[1 * R + r], cf[2 * R + r]};
  c.d = {cf[3 * R + r], cf[4 * R + r], cf[5 * R + r]};
  for (int j = 0; j < 4; ++j) {
    c.L[j] = cf[(6 + j) * R + r];
    c.beta[j] = cf[(10 + j) * R + r];
    c.seed[j] = (uint32_t)cu[j * R + r];
  }
  c.last_pdf = cf[14 * R + r];
  c.eta_scale = cf[15 * R + r];
  c.exclude = ci[0 * R + r];
  c.specular = ci[1 * R + r] != 0;
  c.in_trans = ci[2 * R + r] != 0;
  return c;
}

__device__ __forceinline__ void carry_write(float* __restrict__ cf,
                                            int* __restrict__ cu,
                                            int* __restrict__ ci, long long R,
                                            long long r, const Carry& c,
                                            bool alive) {
  const float fw[CARRY_F] = {c.o.x, c.o.y, c.o.z, c.d.x, c.d.y, c.d.z,
                             c.L[0], c.L[1], c.L[2], c.L[3],
                             c.beta[0], c.beta[1], c.beta[2], c.beta[3],
                             c.last_pdf, c.eta_scale};
  for (int k = 0; k < CARRY_F; ++k) cf[k * R + r] = fw[k];
  for (int k = 0; k < 4; ++k) cu[k * R + r] = (int)c.seed[k];
  ci[0 * R + r] = c.exclude;
  ci[1 * R + r] = (int)c.specular;
  ci[2 * R + r] = (int)c.in_trans;
  ci[3 * R + r] = (int)alive;
}

// The packed slot of an unrolled row (its meta row), -1 for none.
__device__ __forceinline__ int row_slot(const Scene& s, int P, int row) {
  for (int slot = 0; slot < P; ++slot)
    if (s.meta[slot * META] == row) return slot;
  return -1;
}

// The slot P + part of a mesh triangle's row id. The parts are disjoint
// runs of rows in ascending order (SceneStatic.from_scene) and their meta
// rows hold their starts, so the triangle's part is the last one that
// starts at or before it.
__device__ __forceinline__ int part_slot(const Scene& s, int P, int idx) {
  int slot = -1;
  for (int pi = 0; pi < s.n_parts; ++pi)
    if (s.meta[(P + pi) * META] <= idx) slot = P + pi;
  return slot;
}

template <bool SCAN_IN>
__global__ void __launch_bounds__(THREADS)
    shade_step_kernel(const float* __restrict__ prims,
                      const int* __restrict__ meta, int P,
                      const int* __restrict__ lights, int n_lights,
                      const float* __restrict__ spect, int S,
                      const float* __restrict__ carry_f,
                      const int* __restrict__ carry_u,
                      const int* __restrict__ carry_i,
                      const float* __restrict__ mesh_f,
                      const int* __restrict__ mesh_i,
                      const float* __restrict__ un_f,
                      const int* __restrict__ un_i,
                      float* __restrict__ carry_f_out,
                      int* __restrict__ carry_u_out,
                      int* __restrict__ carry_i_out,
                      int* __restrict__ tape_idx, float* __restrict__ sh_f,
                      int* __restrict__ sh_i, float* __restrict__ un_f_out,
                      int* __restrict__ un_i_out, long long R, int depth,
                      int max_depth, int rr_start,
                      const __grid_constant__ MeshParts mp) {
  __shared__ Scene s;
  load_scene(s, prims, meta, P, lights, n_lights, &mp);
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Trace tr = {P, n_lights, S, spect, R, max_depth, rr_start};
  Carry c = carry_read(carry_f, carry_u, carry_i, R, r);
  DeferredNee dn;
  dn.li = -1;
  int hit_idx = -1;
  V3 sh_o = {0.0f, 0.0f, 0.0f};
  bool alive = false;
  if (carry_i[3 * R + r] != 0) {
    Hit h;
    if constexpr (SCAN_IN) {
      h = scan<MESH_ROWS>(s, P, c.o, c.d, c.exclude);
    } else {
      h.t = un_f[r];
      h.idx = un_i[r];
      h.slot = h.idx >= 0 ? row_slot(s, P, h.idx) : -1;
      h.pos = h.idx >= 0 ? vadd(c.o, vscale(h.t, c.d)) : V3{0.0f, 0.0f, 0.0f};
      h.nrm = {un_f[R + r], un_f[2 * R + r], un_f[3 * R + r]};
    }
    const float t_m = mesh_f[r];
    const int id_m = mesh_i[r];
    if (t_m < h.t || (t_m == h.t && id_m > h.idx)) {
      h.t = t_m;
      h.idx = id_m;
      h.slot = part_slot(s, P, id_m);
      h.pos = vadd(c.o, vscale(t_m, c.d));
      h.nrm = {mesh_f[R + r], mesh_f[2 * R + r], mesh_f[3 * R + r]};
    }
    hit_idx = h.idx;
    sh_o = h.pos;
    alive = bounce<false, MESH_ROWS, true>(s, tr, r, depth, c, nullptr, &h,
                                           &dn);
  }
  carry_write(carry_f_out, carry_u_out, carry_i_out, R, r, c, alive);
  tape_idx[r] = hit_idx;
  sh_f[r] = sh_o.x;
  sh_f[R + r] = sh_o.y;
  sh_f[2 * R + r] = sh_o.z;
  for (int l = 0; l < n_lights; ++l) {
    const bool picked = l == dn.li;
    float* f = sh_f + (3 + 8LL * l) * R + r;
    f[0] = picked ? dn.ldir.x : 0.0f;
    f[R] = picked ? dn.ldir.y : 0.0f;
    f[2 * R] = picked ? dn.ldir.z : 0.0f;
    f[3 * R] = picked ? dn.t_su : INFINITY;
    for (int j = 0; j < 4; ++j) f[(4 + j) * R] = picked ? dn.contrib[j] : 0.0f;
    sh_i[2LL * l * R + r] = picked ? dn.idx_su : -1;
    sh_i[(2LL * l + 1) * R + r] = (int)picked;
  }
  Hit nxt;
  nxt.t = INFINITY;
  nxt.idx = -1;
  nxt.nrm = {0.0f, 0.0f, 0.0f};
  if (alive) nxt = scan<MESH_ROWS>(s, P, c.o, c.d, c.exclude);
  un_f_out[r] = nxt.t;
  un_f_out[R + r] = nxt.nrm.x;
  un_f_out[2 * R + r] = nxt.nrm.y;
  un_f_out[3 * R + r] = nxt.nrm.z;
  un_i_out[r] = nxt.idx;
}

}  // namespace

// One bounce of the wavefront over n_rays rays (every array (k, n_rays),
// ray axis minor): carries, mesh winner and, when un_f is not null, the
// previous step's unrolled winner in; the next carries, tape_idx (n_rays),
// sh_f (3 + 8 * n_lights planes), sh_i (2 * n_lights) and the next unrolled
// winner out. meta holds n_prims slot rows, then n_parts part rows (their
// materials and spectra; the shade step walks no part). A null un_f
// selects the build that scans the unrolled rows itself (the first
// bounce). Returns the CUDA error code of the launch (0 on success).
extern "C" int shade_step(const float* prims, const int* meta, int n_prims,
                          const int* lights, int n_lights, const float* spect,
                          int n_spectra, const float* carry_f,
                          const int* carry_u, const int* carry_i,
                          const float* mesh_f, const int* mesh_i,
                          const float* un_f, const int* un_i,
                          float* carry_f_out, int* carry_u_out,
                          int* carry_i_out, int* tape_idx, float* sh_f,
                          int* sh_i, float* un_f_out, int* un_i_out,
                          long long n_rays, int depth, int max_depth,
                          int rr_start, int n_parts, void* stream) {
  if (n_prims < 0 || n_prims > MAX_PRIMS || n_lights < 1 ||
      n_lights > MAX_LIGHTS || n_spectra < 1 || n_rays < 0 || depth < 0 ||
      depth > max_depth || n_parts < 0 || n_parts > MAX_PARTS ||
      (un_f == nullptr) != (un_i == nullptr) ||
      (n_rays + THREADS - 1) / THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const MeshParts mp = make_parts(n_parts, nullptr, nullptr);
  const unsigned blocks = (unsigned)((n_rays + THREADS - 1) / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (un_f == nullptr)
    shade_step_kernel<true><<<blocks, THREADS, 0, st>>>(
        prims, meta, n_prims, lights, n_lights, spect, n_spectra, carry_f,
        carry_u, carry_i, mesh_f, mesh_i, nullptr, nullptr, carry_f_out,
        carry_u_out, carry_i_out, tape_idx, sh_f, sh_i, un_f_out, un_i_out,
        n_rays, depth, max_depth, rr_start, mp);
  else
    shade_step_kernel<false><<<blocks, THREADS, 0, st>>>(
        prims, meta, n_prims, lights, n_lights, spect, n_spectra, carry_f,
        carry_u, carry_i, mesh_f, mesh_i, un_f, un_i, carry_f_out,
        carry_u_out, carry_i_out, tape_idx, sh_f, sh_i, un_f_out, un_i_out,
        n_rays, depth, max_depth, rr_start, mp);
  return (int)cudaGetLastError();
}
