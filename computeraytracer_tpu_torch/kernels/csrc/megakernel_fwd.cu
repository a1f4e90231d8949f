// Forward path-tracing megakernel for Hopper (sm_90a).
//
// Replaces computeraytracer_tpu/kernels/megakernel.py:897 build_forward in
// its plain mode (non-mesh scenes, untaped). One thread traces one ray to
// completion: up to max_depth+1 bounces of make_bounce (megakernel.py:467),
// each an in-order closest-hit scan over every primitive, next-event
// estimation with the power-heuristic MIS, diffuse / glass / mirror
// scattering with Beer-Lambert, Russian roulette, and masked pcg4d draws.
// The bounce itself lives in bounce.cuh, which the backward kernel shares.
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

#include "bounce.cuh"

namespace {

using namespace pathtrace;

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
  load_scene(s, prims, meta, P, lights, n_lights);

  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Trace tr = {P, n_lights, S, spect, R, max_depth, rr_start};
  Carry c = init_carry(rays, seeds, R, r);
  for (int depth = 0; depth <= max_depth; ++depth)
    if (!bounce<false>(s, tr, r, depth, c, nullptr)) break;
  for (int j = 0; j < 4; ++j) out[j * R + r] = c.L[j];
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
