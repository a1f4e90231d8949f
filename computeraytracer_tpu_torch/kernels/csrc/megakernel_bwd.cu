// Backward path-tracing megakernel for Hopper (sm_90a).
//
// Replaces computeraytracer_tpu/kernels/megakernel.py:1314 build_backward.
// Contract, over ray-minor (k, R) planes: prims (P, 12), rays (6, R),
// seeds (4, R), spect (S*4, R), dL (4, R) -> d_prims (P, 12) summed over
// every ray, d_rays (6, R), d_spect (S*4, R). It computes what jax.vjp of
// make_bounce computes (megakernel.py:1410-1417), bounce by bounce:
//
// - Phase A, replay: one thread runs its ray's forward bounce loop
//   (bounce.cuh, the forward kernel's own code) and writes each bounce's
//   INPUT carry to a tape in device memory, (max_depth+1, 16, R) f32
//   (o3 d3 L4 beta4 last_pdf eta_scale) and (max_depth+1, 8, R) i32 (seed
//   words, exclude, specular, in_trans, active): the layout of
//   build_forward(taped="full"). Rows after the ray died hold its final
//   carry with active = 0.
// - Phase B, reverse sweep (reverse.cuh, shared with the tape-fed kernel
//   megakernel_bwd_tape.cu): from the last live bounce down to 0,
//   recompute the bounce from its tape row, then apply the hand-written
//   adjoint. What is left in d_o, d_d at depth 0 is d_rays.
//
// What bounds it on this card: like the forward, divergent per-thread
// control flow and registers (the recomputed intermediates of a whole
// bounce are live during its adjoint), plus the tape's traffic: 96 B per
// bounce written and read back per ray.
//
// What the design does about it:
// - The tape lives in device memory, not in per-thread local arrays: its
//   depth is a runtime value and the layout is the one the tape-fed
//   backward reads.
// - d_spect and d_prims are summed in a fixed order (reverse.cuh): two runs
//   give bit-equal gradients.
//
// Triangle rows: a scene whose unrolled rows include triangles (category
// 2; a mesh part never reaches this kernel, its gradient is the guided
// replay's) runs the MESH_ROWS build, which walks no part, whose replay and
// recompute scan them with the watertight test as the forward does and
// whose adjoint carries a triangle winner's cotangent into its vertices
// (reverse.cuh hit_bwd). Every other scene runs the MESH_NONE build, which
// compiles none of that. The MESH_ROWS build is held to 4 resident blocks
// per SM (128 registers, a few spilled): at its own 165 registers only 3
// fit, and it ran 12% slower.
//
// Numerics: built with --fmad=false, like the forward, so the replay's
// hit winners, Fresnel choices and Russian-roulette decisions are the
// forward's bit for bit.

#include "reverse.cuh"

namespace {

using namespace pathtrace;

template <int MESH>
__global__ void __launch_bounds__(THREADS, MESH == MESH_ROWS ? 4 : 1)
    megakernel_bwd_kernel(const float* __restrict__ prims,
                          const int* __restrict__ meta, int P,
                          const int* __restrict__ lights, int n_lights,
                          const float* __restrict__ rays,
                          const int* __restrict__ seeds,
                          const float* __restrict__ spect, int S,
                          const float* __restrict__ dL,
                          float* __restrict__ partial,
                          float* __restrict__ d_rays,
                          float* __restrict__ d_spect,
                          float* __restrict__ tape_f, int* __restrict__ tape_i,
                          long long R, int max_depth, int rr_start) {
  __shared__ Scene s;
  extern __shared__ float acc_all[];  // [WARPS][P * 12]
  const int P12 = P * 12;
  for (int i = threadIdx.x; i < WARPS * P12; i += blockDim.x) acc_all[i] = 0.0f;
  load_scene(s, prims, meta, P, lights, n_lights);

  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = r < R;
  const Trace tr = {P, n_lights, S, spect, R, max_depth, rr_start};

  // ---- phase A: replay, taping each bounce's input carry
  int n_live = 0;
  if (valid) {
    Carry c = init_carry(rays, seeds, R, r);
    bool alive = true;
    for (int depth = 0; depth <= max_depth; ++depth) {
      tape_write(tape_f, tape_i, R, r, depth, c, alive);
      if (alive) {
        n_live = depth + 1;
        alive = bounce<false, MESH>(s, tr, r, depth, c, nullptr);
      }
    }
    for (int k = 0; k < S * 4; ++k) d_spect[(long long)k * R + r] = 0.0f;
  }

  // ---- phase B: the reverse sweep (reverse.cuh)
  reverse_sweep<MESH>(s, tr, r, valid, n_live, tape_f, tape_i, dL, d_rays,
                      d_spect, acc_all + (threadIdx.x >> 5) * P12);
  block_partial(acc_all, P12, partial);
}

template <int MESH>
int launch_bwd(unsigned blocks, size_t dyn, cudaStream_t st,
               const float* prims, const int* meta, int n_prims,
               const int* lights, int n_lights, const float* rays,
               const int* seeds, const float* spect, int n_spectra,
               const float* dL, float* partial, float* d_rays, float* d_spect,
               float* tape_f, int* tape_i, long long n_rays, int max_depth,
               int rr_start) {
  cudaError_t err = cudaFuncSetAttribute(
      megakernel_bwd_kernel<MESH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn);
  if (err != cudaSuccess) return (int)err;
  megakernel_bwd_kernel<MESH><<<blocks, THREADS, dyn, st>>>(
      prims, meta, n_prims, lights, n_lights, rays, seeds, spect, n_spectra,
      dL, partial, d_rays, d_spect, tape_f, tape_i, n_rays, max_depth,
      rr_start);
  return (int)cudaGetLastError();
}

}  // namespace

// partial: (ceil(n_rays / 128), n_prims * 12) scratch; tape_f
// ((max_depth+1) * 16, n_rays) and tape_i ((max_depth+1) * 8, n_rays)
// scratch; mesh_mode: the scene has triangle rows. Returns the CUDA error
// code of the launches (0 on success).
extern "C" int megakernel_bwd(const float* prims, const int* meta, int n_prims,
                              const int* lights, int n_lights,
                              const float* rays, const int* seeds,
                              const float* spect, int n_spectra,
                              const float* dL, float* d_prims, float* partial,
                              float* d_rays, float* d_spect, float* tape_f,
                              int* tape_i, long long n_rays, int max_depth,
                              int rr_start, int mesh_mode, void* stream) {
  if (n_prims < 1 || n_prims > MAX_PRIMS || n_lights < 1 ||
      n_lights > MAX_LIGHTS || n_spectra < 1 || n_rays < 1 || max_depth < 0 ||
      (n_rays + THREADS - 1) / THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n_rays + THREADS - 1) / THREADS);
  const size_t dyn = (size_t)WARPS * n_prims * 12 * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  const int err =
      (mesh_mode ? launch_bwd<MESH_ROWS> : launch_bwd<MESH_NONE>)(
          blocks, dyn, st, prims, meta, n_prims, lights, n_lights, rays,
          seeds, spect, n_spectra, dL, partial, d_rays, d_spect, tape_f,
          tape_i, n_rays, max_depth, rr_start);
  if (err) return err;
  return finish_d_prims(partial, blocks, n_prims, d_prims, st);
}
