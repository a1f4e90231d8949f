// Backward path-tracing megakernel for Hopper (sm_90a).
//
// Replaces computeraytracer_tpu/kernels/megakernel.py:1314 build_backward.
// Contract, over ray-minor (k, R) planes: prims (P, 12), rays (6, R),
// seeds (4, R), spect (S*4, R), dL (4, R) -> d_prims (P, 12) summed over
// every ray, d_rays (6, R), d_spect (S*4, R). It computes what jax.vjp of
// make_bounce computes (megakernel.py:1410-1417), bounce by bounce.
//
// Two launches on the caller's stream, with no host synchronisation
// between them:
// - the replay: the taped="full" forward's own launch (forward.cuh
//   taped_launch, which megakernel_fwd_taped calls: the refill schedule on
//   triangle rows, the group schedule otherwise) writes each bounce's
//   INPUT carry to the tape, (max_depth+1, 16, R) f32 (o3 d3 L4 beta4
//   last_pdf eta_scale) and (max_depth+1, 8, R) i32 (seed words, exclude,
//   specular, in_trans, active); rows after the ray died hold its final
//   carry with active = 0.
//   Its radiance goes to d_rays' first four planes, which the sweep then
//   overwrites;
// - the reverse sweep (reverse.cuh sweep_kernel), the tape-fed kernel's
//   own launch (megakernel_bwd_tape.cu): from the last live bounce down to
//   0, recompute the bounce from its tape row, then apply the hand-written
//   adjoint. What is left in d_o, d_d at depth 0 is d_rays.
// So the retrace kernel is the taped forward followed by the tape-fed
// kernel, bit for bit.
//
// What bounds it on this card: the replay is the forward's work (divergent
// per-thread control flow, registers) plus writing the tape, 96 B per
// bounce per ray; the sweep is bound as the tape-fed kernel is.
//
// What the design does about it: the replay runs at the forward's own
// register budget and occupancy, not at the sweep's. One kernel for both
// phases would run the replay at the larger budget of the two, with fewer
// resident blocks, and would keep nothing on chip between them: the tape
// goes through device memory either way. The tape is backward()'s
// scratch, or the caller's tape= buffers, so the two launches allocate
// nothing more than one would (but the replay's ray counter: 8 bytes).
//
// Triangle rows: a scene whose unrolled rows include triangles (category
// 2; a mesh part never reaches this kernel, its gradient is the guided
// replay's) runs the MESH_ROWS builds of both launches, which walk no
// part; the sweep's adjoint carries a triangle winner's cotangent into its
// vertices (reverse.cuh hit_bwd). Every other scene runs the MESH_NONE
// builds, which compile none of that.
//
// Numerics: built with --fmad=false, like the forward, so the replay's
// hit winners, Fresnel choices and Russian-roulette decisions are the
// forward's bit for bit.

#include "forward.cuh"
#include "reverse.cuh"

namespace {

using namespace pathtrace;

int bwd(const float* prims, const int* meta, int n_prims, const int* lights,
        int n_lights, const float* rays, const int* seeds, const float* spect,
        int n_spectra, const float* dL, float* d_prims, float* partial,
        float* d_rays, float* d_spect, float* tape_f, int* tape_i,
        long long n_rays, int max_depth, int rr_start, int mesh_mode,
        unsigned long long* next_ray, unsigned long long* times,
        void* stream) {
  const int err =
      check_bwd_args(n_prims, n_lights, n_spectra, n_rays, max_depth);
  if (err) return err;
  if (!next_ray) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t replay = taped_launch(
      prims, meta, n_prims, lights, n_lights, rays, seeds, spect, n_spectra,
      d_rays, tape_f, tape_i, n_rays, max_depth, rr_start, mesh_mode,
      next_ray, st);
  if (replay != cudaSuccess) return (int)replay;
  return launch_sweep(prims, meta, n_prims, lights, n_lights, spect,
                      n_spectra, tape_f, tape_i, dL, d_prims, partial, d_rays,
                      d_spect, n_rays, max_depth, rr_start, mesh_mode, times,
                      st);
}

}  // namespace

// partial: (ceil(n_rays / 128), n_prims * 12) scratch; tape_f
// ((max_depth+1) * 16, n_rays) and tape_i ((max_depth+1) * 8, n_rays)
// scratch; mesh_mode: the scene has triangle rows; next_ray: the replay's
// ray counter, one zeroed u64. Returns the CUDA error code of the launches
// (0 on success).
extern "C" int megakernel_bwd(const float* prims, const int* meta, int n_prims,
                              const int* lights, int n_lights,
                              const float* rays, const int* seeds,
                              const float* spect, int n_spectra,
                              const float* dL, float* d_prims, float* partial,
                              float* d_rays, float* d_spect, float* tape_f,
                              int* tape_i, long long n_rays, int max_depth,
                              int rr_start, int mesh_mode,
                              unsigned long long* next_ray, void* stream) {
  return bwd(prims, meta, n_prims, lights, n_lights, rays, seeds, spect,
             n_spectra, dL, d_prims, partial, d_rays, d_spect, tape_f, tape_i,
             n_rays, max_depth, rr_start, mesh_mode, next_ray, nullptr,
             stream);
}

// megakernel_bwd with the sweep's timed build: the same outputs, and each
// section's clock64() cycles summed over warps added to times (T_KINDS
// zeroed counters, reverse.cuh); the replay is the forward's own build and
// is timed as a launch.
extern "C" int megakernel_bwd_timed(const float* prims, const int* meta,
                                    int n_prims, const int* lights,
                                    int n_lights, const float* rays,
                                    const int* seeds, const float* spect,
                                    int n_spectra, const float* dL,
                                    float* d_prims, float* partial,
                                    float* d_rays, float* d_spect,
                                    float* tape_f, int* tape_i,
                                    long long n_rays, int max_depth,
                                    int rr_start, int mesh_mode,
                                    unsigned long long* next_ray,
                                    unsigned long long* times, void* stream) {
  return bwd(prims, meta, n_prims, lights, n_lights, rays, seeds, spect,
             n_spectra, dL, d_prims, partial, d_rays, d_spect, tape_f, tape_i,
             n_rays, max_depth, rr_start, mesh_mode, next_ray, times, stream);
}
