// Tape-fed backward path-tracing megakernel for Hopper (sm_90a).
//
// Replaces computeraytracer_tpu/kernels/megakernel.py:1480
// build_backward_from_tape. Contract, over ray-minor (k, R) planes:
// prims (P, 12), spect (S*4, R), the tape of the taped forward
// (megakernel_fwd.cu megakernel_fwd_taped: tape_f ((max_depth+1) * 16, R)
// f32, tape_i ((max_depth+1) * 8, R) i32), dL (4, R) -> d_prims (P, 12)
// summed over every ray, d_rays (6, R), d_spect (S*4, R).
//
// It is one launch of the reverse sweep (reverse.cuh sweep_kernel), then
// the fixed-order sum of the blocks' d_prims rows. The retrace kernel
// (megakernel_bwd.cu) launches the same sweep after its replay, so on the
// same tape the two kernels give bit-equal cotangents. A thread's live
// depth is the number of leading tape rows whose active word is set;
// d_rays is the cotangent of the depth-0 row, whose o and d are the input
// rays.
//
// What bounds it on this card: divergent per-thread control flow and
// registers (each live bounce is recomputed from its row, its scans
// included, then its adjoint applied), plus reading the tape: 96 B per row
// per ray of the rows it sweeps, at most 864 B per ray at depth 8. The
// design against it is reverse.cuh's.
//
// Triangle rows: the MESH_ROWS build (no part walked) for a scene with
// category-2 rows, the MESH_NONE build for every other scene.
//
// Numerics: built with --fmad=false, like the forward, so the recomputed
// decisions are the forward's bit for bit.

#include "reverse.cuh"

using namespace pathtrace;

// partial: (ceil(n_rays / 128), n_prims * 12) scratch; mesh_mode: the scene
// has triangle rows. Returns the CUDA error code of the launches (0 on
// success).
extern "C" int megakernel_bwd_tape(const float* prims, const int* meta,
                                   int n_prims, const int* lights,
                                   int n_lights, const float* spect,
                                   int n_spectra, const float* tape_f,
                                   const int* tape_i, const float* dL,
                                   float* d_prims, float* partial,
                                   float* d_rays, float* d_spect,
                                   long long n_rays, int max_depth,
                                   int rr_start, int mesh_mode, void* stream) {
  const int err =
      check_bwd_args(n_prims, n_lights, n_spectra, n_rays, max_depth);
  if (err) return err;
  return launch_sweep(prims, meta, n_prims, lights, n_lights, spect,
                      n_spectra, tape_f, tape_i, dL, d_prims, partial, d_rays,
                      d_spect, n_rays, max_depth, rr_start, mesh_mode, nullptr,
                      (cudaStream_t)stream);
}

// megakernel_bwd_tape in its timed build: the same outputs, and each
// section's clock64() cycles summed over warps added to times (T_KINDS
// zeroed counters, reverse.cuh).
extern "C" int megakernel_bwd_tape_timed(const float* prims, const int* meta,
                                         int n_prims, const int* lights,
                                         int n_lights, const float* spect,
                                         int n_spectra, const float* tape_f,
                                         const int* tape_i, const float* dL,
                                         float* d_prims, float* partial,
                                         float* d_rays, float* d_spect,
                                         long long n_rays, int max_depth,
                                         int rr_start, int mesh_mode,
                                         unsigned long long* times,
                                         void* stream) {
  const int err =
      check_bwd_args(n_prims, n_lights, n_spectra, n_rays, max_depth);
  if (err) return err;
  return launch_sweep(prims, meta, n_prims, lights, n_lights, spect,
                      n_spectra, tape_f, tape_i, dL, d_prims, partial, d_rays,
                      d_spect, n_rays, max_depth, rr_start, mesh_mode, times,
                      (cudaStream_t)stream);
}
