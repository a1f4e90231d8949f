// Tape-fed backward path-tracing megakernel for Hopper (sm_90a).
//
// Replaces computeraytracer_tpu/kernels/megakernel.py:1480
// build_backward_from_tape. Contract, over ray-minor (k, R) planes:
// prims (P, 12), spect (S*4, R), the tape of the taped forward
// (megakernel_fwd.cu megakernel_fwd_taped: tape_f ((max_depth+1) * 16, R)
// f32, tape_i ((max_depth+1) * 8, R) i32), dL (4, R) -> d_prims (P, 12)
// summed over every ray, d_rays (6, R), d_spect (S*4, R).
//
// It is the retrace kernel (megakernel_bwd.cu) without its phase A: the
// forward already wrote each bounce's input carry, so no bounce is traced
// twice. A thread's live depth is the number of leading tape rows whose
// active word is set; the reverse sweep is reverse.cuh, the retrace
// kernel's own code, so on the same tape the two kernels give bit-equal
// cotangents. d_rays is the cotangent of the depth-0 row, whose o and d
// are the input rays.
//
// What bounds it on this card: as the retrace kernel's phase B, divergent
// per-thread control flow and registers (each live bounce is recomputed
// from its row, then its adjoint applied), plus reading the tape: 96 B per
// row per ray of the rows it sweeps, at most 864 B per ray at depth 8.
//
// What the design does about it: the tape is read one row at a time, row
// by row from the last live one, with neighbouring threads on neighbouring
// addresses (ray-minor planes); d_prims and d_spect are summed in a fixed
// order (reverse.cuh).
//
// Triangle rows: as the retrace kernel, the MESH_ROWS build (no part
// walked) for a scene with category-2 rows, the MESH_NONE build for every
// other scene.
//
// Numerics: built with --fmad=false, like the forward, so the recomputed
// decisions are the forward's bit for bit.

#include "reverse.cuh"

namespace {

using namespace pathtrace;

template <int MESH>
__global__ void __launch_bounds__(THREADS)
    megakernel_bwd_tape_kernel(const float* __restrict__ prims,
                               const int* __restrict__ meta, int P,
                               const int* __restrict__ lights, int n_lights,
                               const float* __restrict__ spect, int S,
                               const float* __restrict__ tape_f,
                               const int* __restrict__ tape_i,
                               const float* __restrict__ dL,
                               float* __restrict__ partial,
                               float* __restrict__ d_rays,
                               float* __restrict__ d_spect, long long R,
                               int max_depth, int rr_start) {
  __shared__ Scene s;
  extern __shared__ float acc_all[];  // [WARPS][P * 12]
  const int P12 = P * 12;
  for (int i = threadIdx.x; i < WARPS * P12; i += blockDim.x) acc_all[i] = 0.0f;
  load_scene(s, prims, meta, P, lights, n_lights);

  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = r < R;
  const Trace tr = {P, n_lights, S, spect, R, max_depth, rr_start};

  int n_live = 0;
  if (valid) {
    while (n_live <= max_depth &&
           tape_i[((long long)n_live * TAPE_I + 7) * R + r] != 0)
      ++n_live;
    for (int k = 0; k < S * 4; ++k) d_spect[(long long)k * R + r] = 0.0f;
  }
  reverse_sweep<MESH>(s, tr, r, valid, n_live, tape_f, tape_i, dL, d_rays,
                      d_spect, acc_all + (threadIdx.x >> 5) * P12);
  block_partial(acc_all, P12, partial);
}

template <int MESH>
int launch_bwd_tape(unsigned blocks, size_t dyn, cudaStream_t st,
                    const float* prims, const int* meta, int n_prims,
                    const int* lights, int n_lights, const float* spect,
                    int n_spectra, const float* tape_f, const int* tape_i,
                    const float* dL, float* partial, float* d_rays,
                    float* d_spect, long long n_rays, int max_depth,
                    int rr_start) {
  cudaError_t err = cudaFuncSetAttribute(
      megakernel_bwd_tape_kernel<MESH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  megakernel_bwd_tape_kernel<MESH><<<blocks, THREADS, dyn, st>>>(
      prims, meta, n_prims, lights, n_lights, spect, n_spectra, tape_f, tape_i,
      dL, partial, d_rays, d_spect, n_rays, max_depth, rr_start);
  return (int)cudaGetLastError();
}

}  // namespace

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
  if (n_prims < 1 || n_prims > MAX_PRIMS || n_lights < 1 ||
      n_lights > MAX_LIGHTS || n_spectra < 1 || n_rays < 1 || max_depth < 0 ||
      (n_rays + THREADS - 1) / THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n_rays + THREADS - 1) / THREADS);
  const size_t dyn = (size_t)WARPS * n_prims * 12 * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  const int err =
      (mesh_mode ? launch_bwd_tape<MESH_ROWS> : launch_bwd_tape<MESH_NONE>)(
          blocks, dyn, st, prims, meta, n_prims, lights, n_lights, spect,
          n_spectra, tape_f, tape_i, dL, partial, d_rays, d_spect, n_rays,
          max_depth, rr_start);
  if (err) return err;
  return finish_d_prims(partial, blocks, n_prims, d_prims, st);
}
