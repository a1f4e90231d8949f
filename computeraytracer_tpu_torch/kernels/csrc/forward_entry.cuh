// What the forward's entry points share beside the bodies of forward.cuh:
// the check of their arguments, the records of the global-table build, the
// start of its entry points and its launch grid. Only megakernel_fwd.cu,
// megakernel_fwd_xyz.cu and megakernel_fwd_wide_mesh.cu include it; the
// retrace backward (megakernel_bwd.cu) includes forward.cuh alone, so that
// its library compiles none of these.

#pragma once

#include "forward.cuh"

namespace {

using namespace pathtrace;

// The arguments every forward entry point checks: the rows (at most
// max_prims), lights, spectra, rays and depth.
int check_args(int n_prims, int n_lights, int n_spectra, long long n_rays,
               int max_depth, int max_prims = MAX_PRIMS) {
  if (n_prims < 0 || n_prims > max_prims || n_lights < 1 ||
      n_lights > MAX_LIGHTS || n_spectra < 1 || n_rays < 0 || max_depth < 0 ||
      (n_rays + THREADS - 1) / THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The records of the global-table build, one thread per slot: the
// primitive row's vectors, and the plane constants load_scene computes,
// in its op order, beside the slot's row and category.
__global__ void wide_tables_kernel(const float* __restrict__ prims,
                                   const int* __restrict__ meta, int P,
                                   float* __restrict__ rec) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= P) return;
  const float* p = prims + (long long)slot * 12;
  const int cat = meta[slot * META + 1];
  const V3 d1 = {p[0], p[1], p[2]}, d2 = {p[3], p[4], p[5]},
           d3 = {p[6], p[7], p[8]};
  V3 n0 = {0.0f, 0.0f, 0.0f};
  float inv_e1 = 0.0f, inv_e2 = 0.0f;
  if (cat != 1)
    slot_frame(cat == 2 ? vsub(d2, d1) : d2, cat == 2 ? vsub(d3, d1) : d3,
               n0, inv_e1, inv_e2);
  float4* out = reinterpret_cast<float4*>(rec) + (long long)slot * 4;
  out[0] = make_float4(d1.x, d1.y, d1.z, __int_as_float(meta[slot * META]));
  out[1] = make_float4(d2.x, d2.y, d2.z, inv_e1);
  out[2] = make_float4(d3.x, d3.y, d3.z, inv_e2);
  out[3] = make_float4(n0.x, n0.y, n0.z, __int_as_float(cat));
}

// The start of the global-table entry points (megakernel_fwd_wide,
// megakernel_fwd_wide_mesh): the check of their arguments, then on st the
// launch of wide_tables_kernel, which writes the n_prims slot records into
// rec. Returns a CUDA error code, or -1 where there is no ray and nothing
// was launched.
inline int wide_start(const float* prims, const int* meta, int n_prims,
                      int n_lights, int n_spectra, long long n_rays,
                      int max_depth, float* rec,
                      const unsigned long long* next_ray, cudaStream_t st) {
  const int err = check_args(n_prims, n_lights, n_spectra, n_rays, max_depth,
                             0x7fffffff / REC_WORDS);
  if (err) return err;
  if (!rec || !next_ray || n_prims < 1) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return -1;
  wide_tables_kernel<<<(n_prims + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      prims, meta, n_prims, rec);
  return (int)cudaGetLastError();
}

// The resident grid of a global-table kernel (refill_fwd_wide or
// refill_fwd_wide_xyz), with the smallest shared-memory carveout (set once
// per device), so that L1 holds as much of the records as it can.
template <typename Kernel>
cudaError_t wide_grid(Kernel kernel, long long (&resident)[MAX_DEVICES],
                      long long R, unsigned* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= 0 && dev < MAX_DEVICES &&
      resident[dev] == 0)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 0);
  if (err != cudaSuccess) return err;
  return resident_grid(kernel, resident, R, blocks);
}

}  // namespace
