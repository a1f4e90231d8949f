// The forward with its XYZ epilogue, for serving (tracer/kernel.py
// render_accumulate's frame, kernels/megakernel.py forward_xyz).
//
// A served sample used to be the ray setup, the hero gather, the forward
// (megakernel_fwd.cu), which writes each ray's radiance (4, R), and torch
// glue around it: the rays concatenated into one (6, R) operand, the
// seeds copied to int32, the CIE sum over (3, R) planes (about nine
// elementwise launches) and the frame's accumulation. Every sample wrote
// its radiance and XYZ to device memory and read them back several times,
// to add three numbers into each pixel.
//
// These builds run the refill schedule, the bounce and the tables of
// megakernel_fwd.cu's untaped forward of a scene without mesh parts
// (forward.cuh refill_trace; plain or triangle rows; shared tables, or the
// global-table records past MAX_PRIMS rows), and change only its two ends:
// - a ray starts from the ray setup's outputs as they are, o and d as two
//   (3, R) planes and the seeds as int64 u32 values;
// - a ray that dies reads its 12 hero-gathered CIE values, forms X, Y and
//   Z as ops/spectrum.py spectral_to_xyz_p does, and adds them into the
//   frame's accumulator in place (forward.cuh xyz_add). A ray is traced by
//   one lane, so no other lane writes its pixel in the launch: no atomics.
// A sample is then three launches (ray setup, gather, this one); nothing
// of R rays but the accumulator is written after the gather.
//
// Numerics: built with --fmad=false like the rest, so each product, sum
// and the scale round on their own, as torch's separate kernels round
// them, and with the samples added in order the frame is the composition's
// bit for bit. The epilogue's reads sit where the radiance stores were:
// at a ray's retirement, scattered over the warp's lanes as those were.
//
// Its own source, so that nvcc compiles it beside megakernel_fwd.cu, in
// parallel (kernels/_build.py), and the build's wall time does not grow
// by its instantiations.

#include "forward_entry.cuh"

namespace {

using namespace pathtrace;

// The XYZ builds of the two refill kernels, for serving: the same
// schedule, bounce and tables, with the rays and seeds read from xf and
// each ray's XYZ added into xf.accum as it dies (refill_trace with XYZ).
// Their own names, so that a device trace shows them apart.
template <int MESH>
__global__ void __launch_bounds__(THREADS)
    refill_fwd_xyz(const float* __restrict__ prims,
                   const int* __restrict__ meta, int P,
                   const int* __restrict__ lights, int n_lights,
                   const __grid_constant__ XyzFrame xf,
                   const float* __restrict__ spect, int S, long long R,
                   int max_depth, int rr_start,
                   unsigned long long* __restrict__ next_ray) {
  __shared__ Scene s;
  load_scene(s, prims, meta, P, lights, n_lights);
  refill_trace<MESH, TAPE_NONE, false, true>(
      s, P, n_lights, nullptr, nullptr, spect, S, nullptr, nullptr, nullptr,
      R, max_depth, rr_start, next_ray, nullptr, xf);
}

template <int MESH>
__global__ void __launch_bounds__(THREADS)
    refill_fwd_wide_xyz(const float* __restrict__ rec,
                        const int* __restrict__ meta, int P,
                        const int* __restrict__ lights, int n_lights,
                        const __grid_constant__ XyzFrame xf,
                        const float* __restrict__ spect, int S, long long R,
                        int max_depth, int rr_start,
                        unsigned long long* __restrict__ next_ray) {
  __shared__ WideScene s;
  load_wide_scene(s, rec, meta, lights, n_lights);
  refill_trace<MESH, TAPE_NONE, false, true>(
      s, P, n_lights, nullptr, nullptr, spect, S, nullptr, nullptr, nullptr,
      R, max_depth, rr_start, next_ray, nullptr, xf);
}

// Launch an XYZ build on its resident grid: on the global tables rec
// (refill_fwd_wide_xyz) when WIDE, else on the shared tables of prims
// (refill_fwd_xyz). *next_ray must be 0.
template <int MESH, bool WIDE>
cudaError_t xyz_launch(const float* prims, const float* rec, const int* meta,
                       int P, const int* lights, int n_lights,
                       const XyzFrame& xf, const float* spect, int S,
                       long long R, int max_depth, int rr_start,
                       unsigned long long* next_ray, cudaStream_t st) {
  static long long resident[MAX_DEVICES] = {};
  unsigned blocks = 0;
  cudaError_t err;
  if constexpr (WIDE) {
    err = wide_grid(refill_fwd_wide_xyz<MESH>, resident, R, &blocks);
    if (err != cudaSuccess) return err;
    refill_fwd_wide_xyz<MESH><<<blocks, THREADS, 0, st>>>(
        rec, meta, P, lights, n_lights, xf, spect, S, R, max_depth, rr_start,
        next_ray);
  } else {
    err = resident_grid(refill_fwd_xyz<MESH>, resident, R, &blocks);
    if (err != cudaSuccess) return err;
    refill_fwd_xyz<MESH><<<blocks, THREADS, 0, st>>>(
        prims, meta, P, lights, n_lights, xf, spect, S, R, max_depth,
        rr_start, next_ray);
  }
  return cudaGetLastError();
}

}  // namespace

// The untaped forward of a scene without mesh parts with its XYZ epilogue
// (forward.cuh XyzFrame, xyz_add): the rays o and d (3, n_rays) f32, the
// seeds (4, n_rays) int64 u32 values, cie (12, n_rays) the rays'
// hero-gathered CIE values; each ray's XYZ times scale is added into accum
// (3, n_rays) f32 in place, and nothing else is written but the ray counter
// next_ray (one zeroed u64) and, past MAX_PRIMS rows, the records. rec
// null: the shared tables (at most MAX_PRIMS rows); else rec, n_prims *
// REC_WORDS f32, receives the slot records (wide_tables_kernel, launched
// first on the same stream) and the global-table build traces. mesh_mode:
// the scene has triangle rows.
extern "C" int megakernel_fwd_xyz(const float* prims, const int* meta,
                                  int n_prims, const int* lights,
                                  int n_lights, const float* o,
                                  const float* d, const long long* seeds,
                                  const float* spect, int n_spectra,
                                  const float* cie, float* accum, float scale,
                                  long long n_rays, int max_depth,
                                  int rr_start, int mesh_mode, float* rec,
                                  unsigned long long* next_ray,
                                  void* stream) {
  int err = check_args(n_prims, n_lights, n_spectra, n_rays, max_depth,
                       rec ? 0x7fffffff / REC_WORDS : MAX_PRIMS);
  if (err) return err;
  if (!next_ray || (rec && n_prims < 1)) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (rec) {
    wide_tables_kernel<<<(n_prims + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        prims, meta, n_prims, rec);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  using Launch = decltype(&xyz_launch<MESH_NONE, false>);
  const Launch launch =
      rec ? (mesh_mode ? &xyz_launch<MESH_ROWS, true>
                       : &xyz_launch<MESH_NONE, true>)
          : (mesh_mode ? &xyz_launch<MESH_ROWS, false>
                       : &xyz_launch<MESH_NONE, false>);
  const XyzFrame xf = {o, d, seeds, cie, accum, scale};
  return (int)launch(prims, rec, meta, n_prims, lights, n_lights, xf, spect,
                     n_spectra, n_rays, max_depth, rr_start, next_ray, st);
}
