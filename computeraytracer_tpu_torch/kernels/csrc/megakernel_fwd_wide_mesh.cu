// The untaped forward of a scene with mesh parts and more unrolled rows
// than the shared tables hold (kernels/megakernel.py forward, counted in
// launches_wide_mesh): the final scene of Ray Tracing: The Next Week with
// its ground as a triangle mesh, 1,007 unrolled rows beside one part of
// 4,800 triangles.
//
// It joins the two builds of megakernel_fwd.cu that each take half of such
// a scene: the global-table build (refill_fwd_wide), whose scan reads the
// unrolled rows as 64-byte records from device memory through L1
// (wide_tables_kernel writes them; WideScene), and the mesh mode
// (megakernel_fwd_kernel<MESH_WALK>), whose scan then walks each mesh part's
// chunk BVH and lets the lanes that reach the traversal together scan each
// chunk one of them enters (bounce.cuh scan_mesh_part). The scene is
// WideMeshScene: the records and meta in device memory, the lights and the
// parts' tables in shared memory.
//
// Schedule: the refill schedule of refill_fwd_wide (forward.cuh
// refill_trace), persistent warps whose dead lanes take new rays. The chunk
// scans keep their lanes together there: every live lane of a warp runs
// its bounce in the same trip, so the traversal of a closest-hit scan finds
// them together (__activemask()), up to 32 lanes to a chunk's 128
// triangles; on one thread per ray a warp's lanes die one by one over a
// path of up to 41 bounces, and its chunk scans run on the survivors alone.
// The lanes hold scattered rays, so their box walks diverge; each entered
// chunk is scanned once per ray that enters it on either schedule. Timed on
// this scene at 800^2, depth 40, a one-thread-per-ray build of the same
// scan took 42.7-43.2 ms a sample (96 registers, 278 bytes spilled)
// against the refill schedule's 35.3-35.9 (128 registers, none) (PERF.md).
//
// Numerics: --fmad=false, as every build; images are forward_reference's
// bit for bit (its blocked scan of the unrolled rows, then _scan_mesh_part,
// the same tie rule).
//
// Its own source, so that nvcc compiles it beside megakernel_fwd.cu, in
// parallel (kernels/_build.py), and no build's wall time grows by it.

#include "forward_entry.cuh"

namespace {

using namespace pathtrace;

// The refill schedule on WideMeshScene: records rec (REC_WORDS per slot),
// meta (P slot rows, then one per part) and the parts mp.
__global__ void __launch_bounds__(THREADS)
    refill_fwd_wide_mesh(const float* __restrict__ rec,
                         const int* __restrict__ meta, int P,
                         const int* __restrict__ lights, int n_lights,
                         const float* __restrict__ rays,
                         const int* __restrict__ seeds,
                         const float* __restrict__ spect, int S,
                         float* __restrict__ out, long long R, int max_depth,
                         int rr_start, const __grid_constant__ MeshParts mp,
                         unsigned long long* __restrict__ next_ray) {
  __shared__ WideMeshScene s;
  load_wide_mesh_scene(s, rec, meta, lights, n_lights, mp);
  refill_trace<MESH_WALK, TAPE_NONE, false, false>(
      s, P, n_lights, rays, seeds, spect, S, out, nullptr, nullptr, R,
      max_depth, rr_start, next_ray, nullptr, XyzFrame{});
}

}  // namespace

// The untaped forward of a scene with mesh parts, of any number of
// unrolled rows: out (4, n_rays) as megakernel_fwd. rec, n_prims *
// REC_WORDS f32, receives the slot records (wide_tables_kernel, launched
// first on the same stream); meta holds n_prims slot rows, then n_parts
// part rows; part_ptrs and part_info as megakernel_fwd's; next_ray, one
// zeroed u64, is the ray counter of the refill schedule. Returns the CUDA
// error code of the launches (0 on success).
extern "C" int megakernel_fwd_wide_mesh(
    const float* prims, const int* meta, int n_prims, const int* lights,
    int n_lights, const float* rays, const int* seeds, const float* spect,
    int n_spectra, float* out, long long n_rays, int max_depth, int rr_start,
    int n_parts, const long long* part_ptrs, const int* part_info, float* rec,
    unsigned long long* next_ray, void* stream) {
  if (n_parts < 1 || n_parts > MAX_PARTS || !part_ptrs || !part_info)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = wide_start(prims, meta, n_prims, n_lights, n_spectra, n_rays,
                             max_depth, rec, next_ray, st);
  if (err) return err < 0 ? 0 : err;
  const MeshParts mp = make_parts(n_parts, part_ptrs, part_info);
  static long long resident[MAX_DEVICES] = {};
  unsigned blocks = 0;
  const cudaError_t e =
      wide_grid(refill_fwd_wide_mesh, resident, n_rays, &blocks);
  if (e != cudaSuccess) return (int)e;
  refill_fwd_wide_mesh<<<blocks, THREADS, 0, st>>>(
      rec, meta, n_prims, lights, n_lights, rays, seeds, spect, n_spectra,
      out, n_rays, max_depth, rr_start, mp, next_ray);
  return (int)cudaGetLastError();
}
