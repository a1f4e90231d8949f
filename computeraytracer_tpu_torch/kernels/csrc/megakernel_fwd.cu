// Forward path-tracing megakernel for Hopper (sm_90a).
//
// Replaces computeraytracer_tpu/kernels/megakernel.py:897 build_forward in
// all of its modes:
// - plain (megakernel_fwd with no mesh part and no triangle row);
// - mesh (megakernel_fwd with mesh parts or triangle rows): triangle rows
//   join the unrolled scan through the watertight test, and every mesh
//   part is traversed from device memory (bounce.cuh scan_mesh_part): each
//   lane walks the boxes for its own ray, and the lanes that reach the
//   traversal together (__activemask(): a dead ray has left the bounce
//   loop, and only diffuse hits cast a shadow ray) scan each chunk that one
//   of them enters together. Given a work array, the same code also counts
//   its casts, box tests, triangle tests, chunk scans and the lanes that
//   ran them into it (MESH_COUNT: a separate instantiation, so the
//   uncounted kernel carries no counter). On the card the packed triangle
//   rows always live in device memory, so the TPU kernel's HBM-streaming
//   mode (megakernel.py:849-853, stream_tris) has the same contract here
//   and is covered by this mode;
// - taped="full" (megakernel_fwd_taped, scenes without mesh parts): each
//   bounce's input carry is also written to the tape that
//   megakernel_bwd_tape.cu reads (bounce.cuh tape_write), the layout
//   megakernel_bwd.cu's replay writes, rows after the ray died included;
//   triangle rows scanned as the mesh mode scans them (the MESH_ROWS
//   build, which walks no part) when the scene has some;
// - the untaped forward of a scene without mesh parts with each ray's
//   radiance converted to XYZ and added into the frame as it retires:
//   megakernel_fwd_xyz.cu, the same refill schedule and bounce;
// - taped=True (megakernel_fwd_winners, plain or mesh mode): each bounce's
//   closest-hit winner and the shadow winner of the light its NEE picked,
//   the tape of the guided replay (tracer/replay.py). They are what
//   bounce<true> records anyway (BounceRec.hit.idx, .sh.idx): no second
//   scan. Every entry the replay does not read is -1: a dead ray's rows,
//   and the shadow entries of the lights a bounce did not pick. The TPU
//   kernel scans every light for every lane of a tile and skips whole
//   tiles; those entries are never read, and the radiance is the same.
// A thread traces a ray to completion: up to max_depth+1 bounces of
// make_bounce (megakernel.py:467),
// each an in-order closest-hit scan over every primitive, next-event
// estimation with the power-heuristic MIS, diffuse / glass / mirror
// scattering with Beer-Lambert, Russian roulette, and masked pcg4d draws.
// The bounce itself lives in bounce.cuh, which the backward kernels share,
// and the kernels in forward.cuh, whose taped="full" build the retrace
// backward launches as its replay (megakernel_bwd.cu). Three schedules
// (forward.cuh): the plain mode, triangle rows and the triangle rows'
// taped="full" forward run on persistent warps that refill their dead
// lanes one by one (refill_fwd_kernel); the plain mode's taped="full"
// forward on persistent warps whose lanes take and retire rays in groups
// of sixteen (group_taped_kernel); the mesh parts, the counting mesh build
// and the winner tape one thread per ray on a grid that covers the rays
// (megakernel_fwd_kernel).
//
// What bounds it on this card: per-thread control flow that diverges
// (rays of one warp hit different materials and die at different depths:
// at Cornell 1024^2, depth 8, a ray makes 2.72 trips of the bounce loop
// and a warp of 32 consecutive rays runs 5.24, so one thread per ray keeps
// 52% of the loop's lane slots busy) and register pressure from the live carry (16 f32, 4 u32 and 4 i32
// words plus a hit record), not bytes. Each ray reads 6+4 words, a few
// spectrum words per bounce, and writes 4: a few hundred bytes against
// thousands of flops per bounce. The taped mode adds 96 B per bounce row
// per ray of writes (864 B per ray at depth 8); the winner tape 4 B per
// bounce row and light. The mesh mode adds the traversal: dependent reads
// of boxes from device memory, divergent across the warp, and the chunk
// scans, one plane test per triangle of each entered chunk and a
// watertight test for each plane hit in front of the running best, on
// triangle rows (L2-resident at 81,920 triangles, 5.2 MB) that the lanes
// of a warp read together, 2 KB at a time.
//
// What the design does about it:
// - The carry stays in registers for the whole path; nothing round-trips
//   through memory between bounces.
// - A dead lane takes a new ray (the refill schedule): a warp with
//   REFILL_AT dead lanes takes that many ray ids from one counter, each
//   lane keeps its own ray, depth and carry, and the grid holds only the
//   blocks that stay resident, each loading the scene table once. At
//   Cornell 1024^2 that keeps 0.88 of the lane slots busy (counting build,
//   PERF.md). In the one-thread builds a thread leaves the loop as soon as
//   its ray is dead (the SIMT form of the TPU kernel's all-dead-tile skip;
//   exact, because every update of a dead lane is a masked identity
//   there). The mesh traversal needs the lanes that reach it together.
// - The full tape is laid out row by row, (max_depth+1) * 24 rows of R
//   words (the JAX tape's layout, which the sweep reads coalesced), so a
//   32-byte sector holds one word of one row for 8 consecutive rays. Lanes
//   that hold scattered rays at mixed depths store partial sectors: at
//   Cornell depth 8 (864 B of tape per ray, 85% of the kernel's bytes) a
//   refill build of the taped forward ran 3-4x slower than one thread per
//   ray, which writes whole sectors but keeps only 0.52 of the lane slots
//   busy. The group schedule keeps both in part: 16 lanes hold 16
//   consecutive, 16-aligned rays at one depth and refill together once
//   all 16 have died, a dead lane writing its final-carry row (which the
//   tape needs anyway) beside its group's live ones, so every store is two
//   whole sectors side by side, and the lane slots are as busy as in
//   groups of 16 (0.60 at Cornell 1024^2, counting build; 0.52 for one
//   thread per ray). Groups of 8, one sector a store, kept 0.69 busy but
//   ran slower than one thread per ray (PERF.md): not the sector alone,
//   the width of what a group writes at once sets the tape's cost. On
//   triangle rows (depth 3, 80 triangles scanned twice per bounce) the
//   bounce outweighs the tape and the refill schedule runs it.
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
// - A scene of more rows (megakernel_fwd_wide: the untaped forward of a
//   scene without mesh parts) runs the same refill schedule and bounce on
//   tables in device memory (refill_fwd_wide, bounce.cuh WideScene): a
//   first launch writes one 64-byte record per slot (wide_tables_kernel:
//   the row's vectors and the plane constants load_scene computes, in its
//   op order, with the row and category), and the scans read them through
//   L1, every lane of a warp the same record at once, a broadcast. At
//   3,407 rows the records take 218 KB: shared memory (at most 227 KB a
//   block) would hold them for one block an SM, and a larger scene not at
//   all, so the kernel asks for the smallest shared-memory carveout and
//   leaves the rest to L1. Staging 32-row tiles per warp in shared memory
//   instead ran 2.5x slower (PERF.md).
// - The mesh traversal keeps the lanes of a warp together where the rays
//   diverge most: each lane's box walk stops at every chunk it enters, and
//   the lanes scan the entered chunks side by side, instead of each lane
//   looping alone over its own 128 triangles while the others wait.
//
// Numerics: built with --fmad=false (no contraction of a*b+c into an FMA)
// and IEEE division and square root, so every operation rounds as the plain
// torch version's separate kernels do. expf/sinf/cosf are the full-precision
// library functions.

#include "forward_entry.cuh"

namespace {

using namespace pathtrace;

// Launch refill_fwd_wide on its resident grid. *next_ray must be 0.
template <int MESH>
cudaError_t wide_launch(const float* rec, const int* meta, int P,
                        const int* lights, int n_lights, const float* rays,
                        const int* seeds, const float* spect, int S,
                        float* out, long long R, int max_depth, int rr_start,
                        unsigned long long* next_ray, cudaStream_t st) {
  static long long resident[MAX_DEVICES] = {};
  unsigned blocks = 0;
  const cudaError_t err =
      wide_grid(refill_fwd_wide<MESH>, resident, R, &blocks);
  if (err != cudaSuccess) return err;
  refill_fwd_wide<MESH><<<blocks, THREADS, 0, st>>>(
      rec, meta, P, lights, n_lights, rays, seeds, spect, S, out, R,
      max_depth, rr_start, next_ray);
  return cudaGetLastError();
}

}  // namespace

// part_ptrs: per mesh part (tri_rows, chunk_bbox, node_bbox, node_meta)
// device pointers; part_info: per part (n_nodes, n_real_chunks), host
// arrays. meta holds n_prims slot rows, then n_parts part rows. A scene
// with no part runs the refill schedule (forward.cuh refill_fwd_kernel),
// in its triangle-row build when mesh_mode is set; next_ray is its ray
// counter, one zeroed u64. trips, null or (with no part) TRIP_KINDS zeroed
// counters, selects its counting build, which adds its lane and warp
// trips. A scene with parts runs the one-thread schedule in the mesh mode;
// work, null or (in mesh mode) WORK_KINDS zeroed counters, receives the
// counted mesh mode's casts, box tests, triangle plane tests, triangle
// inside tests, chunk scans, the lanes that ran them and the inside tests
// those scans need. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int megakernel_fwd(const float* prims, const int* meta, int n_prims,
                              const int* lights, int n_lights,
                              const float* rays, const int* seeds,
                              const float* spect, int n_spectra, float* out,
                              long long n_rays, int max_depth, int rr_start,
                              int mesh_mode, int n_parts,
                              const long long* part_ptrs, const int* part_info,
                              unsigned long long* work,
                              unsigned long long* next_ray,
                              unsigned long long* trips, void* stream) {
  int err = check_args(n_prims, n_lights, n_spectra, n_rays, max_depth);
  if (err) return err;
  if (n_parts < 0 || n_parts > MAX_PARTS || (n_parts > 0 && !mesh_mode) ||
      (work && !mesh_mode) || (trips && (n_parts > 0 || work)) ||
      (n_parts == 0 && !work && !next_ray))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_parts == 0 && !work) {
    using Launch = decltype(&refill_launch<MESH_NONE, TAPE_NONE, false>);
    const Launch launch =
        mesh_mode ? (trips ? &refill_launch<MESH_ROWS, TAPE_NONE, true>
                           : &refill_launch<MESH_ROWS, TAPE_NONE, false>)
                  : (trips ? &refill_launch<MESH_NONE, TAPE_NONE, true>
                           : &refill_launch<MESH_NONE, TAPE_NONE, false>);
    return (int)launch(prims, meta, n_prims, lights, n_lights, rays, seeds,
                       spect, n_spectra, out, nullptr, nullptr, n_rays,
                       max_depth, rr_start, next_ray, trips, st);
  }
  const MeshParts mp = make_parts(n_parts, part_ptrs, part_info);
  const unsigned blocks = (unsigned)((n_rays + THREADS - 1) / THREADS);
  if (work)
    megakernel_fwd_kernel<MESH_COUNT, TAPE_NONE><<<blocks, THREADS, 0, st>>>(
        prims, meta, n_prims, lights, n_lights, rays, seeds, spect, n_spectra,
        out, nullptr, nullptr, n_rays, max_depth, rr_start, mp, work);
  else
    megakernel_fwd_kernel<MESH_WALK, TAPE_NONE><<<blocks, THREADS, 0, st>>>(
        prims, meta, n_prims, lights, n_lights, rays, seeds, spect, n_spectra,
        out, nullptr, nullptr, n_rays, max_depth, rr_start, mp, nullptr);
  return (int)cudaGetLastError();
}

// The taped="full" forward of a scene without mesh parts: out as
// megakernel_fwd, and tape_f ((max_depth+1) * 16, n_rays), tape_i
// ((max_depth+1) * 8, n_rays); next_ray, one zeroed u64, is the ray
// counter of its persistent warps. mesh_mode: the scene has triangle
// rows, traced on the refill schedule; without them the group schedule
// runs, and trips, null or TRIP_KINDS zeroed counters, selects its
// counting build, which adds its lane and warp trips.
extern "C" int megakernel_fwd_taped(const float* prims, const int* meta,
                                    int n_prims, const int* lights,
                                    int n_lights, const float* rays,
                                    const int* seeds, const float* spect,
                                    int n_spectra, float* out, float* tape_f,
                                    int* tape_i, long long n_rays,
                                    int max_depth, int rr_start,
                                    int mesh_mode,
                                    unsigned long long* next_ray,
                                    unsigned long long* trips,
                                    void* stream) {
  int err = check_args(n_prims, n_lights, n_spectra, n_rays, max_depth);
  if (err) return err;
  if (!next_ray || (trips && mesh_mode)) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (trips)
    return (int)group_launch<true>(prims, meta, n_prims, lights, n_lights,
                                   rays, seeds, spect, n_spectra, out, tape_f,
                                   tape_i, n_rays, max_depth, rr_start,
                                   next_ray, trips, st);
  return (int)taped_launch(prims, meta, n_prims, lights, n_lights, rays,
                           seeds, spect, n_spectra, out, tape_f, tape_i,
                           n_rays, max_depth, rr_start, mesh_mode, next_ray,
                           st);
}

// The taped=True forward: out as megakernel_fwd, and the winner tape,
// tape_idx (max_depth+1, n_rays) and tape_sh (max_depth+1, n_lights,
// n_rays) i32. The mesh arguments are megakernel_fwd's.
extern "C" int megakernel_fwd_winners(const float* prims, const int* meta,
                                      int n_prims, const int* lights,
                                      int n_lights, const float* rays,
                                      const int* seeds, const float* spect,
                                      int n_spectra, float* out, int* tape_idx,
                                      int* tape_sh, long long n_rays,
                                      int max_depth, int rr_start,
                                      int mesh_mode, int n_parts,
                                      const long long* part_ptrs,
                                      const int* part_info, void* stream) {
  int err = check_args(n_prims, n_lights, n_spectra, n_rays, max_depth);
  if (err) return err;
  if (n_parts < 0 || n_parts > MAX_PARTS || (n_parts > 0 && !mesh_mode))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const MeshParts mp = make_parts(n_parts, part_ptrs, part_info);
  const unsigned blocks = (unsigned)((n_rays + THREADS - 1) / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (mesh_mode)
    megakernel_fwd_kernel<MESH_WALK, TAPE_WINNERS><<<blocks, THREADS, 0, st>>>(
        prims, meta, n_prims, lights, n_lights, rays, seeds, spect, n_spectra,
        out, tape_idx, tape_sh, n_rays, max_depth, rr_start, mp, nullptr);
  else
    megakernel_fwd_kernel<MESH_NONE, TAPE_WINNERS><<<blocks, THREADS, 0, st>>>(
        prims, meta, n_prims, lights, n_lights, rays, seeds, spect, n_spectra,
        out, tape_idx, tape_sh, n_rays, max_depth, rr_start, mp, nullptr);
  return (int)cudaGetLastError();
}

// The untaped forward of a scene without mesh parts and of any number of
// rows, from tables in device memory: out as megakernel_fwd. rec, n_prims
// * REC_WORDS f32, receives the slot records (wide_tables_kernel, launched
// first on the same stream); next_ray, one zeroed u64, is the ray counter
// of the refill schedule; mesh_mode: the scene has triangle rows.
extern "C" int megakernel_fwd_wide(const float* prims, const int* meta,
                                   int n_prims, const int* lights,
                                   int n_lights, const float* rays,
                                   const int* seeds, const float* spect,
                                   int n_spectra, float* out, long long n_rays,
                                   int max_depth, int rr_start, int mesh_mode,
                                   float* rec, unsigned long long* next_ray,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int err = wide_start(prims, meta, n_prims, n_lights, n_spectra, n_rays,
                             max_depth, rec, next_ray, st);
  if (err) return err < 0 ? 0 : err;
  const auto launch = mesh_mode ? &wide_launch<MESH_ROWS>
                                : &wide_launch<MESH_NONE>;
  return (int)launch(rec, meta, n_prims, lights, n_lights, rays, seeds, spect,
                     n_spectra, out, n_rays, max_depth, rr_start, next_ray,
                     st);
}
