// Seeded chunk-BVH walk over every mesh part for Hopper (sm_90a).
//
// Replaces computeraytracer_tpu/kernels/binned.py:640 build_walk_kernel: the
// exact closest mesh hit of each ray, starting from a seed (t, n.xyz, idx)
// and skipping the triangle `exclude`, under the mesh tie rule (t < best, or
// t == best and the higher id). The binned casts of the wavefront
// (kernels/binned.py _walk_finish) run it on the rays that the candidate and
// pair kernels leave unresolved, seeded with their binned winner (closest
// hit) or empty (any hit): compacted into a tier, or over the whole film.
//
// One thread walks one ray's boxes through bounce.cuh scan_mesh_part, the
// code of the mesh forward's in-kernel scan, so a walk from an empty seed
// finds the winner the mesh forward finds. The TPU kernel walks the tree
// once per ray tile (a box is entered when any ray of the tile can hit it)
// and broadcasts each triangle to the tile's lanes; here each thread walks
// the boxes for its own ray, and the 32 lanes of a warp scan every chunk
// that one of them enters together, four triangles each, which changes no
// winner (the boxes are conservative and the tie rule does not depend on
// the test order). Every lane of a warp, a tail lane beyond the last ray
// or an inactive one included, stays to the end of the traversal and helps
// scan: the collectives run under the full mask.
//
// Seeds:
// - t = -inf marks an inactive lane (binned.py:866, walk_compact): the
//   thread walks nothing and writes its seed back, so a launch over every
//   lane of a film costs the dead ones no box test and needs no compaction
//   or host-side count. (The JAX walk_full fallback, binned.py:803-817,
//   seeds inactive rays with their stale winner and can return real hits
//   there; this kernel does not.)
// - a finite t with idx -1 is an occlusion bound: only hits at t <= bound
//   can be taken (a tie at the bound is taken, since every id exceeds -1),
//   and boxes entered beyond it are culled.
//
// What bounds it: the dependent, divergent reads of node and chunk boxes
// of each lane's own walk (L2-resident at 81,920 triangles), and the chunk
// scans: one watertight test per triangle plane hit in front of the
// running best, on rows that a warp reads 2 KB at a time. Given a work
// array, a separate instantiation (MESH_COUNT's counters) also counts its
// casts, box tests, triangle tests, chunk scans and the lanes that ran
// them.
//
// Numerics: --fmad=false, as every kernel of the port.

#include "bounce.cuh"

namespace {

using namespace pathtrace;

template <bool COUNT>
__global__ void __launch_bounds__(THREADS)
    walk_kernel(const float* __restrict__ rays,
                const float* __restrict__ seed_f,
                const int* __restrict__ seed_i, float* __restrict__ out_f,
                int* __restrict__ out_i, long long R,
                const __grid_constant__ MeshParts mp,
                unsigned long long* __restrict__ work) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (COUNT) work_clear();
  const bool in = r < R;
  Hit h;
  h.t = in ? seed_f[r] : -INFINITY;
  h.nrm = {0.0f, 0.0f, 0.0f};
  h.idx = -1;
  h.slot = -1;
  h.pos = {0.0f, 0.0f, 0.0f};
  const bool walking = h.t > -INFINITY;
  V3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 0.0f};
  int exclude = -1;
  if (in) {
    h.nrm = {seed_f[R + r], seed_f[2 * R + r], seed_f[3 * R + r]};
    h.idx = seed_i[r];
  }
  if (walking) {
    if (COUNT) ++mesh_work[W_CAST][threadIdx.x];
    o = {rays[r], rays[R + r], rays[2 * R + r]};
    d = {rays[3 * R + r], rays[4 * R + r], rays[5 * R + r]};
    exclude = seed_i[R + r];
  }
  const Watertight wt = watertight_setup(o, d);
  for (int pi = 0; pi < mp.n; ++pi)
    scan_mesh_part<COUNT>(mp.part[pi], pi, o, d, exclude, wt, h, walking,
                          0xFFFFFFFFu);
  if (in) {
    out_f[r] = h.t;
    out_f[R + r] = h.nrm.x;
    out_f[2 * R + r] = h.nrm.y;
    out_f[3 * R + r] = h.nrm.z;
    out_i[r] = h.idx;
  }
  if (COUNT) work_flush(work);
}

}  // namespace

// rays (6, n_rays) f32 [o, d]; seed_f (4, n_rays) f32 [t, n.xyz]; seed_i
// (2, n_rays) i32 [idx, exclude] -> out_f (4, n_rays) f32 [t, n.xyz],
// out_i (1, n_rays) i32 [idx]. part_ptrs, part_info: megakernel_fwd's. work,
// null or WORK_KINDS zeroed counters, receives the counting build's casts,
// box tests, triangle plane tests, triangle inside tests, chunk scans, the
// lanes that ran them and the inside tests those scans need. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int walk(const float* rays, const float* seed_f, const int* seed_i,
                    float* out_f, int* out_i, long long n_rays, int n_parts,
                    const long long* part_ptrs, const int* part_info,
                    unsigned long long* work, void* stream) {
  if (n_rays < 0 || n_parts < 1 || n_parts > MAX_PARTS ||
      (n_rays + THREADS - 1) / THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const MeshParts mp = make_parts(n_parts, part_ptrs, part_info);
  const unsigned blocks = (unsigned)((n_rays + THREADS - 1) / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (work)
    walk_kernel<true><<<blocks, THREADS, 0, st>>>(rays, seed_f, seed_i, out_f,
                                                  out_i, n_rays, mp, work);
  else
    walk_kernel<false><<<blocks, THREADS, 0, st>>>(
        rays, seed_f, seed_i, out_f, out_i, n_rays, mp, nullptr);
  return (int)cudaGetLastError();
}
