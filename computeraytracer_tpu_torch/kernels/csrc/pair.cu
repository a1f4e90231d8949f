// Pair scans of the binned mesh casts for Hopper (sm_90a).
//
// Replaces two TPU kernels of computeraytracer_tpu/kernels/binned.py, as two
// instantiations of one kernel:
// - :392 build_pair_kernel (pair_closest): the closest hit of each (ray,
//   chunk) pair over the chunk's 128 triangles, under the mesh tie rule
//   (t < best, or t == best and the higher id), starting empty;
// - :898 build_pair_kernel_occl (pair_any): whether the pair has any hit at
//   T_MIN <= t <= t_light, t_light the exact light distance with no pad; it
//   returns at the first one.
// Contracts: kernels/binned.py pair_reference and pair_occluded_reference.
// A pair whose chunk id is -1 (dead) or at or beyond the part's real chunk
// count (padding boxes, which have no triangle rows) tests nothing: no hit.
//
// One thread per pair runs bounce.cuh scan_chunk, the triangle loop of the
// walk's scan_mesh_part, so its t, id and normal are the walk's op for op,
// and the any-hit flag is exactly "closest t <= t_light". The pairs arrive
// sorted by chunk id, so a warp's threads read the same triangle rows
// (L1 broadcasts); the TPU's VMEM-versus-HBM choice (stream_tris) has no
// counterpart, the rows always live in device memory.
//
// What bounds it: per live pair, 128 triangle plane tests and an inside
// test for each plane hit that could win, on rows read through L1/L2; the
// pair planes (9 words in, 5 or 1 out) are the device-memory traffic.
// Given a work array, the counting instantiation adds its live pairs,
// plane tests and inside tests to it.
//
// Numerics: --fmad=false, as every kernel of the port.

#include "bounce.cuh"

namespace {

using namespace pathtrace;

template <bool ANY, bool COUNT>
__global__ void __launch_bounds__(THREADS)
    pair_kernel(const float* __restrict__ pair_f,
                const int* __restrict__ pair_i, const float* __restrict__ tri,
                float* __restrict__ out_f, int* __restrict__ out_i,
                long long P, int n_chunks,
                unsigned long long* __restrict__ work) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (COUNT) work_clear();
  if (p < P) {
    Hit h;
    h.t = INFINITY;
    h.idx = -1;
    h.slot = -1;
    h.pos = {0.0f, 0.0f, 0.0f};
    h.nrm = {0.0f, 0.0f, 0.0f};
    bool hit = false;
    const int chunk = pair_i[p];
    if (chunk >= 0 && chunk < n_chunks) {
      if (COUNT) ++mesh_work[W_CAST][threadIdx.x];
      const V3 o = {pair_f[p], pair_f[P + p], pair_f[2 * P + p]};
      const V3 d = {pair_f[3 * P + p], pair_f[4 * P + p], pair_f[5 * P + p]};
      const int exclude = pair_i[P + p];
      const Watertight wt = watertight_setup(o, d);
      hit = scan_chunk<ANY, COUNT>(
          tri + (long long)chunk * TRIS_PER_CHUNK * TRI_WORDS, 0, o, d,
          exclude, wt, h, ANY ? pair_f[6 * P + p] : 0.0f);
    }
    if (ANY) {
      out_i[p] = hit ? 1 : 0;
    } else {
      out_f[p] = h.t;
      out_f[P + p] = h.nrm.x;
      out_f[2 * P + p] = h.nrm.y;
      out_f[3 * P + p] = h.nrm.z;
      out_i[p] = h.idx;
    }
  }
  if (COUNT) work_flush(work);
}

template <bool ANY>
int launch(const float* pair_f, const int* pair_i, const float* tri,
           float* out_f, int* out_i, long long n_pairs, int n_chunks,
           unsigned long long* work, void* stream) {
  if (n_pairs < 0 || n_chunks < 0 ||
      (n_pairs + THREADS - 1) / THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n_pairs == 0) return 0;
  const unsigned blocks = (unsigned)((n_pairs + THREADS - 1) / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (work)
    pair_kernel<ANY, true><<<blocks, THREADS, 0, st>>>(
        pair_f, pair_i, tri, out_f, out_i, n_pairs, n_chunks, work);
  else
    pair_kernel<ANY, false><<<blocks, THREADS, 0, st>>>(
        pair_f, pair_i, tri, out_f, out_i, n_pairs, n_chunks, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

// pair_f (7, n_pairs) f32 [o, d, unused]; pair_i (2, n_pairs) i32 [chunk
// (-1 dead), exclude]; tri (n_chunks * 16, 128) f32, the part's triangle
// rows -> out_f (4, n_pairs) f32 [t, n.xyz], out_i (1, n_pairs) i32 [idx].
// work, null or WORK_KINDS zeroed counters, receives the counting build's
// live pairs, plane tests and inside tests (columns 0, 2 and 3). Returns the
// CUDA error code of the launch (0 on success).
extern "C" int pair_closest(const float* pair_f, const int* pair_i,
                            const float* tri, float* out_f, int* out_i,
                            long long n_pairs, int n_chunks,
                            unsigned long long* work, void* stream) {
  return launch<false>(pair_f, pair_i, tri, out_f, out_i, n_pairs, n_chunks,
                       work, stream);
}

// pair_f (7, n_pairs) f32 [o, d, t_light]; pair_i and tri as pair_closest's
// -> flag (1, n_pairs) i32, 1 where some triangle is hit at T_MIN <= t <=
// t_light. work as pair_closest's.
extern "C" int pair_any(const float* pair_f, const int* pair_i,
                        const float* tri, int* flag, long long n_pairs,
                        int n_chunks, unsigned long long* work, void* stream) {
  return launch<true>(pair_f, pair_i, tri, nullptr, flag, n_pairs, n_chunks,
                      work, stream);
}
