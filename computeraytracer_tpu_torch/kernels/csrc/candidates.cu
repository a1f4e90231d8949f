// Candidate pass of the binned mesh casts for Hopper (sm_90a).
//
// Replaces computeraytracer_tpu/kernels/binned.py:215 build_candidate_kernel:
// each ray's k nearest chunk AABBs by padded slab entry distance, culled by
// a pre-padded bound. Contract (kernels/binned.py candidates_reference):
// per active lane, the k smallest (t_enter, chunk id) pairs in ascending
// lexicographic order, padded with -1, and t_next, the (k+1)-th smallest
// t_enter (+inf when every candidate fit). A lane whose bound is -inf is
// inactive: no candidates, t_next = +inf. Chunk ids at or beyond n_chunks
// (the BIG boxes that pad the array to whole supernodes) are never
// candidates.
//
// One thread per ray walks the supernodes (SUP_CHUNKS = 16 chunk boxes
// each) and, where it enters one, runs the k-slot compare-swap insertion
// over that supernode's chunks, keeping the running minimum of the evicted
// entries as t_next. The slab arithmetic is bounce.cuh slab_enter, the
// walk's. The TPU kernel skips a supernode only when no lane of its
// 1,024-ray tile enters it; here each thread skips it for its own ray,
// which returns the same slots: rounding is monotone, so a supernode box's
// padded interval contains the padded interval of every chunk box inside
// it, and a ray that cannot enter the supernode enters none of its chunks.
//
// What bounds it: per ray, one slab test per supernode and one per chunk of
// an entered supernode, each followed by k compare-swaps; the boxes (n_sup
// * 17 * 32 bytes, 21,760 at 81,920 triangles) are staged in shared memory
// when they fit in 48 KB and read through L1 otherwise. Only the rays (7
// words) and the candidates (k + 1 words) touch device memory per ray.
// Given a work array, the counting instantiation adds its active rays and
// slab tests to it.
//
// Numerics: --fmad=false, as every kernel of the port.

#include "bounce.cuh"

namespace {

using namespace pathtrace;

constexpr int SUP_CHUNKS = 16;
constexpr int SHARED_LIMIT = 48 * 1024;

template <int K, bool COUNT>
__global__ void __launch_bounds__(THREADS)
    candidates_kernel(const float* __restrict__ rays7,
                      const float* __restrict__ cboxes,
                      const float* __restrict__ sboxes, int* __restrict__ cand,
                      float* __restrict__ t_next_out, long long R,
                      int n_chunks, int n_sup, int use_shared,
                      unsigned long long* __restrict__ work) {
  extern __shared__ float boxes[];
  if (COUNT) work_clear();
  const float* cb = cboxes;
  const float* sb = sboxes;
  if (use_shared) {
    const int nc = n_sup * SUP_CHUNKS * BOX_WORDS;
    const int ns = n_sup * BOX_WORDS;
    for (int i = threadIdx.x; i < nc; i += blockDim.x) boxes[i] = cboxes[i];
    for (int i = threadIdx.x; i < ns; i += blockDim.x)
      boxes[nc + i] = sboxes[i];
    __syncthreads();
    cb = boxes;
    sb = boxes + nc;
  }
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r < R) {
    float slot_t[K];
    int slot_i[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      slot_t[j] = INFINITY;
      slot_i[j] = -1;
    }
    float t_next = INFINITY;
    const float bound = rays7[6 * R + r];
    if (bound > -INFINITY) {
      if (COUNT) ++mesh_work[W_CAST][threadIdx.x];
      const V3 o = {rays7[r], rays7[R + r], rays7[2 * R + r]};
      const V3 d = {rays7[3 * R + r], rays7[4 * R + r], rays7[5 * R + r]};
      float inv_d[3];
      inv_dir(d, inv_d);
      for (int s = 0; s < n_sup; ++s) {
        if (COUNT) ++mesh_work[W_BOX][threadIdx.x];
        float te;
        if (!slab_enter(sb + s * BOX_WORDS, o, inv_d, bound, te)) continue;
        const int end = min((s + 1) * SUP_CHUNKS, n_chunks);
        for (int c = s * SUP_CHUNKS; c < end; ++c) {
          if (COUNT) ++mesh_work[W_BOX][threadIdx.x];
          if (!slab_enter(cb + c * BOX_WORDS, o, inv_d, bound, te)) continue;
          float t_new = te;
          int i_new = c;
          // ascending by t_enter, equal entries by the lower chunk id
          // (binned.py:288-299): the evicted (k+1)-th best ends in t_new
#pragma unroll
          for (int j = 0; j < K; ++j) {
            const bool swap = t_new < slot_t[j] ||
                              (t_new == slot_t[j] && i_new < slot_i[j]);
            const float ts = slot_t[j];
            const int is = slot_i[j];
            slot_t[j] = swap ? t_new : ts;
            slot_i[j] = swap ? i_new : is;
            t_new = swap ? ts : t_new;
            i_new = swap ? is : i_new;
          }
          t_next = fminf(t_next, t_new);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) cand[j * R + r] = slot_i[j];
    t_next_out[r] = t_next;
  }
  if (COUNT) work_flush(work);
}

template <int K>
int launch(const float* rays7, const float* cboxes, const float* sboxes,
           int* cand, float* t_next, long long n_rays, int n_chunks,
           int n_sup, unsigned long long* work, cudaStream_t st) {
  const unsigned blocks = (unsigned)((n_rays + THREADS - 1) / THREADS);
  const size_t bytes =
      (size_t)n_sup * (SUP_CHUNKS + 1) * BOX_WORDS * sizeof(float);
  const int use_shared = bytes <= SHARED_LIMIT;
  const size_t smem = use_shared ? bytes : 0;
  if (work)
    candidates_kernel<K, true><<<blocks, THREADS, smem, st>>>(
        rays7, cboxes, sboxes, cand, t_next, n_rays, n_chunks, n_sup,
        use_shared, work);
  else
    candidates_kernel<K, false><<<blocks, THREADS, smem, st>>>(
        rays7, cboxes, sboxes, cand, t_next, n_rays, n_chunks, n_sup,
        use_shared, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

// rays7 (7, n_rays) f32 [o, d, bound] (bound pre-padded, -inf inactive);
// cboxes (n_sup * 16, 8) f32 chunk boxes, the first n_chunks real; sboxes
// (n_sup, 8) f32 supernode boxes -> cand (k, n_rays) i32, t_next (n_rays,)
// f32. k is 1, 4 or 6 (kernels/binned.py CAND_KS: the default 6, and 1
// and 4 for the tests and for forcing the finishes). work, null or 4
// zeroed counters, receives the counting build's active rays and slab
// tests (columns 0 and 1). Returns the CUDA error code of the launch (0
// on success).
extern "C" int candidates(const float* rays7, const float* cboxes,
                          const float* sboxes, int* cand, float* t_next,
                          long long n_rays, int n_chunks, int n_sup, int k,
                          unsigned long long* work, void* stream) {
  if (n_rays < 0 || n_sup < 0 || n_chunks < 0 ||
      n_chunks > n_sup * SUP_CHUNKS ||
      (n_rays + THREADS - 1) / THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define CAND_CASE(KK)                                                      \
  case KK:                                                                 \
    return launch<KK>(rays7, cboxes, sboxes, cand, t_next, n_rays,         \
                      n_chunks, n_sup, work, st);
  switch (k) {
    CAND_CASE(1) CAND_CASE(4) CAND_CASE(6)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef CAND_CASE
}
