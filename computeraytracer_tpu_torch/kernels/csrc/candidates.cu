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
// A warp-drained pass (the plain model of its schedule is kernels/binned.py
// candidates_drained_reference). Each lane owns one ray. Per group of 32
// supernodes (SUP_CHUNKS = 16 chunk boxes each):
// - the supernode pass: each lane tests every supernode box of the group
//   against its own ray, a loop without divergence, and keeps the ones it
//   enters as bits of one 32-bit mask. The TPU kernel skips a supernode
//   only when no lane of its 1,024-ray tile enters it; a lane skipping it
//   for its own ray returns the same slots: rounding is monotone, so a
//   supernode box's padded interval contains the padded interval of every
//   chunk box inside it, and a ray that cannot enter the supernode enters
//   none of its chunks;
// - the dense supernodes, those DENSE_LANES lanes of the warp or more
//   entered (coherent rays, as the camera's), are tested as the one-thread
//   pass tested every supernode: each lane that entered one runs its chunk
//   boxes against its own ray and inserts its own entries, side by side;
// - the drain: the warp's other (lane, supernode) items, listed in shared
//   memory in rank order (a prefix sum of the masks' popcounts), are taken
//   two per pass, 16 lanes to an item: lane q of a half tests chunk box q
//   of its item's supernode against the owner's ray (o, inv_d and the
//   bound by shuffles). Inactive and tail lanes own no items but test
//   chunks for the others. The entries that pass join their owner's list
//   of pending chunk ids in shared memory (a ballot gives each its place);
//   at the group's end, or when a list would overflow, every lane tests its
//   pending chunks again for their t_enter and inserts them, side by side,
//   instead of one owner at a time.
// The insertion keeps the k slots sorted, each slot placed by its own
// comparison with the entry, and the running minimum of the evicted
// entries as t_next. Its order cannot change the result: the k smallest
// (t_enter, chunk id) pairs are a selection under a strict total order (the
// ids of one ray's entries are unique), and t_next, the (k+1)-th smallest
// t_enter, is the least evicted one whatever the order. The slab arithmetic
// is bounce.cuh slab_enter, the walk's.
//
// What bounds it: per ray, one slab test per supernode and one per chunk of
// an entered supernode (~1.7 of 40 at 81,920 triangles on bounce rays),
// and k-slot insertions of the entries that pass. The one-thread pass ran
// its chunk loop once for every supernode that any lane of the warp
// entered, at a SIMT efficiency of 0.06-0.10 on bounce rays; this pass
// keeps 0.82-0.96 of its lanes busy (PERF.md). The boxes (n_sup *
// 17 * 32 bytes, 21,760 at 81,920 triangles) are read through L1: staging
// them in shared memory per block, as the one-thread pass did, ran slower
// here (PERF.md). Only the rays (7 words) and the candidates (k + 1
// words) touch device memory per ray. Given a work array, the counting
// instantiation adds its active rays (W_CAST), slab tests (W_BOX, the
// second tests of pending chunks not included), the chunk loop's warp
// trips (W_SCAN: a dense supernode's chunks and the drain's passes) and its
// lane trips (W_LANES: chunk tests) to it.
//
// Numerics: --fmad=false, as every kernel of the port.

#include "bounce.cuh"

namespace {

using namespace pathtrace;

constexpr int SUP_CHUNKS = 16;
constexpr unsigned FULL_MASK = 0xffffffffu;
// A supernode that this many lanes of a warp enter is dense.
constexpr int DENSE_LANES = 12;
// Capacity of a lane's list of pending entries: what one pass can add.
constexpr int PEND = 2 * SUP_CHUNKS;

// Each warp's drain items of one group, (owner lane << 8 | supernode bit):
// the supernodes that fewer than DENSE_LANES of its lanes entered.
__shared__ unsigned short drain_items[THREADS / 32][32 * (DENSE_LANES - 1)];
// Each lane's pending entries: chunk ids less the group's first.
__shared__ unsigned short pending[THREADS][PEND];

// Insert entry (t, i) into the ascending slots (st, si) of one lane:
// ascending by t_enter, equal entries by the lower chunk id (binned.py:
// 288-299); the evicted (k+1)-th best lowers t_next. Each slot's place is
// decided by its own comparison with the entry, so the k comparisons are
// independent (no chain of compare-swaps).
template <int K>
__device__ __forceinline__ void insert(float (&st)[K], int (&si)[K],
                                       float& t_next, float t, int i) {
  bool before[K];  // slot j precedes the entry
#pragma unroll
  for (int j = 0; j < K; ++j)
    before[j] = st[j] < t || (st[j] == t && si[j] < i);
  const float evicted = before[K - 1] ? t : st[K - 1];
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    st[j] = before[j] ? st[j] : (before[j - 1] ? t : st[j - 1]);
    si[j] = before[j] ? si[j] : (before[j - 1] ? i : si[j - 1]);
  }
  st[0] = before[0] ? st[0] : t;
  si[0] = before[0] ? si[0] : i;
  t_next = fminf(t_next, evicted);
}

template <int K, bool COUNT>
__global__ void __launch_bounds__(THREADS)
    candidates_kernel(const float* __restrict__ rays7,
                      const float* __restrict__ cb,
                      const float* __restrict__ sb, int* __restrict__ cand,
                      float* __restrict__ t_next_out, long long R,
                      int n_chunks, int n_sup,
                      unsigned long long* __restrict__ work) {
  if (COUNT) work_clear();
  const int lane = threadIdx.x & 31;
  const int half = lane >> 4;  // which item of a pass
  const int sub = lane & 15;   // which chunk of the item's supernode
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const float bound = r < R ? rays7[6 * R + r] : -INFINITY;
  const bool active = bound > -INFINITY;
  V3 o = {0.0f, 0.0f, 0.0f};
  float inv_d[3] = {0.0f, 0.0f, 0.0f};
  if (active) {
    if (COUNT) ++mesh_work[W_CAST][threadIdx.x];
    o = {rays7[r], rays7[R + r], rays7[2 * R + r]};
    inv_dir({rays7[3 * R + r], rays7[4 * R + r], rays7[5 * R + r]}, inv_d);
  }
  float slot_t[K];
  int slot_i[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    slot_t[j] = INFINITY;
    slot_i[j] = -1;
  }
  float t_next = INFINITY;
  unsigned short* list = drain_items[threadIdx.x >> 5];
  int n_pend = 0;
  // this lane's pending entries of group g, tested again for their
  // t_enter (the same arithmetic on the same ray gives the same t) and
  // inserted, every lane at once
  auto flush = [&](int g) {
    __syncwarp();
    for (int j = 0; j < n_pend; ++j) {
      const int c = g * SUP_CHUNKS + pending[threadIdx.x][j];
      float te;
      slab_enter(cb + c * BOX_WORDS, o, inv_d, bound, te);
      insert<K>(slot_t, slot_i, t_next, te, c);
    }
    n_pend = 0;
    __syncwarp();
  };

  for (int g = 0; g < n_sup; g += 32) {
    // the supernode pass: this lane's entered supernodes of the group
    unsigned mask = 0u;
    if (active) {
      const int g_end = min(g + 32, n_sup);
      for (int s = g; s < g_end; ++s) {
        if (COUNT) ++mesh_work[W_BOX][threadIdx.x];
        float te;
        if (slab_enter(sb + s * BOX_WORDS, o, inv_d, bound, te))
          mask |= 1u << (s - g);
      }
    }
    // the dense supernodes: each lane that entered one tests its chunks
    // for its own ray, as the one-thread pass did
    unsigned dense = 0u;
    for (unsigned any = __reduce_or_sync(FULL_MASK, mask); any;
         any &= any - 1u) {
      const unsigned bit = any & (0u - any);
      if (__popc(__ballot_sync(FULL_MASK, mask & bit)) >= DENSE_LANES)
        dense |= bit;
    }
    for (unsigned dm = dense; dm; dm &= dm - 1u) {
      const int s = g + __ffs(dm) - 1;
      const int c0 = s * SUP_CHUNKS, end = min(c0 + SUP_CHUNKS, n_chunks);
      if (COUNT && lane == 0)
        mesh_work[W_SCAN][threadIdx.x] += max(end - c0, 0);
      if (!((mask >> (s - g)) & 1u)) continue;
      for (int c = c0; c < end; ++c) {
        if (COUNT) {
          ++mesh_work[W_BOX][threadIdx.x];
          ++mesh_work[W_LANES][threadIdx.x];
        }
        float te;
        if (slab_enter(cb + c * BOX_WORDS, o, inv_d, bound, te))
          insert<K>(slot_t, slot_i, t_next, te, c);
      }
    }
    // the drain of the other items: lane L owns items [excl, excl + cnt)
    mask &= ~dense;
    const int cnt = __popc(mask);
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL_MASK, incl, off);
      if (lane >= off) incl += v;
    }
    const int total = __shfl_sync(FULL_MASK, incl, 31);
    __syncwarp();
    int e = incl - cnt;
    for (unsigned m = mask; m; m &= m - 1u)
      list[e++] = (unsigned short)((lane << 8) | (__ffs(m) - 1));
    __syncwarp();
    for (int base = 0; base < total; base += 2) {
      const bool has = base + half < total;
      const int own0 = list[base] >> 8;
      const int own1 = base + 1 < total ? list[base + 1] >> 8 : -1;
      const int item = has ? list[base + half] : lane << 8;
      const int src = item >> 8;
      const int c = (g + (item & 0xff)) * SUP_CHUNKS + sub;
      const V3 so = {__shfl_sync(FULL_MASK, o.x, src),
                     __shfl_sync(FULL_MASK, o.y, src),
                     __shfl_sync(FULL_MASK, o.z, src)};
      const float si[3] = {__shfl_sync(FULL_MASK, inv_d[0], src),
                           __shfl_sync(FULL_MASK, inv_d[1], src),
                           __shfl_sync(FULL_MASK, inv_d[2], src)};
      const float sbound = __shfl_sync(FULL_MASK, bound, src);
      const bool test = has && c < n_chunks;
      float te = INFINITY;
      const bool pass =
          test && slab_enter(cb + c * BOX_WORDS, so, si, sbound, te);
      if (COUNT) {
        if (test) {
          ++mesh_work[W_BOX][threadIdx.x];
          ++mesh_work[W_LANES][threadIdx.x];
        }
        if (lane == 0) ++mesh_work[W_SCAN][threadIdx.x];
      }
      // the entries that passed join their owner's pending list, at the
      // end of it in lane order; a full list is flushed first
      const unsigned got = __ballot_sync(FULL_MASK, pass);
      const unsigned mine = (lane == own0 ? got & 0x0000ffffu : 0u) |
                            (lane == own1 ? got & 0xffff0000u : 0u);
      if (__any_sync(FULL_MASK, n_pend + __popc(mine) > PEND)) flush(g);
      const unsigned same = (own0 == src ? 0x0000ffffu : 0u) |
                            (own1 == src ? 0xffff0000u : 0u);
      const int at = __shfl_sync(FULL_MASK, n_pend, src) +
                     __popc(got & same & ((1u << lane) - 1u));
      if (pass)
        pending[(threadIdx.x & ~31) + src][at] =
            (unsigned short)(c - g * SUP_CHUNKS);
      n_pend += __popc(mine);
      __syncwarp();
    }
    flush(g);
  }
  if (r < R) {
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
  if (work)
    candidates_kernel<K, true><<<blocks, THREADS, 0, st>>>(
        rays7, cboxes, sboxes, cand, t_next, n_rays, n_chunks, n_sup, work);
  else
    candidates_kernel<K, false><<<blocks, THREADS, 0, st>>>(
        rays7, cboxes, sboxes, cand, t_next, n_rays, n_chunks, n_sup,
        nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

// rays7 (7, n_rays) f32 [o, d, bound] (bound pre-padded, -inf inactive);
// cboxes (n_sup * 16, 8) f32 chunk boxes, the first n_chunks real; sboxes
// (n_sup, 8) f32 supernode boxes -> cand (k, n_rays) i32, t_next (n_rays,)
// f32. k is 1, 4 or 6 (kernels/binned.py CAND_KS: the default 6, and 1
// and 4 for the tests and for forcing the finishes). work, null or
// WORK_KINDS zeroed counters, receives the counting build's active rays,
// slab tests, drain passes and chunk tests (columns 0, 1, 4 and 5).
// Returns the CUDA error code of the launch (0 on success).
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
