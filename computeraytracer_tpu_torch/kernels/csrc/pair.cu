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
// One thread per pair scans its chunk's 128 triangles in order (scan_pair):
// tri_test's arithmetic, the arithmetic of the walk's scan_mesh_part, so
// its t, id and normal are the walk's op for op, and the any-hit flag is
// exactly "closest t <= t_light". The pairs arrive sorted by chunk id, so
// a warp's threads read the same triangle rows (L1 broadcasts); the TPU's
// VMEM-versus-HBM choice (stream_tris) has no counterpart, the rows always
// live in device memory.
//
// What bounds it: the instructions issued per (pair, triangle), not bytes.
// Per live pair, 128 triangle records (64 bytes each, read through L1) and
// the pair's planes (9 words in, 5 or 1 out) from device memory; the
// one-thread loop it replaced issued ~123 instructions per triangle (13
// scalar loads, an IEEE division per plane test, 18 selects of the
// watertight test's axes). This loop reads a record as three 128-bit loads
// and a 32-bit one, loads the next record while it tests this one, and
// runs the inside test before the plane's division, which then runs only
// for the triangles the ray passes through (PERF.md). Given a work array,
// the counting instantiation adds its live pairs, plane tests and inside
// tests to it; the timed instantiation (pair_timed) adds each section's
// clock64() cycles.
//
// Numerics: --fmad=false, as every kernel of the port.

#include "bounce.cuh"

namespace {

using namespace pathtrace;

// Sections of the timed build (TIMED): each lane's clock64() cycles per
// triangle, summed over lanes: the record's loads, id, exclusion and
// normal (head), the inside test (inside), the plane's t (plane_t),
// taking the hit (update), and the whole loop (loop). The clock reads
// serialise the loop: the shares say where a lane waits, not how fast
// the untimed build runs.
enum { S_HEAD = 0, S_PLANE_T = 1, S_INSIDE = 2, S_UPDATE = 3, S_LOOP = 4,
       S_KINDS = 5 };

// clock64() read after x is available.
__device__ __forceinline__ long long clock_after(float x) {
  long long t;
  asm volatile("add.f32 %1, %1, 0f00000000;\n\tmov.u64 %0, %%clock64;"
               : "=l"(t), "+f"(x)::"memory");
  return t;
}

// The 13 words of a triangle record that the scan reads: v0 v1 v2, id and
// the unit normal, as three 128-bit loads and one 32-bit load (a record is
// 64 bytes, 64-byte aligned: kernels/meshpack.py).
struct Rec {
  float w[13];
};

__device__ __forceinline__ Rec load_rec(const float* __restrict__ tri) {
  const float4* q = reinterpret_cast<const float4*>(tri);
  const float4 q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2);
  return {{q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x, q2.y, q2.z,
           q2.w, __ldg(tri + 12)}};
}

// One chunk's 128 triangles against one ray, in order, on one thread, with
// tri_test's arithmetic in another order: for each triangle its id
// (padding, the excluded triangle), the grazing test, the watertight
// inside test, and only for a triangle the ray passes through the plane's
// t = num / ndotd and its range (kernels/binned.py
// pair_scan_order_reference). A hit needs every test, so the hits and the
// winner are those of the order plane test, range, inside test; the
// division, which every triangle paid, now runs for the one or two that
// the ray passes through. The next record is loaded while this one is
// tested, and the loop is unrolled by two.
// - ANY false: closest hit under the mesh tie rule; updates h. Returns
//   false.
// - ANY true: whether some triangle is hit at T_MIN <= t <= t_light;
//   returns at the first one and leaves h alone. Its t is the closest
//   scan's, so the answer is exactly "closest t <= t_light".
// With COUNT, counts its plane tests and the inside tests that the order
// plane test, range, inside test needs (the yardstick of its bound)
// into mesh_work, computing t for every triangle to do so; with TIMED,
// adds each section's cycles to sec.
template <bool ANY, bool COUNT, bool TIMED>
__device__ __forceinline__ bool scan_pair(const float* __restrict__ tri, V3 o,
                                          V3 d, int exclude,
                                          const Watertight& wt, Hit& h,
                                          float t_light, long long* sec) {
  long long c0 = 0, c1 = 0;
  Rec nxt = load_rec(tri);
#pragma unroll 2
  for (int j = 0; j < TRIS_PER_CHUNK; ++j, tri += TRI_WORDS) {
    if (TIMED) c0 = clock64();
    const Rec cur = nxt;
    if (j + 1 < TRIS_PER_CHUNK) nxt = load_rec(tri + TRI_WORDS);
    const float(&w)[13] = cur.w;
    const int tid = (int)w[9];
    if (tid < 0 || tid == exclude) continue;
    if (COUNT) ++mesh_work[W_PLANE][threadIdx.x];
    const V3 n0 = {w[10], w[11], w[12]};
    const float ndotd = n0.x * d.x + n0.y * d.y + n0.z * d.z;
    const bool flip = ndotd > 0.0f;
    if (TIMED) {
      c1 = clock_after(ndotd);
      sec[S_HEAD] += c1 - c0;
      c0 = c1;
    }
    if (fabsf(flip ? -ndotd : ndotd) < 1e-4f) continue;  // grazing
    const V3 p0 = {w[0], w[1], w[2]};
    const bool inside =
        watertight_inside(wt, p0, {w[3], w[4], w[5]}, {w[6], w[7], w[8]});
    if (TIMED) {
      c1 = clock_after(inside ? 1.0f : 0.0f);
      sec[S_INSIDE] += c1 - c0;
      c0 = c1;
    }
    if (!COUNT && !inside) continue;
    const float num = n0.x * (p0.x - o.x) + n0.y * (p0.y - o.y) +
                      n0.z * (p0.z - o.z);
    const float t = num / ndotd;
    if (TIMED) {
      c1 = clock_after(t);
      sec[S_PLANE_T] += c1 - c0;
      c0 = c1;
    }
    if (ANY) {
      if (!(t >= T_MIN && t <= t_light)) continue;
    } else if (!(t >= T_MIN && (t < h.t || (t == h.t && tid > h.idx)))) {
      continue;
    }
    if (COUNT) ++mesh_work[W_INSIDE][threadIdx.x];
    if (!inside) continue;
    if (ANY) return true;
    const float sgn = flip ? -1.0f : 1.0f;
    h.t = t;
    h.idx = tid;
    h.nrm = {sgn * n0.x, sgn * n0.y, sgn * n0.z};
    if (TIMED) sec[S_UPDATE] += clock_after(h.t) - c0;
  }
  return false;
}

template <bool ANY, bool COUNT, bool TIMED>
__global__ void __launch_bounds__(THREADS)
    pair_kernel(const float* __restrict__ pair_f,
                const int* __restrict__ pair_i, const float* __restrict__ tri,
                float* __restrict__ out_f, int* __restrict__ out_i,
                long long P, int n_chunks,
                unsigned long long* __restrict__ work) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (COUNT) work_clear();
  long long sec[S_KINDS] = {};
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
      const long long c0 = TIMED ? clock64() : 0;
      hit = scan_pair<ANY, COUNT, TIMED>(
          tri + (long long)chunk * TRIS_PER_CHUNK * TRI_WORDS, o, d, exclude,
          wt, h, ANY ? pair_f[6 * P + p] : 0.0f, sec);
      if (TIMED) sec[S_LOOP] += clock_after(h.t + (hit ? 1.0f : 0.0f)) - c0;
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
  if (TIMED)
    for (int k = 0; k < S_KINDS; ++k)
      atomicAdd(work + k, (unsigned long long)sec[k]);
}

template <bool ANY>
int launch(const float* pair_f, const int* pair_i, const float* tri,
           float* out_f, int* out_i, long long n_pairs, int n_chunks,
           unsigned long long* work, unsigned long long* timed,
           void* stream) {
  if (n_pairs < 0 || n_chunks < 0 ||
      (n_pairs + THREADS - 1) / THREADS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (n_pairs == 0) return 0;
  const unsigned blocks = (unsigned)((n_pairs + THREADS - 1) / THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (timed)
    pair_kernel<ANY, false, true><<<blocks, THREADS, 0, st>>>(
        pair_f, pair_i, tri, out_f, out_i, n_pairs, n_chunks, timed);
  else if (work)
    pair_kernel<ANY, true, false><<<blocks, THREADS, 0, st>>>(
        pair_f, pair_i, tri, out_f, out_i, n_pairs, n_chunks, work);
  else
    pair_kernel<ANY, false, false><<<blocks, THREADS, 0, st>>>(
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
                       work, nullptr, stream);
}

// pair_f (7, n_pairs) f32 [o, d, t_light]; pair_i and tri as pair_closest's
// -> flag (1, n_pairs) i32, 1 where some triangle is hit at T_MIN <= t <=
// t_light. work as pair_closest's.
extern "C" int pair_any(const float* pair_f, const int* pair_i,
                        const float* tri, int* flag, long long n_pairs,
                        int n_chunks, unsigned long long* work, void* stream) {
  return launch<true>(pair_f, pair_i, tri, nullptr, flag, n_pairs, n_chunks,
                      work, nullptr, stream);
}

// The timed build of either scan (any_hit 0: pair_closest's outputs, 1:
// pair_any's flag in out_i): times, S_KINDS zeroed counters, receives each
// section's clock64() cycles summed over lanes. Never launched on the
// main path.
extern "C" int pair_timed(const float* pair_f, const int* pair_i,
                          const float* tri, float* out_f, int* out_i,
                          long long n_pairs, int n_chunks, int any_hit,
                          unsigned long long* times, void* stream) {
  if (!times) return (int)cudaErrorInvalidValue;
  return any_hit ? launch<true>(pair_f, pair_i, tri, nullptr, out_i, n_pairs,
                                n_chunks, nullptr, times, stream)
                 : launch<false>(pair_f, pair_i, tri, out_f, out_i, n_pairs,
                                 n_chunks, nullptr, times, stream);
}
