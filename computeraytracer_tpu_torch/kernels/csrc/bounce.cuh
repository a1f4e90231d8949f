// One bounce of the path tracer, shared by the forward and the backward
// megakernels (megakernel_fwd.cu, megakernel_bwd.cu, megakernel_bwd_tape.cu).
//
// Port of computeraytracer_tpu/kernels/megakernel.py:467 make_bounce as
// per-thread SIMT code: an in-order closest-hit scan over every unrolled
// primitive, next-event estimation with the power-heuristic MIS, diffuse /
// glass / mirror scattering with Beer-Lambert, Russian roulette, and masked
// pcg4d draws. The backward's replay and its per-bounce recompute run this
// same code, so their sampling decisions are the forward's bit for bit
// (every kernel is built with --fmad=false).
//
// The scene structure, which the TPU kernel unrolls as Python constants,
// is a small runtime table in shared memory: the primitive rows, per-slot
// (row, category, material, emission, reflectance) and the light rows,
// with the per-patch plane constants and the light areas precomputed in
// the reference's op order (load_scene). A scene of more than MAX_PRIMS
// rows does not fit there: the forward's global-table build reads one
// record per slot from device memory instead (WideScene, the same
// constants in the same op order; WideMeshScene adds mesh parts), and the
// scan, the bounce and NEE take either table through the same accessors.
//
// Mesh mode (the MESH template argument; the forward only): category-2 rows
// (triangles stored as vertices) join the unrolled scan through the
// watertight test, and each mesh part is traversed from device memory by
// scan_mesh_part, the port of megakernel.py:337 _scan_mesh_part. The TPU
// kernel walks the chunk BVH once per ray TILE (a box is entered when any
// ray of the tile can hit it) and broadcasts each triangle to every lane of
// the tile. Here each lane walks the boxes for its own ray, and the lanes of
// a warp scan each entered chunk together, 128 triangles spread over the
// lanes (scan_mesh_part). The result is the same: the boxes are
// conservative (padded by 4 ulp) and the mesh tie rule (t < best, or t ==
// best and the higher id) does not depend on the order in which triangles
// are tested. A mesh hit records slot = P + part, whose meta row carries
// the part's material and spectra.
//
// Deferred mode (bounce's DEFER; the wavefront's shade step, shade_step.cu):
// the closest hit comes in from outside (the walk kernel's mesh winner
// folded into the unrolled winner) and NEE emits its shadow ray and
// contribution instead of adding to L, as make_bounce(defer_nee=True).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pathtrace {

constexpr float T_MIN = 0.001f;
constexpr float ETA1 = 1.0f;
constexpr float ETA2 = 1.5f;
constexpr float ETA_IN = (float)(1.0 / 1.5);  // ETA1 / ETA2
constexpr float ETA_OUT = 1.5f;               // ETA2 / ETA1
constexpr float INV_PI = (float)(1.0 / 3.14159265358979323846);
constexpr float TWO_PI = (float)(2.0 * 3.14159265358979323846);

constexpr int MAX_PRIMS = 256;
constexpr int MAX_LIGHTS = 64;
constexpr int MAX_PARTS = 8;
constexpr int META = 5;  // row, category, material, emission, reflectance
constexpr int THREADS = 128;

// The chunk packing of kernels/meshpack.py.
constexpr int TRI_WORDS = 16;  // v0 v1 v2, id, unit normal, 3 pad
constexpr int TRIS_PER_CHUNK = 128;
constexpr int ROW_WORDS = 128;  // 8 triangles per row, 16 rows per chunk
constexpr int LEAF_CHUNKS = 4;
constexpr int BOX_WORDS = 8;    // lo.xyz hi.xyz pad pad
constexpr int NODE_WORDS = 8;   // skip, chunk_start, is_leaf, pad

enum { DIFFUSE = 0, LIGHT = 1, GLASS = 2, MIRROR = 3 };

// The MESH argument of scan and bounce: no mesh, the mesh mode, the mesh
// mode that also counts its work into mesh_work, or triangle rows through
// the watertight test with no mesh part walked (the builds that never see
// a part: the shade step's scans of the unrolled rows, shade_step.cu, the
// taped="full" forward and both backward kernels), which then compile no
// traversal.
enum { MESH_NONE = 0, MESH_WALK = 1, MESH_COUNT = 2, MESH_ROWS = 3 };

// Work counts of the counting builds, one column per thread of the block:
// casts (closest-hit and shadow scans), box tests (nodes and chunks),
// triangle plane tests and triangle inside tests; the mesh traversal
// (scan_mesh_part) also counts its chunk scans (one per ray and entered
// chunk), the lanes that ran them, summed over the scans, and the inside
// tests that any scan of those chunks must make (W_NEEDED: those of the
// triangles whose plane t the chunk's final best does not beat, the
// winner's included), which no order of the scan can avoid. Kernels
// without a traversal leave the last three at zero. Only the kernels that
// count reference them.
enum {
  W_CAST = 0, W_BOX = 1, W_PLANE = 2, W_INSIDE = 3, W_SCAN = 4, W_LANES = 5,
  W_NEEDED = 6, WORK_KINDS = 7
};
__shared__ unsigned mesh_work[WORK_KINDS][THREADS];

// Zero this thread's work counts.
__device__ __forceinline__ void work_clear() {
  for (int k = 0; k < WORK_KINDS; ++k) mesh_work[k][threadIdx.x] = 0;
}

// Add the block's work counts to work[WORK_KINDS]. Every thread of the
// block must call it.
__device__ void work_flush(unsigned long long* __restrict__ work) {
  __syncthreads();
  if (threadIdx.x < WORK_KINDS) {
    unsigned long long sum = 0;
    for (int t = 0; t < THREADS; ++t) sum += mesh_work[threadIdx.x][t];
    atomicAdd(work + threadIdx.x, sum);
  }
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 vadd(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 vscale(float s, V3 a) {
  return {s * a.x, s * a.y, s * a.z};
}
__device__ __forceinline__ float vdot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 vnormalize(V3 a) {
  float s = vdot(a, a);
  s = s < 1e-20f ? 1.0f : s;
  return vscale(1.0f / sqrtf(s), a);
}

// One mesh part's packed arrays in device memory (kernels/meshpack.py).
struct MeshPart {
  const float* tri;    // (n_real_chunks * 16, 128) triangle rows
  const float* cbox;   // (n_chunks, 8) chunk boxes
  const float* nbox;   // (n_nodes, 8) node boxes, DFS order
  const int* nmeta;    // (n_nodes, 8) node meta, DFS order
  int n_nodes;
  int n_real_chunks;   // chunks with stored rows; the rest are padding
};

// The mesh parts of a launch, passed by value as a kernel argument
// (__grid_constant__, so that taking its address copies nothing).
struct MeshParts {
  int n;
  MeshPart part[MAX_PARTS];
};

struct Scene {
  float prim[MAX_PRIMS * 12];
  float n0[MAX_PRIMS * 3];  // unit plane normal of patches and triangles
  float inv_e1[MAX_PRIMS];
  float inv_e2[MAX_PRIMS];
  int meta[(MAX_PRIMS + MAX_PARTS) * META];  // slots, then mesh parts
  int light_row[MAX_LIGHTS];
  int light_slot[MAX_LIGHTS];
  float light_area[MAX_LIGHTS];
  int n_parts;
  MeshPart part[MAX_PARTS];
};

struct Hit {
  float t;
  int idx;   // original row id, -1 on a miss
  int slot;  // packed slot of the winner
  V3 pos, nrm;
};

// The scene of the forward's global-table build (megakernel_fwd.cu
// megakernel_fwd_wide): any number of slots, each one REC_WORDS record in
// device memory (wide_tables_kernel writes them), read through L1; the
// lights in shared memory, as in Scene. Every lane of a warp reads the same
// record at the same time, so each load is a broadcast. No mesh part
// (WideMeshScene adds them).
//
// A record is four 16-byte words: (d1.xyz, row), (d2.xyz, inv_e1),
// (d3.xyz, inv_e2), (n0.xyz, category), where d1-d3 are the primitive
// row's three vectors (a patch's origin and edges, a sphere's center and
// (radius, radius, radius), a triangle's vertices) and row and category
// are stored as int bits; a sphere's n0 and inverse lengths are 0.
constexpr int REC_WORDS = 16;

struct WideScene {
  const float* rec;  // (P, REC_WORDS) slot records
  const int* meta;   // (P, META), as Scene's; then mesh parts (WideMeshScene)
  int light_row[MAX_LIGHTS];
  int light_slot[MAX_LIGHTS];
  float light_area[MAX_LIGHTS];
};

// WideScene with mesh parts (megakernel_fwd_wide_mesh.cu): the unrolled
// rows as records in device memory, then each part walked through its chunk
// BVH as in Scene (scan_mesh_part). meta holds P slot rows, then one row
// per part. A type of its own, so that the builds without parts keep
// WideScene's shared memory and registers.
struct WideMeshScene : WideScene {
  int n_parts;
  MeshPart part[MAX_PARTS];
};

// Word k (0-3) of slot's record: a plain load (cached in L1), which the
// compiler merges where a scan reads a word twice.
__device__ __forceinline__ float4 rec4(const WideScene& s, int slot, int k) {
  return reinterpret_cast<const float4*>(s.rec)[(long long)slot * 4 + k];
}

// What the scan and NEE read of a slot, from either table: its vector at
// column c (0, 3 or 6: d1, d2, d3), original row, category, unit plane
// normal, inverse squared edge lengths and sphere radius.
__device__ __forceinline__ V3 prim3(const Scene& s, int slot, int c) {
  const float* p = &s.prim[slot * 12 + c];
  return {p[0], p[1], p[2]};
}
__device__ __forceinline__ V3 prim3(const WideScene& s, int slot, int c) {
  const float4 v = rec4(s, slot, c / 3);
  return {v.x, v.y, v.z};
}
__device__ __forceinline__ int slot_row(const Scene& s, int slot) {
  return s.meta[slot * META + 0];
}
__device__ __forceinline__ int slot_row(const WideScene& s, int slot) {
  return __float_as_int(rec4(s, slot, 0).w);
}
__device__ __forceinline__ int slot_cat(const Scene& s, int slot) {
  return s.meta[slot * META + 1];
}
__device__ __forceinline__ int slot_cat(const WideScene& s, int slot) {
  return __float_as_int(rec4(s, slot, 3).w);
}
__device__ __forceinline__ V3 slot_n0(const Scene& s, int slot) {
  return {s.n0[slot * 3], s.n0[slot * 3 + 1], s.n0[slot * 3 + 2]};
}
__device__ __forceinline__ V3 slot_n0(const WideScene& s, int slot) {
  const float4 v = rec4(s, slot, 3);
  return {v.x, v.y, v.z};
}
__device__ __forceinline__ float slot_inv_e1(const Scene& s, int slot) {
  return s.inv_e1[slot];
}
__device__ __forceinline__ float slot_inv_e1(const WideScene& s, int slot) {
  return rec4(s, slot, 1).w;
}
__device__ __forceinline__ float slot_inv_e2(const Scene& s, int slot) {
  return s.inv_e2[slot];
}
__device__ __forceinline__ float slot_inv_e2(const WideScene& s, int slot) {
  return rec4(s, slot, 2).w;
}
__device__ __forceinline__ float slot_radius(const Scene& s, int slot) {
  return s.prim[slot * 12 + 3];
}
__device__ __forceinline__ float slot_radius(const WideScene& s, int slot) {
  return rec4(s, slot, 1).x;
}

// The plane constants of a patch (edges e1, e2) or triangle (edges v1 - v0,
// v2 - v0) slot, in the reference's op order (kernels/megakernel.py:273-
// 295): the unit normal and the inverse squared edge lengths.
__device__ __forceinline__ void slot_frame(V3 e1, V3 e2, V3& n0,
                                           float& inv_e1, float& inv_e2) {
  const V3 n_raw = vcross(e1, e2);
  const float n_len2 = n_raw.x * n_raw.x + n_raw.y * n_raw.y + n_raw.z * n_raw.z;
  const float inv_len = 1.0f / sqrtf(fmaxf(n_len2, 1e-30f));
  n0 = {n_raw.x * inv_len, n_raw.y * inv_len, n_raw.z * inv_len};
  inv_e1 = 1.0f / fmaxf(e1.x * e1.x + e1.y * e1.y + e1.z * e1.z, 1e-12f);
  inv_e2 = 1.0f / fmaxf(e2.x * e2.x + e2.y * e2.y + e2.z * e2.z, 1e-12f);
}

// The area of a light patch of edges e1, e2 (megakernel.py:496-500).
__device__ __forceinline__ float patch_area(V3 e1, V3 e2) {
  return sqrtf(fmaxf(e1.x * e1.x + e1.y * e1.y + e1.z * e1.z, 1e-30f)) *
         sqrtf(fmaxf(e2.x * e2.x + e2.y * e2.y + e2.z * e2.z, 1e-30f));
}

// Load the scene tables into shared memory and precompute the per-slot
// plane constants and per-light areas, in the reference's op order
// (kernels/megakernel.py:273-295 and :496-500). meta holds P slot rows,
// then one row per mesh part of mp (none when mp is null: the backward
// kernels). Every thread of the block must call it; it ends with
// __syncthreads().
__device__ void load_scene(Scene& s, const float* __restrict__ prims,
                           const int* __restrict__ meta, int P,
                           const int* __restrict__ lights, int n_lights,
                           const MeshParts* mp = nullptr) {
  const int n_parts = mp ? mp->n : 0;
  for (int i = threadIdx.x; i < P * 12; i += blockDim.x) s.prim[i] = prims[i];
  for (int i = threadIdx.x; i < (P + n_parts) * META; i += blockDim.x)
    s.meta[i] = meta[i];
  for (int i = threadIdx.x; i < n_lights; i += blockDim.x) {
    s.light_row[i] = lights[2 * i];
    s.light_slot[i] = lights[2 * i + 1];
  }
  if (threadIdx.x == 0) {
    s.n_parts = n_parts;
    for (int i = 0; i < n_parts; ++i) s.part[i] = mp->part[i];
  }
  __syncthreads();
  for (int slot = threadIdx.x; slot < P; slot += blockDim.x) {
    const int cat = s.meta[slot * META + 1];
    if (cat == 1) continue;
    // triangles store vertices: their edges are v1 - v0 and v2 - v0
    const V3 e1 = cat == 2 ? vsub(prim3(s, slot, 3), prim3(s, slot, 0))
                           : prim3(s, slot, 3);
    const V3 e2 = cat == 2 ? vsub(prim3(s, slot, 6), prim3(s, slot, 0))
                           : prim3(s, slot, 6);
    V3 n0;
    slot_frame(e1, e2, n0, s.inv_e1[slot], s.inv_e2[slot]);
    s.n0[slot * 3 + 0] = n0.x;
    s.n0[slot * 3 + 1] = n0.y;
    s.n0[slot * 3 + 2] = n0.z;
  }
  for (int l = threadIdx.x; l < n_lights; l += blockDim.x) {
    const int slot = s.light_slot[l];
    s.light_area[l] = patch_area(prim3(s, slot, 3), prim3(s, slot, 6));
  }
  __syncthreads();
}

// WideScene's load_scene: the record and meta tables stay in device memory
// (rec as wide_tables_kernel wrote it); the light rows and areas go to
// shared memory. Every thread of the block must call it; it ends with
// __syncthreads().
__device__ void load_wide_scene(WideScene& s, const float* __restrict__ rec,
                                const int* __restrict__ meta,
                                const int* __restrict__ lights,
                                int n_lights) {
  if (threadIdx.x == 0) {
    s.rec = rec;
    s.meta = meta;
  }
  for (int i = threadIdx.x; i < n_lights; i += blockDim.x) {
    s.light_row[i] = lights[2 * i];
    s.light_slot[i] = lights[2 * i + 1];
  }
  __syncthreads();
  for (int l = threadIdx.x; l < n_lights; l += blockDim.x) {
    const int slot = s.light_slot[l];
    s.light_area[l] = patch_area(prim3(s, slot, 3), prim3(s, slot, 6));
  }
  __syncthreads();
}

// load_wide_scene, then the mesh parts' tables into shared memory.
__device__ void load_wide_mesh_scene(WideMeshScene& s,
                                     const float* __restrict__ rec,
                                     const int* __restrict__ meta,
                                     const int* __restrict__ lights,
                                     int n_lights, const MeshParts& mp) {
  if (threadIdx.x == 0) {
    s.n_parts = mp.n;
    for (int i = 0; i < mp.n; ++i) s.part[i] = mp.part[i];
  }
  load_wide_scene(s, rec, meta, lights, n_lights);
}

// Per-ray constants of the watertight triangle test (Woop, Benthin and
// Wald 2013; ops/intersect.py watertight_setup): kz is the axis of the
// direction's largest magnitude, kx and ky the cyclic others.
struct Watertight {
  int kx, ky, kz;
  float sx, sy, okx, oky, okz;
};

__device__ __forceinline__ float sel3(int k, V3 v) {
  return k == 0 ? v.x : (k == 1 ? v.y : v.z);
}

__device__ __forceinline__ Watertight watertight_setup(V3 o, V3 d) {
  const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
  Watertight w;
  w.kz = (ax >= ay && ax >= az) ? 0 : (ay >= az ? 1 : 2);
  w.kx = w.kz == 2 ? 0 : w.kz + 1;
  w.ky = w.kx == 2 ? 0 : w.kx + 1;
  const float dkz = sel3(w.kz, d);
  const float safe = dkz == 0.0f ? 1.0f : dkz;  // 0 only for null rays
  w.sx = sel3(w.kx, d) / safe;
  w.sy = sel3(w.ky, d) / safe;
  w.okx = sel3(w.kx, o);
  w.oky = sel3(w.ky, o);
  w.okz = sel3(w.kz, o);
  return w;
}

// The edge-function inside test, both orientations accepted. Each edge
// function is a difference of two separately rounded products (the build's
// --fmad=false): a shared edge then evaluates to exactly the negated value
// in its two triangles, and no ray falls through it.
__device__ __forceinline__ bool watertight_inside(const Watertight& w, V3 v0,
                                                  V3 v1, V3 v2) {
  const float a_z = sel3(w.kz, v0) - w.okz;
  const float b_z = sel3(w.kz, v1) - w.okz;
  const float c_z = sel3(w.kz, v2) - w.okz;
  const float ax = (sel3(w.kx, v0) - w.okx) - w.sx * a_z;
  const float ay = (sel3(w.ky, v0) - w.oky) - w.sy * a_z;
  const float bx = (sel3(w.kx, v1) - w.okx) - w.sx * b_z;
  const float by = (sel3(w.ky, v1) - w.oky) - w.sy * b_z;
  const float cx = (sel3(w.kx, v2) - w.okx) - w.sx * c_z;
  const float cy = (sel3(w.ky, v2) - w.oky) - w.sy * c_z;
  const float u = cx * by - cy * bx;
  const float v = ax * cy - ay * cx;
  const float ww = bx * ay - by * ax;
  const bool pos = u >= 0.0f && v >= 0.0f && ww >= 0.0f;
  const bool neg = u <= 0.0f && v <= 0.0f && ww <= 0.0f;
  return (pos || neg) && (u + v + ww) != 0.0f;
}

// Reciprocal direction of the slab tests (megakernel.py:362-367): a
// component below 1e-12 in magnitude becomes +-1e30, keeping its sign.
__device__ __forceinline__ void inv_dir(V3 d, float inv_d[3]) {
  const float dc[3] = {d.x, d.y, d.z};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const bool tiny = fabsf(dc[c]) < 1e-12f;
    const float sign = dc[c] < 0.0f ? -1.0f : 1.0f;
    inv_d[c] = tiny ? sign * 1e30f : 1.0f / dc[c];
  }
}

// Slab test of a ray against box bb (lo.xyz, hi.xyz), the interval padded
// by 4 ulp on both ends (Ize 2013; megakernel.py:369-390): the box may be
// hit closer than t_best. Degenerate empty boxes (lo == hi == BIG) give an
// infinite entry and are excluded explicitly. t_enter receives the padded
// entry distance (binned.py:72 _slab_t_enter), which ranks the candidate
// chunks (candidates.cu). An axis the ray runs parallel to (inv_dir's
// +-1e30) bounds nothing where lo <= o <= hi, and misses the box
// elsewhere: the reference's product (face - o) * 1e30 is 0 for a ray
// lying in a face, an exit at t = 0 that missed a box whose triangles
// the ray hits. Such rays are rare, so they take a path of their own,
// chosen per ray (the condition does not depend on the box), and every
// other ray runs the reference's three slabs alone.
__device__ __forceinline__ bool slab_enter(const float* __restrict__ bb, V3 o,
                                           const float* inv_d, float t_best,
                                           float& t_enter_out) {
  const float oc[3] = {o.x, o.y, o.z};
  float t_enter = -INFINITY, t_exit = INFINITY;
  if (fabsf(inv_d[0]) != 1e30f && fabsf(inv_d[1]) != 1e30f &&
      fabsf(inv_d[2]) != 1e30f) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float t0 = (bb[c] - oc[c]) * inv_d[c];
      const float t1 = (bb[3 + c] - oc[c]) * inv_d[c];
      t_enter = fmaxf(t_enter, fminf(t0, t1));
      t_exit = fminf(t_exit, fmaxf(t0, t1));
    }
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float t0, t1;
      if (fabsf(inv_d[c]) == 1e30f) {  // parallel to this axis's slab
        t0 = bb[c] <= oc[c] && oc[c] <= bb[3 + c] ? -INFINITY : INFINITY;
        t1 = INFINITY;
      } else {
        t0 = (bb[c] - oc[c]) * inv_d[c];
        t1 = (bb[3 + c] - oc[c]) * inv_d[c];
      }
      t_enter = fmaxf(t_enter, fminf(t0, t1));
      t_exit = fminf(t_exit, fmaxf(t0, t1));
    }
  }
  const float pad = 4.0f * 1.1920928955078125e-7f;  // 4 * 2^-23
  t_exit = t_exit + fabsf(t_exit) * pad;
  t_enter = t_enter - fabsf(t_enter) * pad;
  t_enter_out = t_enter;
  return t_enter <= t_exit && t_exit >= T_MIN && t_enter <= t_best &&
         t_enter < INFINITY;
}

__device__ __forceinline__ bool slab(const float* __restrict__ bb, V3 o,
                                     const float* inv_d, float t_best) {
  float t_enter;
  return slab_enter(bb, o, inv_d, t_best, t_enter);
}

// One triangle of a chunk against one ray, scan_mesh_part's per-lane test
// (pair.cu's scan_pair runs the same arithmetic): whether triangle row `tri`
// (not padding, id -1, and not the triangle `exclude`) is hit at a t that
// beats (best_t, best_i) under the mesh tie rule (t < best_t, or t ==
// best_t and the higher id). The hit's t, id and the normal facing the ray
// come back in t, tid and nrm. With COUNT, counts its plane and inside
// tests into mesh_work.
template <bool COUNT>
__device__ __forceinline__ bool tri_test(const float* __restrict__ tri, V3 o,
                                         V3 d, int exclude,
                                         const Watertight& wt, float best_t,
                                         int best_i, float& t, int& tid,
                                         V3& nrm) {
  tid = (int)tri[9];
  if (tid < 0 || tid == exclude) return false;
  if (COUNT) ++mesh_work[W_PLANE][threadIdx.x];
  const V3 n0 = {tri[10], tri[11], tri[12]};
  const float ndotd = n0.x * d.x + n0.y * d.y + n0.z * d.z;
  const bool flip = ndotd > 0.0f;
  if (fabsf(flip ? -ndotd : ndotd) < 1e-4f) return false;  // grazing
  const V3 p0 = {tri[0], tri[1], tri[2]};
  const float num = n0.x * (p0.x - o.x) + n0.y * (p0.y - o.y) +
                    n0.z * (p0.z - o.z);
  t = num / ndotd;
  if (!(t >= T_MIN && (t < best_t || (t == best_t && tid > best_i))))
    return false;
  if (COUNT) ++mesh_work[W_INSIDE][threadIdx.x];
  if (!watertight_inside(wt, p0, {tri[3], tri[4], tri[5]},
                         {tri[6], tri[7], tri[8]}))
    return false;
  const float sgn = flip ? -1.0f : 1.0f;
  nrm = {sgn * n0.x, sgn * n0.y, sgn * n0.z};
  return true;
}

// tri_test's plane stage alone, computed as tri_test computes it, for
// scan_mesh_part's count of the inside tests its chunk scans need: whether
// triangle row `tri` is a triangle (not padding, and not `exclude`) whose
// plane the ray does not graze, with its id and the plane's t.
__device__ __forceinline__ bool tri_plane(const float* __restrict__ tri, V3 o,
                                          V3 d, int exclude, int& tid,
                                          float& t) {
  tid = (int)tri[9];
  if (tid < 0 || tid == exclude) return false;
  const V3 n0 = {tri[10], tri[11], tri[12]};
  const float ndotd = n0.x * d.x + n0.y * d.y + n0.z * d.z;
  if (fabsf(ndotd) < 1e-4f) return false;  // grazing
  const V3 p0 = {tri[0], tri[1], tri[2]};
  const float num = n0.x * (p0.x - o.x) + n0.y * (p0.y - o.y) +
                    n0.z * (p0.z - o.z);
  t = num / ndotd;
  return true;
}

// One lane's stackless skip-link walk of part mp's DFS node array (descend
// on a box hit, else jump to `skip`; an entered leaf re-tests each of its
// chunk boxes), advanced to the next chunk it enters, boxes culled by
// best_t: returns that chunk, or -1 when the walk is done. The walk's state
// is `node`, the node it is at, and `leaf_i`, the next chunk of an entered
// leaf to test (-1 before the leaf's own box test). With COUNT, counts its
// box tests into mesh_work.
template <bool COUNT>
__device__ __forceinline__ int next_chunk(const MeshPart& mp, V3 o,
                                          const float* inv_d, float best_t,
                                          int& node, int& leaf_i) {
  while (node < mp.n_nodes) {
    const int* meta = mp.nmeta + (long long)node * NODE_WORDS;
    if (leaf_i < 0) {
      if (COUNT) ++mesh_work[W_BOX][threadIdx.x];
      const bool hit =
          slab(mp.nbox + (long long)node * BOX_WORDS, o, inv_d, best_t);
      if (!(hit && meta[2] > 0)) {  // a miss, or an inner node entered
        node = hit ? node + 1 : meta[0];
        continue;
      }
      leaf_i = 0;
    }
    while (leaf_i < LEAF_CHUNKS) {
      const int k = meta[1] + leaf_i++;
      if (k >= mp.n_real_chunks) break;  // padding: no rows stored
      if (COUNT) ++mesh_work[W_BOX][threadIdx.x];
      if (slab(mp.cbox + (long long)k * BOX_WORDS, o, inv_d, best_t)) return k;
    }
    leaf_i = -1;
    node = meta[0];
  }
  return -1;
}

// The order of t values as unsigned keys: ascending with t for every t
// that is not NaN (a hit's t is never NaN: it passed t >= T_MIN).
__device__ __forceinline__ unsigned t_key(float t) {
  const unsigned b = __float_as_uint(t);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Closest hit against mesh part mp, whose hits record `slot`, of the rays
// of the warp's lanes in `mask`, which must all call it together (every
// collective below uses that mask, and they all leave together). A lane
// with `walking` false has no ray here: it only helps the others scan.
//
// A while-while traversal (Aila and Laine 2009) whose triangle loop is
// spread across the lanes. Each walking lane advances its own box walk
// (next_chunk) until it has one entered chunk to scan or is done. Then, for
// each lane with a chunk, in lane order, every lane of the mask scans that
// chunk against the owner's ray (o, d, the watertight constants, exclude
// and its best, broadcast by shuffles): the lane of rank q among m tests
// triangles q, q+m, q+2m, ..., so neighbouring lanes read neighbouring
// 64-byte rows, and keeps its own best under the tie rule from the owner's
// best at the chunk's entry. A reduction over the lanes (min t, then max id
// among the lanes at that t) picks the winner, whose t, id and normal the
// owner takes, with pos = o + t*d as a serial scan computes it.
//
// Exact: the tie rule is a strict total order on (t, id), ids are unique in
// the scene, and the serial scan and the reduction both compute its maximum
// over the owner's entry best and the chunk's hits; a lane's culling by its
// running best saves only inside tests, never a winner. Each lane visits
// the same boxes and chunks, in the same order and with the same best at
// every chunk boundary, as a walk that scans its chunks alone, so h
// updates as that walk's would. With COUNT, counts box, plane and inside
// tests, chunk scans (W_SCAN), the lanes that ran them (W_LANES) and, in a
// second pass over each chunk once its winner is known, the inside tests
// that any order of its scan needs (W_NEEDED): the lanes' own culling
// starts from the entry best and tests more.
template <bool COUNT>
__device__ void scan_mesh_part(const MeshPart& mp, int slot, V3 o, V3 d,
                               int exclude, const Watertight& wt, Hit& h,
                               bool walking, unsigned mask) {
  const int lane = threadIdx.x & 31;
  const int rank = __popc(mask & ((1u << lane) - 1u));
  const int m = __popc(mask);
  float inv_d[3];
  inv_dir(d, inv_d);
  int node = 0, leaf_i = -1;
  int k = walking ? next_chunk<COUNT>(mp, o, inv_d, h.t, node, leaf_i) : -1;
  for (unsigned todo; (todo = __ballot_sync(mask, k >= 0)) != 0u;) {
    for (; todo; todo &= todo - 1u) {
      const int src = __ffs(todo) - 1;
      const int kc = __shfl_sync(mask, k, src);
      const V3 so = {__shfl_sync(mask, o.x, src), __shfl_sync(mask, o.y, src),
                     __shfl_sync(mask, o.z, src)};
      const V3 sd = {__shfl_sync(mask, d.x, src), __shfl_sync(mask, d.y, src),
                     __shfl_sync(mask, d.z, src)};
      Watertight sw;
      sw.kx = __shfl_sync(mask, wt.kx, src);
      sw.ky = __shfl_sync(mask, wt.ky, src);
      sw.kz = __shfl_sync(mask, wt.kz, src);
      sw.sx = __shfl_sync(mask, wt.sx, src);
      sw.sy = __shfl_sync(mask, wt.sy, src);
      sw.okx = __shfl_sync(mask, wt.okx, src);
      sw.oky = __shfl_sync(mask, wt.oky, src);
      sw.okz = __shfl_sync(mask, wt.okz, src);
      const int sex = __shfl_sync(mask, exclude, src);
      float bt = __shfl_sync(mask, h.t, src);
      int bi = __shfl_sync(mask, h.idx, src);
      V3 bn = {0.0f, 0.0f, 0.0f};
      bool found = false;
      const float* rows = mp.tri + (long long)kc * TRIS_PER_CHUNK * TRI_WORDS;
      for (int j = rank; j < TRIS_PER_CHUNK; j += m) {
        float t;
        int tid;
        V3 nrm;
        if (tri_test<COUNT>(rows + j * TRI_WORDS, so, sd, sex, sw, bt, bi, t,
                            tid, nrm)) {
          bt = t;
          bi = tid;
          bn = nrm;
          found = true;
        }
      }
      const unsigned key = found ? t_key(bt) : 0xFFFFFFFFu;
      const unsigned key_min = __reduce_min_sync(mask, key);
      const bool at_min = found && key == key_min;
      const int id_max = __reduce_max_sync(mask, at_min ? bi : -2147483647 - 1);
      const unsigned win = __ballot_sync(mask, at_min && bi == id_max);
      if (win) {
        const int w = __ffs(win) - 1;
        const float t_w = __shfl_sync(mask, bt, w);
        const V3 n_w = {__shfl_sync(mask, bn.x, w), __shfl_sync(mask, bn.y, w),
                        __shfl_sync(mask, bn.z, w)};
        if (lane == src) {
          h.t = t_w;
          h.idx = id_max;
          h.slot = slot;
          h.pos = vadd(o, vscale(t_w, d));
          h.nrm = n_w;
        }
      }
      if (COUNT) {
        if (lane == src) {
          ++mesh_work[W_SCAN][threadIdx.x];
          mesh_work[W_LANES][threadIdx.x] += m;
        }
        // the chunk's final best, the owner's h: its winner or its entry
        const float t_f = __shfl_sync(mask, h.t, src);
        const int i_f = __shfl_sync(mask, h.idx, src);
        for (int j = rank; j < TRIS_PER_CHUNK; j += m) {
          float t;
          int tid;
          if (tri_plane(rows + j * TRI_WORDS, so, sd, sex, tid, t) &&
              t >= T_MIN && (t < t_f || (t == t_f && tid >= i_f)))
            ++mesh_work[W_NEEDED][threadIdx.x];
        }
      }
    }
    if (k >= 0) k = next_chunk<COUNT>(mp, o, inv_d, h.t, node, leaf_i);
  }
}

// In-order closest-hit scan. `t <= best` lets the LAST hit win ties: the
// ceiling light is coplanar with the ceiling and visible only through it.
// With MESH, triangle rows take the watertight test and the mesh parts
// are traversed after the unrolled rows.
template <int MESH, class SceneT>
__device__ Hit scan(const SceneT& s, int P, V3 o, V3 d, int exclude) {
  Hit h;
  h.t = INFINITY;
  h.idx = -1;
  h.slot = -1;
  h.pos = {0.0f, 0.0f, 0.0f};
  h.nrm = {0.0f, 0.0f, 0.0f};
  if (MESH == MESH_COUNT) ++mesh_work[W_CAST][threadIdx.x];
  const float a = vdot(d, d);
  Watertight wt;
  if (MESH) wt = watertight_setup(o, d);
  for (int slot = 0; slot < P; ++slot) {
    const int row = slot_row(s, slot);
    const int cat = slot_cat(s, slot);
    if (row == exclude) continue;
    if (cat == 0 || (MESH && cat == 2)) {
      const V3 p0 = prim3(s, slot, 0);
      const V3 n0 = slot_n0(s, slot);
      const float ndotd = n0.x * d.x + n0.y * d.y + n0.z * d.z;
      const bool flip = ndotd > 0.0f;
      const float ndotd_f = flip ? -ndotd : ndotd;
      if (fabsf(ndotd_f) < 1e-4f) continue;  // grazing
      const float num = n0.x * (p0.x - o.x) + n0.y * (p0.y - o.y) +
                        n0.z * (p0.z - o.z);
      const float t = num / ndotd;
      if (!(t >= T_MIN && t <= h.t)) continue;
      const V3 p = vadd(o, vscale(t, d));
      if (MESH && cat == 2) {
        if (!watertight_inside(wt, p0, prim3(s, slot, 3), prim3(s, slot, 6)))
          continue;
      } else {
        const V3 m = vsub(p, p0);
        const float u = vdot(m, prim3(s, slot, 3)) * slot_inv_e1(s, slot);
        const float v = vdot(m, prim3(s, slot, 6)) * slot_inv_e2(s, slot);
        if (!(u >= 0.0f && u <= 1.0f && v >= 0.0f && v <= 1.0f)) continue;
      }
      const float sgn = flip ? -1.0f : 1.0f;
      h.t = t;
      h.idx = row;
      h.slot = slot;
      h.pos = p;
      h.nrm = {sgn * n0.x, sgn * n0.y, sgn * n0.z};
    } else {  // sphere: radius in column 3
      const V3 c = prim3(s, slot, 0);
      const float radius = slot_radius(s, slot);
      const V3 co = vsub(o, c);
      const float b = 2.0f * vdot(d, co);
      const float c2 = vdot(co, co) - radius * radius;
      const float disc = b * b - 4.0f * a * c2;
      if (!(disc > 0.0f) || !(a > 1e-12f)) continue;
      const float sq = sqrtf(disc);
      const float denom = 2.0f * a;
      const float t_near = (-b - sq) / denom;
      const float t_far = (-b + sq) / denom;
      const bool near_ok = t_near >= T_MIN && t_near <= h.t;
      const float t = near_ok ? t_near : t_far;
      if (!(t >= T_MIN && t <= h.t)) continue;
      const V3 p = vadd(o, vscale(t, d));
      h.t = t;
      h.idx = row;
      h.slot = slot;
      h.pos = p;
      h.nrm = vnormalize(vsub(p, c));
    }
  }
  if constexpr (MESH == MESH_WALK || MESH == MESH_COUNT)
    // the lanes that reach here together scan each chunk together
    for (int pi = 0; pi < s.n_parts; ++pi)
      scan_mesh_part<MESH == MESH_COUNT>(s.part[pi], P + pi, o, d, exclude,
                                         wt, h, true, __activemask());
  return h;
}

__device__ __forceinline__ void pcg4d(uint32_t* v) {
  uint32_t x = v[0] * 1664525u + 1013904223u;
  uint32_t y = v[1] * 1664525u + 1013904223u;
  uint32_t z = v[2] * 1664525u + 1013904223u;
  uint32_t w = v[3] * 1664525u + 1013904223u;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  v[0] = x;
  v[1] = y;
  v[2] = z;
  v[3] = w;
}

// One masked draw: low 24 bits of the advanced state's x word, times 2^-24.
__device__ __forceinline__ float draw(uint32_t* seed) {
  pcg4d(seed);
  return (float)(int)(seed[0] & 0x00FFFFFFu) * (1.0f / 16777216.0f);
}

template <class SceneT>
__device__ __forceinline__ float light_pdf(const SceneT& s, int l, int n_lights,
                                           V3 n_at_light, V3 ray_dir, V3 l_pos,
                                           V3 r_origin) {
  const float abs_cos = fmaxf(1e-5f, fabsf(-vdot(n_at_light, ray_dir)));
  const V3 diff = vsub(l_pos, r_origin);
  const float dist2 = vdot(diff, diff);
  const float geo = abs_cos / fmaxf(dist2, 1e-12f);
  const float pdf =
      (1.0f / fmaxf(s.light_area[l], 1e-12f)) / geo / (float)n_lights;
  return fminf(fmaxf(pdf, 0.0f), 1e16f);
}

__device__ __forceinline__ float power_heuristic(float f, float g) {
  const float r = g / fmaxf(f, 1e-12f);
  return 1.0f / (1.0f + r * r);
}

// The path state carried from one bounce to the next (megakernel.py:62:
// 16 differentiable words, 4 seed words, exclude / specular / in_trans).
struct Carry {
  V3 o, d;
  float L[4];
  float beta[4];
  float last_pdf;
  float eta_scale;
  uint32_t seed[4];
  int exclude;
  bool specular;
  bool in_trans;
};

// Launch-wide constants of one trace.
struct Trace {
  int P, n_lights, S;
  const float* spect;  // (S*4, R), ray axis minor
  long long R;
  int max_depth, rr_start;
};

// Spectrum `row` at ray r's 4 hero wavelengths.
__device__ __forceinline__ void gets(const Trace& tr, long long r, int row,
                                     float* v) {
  for (int j = 0; j < 4; ++j) v[j] = tr.spect[(long long)(row * 4 + j) * tr.R + r];
}

// What the backward's adjoint of one bounce reads back from its forward
// recompute: the decisions taken and the values that cost a scan to get.
struct BounceRec {
  Hit hit;          // main closest hit
  bool scatter;     // the ray left this vertex (not a light, depth < max)
  float beta_bl[4]; // beta after Beer-Lambert
  float u_p, v_p, u_h, v_h;  // diffuse draws (NEE point, hemisphere)
  int li;           // the light NEE picked
  Hit sh;           // the shadow scan's closest hit
  bool unocc;       // the shadow ray reached the picked light
  bool choose_refl; // glass: reflect (else refract)
  bool rr_surv;     // Russian roulette ran and the ray survived
};

// What a bounce with deferred NEE (the shade step) emits instead of adding
// NEE to L: the light its diffuse scatter picked (-1: none), the shadow
// ray's direction, the winner of its scan of the unrolled rows (t, row) and
// the contribution (brdf * (l_emis * scale)) * beta, the op order of the
// in-kernel L update, which the caller adds unless a mesh part occludes
// the shadow ray. The contribution is 0 where an unrolled row occludes it.
struct DeferredNee {
  int li;
  V3 ldir;
  float t_su;
  int idx_su;
  float contrib[4];
};

// The NEE point on light li and the direction to it from `pos`:
// p_l = l_o + u_p*e1 + v_p*e2, ldir = normalize(p_l - pos).
template <class SceneT>
__device__ __forceinline__ V3 nee_target(const SceneT& s, int li, float u_p,
                                         float v_p) {
  const int sl = s.light_slot[li];
  const V3 l_o = prim3(s, sl, 0);
  const V3 l_e1 = prim3(s, sl, 3);
  const V3 l_e2 = prim3(s, sl, 6);
  return {l_o.x + u_p * l_e1.x + v_p * l_e2.x,
          l_o.y + u_p * l_e1.y + v_p * l_e2.y,
          l_o.z + u_p * l_e1.z + v_p * l_e2.z};
}

// The closest hit a bounce starts from: the given one (the shade step's
// merged winner) or its own scan.
template <int MESH, bool GIVEN, class SceneT>
__device__ __forceinline__ Hit main_hit(const SceneT& s, const Trace& tr,
                                        const Carry& c, const Hit* given) {
  if constexpr (GIVEN) return *given;
  else return scan<MESH>(s, tr.P, c.o, c.d, c.exclude);
}

// One bounce: advances c and returns whether the ray is still alive. With
// REC, records what the adjoint needs in *rec; with MESH, the scans run in
// mesh mode. With DEFER (the shade step, make_bounce's defer_nee), the
// closest hit is *given, and NEE writes *dn instead of adding to L: the
// shadow scan covers only what scan<MESH> covers (the unrolled rows under
// MESH_ROWS), and the caller tests the mesh parts. With TIMED (the timed
// builds of the backward's reverse sweep only), the clock64() cycles this
// thread spends in its scans are added to *scan_clk.
template <bool REC, int MESH = MESH_NONE, bool DEFER = false,
          bool TIMED = false, class SceneT = Scene>
__device__ __forceinline__ bool bounce(const SceneT& s, const Trace& tr,
                                       long long r, int depth, Carry& c,
                                       BounceRec* rec,
                                       const Hit* given = nullptr,
                                       DeferredNee* dn = nullptr,
                                       long long* scan_clk = nullptr) {
  long long t_scan = 0;
  if constexpr (TIMED) t_scan = clock64();
  const Hit hit = main_hit<MESH, DEFER>(s, tr, c, given);
  if constexpr (TIMED) *scan_clk += clock64() - t_scan;
  if (REC) {
    rec->hit = hit;
    rec->scatter = false;
    rec->unocc = false;
    rec->rr_surv = false;
  }
  if (hit.idx < 0) return false;
  c.exclude = hit.idx;
  const int* m = &s.meta[hit.slot * META];
  const int mat = m[2];

  // ---- emissive hit
  if (mat == LIGHT) {
    float le[4];
    gets(tr, r, m[3], le);
    float mis_w = 1.0f;
    if (!(depth == 0 || c.specular)) {
      float pdf_l_hit = 0.0f;
      for (int l = 0; l < tr.n_lights; ++l)
        if (s.light_row[l] == hit.idx)
          pdf_l_hit = light_pdf(s, l, tr.n_lights, hit.nrm, c.d, hit.pos, c.o);
      mis_w = power_heuristic(c.last_pdf, pdf_l_hit);
    }
    for (int j = 0; j < 4; ++j) c.L[j] = c.L[j] + c.beta[j] * le[j] * mis_w;
    return false;
  }
  if (depth >= tr.max_depth) return false;
  if (REC) rec->scatter = true;

  // ---- Beer-Lambert inside glass
  if (c.in_trans) {
    float ext[4];
    gets(tr, r, tr.S - 1, ext);
    const V3 diffp = vsub(hit.pos, c.o);
    const float dsq = vdot(diffp, diffp);
    const float dist = sqrtf(dsq > 0.0f ? dsq : 1.0f) * (dsq > 0.0f ? 1.0f : 0.0f);
    for (int j = 0; j < 4; ++j) c.beta[j] = c.beta[j] * expf(-ext[j] * dist);
  }
  if (REC)
    for (int j = 0; j < 4; ++j) rec->beta_bl[j] = c.beta[j];

  const V3 n = hit.nrm;
  if (mat == DIFFUSE) {
    // ---- NEE + cosine bounce (5 draws)
    const float u_l = draw(c.seed);
    const float u_p = draw(c.seed);
    const float v_p = draw(c.seed);
    const float u_h = draw(c.seed);
    const float v_h = draw(c.seed);
    float brdf[4];
    gets(tr, r, m[4], brdf);
    for (int j = 0; j < 4; ++j) brdf[j] = brdf[j] * INV_PI;

    int li = (int)(u_l * (float)tr.n_lights);
    li = li < 0 ? 0 : (li > tr.n_lights - 1 ? tr.n_lights - 1 : li);
    const int sl = s.light_slot[li];
    const V3 p_l = nee_target(s, li, u_p, v_p);
    const V3 ldir = vnormalize(vsub(p_l, hit.pos));
    if constexpr (TIMED) t_scan = clock64();
    const Hit sh = scan<MESH>(s, tr.P, hit.pos, ldir, hit.idx);
    if constexpr (TIMED) *scan_clk += clock64() - t_scan;
    const bool unocc = sh.idx >= 0 && sh.idx == s.light_row[li];
    if (REC) {
      rec->u_p = u_p;
      rec->v_p = v_p;
      rec->u_h = u_h;
      rec->v_h = v_h;
      rec->li = li;
      rec->sh = sh;
      rec->unocc = unocc;
    }
    if (DEFER) {
      dn->li = li;
      dn->ldir = ldir;
      dn->t_su = sh.t;
      dn->idx_su = sh.idx;
      for (int j = 0; j < 4; ++j) dn->contrib[j] = 0.0f;
    }
    if (unocc) {
      const float cos_t = fmaxf(0.0f, vdot(n, ldir));
      const float pdf_l = light_pdf(s, li, tr.n_lights, sh.nrm, ldir, sh.pos, hit.pos);
      const float pdf_b = cos_t * INV_PI;
      const float w_l = power_heuristic(pdf_l, pdf_b);
      const float scale = cos_t * w_l / fmaxf(pdf_l, 1e-12f);
      float l_emis[4];
      gets(tr, r, s.meta[sl * META + 3], l_emis);
      for (int j = 0; j < 4; ++j) {
        const float nee = l_emis[j] * scale;
        if (DEFER)
          dn->contrib[j] = brdf[j] * nee * c.beta[j];
        else
          c.L[j] = c.L[j] + brdf[j] * nee * c.beta[j];
      }
    }

    // cosine hemisphere
    const float r_h = sqrtf(fmaxf(u_h, 0.0f));
    const float th = TWO_PI * v_h;
    const float xh = r_h * cosf(th);
    const float yh = r_h * sinf(th);
    const float zh = sqrtf(fmaxf(0.0f, 1.0f - u_h));
    const bool z_minor = fabsf(n.z) < 0.999f;
    const V3 up = {z_minor ? 0.0f : 1.0f, 0.0f, z_minor ? 1.0f : 0.0f};
    const V3 tangent = vnormalize(vcross(up, n));
    const V3 bitangent = vcross(n, tangent);
    const V3 bd = {tangent.x * xh + bitangent.x * yh + n.x * zh,
                   tangent.y * xh + bitangent.y * yh + n.y * zh,
                   tangent.z * xh + bitangent.z * yh + n.z * zh};
    const float bounce_pdf = zh * INV_PI;
    const float cos_b = fabsf(vdot(n, bd));
    const float bfac = cos_b / fmaxf(bounce_pdf, 1e-12f);
    for (int j = 0; j < 4; ++j) c.beta[j] = c.beta[j] * brdf[j] * bfac;
    c.d = bd;
    c.last_pdf = bounce_pdf;
    c.specular = false;
  } else if (mat == GLASS) {
    // ---- Fresnel-weighted reflect / refract (1 draw)
    const float u_g = draw(c.seed);
    const float cos_in = vdot(n, c.d);
    const float cosi = fminf(fmaxf(cos_in, -1.0f), 1.0f);
    const float fe = cosi > 0.0f ? ETA_OUT : ETA_IN;
    const float sint2 = fe * fe * (1.0f - cosi * cosi);
    const bool tir = sint2 > 1.0f;
    const float cost = sqrtf(tir ? 1.0f : 1.0f - sint2);
    const float ci = fabsf(cosi);
    const float rs = (ETA1 * ci - ETA2 * cost) / (ETA1 * ci + ETA2 * cost);
    const float rp = (ETA2 * ci - ETA1 * cost) / (ETA2 * ci + ETA1 * cost);
    const float pr = tir ? 1.0f : 0.5f * (rs * rs + rp * rp);
    const float eta = cos_in > 0.0f ? ETA_OUT : ETA_IN;
    const V3 ng = cos_in > 0.0f ? V3{-n.x, -n.y, -n.z} : n;
    const bool choose_refl = u_g < pr / fmaxf(pr + (1.0f - pr), 1e-12f);
    if (REC) rec->choose_refl = choose_refl;
    if (choose_refl) {
      const float nd2 = 2.0f * vdot(ng, c.d);
      c.d = vsub(c.d, vscale(nd2, ng));
    } else {
      const float ndoti = vdot(ng, c.d);
      const float kk = 1.0f - eta * eta * (1.0f - ndoti * ndoti);
      const bool ktir = kk < 0.0f;
      const float sqk = sqrtf(ktir ? 1.0f : kk);
      V3 rft = vsub(vscale(eta, c.d), vscale(eta * ndoti + sqk, ng));
      if (ktir) rft = {0.0f, 0.0f, 0.0f};
      c.d = vnormalize(rft);
      const float eta2v = eta * eta;
      for (int j = 0; j < 4; ++j) c.beta[j] = c.beta[j] * eta2v;
      c.eta_scale = c.eta_scale / eta2v;
      c.in_trans = !c.in_trans;
    }
    c.specular = true;
    c.exclude = -1;
  } else if (mat == MIRROR) {
    const float nd2m = 2.0f * vdot(n, c.d);
    c.d = vsub(c.d, vscale(nd2m, n));
    c.specular = true;
    c.exclude = -1;
  }
  c.o = hit.pos;

  // ---- Russian roulette
  const float r0 = c.beta[0] * c.eta_scale;
  const float r1 = c.beta[1] * c.eta_scale;
  const float r2 = c.beta[2] * c.eta_scale;
  const float max_c = fmaxf(r0, fmaxf(r1, r2));
  if (depth > tr.rr_start && max_c < 1.0f) {
    const float u_r = draw(c.seed);
    const float q = fmaxf(0.0f, 1.0f - max_c);
    if (u_r < q) return false;
    const float inv1q = 1.0f / fmaxf(1.0f - q, 1e-12f);
    for (int j = 0; j < 4; ++j) c.beta[j] = c.beta[j] * inv1q;
    if (REC) rec->rr_surv = true;
  }
  return true;
}

// The carry a camera ray starts with: its origin and direction from the
// (3, R) planes o and d, its seed words from seeds (4, R), u32 bits as
// int32 or u32 values as int64 (the low word either way).
template <class Seed>
__device__ __forceinline__ Carry init_carry(const float* __restrict__ o,
                                            const float* __restrict__ d,
                                            const Seed* __restrict__ seeds,
                                            long long R, long long r) {
  Carry c;
  c.o = {o[0 * R + r], o[1 * R + r], o[2 * R + r]};
  c.d = {d[0 * R + r], d[1 * R + r], d[2 * R + r]};
  for (int k = 0; k < 4; ++k) c.seed[k] = (uint32_t)seeds[k * R + r];
  for (int j = 0; j < 4; ++j) {
    c.L[j] = 0.0f;
    c.beta[j] = 1.0f;
  }
  c.last_pdf = 1.0f;
  c.eta_scale = 1.0f;
  c.exclude = -1;
  c.specular = false;
  c.in_trans = false;
  return c;
}

// The same from the rays (6, R) of the forward's operands: o, then d.
__device__ __forceinline__ Carry init_carry(const float* __restrict__ rays,
                                            const int* __restrict__ seeds,
                                            long long R, long long r) {
  return init_carry(rays, rays + 3 * R, seeds, R, r);
}

// The tape of build_forward(taped="full"): each bounce's INPUT carry, rows
// of (max_depth+1, 16, R) f32 (o3 d3 L4 beta4 last_pdf eta_scale) and
// (max_depth+1, 8, R) i32 (seed words, exclude, specular, in_trans,
// active). Rows after the ray died hold its final carry with active = 0.
constexpr int TAPE_F = 16;
constexpr int TAPE_I = 8;

__device__ __forceinline__ void tape_write(float* __restrict__ tape_f,
                                           int* __restrict__ tape_i,
                                           long long R, long long r,
                                           int depth, const Carry& c,
                                           bool alive) {
  const float fw[TAPE_F] = {c.o.x, c.o.y, c.o.z, c.d.x, c.d.y, c.d.z,
                            c.L[0], c.L[1], c.L[2], c.L[3],
                            c.beta[0], c.beta[1], c.beta[2], c.beta[3],
                            c.last_pdf, c.eta_scale};
  const int iw[TAPE_I] = {(int)c.seed[0], (int)c.seed[1], (int)c.seed[2],
                          (int)c.seed[3], c.exclude, (int)c.specular,
                          (int)c.in_trans, (int)alive};
  for (int k = 0; k < TAPE_F; ++k)
    tape_f[((long long)depth * TAPE_F + k) * R + r] = fw[k];
  for (int k = 0; k < TAPE_I; ++k)
    tape_i[((long long)depth * TAPE_I + k) * R + r] = iw[k];
}

// The input carry of one tape row (its active word is not part of Carry).
__device__ __forceinline__ Carry tape_read(const float* __restrict__ tape_f,
                                           const int* __restrict__ tape_i,
                                           long long R, long long r,
                                           int depth) {
  const long long rf = (long long)depth * TAPE_F;
  const long long ri = (long long)depth * TAPE_I;
  Carry c;
  c.o = {tape_f[(rf + 0) * R + r], tape_f[(rf + 1) * R + r],
         tape_f[(rf + 2) * R + r]};
  c.d = {tape_f[(rf + 3) * R + r], tape_f[(rf + 4) * R + r],
         tape_f[(rf + 5) * R + r]};
  for (int j = 0; j < 4; ++j) {
    c.L[j] = tape_f[(rf + 6 + j) * R + r];
    c.beta[j] = tape_f[(rf + 10 + j) * R + r];
    c.seed[j] = (uint32_t)tape_i[(ri + j) * R + r];
  }
  c.last_pdf = tape_f[(rf + 14) * R + r];
  c.eta_scale = tape_f[(rf + 15) * R + r];
  c.exclude = tape_i[(ri + 4) * R + r];
  c.specular = tape_i[(ri + 5) * R + r] != 0;
  c.in_trans = tape_i[(ri + 6) * R + r] != 0;
  return c;
}

// The kernels' mesh-part table from per part (tri_rows, chunk_bbox,
// node_bbox, node_meta) device pointers and (n_nodes, n_real_chunks), host
// arrays; null arrays give parts whose tables only the material lookup
// reads (the shade step's).
inline MeshParts make_parts(int n_parts, const long long* part_ptrs,
                            const int* part_info) {
  MeshParts mp = {};
  mp.n = n_parts;
  for (int i = 0; part_ptrs && i < n_parts; ++i) {
    mp.part[i].tri = (const float*)part_ptrs[4 * i + 0];
    mp.part[i].cbox = (const float*)part_ptrs[4 * i + 1];
    mp.part[i].nbox = (const float*)part_ptrs[4 * i + 2];
    mp.part[i].nmeta = (const int*)part_ptrs[4 * i + 3];
    mp.part[i].n_nodes = part_info[2 * i + 0];
    mp.part[i].n_real_chunks = part_info[2 * i + 1];
  }
  return mp;
}

}  // namespace pathtrace
