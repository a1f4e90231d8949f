// The forward megakernel's bodies, shared by the forward's entry points
// (megakernel_fwd.cu, which describes their design, and the XYZ builds of
// megakernel_fwd_xyz.cu) and the retrace backward (megakernel_bwd.cu),
// whose replay launches the taped="full" build, so that its tape is the
// taped forward's bit for bit. Each source
// that includes it compiles its own instantiations, with the same flags
// (kernels/_build.py).
//
// Three schedules:
// - megakernel_fwd_kernel: one thread per ray, a grid that covers the
//   rays; a lane leaves the bounce loop when its ray dies, and its warp
//   runs on until its longest ray ends. The mesh parts' traversal (whose
//   chunk scans gather the lanes that reach them together), the counting
//   mesh build and the winner tape run it;
// - refill_fwd_kernel: persistent warps that refill dead lanes one by
//   one, for the untaped forward of scenes without mesh parts (plain
//   renders and triangle rows) and the taped="full" forward of triangle
//   rows; refill_fwd_wide, the same schedule on scene tables in device
//   memory, for the untaped forward of scenes of more than MAX_PRIMS rows;
//   and the XYZ builds of both (refill_trace with XYZ), for serving;
// - group_taped_kernel: persistent warps whose lanes take rays and retire
//   them in groups of GROUP, for the taped="full" forward of scenes
//   without mesh parts or triangle rows, so that every tape store of a
//   group writes whole 32-byte sectors, two of them side by side.

#pragma once

#include "bounce.cuh"

namespace {

using namespace pathtrace;

// What a launch tapes: nothing, every bounce's input carry (taped="full"),
// or every bounce's winners (taped=True).
enum { TAPE_NONE = 0, TAPE_FULL = 1, TAPE_WINNERS = 2 };

// The winner tape's row `depth` of ray r: tape_idx (max_depth+1, R) gets
// the closest-hit winner hit_w, tape_sh (max_depth+1, n_lights, R) the
// shadow winner sh_w for light li and -1 for every other light.
__device__ __forceinline__ void winners_write(int* __restrict__ tape_idx,
                                              int* __restrict__ tape_sh,
                                              long long R, long long r,
                                              int depth, int n_lights,
                                              int hit_w, int li, int sh_w) {
  tape_idx[(long long)depth * R + r] = hit_w;
  for (int l = 0; l < n_lights; ++l)
    tape_sh[((long long)depth * n_lights + l) * R + r] = l == li ? sh_w : -1;
}

template <int MESH, int TAPE>
__global__ void __launch_bounds__(THREADS)
    megakernel_fwd_kernel(const float* __restrict__ prims,
                          const int* __restrict__ meta, int P,
                          const int* __restrict__ lights, int n_lights,
                          const float* __restrict__ rays,
                          const int* __restrict__ seeds,
                          const float* __restrict__ spect, int S,
                          float* __restrict__ out, int* __restrict__ tape_i,
                          int* __restrict__ tape_sh, long long R,
                          int max_depth, int rr_start,
                          const __grid_constant__ MeshParts mp,
                          unsigned long long* __restrict__ work) {
  static_assert(TAPE != TAPE_FULL, "the full tape runs on the persistent "
                                   "schedules");
  __shared__ Scene s;
  load_scene(s, prims, meta, P, lights, n_lights, &mp);

  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (MESH == MESH_COUNT) work_clear();
  if (r < R) {
    const Trace tr = {P, n_lights, S, spect, R, max_depth, rr_start};
    Carry c = init_carry(rays, seeds, R, r);
    bool alive = true;
    for (int depth = 0; depth <= max_depth; ++depth) {
      if (TAPE == TAPE_WINNERS) {
        int hit_w = -1, li = -1, sh_w = -1;
        if (alive) {
          BounceRec rec;
          alive = bounce<true, MESH>(s, tr, r, depth, c, &rec);
          hit_w = rec.hit.idx;
          // a diffuse scatter ran the shadow scan for the light it picked
          if (rec.scatter && s.meta[rec.hit.slot * META + 2] == DIFFUSE) {
            li = rec.li;
            sh_w = rec.sh.idx;
          }
        }
        winners_write(tape_i, tape_sh, R, r, depth, n_lights, hit_w, li, sh_w);
      } else if (alive) {
        alive = bounce<false, MESH>(s, tr, r, depth, c, nullptr);
      } else if (TAPE == TAPE_NONE) {
        break;
      }
    }
    for (int j = 0; j < 4; ++j) out[j * R + r] = c.L[j];
  }
  if (MESH == MESH_COUNT) work_flush(work);
}

// The operands of the forward's XYZ builds (megakernel_fwd_xyz.cu): the
// rays as the ray setup writes them, o and d (3, R) f32 and the seeds
// (4, R) int64 holding u32 values; each ray's 12 hero-gathered CIE values
// cie (12, R) f32, the X bar at its 4 wavelengths, then Y's, then Z's; the
// frame's accumulator accum (3, R) f32; and the Riemann sum's scale, the
// f32 value torch multiplies by in ops/spectrum.py spectral_to_xyz_p.
struct XyzFrame {
  const float* o;
  const float* d;
  const long long* seeds;
  const float* cie;
  float* accum;
  float scale;
};

// The XYZ epilogue of ray r, whose radiance is L: each of X, Y and Z as
// spectral_to_xyz_p forms it, ((b0 L0 + b1 L1) + b2 L2) + b3 L3, times the
// scale, every operation rounded on its own (--fmad=false), then added to
// the ray's pixel of the accumulator. A ray is traced by one lane, so no
// other lane writes that pixel in the launch: no atomics. The loads and
// the store go through L2 alone (ld.global.cg, st.global.cg): each line is
// used once, and in L1 it would evict the scene records that the
// global-table build reads there.
__device__ __forceinline__ void xyz_add(const XyzFrame& xf, long long R,
                                        long long r, const float* L) {
  for (int k = 0; k < 3; ++k) {
    const float* b = xf.cie + (long long)(4 * k) * R + r;
    float v = __ldcg(b) * L[0] + __ldcg(b + R) * L[1];
    v = v + __ldcg(b + 2 * R) * L[2];
    v = v + __ldcg(b + 3 * R) * L[3];
    float* a = xf.accum + k * R + r;
    __stcg(a, __ldcg(a) + v * xf.scale);
  }
}

// A warp of the refill schedule takes new rays at the top of a trip once
// this many of its lanes are dead (or all of them, when fewer rays than
// that are left). Chosen by timing 1, 8 and 16 (PERF.md).
constexpr int REFILL_AT = 8;
constexpr unsigned ALL_LANES = 0xffffffffu;

// Counters of the refill schedule's counting build: lane trips (one per
// lane per trip that holds a live ray: every bounce call) and warp trips
// (32 per trip of a warp). Their ratio is the bounce loop's SIMT
// efficiency.
enum { TRIP_LANES = 0, TRIP_WARPS = 1, TRIP_KINDS = 2 };

// The forward of a scene without mesh parts on persistent warps: the grid
// holds only the blocks that stay resident (resident_grid), each loads the
// scene table once, and each lane keeps its own ray, depth and carry. At
// the top of each trip, a warp with REFILL_AT dead lanes (or all) takes
// that many ray ids from *next_ray with one atomicAdd, handed out by rank
// among its dead lanes; an id >= R leaves the lane dead, and the warp
// exits when all its lanes are dead and the counter is spent. A ray that
// dies writes its radiance and frees its lane. Which lane traces a ray, and
// when, varies from launch to launch; what it computes does not: bounce()
// reads only the ray's own inputs and its own depth (Russian roulette,
// the max_depth cut), so every ray's result is the one-thread schedule's
// bit for bit. With TAPE_FULL, a lane writes its ray's input carry before
// each bounce, and the rows after its death (final carry, active = 0) when
// it dies; a warp's lanes hold rays of scattered ids at mixed depths, so
// each 4-byte store fills part of a sector. That pays on triangle rows
// (MESH_ROWS), where a bounce scans 80 triangles twice; at Cornell depth 8
// (864 B of tape per ray) a refill build of the taped forward ran 3-4x
// slower than the one-thread schedule, and group_taped_kernel runs it.
// With COUNT, the warp's lane and warp trips are added to
// trips[TRIP_KINDS]. With XYZ, the rays and seeds are read from xf and a
// ray that dies adds its XYZ into xf.accum (xyz_add) instead of writing its
// radiance: rays, seeds and out are not read. The schedule runs on either
// table (refill_trace): refill_fwd_kernel on the shared one,
// refill_fwd_wide on the records in device memory of a scene of more than
// MAX_PRIMS rows.
template <int MESH, int TAPE, bool COUNT, bool XYZ, class SceneT>
__device__ __forceinline__ void refill_trace(
    const SceneT& s, int P, int n_lights, const float* __restrict__ rays,
    const int* __restrict__ seeds, const float* __restrict__ spect, int S,
    float* __restrict__ out, float* __restrict__ tape_f,
    int* __restrict__ tape_i, long long R, int max_depth, int rr_start,
    unsigned long long* __restrict__ next_ray,
    unsigned long long* __restrict__ trips, const XyzFrame& xf) {
  static_assert(!XYZ || TAPE == TAPE_NONE, "the XYZ builds tape nothing");
  const unsigned lane = threadIdx.x & 31u;
  const Trace tr = {P, n_lights, S, spect, R, max_depth, rr_start};
  long long r = -1;    // this lane's ray, -1 while the lane is dead
  int depth = 0;
  Carry c;
  bool spent = false;  // this warp saw the counter pass R
  unsigned lane_trips = 0, warp_trips = 0;
  for (;;) {
    const unsigned dead = __ballot_sync(ALL_LANES, r < 0);
    const int n_dead = __popc(dead);
    if (!spent && (n_dead >= REFILL_AT || dead == ALL_LANES)) {
      unsigned long long base = 0;
      if (lane == 0) base = atomicAdd(next_ray, (unsigned long long)n_dead);
      base = __shfl_sync(ALL_LANES, base, 0);
      spent = base + n_dead >= (unsigned long long)R;
      if (r < 0) {
        const unsigned long long id =
            base + __popc(dead & ((1u << lane) - 1u));
        if (id < (unsigned long long)R) {
          r = (long long)id;
          depth = 0;
          if constexpr (XYZ)
            c = init_carry(xf.o, xf.d, xf.seeds, R, r);
          else
            c = init_carry(rays, seeds, R, r);
        }
      }
    }
    // no live lane after a refill: the counter is spent
    if (__ballot_sync(ALL_LANES, r >= 0) == 0) break;
    if (COUNT) {
      lane_trips += r >= 0;
      warp_trips += 32;
    }
    if (r >= 0) {
      if (TAPE == TAPE_FULL) tape_write(tape_f, tape_i, R, r, depth, c, true);
      if (bounce<false, MESH>(s, tr, r, depth, c, nullptr)) {
        ++depth;
      } else {
        if (TAPE == TAPE_FULL)
          for (int k = depth + 1; k <= max_depth; ++k)
            tape_write(tape_f, tape_i, R, r, k, c, false);
        if constexpr (XYZ)
          xyz_add(xf, R, r, c.L);
        else
          for (int j = 0; j < 4; ++j) out[j * R + r] = c.L[j];
        r = -1;
      }
    }
  }
  if (COUNT) {
    const unsigned lanes = __reduce_add_sync(ALL_LANES, lane_trips);
    if (lane == 0) {
      atomicAdd(trips + TRIP_LANES, (unsigned long long)lanes);
      atomicAdd(trips + TRIP_WARPS, (unsigned long long)warp_trips);
    }
  }
}

// The refill schedule on the shared tables (load_scene).
template <int MESH, int TAPE, bool COUNT>
__global__ void __launch_bounds__(THREADS)
    refill_fwd_kernel(const float* __restrict__ prims,
                      const int* __restrict__ meta, int P,
                      const int* __restrict__ lights, int n_lights,
                      const float* __restrict__ rays,
                      const int* __restrict__ seeds,
                      const float* __restrict__ spect, int S,
                      float* __restrict__ out, float* __restrict__ tape_f,
                      int* __restrict__ tape_i, long long R, int max_depth,
                      int rr_start,
                      unsigned long long* __restrict__ next_ray,
                      unsigned long long* __restrict__ trips) {
  __shared__ Scene s;
  load_scene(s, prims, meta, P, lights, n_lights);
  refill_trace<MESH, TAPE, COUNT, false>(s, P, n_lights, rays, seeds, spect, S,
                                         out, tape_f, tape_i, R, max_depth,
                                         rr_start, next_ray, trips,
                                         XyzFrame{});
}

// The untaped refill forward of a scene of any number of rows, the
// records rec (REC_WORDS per slot, wide_tables_kernel's) and meta read
// from device memory (WideScene): plain rows, or triangle rows with
// MESH_ROWS. Its own name, so that a device trace shows it apart from
// refill_fwd_kernel.
template <int MESH>
__global__ void __launch_bounds__(THREADS)
    refill_fwd_wide(const float* __restrict__ rec,
                    const int* __restrict__ meta, int P,
                    const int* __restrict__ lights, int n_lights,
                    const float* __restrict__ rays,
                    const int* __restrict__ seeds,
                    const float* __restrict__ spect, int S,
                    float* __restrict__ out, long long R, int max_depth,
                    int rr_start, unsigned long long* __restrict__ next_ray) {
  __shared__ WideScene s;
  load_wide_scene(s, rec, meta, lights, n_lights);
  refill_trace<MESH, TAPE_NONE, false, false>(
      s, P, n_lights, rays, seeds, spect, S, out, nullptr, nullptr, R,
      max_depth, rr_start, next_ray, nullptr, XyzFrame{});
}

// Lanes of a group of group_taped_kernel: 16 consecutive 4-byte words of
// one tape row, 64 bytes, two whole 32-byte sectors. Chosen by timing 8
// and 16 at Cornell 1024^2, depth 8 (PERF.md): groups of 8 fill one sector
// a store and keep more lanes busy (SIMT efficiency 0.69 against 0.60),
// but ran 0.95-0.96 ms a launch against 0.86-0.87 for groups of 16 and
// 0.90 for one thread per ray, whose warp stores whole 128-byte lines.
constexpr int GROUP = 16;
static_assert(GROUP > 1 && GROUP < 32 && 32 % GROUP == 0,
              "a warp holds whole groups");

// The taped="full" forward of a scene without mesh parts or triangle rows
// on persistent warps whose lanes go in groups of GROUP. A group holds the
// GROUP consecutive ray ids g*GROUP .. g*GROUP+GROUP-1 and one depth, and
// advances in lockstep until all its rays have died. At the top of each
// trip, a warp counts its free groups (every lane retired, or never
// started) and takes GROUP ids for each from *next_ray with one atomicAdd,
// handed out by rank among them; the counter moves in multiples of GROUP,
// so a group's first id is GROUP-aligned. An id >= R leaves its lane idle:
// it writes nothing. In each trip every lane of a started group writes
// its tape row at the group's depth: a live lane its input carry (active
// = 1), a lane whose ray has died its final carry (active = 0), the row
// the one-thread schedule writes there. Then the live lanes run the bounce
// and the group's depth goes up by one. When a group's last ray dies, its
// lanes write the rows after that depth (final carry, active = 0) and
// their radiance, and the group is free. With R a multiple of GROUP and
// every tape row's base 64-byte aligned, each of a group's tape_f, tape_i
// and out stores is whole sectors: the layout stays row by row (bounce.cuh
// tape_write), as the sweep and the JAX tape read it. Which warp traces a
// group, and when, varies from launch to launch; what it writes does not:
// bounce() reads only the ray's own inputs and its own depth. With COUNT,
// the warp's lane trips (bounce calls) and warp trips (32 per trip) are
// added to trips[TRIP_KINDS].
template <bool COUNT>
__global__ void __launch_bounds__(THREADS)
    group_taped_kernel(const float* __restrict__ prims,
                       const int* __restrict__ meta, int P,
                       const int* __restrict__ lights, int n_lights,
                       const float* __restrict__ rays,
                       const int* __restrict__ seeds,
                       const float* __restrict__ spect, int S,
                       float* __restrict__ out, float* __restrict__ tape_f,
                       int* __restrict__ tape_i, long long R, int max_depth,
                       int rr_start,
                       unsigned long long* __restrict__ next_ray,
                       unsigned long long* __restrict__ trips) {
  constexpr unsigned GROUP_BITS = (1u << GROUP) - 1u;
  __shared__ Scene s;
  load_scene(s, prims, meta, P, lights, n_lights);

  const unsigned lane = threadIdx.x & 31u;
  const unsigned group = lane / GROUP;
  const unsigned group_lanes = GROUP_BITS << (group * GROUP);
  const Trace tr = {P, n_lights, S, spect, R, max_depth, rr_start};
  long long r = -1;    // this lane's ray; -1 while its group is free
  bool alive = false;  // this lane's ray has not died
  int depth = 0;       // its group's depth, the same in all its lanes
  Carry c;
  bool spent = false;  // this warp saw the counter pass R
  unsigned lane_trips = 0, warp_trips = 0;
  for (;;) {
    const unsigned held = __ballot_sync(ALL_LANES, r >= 0);
    unsigned free_groups = 0;  // bit g: group g holds no ray
    for (int g = 0; g < 32 / GROUP; ++g)
      if (((held >> (g * GROUP)) & GROUP_BITS) == 0) free_groups |= 1u << g;
    if (!spent && free_groups) {
      const unsigned long long n =
          (unsigned long long)GROUP * __popc(free_groups);
      unsigned long long base = 0;
      if (lane == 0) base = atomicAdd(next_ray, n);
      base = __shfl_sync(ALL_LANES, base, 0);
      spent = base + n >= (unsigned long long)R;
      if (free_groups >> group & 1u) {
        const unsigned long long id =
            base + GROUP * __popc(free_groups & ((1u << group) - 1u)) +
            lane % GROUP;
        if (id < (unsigned long long)R) {
          r = (long long)id;
          alive = true;
          depth = 0;
          c = init_carry(rays, seeds, R, r);
        }
      }
    }
    // no live lane after a refill: the counter is spent
    if (__ballot_sync(ALL_LANES, alive) == 0) break;
    if (COUNT) {
      lane_trips += alive;
      warp_trips += 32;
    }
    if (r >= 0) {
      tape_write(tape_f, tape_i, R, r, depth, c, alive);
      if (alive) alive = bounce<false, MESH_NONE>(s, tr, r, depth, c, nullptr);
      ++depth;
    }
    // a group whose last ray died writes its remaining rows and radiance
    const unsigned live = __ballot_sync(ALL_LANES, alive);
    if (r >= 0 && (live & group_lanes) == 0) {
      for (int k = depth; k <= max_depth; ++k)
        tape_write(tape_f, tape_i, R, r, k, c, false);
      for (int j = 0; j < 4; ++j) out[j * R + r] = c.L[j];
      r = -1;
    }
  }
  if (COUNT) {
    const unsigned lanes = __reduce_add_sync(ALL_LANES, lane_trips);
    if (lane == 0) {
      atomicAdd(trips + TRIP_LANES, (unsigned long long)lanes);
      atomicAdd(trips + TRIP_WARPS, (unsigned long long)warp_trips);
    }
  }
}

// The grid of a persistent kernel: as many blocks as stay resident (the SM
// count times the kernel's occupancy), or fewer when the rays fill fewer.
// The resident count is kept per device ordinal in the caller's table,
// taken at the first launch on each device: cards of one host may differ
// in SM count, and a grid sized for another card would leave SMs idle or
// queue blocks behind persistent ones.
constexpr int MAX_DEVICES = 64;
template <typename Kernel>
cudaError_t resident_grid(Kernel kernel, long long (&resident)[MAX_DEVICES],
                          long long R, unsigned* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          THREADS, 0);
    if (err != cudaSuccess) return err;
    resident[dev] = (long long)sms * per_sm;
  }
  const long long need = (R + THREADS - 1) / THREADS;
  *blocks = (unsigned)(need < resident[dev] ? need : resident[dev]);
  return cudaSuccess;
}

// Launch refill_fwd_kernel on its resident grid. *next_ray must be 0.
template <int MESH, int TAPE, bool COUNT>
cudaError_t refill_launch(const float* prims, const int* meta, int P,
                          const int* lights, int n_lights, const float* rays,
                          const int* seeds, const float* spect, int S,
                          float* out, float* tape_f, int* tape_i, long long R,
                          int max_depth, int rr_start,
                          unsigned long long* next_ray,
                          unsigned long long* trips, cudaStream_t st) {
  static long long resident[MAX_DEVICES] = {};
  unsigned blocks = 0;
  const cudaError_t err = resident_grid(refill_fwd_kernel<MESH, TAPE, COUNT>,
                                        resident, R, &blocks);
  if (err != cudaSuccess) return err;
  refill_fwd_kernel<MESH, TAPE, COUNT><<<blocks, THREADS, 0, st>>>(
      prims, meta, P, lights, n_lights, rays, seeds, spect, S, out, tape_f,
      tape_i, R, max_depth, rr_start, next_ray, trips);
  return cudaGetLastError();
}

// Launch group_taped_kernel on its resident grid. *next_ray must be 0.
template <bool COUNT>
cudaError_t group_launch(const float* prims, const int* meta, int P,
                         const int* lights, int n_lights, const float* rays,
                         const int* seeds, const float* spect, int S,
                         float* out, float* tape_f, int* tape_i, long long R,
                         int max_depth, int rr_start,
                         unsigned long long* next_ray,
                         unsigned long long* trips, cudaStream_t st) {
  static long long resident[MAX_DEVICES] = {};
  unsigned blocks = 0;
  const cudaError_t err =
      resident_grid(group_taped_kernel<COUNT>, resident, R, &blocks);
  if (err != cudaSuccess) return err;
  group_taped_kernel<COUNT><<<blocks, THREADS, 0, st>>>(
      prims, meta, P, lights, n_lights, rays, seeds, spect, S, out, tape_f,
      tape_i, R, max_depth, rr_start, next_ray, trips);
  return cudaGetLastError();
}

// Launch the taped="full" forward of a scene without mesh parts, with the
// ray counter *next_ray (one zeroed u64): the refill schedule on triangle
// rows (mesh_mode), the group schedule otherwise. The taped forward's
// entry point and the retrace backward's replay both launch it.
cudaError_t taped_launch(const float* prims, const int* meta, int P,
                         const int* lights, int n_lights, const float* rays,
                         const int* seeds, const float* spect, int S,
                         float* out, float* tape_f, int* tape_i, long long R,
                         int max_depth, int rr_start, int mesh_mode,
                         unsigned long long* next_ray, cudaStream_t st) {
  const auto launch = mesh_mode ? &refill_launch<MESH_ROWS, TAPE_FULL, false>
                                : &group_launch<false>;
  return launch(prims, meta, P, lights, n_lights, rays, seeds, spect, S, out,
                tape_f, tape_i, R, max_depth, rr_start, next_ray, nullptr,
                st);
}

}  // namespace
