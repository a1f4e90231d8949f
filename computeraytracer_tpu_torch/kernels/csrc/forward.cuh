// The forward megakernel's bodies, shared by the forward's entry points
// (megakernel_fwd.cu, which describes their design) and the retrace
// backward (megakernel_bwd.cu), whose replay launches the taped="full"
// build, so that its tape is the taped forward's bit for bit. Each source
// that includes it compiles its own instantiations, with the same flags
// (kernels/_build.py).
//
// Two schedules:
// - megakernel_fwd_kernel: one thread per ray, a grid that covers the
//   rays; a lane leaves the bounce loop when its ray dies, and its warp
//   runs on until its longest ray ends. The mesh parts' traversal (whose
//   chunk scans gather the lanes that reach them together), the counting
//   mesh build, the winner tape and the taped="full" forward of scenes
//   without triangle rows run it;
// - refill_fwd_kernel: persistent warps that refill dead lanes, for the
//   untaped forward of scenes without mesh parts (plain renders and
//   triangle rows) and the taped="full" forward of triangle rows.

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
                          float* __restrict__ out, float* __restrict__ tape_f,
                          int* __restrict__ tape_i, int* __restrict__ tape_sh,
                          long long R, int max_depth, int rr_start,
                          const __grid_constant__ MeshParts mp,
                          unsigned long long* __restrict__ work) {
  __shared__ Scene s;
  load_scene(s, prims, meta, P, lights, n_lights, &mp);

  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (MESH == MESH_COUNT) work_clear();
  if (r < R) {
    const Trace tr = {P, n_lights, S, spect, R, max_depth, rr_start};
    Carry c = init_carry(rays, seeds, R, r);
    bool alive = true;
    for (int depth = 0; depth <= max_depth; ++depth) {
      if (TAPE == TAPE_FULL) tape_write(tape_f, tape_i, R, r, depth, c, alive);
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
// holds only the blocks that stay resident (refill_launch), each loads the
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
// these stores (96 B per bounce row) do not coalesce. That pays on
// triangle rows (MESH_ROWS), where a bounce scans 80 triangles twice,
// and not at Cornell depth 8, whose taped build keeps the one-thread
// schedule (a refill build of it ran 3-4x slower; PERF.md). With
// COUNT, the warp's lane and warp trips are added to trips[TRIP_KINDS].
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

// Launch refill_fwd_kernel on as many blocks as stay resident (the SM
// count times the kernel's occupancy), or fewer when the rays fill fewer.
// *next_ray must be 0. The resident count is kept per device ordinal, taken
// at the first launch on each device: cards of one host may differ in SM
// count, and a grid sized for another card would leave SMs idle or queue
// blocks behind persistent ones.
constexpr int MAX_DEVICES = 64;
template <int MESH, int TAPE, bool COUNT>
cudaError_t refill_launch(const float* prims, const int* meta, int P,
                          const int* lights, int n_lights, const float* rays,
                          const int* seeds, const float* spect, int S,
                          float* out, float* tape_f, int* tape_i, long long R,
                          int max_depth, int rr_start,
                          unsigned long long* next_ray,
                          unsigned long long* trips, cudaStream_t st) {
  static long long resident[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, refill_fwd_kernel<MESH, TAPE, COUNT>, THREADS, 0);
    if (err != cudaSuccess) return err;
    resident[dev] = (long long)sms * per_sm;
  }
  const long long need = (R + THREADS - 1) / THREADS;
  const unsigned blocks =
      (unsigned)(need < resident[dev] ? need : resident[dev]);
  refill_fwd_kernel<MESH, TAPE, COUNT><<<blocks, THREADS, 0, st>>>(
      prims, meta, P, lights, n_lights, rays, seeds, spect, S, out, tape_f,
      tape_i, R, max_depth, rr_start, next_ray, trips);
  return cudaGetLastError();
}

// Launch the taped="full" forward of a scene without mesh parts: the
// refill schedule on triangle rows (mesh_mode; *next_ray zeroed), the
// one-thread schedule otherwise. The taped forward's entry point and the
// retrace backward's replay both launch it.
cudaError_t taped_launch(const float* prims, const int* meta, int P,
                         const int* lights, int n_lights, const float* rays,
                         const int* seeds, const float* spect, int S,
                         float* out, float* tape_f, int* tape_i, long long R,
                         int max_depth, int rr_start, int mesh_mode,
                         unsigned long long* next_ray, cudaStream_t st) {
  if (mesh_mode)
    return refill_launch<MESH_ROWS, TAPE_FULL, false>(
        prims, meta, P, lights, n_lights, rays, seeds, spect, S, out, tape_f,
        tape_i, R, max_depth, rr_start, next_ray, nullptr, st);
  const MeshParts mp = {};
  const unsigned blocks = (unsigned)((R + THREADS - 1) / THREADS);
  megakernel_fwd_kernel<MESH_NONE, TAPE_FULL><<<blocks, THREADS, 0, st>>>(
      prims, meta, P, lights, n_lights, rays, seeds, spect, S, out, tape_f,
      tape_i, nullptr, R, max_depth, rr_start, mp, nullptr);
  return cudaGetLastError();
}

}  // namespace
