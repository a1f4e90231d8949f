// The forward megakernel's body (megakernel_fwd_kernel), shared by the
// forward's entry points (megakernel_fwd.cu, which describes its design)
// and the retrace backward (megakernel_bwd.cu), whose replay launches the
// taped="full" build, so that its tape is the taped forward's bit for bit.
// Each source that includes it compiles its own instantiations, with the
// same flags (kernels/_build.py).

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

}  // namespace
