#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (computeraytracer_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
1. device: the card's name, and its name and power limit from nvidia-smi.
2. build: nvcc compiles every kernel source (each kernel's name,
   registers and spills shown).
3. kernel vs plain: the CUDA forward megakernel and its plain torch
   version on the same CUDA tensors, Cornell box 1024^2, depth 8, sample
   1: all finite, bit-equal on every ray (at least 99.9% of rays within
   rel 1e-4, denominator floored at 1e-2, is the tolerance of the other
   kernels), and a second launch bit-equal to the first (the refill
   schedule hands rays to lanes in an order that varies).
4. served path: tracer.api.render at 1024^2, spp 4, depth 8 with the
   launch counters reset just before; exactly 4 forward launches, all of
   them the XYZ build (phase 33), 4 ray-setup and 4 hero-gather launches
   (spectra and CIE in one), one finish (phase 34), no ray-setup backward, a finite non-zero image whose mean XYZ is within
   1e-3 relative of the same render through the plain versions; the PNG
   is written to a temp dir.
5. timing: forward kernel and plain version at the phase-3 shape (CUDA
   events, after a warm-up). The bounce loop's schedule: the one-thread
   schedule's SIMT efficiency from the taped forward's tape (lane trips
   over warp trips, a warp of 32 consecutive rays running as many trips
   as its longest ray), and the refill schedule's lane and warp trips
   from its counting build (radiance bit-equal; its lane trips equal to
   the tape's exactly); the taped forward's group schedule (lanes in
   groups of mk.GROUP that take and retire rays together) from its
   counting build (radiance and tape bit-equal to an uncounted launch,
   lane trips equal to the tape's), its SIMT efficiency beside the
   model's, schedule_efficiency(trips, GROUP) from the tape; the
   registers and spills of every forward build.
6. backward kernel vs plain: the CUDA backward megakernel and
   backward_reference (in bands of at most 131072 rays) at the phase-3
   shape, for a radiance cotangent dL from a fixed seed: d_prims within
   1e-3 of its largest entry; d_rays and d_spect with at least 99.9% of
   rays within rel 1e-3 (denominator floored at 1e-3 of the plane's
   largest magnitude); all finite. Then a scene of 10 spectra (Cornell
   with four added, two of them read): both backward kernels on a band of
   131072 rays against backward_reference with the same tolerances, and
   bit-equal to each other on one tape.
7. training path: value_and_grad of mean((accum / 4) ** 2) at 1024^2,
   spp 4, depth 8 with respect to spectra and primitives.data1, with both
   launch counters reset just before: exactly 4 forward and 4 backward
   launches, no ray-setup backward, finite gradients, non-zero in every
   spectra row the render
   reads. Then train.optimize (kernel="pallas") for 3 Adam steps (lr
   0.05) from the Cornell scene with spectra row 2 dimmed x0.3 against
   the undimmed target, training that row (spectra_rows: with every row
   free, Adam's first step moves every entry of every row by about lr,
   against albedos of 0.04-0.74, and raised the loss at this size):
   finite losses, the last below the first.
8. timing: the backward kernel per sample and the plain backward on one
   band (CUDA events, after a warm-up); the fwd+bwd step on the host
   clock, split into its forward pass, backward pass and Adam step. The
   retrace kernel's sections from its sweep's timed build (each section's
   share of the clock64() cycles summed over warps, mk.SWEEP_SECTIONS, and
   the timed build's ms; its replay is the taped forward's launch, timed
   in phase 10) and the registers and spills of its builds.
9. tape-fed backward at the phase-3 shape: the taped forward kernel (the
   group schedule) with radiance bit-equal to phase 3's forward kernel
   and a second launch bit-equal to the first; its tape against
   forward_taped_reference (int planes equal, float planes within rel 1e-4
   of a denominator floored at 1e-2 of the plane's scale, on at least
   99.9% of rays; the bit-equal share printed); the tape-fed kernel on
   that tape bit-equal to phase 6's retrace kernel (d_prims, d_rays,
   d_spect) and within phase 6's tolerances of phase 6's plain result.
   The tape-fed kernel's sections from its timed build, and its builds'
   registers and spills.
10. the pallas_taped training path: phase 7's value_and_grad with
   backward="pallas_taped", every counter reset just before: exactly 4
   taped forwards, 4 tape-fed backwards, 0 retrace backwards and 0
   untaped forwards; gradients within 1e-5 of the largest entry of phase
   7's (bit-equality printed). Times: the taped forward and the tape-fed
   kernel (CUDA events), the step on the host clock (3 runs) and split
   into its forward pass, backward pass and Adam step, the peak device
   memory of one step, taped and retrace, and a torch.profiler pass over
   one step of each (device time, idle share, host-issued ops, kernel
   launches, top kernels, the taped forward's kernel, which is the
   retrace step's replay; indexing_backward_kernel, the scatter of an
   indexing backward, must not be among the top five). The setup's
   launches in the taped step: 4 ray setups, 4 gathers, 4 column sums, no
   ray-setup backward.
11. meshes: mesh_scene(1024, 1024, subdivisions=6), 81,920 triangles in
   one mesh part, depth 3. The mesh-mode forward kernel against its plain
   version on a band of 16,384 rays across the blob: at least 99.9% of
   rays within rel 1e-4, all finite. tracer.api.render at 1024^2, spp 4,
   counters reset: exactly 4 mesh-mode launches and no other, a finite
   non-zero image. mesh_scene(256, 256, subdivisions=4): mean XYZ within
   1e-3 relative of the plain render. Times: the mesh kernel per sample
   (CUDA events), the render's Mpaths/s, and a torch.profiler pass over
   the render. Then the mesh kernel's counting build on the full film:
   radiance bit-equal to the mesh kernel's, and its casts, box tests,
   triangle plane tests and the inside tests its chunk scans need, which
   the mesh kernel's bound counts, with the inside tests its lanes made,
   its chunk scans and the lanes that ran them (the lanes of a warp scan
   each entered chunk together). Then tie_mesh_scene(256, 256), a grid of
   exact ties in each layout (duplicates in one chunk or across two,
   shared edges): the mesh kernel and the winner-taped forward against
   their plain versions on all 65,536 rays (winner tapes equal, at least
   99.9% of rays within rel 1e-4, the bit-equal share printed), and the
   walk on 4,096 tie_mesh_rays against walk_reference, bit for bit.
12. triangle rows: mesh_scene(1024, 1024, subdivisions=1), 80 triangle
   rows and 6 patches, no mesh part, depth 3. The forward, the retrace
   backward, the taped forward and the tape-fed backward, whose builds
   scan the triangle rows in the mesh mode: the taped forward's radiance
   bit-equal to the forward's and the two backward kernels bit-equal on
   one tape (full film); phase 5's schedule numbers; each backward against its plain version on a
   band of 16,384 rays across the blob with phase 6's tolerances. Then
   value_and_grad of mean(img ** 2) (spp 1) through backward="pallas"
   and "pallas_taped", counters reset before each: one mesh-mode forward
   and one retrace, or one taped forward and one tape-fed backward;
   finite gradients, non-zero on the triangle rows, the two within 1e-5
   of the largest entry. Times: the four kernels (CUDA events).
13. the winner-taped forward (build_forward(taped=True)) at phase 11's
   workload: radiance bit-equal to the mesh kernel's on all 1,048,576
   rays, tapes equal to forward_winners_reference's on phase 11's band;
   its time and the mesh kernel's in turns (mesh, winners, winners, mesh).
14. the slice's path: value_and_grad of mean(img ** 2) at 1024^2, depth
   3, spp 1, on phase 11's scene (one mesh part of 81,920 triangles)
   with respect to spectra and data1, every counter reset just before:
   exactly one winner-taped forward and no other launch; gradients
   finite, non-zero on the mesh rows (>= 6), bit-equal across two runs.
   The step's host wall, the guided replay's forward and backward times,
   the peak device memory of a step, and a torch.profiler pass.
15. finite differences (staged config 3's check): mesh_scene(32, 32, 2),
   320 triangles in a mesh part, depth 2, the gradient of sum(image) on
   its most influential mesh vertex coordinate against a central
   difference with eps 0.05, the image summed in float64 (at a sum of
   about 407 one float32 step is 2^-15, 4e-3 of the difference):
   relative error at most 2e-3.
16. the trainer: optimize on phase 11's scene at 1024^2, depth 3, spp 1,
   3 Adam steps (lr 0.05) training the blob's reflectance row, dimmed
   x0.3 against the undimmed target: finite losses, the last below the
   first.
17. the wavefront (wavefront=True) at phase 11's workload, depth 3,
   sample 1, its mesh casts binned (candidate and pair kernels, the walk
   for the rays they leave unresolved): render_sample_planar(
   backward="none") with the counters reset just before launches (depth
   + 1) shade steps and, per pipeline the casts logged
   (kernels.binned.cast_log), one candidate and one pair launch per mesh
   part and a walk where it finished unresolved rays, and nothing else;
   its image is the in-kernel path's bit for bit, its radiance the mesh
   kernel's on all 1,048,576 rays. Per cast: live rays, candidates per
   ray, live pairs, unresolved share, finish, batches; the host reads per
   sample. On phase 11's band every launch of the five kernels is held
   against its plain version (shade_step_reference, candidates_reference,
   pair_reference, pair_occluded_reference, walk_reference): integer
   outputs equal, at least 99.9% of rays' float planes within rel 1e-4
   (denominator floored at 1e-2 of the plane's scale; the bit-equal share
   printed). At the full film, one launch each of the candidate kernel
   (the one with the most active lanes, on every 8th ray) and the two pair
   scans (the ones with the most live pairs) is held against its plain
   version the same way. The counting builds (radiance bit-equal) give the
   kernels' slab, plane and inside tests, and the walk's chunk scans, the
   lanes that ran them and the inside tests they need; per candidate
   launch of the full film, its counting build's chunk-loop lane and warp
   trips must equal the trips its lanes' supernode masks give
   (binned.candidate_trips), printed with the SIMT efficiency of the
   warp-drained pass and of the one-thread pass it replaced. Times: every
   launch (CUDA events), the wavefront sample and the mesh kernel in turns (mesh,
   wavefront, wavefront, mesh), and a torch.profiler pass over the
   sample.
18. wavefront gradients: phase 14's value_and_grad with wavefront=True,
   every counter reset just before: the shade-step, candidate,
   closest-hit pair and walk launches its casts logged and no other (no
   any-hit cast: the taped wavefront's shadow casts are closest-hit
   casts); gradients bit-equal to phase 14's; the taped wavefront's
   radiance and tapes equal to the winner-taped kernel's (full film). The
   step's host wall and its peak device memory.
19. the binned casts at the full film: every cast of phase 17's sample,
   recorded, cast again through mesh_closest_hit_batched and against one
   walk over all its rays seeded as the wavefront seeded it before the
   binned casts (a live ray with its bound, a dead one with -inf): idx,
   t and normals bit-equal on every lane, a binned hit beyond the bound
   read as no hit (the fold and the occlusion test discard it); the
   any-hit cast's flag equal to the closest hit's (idx >= 0) & (t <=
   bound). Per cast its numbers and the two casts' times in turns
   (binned, walk, walk, binned). Then each finish of _walk_finish (none,
   each compaction tier, the full walk) forced with k = 1 on the cast
   that leaves the most rays unresolved, winners bit-equal to the walk's.
20. the eager tracer (tracer/xla.py, plain torch, no kernel of this
   script): tracer.api.render(kernel="xla") at phase 4's shape (Cornell
   1024^2, spp 4, depth 8), counters reset just before: no kernel
   launch; at least 99% of pixels within rtol = atol = 2e-4 of phase 4's
   kernel render and the mean XYZ within 1e-3 relative. Host seconds
   (first and second call), Mpaths/s, peak device memory, and a
   torch.profiler pass over one eager sample.
21. the gradient oracle: phase 7's value_and_grad (the same loss and
   samples) with backward="xla", whose backward recomputes each sample
   through the eager tracer under autograd: the loss equal to phase 7's,
   gradients finite, each tensor's relative L2 difference from phase 7's
   (backward="pallas") at most 2e-3, its worst element printed. The
   step's host seconds and peak device memory (a sample that does not
   fit would be retried in row bands, whose gradients add up; the band
   count is printed). Then train.optimize(kernel="xla") for phase 7's 3
   Adam steps: finite losses, the last below the first.
22. the BVH on phase 11's scene (81,920 triangles): the native builder's
   compile and build seconds and node count; intersect_bvh against
   intersect_brute on a row of 1,024 camera rays and their 1,024
   bounce rays (random directions, the hit primitive excluded), brute
   force in chunks of 256 rays: hit flags and winners equal, t within
   rtol 1e-5 / atol 1e-4. Then the eager BVH render of sample 1 at
   1024^2, depth 3, counters reset just before: no kernel launch, at
   least 99% of pixels within phase 20's tolerance of the mesh kernel's
   render of the same sample and the mean XYZ within 1e-3. Its seconds,
   the loop steps of each cast and peak device memory.
23. observability (utils/profiling.py, utils/debug.py):
   measure_mean_depth on Cornell 256^2, depth 8, within 1% of the mean
   trips of the taped forward kernel's tape on the same pixels; the
   CLI's render --profile DIR at 256^2, spp 1: one trace that names the
   served forward kernel (the XYZ build, refill_fwd_xyz) and holds the
   spans crt:render and crt:kernel:megakernel_fwd_xyz; debug.checked passes a clean 64^2 eager
   render and raises on a NaN in spectra.
24. the screen warp of the visibility gradients (ops/warp.py) around the
   kernels at the headline workload: value_and_grad of phase 7's loss
   with vis_grads=("screen",), backward "pallas" (kernels 1 and 3) and
   "pallas_taped" (the taped forward and kernel 4), counters reset just
   before each: exactly SPP launches of each of the two kernels, the
   image bit-equal to the kernel path's stratified=False render, the two
   backwards' gradients within 1e-3 of the largest entry, and the
   retrace gradients within relative L2 2e-3 of the eager tracer's
   screen warp on the same samples. The step's host ms in turns with
   phase 7's step, a profile of each, peak device memory.
25. the boundary terms at tests/test_visibility_grads.py's sizes
   (occluder_scene 32^2, depth 1; samples rendered in batches of whole
   films): the screen silhouette's AD on the kernel path (spp 512)
   within 25% of a central difference (spp 2048, eps 0.06) of the
   stratified=False render, interior AD (light domain only, eager, spp
   256) at most 10% of it; the shadow's light+hemi AD on the eager path
   (spp 512) between 0.40 and 1.10 of its difference, interior AD
   (screen warp only) at most 5%; 25 Adam steps (lr 0.05, spp 32) on the
   kernel path move the occluder from dx 0.22 to |dx| < 0.22/3. Then the
   light and hemisphere warps on the eager tracer at Cornell 1024^2,
   depth 3, one sample, in 4 row bands: the image bit-equal to the
   stratified=False render, gradients finite, seconds and peak memory.
26. a world of one on NCCL (a file store in a temporary directory):
   parallel.render_sharded.render_accumulate_sharded on mesh (1, 1) at
   phase 4's workload, bit-equal to phase 4's image, exactly SPP forward
   launches, each the XYZ build (no gradient is wanted); the host ms of
   each in turns.
27. two ranks on the one card, spawned with torch.multiprocessing, gloo
   over CUDA tensors (NCCL refuses two ranks on one device; this tests
   the path, not its speed); a child that fails fails the phase. Each
   rank builds the kernels, then renders Cornell 1024^2 (spp 4, depth 8)
   with meshes (2, 1) and (1, 2) through the XYZ build, bit-equal to
   phase 4's image and to the per-sample images summed as
   (s1+s2)+(s3+s4); the mesh scene (spp
   4, depth 3) with (2, 1), bit-equal to phase 11's; and the sharded
   value_and_grad of train.optimize.make_loss_fn(mesh=...) by spectra and
   data1 with backward "pallas" and "pallas_taped" on both layouts, (2,
   1) twice: loss within rel 1e-6 of the single-process loss, gradients
   within relative L2 1e-4 of the single-process ones and of the other
   layout's, bit-equal across the two runs. Per rank: launches, step
   ms, peak GB, every all-reduce's bytes and ms.
28. the scalar oracle (tracer/reference_cpu.py) at Cornell 16^2, depth
   5, sample 1, against the kernel path's render on the card: at least
   0.995 of pixels within rel 1e-3, divergent energy at most 1e-3.
29. the per-sample setup's kernels at phase 4's shape (Cornell 1024^2,
   1,048,576 rays): the ray-setup kernel, which computes the camera
   frame itself, bit-equal to its plain version (o, d, hero, seeds) at
   three cameras (Cornell's, SETUP_CAMERAS' tilted up and fov near pi/2)
   and samples 1 and 2^32 - 3; the hero gather of the spectra (24 rows)
   and CIE (12 rows) tables in one launch, each bit-equal to table[:,
   hero]; the column-sum kernel on phase 6's d_spect within relative L2
   1e-6 of a float64 column sum, bit-equal to its plain version and
   across two launches. Each timed (CUDA events; the ray setup alone and
   through its wrapper; each kernel's device time under torch.profiler,
   the mean of the launches it records) against its plain version, its
   library call
   (index_select of the concatenated table; index_put_ with accumulate,
   the gather's autograd backward; index_add_) and its bound, the column
   sums with their share of it.
30. camera gradients at phase 4's shape: the ray setup's backward kernel
   (csrc/setup.cu ray_setup_bwd) on phase 6's d_rays at phase 29's three
   cameras and samples 1 and 2^32 - 3: its twelve sums bit-equal to the
   plain version's (ray_setup_bwd_sums_reference of ray_setup_bwd_terms)
   and across two launches, within relative L2 1e-6 of a float64 sum; its
   camera gradients within 1e-5 of each leaf's largest entry of torch
   autograd of ray_setup_reference (the bit-equal share printed). Phase
   7's value_and_grad also by eye, lookat, up and fov, for "pallas" and
   "pallas_taped", counters reset just before: every count as in the same
   step without camera leaves, and exactly SPP ray-setup backward
   launches; the spectra and data1 gradients bit-equal to phase 7's and
   phase 10's; the camera gradients finite, eye's and fov's non-zero.
   Times: the kernel (CUDA events; device time under the profiler, each
   pass), its plain version, torch autograd of ray_setup_reference, and
   each step's device time with and without camera leaves in turns
   (without, with, with, without), beside the card's name and power
   limit. Phases 4, 7 and 10 launch the ray setup's backward 0 times.
31. the frame graph (tracer/kernel.py accumulate_frame): 20 served
   frames of phase 4's workload on a scene of their own, eagerly (the
   frame graphs set aside, as a key's first call runs) and replayed, in
   turns (eager, graph, graph, eager), each frame synchronised: host ms a
   frame (median, mean) of each turn, the graph counters (no capture, 40
   replays, 40 eager frames), SPP forwards (the XYZ build), ray setups and
   gathers and one finish a frame either way, and every graphed frame's accum, mean and sRGB
   bit-equal to the eager frame of its samples.
32. the forward's global-table build (csrc/megakernel_fwd.cu
   megakernel_fwd_wide) on the benchmark's rtnw-final (3,407 unrolled
   rows, past the shared tables) at 800^2, depth 40, sample 1: the
   kernel twice and forward_reference on every ray, bit-equal; 2
   launches_wide and no other forward; the kernel's time (CUDA events)
   and plain time; its bound from the live bounces and shadow scans of
   the plain bounce loop; render at spp 4 launching 4 of its XYZ build
   (phase 33), no other forward and one finish (phase 34).
33. the forward's XYZ builds (csrc/megakernel_fwd_xyz.cu, the served
   sample's trace: kernels/megakernel.py forward_xyz) on Cornell 1024^2,
   depth 8, and on rtnw-final 800^2, depth 40 (the global-table build),
   sample 1, every counter zeroed just before: twice into an accumulator
   that holds sample 2 already, each bit-equal to phase 3's (phase 32's)
   forward_reference followed by xyz_accumulate_reference on the same
   operands; 2 launches_xyz and 2 of the forward's own counter, nothing
   else. The build's time (CUDA events), its plain time (forward_reference
   plus the model), its bound from its own operands (o, d, int64 seeds,
   spectra, CIE values, the accumulator read and written) and phase 3's
   (phase 32's) scans, and its registers.
34. the finish kernel (csrc/setup.cu finish_frame, a rendered frame's
   mean and sRGB; kernels/setup.py finish_frame) on phase 4's Cornell
   1024^2 frame and phase 32's rtnw-final 800^2 frame, each sum planar
   (3, R) and interleaved (H, W, 3), at sample counts 3 and 4: accum,
   mean and sRGB bit-equal to finish_frame_reference on the card; 4
   launches, counted in launches_finish; the kernels line's launches are
   the finishes that phase 4's and phase 32's renders counted. Its time
   (CUDA events) in turns with the tail of a replayed frame it replaced
   (the graph's permute copy, its clone, the division by a Python number
   and ops/color.py xyz_to_srgb in torch; kernel, tail, tail, kernel), its device time under torch.profiler, its plain
   time, its bound (the sum read once, accum, mean and sRGB written once)
   and its registers.
35. the forward's global-table mesh build (csrc/megakernel_fwd_wide_mesh.cu
   refill_fwd_wide_mesh) on the benchmark's rtnw-final-mesh (1,007
   unrolled rows and one mesh part of 4,800 triangles) at 800^2, depth 40,
   sample 1: on every 10th pixel the kernel twice and forward_reference,
   bit-equal, 2 launches_wide_mesh and no other forward; on the whole film
   its time (CUDA events) in turns with phase 32's refill_fwd_wide on
   rtnw-final, its bound from the plain loop's live bounces and shadow
   scans, its registers, its device time under the profiler and its
   crt:kernel: span; render at spp 4 launching 4 of it, no other forward and one
   finish.
Then one JSON line of kernels, each with its bound (the larger of the
bytes it must move over 3.35 TB/s and a lower count of its float
operations over 67 TFLOP/s, and of the ray setup's and its backward's
u32 operations over 16.7 TOP/s, all at 700 W). The launches of the
radiance and XYZ builds are told apart: each entry counts its own build's
launches in phase 4's (phase 32's) render. For the four kernels
of phase 24, its launches there ("launches_vis_grads"); the kernels of
phase 27 carry their launches on each rank there ("launches_sharded");
the setup's kernels their launches in phase 4's render and phase 10's
step, and the ray setup's backward its launches in phase 30's step.
The last line is {"ok": true, "device": {...}}. It needs no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from computeraytracer_tpu_torch import cli
from computeraytracer_tpu_torch import config as C
from computeraytracer_tpu_torch import native
from computeraytracer_tpu_torch.bvh import builder as bvh_builder
from computeraytracer_tpu_torch.bvh import traverse as bvh_traverse
from computeraytracer_tpu_torch.config import RenderConfig
from computeraytracer_tpu_torch.kernels import _build
from computeraytracer_tpu_torch.kernels import binned as bn
from computeraytracer_tpu_torch.kernels import megakernel as mk
from computeraytracer_tpu_torch.kernels import meshpack
from computeraytracer_tpu_torch.kernels import setup as setup_k
from computeraytracer_tpu_torch.ops import camera as cam_ops
from computeraytracer_tpu_torch.ops import color
from computeraytracer_tpu_torch.ops import intersect as isect
from computeraytracer_tpu_torch.ops import spectrum as spec
from computeraytracer_tpu_torch.ops import warp
from computeraytracer_tpu_torch.parallel import distributed
from computeraytracer_tpu_torch.parallel import mesh as mesh_mod
from computeraytracer_tpu_torch.parallel import render_sharded as rsh
from computeraytracer_tpu_torch.scene import presets, scene_from_dict
from computeraytracer_tpu_torch.tracer import kernel as kt
from computeraytracer_tpu_torch.tracer import reference_cpu as oracle
from computeraytracer_tpu_torch.tracer import replay
from computeraytracer_tpu_torch.tracer import xla as xla_tracer
from computeraytracer_tpu_torch.tracer.api import render
from computeraytracer_tpu_torch.train import optimize as opt
from computeraytracer_tpu_torch.utils import debug, profiling
from computeraytracer_tpu_torch.utils.image import read_png, write_png

WIDTH = HEIGHT = 1024
MAX_DEPTH = 8
RR_START = 1
SPP = 4
BAND = 131072  # rays per band of the plain backward
TRAIN_STEPS = 3
PERTURB_ROW = 2
MESH_SUBDIVISIONS = 6  # 81,920 triangles
MESH_DEPTH = 3
MESH_BAND_ROWS = 16    # 16 x 1024 = 16,384 rays for the plain mesh scan
SMALL_MESH = (256, 4)  # film side, subdivisions of the mean-XYZ check
TRI_SUBDIVISIONS = 1   # 80 triangles, unrolled rows (below mesh_min)
FD_SCENE = (32, 2)     # film side, subdivisions of the finite-difference check
FD_DEPTH = 2
FD_EPS = 0.05
ORACLE_BANDS = (1, 4, 16)  # row bands tried for the oracle's backward
ORACLE_L2 = 2e-3       # relative L2 limit, backward="xla" vs "pallas"
BRUTE_CHUNK = 256      # rays per brute-force chunk over 81,920 triangles
PROFILE_SIDE = 256     # film side of phase 23's mean depth and --profile
CHECKED_SIDE = 64      # film side of phase 23's debug.checked render
VIS_SCREEN = ("screen",)
# Phase 25: tests/test_visibility_grads.py's sizes (occluder_scene 32^2,
# depth 1, FD at spp 2048 and eps 0.06, AD at spp 512, interior AD at spp
# 256; recovery: steps, lr, spp, initial dx); samples per batched call.
OCC_SIDE = 32
OCC_ROW = 3
OCC_EPS = 0.06
OCC_FD_SPP = 2048
OCC_AD_SPP = 512
OCC_INTERIOR_SPP = 256
OCC_RECOVERY = (25, 5e-2, 32, 0.22)
OCC_CHUNK = 256
LIGHT_HEMI_DEPTH = 3
LIGHT_HEMI_BANDS = 4
# Phase 27: two ranks share the card; the (dp, sp) layouts they run, the
# leaves of their value_and_grad and its limit (relative L2 against the
# single-process gradients: the tiles change the order of the sums).
SHARD_WORLD = 2
SHARD_LAYOUTS = ((2, 1), (1, 2))
SHARD_TRAINABLE = ("spectra", "data1")
SHARD_GRAD_L2 = 1e-4
ORACLE_SCENE = (16, 5, 1)  # phase 28: Cornell side, depth, sample
# Phase 32: the benchmark's configuration past the shared tables, at its
# film and depth.
WIDE_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "bench_h100", "configs", "rtnw-final.json")
WIDE_SIDE, WIDE_DEPTH = 800, 40
WIDE_MESH_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "bench_h100", "configs",
                                "rtnw-final-mesh.json")
WIDE_MESH_STRIDE = 10  # every 10th pixel of phase 35's plain comparison

# The bound of a kernel: the larger of its bytes (each input read once,
# each output written once) over the H100's memory rate and its float
# operations over its f32 rate outside the tensor cores (NVIDIA data
# sheet, SXM, 700 W). The operations are a lower count: the closest-hit
# scans only, none of the shading. On Cornell, one scan per live bounce
# and a shadow scan per bounce that left a diffuse surface alive (the
# taped forward's active and specular planes tell them apart), each about
# 35 operations per patch or sphere. On the mesh scene, the counting
# build's casts, each 35 per unrolled row, and its tests: 24 per box
# (three slabs), 14 per triangle plane test and 32 more per inside test.
# The mesh kernel and the walk count the inside tests that any order of
# their chunk scans needs (the triangles whose plane t the chunk's final
# best does not beat), not those that their lanes' culling makes; the pair
# scans count their own. The walk counts only the tests, the shade step
# only its scans of the unrolled rows (the main scan of the first bounce,
# the shadow scans and the scans of the output rays). Where the work
# depends on the data, the bytes count what this run's data needs: the
# tape-fed kernel reads only its rays' live tape rows and the active words
# up to the first dead row; the candidate kernel every lane's bound and the
# other 6 ray words of its active lanes; a pair scan every pair's chunk id,
# the ray words (6 closest, 7 any-hit) and exclude word of its live pairs
# and the triangle rows of each chunk that a live pair reads; every kernel
# writes all its outputs.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# u32 operations outside the tensor cores: 64 a clock on each of the 132
# SMs at the 1.98 GHz boost clock (Hopper white paper; the guide's table
# gives no integer rate outside the tensor cores). The ray setup's count
# per ray: 16 TEA rounds of 17, three pcg4d advances of 32, the seed
# words' two products and the three draws' mask and conversion.
INT32_OPS_PER_S = 64 * 132 * 1.98e9
SETUP_INT_OPS = 16 * 17 + 3 * 32 + 2 + 3 * 2
# its float operations per ray: the jitter (4), s and t (5), the
# direction (12), its norm (6) and the normalization (3), the hero (1)
SETUP_F32_OPS = 31
# the ray setup's backward per ray: the seeds without the hero draw (16
# TEA rounds of 17, two pcg4d advances of 32, the seed words' two products,
# two draws' mask and conversion); its float operations: the jitter (4), s
# and t (5), the direction (15), its norm (6), d (3), d . g_d (5), g_u (9),
# s g_u and t g_u (6), and one add a ray for each of the twelve sums
SETUP_BWD_INT_OPS = 16 * 17 + 2 * 32 + 2 + 2 * 2
SETUP_BWD_F32_OPS = 4 + 5 + 15 + 6 + 3 + 5 + 9 + 6 + 12
CAMERA_LEAVES = ("eye", "lookat", "up", "fov")
# phase 10's step with the setup built each sample (PERF.md §5, on an
# NVIDIA H100 80GB HBM3 at 700 W), printed beside its profile
PER_SAMPLE_SETUP_STEP = {
    "pallas": "788 host-issued ops, 540 launches, idle 0.34-0.39",
    "pallas_taped": "768 host-issued ops, 516 launches, idle 0.36-0.37"}
# phase 29's cameras besides Cornell's (eye, lookat, up, fov): a tilted up,
# a fov near pi/2
SETUP_CAMERAS = {
    "tilted": ((1.3, 2.1, -3.7), (0.2, 0.9, 0.4), (0.3, 1.0, 0.2), 0.9),
    "wide": ((0.0, 0.5, 5.0), (0.1, -0.2, 0.0), (0.0, 1.0, 0.0), 1.5707),
}
# the taped forward's kernel (the group schedule), as the profiler names it
TAPED_KERNEL = "group_taped_kernel"
PRIM_TEST_OPS = 35
BOX_TEST_OPS = 24
TRI_PLANE_OPS = 14
TRI_INSIDE_OPS = 32


def _events_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _plain_render_accum(scene, static, spp, width=None, height=None,
                        max_depth=None, mesh_arrays=()):
    """The served render's accumulation through the plain versions of
    the setup's kernels and the trace (forward_reference), at the main
    path's film and depth unless given."""
    width, height = width or WIDTH, height or HEIGHT
    max_depth = MAX_DEPTH if max_depth is None else max_depth
    px, py = kt.tile_coords(width, height, 0, scene.device)
    accum = torch.zeros((3, width * height), device=scene.device)
    for s in range(1, spp + 1):
        o, d, hero, seed = setup_k.ray_setup_reference(
            scene.camera, width, height, px, py, s)
        radiance = mk.forward_reference(
            static, max_depth, RR_START, mk.pack_prims(scene, static),
            torch.cat([o, d]), seed,
            setup_k.hero_gather_reference(
                spec.expand_hero_table(scene.spectra), hero),
            *mesh_arrays)
        cie_p = setup_k.hero_gather_reference(spec.cie_window_exp(scene.cie),
                                              hero)
        accum = accum + spec.spectral_to_xyz_p(cie_p, radiance)
    return accum.T.reshape(height, width, 3)


def _ptxas(src):
    """The entry-function, register and spill lines that -Xptxas -v
    printed for csrc/<src>.cu."""
    return [line.strip() for line in _build.build_log.get(src, "").splitlines()
            if any(k in line for k in ("entry function", "registers",
                                       "spill"))]


def _sections(run, reps=3):
    """run(times) on a backward kernel's timed build: each section's share
    of the clock64() cycles summed over warps (mk.SWEEP_SECTIONS), the
    cycles, and the timed build's ms (CUDA events)."""
    times = torch.zeros(len(mk.SWEEP_SECTIONS), dtype=torch.int64,
                        device="cuda")
    run(times)
    cycles = times.tolist()
    total = max(sum(cycles), 1)
    scratch = torch.zeros_like(times)
    return {"share": {k: c / total for k, c in zip(mk.SWEEP_SECTIONS,
                                                    cycles)},
            "cycles": cycles,
            "timed_ms": _events_ms(lambda: run(scratch), reps)}


def _frac_within(got, want):
    """Share of rays whose radiance is within rel 1e-4 of the plain one
    (denominator floored at 1e-2)."""
    rel = (got - want).abs() / want.abs().clamp(min=1e-2)
    return (rel < 1e-4).all(dim=0).float().mean().item()


def _schedule(static, max_depth, args, radiance):
    """The bounce loop's schedule at kernel operands args: the one-thread
    schedule's SIMT efficiency from the taped forward's tape, and the
    refill schedule's lane and warp trips from its counting build, whose
    radiance must be `radiance` and whose lane trips must be the tape's.
    Without triangle rows, also the taped forward's group schedule
    (``taped``): its counting build's lane and warp trips, whose radiance
    and tape must be an uncounted launch's and whose lane trips must be
    the tape's, beside the model's efficiency for groups of mk.GROUP."""
    taped = mk.forward_taped(static, max_depth, RR_START, *args)
    tape_trips = mk.trips_from_tape(taped[2])
    trips = torch.zeros(len(mk.TRIP_COUNTS), dtype=torch.int64,
                        device=radiance.device)
    counted = mk.forward(static, max_depth, RR_START, *args, trips=trips)
    if not torch.equal(counted, radiance):
        raise RuntimeError("the refill schedule's counting build changed "
                           "its radiance")
    lane_trips, warp_trips = trips.tolist()
    out = {"mean_trips": tape_trips.double().mean().item(),
           "simt_efficiency_one_thread": mk.schedule_efficiency(tape_trips),
           "lane_trips": lane_trips, "warp_trips": warp_trips,
           "simt_efficiency": lane_trips / warp_trips}
    hist = torch.bincount(tape_trips, minlength=max_depth + 2).tolist()
    print(f"bounce loop schedule: {out['mean_trips']:.5f} trips per ray "
          f"(rays per trip count 0..{max_depth + 1}: {hist}); one-thread "
          f"schedule SIMT efficiency {out['simt_efficiency_one_thread']:.4f}"
          f" (from the tape); refill schedule {lane_trips} lane trips, "
          f"{warp_trips} warp trips, SIMT efficiency "
          f"{out['simt_efficiency']:.4f} (counting build, radiance "
          f"bit-equal)")
    if lane_trips != int(tape_trips.sum()):
        raise RuntimeError(f"counted lane trips {lane_trips} are not the "
                           f"tape's {int(tape_trips.sum())}")
    if static.mesh_mode or not hasattr(mk, "GROUP"):
        return out
    trips.zero_()
    counted = mk.forward_taped(static, max_depth, RR_START, *args,
                               trips=trips)
    if not all(torch.equal(a, b) for a, b in zip(counted, taped)):
        raise RuntimeError("the group schedule's counting build changed "
                           "its radiance or tape")
    lane_trips, warp_trips = trips.tolist()
    out["taped"] = {
        "group": mk.GROUP, "lane_trips": lane_trips,
        "warp_trips": warp_trips,
        "simt_efficiency": lane_trips / warp_trips,
        "simt_efficiency_model": mk.schedule_efficiency(tape_trips,
                                                        mk.GROUP)}
    print(f"taped forward, group schedule (groups of {mk.GROUP}): "
          f"{lane_trips} lane trips, {warp_trips} warp trips, SIMT "
          f"efficiency {out['taped']['simt_efficiency']:.4f} (counting "
          f"build, radiance and tape bit-equal) against the model's "
          f"{out['taped']['simt_efficiency_model']:.4f} for groups of "
          f"{mk.GROUP} from the tape")
    if lane_trips != int(tape_trips.sum()):
        raise RuntimeError(f"the group schedule counted {lane_trips} lane "
                           f"trips, the tape {int(tape_trips.sum())}")
    return out


def _wide_cornell(width, height):
    """Cornell with four spectra added, two of them read by walls: S = 10,
    each ray's d_spect column 40 rows."""
    doc = presets.cornell_box(width, height)
    doc["spectra"].update({
        f"pad{i}": {"wavelength": [400, 550, 700],
                    "value": [0.2 + 0.1 * i, 0.5, 0.6 - 0.1 * i]}
        for i in range(4)})
    doc["objects"]["patches"][0]["reflectance"] = "pad0"
    doc["objects"]["patches"][1]["reflectance"] = "pad1"
    return doc


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _bound(nbytes, ops, int_ops=0):
    """(bound_ms, bound_by) of a kernel that moves nbytes and does ops
    float and int_ops u32 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / F32_OPS_PER_S + int_ops / INT32_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _profile(fn, top=5, host_ops=False, named=()):
    """One run of fn() under torch.profiler: (wall ms, device ms, device
    idle share, kernel launches, the top kernels by device time), with
    host_ops the count of host-issued torch ops (aten ops not called
    from inside another aten op), and with named {key: device ms of the
    kernels whose names hold key}."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + e.time_range.elapsed_us() / 1e3)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out = (wall, dev_ms, 1.0 - dev_ms / wall, len(kernels),
           [(n[:48], round(t, 3)) for n, t in ranked])
    if host_ops:
        out += (sum(1 for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CPU
                    and e.name.startswith("aten::")
                    and not (e.cpu_parent is not None
                             and e.cpu_parent.name.startswith("aten::"))),)
    if named:
        out += ({key: sum(t for n, t in by_name.items() if key in n)
                 for key in named},)
    return out


def _reset_counters():
    mk.launches = mk.launches_mesh = mk.launches_taped = mk.launches_wide = 0
    mk.launches_xyz = mk.launches_wide_mesh = 0
    mk.launches_bwd = mk.launches_bwd_tape = mk.launches_winners = 0
    mk.launches_shade = bn.launches_walk = bn.launches_candidates = 0
    bn.launches_pair = bn.launches_pair_occl = 0
    setup_k.launches_ray_setup = setup_k.launches_gather = 0
    setup_k.launches_gather_bwd = setup_k.launches_ray_setup_bwd = 0
    setup_k.launches_finish = 0


def _setup_counters():
    """The per-sample setup's launch counts (kept out of _counters, whose
    trace-kernel counts the phases hold exactly)."""
    return {"ray_setup": setup_k.launches_ray_setup,
            "hero_gather_fwd": setup_k.launches_gather,
            "hero_gather_bwd": setup_k.launches_gather_bwd,
            "ray_setup_bwd": setup_k.launches_ray_setup_bwd,
            "finish": setup_k.launches_finish}


def _counters():
    return {"forward": mk.launches, "forward_wide": mk.launches_wide,
            "forward_xyz": mk.launches_xyz,
            "forward_wide_mesh": mk.launches_wide_mesh,
            "forward_mesh": mk.launches_mesh,
            "forward_taped": mk.launches_taped, "backward": mk.launches_bwd,
            "backward_tape": mk.launches_bwd_tape,
            "forward_winners": mk.launches_winners,
            "shade_step": mk.launches_shade, "walk": bn.launches_walk,
            "candidates": bn.launches_candidates, "pair": bn.launches_pair,
            "pair_occl": bn.launches_pair_occl}


def _only(**counts):
    """The counter dict with the given counts and every other count 0."""
    want = dict.fromkeys(_counters(), 0)
    want.update(counts)
    return want


def _backward_agreement(got, want):
    """Phase 6's comparison of backward cotangents with the plain ones:
    (ok, report, max_abs_err, bit-equal share of rays)."""
    names = ("d_prims", "d_rays", "d_spect")
    for nm, g, w in zip(names, got, want):
        if not (torch.isfinite(g).all() and torch.isfinite(w).all()):
            raise RuntimeError(f"non-finite {nm}")
    abs_err = max((g - w).abs().max().item() for g, w in zip(got, want))
    prims_err = ((got[0] - want[0]).abs().max()
                 / want[0].abs().max()).item()
    report = [f"d_prims worst err {prims_err:.3g} of its largest entry"]
    fracs = []
    for nm, g, w in zip(names[1:], got[1:], want[1:]):
        den = torch.maximum(w.abs(), 1e-3 * w.abs().max())
        rel = (g - w).abs() / den
        fracs.append((rel < 1e-3).all(dim=0).float().mean().item())
        report.append(f"{nm} {fracs[-1]:.6f} of rays within rel 1e-3, "
                      f"worst rel {rel.max().item():.3g}")
    equal = ((got[1] == want[1]).all(dim=0)
             & (got[2] == want[2]).all(dim=0)).float().mean().item()
    ok = prims_err <= 1e-3 and min(fracs) >= 0.999
    return ok, "; ".join(report), abs_err, equal


def _host_s(fn):
    """Host seconds of fn(), synchronised before and after; returns
    (seconds, fn's result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _train_leaves(scene):
    """(spectra, data1) as fresh leaves that require grad, and the scene
    that holds them."""
    sp = scene.spectra.detach().clone().requires_grad_(True)
    d1 = scene.primitives.data1.detach().clone().requires_grad_(True)
    return sp, d1, dataclasses.replace(
        scene, spectra=sp,
        primitives=dataclasses.replace(scene.primitives, data1=d1))


def _headline_loss(scene, static, backward="pallas"):
    """mean((accum / spp) ** 2) of the planar accumulation over samples
    1..SPP (bench.py's fwd+bwd workload), its setup operands built once
    as render_accumulate builds them."""
    setup = kt.setup_operands(scene, static, backward,
                              *kt.tile_coords(WIDTH, HEIGHT, 0, scene.device))
    accum = torch.zeros((3, HEIGHT, WIDTH), device=scene.device)
    for s in range(1, SPP + 1):
        accum = accum + kt.render_sample_planar(
            scene, WIDTH, HEIGHT, s, MAX_DEPTH, RR_START, static, backward,
            setup=setup)
    return torch.mean((accum / float(SPP)) ** 2)


def _vg(scene, static, backward="pallas"):
    """value_and_grad of the headline loss: the loss value; gradients
    land in the scene's leaves."""
    loss = _headline_loss(scene, static, backward)
    loss.backward()
    return loss.item()


def _rows_read(static):
    """Spectra rows the trace reads: diffuse reflectances, light
    emissions, and the extinction row when the scene has glass."""
    rows = set()
    for m, e, r in zip(static.materials, static.emission_idx,
                       static.reflectance_idx):
        if m == C.DIFFUSE:
            rows.add(r)
        elif m == C.LIGHT:
            rows.add(e)
        elif m == C.GLASS:
            rows.add(static.n_spectra - 1)
    return sorted(rows)


def _unrolled_bounds(args, tape_i, max_depth, row_ops):
    """Bounds of the unrolled-scene kernels on full-film operands args,
    from their taped="full" tape: (bound_ms, bound_by) of the forward,
    the taped forward, the retrace and the tape-fed backward, and the
    counts behind them. row_ops: the operations of one scan over every
    unrolled row. One scan per live bounce and one shadow scan per live
    row after a diffuse scatter (the tape's active and specular planes
    tell them apart); the tape-fed kernel reads its rays' live rows and
    the active words up to the first dead row (the live rows lead: a dead
    ray stays dead)."""
    prims, rays, seeds, spect = args
    R = rays.shape[1]
    D = int(max_depth) + 1
    ti3 = tape_i.reshape(D, mk.TAPE_I, R)
    live = int(ti3[:, 7].sum())
    diffuse_on = int(((ti3[1:, 7] != 0) & (ti3[1:, 5] == 0)).sum())
    scanned = int(torch.clamp(ti3[:, 7].sum(dim=0) + 1, max=D).sum())
    in_fwd = _nbytes(prims, rays, spect) + seeds.numel() * 4  # int32 seeds
    out_fwd = 4 * R * 4
    grads = _nbytes(prims, rays, spect) + 4 * R * 4  # + dL
    tape_bytes = D * (mk.TAPE_F + mk.TAPE_I) * R * 4
    tape_read = (live * (mk.TAPE_F + mk.TAPE_I - 1) + scanned) * 4
    scan_ops = (live + diffuse_on) * row_ops
    return {"forward": _bound(in_fwd + out_fwd, scan_ops),
            "taped": _bound(in_fwd + out_fwd + tape_bytes, scan_ops),
            "backward": _bound(in_fwd + grads, 2 * scan_ops),
            "tape_bwd": _bound(_nbytes(prims, spect) + tape_read + grads,
                               scan_ops),
            "tape_bytes": tape_bytes, "tape_read": tape_read, "live": live,
            "diffuse_on": diffuse_on}


def _band(args, y0):
    """Film rows y0 .. y0+MESH_BAND_ROWS of full-film kernel operands
    (prims unchanged), contiguous."""
    a, b = y0 * WIDTH, (y0 + MESH_BAND_ROWS) * WIDTH
    return (args[0],) + tuple(x[:, a:b].contiguous() for x in args[1:])


def _mesh_loss(scene, static, backward="pallas", mesh_plans=None,
               wavefront=None):
    """mean(img ** 2) of one planar sample of the film at the mesh depth
    (staged config 3's value_and_grad)."""
    img = kt.render_sample_planar(scene, WIDTH, HEIGHT, 1, MESH_DEPTH,
                                  RR_START, static, backward,
                                  mesh_plans=mesh_plans, wavefront=wavefront)
    return torch.mean(img ** 2)


def _mesh_vg(scene, static, backward="pallas", wavefront=None):
    """value_and_grad of _mesh_loss with respect to spectra and data1:
    (loss, d spectra, d data1)."""
    sp, d1, s = _train_leaves(scene)
    loss = _mesh_loss(s, static, backward, wavefront=wavefront)
    loss.backward()
    return loss.item(), sp.grad, d1.grad


def _triangle_rows(dev):
    """Phase 12: the builds of the forward, taped forward and both
    backward kernels that scan triangle rows. Returns the kernels-line
    numbers of the forward, the taped forward and the two backward
    kernels."""
    t0 = time.perf_counter()
    scene, _ = scene_from_dict(presets.mesh_scene(WIDTH, HEIGHT,
                                                  TRI_SUBDIVISIONS),
                               device=dev)
    static = mk.SceneStatic.from_scene(scene)
    tri_slots = [k for k, c in enumerate(static.categories) if c == 2]
    if static.mesh_parts or len(tri_slots) != 20 * 4 ** TRI_SUBDIVISIONS:
        raise RuntimeError(f"mesh_scene(subdivisions={TRI_SUBDIVISIONS}) "
                           f"made {len(tri_slots)} triangle rows and "
                           f"{len(static.mesh_parts)} mesh parts")
    px, py = kt.tile_coords(WIDTH, HEIGHT, 0, dev)
    args = kt.kernel_inputs(scene, *kt.camera_planes(
        scene, WIDTH, HEIGHT, px, py, 1), static)
    R = args[1].shape[1]
    dL = torch.randn((4, R), generator=torch.Generator(device=dev)
                     .manual_seed(1), device=dev)
    fwd = mk.forward(static, MESH_DEPTH, RR_START, *args)
    rad_t, tape_f, tape_i = mk.forward_taped(static, MESH_DEPTH, RR_START,
                                             *args)
    got_b = mk.backward(static, MESH_DEPTH, RR_START, *args, dL)
    got_tb = mk.backward_from_tape(static, MESH_DEPTH, RR_START, args[0],
                                   args[3], tape_f, tape_i, dL)
    torch.cuda.synchronize()
    if not torch.equal(rad_t, fwd):
        raise RuntimeError("triangle rows: the taped forward's radiance is "
                           "not the forward's bit for bit")
    diff = [int((g != w).sum()) for g, w in zip(got_tb, got_b)]
    if any(diff):
        raise RuntimeError(f"triangle rows: the tape-fed kernel differs "
                           f"from the retrace kernel in {diff} entries")
    if not (got_b[0][tri_slots, :9] != 0).any():
        raise RuntimeError("triangle rows: no cotangent reached a triangle")
    print(f"triangle rows: {len(tri_slots)} triangles and "
          f"{len(static.rows) - len(tri_slots)} patches unrolled, depth "
          f"{MESH_DEPTH}, {R} rays ({time.perf_counter() - t0:.1f} s to "
          f"here); taped forward bit-equal to the forward, tape-fed kernel "
          f"bit-equal to the retrace kernel (full film)")
    _schedule(static, MESH_DEPTH, args, fwd)

    y0 = HEIGHT // 2 - MESH_BAND_ROWS // 2
    band = _band(args, y0)
    bdL = dL[:, y0 * WIDTH:(y0 + MESH_BAND_ROWS) * WIDTH].contiguous()
    nb = band[1].shape[1]
    t_plain_f, want_f = _host_s(lambda: mk.forward_taped_reference(
        static, MESH_DEPTH, RR_START, *band))
    rad_b, tf_b, ti_b = mk.forward_taped(static, MESH_DEPTH, RR_START, *band)
    taped_err = (rad_b - want_f[0]).abs().max().item()
    ints_eq = (ti_b == want_f[2]).all(dim=0).float().mean().item()
    out = {}
    for key, got, plain in (
            ("backward",
             mk.backward(static, MESH_DEPTH, RR_START, *band, bdL),
             lambda: mk.backward_reference(static, MESH_DEPTH, RR_START,
                                           *band, bdL)),
            ("tape_bwd",
             mk.backward_from_tape(static, MESH_DEPTH, RR_START, band[0],
                                   band[3], tf_b, ti_b, bdL),
             lambda: mk.backward_from_tape_reference(
                 static, MESH_DEPTH, RR_START, band[0], band[3], tf_b, ti_b,
                 bdL))):
        t_plain, want = _host_s(plain)
        ok, report, err, equal = _backward_agreement(got, want)
        print(f"triangle rows, {key} kernel vs plain ({nb} rays, rows "
              f"{y0}-{y0 + MESH_BAND_ROWS - 1}, plain {t_plain:.1f} s): "
              + report + f"; bit-equal rays {equal:.6f}; max abs err "
              f"{err:.3g}")
        if not ok:
            raise RuntimeError(f"triangle rows: the {key} kernel disagrees "
                               f"with its plain version")
        out[key] = {"max_abs_err": err, "plain_ms": t_plain * 1e3}
    print(f"triangle rows, taped forward vs plain ({nb} rays, plain "
          f"{t_plain_f:.1f} s): int planes equal on {ints_eq:.6f} of rays, "
          f"radiance max abs err {taped_err:.3g}")
    if ints_eq < 0.999:
        raise RuntimeError("triangle rows: the taped forward's tape "
                           "disagrees with its plain version")
    out["taped"] = {"max_abs_err": taped_err, "plain_ms": t_plain_f * 1e3}
    t_plain_fwd, want_fwd = _host_s(lambda: mk.forward_reference(
        static, MESH_DEPTH, RR_START, *band))
    got_fwd = mk.forward(static, MESH_DEPTH, RR_START, *band)
    torch.cuda.synchronize()
    print(f"triangle rows, forward vs plain ({nb} rays, plain "
          f"{t_plain_fwd:.1f} s): within rel 1e-4 on "
          f"{_frac_within(got_fwd, want_fwd):.6f} of rays, bit-equal "
          f"{(got_fwd == want_fwd).all(dim=0).float().mean().item():.6f}")
    if _frac_within(got_fwd, want_fwd) < 0.999:
        raise RuntimeError("triangle rows: the forward disagrees with its "
                           "plain version")
    out["forward"] = {"max_abs_err": (got_fwd - want_fwd).abs().max().item(),
                      "plain_ms": t_plain_fwd * 1e3}

    # the two training paths, counters reset before each
    grads = {}
    for bw, want in (("pallas", _only(forward_mesh=1, backward=1)),
                     ("pallas_taped", _only(forward_taped=1,
                                            backward_tape=1))):
        _reset_counters()
        step_s, (loss, gsp, gd1) = _host_s(lambda: _mesh_vg(scene, static,
                                                            bw))
        counts = _counters()
        if counts != want:
            raise RuntimeError(f"triangle rows, {bw}: launched {counts}, "
                               f"expected {want}")
        if not (torch.isfinite(gsp).all() and torch.isfinite(gd1).all()):
            raise RuntimeError(f"triangle rows, {bw}: gradient not finite")
        if not (gd1[6:] != 0).any():
            raise RuntimeError(f"triangle rows, {bw}: zero gradient on the "
                               f"triangle rows")
        grads[bw] = (gsp, gd1)
        out["backward" if bw == "pallas" else "tape_bwd"]["launches"] = \
            counts["backward" if bw == "pallas" else "backward_tape"]
        if bw == "pallas_taped":
            out["taped"]["launches"] = counts["forward_taped"]
        else:
            out["forward"]["launches"] = counts["forward_mesh"]
        print(f"triangle rows, value_and_grad ({bw}, spp 1): loss "
              f"{loss:.6e}, {step_s * 1e3:.1f} ms (first call), launches "
              f"{counts}")
    errs = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(grads["pallas_taped"], grads["pallas"])]
    print(f"triangle rows: pallas_taped vs pallas gradients, worst err "
          f"{errs} of the largest entry")
    if max(errs) > 1e-5:
        raise RuntimeError("triangle rows: the two backward paths disagree")

    times = {
        "forward": lambda: mk.forward(static, MESH_DEPTH, RR_START, *args),
        "taped": lambda: mk.forward_taped(static, MESH_DEPTH, RR_START,
                                          *args),
        "backward": lambda: mk.backward(static, MESH_DEPTH, RR_START, *args,
                                        dL),
        "tape_bwd": lambda: mk.backward_from_tape(
            static, MESH_DEPTH, RR_START, args[0], args[3], tape_f, tape_i,
            dL)}
    ms = {k: _events_ms(fn, 5) for k, fn in times.items()}
    print(f"triangle rows, ms per sample of {R} rays: {ms}")
    n_patch = len(static.rows) - len(tri_slots)
    bounds = _unrolled_bounds(args, tape_i, MESH_DEPTH,
                              n_patch * PRIM_TEST_OPS
                              + len(tri_slots) * TRI_PLANE_OPS)
    for key in out:
        out[key].update({
            "ms": ms[key], "bound_ms": bounds[key][0],
            "bound_by": bounds[key][1], "library_ms": None,
            "plain_rays": nb, "rays": R, "max_depth": MESH_DEPTH,
            "triangle_rows": len(tri_slots)})
    print(f"triangle rows: live bounces {bounds['live']}, shadow scans "
          f"{bounds['diffuse_on']}, tape {bounds['tape_bytes'] / 1e9:.3f} GB "
          f"({bounds['tape_read'] / 1e9:.3f} GB read by the tape-fed "
          f"kernel); bounds {[bounds[k] for k in out]}")
    return out


TIE_SIDE = 256
TIE_RAYS = 4096


def _tie_scenes(dev):
    """Phase 11's tie scenes: per layout of tie_mesh_scene, the mesh kernel
    and the winner-taped forward against forward_winners_reference on the
    full film, and the walk on tie_mesh_rays against walk_reference."""
    for layout in presets.TIE_LAYOUTS:
        scene, _ = scene_from_dict(presets.tie_mesh_scene(TIE_SIDE, TIE_SIDE,
                                                          layout), device=dev)
        static = mk.SceneStatic.from_scene(scene)
        arrays = tuple(a for p in kt.mesh_packs_for(scene, static)
                       for a in p.arrays)
        px, py = kt.tile_coords(TIE_SIDE, TIE_SIDE, 0, dev)
        args = kt.kernel_inputs(scene, *kt.camera_planes(
            scene, TIE_SIDE, TIE_SIDE, px, py, 1), static)
        rad = mk.forward(static, MESH_DEPTH, RR_START, *args, *arrays)
        win = mk.forward_winners(static, MESH_DEPTH, RR_START, *args,
                                 *arrays)
        t_plain, want = _host_s(lambda: mk.forward_winners_reference(
            static, MESH_DEPTH, RR_START, *args, *arrays))
        rel = (rad - want[0]).abs() / want[0].abs().clamp(min=1e-2)
        frac = (rel < 1e-4).all(dim=0).float().mean().item()
        exact = (rad == want[0]).all(dim=0).float().mean().item()
        tapes = torch.equal(win[1], want[1]) and torch.equal(win[2], want[2])
        on_mesh = int((win[1] >= static.mesh_parts[0].start).sum())
        R = TIE_RAYS
        rays = torch.from_numpy(presets.tie_mesh_rays(R, seed=3)).to(dev)
        seed_f = torch.zeros((4, R), device=dev)
        seed_f[0] = torch.where(torch.arange(R, device=dev) % 3 == 2,
                                -math.inf, math.inf)
        seed_i = torch.full((2, R), -1, dtype=torch.int32, device=dev)
        walked = bn.walk(static, rays, seed_f, seed_i, *arrays)
        walk_want = bn.walk_reference(static, rays, seed_f, seed_i, *arrays)
        walk_same = all(torch.equal(g, w) for g, w in zip(walked, walk_want))
        print(f"tie scene {layout} ({static.mesh_parts[0].count} triangles, "
              f"{TIE_SIDE}x{TIE_SIDE}, depth {MESH_DEPTH}): mesh kernel vs "
              f"plain {frac:.6f} of rays within rel 1e-4, bit-equal "
              f"{exact:.6f}; winner-taped radiance bit-equal to the mesh "
              f"kernel's {torch.equal(win[0], rad)}, tapes equal to the "
              f"plain version's {tapes} ({on_mesh} mesh winners taped); "
              f"walk on {R} tie rays bit-equal {walk_same} "
              f"({int((walked[1][0] >= 0).sum())} hits); plain "
              f"{t_plain:.1f} s")
        if not (frac >= 0.999 and tapes and walk_same and on_mesh
                and torch.equal(win[0], rad)):
            raise RuntimeError(f"tie scene {layout}: the mesh kernels "
                               f"disagree with their plain versions")


def _winners(mstatic, fargs, marrays, y0, mesh_ops):
    """Phase 13: the winner-taped forward at phase 11's workload; returns
    its kernels-line numbers but its launches (phase 14 counts them on the
    slice's path)."""
    ref = mk.forward(mstatic, MESH_DEPTH, RR_START, *fargs, *marrays)
    rad, t_idx, t_sh = mk.forward_winners(mstatic, MESH_DEPTH, RR_START,
                                          *fargs, *marrays)
    torch.cuda.synchronize()
    if not torch.equal(rad, ref):
        raise RuntimeError("the winner-taped forward's radiance is not the "
                           "mesh kernel's bit for bit")
    del ref
    a, b = y0 * WIDTH, (y0 + MESH_BAND_ROWS) * WIDTH
    t_plain, want = _host_s(lambda: mk.forward_winners_reference(
        mstatic, MESH_DEPTH, RR_START, *_band(fargs, y0), *marrays))
    same = (torch.equal(t_idx[:, a:b], want[1])
            and torch.equal(t_sh[..., a:b], want[2]))
    err = (rad[:, a:b] - want[0]).abs().max().item()
    exact = (rad[:, a:b] == want[0]).all(dim=0).float().mean().item()
    print(f"winner-taped forward: radiance bit-equal to the mesh kernel on "
          f"all {rad.shape[1]} rays; tapes vs plain on {b - a} rays (plain "
          f"{t_plain:.1f} s): equal {same}, radiance bit-equal rays "
          f"{exact:.6f}, max abs err {err:.3g}; hits taped "
          f"{int((t_idx >= 0).sum())}, shadow winners taped "
          f"{int((t_sh >= 0).sum())}")
    if not same:
        raise RuntimeError("the winner tapes disagree with the plain "
                           "version")
    fwd = lambda: mk.forward(mstatic, MESH_DEPTH, RR_START, *fargs, *marrays)
    win = lambda: mk.forward_winners(mstatic, MESH_DEPTH, RR_START, *fargs,
                                     *marrays)
    turns = [("mesh", fwd), ("winners", win), ("winners", win),
             ("mesh", fwd)]
    timed = [(k, _events_ms(fn, 2)) for k, fn in turns]
    win_ms = [t for k, t in timed if k == "winners"]
    print(f"winner-taped forward vs mesh kernel, ms per sample in turns: "
          f"{timed}")
    R = fargs[1].shape[1]
    nbytes = (_nbytes(fargs[0], fargs[1], fargs[3], *marrays)
              + fargs[2].numel() * 4 + 4 * R * 4 + _nbytes(t_idx, t_sh))
    bound = _bound(nbytes, mesh_ops)
    return {"max_abs_err": err, "ms": min(win_ms),
            "plain_ms": t_plain * 1e3, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": None,
            "plain_rays": b - a, "rays": R, "max_depth": MESH_DEPTH,
            "mesh_ms": [t for k, t in timed if k == "mesh"],
            "winners_ms": win_ms, "tape_bytes": _nbytes(t_idx, t_sh)}


def _mesh_grads(mscene, mstatic):
    """Phase 14: the slice's path. Returns the winner-taped forward's
    launches in one value_and_grad and its gradients (d spectra,
    d data1)."""
    _reset_counters()
    step_s, (loss, gsp, gd1) = _host_s(lambda: _mesh_vg(mscene, mstatic))
    counts = _counters()
    if counts != _only(forward_winners=1):
        raise RuntimeError(f"mesh value_and_grad launched {counts}, "
                           f"expected one winner-taped forward and nothing "
                           f"else")
    if not (torch.isfinite(gsp).all() and torch.isfinite(gd1).all()):
        raise RuntimeError("mesh gradient not finite")
    if not (gd1[6:] != 0).any():
        raise RuntimeError("zero gradient on the mesh rows")
    step2_s, (_, gsp2, gd12) = _host_s(lambda: _mesh_vg(mscene, mstatic))
    if not (torch.equal(gsp, gsp2) and torch.equal(gd1, gd12)):
        raise RuntimeError("mesh gradient differs between two runs")
    nz = int((gd1[6:] != 0).any(dim=1).sum())
    print(f"mesh value_and_grad (81,920 triangles, 1024^2, depth "
          f"{MESH_DEPTH}, spp 1): loss {loss:.6e}, launches {counts}; "
          f"{step_s * 1e3:.1f} ms, {step2_s * 1e3:.1f} ms on the host clock; "
          f"finite, bit-equal across two runs; {nz} mesh rows with a "
          f"non-zero d data1; |d data1| {float(gd1.abs().sum()):.6g}, "
          f"|d spectra| {float(gsp.abs().sum()):.6g}")
    del gsp2, gd12
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _mesh_vg(mscene, mstatic)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9

    # the guided replay alone, on the winner tape of one sample
    dev = mscene.device
    px, py = kt.tile_coords(WIDTH, HEIGHT, 0, dev)
    prims_full, rays, seeds, spect = kt.kernel_inputs(
        mscene, *kt.camera_planes(mscene, WIDTH, HEIGHT, px, py, 1))
    marrays = tuple(a for p in kt.mesh_packs_for(mscene, mstatic)
                    for a in p.arrays)
    rad, t_idx, t_sh = mk.forward_winners(
        mstatic, MESH_DEPTH, RR_START, mk._unrolled(mstatic, prims_full),
        rays, seeds, spect, *marrays)
    leaves = [x.clone().requires_grad_(True) for x in (prims_full, rays,
                                                       spect)]
    with torch.enable_grad():
        fwd_s, out = _host_s(lambda: replay.trace_replay(
            mstatic, mscene.primitives.category, leaves[0], leaves[1], seeds,
            leaves[2], t_idx, t_sh, MESH_DEPTH, RR_START))
        bwd_s, _ = _host_s(lambda: torch.autograd.grad(
            out, leaves, torch.ones_like(out)))
    rel = (out.detach() - rad).abs() / rad.abs().clamp(min=1e-2)
    frac = (rel < 1e-4).all(dim=0).float().mean().item()
    exact = (out.detach() == rad).all(dim=0).float().mean().item()
    print(f"guided replay: forward {fwd_s * 1e3:.1f} ms, backward "
          f"{bwd_s * 1e3:.1f} ms on the host clock ({rays.shape[1]} rays); "
          f"its radiance vs the winner-taped kernel's: {frac:.6f} of rays "
          f"within rel 1e-4, bit-equal {exact:.6f}; peak device memory "
          f"above the inputs per step {peak:.3f} GB")
    if frac < 0.999:
        raise RuntimeError("the guided replay does not retrace the "
                           "forward's paths")
    del out, leaves
    wall, dev_ms, idle, n_k, top = _profile(lambda: _mesh_vg(mscene,
                                                             mstatic))
    print(f"profile of one mesh value_and_grad: wall {wall:.1f} ms, device "
          f"{dev_ms:.1f} ms, idle share {idle:.3f}, {n_k} kernel launches; "
          f"top {top}")
    return counts["forward_winners"], gsp, gd1


def _finite_difference(dev):
    """Phase 15: staged config 3's finite-difference check."""
    side, subdiv = FD_SCENE
    scene, _ = scene_from_dict(presets.mesh_scene(side, side, subdiv),
                               device=dev)
    static = mk.SceneStatic.from_scene(scene)
    if not static.mesh_parts:
        raise RuntimeError("the finite-difference scene has no mesh part")
    plans = tuple(meshpack.plan_scene_mesh(scene, part)
                  for part in static.mesh_parts)

    def loss(d1):
        s = dataclasses.replace(scene, primitives=dataclasses.replace(
            scene.primitives, data1=d1))
        return kt.render_sample(s, side, side, 1, FD_DEPTH, RR_START, static,
                                mesh_plans=plans).sum(dtype=torch.float64)

    d1 = scene.primitives.data1.detach().clone().requires_grad_(True)
    _reset_counters()
    loss(d1).backward()
    counts = _counters()
    if counts != _only(forward_winners=1):
        raise RuntimeError(f"finite-difference gradient launched {counts}")
    g_mesh = d1.grad[6:]
    flat = int(g_mesh.abs().argmax())
    row, col = flat // 3 + 6, flat % 3
    with torch.no_grad():
        plus, minus = d1.detach().clone(), d1.detach().clone()
        plus[row, col] += FD_EPS
        minus[row, col] -= FD_EPS
        fd = (loss(plus) - loss(minus)).item() / (2 * FD_EPS)
    ad = d1.grad[row, col].item()
    rel = abs(ad - fd) / max(abs(fd), 1e-6)
    print(f"finite differences ({side}x{side}, "
          f"{sum(p.count for p in static.mesh_parts)} triangles, depth "
          f"{FD_DEPTH}, eps {FD_EPS}, data1[{row}, {col}]): AD {ad:.6g}, FD "
          f"{fd:.6g}, relative error {rel:.3g}")
    if not rel <= 2e-3:
        raise RuntimeError(f"AD and FD disagree: {rel}")


def _mesh_train(mscene, mstatic):
    """Phase 16: optimize on the mesh scene."""
    row = mstatic.mesh_parts[0].reflectance_idx
    with torch.no_grad():
        target = opt.render_mean_xyz(mscene, WIDTH, HEIGHT, 1, MESH_DEPTH,
                                     RR_START)
    spectra = mscene.spectra.clone()
    spectra[row] = spectra[row] * 0.3
    train_s, (_, losses) = _host_s(lambda: opt.optimize(
        dataclasses.replace(mscene, spectra=spectra), target, WIDTH, HEIGHT,
        trainable=("spectra",), steps=TRAIN_STEPS, learning_rate=0.05, spp=1,
        max_depth=MESH_DEPTH, rr_start=RR_START, spectra_rows=[row]))
    print(f"optimize on the mesh scene (spectra row {row}): {TRAIN_STEPS} "
          f"steps in {train_s:.2f} s, losses {losses}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise RuntimeError(f"optimize did not lower the mesh loss: "
                           f"{losses}")


# The wavefront's kernels: name -> (module, wrapper attribute, plain
# version taking the wrapper's positional arguments).
WAVEFRONT_KERNELS = {
    "shade": (mk, "shade_step", mk.shade_step_reference),
    "candidates": (bn, "candidate_kernel", bn.candidates_reference),
    "pair_closest": (bn, "pair_intersect", bn.pair_reference),
    "pair_any": (bn, "pair_occluded", bn.pair_occluded_reference),
    "walk": (bn, "walk", bn.walk_reference),
}


def _recorded_wavefront(static, args, marrays, **kw):
    """wavefront_forward on kernel operands args with every call of the
    wavefront's kernel wrappers recorded: (its result, [(kind, args,
    kwargs, outputs)]), tensors cloned when the call returns
    (wavefront_forward adds NEE to the carry in place afterwards)."""
    calls = []
    saved = {kind: getattr(mod, attr)
             for kind, (mod, attr, _) in WAVEFRONT_KERNELS.items()}

    def recorder(kind, fn):
        def call(*a, **k):
            out = fn(*a, **k)
            keep = lambda xs: tuple(x.clone() if torch.is_tensor(x) else x
                                    for x in xs)
            calls.append((kind, keep(a), k,
                          keep((out,) if torch.is_tensor(out) else out)))
            return out
        return call

    for kind, (mod, attr, _) in WAVEFRONT_KERNELS.items():
        setattr(mod, attr, recorder(kind, saved[kind]))
    try:
        out = kt.wavefront_forward(static, MESH_DEPTH, RR_START, *args,
                                   *marrays, **kw)
    finally:
        for kind, (mod, attr, _) in WAVEFRONT_KERNELS.items():
            setattr(mod, attr, saved[kind])
    return out, calls


def _agreement(got, want):
    """A kernel's outputs against its plain version's: (integer outputs
    equal, share of rays whose float planes are within rel 1e-4 of a
    denominator floored at 1e-2 of the plane's scale, share bit-equal, max
    abs err of the finite entries). Equal infinities agree."""
    ints = all(torch.equal(g, w) for g, w in zip(got, want)
               if not g.is_floating_point())
    floats = [(g, w) for g, w in zip(got, want) if g.is_floating_point()]
    if not floats:
        return ints, 1.0, float(ints), 0.0
    f_got = torch.cat([g.reshape(-1, g.shape[-1]) for g, _ in floats])
    f_want = torch.cat([w.reshape(-1, w.shape[-1]) for _, w in floats])
    same = f_got == f_want
    mag = torch.where(torch.isfinite(f_want), f_want.abs(), 0.0)
    scale = mag.amax(dim=1, keepdim=True).clamp(min=1.0)
    err = torch.where(same, 0.0, (f_got - f_want).abs())
    rel = err / torch.maximum(f_want.abs(), 1e-2 * scale)
    close = (same | (rel < 1e-4)).all(dim=0).float().mean().item()
    exact = same.all(dim=0).float().mean().item()
    finite = torch.isfinite(err)
    max_err = err[finite].max().item() if finite.any() else 0.0
    if not finite.all():
        max_err = math.inf
    return ints, close, exact, max_err


def _candidate_bytes(a, out):
    """Bytes a candidate launch must move: every lane's bound, the o and d
    words of the active lanes, the chunk boxes and the outputs."""
    rays7, bbox = a[0], a[1]
    active = int((rays7[6] > -math.inf).sum())
    return rays7.shape[1] * 4 + active * 6 * 4 + _nbytes(bbox, *out)


def _pair_bytes(a, out, ray_words):
    """Bytes a pair launch must move: every pair's chunk id and outputs,
    ray_words ray words and the exclude word of each live pair (a chunk id
    in [0, n_chunks)), and the triangle rows of each chunk read."""
    pair_i, tri = a[1], a[2]
    n_chunks = tri.shape[0] // meshpack.ROWS_PER_CHUNK
    chunk = pair_i[0]
    live = (chunk >= 0) & (chunk < n_chunks)
    chunks_read = int(torch.unique(chunk[live]).numel())
    return (chunk.numel() * 4 + int(live.sum()) * (ray_words + 1) * 4
            + chunks_read * meshpack.ROWS_PER_CHUNK * tri.shape[1] * 4
            + _nbytes(*out))


def _full_film_check(calls):
    """One launch of each binned kernel of a full-film sample against its
    plain version on the same inputs: the pair scans' launch with the most
    live pairs, the candidate launch with the most active lanes on every
    8th ray. -> {kind: (pairs or rays, (ints, close, exact, err), plain
    seconds)}; raises where they disagree."""
    def live(kind, a):
        if kind == "candidates":
            return int((a[0][6] > -math.inf).sum())
        n_chunks = a[2].shape[0] // meshpack.ROWS_PER_CHUNK
        return int(((a[1][0] >= 0) & (a[1][0] < n_chunks)).sum())

    checked = {}
    for kind in ("candidates", "pair_closest", "pair_any"):
        mine = [(live(kind, a), a, out) for k, a, _, out in calls
                if k == kind]
        if not mine:
            continue
        _, a, got = max(mine, key=lambda m: m[0])
        if kind == "candidates":
            a = (a[0][:, ::8].contiguous(), *a[1:])
            got = tuple(g[..., ::8] for g in got)
        plain = WAVEFRONT_KERNELS[kind][2]
        t_s, want = _host_s(lambda: plain(*a))
        want = (want,) if torch.is_tensor(want) else tuple(want)
        agree = _agreement(got, want)
        if not agree[0] or agree[1] < 0.999:
            raise RuntimeError(f"full film: the {kind} launch disagrees with "
                               f"its plain version (integers equal "
                               f"{agree[0]}, floats close on {agree[1]})")
        checked[kind] = (a[1].shape[1] if kind != "candidates"
                         else a[0].shape[1], agree, t_s)
    return checked


def _candidate_simt(calls):
    """The candidate kernel's chunk loop per cast of a full-film sample:
    each launch's counting build (lane trips: chunk tests; warp trips: the
    drain's passes) against the trips its lanes' supernode masks give
    (binned.candidate_trips), and the SIMT efficiency, lane trips over 32
    per warp trip, of the drain and of the one-thread pass it replaced.
    -> [(drain, one-thread)] per launch; raises where the counts differ."""
    simt = []
    for i, (kind, a, _, _) in enumerate(c for c in calls
                                        if c[0] == "candidates"):
        work = torch.zeros(mk.WORK_KINDS, dtype=torch.int64,
                           device=a[0].device)
        bn.candidate_kernel(*a, work=work)
        w = work.tolist()
        want = bn.candidate_trips(a[0], a[1])
        if (w[5], w[4]) != (want["lane_trips"], want["warp_trips"]):
            raise RuntimeError(f"candidate launch {i}: counted lane and warp "
                               f"trips {w[5]}, {w[4]}, its masks give "
                               f"{want}")
        eff = w[5] / max(32 * w[4], 1)
        one = w[5] / max(32 * want["warp_trips_one_thread"], 1)
        simt.append((eff, one))
        print(f"candidate cast {i}: {w[0]} rays, {w[1]} slab tests; chunk "
              f"loop {w[5]} lane trips, {w[4]} warp trips (as the masks "
              f"give), SIMT efficiency {eff:.4f}; the one-thread pass's "
              f"{want['warp_trips_one_thread']} warp trips, {one:.4f}")
    return simt


def _logged(fn):
    """fn() with every counter reset just before and the binned casts
    logged: (host seconds, result, counters, cast log, host reads)."""
    _reset_counters()
    reads = bn.host_reads
    bn.cast_log = log = []
    try:
        secs, out = _host_s(fn)
    finally:
        bn.cast_log = None
    return secs, out, _counters(), log, bn.host_reads - reads


def _casts(log):
    """The cast log grouped per cast: [(header, [pipeline entries])], the
    device scalars read."""
    casts = []
    for e in log:
        e = {k: int(v) if torch.is_tensor(v) else v for k, v in e.items()}
        if "cast" in e:
            casts.append((e, []))
        else:
            casts[-1][1].append(e)
    return casts


def _cast_summary(header, pipes):
    """One cast's numbers: live rays, real candidates per live ray, live
    pairs, unresolved share of the live rays, the finishes, batches."""
    live = sum(p["live"] for p in pipes)
    pairs = sum(p["pairs"] for p in pipes)
    unres = sum(p["unres"] for p in pipes)
    return {"kind": header["cast"], "live": live,
            "cand_per_ray": round(pairs / max(live, 1), 4), "pairs": pairs,
            "unres_share": round(unres / max(live, 1), 6),
            "finish": [p["finish"] for p in pipes],
            "batches": header["batches"]}


def _want_counts(D, log):
    return _only(shade_step=D, **bn.logged_launches(log))


def _wavefront(mscene, mstatic, fargs, marrays, y0, mesh_counts):
    """Phase 17: the wavefront render at phase 11's workload. Returns the
    kernels-line numbers of the shade step, the walk and the binned casts'
    kernels."""
    D = MESH_DEPTH + 1
    planar = lambda wavefront: kt.render_sample_planar(
        mscene, WIDTH, HEIGHT, 1, MESH_DEPTH, RR_START, mstatic, "none",
        wavefront=wavefront)
    wf_s, img, counts, log, reads = _logged(lambda: planar(True))
    want_counts = _want_counts(D, log)
    if counts != want_counts:
        raise RuntimeError(f"the wavefront launched {counts}, expected "
                           f"{want_counts} from its casts")
    if not counts["candidates"] or not counts["pair_occl"]:
        raise RuntimeError(f"the wavefront launched no binned cast: {counts}")
    if not torch.equal(img, planar(False)):
        raise RuntimeError("the wavefront's image is not the in-kernel "
                           "path's bit for bit")
    ref = mk.forward(mstatic, MESH_DEPTH, RR_START, *fargs, *marrays)
    rad = kt.wavefront_forward(mstatic, MESH_DEPTH, RR_START, *fargs,
                               *marrays)
    if not torch.equal(rad, ref):
        raise RuntimeError("the wavefront's radiance is not the mesh "
                           "kernel's bit for bit")
    casts = [_cast_summary(h, p) for h, p in _casts(log)]
    print(f"wavefront: launches {counts} (shade steps = depth + 1; "
          f"candidate, pair and walk launches as its {len(casts)} casts "
          f"logged); {reads} host reads per sample; image bit-equal to the "
          f"in-kernel path's, radiance bit-equal to the mesh kernel's on "
          f"all {rad.shape[1]} rays; {wf_s * 1e3:.1f} ms for the first "
          f"render on the host clock")
    for c in casts:
        print(f"wavefront cast: {c}")

    # every launch on the band against its plain version
    band = _band(fargs, y0)
    _, calls = _recorded_wavefront(mstatic, band, marrays)
    nb = band[1].shape[1]
    report = {kind: [] for kind in WAVEFRONT_KERNELS}
    plain_s = {}
    for kind, a, k, got in calls:
        plain = WAVEFRONT_KERNELS[kind][2]
        t_s, want = _host_s(lambda: plain(*a))
        want = (want,) if torch.is_tensor(want) else tuple(want)
        plain_s.setdefault(kind, t_s)  # the first launch of each kernel
        ints, close, exact, err = _agreement(got, want)
        report[kind].append((ints, close, exact, err))
        if not ints or close < 0.999:
            raise RuntimeError(f"wavefront band: a {kind} launch disagrees "
                               f"with its plain version (integers equal "
                               f"{ints}, floats close on {close})")
    for kind, rows in report.items():
        if not rows:
            print(f"wavefront band ({nb} rays): no {kind} launch")
            continue
        print(f"wavefront band ({nb} rays, rows {y0}-"
              f"{y0 + MESH_BAND_ROWS - 1}), {len(rows)} {kind} launches vs "
              f"plain: integers equal, floats within rel 1e-4 on "
              f"{[round(r[1], 6) for r in rows]}, bit-equal on "
              f"{[round(r[2], 6) for r in rows]} of rays, max abs err "
              f"{max(r[3] for r in rows):.3g}; plain {plain_s[kind]:.2f} s "
              f"for the first launch")

    # the counting builds over the sample
    work = bn.new_work(rad.device)
    counted = kt.wavefront_forward(mstatic, MESH_DEPTH, RR_START, *fargs,
                                   *marrays, work=work)
    if not torch.equal(counted, rad):
        raise RuntimeError("the counting builds changed the radiance")
    work = {k: v.tolist() for k, v in work.items()}
    (w_casts, box_tests, plane_tests, inside_tests, w_scans, w_lanes,
     w_needed) = work["walk"]
    print(f"wavefront work (counting builds, radiance bit-equal): "
          f"candidates {work['candidates'][0]} rays, "
          f"{work['candidates'][1]} slab tests; closest pairs "
          f"{work['pair'][0]} live, {work['pair'][2]} plane and "
          f"{work['pair'][3]} inside tests; any-hit pairs "
          f"{work['pair_any'][0]} live, {work['pair_any'][2]} plane and "
          f"{work['pair_any'][3]} inside tests; walk {w_casts} casts, "
          f"{box_tests} box tests, {plane_tests} plane tests, "
          f"{w_needed} inside tests needed, {inside_tests} made, "
          f"{w_scans} chunk scans on "
          f"{w_lanes} lanes in all ({w_lanes / max(w_scans, 1):.2f} per "
          f"scan) (mesh kernel: {mesh_counts})")

    # times of every launch at the full film, CUDA events
    _, calls = _recorded_wavefront(mstatic, fargs, marrays)
    per = {kind: [] for kind in WAVEFRONT_KERNELS}
    for kind, a, k, _ in calls:
        mod, attr, _ = WAVEFRONT_KERNELS[kind]
        per[kind].append(_events_ms(lambda: getattr(mod, attr)(*a, **k), 3))
    print(f"wavefront ms per launch, in launch order: "
          f"{ {kind: [round(t, 4) for t in ts] for kind, ts in per.items()} }")
    simt = _candidate_simt(calls)
    full = _full_film_check(calls)
    for kind, (n, (_, _, exact, err), t_s) in full.items():
        print(f"wavefront full film: the {kind} launch with the most live "
              f"work ({n} {'rays, every 8th' if kind == 'candidates' else 'pairs'}"
              f") vs plain: integers equal, bit-equal on {exact:.6f} of "
              f"{'rays' if kind == 'candidates' else 'pairs'}, max abs err "
              f"{err:.3g}; plain {t_s:.2f} s")
    fwd = lambda: mk.forward(mstatic, MESH_DEPTH, RR_START, *fargs, *marrays)
    wf = lambda: kt.wavefront_forward(mstatic, MESH_DEPTH, RR_START, *fargs,
                                      *marrays)
    timed = [(k, _events_ms(fn, 2)) for k, fn in
             [("mesh", fwd), ("wavefront", wf), ("wavefront", wf),
              ("mesh", fwd)]]
    print(f"wavefront vs mesh kernel, ms per sample of {rad.shape[1]} rays "
          f"in turns: {timed}")
    wall, dev_ms, idle, n_k, top = _profile(lambda: planar(True))
    print(f"profile of the wavefront sample: wall {wall:.1f} ms, device "
          f"{dev_ms:.1f} ms, idle share {idle:.3f}, {n_k} kernel launches; "
          f"top {top}")

    # bounds, per launch on average over the sample's launches
    by_kind = {kind: [c for c in calls if c[0] == kind]
               for kind in WAVEFRONT_KERNELS}

    ops = {
        "candidates": work["candidates"][1] * BOX_TEST_OPS,
        "pair_closest": (work["pair"][2] * TRI_PLANE_OPS
                         + work["pair"][3] * TRI_INSIDE_OPS),
        "pair_any": (work["pair_any"][2] * TRI_PLANE_OPS
                     + work["pair_any"][3] * TRI_INSIDE_OPS),
        "walk": (box_tests * BOX_TEST_OPS + plane_tests * TRI_PLANE_OPS
                 + w_needed * TRI_INSIDE_OPS),
    }
    nbytes = {
        "candidates": sum(_candidate_bytes(a, out)
                          for _, a, _, out in by_kind["candidates"]),
        "pair_closest": sum(_pair_bytes(a, out, 6)
                            for _, a, _, out in by_kind["pair_closest"]),
        "pair_any": sum(_pair_bytes(a, out, 7)
                        for _, a, _, out in by_kind["pair_any"]),
        "walk": sum(_nbytes(*a[1:4], *marrays, *out)
                    for _, a, _, out in by_kind["walk"]),
    }
    scans = 0
    shade_bytes = 0
    for _, a, _, out in by_kind["shade"]:
        first = len(a) == 11  # no un_f / un_i: it scans the main rays
        live_in = int(a[7][3].sum())
        scans += (live_in if first else 0) + int(out[5][1::2].sum()) \
            + int(out[2][3].sum())
        shade_bytes += _nbytes(*a[4:], *out)
    ops["shade"] = scans * len(mstatic.rows) * PRIM_TEST_OPS
    nbytes["shade"] = shade_bytes
    bounds = {kind: _bound(nbytes[kind] / max(len(by_kind[kind]), 1),
                           ops[kind] / max(len(by_kind[kind]), 1))
              for kind in WAVEFRONT_KERNELS}
    print(f"wavefront bounds per launch: {bounds} (bytes per sample "
          f"{ {k: round(v / 1e9, 4) for k, v in nbytes.items()} } GB, "
          f"operations per sample {ops})")
    wf_ms = [t for k, t in timed if k == "wavefront"]
    launch_key = {"shade": "shade_step", "candidates": "candidates",
                  "pair_closest": "pair", "pair_any": "pair_occl",
                  "walk": "walk"}
    out = {}
    redesigned = {
        "candidates": "warp-drained: each lane's supernode bitmask; "
                      "supernodes most lanes entered tested lane by lane, "
                      "the other (lane, supernode) items two per pass, 16 "
                      "lanes to an item; entries inserted by their owners "
                      "side by side from pending lists; boxes through L1",
        "pair_closest": "its own loop: the record as 128-bit loads, the next "
                        "one loaded ahead, the inside test before the "
                        "plane's division, unrolled by two",
        "pair_any": "the pair_closest loop's any-hit instantiation"}
    for kind in WAVEFRONT_KERNELS:
        rows = report[kind] + [full[kind][1]] if kind in full else report[kind]
        out[kind] = {
            "route": "cuda", "library_ms": None, "plain_rays": nb,
            "rays": rad.shape[1], "max_depth": MESH_DEPTH,
            "wavefront_ms": wf_ms,
            "mesh_ms": [t for k, t in timed if k == "mesh"],
            "launches": counts[launch_key[kind]],
            "max_abs_err": max((r[3] for r in rows), default=None),
            "ms": sum(per[kind]) / len(per[kind]) if per[kind] else None,
            "ms_per_launch": per[kind],
            "plain_ms": plain_s[kind] * 1e3 if kind in plain_s else None,
            "bound_ms": bounds[kind][0], "bound_by": bounds[kind][1],
            "bit_equal_share": min((r[2] for r in rows), default=None),
            "work": work.get({"pair_closest": "pair", "pair_any": "pair_any"}
                             .get(kind, kind)),
        }
        if kind in redesigned:
            out[kind]["redesigned"] = redesigned[kind]
        if kind == "candidates":
            out[kind]["simt_efficiency"] = [e for e, _ in simt]
            out[kind]["simt_efficiency_one_thread"] = [e for _, e in simt]
        if kind in full:
            n, _, t_s = full[kind]
            out[kind]["full_film_check"] = {
                "rays" if kind == "candidates" else "pairs": n,
                "plain_ms": t_s * 1e3}
    out["casts"] = casts
    out["host_reads"] = reads
    return out


def _wavefront_grads(mscene, mstatic, fargs, marrays, grads_in_kernel):
    """Phase 18: phase 14's value_and_grad through the wavefront."""
    D = MESH_DEPTH + 1
    step_s, (loss, gsp, gd1), counts, log, reads = _logged(
        lambda: _mesh_vg(mscene, mstatic, wavefront=True))
    want_counts = _want_counts(D, log)
    if counts != want_counts or counts["pair_occl"]:
        raise RuntimeError(f"wavefront value_and_grad launched {counts}, "
                           f"expected {want_counts} from its casts, "
                           f"closest-hit shadow casts only")
    same = [torch.equal(g, w) for g, w in zip((gsp, gd1), grads_in_kernel)]
    if not all(same):
        raise RuntimeError(f"wavefront gradients differ from phase 14's: "
                           f"bit-equal {same}")
    step2_s, _ = _host_s(lambda: _mesh_vg(mscene, mstatic, wavefront=True))
    taped = kt.wavefront_forward(mstatic, MESH_DEPTH, RR_START, *fargs,
                                 *marrays, taped=True)
    want = mk.forward_winners(mstatic, MESH_DEPTH, RR_START, *fargs,
                              *marrays)
    if not all(torch.equal(a, b) for a, b in zip(taped, want)):
        raise RuntimeError("the taped wavefront's radiance or tapes are not "
                           "the winner-taped kernel's")
    del taped, want
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _mesh_vg(mscene, mstatic, wavefront=True)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    print(f"wavefront value_and_grad (1024^2, depth {MESH_DEPTH}, spp 1): "
          f"loss {loss:.6e}, launches {counts} as its casts logged, "
          f"{reads} host reads; gradients bit-equal to phase 14's; taped "
          f"radiance and tapes equal to the winner-taped kernel's (full "
          f"film); {step_s * 1e3:.1f} ms, {step2_s * 1e3:.1f} ms on the host "
          f"clock; peak device memory above the inputs per step {peak:.3f} "
          f"GB")


def _walk_seeded(mstatic, marrays, rays, exclude, bound, live):
    """The walk-only cast: one walk over every ray, a live ray seeded with
    its bound (idx -1), a dead one with t = -inf and mapped to +inf
    after."""
    seed_f = torch.zeros((4, rays.shape[1]), device=rays.device)
    seed_f[0] = torch.where(live, bound, -math.inf)
    seed_i = torch.stack([torch.full_like(exclude, -1), exclude])
    f, i = bn.walk(mstatic, rays, seed_f, seed_i, *marrays)
    f[0] = torch.where(live, f[0], math.inf)
    return f, i


def _within_bound(f, i, bound, live):
    """A closest-hit result as the walk seeded with the bound returns it:
    a hit beyond the bound (a chunk entered before the padded bound) is no
    hit, (bound, 0, 0, 0, -1); dead rays +inf. The shade step's fold and
    the occlusion test read nothing else."""
    within = (i[0] >= 0) & (f[0] <= bound)
    miss = torch.stack([bound, *(torch.zeros_like(bound),) * 3])
    f = torch.where(within, f, miss)
    f[0] = torch.where(live, f[0], math.inf)
    return f, torch.where(within, i, -1)


def _recorded_casts(mstatic, fargs, marrays):
    """The casts of one wavefront sample on kernel operands fargs, in cast
    order: [(kind "closest" or "any", rays, exclude, bound, live)]."""
    recorded = []
    saved = bn.mesh_closest_hit_batched, bn.mesh_occluded_batched

    def recorder(kind, fn):
        def call(static, arrays, rays, exclude, bound, **kw):
            recorded.append((kind, rays.clone(), exclude.clone(),
                             bound.clone(), kw["active"].clone()))
            return fn(static, arrays, rays, exclude, bound, **kw)
        return call

    bn.mesh_closest_hit_batched = recorder("closest", saved[0])
    bn.mesh_occluded_batched = recorder("any", saved[1])
    try:
        kt.wavefront_forward(mstatic, MESH_DEPTH, RR_START, *fargs, *marrays)
    finally:
        bn.mesh_closest_hit_batched, bn.mesh_occluded_batched = saved
    return recorded


def _binned_casts(mstatic, fargs, marrays):
    """Phase 19: every cast of one wavefront sample at the full film
    through the binned pipeline against one seeded walk of the same rays;
    each _walk_finish branch forced with k = 1."""
    recorded = _recorded_casts(mstatic, fargs, marrays)
    for n, (kind, rays, exclude, bound, live) in enumerate(recorded):
        R = rays.shape[1]
        kw = dict(active=live, batch=R // kt.MESH_CAST_BATCH_FRACTION,
                  threshold=R // kt.MESH_CAST_THRESHOLD_FRACTION)
        closest = lambda: bn.mesh_closest_hit_batched(
            mstatic, marrays, rays, exclude, bound, **kw)
        anyhit = lambda: bn.mesh_occluded_batched(
            mstatic, marrays, rays, exclude, bound, **kw)
        walked = lambda: _walk_seeded(mstatic, marrays, rays, exclude, bound,
                                      live)
        bn.cast_log = log = []
        try:
            f, i = closest()
            occl = anyhit()
        finally:
            bn.cast_log = None
        wf, wi = walked()
        gf, gi = _within_bound(f, i, bound, live)
        if not (torch.equal(gi, wi) and torch.equal(gf, wf)):
            raise RuntimeError(f"binned cast {n} ({kind}) differs from the "
                               f"seeded walk on "
                               f"{int((gi != wi).sum())} lanes' idx")
        flag = live & (i[0] >= 0) & (f[0] <= bound)
        if not torch.equal(occl, flag):
            raise RuntimeError(f"binned cast {n}: the any-hit flag differs "
                               f"from the closest hit's on "
                               f"{int((occl != flag).sum())} lanes")
        (h_c, p_c), (h_a, p_a) = _casts(log)
        timed = [(k, _events_ms(fn, 2)) for k, fn in
                 [("binned", closest), ("walk", walked), ("walk", walked),
                  ("binned", closest)]]
        any_ms = _events_ms(anyhit, 2)
        row = dict(_cast_summary(h_c, p_c), cast=n, recorded=kind,
                   ms_binned_walk=timed, ms_any=any_ms,
                   any_unres_share=_cast_summary(h_a, p_a)["unres_share"],
                   any_finish=_cast_summary(h_a, p_a)["finish"])
        print(f"binned cast {n} ({kind}): {row}; idx, t and normals "
              f"bit-equal to the seeded walk's on all {R} lanes, any-hit "
              f"flag equal to the closest hit's")

    # each finish of _walk_finish, forced by k = 1 on the cast that it
    # leaves the most rays unresolved in
    tri_rows, bbox = bn._part(marrays, 0)
    unres = [~bn.mesh_winner(tri_rows, bbox, rays, exclude, bound, 1,
                             live)[3] & live
             for _, rays, exclude, bound, live in recorded]
    n = max(range(len(recorded)), key=lambda c: int(unres[c].sum()))
    _, rays, exclude, bound, live = recorded[n]
    R = rays.shape[1]
    tiers = bn._finish_tiers(R)
    ids = torch.nonzero(unres[n])[:, 0]
    unres = unres[n]
    resolved = torch.nonzero(live & ~unres)[:, 0]
    if ids.shape[0] <= tiers[-1]:
        raise RuntimeError(f"k = 1 leaves {ids.shape[0]} rays unresolved, "
                           f"too few to force the full walk")
    forced = []
    cases = ([(0, None)]
             + [((lo + u) // 2, u) for lo, u in zip([0] + tiers, tiers)]
             + [(ids.shape[0], "full")])
    for n_unres, finish in cases:
        act = torch.zeros_like(live)
        act[resolved] = True
        act[ids[:n_unres]] = True
        bn.cast_log = log = []
        try:
            f, i = bn.mesh_closest_hit(mstatic, marrays, rays, exclude, bound,
                                       1, act)
        finally:
            bn.cast_log = None
        got = log[-1]["finish"]
        wf, wi = _walk_seeded(mstatic, marrays, rays, exclude, bound, act)
        gf, gi = _within_bound(f, i, bound, act)
        if got != finish or not (torch.equal(gi, wi) and torch.equal(gf, wf)):
            raise RuntimeError(f"k = 1, {n_unres} unresolved: finish {got} "
                               f"(expected {finish}), winners equal to the "
                               f"walk's {torch.equal(gi, wi)}")
        ms = _events_ms(lambda: bn.mesh_closest_hit(
            mstatic, marrays, rays, exclude, bound, 1, act), 2)
        forced.append((n_unres, finish, round(ms, 3)))
    print(f"binned finishes forced with k = 1 on cast {n} (tiers {tiers}): "
          f"(unresolved, finish, ms) {forced}; winners bit-equal to the "
          f"seeded walk's in each")


def _image_agreement(got, want):
    """Phase 20's comparison of two XYZ images (H, W, 3): (share of pixels
    within rtol = atol = 2e-4, relative difference of the mean XYZ)."""
    close = torch.isclose(got, want, rtol=2e-4, atol=2e-4).all(dim=-1)
    g, w = got.mean(dim=(0, 1)), want.mean(dim=(0, 1))
    return (close.float().mean().item(),
            ((g - w).abs() / w.abs()).max().item())


def _peak_gb(fn):
    """(host seconds, peak device memory in GB above what was allocated
    before, fn's result)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    secs, out = _host_s(fn)
    return secs, (torch.cuda.max_memory_allocated() - base) / 1e9, out


def _eager_render(scene, served_accum):
    """Phase 20: the eager tracer's render against phase 4's."""
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP,
                       max_depth=MAX_DEPTH, kernel="xla")
    _reset_counters()
    first_s, peak, out = _peak_gb(lambda: render(scene, cfg))
    if _counters() != _only():
        raise RuntimeError(f"the eager render launched {_counters()}")
    again_s, _ = _host_s(lambda: render(scene, cfg))
    accum = out["accum_xyz"]
    if not torch.isfinite(accum).all():
        raise RuntimeError("the eager render is not finite")
    frac, rel_mean = _image_agreement(accum, served_accum)
    paths = WIDTH * HEIGHT * SPP
    print(f"eager render (kernel='xla'): {WIDTH}x{HEIGHT} spp {SPP} depth "
          f"{MAX_DEPTH} in {first_s:.3f} s, {again_s:.3f} s "
          f"({paths / first_s / 1e6:.3f}, {paths / again_s / 1e6:.3f} "
          f"Mpaths/s), peak {peak:.3f} GB, no kernel launch; vs phase 4's "
          f"kernel render: {frac:.6f} of pixels within 2e-4, mean XYZ rel "
          f"{rel_mean:.3g}")
    if frac < 0.99 or rel_mean > 1e-3:
        raise RuntimeError(f"eager render off the kernel render: {frac}, "
                           f"{rel_mean}")
    wall, dev_ms, idle, n_k, top = _profile(lambda: xla_tracer.render_sample(
        scene, WIDTH, HEIGHT, 1, MAX_DEPTH))
    print(f"profile of one eager sample: wall {wall:.1f} ms, device "
          f"{dev_ms:.1f} ms, idle share {idle:.3f}, {n_k} kernel launches; "
          f"top {top}")


def _oracle_vg(scene, static, bands):
    """value_and_grad of phase 7's loss with backward="xla", the film in
    `bands` row bands (each band's share of the mean, so their losses and
    gradients add up): (loss, d spectra, d data1)."""
    sp, d1, s = _train_leaves(scene)
    rows = HEIGHT // bands
    total = 0.0
    for y0 in range(0, HEIGHT, rows):
        px, py = kt.tile_coords(WIDTH, rows, y0, scene.device)
        accum = torch.zeros((3, rows * WIDTH), device=scene.device)
        for smp in range(1, SPP + 1):
            accum = accum + kt.render_pixels_planar(
                s, WIDTH, HEIGHT, px, py, smp, MAX_DEPTH, RR_START, static,
                "xla")
        loss = ((accum / float(SPP)) ** 2).sum() / float(3 * WIDTH * HEIGHT)
        loss.backward()
        total += loss.item()
    return total, sp.grad, d1.grad


def _gradient_oracle(scene, static, grads_retrace, loss_retrace):
    """Phase 21: backward="xla" against phase 7's backward="pallas", then
    optimize(kernel="xla")."""
    for bands in ORACLE_BANDS:
        try:
            step_s, peak, (loss, *grads) = _peak_gb(
                lambda: _oracle_vg(scene, static, bands))
            break
        except torch.cuda.OutOfMemoryError:
            print(f"gradient oracle: out of memory in {bands} band(s)")
            torch.cuda.empty_cache()
    else:
        raise RuntimeError("the gradient oracle does not fit in "
                           f"{ORACLE_BANDS[-1]} bands")
    report = []
    for nm, g, w in zip(("spectra", "data1"), grads, grads_retrace):
        if not torch.isfinite(g).all():
            raise RuntimeError(f"backward='xla': {nm} gradient not finite")
        rel_l2 = ((g - w).norm() / w.norm()).item()
        worst = (g - w).abs().max().item()
        report.append(f"{nm} rel L2 {rel_l2:.3g}, worst element "
                      f"{worst:.3g} (largest {w.abs().max().item():.3g})")
        if not rel_l2 <= ORACLE_L2:
            raise RuntimeError(f"backward='xla' {nm} gradient off "
                               f"backward='pallas' by {rel_l2} (L2)")
    rel_loss = abs(loss - loss_retrace) / loss_retrace
    print(f"gradient oracle (backward='xla', {WIDTH}x{HEIGHT}, spp {SPP}, "
          f"depth {MAX_DEPTH}, {bands} band(s)): loss {loss:.6e} (phase 7: "
          f"{loss_retrace:.6e}), {step_s:.3f} s, peak {peak:.3f} GB; vs "
          f"backward='pallas': " + "; ".join(report))
    if rel_loss > 1e-5:
        raise RuntimeError(f"backward='xla' loss off phase 7's by {rel_loss}")
    with torch.no_grad():
        target = opt.render_mean_xyz(scene, WIDTH, HEIGHT, SPP, MAX_DEPTH,
                                     RR_START, kernel="xla")
    spectra = scene.spectra.clone()
    spectra[PERTURB_ROW] = spectra[PERTURB_ROW] * 0.3
    train_s, peak, (_, losses) = _peak_gb(lambda: opt.optimize(
        dataclasses.replace(scene, spectra=spectra), target, WIDTH, HEIGHT,
        steps=TRAIN_STEPS, learning_rate=0.05, spp=SPP, max_depth=MAX_DEPTH,
        rr_start=RR_START, kernel="xla", spectra_rows=[PERTURB_ROW]))
    print(f"optimize(kernel='xla'): {TRAIN_STEPS} steps in {train_s:.2f} s, "
          f"peak {peak:.3f} GB, losses {losses}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise RuntimeError(f"optimize(kernel='xla') did not lower the loss: "
                           f"{losses}")


def _brute_chunks(o, d, exclude, prims):
    """intersect_brute over every primitive in chunks of BRUTE_CHUNK rays
    -> (hit, index, t)."""
    parts = [isect.intersect_brute(o[i:i + BRUTE_CHUNK],
                                   d[i:i + BRUTE_CHUNK],
                                   exclude[i:i + BRUTE_CHUNK], prims)
             for i in range(0, o.shape[0], BRUTE_CHUNK)]
    return tuple(torch.cat([getattr(h, k) for h in parts])
                 for k in ("hit", "index", "t"))


def _bvh_mesh(mscene, mstatic):
    """Phase 22: the BVH on phase 11's scene."""
    dev = mscene.device
    n_prims = mscene.primitives.count
    compile_s, _ = _host_s(native._load)
    build_s, bvh = _host_s(lambda: bvh_builder.scene_bvh(mscene,
                                                         backend="native"))
    bvh = bvh_builder.to_device(bvh, dev)
    print(f"BVH: native builder compiled in {compile_s:.2f} s, "
          f"{bvh.n_nodes} nodes over {n_prims} primitives built in "
          f"{build_s:.3f} s")
    px, py = kt.tile_coords(WIDTH, 1, HEIGHT // 2, dev)
    o, d = (x.T.contiguous() for x in kt.camera_planes(
        mscene, WIDTH, HEIGHT, px, py, 1)[:2])
    gen = torch.Generator(device=dev).manual_seed(22)
    with torch.no_grad():
        casts = []
        ex = torch.full((o.shape[0],), -1, dtype=torch.int64, device=dev)
        casts.append((o, d, ex))
        want = _brute_chunks(o, d, ex, mscene.primitives)
        hit_pos = o + want[2][:, None] * d
        d2 = torch.randn(o.shape, generator=gen, device=dev)
        d2 = d2 / d2.norm(dim=-1, keepdim=True)
        casts.append((hit_pos, d2, want[1]))
        bvh_traverse.step_log = []
        report = []
        for i, (co, cd, cex) in enumerate(casts):
            ref = want if i == 0 else _brute_chunks(co, cd, cex,
                                                    mscene.primitives)
            fast = bvh_traverse.intersect_bvh(co, cd, cex, mscene.primitives,
                                              bvh)
            hit = ref[0]
            ok = (torch.equal(fast.hit, hit)
                  and torch.equal(fast.index[hit], ref[1][hit])
                  and torch.allclose(fast.t[hit], ref[2][hit], rtol=1e-5,
                                     atol=1e-4))
            report.append(f"cast {i}: {int(hit.sum())} of {hit.numel()} hit,"
                          f" winners equal {ok}")
            if not ok:
                raise RuntimeError(f"intersect_bvh differs from "
                                   f"intersect_brute on cast {i}")
        print("BVH vs brute force (a row of camera rays, then their bounce "
              "rays): " + "; ".join(report) + f"; loop steps "
              f"{bvh_traverse.step_log}")
        bvh_traverse.step_log = []
        _reset_counters()
        secs, peak, img = _peak_gb(lambda: xla_tracer.render_sample(
            mscene, WIDTH, HEIGHT, 1, MESH_DEPTH, bvh=bvh))
        steps = bvh_traverse.step_log
        bvh_traverse.step_log = None
        if _counters() != _only():
            raise RuntimeError(f"the eager BVH render launched {_counters()}")
        want_img = kt.render_sample(mscene, WIDTH, HEIGHT, 1, MESH_DEPTH,
                                    static=mstatic, backward="none")
    if not torch.isfinite(img).all():
        raise RuntimeError("the eager BVH render is not finite")
    frac, rel_mean = _image_agreement(img, want_img)
    print(f"eager BVH render: {WIDTH}x{HEIGHT} sample 1 depth {MESH_DEPTH} "
          f"in {secs:.3f} s ({WIDTH * HEIGHT / secs / 1e6:.4f} Mpaths/s), "
          f"peak {peak:.3f} GB, loop steps per cast {steps} "
          f"({sum(steps)} in all), no kernel launch; vs the mesh kernel's "
          f"render: {frac:.6f} of pixels within 2e-4, mean XYZ rel "
          f"{rel_mean:.3g}")
    if frac < 0.99 or rel_mean > 1e-3:
        raise RuntimeError(f"eager BVH render off the mesh kernel's: {frac}, "
                           f"{rel_mean}")


def _observability(scene):
    """Phase 23: measure_mean_depth, the CLI's --profile and
    debug.checked."""
    dev = scene.device
    side = PROFILE_SIDE
    cscene, _ = scene_from_dict(presets.cornell_box(side, side), device=dev)
    cstatic = mk.SceneStatic.from_scene(cscene)
    mean_s, m = _host_s(lambda: profiling.measure_mean_depth(
        cscene, side, side, sample=1, max_depth=MAX_DEPTH, rr_start=RR_START))
    px, py = kt.tile_coords(side, side, 0, dev)
    cargs = kt.kernel_inputs(cscene, *kt.camera_planes(cscene, side, side,
                                                       px, py, 1))
    tape_i = mk.forward_taped(cstatic, MAX_DEPTH, RR_START, *cargs)[2]
    tape_mean = mk.trips_from_tape(tape_i).double().mean().item()
    print(f"observability: measure_mean_depth "
          f"(Cornell {side}x{side}, depth {MAX_DEPTH}) {m:.6f} in "
          f"{mean_s:.3f} s; mean trips of the taped forward's tape "
          f"{tape_mean:.6f} (rel {abs(m - tape_mean) / tape_mean:.3g})")
    if abs(m - tape_mean) > 1e-2 * tape_mean:
        raise RuntimeError(f"measure_mean_depth {m} off the tape's "
                           f"{tape_mean}")
    with tempfile.TemporaryDirectory() as tmp:
        logdir = os.path.join(tmp, "trace")
        argv = ["render", "--preset", "cornell_box", "--width", str(side),
                "--height", str(side), "--spp", "1", "--out",
                os.path.join(tmp, "cornell.png"), "--profile", logdir]
        cli_s, rc = _host_s(lambda: cli.main(argv))
        traces = [os.path.join(logdir, f) for f in os.listdir(logdir)]
        if rc != 0 or len(traces) != 1:
            raise RuntimeError(f"render --profile: rc {rc}, traces {traces}")
        with open(traces[0]) as f:
            text = f.read()
        size = os.path.getsize(traces[0])
    if "refill_fwd_xyz" not in text:
        raise RuntimeError("the --profile trace names no forward kernel")
    for span in ("crt:render", "crt:kernel:megakernel_fwd_xyz"):
        if f'"{span}"' not in text:
            raise RuntimeError(f"the --profile trace holds no {span} span")
    print(f"render --profile ({side}x{side}, spp 1): {cli_s:.2f} s, one "
          f"trace of {size} bytes that names the forward's XYZ build and "
          f"holds the spans crt:render and crt:kernel:megakernel_fwd_xyz")
    small = presets.cornell_box(CHECKED_SIDE, CHECKED_SIDE)
    sscene, _ = scene_from_dict(small, device=dev)

    def eager(s):
        return xla_tracer.render_sample(s, CHECKED_SIDE, CHECKED_SIDE, 1, 2,
                                        use_remat=False)

    checked_s, img = _host_s(lambda: debug.checked(eager)(sscene))
    if not torch.equal(img, eager(sscene)):
        raise RuntimeError("debug.checked changed the render")
    bad = sscene.spectra.clone()
    bad[0, 0] = float("nan")
    try:
        debug.checked(eager)(dataclasses.replace(sscene, spectra=bad))
    except debug.CheckError as e:
        caught = str(e)
    else:
        raise RuntimeError("debug.checked missed a NaN in the spectra")
    print(f"debug.checked: a clean {CHECKED_SIDE}x{CHECKED_SIDE} eager "
          f"render passes ({checked_s:.2f} s); a NaN in spectra[0, 0] "
          f"raises ({caught})")


def _vis_loss(scene, static, backward, vis_grads=VIS_SCREEN,
              stratified=True):
    """Phase 7's headline loss with the film coordinates of render_sample
    (vis_grads, stratified) -> (loss, accum (H, W, 3)); backward None
    renders through the eager tracer."""
    accum = torch.zeros((HEIGHT, WIDTH, 3), device=scene.device)
    for smp in range(1, SPP + 1):
        if backward is None:
            img = xla_tracer.render_sample(scene, WIDTH, HEIGHT, smp,
                                           MAX_DEPTH, RR_START,
                                           vis_grads=vis_grads,
                                           stratified=stratified)
        else:
            img = kt.render_sample(scene, WIDTH, HEIGHT, smp, MAX_DEPTH,
                                   RR_START, static, backward,
                                   vis_grads=vis_grads,
                                   stratified=stratified)
        accum = accum + img
    return torch.mean((accum / float(SPP)) ** 2), accum


def _vis_vg(scene, static, backward):
    """value_and_grad of _vis_loss by (spectra, data1): (loss, accum,
    d spectra, d data1)."""
    sp, d1, s = _train_leaves(scene)
    loss, accum = _vis_loss(s, static, backward)
    loss.backward()
    return loss.item(), accum.detach(), sp.grad, d1.grad


def _screen_warp_kernels(scene, static):
    """Phase 24: the screen warp around kernels 1 and 3, or the taped
    forward and kernel 4, at the headline workload. Returns the launch
    counts of the two value_and_grads."""
    with torch.no_grad():
        plain = _vis_loss(scene, static, "none", vis_grads=False,
                          stratified=False)[1]
    runs, launches = {}, {}
    for bw, want in (("pallas", _only(forward=SPP, backward=SPP)),
                     ("pallas_taped", _only(forward_taped=SPP,
                                            backward_tape=SPP))):
        _reset_counters()
        secs, peak, out = _peak_gb(lambda: _vis_vg(scene, static, bw))
        counts = _counters()
        if counts != want:
            raise RuntimeError(f"screen-warp value_and_grad ({bw}) launched "
                               f"{counts}, expected {want}")
        launches[bw] = counts
        loss, accum, g_sp, g_d1 = out
        for nm, g in (("spectra", g_sp), ("data1", g_d1)):
            if not torch.isfinite(g).all():
                raise RuntimeError(f"screen-warp {bw} {nm} gradient not "
                                   f"finite")
        if not torch.equal(accum, plain):
            raise RuntimeError(f"the screen warp ({bw}) changed the image")
        runs[bw] = (loss, g_sp, g_d1)
        print(f"screen warp value_and_grad ({bw}, {WIDTH}x{HEIGHT}, spp "
              f"{SPP}, depth {MAX_DEPTH}): loss {loss:.6e}, launches "
              f"{ {k: v for k, v in counts.items() if v} }, {secs:.3f} s "
              f"(first call), peak {peak:.3f} GB; image bit-equal to the "
              f"stratified=False render")
    errs = [((t - r).abs().max() / r.abs().max()).item()
            for t, r in zip(runs["pallas_taped"][1:], runs["pallas"][1:])]
    same = [bool(torch.equal(t, r)) for t, r in
            zip(runs["pallas_taped"][1:], runs["pallas"][1:])]
    print(f"screen warp, tape-fed vs retrace gradients (spectra, data1): "
          f"worst err {errs} of the largest entry, bit-equal {same}")
    if max(errs) > 1e-3:
        raise RuntimeError("screen-warp gradients of the two backward "
                           "kernels differ")
    eager_s, eager_peak, (loss_e, accum_e, *grads_e) = _peak_gb(
        lambda: _vis_vg(scene, None, None))
    report = []
    for nm, g, w in zip(("spectra", "data1"), runs["pallas"][1:], grads_e):
        rel_l2 = ((g - w).norm() / w.norm()).item()
        report.append(f"{nm} rel L2 {rel_l2:.3g}")
        if not rel_l2 <= ORACLE_L2:
            raise RuntimeError(f"screen-warp {nm} gradient off the eager "
                               f"screen warp's by {rel_l2} (L2)")
    frac, rel_mean = _image_agreement(accum_e, plain)
    print(f"eager screen warp value_and_grad: {eager_s:.3f} s, peak "
          f"{eager_peak:.3f} GB, image {frac:.6f} of pixels within 2e-4 of "
          f"the kernel path's; retrace gradients vs eager: "
          + "; ".join(report))
    if frac < 0.99 or rel_mean > 1e-3:
        raise RuntimeError(f"eager screen-warp image off the kernel path's: "
                           f"{frac}, {rel_mean}")
    turns = []
    for vis in (True, False, False, True):
        if vis:
            turns.append(("vis", _host_s(lambda: _vis_vg(scene, static,
                                                         "pallas"))[0]))
        else:
            turns.append(("headline", _host_s(lambda: _vg(
                _train_leaves(scene)[2], static))[0]))
    print("step in turns (host ms; vis = the screen warp, headline = phase "
          "7's): " + ", ".join(f"{k} {t * 1e3:.1f}" for k, t in turns))
    # the warp's own cost on one sample's film coordinates: its forward
    # (the graph kept, as in a step) and the auxiliary closest hits alone
    px, py = kt.tile_coords(WIDTH, HEIGHT, 0, scene.device)
    gen = torch.Generator(device=scene.device).manual_seed(24)
    st = torch.rand((2, px.shape[0]), generator=gen, device=scene.device)
    leaves = _train_leaves(scene)[2]
    warp_ms = _events_ms(lambda: warp.screen_warp(leaves, WIDTH, HEIGHT,
                                                  st[0], st[1]), 3)
    offs = warp.ring_offsets(8, scene.device) * torch.tensor(
        [1.5 / WIDTH, 1.5 / HEIGHT], device=scene.device)
    a_k = st.T[:, None, :] + offs
    frame = cam_ops.film_frame(scene.camera.eye, scene.camera.lookat,
                               scene.camera.up, scene.camera.fov, WIDTH,
                               HEIGHT)
    o_k, d_k = cam_ops.film_ray(scene.camera.eye, *frame, a_k[..., 0],
                                a_k[..., 1])
    ex_k = torch.full(a_k.shape[:-1], -1, dtype=torch.int64,
                      device=scene.device)
    aux_ms = _events_ms(lambda: warp._aux_hits(o_k, d_k, ex_k,
                                               scene.primitives), 3)
    print(f"screen warp forward, one sample ({WIDTH}x{HEIGHT}, K 8): "
          f"{warp_ms:.2f} ms of device time, of which the auxiliary "
          f"closest hits ({a_k.shape[0] * 8} rays x "
          f"{scene.primitives.category.shape[0]} primitives) {aux_ms:.2f}")
    for label, fn in (("screen warp", lambda: _vis_vg(scene, static,
                                                      "pallas")),
                      ("headline", lambda: _vg(_train_leaves(scene)[2],
                                               static))):
        wall, dev_ms, idle, n_k, top = _profile(fn)
        print(f"profile of one value_and_grad ({label}): wall {wall:.1f} "
              f"ms, device {dev_ms:.1f} ms, idle share {idle:.3f}, {n_k} "
              f"kernel launches; top {top}")
    return launches


def _occ_weights():
    """tests/test_visibility_grads.py's weights: the occluder's
    silhouette rows and the floor's shadow rows of a ramped image."""
    side = OCC_SIDE
    rng = np.random.default_rng(5)
    ramp = (0.25 + np.arange(side) / side)[None, :, None]
    base = (ramp * rng.uniform(0.7, 1.3, (side, side, 3))).astype(np.float32)
    sil = np.zeros_like(base)
    sil[7:18] = base[7:18]
    sha = np.zeros_like(base)
    sha[25:32] = base[25:32]
    return sil, sha


def _shifted(scene, dx):
    """The scene with the occluder moved by dx along x."""
    bump = torch.zeros_like(scene.primitives.data1)
    bump[OCC_ROW, 0] = 1.0
    return dataclasses.replace(scene, primitives=dataclasses.replace(
        scene.primitives, data1=scene.primitives.data1 + bump * dx))


def _occ_batched(scene, static, samples, vis, eager):
    """Mean image (S, S, 3) of samples 1..samples, OCC_CHUNK samples to a
    call of render_pixels (one sample index per ray, whole films one
    after another): the eager tracer with the vis domains, or the kernel
    path with the screen warp (vis = VIS_SCREEN) or unstratified."""
    side = OCC_SIDE
    px, py = kt.tile_coords(side, side, 0, scene.device)
    acc = torch.zeros((side * side, 3), device=scene.device)
    for a in range(1, samples + 1, OCC_CHUNK):
        n = min(OCC_CHUNK, samples + 1 - a)
        smp = torch.arange(a, a + n, device=scene.device).repeat_interleave(
            side * side)
        if eager:
            xyz = xla_tracer.render_pixels(
                scene, side, side, px.repeat(n), py.repeat(n), smp, 1,
                RR_START, use_remat=False, vis_grads=vis)
        else:
            xyz = kt.render_pixels(scene, side, side, px.repeat(n),
                                   py.repeat(n), smp, 1, RR_START, static,
                                   vis_grads=vis, stratified=False)
        acc = acc + xyz.reshape(n, side * side, 3).sum(dim=0)
    return acc.reshape(side, side, 3) / float(samples)


def _d_dx(scene, weight, render):
    """d/d(dx) of sum(render(shifted scene) * weight) at dx = 0."""
    dx = torch.zeros((), device=scene.device, requires_grad=True)
    (render(_shifted(scene, dx)) * weight).sum().backward()
    return float(dx.grad)


def _boundary_terms(dev):
    """Phase 25: the JAX package's boundary-term checks
    (tests/test_visibility_grads.py) at its own sizes, on the card."""
    t0 = time.perf_counter()
    scene, _ = scene_from_dict(presets.occluder_scene(OCC_SIDE, OCC_SIDE),
                               device=dev)
    static = mk.SceneStatic.from_scene(scene)
    sil, sha = (torch.from_numpy(w).to(dev) for w in _occ_weights())
    with torch.no_grad():
        plus, minus = (_occ_batched(_shifted(scene, e), static, OCC_FD_SPP,
                                    (), False)
                       for e in (OCC_EPS, -OCC_EPS))
    fd_sil, fd_sha = (float(((plus - minus) * w).sum()) / (2 * OCC_EPS)
                      for w in (sil, sha))
    ad_screen = _d_dx(scene, sil, lambda s: _occ_batched(
        s, static, OCC_AD_SPP, VIS_SCREEN, False))
    ad_sil_interior = _d_dx(scene, sil, lambda s: _occ_batched(
        s, static, OCC_INTERIOR_SPP, ("light",), True))
    print(f"boundary terms (occluder_scene {OCC_SIDE}x{OCC_SIDE}, depth 1, "
          f"eps {OCC_EPS}): silhouette FD {fd_sil:.5g} (spp {OCC_FD_SPP}), "
          f"screen-warp AD on the kernel path {ad_screen:.5g} (spp "
          f"{OCC_AD_SPP}, ratio {ad_screen / fd_sil:.4f}), interior AD "
          f"(light domain only) {ad_sil_interior:.5g} (spp "
          f"{OCC_INTERIOR_SPP}, {abs(ad_sil_interior / fd_sil):.4f} of FD)")
    if not (abs(fd_sil) > 1.0 and abs(ad_sil_interior) <= 0.10 * abs(fd_sil)
            and abs(ad_screen - fd_sil) <= 0.25 * abs(fd_sil)):
        raise RuntimeError(f"screen silhouette: AD {ad_screen}, interior "
                           f"{ad_sil_interior}, FD {fd_sil}")
    ad_shadow = _d_dx(scene, sha, lambda s: _occ_batched(
        s, static, OCC_AD_SPP, ("light", "hemi"), True))
    ad_sha_interior = _d_dx(scene, sha, lambda s: _occ_batched(
        s, static, OCC_INTERIOR_SPP, VIS_SCREEN, False))
    ratio = ad_shadow / fd_sha
    print(f"shadow: FD {fd_sha:.5g}, light+hemi AD on the eager path "
          f"{ad_shadow:.5g} (spp {OCC_AD_SPP}, ratio {ratio:.4f}), interior "
          f"AD (screen warp only, kernel path) {ad_sha_interior:.5g} (spp "
          f"{OCC_INTERIOR_SPP}, {abs(ad_sha_interior / fd_sha):.4f} of FD)")
    if not (abs(fd_sha) > 2.0 and abs(ad_sha_interior) <= 0.05 * abs(fd_sha)
            and 0.40 <= ratio <= 1.10):
        raise RuntimeError(f"shadow: AD {ad_shadow}, interior "
                           f"{ad_sha_interior}, FD {fd_sha}")
    steps, lr, spp, dx0 = OCC_RECOVERY
    with torch.no_grad():
        target = _occ_batched(scene, static, spp, VIS_SCREEN, False)
    dx = torch.tensor(dx0, device=dev, requires_grad=True)
    adam = torch.optim.Adam([dx], lr=lr)
    rec_s = time.perf_counter()
    for _ in range(steps):
        adam.zero_grad()
        loss = torch.mean((_occ_batched(_shifted(scene, dx), static, spp,
                                        VIS_SCREEN, False) - target) ** 2
                          ) * 1e3
        loss.backward()
        adam.step()
    rec_s = time.perf_counter() - rec_s
    print(f"silhouette recovery on the kernel path: {steps} Adam steps (lr "
          f"{lr}, spp {spp}) in {rec_s:.2f} s, dx {dx0} -> {dx.item():.5f}")
    if not abs(dx.item()) < dx0 / 3:
        raise RuntimeError(f"the occluder did not recover: dx {dx.item()}")
    print(f"phase 25 (boundary terms): {time.perf_counter() - t0:.1f} s")


def _light_hemi_full(scene):
    """Phase 25's last check: the light and hemisphere warps on the eager
    tracer at Cornell's full width, one sample, in row bands."""
    sp, d1, s = _train_leaves(scene)
    rows = HEIGHT // LIGHT_HEMI_BANDS

    def run():
        bands = []
        for y0 in range(0, HEIGHT, rows):
            px, py = kt.tile_coords(WIDTH, rows, y0, scene.device)
            xyz = xla_tracer.render_pixels(s, WIDTH, HEIGHT, px, py, 1,
                                           LIGHT_HEMI_DEPTH, RR_START,
                                           vis_grads=("light", "hemi"))
            (xyz ** 2).sum().backward()
            bands.append(xyz.detach())
        return torch.cat(bands)

    _reset_counters()
    secs, peak, img = _peak_gb(run)
    if _counters() != _only():
        raise RuntimeError(f"the eager light/hemi render launched "
                           f"{_counters()}")
    with torch.no_grad():
        px, py = kt.tile_coords(WIDTH, HEIGHT, 0, scene.device)
        want = xla_tracer.render_pixels(scene, WIDTH, HEIGHT, px, py, 1,
                                        LIGHT_HEMI_DEPTH, RR_START,
                                        stratified=False)
    if not torch.equal(img, want):
        raise RuntimeError("the light/hemi warps changed the image")
    for nm, g in (("spectra", sp.grad), ("data1", d1.grad)):
        if g is None or not torch.isfinite(g).all():
            raise RuntimeError(f"light/hemi {nm} gradient missing or not "
                               f"finite")
    print(f"light+hemi warps (eager, Cornell {WIDTH}x{HEIGHT}, sample 1, "
          f"depth {LIGHT_HEMI_DEPTH}, {LIGHT_HEMI_BANDS} row bands): "
          f"render and backward {secs:.3f} s, peak {peak:.3f} GB; image "
          f"bit-equal to the stratified=False render, gradients finite "
          f"(|d data1| {float(d1.grad.abs().sum()):.6g})")


def _world_of_one(scene, single_accum):
    """Phase 26: render_accumulate_sharded in a world of one on NCCL at
    phase 4's workload, bit-equal to phase 4's image; the host ms of each,
    in turns."""
    with tempfile.TemporaryDirectory() as tmp:
        distributed.initialize(f"file://{tmp}/store", 1, 0)
        try:
            mesh = mesh_mod.make_mesh()
            if tuple(mesh.shape) != (1, 1) or dist.get_backend() != "nccl":
                raise RuntimeError(f"world of one: mesh {mesh}, backend "
                                   f"{dist.get_backend()}")

            def sharded():
                return rsh.render_accumulate_sharded(
                    scene, WIDTH, HEIGHT, SPP, mesh, MAX_DEPTH,
                    kernel="pallas")

            def single():
                return kt.render_accumulate(scene, WIDTH, HEIGHT, SPP,
                                            MAX_DEPTH)

            _reset_counters()
            first_s, got = _host_s(sharded)
            counts = _counters()
            if counts != _only(forward=SPP, forward_xyz=SPP):
                raise RuntimeError(f"world of one launched {counts}, "
                                   f"expected {SPP} XYZ forwards")
            if not torch.equal(got, single_accum):
                raise RuntimeError("the world-of-one render differs from "
                                   "phase 4's")
            turns = [(nm, _host_s(fn)[0] * 1e3) for nm, fn in (
                ("single", single), ("sharded", sharded),
                ("sharded", sharded), ("single", single))]
        finally:
            distributed.shutdown()
    print(f"phase 26 (world of one, nccl, mesh (1, 1)): Cornell {WIDTH}x"
          f"{HEIGHT} spp {SPP} depth {MAX_DEPTH} bit-equal to phase 4's "
          f"render; launches {_launched(counts)}; first call "
          f"{first_s * 1e3:.1f} ms; "
          f"host ms in turns {[(nm, round(t, 3)) for nm, t in turns]}")


def _delta(before):
    after = _counters()
    return {k: after[k] - before[k] for k in after}


def _launched(counts):
    """The counts that are not 0, for printing."""
    return {k: v for k, v in counts.items() if v}


def _sharded_rank(rank, store, out):
    """Phase 27, one of SHARD_WORLD ranks on the one card (gloo over CUDA
    tensors): builds the kernels, renders and steps every layout of
    SHARD_LAYOUTS and saves its results to out/rank<rank>.pt."""
    distributed.initialize(f"file://{store}", SHARD_WORLD, rank, "gloo",
                           local_rank=0)
    try:
        dev = torch.device("cuda", 0)
        build_s, _ = _host_s(_build.build_all)
        scene, _ = scene_from_dict(presets.cornell_box(WIDTH, HEIGHT),
                                   device=dev)
        mscene, _ = scene_from_dict(
            presets.mesh_scene(WIDTH, HEIGHT, MESH_SUBDIVISIONS), device=dev)
        meshes = {shape: mesh_mod.make_mesh(shape) for shape in SHARD_LAYOUTS}
        rsh.allreduce_log = []
        res = {"build_s": build_s, "steps": []}
        _reset_counters()
        for shape, mesh in meshes.items():
            before = _counters()
            secs, img = _host_s(lambda: rsh.render_accumulate_sharded(
                scene, WIDTH, HEIGHT, SPP, mesh, MAX_DEPTH))
            res[("render", shape)] = (img.cpu(), secs, _delta(before))
        before = _counters()
        secs, img = _host_s(lambda: rsh.render_accumulate_sharded(
            mscene, WIDTH, HEIGHT, SPP, meshes[SHARD_LAYOUTS[0]],
            MESH_DEPTH))
        res["mesh"] = (img.cpu(), secs, _delta(before))
        target = torch.zeros((HEIGHT, WIDTH, 3), device=dev)
        for backward in ("pallas", "pallas_taped"):
            for shape, runs in zip(SHARD_LAYOUTS, (2, 1)):
                loss_fn = opt.make_loss_fn(scene, WIDTH, HEIGHT, SPP,
                                           MAX_DEPTH, mesh=meshes[shape],
                                           backward=backward)
                for run in range(runs):
                    logged = len(rsh.allreduce_log)
                    before = _counters()
                    torch.cuda.reset_peak_memory_stats()
                    secs, (loss, grads) = _host_s(
                        lambda: _loss_and_grads(loss_fn, scene, target))
                    res["steps"].append({
                        "backward": backward, "shape": shape, "run": run,
                        "loss": loss, "grads": [g.cpu() for g in grads],
                        "ms": secs * 1e3,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "launches": _delta(before),
                        "allreduce": rsh.allreduce_log[logged:]})
        res["launches"] = _counters()
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        rsh.allreduce_log = None
        distributed.shutdown()


def _loss_and_grads(loss_fn, scene, target):
    """value_and_grad of loss_fn by (spectra, data1) at sample 1."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in
              opt.split_scene(scene, SHARD_TRAINABLE)[0].items()}
    loss = loss_fn(params, target, 1)
    loss.backward()
    return loss.item(), [params[k].grad for k in SHARD_TRAINABLE]


def _rel_l2(g, w):
    return ((g - w).norm() / w.norm()).item()


def _two_ranks(scene, static, single_accum, mesh_accum):
    """Phase 27: SHARD_WORLD spawned ranks share the card (gloo over CUDA
    tensors; NCCL refuses two ranks on one device): their renders
    bit-equal to the single-process ones, their gradients within
    SHARD_GRAD_L2 of the single-process value_and_grad. Returns each
    kernel's launches per rank."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_sharded_rank, args=(os.path.join(tmp, "store"),
                                                tmp),
                           nprocs=SHARD_WORLD, join=True,
                           start_method="spawn")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(SHARD_WORLD)]
    spawn_s = time.perf_counter() - t0
    s = [kt.render_sample_planar(scene, WIDTH, HEIGHT, smp, MAX_DEPTH,
                                 RR_START, static).cpu()
         for smp in range(1, SPP + 1)]
    # (1, 2): each rank sums its two samples, the all-reduce the halves
    want = {(2, 1): single_accum.cpu(),
            (1, 2): ((s[0] + s[1]) + (s[2] + s[3])).permute(1, 2, 0)}
    for r, res in enumerate(ranks):
        print(f"rank {r}: kernels built in {res['build_s']:.1f} s")
        for shape in SHARD_LAYOUTS:
            img, secs, counts = res[("render", shape)]
            local = SPP // shape[1]
            if counts != _only(forward=local, forward_xyz=local):
                raise RuntimeError(f"rank {r} render {shape} launched "
                                   f"{counts}, expected {local} XYZ "
                                   f"forwards")
            if not torch.equal(img, want[shape]):
                raise RuntimeError(f"rank {r}: the {shape} render differs "
                                   f"from the single-process one")
            print(f"rank {r} render {shape}: bit-equal, {secs * 1e3:.1f} "
                  f"ms, launches {_launched(counts)}")
        img, secs, counts = res["mesh"]
        if counts != _only(forward_mesh=SPP):
            raise RuntimeError(f"rank {r} mesh render launched {counts}")
        if not torch.equal(img, mesh_accum.cpu()):
            raise RuntimeError(f"rank {r}: the mesh render differs from "
                               f"phase 11's")
        print(f"rank {r} mesh render {SHARD_LAYOUTS[0]}: bit-equal to phase "
              f"11's, {secs * 1e3:.1f} ms, launches {_launched(counts)}")
    target = torch.zeros((HEIGHT, WIDTH, 3), device=scene.device)
    for backward in ("pallas", "pallas_taped"):
        loss_fn = opt.make_loss_fn(scene, WIDTH, HEIGHT, SPP, MAX_DEPTH,
                                   backward=backward)
        loss1, grads1 = _loss_and_grads(loss_fn, scene, target)
        fwd, bwd = (("forward", "backward") if backward == "pallas"
                    else ("forward_taped", "backward_tape"))
        for r, res in enumerate(ranks):
            steps = {(st["shape"], st["run"]): st for st in res["steps"]
                     if st["backward"] == backward}
            for (shape, run), st in steps.items():
                local = SPP // shape[1]
                if st["launches"] != _only(**{fwd: local, bwd: local}):
                    raise RuntimeError(f"rank {r} {backward} step {shape} "
                                       f"launched {st['launches']}")
                rel_loss = abs(st["loss"] - loss1) / abs(loss1)
                errs = [_rel_l2(g, w.cpu()) for g, w in zip(st["grads"],
                                                            grads1)]
                if (rel_loss > 1e-6 or max(errs) > SHARD_GRAD_L2
                        or not all(torch.isfinite(g).all()
                                   for g in st["grads"])):
                    raise RuntimeError(f"rank {r} {backward} {shape}: loss "
                                       f"rel {rel_loss}, gradients rel L2 "
                                       f"{errs}")
                ar = st["allreduce"]
                print(f"rank {r} {backward} step {shape} run {run}: "
                      f"{st['ms']:.1f} ms, peak {st['peak_gb']:.3f} GB, "
                      f"launches {_launched(st['launches'])}, loss rel "
                      f"{rel_loss:.3g}, "
                      f"gradients rel L2 {[f'{e:.3g}' for e in errs]}; "
                      f"all-reduces "
                      f"{[(a['what'], a['bytes'], round(a['ms'], 3)) for a in ar]}")
            cross = [_rel_l2(g, w) for g, w in zip(
                steps[(SHARD_LAYOUTS[0], 0)]["grads"],
                steps[(SHARD_LAYOUTS[1], 0)]["grads"])]
            again = all(torch.equal(g, w) for g, w in zip(
                steps[(SHARD_LAYOUTS[0], 0)]["grads"],
                steps[(SHARD_LAYOUTS[0], 1)]["grads"]))
            if max(cross) > SHARD_GRAD_L2 or not again:
                raise RuntimeError(f"rank {r} {backward}: layouts rel L2 "
                                   f"{cross}, bit-equal across runs {again}")
            print(f"rank {r} {backward}: {SHARD_LAYOUTS[0]} vs "
                  f"{SHARD_LAYOUTS[1]} rel L2 {[f'{e:.3g}' for e in cross]}, "
                  f"bit-equal across two runs")
    print(f"phase 27 ({SHARD_WORLD} ranks on one card, gloo): "
          f"{spawn_s:.1f} s, kernel builds included")
    return [res["launches"] for res in ranks]


def _oracle_pixels(dev):
    """Phase 28: the scalar oracle (tracer/reference_cpu.py) against the
    kernel path's render of the same pixels on the card."""
    side, depth, sample = ORACLE_SCENE
    scene, _ = scene_from_dict(presets.cornell_box(side, side), device=dev)
    secs, want = _host_s(lambda: oracle.render_sample(scene, side, side,
                                                      sample, depth))
    got = kt.render_sample(scene, side, side, sample, depth).cpu().numpy()
    if got.shape != want.shape or not np.isfinite(got).all():
        raise RuntimeError("the kernel path's oracle pixels are not finite")
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-2)
    close = (rel < 1e-3).all(axis=-1)
    energy = np.abs(got - want)[~close].sum() / (np.abs(want).sum() + 1e-12)
    print(f"phase 28 (scalar oracle, Cornell {side}x{side}, depth {depth}, "
          f"sample {sample}): {close.mean():.4f} of pixels within rel 1e-3, "
          f"divergent energy {energy:.3g}; oracle {secs:.1f} s on the host")
    if close.mean() < 0.995 or energy > 1e-3:
        raise RuntimeError("the kernel path disagrees with the oracle")


def _camera(scene, eye, lookat, up, fov):
    """The scene with another camera, its tensors on the scene's device."""
    f32 = dict(dtype=torch.float32, device=scene.device)
    return dataclasses.replace(scene, camera=dataclasses.replace(
        scene.camera, eye=torch.tensor(eye, **f32),
        lookat=torch.tensor(lookat, **f32), up=torch.tensor(up, **f32),
        fov=torch.tensor(fov, **f32)))


def _kernel_device_ms(fn, reps, *keys, passes=3):
    """Mean device time a call of fn() of the CUDA kernels whose names hold
    the keys (each launched once a call): reps calls under torch.profiler
    after one warm-up, each key's kernel timed as the mean over the
    launches the profiler recorded. It may drop some, or every launch of
    a kernel in a pass: then the pass is repeated, at most passes in all
    -> (total ms, {key: ms}, {key: launches recorded})."""
    fn()
    torch.cuda.synchronize()
    us = {key: [] for key in keys}
    for _ in range(passes):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for key in keys:
            us[key] += [e.time_range.elapsed_us() for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and key in e.name]
        if all(us.values()):
            break
    missing = [key for key in keys if not us[key]]
    if missing:
        raise RuntimeError(f"the profiler recorded no launch of {missing} "
                           f"in {passes} passes")
    by_key = {key: sum(v) / len(v) / 1e3 for key, v in us.items()}
    return (sum(by_key.values()), by_key,
            {key: len(v) for key, v in us.items()})


def _setup_kernels(scene, d_spect, setup_render, setup_step):
    """Phase 29: the setup's kernels at phase 4's shape; returns their
    kernels-line entries."""
    t0 = time.perf_counter()
    px, py = kt.tile_coords(WIDTH, HEIGHT, 0, scene.device)
    rays = px.shape[0]
    cameras = {"cornell": scene.camera, **{
        k: _camera(scene, *v).camera for k, v in SETUP_CAMERAS.items()}}
    for cam_name, cam in cameras.items():
        for sample in (1, 2**32 - 3):
            got = setup_k.ray_setup(cam, WIDTH, HEIGHT, px, py, sample)
            want = setup_k.ray_setup_reference(cam, WIDTH, HEIGHT, px, py,
                                               sample)
            torch.cuda.synchronize()
            for nm, g, w in zip(("o", "d", "hero", "seed"), got, want):
                if g.shape != w.shape or g.dtype != w.dtype or not (
                        torch.equal(g, w)):
                    raise RuntimeError(
                        f"ray-setup kernel's {nm} differs from its plain "
                        f"version at the {cam_name} camera, sample {sample}")
    cam = scene.camera
    operands = (cam.eye, cam.lookat, cam.up, cam.fov)
    o, d, hero, seed = setup_k.ray_setup(cam, WIDTH, HEIGHT, px, py, 1)
    a_ms = _events_ms(lambda: setup_k.ray_setup_launch(
        *operands, WIDTH, HEIGHT, px, py, 1), 20)
    a_wrapper = _events_ms(lambda: setup_k.ray_setup(cam, WIDTH, HEIGHT, px,
                                                     py, 1), 20)
    a_device, _, a_seen = _kernel_device_ms(lambda: setup_k.ray_setup(
        cam, WIDTH, HEIGHT, px, py, 1), 20, "ray_setup")
    a_plain = _events_ms(lambda: setup_k.ray_setup_reference(
        cam, WIDTH, HEIGHT, px, py, 1), 5)
    a_bound = _bound(_nbytes(px, py, o, d, hero, seed, *operands),
                     rays * SETUP_F32_OPS, rays * SETUP_INT_OPS)
    print(f"ray setup ({rays} rays): bit-equal to its plain version (o, d, "
          f"hero, seed) at the {', '.join(cameras)} cameras, samples 1 and "
          f"2^32 - 3; kernel {a_ms:.4f} ms ({a_wrapper:.4f} through its "
          f"wrapper, which issues no torch op for the camera frame; device "
          f"time under the profiler {a_device:.4f}, the mean of "
          f"{a_seen['ray_setup']} launches), plain {a_plain:.3f} "
          f"ms, bound {a_bound[0]:.4f} ms ({a_bound[1]})")
    for line in _ptxas("setup"):
        print(f"ptxas[setup]: {line}")

    spect_t = spec.expand_hero_table(scene.spectra).contiguous()
    cie_t = spec.cie_window_exp(scene.cie).contiguous()
    both_t = torch.cat([spect_t, cie_t])
    got_s, got_c = setup_k.hero_gather_tables((spect_t, cie_t), hero)
    for nm, g, table in (("spectra", got_s, spect_t), ("CIE", got_c, cie_t)):
        if not torch.equal(g, table[:, hero]):
            raise RuntimeError(f"hero gather of the {nm} table differs from "
                               f"table[:, hero]")
    f_ms = _events_ms(lambda: setup_k.hero_gather_tables((spect_t, cie_t),
                                                         hero), 20)
    f_spect_ms = _events_ms(lambda: setup_k.hero_gather(spect_t, hero), 20)
    f_plain = _events_ms(lambda: (
        setup_k.hero_gather_reference(spect_t, hero),
        setup_k.hero_gather_reference(cie_t, hero)), 20)
    f_select = _events_ms(lambda: torch.index_select(both_t, 1, hero), 20)
    f_device = _kernel_device_ms(lambda: setup_k.hero_gather_tables(
        (spect_t, cie_t), hero), 20, "hero_gather")[0]
    f_bound = _bound(_nbytes(spect_t, cie_t, hero, got_s, got_c), 0)
    print(f"hero gather ({spect_t.shape[0]} + {cie_t.shape[0]} x {rays}, one "
          f"launch): bit-equal to table[:, hero] (spectra and CIE); kernel "
          f"{f_ms:.4f} ms (device time under the profiler {f_device:.4f}; "
          f"the spectra alone {f_spect_ms:.4f}), table[:, "
          f"hero] of both {f_plain:.4f} ms, index_select of the "
          f"concatenated table {f_select:.4f} ms, bound {f_bound[0]:.4f} ms "
          f"({f_bound[1]})")

    g = d_spect.contiguous()
    n_cols = spect_t.shape[1]
    first = setup_k.hero_column_sums(g, hero, n_cols)
    second = setup_k.hero_column_sums(g, hero, n_cols)
    plain = setup_k.hero_column_sums_reference(g, hero, n_cols)
    exact = torch.zeros(first.shape, dtype=torch.float64, device=g.device)
    exact.index_add_(1, hero, g.double())
    torch.cuda.synchronize()
    rel_l2 = ((first.double() - exact).norm() / exact.norm()).item()
    same_plain = torch.equal(first, plain)
    b_abs_err = (first - plain).abs().max().item()
    print(f"column sums ({g.shape[0]} x {rays} -> {tuple(first.shape)}): "
          f"relative L2 {rel_l2:.3g} from a float64 column sum, bit-equal "
          f"to the plain version {same_plain} (worst abs {b_abs_err:.3g}), "
          f"two launches bit-equal {torch.equal(first, second)}")
    if rel_l2 > 1e-6 or not same_plain or not torch.equal(first, second):
        raise RuntimeError("column-sum kernel disagrees with the float64 "
                           "sum, its plain version or itself")
    b_ms = _events_ms(lambda: setup_k.hero_column_sums(g, hero, n_cols), 20)
    b_device, b_passes, _ = _kernel_device_ms(
        lambda: setup_k.hero_column_sums(g, hero, n_cols), 20, "hero_sort",
        "hero_sums", "hero_reduce")
    b_plain = _events_ms(lambda: setup_k.hero_column_sums_reference(
        g, hero, n_cols), 5)
    zeros = torch.zeros(first.shape, device=g.device)
    b_put = _events_ms(lambda: torch.ops.aten.index_put_(
        zeros.clone(), [None, hero], g, True), 5)
    b_add = _events_ms(lambda: zeros.clone().index_add_(1, hero, g), 5)
    b_bound = _bound(_nbytes(g, hero, first), g.numel())
    print(f"column sums: kernel {b_ms:.4f} ms (device time under the "
          f"profiler {b_device:.4f}: sort, sums, reduce "
          f"{[round(v, 4) for v in b_passes.values()]}), bound "
          f"{b_bound[0]:.4f} ms ({b_bound[1]}): the device time is "
          f"{b_bound[0] / b_device:.3f} of the bound; plain {b_plain:.3f} "
          f"ms, index_put_(accumulate=True) "
          f"(the gather's autograd backward) {b_put:.4f} ms, index_add_ "
          f"{b_add:.4f} ms")
    print(f"phase 29 (the setup's kernels): {time.perf_counter() - t0:.1f} s")
    src = "computeraytracer_tpu_torch/kernels/csrc/setup.cu"
    launches = {nm: {"launches_render": setup_render[nm],
                     "launches_train": setup_step[nm]}
                for nm in setup_render}
    return [dict({
        "name": "ray_setup",
        "route": "cuda",
        "source": src,
        "replaces": "computeraytracer_tpu/tracer/pallas.py:708-712 (XLA)",
        "launches": setup_render["ray_setup"],
        "max_abs_err": 0.0,
        "ms": a_ms,
        "wrapper_ms": a_wrapper,
        "device_ms": a_device,
        "plain_ms": a_plain,
        "bound_ms": a_bound[0],
        "bound_by": a_bound[1],
        "library_ms": None,
        "rays": rays,
        "cameras": list(cameras),
    }, **launches["ray_setup"]), dict({
        "name": "hero_gather_fwd",
        "route": "cuda",
        "source": src,
        "replaces": "computeraytracer_tpu/tracer/pallas.py:726-731 "
                    "gather_hero_planar (XLA)",
        "launches": setup_render["hero_gather_fwd"],
        "max_abs_err": 0.0,
        "ms": f_ms,
        "device_ms": f_device,
        "ms_spectra_only": f_spect_ms,
        "plain_ms": f_plain,
        "bound_ms": f_bound[0],
        "bound_by": f_bound[1],
        "library_ms": f_select,
        "rows": spect_t.shape[0] + cie_t.shape[0],
        "rays": rays,
    }, **launches["hero_gather_fwd"]), dict({
        "name": "hero_gather_bwd",
        "route": "cuda",
        "source": src,
        "replaces": "computeraytracer_tpu/ops/spectrum.py:246 take_cols "
                    "VJP (XLA)",
        "launches": setup_step["hero_gather_bwd"],
        "max_abs_err": b_abs_err,
        "rel_l2_float64": rel_l2,
        "bit_equal_plain": same_plain,
        "ms": b_ms,
        "device_ms": b_device,
        "device_ms_passes": b_passes,
        "device_share_of_bound": b_bound[0] / b_device,
        "plain_ms": b_plain,
        "bound_ms": b_bound[0],
        "bound_by": b_bound[1],
        "library_ms": b_put,
        "index_add_ms": b_add,
        "rows": g.shape[0],
        "rays": rays,
    }, **launches["hero_gather_bwd"])]


def _camera_leaves(scene):
    """(spectra, data1, eye, lookat, up, fov) as fresh leaves that require
    grad, and the scene that holds them."""
    sp, d1, s = _train_leaves(scene)
    cam = [getattr(scene.camera, n).detach().clone().requires_grad_(True)
           for n in CAMERA_LEAVES]
    return (sp, d1, *cam), dataclasses.replace(
        s, camera=dataclasses.replace(scene.camera,
                                      **dict(zip(CAMERA_LEAVES, cam))))


def _camera_grads(scene, static, d_rays, step_grads, setup_render,
                  setup_step, smi):
    """Phase 30: the ray setup's backward kernel at phase 4's shape against
    its plain version and autograd, phase 7's value_and_grad also by the
    camera for both backwards, and the times; returns its kernels-line
    entry."""
    t0 = time.perf_counter()
    px, py = kt.tile_coords(WIDTH, HEIGHT, 0, scene.device)
    rays = px.shape[0]
    g_o, g_d = d_rays[:3].contiguous(), d_rays[3:].contiguous()
    cameras = {"cornell": scene.camera, **{
        k: _camera(scene, *v).camera for k, v in SETUP_CAMERAS.items()}}
    worst_sum = worst_leaf = worst_l2 = 0.0
    same_leaves, same_plain = [], []
    for cam_name, cam in cameras.items():
        leaves = [getattr(cam, n) for n in CAMERA_LEAVES]
        for sample in (1, 2**32 - 3):
            grads, sums = setup_k.ray_setup_bwd_launch(
                *leaves, WIDTH, HEIGHT, px, py, sample, g_o, g_d)
            again_grads, again = setup_k.ray_setup_bwd_launch(
                *leaves, WIDTH, HEIGHT, px, py, sample, g_o, g_d)
            terms = setup_k.ray_setup_bwd_terms(cam, WIDTH, HEIGHT, px, py,
                                                sample, g_o, g_d)
            plain = setup_k.ray_setup_bwd_sums_reference(terms)
            exact = terms.double().sum(dim=1)
            plain_grads = setup_k.film_frame_vjp(*leaves, WIDTH, HEIGHT,
                                                 plain)
            auto_leaves = [x.detach().clone().requires_grad_(True)
                           for x in leaves]
            o, d, _, _ = setup_k.ray_setup_reference(
                dataclasses.replace(cam, **dict(zip(CAMERA_LEAVES,
                                                    auto_leaves))),
                WIDTH, HEIGHT, px, py, sample)
            auto = torch.autograd.grad((o * g_o).sum() + (d * g_d).sum(),
                                       auto_leaves)
            del o, d, terms
            torch.cuda.synchronize()
            rel_l2 = ((sums.double() - exact).norm() / exact.norm()).item()
            errs = [((g - w).abs().max() / w.abs().max()).item()
                    for g, w in zip(grads, auto)]
            worst_sum = max(worst_sum, (sums - plain).abs().max().item())
            worst_l2 = max(worst_l2, rel_l2)
            worst_leaf = max(worst_leaf, *errs)
            same_leaves += [bool(torch.equal(g, w))
                            for g, w in zip(grads, auto)]
            same_plain += [bool(torch.equal(g, w))
                           for g, w in zip(grads, plain_grads)]
            finite = all(torch.isfinite(g).all() for g in grads)
            if not (torch.equal(sums, plain) and torch.equal(sums, again)
                    and all(torch.equal(a, b)
                            for a, b in zip(grads, again_grads))):
                raise RuntimeError(
                    f"the ray setup's backward sums differ from the plain "
                    f"version's or across launches at the {cam_name} "
                    f"camera, sample {sample}")
            if rel_l2 > 1e-6 or max(errs) > 1e-5 or not finite:
                raise RuntimeError(
                    f"the ray setup's backward at the {cam_name} camera, "
                    f"sample {sample}: relative L2 {rel_l2:.3g} from a "
                    f"float64 sum, leaves {errs} of their largest entry "
                    f"from autograd")
    print(f"ray setup backward ({rays} rays, phase 6's d_rays, the "
          f"{', '.join(cameras)} cameras, samples 1 and 2^32 - 3): the "
          f"twelve sums bit-equal to the plain version's and across two "
          f"launches, worst relative L2 {worst_l2:.3g} from a float64 sum; "
          f"camera gradients within {worst_leaf:.3g} of each leaf's largest "
          f"entry of autograd of ray_setup_reference, bit-equal on "
          f"{sum(same_leaves)} of {len(same_leaves)} leaves (to the plain "
          f"version's frame VJP: {sum(same_plain)} of {len(same_plain)})")

    cam = scene.camera
    leaves = [getattr(cam, n) for n in CAMERA_LEAVES]
    k_ms = _events_ms(lambda: setup_k.ray_setup_bwd_launch(
        *leaves, WIDTH, HEIGHT, px, py, 1, g_o, g_d), 20)
    k_device, k_passes, k_seen = _kernel_device_ms(
        lambda: setup_k.ray_setup_bwd_launch(*leaves, WIDTH, HEIGHT, px, py,
                                             1, g_o, g_d), 20,
        "ray_setup_bwd_kernel", "ray_setup_bwd_reduce")
    k_plain = _events_ms(lambda: setup_k.ray_setup_bwd_reference(
        cam, WIDTH, HEIGHT, px, py, 1, g_o, g_d), 5)
    auto_leaves = [x.detach().clone().requires_grad_(True) for x in leaves]

    def autograd_fwd_bwd():
        o, d, _, _ = setup_k.ray_setup_reference(
            dataclasses.replace(cam, **dict(zip(CAMERA_LEAVES, auto_leaves))),
            WIDTH, HEIGHT, px, py, 1)
        return torch.autograd.grad((o, d), auto_leaves, (g_o, g_d))

    a_fwd_bwd = _events_ms(autograd_fwd_bwd, 5)
    o, d, _, _ = setup_k.ray_setup_reference(
        dataclasses.replace(cam, **dict(zip(CAMERA_LEAVES, auto_leaves))),
        WIDTH, HEIGHT, px, py, 1)
    a_bwd = _events_ms(lambda: torch.autograd.grad(
        (o, d), auto_leaves, (g_o, g_d), retain_graph=True), 5)
    del o, d
    k_bound = _bound(_nbytes(px, py, g_o, g_d, *leaves) + 22 * 4,
                     rays * SETUP_BWD_F32_OPS, rays * SETUP_BWD_INT_OPS)
    print(f"ray setup backward: kernel {k_ms:.4f} ms (CUDA events; device "
          f"time under the profiler {k_device:.4f}: pass 1, pass 2 "
          f"{[round(v, 4) for v in k_passes.values()]}, the means of "
          f"{list(k_seen.values())} launches), bound {k_bound[0]:.4f} ms "
          f"({k_bound[1]}; the device time is {k_bound[0] / k_device:.3f} "
          f"of it); plain {k_plain:.3f} ms; torch autograd of "
          f"ray_setup_reference {a_bwd:.3f} ms (its forward and backward "
          f"{a_fwd_bwd:.3f}); {smi}")
    for line in _ptxas("setup"):
        if "ray_setup_bwd" in line or "Used" in line:
            print(f"ptxas[setup]: {line}")

    cam_grads, step_launches = {}, None
    for bw in ("pallas", "pallas_taped"):
        _reset_counters()
        _vg(_train_leaves(scene)[2], static, bw)
        base = (_counters(), _setup_counters())
        leaves6, cam_scene = _camera_leaves(scene)
        _reset_counters()
        loss = _vg(cam_scene, static, bw)
        counts, setup = _counters(), _setup_counters()
        want_setup = dict(base[1], ray_setup_bwd=SPP)
        if counts != base[0] or setup != want_setup:
            raise RuntimeError(f"{bw} value_and_grad with camera leaves "
                               f"launched {counts}, {setup}; expected "
                               f"{base[0]}, {want_setup}")
        step_launches = setup["ray_setup_bwd"]
        sp, d1, *cam_leaves = leaves6
        same = [bool(torch.equal(g, w))
                for g, w in zip((sp.grad, d1.grad), step_grads[bw])]
        grads = {n: x.grad for n, x in zip(CAMERA_LEAVES, cam_leaves)}
        if not all(same):
            raise RuntimeError(f"{bw}: with camera leaves the spectra and "
                               f"data1 gradients are not phase 7/10's bit "
                               f"for bit ({same})")
        if any(g is None or not torch.isfinite(g).all()
               for g in grads.values()) or not (
                   (grads["eye"] != 0).any() and (grads["fov"] != 0)):
            raise RuntimeError(f"{bw}: camera gradients missing, not "
                               f"finite or zero: {grads}")
        cam_grads[bw] = {n: g.tolist() for n, g in grads.items()}
        print(f"{bw} value_and_grad by spectra, data1 and the camera: loss "
              f"{loss:.6e}, launches {counts}, setup {setup}; spectra and "
              f"data1 gradients bit-equal to phase "
              f"{7 if bw == 'pallas' else 10}'s; camera gradients "
              f"{cam_grads[bw]}")
    turns = {}
    for bw in ("pallas", "pallas_taped"):
        runs = []
        for with_cam in (False, True, True, False):
            fn = ((lambda: _vg(_camera_leaves(scene)[1], static, bw))
                  if with_cam else
                  (lambda: _vg(_train_leaves(scene)[2], static, bw)))
            wall, dev_ms, idle, n_k, _ = _profile(fn)
            runs.append((with_cam, dev_ms, wall, idle, n_k))
        turns[bw] = {"without": [r[1] for r in runs if not r[0]],
                     "with": [r[1] for r in runs if r[0]],
                     "launches": [r[4] for r in runs]}
        print(f"{bw} step under the profiler, in turns (without, with, "
              f"with, without camera leaves): device ms "
              f"{[round(r[1], 3) for r in runs]}, wall ms "
              f"{[round(r[2], 1) for r in runs]}, idle "
              f"{[round(r[3], 3) for r in runs]}, launches "
              f"{[r[4] for r in runs]}; {smi}")
    print(f"phase 30 (camera gradients): {time.perf_counter() - t0:.1f} s")
    return {
        "name": "ray_setup_bwd",
        "route": "cuda",
        "source": "computeraytracer_tpu_torch/kernels/csrc/setup.cu",
        "replaces": "computeraytracer_tpu/tracer/pallas.py:709-711 "
                    "camera_rays_p, its AD (XLA)",
        "launches": step_launches,
        "launches_render": setup_render["ray_setup_bwd"],
        "launches_train": setup_step["ray_setup_bwd"],
        "max_abs_err": worst_sum,
        "max_leaf_err_autograd": worst_leaf,
        "rel_l2_float64": worst_l2,
        "ms": k_ms,
        "device_ms": k_device,
        "device_ms_passes": k_passes,
        "plain_ms": k_plain,
        "autograd_ms": a_bwd,
        "autograd_fwd_bwd_ms": a_fwd_bwd,
        "bound_ms": k_bound[0],
        "bound_by": k_bound[1],
        "library_ms": None,
        "rays": rays,
        "cameras": list(cameras),
        "step_device_ms": turns,
    }


FRAME_TURN = 20  # served frames a turn of phase 31


def _frame_graph_turns(dev):
    """Phase 31: FRAME_TURN served frames (``render``, phase 4's workload,
    a scene of its own) eagerly and through render_accumulate's frame
    graph, in turns (eager, graph, graph, eager), each frame synchronised
    as the benchmark's serve cell does: host ms a frame, the graph
    counters, the forward and setup launches of each turn (SPP of each a
    frame), and every graphed frame's accum, mean and sRGB bit-equal to
    the eager frame of the same samples. An eager frame runs with the
    frame graphs set aside, as a key's first call does."""
    import collections

    scene, _ = scene_from_dict(presets.cornell_box(WIDTH, HEIGHT), device=dev)
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP,
                       max_depth=MAX_DEPTH, kernel="pallas")

    def frame(graphed, k):
        if graphed:
            return render(scene, cfg, first_sample=1 + SPP * k)
        kept = kt._frame_graphs
        kt._frame_graphs = collections.OrderedDict()
        try:
            return render(scene, cfg, first_sample=1 + SPP * k)
        finally:
            kt._frame_graphs = kept

    for k in range(2):  # the key seen, then captured
        frame(True, k)
    torch.cuda.synchronize()
    counters = (kt.graph_captures, kt.graph_replays, kt.graph_eager)
    turns, images = [], {}
    for graphed in (False, True, True, False):
        _reset_counters()
        ms, outs = [], []
        for k in range(FRAME_TURN):
            t0 = time.perf_counter()
            out = frame(graphed, k)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(out)
        launches = (mk.launches, mk.launches_xyz,
                    setup_k.launches_ray_setup, setup_k.launches_gather,
                    setup_k.launches_finish)
        if launches != (FRAME_TURN * SPP,) * 4 + (FRAME_TURN,):
            raise RuntimeError(f"a turn of {FRAME_TURN} frames (graphed "
                               f"{graphed}) launched {launches}")
        images.setdefault(graphed, outs)
        turns.append(("graph" if graphed else "eager", float(np.median(ms)),
                      float(np.mean(ms))))
    counted = tuple(b - a for a, b in zip(counters, (
        kt.graph_captures, kt.graph_replays, kt.graph_eager)))
    if counted != (0, 2 * FRAME_TURN, 2 * FRAME_TURN):
        raise RuntimeError(f"graph captures, replays and eager frames "
                           f"{counted}, expected (0, {2 * FRAME_TURN}, "
                           f"{2 * FRAME_TURN})")
    for k, (e, g) in enumerate(zip(images[False], images[True])):
        for name in ("accum_xyz", "mean_xyz", "srgb"):
            if not torch.equal(e[name], g[name]):
                raise RuntimeError(f"graphed frame {k} {name} differs from "
                                   "the eager frame's")
    print(f"phase 31 (frame graph): Cornell {WIDTH}x{HEIGHT} spp {SPP} "
          f"depth {MAX_DEPTH}, {FRAME_TURN} served frames a turn; frame ms "
          f"(median, mean) in turns "
          f"{[(nm, round(a, 4), round(b, 4)) for nm, a, b in turns]}; "
          f"captures, replays, eager frames {counted}; launches a frame "
          f"{SPP} forwards (the XYZ build), {SPP} ray setups, {SPP} "
          f"gathers and one finish either way; "
          f"accum, mean and sRGB bit-equal")


def _plain_live(static, max_depth, args, mesh_arrays=()):
    """The plain forward's bounce loop (forward_reference's) on args and
    the mesh parts' arrays, counting what _unrolled_bounds reads off a
    tape, for a scene the taped forward refuses: (radiance, live bounces,
    shadow scans)."""
    prims, rays, seeds, spect = args
    mesh = mk._mesh(static, mesh_arrays)
    state = mk._init_state(rays, seeds)
    live = diffuse_on = 0
    for depth in range(max_depth + 1):
        active = state["nondiff"][4]
        if not bool(active.any()):
            break
        live += int(active.sum())
        if depth:
            diffuse_on += int((active & ~state["nondiff"][2]).sum())
        state = mk._bounce(static, prims, spect, state, depth, max_depth,
                           RR_START, mesh)
    return torch.stack(state["diff"][2]), live, diffuse_on


def _wide_tables(dev):
    """Phase 32: the forward's global-table build (megakernel_fwd_wide) on
    the benchmark's rtnw-final, 3,407 unrolled rows, at its 800^2 film and
    depth 40, sample 1. Every pixel: the kernel twice and its plain version
    (forward_reference) on the same CUDA tensors, bit-equal; the build's
    launches (launches_wide, no other forward); its device time (CUDA
    events) and its bound from the plain loop's live bounces and shadow
    scans. Then the served path: render at spp SPP launches SPP of its XYZ
    build and no other forward. Returns its kernels-line entry and what
    phase 33 reuses: the scene, its static, the plain radiance and time, the
    live bounces and shadow scans, and the render's XYZ launches."""
    with open(WIDE_CONFIG) as f:
        scene, _ = scene_from_dict(json.load(f)["scene"], device=dev)
    static = mk.SceneStatic.from_scene(scene)
    if len(static.rows) <= mk.MAX_PRIMS or static.mesh_parts:
        raise RuntimeError(f"rtnw-final has {len(static.rows)} unrolled rows "
                           f"and {len(static.mesh_parts)} mesh parts")
    side, depth = WIDE_SIDE, WIDE_DEPTH
    px, py = kt.tile_coords(side, side, 0, dev)
    args = kt.kernel_inputs(scene, *kt.camera_planes(
        scene, side, side, px, py, 1), static)
    rays = args[1].shape[1]
    _reset_counters()
    got = mk.forward(static, depth, RR_START, *args)
    again = mk.forward(static, depth, RR_START, *args)
    torch.cuda.synchronize()
    if _counters() != _only(forward_wide=2):
        raise RuntimeError(f"two forwards of rtnw-final launched "
                           f"{_counters()}")
    plain_s, want = _host_s(lambda: mk.forward_reference(
        static, depth, RR_START, *args))
    if not (torch.isfinite(got).all() and float(want.sum()) > 0):
        raise RuntimeError("rtnw-final's radiance is not finite and non-zero")
    exact = (got == want).all(dim=0).float().mean().item()
    max_abs_err = (got - want).abs().max().item()
    if exact < 1.0 or not torch.equal(again, got):
        raise RuntimeError(f"the global-table build is bit-equal to its plain "
                           f"version on {exact} of rays; a second launch "
                           f"bit-equal: {torch.equal(again, got)}")
    loop, live, diffuse_on = _plain_live(static, depth, args)
    if not torch.equal(loop, want):
        raise RuntimeError("the counting loop differs from forward_reference")
    ms = _events_ms(lambda: mk.forward(static, depth, RR_START, *args), 3)
    prims, rays_t, seeds, spect = args
    bound = _bound(_nbytes(prims, rays_t, spect) + seeds.numel() * 4
                   + 4 * rays * 4,
                   (live + diffuse_on) * len(static.rows) * PRIM_TEST_OPS)
    _reset_counters()
    cfg = RenderConfig(width=side, height=side, spp=SPP, max_depth=depth,
                       rr_start=RR_START, kernel="pallas")
    render_s, out = _host_s(lambda: render(scene, cfg))
    render_counts = _counters()
    if render_counts != _only(forward_wide=SPP, forward_xyz=SPP):
        raise RuntimeError(f"the rtnw-final render launched {render_counts}")
    finishes = _setup_counters()["finish"]
    if finishes != 1:
        raise RuntimeError(f"the rtnw-final render launched {finishes} "
                           f"finishes, expected 1")
    if not torch.isfinite(out["accum_xyz"]).all():
        raise RuntimeError("the rtnw-final render is not finite")
    print(f"phase 32 (global tables): rtnw-final {len(static.rows)} rows, "
          f"{side}x{side} depth {depth}, sample 1, {rays} rays: kernel "
          f"{ms:.4f} ms, plain {plain_s * 1e3:.1f} ms, bit-equal on "
          f"{exact:.6f} of rays, a second launch bit-equal; {live} live "
          f"bounces, {diffuse_on} shadow scans, bound {bound[0]:.4f} ms "
          f"({bound[1]}); render spp {SPP} in {render_s:.3f} s, "
          f"{SPP} launches of the global-table XYZ build and no other "
          f"forward, one finish")
    return {
        "name": "megakernel_forward_wide",
        "route": "cuda",
        "source": "computeraytracer_tpu_torch/kernels/csrc/megakernel_fwd.cu",
        "replaces": "computeraytracer_tpu/kernels/megakernel.py:897 "
                    "(plain mode, more rows than the shared tables hold)",
        "launches": (render_counts["forward_wide"]
                     - render_counts["forward_xyz"]),
        "max_abs_err": max_abs_err,
        "bit_equal_rays": exact,
        "ms": ms,
        "plain_ms": plain_s * 1e3,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": None,
        "ms_per_sample": ms,
        "mpaths_per_s": rays / (ms * 1e-3) / 1e6,
        "rays": rays,
        "rows": len(static.rows),
        "max_depth": depth,
        "live_bounces": live,
        "shadow_scans_counted": diffuse_on,
        "render_s": render_s,
    }, {"scene": scene, "static": static, "side": side, "depth": depth,
        "want": want, "plain_ms": plain_s * 1e3, "live": live,
        "diffuse_on": diffuse_on,
        "launches": render_counts["forward_xyz"],
        "planar": out["accum_xyz"].permute(2, 0, 1).reshape(3, -1)
                                 .contiguous(), "total": SPP,
        "finishes": finishes}


def _wide_mesh(dev, wide_case):
    """Phase 35: the forward's global-table mesh build
    (csrc/megakernel_fwd_wide_mesh.cu refill_fwd_wide_mesh) on the
    benchmark's rtnw-final-mesh, 1,007 unrolled rows beside one mesh part of
    4,800 triangles, at its 800^2 film and depth 40, sample 1. On every
    WIDE_MESH_STRIDE-th pixel (a band of 64,000 rays): the kernel twice and
    its plain version (forward_reference) on the same CUDA tensors,
    bit-equal, 2 launches_wide_mesh and no other forward. On the whole
    film: its time (CUDA events) in turns with phase 32's refill_fwd_wide
    on rtnw-final (mesh, wide, wide, mesh), what the walk does to the same
    geometry; its bound from the plain loop's live bounces and shadow scans
    on the band, scaled to the film, each scan counted as the benchmark's
    roofline counts it (bench_h100/harness/roofline.py scan_ops); its
    registers; the kernel's device time under the profiler
    (_kernel_device_ms), and the span crt:kernel:megakernel_fwd_wide_mesh
    in a profile of the launch.
    Then the served path: render at spp SPP launches SPP of the build and
    no other forward, and one finish. Returns its kernels-line entry."""
    from bench_h100.harness import roofline

    with open(WIDE_MESH_CONFIG) as f:
        doc = json.load(f)["scene"]
    scene, _ = scene_from_dict(doc, device=dev)
    static = mk.SceneStatic.from_scene(scene)
    if (len(static.rows) <= mk.MAX_PRIMS or len(static.mesh_parts) != 1
            or static.mesh_parts[0].count != 4800):
        raise RuntimeError(f"rtnw-final-mesh has {len(static.rows)} rows and "
                           f"parts {static.mesh_parts}")
    side, depth = WIDE_SIDE, WIDE_DEPTH
    arrays = tuple(a for p in kt.mesh_packs_for(scene, static)
                   for a in p.arrays)
    px, py = kt.tile_coords(side, side, 0, dev)
    band = kt.kernel_inputs(scene, *kt.camera_planes(
        scene, side, side, px[::WIDE_MESH_STRIDE], py[::WIDE_MESH_STRIDE],
        1), static)
    _reset_counters()
    got = mk.forward(static, depth, RR_START, *band, *arrays)
    again = mk.forward(static, depth, RR_START, *band, *arrays)
    torch.cuda.synchronize()
    if _counters() != _only(forward_wide_mesh=2):
        raise RuntimeError(f"two forwards of rtnw-final-mesh launched "
                           f"{_counters()}")
    plain_s, want = _host_s(lambda: mk.forward_reference(
        static, depth, RR_START, *band, *arrays))
    if not (torch.isfinite(got).all() and float(want.sum()) > 0):
        raise RuntimeError("rtnw-final-mesh's radiance is not finite and "
                           "non-zero")
    exact = (got == want).all(dim=0).float().mean().item()
    if exact < 1.0 or not torch.equal(again, got):
        raise RuntimeError(f"the global-table mesh build is bit-equal to its "
                           f"plain version on {exact} of rays; a second "
                           f"launch bit-equal: {torch.equal(again, got)}")
    loop, live, diffuse_on = _plain_live(static, depth, band, arrays)
    if not torch.equal(loop, want):
        raise RuntimeError("the counting loop differs from forward_reference")
    film = kt.kernel_inputs(scene, *kt.camera_planes(
        scene, side, side, px, py, 1), static)
    rays = film[1].shape[1]
    scale = rays / band[1].shape[1]
    w_scene, w_static = wide_case["scene"], wide_case["static"]
    w_film = kt.kernel_inputs(w_scene, *kt.camera_planes(
        w_scene, side, side, px, py, 1), w_static)
    fns = {"mesh": lambda: mk.forward(static, depth, RR_START, *film,
                                      *arrays),
           "wide": lambda: mk.forward(w_static, depth, RR_START, *w_film)}
    turns = [(k, _events_ms(fns[k], 3)) for k in ("mesh", "wide", "wide",
                                                  "mesh")]
    ms = min(t for k, t in turns if k == "mesh")
    prims, rays_t, seeds, spect = film
    bound = _bound(_nbytes(prims, rays_t, spect, *arrays)
                   + seeds.numel() * 4 + 4 * rays * 4,
                   (live + diffuse_on) * scale * roofline.scan_ops(doc))
    # the profiler of this long process may drop every launch of a pass
    # (a fresh process records this one every time): _kernel_device_ms
    # repeats the pass; the span is a host event and always recorded
    kernel_ms, _, _ = _kernel_device_ms(fns["mesh"], 3,
                                        "refill_fwd_wide_mesh", passes=5)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        fns["mesh"]()
        torch.cuda.synchronize()
    span = "crt:kernel:megakernel_fwd_wide_mesh"
    if span not in {e.name for e in prof.events()}:
        raise RuntimeError(f"the profiled launch holds no {span} span")
    _reset_counters()
    cfg = RenderConfig(width=side, height=side, spp=SPP, max_depth=depth,
                       rr_start=RR_START, kernel="pallas")
    render_s, out = _host_s(lambda: render(scene, cfg))
    render_counts = _counters()
    finishes = _setup_counters()["finish"]
    if render_counts != _only(forward_wide_mesh=SPP) or finishes != 1:
        raise RuntimeError(f"the rtnw-final-mesh render launched "
                           f"{render_counts}, {finishes} finishes")
    if not torch.isfinite(out["accum_xyz"]).all():
        raise RuntimeError("the rtnw-final-mesh render is not finite")
    regs = _ptxas("megakernel_fwd_wide_mesh")
    print(f"phase 35 (global-table mesh build): rtnw-final-mesh "
          f"{len(static.rows)} rows and {static.mesh_parts[0].count} "
          f"triangles, {side}x{side} depth {depth}, sample 1: bit-equal on "
          f"{exact:.6f} of a band of {band[1].shape[1]} rays, a second "
          f"launch bit-equal, plain {plain_s * 1e3:.1f} ms on the band; "
          f"kernel ms in turns with refill_fwd_wide on rtnw-final {turns}; "
          f"profiled {kernel_ms:.4f} ms; {live} live bounces and "
          f"{diffuse_on} shadow scans on the band, bound {bound[0]:.4f} ms "
          f"({bound[1]}); render spp {SPP} in {render_s:.3f} s, {SPP} "
          f"launches of the build and no other forward, one finish; "
          f"ptxas {regs}")
    return {
        "name": "megakernel_forward_wide_mesh",
        "route": "cuda",
        "source": "computeraytracer_tpu_torch/kernels/csrc/"
                  "megakernel_fwd_wide_mesh.cu",
        "replaces": "computeraytracer_tpu/kernels/megakernel.py:897 "
                    "(mesh mode, more rows than the shared tables hold)",
        "launches": render_counts["forward_wide_mesh"],
        "bit_equal_rays": exact,
        "plain_rays": band[1].shape[1],
        "ms": ms,
        "turns_with_refill_fwd_wide": turns,
        "profiled_ms": kernel_ms,
        "plain_ms": plain_s * 1e3,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": None,
        "ms_per_sample": ms,
        "mpaths_per_s": rays / (ms * 1e-3) / 1e6,
        "rays": rays,
        "rows": len(static.rows),
        "triangles": static.mesh_parts[0].count,
        "max_depth": depth,
        "live_bounces_band": live,
        "shadow_scans_band": diffuse_on,
        "render_s": render_s,
        "ptxas": regs,
    }


FINISH_REPS = 20  # calls a timing of phase 34


def _finish_tail(xyz, total, width, height):
    """The tail that the finish kernel replaced, on a replayed frame's
    planar sum xyz, as the frame graph and ``tracer/api.py`` ``render`` ran
    it before: the graph's permute copy, the replay's clone, the division
    by the Python number total and ``ops/color.py`` ``xyz_to_srgb`` in
    torch (about thirty launches)."""
    film = xyz.view(3, height, width).permute(1, 2, 0).contiguous().clone()
    mean = film / float(total)
    return film, mean, color.xyz_to_srgb(mean)


def _finish_frame(name, planar, total, side, launches):
    """Phase 34, one film: the finish kernel on the frame's planar sum
    (3, side * side) of total samples and on its interleaved copy, at
    sample counts 3 and total, bit-equal to finish_frame_reference on the
    card; its launches, its time in turns with the tail it replaced, its
    device time, plain time, bound and registers. launches: the finishes
    that the film's render counted (phase 4, phase 32). Returns its
    kernels-line entry."""
    film = planar.view(3, side, side).permute(1, 2, 0).contiguous()
    _reset_counters()
    for layout, src in (("planar", planar), ("interleaved", film)):
        for t in (3, total):
            got = setup_k.finish_frame(src, t, side, side)
            want = setup_k.finish_frame_reference(src, t, side, side)
            torch.cuda.synchronize()
            for nm, g, w in zip(("accum", "mean", "srgb"), got, want):
                if not torch.equal(g, w):
                    raise RuntimeError(f"{name}: the finish kernel's {nm} "
                                       f"({layout}, total {t}) differs from "
                                       f"its plain version")
    if setup_k.launches_finish != 4 or _counters() != _only():
        raise RuntimeError(f"four finishes on {name} counted "
                           f"{setup_k.launches_finish}, {_counters()}")
    kernel = lambda: setup_k.finish_frame(planar, total, side, side)
    tail = lambda: _finish_tail(planar, total, side, side)
    turns = [(nm, _events_ms(fn, FINISH_REPS)) for nm, fn in (
        ("kernel", kernel), ("tail", tail), ("tail", tail),
        ("kernel", kernel))]
    device, _, seen = _kernel_device_ms(kernel, FINISH_REPS, "finish_frame")
    plain_ms = _events_ms(lambda: setup_k.finish_frame_reference(
        planar, total, side, side), FINISH_REPS)
    bound = _bound(_nbytes(planar) + 3 * _nbytes(film), 0)
    regs = _registers("setup", "finish_frame")
    ms = [t for nm, t in turns if nm == "kernel"]
    tail_ms = [t for nm, t in turns if nm == "tail"]
    print(f"phase 34 (finish kernel, {name} {side}x{side}): accum, mean and "
          f"sRGB bit-equal to the plain version, planar and interleaved, "
          f"totals 3 and {total}; 4 launches; ms in turns "
          f"{[(nm, round(t, 4)) for nm, t in turns]}; device {device:.4f} "
          f"ms ({seen['finish_frame']} launches profiled) against its "
          f"bound {bound[0]:.4f} ms ({bound[1]}), {bound[0] / device:.3f} "
          f"of it; plain {plain_ms:.4f} ms; registers {regs}")
    return {
        "name": "finish_frame" + ("" if side == WIDTH else "_" + name),
        "route": "cuda",
        "source": "computeraytracer_tpu_torch/kernels/csrc/setup.cu",
        "replaces": "computeraytracer_tpu/tracer/api.py:103-107 render's "
                    "mean and ops/color.py xyz_to_srgb (XLA)",
        "launches": launches,
        "max_abs_err": 0.0,
        "ms": sum(ms) / len(ms),
        "ms_turns": turns,
        "tail_ms": sum(tail_ms) / len(tail_ms),
        "device_ms": device,
        "plain_ms": plain_ms,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": None,
        "pixels": side * side,
        "registers": regs,
    }


# Float operations of the XYZ epilogue per ray: for each of X, Y and Z
# four products, three sums, the scale and the add into the accumulator.
XYZ_EPILOGUE_OPS = 3 * (4 + 3 + 1 + 1)


def _registers(src, kernel):
    """{entry function: registers} that -Xptxas -v printed for the entries
    of csrc/<src>.cu whose mangled names hold kernel, the names demangled
    by c++filt where it is installed."""
    regs, name = {}, None
    for line in _build.build_log.get(src, "").splitlines():
        if "Compiling entry function '" in line:
            name = line.split("'")[1]
        elif "Used " in line and " registers" in line and name:
            if kernel in name:
                regs[name] = int(line.split("Used ")[1].split()[0])
            name = None
    try:
        names = subprocess.run(["c++filt", "-p"], input="\n".join(regs),
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return regs
    return (dict(zip(names, regs.values())) if len(names) == len(regs)
            else regs)


def _xyz_build(dev, name, case):
    """Phase 33, one scene: the forward's XYZ build (mk.forward_xyz) on
    sample 1 of case (the scene, its static, film side and depth, the plain
    radiance of sample 1 and its time, the live bounces and shadow scans
    of phase 3's tape or phase 32's loop, the XYZ launches of the phase's
    render) into an accumulator that holds sample 2 already: twice,
    bit-equal to forward_reference then xyz_accumulate_reference on the
    same operands; its launches, time, plain time, bound and registers.
    Returns its kernels-line entry."""
    scene, static = case["scene"], case["static"]
    side, depth, want = case["side"], case["depth"], case["want"]
    wide = len(static.rows) > mk.MAX_PRIMS
    setup = kt.setup_operands(scene, static)
    px, py = kt.tile_coords(side, side, 0, dev)

    def operands(sample):
        o, d, hero, seed = kt.camera_planes(scene, side, side, px, py, sample)
        spect, cie = spec.gather_hero_tables(
            (setup.spect_table, setup.cie_table), hero)
        return o, d, seed, spect, cie

    o2, d2, seed2, spect2, cie2 = operands(2)
    start = spec.spectral_to_xyz_p(cie2, mk.forward(
        static, depth, RR_START, setup.prims, torch.cat([o2, d2]), seed2,
        spect2))
    o, d, seed, spect, cie = operands(1)
    # the operands that the plain radiance of sample 1 was computed from
    args = kt.kernel_inputs(scene, *kt.camera_planes(
        scene, side, side, px, py, 1), static)
    if not (torch.equal(args[0], setup.prims)
            and torch.equal(args[1], torch.cat([o, d]))
            and torch.equal(args[2], seed) and torch.equal(args[3], spect)):
        raise RuntimeError(f"{name}: the XYZ build's operands are not those "
                           f"of the plain radiance")
    want_acc = start.clone()
    mk.xyz_accumulate_reference(cie, want, want_acc)
    scratch = start.clone()
    model_ms = _events_ms(lambda: mk.xyz_accumulate_reference(
        cie, want, scratch), 3)
    xyz = (static, depth, RR_START, setup.prims, o, d, seed, spect, cie)
    _reset_counters()
    got, again = start.clone(), start.clone()
    mk.forward_xyz(*xyz, got, mk._ray_counter(dev))
    mk.forward_xyz(*xyz, again, mk._ray_counter(dev))
    torch.cuda.synchronize()
    counts = _counters()
    own = "forward_wide" if wide else "forward"
    if counts != _only(**{own: 2, "forward_xyz": 2}):
        raise RuntimeError(f"two XYZ launches on {name} counted {counts}")
    exact = (got == want_acc).all(dim=0).float().mean().item()
    max_abs_err = (got - want_acc).abs().max().item()
    if exact < 1.0 or not torch.equal(again, got):
        raise RuntimeError(f"{name}: the XYZ build is bit-equal to forward_"
                           f"reference then xyz_accumulate_reference on "
                           f"{exact} of rays; a second launch bit-equal: "
                           f"{torch.equal(again, got)}")
    if torch.equal(got, start):
        raise RuntimeError(f"{name}: the XYZ build added nothing")
    scratch = start.clone()
    ms = _events_ms(lambda: mk.forward_xyz(*xyz, scratch,
                                           mk._ray_counter(dev)), 3)
    rays = o.shape[1]
    bound = _bound(_nbytes(setup.prims, o, d, seed, spect, cie)
                   + 2 * _nbytes(start),
                   (case["live"] + case["diffuse_on"]) * len(static.rows)
                   * PRIM_TEST_OPS + XYZ_EPILOGUE_OPS * rays)
    kernel = "refill_fwd_wide_xyz" if wide else "refill_fwd_xyz"
    regs = _registers("megakernel_fwd_xyz", kernel)
    plain_ms = case["plain_ms"] + model_ms
    print(f"phase 33 (XYZ build, {name} {side}x{side} depth {depth}, "
          f"{len(static.rows)} rows, {kernel}): bit-equal to forward_"
          f"reference then the model on {exact:.6f} of {rays} rays into an "
          f"accumulator holding sample 2, a second launch bit-equal; "
          f"launches {_launched(counts)}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.1f} ms (model {model_ms:.3f} ms), bound "
          f"{bound[0]:.4f} ms ({bound[1]}); registers {regs}")
    return {
        "name": ("megakernel_forward_wide_xyz" if wide
                 else "megakernel_forward_xyz"),
        "route": "cuda",
        "source": "computeraytracer_tpu_torch/kernels/csrc/"
                  "megakernel_fwd_xyz.cu",
        "replaces": "computeraytracer_tpu/kernels/megakernel.py:897 "
                    + ("(plain mode, more rows than the shared tables hold) "
                       if wide else "")
                    + "then computeraytracer_tpu/tracer/pallas.py "
                      "spectral_to_xyz_p and the frame's accumulation",
        "launches": case["launches"],
        "launches_sharded": case.get("launches_sharded"),
        "max_abs_err": max_abs_err,
        "bit_equal_rays": exact,
        "ms": ms,
        "plain_ms": plain_ms,
        "plain_model_ms": model_ms,
        "bound_ms": bound[0],
        "bound_by": bound[1],
        "library_ms": None,
        "ms_per_sample": ms,
        "mpaths_per_s": rays / (ms * 1e-3) / 1e6,
        "rays": rays,
        "rows": len(static.rows),
        "max_depth": depth,
        "live_bounces": case["live"],
        "shadow_scans_counted": case["diffuse_on"],
        "registers": regs,
    }


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})")
    print(smi)

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for src, log in _build.build_log.items():
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print(f"ptxas[{src}]: {line.strip()}")

    # 3. kernel vs plain version at the main path's shape
    scene, _ = scene_from_dict(presets.cornell_box(WIDTH, HEIGHT), device=dev)
    static = mk.SceneStatic.from_scene(scene)
    px, py = kt.tile_coords(WIDTH, HEIGHT, 0, dev)
    o, d, hero, seed = kt.camera_planes(scene, WIDTH, HEIGHT, px, py, 1)
    args = kt.kernel_inputs(scene, o, d, hero, seed)
    got = mk.forward(static, MAX_DEPTH, RR_START, *args)
    want = mk.forward_reference(static, MAX_DEPTH, RR_START, *args)
    torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError("non-finite radiance")
    abs_err = (got - want).abs()
    rel = abs_err / want.abs().clamp(min=1e-2)
    frac = (rel < 1e-4).all(dim=0).float().mean().item()
    max_abs_err = abs_err.max().item()
    exact = (got == want).all(dim=0).float().mean().item()
    again = torch.equal(mk.forward(static, MAX_DEPTH, RR_START, *args), got)
    print(f"kernel vs plain: {frac:.6f} of {got.shape[1]} rays within rel "
          f"1e-4; worst rel {rel.max().item():.3g}, worst abs "
          f"{max_abs_err:.3g}; bit-equal {exact:.6f}; a second launch "
          f"bit-equal: {again}")
    if frac < 0.999 or exact < 1.0 or not again:
        raise RuntimeError(f"kernel disagrees with plain version or with "
                           f"itself: {frac}, {exact}, {again}")

    # 4. the served path
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP,
                       max_depth=MAX_DEPTH, kernel="pallas")
    _reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = render(scene, cfg)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    render_counts = _counters()
    launches = render_counts["forward"] - render_counts["forward_xyz"]
    setup_render = _setup_counters()
    if render_counts != _only(forward=SPP, forward_xyz=SPP):
        raise RuntimeError(f"the render launched {render_counts}, expected "
                           f"{SPP} forwards, each the XYZ build")
    want_setup = {"ray_setup": SPP, "hero_gather_fwd": SPP,
                  "hero_gather_bwd": 0, "ray_setup_bwd": 0, "finish": 1}
    if setup_render != want_setup:
        raise RuntimeError(f"the render's setup launched {setup_render}, "
                           f"expected {want_setup}")
    accum = out["accum_xyz"]
    if not torch.isfinite(accum).all() or not (accum != 0).any():
        raise RuntimeError("render is not finite and non-zero")
    mean_xyz = out["mean_xyz"].mean(dim=(0, 1))
    plain_mean = (_plain_render_accum(scene, static, SPP)
                  / float(out["samples"])).mean(dim=(0, 1))
    rel_mean = ((mean_xyz - plain_mean).abs() / plain_mean.abs()).max().item()
    print(f"render: {WIDTH}x{HEIGHT} spp {SPP} depth {MAX_DEPTH} in "
          f"{render_s:.3f} s ({WIDTH * HEIGHT * SPP / render_s / 1e6:.3f} "
          f"Mpaths/s end to end), launches {_launched(render_counts)}, "
          f"setup launches "
          f"{setup_render}, mean XYZ "
          f"{mean_xyz.tolist()} vs plain {plain_mean.tolist()} "
          f"(rel {rel_mean:.3g})")
    if rel_mean > 1e-3:
        raise RuntimeError(f"mean XYZ off the plain render by {rel_mean}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cornell.png")
        write_png(path, out["srgb"])
        if read_png(path).shape != (HEIGHT, WIDTH, 3):
            raise RuntimeError("PNG did not round-trip")
    print(f"png: {WIDTH}x{HEIGHT} written and read back")

    # 5. timing at the phase-3 shape
    ms = _events_ms(lambda: mk.forward(static, MAX_DEPTH, RR_START, *args), 5)
    plain_ms = _events_ms(
        lambda: mk.forward_reference(static, MAX_DEPTH, RR_START, *args), 2)
    rays = args[1].shape[1]
    print(f"forward: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms per "
          f"sample of {rays} rays")
    schedule = _schedule(static, MAX_DEPTH, args, got)
    for line in _ptxas("megakernel_fwd"):
        print(f"ptxas[megakernel_fwd]: {line}")

    # 6. backward kernel vs plain version at the phase-3 shape
    gen = torch.Generator(device=dev).manual_seed(0)
    dL = torch.randn((4, rays), generator=gen, device=dev)
    got_b = mk.backward(static, MAX_DEPTH, RR_START, *args, dL)
    t_plain_b, want_b = _host_s(lambda: mk.backward_reference(
        static, MAX_DEPTH, RR_START, *args, dL, ray_chunk=BAND))
    ok, report, bwd_abs_err, equal = _backward_agreement(got_b, want_b)
    print(f"backward vs plain ({rays} rays, plain in bands of {BAND}, "
          f"{t_plain_b:.1f} s): " + report
          + f"; bit-equal rays {equal:.6f}; max abs err {bwd_abs_err:.3g}")
    if not ok:
        raise RuntimeError("backward kernel disagrees with plain version")
    wscene, _ = scene_from_dict(_wide_cornell(WIDTH, HEIGHT), device=dev)
    wstatic = mk.SceneStatic.from_scene(wscene)
    wargs = kt.kernel_inputs(wscene, *kt.camera_planes(
        wscene, WIDTH, HEIGHT, px[:BAND], py[:BAND], 1), wstatic)
    wdL = dL[:, :BAND].contiguous()
    got_w = mk.backward(wstatic, MAX_DEPTH, RR_START, *wargs, wdL)
    _, wtf, wti = mk.forward_taped(wstatic, MAX_DEPTH, RR_START, *wargs)
    got_wt = mk.backward_from_tape(wstatic, MAX_DEPTH, RR_START, wargs[0],
                                   wargs[3], wtf, wti, wdL)
    torch.cuda.synchronize()
    if any(bool((g != w).any()) for g, w in zip(got_wt, got_w)):
        raise RuntimeError("with 10 spectra, the two backward kernels "
                           "differ on one tape")
    ok, report, _, equal_w = _backward_agreement(
        got_w, mk.backward_reference(wstatic, MAX_DEPTH, RR_START, *wargs,
                                     wdL))
    print(f"backward with S = {wstatic.n_spectra} spectra ({BAND} "
          f"rays): " + report
          + f"; bit-equal rays {equal_w:.6f}; tape-fed kernel bit-equal")
    if not ok:
        raise RuntimeError("backward kernel disagrees with plain version "
                           "with 10 spectra")
    del got_w, got_wt, wtf, wti

    # 7. the training path at full width
    sp, d1, train_scene = _train_leaves(scene)
    mk.launches = 0
    mk.launches_bwd = 0
    setup_k.launches_ray_setup_bwd = 0
    step_s, loss = _host_s(lambda: _vg(train_scene, static))
    launches_fwd, launches_bwd = mk.launches, mk.launches_bwd
    if (launches_fwd, launches_bwd) != (SPP, SPP):
        raise RuntimeError(f"value_and_grad made {launches_fwd} forward and "
                           f"{launches_bwd} backward launches, expected "
                           f"{SPP} each")
    if setup_k.launches_ray_setup_bwd:
        raise RuntimeError("a step without camera leaves launched the ray "
                           "setup's backward")
    for nm, g in (("spectra", sp.grad), ("data1", d1.grad)):
        if g is None or not torch.isfinite(g).all():
            raise RuntimeError(f"{nm} gradient missing or not finite")
    grads_retrace = (sp.grad.clone(), d1.grad.clone())
    loss_retrace = loss
    rows = _rows_read(static)
    dead = [r for r in rows if not (sp.grad[r] != 0).any()]
    if dead or not (d1.grad != 0).any():
        raise RuntimeError(f"zero gradient in spectra rows {dead} or data1")
    print(f"value_and_grad: loss {loss:.6e}, {launches_fwd} forward + "
          f"{launches_bwd} backward launches, {step_s * 1e3:.1f} ms "
          f"(first call); |d spectra| per read row "
          f"{[float(sp.grad[r].abs().sum()) for r in rows]}, |d data1| "
          f"{float(d1.grad.abs().sum()):.6g}")
    with torch.no_grad():
        target = opt.render_mean_xyz(scene, WIDTH, HEIGHT, SPP, MAX_DEPTH,
                                     RR_START)
    spectra = scene.spectra.clone()
    spectra[PERTURB_ROW] = spectra[PERTURB_ROW] * 0.3
    train_s, (_, losses) = _host_s(lambda: opt.optimize(
        dataclasses.replace(scene, spectra=spectra), target, WIDTH, HEIGHT,
        steps=TRAIN_STEPS, learning_rate=0.05, spp=SPP, max_depth=MAX_DEPTH,
        rr_start=RR_START, kernel="pallas", spectra_rows=[PERTURB_ROW]))
    print(f"optimize: {TRAIN_STEPS} steps in {train_s:.2f} s, losses "
          f"{losses}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise RuntimeError(f"optimize did not lower the loss: {losses}")

    # 8. timing
    bwd_ms = _events_ms(
        lambda: mk.backward(static, MAX_DEPTH, RR_START, *args, dL), 5)
    band = [a.contiguous() for a in (args[1][:, :BAND], args[2][:, :BAND],
                                     args[3][:, :BAND], dL[:, :BAND])]
    plain_bwd_ms = _events_ms(lambda: mk.backward_reference(
        static, MAX_DEPTH, RR_START, args[0], *band), 1)
    print(f"backward: kernel {bwd_ms:.4f} ms per sample of {rays} rays; "
          f"plain {plain_bwd_ms:.1f} ms per band of {BAND} rays")
    bwd_sections = _sections(lambda t: mk.backward(
        static, MAX_DEPTH, RR_START, *args, dL, times=t))
    print(f"backward sections (timed build, {bwd_sections['timed_ms']:.4f} "
          f"ms; the replay is the taped forward's launch): "
          + json.dumps({k: round(v, 4) for k, v in
                        bwd_sections["share"].items()}))
    for line in _ptxas("megakernel_bwd"):
        print(f"ptxas[megakernel_bwd]: {line}")
    steps = [_host_s(lambda: _vg(_train_leaves(scene)[2], static))[0]
             for _ in range(3)]
    paths = WIDTH * HEIGHT * SPP
    print(f"fwd+bwd step (value_and_grad, spp {SPP}): "
          f"{[round(t * 1e3, 3) for t in steps]} ms, "
          f"{[round(paths / t / 1e6, 3) for t in steps]} Mpaths/s")
    sp, d1, train_scene = _train_leaves(scene)
    adam = torch.optim.Adam([sp, d1], lr=0.05)
    fwd_s, loss = _host_s(lambda: _headline_loss(train_scene, static))
    bwd_s, _ = _host_s(loss.backward)
    adam_s, _ = _host_s(adam.step)
    print(f"train step breakdown: forward pass {fwd_s * 1e3:.3f} ms "
          f"({SPP} forward kernels of ~{ms:.3f} ms, the rest setup ops and "
          f"CIE), backward pass {bwd_s * 1e3:.3f} ms ({SPP} backward "
          f"kernels of ~{bwd_ms:.3f} ms, the rest autograd of the setup "
          f"ops), Adam {adam_s * 1e3:.3f} ms")
    print(f"chip_smoke phases 1-8: {time.perf_counter() - t_start:.1f} s")

    # 9. the tape-fed backward at the phase-3 shape
    D = MAX_DEPTH + 1
    rad_t, tape_f, tape_i = mk.forward_taped(static, MAX_DEPTH, RR_START,
                                             *args)
    torch.cuda.synchronize()
    if not torch.equal(rad_t, got):
        raise RuntimeError("taped forward radiance is not the forward "
                           "kernel's bit for bit")
    t_plain_t, want_t = _host_s(lambda: mk.forward_taped_reference(
        static, MAX_DEPTH, RR_START, *args))
    taped_abs_err = (rad_t - want_t[0]).abs().max().item()
    ints_eq = (tape_i == want_t[2]).all(dim=0)
    tf3 = tape_f.reshape(D, 16, rays)
    wf3 = want_t[1].reshape(D, 16, rays)
    scale = wf3.abs().amax(dim=(0, 2), keepdim=True).clamp(min=1.0)
    rel_t = (tf3 - wf3).abs() / torch.maximum(wf3.abs(), 1e-2 * scale)
    floats_ok = (rel_t < 1e-4).all(dim=0).all(dim=0)
    frac_int = ints_eq.float().mean().item()
    frac_float = floats_ok.float().mean().item()
    tape_equal = ((tape_f == want_t[1]).all(dim=0) & ints_eq
                  & (rad_t == want_t[0]).all(dim=0)).float().mean().item()
    live_rows = tape_i.reshape(D, mk.TAPE_I, rays)[:, 7].sum(dim=1).tolist()
    bounds = _unrolled_bounds(args, tape_i, MAX_DEPTH,
                              len(static.rows) * PRIM_TEST_OPS)
    print(f"taped forward: radiance bit-equal to the forward kernel; tape "
          f"vs plain ({t_plain_t:.1f} s): int planes equal on {frac_int:.6f} "
          f"of rays, float planes within rel 1e-4 on {frac_float:.6f}, "
          f"bit-equal rays {tape_equal:.6f}; live bounces per "
          f"depth {live_rows}")
    if frac_int < 0.999 or frac_float < 0.999:
        raise RuntimeError("taped forward's tape disagrees with the plain "
                           "version")
    del want_t
    again = mk.forward_taped(static, MAX_DEPTH, RR_START, *args)
    if not all(torch.equal(a, b) for a, b in zip(again,
                                                  (rad_t, tape_f, tape_i))):
        raise RuntimeError("two launches of the taped forward differ")
    print("taped forward: a second launch bit-equal (radiance and tape)")
    del again
    got_tb = mk.backward_from_tape(static, MAX_DEPTH, RR_START, args[0],
                                   args[3], tape_f, tape_i, dL)
    torch.cuda.synchronize()
    diff = [int((g != w).sum()) for g, w in zip(got_tb, got_b)]
    print(f"tape-fed vs retrace kernel: entries that differ in (d_prims, "
          f"d_rays, d_spect) {diff}")
    if any(diff):
        raise RuntimeError("tape-fed kernel is not the retrace kernel bit "
                           "for bit")
    ok, report, tape_abs_err, equal_t = _backward_agreement(got_tb, want_b)
    print("tape-fed vs plain (phase 6's): " + report
          + f"; bit-equal rays {equal_t:.6f}; max abs err {tape_abs_err:.3g}")
    if not ok:
        raise RuntimeError("tape-fed kernel disagrees with plain version")
    del want_b, got_tb
    tape_sections = _sections(lambda t: mk.backward_from_tape(
        static, MAX_DEPTH, RR_START, args[0], args[3], tape_f, tape_i, dL,
        times=t))
    print(f"tape-fed sections (timed build, "
          f"{tape_sections['timed_ms']:.4f} ms): "
          + json.dumps({k: round(v, 4) for k, v in
                        tape_sections["share"].items()}))
    for line in _ptxas("megakernel_bwd_tape"):
        print(f"ptxas[megakernel_bwd_tape]: {line}")

    # 10. the pallas_taped training path
    sp, d1, train_scene = _train_leaves(scene)
    _reset_counters()
    step_t_s, loss_t = _host_s(lambda: _vg(train_scene, static,
                                           "pallas_taped"))
    counts = _counters()
    setup_step = _setup_counters()
    want_counts = _only(forward_taped=SPP, backward_tape=SPP)
    if counts != want_counts:
        raise RuntimeError(f"pallas_taped value_and_grad launched {counts}, "
                           f"expected {want_counts}")
    want_setup = {"ray_setup": SPP, "hero_gather_fwd": SPP,
                  "hero_gather_bwd": SPP, "ray_setup_bwd": 0, "finish": 0}
    if setup_step != want_setup:
        raise RuntimeError(f"the step's setup launched {setup_step}, "
                           f"expected {want_setup}")
    launches_taped = counts["forward_taped"]
    launches_tape_bwd = counts["backward_tape"]
    errs, same = [], []
    for nm, g, w in (("spectra", sp.grad, grads_retrace[0]),
                     ("data1", d1.grad, grads_retrace[1])):
        if g is None or not torch.isfinite(g).all():
            raise RuntimeError(f"taped {nm} gradient missing or not finite")
        errs.append(((g - w).abs().max() / w.abs().max()).item())
        same.append(bool(torch.equal(g, w)))
    print(f"pallas_taped value_and_grad: loss {loss_t:.6e} (retrace "
          f"{loss_retrace:.6e}), launches {counts}, setup {setup_step}, "
          f"{step_t_s * 1e3:.1f} ms (first "
          f"call); gradients vs phase 7: worst err {errs} of the largest "
          f"entry, bit-equal {same}")
    if max(errs) > 1e-5:
        raise RuntimeError("pallas_taped gradients differ from the retrace "
                           "path's")
    grads_taped = (sp.grad.clone(), d1.grad.clone())
    taped_ms = _events_ms(lambda: mk.forward_taped(
        static, MAX_DEPTH, RR_START, *args), 5)
    tape_bwd_ms = _events_ms(lambda: mk.backward_from_tape(
        static, MAX_DEPTH, RR_START, args[0], args[3], tape_f, tape_i, dL),
        5)
    tband = [a[:, :BAND].contiguous() for a in (args[3], tape_f, tape_i, dL)]
    plain_tape_bwd_ms = _events_ms(lambda: mk.backward_from_tape_reference(
        static, MAX_DEPTH, RR_START, args[0], *tband), 1)
    steps_t = [_host_s(lambda: _vg(_train_leaves(scene)[2], static,
                                   "pallas_taped"))[0] for _ in range(3)]
    peak = {}
    for bw in ("pallas", "pallas_taped"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _vg(_train_leaves(scene)[2], static, bw)
        torch.cuda.synchronize()
        peak[bw] = (torch.cuda.max_memory_allocated() - base) / 1e9
    print(f"taped forward {taped_ms:.4f} ms, tape-fed backward "
          f"{tape_bwd_ms:.4f} ms per sample of {rays} rays (forward "
          f"{ms:.4f}, retrace backward {bwd_ms:.4f}); plain tape-fed "
          f"{plain_tape_bwd_ms:.1f} ms per band of {BAND} rays; tape "
          f"{_nbytes(tape_f, tape_i) / 1e9:.3f} GB per sample")
    print(f"fwd+bwd step (value_and_grad, pallas_taped, spp {SPP}): "
          f"{[round(t * 1e3, 3) for t in steps_t]} ms, "
          f"{[round(paths / t / 1e6, 3) for t in steps_t]} Mpaths/s; peak "
          f"device memory above the inputs per step: retrace "
          f"{peak['pallas']:.3f} GB, taped {peak['pallas_taped']:.3f} GB")
    sp, d1, train_scene = _train_leaves(scene)
    adam = torch.optim.Adam([sp, d1], lr=0.05)
    fwd_s, loss_tt = _host_s(lambda: _headline_loss(train_scene, static,
                                                    "pallas_taped"))
    bwd_s, _ = _host_s(loss_tt.backward)
    adam_s, _ = _host_s(adam.step)
    print(f"taped train step breakdown: forward pass {fwd_s * 1e3:.3f} ms "
          f"({SPP} taped forward kernels of ~{taped_ms:.3f} ms, the rest "
          f"setup ops and CIE), backward pass {bwd_s * 1e3:.3f} ms ({SPP} "
          f"tape-fed kernels of ~{tape_bwd_ms:.3f} ms, the rest autograd of "
          f"the setup ops), Adam {adam_s * 1e3:.3f} ms")
    for bw in ("pallas", "pallas_taped"):
        wall, dev_ms, idle, n_k, top, n_ops, named = _profile(
            lambda: _vg(_train_leaves(scene)[2], static, bw), top=8,
            host_ops=True, named=(TAPED_KERNEL,))
        print(f"profile of one value_and_grad ({bw}): wall {wall:.1f} ms, "
              f"device {dev_ms:.1f} ms, idle share {idle:.3f}, {n_ops} "
              f"host-issued ops, {n_k} kernel launches (with the setup "
              f"built each sample, PERF.md §5: "
              f"{PER_SAMPLE_SETUP_STEP[bw]}); the taped forward's kernel "
              f"({'the replay' if bw == 'pallas' else 'the taped forward'})"
              f" {named[TAPED_KERNEL]:.3f} ms "
              f"({named[TAPED_KERNEL] / dev_ms:.3f} of the device time); "
              f"top {top}")
        if any("indexing_backward" in n for n, _ in top[:5]):
            raise RuntimeError(f"indexing_backward_kernel is among the "
                               f"{bw} step's top device operations")
    del tape_f, tape_i

    # 11. meshes
    t0 = time.perf_counter()
    mscene, _ = scene_from_dict(presets.mesh_scene(WIDTH, HEIGHT,
                                                   MESH_SUBDIVISIONS),
                                device=dev)
    mstatic = mk.SceneStatic.from_scene(mscene)
    n_tris = sum(p.count for p in mstatic.mesh_parts)
    marrays = tuple(a for p in kt.mesh_packs_for(mscene, mstatic)
                    for a in p.arrays)
    torch.cuda.synchronize()
    print(f"mesh scene: {n_tris} triangles in {len(mstatic.mesh_parts)} "
          f"part(s), {len(mstatic.rows)} unrolled rows, loaded and packed "
          f"in {time.perf_counter() - t0:.1f} s")
    if n_tris != 20 * 4 ** MESH_SUBDIVISIONS or len(mstatic.mesh_parts) != 1:
        raise RuntimeError(f"mesh_scene made {len(mstatic.mesh_parts)} "
                           f"mesh part(s) of {n_tris} triangles, expected one "
                           f"of {20 * 4 ** MESH_SUBDIVISIONS}")
    y0 = HEIGHT // 2 - MESH_BAND_ROWS // 2
    bpx, bpy = kt.tile_coords(WIDTH, MESH_BAND_ROWS, y0, dev)
    mo, md, mhero, mseed = kt.camera_planes(mscene, WIDTH, HEIGHT, bpx, bpy,
                                            1)
    margs = kt.kernel_inputs(mscene, mo, md, mhero, mseed, mstatic)
    got_m = mk.forward(mstatic, MESH_DEPTH, RR_START, *margs, *marrays)
    t_plain_m, want_m = _host_s(lambda: mk.forward_reference(
        mstatic, MESH_DEPTH, RR_START, *margs, *marrays))
    if not (torch.isfinite(got_m).all() and torch.isfinite(want_m).all()):
        raise RuntimeError("non-finite mesh radiance")
    mesh_abs_err = (got_m - want_m).abs().max().item()
    rel_m = (got_m - want_m).abs() / want_m.abs().clamp(min=1e-2)
    frac_m = (rel_m < 1e-4).all(dim=0).float().mean().item()
    exact_m = (got_m == want_m).all(dim=0).float().mean().item()
    print(f"mesh kernel vs plain: {frac_m:.6f} of {got_m.shape[1]} rays "
          f"(rows {y0}-{y0 + MESH_BAND_ROWS - 1}) within rel 1e-4; worst rel "
          f"{rel_m.max().item():.3g}, worst abs {mesh_abs_err:.3g}; bit-equal "
          f"{exact_m:.6f}; plain {t_plain_m:.1f} s")
    if frac_m < 0.999:
        raise RuntimeError(f"mesh kernel disagrees with plain version: "
                           f"{frac_m}")
    plain_mesh_ms = t_plain_m * 1e3
    mcfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP,
                        max_depth=MESH_DEPTH)
    _reset_counters()
    mrender_s, mout = _host_s(lambda: render(mscene, mcfg))
    counts = _counters()
    if counts != _only(forward_mesh=SPP):
        raise RuntimeError(f"mesh render launched {counts}, expected {SPP} "
                           f"mesh-mode forwards")
    launches_mesh = counts["forward_mesh"]
    macc = mout["accum_xyz"]
    if not torch.isfinite(macc).all() or not (macc != 0).any():
        raise RuntimeError("mesh render is not finite and non-zero")
    print(f"mesh render: {WIDTH}x{HEIGHT} spp {SPP} depth {MESH_DEPTH} in "
          f"{mrender_s:.3f} s ({WIDTH * HEIGHT * SPP / mrender_s / 1e6:.3f} "
          f"Mpaths/s end to end), launches {counts}")
    side, subdiv = SMALL_MESH
    sscene, _ = scene_from_dict(presets.mesh_scene(side, side, subdiv),
                                device=dev)
    sstatic = mk.SceneStatic.from_scene(sscene)
    sout = render(sscene, RenderConfig(width=side, height=side, spp=SPP,
                                       max_depth=MESH_DEPTH))
    sarrays = tuple(a for p in kt.mesh_packs_for(sscene, sstatic)
                    for a in p.arrays)
    smean = sout["mean_xyz"].mean(dim=(0, 1))
    splain = (_plain_render_accum(sscene, sstatic, SPP, side, side,
                                  MESH_DEPTH, sarrays)
              / float(sout["samples"])).mean(dim=(0, 1))
    rel_s = ((smean - splain).abs() / splain.abs()).max().item()
    print(f"mesh render {side}x{side} ({sum(p.count for p in sstatic.mesh_parts)} "
          f"triangles) spp {SPP}: mean XYZ {smean.tolist()} vs plain "
          f"{splain.tolist()} (rel {rel_s:.3g})")
    if rel_s > 1e-3:
        raise RuntimeError(f"mesh mean XYZ off the plain render by {rel_s}")
    fpx, fpy = kt.tile_coords(WIDTH, HEIGHT, 0, dev)
    fargs = kt.kernel_inputs(mscene, *kt.camera_planes(
        mscene, WIDTH, HEIGHT, fpx, fpy, 1), mstatic)
    mesh_ms = _events_ms(lambda: mk.forward(mstatic, MESH_DEPTH, RR_START,
                                            *fargs, *marrays), 3)
    got_f = mk.forward(mstatic, MESH_DEPTH, RR_START, *fargs, *marrays)
    work = torch.zeros(mk.WORK_KINDS, dtype=torch.int64, device=dev)
    counted = mk.forward(mstatic, MESH_DEPTH, RR_START, *fargs, *marrays,
                         work=work)
    if not torch.equal(counted, got_f):
        raise RuntimeError("the mesh kernel's counting build changed its "
                           "radiance")
    mesh_counts = work.tolist()
    (casts, box_tests, plane_tests, inside_tests, chunk_scans, scan_lanes,
     inside_needed) = mesh_counts
    counted_ms = _events_ms(lambda: mk.forward(
        mstatic, MESH_DEPTH, RR_START, *fargs, *marrays,
        work=torch.zeros(mk.WORK_KINDS, dtype=torch.int64, device=dev)), 1)
    print(f"mesh work (counting build, radiance bit-equal, {counted_ms:.1f} "
          f"ms): {casts} casts, {box_tests} box tests, {plane_tests} "
          f"triangle plane tests, {inside_needed} inside tests needed "
          f"(the bound's), {inside_tests} made by the lanes' culling, "
          f"{chunk_scans} chunk scans on {scan_lanes} lanes in all; per "
          f"cast {box_tests / casts:.2f} boxes, {plane_tests / casts:.2f} "
          f"planes, {inside_needed / casts:.2f} inside needed, "
          f"{inside_tests / casts:.2f} made, {chunk_scans / casts:.2f} "
          f"chunk scans; lanes per chunk scan "
          f"{scan_lanes / max(chunk_scans, 1):.2f}")
    del got_f, counted
    _tie_scenes(dev)
    wall, dev_ms, idle, n_k, top = _profile(lambda: render(mscene, mcfg))
    print(f"profile of the mesh render: wall {wall:.1f} ms, device "
          f"{dev_ms:.1f} ms, idle share {idle:.3f}, {n_k} kernel launches; "
          f"top {top}")
    print(f"mesh forward: kernel {mesh_ms:.3f} ms per sample of "
          f"{fargs[1].shape[1]} rays ({fargs[1].shape[1] / mesh_ms / 1e3:.3f} "
          f"Mpaths/s); plain {plain_mesh_ms:.1f} ms per band of "
          f"{got_m.shape[1]} rays")
    print(f"chip_smoke phases 1-11: {time.perf_counter() - t_start:.1f} s")

    # 12-16. triangle rows, the winner-taped forward, mesh gradients, the
    # finite-difference check and the trainer
    tri = _triangle_rows(dev)
    mesh_ops = (casts * len(mstatic.rows) * PRIM_TEST_OPS
                + box_tests * BOX_TEST_OPS + plane_tests * TRI_PLANE_OPS
                + inside_needed * TRI_INSIDE_OPS)
    win = _winners(mstatic, fargs, marrays, y0, mesh_ops)
    win["launches"], *grads_in_kernel = _mesh_grads(mscene, mstatic)
    _finite_difference(dev)
    _mesh_train(mscene, mstatic)
    print(f"chip_smoke phases 1-16: {time.perf_counter() - t_start:.1f} s")

    # 17-19. the wavefront, its gradients and its binned casts
    wave = _wavefront(mscene, mstatic, fargs, marrays, y0, mesh_counts)
    _wavefront_grads(mscene, mstatic, fargs, marrays, grads_in_kernel)
    _binned_casts(mstatic, fargs, marrays)
    print(f"chip_smoke phases 1-19: {time.perf_counter() - t_start:.1f} s")

    # 20-22. the eager tracer, the gradient oracle and the BVH
    _eager_render(scene, out["accum_xyz"])
    _gradient_oracle(scene, static, grads_retrace, loss_retrace)
    _bvh_mesh(mscene, mstatic)
    print(f"chip_smoke phases 1-22: {time.perf_counter() - t_start:.1f} s")

    # 23-25. observability, the screen warp around the kernels, the
    # boundary terms
    t0 = time.perf_counter()
    _observability(scene)
    vis_launches = _screen_warp_kernels(scene, static)
    _boundary_terms(dev)
    _light_hemi_full(scene)
    print(f"chip_smoke phases 23-25: {time.perf_counter() - t0:.1f} s; "
          f"phases 1-25: {time.perf_counter() - t_start:.1f} s")

    # 26-28. the world of one, two ranks on the card, the scalar oracle
    t0 = time.perf_counter()
    _world_of_one(scene, out["accum_xyz"])
    shard = _two_ranks(scene, static, out["accum_xyz"], macc)
    _oracle_pixels(dev)
    print(f"chip_smoke phases 26-28: {time.perf_counter() - t0:.1f} s; "
          f"phases 1-28: {time.perf_counter() - t_start:.1f} s")

    # 29. the per-sample setup's kernels
    setup_entries = _setup_kernels(scene, got_b[2], setup_render, setup_step)
    print(f"chip_smoke phases 1-29: {time.perf_counter() - t_start:.1f} s")

    # 30. camera gradients: the ray setup's backward kernel
    setup_entries.append(_camera_grads(
        scene, static, got_b[1], {"pallas": grads_retrace,
                                  "pallas_taped": grads_taped},
        setup_render, setup_step, smi))
    print(f"chip_smoke phases 1-30: {time.perf_counter() - t_start:.1f} s")

    # 31. served frames eager and through the frame graph, in turns
    _frame_graph_turns(dev)
    print(f"chip_smoke phases 1-31: {time.perf_counter() - t_start:.1f} s")

    # 32. the forward's global-table build
    wide, wide_case = _wide_tables(dev)
    print(f"chip_smoke phases 1-32: {time.perf_counter() - t_start:.1f} s")

    # 33. the forward's XYZ builds, shared and global-table
    xyz_entries = [
        _xyz_build(dev, "Cornell", {
            "scene": scene, "static": static, "side": WIDTH,
            "depth": MAX_DEPTH, "want": want, "plain_ms": plain_ms,
            "live": bounds["live"], "diffuse_on": bounds["diffuse_on"],
            "launches": render_counts["forward_xyz"],
            "launches_sharded": [c["forward_xyz"] for c in shard]}),
        _xyz_build(dev, "rtnw-final", wide_case)]
    print(f"chip_smoke phases 1-33: {time.perf_counter() - t_start:.1f} s")

    # 34. the finish kernel, Cornell and rtnw-final
    finish_entries = [
        _finish_frame("Cornell", out["accum_xyz"].permute(2, 0, 1)
                      .reshape(3, -1).contiguous(), SPP, WIDTH,
                      setup_render["finish"]),
        _finish_frame("rtnw-final", wide_case["planar"], wide_case["total"],
                      WIDE_SIDE, wide_case["finishes"])]
    print(f"chip_smoke phases 1-34: {time.perf_counter() - t_start:.1f} s")

    # 35. the forward's global-table mesh build
    wide_mesh = _wide_mesh(dev, wide_case)
    print(f"chip_smoke phases 1-35: {time.perf_counter() - t_start:.1f} s")

    # bounds at the shapes timed above
    b_fwd, b_taped = bounds["forward"], bounds["taped"]
    b_bwd, b_tape_bwd = bounds["backward"], bounds["tape_bwd"]
    tape_bytes, tape_read = bounds["tape_bytes"], bounds["tape_read"]
    live, diffuse_on = bounds["live"], bounds["diffuse_on"]
    mrays = fargs[1].shape[1]
    b_mesh = _bound(_nbytes(fargs[0], fargs[1], fargs[3], *marrays)
                    + fargs[2].numel() * 4 + 4 * mrays * 4, mesh_ops)
    src = "computeraytracer_tpu_torch/kernels/csrc/"
    print(json.dumps({"kernels": [{
        "name": "megakernel_forward",
        "route": "cuda",
        "source": src + "megakernel_fwd.cu",
        "replaces": "computeraytracer_tpu/kernels/megakernel.py:897",
        "launches": launches,
        "launches_train": launches_fwd,
        "launches_vis_grads": vis_launches["pallas"]["forward"],
        "launches_sharded": [c["forward"] - c["forward_xyz"]
                             for c in shard],
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_fwd[0],
        "bound_by": b_fwd[1],
        "library_ms": None,
        "ms_per_sample": ms,
        "plain_ms_per_sample": plain_ms,
        "mpaths_per_s": rays / (ms * 1e-3) / 1e6,
        "rays": rays,
        "max_depth": MAX_DEPTH,
        "live_bounces": live,
        "shadow_scans_counted": diffuse_on,
        "schedule": schedule,
    }, {
        "name": "megakernel_forward_taped",
        "route": "cuda",
        "source": src + "megakernel_fwd.cu",
        "replaces": "computeraytracer_tpu/kernels/megakernel.py:897 "
                    "(taped=\"full\")",
        "launches": launches_taped,
        "launches_vis_grads": vis_launches["pallas_taped"]["forward_taped"],
        "launches_sharded": [c["forward_taped"] for c in shard],
        "max_abs_err": taped_abs_err,
        "ms": taped_ms,
        "plain_ms": t_plain_t * 1e3,
        "bound_ms": b_taped[0],
        "bound_by": b_taped[1],
        "library_ms": None,
        "rays": rays,
        "max_depth": MAX_DEPTH,
        "tape_bytes": tape_bytes,
        "redesigned": f"persistent warps whose lanes take and retire rays "
                      f"in groups of {mk.GROUP} ({mk.GROUP} "
                      f"consecutive, aligned rays at one depth), so that "
                      f"every tape store writes whole 32-byte sectors; "
                      f"groups of 8 and 16 timed, 16 kept",
        "schedule": schedule["taped"],
    }, {
        "name": "megakernel_backward",
        "route": "cuda",
        "source": src + "megakernel_bwd.cu",
        "replaces": "computeraytracer_tpu/kernels/megakernel.py:1314",
        "launches": launches_bwd,
        "launches_vis_grads": vis_launches["pallas"]["backward"],
        "launches_sharded": [c["backward"] for c in shard],
        "max_abs_err": bwd_abs_err,
        "ms": bwd_ms,
        "plain_ms": plain_bwd_ms,
        "bound_ms": b_bwd[0],
        "bound_by": b_bwd[1],
        "library_ms": None,
        "plain_rays": BAND,
        "rays": rays,
        "max_depth": MAX_DEPTH,
        "fwdbwd_mpaths_per_s": [paths / t / 1e6 for t in steps],
        "sections": bwd_sections,
    }, {
        "name": "megakernel_backward_from_tape",
        "route": "cuda",
        "source": src + "megakernel_bwd_tape.cu",
        "replaces": "computeraytracer_tpu/kernels/megakernel.py:1480",
        "launches": launches_tape_bwd,
        "launches_vis_grads": vis_launches["pallas_taped"]["backward_tape"],
        "launches_sharded": [c["backward_tape"] for c in shard],
        "max_abs_err": tape_abs_err,
        "ms": tape_bwd_ms,
        "plain_ms": plain_tape_bwd_ms,
        "bound_ms": b_tape_bwd[0],
        "bound_by": b_tape_bwd[1],
        "library_ms": None,
        "plain_rays": BAND,
        "rays": rays,
        "max_depth": MAX_DEPTH,
        "fwdbwd_mpaths_per_s": [paths / t / 1e6 for t in steps_t],
        "peak_gb_per_step": peak["pallas_taped"],
        "tape_bytes_read": tape_read,
        "sections": tape_sections,
    }, {
        "name": "megakernel_forward_mesh",
        "route": "cuda",
        "source": src + "megakernel_fwd.cu",
        "replaces": "computeraytracer_tpu/kernels/megakernel.py:897 "
                    "(mesh mode, _scan_mesh_part :337)",
        "launches": launches_mesh,
        "launches_sharded": [c["forward_mesh"] for c in shard],
        "max_abs_err": mesh_abs_err,
        "ms": mesh_ms,
        "plain_ms": plain_mesh_ms,
        "bound_ms": b_mesh[0],
        "bound_by": b_mesh[1],
        "library_ms": None,
        "plain_rays": got_m.shape[1],
        "rays": mrays,
        "max_depth": MESH_DEPTH,
        "triangles": n_tris,
        "render_mpaths_per_s": WIDTH * HEIGHT * SPP / mrender_s / 1e6,
        "casts": casts,
        "box_tests": box_tests,
        "triangle_plane_tests": plane_tests,
        "triangle_inside_tests_needed": inside_needed,
        "triangle_inside_tests": inside_tests,
        "chunk_scans": chunk_scans,
        "chunk_scan_lanes": scan_lanes,
    }, dict({
        "name": "megakernel_forward_winners",
        "route": "cuda",
        "source": src + "megakernel_fwd.cu",
        "replaces": "computeraytracer_tpu/kernels/megakernel.py:897 "
                    "(taped=True, mesh mode)",
    }, **win)] + [dict({
        "name": name,
        "route": "cuda",
        "source": src + source,
        "replaces": "computeraytracer_tpu/kernels/megakernel.py:" + line
                    + " (triangle rows)",
    }, **tri[key]) for name, source, line, key in (
        ("megakernel_backward_tri", "megakernel_bwd.cu", "1314", "backward"),
        ("megakernel_backward_from_tape_tri", "megakernel_bwd_tape.cu",
         "1480", "tape_bwd"),
        ("megakernel_forward_taped_tri", "megakernel_fwd.cu",
         "897 (taped=\"full\")", "taped"),
        ("megakernel_forward_tri", "megakernel_fwd.cu", "897", "forward"))]
        + [dict({
            "name": name,
            "source": src + source,
            "replaces": "computeraytracer_tpu/kernels/" + line,
            "host_reads_per_sample": wave["host_reads"],
        }, **wave[key]) for name, source, line, key in (
            ("shade_step", "shade_step.cu", "megakernel.py:1087", "shade"),
            ("walk", "walk.cu", "binned.py:640", "walk"),
            ("candidates", "candidates.cu", "binned.py:215", "candidates"),
            ("pair_closest", "pair.cu", "binned.py:392", "pair_closest"),
            ("pair_any", "pair.cu", "binned.py:898", "pair_any"))]
        + setup_entries + [wide] + xyz_entries + finish_entries
        + [wide_mesh]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
