// The per-sample setup of the kernel path for Hopper (sm_90a): the camera
// rays, seeds and hero draw of every ray (ray_setup) with its backward to
// the camera (ray_setup_bwd), and the hero-indexed column gather of the
// spectra and CIE tables with its backward (hero_gather, hero_column_sums).
//
// Replaces the setup that the JAX package runs as one jitted XLA computation
// around its Pallas kernels:
// - ray_setup: computeraytracer_tpu/tracer/pallas.py:708-712, rng.seed_pixel_p
//   -> camera_ops.camera_rays_p -> spectrum.sample_wavelengths_p;
// - ray_setup_bwd: XLA's AD of camera_rays_p (tracer/pallas.py:709-711),
//   which carries the trace's ray cotangent to eye, lookat, up and fov;
// - hero_gather: computeraytracer_tpu/tracer/pallas.py:726-731, one
//   gather_hero_planar (ops/spectrum.py:121) of the spectra and CIE tables;
// - hero_column_sums: its scatter-free backward, spectrum.py:246 take_cols'
//   VJP (a one-hot contraction summed over blocks of rays, _chunked).
//
// ray_setup: one thread per ray. It reads 16 bytes a ray (px, py) and writes
// 64 (o, d, hero, seed), and its 16 TEA rounds and three pcg4d draws are u32
// arithmetic: the bytes bound it, the card's integer rate close behind. The
// camera frame (ops/camera.py film_frame: the basis, tan of the half fov, the
// aspect ratio, lower_left) is computed from the camera's own tensors by one
// thread of each block into shared memory while the block's other warps draw
// their seeds, so the wrapper issues no torch op for it. Every float
// operation is the plain version's (kernels/setup.py ray_setup_reference) in
// its order, each rounded once (--fmad=false, __f*_rn; the camera basis's
// fused multiply-adds as __fmaf_rn; tanf is the CUDA math library's, as
// torch.tan's on the card): the outputs are the plain version's bit for
// bit.
//
// ray_setup_bwd: with u = lower_left + s*horizontal + t*vertical - eye and
// d = u / |u|, the camera's gradient needs twelve sums over the rays, of
// g_o, g_u, s g_u and t g_u with g_u = (g_d - d (d . g_d)) / |u|, and the
// VJP of the camera frame from them. Pass 1 (one thread per ray, a CUDA
// block per 256 consecutive rays) recomputes s, t and u with
// ray_setup_kernel's own device code rather than reading them: it reads 40
// bytes a ray (px, py, g_o, g_d) and its seeds cost ~342 u32 operations a
// ray, so the card's integer rate bounds it, the bytes close behind. Each
// block sums its terms in a fixed order (a shuffle tree per warp, then the
// warps in order) into one partial; pass 2 (one CUDA block) sums the
// partials in BWD_GROUPS groups of consecutive blocks, then the groups in
// order, and one thread applies the frame's VJP (film_frame_vjp). The sums
// are f64 and each is rounded once to f32: the frame's VJP subtracts sums
// of 10^4-10^5 that differ by a few percent (sum s g_u - sum g_u / 2 at a
// wide fov), which f32 partial sums in this order carried to ~1e-5 of the
// camera's gradient. No float atomics: two launches give bit-equal sums, and
// the plain version (kernels/setup.py ray_setup_bwd_reference) adds in the
// same order.
//
// hero_gather: one thread per ray reads its hero and writes its column of
// every row of one or two tables (the spectra and CIE planes of a sample in
// one launch); the tables (36 x 301 floats, ~43 KB) stay in L1/L2. It moves
// the outputs and the hero indices: bytes bound it.
//
// hero_column_sums: d_table[k, l] = the sum of g[k, r] over the rays r with
// hero[r] == l, without float atomics, in a fixed order:
// 1. within each block of HERO_BLOCK consecutive rays, in ray order (from
//    0.0f); rays whose hero lies outside [0, L) are skipped;
// 2. the n_blocks block partials in GROUPS groups of ceil(n_blocks / GROUPS)
//    consecutive blocks (the last groups short or empty), within each group
//    in block order (from 0.0f);
// 3. the GROUPS group sums in group order (from 0.0f).
// Pass 1a (one CUDA block per ray block) sorts the block's rays by hero in
// shared memory, stably: every warp ranks its own contiguous segment of 256
// rays into per-warp column counts (the lanes sharing a hero from one ballot
// per bit of the hero), an exclusive scan over the warps per column gives
// each warp its base, and a block scan of the column totals (warp scans,
// then one scan of the warp totals) gives each column its first slot; it
// writes the starts and each ray's slot (~6 KB a block). Pass 1b runs one
// CUDA block per (ray block, SUM_ROWS rows): it reads the rows' values with
// 16-byte loads, scatters them into their sorted slots in shared memory, and
// one thread per column adds the column's slots, which hold its rays in ray
// order. Its blocks are small (~18 KB of shared memory, eight an SM) and
// many (6,144 for 24 rows and 2^20 rays), so one block's loads and serial
// sums overlap the others'. Pass 2 runs one warp per (group, 32 columns): 8
// warps a CUDA block, ~226 blocks for 24 x 301 columns. g (K x R floats) is
// read once: bytes bound it; the partials (n_blocks x K x L floats) are
// written and read once more. Two launches give bit-equal sums, and the
// plain version (setup.py hero_column_sums_reference: a stable sort, segment
// sums per block, then the groups' sums) adds in the same order.
//
// finish_frame: a rendered frame's tail (tracer/api.py render), one thread
// per pixel. It reads the frame's XYZ sum once, through a component stride
// and a pixel stride (the frame graph's planar (3, R) accumulator, or an
// interleaved (H, W, 3) one), and writes the mean (the sum over the sample
// count, a correctly rounded division, as the CPU's and the JAX package's
// accum / total) and its sRGB (ops/color.py xyz_to_srgb: the 3x3 matrix as
// products summed left to right, the exponential tone map, the gamma's two
// branches, the clamp to [0, 1]) as contiguous (H, W, 3) images, and the
// sum itself as one when it was read planar. Every operation is the plain
// version's (kernels/setup.py finish_frame_reference) in its order, each
// rounded once; expf and powf are the CUDA math library's, as torch.exp's
// and torch.pow's on the card; each constant is the Python number rounded
// once to f32, as torch passes it to its f32 kernels. 12 bytes a pixel are
// read and 24 or 36 written: bytes bound it, so each block stages its
// outputs in shared memory and stores them as whole sectors.
//
// Numerics: --fmad=false, as every kernel of the port.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HERO_BLOCK = 2048;           // rays per block of pass 1
constexpr int SEG_STEPS = HERO_BLOCK / THREADS;  // 32-ray steps a warp ranks
// pass 1a's scratch a ray block: the column starts (MAX_COLS + 1 ints,
// padded to 16 bytes), then each ray's sorted slot as u16 words
constexpr int SLOTS_AT = 516;
constexpr int SORT_WORDS = SLOTS_AT + HERO_BLOCK / 2;
constexpr int GROUPS = WARPS;              // pass 2's groups of ray blocks
constexpr int MAX_COLS = 512;              // table columns (301 wavelengths)
constexpr int HERO_BITS = 9;               // bits of a column index
constexpr int SUM_ROWS = 2;                // rows of g a pass-1b block sums
constexpr int GRID_SIZE = 16;              // strata of the stratified jitter
constexpr float N_LAMBDA = 301.0f;
constexpr unsigned FULL = 0xFFFFFFFFu;
// the ray setup's backward: the twelve ray sums, its second pass's groups
// of blocks and threads (one per group and sum)
constexpr int BWD_SUMS = 12;
constexpr int BWD_GROUPS = 64;
constexpr int BWD_REDUCE_THREADS = BWD_GROUPS * BWD_SUMS;
constexpr unsigned short NO_SLOT = 0xFFFFu;

static_assert(2 * THREADS >= MAX_COLS, "two columns a thread in the scan");
static_assert(MAX_COLS <= (1 << HERO_BITS), "a column index in HERO_BITS");
static_assert(SLOTS_AT >= MAX_COLS + 1 && SLOTS_AT % 4 == 0, "aligned");
static_assert(HERO_BLOCK == 8 * THREADS, "8 rays a thread in pass 1b");

constexpr uint32_t TEA_DELTA = 0x9E3779B9u;
constexpr uint32_t TEA_K0 = 0xA341316Cu, TEA_K1 = 0xC8013EA4u;
constexpr uint32_t TEA_K2 = 0xAD90777Du, TEA_K3 = 0x7E95761Eu;
constexpr uint32_t PCG_A = 1664525u, PCG_C = 1013904223u;

__device__ __forceinline__ uint32_t tea(uint32_t v0, uint32_t v1) {
  uint32_t s0 = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    s0 += TEA_DELTA;
    v0 += ((v1 << 4) + TEA_K0) ^ (v1 + s0) ^ ((v1 >> 5) + TEA_K1);
    v1 += ((v0 << 4) + TEA_K2) ^ (v0 + s0) ^ ((v0 >> 5) + TEA_K3);
  }
  return v0;
}

// One pcg4d advance, the sequential component mixing of ops/rng.py.
__device__ __forceinline__ void pcg4d(uint32_t& x, uint32_t& y, uint32_t& z,
                                      uint32_t& w) {
  x = x * PCG_A + PCG_C;
  y = y * PCG_A + PCG_C;
  z = z * PCG_A + PCG_C;
  w = w * PCG_A + PCG_C;
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
}

// The low 24 bits as a float in [0, 1) (exact).
__device__ __forceinline__ float unit(uint32_t bits) {
  return __fmul_rn((float)(bits & 0x00FFFFFFu), 1.0f / 16777216.0f);
}

// ops/camera.py _normalize: v / sqrt(fma(v2, v2, fma(v1, v1, v0*v0))), the
// JAX package's jnp.linalg.norm as XLA contracts it; returns the norm.
__device__ __forceinline__ float normalize3(float* v) {
  const float n = __fsqrt_rn(
      __fmaf_rn(v[2], v[2], __fmaf_rn(v[1], v[1], __fmul_rn(v[0], v[0]))));
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = __fdiv_rn(v[c], n);
  return n;
}

// ops/camera.py _cross: a1*b2 - a2*b1 as fma(a1, b2, -(a2*b1)), jnp.cross
// as XLA contracts it.
__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* out) {
  out[0] = __fmaf_rn(a[1], b[2], -__fmul_rn(a[2], b[1]));
  out[1] = __fmaf_rn(a[2], b[0], -__fmul_rn(a[0], b[2]));
  out[2] = __fmaf_rn(a[0], b[1], -__fmul_rn(a[1], b[0]));
}

// ops/camera.py film_frame in its op order -> cam: lower_left, horizontal,
// vertical, eye (3 floats each). Halving is exact, so x / 2.0 (the plain
// version's, a product with 0.5 on the card) is x * 0.5 here.
__device__ void film_frame(const float* __restrict__ eye,
                           const float* __restrict__ lookat,
                           const float* __restrict__ up, float fov,
                           float width, float height, float* cam) {
  float e[3], w[3], u[3], v[3], upv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    e[c] = eye[c];
    upv[c] = up[c];
    w[c] = __fsub_rn(e[c], lookat[c]);
  }
  normalize3(w);
  cross3(upv, w, u);
  normalize3(u);
  cross3(w, u, v);
  const float viewport_h = __fmul_rn(2.0f, tanf(__fmul_rn(fov, 0.5f)));
  const float viewport_w = __fmul_rn(__fdiv_rn(width, height), viewport_h);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float hor = __fmul_rn(viewport_w, u[c]);
    const float ver = __fmul_rn(viewport_h, v[c]);
    cam[c] = __fsub_rn(__fsub_rn(__fsub_rn(e[c], __fmul_rn(hor, 0.5f)),
                                 __fmul_rn(ver, 0.5f)),
                       w[c]);
    cam[3 + c] = hor;
    cam[6 + c] = ver;
    cam[9 + c] = e[c];
  }
}

// A ray's film point (s, t) (ops/camera.py _film_st with the stratified
// jitter) and its seed words after the jitter's two draws, s then t.
__device__ __forceinline__ void film_point(long long pxr, long long pyr,
                                           uint32_t sample, float width,
                                           float height, float& s, float& t,
                                           uint32_t* sd) {
  const uint32_t x = (uint32_t)pxr, y = (uint32_t)pyr;
  // seed_pixel: (y, x*100, sample, tea(x, y*100))
  sd[0] = y, sd[1] = x * 100u, sd[2] = sample, sd[3] = tea(x, y * 100u);
  // the jitter: two draws, s then t, in the same stratum on both axes
  pcg4d(sd[0], sd[1], sd[2], sd[3]);
  const float us = unit(sd[0]);
  pcg4d(sd[0], sd[1], sd[2], sd[3]);
  const float ut = unit(sd[0]);
  const float stratum = (float)(sample % GRID_SIZE);
  const float inv_grid = 1.0f / GRID_SIZE;
  const float js = __fmul_rn(__fadd_rn(stratum, us), inv_grid);
  const float jt = __fmul_rn(__fadd_rn(stratum, ut), inv_grid);
  // film coordinates; t runs from the bottom
  s = __fdiv_rn(__fadd_rn(__ll2float_rn(pxr), js), width);
  t = __fdiv_rn(__fadd_rn(__fsub_rn(height, __ll2float_rn(pyr)), jt),
                height);
}

// dv = lower_left + s*horizontal + t*vertical - eye of the frame cam
// (film_frame's layout) -> |dv|.
__device__ __forceinline__ float film_dir(const float* cam, float s, float t,
                                          float* dv) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
    dv[c] = __fsub_rn(__fadd_rn(__fadd_rn(cam[c], __fmul_rn(s, cam[3 + c])),
                                __fmul_rn(t, cam[6 + c])),
                      cam[9 + c]);
  return __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(dv[0], dv[0]), __fmul_rn(dv[1], dv[1])),
      __fmul_rn(dv[2], dv[2])));
}

__global__ void __launch_bounds__(THREADS)
    ray_setup_kernel(const long long* __restrict__ px,
                     const long long* __restrict__ py,
                     const float* __restrict__ eye,
                     const float* __restrict__ lookat,
                     const float* __restrict__ up,
                     const float* __restrict__ fov,
                     const long long* __restrict__ base, long long sample,
                     float width, float height, float* __restrict__ o,
                     float* __restrict__ d, long long* __restrict__ hero,
                     long long* __restrict__ seed, long long R) {
  __shared__ float cam[12];
  if (threadIdx.x == 0)
    film_frame(eye, lookat, up, *fov, width, height, cam);
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < R;
  // the sample's low 32 bits: base + sample, base read from the device
  const uint32_t smp = (uint32_t)(
      (unsigned long long)(base ? __ldg(base) : 0LL) +
      (unsigned long long)sample);
  float s, t;
  uint32_t sd[4];
  film_point(live ? px[r] : 0, live ? py[r] : 0, smp, width, height, s, t,
             sd);
  __syncthreads();  // the frame
  if (!live) return;
  // d = lower_left + s*horizontal + t*vertical - eye, then normalized
  float dv[3];
  const float norm = film_dir(cam, s, t, dv);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c * R + r] = cam[9 + c];
    d[c * R + r] = __fdiv_rn(dv[c], norm);
  }
  // the hero draw
  pcg4d(sd[0], sd[1], sd[2], sd[3]);
  hero[r] = (long long)__fmul_rn(unit(sd[0]), N_LAMBDA);
  seed[r] = sd[0];
  seed[R + r] = sd[1];
  seed[2 * R + r] = sd[2];
  seed[3 * R + r] = sd[3];
}

// a . b, summed in component order
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])),
                   __fmul_rn(a[2], b[2]));
}

// The VJP of a normalization x = v / |v| at its output x and norm n:
// (g - x (x . g)) / n.
__device__ __forceinline__ void normalize3_vjp(const float* x, float n,
                                               const float* g, float* out) {
  const float xg = dot3(x, g);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    out[c] = __fdiv_rn(__fsub_rn(g[c], __fmul_rn(x[c], xg)), n);
}

// The VJP of film_frame from the twelve ray sums S (sum g_o, sum g_u, sum
// s g_u, sum t g_u, 3 each) to the camera: out = d eye (3), d lookat (3),
// d up (3), d fov (1). The rays give eye sum g_o - sum g_u, lower_left
// sum g_u, horizontal sum s g_u, vertical sum t g_u; then lower_left =
// eye - horizontal/2 - vertical/2 - w, horizontal = vw u, vertical = vh v,
// vh = 2 tan(fov/2), vw = (width/height) vh, v = w x u, u = |up x w|^-1
// (up x w), w = |eye - lookat|^-1 (eye - lookat). The basis is recomputed
// as film_frame computes it, and the VJP's crosses fuse as its crosses do;
// every other operation rounds once (kernels/setup.py film_frame_vjp is
// the same code in torch).
__device__ void film_frame_vjp(const float* __restrict__ eye,
                               const float* __restrict__ lookat,
                               const float* __restrict__ up, float fov,
                               float width, float height, const float* S,
                               float* out) {
  float w[3], u[3], v[3], upv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    upv[k] = up[k];
    w[k] = __fsub_rn(eye[k], lookat[k]);
  }
  const float ne = normalize3(w);
  cross3(upv, w, u);
  const float nc = normalize3(u);
  cross3(w, u, v);
  const float th = tanf(__fmul_rn(fov, 0.5f));
  const float vh = __fmul_rn(2.0f, th);
  const float aspect = __fdiv_rn(width, height);
  const float vw = __fmul_rn(aspect, vh);

  float g_eye[3], g_hor[3], g_ver[3], g_w[3], g_u[3], g_v[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float g_ll = S[3 + k];
    g_eye[k] = __fadd_rn(__fsub_rn(S[k], S[3 + k]), g_ll);
    g_hor[k] = __fsub_rn(S[6 + k], __fmul_rn(g_ll, 0.5f));
    g_ver[k] = __fsub_rn(S[9 + k], __fmul_rn(g_ll, 0.5f));
    g_w[k] = -g_ll;
    g_u[k] = __fmul_rn(vw, g_hor[k]);
    g_v[k] = __fmul_rn(vh, g_ver[k]);
  }
  const float g_vw = dot3(g_hor, u);
  const float g_vh = __fadd_rn(dot3(g_ver, v), __fmul_rn(aspect, g_vw));
  const float g_th = __fmul_rn(2.0f, g_vh);
  out[9] = __fmul_rn(__fmul_rn(g_th, __fadd_rn(1.0f, __fmul_rn(th, th))),
                     0.5f);
  // v = w x u
  float t1[3], t2[3];
  cross3(u, g_v, t1);
  cross3(g_v, w, t2);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_w[k] = __fadd_rn(g_w[k], t1[k]);
    g_u[k] = __fadd_rn(g_u[k], t2[k]);
  }
  // u = c / |c|, c = up x w
  float g_c[3];
  normalize3_vjp(u, nc, g_u, g_c);
  cross3(w, g_c, out + 6);
  cross3(g_c, upv, t1);
#pragma unroll
  for (int k = 0; k < 3; ++k) g_w[k] = __fadd_rn(g_w[k], t1[k]);
  // w = e / |e|, e = eye - lookat
  float g_e[3];
  normalize3_vjp(w, ne, g_w, g_e);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out[k] = __fadd_rn(g_eye[k], g_e[k]);
    out[3 + k] = -g_e[k];
  }
}

// Ray r's twelve backward terms at its film point (s, t) of the frame cam:
// g_o, g_u, s g_u, t g_u with g_u = (g_d - d (d . g_d)) / |u|.
__device__ __forceinline__ void ray_terms(const float* cam, float s, float t,
                                          const float* __restrict__ g_o,
                                          const float* __restrict__ g_d,
                                          long long r, long long R,
                                          float* term) {
  float dv[3], dd[3], gd[3];
  const float norm = film_dir(cam, s, t, dv);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dd[c] = __fdiv_rn(dv[c], norm);
    gd[c] = g_d[c * R + r];
    term[c] = g_o[c * R + r];
  }
  const float dg = dot3(dd, gd);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float gu = __fdiv_rn(__fsub_rn(gd[c], __fmul_rn(dd[c], dg)), norm);
    term[3 + c] = gu;
    term[6 + c] = __fmul_rn(s, gu);
    term[9 + c] = __fmul_rn(t, gu);
  }
}

// Pass 1 of the ray setup's backward: one thread per ray recomputes its
// film point and direction as ray_setup_kernel does (the same device code,
// so |u| and d are the forward's bit for bit), reads its cotangents g_o,
// g_d and forms the twelve f32 terms g_o, g_u, s g_u, t g_u with g_u =
// (g_d - d (d . g_d)) / |u|; a ray past R gives zeros. The block sums them
// in f64 in a fixed order: a shuffle tree in each warp (lane i adds lane i
// + h for h = 16, 8, 4, 2, 1), then the warps in order from 0.0, into one
// partial of BWD_SUMS doubles a block.
__global__ void __launch_bounds__(THREADS)
    ray_setup_bwd_kernel(const long long* __restrict__ px,
                         const long long* __restrict__ py,
                         const float* __restrict__ eye,
                         const float* __restrict__ lookat,
                         const float* __restrict__ up,
                         const float* __restrict__ fov, uint32_t sample,
                         float width, float height,
                         const float* __restrict__ g_o,
                         const float* __restrict__ g_d,
                         double* __restrict__ partial, long long R) {
  __shared__ float cam[12];
  __shared__ double warp_sum[WARPS][BWD_SUMS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0)
    film_frame(eye, lookat, up, *fov, width, height, cam);
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < R;
  float s, t;
  uint32_t sd[4];
  film_point(live ? px[r] : 0, live ? py[r] : 0, sample, width, height, s, t,
             sd);
  __syncthreads();  // the frame
  float tf[BWD_SUMS];
  if (live) {
    ray_terms(cam, s, t, g_o, g_d, r, R, tf);
  } else {
#pragma unroll
    for (int k = 0; k < BWD_SUMS; ++k) tf[k] = 0.0f;
  }
  double term[BWD_SUMS];
#pragma unroll
  for (int k = 0; k < BWD_SUMS; ++k) term[k] = (double)tf[k];
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1)
#pragma unroll
    for (int k = 0; k < BWD_SUMS; ++k)
      term[k] = __dadd_rn(term[k], __shfl_down_sync(FULL, term[k], h));
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < BWD_SUMS; ++k) warp_sum[warp][k] = term[k];
  __syncthreads();
  if (threadIdx.x < BWD_SUMS) {
    double acc = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      acc = __dadd_rn(acc, warp_sum[w][threadIdx.x]);
    partial[blockIdx.x * (long long)BWD_SUMS + threadIdx.x] = acc;
  }
}

// Pass 2: the n_blocks partials in BWD_GROUPS groups of ceil(n_blocks /
// BWD_GROUPS) consecutive blocks (the last groups short or empty), each in
// block order from 0.0, one thread per (group, sum); then the groups in
// order from 0.0, each sum rounded once to f32 -> out[0 .. BWD_SUMS); then
// one thread applies film_frame_vjp -> out[BWD_SUMS ..].
__global__ void __launch_bounds__(BWD_REDUCE_THREADS)
    ray_setup_bwd_reduce_kernel(const double* __restrict__ partial,
                                int n_blocks, const float* __restrict__ eye,
                                const float* __restrict__ lookat,
                                const float* __restrict__ up,
                                const float* __restrict__ fov, float width,
                                float height, float* __restrict__ out) {
  __shared__ double group_sum[BWD_GROUPS][BWD_SUMS];
  __shared__ float sums[BWD_SUMS];
  const int tid = threadIdx.x, g = tid / BWD_SUMS, k = tid % BWD_SUMS;
  const int per = (n_blocks + BWD_GROUPS - 1) / BWD_GROUPS;
  const int b0 = min(n_blocks, g * per), b1 = min(n_blocks, b0 + per);
  double acc = 0.0;
#pragma unroll 16
  for (int b = b0; b < b1; ++b)
    acc = __dadd_rn(acc, partial[(long long)b * BWD_SUMS + k]);
  group_sum[g][k] = acc;
  __syncthreads();
  if (tid < BWD_SUMS) {
    double total = 0.0;
    for (int q = 0; q < BWD_GROUPS; ++q)
      total = __dadd_rn(total, group_sum[q][tid]);
    sums[tid] = __double2float_rn(total);
    out[tid] = sums[tid];
  }
  __syncthreads();
  if (tid == 0)
    film_frame_vjp(eye, lookat, up, *fov, width, height, sums,
                   out + BWD_SUMS);
}

// out0[k, r] = t0[k, hero[r]] for k < K0, out1[k, r] = t1[k, hero[r]] for
// k < K1; a hero outside [0, L) gives NaN.
__global__ void __launch_bounds__(THREADS)
    hero_gather_kernel(const float* __restrict__ t0,
                       const float* __restrict__ t1,
                       const long long* __restrict__ hero,
                       float* __restrict__ out0, float* __restrict__ out1,
                       int K0, int K1, int L, long long R) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long h = hero[r];
  const bool valid = h >= 0 && h < L;
  for (int k = 0; k < K0; ++k)
    out0[k * R + r] = valid ? __ldg(t0 + (long long)k * L + h) : NAN;
  for (int k = 0; k < K1; ++k)
    out1[k * R + r] = valid ? __ldg(t1 + (long long)k * L + h) : NAN;
}

// Pass 1a: sort each ray block's rays by hero in shared memory, stably, and
// write the block's column starts (sort[0 .. L], start[l] the first sorted
// slot of column l, start[L] the valid rays) and each ray's sorted slot
// (the u16 words from SLOTS_AT, NO_SLOT for a hero outside [0, L) and for
// the rays past R in the last block).
__global__ void __launch_bounds__(THREADS)
    hero_sort_kernel(const long long* __restrict__ hero,
                     int* __restrict__ sort, int L, long long R) {
  // per warp and column: the warp's count, then its base in the column
  __shared__ __align__(16) unsigned short cnt[WARPS][MAX_COLS];
  __shared__ int col_start[MAX_COLS + 1];
  __shared__ int warp_total[WARPS];
  // each ray's hero (NO_SLOT if outside [0, L)), then its sorted slot
  __shared__ __align__(16) unsigned short slot[HERO_BLOCK];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = (long long)blockIdx.x * HERO_BLOCK;
  const int n = (int)min((long long)HERO_BLOCK, R - base);
  int* start = sort + (long long)blockIdx.x * SORT_WORDS;

  long long hv[SEG_STEPS];
#pragma unroll
  for (int j = 0; j < SEG_STEPS; ++j) {
    const int i = tid + j * THREADS;
    hv[j] = i < n ? hero[base + i] : -1;
  }
#pragma unroll
  for (int j = 0; j < SEG_STEPS; ++j)
    slot[tid + j * THREADS] = hv[j] >= 0 && hv[j] < L ? (unsigned short)hv[j]
                                                      : NO_SLOT;
  for (int i = tid; i < WARPS * MAX_COLS / 2; i += THREADS)
    reinterpret_cast<unsigned*>(&cnt[0][0])[i] = 0u;
  __syncthreads();
  // each warp ranks its segment of 256 rays, 32 a step in ray order: a
  // lane's rank is its hero's count so far plus the lower lanes sharing it
  const unsigned lower = (1u << lane) - 1u;
  int rank[SEG_STEPS];
#pragma unroll
  for (int st = 0; st < SEG_STEPS; ++st) {
    const int h = slot[warp * (SEG_STEPS * 32) + st * 32 + lane];
    // the lanes sharing this lane's hero, from one ballot per bit of the
    // hero (cheaper than __match_any_sync); a lane with no ray or an
    // invalid hero matches no other lane
    unsigned peers = __ballot_sync(FULL, h != NO_SLOT);
#pragma unroll
    for (int bit = 0; bit < HERO_BITS; ++bit) {
      const unsigned ones = __ballot_sync(FULL, (h >> bit) & 1);
      peers &= (h >> bit) & 1 ? ones : ~ones;
    }
    if (h == NO_SLOT) peers = 1u << lane;
    rank[st] = h != NO_SLOT ? cnt[warp][h] + __popc(peers & lower) : 0;
    __syncwarp();
    if (h != NO_SLOT && lane == __ffs(peers) - 1)
      cnt[warp][h] += (unsigned short)__popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // per column (two a thread): each warp's base in the column, an exclusive
  // scan over the warps, and the column's total
  int tot[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int l = 2 * tid + c;
    int run = 0;
    if (l < L)
      for (int w = 0; w < WARPS; ++w) {
        const int x = cnt[w][l];
        cnt[w][l] = (unsigned short)run;
        run += x;
      }
    tot[c] = run;
  }
  // the columns' first slots: an exclusive block scan of the totals
  const int mine = tot[0] + tot[1];
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_total[w];
  const int excl = before + incl - mine;
  if (2 * tid < L) col_start[2 * tid] = start[2 * tid] = excl;
  if (2 * tid + 1 < L) col_start[2 * tid + 1] = start[2 * tid + 1] =
      excl + tot[0];
  if (tid == THREADS - 1) start[L] = excl + mine;
  __syncthreads();
#pragma unroll
  for (int st = 0; st < SEG_STEPS; ++st) {
    const int i = warp * (SEG_STEPS * 32) + st * 32 + lane;
    const int h = slot[i];
    if (h != NO_SLOT)
      slot[i] = (unsigned short)(col_start[h] + cnt[warp][h] + rank[st]);
  }
  __syncthreads();
  uint4* out = reinterpret_cast<uint4*>(sort + (long long)blockIdx.x *
                                        SORT_WORDS + SLOTS_AT);
  const uint4* in = reinterpret_cast<const uint4*>(slot);
  for (int q = tid; q < HERO_BLOCK / 8; q += THREADS) out[q] = in[q];
}

// Pass 1b: partial[b, k, l], the sum of g[k, r] over the rays r of ray
// block b with hero[r] == l, in ray order: one CUDA block per (ray block b,
// SUM_ROWS rows), 8 rays a thread. Each row's 2,048 values are scattered
// into their sorted slots in shared memory, then one thread per column adds
// its slots in order, one chain per row. ~18 KB of shared memory: eight
// CUDA blocks an SM, whose loads and serial sums overlap. vec: 16-byte loads
// of g (R % 4 == 0 and g aligned, so n % 4 == 0 too); else one float at a
// time.
__global__ void __launch_bounds__(THREADS)
    hero_sums_kernel(const float* __restrict__ g,
                     const int* __restrict__ sort,
                     float* __restrict__ partial, int K, int L, long long R,
                     bool vec) {
  __shared__ float gs[SUM_ROWS][HERO_BLOCK];  // the rows in sorted order
  __shared__ int start[MAX_COLS + 1];
  const int tid = threadIdx.x;
  const int b = blockIdx.x, k0 = blockIdx.y * SUM_ROWS;
  const int rows = min(SUM_ROWS, K - k0);
  const long long base = (long long)b * HERO_BLOCK;
  const int n = (int)min((long long)HERO_BLOCK, R - base);
  const int* block_sort = sort + (long long)b * SORT_WORDS;
  const int i = 8 * tid;
  const uint4 sl = __ldg(reinterpret_cast<const uint4*>(block_sort +
                                                        SLOTS_AT) + tid);
  float v[SUM_ROWS][8];
#pragma unroll
  for (int r = 0; r < SUM_ROWS; ++r) {
    if (r >= rows) break;
    const float* row = g + (long long)(k0 + r) * R + base;
    if (vec) {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 a =
          i < n ? __ldg(reinterpret_cast<const float4*>(row + i)) : zero;
      const float4 c =
          i + 4 < n ? __ldg(reinterpret_cast<const float4*>(row + i + 4))
                    : zero;
      v[r][0] = a.x, v[r][1] = a.y, v[r][2] = a.z, v[r][3] = a.w;
      v[r][4] = c.x, v[r][5] = c.y, v[r][6] = c.z, v[r][7] = c.w;
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) v[r][c] = i + c < n ? row[i + c] : 0.0f;
    }
  }
  for (int l = tid; l <= L; l += THREADS) start[l] = __ldg(block_sort + l);
  const unsigned words[4] = {sl.x, sl.y, sl.z, sl.w};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const unsigned s = (words[c / 2] >> (16 * (c % 2))) & 0xFFFFu;
    if (s == NO_SLOT) continue;
#pragma unroll
    for (int r = 0; r < SUM_ROWS; ++r)
      if (r < rows) gs[r][s] = v[r][c];
  }
  __syncthreads();
  for (int l = tid; l < L; l += THREADS) {
    float acc[SUM_ROWS];
#pragma unroll
    for (int r = 0; r < SUM_ROWS; ++r) acc[r] = 0.0f;
    for (int j = start[l]; j < start[l + 1]; ++j)
#pragma unroll
      for (int r = 0; r < SUM_ROWS; ++r) acc[r] = __fadd_rn(acc[r], gs[r][j]);
#pragma unroll
    for (int r = 0; r < SUM_ROWS; ++r)
      if (r < rows) partial[((long long)b * K + k0 + r) * L + l] = acc[r];
  }
}

// Pass 2: out[k, l] = the GROUPS group sums in group order, each the sum of
// its ray blocks' partials in block order. One CUDA block per 32 columns,
// warp w sums group w.
__global__ void __launch_bounds__(THREADS)
    hero_reduce_kernel(const float* __restrict__ partial,
                       float* __restrict__ out, int KL, int n_blocks) {
  __shared__ float group_sum[GROUPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int idx = blockIdx.x * 32 + lane;
  const int per = (n_blocks + GROUPS - 1) / GROUPS;
  const int b0 = warp * per, b1 = min(n_blocks, b0 + per);
  float acc = 0.0f;
  if (idx < KL) {
#pragma unroll 32
    for (int b = b0; b < b1; ++b)
      acc = __fadd_rn(acc, partial[(long long)b * KL + idx]);
  }
  group_sum[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && idx < KL) {
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < GROUPS; ++w)
      total = __fadd_rn(total, group_sum[w][lane]);
    out[idx] = total;
  }
}

// ops/color.py's constants, each the Python number rounded once to f32
constexpr float EXPOSURE = (float)2.2;
constexpr float GAMMA_KNEE = (float)0.0031308;
constexpr float GAMMA_SLOPE = (float)12.92;
constexpr float GAMMA_SCALE = (float)1.055;
constexpr float GAMMA_OFFSET = (float)0.055;
constexpr float GAMMA_POW = (float)(1.0 / 2.4);
constexpr float GAMMA_FLOOR = (float)1e-12;

// torch.clamp's NaN rule: a NaN passes, any other value is clamped
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// One sRGB channel of XYZ (x, y, z) from a row (a, b, c) of the XYZ ->
// linear sRGB matrix: (x*a + y*b) + z*c, 1 - exp(-rgb * EXPOSURE), the
// gamma's linear segment below GAMMA_KNEE, else 1.055 * max(rgb,
// 1e-12)^(1/2.4) - 0.055, clamped to [0, 1].
__device__ __forceinline__ float srgb_channel(float x, float y, float z,
                                              float a, float b, float c) {
  const float lin =
      __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)), __fmul_rn(z, c));
  const float tone = __fsub_rn(1.0f, expf(__fmul_rn(-lin, EXPOSURE)));
  const float lo = __fmul_rn(tone, GAMMA_SLOPE);
  const float hi = __fsub_rn(
      __fmul_rn(GAMMA_SCALE, powf(clamp_min(tone, GAMMA_FLOOR), GAMMA_POW)),
      GAMMA_OFFSET);
  const float v = tone < GAMMA_KNEE ? lo : hi;
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// out[i] = staged[i] for i < n, consecutive threads on consecutive words
__device__ __forceinline__ void store_staged(float* __restrict__ out,
                                             const float* staged, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) out[i] = staged[i];
}

// xyz[c * c_stride + p * p_stride] for components c < 3 and pixels p <
// n_px -> mean and srgb (n_px, 3), and accum (n_px, 3) where not null: one
// thread per pixel. Each block stages its pixels' outputs in shared memory
// and writes each image's 3 x THREADS floats as consecutive words, so that
// a warp's store covers whole sectors (a thread's own three floats, 12
// bytes apart from its neighbours', took three partial stores each).
__global__ void __launch_bounds__(THREADS)
    finish_frame_kernel(const float* __restrict__ xyz, long long c_stride,
                        long long p_stride, float total,
                        float* __restrict__ accum, float* __restrict__ mean,
                        float* __restrict__ srgb, long long n_px) {
  __shared__ float stage[3][3 * THREADS];  // accum, mean, srgb
  const long long p0 = (long long)blockIdx.x * THREADS;
  const long long p = p0 + threadIdx.x;
  const int t3 = 3 * (int)threadIdx.x;
  if (p < n_px) {
    float m[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = __ldg(xyz + c * c_stride + p * p_stride);
      stage[0][t3 + c] = v;
      m[c] = __fdiv_rn(v, total);
      stage[1][t3 + c] = m[c];
    }
    stage[2][t3] = srgb_channel(m[0], m[1], m[2], (float)3.2404542,
                                (float)-1.5371385, (float)-0.4985314);
    stage[2][t3 + 1] = srgb_channel(m[0], m[1], m[2], (float)-0.9692660,
                                    (float)1.8760108, (float)0.0415560);
    stage[2][t3 + 2] = srgb_channel(m[0], m[1], m[2], (float)0.0556434,
                                    (float)-0.2040259, (float)1.0572252);
  }
  __syncthreads();
  const int n = 3 * (int)min((long long)THREADS, n_px - p0);
  if (accum != nullptr) store_staged(accum + 3 * p0, stage[0], n);
  store_staged(mean + 3 * p0, stage[1], n);
  store_staged(srgb + 3 * p0, stage[2], n);
}

bool grid_ok(long long n, long long per_block) {
  return (n + per_block - 1) / per_block <= 0x7fffffffLL;
}

}  // namespace

// px, py (n_rays,) int64 pixel coordinates; eye, lookat, up (3,) and fov ()
// f32, the camera's own tensors; the 1-based sample index is *base + sample,
// or sample where base is null (its low 32 bits are the seed's word; base,
// one int64 on the device, is read by the kernel, so that a captured launch
// renders whatever sample the host wrote there before the replay) -> o, d
// (3, n_rays) f32, hero (n_rays,) int64, seed (4, n_rays) int64 u32 words.
// Returns the CUDA error code of the launch.
extern "C" int ray_setup(const long long* px, const long long* py,
                         const float* eye, const float* lookat,
                         const float* up, const float* fov,
                         const long long* base, long long sample, int width,
                         int height, float* o, float* d, long long* hero,
                         long long* seed, long long n_rays, void* stream) {
  if (n_rays < 0 || width < 1 || height < 1 || !grid_ok(n_rays, THREADS))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const unsigned blocks = (unsigned)((n_rays + THREADS - 1) / THREADS);
  ray_setup_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      px, py, eye, lookat, up, fov, base, sample, (float)width,
      (float)height, o, d, hero, seed, n_rays);
  return (int)cudaGetLastError();
}

// The ray setup's backward for the rays of ray_setup's arguments (px, py,
// the camera's tensors, sample, width, height) and their cotangents g_o,
// g_d (3, n_rays) f32 -> out (BWD_SUMS + 10) f32: the twelve ray sums in
// the fixed order, then d eye (3), d lookat (3), d up (3), d fov (1).
// partial: scratch of ceil(n_rays / THREADS) x BWD_SUMS f64. Two launches;
// returns the CUDA error code.
extern "C" int ray_setup_bwd(const long long* px, const long long* py,
                             const float* eye, const float* lookat,
                             const float* up, const float* fov,
                             long long sample, int width, int height,
                             const float* g_o, const float* g_d,
                             double* partial, float* out, long long n_rays,
                             void* stream) {
  if (n_rays < 0 || width < 1 || height < 1 || !grid_ok(n_rays, THREADS))
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = (n_rays + THREADS - 1) / THREADS;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_blocks > 0) {
    ray_setup_bwd_kernel<<<(unsigned)n_blocks, THREADS, 0, st>>>(
        px, py, eye, lookat, up, fov, (uint32_t)sample, (float)width,
        (float)height, g_o, g_d, partial, n_rays);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  ray_setup_bwd_reduce_kernel<<<1, BWD_REDUCE_THREADS, 0, st>>>(
      partial, (int)n_blocks, eye, lookat, up, fov, (float)width,
      (float)height, out);
  return (int)cudaGetLastError();
}

// t0 (n_rows0, n_cols), t1 (n_rows1, n_cols) f32 (t1 unread when n_rows1 is
// 0), hero (n_rays,) int64 -> out0 (n_rows0, n_rays), out1 (n_rows1, n_rays):
// one launch for both tables.
extern "C" int hero_gather(const float* t0, const float* t1,
                           const long long* hero, float* out0, float* out1,
                           int n_rows0, int n_rows1, int n_cols,
                           long long n_rays, void* stream) {
  if (n_rays < 0 || n_rows0 < 0 || n_rows1 < 0 || n_cols < 1 ||
      !grid_ok(n_rays, THREADS))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0 || n_rows0 + n_rows1 == 0) return 0;
  const unsigned blocks = (unsigned)((n_rays + THREADS - 1) / THREADS);
  hero_gather_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      t0, t1, hero, out0, out1, n_rows0, n_rows1, n_cols, n_rays);
  return (int)cudaGetLastError();
}

// g (n_rows, n_rays) f32, hero (n_rays,) int64 -> out (n_rows, n_cols), the
// column sums in the fixed order; sort, scratch of ceil(n_rays / block) x
// SORT_WORDS ints, and partial, of (ceil(n_rays / block), n_rows, n_cols)
// f32, where block, the caller's rays per block, must be HERO_BLOCK.
// Returns the CUDA error code of the launches.
extern "C" int hero_column_sums(const float* g, const long long* hero,
                                int* sort, float* partial, float* out,
                                int n_rows, int n_cols, long long n_rays,
                                int block, void* stream) {
  if (block != HERO_BLOCK || n_rays < 1 || n_rows < 1 || n_cols < 1 ||
      n_cols > MAX_COLS || n_rows > 65535 || !grid_ok(n_rays, HERO_BLOCK) ||
      (long long)n_rows * n_cols > 0x7fffffffLL - 32)
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = (n_rays + HERO_BLOCK - 1) / HERO_BLOCK;
  const bool vec = n_rays % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  hero_sort_kernel<<<(unsigned)n_blocks, THREADS, 0, st>>>(hero, sort,
                                                           n_cols, n_rays);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  hero_sums_kernel<<<dim3((unsigned)n_blocks,
                          (unsigned)((n_rows + SUM_ROWS - 1) / SUM_ROWS)),
                     THREADS, 0, st>>>(g, sort, partial, n_rows, n_cols,
                                       n_rays, vec);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int kl = n_rows * n_cols;
  hero_reduce_kernel<<<(kl + 31) / 32, THREADS, 0, st>>>(partial, out, kl,
                                                         (int)n_blocks);
  return (int)cudaGetLastError();
}

// A frame's XYZ sum xyz, component c of pixel p at xyz[c * c_stride + p *
// p_stride], and its sample count total -> mean and srgb (n_px, 3) f32,
// and accum (n_px, 3) where not null (a copy of the sum). Returns the CUDA
// error code of the launch.
extern "C" int finish_frame(const float* xyz, long long c_stride,
                            long long p_stride, float total, float* accum,
                            float* mean, float* srgb, long long n_px,
                            void* stream) {
  if (n_px < 0 || c_stride < 0 || p_stride < 0 || !(total > 0.0f) ||
      !grid_ok(n_px, THREADS))
    return (int)cudaErrorInvalidValue;
  if (n_px == 0) return 0;
  const unsigned blocks = (unsigned)((n_px + THREADS - 1) / THREADS);
  finish_frame_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      xyz, c_stride, p_stride, total, accum, mean, srgb, n_px);
  return (int)cudaGetLastError();
}
