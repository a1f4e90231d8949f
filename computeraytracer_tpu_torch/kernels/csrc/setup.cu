// The per-sample setup of the kernel path for Hopper (sm_90a): the camera
// rays, seeds and hero draw of every ray (ray_setup), and the hero-indexed
// column gather of the spectra and CIE tables with its backward
// (hero_gather, hero_column_sums).
//
// Replaces the setup that the JAX package runs as one jitted XLA computation
// around its Pallas kernels:
// - ray_setup: computeraytracer_tpu/tracer/pallas.py:708-712, rng.seed_pixel_p
//   -> camera_ops.camera_rays_p -> spectrum.sample_wavelengths_p;
// - hero_gather: computeraytracer_tpu/ops/spectrum.py:121 gather_hero_planar;
// - hero_column_sums: its scatter-free backward, spectrum.py:246 take_cols'
//   VJP (a one-hot contraction summed over blocks of rays, _chunked).
//
// ray_setup: one thread per ray. It reads 16 bytes a ray (px, py) and writes
// 64 (o, d, hero, seed), and its 16 TEA rounds and three pcg4d draws are u32
// arithmetic: the bytes bound it, the card's integer rate close behind.
// Every float operation is the plain version's (kernels/setup.py
// ray_setup_reference) in its order, each rounded once (--fmad=false,
// __f*_rn): the outputs are the plain version's bit for bit.
//
// hero_gather: one thread per ray reads its hero and writes its column of
// every row; the table (K x 301 floats, ~29 KB for K = 24) stays in L1/L2.
// It moves the (K, R) output and the hero indices: bytes bound it.
//
// hero_column_sums: d_table[k, l] = the sum of g[k, r] over the rays r with
// hero[r] == l, without float atomics, in a fixed order: within each block of
// HERO_BLOCK consecutive rays in ray order, then over the blocks in block
// order. Pass 1 (one CUDA block per ray block) sorts the block's rays by hero
// in shared memory, stably (integer counts, then one warp ranks the rays in
// order with __match_any_sync), stages g a tile of KT rows at a time, and one
// thread per (row, column) sums its column's rays in ray order into the
// block's (K, L) partial. Pass 2 adds the partials of each (row, column) in
// block order. g (K x R floats) is read once: bytes bound it. Two launches
// give bit-equal sums, and the plain version (setup.py
// hero_column_sums_reference: a stable sort and two sequential segment sums)
// adds in the same order.
//
// Numerics: --fmad=false, as every kernel of the port.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int HERO_BLOCK = 2048;  // rays per block of the backward's pass 1
constexpr int KT = 4;             // rows of g staged at a time
constexpr int MAX_COLS = 512;     // table columns (301 wavelengths)
constexpr int GRID_SIZE = 16;     // strata of the stratified jitter
constexpr float N_LAMBDA = 301.0f;

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

// cam: lower_left, horizontal, vertical, eye (3 floats each).
__global__ void __launch_bounds__(THREADS)
    ray_setup_kernel(const long long* __restrict__ px,
                     const long long* __restrict__ py,
                     const float* __restrict__ cam, uint32_t sample,
                     float width, float height, float* __restrict__ o,
                     float* __restrict__ d, long long* __restrict__ hero,
                     long long* __restrict__ seed, long long R) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long pxr = px[r], pyr = py[r];
  const uint32_t x = (uint32_t)pxr, y = (uint32_t)pyr;
  // seed_pixel: (y, x*100, sample, tea(x, y*100))
  uint32_t s0 = y, s1 = x * 100u, s2 = sample, s3 = tea(x, y * 100u);
  // the jitter: two draws, s then t, in the same stratum on both axes
  pcg4d(s0, s1, s2, s3);
  const float us = unit(s0);
  pcg4d(s0, s1, s2, s3);
  const float ut = unit(s0);
  const float stratum = (float)(sample % GRID_SIZE);
  const float inv_grid = 1.0f / GRID_SIZE;
  const float js = __fmul_rn(__fadd_rn(stratum, us), inv_grid);
  const float jt = __fmul_rn(__fadd_rn(stratum, ut), inv_grid);
  // film coordinates; t runs from the bottom
  const float s = __fdiv_rn(__fadd_rn(__ll2float_rn(pxr), js), width);
  const float t = __fdiv_rn(
      __fadd_rn(__fsub_rn(height, __ll2float_rn(pyr)), jt), height);
  // d = lower_left + s*horizontal + t*vertical - eye, then normalized
  float dv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    dv[c] = __fsub_rn(__fadd_rn(__fadd_rn(cam[c], __fmul_rn(s, cam[3 + c])),
                                __fmul_rn(t, cam[6 + c])),
                      cam[9 + c]);
  const float norm = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(dv[0], dv[0]), __fmul_rn(dv[1], dv[1])),
      __fmul_rn(dv[2], dv[2])));
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o[c * R + r] = cam[9 + c];
    d[c * R + r] = __fdiv_rn(dv[c], norm);
  }
  // the hero draw
  pcg4d(s0, s1, s2, s3);
  hero[r] = (long long)__fmul_rn(unit(s0), N_LAMBDA);
  seed[r] = s0;
  seed[R + r] = s1;
  seed[2 * R + r] = s2;
  seed[3 * R + r] = s3;
}

// out[k, r] = table[k, hero[r]]; a hero outside [0, L) gives NaN.
__global__ void __launch_bounds__(THREADS)
    hero_gather_kernel(const float* __restrict__ table,
                       const long long* __restrict__ hero,
                       float* __restrict__ out, int K, int L, long long R) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const long long h = hero[r];
  const bool valid = h >= 0 && h < L;
  for (int k = 0; k < K; ++k)
    out[k * R + r] = valid ? __ldg(table + (long long)k * L + h) : NAN;
}

// Pass 1: partial[b, k, l], the sum of g[k, r] over the rays r of ray block
// b with hero[r] == l, in ray order. A hero outside [0, L) is skipped.
__global__ void __launch_bounds__(THREADS)
    hero_partials_kernel(const float* __restrict__ g,
                         const long long* __restrict__ hero,
                         float* __restrict__ partial, int K, int L,
                         long long R) {
  __shared__ short hs[HERO_BLOCK];               // each ray's hero, or -1
  __shared__ unsigned short order[HERO_BLOCK];   // rays sorted by hero
  __shared__ int start[MAX_COLS + 1];            // each column's first slot
  __shared__ int cursor[MAX_COLS];
  __shared__ float gs[KT][HERO_BLOCK];
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * HERO_BLOCK;
  const int n = (int)min((long long)HERO_BLOCK, R - base);

  for (int l = tid; l <= L; l += THREADS) start[l] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += THREADS) {
    const long long h = hero[base + i];
    const bool valid = h >= 0 && h < L;
    hs[i] = valid ? (short)h : (short)-1;
    if (valid) atomicAdd(&start[h + 1], 1);  // integer counts
  }
  __syncthreads();
  if (tid == 0)
    for (int l = 0; l < L; ++l) start[l + 1] += start[l];
  __syncthreads();
  for (int l = tid; l < L; l += THREADS) cursor[l] = start[l];
  __syncthreads();
  // one warp places the rays in ray order: 32 at a time, each lane after
  // the lower lanes of its hero and the earlier steps' rays
  if (tid < 32) {
    const unsigned lower = (1u << tid) - 1u;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + tid;
      const int h = i < n ? hs[i] : -1;
      // lanes with no ray or an invalid hero match no lane with a ray
      const int key = h >= 0 ? h : -2 - tid;
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, key);
      const int leader = __ffs(peers) - 1;
      int pos = h >= 0 && tid == leader ? cursor[h] : 0;
      pos = __shfl_sync(0xFFFFFFFFu, pos, leader);
      if (h >= 0) order[pos + __popc(peers & lower)] = (unsigned short)i;
      __syncwarp();
      if (h >= 0 && tid == leader) cursor[h] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();

  for (int k0 = 0; k0 < K; k0 += KT) {
    const int kt = min(KT, K - k0);
    for (int kk = 0; kk < kt; ++kk)
      for (int i = tid; i < n; i += THREADS)
        gs[kk][i] = g[(long long)(k0 + kk) * R + base + i];
    __syncthreads();
    for (int item = tid; item < kt * L; item += THREADS) {
      const int kk = item / L, l = item - kk * L;
      float acc = 0.0f;
      for (int j = start[l]; j < start[l + 1]; ++j)
        acc = __fadd_rn(acc, gs[kk][order[j]]);
      partial[((long long)blockIdx.x * K + k0 + kk) * L + l] = acc;
    }
    __syncthreads();
  }
}

// Pass 2: out[k, l] = the sum over ray blocks, in block order.
__global__ void __launch_bounds__(THREADS)
    hero_reduce_kernel(const float* __restrict__ partial,
                       float* __restrict__ out, int KL, int n_blocks) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= KL) return;
  float acc = 0.0f;
#pragma unroll 8
  for (int b = 0; b < n_blocks; ++b)
    acc = __fadd_rn(acc, partial[(long long)b * KL + idx]);
  out[idx] = acc;
}

bool grid_ok(long long n, long long per_block) {
  return (n + per_block - 1) / per_block <= 0x7fffffffLL;
}

}  // namespace

// px, py (n_rays,) int64 pixel coordinates; cam (12,) f32 [lower_left,
// horizontal, vertical, eye] of ops/camera.py film_frame; sample the 1-based
// sample index (its low 32 bits are the seed's word) -> o, d (3, n_rays) f32,
// hero (n_rays,) int64, seed (4, n_rays) int64 u32 words. Returns the CUDA
// error code of the launch.
extern "C" int ray_setup(const long long* px, const long long* py,
                         const float* cam, long long sample, int width,
                         int height, float* o, float* d, long long* hero,
                         long long* seed, long long n_rays, void* stream) {
  if (n_rays < 0 || width < 1 || height < 1 || !grid_ok(n_rays, THREADS))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const unsigned blocks = (unsigned)((n_rays + THREADS - 1) / THREADS);
  ray_setup_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      px, py, cam, (uint32_t)sample, (float)width, (float)height, o, d, hero,
      seed, n_rays);
  return (int)cudaGetLastError();
}

// table (n_rows, n_cols) f32, hero (n_rays,) int64 -> out (n_rows, n_rays).
extern "C" int hero_gather(const float* table, const long long* hero,
                           float* out, int n_rows, int n_cols,
                           long long n_rays, void* stream) {
  if (n_rays < 0 || n_rows < 0 || n_cols < 1 || !grid_ok(n_rays, THREADS))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0 || n_rows == 0) return 0;
  const unsigned blocks = (unsigned)((n_rays + THREADS - 1) / THREADS);
  hero_gather_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      table, hero, out, n_rows, n_cols, n_rays);
  return (int)cudaGetLastError();
}

// g (n_rows, n_rays) f32, hero (n_rays,) int64 -> out (n_rows, n_cols), the
// column sums in the fixed order; partial, scratch of (ceil(n_rays /
// block), n_rows, n_cols) f32, where block, the caller's rays per block, must
// be HERO_BLOCK. Returns the CUDA error code of the launches.
extern "C" int hero_column_sums(const float* g, const long long* hero,
                                float* partial, float* out, int n_rows,
                                int n_cols, long long n_rays, int block,
                                void* stream) {
  if (block != HERO_BLOCK || n_rays < 1 || n_rows < 1 || n_cols < 1 ||
      n_cols > MAX_COLS || !grid_ok(n_rays, HERO_BLOCK) ||
      (long long)n_rows * n_cols > 0x7fffffffLL - THREADS)
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = (n_rays + HERO_BLOCK - 1) / HERO_BLOCK;
  cudaStream_t st = (cudaStream_t)stream;
  hero_partials_kernel<<<(unsigned)n_blocks, THREADS, 0, st>>>(
      g, hero, partial, n_rows, n_cols, n_rays);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int kl = n_rows * n_cols;
  hero_reduce_kernel<<<(kl + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      partial, out, kl, (int)n_blocks);
  return (int)cudaGetLastError();
}
