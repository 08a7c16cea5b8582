// Counter-based dropout keep-masks shared by the NJODE kernels (K4,
// fused_scan.cu) and the GRU-ODE-Bayes kernels (K7, fused_gob.cu), so both
// kernel families draw masks one way.
//
// Random123's Philox4x32-10 with key (seed_lo, seed_hi) and counter
// (col >> 2, global_row, k, slot); the mask bit of column col is word
// col & 3, kept iff word < thresh (unsigned). So one draw gives the four
// columns of a quad (philox_keep4). The counter depends only on the global
// row and column, never on the CTA split or the layer width, so a backward
// kernel redraws its forward's masks. ops/fused_scan.py's
// philox_keep_plain is the same function in PyTorch.
//
// The scan kernels keep a step's masks as bits in shared memory (mask
// words: 32 columns a word, column c at bit c & 31 of word c >> 5 of its
// row and slot), filled ahead by threads a phase leaves idle: where they
// are many, eight lanes a word, a draw each (lanes_word), else a word a
// thread, its eight draws.

#pragma once

#include <stdint.h>

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    if (i) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// the keep bits of columns 4q .. 4q + 3 (bit i: column 4q + i) of one draw
__device__ __forceinline__ uint32_t philox_keep4(uint32_t k0, uint32_t k1,
                                                 uint32_t thresh, int q,
                                                 int grow, int k, int slot) {
  uint4 r = philox4x32_10(make_uint4((uint32_t)q, (uint32_t)grow,
                                     (uint32_t)k, (uint32_t)slot), k0, k1);
  return (uint32_t)(r.x < thresh) | (uint32_t)(r.y < thresh) << 1
         | (uint32_t)(r.z < thresh) << 2 | (uint32_t)(r.w < thresh) << 3;
}

// the keep bits of quad q (columns 4q .. 4q + 3 below `width`) of one row
// and slot of step k: a draw ('prng', mode 2) or the bytes of the input
// masks at u ('input', mode 1; u points at the row's column 0)
__device__ __forceinline__ uint32_t quad_bits(int mode, const int8_t* u,
                                              uint32_t k0, uint32_t k1,
                                              uint32_t thresh, int q,
                                              int width, int grow, int k,
                                              int slot) {
  const int c0 = 4 * q;
  if (c0 >= width) return 0u;
  if (mode == 2) return philox_keep4(k0, k1, thresh, q, grow, k, slot);
  uint32_t bits = 0u;
  for (int i = 0; i < 4 && c0 + i < width; ++i)
    bits |= (uint32_t)(u[c0 + i] != 0) << i;
  return bits;
}

// The word of eight lanes that run this together, lane j (threadIdx.x &
// 7) giving `nib`, the keep bits of the word's quad j: returned to all.
__device__ __forceinline__ uint32_t lanes_word(uint32_t nib) {
  return __reduce_or_sync(0xFFu << (threadIdx.x & 24),
                          nib << (4 * (threadIdx.x & 7)));
}

// The keep-masks [K, S, B, W] int8 of K steps, the bytes of row y = (k *
// S + slot) * B + b at y * W: thread (x, y) of a block (bx, by) draws quad
// x (and x + bx, ...) of row y, and the rows stride over the grid (y, then
// y + gridDim.y * by, ...); the stride's (b, slot, k) are added with
// carries, so a row costs no division.
__device__ __forceinline__ void philox_mask_rows(const long long* seed,
                                                 int K, int S, int B, int W,
                                                 uint32_t thresh,
                                                 int8_t* out) {
  const unsigned long long s = (unsigned long long)seed[0];
  const uint32_t k0 = (uint32_t)(s & 0xFFFFFFFFull), k1 = (uint32_t)(s >> 32);
  const int nq = (W + 3) >> 2, rows = K * S * B;
  const int stride = (int)(gridDim.y * blockDim.y);
  int y = (int)(blockIdx.y * blockDim.y + threadIdx.y);
  int b = y % B, t = y / B, slot = t % S, k = t / S;
  const int db = stride % B, ts = stride / B, dslot = ts % S, dk = ts / S;
  for (; y < rows; y += stride) {
    int8_t* o = out + (size_t)y * W;
    for (int q = (int)threadIdx.x; q < nq; q += (int)blockDim.x) {
      const uint32_t bits = philox_keep4(k0, k1, thresh, q, b, k, slot);
      const int c0 = 4 * q;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (c0 + i < W) o[c0 + i] = (int8_t)((bits >> i) & 1u);
    }
    b += db;
    slot += dslot;
    k += dk;
    if (b >= B) { b -= B; ++slot; }
    if (slot >= S) { slot -= S; ++k; }
  }
}

// The launch of a philox_mask_rows kernel: bx a power of two that covers
// a row's quads (at most 32), 256 threads a block, at most eight blocks an
// SM (the grid's rows then stride).
template <class Kern>
static cudaError_t launch_mask_rows(Kern kern, const long long* seed, int K,
                                    int S, int B, int W, unsigned thresh,
                                    int8_t* out, cudaStream_t st) {
  const long long rows = (long long)K * S * B;
  if (rows <= 0 || W <= 0) return cudaSuccess;
  if (rows > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const int nq = (W + 3) / 4;
  int bx = 1;
  while (bx < nq && bx < 32) bx <<= 1;
  const int by = 256 / bx;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long need = (rows + by - 1) / by;
  const int gy = (int)(need < 8LL * sms ? need : 8LL * sms);
  kern<<<dim3(1, gy), dim3(bx, by), 0, st>>>(seed, K, S, B, W, thresh, out);
  return cudaGetLastError();
}
