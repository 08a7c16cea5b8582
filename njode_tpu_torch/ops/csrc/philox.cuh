// Counter-based dropout keep-masks shared by the NJODE kernels (K4,
// fused_scan.cu) and the GRU-ODE-Bayes kernels (K7, fused_gob.cu), so both
// kernel families draw masks one way.
//
// Random123's Philox4x32-10 with key (seed_lo, seed_hi) and counter
// (col >> 2, global_row, k, slot); the mask bit of column col is word
// col & 3, kept iff word < thresh (unsigned). The counter depends only on
// the global row and column, never on the CTA split or the layer width, so
// a backward kernel redraws its forward's masks. ops/fused_scan.py's
// philox_keep_plain is the same function in PyTorch.

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

__device__ __forceinline__ bool philox_keep(uint32_t k0, uint32_t k1,
                                            uint32_t thresh, int col,
                                            int grow, int k, int slot) {
  uint4 r = philox4x32_10(make_uint4((uint32_t)col >> 2, (uint32_t)grow,
                                     (uint32_t)k, (uint32_t)slot), k0, k1);
  int w = col & 3;
  uint32_t word = w == 0 ? r.x : (w == 1 ? r.y : (w == 2 ? r.z : r.w));
  return word < thresh;          // unsigned compare
}
