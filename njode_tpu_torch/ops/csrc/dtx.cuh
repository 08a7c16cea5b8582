// The weight gradients' sum d^T x over (step, row) records, shared by the
// NJODE K2 (stage (c), njode_wgrad_kernel, fused_scan.cu) and the
// GRU-ODE-Bayes K6 (stage (c), gob_wgrad_kernel, fused_gob.cu): each
// library's kernel reads its own tile and job tables and calls dtx_tile.
//
// A CTA owns one output tile [DTX_TILE, DTX_TILE] of a leaf (rows j0.. of
// its `out`, columns i0.. of its `in`; column `in` its bias where bias >=
// 0, x a column of ones) and one stretch [r0, r1) of the records. It sums
// d[j] x[i] for each of the tile's jobs in job order, then record order,
// one fp32 FMA chain an output, so the order is the libraries' own and
// depends on nothing but the stretch. DTX_NT threads hold DTX_TJ x DTX_TI
// outputs each; DTX_STAGES blocks of DTX_TILE records are in flight
// through cp.async into shared memory (4-byte copies: the fields start at
// any float), so the loads of the blocks ahead overlap the FMAs of this
// one. The defaults, 2 x 4 outputs (128 threads) and four blocks, were the
// fastest or within 2 % of it at the main path's and GOB's shapes of the
// variants scripts/tune_dtx.py times (PERF.md); it builds them by defining
// DTX_TI, DTX_TJ and DTX_STAGES before the include. Every variant gives
// the same bits.

#pragma once

#define DTX_TILE 32            // an output tile [32, 32]; a block of 32 records
#ifndef DTX_TI
#define DTX_TI 2               // output columns (i) a thread
#endif
#ifndef DTX_TJ
#define DTX_TJ 4               // output rows (j) a thread
#endif
#ifndef DTX_STAGES
#define DTX_STAGES 4           // record blocks in flight
#endif
#define DTX_NT ((DTX_TILE / DTX_TI) * (DTX_TILE / DTX_TJ))  // threads a CTA

// one output tile: the weight leaf's offset, its columns and rows, the
// tile's first column i0 and row j0, its first job and job count, its
// bias's offset or -1 (a bias of its own leaf is a tile with in = 1 whose
// jobs have no x)
struct DtxTile {
  int loff, in, out, i0, j0, jf, jn, bias;
};

// one job: x (nullptr: a column of ones) and d of record r at x + r * xs
// and d + r * ds
struct DtxJob {
  const float* x;
  int xs;
  const float* d;
  int ds;
};

__device__ __forceinline__ void dtx_cp4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void dtx_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// until at most N of this thread's newest copy groups are pending
template <int N>
__device__ __forceinline__ void dtx_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// n consecutive floats of shared memory at p (16-byte aligned for 4)
template <int N>
__device__ __forceinline__ void dtx_get(const float* p, float* o) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    o[0] = v.x; o[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) o[q] = p[q];
  }
}

// Sums tile t over records [r0, r1) of the jobs job_at(t.jf) ..
// job_at(t.jf + t.jn - 1) and writes the sums to P (acc: adds them), the
// weight's element (j, i) at P[t.loff + j * in + i] (out_major) or
// P[t.loff + i * out + j], its bias's j at P[t.bias + j].
template <class JobAt>
__device__ __forceinline__ void dtx_tile(const DtxTile& t, JobAt job_at,
                                         int r0, int r1, float* P,
                                         bool out_major, bool acc) {
  constexpr int LR = DTX_NT / DTX_TILE;     // rows a pass of the threads
  __shared__ __align__(16) float xs[DTX_STAGES][DTX_TILE][DTX_TILE];
  __shared__ __align__(16) float ds[DTX_STAGES][DTX_TILE][DTX_TILE];
  const int tid = threadIdx.x;
  // loads: column c of rows lr, lr + LR, .. of a block; FMAs: columns
  // TI tx .. of x against rows TJ ty .. of d
  const int c = tid % DTX_TILE, lr = tid / DTX_TILE;
  const int tx = tid % (DTX_TILE / DTX_TI), ty = tid / (DTX_TILE / DTX_TI);
  const int nbj = r1 > r0 ? (r1 - r0 + DTX_TILE - 1) / DTX_TILE : 0;
  const int nblk = t.jn * nbj;
  const int i = t.i0 + c, j = t.j0 + c;
  auto load = [&](int b, int slot) {
    const DtxJob q = job_at(t.jf + b / nbj);
    const int rb = r0 + (b % nbj) * DTX_TILE, nr = min(DTX_TILE, r1 - rb);
    const float* xp = q.x && i < t.in
        ? q.x + i + (size_t)(rb + lr) * q.xs : nullptr;
    const float* dp = j < t.out ? q.d + j + (size_t)(rb + lr) * q.ds
                                : nullptr;
    const float one = (!q.x && i < t.in) || (i == t.in && t.bias >= 0)
                          ? 1.f : 0.f;
    const size_t xstep = (size_t)LR * q.xs, dstep = (size_t)LR * q.ds;
#pragma unroll
    for (int rr = lr; rr < DTX_TILE; rr += LR) {
      const bool ok = rr < nr;
      if (ok && xp) dtx_cp4(&xs[slot][rr][c], xp);
      else xs[slot][rr][c] = ok ? one : 0.f;
      if (ok && dp) dtx_cp4(&ds[slot][rr][c], dp);
      else ds[slot][rr][c] = 0.f;
      if (xp) xp += xstep;
      if (dp) dp += dstep;
    }
  };
  float a[DTX_TJ][DTX_TI];
#pragma unroll
  for (int q = 0; q < DTX_TJ; ++q)
#pragma unroll
    for (int p = 0; p < DTX_TI; ++p) a[q][p] = 0.f;
  for (int b = 0; b < DTX_STAGES - 1; ++b) {
    if (b < nblk) load(b, b);
    dtx_commit();
  }
  for (int b = 0; b < nblk; ++b) {
    dtx_wait<DTX_STAGES - 2>();
    __syncthreads();
    // the slot of block b - 1, which every thread has left
    const int nb = b + DTX_STAGES - 1;
    if (nb < nblk) load(nb, nb % DTX_STAGES);
    dtx_commit();
    const int slot = b % DTX_STAGES;
#pragma unroll 8
    for (int kk = 0; kk < DTX_TILE; ++kk) {
      float xa[DTX_TI], da[DTX_TJ];
      dtx_get<DTX_TI>(&xs[slot][kk][DTX_TI * tx], xa);
      dtx_get<DTX_TJ>(&ds[slot][kk][DTX_TJ * ty], da);
#pragma unroll
      for (int q = 0; q < DTX_TJ; ++q)
#pragma unroll
        for (int p = 0; p < DTX_TI; ++p)
          a[q][p] = fmaf(da[q], xa[p], a[q][p]);
    }
  }
#pragma unroll
  for (int q = 0; q < DTX_TJ; ++q) {
    const int jj = t.j0 + DTX_TJ * ty + q;
    if (jj >= t.out) continue;
#pragma unroll
    for (int p = 0; p < DTX_TI; ++p) {
      const int ii = t.i0 + DTX_TI * tx + p;
      float* o = ii < t.in
          ? P + t.loff + (out_major ? (size_t)jj * t.in + ii
                                    : (size_t)ii * t.out + jj)
          : ii == t.in && t.bias >= 0 ? P + t.bias + jj : nullptr;
      if (o) *o = acc ? *o + a[q][p] : a[q][p];
    }
  }
}
