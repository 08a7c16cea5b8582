// Hand-written Hopper kernels for the GRU-ODE-Bayes training scan (sm_90a).
//
// Replaces the Pallas TPU kernels of njode_tpu/ops/fused_gob.py:
//   gob_scan_fwd_kernel<true>   K5  _fwd_impl / _make_fwd_kernel (training
//                                   forward: loss and step-entry histories)
//   gob_scan_fwd_kernel<false>  K5  eval form (_make_fwd_kernel, want_hists
//                                   False: loss only, no dropout)
//   gob_scan_bwd_kernel         K6  _fused_bwd / _make_bwd_kernel (BPTT)
//   philox_keep (philox.cuh)    K7  _step_masks (p_model keep-masks, 3
//                                   slots per step: ode-midpoint,
//                                   ode-final, post-jump)
// The per-CTA loss and gradient partials are summed by reduce_partials in
// fused_scan.cu, in a fixed order (no float atomics: runs repeat bit for
// bit).
//
// Design. The scan is K sequential steps of small dependent matmuls over
// the state (h, mean, var) of ROWS batch rows; one CTA owns ROWS rows and
// walks all K steps itself. The weights do not fit shared memory at the
// published widths (409 KB of fp32 leaves at hidden 100, 105 KB at 50),
// so they stay in device memory and are read through L1/L2 (they fit L2
// easily); shared memory holds only the rows' carries and each step's
// activations (132 KB for the backward at hidden 100). Each matmul
// is fp32 FMA with one thread per (row, output column) and a
// __syncthreads after every phase. The backward re-materialises each step
// from its step-entry carries, walks k = K-1..0, and adds every weight
// gradient to the CTA's own partial row in device memory: an entry is
// only ever updated by the one thread the loop maps it to, so no atomics
// are needed.
//
// Bound on this card. About 28,250 MACs per row-step forward at hidden 50
// (111,000 at 100): at B = 20, K = 100 a forward is 113 MFLOP, under 2 us
// at the 67 TFLOP/s fp32 peak, and the bytes (histories, inputs, weights
// once) are under 1 MB. What limits these kernels is latency: a chain of
// K steps of ~40 dependent phases each, on ceil(B/ROWS) of the 132 SMs.
// This first version is simple and exact; tensor cores, overlapping the
// independent products and a faster gradient accumulation are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"          // K7: philox_keep

#define ROWS 8
#define NTHREADS 256
#define MAX_LEAVES 40

// Mirrored field by field by ops/fused_gob.py::_GobCfg (all 4-byte fields).
// Leaf slots hold the index of a weight in the flat leaf list, -1 if absent:
//   pm   p_model W0 [H,P], b0, Wm [P,D], bm, Wv [P,D], bv
//   fxm/fxv/fxb  input-projection blocks of the propagation cell, per gate
//        (mean part [D,H], var part [D,H], bias [1,H]): gates r, z, h of
//        the full field; z, n of the minimal field; r, z, n of the
//        discretized GRU cell
//   fh   the cell's hidden matrices [H,H] (full: Whr, Whz, Whh; minimal:
//        Whz, Whn; discretized: w_hh per gate); fhb its hidden biases
//   wp   the packed prep blocks [D, D*prep] (X, mean, feat2, error); bp
//        bias_prep [1, D*prep]; ih/hh/bih/bhh the observation GRU per gate
struct GobCfg {
  int K, B, D, H, P, DP, prep, n_params, n_leaves;
  int full, impute, logvar, prop, bias, mode;  // prop 0 euler 1 mid 2 disc
  unsigned int thresh;
  float keep, mixing;
  int rows, fwd_floats, smem_floats;
  int leaf_off[MAX_LEAVES + 1];
  int pm[6];
  int fxm[3], fxv[3], fxb[3], fh[3], fhb[3];
  int wp[4], bp[1], ih[3], hh[3], bih[3], bhh[3];
  int o_h, o_m, o_v, o_X, o_M, o_obs, o_lrow, o_nll;
  int o_f1a, o_f1b, o_f1c, o_f1d, o_fo, o_kk, o_mk, o_vk, o_prek, o_ak;
  int o_f2a, o_f2b, o_f2c, o_f2d, o_h1p, o_pre1, o_a1, o_m1p, o_v1p;
  int o_h1, o_m1, o_v1, o_err, o_ft2, o_pre, o_gin;
  int o_ga, o_gb, o_gc, o_gd, o_gt, o_h2, o_pre2, o_a2, o_m2p, o_v2p;
  int o_m2, o_v2;
  int o_dh, o_dm, o_dv, o_dh2, o_dh1, o_dm1, o_dv1, o_dm2, o_dv2;
  int o_dg0, o_dg1, o_dg2, o_dg3, o_dx, o_dp, o_dmk, o_dvk, o_dkk;
  int o_df, o_fa0, o_fa1, o_fa2, o_dhf, o_dfm, o_dff, o_dfe;
};

struct Leaves { const float* p[MAX_LEAVES]; };

struct MaskCtx {
  int mode;                  // 0 none, 1 input masks, 2 philox
  const int8_t* u;
  uint32_t k0, k1, thresh;
  int k, row0, nv, B, P;
  float keep;
};

#define BUF(name) (sm + c.o_##name)
#define LW(i) ((i) >= 0 ? lv.p[(i)] : (const float*)nullptr)
#define GL(i) (G + c.leaf_off[(i)])

// constants of the loss, as the JAX kernel rounds them to float32
#define TWO_LOG_LIK_C 1.8378770664093453f   // 2 log sqrt(2 pi)
#define LOG_S2 -4.605170185988091f          // log(obs noise std 1e-2)
#define INV_S2SQ 10000.0f                   // 1 / s2^2
#define TWO_S2SQ 2e-4f                      // 2 s2^2
#define INV_TWO_S2SQ 5000.0f

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float sgnf(float x) {
  return (float)((x > 0.f) - (x < 0.f));
}

// keep-mask of slot `slot` at local row r, column col
__device__ __forceinline__ bool keep_at(const MaskCtx& m, int slot, int r,
                                        int col) {
  if (r >= m.nv) return true;    // padding row of the last CTA
  int grow = m.row0 + r;
  if (m.mode == 1)
    return m.u[(((size_t)m.k * 3 + slot) * m.B + grow) * m.P + col] != 0;
  return philox_keep(m.k0, m.k1, m.thresh, col, grow, m.k, slot);
}

// ------------------------------------------------ products (all end synced)
// The device functions below are __noinline__: each is called from many
// sites and from three kernels, and inlining them all multiplies nvcc's
// time (about 50 s for this file) for no measurable gain in a scan bound
// by its chain of synchronised phases.

// y[r, j] = (acc ? y[r, j] : 0) + sum_i x[r, i] W[i, j] (+ b[j])
__device__ __noinline__ void lin(const float* __restrict__ W, const float* __restrict__ b,
                    const float* x, int in, int out, float* y, bool acc) {
  for (int idx = threadIdx.x; idx < ROWS * out; idx += blockDim.x) {
    int r = idx / out, j = idx - r * out;
    const float* xr = x + r * in;
    float s = 0.f;
    for (int i = 0; i < in; ++i)
      s = fmaf(xr[i], __ldg(W + (size_t)i * out + j), s);
    if (b) s += __ldg(b + j);
    y[idx] = acc ? y[idx] + s : s;
  }
  __syncthreads();
}

// dx[r, i] = (acc ? dx[r, i] : 0) + sum_j d[r, j] W[i, j]
__device__ __noinline__ void linT(const float* __restrict__ W, const float* d, int out,
                     int in, float* dx, bool acc) {
  for (int idx = threadIdx.x; idx < ROWS * in; idx += blockDim.x) {
    int r = idx / in, i = idx - r * in;
    const float* dr = d + r * out;
    const float* wi = W + (size_t)i * out;
    float s = 0.f;
    for (int j = 0; j < out; ++j) s = fmaf(dr[j], __ldg(wi + j), s);
    dx[idx] = acc ? dx[idx] + s : s;
  }
  __syncthreads();
}

// G[i, j] += sum_{r < nv} x[r, i] d[r, j]   (the CTA's partial row)
__device__ __noinline__ void wgrad(float* G, const float* x, int in, const float* d,
                      int out, int nv) {
  for (int idx = threadIdx.x; idx < in * out; idx += blockDim.x) {
    int i = idx / out, j = idx - i * out;
    float s = 0.f;
    for (int r = 0; r < nv; ++r) s = fmaf(x[r * in + i], d[r * out + j], s);
    G[idx] += s;
  }
  __syncthreads();
}

// G[j] += sum_{r < nv} d[r, j]
__device__ __noinline__ void bgrad(float* G, const float* d, int out, int nv) {
  for (int j = threadIdx.x; j < out; j += blockDim.x) {
    float s = 0.f;
    for (int r = 0; r < nv; ++r) s += d[r * out + j];
    G[j] += s;
  }
  __syncthreads();
}

// ------------------------------------------------------------- p_model

// pre = x W0 + b0, a = dropout(relu(pre)), (mo, vo) = (a Wm + bm, a Wv + bv)
__device__ __noinline__ void pmodel_fwd(const GobCfg& c, const Leaves& lv, const float* x,
                           float* pre, float* a, float* mo, float* vo,
                           const MaskCtx& mc, int slot) {
  const int P = c.P;
  lin(LW(c.pm[0]), LW(c.pm[1]), x, c.H, P, pre, false);
  for (int idx = threadIdx.x; idx < ROWS * P; idx += blockDim.x) {
    float v = fmaxf(pre[idx], 0.f);
    if (mc.mode) {
      int r = idx / P, j = idx - r * P;
      v = keep_at(mc, slot, r, j) ? v / mc.keep : 0.f;
    }
    a[idx] = v;
  }
  __syncthreads();
  lin(LW(c.pm[2]), LW(c.pm[3]), a, P, c.D, mo, false);
  lin(LW(c.pm[4]), LW(c.pm[5]), a, P, c.D, vo, false);
}

// adds the p_model gradients; dx (+)= the gradient wrt its input x
__device__ __noinline__ void pmodel_bwd(const GobCfg& c, const Leaves& lv, float* G,
                           const float* x, const float* pre, const float* a,
                           const float* dm, const float* dv, float* dp,
                           float* dx, bool acc_dx, const MaskCtx& mc,
                           int slot, int nv) {
  const int P = c.P, D = c.D;
  wgrad(GL(c.pm[2]), a, P, dm, D, nv);
  bgrad(GL(c.pm[3]), dm, D, nv);
  wgrad(GL(c.pm[4]), a, P, dv, D, nv);
  bgrad(GL(c.pm[5]), dv, D, nv);
  const float* Wm = LW(c.pm[2]);
  const float* Wv = LW(c.pm[4]);
  for (int idx = threadIdx.x; idx < ROWS * P; idx += blockDim.x) {
    int r = idx / P, j = idx - r * P;
    float s = 0.f;
    for (int d = 0; d < D; ++d)
      s += dm[r * D + d] * __ldg(Wm + j * D + d)
           + dv[r * D + d] * __ldg(Wv + j * D + d);
    if (mc.mode) s = keep_at(mc, slot, r, j) ? s / mc.keep : 0.f;
    dp[idx] = pre[idx] > 0.f ? s : 0.f;
  }
  __syncthreads();
  wgrad(GL(c.pm[0]), x, c.H, dp, P, nv);
  bgrad(GL(c.pm[1]), dp, P, nv);
  linT(LW(c.pm[0]), dp, P, c.H, dx, acc_dx);
}

// ------------------------------------------------------- the GRU-ODE field

// gate pre-activation: g = [mi Wxm_k + vi Wxv_k + bx_k] + hin Wh
__device__ __noinline__ void gate_pre(const GobCfg& c, const Leaves& lv, int k,
                         const float* mi, const float* vi, const float* hin,
                         int wh, float* g) {
  if (c.impute) {
    lin(LW(c.fxm[k]), LW(c.fxb[k]), mi, c.D, c.H, g, false);
    lin(LW(c.fxv[k]), nullptr, vi, c.D, c.H, g, true);
    lin(LW(wh), nullptr, hin, c.H, c.H, g, true);
  } else {
    lin(LW(wh), nullptr, hin, c.H, c.H, g, false);
  }
}

// f = field(mi, vi, h) (the inputs are unread without impute). Saves
// full: F0 r, F1 z, F2 u, F3 r*h;  minimal: F0 z, F1 n, F2 z*h.
__device__ __noinline__ void field_fwd(const GobCfg& c, const Leaves& lv, const float* mi,
                          const float* vi, const float* h, float* F0,
                          float* F1, float* F2, float* F3, float* f) {
  const int H = c.H;
  if (c.full) {
    gate_pre(c, lv, 0, mi, vi, h, c.fh[0], F0);
    gate_pre(c, lv, 1, mi, vi, h, c.fh[1], F1);
    for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x) {
      float r = sigm(F0[idx]);
      F0[idx] = r;
      F1[idx] = sigm(F1[idx]);
      F3[idx] = r * h[idx];
    }
    __syncthreads();
    gate_pre(c, lv, 2, mi, vi, F3, c.fh[2], F2);
    for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x) {
      float u = tanhf(F2[idx]);
      F2[idx] = u;
      f[idx] = (1.f - F1[idx]) * (u - h[idx]);
    }
  } else {
    gate_pre(c, lv, 0, mi, vi, h, c.fh[0], F0);
    for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x) {
      float z = sigm(F0[idx]);
      F0[idx] = z;
      F2[idx] = z * h[idx];
    }
    __syncthreads();
    gate_pre(c, lv, 1, mi, vi, F2, c.fh[1], F1);
    for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x) {
      float n = tanhf(F1[idx]);
      F1[idx] = n;
      f[idx] = (1.f - F0[idx]) * (n - h[idx]);
    }
  }
  __syncthreads();
}

// the input-projection gradients of gate k: weights, bias, and dm/dv
__device__ __noinline__ void gate_in_bwd(const GobCfg& c, const Leaves& lv, float* G,
                            int k, const float* mi, const float* vi,
                            const float* da, float* dmo, float* dvo,
                            bool acc, int nv) {
  const int D = c.D, H = c.H;
  wgrad(GL(c.fxm[k]), mi, D, da, H, nv);
  wgrad(GL(c.fxv[k]), vi, D, da, H, nv);
  if (c.fxb[k] >= 0) bgrad(GL(c.fxb[k]), da, H, nv);
  linT(LW(c.fxm[k]), da, H, D, dmo, acc);
  linT(LW(c.fxv[k]), da, H, D, dvo, acc);
}

// backward of field_fwd for the field gradient df: adds the weight
// gradients, writes dhf = d/dh and (impute) dmo, dvo = d/d(mi, vi)
__device__ __noinline__ void field_bwd(const GobCfg& c, const Leaves& lv, float* G,
                          const float* mi, const float* vi, const float* h,
                          const float* F0, const float* F1, const float* F2,
                          const float* F3, const float* df, float* fa0,
                          float* fa1, float* fa2, float* dhf, float* dmo,
                          float* dvo, int nv) {
  const int H = c.H;
  if (c.full) {
    for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x) {
      float z = F1[idx], u = F2[idx], d = df[idx], hv = h[idx];
      float du = d * (1.f - z);
      fa1[idx] = -d * (u - hv);                 // dz
      dhf[idx] = -d * (1.f - z);
      fa0[idx] = du * (1.f - u * u);            // da_u
    }
    __syncthreads();
    wgrad(GL(c.fh[2]), F3, H, fa0, H, nv);      // Whh += (r h)^T da_u
    linT(LW(c.fh[2]), fa0, H, H, fa2, false);   // d(r h)
    for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x) {
      float r = F0[idx], z = F1[idx], drh = fa2[idx];
      float dr = drh * h[idx];
      dhf[idx] += drh * r;
      fa2[idx] = dr * r * (1.f - r);            // da_r
      fa1[idx] = fa1[idx] * z * (1.f - z);      // da_z
    }
    __syncthreads();
    wgrad(GL(c.fh[1]), h, H, fa1, H, nv);
    linT(LW(c.fh[1]), fa1, H, H, dhf, true);
    wgrad(GL(c.fh[0]), h, H, fa2, H, nv);
    linT(LW(c.fh[0]), fa2, H, H, dhf, true);
    if (c.impute) {
      gate_in_bwd(c, lv, G, 0, mi, vi, fa2, dmo, dvo, false, nv);
      gate_in_bwd(c, lv, G, 1, mi, vi, fa1, dmo, dvo, true, nv);
      gate_in_bwd(c, lv, G, 2, mi, vi, fa0, dmo, dvo, true, nv);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x) {
    float z = F0[idx], n = F1[idx], d = df[idx], hv = h[idx];
    float dn = d * (1.f - z);
    fa1[idx] = -d * (n - hv);                   // dz
    dhf[idx] = -d * (1.f - z);
    fa0[idx] = dn * (1.f - n * n);              // da_n
  }
  __syncthreads();
  wgrad(GL(c.fh[1]), F2, H, fa0, H, nv);        // Whn += (z h)^T da_n
  linT(LW(c.fh[1]), fa0, H, H, fa2, false);     // d(z h)
  for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x) {
    float z = F0[idx], dzh = fa2[idx];
    float dz = fa1[idx] + dzh * h[idx];
    dhf[idx] += dzh * z;
    fa1[idx] = dz * z * (1.f - z);              // da_z
  }
  __syncthreads();
  wgrad(GL(c.fh[0]), h, H, fa1, H, nv);
  linT(LW(c.fh[0]), fa1, H, H, dhf, true);
  if (c.impute) {
    gate_in_bwd(c, lv, G, 0, mi, vi, fa1, dmo, dvo, false, nv);
    gate_in_bwd(c, lv, G, 1, mi, vi, fa0, dmo, dvo, true, nv);
  }
}

// ------------------------------------------------------------ GRU cells

// The caller has put the input projections gi_r, gi_z into G0, G1 and gi_n
// into gt. Completes G0..G3 = r, z, n, gh_n and out = (1-z) n + z h.
__device__ __noinline__ void gru_fwd(const GobCfg& c, const Leaves& lv, const int* hh,
                        const int* bhh, const float* h, float* G0, float* G1,
                        float* G2, float* G3, const float* gt, float* out) {
  const int H = c.H;
  lin(LW(hh[0]), LW(bhh[0]), h, H, H, G0, true);
  lin(LW(hh[1]), LW(bhh[1]), h, H, H, G1, true);
  lin(LW(hh[2]), LW(bhh[2]), h, H, H, G3, false);
  for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x) {
    float r = sigm(G0[idx]), z = sigm(G1[idx]);
    float n = tanhf(gt[idx] + r * G3[idx]);
    G0[idx] = r;
    G1[idx] = z;
    G2[idx] = n;
    out[idx] = (1.f - z) * n + z * h[idx];
  }
  __syncthreads();
}

// Backward of gru_fwd for d(out) = dy: dgi = (dg0, dg1, dg2), dgh = (dg0,
// dg1, dg3); dhout (+)= dy z + sum_k dgh_k hh_k^T
__device__ __noinline__ void gru_bwd(const GobCfg& c, const Leaves& lv, const int* hh,
                        const float* h, const float* G0, const float* G1,
                        const float* G2, const float* G3, const float* dy,
                        float* dg0, float* dg1, float* dg2, float* dg3,
                        float* dhout, bool acc) {
  const int H = c.H;
  for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x) {
    float r = G0[idx], z = G1[idx], n = G2[idx], ghn = G3[idx];
    float d = dy[idx];
    float da_z = d * (h[idx] - n) * z * (1.f - z);
    float da_n = d * (1.f - z) * (1.f - n * n);
    float dr = da_n * ghn;
    dg0[idx] = dr * r * (1.f - r);
    dg1[idx] = da_z;
    dg2[idx] = da_n;
    dg3[idx] = da_n * r;
    float dh = d * z;
    dhout[idx] = acc ? dhout[idx] + dh : dh;
  }
  __syncthreads();
  linT(LW(hh[0]), dg0, H, H, dhout, true);
  linT(LW(hh[1]), dg1, H, H, dhout, true);
  linT(LW(hh[2]), dg3, H, H, dhout, true);
}

// the weight gradients of a GRU cell from gru_bwd's dgi/dgh
__device__ __noinline__ void gru_wgrads(const GobCfg& c, float* G, const int* ih,
                           const int* hh, const int* bih, const int* bhh,
                           const float* x, int in, const float* h,
                           const float* dg0, const float* dg1,
                           const float* dg2, const float* dg3, int nv) {
  const int H = c.H;
  const float* dgi[3] = {dg0, dg1, dg2};
  const float* dgh[3] = {dg0, dg1, dg3};
  for (int k = 0; k < 3; ++k) {
    wgrad(GL(ih[k]), x, in, dgi[k], H, nv);
    wgrad(GL(hh[k]), h, H, dgh[k], H, nv);
    if (bih[k] >= 0) bgrad(GL(bih[k]), dgi[k], H, nv);
    if (bhh[k] >= 0) bgrad(GL(bhh[k]), dgh[k], H, nv);
  }
}

// ------------------------------------------------------------- one step

// Forward of one step for the CTA's rows from the carries (h, m, v) and
// the step's inputs (X, M, obs) in shared memory: fills every buffer the
// backward reads, ends with (h2, m2, v2) and the per-row NLL.
__device__ __noinline__ void step_fwd(const GobCfg& c, const Leaves& lv, float* sm,
                         float dt, const MaskCtx& mc) {
  const int H = c.H, D = c.D, DP = c.DP;
  float* h = BUF(h); float* m = BUF(m); float* v = BUF(v);
  float* X = BUF(X); float* M = BUF(M); float* obs = BUF(obs);
  float* h1 = BUF(h1); float* m1 = BUF(m1); float* v1 = BUF(v1);
  __syncthreads();                 // the carries and inputs are loaded
  if (dt > 0.f) {                  // dt == 0 padding steps skip this
    float* h1p = BUF(h1p);
    if (c.prop == 2) {             // discretized: one GRU cell tick
      float* gi[3] = {BUF(f1a), BUF(f1b), BUF(gt)};
      for (int k = 0; k < 3; ++k) {
        if (c.impute) {
          lin(LW(c.fxm[k]), LW(c.fxb[k]), m, D, H, gi[k], false);
          lin(LW(c.fxv[k]), nullptr, v, D, H, gi[k], true);
        } else {
          lin(nullptr, LW(c.fxb[k]), m, 0, H, gi[k], false);
        }
      }
      gru_fwd(c, lv, c.fh, c.fhb, h, BUF(f1a), BUF(f1b), BUF(f1c), BUF(f1d),
              BUF(gt), h1p);
    } else {
      float* fo = BUF(fo);
      field_fwd(c, lv, m, v, h, BUF(f1a), BUF(f1b), BUF(f1c), BUF(f1d), fo);
      if (c.prop == 1) {           // midpoint
        float* kk = BUF(kk);
        for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x)
          kk[idx] = h[idx] + dt * 0.5f * fo[idx];
        __syncthreads();
        if (c.impute)
          pmodel_fwd(c, lv, kk, BUF(prek), BUF(ak), BUF(mk), BUF(vk), mc, 0);
        field_fwd(c, lv, BUF(mk), BUF(vk), kk, BUF(f2a), BUF(f2b), BUF(f2c),
                  BUF(f2d), fo);
      }
      for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x)
        h1p[idx] = h[idx] + dt * fo[idx];
      __syncthreads();
    }
    pmodel_fwd(c, lv, h1p, BUF(pre1), BUF(a1), BUF(m1p), BUF(v1p), mc, 1);
    for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x)
      h1[idx] = h1p[idx];
    for (int idx = threadIdx.x; idx < ROWS * D; idx += blockDim.x) {
      m1[idx] = BUF(m1p)[idx];
      v1[idx] = BUF(v1p)[idx];
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x)
      h1[idx] = h[idx];
    for (int idx = threadIdx.x; idx < ROWS * D; idx += blockDim.x) {
      m1[idx] = m[idx];
      v1[idx] = v[idx];
    }
  }
  __syncthreads();
  // observation update: NLL, features, prep transform, GRU jump
  float* err = BUF(err); float* ft2 = BUF(ft2); float* nll = BUF(nll);
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) {
      int i = r * D + d;
      float mean = m1[i], var = v1[i], e, t;
      if (c.logvar) {
        e = (X[i] - mean) / expf(0.5f * var);
        t = e * e + var + TWO_LOG_LIK_C;
        ft2[i] = var;
      } else {
        float a = fabsf(var) + 1e-6f;
        e = (X[i] - mean) / sqrtf(a);
        t = e * e + logf(a);
        ft2[i] = a;
      }
      err[i] = e;
      s += t * M[i];
    }
    nll[r] = 0.5f * s;
  }
  __syncthreads();
  float* pre = BUF(pre); float* gin = BUF(gin);
  lin(LW(c.wp[0]), nullptr, X, D, DP, pre, false);
  lin(LW(c.wp[1]), nullptr, m1, D, DP, pre, true);
  lin(LW(c.wp[2]), nullptr, ft2, D, DP, pre, true);
  lin(LW(c.wp[3]), LW(c.bp[0]), err, D, DP, pre, true);
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += blockDim.x) {
    int r = idx / DP, col = idx - r * DP;
    gin[idx] = fmaxf(pre[idx], 0.f) * M[r * D + col / c.prep];
  }
  __syncthreads();
  lin(LW(c.ih[0]), LW(c.bih[0]), gin, DP, H, BUF(ga), false);
  lin(LW(c.ih[1]), LW(c.bih[1]), gin, DP, H, BUF(gb), false);
  lin(LW(c.ih[2]), LW(c.bih[2]), gin, DP, H, BUF(gt), false);
  float* h2 = BUF(h2);
  gru_fwd(c, lv, c.hh, c.bhh, h1, BUF(ga), BUF(gb), BUF(gc), BUF(gd),
          BUF(gt), h2);
  for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x) {
    float o = obs[idx / H];
    h2[idx] = o * h2[idx] + (1.f - o) * h1[idx];
  }
  __syncthreads();
  pmodel_fwd(c, lv, h2, BUF(pre2), BUF(a2), BUF(m2p), BUF(v2p), mc, 2);
  float* m2 = BUF(m2); float* v2 = BUF(v2);
  for (int idx = threadIdx.x; idx < ROWS * D; idx += blockDim.x) {
    float o = obs[idx / D];
    m2[idx] = o * BUF(m2p)[idx] + (1.f - o) * m1[idx];
    v2[idx] = o * BUF(v2p)[idx] + (1.f - o) * v1[idx];
  }
  __syncthreads();
}

// Backward of one step, after step_fwd: from (dh, dm, dv) = the gradient
// wrt the step's outputs (h2, m2, v2) to the gradient wrt its entry carries
// (written back into dh, dm, dv), adding every weight gradient to G.
__device__ __noinline__ void step_bwd(const GobCfg& c, const Leaves& lv, float* sm,
                         float* G, float dt, float dloss, const MaskCtx& mc,
                         int nv) {
  const int H = c.H, D = c.D, DP = c.DP;
  float* h = BUF(h); float* m = BUF(m); float* v = BUF(v);
  float* X = BUF(X); float* M = BUF(M); float* obs = BUF(obs);
  float* dh = BUF(dh); float* dm = BUF(dm); float* dv = BUF(dv);
  float* dh1 = BUF(dh1); float* dh2 = BUF(dh2);
  float* dm1 = BUF(dm1); float* dv1 = BUF(dv1);
  float* dm2 = BUF(dm2); float* dv2 = BUF(dv2);
  float* dp = BUF(dp); float* dx = BUF(dx);
  float* dg0 = BUF(dg0); float* dg1 = BUF(dg1);
  float* dg2 = BUF(dg2); float* dg3 = BUF(dg3);
  // KL on (m2, v2), the carry from the next step, the obs select
  for (int idx = threadIdx.x; idx < ROWS * D; idx += blockDim.x) {
    float o = obs[idx / D], mk = M[idx], mv = BUF(m2)[idx];
    float vv = BUF(v2)[idx];
    float sc = dloss * c.mixing * o * mk;
    float dklm = sc * (mv - X[idx]) * INV_S2SQ;
    float dklv;
    if (c.logvar) {
      dklv = sc * (-0.5f + expf(vv) / TWO_S2SQ);
    } else {
      float a = fabsf(vv) + 1e-5f;
      dklv = sc * sgnf(vv) * (-0.5f / a + INV_TWO_S2SQ);
    }
    float gm = dm[idx] + dklm, gv = dv[idx] + dklv;
    dm2[idx] = o * gm;                         // -> p_model (post jump)
    dv2[idx] = o * gv;
    dm1[idx] = (1.f - o) * gm;
    dv1[idx] = (1.f - o) * gv;
  }
  __syncthreads();
  pmodel_bwd(c, lv, G, BUF(h2), BUF(pre2), BUF(a2), dm2, dv2, dp, dh2, false,
             mc, 2, nv);
  for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x) {
    float o = obs[idx / H];
    float g = dh2[idx] + dh[idx];
    dh2[idx] = o * g;                          // d h_jump
    dh1[idx] = (1.f - o) * g;
  }
  __syncthreads();
  // observation GRU
  const float* h1 = BUF(h1);
  gru_bwd(c, lv, c.hh, h1, BUF(ga), BUF(gb), BUF(gc), BUF(gd), dh2, dg0, dg1,
          dg2, dg3, dh1, true);
  gru_wgrads(c, G, c.ih, c.hh, c.bih, c.bhh, BUF(gin), DP, h1, dg0, dg1, dg2,
             dg3, nv);
  linT(LW(c.ih[0]), dg0, H, DP, dx, false);
  linT(LW(c.ih[1]), dg1, H, DP, dx, true);
  linT(LW(c.ih[2]), dg2, H, DP, dx, true);
  const float* pre = BUF(pre);
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += blockDim.x) {
    int r = idx / DP, col = idx - r * DP;
    dx[idx] = pre[idx] > 0.f ? dx[idx] * M[r * D + col / c.prep] : 0.f;
  }
  __syncthreads();
  const float* m1 = BUF(m1); const float* v1 = BUF(v1);
  const float* err = BUF(err); const float* ft2 = BUF(ft2);
  wgrad(GL(c.wp[0]), X, D, dx, DP, nv);
  wgrad(GL(c.wp[1]), m1, D, dx, DP, nv);
  wgrad(GL(c.wp[2]), ft2, D, dx, DP, nv);
  wgrad(GL(c.wp[3]), err, D, dx, DP, nv);
  bgrad(GL(c.bp[0]), dx, DP, nv);
  float* dfm = BUF(dfm); float* dff = BUF(dff); float* dfe = BUF(dfe);
  linT(LW(c.wp[1]), dx, DP, D, dfm, false);
  linT(LW(c.wp[2]), dx, DP, D, dff, false);
  linT(LW(c.wp[3]), dx, DP, D, dfe, false);
  // the NLL and the feature paths into (m1, v1)
  for (int idx = threadIdx.x; idx < ROWS * D; idx += blockDim.x) {
    float sc = dloss * obs[idx / D] * M[idx];
    float e = err[idx];
    if (c.logvar) {
      float sigma = expf(0.5f * v1[idx]);
      dm1[idx] += -sc * e / sigma - dfe[idx] / sigma + dfm[idx];
      dv1[idx] += sc * 0.5f * (1.f - e * e) - 0.5f * dfe[idx] * e + dff[idx];
    } else {
      float a = ft2[idx], sq = sqrtf(a), sg = sgnf(v1[idx]);
      dm1[idx] += -sc * e / sq - dfe[idx] / sq + dfm[idx];
      dv1[idx] += sg * sc * 0.5f * (1.f - e * e) / a
                  + sg * (-0.5f * dfe[idx] * e / a + dff[idx]);
    }
  }
  __syncthreads();
  if (!(dt > 0.f)) {               // padding step: the carries pass through
    for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x)
      dh[idx] = dh1[idx];
    for (int idx = threadIdx.x; idx < ROWS * D; idx += blockDim.x) {
      dm[idx] = dm1[idx];
      dv[idx] = dv1[idx];
    }
    __syncthreads();
    return;
  }
  // the propagation: h1 = cell(h, m, v), (m1, v1) = p_model(h1)
  pmodel_bwd(c, lv, G, BUF(h1p), BUF(pre1), BUF(a1), dm1, dv1, dp, dh1,
             true, mc, 1, nv);
  if (c.prop == 2) {
    gru_bwd(c, lv, c.fh, h, BUF(f1a), BUF(f1b), BUF(f1c), BUF(f1d), dh1, dg0,
            dg1, dg2, dg3, dh, false);
    const float* dgi[3] = {dg0, dg1, dg2};
    const float* dgh[3] = {dg0, dg1, dg3};
    for (int k = 0; k < 3; ++k) {
      if (c.impute) {
        wgrad(GL(c.fxm[k]), m, D, dgi[k], H, nv);
        wgrad(GL(c.fxv[k]), v, D, dgi[k], H, nv);
        linT(LW(c.fxm[k]), dgi[k], H, D, dm, k > 0);
        linT(LW(c.fxv[k]), dgi[k], H, D, dv, k > 0);
      }
      wgrad(GL(c.fh[k]), h, H, dgh[k], H, nv);
      if (c.fxb[k] >= 0) bgrad(GL(c.fxb[k]), dgi[k], H, nv);
      if (c.fhb[k] >= 0) bgrad(GL(c.fhb[k]), dgh[k], H, nv);
    }
  } else {
    float* df = BUF(df); float* dhf = BUF(dhf);
    float* fa0 = BUF(fa0); float* fa1 = BUF(fa1); float* fa2 = BUF(fa2);
    for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x)
      df[idx] = dt * dh1[idx];
    __syncthreads();
    if (c.prop == 0) {
      field_bwd(c, lv, G, m, v, h, BUF(f1a), BUF(f1b), BUF(f1c), BUF(f1d),
                df, fa0, fa1, fa2, dhf, dm, dv, nv);
      for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x)
        dh[idx] = dh1[idx] + dhf[idx];
    } else {
      // midpoint: h1 = h + dt f(mk, vk, kk), kk = h + dt/2 f(m, v, h),
      // (mk, vk) = p_model(kk) with impute
      float* dkk = BUF(dkk);
      const float* kk = BUF(kk);
      field_bwd(c, lv, G, BUF(mk), BUF(vk), kk, BUF(f2a), BUF(f2b),
                BUF(f2c), BUF(f2d), df, fa0, fa1, fa2, dkk, BUF(dmk),
                BUF(dvk), nv);
      if (c.impute)
        pmodel_bwd(c, lv, G, kk, BUF(prek), BUF(ak), BUF(dmk), BUF(dvk), dp,
                   dkk, true, mc, 0, nv);
      for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x)
        df[idx] = dt * 0.5f * dkk[idx];
      __syncthreads();
      field_bwd(c, lv, G, m, v, h, BUF(f1a), BUF(f1b), BUF(f1c), BUF(f1d),
                df, fa0, fa1, fa2, dhf, dm, dv, nv);
      for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x)
        dh[idx] = dh1[idx] + dkk[idx] + dhf[idx];
    }
  }
  if (!c.impute)
    for (int idx = threadIdx.x; idx < ROWS * D; idx += blockDim.x) {
      dm[idx] = 0.f;
      dv[idx] = 0.f;
    }
  __syncthreads();
}

// ---------------------------------------------------------------- kernels

__device__ MaskCtx make_mask_ctx(const GobCfg& c, const int8_t* u,
                                 const long long* seed, int row0, int nv) {
  MaskCtx mc;
  mc.mode = c.mode;
  mc.u = u;
  unsigned long long s = (c.mode == 2) ? (unsigned long long)seed[0] : 0ull;
  mc.k0 = (uint32_t)(s & 0xFFFFFFFFull);
  mc.k1 = (uint32_t)(s >> 32);
  mc.thresh = c.thresh;
  mc.k = 0; mc.row0 = row0; mc.nv = nv; mc.B = c.B; mc.P = c.P;
  mc.keep = c.keep;
  return mc;
}

// the step's inputs of the CTA's rows (zeros on padding rows)
__device__ __noinline__ void load_step(const GobCfg& c, float* sm, int k, int row0,
                          int nv, const float* obs_g, const float* X_g,
                          const float* M_g) {
  const int D = c.D, B = c.B;
  float* obs = BUF(obs); float* X = BUF(X); float* M = BUF(M);
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x)
    obs[r] = r < nv ? obs_g[(size_t)k * B + row0 + r] : 0.f;
  for (int idx = threadIdx.x; idx < ROWS * D; idx += blockDim.x) {
    bool ok = idx / D < nv;
    size_t g = ((size_t)k * B + row0) * D + idx;
    X[idx] = ok ? X_g[g] : 0.f;
    M[idx] = ok ? M_g[g] : 0.f;
  }
}

// rows [0, nv) of a [.., B, W] array at step k into a [ROWS, W] buffer
__device__ __noinline__ void load_rows(float* dst, const float* src, int k, int B, int W,
                          int row0, int nv) {
  for (int idx = threadIdx.x; idx < ROWS * W; idx += blockDim.x)
    dst[idx] = idx / W < nv ? src[((size_t)k * B + row0) * W + idx] : 0.f;
}

template <bool WANT_HISTS>
__global__ void __launch_bounds__(NTHREADS)
gob_scan_fwd_kernel(GobCfg c, Leaves lv, const float* __restrict__ dts,
                    const float* __restrict__ obs_g,
                    const float* __restrict__ X_g,
                    const float* __restrict__ M_g, const int8_t* u,
                    const long long* seed, const float* __restrict__ h0,
                    const float* __restrict__ m0,
                    const float* __restrict__ v0, float* loss_part,
                    float* hh, float* mh, float* vh) {
  extern __shared__ float sm[];
  const int H = c.H, D = c.D, B = c.B;
  const int row0 = blockIdx.x * ROWS;
  const int nv = min(ROWS, B - row0);
  float* h = BUF(h); float* m = BUF(m); float* v = BUF(v);
  float* lrow = BUF(lrow);
  load_rows(h, h0, 0, B, H, row0, nv);
  load_rows(m, m0, 0, B, D, row0, nv);
  load_rows(v, v0, 0, B, D, row0, nv);
  for (int r = threadIdx.x; r < ROWS; r += blockDim.x) lrow[r] = 0.f;
  MaskCtx mc = make_mask_ctx(c, u, seed, row0, nv);
  __syncthreads();
  for (int k = 0; k < c.K; ++k) {
    if (WANT_HISTS) {
      for (int idx = threadIdx.x; idx < nv * H; idx += blockDim.x)
        hh[((size_t)k * B + row0) * H + idx] = h[idx];
      for (int idx = threadIdx.x; idx < nv * D; idx += blockDim.x) {
        mh[((size_t)k * B + row0) * D + idx] = m[idx];
        vh[((size_t)k * B + row0) * D + idx] = v[idx];
      }
    }
    load_step(c, sm, k, row0, nv, obs_g, X_g, M_g);
    mc.k = k;
    step_fwd(c, lv, sm, dts[k], mc);
    // the step's loss per row: obs * (nll + mixing * KL(m2, v2))
    const float* X = BUF(X); const float* M = BUF(M);
    const float* m2 = BUF(m2); const float* v2 = BUF(v2);
    for (int r = threadIdx.x; r < nv; r += blockDim.x) {
      float kl = 0.f;
      for (int d = 0; d < D; ++d) {
        int i = r * D + d;
        float log_std, var;
        if (c.logvar) {
          log_std = 0.5f * v2[i];
          var = expf(v2[i]);
        } else {
          var = fabsf(v2[i]) + 1e-5f;
          log_std = 0.5f * logf(var);
        }
        float dmx = m2[i] - X[i];
        kl += (LOG_S2 - log_std + (var + dmx * dmx) / TWO_S2SQ - 0.5f)
              * M[i];
      }
      float o = BUF(obs)[r];
      lrow[r] += o * BUF(nll)[r] + c.mixing * (o * kl);
    }
    for (int idx = threadIdx.x; idx < ROWS * H; idx += blockDim.x)
      h[idx] = BUF(h2)[idx];
    for (int idx = threadIdx.x; idx < ROWS * D; idx += blockDim.x) {
      m[idx] = m2[idx];
      v[idx] = v2[idx];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < nv; ++r) s += lrow[r];
    loss_part[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(NTHREADS)
gob_scan_bwd_kernel(GobCfg c, Leaves lv, const float* __restrict__ dts,
                    const float* __restrict__ obs_g,
                    const float* __restrict__ X_g,
                    const float* __restrict__ M_g, const int8_t* u,
                    const long long* seed, const float* __restrict__ hh,
                    const float* __restrict__ mh,
                    const float* __restrict__ vh, const float* dloss_p,
                    float* partials, float* dh0, float* dm0, float* dv0) {
  extern __shared__ float sm[];
  const int H = c.H, D = c.D, B = c.B;
  const int row0 = blockIdx.x * ROWS;
  const int nv = min(ROWS, B - row0);
  float* G = partials + (size_t)blockIdx.x * c.n_params;
  for (int i = threadIdx.x; i < c.n_params; i += blockDim.x) G[i] = 0.f;
  float* dh = BUF(dh); float* dm = BUF(dm); float* dv = BUF(dv);
  for (int i = threadIdx.x; i < ROWS * H; i += blockDim.x) dh[i] = 0.f;
  for (int i = threadIdx.x; i < ROWS * D; i += blockDim.x) {
    dm[i] = 0.f;
    dv[i] = 0.f;
  }
  const float dloss = dloss_p[0];
  MaskCtx mc = make_mask_ctx(c, u, seed, row0, nv);
  __syncthreads();
  for (int k = c.K - 1; k >= 0; --k) {
    load_rows(BUF(h), hh, k, B, H, row0, nv);
    load_rows(BUF(m), mh, k, B, D, row0, nv);
    load_rows(BUF(v), vh, k, B, D, row0, nv);
    load_step(c, sm, k, row0, nv, obs_g, X_g, M_g);
    mc.k = k;
    const float dt = dts[k];
    step_fwd(c, lv, sm, dt, mc);
    step_bwd(c, lv, sm, G, dt, dloss, mc, nv);
  }
  for (int idx = threadIdx.x; idx < nv * H; idx += blockDim.x)
    dh0[(size_t)row0 * H + idx] = dh[idx];
  for (int idx = threadIdx.x; idx < nv * D; idx += blockDim.x) {
    dm0[(size_t)row0 * D + idx] = dm[idx];
    dv0[(size_t)row0 * D + idx] = dv[idx];
  }
}

// The K7 masks of K steps written out ([K, 3, B, P] int8): the draw the scan
// kernels make in 'prng' mode, for tests and timing.
__global__ void gob_masks_kernel(const long long* seed, int K, int B, int P,
                                 unsigned thresh, int8_t* out) {
  size_t n = (size_t)K * 3 * B * P;
  unsigned long long s = (unsigned long long)seed[0];
  uint32_t k0 = (uint32_t)(s & 0xFFFFFFFFull), k1 = (uint32_t)(s >> 32);
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    int col = (int)(idx % P);
    size_t q = idx / P;
    int row = (int)(q % B);
    q /= B;
    int slot = (int)(q % 3);
    int k = (int)(q / 3);
    out[idx] = philox_keep(k0, k1, thresh, col, row, k, slot) ? 1 : 0;
  }
}

// ------------------------------------------------------------ C interface

static Leaves make_leaves(const GobCfg* c, void** leaves) {
  Leaves lv;
  for (int i = 0; i < MAX_LEAVES; ++i)
    lv.p[i] = i < c->n_leaves ? (const float*)leaves[i] : nullptr;
  return lv;
}

extern "C" const char* gob_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int gob_scan_fwd(const GobCfg* c, void** leaves,
                            const float* dts, const float* obs,
                            const float* X, const float* M,
                            const int8_t* u, const long long* seed,
                            const float* h0, const float* m0,
                            const float* v0, float* loss_part, float* hh,
                            float* mh, float* vh, int want_hists,
                            void* stream) {
  if (c->rows != ROWS || c->n_leaves > MAX_LEAVES)
    return (int)cudaErrorInvalidValue;
  Leaves lv = make_leaves(c, leaves);
  int grid = (c->B + ROWS - 1) / ROWS;
  size_t smem = (size_t)c->fwd_floats * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (want_hists) {
    e = cudaFuncSetAttribute(gob_scan_fwd_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    gob_scan_fwd_kernel<true><<<grid, NTHREADS, smem, st>>>(
        *c, lv, dts, obs, X, M, u, seed, h0, m0, v0, loss_part, hh, mh, vh);
  } else {
    e = cudaFuncSetAttribute(gob_scan_fwd_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    gob_scan_fwd_kernel<false><<<grid, NTHREADS, smem, st>>>(
        *c, lv, dts, obs, X, M, u, seed, h0, m0, v0, loss_part, hh, mh, vh);
  }
  return (int)cudaGetLastError();
}

extern "C" int gob_scan_bwd(const GobCfg* c, void** leaves,
                            const float* dts, const float* obs,
                            const float* X, const float* M,
                            const int8_t* u, const long long* seed,
                            const float* hh, const float* mh,
                            const float* vh, const float* dloss,
                            float* partials, float* dh0, float* dm0,
                            float* dv0, void* stream) {
  if (c->rows != ROWS || c->n_leaves > MAX_LEAVES)
    return (int)cudaErrorInvalidValue;
  Leaves lv = make_leaves(c, leaves);
  int grid = (c->B + ROWS - 1) / ROWS;
  size_t smem = (size_t)c->smem_floats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      gob_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  gob_scan_bwd_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      *c, lv, dts, obs, X, M, u, seed, hh, mh, vh, dloss, partials, dh0, dm0,
      dv0);
  return (int)cudaGetLastError();
}

extern "C" int gob_masks(const long long* seed, int K, int B, int P,
                         unsigned thresh, int8_t* out, void* stream) {
  size_t n = (size_t)K * 3 * B * P;
  int threads = 256;
  int grid = (int)((n + threads - 1) / threads);
  if (grid > 65535) grid = 65535;
  gob_masks_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      seed, K, B, P, thresh, out);
  return (int)cudaGetLastError();
}
