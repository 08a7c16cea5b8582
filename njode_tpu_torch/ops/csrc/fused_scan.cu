// Hand-written Hopper kernels for the NJODE training scan (sm_90a).
//
// Replaces the Pallas TPU kernels of njode_tpu/ops/fused_scan.py:
//   njode_scan_fwd_kernel<true>   K1  _fwd_impl / _make_fwd_kernel (training forward, histories)
//   njode_scan_fwd_kernel<false>  K3  make_fused_eval_fn (eval loss, no histories, no dropout)
//   njode_scan_bwd_kernel         K2  _fused_bwd / _make_bwd_kernel (hand-written BPTT)
//   philox_keep (device function) K4  _step_masks (per-step dropout keep-masks)
//   reduce_partials               the in-kernel accumulation of the TPU grid (loss_ref +=, _acc_wb)
//
// Design. The scan is K sequential steps of tiny matmuls (widths <= ~50,
// batch rows 100-4000). One CTA owns ROWS batch rows and walks all K steps
// itself; all weights, carries and per-step activations live in dynamic
// shared memory, so a step touches device memory only for its per-step
// inputs (t, dt, obs, X, masks) and the history rows. Each layer is fp32
// FMA with one thread per (row, output column) and a __syncthreads between
// layers. The backward kernel re-materialises each step from the stored
// step-entry carries (h, last_X, tau), walks k = K-1..0, and sums every
// weight gradient in a per-CTA shared-memory accumulator that it writes to
// a per-CTA partial row; reduce_partials then sums the partials in a fixed
// order (no float atomics: results are bit-identical run to run).
//
// Bound on this card. The work is ~25,600 FLOP per row-step at the main
// path (12,800 MACs) - at B=200, K=100 that is 0.51 GFLOP, 7.6 us at the
// 67 TFLOP/s fp32 peak, and ~1 MB of traffic (0.3 us at 3.35 TB/s), so the
// bound is operations. What actually limits these kernels is latency: the
// K-step chain is sequential, and at B=100-200 only ceil(B/16) = 7-13 of
// the 132 SMs have a CTA. This first version is simple and exact; tensor
// cores, fewer rows per CTA and overlapping the independent MLPs are later
// work (PERF.md, Open questions).
//
// Dropout masks. 'input' mode reads int8 keep-masks [K,S,B,Wmax]; 'prng'
// mode draws Philox4x32-10 (philox.cuh, shared with the GRU-ODE-Bayes
// kernels) with key (seed_lo, seed_hi) and counter
// (col >> 2, global_row, k, slot), word col & 3, kept iff word < thresh.
// The counter depends only on the global row and column, never on the CTA
// split or the layer width, so the backward redraws the forward's masks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"          // K4: philox_keep

#define ROWS 16
#define NTHREADS 256
#define MAX_LIN 8
#define MAX_LEAVES 48

struct MLPDesc {
  int n_lin;                 // Linear layers (hidden layers + 1)
  int w[MAX_LIN + 1];        // width chain: in, hidden..., out
  int act[MAX_LIN];          // per hidden layer: 0 tanh, 1 relu
  int w_off[MAX_LIN];        // weight [out, in] offset in the flat params
  int b_off[MAX_LIN];        // bias offset, -1 without bias
  int slot0;                 // dropout slot of hidden layer 0
  int save_off;              // smem offset of the saved pre-acts / acts
};

// Mirrored field by field by ops/fused_scan.py::_ScanCfg (all 4-byte fields).
struct ScanCfg {
  int K, B, D, H, O, S, Wmax, n_params, n_leaves;
  int enc_case, enc_mult, ro_case, ro_mult, easy, ict, mode;
  unsigned int thresh;
  float keep, weight;
  int rows, buf_w, smem_floats;
  int leaf_off[MAX_LEAVES + 1];
  int o_w, o_g, o_h, o_lx, o_tau, o_X, o_obs, o_nobs, o_lrow, o_h1, o_h2;
  int o_in_ode, o_tX, o_in_ro, o_f, o_enc, o_ro, o_dA, o_dB, o_dh, o_dlx;
  int o_dtau, o_rs, o_dst, o_dh1, o_dhe, o_df, o_dlxc, o_dtauc;
  MLPDesc ode, enc, ro;
};

struct Leaves { const float* p[MAX_LEAVES]; };

struct MaskCtx {
  int mode;                  // 0 none, 1 input masks, 2 philox
  const int8_t* u;
  uint32_t k0, k1, thresh;
  int k, row0, nv, half, jump, B, S, Wmax;
  float keep;
};

// keep-mask of hidden slot `slot` at local row r (stacked rows r >= half
// belong to the second readout, slot + jump), column col
__device__ __forceinline__ bool keep_at(const MaskCtx& m, int slot, int r,
                                        int col) {
  int lr = r;
  if (r >= m.half) { lr = r - m.half; slot += m.jump; }
  int grow = m.row0 + lr;
  if (lr >= m.nv) return true;   // padding row of the last CTA
  if (m.mode == 1)
    return m.u[(((size_t)m.k * m.S + slot) * m.B + grow) * m.Wmax + col] != 0;
  return philox_keep(m.k0, m.k1, m.thresh, col, grow, m.k, slot);
}

__device__ __forceinline__ float act_f(int a, float x) {
  return a == 0 ? tanhf(x) : fmaxf(x, 0.f);
}

__device__ __forceinline__ float act_grad(int a, float pre) {
  if (a == 0) { float t = tanhf(pre); return 1.f - t * t; }
  return pre > 0.f ? 1.f : 0.f;
}

// y[r, j] = sum_i x[r, i] * W[j, i] (+ b[j]);  W in nn.Linear's [out, in]
__device__ __forceinline__ void linear(const float* W, const float* b,
                                       const float* x, int in, int out,
                                       int rows, float* y) {
  for (int idx = threadIdx.x; idx < rows * out; idx += blockDim.x) {
    int r = idx / out, j = idx - r * out;
    const float* xr = x + r * in;
    const float* wj = W + j * in;
    float acc = 0.f;
    for (int i = 0; i < in; ++i) acc = fmaf(xr[i], wj[i], acc);
    y[idx] = b ? acc + b[j] : acc;
  }
}

// MLP forward over `rows` rows: saves each hidden layer's pre-activation
// and post-dropout activation at sm + m.save_off (pre [rows, w], act
// [rows, w] per layer) and writes the output to `out`. Ends synced.
__device__ void mlp_fwd(const ScanCfg& c, const MLPDesc& m, float* sm,
                        const float* x, int rows, float* out,
                        const MaskCtx& mc) {
  const float* sw = sm + c.o_w;
  const float* in = x;
  float* save = sm + m.save_off;
  for (int l = 0; l < m.n_lin; ++l) {
    int wi = m.w[l], wo = m.w[l + 1];
    const float* b = m.b_off[l] >= 0 ? sw + m.b_off[l] : nullptr;
    bool last = l == m.n_lin - 1;
    float* y = last ? out : save;
    linear(sw + m.w_off[l], b, in, wi, wo, rows, y);
    __syncthreads();
    if (!last) {
      float* a = save + rows * wo;
      for (int idx = threadIdx.x; idx < rows * wo; idx += blockDim.x) {
        float v = act_f(m.act[l], y[idx]);
        if (mc.mode) {
          int r = idx / wo, j = idx - r * wo;
          v = keep_at(mc, m.slot0 + l, r, j) ? v / mc.keep : 0.f;
        }
        a[idx] = v;
      }
      __syncthreads();
      in = a;
      save += 2 * rows * wo;
    }
  }
}

// MLP backward: d0 [rows, out] is the gradient of the output; adds the
// weight and bias gradients of valid rows to the accumulator and returns
// the buffer holding dx [rows, in] (nullptr unless want_dx). Ends synced.
__device__ const float* mlp_bwd(const ScanCfg& c, const MLPDesc& m,
                                float* sm, const float* x, int rows,
                                const float* d0, bool want_dx,
                                const MaskCtx& mc) {
  const float* sw = sm + c.o_w;
  float* g = sm + c.o_g;
  float* bufs[2] = {sm + c.o_dA, sm + c.o_dB};
  // offsets of each hidden layer's saved (pre, act) pair
  int save_at[MAX_LIN];
  int s = m.save_off;
  for (int l = 0; l + 1 < m.n_lin; ++l) {
    save_at[l] = s;
    s += 2 * rows * m.w[l + 1];
  }
  const float* cur = d0;
  int nb = 0;
  for (int l = m.n_lin - 1; l >= 0; --l) {
    int wi = m.w[l], wo = m.w[l + 1];
    const float* a_in = l == 0 ? x : sm + save_at[l - 1] + rows * wi;
    const float* W = sw + m.w_off[l];
    for (int idx = threadIdx.x; idx < wo * wi; idx += blockDim.x) {
      int j = idx / wi, i = idx - j * wi;
      float acc = 0.f;
      for (int r = 0; r < rows; ++r) {
        int lr = r >= mc.half ? r - mc.half : r;
        if (lr < mc.nv) acc = fmaf(cur[r * wo + j], a_in[r * wi + i], acc);
      }
      g[m.w_off[l] + idx] += acc;
    }
    if (m.b_off[l] >= 0) {
      for (int j = threadIdx.x; j < wo; j += blockDim.x) {
        float acc = 0.f;
        for (int r = 0; r < rows; ++r) {
          int lr = r >= mc.half ? r - mc.half : r;
          if (lr < mc.nv) acc += cur[r * wo + j];
        }
        g[m.b_off[l] + j] += acc;
      }
    }
    float* nxt = nullptr;
    if (l > 0 || want_dx) {
      nxt = bufs[nb];
      nb ^= 1;
      const float* pre = l > 0 ? sm + save_at[l - 1] : nullptr;
      for (int idx = threadIdx.x; idx < rows * wi; idx += blockDim.x) {
        int r = idx / wi, i = idx - r * wi;
        float acc = 0.f;
        for (int j = 0; j < wo; ++j)
          acc = fmaf(cur[r * wo + j], W[j * wi + i], acc);
        if (l > 0) {
          if (mc.mode)
            acc = keep_at(mc, m.slot0 + l - 1, r, i) ? acc / mc.keep : 0.f;
          acc *= act_grad(m.act[l - 1], pre[idx]);
        }
        nxt[idx] = acc;
      }
    }
    __syncthreads();
    cur = nxt;
  }
  return cur;
}

// residual of class FFNN: case 1 tiles the raw input, case 2 averages its
// `mult` chunks
__device__ __forceinline__ float residual(int cs, int mult, const float* xr,
                                          int in_w, int j) {
  if (cs == 0) return 0.f;
  if (cs == 1) return xr[j % in_w];
  int chunk = in_w / mult;
  float s = xr[j];
  for (int i = 1; i < mult; ++i) s += xr[i * chunk + j];
  return s / (float)mult;
}

// gradient of the residual branch wrt the raw input column i
__device__ __forceinline__ float residual_bwd(int cs, int mult,
                                              const float* dr, int out_w,
                                              int i) {
  if (cs == 0) return 0.f;
  if (cs == 1) {
    int chunk = out_w / mult;
    float s = dr[i];
    for (int q = 1; q < mult; ++q) s += dr[q * chunk + i];
    return s;
  }
  return dr[i % out_w] / (float)mult;
}

__device__ void load_weights(const ScanCfg& c, const Leaves& lv, float* sm) {
  float* sw = sm + c.o_w;
  for (int l = 0; l < c.n_leaves; ++l) {
    int off = c.leaf_off[l], n = c.leaf_off[l + 1] - off;
    for (int i = threadIdx.x; i < n; i += blockDim.x) sw[off + i] = lv.p[l][i];
  }
}

__device__ MaskCtx make_mask_ctx(const ScanCfg& c, const int8_t* u,
                                 const long long* seed, int row0, int nv) {
  MaskCtx mc;
  mc.mode = c.mode;
  mc.u = u;
  unsigned long long s = (c.mode == 2) ? (unsigned long long)seed[0] : 0ull;
  mc.k0 = (uint32_t)(s & 0xFFFFFFFFull);
  mc.k1 = (uint32_t)(s >> 32);
  mc.thresh = c.thresh;
  mc.k = 0; mc.row0 = row0; mc.nv = nv; mc.half = ROWS; mc.jump = 0;
  mc.B = c.B; mc.S = c.S; mc.Wmax = c.Wmax; mc.keep = c.keep;
  return mc;
}

// One step forward for the CTA's rows, from the carries in smem (h, lx,
// tau, X, obs already loaded): fills h1, h2, tanh(X), the ODE input, the
// stacked readout input and output, with every MLP's saved activations.
__device__ void step_forward(const ScanCfg& c, float* sm, float t, float dt,
                             MaskCtx& mc) {
  const int R = ROWS, D = c.D, H = c.H, O = c.O;
  const int iw = c.ode.w[0];
  float* h = sm + c.o_h; float* lx = sm + c.o_lx; float* tau = sm + c.o_tau;
  float* X = sm + c.o_X; float* obs = sm + c.o_obs;
  float* in_ode = sm + c.o_in_ode; float* tX = sm + c.o_tX;
  __syncthreads();                 // the step's carries and inputs are loaded
  for (int idx = threadIdx.x; idx < R * iw; idx += blockDim.x) {
    int r = idx / iw, q = idx - r * iw;
    float tdiff = (t - dt) - tau[r];
    float v;
    if (q < D) v = tanhf(lx[r * D + q]);
    else if (q < D + H) v = tanhf(h[r * H + q - D]);
    else if (q == D + H) v = tau[r];
    else if (q == D + H + 1) v = tdiff;
    else v = tau[r] + tdiff;                 // input_current_t feature
    in_ode[idx] = v;
  }
  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x)
    tX[idx] = tanhf(X[idx]);
  __syncthreads();
  mc.half = R; mc.jump = 0;
  mlp_fwd(c, c.ode, sm, in_ode, R, sm + c.o_f, mc);
  mlp_fwd(c, c.enc, sm, tX, R, sm + c.o_enc, mc);
  float* f = sm + c.o_f; float* enc = sm + c.o_enc;
  float* h1 = sm + c.o_h1; float* h2 = sm + c.o_h2;
  float* in_ro = sm + c.o_in_ro;
  for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
    int r = idx / H, j = idx - r * H;
    float a = h[idx] + dt * f[idx];
    float he = residual(c.enc_case, c.enc_mult, X + r * D, D, j) + enc[idx];
    float o = obs[r];
    float b = o * he + (1.f - o) * a;
    h1[idx] = a;
    h2[idx] = b;
    in_ro[idx] = tanhf(a);
    in_ro[R * H + idx] = tanhf(b);
  }
  __syncthreads();
  mc.half = R; mc.jump = c.ro.n_lin - 1;   // rows >= R use the r2 slots
  mlp_fwd(c, c.ro, sm, in_ro, 2 * R, sm + c.o_ro, mc);
  mc.half = 2 * R;                          // no stacked rows elsewhere
  (void)O;
}

// readouts with residual: y_bj for row r (stacked row r), y (row R + r)
__device__ __forceinline__ float y_at(const ScanCfg& c, const float* sm,
                                      int rr, int o) {
  const float* hsrc = rr < ROWS ? sm + c.o_h1 + rr * c.H
                                : sm + c.o_h2 + (rr - ROWS) * c.H;
  return residual(c.ro_case, c.ro_mult, hsrc, c.H, o)
         + sm[c.o_ro + rr * c.O + o];
}

template <bool WANT_HISTS>
__global__ void __launch_bounds__(NTHREADS)
njode_scan_fwd_kernel(ScanCfg c, Leaves lv, const float* __restrict__ times,
                      const float* __restrict__ dts,
                      const float* __restrict__ obs_g,
                      const float* __restrict__ X_g, const int8_t* u,
                      const long long* seed,
                      const float* __restrict__ n_obs,
                      const float* __restrict__ h0,
                      const float* __restrict__ sx, float* loss_part,
                      float* hh, float* lxh, float* tauh) {
  extern __shared__ float sm[];
  const int R = ROWS, D = c.D, H = c.H, O = c.O, B = c.B;
  const int row0 = blockIdx.x * R;
  const int nv = min(R, B - row0);
  load_weights(c, lv, sm);
  float* h = sm + c.o_h; float* lx = sm + c.o_lx; float* tau = sm + c.o_tau;
  float* X = sm + c.o_X; float* obs = sm + c.o_obs;
  float* nobs = sm + c.o_nobs; float* lrow = sm + c.o_lrow;
  for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
    int r = idx / H;
    h[idx] = r < nv ? h0[(size_t)row0 * H + idx] : 0.f;
  }
  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
    int r = idx / D;
    lx[idx] = r < nv ? sx[(size_t)row0 * D + idx] : 0.f;
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    tau[r] = 0.f;
    lrow[r] = 0.f;
    nobs[r] = r < nv ? n_obs[row0 + r] : 1.f;
  }
  MaskCtx mc = make_mask_ctx(c, u, seed, row0, nv);
  __syncthreads();
  for (int k = 0; k < c.K; ++k) {
    const float t = times[k], dt = dts[k];
    if (WANT_HISTS) {
      for (int idx = threadIdx.x; idx < nv * H; idx += blockDim.x)
        hh[((size_t)k * B + row0) * H + idx] = h[idx];
      for (int idx = threadIdx.x; idx < nv * D; idx += blockDim.x)
        lxh[((size_t)k * B + row0) * D + idx] = lx[idx];
      for (int r = threadIdx.x; r < nv; r += blockDim.x)
        tauh[(size_t)k * B + row0 + r] = tau[r];
    }
    for (int r = threadIdx.x; r < R; r += blockDim.x)
      obs[r] = r < nv ? obs_g[(size_t)k * B + row0 + r] : 0.f;
    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
      int r = idx / D;
      X[idx] = r < nv ? X_g[((size_t)k * B + row0) * D + idx] : 0.f;
    }
    mc.k = k;
    step_forward(c, sm, t, dt, mc);
    // per-row loss term, then the carry updates
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      float e1 = 0.f, e2 = 0.f;
      for (int o = 0; o < O; ++o) {
        float yb = y_at(c, sm, r, o), y = y_at(c, sm, R + r, o);
        float x = X[r * D + o];
        float d1 = x - y, d2 = yb - (c.easy ? x : y);
        e1 += d1 * d1;
        e2 += d2 * d2;
      }
      float s1 = sqrtf(e1 + 1e-10f), s2 = sqrtf(e2 + 1e-10f);
      float fac = c.easy ? 1.f : 2.f;
      float g = fac * c.weight * s1 + fac * (1.f - c.weight) * s2;
      lrow[r] += obs[r] * g * g / fmaxf(nobs[r], 1.f);
      if (obs[r] > 0.f) tau[r] = t;
    }
    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x)
      if (obs[idx / D] > 0.f) lx[idx] = X[idx];
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x)
      h[idx] = sm[c.o_h2 + idx];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < nv; ++r) s += lrow[r];
    loss_part[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(NTHREADS)
njode_scan_bwd_kernel(ScanCfg c, Leaves lv, const float* __restrict__ times,
                      const float* __restrict__ dts,
                      const float* __restrict__ obs_g,
                      const float* __restrict__ X_g, const int8_t* u,
                      const long long* seed,
                      const float* __restrict__ n_obs,
                      const float* __restrict__ hh,
                      const float* __restrict__ lxh,
                      const float* __restrict__ tauh, const float* dloss_p,
                      float* partials, float* dh0) {
  extern __shared__ float sm[];
  const int R = ROWS, D = c.D, H = c.H, O = c.O, B = c.B;
  const int row0 = blockIdx.x * R;
  const int nv = min(R, B - row0);
  const int iw = c.ode.w[0];
  load_weights(c, lv, sm);
  float* g = sm + c.o_g;
  for (int i = threadIdx.x; i < c.n_params; i += blockDim.x) g[i] = 0.f;
  float* h = sm + c.o_h; float* lx = sm + c.o_lx; float* tau = sm + c.o_tau;
  float* X = sm + c.o_X; float* obs = sm + c.o_obs; float* nobs = sm + c.o_nobs;
  float* dh = sm + c.o_dh; float* dlx = sm + c.o_dlx; float* dtau = sm + c.o_dtau;
  float* rs = sm + c.o_rs; float* dst = sm + c.o_dst; float* dh1 = sm + c.o_dh1;
  float* dhe = sm + c.o_dhe; float* df = sm + c.o_df;
  float* dlxc = sm + c.o_dlxc; float* dtauc = sm + c.o_dtauc;
  for (int i = threadIdx.x; i < R * H; i += blockDim.x) dh[i] = 0.f;
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) dlx[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    dtau[r] = 0.f;
    nobs[r] = r < nv ? n_obs[row0 + r] : 1.f;
  }
  const float dloss = dloss_p[0];
  MaskCtx mc = make_mask_ctx(c, u, seed, row0, nv);
  __syncthreads();
  for (int k = c.K - 1; k >= 0; --k) {
    const float t = times[k], dt = dts[k];
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x)
      h[idx] = idx / H < nv ? hh[((size_t)k * B + row0) * H + idx] : 0.f;
    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
      bool ok = idx / D < nv;
      lx[idx] = ok ? lxh[((size_t)k * B + row0) * D + idx] : 0.f;
      X[idx] = ok ? X_g[((size_t)k * B + row0) * D + idx] : 0.f;
    }
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      bool ok = r < nv;
      tau[r] = ok ? tauh[(size_t)k * B + row0 + r] : 0.f;
      obs[r] = ok ? obs_g[(size_t)k * B + row0 + r] : 0.f;
    }
    mc.k = k;
    step_forward(c, sm, t, dt, mc);
    // loss gradients per row: rs = (de1, de2)
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      float e1 = 0.f, e2 = 0.f;
      for (int o = 0; o < O; ++o) {
        float yb = y_at(c, sm, r, o), y = y_at(c, sm, R + r, o);
        float x = X[r * D + o];
        float d1 = x - y, d2 = yb - (c.easy ? x : y);
        e1 += d1 * d1;
        e2 += d2 * d2;
      }
      float s1 = sqrtf(e1 + 1e-10f), s2 = sqrtf(e2 + 1e-10f);
      float fac = c.easy ? 1.f : 2.f;
      float gg = fac * c.weight * s1 + fac * (1.f - c.weight) * s2;
      float dinner = dloss * obs[r] / fmaxf(nobs[r], 1.f) / (float)B;
      float dg = 2.f * gg * dinner;
      rs[2 * r] = (fac * c.weight * dg) * (0.5f / s1);
      rs[2 * r + 1] = (fac * (1.f - c.weight) * dg) * (0.5f / s2);
      float o = obs[r];
      dtauc[r] = (1.f - o) * dtau[r];
    }
    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x)
      dlxc[idx] = (1.f - obs[idx / D]) * dlx[idx];
    __syncthreads();
    // d_stack = [dy_bj ; dy]
    for (int idx = threadIdx.x; idx < R * O; idx += blockDim.x) {
      int r = idx / O, o = idx - r * O;
      float yb = y_at(c, sm, r, o), y = y_at(c, sm, R + r, o);
      float x = X[r * D + o];
      float de1 = rs[2 * r], de2 = rs[2 * r + 1];
      float dy = de1 * 2.f * (y - x);
      float dyb = de2 * 2.f * (yb - (c.easy ? x : y));
      if (!c.easy) dy += de2 * 2.f * (y - yb);
      dst[idx] = dyb;
      dst[R * O + idx] = dy;
    }
    __syncthreads();
    // stacked readout backward
    mc.half = R; mc.jump = c.ro.n_lin - 1;
    const float* d_rin = mlp_bwd(c, c.ro, sm, sm + c.o_in_ro, 2 * R, dst,
                                 true, mc);
    const float* in_ro = sm + c.o_in_ro;
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      int r = idx / H, j = idx - r * H;
      float a1 = in_ro[idx], a2 = in_ro[R * H + idx];
      float dt1 = d_rin[idx] * (1.f - a1 * a1)
                  + residual_bwd(c.ro_case, c.ro_mult, dst + r * O, O, j);
      float dt2 = d_rin[R * H + idx] * (1.f - a2 * a2)
                  + residual_bwd(c.ro_case, c.ro_mult, dst + (R + r) * O, O,
                                 j);
      float o = obs[r];
      float d2 = dh[idx] + dt2;
      dhe[idx] = o * d2;
      float d1 = (1.f - o) * d2 + dt1;
      dh1[idx] = d1;
      df[idx] = dt * d1;
    }
    __syncthreads();
    mc.half = 2 * R; mc.jump = 0;
    // encoder backward: X is data, only the weights get gradients
    mlp_bwd(c, c.enc, sm, sm + c.o_tX, R, dhe, false, mc);
    // Euler step backward: h1 = h + dt * f(ode_in)
    const float* dino = mlp_bwd(c, c.ode, sm, sm + c.o_in_ode, R, df, true,
                                mc);
    const float* in_ode = sm + c.o_in_ode;
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      int r = idx / H, j = idx - r * H;
      float th = in_ode[r * iw + D + j];
      dh[idx] = dh1[idx] + dino[r * iw + D + j] * (1.f - th * th);
    }
    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
      int r = idx / D, q = idx - r * D;
      float tl = in_ode[r * iw + q];
      dlx[idx] = dlxc[idx] + dino[r * iw + q] * (1.f - tl * tl);
    }
    // the input_current_t feature tau + tdiff == t_prev is constant in tau
    for (int r = threadIdx.x; r < R; r += blockDim.x)
      dtau[r] = dtauc[r] + dino[r * iw + D + H] - dino[r * iw + D + H + 1];
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < nv * H; idx += blockDim.x)
    dh0[(size_t)row0 * H + idx] = dh[idx];
  for (int i = threadIdx.x; i < c.n_params; i += blockDim.x)
    partials[(size_t)blockIdx.x * c.n_params + i] = g[i];
}

// out[p] = scale * sum_c partials[c, p], summed in a fixed order
__global__ void reduce_partials_kernel(const float* __restrict__ partials,
                                       int n_parts, int n, float scale,
                                       float* __restrict__ out) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float s = 0.f;
  for (int q = 0; q < n_parts; ++q) s += partials[(size_t)q * n + p];
  out[p] = s * scale;
}

// The K4 masks of K steps written out ([K, S, B, W] int8): the draw the
// scan kernels make in 'prng' mode, for tests and timing.
__global__ void philox_masks_kernel(const long long* seed, int K, int S,
                                    int B, int W, unsigned thresh,
                                    int8_t* out) {
  size_t n = (size_t)K * S * B * W;
  unsigned long long s = (unsigned long long)seed[0];
  uint32_t k0 = (uint32_t)(s & 0xFFFFFFFFull), k1 = (uint32_t)(s >> 32);
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    int col = (int)(idx % W);
    size_t q = idx / W;
    int row = (int)(q % B);
    q /= B;
    int slot = (int)(q % S);
    int k = (int)(q / S);
    out[idx] = philox_keep(k0, k1, thresh, col, row, k, slot) ? 1 : 0;
  }
}

// ------------------------------------------------------------ C interface

static Leaves make_leaves(const ScanCfg* c, void** leaves) {
  Leaves lv;
  for (int i = 0; i < MAX_LEAVES; ++i)
    lv.p[i] = i < c->n_leaves ? (const float*)leaves[i] : nullptr;
  return lv;
}

extern "C" const char* njode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int njode_scan_fwd(const ScanCfg* c, void** leaves,
                              const float* times, const float* dts,
                              const float* obs, const float* X,
                              const int8_t* u, const long long* seed,
                              const float* n_obs, const float* h0,
                              const float* sx, float* loss_part, float* hh,
                              float* lxh, float* tauh, int want_hists,
                              void* stream) {
  if (c->rows != ROWS) return (int)cudaErrorInvalidValue;
  Leaves lv = make_leaves(c, leaves);
  int grid = (c->B + ROWS - 1) / ROWS;
  size_t smem = (size_t)c->smem_floats * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (want_hists) {
    e = cudaFuncSetAttribute(njode_scan_fwd_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    njode_scan_fwd_kernel<true><<<grid, NTHREADS, smem, st>>>(
        *c, lv, times, dts, obs, X, u, seed, n_obs, h0, sx, loss_part, hh,
        lxh, tauh);
  } else {
    e = cudaFuncSetAttribute(njode_scan_fwd_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    njode_scan_fwd_kernel<false><<<grid, NTHREADS, smem, st>>>(
        *c, lv, times, dts, obs, X, u, seed, n_obs, h0, sx, loss_part, hh,
        lxh, tauh);
  }
  return (int)cudaGetLastError();
}

extern "C" int njode_scan_bwd(const ScanCfg* c, void** leaves,
                              const float* times, const float* dts,
                              const float* obs, const float* X,
                              const int8_t* u, const long long* seed,
                              const float* n_obs, const float* hh,
                              const float* lxh, const float* tauh,
                              const float* dloss, float* partials,
                              float* dh0, void* stream) {
  if (c->rows != ROWS) return (int)cudaErrorInvalidValue;
  Leaves lv = make_leaves(c, leaves);
  int grid = (c->B + ROWS - 1) / ROWS;
  size_t smem = (size_t)c->smem_floats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      njode_scan_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  njode_scan_bwd_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      *c, lv, times, dts, obs, X, u, seed, n_obs, hh, lxh, tauh, dloss,
      partials, dh0);
  return (int)cudaGetLastError();
}

extern "C" int njode_philox_masks(const long long* seed, int K, int S, int B,
                                  int W, unsigned thresh, int8_t* out,
                                  void* stream) {
  size_t n = (size_t)K * S * B * W;
  int threads = 256;
  int grid = (int)((n + threads - 1) / threads);
  if (grid > 65535) grid = 65535;
  philox_masks_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      seed, K, S, B, W, thresh, out);
  return (int)cudaGetLastError();
}

extern "C" int njode_reduce_partials(const float* partials, int n_parts,
                                     int n, float scale, float* out,
                                     void* stream) {
  int threads = 256, grid = (n + threads - 1) / threads;
  reduce_partials_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      partials, n_parts, n, scale, out);
  return (int)cudaGetLastError();
}
