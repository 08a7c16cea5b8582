// Hand-written Hopper kernels for the NJODE training scan (sm_90a).
//
// Replaces the Pallas TPU kernels of njode_tpu/ops/fused_scan.py, all
// their branches (unmasked, masked: _step_forward / _step_backward's
// imputation path, and the GRU jump: _gru_fwd / _gru_bwd):
//   njode_scan_fwd_kernel<true>   K1  _fwd_impl / _make_fwd_kernel (training forward, histories)
//   njode_scan_fwd_kernel<false>  K3  make_fused_eval_fn (eval loss, no histories, no dropout)
//   njode_scan_bwd_kernel         K2  _fused_bwd / _make_bwd_kernel (hand-written BPTT)
//   philox_keep (device function) K4  _step_masks (per-step dropout keep-masks)
//   reduce_partials               the in-kernel accumulation of the TPU grid (loss_ref +=, _acc_wb)
//
// Design. The scan is K sequential steps of tiny matmuls (widths <= ~50,
// batch rows 100-4000). One CTA owns R batch rows and walks all K steps
// itself; all weights (resident plan, below), carries and per-step
// activations live in dynamic shared memory, so a step touches device
// memory only for its per-step inputs (t, dt, obs, X, masks) and the
// history rows. Each layer is fp32
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
// Masked branch (c.masked). The pre-jump readout imputes the unobserved
// coordinates, X_imp = X*M + (1-M)*y_bj, and the encoder reads
// [tanh X_imp, M] (2D wide) with its residual on X_imp (D wide), so a step
// runs four MLP passes one after another: ODE, pre-jump readout (R rows,
// slots s_r1), encoder, post-jump readout (R rows, slots s_r2, MLPDesc
// ro2: the same weights, its own saved activations). The loss weighs each
// coordinate by M, and last_X takes the post-jump prediction y at observed
// rows, so the backward adds obs*dlast_X to dy and carries (1-M)*dX_imp
// into dy_bj before the pre-jump readout's backward.
//
// GRU jump (c.use_rnn, a runtime branch like c.masked). At observed rows
// h' = GRUCell(tanh X, h_t), h_t = tanh h1, on the raw observation whether
// masked or not, in torch's gate order r, z, n: gate g is row g*H + j of
// weight_ih [3H, D] and weight_hh [3H, H] (leaf offsets c.gru_*), and
//   r = sig(gi_r + gh_r), z = sig(gi_z + gh_z), n = tanh(gi_n + r*gh_n),
//   h' = (1-z)*n + z*h_t,  h2 = obs*h' + (1-obs)*h1,
// with b_hh_n inside gh_n. It takes the encoder's place; the encoder runs
// only at t=0, outside (its dropout slots stay in S, unused). Both readouts
// then run as one stacked pass even when masked, and a masked config keeps
// its M-weighted loss and last_X = y. gru_fwd gives a thread one (row, j)
// and all three gates' sums (tanh X from tX [R, D], h_t from in_ro[0:R*H])
// and saves (r, z, n, gh_n) in region gru [4][R*H]. gru_bwd writes the
// gate gradients da_r, da_z, da_n = dgi_n and dgh_n = r*da_n (the gradient
// of b_hh_n and the hh row of n: r scales gh_n) to dG [R, 4H], then adds
// the four leaves' gradients (X is data: no dx) and dh1 += (dh'*z +
// sum_g dgh_g W_hh[g]) * (1 - h_t^2).
//
// Dropout masks. 'input' mode reads int8 keep-masks [K,S,B,Wmax]; 'prng'
// mode draws Philox4x32-10 (philox.cuh, shared with the GRU-ODE-Bayes
// kernels) with key (seed_lo, seed_hi) and counter
// (col >> 2, global_row, k, slot), word col & 3, kept iff word < thresh.
// The counter depends only on the global row and column, never on the CTA
// split or the layer width, so the backward redraws the forward's masks.
//
// Two plans (c.plan; the counterpart of the JAX kernel's _select_plan /
// _block_plan, which cut nets that overflow VMEM into K-chunks and batch
// blocks). 'resident' (GW = false): every weight and its gradient sit in
// shared memory, as above. 'global' (GW = true), for nets whose weights do
// not fit one CTA (PhysioNet, the 400-wide arms): the weights stay in one
// packed fp32 buffer in device memory (each leaf at a 16-byte boundary,
// Spec.pack_off), and K2 adds each step's weight gradients in place into
// its CTA's partial row, which it zeroes first. Each gradient element has
// one owning thread within the CTA, so there are no atomics and a run
// repeats bit for bit. Only activations live in shared memory, and R
// (c.rows) is the largest of 16, 8, 4, 2, 1 whose activations fit. Each
// kernel is built twice over R (template RT): with R = 16 a compile-time
// constant, so the row loops of the default plans unroll (read at run
// time, R slowed the resident K2 by 12 %), and with R read from c.rows.
//
// The global plan's weights reach the FMA chains through shared memory.
// Reading them through __ldg put an L2 round trip on every link of each
// column's serial sum (one load in flight a thread, 8 warps an SM: K2 ran
// at 0.07 % of its fp32 bound). Now the ring (the region left after the
// activations, two stages) holds weight tiles that cp.async copies in the
// background: acquiring tile t waits for it, syncs, and starts the copy of
// tile t + 1 into the other stage, so each copy overlaps the arithmetic of
// the tile before it, across layers, MLPs and steps. The host lists a
// step's tiles in the order the kernels consume them (Spec.tile_program:
// the forward's, then K2's backward), and every consumer checks the
// descriptor's key. A forward product y = W x takes column blocks
// [out x T] of W (bias on the last) and dx = W^T d row blocks [T x in];
// the GRU's gates run as two such products into the region gsc. A thread
// keeps its outputs (a column of up to RB rows, MAXI of them a pass) in
// registers across tiles, walking the summed index upwards, so each sum
// runs in the resident plan's order and both plans give the same bits at
// one R. The weight gradients (no weights read) stay in the CTA's partial
// row: a thread issues the loads of GB of its elements before it sums
// them (the cheaper of the two ways to take the serial L2 round trip out
// of the read-modify-write; staging the gradient tiles through shared
// memory would also need ring space the 400-wide arms do not have beside
// their weight tiles). The passes stay inlined into the six global kernel
// instantiations, which makes this file slow to build (nvcc 249 s on the
// H100 machine): compiled once each, out of line (__noinline__ mlp_fwd,
// mlp_bwd, gru_fwd and gru_bwd), they built in 28 s but ran 35-47 %
// slower on the card (PERF.md).
//
// reduce_partials. The scan kernels' C entries enqueue it themselves on
// the same stream right after K1/K3 (the loss, [n_cta, 1]) and K2 (the
// gradients): one launch more on the device, no Python call and no second
// ctypes trip on the host. (The alternative, the last CTA of K1 summing the
// loss after a ticket, would cover only the loss.) A thread sums one
// column; its bound is bytes, (n_parts + 1) * n * 4. Two bodies shaped for
// bandwidth were no faster on the card (float4 loads on rows padded to 16
// bytes: the same device time; 4 columns a thread with 8 rows' loads ahead:
// 3-4x slower; PERF.md), so the kernel kept its first body.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"          // K4: philox_keep

#define MAX_ROWS 16            // batch rows per CTA: c.rows in 1..MAX_ROWS
#define RB 4                   // rows a thread sums in the global plan
#define NTHREADS 256
#define MAX_LIN 8
#define MAX_LEAVES 52          // three MLPs of MAX_LIN layers, the GRU's 4
#define MAXI 4                 // global plan: items a thread keeps over tiles
#define GB 16                  // global plan: gradient loads issued ahead
#define TILE_INTS 8            // ints of a tile descriptor (tile_program)

struct MLPDesc {
  int n_lin;                 // Linear layers (hidden layers + 1)
  int w[MAX_LIN + 1];        // width chain: in, hidden..., out
  int act[MAX_LIN];          // per hidden layer: 0 tanh, 1 relu
  int w_off[MAX_LIN];        // weight [out, in] offset in the flat params
  int b_off[MAX_LIN];        // bias offset, -1 without bias
  int pw_off[MAX_LIN];       // the weight's offset in the packed buffer
  int slot0;                 // dropout slot of hidden layer 0
  int save_off;              // smem offset of the saved pre-acts / acts
};

// Mirrored field by field by ops/fused_scan.py::_ScanCfg (all 4-byte fields).
struct ScanCfg {
  int K, B, D, H, O, S, Wmax, n_params, n_leaves;
  int enc_case, enc_mult, ro_case, ro_mult, easy, ict, mode, masked, use_rnn;
  unsigned int thresh;
  float keep, weight;
  int rows, plan, buf_w, smem_floats;   // plan: 0 resident, 1 global
  int gru_wih, gru_whh, gru_bih, gru_bhh;   // GRU leaf offsets, -1: none
  int gru_pwih, gru_pwhh;      // the GRU weights in the packed buffer
  int n_tiles_fwd, n_tiles_bwd, stage;   // global plan: tiles a step, stage
  int leaf_off[MAX_LEAVES + 1];
  int o_w, o_g, o_h, o_lx, o_tau, o_X, o_obs, o_nobs, o_lrow, o_h1, o_h2;
  int o_in_ode, o_tX, o_in_ro, o_f, o_enc, o_ro, o_dA, o_dB, o_dh, o_dlx;
  int o_dtau, o_rs, o_dst, o_dh1, o_dhe, o_df, o_dlxc, o_dtauc, o_M, o_Xi;
  int o_gru, o_dG;             // use_rnn only: saved gates, gate gradients
  int o_gsc, o_ring;           // global plan: GRU gate sums, weight ring
  MLPDesc ode, enc, ro, ro2;   // ro2: the masked branch's post-jump pass
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

// ------------------------------------------- the global plan's weight ring

// Asynchronous copies from device into shared memory (cp.async); a host
// build of these bodies (a CPU rehearsal) copies at once.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
#else
  for (int i = 0; i < 4; ++i) dst[i] = src[i];
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// The ring: two stages of `stage` floats at buf; tile t goes to stage t & 1.
// prog lists one step's tiles (n of them; the list repeats every step),
// TILE_INTS ints each: src (float offset in the packed weights), rows,
// stride (floats between rows in the packed buffer), cols, flags (1: the
// op's last tile, 2: a dx tile), bsrc (the bias's offset, copied after the
// tile, or -1), key (the op's weight offset), unused.
struct Ring {
  const int* prog;
  int n, t, stage;
  float* buf;
  const float* wg;
};

struct Tile {
  const float* w;            // [rows x cols] in shared memory
  const float* b;            // the bias, or null
  int s0, ns, last;          // the summed index's block, the op's last tile
};

// start the copy of tile t into its stage (every thread takes a share)
__device__ void ring_issue(const Ring& rg, int t) {
  const int* d = rg.prog + TILE_INTS * (t % rg.n);
  const int src = __ldg(d), rows = __ldg(d + 1), stride = __ldg(d + 2);
  const int cols = __ldg(d + 3), bsrc = __ldg(d + 5);
  float* dst = rg.buf + (t & 1) * rg.stage;
  const float* s = rg.wg + src;
  const int n = rows * cols;
  if (stride == cols) {                // one contiguous run
    if (((src | n) & 3) == 0)
      for (int e = 4 * threadIdx.x; e < n; e += 4 * NTHREADS)
        cp_async16(dst + e, s + e);
    else
      for (int e = threadIdx.x; e < n; e += NTHREADS)
        cp_async4(dst + e, s + e);
  } else if (((src | stride | cols) & 3) == 0) {  // 16-byte column blocks
    const int c4 = cols >> 2;
    for (int e = threadIdx.x; e < rows * c4; e += NTHREADS) {
      int r = e / c4, q = e - r * c4;
      cp_async16(dst + 4 * e, s + (size_t)r * stride + 4 * q);
    }
  } else {
    const int dr = NTHREADS / cols, dc = NTHREADS - dr * cols;
    int r = threadIdx.x / cols, q = threadIdx.x - r * cols;
    for (; r < rows; r += dr, q += dc) {
      if (q >= cols) { q -= cols; ++r; if (r >= rows) break; }
      cp_async4(dst + r * cols + q, s + (size_t)r * stride + q);
    }
  }
  if (bsrc >= 0)
    for (int j = threadIdx.x; j < rows; j += NTHREADS)
      cp_async4(dst + n + j, rg.wg + bsrc + j);
  cp_async_commit();
}

// Wait for the next tile (it must belong to the op `key` of kind `dx`),
// make it visible to the CTA and start the copy of the tile after it into
// the other stage, which every thread has finished reading at the barrier.
__device__ Tile ring_acquire(Ring& rg, int key, int dx) {
  cp_async_wait_all();
  __syncthreads();
  ring_issue(rg, rg.t + 1);
  const int* d = rg.prog + TILE_INTS * (rg.t % rg.n);
  const int src = __ldg(d), rows = __ldg(d + 1), cols = __ldg(d + 3);
  const int flags = __ldg(d + 4);
  if (__ldg(d + 6) != key || ((flags >> 1) & 1) != dx) __trap();
  Tile tl;
  tl.w = rg.buf + (rg.t & 1) * rg.stage;
  tl.b = __ldg(d + 5) >= 0 ? tl.w + rows * cols : nullptr;
  tl.s0 = dx ? (src - key) / cols : src - key;
  tl.ns = dx ? rows : cols;
  tl.last = flags & 1;
  rg.t++;
  return tl;
}

// acc[rr] += a(r0 + rr, s) * W(o, s) over the tile's block of s, upwards
template <bool DX, class A>
__device__ __forceinline__ void tile_sums(const Tile& tl, int n_o, int r0,
                                          int o, int nr, const A& a,
                                          float (&acc)[RB]) {
  const float* w = DX ? tl.w + o : tl.w + o * tl.ns;
  const int ws = DX ? n_o : 1;
  for (int s = 0; s < tl.ns; ++s) {
    float wv = w[s * ws];
#pragma unroll
    for (int rr = 0; rr < RB; ++rr)
      if (rr < nr) acc[rr] = fmaf(a(r0 + rr, tl.s0 + s), wv, acc[rr]);
  }
}

// One weight op of the global plan through the ring: for r < rows and
// o < n_o, out(r, o, init(r, o) + sum_s a(r, s) * W(o, s) [+ b(o)]), the sum
// over s upwards. The forward kind (DX false) multiplies by W [n_o, n_s]
// (tiles: column blocks with the bias on the last); the dx kind by the
// transpose of W [n_s, n_o] (tiles: row blocks). A thread owns (row block
// q, output o) items, RB rows each: all of them within a tile when the op
// is one tile, else MAXI of them a pass over the op's tiles.
template <bool DX, class A, class I, class O>
__device__ void ring_op(Ring& rg, int key, int n_o, int rows, const A& a,
                        const I& init, const O& out) {
  const int n_items = (rows + RB - 1) / RB * n_o;
  Tile tl = ring_acquire(rg, key, DX);
  if (tl.last) {
    for (int idx = threadIdx.x; idx < n_items; idx += NTHREADS) {
      int q = idx / n_o, o = idx - q * n_o;
      int r0 = q * RB, nr = min(RB, rows - r0);
      float acc[RB];
#pragma unroll
      for (int rr = 0; rr < RB; ++rr)
        acc[rr] = rr < nr ? init(r0 + rr, o) : 0.f;
      tile_sums<DX>(tl, n_o, r0, o, nr, a, acc);
#pragma unroll
      for (int rr = 0; rr < RB; ++rr)
        if (rr < nr) out(r0 + rr, o, tl.b ? acc[rr] + tl.b[o] : acc[rr]);
    }
    return;
  }
  for (int base = 0; base < n_items; base += MAXI * NTHREADS) {
    float acc[MAXI][RB];
#pragma unroll
    for (int m = 0; m < MAXI; ++m) {
      int idx = base + m * NTHREADS + threadIdx.x;
      int q = idx / n_o, o = idx - q * n_o;
      int r0 = q * RB, nr = min(RB, rows - r0);
#pragma unroll
      for (int rr = 0; rr < RB; ++rr)
        acc[m][rr] = idx < n_items && rr < nr ? init(r0 + rr, o) : 0.f;
    }
    for (;;) {
#pragma unroll
      for (int m = 0; m < MAXI; ++m) {
        int idx = base + m * NTHREADS + threadIdx.x;
        if (idx < n_items) {
          int q = idx / n_o, o = idx - q * n_o;
          tile_sums<DX>(tl, n_o, q * RB, o, min(RB, rows - q * RB), a,
                        acc[m]);
        }
      }
      if (tl.last) break;
      tl = ring_acquire(rg, key, DX);
    }
#pragma unroll
    for (int m = 0; m < MAXI; ++m) {
      int idx = base + m * NTHREADS + threadIdx.x;
      if (idx < n_items) {
        int q = idx / n_o, o = idx - q * n_o;
        int r0 = q * RB, nr = min(RB, rows - r0);
#pragma unroll
        for (int rr = 0; rr < RB; ++rr)
          if (rr < nr)
            out(r0 + rr, o, tl.b ? acc[m][rr] + tl.b[o] : acc[m][rr]);
      }
    }
    if (base + MAXI * NTHREADS < n_items) tl = ring_acquire(rg, key, DX);
  }
}

// g[idx] += sum(idx) for idx < n, each element by its one owning thread;
// a thread issues the loads of GB of its elements before it sums them
// (the global plan's gradients in the CTA's partial row)
template <class F>
__device__ __forceinline__ void grad_add(float* __restrict__ g, int n,
                                         const F& sum) {
  for (int base = threadIdx.x; base < n; base += GB * NTHREADS) {
    float old[GB];
#pragma unroll
    for (int u = 0; u < GB; ++u) {
      int idx = base + u * NTHREADS;
      old[u] = idx < n ? g[idx] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < GB; ++u) {
      int idx = base + u * NTHREADS;
      if (idx < n) g[idx] = old[u] + sum(idx);
    }
  }
}

// MLP forward over `rows` rows: saves each hidden layer's pre-activation
// and post-dropout activation at sm + m.save_off (pre [rows, w], act
// [rows, w] per layer) and writes the output to `out`. Ends synced. GW:
// the weights come through the ring (global plan).
template <bool GW>
__device__ void mlp_fwd(const ScanCfg& c, const MLPDesc& m, float* sm,
                        Ring& rg, const float* x, int rows, float* out,
                        const MaskCtx& mc) {
  const float* sw = sm + c.o_w;
  const float* in = x;
  float* save = sm + m.save_off;
  for (int l = 0; l < m.n_lin; ++l) {
    int wi = m.w[l], wo = m.w[l + 1];
    bool last = l == m.n_lin - 1;
    float* y = last ? out : save;
    if constexpr (GW) {
      ring_op<false>(
          rg, m.pw_off[l], wo, rows,
          [&](int r, int s) { return in[r * wi + s]; },
          [](int, int) { return 0.f; },
          [&](int r, int o, float v) { y[r * wo + o] = v; });
    } else {
      const float* b = m.b_off[l] >= 0 ? sw + m.b_off[l] : nullptr;
      linear(sw + m.w_off[l], b, in, wi, wo, rows, y);
    }
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
// GW: the weights come through the ring and the gradients are added into
// `gg`, the CTA's partial row in device memory (global plan); each
// gradient element is updated by the one thread that owns it, in every
// call.
template <bool GW>
__device__ const float* mlp_bwd(const ScanCfg& c, const MLPDesc& m,
                                float* sm, Ring& rg, float* gg,
                                const float* x, int rows, const float* d0,
                                bool want_dx, const MaskCtx& mc) {
  const float* sw = sm + c.o_w;
  float* g = GW ? gg : sm + c.o_g;
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
    auto dw = [&](int idx) {
      int j = idx / wi, i = idx - j * wi;
      float acc = 0.f;
      for (int r = 0; r < rows; ++r) {
        int lr = r >= mc.half ? r - mc.half : r;
        if (lr < mc.nv) acc = fmaf(cur[r * wo + j], a_in[r * wi + i], acc);
      }
      return acc;
    };
    if constexpr (GW) {
      grad_add(g + m.w_off[l], wo * wi, dw);
    } else {
      for (int idx = threadIdx.x; idx < wo * wi; idx += blockDim.x)
        g[m.w_off[l] + idx] += dw(idx);
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
    if constexpr (GW) {
      if (l > 0 || want_dx) {
        // dx as below through the ring, a thread owning column i of up to
        // RB rows
        nxt = bufs[nb];
        nb ^= 1;
        const float* pre = l > 0 ? sm + save_at[l - 1] : nullptr;
        ring_op<true>(
            rg, m.pw_off[l], wi, rows,
            [&](int r, int s) { return cur[r * wo + s]; },
            [](int, int) { return 0.f; },
            [&](int r, int i, float v) {
              if (l > 0) {
                if (mc.mode)
                  v = keep_at(mc, m.slot0 + l - 1, r, i) ? v / mc.keep
                                                          : 0.f;
                v *= act_grad(m.act[l - 1], pre[r * wi + i]);
              }
              nxt[r * wi + i] = v;
            });
      }
    } else if (l > 0 || want_dx) {
      const float* W = sw + m.w_off[l];
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
  mc.k = 0; mc.row0 = row0; mc.nv = nv; mc.half = c.rows; mc.jump = 0;
  mc.B = c.B; mc.S = c.S; mc.Wmax = c.Wmax; mc.keep = c.keep;
  return mc;
}

// readouts with residual: y_bj for row r (row r of h1 / the first half
// of ro), y (row R + r: h2 / the second half)
__device__ __forceinline__ float y_at(const ScanCfg& c, const float* sm,
                                      int R, int rr, int o) {
  const float* hsrc = rr < R ? sm + c.o_h1 + rr * c.H
                             : sm + c.o_h2 + (rr - R) * c.H;
  return residual(c.ro_case, c.ro_mult, hsrc, c.H, o)
         + sm[c.o_ro + rr * c.O + o];
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// The GRU jump forward (_gru_fwd) for R rows: tanh X at tX [R, D], h_t =
// tanh h1 at in_ro[0:R*H]. A thread owns (row r, unit j) and sums the
// three gates' rows of W_ih and W_hh in index order, then writes h2, tanh
// h2 (in_ro[R*H:]) and the saved (r, z, n, gh_n). The global plan first
// runs the gate sums as two ring products, gi = W_ih x and gh = W_hh h_t
// (with their biases, each sum in the same order), into gsc [2][R, 3H].
// Not synced at the end.
template <bool GW>
__device__ void gru_fwd(const ScanCfg& c, float* sm, Ring& rg, int R) {
  const int D = c.D, H = c.H, RH = R * H, H3 = 3 * H;
  const float* sw = sm + c.o_w;
  const float* tX = sm + c.o_tX; float* in_ro = sm + c.o_in_ro;
  const float* h1 = sm + c.o_h1; float* h2 = sm + c.o_h2;
  const float* obs = sm + c.o_obs; float* sv = sm + c.o_gru;
  float* gs = sm + c.o_gsc;
  if constexpr (GW) {
    ring_op<false>(
        rg, c.gru_pwih, H3, R, [&](int r, int s) { return tX[r * D + s]; },
        [](int, int) { return 0.f; },
        [&](int r, int o, float v) { gs[r * H3 + o] = v; });
    ring_op<false>(
        rg, c.gru_pwhh, H3, R,
        [&](int r, int s) { return in_ro[r * H + s]; },
        [](int, int) { return 0.f; },
        [&](int r, int o, float v) { gs[(R + r) * H3 + o] = v; });
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < RH; idx += blockDim.x) {
    int r = idx / H, j = idx - r * H;
    const float* x = tX + r * D;
    const float* ht = in_ro + r * H;
    float gi[3], gh[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if constexpr (GW) {
        gi[q] = gs[r * H3 + q * H + j];
        gh[q] = gs[(R + r) * H3 + q * H + j];
      } else {
        const float* wi = sw + c.gru_wih + (size_t)(q * H + j) * D;
        const float* wh = sw + c.gru_whh + (size_t)(q * H + j) * H;
        float a = 0.f, b = 0.f;
        for (int i = 0; i < D; ++i) a = fmaf(x[i], wi[i], a);
        for (int i = 0; i < H; ++i) b = fmaf(ht[i], wh[i], b);
        if (c.gru_bih >= 0) {
          a += sw[c.gru_bih + q * H + j];
          b += sw[c.gru_bhh + q * H + j];
        }
        gi[q] = a;
        gh[q] = b;
      }
    }
    float rg = sigmoid_f(gi[0] + gh[0]);
    float z = sigmoid_f(gi[1] + gh[1]);
    float n = tanhf(gi[2] + rg * gh[2]);
    float hp = (1.f - z) * n + z * ht[j];
    sv[idx] = rg;
    sv[RH + idx] = z;
    sv[2 * RH + idx] = n;
    sv[3 * RH + idx] = gh[2];
    float o = obs[r];
    float b2 = o * hp + (1.f - o) * h1[idx];
    h2[idx] = b2;
    in_ro[RH + idx] = tanhf(b2);
  }
}

// dgh of gate row gj (0..3H) at row r: da_r, da_z for r and z, dgh_n for n
__device__ __forceinline__ float dgh_at(const float* dG, int H, int r,
                                        int gj) {
  return dG[r * 4 * H + (gj < 2 * H ? gj : gj + H)];
}

// The GRU jump backward (_gru_bwd) for the CTA's nv valid rows of R, from
// dh' = dhe (obs * dh2) and the saved gates; adds the four leaves'
// gradients to g (shared memory, or the CTA's partial row in the global
// plan; one owning thread per element), and dh_t * (1 - h_t^2) to dh1,
// then df = dt * dh1 (its W_hh product through the ring in the global
// plan). Starts and ends synced.
template <bool GW>
__device__ void gru_bwd(const ScanCfg& c, float* sm, Ring& rg, float* g,
                        int R, int nv, float dt) {
  const int D = c.D, H = c.H, RH = R * H, H3 = 3 * H;
  const float* sw = sm + c.o_w;
  const float* tX = sm + c.o_tX; const float* ht = sm + c.o_in_ro;
  const float* sv = sm + c.o_gru; float* dG = sm + c.o_dG;
  const float* dhe = sm + c.o_dhe;
  float* dh1 = sm + c.o_dh1; float* df = sm + c.o_df;
  for (int idx = threadIdx.x; idx < RH; idx += blockDim.x) {
    int r = idx / H, j = idx - r * H;
    float rg = sv[idx], z = sv[RH + idx], n = sv[2 * RH + idx];
    float d = dhe[idx];
    float da_n = d * (1.f - z) * (1.f - n * n);
    float* q = dG + r * 4 * H;
    q[j] = da_n * sv[3 * RH + idx] * rg * (1.f - rg);         // da_r
    q[H + j] = d * (ht[idx] - n) * z * (1.f - z);             // da_z
    q[2 * H + j] = da_n;                                      // dgi_n
    q[3 * H + j] = da_n * rg;                                 // dgh_n
  }
  __syncthreads();
  auto dwi = [&](int idx) {
    int gj = idx / D, i = idx - gj * D;
    float acc = 0.f;
    for (int r = 0; r < nv; ++r)
      acc = fmaf(dG[r * 4 * H + gj], tX[r * D + i], acc);
    return acc;
  };
  auto dwh = [&](int idx) {
    int gj = idx / H, i = idx - gj * H;
    float acc = 0.f;
    for (int r = 0; r < nv; ++r)
      acc = fmaf(dgh_at(dG, H, r, gj), ht[r * H + i], acc);
    return acc;
  };
  if constexpr (GW) {
    grad_add(g + c.gru_wih, H3 * D, dwi);
    grad_add(g + c.gru_whh, H3 * H, dwh);
  } else {
    for (int idx = threadIdx.x; idx < H3 * D; idx += blockDim.x)
      g[c.gru_wih + idx] += dwi(idx);
    for (int idx = threadIdx.x; idx < H3 * H; idx += blockDim.x)
      g[c.gru_whh + idx] += dwh(idx);
  }
  if (c.gru_bih >= 0)
    for (int gj = threadIdx.x; gj < H3; gj += blockDim.x) {
      float a = 0.f, b = 0.f;
      for (int r = 0; r < nv; ++r) {
        a += dG[r * 4 * H + gj];
        b += dgh_at(dG, H, r, gj);
      }
      g[c.gru_bih + gj] += a;
      g[c.gru_bhh + gj] += b;
    }
  auto dh1_out = [&](int r, int i, float acc) {
    int idx = r * H + i;
    float t = ht[idx];
    float d1 = dh1[idx] + acc * (1.f - t * t);
    dh1[idx] = d1;
    df[idx] = dt * d1;
  };
  if constexpr (GW) {
    ring_op<true>(
        rg, c.gru_pwhh, H, R,
        [&](int r, int s) { return dgh_at(dG, H, r, s); },
        [&](int r, int i) { return dhe[r * H + i] * sv[RH + r * H + i]; },
        dh1_out);
  } else {
    const float* Whh = sw + c.gru_whh;
    for (int idx = threadIdx.x; idx < RH; idx += blockDim.x) {
      int r = idx / H, i = idx - r * H;
      float acc = dhe[idx] * sv[RH + idx];                    // dh' * z
      for (int gj = 0; gj < H3; ++gj)
        acc = fmaf(dgh_at(dG, H, r, gj), Whh[gj * H + i], acc);
      dh1_out(r, i, acc);
    }
  }
  __syncthreads();
}

// One step forward for the CTA's rows, from the carries in smem (h, lx,
// tau, X, obs and, masked, M already loaded): fills h1, h2, the jump's
// input tX, the ODE input, the readout inputs and outputs (y_bj rows
// 0..R-1, y rows R..2R-1), with every MLP's saved activations (and, with
// use_rnn, the GRU's saved gates).
template <bool GW, int RT>
__device__ void step_forward(const ScanCfg& c, float* sm, Ring& rg,
                             float t, float dt, MaskCtx& mc) {
  const int R = RT ? RT : c.rows, D = c.D, H = c.H, O = c.O;
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
  if (!c.masked || c.use_rnn)      // the encoder's or the GRU's input
    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x)
      tX[idx] = tanhf(X[idx]);
  __syncthreads();
  mc.half = R; mc.jump = 0;
  mlp_fwd<GW>(c, c.ode, sm, rg, in_ode, R, sm + c.o_f, mc);
  float* f = sm + c.o_f; float* enc = sm + c.o_enc;
  float* h1 = sm + c.o_h1; float* h2 = sm + c.o_h2;
  float* in_ro = sm + c.o_in_ro;
  if (c.masked && !c.use_rnn) {
    const float* M = sm + c.o_M;
    float* Xi = sm + c.o_Xi;
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      float a = h[idx] + dt * f[idx];
      h1[idx] = a;
      in_ro[idx] = tanhf(a);
    }
    __syncthreads();
    mlp_fwd<GW>(c, c.ro, sm, rg, in_ro, R, sm + c.o_ro, mc);  // y_bj, r1
    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
      int r = idx / D, q = idx - r * D;
      float m = M[idx];
      float xi = X[idx] * m + (1.f - m) * y_at(c, sm, R, r, q);
      Xi[idx] = xi;
      tX[r * 2 * D + q] = tanhf(xi);
      tX[r * 2 * D + D + q] = m;
    }
    __syncthreads();
    mlp_fwd<GW>(c, c.enc, sm, rg, tX, R, enc, mc);
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      int r = idx / H, j = idx - r * H;
      float he = residual(c.enc_case, c.enc_mult, Xi + r * D, D, j)
                 + enc[idx];
      float o = obs[r];
      float b = o * he + (1.f - o) * h1[idx];
      h2[idx] = b;
      in_ro[R * H + idx] = tanhf(b);
    }
    __syncthreads();
    mlp_fwd<GW>(c, c.ro2, sm, rg, in_ro + R * H, R, sm + c.o_ro + R * O,
                mc);
    mc.half = 2 * R;
    return;
  }
  if (c.use_rnn) {
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      float a = h[idx] + dt * f[idx];
      h1[idx] = a;
      in_ro[idx] = tanhf(a);
    }
    __syncthreads();
    gru_fwd<GW>(c, sm, rg, R);
  } else {
    mlp_fwd<GW>(c, c.enc, sm, rg, tX, R, enc, mc);
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      int r = idx / H, j = idx - r * H;
      float a = h[idx] + dt * f[idx];
      float he = residual(c.enc_case, c.enc_mult, X + r * D, D, j)
                 + enc[idx];
      float o = obs[r];
      float b = o * he + (1.f - o) * a;
      h1[idx] = a;
      h2[idx] = b;
      in_ro[idx] = tanhf(a);
      in_ro[R * H + idx] = tanhf(b);
    }
  }
  __syncthreads();
  mc.half = R; mc.jump = c.ro.n_lin - 1;   // rows >= R use the r2 slots
  mlp_fwd<GW>(c, c.ro, sm, rg, in_ro, 2 * R, sm + c.o_ro, mc);
  mc.half = 2 * R;                          // no stacked rows elsewhere
}

// the step's loss gradients wrt (e1, e2) per row, or its loss term: the
// masked coordinates (M) count only where observed
__device__ __forceinline__ void row_errors(const ScanCfg& c,
                                           const float* sm, int R, int r,
                                           float& s1, float& s2, float& g) {
  const int D = c.D;
  const float* X = sm + c.o_X;
  const float* M = sm + c.o_M;
  float e1 = 0.f, e2 = 0.f;
  for (int o = 0; o < c.O; ++o) {
    float yb = y_at(c, sm, R, r, o), y = y_at(c, sm, R, R + r, o);
    float x = X[r * D + o];
    float m = c.masked ? M[r * D + o] : 1.f;
    float d1 = x - y, d2 = yb - (c.easy ? x : y);
    e1 += m * d1 * d1;
    e2 += m * d2 * d2;
  }
  s1 = sqrtf(e1 + 1e-10f);
  s2 = sqrtf(e2 + 1e-10f);
  float fac = c.easy ? 1.f : 2.f;
  g = fac * c.weight * s1 + fac * (1.f - c.weight) * s2;
}

template <bool WANT_HISTS, bool GW, int RT>
__global__ void __launch_bounds__(NTHREADS)
njode_scan_fwd_kernel(ScanCfg c, Leaves lv, const float* __restrict__ wg,
                      const int* __restrict__ prog,
                      const float* __restrict__ times,
                      const float* __restrict__ dts,
                      const float* __restrict__ obs_g,
                      const float* __restrict__ X_g,
                      const float* __restrict__ M_g, const int8_t* u,
                      const long long* seed,
                      const float* __restrict__ n_obs,
                      const float* __restrict__ h0,
                      const float* __restrict__ sx, float* loss_part,
                      float* hh, float* lxh, float* tauh) {
  extern __shared__ float sm[];
  const int R = RT ? RT : c.rows, D = c.D, H = c.H, B = c.B;
  const int row0 = blockIdx.x * R;
  const int nv = min(R, B - row0);
  if (!GW) load_weights(c, lv, sm);
  float* h = sm + c.o_h; float* lx = sm + c.o_lx; float* tau = sm + c.o_tau;
  float* X = sm + c.o_X; float* obs = sm + c.o_obs;
  float* nobs = sm + c.o_nobs; float* lrow = sm + c.o_lrow;
  float* Mm = sm + c.o_M;
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
  // the global plan's weight ring: the forward's tiles, step after step
  Ring rg{prog, c.n_tiles_fwd, 0, c.stage, sm + c.o_ring, wg};
  if (GW) ring_issue(rg, 0);
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
      size_t gi = ((size_t)k * B + row0) * D + idx;
      X[idx] = r < nv ? X_g[gi] : 0.f;
      if (c.masked) Mm[idx] = r < nv ? M_g[gi] : 0.f;
    }
    mc.k = k;
    step_forward<GW, RT>(c, sm, rg, t, dt, mc);
    // per-row loss term, then the carry updates (masked: last_X takes the
    // post-jump prediction, O == D)
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      float s1, s2, g;
      row_errors(c, sm, R, r, s1, s2, g);
      lrow[r] += obs[r] * g * g / fmaxf(nobs[r], 1.f);
      if (obs[r] > 0.f) tau[r] = t;
    }
    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
      int r = idx / D;
      if (obs[r] > 0.f)
        lx[idx] = c.masked ? y_at(c, sm, R, R + r, idx - r * D) : X[idx];
    }
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x)
      h[idx] = sm[c.o_h2 + idx];
    __syncthreads();
  }
  if (GW) cp_async_wait_all();   // the next step's first tile, unused
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < nv; ++r) s += lrow[r];
    loss_part[blockIdx.x] = s;
  }
}

template <bool GW, int RT>
__global__ void __launch_bounds__(NTHREADS)
njode_scan_bwd_kernel(ScanCfg c, Leaves lv, const float* __restrict__ wg,
                      const int* __restrict__ prog,
                      const float* __restrict__ times,
                      const float* __restrict__ dts,
                      const float* __restrict__ obs_g,
                      const float* __restrict__ X_g,
                      const float* __restrict__ M_g, const int8_t* u,
                      const long long* seed,
                      const float* __restrict__ n_obs,
                      const float* __restrict__ hh,
                      const float* __restrict__ lxh,
                      const float* __restrict__ tauh, const float* dloss_p,
                      float* partials, float* dh0) {
  extern __shared__ float sm[];
  const int R = RT ? RT : c.rows, D = c.D, H = c.H, O = c.O, B = c.B;
  const int row0 = blockIdx.x * R;
  const int nv = min(R, B - row0);
  const int iw = c.ode.w[0];
  if (!GW) load_weights(c, lv, sm);
  // the gradient accumulator: shared memory, or (global plan) this CTA's
  // partial row, zeroed here and added into in place every step
  float* g = GW ? partials + (size_t)blockIdx.x * c.n_params : sm + c.o_g;
  for (int i = threadIdx.x; i < c.n_params; i += blockDim.x) g[i] = 0.f;
  float* h = sm + c.o_h; float* lx = sm + c.o_lx; float* tau = sm + c.o_tau;
  float* X = sm + c.o_X; float* obs = sm + c.o_obs; float* nobs = sm + c.o_nobs;
  float* dh = sm + c.o_dh; float* dlx = sm + c.o_dlx; float* dtau = sm + c.o_dtau;
  float* rs = sm + c.o_rs; float* dst = sm + c.o_dst; float* dh1 = sm + c.o_dh1;
  float* dhe = sm + c.o_dhe; float* df = sm + c.o_df;
  float* dlxc = sm + c.o_dlxc; float* dtauc = sm + c.o_dtauc;
  float* Mm = sm + c.o_M;
  for (int i = threadIdx.x; i < R * H; i += blockDim.x) dh[i] = 0.f;
  for (int i = threadIdx.x; i < R * D; i += blockDim.x) dlx[i] = 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    dtau[r] = 0.f;
    nobs[r] = r < nv ? n_obs[row0 + r] : 1.f;
  }
  const float dloss = dloss_p[0];
  MaskCtx mc = make_mask_ctx(c, u, seed, row0, nv);
  // the global plan's weight ring: the forward's tiles, then the
  // backward's, step after step
  Ring rg{prog, c.n_tiles_fwd + c.n_tiles_bwd, 0, c.stage, sm + c.o_ring, wg};
  if (GW) ring_issue(rg, 0);
  __syncthreads();
  for (int k = c.K - 1; k >= 0; --k) {
    const float t = times[k], dt = dts[k];
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x)
      h[idx] = idx / H < nv ? hh[((size_t)k * B + row0) * H + idx] : 0.f;
    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
      bool ok = idx / D < nv;
      size_t gi = ((size_t)k * B + row0) * D + idx;
      lx[idx] = ok ? lxh[gi] : 0.f;
      X[idx] = ok ? X_g[gi] : 0.f;
      if (c.masked) Mm[idx] = ok ? M_g[gi] : 0.f;
    }
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      bool ok = r < nv;
      tau[r] = ok ? tauh[(size_t)k * B + row0 + r] : 0.f;
      obs[r] = ok ? obs_g[(size_t)k * B + row0 + r] : 0.f;
    }
    mc.k = k;
    step_forward<GW, RT>(c, sm, rg, t, dt, mc);
    // loss gradients per row: rs = (de1, de2)
    for (int r = threadIdx.x; r < R; r += blockDim.x) {
      float s1, s2, gg;
      row_errors(c, sm, R, r, s1, s2, gg);
      float fac = c.easy ? 1.f : 2.f;
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
    // d_stack = [dy_bj ; dy]; masked: M weighs each coordinate, and
    // last_X2 = where(obs, y, last_X) adds obs * dlast_X to dy
    for (int idx = threadIdx.x; idx < R * O; idx += blockDim.x) {
      int r = idx / O, o = idx - r * O;
      float yb = y_at(c, sm, R, r, o), y = y_at(c, sm, R, R + r, o);
      float x = X[r * D + o];
      float m = c.masked ? Mm[r * D + o] : 1.f;
      float de1 = rs[2 * r] * m, de2 = rs[2 * r + 1] * m;
      float dy = de1 * 2.f * (y - x);
      float dyb = de2 * 2.f * (yb - (c.easy ? x : y));
      if (!c.easy) dy += de2 * 2.f * (y - yb);
      if (c.masked) dy += obs[r] * dlx[r * D + o];
      dst[idx] = dyb;
      dst[R * O + idx] = dy;
    }
    __syncthreads();
    const float* in_ro = sm + c.o_in_ro;
    if (!c.masked || c.use_rnn) {
      // stacked readout backward
      mc.half = R; mc.jump = c.ro.n_lin - 1;
      const float* d_rin = mlp_bwd<GW>(c, c.ro, sm, rg, g, in_ro, 2 * R,
                                       dst, true, mc);
      for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
        int r = idx / H, j = idx - r * H;
        float a1 = in_ro[idx], a2 = in_ro[R * H + idx];
        float dt1 = d_rin[idx] * (1.f - a1 * a1)
                    + residual_bwd(c.ro_case, c.ro_mult, dst + r * O, O, j);
        float dt2 = d_rin[R * H + idx] * (1.f - a2 * a2)
                    + residual_bwd(c.ro_case, c.ro_mult, dst + (R + r) * O,
                                   O, j);
        float o = obs[r];
        float d2 = dh[idx] + dt2;
        dhe[idx] = o * d2;
        float d1 = (1.f - o) * d2 + dt1;
        dh1[idx] = d1;
        df[idx] = dt * d1;
      }
      __syncthreads();
      mc.half = 2 * R; mc.jump = 0;
      // the jump's backward: X is data, only the weights get gradients
      if (c.use_rnn) gru_bwd<GW>(c, sm, rg, g, R, nv, dt);
      else mlp_bwd<GW>(c, c.enc, sm, rg, g, sm + c.o_tX, R, dhe, false, mc);
    } else {
      mc.half = 2 * R; mc.jump = 0;
      // post-jump readout backward (input tanh h2)
      const float* d_r2 = mlp_bwd<GW>(c, c.ro2, sm, rg, g, in_ro + R * H,
                                      R, dst + R * O, true, mc);
      for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
        int r = idx / H, j = idx - r * H;
        float a2 = in_ro[R * H + idx];
        float d2 = dh[idx] + d_r2[idx] * (1.f - a2 * a2)
                   + residual_bwd(c.ro_case, c.ro_mult, dst + (R + r) * O, O,
                                  j);
        float o = obs[r];
        dhe[idx] = o * d2;
        dh1[idx] = (1.f - o) * d2;
      }
      __syncthreads();
      // encoder backward to its input [tanh X_imp, M]; X_imp = X*M +
      // (1-M)*y_bj, X and M are data, so dX_imp flows into dy_bj
      const float* d_ein = mlp_bwd<GW>(c, c.enc, sm, rg, g, sm + c.o_tX, R,
                                       dhe, true, mc);
      const float* tX = sm + c.o_tX;
      for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
        int r = idx / D, q = idx - r * D;
        float tx = tX[r * 2 * D + q];
        float dxi = d_ein[r * 2 * D + q] * (1.f - tx * tx)
                    + residual_bwd(c.enc_case, c.enc_mult, dhe + r * H, H, q);
        dst[r * O + q] += (1.f - Mm[idx]) * dxi;
      }
      __syncthreads();
      // pre-jump readout backward (input tanh h1)
      const float* d_r1 = mlp_bwd<GW>(c, c.ro, sm, rg, g, in_ro, R, dst,
                                      true, mc);
      for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
        int r = idx / H, j = idx - r * H;
        float a1 = in_ro[idx];
        float d1 = dh1[idx] + d_r1[idx] * (1.f - a1 * a1)
                   + residual_bwd(c.ro_case, c.ro_mult, dst + r * O, O, j);
        dh1[idx] = d1;
        df[idx] = dt * d1;
      }
      __syncthreads();
    }
    // Euler step backward: h1 = h + dt * f(ode_in)
    const float* dino = mlp_bwd<GW>(c, c.ode, sm, rg, g, sm + c.o_in_ode, R,
                                    df, true, mc);
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
  if (GW) cp_async_wait_all();   // the next step's first tile, unused
  for (int idx = threadIdx.x; idx < nv * H; idx += blockDim.x)
    dh0[(size_t)row0 * H + idx] = dh[idx];
  if (!GW)
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

// the rows per CTA and the plan the config names, and the packed weights
// and the ring's tile program exactly when the plan is global
static bool cfg_ok(const ScanCfg* c, const float* wg, const int* prog) {
  return c->rows >= 1 && c->rows <= MAX_ROWS
         && (c->plan == 0 || c->plan == 1)
         && (c->plan == 1) == (wg != nullptr)
         && (c->plan == 1) == (prog != nullptr);
}

// reduce_partials on the stream
static cudaError_t launch_reduce(const float* P, int n_parts, int n,
                                 float scale, float* out, cudaStream_t st) {
  int threads = 256, grid = (n + threads - 1) / threads;
  reduce_partials_kernel<<<grid, threads, 0, st>>>(P, n_parts, n, scale, out);
  return cudaGetLastError();
}

template <bool H, bool GW, int RT>
static cudaError_t launch_fwd(const ScanCfg* c, const Leaves& lv,
                              const float* wg, const int* prog,
                              const float* times, const float* dts,
                              const float* obs, const float* X,
                              const float* M, const int8_t* u,
                              const long long* seed, const float* n_obs,
                              const float* h0, const float* sx,
                              float* loss_part, float* hh, float* lxh,
                              float* tauh, cudaStream_t st) {
  int grid = (c->B + c->rows - 1) / c->rows;
  size_t smem = (size_t)c->smem_floats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      njode_scan_fwd_kernel<H, GW, RT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  njode_scan_fwd_kernel<H, GW, RT><<<grid, NTHREADS, smem, st>>>(
      *c, lv, wg, prog, times, dts, obs, X, M, u, seed, n_obs, h0, sx,
      loss_part, hh, lxh, tauh);
  return cudaGetLastError();
}

// RT, the rows per CTA as a compile-time constant: MAX_ROWS (the row loops
// of the default plans unroll), else 0 (read from c.rows)
template <bool H, bool GW>
static decltype(&launch_fwd<H, GW, 0>) fwd_for_rows(const ScanCfg* c) {
  return c->rows == MAX_ROWS ? launch_fwd<H, GW, MAX_ROWS>
                             : launch_fwd<H, GW, 0>;
}

// K1 (want_hists) or K3, then the reduction of the per-CTA losses into
// loss[0] (scaled by loss_scale), both on the stream. wg: the weights
// packed at pack_off (global plan), prog: the ring's tile program (global
// plan), else null.
extern "C" int njode_scan_fwd(const ScanCfg* c, void** leaves,
                              const float* wg, const int* prog,
                              const float* times, const float* dts,
                              const float* obs, const float* X,
                              const float* M,
                              const int8_t* u, const long long* seed,
                              const float* n_obs, const float* h0,
                              const float* sx, float* loss_part, float* loss,
                              float* hh, float* lxh, float* tauh,
                              int want_hists, float loss_scale,
                              void* stream) {
  if (!cfg_ok(c, wg, prog)) return (int)cudaErrorInvalidValue;
  Leaves lv = make_leaves(c, leaves);
  cudaStream_t st = (cudaStream_t)stream;
  auto f = want_hists ? (c->plan ? fwd_for_rows<true, true>(c)
                                 : fwd_for_rows<true, false>(c))
                      : (c->plan ? fwd_for_rows<false, true>(c)
                                 : fwd_for_rows<false, false>(c));
  cudaError_t e = f(c, lv, wg, prog, times, dts, obs, X, M, u, seed, n_obs,
                    h0, sx, loss_part, hh, lxh, tauh, st);
  if (e != cudaSuccess) return (int)e;
  int n_cta = (c->B + c->rows - 1) / c->rows;
  return (int)launch_reduce(loss_part, n_cta, 1, loss_scale, loss, st);
}

template <bool GW, int RT>
static cudaError_t launch_bwd(const ScanCfg* c, const Leaves& lv,
                              const float* wg, const int* prog,
                              const float* times, const float* dts,
                              const float* obs, const float* X,
                              const float* M, const int8_t* u,
                              const long long* seed, const float* n_obs,
                              const float* hh, const float* lxh,
                              const float* tauh, const float* dloss,
                              float* partials, float* dh0, cudaStream_t st) {
  int grid = (c->B + c->rows - 1) / c->rows;
  size_t smem = (size_t)c->smem_floats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      njode_scan_bwd_kernel<GW, RT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  njode_scan_bwd_kernel<GW, RT><<<grid, NTHREADS, smem, st>>>(
      *c, lv, wg, prog, times, dts, obs, X, M, u, seed, n_obs, hh, lxh,
      tauh, dloss, partials, dh0);
  return cudaGetLastError();
}

template <bool GW>
static decltype(&launch_bwd<GW, 0>) bwd_for_rows(const ScanCfg* c) {
  return c->rows == MAX_ROWS ? launch_bwd<GW, MAX_ROWS> : launch_bwd<GW, 0>;
}

// K2, then the reduction of its partial rows ([n_cta, n_params]) into
// grads [n_params], both on the stream
extern "C" int njode_scan_bwd(const ScanCfg* c, void** leaves,
                              const float* wg, const int* prog,
                              const float* times, const float* dts,
                              const float* obs, const float* X,
                              const float* M,
                              const int8_t* u, const long long* seed,
                              const float* n_obs, const float* hh,
                              const float* lxh, const float* tauh,
                              const float* dloss, float* partials,
                              float* grads, float* dh0, void* stream) {
  if (!cfg_ok(c, wg, prog)) return (int)cudaErrorInvalidValue;
  Leaves lv = make_leaves(c, leaves);
  cudaStream_t st = (cudaStream_t)stream;
  auto f = c->plan ? bwd_for_rows<true>(c) : bwd_for_rows<false>(c);
  cudaError_t e = f(c, lv, wg, prog, times, dts, obs, X, M, u, seed, n_obs,
                    hh, lxh, tauh, dloss, partials, dh0, st);
  if (e != cudaSuccess) return (int)e;
  int n_cta = (c->B + c->rows - 1) / c->rows;
  return (int)launch_reduce(partials, n_cta, c->n_params, 1.f, grads, st);
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

// out = scale * the sum of partials' rows (row q at partials + q * n)
extern "C" int njode_reduce_partials(const float* partials, int n_parts,
                                     int n, float scale, float* out,
                                     void* stream) {
  return (int)launch_reduce(partials, n_parts, n, scale, out,
                            (cudaStream_t)stream);
}
