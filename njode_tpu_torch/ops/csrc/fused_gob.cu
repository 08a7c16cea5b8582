// Hand-written Hopper kernels for the GRU-ODE-Bayes training scan (sm_90a).
//
// Replaces the Pallas TPU kernels of njode_tpu/ops/fused_gob.py:
//   gob_scan_fwd_kernel<R, true, GA>   K5  _fwd_impl / _make_fwd_kernel
//                                          (training forward: loss and the
//                                          step-entry histories)
//   gob_scan_fwd_kernel<R, false, GA>  K5  eval form (_make_fwd_kernel,
//                                          want_hists False: loss only)
//   gob_remat_kernel<R, GA>            K6  _fused_bwd / _make_bwd_kernel,
//   gob_chain_kernel<R, GA>                stage (a) remat, (b) chain, (c)
//   gob_wgrad_kernel                       wgrad
//   mask words (fill_masks)        K7  _step_masks (p_model keep-masks, 3
//                                      slots per step: ode-midpoint,
//                                      ode-final, post-jump)
//   gob_masks_kernel                   the same masks written out (tests,
//                                      timing)
// R, the batch rows one CTA owns, is one of 1, 2, 4, 8, 16
// (ops/fused_gob.py Spec.rows_for picks it). GA: the device-memory form of
// the activations (below), at R = 1 only. The per-CTA loss partials and
// stage (c)'s gradient partial rows are summed by reduce_partials in
// fused_scan.cu, in a fixed order (no float atomics: runs repeat bit for
// bit).
//
// Design. The scan is K sequential steps of small dependent products over
// the state (h, mean, var) of each batch row. What bounds it on this card
// is latency, not flops or bytes (about 28,250 MACs a row-step forward at
// hidden 50: a K5 call at B = 20, K = 100 is 113 MFLOP, under 2 us at the
// 67 TFLOP/s fp32 peak): a chain of K steps of dependent phases, each a
// barrier and an FMA chain. So:
// - a CTA owns few rows (one at the published training batches, eight at
//   the eval's 2,000), so that the batch spreads over the 132 SMs and a
//   phase takes one pass or few of the CTA's threads (256; 512 where the
//   weights come from L2, to keep more of their loads in flight);
// - every output of a product is split over S lanes of a warp (S a power
//   of two, from the phase's outputs and input width): each lane runs
//   in/S FMAs and the lanes reduce with __shfl_xor_sync in a fixed order;
// - independent products share one phase behind one barrier (a field's r
//   and z gates, p_model's two heads, the four prep products, the
//   observation GRU's six products, the backward's transposed products
//   into one gradient), and elementwise steps ride in the epilogue of the
//   product before them;
// - the weights (105 KB at hidden 50, 409 KB at 100) are staged into
//   shared memory once per CTA by K5 and the chain where they fit beside
//   the activations and the batch takes one CTA an SM (hidden 50, the
//   climate arm), else read through L1/L2; the activations live in
//   shared memory, reached from the out-of-line step bodies through
//   offsets into the dynamic array (so those loads stay in the shared
//   address space); each kernel copies the call's configuration and leaf
//   pointers from its parameters into shared memory first, where those
//   bodies read them;
// - K6 keeps only the carry gradients on its sequential chain: stage (a)
//   re-runs every step of a chunk at once from the stored carries (the
//   same device code as K5, so the same bits) into a device workspace;
//   stage (b) walks the chunk backwards at R rows a CTA, cp.async bringing
//   the next step's activations while it works, and writes every delta a
//   weight gradient needs; stage (c) sums x^T d over all (step, row) pairs
//   of the chunk for every weight, in an order that does not depend on R;
// - the dropout masks (K7) are bits in shared memory (philox.cuh's mask
//   words, region mw: per row and slot cc.nw words), one draw a quad of
//   columns: K5 fills a step's words in the phase that loads its inputs,
//   on the threads past those loads, while they are in flight (no barrier
//   added; the call sits in step_fwd, out of line: in the kernels' own
//   bodies it slowed K5 2-6 %, masks or not), stage (a) likewise, and
//   stage (b) draws none: p_model's hidden layer is relu, so the mask's
//   part of its backward, relu'(pre) * keep / (1 - rate), is a != 0 ? 1 /
//   (1 - rate) : 0 on the saved post-dropout activation a (bit for bit,
//   NaN and -0 included);
// - where one row's buffers do not fit one CTA's shared memory (p_hidden
//   4,000: 244-301 KB a row in the chain), the device-memory form (GA,
//   cc.ga) keeps the widest of them (Spec.slab_classes: the P-wide first,
//   then the D*prep-wide, then the rest) in a slab of device memory that
//   the CTA owns (a few hundred KB, which stays in L2 at the training
//   batches) and the others in shared memory. A buffer's offset carries
//   SLAB_BIT where it lies in the slab (ap), so the step bodies, templated
//   on GA, run the same arithmetic in the same order on either form and
//   the two give the same bits; the shared form compiles as before. In the
//   chain the slab holds its two copies of the forward part (stage (a)'s
//   buffers come in by plain loads and stores, cp.async reaching only
//   shared memory) and its own.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"          // K7: philox_keep4, mask words, mask rows

#define MAX_NT 512          // threads of a scan CTA: 256 or 512 (cfg.threads)
#define NT ((int)blockDim.x)
#define WG_NT 256           // threads of a stage (c) CTA
#define MAX_LEAVES 40
#define MAX_SAVE 48
#define MAX_DLT 32
#define WG_TILE 32
// an activation offset with this bit set lies in the CTA's slab of device
// memory (the device-memory form, cc.ga), the rest of it its offset there
#define SLAB_BIT (1 << 28)

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
// save_*: the buffers stage (a) writes to the workspace (shared offset in
// the forward layout, workspace region, width); dlt_*: the deltas stage
// (b) writes (dlt_prop: 0 on a dt == 0 padding step).
struct GobCfg {
  int K, B, D, H, P, DP, prep, n_params, n_leaves;
  int full, impute, logvar, prop, bias, mode;  // prop 0 euler 1 mid 2 disc
  unsigned int thresh;
  float keep, mixing;
  int rows, fwd_floats, smem_floats, n_ws, n_save, n_dlt;
  int wsm, o_w;              // weights staged in shared memory at o_w
  int threads;               // threads of a K5 / stage (a) / (b) CTA
  int o_mw, n_mw, nw, lg_nw; // the mask words (K5, stage a; past the staged
                             // weights, the end of K5's dynamic memory):
                             // offset, floats, words of a row and slot
                             // (ceil(P / 32)), log2 of the power of two >= nw
  int ga;                    // the device-memory form: buffers whose offset
                             // has SLAB_BIT live in the CTA's slab
  int slab_fwd, slab_floats; // floats of a slab: the forward buffers (K5,
                             // stage a), the chain's (two copies of them,
                             // then its own)
  int leaf_off[MAX_LEAVES + 1];
  int pm[6];
  int fxm[3], fxv[3], fxb[3], fh[3], fhb[3];
  int wp[4], bp[1], ih[3], hh[3], bih[3], bhh[3];
  int save_sm[MAX_SAVE], save_ws[MAX_SAVE], save_w[MAX_SAVE];
  int dlt_sm[MAX_DLT], dlt_ws[MAX_DLT], dlt_w[MAX_DLT], dlt_prop[MAX_DLT];
  int o_h, o_m, o_v, o_X, o_M, o_obs, o_lrow, o_nll;
  int o_f1a, o_f1b, o_f1c, o_f1d, o_fo, o_kk, o_mk, o_vk, o_prek, o_ak;
  int o_f2a, o_f2b, o_f2c, o_f2d, o_h1p, o_pre1, o_a1, o_m1p, o_v1p;
  int o_h1, o_m1, o_v1, o_err, o_ft2, o_pre, o_gin;
  int o_ga, o_gb, o_gc, o_gd, o_gt, o_h2, o_pre2, o_a2, o_m2p, o_v2p;
  int o_m2, o_v2;
  int o_dh, o_dm, o_dv, o_dh1, o_dm1, o_dv1, o_dm2, o_dv2, o_dp2;
  int o_og0, o_og1, o_og2, o_og3, o_dx, o_dfm, o_dff, o_dfe, o_dp1;
  int o_pg0, o_pg1, o_pg2, o_pg3, o_e1a0, o_e1a1, o_e1a2;
  int o_e2a0, o_e2a1, o_e2a2, o_dp0, o_dmk, o_dvk, o_df, o_dhf, o_dkk;
};

struct Leaves { const float* p[MAX_LEAVES]; };

// one call's configuration and weights: each kernel takes them as
// parameters and copies them here first (load_call), where the
// out-of-line step bodies read them (about 2.2 KB beside the dynamic
// buffers; ops/fused_gob.py SMEM_LIMIT leaves room for them)
__shared__ GobCfg cc;
__shared__ Leaves cl;
__shared__ float* cslab;     // the CTA's slab (device-memory form)

extern __shared__ float sm[];

// The buffer at activation offset `off`: in shared memory, or (GA, the
// device-memory form, where the offset has SLAB_BIT) in the CTA's slab.
// The shared form (GA false) compiles to sm + off as before.
template <bool GA>
__device__ __forceinline__ float* ap(int off) {
  if (GA && (off & SLAB_BIT)) return cslab + (off ^ SLAB_BIT);
  return sm + off;
}

// forward buffer o of the layout copy at ab (0, or the chain's second copy
// at cc.fwd_floats; its slab buffers at cc.slab_fwd)
template <bool GA>
__device__ __forceinline__ int fo(int ab, int o) {
  if (GA && (o & SLAB_BIT)) return ab ? o + cc.slab_fwd : o;
  return ab + o;
}

struct MaskCtx {
  int mode;                  // 0 none, 1 input masks, 2 philox
  const int8_t* u;
  uint32_t k0, k1;
  int row0, nv;
  const uint32_t* bits;      // the step's mask words
};

#define LW(i) ((i) >= 0 ? cl.p[(i)] : (const float*)nullptr)
#define FO(name) fo<GA>(ab, cc.o_##name)   // forward buffer of a layout copy
#define BO(name) (cc.o_##name)            // the chain's own buffers
#define AP(off) ap<GA>(off)               // a buffer's address
#define SM(off) (*ap<GA>(off))            // a buffer's element

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

// keep-mask of slot `slot` at local row r, column col: a bit of the step's
// words (a padding row of the last CTA keeps every column)
__device__ __forceinline__ bool keep_at(const MaskCtx& m, int slot, int r,
                                        int col) {
  return (m.bits[(r * 3 + slot) * cc.nw + (col >> 5)] >> (col & 31)) & 1u;
}


// Step k's mask words (R * 3 * 2^lg_nw: the words of a row and slot
// padded to a power of two), eight lanes a word, a draw each: the CTA's
// thread t is lane e = t - lane0 (+ NT, ...), of word e >> 3 = (r * 3 +
// slot) * 2^lg_nw + w and its quad 8w + (e & 7), the eight nibbles
// combined by lanes_word (lane0, a multiple of 32, keeps a word's lanes in
// one warp); a padding word (w >= nw) is skipped by its eight lanes
// together, a padding row keeps every column. Out of line, so the step
// bodies' code stays as it was; the caller syncs before the words are
// read.
__device__ __noinline__ void fill_masks(const MaskCtx& m, int k,
                                        int lane0) {
  const int n = cc.rows * 3 * (8 << cc.lg_nw);
  uint32_t* words = (uint32_t*)(sm + cc.o_mw);
  for (int e = (int)threadIdx.x - lane0; e < n; e += NT) {
    if (e < 0) continue;
    const int v = e >> 3, w = v & ((1 << cc.lg_nw) - 1);
    if (w >= cc.nw) continue;
    const int rs = v >> cc.lg_nw;          // r * 3 + slot
    const int r = rs / 3, slot = rs - 3 * r;
    uint32_t nib = 0xFu;
    if (r < m.nv) {
      const int grow = m.row0 + r;
      const int8_t* ur = m.mode == 1
          ? m.u + (((size_t)k * 3 + slot) * cc.B + grow) * cc.P : nullptr;
      nib = quad_bits(m.mode, ur, m.k0, m.k1, cc.thresh, 8 * w + (e & 7),
                      cc.P, grow, k, slot);
    }
    const uint32_t word = lanes_word(nib);
    if ((e & 7) == 0) words[rs * cc.nw + w] = word;
  }
}

__device__ __forceinline__ float bias_at(int slot, int j) {
  return slot >= 0 ? cl.p[slot][j] : 0.f;
}

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

// ------------------------------------------------------------ one phase

// Lanes per output: the largest power of two that keeps the phase in one
// pass of the CTA's threads (cfg.threads, the same for K5 and stage (a),
// so both sum in one order) and at least four FMAs a lane.
__device__ __forceinline__ int pick_s(int n_out, int n_in) {
  int S = 1;
  while (S < 32 && n_out * S * 2 <= NT && n_in >= 8 * S) S <<= 1;
  return S;
}

// lane l's share of sum_q x[q] W[q * ws]: q = l, l + S, ... The weights
// are in shared memory (staged) or device memory (through L1/L2), so the
// load is generic; eight of them are issued ahead of their FMAs.
__device__ __forceinline__ float dotw(const float* x,
                                      const float* __restrict__ W, int ws,
                                      int n, int l, int S) {
  float s = 0.f;
#pragma unroll 8
  for (int q = l; q < n; q += S) s = fmaf(x[q], W[(size_t)q * ws], s);
  return s;
}

// n_out outputs, S lanes each: part(o, l) is lane l's partial sum of
// output o, the S partials are reduced in a fixed butterfly and lane 0
// hands the sum to epi(o, s). Every thread runs the same passes (the
// shuffles need whole warps); ends with a barrier.
template <class Part, class Epi>
__device__ __forceinline__ void phase(int n_out, int S, Part part, Epi epi) {
  const int n = n_out * S;
  const int lg = __ffs(S) - 1;
  for (int base = 0; base < n; base += NT) {
    const int t = base + threadIdx.x;
    const int o = t >> lg, l = t & (S - 1);
    float s = t < n ? part(o, l) : 0.f;
    for (int w = S >> 1; w > 0; w >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, w);
    if (t < n && l == 0) epi(o, s);
  }
  __syncthreads();
}

// ------------------------------------------------------------- forward
// The step bodies below are out of line (each compiled once for every
// kernel and R); they take shared-memory buffers as float offsets into sm.

// input part of gate k of the field or cell: mi Wxm_k + vi Wxv_k (impute)
__device__ __forceinline__ float gate_in(int k, const float* mi,
                                         const float* vi, int r, int j,
                                         int l, int S) {
  if (!cc.impute) return 0.f;
  const int D = cc.D, H = cc.H;
  return dotw(mi + r * D, LW(cc.fxm[k]) + j, H, D, l, S)
         + dotw(vi + r * D, LW(cc.fxv[k]) + j, H, D, l, S);
}


// p_model: pre = x W0 + b0, a = dropout(relu(pre)), heads (mo, vo) = (a Wm
// + bm, a Wv + bv). With cm >= 0 the heads also go to (cm, cv): as they
// are (sel < 0), or selected by the per-row obs at sel, obs * head + (1 -
// obs) * (om, ov) (the post-jump state).
template <bool GA>
__device__ __noinline__ void pmodel_fwd(int x_, int pre_, int a_, int mo_,
                                        int vo_, int cm_, int cv_, int sel_,
                                        int om_, int ov_, const MaskCtx& mc,
                                        int slot) {
  const int R = cc.rows, H = cc.H, P = cc.P, D = cc.D;
  const float* x = AP(x_);
  float* pre = AP(pre_);
  float* a = AP(a_);
  const float* W0 = LW(cc.pm[0]);
  const int b0 = cc.pm[1];
  int S = pick_s(R * P, H);
  phase(R * P, S,
        [&](int o, int l) {
          int r = o / P, j = o - r * P;
          return dotw(x + r * H, W0 + j, P, H, l, S);
        },
        [&](int o, float s) {
          int r = o / P, j = o - r * P;
          s += bias_at(b0, j);
          pre[o] = s;
          float v = fmaxf(s, 0.f);
          if (mc.mode) v = keep_at(mc, slot, r, j) ? v / cc.keep : 0.f;
          a[o] = v;
        });
  const float* Wm = LW(cc.pm[2]);
  const float* Wv = LW(cc.pm[4]);
  S = pick_s(R * 2 * D, P);
  phase(R * 2 * D, S,
        [&](int o, int l) {
          int g = o / (R * D), q = o - g * R * D, r = q / D, d = q - r * D;
          return dotw(a + r * P, (g ? Wv : Wm) + d, D, P, l, S);
        },
        [&](int o, float s) {
          int g = o / (R * D), q = o - g * R * D, r = q / D;
          s += bias_at(cc.pm[g ? 5 : 3], q - r * D);
          SM((g ? vo_ : mo_) + q) = s;
          if (cm_ >= 0) {
            float* cp = AP((g ? cv_ : cm_));
            if (sel_ >= 0) {
              float ob = SM(sel_ + r);
              cp[q] = ob * s + (1.f - ob) * SM((g ? ov_ : om_) + q);
            } else {
              cp[q] = s;
            }
          }
        });
}

// One field evaluation at (mi, vi, hin): F0..F3 (full: r, z, u, r*hin;
// minimal: z, n, z*hin) and fo = f; with out >= 0 also out = base + coef f.
template <bool GA>
__device__ __noinline__ void field_fwd(int mi_, int vi_, int hin_, int F0_,
                                       int F1_, int F2_, int F3_, int fo_,
                                       int base_, float coef, int out_) {
  const int R = cc.rows, H = cc.H, D = cc.D;
  const float* mi = AP(mi_);
  const float* vi = AP(vi_);
  const float* hin = AP(hin_);
  float* F0 = AP(F0_);
  float* F1 = AP(F1_);
  float* F2 = AP(F2_);
  float* F3 = AP(F3_);
  const int n_in = (cc.impute ? 2 * D : 0) + H;
  auto finish = [&](int o, float u, float z) {
    float f = (1.f - z) * (u - hin[o]);
    SM(fo_ + o) = f;
    if (out_ >= 0) SM(out_ + o) = SM(base_ + o) + coef * f;
  };
  if (cc.full) {
    int S = pick_s(R * 2 * H, n_in);
    phase(R * 2 * H, S,
          [&](int o, int l) {
            int g = o / (R * H), q = o - g * R * H, r = q / H;
            int j = q - r * H;
            return gate_in(g, mi, vi, r, j, l, S)
                   + dotw(hin + r * H, LW(cc.fh[g]) + j, H, H, l, S);
          },
          [&](int o, float s) {
            int g = o / (R * H), q = o - g * R * H, j = q % H;
            float y = sigm(s + bias_at(cc.fxb[g], j));
            if (g == 0) {
              F0[q] = y;
              F3[q] = y * hin[q];
            } else {
              F1[q] = y;
            }
          });
    S = pick_s(R * H, n_in);
    phase(R * H, S,
          [&](int o, int l) {
            int r = o / H, j = o - r * H;
            return gate_in(2, mi, vi, r, j, l, S)
                   + dotw(F3 + r * H, LW(cc.fh[2]) + j, H, H, l, S);
          },
          [&](int o, float s) {
            float u = tanhf(s + bias_at(cc.fxb[2], o % H));
            F2[o] = u;
            finish(o, u, F1[o]);
          });
  } else {
    int S = pick_s(R * H, n_in);
    phase(R * H, S,
          [&](int o, int l) {
            int r = o / H, j = o - r * H;
            return gate_in(0, mi, vi, r, j, l, S)
                   + dotw(hin + r * H, LW(cc.fh[0]) + j, H, H, l, S);
          },
          [&](int o, float s) {
            float z = sigm(s + bias_at(cc.fxb[0], o % H));
            F0[o] = z;
            F2[o] = z * hin[o];
          });
    phase(R * H, S,
          [&](int o, int l) {
            int r = o / H, j = o - r * H;
            return gate_in(1, mi, vi, r, j, l, S)
                   + dotw(F2 + r * H, LW(cc.fh[1]) + j, H, H, l, S);
          },
          [&](int o, float s) {
            float n = tanhf(s + bias_at(cc.fxb[1], o % H));
            F1[o] = n;
            finish(o, n, F0[o]);
          });
  }
}

// The discretized cell: one GRU tick of h driven by (m, v). Leaves F0..F3
// = r, z, n, gh_n, gt = gi_n, and h1p = (1 - z) n + z h.
template <bool GA>
__device__ __noinline__ void cell_fwd(int m_, int v_, int h_, int F0_,
                                      int F1_, int F2_, int F3_, int gt_,
                                      int out_) {
  const int R = cc.rows, H = cc.H, D = cc.D;
  const float* m = AP(m_);
  const float* v = AP(v_);
  const float* h = AP(h_);
  float* F0 = AP(F0_);
  float* F1 = AP(F1_);
  float* F3 = AP(F3_);
  float* gt = AP(gt_);
  // segments: gi_r + gh_r, gi_z + gh_z, gi_n, gh_n
  int S = pick_s(R * 4 * H, (cc.impute ? 2 * D : 0) + H);
  phase(R * 4 * H, S,
        [&](int o, int l) {
          int g = o / (R * H), q = o - g * R * H, r = q / H, j = q - r * H;
          float s = g < 3 ? gate_in(g, m, v, r, j, l, S) : 0.f;
          if (g != 2)
            s += dotw(h + r * H, LW(cc.fh[g == 3 ? 2 : g]) + j, H, H, l, S);
          return s;
        },
        [&](int o, float s) {
          int g = o / (R * H), q = o - g * R * H, j = q % H;
          if (g < 2) {
            s += bias_at(cc.fxb[g], j) + bias_at(cc.fhb[g], j);
            (g ? F1 : F0)[q] = s;
          } else if (g == 2) {
            gt[q] = s + bias_at(cc.fxb[2], j);
          } else {
            F3[q] = s + bias_at(cc.fhb[2], j);
          }
        });
  for (int idx = threadIdx.x; idx < R * H; idx += NT) {
    float r = sigm(F0[idx]), z = sigm(F1[idx]);
    float n = tanhf(gt[idx] + r * F3[idx]);
    F0[idx] = r;
    F1[idx] = z;
    SM(F2_ + idx) = n;
    SM(out_ + idx) = (1.f - z) * n + z * h[idx];
  }
  __syncthreads();
}

// Forward of one step (k) for the CTA's rows, on the forward buffers at
// `ab`, from the carries (h, m, v) and the step's inputs (X, M, obs): first
// the step's mask words (fill_masks, from thread lane0 on, while the
// caller's loads of the inputs are in flight), then every buffer the
// backward reads; ends with (h2, m2, v2) and the per-row NLL.
// A dt == 0 padding step skips the propagation: its buffers keep what they
// held (stage (a) zeroes them first).
template <bool GA>
__device__ __noinline__ void step_fwd(int ab, float dt, const MaskCtx& mc,
                                      int k, int lane0) {
  const int R = cc.rows, H = cc.H, D = cc.D, DP = cc.DP;
  if (mc.mode) fill_masks(mc, k, lane0);   // the step's mask words
  __syncthreads();                 // the carries and inputs are loaded
  if (dt > 0.f) {
    if (cc.prop == 2) {
      cell_fwd<GA>(FO(m), FO(v), FO(h), FO(f1a), FO(f1b), FO(f1c), FO(f1d),
               FO(gt), FO(h1p));
    } else if (cc.prop == 1) {     // midpoint
      field_fwd<GA>(FO(m), FO(v), FO(h), FO(f1a), FO(f1b), FO(f1c), FO(f1d),
                FO(fo), FO(h), dt * 0.5f, FO(kk));
      if (cc.impute)
        pmodel_fwd<GA>(FO(kk), FO(prek), FO(ak), FO(mk), FO(vk), -1, -1, -1, -1,
                   -1, mc, 0);
      field_fwd<GA>(FO(mk), FO(vk), FO(kk), FO(f2a), FO(f2b), FO(f2c), FO(f2d),
                FO(fo), FO(h), dt, FO(h1p));
    } else {
      field_fwd<GA>(FO(m), FO(v), FO(h), FO(f1a), FO(f1b), FO(f1c), FO(f1d),
                FO(fo), FO(h), dt, FO(h1p));
    }
    for (int idx = threadIdx.x; idx < R * H; idx += NT)
      SM(FO(h1) + idx) = SM(FO(h1p) + idx);
    pmodel_fwd<GA>(FO(h1p), FO(pre1), FO(a1), FO(m1p), FO(v1p), FO(m1), FO(v1),
               -1, -1, -1, mc, 1);
  } else {
    for (int idx = threadIdx.x; idx < R * H; idx += NT)
      SM(FO(h1) + idx) = SM(FO(h) + idx);
    for (int idx = threadIdx.x; idx < R * D; idx += NT) {
      SM(FO(m1) + idx) = SM(FO(m) + idx);
      SM(FO(v1) + idx) = SM(FO(v) + idx);
    }
    __syncthreads();
  }
  // observation update: NLL, features, prep transform, GRU jump
  const float* X = AP(FO(X));
  const float* M = AP(FO(M));
  const float* obs = AP(FO(obs));
  const float* m1 = AP(FO(m1));
  const float* v1 = AP(FO(v1));
  const float* h1 = AP(FO(h1));
  float* err = AP(FO(err));
  float* ft2 = AP(FO(ft2));
  for (int r = threadIdx.x; r < R; r += NT) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) {
      int i = r * D + d;
      float mean = m1[i], var = v1[i], e, t;
      if (cc.logvar) {
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
    SM(FO(nll) + r) = 0.5f * s;
  }
  __syncthreads();
  float* pre = AP(FO(pre));
  float* gin = AP(FO(gin));
  int S = pick_s(R * DP, 4 * D);
  phase(R * DP, S,
        [&](int o, int l) {
          int r = o / DP, col = o - r * DP, i = r * D;
          return dotw(X + i, LW(cc.wp[0]) + col, DP, D, l, S)
                 + dotw(m1 + i, LW(cc.wp[1]) + col, DP, D, l, S)
                 + dotw(ft2 + i, LW(cc.wp[2]) + col, DP, D, l, S)
                 + dotw(err + i, LW(cc.wp[3]) + col, DP, D, l, S);
        },
        [&](int o, float s) {
          int r = o / DP, col = o - r * DP;
          s += bias_at(cc.bp[0], col);
          pre[o] = s;
          gin[o] = fmaxf(s, 0.f) * M[r * D + col / cc.prep];
        });
  // the observation GRU: ga = gi_r + gh_r, gb = gi_z + gh_z, gt = gi_n,
  // gd = gh_n
  float* ga = AP(FO(ga));
  float* gb = AP(FO(gb));
  float* gd = AP(FO(gd));
  float* gt = AP(FO(gt));
  S = pick_s(R * 4 * H, DP + H);
  phase(R * 4 * H, S,
        [&](int o, int l) {
          int g = o / (R * H), q = o - g * R * H, r = q / H, j = q - r * H;
          float s = 0.f;
          if (g < 3) s = dotw(gin + r * DP, LW(cc.ih[g]) + j, H, DP, l, S);
          if (g != 2)
            s += dotw(h1 + r * H, LW(cc.hh[g == 3 ? 2 : g]) + j, H, H, l, S);
          return s;
        },
        [&](int o, float s) {
          int g = o / (R * H), q = o - g * R * H, j = q % H;
          if (g < 2)
            (g ? gb : ga)[q] = s + bias_at(cc.bih[g], j)
                               + bias_at(cc.bhh[g], j);
          else if (g == 2)
            gt[q] = s + bias_at(cc.bih[2], j);
          else
            gd[q] = s + bias_at(cc.bhh[2], j);
        });
  float* h2 = AP(FO(h2));
  for (int idx = threadIdx.x; idx < R * H; idx += NT) {
    float r = sigm(ga[idx]), z = sigm(gb[idx]);
    float n = tanhf(gt[idx] + r * gd[idx]);
    ga[idx] = r;
    gb[idx] = z;
    SM(FO(gc) + idx) = n;
    float o = obs[idx / H];
    h2[idx] = o * ((1.f - z) * n + z * h1[idx]) + (1.f - o) * h1[idx];
  }
  __syncthreads();
  pmodel_fwd<GA>(FO(h2), FO(pre2), FO(a2), FO(m2p), FO(v2p), FO(m2), FO(v2),
             FO(obs), FO(m1), FO(v1), mc, 2);
}

// ------------------------------------------------------------ backward

// the p_model hidden delta dp = relu'(pre) * dropout^T (dm Wm^T + dv Wv^T)
// from the saved post-dropout activation a = dropout(relu(pre)): a != 0
// exactly where pre > 0 and the column was kept (a kept pre > 0 divided
// by 1 - rate stays > 0; NaN, -0 and pre <= 0 give 0), so no mask is drawn
template <bool GA>
__device__ __noinline__ void pm_dp(int a_, int dm_, int dv_, int dp_) {
  const int R = cc.rows, P = cc.P, D = cc.D;
  const float* dm = AP(dm_);
  const float* dv = AP(dv_);
  const float* Wm = LW(cc.pm[2]);
  const float* Wv = LW(cc.pm[4]);
  int S = pick_s(R * P, 2 * D);
  phase(R * P, S,
        [&](int o, int l) {
          int r = o / P, j = o - r * P;
          return dotw(dm + r * D, Wm + j * D, 1, D, l, S)
                 + dotw(dv + r * D, Wv + j * D, 1, D, l, S);
        },
        [&](int o, float s) {
          if (cc.mode) s = s / cc.keep;
          SM(dp_ + o) = SM(a_ + o) != 0.f ? s : 0.f;
        });
}

// y (+)= dp W0^T (the p_model input gradient); with df >= 0 also df =
// coef * y
template <bool GA>
__device__ __noinline__ void pm_dx(int dp_, int y_, bool acc, int df_,
                                   float coef) {
  const int R = cc.rows, H = cc.H, P = cc.P;
  const float* dp = AP(dp_);
  const float* W0 = LW(cc.pm[0]);
  int S = pick_s(R * H, P);
  phase(R * H, S,
        [&](int o, int l) {
          int r = o / H, j = o - r * H;
          return dotw(dp + r * P, W0 + j * P, 1, P, l, S);
        },
        [&](int o, float s) {
          float y = acc ? SM(y_ + o) + s : s;
          SM(y_ + o) = y;
          if (df_ >= 0) SM(df_ + o) = coef * y;
        });
}

// Backward of one field evaluation at (mi, vi, hin) with saved F0..F3 for
// its gradient df: the deltas a0, a1, a2 (full: da_u, da_z, da_r;
// minimal: da_n, da_z), dhf = d/d hin and (impute) dmo, dvo = d/d(mi, vi).
template <bool GA>
__device__ __noinline__ void field_bwd(int hin_, int F0_, int F1_, int F2_,
                                       int df_, int a0_, int a1_, int a2_,
                                       int dhf_, int dmo_, int dvo_) {
  const int R = cc.rows, H = cc.H, D = cc.D;
  const float* hin = AP(hin_);
  const float* F0 = AP(F0_);
  const float* F1 = AP(F1_);
  const float* F2 = AP(F2_);
  const float* df = AP(df_);
  float* a0 = AP(a0_);
  float* a1 = AP(a1_);
  float* a2 = AP(a2_);
  float* dhf = AP(dhf_);
  const bool full = cc.full;
  const float* z_ = full ? F1 : F0;      // the update gate
  const float* u_ = full ? F2 : F1;      // the candidate
  for (int idx = threadIdx.x; idx < R * H; idx += NT) {
    float z = z_[idx], u = u_[idx], d = df[idx];
    a1[idx] = -d * (u - hin[idx]);
    dhf[idx] = -d * (1.f - z);
    a0[idx] = d * (1.f - z) * (1.f - u * u);
  }
  __syncthreads();
  const float* Wlast = LW(cc.fh[full ? 2 : 1]);
  int S = pick_s(R * H, H);
  phase(R * H, S,
        [&](int o, int l) {
          int r = o / H, j = o - r * H;
          return dotw(a0 + r * H, Wlast + j * H, 1, H, l, S);
        },
        [&](int o, float s) {
          float hv = hin[o];
          if (full) {            // s = d(r h)
            float r = F0[o], z = F1[o];
            dhf[o] += s * r;
            a2[o] = s * hv * r * (1.f - r);
            a1[o] = a1[o] * z * (1.f - z);
          } else {               // s = d(z h)
            float z = F0[o];
            float dz = a1[o] + s * hv;
            dhf[o] += s * z;
            a1[o] = dz * z * (1.f - z);
          }
        });
  // dhf += a1 Wz^T (+ a2 Wr^T); dmo, dvo = sum_k da_k Wx_k^T
  const int ng = full ? 3 : 2;
  const float* da[3] = {full ? a2 : a1, full ? a1 : a0, a0};
  const int n_out = R * H + (cc.impute ? 2 * R * D : 0);
  S = pick_s(n_out, ng * H);
  phase(n_out, S,
        [&](int o, int l) {
          if (o < R * H) {
            int r = o / H, j = o - r * H;
            float s = dotw(a1 + r * H, LW(cc.fh[full ? 1 : 0]) + j * H, 1, H,
                           l, S);
            if (full) s += dotw(a2 + r * H, LW(cc.fh[0]) + j * H, 1, H, l, S);
            return s;
          }
          int q = o - R * H, g = q / (R * D);
          q -= g * R * D;
          int r = q / D, d = q - r * D;
          float s = 0.f;
          for (int k = 0; k < ng; ++k)
            s += dotw(da[k] + r * H, LW(g ? cc.fxv[k] : cc.fxm[k]) + d * H,
                      1, H, l, S);
          return s;
        },
        [&](int o, float s) {
          if (o < R * H) {
            dhf[o] += s;
          } else {
            int q = o - R * H, g = q / (R * D);
            SM((g ? dvo_ : dmo_) + q - g * R * D) = s;
          }
        });
}

// Backward of one step on the saved buffers at `ab`: from (dh, dm, dv) =
// the gradient wrt the step's outputs (h2, m2, v2) to the gradient wrt its
// entry carries (written back into dh, dm, dv), leaving in the chain's
// buffers every delta a weight gradient needs.
template <bool GA>
__device__ __noinline__ void step_bwd(int ab, float dt, float dloss) {
  const int R = cc.rows, H = cc.H, D = cc.D, DP = cc.DP;
  const float* obs = AP(FO(obs));
  const float* M = AP(FO(M));
  const float* X = AP(FO(X));
  float* dh = AP(BO(dh));
  float* dm = AP(BO(dm));
  float* dv = AP(BO(dv));
  float* dh1 = AP(BO(dh1));
  float* dm1 = AP(BO(dm1));
  float* dv1 = AP(BO(dv1));
  // KL on (m2, v2), the carry from the next step, the obs select
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    float o = obs[idx / D], mk = M[idx], mv = SM(FO(m2) + idx);
    float vv = SM(FO(v2) + idx);
    float sc = dloss * cc.mixing * o * mk;
    float dklm = sc * (mv - X[idx]) * INV_S2SQ;
    float dklv;
    if (cc.logvar) {
      dklv = sc * (-0.5f + expf(vv) / TWO_S2SQ);
    } else {
      float a = fabsf(vv) + 1e-5f;
      dklv = sc * sgnf(vv) * (-0.5f / a + INV_TWO_S2SQ);
    }
    float gm = dm[idx] + dklm, gv = dv[idx] + dklv;
    SM(BO(dm2) + idx) = o * gm;                // -> p_model (post jump)
    SM(BO(dv2) + idx) = o * gv;
    dm1[idx] = (1.f - o) * gm;
    dv1[idx] = (1.f - o) * gv;
  }
  __syncthreads();
  pm_dp<GA>(FO(a2), BO(dm2), BO(dv2), BO(dp2));
  // d h2 = dp2 W0^T + dh, split by obs; the observation GRU's deltas
  {
    const int P = cc.P;
    const float* dp2 = AP(BO(dp2));
    const float* W0 = LW(cc.pm[0]);
    int S = pick_s(R * H, P);
    phase(R * H, S,
          [&](int o, int l) {
            int r = o / H, j = o - r * H;
            return dotw(dp2 + r * P, W0 + j * P, 1, P, l, S);
          },
          [&](int o, float s) {
            float g = s + dh[o], ob = obs[o / H];
            float dj = ob * g;
            float r = SM(FO(ga) + o), z = SM(FO(gb) + o);
            float n = SM(FO(gc) + o), ghn = SM(FO(gd) + o);
            float da_z = dj * (SM(FO(h1) + o) - n) * z * (1.f - z);
            float da_n = dj * (1.f - z) * (1.f - n * n);
            SM(BO(og0) + o) = da_n * ghn * r * (1.f - r);
            SM(BO(og1) + o) = da_z;
            SM(BO(og2) + o) = da_n;
            SM(BO(og3) + o) = da_n * r;
            dh1[o] = (1.f - ob) * g + dj * z;
          });
  }
  // dh1 += dgh hh^T; dx = relu'(pre) M (dgi ih^T)
  {
    const float* og0 = AP(BO(og0));
    const float* og1 = AP(BO(og1));
    const float* og2 = AP(BO(og2));
    const float* og3 = AP(BO(og3));
    float* dx = AP(BO(dx));
    int S = pick_s(R * (H + DP), 3 * H);
    phase(R * (H + DP), S,
          [&](int o, int l) {
            if (o < R * H) {
              int r = o / H, j = o - r * H;
              return dotw(og0 + r * H, LW(cc.hh[0]) + j * H, 1, H, l, S)
                     + dotw(og1 + r * H, LW(cc.hh[1]) + j * H, 1, H, l, S)
                     + dotw(og3 + r * H, LW(cc.hh[2]) + j * H, 1, H, l, S);
            }
            int q = o - R * H, r = q / DP, col = q - r * DP;
            return dotw(og0 + r * H, LW(cc.ih[0]) + col * H, 1, H, l, S)
                   + dotw(og1 + r * H, LW(cc.ih[1]) + col * H, 1, H, l, S)
                   + dotw(og2 + r * H, LW(cc.ih[2]) + col * H, 1, H, l, S);
          },
          [&](int o, float s) {
            if (o < R * H) {
              dh1[o] = dh1[o] + s;
            } else {
              int q = o - R * H, r = q / DP, col = q - r * DP;
              dx[q] = SM(FO(pre) + q) > 0.f
                          ? s * M[r * D + col / cc.prep] : 0.f;
            }
          });
    // dfm, dff, dfe = dx wp[1..3]^T
    S = pick_s(R * 3 * D, DP);
    phase(R * 3 * D, S,
          [&](int o, int l) {
            int g = o / (R * D), q = o - g * R * D, r = q / D;
            int d = q - r * D;
            return dotw(dx + r * DP, LW(cc.wp[1 + g]) + d * DP, 1, DP, l, S);
          },
          [&](int o, float s) {
            int g = o / (R * D), q = o - g * R * D;
            SM((g == 0 ? BO(dfm) : g == 1 ? BO(dff) : BO(dfe)) + q) = s;
          });
  }
  // the NLL and the feature paths into (m1, v1)
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    float sc = dloss * obs[idx / D] * M[idx];
    float e = SM(FO(err) + idx), v1 = SM(FO(v1) + idx);
    float dfm = SM(BO(dfm) + idx), dff = SM(BO(dff) + idx);
    float dfe = SM(BO(dfe) + idx);
    if (cc.logvar) {
      float sigma = expf(0.5f * v1);
      dm1[idx] += -sc * e / sigma - dfe / sigma + dfm;
      dv1[idx] += sc * 0.5f * (1.f - e * e) - 0.5f * dfe * e + dff;
    } else {
      float a = SM(FO(ft2) + idx), sq = sqrtf(a), sg = sgnf(v1);
      dm1[idx] += -sc * e / sq - dfe / sq + dfm;
      dv1[idx] += sg * sc * 0.5f * (1.f - e * e) / a
                  + sg * (-0.5f * dfe * e / a + dff);
    }
  }
  __syncthreads();
  if (!(dt > 0.f)) {               // padding step: the carries pass through
    for (int idx = threadIdx.x; idx < R * H; idx += NT) dh[idx] = dh1[idx];
    for (int idx = threadIdx.x; idx < R * D; idx += NT) {
      dm[idx] = dm1[idx];
      dv[idx] = dv1[idx];
    }
    __syncthreads();
    return;
  }
  // the propagation: h1 = cell(h, m, v), (m1, v1) = p_model(h1)
  pm_dp<GA>(FO(a1), BO(dm1), BO(dv1), BO(dp1));
  const bool field = cc.prop != 2;
  pm_dx<GA>(BO(dp1), BO(dh1), true, field ? BO(df) : -1, dt);
  if (cc.prop == 2) {
    const float* h = AP(FO(h));
    for (int idx = threadIdx.x; idx < R * H; idx += NT) {
      float r = SM(FO(f1a) + idx), z = SM(FO(f1b) + idx);
      float n = SM(FO(f1c) + idx), ghn = SM(FO(f1d) + idx);
      float d = dh1[idx];
      float da_z = d * (h[idx] - n) * z * (1.f - z);
      float da_n = d * (1.f - z) * (1.f - n * n);
      SM(BO(pg0) + idx) = da_n * ghn * r * (1.f - r);
      SM(BO(pg1) + idx) = da_z;
      SM(BO(pg2) + idx) = da_n;
      SM(BO(pg3) + idx) = da_n * r;
      dh[idx] = d * z;
    }
    __syncthreads();
    const float* pg0 = AP(BO(pg0));
    const float* pg1 = AP(BO(pg1));
    const float* pg2 = AP(BO(pg2));
    const float* pg3 = AP(BO(pg3));
    const int n_out = R * H + (cc.impute ? 2 * R * D : 0);
    int S = pick_s(n_out, 3 * H);
    phase(n_out, S,
          [&](int o, int l) {
            if (o < R * H) {
              int r = o / H, j = o - r * H;
              return dotw(pg0 + r * H, LW(cc.fh[0]) + j * H, 1, H, l, S)
                     + dotw(pg1 + r * H, LW(cc.fh[1]) + j * H, 1, H, l, S)
                     + dotw(pg3 + r * H, LW(cc.fh[2]) + j * H, 1, H, l, S);
            }
            int q = o - R * H, g = q / (R * D);
            q -= g * R * D;
            int r = q / D, d = q - r * D;
            const int* fx = g ? cc.fxv : cc.fxm;
            return dotw(pg0 + r * H, LW(fx[0]) + d * H, 1, H, l, S)
                   + dotw(pg1 + r * H, LW(fx[1]) + d * H, 1, H, l, S)
                   + dotw(pg2 + r * H, LW(fx[2]) + d * H, 1, H, l, S);
          },
          [&](int o, float s) {
            if (o < R * H) {
              dh[o] = dh[o] + s;
            } else {
              int q = o - R * H, g = q / (R * D);
              (g ? dv : dm)[q - g * R * D] = s;
            }
          });
  } else if (cc.prop == 0) {
    field_bwd<GA>(FO(h), FO(f1a), FO(f1b), FO(f1c), BO(df), BO(e1a0), BO(e1a1),
              BO(e1a2), BO(dhf), BO(dm), BO(dv));
    for (int idx = threadIdx.x; idx < R * H; idx += NT)
      dh[idx] = dh1[idx] + SM(BO(dhf) + idx);
  } else {
    // midpoint: h1 = h + dt f(mk, vk, kk), kk = h + dt/2 f(m, v, h),
    // (mk, vk) = p_model(kk) with impute
    field_bwd<GA>(FO(kk), FO(f2a), FO(f2b), FO(f2c), BO(df), BO(e2a0),
              BO(e2a1), BO(e2a2), BO(dkk), BO(dmk), BO(dvk));
    if (cc.impute) {
      pm_dp<GA>(FO(ak), BO(dmk), BO(dvk), BO(dp0));
      pm_dx<GA>(BO(dp0), BO(dkk), true, BO(df), dt * 0.5f);
    } else {
      for (int idx = threadIdx.x; idx < R * H; idx += NT)
        SM(BO(df) + idx) = dt * 0.5f * SM(BO(dkk) + idx);
      __syncthreads();
    }
    field_bwd<GA>(FO(h), FO(f1a), FO(f1b), FO(f1c), BO(df), BO(e1a0), BO(e1a1),
              BO(e1a2), BO(dhf), BO(dm), BO(dv));
    for (int idx = threadIdx.x; idx < R * H; idx += NT)
      dh[idx] = dh1[idx] + SM(BO(dkk) + idx) + SM(BO(dhf) + idx);
  }
  if (!cc.impute)
    for (int idx = threadIdx.x; idx < R * D; idx += NT) {
      dm[idx] = 0.f;
      dv[idx] = 0.f;
    }
  __syncthreads();
}

// ---------------------------------------------------------------- kernels

// slab: the CTA's slab of device memory (the device-memory form), or null
__device__ __forceinline__ void load_call(const GobCfg& c, const Leaves& lv,
                                          float* slab) {
  const int* ci = (const int*)&c;
  int* di = (int*)&cc;
  for (int i = threadIdx.x; i < (int)(sizeof(GobCfg) / 4); i += NT)
    di[i] = ci[i];
  for (int i = threadIdx.x; i < MAX_LEAVES; i += NT) cl.p[i] = lv.p[i];
  if (threadIdx.x == 0) cslab = slab;
  __syncthreads();
}

// With cc.wsm, every leaf into shared memory at o_w (leaf i at
// leaf_off[i]) and the leaf pointers onto those copies (K5 and the chain,
// where the weights fit beside the activations at one CTA an SM).
__device__ __forceinline__ void stage_weights() {
  if (!cc.wsm) return;
  for (int i = 0; i < cc.n_leaves; ++i) {
    const float* src = cl.p[i];
    float* dst = sm + cc.o_w + cc.leaf_off[i];
    const int n = cc.leaf_off[i + 1] - cc.leaf_off[i];
    for (int e = threadIdx.x; e < n; e += NT) dst[e] = src[e];
  }
  __syncthreads();
  if (threadIdx.x < cc.n_leaves)
    cl.p[threadIdx.x] = sm + cc.o_w + cc.leaf_off[threadIdx.x];
  __syncthreads();
}

__device__ MaskCtx make_mask_ctx(const int8_t* u, const long long* seed,
                                 int row0, int nv) {
  MaskCtx mc;
  mc.mode = cc.mode;
  mc.u = u;
  unsigned long long s = (cc.mode == 2) ? (unsigned long long)seed[0] : 0ull;
  mc.k0 = (uint32_t)(s & 0xFFFFFFFFull);
  mc.k1 = (uint32_t)(s >> 32);
  mc.row0 = row0; mc.nv = nv;
  mc.bits = (const uint32_t*)(sm + cc.o_mw);
  return mc;
}

// rows [0, nv) of a [.., B, W] array at step k into the R-row buffer at
// offset dst (zeros on padding rows)
template <bool GA>
__device__ __forceinline__ void load_rows(int R, int dst, const float* src,
                                          int k, int W, int row0, int nv) {
  for (int idx = threadIdx.x; idx < R * W; idx += NT)
    SM(dst + idx) = idx / W < nv
        ? src[((size_t)k * cc.B + row0) * W + idx] : 0.f;
}

// the step's inputs of the CTA's rows into the forward buffers at ab
template <bool GA>
__device__ __forceinline__ void load_step(int R, int ab, int k, int row0,
                                          int nv, const float* obs_g,
                                          const float* X_g,
                                          const float* M_g) {
  load_rows<GA>(R, FO(obs), obs_g, k, 1, row0, nv);
  load_rows<GA>(R, FO(X), X_g, k, cc.D, row0, nv);
  load_rows<GA>(R, FO(M), M_g, k, cc.D, row0, nv);
}

template <int R, bool WANT_HISTS, bool GA>
__global__ void __launch_bounds__(MAX_NT)
gob_scan_fwd_kernel(GobCfg c, Leaves lv, float* slab,
                    const float* __restrict__ dts,
                    const float* __restrict__ obs_g,
                    const float* __restrict__ X_g,
                    const float* __restrict__ M_g, const int8_t* u,
                    const long long* seed, const float* __restrict__ h0,
                    const float* __restrict__ m0,
                    const float* __restrict__ v0, float* loss_part,
                    float* hh, float* mh, float* vh) {
  load_call(c, lv, GA ? slab + (size_t)blockIdx.x * c.slab_fwd : nullptr);
  stage_weights();
  const int H = cc.H, D = cc.D, B = cc.B, ab = 0;
  const int row0 = blockIdx.x * R;
  const int nv = min(R, B - row0);
  float* h = AP(FO(h));
  float* m = AP(FO(m));
  float* v = AP(FO(v));
  float* lrow = AP(FO(lrow));
  load_rows<GA>(R, FO(h), h0, 0, H, row0, nv);
  load_rows<GA>(R, FO(m), m0, 0, D, row0, nv);
  load_rows<GA>(R, FO(v), v0, 0, D, row0, nv);
  for (int r = threadIdx.x; r < R; r += NT) lrow[r] = 0.f;
  MaskCtx mc = make_mask_ctx(u, seed, row0, nv);
  __syncthreads();
  for (int k = 0; k < cc.K; ++k) {
    if (WANT_HISTS) {
      for (int idx = threadIdx.x; idx < nv * H; idx += NT)
        hh[((size_t)k * B + row0) * H + idx] = h[idx];
      for (int idx = threadIdx.x; idx < nv * D; idx += NT) {
        mh[((size_t)k * B + row0) * D + idx] = m[idx];
        vh[((size_t)k * B + row0) * D + idx] = v[idx];
      }
    }
    load_step<GA>(R, ab, k, row0, nv, obs_g, X_g, M_g);
    // the step's mask words, by the threads past those that store the
    // histories and load the inputs, while those loads are in flight
    step_fwd<GA>(ab, dts[k], mc, k, ((max(R * H, R * D) - 1) % NT + 32) & ~31);
    // the step's loss per row: obs * (nll + mixing * KL(m2, v2))
    const float* X = AP(FO(X));
    const float* M = AP(FO(M));
    const float* m2 = AP(FO(m2));
    const float* v2 = AP(FO(v2));
    for (int r = threadIdx.x; r < nv; r += NT) {
      float kl = 0.f;
      for (int d = 0; d < D; ++d) {
        int i = r * D + d;
        float log_std, var;
        if (cc.logvar) {
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
      float o = SM(FO(obs) + r);
      lrow[r] += o * SM(FO(nll) + r) + cc.mixing * (o * kl);
    }
    for (int idx = threadIdx.x; idx < R * H; idx += NT)
      h[idx] = SM(FO(h2) + idx);
    for (int idx = threadIdx.x; idx < R * D; idx += NT) {
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

// K6 stage (a): CTA (x, y) re-runs step k0 + y for rows x*R.. from the
// stored carries and writes the saved buffers into the chunk's workspace
// (each buffer a [KBc, width] matrix, row (k - k0) * B + b).
template <int R, bool GA>
__global__ void __launch_bounds__(MAX_NT)
gob_remat_kernel(GobCfg c, Leaves lv, float* slab,
                 const float* __restrict__ dts,
                 const float* __restrict__ obs_g,
                 const float* __restrict__ X_g,
                 const float* __restrict__ M_g, const int8_t* u,
                 const long long* seed, const float* __restrict__ hh,
                 const float* __restrict__ mh,
                 const float* __restrict__ vh, int k0, int KBc, float* ws) {
  load_call(c, lv, GA ? slab + ((size_t)blockIdx.y * gridDim.x + blockIdx.x)
                                   * c.slab_fwd
                      : nullptr);
  const int B = cc.B, ab = 0;
  const int row0 = blockIdx.x * R;
  const int nv = min(R, B - row0);
  const int k = k0 + blockIdx.y;
  for (int i = threadIdx.x; i < cc.fwd_floats; i += NT) sm[i] = 0.f;
  if (GA)
    for (int i = threadIdx.x; i < cc.slab_fwd; i += NT) cslab[i] = 0.f;
  __syncthreads();
  load_rows<GA>(R, FO(h), hh, k, cc.H, row0, nv);
  load_rows<GA>(R, FO(m), mh, k, cc.D, row0, nv);
  load_rows<GA>(R, FO(v), vh, k, cc.D, row0, nv);
  load_step<GA>(R, ab, k, row0, nv, obs_g, X_g, M_g);
  MaskCtx mc = make_mask_ctx(u, seed, row0, nv);
  step_fwd<GA>(ab, dts[k], mc, k, 0);
  const size_t row = (size_t)blockIdx.y * B + row0;
  for (int s = 0; s < cc.n_save; ++s) {
    const int w = cc.save_w[s];
    const float* src = AP(cc.save_sm[s]);
    float* dst = ws + (size_t)cc.save_ws[s] * KBc + row * w;
    for (int idx = threadIdx.x; idx < nv * w; idx += NT) dst[idx] = src[idx];
  }
}

// stage (a)'s buffers of step k (chunk row kl) into the layout copy at ab
template <bool GA>
__device__ __forceinline__ void prefetch_step(int ab, const float* ws,
                                              int KBc, int kl, int row0,
                                              int nv) {
  const size_t row = (size_t)kl * cc.B + row0;
  for (int s = 0; s < cc.n_save; ++s) {
    const int w = cc.save_w[s];
    const float* src = ws + (size_t)cc.save_ws[s] * KBc + row * w;
    const int o = fo<GA>(ab, cc.save_sm[s]);
    float* dst = AP(o);
    if (GA && (o & SLAB_BIT))
      for (int idx = threadIdx.x; idx < nv * w; idx += NT) dst[idx] = src[idx];
    else
      for (int idx = threadIdx.x; idx < nv * w; idx += NT)
        cp_async4(dst + idx, src + idx);
  }
  cp_async_commit();
}

// K6 stage (b): the reverse walk over steps [k0, k1) of the CTA's rows,
// carrying (dh, dm, dv) in dh0/dm0/dv0 from chunk to chunk (zero before
// the last chunk, `first`); writes each step's deltas to the workspace.
template <int R, bool GA>
__global__ void __launch_bounds__(MAX_NT)
gob_chain_kernel(GobCfg c, Leaves lv, float* slab,
                 const float* __restrict__ dts,
                 float* ws, int KBc, int k0, int k1, const float* dloss_p,
                 float* dh0, float* dm0, float* dv0, int first) {
  load_call(c, lv,
            GA ? slab + (size_t)blockIdx.x * c.slab_floats : nullptr);
  const int H = cc.H, D = cc.D, B = cc.B;
  const int row0 = blockIdx.x * R;
  const int nv = min(R, B - row0);
  for (int i = threadIdx.x; i < cc.smem_floats; i += NT) sm[i] = 0.f;
  if (GA)
    for (int i = threadIdx.x; i < cc.slab_floats; i += NT) cslab[i] = 0.f;
  stage_weights();
  __syncthreads();
  if (!first) {
    load_rows<GA>(R, BO(dh), dh0, 0, H, row0, nv);
    load_rows<GA>(R, BO(dm), dm0, 0, D, row0, nv);
    load_rows<GA>(R, BO(dv), dv0, 0, D, row0, nv);
  }
  const float dloss = dloss_p[0];
  prefetch_step<GA>(0, ws, KBc, k1 - 1 - k0, row0, nv);
  cp_async_wait_all();
  __syncthreads();
  for (int k = k1 - 1, it = 0; k >= k0; --k, ++it) {
    const int ab = (it & 1) ? cc.fwd_floats : 0;
    if (k > k0)
      prefetch_step<GA>(ab ? 0 : cc.fwd_floats, ws, KBc, k - 1 - k0, row0, nv);
    const float dt = dts[k];
    step_bwd<GA>(ab, dt, dloss);
    const size_t row = (size_t)(k - k0) * B + row0;
    for (int s = 0; s < cc.n_dlt; ++s) {
      const int w = cc.dlt_w[s];
      const bool zero = cc.dlt_prop[s] && !(dt > 0.f);
      const float* src = AP(cc.dlt_sm[s]);
      float* dst = ws + (size_t)cc.dlt_ws[s] * KBc + row * w;
      for (int idx = threadIdx.x; idx < nv * w; idx += NT)
        dst[idx] = zero ? 0.f : src[idx];
    }
    cp_async_wait_all();
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < nv * H; idx += NT)
    dh0[(size_t)row0 * H + idx] = SM(BO(dh) + idx);
  for (int idx = threadIdx.x; idx < nv * D; idx += NT) {
    dm0[(size_t)row0 * D + idx] = SM(BO(dm) + idx);
    dv0[(size_t)row0 * D + idx] = SM(BO(dv) + idx);
  }
}

// K6 stage (c): CTA (t, s) owns output tile t of one leaf (tiles[t]: leaf
// offset, in, out, i0, j0, first job, jobs) and the s-th of n_split
// stretches of the chunk's nrows (step, row) pairs; it sums x^T d over its
// stretch for each of the leaf's jobs (jobs[j]: x region or -1 for a
// bias's ones, x width, delta region, delta width), in job order and then
// row order, and writes (acc: adds) its partial row s. The order does not
// depend on the rows per CTA of stages (a) and (b).
__global__ void __launch_bounds__(WG_NT)
gob_wgrad_kernel(const float* __restrict__ ws, int KBc, int nrows,
                 const int* __restrict__ tiles, const int* __restrict__ jobs,
                 int n_split, float* partials, int n_params, int acc) {
  __shared__ float xs[WG_TILE][WG_TILE + 1], ds[WG_TILE][WG_TILE + 1];
  const int* t = tiles + blockIdx.x * 7;
  const int loff = t[0], in = t[1], out = t[2], i0 = t[3], j0 = t[4];
  const int jf = t[5], jn = t[6];
  const int per = (nrows + n_split - 1) / n_split;
  const int r0 = blockIdx.y * per, r1 = min(nrows, r0 + per);
  const int ty = threadIdx.x / WG_TILE, tx = threadIdx.x % WG_TILE;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int jb = 0; jb < jn; ++jb) {
    const int* jp = jobs + (jf + jb) * 4;
    const int xo = jp[0], xw = jp[1], dw = jp[3];
    const float* Xm = xo >= 0 ? ws + (size_t)xo * KBc : nullptr;
    const float* Dm = ws + (size_t)jp[2] * KBc;
    for (int rb = r0; rb < r1; rb += WG_TILE) {
      for (int e = threadIdx.x; e < WG_TILE * WG_TILE; e += WG_NT) {
        int rr = e / WG_TILE, q = e % WG_TILE, row = rb + rr;
        bool ok = row < r1;
        xs[rr][q] = (ok && i0 + q < in)
            ? (Xm ? Xm[(size_t)row * xw + i0 + q] : 1.f) : 0.f;
        ds[rr][q] = (ok && j0 + q < out)
            ? Dm[(size_t)row * dw + j0 + q] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < WG_TILE; ++kk) {
        float d = ds[kk][tx];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          a[q] = fmaf(xs[kk][ty + 8 * q], d, a[q]);
      }
      __syncthreads();
    }
  }
  float* P = partials + (size_t)blockIdx.y * n_params + loff;
  for (int q = 0; q < 4; ++q) {
    int i = i0 + ty + 8 * q, j = j0 + tx;
    if (i < in && j < out) {
      float* p = P + (size_t)i * out + j;
      *p = acc ? *p + a[q] : a[q];
    }
  }
}

// The K7 masks of K steps written out ([K, 3, B, P] int8): the draw the scan
// kernels make in 'prng' mode (one Philox a quad), for tests and timing.
__global__ void __launch_bounds__(256)
gob_masks_kernel(const long long* seed, int K, int S, int B, int P,
                 unsigned thresh, int8_t* out) {
  philox_mask_rows(seed, K, S, B, P, thresh, out);
}

// ------------------------------------------------------------ C interface

static cudaError_t make_leaves(const GobCfg* c, void** leaves, Leaves* lv) {
  if (c->n_leaves > MAX_LEAVES || c->n_save > MAX_SAVE ||
      c->n_dlt > MAX_DLT || (c->threads != 256 && c->threads != MAX_NT))
    return cudaErrorInvalidValue;
  for (int i = 0; i < MAX_LEAVES; ++i)
    lv->p[i] = i < c->n_leaves ? (const float*)leaves[i] : nullptr;
  return cudaSuccess;
}

template <class F>
static cudaError_t set_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// the kernel instance of the call's rows and activation form: the shared
// form at 1, 2, 4, 8 or 16 rows, the device-memory form (c->ga) at one
#define GOB_FORM(c_, CASE)                                              \
  if ((c_)->ga) {                                                       \
    if ((c_)->rows != 1) return (int)cudaErrorInvalidValue;             \
    CASE(1, true);                                                      \
  } else {                                                              \
    switch ((c_)->rows) {                                               \
      case 1: CASE(1, false); break;                                    \
      case 2: CASE(2, false); break;                                    \
      case 4: CASE(4, false); break;                                    \
      case 8: CASE(8, false); break;                                    \
      case 16: CASE(16, false); break;                                  \
      default: return (int)cudaErrorInvalidValue;                       \
    }                                                                   \
  }

// the device-memory form needs its slab, the shared form none
static bool slab_ok(const GobCfg* c, const float* slab) {
  return (c->ga != 0) == (slab != nullptr);
}

extern "C" const char* gob_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// slab: the device-memory form's slabs, ceil(B / rows) * slab_fwd floats
// (null in the shared form)
extern "C" int gob_scan_fwd(const GobCfg* c, void** leaves,
                            const float* dts, const float* obs,
                            const float* X, const float* M,
                            const int8_t* u, const long long* seed,
                            const float* h0, const float* m0,
                            const float* v0, float* loss_part, float* hh,
                            float* mh, float* vh, int want_hists,
                            float* slab, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Leaves lv;
  cudaError_t e = make_leaves(c, leaves, &lv);
  if (e != cudaSuccess) return (int)e;
  if (!slab_ok(c, slab)) return (int)cudaErrorInvalidValue;
  const int grid = (c->B + c->rows - 1) / c->rows;
  const size_t smem = (size_t)(c->o_mw + c->n_mw) * sizeof(float);
#define FWD_CASE(R, GA)                                                     \
  if (want_hists) {                                                         \
    e = set_smem(gob_scan_fwd_kernel<R, true, GA>, smem);                   \
    if (e != cudaSuccess) return (int)e;                                    \
    gob_scan_fwd_kernel<R, true, GA><<<grid, c->threads, smem, st>>>(       \
        *c, lv, slab, dts, obs, X, M, u, seed, h0, m0, v0, loss_part, hh,   \
        mh, vh);                                                            \
  } else {                                                                  \
    e = set_smem(gob_scan_fwd_kernel<R, false, GA>, smem);                  \
    if (e != cudaSuccess) return (int)e;                                    \
    gob_scan_fwd_kernel<R, false, GA><<<grid, c->threads, smem, st>>>(      \
        *c, lv, slab, dts, obs, X, M, u, seed, h0, m0, v0, loss_part, hh,   \
        mh, vh);                                                            \
  }
  GOB_FORM(c, FWD_CASE)
#undef FWD_CASE
  return (int)cudaGetLastError();
}

// K6: for each chunk of Kc steps, last first, stages (a), (b) and (c) on
// the stream; stage (c)'s partial rows [n_split, n_params] are left for
// reduce_partials. slab: the device-memory form's slabs (null in the shared
// form), the larger of stage (a)'s ceil(B / rows) * Kc * slab_fwd floats and
// the chain's ceil(B / rows) * slab_floats: the stages of a chunk run one
// after the other on the stream and share it.
extern "C" int gob_scan_bwd(const GobCfg* c, void** leaves,
                            const float* dts, const float* obs,
                            const float* X, const float* M,
                            const int8_t* u, const long long* seed,
                            const float* hh, const float* mh,
                            const float* vh, const float* dloss, float* ws,
                            int Kc, const int* tiles, int n_tiles,
                            const int* jobs, int n_split, float* partials,
                            float* dh0, float* dm0, float* dv0, float* slab,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Leaves lv;
  cudaError_t e = make_leaves(c, leaves, &lv);
  if (e != cudaSuccess) return (int)e;
  if (!slab_ok(c, slab)) return (int)cudaErrorInvalidValue;
  const int B = c->B, K = c->K;
  const int nb = (B + c->rows - 1) / c->rows;
  const int KBc = Kc * B;
  const int n_chunks = (K + Kc - 1) / Kc;
  const size_t fwd = (size_t)(c->o_mw + c->n_mw) * sizeof(float);
  const size_t full = (size_t)(c->wsm ? c->o_w + c->n_params
                                      : c->smem_floats) * sizeof(float);
#define ATTR_CASE(R, GA)                                      \
  e = set_smem(gob_remat_kernel<R, GA>, fwd);                 \
  if (e == cudaSuccess) e = set_smem(gob_chain_kernel<R, GA>, full);
  GOB_FORM(c, ATTR_CASE)
#undef ATTR_CASE
  if (e != cudaSuccess) return (int)e;
  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const int k0 = ci * Kc, k1 = min(K, k0 + Kc);
    const int last = ci == n_chunks - 1;
#define STAGE_CASE(R, GA)                                                  \
  gob_remat_kernel<R, GA><<<dim3(nb, k1 - k0), c->threads, fwd, st>>>(     \
      *c, lv, slab, dts, obs, X, M, u, seed, hh, mh, vh, k0, KBc, ws);     \
  e = cudaGetLastError();                                                  \
  if (e != cudaSuccess) return (int)e;                                     \
  gob_chain_kernel<R, GA><<<nb, c->threads, full, st>>>(                   \
      *c, lv, slab, dts, ws, KBc, k0, k1, dloss, dh0, dm0, dv0, last);
    GOB_FORM(c, STAGE_CASE)
#undef STAGE_CASE
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    gob_wgrad_kernel<<<dim3(n_tiles, n_split), WG_NT, 0, st>>>(
        ws, KBc, (k1 - k0) * B, tiles, jobs, n_split, partials,
        c->n_params, !last);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

extern "C" int gob_masks(const long long* seed, int K, int B, int P,
                         unsigned thresh, int8_t* out, void* stream) {
  return (int)launch_mask_rows(gob_masks_kernel, seed, K, 3, B, P, thresh,
                               out, (cudaStream_t)stream);
}
